// FPN multilevel RoIAlign on NHWC maps: forward, and its gradient into
// the level maps.
//
// Shared by both: the standard mmdet level routing (single_level_roi_
// extractor.py:44, the JAX package's ops/roi_align.py::multilevel_roi_align)
//   lvl = clamp(floor(log2(sqrt(area) / finest_scale + 1e-6)), 0, L-1),
// out_size x out_size bins, a fixed ss x ss sample grid per bin, mmcv's
// bilinear taps with samples more than one pixel outside the map zeroed,
// f32 sums. The TPU kernels' coarser-level bump for RoIs whose samples
// overflow their DMA window has no counterpart here: there is no window.
// The sample grid is separable: sample (ky, kx) of a RoI takes its rows
// from the ky-th y sample and its columns from the kx-th x sample, and its
// corner weights are products of the two (hy*hx, hy*lx, ly*hx, ly*lx), so
// each kernel computes the RoI's out_size*ss y samples and as many x
// samples once into a table. Compiled with -fmad=false so every sample
// coordinate and weight rounds exactly as in the plain version
// (ops/roi_align.py: separately rounded multiplies and adds); the
// backward's sums use explicit fmaf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // out_size * ss per axis

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Level of one RoI (mmdet routing).
__device__ __forceinline__ int route_level(const float* roi, int L, float finest_scale) {
  const float area = (roi[2] - roi[0]) * (roi[3] - roi[1]);
  const float sc = sqrtf(fmaxf(area, 0.f));
  float lf = floorf(log2f(sc / finest_scale + 1e-6f));
  lf = fminf(fmaxf(lf, 0.f), (float)(L - 1));
  return (int)lf;
}

// Where a RoI's sample grid starts on its level and how wide a bin is.
struct Grid {
  float x1, y1, bw, bh;
};

__device__ __forceinline__ Grid roi_grid(const float* roi, float scale, int out_size,
                                         float offset) {
  Grid g;
  g.x1 = roi[0] * scale - offset;
  g.y1 = roi[1] * scale - offset;
  g.bw = (roi[2] - roi[0]) * scale / (float)out_size;
  g.bh = (roi[3] - roi[1]) * scale / (float)out_size;
  return g;
}

// Sample k of one axis (mmcv semantics, the JAX package's
// ops/roi_align.py::_bilinear_weights_indices per axis): the two clamped
// corner indices, their weights h = 1 - l and l, and whether the sample
// lies more than a pixel outside the map (then its taps weigh nothing).
struct Axis {
  int i0, i1;
  float h, l;
  int outside;
};

__device__ __forceinline__ Axis axis_sample(float start, float bin, int k, int ss, int size) {
  Axis a;
  const float fs = (float)size;
  const float gk = (float)(k / ss) + ((float)(k % ss) + 0.5f) / (float)ss;
  float v = start + gk * bin;
  a.outside = (v < -1.f) || (v > fs);
  v = fminf(fmaxf(v, 0.f), fs - 1.f);
  const float v0 = floorf(v);
  const float v1 = fminf(v0 + 1.f, fs - 1.f);
  a.l = v - v0;
  a.h = 1.f - a.l;
  a.i0 = (int)v0;
  a.i1 = (int)v1;
  return a;
}

// One sample of the backward's table: its corners packed as
// i0 | i1 << 16, its bin along the axis, and its corner weights, both 0
// for a sample outside the map.
struct Samp {
  int idx, bin;
  float h, l;
};

// The rows and columns a RoI's taps can reach on its level: from the
// smallest to the largest corner index of its samples inside the map
// (zero-weight corners included, so the range is conservative);
// (0, -1, 0, -1) when every sample of an axis lies outside. The plain
// version is ops/roi_align.py::roi_footprints. With ``tab``, also writes
// the RoI's n y samples, then its n x samples.
struct Foot {
  int y_lo, y_hi, x_lo, x_hi;
};

__device__ __forceinline__ Foot sample_table(const Grid& g, int H, int W, int n, int ss,
                                             Samp* tab) {
  Foot f{0x7fffffff, -1, 0x7fffffff, -1};
  for (int k = 0; k < n; ++k) {
    const Axis y = axis_sample(g.y1, g.bh, k, ss, H);
    if (!y.outside) { f.y_lo = min(f.y_lo, y.i0); f.y_hi = max(f.y_hi, y.i1); }
    const Axis x = axis_sample(g.x1, g.bw, k, ss, W);
    if (!x.outside) { f.x_lo = min(f.x_lo, x.i0); f.x_hi = max(f.x_hi, x.i1); }
    if (tab) {
      tab[k] = Samp{y.i0 | y.i1 << 16, k / ss, y.outside ? 0.f : y.h, y.outside ? 0.f : y.l};
      tab[n + k] = Samp{x.i0 | x.i1 << 16, k / ss, x.outside ? 0.f : x.h,
                        x.outside ? 0.f : x.l};
    }
  }
  if (f.y_lo > f.y_hi || f.x_lo > f.x_hi) f = Foot{0, -1, 0, -1};
  return f;
}

// 16-byte vectors of the map's dtype: 8 bf16 or 4 f32 channels.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

// ---------------------------------------------------------------------------
// Forward.
//
// Replaces the Pallas TPU kernel
// nsgp_repre_tpu/ops/roi_align_pallas.py::_roi_kernel
// (multilevel_roi_align_pallas / multilevel_roi_align_window).
//
// What bounds it on the H100: memory. It writes R*out^2*C outputs and
// reads the map rows its taps touch (16 per bin at ss = 2; neighbouring
// bins share rows, which stay in L1/L2). One block per RoI: its first
// threads compute the RoI's y and x sample tables into shared memory
// once; then each thread takes (bin, 16-byte channel vector) items, so a
// warp reads whole 512-byte NHWC rows (bf16, C = 256) with 16-byte loads
// and writes its bin with 16-byte stores. Per tap the sums run in the
// plain version's corner order (y0x0, y1x0, y0x1, y1x1) and round once.

struct Levels {
  const void* f[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, rounded to f32
};

constexpr int kFwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_kernel(Levels lv, int L, const float* __restrict__ rois,
                 const int* __restrict__ batch_idx, T* __restrict__ out, int C, int out_size,
                 int ss, float finest_scale, float offset) {
  constexpr int V = Vec<T>::N;
  __shared__ Axis sy[kMaxSamples], sx[kMaxSamples];
  const int r = blockIdx.x;
  const float* roi = rois + 4 * r;
  const int l = route_level(roi, L, finest_scale);
  const int H = lv.h[l], W = lv.w[l];
  const int n = out_size * ss;
  if (threadIdx.x < 2 * n) {
    const Grid g = roi_grid(roi, lv.scale[l], out_size, offset);
    const int k = threadIdx.x;
    if (k < n) sy[k] = axis_sample(g.y1, g.bh, k, ss, H);
    else sx[k - n] = axis_sample(g.x1, g.bw, k - n, ss, W);
  }
  __syncthreads();

  const T* f = (const T*)lv.f[l] + (long)batch_idx[r] * H * W * C;
  const float inv_ss = 1.f / (float)ss;
  const float norm = inv_ss * inv_ss;
  const int nv = C / V;
  const int items = out_size * out_size * nv;
  T* o = out + (long)r * out_size * out_size * C;
  for (int it = threadIdx.x; it < items; it += kFwdThreads) {
    const int bin = it / nv;
    const int c = (it - bin * nv) * V;
    const int by = bin / out_size, bx = bin - by * out_size;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int a = 0; a < ss; ++a) {
      const Axis y = sy[by * ss + a];
      for (int b = 0; b < ss; ++b) {
        const Axis x = sx[bx * ss + b];
        // an outside sample adds +-0 (zero weights): skip its loads
        if (y.outside || x.outside) continue;
        const float w00 = y.h * x.h, w01 = y.h * x.l, w10 = y.l * x.h, w11 = y.l * x.l;
        float f00[V], f10[V], f01[V], f11[V];
        load16(f + ((long)y.i0 * W + x.i0) * C + c, f00);
        load16(f + ((long)y.i1 * W + x.i0) * C + c, f10);
        load16(f + ((long)y.i0 * W + x.i1) * C + c, f01);
        load16(f + ((long)y.i1 * W + x.i1) * C + c, f11);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = w00 * f00[j];
          v += w10 * f10[j];
          v += w01 * f01[j];
          v += w11 * f11[j];
          acc[j] += v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = acc[j] * norm;
    store16(o + (long)bin * C + c, acc);
  }
}

// ---------------------------------------------------------------------------
// Backward: the gradient into the level maps, the transpose of the
// forward.
//
// Replaces the Pallas TPU kernel
// nsgp_repre_tpu/ops/roi_align_pallas.py::_roi_bwd_kernel
// (multilevel_roi_align_bwd_pallas, used by _window_bwd). The TPU kernel
// carries the sum from one RoI to the next in its sequential grid and is
// deterministic (:606-610). Here each block owns a piece of the OUTPUT and
// pulls in the RoIs that touch it, in RoI order, so the result is
// deterministic too and needs no atomics, no zeroed f32 buffer and no
// cast pass:
//
// 1. roi_bin_kernel, one thread per RoI: level, the sample table (its
//    y and x samples' corners, bins and weights, into global scratch),
//    footprint (the rows and columns its taps can reach), and one bit per
//    (8x8 map tile it meets, RoI) set with an integer atomicOr (an OR is
//    order-free), and each tile's RoI count; roi_tile_order_kernel then
//    orders the tiles by count, so that the tiles that collect many RoIs
//    (the sampler's positives around a ground-truth box) start first.
// 2. roi_align_bwd_kernel, one block of one warp per (image, level, 8x8
//    tile, 32 channels; one channel per lane). A warp shares nothing with
//    other warps, so no warp waits at a block barrier for another and the
//    16 warps an SM holds (128 registers each) hide each other's
//    latencies. The warp
//    compacts its tile's bit mask into the list of its RoIs in index
//    order, then for each RoI
//    - cp.async brings in the RoI's g slice (out^2 bins x 32 channels) and
//      sample table, double-buffered: the next RoI's land during this
//      one's taps;
//    - lanes 0-15 turn the table into the weight of each of the tile's 8
//      rows and 8 columns per bin (the sum of the bin's samples' corner
//      weights on it), and ballots give the rows, columns and bins any
//      tap reaches;
//    - for each reached bin row, the x pass sums g/ss^2 times each
//      column's weights over the reached bins (the TPU kernel's g·Wx
//      restricted to the tile), and the y pass adds each reached row's
//      weight times those sums to the tile's 64 pixels, held in f32
//      registers (Wy^T·(g·Wx)).
//    The add order of every output is fixed: RoI index, then bin row,
//    then bin column (and within a bin, sample, corner).
// 3. The warp writes its tile once, in the output dtype; a tile that no
//    RoI meets writes zeros.
//
// What bounds it on the H100: bytes (read g once, write the level
// gradients once); the sums run from shared memory (g, weights) and
// registers.

struct Tiles {
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  long long off[kMaxLevels];  // first row of the level in the flat (rows, C) output
  int ty[kMaxLevels];         // tiles per image down and across
  int tx[kMaxLevels];
  int base[kMaxLevels];       // first tile of the level
  int count[kMaxLevels];      // tiles of the level over all images
};

constexpr int kTile = 8;        // map pixels per tile side
constexpr int kChunk = 32;      // channels per block: one warp, one channel per lane
constexpr int kMaxSide = 32768;  // map rows and columns (two corners packed in a Samp's int)
constexpr int kListRois = 1024;  // RoIs per list pass: one mask word per lane
constexpr int kMaxOut = 32;     // out_size (bins per axis, one bit each in a mask)
constexpr int kMaskLoads = 8;   // mask words per lane loaded at once (8192 RoIs)

__global__ void roi_bin_kernel(Tiles t, int L, int B, const float* __restrict__ rois,
                               const int* __restrict__ batch_idx, uint32_t* __restrict__ masks,
                               int* __restrict__ counts, Samp* __restrict__ tabs, int nwords,
                               int R, int out_size, int ss, float finest_scale, float offset) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int b = batch_idx[r];
  if (b < 0 || b >= B) return;
  const float* roi = rois + 4 * r;
  const int l = route_level(roi, L, finest_scale);
  const int n = out_size * ss;
  const Foot f = sample_table(roi_grid(roi, t.scale[l], out_size, offset), t.h[l], t.w[l], n,
                              ss, tabs + (long)r * 2 * n);
  if (f.y_lo > f.y_hi) return;  // every sample outside: no taps
  const uint32_t bit = 1u << (r & 31);
  for (int ty = f.y_lo / kTile; ty <= f.y_hi / kTile; ++ty)
    for (int tx = f.x_lo / kTile; tx <= f.x_hi / kTile; ++tx) {
      const long tile = t.base[l] + ((long)b * t.ty[l] + ty) * t.tx[l] + tx;
      atomicOr(masks + tile * nwords + (r >> 5), bit);
      atomicAdd(counts + tile, 1);
    }
}

// The tiles in descending order of their RoI counts (counts above 255
// share the first bucket), so that the tiles that take longest start
// first. The order within a bucket varies from run to run; the results do
// not depend on it (each tile is summed by one warp).
constexpr int kCountBuckets = 256;

__global__ void roi_tile_order_kernel(const int* __restrict__ counts, int* __restrict__ order,
                                      int n_tiles) {
  __shared__ int off[kCountBuckets];
  for (int i = threadIdx.x; i < kCountBuckets; i += blockDim.x) off[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x)
    atomicAdd(off + min(counts[i], kCountBuckets - 1), 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int c = kCountBuckets - 1; c >= 0; --c) {
      const int v = off[c];
      off[c] = s;
      s += v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x)
    order[atomicAdd(off + min(counts[i], kCountBuckets - 1), 1)] = i;
}

// Footprints alone, (R, 5) int32: level, y_lo, y_hi, x_lo, x_hi; for
// comparing the binning rule with its plain version.
__global__ void roi_footprint_kernel(Tiles t, int L, const float* __restrict__ rois,
                                     int* __restrict__ out, int R, int out_size, int ss,
                                     float finest_scale, float offset) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* roi = rois + 4 * r;
  const int l = route_level(roi, L, finest_scale);
  const Foot f = sample_table(roi_grid(roi, t.scale[l], out_size, offset), t.h[l], t.w[l],
                              out_size * ss, ss, nullptr);
  int* o = out + 5 * r;
  o[0] = l; o[1] = f.y_lo; o[2] = f.y_hi; o[3] = f.x_lo; o[4] = f.x_hi;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

// The RoI's g slice for channels [c0, c0 + kChunk) (bins rows of kChunk
// values) and its 2n-entry sample table.
template <typename G>
__device__ __forceinline__ void fetch_roi(G* dst, Samp* dtab, const G* grad, const Samp* tabs,
                                          int r, int bins, int n, int C, int c0) {
  constexpr int P = kChunk * (int)sizeof(G) / 16;  // 16-byte pieces per bin
  for (int i = threadIdx.x; i < bins * P; i += 32) {
    const int bin = i / P, p = i - bin * P;
    cp_async16(reinterpret_cast<char*>(dst + bin * kChunk) + p * 16,
               reinterpret_cast<const char*>(grad + ((long)r * bins + bin) * C + c0) + p * 16);
  }
  for (int i = threadIdx.x; i < 2 * n; i += 32) cp_async16(dtab + i, tabs + (long)r * 2 * n + i);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Dynamic shared memory of one backward block.
__host__ __device__ constexpr size_t bwd_smem_bytes(int out_size, int n, int gsize) {
  return 2 * (size_t)out_size * out_size * kChunk * gsize  // raw g slices, double-buffered
         + 2 * (size_t)2 * n * sizeof(Samp)                 // sample tables, double-buffered
         + (size_t)2 * kTile * out_size * 4                 // tile-row and tile-column weights
         + kListRois * sizeof(uint16_t);                    // this pass's RoIs
}

template <typename G, typename O>
__global__ void __launch_bounds__(32)
roi_align_bwd_kernel(Tiles t, int L, const Samp* __restrict__ tabs, const G* __restrict__ grad,
                     O* __restrict__ out, const uint32_t* __restrict__ masks,
                     const int* __restrict__ order, int nwords, int C, int out_size, int ss) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bins = out_size * out_size, n = out_size * ss;
  G* raw = reinterpret_cast<G*>(smem);
  Samp* stab = reinterpret_cast<Samp*>(raw + 2 * bins * kChunk);
  float* wt = reinterpret_cast<float*>(stab + 2 * 2 * n);  // [bin][row 0-7, column 0-7]
  uint16_t* list = reinterpret_cast<uint16_t*>(wt + 2 * kTile * out_size);

  const int lane = threadIdx.x;
  const int nch = C / kChunk;
  const int c0 = (blockIdx.x % nch) * kChunk;
  const int tile = order[blockIdx.x / nch];
  int l = 0;
  while (l < L - 1 && (tile < t.base[l] || tile >= t.base[l] + t.count[l])) ++l;
  const int H = t.h[l], W = t.w[l];
  int rest = tile - t.base[l];
  const int x0 = (rest % t.tx[l]) * kTile;
  rest /= t.tx[l];
  const int y0 = (rest % t.ty[l]) * kTile;
  const int b = rest / t.ty[l];
  // the mean over a bin's samples, as the plain version rounds g / ss^2 (a
  // multiply by the exact reciprocal when ss^2 is a power of two)
  const int nsq = ss * ss;
  const bool pow2 = (nsq & (nsq - 1)) == 0;
  const float n_samples = (float)nsq, inv_n = 1.f / n_samples;
  // the tile row (p < 8) or column (p >= 8) whose weights this lane sums,
  // for every other bin starting at bin lane / 16
  const int p = lane & (2 * kTile - 1);
  const bool is_row = p < kTile;
  const int at = (is_row ? y0 : x0) + (p & (kTile - 1));

  float acc[kTile * kTile];  // pixel (y, x) of the tile at y * 8 + x, channel c0 + lane
#pragma unroll
  for (int i = 0; i < kTile * kTile; ++i) acc[i] = 0.f;

  const uint32_t* mask = masks + (long)tile * nwords;
  for (int wb = 0; wb < nwords; wb += 32 * kMaskLoads) {
    // kMaskLoads words per lane in flight at once; a pass per group of 32
    // words that holds a RoI
    uint32_t mw[kMaskLoads];
    uint32_t live = 0;
#pragma unroll
    for (int j = 0; j < kMaskLoads; ++j) {
      const int wi = wb + 32 * j + lane;
      mw[j] = wi < nwords ? __ldg(mask + wi) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kMaskLoads; ++j)
      if (__any_sync(0xffffffffu, mw[j] != 0u)) live |= 1u << j;
    for (; live; live &= live - 1) {
      const int jl = __ffs(live) - 1;
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < kMaskLoads; ++j)
        if (j == jl) m = mw[j];
      const int w0 = wb + 32 * jl;
      // this pass's RoIs in index order: a warp scan of its 32 mask words
      const int cnt = __popc(m);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int nr = __shfl_sync(0xffffffffu, incl, 31);
      int pos = incl - cnt;
      for (uint32_t mm = m; mm; mm &= mm - 1) list[pos++] = (uint16_t)(lane * 32 + __ffs(mm) - 1);
      __syncwarp();

      const int rbase = w0 * 32;
      fetch_roi(raw, stab, grad, tabs, rbase + list[0], bins, n, C, c0);
      cp_async_commit();
      for (int i = 0; i < nr; ++i) {
        const int cur = i & 1;
        if (i + 1 < nr)
          fetch_roi(raw + (cur ^ 1) * bins * kChunk, stab + (cur ^ 1) * 2 * n, grad, tabs,
                    rbase + list[i + 1], bins, n, C, c0);
        cp_async_commit();  // possibly empty: keeps wait_group 1 exact
        cp_async_wait1();
        __syncwarp();  // this RoI's slice and table have landed for every lane

        // the weight of each tile row and column per bin: the sum of the
        // bin's samples' corner weights on it, in sample order
        uint32_t nzb = 0;  // bins with a nonzero weight on this lane's row or column
        const Samp* tab = stab + cur * 2 * n + (is_row ? 0 : n);
        for (int bin = lane >> 4; bin < out_size; bin += 2) {
          float w = 0.f;
          for (int k = bin * ss; k < bin * ss + ss; ++k) {
            const Samp a = tab[k];
            if ((a.idx & 0xffff) == at) w += a.h;
            if ((a.idx >> 16) == at) w += a.l;
          }
          wt[bin * 2 * kTile + p] = w;
          if (w != 0.f) nzb |= 1u << bin;
        }
        const uint32_t rb = __ballot_sync(0xffffffffu, is_row && nzb);
        const uint32_t cb = __ballot_sync(0xffffffffu, !is_row && nzb);
        const uint32_t rows = (rb | rb >> 16) & 0xffu;
        const uint32_t cols = ((cb | cb >> 16) >> kTile) & 0xffu;
        const uint32_t bys = __reduce_or_sync(0xffffffffu, is_row ? nzb : 0u);
        const uint32_t bxs = __reduce_or_sync(0xffffffffu, is_row ? 0u : nzb);
        __syncwarp();  // the weights are visible to every lane
        if (!rows || !cols) {
          __syncwarp();
          continue;
        }

        // for each bin row the RoI reaches: the x pass (g / ss^2 times the
        // column weights, summed over the reached bins: the TPU kernel's
        // g·Wx restricted to the tile), then the y pass (each reached pixel
        // adds its row's weight times its column's x sum: Wy^T·(g·Wx))
        const G* gs = raw + cur * bins * kChunk + lane;
        for (uint32_t mby = bys; mby; mby &= mby - 1) {
          const int by = __ffs(mby) - 1;
          float xs[kTile];
#pragma unroll
          for (int x = 0; x < kTile; ++x) xs[x] = 0.f;
          for (uint32_t mbx = bxs; mbx; mbx &= mbx - 1) {
            const int bx = __ffs(mbx) - 1;
            const float gv = to_f(gs[(by * out_size + bx) * kChunk]);
            const float4 wa = *reinterpret_cast<const float4*>(wt + bx * 2 * kTile + kTile);
            const float4 wb = *reinterpret_cast<const float4*>(wt + bx * 2 * kTile + kTile + 4);
            const float wx[kTile] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int x = 0; x < kTile; ++x) xs[x] = fmaf(gv, wx[x], xs[x]);
          }
#pragma unroll
          for (int x = 0; x < kTile; ++x) xs[x] = pow2 ? xs[x] * inv_n : xs[x] / n_samples;
          const float4 ya = *reinterpret_cast<const float4*>(wt + by * 2 * kTile);
          const float4 yb = *reinterpret_cast<const float4*>(wt + by * 2 * kTile + 4);
          const float wy[kTile] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
          for (int y = 0; y < kTile; ++y) {
            if (wy[y] == 0.f) continue;
#pragma unroll
            for (int x = 0; x < kTile; ++x)
              acc[y * kTile + x] = fmaf(wy[y], xs[x], acc[y * kTile + x]);
          }
        }
        __syncwarp();  // the weights and this slice's buffers are free again
      }
    }
  }

  O* o = out + (t.off[l] + (long)b * H * W) * C + c0 + lane;
#pragma unroll
  for (int y = 0; y < kTile; ++y) {
#pragma unroll
    for (int x = 0; x < kTile; ++x)
      if (y0 + y < H && x0 + x < W)
        store1(o + ((long)(y0 + y) * W + x0 + x) * C, acc[y * kTile + x]);
  }
}

Tiles make_tiles(const int* hs, const int* ws, const float* scales, const long long* offs, int L,
                 int B) {
  Tiles t{};
  int base = 0;
  for (int i = 0; i < L; ++i) {
    t.h[i] = hs[i];
    t.w[i] = ws[i];
    t.scale[i] = scales[i];
    t.off[i] = offs ? offs[i] : 0;
    t.ty[i] = (hs[i] + kTile - 1) / kTile;
    t.tx[i] = (ws[i] + kTile - 1) / kTile;
    t.base[i] = base;
    t.count[i] = B * t.ty[i] * t.tx[i];
    base += t.count[i];
  }
  return t;
}

template <typename G, typename O>
cudaError_t launch_bwd(const Tiles& t, int L, int n_tiles, const Samp* tabs, const void* grad,
                       void* out, const uint32_t* masks, const int* order, int nwords, int C,
                       int out_size, int ss, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(out_size, out_size * ss, (int)sizeof(G));
  cudaError_t e = cudaFuncSetAttribute(roi_align_bwd_kernel<G, O>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  roi_align_bwd_kernel<G, O><<<n_tiles * (C / kChunk), 32, smem, s>>>(
      t, L, tabs, (const G*)grad, (O*)out, masks, order, nwords, C, out_size, ss);
  return cudaGetLastError();
}

}  // namespace

// feats: L NHWC maps (B, H_l, W_l, C), one dtype, 16-byte aligned; rois
// (R, 4) f32 image coordinates; batch_idx (R,) int32; out (R, out_size,
// out_size, C). dtype: 0 = float32, 1 = bfloat16. C a multiple of the
// 16-byte vector (4 f32, 8 bf16); out_size * ss <= 64.
extern "C" int nsgp_roi_align(const void* const* feats, const int* hs, const int* ws,
                              const float* scales, int L, const void* rois,
                              const void* batch_idx, void* out, int R, int C,
                              int out_size, int ss, float finest_scale, int aligned,
                              int dtype, void* stream) {
  if (L < 1 || L > kMaxLevels || out_size * ss > kMaxSamples || ss < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Levels lv;
  for (int i = 0; i < L; ++i) {
    lv.f[i] = feats[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float offset = aligned ? 0.5f : 0.f;
  if (dtype == 1)
    roi_align_kernel<__nv_bfloat16><<<R, kFwdThreads, 0, s>>>(
        lv, L, (const float*)rois, (const int*)batch_idx, (__nv_bfloat16*)out, C, out_size,
        ss, finest_scale, offset);
  else
    roi_align_kernel<float><<<R, kFwdThreads, 0, s>>>(lv, L, (const float*)rois,
                                                      (const int*)batch_idx, (float*)out, C,
                                                      out_size, ss, finest_scale, offset);
  return (int)cudaGetLastError();
}

// grad (R, out_size, out_size, C) in grad_dtype (0 = f32, 1 = bf16); rois,
// batch_idx as in the forward; out: the flat (rows, C) gradient of all L
// levels in out_dtype (level l's (B, H_l, W_l) rows start at offs[l]),
// every element written. Scratch: masks, one uint32 word per (8x8 tile
// of every level and image, 32 RoIs), then two ints per tile (its RoI
// count and the launch order), zeroed and filled here; tabs, R * 2 *
// out_size * ss entries of 16 bytes. C a multiple of 32; out_size <= 32;
// out_size * ss <= 64.
extern "C" int nsgp_roi_align_bwd(const int* hs, const int* ws, const float* scales,
                                  const long long* offs, int L, int B, const void* rois,
                                  const void* batch_idx, const void* grad, int grad_dtype,
                                  void* out, int out_dtype, void* masks, void* tabs, int R,
                                  int C, int out_size, int ss, float finest_scale, int aligned,
                                  void* stream) {
  if (L < 1 || L > kMaxLevels || out_size * ss > kMaxSamples || out_size > kMaxOut || ss < 1 ||
      C % kChunk)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < L; ++i)
    if (hs[i] >= kMaxSide || ws[i] >= kMaxSide) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Tiles t = make_tiles(hs, ws, scales, offs, L, B);
  int n_tiles = 0;
  for (int i = 0; i < L; ++i) n_tiles += t.count[i];
  const int nwords = (R + 31) / 32;
  uint32_t* m = (uint32_t*)masks;
  int* counts = (int*)(m + (size_t)n_tiles * nwords);
  int* order = counts + n_tiles;
  Samp* tab = (Samp*)tabs;
  cudaError_t e = cudaMemsetAsync(masks, 0, ((size_t)n_tiles * nwords + n_tiles) * 4, s);
  if (e != cudaSuccess) return (int)e;
  if (R > 0)
    roi_bin_kernel<<<(R + 255) / 256, 256, 0, s>>>(
        t, L, B, (const float*)rois, (const int*)batch_idx, m, counts, tab, nwords, R,
        out_size, ss, finest_scale, aligned ? 0.5f : 0.f);
  roi_tile_order_kernel<<<1, 1024, 0, s>>>(counts, order, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (grad_dtype == 1 && out_dtype == 1)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(t, L, n_tiles, tab, grad, out, m, order,
                                                         nwords, C, out_size, ss, s);
  if (grad_dtype == 1)
    return (int)launch_bwd<__nv_bfloat16, float>(t, L, n_tiles, tab, grad, out, m, order, nwords,
                                                 C, out_size, ss, s);
  if (out_dtype == 1)
    return (int)launch_bwd<float, __nv_bfloat16>(t, L, n_tiles, tab, grad, out, m, order, nwords,
                                                 C, out_size, ss, s);
  return (int)launch_bwd<float, float>(t, L, n_tiles, tab, grad, out, m, order, nwords, C,
                                       out_size, ss, s);
}

// The binning pass's footprints, (R, 5) int32 (level, y_lo, y_hi, x_lo,
// x_hi), for comparing it with ops/roi_align.py::roi_footprints.
extern "C" int nsgp_roi_footprints(const int* hs, const int* ws, const float* scales, int L,
                                   const void* rois, void* out, int R, int out_size, int ss,
                                   float finest_scale, int aligned, void* stream) {
  if (L < 1 || L > kMaxLevels || ss < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const Tiles t = make_tiles(hs, ws, scales, nullptr, L, 1);
  roi_footprint_kernel<<<(R + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      t, L, (const float*)rois, (int*)out, R, out_size, ss, finest_scale, aligned ? 0.5f : 0.f);
  return (int)cudaGetLastError();
}
