// FPN multilevel RoIAlign forward on NHWC maps.
//
// Replaces the Pallas TPU kernel
// nsgp_repre_tpu/ops/roi_align_pallas.py::_roi_kernel
// (multilevel_roi_align_pallas / multilevel_roi_align_window): 7x7 bins, a
// fixed 2x2 sample grid per bin, aligned=True, mmcv's zeroing of samples
// more than one pixel outside the map, f32 accumulation, output in the
// feature dtype.
//
// Routing is the standard mmdet rule (single_level_roi_extractor.py:44,
// the JAX package's ops/roi_align.py::multilevel_roi_align):
//   lvl = clamp(floor(log2(sqrt(area) / finest_scale + 1e-6)), 0, L-1).
// The TPU kernel's coarser-level bump for RoIs whose samples overflow its
// DMA window has no counterpart here: there is no window.
//
// What bounds it on the H100: memory. At predict (R = 1000 per image,
// C = 256) it writes R*49*256 outputs and reads 16 bilinear taps per bin
// from the level maps; the taps of neighbouring bins overlap and stay in
// L1/L2. One block per (RoI, bin row) and one thread per channel: every
// tap is one coalesced read of a C-wide NHWC row, with no shared memory
// and no atomics. The sample coordinates and weights are recomputed by
// each thread (scalar work, identical across the block). Compiled with
// -fmad=false so the sample coordinates round exactly as in the plain
// version (a separately rounded multiply and add).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;

struct Levels {
  const void* f[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, rounded to f32
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Bilinear corner offsets and weights of one sample (mmcv semantics, the
// JAX package's ops/roi_align.py::_bilinear_weights_indices).
struct Tap {
  int y0, y1, x0, x1;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Tap bilinear(float y, float x, int H, int W) {
  Tap t;
  const float fh = (float)H, fw = (float)W;
  const bool outside = (y < -1.f) || (y > fh) || (x < -1.f) || (x > fw);
  y = fminf(fmaxf(y, 0.f), fh - 1.f);
  x = fminf(fmaxf(x, 0.f), fw - 1.f);
  const float y0 = floorf(y), x0 = floorf(x);
  const float y1 = fminf(y0 + 1.f, fh - 1.f), x1 = fminf(x0 + 1.f, fw - 1.f);
  const float ly = y - y0, lx = x - x0;
  const float hy = 1.f - ly, hx = 1.f - lx;
  t.y0 = (int)y0; t.y1 = (int)y1; t.x0 = (int)x0; t.x1 = (int)x1;
  t.w00 = outside ? 0.f : hy * hx;
  t.w01 = outside ? 0.f : hy * lx;
  t.w10 = outside ? 0.f : ly * hx;
  t.w11 = outside ? 0.f : ly * lx;
  return t;
}

template <typename T>
__global__ void roi_align_kernel(Levels lv, int L, const float* __restrict__ rois,
                                 const int* __restrict__ batch_idx, T* __restrict__ out,
                                 int C, int out_size, int ss, float finest_scale,
                                 float offset) {
  const int r = blockIdx.x, by = blockIdx.y, c = threadIdx.x;
  const float rx1 = rois[4 * r + 0], ry1 = rois[4 * r + 1];
  const float rx2 = rois[4 * r + 2], ry2 = rois[4 * r + 3];
  const float area = (rx2 - rx1) * (ry2 - ry1);
  const float sc = sqrtf(fmaxf(area, 0.f));
  float lf = floorf(log2f(sc / finest_scale + 1e-6f));
  lf = fminf(fmaxf(lf, 0.f), (float)(L - 1));
  const int l = (int)lf;
  const int H = lv.h[l], W = lv.w[l];
  const float s = lv.scale[l];
  const T* f = (const T*)lv.f[l] + (long)batch_idx[r] * H * W * C;

  const float x1 = rx1 * s - offset;
  const float y1 = ry1 * s - offset;
  const float bw = (rx2 - rx1) * s / (float)out_size;
  const float bh = (ry2 - ry1) * s / (float)out_size;
  const float inv_ss = 1.f / (float)ss;

  T* o = out + (((long)r * out_size + by) * out_size) * C + c;
  for (int bx = 0; bx < out_size; ++bx) {
    float acc = 0.f;
    for (int sy = 0; sy < ss; ++sy) {
      const float gy = (float)by + ((float)sy + 0.5f) / (float)ss;
      const float y = y1 + gy * bh;
      for (int sx = 0; sx < ss; ++sx) {
        const float gx = (float)bx + ((float)sx + 0.5f) / (float)ss;
        const float x = x1 + gx * bw;
        const Tap t = bilinear(y, x, H, W);
        // corner order of the plain version: y0x0, y1x0, y0x1, y1x1
        float v = t.w00 * to_f(f[((long)t.y0 * W + t.x0) * C + c]);
        v += t.w10 * to_f(f[((long)t.y1 * W + t.x0) * C + c]);
        v += t.w01 * to_f(f[((long)t.y0 * W + t.x1) * C + c]);
        v += t.w11 * to_f(f[((long)t.y1 * W + t.x1) * C + c]);
        acc += v;
      }
    }
    o[(long)bx * C] = from_f<T>(acc * (inv_ss * inv_ss));
  }
}

// ---------------------------------------------------------------------------
// Backward: d features += the transpose of the forward, per RoI.
//
// Replaces the Pallas TPU kernel
// nsgp_repre_tpu/ops/roi_align_pallas.py::_roi_bwd_kernel
// (multilevel_roi_align_bwd_pallas, used by _window_bwd): per RoI, its
// bin gradients spread back onto the level map through the same bilinear
// taps, accumulated in f32 and cast once to the feature dtype (the JAX
// package accumulates in f32 too, roi_align_pallas.py:726-731). RoI and
// batch-index gradients do not exist: proposals are data.
//
// What bounds it on the H100: bytes (read g once, write the level
// gradients once). Same layout as the forward: one block per (RoI, bin
// row), one thread per channel, the sample coordinates recomputed per
// thread with the forward's exact arithmetic. Each tap is one coalesced
// C-wide atomicAdd into a zeroed f32 NHWC buffer (all levels in one
// buffer); the wrapper casts it to the feature dtype. The TPU kernel runs its RoIs
// in order and is deterministic (:606-610); here the f32 sums of
// overlapping RoIs are added in whatever order the atomics land, so the
// result can differ from run to run in the last bits of f32 (the tests
// state a tolerance for it).

struct LevelRows {
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  long off[kMaxLevels];  // first row of the level in the flat (rows, C) buffer
};

template <typename G>
__global__ void roi_align_bwd_kernel(LevelRows lv, int L, const float* __restrict__ rois,
                                     const int* __restrict__ batch_idx,
                                     const G* __restrict__ grad, float* __restrict__ acc, int C,
                                     int out_size, int ss, float finest_scale, float offset) {
  const int r = blockIdx.x, by = blockIdx.y, c = threadIdx.x;
  const float rx1 = rois[4 * r + 0], ry1 = rois[4 * r + 1];
  const float rx2 = rois[4 * r + 2], ry2 = rois[4 * r + 3];
  const float area = (rx2 - rx1) * (ry2 - ry1);
  const float sc = sqrtf(fmaxf(area, 0.f));
  float lf = floorf(log2f(sc / finest_scale + 1e-6f));
  lf = fminf(fmaxf(lf, 0.f), (float)(L - 1));
  const int l = (int)lf;
  const int H = lv.h[l], W = lv.w[l];
  const float s = lv.scale[l];
  float* f = acc + (lv.off[l] + (long)batch_idx[r] * H * W) * C + c;

  const float x1 = rx1 * s - offset;
  const float y1 = ry1 * s - offset;
  const float bw = (rx2 - rx1) * s / (float)out_size;
  const float bh = (ry2 - ry1) * s / (float)out_size;
  const float n_samples = (float)(ss * ss);

  const G* gr = grad + (((long)r * out_size + by) * out_size) * C + c;
  for (int bx = 0; bx < out_size; ++bx) {
    // the mean over the bin's samples: each sample gets g / (ss * ss)
    const float gv = to_f(gr[(long)bx * C]) / n_samples;
    for (int sy = 0; sy < ss; ++sy) {
      const float gy = (float)by + ((float)sy + 0.5f) / (float)ss;
      const float y = y1 + gy * bh;
      for (int sx = 0; sx < ss; ++sx) {
        const float gx = (float)bx + ((float)sx + 0.5f) / (float)ss;
        const float x = x1 + gx * bw;
        const Tap t = bilinear(y, x, H, W);
        if (t.w00 == 0.f && t.w01 == 0.f && t.w10 == 0.f && t.w11 == 0.f) continue;
        atomicAdd(f + ((long)t.y0 * W + t.x0) * C, gv * t.w00);
        atomicAdd(f + ((long)t.y1 * W + t.x0) * C, gv * t.w10);
        atomicAdd(f + ((long)t.y0 * W + t.x1) * C, gv * t.w01);
        atomicAdd(f + ((long)t.y1 * W + t.x1) * C, gv * t.w11);
      }
    }
  }
}

}  // namespace

// feats: L NHWC maps (B, H_l, W_l, C), one dtype; rois (R, 4) f32 image
// coordinates; batch_idx (R,) int32; out (R, out_size, out_size, C).
// dtype: 0 = float32, 1 = bfloat16. C <= 1024 (one thread per channel).
extern "C" int nsgp_roi_align(const void* const* feats, const int* hs, const int* ws,
                              const float* scales, int L, const void* rois,
                              const void* batch_idx, void* out, int R, int C,
                              int out_size, int ss, float finest_scale, int aligned,
                              int dtype, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Levels lv;
  for (int i = 0; i < L; ++i) {
    lv.f[i] = feats[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(R, out_size);
  const float offset = aligned ? 0.5f : 0.f;
  if (dtype == 1)
    roi_align_kernel<__nv_bfloat16><<<grid, C, 0, s>>>(
        lv, L, (const float*)rois, (const int*)batch_idx, (__nv_bfloat16*)out, C, out_size,
        ss, finest_scale, offset);
  else
    roi_align_kernel<float><<<grid, C, 0, s>>>(lv, L, (const float*)rois,
                                               (const int*)batch_idx, (float*)out, C,
                                               out_size, ss, finest_scale, offset);
  return (int)cudaGetLastError();
}

// grad (R, out_size, out_size, C) in grad_dtype (0 = f32, 1 = bf16); rois,
// batch_idx as in the forward; acc: the flat f32 (rows, C) buffer of all L
// levels (level l's (B, H_l, W_l) rows start at offs[l]), zeroed here and
// accumulated. C <= 1024.
extern "C" int nsgp_roi_align_bwd(const int* hs, const int* ws, const float* scales,
                                  const long long* offs, int L, const void* rois,
                                  const void* batch_idx, const void* grad, int grad_dtype,
                                  void* acc, long long rows, int R, int C,
                                  int out_size, int ss, float finest_scale, int aligned,
                                  void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)rows * C * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  LevelRows lv;
  for (int i = 0; i < L; ++i) {
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
    lv.off[i] = (long)offs[i];
  }
  const float offset = aligned ? 0.5f : 0.f;
  if (R > 0) {
    dim3 grid(R, out_size);
    if (grad_dtype == 1)
      roi_align_bwd_kernel<__nv_bfloat16><<<grid, C, 0, s>>>(
          lv, L, (const float*)rois, (const int*)batch_idx, (const __nv_bfloat16*)grad,
          (float*)acc, C, out_size, ss, finest_scale, offset);
    else
      roi_align_bwd_kernel<float><<<grid, C, 0, s>>>(lv, L, (const float*)rois,
                                                     (const int*)batch_idx, (const float*)grad,
                                                     (float*)acc, C, out_size, ss, finest_scale,
                                                     offset);
  }
  return (int)cudaGetLastError();
}
