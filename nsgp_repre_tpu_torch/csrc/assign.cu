// Fused RPN anchor assignment + regression targets.
//
// Replaces the Pallas TPU kernel
// nsgp_repre_tpu/ops/assign_pallas.py::_assign_kernel
// (rpn_assign_targets_pallas): MaxIoU assignment with low-quality claims
// (mmdet max_iou_assigner.py:85, gt_max_assign_all=True) and bbox2delta
// targets against the matched gt, without materialising the (G, N) IoU
// matrix in device memory.
//
// Semantics, as in the plain version (models/assigners.py::max_iou_assign
// + gather of the matched gt + structures/boxes.py::bbox2delta):
//   - padded gts have IoU -1 (they are skipped: they never win a max);
//   - argmax over gts takes the FIRST gt among ties, the low-quality claim
//     the LAST claiming gt;
//   - every anchor counts for a gt's best IoU, invalid anchors included;
//     invalid anchors end up IGNORE;
//   - the target of a non-positive anchor is taken against gt 0.
//
// Two launches, as the TPU kernel's two phases. Each block takes 1,024
// anchors, 4 a thread, 256 apart, so that a warp's loads and stores of
// one array fill whole 128-byte lines.
//   1. gt_max_kernel: each gt's best IoU over all anchors. Every block
//      compacts the image's valid gts (ballots, in index order, all loads
//      at once) into shared memory sized by G; block 0 of each image also
//      stores the compacted list for phase 2. Each warp reduces its maxima
//      with shuffles, the block in shared memory, and the block folds them
//      into a (B, G) buffer with one integer atomicMax per gt on the IoU's
//      bits. IoUs are >= +0 (a -0 is folded to +0 first), and for
//      non-negative floats the unsigned order of the bits is the float
//      order, so a buffer zeroed before the launch ends up holding each
//      valid gt's maximum; the -1 of a padded gt or a missing anchor is
//      never folded. A max does not depend on the order of the atomics,
//      so the result is deterministic.
//   2. assign_kernel: loads only the valid gts and their maxima, applies
//      the rules and writes the outputs (16-byte stores of the targets).
// The claim test ``iou == gt_max`` needs the IoU to be bit-identical in
// both phases and in the plain version: the source is compiled with
// -fmad=false and keeps bbox_overlaps' operation order (union =
// max(area_g + area_a - inter, eps), then inter / union with an IEEE
// division). Where inter == 0 the quotient is inter itself (+0 or -0,
// the union being positive), so the division is skipped: most
// anchor-gt pairs do not overlap.
//
// What bounds it on the H100: bytes. The work is (valid gts) x N IoUs per
// phase (a few per image at the main shapes), far below the f32 peak; the
// outputs (assigned, max_overlaps, 4 targets: 24 bytes per anchor)
// dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // anchors per thread, kThreads apart
constexpr int kSpan = kThreads * kPer;  // anchors per block
constexpr int kMaxG = 512;
constexpr int kNeg = -1;
constexpr int kIgnore = -2;
constexpr float kEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area(float4 b) { return (b.z - b.x) * (b.w - b.y); }

// structures/boxes.py::bbox_overlaps, one gt against one anchor
__device__ __forceinline__ float iou(float4 g, float area_g, float4 a, float area_a) {
  const float iw = fmaxf(fminf(g.z, a.z) - fmaxf(g.x, a.x), 0.f);
  const float ih = fmaxf(fminf(g.w, a.w) - fmaxf(g.y, a.y), 0.f);
  const float inter = iw * ih;
  if (inter == 0.f) return inter;  // == inter / uni, uni > 0
  const float uni = fmaxf(area_g + area_a - inter, kEps);
  return inter / uni;
}

// the image's valid gts, compacted in index order into shared memory
// (and, in block 0, into cg_box / cg_idx for phase 2): 256 slots at a
// time, every load in flight at once, a ballot per warp and a prefix over
// the warps; returns the count
__device__ int compact_gts(const float4* gt, const uint8_t* valid, int G, float4* s_box,
                           float* s_area, unsigned* s_max, float4* cg_box, int* cg_idx,
                           bool first) {
  __shared__ int warp_count[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int base = 0;
  for (int g0 = 0; g0 < G; g0 += kThreads) {
    const int g = g0 + threadIdx.x;
    const bool v = g < G && valid[g];
    const float4 box = g < G ? gt[g] : make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned m = __ballot_sync(kFull, v);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int at = base + __popc(m & ((1u << lane) - 1u));
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) at += warp_count[w];
      base += warp_count[w];
    }
    if (v) {
      s_box[at] = box;
      s_area[at] = area(box);
      s_max[at] = 0u;
      if (first) {
        cg_box[at] = box;
        cg_idx[at] = g;
      }
    }
    __syncthreads();
  }
  return base;
}

// phase 1: gmax[b, k] = bits of the best IoU of the image's k-th valid gt
__global__ void __launch_bounds__(kThreads)
gt_max_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt_boxes,
              const uint8_t* __restrict__ gt_valid, float4* __restrict__ cg_box,
              int* __restrict__ cg_idx, int* __restrict__ cg_n, unsigned* __restrict__ gmax,
              int N, int G) {
  extern __shared__ float4 s_box[];  // G boxes, then G areas and G block maxima
  float* s_area = reinterpret_cast<float*>(s_box + G);
  unsigned* s_max = reinterpret_cast<unsigned*>(s_area + G);
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  const bool first = blockIdx.x == 0;
  const int a0 = blockIdx.x * kSpan + threadIdx.x;
  float4 box[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {  // in flight while the gts are compacted
    const int a = a0 + i * kThreads;
    box[i] = a < N ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long bg = (long)b * G;
  const int n = compact_gts(gt_boxes + bg, gt_valid + bg, G, s_box, s_area, s_max, cg_box + bg,
                            cg_idx + bg, first);
  if (first && threadIdx.x == 0) cg_n[b] = n;
  float ar[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) ar[i] = area(box[i]);
  for (int k = 0; k < n; ++k) {
    const float4 g = s_box[k];
    const float ga = s_area[k];
    float m = -1.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (a0 + i * kThreads < N) m = fmaxf(m, iou(g, ga, box[i], ar[i]));
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0 && m >= 0.f) atomicMax(&s_max[k], __float_as_uint(m + 0.f));  // -0 -> +0
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads)
    if (s_max[k] != 0u) atomicMax(&gmax[bg + k], s_max[k]);
}

// phase 2: assignment rules and bbox2delta targets
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt_boxes,
              const float4* __restrict__ cg_box, const int* __restrict__ cg_idx,
              const int* __restrict__ cg_n, const unsigned* __restrict__ gmax,
              const uint8_t* __restrict__ prior_valid, int* __restrict__ assigned,
              float* __restrict__ max_overlaps, float4* __restrict__ tgt, int N, int G,
              float pos_iou_thr, float neg_iou_thr, float min_pos_iou) {
  extern __shared__ float4 s_box[];  // n boxes, then n areas, gt indices and maxima
  float* s_area = reinterpret_cast<float*>(s_box + G);
  int* s_idx = reinterpret_cast<int*>(s_area + G);
  float* s_gmax = reinterpret_cast<float*>(s_idx + G);
  const int b = blockIdx.y;
  const long bg = (long)b * G;
  const int n = cg_n[b];
  const int a0 = blockIdx.x * kSpan + threadIdx.x;
  float4 box[kPer];
  bool ok[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {  // in flight while the gts arrive
    const int a = a0 + i * kThreads;
    box[i] = a < N ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    ok[i] = a < N && prior_valid[(long)b * N + a];
  }
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float4 g = cg_box[bg + k];
    s_box[k] = g;
    s_area[k] = area(g);
    s_idx[k] = cg_idx[bg + k];
    s_gmax[k] = __uint_as_float(gmax[bg + k]);
  }
  __syncthreads();
  const float4* gt = gt_boxes + bg;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int a = a0 + i * kThreads;
    if (a >= N) break;
    const float ar = area(box[i]);
    float pmax = -1.f;
    int amax = 0, claimed = -1;
    for (int k = 0; k < n; ++k) {
      const float v = iou(s_box[k], s_area[k], box[i], ar);
      if (v > pmax) {  // strict: the first gt among ties keeps the argmax
        pmax = v;
        amax = s_idx[k];
      }
      if (v == s_gmax[k] && s_gmax[k] >= min_pos_iou) claimed = s_idx[k];  // the last wins
    }
    int r = kIgnore;
    if (pmax >= 0.f && pmax < neg_iou_thr) r = kNeg;
    if (pmax >= pos_iou_thr) r = amax;
    if (claimed >= 0) r = claimed;
    if (!ok[i]) r = kIgnore;
    const long o = (long)b * N + a;
    assigned[o] = r;
    max_overlaps[o] = pmax;

    // bbox2delta(anchor, gt[max(r, 0)]) in structures/boxes.py's order
    const float4 p = box[i];
    const float4 m = gt[r > 0 ? r : 0];
    const float px = (p.x + p.z) * 0.5f, py = (p.y + p.w) * 0.5f;
    const float pw = fmaxf(p.z - p.x, kEps), ph = fmaxf(p.w - p.y, kEps);
    const float gx = (m.x + m.z) * 0.5f, gy = (m.y + m.w) * 0.5f;
    const float gw = m.z - m.x, gh = m.w - m.y;
    tgt[o] = make_float4((gx - px) / pw, (gy - py) / ph, logf(fmaxf(gw, kEps) / pw),
                         logf(fmaxf(gh, kEps) / ph));
  }
}

}  // namespace

// anchors (N, 4) f32; gt_boxes (B, G, 4) f32; gt_valid (B, G) bool;
// prior_valid (B, N) bool; scratch: B * (6 * G + 1) int32 words (the
// compacted gt boxes, the gt maxima, the compacted gt indices, the valid
// counts); outputs assigned (B, N) int32, max_overlaps (B, N) f32, tgt
// (B, N, 4) f32. 1 <= G <= 512. A memset of the (B, G) maxima, then two
// launches.
extern "C" int nsgp_assign(const void* anchors, const void* gt_boxes, const void* gt_valid,
                           const void* prior_valid, void* scratch, void* assigned,
                           void* max_overlaps, void* tgt, int B, int N, int G,
                           float pos_iou_thr, float neg_iou_thr, float min_pos_iou,
                           void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long BG = (long)B * G;
  float4* cg_box = (float4*)scratch;
  unsigned* gmax = (unsigned*)(cg_box + BG);
  int* cg_idx = (int*)(gmax + BG);
  int* cg_n = cg_idx + BG;
  cudaError_t e = cudaMemsetAsync(gmax, 0, BG * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kSpan - 1) / kSpan, B);
  gt_max_kernel<<<grid, kThreads, G * (sizeof(float4) + 2 * sizeof(float)), s>>>(
      (const float4*)anchors, (const float4*)gt_boxes, (const uint8_t*)gt_valid, cg_box, cg_idx,
      cg_n, gmax, N, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  assign_kernel<<<grid, kThreads, G * (sizeof(float4) + 3 * sizeof(float)), s>>>(
      (const float4*)anchors, (const float4*)gt_boxes, cg_box, cg_idx, cg_n, gmax,
      (const uint8_t*)prior_valid, (int*)assigned, (float*)max_overlaps, (float4*)tgt, N, G,
      pos_iou_thr, neg_iou_thr, min_pos_iou);
  return (int)cudaGetLastError();
}
