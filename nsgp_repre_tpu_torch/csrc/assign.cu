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
// Two phases, as on the TPU. Phase 1 takes each gt's maximum IoU over all
// anchors: one block per 256 anchors writes per-block partial maxima and
// a second kernel reduces them (a max is order-independent, so the result
// does not depend on the schedule). Phase 2 recomputes each IoU and
// applies the rules. The claim test ``iou == gt_max`` needs the IoU to be
// bit-identical in both phases and in the plain version: the source is
// compiled with -fmad=false and keeps bbox_overlaps' operation order
// (union = max(area_g + area_a - inter, eps), then inter / union with an
// IEEE division).
//
// What bounds it on the H100: bytes. Valid gts are compacted into shared
// memory, so the work is (valid gts) x N IoUs per phase (a few per image
// at the main shapes), far below the f32 peak; the outputs (assigned,
// max_overlaps, 4 targets: 24 bytes per anchor) dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 512;
constexpr int kNeg = -1;
constexpr int kIgnore = -2;
constexpr float kEps = 1e-6f;

struct GtList {
  float4 box[kMaxG];
  float area[kMaxG];
  int idx[kMaxG];
  int n;
};

// the image's valid gts, compacted in index order (G <= kMaxG): each
// thread tests one slot, a ballot per warp and a prefix over the warps
// give its place
__device__ void load_valid_gts(GtList& s, const float4* gt, const uint8_t* gt_valid, int G) {
  __shared__ int warp_count[kWarps];
  __shared__ int base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int g0 = 0; g0 < G; g0 += kThreads) {
    const int g = g0 + threadIdx.x;
    const bool v = g < G && gt_valid[g];
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int at = base + __popc(m & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += warp_count[w];
    if (v) {
      const float4 b = gt[g];
      s.box[at] = b;
      s.area[at] = (b.z - b.x) * (b.w - b.y);
      s.idx[at] = g;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kWarps; ++w) base += warp_count[w];
    __syncthreads();
  }
  if (threadIdx.x == 0) s.n = base;
  __syncthreads();
}

// structures/boxes.py::bbox_overlaps, one gt against one anchor
__device__ __forceinline__ float iou(float4 g, float area_g, float4 a, float area_a) {
  const float iw = fmaxf(fminf(g.z, a.z) - fmaxf(g.x, a.x), 0.f);
  const float ih = fmaxf(fminf(g.w, a.w) - fmaxf(g.y, a.y), 0.f);
  const float inter = iw * ih;
  const float uni = fmaxf(area_g + area_a - inter, kEps);
  return inter / uni;
}

// phase 1: partial[b, blk, g] = max IoU of valid gt g over this block's anchors
__global__ void gt_max_partial_kernel(const float4* __restrict__ anchors,
                                      const float4* __restrict__ gt_boxes,
                                      const uint8_t* __restrict__ gt_valid,
                                      float* __restrict__ partial, int N, int G) {
  __shared__ GtList s;
  __shared__ float warp_max[kWarps][kMaxG];
  const int b = blockIdx.y;
  load_valid_gts(s, gt_boxes + (long)b * G, gt_valid + (long)b * G, G);
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const bool in = a < N;
  const float4 box = in ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float area = (box.z - box.x) * (box.w - box.y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < s.n; ++k) {
    float v = in ? iou(s.box[k], s.area[k], box, area) : -1.f;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) warp_max[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < s.n; k += kThreads) {
    float m = warp_max[0][k];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w][k]);
    partial[((long)b * gridDim.x + blockIdx.x) * G + s.idx[k]] = m;
  }
}

// gmax[b, g] = max over blocks of partial[b, :, g] (valid gts only)
__global__ void gt_max_reduce_kernel(const float* __restrict__ partial,
                                     const uint8_t* __restrict__ gt_valid,
                                     float* __restrict__ gmax, int nblk, int G) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (!gt_valid[(long)b * G + g]) continue;
    float m = -1.f;
    for (int k = 0; k < nblk; ++k) m = fmaxf(m, partial[((long)b * nblk + k) * G + g]);
    gmax[(long)b * G + g] = m;
  }
}

// phase 2: assignment rules and bbox2delta targets, one thread per anchor
__global__ void assign_kernel(const float4* __restrict__ anchors,
                              const float4* __restrict__ gt_boxes,
                              const uint8_t* __restrict__ gt_valid,
                              const uint8_t* __restrict__ prior_valid,
                              const float* __restrict__ gmax, int* __restrict__ assigned,
                              float* __restrict__ max_overlaps, float4* __restrict__ tgt,
                              int N, int G, float pos_iou_thr, float neg_iou_thr,
                              float min_pos_iou) {
  __shared__ GtList s;
  __shared__ float s_gmax[kMaxG];
  const int b = blockIdx.y;
  const float4* gt = gt_boxes + (long)b * G;
  load_valid_gts(s, gt, gt_valid + (long)b * G, G);
  for (int k = threadIdx.x; k < s.n; k += kThreads) s_gmax[k] = gmax[(long)b * G + s.idx[k]];
  __syncthreads();
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= N) return;
  const float4 box = anchors[a];
  const float area = (box.z - box.x) * (box.w - box.y);
  float pmax = -1.f;
  int amax = 0, claimed = -1;
  for (int k = 0; k < s.n; ++k) {
    const float v = iou(s.box[k], s.area[k], box, area);
    if (v > pmax) {  // strict: the first gt among ties keeps the argmax
      pmax = v;
      amax = s.idx[k];
    }
    if (v == s_gmax[k] && s_gmax[k] >= min_pos_iou) claimed = s.idx[k];  // the last wins
  }
  int r = kIgnore;
  if (pmax >= 0.f && pmax < neg_iou_thr) r = kNeg;
  if (pmax >= pos_iou_thr) r = amax;
  if (claimed >= 0) r = claimed;
  const long o = (long)b * N + a;
  if (!prior_valid[o]) r = kIgnore;
  assigned[o] = r;
  max_overlaps[o] = pmax;

  // bbox2delta(anchor, gt[max(r, 0)]) in structures/boxes.py's order
  const float4 m = gt[r > 0 ? r : 0];
  const float px = (box.x + box.z) * 0.5f, py = (box.y + box.w) * 0.5f;
  const float pw = fmaxf(box.z - box.x, kEps), ph = fmaxf(box.w - box.y, kEps);
  const float gx = (m.x + m.z) * 0.5f, gy = (m.y + m.w) * 0.5f;
  const float gw = m.z - m.x, gh = m.w - m.y;
  tgt[o] = make_float4((gx - px) / pw, (gy - py) / ph, logf(fmaxf(gw, kEps) / pw),
                       logf(fmaxf(gh, kEps) / ph));
}

}  // namespace

// anchors (N, 4) f32; gt_boxes (B, G, 4) f32; gt_valid (B, G) bool;
// prior_valid (B, N) bool; partial (B, ceil(N / 256), G) f32 and gmax
// (B, G) f32 scratch; outputs assigned (B, N) int32, max_overlaps (B, N)
// f32, tgt (B, N, 4) f32. G <= 512.
extern "C" int nsgp_assign(const void* anchors, const void* gt_boxes, const void* gt_valid,
                           const void* prior_valid, void* partial, void* gmax, void* assigned,
                           void* max_overlaps, void* tgt, int B, int N, int G,
                           float pos_iou_thr, float neg_iou_thr, float min_pos_iou,
                           void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + kThreads - 1) / kThreads;
  const dim3 grid(nblk, B);
  gt_max_partial_kernel<<<grid, kThreads, 0, s>>>((const float4*)anchors,
                                                  (const float4*)gt_boxes,
                                                  (const uint8_t*)gt_valid, (float*)partial, N, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gt_max_reduce_kernel<<<B, 128, 0, s>>>((const float*)partial, (const uint8_t*)gt_valid,
                                         (float*)gmax, nblk, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  assign_kernel<<<grid, kThreads, 0, s>>>(
      (const float4*)anchors, (const float4*)gt_boxes, (const uint8_t*)gt_valid,
      (const uint8_t*)prior_valid, (const float*)gmax, (int*)assigned, (float*)max_overlaps,
      (float4*)tgt, N, G, pos_iou_thr, neg_iou_thr, min_pos_iou);
  return (int)cudaGetLastError();
}
