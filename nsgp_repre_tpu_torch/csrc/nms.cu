// Batched greedy NMS over score-sorted boxes.
//
// Replaces the Pallas TPU kernel nsgp_repre_tpu/ops/nms_pallas.py::_nms_kernel
// (nms_pallas / batched_nms_pallas). Same contract: a box is kept when its
// IoU with every box kept before it is <= thr; equal scores go to the
// lowest index (the caller sorts with a stable descending sort, so the
// sorted order IS the greedy pick order).
//
// What bounds it on the H100: neither bytes nor FLOPs, but the sequential
// dependence of greedy NMS. The TPU design (every box in fast memory, one
// argmax over all of them per pick, max_out picks) does not carry over:
// 20,000 multiclass candidates do not fit 227 KB of shared memory, and one
// full pass per pick from L2 would read ~166 MB per image for proposals.
// Instead the work is split in two:
//   1. nms_mask: all pairwise IoU tests in parallel, (B, row-block,
//      col-block) blocks of 64x64 pairs, each pair a bit of a 64-bit word
//      (only the upper triangle; rows beyond the image's valid count
//      are skipped);
//   2. nms_sweep: one block per image walks the sorted boxes 64 at a time;
//      one thread resolves the 64 boxes of a row block against the
//      suppression bits, then all threads OR the kept rows' words into the
//      shared "removed" bitmap. It stops after max_out keeps.
// The mask kernel is compiled with -fmad=false, and the IoU is written in
// the order of the plain version (union clamped to >= 1e-6, suppress when
// iou > thr), so a pair exactly at the threshold is decided the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float thr) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  const float inter = iw * ih;
  const float area_b = (b.z - b.x) * (b.w - b.y);
  const float uni = fmaxf(area_a + area_b - inter, 1e-6f);
  return inter / uni > thr;
}

__global__ void __launch_bounds__(kBlock)
nms_mask(const float4* __restrict__ boxes, const int* __restrict__ n_valid, float thr,
         unsigned long long* __restrict__ mask, int N, int nblk) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int nv = n_valid[b];
  // the sweep reads only words at or right of the diagonal, of valid rows
  if (cb < rb || rb * kBlock >= nv) return;
  const int rows = min(nv - rb * kBlock, kBlock);
  const int cols = max(min(nv - cb * kBlock, kBlock), 0);
  __shared__ float4 cbox[kBlock];
  const int t = threadIdx.x;
  if (t < cols) cbox[t] = boxes[(long)b * N + cb * kBlock + t];
  __syncthreads();
  if (t >= rows) return;
  const int i = rb * kBlock + t;
  const float4 a = boxes[(long)b * N + i];
  const float area_a = (a.z - a.x) * (a.w - a.y);
  unsigned long long bits = 0ull;
  for (int k = (cb == rb) ? t + 1 : 0; k < cols; ++k)
    if (suppresses(a, area_a, cbox[k], thr)) bits |= 1ull << k;
  mask[((long)b * N + i) * nblk + cb] = bits;
}

__global__ void nms_sweep(const unsigned long long* __restrict__ mask,
                          const int* __restrict__ order, const int* __restrict__ n_valid,
                          int* __restrict__ keep_idx, int* __restrict__ keep_count, int N,
                          int nblk, int max_out) {
  extern __shared__ unsigned long long removed[];  // nblk words
  __shared__ unsigned long long diag[kBlock];
  __shared__ int kept_rows[kBlock];
  __shared__ int n_kept;
  __shared__ int total;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nv = n_valid[b];
  const unsigned long long* M = mask + (long)b * N * nblk;
  for (int k = tid; k < nblk; k += blockDim.x) removed[k] = 0ull;
  for (int k = tid; k < max_out; k += blockDim.x) keep_idx[(long)b * max_out + k] = 0;
  if (tid == 0) total = 0;
  __syncthreads();
  for (int rb = 0; rb < nblk; ++rb) {
    const int start = rb * kBlock;
    if (start >= nv) break;
    if (tid < kBlock) {
      const int i = start + tid;
      diag[tid] = i < nv ? M[(long)i * nblk + rb] : 0ull;
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long cur = removed[rb];
      int nk = 0, tot = total;
      for (int t = 0; t < kBlock; ++t) {
        const int i = start + t;
        if (i >= nv || tot >= max_out) break;
        if (!((cur >> t) & 1ull)) {
          kept_rows[nk++] = i;
          keep_idx[(long)b * max_out + tot] = order[(long)b * N + i];
          ++tot;
          cur |= diag[t];
        }
      }
      n_kept = nk;
      total = tot;
    }
    __syncthreads();
    for (int cb = rb + 1 + tid; cb < nblk; cb += blockDim.x) {
      unsigned long long acc = 0ull;
      for (int k = 0; k < n_kept; ++k) acc |= M[(long)kept_rows[k] * nblk + cb];
      removed[cb] |= acc;
    }
    __syncthreads();
    if (total >= max_out) break;
  }
  if (tid == 0) keep_count[b] = total;
}

}  // namespace

// boxes: (B, N, 4) f32, already class/level-offset and sorted by score
// (descending, stable); order: (B, N) int32 original index of each sorted
// box; n_valid: (B,) number of valid (leading) boxes; mask: scratch of
// B * N * ceil(N/64) words; keep_idx: (B, max_out) int32 original indices
// in pick order, 0 in unused slots; keep_count: (B,) number of keeps.
extern "C" int nsgp_nms(const void* boxes, const void* order, const void* n_valid,
                        void* mask, void* keep_idx, void* keep_count, int B, int N,
                        float thr, int max_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + kBlock - 1) / kBlock;
  dim3 grid(nblk, nblk, B);
  nms_mask<<<grid, kBlock, 0, s>>>((const float4*)boxes, (const int*)n_valid, thr,
                                  (unsigned long long*)mask, N, nblk);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  nms_sweep<<<B, 256, nblk * sizeof(unsigned long long), s>>>(
      (const unsigned long long*)mask, (const int*)order, (const int*)n_valid,
      (int*)keep_idx, (int*)keep_count, N, nblk, max_out);
  return (int)cudaGetLastError();
}
