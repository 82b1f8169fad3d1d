// Row gather: out[i] = table[clamp(idx[i], 0, N-1)] for an (N, row_bytes)
// table and M int32 indices.
//
// Replaces the Pallas TPU kernel nsgp_repre_tpu/ops/gather_pallas.py::_gather_kernel
// (gather_rows), which issues one DMA per row from a 16-deep window of
// DMA semaphores and needs C % 1024 == 0 (the (8, 128) f32 tiling of HBM).
//
// What bounds it on the H100: bytes. It reads M rows and writes M rows and
// does no arithmetic, so the least time is 2 * M * row_bytes / 3.35 TB/s.
// The TPU's DMA window does not carry over: here one warp copies one row
// with 16-byte vector loads and stores, neighbouring lanes on neighbouring
// addresses, four vectors in flight per lane, and many warps per SM keep
// enough bytes in flight to cover the latency of device memory. Each block
// loads (and clamps) its own rows' indices into shared memory once. Any
// row whose byte size is a multiple of 16 works; the dtype does not matter
// to a copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block, one warp each
constexpr int kUnroll = 4;  // 16-byte vectors in flight per lane

__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, long long M, int N, int vecs) {
  __shared__ int rows[kWarps];
  const long long r0 = (long long)blockIdx.x * kWarps;
  if (threadIdx.x < kWarps && r0 + threadIdx.x < M) {
    const int i = idx[r0 + threadIdx.x];
    rows[threadIdx.x] = i < 0 ? 0 : (i >= N ? N - 1 : i);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = r0 + warp;
  if (r >= M) return;
  const uint4* src = table + (long long)rows[warp] * vecs;
  uint4* dst = out + r * vecs;
  int v = lane;
  for (; v + 32 * (kUnroll - 1) < vecs; v += 32 * kUnroll) {
    uint4 t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) t[u] = __ldg(src + v + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[v + 32 * u] = t[u];
  }
  for (; v < vecs; v += 32) dst[v] = __ldg(src + v);
}

}  // namespace

// table: (N, row_bytes) with row_bytes % 16 == 0 and both pointers 16-byte
// aligned (checked by the Python wrapper); idx: (M,) int32. Returns the
// cudaGetLastError() code of the launch.
extern "C" int nsgp_gather(const void* table, const void* idx, void* out, long long M, int N,
                           int row_bytes, void* stream) {
  const long long blocks = (M + kWarps - 1) / kWarps;
  gather_rows_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, M, N, row_bytes / 16);
  return (int)cudaGetLastError();
}
