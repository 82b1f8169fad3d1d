// Forward 3x3 / stride 1 / pad 1 convolution on NHWC maps, with bias,
// optional ReLU and an optional packed 1x1 epilogue.
//
// Replaces two Pallas TPU kernels of nsgp_repre_tpu/ops/rpn_head_pallas.py:
//   _conv3x3_kernel  (conv3x3_fused): the FPN output convs at batch 1;
//   _rpn_head_kernel (rpn_head_fused): the dense RPN head, i.e. the shared
//     3x3 conv + ReLU followed by ONE packed 1x1 matmul whose first A
//     columns are the objectness logits and the next 4A the box deltas.
//
// What bounds it on the H100: arithmetic. The P2 level at the 608x1024
// canvas is 38,912 pixels x 2,304 (= 9*256) x 256 multiply-adds, ~46 GFLOP
// for one conv, against ~40 MB of input/output bytes, far above the card's
// ~295 FLOP/byte ridge. Both kernels are implicit GEMMs (M = pixels,
// N = output channels, K = 9 taps x C) that never materialise the im2col
// matrix.
//   * bf16 (the main path): one warp-specialised kernel on Hopper's
//     tensor cores. A block owns a patch of 16 columns x 8 rows = 128
//     pixels of one image and BN = 256 output channels (128 for a plain
//     conv whose grid is too small to fill the card). The K loop walks
//     the 9 taps and, inside each, the channels in 64-wide chunks (36
//     steps at C = 256; C is zero-padded to Cp, a multiple of 64, in the
//     weight, and the map's channels past C load as zeros). One producer
//     thread issues the TMA loads of each step into a ring of
//     shared-memory stages guarded by mbarriers: the A tile is the same
//     4-D box of the NHWC map (64 channels x 16 x 8 pixels) shifted by the
//     tap, so the tensor map's zero fill outside the map IS the conv's
//     zero padding (no predicates, no per-thread addresses), and the B
//     tile is a 64 x BN box of the K-major weight (F, 9*Cp). Two consumer
//     warpgroups each run wgmma.mma_async m64nBNk16 on 64 of the 128
//     pixels, f32 sums in registers (setmaxnreg moves registers from the
//     producer to them), and release a stage once the product that read
//     it has retired. The head writes its 128 x 256 hidden tile (bf16) to
//     shared memory in the swizzled layout a wgmma A operand needs and
//     runs the packed 1x1 as a second wgmma (m64nPNk16 over K = 256, PN =
//     16 for P <= 16, else 128), so the hidden map never reaches device
//     memory.
//   * f32: the same GEMM on the CUDA cores (16-deep slices, 4x4 register
//     tiles per thread), exact f32 products with f32 sums.
// Hidden widths F > 256 (the C4 and DC5 heads: 1024 and 2048): the packed
// 1x1 is linear over F, so blockIdx.y takes one 256-wide chunk of the
// hidden vector, runs the conv and the 1x1 on that chunk alone and writes
// its f32 partial 1x1 sums (F/256, pixels, P); a second launch adds the
// partials in chunk order, then the bias, and rounds. F / 256 times as
// many blocks fill the card where one block per pixel patch would leave a
// third of it idle (C4 at batch 2: 84 patches for 132 SMs). No split-K of
// the conv, no atomics: a call gives the same bits every time. At F = 256
// there is one chunk and the block writes the output itself.
// The TPU kernel pads its epilogue to 128 lanes; here it writes exactly
// P = 5A columns (the wgmma product pads P to PN inside shared memory).
//
// Rounding follows rpn_head_pallas.py:135 and :148-149: the conv sum is
// rounded to the map's dtype, the bias (rounded to that dtype) is added
// and the sum rounded again; the epilogue does the same with its f32
// matmul sum and its bias.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float to T and back: the dtype's rounding point
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// ---------------------------------------------------------------------------
// f32: implicit GEMM on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int SIMT_BK = 16;

// BM pixels x BN output channels per block; each thread a TM x TN tile.
// EPI: after the conv (+bias, ReLU) the BM x BN tile of hidden values is
// kept in shared memory and multiplied by rows n0..n0+BN of the packed
// (F, P) 1x1 weight; with one chunk (BN == F) the block writes the output,
// else its f32 partial sums go to part (F/BN, M, P) for rpn_head_reduce.
template <typename T, int BM, int BN, int TM, int TN, bool EPI>
__global__ void __launch_bounds__(kThreads)
conv3x3_simt(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, const T* __restrict__ wcr,
             const float* __restrict__ bcr, float* __restrict__ part, T* __restrict__ out,
             int B, int H, int W, int C, int F, int P, int relu) {
  constexpr int BK = SIMT_BK;
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread tiling");
  constexpr int EA = BM * BK / kThreads;  // A elements loaded per thread
  constexpr int EB = BK * BN / kThreads;  // B elements loaded per thread
  static_assert(EA >= 1 && EB >= 1, "tile too small");

  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long M = (long)B * H * W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;

  // this thread's A-load row (one pixel) and k offset inside the slice
  const int a_m = tid / (BK / EA);
  const int a_k = (tid % (BK / EA)) * EA;
  const long a_pix = m0 + a_m;
  int a_b = 0, a_y = 0, a_x = 0;
  if (a_pix < M) {
    a_b = (int)(a_pix / ((long)H * W));
    int rem = (int)(a_pix - (long)a_b * H * W);
    a_y = rem / W;
    a_x = rem - a_y * W;
  }
  // this thread's B-load row (k) and column offset
  const int b_k = tid / (BN / EB);
  const int b_n = (tid % (BN / EB)) * EB;

  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // the slice lies inside one tap because C % BK == 0
    const int tap = k0 / C;
    const int c0 = k0 - tap * C;
    const int ky = tap / 3, kx = tap - (tap / 3) * 3;
    {
      const int yy = a_y + ky - 1, xx = a_x + kx - 1;
      const bool ok = a_pix < M && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src = x + (((long)a_b * H + yy) * W + xx) * C + c0 + a_k;
#pragma unroll
      for (int e = 0; e < EA; ++e) As[a_k + e][a_m] = ok ? to_f(src[e]) : 0.f;
    }
    {
      const T* src = w + (long)(k0 + b_k) * F + n0 + b_n;
#pragma unroll
      for (int e = 0; e < EB; ++e) Bs[b_k][b_n + e] = (n0 + b_n + e < F) ? to_f(src[e]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][tm + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tn + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

  if constexpr (!EPI) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long m = m0 + tm + i * (BM / TM);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tn + j * (BN / TN);
        if (n >= F) continue;
        float h = rnd<T>(rnd<T>(acc[i][j]) + rnd<T>(bias[n]));
        if (relu) h = fmaxf(h, 0.f);
        out[m * F + n] = from_f<T>(h);
      }
    }
  } else {
    // hidden tile -> shared memory, then the packed 1x1 epilogue
    __shared__ float Hs[BM][BN + 1];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tn + j * (BN / TN);
        float h = rnd<T>(rnd<T>(acc[i][j]) + rnd<T>(bias[n0 + n]));
        if (relu) h = fmaxf(h, 0.f);
        Hs[tm + i * (BM / TM)][n] = h;
      }
    }
    __syncthreads();
    for (int o = tid; o < BM * P; o += kThreads) {
      const int mi = o / P, p = o - (o / P) * P;
      const long m = m0 + mi;
      if (m >= M) continue;
      float s = 0.f;
      for (int n = 0; n < BN; ++n) s += Hs[mi][n] * to_f(wcr[(long)(n0 + n) * P + p]);
      if (part)
        part[((long)blockIdx.y * M + m) * P + p] = s;
      else
        out[m * P + p] = from_f<T>(rnd<T>(rnd<T>(s) + rnd<T>(bcr[p])));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised implicit GEMM (TMA loads, wgmma, mbarrier ring)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int PATCH_X = 16, PATCH_Y = 8;  // pixel patch of one block
constexpr int BM = PATCH_X * PATCH_Y;     // 128 pixels: 64 per consumer warpgroup
constexpr int BK = 64;                    // channels per K step: one 128-byte swizzle row
constexpr int WG = 128;                   // threads of a warpgroup
constexpr int TC_THREADS = 3 * WG;        // producer warpgroup + two consumer warpgroups
constexpr int ROW_BYTES = BK * 2;         // one K-major row of a tile in shared memory
constexpr int SW_ATOM = 8 * ROW_BYTES;    // 8 rows: the 128B swizzle's repeat (and wgmma's SBO)

// Shared memory of one block, every buffer 1024-byte aligned (the 128B
// swizzle pattern is a function of the address bits). PN: the packed 1x1
// columns padded for wgmma (16 or 128).
template <int BN, bool EPI, int PN>
struct TcCfg {
  static constexpr int STAGES = EPI ? 3 : 4;
  static constexpr int A_BYTES = BM * ROW_BYTES;                // 16 KB
  static constexpr int B_BYTES = BN * ROW_BYTES;                // 16 or 32 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the head's hidden tile (128 x 256 bf16, 64 KB) reuses the ring once
  // the last product has read it
  static constexpr int H_BYTES = EPI ? BM * BN * 2 : 0;
  static constexpr int W_OFF = STAGES * STAGE_BYTES > H_BYTES ? STAGES * STAGE_BYTES : H_BYTES;
  static constexpr int W_BYTES = EPI ? PN * BN * 2 : 0;         // packed 1x1 weight, 8 or 64 KB
  static constexpr int BAR_OFF = W_OFF + W_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + slack to align the base
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128B swizzle: rows of 128
// bytes, 8-row groups SW_ATOM apart (LBO is unused for this layout).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(SW_ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin the accumulators at this point of the program: no read or write of
// them moves across an issue, commit or wait of the asynchronous products
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256, f32, registers) += A (64 x 16) * B (16 x 256), both bf16 in shared memory
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, f32, registers) += A (64 x 16) * B (16 x 128), both bf16 in shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x PN, f32, registers) += A (64 x 16) * B (16 x PN), PN = 16 or 128
template <int PN>
__device__ __forceinline__ void wgmma_epi(float (&d)[PN / 2], uint64_t da, uint64_t db);

// D (64 x 16, f32, registers) += A (64 x 16) * B (16 x 16), both bf16 in shared memory
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_epi<16>(float (&d)[8], uint64_t da, uint64_t db) {
  wgmma_n16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_epi<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_n128(d, da, db);
}

// byte offset of element (row, k), k < 64, of a K-major tile in the 128B
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ uint32_t sw128_off(int row, int k) {
  return row * ROW_BYTES + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ float epi(float acc, float bias, int relu) {
  float h = rnd<bf16>(rnd<bf16>(acc) + rnd<bf16>(bias));
  return relu ? fmaxf(h, 0.f) : h;
}

// tm_x: the NHWC map as a 4-D tensor (C, W, H, B), box (64, 16, 8, 1);
// tm_w: the K-major weight (F, 9*Cp), box (64, BN); both 128B-swizzled.
// Block (blockIdx.x, blockIdx.y) = (pixel patch, BN output channels).
// EPI: BN == 256 hidden channels n0..n0+255 and the packed 1x1 on them,
// P <= PN columns: out (P channels) when F == 256, else the f32 partial
// sums part (F/256, B*H*W, P). Without EPI, out has F channels.
template <int BN, bool EPI, int PN>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
              const float* __restrict__ bias, const bf16* __restrict__ wcr,
              const float* __restrict__ bcr, float* __restrict__ part, bf16* __restrict__ out,
              int H, int W, int Cp, int F, int P, int relu, int tiles_x, int tiles_y) {
  typedef TcCfg<BN, EPI, PN> S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + S::BAR_OFF, empty = full + S::STAGES * 8;

  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * PATCH_X;
  const int y0 = ((tile / tiles_x) % tiles_y) * PATCH_Y;
  const int b = tile / (tiles_x * tiles_y);
  const int n0 = blockIdx.y * BN;
  const int csteps = Cp / BK;
  const int ksteps = 9 * csteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx; TMA adds the bytes
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (EPI) {
    // rows n0..n0+255 of the packed 1x1 weight (F x P) as a K-major
    // (PN x 256) wgmma B operand: 4 chunks of PN rows x 64, zero columns
    // beyond P; consecutive threads read consecutive columns of a row
    for (int e = threadIdx.x; e < PN * BN; e += TC_THREADS) {
      const int k = e / PN, p = e % PN;
      const bf16 v = p < P ? wcr[(long)(n0 + k) * P + p] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<bf16*>(smem + S::W_OFF + (k / BK) * (PN * ROW_BYTES) +
                               sw128_off(p, k % BK)) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    // registers per thread: 128 x 40 + 256 x 232 fit the SM's 64K
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % S::STAGES;
        mbar_wait(empty + 8 * s, ((ks / S::STAGES) & 1) ^ 1);  // the first round passes
        const int tap = ks / csteps, c0 = (ks - tap * csteps) * BK;
        const int ky = tap / 3, kx = tap - ky * 3;
        const uint32_t a = sbase + s * S::STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, S::STAGE_BYTES);
        // the tap's shifted patch; rows and columns outside the map arrive as zeros
        tma_load_4d(a, &tm_x, full + 8 * s, c0, x0 + kx - 1, y0 + ky - 1, b);
        tma_load_2d(a + S::A_BYTES, &tm_w, full + 8 * s, tap * Cp + c0, n0);
      }
    }
  } else {
    // ---- two consumer warpgroups: 64 pixels x BN channels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");  // BN/2 f32 sums each
    const int cw = threadIdx.x / WG - 1;
    const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = ks % S::STAGES;
      mbar_wait(full + 8 * s, (ks / S::STAGES) & 1);
      const uint32_t a = sbase + s * S::STAGE_BYTES + cw * (BM / 2) * ROW_BYTES;
      const uint32_t bb = sbase + s * S::STAGE_BYTES + S::A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 channels = 32 bytes per product
        if constexpr (BN == 256)
          wgmma_n256(acc, sw128_desc(a + kk * 32), sw128_desc(bb + kk * 32));
        else
          wgmma_n128(acc, sw128_desc(a + kk * 32), sw128_desc(bb + kk * 32));
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the previous step's products have retired: free its stage
      fence_regs(acc);
      if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * ((ks - 1) % S::STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator fragment of m64nNk16: acc[4j + 2h + c] is row
    // 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + c of the 64 x BN tile
    if constexpr (!EPI) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * (BM / 2) + warp * 16 + lane / 4 + 8 * h;  // pixel of the patch
        const int y = y0 + r / PATCH_X, x = x0 + r % PATCH_X;
        if (y < H && x < W) {
          bf16* o = out + (((long)b * H + y) * W + x) * F + n0;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = 8 * j + 2 * (lane % 4);
            *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(
                epi(acc[4 * j + 2 * h], bias[n0 + n], relu),
                epi(acc[4 * j + 2 * h + 1], bias[n0 + n + 1], relu));
          }
        }
      }
    } else {
      // hidden tile (this warpgroup's 64 rows x 256, bf16) -> shared memory
      // as a K-major wgmma A operand: 4 chunks of 64 rows x 64 channels
      asm volatile("bar.sync 3, %0;\n" ::"n"(2 * WG) : "memory");  // both are done with the ring
      uint8_t* hid = smem + cw * (BM / 2) * BN * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = 8 * j + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(hid + (n / BK) * (BM / 2) * ROW_BYTES +
                                             sw128_off(r, n % BK)) =
              __floats2bfloat162_rn(epi(acc[4 * j + 2 * h], bias[n0 + n], relu),
                                    epi(acc[4 * j + 2 * h + 1], bias[n0 + n + 1], relu));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(WG) : "memory");  // this warpgroup

      // packed 1x1: (64 x 256 hidden) @ (256 x PN weight), K = 256 in 16 steps
      float o[PN / 2];
#pragma unroll
      for (int i = 0; i < PN / 2; ++i) o[i] = 0.f;
      const uint32_t ha = smem_u32(hid), wa = sbase + S::W_OFF;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
        const int chunk = k / (BK / 16), kk = k % (BK / 16);
        wgmma_epi<PN>(o, sw128_desc(ha + chunk * (BM / 2) * ROW_BYTES + kk * 32),
                      sw128_desc(wa + chunk * PN * ROW_BYTES + kk * 32));
      }
      wgmma_commit();
      fence_regs(o);
      wgmma_wait<0>();
      fence_regs(o);
      const long M = (long)(gridDim.x / (tiles_x * tiles_y)) * H * W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * (BM / 2) + warp * 16 + lane / 4 + 8 * h;
        const int y = y0 + r / PATCH_X, x = x0 + r % PATCH_X;
        if (y < H && x < W) {
          const long pix = ((long)b * H + y) * W + x;
#pragma unroll
          for (int j = 0; j < PN / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int p = 8 * j + 2 * (lane % 4) + c;
              if (p < P) {
                if (part)
                  part[((long)blockIdx.y * M + pix) * P + p] = o[4 * j + 2 * h + c];
                else
                  out[pix * P + p] = __float2bfloat16_rn(epi(o[4 * j + 2 * h + c], bcr[p], 0));
              }
            }
          }
        }
      }
    }
  }
}

// the epilogue of F > 256: the chunks' f32 partial 1x1 sums part (chunks,
// M, P) added in chunk order, then the bias, rounded where the one-chunk
// epilogue rounds
template <typename T>
__global__ void rpn_head_reduce(const float* __restrict__ part, const float* __restrict__ bcr,
                                T* __restrict__ out, long MP, int P, int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MP) return;
  float s = part[i];
  for (int c = 1; c < chunks; ++c) s += part[c * MP + i];
  out[i] = from_f<T>(rnd<T>(rnd<T>(s) + rnd<T>(bcr[i % P])));
}

template <typename T>
int launch_reduce(const float* part, const void* bcr, void* out, long M, int P, int chunks,
                  cudaStream_t stream) {
  const long MP = M * P;
  rpn_head_reduce<T><<<(unsigned)((MP + 255) / 256), 256, 0, stream>>>(
      part, (const float*)bcr, (T*)out, MP, P, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const void* x, const void* w, const void* b, const void* wcr, const void* bcr,
                float* part, void* out, int B, int H, int W, int C, int F, int P, int relu,
                cudaStream_t stream) {
  const long M = (long)B * H * W;
  if (wcr) {
    constexpr int BM = 16, BN = 256;
    const int chunks = F / BN;
    dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)chunks);
    conv3x3_simt<T, BM, BN, 4, 4, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)b, (const T*)wcr, (const float*)bcr,
        chunks > 1 ? part : nullptr, (T*)out, B, H, W, C, F, P, relu);
    const int rc = (int)cudaGetLastError();
    if (rc || chunks == 1) return rc;
    return launch_reduce<T>(part, bcr, out, M, P, chunks, stream);
  }
  constexpr int BM = 64, BN = 64;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + BN - 1) / BN));
  conv3x3_simt<T, BM, BN, 4, 4, false><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (const float*)b, nullptr, nullptr, nullptr, (T*)out,
      B, H, W, C, F, 0, relu);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is fetched once through the runtime's entry-point query
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 tensor map with the 128B swizzle; zero fill outside the tensor
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool EPI, int PN>
int launch_wgmma(const void* x, const void* wk, const void* b, const void* wcr, const void* bcr,
                 float* part, void* out, int B, int H, int W, int C, int F, int P, int relu,
                 cudaStream_t stream) {
  typedef TcCfg<BN, EPI, PN> S;
  const int Cp = (C + BK - 1) / BK * BK;
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {BK, PATCH_X, PATCH_Y, 1};
  const cuuint64_t wd[2] = {(cuuint64_t)9 * Cp, (cuuint64_t)F};
  const cuuint64_t ws[1] = {(cuuint64_t)9 * Cp * 2};
  const cuuint32_t wb[2] = {BK, BN};
  if (!encode(&tm_x, x, 4, xd, xs, xb) || !encode(&tm_w, wk, 2, wd, ws, wb))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_wgmma<BN, EPI, PN>;
  static bool opted_in = false;  // above 48 KB of shared memory only on request
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int tiles_x = (W + PATCH_X - 1) / PATCH_X, tiles_y = (H + PATCH_Y - 1) / PATCH_Y;
  const int chunks = F / BN;
  dim3 grid((unsigned)((long)B * tiles_x * tiles_y), (unsigned)chunks);
  kernel<<<grid, TC_THREADS, S::SMEM, stream>>>(
      tm_x, tm_w, (const float*)b, (const bf16*)wcr, (const float*)bcr,
      EPI && chunks > 1 ? part : nullptr, (bf16*)out, H, W, Cp, F, P, relu, tiles_x, tiles_y);
  const int rc = (int)cudaGetLastError();
  if (rc || !EPI || chunks == 1) return rc;
  return launch_reduce<bf16>(part, bcr, out, (long)B * H * W, P, chunks, stream);
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wcr/bcr null: plain conv (out has F
// channels); otherwise the packed epilogue (F % 256 == 0, P <= 128; out
// has P channels; F > 256 needs part, f32 scratch of (F/256) * B*H*W * P).
// f32: w is HWIO (3, 3, C, F), C % 16 == 0. bf16: w is the K-major
// (F, 9*Cp) weight with k = (ky*3 + kx)*Cp + c, Cp = C rounded up to 64
// and zeros for c >= C (rpn_head_cuda.py::conv_weight_kmajor); C % 8 == 0,
// 16-byte aligned x and w, F % 128 == 0 without the epilogue. Shapes are
// checked by the Python wrapper; returns the cudaGetLastError() code of the
// launches (cudaErrorInvalidValue if a tensor map cannot be encoded).
extern "C" int nsgp_conv3x3(const void* x, const void* w, const void* b, const void* wcr,
                            const void* bcr, void* part, void* out, int B, int H, int W, int C,
                            int F, int P, int relu, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* pt = (float*)part;
  if (dtype == 1) {
    if (wcr && P <= 16)
      return launch_wgmma<256, true, 16>(x, w, b, wcr, bcr, pt, out, B, H, W, C, F, P, relu, s);
    if (wcr)
      return launch_wgmma<256, true, 128>(x, w, b, wcr, bcr, pt, out, B, H, W, C, F, P, relu, s);
    // 256 channels per block read each A tile once for all of them; blocks
    // of 128 pay off where twice as many still fit in one wave (the small
    // levels at batch 1), since a tile's time, not the card, bounds those
    const long tiles = (long)B * ((W + PATCH_X - 1) / PATCH_X) * ((H + PATCH_Y - 1) / PATCH_Y);
    if (F % 256 == 0 && 2 * tiles > sm_count())
      return launch_wgmma<256, false, 16>(x, w, b, nullptr, nullptr, nullptr, out, B, H, W, C, F,
                                          0, relu, s);
    return launch_wgmma<128, false, 16>(x, w, b, nullptr, nullptr, nullptr, out, B, H, W, C, F,
                                        0, relu, s);
  }
  return launch_simt<float>(x, w, b, wcr, bcr, pt, out, B, H, W, C, F, P, relu, s);
}
