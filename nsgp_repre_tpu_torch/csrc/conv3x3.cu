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
// matrix: each A-tile row is one pixel's C-slice of one tap, read from
// the NHWC map with the conv's zero padding applied at load time.
//   * bf16 (the predict path): tensor cores through nvcuda::wmma
//     (16x16x16 bf16 tiles, f32 accumulators). 128x128 (conv) or 64x256
//     (head) block tiles, 8 warps of 32x64, BK = 32 slices staged in shared
//     memory by cp.async, double-buffered so the next slice loads while
//     the current one multiplies. The head keeps its 64 x 256 hidden tile
//     in shared memory and runs the packed 1x1 as a second wmma product,
//     so the hidden map never reaches device memory.
//   * f32: the same GEMM on the CUDA cores (16-deep slices, 4x4 register
//     tiles per thread), exact f32 products with f32 sums.
// The TPU kernel pads its epilogue to 128 lanes; here it writes exactly
// P = 5A columns (the wmma product pads P to 16 inside shared memory).
//
// Rounding follows rpn_head_pallas.py:135 and :148-149: the conv sum is
// rounded to the map's dtype, the bias (rounded to that dtype) is added
// and the sum rounded again; the epilogue does the same with its f32
// matmul sum and its bias.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

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
// kept in shared memory and multiplied by the packed (BN, P) 1x1 weight;
// that requires BN == F (the whole hidden vector of a pixel in one block).
template <typename T, int BM, int BN, int TM, int TN, bool EPI>
__global__ void __launch_bounds__(kThreads)
conv3x3_simt(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, const T* __restrict__ wcr,
             const float* __restrict__ bcr, T* __restrict__ out,
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
        float h = rnd<T>(rnd<T>(acc[i][j]) + rnd<T>(bias[n]));
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
      for (int n = 0; n < BN; ++n) s += Hs[mi][n] * to_f(wcr[n * P + p]);
      out[m * P + p] = from_f<T>(rnd<T>(rnd<T>(s) + rnd<T>(bcr[p])));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores (wmma), cp.async double buffer
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int TC_BK = 32;      // K slice per stage (inside one tap: C % 32 == 0)
constexpr int TC_LDA = TC_BK + 8;  // padded shared-memory rows (bank spread)
constexpr int TC_P = 16;       // packed 1x1 columns, padded for wmma
constexpr int TC_LDW = TC_P + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN, bool EPI>
struct TcShape {
  static constexpr int WN = BN / 64;  // warps along N; each warp 32 x 64
  static constexpr int WM = BM / 32;
  static_assert(WM * WN == kThreads / 32, "8 warps of 32x64");
  static constexpr int LDB = BN + 8;
  static constexpr int A_STAGE = BM * TC_LDA;  // elements
  static constexpr int B_STAGE = TC_BK * LDB;
  static constexpr int PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
  static constexpr int LDH = BN + 8;                      // hidden tile (EPI)
  static constexpr int H_BYTES = EPI ? BM * LDH * 2 : 0;
  static constexpr int STAGE_BYTES = (kThreads / 32) * 256 * 4;  // a 16x16 f32 tile per warp
  static constexpr int W_BYTES = EPI ? BN * TC_LDW * 2 : 0;
  static constexpr int POST_BYTES =
      H_BYTES + (STAGE_BYTES > W_BYTES ? STAGE_BYTES : W_BYTES);
  static constexpr int SMEM = PIPE_BYTES > POST_BYTES ? PIPE_BYTES : POST_BYTES;
  static constexpr int A_CHUNKS = BM * (TC_BK / 8) / kThreads;  // 16-byte loads per thread
  static constexpr int B_CHUNKS = TC_BK * (BN / 8) / kThreads;
};

template <int BM, int BN, bool EPI>
__global__ void __launch_bounds__(kThreads)
conv3x3_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, const bf16* __restrict__ wcr,
             const float* __restrict__ bcr, bf16* __restrict__ out,
             int B, int H, int W, int C, int F, int P, int relu) {
  typedef TcShape<BM, BN, EPI> S;
  __shared__ __align__(128) unsigned char smem[S::SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * S::A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::WN, wn = warp % S::WN;
  const long M = (long)B * H * W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KT = 9 * C / TC_BK;

  // the pixels whose rows this thread loads (fixed across K)
  int a_row[S::A_CHUNKS], a_c8[S::A_CHUNKS], a_b[S::A_CHUNKS], a_y[S::A_CHUNKS],
      a_x[S::A_CHUNKS];
  bool a_in[S::A_CHUNKS];
#pragma unroll
  for (int s = 0; s < S::A_CHUNKS; ++s) {
    const int q = tid + s * kThreads;
    a_row[s] = q / (TC_BK / 8);
    a_c8[s] = q % (TC_BK / 8);
    const long pix = m0 + a_row[s];
    a_in[s] = pix < M;
    const long p = a_in[s] ? pix : 0;
    a_b[s] = (int)(p / ((long)H * W));
    const int rem = (int)(p - (long)a_b[s] * H * W);
    a_y[s] = rem / W;
    a_x[s] = rem - a_y[s] * W;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
    const int tap = k0 / C, c0 = k0 - tap * C;
    const int ky = tap / 3 - 1, kx = tap % 3 - 1;
    bf16* as = As + stage * S::A_STAGE;
    bf16* bs = Bs + stage * S::B_STAGE;
#pragma unroll
    for (int s = 0; s < S::A_CHUNKS; ++s) {
      const int yy = a_y[s] + ky, xx = a_x[s] + kx;
      const bool ok = a_in[s] && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const bf16* src = ok ? x + (((long)a_b[s] * H + yy) * W + xx) * C + c0 + a_c8[s] * 8 : x;
      cp_async16(as + a_row[s] * TC_LDA + a_c8[s] * 8, src, ok);
    }
#pragma unroll
    for (int s = 0; s < S::B_CHUNKS; ++s) {
      const int q = tid + s * kThreads;
      const int r = q / (BN / 8), c8 = q % (BN / 8);
      cp_async16(bs + r * S::LDB + c8 * 8, w + (long)(k0 + r) * F + n0 + c8 * 8, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As + (kt & 1) * S::A_STAGE;
    const bf16* bs = Bs + (kt & 1) * S::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * TC_LDA + kk, TC_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * S::LDB + wn * 64 + j * 16, S::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is overwritten by the next prefetch
  }

  // epilogue: each accumulator tile goes through a per-warp 16x16 f32
  // staging tile; each lane rounds, biases and stores 8 consecutive channels
  bf16* Hs = reinterpret_cast<bf16*>(smem);  // EPI: hidden tile (BM x LDH)
  float* stage = reinterpret_cast<float*>(smem + S::H_BYTES) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int ml = wm * 32 + i * 16 + r;
      const int nl = wn * 64 + j * 16 + c8;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float h = rnd<bf16>(rnd<bf16>(stage[r * 16 + c8 + e]) + rnd<bf16>(bias[n0 + nl + e]));
        if (relu) h = fmaxf(h, 0.f);
        v[e] = __float2bfloat16_rn(h);
      }
      if constexpr (EPI) {
        *reinterpret_cast<uint4*>(Hs + ml * S::LDH + nl) = *reinterpret_cast<uint4*>(v);
      } else {
        const long m = m0 + ml;
        if (m < M)
          *reinterpret_cast<uint4*>(out + m * F + n0 + nl) = *reinterpret_cast<uint4*>(v);
      }
      __syncwarp();
    }
  }

  if constexpr (EPI) {
    // packed 1x1: (BM x F) hidden tile @ (F x 16) weight, on the tensor cores
    __syncthreads();
    bf16* Ws = reinterpret_cast<bf16*>(smem + S::H_BYTES);  // reuses the staging area
    for (int e = tid; e < BN * TC_P; e += kThreads) {
      const int k = e / TC_P, p = e % TC_P;
      Ws[k * TC_LDW + p] = p < P ? wcr[k * P + p] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    if (warp < BM / 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
      for (int k = 0; k < BN; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Hs + warp * 16 * S::LDH + k, S::LDH);
        wmma::load_matrix_sync(fb, Ws + k * TC_LDW, TC_LDW);
        wmma::mma_sync(o, fa, fb, o);
      }
      __syncwarp();
      // this warp's 16 hidden rows are read by no other warp: stage there
      float* st = reinterpret_cast<float*>(Hs + warp * 16 * S::LDH);
      wmma::store_matrix_sync(st, o, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * TC_P; e += 32) {
        const int rr = e / TC_P, p = e % TC_P;
        const long m = m0 + warp * 16 + rr;
        if (p < P && m < M)
          out[m * P + p] = __float2bfloat16_rn(rnd<bf16>(rnd<bf16>(st[e]) + rnd<bf16>(bcr[p])));
      }
    }
  }
}

template <typename T>
int launch_simt(const void* x, const void* w, const void* b, const void* wcr, const void* bcr,
                void* out, int B, int H, int W, int C, int F, int P, int relu,
                cudaStream_t stream) {
  const long M = (long)B * H * W;
  if (wcr) {
    constexpr int BM = 16, BN = 256;
    dim3 grid((unsigned)((M + BM - 1) / BM), 1);
    conv3x3_simt<T, BM, BN, 4, 4, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)b, (const T*)wcr, (const float*)bcr,
        (T*)out, B, H, W, C, F, P, relu);
  } else {
    constexpr int BM = 64, BN = 64;
    dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + BN - 1) / BN));
    conv3x3_simt<T, BM, BN, 4, 4, false><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)b, nullptr, nullptr, (T*)out,
        B, H, W, C, F, 0, relu);
  }
  return (int)cudaGetLastError();
}

int launch_wmma(const void* x, const void* w, const void* b, const void* wcr, const void* bcr,
                void* out, int B, int H, int W, int C, int F, int P, int relu,
                cudaStream_t stream) {
  const long M = (long)B * H * W;
  if (wcr) {
    constexpr int BM = 64, BN = 256;
    dim3 grid((unsigned)((M + BM - 1) / BM), 1);
    conv3x3_wmma<BM, BN, true><<<grid, kThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)w, (const float*)b, (const bf16*)wcr, (const float*)bcr,
        (bf16*)out, B, H, W, C, F, P, relu);
  } else {
    constexpr int BM = 128, BN = 128;
    dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / BN));
    conv3x3_wmma<BM, BN, false><<<grid, kThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)w, (const float*)b, nullptr, nullptr, (bf16*)out,
        B, H, W, C, F, 0, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wcr/bcr null: plain conv (out has F
// channels); otherwise the packed epilogue (F must be 256; out has P
// channels). Needs C % 16 == 0 (f32) or C % 32 == 0 (bf16); bf16 also
// needs F % 128 == 0 without the epilogue and P <= 16 with it. Shapes are
// checked by the Python wrapper; returns the cudaGetLastError() code of
// the launch.
extern "C" int nsgp_conv3x3(const void* x, const void* w, const void* b, const void* wcr,
                            const void* bcr, void* out, int B, int H, int W, int C, int F,
                            int P, int relu, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_wmma(x, w, b, wcr, bcr, out, B, H, W, C, F, P, relu, s);
  return launch_simt<float>(x, w, b, wcr, bcr, out, B, H, W, C, F, P, relu, s);
}
