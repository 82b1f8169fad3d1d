// Batched greedy NMS over score-sorted boxes: one fused walk per image.
//
// Replaces the Pallas TPU kernel nsgp_repre_tpu/ops/nms_pallas.py::_nms_kernel
// (nms_pallas / batched_nms_pallas). Same contract: a box is kept when its
// IoU with every box kept before it is <= thr; equal scores go to the
// lowest index (the caller sorts with a stable descending sort, so the
// sorted order IS the greedy pick order).
//
// What bounds it on the H100: neither bytes nor FLOPs, but the sequential
// dependence of greedy NMS. The TPU design (every box in fast memory, one
// argmax and one IoU row per pick, max_out picks) does not carry over, and
// neither does a full pairwise bitmask: at the train step's call (16 x
// 8,304 candidates, 1,000 kept) the upper triangle is ~552 M IoUs, while
// the greedy walk, which stops at its 1,000th keep, needs ~8.4 M.
//
// So each image is walked by a cluster of up to 8 blocks of 32 warps (as
// many as let every image's cluster run at once: 4 at the train step's 16
// images), 64 sorted candidates at a time (a row block), testing only
// what the walk needs:
//   1. each candidate of the row block against the boxes kept so far. The
//      kept set is dealt round-robin over the cluster's blocks (keep q to
//      block q % cs), each holding its share in shared memory (24 B a
//      keep); a half-warp tests one candidate against the block's share
//      and stops at the first suppressor. Each block ORs its verdicts into
//      one 64-bit word, and after one cluster barrier every block ORs the
//      cluster's words through distributed shared memory;
//   2. at the same time, the row block's own pairs: for each candidate
//      that step 1 left alive, one warp builds its row of 64 bits as two
//      ballots (the later candidates it suppresses, the earlier ones that
//      suppress it), each pair tested with the earlier box first;
//   3. one warp resolves the row block on register bit masks, in rounds:
//      a live candidate that no live earlier candidate suppresses is kept
//      whatever happens to the others, and the candidates it suppresses
//      are dead. Each lane holds, for two candidates, the bits of the
//      earlier ones that suppress them; a round keeps all sure candidates
//      at once (a ballot) and kills every candidate one of them suppresses
//      (a second ballot). The lowest live candidate is always sure, so
//      the rounds end, usually after one to three. Keeps past max_out
//      are dropped from the top. Every block of the cluster builds the
//      same rows (step 2), resolves them to the same keeps and stores
//      its share of them.
// The next row block's boxes are loaded into registers while the current
// one is tested. The walk stops at max_out keeps or at the image's valid
// count; keep_idx is written once, at the end. So the IoUs evaluated are
// at most, summed over the row blocks up to the stop, rows x (keeps before
// the row block) plus, in each of the cluster's blocks, each live row
// against the block's 63 others. The counting instantiation (kCount)
// measures it: on chip_smoke.py's seeded train call (16 x 8,304, 1,000
// kept, clusters of 4) the walk evaluated 13,011,016 IoUs on the H100,
// against the 8,417,180 pairs greedy NMS needs there and the 551,584,896
// of the upper triangle that a full pairwise bitmask evaluates.
// The kept set bounds max_out (kMaxKeep in one block); the number of
// candidates is not bounded.
//
// The decision rule is the plain version's, bit for bit (ops/nms.py):
// suppress when fl(inter / uni) > thr, uni = max(area_a + area_b - inter,
// 1e-6) in that order, area_a the earlier box's; the file is compiled
// with -fmad=false. The IEEE division runs only where a cheaper test
// cannot decide:
//   - inter == 0: the quotient is exactly zero, so the decision is 0 > thr;
//   - p = fl(thr * uni), normal: inter > fl(p * (1 + 2^-20)) implies
//     inter / uni > thr * (1 + 2^-20) * (1 - 2^-24)^2 > thr * (1 + 2^-23)
//     >= the next float above thr, so the rounded quotient is above thr
//     (rounding is monotone); inter < fl(p * (1 - 2^-20)) implies
//     inter / uni < thr * (1 - 2^-20) * (1 + 2^-24)^2 < thr, so the rounded
//     quotient is at most thr. Either way the division would decide the
//     same. Inside that band of ~8 ulps, or when p is not a normal
//     number, the exact division decides.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kRow = 64;  // candidates per row block
constexpr int kWarps = kRow / 2;  // two candidates (and two in-block rows) per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxKeep = 8192;  // kept boxes in one block's shared memory: 24 B each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kHi = 1.f + 0x1p-20f;
constexpr float kLo = 1.f - 0x1p-20f;

// does the earlier box a (area_a) suppress box b (area_b)?
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thr) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  const float inter = iw * ih;
  if (inter == 0.f) return 0.f > thr;
  const float uni = fmaxf(area_a + area_b - inter, 1e-6f);
  const float p = thr * uni;
  if (p >= 0x1p-100f && p <= 0x1p100f) {
    if (inter > p * kHi) return true;
    if (inter < p * kLo) return false;
  }
  return inter / uni > thr;
}

__device__ __forceinline__ float area(float4 b) { return (b.z - b.x) * (b.w - b.y); }

// dynamic shared memory of one block: its share of the kept set, 24 B a keep
constexpr size_t kept_smem(int max_out, int cs) {
  return (size_t)((max_out + cs - 1) / cs) * (sizeof(float4) + sizeof(float) + sizeof(int));
}

// one cluster of cs blocks per image (grid B * cs); per_block = ceil(max_out / cs).
// kCount: also add the number of IoUs evaluated to *ious (a measuring build
// of the same walk; the main path runs kCount = false)
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
nms_walk(const float4* __restrict__ boxes, const int* __restrict__ order,
         const int* __restrict__ n_valid, float thr, int* __restrict__ keep_idx,
         int* __restrict__ keep_count, int N, int max_out, int per_block,
         unsigned long long* __restrict__ ious) {
  extern __shared__ float4 kept_box[];  // this block's share: boxes, then areas and indices
  float* kept_area = reinterpret_cast<float*>(kept_box + per_block);
  int* kept_idx = reinterpret_cast<int*>(kept_area + per_block);
  __shared__ float4 cbox[kRow];
  __shared__ float carea[kRow];
  __shared__ int corder[kRow];
  __shared__ unsigned long long prow[kRow];  // live candidate t: bit j if one of t, j suppresses the other
  __shared__ unsigned long long verdict[2];  // suppressed by this block's share, by row-block parity
  __shared__ int s_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nv = min(n_valid[b], N);
  const float4* bx = boxes + (long)b * N;
  const int* ord = order + (long)b * N;
  if (tid == 0) s_total = 0;
  float4 nb = make_float4(0.f, 0.f, 0.f, 0.f);
  int no = 0;
  unsigned n_iou = 0;  // IoUs this thread evaluated (kCount)
  if (tid < kRow && tid < nv) {
    nb = bx[tid];
    no = ord[tid];
  }
  __syncthreads();
  for (int start = 0, parity = 0; start < nv; start += kRow, parity ^= 1) {
    if (tid < kRow) {
      cbox[tid] = nb;
      carea[tid] = area(nb);
      corder[tid] = no;
      const int i = start + kRow + tid;  // prefetch the next row block
      if (i < nv) {
        nb = bx[i];
        no = ord[i];
      }
    }
    // the other blocks last read this word two row blocks ago, before the
    // previous cluster barrier
    if (tid == 0) verdict[parity] = 0ull;
    __syncthreads();
    const int K = s_total;
    const int k_here = K > rank ? (K - rank + cs - 1) / cs : 0;  // keeps rank, rank + cs, ...
    const int rows = min(nv - start, kRow);

    // 1. candidates 2 * warp + half against this block's share of the kept set
    const int c = 2 * warp + (lane >> 4);
    const bool live = c < rows;
    const float4 cb = cbox[c];
    const float ca = carea[c];
    bool s = false;
    for (int j0 = 0; j0 < k_here; j0 += 16) {
      const int j = j0 + (lane & 15);
      if (live && !s && j < k_here) {
        s = suppresses(kept_box[j], kept_area[j], cb, ca, thr);
        if (kCount) ++n_iou;
      }
      const unsigned m = __ballot_sync(kFull, s || !live);
      if ((m & 0xffffu) && (m >> 16)) break;  // both candidates decided
    }
    const unsigned sm = __ballot_sync(kFull, s);
    const bool sup[2] = {(sm & 0xffffu) != 0u, (sm >> 16) != 0u};
    if (lane == 0 && (sup[0] || sup[1]))
      atomicOr(&verdict[parity], (unsigned long long)(sup[0] | (sup[1] << 1)) << (2 * warp));

    // 2. the in-block rows of the same two candidates, where still alive
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * warp + h;
      if (r >= rows || sup[h]) continue;  // warp-uniform
      const float4 rb = cbox[r];
      const float ra = carea[r];
      bool hit[2];
      for (int q = 0; q < 2; ++q) {
        const int j = lane + 32 * q;
        hit[q] = j != r && j < rows &&
                 (j > r ? suppresses(rb, ra, cbox[j], carea[j], thr)
                        : suppresses(cbox[j], carea[j], rb, ra, thr));
        if (kCount && j != r && j < rows) ++n_iou;
      }
      const unsigned mlo = __ballot_sync(kFull, hit[0]), mhi = __ballot_sync(kFull, hit[1]);
      if (lane == 0) prow[r] = ((unsigned long long)mhi << 32) | mlo;
    }
    cluster.sync();

    // 3. one warp resolves the row block and stores this block's share of its keeps
    if (warp == 0) {
      const unsigned long long v =
          lane < cs ? *cluster.map_shared_rank(&verdict[parity], lane) : 0ull;
      const unsigned long long dead =
          __reduce_or_sync(kFull, (unsigned)v) |
          ((unsigned long long)__reduce_or_sync(kFull, (unsigned)(v >> 32)) << 32);
      const unsigned long long in_rows = rows == kRow ? ~0ull : (1ull << rows) - 1ull;
      unsigned long long alive = in_rows & ~dead;
      // lane holds candidates lane and lane + 32: the live earlier ones that suppress them
      unsigned long long earlier[2];
      for (int q = 0; q < 2; ++q) {
        const int t = lane + 32 * q;
        earlier[q] = (alive >> t) & 1ull ? prow[t] & ((1ull << t) - 1ull) : 0ull;
      }
      unsigned long long keep = 0ull;
      while (alive) {
        bool sure[2], hit[2];
        for (int q = 0; q < 2; ++q)  // live, and no live earlier candidate suppresses it
          sure[q] = ((alive >> (lane + 32 * q)) & 1ull) && !(earlier[q] & alive);
        const unsigned long long now = (unsigned long long)__ballot_sync(kFull, sure[0]) |
                                       ((unsigned long long)__ballot_sync(kFull, sure[1]) << 32);
        for (int q = 0; q < 2; ++q) hit[q] = (earlier[q] & now) != 0ull;  // a keep suppresses it
        const unsigned long long killed = (unsigned long long)__ballot_sync(kFull, hit[0]) |
                                          ((unsigned long long)__ballot_sync(kFull, hit[1]) << 32);
        keep |= now;
        alive &= ~(now | killed);
      }
      for (int over = K + __popcll(keep) - max_out; over > 0; --over)
        keep &= ~(1ull << (63 - __clzll((long long)keep)));  // the greedy stops at max_out
      for (int q = 0; q < 2; ++q) {
        const int p = lane + 32 * q;
        if ((keep >> p) & 1ull) {
          const int at = K + __popcll(keep & ((1ull << p) - 1ull));
          if (at % cs == rank) {
            kept_box[at / cs] = cbox[p];
            kept_area[at / cs] = carea[p];
            kept_idx[at / cs] = corder[p];
          }
        }
      }
      if (lane == 0) s_total = K + __popcll(keep);
    }
    __syncthreads();
    if (s_total >= max_out) break;
  }
  const int total = s_total;
  for (int k = rank + cs * tid; k < max_out; k += cs * kThreads)
    keep_idx[(long)b * max_out + k] = k < total ? kept_idx[k / cs] : 0;
  if (tid == 0 && rank == 0) keep_count[b] = total;
  if (kCount) {
    const unsigned w = __reduce_add_sync(kFull, n_iou);
    if (lane == 0 && w) atomicAdd(ious, (unsigned long long)w);
  }
  cluster.sync();  // no block leaves while another may read its verdicts
}

// The largest cluster (8, 4, 2 or 1 blocks) of which all B run at once,
// asked of the occupancy calculator with the launch's own shared memory:
// on the H100, 15 clusters of 8 fit, so 16 images take clusters of 4 (a
// 16th cluster of 8 would wait for a second wave). Cached per device,
// max_out and B; a miss also sets the kernel's shared-memory limit on the
// device first.
template <bool kCount>
cudaError_t cluster_size(int device, int B, int max_out, int* cs_out) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> sizes;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, max_out, B);
  const auto hit = sizes.find(key);
  if (hit != sizes.end()) {
    *cs_out = hit->second;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // first on this device: shared memory above the default 48 KB is allowed
  // up to what a cluster of one needs (kMaxKeep keeps: 196,608 B)
  cudaError_t e = cudaFuncSetAttribute(
      nms_walk<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kept_smem(kMaxKeep, 1));
  if (e != cudaSuccess) return e;
  int cs = kMaxCluster;
  for (; cs > 1; cs /= 2) {
    cfg.gridDim = dim3(cs);
    cfg.dynamicSmemBytes = kept_smem(max_out, cs);
    attr[0].val.clusterDim.x = cs;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, nms_walk<kCount>, &cfg);
    if (e != cudaSuccess) return e;
    if (n >= B) break;
  }
  sizes[key] = cs;
  *cs_out = cs;
  return cudaSuccess;
}

template <bool kCount>
int launch(const void* boxes, const void* order, const void* n_valid, void* keep_idx,
           void* keep_count, int B, int N, float thr, int max_out, void* ious, void* stream) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  int cs = 1;
  e = cluster_size<kCount>(device, B, max_out, &cs);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kept_smem(max_out, cs);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_walk<kCount>, (const float4*)boxes, (const int*)order,
                         (const int*)n_valid, thr, (int*)keep_idx, (int*)keep_count, N, max_out,
                         (max_out + cs - 1) / cs, (unsigned long long*)ious);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// boxes: (B, N, 4) f32, already class/level-offset and sorted by score
// (descending, stable); order: (B, N) int32 original index of each sorted
// box; n_valid: (B,) number of valid (leading) boxes; keep_idx: (B,
// max_out) int32 original indices in pick order, 0 in unused slots (every
// slot is written); keep_count: (B,) number of keeps. 1 <= max_out <=
// kMaxKeep. One launch of B clusters, each of as many blocks (up to 8) as
// let all B run at once. ious: null, or one uint64 to which the walk adds
// the number of IoUs it evaluated (the counting instantiation: chip_smoke.py
// measures the walk's work with it).
extern "C" int nsgp_nms(const void* boxes, const void* order, const void* n_valid,
                        void* keep_idx, void* keep_count, int B, int N, float thr,
                        int max_out, void* ious, void* stream) {
  if (max_out < 1 || max_out > kMaxKeep) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return ious ? launch<true>(boxes, order, n_valid, keep_idx, keep_count, B, N, thr, max_out,
                             ious, stream)
              : launch<false>(boxes, order, n_valid, keep_idx, keep_count, B, N, thr, max_out,
                              nullptr, stream);
}
