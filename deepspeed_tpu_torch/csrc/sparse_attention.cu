// Block-sparse flash attention (forward, dQ, dK/dV) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   sparse_attention_fwd     <- `_sparse_fwd_kernel` (launched by `_sparse_forward`);
//   sparse_attention_bwd_dq  <- `_sparse_bwd_dq_kernel` (`_sparse_backward`);
//   sparse_attention_bwd_dkv <- `_sparse_bwd_dkv_kernel` (`_sparse_backward`).
// A layout is an (n, n) map of `block`-sized tiles, block = T / n. The TPU
// kernels walk a flat list of pairs on the sequential grid axis and carry
// their accumulators in VMEM from a run's `first` pair to its `last`. CUDA
// blocks run in no order, so here a CTA owns output rows and walks their
// partners inside the CTA, accumulators in registers. Every output has one
// owner: no atomics, the same bits from run to run, and every output element
// is written (a key block no query attends gets zeros, the TPU code's dummy
// pair).
//
// Layout of the tensors: q, k, v, o, do, dq, dk, dv (BH, T, D); lse, delta
// (BH, T) fp32, delta = rowsum(dO * O) from the caller. The softmax scale is
// folded into q by the caller. Inputs fp32, bf16 or fp16; D = 16, 32, 64, 80,
// 96 or 128.
// A masked probability is set to exactly 0, never computed from a masked
// score. Causal masking is top-left (key <= query), as in the TPU kernels.
//
// What bounds them on the H100: at the training cell (BH = 64, T = 2048,
// D = 128, bf16, the fixed layout at block 16: 574,464 visible pairs per
// head) the forward does 4 D flops per visible pair (18.8 GFLOP), dq 6 D
// (28.2) and dk/dv 8 D (37.6), against 0.13-0.20 GB of inputs and outputs
// each: about 0.04-0.06 ms at the bf16 tensor-core peak or the memory rate.
//
// -------------------------------------------------------------- schedule
// All three entries walk a CTA schedule built once on the host
// (`SparseSchedule`): a CTA owns 64 rows, four 16-row slices, each the first
// row of one warp (own_rows[cta], -1 for none), taken from layout blocks
// grouped so that they share partners. Its partners stream as a list of
// 16-row chunks (chunks[chunk_ptr[cta] .. chunk_ptr[cta+1]), four to a
// 64-row tile): each chunk word is `first partner row | warp mask`, the mask
// saying which warps' rows attend that chunk. Under causal a chunk that lies
// wholly past a warp's diagonal carries no bit for it; the chunk whose first
// row equals the warp's first row is the diagonal one, and only it evaluates
// the mask. A warp skips a chunk without its bit (a warp-uniform branch), so
// a warp whose rows have no partners writes exact zeros. CTAs are ordered
// longest first, and blockIdx.y is the CTA, so the long ones launch first.
// The forward and dq walk the query side's schedule (own rows are queries,
// chunks keys), dk/dv the key side's.
//
// bf16 / fp16: `sparse_fwd_mma_kernel`, `sparse_bwd_dq_mma_kernel` and
// `sparse_bwd_dkv_mma_kernel` on the tensor cores (mma.sync.m16n8k16,
// ldmatrix, a 2-stage cp.async ring of gathered 64-row tiles;
// hopper_mma.cuh), one warp per 16 own rows, the `m16` of the product, so one
// warp holds one block-16 layout block:
//   * forward: Q stays in registers as A fragments; per tile S = Q K^T by mma
//     for the chunks that carry the warp's bit (K as B by ldmatrix), the
//     running max and sum rescaled once per 64-key tile (the rescale touches
//     all D / 2 accumulator floats of a lane, as much work as a chunk's
//     product), P rounded to the input type as the TPU's
//     `_online_softmax_block` does and fed from registers to O += P V (V by
//     ldmatrix.trans); O / l_safe and lse = m + log(l_safe) at the end, with
//     l_safe = (l == 0 ? 1 : l) as in the TPU kernel. Q is staged in the K
//     ring's second stage until tile 1 lands there, so the CTA holds only the
//     two rings (70 KB at D = 128) and three CTAs fit on an SM;
//   * dq: Q and dO stay in registers as A fragments; per chunk `dq_chunk`
//     (hopper_mma.cuh, shared with the dense dq kernel): S = Q K^T and
//     dP = dO V^T by mma, P = exp(S - lse) and dS = P (dP - delta) on the
//     fragments, dS rounded to k's type as the TPU's `_bwd_p_ds` does and fed
//     from registers to dQ += dS K (K by ldmatrix.trans). Q and dO are staged
//     in the rings' second stages, as the forward stages Q and the dense dq
//     stages both, so it too holds only the two rings;
//   * dk/dv: `flash_bwd_dkv_mma_kernel`'s loop over gathered query chunks:
//     S^T = K Q^T and dP^T = V dO^T, P^T (rounded to do's type, as JAX does)
//     and dS^T from registers into dV += P^T dO and dK += dS^T Q; the chunk's
//     lse and delta come by cp.async beside it. K and V stay in registers as A
//     fragments for D <= 96 and are re-read by ldmatrix at D = 128 (the two
//     fp32 accumulators take 128 registers a thread there).
// fp32: `sparse_fwd_kernel`, `sparse_bwd_dq_kernel` and
// `sparse_bwd_dkv_kernel`, CUDA cores, kept because the fp32 checks hold the
// kernels to 1e-4 of an fp32 reference, which neither TF32 nor bf16 products
// can meet: 8 warps of 8 own rows, two chunks (32 partner rows, one per
// lane) per streamed tile, all in fp32. The dtype code selects the instance;
// nothing falls back at run time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kRowsPerWarp = 8;
constexpr int kTile = 32;        // streamed rows per tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ int lane_of(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------- fp32
// The schedule's CTA owns four 16-row slices (own_rows[cta]); warp w of 8
// owns the 8 rows (w % 2) * 8 .. of slice w / 2. A streamed tile is two
// chunks of the schedule, 32 partner rows, one per lane: lane j's chunk is
// j / 16, and a lane's row counts for the warp when that chunk's bit for
// the warp's slice is set.
constexpr int kCtaRows = 64;
constexpr int kCtaWarps = kCtaRows / kRowsPerWarp;
constexpr int kCtaThreads = kCtaWarps * 32;

// Shared-memory sizes in floats: the CTA's own rows (unpadded, read as
// broadcasts), streamed rows (padded by 4 floats for conflict-free float4
// reads) and per-warp 8 x 32 scratch blocks.
template <int D>
struct Smem {
  static constexpr int kStride = D + 4;
  static constexpr int own = kCtaRows * D;
  static constexpr int streamed = kTile * kStride;
  static constexpr int scratch = kCtaRows * kTile;
  static constexpr int fwd_bytes = (own + streamed + kTile * D + scratch) * 4;
  static constexpr int dq_bytes = (2 * own + 2 * streamed + scratch) * 4;
  static constexpr int dkv_bytes = (2 * own + 2 * streamed + 2 * scratch) * 4;
};

// Rows s_idx[0..32) of a (T, D) slice into shared memory with the given row
// stride; a row of index -1 is zero.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           const int* s_idx, int stride) {
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    const int g = s_idx[r];
    dst[r * stride + c] = g >= 0 ? src[static_cast<size_t>(g) * D + c] : 0.f;
  }
}

// The CTA's four slices of a (T, D) slice, unpadded; a slice of -1 is
// zero.
template <int D>
__device__ __forceinline__ void stage_slices(float* dst, const float* __restrict__ src, int4 own) {
  for (int e = threadIdx.x; e < kCtaRows * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    const int r0 = lane_of(own, r / 16);
    dst[e] = r0 >= 0 ? src[static_cast<size_t>(r0 + r % 16) * D + c] : 0.f;
  }
}

// Tile t of a CTA's chunk list: threads 0..31 write lane j's partner row (-1
// for a padding chunk) and its chunk's warp mask; the caller synchronises.
__device__ __forceinline__ void stage_chunk_index(int* s_idx, int* s_bits,
                                                  const int* __restrict__ list, int t) {
  if (threadIdx.x < kTile) {
    const int word = list[2 * t + threadIdx.x / 16];
    const int bits = word & 15;
    s_idx[threadIdx.x] = bits ? (word & ~15) + threadIdx.x % 16 : -1;
    s_bits[threadIdx.x] = bits;
  }
}

// Forward. Own rows are queries, chunks are keys.
template <int D>
__global__ void __launch_bounds__(kCtaThreads)
sparse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  const int4* __restrict__ own_rows, const int* __restrict__ chunk_ptr,
                  const int* __restrict__ chunks, int t, int causal) {
  constexpr int KS = Smem<D>::kStride;
  constexpr int C = hopper::lane_cols(D);  // output columns per lane
  extern __shared__ float4 smem4[];
  __shared__ int s_idx[kTile], s_bits[kTile];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Smem<D>::own;
  float* sV = sK + Smem<D>::streamed;
  float* sP = sV + kTile * D;

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int4 own = own_rows[blockIdx.y];
  const int slice = warp / 2;
  const int first = lane_of(own, slice);               // the slice's first row, -1: none
  const int row0 = first + (warp % 2) * kRowsPerWarp;  // the warp's first query row
  const int* list = chunks + chunk_ptr[blockIdx.y];
  const int n_tiles = (chunk_ptr[blockIdx.y + 1] - chunk_ptr[blockIdx.y]) / 2;

  stage_slices<D>(sQ, q + base, own);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const float* myQ = sQ + warp * kRowsPerWarp * D;
  float* myP = sP + warp * kRowsPerWarp * kTile;

  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stage_chunk_index(s_idx, s_bits, list, tt);
    __syncthreads();
    stage_rows<D>(sK, k + base, s_idx, KS);
    stage_rows<D>(sV, v + base, s_idx, D);
    __syncthreads();

    const int key = s_idx[lane];  // lane j owns key s_idx[j]
    const bool take = first >= 0 && ((s_bits[lane] >> slice) & 1);
    if (!__any_sync(0xffffffffu, take)) continue;  // neither chunk is this warp's

    // S = Q K^T for this warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = sK + lane * KS;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = dot4(*reinterpret_cast<const float4*>(myQ + r * D + c), kv, s[r]);
    }

    // online softmax; only the slice's diagonal chunk evaluates the mask
    const bool full = __all_sync(0xffffffffu, take && (!causal || key < first));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (take && (!causal || key <= row0 + r));
      const float sr = valid ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
      myP[r * kTile + lane] = p;
    }
    __syncwarp();

    // O += P V; lane owns output columns lane + 32 c.
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pr[r] = *reinterpret_cast<const float4*>(myP + r * kTile + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = sV + (j + jj) * D + lane;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!hopper::lane_owns<D>(lane, c)) continue;
          const float vv = vr[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(lane_of(pr[r], jj), vv, acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

  if (first < 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    float* orow = o + base + static_cast<size_t>(row) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (hopper::lane_owns<D>(lane, c)) orow[32 * c] = acc[r][c] / l_safe;
    if (lane == 0) lse[static_cast<size_t>(bh) * t + row] = m[r] + logf(l_safe);
  }
}

// dQ. Own rows are queries, chunks are keys.
template <int D>
__global__ void __launch_bounds__(kCtaThreads)
sparse_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, const int4* __restrict__ own_rows,
                     const int* __restrict__ chunk_ptr, const int* __restrict__ chunks, int t,
                     int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = hopper::lane_cols(D);
  extern __shared__ float4 smem4[];
  __shared__ int s_idx[kTile], s_bits[kTile];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + Smem<D>::own;
  float* sK = sDO + Smem<D>::own;
  float* sV = sK + Smem<D>::streamed;
  float* sDS = sV + Smem<D>::streamed;

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int4 own = own_rows[blockIdx.y];
  const int slice = warp / 2;
  const int first = lane_of(own, slice);                  // the slice's first row, -1: none
  const int row0 = first + (warp % 2) * kRowsPerWarp;     // the warp's first query row
  const int* list = chunks + chunk_ptr[blockIdx.y];
  const int n_tiles = (chunk_ptr[blockIdx.y + 1] - chunk_ptr[blockIdx.y]) / 2;

  stage_slices<D>(sQ, q + base, own);
  stage_slices<D>(sDO, dout + base, own);

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const size_t i = static_cast<size_t>(bh) * t + row0 + r;
    lse_r[r] = first >= 0 ? lse[i] : 0.f;
    delta_r[r] = first >= 0 ? delta[i] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const float* myQ = sQ + warp * kRowsPerWarp * D;
  const float* myDO = sDO + warp * kRowsPerWarp * D;
  float* myDS = sDS + warp * kRowsPerWarp * kTile;

  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();
    stage_chunk_index(s_idx, s_bits, list, tt);
    __syncthreads();
    stage_rows<D>(sK, k + base, s_idx, S);
    stage_rows<D>(sV, v + base, s_idx, S);
    __syncthreads();

    const int key = s_idx[lane];  // lane j owns key s_idx[j]
    const bool take = first >= 0 && ((s_bits[lane] >> slice) & 1);
    if (!__any_sync(0xffffffffu, take)) continue;  // neither chunk is this warp's

    // S = Q K^T and dP = dO V^T for this warp's rows
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* kr = sK + lane * S;
    const float* vr = sV + lane * S;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
      const float4 vv = *reinterpret_cast<const float4*>(vr + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = dot4(*reinterpret_cast<const float4*>(myQ + r * D + c), kv, s[r]);
        dp[r] = dot4(*reinterpret_cast<const float4*>(myDO + r * D + c), vv, dp[r]);
      }
    }

    // dS = P (dP - delta); only the slice's diagonal chunk evaluates the mask
    const bool full = __all_sync(0xffffffffu, take && (!causal || key < first));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (take && (!causal || key <= row0 + r));
      const float p = valid ? expf(s[r] - lse_r[r]) : 0.f;
      myDS[r * kTile + lane] = p * (dp[r] - delta_r[r]);
    }
    __syncwarp();

    // dQ += dS K; lane owns output columns lane + 32 c.
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 ds4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        ds4[r] = *reinterpret_cast<const float4*>(myDS + r * kTile + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = sK + (j + jj) * S + lane;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!hopper::lane_owns<D>(lane, c)) continue;
          const float kk = krow[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(lane_of(ds4[r], jj), kk, acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

  if (first < 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* out = dq + base + static_cast<size_t>(row0 + r) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (hopper::lane_owns<D>(lane, c)) out[32 * c] = acc[r][c];
  }
}

// dK, dV. Own rows are keys, chunks are queries.
template <int D>
__global__ void __launch_bounds__(kCtaThreads)
sparse_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      const int4* __restrict__ own_rows, const int* __restrict__ chunk_ptr,
                      const int* __restrict__ chunks, int t, int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = hopper::lane_cols(D);
  extern __shared__ float4 smem4[];
  __shared__ int s_idx[kTile], s_bits[kTile];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + Smem<D>::own;
  float* sQ = sV + Smem<D>::own;
  float* sDO = sQ + Smem<D>::streamed;
  float* sP = sDO + Smem<D>::streamed;
  float* sDS = sP + Smem<D>::scratch;

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const float* lseb = lse + static_cast<size_t>(bh) * t;
  const float* deltab = delta + static_cast<size_t>(bh) * t;
  const int4 own = own_rows[blockIdx.y];
  const int slice = warp / 2;
  const int first = lane_of(own, slice);
  const int key0 = first + (warp % 2) * kRowsPerWarp;  // the warp's first key row
  const int* list = chunks + chunk_ptr[blockIdx.y];
  const int n_tiles = (chunk_ptr[blockIdx.y + 1] - chunk_ptr[blockIdx.y]) / 2;  // 0: unattended

  stage_slices<D>(sK, k + base, own);
  stage_slices<D>(sV, v + base, own);

  float acc_k[kRowsPerWarp][C], acc_v[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  const float* myK = sK + warp * kRowsPerWarp * D;
  const float* myV = sV + warp * kRowsPerWarp * D;
  float* myP = sP + warp * kRowsPerWarp * kTile;
  float* myDS = sDS + warp * kRowsPerWarp * kTile;

  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();
    stage_chunk_index(s_idx, s_bits, list, tt);
    __syncthreads();
    stage_rows<D>(sQ, q + base, s_idx, S);
    stage_rows<D>(sDO, dout + base, s_idx, S);
    __syncthreads();

    const int query = s_idx[lane];  // lane i owns query s_idx[i]
    const bool take = first >= 0 && ((s_bits[lane] >> slice) & 1);
    if (!__any_sync(0xffffffffu, take)) continue;

    // S^T = K Q^T and dP^T = V dO^T for this warp's keys
    const float lse_i = query >= 0 ? lseb[query] : 0.f;
    const float delta_i = query >= 0 ? deltab[query] : 0.f;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* qr = sQ + lane * S;
    const float* dor = sDO + lane * S;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + c);
      const float4 dov = *reinterpret_cast<const float4*>(dor + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = dot4(*reinterpret_cast<const float4*>(myK + r * D + c), qv, s[r]);
        dp[r] = dot4(*reinterpret_cast<const float4*>(myV + r * D + c), dov, dp[r]);
      }
    }

    const bool full = __all_sync(0xffffffffu, take && (!causal || query >= first + 16));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (take && (!causal || key0 + r <= query));
      const float p = valid ? expf(s[r] - lse_i) : 0.f;
      myP[r * kTile + lane] = p;
      myDS[r * kTile + lane] = p * (dp[r] - delta_i);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q over the tile's queries; lane owns
    // output columns lane + 32 c.
#pragma unroll 1
    for (int i = 0; i < kTile; i += 4) {
      float4 p4[kRowsPerWarp], ds4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        p4[r] = *reinterpret_cast<const float4*>(myP + r * kTile + i);
        ds4[r] = *reinterpret_cast<const float4*>(myDS + r * kTile + i);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float* qrow = sQ + (i + ii) * S + lane;
        const float* dorow = sDO + (i + ii) * S + lane;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!hopper::lane_owns<D>(lane, c)) continue;
          const float qq = qrow[32 * c];
          const float dd = dorow[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            acc_v[r][c] = fmaf(lane_of(p4[r], ii), dd, acc_v[r][c]);
            acc_k[r][c] = fmaf(lane_of(ds4[r], ii), qq, acc_k[r][c]);
          }
        }
      }
    }
    __syncwarp();
  }

  if (first < 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const size_t off = base + static_cast<size_t>(key0 + r) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!hopper::lane_owns<D>(lane, c)) continue;
      dk[off + 32 * c] = acc_k[r][c];
      dv[off + 32 * c] = acc_v[r][c];
    }
  }
}

// ------------------------------------------- backward on the tensor cores
namespace mma {

constexpr int kThreads = 128;  // 4 warps x 16 own rows
constexpr int kRows = 64;      // own rows of a CTA, partner rows of a streamed tile
constexpr int kStages = 2;

template <int D>
struct Plan {
  static constexpr int kStride = D + 8;  // padded row, in elements
  static constexpr int kTile = kRows * kStride;
  // the forward and dq: the K and V rings alone (Q, and dO for dq, are
  // staged in the rings' second stages, the epilogue goes through the K
  // ring's first), as the dense dq; dk/dv: two own tiles, the rings, and
  // the lse and delta rings (fp32)
  static constexpr int ring_bytes = (2 * kStages) * kTile * 2;
  static constexpr int dkv_bytes = ring_bytes + 2 * kTile * 2 + 2 * kStages * kRows * 4;
};

// A tile's four chunk words as the rows to load: a padding chunk (no warp)
// is not loaded.
__device__ __forceinline__ void chunk_rows(int (&rows)[4], int4 words) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = lane_of(words, i);
    rows[i] = (w & 15) ? (w & ~15) : -1;
  }
}

// Forward. Own rows are queries, chunks are keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse,
                      const int4* __restrict__ own_rows, const int* __restrict__ chunk_ptr,
                      const int* __restrict__ chunks, int t, int causal) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NO = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kStages * Plan<D>::kTile;
  T* sQ = sK + Plan<D>::kTile;  // Q in the K ring's stage 1 until tile 1 lands there

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int4 own4 = own_rows[blockIdx.y];
  const int own[4] = {own4.x, own4.y, own4.z, own4.w};
  const int row_w = lane_of(own4, warp);  // the warp's first query row, -1: none
  const int4* tiles = reinterpret_cast<const int4*>(chunks + chunk_ptr[blockIdx.y]);
  const int n_tiles = (chunk_ptr[blockIdx.y + 1] - chunk_ptr[blockIdx.y]) / 4;
  const int4 none = make_int4(0, 0, 0, 0);

  auto load_tile = [&](int st, int4 words) {
    int rows[4];
    chunk_rows(rows, words);
    load_chunks_async<T, D, kThreads>(sK + st * Plan<D>::kTile, k + base, rows);
    load_chunks_async<T, D, kThreads>(sV + st * Plan<D>::kTile, v + base, rows);
  };

  // the words of tile t + 1 are read one tile ahead, so the ring's address
  // arithmetic never waits on them
  int4 w_next = n_tiles > 1 ? tiles[1] : none;
  load_chunks_async<T, D, kThreads>(sQ, q + base, own);
  if (n_tiles > 0) load_tile(0, tiles[0]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KS][4];  // the warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw score units
  float l[2] = {0.f, 0.f};              // this lane's partial row sums

  int4 w_cur = n_tiles > 0 ? tiles[0] : none;
  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<kStages - 2>();  // tile tt has landed
    __syncthreads();               // ... for every thread, and tile tt - 1 is consumed
    if (tt + 1 < n_tiles) load_tile((tt + 1) % kStages, w_next);
    cp_async_commit();
    const int4 words = w_cur;
    w_cur = w_next;
    w_next = tt + 2 < n_tiles ? tiles[tt + 2] : none;
    const T* ks = sK + (tt % kStages) * Plan<D>::kTile;
    const T* vs = sV + (tt % kStages) * Plan<D>::kTile;

    // the chunks of this tile that carry the warp's bit (warp-uniform)
    bool has[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) has[ch] = (lane_of(words, ch) >> warp) & 1;
    if (!(has[0] || has[1] || has[2] || has[3])) continue;

    // S = Q K^T: per chunk two n-tiles of 8 keys; one ldmatrix.x4 gives both B
    float s[4][2][4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
      for (int n = 0; n < 2; ++n) s[ch][n][0] = s[ch][n][1] = s[ch][n][2] = s[ch][n][3] = 0.f;
      if (!has[ch]) continue;
      const int b_row = (ch * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + b_row + kk * 16);
        mma_16816<T>(s[ch][0], qf[kk], b[0], b[1]);
        mma_16816<T>(s[ch][1], qf[kk], b[2], b[3]);
      }
      // only the warp's diagonal chunk is masked: element e of n-tile n is
      // query row g + 8 (e / 2), key column n * 8 + 2 c + e % 2
      if (causal && (lane_of(words, ch) & ~15) == row_w) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + 2 * c + (e & 1) > g + (e >> 1) * 8) s[ch][n][e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments, rescaled once per tile: a row's
    // scores lie in one quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (!has[ch]) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[ch][n][0], s[ch][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[ch][n][2], s[ch][n][3]));
      }
    }
    float ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ml[i] = (mx[i] == -INFINITY ? 0.f : mx[i]) * kLog2e;  // a row that saw no key yet
      const float corr = exp2_fast(m[i] * kLog2e - ml[i]);
      m[i] = mx[i];
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }

    // P (a masked score gives exactly 0) and O += P V: P in the input type
    // from registers, V by ldmatrix.trans
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (!has[ch]) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[ch][n][e] = exp2_fast(fmaf(s[ch][n][e], kLog2e, -ml[e >> 1]));
          l[e >> 1] += s[ch][n][e];
        }
      }
      const uint32_t pa[4] = {
          pack2<T>(s[ch][0][0], s[ch][0][1]), pack2<T>(s[ch][0][2], s[ch][0][3]),
          pack2<T>(s[ch][1][0], s[ch][1][1]), pack2<T>(s[ch][1][2], s[ch][1][3])};
      const int t_row = (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + t_row + dd * 16);
        mma_16816<T>(acc[2 * dd], pa, b[0], b[1]);
        mma_16816<T>(acc[2 * dd + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  if (row_w < 0) return;

  // epilogue: O / l_safe through the warp's own 16 rows of the K ring's
  // first stage, then 16-byte coalesced stores; lse = m + log l_safe
  float l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l_safe[i] = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][2 * i] *= inv;
      acc[n][2 * i + 1] *= inv;
    }
  }
  store_rows<T, D>(o + base, sK + warp * 16 * S, acc, row_w, 16, lane);
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse[static_cast<size_t>(bh) * t + row_w + g + 8 * i] = m[i] + logf(l_safe[i]);
  }
}

// dQ. Own rows are queries, chunks are keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, const int4* __restrict__ own_rows,
                         const int* __restrict__ chunk_ptr, const int* __restrict__ chunks, int t,
                         int causal) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kStages * Plan<D>::kTile;
  T* sQ = sK + Plan<D>::kTile;  // Q and dO in the rings' stage 1 until tile 1 lands
  T* sDO = sV + Plan<D>::kTile;

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int4 own4 = own_rows[blockIdx.y];
  const int own[4] = {own4.x, own4.y, own4.z, own4.w};
  const int row_w = lane_of(own4, warp);  // the warp's first query row, -1: none
  const int4* tiles = reinterpret_cast<const int4*>(chunks + chunk_ptr[blockIdx.y]);
  const int n_tiles = (chunk_ptr[blockIdx.y + 1] - chunk_ptr[blockIdx.y]) / 4;
  const int4 none = make_int4(0, 0, 0, 0);

  auto load_tile = [&](int st, int4 words) {
    int rows[4];
    chunk_rows(rows, words);
    load_chunks_async<T, D, kThreads>(sK + st * Plan<D>::kTile, k + base, rows);
    load_chunks_async<T, D, kThreads>(sV + st * Plan<D>::kTile, v + base, rows);
  };

  // the words of tile t + 1 are read one tile ahead, so the ring's address
  // arithmetic never waits on them
  int4 w_next = n_tiles > 1 ? tiles[1] : none;
  load_chunks_async<T, D, kThreads>(sQ, q + base, own);
  load_chunks_async<T, D, kThreads>(sDO, dout + base, own);
  if (n_tiles > 0) load_tile(0, tiles[0]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 query rows of Q and dO as A fragments; lse and delta of
  // its rows g and g + 8
  uint32_t qf[KS][4], dof[KS][4];
  const int a_row = (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], sQ + a_row + kk * 16);
    ldmatrix_x4(dof[kk], sDO + a_row + kk * 16);
  }
  float lq[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = static_cast<size_t>(bh) * t + row_w + g + 8 * i;
    lq[i] = row_w >= 0 ? lse[r] * kLog2e : 0.f;
    dl[i] = row_w >= 0 ? delta[r] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int4 w_cur = n_tiles > 0 ? tiles[0] : none;
  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<kStages - 2>();  // tile tt has landed
    __syncthreads();               // ... for every thread, and tile tt - 1 is consumed
    if (tt + 1 < n_tiles) load_tile((tt + 1) % kStages, w_next);
    cp_async_commit();
    const int4 words = w_cur;
    w_cur = w_next;
    w_next = tt + 2 < n_tiles ? tiles[tt + 2] : none;
    const T* ks = sK + (tt % kStages) * Plan<D>::kTile;
    const T* vs = sV + (tt % kStages) * Plan<D>::kTile;

    // per 16-key chunk; only the warp's diagonal chunk is masked
    const int lim[2] = {g, g + 8};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const int word = lane_of(words, ch);
      if (!((word >> warp) & 1)) continue;  // not this warp's chunk
      dq_chunk<T, D>(acc, qf, dof, ks + ch * 16 * S, vs + ch * 16 * S, lq, dl,
                     causal && (word & ~15) == row_w, lim, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the rings

  // epilogue through the warp's own 16 rows of the K ring's first stage
  if (row_w >= 0) store_rows<T, D>(dq + base, sK + warp * 16 * S, acc, row_w, 16, lane);
}

// dK, dV. Own rows are keys, chunks are queries.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          const int4* __restrict__ own_rows, const int* __restrict__ chunk_ptr,
                          const int* __restrict__ chunks, int t, int causal) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr bool kKVInRegs = D <= 96;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + Plan<D>::kTile;
  T* sQ = sV + Plan<D>::kTile;
  T* sDO = sQ + kStages * Plan<D>::kTile;
  float* sL = reinterpret_cast<float*>(sDO + kStages * Plan<D>::kTile);
  float* sDl = sL + kStages * kRows;

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const float* lg = lse + static_cast<size_t>(bh) * t;
  const float* dlg = delta + static_cast<size_t>(bh) * t;
  const int4 own4 = own_rows[blockIdx.y];
  const int own[4] = {own4.x, own4.y, own4.z, own4.w};
  const int key_w = lane_of(own4, warp);  // the warp's first key row, -1: none
  const int4* tiles = reinterpret_cast<const int4*>(chunks + chunk_ptr[blockIdx.y]);
  const int n_tiles = (chunk_ptr[blockIdx.y + 1] - chunk_ptr[blockIdx.y]) / 4;  // 0: unattended
  const int4 none = make_int4(0, 0, 0, 0);

  auto load_tile = [&](int st, int4 words) {
    int rows[4];
    chunk_rows(rows, words);
    load_chunks_async<T, D, kThreads>(sQ + st * Plan<D>::kTile, q + base, rows);
    load_chunks_async<T, D, kThreads>(sDO + st * Plan<D>::kTile, dout + base, rows);
    const int i = threadIdx.x % kRows;  // threads 0-63 take lse, 64-127 delta
    const int r0 = lane_of(make_int4(rows[0], rows[1], rows[2], rows[3]), i / 16);
    if (r0 >= 0)
      cp_async_4((threadIdx.x < kRows ? sL : sDl) + st * kRows + i,
                 (threadIdx.x < kRows ? lg : dlg) + r0 + i % 16, true);
  };

  int4 w_next = n_tiles > 1 ? tiles[1] : none;
  load_chunks_async<T, D, kThreads>(sK, k + base, own);
  load_chunks_async<T, D, kThreads>(sV, v + base, own);
  if (n_tiles > 0) load_tile(0, tiles[0]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 key rows of K and V as A fragments, k-step kk
  const int a_row = (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
  uint32_t kf[kKVInRegs ? KS : 1][4], vf[kKVInRegs ? KS : 1][4];
  if constexpr (kKVInRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(kf[kk], sK + a_row + kk * 16);
      ldmatrix_x4(vf[kk], sV + a_row + kk * 16);
    }
  }

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  int4 w_cur = n_tiles > 0 ? tiles[0] : none;
  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tt + 1 < n_tiles) load_tile((tt + 1) % kStages, w_next);
    cp_async_commit();
    const int4 words = w_cur;
    w_cur = w_next;
    w_next = tt + 2 < n_tiles ? tiles[tt + 2] : none;
    const int st = tt % kStages;
    const T* qs = sQ + st * Plan<D>::kTile;
    const T* dos = sDO + st * Plan<D>::kTile;
    const float* ls = sL + st * kRows;
    const float* dls = sDl + st * kRows;

#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {  // 16-query chunks
      const int word = lane_of(words, ch);
      if (!((word >> warp) & 1)) continue;
      const int query0 = word & ~15;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries, two n-tiles each
      float st_[2][4] = {}, dpt[2][4] = {};
      const int b_row = (ch * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bq[4], bdo[4];
        ldmatrix_x4(bq, qs + b_row + kk * 16);
        ldmatrix_x4(bdo, dos + b_row + kk * 16);
        if constexpr (kKVInRegs) {
          mma_16816<T>(st_[0], kf[kk], bq[0], bq[1]);
          mma_16816<T>(st_[1], kf[kk], bq[2], bq[3]);
          mma_16816<T>(dpt[0], vf[kk], bdo[0], bdo[1]);
          mma_16816<T>(dpt[1], vf[kk], bdo[2], bdo[3]);
        } else {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, sK + a_row + kk * 16);
          ldmatrix_x4(va, sV + a_row + kk * 16);
          mma_16816<T>(st_[0], ka, bq[0], bq[1]);
          mma_16816<T>(st_[1], ka, bq[2], bq[3]);
          mma_16816<T>(dpt[0], va, bdo[0], bdo[1]);
          mma_16816<T>(dpt[1], va, bdo[2], bdo[3]);
        }
      }

      // P^T and dS^T; element e of n-tile n is key row g + 8 (e / 2), query
      // column n * 8 + 2 c + e % 2 of the chunk. Only the warp's diagonal
      // chunk is masked.
      const bool mask = causal && query0 == key_w;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int qi = ch * 16 + n * 8 + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dq = (e & 1) ? d2.y : d2.x;
          float p = exp2_fast((st_[n][e] - lq) * kLog2e);
          if (mask && g + (e >> 1) * 8 > n * 8 + 2 * c + (e & 1)) p = 0.f;
          st_[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dq);
        }
      }
      const uint32_t pa[4] = {pack2<T>(st_[0][0], st_[0][1]), pack2<T>(st_[0][2], st_[0][3]),
                              pack2<T>(st_[1][0], st_[1][1]), pack2<T>(st_[1][2], st_[1][3])};
      const uint32_t da[4] = {pack2<T>(dpt[0][0], dpt[0][1]), pack2<T>(dpt[0][2], dpt[0][3]),
                              pack2<T>(dpt[1][0], dpt[1][1]), pack2<T>(dpt[1][2], dpt[1][3])};

      // dV += P^T dO and dK += dS^T Q over the chunk's 16 queries
      const int t_row = (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dos + t_row + dd * 16);
        mma_16816<T>(dv_acc[2 * dd], pa, b[0], b[1]);
        mma_16816<T>(dv_acc[2 * dd + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, qs + t_row + dd * 16);
        mma_16816<T>(dk_acc[2 * dd], da, b[0], b[1]);
        mma_16816<T>(dk_acc[2 * dd + 1], da, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue through the warp's own rows of the K and V tiles (only this
  // warp ever read them); keys no query sees keep their zeros
  if (key_w >= 0) {
    store_rows<T, D>(dk + base, sK + warp * 16 * S, dk_acc, key_w, 16, lane);
    store_rows<T, D>(dv + base, sV + warp * 16 * S, dv_acc, key_w, 16, lane);
  }
}

}  // namespace mma

// ------------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  const int4* own;  // the schedule
  const int *chunk_ptr, *chunks;
  int n_cta, bh, t, causal;
  cudaStream_t stream;
};

enum class Entry { kFwd, kDq, kDkv };

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// blockIdx.y is the schedule's CTA, longest first.
template <typename T, int D>
cudaError_t launch(Entry entry, const Args& a) {
  const dim3 grid(a.bh, a.n_cta);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  float* lse_out = static_cast<float*>(a.lse_out);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {  // the CUDA-core instances
    if (entry == Entry::kFwd) {
      constexpr int smem = Smem<D>::fwd_bytes;
      if ((err = prepare(sparse_fwd_kernel<D>, smem)) != cudaSuccess) return err;
      sparse_fwd_kernel<D><<<grid, kCtaThreads, smem, a.stream>>>(
          q, k, v, static_cast<float*>(a.o), lse_out, a.own, a.chunk_ptr, a.chunks, a.t,
          a.causal);
    } else if (entry == Entry::kDq) {
      constexpr int smem = Smem<D>::dq_bytes;
      if ((err = prepare(sparse_bwd_dq_kernel<D>, smem)) != cudaSuccess) return err;
      sparse_bwd_dq_kernel<D><<<grid, kCtaThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.own, a.chunk_ptr, a.chunks,
          a.t, a.causal);
    } else {
      constexpr int smem = Smem<D>::dkv_bytes;
      if ((err = prepare(sparse_bwd_dkv_kernel<D>, smem)) != cudaSuccess) return err;
      sparse_bwd_dkv_kernel<D><<<grid, kCtaThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
          a.own, a.chunk_ptr, a.chunks, a.t, a.causal);
    }
  } else {  // bf16 / fp16: the tensor cores
    if (entry == Entry::kFwd) {
      constexpr int smem = mma::Plan<D>::ring_bytes;
      if ((err = prepare(mma::sparse_fwd_mma_kernel<T, D>, smem)) != cudaSuccess) return err;
      mma::sparse_fwd_mma_kernel<T, D><<<grid, mma::kThreads, smem, a.stream>>>(
          q, k, v, static_cast<T*>(a.o), lse_out, a.own, a.chunk_ptr, a.chunks, a.t, a.causal);
    } else if (entry == Entry::kDq) {
      constexpr int smem = mma::Plan<D>::ring_bytes;
      if ((err = prepare(mma::sparse_bwd_dq_mma_kernel<T, D>, smem)) != cudaSuccess) return err;
      mma::sparse_bwd_dq_mma_kernel<T, D><<<grid, mma::kThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.own, a.chunk_ptr, a.chunks, a.t,
          a.causal);
    } else {
      constexpr int smem = mma::Plan<D>::dkv_bytes;
      if ((err = prepare(mma::sparse_bwd_dkv_mma_kernel<T, D>, smem)) != cudaSuccess) return err;
      mma::sparse_bwd_dkv_mma_kernel<T, D><<<grid, mma::kThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.own,
          a.chunk_ptr, a.chunks, a.t, a.causal);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Entry entry, const Args& a, int d) {
  switch (d) {
    case 16: return launch<T, 16>(entry, a);
    case 32: return launch<T, 32>(entry, a);
    case 64: return launch<T, 64>(entry, a);
    case 80: return launch<T, 80>(entry, a);
    case 96: return launch<T, 96>(entry, a);
    case 128: return launch<T, 128>(entry, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Entry entry, const Args& a, int d, int dtype, int device) {
  if (a.bh < 1 || a.t < 1 || a.t % 16 != 0 || a.n_cta < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);  // this library's runtime has its own current device
  if (err != cudaSuccess) return err;
  if (dtype == 0) return dispatch_d<float>(entry, a, d);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(entry, a, d);
  if (dtype == 2) return dispatch_d<__half>(entry, a, d);
  return cudaErrorInvalidValue;
}

Args schedule_args(const void* own_rows, const void* chunk_ptr, const void* chunks, int n_cta,
                   int bh, int t, int causal, void* stream) {
  Args a{};
  a.own = static_cast<const int4*>(own_rows);
  a.chunk_ptr = static_cast<const int*>(chunk_ptr), a.chunks = static_cast<const int*>(chunks);
  a.n_cta = n_cta, a.bh = bh, a.t = t, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; device: the CUDA ordinal of the
// tensors. Each entry takes its side's int32 schedule (own_rows (n_cta, 4),
// chunk_ptr (n_cta + 1), chunks) on that device: the forward and dq the query
// side's, dk/dv the key side's. Each returns a cudaError_t (0 = launched).
extern "C" int sparse_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* own_rows, const void* chunk_ptr,
                                    const void* chunks, int n_cta, int bh, int t, int d,
                                    int causal, int dtype, int device, void* stream) {
  Args a = schedule_args(own_rows, chunk_ptr, chunks, n_cta, bh, t, causal, stream);
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse_out = lse;
  return run(Entry::kFwd, a, d, dtype, device);
}

extern "C" int sparse_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, const void* own_rows, const void* chunk_ptr,
                                       const void* chunks, int n_cta, int bh, int t, int d,
                                       int causal, int dtype, int device, void* stream) {
  Args a = schedule_args(own_rows, chunk_ptr, chunks, n_cta, bh, t, causal, stream);
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta, a.dq = dq;
  return run(Entry::kDq, a, d, dtype, device);
}

extern "C" int sparse_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, const void* own_rows,
                                        const void* chunk_ptr, const void* chunks, int n_cta,
                                        int bh, int t, int d, int causal, int dtype, int device,
                                        void* stream) {
  Args a = schedule_args(own_rows, chunk_ptr, chunks, n_cta, bh, t, causal, stream);
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta, a.dk = dk, a.dv = dv;
  return run(Entry::kDkv, a, d, dtype, device);
}

extern "C" const char* sparse_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
