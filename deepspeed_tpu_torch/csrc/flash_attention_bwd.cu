// Flash-attention backward (FA2 recompute) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py
// launched from `_flash_backward`:
//   flash_attention_bwd_dq  <- `_bwd_dq_tri_kernel` (causal, triangular grid) and
//                              `_bwd_dq_kernel` (rectangular grid);
//   flash_attention_bwd_dkv <- `_bwd_dkv_tri_kernel` and `_bwd_dkv_kernel`.
// Both recompute the probabilities from the forward's log-sum-exp, as the
// shared `_bwd_p_ds` does:
//   P = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta)
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
// with delta = rowsum(dO * O) computed by the caller in fp32.
//
// The TPU kernels carry their accumulators in VMEM across the sequential
// ("arbitrary") grid axis. CUDA blocks run in no order, so the loop over the
// other axis lives inside the CTA and the accumulators live in registers:
//   * dq:  one CTA per (bh, 64 query rows); it loops over key tiles from the
//          first key up to the diagonal (the row-major `_causal_pairs`).
//   * dkv: one CTA per (bh, 64 key rows); it loops over query tiles from the
//          diagonal down to the last query (`_causal_pairs_colmajor`).
// Each output tile has exactly one owner, so no atomics are needed and the
// result is the same from run to run. Causal masking is top-left aligned
// (key j visible to query i when j <= i), as in the Pallas kernels. Masked
// pairs and rows past the sequence contribute exactly zero (p is set to 0,
// never computed from a masked score), so a row that saw no key, whose lse is
// -1e30, gives zero gradients rather than NaN.
//
// Layout: q, do, dq (BH, Tq, D); k, v, dk, dv (BH, Tk, D); lse, delta (BH, Tq)
// fp32. The softmax scale is folded into q by the caller. Inputs are fp32,
// bf16 or fp16; every sum is fp32; outputs are written in the input type.
//
// What bounds it on the H100: at the training shape (BH = 128, T = 1024,
// D = 96, bf16, causal) the pair recomputes S and dP in both kernels, seven
// half-triangle products in all, 7 * 2 * BH * T^2 * D / 2 ~ 90 GFLOP, against
// ~0.2 GB of inputs and outputs: operations bound (~0.09 ms on the bf16 tensor
// cores).
//
// bf16 / fp16: `flash_bwd_dq_mma_kernel` and `flash_bwd_dkv_mma_kernel` on the
// tensor cores (mma.sync, cp.async; see their section below). fp32:
// `flash_bwd_dq_fp32_kernel` and `flash_bwd_dkv_fp32_kernel`, the first
// design on the CUDA cores, kept because the fp32 checks hold the kernels to
// 1e-4 of an fp32 reference, which neither TF32 nor bf16 tensor-core products
// can meet. The dtype code selects the instance; nothing falls back at run
// time. What the CUDA-core design does:
//   * the CTA's own 64 rows (q and dO, or k and v) are staged once in shared
//     memory and reused against every streamed tile of 32 rows; scores,
//     probabilities and dS never leave the SM;
//   * a lane owns one streamed row (a key for dq, a query for dkv) for the two
//     score products, so a warp's 8 own rows reuse each streamed element read
//     8 times; streamed rows are padded by 4 floats so per-lane float4 reads
//     are free of bank conflicts;
//   * for the accumulating products a lane owns the output columns lane + 32 c
//     (the upper lanes skip the last when D is 16 or 80), so the
//     accumulators need no cross-lane reduction; P and dS pass from the score
//     layout to the column layout through a per-warp scratch in shared memory;
//   * tiles wholly inside the causal triangle and the sequence skip the mask.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // 64 own rows per CTA
constexpr int kBlockCols = 32;                     // streamed rows: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared-memory plan, in floats: two tiles of the CTA's own rows (unpadded,
// read as broadcasts), two streamed tiles (rows padded by 4 floats), and two
// per-warp scratch blocks of 8 x 32 (P and dS; dq needs only dS).
template <int D>
struct Smem {
  static constexpr int kStride = D + 4;
  static constexpr int own = kBlockRows * D;
  static constexpr int streamed = kBlockCols * kStride;
  static constexpr int scratch = kWarps * kRowsPerWarp * kBlockCols;
  static constexpr int bytes = (2 * own + 2 * streamed + 2 * scratch) * static_cast<int>(sizeof(float));
};

// Stage rows [r0, r0 + rows) of a (t, D) slice into shared memory with the
// given row stride; rows past t are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0, int rows,
                                      int t, int stride) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * stride + c] = (r0 + r < t) ? src[static_cast<size_t>(r0 + r) * D + c] : 0.f;
  }
}

// ------------------------------------------------------------------ dQ, fp32
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int t_q, int t_k, int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = hopper::lane_cols(D);  // output columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + Smem<D>::own;
  float* sK = sDO + Smem<D>::own;
  float* sV = sK + Smem<D>::streamed;
  float* sDS = sV + Smem<D>::streamed;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + static_cast<size_t>(bh) * t_q * D;
  const float* dob = dout + static_cast<size_t>(bh) * t_q * D;
  const float* kb = k + static_cast<size_t>(bh) * t_k * D;
  const float* vb = v + static_cast<size_t>(bh) * t_k * D;

  stage<D>(sQ, qb, q0, kBlockRows, t_q, D);
  stage<D>(sDO, dob, q0, kBlockRows, t_q, D);

  const int row0 = q0 + warp * kRowsPerWarp;  // first query row of this warp
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const bool in = row0 + r < t_q;
    const size_t i = static_cast<size_t>(bh) * t_q + row0 + r;
    lse_r[r] = in ? lse[i] : 0.f;
    delta_r[r] = in ? delta[i] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const float* myQ = sQ + warp * kRowsPerWarp * D;
  const float* myDO = sDO + warp * kRowsPerWarp * D;
  float* myDS = sDS + warp * kRowsPerWarp * kBlockCols;
  int last_key = t_k - 1;
  if (causal) last_key = min(last_key, min(q0 + kBlockRows, t_q) - 1);
  const int n_tiles = last_key / kBlockCols + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockCols;
    __syncthreads();  // the previous tile is consumed (and the own rows are staged)
    stage<D>(sK, kb, k0, kBlockCols, t_k, S);
    stage<D>(sV, vb, k0, kBlockCols, t_k, S);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's rows; lane j owns key k0 + j.
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

    // dS = P (dP - delta); only the diagonal or ragged tile evaluates the mask
    const bool full = (k0 + kBlockCols <= t_k) && (!causal || k0 + kBlockCols - 1 <= row0);
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (key < t_k && (!causal || key <= row0 + r));
      const float p = valid ? expf(s[r] - lse_r[r]) : 0.f;
      myDS[r * kBlockCols + lane] = p * (dp[r] - delta_r[r]);
    }
    __syncwarp();

    // dQ += dS K; lane owns output columns lane + 32 c.
#pragma unroll 2
    for (int j = 0; j < kBlockCols; j += 4) {
      float4 ds4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        ds4[r] = *reinterpret_cast<const float4*>(myDS + r * kBlockCols + j);
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

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= t_q) continue;
    float* out = dq + (static_cast<size_t>(bh) * t_q + row) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (hopper::lane_owns<D>(lane, c)) out[32 * c] = acc[r][c];
  }
}

// ------------------------------------------------------------- dK, dV, fp32
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int t_q, int t_k,
                          int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = hopper::lane_cols(D);
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + Smem<D>::own;
  float* sQ = sV + Smem<D>::own;
  float* sDO = sQ + Smem<D>::streamed;
  float* sP = sDO + Smem<D>::streamed;
  float* sDS = sP + Smem<D>::scratch;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + static_cast<size_t>(bh) * t_q * D;
  const float* dob = dout + static_cast<size_t>(bh) * t_q * D;
  const float* lseb = lse + static_cast<size_t>(bh) * t_q;
  const float* deltab = delta + static_cast<size_t>(bh) * t_q;

  stage<D>(sK, k + static_cast<size_t>(bh) * t_k * D, k0, kBlockRows, t_k, D);
  stage<D>(sV, v + static_cast<size_t>(bh) * t_k * D, k0, kBlockRows, t_k, D);

  const int key0 = k0 + warp * kRowsPerWarp;  // first key row of this warp
  float acc_k[kRowsPerWarp][C], acc_v[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  const float* myK = sK + warp * kRowsPerWarp * D;
  const float* myV = sV + warp * kRowsPerWarp * D;
  float* myP = sP + warp * kRowsPerWarp * kBlockCols;
  float* myDS = sDS + warp * kRowsPerWarp * kBlockCols;

  // causal: queries before the CTA's first key see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < t_q; q0 += kBlockCols) {
    __syncthreads();  // the previous tile is consumed (and the own rows are staged)
    stage<D>(sQ, qb, q0, kBlockCols, t_q, S);
    stage<D>(sDO, dob, q0, kBlockCols, t_q, S);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's keys; lane i owns query q0 + i.
    const int query = q0 + lane;
    const bool q_in = query < t_q;
    const float lse_i = q_in ? lseb[query] : 0.f;
    const float delta_i = q_in ? deltab[query] : 0.f;
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

    const bool full = (q0 + kBlockCols <= t_q) && (!causal || key0 + kRowsPerWarp - 1 <= q0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (q_in && (!causal || key0 + r <= query));
      const float p = valid ? expf(s[r] - lse_i) : 0.f;
      myP[r * kBlockCols + lane] = p;
      myDS[r * kBlockCols + lane] = p * (dp[r] - delta_i);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q over the tile's queries; lane owns
    // output columns lane + 32 c.
#pragma unroll 1
    for (int i = 0; i < kBlockCols; i += 4) {
      float4 p4[kRowsPerWarp], ds4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        p4[r] = *reinterpret_cast<const float4*>(myP + r * kBlockCols + i);
        ds4[r] = *reinterpret_cast<const float4*>(myDS + r * kBlockCols + i);
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

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = key0 + r;
    if (key >= t_k) continue;
    const size_t o = (static_cast<size_t>(bh) * t_k + key) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!hopper::lane_owns<D>(lane, c)) continue;
      dk[o + 32 * c] = acc_k[r][c];
      dv[o + 32 * c] = acc_v[r][c];
    }
  }
}


// ----------------------------------------------------- on the tensor cores
// The bf16 / fp16 instances of both entries, on the forward's machinery
// (hopper_mma.cuh). dK, dV: the forward, transposed.
//   * A warpgroup owns 64 key rows, a warp 16 of them; for D <= 96 the warp's
//     K and V rows stay in registers as A-fragments for the whole loop (at
//     D = 128 the two fp32 accumulators alone take 128 registers a thread,
//     so K and V are re-read from shared memory by ldmatrix per chunk
//     instead, which keeps the kernel clear of spills).
//   * The loop walks 64-query tiles from the diagonal (causal) to t_q; Q, dO
//     and the tile's lse and delta come through a 2-stage cp.async ring.
//   * Each tile is taken in four 16-query chunks: S^T = K Q^T and
//     dP^T = V dO^T by mma (Q, dO by ldmatrix), P^T = exp(S^T - lse) and
//     dS^T = P^T (dP^T - delta) on the fragments, both rounded to the input
//     type as `_bwd_p_ds` and `p.astype(do.dtype)` do, and reused from
//     registers as A-fragments for dV += P^T dO and dK += dS^T Q (dO, Q by
//     ldmatrix.trans), accumulated in fp32 registers. On the diagonal tile a
//     warp skips the chunks whose queries all precede its keys, and only the
//     chunk on its diagonal or past t_q evaluates the mask.
//   * Each output row has one owner and the order of the sums is fixed, so
//     the bits are the same every run. Key block 0 walks the most query
//     tiles under causal; blockIdx.y = key block, so it launches first.
namespace mma {

constexpr int kBlockK = 64;  // dk/dv: own key rows, 4 warps x 16; dq: streamed key tile
constexpr int kBlockQ = 64;  // dk/dv: streamed query tile; dq: own query rows
constexpr int kThreads = 128;
constexpr int kStages = 2;

template <int D>
struct Plan {
  static constexpr int kStride = D + 8;  // padded row, in elements
  static constexpr int kTile = 64 * kStride;
  // K and V tiles (reused for the epilogue), the Q ring, the dO ring, then
  // the lse and delta rings (fp32)
  static constexpr int kHalfs = (2 + 2 * kStages) * kTile;
  static constexpr int bytes = kHalfs * 2 + 2 * kStages * kBlockQ * 4;
  // dq: the K and V rings alone; Q and dO are staged in their second
  // stages, and the epilogue goes through the K ring's first
  static constexpr int dq_bytes = 2 * kStages * kTile * 2;
};

// dQ on the tensor cores: `sparse_bwd_dq_mma_kernel`'s loop over contiguous
// tiles. A warpgroup owns 64 query rows, a warp 16 of them; Q and dO stay in
// registers as A fragments and each row's lse * log2 e and delta in
// registers. 64-key tiles of K and V stream from key 0 up to the CTA's
// diagonal (causal) or to t_k through a 2-stage cp.async ring, rows past t_k
// zero-filled. Q and dO are staged in the rings' second stages until tile 1
// lands there, so the CTA holds only the two rings (53 KB at D = 96) and
// three CTAs fit on an SM where the registers allow it. Each tile is taken
// in four 16-key chunks by `dq_chunk` (hopper_mma.cuh): S and dP by mma, P
// and dS on the fragments, dS rounded to the input type, dQ += dS K. A warp
// skips a chunk wholly past its diagonal or past t_k; only a chunk that
// crosses either evaluates the mask. Query rows past t_q are zero-filled,
// neither read as data nor stored. The query blocks with the most keys
// launch first (causal: the block index is reversed), and the epilogue
// stores through shared memory, 16 bytes a lane.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int t_q, int t_k, int causal) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kStages * Plan<D>::kTile;
  T* sQ = sK + Plan<D>::kTile;   // Q and dO in the rings' stage 1 until tile 1 lands
  T* sDO = sV + Plan<D>::kTile;

  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int row_w = q0 + warp * 16;  // the warp's first query row
  const T* kg = k + static_cast<size_t>(bh) * t_k * D;
  const T* vg = v + static_cast<size_t>(bh) * t_k * D;

  int last_key = t_k - 1;
  if (causal) last_key = min(last_key, min(q0 + kBlockQ, t_q) - 1);
  const int n_tiles = last_key / kBlockK + 1;

  load_tile_async<T, D, kBlockQ, kThreads>(sQ, q + static_cast<size_t>(bh) * t_q * D, q0, t_q);
  load_tile_async<T, D, kBlockQ, kThreads>(sDO, dout + static_cast<size_t>(bh) * t_q * D, q0,
                                           t_q);
  load_tile_async<T, D, kBlockK, kThreads>(sK, kg, 0, t_k);
  load_tile_async<T, D, kBlockK, kThreads>(sV, vg, 0, t_k);
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
    const int row = row_w + g + 8 * i;
    const size_t r = static_cast<size_t>(bh) * t_q + row;
    lq[i] = row < t_q ? lse[r] * kLog2e : 0.f;
    dl[i] = row < t_q ? delta[r] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int lim_row[2];  // the last key that rows g and g + 8 see
#pragma unroll
  for (int i = 0; i < 2; ++i) lim_row[i] = causal ? min(t_k - 1, row_w + g + 8 * i) : t_k - 1;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // ... for every thread, and tile t - 1 is consumed
    if (t + 1 < n_tiles) {
      const int st = (t + 1) % kStages;
      load_tile_async<T, D, kBlockK, kThreads>(sK + st * Plan<D>::kTile, kg, (t + 1) * kBlockK,
                                               t_k);
      load_tile_async<T, D, kBlockK, kThreads>(sV + st * Plan<D>::kTile, vg, (t + 1) * kBlockK,
                                               t_k);
    }
    cp_async_commit();
    if (row_w >= t_q) continue;  // a warp wholly past the queries
    const T* ks = sK + (t % kStages) * Plan<D>::kTile;
    const T* vs = sV + (t % kStages) * Plan<D>::kTile;

#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {  // 16-key chunks
      const int key0 = t * kBlockK + ch * 16;
      if (key0 >= t_k || (causal && key0 > row_w + 15)) continue;  // no key visible
      const int lim[2] = {lim_row[0] - key0, lim_row[1] - key0};  // as chunk columns
      const bool mask = key0 + 15 >= t_k || (causal && key0 + 15 > row_w);
      dq_chunk<T, D>(acc, qf, dof, ks + ch * 16 * S, vs + ch * 16 * S, lq, dl, mask, lim, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the rings

  // epilogue through the warp's own 16 rows of the K ring's first stage
  if (row_w < t_q)
    store_rows<T, D>(dq + static_cast<size_t>(bh) * t_q * D, sK + warp * 16 * S, acc, row_w,
                     min(16, t_q - row_w), lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k, int causal) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-tiles of dK, dV
  constexpr bool kKVInRegs = D <= 96;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + Plan<D>::kTile;
  T* sQ = sV + Plan<D>::kTile;
  T* sDO = sQ + kStages * Plan<D>::kTile;
  float* sL = reinterpret_cast<float*>(sK + Plan<D>::kHalfs);
  float* sDl = sL + kStages * kBlockQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int key_w = k0 + warp * 16;  // the warp's first key row
  const T* qg = q + static_cast<size_t>(bh) * t_q * D;
  const T* dog = dout + static_cast<size_t>(bh) * t_q * D;
  const float* lg = lse + static_cast<size_t>(bh) * t_q;
  const float* dlg = delta + static_cast<size_t>(bh) * t_q;

  // causal: queries before the CTA's first key see none of its keys
  const int q_first = causal ? k0 : 0;
  const int n_tiles = q_first < t_q ? (t_q - q_first + kBlockQ - 1) / kBlockQ : 0;

  auto load_q_tile = [&](int tile) {
    const int st = tile % kStages, qt0 = q_first + tile * kBlockQ;
    load_tile_async<T, D, kBlockQ, kThreads>(sQ + st * Plan<D>::kTile, qg, qt0, t_q);
    load_tile_async<T, D, kBlockQ, kThreads>(sDO + st * Plan<D>::kTile, dog, qt0, t_q);
    const int i = threadIdx.x % kBlockQ;  // threads 0-63 take lse, 64-127 delta
    const bool in = qt0 + i < t_q;
    cp_async_4((threadIdx.x < kBlockQ ? sL : sDl) + st * kBlockQ + i,
               (threadIdx.x < kBlockQ ? lg : dlg) + (in ? qt0 + i : 0), in);
  };

  load_tile_async<T, D, kBlockK, kThreads>(sK, k + static_cast<size_t>(bh) * t_k * D, k0, t_k);
  load_tile_async<T, D, kBlockK, kThreads>(sV, v + static_cast<size_t>(bh) * t_k * D, k0, t_k);
  if (n_tiles > 0) load_q_tile(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (st < n_tiles) load_q_tile(st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
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

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // ... for every thread, and tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) load_q_tile(t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages;
    const T* qs = sQ + st * Plan<D>::kTile;
    const T* dos = sDO + st * Plan<D>::kTile;
    const float* ls = sL + st * kBlockQ;
    const float* dls = sDl + st * kBlockQ;
    const int qt0 = q_first + t * kBlockQ;
    const bool diag = causal && t == 0;  // queries qt0.. against keys k0.., qt0 == k0

#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {  // 16-query chunks
      if (diag && ch < warp) continue;  // the chunk's queries all precede the warp's keys
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

      // P^T and dS^T; element e of n-tile n is key row g + 8 (e / 2),
      // query column ch * 16 + n * 8 + 2 c + e % 2
      const bool mask = (diag && ch == warp) || qt0 + ch * 16 + 15 >= t_q;
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
          if (mask) {
            const int query = qt0 + qi + (e & 1);
            const int key = key_w + g + (e >> 1) * 8;
            if (query >= t_q || (causal && key > query)) p = 0.f;
          }
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
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dos + t_row + dp * 16);
        mma_16816<T>(dv_acc[2 * dp], pa, b[0], b[1]);
        mma_16816<T>(dv_acc[2 * dp + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, qs + t_row + dp * 16);
        mma_16816<T>(dk_acc[2 * dp], da, b[0], b[1]);
        mma_16816<T>(dk_acc[2 * dp + 1], da, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: dK and dV through the warp's own rows of the K and V tiles
  // (only this warp ever read them), then 16-byte coalesced stores; keys no
  // query sees keep their zeros
  __syncwarp();
  T* sk = sK + warp * 16 * S;
  T* sv = sV + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(sk + g * S + n * 8 + 2 * c) = pack2<T>(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<uint32_t*>(sk + (g + 8) * S + n * 8 + 2 * c) =
        pack2<T>(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<uint32_t*>(sv + g * S + n * 8 + 2 * c) = pack2<T>(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(sv + (g + 8) * S + n * 8 + 2 * c) =
        pack2<T>(dv_acc[n][2], dv_acc[n][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < kChunks / 2; ++j) {  // 16 rows x kChunks chunks over 32 lanes
    const int i = lane + 32 * j;
    const int r = i / kChunks, cc = i % kChunks;
    if (key_w + r < t_k) {
      const size_t off = (static_cast<size_t>(bh) * t_k + key_w + r) * D + cc * 8;
      *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(sk + r * S + cc * 8);
      *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(sv + r * S + cc * 8);
    }
  }
}

}  // namespace mma

// ------------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, t_q, t_k, causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  if constexpr (!std::is_same_v<T, float>) {
    constexpr int smem = mma::Plan<D>::dq_bytes;
    cudaError_t err = cudaFuncSetAttribute(mma::flash_bwd_dq_mma_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.t_q + mma::kBlockQ - 1) / mma::kBlockQ);
    mma::flash_bwd_dq_mma_kernel<T, D><<<grid, mma::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.t_q, a.t_k, a.causal);
    return cudaGetLastError();
  } else {  // fp32: the CUDA-core kernel
    constexpr int smem = Smem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_fp32_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.t_q + kBlockRows - 1) / kBlockRows);
    flash_bwd_dq_fp32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), a.t_q, a.t_k, a.causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  if constexpr (!std::is_same_v<T, float>) {
    constexpr int smem = mma::Plan<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(mma::flash_bwd_dkv_mma_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.t_k + mma::kBlockK - 1) / mma::kBlockK);
    mma::flash_bwd_dkv_mma_kernel<T, D><<<grid, mma::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.t_q, a.t_k, a.causal);
    return cudaGetLastError();
  } else {  // fp32: the CUDA-core kernel
    constexpr int smem = Smem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_fp32_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.t_k + kBlockRows - 1) / kBlockRows);
    flash_bwd_dkv_fp32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.t_q, a.t_k, a.causal);
    return cudaGetLastError();
  }
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 80: return kDq ? launch_dq<T, 80>(a) : launch_dkv<T, 80>(a);
    case 96: return kDq ? launch_dq<T, 96>(a) : launch_dkv<T, 96>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(const Args& a, int d, int dtype, int device) {
  if (a.bh < 1 || a.t_q < 1 || a.t_k < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);  // this library's runtime has its own current device
  if (err != cudaSuccess) return err;
  if (dtype == 0) return dispatch_d<float, kDq>(a, d);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, kDq>(a, d);
  if (dtype == 2) return dispatch_d<__half, kDq>(a, d);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; device: the CUDA ordinal of the tensors.
// Each returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int bh, int t_q, int t_k, int d, int causal,
                                      int dtype, int device, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, t_q, t_k, causal,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, dtype, device);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t_q, int t_k, int d,
                                       int causal, int dtype, int device, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, t_q, t_k, causal,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, dtype, device);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
