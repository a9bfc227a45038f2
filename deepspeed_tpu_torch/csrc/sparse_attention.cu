// Block-sparse flash attention (forward, dQ, dK/dV) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   sparse_attention_fwd     <- `_sparse_fwd_kernel` (launched by `_sparse_forward`);
//   sparse_attention_bwd_dq  <- `_sparse_bwd_dq_kernel` (`_sparse_backward`);
//   sparse_attention_bwd_dkv <- `_sparse_bwd_dkv_kernel` (`_sparse_backward`).
// A layout is an (n, n) map of `block`-sized tiles, block = T / n. The caller
// passes it as CSR lists (ops/pallas/flash_attention.py `SparsePairs`): query
// block i attends key blocks row_cols[row_ptr[i] .. row_ptr[i+1]), key block j
// is attended by query blocks col_rows[col_ptr[j] .. col_ptr[j+1]), ascending,
// pairs above the diagonal already dropped when causal.
//
// The TPU kernels walk a flat list of pairs on the sequential grid axis and
// carry their accumulators in VMEM from a run's `first` pair to its `last`.
// CUDA blocks run in no order, so here one CTA owns a slice of one output
// block and walks that block's CSR list inside the CTA, accumulators in
// registers:
//   * forward and dq: one CTA per (bh, query rows), walking row_cols;
//   * dk/dv:          one CTA per (bh, key rows), walking col_rows.
// Every output has one owner: no atomics, the same bits from run to run. A key
// block that no query attends has an empty list, so its CTA writes zeros (the
// TPU code's dummy pair); every output element is written.
//
// Tiles. A CTA owns min(block, 64) rows (8 rows per warp: 2, 4 or 8 warps for
// blocks of 16, 32 and >= 64) and streams the other side 32 rows at a time,
// one row per lane. The 32 streamed rows are the next 32 positions of the
// concatenated list: two key blocks at block 16, half a block at 64. So a
// block-16 layout keeps every lane busy, but a 16-row CTA has two warps: low
// reuse of each streamed row (16 own rows) and many small CTAs. Packing
// several layout blocks into one Hopper-sized tile is later speed work.
//
// Masking. When causal, only a tile holding the diagonal block (or the list's
// ragged end) evaluates the mask, key <= query; other tiles run mask-free, and
// nothing is masked when not causal (`_sparse_dispatch`). A masked probability
// is set to exactly 0, never computed from a masked score. The forward ends
// with l_safe = (l == 0 ? 1 : l), as the TPU kernel does.
//
// Layout of the tensors: q, k, v, o, do, dq, dk, dv (BH, T, D); lse, delta
// (BH, T) fp32, delta = rowsum(dO * O) from the caller. The softmax scale is
// folded into q by the caller. Inputs fp32, bf16 or fp16; D = 64, 96 or 128.
// Precision: every product and sum is fp32, and P and dS stay fp32 until the
// output is written in the input type. The TPU kernels round dS to k's type
// and P to do's type before the last products, so bf16 results differ from an
// fp32 reference by the output's own rounding only.
//
// What bounds it on the H100: at the training cell (BH = 64, T = 2048,
// D = 128, bf16, the fixed layout at block 16: 574,464 visible pairs per head)
// the forward does 4 D flops per visible pair (18.8 GFLOP), dq 6 D (28.2) and
// dk/dv 8 D (37.6), against 0.13-0.20 GB of inputs and outputs each: about
// 0.04-0.06 ms at the bf16 tensor-core peak or the memory rate. This first
// version runs the products on the CUDA cores in fp32 (no mma/wgmma, no TMA),
// as the dense kernels do, so it is bound in practice by fp32 FMA issue and
// shared-memory traffic. What the design does about it: own rows are staged
// once as fp32 and reused against every streamed tile; scores, P and dS never
// leave the SM; streamed rows are padded by 4 floats so per-lane float4 reads
// are free of bank conflicts; a warp's 8 own rows reuse every streamed read 8
// times. Load imbalance: in the cell's layout the global key columns are
// attended by up to 125 query blocks, most columns by about 4, so the dk/dv
// CTAs of the global columns run ~30 times longer than the rest. That is
// right and slow, and left for later (split long lists over CTAs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerWarp = 8;
constexpr int kTile = 32;        // streamed rows per tile: one per lane
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

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

// Own rows of a CTA: min(block, 64).
__host__ __device__ __forceinline__ int own_rows(int block) { return block < 64 ? block : 64; }

// Shared-memory sizes in floats. Streamed rows carry 4 floats of padding.
template <int D>
struct Smem {
  static constexpr int kStride = D + 4;
  static constexpr int streamed = kTile * kStride;
  __host__ __device__ static int own(int rows) { return rows * D; }
  __host__ __device__ static int scratch(int rows) { return rows * kTile; }  // 8 x 32 per warp
  __host__ __device__ static int fwd_bytes(int rows) {
    return (own(rows) + streamed + kTile * D + scratch(rows)) * static_cast<int>(sizeof(float));
  }
  __host__ __device__ static int dq_bytes(int rows) {
    return (2 * own(rows) + 2 * streamed + scratch(rows)) * static_cast<int>(sizeof(float));
  }
  __host__ __device__ static int dkv_bytes(int rows) {
    return (2 * own(rows) + 2 * streamed + 2 * scratch(rows)) * static_cast<int>(sizeof(float));
  }
};

// The global row indices of tile `t` of a CSR list: position p = 32 t + i of
// the concatenated blocks lies in entry p / block at offset p % block; -1 past
// the list's end. Threads 0..31 write s_idx; the caller synchronises.
__device__ __forceinline__ void stage_index(int* s_idx, const int* __restrict__ list, int start,
                                            int count, int block, int t) {
  if (threadIdx.x < kTile) {
    const int p = t * kTile + threadIdx.x;
    const int e = p / block;
    s_idx[threadIdx.x] = e < count ? list[start + e] * block + p % block : -1;
  }
}

// Rows s_idx[0..32) of a (T, D) slice into shared memory as fp32 with the
// given row stride; a row of index -1 is zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, const int* s_idx,
                                           int stride) {
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    const int g = s_idx[r];
    dst[r * stride + c] = g >= 0 ? to_float(src[static_cast<size_t>(g) * D + c]) : 0.f;
  }
}

// The CTA's own rows [r0, r0 + rows) of a (T, D) slice, unpadded.
template <typename T, int D>
__device__ __forceinline__ void stage_own(float* dst, const T* __restrict__ src, int r0, int rows) {
  const T* s = src + static_cast<size_t>(r0) * D;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) dst[e] = to_float(s[e]);
}

// ------------------------------------------------------------------ forward
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ row_ptr,
                  const int* __restrict__ row_cols, int t, int block, int causal) {
  constexpr int KS = Smem<D>::kStride;
  constexpr int C = D / 32;  // output columns per lane
  const int rows = own_rows(block);
  extern __shared__ float4 smem4[];
  __shared__ int s_idx[kTile];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Smem<D>::own(rows);
  float* sV = sK + Smem<D>::streamed;
  float* sP = sV + kTile * D;

  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * rows;  // first own (query) row
  const int qb = r0 / block;         // its layout block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int start = row_ptr[qb];
  const int count = row_ptr[qb + 1] - start;
  const int n_tiles = (count * block + kTile - 1) / kTile;

  stage_own<T, D>(sQ, q + base, r0, rows);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const int row0 = r0 + warp * kRowsPerWarp;  // first query row of this warp
  const float* myQ = sQ + warp * kRowsPerWarp * D;
  float* myP = sP + warp * kRowsPerWarp * kTile;

  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stage_index(s_idx, row_cols, start, count, block, tt);
    __syncthreads();
    stage_rows<T, D>(sK, k + base, s_idx, KS);
    stage_rows<T, D>(sV, v + base, s_idx, D);
    __syncthreads();

    // S = Q K^T for this warp's rows; lane j owns streamed key s_idx[j].
    const int key = s_idx[lane];
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

    // online softmax; only a tile holding the diagonal block or the list's
    // end evaluates the mask
    const bool full = __all_sync(0xffffffffu, key >= 0 && (!causal || key / block != qb));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (key >= 0 && (!causal || key <= row0 + r));
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
          const float vv = vr[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(lane_of(pr[r], jj), vv, acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + base + static_cast<size_t>(row) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) store(orow + 32 * c, acc[r][c] / l_safe);
    if (lane == 0) lse[static_cast<size_t>(bh) * t + row] = m[r] + logf(l_safe);
  }
}

// ----------------------------------------------------------------------- dQ
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     const int* __restrict__ row_ptr, const int* __restrict__ row_cols, int t,
                     int block, int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = D / 32;
  const int rows = own_rows(block);
  extern __shared__ float4 smem4[];
  __shared__ int s_idx[kTile];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + Smem<D>::own(rows);
  float* sK = sDO + Smem<D>::own(rows);
  float* sV = sK + Smem<D>::streamed;
  float* sDS = sV + Smem<D>::streamed;

  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int qb = r0 / block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int start = row_ptr[qb];
  const int count = row_ptr[qb + 1] - start;
  const int n_tiles = (count * block + kTile - 1) / kTile;

  stage_own<T, D>(sQ, q + base, r0, rows);
  stage_own<T, D>(sDO, dout + base, r0, rows);

  const int row0 = r0 + warp * kRowsPerWarp;
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const size_t i = static_cast<size_t>(bh) * t + row0 + r;
    lse_r[r] = lse[i];
    delta_r[r] = delta[i];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const float* myQ = sQ + warp * kRowsPerWarp * D;
  const float* myDO = sDO + warp * kRowsPerWarp * D;
  float* myDS = sDS + warp * kRowsPerWarp * kTile;

  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();
    stage_index(s_idx, row_cols, start, count, block, tt);
    __syncthreads();
    stage_rows<T, D>(sK, k + base, s_idx, S);
    stage_rows<T, D>(sV, v + base, s_idx, S);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's rows; lane j owns key s_idx[j].
    const int key = s_idx[lane];
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

    // dS = P (dP - delta)
    const bool full = __all_sync(0xffffffffu, key >= 0 && (!causal || key / block != qb));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (key >= 0 && (!causal || key <= row0 + r));
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
    T* out = dq + base + static_cast<size_t>(row0 + r) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) store(out + 32 * c, acc[r][c]);
  }
}

// ------------------------------------------------------------------- dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      const int* __restrict__ col_ptr, const int* __restrict__ col_rows, int t,
                      int block, int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = D / 32;
  const int rows = own_rows(block);
  extern __shared__ float4 smem4[];
  __shared__ int s_idx[kTile];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + Smem<D>::own(rows);
  float* sQ = sV + Smem<D>::own(rows);
  float* sDO = sQ + Smem<D>::streamed;
  float* sP = sDO + Smem<D>::streamed;
  float* sDS = sP + Smem<D>::scratch(rows);

  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * rows;  // first own (key) row
  const int kb = r0 / block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const float* lseb = lse + static_cast<size_t>(bh) * t;
  const float* deltab = delta + static_cast<size_t>(bh) * t;
  const int start = col_ptr[kb];
  const int count = col_ptr[kb + 1] - start;
  const int n_tiles = (count * block + kTile - 1) / kTile;  // 0: an unattended key block

  stage_own<T, D>(sK, k + base, r0, rows);
  stage_own<T, D>(sV, v + base, r0, rows);

  const int key0 = r0 + warp * kRowsPerWarp;  // first key row of this warp
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
    stage_index(s_idx, col_rows, start, count, block, tt);
    __syncthreads();
    stage_rows<T, D>(sQ, q + base, s_idx, S);
    stage_rows<T, D>(sDO, dout + base, s_idx, S);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's keys; lane i owns query s_idx[i].
    const int query = s_idx[lane];
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

    const bool full = __all_sync(0xffffffffu, query >= 0 && (!causal || query / block != kb));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (query >= 0 && (!causal || key0 + r <= query));
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
    const size_t off = base + static_cast<size_t>(key0 + r) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      store(dk + off + 32 * c, acc_k[r][c]);
      store(dv + off + 32 * c, acc_v[r][c]);
    }
  }
}

// ------------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  const int *ptr, *list;
  int bh, t, block, causal;
  cudaStream_t stream;
};

enum class Entry { kFwd, kDq, kDkv };

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int D>
cudaError_t launch(Entry entry, const Args& a) {
  const int rows = own_rows(a.block);
  const dim3 grid(a.bh, a.t / rows);
  const int threads = rows / kRowsPerWarp * 32;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (entry == Entry::kFwd) {
    const int smem = Smem<D>::fwd_bytes(rows);
    if ((err = prepare(sparse_fwd_kernel<T, D>, smem)) != cudaSuccess) return err;
    sparse_fwd_kernel<T, D><<<grid, threads, smem, a.stream>>>(
        q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), a.ptr, a.list, a.t,
        a.block, a.causal);
  } else if (entry == Entry::kDq) {
    const int smem = Smem<D>::dq_bytes(rows);
    if ((err = prepare(sparse_bwd_dq_kernel<T, D>, smem)) != cudaSuccess) return err;
    sparse_bwd_dq_kernel<T, D><<<grid, threads, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.ptr, a.list, a.t, a.block,
        a.causal);
  } else {
    const int smem = Smem<D>::dkv_bytes(rows);
    if ((err = prepare(sparse_bwd_dkv_kernel<T, D>, smem)) != cudaSuccess) return err;
    sparse_bwd_dkv_kernel<T, D><<<grid, threads, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.ptr,
        a.list, a.t, a.block, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Entry entry, const Args& a, int d) {
  switch (d) {
    case 64: return launch<T, 64>(entry, a);
    case 96: return launch<T, 96>(entry, a);
    case 128: return launch<T, 128>(entry, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Entry entry, const Args& a, int d, int dtype, int device) {
  const bool block_ok = a.block == 16 || a.block == 32 || a.block == 64 || a.block == 128;
  if (a.bh < 1 || a.t < 1 || !block_ok || a.t % a.block != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);  // this library's runtime has its own current device
  if (err != cudaSuccess) return err;
  if (dtype == 0) return dispatch_d<float>(entry, a, d);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(entry, a, d);
  if (dtype == 2) return dispatch_d<__half>(entry, a, d);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; device: the CUDA ordinal of the
// tensors; ptr/list: int32 CSR lists on that device. Each returns a cudaError_t
// (0 = launched).
extern "C" int sparse_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* row_ptr, const void* row_cols, int bh,
                                    int t, int block, int d, int causal, int dtype, int device,
                                    void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse_out = lse;
  a.ptr = static_cast<const int*>(row_ptr), a.list = static_cast<const int*>(row_cols);
  a.bh = bh, a.t = t, a.block = block, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Entry::kFwd, a, d, dtype, device);
}

extern "C" int sparse_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, const void* row_ptr, const void* row_cols, int bh,
                                       int t, int block, int d, int causal, int dtype, int device,
                                       void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta, a.dq = dq;
  a.ptr = static_cast<const int*>(row_ptr), a.list = static_cast<const int*>(row_cols);
  a.bh = bh, a.t = t, a.block = block, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Entry::kDq, a, d, dtype, device);
}

extern "C" int sparse_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, const void* col_ptr,
                                        const void* col_rows, int bh, int t, int block, int d,
                                        int causal, int dtype, int device, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta, a.dk = dk, a.dv = dv;
  a.ptr = static_cast<const int*>(col_ptr), a.list = static_cast<const int*>(col_rows);
  a.bh = bh, a.t = t, a.block = block, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Entry::kDkv, a, d, dtype, device);
}

extern "C" const char* sparse_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
