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
//   * dq:  one CTA per (bh, 64 query rows); it loops over 32-key tiles from
//          the first key up to the diagonal (the row-major `_causal_pairs`).
//   * dkv: one CTA per (bh, 64 key rows); it loops over 32-query tiles from
//          the diagonal down to the last query (`_causal_pairs_colmajor`).
// Each output tile has exactly one owner, so no atomics are needed and the
// result is the same from run to run. Causal masking is top-left aligned
// (key j visible to query i when j <= i), as in the Pallas kernels. Masked
// pairs and rows past the sequence contribute exactly zero (p is set to 0,
// never computed from a masked score), so a row that saw no key, whose lse is
// -1e30, gives zero gradients rather than NaN.
//
// Layout: q, do, dq (BH, Tq, D); k, v, dk, dv (BH, Tk, D); lse, delta (BH, Tq)
// fp32. The softmax scale is folded into q by the caller. Inputs are fp32,
// bf16 or fp16; every product and sum is fp32; outputs are written in the
// input type.
//
// What bounds it on the H100: at the training shape (BH = 128, T = 1024,
// D = 96, bf16, causal) the pair recomputes S and dP in both kernels, seven
// half-triangle products in all, 7 * 2 * BH * T^2 * D / 2 ~ 90 GFLOP, against
// ~0.2 GB of inputs and outputs: operations bound (~0.09 ms on the bf16 tensor
// cores). This first version runs the products on the CUDA cores in fp32 (no
// mma/wgmma, no TMA), as the forward does, so it is bound in practice by fp32
// FMA throughput and shared-memory traffic. What the design does about it:
//   * the CTA's own 64 rows (q and dO, or k and v) are staged once in shared
//     memory as fp32 and reused against every streamed tile; scores,
//     probabilities and dS never leave the SM;
//   * a lane owns one streamed row (a key for dq, a query for dkv) for the two
//     score products, so a warp's 8 own rows reuse each streamed element read
//     8 times; streamed rows are padded by 4 floats so per-lane float4 reads
//     are free of bank conflicts;
//   * for the accumulating products a lane owns D/32 output columns, so the
//     accumulators need no cross-lane reduction; P and dS pass from the score
//     layout to the column layout through a per-warp scratch in shared memory;
//   * tiles wholly inside the causal triangle and the sequence skip the mask.
// Tensor-core MMA (wgmma) and TMA staging are the next step for speed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // 64 own rows per CTA
constexpr int kBlockCols = 32;                     // streamed rows: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

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

// Stage rows [r0, r0 + rows) of a (t, D) slice into shared memory as fp32 with
// the given row stride; rows past t are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int rows,
                                      int t, int stride) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * stride + c] = (r0 + r < t) ? to_float(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

// ------------------------------------------------------------------------ dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int t_q, int t_k,
                    int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = D / 32;  // output columns per lane
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
  const T* qb = q + static_cast<size_t>(bh) * t_q * D;
  const T* dob = dout + static_cast<size_t>(bh) * t_q * D;
  const T* kb = k + static_cast<size_t>(bh) * t_k * D;
  const T* vb = v + static_cast<size_t>(bh) * t_k * D;

  stage<T, D>(sQ, qb, q0, kBlockRows, t_q, D);
  stage<T, D>(sDO, dob, q0, kBlockRows, t_q, D);

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
    stage<T, D>(sK, kb, k0, kBlockCols, t_k, S);
    stage<T, D>(sV, vb, k0, kBlockCols, t_k, S);
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
    T* out = dq + (static_cast<size_t>(bh) * t_q + row) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) store(out + 32 * c, acc[r][c]);
  }
}

// -------------------------------------------------------------------- dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int t_q, int t_k, int causal) {
  constexpr int S = Smem<D>::kStride;
  constexpr int C = D / 32;
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
  const T* qb = q + static_cast<size_t>(bh) * t_q * D;
  const T* dob = dout + static_cast<size_t>(bh) * t_q * D;
  const float* lseb = lse + static_cast<size_t>(bh) * t_q;
  const float* deltab = delta + static_cast<size_t>(bh) * t_q;

  stage<T, D>(sK, k + static_cast<size_t>(bh) * t_k * D, k0, kBlockRows, t_k, D);
  stage<T, D>(sV, v + static_cast<size_t>(bh) * t_k * D, k0, kBlockRows, t_k, D);

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
    stage<T, D>(sQ, qb, q0, kBlockCols, t_q, S);
    stage<T, D>(sDO, dob, q0, kBlockCols, t_q, S);
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
      store(dk + o + 32 * c, acc_k[r][c]);
      store(dv + o + 32 * c, acc_v[r][c]);
    }
  }
}

// ------------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, t_q, t_k, causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_q + kBlockRows - 1) / kBlockRows);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.t_q, a.t_k, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_k + kBlockRows - 1) / kBlockRows);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t_q,
      a.t_k, a.causal);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
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
