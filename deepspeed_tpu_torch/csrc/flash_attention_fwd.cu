// Flash-attention forward (FA2 online softmax) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py
// `_fwd_tri_kernel` (causal, triangular grid) and `_fwd_kernel` (rectangular
// grid, causal or not), both launched from `_flash_forward`. One kernel covers
// both: the TPU's sequential k-block grid axis becomes a loop inside the CTA,
// and under `causal` that loop stops at the diagonal, which is what the
// triangular grid bought on the TPU.
//
// Layout: q, o (BH, Tq, D); k, v (BH, Tk, D); lse (BH, Tq) fp32 in natural
// log; inputs fp32, bf16 or fp16, o in the input type. The softmax scale is
// folded into q by the caller. Causal masking is top-left aligned (key j is
// visible to query i when j <= i), as in the Pallas kernels.
//
// Two instances, selected by the dtype code (nothing falls back at run time):
//
// bf16 / fp16: `flash_fwd_mma_kernel`, on the tensor cores. What bounds it on
// the H100: at the training shape (BH=128, T=1024, D=96, causal) 25.8 GFLOP
// against 101 MB, ~26 us of bf16 tensor-core work and ~30 us of memory
// traffic; at the serving prefill shape (BH=1024, T=128, D=64) 2.2 GFLOP
// against 67 MB, memory-bound. The design:
//   * one warpgroup (4 warps x 16 query rows) owns 64 query rows; Q is staged
//     once and held in registers as mma A-fragments (ldmatrix);
//   * S = Q K^T by mma.sync.m16n8k16 (bf16/fp16 in, fp32 accumulate), K read
//     from shared memory by ldmatrix;
//   * the online softmax runs on the accumulator fragments: a row lives in
//     the 4 lanes of a quad, so its max and sum need two shfl_xor; exp2 with
//     log2 e folded in; the per-lane partial row sums are reduced only once,
//     at the end;
//   * O += P V with P rounded to the input type, as the JAX kernel does
//     (`p.astype(v.dtype)`), and reused from registers as the A-fragment: the
//     C fragments of two 8-key n-tiles are the A fragment of one 16-key
//     k-step. V comes through ldmatrix.trans;
//   * K/V tiles of 64 keys stream through a 2-stage cp.async ring, 16 bytes a
//     thread, rows past t_k zero-filled; rows are padded by 16 bytes so
//     ldmatrix is free of bank conflicts; one __syncthreads per tile;
//   * causal: tiles above the diagonal are never loaded, only the diagonal or
//     ragged tile evaluates the mask (per warp), and the query blocks with the
//     most keys are launched first (the block index is reversed);
//   * the epilogue stages O / l through shared memory for 16-byte coalesced
//     stores.
//
// fp32: `flash_fwd_fp32_kernel`, the first design on the CUDA cores, kept
// because the fp32 checks hold the kernel to 1e-4 of an fp32 reference, which
// neither TF32 nor bf16 tensor-core products can meet. 8 warps x 8 query rows,
// a lane owns one key of a 32-key tile for Q K^T and the output columns
// lane + 32 c for P V (the upper lanes skip the last when D is 16 or 80); tiles staged element by element as fp32 in shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value (fp32 instance)

// ------------------------------------------------------- bf16 / fp16 (mma)
namespace mma {

constexpr int kBlockQ = 64;  // 4 warps x 16 query rows
constexpr int kBlockK = 64;  // keys per streamed tile
constexpr int kThreads = 128;
constexpr int kStages = 2;   // K/V ring depth

template <int D>
struct Plan {
  static constexpr int kStride = D + 8;             // padded row, in elements
  static constexpr int kTile = kBlockK * kStride;   // one 64-row tile
  // Q tile (reused for the epilogue), then the K ring and the V ring
  static constexpr int bytes = (1 + 2 * kStages) * kTile * 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int t_q, int t_k, int causal) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NO = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + Plan<D>::kTile;
  T* sV = sK + kStages * Plan<D>::kTile;

  const int bh = blockIdx.x;
  // causal: the last query blocks see the most keys, so they launch first
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;  // the lane's row in an 8-row group, its column pair
  const int row_w = q0 + warp * 16;      // the warp's first query row
  const T* qg = q + static_cast<size_t>(bh) * t_q * D;
  const T* kg = k + static_cast<size_t>(bh) * t_k * D;
  const T* vg = v + static_cast<size_t>(bh) * t_k * D;

  int last_key = t_k - 1;
  if (causal) last_key = min(last_key, min(q0 + kBlockQ, t_q) - 1);
  const int n_tiles = last_key / kBlockK + 1;

  // prologue: Q with the first K/V tile, then the rest of the ring
  load_tile_async<T, D, kBlockQ, kThreads>(sQ, qg, q0, t_q);
  load_tile_async<T, D, kBlockK, kThreads>(sK, kg, 0, t_k);
  load_tile_async<T, D, kBlockK, kThreads>(sV, vg, 0, t_k);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      load_tile_async<T, D, kBlockK, kThreads>(sK + st * Plan<D>::kTile, kg, st * kBlockK, t_k);
      load_tile_async<T, D, kBlockK, kThreads>(sV + st * Plan<D>::kTile, vg, st * kBlockK, t_k);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
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

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // ... for every thread, and tile t - 1 is consumed
    {
      const int nt = t + kStages - 1;
      if (nt < n_tiles) {
        const int st = nt % kStages;
        load_tile_async<T, D, kBlockK, kThreads>(sK + st * Plan<D>::kTile, kg, nt * kBlockK, t_k);
        load_tile_async<T, D, kBlockK, kThreads>(sV + st * Plan<D>::kTile, vg, nt * kBlockK, t_k);
      }
      cp_async_commit();
    }
    const T* ks = sK + (t % kStages) * Plan<D>::kTile;
    const T* vs = sV + (t % kStages) * Plan<D>::kTile;
    const int kt0 = t * kBlockK;

    // S = Q K^T: 8 n-tiles of 8 keys; one ldmatrix.x4 gives two n-tiles' B
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_16816<T>(s[2 * np], qf[kk], b[0], b[1]);
        mma_16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // only a tile that crosses this warp's diagonal or the end of the keys
    // evaluates the mask
    if (kt0 + kBlockK > t_k || (causal && kt0 + kBlockK - 1 > row_w)) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt0 + n * 8 + 2 * c + (e & 1);
          const int row = row_w + g + (e >> 1) * 8;
          if (key >= t_k || (causal && key > row)) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments: a row's 64 scores lie in one quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
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
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_fast(fmaf(s[n][e], kLog2e, -ml[e >> 1]));
        l[e >> 1] += s[n][e];
      }
    }

    // O += P V: P in the input type from registers; V by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 16-key k-steps
      const uint32_t pa[4] = {pack2<T>(s[2 * j][0], s[2 * j][1]),
                              pack2<T>(s[2 * j][2], s[2 * j][3]),
                              pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + dp * 16 +
                                 (lane >> 4) * 8);
        mma_16816<T>(acc[2 * dp], pa, b[0], b[1]);
        mma_16816<T>(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: O / l through the warp's own rows of the Q tile, then 16-byte
  // coalesced stores; lse = m + log l
  float inv[2], l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l_safe[i] = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe[i];
  }
  T* so = sQ + warp * 16 * S;  // only this warp ever read these rows
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * S + n * 8 + 2 * c) =
        pack2<T>(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * S + n * 8 + 2 * c) =
        pack2<T>(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < kChunks / 2; ++j) {  // 16 rows x kChunks chunks over 32 lanes
    const int i = lane + 32 * j;
    const int r = i / kChunks, ch = i % kChunks;
    if (row_w + r < t_q)
      *reinterpret_cast<uint4*>(o + (static_cast<size_t>(bh) * t_q + row_w + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(so + r * S + ch * 8);
  }
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_w + g + 8 * i;
      if (row < t_q) lse[static_cast<size_t>(bh) * t_q + row] = m[i] + logf(l_safe[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t_q, int t_k, int causal, cudaStream_t stream) {
  constexpr int smem = Plan<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t_q, t_k, causal);
  return cudaGetLastError();
}

}  // namespace mma

// --------------------------------------------------------- fp32 (CUDA cores)
namespace fp32 {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows per CTA
constexpr int kBlockK = 32;                     // one key per lane
constexpr int kThreads = kWarps * 32;

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

// Shared-memory plan, in floats. K rows carry 4 floats of padding.
template <int D>
struct Smem {
  static constexpr int kStride = D + 4;
  static constexpr int q = kBlockQ * D;
  static constexpr int k = kBlockK * kStride;
  static constexpr int v = kBlockK * D;
  static constexpr int p = kWarps * kRowsPerWarp * kBlockK;
  static constexpr int bytes = (q + k + v + p) * static_cast<int>(sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t_q, int t_k, int causal) {
  constexpr int KS = Smem<D>::kStride;
  constexpr int C = hopper::lane_cols(D);  // output columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Smem<D>::q;
  float* sV = sK + Smem<D>::k;
  float* sP = sV + Smem<D>::v;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_base = static_cast<size_t>(bh) * t_q * D;
  const size_t k_base = static_cast<size_t>(bh) * t_k * D;

  // Q tile; rows past t_q are zero and never written out.
  for (int e = threadIdx.x; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sQ[e] = (q0 + r < t_q) ? q[q_base + static_cast<size_t>(q0 + r) * D + c] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // first query row of this warp
  const float* myQ = sQ + warp * kRowsPerWarp * D;
  float* myP = sP + warp * kRowsPerWarp * kBlockK;
  int last_key = t_k - 1;
  if (causal) last_key = min(last_key, min(q0 + kBlockQ, t_q) - 1);
  const int n_tiles = last_key / kBlockK + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and the Q tile is staged)
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < t_k;
      const size_t g = k_base + static_cast<size_t>(k0 + r) * D + c;
      sK[r * KS + c] = in ? k[g] : 0.f;
      sV[r * D + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's rows; lane j owns key k0 + j.
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = sK + lane * KS;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(myQ + r * D + c);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax; only the diagonal or ragged tile evaluates the mask
    const bool full = (k0 + kBlockK <= t_k) && (!causal || k0 + kBlockK - 1 <= row0);
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = full || (key < t_k && (!causal || key <= row0 + r));
      const float sr = valid ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
      myP[r * kBlockK + lane] = p;
    }
    __syncwarp();

    // O += P V; lane owns output columns lane + 32 c.
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pr[r] = *reinterpret_cast<const float4*>(myP + r * kBlockK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = sV + (j + jj) * D + lane;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!hopper::lane_owns<D>(lane, c)) continue;
          const float vv = vr[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
            acc[r][c] = fmaf(pj, vv, acc[r][c]);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= t_q) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    float* orow = o + q_base + static_cast<size_t>(row) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (hopper::lane_owns<D>(lane, c)) orow[32 * c] = acc[r][c] / l_safe;
    if (lane == 0) lse[static_cast<size_t>(bh) * t_q + row] = m[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t_q, int t_k, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_fp32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), t_q, t_k, causal);
  return cudaGetLastError();
}

}  // namespace fp32

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int t_q, int t_k, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>)
    return fp32::launch<D>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
  else
    return mma::launch<T, D>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int t_q, int t_k, int d, int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 80: return launch_d<T, 80>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 96: return launch_d<T, 96>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; device: the CUDA ordinal of the tensors.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int t_q, int t_k, int d, int causal,
                                   int dtype, int device, void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);  // this library's runtime has its own current device
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, lse, bh, t_q, t_k, d, causal, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t_q, t_k, d, causal, s);
  if (dtype == 2) return dispatch_d<__half>(q, k, v, o, lse, bh, t_q, t_k, d, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
