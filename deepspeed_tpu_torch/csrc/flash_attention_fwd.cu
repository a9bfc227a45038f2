// Flash-attention forward (FA2 online softmax) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py
// `_fwd_tri_kernel` (causal, triangular grid) and `_fwd_kernel` (rectangular
// grid, causal or not), both launched from `_flash_forward`. One kernel covers
// both: the TPU's sequential k-block grid axis becomes a loop inside the CTA,
// and under `causal` that loop stops at the diagonal, which is what the
// triangular grid bought on the TPU.
//
// Layout: q, o (BH, Tq, D); k, v (BH, Tk, D); lse (BH, Tq) fp32; inputs fp32,
// bf16 or fp16, all arithmetic fp32, o in the input type. The softmax
// scale is folded into q by the caller. Causal masking is top-left aligned
// (key j is visible to query i when j <= i), as in the Pallas kernels.
//
// What bounds it on the H100: at the serving prefill shape (B=32, T=128, H=32,
// D=64, bf16) the bytes are ~67 MB (~20 us at 3.35 TB/s) and the causal
// matmul work ~2.2 GFLOP (~2 us on the bf16 tensor cores), so the work is
// memory-bound. This first version runs the two products on the CUDA cores in
// fp32 (no mma/wgmma, no TMA), so it is bound in practice by shared-memory
// traffic and fp32 FMA issue, not by HBM. What the design does about it:
//   * each input element is read from device memory once per CTA and staged
//     in shared memory as fp32; scores and probabilities never leave the SM;
//   * a CTA owns 64 query rows (8 warps x 8 rows), so every K/V element read
//     from shared memory feeds 8 rows of FMAs; K rows are padded so the
//     per-lane float4 reads are free of bank conflicts;
//   * a lane owns one key of the 32-key tile for Q K^T and D/32 output
//     columns for P V, so the running max/sum need only warp shuffles;
//   * tiles wholly below the diagonal (and inside Tk) skip the mask; only the
//     diagonal or ragged tile pays it.
// Tensor-core MMA (wgmma) and TMA staging are the next step for speed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows per CTA
constexpr int kBlockK = 32;                     // one key per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;               // the Pallas kernels' mask value

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t_q, int t_k, int causal) {
  constexpr int KS = Smem<D>::kStride;
  constexpr int C = D / 32;  // output columns per lane
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
    sQ[e] = (q0 + r < t_q) ? to_float(q[q_base + static_cast<size_t>(q0 + r) * D + c]) : 0.f;
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
      sK[r * KS + c] = in ? to_float(k[g]) : 0.f;
      sV[r * D + c] = in ? to_float(v[g]) : 0.f;
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
    T* orow = o + q_base + static_cast<size_t>(row) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) store(orow + 32 * c, acc[r][c] / l_safe);
    if (lane == 0) lse[static_cast<size_t>(bh) * t_q + row] = m[r] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t_q, int t_k, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t_q, t_k, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int t_q, int t_k, int d, int causal, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 96: return launch<T, 96>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t_q, t_k, causal, stream);
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
