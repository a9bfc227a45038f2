// Single-token decode attention over a KV cache, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_kernel` (launched from `decode_attention`): one new query token per
// sequence attends over the cache entries valid through index `pos`, with an
// online softmax in fp32 and grouped-query heads (H % KV == 0).
//
// Layout: q, o (B, H, Dh); k, v cache (B, S, KV, Dh), the models' own cache
// layout, in fp32, bf16 or fp16; `pos` is an int32 in device memory, read by
// the kernel, so a decode loop never waits on the host for it. Query head h
// belongs to KV head h / (H / KV), as in the Pallas kernel's (B, KV, H/KV,
// Dh) grouping.
//
// What bounds it on the H100: bytes. Each step reads the valid cache prefix,
// 2 * B * (pos+1) * KV * Dh elements (16.8 MB at B=32, S=256, KV=8, Dh=64 in
// bf16, ~5 us at 3.35 TB/s), against 4 * B * H * (pos+1) * Dh operations, far
// below the tensor cores' rate. What the design does about it:
//   * one CTA per (batch row, KV head, group of up to 8 query heads): the
//     K/V rows of a KV head are read once for all the query heads that share
//     them, never repeated to H heads;
//   * the loop stops at `pos`: entries past it are neither read nor computed,
//     like the Pallas kernel's clamped block index;
//   * four warps stream 32-key tiles in turn, each with its own running
//     max/sum, and merge once at the end through shared memory; the scores
//     never leave the SM;
//   * K rows are read as 16-byte vectors (one key per lane), V rows as
//     coalesced warp-wide reads (output columns lane + 32 c per lane).
// The TPU kernel's 8-row sublane padding of the query group has no
// counterpart here. The softmax scale is applied to q in fp32 on load.
// A split over S across CTAs (flash-decoding) is the next step for long caches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;          // keys per warp iteration, one per lane
constexpr int kMaxGroup = 8;       // query heads per CTA
constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value

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

// G: query heads handled per CTA (a power of two <= kMaxGroup).
template <typename T, int DH, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ pos_ptr, T* __restrict__ o, int h, int kv, int s_len,
              float scale) {
  constexpr int C = hopper::lane_cols(DH);               // output columns per lane
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  __shared__ float sQ[G][DH];
  __shared__ float sP[kWarps][G][kTile];
  __shared__ float sM[kWarps][G];
  __shared__ float sL[kWarps][G];
  __shared__ float sAcc[kWarps][G][DH];

  const int b = blockIdx.y;
  const int rep = h / kv;                  // query heads per KV head
  const int chunks = (rep + G - 1) / G;    // CTAs per KV head
  const int kvh = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * G;
  const int ng = min(G, rep - g0);         // query heads of this CTA
  const int head0 = kvh * rep + g0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int pos = *pos_ptr;
  const int n_valid = max(0, min(pos + 1, s_len));

  for (int e = threadIdx.x; e < G * DH; e += kThreads) {
    const int g = e / DH, d = e % DH;
    sQ[g][d] = g < ng ? to_float(q[(static_cast<size_t>(b) * h + head0 + g) * DH + d]) * scale
                      : 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(kv) * DH;  // between cache positions
  const size_t base = static_cast<size_t>(b) * s_len * row_stride + static_cast<size_t>(kvh) * DH;
  const T* kb = k + base;
  const T* vb = v + base;
  const int n_tiles = (n_valid + kTile - 1) / kTile;

  for (int t = warp; t < n_tiles; t += kWarps) {
    const int j0 = t * kTile;
    const int key = j0 + lane;
    const bool valid = key < n_valid;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {  // never read past pos
      const uint4* kr = reinterpret_cast<const uint4*>(kb + static_cast<size_t>(key) * row_stride);
#pragma unroll
      for (int i = 0; i < DH / kVec; ++i) {
        const uint4 raw = kr[i];
        const T* kv_ = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float kd = to_float(kv_[e]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = fmaf(sQ[g][i * kVec + e], kd, s[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = valid ? s[g] : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float corr = expf(m[g] - m_new);
      const float p = valid ? expf(sg - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] *= corr;
      sP[warp][g][lane] = p;
    }
    __syncwarp();
    const int n_keys = min(kTile, n_valid - j0);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      const T* vr = vb + static_cast<size_t>(j0 + j) * row_stride + lane;
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vv[c] = hopper::lane_owns<DH>(lane, c) ? to_float(vr[32 * c]) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sP[warp][g][j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] = fmaf(p, vv[c], acc[g][c]);
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sM[warp][g] = m[g];
      sL[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (hopper::lane_owns<DH>(lane, c)) sAcc[warp][g][lane + 32 * c] = acc[g][c];
  __syncthreads();

  for (int e = threadIdx.x; e < ng * DH; e += kThreads) {
    const int g = e / DH, d = e % DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w][g] - mx);
      lsum += sL[w][g] * f;
      out += sAcc[w][g][d] * f;
    }
    store(o + (static_cast<size_t>(b) * h + head0 + g) * DH + d, lsum == 0.f ? 0.f : out / lsum);
  }
}

template <typename T, int DH, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* o, int b,
                   int h, int kv, int s_len, float scale, cudaStream_t stream) {
  const int chunks = (h / kv + G - 1) / G;
  const dim3 grid(kv * chunks, b);
  decode_kernel<T, DH, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<T*>(o), h, kv, s_len, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const void* pos, void* o,
                       int b, int h, int kv, int s_len, float scale, cudaStream_t stream) {
  const int rep = h / kv;
  if (rep <= 1) return launch<T, DH, 1>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
  if (rep <= 2) return launch<T, DH, 2>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
  if (rep <= 4) return launch<T, DH, 4>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
  return launch<T, DH, kMaxGroup>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* pos, void* o,
                        int b, int h, int kv, int s_len, int dh, float scale,
                        cudaStream_t stream) {
  switch (dh) {
    case 16: return dispatch_g<T, 16>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
    case 32: return dispatch_g<T, 32>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
    case 80: return dispatch_g<T, 80>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
    case 96: return dispatch_g<T, 96>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, pos, o, b, h, kv, s_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; device: the CUDA ordinal of the tensors.
// Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                void* o, int b, int h, int kv, int s_len, int dh, float scale,
                                int dtype, int device, void* stream) {
  if (b < 1 || kv < 1 || h % kv != 0 || s_len < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);  // this library's runtime has its own current device
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<float>(q, k, v, pos, o, b, h, kv, s_len, dh, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, pos, o, b, h, kv, s_len, dh, scale, s);
  if (dtype == 2) return dispatch_dh<__half>(q, k, v, pos, o, b, h, kv, s_len, dh, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
