// Single-token decode attention over a KV cache, split over the cache
// (flash-decoding), for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py
// `_decode_kernel` (launched from `decode_attention`): one new query token per
// sequence attends over the cache entries valid through index `pos`, with an
// online softmax in fp32 and grouped-query heads (H % KV == 0).
//
// Layout: q, o (B, H, Dh); k, v cache (B, S, KV, Dh), the models' own cache
// layout, in fp32, bf16 or fp16; `pos` is an int32 in device memory, read by
// the kernels, so a decode loop never waits on the host for it and the launch
// can be captured in a CUDA graph once and replayed at every position. Query
// head h belongs to KV head h / (H / KV), as in the Pallas kernel's (B, KV,
// H/KV, Dh) grouping.
//
// What bounds it on the H100: bytes. Each step reads the valid cache prefix,
// 2 * B * (pos+1) * KV * Dh elements (16.8 MB at B=32, S=256, KV=8, Dh=64 in
// bf16, ~5 us at 3.35 TB/s; 67 MB at B=4, S=8192), against 4 * B * H *
// (pos+1) * Dh operations, far below the tensor cores' rate. So the design
// keeps many bytes in flight on every SM:
//   * the grid covers (KV head and its group of query heads, key chunk,
//     batch row), KV heads fastest, so CTAs that run together read the
//     neighbouring heads of the same positions. The chunk length is the
//     wrapper's, chosen from the cache capacity S and never from `pos`, so
//     the grid does not depend on a value that lives on the device and one
//     launch can be captured and replayed. A CTA whose chunk starts past
//     `pos` exits at once;
//   * K/V rows are read once for all the query heads that share them;
//   * entries past `pos` are neither read nor computed (the Pallas kernel's
//     clamped block index): their shared-memory rows are zero-filled;
//   * when `pos` leaves more than one chunk, each CTA writes its chunk's
//     partial softmax state (m, l and the unnormalised output, fp32) to a
//     workspace the wrapper allocates, and the CTA that arrives last at its
//     (batch row, head group)'s semaphore merges the chunks with the same
//     rescale the warps of one CTA use, and resets the semaphore. No second
//     kernel is launched; with one active chunk the CTA writes the output.
//
// Two partial kernels, selected by the dtype code (nothing falls back at run
// time):
//
// bf16 / fp16: `decode_split_mma_kernel`, on the tensor cores. Four warps;
// 64-key tiles of K and V stream through a 2-stage cp.async ring, 16 bytes a
// thread, rows padded by 16 bytes for ldmatrix. The CTA's up to 16 query
// heads are the M rows of mma.sync.m16n8k16 (4 of 16 used at H/KV = 4; the
// kernel is bound by bytes, not by the products). Each warp takes 16 keys of
// every tile: S = Q K^T from ldmatrix fragments, the online softmax on the
// fragments, P rounded to the input type and fed from registers to O += P V
// (V by ldmatrix.trans), as the flash kernels do. The four warps' states are
// merged through shared memory at the end. Head dims 16, 32, 64, 80, 96, 128
// and 256 (GPT-J-6B: 143,616 bytes of shared memory for the Q rows and the
// two rings, 32 accumulator n-tiles a thread).
//
// fp32: `decode_split_fp32_kernel`, the first design on the CUDA cores, kept
// because the fp32 checks hold the kernel to 1e-4 of an fp32 reference, which
// neither TF32 nor bf16 products meet; it walks only its chunk, with the same
// split. Four warps stream 32-key tiles in turn, K as 16-byte vectors (one
// key per lane), V as coalesced warp-wide reads (output columns lane + 32 c).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 128;      // four warps
constexpr int kTileKeys = 64;      // the chunk length is a multiple of this
constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value (fp32 instance)

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

__device__ __forceinline__ int valid_keys(const int* pos_ptr, int s_len) {
  return max(0, min(*pos_ptr + 1, s_len));
}

// The workspace of a split launch: the partial outputs (B * H, chunks, D),
// then (m, l) per (B * H, chunk), m in natural-log units of the scaled
// score; and one semaphore per (batch row, head group), zero between
// launches.
struct Split {
  float* o;
  float* ml;
  int* sem;
  int n_chunks;
};

// A CTA's row r, merged over its warps: to the output when pos leaves a
// single active chunk, else to the workspace as the chunk's partial. m is in
// scaled-score units.
template <typename T, int D>
__device__ __forceinline__ void write_row(T* __restrict__ o, Split part, int n_act, int row,
                                          int d, float m, float l, float acc) {
  if (n_act == 1) {
    store(o + static_cast<size_t>(row) * D + d, acc / l);
    return;
  }
  const size_t at = static_cast<size_t>(row) * part.n_chunks + blockIdx.y;
  part.o[at * D + d] = acc;
  if (d == 0) {
    part.ml[2 * at] = m;
    part.ml[2 * at + 1] = l;
  }
}

// After every thread of the CTA wrote its partial rows: the CTA that
// arrives last at its (batch row, head group)'s semaphore merges the n_act
// active chunks' partials into the output,
//   o = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c,  M = max_c m_c,
// and sets the semaphore back to 0 for the next launch (the threadfence
// reduction pattern; chunks past pos never touch it). A warp merges a row:
// its lanes reduce (m, l) over the chunks, then take 32 chunks' weights at a
// time and stream those chunks' outputs, lane l owning columns l + 32 j.
template <typename T, int D>
__device__ __forceinline__ void merge_chunks(T* __restrict__ o, Split part, int n_act, int row0,
                                             int n_rows) {
  constexpr int C = hopper::lane_cols(D);
  __shared__ int last;
  const int sem = blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();  // this thread's partials are visible before the CTA counts itself
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(part.sem + sem, 1) == n_act - 1;
    if (last) part.sem[sem] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < n_rows; r += kThreads / 32) {
    const size_t at = static_cast<size_t>(row0 + r) * part.n_chunks;
    const float* ml = part.ml + 2 * at;
    const float* po = part.o + at * D;
    float mx = -INFINITY;
    for (int c = lane; c < n_act; c += 32) mx = fmaxf(mx, __ldcg(ml + 2 * c));
    mx = warp_max(mx);
    float lsum = 0.f, out[C] = {};
    for (int c0 = 0; c0 < n_act; c0 += 32) {
      const int c = c0 + lane;
      const float f = c < n_act ? expf(__ldcg(ml + 2 * c) - mx) : 0.f;
      if (c < n_act) lsum = fmaf(f, __ldcg(ml + 2 * c + 1), lsum);
      const int n = min(32, n_act - c0);
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const float fi = __shfl_sync(0xffffffffu, f, i);
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (hopper::lane_owns<D>(lane, j))
            out[j] = fmaf(fi, __ldcg(po + static_cast<size_t>(c0 + i) * D + lane + 32 * j), out[j]);
      }
    }
    lsum = warp_sum(lsum);
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (hopper::lane_owns<D>(lane, j))
        store(o + static_cast<size_t>(row0 + r) * D + lane + 32 * j, out[j] / lsum);
  }
}

// With the cache valid through no entry (pos < 0) no CTA has keys; the
// output is 0, as the Pallas kernel's finalize gives for l = 0.
template <typename T, int D>
__device__ __forceinline__ void write_empty(T* __restrict__ o, int row0, int n_rows) {
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads)
    store(o + static_cast<size_t>(row0) * D + e, 0.f);
}

// ------------------------------------------------------- bf16 / fp16 (mma)
namespace mma {

constexpr int kRows = 16;   // query heads of one CTA: the M rows of the product
constexpr int kStages = 2;  // K/V ring depth

template <int D>
struct Plan {
  static constexpr int kStride = D + 8;                   // padded row, in elements
  static constexpr int kTile = kTileKeys * kStride;       // one 64-key tile
  // the Q rows, then the K ring and the V ring; the merge reuses the rings
  static constexpr int bytes = (kRows * kStride + 2 * kStages * kTile) * 2;
  static_assert(4 * kRows * (D + 2) * 4 <= 2 * kStages * kTile * 2, "merge fits the rings");
};

// Rows [r0, r0 + ROWS) of a strided slice (row i at src + i * stride) into a
// shared tile of row stride D + 8, 16 bytes a thread by cp.async; rows at or
// past `end` are zero-filled and not read.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_async(T* dst, const T* __restrict__ src, size_t stride,
                                                int r0, int end) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool in = r0 + r < end;
    hopper::cp_async_16(dst + r * (D + 8) + ch * 8,
                        src + (in ? static_cast<size_t>(r0 + r) * stride : 0) + ch * 8, in);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos_ptr,
                        T* __restrict__ o, Split part, int h, int kv, int s_len, int chunk,
                        float scale) {
  using namespace hopper;
  constexpr int S = Plan<D>::kStride;
  constexpr int KS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NO = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * S;
  T* sV = sK + kStages * Plan<D>::kTile;

  const int rep = h / kv;
  const int groups = (rep + kRows - 1) / kRows;
  const int kvh = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * kRows;
  const int n_rows = min(kRows, rep - r0);
  const int b = blockIdx.z;
  const int row0 = b * h + kvh * rep + r0;  // the CTA's first (batch, head) row

  const int n_valid = valid_keys(pos_ptr, s_len);
  const int n_act = (n_valid + chunk - 1) / chunk;  // chunks that start at or before pos
  const int k0 = blockIdx.y * chunk;
  if (k0 >= n_valid) {  // a chunk past pos: nothing read, no partial written
    if (blockIdx.y == 0) write_empty<T, D>(o, row0, n_rows);
    return;
  }
  const int n_tiles = (min(k0 + chunk, n_valid) - k0 + kTileKeys - 1) / kTileKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const float sl = scale * kLog2e;  // raw score -> log2 units

  const size_t stride = static_cast<size_t>(kv) * D;  // between cache positions
  const T* kg = k + static_cast<size_t>(b) * s_len * stride + static_cast<size_t>(kvh) * D;
  const T* vg = v + static_cast<size_t>(b) * s_len * stride + static_cast<size_t>(kvh) * D;

  // prologue: the Q rows (zero past n_rows) with the first K/V tile, then the
  // next tiles, so that every stage of the ring is in flight
  load_rows_async<T, D, kRows>(sQ, q + static_cast<size_t>(row0) * D, D, 0, n_rows);
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) {
      load_rows_async<T, D, kTileKeys>(sK + st * Plan<D>::kTile, kg, stride,
                                       k0 + st * kTileKeys, n_valid);
      load_rows_async<T, D, kTileKeys>(sV + st * Plan<D>::kTile, vg, stride,
                                       k0 + st * kTileKeys, n_valid);
    }
    cp_async_commit();  // one group per stage, empty or not, for the wait count
  }
  cp_async_wait<kStages - 1>();  // Q and tile 0 have landed
  __syncthreads();

  uint32_t qf[KS][4];  // the query heads as A fragments, the same in every warp
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], sQ + (lane & 15) * S + kk * 16 + (lane >> 4) * 8);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw score units
  float l[2] = {0.f, 0.f};              // this lane's partial row sums

  const int b_row = ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
  const int t_row = ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      cp_async_wait<kStages - 1>();  // tile t has landed (group t; later tiles may be in flight)
      __syncthreads();               // ... for every thread
    }
    const T* ks = sK + (t % kStages) * Plan<D>::kTile + warp * 16 * S;  // this warp's 16 keys
    const T* vs = sV + (t % kStages) * Plan<D>::kTile + warp * 16 * S;
    const int key0 = k0 + t * kTileKeys + warp * 16;

    // S = Q K^T over the warp's 16 keys: two n-tiles of 8
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, ks + b_row + kk * 16);
      mma_16816<T>(s[0], qf[kk], bk[0], bk[1]);
      mma_16816<T>(s[1], qf[kk], bk[2], bk[3]);
    }
    if (key0 + 16 > n_valid) {  // only the tile that crosses pos masks
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + n * 8 + 2 * c + (e & 1) >= n_valid) s[n][e] = -INFINITY;
    }

    // online softmax on the fragments: a row's 16 scores lie in one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(m[i], fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                                   fmaxf(s[1][2 * i], s[1][2 * i + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ml = mx == -INFINITY ? 0.f : mx * sl;  // a row that saw no key yet
      const float corr = exp2_fast(m[i] * sl - ml);
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[n][e] = exp2_fast(fmaf(s[n][e], sl, -ml));
          l[i] += s[n][e];
        }
      }
    }

    // O += P V: P in the input type from registers; V by ldmatrix.trans
    const uint32_t pa[4] = {pack2<T>(s[0][0], s[0][1]), pack2<T>(s[0][2], s[0][3]),
                            pack2<T>(s[1][0], s[1][1]), pack2<T>(s[1][2], s[1][3])};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + t_row + dd * 16);
      mma_16816<T>(acc[2 * dd], pa, bv[0], bv[1]);
      mma_16816<T>(acc[2 * dd + 1], pa, bv[2], bv[3]);
    }
    if (t + kStages < n_tiles) {  // refill the stage just consumed
      __syncthreads();
      const int kt = k0 + (t + kStages) * kTileKeys;
      load_rows_async<T, D, kTileKeys>(sK + (t % kStages) * Plan<D>::kTile, kg, stride, kt,
                                       n_valid);
      load_rows_async<T, D, kTileKeys>(sV + (t % kStages) * Plan<D>::kTile, vg, stride, kt,
                                       n_valid);
    }
    cp_async_commit();  // one group per tile, empty or not, for the wait count
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free for the merge

  // merge the four warps' states through shared memory
  float* sO = reinterpret_cast<float*>(sK);  // [warp][row][D]
  float* sM = sO + 4 * kRows * D;            // [warp][row]
  float* sL = sM + 4 * kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (c == 0) {
      sM[warp * kRows + g + 8 * i] = m[i];
      sL[warp * kRows + g + 8 * i] = l[i];
    }
  }
  float* so = sO + warp * kRows * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    so[g * D + n * 8 + 2 * c] = acc[n][0];
    so[g * D + n * 8 + 2 * c + 1] = acc[n][1];
    so[(g + 8) * D + n * 8 + 2 * c] = acc[n][2];
    so[(g + 8) * D + n * 8 + 2 * c + 1] = acc[n][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = -INFINITY;  // finite: warp 0's first key is the chunk's first, <= pos
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, sM[w * kRows + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2_fast((sM[w * kRows + r] - mx) * sl);  // 0 for a warp with no key
      lsum += sL[w * kRows + r] * f;
      out += sO[(w * kRows + r) * D + d] * f;
    }
    write_row<T, D>(o, part, n_act, row0 + r, d, mx * scale, lsum, out);
  }
  if (n_act > 1) merge_chunks<T, D>(o, part, n_act, row0, n_rows);
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, const int* pos, T* o, Split part,
                   int b, int h, int kv, int s_len, int chunk, float scale, cudaStream_t stream) {
  constexpr int smem = Plan<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(decode_split_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int groups = (h / kv + kRows - 1) / kRows;
  const dim3 grid(kv * groups, part.n_chunks, b);  // a position's KV heads side by side
  decode_split_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(q, k, v, pos, o, part, h, kv,
                                                                   s_len, chunk, scale);
  return cudaGetLastError();
}

}  // namespace mma

// --------------------------------------------------------- fp32 (CUDA cores)
namespace fp32 {

constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // keys per warp iteration, one per lane
constexpr int kMaxGroup = 8;  // query heads per CTA

// G: query heads handled per CTA (a power of two <= kMaxGroup).
template <int DH, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ pos_ptr,
                         float* __restrict__ o, Split part, int h, int kv, int s_len,
                         int chunk, float scale) {
  constexpr int C = hopper::lane_cols(DH);  // output columns per lane
  constexpr int kVec = 4;                   // floats per 16-byte load
  __shared__ float sQ[G][DH];
  __shared__ float sP[kWarps][G][kTile];
  __shared__ float sM[kWarps][G];
  __shared__ float sL[kWarps][G];
  __shared__ float sAcc[kWarps][G][DH];
  // static shared memory stops at 48 KB: 45,312 B at DH = 256 with G = 8
  static_assert((G * DH + kWarps * G * (kTile + 2 + DH)) * 4 + 4 <= 48 * 1024,
                "fp32 decode tiles exceed static shared memory");

  const int b = blockIdx.z;
  const int rep = h / kv;                  // query heads per KV head
  const int groups = (rep + G - 1) / G;    // CTAs per KV head
  const int kvh = blockIdx.x / groups;
  const int g0 = (blockIdx.x % groups) * G;
  const int ng = min(G, rep - g0);         // query heads of this CTA
  const int row0 = b * h + kvh * rep + g0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int n_valid = valid_keys(pos_ptr, s_len);
  const int n_act = (n_valid + chunk - 1) / chunk;  // chunks that start at or before pos
  const int k0 = blockIdx.y * chunk;
  if (k0 >= n_valid) {  // a chunk past pos: nothing read, no partial written
    if (blockIdx.y == 0) write_empty<float, DH>(o, row0, ng);
    return;
  }
  const int k1 = min(k0 + chunk, n_valid);

  for (int e = threadIdx.x; e < G * DH; e += kThreads) {
    const int g = e / DH, d = e % DH;
    sQ[g][d] = g < ng ? q[static_cast<size_t>(row0 + g) * DH + d] * scale : 0.f;
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
  const float* kb = k + base;
  const float* vb = v + base;
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;

  for (int t = warp; t < n_tiles; t += kWarps) {
    const int j0 = k0 + t * kTile;
    const int key = j0 + lane;
    const bool valid = key < k1;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {  // never read past pos
      const float4* kr = reinterpret_cast<const float4*>(kb + static_cast<size_t>(key) * row_stride);
#pragma unroll
      for (int i = 0; i < DH / kVec; ++i) {
        const float4 raw = kr[i];
        const float kd[kVec] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < kVec; ++e)
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = fmaf(sQ[g][i * kVec + e], kd[e], s[g]);
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
    const int n_keys = min(kTile, k1 - j0);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      const float* vr = vb + static_cast<size_t>(j0 + j) * row_stride + lane;
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = hopper::lane_owns<DH>(lane, c) ? vr[32 * c] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sP[warp][g][j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] = fmaf(p, vv[c], acc[g][c]);
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states; a warp that had no tile keeps
  // m = -1e30 and gets weight exp(-1e30 - max) = 0
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
    write_row<float, DH>(o, part, n_act, row0 + g, d, mx, lsum, out);
  }
  if (n_act > 1) merge_chunks<float, DH>(o, part, n_act, row0, ng);
}

template <int DH, int G>
cudaError_t launch_g(const float* q, const float* k, const float* v, const int* pos, float* o,
                     Split part, int b, int h, int kv, int s_len, int chunk, float scale,
                     cudaStream_t stream) {
  const int groups = (h / kv + G - 1) / G;
  const dim3 grid(kv * groups, part.n_chunks, b);  // a position's KV heads side by side
  decode_split_fp32_kernel<DH, G><<<grid, kThreads, 0, stream>>>(q, k, v, pos, o, part, h, kv,
                                                                 s_len, chunk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const int* pos, float* o,
                   Split part, int b, int h, int kv, int s_len, int chunk, float scale,
                   cudaStream_t stream) {
  const int rep = h / kv;
  if (rep <= 1) return launch_g<DH, 1>(q, k, v, pos, o, part, b, h, kv, s_len, chunk, scale, stream);
  if (rep <= 2) return launch_g<DH, 2>(q, k, v, pos, o, part, b, h, kv, s_len, chunk, scale, stream);
  if (rep <= 4) return launch_g<DH, 4>(q, k, v, pos, o, part, b, h, kv, s_len, chunk, scale, stream);
  return launch_g<DH, kMaxGroup>(q, k, v, pos, o, part, b, h, kv, s_len, chunk, scale, stream);
}

}  // namespace fp32

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* pos, void* o,
                         void* work, void* sem, int b, int h, int kv, int s_len, int chunk,
                         float scale, cudaStream_t stream) {
  const int n_chunks = (s_len + chunk - 1) / chunk;
  float* ws = static_cast<float*>(work);
  const Split part{ws, ws + static_cast<size_t>(b) * h * n_chunks * D, static_cast<int*>(sem),
                   n_chunks};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* pt = static_cast<const int*>(pos);
  T* ot = static_cast<T*>(o);
  if constexpr (std::is_same<T, float>::value)
    return fp32::launch<D>(qt, kt, vt, pt, ot, part, b, h, kv, s_len, chunk, scale, stream);
  else
    return mma::launch<T, D>(qt, kt, vt, pt, ot, part, b, h, kv, s_len, chunk, scale, stream);
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* pos, void* o,
                        void* work, void* sem, int b, int h, int kv, int s_len, int dh,
                        int chunk, float scale, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_split<T, 16>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    case 32: return launch_split<T, 32>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    case 64: return launch_split<T, 64>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    case 80: return launch_split<T, 80>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    case 96: return launch_split<T, 96>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    case 128: return launch_split<T, 128>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    case 256: return launch_split<T, 256>(q, k, v, pos, o, work, sem, b, h, kv, s_len, chunk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; device: the CUDA ordinal of
// the tensors. chunk: keys per CTA, a positive multiple of 64. When the cache
// is more than one chunk: work, a float32 workspace of B * H * ceil(S /
// chunk) * (dh + 2) elements, and sem, B * KV * ceil(H / KV / 16) int32
// semaphores that are zero and that each launch leaves zero (calls that
// share them must not overlap in time); both may be null for one chunk.
// Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                void* o, void* work, void* sem, int b, int h, int kv, int s_len,
                                int dh, int chunk, float scale, int dtype, int device,
                                void* stream) {
  if (b < 1 || kv < 1 || h % kv != 0 || s_len < 1 || chunk < kTileKeys || chunk % kTileKeys)
    return cudaErrorInvalidValue;
  if (chunk < s_len && (work == nullptr || sem == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);  // this library's runtime has its own current device
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, pos, o, work, sem, b, h, kv, s_len, dh, chunk, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, pos, o, work, sem, b, h, kv, s_len, dh, chunk,
                                      scale, s);
  if (dtype == 2)
    return dispatch_dh<__half>(q, k, v, pos, o, work, sem, b, h, kv, s_len, dh, chunk, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
