// Masked flash attention for the speculative tree pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `tree_attention` in
// src/repro/kernels/tree_attention.py (body `_attn_tile_body`), and computes
// the same function as `tree_attention_ref` in ../ref.py, taking the engine
// layout directly:
//
//   q    (B, T, H, D)     bf16 or f32, contiguous
//   k, v (B, S, Hkv, D)   same dtype as q, contiguous
//   mask (Bm, T, S)       bool stored one byte per entry, Bm in {1, B}
//   out  (B, T, H, D)     q's dtype
//
//   s = q . k / sqrt(D) in fp32;  s = mask ? s : -1e30 (finite NEG_INF);
//   online max and sum over S;  out = acc / max(l, 1e-30).
//
// Query head h reads KV head h / (H / Hkv), and batch row b reads mask row
// (Bm == B ? b : 0), so neither K/V nor the mask is replicated in memory.
// A fully masked row gives the mean of V over the S slots and never NaN, as
// the TPU kernel does; unwritten ring lanes are zeros and stay finite.
//
// Bound on an H100: the kernel has to read K/V once per (batch row, KV head)
// group and does 4*D flops per (query row, key), far below the card's
// operations-per-byte line, so it is memory-bound.  At the target tree pass
// of full-width granite-8b (B=1, T=7, Hkv=8, D=128, S=1024, bf16) one layer
// reads about 4.2 MB of K/V: about 1.25 us at 3.35 TB/s.  (That reads every
// ring slot; chip_smoke.py counts only the slots the mask admits, which is
// far less on a mostly empty ring.)
//
// Design (simple and right first; the fast version is later work):
//   * one block per (tile of up to 16 query rows, query head, batch row);
//     the TPU kernel's sequential grid axis over key blocks becomes a loop
//     inside the block, so nothing carries across blocks (no split-K, no
//     atomics);
//   * the loop stages 32 keys of K and V at a time in shared memory as fp32,
//     each row padded by one float so that lane-per-key reads are free of
//     bank conflicts.  Each thread issues all of its 16-byte K/V loads for
//     a chunk at once, and the next chunk (K, V and the mask bytes) is
//     loaded into registers while the current one is scored, so the loop
//     waits about one memory latency per chunk, not one per element;
//   * one warp per query row carries (m, l, acc[D]) in registers: lane j
//     scores key j of the chunk, the warp reduces max and sum with shuffles,
//     and lane j owns output dims j, j+32, ...;
//   * the ragged query tile edge (T is not a multiple of 16) is masked by
//     idle warps that still help stage K/V; keys past S are skipped, which
//     is not the same as masked.
// Each query head re-reads its KV head's K/V (from L2 after the first head
// of the group) and the loop is serial over S, which is why this version
// sits well above the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;       // keys staged per loop step: one per lane
constexpr int kMaxRows = 16;     // query rows per block: one warp each
constexpr int kMinThreads = 256; // blocks have at least 8 warps to stage K/V
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of K or V -> fp32 in shared memory (exact for both types: a
// bf16 value is the high half of the fp32 with the same bits)
__device__ __forceinline__ void unpack(float* dst, const uint4& u, const float*) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(float* dst, const uint4& u, const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kMaxRows * 32) tree_attention_kernel(const scalar_t* __restrict__ q,
                                      const scalar_t* __restrict__ k,
                                      const scalar_t* __restrict__ v,
                                      const uint8_t* __restrict__ mask,
                                      scalar_t* __restrict__ out,
                                      int T, int H, int Hkv, int S, int Bm) {
  constexpr int DP = D + 1;                          // padded smem row
  constexpr int PER_LANE = D / 32;                   // output dims owned by one lane
  constexpr int VEC = 16 / sizeof(scalar_t);         // elements per 16-byte load
  constexpr int ROW_VECS = D / VEC;
  constexpr int CHUNK_VECS = kChunk * ROW_VECS;
  constexpr int PER_THREAD = (CHUNK_VECS + kMinThreads - 1) / kMinThreads;
  __shared__ float k_s[kChunk * DP];
  __shared__ float v_s[kChunk * DP];
  __shared__ float q_s[kMaxRows * D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kMaxRows;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int t = t0 + warp;
  const bool active = warp < kMaxRows && t < T;
  const float scale = rsqrtf((float)D);

  // stage this tile's query rows
  const int rows = min(kMaxRows, T - t0);
  for (int i = threadIdx.x; i < rows * D; i += nthreads) {
    const int r = i / D, d = i % D;
    q_s[r * D + d] = load_f(q + (((int64_t)b * T + t0 + r) * H + h) * D + d);
  }

  const uint8_t* mrow = mask + ((int64_t)(Bm == 1 ? 0 : b) * T + (active ? t : 0)) * S;
  const int64_t kv_stride = (int64_t)Hkv * D;  // between consecutive slots
  const scalar_t* kb = k + ((int64_t)b * S * Hkv + kvh) * D;
  const scalar_t* vb = v + ((int64_t)b * S * Hkv + kvh) * D;

  // registers holding the next chunk: K/V vectors and this lane's mask byte
  uint4 kr[PER_THREAD], vr[PER_THREAD];
  uint8_t mr = 0;
  auto fetch = [&](int s0) {
    const int n = min(kChunk, S - s0);
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int i = threadIdx.x + r * nthreads;
      if (i < n * ROW_VECS) {
        const int64_t off = (int64_t)(s0 + i / ROW_VECS) * kv_stride + (i % ROW_VECS) * VEC;
        kr[r] = *reinterpret_cast<const uint4*>(kb + off);
        vr[r] = *reinterpret_cast<const uint4*>(vb + off);
      }
    }
    if (active && lane < n) mr = mrow[s0 + lane];
  };

  float m = kNegInf, l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  fetch(0);
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int n = min(kChunk, S - s0);
    __syncthreads();  // previous chunk consumed (and q_s staged, first time)
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int i = threadIdx.x + r * nthreads;
      if (i < n * ROW_VECS) {
        const int j = i / ROW_VECS, d = (i % ROW_VECS) * VEC;
        unpack(k_s + j * DP + d, kr[r], k);
        unpack(v_s + j * DP + d, vr[r], v);
      }
    }
    const bool admit = mr != 0;
    __syncthreads();
    if (s0 + kChunk < S) fetch(s0 + kChunk);  // in flight while this chunk is scored
    if (!active) continue;

    // lane j scores key s0 + j
    float s = __int_as_float(0xff800000);  // -inf: keys past S take no part
    if (lane < n) {
      const float* qr = q_s + warp * D;
      const float* kr_s = k_s + lane * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr_s[d], dot);
      s = admit ? dot * scale : kNegInf;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = lane < n ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vr_s = v_s + j * DP + lane;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] = fmaf(pj, vr_s[32 * i], acc[i]);
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    scalar_t* o = out + (((int64_t)b * T + t) * H + h) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) store_f(o + lane + 32 * i, acc[i] * inv);
  }
}

template <typename scalar_t, int D>
void launch(const void* q, const void* k, const void* v, const void* mask, void* out,
            int B, int T, int H, int Hkv, int S, int Bm, cudaStream_t stream) {
  const int rows = T < kMaxRows ? T : kMaxRows;
  const int threads = rows * 32 < kMinThreads ? kMinThreads : rows * 32;
  dim3 grid((T + kMaxRows - 1) / kMaxRows, H, B);
  tree_attention_kernel<scalar_t, D><<<grid, threads, 0, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<const uint8_t*>(mask),
      static_cast<scalar_t*>(out), T, H, Hkv, S, Bm);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  k and v must be 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue for a shape this file has no instance for.  The
// wrapper (../tree_attention.py) checks everything else.
int tree_attention_launch(const void* q, const void* k, const void* v, const void* mask,
                          void* out, int B, int T, int H, int Hkv, int S, int D, int Bm,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 128) launch<float, 128>(q, k, v, mask, out, B, T, H, Hkv, S, Bm, st);
  else if (dtype == 0 && D == 64) launch<float, 64>(q, k, v, mask, out, B, T, H, Hkv, S, Bm, st);
  else if (dtype == 1 && D == 128) launch<__nv_bfloat16, 128>(q, k, v, mask, out, B, T, H, Hkv, S, Bm, st);
  else if (dtype == 1 && D == 64) launch<__nv_bfloat16, 64>(q, k, v, mask, out, B, T, H, Hkv, S, Bm, st);
  else return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* tree_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
