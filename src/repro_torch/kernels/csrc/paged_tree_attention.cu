// Paged and ragged masked attention for the batched tree pass, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/tree_attention.py:
//   * `paged_tree_attention` (padded pass: ingest, trunk, padded target tree pass)
//   * `ragged_paged_tree_attention` (the flat node-major target tree pass)
// and computes the same functions as `paged_tree_attention_ref` and
// `ragged_tree_attention_ref` in ../ref.py, in the engine layout:
//
//   q      (R, H, D)               bf16 or f32: R = B*T rows of (B, T, H, D), or N flat nodes
//   k, v   (NBLK, block, Hkv, D)   one layer of the paged arena, as the pool stores it
//   tbl    (B, nb) int32           physical block of each logical block, -1 = unmapped
//   owner  (N,) int32 or null      ragged: pool row of each node, -1 = padding lane;
//                                  padded: null (row r / T)
//   mask   (Bm, T, S) or (N, S)    bool over the owner row's LOGICAL slots, S = nb * block
//   out    (R, H, D)               q's dtype
//
// Logical slot s of row b lives at arena lane (max(tbl[b, s / block], 0), s % block):
// unmapped entries read the trash block 0, as the oracle's gather does, and the mask
// bars them.  Query head h reads KV head h / (H / Hkv).  Nothing is transposed,
// replicated or gathered in memory.
//
//   s = q . k / sqrt(D) in fp32;  s = mask ? s : -1e30 (finite NEG_INF);
//   online max and sum over S;  out = acc / max(l, 1e-30).
//
// Bound on an H100: memory.  The work is 4*D flops per admitted (query head, key), far
// below the card's operations-per-byte line; the bytes are q, out, the mask and the
// admitted K/V rows.  On the batched main path a row's ring holds tens of written
// slots out of 1024, so almost every mask byte is False.
//
// Design (simple and right first):
//   * one warp per (query row, query head); no shared state between warps, so rows of
//     different owners (the ragged pass) sit in one block freely, and the owner is taken
//     per query row: the TPU kernel's 8-row owner-uniform Q tile does not exist here;
//   * the warp walks S in chunks of 32 slots, lane j on slot s0 + j.  A chunk where the
//     row admits no slot is skipped without touching K or V: a skipped masked key would
//     only add exp(-1e30 - m) = 0 once the row has a real score, and before that the
//     first real score resets (m, l, acc) with alpha = 0, so skipping is exact;
//   * an admitting lane reads its own key row (16-byte loads) and dots it with q, staged
//     once per warp in shared memory; the warp reduces max and sum with shuffles;
//   * PV walks only the admitted lanes of the chunk (lane j of the warp owns output dims
//     j, j+32, ...), so masked V rows are never read;
//   * a row that admits no slot at all gets the oracle's answer, the mean of V over the
//     S logical slots (trash lanes included), in a last pass; finite, never NaN;
//   * a ragged padding lane (owner -1) reads nothing and writes zeros: the engine
//     discards its output, which would otherwise attend over a live row or, over an
//     idle one, take the mean-of-V pass.
// Each query head re-reads its KV head's admitted rows (from L2 after the first head of
// the group); a block of 4 warps holds 4 consecutive heads of one row for that reuse.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // (query row, head) pairs per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// q[0..VEC) . (16 bytes of K), fp32
__device__ __forceinline__ float dot_vec(const float* q, const uint4& u, const float*) {
  float d = q[0] * __uint_as_float(u.x);
  d = fmaf(q[1], __uint_as_float(u.y), d);
  d = fmaf(q[2], __uint_as_float(u.z), d);
  return fmaf(q[3], __uint_as_float(u.w), d);
}
__device__ __forceinline__ float dot_vec(const float* q, const uint4& u, const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 value is the high half of the fp32 with the same bits
    d = fmaf(q[2 * i], __uint_as_float(w[i] << 16), d);
    d = fmaf(q[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), d);
  }
  return d;
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
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                           const scalar_t* __restrict__ v, const int32_t* __restrict__ tbl,
                           const int32_t* __restrict__ owner, const uint8_t* __restrict__ mask,
                           scalar_t* __restrict__ out, int R, int T, int H, int Hkv, int block,
                           int nb, int Bm) {
  constexpr int VEC = 16 / sizeof(scalar_t);  // elements per 16-byte load
  constexpr int PER_LANE = D / 32;            // output dims owned by one lane
  __shared__ __align__(16) float q_s[kWarps][D];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = blockIdx.x * kWarps + warp;  // (row, head), heads fastest
  if (pair >= R * H) return;                  // whole warps only; no block-wide sync below
  const int r = pair / H;
  const int h = pair % H;
  const int b = owner != nullptr ? owner[r] : r / T;
  scalar_t* o = out + ((int64_t)r * H + h) * D;
  if (b < 0) {  // ragged padding lane
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) store_f(o + lane + 32 * i, 0.f);
    return;
  }
  const int S = nb * block;
  const int kvh = h / (H / Hkv);
  const uint8_t* mrow =
      mask + (owner != nullptr ? (int64_t)r * S : ((int64_t)(Bm == 1 ? 0 : b) * T + r % T) * S);
  const int32_t* trow = tbl + (int64_t)b * nb;
  const int64_t slot_stride = (int64_t)Hkv * D;
  const scalar_t* kb = k + (int64_t)kvh * D;
  const scalar_t* vb = v + (int64_t)kvh * D;

  const scalar_t* qr = q + ((int64_t)r * H + h) * D;
  float* qs = q_s[warp];
  for (int d = lane; d < D; d += 32) qs[d] = load_f(qr + d);
  __syncwarp();

  // arena element offset of logical slot s (unmapped -> trash block 0)
  auto lane_of = [&](int s) -> int64_t {
    const int blk = max(__ldg(trow + s / block), 0);
    return ((int64_t)blk * block + s % block) * slot_stride;
  };

  const float scale = rsqrtf((float)D);
  float m = kNegInf, l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool admit = s < S && mrow[s] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, admit);
    if (bits == 0) continue;  // warp-uniform: nothing of this chunk is read

    float sc = kNegInf;
    if (admit) {
      const scalar_t* kr = kb + lane_of(s);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += VEC) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr + d);
        dot += dot_vec(qs + d, u, kr);
      }
      sc = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(sc));  // a real score: some lane admitted
    const float p = admit ? expf(sc - m_new) : 0.f;  // masked: exp(-1e30 - m_new) == 0
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= alpha;
    for (unsigned rest = bits; rest; rest &= rest - 1) {
      const int j = __ffs(rest) - 1;
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const scalar_t* vr = vb + lane_of(s0 + j) + lane;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] = fmaf(pj, load_f(vr + 32 * i), acc[i]);
    }
    m = m_new;
  }

  if (l == 0.f) {  // no admitted slot: every weight is exp(0), the mean of V over S
    for (int s = 0; s < S; ++s) {
      const scalar_t* vr = vb + lane_of(s) + lane;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] += load_f(vr + 32 * i);
    }
    l = (float)S;
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) store_f(o + lane + 32 * i, acc[i] * inv);
}

template <typename scalar_t, int D>
void launch(const void* q, const void* k, const void* v, const void* tbl, const void* owner,
            const void* mask, void* out, int R, int T, int H, int Hkv, int block, int nb, int Bm,
            cudaStream_t stream) {
  const int blocks = (R * H + kWarps - 1) / kWarps;
  paged_attention_kernel<scalar_t, D><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<const int32_t*>(tbl),
      static_cast<const int32_t*>(owner), static_cast<const uint8_t*>(mask),
      static_cast<scalar_t*>(out), R, T, H, Hkv, block, nb, Bm);
}

}  // namespace

extern "C" {

// Padded pass: owner == NULL, q/out (B*T, H, D) with R = B*T, mask (Bm, T, S).
// Ragged pass: owner (R,) (-1 = padding lane: zeros), mask (R, S), T and Bm unused.
// dtype: 0 = float32, 1 = bfloat16.  q, k, v must be 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = success); cudaErrorInvalidValue for
// a shape this file has no instance for.  The wrapper (../paged_tree_attention.py)
// checks everything else.
int paged_tree_attention_launch(const void* q, const void* k, const void* v, const void* tbl,
                                const void* owner, const void* mask, void* out, int R, int T,
                                int H, int Hkv, int block, int nb, int D, int Bm, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || block <= 0 || nb <= 0) return cudaErrorInvalidValue;
  if (owner == nullptr && (T <= 0 || R % T != 0)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 128) launch<float, 128>(q, k, v, tbl, owner, mask, out, R, T, H, Hkv, block, nb, Bm, st);
  else if (dtype == 0 && D == 64) launch<float, 64>(q, k, v, tbl, owner, mask, out, R, T, H, Hkv, block, nb, Bm, st);
  else if (dtype == 1 && D == 128) launch<__nv_bfloat16, 128>(q, k, v, tbl, owner, mask, out, R, T, H, Hkv, block, nb, Bm, st);
  else if (dtype == 1 && D == 64) launch<__nv_bfloat16, 64>(q, k, v, tbl, owner, mask, out, R, T, H, Hkv, block, nb, Bm, st);
  else return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* paged_tree_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
