// Split-K flash-decode for Hopper (sm_90a): one query token per row against a dense or
// a paged KV cache.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/decode_attention.py, which
// share the body `_decode_kernel`:
//   * `decode_attention` (dense cache)
//   * `paged_decode_attention` (the paged pool, K/V read through the block table)
// and computes the same functions as `decode_attention_ref` and
// `paged_decode_attention_ref` in ../ref.py, in the engine layout:
//
//   q        (B, 1, H, D)            bf16 or f32
//   k, v     (B, S, Hkv, D)          dense: each row's cache
//            (NBLK, block, Hkv, D)   paged: one layer of the arena, as the pool stores it
//   tbl      (B, nb) int32 or null   paged: physical block of each logical block, -1 =
//                                    unmapped (read as the trash block 0); S = nb * block
//   lengths  (B,) int32              slot s of row b is valid iff s < len (and, with a
//                                    window, s >= len - window); no mask tensor
//   out      (B, 1, H, D)            q's dtype
//
//   s = q . k / sqrt(D) in fp32 over the valid slots; softmax; out = sum p v.
//   A row with no valid slot (length 0) gets the mean of V over all S logical slots, as
//   the oracle's finite NEG_INF gives it: finite, never NaN.
//
// Bound on an H100: memory.  Each valid K/V row is read once per KV head and serves the
// G = H / Hkv query heads of that head: 4*D*G flops per 4*D bytes (bf16), far below the
// card's operations-per-byte line.  The least time is the valid K/V bytes over the
// memory rate.
//
// Design (simple and right first):
//   * one CTA per (split, KV head, row): it serves every query head of its KV head (up to
//     16 per CTA; more heads take more CTAs), so a K/V row is read once per group, not G
//     times as the TPU wrapper's `jnp.repeat` makes it.  Nothing is padded (the TPU kernel
//     pads the query to 8 sublanes and S to its key block) and the paged arena is read in
//     its native layout (no `_fold_paged_arena` transpose);
//   * the splits fill the card's 132 SMs and balance rows of any length: split i takes
//     slots [lo + P i, lo + P (i + 1)) of ITS ROW'S valid range [lo, hi), read from
//     `lengths` on the card (no host read).  The grid has ceil(S / P) splits per row; a
//     split past its row's range exits at once and writes nothing, so a long row gets many
//     CTAs and a short one few.  The wrapper picks P from S: S / 8 rounded up to a power of
//     two within [128, 512], so a short cache still spreads over 8 CTAs per row and a long
//     one keeps the partials few;
//   * inside a CTA, 4 warps take 32-slot chunks in turn.  Lane j of a warp scores slot
//     s0 + j for all the group's heads: it reads its key row with 16-byte loads and dots
//     it with the queries, staged once per CTA in shared memory.  The warp reduces max and
//     sum with shuffles, keeps an online (m, l, acc) per head, and walks the chunk's slots
//     for PV with lane j owning output dims [j * D/32, (j+1) * D/32), issuing the V loads
//     of 8 slots before it uses them (one memory round trip per 8 slots, not per slot);
//   * the 4 warps merge their (m, l, acc) in shared memory and the CTA writes one fp32
//     partial per (row, head); a second small kernel combines a row's partials:
//     out = sum_p acc_p e^(m_p - M) / sum_p l_p e^(m_p - M), over the splits that the
//     row's range reaches (the combine works them out from `lengths` as the splits do).
//     A warp with no chunk keeps (-1e30, 0, 0), weighed by exp(-1e30 - M) = 0: skipping
//     it is exact because warp 0 of a split that is reached always has a chunk;
//   * a row with no valid slot takes the range [0, S) with every score 0, so each partial
//     sums V with weight 1 and the combine returns the mean over S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per CTA
constexpr int kVBatch = 8;  // V rows loaded together in the PV walk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// n 32-bit words of packed values into floats
__device__ __forceinline__ void unpack(const unsigned* w, int n, float* out, const float*) {
#pragma unroll
  for (int i = 0; i < n; ++i) out[i] = __uint_as_float(w[i]);
}
__device__ __forceinline__ void unpack(const unsigned* w, int n, float* out, const __nv_bfloat16*) {
#pragma unroll
  for (int i = 0; i < n; ++i) {  // a bf16 value is the high half of the fp32 with the same bits
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// W 32-bit words (W in {1, 2, 4}, aligned) of packed values
template <int W>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  static_assert(W == 1 || W == 2 || W == 4, "vector width");
  if constexpr (W == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
}

// this row's valid slots [lo, hi); none valid: every slot, weight 1 (the mean of V)
__device__ __forceinline__ bool valid_range(int len, int S, int window, int& lo, int& hi) {
  lo = window > 0 ? max(len - window, 0) : 0;
  hi = min(len, S);
  if (hi > lo) return false;
  lo = 0;
  hi = S;
  return true;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (ceil(S / split_slots), Hkv * n_hg, B); GB query heads per CTA (the first nh real)
template <typename scalar_t, int D, int GB>
__global__ void __launch_bounds__(kWarps * 32)
    decode_split_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                        const scalar_t* __restrict__ v, const int32_t* __restrict__ tbl,
                        const int32_t* __restrict__ lengths, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc, int H, int Hkv,
                        int S, int block, int nb, int window, int split_slots) {
  constexpr int VEC = 16 / sizeof(scalar_t);             // elements per 16-byte load
  constexpr int PL = D / 32;                             // output dims owned by one lane
  constexpr int VW = PL * (int)sizeof(scalar_t) / 4;     // 32-bit words of a lane's V slice
  __shared__ __align__(16) float q_s[GB][D];             // the queries; then the merged acc
  __shared__ __align__(16) float p_s[kWarps][32][GB];
  __shared__ int64_t off_s[kWarps][32];
  __shared__ float m_s[kWarps][GB], l_s[kWarps][GB];

  const int n_split = gridDim.x;
  const int split = blockIdx.x;
  const int G = H / Hkv;
  const int n_hg = (G + GB - 1) / GB;
  const int kvh = blockIdx.y / n_hg;
  const int h0 = kvh * G + (blockIdx.y % n_hg) * GB;  // first query head of this CTA
  const int nh = min(GB, kvh * G + G - h0);          // real heads among the GB
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int lo, hi;
  const bool none = valid_range(lengths[b], S, window, lo, hi);
  const int s_begin = lo + split * split_slots;
  if (s_begin >= hi) return;  // the row's range ends before this split: nothing to write
  const int s_end = min(s_begin + split_slots, hi);
  const int n_chunks = (s_end - s_begin + 31) / 32;

  for (int i = threadIdx.x; i < GB * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[g][d] = g < nh ? load_f(q + ((int64_t)b * H + h0 + g) * D + d) : 0.f;
  }
  __syncthreads();

  const int64_t slot_stride = (int64_t)Hkv * D;
  // element offset of logical slot s of row b, KV head kvh
  auto offset_of = [&](int s) -> int64_t {
    if (tbl == nullptr) return ((int64_t)b * S + s) * slot_stride + (int64_t)kvh * D;
    const int blk = max(__ldg(tbl + (int64_t)b * nb + s / block), 0);
    return ((int64_t)blk * block + s % block) * slot_stride + (int64_t)kvh * D;
  };

  const float scale = rsqrtf((float)D);
  float m[GB], l[GB], acc[GB][PL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[g][i] = 0.f;
  }

  for (int c = warp; c < n_chunks; c += kWarps) {
    const int s0 = s_begin + c * 32;
    const bool in = s0 + lane < s_end;
    const int64_t off = in ? offset_of(s0 + lane) : 0;
    float sc[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) sc[g] = in && none ? 0.f : kNegInf;
    if (in && !none) {
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] = 0.f;
      const scalar_t* kr = k + off;
#pragma unroll
      for (int d = 0; d < D; d += VEC) {
        unsigned w[4];
        float kf[VEC];
        load_words<4>(kr + d, w);
        unpack(w, 4, kf, kr);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) sc[g] = fmaf(q_s[g][d + e], kf[e], sc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] *= scale;
    }
    off_s[warp][lane] = off;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_new = fmaxf(m[g], warp_max(sc[g]));  // lane 0 is in: a real score
      const float p = in ? expf(sc[g] - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);  // 0 at the first chunk
      l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < PL; ++i) acc[g][i] *= alpha;
      p_s[warp][lane][g] = p;
      m[g] = m_new;
    }
    __syncwarp();
    const int n_in = min(32, s_end - s0);
    for (int j0 = 0; j0 < n_in; j0 += kVBatch) {
      unsigned raw[kVBatch][VW];
#pragma unroll
      for (int u = 0; u < kVBatch; ++u)
        if (j0 + u < n_in) load_words<VW>(v + off_s[warp][j0 + u] + lane * PL, raw[u]);
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        if (j0 + u >= n_in) break;
        float vv[PL];
        unpack(raw[u], VW, vv, v);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float pj = p_s[warp][j0 + u][g];
#pragma unroll
          for (int i = 0; i < PL; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();  // the next chunk overwrites p_s and off_s
  }

  // merge the warps' (m, l, acc) into q_s, then write the split's partial
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) m_s[warp][g] = m[g], l_s[warp][g] = l[g];
  }
  __syncthreads();  // every warp is past its loop: q_s is free
  for (int i = threadIdx.x; i < GB * D; i += blockDim.x) (&q_s[0][0])[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float M = m_s[0][g];
#pragma unroll
        for (int x = 1; x < kWarps; ++x) M = fmaxf(M, m_s[x][g]);
        const float wt = expf(m[g] - M);  // 0 for a warp without a chunk
#pragma unroll
        for (int i = 0; i < PL; ++i) q_s[g][lane * PL + i] += acc[g][i] * wt;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nh * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    part_acc[(((int64_t)b * H + h0 + g) * n_split + split) * D + d] = q_s[g][d];
  }
  if (threadIdx.x < nh) {
    const int g = threadIdx.x;
    float M = m_s[0][g];
    for (int x = 1; x < kWarps; ++x) M = fmaxf(M, m_s[x][g]);
    float L = 0.f;
    for (int x = 0; x < kWarps; ++x) L = fmaf(l_s[x][g], expf(m_s[x][g] - M), L);
    const int64_t part = ((int64_t)b * H + h0 + g) * n_split + split;
    part_m[part] = M;
    part_l[part] = L;
  }
}

// grid (B * H), D threads: merge the partials of one (row, head) over the splits its
// valid range reaches (the others wrote nothing)
template <typename scalar_t>
__global__ void decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc, const int32_t* __restrict__ lengths,
                                      scalar_t* __restrict__ out, int H, int S, int window, int n_split,
                                      int split_slots, int D) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  int lo, hi;
  valid_range(lengths[row / H], S, window, lo, hi);
  const int n_used = (hi - lo + split_slots - 1) / split_slots;
  const float* pm = part_m + row * n_split;
  const float* pl = part_l + row * n_split;
  float M = kNegInf;
  for (int p = 0; p < n_used; ++p) M = fmaxf(M, pm[p]);
  float L = 0.f, a = 0.f;
  for (int p = 0; p < n_used; ++p) {
    const float w = expf(pm[p] - M);
    L = fmaf(pl[p], w, L);
    a = fmaf(part_acc[(row * n_split + p) * D + d], w, a);
  }
  store_f(out + row * D + d, a / fmaxf(L, 1e-30f));
}

template <typename scalar_t, int D, int GB>
void launch_split(const void* q, const void* k, const void* v, const void* tbl, const void* lengths,
                  float* pm, float* pl, float* pa, int B, int H, int Hkv, int S, int block, int nb,
                  int window, int n_split, int split_slots, cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid(n_split, Hkv * ((G + GB - 1) / GB), B);
  decode_split_kernel<scalar_t, D, GB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<const int32_t*>(tbl),
      static_cast<const int32_t*>(lengths), pm, pl, pa, H, Hkv, S, block, nb, window, split_slots);
}

template <typename scalar_t, int D>
void launch(const void* q, const void* k, const void* v, const void* tbl, const void* lengths,
            float* pm, float* pl, float* pa, void* out, int B, int H, int Hkv, int S, int block,
            int nb, int window, int n_split, int split_slots, cudaStream_t stream) {
  const int G = H / Hkv;
  if (G <= 4)
    launch_split<scalar_t, D, 4>(q, k, v, tbl, lengths, pm, pl, pa, B, H, Hkv, S, block, nb, window, n_split,
                                 split_slots, stream);
  else if (G <= 8)
    launch_split<scalar_t, D, 8>(q, k, v, tbl, lengths, pm, pl, pa, B, H, Hkv, S, block, nb, window, n_split,
                                 split_slots, stream);
  else
    launch_split<scalar_t, D, 16>(q, k, v, tbl, lengths, pm, pl, pa, B, H, Hkv, S, block, nb, window, n_split,
                                  split_slots, stream);
  decode_combine_kernel<scalar_t><<<B * H, D, 0, stream>>>(pm, pl, pa, static_cast<const int32_t*>(lengths),
                                                           static_cast<scalar_t*>(out), H, S, window, n_split,
                                                           split_slots, D);
}

}  // namespace

extern "C" {

// Dense: tbl == NULL, k/v (B, S, Hkv, D), block and nb unused.
// Paged: tbl (B, nb), k/v (NBLK, block, Hkv, D), S = nb * block.
// part_m, part_l (B*H*n_split,) and part_acc (B*H*n_split*D,) fp32 workspace,
// n_split = ceil(S / split_slots), split_slots a positive multiple of 32.
// dtype: 0 = float32, 1 = bfloat16.  q, k, v must be 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 = success); cudaErrorInvalidValue for
// a shape this file has no instance for.  The wrapper (../decode_attention.py) checks
// everything else.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* tbl,
                            const void* lengths, void* part_m, void* part_l, void* part_acc,
                            void* out, int B, int H, int Hkv, int S, int block, int nb, int D,
                            int window, int split_slots, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || window < 0 || split_slots <= 0 ||
      split_slots % 32 != 0)
    return cudaErrorInvalidValue;
  const int n_split = (S + split_slots - 1) / split_slots;
  if (tbl != nullptr && (block <= 0 || nb <= 0 || S != block * nb)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0 && D == 128) launch<float, 128>(q, k, v, tbl, lengths, pm, pl, pa, out, B, H, Hkv, S, block, nb, window, n_split, split_slots, st);
  else if (dtype == 0 && D == 64) launch<float, 64>(q, k, v, tbl, lengths, pm, pl, pa, out, B, H, Hkv, S, block, nb, window, n_split, split_slots, st);
  else if (dtype == 1 && D == 128) launch<__nv_bfloat16, 128>(q, k, v, tbl, lengths, pm, pl, pa, out, B, H, Hkv, S, block, nb, window, n_split, split_slots, st);
  else if (dtype == 1 && D == 64) launch<__nv_bfloat16, 64>(q, k, v, tbl, lengths, pm, pl, pa, out, B, H, Hkv, S, block, nb, window, n_split, split_slots, st);
  else return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
