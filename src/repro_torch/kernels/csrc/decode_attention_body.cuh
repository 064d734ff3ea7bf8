// Split-K flash-decode for Hopper (sm_90a): one query token per row against a dense or
// a paged KV cache, in one launch.  The body of decode_attention.cu (the bfloat16
// instances) and decode_attention_f32.cu (the float32 ones): two sources, so that nvcc
// compiles the two dtypes' 25 instances in parallel.
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
// Design:
//   * one CTA per (split, KV head x head group, row) serves up to 16 query heads of one
//     KV head (the whole group at G <= 16), so a K/V row is read once per group, not G
//     times as the TPU wrapper's `jnp.repeat` makes it.  Nothing is padded in memory
//     and the paged arena is read in its native layout;
//   * split i takes slots [lo + P i, lo + P (i + 1)) of ITS ROW'S valid range [lo, hi),
//     read from `lengths` on the card (no host read); the grid has ceil(S / P) splits per
//     row and a split past its row's range exits at once.  The wrapper's rule
//     (`split_slots` in ../decode_attention.py) picks P from S;
//   * bf16 runs on the tensor cores: the 16 heads are the 16 rows of an
//     mma.sync.m16n8k16 A tile (G 4 and 8 pad rows with zeros, never loaded).  K/V
//     64-key chunks are staged in shared memory by cp.async 16-byte copies, contiguous
//     across a warp's lanes, kStages deep.  Warp w takes keys [16 w, 16 w + 16) of
//     every chunk: their 16 x 16 scores (K through ldmatrix, 16 mma), its own online
//     (m, l) in fp32, log2 units, and PV over all D (V through ldmatrix.trans, one k16
//     step).  No warp repeats another's work and none waits for another within a
//     chunk; the 4 warps merge their (m, l, acc) once, at the end.  The weights P are
//     split into a bf16 high part and a bf16 residual, one mma each, as the tree
//     kernels do, so P keeps ~16 mantissa bits;
//   * fp32 stays SIMT (mma.sync takes no fp32; TF32 would not hold the float32
//     tolerance): 4 warps take 32-slot chunks in turn, lane j scores slot j for all the
//     CTA's heads from its own key row, then walks the chunk's V rows for PV with lane j
//     owning output dims [j PL, (j+1) PL), PL = ceil(D / 32) (at D 48 lanes 24-31 own
//     none); the warps merge in shared memory;
//   * head_dim 32, 48, 64, 128 and 256 are compiled: D / 16 k-steps of QK, taken in pairs
//     through ldmatrix.x4, the last one alone through ldmatrix.x2 when D / 16 is odd (D
//     48); D 256 keeps 32 n8 accumulator tiles a warp and runs one CTA an SM;
//   * one launch: a row whose range fits one split is normalised and written by its
//     CTA.  Otherwise every CTA writes an fp32 partial (m, l, acc) per head, and the
//     last CTA of a (row, head group) to finish combines them: it learns that it is
//     last from an atomic ticket (one int32 per (row, head group), which the wrapper
//     allocates zeroed once per device and stream, and which the last CTA resets to 0),
//     out = sum_p acc_p e^(m_p - M) / sum_p l_p e^(m_p - M);
//   * a row with no valid slot takes the range [0, S) with every score 0, so each split
//     sums V with weight 1 and the combine returns the mean over S.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;  // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // query heads per CTA in bf16: one m16 tile
constexpr int kKeys = 32;  // fp32: keys per chunk
constexpr int kWarpKeys = 16;  // bf16: keys of a chunk per warp, one k16 step of PV
constexpr int kChunk = kWarps * kWarpKeys;  // bf16: keys per staged chunk
constexpr int kStages = 3;  // bf16 staging depth: chunks in shared memory
constexpr int kVBatch = 8;  // fp32: V rows loaded together in the PV walk
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tbl;      // paged (B, nb); dense null
  const int32_t* lengths;  // (B,)
  float* part_m;           // (B, H, n_split): m in log2 units
  float* part_l;           // (B, H, n_split)
  float* part_acc;         // (B, H, n_split, D)
  int32_t* tickets;        // (B, Hkv * n_hg), 0 between calls
  void* out;               // (B, 1, H, D)
  int H, Hkv, S, block, nb, window, split_slots, n_split, n_hg;
};

// ------------------------------------------------------------ small helpers ---

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// W floats (W in {1, 2, 4, 8}, aligned to min(W, 4) floats)
template <int W>
__device__ __forceinline__ void load_floats(const float* p, float* x) {
  static_assert(W == 1 || W == 2 || W == 4 || W == 8, "vector width");
  if constexpr (W == 8) {
    load_floats<4>(p, x);
    load_floats<4>(p + 4, x + 4);
  } else if constexpr (W == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  } else if constexpr (W == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x, x[1] = u.y;
  } else {
    x[0] = *p;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x - bf16(x)) for both halves of a packed pair: the residual of the rounding
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi, uint32_t rounded) {
  const float rl = __uint_as_float(rounded << 16), rh = __uint_as_float(rounded & 0xffff0000u);
  return pack_bf16(lo - rl, hi - rh);
}

// ------------------------------------------------------------ the CTA's work ---

// What a CTA serves: heads [h0, h0 + nh) of KV head kvh in row b, slots
// [s_begin, s_end) of the row's valid range, split `split` of the n_used it reaches.
struct Cta {
  int b, kvh, h0, nh, split, n_used, s_begin, s_end;
  bool none;  // the row has no valid slot: every score is 0 (the mean of V)
};

// grid (n_split, Hkv * n_hg, B); gh heads per CTA.  False: the row's range ends before
// this split, and the CTA has nothing to write.
__device__ __forceinline__ bool cta_range(const Params& p, int gh, Cta& c) {
  const int G = p.H / p.Hkv;
  c.b = blockIdx.z;
  c.kvh = blockIdx.y / p.n_hg;
  c.h0 = c.kvh * G + (blockIdx.y % p.n_hg) * gh;
  c.nh = min(gh, c.kvh * G + G - c.h0);
  c.split = blockIdx.x;
  const int len = p.lengths[c.b];
  int lo = p.window > 0 ? max(len - p.window, 0) : 0;
  int hi = min(len, p.S);
  c.none = hi <= lo;
  if (c.none) lo = 0, hi = p.S;
  c.s_begin = lo + c.split * p.split_slots;
  if (c.s_begin >= hi) return false;
  c.s_end = min(c.s_begin + p.split_slots, hi);
  c.n_used = (hi - lo + p.split_slots - 1) / p.split_slots;
  return true;
}

// The CTA's end, shared by both bodies.  acc_s (nh, D): its unnormalised sum of p v;
// ml_s (nh, 2): m (log2 units) and l of each head.  One split: normalise and write.
// Else write the partial, take a ticket, and if this CTA is the row's last, combine
// every split of its heads.
template <typename scalar_t, int D>
__device__ void finish(const Params& p, const Cta& c, const float* acc_s, const float* ml_s) {
  __shared__ int last_s;
  const int64_t rh0 = (int64_t)c.b * p.H + c.h0;  // (row, head) of the CTA's first head
  scalar_t* out = static_cast<scalar_t*>(p.out) + rh0 * D;
  if (c.n_used == 1) {
    for (int i = threadIdx.x; i < c.nh * D; i += kThreads) store_f(out + i, acc_s[i] / fmaxf(ml_s[2 * (i / D) + 1], 1e-30f));
    return;
  }
  for (int i = threadIdx.x; i < c.nh * D; i += kThreads)
    p.part_acc[((rh0 + i / D) * p.n_split + c.split) * D + i % D] = acc_s[i];
  if (threadIdx.x < c.nh) {
    const int64_t part = (rh0 + threadIdx.x) * p.n_split + c.split;
    p.part_m[part] = ml_s[2 * threadIdx.x];
    p.part_l[part] = ml_s[2 * threadIdx.x + 1];
  }
  __threadfence();  // the partial is visible card-wide before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t* ticket = p.tickets + (int64_t)c.b * gridDim.y + blockIdx.y;
    last_s = atomicAdd(ticket, 1) == c.n_used - 1;
    if (last_s) *ticket = 0;  // every split of this call has taken its ticket: ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // out = sum_p acc_p e^(m_p - M) / sum_p l_p e^(m_p - M), merged online.  Thread i takes
  // the float4 items i, i + kThreads, ... of the (nh, D / 4) tile and reads (m, l, acc)
  // of kBatch splits of each before it merges: kItems x kBatch x 3 loads in flight a
  // thread, none waiting on another
  constexpr int D4 = D / 4, kItems = (kRows * D4 + kThreads - 1) / kThreads, kBatch = 4;
  int64_t row[kItems];  // (row, head) of the item, its first split
  bool on[kItems];
  float M[kItems], L[kItems];
  float4 a[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    on[it] = i / D4 < c.nh;
    row[it] = (rh0 + i / D4) * p.n_split;
    M[it] = kNegInf;
    L[it] = 0.f;
    a[it] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s0 = 0; s0 < c.n_used; s0 += kBatch) {
    float4 x[kBatch][kItems];
    float mm[kBatch][kItems], ll[kBatch][kItems];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const bool in = on[it] && s0 + u < c.n_used;
        const int64_t part = row[it] + s0 + u;
        const int d4 = (threadIdx.x + it * kThreads) % D4;
        x[u][it] = in ? __ldcg(reinterpret_cast<const float4*>(p.part_acc + part * D) + d4) : make_float4(0.f, 0.f, 0.f, 0.f);
        mm[u][it] = in ? __ldcg(p.part_m + part) : kNegInf;
        ll[u][it] = in ? __ldcg(p.part_l + part) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const float M_new = fmaxf(M[it], mm[u][it]);  // a used split has l >= 1: a real m
        const float old = exp2f(M[it] - M_new), wt = exp2f(mm[u][it] - M_new);
        M[it] = M_new;
        L[it] = L[it] * old + ll[u][it] * wt;
        a[it].x = a[it].x * old + x[u][it].x * wt;
        a[it].y = a[it].y * old + x[u][it].y * wt;
        a[it].z = a[it].z * old + x[u][it].z * wt;
        a[it].w = a[it].w * old + x[u][it].w * wt;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (!on[it]) continue;
    const float inv = 1.f / fmaxf(L[it], 1e-30f);
    scalar_t* o = out + 4 * (threadIdx.x + it * kThreads);  // item i is dims 4i.. of the (nh, D) tile
    store_f(o, a[it].x * inv);
    store_f(o + 1, a[it].y * inv);
    store_f(o + 2, a[it].z * inv);
    store_f(o + 3, a[it].w * inv);
  }
}

// ------------------------------------------------------- bf16: tensor cores ---

template <int D>
struct MmaShape {
  static constexpr int KS = D + 8;                         // staged row, elements (16-byte pad)
  static constexpr int kBuf = kChunk * KS;                 // elements of one staged K or V chunk
  static constexpr int kStagingBytes = kStages * 2 * kBuf * 2;
  // the epilogue: the warps' (16, D) blocks and (m, l), the merged (16, D) and (16, 2), weights
  static constexpr int kEpilogueFloats =
      kWarps * (kRows * (D + 8) + 2 * kRows) + kRows * D + 2 * kRows + kRows * kWarps;
  static_assert(kEpilogueFloats * 4 <= kStagingBytes, "the epilogue reuses the staging buffers");
  // dynamic shared memory: the staging buffers, then the table slice (paged)
  static int bytes(int split_slots, int block, bool paged) {
    return kStagingBytes + (paged ? (split_slots / block + 2) * 4 : 0);
  }
};

// two CTAs an SM, but one at D 256, whose 32 accumulator tiles a warp need the registers
template <int D, bool kPaged>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2) decode_mma_kernel(const Params p) {
  using Shape = MmaShape<D>;
  constexpr int KS = Shape::KS, kBuf = Shape::kBuf;
  constexpr int NK = D / 16;  // k-steps of QK over D
  constexpr int ND = D / 8;   // n8 tiles of PV over D
  constexpr int PPR = D / 8;  // 16-byte pieces of a K/V row
  extern __shared__ __align__(16) char smem[];
  int32_t* tbl_s = reinterpret_cast<int32_t*>(smem + Shape::kStagingBytes);
  // paged: the slice of the row's table that slots [lo, hi) cover, from block lo / block
  auto load_tbl = [&](int lo, int hi) {
    const int blk0 = lo / p.block, n_blk = (hi - 1) / p.block - blk0 + 1;
    for (int i = threadIdx.x; i < n_blk; i += kThreads)
      tbl_s[i] = __ldg(p.tbl + (int64_t)blockIdx.z * p.nb + blk0 + i);
  };
  // with no window a split's range starts at split * P whatever the row's length, so its
  // table slice loads beside `lengths`, not after it
  if constexpr (kPaged)
    if (p.window == 0) load_tbl(blockIdx.x * p.split_slots, min(p.S, (blockIdx.x + 1) * p.split_slots));
  Cta c;
  if (!cta_range(p, kRows, c)) return;
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int blk0 = kPaged ? c.s_begin / p.block : 0;
  if constexpr (kPaged) {
    if (p.window > 0) load_tbl(c.s_begin, c.s_end);
    __syncthreads();
  }
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  auto offset_of = [&](int s) -> int64_t {  // element offset of logical slot s, KV head kvh
    int64_t slot;
    if constexpr (kPaged) {
      slot = (int64_t)max(tbl_s[s / p.block - blk0], 0) * p.block + s % p.block;  // unmapped: trash block 0
    } else {
      slot = (int64_t)c.b * p.S + s;
    }
    return (slot * p.Hkv + c.kvh) * D;
  };
  const int n_chunks = (c.s_end - c.s_begin + kChunk - 1) / kChunk;
  // chunk ch (keys s_begin + 64 ch ...) into stage ch % kStages; keys at or past s_end
  // zero-filled.  Thread i copies the 16-byte pieces i, i + kThreads, ... of the chunk's
  // kChunk x PPR (PPR need not divide kThreads: 6 at D 48).
  auto stage = [&](int ch) {
    __nv_bfloat16* ks = kv_s + (ch % kStages) * 2 * kBuf;
    __nv_bfloat16* vs = ks + kBuf;
    for (int i = threadIdx.x; i < kChunk * PPR; i += kThreads) {
      const int j = i / PPR, part = i % PPR;
      const int s = c.s_begin + ch * kChunk + j;
      __nv_bfloat16* kd = ks + j * KS + part * 8;
      __nv_bfloat16* vd = vs + j * KS + part * 8;
      if (s < c.s_end) {
        const int64_t off = offset_of(s) + part * 8;
        cp_async16(kd, k + off);
        cp_async16(vd, v + off);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_chunks) stage(i);
    cp_async_commit();
  }

  // the queries as A fragments: tile rows g and g + 8 are heads h0 + g and h0 + g + 8
  // (zero past nh); loaded while the first chunks fly
  uint32_t qa[NK][4];
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + ((int64_t)c.b * p.H + c.h0) * D;
    const __nv_bfloat16* qg = g < c.nh ? q + g * D : nullptr;
    const __nv_bfloat16* qg8 = g + 8 < c.nh ? q + (g + 8) * D : nullptr;
    auto pair = [](const __nv_bfloat16* r, int d) -> uint32_t {
      return r == nullptr ? 0u : *reinterpret_cast<const uint32_t*>(r + d);
    };
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int d = 16 * kk + 2 * t;
      qa[kk][0] = pair(qg, d);
      qa[kk][1] = pair(qg8, d);
      qa[kk][2] = pair(qg, d + 8);
      qa[kk][3] = pair(qg8, d + 8);
    }
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8; l: this thread's keys
  const float scale_log2 = rsqrtf((float)D) * kLog2e;

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch is staged, and every warp is done with chunk ch - 1
    if (ch + kStages - 1 < n_chunks) stage(ch + kStages - 1);
    cp_async_commit();
    // this warp's 16 keys of the chunk: rows 16 warp ... of the staged K and V
    const __nv_bfloat16* ks = kv_s + (ch % kStages) * 2 * kBuf + kWarpKeys * warp * KS;
    const __nv_bfloat16* vs = ks + kBuf;
    const int s0 = c.s_begin + ch * kChunk + kWarpKeys * warp;
    if (s0 >= c.s_end) continue;  // the chunk's valid keys end before this warp's

    // scores: s[n][e] is key 8n + 2t + (e & 1) of the warp's 16, row g (e < 2) or g + 8
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (!c.none) {
      float s2[2][4];  // the odd k-steps: two chains of NK / 2 mma, not one of NK
#pragma unroll
      for (int n = 0; n < 2; ++n) s2[n][0] = s2[n][1] = s2[n][2] = s2[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk + 1 < NK; kk += 2) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(b0, b1, b2, b3, ks + (8 * n + (lane & 7)) * KS + 16 * kk + 8 * (lane >> 3));
          mma_bf16(s[n], qa[kk], b0, b1);
          mma_bf16(s2[n], qa[kk + 1], b2, b3);
        }
      }
      if constexpr (NK % 2) {  // D 48: the third k-step alone
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2(b0, b1, ks + (8 * n + (lane & 7)) * KS + 16 * (NK - 1) + 8 * ((lane >> 3) & 1));
          mma_bf16(s[n], qa[NK - 1], b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = s0 + 8 * n + 2 * t + (e & 1) < c.s_end;
        s[n][e] = in ? s[n][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // the quad holds a row's 16 keys; key s0 is valid
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      const float alpha = exp2f(m[hf] - m_new);  // 0 at the warp's first keys
      m[hf] = m_new;
      l[hf] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * hf] *= alpha;
        o[n][2 * hf + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
    // PV: P (16 x 16 keys) as one k16 step, a bf16 high part and a residual, over all D
    uint32_t hi[4], lo[4];
    hi[0] = pack_bf16(s[0][0], s[0][1]);
    hi[1] = pack_bf16(s[0][2], s[0][3]);
    hi[2] = pack_bf16(s[1][0], s[1][1]);
    hi[3] = pack_bf16(s[1][2], s[1][3]);
    lo[0] = pack_bf16_residual(s[0][0], s[0][1], hi[0]);
    lo[1] = pack_bf16_residual(s[0][2], s[0][3], hi[1]);
    lo[2] = pack_bf16_residual(s[1][0], s[1][1], hi[2]);
    lo[3] = pack_bf16_residual(s[1][2], s[1][3], hi[3]);
    const __nv_bfloat16* vrow = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * KS + 8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, vrow + 8 * n);
      mma_bf16(o[n], hi, b0, b1);
      mma_bf16(o[n], lo, b0, b1);
      mma_bf16(o[n + 1], hi, b2, b3);
      mma_bf16(o[n + 1], lo, b2, b3);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the staging buffers are free: they hold the epilogue's arrays

  // merge the warps' (m, l, acc): warp w's block is (16, D) acc in rows of D + 8 floats
  // (so a warp's stores of its accumulator fragments hit distinct banks), then (16, 2) (m, l)
  float* blk = reinterpret_cast<float*>(smem);
  constexpr int KB = D + 8, kBlk = kRows * KB + 2 * kRows;
  float* acc_s = blk + kWarps * kBlk;  // (16, D)
  float* ml_s = acc_s + kRows * D;     // (16, 2)
  float* wt_s = ml_s + 2 * kRows;      // (16, kWarps): each warp's weight in a row
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  float* mine = blk + warp * kBlk;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<float2*>(mine + g * KB + 8 * n + 2 * t) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * KB + 8 * n + 2 * t) = make_float2(o[n][2], o[n][3]);
  }
  if (t == 0) {
    mine[kRows * KB + 2 * g] = m[0];
    mine[kRows * KB + 2 * g + 1] = l[0];
    mine[kRows * KB + 2 * (g + 8)] = m[1];
    mine[kRows * KB + 2 * (g + 8) + 1] = l[1];
  }
  __syncthreads();
  // a warp without keys holds (-1e30, 0, 0): weight e^(-1e30 - M) = 0
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, blk[w * kBlk + kRows * KB + 2 * r]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(blk[w * kBlk + kRows * KB + 2 * r] - M);
      wt_s[r * kWarps + w] = wt;
      L = fmaf(blk[w * kBlk + kRows * KB + 2 * r + 1], wt, L);
    }
    ml_s[2 * r] = M;
    ml_s[2 * r + 1] = L;
  }
  __syncthreads();
  for (int i = 4 * threadIdx.x; i < c.nh * D; i += 4 * kThreads) {
    const float* wt = wt_s + (i / D) * kWarps;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(blk + w * kBlk + (i / D) * KB + i % D);
      a.x = fmaf(x.x, wt[w], a.x);
      a.y = fmaf(x.y, wt[w], a.y);
      a.z = fmaf(x.z, wt[w], a.z);
      a.w = fmaf(x.w, wt[w], a.w);
    }
    *reinterpret_cast<float4*>(acc_s + i) = a;
  }
  __syncthreads();
  finish<__nv_bfloat16, D>(p, c, acc_s, ml_s);
}

// ------------------------------------------------------------------ fp32: SIMT ---

// GB query heads per CTA (the first nh real)
template <int D, int GB>
__global__ void __launch_bounds__(kThreads) decode_simt_kernel(const Params p) {
  constexpr int PL = (D + 31) / 32;                      // output dims owned by one lane
  static_assert(D % PL == 0 && D % 4 == 0, "a lane owns all of its PL dims or none");
  __shared__ __align__(16) float q_s[GB][D];             // the queries; then the merged acc
  __shared__ __align__(16) float p_s[kWarps][32][GB];    // the weights
  __shared__ int64_t off_s[kWarps][32];
  __shared__ float m_s[kWarps][GB], l_s[kWarps][GB], ml_s[GB][2];

  Cta c;
  if (!cta_range(p, GB, c)) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool owns = lane * PL < D;  // false only for lanes 24-31 at D 48
  const int n_chunks = (c.s_end - c.s_begin + 31) / 32;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* q = static_cast<const float*>(p.q);

  for (int i = threadIdx.x; i < GB * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[g][d] = g < c.nh ? q[((int64_t)c.b * p.H + c.h0 + g) * D + d] : 0.f;
  }
  __syncthreads();

  const int64_t slot_stride = (int64_t)p.Hkv * D;
  // element offset of logical slot s of row b, KV head kvh
  auto offset_of = [&](int s) -> int64_t {
    if (p.tbl == nullptr) return ((int64_t)c.b * p.S + s) * slot_stride + (int64_t)c.kvh * D;
    const int blk = max(__ldg(p.tbl + (int64_t)c.b * p.nb + s / p.block), 0);
    return ((int64_t)blk * p.block + s % p.block) * slot_stride + (int64_t)c.kvh * D;
  };

  const float scale_log2 = rsqrtf((float)D) * kLog2e;
  float m[GB], l[GB], acc[GB][PL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[g][i] = 0.f;
  }

  for (int ch = warp; ch < n_chunks; ch += kWarps) {
    const int s0 = c.s_begin + ch * 32;
    const bool in = s0 + lane < c.s_end;
    const int64_t off = in ? offset_of(s0 + lane) : 0;
    float sc[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) sc[g] = in && c.none ? 0.f : kNegInf;
    if (in && !c.none) {
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] = 0.f;
      const float* kr = k + off;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float kf[4];
        load_floats<4>(kr + d, kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[g] = fmaf(q_s[g][d + e], kf[e], sc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] *= scale_log2;
    }
    off_s[warp][lane] = off;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_new = fmaxf(m[g], warp_max(sc[g]));  // lane 0 is in: a real score
      const float pr = in ? exp2f(sc[g] - m_new) : 0.f;
      const float alpha = exp2f(m[g] - m_new);  // 0 at the first chunk
      l[g] = l[g] * alpha + warp_sum(pr);
#pragma unroll
      for (int i = 0; i < PL; ++i) acc[g][i] *= alpha;
      p_s[warp][lane][g] = pr;
      m[g] = m_new;
    }
    __syncwarp();
    const int n_in = min(32, c.s_end - s0);
    for (int j0 = 0; j0 < n_in; j0 += kVBatch) {
      float vv[kVBatch][PL];
#pragma unroll
      for (int u = 0; u < kVBatch; ++u)
        if (j0 + u < n_in) {
          if (owns) {
            load_floats<PL>(v + off_s[warp][j0 + u] + lane * PL, vv[u]);
          } else {
#pragma unroll
            for (int i = 0; i < PL; ++i) vv[u][i] = 0.f;
          }
        }
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        if (j0 + u >= n_in) break;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float pj = p_s[warp][j0 + u][g];
#pragma unroll
          for (int i = 0; i < PL; ++i) acc[g][i] = fmaf(pj, vv[u][i], acc[g][i]);
        }
      }
    }
    __syncwarp();  // the next chunk overwrites p_s and off_s
  }

  // merge the warps' (m, l, acc) into q_s and ml_s
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) m_s[warp][g] = m[g], l_s[warp][g] = l[g];
  }
  __syncthreads();  // every warp is past its loop: q_s is free
  for (int i = threadIdx.x; i < GB * D; i += blockDim.x) (&q_s[0][0])[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && owns) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float M = m_s[0][g];
#pragma unroll
        for (int x = 1; x < kWarps; ++x) M = fmaxf(M, m_s[x][g]);
        const float wt = exp2f(m[g] - M);  // 0 for a warp without a chunk
#pragma unroll
        for (int i = 0; i < PL; ++i) q_s[g][lane * PL + i] += acc[g][i] * wt;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < GB) {
    const int g = threadIdx.x;
    float M = m_s[0][g];
    for (int x = 1; x < kWarps; ++x) M = fmaxf(M, m_s[x][g]);
    float L = 0.f;
    for (int x = 0; x < kWarps; ++x) L = fmaf(l_s[x][g], exp2f(m_s[x][g] - M), L);
    ml_s[g][0] = M;
    ml_s[g][1] = L;
  }
  __syncthreads();
  finish<float, D>(p, c, &q_s[0][0], &ml_s[0][0]);
}

// ------------------------------------------------------------------ launching ---

template <int D, bool kPaged>
int launch_mma(const Params& p, dim3 grid, cudaStream_t stream) {
  const int bytes = MmaShape<D>::bytes(p.split_slots, p.block, kPaged);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  // set on every launch: the attribute holds for the current device only, and costs little
  const cudaError_t e =
      cudaFuncSetAttribute(decode_mma_kernel<D, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  decode_mma_kernel<D, kPaged><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename scalar_t, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.n_split, p.Hkv * p.n_hg, B);
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    return p.tbl != nullptr ? launch_mma<D, true>(p, grid, stream) : launch_mma<D, false>(p, grid, stream);
  } else {
    const int G = p.H / p.Hkv;
    if (G <= 4)
      decode_simt_kernel<D, 4><<<grid, kThreads, 0, stream>>>(p);
    else if (G <= 8)
      decode_simt_kernel<D, 8><<<grid, kThreads, 0, stream>>>(p);
    else
      decode_simt_kernel<D, 16><<<grid, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
}


// The C entries' checks (the wrapper, ../decode_attention.py, checks everything else), the
// parameters, then the instance of head_dim D in scalar_t.  Arguments: see the C entries.
template <typename scalar_t>
int decode_launch(const void* q, const void* k, const void* v, const void* tbl, const void* lengths, void* part_m,
                  void* part_l, void* part_acc, void* tickets, void* out, int B, int H, int Hkv, int S, int block,
                  int nb, int D, int window, int split_slots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || window < 0 || split_slots <= 0 ||
      split_slots % kKeys != 0)
    return cudaErrorInvalidValue;
  const int n_split = (S + split_slots - 1) / split_slots;
  if (tbl != nullptr && (block <= 0 || nb <= 0 || S != block * nb)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(part_acc)) % 16)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v;
  p.tbl = static_cast<const int32_t*>(tbl);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.tickets = static_cast<int32_t*>(tickets);
  p.out = out;
  p.H = H, p.Hkv = Hkv, p.S = S, p.block = block, p.nb = nb, p.window = window;
  p.split_slots = split_slots, p.n_split = n_split, p.n_hg = (H / Hkv + kRows - 1) / kRows;
  switch (D) {
    case 32: return launch<scalar_t, 32>(p, B, st);
    case 48: return launch<scalar_t, 48>(p, B, st);
    case 64: return launch<scalar_t, 64>(p, B, st);
    case 128: return launch<scalar_t, 128>(p, B, st);
    case 256: return launch<scalar_t, 256>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
