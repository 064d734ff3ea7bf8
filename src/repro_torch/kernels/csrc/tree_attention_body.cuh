// The device body shared by csrc/tree_attention.cu (dense K/V) and
// csrc/paged_tree_attention.cu (the paged arena, padded and ragged passes), for
// Hopper (sm_90a).  Each source includes this header and instantiates the body with
// its way of addressing a K/V slot; build.py hashes this header with every source.
//
// What it computes (the contract of ../ref.py's tree_attention_ref,
// paged_tree_attention_ref and ragged_tree_attention_ref):
//
//   s = q . k / sqrt(D) in fp32;  s = mask ? s : -1e30 (finite NEG_INF);
//   softmax over the S slots of the row's K/V view;  out = sum p v / max(l, 1e-30).
//
// A row that admits no slot gets the mean of V over all S slots (unwritten lanes and
// unmapped blocks included), as the finite NEG_INF gives it; a ragged padding lane
// (owner -1) gets zeros and reads nothing.
//
// Bound on an H100: memory.  A K/V row serves the G = H / Hkv query heads of its KV
// head, 4*D*G flops per 4*D bytes (bf16), far below the card's operations-per-byte
// line.  The least time is the admitted K/V bytes (plus q, out and the mask) over the
// memory rate; on the engines' 1024-slot rings that is well under a microsecond, so
// the time is latency: the number of dependent memory round trips a CTA makes.
//
// Design:
//   * a CTA serves one KV head's query group: its score rows are the gh query heads of
//     that KV head (all G of them unless G > 128) times a tile of up to tq query rows of
//     ONE K/V view (dense batch row, paged pool row, or a run of ragged nodes with one
//     owner), at most 128 score rows, 16 per warp.  K/V rows are read once per group,
//     not once per head.  Grid (tile slot, KV head x head group, split);
//   * ragged tiles are cut on the card: a tile starts at every owner change and every
//     tq nodes inside a run, so an owner that recurs after a gap just starts another
//     tile.  The CTA of a node that starts no tile exits at once.  The host never
//     reads the owners;
//   * a mask pre-pass reads the tile's mask bytes for the CTA's key range once per CTA
//     (16-byte loads where the rows are aligned), packs them into one 32-bit word per
//     (query row, 32-key chunk) in shared memory and ORs them into a live-chunk bitmap.
//     Only live chunks are loaded.  Skipping a dead chunk is exact: for a row with an
//     admitted key every masked key has weight exp(-1e30 - m) = 0, and a masked key
//     inside a live chunk gets weight 0 directly (so a row's (m, l, acc) only ever
//     holds admitted keys);
//   * live chunks are staged in shared memory with cp.async 16-byte copies, two stages
//     deep.  In bf16 the warps form teams, each holding every 16-row tile of the score
//     rows (28 rows: 2 warps a team, 4 teams; 112 rows: one team of 7); a stage holds
//     4 chunks, team t takes chunks t, t + n_teams, ... of it, the teams work at once,
//     and they merge their (m, l, acc) in shared memory at the end (a team with no live
//     chunk loads no queries and merges nothing).  The paged instance reads the slice
//     of its row's block table that the key range covers into shared memory in the
//     pre-pass, so a copy's address costs no dependent global load;
//   * bf16 scores and weighs on the tensor cores: mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate), K through ldmatrix and V through ldmatrix.trans, the online (m, l)
//     in fp32 in log2 units, as FlashAttention-2 does.  The weights P are split into a
//     bf16 high part and a bf16 residual and PV takes one mma for each, so P carries
//     ~16 mantissa bits (relative error <= 2^-17 against the plain version's fp32
//     weights; one bf16 rounding alone would be up to 2^-9).  wgmma wants 64-row
//     warpgroup tiles, which 4-112 score rows do not fill;
//   * fp32 keeps a SIMT inner product under the same schedule (the score rows dealt
//     round robin to all 8 warps; lane j scores key j of the chunk for its warp's rows
//     and owns output dims j, j+32, ...): TF32 would not hold the 1e-4 float32
//     tolerance;
//   * rows that admit nothing: with one split, a last pass over all S slots adds every
//     V row with weight 1 to those rows only (their (m, l, acc) are still empty); with
//     splits, the combine kernel sees l == 0 in every split and takes the mean itself;
//   * split-K only for long caches (the wrapper's schedule: S > 4096, splits of 2048
//     slots; chosen from the shapes, never from the mask).  Each split writes fp32
//     partials (m, l, acc) and the combine kernel (one CTA per (row, head)) merges
//     them; at S <= 4096 a call is one launch;
//   * head_dim 32 and 48 (examples/serve_speculative.py's target and draft): the bf16
//     instances take D / 16 k-steps, the last one alone through ldmatrix.x2 when D / 16
//     is odd; the fp32 lanes own ceil(D / 32) output dims, those at or past D masked;
//   * head_dim 256 (RecurrentGemma's local attention) doubles every per-row buffer, so
//     its instances hold at most 64 score rows a CTA (max_rows; the wrapper's schedule
//     follows), stage 2 chunks a stage in bf16 (2 teams at most), and keep the bf16
//     queries' mma fragments in shared memory instead of 64 more registers a thread
//     (the output tile alone is 128 fp32 registers at D 256).  In fp32 the queries of
//     64 rows and two stages of K/V then fit in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // each source that includes this is its own library: nothing is shared
namespace tree_attn {

constexpr int kKeys = 32;           // keys per chunk: one mask word per query row
constexpr int kWarps = 8;           // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16;       // score rows per warp: one m16 tile
constexpr int kMaxRows = kWarps * kWarpRows;  // score rows per CTA (max_rows: fewer at D 256)
constexpr int kMaxQuery = 32;       // query rows per CTA
constexpr int kStages = 2;          // staging stages: one loads while one is used
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;          // (R, H, D)
  const void* k;          // dense (B, S, Hkv, D); paged (NBLK, block, Hkv, D)
  const void* v;
  const uint8_t* mask;    // dense/padded (Bm, T, S); ragged (R, S)
  const int32_t* tbl;     // paged (B, nb); dense null
  const int32_t* owner;   // ragged (R,); else null
  void* out;              // (R, H, D)
  float* part_ml;         // (n_split, R, H, 2): m (log2 units), l; n_split > 1 only
  float* part_acc;        // (n_split, R, H, D)
  int R, T, H, Hkv, S, D;
  int block, nb, Bm;
  int tq, gh, n_hg;       // query rows per tile, heads per CTA, head groups per KV head
  int split_slots, n_split;
  int mask_vec;           // mask rows may be read with 16-byte loads
};

// ------------------------------------------------------------ small helpers ---

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 4 mask bytes -> 4 bits (byte i != 0 -> bit i)
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  const uint32_t t = __vcmpne4(w, 0u);
  return (t & 1u) | ((t >> 7) & 2u) | ((t >> 14) & 4u) | ((t >> 21) & 8u);
}

// Score rows a CTA holds at head dim D.
__host__ __device__ constexpr int max_rows(int D) { return D > 128 ? kMaxRows / 2 : kMaxRows; }

// ------------------------------------------------------------ shared memory ---

// Byte offsets of the dynamic shared memory regions.  The host computes the same
// layout to size the launch.
struct Layout {
  int kv;      // staging slots x {K, V} x kKeys x (D + pad) elements; then the teams' merge
  int q;       // fp32: max_rows(D) x D queries; bf16 at D > 128: their mma fragments
  int p;       // fp32 only: max_rows(D) x kKeys weights
  int bits;    // kMaxQuery x n_chunk mask words
  int live;    // live-chunk bitmap words, then the live-chunk list
  int tbl;     // paged: the block-table slice of the key range
  int total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int elt, int D, int slots, int split_slots, int block,
                                              bool paged) {
  const int n_chunk = split_slots / kKeys;
  const int row = D + 16 / elt;  // each staged row padded by 16 bytes: ldmatrix and float4 reads
  Layout L;
  int at = 0;
  L.kv = at;
  const int merge = elt == 2 ? kWarps * (kWarpRows * D + 64 + kWarpRows) * 4 : 0;  // MmaWarp::kMergeFloats
  at += align16(max(slots * 2 * kKeys * row * elt, merge));
  L.q = at;
  if (elt == 4 || D > 128) at += align16(max_rows(D) * D * elt);
  L.p = at;
  if (elt == 4) at += align16(max_rows(D) * kKeys * 4);
  L.bits = at;
  at += align16(kMaxQuery * n_chunk * 4);
  L.live = at;
  at += align16((n_chunk / 32 + 1) * 4 + n_chunk * 4);
  L.tbl = at;
  if (paged) at += align16((split_slots / block + 2) * 4);
  L.total = at;
  return L;
}

// ------------------------------------------------------------ K/V addressing ---

// Element offset of logical slot s of K/V view b, KV head kvh.
template <bool kPaged>
__device__ __forceinline__ int64_t kv_offset(const Params& p, const int32_t* tbl_s, int blk0, int b, int s,
                                             int kvh) {
  int64_t slot;
  if constexpr (kPaged) {
    const int blk = tbl_s[s / p.block - blk0];
    slot = (int64_t)max(blk, 0) * p.block + s % p.block;  // unmapped: the trash block 0
  } else {
    slot = (int64_t)b * p.S + s;
  }
  return (slot * p.Hkv + kvh) * p.D;
}

// Same, reading the table from global memory (the combine kernel's mean pass).
template <bool kPaged>
__device__ __forceinline__ int64_t kv_offset_global(const Params& p, int b, int s, int kvh) {
  int64_t slot;
  if constexpr (kPaged) {
    const int blk = __ldg(p.tbl + (int64_t)b * p.nb + s / p.block);
    slot = (int64_t)max(blk, 0) * p.block + s % p.block;
  } else {
    slot = (int64_t)b * p.S + s;
  }
  return (slot * p.Hkv + kvh) * p.D;
}

__device__ __forceinline__ const uint8_t* mask_row(const Params& p, int r, int b) {
  if (p.owner != nullptr) return p.mask + (int64_t)r * p.S;
  return p.mask + ((int64_t)(p.Bm == 1 ? 0 : b) * p.T + r % p.T) * p.S;
}

// The mask word of keys [s0, s0 + 32) of a row, keys at or past hi reading 0.
__device__ __forceinline__ uint32_t mask_word(const uint8_t* row, int s0, int hi, bool vec) {
  if (vec && s0 + kKeys <= hi) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + s0);
    const uint4 c = *reinterpret_cast<const uint4*>(row + s0 + 16);
    return pack4(a.x) | (pack4(a.y) << 4) | (pack4(a.z) << 8) | (pack4(a.w) << 12) | (pack4(c.x) << 16) |
           (pack4(c.y) << 20) | (pack4(c.z) << 24) | (pack4(c.w) << 28);
  }
  uint32_t w = 0;
  for (int j = 0; j < kKeys && s0 + j < hi; ++j) w |= (uint32_t)(row[s0 + j] != 0) << j;
  return w;
}

// ------------------------------------------------ the warp engines (16 rows) ---

// What a warp needs to know of its 16 score rows.  Score row i of the CTA is query
// row r0 + i / ng, head g0 + i % ng of the KV head.
struct Rows {
  int r0, ng, nrows, h0;  // h0: first query head of the CTA (kvh * G + g0)
  int n_chunk;
  const uint32_t* bits;   // (kMaxQuery, n_chunk) mask words
  __device__ __forceinline__ bool valid(int i) const { return i < nrows; }
  __device__ __forceinline__ int qrow(int i) const { return r0 + i / ng; }
  __device__ __forceinline__ int head(int i) const { return h0 + i % ng; }
  __device__ __forceinline__ uint32_t word(int i, int c) const {
    return i < nrows ? bits[(i / ng) * n_chunk + c] : 0u;
  }
};

// bf16: mma.sync.  Thread (g = lane / 4, t = lane % 4) holds score rows g and g + 8 of
// the warp's tile in the m16n8 accumulator layout.
template <int D>
struct MmaWarp {
  static constexpr int NK = D / 16;  // k-steps over D (odd at D 48: the last one alone)
  static constexpr int ND = D / 8;   // n-tiles over D
  static constexpr int KS = D + 8;   // staged row, elements
  // the query fragments in shared memory (NK x 32 lanes x 16 bytes a tile) at D > 128
  static constexpr bool kQShared = D > 128;
  static_assert(D % 16 == 0 && ND % 2 == 0, "k-steps of 16 and pairs of n-tiles");
  static_assert(!kQShared || NK % 2 == 0, "shared query fragments are read in pairs of k-steps");
  uint32_t qa[kQShared ? 1 : NK][4];
  const uint4* qs;  // kQShared: this warp tile's fragments
  float o[ND][4];
  float m[2], l[2];  // rows g, g + 8: running max (log2 units) and this thread's partial sum
  int ra, rb;        // the two rows' indices among the CTA's score rows

  // The CTA's warps form teams: each team holds every 16-row tile of the score rows
  // (warp w takes tile w % n_tiles in team w / n_tiles) and takes its own chunk of a
  // stage; teams merge their (m, l, acc) at the end.
  static __device__ __forceinline__ int n_tiles(int nrows) { return (nrows + kWarpRows - 1) / kWarpRows; }
  static __device__ __forceinline__ int n_teams(int nrows, int max_teams) {
    return min(max_teams, kWarps / n_tiles(nrows));
  }
  static __device__ __forceinline__ int team(int warp, int nrows) { return warp / n_tiles(nrows); }
  static __device__ __forceinline__ int tile(int warp, int nrows) { return warp % n_tiles(nrows); }
  // floats of one warp's merge block: acc (16, D), then l (32 lanes x 2), then m (16)
  static constexpr int kMergeFloats = kWarpRows * D + 64 + kWarpRows;

  // q_all: the CTA's fragment region (kQShared); write: this warp writes its tile's
  // fragments there (team 0; the other teams read them after the pre-pass's sync)
  __device__ __forceinline__ void init(const Params& p, const Rows& rows, int tile, int lane, uint4* q_all,
                                       bool write) {
    const int g = lane >> 2, t = lane & 3;
    ra = tile * kWarpRows + g;
    rb = ra + 8;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    const unsigned short* qa_p = rows.valid(ra)
        ? reinterpret_cast<const unsigned short*>(q + ((int64_t)rows.qrow(ra) * p.H + rows.head(ra)) * D)
        : nullptr;
    const unsigned short* qb_p = rows.valid(rb)
        ? reinterpret_cast<const unsigned short*>(q + ((int64_t)rows.qrow(rb) * p.H + rows.head(rb)) * D)
        : nullptr;
    auto pair = [](const unsigned short* r, int d) -> uint32_t {
      return r == nullptr ? 0u : (uint32_t)r[d] | ((uint32_t)r[d + 1] << 16);
    };
    if constexpr (kQShared) {
      uint4* mine = q_all + tile * NK * 32;
      qs = mine;
      if (write)
        for (int kk = 0; kk < NK; ++kk) {
          const int d = 16 * kk + 2 * t;
          mine[kk * 32 + lane] = make_uint4(pair(qa_p, d), pair(qb_p, d), pair(qa_p, d + 8), pair(qb_p, d + 8));
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const int d = 16 * kk + 2 * t;
        qa[kk][0] = pair(qa_p, d);
        qa[kk][1] = pair(qb_p, d);
        qa[kk][2] = pair(qa_p, d + 8);
        qa[kk][3] = pair(qb_p, d + 8);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void rescale(int half, float alpha) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * half] *= alpha;
      o[n][2 * half + 1] *= alpha;
    }
  }

  // one staged chunk of 32 keys; wa, wb the two rows' mask words
  __device__ __forceinline__ void chunk(const __nv_bfloat16* ks, const __nv_bfloat16* vs, uint32_t wa, uint32_t wb,
                                        float scale_log2, int lane) {
    const int t = lane & 3;
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kQShared) {
      // a pair of k-steps' query fragments at a time, from shared memory
#pragma unroll 2
      for (int kk = 0; kk < NK; kk += 2) {
        const uint4 x = qs[kk * 32 + lane], y = qs[(kk + 1) * 32 + lane];
        const uint32_t a0[4] = {x.x, x.y, x.z, x.w}, a1[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(b0, b1, b2, b3, ks + (8 * n + (lane & 7)) * KS + 16 * kk + 8 * (lane >> 3));
          mma_bf16(s[n], a0, b0, b1);
          mma_bf16(s[n], a1, b2, b3);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int kk = 0; kk + 1 < NK; kk += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(b0, b1, b2, b3, ks + (8 * n + (lane & 7)) * KS + 16 * kk + 8 * (lane >> 3));
          mma_bf16(s[n], qa[kk], b0, b1);
          mma_bf16(s[n], qa[kk + 1], b2, b3);
        }
        if constexpr (NK % 2) {  // the last k-step alone: 16 columns, lanes 0-15 address
          uint32_t b0, b1;
          ldmatrix_x2(b0, b1, ks + (8 * n + (lane & 7)) * KS + 16 * (NK - 1) + 8 * ((lane >> 3) & 1));
          mma_bf16(s[n], qa[NK - 1], b0, b1);
        }
      }
    }
    // mask, online max and weights; key of s[n][e] is 8n + 2t + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = e < 2 ? wa : wb;
        const bool admit = (w >> (8 * n + 2 * t + (e & 1))) & 1u;
        s[n][e] = admit ? s[n][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = exp2f(m[hf] - m_new);  // 0 at a row's first admitted key; 1 while none
      m[hf] = m_new;
      l[hf] *= alpha[hf];
      rescale(hf, alpha[hf]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float pe = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m[hf]) : 0.f;  // masked: weight 0
        s[n][e] = pe;
        l[hf] += pe;
      }
    }
    // PV: P (16 x 32 keys) as two k16 steps, each as a bf16 high part and residual
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t hi[4], lo[4];
      hi[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      hi[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      hi[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      hi[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      lo[0] = pack_bf16_residual(s[2 * kk][0], s[2 * kk][1], hi[0]);
      lo[1] = pack_bf16_residual(s[2 * kk][2], s[2 * kk][3], hi[1]);
      lo[2] = pack_bf16_residual(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2]);
      lo[3] = pack_bf16_residual(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3]);
      const __nv_bfloat16* vrow = vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * KS + 8 * (lane >> 4);
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
  }

  // the sums of the thread quad: each row's l over its 32 keys' owners
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
  }

  __device__ __forceinline__ bool fully_masked(const Rows& rows) const {
    return (rows.valid(ra) && l[0] == 0.f) || (rows.valid(rb) && l[1] == 0.f);
  }

  // the mean pass: every staged V row with weight 1 into the rows that admit nothing
  __device__ __forceinline__ void mean_chunk(const __nv_bfloat16* vs, const Rows& rows, int lane) {
    const uint32_t one = 0x3f803f80u;  // two bf16 1.0
    const uint32_t pa = rows.valid(ra) && l[0] == 0.f ? one : 0u;
    const uint32_t pb = rows.valid(rb) && l[1] == 0.f ? one : 0u;
    const uint32_t a[4] = {pa, pb, pa, pb};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const __nv_bfloat16* vrow = vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * KS + 8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vrow + 8 * n);
        mma_bf16(o[n], a, b0, b1);
        mma_bf16(o[n + 1], a, b2, b3);
      }
    }
  }

  __device__ __forceinline__ void set_mean_l(const Rows& rows, float n_slots) {
    if (rows.valid(ra) && l[0] == 0.f) l[0] = n_slots;
    if (rows.valid(rb) && l[1] == 0.f) l[1] = n_slots;
  }

  // this warp's (m, l, acc) into its merge block (l not yet quad-reduced)
  __device__ __forceinline__ void merge_out(float* blk, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(blk + g * D + 8 * n + 2 * t) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(blk + (g + 8) * D + 8 * n + 2 * t) = make_float2(o[n][2], o[n][3]);
    }
    blk[kWarpRows * D + 2 * lane] = l[0];
    blk[kWarpRows * D + 2 * lane + 1] = l[1];
    if (t == 0) {
      blk[kWarpRows * D + 64 + g] = m[0];
      blk[kWarpRows * D + 64 + g + 8] = m[1];
    }
  }

  // merge another team's (m, l, acc) of the same tile into this warp's
  __device__ __forceinline__ void merge_in(const float* blk, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float a[2], b[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mo = blk[kWarpRows * D + 64 + g + 8 * hf];
      const float M = fmaxf(m[hf], mo);
      a[hf] = exp2f(m[hf] - M);  // 1 for both when neither holds a key: all terms are 0
      b[hf] = exp2f(mo - M);
      l[hf] = l[hf] * a[hf] + blk[kWarpRows * D + 2 * lane + hf] * b[hf];
      m[hf] = M;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(blk + g * D + 8 * n + 2 * t);
      const float2 y = *reinterpret_cast<const float2*>(blk + (g + 8) * D + 8 * n + 2 * t);
      o[n][0] = o[n][0] * a[0] + x.x * b[0];
      o[n][1] = o[n][1] * a[0] + x.y * b[0];
      o[n][2] = o[n][2] * a[1] + y.x * b[1];
      o[n][3] = o[n][3] * a[1] + y.y * b[1];
    }
  }

  __device__ __forceinline__ void write(const Params& p, const Rows& rows, int lane, int split) const {
    const int t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = hf ? rb : ra;
      if (!rows.valid(i)) continue;
      const int64_t row = (int64_t)rows.qrow(i) * p.H + rows.head(i);
      if (p.n_split == 1) {
        const float inv = 1.f / fmaxf(l[hf], 1e-30f);
        uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + row * D);
#pragma unroll
        for (int n = 0; n < ND; ++n) out[4 * n + t] = pack_bf16(o[n][2 * hf] * inv, o[n][2 * hf + 1] * inv);
      } else {
        const int64_t part = (int64_t)split * p.R * p.H + row;
        float2* acc = reinterpret_cast<float2*>(p.part_acc + part * D);
#pragma unroll
        for (int n = 0; n < ND; ++n) acc[4 * n + t] = make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
        if (t == 0) {
          p.part_ml[2 * part] = m[hf];
          p.part_ml[2 * part + 1] = l[hf];
        }
      }
    }
  }
};

// fp32: SIMT.  The CTA's score rows are dealt round robin to its 8 warps (row
// warp + 8 r is the warp's r-th, at most RW: 16, or 8 at D 256), so every warp computes.  Lane j scores
// key j of the chunk for the warp's rows (queries in shared memory); lane j owns
// output dims j, j + 32, ... below D (at D 48 lanes 16-31 own one dim, the rest two).
template <int D>
struct SimtWarp {
  static constexpr int PL = (D + 31) / 32;  // output dims a lane owns at most
  // lane owns dim lane + 32 i (always for i < D / 32)
  static __device__ __forceinline__ bool owns(int i, int lane) { return D % 32 == 0 || lane + 32 * i < D; }
  static constexpr int KS = D + 4;  // staged row, elements
  static constexpr int RW = max_rows(D) / kWarps;  // score rows a warp holds at most
  float acc[RW][PL];
  float m[RW], l[RW];  // running max (log2 units); this lane's partial sum
  float* q_s;          // (RW, D) this warp's queries
  float* p_s;          // (RW, 32) this warp's weights
  int warp, nr;                      // this warp's rows: warp + kWarps * r for r < nr

  // one team: every warp with rows works on every chunk (a warp without rows is in no
  // team: its team number is n_teams)
  static __device__ __forceinline__ int n_teams(int, int) { return 1; }
  static __device__ __forceinline__ int team(int warp, int nrows) { return warp < nrows ? 0 : 1; }
  static __device__ __forceinline__ int tile(int warp, int) { return warp; }
  static constexpr int kMergeFloats = 0;
  __device__ __forceinline__ int row(int r) const { return warp + kWarps * r; }

  __device__ __forceinline__ void init(const Params& p, const Rows& rows, int warp_, int lane, float* q_all,
                                       float* p_all) {
    warp = warp_;
    nr = min(RW, (rows.nrows - warp + kWarps - 1) / kWarps);
    q_s = q_all + warp * RW * D;
    p_s = p_all + warp * RW * kKeys;
    const float* q = static_cast<const float*>(p.q);
    for (int r = 0; r < nr; ++r) {
      const float* qr = q + ((int64_t)rows.qrow(row(r)) * p.H + rows.head(row(r))) * D;
      for (int d = lane; d < D; d += 32) q_s[r * D + d] = qr[d];
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) acc[r][i] = 0.f;
    }
  }

  __device__ __forceinline__ void chunk(const float* ks, const float* vs, const Rows& rows, int c,
                                        float scale_log2, int lane) {
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* kr = ks + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r >= nr) break;
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * D + d);
        s[r] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r >= nr) break;
      const bool admit = (rows.word(row(r), c) >> lane) & 1u;
      const float sr = admit ? s[r] * scale_log2 : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = exp2f(m[r] - m_new);
      const float pr = admit ? exp2f(sr - m_new) : 0.f;
      m[r] = m_new;
      l[r] = l[r] * alpha + pr;
      p_s[r * kKeys + lane] = pr;
#pragma unroll
      for (int i = 0; i < PL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < kKeys; ++j) {
      float vv[PL];
#pragma unroll
      for (int i = 0; i < PL; ++i) vv[i] = owns(i, lane) ? vs[j * KS + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r >= nr) break;
        const float pj = p_s[r * kKeys + j];
#pragma unroll
        for (int i = 0; i < PL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
    __syncwarp();  // the next chunk overwrites p_s
  }

  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int r = 0; r < RW; ++r) l[r] = warp_sum(l[r]);
  }

  __device__ __forceinline__ bool fully_masked(const Rows&) const {
    bool any = false;
#pragma unroll
    for (int r = 0; r < RW; ++r) any |= r < nr && l[r] == 0.f;
    return any;
  }

  __device__ __forceinline__ void mean_chunk(const float* vs, const Rows&, int lane) {
    for (int j = 0; j < kKeys; ++j) {
      float vv[PL];
#pragma unroll
      for (int i = 0; i < PL; ++i) vv[i] = owns(i, lane) ? vs[j * KS + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r >= nr) break;
        if (l[r] != 0.f) continue;
#pragma unroll
        for (int i = 0; i < PL; ++i) acc[r][i] += vv[i];
      }
    }
  }

  __device__ __forceinline__ void set_mean_l(const Rows&, float n_slots) {
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (r < nr && l[r] == 0.f) l[r] = n_slots;
  }

  __device__ __forceinline__ void merge_out(float*, int) const {}
  __device__ __forceinline__ void merge_in(const float*, int) {}

  __device__ __forceinline__ void write(const Params& p, const Rows& rows, int lane, int split) const {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r >= nr) break;
      const int64_t row_hd = (int64_t)rows.qrow(row(r)) * p.H + rows.head(row(r));
      if (p.n_split == 1) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float* out = static_cast<float*>(p.out) + row_hd * D;
#pragma unroll
        for (int k = 0; k < PL; ++k)
          if (owns(k, lane)) out[lane + 32 * k] = acc[r][k] * inv;
      } else {
        const int64_t part = (int64_t)split * p.R * p.H + row_hd;
#pragma unroll
        for (int k = 0; k < PL; ++k)
          if (owns(k, lane)) p.part_acc[part * D + lane + 32 * k] = acc[r][k];
        if (lane == 0) {
          p.part_ml[2 * part] = m[r];
          p.part_ml[2 * part + 1] = l[r];
        }
      }
    }
  }
};

// ------------------------------------------------------------------ the CTA ---

template <typename scalar_t, int D>
struct Traits;
template <int D>
struct Traits<__nv_bfloat16, D> {
  using Warp = MmaWarp<D>;
  static constexpr int kChunks = D > 128 ? 2 : 4;  // chunks per stage, dealt to up to kChunks warp teams
};
template <int D>
struct Traits<float, D> {
  using Warp = SimtWarp<D>;
  static constexpr int kChunks = 1;
};

// Copy chunk c (keys lo + 32c ...) of K (when with_k) and V into one staging slot;
// keys at or past hi are zero-filled.
template <typename scalar_t, int D, bool kPaged>
__device__ __forceinline__ void stage(const Params& p, scalar_t* kb, scalar_t* vb, int c, int lo, int hi, int b,
                                      int kvh, const int32_t* tbl_s, int blk0, bool with_k) {
  constexpr int VEC = 16 / sizeof(scalar_t);
  constexpr int PPR = D / VEC;  // 16-byte pieces per row
  constexpr int KS = D + VEC;
  const scalar_t* k = static_cast<const scalar_t*>(p.k);
  const scalar_t* v = static_cast<const scalar_t*>(p.v);
  for (int idx = threadIdx.x; idx < kKeys * PPR; idx += kThreads) {
    const int j = idx / PPR, part = idx % PPR;
    const int s = lo + kKeys * c + j;
    scalar_t* kd = kb + j * KS + part * VEC;
    scalar_t* vd = vb + j * KS + part * VEC;
    if (s < hi) {
      const int64_t off = kv_offset<kPaged>(p, tbl_s, blk0, b, s, kvh) + part * VEC;
      if (with_k) cp_async16(kd, k + off);
      cp_async16(vd, v + off);
    } else {
      if (with_k) *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <typename scalar_t, int D, bool kPaged>
__device__ __forceinline__ void attend(const Params& p, char* smem) {
  using Tr = Traits<scalar_t, D>;
  using Warp = typename Tr::Warp;
  constexpr int kChunks = Tr::kChunks;
  constexpr int KS = D + 16 / (int)sizeof(scalar_t);
  constexpr int kBuf = kKeys * KS;  // elements of one staged K or V chunk
  __shared__ int tile_s[3];         // first row, end row, K/V view (-1: padding lanes)
  __shared__ int nlive_s;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // ---- the tile: [r0, r1) query rows of one view
  if (warp == 0) {
    int r0 = -1, r1 = -1, b = -1;
    const int x = blockIdx.x;
    if (p.owner == nullptr) {
      const int n_tile = (p.T + p.tq - 1) / p.tq;
      b = x / n_tile;
      const int t0 = (x % n_tile) * p.tq;
      r0 = b * p.T + t0;
      r1 = b * p.T + min(p.T, t0 + p.tq);
    } else {
      // a tile starts at an owner change and every tq nodes inside a run
      const int own = __ldg(p.owner + x);
      int start = x;
      while (true) {
        const int j = start - 1 - lane;
        const unsigned diff = __ballot_sync(0xffffffffu, j < 0 || __ldg(p.owner + max(j, 0)) != own);
        if (diff) {
          start -= __ffs(diff) - 1;
          break;
        }
        start -= 32;
      }
      if ((x - start) % p.tq == 0) {
        const int j = x + 1 + lane;
        const unsigned stop =
            __ballot_sync(0xffffffffu, lane >= p.tq - 1 || j >= p.R || __ldg(p.owner + min(j, p.R - 1)) != own);
        r0 = x;
        r1 = x + __ffs(stop);
        b = own;
      }
    }
    if (lane == 0) tile_s[0] = r0, tile_s[1] = r1, tile_s[2] = b;
  }
  __syncthreads();
  const int r0 = tile_s[0], r1 = tile_s[1], b = tile_s[2];
  if (r0 < 0) return;  // this node starts no tile

  const int G = p.H / p.Hkv;
  const int kvh = blockIdx.y / p.n_hg;
  const int g0 = (blockIdx.y % p.n_hg) * p.gh;
  const int ng = min(p.gh, G - g0);
  const int nq = r1 - r0;
  const int split = blockIdx.z;
  const int lo = split * p.split_slots;
  const int hi = min(p.S, lo + p.split_slots);

  if (b < 0) {  // ragged padding lanes: zeros (the combine writes them under splits)
    if (p.n_split == 1) {
      scalar_t* out = static_cast<scalar_t*>(p.out);
      for (int i = threadIdx.x; i < nq * ng * D; i += kThreads) {
        const int qi = i / (ng * D), g = (i / D) % ng, d = i % D;
        out[((int64_t)(r0 + qi) * p.H + kvh * G + g0 + g) * D + d] = scalar_t(0.f);
      }
    }
    return;
  }

  const Layout L = make_layout(sizeof(scalar_t), D, kStages * kChunks, p.split_slots, p.block, kPaged);
  scalar_t* kv_s = reinterpret_cast<scalar_t*>(smem + L.kv);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(smem + L.bits);
  const int n_chunk = (hi - lo + kKeys - 1) / kKeys;
  const int n_words = n_chunk / 32 + 1;
  uint32_t* live_w = reinterpret_cast<uint32_t*>(smem + L.live);
  int* live_list = reinterpret_cast<int*>(live_w + n_words);
  int32_t* tbl_s = reinterpret_cast<int32_t*>(smem + L.tbl);
  const int blk0 = kPaged ? lo / p.block : 0;

  const Rows rows{r0, ng, nq * ng, kvh * G + g0, n_chunk, bits_s};
  const int n_teams = Warp::n_teams(rows.nrows, kChunks);
  const int team = Warp::team(warp, rows.nrows);
  bool computes = team < n_teams;
  Warp w;
  auto init = [&]() {
    if constexpr (sizeof(scalar_t) == 2) {
      w.init(p, rows, Warp::tile(warp, rows.nrows), lane, reinterpret_cast<uint4*>(smem + L.q), team == 0);
    } else {
      w.init(p, rows, warp, lane, reinterpret_cast<float*>(smem + L.q), reinterpret_cast<float*>(smem + L.p));
    }
  };
  if (computes && team == 0) init();  // team 0's query loads fly during the pre-pass

  // ---- pre-pass: mask words, live chunks, the table slice
  for (int i = threadIdx.x; i < n_words; i += kThreads) live_w[i] = 0u;
  if constexpr (kPaged) {
    const int n_blk = (hi - 1) / p.block - blk0 + 1;
    for (int i = threadIdx.x; i < n_blk; i += kThreads) tbl_s[i] = __ldg(p.tbl + (int64_t)b * p.nb + blk0 + i);
  }
  __syncthreads();
  for (int item = threadIdx.x; item < nq * n_chunk; item += kThreads) {
    const int qi = item / n_chunk, c = item % n_chunk;
    const uint32_t word = mask_word(mask_row(p, r0 + qi, b), lo + kKeys * c, hi, p.mask_vec != 0);
    bits_s[qi * n_chunk + c] = word;
    if (word) atomicOr(live_w + (c >> 5), 1u << (c & 31));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < n_words; ++i)
      for (uint32_t bw = live_w[i]; bw; bw &= bw - 1) live_list[n++] = 32 * i + __ffs(bw) - 1;
    nlive_s = n;
  }
  __syncthreads();
  const int nlive = nlive_s;
  // teams past the live chunks have nothing to do (the engines' rings hold 1-2 live chunks)
  const int used_teams = max(1, min(n_teams, nlive));
  computes = computes && team < used_teams;
  if (computes && team > 0) init();

  // ---- the live chunks: stage i holds entries [i kChunks, (i + 1) kChunks) of the list,
  // kStages stages deep; team t takes entries t, t + n_teams, ... of a stage (n_teams
  // divides kChunks)
  const float scale_log2 = rsqrtf((float)D) * kLog2e;
  auto buf_k = [&](int i, int u) { return kv_s + (2 * ((i % kStages) * kChunks + u)) * kBuf; };
  auto buf_v = [&](int i, int u) { return kv_s + (2 * ((i % kStages) * kChunks + u) + 1) * kBuf; };
  auto stage_live = [&](int i) {
    for (int u = 0; u < kChunks && i * kChunks + u < nlive; ++u)
      stage<scalar_t, D, kPaged>(p, buf_k(i, u), buf_v(i, u), live_list[i * kChunks + u], lo, hi, b, kvh, tbl_s,
                                 blk0, true);
  };
  const int n_iter = (nlive + kChunks - 1) / kChunks;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_iter) stage_live(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_iter; ++i) {
    if (i + kStages - 1 < n_iter) stage_live(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    for (int u = team; computes && u < kChunks && i * kChunks + u < nlive; u += n_teams) {
      const int c = live_list[i * kChunks + u];
      if constexpr (sizeof(scalar_t) == 2) {
        w.chunk(buf_k(i, u), buf_v(i, u), rows.word(w.ra, c), rows.word(w.rb, c), scale_log2, lane);
      } else {
        w.chunk(buf_k(i, u), buf_v(i, u), rows, c, scale_log2, lane);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // ---- the teams merge into team 0 (the staging buffers hold the merge blocks)
  if (used_teams > 1) {
    float* merge_s = reinterpret_cast<float*>(smem + L.kv);
    if (computes && team > 0) w.merge_out(merge_s + warp * Warp::kMergeFloats, lane);
    __syncthreads();
    if (computes && team == 0) {
      // team u holds this tile in warp (u n_tiles + tile), and this warp is tile
      const int n_tiles = rows.nrows / kWarpRows + (rows.nrows % kWarpRows != 0);
      for (int u = 1; u < used_teams; ++u) w.merge_in(merge_s + (warp + u * n_tiles) * Warp::kMergeFloats, lane);
    }
    __syncthreads();  // the merge blocks are read before the mean pass restages
  }
  computes = computes && team == 0;
  if (computes) w.reduce_l();

  // ---- rows that admit nothing: the mean of V over every slot (one split only)
  if (p.n_split == 1 && __syncthreads_or(computes && w.fully_masked(rows))) {
    auto stage_all = [&](int i) {
      for (int u = 0; u < kChunks && i * kChunks + u < n_chunk; ++u)
        stage<scalar_t, D, kPaged>(p, buf_k(i, u), buf_v(i, u), i * kChunks + u, lo, hi, b, kvh, tbl_s, blk0, false);
    };
    const int n_all = (n_chunk + kChunks - 1) / kChunks;
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_all) stage_all(i);
      cp_async_commit();
    }
    for (int i = 0; i < n_all; ++i) {
      if (i + kStages - 1 < n_all) stage_all(i + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      if (computes)
        for (int u = 0; u < kChunks && i * kChunks + u < n_chunk; ++u) w.mean_chunk(buf_v(i, u), rows, lane);
      __syncthreads();
    }
    cp_async_wait<0>();
    if (computes) w.set_mean_l(rows, (float)(hi - lo));
  }

  if (computes) w.write(p, rows, lane, split);
}

// One CTA per (row, head), D threads: merge the splits' partials; a padding lane gets
// zeros; a row that admits nothing in any split gets the mean of V over all S slots.
template <typename scalar_t, bool kPaged>
__device__ __forceinline__ void combine(const Params& p) {
  const int64_t rh = blockIdx.x;
  const int r = (int)(rh / p.H), h = (int)(rh % p.H);
  const int d = threadIdx.x;
  const int b = p.owner != nullptr ? __ldg(p.owner + r) : r / p.T;
  scalar_t* out = static_cast<scalar_t*>(p.out) + rh * p.D;
  if (b < 0) {
    out[d] = scalar_t(0.f);
    return;
  }
  const int64_t stride = (int64_t)p.R * p.H;
  float M = kNegInf;
  bool any = false;
  for (int s = 0; s < p.n_split; ++s) {
    const float l = p.part_ml[2 * (s * stride + rh) + 1];
    if (l > 0.f) {
      any = true;
      M = fmaxf(M, p.part_ml[2 * (s * stride + rh)]);
    }
  }
  float L = 0.f, a = 0.f;
  if (any) {
    for (int s = 0; s < p.n_split; ++s) {
      const int64_t part = s * stride + rh;
      const float l = p.part_ml[2 * part + 1];
      if (l > 0.f) {
        const float wt = exp2f(p.part_ml[2 * part] - M);
        L = fmaf(l, wt, L);
        a = fmaf(p.part_acc[part * p.D + d], wt, a);
      }
    }
  } else {  // the mean of V over S, 8 loads in flight
    const int kvh = h / (p.H / p.Hkv);
    const scalar_t* v = static_cast<const scalar_t*>(p.v);
    int s = 0;
    for (; s + 8 <= p.S; s += 8) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = (float)v[kv_offset_global<kPaged>(p, b, s + u, kvh) + d];
#pragma unroll
      for (int u = 0; u < 8; ++u) a += x[u];
    }
    for (; s < p.S; ++s) a += (float)v[kv_offset_global<kPaged>(p, b, s, kvh) + d];
    L = (float)p.S;
  }
  out[d] = scalar_t(a / fmaxf(L, 1e-30f));
}

// ------------------------------------------------------------------ launching ---

// Launch kernel (grid as the body expects) and, with splits, combine.  Returns
// cudaGetLastError() after the launches.
template <typename scalar_t, int D, typename K, typename C>
int launch(K kernel, C combine_kernel, const Params& p, int n_tile_slots, cudaStream_t stream) {
  constexpr int kSlots = kStages * Traits<scalar_t, D>::kChunks;
  const bool paged = p.tbl != nullptr;
  const int bytes = make_layout(sizeof(scalar_t), D, kSlots, p.split_slots, p.block, paged).total;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  // set on every launch past the 48 KB default: the attribute holds for the
  // current device only, and costs little
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_tile_slots, p.Hkv * p.n_hg, p.n_split);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  if (p.n_split > 1) combine_kernel<<<p.R * p.H, D, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// Checks shared by both entries; cudaSuccess when the schedule fits the body.
inline int check_schedule(const Params& p) {
  const int G = p.Hkv > 0 ? p.H / p.Hkv : 0;
  if (p.R <= 0 || p.H <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 || p.S <= 0) return cudaErrorInvalidValue;
  if (p.tq < 1 || p.tq > kMaxQuery || p.gh < 1 || p.gh > G || p.tq * p.gh > max_rows(p.D)) return cudaErrorInvalidValue;
  if (p.n_hg != (G + p.gh - 1) / p.gh) return cudaErrorInvalidValue;
  if (p.split_slots <= 0 || p.split_slots % kKeys != 0 || p.n_split != (p.S + p.split_slots - 1) / p.split_slots)
    return cudaErrorInvalidValue;
  if (p.n_split > 1 && (p.part_ml == nullptr || p.part_acc == nullptr)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p.k) | reinterpret_cast<uintptr_t>(p.v)) % 16) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace tree_attn
}  // namespace
