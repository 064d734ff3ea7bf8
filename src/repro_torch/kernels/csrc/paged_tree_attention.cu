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
// replicated or gathered in memory.  A row that admits no slot gets the mean of V over
// its S logical slots (trash lanes included); a ragged padding lane (owner -1) reads
// nothing and writes zeros: the engine discards its output.
//
// The body (tree_attention_body.cuh, shared with the dense kernel) reads the block-table
// slice of its key range into shared memory once per CTA and then addresses slot s
// there; a CTA serves one KV head's query heads for a tile of one pool row's query rows
// (padded) or of a run of nodes with one owner (ragged, cut on the card), loads only the
// 32-slot chunks the tile's mask admits, and splits the keys over CTAs only past 4096
// slots.  Its header says why and how.
#include "tree_attention_body.cuh"

namespace {

using tree_attn::Params;

template <typename scalar_t, int D>
__global__ void __launch_bounds__(tree_attn::kThreads) paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  tree_attn::attend<scalar_t, D, true>(p, smem);
}

template <typename scalar_t>
__global__ void paged_attention_combine_kernel(const Params p) {
  tree_attn::combine<scalar_t, true>(p);
}

template <typename scalar_t, int D>
int launch(const Params& p, cudaStream_t stream) {
  // padded: one slot per (pool row, query tile); ragged: one per node (a node that
  // starts no tile exits at once)
  const int slots = p.owner != nullptr ? p.R : (p.R / p.T) * ((p.T + p.tq - 1) / p.tq);
  return tree_attn::launch<scalar_t, D>(paged_attention_kernel<scalar_t, D>, paged_attention_combine_kernel<scalar_t>,
                                        p, slots, stream);
}

}  // namespace

extern "C" {

// Padded pass: owner == NULL, q/out (B*T, H, D) with R = B*T, mask (Bm, T, S).
// Ragged pass: owner (R,) (-1 = padding lane: zeros), mask (R, S), T and Bm unused.
// tq, gh, split_slots, n_split: the wrapper's schedule (../tree_attention.py).
// part_ml (n_split, R, H, 2) and part_acc (n_split, R, H, D) fp32 workspace when
// n_split > 1, else null.  mask_vec: S % 16 == 0 and mask 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16.  k and v must be 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 = success); cudaErrorInvalidValue for
// a shape or schedule this file has no instance for.  The wrapper
// (../paged_tree_attention.py) checks everything else.
int paged_tree_attention_launch(const void* q, const void* k, const void* v, const void* tbl,
                                const void* owner, const void* mask, void* out, void* part_ml,
                                void* part_acc, int R, int T, int H, int Hkv, int block, int nb, int D,
                                int Bm, int tq, int gh, int split_slots, int n_split, int mask_vec,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block <= 0 || nb <= 0 || tbl == nullptr) return cudaErrorInvalidValue;
  if (owner == nullptr && (T <= 0 || R % T != 0)) return cudaErrorInvalidValue;
  Params p{};
  p.q = q, p.k = k, p.v = v, p.mask = static_cast<const uint8_t*>(mask), p.out = out;
  p.tbl = static_cast<const int32_t*>(tbl), p.owner = static_cast<const int32_t*>(owner);
  p.part_ml = static_cast<float*>(part_ml), p.part_acc = static_cast<float*>(part_acc);
  p.R = R, p.T = owner != nullptr ? 1 : T, p.H = H, p.Hkv = Hkv, p.S = nb * block, p.D = D;
  p.block = block, p.nb = nb, p.Bm = owner != nullptr ? 1 : Bm;
  p.tq = tq, p.gh = gh, p.n_hg = Hkv > 0 && gh > 0 ? (H / Hkv + gh - 1) / gh : 0;
  p.split_slots = split_slots, p.n_split = n_split, p.mask_vec = mask_vec;
  const int bad = tree_attn::check_schedule(p);
  if (bad) return bad;
  if (dtype == 0 && D == 256) return launch<float, 256>(p, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(p, st);
  if (dtype == 0 && D == 64) return launch<float, 64>(p, st);
  if (dtype == 0 && D == 48) return launch<float, 48>(p, st);
  if (dtype == 0 && D == 32) return launch<float, 32>(p, st);
  if (dtype == 1 && D == 256) return launch<__nv_bfloat16, 256>(p, st);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 48) return launch<__nv_bfloat16, 48>(p, st);
  if (dtype == 1 && D == 32) return launch<__nv_bfloat16, 32>(p, st);
  return cudaErrorInvalidValue;
}

const char* paged_tree_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
