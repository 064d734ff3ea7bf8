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
// Query head h reads KV head h / (H / Hkv), and batch row b reads mask row
// (Bm == B ? b : 0), so neither K/V nor the mask is replicated in memory.
// A fully masked row gives the mean of V over the S slots and never NaN, as
// the TPU kernel does; unwritten ring lanes are zeros and stay finite.
//
// The body (tree_attention_body.cuh, shared with the paged kernels) reads K/V
// row (b, s) directly: a CTA serves one KV head's query heads for a tile of
// one batch row's query rows, loads only the 32-slot chunks the tile's mask
// admits, scores and weighs on the tensor cores in bf16, and splits the keys
// over CTAs only past 4096 slots.  Its header says why and how.
#include "tree_attention_body.cuh"

namespace {

using tree_attn::Params;

template <typename scalar_t, int D>
__global__ void __launch_bounds__(tree_attn::kThreads) tree_attention_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  tree_attn::attend<scalar_t, D, false>(p, smem);
}

template <typename scalar_t>
__global__ void tree_attention_combine_kernel(const Params p) {
  tree_attn::combine<scalar_t, false>(p);
}

template <typename scalar_t, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int B = p.R / p.T;
  const int n_tile = (p.T + p.tq - 1) / p.tq;
  return tree_attn::launch<scalar_t, D>(tree_attention_kernel<scalar_t, D>, tree_attention_combine_kernel<scalar_t>,
                                        p, B * n_tile, stream);
}

}  // namespace

extern "C" {

// tq, gh, split_slots, n_split: the wrapper's schedule (../tree_attention.py).
// part_ml (n_split, B*T, H, 2) and part_acc (n_split, B*T, H, D) fp32 workspace
// when n_split > 1, else null.  mask_vec: S % 16 == 0 and mask 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16.  k and v must be 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 = success);
// cudaErrorInvalidValue for a shape or schedule this file has no instance for.
// The wrapper checks everything else.
int tree_attention_launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                          void* part_ml, void* part_acc, int B, int T, int H, int Hkv, int S, int D,
                          int Bm, int tq, int gh, int split_slots, int n_split, int mask_vec, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return cudaErrorInvalidValue;
  Params p{};
  p.q = q, p.k = k, p.v = v, p.mask = static_cast<const uint8_t*>(mask), p.out = out;
  p.part_ml = static_cast<float*>(part_ml), p.part_acc = static_cast<float*>(part_acc);
  p.R = B * T, p.T = T, p.H = H, p.Hkv = Hkv, p.S = S, p.D = D, p.block = 1, p.nb = 0, p.Bm = Bm;
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

const char* tree_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
