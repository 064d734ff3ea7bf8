// Batched ring-compaction KV commit, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `commit_kv` in src/repro/kernels/commit_kv.py and
// computes the same function as `commit_kv_ref` in ../ref.py:
//
//   k[l, b, dst[b, j]] <- k[l, b, src[b, j]]   (and likewise v), for every l, b, j
//
//   k, v     (L, B, Smax, F) contiguous, F = Hkv * hd elements of any 2- or 4-byte type,
//            moved as raw 16-byte vectors (F * elt must be a multiple of 16);
//            a paged arena is passed as one row: (L, 1, NBLK * block, F)
//   src, dst (B, P) int32 slots; padding entries carry src == dst
//
// The TPU kernel is exact only because its grid walks j in order: entry j's source may
// be entry j+1's destination (an accepted path [2, 3] moves C+2 -> C+1, then
// C+3 -> C+2).  CUDA blocks run in no order, so the work is split only where no such
// hazard can cross: over (feature slice, layer, k|v).  One CTA holds EVERY entry of its
// slice: each thread loads all of its vectors into registers, the block synchronises,
// and only then does any thread store.  Each entry thus reads its pre-commit value:
// gather-then-scatter, the oracle's semantics, bit for bit.
//
// An entry with src == dst (padding: a root's identity copy, or an idle row's copy of
// the shared trash lane) or with an index outside [0, Smax) moves nothing: the kernel
// neither reads nor writes it, as `commit_kv_ref` drops it.  So the duplicated trash
// entries write nothing and cannot race.
//
// Bound on an H100: bytes.  It moves 2 (read + write) * 2 (k, v) * L * M * F * elt
// bytes, M = the entries that move, and computes nothing.  At the engines' sizes
// (tens of entries, ~4 MB) the time is latency: the dependent round trips a CTA makes.
//
// Design (one launch; the units of work are (feature slice, layer, k|v), the CTAs at most
// one wave of the card, each taking units u, u + grid, ...):
//   * each CTA reads src/dst once and compacts the entries that move into a list in
//     shared memory (a stable warp-ballot compaction), so the copy issues no global
//     index read and spends no step on an identity entry;
//   * in a unit, item i of the M x w (entry, 16-byte vector) items goes to thread
//     i % threads, slot i / threads of a register array of kHold vectors: all of a
//     thread's loads are in flight at once, then one __syncthreads, then the stores.
//     The next unit's loads touch another (slice, layer, k|v), so they follow the
//     stores at once;
//   * the wrapper (../commit_kv.py, `commit_schedule`) picks the slice width w (a
//     power of two of 16-byte vectors) so that there are about 512 units, the threads
//     so that B * P * w items fit kHold per thread, and as many CTAs as units up to
//     what the SMs hold at once.  B * P is capped at kHold * 1024 / 2 entries, so that
//     a slice is at least 2 vectors, one 32-byte sector (a 16-byte slice would read
//     and write half sectors).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHold = 8;            // 16-byte vectors a thread holds between gather and scatter
constexpr int kMaxThreads = 1024;

// units: slices x L x 2; dynamic shared memory: 2 * B * P int32 (the moving entries'
// lanes within a layer, b * smax + slot)
__global__ void __launch_bounds__(kMaxThreads)
    commit_kv_kernel(uint4* __restrict__ k, uint4* __restrict__ v, const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst, int B, int P, int smax, int fv, int cw, int L) {
  extern __shared__ int32_t lanes_s[];  // [0, E): source lanes; [E, 2E): destination lanes
  __shared__ int warp_n[kMaxThreads / 32];
  __shared__ int n_moves;
  const int E = B * P;
  int32_t* src_s = lanes_s;
  int32_t* dst_s = lanes_s + E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  // ---- the moving entries, in entry order
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += blockDim.x) {
    const int e = e0 + tid;
    int32_t s = 0, d = 0;
    bool mv = false;
    if (e < E) {
      s = __ldg(src + e), d = __ldg(dst + e);
      mv = s != d && s >= 0 && s < smax && d >= 0 && d < smax;  // identity and out of range move nothing
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mv);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = base + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += warp_n[w];
    if (mv) {
      const int32_t row = (e / P) * smax;
      src_s[at] = row + s;
      dst_s[at] = row + d;
    }
    for (int w = 0; w < n_warps; ++w) base += warp_n[w];
    __syncthreads();  // warp_n is rewritten by the next round
  }
  if (tid == 0) n_moves = base;
  __syncthreads();

  // ---- each unit: gather every item into registers, then scatter
  const int n_slices = (fv + cw - 1) / cw;
  for (int unit = blockIdx.x; unit < n_slices * L * 2; unit += gridDim.x) {
    const int slice = unit % n_slices, l = unit / n_slices / 2;
    uint4* data = (unit / n_slices) % 2 == 0 ? k : v;
    const int c0 = slice * cw;
    const int w = min(cw, fv - c0);
    const int n_items = n_moves * w;
    const int64_t layer = (int64_t)l * B * smax;  // first lane of this layer
    uint4 held[kHold];
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int i = tid + u * blockDim.x;
      if (i < n_items) held[u] = data[(layer + src_s[i / w]) * fv + c0 + i % w];
    }
    __syncthreads();  // every source of the unit read before any destination is written
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int i = tid + u * blockDim.x;
      if (i < n_items) data[(layer + dst_s[i / w]) * fv + c0 + i % w] = held[u];
    }
  }
}

}  // namespace

extern "C" {

// fv: 16-byte vectors per (layer, row, slot) lane; cw: vectors per slice; threads: a
// multiple of 32 with B * P * cw <= kHold * threads; ctas: the grid.  k and v must be
// 16-byte aligned and B * smax < 2^31.  Returns cudaGetLastError() after the launch
// (0 = success); cudaErrorInvalidValue for arguments outside those limits.  The wrapper
// (../commit_kv.py) computes cw, threads and ctas and checks the rest.
int commit_kv_launch(void* k, void* v, const void* src, const void* dst, int L, int B, int P,
                     long long smax, int fv, int cw, int threads, int ctas, void* stream) {
  const long long E = (long long)B * P;
  if (L <= 0 || E <= 0 || fv <= 0 || smax <= 0 || (long long)B * smax >= (1LL << 31) || cw <= 0 || cw > fv ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || E * cw > (long long)kHold * threads ||
      ctas <= 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) return cudaErrorInvalidValue;
  commit_kv_kernel<<<ctas, threads, 2 * E * sizeof(int32_t), static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k), static_cast<uint4*>(v), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), B, P, (int)smax, fv, cw, L);
  return (int)cudaGetLastError();
}

const char* commit_kv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
