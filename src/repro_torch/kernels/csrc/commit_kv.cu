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
// C+3 -> C+2).  CUDA blocks run in no order, so this kernel gathers EVERY source lane
// of its (layer, feature chunk) into shared memory, synchronises the block, and only
// then scatters: each entry reads its pre-commit value, which is gather-then-scatter,
// the oracle's semantics, bit for bit.
//
// An entry with src == dst (padding: a root's identity copy, or an idle row's copy of
// the shared trash lane) or with an index outside [0, Smax) moves nothing: the kernel
// neither reads nor writes it, as `commit_kv_ref` drops it.  So the duplicated trash
// entries write nothing and cannot race.
//
// One launch commits every layer, k and v: the grid is (feature chunks, L, 2).
//
// Bound on an H100: bytes.  It moves 2 (read + write) * 2 (k, v) * L * M * F * elt
// bytes, M = the entries that move (src != dst, in range), and computes nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemVectors = 3072;  // 48 KB of 16-byte vectors: static shared memory limit

__global__ void __launch_bounds__(kThreads)
    commit_kv_kernel(uint4* __restrict__ k, uint4* __restrict__ v, const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst, int B, int P, int64_t smax, int fv, int cw) {
  __shared__ uint4 buf[kSmemVectors];
  uint4* base = blockIdx.z == 0 ? k : v;
  const int l = blockIdx.y;
  const int c0 = blockIdx.x * cw;
  const int w = min(cw, fv - c0);
  const int E = B * P;
  auto moves = [&](int e) {  // identity and out-of-range entries move nothing
    const int32_t s = src[e], d = dst[e];
    return s != d && s >= 0 && s < smax && d >= 0 && d < smax;
  };
  auto lane = [&](int e, int32_t s) -> int64_t {
    return (((int64_t)l * B + e / P) * smax + s) * fv + c0;
  };
  for (int i = threadIdx.x; i < E * w; i += blockDim.x) {
    const int e = i / w, c = i % w;
    if (moves(e)) buf[e * w + c] = base[lane(e, src[e]) + c];
  }
  __syncthreads();  // every source read before any destination is written
  for (int i = threadIdx.x; i < E * w; i += blockDim.x) {
    const int e = i / w, c = i % w;
    if (moves(e)) base[lane(e, dst[e]) + c] = buf[e * w + c];
  }
}

}  // namespace

extern "C" {

// fv: 16-byte vectors per (layer, row, slot) lane.  k and v must be 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = success); cudaErrorInvalidValue for
// B * P past what shared memory holds.  The wrapper (../commit_kv.py) checks the rest.
int commit_kv_launch(void* k, void* v, const void* src, const void* dst, int L, int B, int P,
                     long long smax, int fv, void* stream) {
  const int E = B * P;
  if (L <= 0 || E <= 0 || fv <= 0 || smax <= 0 || E > kSmemVectors) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) return cudaErrorInvalidValue;
  const int cw = fv < kSmemVectors / E ? fv : kSmemVectors / E;
  dim3 grid((fv + cw - 1) / cw, L, 2);
  commit_kv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k), static_cast<uint4*>(v), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), B, P, (int64_t)smax, fv, cw);
  return (int)cudaGetLastError();
}

const char* commit_kv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
