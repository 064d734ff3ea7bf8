// The bfloat16 instances of the split-K flash-decode for Hopper (sm_90a): the counterparts
// of the Pallas TPU kernels `decode_attention` and `paged_decode_attention` of
// src/repro/kernels/decode_attention.py.  The design is in decode_attention_body.cuh;
// decode_attention_f32.cu holds the other dtype's instances (two sources compile in parallel).
#include "decode_attention_body.cuh"

extern "C" {

// Dense: tbl == NULL, k/v (B, S, Hkv, D), block and nb unused.
// Paged: tbl (B, nb), k/v (NBLK, block, Hkv, D), S = nb * block.
// part_m, part_l (B*H*n_split,) and part_acc (B*H*n_split*D,) fp32 workspace, part_acc
// 16-byte aligned, n_split = ceil(S / split_slots), split_slots a positive
// multiple of 32; tickets (B * Hkv * ceil(H / Hkv / 16),) int32, all 0, and 0 again when
// the launch ends.  dtype: 1 (bfloat16; another is refused).  D: 32, 48, 64, 128 or 256.
// q, k, v must be 16-byte aligned.  Returns cudaGetLastError() after the launch (0 =
// success); cudaErrorInvalidValue for a shape this file has no instance for.  The wrapper
// (../decode_attention.py) checks everything else.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* tbl, const void* lengths,
                            void* part_m, void* part_l, void* part_acc, void* tickets, void* out, int B, int H,
                            int Hkv, int S, int block, int nb, int D, int window, int split_slots, int dtype,
                            void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  return decode_launch<__nv_bfloat16>(q, k, v, tbl, lengths, part_m, part_l, part_acc, tickets, out, B, H, Hkv, S,
                                    block, nb, D, window, split_slots, stream);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
