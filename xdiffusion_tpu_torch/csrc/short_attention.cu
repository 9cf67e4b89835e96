// K7: non-causal attention on head-major (B, H, S, D) tensors.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:171
// (`_short_seq_kernel`, wrapper `short_attention` :208 / `_short_forward`
// :215, `pallas_call` :224). Per (batch, head) slice it is K1's arithmetic
// with one head: fp32 logits from the dots, softmax in fp32, the normalized
// probabilities rounded to v's dtype before the PV product, fp32
// accumulation, the output in q's dtype (q, k and v share it).
//
// Design: the B and H axes merge into one batch axis of K1's template
// (bsc_attention.cuh) run with heads = 1, so each block takes one (slice,
// 64-row query tile) and walks the keys in 64-key tiles, twice, as K1
// does. The merge needs each operand's batch stride to be H times its head
// stride; the Python wrapper checks that, and the 16-byte row alignment.
//
// Bound on the H100: at S = 16 (the DiT site, head-major) a slice moves
// 4 * 16 * D elements for 4 * 16 * 16 * D flops, 16 flops per element,
// far below the card's ~295 bf16 flops per byte: bytes bound it. One
// 64-row tile is then three-quarters empty; the TPU kernel packs G slices
// into a grid step for the same reason, and packing slices into one block
// is left for a later change.
#include "bsc_attention.cuh"

// q: (N, Sq, d), k/v: (N, Sk, d), out: (N, Sq, d) with N = B * H, each with
// unit stride on d and the slice / row strides (elements) given in
// `strides` as {q_ns, q_rs, k_ns, k_rs, v_ns, v_rs, o_ns, o_rs}. Rows must
// start on 16-byte boundaries (checked by the Python wrapper).
XD_EXPORT int xd_short_attention(const void* q, const void* k, const void* v,
                                 void* out, int n, int sq, int sk, int d,
                                 const long long* strides, float scale, int dtype,
                                 void* stream) {
  if (n <= 0 || n > 65535 || sq <= 0 || sk <= 0) return XD_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == XD_F32)
    return dispatch_d<float>(q, k, v, out, n, sq, sk, 1, d, strides, scale, st);
  if (dtype == XD_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, n, sq, sk, 1, d, strides, scale, st);
  return XD_ERR_DTYPE;
}
