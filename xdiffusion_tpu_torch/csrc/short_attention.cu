// K7: non-causal attention on head-major (B, H, S, D) tensors.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:171
// (`_short_seq_kernel`, wrapper `short_attention` :208 / `_short_forward`
// :215, `pallas_call` :224). Per (batch, head) slice it is K1's arithmetic
// with one head: fp32 logits from the dots, softmax in fp32, the normalized
// probabilities rounded to v's dtype before the PV product, fp32
// accumulation, the output in q's dtype (q, k and v share it).
//
// Design: the B and H axes merge into one batch axis of K1's device code
// (bsc_attention.cuh) run with heads = 1, on the variant `bsc_plan` picks
// for that shape: at S = 16 (the DiT's attention, head-major) one warp per
// slice, several slices a block, as the TPU kernel packs G slices into a
// grid step (`_short_group` :197); up to ROW_MAX_KEYS keys the one-pass row
// variant; beyond, the two-pass stream. The merge needs each operand's batch
// stride to be H times its head stride; the Python wrapper checks that, and
// the 16-byte row alignment.
//
// Bound on the H100: at S = 16 a slice moves 4 * 16 * D elements for
// 4 * 16 * 16 * D flops, 16 flops per element, far below the card's ~295
// bf16 flops per byte: bytes bound it.
#include "bsc_attention.cuh"

// q: (N, Sq, d), k/v: (N, Sk, d), out: (N, Sq, d) with N = B * H, each with
// unit stride on d and the slice / row strides (elements) given in
// `strides` as {q_ns, q_rs, k_ns, k_rs, v_ns, v_rs, o_ns, o_rs}. Rows must
// start on 16-byte boundaries (checked by the Python wrapper). `plan`: the
// 13 ints of `bsc_plan` for (N, Sq, Sk, 1 head, d).
XD_EXPORT int xd_short_attention(const void* q, const void* k, const void* v,
                                 void* out, int n, int sq, int sk, int d,
                                 const long long* strides, float scale, int dtype,
                                 const int* plan, void* stream) {
  if (n > 65535) return XD_ERR_SHAPE;
  const bsc::Fwd a{q, k, v, out, n, sq, sk, 1, strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5], strides[6], strides[7], scale};
  return bsc::forward(a, bsc::read_plan(plan), d, dtype, (cudaStream_t)stream);
}
