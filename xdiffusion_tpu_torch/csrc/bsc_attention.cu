// K1: non-causal multi-head attention read straight from the (B, S, C=H*D)
// qkv-projection layout.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:266
// (`_bsc_kernel`, wrapper `short_attention_bsc` :300, `pallas_call` :330).
// Same numerics: fp32 logits from the dots times the scale, the exact row
// max and sum in fp32, p = exp(s - max) / sum rounded once to v's dtype
// before the P.V product (:291), fp32 accumulation, the output in q's dtype,
// heads as column slices with a stride of D.
//
// Bound on the H100, per (batch, head): 4*Sq*Sk*D flops and Sq*Sk
// exponentials against (2*Sq + 2*Sk)*D elements moved. At the main paths'
// sites it is bytes:
// - the flagship UNet's 16x16 maps, (64, 256, C=256, 4 heads) in bf16: 128
//   flops per byte, under the card's ~295 bf16 flops per byte; its
//   exponentials take under half the time its bytes take;
// - the UNet's 4x4 middle block (S = 16) and the DiT, (128, 16, C=384, 6
//   heads) in fp32: 16 flops per element moved.
// What holds it back in practice is latency: a block's work is a short
// chain of dependent tile loads, products and row reductions.
//
// Design (the variants and their layouts: bsc_attention.cuh). The TPU
// kernel holds a head's whole (Sq, Sk) softmax on chip. On the H100 a warp's
// 16 rows of logits fit its registers up to 256 keys in bf16, and a shared
// strip (16 KB at 256 fp32 keys) up to 512, so the "row" variant computes
// Q.K^T once, finds the exact row max and sum and rounds p once, as the TPU
// kernel does, and loads each K and V tile once per block of 16 to 64 query
// rows. At S <= 32 a 64-row tile would be three-quarters empty, so the
// "packed" variant gives each warp one whole (batch, head) slice and packs
// several per block, as `_bsc_forward` packs a group of batch rows into a
// grid step (:319-330). Longer key counts take the two-pass "stream"
// template, which recomputes Q.K^T but holds only one 64-key tile.
#include "bsc_attention.cuh"

// q: (B, Sq, heads*d), k/v: (B, Sk, heads*d), out: (B, Sq, heads*d), each
// with unit stride on the last axis and the batch / row strides (elements)
// given in `strides` as {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs}.
// Rows must start on 16-byte boundaries (checked by the Python wrapper).
// `plan`: the 13 ints of `bsc_plan` (ops/flash_attention.py).
XD_EXPORT int xd_bsc_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int sk, int heads, int d,
                               const long long* strides, float scale, int dtype,
                               const int* plan, void* stream) {
  const bsc::Fwd a{q, k, v, out, b, sq, sk, heads, strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5], strides[6], strides[7], scale};
  return bsc::forward(a, bsc::read_plan(plan), d, dtype, (cudaStream_t)stream);
}
