// K1: non-causal multi-head attention read straight from the (B, S, C=H*D)
// qkv-projection layout.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:266
// (`_bsc_kernel`, wrapper `short_attention_bsc` :300, `pallas_call` :330).
// Same numerics: fp32 logits from the dots, softmax in fp32, the normalized
// probabilities rounded to v's dtype before the PV product (:291), fp32
// accumulation, heads as column slices with a stride of D.
//
// Bound on the H100: at the UNet's S=256, D=64 it does 4*S*S*D flops per
// (batch, head) against 4*S*D*2 bytes, ~128 flops per byte, below the card's
// ~295 bf16 flops per byte, so bytes bound it; the fp32 logits never leave
// the SM.
//
// Design: the TPU kernel holds one head's whole (Sq, Sk) softmax on chip;
// at S=256 the fp32 logits alone are 256 KB, more than the 227 KB of shared
// memory a block may use. So each block takes one (batch, head, 64-row
// query tile) and walks the keys in tiles of 64, twice: the first pass finds
// each row's max and sum, the second forms p = exp(s - max) / sum, rounds it
// to v's dtype (as the TPU kernel does) and accumulates P.V. The second pass
// recomputes Q.K^T, which costs half again the flops but keeps the
// TPU kernel's rounding exactly and needs no rescaling of the accumulator.
// Each of the 4 warps owns 16 query rows. bf16 runs the products on the
// tensor cores (wmma, fp32 accumulation); fp32 runs them on the CUDA cores
// in full fp32 so that it matches the plain version without TF32 rounding.
#include "bsc_attention.cuh"

// q: (B, Sq, heads*d), k/v: (B, Sk, heads*d), out: (B, Sq, heads*d), each
// with unit stride on the last axis and the batch / row strides (elements)
// given in `strides` as {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs}.
// Rows must start on 16-byte boundaries (checked by the Python wrapper).
XD_EXPORT int xd_bsc_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int sk, int heads, int d,
                               const long long* strides, float scale, int dtype,
                               void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0) return XD_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == XD_F32)
    return dispatch_d<float>(q, k, v, out, b, sq, sk, heads, d, strides, scale, st);
  if (dtype == XD_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, b, sq, sk, heads, d, strides,
                                     scale, st);
  return XD_ERR_DTYPE;
}
