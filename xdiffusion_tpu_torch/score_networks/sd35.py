"""SD3.5's MMDiT-X: SD3 with a second image-only attention in the first blocks.

Counterpart of `SD35Transformer2DModel` in
xdiffusion_tpu/score_networks/sd35.py: the blocks that `dual_attention_layers`
names (a list of indices, or an int N for the first N blocks) run
`MMDiTBlock`'s dual path (score_networks/sd3.py), whose residual lands
before the MLP. Both attentions run on K5 on the card.
"""

from __future__ import annotations

from xdiffusion_tpu_torch.score_networks.sd3 import MMDiTBlock, SD3Transformer2DModel


class SD35Transformer2DModel(SD3Transformer2DModel):
    """SD3 with MMDiT-X blocks in `dual_attention_layers`."""

    def _make_block(self, i: int, n_layers: int) -> MMDiTBlock:
        dual = self._dual_attention_layers
        in_dual = i < int(dual) if isinstance(dual, int) else i in tuple(dual)
        return MMDiTBlock(self._dim, self._num_heads, context_pre_only=(i == n_layers - 1),
                          dual_attention=in_dual, qk_norm=self._qk_norm)
