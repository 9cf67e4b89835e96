"""HunyuanVideo conditioning layers: the rotary-table context head and the
text encoders' offline path (counterpart of
xdiffusion_tpu/layers/hunyuan_video/)."""
