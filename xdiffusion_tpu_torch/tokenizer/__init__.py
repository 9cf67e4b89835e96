"""Text tokenizer: GPT-2 byte-level BPE on the vocabulary shipped beside it."""

from xdiffusion_tpu_torch.tokenizer.bpe import Encoder, get_encoder  # noqa: F401
