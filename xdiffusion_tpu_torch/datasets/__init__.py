"""Host input pipeline.

Counterpart of xdiffusion_tpu/datasets: in-memory numpy datasets that read
real archives when present (MNIST IDX under $XDIFFUSION_DATA_DIR, default
<repo>/data) and otherwise fall back to the deterministic synthetic
stand-in with the same shapes and classes.
"""

from xdiffusion_tpu_torch.datasets.utils import load_dataset  # noqa: F401
