"""Sample-quality evaluation: the LeNet-feature FID."""
