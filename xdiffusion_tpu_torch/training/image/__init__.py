"""Image-diffusion training."""
