"""Tensor ops of the port: plain PyTorch where XLA compiled the JAX
package's op, a hand-written Hopper kernel where it had a Pallas kernel
(K1 flash_attention, K3 group_norm, K4 fused_resblock)."""
