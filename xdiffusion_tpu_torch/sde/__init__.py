"""Stochastic-differential-equation shells of the diffusion processes."""
