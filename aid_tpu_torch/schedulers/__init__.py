"""Diffusion schedulers (DDIM and Euler so far)."""
