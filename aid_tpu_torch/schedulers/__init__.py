"""Diffusion schedulers (Euler so far)."""
