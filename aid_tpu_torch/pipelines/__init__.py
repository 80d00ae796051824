"""Denoising pipelines."""
