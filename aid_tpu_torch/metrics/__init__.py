"""Perceptual metrics of a frame sequence: LPIPS and the Gini smoothness."""
