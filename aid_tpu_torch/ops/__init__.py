"""Ops: interpolation math, interpolated attention and the 3x3 conv, each with its kernel wrapper."""
