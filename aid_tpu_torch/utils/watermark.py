"""Invisible watermark for SDXL frames (numpy Haar DWT and 4x4 DCT).

A copy of ``aid_tpu.utils.watermark`` (pure numpy; the port imports nothing
of the JAX package). The SDXL pipeline applies it to every decoded frame
when ``InterpolationXLPipeline.watermarker`` is set, as the JAX pipeline
does (``aid_tpu/pipelines/sdxl.py:40-53``). The scheme is invisible-
watermark's dwtDct with diffusers' fixed 48-bit message:

  1. RGB -> YUV (BT.601), embed in the U chroma plane
  2. one-level 2D Haar DWT -> approximation band cA
  3. per 4x4 block of cA: 2D DCT-II, quantisation-index-modulate the
     largest-magnitude AC coefficient with one message bit
     (val -> (|val|//s + 0.25 + 0.5*bit) * s, sign preserved)
  4. inverse DCT -> inverse DWT -> RGB, round to uint8

Decoding reads the modulated fraction per block and majority-votes each
bit index across blocks, which survives the uint8 round trip.
"""

from __future__ import annotations

import numpy as np

# diffusers WATERMARK_MESSAGE = 0b1011_0011_1110_1100_1001_0000_0111_1011_1011_0001_1001_1110
WATERMARK_BITS = [
    int(b) for b in bin(0b101100111110110010010000011110111011000110011110)[2:].zfill(48)
]

_DCT4 = np.array(
    [[0.5, 0.5, 0.5, 0.5]] +
    [[np.cos((2 * j + 1) * k * np.pi / 8) * np.sqrt(0.5) for j in range(4)] for k in range(1, 4)],
    dtype=np.float64,
)

_RGB2YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14713, -0.28886, 0.436],
     [0.615, -0.51499, -0.10001]], dtype=np.float64)
_YUV2RGB = np.linalg.inv(_RGB2YUV)


def _haar2(x):
    a, b = x[0::2, 0::2], x[0::2, 1::2]
    c, d = x[1::2, 0::2], x[1::2, 1::2]
    return ((a + b + c + d) / 2, (a - b + c - d) / 2,
            (a + b - c - d) / 2, (a - b - c + d) / 2)


def _ihaar2(cA, cH, cV, cD):
    a = (cA + cH + cV + cD) / 2
    b = (cA - cH + cV - cD) / 2
    c = (cA + cH - cV - cD) / 2
    d = (cA - cH - cV + cD) / 2
    h, w = cA.shape
    out = np.empty((h * 2, w * 2), np.float64)
    out[0::2, 0::2], out[0::2, 1::2] = a, b
    out[1::2, 0::2], out[1::2, 1::2] = c, d
    return out


def _blocks(cA, block):
    h, w = cA.shape
    hb, wb = h // block, w // block
    x = cA[: hb * block, : wb * block]
    return x.reshape(hb, block, wb, block).transpose(0, 2, 1, 3).reshape(-1, block, block)


def _unblocks(blocks, shape, block):
    h, w = shape
    hb, wb = h // block, w // block
    x = blocks.reshape(hb, wb, block, block).transpose(0, 2, 1, 3).reshape(hb * block, wb * block)
    return x


class InvisibleWatermark:
    """dwtDct-style invisible watermark (encode + decode)."""

    def __init__(self, bits=None, scale: float = 36.0, block: int = 4):
        self.bits = np.asarray(WATERMARK_BITS if bits is None else bits, np.int64)
        self.scale = float(scale)
        self.block = int(block)

    # -- single image -----------------------------------------------------
    def _encode_plane(self, u: np.ndarray) -> np.ndarray:
        h, w = (u.shape[0] // 2) * 2, (u.shape[1] // 2) * 2
        cA, cH, cV, cD = _haar2(u[:h, :w])
        B = _blocks(cA, self.block)
        coef = np.einsum("ij,njk,lk->nil", _DCT4, B, _DCT4)  # DCT-II per block
        n = coef.shape[0]
        flat = coef.reshape(n, -1)
        ac = np.abs(flat.copy())
        ac[:, 0] = -1.0  # never the DC coefficient
        pos = np.argmax(ac, axis=1)
        val = flat[np.arange(n), pos]
        bit = self.bits[np.arange(n) % len(self.bits)]
        mag = (np.abs(val) // self.scale + 0.25 + 0.5 * bit) * self.scale
        flat[np.arange(n), pos] = np.sign(val) * mag + (np.sign(val) == 0) * mag
        coef = flat.reshape(n, self.block, self.block)
        B = np.einsum("ji,njk,kl->nil", _DCT4, coef, _DCT4)  # inverse DCT
        cA2 = cA.copy()
        hb, wb = (cA.shape[0] // self.block) * self.block, (cA.shape[1] // self.block) * self.block
        cA2[:hb, :wb] = _unblocks(B, cA.shape, self.block)[:hb, :wb]
        out = u.astype(np.float64).copy()
        out[:h, :w] = _ihaar2(cA2, cH, cV, cD)
        return out

    def _decode_plane(self, u: np.ndarray) -> np.ndarray:
        h, w = (u.shape[0] // 2) * 2, (u.shape[1] // 2) * 2
        cA, _, _, _ = _haar2(u[:h, :w])
        B = _blocks(cA, self.block)
        coef = np.einsum("ij,njk,lk->nil", _DCT4, B, _DCT4)
        n = coef.shape[0]
        flat = coef.reshape(n, -1)
        ac = np.abs(flat.copy())
        ac[:, 0] = -1.0
        pos = np.argmax(ac, axis=1)
        val = np.abs(flat[np.arange(n), pos])
        frac = (val % self.scale) / self.scale
        votes = (frac > 0.5).astype(np.int64)
        idx = np.arange(n) % len(self.bits)
        ones = np.bincount(idx, weights=votes, minlength=len(self.bits))
        tot = np.bincount(idx, minlength=len(self.bits))
        return (ones * 2 > tot).astype(np.int64)

    # -- batch API ----------------------------------------------------------
    def apply(self, images: np.ndarray) -> np.ndarray:
        """(N,H,W,3) uint8 -> watermarked uint8."""
        out = np.empty_like(images)
        for i, img in enumerate(images):
            yuv = img.astype(np.float64) @ _RGB2YUV.T
            yuv[..., 1] = self._encode_plane(yuv[..., 1])
            rgb = yuv @ _YUV2RGB.T
            out[i] = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
        return out

    def decode(self, image: np.ndarray) -> np.ndarray:
        """One (H,W,3) uint8 image -> recovered bit vector."""
        yuv = image.astype(np.float64) @ _RGB2YUV.T
        return self._decode_plane(yuv[..., 1])
