"""A reader and a writer of the safetensors format, with no dependency beyond torch.

Counterpart of ``aid_tpu.models.params.load_safetensors`` (params.py:556-570),
which uses the ``safetensors`` package; the port reads the format itself, so
that it loads checkpoints where that package is not installed. The format:
an 8-byte little-endian header length N, N bytes of JSON mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin, end)
into the data that follows (an optional ``__metadata__`` entry is skipped),
then the raw little-endian data.

The file is memory-mapped and each tensor copied once from the map to its
place: floating tensors in the requested ``dtype`` on the requested device,
others in their own dtype. :func:`save_safetensors` writes the same format
(chip_smoke.py writes its random-weight checkpoint with it).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

#: the dtypes diffusers and transformers checkpoints of the supported models
#: carry: the weights, and I64 for transformers' position_ids buffer
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}


def _files(path: str) -> list:
    if not os.path.isdir(path):
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))


def _read_header(path: str) -> tuple:
    """(tensor entries of one file, byte offset of its data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_safetensors(path: str, dtype: Optional[torch.dtype] = None, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, or of every ``*.safetensors``
    file of a directory read in sorted order (a later file's key replaces an
    earlier one's, as in the JAX package), as torch tensors on ``device``;
    floating ones cast to ``dtype`` when given."""
    out = {}
    for file in _files(path):
        header, start = _read_header(file)
        with open(file, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            for name, entry in header.items():
                src = _DTYPES.get(entry["dtype"])
                if src is None:
                    raise ValueError(f"{file}: tensor {name!r} has dtype {entry['dtype']}, which this reader "
                                     f"does not take ({sorted(_DTYPES)})")
                begin, end = entry["data_offsets"]
                shape = tuple(entry["shape"])
                want = dtype if dtype is not None and src.is_floating_point else src
                if end == begin:
                    out[name] = torch.empty(shape, dtype=want, device=device)
                    continue
                raw = torch.frombuffer(mm, dtype=src, count=(end - begin) // src.itemsize, offset=start + begin)
                out[name] = raw.reshape(shape).to(device=device, dtype=want, copy=True)
                del raw  # the map closes only once no tensor views it
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; names in sorted order) as one
    .safetensors file, the header padded with spaces so that the data
    starts 8-byte aligned, as the format's own writer does."""
    names = {v: k for k, v in _DTYPES.items()}
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(tensors):
            f.write(tensors[name].detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
