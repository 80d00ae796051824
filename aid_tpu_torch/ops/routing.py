"""Where an op runs: its hand-written CUDA kernel, or its plain PyTorch version.

The rule is the tensor's device. A CPU tensor goes to the plain version; a
CUDA tensor goes to the kernel, whose wrapper launches it or raises. There is
no fallback from a kernel that fails to the plain version.

``reference_ops()`` is the one exception, and it exists for tests only: inside
it, CUDA tensors take the plain versions too, so a check on the card can run
the same model twice (kernels, then plain) and compare. Nothing on the main
path enters it. It plays the part of ``FLASH_KERNEL_OVERRIDES`` in the JAX
package.
"""

from __future__ import annotations

import contextlib

import torch

_reference_depth = 0


@contextlib.contextmanager
def reference_ops():
    """Test-only seam: run every op's plain PyTorch version, on any device."""
    global _reference_depth
    _reference_depth += 1
    try:
        yield
    finally:
        _reference_depth -= 1


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the op must launch its CUDA kernel for these tensors.

    False for CPU tensors (and for CUDA tensors inside ``reference_ops()``).
    Raises for mixed devices or a device that has neither route.
    """
    devices = {t.device.type for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    dev = devices.pop()
    if dev == "cpu":
        return False
    if dev == "cuda":
        return _reference_depth == 0
    raise ValueError(f"no route for device type {dev!r}: CPU runs the plain version, CUDA the kernel")
