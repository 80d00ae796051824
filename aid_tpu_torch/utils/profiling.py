"""Phase timers and profiler traces.

Counterpart of ``aid_tpu.utils.profiling``: :class:`PhaseTimer` sums the
wall-clock seconds of named phases, and waits at each phase's exit for the
device that holds the value the phase registered, since CUDA launches
return before the card has done the work; :func:`trace` records a
``torch.profiler`` trace (CPU and, where there is a card, CUDA activity) in
place of ``jax.profiler``'s, for TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def _first_tensor(value) -> Optional[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return value
    items = value.values() if isinstance(value, dict) else value if isinstance(value, (list, tuple)) else ()
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class _Phase:
    """The handle ``PhaseTimer.phase`` yields: ``sync(value)`` registers the
    value the phase produced (a tensor, or a list / tuple / dict holding
    one), so that the timer waits for its device at the phase's exit."""

    def __init__(self):
        self._sync_value = None

    def sync(self, value):
        self._sync_value = value
        return value


class PhaseTimer:
    """Wall-clock seconds and calls by phase name::

        timer = PhaseTimer()
        with timer.phase("denoise") as ph:
            latents = ph.sync(pipe.interpolate_single(0.5, output_type="latent"))
        print(timer.report())

    At a phase's exit, a registered value on a CUDA device is waited for
    with ``torch.cuda.synchronize`` on that device; a CPU value needs no
    wait."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        ph = _Phase()
        t0 = time.perf_counter()
        try:
            yield ph
        finally:
            tensor = _first_tensor(ph._sync_value)
            if tensor is not None and tensor.device.type == "cuda":
                torch.cuda.synchronize(tensor.device)
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(f"{name:<30} {self.totals[name]:8.3f}s x{self.counts[name]}"
                         for name in sorted(self.totals, key=self.totals.get, reverse=True))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block, written to ``log_dir`` in
    TensorBoard's layout (a Chrome trace); nothing when ``log_dir`` is
    None. CUDA activity is recorded where a card is visible."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
