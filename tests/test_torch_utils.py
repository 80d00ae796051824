"""The port's utilities against aid_tpu's: the parity readers, the phase
timer and profiler trace, and the image strips and grids.

The readers see files written here with numpy, safetensors and torch. The
JAX package returns NHWC latents and the port NCHW, so for every layout
whose channel axis the rule can tell (4 channels, spatial sizes over 8) the
port's tensor is the JAX package's transposed, bit for bit; embeddings keep
their layout on both sides. Images are compared pixel for pixel.
"""

import os

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import torch_helpers as th
from aid_tpu.utils import images as jimages
from aid_tpu.utils import parity as jparity
from aid_tpu_torch.utils import images, parity, profiling


def _write(path, x, key="latents"):
    x = np.ascontiguousarray(x)
    if path.endswith(".npy"):
        np.save(path, x)
    elif path.endswith(".npz"):
        np.savez(path, other=np.zeros(1, np.float32), **{key: x})
    elif path.endswith(".safetensors"):
        save_file({key: x, "zz_other": np.zeros(1, np.float32)}, path)
    elif path.endswith(".bin"):
        torch.save({key: torch.from_numpy(x).to(torch.bfloat16)}, path)
    else:
        torch.save(torch.from_numpy(x), path)


@pytest.mark.parametrize("ext", ["npy", "npz", "safetensors", "pt", "bin"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc", "chw"])
def test_reference_latents_match_jax(tmp_path, ext, layout):
    """NCHW stays, NHWC is turned to NCHW, CHW gains a batch axis; f32 on
    the device asked for, equal to the JAX reader's NHWC array transposed;
    ``key`` picks an entry, the first one (safetensors: sorted) without."""
    x = th.normal(3, (2, 4, 16, 12))
    stored = {"nchw": x, "nhwc": x.transpose(0, 2, 3, 1), "chw": x[0]}[layout]
    path = str(tmp_path / f"lat.{ext}")
    _write(path, stored)
    key = "latents" if ext in ("npz", "bin") else None
    got = parity.load_reference_latents(path, key=key, device="cpu")
    want = np.asarray(jparity.load_reference_latents(path, key=key))
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    expect = x if layout != "chw" else x[:1]
    if ext == "bin":  # stored in bf16: both readers upcast the same rounded values
        expect = torch.from_numpy(expect).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.numpy(), expect)
    if ext == "safetensors":  # no key: the first name in sorted order, as safe_open lists them
        np.testing.assert_array_equal(parity.load_reference_latents(path, device="cpu").numpy(), expect)
    with pytest.raises(ValueError, match="3D/4D"):
        np.save(str(tmp_path / "bad.npy"), np.zeros((4, 4), np.float32))
        parity.load_reference_latents(str(tmp_path / "bad.npy"), device="cpu")


@pytest.mark.parametrize("shape", [(1, 77, 32), (2, 16), (16,)])
def test_reference_embeds_match_jax(tmp_path, shape):
    e = th.normal(4, shape)
    for ext in ("npy", "safetensors", "pt"):
        path = str(tmp_path / f"emb.{ext}")
        _write(path, e)
        got = parity.load_reference_embeds(path, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(jparity.load_reference_embeds(path)))
        assert got.shape == (e[None] if e.ndim == 1 else e).shape


def test_reference_readers_default_to_the_card():
    import inspect

    for fn in (parity.load_reference_latents, parity.load_reference_embeds):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_image_stats_match_jax():
    frames = (th.rng(5).random((3, 16, 16, 3)) * 255).astype(np.uint8)
    assert parity.image_stats(frames) == jparity.image_stats(frames)


def test_phase_timer_sums_phases_and_syncs(monkeypatch):
    """Totals and counts by phase; a registered CUDA value is waited for on
    its device at the phase's exit (stubbed here), a CPU one is not; the
    report lists the longest phase first."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("encode") as ph:
            assert ph.sync(torch.ones(2)).sum() == 2
    with timer.phase("denoise") as ph:
        ph.sync({"latents": [torch.empty(1, device="meta")]})  # a nested value, on no CUDA device
        sum(range(200000))
    assert synced == [] and timer.counts == {"encode": 2, "denoise": 1}
    assert all(v > 0 for v in timer.totals.values())

    class FakeCuda:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(profiling, "_first_tensor", lambda value: FakeCuda())
    with timer.phase("decode") as ph:
        ph.sync(object())
    assert synced == [torch.device("cuda", 1)]
    lines = timer.report().splitlines()
    assert len(lines) == 3 and lines[0].split()[0] == max(timer.totals, key=timer.totals.get)
    assert lines[0].endswith(f"x{timer.counts[lines[0].split()[0]]}")


def test_trace_writes_a_profile(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files and os.path.getsize(tmp_path / files[0]) > 0


def test_images_match_jax(tmp_path):
    """to_pil, the strip (upscaled, saved), the grid, save_image and
    load_and_process_images against the JAX package's, pixel for pixel."""
    frames = (th.rng(6).random((5, 8, 10, 3)) * 255).astype(np.uint8)
    floats = frames / 255.0
    for a, b in zip(images.to_pil(floats), jimages.to_pil(floats)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    strip = images.show_images_horizontally(frames, output_file=str(tmp_path / "s.png"), upscale=2)
    np.testing.assert_array_equal(np.asarray(strip), np.asarray(jimages.show_images_horizontally(frames, upscale=2)))
    assert strip.size == (5 * 10 * 2, 8 * 2) and os.path.exists(tmp_path / "s.png")
    for kw in ({}, {"cols": 3}, {"rows": 1, "cols": 5}):
        np.testing.assert_array_equal(np.asarray(images.image_grids(frames, **kw)),
                                      np.asarray(jimages.image_grids(frames, **kw)))
    np.testing.assert_array_equal(np.asarray(images.image_grids(images.to_pil(frames))),
                                  np.asarray(jimages.image_grids(frames)))
    with pytest.raises(ValueError, match="empty"):
        images.image_grids([])
    for i in (10, 2, 1):
        images.save_image(frames[i % 5], str(tmp_path / f"{i}.jpg"))
    got, want = images.load_and_process_images(str(tmp_path)), jimages.load_and_process_images(str(tmp_path))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
