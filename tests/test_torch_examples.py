"""The port's example scripts (examples/torch_*.py), on the CPU.

The tiny demo runs end to end into a temporary directory; the SD and parity
scripts run on a tiny diffusers directory written by chip_smoke.py's
``write_checkpoint`` (the parity run also from exported latents and
embeddings); every script's arguments parse, with the card as the default
device; and importing a script adds neither jax, the JAX package nor PIL.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ("torch_demo_tiny", "torch_interpolate_sd", "torch_interpolate_sdxl", "torch_parity_run")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_tiny_end_to_end(tmp_path):
    out = _load("torch_demo_tiny").main(["--device", "cpu", "--steps", "2", "--out", str(tmp_path)])
    for name, n in (("aid_sequence", 7), ("paid_sequence", 5), ("single", 3), ("denoising_baseline", 1)):
        assert (tmp_path / f"{name}.png").is_file()
        assert out[name].shape == (n, 16, 16, 3) and out[name].dtype == np.uint8


@pytest.mark.parametrize("name,argv", [
    ("torch_demo_tiny", []),
    ("torch_interpolate_sd", ["/ckpt", "--clip", "/clip", "--exploration", "16"]),
    ("torch_interpolate_sdxl", ["/ckpt", "--warmup", "0.5"]),
    ("torch_parity_run", ["--checkpoint", "/ckpt", "--sdxl", "--pooled-embeds-start", "p.npy"]),
])
def test_arguments_parse_with_the_card_by_default(name, argv):
    args = _load(name).parser().parse_args(argv)
    assert args.device == "cuda"
    assert vars(_load(name).parser().parse_args(argv + ["--device", "cpu"]))["device"] == "cpu"


def test_imports_leave_jax_and_pil_out():
    code = (f"import sys, importlib.util\nbefore = set(sys.modules)\nfor n in {SCRIPTS!r}:\n"
            f"    spec = importlib.util.spec_from_file_location(n, '{REPO}/examples/' + n + '.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'flax', 'aid_tpu', 'PIL'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def sd_dir(tmp_path_factory):
    """A tiny SD 1.x diffusers directory (f16 weights ~ N(0, 0.02)), as
    tests/test_torch_chip_smoke.py writes SD 2.1's at a tiny size."""
    spec = importlib.util.spec_from_file_location("chip_smoke_for_examples", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfgs = smoke.sd15_diffusers_configs()
    del cfgs["safety_checker"]
    cfgs["unet"].update(block_out_channels=[32, 64], down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                        up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"], layers_per_block=1,
                        attention_head_dim=2, cross_attention_dim=32, norm_num_groups=8, sample_size=8)
    cfgs["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=4)
    cfgs["text_encoder"].update(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2)
    root = tmp_path_factory.mktemp("sd15")
    smoke.write_checkpoint(str(root), device="cpu", configs=cfgs)
    return root


def test_interpolate_sd_end_to_end(sd_dir, tmp_path):
    out = tmp_path / "strip.png"
    _load("torch_interpolate_sd").main([str(sd_dir), "--device", "cpu", "--steps", "2", "--size", "3",
                                        "--guide", "a toy", "--out", str(out)])
    from PIL import Image

    assert Image.open(out).size == (3 * 16, 16)


def test_parity_run_end_to_end_from_exported_inputs(sd_dir, tmp_path):
    """The parity run from exported latents (.npy) and text embeddings
    (.pt): three frames, their PNGs and the stats; the same inputs from the
    prompts' own embeddings give the same frames."""
    from aid_tpu_torch.models.loader import load_interpolation_pipeline

    pipe = load_interpolation_pipeline(str(sd_dir), device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    files = {}
    for name in ("start", "end"):
        files[f"latent_{name}"] = tmp_path / f"latent_{name}.npy"
        np.save(files[f"latent_{name}"], pipe.generate_latent(gen).numpy())
    emb_s, neg = pipe.encode_prompt("a cat")
    emb_e, _ = pipe.encode_prompt("a dog")
    for name, x in (("embeds_start", emb_s), ("embeds_end", emb_e), ("neg_embeds", neg)):
        files[name] = tmp_path / f"{name}.pt"
        torch.save(x, files[name])
    argv = ["--checkpoint", str(sd_dir), "--device", "cpu", "--steps", "2", "--scheduler", "ddim"]
    argv += [a for k, v in files.items() for a in (f"--{k.replace('_', '-')}", str(v))]
    runs = {}
    prompts_only = [a for a in argv if "embeds" not in a and not a.endswith(".pt")]
    for label, args in (("embeds", argv), ("prompts", prompts_only)):
        out = tmp_path / label
        _load("torch_parity_run").main(args + ["--prompt-start", "a cat", "--prompt-end", "a dog", "--out", str(out)])
        stats = json.loads((out / "stats.json").read_text())
        assert stats["shape"] == [3, 16, 16, 3] and all((out / f"frame_{i}.png").is_file() for i in range(3))
        runs[label] = stats
    assert runs["embeds"]["frame_means"] == runs["prompts"]["frame_means"]
