"""chip_smoke.py's import preamble, on the CPU.

The script must run the package that lies beside it from any working
directory, also under PYTHONSAFEPATH, and must fail (with no result line)
where it lies alone. Neither check imports torch: the preamble only sets the
import path, and the lone script stops before its first phase.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONSAFEPATH"] = "1"  # the interpreter adds neither the cwd nor the script's directory
    return env


def test_preamble_resolves_the_package_from_another_directory(tmp_path):
    code = ("import importlib.util, runpy, sys; runpy.run_path(sys.argv[1], run_name='preamble'); "
            "print(importlib.util.find_spec('aid_tpu_torch').origin); print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO / "chip_smoke.py")], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    origin, torch_loaded = out.stdout.split()
    assert Path(origin) == REPO / "aid_tpu_torch" / "__init__.py"
    assert torch_loaded == "False"


def test_lone_script_fails_without_a_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "aid_tpu_torch" in out.stderr


def _load_smoke():
    """chip_smoke.py as a module (its top level imports the standard library only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNEL_NAMES = ("flash_interpolated_attention", "flash_interpolated_attention(D=40/80/160)",
                "flash_self_attention_f32", "flash_self_attention_bf16", "conv3x3_same", "conv3x3_same(packed=True)",
                "conv3x3_gnsilu", "flash_interpolated_attention_f32", "flash_interpolated_attention_f32(D=40/80/160)",
                "conv3x3_same_f32", "conv3x3_gnsilu_f32", "flash_interpolated_attention_f16",
                "flash_interpolated_attention_f16(D=40/80/160)", "flash_self_attention_f16", "conv3x3_same_f16",
                "conv3x3_same_f16(packed=True)", "conv3x3_gnsilu_f16", "flash_interpolated_attention(D=161-512)",
                "flash_interpolated_attention_f16(D=161-512)", "flash_interpolated_attention_f32(D=161-512)",
                "flash_interpolated_attention(D=513-2048)", "flash_interpolated_attention_f16(D=513-2048)",
                "flash_interpolated_attention_f32(D=513-2048)", "flash_interpolated_attention(onepass)",
                "flash_interpolated_attention_f16(onepass)", "flash_interpolated_attention(midstream)",
                "flash_interpolated_attention_f16(midstream)")
# the static-shift instances' entries, after the rest
STATIC_KERNEL_NAMES = ("flash_interpolated_attention(static)", "flash_interpolated_attention(static midstream)",
                       "flash_interpolated_attention_f32(static)", "flash_interpolated_attention(static dmid)",
                       "flash_interpolated_attention_f32(static dmid)", "flash_interpolated_attention(static dwide)",
                       "flash_interpolated_attention_f32(static dwide)", "flash_self_attention_f32(static)",
                       "flash_self_attention_bf16(static)")


def test_kernels_line_carries_bound_and_library_time():
    """The kernels line parses as JSON, and every entry carries the keys the
    contract names, first and in order: bound_ms and library_ms too (null
    where no single PyTorch call computes the function), beside what phase 3
    measured besides (kernel_ms, the library call's name). A conv or bf16
    attention entry's ms is its wrapper's time, as in every kernels line
    before, and the launch alone is kernel_ms beside it."""
    import json

    smoke = _load_smoke()
    records = {}
    for i, name in enumerate(KERNEL_NAMES + STATIC_KERNEL_NAMES):
        lib = None if name.startswith(("flash_interpolated", "conv3x3_gnsilu")) else 0.5 + i
        records[name] = {"max_abs_err": 1e-3 * i, "ms": 1.0 + i, "plain_ms": 2.0 + i, "bound_ms": 0.25 * (i + 1),
                         "bound_by": "operations", "library_ms": lib, "library": lib and "cudnn channels_last"}
        records[name]["kernel_ms"] = 0.5 + i
    launches = {f"{k}[D={d}]": 3 for k in ("flash_interpolated_attention", "flash_interpolated_attention_f32")
                for d in (40, 64, 80, 160)}
    launches.update({c: 3 for c in ("flash_self_attention_f32", "flash_self_attention_bf16", "conv3x3_same",
                                    "conv3x3_gnsilu", "conv3x3_same_f32")})
    launches["conv3x3_gnsilu_f32"] = 4
    launches.update({f"flash_interpolated_attention_f16[D={d}]": d for d in (40, 64, 80, 160)})
    launches.update({"flash_self_attention_f16": 5, "conv3x3_same_f16": 6, "conv3x3_gnsilu_f16": 7})
    launches.update({f"flash_interpolated_attention{t}[D=512]": n for t, n in (("", 11), ("_f16", 12), ("_f32", 13))})
    launches.update({f"flash_interpolated_attention{t}[D=2048]": n for t, n in (("", 21), ("_f16", 22), ("_f32", 23))})
    # the short-stream kernel's launches, a part of the D <= 160 counts: 1 a head dim in bf16, 2 in f16; and
    # the mid-length stream kernel's: none at D = 40 and 160, 1 at 64 and 80 in bf16, 3 in f16
    for t, n, m in (("", 1, 1), ("_f16", 2, 3)):
        launches.update({f"flash_interpolated_attention{t}[onepass D={d}]": n for d in (40, 64, 80, 160)})
        launches[f"flash_interpolated_attention{t}[onepass]"] = 4 * n
        launches.update({f"flash_interpolated_attention{t}[midstream D={d}]": m * (d in (64, 80))
                         for d in (40, 64, 80, 160)})
        launches[f"flash_interpolated_attention{t}[midstream]"] = 2 * m
    # the static-shift instances' launches, parts of the D <= 160 counts too: the streaming kernels' 1 a head
    # dim in bf16 (none at 160), 2 in f32; the bf16 mid-length stream kernel's 1 at D = 64
    for t, n in (("", 1), ("_f32", 2)):
        launches.update({f"flash_interpolated_attention{t}[static D={d}]": n * (d != 160 or t == "_f32")
                         for d in (40, 64, 80, 160)})
        launches[f"flash_interpolated_attention{t}[static]"] = 3 * n if t == "" else 4 * n
        launches.update({f"flash_interpolated_attention{t}[static midstream D={d}]": int(d == 64 and t == "")
                         for d in (40, 64, 80, 160)})
        launches[f"flash_interpolated_attention{t}[static midstream]"] = int(t == "")
    # the D=161-512 kernels' static launches, parts of their D=512 counts: 5 in bf16, 6 in f32 (by head dim, the
    # dims a path launched); the D=512 self kernels', parts of theirs: 2 in f32, 1 in bf16
    for t, n in (("", 5), ("_f32", 6)):
        launches[f"flash_interpolated_attention{t}[static dmid]"] = n
        launches[f"flash_interpolated_attention{t}[static dmid D=320]"] = n
    # the wide kernels' static launches, parts of their D=2048 counts: 7 in bf16, 4 in f32 (by the instance's
    # padded head dim)
    for t, n in (("", 7), ("_f32", 4)):
        launches[f"flash_interpolated_attention{t}[static dwide]"] = n
        launches[f"flash_interpolated_attention{t}[static dwide D=640]"] = n
    launches.update({"flash_self_attention_f32[static]": 2, "flash_self_attention_bf16[static]": 1,
                     "flash_self_attention_f16[static]": 0})
    paths = [{k: n if i else 0 for k, n in launches.items()} for i in range(2)]  # the first path launched none
    entries = json.loads(smoke.kernels_line(records, launches, paths))["kernels"]
    assert [e["name"] for e in entries] == list(KERNEL_NAMES + STATIC_KERNEL_NAMES)
    for e, name in zip(entries, KERNEL_NAMES + STATIC_KERNEL_NAMES):
        assert tuple(e)[:len(smoke.KERNEL_KEYS)] == smoke.KERNEL_KEYS
        assert e["route"] == "cuda" and e["bound_by"] in ("bytes", "operations")
        assert e["bound_ms"] == records[name]["bound_ms"] and e["library_ms"] == records[name]["library_ms"]
        assert e["ms"] == records[name]["ms"]
        if name.startswith("conv"):
            for part in ("ms: through the wrapper", "kernel_ms: the conv launch alone", "layout_ms: the layout kernel"):
                assert part in e["contract"]
        if name.startswith("conv") or name.startswith("flash_interpolated") or name in (
                "flash_self_attention_bf16", "flash_self_attention_f16"):
            assert e["kernel_ms"] == records[name]["kernel_ms"]
        if name.startswith("flash_interpolated") or name in ("flash_self_attention_bf16", "flash_self_attention_f16"):
            for part in ("ms: through the wrapper", "kernel_ms: the launch alone"):
                assert part in e["contract"]
        assert (REPO / e["source"]).is_file()
        path, line = e["replaces"].split(":")
        assert path.startswith("aid_tpu/") and (REPO / path).is_file() and int(line) > 0
    # the bf16 streaming kernel at D = 64, the short and mid-length streams' and the static instances' launches not
    assert entries[0]["launches"] == 3 - 1 - 1 - 1 - 1
    assert entries[1]["launches"] == 9 - 3 - 1 - 2  # the bf16 kernel at D = 40, 80 and 160
    assert entries[3]["launches"] == 3 - 1 and entries[3]["source"].endswith("flash_attention_bf16_d512.cu")
    # the f32 instances: their own sources and launch counts
    by_name = {e["name"]: e for e in entries}
    assert by_name["flash_interpolated_attention_f32"]["source"].endswith("flash_interpolated_attention_f32.cu")
    assert by_name["flash_interpolated_attention_f32"]["launches"] == 3 - 2
    assert by_name["flash_interpolated_attention_f32(D=40/80/160)"]["launches"] == 9 - 3 * 2
    assert by_name["conv3x3_same_f32"]["source"].endswith("conv3x3_f32.cu")
    assert by_name["conv3x3_same_f32"]["launches"] == 3 and by_name["conv3x3_same_f32"]["replaces"].endswith(":30")
    # the f32 GN+SiLU conv: TPU kernel #5, in the f32 conv's source, its own count
    gn32 = by_name["conv3x3_gnsilu_f32"]
    assert gn32["source"].endswith("conv3x3_f32.cu") and gn32["replaces"] == "aid_tpu/ops/conv.py:78"
    assert gn32["launches"] == 4 and gn32["library_ms"] is None
    # the f16 instances: the bf16 designs' sources, their own C entries and launch counts
    f16 = {n: by_name[n] for n in KERNEL_NAMES[-16:-10]}
    assert f16["flash_interpolated_attention_f16"]["source"].endswith("flash_interpolated_attention.cu")
    assert f16["flash_interpolated_attention_f16"]["launches"] == 64 - 2 - 3
    assert f16["flash_interpolated_attention_f16(D=40/80/160)"]["launches"] == 40 + 80 + 160 - 3 * 2 - 3
    assert f16["flash_self_attention_f16"]["source"].endswith("flash_attention_bf16_d512.cu")
    assert f16["flash_self_attention_f16"]["launches"] == 5
    assert f16["conv3x3_same_f16"]["launches"] == f16["conv3x3_same_f16(packed=True)"]["launches"] == 6
    assert f16["conv3x3_gnsilu_f16"]["launches"] == 7 and f16["conv3x3_gnsilu_f16"]["source"].endswith("conv3x3.cu")
    assert [e["replaces"].split(":")[1] for e in f16.values()] == ["101", "101", "101", "30", "47", "78"]
    assert {e["entry"] for e in f16.values()} == {"aid_flash_attn_f16", "aid_flash_attn_f16_d512", "aid_conv3x3_f16",
                                                 "aid_conv3x3_gnsilu_f16"}
    # the D=161-512 entries: the two D=161-512 sources, their own C entries,
    # each read from its dtype's count under D=512, self mode's instance named
    wide = {n: by_name[n] for n in KERNEL_NAMES[-10:-7]}
    assert [e["launches"] for e in wide.values()] == [11 - 5, 12, 13 - 6]  # less the static instances' launches
    assert [e["entry"] for e in wide.values()] == ["aid_flash_attn_bf16_dmid", "aid_flash_attn_f16_dmid",
                                                   "aid_flash_attn_f32_dmid"]
    assert [e["source"].rsplit("/", 1)[1] for e in wide.values()] == ["flash_attention_dmid.cu"] * 2 + [
        "flash_attention_dmid_f32.cu"]
    assert all(e["replaces"] == "aid_tpu/ops/flash_attention.py:101" and e["library_ms"] is None
               and "at the caller's D" in e["contract"] and "NSETS 0" in e["design"] for e in wide.values())
    # self mode's last head dim on the self instance: 511 in bf16 and f16, 448 in f32
    assert [next(d for d in ("511", "448") if f"self mode at 161-{d} (its self instance, n_sets 0)" in e["contract"])
            for e in wide.values()] == ["511", "511", "448"]
    # the wide entries past 512: one source, their own C entries, each read
    # from its dtype's count under DWIDE
    dwide = {n: by_name[n] for n in KERNEL_NAMES[-7:-4]}
    assert [e["launches"] for e in dwide.values()] == [21 - 7, 22, 23 - 4]  # less the static instances' launches
    assert [e["entry"] for e in dwide.values()] == ["aid_flash_attn_bf16_dwide", "aid_flash_attn_f16_dwide",
                                                    "aid_flash_attn_f32_dwide"]
    assert all(e["source"] == "aid_tpu_torch/csrc/flash_attention_dwide.cu" and e["also_replaces"].endswith(":339")
               and "bound_padded_ms at the padded D the kernel computes" in e["contract"]
               and "flash_dwide_combine_kernel" in e["design"] for e in dwide.values())
    # the short-stream kernel: its own source and C entries, TPU kernel #2
    # (`_kernel_onepass`), each read from its dtype's short-stream count
    onepass = {n: by_name[n] for n in KERNEL_NAMES[-4:-2]}
    assert [e["launches"] for e in onepass.values()] == [4, 8]
    assert [e["entry"] for e in onepass.values()] == ["aid_flash_attn_bf16_onepass", "aid_flash_attn_f16_onepass"]
    assert all(e["source"] == "aid_tpu_torch/csrc/flash_attention_onepass.cu"
               and e["replaces"] == "aid_tpu/ops/flash_attention.py:339" for e in onepass.values())
    # the mid-length stream kernel: its own source and C entries, TPU kernel #2
    # too, each read from its dtype's mid-length stream count
    midstream = {n: by_name[n] for n in KERNEL_NAMES[-2:]}
    assert [e["launches"] for e in midstream.values()] == [2, 6]
    assert [e["entry"] for e in midstream.values()] == ["aid_flash_attn_bf16_midstream",
                                                        "aid_flash_attn_f16_midstream"]
    assert all(e["source"] == "aid_tpu_torch/csrc/flash_attention_midstream.cu"
               and e["replaces"] == "aid_tpu/ops/flash_attention.py:339" and "3072 keys" in e["contract"]
               for e in midstream.values())
    # the static-shift instances: their own sources and C entries, the static
    # branches of both TPU kernels, their counts in all and on each path
    static = [by_name[n] for n in STATIC_KERNEL_NAMES]
    assert [e["launches"] for e in static] == [3, 1, 8, 5, 6, 7, 4, 2, 1]
    assert [e["launches_by_path"] for e in static] == [[0, 3], [0, 1], [0, 8], [0, 5], [0, 6], [0, 7], [0, 4], [0, 2],
                                                       [0, 1]]
    assert [e["entry"] for e in static] == ["aid_flash_attn_bf16_static", "aid_flash_attn_bf16_midstream_static",
                                            "aid_flash_attn_f32_static", "aid_flash_attn_bf16_dmid_static",
                                            "aid_flash_attn_f32_dmid_static", "aid_flash_attn_bf16_dwide_static",
                                            "aid_flash_attn_f32_dwide_static", "aid_flash_attn_f32_d512_static",
                                            "aid_flash_attn_bf16_d512_static"]
    assert [e["source"].rsplit("/", 1)[1] for e in static] == [
        "flash_interpolated_attention_static.cu", "flash_attention_midstream_static.cu",
        "flash_interpolated_attention_f32_static.cu", "flash_attention_dmid_static.cu",
        "flash_attention_dmid_f32_static.cu", "flash_attention_dwide_static.cu", "flash_attention_dwide_static.cu",
        "flash_attention_f32_d512_static.cu", "flash_attention_bf16_d512_static.cu"]
    assert [e["replaces"] for e in static] == ["aid_tpu/ops/flash_attention.py:210",
                                               "aid_tpu/ops/flash_attention.py:520",
                                               "aid_tpu/ops/flash_attention.py:210"] + [
        "aid_tpu/ops/flash_attention.py:210"] * 6
    assert all("flash_dwide_combine_kernel" in e["design"] and "O = sum O_s / sum l_s" in e["design"]
               for e in static[5:7])


def test_f32_phases_follow_the_bf16_paths():
    """Phases 11 (f32 SDXL) and 12 (f32 SD 1.5) exist with their banners,
    run after phase 10 in main(), and every name the kernels line reads is a
    count that read_counts reports."""
    import inspect

    smoke = _load_smoke()
    assert "== phase 11: f32 SDXL UNet" in inspect.getsource(smoke.phase_f32_sdxl)
    assert "== phase 12: f32 SD1.5 UNet" in inspect.getsource(smoke.phase_f32_sd15)
    main = inspect.getsource(smoke.main)
    assert main.index("phase_sd15_image") < main.index("phase_f32_sdxl") < main.index("phase_f32_sd15")
    for tag in ("11. f32 SDXL", "12. f32 SD1.5"):
        assert tag in smoke.__doc__


def test_bounds_follow_the_work():
    """bound_ms from shapes: the larger of operations over the peak of their
    type and bytes over the memory rate (the figures of the kernel table)."""
    smoke = _load_smoke()
    ms, by = smoke.conv_bound(7, 128, 128, 960, 320)  # 634 GFLOP of bf16 products
    assert by == "operations" and abs(ms - 0.641) < 1e-3
    ms, by = smoke.attention_bound("self", 1, 1, 16384, 16384, 512, elem=4, tf32_passes=3)
    assert by == "operations" and abs(ms - 3.332) < 1e-3  # 550 GFLOP at three TF32 passes
    ms, by = smoke.attention_bound("self", 1, 1, 16384, 16384, 512)  # the same flops in bf16
    assert by == "operations" and abs(ms - 0.556) < 1e-3
    ms, by = smoke.attention_bound("self", 7, 1, 4096, 4096, 512)
    assert by == "operations" and abs(ms - 0.243) < 1e-3
    ms, by = smoke.attention_bound("self", 7, 10, 4096, 77, 64)  # 77 keys: the bytes bind
    assert by == "bytes"
    # fused_outer: own, begin and end segments, except the two skip rows
    self_ms, _ = smoke.attention_bound("self", 7, 10, 4096, 4096, 64)
    outer_ms, _ = smoke.attention_bound("fused_outer", 7, 10, 4096, 4096, 64, skip_rows=2)
    assert abs(outer_ms / self_ms - (5 * 3 + 2) / 7) < 1e-9
    # the f32 instances at three TF32 passes, the f32 UNets' shapes
    ms, by = smoke.attention_bound("self", 7, 10, 4096, 4096, 64, elem=4, tf32_passes=3)
    assert by == "operations" and abs(ms - 1.822) < 1e-3
    ms, by = smoke.attention_bound("fused_outer", 7, 10, 4096, 4096, 64, elem=4, tf32_passes=3, skip_rows=2)
    assert by == "operations" and abs(ms - 4.425) < 1e-3
    ms, by = smoke.attention_bound("self", 7, 8, 4096, 4096, 40, elem=4, tf32_passes=3)
    assert by == "operations" and abs(ms - 0.911) < 1e-3
    ms, by = smoke.conv_bound(7, 128, 128, 960, 320, tf32_passes=3)  # 634 GFLOP at three TF32 passes
    assert by == "operations" and abs(ms - 3.843) < 1e-3
    # the f32 D=512 kernel's own split: 1.5 TF32 and 1.5 bf16 passes, whose times add on the tensor cores
    ms, by = smoke.attention_bound("self", 1, 1, 16384, 16384, 512, elem=4, **smoke.F32_D512_PASSES)
    assert by == "operations" and abs(ms - 2.500) < 1e-3
    ms, by = smoke.attention_bound("self", 7, 1, 4096, 4096, 512, elem=4, **smoke.F32_D512_PASSES)
    assert by == "operations" and abs(ms - 1.094) < 1e-3
    ms, by = smoke.bound({"bf16": 989e9, "tf32": 495e9, "f32": 67e9}, 0.0)  # f32 beside the tensor cores
    assert by == "operations" and abs(ms - 2.0) < 1e-9


def test_sd21_phase_follows_the_f32_paths():
    """Phase 13 (SD 2.1 through the loader) exists with its banner, runs
    last in main(), writes its checkpoint inside the checkout's git-ignored
    build/ and removes it, loads it with no device and no dtype as the app
    does, and checks the f32 GN+SiLU conv's launches; its SD 2.1 configs
    read back as the port's presets."""
    import inspect

    smoke = _load_smoke()
    src = inspect.getsource(smoke.phase_sd21)
    assert "== phase 13: SD2.1" in src and "13. SD2.1" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert main.index("phase_f32_sd15") < main.index("phase_sd21(card)")
    assert main.index("sd21_fused_conv_classes()") < main.index("phase_kernels(")
    assert 'dir=os.path.join(ROOT, "build")' in src and "shutil.rmtree(root" in src
    assert "scheduler_name=\"unipc\", guidance_scale=SD21_GUIDANCE, **kw)" in src and "pipe = load()" in src
    assert '"conv3x3_gnsilu_f32")' in src and "check_fused_vs_plain(" in src
    assert smoke.SD21_STEPS == 25 and smoke.SD21_GUIDANCE == 10.0
    assert "build/" in (REPO / ".gitignore").read_text().split()

    from aid_tpu_torch.models import configs, loader

    cfgs = smoke.sd21_diffusers_configs()
    assert loader.unet_config_from_diffusers(cfgs["unet"]) == configs.SD21_UNET
    assert loader.vae_config_from_diffusers(cfgs["vae"]) == configs.SD_VAE
    text = loader.clip_text_config_from_transformers(cfgs["text_encoder"])
    assert text == dataclasses.replace(configs.OPENCLIP_VIT_H_TEXT, eos_token_id=2)
    assert cfgs["scheduler"]["prediction_type"] == "v_prediction" and cfgs["scheduler"]["steps_offset"] == 1


def test_sd21_checkpoint_writer_round_trips(tmp_path):
    """write_checkpoint at a tiny size on the CPU: every module's
    weights land as f16 safetensors under the diffusers names that the
    loader reads strictly, and the tokenizer pads with "!" (id 0)."""
    import torch

    from aid_tpu_torch.models import loader

    smoke = _load_smoke()
    cfgs = smoke.sd21_diffusers_configs()
    cfgs["unet"].update(block_out_channels=[32, 64], down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                        up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"], layers_per_block=1,
                        attention_head_dim=[2, 2], cross_attention_dim=32, norm_num_groups=8, sample_size=8)
    cfgs["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=4)
    cfgs["text_encoder"].update(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2)
    nbytes = smoke.write_checkpoint(str(tmp_path), device="cpu", configs=cfgs)
    pipe = loader.load_interpolation_pipeline(str(tmp_path), scheduler_name="unipc", device="cpu")
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder) for p in m.parameters())
    assert nbytes == 2 * n_params
    stds = [p.float().std().item() for p in pipe.unet.parameters() if p.numel() > 1000]
    assert stds and all(0.015 < s < 0.025 for s in stds)  # N(0, 0.02), read back from f16
    assert pipe.tokenizer.pad_id == 0 and pipe.scheduler.config.prediction_type == "v_prediction"


def test_sd21_fused_conv_classes_read_on_meta():
    """The SD 2.1 GN+SiLU conv classes that phase 3 times are read off a
    forward on the meta device (no weights, no card): the resnet convs at
    96^2 and 48^2 with cin >= 320, as gn_conv_fused routes them; phase 13
    takes no parameter but the card's name."""
    import inspect

    smoke = _load_smoke()
    classes = smoke.sd21_fused_conv_classes()
    assert classes == {(96, 96, 320, 320): 7, (48, 48, 320, 640): 1, (48, 48, 640, 640): 6,
                       (48, 48, 1920, 640): 1, (48, 48, 1280, 640): 1, (48, 48, 960, 640): 1,
                       (96, 96, 960, 320): 1, (96, 96, 640, 320): 2}
    assert list(inspect.signature(smoke.phase_sd21).parameters) == ["card"]


def _tiny_sd15_configs(smoke):
    """sd15_diffusers_configs cut to the tiny test sizes (CLIP vision as
    configs.TINY_CLIP_VISION)."""
    from aid_tpu_torch.models.configs import TINY_CLIP_VISION as V

    cfgs = smoke.sd15_diffusers_configs()
    cfgs["unet"].update(block_out_channels=[32, 64], down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                        up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"], layers_per_block=1,
                        attention_head_dim=2, cross_attention_dim=32, norm_num_groups=8, sample_size=8)
    cfgs["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=4)
    cfgs["text_encoder"].update(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2)
    cfgs["safety_checker"]["projection_dim"] = V.projection_dim
    cfgs["safety_checker"]["vision_config"].update(hidden_size=V.hidden_size, intermediate_size=V.intermediate_size,
                                                   num_hidden_layers=V.num_hidden_layers,
                                                   num_attention_heads=V.num_attention_heads,
                                                   patch_size=V.patch_size, image_size=V.image_size)
    return cfgs


def test_selection_phases_follow_the_padded_phase():
    """Phases 15 (SD 1.5 with a safety checker through the loader) and 16
    (PAID selection on its pipeline) exist with their banners, run after
    phase 14 in main(); the SD 1.5 configs read back as the port's presets,
    the checker's as CompVis's published ViT-L/14 with projection 768;
    phase 8 reads the watermark back."""
    import inspect

    smoke = _load_smoke()
    assert "== phase 15: SD1.5 with a safety checker" in inspect.getsource(smoke.phase_sd15_safety)
    assert "== phase 16: PAID selection" in inspect.getsource(smoke.phase_selection)
    for tag in ("15. SD1.5 safety", "16. selection"):
        assert tag in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_tiny_padded(card)") < main.index("phase_sd15_safety(card)")
            < main.index("phase_selection(pipe, card)") < main.index("kernels_line("))
    assert "smoke wall time" in main
    assert "InvisibleWatermark().decode(" in inspect.getsource(smoke.phase_image)
    assert (smoke.SELECT_EXPLORATION, smoke.SELECT_SIZE) == (16, 7)

    from aid_tpu_torch.models import configs, loader

    cfgs = smoke.sd15_diffusers_configs()
    assert loader.unet_config_from_diffusers(cfgs["unet"]) == configs.SD15_UNET
    assert loader.vae_config_from_diffusers(cfgs["vae"]) == configs.SD_VAE
    text = loader.clip_text_config_from_transformers(cfgs["text_encoder"])
    assert text == dataclasses.replace(configs.CLIP_VIT_L_TEXT, eos_token_id=2)
    vision = loader.clip_vision_config_from_transformers(cfgs["safety_checker"])
    assert vision == configs.CLIPVisionConfig(image_size=224, patch_size=14, hidden_size=1024, intermediate_size=4096,
                                              num_hidden_layers=24, num_attention_heads=16, projection_dim=768)
    assert configs.CLIP_VIT_B32_VISION == configs.CLIPVisionConfig(
        image_size=224, patch_size=32, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
        num_attention_heads=12, projection_dim=512, hidden_act="quick_gelu")


def test_sd15_checkpoint_writer_with_safety_checker(tmp_path):
    """write_checkpoint with the SD 1.5 configs writes the
    safety_checker/ too, under the diffusers names the loader reads
    strictly; the loader attaches it to the pipeline."""
    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.safety import SafetyChecker

    smoke = _load_smoke()
    nbytes = smoke.write_checkpoint(str(tmp_path), device="cpu", configs=_tiny_sd15_configs(smoke))
    pipe = loader.load_interpolation_pipeline(str(tmp_path), device="cpu")
    modules = (pipe.unet, pipe.vae, pipe.text_encoder, pipe.safety_checker)
    assert isinstance(pipe.safety_checker, SafetyChecker)
    assert nbytes == 2 * sum(p.numel() for m in modules for p in m.parameters())
    assert {p.dtype for p in pipe.safety_checker.parameters()} == {torch_float32()}


def torch_float32():
    import torch

    return torch.float32


def test_selection_phases_rehearse_on_the_cpu(monkeypatch):
    """Phases 15 and 16 end to end at the tiny size on the CPU (3 DDIM
    steps), torch.cuda's timing calls stubbed: every check but the kernel
    launch counts (no kernel runs here) must pass, and the selection must
    return its three paths."""
    import torch

    smoke = _load_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    skipped = []

    def fail(msg):
        if "launch" not in msg:
            raise AssertionError(msg)
        skipped.append(msg)

    monkeypatch.setattr(smoke, "fail", fail)
    monkeypatch.setattr(smoke, "SD15_STEPS", 3)
    # the tiny model barely moves with t: the batching bound at its scale
    monkeypatch.setattr(smoke, "SELECT_BATCH_TOL", 1e-4)
    from aid_tpu_torch.models.configs import TINY_CLIP_VISION

    pipe, counts = smoke.phase_sd15_safety("cpu", device="cpu", configs=_tiny_sd15_configs(smoke))
    assert pipe.safety_checker is not None and set(counts) >= {"flash_self_attention_f32"}
    paths = smoke.phase_selection(pipe, "cpu", scorer_cfg=TINY_CLIP_VISION)
    assert len(paths) == 3
    assert skipped and all("launch" in m for m in skipped)


def test_ip_adapter_phase_follows_the_selection_phases():
    """Phase 17 (IP-Adapter) exists with its banner and runs after phase 16
    in main(), before the kernels line."""
    import inspect

    smoke = _load_smoke()
    assert "== phase 17: IP-Adapter" in inspect.getsource(smoke.phase_ip_adapter)
    assert "17. IP-Adapter" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_selection(pipe, card)") < main.index("phase_ip_adapter(card)")
            < main.index("kernels_line("))
    assert smoke.IP_PLUS_WIDTHS == dict(embed_dim=1280, hidden_dim=768, depth=4, heads=12, num_queries=16)


TINY_PLUS = dict(embed_dim=32, hidden_dim=64, depth=2, heads=1, num_queries=16)


def test_ip_adapter_writer_round_trips(tmp_path):
    """write_ip_adapter writes one .safetensors file in the published
    layout: ``image_proj.*`` and ``ip_adapter.<idx>.to_{k,v}_ip.weight`` at
    idx 1, 3, ... (one pair per cross-attention layer, in the processor
    order), f16; load_aid_ip_adapter(path) takes it back into the UNet and
    a Plus resampler, and check_ip_loaded agrees."""
    import dataclasses

    import torch

    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.ip_adapter import Resampler
    from aid_tpu_torch.models.params import unet_attention_order
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.utils.safetensors import load_safetensors

    smoke = _load_smoke()
    cfg = dataclasses.replace(configs.TINY_UNET, ip_num_tokens=16, ip_hidden_dim=32)
    unet = smoke.build_sd15(cfg=cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    proj = smoke.seed_adapter_module(Resampler(cfg.cross_attention_dim, **TINY_PLUS), gen)
    path = str(tmp_path / "ip.safetensors")
    written = smoke.write_ip_adapter(path, unet, proj, gen)
    n = len(unet_attention_order(cfg))
    ip_keys = sorted(k for k in written if k.startswith("ip_adapter."))
    assert ip_keys == sorted(f"ip_adapter.{2 * i + 1}.{p}.weight" for i in range(n) for p in ("to_k_ip", "to_v_ip"))
    assert {k.split(".", 1)[1] for k in written if k.startswith("image_proj.")} == set(proj.state_dict())
    on_disk = load_safetensors(path)
    assert set(on_disk) == set(written) and {v.dtype for v in on_disk.values()} == {torch.float16}
    pipe = InterpolationPipeline(unet=unet, vae=None, text_encoder=None, tokenizer=None)
    pipe.load_aid_ip_adapter(path, scale=0.5)
    failures = []
    smoke.fail = failures.append
    smoke.check_ip_loaded("tiny Plus", pipe, written, plus=True)
    assert not failures and pipe.ip_plus and isinstance(pipe.ip_proj, Resampler)
    mid = unet_attention_order(cfg)[-1]  # the mid block last: the highest index
    last = written[f"ip_adapter.{2 * n - 1}.to_k_ip.weight"]
    assert torch.equal(unet.get_submodule(mid).to_k_ip.weight, last.float())
    smoke.check_ip_loaded("tiny Plus, a layer changed", pipe, {**written, ip_keys[0]: -written[ip_keys[0]]}, plus=True)
    assert failures and "did not load back" in failures[0]


def test_ip_adapter_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 17 end to end at the tiny size on the CPU (3 DDIM steps),
    torch.cuda's timing calls stubbed: the files written and loaded, every
    forward check (the sound reading is 0 here, so the bound is set under
    the faults' readings) and both interpolate_single runs pass; only the
    kernel launch counts fail (no kernel runs here)."""
    import torch

    from aid_tpu_torch.models import configs

    smoke = _load_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    skipped = []

    def fail(msg):
        if "launch" not in msg:
            raise AssertionError(msg)
        skipped.append(msg)

    monkeypatch.setattr(smoke, "fail", fail)
    monkeypatch.setattr(smoke, "SD15_STEPS", 3)
    monkeypatch.setattr(smoke, "IP_UNET_TOL", 1e-7)
    paths = smoke.phase_ip_adapter("cpu", unet_cfg=configs.TINY_UNET, text_cfg=configs.TINY_CLIP_TEXT,
                                   vae_cfg=configs.TINY_VAE, vision_cfg=configs.TINY_CLIP_VISION,
                                   plus_widths=TINY_PLUS, device="cpu")
    assert len(paths) == 2
    assert skipped and all("launch" in m for m in skipped)


def test_single_file_phase_follows_the_ip_adapter_phase():
    """Phase 18 (single files, LoRA, textual inversion, prompt embeds,
    exported latents) exists with its banner and runs last in main(),
    before the kernels line; its files go into the checkout's git-ignored
    build/ and are removed; it loads as the app would, with UniPC and
    guidance 10."""
    import inspect

    smoke = _load_smoke()
    src = inspect.getsource(smoke.phase_single_file)
    assert "== phase 18: SD2.1 at 768px from one LDM .safetensors" in src and "18. single file" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_ip_adapter(card)") < main.index("phase_single_file(card)")
            < main.index("kernels_line("))
    assert 'dir=os.path.join(ROOT, "build")' in src and "shutil.rmtree(root" in src
    assert 'prediction_type="v_prediction", guidance_scale=SD21_GUIDANCE' in src
    assert (smoke.LORA_RANK, smoke.LORA_ALPHA, smoke.LORA_SCALE) == (8, 16.0, 0.75)


@pytest.mark.parametrize("preset", ["SD15_UNET", "SD21_UNET", "SDXL_UNET"])
def test_smoke_ldm_map_inverts_the_ports(preset):
    """The smoke's LDM names (written from the LDM layout) and the port's
    converters are each other's inverse on every key of the full-size UNet,
    its VAE and its text towers, built on the meta device: each key maps to
    a distinct LDM name and back to itself; the OpenCLIP towers come back
    with every key and shape (q/k/v packed and split, the projection
    transposed twice)."""
    import torch

    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.params import _ldm_unet_key, _ldm_vae_key, convert_open_clip_text_state_dict
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL

    smoke = _load_smoke()
    cfg = getattr(configs, preset)
    xl = preset == "SDXL_UNET"
    with torch.device("meta"):
        unet = UNet2DCondition(cfg).state_dict()
        vae = AutoencoderKL(configs.SDXL_VAE if xl else configs.SD_VAE).state_dict()
        towers = {"SD15_UNET": [], "SD21_UNET": [configs.OPENCLIP_VIT_H_TEXT],
                  "SDXL_UNET": [configs.SDXL_TEXT_ENCODER_2]}[preset]
        towers = [CLIPTextModel(t).state_dict() for t in towers]
    ldm = {k: smoke.ldm_unet_key(k, cfg) for k in unet}
    assert len(set(ldm.values())) == len(unet)
    assert all(_ldm_unet_key(v, cfg.layers_per_block) == k for k, v in ldm.items())
    assert any(v.startswith("label_emb.0.") for v in ldm.values()) == xl
    vae_ldm = {k: smoke.ldm_vae_key(k, 4) for k in vae}
    assert len(set(vae_ldm.values())) == len(vae) and all(_ldm_vae_key(v, 4) == k for k, v in vae_ldm.items())
    assert "decoder.up.3.block.0.conv1.weight" in vae_ldm.values()  # the decoder's first level, high-res first
    for sd in towers:
        back = convert_open_clip_text_state_dict(smoke.open_clip_text_state_dict(sd))
        assert back.keys() == sd.keys() and all(back[k].shape == sd[k].shape for k in sd)
    full = smoke.ldm_checkpoint(unet, vae, cfg, 4, {})
    assert sum(v.dim() == 4 for k, v in full.items() if ".mid.attn_1." in k) == 8  # the 1x1 convs, both sides


def test_single_file_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 18 end to end at a tiny size on the CPU (3 UniPC steps), with
    the port's SD 2.x presets patched to the tiny configs the written
    directory holds (an SD 2.x file is told by its 1024-wide
    cross-attention, so the tiny text tower keeps that width), torch.cuda's
    timing calls stubbed: every check passes (the bit-equal weights and
    latents, the SDXL round trip, the LoRA merge, textual inversion, the
    embeds and the exported latents; the forward check's sound reading is 0
    here, so the bound is set under the faults'), only the kernel launch
    counts fail (no kernel runs here)."""
    import dataclasses

    import torch

    from aid_tpu_torch.models import configs, loader

    smoke = _load_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    skipped = []

    def fail(msg):
        if "launch" not in msg:
            raise AssertionError(msg)
        skipped.append(msg)

    monkeypatch.setattr(smoke, "fail", fail)
    monkeypatch.setattr(smoke, "SD21_UNET_TOL", 1e-7)
    cfgs = smoke.sd21_diffusers_configs()
    cfgs["unet"].update(block_out_channels=[32, 64], down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                        up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"], attention_head_dim=[2, 2],
                        norm_num_groups=8, sample_size=8)
    cfgs["vae"].update(block_out_channels=[16, 16, 32, 32], layers_per_block=1, norm_num_groups=4)
    cfgs["text_encoder"].update(vocab_size=600, num_hidden_layers=2)
    monkeypatch.setattr(configs, "SD21_UNET", loader.unet_config_from_diffusers(cfgs["unet"]))
    monkeypatch.setattr(configs, "SD_VAE", loader.vae_config_from_diffusers(cfgs["vae"]))
    xl = {"unet": configs.TINY_SDXL_UNET, "vae": configs.TINY_VAE, "text": configs.TINY_CLIP_TEXT,
          "text_2": dataclasses.replace(configs.TINY_CLIP_TEXT, projection_dim=24, hidden_act="gelu")}
    (REPO / "build").mkdir(exist_ok=True)
    before = set(os.listdir(REPO / "build"))
    paths = smoke.phase_single_file("cpu", configs=cfgs, xl_cfgs=xl, device="cpu", steps=3)
    assert len(paths) == 1 and set(paths[0]) >= {"flash_interpolated_attention[D=64]", "conv3x3_same"}
    assert len(skipped) == 4 and all("launch" in m for m in skipped)
    assert set(os.listdir(REPO / "build")) <= before  # the files written are removed


def _stub_cuda_and_fail(monkeypatch, smoke):
    """torch.cuda's timing calls stubbed and every launch-count failure kept
    aside (no kernel runs on the CPU); any other failure raises."""
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    skipped = []

    def fail(msg):
        if "launch" not in msg:
            raise AssertionError(msg)
        skipped.append(msg)

    monkeypatch.setattr(smoke, "fail", fail)
    return skipped


def test_frames_phase_follows_the_single_file_phase():
    """Phase 19 exists with its three banners: (a) right after phase 7 on
    phase 5's program and result, (c) on phase 15's pipeline before it is
    freed, (b) after phase 18, before the kernels line."""
    import inspect

    smoke = _load_smoke()
    assert "== phase 19 (a)" in inspect.getsource(smoke.phase_frames_world_one)
    assert "== phase 19 (b)" in inspect.getsource(smoke.phase_frames)
    assert "== phase 19 (c)" in inspect.getsource(smoke.phase_app)
    assert "19. frames" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_fused(") < main.index("phase_frames_world_one(") < main.index("phase_image(")
            < main.index("phase_selection(pipe, card)") < main.index("phase_app(pipe, card)") < main.index("del pipe")
            < main.index("phase_single_file(card)") < main.index("phase_frames(card)") < main.index("kernels_line("))


def test_frames_world_one_rehearses_on_the_cpu(monkeypatch):
    """Phase 19 (a) at the tiny SDXL size in a gloo world of one on the CPU:
    bit-equal to phase 5's latents, its all-gathers counted."""
    import torch

    from aid_tpu_torch.models.configs import TINY_SDXL_UNET as cfg
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.ops.interp import generate_beta_schedule

    smoke = _load_smoke()
    skipped = _stub_cuda_and_fail(monkeypatch, smoke)
    torch.manual_seed(0)
    unet = UNet2DCondition(cfg).eval()
    g = torch.Generator().manual_seed(1)
    frames, s = 5, cfg.sample_size
    sample = torch.randn((frames, cfg.in_channels, s, s), generator=g)
    ehs, uncond = (torch.randn((frames, 77, cfg.cross_attention_dim), generator=g) for _ in range(2))
    added = {"text_embeds": torch.randn((frames, 24), generator=g),
             "time_ids": torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]]).expand(frames, 6)}
    coef = torch.from_numpy(generate_beta_schedule(frames, 28, 28, force_endpoints=True))
    counts, out = smoke.phase_main(unet, sample, ehs, uncond, added, coef, 2, "cpu")
    got = smoke.phase_frames_world_one(unet, sample, ehs, uncond, added, coef, 2, out, counts, "cpu",
                                       backend="gloo")
    assert got == counts
    assert skipped and all("launch" in m for m in skipped)


def test_frames_world_of_two_rehearses_on_the_cpu(monkeypatch):
    """Phase 19 (b) at the tiny SD size in f32 on the CPU (3 steps, the TP
    run 3): two spawned gloo ranks, every bound with its planted faults;
    only the launch counts (no kernel here) are set aside."""
    import sys

    from aid_tpu_torch.models.configs import TINY_UNET

    smoke = _load_smoke()
    # the ranks import the script by its own name to find their function
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    smoke.__name__ = smoke.frames_rank.__module__ = "chip_smoke"
    monkeypatch.syspath_prepend(str(REPO))
    skipped = _stub_cuda_and_fail(monkeypatch, smoke)
    # the tiny random model barely moves in 3 steps: the bounds at its scale
    # (sound ~5e-8; the smallest planted fault ~4e-5)
    monkeypatch.setattr(smoke, "FRAMES_TOL", 1e-6)
    monkeypatch.setattr(smoke, "FRAMES_TP_TOL", 1e-6)
    import torch

    paths = smoke.phase_frames("cpu", device="cpu", unet_cfg=TINY_UNET, steps=3, dtype=torch.float32)
    assert len(paths) == 3
    assert skipped and all("launch" in m for m in skipped)


def test_app_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 19 (c) on a tiny CPU pipeline: the app's generate through the
    stub gradio gives the example's 7 frames, and gradio stays uninstalled."""
    import sys

    import torch

    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    smoke = _load_smoke()
    skipped = _stub_cuda_and_fail(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "SD15_STEPS", 3)
    torch.manual_seed(0)
    pipe = InterpolationPipeline(
        unet=UNet2DCondition(configs.TINY_UNET).eval(), vae=AutoencoderKL(configs.TINY_VAE).eval(),
        text_encoder=CLIPTextModel(configs.TINY_CLIP_TEXT).eval(),
        tokenizer=HashTokenizer(configs.TINY_CLIP_TEXT.vocab_size), vae_scale_factor=2)
    counts = smoke.phase_app(pipe, "cpu")
    assert "flash_interpolated_attention" in counts and "gradio" not in sys.modules
    assert skipped and all("launch" in m for m in skipped)


def test_f16_phase_follows_the_single_file_phase():
    """Phase 20 (the f16 path) exists with its banner and runs after phase 18
    and before phase 19 (b), which stays last; it writes its SD 1.5
    directory into the checkout's git-ignored build/ and removes it, loads
    it with dtype=torch.float16 as users do and its VAE with load_vae(dtype=
    torch.float16), and checks (a), (b) and (c) with the f16-only guard."""
    import inspect

    smoke = _load_smoke()
    src = inspect.getsource(smoke.phase_f16)
    assert "== phase 20: f16" in src and "20. f16" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_single_file(card)") < main.index("phase_f16(card, args.steps)")
            < main.index("phase_frames(card)") < main.index("kernels_line("))
    assert 'dir=os.path.join(ROOT, "build")' in src and "shutil.rmtree(root" in src
    assert "load_interpolation_pipeline(root, dtype=f16)" in src and "load_vae(os.path.join(root, \"vae\"), dtype=f16)" in src
    assert "build_headline(dtype=f16)" in src
    for check in ("check_unet_vs_plain(", "check_decoder(", "check_fused_vs_plain(", "run_denoise("):
        assert check in src, check
    assert src.count("check_f16_only(") == 7 and '"conv3x3_gnsilu_f16"' in src
    tols = (smoke.F16_SD15_UNET_TOL, smoke.F16_UNET_TOL, smoke.F16_FUSED_UNET_TOL, smoke.F16_VAE_TOL)
    assert all(0 < t < 1e-2 for t in tols)


@pytest.mark.parametrize("dtype", ["f16", "f32"])
def test_dtype_guards_fail_on_another_dtype(dtype):
    """check_f16_only / check_f32_only, fed read_counts()'s names: they pass
    a path that launched its own dtype's kernels only (and, for f16, an
    allowed f32 VAE attention), and fail on any launch of another dtype's
    kernel or on a needed kernel left unlaunched."""
    smoke = _load_smoke()

    class Failed(Exception):
        pass

    def fail(msg):
        raise Failed(msg)

    smoke.fail = fail
    guard = smoke.check_f16_only if dtype == "f16" else smoke.check_f32_only
    counts = {n: 0 for n in smoke.read_counts()}
    needed = (f"flash_interpolated_attention_{dtype}[D=64]", f"conv3x3_same_{dtype}")
    for n in needed + (f"flash_interpolated_attention_{dtype}",):
        counts[n] = 3
    guard("rehearsal", counts, needed)
    others = [n for d, names in smoke.KERNELS_BY_DTYPE.items() if d != dtype for n in names]
    assert len(others) == 8 and set(others) <= set(counts)
    for name in others:
        with pytest.raises(Failed, match="another dtype"):
            guard("rehearsal", {**counts, name: 1}, needed)
    with pytest.raises(Failed, match="not launched"):
        guard("rehearsal", {**counts, f"conv3x3_same_{dtype}": 0}, needed)
    if dtype == "f16":  # the f32 VAE's attention, where the loader keeps the VAE in f32
        guard("rehearsal", {**counts, "flash_self_attention_f32": 1}, needed, allowed=("flash_self_attention_f32",))


def test_wide_heads_phase_follows_the_f16_phase():
    """Phase 21 (SD 1.x at D = 320) exists with its banner and runs after
    phase 20 and before phase 19 (b); its directory is SD 1.5's with the list
    attention_head_dim [1, 2, 4, 4], which the port's loader reads as head
    counts: 320 channels a head at every level, SD 1.5's config otherwise.
    Phase 3 times the D=161-512 endpoint entries at its shapes."""
    import inspect

    from aid_tpu_torch.models import configs, loader

    smoke = _load_smoke()
    src = inspect.getsource(smoke.phase_wide_heads)
    assert "== phase 21: SD1.x at D=320" in src and "21. D=320" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_f16(card, args.steps)") < main.index("phase_wide_heads(card)")
            < main.index("phase_frames(card)") < main.index("kernels_line("))
    assert 'dir=os.path.join(ROOT, "build")' in src and "shutil.rmtree(root" in src
    for check in ("check_unet_vs_plain(", "check_wide_only(", "run_image_path(", "coef_swapped", "own_dropped",
                  "key_tail_unmasked"):
        assert check in src, check
    cfg = loader.unet_config_from_diffusers(smoke.sd15_wide_head_configs()["unet"])
    assert cfg == dataclasses.replace(configs.SD15_UNET, num_attention_heads=(1, 2, 4, 4))
    assert [c // h for c, h in zip(cfg.block_out_channels, cfg.num_attention_heads)] == [320] * 4
    assert "safety_checker" not in smoke.sd15_wide_head_configs()
    kernels = inspect.getsource(smoke.phase_kernels)
    assert "wide_cases" in kernels and '"pure_inner", "self")' in kernels and "d512_launch(q, k, v)" in kernels


def test_one_head_phase_follows_the_wide_heads_phase():
    """Phase 22 (SD 1.x with one head a level) exists with its banner and
    runs after phase 21 and before phase 19 (b); its directory is SD 1.5's
    with attention_head_dim [1, 1, 1, 1]: head dims 320 / 640 / 1280 / 1280,
    SD 1.5's config otherwise. Phase 3 times the wide entries at its
    shapes, at 2048 and at a ragged 520, in every mode and dtype."""
    import inspect

    from aid_tpu_torch.models import configs, loader

    smoke = _load_smoke()
    src = inspect.getsource(smoke.phase_one_head_a_level)
    assert "== phase 22: SD1.x with one head a level" in src and "22. one head" in smoke.__doc__
    main = inspect.getsource(smoke.main)
    assert (main.index("phase_wide_heads(card)") < main.index("phase_one_head_a_level(card)")
            < main.index("phase_frames(card)") < main.index("kernels_line("))
    assert 'dir=os.path.join(ROOT, "build")' in src and "shutil.rmtree(root" in src
    for check in ("check_unet_vs_plain(", "check_wide_only(", "run_image_path(", "coef_swapped", "own_dropped",
                  "every_slice_own_chunk", "slice_own_chunk"):
        assert check in src, check
    cfg = loader.unet_config_from_diffusers(smoke.sd15_one_head_configs()["unet"])
    assert cfg == dataclasses.replace(configs.SD15_UNET, num_attention_heads=(1, 1, 1, 1))
    assert [c // h for c, h in zip(cfg.block_out_channels, cfg.num_attention_heads)] == [320, 640, 1280, 1280]
    kernels = inspect.getsource(smoke.phase_kernels)
    assert "dwide_cases" in kernels and "(512, 512, 2048, two, 3)" in kernels and "(1024, 1024, 520" in kernels


def test_key_tail_fault_moves_self_mode_only():
    """Phase 21's self-mode fault: the plain attention in self mode over
    keys padded with zeros to the next multiple of 64 (a last key tile read
    unmasked) moves a 77-key call, leaves a call whose keys fill their tiles
    (64) as it was, and leaves every endpoint mode as it was."""
    import torch

    smoke = _load_smoke()
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain as plain

    g = torch.Generator().manual_seed(4)
    q, k = torch.randn(2, 1, 10, 320, generator=g), torch.randn(2, 1, 77, 320, generator=g)
    fault = smoke.key_tail_unmasked(plain)
    assert not torch.allclose(fault(q, k, k), plain(q, k, k), rtol=1e-2, atol=1e-2)
    assert torch.equal(fault(q, k[:, :, :64], k[:, :, :64]), plain(q, k[:, :, :64], k[:, :, :64]))
    c = torch.tensor([0.3, 0.6])
    assert torch.equal(fault(q, k, k, c, "fused_outer"), plain(q, k, k, c, "fused_outer"))


def test_slice_fault_moves_one_slice():
    """The phase's planted fault changes one output slice of a wide call
    (the first consumer warpgroup's columns: the 64-column chunks 0, 2, 4,
    ...) and nothing else, and leaves a call at D <= 512 as it was; with the
    exchange dropped both warpgroups' slices move."""
    import torch

    smoke = _load_smoke()
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain as plain

    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(3, 1, 12, 640, generator=g), torch.randn(3, 1, 20, 640, generator=g)
    c = torch.tensor([0.0, 0.5, 1.0])
    want = plain(q, k, k, c, "fused_outer")
    got = smoke.slice_own_chunk(plain)(q, k, k, c, "fused_outer")
    for j in range(0, 640, 64):
        moved = not torch.allclose(got[..., j:j + 64], want[..., j:j + 64])
        assert moved == (j // 64 % 2 == 0), j
    got = smoke.every_slice_own_chunk(plain)(q, k, k, c, "fused_outer")  # the exchange dropped: every slice moves
    assert all(not torch.allclose(got[..., j:j + 64], want[..., j:j + 64]) for j in range(0, 640, 64))
    q = q[..., :320]
    assert torch.equal(smoke.slice_own_chunk(plain)(q, q, q, c, "fused_outer"), plain(q, q, q, c, "fused_outer"))


def test_one_head_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 22 end to end at a tiny size on the CPU (one head a level at
    widths 192 / 544: head dims 192, taken by the D=161-512 entries, and 544, by
    the wide ones; 2 DDIM steps), torch.cuda's timing calls stubbed: the
    directory written, loaded and removed, three forwards with their planted
    faults over the bounds (set to the CPU's scale, where both sides run the
    plain versions), the interpolate's 7 frames; only the launch counts (no
    kernel here) are set aside."""
    smoke = _load_smoke()
    skipped = _stub_cuda_and_fail(monkeypatch, smoke)
    for tol in ("SD15_UNET_TOL", "F32_UNET_TOL", "F16_SD15_UNET_TOL"):
        monkeypatch.setattr(smoke, tol, 1e-7)
    cfgs = {k: v for k, v in _tiny_sd15_configs(smoke).items() if k != "safety_checker"}
    cfgs["unet"].update(block_out_channels=[192, 544], attention_head_dim=[1, 1], norm_num_groups=32)
    before = set(os.listdir(REPO / "build")) if (REPO / "build").is_dir() else set()
    paths = smoke.phase_one_head_a_level("cpu", device="cpu", configs=cfgs, steps=2)
    assert len(paths) == 4 and all("flash_interpolated_attention[D=2048]" in p for p in paths)
    assert skipped and all("launch" in m for m in skipped)
    assert set(os.listdir(REPO / "build")) <= before  # the directory written is removed


def test_wide_heads_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 21 end to end at a tiny size on the CPU (heads of 192 at widths
    192 / 384, 2 DDIM steps), torch.cuda's timing calls stubbed: the
    directory written, loaded and removed, three forwards with their planted
    faults over the bounds (the bounds set to the CPU's scale, where both
    sides run the plain versions), a self-mode forward in each dtype with its
    last key tile unmasked over the bound, the interpolate's 7 frames; only
    the launch counts (no kernel here) are set aside."""
    smoke = _load_smoke()
    skipped = _stub_cuda_and_fail(monkeypatch, smoke)
    for tol in ("SD15_UNET_TOL", "F32_UNET_TOL", "F16_SD15_UNET_TOL"):
        monkeypatch.setattr(smoke, tol, 1e-7)
    cfgs = {k: v for k, v in _tiny_sd15_configs(smoke).items() if k != "safety_checker"}
    cfgs["unet"].update(block_out_channels=[192, 384], attention_head_dim=[1, 2])
    before = set(os.listdir(REPO / "build")) if (REPO / "build").is_dir() else set()
    paths = smoke.phase_wide_heads("cpu", device="cpu", configs=cfgs, steps=2)
    assert len(paths) == 7 and all("flash_interpolated_attention[D=512]" in p for p in paths)
    assert skipped and all("launch" in m for m in skipped)
    assert set(os.listdir(REPO / "build")) <= before  # the directory written is removed


def test_static_shift_helpers_rehearse_on_the_cpu():
    """Phase 3's static-shift helpers and the logit-window check at a tiny
    size on the CPU: the window inputs put the row maxes near -23 (cold) and
    past +70 (hot); the planted per-tile-rescale fault equals the plain
    static shift when it has one tile (or no shift to leave in) and is far
    from it over several tiles; the logit window of a dispatch_attention
    call is read and passes, and logits past +70 fail the smoke."""
    import torch

    from aid_tpu_torch.ops.attention import _row_maxes, dispatch_attention
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain

    smoke = _load_smoke()
    assert smoke.STATIC_WINDOW == (-32.0, 70.0)
    gen = torch.Generator().manual_seed(4)
    for hot in (False, True):
        q, k, v, scale = smoke.window_inputs(torch.float32, hot, 2, 2, 300, 64, gen)
        m = _row_maxes(q, k, scale)
        # hot: most rows past +70 over 300 keys (the smoke's thousands reach further)
        assert (m.median() > 70 and m.max() > 100) if hot else ((m > -32) & (m < -15)).all()
    coef = torch.tensor([0.2, 0.7])
    q, k, v = (torch.randn(2, 2, 48, 64, generator=gen) for _ in range(3))
    for mode in ("self", "pure_inner"):
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0)
        assert torch.allclose(smoke.shift_in_rescale_fault(q, k, v, coef, mode, 40.0, 64), want, atol=1e-5)
        zero = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=0.0)
        assert torch.allclose(smoke.shift_in_rescale_fault(q, k, v, coef, mode, 0.0, 16), zero, atol=1e-5)
        far = (smoke.shift_in_rescale_fault(q, k, v, coef, mode, 40.0, 16) - want).abs().max()
        assert far > 0.1 * want.abs().max()
    with smoke.logit_window("a tiny call"):
        dispatch_attention(q, k, v, coef, "fused_outer")
    with pytest.raises(SystemExit):
        with smoke.logit_window("a hot call"):
            dispatch_attention(q * 100, k, v, coef, "self")


@pytest.mark.parametrize("mode", ["fused_outer", "pure_outer", "fused_inner", "pure_inner", "self"])
def test_split_normalised_fault_rehearses_on_the_cpu(mode):
    """Phase 3's planted fault for the wide kernels' static combine step at a
    tiny size on the CPU: with one split it is the plain static shift (skip
    rows, shared endpoints of their own length, the inner modes' lerp), and
    with the key stream in several splits (each normalised alone) it is far
    from it."""
    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain

    smoke = _load_smoke()
    gen = torch.Generator().manual_seed(6)
    coef = torch.tensor([0.0, 0.3, 0.8, 1.0])
    q, k, v = (torch.randn(4, 2, 24, 32, generator=gen) for _ in range(3))
    kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, 4)}
    if mode != "self":
        kw.update({n: torch.randn(2, 20, 32, generator=gen) for n in ("k_begin", "v_begin", "k_end", "v_end")})
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0, **kw)
    one = smoke.split_normalised_fault(q, k, v, coef, mode, kw, 40.0, 8, 1)
    assert torch.allclose(one, want, atol=1e-5)
    far = (smoke.split_normalised_fault(q, k, v, coef, mode, kw, 40.0, 8, 3) - want).abs().max()
    assert far > 0.1 * want.abs().max()
