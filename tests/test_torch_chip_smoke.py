"""chip_smoke.py's import preamble, on the CPU.

The script must run the package that lies beside it from any working
directory, also under PYTHONSAFEPATH, and must fail (with no result line)
where it lies alone. Neither check imports torch: the preamble only sets the
import path, and the lone script stops before its first phase.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

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
                "conv3x3_same_f32")


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
    for i, name in enumerate(KERNEL_NAMES):
        lib = None if name.startswith("flash_interpolated") or name == "conv3x3_gnsilu" else 0.5 + i
        records[name] = {"max_abs_err": 1e-3 * i, "ms": 1.0 + i, "plain_ms": 2.0 + i, "bound_ms": 0.25 * (i + 1),
                         "bound_by": "operations", "library_ms": lib, "library": lib and "cudnn channels_last"}
        records[name]["kernel_ms"] = 0.5 + i
    launches = {f"{k}[D={d}]": 3 for k in ("flash_interpolated_attention", "flash_interpolated_attention_f32")
                for d in (40, 64, 80, 160)}
    launches.update({c: 3 for c in ("flash_self_attention_f32", "flash_self_attention_bf16", "conv3x3_same",
                                    "conv3x3_gnsilu", "conv3x3_same_f32")})
    entries = json.loads(smoke.kernels_line(records, launches))["kernels"]
    assert [e["name"] for e in entries] == list(KERNEL_NAMES)
    for e, name in zip(entries, KERNEL_NAMES):
        assert tuple(e)[:len(smoke.KERNEL_KEYS)] == smoke.KERNEL_KEYS
        assert e["route"] == "cuda" and e["bound_by"] in ("bytes", "operations")
        assert e["bound_ms"] == records[name]["bound_ms"] and e["library_ms"] == records[name]["library_ms"]
        assert e["ms"] == records[name]["ms"]
        if name.startswith("conv"):
            for part in ("ms: through the wrapper", "kernel_ms: the conv launch alone", "layout_ms: the layout kernel"):
                assert part in e["contract"]
        if name.startswith("conv") or name.startswith("flash_interpolated") or name == "flash_self_attention_bf16":
            assert e["kernel_ms"] == records[name]["kernel_ms"]
        if name.startswith("flash_interpolated") or name == "flash_self_attention_bf16":
            for part in ("ms: through the wrapper", "kernel_ms: the launch alone"):
                assert part in e["contract"]
        assert (REPO / e["source"]).is_file()
        path, line = e["replaces"].split(":")
        assert path.startswith("aid_tpu/") and (REPO / path).is_file() and int(line) > 0
    assert entries[1]["launches"] == 9  # the bf16 kernel at D = 40, 80 and 160
    assert entries[3]["launches"] == 3 and entries[3]["source"].endswith("flash_attention_bf16_d512.cu")
    # the f32 instances: their own sources and launch counts
    by_name = {e["name"]: e for e in entries}
    assert by_name["flash_interpolated_attention_f32"]["source"].endswith("flash_interpolated_attention_f32.cu")
    assert by_name["flash_interpolated_attention_f32"]["launches"] == 3
    assert by_name["flash_interpolated_attention_f32(D=40/80/160)"]["launches"] == 9
    assert by_name["conv3x3_same_f32"]["source"].endswith("conv3x3_f32.cu")
    assert by_name["conv3x3_same_f32"]["launches"] == 3 and by_name["conv3x3_same_f32"]["replaces"].endswith(":30")


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
