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
