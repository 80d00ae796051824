"""Build a checkout's CUDA kernels and print ptxas's resources per kernel.

    python3 tools/ptxas_report.py [--root DIR]

Compiles ``aid_tpu_torch/csrc/*.cu`` of the checkout at ``--root`` (default:
this one) with the flags of that checkout's own ``ops/_build.py`` (nvcc
``-Xptxas -v``, one process per source, all at once; the objects are thrown
away) and prints one line per kernel: its demangled name
(``c++filt`` where the toolkit's host has it), registers, spill stores and
loads in bytes, ptxas's performance remarks on it (say C7513: its wgmma
serialised), and its source. Run it on the parent unpacked under
``build/`` and on this checkout in one call to hold a change of the sources
against the registers and spills of every kernel that was there before. The
last line is one JSON object {kernel: [registers, spill stores, spill
loads, remark codes...]}. Needs nvcc (the CUDA toolkit); no card is used.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path


def parse(report: str) -> dict:
    """{mangled kernel: [registers, spill store bytes, spill load bytes, source, remark codes]} from ptxas
    -v output; a remark is a "Potential Performance Loss" line naming the kernel (C7513: wgmma serialised)."""
    kernels, name, source = {}, None, "?"
    for line in report.splitlines():
        m = re.search(r"\((C\d+)\) Potential Performance Loss: .* in the function '(\w+)'", line)
        if m:
            kernels.setdefault(m.group(2), [None, 0, 0, source, []])[4].append(m.group(1))
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            kernels.setdefault(name, [None, 0, 0, source, []])[1:3] = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.setdefault(name, [None, 0, 0, source, []])[0] = int(m.group(1))
    return kernels


def demangle(names: list) -> dict:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.split("\n")
    return {n: (d or n) for n, d in zip(names, out)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose kernels are built (default: this one)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from aid_tpu_torch.ops import _build

    reports, nvcc = {}, _build._nvcc()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        # one nvcc per source, all at once, ptxas -v each: every kernel keeps the file it came from
        procs = {src: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(Path(tmp) / f"{src.stem}.o"),
                                        str(src)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for src in _build.sources()}
        for src, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {src.name}:\n{err}")
            for name, row in parse(err).items():
                row[3] = src.name
                reports[name] = row
    names = demangle(sorted(reports))
    for mangled in sorted(reports, key=lambda n: (reports[n][3], names[n])):
        regs, st, ld, src, remarks = reports[mangled]
        note = f" ({', '.join(sorted(set(remarks)))}: performance remarks)" if remarks else ""
        print(f"{src:40s} {regs} registers, {st} bytes spill stores, {ld} bytes spill loads{note}  {names[mangled]}",
              flush=True)
    print(f"the kernels of {root}", flush=True)
    print(json.dumps({names[n]: reports[n][:3] + sorted(set(reports[n][4])) for n in sorted(reports)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
