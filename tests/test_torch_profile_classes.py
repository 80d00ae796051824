"""The step profiler's kernel classes (tools/torch_profile_step.py) against the port's kernels.

Each kernel's demangled name, as a trace of the card shows it, is built from
the template instances the host code of ``aid_tpu_torch/csrc/*.cu`` launches
(element types, head dims, modes and flags read from the sources' dispatch
lines) and fed to the profiler's class patterns. The set of kernels is read
from the sources' ``__global__`` definitions, so a new kernel without a class
fails here. Needs no card and no nvcc.
"""

import importlib.util
import itertools
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "aid_tpu_torch" / "csrc"


def _profiler():
    spec = importlib.util.spec_from_file_location("torch_profile_step", ROOT / "tools" / "torch_profile_step.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(text: str) -> dict:
    """{kernel: number of template parameters} of a source's __global__ definitions."""
    out = {}
    for m in re.finditer(r"(?:template <([^>]*)>\s*)?__global__ void __launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*"
                         r"(\w+)\(", text):
        out[m.group(2)] = 0 if m.group(1) is None else len(m.group(1).split(","))
    return out


def _all(pattern: str, text: str) -> list:
    return sorted(set(re.findall(pattern, text)), key=str)


def _source_text(name: str) -> str:
    """A source's text; a static-shift source (``#define AID_STATIC_SHIFT 1``
    then ``#include`` of the exact source) gives the source it includes."""
    text = (CSRC / name).read_text()
    m = re.search(r'#define AID_STATIC_SHIFT 1\s+#include "(\w+\.cu)"', text)
    return (CSRC / m.group(1)).read_text() if m else text


def _instances(name: str, text: str) -> list:
    """[(kernel, template arguments)] that the source's host code launches,
    their values read from its dispatch lines; a static-shift source's are
    its included source's where AID_STATIC_SHIFT keeps them (the f32
    kernels' every instance, the 16-bit kernels' bf16 ones, the wide
    kernel's bf16 and f32 ones; the mid-length stream kernel at D = 64 in the
    endpoint modes)."""
    if name.endswith("_static.cu"):
        exact = _instances(name.replace("_static.cu", ".cu"), text)
        if name == "flash_attention_midstream_static.cu":
            return [(k, a) for k, a in exact if a[0] == "__nv_bfloat16" and a[1] == "64" and a[-1] != "0"]
        return [(k, a) for k, a in exact if k in F32_KERNELS or a[0] in ("__nv_bfloat16", "float")]
    types = _all(r"(?:entry|conv|entry_interp)<(__nv_bfloat16|__half|float)>", text)
    dims = _all(r"case (\d+): return launch_d<", text)
    modes = _all(r"launch(?:_interp)?<[^<>]*?(true|false), (\d)>", text)
    if name == "flash_interpolated_attention.cu":
        return [("flash_kernel", (t, d, *m)) for t in types for d in dims for m in modes]
    if name == "flash_interpolated_attention_f32.cu":
        return [("flash_f32_kernel", (d, *m)) for d in dims for m in modes]
    if name == "flash_attention_bf16_d512.cu":
        return [("flash16_d512_kernel", (t,)) for t in types]
    if name == "flash_attention_f32_d512.cu":
        return [("flash_f32_d512_kernel", ())]
    if name == "flash_attention_dmid.cu":
        layouts = {"true": "flash16_dmid_rows_kernel", "false": "flash16_dmid_split_kernel"}
        chunks = _all(r"return launch_modes<T, (\d), (true|false)>", text)
        modes = _all(r"return launch_rows<T, NC, (true|false), (\d)>", text)
        return [(layouts[rows], (t, nc, *m)) for t in types for nc, rows in chunks for m in modes]
    if name == "flash_attention_dmid_f32.cu":
        tiles = _all(r"return launch_modes<(\d), (\d+)>", text)  # (M blocks a warpgroup, keys a tile)
        modes = _all(r"return launch<MBW, BK, (true|false), (\d)>", text)
        return [("flash_f32_dmid_kernel", (*mt, *m)) for mt in tiles for m in modes]
    if name == "flash_attention_onepass.cu":  # the instances whose stream and one warpgroup's ring fit (kFits)
        from aid_tpu_torch.ops.flash_attention import onepass_tiles

        kts = _all(r"case (\d+): return launch_fit<T, D, (\d+)>", text)
        assert all(a == b for a, b in kts)
        return [("onepass_kernel", (t, d, kt)) for t in types for d in dims for kt, _ in kts
                if onepass_tiles(int(d), 16 * int(kt), 16, "self") is not None]
    if name == "flash_attention_midstream.cu":  # (warpgroups, IDLE) as the dispatch picks them, by NSETS
        from aid_tpu_torch.ops.flash_attention import MIDSTREAM_TILES

        sets = _all(r"case (\d): return launch_sets<T, D, \1>", text)
        shapes = _all(r"launch<T, D, (\d|NWG), (true|false), NSETS>", text)  # NWG: the head dim's most (kMaxWG)
        most = {d: str(MIDSTREAM_TILES[int(d)][3]) for d in dims}
        return [("midstream_kernel", (t, d, most[d] if w == "NWG" else w, idle, n)) for t in types for d in dims
                for w, idle in shapes for n in sets if w == "NWG" or int(w) <= int(most[d])]
    if name == "flash_attention_dwide.cu":
        tiles = re.findall(r"return launch<T, (\d+), f32 \? (\d+) : (\d+)>", text)  # (chunks, f32 rows, 16-bit rows)
        return [("flash_dwide_kernel", (t, nc, rf if t == "float" else r16)) for t in types for nc, rf, r16 in tiles] + [
            ("flash_dwide_combine_kernel", (t,)) for t in types]
    if name == "conv3x3.cu":
        return [("conv3x3_kernel", (t, g)) for t in types for g in _all(r"return launch<T, (true|false)>", text)] + [
            ("blocked_kernel", (v,)) for v in _all(r"blocked_kernel<(true|false)><<<", text)]
    if name == "conv3x3_f32.cu":
        vec = _all(r"blocked_f32_kernel<(true|false), kPro><<<", text)
        pro = _all(r"return launch_blocked<(true|false)>", text)
        return [("conv3x3_f32_kernel", ())] + [("blocked_f32_kernel", vp) for vp in itertools.product(vec, pro)]
    raise AssertionError(f"{name}: a source the profiler's classes do not know")


# the f32 attention kernels: a static-shift source keeps all their instances
F32_KERNELS = ("flash_f32_kernel", "flash_f32_dmid_kernel", "flash_f32_d512_kernel")


def _demangled(kernel: str, args: tuple, static: bool = False) -> str:
    """The kernel's name as the card's trace shows it (demangled, its
    parameters elided); a static-shift instance's in its namespace
    ``static_shift``."""
    targs = f"<{', '.join(args)}>" if args else ""
    ns = "(anonymous namespace)::static_shift::" if static else "(anonymous namespace)::"
    return f"void {ns}{kernel}{targs}(CUtensorMap_st, {ns}Params)"


def _expected(kernel: str, args: tuple) -> str:
    """The class each kernel belongs to: the attention's mode from its
    HAS_OWN, NSETS arguments (the last two), the D=512 self kernels, the wide
    kernel and its combine step, the convs and their layout passes."""
    if kernel in ("flash_kernel", "flash_f32_kernel", "flash16_dmid_rows_kernel", "flash16_dmid_split_kernel",
                  "flash_f32_dmid_kernel"):
        return {("true", "2"): "attention kernel, fused_outer",
                ("true", "0"): "attention kernel, self and cross"}.get(args[-2:], "attention kernel, other modes")
    if kernel == "onepass_kernel":
        return "attention kernel, short key streams"
    if kernel == "midstream_kernel":
        return {"2": "attention kernel, mid-length streams, outer modes",
                "0": "attention kernel, mid-length streams, self"}.get(args[-1],
                                                                      "attention kernel, mid-length streams, inner modes")
    if kernel in ("flash16_d512_kernel", "flash_f32_d512_kernel"):
        return "attention kernel, D=512 self (VAE)"
    if kernel in ("flash_dwide_kernel", "flash_dwide_combine_kernel"):
        return "attention kernel, head dims past 512"
    if kernel in ("conv3x3_kernel", "conv3x3_f32_kernel"):
        return "conv kernel"
    assert kernel in ("blocked_kernel", "blocked_f32_kernel"), kernel
    return "conv layout pass"


SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))


@pytest.mark.parametrize("source", SOURCES)
def test_every_kernel_of_a_source_has_its_class(source):
    """Every kernel a source defines is launched at the instances read from
    its dispatch lines (template arguments as many as its parameters), and
    each instance's demangled name lands in its class, never in the
    elementwise catch-all."""
    text = _source_text(source)
    defined = _kernels(text)
    instances = _instances(source, text)
    assert defined and {k for k, _ in instances} == set(defined), (source, defined)
    assert all(len(args) == defined[k] for k, args in instances), source
    classes = _profiler().CLASSES
    for kernel, args in instances:
        name = _demangled(kernel, args, static=source.endswith("_static.cu"))
        got = next(n for n, pat in classes if pat.search(name))
        assert got == _expected(kernel, args), (name, got)


def test_modes_and_instances_cover_the_kernels():
    """The sources' dispatch gives what the port launches: the five modes of
    the D <= 160 kernels at four head dims in three types, the four endpoint
    modes and self mode at D = 161-512 (bf16 and f16: 3, 4 and 5 chunks with
    a warpgroup over its own rows, 3 and 4 chunks a warpgroup with D split;
    f32: four tilings), four wide instances a type with their combine
    steps, the short-stream kernel's instances whose stream fits beside one
    warpgroup's Q/O ring, the mid-length stream kernel's by mode kind; and
    the static-shift instances (bf16 and f32 at D <= 160 in every mode, the
    bf16 mid-length stream kernel at D = 64 in the endpoint modes, bf16 and
    f32 at D = 161-512 in every mode and self mode, the D=512 self kernels in
    bf16 and f32, the wide kernel's four instances and combine step in bf16
    and f32)."""
    counts = {}
    for source in SOURCES:
        for kernel, _ in _instances(source, _source_text(source)):
            counts[kernel] = counts.get(kernel, 0) + 1
    # the static-shift instances: bf16 and f32 at four head dims in five modes
    assert counts["flash_kernel"] == 2 * 4 * 5 + 4 * 5 and counts["flash_f32_kernel"] == 2 * 4 * 5
    # and bf16 (3 + 2 chunk counts) and f32 (four tilings) at D = 161-512 in five modes, the D=512 self kernels'
    assert counts["flash16_dmid_rows_kernel"] == 2 * 3 * 5 + 3 * 5
    assert counts["flash16_dmid_split_kernel"] == 2 * 2 * 5 + 2 * 5
    assert counts["flash_f32_dmid_kernel"] == 2 * 4 * 5
    assert counts["flash16_d512_kernel"] == 2 + 1 and counts["flash_f32_d512_kernel"] == 1 + 1
    # the wide kernel: four instances and the combine step in three types, and their static bf16 and f32 ones
    assert counts["flash_dwide_kernel"] == 3 * 4 + 2 * 4 and counts["flash_dwide_combine_kernel"] == 3 + 2
    assert counts["conv3x3_kernel"] == 2 * 2 and counts["blocked_f32_kernel"] == 4
    # the short-stream kernel: five stream sizes at four head dims in two types, but 15 tiles at D=160
    assert counts["onepass_kernel"] == 2 * (4 * 5 - 1)
    # the mid-length stream kernel: three NSETS in two types, three warpgroups (with and without idle
    # warpgroups) at D = 64, two at 80
    assert counts["midstream_kernel"] == 2 * 3 * (2 + 1) + 2 * 2  # + static: bf16 D = 64, NSETS 1 and 2, idle or not


def test_library_kernels_keep_their_classes():
    """Names of library kernels still land in the library classes, and
    anything else in the catch-all."""
    classes = _profiler().CLASSES

    def cls(name):
        return next(n for n, pat in classes if pat.search(name))

    assert cls("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc") == "cuDNN convs"
    assert cls("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT") == "cuBLAS GEMMs"
    assert cls("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>") == "GroupNorm / LayerNorm"
    assert cls("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>") == (
        "elementwise and other")
