"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc (the kernels build at first
use) and skip elsewhere. This file imports neither jax nor the JAX package,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Shapes are small and ragged on purpose (tails of every tile size, per-row
and shared endpoints, skip rows); chip_smoke.py checks the main path's shapes.
"""

import pytest
import torch
import torch.nn.functional as F

from aid_tpu_torch.models.layers import per_row_endpoints, skip_mask
from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention
from aid_tpu_torch.ops.conv import (
    conv3x3_gnsilu,
    conv3x3_gnsilu_f16,
    conv3x3_gnsilu_f32,
    conv3x3_gnsilu_plain,
    conv3x3_same,
    conv3x3_same_f16,
    conv3x3_same_f32,
)
from aid_tpu_torch.ops.flash_attention import (
    KERNEL_F32_TILES,
    flash_interpolated_attention,
    flash_interpolated_attention_f16,
    flash_interpolated_attention_f32,
    flash_interpolated_attention_plain,
    flash_self_attention_bf16,
    flash_self_attention_f16,
    flash_self_attention_f32,
    padded_head_dim,
    takes_d512_self,
    takes_midstream,
    takes_onepass,
)
from aid_tpu_torch.ops.flash_attention import DWIDE, instance_head_dim, takes_d512_self
from aid_tpu_torch.ops.routing import reference_ops

pytestmark = pytest.mark.cuda

MODES = [m.value for m in AttnMode]

# bf16 inputs and output: the kernel and the plain version round P to bf16 at
# different points (unnormalized tile probabilities vs normalized softmax)
# and sum in another order; each output also rounds once to bf16 (2^-9 of
# its size). 2% of max |ref| is a few bf16 ulps at the largest outputs.
ATTN_RTOL = 2e-2
# bf16 conv, f32 accumulation on both sides: one rounding of the output
# (relative 2^-8) plus order differences; relative to max |ref|.
CONV_RTOL = 1e-2
# f32 attention with 3xTF32 products in the kernel and full-f32 matmuls in
# the plain version (TF32 off, set in the fixture): the dropped lo*lo terms
# (~2^-22 relative), summation order and exp2 vs exp, ~1e-6 of max |ref|
# over thousands of keys. 1e-4 leaves margin; plain TF32 (~1e-3) or a wrong
# mask, scale or tile would not pass.
F32_ATTN_RTOL = 1e-4
# f32 conv with 3xTF32 products and f32 sums of each K chunk in the kernel,
# cuDNN in full f32 on the other side (TF32 off): the dropped lo*lo terms and
# summation order, ~1e-6 of max |ref| at K = 9 * 960. 1e-4 as for the f32
# attention; plain TF32 (~4e-4 at that K) or a wrong tap would not pass.
F32_CONV_RTOL = 1e-4
# f16 inputs and output: the bf16 design's roundings (P, the output) at f16's
# 2^-11 relative instead of bf16's 2^-8, eight times finer; a quarter of the
# bf16 bound keeps twice that scaling as margin. A wrong mask, scale, tile
# or element type (f16 bits read as bf16) is tens of percent.
F16_ATTN_RTOL = 5e-3
# f16 conv, f32 accumulation on both sides: as CONV_RTOL at f16's finer
# output rounding.
F16_CONV_RTOL = 2.5e-3

# by dtype: the D <= 160 attention wrapper whose counters its launches land
# in, the D=512 one, and the attention's bound against the plain version
ATTN_WRAPPER = {torch.bfloat16: flash_interpolated_attention, torch.float16: flash_interpolated_attention_f16,
                torch.float32: flash_interpolated_attention_f32}
D512_WRAPPER = {torch.bfloat16: flash_self_attention_bf16, torch.float16: flash_self_attention_f16,
                torch.float32: flash_self_attention_f32}
ATTN_RTOLS = {torch.bfloat16: ATTN_RTOL, torch.float16: F16_ATTN_RTOL, torch.float32: F32_ATTN_RTOL}
DTYPES = dict(argvalues=[torch.bfloat16, torch.float32, torch.float16], ids=["bf16", "f32", "f16"])


def _attn_err(got, want):
    """max |got - want| / max |want|"""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False  # f16 plain versions reduce in f32
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, seed, dtype=torch.bfloat16):
    return torch.randn(shape, generator=_gen(seed), device="cuda", dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 100, 100, None, None),     # rows 0 / B-1 as endpoints, ragged q and kv tails
    (4, 3, 130, 77, 77, 3),           # cross-like: 77 keys, shared 77-token endpoints
    (2, 2, 64, 64, 23, 4),            # per-row endpoints of their own length
])
def test_flash_kernel_matches_plain(dev, mode, B, H, S, L, Le, ep):
    q, k, v = _randn((B, H, S, 64), 1), _randn((B, H, L, 64), 2), _randn((B, H, L, 64), 3)
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, 64) if ep == 3 else (B, H, Le, 64)
        eps = {n: _randn(shape, 10 + i) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before = flash_interpolated_attention.launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _attn_err(got, want) < ATTN_RTOL


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 100, 100, None, None),     # rows 0 / B-1 as endpoints, ragged q and kv tails
    (4, 3, 130, 77, 77, 3),           # cross-like: 77 keys, shared 77-token endpoints
    (2, 2, 64, 64, 23, 4),            # per-row endpoints of their own length
])
def test_flash_kernel_head_dims_match_plain(dev, D, mode, B, H, S, L, Le, ep):
    """SD1.x's head dims: 40 (Q K^T over 48 columns, the pad zero-filled by
    the tensor map), 80 (two 64-column boxes), and 160 (three boxes, 64-row
    q tiles, one accumulator set of 160 columns). The operands are (B, S, H*D) projections viewed as
    (B, H, S, D), as the model passes them, so each row's columns past D
    are the next head's: a kernel that read them would disagree."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 1))
    k, v = heads(_randn((B, L, H * D), 2)), heads(_randn((B, L, H * D), 3))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 10 + i) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before, before_d = flash_interpolated_attention.launches, flash_interpolated_attention.launches_by_head_dim[D]
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before + 1
    assert flash_interpolated_attention.launches_by_head_dim[D] == before_d + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOL
    # the strided views and contiguous copies give the same bits
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 200, 129, None, None),   # Sq past one q tile (192, 128 or 64 rows), 129 keys: a 1-key last tile
    (2, 3, 77, 77, 23, 4),          # 77 keys and queries (one tile), per-row endpoints of 23 keys
    (4, 2, 130, 77, 129, 3),        # shared 3D endpoints of 129 keys
])
def test_flash_kernel_tile_edges(dev, D, mode, B, H, S, L, Le, ep):
    """The edges of the kernel's tiles at every head dim and mode: q tails
    of the q tile (192 rows at D=40/64, 128 at D=80, 64 at D=160), KV
    segments around one 128-key tile (two 64-key tiles at D=160),
    per-row and shared endpoints, skip rows at both ends; operands are the
    model's (B, S, H*D) views, and equal contiguous copies bit for bit."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 81))
    k, v = heads(_randn((B, L, H * D), 82)), heads(_randn((B, L, H * D), 83))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 90 + i) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


def test_flash_kernel_launch_alone_repeats(dev):
    """kernel_launch prepares the operands once; each call of its launch
    writes the same result into the same buffer, and counts nothing."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    q, k, v = _randn((3, 2, 150, 64), 84), _randn((3, 2, 90, 64), 85), _randn((3, 2, 90, 64), 86)
    coef = torch.tensor([0.0, 0.4, 1.0], device=dev)
    before = flash_interpolated_attention.launches
    out, launch = kernel_launch(q, k, v, coef, "fused_outer")
    launch()
    first = out.clone()
    launch()
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before
    assert torch.equal(out, first)
    assert torch.equal(out, flash_interpolated_attention(q, k, v, coef, "fused_outer"))


def test_flash_kernel_strided_heads(dev):
    """(B, S, H*D) projections viewed as (B, H, S, D) go in without a copy.

    Only the addressing differs from contiguous operands, so the kernel's
    result on the strided views must equal, bit for bit, its result on
    contiguous copies; a stride read wrongly anywhere breaks that."""
    B, S, H = 3, 96, 4
    coef = torch.tensor([0.0, 0.5, 1.0], device=dev)
    x = _randn((B, S, H * 64), 20)
    q = x.view(B, S, H, 64).transpose(1, 2)
    assert not q.is_contiguous()
    got = flash_interpolated_attention(q, q, q, coef, "fused_outer")
    qc = q.contiguous()
    assert torch.equal(got, flash_interpolated_attention(qc, qc, qc, coef, "fused_outer"))
    want = flash_interpolated_attention_plain(q, q, q, coef, "fused_outer")
    assert _attn_err(got, want) < ATTN_RTOL


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    """On a CUDA tensor a dtype, head dim or mode with no kernel instance
    raises: no quiet fallback to the plain version. f32 at a UNet head dim
    has its instance: it launches the f32 kernel and matches the plain
    version. A head dim with no instance of its own (48) pads to the next
    (64) in bf16 and f32: one launch each, counted under D=64, matching the
    plain version at D=48. f32 at D = 512 outside self mode launches the
    f32 D=161-512 endpoint entry, counted under D=512, and matches the plain
    version."""
    q = _randn((2, 2, 64, 64), 30, torch.float32)
    before = flash_interpolated_attention_f32.launches
    got = flash_interpolated_attention(q, q, q)
    torch.cuda.synchronize()
    assert flash_interpolated_attention_f32.launches == before + 1
    assert _attn_err(got, flash_interpolated_attention_plain(q, q, q)) < F32_ATTN_RTOL
    with pytest.raises(NotImplementedError):  # f64 has no instance
        flash_interpolated_attention(q.double(), q.double(), q.double())
    q = _randn((2, 2, 64, 48), 31)  # a head dim with no kernel instance of its own: padded to 64
    for fn, x, rtol in ((flash_interpolated_attention, q, ATTN_RTOL),
                        (flash_interpolated_attention_f32, q.float(), F32_ATTN_RTOL)):
        before = fn.launches_by_head_dim[64]
        got = flash_interpolated_attention(x, x, x)
        torch.cuda.synchronize()
        assert fn.launches_by_head_dim[64] == before + 1
        assert got.shape == x.shape and got.dtype == x.dtype
        assert _attn_err(got, flash_interpolated_attention_plain(x, x, x)) < rtol
    q = _randn((2, 1, 64, 512), 32, torch.float32)
    coef = torch.tensor([0.0, 1.0], device=dev)
    before = flash_interpolated_attention_f32.launches_by_head_dim[512]  # the f32 D=161-512 endpoint entry
    got = flash_interpolated_attention(q, q, q, coef, "fused_outer")
    torch.cuda.synchronize()
    assert flash_interpolated_attention_f32.launches_by_head_dim[512] == before + 1
    assert _attn_err(got, flash_interpolated_attention_plain(q, q, q, coef, "fused_outer")) < F32_ATTN_RTOL
    q = _randn((1, 1, 16, 2056), 39, torch.float32)
    with pytest.raises(NotImplementedError):  # past 2048 nothing pads
        flash_interpolated_attention(q, q, q)
    with pytest.raises(NotImplementedError):
        flash_self_attention_f32(q.to(torch.bfloat16), q.to(torch.bfloat16), q.to(torch.bfloat16))
    x = _randn((1, 12, 8, 8), 33)  # Cin % 8 != 0
    with pytest.raises(NotImplementedError):
        conv3x3_gnsilu(x, _randn((8, 12, 3, 3), 34), _randn((8,), 35), _randn((12,), 36), _randn((12,), 37), 4)
    x = _randn((1, 16, 8, 8), 38, torch.float32)  # the GN+SiLU conv has no f64 instance
    with pytest.raises(NotImplementedError):
        conv3x3_gnsilu(x.double(), _randn((8, 16, 3, 3), 34).double(), _randn((8,), 35, torch.float32),
                       _randn((16,), 36, torch.float32), _randn((16,), 37, torch.float32), 4)
    with pytest.raises(NotImplementedError):  # nor has f64 a conv instance
        conv3x3_same(x.double(), _randn((8, 16, 3, 3), 34).double(), _randn((8,), 35).double())


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D,mode", [(D, m) for D in (16, 32, 48, 100) for m in MODES] + [(200, "self")]
                         + [(D, m) for D in (200, 320) for m in MODES if (D, m) != (200, "self")])
def test_flash_kernels_pad_head_dims(dev, dtype, D, mode):
    """A head dim that no instance takes is zero-padded to the next one that
    does (below 160 to 40/64/80/160 in every mode; past it the D=161-512
    entries take the caller's D, a multiple of 8, in every mode, self mode
    through their instance with no endpoint set) and launches that instance
    once, counted under the instance's head dim (512 for the D=161-512
    entries); the
    result, sliced back to D, matches the plain version at D with the
    unpadded scale: (B, S, H*D) projections viewed as (B, H, S, D), skip
    rows at both ends, shared endpoints (outer and fused inner modes) and
    per-row ones (pure inner), 77 keys and 130 queries ragged against every
    tile."""
    B, H, S, L, Le = 3, 2, 130, 77, 23

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 400 + D, dtype))
    k, v = heads(_randn((B, L, H * D), 401 + D, dtype)), heads(_randn((B, L, H * D), 402 + D, dtype))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if mode != "self":
        shape = (B, H, Le, D) if mode == "pure_inner" else (H, Le, D)
        eps = {n: _randn(shape, 410 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    Dp = padded_head_dim(D, mode)
    if Dp == 512 and mode == "self":
        fn = D512_WRAPPER[dtype]

        def count():
            return fn.launches
    else:
        fn = ATTN_WRAPPER[dtype]

        def count():
            return fn.launches_by_head_dim[instance_head_dim(Dp)]

    before = count()
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert count() == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape == (B, H, S, D) and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]


def _tiny_model(name, dtype):
    """A tiny configuration of the port's UNet (SD1.x-like or SDXL-like:
    head dims 16 and 32) or its VAE (a mid-block attention at D = 32) with
    N(0, 0.02) weights from a seed, on the card, and a call of it on seeded
    inputs: fused_outer AID over 5 frames for the UNets, the decoder for
    the VAE."""
    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL

    dev, frames = torch.device("cuda"), 5
    gen = _gen(500)
    model = (AutoencoderKL(configs.TINY_VAE, device=dev, dtype=dtype) if name == "TINY_VAE"
             else UNet2DCondition(getattr(configs, name), device=dev, dtype=dtype)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    if name == "TINY_VAE":
        z = randn(frames, configs.TINY_VAE.latent_channels, 8, 8)
        return lambda: model.decode(z)
    cfg = model.config
    sample = randn(frames, cfg.in_channels, cfg.sample_size, cfg.sample_size)
    ehs = randn(frames, 77, cfg.cross_attention_dim)
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        added = {"text_embeds": randn(frames, pooled),
                 "time_ids": torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], device=dev).expand(frames, 6)}
    aid = AidContext(coef=torch.linspace(0, 1, frames, device=dev), mode=AidMode.from_name("fused_outer"))
    return lambda: model(sample, torch.tensor(500, device=dev), ehs, aid, added)


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("name", ["TINY_UNET", "TINY_SDXL_UNET", "TINY_VAE"])
def test_tiny_models_run_the_kernels(dev, dtype, name):
    """The repo's tiny configurations run on the card: their head dims (16
    and 32) take the D=40 instance padded, in bf16 and f32, and the output
    through the kernels matches the same model through the plain versions
    (largest per-frame relative L2 under the attention's own bound: 1e-4 in
    f32, 2e-2 in bf16), with the launches counted under D=40 and none at
    another head dim."""
    call = _tiny_model(name, dtype)
    fn = ATTN_WRAPPER[dtype]
    before = dict(fn.launches_by_head_dim)
    with torch.no_grad():
        got = call()
        torch.cuda.synchronize()
        launched = {d: fn.launches_by_head_dim[d] - before[d] for d in before}
        with reference_ops():
            want = call()
    assert launched[40] > 0 and sum(launched.values()) == launched[40]
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    diff = (got.float() - want.float()).flatten(1).norm(dim=1) / want.float().flatten(1).norm(dim=1)
    assert diff.max().item() < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("B,H,S,L", [
    (1, 1, 1000, 1000),   # ragged: not a multiple of the 64-row/16-key tiles
    (1, 1, 4096, 4096),
    (3, 2, 300, 200),     # B > 1, H > 1, fewer keys than queries
    (1, 1, 16384, 16384),  # one 1024px SDXL frame
    (2, 3, 1000, 1000),   # B, H > 1 with ragged tails
    (1, 1, 1, 1),          # one query, one key
    (2, 1, 63, 15),        # one row short of a query tile, one key short of a K/V tile
    (1, 2, 65, 17),        # one past each
    (3, 1, 100, 200),      # more keys than queries
    (1, 1, 64, 16),        # one whole tile of each: no second key tile
    (1, 1, 128, 32),       # two whole key tiles: K and V each refilled once
    (2, 1, 65, 47),        # three key tiles, the last one key short: the K and V slots refilled twice
    (7, 1, 4000, 4000),    # the tiled decode's ragged tile, seven frames
])
def test_flash_f32_d512_kernel_matches_plain(dev, B, H, S, L):
    q = _randn((B, H, S, 512), 50, torch.float32)
    k, v = _randn((B, H, L, 512), 51, torch.float32), _randn((B, H, L, 512), 52, torch.float32)
    before = flash_self_attention_f32.launches
    got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
    torch.cuda.synchronize()
    assert flash_self_attention_f32.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _attn_err(got, want) < F32_ATTN_RTOL


@pytest.mark.parametrize("B,H,S,L", [
    (1, 1, 16384, 16384),  # one 1024px SDXL frame
    (7, 1, 4096, 4096),    # SD 1.5's batched 512px decode, a 512px tile, a 512px encode
    (1, 1, 4000, 4000),    # ragged: not a multiple of the 64-row / 32-key tiles
    (1, 1, 1, 1),          # one query, one key
    (2, 1, 63, 31),        # one row short of a q tile, one key short of a K/V tile
    (1, 2, 65, 33),        # one past each
    (3, 1, 100, 200),      # more keys than queries
    (2, 3, 129, 97),       # B, H > 1, ragged in both
    (1, 1, 64, 32),        # one whole tile of each: no pipelined step
    (1, 1, 128, 64),       # two whole key tiles: one pipelined step, then the last tile
    (2, 1, 65, 95),        # three key tiles, the last one key short, both rings wrapping
])
def test_flash_bf16_d512_kernel_matches_plain(dev, B, H, S, L):
    """The bf16 D=512 self kernel, routed as the bf16 VAE calls it, against
    its plain version; operands are (B, S, H*512) projections viewed as
    (B, H, S, 512), and equal contiguous copies bit for bit."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, 512).transpose(1, 2)

    q = heads(_randn((B, S, H * 512), 53))
    k, v = heads(_randn((B, L, H * 512), 54)), heads(_randn((B, L, H * 512), 55))
    before = flash_self_attention_bf16.launches
    got = flash_interpolated_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_self_attention_bf16.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_self_attention_bf16(*args))


def test_flash_d512_refuses_other_instances(dev):
    """At D=512 the endpoint modes launch the bf16 D=161-512 endpoint entry
    (counted under D=512 on the bf16 wrapper, not on the self kernel's) and
    match the plain version; f64 still raises. An f32 call at a UNet head
    dim has its own kernel: it launches the f32 instance, counted by head
    dim, and matches the plain version."""
    q = _randn((2, 1, 64, 512), 56)
    coef = torch.tensor([0.0, 1.0], device=dev)
    for mode in ("fused_outer", "pure_outer", "fused_inner", "pure_inner"):
        before, self_before = flash_interpolated_attention.launches_by_head_dim[512], flash_self_attention_bf16.launches
        got = flash_interpolated_attention(q, q, q, coef, mode)
        torch.cuda.synchronize()
        assert flash_interpolated_attention.launches_by_head_dim[512] == before + 1
        assert flash_self_attention_bf16.launches == self_before
        assert _attn_err(got, flash_interpolated_attention_plain(q, q, q, coef, mode)) < ATTN_RTOL
        with pytest.raises(NotImplementedError):
            flash_interpolated_attention(q.double(), q.double(), q.double(), coef, mode)
    for D in (40, 64, 80, 160):
        q = _randn((2, 2, 64, D), 57, torch.float32)
        before = flash_interpolated_attention_f32.launches_by_head_dim[D]
        got = flash_interpolated_attention(q, q, q, coef, "fused_outer")
        torch.cuda.synchronize()
        assert flash_interpolated_attention_f32.launches_by_head_dim[D] == before + 1
        assert got.dtype == torch.float32
        assert _attn_err(got, flash_interpolated_attention_plain(q, q, q, coef, "fused_outer")) < F32_ATTN_RTOL


# the D=161-512 endpoint entries' endpoint forms: rows 0 / B-1 of K/V, then
# shared (H, Le, D) and per-row (B, H, Le, D) endpoints of an IP segment's 4
# and 16 tokens and the text's 77, ragged against the 32- and 16-key tiles
D512_INTERP_ENDPOINTS = [("rows", None)] + [(ep, Le) for ep in ("shared", "per_row") for Le in (4, 16, 77)]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D", [192, 200, 320, 384, 448, 512])
@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
@pytest.mark.parametrize("ep,Le", D512_INTERP_ENDPOINTS)
def test_flash_d512_interp_kernels_match_plain(dev, dtype, D, mode, ep, Le):
    """Head dims past 160 in the endpoint modes: one launch of the D=161-512
    endpoint entry of the dtype (aid_flash_attn_{bf16,f16,f32}_dmid) at the
    caller's D, every layout of the kernels (bf16 and f16: 3, 4 and 5
    64-column chunks with warpgroups over their own rows, 6 and 8 with D
    split; f32: 32- and 16-key tiles, 2 to 4 M blocks a warpgroup; D = 200
    ragged against the chunks), counted under D=512 on the dtype's
    interpolating wrapper and on no other kernel, matching the plain
    version: (B, S, H*D) projections viewed as (B, H, S, D) (strided heads),
    skip rows at both ends, 130 queries and 77 own keys ragged against the
    64-row and every key tile."""
    B, H, S, L = 3, 2, 130, 77

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 700 + D, dtype))
    k, v = heads(_randn((B, L, H * D), 701 + D, dtype)), heads(_randn((B, L, H * D), 702 + D, dtype))
    coef = torch.tensor([0.0, 0.35, 1.0], device=dev)
    skip = torch.tensor([True, False, True], device=dev)
    eps = {}
    if ep != "rows":
        shape = (H, Le, D) if ep == "shared" else (B, H, Le, D)
        eps = {n: _randn(shape, 710 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    wrapper = ATTN_WRAPPER[dtype]
    before = dict(wrapper.launches_by_head_dim)
    self_before = D512_WRAPPER[dtype].launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert wrapper.launches_by_head_dim == {**before, 512: before[512] + 1}
    assert D512_WRAPPER[dtype].launches == self_before
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape == (B, H, S, D) and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]


# the wide entries' shapes: ragged head dims (520, one 64-column chunk past
# 512; 1000, under the 1024 instance), SD 1.x's 640 and 1280 with one head a
# level, the widest 2048; 130 queries and 77 own keys ragged against the
# row blocks (32 / 16 in bf16 and f16, 16 / 8 in f32) and the key tile (128
# keys in bf16 and f16, 64 in f32); at B = 3, H = 2 every grid is under one
# wave of blocks, so the key stream is split and merged by the combine step
DWIDE_DIMS = [520, 640, 1000, 1280, 2048]
DWIDE_ENDPOINTS = [("rows", None), ("shared", 77), ("per_row", 16)]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D", DWIDE_DIMS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ep,Le", DWIDE_ENDPOINTS)
def test_flash_dwide_kernels_match_plain(dev, dtype, D, mode, ep, Le):
    """Head dims past 512 in every mode: one launch of the wide entry of the
    dtype (aid_flash_attn_{bf16,f16,f32}_dwide), counted under DWIDE on the
    dtype's interpolating wrapper and on no other kernel, matching the plain
    version at the caller's D: (B, S, H*D) projections viewed as (B, H, S,
    D) (strided heads), skip rows at both ends, 130 queries and 77 own keys
    ragged against every tile, endpoints from the rows or of their own
    length, shared or per row."""
    if ep != "rows" and mode == "self":
        pytest.skip("self mode reads no endpoint")
    B, H, S, L = 3, 2, 130, 77

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 800 + D, dtype))
    k, v = heads(_randn((B, L, H * D), 801 + D, dtype)), heads(_randn((B, L, H * D), 802 + D, dtype))
    coef = torch.tensor([0.0, 0.35, 1.0], device=dev)
    skip = torch.tensor([True, False, True], device=dev)
    eps = {}
    if ep != "rows":
        shape = (H, Le, D) if ep == "shared" else (B, H, Le, D)
        eps = {n: _randn(shape, 810 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    wrapper = ATTN_WRAPPER[dtype]
    before = {fn: dict(fn.launches_by_head_dim) for fn in ATTN_WRAPPER.values()}
    self_before = [fn.launches for fn in D512_WRAPPER.values()]
    kw = {} if mode == "self" else {"skip_endpoints": skip}
    got = flash_interpolated_attention(q, k, v, coef, mode, **kw, **eps)
    torch.cuda.synchronize()
    for fn, counts in before.items():
        assert fn.launches_by_head_dim == ({**counts, DWIDE: counts[DWIDE] + 1} if fn is wrapper else counts)
    assert [fn.launches for fn in D512_WRAPPER.values()] == self_before
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw, **eps)
    assert got.shape == want.shape == (B, H, S, D) and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("B,H,S,L,D", [
    (2, 1, 1024, 1024, 640),   # SD 1.x with one head a level at 32^2
    (2, 1, 256, 256, 1280),    # at 16^2
    (1, 1, 64, 64, 1280),      # the mid block
    (1, 1, 1, 1, 2048),        # one query, one key
    (1, 2, 33, 17, 1152),      # one row past a 32-row block, a ragged key tile, the 1280 instance
])
def test_flash_dwide_kernels_at_path_shapes(dev, dtype, B, H, S, L, D):
    """The wide entries at the path's shapes and at the edges of their
    tiles, in fused_outer and self mode (through flash_self_attention_* as
    the VAE would call it), against the plain version."""
    q, k, v = (_randn((B, H, n, D), 830 + i, dtype) for i, n in enumerate((S, L, L)))
    coef = torch.linspace(0, 1, B, device=dev)
    for mode in ("fused_outer", "self"):
        got = (D512_WRAPPER[dtype](q, k, v) if mode == "self"
               else flash_interpolated_attention(q, k, v, coef, mode))
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode)
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert _attn_err(got, want) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("B,S,L,D,mode,split", [
    (1, 512, 512, 2048, "self", True),           # 32 or 64 row blocks over 8 key tiles
    (7, 64, 64, 1280, "fused_outer", True),      # the mid block: own, begin and end one tile each
    (3, 100, 300, 640, "fused_outer", True),     # 5 own tiles and 5 a set, skip rows past their own segment
    (7, 1024, 1024, 640, "self", False),         # a full grid: no split
])
def test_flash_dwide_kernels_split_key_stream(dev, dtype, B, S, L, D, mode, split):
    """Where the grid of row blocks is under one wave the wide entry splits
    each row block's key stream across blocks and its combine step merges
    them (the split from the wrapper's mirror of the host rule, as the
    workspace is sized); the result matches the plain version, and one
    launch is counted."""
    from aid_tpu_torch.ops.flash_attention import dwide_split, dwide_tiles, kernel_operands

    H = 1
    q, k, v = (_randn((B, H, n, D), 860 + i, dtype) for i, n in enumerate((S, L, L)))
    coef = torch.linspace(0, 1, B, device=dev)
    kw = {} if mode == "self" else {"skip_endpoints": torch.tensor([True] + [False] * (B - 2) + [True], device=dev)}
    ops = kernel_operands(q, k, v, coef, mode, **kw)
    Dp, BQ, BK = dwide_tiles(D, dtype)
    tiles = -(-L // BK) * (3 if mode == "fused_outer" else 1)
    assert ops["splits"] == dwide_split(B * H * -(-S // BQ), tiles) and (ops["splits"] > 1) == split
    wrapper = ATTN_WRAPPER[dtype]
    before = wrapper.launches_by_head_dim[DWIDE]
    got = flash_interpolated_attention(q, k, v, coef, mode, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches_by_head_dim[DWIDE] == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **DTYPES)
def test_flash_d512_self_mode_keeps_its_entries(dev, dtype):
    """Self mode at D = 512 (the VAE's) still takes the D=512 self kernels:
    one launch of the self entry, none of the D=161-512 one; at 192 and 320
    (a 320-wide UNet's unconditional pass) self mode takes the D=161-512
    entry's self instance instead, counted under D=512 on the interpolating
    wrapper, whether the call comes through the interpolating wrapper or the
    self-attention one; each matches the plain version."""
    for D in (192, 320, 512):
        q = _randn((2, 1, 100, D), 720 + D, dtype)
        k, v = _randn((2, 1, 77, D), 721 + D, dtype), _randn((2, 1, 77, D), 722 + D, dtype)
        for fn in (flash_interpolated_attention, D512_WRAPPER[dtype]):
            before, self_before = ATTN_WRAPPER[dtype].launches_by_head_dim[512], D512_WRAPPER[dtype].launches
            got = fn(q, k, v)
            torch.cuda.synchronize()
            assert D512_WRAPPER[dtype].launches == self_before + (D == 512)
            assert ATTN_WRAPPER[dtype].launches_by_head_dim[512] == before + (D != 512)
            assert _attn_err(got, flash_interpolated_attention_plain(q, k, v)) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D", [192, 200, 320, 384, 448, 504])
@pytest.mark.parametrize("B,H,S,L", [(3, 2, 130, 77), (7, 2, 1024, 333), (1, 1, 1, 1)])
def test_flash_dmid_self_instance_matches_plain(dev, dtype, D, B, H, S, L):
    """Self mode at 161-511 (f32 to 448, its DMID_SELF_MAX; past it one
    launch of the D=512 self kernels): one launch of the D=161-512 entry of
    the dtype with n_sets 0 at the caller's D (bf16 and f16: 3, 4 and 5 64-column
    chunks with warpgroups over their own rows, one a block at (3,2,130) and
    two at (7,2,1024), past one wave of 64-row blocks; 6 and 8 with D split;
    f32: 32- and 16-key tiles, 2 to 4 M blocks a warpgroup; D = 200 ragged
    against the chunks), counted under D=512 on the interpolating wrapper
    and on no other kernel, matching the plain version: (B, S, H*D)
    projections viewed as (B, H, S, D) (strided heads), queries and keys
    ragged against every tile, one query over one key."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 730 + D, dtype))
    k, v = heads(_randn((B, L, H * D), 731 + D, dtype)), heads(_randn((B, L, H * D), 732 + D, dtype))
    d512 = takes_d512_self(D, "self", dtype)
    assert padded_head_dim(D, "self", dtype) == (512 if d512 else D) and d512 == (dtype == torch.float32 and D > 448)
    before = _all_launches()
    got = flash_interpolated_attention(q, k, v)
    torch.cuda.synchronize()
    name = ATTN_WRAPPER[dtype].__name__
    assert _launched(before) == ({D512_WRAPPER[dtype].__name__: 1} if d512 else {name: 1, f"{name}[D=512]": 1})
    want = flash_interpolated_attention_plain(q, k, v)
    assert got.shape == want.shape == (B, H, S, D) and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 200, 129, None, None),   # Sq past a 64-row q tile, 129 keys: a 1-key last tile (64- and 32-key tiles)
    (2, 3, 77, 77, 23, 4),          # 77 keys and queries (a ragged key tail), per-row endpoints of 23 keys
    (4, 2, 130, 77, 129, 3),        # shared 3D endpoints of 129 keys
    # the edges of each instance's own tiles ("bk": its keys per tile; query rows 192 / 128 / 128 / 64 at
    # D = 40 / 64 / 80 / 160)
    (3, 2, 129, 1, 1, 3),           # one key and a shared one-key endpoint, Sq one row past 128 (or 64 x 2)
    (3, 2, 127, "bk-1", "bk+1", 4),  # Sq one row short of 128, per-row endpoints one key past the tile
    (3, 2, 255, "bk+1", "bk-1", 3),  # Sq one short of 256, shared endpoints one key short (15, 31 or 63)
])
def test_flash_f32_kernel_matches_plain(dev, D, mode, B, H, S, L, Le, ep):
    """The f32 kernel at every head dim and mode, as an f32 UNet calls it:
    (B, S, H*D) projections viewed as (B, H, S, D) (columns past D are the
    next head's), q tails past, at and short of every query tile, key
    segments of 1, tile - 1 and tile + 1 keys and other ragged tails,
    per-row and shared endpoints, skip rows at both ends (the middle rows
    blend); one launch of the f32 instance, within the f32 promise of the
    plain version (TF32 off), and the strided views equal to contiguous
    copies bit for bit."""
    bk = KERNEL_F32_TILES[D][1]
    L, Le = ({"bk-1": bk - 1, "bk+1": bk + 1}.get(x, x) for x in (L, Le))

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 181, torch.float32))
    k, v = heads(_randn((B, L, H * D), 182, torch.float32)), heads(_randn((B, L, H * D), 183, torch.float32))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 190 + i, torch.float32) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before, before_bf16 = flash_interpolated_attention_f32.launches, flash_interpolated_attention.launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert flash_interpolated_attention_f32.launches == before + 1
    assert flash_interpolated_attention.launches == before_bf16
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _attn_err(got, want) < F32_ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_flash_f32_kernel_batched_cfg_rows(dev, mode):
    """Batched CFG's call in f32 at SDXL's D=64: 2N rows, per-row endpoints,
    the uncond half skipped in fused modes; the f32 kernel against the plain
    version, and its uncond half against vanilla attention."""
    N, H, S, D = 3, 2, 200, 64

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q, k, v = (heads(_randn((2 * N, S, H * D), 187 + i, torch.float32)) for i in range(3))
    coef = torch.linspace(0, 1, N, device=dev).repeat(2)
    kb, ke = per_row_endpoints(k, N)
    vb, ve = per_row_endpoints(v, N)
    eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve, skip_endpoints=skip_mask(coef, N))
    got = flash_interpolated_attention_f32(q, k, v, coef, mode, **eps)
    torch.cuda.synchronize()
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode, **eps)) < F32_ATTN_RTOL
    assert _attn_err(got[N:], flash_interpolated_attention_plain(q[N:], k[N:], v[N:])) < F32_ATTN_RTOL


@pytest.mark.parametrize("D", [40, 64])
@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_flash_kernel_batched_cfg_rows(dev, D, mode):
    """Batched CFG's call: 2N rows [cond; uncond], per-row (B, H, S, D)
    endpoints (cond rows 0 / N-1 for the cond half, each uncond row its
    own), the uncond half skipped in fused modes; the kernel against the
    plain version, and its uncond half against vanilla attention."""
    N, H, S = 3, 2, 200

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q, k, v = (heads(_randn((2 * N, S, H * D), 87 + i)) for i in range(3))
    coef = torch.linspace(0, 1, N, device=dev).repeat(2)
    kb, ke = per_row_endpoints(k, N)
    vb, ve = per_row_endpoints(v, N)
    eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve, skip_endpoints=skip_mask(coef, N))
    got = flash_interpolated_attention(q, k, v, coef, mode, **eps)
    torch.cuda.synchronize()
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode, **eps)) < ATTN_RTOL
    assert _attn_err(got[N:], flash_interpolated_attention_plain(q[N:], k[N:], v[N:])) < ATTN_RTOL


# The IP-Adapter branch's calls: the cross layers' queries over 4 (standard
# adapter) or 16 (Plus) image tokens, each segment shorter than one key tile
# of every instance (16..128 keys), at SD 1.5's head dims and SDXL's 64.
IP_ENDPOINTS = ["rows", "shared", "per_row"]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T", [4, 16])
@pytest.mark.parametrize("ep", IP_ENDPOINTS)
def test_flash_kernels_ip_segments(dev, dtype, D, mode, T, ep):
    """The kernels against their plain versions on the IP branch's calls:
    an own KV of T = 4 or 16 image tokens and endpoints of T tokens, every
    mode, bf16 and f32, 200 queries (a q tail at every tile). Endpoints are
    rows 0 / B-1 of the tokens (the sequential pass), one shared (H, T, D)
    pair, or per row as batched CFG makes them ([cond; uncond], 2 x 3 rows,
    each uncond row its own); the operands are (B, T, H*D) projections
    viewed as (B, H, T, D), as CrossAttention passes them. One launch of
    the instance of the dtype, counted under D."""
    B = 6 if ep == "per_row" else 3
    H, S = 2, 200

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 600 + D, dtype))
    k, v = heads(_randn((B, T, H * D), 601 + D, dtype)), heads(_randn((B, T, H * D), 602 + D, dtype))
    coef = torch.linspace(0, 1, B // 2 if ep == "per_row" else B, device=dev)
    eps = {}
    if ep == "per_row":
        coef = coef.repeat(2)
        kb, ke = per_row_endpoints(k, B // 2)
        vb, ve = per_row_endpoints(v, B // 2)
        eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve)
    elif ep == "shared":
        eps = {n: _randn((H, T, D), 610 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    fn = ATTN_WRAPPER[dtype]
    before = fn.launches_by_head_dim[D]
    got = flash_interpolated_attention(q, k, v, coef, mode, **eps)
    torch.cuda.synchronize()
    assert fn.launches_by_head_dim[D] == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, **eps)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    if ep == "per_row" and mode != "self":  # each uncond row's own tokens as its endpoints: vanilla attention
        van = flash_interpolated_attention_plain(q[3:], k[3:], v[3:])
        assert _attn_err(got[3:], van) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_ip_force_vanilla_is_one_launch(dev, dtype, mode):
    """force_vanilla on a 4-token IP call (the fused loop's late steps):
    one launch, the forced rows attend their own tokens alone."""
    q, k, v = _randn((4, 2, 150, 40), 620, dtype), _randn((4, 2, 4, 40), 621, dtype), _randn((4, 2, 4, 40), 622, dtype)
    coef = torch.tensor([0.0, 0.3, 0.7, 1.0], device=dev)
    force = torch.tensor([False, True, False, True], device=dev)
    fn = ATTN_WRAPPER[dtype]
    before = fn.launches
    got = dispatch_attention(q, k, v, coef, mode, skip_endpoints=force, force_vanilla=force)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    tol = ATTN_RTOLS[dtype]
    assert _attn_err(got[force], flash_interpolated_attention_plain(q, k, v)[force]) < tol
    assert _attn_err(got[~force], flash_interpolated_attention_plain(q, k, v, coef, mode)[~force]) < tol


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("ip", ["own", "fused_outer", "pure_inner", "scale_control", "batched_fused_inner"])
def test_tiny_ip_unet_runs_the_kernels(dev, dtype, ip):
    """TINY_UNET_IP with 4 image tokens on the card: every attention,
    the IP branch's included, launches the D=40 instance (head dims 16 and
    32 padded), and the output matches the same forward through the plain
    versions as in test_tiny_models_run_the_kernels. The weights are
    N(0, 0.2), so that attention outputs weigh in the residual stream: the
    IP branch moves the output by more than twice that bound."""
    import dataclasses

    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.models.params import unet_attention_order
    from aid_tpu_torch.models.unet import UNet2DCondition

    cfg, frames, gen = configs.TINY_UNET_IP, 3, _gen(630)
    model = UNet2DCondition(cfg, device=dev, dtype=dtype).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.2, generator=gen)
    batched = ip.startswith("batched")
    rows = 2 * frames if batched else frames

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    sample = randn(rows, cfg.in_channels, cfg.sample_size, cfg.sample_size)
    ehs, tokens = randn(rows, 77, cfg.cross_attention_dim), randn(rows, cfg.ip_num_tokens, cfg.cross_attention_dim)
    coef = torch.linspace(0, 1, frames, device=dev).repeat(2 if batched else 1)
    name = ip.removeprefix("batched_")
    mode = (AidMode.vanilla(has_ip=True) if name == "own" else AidMode.from_name(name, has_ip=True))
    if batched:
        mode = dataclasses.replace(mode, cfg_split=frames)
    aid = AidContext(coef=coef, mode=mode, ip_hidden_states=tokens, ip_scale=0.7)
    fn = ATTN_WRAPPER[dtype]
    t = torch.tensor(500, device=dev)
    with torch.no_grad():
        before = fn.launches_by_head_dim[40]
        got = model(sample, t, ehs, aid)
        torch.cuda.synchronize()
        launched = fn.launches_by_head_dim[40] - before
        with reference_ops():
            want = model(sample, t, ehs, aid)
            no_ip = model(sample, t, ehs, dataclasses.replace(aid, ip_hidden_states=None))
    # each transformer block: a self-attention, a text cross-attention and an IP call
    assert launched == 3 * len(unet_attention_order(cfg))
    tol = ATTN_RTOLS[dtype]

    def worst(a):
        return ((a.float() - want.float()).flatten(1).norm(dim=1) / want.float().flatten(1).norm(dim=1)).max().item()

    assert torch.isfinite(got).all() and worst(got) < tol
    assert worst(no_ip) > 2 * tol


@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_force_vanilla_is_one_launch(dev, mode):
    """dispatch_attention's force_vanilla on the card: one kernel launch
    (fused modes fold it into the skip rows, pure modes substitute the
    endpoints), the forced rows vanilla, the others as without it."""
    q, k, v = (_randn((4, 2, 150, 64), 95 + i) for i in range(3))
    coef = torch.tensor([0.0, 0.3, 0.7, 1.0], device=dev)
    force = torch.tensor([False, True, False, True], device=dev)
    before = flash_interpolated_attention.launches
    got = dispatch_attention(q, k, v, coef, mode, force_vanilla=force)
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before + 1
    assert _attn_err(got[force], flash_interpolated_attention_plain(q, k, v)[force]) < ATTN_RTOL
    free = flash_interpolated_attention_plain(q, k, v, coef, mode)
    assert _attn_err(got[~force], free[~force]) < ATTN_RTOL


# the redesigned kernel's tile classes: 4 x 64-pixel tiles against W = 96
# (SD 2.1's 96^2 latents, a half tile at the edge) and W = 100 (ragged in
# both), N tiles of 160 against Cout 320 / 640 (exact) and 130 (ragged), a
# 16-channel K chunk against Cin = 40 (the last chunk half zero-filled), and
# the SDXL 960 -> 320 class at 128^2 with all 7 frames
REDESIGN_CLASSES = [(2, 40, cout, w, w) for w in (96, 100) for cout in (320, 640, 130)] + [(7, 960, 320, 128, 128)]


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (2, 64, 64, 16, 16),
    (1, 40, 24, 13, 7),     # ragged pixels, Cin not a multiple of 16, Cout of 160
    (3, 96, 130, 9, 11),
] + REDESIGN_CLASSES)
def test_conv_kernel_matches_plain(dev, B, Cin, Cout, H, W):
    x = _randn((B, Cin, H, W), 40)
    w = _randn((Cout, Cin, 3, 3), 41) * Cin ** -0.5
    b = _randn((Cout,), 42)
    before = conv3x3_same.launches
    got = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_same.launches == before + 1
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item() / want.abs().max().item()
    assert err < CONV_RTOL


def _ring(H, W, device):
    ring = torch.zeros(H, W, dtype=torch.bool, device=device)
    ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
    return ring


@pytest.mark.parametrize("B,Cin,Cout,H,W,groups", [
    (1, 320, 320, 13, 11, 32),    # pixels not a multiple of the 128-pixel tile
    (7, 320, 640, 16, 16, 32),
    (2, 2560, 1280, 9, 7, 32),    # the widest SDXL resnet input
    (7, 2560, 1280, 8, 8, 32),
    (3, 40, 24, 5, 6, 8),         # Cin not a multiple of the 16-channel K chunk
] + [(*c, 8) for c in REDESIGN_CLASSES])
def test_conv_gnsilu_kernel_matches_plain(dev, B, Cin, Cout, H, W, groups):
    """The prologue kernel against its plain version (same one-pass
    statistics, silu in f32 rounded to bf16, cuDNN conv with zero padding).
    The border ring is checked on its own: a halo that took silu(shift)
    moves only that ring, which the whole-tensor bound would barely see."""
    x = (_randn((B, Cin, H, W), 60).float() * 2.0 + 1.0).to(torch.bfloat16)
    w = _randn((Cout, Cin, 3, 3), 61) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 62)
    gamma = (1.0 + 0.3 * _randn((Cin,), 63, torch.float32))
    beta = 0.5 * _randn((Cin,), 64, torch.float32)
    before = conv3x3_gnsilu.launches
    got = conv3x3_gnsilu(x, w, b, gamma, beta, groups)
    torch.cuda.synchronize()
    assert conv3x3_gnsilu.launches == before + 1
    want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, groups)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    ref = want.float().abs().max().item()
    ring = _ring(H, W, dev)
    assert err[:, :, ring].max().item() < CONV_RTOL * ref
    assert err[:, :, ~ring].max().item() < CONV_RTOL * ref


def test_conv_packed_is_the_prologue_free_kernel(dev):
    """conv3x3_same(packed=True) launches the same kernel as packed=False
    (one conv kernel serves both TPU contracts): equal bits, one launch each."""
    x = _randn((2, 64, 12, 10), 70)
    w = _randn((96, 64, 3, 3), 71) * 64 ** -0.5
    b = _randn((96,), 72)
    before = conv3x3_same.launches
    packed = conv3x3_same(x, w, b, packed=True)
    plain_flag = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_same.launches == before + 2
    assert torch.equal(packed, plain_flag)
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert (packed.float() - want).abs().max().item() < CONV_RTOL * want.abs().max().item()


def test_conv_retiles_a_weight_updated_in_place(dev):
    """The wrapper keeps a weight's tiling between calls; an in-place update
    (a new version of the weight) must reach the kernel on the next call."""
    x = _randn((2, 64, 12, 10), 73)
    w = torch.nn.Parameter(_randn((96, 64, 3, 3), 74) * 64 ** -0.5)
    b = _randn((96,), 75)
    with torch.no_grad():
        first = conv3x3_same(x, w, b)
        w.mul_(-2)
        second = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    want = F.conv2d(x.float(), w.detach().float(), b.float(), padding=1)
    assert not torch.equal(first, second)
    assert (second.float() - want).abs().max().item() < CONV_RTOL * want.abs().max().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "channel_slice", "misaligned_slice", "row_slice"])
def test_conv_layout_kernel_matches_plain(dev, layout):
    """The conv's layout kernel writes (B, C/8, H, W, 8) from x at its own
    strides, bit for bit: NCHW, channels-last (16-byte loads), a
    channels-last view 16 bytes in, one 8 bytes in (no 16-byte loads), and
    a view of rows."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain

    x = _randn((3, 48, 13, 11), 76)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "channel_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 8:40]
    elif layout == "misaligned_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 4:36]
    elif layout == "row_slice":
        x = x[:, :, 1:]
    got = blocked_input(x)
    assert got.shape == (x.shape[0], x.shape[1] // 8, x.shape[2], x.shape[3], 8)
    assert torch.equal(got, blocked_input_plain(x))


# the f32 kernel's tile classes: 2 x 64-pixel tiles against W = 96 and 100
# (half and ragged column tiles), N tiles of 160 against Cout 320 (exact)
# and 130 (ragged), an 8-channel K chunk against Cin = 36 (the last chunk's
# second 4-channel group zero-filled by the TMA box), and the three SDXL
# classes at 128^2 with all 7 frames
F32_CONV_CLASSES = [(2, 36, cout, w, w) for w in (96, 100) for cout in (320, 130)] + [
    (7, 960, 320, 128, 128), (7, 640, 320, 128, 128), (7, 640, 640, 128, 128)]
# one class with all three edges at once: W = 96, Cin % 8 == 4, a Cout
# under one N tile
F32_CONV_EDGES = (2, 20, 26, 5, 96)


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (2, 64, 64, 16, 16),
    (1, 40, 24, 13, 7),     # ragged pixels, Cout not a multiple of the 160-channel N tile
    (3, 12, 130, 9, 11),    # Cin % 8 != 0: the last K chunk's second block zero-filled
    F32_CONV_EDGES,
] + F32_CONV_CLASSES)
def test_conv_f32_kernel_matches_plain(dev, B, Cin, Cout, H, W):
    """The f32 conv kernel, routed by conv3x3_same as an f32 UNet calls it,
    against cuDNN in full f32: one launch of the f32 instance, none of the
    bf16 one, a channels-last f32 result within the f32 promise."""
    x = _randn((B, Cin, H, W), 140, torch.float32)
    w = _randn((Cout, Cin, 3, 3), 141, torch.float32) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 142, torch.float32)
    before, before_bf16 = conv3x3_same_f32.launches, conv3x3_same.launches
    got = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_same_f32.launches == before + 1 and conv3x3_same.launches == before_bf16
    want = F.conv2d(x, w, b, padding=1)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err < F32_CONV_RTOL
    # packed=True launches the same instance: the same bits
    assert torch.equal(got, conv3x3_same(x, w, b, packed=True))


@pytest.mark.parametrize("B,Cin,Cout,H,W", [(2, 64, 96, 12, 10), F32_CONV_EDGES])
def test_conv_f32_retiles_a_weight_updated_in_place(dev, B, Cin, Cout, H, W):
    """The f32 weight tiling (raw and lo) is kept between calls and redone
    after an in-place update."""
    x = _randn((B, Cin, H, W), 143, torch.float32)
    w = torch.nn.Parameter(_randn((Cout, Cin, 3, 3), 144, torch.float32) * Cin ** -0.5)
    b = _randn((Cout,), 145, torch.float32)
    with torch.no_grad():
        first = conv3x3_same(x, w, b)
        w.mul_(-2)
        second = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    want = F.conv2d(x, w.detach(), b, padding=1)
    assert not torch.equal(first, second)
    assert (second - want).abs().max().item() < F32_CONV_RTOL * want.abs().max().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "channel_slice", "misaligned_slice", "row_slice",
                                    "c20_w96"])
def test_conv_f32_layout_kernel_matches_plain(dev, layout):
    """The f32 layout kernel writes (B, C/4, H, W, 4) and its lo part right
    after it from x at its own strides, bit for bit: NCHW, channels-last
    (16-byte loads), a channels-last view 16 bytes in, one 8 bytes in (no
    16-byte loads), a view of rows, and C % 8 == 4 at W = 96."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain

    x = _randn((2, 20, 5, 96) if layout == "c20_w96" else (3, 48, 13, 11), 146, torch.float32)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "channel_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 4:40]
    elif layout == "misaligned_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 2:38]
    elif layout == "row_slice":
        x = x[:, :, 1:]
    got = blocked_input(x)
    assert got.shape == (2, x.shape[0], x.shape[1] // 4, x.shape[2], x.shape[3], 4)
    assert torch.equal(got, blocked_input_plain(x))


@pytest.mark.parametrize("B,Cin,Cout,H,W,groups", [
    (1, 320, 320, 13, 11, 32),    # pixels not a multiple of the 128-pixel tile
    (3, 12, 24, 5, 6, 4),         # Cin % 8 != 0: the last K chunk's second block zero-filled
    (2, 2560, 1280, 9, 7, 32),    # the widest SDXL resnet input
    (1, 320, 320, 96, 96, 32),    # SD 2.1's fused classes at 96^2 (one full, one half column tile)
    (1, 640, 320, 96, 96, 32),
    (1, 640, 640, 48, 48, 32),    # and at 48^2
    (1, 1280, 640, 48, 48, 32),
    (*F32_CONV_EDGES, 4),         # W = 96, Cin % 8 == 4, Cout under one N tile
])
def test_conv_gnsilu_f32_kernel_matches_plain(dev, B, Cin, Cout, H, W, groups):
    """The f32 GN+SiLU conv (the prologue in the f32 layout pass, then the
    f32 conv kernel), routed by conv3x3_gnsilu as an f32 UNet calls it,
    against its plain version in full f32: one launch of the f32 instance,
    none of the bf16 ones, the border ring (where a halo that took
    silu(shift) would show) and the interior each within the f32 promise."""
    x = _randn((B, Cin, H, W), 160, torch.float32) * 2.0 + 1.0
    w = _randn((Cout, Cin, 3, 3), 161, torch.float32) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 162, torch.float32)
    gamma = 1.0 + 0.3 * _randn((Cin,), 163, torch.float32)
    beta = 0.5 * _randn((Cin,), 164, torch.float32)
    before = (conv3x3_gnsilu_f32.launches, conv3x3_gnsilu.launches, conv3x3_same_f32.launches)
    got = conv3x3_gnsilu(x, w, b, gamma, beta, groups)
    torch.cuda.synchronize()
    assert (conv3x3_gnsilu_f32.launches, conv3x3_gnsilu.launches, conv3x3_same_f32.launches) == (
        before[0] + 1, before[1], before[2])
    want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, groups)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs()
    ref = want.abs().max().item()
    ring = _ring(H, W, dev)
    assert err[:, :, ring].max().item() < F32_CONV_RTOL * ref
    assert err[:, :, ~ring].max().item() < F32_CONV_RTOL * ref


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "row_slice", "c20_w96"])
def test_conv_f32_prologue_layout_matches_plain(dev, layout):
    """The f32 layout pass with the prologue writes silu(x * scale + shift)
    as (B, C/4, H, W, 4) from x at its own strides, within a few f32 ulps
    of the plain version (fma and expf against torch's separate mul, add
    and silu), and right after it that value's lo part, bit for bit (a
    value an ulp off may cross a tf32 step, so lo is held to the kernel's
    own blocks, not to the plain version's)."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain, tf32_rest

    B, C, H, W = (2, 20, 5, 96) if layout == "c20_w96" else (3, 48, 13, 11)
    x = _randn((B, C, H, W), 165, torch.float32) * 3.0
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "row_slice":
        x = x[:, :, 1:]
    sc, sh = _randn((B, C), 166, torch.float32), _randn((B, C), 167, torch.float32)
    got = blocked_input(x, sc, sh)
    want = blocked_input_plain(x, sc, sh)
    assert got.shape == want.shape == (2, B, C // 4, x.shape[2], W, 4)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6 * want[0].abs().max().item()
    assert torch.equal(got[1], tf32_rest(got[0]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,L", [
    (144, 144),   # SD 2.1's 12^2 self-attention: queries under one 192-row tile, a ragged 16-key tail
    (576, 576),   # its 24^2 self-attention: 576 keys, not a multiple of the 128-key tile
    (144, 77),    # a 77-key cross-attention at 12^2
])
def test_flash_kernels_at_sd21_shapes(dev, dtype, mode, S, L):
    """The bf16 and f32 attention at D=64 with SD 2.1's 20 heads at its new
    ragged sequence lengths, as its UNet calls them ((B, S, H*D) views), in
    every mode with skip rows at both ends."""
    B, H, D = 3, 20, 64

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 170, dtype))
    k, v = heads(_randn((B, L, H * D), 171, dtype)), heads(_randn((B, L, H * D), 172, dtype))
    coef = torch.tensor([0.0, 0.4, 1.0], device=dev)
    skip = skip_mask(coef, B)
    counter = flash_interpolated_attention_f32 if dtype == torch.float32 else flash_interpolated_attention
    before = counter.launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < (F32_ATTN_RTOL if dtype == torch.float32 else ATTN_RTOL)


@pytest.mark.parametrize("dtype,Cin,Cout", [(dtype, cin, cout) for dtype in (torch.bfloat16, torch.float32)
                                             for cin, cout in ((960, 320), (640, 320), (640, 640))]
                         + [(torch.float32, 36, 130)])
def test_conv_kernels_at_sd21_width(dev, dtype, Cin, Cout):
    """The bf16 and f32 conv at W = 96 (SD 2.1's 96^2 up-block convs: one
    full 64-column tile and one half-empty tile per row), a few rows; in
    f32 also at Cin % 8 == 4 and a ragged Cout."""
    x = _randn((2, Cin, 6, 96), 175, dtype)
    w = _randn((Cout, Cin, 3, 3), 176, dtype) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 177, dtype)
    got = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want).abs().max().item() / want.abs().max().item()
    assert err < (F32_CONV_RTOL if dtype == torch.float32 else CONV_RTOL)


# ---------------------------------------------------------------------------
# the f16 instances: flash_interpolated_attention.cu's aid_flash_attn_f16,
# flash_attention_bf16_d512.cu's aid_flash_attn_f16_d512, conv3x3.cu's
# aid_conv3x3_f16 / aid_conv3x3_gnsilu_f16 / aid_conv3x3_blocked_f16
# ---------------------------------------------------------------------------

def _all_launches():
    """Every wrapper's launch count, the per-head-dim ones included."""
    fns = [*ATTN_WRAPPER.values(), *D512_WRAPPER.values(), conv3x3_same, conv3x3_same_f16, conv3x3_same_f32,
           conv3x3_gnsilu, conv3x3_gnsilu_f16, conv3x3_gnsilu_f32]
    counts = {fn.__name__: fn.launches for fn in fns}
    for fn in ATTN_WRAPPER.values():
        counts.update({f"{fn.__name__}[D={d}]": n for d, n in fn.launches_by_head_dim.items()})
    return counts


def _launched(before):
    """The counts that moved since ``before``."""
    return {k: n - before[k] for k, n in _all_launches().items() if n != before[k]}


@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 200, 129, None, None),   # Sq past one q tile, 129 keys: a 1-key last tile
    (4, 3, 130, 77, 77, 3),         # cross-like: 77 keys, shared 77-token endpoints
    (2, 3, 77, 77, 23, 4),          # per-row endpoints of 23 keys
])
def test_flash_f16_kernel_matches_plain(dev, D, mode, B, H, S, L, Le, ep):
    """The f16 instance of the D <= 160 kernel at every head dim and mode,
    routed by dtype as an f16 UNet calls it: one launch of the f16 wrapper
    counted under D and nothing else, on the model's (B, S, H*D) views with
    skip rows at both ends; within F16_ATTN_RTOL of the plain version in
    f16 (P rounded to f16), and the same bits on contiguous copies."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    f16 = torch.float16
    q = heads(_randn((B, S, H * D), 700 + D, f16))
    k, v = heads(_randn((B, L, H * D), 701 + D, f16)), heads(_randn((B, L, H * D), 702 + D, f16))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 710 + i, f16) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before = _all_launches()
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_interpolated_attention_f16": 1, f"flash_interpolated_attention_f16[D={D}]": 1}
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == f16 and torch.isfinite(got).all()
    assert _attn_err(got, want) < F16_ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


def test_flash_f16_kernel_is_not_the_bf16_one(dev):
    """The f16 instance reads its operands as f16: the same bits handed to
    the bf16 instance (viewed as bf16) give another result, and the f16
    result is much closer to the f16 plain version than bf16 rounding allows."""
    q, k, v = (_randn((2, 2, 150, 64), 720 + i, torch.float16) for i in range(3))
    got = flash_interpolated_attention(q, k, v)
    want = flash_interpolated_attention_plain(q, k, v)
    as_bf16 = flash_interpolated_attention(*(x.view(torch.bfloat16) for x in (q, k, v)))
    torch.cuda.synchronize()
    assert _attn_err(got, want) < F16_ATTN_RTOL
    assert not torch.equal(got.view(torch.bfloat16), as_bf16)
    rounded = want.to(torch.bfloat16).to(torch.float16)  # the output at bf16's precision
    assert _attn_err(got, want) < _attn_err(rounded, want)


@pytest.mark.parametrize("B,H,S,L", [
    (7, 1, 4096, 4096),    # SD 1.5's batched 512px decode of an f16 VAE
    (1, 1, 4000, 4000),    # ragged: not a multiple of the 64-row / 32-key tiles
    (1, 1, 1, 1),          # one query, one key
    (2, 1, 63, 31),        # one row short of a q tile, one key short of a K/V tile
    (1, 2, 65, 33),        # one past each
    (2, 3, 129, 97),       # B, H > 1, ragged in both
    (2, 1, 65, 95),        # three key tiles, the last one key short, both rings wrapping
])
def test_flash_f16_d512_kernel_matches_plain(dev, B, H, S, L):
    """The f16 instance of the D=512 self kernel, routed as an f16 VAE calls
    it, against its plain version in f16; (B, S, H*512) views, and equal
    contiguous copies bit for bit; one launch of the f16 D=512 wrapper and
    nothing else."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, 512).transpose(1, 2)

    q = heads(_randn((B, S, H * 512), 730, torch.float16))
    k, v = heads(_randn((B, L, H * 512), 731, torch.float16)), heads(_randn((B, L, H * 512), 732, torch.float16))
    before = _all_launches()
    got = flash_interpolated_attention(q, k, v)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_self_attention_f16": 1}
    want = flash_interpolated_attention_plain(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.float16 and torch.isfinite(got).all()
    assert _attn_err(got, want) < F16_ATTN_RTOL
    assert torch.equal(got, flash_self_attention_f16(*[x.contiguous() for x in (q, k, v)]))


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (2, 64, 64, 16, 16),
    (1, 40, 24, 13, 7),     # ragged pixels, Cin not a multiple of 16, Cout of 160
    (3, 96, 130, 9, 11),
] + REDESIGN_CLASSES)
def test_conv_f16_kernel_matches_plain(dev, B, Cin, Cout, H, W):
    """The f16 conv instance, routed by conv3x3_same (both packed flags) as
    an f16 UNet calls it: one launch of the f16 wrapper per call and
    nothing else, an f16 channels-last result within F16_CONV_RTOL of cuDNN
    in f32 on the same f16 operands, and the same bits from both flags."""
    f16 = torch.float16
    x = _randn((B, Cin, H, W), 740, f16)
    w = _randn((Cout, Cin, 3, 3), 741, f16) * Cin ** -0.5
    b = _randn((Cout,), 742, f16)
    before = _all_launches()
    got = conv3x3_same(x, w, b)
    packed = conv3x3_same(x, w, b, packed=True)
    torch.cuda.synchronize()
    assert _launched(before) == {"conv3x3_same_f16": 2}
    assert torch.equal(got, packed)
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert got.shape == want.shape and got.dtype == f16
    assert (got.float() - want).abs().max().item() < F16_CONV_RTOL * want.abs().max().item()


@pytest.mark.parametrize("B,Cin,Cout,H,W,groups", [
    (1, 320, 320, 13, 11, 32),
    (2, 2560, 1280, 9, 7, 32),    # the widest SDXL resnet input
    (3, 40, 24, 5, 6, 8),         # Cin not a multiple of the 16-channel K chunk
] + [(*c, 8) for c in REDESIGN_CLASSES])
def test_conv_gnsilu_f16_kernel_matches_plain(dev, B, Cin, Cout, H, W, groups):
    """The f16 prologue instance against its plain version (the same
    statistics, silu in f32 rounded to f16, cuDNN with zero padding), the
    border ring on its own; one launch of the f16 GN+SiLU wrapper."""
    f16 = torch.float16
    x = (_randn((B, Cin, H, W), 750, torch.float32) * 2.0 + 1.0).to(f16)
    w = _randn((Cout, Cin, 3, 3), 751, f16) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 752, f16)
    gamma = 1.0 + 0.3 * _randn((Cin,), 753, torch.float32)
    beta = 0.5 * _randn((Cin,), 754, torch.float32)
    before = _all_launches()
    got = conv3x3_gnsilu(x, w, b, gamma, beta, groups)
    torch.cuda.synchronize()
    assert _launched(before) == {"conv3x3_gnsilu_f16": 1}
    want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, groups)
    assert got.shape == want.shape and got.dtype == f16
    err, ref, ring = (got.float() - want.float()).abs(), want.float().abs().max().item(), _ring(H, W, dev)
    assert err[:, :, ring].max().item() < F16_CONV_RTOL * ref
    assert err[:, :, ~ring].max().item() < F16_CONV_RTOL * ref


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "misaligned_slice"])
def test_conv_f16_layout_kernel_matches_plain(dev, layout):
    """aid_conv3x3_blocked_f16 writes (B, C/8, H, W, 8) from f16 x at its own
    strides, bit for bit."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain

    x = _randn((3, 48, 13, 11), 760, torch.float16)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "misaligned_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 4:36]
    got = blocked_input(x)
    assert got.dtype == torch.float16 and torch.equal(got, blocked_input_plain(x))


# The short-stream kernel (csrc/flash_attention_onepass.cu): the calls the
# route sends it, each stream resident in shared memory. (B, H, Sq, Lk, Le,
# endpoints): the 77-key cross call with shared 77-token endpoints and with
# per-row ones of 23 keys, the IP tokens (16 shared, 4 per row), a 144-key
# self stream (9 of 10 tiles), and enough (b, h, query tile) units that
# blocks' runs cross into the next (b, h) and reload the stream.
ONEPASS_CASES = [(3, 2, 130, 77, 77, 3), (2, 3, 200, 77, 23, 4), (4, 2, 257, 16, 16, 3), (3, 2, 100, 4, 4, 4),
                 (2, 3, 144, 144, None, None), (7, 10, 1024, 77, None, None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("D,mode,case", [
    (D, m, c) for D in (40, 64, 80, 160) for m in MODES for c in ONEPASS_CASES
    if takes_onepass(D, c[2], c[3], c[3] if c[4] is None else c[4], m)])
def test_flash_onepass_kernel_matches_plain(dev, dtype, D, mode, case):
    """Every routed call: one launch of the short-stream kernel (counted
    under D in launches_onepass), within the dtype's bound of the plain
    version and of the streaming kernel on the same call; skip rows at both
    ends, (B, S, H*D) projections viewed as (B, H, S, D)."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    B, H, S, L, Le, ep = case

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 900 + D, dtype))
    k, v = heads(_randn((B, L, H * D), 901 + D, dtype)), heads(_randn((B, L, H * D), 902 + D, dtype))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 910 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    fn = ATTN_WRAPPER[dtype]
    before, before_d = fn.launches_onepass[D], fn.launches_by_head_dim[D]
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert fn.launches_onepass[D] == before + 1 and fn.launches_by_head_dim[D] == before_d + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    streamed, launch = kernel_launch(q, k, v, coef, mode, skip_endpoints=skip, onepass=False, **eps)
    launch()
    torch.cuda.synchronize()
    assert _attn_err(got, streamed) < 2 * ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("D,mode,S,L", [(160, "self", 100, 256), (160, "fused_outer", 100, 77),
                                        (64, "self", 100, 576), (64, "fused_outer", 100, 144),
                                        (160, "self", 64, 64), (40, "self", 64, 77)])
def test_flash_onepass_longer_streams_keep_the_streaming_kernel(dev, dtype, D, mode, S, L):
    """Calls the route keeps on the streaming kernel: streams the
    short-stream kernel does not hold (past its largest instance, or over
    its shared memory beside the Q ring), and those past its measured
    limit (one 64-row query tile a (b, h)): no launch of the new one."""
    q, k, v = _randn((3, 2, S, D), 930, dtype), _randn((3, 2, L, D), 931, dtype), _randn((3, 2, L, D), 932, dtype)
    coef = torch.linspace(0, 1, 3, device=dev)
    fn = ATTN_WRAPPER[dtype]
    before = dict(fn.launches_onepass)
    got = flash_interpolated_attention(q, k, v, coef, mode)
    torch.cuda.synchronize()
    assert fn.launches_onepass == before
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode)) < ATTN_RTOLS[dtype]


# The mid-length stream kernel (csrc/flash_attention_midstream.cu): streams
# past what the short-stream kernel holds. (B, H, Sq, Lk, Le, endpoints):
# two 192-row items a (b, h), the second with two warpgroups idle, over a
# ragged 300-key own segment and shared 131-key endpoints; 576 queries (three
# items, none idle) with per-row endpoints of their own length; 384 queries
# over 333 own keys; and SDXL's own (7, 20, 1024) (many items a block).
MIDSTREAM_CASES = [(3, 2, 256, 300, 131, 3), (2, 3, 576, 300, 77, 4), (3, 2, 384, 333, 300, None),
                   (7, 20, 1024, 1024, None, None)]


def _midstream_inputs(dtype, D, case, seed):
    B, H, S, L, Le, ep = case

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), seed, dtype))
    k, v = heads(_randn((B, L, H * D), seed + 1, dtype)), heads(_randn((B, L, H * D), seed + 2, dtype))
    coef = torch.linspace(0, 1, B, device="cuda")
    skip = torch.zeros(B, dtype=torch.bool, device="cuda")
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, seed + 10 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    return q, k, v, coef, dict(skip_endpoints=skip, **eps)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("D,mode,case", [(D, m, c) for D in (64, 80) for m in MODES for c in MIDSTREAM_CASES])
def test_flash_midstream_kernel_matches_plain(dev, dtype, D, mode, case):
    """Every mode at both head dims, sent to the mid-length stream kernel
    (kernel_launch(..., midstream=True), whatever the route's limits), within
    the dtype's bound of the plain version and of the streaming kernel on the
    same call; skip rows at both ends, (B, S, H*D) projections viewed as (B,
    H, S, D)."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    q, k, v, coef, kw = _midstream_inputs(dtype, D, case, 950 + D)
    got, launch = kernel_launch(q, k, v, coef, mode, midstream=True, **kw)
    launch()
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    streamed, launch = kernel_launch(q, k, v, coef, mode, midstream=False, **kw)
    launch()
    torch.cuda.synchronize()
    assert _attn_err(got, streamed) < 2 * ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("D,mode,H,S", [(64, "self", 20, 1024), (64, "fused_outer", 20, 1024), (64, "self", 20, 576),
                                        (64, "fused_outer", 20, 576), (64, "self", 10, 2304), (80, "self", 8, 1024),
                                        (64, "pure_outer", 4, 1024), (64, "fused_inner", 4, 1024),
                                        (64, "pure_inner", 4, 1024)])
def test_flash_midstream_route_launches_it(dev, dtype, D, mode, H, S):
    """The paths' routed calls (SDXL's 1024-token level, SD 2.1's 576 and
    2304, SD 1.5's 1024 at D = 80) through the wrapper: one launch of the
    mid-length stream kernel, counted under D in launches_midstream and
    launches_by_head_dim, the plain version's result."""
    assert takes_midstream(D, S, S, S, mode, dtype)
    q, k, v, coef, kw = _midstream_inputs(dtype, D, (3, H, S, S, None, None), 990 + S)
    fn = ATTN_WRAPPER[dtype]
    before, before_d = fn.launches_midstream[D], fn.launches_by_head_dim[D]
    got = flash_interpolated_attention(q, k, v, coef, mode, **kw)
    torch.cuda.synchronize()
    assert fn.launches_midstream[D] == before + 1 and fn.launches_by_head_dim[D] == before_d + 1
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("D,mode,S,L", [(64, "self", 4096, 4096), (64, "fused_outer", 1024, 1025),
                                        (64, "self", 512, 576), (80, "fused_outer", 1024, 1024),
                                        (80, "fused_inner", 1024, 1024), (80, "pure_inner", 1024, 1024),
                                        (160, "self", 1024, 256), (40, "fused_outer", 1024, 1024)])
def test_flash_midstream_route_keeps_the_rest(dev, dtype, D, mode, S, L):
    """Calls the route keeps off the mid-length stream kernel: streams past
    3072 keys, fewer query rows than its measured limit, D = 80 in every
    mode but self (not measured faster), head dims it has no instance of: no
    launch of it, the result still the plain version's."""
    q, k, v = _randn((2, 2, S, D), 970, dtype), _randn((2, 2, L, D), 971, dtype), _randn((2, 2, L, D), 972, dtype)
    coef = torch.linspace(0, 1, 2, device=dev)
    fn = ATTN_WRAPPER[dtype]
    before = dict(fn.launches_midstream)
    got = flash_interpolated_attention(q, k, v, coef, mode)
    torch.cuda.synchronize()
    assert fn.launches_midstream == before
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode)) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("mode", ["self", "fused_outer"])
def test_flash_midstream_kernel_past_the_route(dev, dtype, mode):
    """Sent past the route (midstream=True): a 4096-token stream, many items a
    block over long segments; two launches in a row give the same result."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    q, k, v = (_randn((3, 4, 4096, 64), 980 + i, dtype) for i in range(3))
    coef = torch.linspace(0, 1, 3, device=dev)
    out, launch = kernel_launch(q, k, v, coef, mode, midstream=True)
    assert launch.operands["entry"].endswith("_midstream")
    launch()
    torch.cuda.synchronize()
    first = out.clone()
    out.zero_()
    launch()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    assert _attn_err(out, flash_interpolated_attention_plain(q, k, v, coef, mode)) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_flash_midstream_kernel_on_two_streams(dev, dtype):
    """Two launches on two streams at once (each block takes its items by its
    own index: no state outlives a launch), each the plain version's result
    and the same as alone."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    calls = []
    for i, mode in enumerate(("self", "fused_outer")):
        q, k, v, coef, kw = _midstream_inputs(dtype, 64, (7, 20, 1024, 1024, None, None), 1010 + 10 * i)
        torch.cuda.synchronize()
        with torch.cuda.stream(torch.cuda.Stream()):  # the launch runs on the stream current here
            out, launch = kernel_launch(q, k, v, coef, mode, midstream=True, **kw)
        launch()
        torch.cuda.synchronize()
        calls.append((out, launch, out.clone(), flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)))
    for _ in range(3):
        for out, *_ in calls:
            out.zero_()
        torch.cuda.synchronize()
        for _, launch, *_ in calls:
            launch()
        torch.cuda.synchronize()
        for out, _, alone, want in calls:
            assert torch.equal(out, alone)
            assert _attn_err(out, want) < ATTN_RTOLS[dtype]


# ---------------------------------------------------------------------------
# the static-shift instances (static_smax, C = 40): flash_interpolated_attention_static.cu
# (bf16), flash_interpolated_attention_f32_static.cu (f32), flash_attention_midstream_static.cu
# (bf16, D = 64, the endpoint modes), held to the plain version's static shift
# ---------------------------------------------------------------------------

STATIC_DTYPES = dict(argvalues=[torch.bfloat16, torch.float32], ids=["bf16", "f32"])
# (B, H, S, L, Le, endpoints): ragged q and kv tails with rows 0 / B-1 as
# endpoints, 77 keys with shared 77-token endpoints, per-row endpoints of their own length
STATIC_CASES = [(3, 2, 100, 100, None, None), (4, 3, 130, 77, 77, 3), (2, 2, 64, 64, 23, 4)]


def _static_inputs(dtype, D, case, seed):
    B, H, S, L, Le, ep = case
    q, k, v = (_randn((B, H, n, D), seed + i, dtype) for i, n in enumerate((S, L, L)))
    coef = torch.linspace(0, 1, B, device="cuda")
    skip = torch.zeros(B, dtype=torch.bool, device="cuda")
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, seed + 10 + i, dtype) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    return q, k, v, coef, dict(skip_endpoints=skip, **eps)


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", STATIC_CASES)
def test_flash_static_kernel_matches_plain(dev, dtype, D, mode, case):
    """The streaming kernels' static-shift instances in every mode and head
    dim: within the dtype's bound of the plain version's static shift, and of
    the exact kernel on the same call (logits well inside the window)."""
    from aid_tpu_torch.ops.flash_attention import STATIC_ENTRIES, kernel_launch

    q, k, v, coef, kw = _static_inputs(dtype, D, case, 1100 + D)
    got, launch = kernel_launch(q, k, v, coef, mode, static_smax=40.0, midstream=False, **kw)
    assert launch.operands["entry"] == STATIC_ENTRIES[dtype] and not launch.operands["onepass"]
    launch()
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0, **kw)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    exact, launch = kernel_launch(q, k, v, coef, mode, onepass=False, midstream=False, **kw)
    launch()
    torch.cuda.synchronize()
    assert _attn_err(got, exact) < 2 * ATTN_RTOLS[dtype]


@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
@pytest.mark.parametrize("case", MIDSTREAM_CASES)
def test_flash_static_midstream_kernel_matches_plain(dev, mode, case):
    """The mid-length stream kernel's static-shift instance (bf16, D = 64, the
    endpoint modes) on the schedule's cases: within ATTN_RTOL of the plain
    version's static shift and of the exact instance."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    q, k, v, coef, kw = _midstream_inputs(torch.bfloat16, 64, case, 1200)
    got, launch = kernel_launch(q, k, v, coef, mode, static_smax=40.0, midstream=True, **kw)
    assert launch.operands["entry"] == "aid_flash_attn_bf16_midstream_static"
    launch()
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0, **kw)
    assert torch.isfinite(got).all() and _attn_err(got, want) < ATTN_RTOL
    exact, launch = kernel_launch(q, k, v, coef, mode, midstream=True, **kw)
    launch()
    torch.cuda.synchronize()
    assert _attn_err(got, exact) < 2 * ATTN_RTOL


def _window_inputs(dtype, hot, B=2, H=2, S=300, D=64):
    """aid_tpu's window-edge inputs (tests/test_flash_attention.py:250-281):
    cold, every logit biased to -25 through a dedicated column (row maxes near
    -23 at scale 1); hot, q x 40 and k leaning on q (row maxes in the
    thousands at D**-0.5)."""
    q, k, v = (_randn((B, H, S, D), 1300 + i, torch.float32) for i in range(3))
    if hot:
        qh = q * 40.0
        return qh.to(dtype), (k + qh * 0.1).to(dtype), v.to(dtype), None
    qc = torch.cat([q[..., :-1] * 0.1, torch.ones_like(q[..., :1])], -1)
    kc = torch.cat([k[..., :-1], torch.full_like(k[..., :1], -25.0)], -1)
    return qc.to(dtype), kc.to(dtype), v.to(dtype), 1.0


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
@pytest.mark.parametrize("mode", ["self", "fused_outer", "pure_inner"])
@pytest.mark.parametrize("midstream", [False, True], ids=["streaming", "midstream"])
def test_flash_static_kernels_at_the_window_edges(dev, dtype, mode, midstream):
    """Near the window's bottom (row max ~ -23) the static instances give the
    exact softmax; far above its top they give the plain version's CLIPPED
    result, finite, far from the exact one."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    if midstream and (dtype == torch.float32 or mode == "self"):
        pytest.skip("the mid-length stream kernel's static instance is bf16 in the endpoint modes")
    coef = torch.tensor([0.25, 0.75], device=dev)
    for hot in (False, True):
        q, k, v, scale = _window_inputs(dtype, hot)
        got, launch = kernel_launch(q, k, v, coef, mode, scale=scale, static_smax=40.0, midstream=midstream)
        launch()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        clipped = flash_interpolated_attention_plain(q, k, v, coef, mode, scale=scale, static_smax=40.0)
        exact = flash_interpolated_attention_plain(q, k, v, coef, mode, scale=scale)
        assert _attn_err(got, clipped) < ATTN_RTOLS[dtype]
        if hot:
            assert _attn_err(got, exact) > 10 * ATTN_RTOLS[dtype]
        else:
            assert _attn_err(got, exact) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype,D,mode,H,S,route", [
    (torch.bfloat16, 64, "self", 10, 4096, "streaming"), (torch.bfloat16, 64, "fused_outer", 4, 4096, "streaming"),
    (torch.bfloat16, 64, "fused_outer", 20, 1024, "midstream"), (torch.bfloat16, 64, "pure_inner", 20, 1024,
                                                                 "midstream"),
    (torch.bfloat16, 40, "self", 8, 4096, "streaming"), (torch.bfloat16, 80, "fused_outer", 8, 1024, "streaming"),
    (torch.float32, 64, "fused_outer", 4, 4096, "streaming"), (torch.float32, 40, "self", 8, 4096, "streaming")])
def test_flash_static_auto_launches_the_static_instances(dev, dtype, D, mode, H, S, route):
    """"auto" through the wrapper at the model paths' call classes the JAX
    wrapper shifts: one launch of the static instance the class takes
    (unless PERF.md measured it slower: STATIC_SHIFT_SLOWER keeps it exact),
    counted in launches_static / launches_static_midstream, the plain
    version's result."""
    from aid_tpu_torch.ops.flash_attention import STATIC_SHIFT_SLOWER

    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    q, k, v, coef, kw = _midstream_inputs(dtype, D, (3, H, S, S, None, None), 1400 + S)
    fn = ATTN_WRAPPER[dtype]
    counter = fn.launches_static_midstream if route == "midstream" else fn.launches_static
    before, before_d = counter[D], fn.launches_by_head_dim[D]
    got = flash_interpolated_attention(q, k, v, coef, mode, static_smax="auto", **kw)
    torch.cuda.synchronize()
    slower = (route, names[dtype], D, mode) in STATIC_SHIFT_SLOWER
    assert counter[D] == before + (0 if slower else 1) and fn.launches_by_head_dim[D] == before_d + 1
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("mode,S,L", [("self", 1024, 1024), ("fused_outer", 4096, 77), ("self", 256, 256)])
def test_flash_static_auto_keeps_exact_classes_exact(dev, mode, S, L):
    """"auto" keeps the classes the JAX model path keeps exact on their exact
    kernels: a one-pass self call (1024 tokens), the short-stream kernel's
    77-key call, own KV under FLASH_MIN_KV through dispatch_attention; and
    f16 everywhere. No static launch."""
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v = _randn((2, 4, S, 64), 1500, dtype), _randn((2, 4, L, 64), 1501, dtype), _randn((2, 4, L, 64), 1502,
                                                                                                   dtype)
        coef = torch.linspace(0, 1, 2, device=dev)
        fn = ATTN_WRAPPER[dtype]
        before = (dict(fn.launches_static), dict(fn.launches_static_midstream))
        dispatch_attention(q, k, v, coef, mode)
        flash_interpolated_attention(q, k, v, coef, mode, static_smax="auto")
        torch.cuda.synchronize()
        assert (fn.launches_static, fn.launches_static_midstream) == before


def test_flash_static_shift_refuses_what_has_no_instance(dev):
    """A float shift with no static instance raises (no fallback): in f16
    (ValueError, the D=512 self wrapper's and the wide head dims' too), past
    head dim 2048 (no kernel at all: NotImplementedError). Up to 2048 bf16
    and f32 have their instances (the wide ones' test is below)."""
    q = _randn((2, 2, 64, 64), 1600, torch.float16)
    with pytest.raises(ValueError, match="f16"):
        flash_interpolated_attention_f16(q, q, q, None, "self", static_smax=40.0)
    x = _randn((1, 1, 64, 512), 1602, torch.float16)
    with pytest.raises(ValueError, match="f16"):
        flash_self_attention_f16(x, x, x, static_smax=40.0)
    x = _randn((2, 1, 64, 640), 1603, torch.float16)
    with pytest.raises(ValueError, match="f16"):
        flash_interpolated_attention_f16(x, x, x, torch.zeros(2, device=dev), "fused_outer", static_smax=40.0)
    for dtype in (torch.bfloat16, torch.float32):
        for mode in ("fused_outer", "self"):
            x = _randn((2, 1, 64, 2056), 1601, dtype)
            with pytest.raises(NotImplementedError):
                ATTN_WRAPPER[dtype](x, x, x, torch.zeros(2, device=dev), mode, static_smax=40.0)


# the static-shift instances past head dim 160: flash_attention_dmid_static.cu (bf16) and
# flash_attention_dmid_f32_static.cu (f32), every mode and self mode at the caller's head dim, and the
# D=512 self kernels' (flash_attention_{f32,bf16}_d512_static.cu, the VAE mid block)
STATIC_DMID_DIMS = [192, 320, 448, 504, 512]


@pytest.mark.parametrize("dtype,D,mode", [
    pytest.param(dt, D, m, id=f"{name}-{D}-{m}") for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
    for D in STATIC_DMID_DIMS for m in MODES if not takes_d512_self(D, m, dt)])
@pytest.mark.parametrize("case", STATIC_CASES)
def test_flash_static_dmid_kernel_matches_plain(dev, dtype, D, mode, case):
    """The D=161-512 kernels' static-shift instances in every mode and self
    mode (where the D=512 self kernels do not take it: their test is below)
    at the caller's head dim: the rows layout (192, 320), the split one
    (448, 504, 512), f32's 32- and 16-key tiles; within the dtype's bound of
    the plain version's static shift, and of the exact instance on the same
    call (logits well inside the window)."""
    from aid_tpu_torch.ops.flash_attention import STATIC_DMID_ENTRIES, kernel_launch

    q, k, v, coef, kw = _static_inputs(dtype, D, case, 1700 + D)
    got, launch = kernel_launch(q, k, v, coef, mode, static_smax=40.0, **kw)
    assert launch.operands["entry"] == STATIC_DMID_ENTRIES[dtype]
    launch()
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0, **kw)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    exact, launch = kernel_launch(q, k, v, coef, mode, **kw)
    launch()
    torch.cuda.synchronize()
    assert _attn_err(got, exact) < 2 * ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
@pytest.mark.parametrize("B,H,S,L,D", [(1, 1, 16384, 16384, 512), (7, 1, 4096, 4096, 512), (1, 1, 4000, 4000, 512),
                                       (2, 2, 150, 77, 512), (1, 1, 1, 1, 512), (2, 1, 130, 33, 504)])
def test_flash_static_d512_kernel_matches_plain(dev, dtype, B, H, S, L, D):
    """The D=512 self kernels' static-shift instances at the VAE's shapes (a
    1024px frame, seven 512px frames, the tiled decode's ragged tile), ragged
    tails, one key, and a head dim the f32 route pads to 512: within the
    dtype's bound of the plain version's static shift and of the exact
    instance, one launch counted in the wrapper's launches_static."""
    from aid_tpu_torch.ops.flash_attention import STATIC_D512_ENTRIES, d512_launch

    q, k, v = (_randn((B, H, n, D), 1800 + i, dtype) for i, n in enumerate((S, L, L)))
    got, launch = d512_launch(q, k, v, static_smax=40.0)
    assert launch.operands["entry"] == STATIC_D512_ENTRIES[dtype]
    launch()
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, static_smax=40.0)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    wrapper = D512_WRAPPER[dtype]
    before = (wrapper.launches, wrapper.launches_static)
    through = wrapper(q, k, v, static_smax=40.0)
    torch.cuda.synchronize()
    routed = takes_d512_self(D, dtype=dtype)
    assert (wrapper.launches, wrapper.launches_static) == (before[0] + routed, before[1] + routed)
    assert _attn_err(through, want) < ATTN_RTOLS[dtype]
    exact, launch = d512_launch(q, k, v)
    launch()
    torch.cuda.synchronize()
    assert _attn_err(got, exact) < 2 * ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
@pytest.mark.parametrize("D,mode", [(320, "self"), (320, "fused_outer"), (448, "pure_inner"), (512, "self"),
                                    (512, "pure_outer"), (640, "fused_outer"), (1280, "self"), (2048, "pure_inner")])
def test_flash_static_wide_head_kernels_at_the_window_edges(dev, dtype, D, mode):
    """The window's edges on the static instances past 160 (the D=161-512
    ones, at 512 in self mode the D=512 self ones, past 512 the wide ones,
    split: two rows of 300 queries): near the bottom (row max
    ~ -23) the exact softmax; far above the top the plain version's CLIPPED
    result, finite, far from the exact one."""
    coef = torch.tensor([0.25, 0.75], device=dev)
    for hot in (False, True):
        q, k, v, scale = _window_inputs(dtype, hot, D=D)
        got = flash_interpolated_attention(q, k, v, coef, mode, scale=scale, static_smax=40.0)  # routed by dtype
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        clipped = flash_interpolated_attention_plain(q, k, v, coef, mode, scale=scale, static_smax=40.0)
        exact = flash_interpolated_attention_plain(q, k, v, coef, mode, scale=scale)
        assert _attn_err(got, clipped) < ATTN_RTOLS[dtype]
        if hot:
            assert _attn_err(got, exact) > 10 * ATTN_RTOLS[dtype]
        else:
            assert _attn_err(got, exact) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
@pytest.mark.parametrize("B,H,S,D,mode", [(7, 1, 4096, 320, "fused_outer"), (7, 1, 4096, 320, "self"),
                                          (7, 2, 1024, 320, "fused_outer"), (3, 2, 1024, 448, "pure_inner"),
                                          (1, 1, 4096, 512, "self")])
def test_flash_static_auto_launches_the_wide_head_instances(dev, dtype, B, H, S, D, mode):
    """"auto" through dispatch_attention at the wide-head and VAE call
    classes the JAX wrapper shifts: one launch of the D=161-512 kernels'
    static instance (launches_static_dmid, by head dim) or, in self mode
    past the dtype's DMID_SELF_MAX, the D=512 self kernels' (the wrapper's
    launches_static), unless STATIC_SHIFT_SLOWER keeps the class exact; the
    plain version's result."""
    from aid_tpu_torch.ops.flash_attention import STATIC_SHIFT_SLOWER, static_route

    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    q, k, v, coef, kw = _midstream_inputs(dtype, D, (B, H, S, S, None, None), 1900 + D)
    kw = kw if mode != "self" else {}
    d512 = takes_d512_self(D, mode, dtype)
    route = static_route(D, S, S, S, mode, dtype)
    assert route == ("d512" if d512 else "dmid")
    slower = (route, names[dtype], D, mode) in STATIC_SHIFT_SLOWER
    fn, wrapper = ATTN_WRAPPER[dtype], D512_WRAPPER[dtype]
    before = (dict(fn.launches_static_dmid), wrapper.launches_static)
    got = dispatch_attention(q, k, v, coef, mode, **kw)
    torch.cuda.synchronize()
    after = (dict(fn.launches_static_dmid), wrapper.launches_static)
    shifted = 0 if slower else 1
    if d512:
        assert after == (before[0], before[1] + shifted)
    else:
        assert after[0].get(D, 0) == before[0].get(D, 0) + shifted and after[1] == before[1]
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=None if slower else 40.0, **kw)
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
def test_flash_static_slower_class_stays_exact(dev, dtype, monkeypatch):
    """A class in STATIC_SHIFT_SLOWER keeps "auto" exact on its exact
    instance: with the D=161-512 fused_outer class and the D=512 self class
    put there, no static launch, the exact result."""
    from aid_tpu_torch.ops import flash_attention as fa

    name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    monkeypatch.setattr(fa, "STATIC_SHIFT_SLOWER", frozenset({("dmid", name, 320, "fused_outer"),
                                                               ("d512", name, 512, "self")}))
    fa._auto_shift.cache_clear()
    try:
        fn, wrapper = ATTN_WRAPPER[dtype], D512_WRAPPER[dtype]
        for D, mode, B, S in ((320, "fused_outer", 3, 1024), (512, "self", 1, 4096)):
            q, k, v, coef, kw = _midstream_inputs(dtype, D, (B, 1, S, S, None, None), 2000 + D)
            kw = kw if mode != "self" else {}
            before = (dict(fn.launches_static_dmid), wrapper.launches_static)
            got = dispatch_attention(q, k, v, coef, mode, **kw)
            torch.cuda.synchronize()
            assert (dict(fn.launches_static_dmid), wrapper.launches_static) == before
            want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
            assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    finally:
        fa._auto_shift.cache_clear()


# the wide kernels' static-shift instances (flash_attention_dwide_static.cu, bf16 and f32, every mode):
# (B, H, S, L, Le, endpoints, split): the key stream split across blocks (the static combine step), shared
# 150-key endpoints over 200 own keys split (two key tiles a segment at least, so the pure modes split too),
# per-row endpoints of their own length with enough blocks to fill the card (unsplit)
STATIC_DWIDE_CASES = [(2, 1, 100, 300, None, None, True), (4, 1, 40, 200, 150, 3, True),
                      (7, 4, 600, 200, 45, 4, False)]


@pytest.mark.parametrize("dtype", **STATIC_DTYPES)
@pytest.mark.parametrize("D", [520, 640, 1280, 2048])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", STATIC_DWIDE_CASES, ids=["split", "split-shared", "unsplit-per-row"])
def test_flash_static_dwide_kernel_matches_plain(dev, dtype, D, mode, case):
    """The wide kernels' static-shift instances in every mode, split (the
    static combine step) and unsplit: the exact entry's layout (workspace,
    split); within the dtype's bound of the plain version's static shift,
    and of the exact instance on the same call (logits well inside the
    window); one launch counted in launches_static_dwide under the
    instance's padded head dim through the wrapper."""
    from aid_tpu_torch.ops.flash_attention import STATIC_DWIDE_ENTRIES, dwide_tiles, kernel_launch

    *shape, split = case
    q, k, v, coef, kw = _static_inputs(dtype, D, shape, 2100 + D)
    kw = kw if mode != "self" else {}
    got, launch = kernel_launch(q, k, v, coef, mode, static_smax=40.0, **kw)
    exact, exact_launch = kernel_launch(q, k, v, coef, mode, **kw)
    ops = launch.operands
    assert ops["entry"] == STATIC_DWIDE_ENTRIES[dtype] and (ops["splits"] > 1) == split
    assert ops["splits"] == exact_launch.operands["splits"]
    launch()
    exact_launch()
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0, **kw)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
    assert _attn_err(got, exact) < 2 * ATTN_RTOLS[dtype]
    fn = ATTN_WRAPPER[dtype]
    Dk = dwide_tiles(D, dtype)[0]
    before = fn.launches_static_dwide[Dk]
    through = fn(q, k, v, coef, mode, static_smax=40.0, **kw)
    torch.cuda.synchronize()
    assert fn.launches_static_dwide[Dk] == before + 1
    assert torch.equal(through, got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16], ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B,H,S,D,mode", [(7, 1, 1024, 640, "fused_outer"), (7, 1, 1024, 640, "pure_inner"),
                                          (2, 1, 1024, 1280, "fused_outer"), (2, 1, 1024, 1024, "fused_inner"),
                                          (7, 1, 1024, 640, "self")])
def test_flash_static_auto_launches_the_dwide_instances(dev, dtype, B, H, S, D, mode):
    """"auto" through dispatch_attention past head dim 512: one launch of
    the wide kernels' static instance (launches_static_dwide, by the
    instance's padded head dim) where the JAX wrapper shifts (its endpoint
    modes) and no class of STATIC_SHIFT_SLOWER keeps it exact; none in f16,
    in f32 past 1024 (where the JAX wrapper raises) or in self mode over
    1024 tokens (the JAX wrapper's one-pass self call); the plain version's
    result, at the shift "auto" took."""
    from aid_tpu_torch.ops.flash_attention import STATIC_SHIFT_SLOWER, dwide_tiles, static_route

    name = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float16: "f16"}[dtype]
    q, k, v, coef, kw = _midstream_inputs(dtype, D, (B, H, S, S, None, None), 2200 + D)
    kw = kw if mode != "self" else {}
    assert static_route(D, S, S, S, mode, dtype) == "dwide"
    Dk = dwide_tiles(D, dtype)[0]
    shifted = (dtype == torch.bfloat16 or (dtype == torch.float32 and D <= 1024)) and mode != "self" and (
        "dwide", name, Dk, mode) not in STATIC_SHIFT_SLOWER
    fn = ATTN_WRAPPER[dtype]
    before = dict(fn.launches_static_dwide)
    got = dispatch_attention(q, k, v, coef, mode, **kw)
    torch.cuda.synchronize()
    assert fn.launches_static_dwide == {**before, Dk: before[Dk] + shifted}
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=40.0 if shifted else None, **kw)
    assert _attn_err(got, want) < ATTN_RTOLS[dtype]
