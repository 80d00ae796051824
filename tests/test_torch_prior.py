"""The port's coefficient selection against aid_tpu's: the Beta-prior
explore-and-select (``prior/beta.py``), its DP path search in Python and
native, the Bayesian (alpha, beta) search (``prior/bayes.py``), and the
whole slice, ``BetaPriorPipeline.generate_interpolation`` on the tiny SD
pipeline with a tiny CLIP-vision scorer.

The host logic is the same numpy and scipy on both sides, so with a fake
pipeline and a fake scorer both packages must take the same decisions
exactly. With the real tiny pipelines the frames agree to one uint8 step,
so every discrete choice (the gap a round bisects, the DP path) is first
checked to hold with a margin over what that difference can move; then
both packages must make it alike. f32 on the CPU.
"""

import itertools
import os

import numpy as np
import pytest

import torch_helpers as th
from aid_tpu.models import configs as jcfg
from aid_tpu.models.clip import CLIPVisionModel as JaxVision
from aid_tpu.models.params import convert_clip_vision_state_dict
from aid_tpu.prior import bayes as jax_bayes
from aid_tpu.prior import beta as jax_beta
from aid_tpu.prior.clip_scorer import make_clip_feature_fn as jax_feature_fn
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPVisionModel
from aid_tpu_torch.ops.interp import beta_cdf, generate_beta_schedule
from aid_tpu_torch.prior import bayes, beta, dp_solver
from aid_tpu_torch.prior.clip_scorer import make_clip_feature_fn
from test_torch_pipeline_sd import STEPS, _both, _latents, _same_images, pipes  # noqa: F401

# The whole slice's frames agree to one uint8 step (test_torch_pipeline_sd),
# in the few values that round apart; the two packages' cosine distances
# over the tiny CLIP tower then agree to ~7e-7 (measured), and the test
# asserts DIST_TOL over every pair of frames. A decision counts only where
# its margin exceeds 2 * DIST_TOL in both packages' own distances, so that
# rounding can neither pass nor fail the test. (One uint8 step in every
# value of every frame at once would move a distance by up to 1.5e-3.)
DIST_TOL = 1e-4


def _random_weights(seed, m):
    r = th.rng(seed)
    w = -np.ones((m, m))
    for i in range(m):
        for j in range(i + 1, m):
            w[i, j] = r.uniform(0.1, 1.0)
    return w


def _brute_force(n, m, w):
    """The smallest spread over every increasing n-node path 0 -> m-1."""
    best = None
    for mids in itertools.combinations(range(1, m - 1), n - 2):
        path = (0,) + mids + (m - 1,)
        ws = [w[path[i], path[i + 1]] for i in range(n - 1)]
        if -1 not in ws:
            best = min(best, max(ws) - min(ws)) if best is not None else max(ws) - min(ws)
    return best


def _spread(w, path):
    ws = [w[path[i], path[i + 1]] for i in range(len(path) - 1)]
    return max(ws) - min(ws)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dp_python_matches_jax_and_brute_force(seed):
    m, n = 8, 4
    w = _random_weights(seed, m)
    got = beta._find_minimal_spread_and_path_py(n, m, w)
    assert got == jax_beta._find_minimal_spread_and_path_py(n, m, w)
    d, path = got
    assert path[0] == 0 and path[-1] == m - 1 and len(path) == n and path == sorted(path)
    # the bisection stops within its 1e-6 of the optimum
    assert _spread(w, path) <= _brute_force(n, m, w) + 1e-6 and d >= _spread(w, path) - 1e-12


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_dp_native_matches_python(seed):
    """The port's g++ build of native/dp_solver.cc against the Python
    search: the same spread, a valid path. It builds into the git-ignored
    build/aid_tpu_torch/, never into the JAX package's native/."""
    m, n = 9, 4
    w = _random_weights(seed, m)
    d_nat, p_nat = dp_solver.find_minimal_spread_and_path(n, m, w)
    d_py, p_py = beta._find_minimal_spread_and_path_py(n, m, w)
    assert abs(_spread(w, p_nat) - _spread(w, p_py)) < 1e-6 and abs(d_nat - d_py) < 1e-6
    assert p_nat[0] == 0 and p_nat[-1] == m - 1 and len(p_nat) == n
    lib = dp_solver.library_path()
    assert lib.exists() and lib.parent == dp_solver.BUILD_DIR
    assert dp_solver.BUILD_DIR.parts[-2:] == ("build", "aid_tpu_torch")
    assert os.path.commonpath([lib, dp_solver._ROOT / "aid_tpu"]) != str(dp_solver._ROOT / "aid_tpu")


def test_dp_full_range_and_dispatch():
    """All-equal weights and a path forced to the full weight range solve
    (the reference's (None, None) crash is a documented deviation), through
    the dispatch and both searches, as the JAX package."""
    eq = np.full((4, 4), -1.0)
    eq[np.triu_indices(4, 1)] = 0.3
    forced = np.full((3, 3), -1.0)
    forced[0, 1], forced[1, 2], forced[0, 2] = 0.0, 1.0, 0.5
    for n, m, w, want_d in ((3, 4, eq, 0.0), (3, 3, forced, 1.0)):
        for solver in (beta.find_minimal_spread_and_path, beta._find_minimal_spread_and_path_py,
                       dp_solver.find_minimal_spread_and_path):
            d, path = solver(n, m, w)
            assert abs(d - want_d) < 1e-9 and path[0] == 0 and path[-1] == m - 1
        assert beta.find_minimal_spread_and_path(n, m, w) == jax_beta.find_minimal_spread_and_path(n, m, w)
    with pytest.raises(ValueError):
        dp_solver.find_minimal_spread_and_path(5, 3, forced)


@pytest.mark.parametrize("case", ["known", "noisy", "skewed"])
def test_fit_alpha_beta_matches_jax(case):
    xs = np.linspace(0.0, 1.0, 12) if case != "skewed" else np.concatenate([[0.0], np.sort(th.rng(20).random(9)), [1.0]])
    ds = np.diff(beta_cdf(xs, 4.0, 2.0))
    if case != "known":
        ds = ds * th.rng(21).uniform(0.7, 1.3, ds.size)
    got = beta.fit_alpha_beta(xs, ds)
    assert got == jax_beta.fit_alpha_beta(xs, ds)
    if case == "known":
        assert abs(got[0] - 4.0) < 1e-3 and abs(got[1] - 2.0) < 1e-3


class _FakePipe:
    """Deterministic stand-in for both packages' pipelines: frame t is a
    flat image of brightness t; records every call."""

    def __init__(self):
        self.calls, self.batch_calls = [], []

    @staticmethod
    def _img(t):
        return np.full((8, 8, 3), t * 255.0).astype(np.uint8)

    def interpolate_single(self, t, *args, **kwargs):
        self.calls.append(float(t))
        return np.stack([self._img(0.0), self._img(t), self._img(1.0)])

    def generate_latent(self, seed=0):  # the JAX package's name
        return np.zeros((1, 4, 4, 4), np.float32)

    _seeded_latent = generate_latent  # the port's

    def interpolate(self, latent_start=None, latent_end=None, prompt_start="", prompt_end="", ts=None, **kwargs):
        ts = np.asarray(ts, np.float32)
        assert ts[0] == 0.0 and ts[-1] == 1.0 and np.all(np.diff(ts) >= 0)
        self.batch_calls.append([float(t) for t in ts])
        return np.stack([self._img(t) for t in ts])

    def interpolate_save_gpu(self, *args, size=3, alpha=None, beta=None, **kw):
        ts = generate_beta_schedule(size, alpha or 3, beta or 3, force_endpoints=True)
        return np.stack([self._img(t) for t in ts])


def _fake_features(images):
    """Brightness to an angle: cosine distance grows with |t_a - t_b|, with
    an uneven curve so the Beta fit moves."""
    t = images.reshape(images.shape[0], -1).mean(axis=1) / 255.0
    ang = 0.9 * t ** 1.7
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


@pytest.mark.parametrize("batch_k", [1, 4])
@pytest.mark.parametrize("uniform", [False, True])
def test_beta_prior_with_fakes_matches_jax(batch_k, uniform):
    """Both packages explore the same coefficients, in the same calls, and
    select the same frames."""
    runs = []
    for module in (beta, jax_beta):
        pipe = _FakePipe()
        bp = module.BetaPriorPipeline(pipe, _fake_features)
        out = bp.generate_interpolation("a", "b", exploration_size=10, interpolation_size=5, batch_k=batch_k,
                                        uniform=uniform, num_inference_steps=2)
        runs.append((pipe.calls, pipe.batch_calls, bp.xs, bp.ds, bp.alpha, bp.beta_param,
                     [float(im.mean()) for im in out]))
    assert runs[0] == runs[1]
    calls, batch_calls, xs, *_ = runs[0]
    assert len(xs) == 10 and xs == sorted(xs) and len(runs[0][-1]) == 5
    assert bool(batch_calls) == (batch_k > 1)


def _fake_lpips(images):
    t = images.reshape(images.shape[0], -1).mean(axis=1) / 255.0
    return np.abs(np.diff(t ** 1.3))


@pytest.mark.parametrize("target", [0.9, 0.999])
def test_bayesian_selection_with_fakes_matches_jax(target):
    """The same probes and the same (alpha, beta): with 0.9 the grid's early
    exit ends it, with 0.999 the GP iterations run."""
    kw = dict(size=5, num_inference_steps=6, n_iter=4, target_score=target)
    got = bayes.bayesian_prior_selection(_FakePipe(), None, None, "a", "b", _fake_lpips, **kw)
    want = jax_bayes.bayesian_prior_selection(_FakePipe(), None, None, "a", "b", _fake_lpips, **kw)
    assert got == want and all(1.0 <= v <= 6.0 for v in got)


def test_gp_optimizer_matches_jax():
    opts = [m.GPOptimizer(bounds=np.array([[0.0, 10.0], [0.0, 10.0]]), seed=0) for m in (bayes, jax_bayes)]

    def f(x):
        return -((x[0] - 3.0) ** 2 + (x[1] - 7.0) ** 2)

    for opt in opts:
        for x in [[0, 0], [10, 10], [5, 5], [0, 10], [10, 0]]:
            opt.register(x, f(x))
    for _ in range(12):
        xs = [opt.suggest() for opt in opts]
        np.testing.assert_array_equal(xs[0], xs[1])
        for opt, x in zip(opts, xs):
            opt.register(x, f(x))
    best = opts[0].max["params"]
    assert abs(best[0] - 3.0) < 1.5 and abs(best[1] - 7.0) < 1.5


# --- the real tiny pipelines ---------------------------------------------


def test_gen_batch_middles_equal_interpolate_single(pipes):
    """_gen_batch's middles, from one sorted (k + 2)-frame interpolate, come
    back in ts order and each equals the middle of a 3-frame
    interpolate_single at the same t (to one uint8 step)."""
    _, pipe = pipes
    (_, _), (ta, tb) = _both(*_latents(110))
    bp = beta.BetaPriorPipeline(pipe, None)
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", latent_start=ta, latent_end=tb,
              num_inference_steps=STEPS)
    ts = [0.7, 0.2, 0.45]
    middles = bp._gen_batch(ts, **kw)
    assert middles.shape == (3, 16, 16, 3)
    for t, mid in zip(ts, middles):
        _same_images(mid[None], bp._gen(t, **kw)[1:2])
    # missing latents come from seeds seed and seed + 1, as interpolate_single's
    kw.pop("latent_start"), kw.pop("latent_end")
    _same_images(bp._gen_batch([0.3], seed=5, **kw), bp._gen(0.3, seed=5, **kw)[1:2])


def _rounds(bp_class):
    """A BetaPriorPipeline subclass recording the coefficients each round
    generates, in order."""

    class Recording(bp_class):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rounds = []

        def _gen(self, t, **kw):
            self.rounds.append([t])
            return super()._gen(t, **kw)

        def _gen_batch(self, ts, **kw):
            self.rounds.append(list(ts))
            return super()._gen_batch(ts, **kw)

    return Recording


def _pairwise(bp):
    """All-pairs cosine distances of the explored frames (-1 below the diagonal)."""
    m = len(bp.features)
    w = -np.ones((m, m))
    for i in range(m):
        for j in range(i + 1, m):
            w[i, j] = bp._dist(bp.features[i], bp.features[j])
    return w


def _check_margins(bp):
    """Replay the exploration from the final frames' features: at every
    round the gaps it bisected must lead the others by more than
    2 * DIST_TOL, and the DP's path must beat every other path's spread by
    as much. Returns the margins."""
    index = {x: i for i, x in enumerate(bp.xs)}
    w = _pairwise(bp)
    cur, margins = [0.0, 0.5, 1.0], []
    for inserted in bp.rounds[1:]:
        ds = np.array([w[index[a], index[b]] for a, b in zip(cur, cur[1:])])
        order = np.argsort(-ds, kind="stable")
        k = len(inserted)
        if k < len(ds):
            margins.append(ds[order[k - 1]] - ds[order[k]])
        assert {int(i) for i in order[:k]} == {int(np.searchsorted(cur, t)) - 1 for t in inserted}
        cur = sorted(cur + inserted)
    m, n = len(bp.xs), len(bp.selected)
    spreads = sorted(_spread(w, (0,) + mids + (m - 1,)) for mids in itertools.combinations(range(1, m - 1), n - 2))
    margins.append(spreads[1] - spreads[0])
    assert _spread(w, bp.selected) == spreads[0]
    assert min(margins) > 2 * DIST_TOL, margins
    return margins


@pytest.fixture(scope="module")
def scorers():
    vision = th.seed_module(CLIPVisionModel(configs.TINY_CLIP_VISION), 30)
    params = th.to_jnp(convert_clip_vision_state_dict(th.numpy_state_dict(vision)))
    return make_clip_feature_fn(vision), jax_feature_fn(JaxVision(jcfg.TINY_CLIP_VISION), params)


@pytest.mark.parametrize("batch_k", [1, 4])
def test_selection_slice_matches_jax(pipes, scorers, batch_k):
    """generate_interpolation on both tiny SD pipelines from the same
    weights and latents, exploration 5, selection 3, 2 DDIM steps: the same
    rounds and coefficients, the same selected frames, to one uint8 step."""
    jax_pipe, pipe = pipes
    port_fn, jax_fn = scorers
    (ja, jb), (ta, tb) = _both(*_latents(120))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", exploration_size=5, interpolation_size=3,
              num_inference_steps=STEPS, batch_k=batch_k)
    results = []
    for module, p, fn, a, b in ((beta, pipe, port_fn, ta, tb), (jax_beta, jax_pipe, jax_fn, ja, jb)):
        bp = _rounds(module.BetaPriorPipeline)(p, fn)
        out = bp.generate_interpolation(latent_start=a, latent_end=b, **kw)
        bp.features = list(fn(np.stack([np.asarray(im) for im in bp.images])))
        bp.selected = [next(i for i, im in enumerate(bp.images) if im is sel) for sel in out]
        results.append((bp, out))
    (port, port_out), (jx, jax_out) = results
    _check_margins(port)
    _check_margins(jx)
    assert [len(r) for r in port.rounds] == [len(r) for r in jx.rounds]
    np.testing.assert_allclose(np.concatenate(port.rounds), np.concatenate(jx.rounds), rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.xs, jx.xs, rtol=0, atol=1e-4)
    assert np.abs(_pairwise(port) - _pairwise(jx)).max() < DIST_TOL
    np.testing.assert_allclose(port.ds, jx.ds, rtol=0, atol=DIST_TOL)
    assert port.selected == jx.selected and len(port.selected) == 3
    assert (port.alpha, port.beta_param) == pytest.approx((jx.alpha, jx.beta_param), rel=1e-3)
    for got, want in zip(port_out, jax_out):
        _same_images(got[None], np.asarray(want)[None])
