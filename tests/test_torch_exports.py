"""The port's package exports against the JAX package's.

Every name in each ``aid_tpu.X.__all__`` resolves on ``aid_tpu_torch.X``
(the top level, models, prior, metrics, pipelines, ops and utils), so code
written against ``aid_tpu`` can switch its imports; the top level also has
``__version__``. Importing the port builds nothing: the native DP solver of
``prior`` is built at its first use.
"""

import importlib
import subprocess
import sys

import pytest

SUBPACKAGES = ["", "models", "prior", "metrics", "pipelines", "ops", "utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_every_jax_export_resolves_on_the_port(sub):
    """Each name the JAX subpackage exports is an attribute of the port's,
    and the port's own __all__ holds it too."""
    jax_mod = importlib.import_module("aid_tpu" + (f".{sub}" if sub else ""))
    port = importlib.import_module("aid_tpu_torch" + (f".{sub}" if sub else ""))
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(jax_mod.__all__) <= set(port.__all__)


def test_top_level_version_and_lazy_subpackages():
    """``__version__`` at the top level; ``prior``, ``metrics`` and
    ``parallel`` load when first named, and importing the port neither
    imports them nor builds the native DP solver."""
    code = ("import sys, aid_tpu_torch as a; "
            "early = [m for m in ('aid_tpu_torch.prior', 'aid_tpu_torch.metrics', 'aid_tpu_torch.parallel') "
            "if m in sys.modules]; "
            "from aid_tpu_torch.prior import dp_solver; "
            "built = dp_solver.library.cache_info().currsize > 0; "
            "assert a.prior.BetaPriorPipeline and a.metrics.compute_gini and a.parallel.make_mesh; "
            "print(a.__version__, early, built)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    version, rest = proc.stdout.split(" ", 1)
    assert version and version == importlib.import_module("aid_tpu_torch").__version__
    assert rest.strip() == "[] False"
