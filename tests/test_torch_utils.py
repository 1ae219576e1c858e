"""The port's init heuristics equal ``gpsig_tpu.utils`` exactly for the same
seed, and the port imports without JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpsig_tpu import utils as jutils
from gpsig_tpu_torch import utils as tutils

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kw", [
    dict(increments=True, labels=True),
    dict(increments=False, labels=True),
    dict(increments=True, labels=False),
    dict(increments=False, labels=False, num_lags=2),
])
def test_inducing_tensors_equal(kw):
    rng = np.random.RandomState(1)
    X = rng.randn(40, 12, 3)
    labels = (np.arange(40) % 3) if kw.pop("labels") else None
    a = jutils.suggest_initial_inducing_tensors(X, 3, 17, labels=labels,
                                                seed=4, **kw)
    b = tutils.suggest_initial_inducing_tensors(X, 3, 17, labels=labels,
                                                seed=4, **kw)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_samples", [None, 50])
def test_lengthscales_equal(num_samples):
    rng = np.random.RandomState(2)
    X = rng.randn(30, 9, 4) * 3.0
    X[0, 3, 1] = np.nan
    np.testing.assert_array_equal(
        jutils.suggest_initial_lengthscales(X, num_samples, seed=3),
        tutils.suggest_initial_lengthscales(X, num_samples, seed=3))


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import gpsig_tpu_torch, gpsig_tpu_torch.ops._cuda_build\n"
        "import gpsig_tpu_torch.training\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.split('.')[0] in ('optax', 'gpsig_tpu') "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing falls back to the plain version."""
    from gpsig_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_cuda_build, "_BUILD_ROOT", tmp_path / "build")
    if (Path("/usr/local/cuda/bin/nvcc")).exists():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build()
    # the source hash keys the build directory and is stable
    assert _cuda_build._digest() == _cuda_build._digest()
