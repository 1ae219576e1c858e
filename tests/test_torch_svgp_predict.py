"""The serving slice of the port against ``gpsig_tpu``: ``predict_f`` and
``predict_y`` at float64 and float32, with learned weights, without
normalization and on the integrated path.

Split from ``test_torch_svgp_serving.py`` (its set-up and tolerances:
<= 1e-9 at float64, <= 1e-4 at float32), so that no port test file queues
ahead of the suite's long JAX files under xdist's ``loadfile``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_svgp_serving import TOL, _close, _setup


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", ["default", "learn_weights",
                                     "unnormalized", "integrated_path"])
def test_predict_f_and_y(dtype, variant):
    kw = {"default": {}, "learn_weights": {"learn_weights": True},
          "unnormalized": {"normalization": False},
          "integrated_path": {"difference": False}}[variant]
    jmodel, params, tmodel, Xq = _setup(dtype, **kw)

    def jax_predict(p, X):  # one jax.jit program: eager JAX compiles every op
        f = jmodel.predict_f(p, X)
        # predict_y is the likelihood on predict_f's output (svgp.py:161-164)
        return f, jmodel.likelihood.predict_mean_and_var(*f)

    jf, jy = jax.jit(jax_predict)(params, jnp.asarray(Xq))
    with torch.no_grad():
        tf = tmodel.predict_f(torch.from_numpy(Xq))
        ty = tmodel.predict_y(torch.from_numpy(Xq))
    for a, b in zip(jf + jy, tf + ty):
        _close(a, b, TOL[dtype])
    assert np.all(np.isfinite(ty[0].numpy()))
