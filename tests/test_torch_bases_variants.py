"""The named variants of the eight bases without a hand kernel
(``SignatureCosine``, ``SignaturePoly``, ``SignatureMix``,
``SignatureMatern32``, ``SignatureMatern52``, ``SignatureSpectral`` and its
families and aliases) against ``gpsig_tpu``'s: keyword routing, bijectors,
raw leaves carried across, and ``K`` with its gradient at float64 (<=
1e-10 relative to the largest entry, the port's naive graph against
JAX's).

Split from ``test_torch_bases_ops.py`` (its helpers), so that no file holds
more than 9 tests.
"""

import jax
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from test_torch_bases_increments import rel_err

RNG = np.random.RandomState(13)
VARIANTS = [  # (name, keyword arguments, base)
    ("SignatureCosine", {}, "cosine"),
    ("SignaturePoly", {"gamma": 1.1, "degree": 2}, "poly"),
    ("SignatureMix", {}, "mix"),
    ("SignatureMatern32", {}, "matern32"),
    ("SignatureMatern52", {}, "matern52"),
    ("SignatureSpectral", {"family": "gauss", "Q": 3}, "spectral_rbf"),
    ("SignatureSpectral", {"family": "exponential"}, "spectral_exp"),
    ("SignatureSpectral", {"family": "mix", "Q": 4}, "spectral_mixed"),
]


@pytest.mark.parametrize("name,kwargs,base", VARIANTS,
                         ids=[v[2] for v in VARIANTS])
def test_variant_routing_and_guards(name, kwargs, base):
    """Each variant routes its keywords as JAX's does, takes a JAX tree of
    raw leaves through ``convert.load_jax_params`` and gives JAX's Gram;
    the norm guards keep a zero observation's gradient finite."""
    jk = getattr(G.kernels, name)(2, 2, **kwargs)
    tk = getattr(T.kernels, name)(2, 2, dtype=torch.float64, device="cpu",
                                  **kwargs)
    assert tk.base == jk.base == base
    assert tk.bijectors == jk.bijectors
    assert tk.constrain().keys() == jk.constrain(jk.init_params()).keys()
    params = jk.init_params(jax.random.PRNGKey(1))
    with torch.no_grad():
        for k, v in params.items():
            getattr(tk, k).copy_(torch.from_numpy(np.array(v)))
    X = RNG.randn(3, 6, 2) + 0.4
    X[0, 2] = 0.0  # an observation at the origin
    want = jax.jit(lambda p, x: jk.K(p, x))(params, X)
    Xt = torch.tensor(X, requires_grad=True)
    got = tk.K(Xt)
    assert rel_err(want, got) <= 1e-10
    got.sum().backward()
    assert bool(torch.isfinite(Xt.grad).all())
    with pytest.raises(ValueError, match="family"):
        T.kernels.SignatureSpectral(2, 2, family="nope", device="cpu")
