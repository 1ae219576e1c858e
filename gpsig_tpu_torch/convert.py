"""Parameters between the JAX package's pytree and the port's modules.

The bijectors of both packages are identical, so raw values carry over
unchanged: ``load_jax_params`` copies each leaf of a ``gpsig_tpu``
``SVGP.init_params()``-layout tree (numpy or JAX arrays; it only calls
``numpy.asarray`` on them) into the parameter of the same name, keeping the
module's dtype and device; ``to_numpy_tree`` gives the tree back.
``named_leaves`` names each parameter by its ``/``-joined JAX path
(``kern/variances``, ``ind/Z``, ``q_sqrt``, ``mean/A``, ``lik/variance``),
the names that ``training``'s masks and optimizers select on.
"""

from __future__ import annotations

import numpy as np
import torch


def named_leaves(model) -> dict:
    """{'/'-joined JAX path: parameter} of an SVGP, e.g. ``kern/variances``,
    ``ind/Z``, ``q_mu``, and a mean function's and a trainable
    likelihood's (``mean/A``, ``lik/variance``)."""
    out = {f"kern/{n}": p for n, p in model.kern.named_parameters()}
    out.update({f"ind/{n}": p for n, p in model.ind.named_parameters()})
    out["q_mu"] = model.q_mu
    out["q_sqrt"] = model.q_sqrt
    for prefix, module in (("mean", model.mean_function),
                           ("lik", model.likelihood)):
        if module is not None:
            out.update({f"{prefix}/{n}": p
                        for n, p in module.named_parameters()})
    return out


def _leaves(model) -> dict:
    """{path tuple: parameter} in the JAX pytree layout."""
    return {tuple(name.split("/")): p
            for name, p in named_leaves(model).items()}


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (k,)))
        return flat
    return {prefix: tree}


def load_jax_params(model, tree) -> None:
    """Copy a JAX ``SVGP`` parameter tree into ``model`` in place."""
    leaves = _leaves(model)
    flat = _flatten(tree)
    if set(flat) != set(leaves):
        raise ValueError(
            "parameter trees differ: only in the JAX tree "
            f"{sorted(set(flat) - set(leaves))}, only in the model "
            f"{sorted(set(leaves) - set(flat))}"
        )
    with torch.no_grad():
        for path, param in leaves.items():
            value = torch.from_numpy(np.array(flat[path]))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{'/'.join(path)}: shape {tuple(value.shape)} != "
                    f"{tuple(param.shape)}"
                )
            param.copy_(value)


def to_numpy_tree(model) -> dict:
    """The model's raw parameters as a JAX-layout tree of numpy arrays."""
    tree: dict = {}
    for path, param in _leaves(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        # a copy: on the CPU, .numpy() would share the parameter's memory
        node[path[-1]] = param.detach().cpu().numpy().copy()
    return tree
