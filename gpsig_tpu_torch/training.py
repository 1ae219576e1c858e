"""Training loop: NAdam with history, best-on-validation and patience.

The port of ``gpsig_tpu/training.py``.  What differs from the JAX package:

* an optimizer is a factory, ``opt(params) -> torch.optim.Optimizer``
  (``nadam(1e-3)``), built inside ``optimize`` over the parameters a phase
  trains, where the JAX package passes an ``optax`` transform;
* ``NAdam`` is ``optax.nadam`` step for step (``torch.optim.NAdam`` is
  another rule: ``momentum_decay=4e-3`` and a momentum schedule);
* ``loss_fn(model, *batch)`` takes the model where the JAX package's
  ``loss_fn(params, *batch)`` takes the parameter pytree; the model is
  trained in place, and ``history['final_params']`` and the best-on-val
  snapshot are parameter trees in the JAX layout (``convert.to_numpy_tree``);
* parameters are selected by their ``/``-joined JAX names (``kern/variances``,
  ``ind/Z``, ``q_sqrt``; ``convert.named_leaves``).  A frozen leaf gets no
  update and no optimizer moments, as under ``optax.masked``.

Checkpoint and resume (``checkpoint_path``, ``resume_from``) wait for
``checkpoint.py`` (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from . import config as cfg
from . import convert


class NAdam(torch.optim.Optimizer):
    """``optax.nadam`` (optax 0.2.6: ``scale_by_adam(nesterov=True)`` then
    ``scale_by_learning_rate``).  With t counted from 1 and g the gradient::

        mu = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
        mu_hat = b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
        nu_hat = nu / (1 - b2^t)
        p -= lr mu_hat / (sqrt(nu_hat) + eps)

    A parameter without a gradient steps with g = 0, as optax sees a zero
    gradient for a leaf the loss does not use."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("NAdam.step takes no closure")
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                t = state["count"] + 1
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mu_hat = (mu * (b1 / (1.0 - b1 ** (t + 1)))
                          + g * ((1.0 - b1) / (1.0 - b1 ** t)))
                nu_hat = nu / (1.0 - b2 ** t)
                p.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))
                state["count"] = t


def nadam(learning_rate: float = 1e-3):
    """The reference benchmarks' optimizer (``train_gpsig.py:106``), as a
    factory over parameters."""
    return functools.partial(NAdam, lr=learning_rate)


def path_mask(model, predicate: Callable[[str], bool]) -> dict:
    """{name: bool} from a predicate over the '/'-joined parameter names."""
    return {name: bool(predicate(name))
            for name in convert.named_leaves(model)}


def multi_optimizer(pairs, model, mask: dict | None = None) -> list:
    """Partition the parameters among several optimizers run in one phase.

    Each parameter goes to the FIRST ``(opt, predicate)`` pair whose
    predicate matches its name; unmatched parameters, and those ``mask``
    sets False, are frozen (no update, no moments).  Returns the built
    optimizers, one for each pair that got parameters."""
    groups: list[list] = [[] for _ in pairs]
    for name, p in convert.named_leaves(model).items():
        if mask is not None and not mask[name]:
            continue
        for i, (_, pred) in enumerate(pairs):
            if pred(name):
                groups[i].append(p)
                break
    return [opt(ps) for (opt, _), ps in zip(pairs, groups) if ps]


def masked_optimizer(opt, model, mask: dict) -> list:
    """``opt`` over the parameters ``mask`` sets True; the others frozen."""
    return multi_optimizer([(opt, lambda _: True)], model, mask)


def minibatch_indices(rng: np.random.RandomState, num_data: int,
                      batch_size: int):
    """Host-side shuffled minibatch index stream (epoch reshuffling)."""
    while True:
        perm = rng.permutation(num_data)
        for i in range(0, num_data - batch_size + 1, batch_size):
            yield perm[i:i + batch_size]


class MinibatchStream:
    """Checkpointable shuffled minibatch index stream.

    Same draw sequence as :func:`minibatch_indices` and as the JAX
    package's stream for the same seed, with a ``state()``/``set_state()``
    pair that resumes at the exact position in the exact permutation."""

    def __init__(self, num_data: int, batch_size: int, seed_or_rng=0):
        self.num_data = int(num_data)
        self.batch_size = int(batch_size)
        if isinstance(seed_or_rng, np.random.RandomState):
            self.rng = seed_or_rng
        else:
            self.rng = np.random.RandomState(seed_or_rng)
        self._perm = None
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._perm is None or self._pos + self.batch_size > self.num_data:
            self._perm = self.rng.permutation(self.num_data)
            self._pos = 0
        idx = self._perm[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def state(self) -> dict:
        """Serializable snapshot of the stream."""
        name, keys, pos, has_gauss, gauss = self.rng.get_state()
        if name != "MT19937":
            raise ValueError(f"unexpected bit generator {name}")
        perm = self._perm if self._perm is not None else np.zeros(0, np.int64)
        return {
            "mt_keys": np.asarray(keys, np.uint32),
            "mt_pos": np.asarray(pos, np.int64),
            "has_gauss": np.asarray(has_gauss, np.int64),
            "gauss": np.asarray(gauss, np.float64),
            "perm": np.asarray(perm, np.int64),
            "pos": np.asarray(self._pos, np.int64),
        }

    def set_state(self, state: dict) -> None:
        self.rng.set_state((
            "MT19937", np.asarray(state["mt_keys"], np.uint32),
            int(state["mt_pos"]), int(state["has_gauss"]),
            float(state["gauss"]),
        ))
        perm = np.asarray(state["perm"], np.int64)
        self._perm = perm if perm.size else None
        self._pos = int(state["pos"])


class BatchIterator:
    """Minibatch tuples ``(arr[idx] for arr in arrays)`` from a
    :class:`MinibatchStream`, forwarding its state.

    The arrays are moved once, at construction, to ``device``
    (``config.default_device()``, the card, unless given), so each
    minibatch is an index into a dataset that already lives there.
    ``batch_fn`` (optional) turns the index array into the batch tuple
    instead."""

    def __init__(self, stream: MinibatchStream, *arrays, batch_fn=None,
                 device=None):
        self.stream = stream
        self.device = torch.device(device or cfg.default_device())
        self.arrays = tuple(torch.as_tensor(a, device=self.device)
                            for a in arrays)
        self.batch_fn = batch_fn

    def __iter__(self):
        return self

    def __next__(self):
        idx = next(self.stream)
        if self.batch_fn is not None:
            return self.batch_fn(idx)
        at = torch.as_tensor(idx, device=self.device)
        return tuple(a[at] for a in self.arrays)

    def state(self):
        return self.stream.state()

    def set_state(self, state):
        self.stream.set_state(state)


def optimize(loss_fn, model, opt, *, max_iter: int, data_iter=None,
             trainable: Callable[[str], bool] | None = None,
             val_scorer=None, lower_is_better: bool = False,
             history: dict | None = None, save_best_params: bool = False,
             patience: int | None = None, print_freq: int = 50,
             save_freq: int = 50, save_params_history: bool = False,
             checkpoint_path: str | None = None,
             checkpoint_extra: dict | None = None,
             resume_from: str | None = None, log_fn=print) -> dict:
    """Run an optimization phase on ``model`` in place.

    Args:
      loss_fn: ``loss_fn(model, *batch) -> scalar tensor``.
      model: the ``SVGP`` to train.
      opt: an optimizer factory (``nadam(1e-3)``), or a list of
        ``(factory, predicate)`` pairs partitioning the parameters among
        several optimizers (first match wins, unmatched frozen).
      max_iter: number of steps in this phase.
      data_iter: iterator of batch tuples passed to ``loss_fn``; if None,
        ``loss_fn(model)`` runs full-batch.
      trainable: predicate over parameter names; False leaves are frozen.
      val_scorer: ``val_scorer(model) -> score`` or a list of scores (the
        last one is used for best/patience), evaluated every ``save_freq``
        steps.
      history: resumable history dict keyed by iteration.
      save_params_history: record the parameter tree at every snapshot.
      checkpoint_path, checkpoint_extra, resume_from: not ported yet.

    Returns the updated history; ``history['final_params']`` holds the
    last parameters and ``history['best']['params']`` the best on
    validation, as JAX-layout trees.
    """
    if checkpoint_path is not None or resume_from is not None:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet: ROADMAP Queue 1, item 6 "
            "(checkpoint.py)")
    del checkpoint_extra
    if history is None:
        history = {}
    numeric_iters = [k for k in history if isinstance(k, int)]
    start_iter = max(numeric_iters) if numeric_iters else 0
    start_time = history[start_iter]["time"] if start_iter else 0.0

    mask = path_mask(model, trainable or (lambda _: True))
    pairs = opt if isinstance(opt, list) else [(opt, lambda _: True)]
    optimizers = multi_optimizer(pairs, model, mask)
    best = history.get("best")
    stopped_early = False
    t0 = time.time()

    for it in range(start_iter + 1, start_iter + max_iter + 1):
        batch = next(data_iter) if data_iter is not None else ()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        loss = loss.detach()
        for o in optimizers:
            o.step()

        now = time.time() - t0 + start_time
        if it % print_freq == 0:
            log_fn(f"iter {it} | time {now:.1f}s | loss {float(loss):.4f}")

        if it % save_freq == 0 or it == start_iter + max_iter:
            rec: dict[str, Any] = {"time": now, "loss": float(loss),
                                   "elbo": -float(loss)}
            if save_params_history:
                rec["params"] = convert.to_numpy_tree(model)
            if val_scorer is not None:
                scores = val_scorer(model)
                rec["val"] = scores
                score = (scores[-1] if isinstance(scores, (list, tuple))
                         else scores)
                log_fn(f"iter {it} | val {scores}")
                if save_best_params:
                    improved = (
                        best is None
                        or (lower_is_better and score <= best["val_score"])
                        or (not lower_is_better
                            and score >= best["val_score"])
                    )
                    if improved:
                        best = {"iter": it, "time": now,
                                "elbo": -float(loss), "val": scores,
                                "val_score": score,
                                "params": convert.to_numpy_tree(model)}
                        history["best"] = best
                if patience is not None and best is not None:
                    if it - best["iter"] > patience:
                        log_fn(f"no val improvement for {patience} iters: "
                               "stopping early")
                        stopped_early = True
            history[it] = rec
        if stopped_early:
            break

    model.zero_grad(set_to_none=True)
    history["final_params"] = convert.to_numpy_tree(model)
    return history


def restore_best(model, history):
    """Load the best-on-validation parameters into ``model`` if they were
    tracked, else leave the final ones; returns the model."""
    if "best" in history and "params" in history["best"]:
        convert.load_jax_params(model, history["best"]["params"])
    return model
