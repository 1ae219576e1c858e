"""The reference's GPSig classifier recipe on the port
(``benchmarks/models/train_gpsig.py::train_gpsig_classifier``).

    load -> inducing tensors (or sequences) and lengthscales from the
    data -> SVGP -> 4-phase schedule:
      1. the variational distribution only (kernel frozen);
      2. + kernel hyperparameters except the per-level variances, early
         stop on validation nlpp;
      3. + the per-level variances;
      4. kernel frozen, validation data folded into training, q(u)
         assimilated
    -> test metrics -> results on disk.

The schedule, masks, patience and ``epochs_cap`` arithmetic, per-phase
checkpoint names and the files written are the JAX recipe's.  The model is
built at float32 on ``device`` (``config.default_device()``, the card,
unless given) and trained in place.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from . import config as cfg
from . import datasets, kernels, likelihoods, metrics, training
from . import utils as gp_utils
from .inducing import InducingSequences, InducingTensors
from .models import SVGP


def train_gpsig_classifier(
    dataset: str, *, num_levels: int = 4, num_inducing: int = 500,
    normalize_data: bool = True, minibatch_size: int = 50,
    max_len: int = 400, increments: bool = True, learn_weights: bool = False,
    num_lags: int | None = None, low_rank: bool = False,
    val_split=None, test_split=None, experiment_idx=None,
    use_tensors: bool = True, save_dir: str = "./GPSig/",
    epochs_cap: int | None = None, data_dir: str | None = None, seed: int = 0,
    checkpoint_dir: str | None = None, resume: bool = False, device=None,
):
    """Train and evaluate one GPSig classifier; returns the results dict.

    ``epochs_cap`` scales down the reference's very long phase budgets
    (patience = max(500 epochs, 5000 iterations)) for short runs.
    ``checkpoint_dir`` writes a checkpoint per phase; with ``resume=True`` a
    killed run restarts from the last checkpoint of the phase it died in
    and continues the same trajectory.
    """
    device = torch.device(device or cfg.default_device())
    print(f"==== GPSig on {dataset} ====")
    X_train, y_train, X_val, y_val, X_test, y_test = datasets.load_dataset(
        dataset, val_split=val_split, test_split=test_split,
        normalize_data=normalize_data, add_time=True,
        max_len=max_len, data_dir=data_dir, seed=seed,
    )

    num_train, _, num_features = X_train.shape
    num_classes = np.unique(y_train).size
    dtype = torch.float32
    at = dict(dtype=dtype, device=device)

    # initialization heuristics (class-stratified)
    if use_tensors:
        Z = gp_utils.suggest_initial_inducing_tensors(
            X_train, num_levels, num_inducing, labels=y_train,
            increments=increments, num_lags=num_lags, seed=seed,
        )
        ind = InducingTensors(Z, num_levels, increments=increments,
                              learn_weights=learn_weights, **at)
    else:
        Z = gp_utils.suggest_initial_inducing_sequences(
            X_train, num_inducing, num_levels + 1, labels=y_train, seed=seed)
        ind = InducingSequences(Z, num_levels, learn_weights=learn_weights,
                                **at)

    l_init = gp_utils.suggest_initial_lengthscales(
        X_train, num_samples=1000, seed=seed)
    kern = kernels.SignatureRBF(num_features, num_levels, lengthscales=l_init,
                                num_lags=num_lags, low_rank=low_rank, **at)

    if num_classes == 2:
        lik = likelihoods.Bernoulli()
        num_latent = 1
    else:
        lik = likelihoods.MultiClass(num_classes)
        num_latent = num_classes

    model = SVGP(kern, ind, lik, num_latent=num_latent, num_data=num_train,
                 **at)

    def labels(y):
        return np.asarray(y, np.float32)[:, None]

    batch = min(minibatch_size, num_train)
    stream = training.MinibatchStream(num_train, batch, seed_or_rng=seed)
    arrays = (torch.as_tensor(X_train, **at), torch.as_tensor(labels(y_train),
                                                              **at))

    def data_iter():
        return training.BatchIterator(stream, *arrays, device=device)

    def loss_fn(m, xb, yb):
        return m.loss(xb, yb)

    name = dataset if experiment_idx is None else f"{dataset}_{experiment_idx}"

    def ckpt_kw(phase: int):
        """Per-phase checkpoint/resume wiring for optimize()."""
        if checkpoint_dir is None:
            return {}
        path = os.path.join(checkpoint_dir, f"{name}_phase{phase}.ckpt")
        kw = {"checkpoint_path": path,
              "checkpoint_extra": {"phase": np.asarray(phase)}}
        if resume:
            kw["resume_from"] = path
        return kw

    val_scorer = None
    if X_val is not None:
        X_val32 = X_val.astype(np.float32)

        def val_scorer(m):
            return [metrics.accuracy(m, X_val32, y_val, batch_size=batch),
                    metrics.nlpp(m, X_val32, y_val, batch_size=batch)]

    iters_per_epoch = max(1, num_train // batch)
    patience = max(500 * iters_per_epoch, 5000)
    if epochs_cap is not None:
        patience = min(patience, epochs_cap * iters_per_epoch)
    phase2_iters = 5000 * iters_per_epoch
    if epochs_cap is not None:
        phase2_iters = min(phase2_iters, epochs_cap * iters_per_epoch)
    save_freq = min(iters_per_epoch, 50)
    common = dict(val_scorer=val_scorer, save_best_params=X_val is not None,
                  lower_is_better=True, save_freq=save_freq,
                  print_freq=save_freq * 5)
    opt = training.nadam(1e-3)

    # phase 1: q(u) only
    hist = training.optimize(
        loss_fn, model, opt, max_iter=patience, data_iter=data_iter(),
        trainable=lambda n: not n.startswith("kern"), **common, **ckpt_kw(1))

    # phase 2: + kernel except per-level variances, early stopping
    hist = training.optimize(
        loss_fn, model, opt, max_iter=phase2_iters, data_iter=data_iter(),
        trainable=lambda n: n != "kern/variances", patience=patience,
        history=hist, **common, **ckpt_kw(2))
    training.restore_best(model, hist)

    # phase 3: everything
    hist = training.optimize(
        loss_fn, model, opt, max_iter=phase2_iters, data_iter=data_iter(),
        patience=patience, history=hist, **common, **ckpt_kw(3))
    training.restore_best(model, hist)

    results = {}
    if X_val is not None:
        results["val_acc"] = metrics.accuracy(model, X_val32, y_val,
                                              batch_size=batch)
        results["val_nlpp"] = metrics.nlpp(model, X_val32, y_val,
                                           batch_size=batch)
        print(f"val acc {results['val_acc']:.4f} "
              f"nlpp {results['val_nlpp']:.4f}")

        # phase 4: freeze the kernel, fold val into train, assimilate q(u)
        X_all = np.concatenate([X_train, X_val], axis=0)
        y_all = np.concatenate([y_train, y_val], axis=0)
        num_train = len(y_all)
        model.num_data = num_train
        arrays = (torch.as_tensor(X_all, **at),
                  torch.as_tensor(labels(y_all), **at))
        stream = training.MinibatchStream(num_train, batch,
                                          seed_or_rng=seed + 1)
        hist = training.optimize(
            loss_fn, model, opt, max_iter=patience, data_iter=data_iter(),
            trainable=lambda n: not n.startswith("kern"), history=hist,
            save_freq=save_freq, print_freq=save_freq * 5, **ckpt_kw(4))

    X_test32 = X_test.astype(np.float32)
    results["test_acc"] = metrics.accuracy(model, X_test32, y_test,
                                           batch_size=batch)
    results["test_nlpp"] = metrics.nlpp(model, X_test32, y_test,
                                        batch_size=batch)
    print(f"test acc {results['test_acc']:.4f} "
          f"nlpp {results['test_nlpp']:.4f}")

    os.makedirs(save_dir, exist_ok=True)
    hist["results"] = results
    hist.pop("final_params", None)
    hist.pop("best", None)
    with open(os.path.join(save_dir, name + ".pkl"), "wb") as f:
        pickle.dump(hist, f)
    with open(os.path.join(save_dir, name + ".json"), "w") as f:
        json.dump(results, f, indent=2)
    return results
