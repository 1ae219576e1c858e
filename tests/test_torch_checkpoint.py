"""``checkpoint`` and ``training.optimize``'s checkpoint/resume in the port
(small Bernoulli SVGP, d=2, M=2, 8 inducing tensors, float64 on the CPU):
the counterparts of ``tests/test_svgp_variants.py``'s resume tests.  A
resumed run is held bit for bit to the uninterrupted one."""

import numpy as np
import pytest
import torch

import gpsig_tpu_torch as T
from gpsig_tpu_torch import checkpoint, convert, training

D, M, NZ, N, L = 2, 2, 8, 20, 10


def _data():
    rng = np.random.RandomState(31)
    X = rng.randn(N, L, D)
    y = (X[:, :, 0].mean(axis=1) > 0).astype(np.float64)
    return X, y[:, None]


def _model():
    X, _ = _data()
    Z = T.utils.suggest_initial_inducing_tensors(X, M, NZ, seed=0)
    return T.SVGP(
        T.kernels.SignatureRBF(D, M, dtype=torch.float64, device="cpu"),
        T.InducingTensors(Z, M, dtype=torch.float64, device="cpu"),
        T.likelihoods.Bernoulli(), num_latent=1, num_data=N, device="cpu")


def _run(path=None, resume=None, seed=7, **kw):
    """``optimize`` on a fresh model, optimizer and stream."""
    model = _model()
    X, Y = _data()
    data = training.BatchIterator(training.MinibatchStream(N, 5, seed), X, Y,
                                  device="cpu")
    opts = dict(max_iter=12, save_freq=2, print_freq=100,
                log_fn=lambda *_: None, checkpoint_path=path,
                resume_from=resume)
    opts.update(kw)
    hist = training.optimize(lambda m, xb, yb: m.loss(xb, yb), model,
                             training.nadam(1e-2), data_iter=data, **opts)
    return model, hist


def _same_params(a, b):
    ta, tb = convert.to_numpy_tree(a), convert.to_numpy_tree(b)
    for name in convert.named_leaves(a):
        x, y = ta, tb
        for key in name.split("/"):
            x, y = x[key], y[key]
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_save_restore_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "state.ckpt")
    stream = training.MinibatchStream(17, 5, 3)
    next(stream)
    state = {"params": {"kern": {"sigma": np.float32(1.5)},
                        "q_mu": np.arange(6.0).reshape(3, 2)},
             "moments": [{"count": 3, "mu": torch.ones(2, 2)}],
             "iter": np.asarray(4), "data_state": stream.state(),
             "extra": {"phase": np.asarray(2)}}
    checkpoint.save(path, state)
    assert checkpoint.exists(path) and not checkpoint.exists(path + ".tmp")
    raw = torch.load(path, weights_only=True)  # tensors and scalars only
    assert raw["data_state"]["mt_keys"].dtype == torch.int64
    like = {"params": {"kern": {"sigma": np.float32(0)},
                       "q_mu": np.zeros((3, 2))},
            "moments": [{"count": 0, "mu": torch.zeros(2, 2,
                                                       dtype=torch.float64)}],
            "iter": np.asarray(0), "data_state": stream.state(),
            "extra": {"phase": np.asarray(0)}}
    got = checkpoint.restore(path, like)
    np.testing.assert_array_equal(got["params"]["q_mu"],
                                  state["params"]["q_mu"])
    assert got["params"]["kern"]["sigma"].dtype == np.float32
    assert got["moments"][0]["count"] == 3
    assert got["moments"][0]["mu"].dtype == torch.float64
    assert got["data_state"]["mt_keys"].dtype == np.uint32
    np.testing.assert_array_equal(got["data_state"]["mt_keys"],
                                  state["data_state"]["mt_keys"])
    resumed = training.MinibatchStream(17, 5, 99)
    resumed.set_state(got["data_state"])
    np.testing.assert_array_equal(next(resumed), next(stream))
    # top-level keys missing from the file: an error, or like's value with
    # fill_missing; keys of the file that like lacks are ignored
    newer = dict(like, best={"has_best": np.asarray(0)})
    with pytest.raises(ValueError, match="missing"):
        checkpoint.restore(path, newer)
    got = checkpoint.restore(path, newer, fill_missing=True)
    assert int(got["best"]["has_best"]) == 0 and int(got["iter"]) == 4
    older = {k: v for k, v in like.items() if k != "extra"}
    assert set(checkpoint.restore(path, older)) == set(older)
    with pytest.raises(ValueError, match="keys"):
        checkpoint.restore(path, dict(like, params={"q_mu": np.zeros(1)}))


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """A run killed after 6 steps (checkpoint every 2) and resumed from the
    file by a fresh model, optimizer and stream (another seed) ends with the
    uninterrupted run's parameters and loss records, bit for bit."""
    model_a, hist_a = _run()
    path = str(tmp_path / "crash.ckpt")
    _run(path, max_iter=6)
    model_b, hist_b = _run(resume=path, seed=0)
    _same_params(model_a, model_b)
    assert [k for k in hist_b if isinstance(k, int)] == [8, 10, 12]
    for it in (8, 10, 12):
        assert hist_a[it]["loss"] == hist_b[it]["loss"]


def test_resume_restores_best_and_early_stop(tmp_path):
    """Checkpoints carry the best-on-validation snapshot and the tripped
    early stop: a resumed run restores the same best parameters as the
    uninterrupted one, and a run killed after stopping early trains no
    further on resume."""
    calls = {"n": 0}

    def val_scorer(_):
        calls["n"] += 1
        return [1.0, 10.0 - calls["n"]]  # strictly decreasing after iter 2

    common = dict(val_scorer=val_scorer, save_best_params=True)
    model_a, hist_a = _run(**common)
    calls["n"] = 0
    path = str(tmp_path / "crash.ckpt")
    _run(path, max_iter=6, **common)
    calls["n"] = 3  # the scorer's state as the uninterrupted run has it
    model_b, hist_b = _run(resume=path, seed=0, **common)
    assert hist_b["best"]["iter"] == hist_a["best"]["iter"] == 2
    assert hist_b["best"]["val"] == hist_a["best"]["val"]
    training.restore_best(model_a, hist_a)
    training.restore_best(model_b, hist_b)
    _same_params(model_a, model_b)

    # early stop trips at iter 8 (best at 2, patience 5: 8 - 2 > 5); a run
    # killed after it trains no further on resume
    calls["n"] = 0
    path2 = str(tmp_path / "stopped.ckpt")
    model_c, hist_c = _run(path2, patience=5, **common)
    model_d, hist_d = _run(resume=path2, seed=0, patience=5, **common)
    assert max(k for k in hist_c if isinstance(k, int)) == 8
    assert not [k for k in hist_d if isinstance(k, int)]
    _same_params(model_c, model_d)


def test_incompatible_checkpoint_raises(tmp_path):
    path = str(tmp_path / "state.ckpt")
    _run(path, max_iter=2)
    # another model: other inducing tensors
    X, Y = _data()
    Z = T.utils.suggest_initial_inducing_tensors(X, M, NZ + 1, seed=0)
    other = T.SVGP(
        T.kernels.SignatureRBF(D, M, dtype=torch.float64, device="cpu"),
        T.InducingTensors(Z, M, dtype=torch.float64, device="cpu"),
        T.likelihoods.Bernoulli(), num_latent=1, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        training.optimize(lambda m, xb, yb: m.loss(xb, yb), other,
                          training.nadam(), max_iter=4,
                          data_iter=iter(lambda: (X, Y), None),
                          resume_from=path, log_fn=lambda *_: None)
    # another optimizer layout: the phase-1 mask where the file has all
    model = _model()
    with pytest.raises(ValueError, match="incompatible"):
        training.optimize(lambda m, xb, yb: m.loss(xb, yb), model,
                          training.nadam(), max_iter=4,
                          data_iter=iter(lambda: (X, Y), None),
                          trainable=lambda n: not n.startswith("kern"),
                          resume_from=path, log_fn=lambda *_: None)
    # a file that is not a state tree
    torch.save([1, 2], str(tmp_path / "junk.ckpt"))
    with pytest.raises(ValueError, match="incompatible"):
        training.optimize(lambda m, xb, yb: m.loss(xb, yb), model,
                          training.nadam(), max_iter=4,
                          data_iter=iter(lambda: (X, Y), None),
                          resume_from=str(tmp_path / "junk.ckpt"),
                          log_fn=lambda *_: None)
