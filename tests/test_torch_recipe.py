"""The port's ``recipes.train_gpsig_classifier`` on the CPU at the
configuration of ``tests/test_recipe_golden.py`` (data from
``benchmarks/datasets/make_synthetic.write_mat``), held to the JAX
package's pinned results in ``tests/goldens/gpsig_recipe_synthetic.json``
with the same bands (+-0.02 accuracy, +-0.05 nlpp); then the files and
per-phase checkpoints it writes, resuming from them, and lags."""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from gpsig_tpu_torch import recipes

_HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(_HERE, os.pardir, "benchmarks", "datasets"))

ACC_TOL = 0.02
NLPP_TOL = 0.05


def _run(tmp_path, variant, **kw):
    from make_synthetic import write_mat

    common = dict(minibatch_size=12, max_len=16, num_lags=None,
                  val_split=0.2, data_dir=str(tmp_path),
                  save_dir=str(tmp_path / "out"), epochs_cap=2,
                  experiment_idx=0, seed=0, device="cpu")
    common.update(kw)
    if variant == "bernoulli_tensors":
        write_mat(str(tmp_path / "SyntheticBinary.mat"), num_classes=2,
                  per_class_train=8, per_class_test=4, length=16, seed=1)
        return recipes.train_gpsig_classifier(
            "SyntheticBinary", num_levels=2, num_inducing=12,
            increments=True, **common)
    write_mat(str(tmp_path / "SyntheticLibras.mat"), num_classes=3,
              per_class_train=8, per_class_test=4, length=16, seed=0)
    if variant == "multiclass_tensors":
        return recipes.train_gpsig_classifier(
            "SyntheticLibras", num_levels=2, num_inducing=12,
            increments=True, **common)
    return recipes.train_gpsig_classifier(
        "SyntheticLibras", num_levels=2, num_inducing=10, use_tensors=False,
        **common)


@pytest.mark.parametrize("variant", ["multiclass_tensors",
                                     "bernoulli_tensors",
                                     "multiclass_sequences"])
def test_recipe_matches_the_jax_goldens(tmp_path, variant):
    with open(os.path.join(_HERE, "goldens",
                           "gpsig_recipe_synthetic.json")) as f:
        golden = json.load(f)[variant]
    res = _run(tmp_path, variant)
    assert abs(res["test_acc"] - golden["test_acc"]) <= ACC_TOL, (res, golden)
    assert abs(res["test_nlpp"] - golden["test_nlpp"]) <= NLPP_TOL, (
        res, golden)
    assert abs(res["val_nlpp"] - golden["val_nlpp"]) <= NLPP_TOL, (
        res, golden)
    assert np.isfinite(res["val_nlpp"])


def test_recipe_files_checkpoints_and_resume(tmp_path):
    """The results on disk (``.json``, ``.pkl`` with a record at the end of
    each phase), one checkpoint per phase under the JAX recipe's names, and
    a rerun with ``resume=True`` after the run finished: every phase
    resumes at its end and the results are the same."""
    ckpt = tmp_path / "ckpt"
    res = _run(tmp_path, "multiclass_tensors", checkpoint_dir=str(ckpt))
    out = tmp_path / "out"
    with open(out / "SyntheticLibras_0.json") as f:
        assert json.load(f) == res
    with open(out / "SyntheticLibras_0.pkl", "rb") as f:
        hist = pickle.load(f)
    assert hist["results"] == res
    assert "best" not in hist and "final_params" not in hist
    assert [k for k in hist if isinstance(k, int)] == [1, 2, 3, 4, 5, 6, 7,
                                                       8]
    assert sorted(os.listdir(ckpt)) == [f"SyntheticLibras_0_phase{k}.ckpt"
                                        for k in range(1, 5)]
    again = _run(tmp_path, "multiclass_tensors", checkpoint_dir=str(ckpt),
                 resume=True)
    assert again == res


def test_recipe_with_lags_and_what_it_refuses(tmp_path):
    """``num_lags=1`` (the reference runner's) trains the lag leaves through
    all four phases; a dataset that is not on disk raises as the JAX
    loader does (``low_rank=True`` is ported: test_torch_low_rank_svgp)."""
    res = _run(tmp_path, "multiclass_tensors", num_lags=1)
    assert all(np.isfinite(v) for v in res.values())
    assert 0.0 <= res["test_acc"] <= 1.0
    with pytest.raises(FileNotFoundError, match="NoSuchSet"):
        recipes.train_gpsig_classifier("NoSuchSet", data_dir=str(tmp_path),
                                       device="cpu")
