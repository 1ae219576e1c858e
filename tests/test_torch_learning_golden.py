"""The port's counterpart of ``tests/test_learning_golden.py::
test_flagship_lags_config_learns``: the reference's flagship configuration
(``num_lags=1``, incremental inducing tensors) learns end to end through
``recipes.train_gpsig_classifier`` on the CPU, to the same bars (test
accuracy >= 0.9 against 1/3 chance, nlpp <= 0.15).

Marked ``slow``: excluded from the default suite (pytest.ini), run with
``pytest -m slow``.
"""

import os
import sys

import pytest

from gpsig_tpu_torch import recipes

_HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(_HERE, os.pardir, "benchmarks", "datasets"))


@pytest.mark.slow
def test_flagship_lags_config_learns(tmp_path):
    from make_synthetic import write_mat

    write_mat(str(tmp_path / "SyntheticLibras.mat"), num_classes=3,
              per_class_train=67, per_class_test=20, length=24, seed=0)
    res = recipes.train_gpsig_classifier(
        "SyntheticLibras", num_levels=3, num_inducing=40, increments=True,
        minibatch_size=32, max_len=24, num_lags=1, val_split=0.2,
        data_dir=str(tmp_path), save_dir=str(tmp_path / "out"),
        epochs_cap=25, experiment_idx=0, seed=0, device="cpu")
    assert res["test_acc"] >= 0.9, res
    assert res["test_nlpp"] <= 0.15, res
