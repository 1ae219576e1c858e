"""The port's ``preprocessing`` and ``datasets`` (its own numpy copies)
against ``gpsig_tpu``'s: arrays and labels equal bit for bit, splits
included, on a ``.mat`` written by ``benchmarks/datasets/make_synthetic``
and on small hand-written UEA ``.ts`` files with missing values."""

import os
import sys

import numpy as np
import pytest

from gpsig_tpu import datasets as jdata
from gpsig_tpu import preprocessing as jprep
from gpsig_tpu_torch import datasets as tdata
from gpsig_tpu_torch import preprocessing as tprep

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "benchmarks", "datasets"))

TS = """# a small UEA file
@problemName Tiny
@timeStamps false
@missing true
@univariate false
@classLabel true up down
@data
0.1,0.2,0.4,0.3:1.0,?,0.5,0.2:up
0.5,0.4,?:0.1,0.2,0.3:down
?,?,0.3,0.1,0.0:0.2,0.1,0.1,0.3,0.2:up
0.9,0.8,0.6,0.2:?,?,?,?:down
0.3,0.1,0.2,0.4:0.4,0.4,0.1,0.0:up
0.2,0.2,0.7:0.3,0.8,0.1:down
"""


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_preprocessing_equal():
    rng = np.random.RandomState(0)
    seqs = [rng.randn(n, 3) for n in (5, 9, 2, 9)]
    seqs[1][-3:] = seqs[1][-4]  # a repeat-padded tail
    for kw in (dict(), dict(pre=True), dict(pad_with=0.0, pre=True),
               dict(pad_with=float("nan"))):
        _equal(jprep.tabulate_list_of_sequences(seqs, **kw),
               tprep.tabulate_list_of_sequences(seqs, **kw))
    _equal(jprep.tabulate_list_of_sequences([s.T for s in seqs], orient_ax=1),
           tprep.tabulate_list_of_sequences([s.T for s in seqs], orient_ax=1))
    _equal(jprep.pad_sequence(seqs[0], 8), tprep.pad_sequence(seqs[0], 8))
    table = jprep.tabulate_list_of_sequences(seqs)
    _equal(jprep.add_time_to_table(table), tprep.add_time_to_table(table))
    _equal(jprep.add_time_to_table(table.reshape(4, -1), 3),
           tprep.add_time_to_table(table.reshape(4, -1), 3))
    for a, b in zip(jprep.add_time_to_list(seqs), tprep.add_time_to_list(seqs)):
        _equal(a, b)
    _equal(jprep.add_natural_parametrization_to_table(table),
           tprep.add_natural_parametrization_to_table(table))
    for a, b in zip(jprep.add_natural_parametrization_to_list(seqs),
                    tprep.add_natural_parametrization_to_list(seqs)):
        _equal(a, b)
    for n in (3, 4, 9):
        _equal(jprep.mean_pool_to_max_len(seqs[1], n),
               tprep.mean_pool_to_max_len(seqs[1], n))
    with pytest.raises(ValueError, match="inconsistent"):
        tprep.tabulate_list_of_sequences([np.zeros((2, 2)), np.zeros((2, 3))])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(val_split=0.2, normalize_data=True, add_time=True),
    dict(val_split=0.3, test_split=10, add_time=True, max_len=11),
    dict(val_split=5, normalize_data=True),
    dict(test_split=0.25, seed=3),
])
def test_load_dataset_mat_equal(tmp_path, kw):
    from make_synthetic import write_mat

    write_mat(str(tmp_path / "Synth.mat"), num_classes=4, per_class_train=7,
              per_class_test=3, length=23, seed=2)
    a = jdata.load_dataset("Synth", data_dir=str(tmp_path), **kw)
    b = tdata.load_dataset("Synth", data_dir=str(tmp_path), **kw)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        _equal(x, y)
    assert b[0].dtype == np.float64


def test_load_dataset_ts_with_missing_values(tmp_path):
    """The ``.ts`` parser with imputation, flat and in the UEA layout,
    string labels, with a validation split."""
    (tmp_path / "Tiny_TRAIN.ts").write_text(TS)
    (tmp_path / "Tiny_TEST.ts").write_text(TS)
    sub = tmp_path / "uea" / "Tiny"
    sub.mkdir(parents=True)
    (sub / "Tiny_TRAIN.ts").write_text(TS)
    (sub / "Tiny_TEST.ts").write_text(TS)
    for d in (tmp_path, tmp_path / "uea"):
        with pytest.warns(UserWarning, match="imputed"):
            a = jdata.load_dataset("Tiny", data_dir=str(d), add_time=True,
                                   val_split=2)
        with pytest.warns(UserWarning, match="imputed"):
            b = tdata.load_dataset("Tiny", data_dir=str(d), add_time=True,
                                   val_split=2)
        for x, y in zip(a, b):
            _equal(x, y)
        assert not np.isnan(b[0]).any()
    with pytest.raises(FileNotFoundError):
        tdata.load_dataset("Absent", data_dir=str(tmp_path))
    bad = tmp_path / "NoLabel_TRAIN.ts"
    bad.write_text("@data\n0.1,0.2\n")
    with pytest.raises(ValueError, match="classLabel"):
        tdata._parse_ts_file(str(bad))


def test_default_data_dir_rule():
    """The same rule as the JAX package: ``$GPSIG_TPU_DATA_DIR``, else
    ``benchmarks/datasets`` beside the package."""
    if "GPSIG_TPU_DATA_DIR" in os.environ:
        assert tdata.DEFAULT_DATA_DIR == os.environ["GPSIG_TPU_DATA_DIR"]
    else:
        assert (os.path.realpath(tdata.DEFAULT_DATA_DIR)
                == os.path.realpath(jdata.DEFAULT_DATA_DIR))
        assert os.path.realpath(tdata.DEFAULT_DATA_DIR).endswith(
            os.path.join("benchmarks", "datasets"))
