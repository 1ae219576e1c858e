#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gpsig_tpu_torch``) on one GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: require CUDA, print versions and the card's name and power
   limit, build the hand-written kernels from ``gpsig_tpu_torch/csrc`` --
   the main library (1-8 levels) and, beside it, the ones for 9, 10 and 17
   levels and the K5/K6 ones for order 2 and order 4 at 4 levels and
   order 3 at 9 -- and print each's build time and ptxas's registers and
   stack frame for K1, K2, K3 and K5 at 4 levels, every kernel at 9 and 17,
   K3 at 10 and every order instance (the whole report goes to the details
   file);
2. kernels: K1 (Kzz) and K3 (Kzx) on the card at the benchmark shape
   (lt=10, nZ=500, d=14, N=32 and 50, L=93) and at ragged shapes, each held
   against its plain PyTorch version at f32 (<= 1e-5 * max(scale, 1)) and
   at f64 (<= 1e-4 * max(scale, 1)); K2 and K4, their backward kernels,
   under a random cotangent at the same shapes against their plain
   versions at f32 and f64 (<= 1e-4 * max(scale, 1): the gradients sum
   many more terms in another order); K1 and K2 in both modes (all pairs;
   symmetric, the main path's); K5 (seq x seq) and K6 (its backward)
   under the same bounds at the shapes of the inducing-sequences model --
   500 sequences of length 5 (symmetric), 500 x 50 at 5 vs 93 steps, 50 at
   93 (symmetric), 500 x 50 at 5 vs 205 steps in both argument orders --
   at lengths past one inner chunk on both sides: 50 at UWave's 315
   (symmetric), 20 at the reference runner's max_len 500 (symmetric), 7 x
   5 at 300 vs WalkvsRun's 1,918 in both orders -- and ragged 7 x 5 at 11
   vs 18 (rbf and linear, difference on and off); symmetric outputs must
   be exactly symmetric, and K2, K4 and K6 launched twice on the same
   inputs must give bit-identical gradients; K3 and K4 at 70,000 examples
   in one call (32 inducing tensors, L=6; the plain versions on slices of
   10,000), K1-K6 at 9, 10 and 17 levels and K2 also at 17 levels and
   d2 = 42; each level of a forward level stack and each gradient is held
   to the bounds at its own scale; then common.cuh's short expm1 (K1's,
   K2's, K3's and K5's) against float64 on a dense grid, alone (<= 5 ulp)
   and in the cancelling slot Gram and its partials (<= 16 float32
   epsilons of their terms); at PEMS's 963 features, K5/K6 on the Kzz and
   Kzx of 500 length-5 inducing sequences against 50 examples of 144
   steps, and K1-K4 on 500 inducing tensors; and ``fused_tensor_levels``
   launching K1 and K2 once each, in symmetric mode, its output exactly
   symmetric; and (2h) K1-K6 at the lagged width (d=14, num_lags=1, so
   d2 = 30) on the lagged model's own rows -- K1/K2 on 500 inducing
   tensors (symmetric), K3/K4 against 50 examples of 93 steps, K5/K6 on
   the sequences model's Kzz, Kzx and full Kxx -- under the same bounds,
   K2, K4 and K6 launched twice for bit-identical gradients;
3. serving: an SVGP at the benchmark width (SignatureRBF d=14 M=4, 500
   incremental inducing tensors, MultiClass C=10) behind a bucketed
   ``serving.Predictor`` with ``fused='on'`` answers ragged requests; K1's
   and K3's launch counters must rise, outputs be finite, each predictive
   mean row sum to 1 within 1e-3, and means agree within 1e-3 with the
   port's own f64 CPU path; then ``predict_f(full_cov=True)`` at N=50,
   L=93 must launch K5 once, give a covariance whose diagonal is
   ``predict_f``'s variance within 1e-5 relative, and whose jittered
   Cholesky succeeds;
5. training: on one minibatch of 50, the gradient of every leaf on the
   card must be non-zero where the f64 CPU path's is and lie within
   relative L2 1e-3 of it, relative to the larger of the leaf's own norm
   and 1e-3 of the largest leaf's; for ``kern/sigma`` also of
   ``kern/variances``' norm (the loss is invariant to a common scale of
   the covariances up to the jitter, so sigma's gradient is a sum of the
   per-level terms of variances' gradient that cancels to ~1e-7 of them,
   below what f32 resolves, and carries their absolute error); then
   ``training.optimize`` takes 30 NAdam(1e-3) steps over minibatches of
   50 of synthetic (2000, 93, 14) data under the reference's phase-2
   mask (all but ``kern/variances``): each of the four kernels must launch
   once a step (K5/K6 never), every loss be finite, the last ten losses
   average below the first ten, and the frozen leaf keep its bits;
6. inducing sequences: phases 3 and 5 again for the same SVGP with 500
   inducing sequences of length 5 (the recipe's ``use_tensors=False``,
   ``train_gpsig.py:76-80``): K5 must launch on the serving path, ``ind/Z``
   get a gradient, and K5 and K6 launch exactly twice a training step
   (Kzz and Kzx), K1-K4 never;
7. lags: phases 3 and 5 again for the tensors model with num_lags=1
   (``kern/lags`` and ``kern/gamma`` among the leaves whose gradients are
   checked; ``kern/lags`` is held to 2e-3, not 1e-3: its gradient is a
   nearly cancelling sum on white noise, ``LEAF_GRAD_BOUND``), the served
   means held to the f64 CPU path at the same bucket
   (with lags, repeat padding changes the lagged features); then the same
   for its Bernoulli twin (two classes, one latent);
8. the recipe: ``recipes.train_gpsig_classifier`` on data written at run
   time to a temporary directory in the ``.mat`` layout (2,000 training
   and 500 test sequences of 93 steps and 13 channels; ``add_time`` makes
   d = 14), with num_lags=1, 500 inducing tensors, M=4, val_split=0.2 and
   epochs_cap=1, for 10 classes (MultiClass) and 2 (Bernoulli): all four
   phases must run, K1-K4 launch, the results be finite and the test
   accuracy above chance; then (8b) phase 2 on the lagged model, run to its
   end, run again and killed between two checkpoints, and resumed by a
   fresh model, optimizer and stream, must end with the same parameters,
   best snapshot and loss records, bit for bit;
9. matern12 (``bench.py --svgp --base matern12``, SignatureMatern12):
   (9a) common.cuh's matern12 closed form and six partials against
   float64, then K1-K6 under matern12 against their plain versions -- K1/K2
   on 500 benchmark and 37 ragged inducing tensors (with and without
   increments, both modes), K3/K4 at 500 x 50 x 93 and in all four
   increments x difference cases, K5/K6 at the sequences model's Kzz, Kzx
   and full Kxx and at 315 steps (symmetric, and 20 x 10 distinct
   sequences) -- under phase 2's bounds where the pairs are distinct (a
   part whose f32 plain version misses the f32 bound against f64 held
   against f64), and at a symmetric Gram's diagonal pairs (r = 0, the
   |.| kink of exp(-r)) under JAX's matern12 bounds, 2e-3 forward and
   5e-3 gradient, against the f32 plain version; K2, K4 and K6 launched
   twice for bit-identical gradients, symmetric outputs exactly symmetric;
   (9b-9c) the matern12 tensors model served and trained as phases 3 and
   5 (a leaf that misses 1e-3 where the f32 plain path misses it too is
   held to that path's reading); (9d) the same for the matern12
   inducing-sequences model; (9e) its tensors model's
   ``predict_f(full_cov=True)`` as phase 3, its diagonal and mean within
   2e-3 (the kink: the full Gram's diagonal and the closed-form one are
   two f32 evaluations at r = 0); (9f, after phase 4) K1-K6
   under matern12 timed as phase 4a, and both models' request latency and
   training steps/s;
10. order > 1 (``SignatureRBF(14, 4, order=k)``, the reference's
   discretization; its (k x k) grid of partial tensors in K5/K6): (10a) K5
   and K6 at orders 2 and 4 (4 levels) on the sequences model's Kzz, Kzx
   and full Kxx, 50 at 315 steps (symmetric), 7 x 5 at 300 vs 1,918 in
   both argument orders, ragged 7 x 5 at 11 vs 18 (difference on and off,
   rbf and linear) and matern12's three Grams, and at order 3 (9 levels)
   on the short cases, against their plain versions under phase 2's bounds
   (matern12's diagonal pairs as phase 9a holds them); K6 twice
   bit-identical, symmetric outputs exactly symmetric; (10b) the order-2
   inducing-sequences model served, every leaf's gradient held, 30 steps
   with K5 and K6 twice a step, and ``predict_f(full_cov=True)`` (K5 three
   times: Kzz, Kzx, Kxx); (10c) the order-2 inducing-tensors model the same
   way under ``fused='auto'`` with K1 and K2 once a step and K3/K4 never
   (Kzx has no kernel past order 1, in JAX as here), and a ``fused='on'``
   twin raising on its Kzx; (10d) the order-4 (full grid) sequences model
   as 10b; (10e, after phase 9f) K5/K6 at orders 1, 2 and 4 at the Kzz,
   Kzx and full Kxx shapes against their plain versions, and the three
   models' request latency and training steps/s;
11. the eight bases without a hand kernel -- cosine, poly, mix,
   matern32, matern52 and spectral rbf/exp/mixed -- through their variants
   (``SignatureCosine``, ``SignaturePoly(degree=3)``, ``SignatureMix``,
   ``SignatureMatern32``, ``SignatureMatern52``,
   ``SignatureSpectral(family=...)``, Q=5) at the benchmark width with the
   heuristic lengthscales, under ``fused='auto'``: torch ops, the route the
   JAX package takes for them (it has no Pallas kernel for them); (11a)
   each base's inducing-tensors model served on the six buckets, means
   within 1e-3 of the f64 path (torch ops on the card too) and the same
   argmax where decided; (11b) one base of each family (cosine, poly, mix,
   matern32, spectral_mixed) trained as phase 5: every leaf's gradient
   within 1e-3 of its scale against f64, 30 NAdam steps under the phase-2
   mask, losses falling, the frozen leaf bit-identical; (11c) the matern32
   inducing-sequences model (the blocked seq x seq path) served, trained
   and its ``predict_f(full_cov=True)`` held as phase 3; (11d) no kernel
   launched in 11a-11c (every counter at 0), and a ``fused='on'`` twin of
   each model raising on CUDA tensors; (11e, after phase 10e) each
   model's request latency (median of 3 a bucket), and for the trained
   ones training steps/s (median of 3 steps) with a profile of one step
   and the device work of each covariance leg (Kzz, Kzx, Kxx's diagonal);
12. low-rank features (``SignatureRBF(low_rank=True)``: Nystrom features
   and randomized Hadamard products, torch ops, as the JAX package runs
   them through XLA) and the rest of the model API: (12a) the low-rank
   tensors model at the benchmark width (500 incremental inducing
   tensors, C=10, with ``num_components=100, rank_bound=200``: the
   defaults' rank, 201, is below 500 and makes Kzz singular) served on
   the six buckets, two calls with generators seeded alike giving
   bit-identical Grams, trained 30 steps under the phase-2 mask, K1-K6 at
   0; (12b) before it trains, levels 0 and 1 of its Kzz, Kzx and full
   Kxx against its f64 path on the same draws (within 1e-3 of their
   scale: those levels do not depend on an eigenvector's sign), and a
   model with exact features (8 components, M=3, 100 inducing tensors)
   held as phases 3 and 5 hold theirs; (12c) the recipe with
   ``low_rank=True`` (num_lags=1, 150 inducing tensors, epochs_cap=1) on
   phase 8's data, C=10 and C=2; (12d) the configuration of
   ``examples/low_rank_long_sequences.py`` (10,000 random walks of 1,000
   steps, d=3, M=3, 96 components, rank bound 128, in 4 chunks sharing
   every draw): factor time, implied Gram entries/s, and the normalized
   low-rank Gram of 256 walks against the exact one from K5
   (``K_blocked(method='pallas')``), max and mean error read; (12e) a
   Gaussian regression model (500 incremental inducing tensors, K1-K4, a
   ``Linear`` mean function, trainable noise) served, every leaf's
   gradient held against f64, trained 30 steps, and ``predict_f_samples``
   (S = 4,096) within 5 standard errors of ``predict_f``'s moments, with
   and without ``full_cov``; (12f, after phase 11e) the 12a and 12e
   models' request latency and training steps/s as phase 11e times them;
4. times: the six kernels against their plain versions with CUDA events,
   interleaved plain / kernel / kernel / plain (K1 and K2 in both modes
   with both bounds, each unordered pair counted once and every ordered
   pair; K3 at N = 1, 8, 32 and 50, K5 and K6 also at the N=50, L=315 full
   Kxx, K1-K6 at 9 and 17 levels once; K1, K2 and K3 at N = 1 and 8 also
   from a CUDA graph, the launch alone); request latency per bucket
   (median of 5) and training steps/s (median of 10 synchronized steps
   after 3 warm-up steps) with a ``torch.profiler`` breakdown of two
   steps, for both models (9f and 10e: median of 5 steps, one profiled);
   (4e) K1-K6 at the lagged width at phase 2h's shapes, and the lagged
   tensors model's training steps/s and profile.

The line before the last is a JSON object with one entry per kernel, one
per kernel's matern12 instance and one for K5 and K6 at order 2 and at
order 4; the last line is ``{"ok": true,
"device": {...}}``.  Details go to
``build/chip_smoke.json``.  The script imports nothing of JAX.

``python3 chip_smoke.py --kernel-times`` builds the main library and runs
phase 4a alone, printing its rows as one JSON line: a copy of the script
in another checkout times that checkout's kernels, so two trees can be
compared in one call.  ``python3 chip_smoke.py --bases`` runs phase 11
alone (it builds nothing), its details in ``build/chip_smoke_bases.json``;
``python3 chip_smoke.py --low-rank`` builds the main library and runs
phase 12 alone, its details in ``build/chip_smoke_low_rank.json``.
"""

from __future__ import annotations

import importlib
import inspect
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
SEED = 0
D, LEVELS, N_IND, C, L, N_TRAIN = 14, 4, 500, 10, 93, 2000
LT, D2 = LEVELS * (LEVELS + 1) // 2, D + 2
LEN_BUCKETS, BATCH_BUCKETS = (48, 96), (1, 8, 32)
REQUESTS = ((1, 93), (5, 40), (32, 93), (20, 70))
BATCH, STEPS, LR = 50, 30, 1e-3
F32_BOUND, F64_BOUND, BWD_BOUND, MEAN_BOUND = 1e-5, 1e-4, 1e-4, 1e-3
GRAD_BOUND, GRAD_FLOOR = 1e-3, 1e-3
# kern/lags' gradient on white-noise data is a sum of terms of both signs
# that nearly cancel, so the f32 error of the cotangents they weigh stays
# in it: 1.28e-3 of its norm through the kernels, 4.4e-3 through the f32
# plain path, on the lagged MultiClass model.  It misses GRAD_BOUND and is
# held to its own limit, below the f32 plain path's error.
LEAF_GRAD_BOUND = {"kern/lags": 2e-3}
# H100 SXM: f32 outside the tensor cores, HBM3 (NVIDIA's data sheet)
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
LEN_IND = LEVELS + 1  # inducing sequences of the recipe (train_gpsig.py:76-80)
LONG = 205  # steps of the longest CharacterTrajectories series
UWAVE, MAX_LEN, WALK = 315, 500, 1918  # benchmarks/datasets.json; the
# reference runner's --max-len (benchmarks/run_gpsig_benchmarks.py:29)
MANY, MANY_NZ, MANY_L = 70_000, 32, 6  # examples past the 65,535 grid limit
EXTRA_LEVELS = 9  # past the main library's 8
WIDE_LEVELS = 10  # K3 chains its range states four warps at a time
MANY_LEVELS = 17  # K3 past its chained states (its serial path)
LEVEL_LIBS = (EXTRA_LEVELS, WIDE_LEVELS, MANY_LEVELS)
# phase 10: K5/K6 at order > 1, each (levels, order) from a library of its
# own -- order 2 and the full grid (order 4) at the benchmark's 4 levels,
# order 3 on 9 levels
ORDER_LIBS = ((LEVELS, 2), (LEVELS, LEVELS), (EXTRA_LEVELS, 3))
WIDE_K2_D = 40  # d2 = 42 at 17 levels: past what a K2 holding a level's
# rows in shared memory could take
PEMS_D, PEMS_L = 963, 144  # PEMS: 963 features, 144 observations
# (benchmarks/datasets.json)
# the inducing-sequences model's three seq x seq Grams:
# (N1, L1, N2, L2, symmetric, base, difference)
SEQ_KZZ = (N_IND, LEN_IND, N_IND, LEN_IND, True, "rbf", True)
SEQ_KZX = (N_IND, LEN_IND, BATCH, L, False, "rbf", True)
SEQ_KXX = (BATCH, L, BATCH, L, True, "rbf", True)
LAGS = 1  # the reference runner's num_lags (run_gpsig_benchmarks.py:30)
D_LAG2 = (LAGS + 1) * D + 2  # the kernels' augmented width with lags
LAG_SEQ = {"Kzz": SEQ_KZZ, "Kzx": SEQ_KZX, "Kxx": SEQ_KXX}
M12 = "matern12"  # bench.py --svgp --base matern12
KINK_FWD, KINK_BWD = 2e-3, 5e-3  # matern12 at r = 0, JAX's own bounds
# (tests/test_inducing_pallas.py:52-53), relative to max(scale, 1)
M12_SEQ = {"Kzz": SEQ_KZZ[:5] + (M12, True),
           "Kzx": SEQ_KZX[:5] + (M12, True),
           "Kxx": SEQ_KXX[:5] + (M12, True)}
M12_SEQ_CASES = (*M12_SEQ.values(),
                 # past one inner chunk on both sides: symmetric, and
                 # distinct sequences (no kink) in both sides' gradients
                 (BATCH, UWAVE, BATCH, UWAVE, True, M12, True),
                 (20, UWAVE, 10, UWAVE, False, M12, True))
RECIPE_TRAIN, RECIPE_TEST, RECIPE_CHANNELS = 2000, 500, 13
KILL_SAVE, KILL_AT, KILL_ITERS = 8, 13, 32  # checkpoints every 8 steps;
# the run dies before its 14th step, between the checkpoints at 8 and 16
KERNELS = {  # name: (module, source, TPU kernel it replaces)
    "kzz_fwd": ("inducing_cuda", "gpsig_tpu_torch/csrc/kzz_fwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:223"),
    "kzx_fwd": ("inducing_cuda", "gpsig_tpu_torch/csrc/kzx_fwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:697"),
    "kzz_bwd": ("inducing_cuda", "gpsig_tpu_torch/csrc/kzz_bwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:256"),
    "kzx_bwd": ("inducing_cuda", "gpsig_tpu_torch/csrc/kzx_bwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:740"),
    "seq_fwd": ("signature_cuda", "gpsig_tpu_torch/csrc/seq_fwd.cu",
                "gpsig_tpu/ops/signature_pallas.py:436"),
    "seq_bwd": ("signature_cuda", "gpsig_tpu_torch/csrc/seq_bwd.cu",
                "gpsig_tpu/ops/signature_pallas.py:827"),
}


def phase2_mask(name: str) -> bool:
    """The reference's phase 2 (``train_gpsig.py:161-163``)."""
    return name != "kern/variances"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '_Z\w*?((?:kzz|kzx|seq)_(?:fwd|bwd)_"
    r"(?:kernel|serial_kernel|combine))I(\w*?)EEv")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(report: str) -> list:
    """Registers, stack frame and spills of each kernel instance in a
    ptxas report; the template arguments (levels first) from its name."""
    rows, cur, frame = [], None, None
    for line in report.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = (m.group(1), [int(a) for a in re.findall(r"L[ib](\d+)E",
                                                           m.group(2) + "E")])
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            frame = [int(g) for g in m.groups()]
        m = _PTXAS_REGS.search(line)
        if m and cur is not None:
            rows.append(dict(kernel=cur[0], args=cur[1],
                             registers=int(m.group(1)), stack_frame=frame[0],
                             spill_stores=frame[1], spill_loads=frame[2]))
            cur = None
    return rows


def print_ptxas(rows, keep) -> None:
    for r in rows:
        if keep(r):
            print(f"    {r['kernel']}<{','.join(map(str, r['args']))}>: "
                  f"{r['registers']} registers, {r['stack_frame']} bytes "
                  f"stack frame, {r['spill_stores']} / {r['spill_loads']} "
                  "bytes spill stores / loads")


def build_libraries(build_mod, levels=LEVEL_LIBS, orders=ORDER_LIBS):
    """Phase 1: the main library, those for ``levels`` and the K5/K6 ones
    for each (levels, order) of ``orders``, built at once (each runs one
    nvcc per source); returns {key: (library, seconds)}, the main library
    under 1, the others under their level count or (levels, order)."""
    out, errors = {}, []

    def build(m):
        t0 = time.perf_counter()
        try:
            out[m] = (build_mod.load(*(m if isinstance(m, tuple) else (m,))),
                      time.perf_counter() - t0)
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    workers = [threading.Thread(target=build, args=(m,))
               for m in (*levels, *orders)]
    for w in workers:
        w.start()
    build(1)
    for w in workers:
        w.join()
    if errors:
        raise errors[0]
    return out


def _wrapper(name: str):
    """The launching wrapper of a kernel, looked up in its own module."""
    module = importlib.import_module(f"gpsig_tpu_torch.ops.{KERNELS[name][0]}")
    return getattr(module, name)


def reset_counts() -> None:
    for name in KERNELS:
        _wrapper(name).launches = 0


def read_counts() -> dict:
    return {name: _wrapper(name).launches for name in KERNELS}


def synthetic_data():
    """Synthetic (2000, 93, 14) data and labels from the seed."""
    rng = np.random.RandomState(SEED)
    X = rng.randn(N_TRAIN, L, D).astype(np.float32)
    return X, rng.randint(0, C, N_TRAIN)


def synthetic_setup(ut, T, X, y, kind: str, num_lags=None, classes=C,
                    base="rbf", order=1, fused="on", variant=None,
                    ref_device="cpu"):
    """Benchmark-width SVGP with parameters from a numpy seed: the ported
    heuristics on the synthetic data -- 500 incremental inducing tensors
    (``kind='tensors'``) or 500 inducing sequences of length M+1
    (``'sequences'``, the recipe's ``use_tensors=False``) -- with q_mu /
    q_sqrt perturbed so predictions differ across classes and examples;
    ``num_lags`` lagged copies of the data, the recipe's likelihood for
    ``classes`` (Bernoulli, one latent, for 2), the signature kernel's
    ``base`` (SignatureRBF's, or SignatureMatern12's) and ``order``, or
    the named ``variant`` (constructor name, keyword arguments) of
    ``T.kernels``, given the heuristic lengthscales too.  Returns the f32
    model on the card (``fused``), its f64 twin on ``ref_device`` (the CPU:
    the plain versions) and ``build(dtype, fused, device)`` loaded with the
    same parameters."""
    rng = np.random.RandomState(SEED + (1 if kind == "tensors" else 2))
    latent = 1 if classes == 2 else classes
    if kind == "tensors":
        Z = ut.suggest_initial_inducing_tensors(
            X, LEVELS, N_IND, labels=y, increments=True, num_lags=num_lags,
            seed=SEED)
    else:
        Z = ut.suggest_initial_inducing_sequences(
            X, N_IND, LEN_IND, labels=y, seed=SEED)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    tree = None

    def build(dtype, fused, device):
        if variant is None:
            kern = T.kernels.SignatureKernel(
                D, LEVELS, base=base, order=order, lengthscales=ls,
                num_lags=num_lags, fused=fused, dtype=dtype, device=device)
        else:
            kern = getattr(T.kernels, variant[0])(
                D, LEVELS, order=order, lengthscales=ls, num_lags=num_lags,
                fused=fused, dtype=dtype, device=device, **variant[1])
        if kind == "tensors":
            ind = T.InducingTensors(Z, LEVELS, increments=True, dtype=dtype,
                                    device=device)
        else:
            ind = T.InducingSequences(Z, LEVELS, dtype=dtype, device=device)
        lik = (T.likelihoods.Bernoulli() if classes == 2
               else T.likelihoods.MultiClass(classes))
        model = T.SVGP(kern, ind, lik, num_latent=latent, num_data=N_TRAIN,
                       device=device)
        if tree is not None:
            T.convert.load_jax_params(model, tree)
        return model

    model = build(torch.float32, fused, "cuda")
    tree = T.convert.to_numpy_tree(model)
    tree["q_mu"] = rng.randn(N_IND, latent) * 0.5
    tree["q_sqrt"] = (np.tril(rng.randn(latent, N_IND, N_IND)) * 0.02
                      + 0.5 * np.eye(N_IND)[None])
    if num_lags:  # lags and gamma off their initial values
        tree["kern"]["lags"] = tree["kern"]["lags"] + 0.5
        tree["kern"]["gamma"] = tree["kern"]["gamma"] + 0.3
    T.convert.load_jax_params(model, tree)
    ref = build(torch.float64, "auto", ref_device)  # the plain versions
    return model, ref, build


def kernel_inputs(ic, X, Z_np, ls, nz, n, l, *, base, inc, dtype):
    """Augmented rows for K1-K4 from scaled data on the card."""
    dev = "cuda"
    Zt = torch.as_tensor(Z_np[:, :nz] if inc else Z_np[:, :nz, 0],
                         dtype=dtype, device=dev) / torch.as_tensor(
        ls, dtype=dtype, device=dev)
    Xt = torch.as_tensor(X[:n, :l], dtype=dtype, device=dev) / torch.as_tensor(
        ls, dtype=dtype, device=dev)
    Vl, Dl = ic._prep_tensors(Zt, base, inc, lhs=True)
    Vr, Dr = ic._prep_tensors(Zt, base, inc, lhs=False)
    Xv, Xd = ic._prep_seq(Xt, base)
    return (Vl, Dl, Vr, Dr), (Vl, Dl, Xv, Xd)


def cotangents(nz, n, dtype):
    """Random cotangents of the Kzz and Kzx level stacks, from the seed."""
    rng = np.random.RandomState(SEED + 4)
    return (torch.as_tensor(rng.randn(LEVELS + 1, nz, nz), dtype=dtype,
                            device="cuda"),
            torch.as_tensor(rng.randn(LEVELS + 1, nz, n), dtype=dtype,
                            device="cuda"))


def benchmark_inputs(ut, X):
    Z_np = ut.suggest_initial_inducing_tensors(
        X[:200], LEVELS, N_IND, increments=True, seed=SEED + 1)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    return Z_np, ls


def kernel_checks(ic, ut, X):
    """Phase 2: every case of K1-K4 against its plain version, K1 and K2 in
    both modes (all pairs; symmetric, the main path's)."""
    Z_np, ls = benchmark_inputs(ut, X)
    cases = [  # (nz, N, L, base, increments, difference)
        (N_IND, 32, L, "rbf", True, True),
        (N_IND, BATCH, L, "rbf", True, True),
        (37, 3, 18, "rbf", True, True),
        (37, 3, 18, "rbf", False, False),
        (37, 3, 18, "rbf", True, False),
        (37, 3, 18, "rbf", False, True),
        (37, 3, 18, "linear", True, True),
        (37, 3, 18, "linear", False, False),
    ]
    rows = []
    for nz, n, l, base, inc, diff in cases:
        zz32, zx32 = kernel_inputs(ic, X, Z_np, ls, nz, n, l, base=base,
                                   inc=inc, dtype=torch.float32)
        zz64, zx64 = kernel_inputs(ic, X, Z_np, ls, nz, n, l, base=base,
                                   inc=inc, dtype=torch.float64)
        cz32, cx32 = cotangents(nz, n, torch.float32)
        cz64, cx64 = cz32.double(), cx32.double()
        kw = dict(num_levels=LEVELS, base=base, increments=inc)
        kwx = dict(kw, difference=diff)
        meta = dict(nz=nz, N=n, L=l, base=base, increments=inc,
                    difference=diff)
        pairs = [
            ("kzx_fwd", ic.kzx_fwd(*zx32, **kwx),
             ic.kzx_fwd_plain(*zx32, **kwx), ic.kzx_fwd_plain(*zx64, **kwx),
             meta),
            ("kzx_bwd", ic.kzx_bwd(*zx32, cx32, **kwx),
             ic.kzx_bwd_plain(*zx32, cx32, **kwx),
             ic.kzx_bwd_plain(*zx64, cx64, **kwx), meta),
        ]
        again = ic.kzx_bwd(*zx32, cx32, **kwx)
        check(all(torch.equal(a, b) for a, b in zip(pairs[1][1], again)),
              f"kzx_bwd {nz, n, l, base, inc, diff}: two launches differ")
        for sym in (False, True):
            kws = dict(kw, symmetric=sym)
            out = ic.kzz_fwd(*zz32, **kws)
            grads = ic.kzz_bwd(*zz32, cz32, **kws)
            again = ic.kzz_bwd(*zz32, cz32, **kws)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"kzz_bwd {nz, base, inc, sym}: two launches differ")
            if sym:
                check(torch.equal(out, out.transpose(1, 2)),
                      f"kzz_fwd {nz, base, inc}: not exactly symmetric")
            m = dict(meta, symmetric=sym)
            pairs += [("kzz_fwd", out, ic.kzz_fwd_plain(*zz32, **kws),
                       ic.kzz_fwd_plain(*zz64, **kws), m),
                      ("kzz_bwd", grads, ic.kzz_bwd_plain(*zz32, cz32, **kws),
                       ic.kzz_bwd_plain(*zz64, cz64, **kws), m)]
        torch.cuda.synchronize()
        for pair in pairs:
            rows.append(check_against_plain(*pair))
    return rows


def fused_kzz_check(T, ic, ut, X) -> dict:
    """Phase 2g: ``fused_tensor_levels`` on the card at the benchmark width,
    forward and backward through autograd, launches K1 and K2 once each in
    symmetric mode: an exactly symmetric output, bit-equal to
    ``kzz_fwd(symmetric=True)`` on the same rows."""
    Z_np, ls = benchmark_inputs(ut, X)
    Z = (torch.as_tensor(Z_np, device="cuda")
         / torch.as_tensor(ls, device="cuda")).float().requires_grad_()
    ct = cotangents(N_IND, 1, torch.float32)[0]
    reset_counts()
    out = ic.fused_tensor_levels(Z, num_levels=LEVELS)
    (g,) = torch.autograd.grad(out, Z, ct)
    torch.cuda.synchronize()
    launches = read_counts()
    rows = (*ic._prep_tensors(Z.detach(), "rbf", True, lhs=True),
            *ic._prep_tensors(Z.detach(), "rbf", True, lhs=False))
    direct = ic.kzz_fwd(*rows, num_levels=LEVELS, base="rbf",
                        increments=True, symmetric=True)
    print(f"  fused_tensor_levels: launches {launches}")
    check(launches["kzz_fwd"] == 1 and launches["kzz_bwd"] == 1,
          f"fused_tensor_levels did not launch K1 and K2 once: {launches}")
    check(torch.equal(out, out.transpose(1, 2)),
          "fused_tensor_levels: not exactly symmetric")
    check(torch.equal(out.detach(), direct),
          "fused_tensor_levels differs from kzz_fwd(symmetric=True)")
    check(bool(torch.isfinite(g).all()), "fused_tensor_levels: gradient")
    return dict(launches=launches, symmetric=True)


def check_against_plain(name, out, p32, p64, meta, kink=None,
                        f32_floor=False) -> dict:
    """A kernel's output against its plain version at f32 and f64, each
    part held to the bound at its own scale, floored at 1 as in PERF.md
    section 2: each level of a forward level stack (the top level of a long
    sequence is orders of magnitude above the first), each gradient of a
    backward.  ``kink`` (matern12 at r = 0, where f64 is no reference for
    f32) replaces both bounds, reads the f64 error and holds the f32 one
    alone, at the f32 plain version's scale; ``f32_floor`` (matern12)
    holds a part to the f32 bound against the f32 plain version or against
    f64, whichever is nearer, and where the f32 plain version itself misses
    the f32 bound against f64 (its level sums ill conditioned at f32)
    against f64 alone."""
    if isinstance(out, torch.Tensor):  # a level stack: one part a level
        out, p32, p64 = out.unbind(0), p32.unbind(0), p64.unbind(0)
    bound = F32_BOUND if name.endswith("fwd") else BWD_BOUND
    bound64 = F64_BOUND if name.endswith("fwd") else BWD_BOUND
    hold64 = kink is None
    if not hold64:
        bound = bound64 = kink
    tops = [float(p.abs().max()) for p in (p64 if hold64 else p32)]
    scales = [max(t, 1.0) for t in tops]
    e32 = [float((o - p).abs().max()) for o, p in zip(out, p32)]
    e64 = [float((o.double() - p).abs().max()) for o, p in zip(out, p64)]
    plain_off = [float((a.double() - b).abs().max())
                 for a, b in zip(p32, p64)]
    # the largest error of a part against its bound at its scale
    if f32_floor:
        e32_held = [min(e, e6) for e, e6, o, c in
                    zip(e32, e64, plain_off, scales) if o <= bound * c]
        c32_held = [c for o, c in zip(plain_off, scales) if o <= bound * c]
    else:
        e32_held, c32_held = e32, scales
    r32 = max((e / (bound * c) for e, c in zip(e32_held, c32_held)),
              default=0.0)
    r64 = max(e / (bound64 * c) for e, c in zip(e64, scales))
    row = dict(kernel=name, **meta, scale=max(tops), part_scales=tops,
               err_vs_plain_f32=max(e32), err_vs_plain_f64=max(e64),
               f32_err_over_bound=r32, f64_err_over_bound=r64,
               part_err_f32=e32, part_err_f64=e64,
               part_plain_f32_err_vs_f64=plain_off)
    row["plain_f32_err_vs_f64"] = max(row["part_plain_f32_err_vs_f64"])
    print(f"  {name} {meta}: |k-p32|={max(e32):.3e} |k-p64|={max(e64):.3e} "
          f"scale={max(tops):.3e}; worst part at {r32:.3f} / {r64:.3f} "
          "of its f32 / f64 bound" + ("" if hold64 else
                                      " (f64 read, not held)")
          + (f"; the f32 plain version {max(plain_off):.3e} off f64"
             if f32_floor else ""))
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{name}: non-finite")
    check(r32 <= 1.0, f"{name} {row}: exceeds the f32 bound")
    check(r64 <= 1.0 or not hold64, f"{name} {row}: exceeds the f64 bound")
    return row


SEQ_CASES = (  # (N1, L1, N2, L2, symmetric, base, difference)
    SEQ_KZZ, SEQ_KZX, SEQ_KXX,
    # data longer than 128 steps (CharacterTrajectories' longest,
    # benchmarks/datasets.json), in both argument orders
    (N_IND, LEN_IND, BATCH, LONG, False, "rbf", True),
    (BATCH, LONG, N_IND, LEN_IND, False, "rbf", True),
    # both sides past one inner chunk: a full Kxx at UWave's length, pairs
    # at the reference runner's max_len, and WalkvsRun's longest series
    (BATCH, UWAVE, BATCH, UWAVE, True, "rbf", True),
    (20, MAX_LEN, 20, MAX_LEN, True, "rbf", True),
    (7, 300, 5, WALK, False, "rbf", True),
    (5, WALK, 7, 300, False, "rbf", True),
    (7, 11, 5, 18, False, "rbf", True),
    (7, 11, 5, 18, False, "rbf", False),
    (7, 11, 5, 18, False, "linear", True),
    (7, 11, 5, 18, False, "linear", False),
)


def seq_inputs(ic, Zs, X, ls, case, dtype, levels=LEVELS):
    """Augmented rows for K5/K6 (inducing sequences Zs against data X, both
    scaled) and a cotangent of ``levels`` levels from the seed, on the
    card."""
    n1, l1, n2, l2, sym, base, _ = case
    scale = torch.as_tensor(ls, dtype=dtype, device="cuda")

    def data(n, l, last):
        if l <= L:
            return X[-n:, :l] if last else X[:n, :l]
        # longer than the synthetic data: points of size 1/sqrt(l), as the
        # card tests draw them.  Unit white noise of these lengths leaves
        # the odd levels, sums of many terms of both signs, ill conditioned
        # in f32: the f32 plain version itself is then further off f64 than
        # the bounds at a level's own scale
        rng = np.random.RandomState(SEED + 7 + int(last))
        return rng.randn(n, l, D) / np.sqrt(l)

    A = Zs[:n1, :l1] if l1 == LEN_IND else data(n1, l1, True)
    A = torch.as_tensor(A, dtype=dtype, device="cuda") / scale
    B = Zs[:n2, :l2] if l2 == LEN_IND else data(n2, l2, False)
    B = A if sym else torch.as_tensor(B, dtype=dtype, device="cuda") / scale
    ct = torch.as_tensor(np.random.RandomState(SEED + 6).randn(
        levels + 1, n1, n2), dtype=dtype, device="cuda")
    return (*ic._prep_seq(A, base, lhs=True), *ic._prep_seq(B, base)), ct


def seq_kernel_checks(sc, ic, Zs, X, ls):
    """Phase 2b: K5 and K6 against their plain versions; the symmetric
    outputs must be exactly symmetric."""
    rows = []
    for case in SEQ_CASES:
        n1, l1, n2, l2, sym, base, diff = case
        r32, ct32 = seq_inputs(ic, Zs, X, ls, case, torch.float32)
        r64, ct64 = seq_inputs(ic, Zs, X, ls, case, torch.float64)
        kw = dict(num_levels=LEVELS, base=base, difference=diff,
                  symmetric=sym)
        out = sc.seq_fwd(*r32, **kw)
        grads = sc.seq_bwd(*r32, ct32, **kw)
        again = sc.seq_bwd(*r32, ct32, **kw)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"seq_bwd {case}: two launches differ")
        pairs = (("seq_fwd", out, sc.seq_fwd_plain(*r32, **kw),
                  sc.seq_fwd_plain(*r64, **kw)),
                 ("seq_bwd", grads, sc.seq_bwd_plain(*r32, ct32, **kw),
                  sc.seq_bwd_plain(*r64, ct64, **kw)))
        torch.cuda.synchronize()
        if sym:
            check(torch.equal(out, out.transpose(1, 2)),
                  f"seq_fwd {case}: not exactly symmetric")
        meta = dict(N1=n1, L1=l1, N2=n2, L2=l2, symmetric=sym, base=base,
                    difference=diff)
        for pair in pairs:
            rows.append(check_against_plain(*pair, meta))
    return rows


def _sliced(fn, args, ct, n_ex, step=10_000):
    """A Kzx kernel's plain version on slices of the examples: the forward
    concatenated, the backward's inducing gradients summed and its
    sequence gradients concatenated."""
    parts = []
    for a in range(0, n_ex, step):
        sl = (*args[:2], args[2][a:a + step], args[3][a:a + step])
        parts.append(fn(*sl) if ct is None else fn(*sl, ct[:, :, a:a + step]))
    if ct is None:
        return torch.cat(parts, dim=2)
    return (sum(p[0] for p in parts), sum(p[1] for p in parts),
            torch.cat([p[2] for p in parts]), torch.cat([p[3] for p in parts]))


def many_examples_checks(ic, ut, X):
    """Phase 2c: K3 and K4 at 70,000 examples in one call (past the 65,535
    of a grid's y), 32 benchmark inducing tensors, L=6, against their plain
    versions on slices of 10,000 examples."""
    Z_np, ls = benchmark_inputs(ut, X)
    Xm = np.random.RandomState(SEED + 9).randn(MANY, MANY_L, D)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        _, zx = kernel_inputs(ic, Xm, Z_np, ls, MANY_NZ, MANY, MANY_L,
                              base="rbf", inc=True, dtype=dtype)
        ct = torch.as_tensor(np.random.RandomState(SEED + 10).randn(
            LEVELS + 1, MANY_NZ, MANY), dtype=dtype, device="cuda")
        rows[dtype] = (zx, ct)
    (zx, ct), (zx64, ct64) = rows[torch.float32], rows[torch.float64]
    kw = dict(num_levels=LEVELS, base="rbf", increments=True,
              difference=True)
    out, grads = ic.kzx_fwd(*zx, **kw), ic.kzx_bwd(*zx, ct, **kw)
    torch.cuda.synchronize()
    meta = dict(nz=MANY_NZ, N=MANY, L=MANY_L)

    def fwd(*a):
        return ic.kzx_fwd_plain(*a, **kw)

    def bwd(*a):
        return ic.kzx_bwd_plain(*a, **kw)

    return [check_against_plain("kzx_fwd", out, _sliced(fwd, zx, None, MANY),
                                _sliced(fwd, zx64, None, MANY), meta),
            check_against_plain("kzx_bwd", grads, _sliced(bwd, zx, ct, MANY),
                                _sliced(bwd, zx64, ct64, MANY), meta)]


def extra_levels_setup(ic, sc, m=EXTRA_LEVELS, d=D):
    """Inputs at m levels and a small width (d features), and for each of
    K1-K6 a ``call(fn, dtype)`` of its kernel or plain version on them; K1
    and K2 in symmetric mode, the main path's."""
    lt, nz, n = m * (m + 1) // 2, 37, 3
    rng = np.random.RandomState(SEED + 11)
    Z = rng.randn(lt, nz, 2, d) * 0.3 * np.sqrt(D / d)
    Xs = rng.randn(n, 18, D) / 4
    A, B = rng.randn(7, 11, D) / 4, rng.randn(5, 40, D) / 4
    ctz, ctx, cts = (rng.randn(m + 1, nz, nz), rng.randn(m + 1, nz, n),
                     rng.randn(m + 1, 7, 5))
    ins = {}
    for dtype in (torch.float32, torch.float64):
        Zt, Xt, At, Bt, cz, cx, cs = (
            torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (Z, Xs, A, B, ctz, ctx, cts))
        zz = (*ic._prep_tensors(Zt, "rbf", True, lhs=True),
              *ic._prep_tensors(Zt, "rbf", True, lhs=False))
        zx = (*zz[:2], *ic._prep_seq(Xt, "rbf"))
        ss = (*ic._prep_seq(At, "rbf", lhs=True), *ic._prep_seq(Bt, "rbf"))
        ins[dtype] = (zz, zx, ss, cz, cx, cs)
    kw = dict(num_levels=m, base="rbf", increments=True)
    kwz = dict(kw, symmetric=True)
    kwx = dict(kw, difference=True)
    kws = dict(num_levels=m, base="rbf", difference=True)
    # (kernel, its rows in ins, its cotangent in ins, options)
    specs = (("kzz_fwd", 0, None, kwz), ("kzx_fwd", 1, None, kwx),
             ("kzz_bwd", 0, 3, kwz), ("kzx_bwd", 1, 4, kwx),
             ("seq_fwd", 2, None, kws), ("seq_bwd", 2, 5, kws))
    calls = {}
    for name, at, ct_at, opts in specs:
        def call(fn, dtype, at=at, ct_at=ct_at, opts=opts):
            got = ins[dtype]
            cts = () if ct_at is None else (got[ct_at],)
            return fn(*got[at], *cts, **opts)
        calls[name] = call
    return calls


def _plain(name: str):
    return getattr(importlib.import_module(_wrapper(name).__module__),
                   name + "_plain")


def extra_levels_checks(ic, sc):
    """Phase 2d: K1-K6 at 9, 10 and 17 levels (the libraries built for
    those level counts) at a small width, and K2 at 17 levels and d2 = 42,
    against their plain versions."""
    cases = [(m, D, None) for m in LEVEL_LIBS]
    cases.append((MANY_LEVELS, WIDE_K2_D, "kzz_bwd"))
    rows = []
    for m, d, only in cases:
        for name, call in extra_levels_setup(ic, sc, m, d).items():
            if only not in (None, name):
                continue
            out = call(_wrapper(name), torch.float32)
            torch.cuda.synchronize()
            rows.append(check_against_plain(
                name, out, call(_plain(name), torch.float32),
                call(_plain(name), torch.float64), dict(levels=m, d2=d + 2)))
    return rows


def expm1_checks(sc) -> dict:
    """Phase 2e: common.cuh's expm1_acc (the expm1 of K1, K2, K3 and K5) and
    CUDA's expm1f against float64 expm1 on a dense grid of [-1, 1], at the
    switch at +-0.41 and near 0, in float32 ulp of the true value; and the
    rbf slot Gram exp(a) (expm1(d01 + d10 + dxx) - expm1(d01) -
    expm1(d10)), whose terms cancel, with each, in float32 epsilons of the
    sum of its terms' magnitudes; and its partials exp(a) (expm1(s) -
    expm1(d01)), exp(a) (expm1(s) - expm1(d10)), exp(a) (expm1(s) + 1)
    (K2's weights; s = d01 + d10 + dxx) likewise, where the terms of s
    count too, as exp(s) (|d01| + |d10| + |dxx|): s is summed in float32,
    and where its terms cancel and expm1(d01) or expm1(d10) is not there
    to cover it (as it is in the slot Gram) that rounding, not the expm1,
    sets the error.  Bounds: 5 ulp, 16 epsilons."""
    x = np.concatenate([np.linspace(-1, 1, 1 << 22),
                        0.41 + np.linspace(-1e-3, 1e-3, 1 << 16),
                        -0.41 + np.linspace(-1e-3, 1e-3, 1 << 16),
                        np.geomspace(1e-9, 0.1, 1 << 16),
                        -np.geomspace(1e-9, 0.1, 1 << 16)]).astype(np.float32)
    rng = np.random.RandomState(SEED + 12)
    k = 1 << 22
    combo = np.stack([rng.uniform(-1, 0.5, k), rng.uniform(-0.6, 0.6, k),
                      rng.uniform(-0.6, 0.6, k),
                      rng.uniform(-0.05, 0.05, k)], 1).astype(np.float32)
    args = np.concatenate([np.stack([x, *np.zeros((3, len(x)))], 1),
                           combo]).astype(np.float32)
    out = sc.expm1_probe(torch.as_tensor(args, device="cuda")).cpu().numpy()
    want = np.expm1(x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    a, d01, d10, dxx = combo.astype(np.float64).T
    es, e01, e10 = np.expm1(d01 + d10 + dxx), np.expm1(d01), np.expm1(d10)
    ea, eps = np.exp(a), 2.0 ** -23
    g = ea * (es - e01 - e10)
    unit = ea * (np.abs(es) + np.abs(e01) + np.abs(e10)) * eps
    # the partials with expm1_acc (columns 4-6), the first with expm1f (7)
    sum_terms = np.exp(d01 + d10 + dxx) * (np.abs(d01) + np.abs(d10)
                                           + np.abs(dxx))
    parts = [(ea * (es - e01), ea * (np.abs(es) + np.abs(e01) + sum_terms)),
             (ea * (es - e10), ea * (np.abs(es) + np.abs(e10) + sum_terms)),
             (ea * (es + 1.0), ea * (np.abs(es) + 1.0 + sum_terms))]
    parts = [(p, u * eps) for p, u in parts]
    c = out[len(x):]
    res = dict(points=len(x), combos=k,
               expm1_acc_max_ulp=float(np.max(np.abs(out[:len(x), 0] - want)
                                              / ulp)),
               expm1f_max_ulp=float(np.max(np.abs(out[:len(x), 1] - want)
                                           / ulp)),
               slot_gram_acc_max_eps=float(np.max(np.abs(c[:, 2] - g)
                                                  / unit)),
               slot_gram_expm1f_max_eps=float(np.max(np.abs(c[:, 3] - g)
                                                     / unit)),
               partials_acc_max_eps=[float(np.max(np.abs(c[:, 4 + i] - p) / u))
                                     for i, (p, u) in enumerate(parts)],
               partial_expm1f_max_eps=float(np.max(
                   np.abs(c[:, 7] - parts[0][0]) / parts[0][1])))
    print(f"  expm1 on {len(x)} points: expm1_acc {res['expm1_acc_max_ulp']:.2f}"
          f" ulp, expm1f {res['expm1f_max_ulp']:.2f} ulp at most; slot Gram "
          f"on {k} cancelling rows: {res['slot_gram_acc_max_eps']:.2f} eps "
          f"with expm1_acc, {res['slot_gram_expm1f_max_eps']:.2f} with "
          "expm1f, at most; its partials (K2's weights) "
          + " / ".join(f"{e:.2f}" for e in res["partials_acc_max_eps"])
          + f" eps with expm1_acc, the first {res['partial_expm1f_max_eps']:.2f}"
          " with expm1f")
    check(res["expm1_acc_max_ulp"] <= 5, f"expm1_acc past 5 ulp: {res}")
    check(res["slot_gram_acc_max_eps"] <= 16, f"slot Gram past 16 eps: {res}")
    check(max(res["partials_acc_max_eps"]) <= 16,
          f"slot Gram partials past 16 eps: {res}")
    return res


def _walks(rng, n, l, d, v):
    """Paths from 0 to a shared direction v (|v| ~ 1) plus a random walk
    of half its size: at any width |x_t|^2 stays O(1), and the increments
    of any two paths correlate, so that the levels are O(1)."""
    t = np.linspace(0.0, 1.0, l)[:, None]
    walk = np.cumsum(rng.randn(n, l, d), 1) / np.sqrt(l * d)
    return torch.as_tensor(t * v + 0.5 * walk, device="cuda")


def wide_checks(ic, sc):
    """Phase 2f: PEMS's 963 features.  K5 and K6 on the Kzz of 500
    inducing sequences of length 5 and their Kzx against 50 examples of
    144 steps (inner rows past shared memory, read through L1); K1-K4 on
    500 inducing tensors against 16 of the examples (K1 and K2 in
    symmetric mode, the main path's); each against its plain version."""
    rng = np.random.RandomState(SEED + 13)
    v = rng.randn(PEMS_D) / np.sqrt(PEMS_D)
    Z = _walks(rng, N_IND, LEN_IND, PEMS_D, v)
    X = _walks(rng, BATCH, PEMS_L + 1, PEMS_D, v)
    Zt = torch.as_tensor(rng.randn(LT, N_IND, 2, PEMS_D) / np.sqrt(PEMS_D),
                         device="cuda")
    rows, meta = [], dict(d=PEMS_D)
    kws = dict(num_levels=LEVELS, base="rbf", difference=True)
    for A, B, sym in ((Z, Z, True), (Z, X, False)):
        r64 = (*ic._prep_seq(A, "rbf", lhs=True), *ic._prep_seq(B, "rbf"))
        r32 = [t.float() for t in r64]
        ct64 = torch.as_tensor(rng.randn(LEVELS + 1, len(A), len(B)),
                               device="cuda")
        ct32 = ct64.float()
        kw = dict(kws, symmetric=sym)
        out = sc.seq_fwd(*r32, **kw)
        grads = sc.seq_bwd(*r32, ct32, **kw)
        torch.cuda.synchronize()
        if sym:
            check(torch.equal(out, out.transpose(1, 2)),
                  "seq_fwd at PEMS width: not exactly symmetric")
        m = dict(meta, N1=len(A), L1=A.shape[1], N2=len(B), L2=B.shape[1])
        rows.append(check_against_plain(
            "seq_fwd", out, sc.seq_fwd_plain(*r32, **kw),
            sc.seq_fwd_plain(*r64, **kw), m))
        rows.append(check_against_plain(
            "seq_bwd", grads, sc.seq_bwd_plain(*r32, ct32, **kw),
            sc.seq_bwd_plain(*r64, ct64, **kw), m))
    zz64 = (*ic._prep_tensors(Zt, "rbf", True, lhs=True),
            *ic._prep_tensors(Zt, "rbf", True, lhs=False))
    zx64 = (*zz64[:2], *ic._prep_seq(X[:16], "rbf"))
    zz32, zx32 = [t.float() for t in zz64], [t.float() for t in zx64]
    cx64 = torch.as_tensor(rng.randn(LEVELS + 1, N_IND, 16), device="cuda")
    kw = dict(num_levels=LEVELS, base="rbf", increments=True)
    kwx = dict(kw, difference=True)
    m = dict(meta, nz=N_IND, N=16, L=PEMS_L + 1)
    rows.append(check_against_plain(
        "kzz_fwd", ic.kzz_fwd(*zz32, symmetric=True, **kw),
        ic.kzz_fwd_plain(*zz32, symmetric=True, **kw),
        ic.kzz_fwd_plain(*zz64, symmetric=True, **kw),
        dict(m, symmetric=True)))
    rows.append(check_against_plain(
        "kzx_fwd", ic.kzx_fwd(*zx32, **kwx), ic.kzx_fwd_plain(*zx32, **kwx),
        ic.kzx_fwd_plain(*zx64, **kwx), m))
    rows.append(check_against_plain(
        "kzx_bwd", ic.kzx_bwd(*zx32, cx64.float(), **kwx),
        ic.kzx_bwd_plain(*zx32, cx64.float(), **kwx),
        ic.kzx_bwd_plain(*zx64, cx64, **kwx), m))
    cz64 = torch.as_tensor(rng.randn(LEVELS + 1, N_IND, N_IND), device="cuda")
    kwz = dict(kw, symmetric=True)
    rows.append(check_against_plain(
        "kzz_bwd", ic.kzz_bwd(*zz32, cz64.float(), **kwz),
        ic.kzz_bwd_plain(*zz32, cz64.float(), **kwz),
        ic.kzz_bwd_plain(*zz64, cz64, **kwz), dict(m, symmetric=True)))
    return rows


def time_extra_levels(ic, sc):
    """Phase 4d: K1-K6 at 9 and 17 levels, once, at the phase-2d shapes,
    against their plain versions, interleaved."""
    rows = []
    for m in (EXTRA_LEVELS, MANY_LEVELS):
        for name, call in extra_levels_setup(ic, sc, m).items():
            def kern():
                return call(_wrapper(name), torch.float32)

            def plain():
                return call(_plain(name), torch.float32)

            p1, k1, k2, p2 = (time_cuda(plain, reps=5), time_cuda(kern),
                              time_cuda(kern), time_cuda(plain, reps=5))
            rows.append(dict(kernel=name, levels=m, ms=[k1, k2],
                             plain_ms=[p1, p2]))
            print(f"  {name} ({m} levels): kernel {k1:.4f} / {k2:.4f} ms, "
                  f"plain {p1:.4f} / {p2:.4f} ms")
    return rows


def drive_serving(T, model, ref, X, expect, same_bucket=False,
                  ref_device="cpu", len_buckets=LEN_BUCKETS,
                  regression=False):
    """Phase 3: the serving path through its public entry points; the
    kernels in ``expect`` must launch during the requests.  The f64
    reference (on the CPU, or ``ref_device``) answers each request
    unpadded, or, with ``same_bucket`` (lags: padding changes the lagged
    features), through a Predictor with the same buckets; None (a low-rank
    model: its f32 and f64 draws differ, phase 12b holds its accuracy)
    answers none.  ``regression`` (a Gaussian likelihood): the means are
    held to the reference relative to their scale, with no classes."""
    pred = T.serving.Predictor(model, len_buckets=len_buckets,
                               batch_buckets=BATCH_BUCKETS, device="cuda")
    pred.warmup(D)
    torch.cuda.synchronize()
    rng = np.random.RandomState(SEED + 2)
    reqs = [X[rng.choice(len(X), n, replace=False), :l] for n, l in REQUESTS]
    reset_counts()
    outs = [pred.predict_y(r) for r in reqs]
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches during the requests: {launches}")
    for name in expect:
        check(launches[name] > 0, f"{name} was not launched on the serving "
              "path")
    if ref is None:
        ref_fn = None
    elif same_bucket:
        ref_fn = T.serving.Predictor(
            ref, len_buckets=len_buckets, batch_buckets=BATCH_BUCKETS,
            device=ref_device, dtype=torch.float64).predict_y
    else:
        def ref_fn(r):
            with torch.no_grad():
                return ref.predict_y(torch.as_tensor(
                    r, dtype=torch.float64, device=ref_device))
    P = model.num_latent
    rows = []
    for (n, l), r, (mean, var) in zip(REQUESTS, reqs, outs):
        mean, var = mean.double().cpu(), var.double().cpu()
        check(mean.shape == (n, P) and var.shape == (n, P),
              f"request ({n}, {l}): output shapes {mean.shape}, {var.shape}")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
              f"request ({n}, {l}): non-finite output")
        if ref_fn is None:
            row_err = (float((mean.sum(1) - 1.0).abs().max()) if P > 1
                       else 0.0)
            check(row_err <= MEAN_BOUND, f"request ({n}, {l}): rows sum off "
                  f"by {row_err}")
            print(f"  request (n={n}, l={l}): row-sum err={row_err:.3e}")
            rows.append(dict(n=n, l=l, row_sum_err=row_err))
            continue
        ref_mean = ref_fn(r)[0].cpu()
        err = float((mean - ref_mean).abs().max())
        if regression:
            err /= max(float(ref_mean.abs().max()), 1.0)
            print(f"  request (n={n}, l={l}): |mean - f64| / scale="
                  f"{err:.3e}")
            check(err <= MEAN_BOUND, f"request ({n}, {l}): means off the "
                  f"f64 path by {err}")
            rows.append(dict(n=n, l=l, rel_err_vs_f64=err))
            continue
        if P > 1:
            row_err = float((mean.sum(1) - 1.0).abs().max())
            check(row_err <= MEAN_BOUND, f"request ({n}, {l}): rows sum off "
                  f"by {row_err}")
            top2 = torch.topk(ref_mean, 2, dim=1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 * MEAN_BOUND
            same = torch.argmax(mean, 1) == torch.argmax(ref_mean, 1)
        else:  # one latent: p(y = 1), the class is p > 0.5
            row_err = 0.0
            decided = (ref_mean[:, 0] - 0.5).abs() > MEAN_BOUND
            same = (mean[:, 0] > 0.5) == (ref_mean[:, 0] > 0.5)
        print(f"  request (n={n}, l={l}): |mean - f64|={err:.3e} "
              f"row-sum err={row_err:.3e} argmax agree={int(same.sum())}/{n}")
        check(err <= MEAN_BOUND, f"request ({n}, {l}): means off the f64 "
              f"CPU path by {err}")
        check(bool(same[decided].all()), f"request ({n}, {l}): argmax "
              "differs from the f64 CPU path")
        rows.append(dict(n=n, l=l, err_vs_f64_cpu=err, row_sum_err=row_err,
                         argmax_agree=int(same.sum())))
    return pred, launches, rows


def leaf_grads(T, model, X, Y, generator=None):
    """Loss and every leaf's gradient (f64, on the CPU) on one batch."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(X, Y, generator=generator)
    loss.backward()
    grads = {name: p.grad.detach().double().cpu()
             for name, p in T.convert.named_leaves(model).items()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def gradient_check(T, model, ref, build, X, y, plain_floor=False,
                   ref_device="cpu", draws=None):
    """Phase 5a: on the first minibatch, every leaf's gradient on the card
    (the kernels) against the port's f64 CPU path (the plain versions); the
    f32 plain PyTorch path on the card (``fused='off'``) is measured beside
    it.  ``plain_floor`` (matern12): a leaf that misses its bound where the
    f32 plain path misses it too is held to no worse than that path.
    ``ref_device``: where the f64 path runs (the CPU, or the card for the
    bases without a kernel, whose f64 path is torch ops there too).
    ``draws``: a low-rank model's draws (float32), given to all three
    (cast to float64 for the reference)."""
    idx = next(T.training.MinibatchStream(N_TRAIN, BATCH, seed_or_rng=SEED))
    xb, yb = X[idx], y[idx, None].astype(np.float32)

    def on(device, dtype):
        return (torch.as_tensor(xb, dtype=dtype, device=device),
                torch.as_tensor(yb, dtype=dtype, device=device))

    d64 = None if draws is None else draws.to(ref_device, torch.float64)
    loss_k, g_k = leaf_grads(T, model, *on("cuda", torch.float32), draws)
    loss_r, g_r = leaf_grads(T, ref, *on(ref_device, torch.float64), d64)
    off = build(torch.float32, "off", "cuda")
    loss_o, g_o = leaf_grads(T, off, *on("cuda", torch.float32), draws)
    del off
    top = max(float(g.norm()) for g in g_r.values())
    # kern/sigma's gradient is sum_m variances_m dL/dw_m (w_m = sigma
    # variances_m): the per-level sums whose scaled copies are
    # kern/variances' gradient, cancelling to ~1e-7 of them.  It carries
    # their absolute f32 error, so its floor is that leaf's norm.
    floor = {"kern/sigma": float(g_r["kern/variances"].norm())}
    rows = []
    for name, want in g_r.items():
        norm = float(want.norm())
        err_k = float((g_k[name] - want).norm())
        err_o = float((g_o[name] - want).norm())
        denom = max(norm, GRAD_FLOOR * top, floor.get(name, 0.0))
        rows.append(dict(leaf=name, ref_norm=norm,
                         bound=LEAF_GRAD_BOUND.get(name, GRAD_BOUND),
                         rel_l2_kernels=err_k / norm,
                         rel_l2_plain_off=err_o / norm,
                         bounded_err_kernels=err_k / denom,
                         bounded_err_plain_off=err_o / denom,
                         nonzero=bool((g_k[name] != 0).any())))
        print(f"  grad {name}: |g_f64|={norm:.4e} rel L2 kernels "
              f"{err_k / norm:.3e}, plain fused='off' {err_o / norm:.3e}; "
              f"held to the bound: {err_k / denom:.3e} <= "
              f"{rows[-1]['bound']:.0e}")
        if norm > 0:
            check(rows[-1]["nonzero"], f"{name}: zero gradient on the card "
                  "where the f64 CPU path has one")
    print(f"  loss: card {loss_k:.8f}, f64 CPU {loss_r:.8f}, "
          f"fused='off' {loss_o:.8f}")
    check(next(r for r in rows if r["leaf"] == "ind/Z")["nonzero"],
          "ind/Z has no gradient on the card")
    for r in rows:
        if plain_floor and r["bounded_err_plain_off"] > r["bound"]:
            r["bound"] = max(r["bound"], r["bounded_err_plain_off"])
            print(f"  grad {r['leaf']}: held to the f32 plain path's "
                  f"{r['bound']:.3e}")
        check(r["bounded_err_kernels"] <= r["bound"],
              f"{r['leaf']}: gradient off the f64 CPU path: {r}")
    return dict(loss_card=loss_k, loss_f64_cpu=loss_r, loss_plain_off=loss_o,
                leaves=rows)


def drive_training(T, model, X, y, expect):
    """Phase 5b: the training path through its public entry points; each
    kernel must launch ``expect[name]`` times a step (0 if not named)."""
    frozen = {n: p.detach().clone()
              for n, p in T.convert.named_leaves(model).items()
              if not phase2_mask(n)}
    data = T.training.BatchIterator(
        T.training.MinibatchStream(N_TRAIN, BATCH, seed_or_rng=SEED),
        X, y[:, None].astype(np.float32), device="cuda")
    reset_counts()
    hist = T.training.optimize(
        lambda m, xb, yb: m.loss(xb, yb), model, T.training.nadam(LR),
        max_iter=STEPS, data_iter=data, trainable=phase2_mask, save_freq=1,
        print_freq=10, log_fn=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches during {STEPS} steps: {launches}")
    for name, count in launches.items():
        check(count == STEPS * expect.get(name, 0), f"{name} launched "
              f"{count} times in {STEPS} steps")
    losses = [hist[i]["loss"] for i in range(1, STEPS + 1)]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"  mean loss, first 10 steps {first:.4f}, last 10 {last:.4f}")
    check(last < first, "the loss did not fall over the run")
    for name, before in frozen.items():
        check(torch.equal(T.convert.named_leaves(model)[name], before),
              f"the frozen leaf {name} changed")
    return launches, dict(losses=losses, mean_first10=first,
                          mean_last10=last)


def time_cuda(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(name: str, nz: int, n: int, l: int, symmetric: bool = False,
             d2: int = D2) -> tuple[float, str]:
    """Least time the card could take for a kernel's work at this shape:
    FMAs (2 operations each) at the f32 peak against each input read and
    each output written once at the memory rate.  Slot dots: 4 of width
    d2 per slot Gram; each backward adds two d2-wide terms to each of its
    four gradients.  Kzz counts each unordered pair once when
    ``symmetric``, as ``seq_bound_ms`` does; ``d2`` is the augmented row
    width (d + 2)."""
    T_steps = l - 1  # the difference sweep of the benchmark configuration
    lvl = LEVELS + 1
    pairs = nz * (nz + 1) // 2 if symmetric else nz * nz
    if name == "kzz_fwd":
        fma = 4 * LT * pairs * d2
        nbytes = 4 * (4 * LT * nz * d2 + lvl * nz * nz)
    elif name == "kzz_bwd":
        fma = 12 * LT * pairs * d2
        nbytes = 4 * (8 * LT * nz * d2 + lvl * nz * nz)
    elif name == "kzx_fwd":
        fma = 4 * LT * nz * n * T_steps * d2
        nbytes = 4 * (2 * LT * nz * d2 + 2 * n * l * d2 + lvl * nz * n)
    else:
        fma = 12 * LT * nz * n * T_steps * d2
        nbytes = 4 * (4 * LT * nz * d2 + 4 * n * l * d2 + lvl * nz * n)
    t_ops, t_bytes = 2 * fma / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def seq_bound_ms(name: str, case, d2: int = D2, order: int = 1,
                 levels: int = LEVELS) -> tuple[float, str]:
    """``bound_ms`` for K5/K6 on a SEQ_CASES entry: per increment entry of
    the pairs this run computes (each unordered pair once when symmetric),
    4 dots of d2 plus, a level past the first, 2 FMAs a tile of its grid
    (the product, the level sum) and one a column carry or scan (d of
    each, d = min(level, order)): 3 a level at order 1 (the product, the
    column sum, the prefix), 2 d^2 + d at a higher order, whose extra
    tiles this counts; and the level sum.  Backward the dots, four d2-wide
    weight contractions on each side and the levels forward and in
    reverse.  Bytes: the four row arrays (and the cotangent) read, the
    level stack (the four gradients) written."""
    n1, l1, n2, l2, sym, _, diff = case
    pairs = n1 * (n1 + 1) // 2 if sym else n1 * n2
    entries = pairs * (l1 - diff) * (l2 - diff)
    rows = 2 * (n1 * l1 + n2 * l2) * d2
    grid = sum(2 * min(i, order) ** 2 + min(i, order)
               for i in range(2, levels + 1))
    if name == "seq_fwd":
        fma = entries * (4 * d2 + grid + 1)
        nbytes = 4 * (rows + (levels + 1) * n1 * n2)
    else:
        fma = entries * (12 * d2 + 2 * grid + 1)
        nbytes = 4 * (2 * rows + (levels + 1) * n1 * n2)
    t_ops, t_bytes = 2 * fma / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_seq_kernels(sc, ic, Zs, X, ls):
    """Phase 4a': K5 and K6 vs their plain versions at the three
    full-width shapes (Kzz, Kzx, full Kxx), at Kzx with 205-step data and
    at the full Kxx of 315-step data, interleaved."""
    rows = []
    for case in SEQ_CASES[:4] + SEQ_CASES[5:6]:
        n1, l1, n2, l2, sym, base, diff = case
        r, ct = seq_inputs(ic, Zs, X, ls, case, torch.float32)
        kw = dict(num_levels=LEVELS, base=base, difference=diff,
                  symmetric=sym)
        for name, kern, plain in (
                ("seq_fwd", lambda: sc.seq_fwd(*r, **kw),
                 lambda: sc.seq_fwd_plain(*r, **kw)),
                ("seq_bwd", lambda: sc.seq_bwd(*r, ct, **kw),
                 lambda: sc.seq_bwd_plain(*r, ct, **kw))):
            p1, k1, k2, p2 = (time_cuda(plain, reps=5), time_cuda(kern),
                              time_cuda(kern), time_cuda(plain, reps=5))
            b_ms, b_by = seq_bound_ms(name, case)
            rows.append(dict(kernel=name, N1=n1, L1=l1, N2=n2, L2=l2,
                             symmetric=sym, ms=[k1, k2], plain_ms=[p1, p2],
                             bound_ms=b_ms, bound_by=b_by))
            print(f"  {name} ({n1}x{l1} vs {n2}x{l2}, symmetric={sym}): "
                  f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
                  f"{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def full_cov_check(T, model, X, bound=1e-5, k5=1):
    """Phase 3b: the tensor model's ``predict_f(full_cov=True)`` at N=50,
    L=93 launches K5 once (``k5`` times: an inducing-sequences model's
    Kzz, Kzx and full Kxx); the covariance's diagonal is ``predict_f``'s
    variance within ``bound`` relative (its mean ``predict_f``'s within
    ``bound``), and its jittered Cholesky succeeds.  The full covariance
    normalizes Kzx by the diagonal of the full Kxx (K5's self-pairs),
    ``predict_f`` by the closed-form diagonal, as the JAX package does
    (``gpsig_tpu/kernels.py:911-934``): under matern12 both sit at r = 0,
    the |.| kink, where two f32 evaluations differ by ~sqrt(eps), so the
    matern12 model is held to KINK_FWD."""
    Xq = torch.as_tensor(X[:BATCH], device="cuda")
    reset_counts()
    with torch.no_grad():
        mean, cov = model.predict_f(Xq, full_cov=True)
    torch.cuda.synchronize()
    launches = read_counts()
    with torch.no_grad():
        mean_d, var = model.predict_f(Xq)
    print(f"  launches during predict_f(full_cov=True): {launches}")
    check(launches["seq_fwd"] == k5,
          f"full_cov launched K5 {launches['seq_fwd']} times, not {k5}")
    check(cov.shape == (C, BATCH, BATCH), f"covariance shape {cov.shape}")
    check(bool(torch.isfinite(cov).all()), "non-finite covariance")
    rel = float(((torch.diagonal(cov, dim1=1, dim2=2).T - var).abs()
                 / var.abs()).max())
    mean_err = float((mean - mean_d).abs().max())
    eye = torch.eye(BATCH, device="cuda", dtype=cov.dtype)
    _, info = torch.linalg.cholesky_ex(cov + T.config.jitter() * eye)
    min_eig = float(torch.linalg.eigvalsh(cov.double()).min())
    print(f"  diag vs variance: {rel:.3e} relative; mean vs predict_f: "
          f"{mean_err:.3e}; Cholesky info {info.tolist()}; smallest "
          f"eigenvalue {min_eig:.3e}")
    check(rel <= bound, f"covariance diagonal off the variance by {rel}")
    check(mean_err <= bound, f"full_cov mean off by {mean_err}")
    check(not bool(info.any()), "the jittered Cholesky failed")
    return dict(launches=launches, diag_rel_err=rel, mean_err=mean_err,
                min_eigenvalue=min_eig)


def time_graph(fn, reps=20) -> float:
    """A call's device time alone: ``reps`` calls captured in a CUDA graph,
    replayed; the host work of the wrapper between launches drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_cuda(graph.replay, reps=5, warm=2) / reps


def time_kernels(ic, ut, X):
    """Phase 4a: kernel vs plain at the benchmark shapes, interleaved; K1
    and K2 in both modes (symmetric is the main path's), each with both
    bounds; K1, K2 and K3 at the serving batches also from a CUDA graph
    (the launch alone).  A checkout whose K1 and K2 lack the symmetric mode
    times their all-pairs rows only."""
    Z_np, ls = benchmark_inputs(ut, X)
    modes = ((False, True) if "symmetric" in inspect.signature(
        ic.kzz_fwd).parameters else (False,))
    rows = []
    for name, n, sym in (
            [("kzz_fwd", BATCH, s) for s in modes]
            + [("kzx_fwd", 1, False), ("kzx_fwd", 8, False),
               ("kzx_fwd", 32, False), ("kzx_fwd", BATCH, False)]
            + [("kzz_bwd", BATCH, s) for s in modes]
            + [("kzx_bwd", BATCH, False)]):
        zz, zx = kernel_inputs(ic, X, Z_np, ls, N_IND, n, L, base="rbf",
                               inc=True, dtype=torch.float32)
        cz, cx = cotangents(N_IND, n, torch.float32)
        kw = dict(num_levels=LEVELS, base="rbf", increments=True)
        kwx = dict(kw, difference=True)
        if sym:
            kw["symmetric"] = True
        kern, plain = {
            "kzz_fwd": (lambda: ic.kzz_fwd(*zz, **kw),
                        lambda: ic.kzz_fwd_plain(*zz, **kw)),
            "kzx_fwd": (lambda: ic.kzx_fwd(*zx, **kwx),
                        lambda: ic.kzx_fwd_plain(*zx, **kwx)),
            "kzz_bwd": (lambda: ic.kzz_bwd(*zz, cz, **kw),
                        lambda: ic.kzz_bwd_plain(*zz, cz, **kw)),
            "kzx_bwd": (lambda: ic.kzx_bwd(*zx, cx, **kwx),
                        lambda: ic.kzx_bwd_plain(*zx, cx, **kwx)),
        }[name]
        p1, k1, k2, p2 = (time_cuda(plain), time_cuda(kern),
                          time_cuda(kern), time_cuda(plain))
        b_ms, b_by = bound_ms(name, N_IND, n, L, symmetric=sym)
        rows.append(dict(kernel=name, N=n, symmetric=sym, ms=[k1, k2],
                         plain_ms=[p1, p2], bound_ms=b_ms, bound_by=b_by))
        extra = ""
        if name.startswith("kzz"):
            all_ms, _ = bound_ms(name, N_IND, n, L)
            rows[-1]["bound_all_pairs_ms"] = all_ms
            extra = f", all-pairs bound {all_ms:.4f} ms"
        if name.startswith("kzz") or n < 32:
            rows[-1]["graph_ms"] = time_graph(kern)
            extra += f", launch alone {rows[-1]['graph_ms']:.4f} ms"
        print(f"  {name} (nZ={N_IND}, N={n}, L={L}, symmetric={sym}): kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}){extra}")
    return rows


def time_requests(pred, X, reps=10, warm=2, len_buckets=LEN_BUCKETS):
    """Phase 4b: request latency per bucket, host clock around a
    synchronized predict_y, median of ``reps`` warmed calls."""
    rows = []
    for lb in len_buckets:
        for b in BATCH_BUCKETS:
            Xq = X[:b, :lb]
            for _ in range(warm):
                pred.predict_y(Xq)
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                mean, _ = pred.predict_y(Xq)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            rows.append(dict(len_bucket=lb, batch_bucket=b,
                             median_ms=float(np.median(ts)),
                             min_ms=float(np.min(ts))))
            print(f"  bucket (L={lb}, batch={b}): median "
                  f"{np.median(ts):.3f} ms, min {np.min(ts):.3f} ms")
    return rows


def time_training(T, model, X, y, reps=20, warm=5, profiled=3):
    """Phase 4c: training steps/s (host clock around each synchronized
    step, median of ``reps`` after ``warm`` warm-up steps) and a profile
    of ``profiled`` steps."""
    opts = T.training.masked_optimizer(
        T.training.nadam(LR), model, T.training.path_mask(model, phase2_mask))
    data = T.training.BatchIterator(
        T.training.MinibatchStream(N_TRAIN, BATCH, seed_or_rng=SEED + 3),
        X, y[:, None].astype(np.float32), device="cuda")

    def step():
        xb, yb = next(data)
        model.zero_grad(set_to_none=True)
        model.loss(xb, yb).backward()
        for o in opts:
            o.step()

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ts))
    print(f"  training step: median {med:.3f} ms ({1e3 / med:.2f} steps/s), "
          f"min {min(ts):.3f} ms")
    return dict(step_ms=ts, median_ms=med, steps_per_s=1e3 / med,
                profile=profile_steps(step, profiled))


def _device_kernels(prof) -> dict:
    """{name: (microseconds, count)} of a profile's device activity
    (kernels, copies), without the ranges that user annotations such as
    Optimizer.step draw over it on the device."""
    from torch.autograd import DeviceType

    kernels: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us, count = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return kernels


def profile_steps(step, n_steps: int = 3) -> dict:
    """Device busy share, launches and the largest legs of a step, from
    ``torch.profiler``; CUDA events over the same steps if the profiler
    shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    events = prof.key_averages()
    kernels = _device_kernels(prof)
    device_ms = sum(us for us, _ in kernels.values()) / 1e3 / n_steps
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               launches_per_step=launches / n_steps)
    if device_ms == 0.0:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_steps):
            step()
        end.record()
        torch.cuda.synchronize()
        out.update(busy_share="not measured (no device time in the "
                   "profile)", event_span_ms=start.elapsed_time(end) / n_steps)
        print(f"  profile: no device time; step span by CUDA events "
              f"{out['event_span_ms']:.3f} ms")
        return out
    out["busy_share"] = device_ms / wall_ms
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    out["top_kernels"] = [dict(name=name[:90], ms_per_step=us / 1e3 / n_steps,
                               count_per_step=count / n_steps)
                          for name, (us, count) in top]
    cpu_top = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    out["top_host_ops"] = [dict(name=e.key[:90], self_cpu_ms_per_step=(
        e.self_cpu_time_total / 1e3 / n_steps), count_per_step=e.count /
        n_steps) for e in cpu_top]
    print(f"  profile: wall {wall_ms:.3f} ms/step, device {device_ms:.3f} "
          f"ms/step (busy {100 * out['busy_share']:.1f}%), "
          f"{out['launches_per_step']:.0f} launches/step")
    for r in out["top_kernels"]:
        print(f"    {r['ms_per_step']:.4f} ms x{r['count_per_step']:.0f} "
              f"{r['name']}")
    for r in out["top_host_ops"]:
        print(f"    host {r['self_cpu_ms_per_step']:.3f} ms "
              f"x{r['count_per_step']:.0f} {r['name']}")
    return out


def lagged_rows(T, ic, ut, X, y, dtype):
    """The lagged model's own rows at ``dtype`` on the card: 500
    incremental inducing tensors lag-tiled by the ported heuristic, 50
    examples of 93 steps and 500 inducing sequences of length 5, each
    lag-augmented, divided by the lengthscales and weighted by gamma as
    ``SignatureKernel`` does (d2 = 30); and cotangents from the seed."""
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    kern = T.kernels.SignatureRBF(D, LEVELS, lengthscales=ls, num_lags=LAGS,
                                  dtype=dtype, device="cuda")
    Z = ut.suggest_initial_inducing_tensors(
        X, LEVELS, N_IND, labels=y, increments=True, num_lags=LAGS, seed=SEED)
    Zs = ut.suggest_initial_inducing_sequences(X, N_IND, LEN_IND, labels=y,
                                               seed=SEED)

    def on(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    with torch.no_grad():
        cp = kern.constrain()
        Zt = kern._scale_tensors(cp, on(Z))
        Xt = kern._scale_sequences(cp, on(X[:BATCH]))
        St = kern._scale_sequences(cp, on(Zs))
    zz = (*ic._prep_tensors(Zt, "rbf", True, lhs=True),
          *ic._prep_tensors(Zt, "rbf", True, lhs=False))
    seqs = {"Kzz": (St, St), "Kzx": (St, Xt), "Kxx": (Xt, Xt)}
    rows = dict(zz=zz, zx=(*zz[:2], *ic._prep_seq(Xt, "rbf")), **{
        k: (*ic._prep_seq(a, "rbf", lhs=True), *ic._prep_seq(b, "rbf"))
        for k, (a, b) in seqs.items()})
    check(rows["zx"][2].shape[-1] == D_LAG2, "lagged rows: not d2 = 30")
    rng = np.random.RandomState(SEED + 14)
    shapes = dict(zz=(N_IND, N_IND), zx=(N_IND, BATCH), Kzz=(N_IND, N_IND),
                  Kzx=(N_IND, BATCH), Kxx=(BATCH, BATCH))
    cts = {k: on(rng.randn(LEVELS + 1, *sh)) for k, sh in shapes.items()}
    return rows, cts


def lagged_setup(T, ic, ut, X, y):
    """For each of K1-K6 at the lagged width, its shape and a
    ``call(fn, dtype)`` of its kernel or plain version on the lagged rows:
    K1/K2 on the Kzz of 500 inducing tensors (symmetric, the main path's),
    K3/K4 on their Kzx against 50 examples of 93 steps, K5/K6 on the
    sequences model's Kzz, Kzx and full Kxx."""
    ins = {dt: lagged_rows(T, ic, ut, X, y, dt)
           for dt in (torch.float32, torch.float64)}
    kw = dict(num_levels=LEVELS, base="rbf", increments=True)
    specs = [("kzz_fwd", "zz", False, dict(kw, symmetric=True),
              dict(nz=N_IND, symmetric=True)),
             ("kzz_bwd", "zz", True, dict(kw, symmetric=True),
              dict(nz=N_IND, symmetric=True)),
             ("kzx_fwd", "zx", False, dict(kw, difference=True),
              dict(nz=N_IND, N=BATCH, L=L, symmetric=False)),
             ("kzx_bwd", "zx", True, dict(kw, difference=True),
              dict(nz=N_IND, N=BATCH, L=L, symmetric=False))]
    for key, case in LAG_SEQ.items():
        n1, l1, n2, l2, sym, base, diff = case
        opts = dict(num_levels=LEVELS, base=base, difference=diff,
                    symmetric=sym)
        meta = dict(gram=key, N1=n1, L1=l1, N2=n2, L2=l2, symmetric=sym)
        specs += [("seq_fwd", key, False, opts, meta),
                  ("seq_bwd", key, True, opts, meta)]
    out = []
    for name, at, bwd, opts, meta in specs:
        def call(fn, dtype, at=at, bwd=bwd, opts=opts):
            rows, cts = ins[dtype]
            return fn(*rows[at], *((cts[at],) if bwd else ()), **opts)
        out.append((name, dict(meta, d2=D_LAG2, lags=LAGS), call))
    return out


def lagged_kernel_checks(T, ic, ut, X, y):
    """Phase 2h: K1-K6 at the lagged width (d=14, num_lags=1, d2 = 30)
    against their plain versions under phase 2's bounds; symmetric outputs
    exactly symmetric, K2, K4 and K6 bit-identical across two launches."""
    rows = []
    for name, meta, call in lagged_setup(T, ic, ut, X, y):
        out = call(_wrapper(name), torch.float32)
        if name.endswith("bwd"):
            again = call(_wrapper(name), torch.float32)
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"{name} {meta}: two launches differ")
        elif meta["symmetric"]:
            check(torch.equal(out, out.transpose(1, 2)),
                  f"{name} {meta}: not exactly symmetric")
        torch.cuda.synchronize()
        rows.append(check_against_plain(
            name, out, call(_plain(name), torch.float32),
            call(_plain(name), torch.float64), meta))
    return rows


def time_lagged_kernels(T, ic, ut, X, y):
    """Phase 4e: K1-K6 at the lagged width against their plain versions,
    interleaved as phase 4a; K1 and K2 also from a CUDA graph."""
    rows = []
    for name, meta, call in lagged_setup(T, ic, ut, X, y):
        def kern():
            return call(_wrapper(name), torch.float32)

        def plain():
            return call(_plain(name), torch.float32)

        p1, k1, k2, p2 = (time_cuda(plain, reps=5), time_cuda(kern),
                          time_cuda(kern), time_cuda(plain, reps=5))
        if name.startswith("seq"):
            b_ms, b_by = seq_bound_ms(name, LAG_SEQ[meta["gram"]], d2=D_LAG2)
        else:
            b_ms, b_by = bound_ms(name, N_IND, BATCH, L, meta["symmetric"],
                                  d2=D_LAG2)
        row = dict(kernel=name, **meta, ms=[k1, k2], plain_ms=[p1, p2],
                   bound_ms=b_ms, bound_by=b_by)
        extra = ""
        if name.startswith("kzz"):
            row["graph_ms"] = time_graph(kern)
            extra = f", launch alone {row['graph_ms']:.4f} ms"
        rows.append(row)
        print(f"  {name} (d2={D_LAG2}, {meta.get('gram', 'tensors')}): kernel"
              f" {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}){extra}")
    return rows


def drive_lagged_model(T, ut, X, y, classes):
    """Phase 7: the benchmark-width model with num_lags=1 (d2 = 30 in the
    kernels) and the recipe's likelihood for ``classes``: bucketed serving
    against the f64 CPU path at the same bucket, the gradient of every
    leaf (``kern/lags`` and ``kern/gamma`` among them) against it, then 30
    NAdam steps under the phase-2 mask, K1-K4 once a step."""
    model, ref, build = synthetic_setup(ut, T, X, y, "tensors",
                                        num_lags=LAGS, classes=classes)
    pred, serve_launches, requests = drive_serving(
        T, model, ref, X, ("kzz_fwd", "kzx_fwd"), same_bucket=True)
    grads = gradient_check(T, model, ref, build, X, y)
    got = {r["leaf"] for r in grads["leaves"]}
    check({"kern/lags", "kern/gamma"} <= got, f"lag leaves missing: {got}")
    launches, train = drive_training(
        T, model, X, y, dict.fromkeys(("kzz_fwd", "kzx_fwd", "kzz_bwd",
                                       "kzx_bwd"), 1))
    return model, build, dict(classes=classes, serving_launches=serve_launches,
                              requests=requests, gradient_check=grads,
                              training_launches=launches, training=train)


def write_recipe_data(path, classes: int, seed: int) -> None:
    """A dataset in the reference's ``.mat`` layout: 2,000 training and 500
    test sequences of 93 steps and 13 channels, labels 1..classes; a class
    sets a drift in the first channel and the frequency of a sinusoid in
    every channel, under unit-scale noise."""
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 1.0, L)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, RECIPE_CHANNELS)[None, None, :]

    def block(n):
        lab = rng.randint(0, classes, n)
        c = lab[:, None, None] / max(classes - 1, 1)
        amp = 0.8 + 0.4 * rng.rand(n, 1, 1)
        Xb = amp * np.sin(2 * np.pi * (1.0 + 2.0 * c) * t + phase)
        Xb[:, :, :1] += 2.0 * c * t[:, :, :1]
        Xb = Xb + 0.3 * rng.randn(n, L, RECIPE_CHANNELS)
        obj = np.empty(n, dtype=object)
        for i in range(n):
            obj[i] = Xb[i]
        return obj, (lab + 1).astype(np.float64)

    X_train, y_train = block(RECIPE_TRAIN)
    X_test, y_test = block(RECIPE_TEST)
    savemat(path, {"X_train": X_train, "y_train": y_train,
                   "X_test": X_test, "y_test": y_test})


def drive_recipe(T, tmp: Path, classes: int, low_rank: bool = False,
                 num_inducing: int = N_IND) -> dict:
    """Phase 8a: ``recipes.train_gpsig_classifier`` on the card with
    num_lags=1, 500 inducing tensors, M=4, val_split=0.2, epochs_cap=1 (32
    steps a phase) on data written here: all four phases run (the history
    on disk holds a record at the end of each), every phase's checkpoint is
    written, K1-K4 launch, the results are finite and the test accuracy is
    above chance.  Phase 12c: ``low_rank`` with ``num_inducing`` inducing
    tensors, no kernel launched."""
    name = f"{'LowRank' if low_rank else 'Lagged'}{classes}"
    write_recipe_data(str(tmp / f"{name}.mat"), classes, SEED + classes)
    reset_counts()
    t0 = time.perf_counter()
    res = T.recipes.train_gpsig_classifier(
        name, num_levels=LEVELS, num_inducing=num_inducing,
        minibatch_size=BATCH,
        num_lags=LAGS, val_split=0.2, epochs_cap=1, data_dir=str(tmp),
        save_dir=str(tmp / "out"), checkpoint_dir=str(tmp / "ckpt"),
        low_rank=low_rank, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    import pickle
    with open(tmp / "out" / f"{name}.pkl", "rb") as f:
        hist = pickle.load(f)
    iters = sorted(k for k in hist if isinstance(k, int))
    per_phase = (RECIPE_TRAIN - int(np.ceil(0.2 * RECIPE_TRAIN))) // BATCH
    phases = per_phase * np.arange(1, 5)
    print(f"  recipe C={classes}: {wall:.1f} s wall, results {res}, "
          f"records at {iters}, launches {launches}")
    check(all(int(p) in iters for p in phases),
          f"recipe C={classes}: not all four phases ran: {iters}")
    check(all((tmp / "ckpt" / f"{name}_phase{k}.ckpt").exists()
              for k in range(1, 5)), "a phase checkpoint is missing")
    check(all(np.isfinite(v) for v in res.values()),
          f"recipe C={classes}: non-finite results {res}")
    check(res["test_acc"] > 1.0 / classes,
          f"recipe C={classes}: test accuracy {res['test_acc']} at chance")
    if low_rank:
        check_no_launch(launches, "the low-rank recipe")
    for k in () if low_rank else ("kzz_fwd", "kzx_fwd", "kzz_bwd",
                                  "kzx_bwd"):
        check(launches[k] > 0, f"recipe: {k} was not launched")
    return dict(classes=classes, results=res, wall_s=wall, records=iters,
                launches=launches)


class Killed(Exception):
    """The simulated death of a training run."""


class KillAt:
    """A data iterator that dies before its ``n + 1``-th batch, forwarding
    the stream state the checkpoints hold."""

    def __init__(self, it, n: int):
        self.it, self.n = it, n

    def __iter__(self):
        return self

    def __next__(self):
        if self.n == 0:
            raise Killed
        self.n -= 1
        return next(self.it)

    def state(self):
        return self.it.state()

    def set_state(self, state):
        self.it.set_state(state)


def _flat(tree: dict, prefix: str = "") -> dict:
    """{'/'-joined path: leaf} of a nested parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def kill_and_resume(T, build, X, y, tmp: Path) -> dict:
    """Phase 8b: phase 2 of the recipe (the phase-2 mask, best-on-val on
    100 held-out examples, patience) on the lagged benchmark-width model,
    32 steps with a checkpoint every 8, run to its end once; run again and
    killed before its 14th step, between the checkpoints at 8 and 16; then
    resumed from the file by a fresh model, optimizer and stream (another
    seed).  The final parameters, the best snapshot and the loss records
    after the resume point must equal the uninterrupted run's bit for
    bit."""
    Xv, yv = X[-100:], y[-100:]

    def run(path, seed, kill=None, resume=False):
        model = build(torch.float32, "on", "cuda")
        data = T.training.BatchIterator(
            T.training.MinibatchStream(N_TRAIN - 100, BATCH, seed_or_rng=seed),
            X[:-100], y[:-100, None].astype(np.float32), device="cuda")
        hist = T.training.optimize(
            lambda m, xb, yb: m.loss(xb, yb), model, T.training.nadam(LR),
            max_iter=KILL_ITERS,
            data_iter=data if kill is None else KillAt(data, kill),
            trainable=phase2_mask,
            val_scorer=lambda m: T.metrics.nlpp(m, Xv, yv, batch_size=BATCH),
            save_best_params=True, lower_is_better=True, patience=KILL_ITERS,
            save_freq=KILL_SAVE, print_freq=10 ** 9,
            checkpoint_path=str(path), resume_from=str(path) if resume else None,
            log_fn=lambda s: print(f"  {s}"))
        return model, hist

    model_a, hist_a = run(tmp / "whole.ckpt", SEED + 5)
    try:
        run(tmp / "killed.ckpt", SEED + 5, kill=KILL_AT)
        raise RuntimeError("the killed run did not die")
    except Killed:
        pass
    model_c, hist_c = run(tmp / "killed.ckpt", SEED + 99, resume=True)
    leaves_a = T.convert.named_leaves(model_a)
    same = {n: torch.equal(p, leaves_a[n])
            for n, p in T.convert.named_leaves(model_c).items()}
    after = [it for it in hist_a if isinstance(it, int) and it > KILL_SAVE]
    losses = {it: (hist_a[it]["loss"], hist_c[it]["loss"]) for it in after}
    print(f"  kill-and-resume: records of the resumed run at "
          f"{sorted(k for k in hist_c if isinstance(k, int))}, "
          f"leaves bit-equal {sum(same.values())}/{len(same)}, losses after "
          f"the resume point {losses}, best at {hist_a['best']['iter']} / "
          f"{hist_c['best']['iter']}")
    check(all(same.values()), f"kill-and-resume: parameters differ: {same}")
    check(all(a == c for a, c in losses.values()),
          f"kill-and-resume: loss records differ: {losses}")
    best_a, best_c = (_flat(h["best"]["params"]) for h in (hist_a, hist_c))
    check(hist_a["best"]["iter"] == hist_c["best"]["iter"]
          and best_a.keys() == best_c.keys()
          and all(np.array_equal(best_a[k], best_c[k]) for k in best_a),
          "kill-and-resume: the best snapshots differ")
    return dict(leaves_bit_equal=same, losses_after_resume=losses,
                best_iter=hist_a["best"]["iter"])


# ---------------------------------------------------------------------------
# phase 9: the matern12 base (SignatureMatern12, bench.py --svgp --base
# matern12)
# ---------------------------------------------------------------------------


def m12_probe_check(sc) -> dict:
    """Phase 9a': ``common.cuh``'s matern12 closed form and its six
    partials (through ``signature_cuda.m12_probe``) against
    ``gram.mat12_cross_partials`` at float64 on the same float32 inputs:
    corner dots of 2**16 random point pairs and steps at the benchmark
    width (d=14, steps from 1e-3 to 1 of the points' spread), each column
    within 1e-4 of max(its largest magnitude, 1)."""
    from gpsig_tpu_torch.ops import gram

    rng = np.random.RandomState(SEED + 15)
    n = 1 << 16
    x, y = rng.randn(n, D) * 0.5, rng.randn(n, D) * 0.5
    size = 10.0 ** rng.uniform(-3, 0, (2, n, 1))
    dx, dy = rng.randn(n, D) * size[0], rng.randn(n, D) * size[1]
    nx, ny = -0.5 * np.sum(x * x, 1), -0.5 * np.sum(y * y, 1)
    a00 = np.sum(x * y, 1) + nx + ny
    d01 = np.sum(x * dy, 1) - 0.5 * np.sum((2 * y + dy) * dy, 1)
    d10 = np.sum(dx * y, 1) - 0.5 * np.sum((2 * x + dx) * dx, 1)
    dxx = np.sum(dx * dy, 1)
    args = np.stack([a00, d01, d10, dxx, np.linalg.norm(dx, axis=1),
                     np.linalg.norm(dy, axis=1)], 1).astype(np.float32)
    out = sc.m12_probe(torch.as_tensor(args, device="cuda")).double().cpu()
    M, P = gram.mat12_cross_partials(*torch.as_tensor(args).double().T)
    want = [M, M, *P, M]
    errs = [float((out[:, k] - w).abs().max()
                  / max(float(w.abs().max()), 1.0))
            for k, w in enumerate(want)]
    print("  matern12 device algebra vs float64 on 65536 corner pairs "
          "(relative to each column's largest, floored at 1): value "
          f"{errs[0]:.2e}, with partials {errs[1]:.2e}, partials "
          + " / ".join(f"{e:.2e}" for e in errs[2:8])
          + f", with expm1f {errs[8]:.2e}")
    check(max(errs) <= 1e-4, f"matern12 device algebra off float64: {errs}")
    return dict(pairs=n, rel_err=errs)


def m12_kernel_checks(ic, sc, ut, X, Zs, ls):
    """Phase 9a: K1-K6 under matern12 against their plain versions at f32
    and f64.  K1/K2 on 500 benchmark inducing tensors and 37 ragged ones
    (with and without increments), both modes; K3/K4 at 500 x 50 x 93 and
    in all four increments x difference cases at 37 x 3 x 18; K5/K6 at the
    sequences model's Kzz, Kzx and full Kxx and at 315 steps (past one
    inner chunk: symmetric, and 20 x 10 distinct sequences).  Phase 2's
    bounds hold where the pairs are distinct; a symmetric Gram's diagonal
    pairs meet their own points at r = 0, the |.| kink of exp(-r), where
    f32 is sqrt(eps)-limited against any reference: those are held to
    JAX's matern12 bounds (KINK_FWD, KINK_BWD relative to max(scale, 1)),
    the gradients of the off-diagonal pairs (a cotangent with a zero
    diagonal) to phase 2's -- the f32 bound against the nearer of the f32
    plain version and f64, and against f64 alone for a part where the f32
    plain version itself misses the f32 bound (``f32_floor``: matern12's
    entries carry ~10 ulp, and the level sums of 93 white-noise steps
    amplify that to ~1e-5 of a level, so the two f32 versions differ by
    twice that).  At the kink f64 is no reference for f32: the self-pairs'
    a00 is rounding noise, so r00 is sqrt(eps)-sized and exp(-r)'s
    derivative 1/r00-sized in both, 1e8 times larger at f64 -- there the
    kernel is held against the f32 plain version and the f64 error is
    read.  K2, K4 and K6 bit-identical across two launches, symmetric K1
    and K5 outputs exactly symmetric."""
    f32, f64 = torch.float32, torch.float64
    Z_np, _ = benchmark_inputs(ut, X)
    rows = []

    def bwd_twice(name, fn):
        grads, again = fn(), fn()
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"{name} (matern12): two launches differ")
        return grads

    def held(name, out, plain, meta, kink):
        """out and its plain versions (f32, f64), phase 2's bounds off the
        kink, the kink's bound on all of it."""
        p32, p64 = plain(f32), plain(f64)
        if kink is None:
            rows.append(check_against_plain(name, out, p32, p64, meta,
                                            f32_floor=True))
            return
        off, bound = kink
        if off is not None:  # a level stack off its diagonal
            rows.append(check_against_plain(
                name, out[:, off], p32[:, off], p64[:, off],
                dict(meta, part="off the diagonal"), f32_floor=True))
        rows.append(check_against_plain(name, out, p32, p64,
                                        dict(meta, part="all"), kink=bound))

    for nz, inc in ((N_IND, True), (37, True), (37, False)):
        zz = {dt: kernel_inputs(ic, X, Z_np, ls, nz, 3, 18, base=M12,
                                inc=inc, dtype=dt)[0] for dt in (f32, f64)}
        cz = cotangents(nz, 3, f32)[0].double()
        off = ~torch.eye(nz, dtype=torch.bool, device="cuda")
        for sym in (False, True):
            kw = dict(num_levels=LEVELS, base=M12, increments=inc,
                      symmetric=sym)
            meta = dict(nz=nz, base=M12, increments=inc, symmetric=sym)
            out = ic.kzz_fwd(*zz[f32], **kw)
            if sym:
                check(torch.equal(out, out.transpose(1, 2)),
                      f"kzz_fwd (matern12) {nz, inc}: not exactly symmetric")
            held("kzz_fwd", out,
                 lambda dt: ic.kzz_fwd_plain(*zz[dt], **kw), meta,
                 (off, KINK_FWD))
            for ct, part, bound in ((cz * off, "zero-diagonal cotangent",
                                     None),
                                    (cz, "full cotangent", KINK_BWD)):
                grads = bwd_twice("kzz_bwd", lambda: ic.kzz_bwd(
                    *zz[f32], ct.float(), **kw))
                torch.cuda.synchronize()
                rows.append(check_against_plain(
                    "kzz_bwd", grads,
                    ic.kzz_bwd_plain(*zz[f32], ct.float(), **kw),
                    ic.kzz_bwd_plain(*zz[f64], ct, **kw),
                    dict(meta, part=part), kink=bound))
    for nz, n, l, inc, diff in ((N_IND, BATCH, L, True, True),
                                (37, 3, 18, True, True),
                                (37, 3, 18, True, False),
                                (37, 3, 18, False, True),
                                (37, 3, 18, False, False)):
        zx = {dt: kernel_inputs(ic, X, Z_np, ls, nz, n, l, base=M12,
                                inc=inc, dtype=dt)[1] for dt in (f32, f64)}
        cx = cotangents(nz, n, f32)[1].double()
        kw = dict(num_levels=LEVELS, base=M12, increments=inc,
                  difference=diff)
        meta = dict(nz=nz, N=n, L=l, base=M12, increments=inc,
                    difference=diff)
        held("kzx_fwd", ic.kzx_fwd(*zx[f32], **kw),
             lambda dt: ic.kzx_fwd_plain(*zx[dt], **kw), meta, None)
        grads = bwd_twice("kzx_bwd", lambda: ic.kzx_bwd(
            *zx[f32], cx.float(), **kw))
        torch.cuda.synchronize()
        rows.append(check_against_plain(
            "kzx_bwd", grads, ic.kzx_bwd_plain(*zx[f32], cx.float(), **kw),
            ic.kzx_bwd_plain(*zx[f64], cx, **kw), meta))
    for case in M12_SEQ_CASES:
        n1, l1, n2, l2, sym, base, diff = case
        r = {dt: seq_inputs(ic, Zs, X, ls, case, dt) for dt in (f32, f64)}
        ct = r[f32][1].double()
        kw = dict(num_levels=LEVELS, base=base, difference=diff,
                  symmetric=sym)
        meta = dict(N1=n1, L1=l1, N2=n2, L2=l2, symmetric=sym, base=base)
        out = sc.seq_fwd(*r[f32][0], **kw)
        kink, cts = None, ((ct, "cotangent", None),)
        if sym:
            check(torch.equal(out, out.transpose(1, 2)),
                  f"seq_fwd (matern12) {case}: not exactly symmetric")
            off = ~torch.eye(n1, dtype=torch.bool, device="cuda")
            kink = (off, KINK_FWD)
            cts = ((ct * off, "zero-diagonal cotangent", None),
                   (ct, "full cotangent", KINK_BWD))
        held("seq_fwd", out, lambda dt: sc.seq_fwd_plain(*r[dt][0], **kw),
             meta, kink)
        for c, part, bound in cts:
            grads = bwd_twice("seq_bwd", lambda: sc.seq_bwd(
                *r[f32][0], c.float(), **kw))
            torch.cuda.synchronize()
            rows.append(check_against_plain(
                "seq_bwd", grads, sc.seq_bwd_plain(*r[f32][0], c.float(),
                                                   **kw),
                sc.seq_bwd_plain(*r[f64][0], c, **kw),
                dict(meta, part=part), kink=bound, f32_floor=bound is None))
    return rows


def drive_m12_model(T, ut, X, y, kind):
    """Phases 9b-9d: the benchmark-width SignatureMatern12 SVGP
    (``bench.py --svgp --base matern12``) with 500 inducing tensors or 500
    inducing sequences of length 5: served (means within 1e-3 of the f64
    CPU path, the same argmax where decided), every leaf's gradient held
    (``plain_floor``), then 30 NAdam steps under the phase-2 mask."""
    model, ref, build = synthetic_setup(ut, T, X, y, kind, base=M12)
    expect = ("kzz_fwd", "kzx_fwd") if kind == "tensors" else ("seq_fwd",)
    pred, serve_launches, requests = drive_serving(T, model, ref, X, expect)
    grads = gradient_check(T, model, ref, build, X, y, plain_floor=True)
    per_step = (dict.fromkeys(("kzz_fwd", "kzx_fwd", "kzz_bwd", "kzx_bwd"),
                              1) if kind == "tensors"
                else {"seq_fwd": 2, "seq_bwd": 2})
    launches, train = drive_training(T, model, X, y, per_step)
    return model, pred, dict(kind=kind, serving_launches=serve_launches,
                             requests=requests, gradient_check=grads,
                             training_launches=launches, training=train)


def time_m12_kernels(ic, sc, ut, X, Zs, ls):
    """Phase 9f: K1-K6 under matern12 at d2 = 16 against their plain
    versions, interleaved as phase 4a (K1/K2 symmetric, the main path's,
    also from a CUDA graph: the launch alone; K3/K4 at N=50; K5/K6 at the
    sequences model's Kzz, Kzx and full Kxx)."""
    Z_np, _ = benchmark_inputs(ut, X)
    zz, zx = kernel_inputs(ic, X, Z_np, ls, N_IND, BATCH, L, base=M12,
                           inc=True, dtype=torch.float32)
    cz, cx = cotangents(N_IND, BATCH, torch.float32)
    kw = dict(num_levels=LEVELS, base=M12, increments=True)
    kwz, kwx = dict(kw, symmetric=True), dict(kw, difference=True)
    calls = [("kzz_fwd", dict(symmetric=True),
              lambda: ic.kzz_fwd(*zz, **kwz),
              lambda: ic.kzz_fwd_plain(*zz, **kwz)),
             ("kzz_bwd", dict(symmetric=True),
              lambda: ic.kzz_bwd(*zz, cz, **kwz),
              lambda: ic.kzz_bwd_plain(*zz, cz, **kwz)),
             ("kzx_fwd", dict(N=BATCH), lambda: ic.kzx_fwd(*zx, **kwx),
              lambda: ic.kzx_fwd_plain(*zx, **kwx)),
             ("kzx_bwd", dict(N=BATCH), lambda: ic.kzx_bwd(*zx, cx, **kwx),
              lambda: ic.kzx_bwd_plain(*zx, cx, **kwx))]
    for key, case in M12_SEQ.items():
        r, ct = seq_inputs(ic, Zs, X, ls, case, torch.float32)
        kws = dict(num_levels=LEVELS, base=M12, difference=True,
                   symmetric=case[4])
        calls += [("seq_fwd", dict(gram=key, case=case),
                   lambda r=r, kws=kws: sc.seq_fwd(*r, **kws),
                   lambda r=r, kws=kws: sc.seq_fwd_plain(*r, **kws)),
                  ("seq_bwd", dict(gram=key, case=case),
                   lambda r=r, ct=ct, kws=kws: sc.seq_bwd(*r, ct, **kws),
                   lambda r=r, ct=ct, kws=kws: sc.seq_bwd_plain(*r, ct,
                                                                **kws))]
    rows = []
    for name, meta, kern, plain in calls:
        p1, k1, k2, p2 = (time_cuda(plain, reps=5), time_cuda(kern),
                          time_cuda(kern), time_cuda(plain, reps=5))
        if name.startswith("seq"):
            b_ms, b_by = seq_bound_ms(name, meta["case"])
            meta = dict(gram=meta["gram"])
        else:
            b_ms, b_by = bound_ms(name, N_IND, BATCH, L,
                                  meta.get("symmetric", False))
        row = dict(kernel=name, base=M12, **meta, ms=[k1, k2],
                   plain_ms=[p1, p2], bound_ms=b_ms, bound_by=b_by)
        extra = ""
        if name.startswith("kzz"):
            row["graph_ms"] = time_graph(kern)
            extra = f", launch alone {row['graph_ms']:.4f} ms"
        rows.append(row)
        print(f"  {name} (matern12, {meta}): kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}){extra}")
    return rows


# ---------------------------------------------------------------------------
# phase 10: order > 1 (SignatureRBF(d, M, order=k)), the (k x k) grid in K5/K6
# ---------------------------------------------------------------------------

# (N1, L1, N2, L2, symmetric, base, difference) of phase 10a, for each
# (levels, order): the sequences model's three Grams, past one inner chunk
# (50 at UWave's 315, symmetric; 7 x 5 at 300 vs WalkvsRun's 1,918 in both
# argument orders), ragged with difference on and off, linear and matern12
ORDER_CASES = (SEQ_KZZ, SEQ_KZX, SEQ_KXX,
               (BATCH, UWAVE, BATCH, UWAVE, True, "rbf", True),
               (7, 300, 5, WALK, False, "rbf", True),
               (5, WALK, 7, 300, False, "rbf", True),
               (7, 11, 5, 18, False, "rbf", True),
               (7, 11, 5, 18, False, "rbf", False),
               (7, 11, 5, 18, False, "linear", True),
               *M12_SEQ.values())
# order 3 runs on the 9-level library: the short cases
ORDER3_CASES = (SEQ_KZZ, SEQ_KZX, (7, 11, 5, 18, False, "rbf", True),
                (7, 11, 5, 18, False, "rbf", False),
                (7, 11, 5, 18, False, "linear", True))


def order_kernel_checks(sc, ic, Zs, X, ls):
    """Phase 10a: K5 and K6 at orders 2 and 4 (4 levels) on ORDER_CASES
    and at order 3 (9 levels) on ORDER3_CASES, against their plain versions
    at f32 and f64 under phase 2's bounds, each level and gradient at its
    own scale; K6 launched twice bit-identical, symmetric outputs exactly
    symmetric.  matern12's symmetric Grams meet the |.| kink at their
    diagonal pairs and are held as phase 9a holds them (off the diagonal
    at phase 2's bounds, all of it at JAX's matern12 bounds against the
    f32 plain version; the gradients of a zero-diagonal cotangent at phase
    2's)."""
    f32, f64 = torch.float32, torch.float64
    rows = []
    for levels, order in ORDER_LIBS:
        for case in ORDER_CASES if order != 3 else ORDER3_CASES:
            n1, l1, n2, l2, sym, base, diff = case
            r = {dt: seq_inputs(ic, Zs, X, ls, case, dt, levels)
                 for dt in (f32, f64)}
            kw = dict(num_levels=levels, base=base, difference=diff,
                      symmetric=sym, order=order)
            meta = dict(N1=n1, L1=l1, N2=n2, L2=l2, symmetric=sym, base=base,
                        difference=diff, levels=levels, order=order)
            out = sc.seq_fwd(*r[f32][0], **kw)
            p32 = sc.seq_fwd_plain(*r[f32][0], **kw)
            p64 = sc.seq_fwd_plain(*r[f64][0], **kw)
            torch.cuda.synchronize()
            if sym:
                check(torch.equal(out, out.transpose(1, 2)),
                      f"seq_fwd order {order} {case}: not exactly symmetric")
            ct = r[f64][1]
            m12 = base == M12
            if sym and m12:
                off = ~torch.eye(n1, dtype=torch.bool, device="cuda")
                rows.append(check_against_plain(
                    "seq_fwd", out[:, off], p32[:, off], p64[:, off],
                    dict(meta, part="off the diagonal"), f32_floor=True))
                rows.append(check_against_plain(
                    "seq_fwd", out, p32, p64, dict(meta, part="all"),
                    kink=KINK_FWD))
                ct = ct * off
            else:
                rows.append(check_against_plain("seq_fwd", out, p32, p64,
                                                meta, f32_floor=m12))
            grads = sc.seq_bwd(*r[f32][0], ct.float(), **kw)
            again = sc.seq_bwd(*r[f32][0], ct.float(), **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"seq_bwd order {order} {case}: two launches differ")
            rows.append(check_against_plain(
                "seq_bwd", grads,
                sc.seq_bwd_plain(*r[f32][0], ct.float(), **kw),
                sc.seq_bwd_plain(*r[f64][0], ct, **kw), meta,
                f32_floor=m12))
    return rows


def drive_order_model(T, ut, X, y, kind, order):
    """Phases 10b-10d: the benchmark-width SignatureRBF(14, 4, order) SVGP
    with 500 inducing sequences of length 5 or 500 incremental inducing
    tensors.  Served through ``Predictor`` (means within 1e-3 of the f64
    CPU path, the same argmax where decided), every leaf's gradient held to
    1e-3, 30 NAdam steps under the phase-2 mask, and
    ``predict_f(full_cov=True)``.  Sequences: K5 and K6 twice a step (Kzz,
    Kzx), and the full covariance launches K5 three times (Kzz, Kzx, Kxx).
    Tensors: Kzx has no kernel past order 1, so the model runs under
    'auto': K1 and K2 once a step, K3 and K4 never, K5 once for the full
    covariance's Kxx; a ``fused='on'`` twin raises on its Kzx."""
    tensors = kind == "tensors"
    model, ref, build = synthetic_setup(
        ut, T, X, y, kind, order=order, fused="auto" if tensors else "on")
    check(model.kern.order == order, f"kernel order {model.kern.order}")
    expect = ("kzz_fwd",) if tensors else ("seq_fwd",)
    pred, serve_launches, requests = drive_serving(T, model, ref, X, expect)
    if tensors:
        check(serve_launches["kzx_fwd"] == 0, "K3 launched at order "
              f"{order}: {serve_launches}")
        twin = build(torch.float32, "on", "cuda")
        Xq = torch.as_tensor(X[:2], device="cuda")
        try:
            twin.predict_y(Xq)
        except ValueError as e:
            check("order=1 only" in str(e), f"fused='on' raised {e}")
            print(f"  fused='on' on the order-{order} Kzx raises: {e}")
        else:
            check(False, f"fused='on' served an order-{order} Kzx")
        del twin
    grads = gradient_check(T, model, ref, build, X, y)
    per_step = ({"kzz_fwd": 1, "kzz_bwd": 1} if tensors
                else {"seq_fwd": 2, "seq_bwd": 2})
    launches, train = drive_training(T, model, X, y, per_step)
    print(f"  predict_f(full_cov=True), order {order}:")
    full_cov = full_cov_check(T, model, X, k5=1 if tensors else 3)
    return model, pred, dict(kind=kind, order=order,
                             serving_launches=serve_launches,
                             requests=requests, gradient_check=grads,
                             training_launches=launches, training=train,
                             full_cov=full_cov)


def time_order_kernels(sc, ic, Zs, X, ls):
    """Phase 10e: K5 and K6 at orders 1, 2 and 4 (4 levels) at the
    sequences model's Kzz, Kzx and full Kxx, each against its plain
    version, interleaved plain / kernel / kernel / plain, with the bound
    that counts the order's grid (``seq_bound_ms``)."""
    rows = []
    for key, case in (("Kzz", SEQ_KZZ), ("Kzx", SEQ_KZX), ("Kxx", SEQ_KXX)):
        r, ct = seq_inputs(ic, Zs, X, ls, case, torch.float32)
        for order in (1, 2, LEVELS):
            kw = dict(num_levels=LEVELS, base="rbf", difference=True,
                      symmetric=case[4], order=order)
            for name, kern, plain in (
                    ("seq_fwd", lambda: sc.seq_fwd(*r, **kw),
                     lambda: sc.seq_fwd_plain(*r, **kw)),
                    ("seq_bwd", lambda: sc.seq_bwd(*r, ct, **kw),
                     lambda: sc.seq_bwd_plain(*r, ct, **kw))):
                p1, k1, k2, p2 = (time_cuda(plain, reps=5), time_cuda(kern),
                                  time_cuda(kern), time_cuda(plain, reps=5))
                b_ms, b_by = seq_bound_ms(name, case, order=order)
                rows.append(dict(kernel=name, gram=key, order=order,
                                 ms=[k1, k2], plain_ms=[p1, p2],
                                 bound_ms=b_ms, bound_by=b_by))
                print(f"  {name} ({key}, order {order}): kernel {k1:.4f} / "
                      f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# phase 11: the eight bases without a hand kernel (cosine, poly, mix,
# matern32/52, spectral rbf/exp/mixed), as torch ops -- the route the JAX
# package takes for them through XLA (it has no Pallas kernel for them)
# ---------------------------------------------------------------------------

BASES = {  # base: (variant of T.kernels, its keyword arguments)
    "cosine": ("SignatureCosine", {}),
    "poly": ("SignaturePoly", {"degree": 3}),
    "mix": ("SignatureMix", {}),
    "matern32": ("SignatureMatern32", {}),
    "matern52": ("SignatureMatern52", {}),
    "spectral_rbf": ("SignatureSpectral", {"family": "rbf"}),
    "spectral_exp": ("SignatureSpectral", {"family": "exp"}),
    "spectral_mixed": ("SignatureSpectral", {"family": "mixed"}),
}
TRAINED = ("cosine", "poly", "mix", "matern32", "spectral_mixed")  # a family each
SEQ_BASE = "matern32"  # the inducing-sequences model of 11c


def check_no_launch(launches: dict, what: str) -> None:
    check(not any(launches.values()), f"{what} launched a kernel: "
          f"{launches}")


def fused_on_raises(T, base, build, X) -> str:
    """Phase 11d: a ``fused='on'`` twin of the model raises on CUDA tensors
    (no kernel for the base, in JAX as here), naming the kernels' bases."""
    twin = build(torch.float32, "on", "cuda")
    try:
        with torch.no_grad():
            twin.predict_y(torch.as_tensor(X[:2], device="cuda"))
    except ValueError as e:
        check("has no CUDA kernel" in str(e) and "rbf" in str(e),
              f"{base}: fused='on' raised {e}")
        return str(e)
    check(False, f"{base}: fused='on' served without a kernel")


def kzx_f32_error(model, ref, X) -> list:
    """Phase 11a: each level of the normalized Kzx (f32, the closed forms)
    against the f64 path on one minibatch of 50, as max abs over the
    level's largest entry (read, not bounded: the spectral closed form is
    the leg ADVICE.md leaves unmeasured)."""
    xb = X[:BATCH]
    with torch.no_grad():
        got, want = (m.kern.K_tens_n_seq_covs(
            m.ind.Z, torch.as_tensor(xb, dtype=dt, device="cuda"),
            increments=True, return_levels=True)[1]
            for m, dt in ((model, torch.float32), (ref, torch.float64)))
    errs = [float((g.double() - w).abs().max() / w.abs().max().clamp(
        min=1e-300)) for g, w in zip(got, want)]
    print("  Kzx f32 vs f64, each level: " + ", ".join(
        f"{e:.2e}" for e in errs))
    return errs


def drive_base_model(T, ut, X, y, base, kind="tensors"):
    """Phases 11a-11d for one base: the benchmark-width model (500
    incremental inducing tensors, or 500 inducing sequences of length 5)
    through the variant's constructor under ``fused='auto'``, served on the
    six buckets with its means held to the f64 path on the card (torch ops
    there too) at phase 3's bound, no kernel launched, and its Kzx's f32
    error read level by level (``kzx_f32_error``); for the bases in
    ``TRAINED`` and the sequences model, every leaf's gradient held against
    f64 and 30 NAdam steps under the phase-2 mask, no kernel launched; for
    the sequences model, ``predict_f(full_cov=True)`` as phase 3 holds it;
    and a ``fused='on'`` twin raising."""
    model, ref, build = synthetic_setup(ut, T, X, y, kind, fused="auto",
                                        variant=BASES[base],
                                        ref_device="cuda")
    check(model.kern.base == base, f"kernel base {model.kern.base}")
    pred, serve_launches, requests = drive_serving(T, model, ref, X, (),
                                                   ref_device="cuda")
    check_no_launch(serve_launches, f"serving {base}")
    out = dict(base=base, kind=kind, serving_launches=serve_launches,
               requests=requests, fused_on=fused_on_raises(T, base, build, X))
    if kind == "tensors":
        out["kzx_f32_vs_f64"] = kzx_f32_error(model, ref, X)
    print(f"  fused='on' raises: {out['fused_on'][:80]}...")
    if base in TRAINED or kind == "sequences":
        out["gradient_check"] = gradient_check(T, model, ref, build, X, y,
                                               ref_device="cuda")
        launches, out["training"] = drive_training(T, model, X, y, {})
        out["training_launches"] = launches
    del ref
    if kind == "sequences":
        print(f"  predict_f(full_cov=True), {base} sequences:")
        out["full_cov"] = full_cov_check(T, model, X, k5=0)
        check_no_launch(out["full_cov"]["launches"], "the full covariance")
    torch.cuda.empty_cache()
    return model, pred, out


def device_ms(fn, n: int = 1) -> float:
    """Device time of ``fn`` (the sum of its kernels and copies), from
    ``torch.profiler``, per call (the model is warm from its timed steps)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(us for us, _ in _device_kernels(prof).values()) / 1e3 / n


def leg_device_ms(model, X) -> dict:
    """Phase 11e: the device work of each covariance leg of a training step
    on one minibatch of 50, forward and backward under a sum's cotangent:
    Kzz, Kzx and Kxx's diagonal, from the profiler."""
    kern, ind = model.kern, model.ind
    xb = torch.as_tensor(X[:BATCH], device="cuda")
    tensors = hasattr(ind, "increments")

    def leg(which):
        def fn():
            cp = kern.constrain()
            Xs = kern._scale_sequences(cp, xb)
            if tensors:
                Z = kern._scale_tensors(cp, ind.Z)
                out = {"Kzz": lambda: kern._K_tens(cp, Z, True),
                       "Kzx": lambda: kern._K_tens_vs_seq(cp, Z, Xs, True),
                       "Kxx_diag": lambda: kern._K_seq_diag(cp, Xs)}[which]()
            else:
                Zs = kern._scale_sequences(cp, ind.Z)
                out = {"Kzz": lambda: kern._K_seq(cp, Zs),
                       "Kzx": lambda: kern._K_seq(cp, Zs, Xs),
                       "Kxx_diag": lambda: kern._K_seq_diag(cp, Xs)}[which]()
            out.sum().backward()
            model.zero_grad(set_to_none=True)
        return fn

    legs = {name: device_ms(leg(name)) for name in ("Kzz", "Kzx",
                                                    "Kxx_diag")}
    top = max(legs, key=legs.get)
    print("  device work of the covariance legs (fwd + bwd): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in legs.items())
          + f"; the largest: {top}")
    return dict(legs_ms=legs, largest=top)


def serve_and_train_bases(T, ut, X, y) -> dict:
    """Phases 11a-11d: every base without a kernel served through its
    inducing-tensors model (those of ``TRAINED`` trained), then the
    ``SEQ_BASE`` inducing-sequences model."""
    print("phase 11: the eight bases without a hand kernel, as torch ops")
    print("  11a-11b, 11d: the inducing-tensors models")
    models = {}
    for base in BASES:
        print(f"  {base}{' (served and trained)' if base in TRAINED else ''}"
              f" [{time.perf_counter() - T0:.1f} s]:", flush=True)
        models[base] = drive_base_model(T, ut, X, y, base)
    print(f"  11c: the {SEQ_BASE} inducing-sequences model "
          f"[{time.perf_counter() - T0:.1f} s]", flush=True)
    models[f"{SEQ_BASE}_sequences"] = drive_base_model(T, ut, X, y, SEQ_BASE,
                                                       "sequences")
    return models


def time_bases(T, X, y, models, card, serve_train_s) -> dict:
    """Phase 11e: each phase-11 model's request latency per bucket (median
    of 3 after 1 warm-up call), and for the trained ones training steps/s
    (median of 3 after 1 warm-up step) with a profile of one step and the
    device work of each covariance leg: shallower than phase 4, so that
    the script keeps within its time limit (the spectral step takes ~1.5 s
    and dispatches ~35,000 launches)."""
    print(f"phase 11e: times of the eight bases ({card})")
    t0 = time.perf_counter()
    out = {}
    for name, (model, pred, res) in models.items():
        print(f"  {name} [{time.perf_counter() - T0:.1f} s]:", flush=True)
        res = dict(res, request_latency=time_requests(pred, X, reps=3,
                                                       warm=1))
        if "training" in res:
            res["training_time"] = time_training(T, model, X, y, reps=3,
                                                 warm=1, profiled=1)
            res["legs"] = leg_device_ms(model, X)
        out[name] = res
    out["seconds"] = dict(serve_and_train=serve_train_s,
                          times=time.perf_counter() - t0)
    print(f"  phase 11: {serve_train_s:.1f} s served and trained, "
          f"{out['seconds']['times']:.1f} s timed")
    return out


def run_phase11(T, ut, X, y, card) -> dict:
    t0 = time.perf_counter()
    models = serve_and_train_bases(T, ut, X, y)
    return time_bases(T, X, y, models, card, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 12: low-rank features (Nystrom features and randomized Hadamard
# products, ops/low_rank.py: torch ops, as the JAX package runs them through
# XLA) and the rest of the model API (Gaussian regression with a mean
# function, predict_f_samples)
# ---------------------------------------------------------------------------

# 12a: the recipe's defaults (num_components = rank_bound = 50) give
# features of rank <= 1 + 50 + 3 * 50 = 201, below 500 inducing tensors:
# Kzz is singular up to its jitter and JAX's float32 loss is NaN there.
# Only these two are raised from the defaults, so the rank (<= 701) passes
# 500.
LOW_RANK = dict(low_rank=True, num_components=100, rank_bound=200)
# 12b: exact features (no projection, so no eigenvector sign enters a
# Gram) of 8 components: 8, 64 and 512 features at levels 1-3
EXACT_LEVELS, EXACT_COMPONENTS, EXACT_IND = 3, 8, 100
LR_RECIPE_IND = 150  # 12c: fits the recipe's default rank, 201
# 12d: examples/low_rank_long_sequences.py's configuration
LONG_N, LONG_L, LONG_D, LONG_M = 10_000, 1_000, 3, 3
LONG_C, LONG_RB, LONG_CHUNKS, LONG_BLOCK = 96, 128, 4, 256
SAMPLES, SAMPLE_SE = 4096, 5.0  # 12e: predict_f_samples' moments


def lr_draws(model, X, seed):
    """A low-rank model's draws (float32, on the card) for its covariance
    call on the sequences X: landmarks among the union of its inducing
    tensors' and X's points."""
    n_points = model.ind.Z.numel() // model.ind.Z.shape[-1] + (
        X.shape[0] * X.shape[1])
    return model.kern._lr_draws(torch.Generator("cuda").manual_seed(seed),
                                n_points, torch.zeros(1, device="cuda"))


def same_draws_check(model, X) -> dict:
    """12a: two covariance calls with generators seeded alike give
    bit-identical Grams, as do two calls with none (seed 0), and another
    seed another Gram."""
    xb = torch.as_tensor(X[:BATCH], device="cuda")

    def covs(seed):
        gen = None if seed is None else torch.Generator(
            "cuda").manual_seed(seed)
        with torch.no_grad():
            return model.kern.K_tens_n_seq_covs(
                model.ind.Z, xb, increments=True, return_levels=True,
                generator=gen)

    a, b, c, d = covs(SEED + 5), covs(SEED + 5), covs(None), covs(None)
    same = (all(torch.equal(u, v) for u, v in zip(a, b))
            and all(torch.equal(u, v) for u, v in zip(c, d)))
    differ = not torch.equal(a[1], c[1])
    print(f"  same generator, same Grams bit for bit: {same}; another "
          f"seed, another Gram: {differ}")
    check(same, "two calls with the same draws gave different Grams")
    check(differ, "two seeds gave the same Kzx")
    return dict(bit_identical=same, seeds_differ=differ)


def drive_low_rank_model(T, ut, X, y):
    """12a: the low-rank tensors model (``LOW_RANK``) at the benchmark
    width, served on the six buckets, its repeated draws bit-identical;
    (12b) its low levels held against f64 before it trains; then 30 steps
    under the phase-2 mask; no kernel launched."""
    model, ref, build = synthetic_setup(
        ut, T, X, y, "tensors", fused="auto",
        variant=("SignatureRBF", LOW_RANK), ref_device="cuda")
    check(model.kern.low_rank, "the model's kernel is not low-rank")
    pred, launches, requests = drive_serving(T, model, None, X, ())
    check_no_launch(launches, "serving the low-rank model")
    draws = same_draws_check(model, X)
    print("  12b: levels 0-1 of the 12a model against f64")
    low_levels = low_levels_check(model, ref, X)
    del ref
    train_launches, train = drive_training(T, model, X, y, {})
    out = dict(serving_launches=launches, requests=requests, draws=draws,
               low_levels=low_levels, training_launches=train_launches,
               training=train)
    return model, pred, out


def low_levels_check(model, ref, X) -> list:
    """12b: levels 0 and 1 of Kzz, Kzx and the full Kxx of the 12a model
    (f32, the card) against its f64 path on the same draws: they depend on
    the Nystrom features alone, not on an eigenvector's sign.  Each level
    within MEAN_BOUND of max(its scale, 1)."""
    xb = torch.as_tensor(X[:BATCH], device="cuda")
    draws = lr_draws(model, xb, SEED + 6)
    with torch.no_grad():
        got = model.kern.K_tens_n_seq_covs(
            model.ind.Z, xb, full_X_cov=True, increments=True,
            return_levels=True, generator=draws)
        want = ref.kern.K_tens_n_seq_covs(
            ref.ind.Z, xb.double(), full_X_cov=True, increments=True,
            return_levels=True, generator=draws.to(dtype=torch.float64))
    rows = []
    for name, g, w in zip(("Kzz", "Kzx", "Kxx"), got, want):
        for lvl in (0, 1):
            scale = max(float(w[lvl].abs().max()), 1.0)
            err = float((g[lvl].double() - w[lvl]).abs().max()) / scale
            rows.append(dict(gram=name, level=lvl, err=err, scale=scale))
            print(f"  {name} level {lvl}: f32 vs f64 {err:.3e} of "
                  f"max(scale, 1) = {scale:.3e}")
            check(err <= MEAN_BOUND, f"{name} level {lvl} off f64 by {err}")
    return rows


def exact_setup(ut, T, X, y):
    """12b: ``EXACT_IND`` incremental inducing tensors, M = EXACT_LEVELS,
    exact low-rank features of ``EXACT_COMPONENTS`` components (d=14,
    L=93, C=10), weights from the seed; the f32 model on the card, its f64
    twin there too (torch ops) and ``build``."""
    rng = np.random.RandomState(SEED + 7)
    Z = ut.suggest_initial_inducing_tensors(
        X, EXACT_LEVELS, EXACT_IND, labels=y, increments=True, seed=SEED)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    tree = None

    def build(dtype, fused, device):
        kern = T.kernels.SignatureRBF(
            D, EXACT_LEVELS, lengthscales=ls, low_rank=True,
            num_components=EXACT_COMPONENTS, sparsity="exact", fused=fused,
            dtype=dtype, device=device)
        ind = T.InducingTensors(Z, EXACT_LEVELS, increments=True,
                                dtype=dtype, device=device)
        model = T.SVGP(kern, ind, T.likelihoods.MultiClass(C), num_latent=C,
                       num_data=N_TRAIN, device=device)
        if tree is not None:
            T.convert.load_jax_params(model, tree)
        return model

    model = build(torch.float32, "auto", "cuda")
    tree = T.convert.to_numpy_tree(model)
    tree["q_mu"] = rng.randn(EXACT_IND, C) * 0.5
    tree["q_sqrt"] = (np.tril(rng.randn(C, EXACT_IND, EXACT_IND)) * 0.02
                      + 0.5 * np.eye(EXACT_IND)[None])
    T.convert.load_jax_params(model, tree)
    return model, build(torch.float64, "auto", "cuda"), build


def exact_model_check(T, ut, X, y) -> dict:
    """12b: the exact-feature model, f32 on the card against its f64 path
    on the same draws: the loss within GRAD_BOUND relative, every leaf's
    gradient as phase 5 holds it, and the predictive means of one
    minibatch as phase 3 holds them."""
    model, ref, build = exact_setup(ut, T, X, y)
    idx = next(T.training.MinibatchStream(N_TRAIN, BATCH, seed_or_rng=SEED))
    xb = torch.as_tensor(X[idx], device="cuda")
    draws = lr_draws(model, xb, SEED + 8)
    grads = gradient_check(T, model, ref, build, X, y, ref_device="cuda",
                           draws=draws)
    loss_err = abs(grads["loss_card"] - grads["loss_f64_cpu"]) / abs(
        grads["loss_f64_cpu"])
    with torch.no_grad():
        got = model.predict_y(xb, generator=draws)[0].double()
        want = ref.predict_y(xb.double(), generator=draws.to(
            dtype=torch.float64))[0]
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * MEAN_BOUND
    same = torch.argmax(got, 1) == torch.argmax(want, 1)
    print(f"  exact features: loss f32 vs f64 {loss_err:.3e} relative; "
          f"means {err:.3e}; argmax agree {int(same.sum())}/{BATCH}")
    check(loss_err <= GRAD_BOUND, f"exact model: loss off f64 by {loss_err}")
    check(err <= MEAN_BOUND, f"exact model: means off f64 by {err}")
    check(bool(same[decided].all()), "exact model: argmax differs from f64")
    return dict(gradient_check=grads, loss_rel_err=loss_err, mean_err=err,
                argmax_agree=int(same.sum()))


def long_sequences(T) -> dict:
    """12d: examples/low_rank_long_sequences.py through the port: low-rank
    factors of N=10,000 random walks of L=1,000 steps (d=3, M=3, 96
    components, rank bound 128) in 4 chunks of examples that share the
    landmarks (96 of 64 walks' points, among the scaled points as the
    kernel draws them) and every projection; the factor time (a second,
    synchronized pass) and the implied Gram entries per second; then the
    normalized low-rank Gram of the first 256 walks against the exact one,
    ``K_blocked(method='pallas')`` (K5): max and mean error, no bound
    (random walks are that example's stated worst case)."""
    g = torch.Generator("cuda").manual_seed(SEED)
    X = torch.cumsum(torch.randn((LONG_N, LONG_L, LONG_D), generator=g,
                                 device="cuda"), dim=1) / np.sqrt(LONG_L)
    ls = np.ones(LONG_D) * np.sqrt(LONG_D)
    kern = T.kernels.SignatureRBF(
        LONG_D, LONG_M, low_rank=True, num_components=LONG_C,
        rank_bound=LONG_RB, lengthscales=ls, device="cuda")
    with torch.no_grad():
        cp = kern.constrain()
        flat = kern._scale_sequences(cp, X[::LONG_N // 64]).reshape(
            -1, LONG_D)
        landmarks = flat[torch.randperm(flat.shape[0], generator=g,
                                        device="cuda")[:LONG_C]]
        draws = T.ops.low_rank.draw_low_rank(
            g, None, num_components=LONG_C, rank_bound=LONG_RB,
            num_levels=LONG_M, sparsity=kern.sparsity, dtype=torch.float32)
        fmap = kern._lr_feature_map(cp, landmarks, draws)

        def factors():
            parts = [kern._K_seq_lr_feat(kern._scale_sequences(cp, c), fmap,
                                         draws)
                     for c in X.chunk(LONG_CHUNKS)]
            return [torch.cat([p[m] for p in parts])
                    for m in range(LONG_M + 1)]

        factors()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        phis = factors()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        sub = [p[:LONG_BLOCK] for p in phis]
        lvls = torch.stack([p @ p.T for p in sub])
        dsq = torch.sqrt(torch.diagonal(lvls, dim1=1, dim2=2) + 1e-6)
        K_lr = (lvls / (dsq[:, :, None] * dsq[:, None, :])).sum(0)
        exact_kern = T.kernels.SignatureRBF(LONG_D, LONG_M, lengthscales=ls,
                                            device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        exact = exact_kern.K_blocked(X[:LONG_BLOCK], method="pallas")
        torch.cuda.synchronize()
        exact_s = time.perf_counter() - t0
        k5 = read_counts()["seq_fwd"]
        err = (K_lr - exact).abs()
    shapes = [tuple(p.shape) for p in phis]
    out = dict(factor_s=seconds, entries_per_s=LONG_N ** 2 / seconds,
               shapes=shapes, peak_gb=peak_gb, exact_s=exact_s,
               k5_launches=k5, max_err=float(err.max()),
               mean_err=float(err.mean()))
    print(f"  factors {shapes} in {seconds:.3f} s ({out['entries_per_s']:.3e}"
          f" implied Gram entries/s), peak {peak_gb:.2f} GiB; exact "
          f"{LONG_BLOCK}x{LONG_BLOCK} Gram by K5 ({k5} launches) in "
          f"{exact_s:.3f} s; normalized low-rank vs exact: max err "
          f"{out['max_err']:.3f}, mean err {out['mean_err']:.3f}")
    check(all(bool(torch.isfinite(p).all()) for p in phis),
          "non-finite long-sequence factors")
    check(k5 > 0, "the exact Gram did not launch K5")
    return out


def regression_targets(X):
    """12e: a smooth function of each sequence plus noise, from the seed."""
    rng = np.random.RandomState(SEED + 9)
    drift = X[:, :, :3].sum(axis=(1, 2)) / np.sqrt(3 * X.shape[1])
    y = np.tanh(drift) + 0.5 * np.sin(X[:, -1, 0])
    return (y + 0.1 * rng.randn(len(X))).astype(np.float32)


def gaussian_setup(ut, T, X, Yr):
    """12e: Gaussian regression at the benchmark width: 500 incremental
    inducing tensors (K1-K4 under ``fused='on'``), a ``Linear`` mean
    function of the flattened (93 x 14) sequences, a trainable noise
    variance, weights from the seed; the f64 twin on the card runs the
    reference graphs (``fused='off'``, torch ops)."""
    rng = np.random.RandomState(SEED + 10)
    Z = ut.suggest_initial_inducing_tensors(X, LEVELS, N_IND,
                                            increments=True, seed=SEED)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    tree = None

    def build(dtype, fused, device):
        at = dict(dtype=dtype, device=device)
        model = T.SVGP(
            T.kernels.SignatureRBF(D, LEVELS, lengthscales=ls, fused=fused,
                                   **at),
            T.InducingTensors(Z, LEVELS, increments=True, **at),
            T.likelihoods.Gaussian(0.5, trainable=True, **at), num_latent=1,
            num_data=N_TRAIN,
            mean_function=T.mean_functions.Linear(L * D, **at),
            device=device)
        if tree is not None:
            T.convert.load_jax_params(model, tree)
        return model

    model = build(torch.float32, "on", "cuda")
    tree = T.convert.to_numpy_tree(model)
    tree["q_mu"] = rng.randn(N_IND, 1) * 0.5
    tree["q_sqrt"] = (np.tril(rng.randn(1, N_IND, N_IND)) * 0.02
                      + 0.5 * np.eye(N_IND)[None])
    tree["mean"]["A"] = rng.randn(L * D, 1) * 0.01
    tree["mean"]["b"] = np.array([0.1])
    T.convert.load_jax_params(model, tree)
    return model, build(torch.float64, "off", "cuda"), build


def samples_check(T, model, X) -> dict:
    """12e: ``predict_f_samples`` of S = 4,096 at one minibatch: shape
    (S, N, 1); the samples' mean and variance within 5 standard errors of
    ``predict_f``'s, and with ``full_cov`` their covariance within 5 of
    the jittered predictive covariance, entry by entry."""
    xb = torch.as_tensor(X[:BATCH], device="cuda")
    g = torch.Generator("cuda").manual_seed(SEED + 11)
    with torch.no_grad():
        mean, var = (t.double()[:, 0] for t in model.predict_f(xb))
        s = model.predict_f_samples(xb, num_samples=SAMPLES, generator=g)
        fmean, fcov = model.predict_f(xb, full_cov=True)
        sf = model.predict_f_samples(xb, num_samples=SAMPLES, generator=g,
                                     full_cov=True)
    check(tuple(s.shape) == (SAMPLES, BATCH, 1) == tuple(sf.shape),
          f"sample shapes {tuple(s.shape)}, {tuple(sf.shape)}")
    s, sf = s.double()[:, :, 0], sf.double()[:, :, 0]
    z_mean = float(((s.mean(0) - mean).abs()
                    / torch.sqrt(var / SAMPLES)).max())
    z_var = float(((s.var(0) - var).abs() / (
        var * np.sqrt(2.0 / (SAMPLES - 1)))).max())
    cov = fcov[0].double() + T.config.jitter() * torch.eye(
        BATCH, dtype=torch.float64, device="cuda")
    sd = torch.diagonal(cov)
    z_fmean = float(((sf.mean(0) - fmean[:, 0].double()).abs()
                     / torch.sqrt(sd / SAMPLES)).max())
    se = torch.sqrt((sd[:, None] * sd[None, :] + cov ** 2) / SAMPLES)
    z_cov = float(((torch.cov(sf.T) - cov).abs() / se).max())
    print(f"  predict_f_samples (S={SAMPLES}): mean {z_mean:.2f} SE, "
          f"variance {z_var:.2f} SE; full_cov: mean {z_fmean:.2f} SE, "
          f"covariance {z_cov:.2f} SE (largest over entries)")
    for what, z in (("mean", z_mean), ("variance", z_var),
                    ("full_cov mean", z_fmean), ("covariance", z_cov)):
        check(z <= SAMPLE_SE, f"sample {what} {z} standard errors off")
    return dict(z_mean=z_mean, z_var=z_var, z_full_mean=z_fmean,
                z_cov=z_cov)


def drive_gaussian_model(T, ut, X):
    """12e: the Gaussian regression model served (one length bucket, 93:
    the mean function takes 93 x 14 inputs), every leaf's gradient held
    against f64 (``lik/variance`` and ``mean/*`` among them), 30 steps
    with K1-K4 once a step, and ``predict_f_samples``."""
    Yr = regression_targets(X)
    model, ref, build = gaussian_setup(ut, T, X, Yr)
    pred, launches, requests = drive_serving(
        T, model, ref, X, ("kzz_fwd", "kzx_fwd"), same_bucket=True,
        ref_device="cuda", len_buckets=(L,), regression=True)
    grads = gradient_check(T, model, ref, build, X, Yr, ref_device="cuda")
    del ref
    check({"lik/variance", "mean/A", "mean/b"} <= {
        r["leaf"] for r in grads["leaves"]}, "a Gaussian leaf is missing")
    train_launches, train = drive_training(
        T, model, X, Yr, dict.fromkeys(("kzz_fwd", "kzx_fwd", "kzz_bwd",
                                        "kzx_bwd"), 1))
    out = dict(serving_launches=launches, requests=requests,
               gradient_check=grads, training_launches=train_launches,
               training=train, samples=samples_check(T, model, X))
    return model, pred, Yr, out


def run_phase12(T, ut, X, y):
    """Phases 12a-12e; returns the models 12f times and the details."""
    t0 = time.perf_counter()
    print("phase 12: low-rank features and the rest of the model API")
    print("  12a: the low-rank tensors model "
          f"(num_components={LOW_RANK['num_components']}, "
          f"rank_bound={LOW_RANK['rank_bound']})", flush=True)
    lr_model, lr_pred, lr = drive_low_rank_model(T, ut, X, y)
    print("  12b: the exact-feature model "
          f"[{time.perf_counter() - T0:.1f} s]", flush=True)
    exact = exact_model_check(T, ut, X, y)
    print(f"  12c: the recipe with low_rank=True, {LR_RECIPE_IND} inducing "
          f"tensors [{time.perf_counter() - T0:.1f} s]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        recipe = [drive_recipe(T, Path(tmp), c, low_rank=True,
                               num_inducing=LR_RECIPE_IND) for c in (C, 2)]
    print("  12d: examples/low_rank_long_sequences.py's configuration "
          f"[{time.perf_counter() - T0:.1f} s]", flush=True)
    long_seq = long_sequences(T)
    torch.cuda.empty_cache()
    print("  12e: Gaussian regression with a Linear mean function "
          f"[{time.perf_counter() - T0:.1f} s]", flush=True)
    g_model, g_pred, Yr, gauss = drive_gaussian_model(T, ut, X)
    details = dict(low_rank=lr, exact=exact, recipe=recipe,
                   long_sequences=long_seq, gaussian=gauss,
                   seconds=dict(checks=time.perf_counter() - t0))
    return (lr_model, lr_pred, g_model, g_pred, Yr), details


def time_phase12(T, X, y, models, details, card) -> dict:
    """12f: request latency (median of 5 a bucket) and training steps/s
    (median of 5 steps, one profiled: device ms, launches, busy share) of
    the 12a and 12e models, as phase 11e measures them."""
    print(f"phase 12f: times of the low-rank and Gaussian models ({card})")
    t0 = time.perf_counter()
    lr_model, lr_pred, g_model, g_pred, Yr = models
    print("  low-rank tensors model:")
    details["low_rank"].update(
        request_latency=time_requests(lr_pred, X, reps=5, warm=1),
        training_time=time_training(T, lr_model, X, y, reps=5, warm=2,
                                    profiled=1))
    print("  Gaussian regression model:")
    details["gaussian"].update(
        request_latency=time_requests(g_pred, X, reps=5, warm=1,
                                      len_buckets=(L,)),
        training_time=time_training(T, g_model, X, Yr, reps=5, warm=2,
                                    profiled=1))
    details["seconds"]["times"] = time.perf_counter() - t0
    print(f"  phase 12: {details['seconds']['checks']:.1f} s checked, "
          f"{details['seconds']['times']:.1f} s timed")
    return details


def main() -> None:
    # phase 1: device and build
    check(torch.cuda.is_available(), "CUDA is not available")
    import gpsig_tpu_torch as T
    check(Path(T.__file__).resolve().parents[1] == ROOT,
          f"gpsig_tpu_torch was imported from {T.__file__}, not from this "
          "checkout")
    from gpsig_tpu_torch import utils as ut
    from gpsig_tpu_torch.ops import _cuda_build
    from gpsig_tpu_torch.ops import inducing_cuda as ic
    from gpsig_tpu_torch.ops import signature_cuda as sc

    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card)
    if "--kernel-times" in sys.argv[1:]:
        # phase 1 (the main library) and phase 4a alone: a quick comparison
        # of two checkouts, each run with its own copy of this script
        (lib, build_s), = build_libraries(_cuda_build, levels=(),
                                          orders=()).values()
        print(f"phase 1: built {lib.path.parent.name} in {build_s:.1f} s")
        print(f"phase 4a: kernel times ({card})")
        rows = time_kernels(ic, ut, synthetic_data()[0])
        print(json.dumps({"card": card, "kernel_times": rows}))
        return
    if "--bases" in sys.argv[1:]:
        # phase 11 alone (it builds no kernel): a quick run of the eight
        # bases without one; the details go to build/chip_smoke_bases.json
        X, y = synthetic_data()
        bases = run_phase11(T, ut, X, y, card)
        out_dir = ROOT / "build"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_bases.json").write_text(
            json.dumps(dict(card=card, bases=bases), indent=1))
        print(json.dumps({"card": card, "seconds": bases["seconds"]}))
        return
    if "--low-rank" in sys.argv[1:]:
        # phase 12 alone, with the main library (K1-K5 in 12d and 12e);
        # the details go to build/chip_smoke_low_rank.json
        (lib, build_s), = build_libraries(_cuda_build, levels=(),
                                          orders=()).values()
        print(f"phase 1: built {lib.path.parent.name} in {build_s:.1f} s")
        X, y = synthetic_data()
        models, low_rank = run_phase12(T, ut, X, y)
        low_rank = time_phase12(T, X, y, models, low_rank, card)
        check("jax" not in sys.modules, "something imported jax")
        out_dir = ROOT / "build"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_low_rank.json").write_text(json.dumps(
            dict(card=card, build_s=build_s, low_rank=low_rank), indent=1))
        print(json.dumps({"card": card, "build_s": build_s,
                          "seconds": time.perf_counter() - T0}))
        return
    libs = build_libraries(_cuda_build)
    lib, build_s = libs[1]
    ptxas = {m: ptxas_summary(libs[m][0].ptxas_report) for m in libs}
    print(f"phase 1: built {lib.path.parent.name} (1-8 levels) in "
          f"{build_s:.1f} s, " + ", ".join(
              f"{libs[m][0].path.parent.name} ({m} levels) in "
              f"{libs[m][1]:.1f} s" for m in LEVEL_LIBS)
          + ", " + ", ".join(f"{libs[k][0].path.parent.name} (order {k[1]})"
                             for k in ORDER_LIBS)
          + f", at once; ptxas, K1, K2, K3 and K5 at {LEVELS} levels:")
    print_ptxas(ptxas[1], lambda r: r["args"][:1] == [LEVELS]
                and r["args"][-1] == 0 and (
                    r["kernel"].startswith(("kzz", "kzx_fwd"))
                    or r["kernel"] == "seq_fwd_kernel"))
    print(f"  every matern12 instance at {LEVELS} levels:")
    print_ptxas(ptxas[1], lambda r: r["args"][:1] == [LEVELS]
                and r["args"][-1] == 1 and len(r["args"]) > 1)
    print(f"  every kernel at {EXTRA_LEVELS} levels:")
    print_ptxas(ptxas[EXTRA_LEVELS], lambda r: True)
    print(f"  K3 at {WIDE_LEVELS} levels:")
    print_ptxas(ptxas[WIDE_LEVELS], lambda r: r["kernel"].startswith("kzx_fwd"))
    print(f"  every kernel at {MANY_LEVELS} levels:")
    print_ptxas(ptxas[MANY_LEVELS], lambda r: True)
    for key in ORDER_LIBS:
        print(f"  K5 and K6 at {key[0]} levels, order {key[1]} "
              f"({libs[key][0].path.parent.name}, built in "
              f"{libs[key][1]:.1f} s):")
        print_ptxas(ptxas[key], lambda r: True)

    print("set-up: benchmark-width models from the seed")
    X, y = synthetic_data()
    model, ref, build = synthetic_setup(ut, T, X, y, "tensors")
    smodel, sref, sbuild = synthetic_setup(ut, T, X, y, "sequences")
    Zs = T.convert.to_numpy_tree(sref)["ind"]["Z"]
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    print("phase 2: kernels against their plain versions")
    checks = (kernel_checks(ic, ut, X) + seq_kernel_checks(sc, ic, Zs, X, ls)
              + many_examples_checks(ic, ut, X) + extra_levels_checks(ic, sc))
    expm1 = expm1_checks(sc)
    checks += wide_checks(ic, sc)
    fused_kzz = fused_kzz_check(T, ic, ut, X)
    print(f"phase 2h: K1-K6 at the lagged width (num_lags={LAGS}, "
          f"d2 = {D_LAG2})")
    checks += lagged_kernel_checks(T, ic, ut, X, y)
    print("phase 3: serving, inducing tensors")
    pred, serve_launches, requests = drive_serving(
        T, model, ref, X, ("kzz_fwd", "kzx_fwd"))
    full_cov = full_cov_check(T, model, X)
    print("phase 5: training, inducing tensors")
    grads = gradient_check(T, model, ref, build, X, y)
    train_launches, train = drive_training(
        T, model, X, y, dict.fromkeys(("kzz_fwd", "kzx_fwd", "kzz_bwd",
                                       "kzx_bwd"), 1))
    print("phase 6: serving and training, inducing sequences")
    spred, s_serve_launches, s_requests = drive_serving(
        T, smodel, sref, X, ("seq_fwd",))
    s_grads = gradient_check(T, smodel, sref, sbuild, X, y)
    # K5 and K6 twice a step: Kzz and Kzx
    s_train_launches, s_train = drive_training(
        T, smodel, X, y, {"seq_fwd": 2, "seq_bwd": 2})
    print(f"phase 7: the benchmark-width model with num_lags={LAGS}, "
          "MultiClass and Bernoulli")
    lmodel, lbuild, lagged = drive_lagged_model(T, ut, X, y, C)
    print("  Bernoulli (C=2, one latent):")
    lagged_bern = drive_lagged_model(T, ut, X, y % 2, 2)[2]
    print("phase 8: the recipe on the card, then kill-and-resume")
    with tempfile.TemporaryDirectory() as tmp:
        recipe = [drive_recipe(T, Path(tmp), c) for c in (C, 2)]
        resume = kill_and_resume(T, lbuild, X, y, Path(tmp))
    print("phase 9: the matern12 base (SignatureMatern12)")
    print("  9a: K1-K6 under matern12 against their plain versions")
    m12_probe = m12_probe_check(sc)
    m12_checks = m12_kernel_checks(ic, sc, ut, X, Zs, ls)
    print("  9b-9c: the tensors model, served and trained")
    m12_model, m12_pred, m12_tensors = drive_m12_model(T, ut, X, y,
                                                       "tensors")
    print("  9d: the inducing-sequences model, served and trained")
    m12_smodel, m12_spred, m12_sequences = drive_m12_model(T, ut, X, y,
                                                           "sequences")
    print("  9e: predict_f(full_cov=True) on the tensors model")
    m12_full_cov = full_cov_check(T, m12_model, X, bound=KINK_FWD)
    print("phase 10: order > 1 (the (order x order) grid in K5/K6)")
    print("  10a: K5/K6 at orders 2, 4 (4 levels) and 3 (9 levels) against "
          "their plain versions")
    order_checks = order_kernel_checks(sc, ic, Zs, X, ls)
    print("  10b: the order-2 inducing-sequences model")
    o2_smodel, o2_spred, o2_sequences = drive_order_model(
        T, ut, X, y, "sequences", 2)
    print("  10c: the order-2 inducing-tensors model")
    o2_model, o2_pred, o2_tensors = drive_order_model(T, ut, X, y,
                                                      "tensors", 2)
    print(f"  10d: the order-{LEVELS} (full grid) inducing-sequences model")
    o4_smodel, o4_spred, o4_sequences = drive_order_model(
        T, ut, X, y, "sequences", LEVELS)
    t11 = time.perf_counter()
    base_models = serve_and_train_bases(T, ut, X, y)
    t11 = time.perf_counter() - t11
    low_rank_models, low_rank = run_phase12(T, ut, X, y)
    print(f"phase 4: times ({card})")
    ktimes = (time_kernels(ic, ut, X) + time_seq_kernels(sc, ic, Zs, X, ls)
              + time_extra_levels(ic, sc))
    latency = time_requests(pred, X, reps=5, warm=1)
    train_time = time_training(T, model, X, y, reps=10, warm=3, profiled=2)
    print("  inducing sequences:")
    s_latency = time_requests(spred, X, reps=5, warm=1)
    s_train_time = time_training(T, smodel, X, y, reps=10, warm=3,
                                 profiled=2)
    print(f"  lagged width (num_lags={LAGS}, d2 = {D_LAG2}):")
    lag_times = time_lagged_kernels(T, ic, ut, X, y)
    lag_train_time = time_training(T, lmodel, X, y, reps=10, warm=3,
                                   profiled=2)
    print(f"phase 9f: matern12 times ({card})")
    m12_times = time_m12_kernels(ic, sc, ut, X, Zs, ls)
    m12_latency = time_requests(m12_pred, X, reps=5, warm=1)
    m12_train_time = time_training(T, m12_model, X, y, reps=5, warm=2,
                                   profiled=1)
    print("  matern12, inducing sequences:")
    m12_s_latency = time_requests(m12_spred, X, reps=5, warm=1)
    m12_s_train_time = time_training(T, m12_smodel, X, y, reps=5, warm=2,
                                     profiled=1)
    print(f"phase 10e: order > 1 times ({card})")
    order_times = time_order_kernels(sc, ic, Zs, X, ls)
    order_models = {}
    for name, (mdl, prd, res) in {
            "order2_sequences": (o2_smodel, o2_spred, o2_sequences),
            "order2_tensors": (o2_model, o2_pred, o2_tensors),
            f"order{LEVELS}_sequences": (o4_smodel, o4_spred,
                                         o4_sequences)}.items():
        print(f"  {name}:")
        order_models[name] = dict(
            res, request_latency=time_requests(prd, X, reps=5, warm=1),
            training_time=time_training(T, mdl, X, y, reps=5, warm=2,
                                        profiled=1))
    bases = time_bases(T, X, y, base_models, card, t11)
    low_rank = time_phase12(T, X, y, low_rank_models, low_rank, card)
    check("jax" not in sys.modules, "something imported jax")

    kernels = []
    for name, (_, src, replaces) in KERNELS.items():
        if name.startswith("seq"):  # at the Kzx shape of a training step
            t = next(r for r in ktimes if r["kernel"] == name
                     and r.get("N2") == BATCH and r["N1"] == N_IND
                     and r["L2"] == L)
            launches = s_train_launches[name]
        else:  # K1 and K2 in the main path's symmetric mode
            t = next(r for r in ktimes if r["kernel"] == name
                     and r.get("N") == BATCH
                     and r.get("symmetric") == name.startswith("kzz"))
            launches = train_launches[name]
        # at the lagged width: K5/K6 at the sequences model's Kzx shape
        lt = next(r for r in lag_times if r["kernel"] == name
                  and r.get("gram", "Kzx") == "Kzx")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["err_vs_plain_f32"] for r in checks
                            if r["kernel"] == name),
            ms=float(np.mean(t["ms"])), plain_ms=float(np.mean(t["plain_ms"])),
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            lagged=dict(d2=D_LAG2, ms=float(np.mean(lt["ms"])),
                        plain_ms=float(np.mean(lt["plain_ms"])),
                        bound_ms=lt["bound_ms"], bound_by=lt["bound_by"],
                        launches=lagged["training_launches"][name])))
    for name, (_, src, replaces) in KERNELS.items():
        # matern12: K1-K4 on the tensors model, K5/K6 at the sequences
        # model's Kzx shape, with the launches of their training runs
        if name.startswith("seq"):
            t = next(r for r in m12_times if r["kernel"] == name
                     and r["gram"] == "Kzx")
            launches = m12_sequences["training_launches"][name]
        else:
            t = next(r for r in m12_times if r["kernel"] == name)
            launches = m12_tensors["training_launches"][name]
        kernels.append(dict(
            name=f"{name} (matern12)", route="cuda", source=src,
            replaces=replaces, launches=launches,
            max_abs_err=max(r["err_vs_plain_f32"] for r in m12_checks
                            if r["kernel"] == name),
            ms=float(np.mean(t["ms"])), plain_ms=float(np.mean(t["plain_ms"])),
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))
    for order, res in ((2, o2_sequences), (LEVELS, o4_sequences)):
        # at the sequences model's Kzx shape, with its training launches
        for name in ("seq_fwd", "seq_bwd"):
            _, src, replaces = KERNELS[name]
            t = next(r for r in order_times if r["kernel"] == name
                     and r["gram"] == "Kzx" and r["order"] == order)
            kernels.append(dict(
                name=f"{name} (order {order})", route="cuda", source=src,
                replaces=replaces, launches=res["training_launches"][name],
                max_abs_err=max(r["err_vs_plain_f32"] for r in order_checks
                                if r["kernel"] == name
                                and r["order"] == order),
                ms=float(np.mean(t["ms"])),
                plain_ms=float(np.mean(t["plain_ms"])),
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None))
    details = dict(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   build_levels_s={str(m): libs[m][1]
                                   for m in (*LEVEL_LIBS, *ORDER_LIBS)},
                   ptxas=lib.ptxas_report,
                   ptxas_levels={str(m): libs[m][0].ptxas_report
                                 for m in (*LEVEL_LIBS, *ORDER_LIBS)},
                   ptxas_summary={str(k): v for k, v in ptxas.items()},
                   kernel_checks=checks,
                   expm1=expm1, fused_kzz=fused_kzz,
                   serving_launches=serve_launches, requests=requests,
                   full_cov=full_cov, gradient_check=grads,
                   training_launches=train_launches, training=train,
                   sequences=dict(
                       serving_launches=s_serve_launches,
                       requests=s_requests, gradient_check=s_grads,
                       training_launches=s_train_launches, training=s_train,
                       request_latency=s_latency, training_time=s_train_time),
                   lagged=dict(lagged, kernel_times=lag_times,
                               training_time=lag_train_time),
                   lagged_bernoulli=lagged_bern, recipe=recipe,
                   kill_and_resume=resume,
                   matern12=dict(
                       probe=m12_probe, kernel_checks=m12_checks,
                       tensors=dict(m12_tensors, full_cov=m12_full_cov,
                                    request_latency=m12_latency,
                                    training_time=m12_train_time),
                       sequences=dict(m12_sequences,
                                      request_latency=m12_s_latency,
                                      training_time=m12_s_train_time),
                       kernel_times=m12_times),
                   orders=dict(kernel_checks=order_checks,
                               kernel_times=order_times, **order_models),
                   bases=bases, low_rank=low_rank,
                   kernel_times=ktimes, request_latency=latency,
                   training_time=train_time, kernels=kernels,
                   seconds=time.perf_counter() - T0)
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
