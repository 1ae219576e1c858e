#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gpsig_tpu_torch``) on one GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: require CUDA, print versions and the card's name and power
   limit, build the hand-written kernels from ``gpsig_tpu_torch/csrc`` and
   print the ptxas report (registers, shared memory, spills);
2. kernels: K1 (Kzz) and K3 (Kzx) on the card at the benchmark shape
   (lt=10, nZ=500, d=14, N=32 and 50, L=93) and at ragged shapes, each held
   against its plain PyTorch version at f32 (<= 1e-5 * max(scale, 1)) and
   at f64 (<= 1e-4 * max(scale, 1)); K2 and K4, their backward kernels,
   under a random cotangent at the same shapes against their plain
   versions at f32 and f64 (<= 1e-4 * max(scale, 1): the gradients sum
   many more terms in another order); K5 (seq x seq) and K6 (its backward)
   under the same bounds at the shapes of the inducing-sequences model --
   500 sequences of length 5 (symmetric), 500 x 50 at 5 vs 93 steps, 50 at
   93 (symmetric) -- and ragged 7 x 5 at 11 vs 18 (rbf and linear,
   difference on and off); symmetric outputs must be exactly symmetric;
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
4. times: the six kernels against their plain versions with CUDA events,
   interleaved plain / kernel / kernel / plain; request latency per
   bucket and training steps/s (median of 20 synchronized steps after 5
   warm-up steps) with a ``torch.profiler`` breakdown of a step, for both
   models.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
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
# H100 SXM: f32 outside the tensor cores, HBM3 (NVIDIA's data sheet)
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
LEN_IND = LEVELS + 1  # inducing sequences of the recipe (train_gpsig.py:76-80)
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


def synthetic_setup(ut, T, X, y, kind: str):
    """Benchmark-width SVGP with parameters from a numpy seed: the ported
    heuristics on the synthetic data -- 500 incremental inducing tensors
    (``kind='tensors'``) or 500 inducing sequences of length M+1
    (``'sequences'``, the recipe's ``use_tensors=False``) -- with q_mu /
    q_sqrt perturbed so predictions differ across classes and examples.
    Returns the f32 model on the card, its f64 twin on the CPU (the plain
    versions) and ``build(dtype, fused, device)`` loaded with the same
    parameters."""
    rng = np.random.RandomState(SEED + (1 if kind == "tensors" else 2))
    if kind == "tensors":
        Z = ut.suggest_initial_inducing_tensors(
            X, LEVELS, N_IND, labels=y, increments=True, seed=SEED)
    else:
        Z = ut.suggest_initial_inducing_sequences(
            X, N_IND, LEN_IND, labels=y, seed=SEED)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    tree = None

    def build(dtype, fused, device):
        kern = T.kernels.SignatureRBF(D, LEVELS, lengthscales=ls,
                                      fused=fused, dtype=dtype, device=device)
        if kind == "tensors":
            ind = T.InducingTensors(Z, LEVELS, increments=True, dtype=dtype,
                                    device=device)
        else:
            ind = T.InducingSequences(Z, LEVELS, dtype=dtype, device=device)
        model = T.SVGP(kern, ind, T.likelihoods.MultiClass(C), num_latent=C,
                       num_data=N_TRAIN, device=device)
        if tree is not None:
            T.convert.load_jax_params(model, tree)
        return model

    model = build(torch.float32, "on", "cuda")
    tree = T.convert.to_numpy_tree(model)
    tree["q_mu"] = rng.randn(N_IND, C) * 0.5
    tree["q_sqrt"] = (np.tril(rng.randn(C, N_IND, N_IND)) * 0.02
                      + 0.5 * np.eye(N_IND)[None])
    T.convert.load_jax_params(model, tree)
    ref = build(torch.float64, "auto", "cpu")  # the plain versions
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
    """Phase 2: every case of K1-K4 against its plain version."""
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
        pairs = (
            ("kzz_fwd", ic.kzz_fwd(*zz32, **kw),
             ic.kzz_fwd_plain(*zz32, **kw), ic.kzz_fwd_plain(*zz64, **kw)),
            ("kzx_fwd", ic.kzx_fwd(*zx32, **kwx),
             ic.kzx_fwd_plain(*zx32, **kwx), ic.kzx_fwd_plain(*zx64, **kwx)),
            ("kzz_bwd", ic.kzz_bwd(*zz32, cz32, **kw),
             ic.kzz_bwd_plain(*zz32, cz32, **kw),
             ic.kzz_bwd_plain(*zz64, cz64, **kw)),
            ("kzx_bwd", ic.kzx_bwd(*zx32, cx32, **kwx),
             ic.kzx_bwd_plain(*zx32, cx32, **kwx),
             ic.kzx_bwd_plain(*zx64, cx64, **kwx)),
        )
        torch.cuda.synchronize()
        for pair in pairs:
            rows.append(check_against_plain(
                *pair, dict(nz=nz, N=n, L=l, base=base, increments=inc,
                            difference=diff)))
    return rows


def check_against_plain(name, out, p32, p64, meta) -> dict:
    """A kernel's output against its plain version at f32 and f64."""
    if isinstance(out, torch.Tensor):
        out, p32, p64 = (out,), (p32,), (p64,)
    bound = F32_BOUND if name.endswith("fwd") else BWD_BOUND
    bound64 = F64_BOUND if name.endswith("fwd") else BWD_BOUND
    scale = max(float(p.abs().max()) for p in p64)
    e32 = max(float((o - p).abs().max()) for o, p in zip(out, p32))
    e64 = max(float((o.double() - p).abs().max()) for o, p in zip(out, p64))
    row = dict(kernel=name, **meta, scale=scale, err_vs_plain_f32=e32,
               err_vs_plain_f64=e64, plain_f32_err_vs_f64=max(
                   float((a.double() - b).abs().max())
                   for a, b in zip(p32, p64)))
    print(f"  {name} {meta}: |k-p32|={e32:.3e} |k-p64|={e64:.3e} "
          f"scale={scale:.3e}")
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{name}: non-finite")
    check(e32 <= bound * max(scale, 1.0), f"{name} {row}: exceeds the f32 "
          "bound")
    check(e64 <= bound64 * max(scale, 1.0), f"{name} {row}: exceeds the f64 "
          "bound")
    return row


SEQ_CASES = (  # (N1, L1, N2, L2, symmetric, base, difference)
    (N_IND, LEN_IND, N_IND, LEN_IND, True, "rbf", True),  # Kzz
    (N_IND, LEN_IND, BATCH, L, False, "rbf", True),  # Kzx
    (BATCH, L, BATCH, L, True, "rbf", True),  # full Kxx
    (7, 11, 5, 18, False, "rbf", True),
    (7, 11, 5, 18, False, "rbf", False),
    (7, 11, 5, 18, False, "linear", True),
    (7, 11, 5, 18, False, "linear", False),
)


def seq_inputs(ic, Zs, X, ls, case, dtype):
    """Augmented rows for K5/K6 (inducing sequences Zs against data X, both
    scaled) and a cotangent from the seed, on the card."""
    n1, l1, n2, l2, sym, base, _ = case
    scale = torch.as_tensor(ls, dtype=dtype, device="cuda")
    A = Zs[:n1, :l1] if l1 == LEN_IND else X[-n1:, :l1]
    A = torch.as_tensor(A, dtype=dtype, device="cuda") / scale
    B = A if sym else torch.as_tensor(X[:n2, :l2], dtype=dtype,
                                      device="cuda") / scale
    ct = torch.as_tensor(np.random.RandomState(SEED + 6).randn(
        LEVELS + 1, n1, n2), dtype=dtype, device="cuda")
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


def drive_serving(T, model, ref, X, expect):
    """Phase 3: the serving path through its public entry points; the
    kernels in ``expect`` must launch during the requests."""
    pred = T.serving.Predictor(model, len_buckets=LEN_BUCKETS,
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
    rows = []
    for (n, l), r, (mean, var) in zip(REQUESTS, reqs, outs):
        mean, var = mean.double().cpu(), var.double().cpu()
        check(mean.shape == (n, C) and var.shape == (n, C),
              f"request ({n}, {l}): output shapes {mean.shape}, {var.shape}")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
              f"request ({n}, {l}): non-finite output")
        row_err = float((mean.sum(1) - 1.0).abs().max())
        check(row_err <= MEAN_BOUND, f"request ({n}, {l}): rows sum off by "
              f"{row_err}")
        with torch.no_grad():
            ref_mean, _ = ref.predict_y(torch.as_tensor(r, dtype=torch.float64))
        err = float((mean - ref_mean).abs().max())
        top2 = torch.topk(ref_mean, 2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * MEAN_BOUND
        same = torch.argmax(mean, 1) == torch.argmax(ref_mean, 1)
        print(f"  request (n={n}, l={l}): |mean - f64 CPU|={err:.3e} "
              f"row-sum err={row_err:.3e} argmax agree={int(same.sum())}/{n}")
        check(err <= MEAN_BOUND, f"request ({n}, {l}): means off the f64 "
              f"CPU path by {err}")
        check(bool(same[decided].all()), f"request ({n}, {l}): argmax "
              "differs from the f64 CPU path")
        rows.append(dict(n=n, l=l, err_vs_f64_cpu=err, row_sum_err=row_err,
                         argmax_agree=int(same.sum())))
    return pred, launches, rows


def leaf_grads(T, model, X, Y):
    """Loss and every leaf's gradient (f64, on the CPU) on one batch."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(X, Y)
    loss.backward()
    grads = {name: p.grad.detach().double().cpu()
             for name, p in T.convert.named_leaves(model).items()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def gradient_check(T, model, ref, build, X, y):
    """Phase 5a: on the first minibatch, every leaf's gradient on the card
    (the kernels) against the port's f64 CPU path (the plain versions); the
    f32 plain PyTorch path on the card (``fused='off'``) is measured beside
    it."""
    idx = next(T.training.MinibatchStream(N_TRAIN, BATCH, seed_or_rng=SEED))
    xb, yb = X[idx], y[idx, None].astype(np.float32)

    def on(device, dtype):
        return (torch.as_tensor(xb, dtype=dtype, device=device),
                torch.as_tensor(yb, dtype=dtype, device=device))

    loss_k, g_k = leaf_grads(T, model, *on("cuda", torch.float32))
    loss_r, g_r = leaf_grads(T, ref, *on("cpu", torch.float64))
    off = build(torch.float32, "off", "cuda")
    loss_o, g_o = leaf_grads(T, off, *on("cuda", torch.float32))
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
                         rel_l2_kernels=err_k / norm,
                         rel_l2_plain_off=err_o / norm,
                         bounded_err_kernels=err_k / denom,
                         bounded_err_plain_off=err_o / denom,
                         nonzero=bool((g_k[name] != 0).any())))
        print(f"  grad {name}: |g_f64|={norm:.4e} rel L2 kernels "
              f"{err_k / norm:.3e}, plain fused='off' {err_o / norm:.3e}; "
              f"held to the bound: {err_k / denom:.3e}")
        if norm > 0:
            check(rows[-1]["nonzero"], f"{name}: zero gradient on the card "
                  "where the f64 CPU path has one")
    print(f"  loss: card {loss_k:.8f}, f64 CPU {loss_r:.8f}, "
          f"fused='off' {loss_o:.8f}")
    check(next(r for r in rows if r["leaf"] == "ind/Z")["nonzero"],
          "ind/Z has no gradient on the card")
    for r in rows:
        check(r["bounded_err_kernels"] <= GRAD_BOUND,
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


def bound_ms(name: str, nz: int, n: int, l: int) -> tuple[float, str]:
    """Least time the card could take for a kernel's work at this shape:
    FMAs (2 operations each) at the f32 peak against each input read and
    each output written once at the memory rate.  Slot dots: 4 of width
    d2 per slot Gram; each backward adds two d2-wide terms to each of its
    four gradients."""
    T_steps = l - 1  # the difference sweep of the benchmark configuration
    lvl = LEVELS + 1
    if name == "kzz_fwd":
        fma = 4 * LT * nz * nz * D2
        nbytes = 4 * (4 * LT * nz * D2 + lvl * nz * nz)
    elif name == "kzz_bwd":
        fma = 12 * LT * nz * nz * D2
        nbytes = 4 * (8 * LT * nz * D2 + lvl * nz * nz)
    elif name == "kzx_fwd":
        fma = 4 * LT * nz * n * T_steps * D2
        nbytes = 4 * (2 * LT * nz * D2 + 2 * n * l * D2 + lvl * nz * n)
    else:
        fma = 12 * LT * nz * n * T_steps * D2
        nbytes = 4 * (4 * LT * nz * D2 + 4 * n * l * D2 + lvl * nz * n)
    t_ops, t_bytes = 2 * fma / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def seq_bound_ms(name: str, case) -> tuple[float, str]:
    """``bound_ms`` for K5/K6 on a SEQ_CASES entry: per increment entry of
    the pairs this run computes (each unordered pair once when symmetric),
    4 dots of d2 plus 3 FMAs a level past the first (the product, the
    column sum, the prefix) and the level sum forward; backward the dots,
    four d2-wide weight contractions on each side and the levels forward
    and in reverse.  Bytes: the four row arrays (and the cotangent) read,
    the level stack (the four gradients) written."""
    n1, l1, n2, l2, sym, _, diff = case
    pairs = n1 * (n1 + 1) // 2 if sym else n1 * n2
    entries = pairs * (l1 - diff) * (l2 - diff)
    rows = 2 * (n1 * l1 + n2 * l2) * D2
    if name == "seq_fwd":
        fma = entries * (4 * D2 + 3 * (LEVELS - 1) + 1)
        nbytes = 4 * (rows + (LEVELS + 1) * n1 * n2)
    else:
        fma = entries * (12 * D2 + 6 * (LEVELS - 1) + 1)
        nbytes = 4 * (2 * rows + (LEVELS + 1) * n1 * n2)
    t_ops, t_bytes = 2 * fma / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_seq_kernels(sc, ic, Zs, X, ls):
    """Phase 4a': K5 and K6 vs their plain versions at the three
    full-width shapes (Kzz, Kzx, full Kxx), interleaved."""
    rows = []
    for case in SEQ_CASES[:3]:
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


def full_cov_check(T, model, X):
    """Phase 3b: the tensor model's ``predict_f(full_cov=True)`` at N=50,
    L=93 launches K5 once; the covariance's diagonal is ``predict_f``'s
    variance within 1e-5 relative, and its jittered Cholesky succeeds."""
    Xq = torch.as_tensor(X[:BATCH], device="cuda")
    reset_counts()
    with torch.no_grad():
        mean, cov = model.predict_f(Xq, full_cov=True)
    torch.cuda.synchronize()
    launches = read_counts()
    with torch.no_grad():
        mean_d, var = model.predict_f(Xq)
    print(f"  launches during predict_f(full_cov=True): {launches}")
    check(launches["seq_fwd"] == 1, "full_cov did not launch K5 once")
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
    check(rel <= 1e-5, f"covariance diagonal off the variance by {rel}")
    check(mean_err <= 1e-5, f"full_cov mean off by {mean_err}")
    check(not bool(info.any()), "the jittered Cholesky failed")
    return dict(launches=launches, diag_rel_err=rel, mean_err=mean_err,
                min_eigenvalue=min_eig)


def time_kernels(ic, ut, X):
    """Phase 4a: kernel vs plain at the benchmark shapes, interleaved."""
    Z_np, ls = benchmark_inputs(ut, X)
    rows = []
    for name, n in (("kzz_fwd", BATCH), ("kzx_fwd", 32), ("kzx_fwd", BATCH),
                    ("kzz_bwd", BATCH), ("kzx_bwd", BATCH)):
        zz, zx = kernel_inputs(ic, X, Z_np, ls, N_IND, n, L, base="rbf",
                               inc=True, dtype=torch.float32)
        cz, cx = cotangents(N_IND, n, torch.float32)
        kw = dict(num_levels=LEVELS, base="rbf", increments=True)
        kwx = dict(kw, difference=True)
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
        b_ms, b_by = bound_ms(name, N_IND, n, L)
        rows.append(dict(kernel=name, N=n, ms=[k1, k2], plain_ms=[p1, p2],
                         bound_ms=b_ms, bound_by=b_by))
        print(f"  {name} (nZ={N_IND}, N={n}, L={L}): kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    return rows


def time_requests(pred, X):
    """Phase 4b: request latency per bucket, host clock around a
    synchronized predict_y, median of 10 warmed calls."""
    rows = []
    for lb in LEN_BUCKETS:
        for b in BATCH_BUCKETS:
            Xq = X[:b, :lb]
            for _ in range(2):
                pred.predict_y(Xq)
            torch.cuda.synchronize()
            ts = []
            for _ in range(10):
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


def time_training(T, model, X, y):
    """Phase 4c: training steps/s (host clock around each synchronized
    step, median of 20 after 5 warm-up steps) and a profile of 3 steps."""
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

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ts))
    print(f"  training step: median {med:.3f} ms ({1e3 / med:.2f} steps/s), "
          f"min {min(ts):.3f} ms")
    return dict(step_ms=ts, median_ms=med, steps_per_s=1e3 / med,
                profile=profile_steps(step))


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
    # device activity (kernels, copies), without the ranges that user
    # annotations such as Optimizer.step draw over it on the device
    kernels: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us, count = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), count + 1)
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
    t0 = time.perf_counter()
    lib = _cuda_build.load()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {lib.path.name} in {build_s:.1f} s; ptxas:")
    print(lib.ptxas_report.strip())

    print("set-up: benchmark-width models from the seed")
    X, y = synthetic_data()
    model, ref, build = synthetic_setup(ut, T, X, y, "tensors")
    smodel, sref, sbuild = synthetic_setup(ut, T, X, y, "sequences")
    Zs = T.convert.to_numpy_tree(sref)["ind"]["Z"]
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    print("phase 2: kernels against their plain versions")
    checks = kernel_checks(ic, ut, X) + seq_kernel_checks(sc, ic, Zs, X, ls)
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
    print(f"phase 4: times ({card})")
    ktimes = time_kernels(ic, ut, X) + time_seq_kernels(sc, ic, Zs, X, ls)
    latency = time_requests(pred, X)
    train_time = time_training(T, model, X, y)
    print("  inducing sequences:")
    s_latency = time_requests(spred, X)
    s_train_time = time_training(T, smodel, X, y)
    check("jax" not in sys.modules, "something imported jax")

    kernels = []
    for name, (_, src, replaces) in KERNELS.items():
        if name.startswith("seq"):  # at the Kzx shape of a training step
            t = next(r for r in ktimes if r["kernel"] == name
                     and r.get("N2") == BATCH and r["N1"] == N_IND)
            launches = s_train_launches[name]
        else:
            t = next(r for r in ktimes if r["kernel"] == name
                     and r.get("N") == BATCH)
            launches = train_launches[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["err_vs_plain_f32"] for r in checks
                            if r["kernel"] == name),
            ms=float(np.mean(t["ms"])), plain_ms=float(np.mean(t["plain_ms"])),
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))
    details = dict(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   ptxas=lib.ptxas_report, kernel_checks=checks,
                   serving_launches=serve_launches, requests=requests,
                   full_cov=full_cov, gradient_check=grads,
                   training_launches=train_launches, training=train,
                   sequences=dict(
                       serving_launches=s_serve_launches,
                       requests=s_requests, gradient_check=s_grads,
                       training_launches=s_train_launches, training=s_train,
                       request_latency=s_latency, training_time=s_train_time),
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
