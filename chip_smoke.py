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
   many more terms in another order);
3. serving: an SVGP at the benchmark width (SignatureRBF d=14 M=4, 500
   incremental inducing tensors, MultiClass C=10) behind a bucketed
   ``serving.Predictor`` with ``fused='on'`` answers ragged requests; K1's
   and K3's launch counters must rise, outputs be finite, each predictive
   mean row sum to 1 within 1e-3, and means agree within 1e-3 with the
   port's own f64 CPU path;
5. training: on one minibatch of 50, the gradient of every leaf on the
   card must be non-zero where the f64 CPU path's is and lie within
   relative L2 1e-3 of it, relative to the larger of the leaf's own norm
   and 1e-3 of the largest leaf's (``kern/sigma``: the loss is invariant
   to a common scale of the covariances up to the jitter, so its gradient
   is ~1e-7 of the others and below what f32 resolves); then
   ``training.optimize`` takes 30 NAdam(1e-3) steps over minibatches of
   50 of synthetic (2000, 93, 14) data under the reference's phase-2
   mask (all but ``kern/variances``): each of the four kernels must launch
   once a step, every loss be finite, the last ten losses average below
   the first ten, and the frozen leaf keep its bits;
4. times: the four kernels against their plain versions with CUDA events,
   interleaved plain / kernel / kernel / plain; request latency per
   bucket; training steps/s (median of 20 synchronized steps after 5
   warm-up steps) and a ``torch.profiler`` breakdown of a step.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
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
KERNELS = {  # name: (source, TPU kernel it replaces)
    "kzz_fwd": ("gpsig_tpu_torch/csrc/kzz_fwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:223"),
    "kzx_fwd": ("gpsig_tpu_torch/csrc/kzx_fwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:697"),
    "kzz_bwd": ("gpsig_tpu_torch/csrc/kzz_bwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:256"),
    "kzx_bwd": ("gpsig_tpu_torch/csrc/kzx_bwd.cu",
                "gpsig_tpu/ops/inducing_pallas.py:740"),
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


def reset_counts(ic) -> None:
    for name in KERNELS:
        getattr(ic, name).launches = 0


def read_counts(ic) -> dict:
    return {name: getattr(ic, name).launches for name in KERNELS}


def synthetic_setup(ut, T):
    """Benchmark-width SVGP with parameters from a numpy seed: the ported
    heuristics on synthetic (2000, 93, 14) data, q_mu / q_sqrt perturbed so
    predictions differ across classes and examples.  Returns the f32 model
    on the card, its f64 twin on the CPU (the plain versions), the data and
    labels, and ``build(dtype, fused, device)`` loaded with the same
    parameters."""
    rng = np.random.RandomState(SEED)
    X = rng.randn(N_TRAIN, L, D).astype(np.float32)
    y = rng.randint(0, C, N_TRAIN)
    Z = ut.suggest_initial_inducing_tensors(
        X, LEVELS, N_IND, labels=y, increments=True, seed=SEED)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    tree = None

    def build(dtype, fused, device):
        kern = T.kernels.SignatureRBF(D, LEVELS, lengthscales=ls,
                                      fused=fused, dtype=dtype, device=device)
        ind = T.InducingTensors(Z, LEVELS, increments=True, dtype=dtype,
                                device=device)
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
    return model, ref, X, y, build


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
        for name, out, p32, p64 in pairs:
            if isinstance(out, torch.Tensor):
                out, p32, p64 = (out,), (p32,), (p64,)
            bound = F32_BOUND if name.endswith("fwd") else BWD_BOUND
            bound64 = F64_BOUND if name.endswith("fwd") else BWD_BOUND
            scale = max(float(p.abs().max()) for p in p64)
            e32 = max(float((o - p).abs().max()) for o, p in zip(out, p32))
            e64 = max(float((o.double() - p).abs().max())
                      for o, p in zip(out, p64))
            row = dict(kernel=name, nz=nz, N=n, L=l, base=base,
                       increments=inc, difference=diff, scale=scale,
                       err_vs_plain_f32=e32, err_vs_plain_f64=e64,
                       plain_f32_err_vs_f64=max(
                           float((a.double() - b).abs().max())
                           for a, b in zip(p32, p64)))
            rows.append(row)
            print(f"  {name} nz={nz} N={n} L={l} {base} inc={inc} "
                  f"diff={diff}: |k-p32|={e32:.3e} |k-p64|={e64:.3e} "
                  f"scale={scale:.3e}")
            check(all(bool(torch.isfinite(o).all()) for o in out),
                  f"{name}: non-finite")
            check(e32 <= bound * max(scale, 1.0),
                  f"{name} {row}: exceeds the f32 bound")
            check(e64 <= bound64 * max(scale, 1.0),
                  f"{name} {row}: exceeds the f64 bound")
    return rows


def drive_serving(T, ic, model, ref, X):
    """Phase 3: the serving path through its public entry points."""
    pred = T.serving.Predictor(model, len_buckets=LEN_BUCKETS,
                               batch_buckets=BATCH_BUCKETS, device="cuda")
    pred.warmup(D)
    torch.cuda.synchronize()
    rng = np.random.RandomState(SEED + 2)
    reqs = [X[rng.choice(len(X), n, replace=False), :l] for n, l in REQUESTS]
    reset_counts(ic)
    outs = [pred.predict_y(r) for r in reqs]
    torch.cuda.synchronize()
    launches = read_counts(ic)
    print(f"  launches during the requests: {launches}")
    for name in ("kzz_fwd", "kzx_fwd"):
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
    (K1-K4) against the port's f64 CPU path (the plain versions); the f32
    plain PyTorch path on the card (``fused='off'``) is measured beside it."""
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
    rows = []
    for name, want in g_r.items():
        norm = float(want.norm())
        err_k = float((g_k[name] - want).norm())
        err_o = float((g_o[name] - want).norm())
        denom = max(norm, GRAD_FLOOR * top)
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


def drive_training(T, ic, model, X, y):
    """Phase 5b: the training path through its public entry points."""
    frozen = {n: p.detach().clone()
              for n, p in T.convert.named_leaves(model).items()
              if not phase2_mask(n)}
    data = T.training.BatchIterator(
        T.training.MinibatchStream(N_TRAIN, BATCH, seed_or_rng=SEED),
        X, y[:, None].astype(np.float32), device="cuda")
    reset_counts(ic)
    hist = T.training.optimize(
        lambda m, xb, yb: m.loss(xb, yb), model, T.training.nadam(LR),
        max_iter=STEPS, data_iter=data, trainable=phase2_mask, save_freq=1,
        print_freq=10, log_fn=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    launches = read_counts(ic)
    print(f"  launches during {STEPS} steps: {launches}")
    for name, count in launches.items():
        check(count == STEPS, f"{name} launched {count} times in {STEPS} "
              "steps")
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

    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card)
    t0 = time.perf_counter()
    lib = _cuda_build.load()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {lib.path.name} in {build_s:.1f} s; ptxas:")
    print(lib.ptxas_report.strip())

    print("set-up: benchmark-width model from the seed")
    model, ref, X, y, build = synthetic_setup(ut, T)
    print("phase 2: kernels against their plain versions")
    checks = kernel_checks(ic, ut, X)
    print("phase 3: serving")
    pred, serve_launches, requests = drive_serving(T, ic, model, ref, X)
    print("phase 5: training")
    grads = gradient_check(T, model, ref, build, X, y)
    train_launches, train = drive_training(T, ic, model, X, y)
    print(f"phase 4: times ({card})")
    ktimes = time_kernels(ic, ut, X)
    latency = time_requests(pred, X)
    train_time = time_training(T, model, X, y)
    check("jax" not in sys.modules, "something imported jax")

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = next(r for r in ktimes if r["kernel"] == name and r["N"] == BATCH)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=train_launches[name],
            max_abs_err=max(r["err_vs_plain_f32"] for r in checks
                            if r["kernel"] == name),
            ms=float(np.mean(t["ms"])), plain_ms=float(np.mean(t["plain_ms"])),
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))
    details = dict(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   ptxas=lib.ptxas_report, kernel_checks=checks,
                   serving_launches=serve_launches, requests=requests,
                   gradient_check=grads, training_launches=train_launches,
                   training=train, kernel_times=ktimes,
                   request_latency=latency, training_time=train_time,
                   kernels=kernels)
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
