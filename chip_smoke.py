#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gpsig_tpu_torch``) on one GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: require CUDA, print versions and the card's name and power
   limit, build the hand-written kernels from ``gpsig_tpu_torch/csrc`` and
   print the ptxas report (registers, shared memory, spills);
2. kernels: K1 (Kzz) and K3 (Kzx) on the card at the serving shape
   (lt=10, nZ=500, d=14, N=32 and 50, L=93) and at ragged shapes, each held
   against its plain PyTorch version at f32 (<= 1e-5 * max(scale, 1)) and
   at f64 (<= 1e-4 * max(scale, 1));
3. slice: an SVGP at the benchmark width (SignatureRBF d=14 M=4, 500
   incremental inducing tensors, MultiClass C=10) behind a bucketed
   ``serving.Predictor`` with ``fused='on'`` answers ragged requests; both
   kernels' launch counters must rise, outputs be finite, each predictive
   mean row sum to 1 within 1e-3, and means agree within 1e-3 with the
   port's own f64 CPU path;
4. times: K1 and K3 against their plain versions with CUDA events,
   interleaved plain / kernel / kernel / plain, and request latency per
   bucket.

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
LEN_BUCKETS, BATCH_BUCKETS = (48, 96), (1, 8, 32)
REQUESTS = ((1, 93), (5, 40), (32, 93), (20, 70))
F32_BOUND, F64_BOUND, MEAN_BOUND = 1e-5, 1e-4, 1e-3


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_model(ut, T):
    """Benchmark-width SVGP with parameters from a numpy seed: the ported
    heuristics on synthetic (2000, 93, 14) data, q_mu / q_sqrt perturbed so
    predictions differ across classes and examples."""
    rng = np.random.RandomState(SEED)
    X = rng.randn(N_TRAIN, L, D).astype(np.float32)
    y = rng.randint(0, C, N_TRAIN)
    Z = ut.suggest_initial_inducing_tensors(
        X, LEVELS, N_IND, labels=y, increments=True, seed=SEED)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)

    def build(dtype, fused):
        kern = T.kernels.SignatureRBF(D, LEVELS, lengthscales=ls,
                                      fused=fused, dtype=dtype)
        ind = T.InducingTensors(Z, LEVELS, increments=True, dtype=dtype)
        return T.SVGP(kern, ind, T.likelihoods.MultiClass(C), num_latent=C,
                      num_data=N_TRAIN)

    model = build(torch.float32, "on")
    tree = T.convert.to_numpy_tree(model)
    tree["q_mu"] = rng.randn(N_IND, C) * 0.5
    tree["q_sqrt"] = (np.tril(rng.randn(C, N_IND, N_IND)) * 0.02
                      + 0.5 * np.eye(N_IND)[None])
    T.convert.load_jax_params(model, tree)
    ref = build(torch.float64, "auto")  # CPU: the plain versions
    T.convert.load_jax_params(ref, tree)
    return model, ref, X


def kernel_inputs(ic, X, Z_np, ls, nz, n, l, *, base, inc, dtype):
    """Augmented rows for K1 / K3 from scaled data on the card."""
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


def kernel_checks(ic, ut, X):
    """Phase 2: every case of K1 and K3 against its plain version."""
    Z_np = ut.suggest_initial_inducing_tensors(
        X[:200], LEVELS, N_IND, increments=True, seed=SEED + 1)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    cases = [  # (nz, N, L, base, increments, difference)
        (N_IND, 32, L, "rbf", True, True),
        (N_IND, 50, L, "rbf", True, True),
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
        kw = dict(num_levels=LEVELS, base=base, increments=inc)
        pairs = (
            ("kzz_fwd", ic.kzz_fwd(*zz32, **kw),
             ic.kzz_fwd_plain(*zz32, **kw), ic.kzz_fwd_plain(*zz64, **kw)),
            ("kzx_fwd", ic.kzx_fwd(*zx32, difference=diff, **kw),
             ic.kzx_fwd_plain(*zx32, difference=diff, **kw),
             ic.kzx_fwd_plain(*zx64, difference=diff, **kw)),
        )
        torch.cuda.synchronize()
        for name, out, p32, p64 in pairs:
            scale = float(p64.abs().max())
            e32 = float((out - p32).abs().max())
            e64 = float((out.double() - p64).abs().max())
            row = dict(kernel=name, nz=nz, N=n, L=l, base=base,
                       increments=inc, difference=diff, scale=scale,
                       err_vs_plain_f32=e32, err_vs_plain_f64=e64,
                       plain_f32_err_vs_f64=float(
                           (p32.double() - p64).abs().max()))
            rows.append(row)
            print(f"  {name} nz={nz} N={n} L={l} {base} inc={inc} "
                  f"diff={diff}: |k-p32|={e32:.3e} |k-p64|={e64:.3e} "
                  f"scale={scale:.3e}")
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite")
            check(e32 <= F32_BOUND * max(scale, 1.0),
                  f"{name} {row}: exceeds the f32 bound")
            check(e64 <= F64_BOUND * max(scale, 1.0),
                  f"{name} {row}: exceeds the f64 bound")
    return rows


def drive_slice(T, ic, model, ref, X):
    """Phase 3: the serving path through its public entry points."""
    pred = T.serving.Predictor(model, len_buckets=LEN_BUCKETS,
                               batch_buckets=BATCH_BUCKETS, device="cuda")
    pred.warmup(D)
    torch.cuda.synchronize()
    rng = np.random.RandomState(SEED + 2)
    reqs = [X[rng.choice(len(X), n, replace=False), :l] for n, l in REQUESTS]
    ic.kzz_fwd.launches = 0
    ic.kzx_fwd.launches = 0
    outs = [pred.predict_y(r) for r in reqs]
    torch.cuda.synchronize()
    launches = {"kzz_fwd": ic.kzz_fwd.launches,
                "kzx_fwd": ic.kzx_fwd.launches}
    print(f"  launches during the requests: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
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


def time_kernels(ic, ut, X):
    """Phase 4a: kernel vs plain at the serving shape, interleaved."""
    Z_np = ut.suggest_initial_inducing_tensors(
        X[:200], LEVELS, N_IND, increments=True, seed=SEED + 1)
    ls = ut.suggest_initial_lengthscales(X, 1000, seed=SEED)
    rows = []
    for name, n in (("kzz_fwd", 32), ("kzx_fwd", 32), ("kzx_fwd", 50)):
        zz, zx = kernel_inputs(ic, X, Z_np, ls, N_IND, n, L, base="rbf",
                               inc=True, dtype=torch.float32)
        kw = dict(num_levels=LEVELS, base="rbf", increments=True)
        if name == "kzz_fwd":
            kern = lambda: ic.kzz_fwd(*zz, **kw)  # noqa: E731
            plain = lambda: ic.kzz_fwd_plain(*zz, **kw)  # noqa: E731
        else:
            kw["difference"] = True
            kern = lambda: ic.kzx_fwd(*zx, **kw)  # noqa: E731
            plain = lambda: ic.kzx_fwd_plain(*zx, **kw)  # noqa: E731
        p1, k1, k2, p2 = (time_cuda(plain), time_cuda(kern),
                          time_cuda(kern), time_cuda(plain))
        rows.append(dict(kernel=name, N=n, ms=[k1, k2], plain_ms=[p1, p2]))
        print(f"  {name} (nZ={N_IND}, N={n}, L={L}): kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
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

    print("phase 3 set-up: benchmark-width model from the seed")
    model, ref, X = synthetic_model(ut, T)
    print("phase 2: kernels against their plain versions")
    checks = kernel_checks(ic, ut, X)
    print("phase 3: serving slice")
    pred, launches, requests = drive_slice(T, ic, model, ref, X)
    print(f"phase 4: times ({card})")
    ktimes = time_kernels(ic, ut, X)
    latency = time_requests(pred, X)
    check("jax" not in sys.modules, "something imported jax")

    sources = {"kzz_fwd": ("gpsig_tpu_torch/csrc/kzz_fwd.cu",
                           "gpsig_tpu/ops/inducing_pallas.py:223"),
               "kzx_fwd": ("gpsig_tpu_torch/csrc/kzx_fwd.cu",
                           "gpsig_tpu/ops/inducing_pallas.py:697")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = next(r for r in ktimes if r["kernel"] == name and r["N"] == 32)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["err_vs_plain_f32"] for r in checks
                            if r["kernel"] == name),
            ms=float(np.mean(t["ms"])), plain_ms=float(np.mean(t["plain_ms"]))))
    details = dict(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   ptxas=lib.ptxas_report, kernel_checks=checks,
                   requests=requests, kernel_times=ktimes,
                   request_latency=latency, kernels=kernels)
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
