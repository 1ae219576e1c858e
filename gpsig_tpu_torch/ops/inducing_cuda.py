"""Inducing-tensor covariances (Kzz, Kzx) through hand-written CUDA kernels.

The port of ``gpsig_tpu/ops/inducing_pallas.py``'s forward path:

* ``kzz_fwd`` launches K1 (``csrc/kzz_fwd.cu``), which replaces the TPU
  kernel ``_kernel_tens_fwd`` (``inducing_pallas.py:223``);
* ``kzx_fwd`` launches K3 (``csrc/kzx_fwd.cu``), which replaces
  ``_kernel_zx_fwd`` (``inducing_pallas.py:697``).

Each wrapper has a plain PyTorch version beside it (``kzz_fwd_plain``,
``kzx_fwd_plain``) built from the same algebra in torch ops, and a launch
counter (``kzz_fwd.launches``, ``kzx_fwd.launches``) that rises by one per
kernel launch and nowhere else.  A wrapper runs its plain version only
because the tensors it was given lie on the CPU; on a CUDA tensor it
launches the kernel or raises (float64, an unsupported base, mixed
devices).  There is no fallback from a failed build or launch.

The host-side prep stays in torch, as the JAX package keeps it in XLA: the
norm augmentation that turns the rbf exponent -|z - x|^2/2 into one dot
product, lhs ``[z, -|z|^2/2, 1]`` against rhs ``[x, 1, -|x|^2/2]``, and the
exact norm-channel differences ``-<z1 + z0, z1 - z0>/2`` of each increment.
The kernels take the augmented rows and nothing else.  The TPU-only
machinery (lane batching, VMEM plans, padding to 128) has no counterpart.

Each wrapper's docstring says what bounds its kernel on the H100 and what
the design does about it; the header of its ``.cu`` file has the detail.
"""

from __future__ import annotations

import torch

from . import gram
from .signature import signature_kern_tens_vs_seq_first_order, tensor_kern

SUPPORTED_BASES = ("rbf", "linear")
_BASE_IDS = {"rbf": 0, "linear": 1}  # csrc/common.cuh::Base
MAX_LEVELS = 8  # csrc/common.cuh::kMaxLevels


# ---------------------------------------------------------------------------
# host-side prep
# ---------------------------------------------------------------------------


def _aug_value(Z, base: str, lhs: bool):
    """(..., d) -> (..., d2) norm-augmented value vectors."""
    if base == "linear":
        return Z
    n = -0.5 * torch.sum(torch.square(Z), dim=-1, keepdim=True)
    ones = torch.ones_like(n)
    return torch.cat([Z, n, ones] if lhs else [Z, ones, n], dim=-1)


def _aug_diff(Z0, Z1, base: str, lhs: bool):
    """Difference vectors with the exact norm-channel difference."""
    dZ = Z1 - Z0
    if base == "linear":
        return dZ
    dn = -0.5 * torch.sum((Z1 + Z0) * dZ, dim=-1, keepdim=True)
    zeros = torch.zeros_like(dn)
    return torch.cat([dZ, dn, zeros] if lhs else [dZ, zeros, dn], dim=-1)


def _prep_tensors(Z, base: str, increments: bool, lhs: bool):
    """(lt, nZ, [2,] d) -> value / difference rows, each (lt, nZ, d2)."""
    if increments:
        V = _aug_value(Z[:, :, 0, :], base, lhs)
        D = _aug_diff(Z[:, :, 0, :], Z[:, :, 1, :], base, lhs)
    else:
        V = _aug_value(Z, base, lhs)
        D = torch.zeros_like(V)
    return V.contiguous(), D.contiguous()


def _prep_seq(X, base: str):
    """(N, L, d) -> rhs value / step rows, each (N, L, d2); the last step
    repeats the last observation, so its difference is exactly 0."""
    Xn = torch.cat([X[:, 1:], X[:, -1:]], dim=1)
    V = _aug_value(X, base, lhs=False)
    D = _aug_diff(X, Xn, base, lhs=False)
    return V.contiguous(), D.contiguous()


def _check_config(num_levels: int, base: str, lt: int):
    if base not in SUPPORTED_BASES:
        raise ValueError(
            f"base {base!r} has no inducing kernel; supported: "
            f"{SUPPORTED_BASES}"
        )
    if lt != num_levels * (num_levels + 1) // 2:
        raise ValueError(f"{lt} packed slots do not make {num_levels} levels")


def _check_cuda(name: str, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: inputs must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} runs in float32 on the card, got {t.dtype}; "
                "float64 runs on the CPU (the plain version)"
            )


def _launch(fn_name: str, *args):
    from . import _cuda_build

    rc = getattr(_cuda_build.load().lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: Kzz
# ---------------------------------------------------------------------------


def kzz_fwd_plain(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
                  increments: bool):
    """Plain torch version of K1 on the augmented rows (lt, nZ, d2):
    ``(num_levels+1, nZ, nZ)``.  f32 uses ``gram.exp_accurate`` and the
    Taylor ``expm1``; f64 the native exp/expm1."""
    def dots(A, B):
        return torch.matmul(A, B.transpose(1, 2))

    if base == "linear":
        G = dots(Dl, Dr) if increments else dots(Vl, Vr)
    elif not increments:
        G = gram.exp_accurate(dots(Vl, Vr))
    else:
        d01, d10 = dots(Vl, Dr), dots(Dl, Vr)
        expm1 = gram._expm1_stable
        G = gram.exp_accurate(dots(Vl, Vr)) * (
            expm1(d01 + d10 + dots(Dl, Dr)) - expm1(d01) - expm1(d10)
        )
    return tensor_kern(G, num_levels)


def kzz_fwd(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
            increments: bool):
    """K1 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_tens_fwd`` (``gpsig_tpu/ops/inducing_pallas.py:223``).
    Bound on the H100: at nZ=500 the output is (M+1) nZ^2 floats = 5 MB and
    the work ~0.3 GFLOP, so a call is latency- and launch-bound.  Design:
    one launch, one thread per (i, j), rows staged through shared memory in
    16-column chunks (``csrc/kzz_fwd.cu``)."""
    lt, nz, d2 = Vl.shape
    _check_config(num_levels, base, lt)
    for t in (Dl, Vr, Dr):
        if t.shape != Vl.shape:
            raise ValueError(f"kzz_fwd: shape {tuple(t.shape)} != "
                             f"{tuple(Vl.shape)}")
    if Vl.device.type == "cpu":
        return kzz_fwd_plain(Vl, Dl, Vr, Dr, num_levels=num_levels,
                             base=base, increments=increments)
    _check_cuda("kzz_fwd", Vl, Dl, Vr, Dr)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"kzz_fwd is built for up to {MAX_LEVELS} levels")
    Vl, Dl, Vr, Dr = (t.contiguous() for t in (Vl, Dl, Vr, Dr))
    out = torch.empty((num_levels + 1, nz, nz), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzz_fwd", Vl.data_ptr(), Dl.data_ptr(), Vr.data_ptr(),
            Dr.data_ptr(), out.data_ptr(), lt, nz, d2, num_levels,
            _BASE_IDS[base], int(increments), _stream(Vl))
    kzz_fwd.launches += 1
    return out


kzz_fwd.launches = 0


# ---------------------------------------------------------------------------
# K3: Kzx
# ---------------------------------------------------------------------------


def kzx_fwd_plain(Vl, Dl, Xv, Xd, *, num_levels: int, base: str,
                  increments: bool, difference: bool):
    """Plain torch version of K3: tensor rows (lt, nZ, d2) against sequence
    rows (N, L, d2) -> ``(num_levels+1, nZ, N)``.  f32 uses
    ``gram.exp_accurate`` and the Taylor ``expm1``; f64 the native ones."""
    T = Xv.shape[1] - 1 if difference else Xv.shape[1]
    Xv, Xd = Xv[:, :T], Xd[:, :T]

    def dots(A, B):
        return torch.einsum("kzc,ntc->kznt", A, B)

    exp, expm1 = gram.exp_accurate, gram._expm1_stable
    if base == "linear":
        G = dots(Dl if increments else Vl, Xd if difference else Xv)
    elif increments:
        eA0, dZA = exp(dots(Vl, Xv)), dots(Dl, Xv)
        if difference:
            dA0 = dots(Vl, Xd)
            G = eA0 * (exp(dZA) * expm1(dA0 + dots(Dl, Xd)) - expm1(dA0))
        else:
            G = eA0 * expm1(dZA)
    elif difference:
        G = exp(dots(Vl, Xv)) * expm1(dots(Vl, Xd))
    else:
        G = exp(dots(Vl, Xv))
    return signature_kern_tens_vs_seq_first_order(G, num_levels,
                                                  difference=False)


def kzx_fwd(Vl, Dl, Xv, Xd, *, num_levels: int, base: str, increments: bool,
            difference: bool):
    """K3 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_zx_fwd`` (``gpsig_tpu/ops/inducing_pallas.py:697``).
    Bound on the H100: exp/FMA issue -- per (z, n, t) about lt slots x 4
    dots of d2 plus 3 transcendentals -- and the few (z, n) pairs to run in
    parallel.  Design: the time recursion is one register-carried sweep;
    a block's warps compute a time chunk's slot Grams in parallel into
    shared memory before one warp sweeps it (``csrc/kzx_fwd.cu``)."""
    lt, nz, d2 = Vl.shape
    n_ex, L, _ = Xv.shape
    _check_config(num_levels, base, lt)
    if Dl.shape != Vl.shape or Xd.shape != Xv.shape or Xv.shape[-1] != d2:
        raise ValueError("kzx_fwd: inconsistent input shapes")
    if Vl.device.type == "cpu":
        return kzx_fwd_plain(Vl, Dl, Xv, Xd, num_levels=num_levels,
                             base=base, increments=increments,
                             difference=difference)
    _check_cuda("kzx_fwd", Vl, Dl, Xv, Xd)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"kzx_fwd is built for up to {MAX_LEVELS} levels")
    if n_ex > 65535:
        raise ValueError("kzx_fwd takes at most 65535 examples per call")
    # the kernel reads the inducing rows as (lt, d2, nZ): coalesced per warp
    VlT = Vl.transpose(1, 2).contiguous()
    DlT = Dl.transpose(1, 2).contiguous()
    Xv, Xd = Xv.contiguous(), Xd.contiguous()
    out = torch.empty((num_levels + 1, nz, n_ex), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzx_fwd", VlT.data_ptr(), DlT.data_ptr(), Xv.data_ptr(),
            Xd.data_ptr(), out.data_ptr(), lt, nz, n_ex, L, d2, num_levels,
            _BASE_IDS[base], int(increments), int(difference), _stream(Vl))
    kzx_fwd.launches += 1
    return out


kzx_fwd.launches = 0


# ---------------------------------------------------------------------------
# public entry points (signatures of the JAX package's fused wrappers)
# ---------------------------------------------------------------------------


def fused_tensor_levels(Z, *, num_levels: int, base: str = "rbf",
                        increments: bool = True):
    """(num_levels+1, nZ, nZ) inducing-tensor level Grams.

    Z: (lt, nZ, 2, d) with increments, else (lt, nZ, d)."""
    Vl, Dl = _prep_tensors(Z, base, increments, lhs=True)
    Vr, Dr = _prep_tensors(Z, base, increments, lhs=False)
    return kzz_fwd(Vl, Dl, Vr, Dr, num_levels=num_levels, base=base,
                   increments=increments)


def fused_tens_vs_seq_levels(Z, X, *, num_levels: int, base: str = "rbf",
                             increments: bool = True,
                             difference: bool = True, fast_math="high"):
    """(num_levels+1, nZ, N) tensor-vs-sequence level kernels, order 1.

    Z: (lt, nZ, 2, d) with increments else (lt, nZ, d); X: (N, L, d).
    ``fast_math`` is accepted for the JAX signature; every value means full
    f32 on the card."""
    del fast_math
    Vl, Dl = _prep_tensors(Z, base, increments, lhs=True)
    Xv, Xd = _prep_seq(X, base)
    return kzx_fwd(Vl, Dl, Xv, Xd, num_levels=num_levels, base=base,
                   increments=increments, difference=difference)
