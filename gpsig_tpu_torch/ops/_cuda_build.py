"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``gpsig_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``: one ``nvcc -c`` for each source, all started
together, then one link.  The build runs at first use, into
``build/kernels/<hash>/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the sources and flags, so a fresh checkout builds itself
and an unchanged one reuses its library.  ``ptxas -v`` output (registers,
shared memory, spills per kernel) is kept beside the library.

The main library holds each kernel's instances for 1 to ``MAIN_LEVELS``
signature levels.  A call with more levels loads, at its first use, a
second library built from the same sources with
``-DGPSIG_EXTRA_LEVELS=M``: one instance of each kernel for that M alone,
in ``build/kernels/<hash>-m<M>/``, loaded once per M per process.  The
seq x seq kernels K5 and K6 at an order k > 1 (the signature's
discretization, its (k x k) grid) come from a library of their own, built
at first use from ``seq_fwd.cu`` and ``seq_bwd.cu`` alone with
``-DGPSIG_ORDER=k -DGPSIG_ORDER_LEVELS=M`` into
``build/kernels/<hash>-m<M>-o<k>/``: the main library's instances are not
multiplied by the order.

No ``--use_fast_math``: it would turn ``expf`` into ``__expf`` and lose the
accuracy the slot-Gram algebra needs (``csrc/common.cuh``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("kzz_fwd.cu", "kzz_bwd.cu", "kzx_fwd.cu", "kzx_bwd.cu",
            "seq_fwd.cu", "seq_bwd.cu")
_SEQ_SOURCES = ("seq_fwd.cu", "seq_bwd.cu")  # an order library's
_HEADERS = ("common.cuh",)
MAIN_LEVELS = 8  # csrc/common.cuh::kMaxLevels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, argtypes): pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    # (the two step-norm arrays after the rows: matern12's, else null)
    # vl, dl, vr, dr, nl, nr, out, lt, nz, d2, num_levels, base, increments,
    # symmetric, stream
    "gpsig_kzz_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # vl, dl, xv, xd, nz, nt, out, lt, nz, n_ex, L, d2, num_levels, base,
    # increments, difference, stream
    "gpsig_kzx_fwd": [_P] * 7 + [_I] * 9 + [_P],
    # vl, dl, vr, dr, nl, nr, ct, out, lt, nz, d2, num_levels, base,
    # increments, symmetric, ranges, strips per range, stream
    "gpsig_kzz_bwd": [_P] * 8 + [_I] * 9 + [_P],
    # vl, dl, xv, xd, nz, nt, ct, gz, gx, ck, lt, nz, n_ex, L, d2,
    # num_levels, base, increments, difference, t_chunk, stage_rows, stream
    "gpsig_kzx_bwd": [_P] * 10 + [_I] * 11 + [_P],
    # ov, od, iv, id, no, ni, out, carry, n_out, L_out, n_in, L_in, d2,
    # num_levels, order, base, difference, symmetric, swap, group, cpl,
    # chunks, outer range, stream
    "gpsig_seq_fwd": [_P] * 8 + [_I] * 15 + [_P],
    # ov, od, iv, id, no, ni, ct, g_out, g_in, scratch, n_out, L_out, n_in,
    # L_in, d2, num_levels, order, base, difference, symmetric, swap, group,
    # cpl, chunks, ranges, workspace mode, stream
    "gpsig_seq_bwd": [_P] * 10 + [_I] * 16 + [_P],
    # args (n, 4), out (n, 4), n, stream: a test hook of common.cuh's expm1
    "gpsig_expm1_probe": [_P] * 2 + [_I] + [_P],
    # args (n, 8), out (n, 9), n, stream: a test hook of its matern12
    "gpsig_m12_probe": [_P] * 2 + [_I] + [_P],
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    ptxas_report: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels are built from source at first use"
    )


def _flags(num_levels: int, order: int = 1) -> tuple[str, ...]:
    if order > 1:
        return NVCC_FLAGS + (f"-DGPSIG_ORDER={order}",
                             f"-DGPSIG_ORDER_LEVELS={num_levels}")
    if num_levels <= MAIN_LEVELS:
        return NVCC_FLAGS
    return NVCC_FLAGS + (f"-DGPSIG_EXTRA_LEVELS={num_levels}",)


def _tag(num_levels: int, order: int = 1) -> str:
    """The library's directory under ``build/kernels/``."""
    tag = _digest(_flags(num_levels, order))
    if order > 1:
        return tag + f"-m{num_levels}-o{order}"
    return tag + (f"-m{num_levels}" if num_levels > MAIN_LEVELS else "")


def _digest(flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _HEADERS + _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds) -> str:
    """Run the commands in parallel and wait for all; raise if any failed.
    Returns their joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    outputs, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        outputs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outputs)


def build(num_levels: int = 1, order: int = 1) -> tuple[Path, str]:
    """Compile the library that holds ``num_levels`` at ``order`` (the
    main one up to ``MAIN_LEVELS`` at order 1, else the one for that level
    count, or K5/K6 alone for that order) unless this source hash is built
    already.  Returns (library path, ptxas report)."""
    flags = _flags(num_levels, order)
    sources = _SEQ_SOURCES if order > 1 else _SOURCES
    out_dir = _BUILD_ROOT / _tag(num_levels, order)
    lib_path = out_dir / "libgpsig_kernels.so"
    report_path = out_dir / "ptxas.txt"
    if lib_path.exists() and report_path.exists():
        return lib_path, report_path.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in sources]
    report = _run([[nvcc, *flags, "-c", "-o", str(obj), str(_CSRC / src)]
                   for src, obj in zip(sources, objs)])
    tmp = out_dir / f"libgpsig_kernels.{tag}.so"
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    report_path.write_text(report)
    os.replace(tmp, lib_path)
    return lib_path, report


def load(num_levels: int = 1, order: int = 1) -> KernelLibrary:
    """Build (if needed) and load, once per process, the library that
    holds ``num_levels`` at ``order``: the main one for up to
    ``MAIN_LEVELS`` at order 1, else the one built for that level count,
    or for that level count and order."""
    if order > 1:
        return _load(num_levels, order)
    return _load(num_levels if num_levels > MAIN_LEVELS else 1, 1)


@functools.lru_cache(maxsize=None)
def _load(num_levels: int, order: int) -> KernelLibrary:
    path, report = build(num_levels, order)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if order > 1 and not name.startswith("gpsig_seq_"):
            continue  # an order library holds K5 and K6 alone
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, ptxas_report=report)
