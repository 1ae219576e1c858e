"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``gpsig_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``: one ``nvcc -c`` for each source, all started
together, then one link.  The build runs at first use, into
``build/kernels/<hash>/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the sources and flags, so a fresh checkout builds itself
and an unchanged one reuses its library.  ``ptxas -v`` output (registers,
shared memory, spills per kernel) is kept beside the library.

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
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, argtypes): pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    # vl, dl, vr, dr, out, lt, nz, d2, num_levels, base, increments, stream
    "gpsig_kzz_fwd": [_P] * 5 + [_I] * 6 + [_P],
    # vl, dl, xv, xd, out, lt, nz, n_ex, L, d2, num_levels, base,
    # increments, difference, stream
    "gpsig_kzx_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # vl, dl, vr, dr, ct, out, lt, nz, d2, num_levels, base, increments,
    # splits, tiles_per_split, stream
    "gpsig_kzz_bwd": [_P] * 6 + [_I] * 8 + [_P],
    # vl, dl, xv, xd, ct, gz, gx, ck, lt, nz, n_ex, L, d2, num_levels,
    # base, increments, difference, t_chunk, stream
    "gpsig_kzx_bwd": [_P] * 8 + [_I] * 10 + [_P],
    # ov, od, ivT, idT, out, n_out, L_out, n_in, L_in, d2, num_levels, base,
    # difference, symmetric, swap, group, cpl, splits, stream
    "gpsig_seq_fwd": [_P] * 5 + [_I] * 13 + [_P],
    # lv, ld, rv, rd, lvT, ldT, rvT, rdT, ct, g1, g2, scratch, n1, L1, n2,
    # L2, d2, num_levels, base, difference, symmetric, group0, cpl0,
    # splits0, group1, cpl1, splits1, stream
    "gpsig_seq_bwd": [_P] * 12 + [_I] * 15 + [_P],
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def build() -> tuple[Path, str]:
    """Compile the kernels unless this source hash is built already.
    Returns (library path, ptxas report)."""
    out_dir = _BUILD_ROOT / _digest()
    lib_path = out_dir / "libgpsig_kernels.so"
    report_path = out_dir / "ptxas.txt"
    if lib_path.exists() and report_path.exists():
        return lib_path, report_path.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in _SOURCES]
    report = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)]
                   for src, obj in zip(_SOURCES, objs)])
    tmp = out_dir / f"libgpsig_kernels.{tag}.so"
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    report_path.write_text(report)
    os.replace(tmp, lib_path)
    return lib_path, report


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library once per process."""
    path, report = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, ptxas_report=report)
