"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``gpsig_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``.  The build runs at first use, into
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
_SOURCES = ("kzz_fwd.cu", "kzx_fwd.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, argtypes): pointers and the stream as c_void_p, sizes as c_int
_SIGNATURES = {
    # vl, dl, vr, dr, out, lt, nz, d2, num_levels, base, increments, stream
    "gpsig_kzz_fwd": [_P] * 5 + [_I] * 6 + [_P],
    # vl, dl, xv, xd, out, lt, nz, n_ex, L, d2, num_levels, base,
    # increments, difference, stream
    "gpsig_kzx_fwd": [_P] * 5 + [_I] * 9 + [_P],
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


def build() -> tuple[Path, str]:
    """Compile the kernels unless this source hash is built already.
    Returns (library path, ptxas report)."""
    out_dir = _BUILD_ROOT / _digest()
    lib_path = out_dir / "libgpsig_kernels.so"
    report_path = out_dir / "ptxas.txt"
    if lib_path.exists() and report_path.exists():
        return lib_path, report_path.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libgpsig_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
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
