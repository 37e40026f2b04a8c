"""nvcc build and ctypes loader for the CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file is compiled with nvcc for Hopper (``sm_90a``) into
ONE shared library with a plain C interface, loaded with ctypes. The build
runs at first use, never at import (importing the package must work on a
machine without nvcc or CUDA), into ``montecarlo_tpu_torch/_build/`` (listed
in .gitignore). The library's file name carries a hash of the sources and
the command line, so an edited kernel is rebuilt and a stale library is never
loaded. A plain C interface keeps the build to seconds; a source that
includes PyTorch's headers would take minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the exported launchers; every launcher returns the
# cudaGetLastError() code of its launch (0 = success)
SIGNATURES = {
    # G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, F, N,
    # lamb, sign0, sign1, det_power, use_boson, stream
    "site_sweep_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _F, _F, _F, _I, _I, _P),
    # A, mx, Q, Rs, d, B, N, stream
    "udt_qr_f32": (_P, _P, _P, _P, _P, _I, _I, _P),
    # A, Z, mx, Q, X, B, N, stream
    "udt_qr_solve_f32": (_P, _P, _P, _P, _P, _I, _I, _P),
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


# the CUDA toolkit's default install prefix, searched after PATH and CUDA_HOME
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.environ.get("CUDA_HOME"):
        cand = Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH, under $CUDA_HOME/bin or "
                           f"at {CUDA_NVCC})")
    return nvcc


def nvcc_command(nvcc: str, output: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), *map(str, sources())]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmctorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists.
    Writes to a temporary name and renames, so concurrent builds never
    load a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, code: int):
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {code})")
