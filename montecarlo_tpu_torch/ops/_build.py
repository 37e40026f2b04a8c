"""nvcc build and ctypes loader for the CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled with nvcc for Hopper (``sm_90a``) into an object file, all of them
at once in parallel processes, and the objects are linked into ONE shared
library with a plain C interface, loaded with ctypes. The build runs at
first use, never at import (importing the package must work on a machine
without nvcc or CUDA), into ``montecarlo_tpu_torch/_build/`` (listed in
.gitignore). The library's file name carries a hash of the sources, the
headers and the command lines, so an edited kernel is rebuilt and a stale
library is never loaded. ``use_defines`` switches the process to a build
with extra preprocessor flags (chip_profile.py's phase stamps,
``-DMC_PHASE_STAMPS``) in a directory of its own. A plain C interface keeps
the build to seconds; a source that includes PyTorch's headers would take
minutes.
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
# dynamic shared memory one block may use on Hopper (sm_90), in bytes
SMEM_PER_BLOCK = 232448

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# extra -D flags of this process's build (empty: the kernels as they ship)
DEFINES: tuple = ()

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# C signatures of the exported launchers; every launcher returns the
# cudaGetLastError() code of its launch (0 = success)
SIGNATURES = {
    # G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, F, N,
    # lamb, sign0, sign1, det_power, use_boson, stream
    "site_sweep_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _F, _F, _F, _I, _I, _P),
    # ... with the negative-weight statistics (C, 3) after nneg
    "site_sweep_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _D, _D, _D, _I, _I, _P),
    "site_sweep_pair_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _F, _F, _F, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, acc, nneg, Ml, Mr, C, F, N,
    # lamb, sign0, sign1, det_power, use_boson, wrap_dir, stream
    "site_sweep_wrap_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _F, _F, _F, _I, _I, _I, _P),
    # A, Q, R, B, N, stream
    "qr_f32": (_P, _P, _P, _I, _I, _P),
    "qr_f64": (_P, _P, _P, _I, _I, _P),
    # A, V, tau, R, B, N, stream
    "qr_vtau_f32": (_P, _P, _P, _P, _I, _I, _P),
    # A, R, B, N, stream (K15-noq)
    "qr_r_f32": (_P, _P, _I, _I, _P),
    # A, Q, R, B, N, stream (K15-backward)
    "qr_backward_f32": (_P, _P, _P, _I, _I, _P),
    # A, Q, R, B, N, KC (reflectors per block barrier), stream (K16)
    "qr_kcol_f32": (_P, _P, _P, _I, _I, _I, _P),
    # A, mx, Q, Rs, d, B, N, stream
    "udt_qr_f32": (_P, _P, _P, _P, _P, _I, _I, _P),
    # A, Z, mx, Q, X, B, N, stream
    "udt_qr_solve_f32": (_P, _P, _P, _P, _P, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, acc, nneg, scratch, C, F, N (G's
    # row length), NS (sites), DK, CS, lamb, sign0, sign1, det_power,
    # use_boson, stream
    "site_sweep_delayed_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, _F, _F, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg, scratch, C, F, N,
    # NS, DK, CS, P (column passes), lamb, sign0, sign1, det_power,
    # use_boson, stream
    "site_sweep_delayed_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _D, _D, _D, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg, C, F, N, NS, CS,
    # TR (thread rows), lamb, sign0, sign1, det_power, use_boson, stream:
    # the rank-1 layout at dk = 1
    "site_sweep_delayed_f64_rank1": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _D, _D, _D, _I, _I, _P),
    # F, N, CS, TR, out (int*)
    "site_sweep_delayed_f64_rank1_max_clusters": (_I, _I, _I, _I, _P),
    # F, N, DK, CS, out (int*): the cluster layout's occupancy
    "site_sweep_delayed_f32_max_clusters": (_I, _I, _I, _I, _P),
    # F, N, DK, CS, P, out (int*)
    "site_sweep_delayed_f64_max_clusters": (_I, _I, _I, _I, _I, _P),
    # A, Q, R, work, B, N, CS, stream
    "qr_blocked_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, accept, det, C, F, N,
    # lamb, sign0, sign1, det_power, use_boson, stream
    "site_sweep_cx_c64": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _F, _F, _F, _I, _I, _P),
    "site_sweep_cx_c128": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _D, _D, _D, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, accept, det, C, F, N, NP (the
    # layout's row length), CS, TR (thread rows), KR (register rows), lamb,
    # sign0, sign1, det_power, use_boson, stream: K8-c128 past N = 64
    "site_sweep_cx_c128_rank1": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _D, _D, _D, _I, _I, _P),
    # F, NP, CS, TR, KR, out (int*)
    "site_sweep_cx_c128_rank1_max_clusters": (_I, _I, _I, _I, _I, _P),
    # A, Q, R, B, N, stream
    "qr_cx_c64": (_P, _P, _P, _I, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, accept, det, scratch, C, F, N (G's
    # row length), NS (sites), DK, CS, P (column passes), S (flavor stages),
    # lamb, sign0, sign1, det_power, use_boson, stream
    "site_sweep_delayed_cx_c64": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _F, _F, _F, _I, _I,
                                  _P),
    # F, N, DK, CS, P, S, out (int*)
    "site_sweep_delayed_cx_c64_max_clusters": (_I, _I, _I, _I, _I, _I, _P),
    # ... complex128
    "site_sweep_delayed_cx_c128": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _D, _D, _D, _I,
                                   _I, _P),
    "site_sweep_delayed_cx_c128_max_clusters": (_I, _I, _I, _I, _I, _I,
                                                _P),
    # G_in, G_out, sigma_in, sigma_out, u, accept, det, C, F, N, NS, CS, TR,
    # lamb, sign0, sign1, det_power, use_boson, stream
    "site_sweep_delayed_cx_c128_rank1": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _D, _D, _D, _I, _I,
                                         _P),
    "site_sweep_delayed_cx_c128_rank1_max_clusters": (_I, _I, _I, _I, _P),
    # G_in, G_out, sigma_in, sigma_out, u, accept, det, C, N, NS, DK, P
    # (column passes), R (row passes), lamb, sign0, sign1, det_power,
    # use_boson, stream: K9-c128 at F = 2, one flavor a block
    "site_sweep_delayed_cx_c128_flavors": (_P, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _I, _I, _I, _D, _D, _D,
                                           _I, _I, _P),
    # N, DK, P, R, out (int*)
    "site_sweep_delayed_cx_c128_flavors_max_clusters": (_I, _I, _I, _I, _P),
    # conf_in, conf_out, u, table, order, offsets, masks, thr, acc, C, N,
    # z, n_classes, split (two classes of 32 and N - 32 positions), stream
    "ising_sweep_i8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _P),
    # conf, in_cluster, frontier, seed_spin, u, rev, in_out, front_out,
    # scratch, status, p_add, C, N, z, zr, Lb (levels), stream
    "wolff_step_u8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _D, _I, _I,
                      _I, _I, _I, _P),
    # dst (host), n_blocks, stream: the phase stamps of the last launch
    "site_sweep_delayed_f32_stamps": (_P, _I, _P),
    "site_sweep_delayed_cx_c64_stamps": (_P, _I, _P),
    "site_sweep_delayed_f64_stamps": (_P, _I, _P),
    "site_sweep_delayed_cx_c128_stamps": (_P, _I, _P),
    "qr_cx_c64_stamps": (_P, _I, _P),
    "qr_blocked_f32_stamps": (_P, _I, _P),
    "site_sweep_f32_stamps": (_P, _I, _P),
    "site_sweep_cx_c64_stamps": (_P, _I, _P),
    "udt_qr_f32_stamps": (_P, _I, _P),
    "udt_qr_solve_f32_stamps": (_P, _I, _P),
    "qr_f64_stamps": (_P, _I, _P),
    "qr_f32_stamps": (_P, _I, _P),
    "site_sweep_wrap_f32_stamps": (_P, _I, _P),
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


def compile_command(nvcc: str, source: Path, output: Path) -> list:
    """nvcc for one source file into one object file."""
    return [nvcc, *NVCC_FLAGS, *DEFINES, "-c", str(source), "-o", str(output)]


def link_command(nvcc: str, objects, output: Path) -> list:
    """nvcc linking the object files into the shared library."""
    return [nvcc, "-shared", "-o", str(output), *map(str, objects)]


def headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def build_dir() -> Path:
    return BUILD_DIR / "defines" if DEFINES else BUILD_DIR


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + DEFINES).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libmctorch_{h.hexdigest()[:16]}.so"


def use_defines(*defines: str):
    """Build and load the kernels with these extra -D flags from now on in
    this process (no flags: the kernels as they ship)."""
    global DEFINES
    DEFINES = tuple(defines)
    load.cache_clear()


def _run(procs):
    """Wait for every nvcc process; raise with the first failure's output."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out, err)
    if failed is not None:
        cmd, code, out, err = failed
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists:
    one nvcc process per source, all started together, then one link.
    Builds in a fresh temporary directory and renames the library into
    place, so concurrent builds never load a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = []
        for src, obj in zip(sources(), objs):
            cmd = compile_command(nvcc, src, obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        _run(procs)
        out = Path(tmp) / lib.name
        cmd = link_command(nvcc, objs, out)
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(out, lib)
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
