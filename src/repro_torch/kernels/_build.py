"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``<repo>/build/repro_torch_kernels/`` at first use, then loaded with
``ctypes``. Libraries are named by a hash of their source, so an edited
source rebuilds and an unchanged one is reused. Only sources in the
checkout are built; nothing is fetched.

``build_all()`` starts one ``nvcc`` per source at once (the build is
part of a run's set-up time); ``library(name)`` builds one on demand.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

#: ctypes signatures of the C entry points (pointers and the stream as
#: c_void_p, so 64-bit addresses are never cut to an int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_attention": ("paged_attention_bf16",
                        [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
    "flash_prefill": ("flash_prefill_bf16",
                      [_P] * 5 + [_I] * 8 + [_F, _P]),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, job) -> None:
    proc, tmp, out, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n"
                           f"{text[-4000:]}")
    os.replace(tmp, out)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    sym, argtypes = SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    if name == "paged_attention":
        lib.paged_attention_split_tokens.argtypes = []
        lib.paged_attention_split_tokens.restype = ctypes.c_int
    return lib


def build_all() -> dict:
    """Compile every kernel source at once (one nvcc each, in parallel)
    and load them. Returns {name: seconds of the whole build}."""
    t0 = time.monotonic()
    with _lock:
        jobs = {n: _start(n) for n in SIGNATURES if n not in _libs}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
        for n in jobs:
            _libs[n] = _load(n)
    return {"seconds": time.monotonic() - t0, "built": sorted(jobs)}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = _libs[name] = _load(name)
        return lib


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said about one kernel's build (registers,
    shared memory, spills); empty if the library was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` from a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
