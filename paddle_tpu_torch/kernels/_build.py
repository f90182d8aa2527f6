"""Build the CUDA sources in ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``kernels/_build/lib<name>-<hash>.so`` with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

at first use. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds
anew and an unchanged one loads the library already built. The
compiler's output (ptxas's registers, shared memory and spills of every
kernel) and the build's seconds are kept beside the library as
``lib<name>-<hash>.so.log``; `build_report` reads them.
`build_all` starts one ``nvcc`` per source, all at once, and waits for
all of them. A build or load failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels build from source at first use")
    return found


def _lib_path(name: str) -> str:
    files = [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                    if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; None when it is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job):
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as fh:
        fh.write(f"build seconds {seconds:.1f}\n{log}")
    os.replace(tmp, out)   # atomic: a reader never sees a partial .so


def build_report(name: str) -> str:
    """The build's seconds and ptxas's lines for ``csrc/<name>.cu`` as
    built (empty when it has not been built here)."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def build_all(names=None):
    """Build every named source (default: all) in parallel."""
    names = sources() if names is None else list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
        return lib


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "build_report",
           "load", "sources"]
