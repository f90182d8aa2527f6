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
A variant (`VARIANTS`) is a source built again with its own defines
into a library of its own name: the ``_f16`` flash libraries are the
flash sources built with ``-DPTT_F16``, their tensor-core kernels on
float16 (``csrc/flash_common.cuh``); the paged source is built once a
query dtype (``paged_attention`` float32, ``paged_attention_bf16``,
``paged_attention_f16``), each against every page type. `SOURCE_FLAGS`
adds flags to every library of one source.
`build_all` starts one ``nvcc`` per library, all at once, and waits for
all of them, timing each to its own exit (the compiler writes to a file
beside the library, so no pipe can fill and hold it). A build or load
failure raises; nothing falls back.
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

#: library name -> (source, extra nvcc flags)
VARIANTS = {
    "flash_attention_f16": ("flash_attention", ["-DPTT_F16"]),
    "flash_attention_qkv_f16": ("flash_attention_qkv", ["-DPTT_F16"]),
    "paged_attention_bf16": ("paged_attention", ["-DPTT_Q_BF16"]),
    "paged_attention_f16": ("paged_attention", ["-DPTT_Q_F16"]),
}

#: source -> nvcc flags of every library built from it. Each paged
#: library instantiates 50 kernels (5 page types x 10 widths and tiles);
#: one library of 60 took 140-190 s on one core, where the others take
#: about 30: ``--split-compile=0`` optimizes its device code in parallel
#: on every core.
SOURCE_FLAGS = {
    "paged_attention": ["--split-compile=0"],
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every library: each kernel source (``csrc/<name>.cu``)
    and each variant."""
    return sorted([f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu")]
                  + list(VARIANTS))


def source_and_flags(name: str):
    """``(source, extra nvcc flags)`` of library ``name``."""
    source, flags = VARIANTS.get(name, (name, []))
    return source, SOURCE_FLAGS.get(source, []) + flags


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
    source, flags = source_and_flags(name)
    files = [source + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                      if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
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
    source, flags = source_and_flags(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp,
           os.path.join(CSRC, source + ".cu")]
    with open(tmp + ".out", "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job):
    """Wait for one ``nvcc``: its seconds from start to exit and its
    output go to the library's log; the library takes its place."""
    proc, tmp, out, t0 = job
    proc.wait()
    seconds = time.perf_counter() - t0
    with open(tmp + ".out") as fh:
        log = fh.read()
    os.remove(tmp + ".out")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} "
                           f"(exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as fh:
        fh.write(f"build seconds {seconds:.1f}\n{log}")
    os.replace(tmp, out)   # atomic: a reader never sees a partial .so


def build_report(name: str) -> str:
    """The build's seconds and ptxas's lines for library ``name`` as
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
        jobs = {n: job for n in names if (job := _start(n)) is not None}
        try:
            while jobs:
                done = [n for n, job in jobs.items()
                        if job[0].poll() is not None]
                for n in done:
                    _finish(n, jobs.pop(n))
                if jobs and not done:
                    time.sleep(0.05)
        except BaseException:
            # a failed build stops the others it started
            for proc, *_ in jobs.values():
                proc.kill()
                proc.wait()
            raise


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a source or a variant), building it
    first if needed."""
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


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "SOURCE_FLAGS", "VARIANTS",
           "build_all", "build_report", "load", "source_and_flags",
           "sources"]
