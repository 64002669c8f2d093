"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. Libraries land in
``distar_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the source, the headers and the flags, so an edited source or
header rebuilds and an unchanged one is reused. Nothing builds at import: a
kernel's library is built at its first launch, or all of them at once (one
``nvcc`` per source, started together) by :func:`build`.
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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("masked_attention", "scatter_add_connection", "scatter_add_onehot")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, every header in ``csrc/``
    (a source may include any of them) and the flags."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all in parallel.
    Returns {name: seconds} for the ones built; the compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``. Raises with the compiler's output on failure."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        Path(f"{out}.log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if missing; C signatures set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, f"{name}_fwd")
            P, I = ctypes.c_void_p, ctypes.c_int
            if name == "masked_attention":
                fn.argtypes = [P, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, P]
            elif name == "scatter_add_connection":  # with a bfloat16 flag
                fn.argtypes = [P, P, P, I, I, I, I, I, P]
            else:
                fn.argtypes = [P, P, P, I, I, I, I, P]
            fn.restype = I
            _libs[name] = lib
        return lib
