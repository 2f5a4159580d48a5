"""Build the port's CUDA kernels from source and load them with ctypes.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface (no PyTorch headers, so
a build takes seconds). The library name embeds the SHA-256 of the
source, so an edited source is never served by a stale binary. Builds
land through a temporary file and a rename, so concurrent builders race
safely. Nothing is built when a module is imported: the first launch of
a kernel builds it, and :func:`build_all` builds every source at once,
one ``nvcc`` process per source, all started together.

The build directory (``thrill_tpu_torch/_build/``) is listed in
``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

CSRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "csrc"))
BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "_build"))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler messages of the builds made by this process (ptxas register
# and shared-memory reports), keyed by source name
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Names (without ``.cu``) of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit's compiler")


def _artifact(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate(timeout=600)
    build_logs[name] = log
    tmp = f"{out}.tmp.{os.getpid()}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = ()) -> Dict[str, str]:
    """Build every named source (default: all of ``csrc/``) that has no
    current library, with all ``nvcc`` processes running at once.
    Returns {name: library path}."""
    names = list(names) or sources()
    outs = {n: _artifact(n) for n in names}
    with _lock:
        procs = {n: _start(n, outs[n]) for n in names
                 if not os.path.exists(outs[n])}
        for n, p in procs.items():
            _finish(n, outs[n], p)
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(path)
    return lib
