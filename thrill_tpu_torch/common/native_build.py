"""Build the port's native code from source and load it with ctypes.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface (no PyTorch headers, so
a build takes seconds). The library name embeds the SHA-256 of the
source, so an edited source is never served by a stale binary. Builds
land through a temporary file and a rename, under an exclusive file lock
beside the library (``<library>.lock``, ``fcntl.flock``): processes that
build at once, as the ranks of a multi-process mesh on one machine do,
make each library once, and the others wait for it and load it. Nothing
is built when a module is imported: the first launch of a kernel builds
it, and :func:`build_all` builds every source at once, one ``nvcc``
process per source, all started together.

Host C++ (``native/<name>.cpp``, the spill store) takes the other
route, :func:`load_host`: ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
at first use, named by the source's hash in the same directory. A failed
host build prints the compiler's message on stderr once, and the caller
takes its Python version.

The build directory (``thrill_tpu_torch/_build/``) is listed in
``.gitignore``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

CSRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "csrc"))
NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                          "native"))
BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "_build"))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler messages of the builds made by this process (ptxas register
# and shared-memory reports), keyed by source name
build_logs: Dict[str, str] = {}
# the host libraries this process compiled itself (not found built)
host_builds: List[str] = []


@contextlib.contextmanager
def _file_locks(outs: Sequence[str]):
    """Hold the exclusive build lock of every library in ``outs``, taken
    in sorted order so two processes building overlapping sets cannot
    deadlock."""
    with contextlib.ExitStack() as stack:
        for out in sorted(set(outs)):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            f = stack.enter_context(open(out + ".lock", "a"))
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            stack.callback(fcntl.flock, f.fileno(), fcntl.LOCK_UN)
        yield


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
    missing = [n for n in names if not os.path.exists(outs[n])]
    if not missing:
        return outs
    with _lock, _file_locks([outs[n] for n in missing]):
        # another process may have built them while this one waited
        procs = {n: _start(n, outs[n]) for n in missing
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


HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_host_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def load_host(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of ``native/<name>.cpp``, built with ``g++``
    first if needed; None (and the compiler's message on stderr, once)
    when it cannot be built."""
    with _lock:
        if name in _host_libs:
            return _host_libs[name]
        src = os.path.join(NATIVE_DIR, name + ".cpp")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        lib = None
        try:
            if not os.path.exists(out):
                with _file_locks([out]):
                    if not os.path.exists(out):
                        tmp = f"{out}.tmp.{os.getpid()}"
                        proc = subprocess.run(
                            [shutil.which("g++") or "g++", *HOST_FLAGS,
                             src, "-o", tmp], capture_output=True,
                            text=True, timeout=300)
                        if proc.returncode != 0:
                            raise RuntimeError(proc.stderr or proc.stdout)
                        os.replace(tmp, out)
                        host_builds.append(name)
            lib = ctypes.CDLL(out)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            print(f"thrill_tpu_torch: building native/{name}.cpp failed; "
                  f"the Python version runs instead:\n{e}",
                  file=sys.stderr)
        _host_libs[name] = lib
        return lib
