"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the
package, then loaded with ``ctypes``.  The hash covers the source, the
headers it may include (``csrc/*.cuh``) and the flags, so an edited source
is rebuilt and a stale library is never loaded.
Nothing is built at import time: the CPU tests import every module on a
machine without ``nvcc``.

Several processes may reach a kernel's first use at once (the ranks of a
job on one host).  Each build holds an exclusive lock on
``_build/<library>.lock`` while it checks for the library and compiles it,
so one process builds and the others wait and load its result; the library
is written under a temporary name and renamed into place, so no process
ever loads a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
#: name -> seconds ``nvcc`` took, for the builds this process ran.
build_seconds: Dict[str, float] = {}
#: name -> what ``nvcc`` printed (``-Xptxas -v``: registers, shared memory,
#: spills per kernel), for the builds this process ran.
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin; "
            "the port's CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Build output of ``csrc/<name>.cu``, named by a hash of the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        # Released when the file closes, also when the process dies.
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():     # another process built it while we waited
            return out
        return _run_nvcc(name, out)


def _run_nvcc(name: str, out: Path) -> Path:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                      str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    # Atomic publish: a concurrent process never loads a half-written file.
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = _libraries[name] = ctypes.CDLL(str(_compile(name)))
        return lib


def compile_all(names: Iterable[str]) -> None:
    """Compile several sources at once, one ``nvcc`` each, all started
    together; :func:`library` then loads them without building."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(_compile, name) for name in names]:
            future.result()
