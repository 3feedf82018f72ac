"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``.  All sources are built
in parallel — one ``nvcc`` per source, started together — at the first
call of any kernel, into ``_build/<hash>/`` beside this package, where
``<hash>`` digests every source and the compile flags: a changed source
rebuilds, an unchanged one loads.  Nothing here runs at import time, so
the CPU tests import every module without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}     # per-source nvcc output (ptxas report)


def sources() -> list[pathlib.Path]:
    """Every kernel source in ``csrc/`` (one library each)."""
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Digest of every ``.cu``/``.cuh`` source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on a machine with the CUDA toolkit")
    return found


def build_all() -> pathlib.Path:
    """Build every source that is not built yet; return the directory.

    Concurrent callers serialize on a lock file; each library is
    written under a temporary name and renamed into place.
    """
    out = BUILD_ROOT / source_hash()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in sources() if not (out / f"lib{s.stem}.so").exists()]
        if todo:
            nvcc = find_nvcc()
            t0 = time.perf_counter()
            procs = []
            for src in todo:
                tmp = out / f"lib{src.stem}.so.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, tmp, proc in procs:
                log, _ = proc.communicate()
                BUILD_LOG[src.name] = log
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log}")
                else:
                    os.replace(tmp, out / f"lib{src.stem}.so")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            BUILD_LOG["_seconds"] = f"{time.perf_counter() - t0:.3f}"
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building every kernel at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _LIBS[name]
