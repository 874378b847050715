"""Build and load the port's CUDA kernels (no counterpart in the JAX
package).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``paddle_tpu_torch/_build/``
(git-ignored), then loaded with ``ctypes`` — route (b) of the
hopper-kernels guide: no PyTorch headers, so a build takes seconds.
The output name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a stale library is never loaded. All sources are
compiled by parallel ``nvcc`` processes on the first ``load``.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: every kernel source of the package, built together on first use
SOURCES = ("flash_attention_fwd", "flash_attention_fwd_tc",
           "flash_attention_bwd", "flash_attention_bwd_dq_tc",
           "flash_attention_bwd_dkv_tc", "flash_attention_bwd_single_tile_tc",
           "ragged_paged_attention", "int8_matmul")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together. Raises with the compiler's
    output when one fails. Returns ``{name: library path}``."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (building all sources
    on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build(SOURCES if name in SOURCES else (name,))
            lib = ctypes.CDLL(str(paths[name]))
            _libs[name] = lib
        return lib
