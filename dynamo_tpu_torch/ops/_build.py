"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles each source under ``dynamo_tpu_torch/csrc/`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), inside ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The library name carries a hash of its source, so an
edited kernel is rebuilt and a stale one is never loaded; the hash also
covers the shared headers (``csrc/*.cuh``), so an edit there rebuilds
every library.  Nothing here
runs at import time: the CPU tests import every module, on machines that
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_attention.cu", "grouped_gemm.cu", "kv_transfer.cu",
           "vision_attention.cu", "ring_attention.cu")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per source: seconds the build took (0.0 when the library was already
# built) and the compiler's register/shared-memory report (-Xptxas -v)
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(source: str) -> str:
    h = hashlib.sha1()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _build_one(source: str) -> str:
    out = _lib_path(source)
    if os.path.exists(out):
        build_info[source] = {"seconds": 0.0, "ptxas": ""}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    build_info[source] = {"seconds": time.perf_counter() - t0,
                          "ptxas": proc.stderr}
    return out


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source (one `nvcc` each, all started together) and
    load the libraries; later calls return the loaded ones."""
    with _lock:
        missing: List[str] = [s for s in SOURCES if s not in _libs]
        if missing:
            with ThreadPoolExecutor(max_workers=len(missing)) as ex:
                paths = list(ex.map(_build_one, missing))
            for src, path in zip(missing, paths):
                _libs[src] = ctypes.CDLL(path)
        return dict(_libs)


def load(source: str) -> ctypes.CDLL:
    return build_all()[source]
