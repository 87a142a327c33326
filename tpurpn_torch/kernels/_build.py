"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers: seconds to build, not minutes)
under ``build/tpurpn_torch/`` at the repository root, keyed on the sources'
content and the flags, and is loaded with ``ctypes``. Pointers and the CUDA
stream cross as ``c_void_p``. Every C entry returns ``cudaGetLastError()``
(or the first error before the launch); ``check`` raises on a non-zero code.

``-fmad=false``: no multiply-add is contracted into an FMA, so the IoU of
the proposal, target and NMS kernels rounds op for op as ``tpurpn``'s; no
fast math, so division is IEEE.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpurpn_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signature of every exported entry: (argtypes), restype is int
SIGNATURES = {
    "proposal": {
        "proposal_select": (P, P, P, P, P, P, I, I, I, I, F, P),
        "proposal_select_levels": (P, P, P, P, P, P, P, I, I, I, I, F, P),
    },
    "ir_stage": {
        "ir_block": (P, P, P, I, I, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
        "ir_expand": (P, P, P, I, I, P, I, I, I, I, P),
    },
    "targets": {
        "iou_matching": (P, P, P, P, P, I, I, I, P),
        "rpn_targets": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, I, I,
                        F, F, F, F, P),
        "targets_cluster_size": (I,),
    },
    "nms": {
        "nms_keep": (P, P, P, P, P, P, I, I, I, I, I, F, P),
    },
    "prefix": {
        "prefix_pointwise": (P, P, P, P, I, P, I, I, I, I, P),
        "prefix_depthwise": (P, P, P, P, I, I, I, I, I, P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _key(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_key(name)}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process, temporary output, final path), or None when built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, out


def build(names: Iterable[str]) -> None:
    """Build the named kernels, one nvcc per source, all started together."""
    started = [(n, _start(n)) for n in names]
    failed = []
    for name, job in started:
        if job is None:
            continue
        proc, tmp, out = job
        if proc.wait() != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    if failed:
        logs = "\n".join(
            library_path(n).with_suffix(".log").read_text() for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) of the build."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = (ctypes.c_int,)
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")
