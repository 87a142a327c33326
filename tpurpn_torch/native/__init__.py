"""Native (C++) batch generator of the synthetic dataset, bound with ctypes
(port of ``tpurpn/native/__init__.py``).

``dataloader.cpp`` is the port's own copy of ``tpurpn``'s OpenMP generator
(the role the reference gives tf.data's C++ workers, SURVEY.md §2 row 7). It
is compiled on first use with ``g++ -O3 -fopenmp -shared -fPIC -std=c++17``
into ``build/tpurpn_torch/`` at the repository root, beside the CUDA
libraries, under a name that holds the source's hash; nothing is written
beside the source. Same flags, same source: the same bytes as
``tpurpn.native.generate_batch`` for every (seed, index).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "dataloader.cpp"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The binary's name holds the source's crc32: a library built from
    another source is never loaded."""
    digest = zlib.crc32(SRC.read_bytes()) & 0xFFFFFFFF
    return BUILD_DIR / f"libtpurpn_data-{digest:08x}.so"


def build() -> Path:
    """Compile the generator unless a binary of this source exists: to a
    per-process temporary name, then an atomic rename, so concurrent builds
    never expose a half-written library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def load_library():
    """Build (if needed) and load the generator; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tpurpn_generate_batch.argtypes = [
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.tpurpn_generate_batch.restype = None
            lib.tpurpn_loader_version.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the generator builds and loads here (g++ with OpenMP)."""
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def generate_batch(
    seed: int,
    indices: np.ndarray,
    raw_h: int,
    raw_w: int,
    max_boxes: int,
    min_boxes: int,
    num_classes: int,
):
    """Generate a synthetic detection batch natively (parallel across cores).

    Returns (imgs u8 (B,H,W,3), boxes f32 (B,max_boxes,4), labels i32
    (B,max_boxes)), the format of ``data.SyntheticVOC``, deterministic per
    (seed, index) under the generator's own RNG (not the Python sampler's).
    """
    if not (raw_h > 0 and raw_w > 0 and 0 <= min_boxes <= max_boxes and num_classes > 0):
        raise ValueError(f"bad generator shape: {raw_h}x{raw_w}, boxes "
                         f"{min_boxes}..{max_boxes}, {num_classes} classes")
    lib = load_library()
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    B = len(idx)
    imgs = np.empty((B, raw_h, raw_w, 3), np.uint8)
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    labels = np.empty((B, max_boxes), np.int32)
    lib.tpurpn_generate_batch(
        ctypes.c_uint64(seed),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, raw_h, raw_w, max_boxes, min_boxes, num_classes,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return imgs, boxes, labels
