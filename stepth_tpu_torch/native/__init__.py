"""The native host engine through ctypes (twin of ``stepth_tpu/native``).

``engine.cc`` (the port's copy of the JAX package's C++ engine) is the
reference pipeline's hot loops in C++ with a thread pool: subdivision and
ring search (:func:`raw_disparity`, :func:`depth_from_additional`), a
hierarchical matcher (:func:`hier_disparity`) and SGM
(:func:`sgm_disparity`). It runs on the host by design, only where a caller
names it (``depth --backend native``, ``DepthFrame`` method ``"native"``),
and takes and returns numpy arrays (tensors are copied to the host).

It is built with ``g++`` at first use, never at import, into
``stepth_tpu_torch/_build/native-<hash>/`` (the hash of the source and the
flags), apart from the JAX package's ``$TMPDIR/stepth_native_engine.so``: a
changed source rebuilds, an unchanged one loads. The build writes a file
named for its process and renames it into place, so processes that build
at once (test workers) each load a whole library. A failed build raises
with the compiler's message; nothing falls back to the oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from stepth_tpu_torch.oracle.resize import resample_exact_np

SRC = pathlib.Path(__file__).resolve().parent / "engine.cc"
BUILD_ROOT = SRC.parent.parent / "_build"
LIB_NAME = "libstepth_torch_native.so"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "stepth_raw_disparity": [P, P, I, I, I, I, P, I, I, I, I, P],
    "stepth_sgm_disparity": [P, P, I, I, I, I, F, F, I, F, I, I, P, P],
    "stepth_hier_disparity": [P, P, I, I, I, I, I, I, I, P],
}


def lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def _build(out: pathlib.Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native engine: g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native engine: g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The engine, built first if its source changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _lib = lib
        return _lib


def _host(x, dtype) -> np.ndarray:
    """``x`` (array or tensor, any device) as a contiguous host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed rc={rc}")


def raw_disparity(main_rgb, add_rgb, precision, min_splits: int = 16,
                  max_splits: Optional[int] = None, max_radius: int = 255,
                  n_threads: int = 8) -> np.ndarray:
    """The per-pixel matched distance wrapped to u8, before normalisation
    (``oracle.pipeline.raw_disparity_map``)."""
    main_rgb, add_rgb = _host(main_rgb, np.uint8), _host(add_rgb, np.uint8)
    h, w, _ = main_rgb.shape
    ah, aw, _ = add_rgb.shape
    prec = np.ascontiguousarray(np.asarray(precision, dtype=np.int32).reshape(3))
    out = np.empty((h, w), dtype=np.uint8)
    _check(load().stepth_raw_disparity(
        main_rgb.ctypes.data, add_rgb.ctypes.data, h, w, ah, aw, prec.ctypes.data,
        int(min_splits), -1 if max_splits is None else int(max_splits), int(max_radius),
        int(n_threads), out.ctypes.data), "stepth_raw_disparity")
    return out


def depth_from_additional(main_rgb, add_rgb, precision, min_splits: int = 16,
                          max_splits: Optional[int] = None, max_radius: int = 255,
                          n_threads: int = 8) -> np.ndarray:
    """The whole flow: C++ subdivision and ring search, then the oracle's
    max-normalisation (all zero where the max is 0, quirk Q3) and
    same-size Gaussian resample. u8 ``[H, W]``."""
    raw = raw_disparity(main_rgb, add_rgb, precision, min_splits, max_splits, max_radius,
                        n_threads)
    m = int(raw.max())
    norm = (np.zeros_like(raw) if m == 0
            else ((raw.astype(np.uint64) * 255) // m).astype(np.uint8))
    return resample_exact_np(norm, raw.shape[0], raw.shape[1], "gaussian")


def hier_disparity(left, right, levels: int = 4, coarsest_disparities: int = 16,
                   refine_radius: int = 4, window: int = 9, n_threads: int = 8) -> np.ndarray:
    """The multithreaded C++ hierarchical matcher (coarse dense SAD, then
    per-level refinement): disparity f32 ``[H, W]``."""
    left, right = _host(left, np.float32), _host(right, np.float32)
    h, w = left.shape
    out = np.empty((h, w), dtype=np.float32)
    _check(load().stepth_hier_disparity(
        left.ctypes.data, right.ctypes.data, h, w, int(levels), int(coarsest_disparities),
        int(refine_radius), int(window), int(n_threads), out.ctypes.data),
        "stepth_hier_disparity")
    return out


def sgm_disparity(left, right, num_disparities: int = 64, window: int = 5, p1: float = 8.0,
                  p2: float = 32.0, directions: int = 4, lr_threshold: Optional[float] = 1.0,
                  subpixel: bool = True, n_threads: int = 8):
    """The multithreaded C++ SGM (the ``sgm`` backend's pipeline; on
    u8-valued gray inputs every intermediate is an exact small integer in
    f32): ``(disparity f32[H, W], valid bool[H, W])``."""
    left, right = _host(left, np.float32), _host(right, np.float32)
    h, w = left.shape
    disp = np.empty((h, w), dtype=np.float32)
    valid = np.empty((h, w), dtype=np.uint8)
    _check(load().stepth_sgm_disparity(
        left.ctypes.data, right.ctypes.data, h, w, int(num_disparities), int(window),
        float(p1), float(p2), int(directions), -1.0 if lr_threshold is None else
        float(lr_threshold), 1 if subpixel else 0, int(n_threads), disp.ctypes.data,
        valid.ctypes.data), "stepth_sgm_disparity")
    return disp, valid.astype(bool)
