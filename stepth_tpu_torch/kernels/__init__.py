"""Build, load and launch the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into one shared
library with a plain C interface, loaded through ``ctypes``. The build runs
at the first CUDA launch, never at import (importing the package needs no
``nvcc``), into ``stepth_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and the flags: a changed source rebuilds, an unchanged one loads.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; :meth:`Kernel.launch` raises on a
non-zero code and counts the launch. There is no fallback: a missing
toolchain or a failed build raises.

Each :class:`Kernel` records itself in :data:`REGISTRY` under the short key
the tools print (``K1`` … ``K11``, ``K2 plan``, ``census``);
:func:`registry` returns every kernel of the package, in key order.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pathlib
import pkgutil
import shutil
import subprocess
import threading
import time
from typing import Optional, Sequence

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libstepth_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}  # set by load(): path, seconds, built, ptxas log
REGISTRY: dict = {}  # key -> Kernel, filled as each module defines its kernels


def _sources() -> Sequence[pathlib.Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise on the first that fails. Returns
    their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]  # waits for every process
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _build(out: pathlib.Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs, compiles = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out.with_name(f"{src.stem}.{tag}.o")
        objs.append(str(obj))
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    log = _run_all(compiles)
    tmp = out.with_name(f"{out.name}.{tag}")
    log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]])
    for obj in objs:
        os.remove(obj)
    (out.parent / "build.log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = BUILD_ROOT / source_hash() / LIB_NAME
        t0 = time.perf_counter()
        built = not path.exists()
        log = _build(path) if built else (path.parent / "build.log").read_text()
        lib = ctypes.CDLL(str(path))
        lib.stepth_error_string.argtypes = [ctypes.c_int]
        lib.stepth_error_string.restype = ctypes.c_char_p
        build_info.update(
            path=str(path), built=built, ptxas=log,
            seconds=time.perf_counter() - t0,
        )
        _lib = lib
        return lib


# C argument kinds for Kernel signatures
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Kernel:
    """One exported C launcher: its key in :data:`REGISTRY`, its signature,
    where its source lives, which TPU kernel it replaces, and ``launches``,
    the number of times it was launched (a plain counter; callers may reset
    it to 0)."""

    def __init__(self, key: str, name: str, symbol: str, argtypes, source: str,
                 replaces: str):
        if key in REGISTRY:
            raise ValueError(f"kernel key {key!r} is already registered")
        REGISTRY[key] = self
        self.key = key
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            msg = load().stepth_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({rc}: {msg})")
        self.launches += 1


def registry() -> dict:
    """Every kernel of the package, ``key: Kernel``, in the order ``K1``,
    ``K2``, ``K2 emit`` … ``K11``, ``census``. Imports each module of the
    package first, so the answer does not depend on what the caller
    imported."""
    for mod in pkgutil.walk_packages([str(PKG_DIR)], "stepth_tpu_torch."):
        if not mod.name.endswith("__main__"):
            importlib.import_module(mod.name)
    return dict(sorted(REGISTRY.items(), key=lambda kv: (len(kv[0].split()[0]), kv[0])))


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
