"""Checkpoint / resume (twin of ``stepth_tpu/utils/checkpoint.py``).

The reference saves through Orbax when it is installed and falls back to a
NumPy ``.npz``; the port writes that ``.npz`` layout only: ``leaf_i`` for
the i-th leaf of the state in ``jax.tree`` order (dict keys sorted) and
``__meta__``, the metadata as JSON bytes. A path without ``.npz`` gets it
appended. State is any tree of tensors (on any device), arrays and
NamedTuples of them — typically a :class:`stepth_tpu_torch.fusion.ba.BAState`
or a dict of its fields.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from stepth_tpu_torch.utils.debug import named_leaves


# what reading a corrupt or truncated checkpoint can raise
READ_ERRORS = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state: Any, metadata: Optional[Dict] = None) -> None:
    """Save ``state`` to ``path`` (``.npz`` appended if missing), moving each
    leaf to the host. The file is written under a temporary name in the same
    directory and published by ``os.replace`` (atomic on POSIX), so a process
    killed mid-save never leaves a truncated checkpoint at ``path``."""
    arrays = {f"leaf_{i}": _host(leaf) for i, (_, leaf) in enumerate(named_leaves(state))}
    if metadata:
        arrays["__meta__"] = np.frombuffer(json.dumps(metadata).encode(), np.uint8)
    npz_path = _npz(path)
    tmp_path = npz_path + f".tmp.{os.getpid()}"
    try:
        with open(tmp_path, "wb") as f:  # a file object: np.savez keeps its name
            np.savez(f, **arrays)
        os.replace(tmp_path, npz_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


def _rebuild(like: Any, leaves: Iterator) -> Any:
    """A tree shaped as ``like`` whose leaves are taken from ``leaves`` in
    order; a leaf of ``like`` that is a tensor puts its restored leaf on that
    tensor's device, any other leaf restores as a numpy array."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, device=like.device)
    return arr


def restore(path: str, like: Any) -> Any:
    """Restore the checkpoint at ``path`` into a tree shaped as ``like``
    (required: the layout stores leaves, not the tree's structure)."""
    if like is None:
        raise ValueError("npz restore requires a `like` tree for structure")
    with np.load(_npz(path)) as data:
        n = sum(1 for _ in named_leaves(like))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(like, iter(leaves))


def metadata(path: str) -> Optional[Dict]:
    """The checkpoint's metadata, or None if it has none or cannot be read:
    a corrupt or truncated file reads as absent, so a resume loop restarts
    from scratch instead of failing on every relaunch."""
    npz_path = _npz(path)
    if not os.path.exists(npz_path):
        return None
    try:
        with np.load(npz_path) as data:
            if "__meta__" not in data:
                return None
            return json.loads(bytes(data["__meta__"]).decode())
    except READ_ERRORS:
        return None
