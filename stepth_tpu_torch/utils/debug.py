"""Numerical-safety checks (twin of ``stepth_tpu/utils/debug.py``).

* ``checked(fn)``   — run ``fn`` and raise ``FloatingPointError`` naming the
                      first floating output leaf that holds NaN or ±inf;
* ``assert_finite`` — raise ``AssertionError`` if any floating leaf of a
                      tree holds NaN or ±inf.

The reference's ``checked`` is ``checkify``, which also stops at an
out-of-bounds index and an integer division by zero inside the program.
Torch has no such instrumentation, so ``checked`` looks only at the
outputs and catches neither: an index past the end raises its own error on
the CPU and a device-side assert on the card, and an integer division by
zero raises on the CPU and gives an unspecified value on the card. A NaN
that the function computes and then drops (masked out by ``torch.where``)
is not seen either. The reference's ``interpret_kernels`` has no
counterpart: a CUDA kernel has no interpreter mode, and each kernel's plain
version is what runs on CPU tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def named_leaves(tree: Any, name: str = "output") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts (keys sorted, as
    ``jax.tree`` orders them), lists, tuples and NamedTuples; ``None`` has
    no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{name}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field, v in zip(tree._fields, tree):
            yield from named_leaves(v, f"{name}.{field}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{name}[{i}]")
    else:
        yield name, tree


def _non_finite(leaf) -> int:
    """How many NaN/±inf values a floating leaf holds (0 for other leaves)."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return 0
        return int((~torch.isfinite(leaf)).sum())
    arr = np.asarray(leaf)
    if arr.dtype.kind != "f":
        return 0
    return int((~np.isfinite(arr)).sum())


def checked(fn: Callable) -> Callable:
    """Return a wrapped ``fn`` that raises ``FloatingPointError`` when a
    floating output leaf holds NaN or ±inf (see the module docstring for
    what it cannot catch). Call it exactly like ``fn``."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for name, leaf in named_leaves(out):
            bad = _non_finite(leaf)
            if bad:
                raise FloatingPointError(f"{getattr(fn, '__name__', 'fn')}: {name} holds "
                                         f"{bad} NaN/inf value(s)")
        return out

    wrapped.__name__ = getattr(fn, "__name__", "checked")
    return wrapped


def assert_finite(tree: Any, name: str = "value") -> None:
    """Raise ``AssertionError`` if any leaf of ``tree`` holds NaN/inf."""
    for i, (_, leaf) in enumerate(named_leaves(tree)):
        bad = _non_finite(leaf)
        if bad:
            raise AssertionError(f"{name}: leaf {i} has {bad} non-finite values")
