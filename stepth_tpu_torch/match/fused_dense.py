"""Fused exhaustive matcher: kernel K1 and its plain version (twin of
``stepth_tpu/match/pallas_dense.py:85-399``).

:func:`raw_match` launches the CUDA kernel for CUDA tensors and runs
:func:`raw_match_plain` for CPU tensors. Both compute, per pixel and over all
``d < D``: the SAD/SSD cost against the right image sampled at ``x − d``
(edge-replicated), a zero-padded ``window``² box sum, a first-minimum WTA with
parabolic subpixel for ``best ∈ [1, D−2]``, the optional uniqueness test and
the right-view WTA ``costR(x, d) = costL(x + d, d)``.

Census planes and the in-kernel LR sweep belong to the census+LR slice; both
paths raise ``NotImplementedError`` for them.
"""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig

_BIG = 1e30

K1 = kernels.Kernel(
    "K1 fused_dense",
    "stepth_fused_dense",
    [kernels.PTR] * 6 + [kernels.INT] * 6 + [kernels.FLOAT, kernels.INT, kernels.INT],
    source="stepth_tpu_torch/csrc/fused_dense.cu",
    replaces="stepth_tpu/match/pallas_dense.py:85",
)


def box_sum_ordered(x: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    """Valid-mode box sum of ``2·(win//2) + 1`` taps along ``dim`` (output
    ``2·(win//2)`` shorter), adding in the reference kernels' order: window 9
    as the exact two-stage 3×3 decomposition ``y(k) = (c(k) + c(k−1)) +
    c(k+1)``, ``z(k) = (y(k) + y(k−3)) + y(k+3)``; other windows left to
    right. The CUDA kernels use the same order (``csrc/common.cuh``)."""
    n = x.shape[dim]
    if win == 9:
        y = (x.narrow(dim, 1, n - 2) + x.narrow(dim, 0, n - 2)) + x.narrow(dim, 2, n - 2)
        m = n - 2
        return (y.narrow(dim, 3, m - 6) + y.narrow(dim, 0, m - 6)) + y.narrow(dim, 6, m - 6)
    taps = 2 * (win // 2) + 1
    out_n = n - taps + 1
    z = x.narrow(dim, 0, out_n)
    for j in range(1, taps):
        z = z + x.narrow(dim, j, out_n)
    return z


def _check_cfg(cfg: MatchConfig) -> None:
    if cfg.cost == "census":
        raise NotImplementedError(
            "census cost: ROADMAP slice 2 (census planes in K1/K2)"
        )
    if cfg.cost not in ("sad", "ssd"):
        raise NotImplementedError(f"fused matcher: cost {cfg.cost!r} unsupported")
    if cfg.lr_threshold is not None:
        raise NotImplementedError(
            "in-kernel LR sweep: ROADMAP slice 2 (K4 LR check); "
            "pass lr_threshold=None"
        )


def raw_match_plain(
    lg: torch.Tensor,
    rg: torch.Tensor,
    cfg: MatchConfig,
    tile_rows: int = 32,
    g_row0: int = 0,
    g_h: Optional[int] = None,
):
    """K1's plain version on gray f32[H, W] images, on any device. Returns
    ``(disp, disp_r, cbest, valid)``, all f32[H, W] (``valid`` is 1.0/0.0).
    ``g_row0``/``g_h``: global row window when the inputs are a halo-extended
    row shard (rows outside ``[0, g_h)`` contribute no cost). ``tile_rows``
    is kept for signature parity; the output does not depend on it."""
    _check_cfg(cfg)
    h, w = lg.shape
    D, win = cfg.num_disparities, cfg.window
    r = win // 2
    if g_h is None:
        g_h = h
    dev = lg.device
    gr = g_row0 + torch.arange(h, device=dev)
    row_ok = ((gr >= 0) & (gr < g_h))[:, None]
    x = torch.arange(w, device=dev)

    def full(v):
        return torch.full((h, w), v, dtype=torch.float32, device=dev)

    izero = torch.zeros((h, w), dtype=torch.int32, device=dev)
    best, cb, cp1, bestr = full(_BIG), full(_BIG), full(_BIG), full(_BIG)
    cm1, prev = full(0.0), full(0.0)
    runlag2, second = full(_BIG), full(_BIG)
    bestd, bestrd = izero, izero
    for d in range(D):
        diff = lg - rg[:, (x - d).clamp(min=0)]
        cost = diff * diff if cfg.cost == "ssd" else diff.abs()
        cost = torch.where(row_ok, cost, 0.0)
        padded = torch.nn.functional.pad(cost, (r, r, r, r))
        agg = box_sum_ordered(box_sum_ordered(padded, win, 0), win, 1)

        upd = agg < best
        is_next = ~upd & (bestd == d - 1)
        cm1 = torch.where(upd, prev, cm1)
        cb = torch.where(upd, agg, cb)
        cp1 = torch.where(is_next, agg, cp1)
        if cfg.uniqueness is not None:
            # second best outside the ±1 zone: restart from min over [0, d−2]
            # on a new best, else accumulate costs with d > bestd + 1
            far = ~upd & (d > bestd + 1)
            second = torch.where(upd, runlag2, second)
            second = torch.where(far, torch.minimum(second, agg), second)
            runlag2 = torch.minimum(runlag2, prev + (_BIG if d < 1 else 0.0))
        best = torch.where(upd, agg, best)
        bestd = torch.where(upd, d, bestd)

        aggr = full(_BIG)  # right view: costR(x, d) = costL(x + d, d)
        if d < w:
            aggr[:, : w - d] = agg[:, d:]
        updr = aggr < bestr
        bestr = torch.where(updr, aggr, bestr)
        bestrd = torch.where(updr, d, bestrd)
        prev = agg

    denom = cm1 - 2.0 * cb + cp1
    delta = torch.where(denom.abs() > 1e-6, (cm1 - cp1) / (2.0 * denom), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    interior = (bestd >= 1) & (bestd <= D - 2)
    bd = bestd.to(torch.float32)
    disp = torch.where(interior, bd + delta, bd)
    if cfg.uniqueness is None:
        valid = full(1.0)
    else:
        valid = (cb * (1.0 + cfg.uniqueness) <= second).to(torch.float32)
    return disp, bestrd.to(torch.float32), cb, valid


def raw_match(
    lg: torch.Tensor,
    rg: torch.Tensor,
    cfg: MatchConfig,
    tile_rows: int = 32,
    g_row0: int = 0,
    g_h: Optional[int] = None,
):
    """Fused exhaustive match of gray f32[H, W] images: K1 on CUDA tensors,
    :func:`raw_match_plain` on CPU tensors. Returns ``(disp, disp_r, cbest,
    valid)``, full-size and pre-epilogue."""
    if lg.device.type == "cpu":
        return raw_match_plain(lg, rg, cfg, tile_rows, g_row0, g_h)
    _check_cfg(cfg)
    kernels.check_cuda_tensor("raw_match left", lg, torch.float32, 2)
    kernels.check_cuda_tensor("raw_match right", rg, torch.float32, 2)
    if rg.shape != lg.shape or rg.device != lg.device:
        raise ValueError(f"left {tuple(lg.shape)} / right {tuple(rg.shape)} differ")
    h, w = lg.shape
    D = cfg.num_disparities
    if D < 1 or cfg.window < 1:
        raise ValueError(f"need D ≥ 1 and window ≥ 1, got {D}, {cfg.window}")
    outs = [torch.empty_like(lg) for _ in range(4)]
    uniq = cfg.uniqueness
    K1.launch(
        lg.device, lg.data_ptr(), rg.data_ptr(), *(o.data_ptr() for o in outs),
        h, w, D, cfg.window, int(cfg.cost == "ssd"), int(uniq is not None),
        1.0 + (uniq or 0.0), int(g_row0), h if g_h is None else int(g_h),
    )
    return tuple(outs)
