"""Coarse-to-fine matching in plain torch (twin of
``stepth_tpu/match/pyramid.py``): the pyramid helpers, shared with the
kernel pipeline of ``fused_refine``, and the ``hierarchical`` backend
(:func:`match_hierarchical`), whose refine levels are gathers and box sums
over every planned candidate (:func:`_refine_level`), as the reference keeps
them in plain XLA."""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import dense


def downsample2(gray: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, odd trailing row/col dropped. Same add order as the
    reference ((top + bottom), then (left + right), then × 0.25), so the two
    agree bit for bit."""
    h, w = gray.shape
    g = gray[: h // 2 * 2, : w // 2 * 2]
    v = g[0::2] + g[1::2]
    return (v[:, 0::2] + v[:, 1::2]) * 0.25


def upsample2_disparity(disp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour 2× upsample to (h, w); values double because pixel
    coordinates double. Odd targets are edge-padded."""
    up = disp.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1) * 2.0
    up = up[:h, :w]
    ph, pw = h - up.shape[0], w - up.shape[1]
    return _edge_pad(up, 0, ph, 0, pw) if ph or pw else up


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """``x`` [H, W, ...] padded by repeating its edge rows and columns
    (``jnp.pad(mode="edge")`` as clamped index gathers)."""
    h, w = x.shape[:2]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x[rows][:, cols]


_SCAN_BLOCK = 16


def _cumsum_blocked(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along ``dim`` in the order XLA's CPU backend
    sums ``jnp.cumsum``: sequentially inside blocks of 16, then each block
    plus the (recursively scanned) total of the blocks before it. Explicit
    adds, so the card and the CPU give the same bits; with the ``1e6``
    costs of out-of-image candidates the sums are inexact, and only this
    order gives the JAX package's values."""
    n = x.shape[dim]
    x = x.movedim(dim, 0)
    nb = -(-n // _SCAN_BLOCK)
    if nb * _SCAN_BLOCK > n:
        x = torch.cat([x, x.new_zeros((nb * _SCAN_BLOCK - n,) + tuple(x.shape[1:]))])
    blocks = x.reshape((nb, _SCAN_BLOCK) + tuple(x.shape[1:]))
    acc = [blocks[:, 0]]
    for k in range(1, _SCAN_BLOCK):
        acc.append(acc[-1] + blocks[:, k])
    inner = torch.stack(acc, 1)
    del acc
    if nb > 1:
        before = _cumsum_blocked(inner[:, -1], 0)[:-1]
        inner = torch.cat([inner[:1], inner[1:] + before[:, None]])
    return inner.reshape((nb * _SCAN_BLOCK,) + tuple(x.shape[1:]))[:n].movedim(0, dim)


def _box_sum(cost: torch.Tensor, window: int) -> torch.Tensor:
    """``dense.box_aggregate`` (zero outside the image) with the prefix sums
    of :func:`_cumsum_blocked`."""
    if window <= 1:
        return cost
    r = window // 2

    def axis_boxsum(x, axis):
        n = x.shape[axis]
        ii = _cumsum_blocked(x, axis)
        ii = torch.cat([torch.zeros_like(ii.narrow(axis, 0, 1)), ii], dim=axis)
        idx = torch.arange(n, device=x.device)
        return (ii.index_select(axis, (idx + r + 1).clamp(max=n))
                - ii.index_select(axis, (idx - r).clamp(min=0)))

    return axis_boxsum(axis_boxsum(cost.to(torch.float32), 0), 1)


def _refine_level(left_g: torch.Tensor, right_g: torch.Tensor, prior: torch.Tensor,
                  cfg: MatchConfig, radius: int, max_base: Optional[int] = None,
                  max_windows: int = 1, tile_rows: int = 32) -> torch.Tensor:
    """Refine ``prior`` on one level within per-tile base windows (twin of
    ``stepth_tpu/match/pyramid.py:50-186``), in plain torch.

    Bases are fixed per (``tile_rows`` × 128) tile by the plan
    ``fused_refine.tile_windows_from_prior`` (``K = 2`` when the capped
    window count is ≤ 1, else the cap); windows beyond a tile's plan
    duplicate window 0. The SAD cost of every candidate ``s = base + o``
    (``o`` in ``±radius``, ``1e6`` where ``x − s`` leaves the image) is
    box-summed (:func:`_box_sum`), and the first minimum over the candidates in (window,
    offset) order wins. Four tilings shifted by half a tile, ``(0, 0), (0,
    64), (tile_rows/2, 0), (tile_rows/2, 64)``, run in that order, each
    competing only for the pixels interior to its own tiles (farther than
    ``window // 2`` from a tile border); a later tiling takes a pixel only
    with a strictly lower cost. Parabolic subpixel only where the winning
    offset is interior to its window; the result is clipped to ``[0, w −
    1]``. One tiling's candidates ([H, W, K·(2R + 1)]) are freed before the
    next is built."""
    from stepth_tpu_torch.match import fused_refine

    h, w = left_g.shape
    dev = left_g.device
    if max_base is None:
        max_base = w - 1
    tw = 128
    hp = -(-h // tile_rows) * tile_rows
    wp = -(-w // tw) * tw
    prior_p = _edge_pad(prior, 0, hp - h, 0, wp - w)
    mw_eff = min(max_windows, -(-(max_base + 1) // (2 * radius + 1)))
    K = 2 if mw_eff <= 1 else mw_eff
    kidx = torch.arange(K, device=dev)[None, None, :]
    rbox = cfg.window // 2
    sr, sc = tile_rows // 2, tw // 2
    x = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    y = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32, device=dev)
    no = 2 * radius + 1

    merged = None
    for dy, dx in ((0, 0), (0, sc), (sr, 0), (sr, sc)):
        pp = _edge_pad(prior_p, dy, dy, dx, dx)
        if (dy or dx) and (pp.shape[0] % tile_rows or pp.shape[1] % tw):
            pp = _edge_pad(pp, 0, -pp.shape[0] % tile_rows, 0, -pp.shape[1] % tw)
        b_t, nw_t = fused_refine.tile_windows_from_prior(pp, tile_rows, max_base, radius,
                                                         max_windows)
        b_t = torch.where(kidx < nw_t[..., None], b_t, b_t[..., :1])
        ty = (torch.arange(h, device=dev) + dy) // tile_rows
        tx = (torch.arange(w, device=dev) + dx) // tw
        bases = b_t[ty][:, tx]  # [h, w, K]
        near_c = ((x + dx) % tw < rbox) | ((x + dx) % tw >= tw - rbox)
        near_r = ((y + dy) % tile_rows < rbox) | ((y + dy) % tile_rows >= tile_rows - rbox)
        not_owner = near_c | near_r  # [h, w]

        svals = (bases[..., None] + offs).reshape(h, w, K * no)
        xs = x[..., None] - svals
        inb = (xs >= 0) & (xs < w)
        r_samp = right_g.gather(1, xs.clamp(0, w - 1).reshape(h, -1).long()).reshape(xs.shape)
        del xs
        cost = torch.where(inb, (left_g[..., None] - r_samp).abs(), 1e6)
        del inb, r_samp
        agg = _box_sum(cost, cfg.window)
        del cost
        agg = torch.where(not_owner[..., None], 1e30, agg)

        i0 = torch.argmin(agg, dim=-1)  # the first minimum: plan order breaks ties
        cand = (agg.gather(-1, i0[..., None])[..., 0],
                agg.gather(-1, (i0 - 1).clamp(min=0)[..., None])[..., 0],
                agg.gather(-1, (i0 + 1).clamp(max=K * no - 1)[..., None])[..., 0],
                svals.gather(-1, i0[..., None])[..., 0].to(torch.float32),
                (i0 % no >= 1) & (i0 % no <= no - 2))
        del agg, svals
        if merged is None:
            merged = cand
        else:
            upd = cand[0] < merged[0]  # an earlier tiling wins a tie
            merged = tuple(torch.where(upd, n, o) for n, o in zip(cand, merged))

    cb, cm1, cp1, bestd, interior = merged
    denom = cm1 - 2.0 * cb + cp1
    delta = torch.where(denom.abs() > 1e-6, (cm1 - cp1) / (2.0 * denom),
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    if not cfg.subpixel:
        interior = torch.zeros_like(interior)
    return torch.where(interior, bestd + delta, bestd).clamp(0.0, float(w - 1))


def match_hierarchical(left, right, cfg: MatchConfig = MatchConfig(),
                       pyr: PyramidConfig = PyramidConfig(), coarse_backend: str = "wta",
                       sgm: Optional[SGMConfig] = None, device=None) -> dense.MatchResult:
    """Hierarchical dense match of a rectified pair in plain torch (the
    ``hierarchical`` backend; twin of ``stepth_tpu/match/pyramid.py:
    189-269``): grayscale, ``levels − 1`` downsamples, the coarsest level by
    ``dense.match_pair`` (``coarse_backend="wta"``) or
    ``sgm.match_pair_sgm`` (``"sgm"``, with ``sgm``, by default
    ``SGMConfig()``) over ``coarsest_disparities``, then
    :func:`_refine_level` at each finer level (``max_base`` doubling; level 0
    takes ``final_radius``/``final_windows``), the sort-based
    ``dense.median3``, and the coarse level's validity carried to full
    resolution by nearest ×2 per level with edge padding. ``left``/``right``:
    gray [H, W] or RGB [H, W, 3] tensors (their device), or arrays (on
    ``device``, the card by default)."""
    from stepth_tpu_torch.match import sgm as sgm_mod

    lefts = [dense.grayscale(left, device)]
    rights = [dense.grayscale(right, device)]
    for _ in range(pyr.levels - 1):
        lefts.append(downsample2(lefts[-1]))
        rights.append(downsample2(rights[-1]))

    coarse_cfg = MatchConfig(
        num_disparities=pyr.coarsest_disparities, window=cfg.window, cost=cfg.cost,
        census_window=cfg.census_window, subpixel=cfg.subpixel,
        lr_threshold=cfg.lr_threshold, uniqueness=cfg.uniqueness,
    )
    if coarse_backend == "wta":
        res = dense.match_pair(lefts[-1], rights[-1], coarse_cfg)
    elif coarse_backend == "sgm":
        res = sgm_mod.match_pair_sgm(lefts[-1], rights[-1], coarse_cfg,
                                     SGMConfig() if sgm is None else sgm)
    else:
        raise ValueError(f"coarse_backend must be 'wta' or 'sgm', got {coarse_backend!r}")
    disp = res.disparity
    max_base = pyr.coarsest_disparities
    for lvl in range(pyr.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = upsample2_disparity(disp, h, w)
        max_base = max_base * 2
        disp = _refine_level(
            lefts[lvl], rights[lvl], prior, cfg,
            pyr.final_radius if lvl == 0 else pyr.refine_radius, max_base=max_base,
            max_windows=pyr.final_windows if lvl == 0 else pyr.refine_windows,
        )
    disp = dense.median3(disp)
    v = res.valid
    for lvl in range(pyr.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        v = v.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        v = _edge_pad(v, 0, max(0, h - v.shape[0]), 0, max(0, w - v.shape[1]))[:h, :w]
    return dense.MatchResult(disparity=disp, valid=v & (disp >= 0), cost=torch.zeros_like(disp))
