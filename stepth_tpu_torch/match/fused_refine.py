"""Hierarchical matching: the refine plan, kernel K2 with its plain version,
and the coarse-to-fine pipeline (twin of
``stepth_tpu/match/pallas_refine.py:377-702``).

A refine level searches ``base ± R`` around the upsampled coarser disparity,
where ``base`` is fixed per (tile_rows × 128-column) tile: the plan
(:func:`tile_windows_from_prior`) gives each tile up to ``max_windows`` bases
and the number ``nw`` to run. The plan is part of the output contract and is
built here in torch, on the input's device, as the reference builds it.

:func:`refine_level` plans a level and hands the plan to
:func:`refine_planned`, which launches K2 for CUDA tensors and runs
:func:`refine_planned_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig, PyramidConfig
from stepth_tpu_torch.match import dense, fused_dense, fused_post, pyramid

_BIG = 1e30
_TW = 128  # plan tile width (part of the output contract)

K2 = kernels.Kernel(
    "K2 fused_refine",
    "stepth_fused_refine",
    [kernels.PTR] * 5 + [kernels.INT] * 10,
    source="stepth_tpu_torch/csrc/fused_refine.cu",
    replaces="stepth_tpu/match/pallas_refine.py:63",
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tile_windows_from_prior(
    prior: torch.Tensor, tile_rows: int, max_base: int, radius: int, max_windows: int
):
    """Per-tile search-window plan ``(bases i32[nr, nc, K], nw i32[nr, nc])``
    for a prior f32[hp, wp] already padded to whole tiles.

    Tiles whose prior spread fits one ``round(mean) ± radius`` window get
    ``nw = 1`` and that base. Other tiles get a greedy ``± radius`` interval
    cover of their 8×8-subtile prior means, lowest uncovered target first.
    ``K`` is capped at ``ceil((max_base + 1) / (2·radius + 1))``, the most a
    greedy cover of ``[0, max_base]`` can use; a cap of 1 gives ``K = 2`` with
    ``nw = 1``."""
    hp, wp = prior.shape
    nr, nc = hp // tile_rows, wp // _TW
    mean = prior.reshape(nr, tile_rows, nc, _TW).mean(dim=(1, 3))
    b_mean = torch.round(mean).clamp(0, max_base).to(torch.int32)
    max_windows = min(max_windows, -(-(max_base + 1) // (2 * radius + 1)))
    if max_windows <= 1:
        bases = b_mean[..., None].expand(nr, nc, 2).contiguous()
        return bases, torch.ones_like(b_mean)
    # 8×8 subtile means. The sum runs sequentially in row-major window order,
    # the order of the reference's reduce_window, because a subtile mean that
    # is an integer in exact arithmetic decides `sub > c + radius` by its
    # last bit.
    pooled = torch.zeros((hp // 8, wp // 8), dtype=prior.dtype, device=prior.device)
    for dy in range(8):
        for dx in range(8):
            pooled = pooled + prior[dy::8, dx::8]
    pooled = pooled * (1.0 / 64.0)
    sub = pooled.reshape(nr, tile_rows // 8, nc, _TW // 8)
    sub = sub.permute(0, 2, 1, 3).reshape(nr, nc, -1)  # [nr, nc, n_sub]
    blo_c = torch.minimum(torch.floor(sub.amin(-1)).clamp(0, max_base), b_mean)
    bhi_c = torch.maximum(torch.ceil(sub.amax(-1)).clamp(0, max_base), b_mean)
    one = (b_mean - blo_c <= radius) & (bhi_c - b_mean <= radius)

    uncov = torch.ones(sub.shape, dtype=torch.bool, device=prior.device)
    bases = []
    nw = torch.zeros_like(b_mean)
    for _ in range(max_windows):
        v = torch.where(uncov, sub, _BIG).amin(-1)  # lowest uncovered target
        # centre the window on the uncovered group reachable from v
        vhi = torch.where(uncov & (sub <= v[..., None] + 2 * radius), sub, -_BIG)
        vhi = torch.maximum(vhi.amax(-1), v)
        c = torch.round((v + vhi) * 0.5).clamp(0, max_base).to(torch.int32)
        bases.append(c)
        nw = nw + (v < _BIG).to(torch.int32)
        uncov = uncov & (sub > c[..., None].to(torch.float32) + radius)
    bases = torch.stack(bases, dim=-1)
    bases = torch.where(one[..., None], b_mean[..., None], bases)
    nw = torch.where(one, 1, nw.clamp(min=1)).to(torch.int32)
    return bases, nw


def plan_level(
    prior: torch.Tensor, tile_rows: int, max_base: int, radius: int, max_windows: int
):
    """The plan one refine level runs: ``tile_rows`` rounded up to a multiple
    of 8, the prior edge-padded to whole (tile_rows × 128) tiles, then
    :func:`tile_windows_from_prior`. Returns ``(bases, nw, tile_rows)``."""
    tile_rows = _round_up(tile_rows, 8)
    h, w = prior.shape
    rows = torch.arange(_round_up(h, tile_rows), device=prior.device).clamp(max=h - 1)
    cols = torch.arange(_round_up(w, _TW), device=prior.device).clamp(max=w - 1)
    bases, nw = tile_windows_from_prior(
        prior[rows][:, cols], tile_rows, max_base, radius, max_windows
    )
    return bases, nw, tile_rows


def _check_level(cfg: MatchConfig, lr: bool) -> None:
    if lr:
        raise NotImplementedError("refine lr=True: ROADMAP slice 2 (K2 right view)")
    if cfg.cost == "census":
        raise NotImplementedError(
            "census cost: ROADMAP slice 2 (census planes in K1/K2)"
        )
    if cfg.cost not in ("sad", "ssd"):
        raise NotImplementedError(f"refine: cost {cfg.cost!r} unsupported")


def refine_planned_plain(lg, rg, bases, nw, cfg: MatchConfig, radius: int,
                         tile_rows: int, g_row0: int = 0, g_h: Optional[int] = None):
    """K2's plain version for a given plan (from :func:`plan_level`): every
    tile's cost over its box halo is gathered at the tile's own candidate, so
    neighbours across a tile border are costed at the centre tile's
    disparity, as in the kernel."""
    h, w = lg.shape
    g_h = h if g_h is None else g_h
    nr, nc, K = bases.shape
    win, R, TH = cfg.window, radius, tile_rows
    r = win // 2
    dev = lg.device
    ys = torch.arange(nr, device=dev)[:, None] * TH - r + torch.arange(TH + 2 * r, device=dev)
    xs = torch.arange(nc, device=dev)[:, None] * _TW - r + torch.arange(_TW + 2 * r, device=dev)
    SR, Q = ys.shape[1], xs.shape[1]
    row_ok = (ys >= 0) & (ys < h) & (g_row0 + ys >= 0) & (g_row0 + ys < g_h)
    col_ok = (xs >= 0) & (xs < w)
    in_img = row_ok[:, :, None, None] & col_ok[None, None]  # [nr, SR, nc, Q]
    yc = ys.clamp(0, h - 1)
    left = lg[yc][:, :, xs.clamp(0, w - 1)]  # [nr, SR, nc, Q]
    right_rows = rg[yc]  # [nr, SR, w]

    shape = (nr, TH, nc, _TW)

    def full(v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    best, cb, cp1, cm1 = full(_BIG), full(_BIG), full(_BIG), full(0.0)
    bests = full(0, torch.int32)
    oi = full(-2, torch.int32)
    wbest = full(-1, torch.int32)
    for wi in range(K):
        active = ((nw > wi) | (wi == 0))[:, None, :, None]  # window 0 always runs
        prev = full(0.0)
        for o in range(-R, R + 1):
            s = bases[:, :, wi] + o  # [nr, nc]; may be < 0 at base 0
            xsrc = xs[None] - s[:, :, None]  # [nr, nc, Q]
            bad = ((xsrc < 0) | (xsrc >= w))[:, None]
            idx = xsrc.clamp(0, w - 1).reshape(nr, 1, nc * Q).expand(nr, SR, nc * Q)
            rs = torch.gather(right_rows, 2, idx).reshape(nr, SR, nc, Q)
            diff = left - rs
            cost = diff * diff if cfg.cost == "ssd" else diff.abs()
            cost = torch.where(bad, 1e6, cost)
            cost = torch.where(in_img, cost, 0.0)
            agg = fused_dense.box_sum_ordered(
                fused_dense.box_sum_ordered(cost, win, 1), win, 3
            )  # [nr, TH, nc, TW]
            oc = o + R
            upd = active & (agg < best)
            is_next = active & ~upd & (wbest == wi) & (oi == oc - 1)
            cm1 = torch.where(upd, prev, cm1)
            cb = torch.where(upd, agg, cb)
            cp1 = torch.where(is_next, agg, cp1)
            best = torch.where(upd, agg, best)
            bests = torch.where(upd, s[:, None, :, None], bests)
            oi = torch.where(upd, oc, oi)
            wbest = torch.where(upd, wi, wbest)
            prev = agg

    denom = cm1 - 2.0 * cb + cp1
    delta = torch.where(denom.abs() > 1e-6, (cm1 - cp1) / (2.0 * denom), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    interior = (oi >= 1) & (oi <= 2 * R - 1)
    dval = bests.to(torch.float32)
    dval = torch.where(interior, dval + delta, dval).clamp(0.0, float(w - 1))
    return dval.reshape(nr * TH, nc * _TW)[:h, :w]


def refine_level_plain(
    left_g: torch.Tensor,
    right_g: torch.Tensor,
    prior: torch.Tensor,
    cfg: MatchConfig,
    radius: int,
    max_base: int,
    tile_rows: int = 32,
    g_row0: int = 0,
    g_h: Optional[int] = None,
    lr: bool = False,
    max_windows: int = 4,
) -> torch.Tensor:
    """K2's plain version, on any device: one refine level of gray f32[H, W]
    images around ``prior`` f32[H, W]; returns the disparity f32[H, W].
    ``g_row0``/``g_h``: global row window of a halo-extended row shard."""
    _check_level(cfg, lr)
    bases, nw, tile_rows = plan_level(prior, tile_rows, max_base, radius, max_windows)
    return refine_planned_plain(
        left_g, right_g, bases, nw, cfg, radius, tile_rows, g_row0, g_h
    )


def refine_planned(lg, rg, bases, nw, cfg: MatchConfig, radius: int,
                   tile_rows: int, g_row0: int = 0, g_h: Optional[int] = None):
    """One refine level for a given plan: K2 on CUDA tensors,
    :func:`refine_planned_plain` on CPU tensors."""
    if lg.device.type == "cpu":
        return refine_planned_plain(lg, rg, bases, nw, cfg, radius, tile_rows, g_row0, g_h)
    kernels.check_cuda_tensor("refine left", lg, torch.float32, 2)
    kernels.check_cuda_tensor("refine right", rg, torch.float32, 2)
    kernels.check_cuda_tensor("refine bases", bases, torch.int32, 3)
    kernels.check_cuda_tensor("refine nw", nw, torch.int32, 2)
    h, w = lg.shape
    nr, nc, K = bases.shape
    if rg.shape != lg.shape or nw.shape != (nr, nc) or tile_rows % 8:
        raise ValueError("refine: right/plan shapes disagree or tile_rows % 8 != 0")
    if nr * tile_rows < h or nc * _TW < w:
        raise ValueError(f"refine: plan {nr}x{nc} tiles does not cover {h}x{w}")
    out = torch.empty_like(lg)
    K2.launch(
        lg.device, lg.data_ptr(), rg.data_ptr(), bases.data_ptr(), nw.data_ptr(),
        out.data_ptr(), h, w, nc, K, tile_rows, radius, cfg.window,
        int(cfg.cost == "ssd"), int(g_row0), h if g_h is None else int(g_h),
    )
    return out


def refine_level(
    left_g: torch.Tensor,
    right_g: torch.Tensor,
    prior: torch.Tensor,
    cfg: MatchConfig,
    radius: int,
    max_base: int,
    tile_rows: int = 32,
    g_row0: int = 0,
    g_h: Optional[int] = None,
    lr: bool = False,
    max_windows: int = 4,
) -> torch.Tensor:
    """One refine level: the plan, then K2 on CUDA tensors or its plain
    version on CPU tensors (:func:`refine_planned`). Same arguments as the
    reference's ``refine_level`` without ``interpret``; ``lr=True`` (the
    right-view output) is not ported yet."""
    _check_level(cfg, lr)
    if prior.shape != left_g.shape:
        raise ValueError(f"prior {tuple(prior.shape)} != image {tuple(left_g.shape)}")
    bases, nw, tile_rows = plan_level(prior, tile_rows, max_base, radius, max_windows)
    return refine_planned(left_g, right_g, bases, nw, cfg, radius, tile_rows, g_row0, g_h)


def _match_hierarchical(left, right, cfg, pyr, tile_rows, lr_check, coarse_backend,
                        device, match_fn, refine_fn, median_fn) -> dense.MatchResult:
    if lr_check:
        raise NotImplementedError(
            "lr_check: ROADMAP slice 2 (K2 lr=True, K4 LR check, K5 fill)"
        )
    if coarse_backend == "sgm":
        raise NotImplementedError("coarse_backend='sgm': ROADMAP Queue 1 item 7 (K6-K9)")
    if coarse_backend != "wta":
        raise ValueError(f"coarse_backend must be 'wta' or 'sgm', got {coarse_backend!r}")
    lefts = [dense.grayscale(left, device)]
    rights = [dense.grayscale(right, device)]
    for _ in range(pyr.levels - 1):
        lefts.append(pyramid.downsample2(lefts[-1]))
        rights.append(pyramid.downsample2(rights[-1]))

    coarse_cfg = MatchConfig(
        num_disparities=pyr.coarsest_disparities,
        window=cfg.window,
        cost=cfg.cost,
        census_window=cfg.census_window,
        subpixel=cfg.subpixel,
        lr_threshold=None,
    )
    disp = match_fn(lefts[-1], rights[-1], coarse_cfg, tile_rows=min(tile_rows, 16))[0]
    max_base = pyr.coarsest_disparities
    for lvl in range(pyr.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = pyramid.upsample2_disparity(disp, h, w)
        max_base = max_base * 2
        disp = refine_fn(
            lefts[lvl], rights[lvl], prior, cfg,
            pyr.final_radius if lvl == 0 else pyr.refine_radius,
            max_base, tile_rows,
            max_windows=pyr.final_windows if lvl == 0 else pyr.refine_windows,
        )
    disp = median_fn(disp)
    return dense.MatchResult(disparity=disp, valid=disp >= 0, cost=torch.zeros_like(disp))


def match_hierarchical_fused(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    device=None,
) -> dense.MatchResult:
    """Coarse-to-fine matching through the kernels (twin of
    ``match_hierarchical_pallas`` with ``coarse_backend="wta"``): grayscale,
    ``levels − 1`` downsamples, K1 at the coarsest level, K2 at every finer
    level (``max_base`` doubling from ``coarsest_disparities``; level 0 uses
    ``final_radius``/``final_windows``), then K3. ``left``/``right``: gray
    [H, W] or RGB [H, W, 3] tensors, or arrays with an explicit ``device``."""
    return _match_hierarchical(
        left, right, cfg, pyr, tile_rows, lr_check, coarse_backend, device,
        fused_dense.raw_match, refine_level, fused_post.median3_fused,
    )


def match_hierarchical_plain(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    device=None,
) -> dense.MatchResult:
    """The same pipeline through the kernels' plain versions, on any device:
    the reference the kernel path is held to on the card."""
    return _match_hierarchical(
        left, right, cfg, pyr, tile_rows, lr_check, coarse_backend, device,
        fused_dense.raw_match_plain, refine_level_plain, fused_post.median3_plain,
    )
