"""Hierarchical matching: the refine plan, kernel K2 with its plain version,
the matcher's stage table, the coarse-to-fine pipeline and its temporally
seeded video loop (twin of ``stepth_tpu/match/pallas_refine.py:377-789``).

:class:`Stages` is the matcher's one table of stages, where the choice
between the kernels (:data:`FUSED`) and their plain versions (:data:`PLAIN`)
is made; every pipeline of the matcher takes it as its first argument.

A refine level searches ``base ± R`` around the upsampled coarser disparity,
where ``base`` is fixed per (tile_rows × 128-column) tile: the plan
(:func:`tile_windows_from_prior`) gives each tile up to ``max_windows`` bases
and the number ``nw`` to run. The plan is part of the output contract and
a stage of its own: :func:`plan_level` (``FUSED.plan``) builds it with
K2_PLAN for CUDA tensors and with the plain torch version for CPU tensors;
:func:`plan_level_plain` (``PLAIN.plan``) in plain torch on any device. The
``refine`` stage, :func:`refine_planned`, then launches K2 for CUDA tensors
and runs :func:`refine_planned_plain` for CPU tensors.

``lr=True`` also returns the right-view disparity ``dR`` (−1e6 where no
candidate covered the column). Its contract is the reference kernel's: each
tile contributes candidates from its whole 256-column cost region, real
columns ``[jc·128 − M, jc·128 − M + 256)`` with ``M = round_up(2·(win//2),
8)``, whose horizontal box sums wrap modulo 256 at both ends; a candidate at
region column ``q'`` with offset ``o`` reaches right column ``x(q') − s``
only for ``q' ∈ [R + o, 255 − R + o]``; the first minimum wins in the order
(tile, window, offset).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import dense, fused_dense, fused_post, fused_sgm, pyramid
from stepth_tpu_torch.utils import tracing

_BIG = 1e30
_TW = 128  # plan tile width (part of the output contract)
_CW = 256  # the reference's cost-region width (the right view's contract)
_UNTOUCHED = torch.iinfo(torch.int64).max  # start of the plain scatter-min

K2 = kernels.Kernel(
    "K2",
    "K2 fused_refine",
    "stepth_fused_refine",
    [kernels.PTR] * 4 + [kernels.INT] + [kernels.PTR] * 4 + [kernels.INT] * 12,
    source="stepth_tpu_torch/csrc/fused_refine.cu",
    replaces="stepth_tpu/match/pallas_refine.py:63",
)
K2_EMIT = kernels.Kernel(
    "K2 emit",
    "K2 right-view emit",
    "stepth_refine_emit_r",
    [kernels.PTR] * 3 + [kernels.INT] * 6,
    source="stepth_tpu_torch/csrc/fused_refine.cu",
    replaces="stepth_tpu/match/pallas_refine.py:63",
)
K2_PLAN = kernels.Kernel(
    "K2 plan",
    "K2 refine plan",
    "stepth_refine_plan",
    [kernels.PTR] * 4 + [kernels.INT] * 7,
    source="stepth_tpu_torch/csrc/fused_refine.cu",
    replaces="none (the XLA glue of stepth_tpu/match/pallas_refine.py:377)",
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _tile_mean(prior: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The (tile_rows × 128) tile means f32[nr, nc] of a padded prior: one
    torch reduction, which the kernel path and the plain path both take, so
    ``round(mean)`` is the same at a mean within an ulp of a half."""
    hp, wp = prior.shape
    return prior.reshape(hp // tile_rows, tile_rows, wp // _TW, _TW).mean(dim=(1, 3))


def _window_cap(max_base: int, radius: int, max_windows: int) -> int:
    """``max_windows`` capped at ``ceil((max_base + 1) / (2·radius + 1))``,
    the most windows a greedy cover of ``[0, max_base]`` can use."""
    return min(max_windows, -(-(max_base + 1) // (2 * radius + 1)))


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
    b_mean = torch.round(_tile_mean(prior, tile_rows)).clamp(0, max_base).to(torch.int32)
    max_windows = _window_cap(max_base, radius, max_windows)
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


def tile_windows_fused(
    prior: torch.Tensor, tile_rows: int, max_base: int, radius: int, max_windows: int
):
    """:func:`tile_windows_from_prior` on a padded CUDA prior: the torch tile
    mean, then K2_PLAN, one block a tile. Same arguments and outputs."""
    kernels.check_cuda_tensor("plan prior", prior, torch.float32, 2)
    hp, wp = prior.shape
    if tile_rows < 8 or tile_rows % 8 or hp % tile_rows or wp % _TW:
        raise ValueError(f"plan: prior {hp}x{wp} is not whole ({tile_rows}x{_TW}) tiles")
    if prior.data_ptr() % 16:  # K2_PLAN reads each subtile row as two float4
        raise ValueError("plan: the prior is not 16-byte aligned")
    nr, nc = hp // tile_rows, wp // _TW
    mean = _tile_mean(prior, tile_rows)
    K = _window_cap(max_base, radius, max_windows)
    single = K <= 1
    K = 2 if single else K
    bases = torch.empty((nr, nc, K), dtype=torch.int32, device=prior.device)
    nw = torch.empty((nr, nc), dtype=torch.int32, device=prior.device)
    K2_PLAN.launch(prior.device, prior.data_ptr(), mean.data_ptr(), bases.data_ptr(),
                   nw.data_ptr(), hp, wp, tile_rows, K, max_base, radius, int(single))
    return bases, nw


def pad_prior(prior: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The prior edge-padded to whole (tile_rows × 128) tiles: one copy."""
    h, w = prior.shape
    return F.pad(prior[None], (0, -w % _TW, 0, -h % tile_rows), mode="replicate")[0]


def _plan(tile_windows, prior, tile_rows, max_base, radius, max_windows):
    tile_rows = _round_up(tile_rows, 8)
    bases, nw = tile_windows(pad_prior(prior, tile_rows), tile_rows, max_base, radius,
                             max_windows)
    return bases, nw, tile_rows


@tracing.annotate("stepth/plan")
def plan_level(
    prior: torch.Tensor, tile_rows: int, max_base: int, radius: int, max_windows: int
):
    """The plan one refine level runs: ``tile_rows`` rounded up to a multiple
    of 8, the prior edge-padded to whole (tile_rows × 128) tiles, then
    :func:`tile_windows_fused` (K2_PLAN) on CUDA tensors or
    :func:`tile_windows_from_prior` on CPU tensors. Returns ``(bases, nw,
    tile_rows)``."""
    plan = tile_windows_from_prior if prior.device.type == "cpu" else tile_windows_fused
    return _plan(plan, prior, tile_rows, max_base, radius, max_windows)


@tracing.annotate("stepth/plan")
def plan_level_plain(
    prior: torch.Tensor, tile_rows: int, max_base: int, radius: int, max_windows: int
):
    """:func:`plan_level`'s plain version, on any device: the same pad, then
    :func:`tile_windows_from_prior`."""
    return _plan(tile_windows_from_prior, prior, tile_rows, max_base, radius, max_windows)


def _region_margin(cfg: MatchConfig, radius: int) -> int:
    """The reference's cost-region margin ``M``, after its checks."""
    if cfg.cost not in ("sad", "ssd", "census"):
        raise NotImplementedError(f"refine: cost {cfg.cost!r} unsupported")
    if radius >= 64:
        raise ValueError(f"refine radius {radius} ≥ 64 (right-block headroom)")
    rbox = cfg.window // 2
    M = _round_up(2 * rbox, 8)
    if M + _TW + 2 * rbox > _CW:
        raise ValueError(f"window {cfg.window} too wide for the {_CW} cost region")
    return M


def _images_plain(lg, rg, cfg: MatchConfig):
    """The matched images as planes [P, H, W] for K2's plain version: census
    descriptors (int32, ``dense.census_pair_plain``), or the gray image
    itself (P = 1)."""
    if cfg.cost == "census":
        return dense.census_pair_plain(lg, rg, cfg.census_window)
    return lg[None], rg[None]


def emit_right_plain(packed, bases, tile_rows: int, radius: int) -> torch.Tensor:
    """The right-view emit's plain version: decode the packed per-column
    minima int64 [H, W] (``f32 cost bits << 32 | key``, −1 where no
    candidate arrived) into dR f32[H, W]: key ``(jc·K + wi)·(2R+1) + o + R``
    → candidate ``bases[y // tile_rows, jc, wi] + o``; −1e6 where untouched."""
    h, w = packed.shape
    nc, K = bases.shape[1:]
    n = 2 * radius + 1
    key = packed & 0xFFFFFFFF
    o = key % n - radius
    jc, wi = (key // n // K).clamp(max=nc - 1), key // n % K
    i = (torch.arange(h, device=packed.device) // tile_rows)[:, None].expand(h, w)
    s = bases[i, jc, wi] + o
    return torch.where(packed == -1, -1e6, s.to(torch.float32))


def emit_right(packed, bases, tile_rows: int, radius: int) -> torch.Tensor:
    """Right-view decode: the emit kernel of K2 on CUDA tensors,
    :func:`emit_right_plain` on CPU tensors."""
    if packed.device.type == "cpu":
        return emit_right_plain(packed, bases, tile_rows, radius)
    kernels.check_cuda_tensor("emit packed", packed, torch.int64, 2)
    kernels.check_cuda_tensor("emit bases", bases, torch.int32, 3)
    h, w = packed.shape
    nr, nc, K = bases.shape
    if nr * tile_rows < h:
        raise ValueError(f"emit: plan {nr}x{nc} tiles does not cover {h} rows")
    disp_r = torch.empty((h, w), dtype=torch.float32, device=packed.device)
    K2_EMIT.launch(packed.device, packed.data_ptr(), bases.data_ptr(), disp_r.data_ptr(),
                   h, w, nc, K, tile_rows, radius)
    return disp_r


def refine_planned_plain(lg, rg, bases, nw, cfg: MatchConfig, radius: int,
                         tile_rows: int, g_row0: int = 0, g_h: Optional[int] = None,
                         lr: bool = False):
    """K2's plain version for a given plan (from :func:`plan_level`): every
    tile's cost over its box halo is gathered at the tile's own candidate, so
    neighbours across a tile border are costed at the centre tile's
    disparity, as in the kernel. With ``lr`` each tile costs its whole
    256-column region, circularly box-summed, and its candidates are
    scatter-minned into the right view by ``(cost, tile, window, offset)``;
    returns ``(disp, disp_r)``."""
    h, w = lg.shape
    g_h = h if g_h is None else g_h
    nr, nc, K = bases.shape
    win, R, TH = cfg.window, radius, tile_rows
    r = win // 2
    M = _region_margin(cfg, R)
    off, Q = (M, _CW) if lr else (r, _TW + 2 * r)
    dev = lg.device
    ys = torch.arange(nr, device=dev)[:, None] * TH - r + torch.arange(TH + 2 * r, device=dev)
    xs = torch.arange(nc, device=dev)[:, None] * _TW - off + torch.arange(Q, device=dev)
    SR = ys.shape[1]
    row_ok = (ys >= 0) & (ys < h) & (g_row0 + ys >= 0) & (g_row0 + ys < g_h)
    col_ok = (xs >= 0) & (xs < w)
    in_img = row_ok[:, :, None, None] & col_ok[None, None]  # [nr, SR, nc, Q]
    yc = ys.clamp(0, h - 1)
    lsrc, rsrc = _images_plain(lg, rg, cfg)
    P = lsrc.shape[0]
    left = lsrc[:, yc][..., xs.clamp(0, w - 1)]  # [P, nr, SR, nc, Q]
    right_rows = rsrc[:, yc]  # [P, nr, SR, w]

    shape = (nr, TH, nc, _TW)

    def full(v, dtype=torch.float32, shape=shape):
        return torch.full(shape, v, dtype=dtype, device=dev)

    best, cb, cp1, cm1 = full(_BIG), full(_BIG), full(_BIG), full(0.0)
    bests = full(0, torch.int32)
    oi = full(-2, torch.int32)
    wbest = full(-1, torch.int32)
    if lr:
        packed = torch.full((h * w,), _UNTOUCHED, dtype=torch.int64, device=dev)
        y_out = (torch.arange(nr, device=dev)[:, None] * TH
                 + torch.arange(TH, device=dev))[:, :, None, None]  # [nr, TH, 1, 1]
    for wi in range(K):
        active = ((nw > wi) | (wi == 0))[:, None, :, None]  # window 0 always runs
        prev = full(0.0)
        if lr:
            rshape = (nr, TH, nc, _CW - 2 * R)  # targets q ∈ [2R, 256)
            rbest, roff = full(_BIG, shape=rshape), full(-1, torch.int64, rshape)
            # right column reached from target q: u = x(q') − s = x(q) − R − base
            u = (xs[None, :, 2 * R:] - R - bases[:, :, wi, None])[:, None]  # [nr, 1, nc, nq]
        for o in range(-R, R + 1):
            s = bases[:, :, wi] + o  # [nr, nc]; may be < 0 at base 0
            xsrc = xs[None] - s[:, :, None]  # [nr, nc, Q]
            bad = ((xsrc < 0) | (xsrc >= w))[:, None]
            idx = xsrc.clamp(0, w - 1).reshape(1, nr, 1, nc * Q).expand(P, nr, SR, nc * Q)
            rs = torch.gather(right_rows, 3, idx).reshape(P, nr, SR, nc, Q)
            if cfg.cost == "census":
                cost = dense.popcount32(left ^ rs).sum(0).to(torch.float32)
            else:
                diff = left[0] - rs[0]
                cost = diff * diff if cfg.cost == "ssd" else diff.abs()
            cost = torch.where(bad, 1e6, cost)
            cost = torch.where(in_img, cost, 0.0)
            vert = fused_dense.box_sum_ordered(cost, win, 1)  # [nr, TH, nc, Q]
            if lr:  # the reference's roll: the region's box sums wrap mod 256
                if r:
                    vert = torch.cat([vert[..., -r:], vert, vert[..., :r]], dim=3)
                region = fused_dense.box_sum_ordered(vert, win, 3)  # [nr, TH, nc, 256]
                agg = region[..., M : M + _TW]
            else:
                agg = fused_dense.box_sum_ordered(vert, win, 3)  # [nr, TH, nc, TW]
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
            if lr:
                # target q takes region column q' = q − R + o
                cand = region[..., R + o : _CW - R + o]
                xc = xs[None, None, :, R + o : _CW - R + o]
                ok = (xc >= 0) & (xc < w) & (u >= 0) & (u < w)
                take = ok & (cand < rbest)
                rbest = torch.where(take, cand, rbest)
                roff = torch.where(take, oc, roff)
        if lr:
            key = (torch.arange(nc, device=dev)[:, None] * K + wi) * (2 * R + 1) + roff
            hit = active & (roff >= 0) & (y_out < h)
            val = (rbest.view(torch.int32).to(torch.int64) << 32) | key
            dst = (y_out * w + u).expand(rshape)
            packed.scatter_reduce_(0, dst[hit], val[hit], reduce="amin")

    denom = cm1 - 2.0 * cb + cp1
    delta = torch.where(denom.abs() > 1e-6, (cm1 - cp1) / (2.0 * denom), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    interior = (oi >= 1) & (oi <= 2 * R - 1)
    dval = bests.to(torch.float32)
    dval = torch.where(interior, dval + delta, dval).clamp(0.0, float(w - 1))
    disp = dval.reshape(nr * TH, nc * _TW)[:h, :w]
    if lr:  # the kernel's untouched marker: all ones
        packed = torch.where(packed == _UNTOUCHED, -1, packed).reshape(h, w)
        return disp, emit_right_plain(packed, bases, TH, R)
    return disp


def refine_planned(lg, rg, bases, nw, cfg: MatchConfig, radius: int,
                   tile_rows: int, g_row0: int = 0, g_h: Optional[int] = None,
                   lr: bool = False):
    """One refine level for a given plan: K2 (then its right-view emit with
    ``lr``) on CUDA tensors, :func:`refine_planned_plain` on CPU tensors.
    Returns ``disp``, or ``(disp, disp_r)`` with ``lr``."""
    if lg.device.type == "cpu":
        return refine_planned_plain(lg, rg, bases, nw, cfg, radius, tile_rows,
                                    g_row0, g_h, lr)
    M = _region_margin(cfg, radius)
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
    images = (lg.data_ptr(), rg.data_ptr(), None, None, 0)
    if cfg.cost == "census":
        lc, rc = dense.census_pair(lg, rg, cfg.census_window)
        images = (None, None, lc.data_ptr(), rc.data_ptr(), lc.shape[0])
    out = torch.empty_like(lg)
    # all ones: the u64 start value atomicMin never keeps
    packed = torch.full((h, w), -1, dtype=torch.int64, device=lg.device) if lr else None
    K2.launch(
        lg.device, *images, bases.data_ptr(), nw.data_ptr(), out.data_ptr(),
        packed.data_ptr() if lr else None, h, w, nc, K, tile_rows, radius,
        cfg.window, M, int(cfg.cost == "ssd"), int(g_row0),
        h if g_h is None else int(g_h), int(lr),
    )
    if not lr:
        return out
    return out, emit_right(packed, bases, tile_rows, radius)


class Stages(NamedTuple):
    """The stages of the matcher's pipelines, each a kernel's wrapper
    (:data:`FUSED`) or its plain version (:data:`PLAIN`);
    :data:`STAGE_KERNELS` names the kernel of each stage's outputs."""

    match: Callable  # K1, + K4 with cfg.lr_threshold
    plan: Callable  # K2_PLAN
    refine: Callable  # census, K2 and its right-view emit, for a given plan
    volume: Callable  # census, K6
    scan: Callable  # K7
    scan_wta: Callable  # K8
    wta: Callable  # K9, + K4 with cfg.lr_threshold
    scan_carry: Callable  # K10, the sharded relay's
    lr: Callable  # K4
    fill: Callable  # K5
    median: Callable  # K3


FUSED = Stages(
    match=fused_dense.raw_match, plan=plan_level, refine=refine_planned,
    volume=fused_sgm.aggregated_volume, scan=fused_sgm.scan_direction,
    scan_wta=fused_sgm.scan_wta_direction, wta=fused_sgm.wta_from_volume,
    scan_carry=fused_sgm.scan_direction_carry, lr=fused_post.lr_consistency_fused,
    fill=fused_post.fill_invalid_fused, median=fused_post.median3_fused,
)
PLAIN = Stages(
    match=fused_dense.raw_match_plain, plan=plan_level_plain, refine=refine_planned_plain,
    volume=fused_sgm.aggregated_volume_plain, scan=fused_sgm.scan_direction_plain,
    scan_wta=fused_sgm.scan_wta_direction_plain, wta=fused_sgm.wta_from_volume_plain,
    scan_carry=fused_sgm.scan_direction_carry_plain, lr=fused_post.lr_consistency_plain,
    fill=fused_post.fill_invalid_plain, median=fused_post.median3_plain,
)

# each stage's outputs by the key of the kernel that makes them (the last
# key repeats): the WTA's validity is K4's LR check of K9's maps
STAGE_KERNELS = {
    "match": ("K1",), "plan": ("K2 plan",), "refine": ("K2", "K2 emit"), "volume": ("K6",),
    "scan": ("K7",), "scan_wta": ("K8",), "wta": ("K9", "K9", "K9", "K4"),
    "scan_carry": ("K10",), "lr": ("K4",), "fill": ("K5",), "median": ("K3",),
}


@tracing.annotate("stepth/refine")
def _refine_level(stages: Stages, left_g, right_g, prior, cfg, radius, max_base, tile_rows,
                  g_row0, g_h, lr, max_windows):
    if prior.shape != left_g.shape:
        raise ValueError(f"prior {tuple(prior.shape)} != image {tuple(left_g.shape)}")
    bases, nw, tile_rows = stages.plan(prior, tile_rows, max_base, radius, max_windows)
    return stages.refine(left_g, right_g, bases, nw, cfg, radius, tile_rows, g_row0, g_h, lr)


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
):
    """One refine level: the plan, then K2 on CUDA tensors or its plain
    version on CPU tensors (:func:`refine_planned`). Same arguments and
    outputs as the reference's ``refine_level`` without ``interpret``:
    f32[H, W], or ``(disp, disp_r)`` with ``lr``."""
    return _refine_level(FUSED, left_g, right_g, prior, cfg, radius, max_base, tile_rows,
                         g_row0, g_h, lr, max_windows)


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
):
    """The plain version of :func:`refine_level`, on any device: the plain
    plan (:func:`plan_level_plain`), then K2's plain version."""
    return _refine_level(PLAIN, left_g, right_g, prior, cfg, radius, max_base, tile_rows,
                         g_row0, g_h, lr, max_windows)


@tracing.annotate("stepth/post")
def _post(stages: Stages, disp, disp_r, cfg: MatchConfig, max_base: int, lr_check: bool):
    """The epilogue: LR check against ``disp_r`` (threshold
    ``cfg.lr_threshold``, 1.0 when unset; ``D = max_base``), occlusion fill
    and median with ``lr_check``; the median alone without."""
    if lr_check:
        thr = 1.0 if cfg.lr_threshold is None else float(cfg.lr_threshold)
        valid = stages.lr(disp, disp_r, thr, max_base)
        disp = stages.median(stages.fill(disp, valid))
        return dense.MatchResult(disparity=disp, valid=valid, cost=torch.zeros_like(disp))
    disp = stages.median(disp)
    return dense.MatchResult(disparity=disp, valid=disp >= 0, cost=torch.zeros_like(disp))


def _match_hierarchical(stages: Stages, left, right, cfg, pyr, tile_rows, lr_check,
                        coarse_backend, device, sgm: Optional[SGMConfig] = None
                        ) -> dense.MatchResult:
    if coarse_backend not in ("wta", "sgm"):
        raise ValueError(f"coarse_backend must be 'wta' or 'sgm', got {coarse_backend!r}")
    if lr_check and pyr.levels == 1:
        raise ValueError("lr_check needs at least one refine level")
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
    with tracing.span("stepth/coarse"):
        if coarse_backend == "wta":
            disp = stages.match(lefts[-1], rights[-1], coarse_cfg,
                                tile_rows=min(tile_rows, 16))[0]
        else:  # the whole SGM pipeline on the same stages, epilogue included
            disp = fused_sgm._match_pair_sgm(stages, lefts[-1], rights[-1], coarse_cfg,
                                             SGMConfig() if sgm is None else sgm,
                                             None).disparity
    max_base = pyr.coarsest_disparities
    disp_r = None
    for lvl in range(pyr.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = pyramid.upsample2_disparity(disp, h, w)
        max_base = max_base * 2
        want_lr = lr_check and lvl == 0  # dR only at full resolution
        out = _refine_level(
            stages, lefts[lvl], rights[lvl], prior, cfg,
            pyr.final_radius if lvl == 0 else pyr.refine_radius, max_base, tile_rows, 0, None,
            want_lr, pyr.final_windows if lvl == 0 else pyr.refine_windows,
        )
        disp, disp_r = out if want_lr else (out, None)
    return _post(stages, disp, disp_r, cfg, max_base, lr_check)


def match_hierarchical_fused(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    device=None,
    sgm: Optional[SGMConfig] = None,
) -> dense.MatchResult:
    """Coarse-to-fine matching through the kernels (twin of
    ``match_hierarchical_pallas``): grayscale, ``levels − 1`` downsamples,
    at the coarsest level K1 (``coarse_backend="wta"``) or the whole SGM
    pipeline of ``fused_sgm.match_pair_sgm_fused`` with ``sgm`` (default
    ``SGMConfig()``; ``"sgm"``: K6, K7, K8 or K9, K5, K3), K2 at every finer
    level (``max_base`` doubling from ``coarsest_disparities``; level 0 uses
    ``final_radius``/``final_windows``, and with ``lr_check`` also returns
    the right view), then with ``lr_check`` K4 (``D = coarsest << (levels −
    1)``) and K5, and K3. ``left``/``right``: gray [H, W] or RGB [H, W, 3]
    tensors, or arrays (on ``device``, the card by default)."""
    return _match_hierarchical(FUSED, left, right, cfg, pyr, tile_rows, lr_check,
                               coarse_backend, device, sgm)


def match_hierarchical_plain(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    device=None,
    sgm: Optional[SGMConfig] = None,
) -> dense.MatchResult:
    """The same pipeline through the kernels' plain versions, the plan's
    included (:func:`plan_level_plain`), on any device: the reference the
    kernel path is held to on the card."""
    return _match_hierarchical(PLAIN, left, right, cfg, pyr, tile_rows, lr_check,
                               coarse_backend, device, sgm)


def seeded_frame(stages: Stages, left, right, prior, cfg: MatchConfig, pyr: PyramidConfig,
                 tile_rows: int = 64, lr_check: bool = False, device=None) -> dense.MatchResult:
    """One seeded (non-key) video frame on ``stages`` (:data:`FUSED` or
    :data:`PLAIN`): level-0 refine around ``prior``, the previous frame's
    disparity, with ``max_base = coarsest << (levels − 1)``, then the
    epilogue."""
    max_base = pyr.coarsest_disparities << (pyr.levels - 1)
    out = _refine_level(
        stages, dense.grayscale(left, device), dense.grayscale(right, device), prior, cfg,
        pyr.final_radius, max_base, tile_rows, 0, None, lr_check, pyr.final_windows,
    )
    disp, disp_r = out if lr_check else (out, None)
    return _post(stages, disp, disp_r, cfg, max_base, lr_check)


def _match_temporal(stages: Stages, lefts, rights, cfg, pyr, keyframe_interval, tile_rows,
                    lr_check, coarse_backend, device, sgm=None) -> dense.MatchResult:
    if lefts.ndim not in (3, 4):
        raise ValueError(f"expected [T,H,W] or [T,H,W,C], got {tuple(lefts.shape)}")
    if keyframe_interval < 1:
        raise ValueError(f"keyframe_interval must be >= 1, got {keyframe_interval}")
    frames = []
    prev = None
    for i in range(lefts.shape[0]):
        if i % keyframe_interval == 0:
            res = _match_hierarchical(stages, lefts[i], rights[i], cfg, pyr, tile_rows,
                                      lr_check, coarse_backend, device, sgm)
        else:
            res = seeded_frame(stages, lefts[i], rights[i], prev, cfg, pyr, tile_rows,
                               lr_check, device)
        prev = res.disparity
        frames.append(res)
    return dense.MatchResult(*(torch.stack(field) for field in zip(*frames)))


def match_temporal_fused(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    keyframe_interval: int = 8,
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    device=None,
    sgm: Optional[SGMConfig] = None,
) -> dense.MatchResult:
    """Video stereo with temporal seeding (twin of ``match_temporal_pallas``)
    over stacked frames ``[T, H, W]`` (or ``[T, H, W, 3]``): frame 0 and
    every ``keyframe_interval``-th frame run :func:`match_hierarchical_fused`
    (``coarse_backend`` and ``sgm`` as there);
    every other frame runs only level-0 K2 (with its right view under
    ``lr_check``) seeded by the previous frame's output disparity, with
    ``max_base = coarsest << (levels − 1)``, then the same epilogue. The
    reference's ``lax.scan``/``lax.cond`` are a Python loop here. Returns a
    stacked :class:`MatchResult`."""
    return _match_temporal(FUSED, lefts, rights, cfg, pyr, keyframe_interval, tile_rows,
                           lr_check, coarse_backend, device, sgm)


def match_temporal_plain(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    keyframe_interval: int = 8,
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    device=None,
    sgm: Optional[SGMConfig] = None,
) -> dense.MatchResult:
    """The same video loop through the kernels' plain versions."""
    return _match_temporal(PLAIN, lefts, rights, cfg, pyr, keyframe_interval, tile_rows,
                           lr_check, coarse_backend, device, sgm)
