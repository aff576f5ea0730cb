"""The reference of the coarse-to-fine path (``hierarchical-pallas``) and its
temporally seeded video loop, in plain torch.

A keyframe: grayscale, ``levels − 1`` 2×2 average pools, the exhaustive
WTA at the coarsest level over ``coarsest_disparities``, then at every finer
level the tile-base refine around the 2×-upsampled disparity, planned per
(64 × 128) tile, with the right view at full resolution; then the LR check,
the scanline fill and the 3×3 median. A seeded frame runs only the
full-resolution refine around the previous frame's disparity (this
reference's own), then the same epilogue. The plan and the right view's
region contract are the program's output contract, copied here.

With a ``record`` list, each step appends the launch the program's kernel
path makes for it (``roofline.launch``), counted from this reference's own
plans.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from portbench import roofline
from portbench.reference import common

TILE_ROWS = 64  # the pipeline's refine tile height (the plan's contract)
_TW = 128  # plan tile width
_CW = 256  # the right view's cost-region width
_UNTOUCHED = torch.iinfo(torch.int64).max


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def downsample2(gray: torch.Tensor) -> torch.Tensor:
    """2×2 average, odd trailing row/column dropped: (top + bottom), then
    (left + right), then × 0.25."""
    h, w = gray.shape
    g = gray[: h // 2 * 2, : w // 2 * 2]
    v = g[0::2] + g[1::2]
    return (v[:, 0::2] + v[:, 1::2]) * 0.25


def upsample2_disparity(disp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2× upsample to (h, w), values doubled; odd targets
    edge-padded."""
    up = disp.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1) * 2.0
    up = up[:h, :w]
    ph, pw = h - up.shape[0], w - up.shape[1]
    if ph or pw:
        rows = torch.arange(h, device=up.device).clamp(max=up.shape[0] - 1)
        cols = torch.arange(w, device=up.device).clamp(max=up.shape[1] - 1)
        up = up[rows][:, cols]
    return up


def tile_windows(prior: torch.Tensor, tile_rows: int, max_base: int, radius: int,
                 max_windows: int):
    """The plan ``(bases i32[nr, nc, K], nw i32[nr, nc])`` of a prior padded
    to whole tiles: one ``round(mean) ± radius`` window where the tile's
    prior fits it, else a greedy ``± radius`` cover of its 8×8-subtile
    means, lowest uncovered first; ``K`` capped at ``ceil((max_base + 1) /
    (2·radius + 1))`` (a cap of 1 gives ``K = 2``, ``nw = 1``)."""
    hp, wp = prior.shape
    nr, nc = hp // tile_rows, wp // _TW
    mean = prior.reshape(nr, tile_rows, nc, _TW).mean(dim=(1, 3))
    b_mean = torch.round(mean).clamp(0, max_base).to(torch.int32)
    max_windows = min(max_windows, -(-(max_base + 1) // (2 * radius + 1)))
    if max_windows <= 1:
        bases = b_mean[..., None].expand(nr, nc, 2).contiguous()
        return bases, torch.ones_like(b_mean)
    # 8×8 subtile means, summed in row-major window order
    pooled = torch.zeros((hp // 8, wp // 8), dtype=prior.dtype, device=prior.device)
    for dy in range(8):
        for dx in range(8):
            pooled = pooled + prior[dy::8, dx::8]
    pooled = pooled * (1.0 / 64.0)
    sub = pooled.reshape(nr, tile_rows // 8, nc, _TW // 8)
    sub = sub.permute(0, 2, 1, 3).reshape(nr, nc, -1)
    blo = torch.minimum(torch.floor(sub.amin(-1)).clamp(0, max_base), b_mean)
    bhi = torch.maximum(torch.ceil(sub.amax(-1)).clamp(0, max_base), b_mean)
    one = (b_mean - blo <= radius) & (bhi - b_mean <= radius)
    uncov = torch.ones(sub.shape, dtype=torch.bool, device=prior.device)
    bases = []
    nw = torch.zeros_like(b_mean)
    for _ in range(max_windows):
        v = torch.where(uncov, sub, common.BIG).amin(-1)
        vhi = torch.where(uncov & (sub <= v[..., None] + 2 * radius), sub, -common.BIG)
        vhi = torch.maximum(vhi.amax(-1), v)
        c = torch.round((v + vhi) * 0.5).clamp(0, max_base).to(torch.int32)
        bases.append(c)
        nw = nw + (v < common.BIG).to(torch.int32)
        uncov = uncov & (sub > c[..., None].to(torch.float32) + radius)
    bases = torch.stack(bases, dim=-1)
    bases = torch.where(one[..., None], b_mean[..., None], bases)
    nw = torch.where(one, 1, nw.clamp(min=1)).to(torch.int32)
    return bases, nw


def plan(prior: torch.Tensor, max_base: int, radius: int, max_windows: int):
    """The prior edge-padded to whole (64 × 128) tiles, then its plan."""
    h, w = prior.shape
    rows = torch.arange(_round_up(h, TILE_ROWS), device=prior.device).clamp(max=h - 1)
    cols = torch.arange(_round_up(w, _TW), device=prior.device).clamp(max=w - 1)
    return tile_windows(prior[rows][:, cols], TILE_ROWS, max_base, radius, max_windows)


def _images(lg, rg, match: dict):
    if match["cost"] == "census":
        return common.census_pair(lg, rg, match["census_window"])
    return lg[None], rg[None]


def _emit_right(packed, bases, radius: int) -> torch.Tensor:
    """Decode packed per-column minima (``cost bits << 32 | key``, −1 where
    none arrived) into the right view: key ``(jc·K + wi)·(2R+1) + o + R`` →
    ``bases[y // 64, jc, wi] + o``; −1e6 where untouched."""
    h, w = packed.shape
    nc, K = bases.shape[1:]
    n = 2 * radius + 1
    key = packed & 0xFFFFFFFF
    o = key % n - radius
    jc, wi = (key // n // K).clamp(max=nc - 1), key // n % K
    i = (torch.arange(h, device=packed.device) // TILE_ROWS)[:, None].expand(h, w)
    s = bases[i, jc, wi] + o
    return torch.where(packed == -1, -1e6, s.to(torch.float32))


def refine(lg, rg, bases, nw, match: dict, radius: int, lr: bool, q):
    """The refine of one level for a plan: every tile's candidates ``base +
    o``, ``o ∈ ±radius``, costed over the tile's box halo at the tile's own
    candidate; the first minimum in (window, offset) order with a parabolic
    subpixel where the offset is interior. With ``lr`` each tile costs its
    whole 256-column region (box sums wrapping mod 256) and scatter-mins
    its candidates into the right view by ``(cost, tile, window, offset)``.
    Returns ``disp`` or ``(disp, disp_r)``."""
    h, w = lg.shape
    nr, nc, K = bases.shape
    win, R, TH = match["window"], radius, TILE_ROWS
    r = win // 2
    M = _round_up(2 * r, 8)
    if R >= 64 or M + _TW + 2 * r > _CW:
        raise ValueError(f"refine: radius {R} or window {win} out of the region contract")
    off, Q = (M, _CW) if lr else (r, _TW + 2 * r)
    dev = lg.device
    ys = torch.arange(nr, device=dev)[:, None] * TH - r + torch.arange(TH + 2 * r, device=dev)
    xs = torch.arange(nc, device=dev)[:, None] * _TW - off + torch.arange(Q, device=dev)
    SR = ys.shape[1]
    row_ok = (ys >= 0) & (ys < h)
    col_ok = (xs >= 0) & (xs < w)
    in_img = row_ok[:, :, None, None] & col_ok[None, None]
    yc = ys.clamp(0, h - 1)
    lsrc, rsrc = _images(lg, rg, match)
    P = lsrc.shape[0]
    left = lsrc[:, yc][..., xs.clamp(0, w - 1)]
    right_rows = rsrc[:, yc]
    shape = (nr, TH, nc, _TW)

    def full(v, dtype=torch.float32, shape=shape):
        return torch.full(shape, v, dtype=dtype, device=dev)

    best, cb, cp1, cm1 = full(common.BIG), full(common.BIG), full(common.BIG), full(0.0)
    bests = full(0, torch.int32)
    oi = full(-2, torch.int32)
    wbest = full(-1, torch.int32)
    if lr:
        packed = torch.full((h * w,), _UNTOUCHED, dtype=torch.int64, device=dev)
        y_out = (torch.arange(nr, device=dev)[:, None] * TH
                 + torch.arange(TH, device=dev))[:, :, None, None]
    for wi in range(K):
        active = ((nw > wi) | (wi == 0))[:, None, :, None]
        prev = full(0.0)
        if lr:
            rshape = (nr, TH, nc, _CW - 2 * R)
            rbest, roff = full(common.BIG, shape=rshape), full(-1, torch.int64, rshape)
            u = (xs[None, :, 2 * R:] - R - bases[:, :, wi, None])[:, None]
        for o in range(-R, R + 1):
            s = bases[:, :, wi] + o
            xsrc = xs[None] - s[:, :, None]
            bad = ((xsrc < 0) | (xsrc >= w))[:, None]
            idx = xsrc.clamp(0, w - 1).reshape(1, nr, 1, nc * Q).expand(P, nr, SR, nc * Q)
            rs = torch.gather(right_rows, 3, idx).reshape(P, nr, SR, nc, Q)
            if match["cost"] == "census":
                cost = common.pixel_cost(left, rs, "census")
            else:
                cost = common.pixel_cost(left[0], rs[0], match["cost"])
            cost = torch.where(bad, 1e6, cost)
            cost = torch.where(in_img, cost, 0.0)
            vert = common.box_sum_ordered(cost, win, 1)
            if lr:
                if r:
                    vert = torch.cat([vert[..., -r:], vert, vert[..., :r]], dim=3)
                region = q(common.box_sum_ordered(vert, win, 3))
                agg = region[..., M: M + _TW]
            else:
                agg = q(common.box_sum_ordered(vert, win, 3))
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
                cand = region[..., R + o: _CW - R + o]
                xc = xs[None, None, :, R + o: _CW - R + o]
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
    if lr:
        packed = torch.where(packed == _UNTOUCHED, -1, packed).reshape(h, w)
        return disp, _emit_right(packed, bases, R)
    return disp


def _planes(match: dict) -> int:
    if match["cost"] != "census":
        return 1
    return -(-(match["census_window"] ** 2 - 1) // 32)


def _record_refine(record, match, h, w, bases, nw, radius, lr):
    """The refine kernel's launch (and its right view's decode with ``lr``):
    both views' matched planes read, the plan read, the disparity (and the
    packed right view) written; operations per candidate the plan runs."""
    if record is None:
        return
    P = _planes(match)
    nr, nc, K = bases.shape
    rows = (h - torch.arange(nr, device=nw.device) * TILE_ROWS).clamp(max=TILE_ROWS)
    cols = (w - torch.arange(nc, device=nw.device) * _TW).clamp(max=_TW)
    cand = int((nw.clamp(min=1) * rows[:, None] * cols[None, :]).sum()) * (2 * radius + 1)
    nbytes = 8 * P * h * w + 4 * (bases.numel() + nw.numel()) + 4 * h * w + (8 * h * w if lr else 0)
    ops = cand * (roofline.cost_ops(match["cost"], match["window"], P) + 1)
    record.append(roofline.launch("fused_refine_kernel", nbytes, ops))
    if lr:
        record.append(roofline.launch("refine_emit_r_kernel", 12 * h * w + 4 * bases.numel(), 0))


def _record_post(record, h, w):
    """The epilogue's three launches: LR check, fill, median."""
    if record is not None:
        record += [roofline.launch("lr_check_kernel", 9 * h * w, 12 * h * w),
                   roofline.launch("fill_invalid_kernel", 9 * h * w, 4 * h * w),
                   roofline.launch("median3_kernel", 8 * h * w, 38 * h * w)]


def coarse_wta(lg, rg, match: dict, D: int, q, record):
    """The exhaustive WTA over ``d < D`` with subpixel: the coarse level."""
    planes = _images(lg, rg, match) if match["cost"] == "census" else None
    wta = common.Wta(lg.shape, lg.device)
    for d in range(D):
        wta.update(common.box_cost(lg, rg, planes, match, d, q), d)
    if record is not None:
        h, w = lg.shape
        P = _planes(match)
        record.append(roofline.launch(
            "fused_dense_kernel", 8 * P * h * w + 20 * h * w,
            h * w * D * (roofline.cost_ops(match["cost"], match["window"], P) + 2)))
    return wta.result(D)[0]


def keyframe(left, right, cfg: dict, q, record=None):
    """The full pyramid on f32 RGB [H, W, 3]: ``(disparity, valid)``."""
    match, pyr = cfg["match"], cfg["pyramid"]
    levels = pyr["levels"]
    lefts, rights = [common.grayscale(left)], [common.grayscale(right)]
    for _ in range(levels - 1):
        lefts.append(downsample2(lefts[-1]))
        rights.append(downsample2(rights[-1]))
    disp = coarse_wta(lefts[-1], rights[-1], match, pyr["coarsest_disparities"], q, record)
    max_base = pyr["coarsest_disparities"]
    disp_r = None
    for lvl in range(levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = upsample2_disparity(disp, h, w)
        max_base *= 2
        radius = _final(pyr, "radius") if lvl == 0 else pyr["refine_radius"]
        windows = _final(pyr, "windows") if lvl == 0 else pyr["refine_windows"]
        lr = cfg["lr_check"] and lvl == 0
        bases, nw = plan(prior, max_base, radius, windows)
        out = refine(lefts[lvl], rights[lvl], bases, nw, match, radius, lr, q)
        _record_refine(record, match, h, w, bases, nw, radius, lr)
        disp, disp_r = out if lr else (out, None)
    return _post(disp, disp_r, cfg, max_base, record)


def seeded(left, right, prior, cfg: dict, q, record=None):
    """A non-key video frame: the full-resolution refine around ``prior``."""
    match, pyr = cfg["match"], cfg["pyramid"]
    max_base = pyr["coarsest_disparities"] << (pyr["levels"] - 1)
    lg, rg = common.grayscale(left), common.grayscale(right)
    radius, windows = _final(pyr, "radius"), _final(pyr, "windows")
    bases, nw = plan(prior, max_base, radius, windows)
    out = refine(lg, rg, bases, nw, match, radius, cfg["lr_check"], q)
    _record_refine(record, match, *lg.shape, bases, nw, radius, cfg["lr_check"])
    disp, disp_r = out if cfg["lr_check"] else (out, None)
    return _post(disp, disp_r, cfg, max_base, record)


def _final(pyr: dict, what: str) -> int:
    v = pyr.get(f"refine_{what}_final")
    return pyr[f"refine_{what}"] if v is None else v


def _post(disp, disp_r, cfg, max_base, record):
    h, w = disp.shape
    if cfg["lr_check"]:
        _record_post(record, h, w)
        return common.epilogue(disp, disp_r, cfg["match"]["lr_threshold"], max_base)
    if record is not None:
        record.append(roofline.launch("median3_kernel", 8 * h * w, 38 * h * w))
    disp = common.median3(disp)
    return disp, disp >= 0


def check_config(cfg: dict) -> None:
    """Raise on what this reference does not follow."""
    m = cfg["match"]
    if cfg["backend"] != "hierarchical-pallas":
        raise ValueError(f"hierarchical reference: backend {cfg['backend']!r}")
    if m["cost"] not in ("sad", "ssd", "census") or m["uniqueness"] is not None \
            or not m["subpixel"]:
        raise ValueError("hierarchical reference: needs sad/ssd/census, subpixel, no uniqueness")


def run_call(lefts, rights, cfg: dict, entry: dict, precision: str = "f32",
             record: Optional[List[dict]] = None):
    """The outputs of one served call on f32 RGB frames [T, H, W, 3]:
    a ``(disparity, valid)`` per frame. ``entry["keyframe_interval"]``: the
    video loop's keyframes (a call starts at one); absent, every frame is a
    keyframe. ``record``: a list per frame of its launches."""
    check_config(cfg)
    q = common.quantizer(precision)
    kfi = entry.get("keyframe_interval") or 1
    outs, prev = [], None
    for t in range(lefts.shape[0]):
        rec = None if record is None else []
        if t % kfi == 0:
            out = keyframe(lefts[t], rights[t], cfg, q, rec)
        else:
            out = seeded(lefts[t], rights[t], prev, cfg, q, rec)
        prev = out[0]
        outs.append(out)
        if record is not None:
            record.append(rec)
    return outs
