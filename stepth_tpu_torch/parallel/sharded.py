"""Row-tile-sharded matching over a device mesh, with halo exchange between
shards (twin of ``stepth_tpu/parallel/sharded.py``).

Image rows split evenly over the mesh's ``tile`` devices; pairs of a batch
over its ``data`` rows. Window aggregation, census support and the median
need neighbour rows, which each shard takes from its neighbours as a halo
(:func:`halo_exchange_rows`); at the true image borders the halo repeats the
edge row (``edge="replicate"``, the unsharded ``pad(mode="edge")``), and
costs of rows outside the image are zeroed (the unsharded zero-pad
clipping), so every path here equals its unsharded twin bit for bit on
integer-valued inputs. The shards this process owns run one after another
in a Python loop (:mod:`stepth_tpu_torch.parallel.mesh`); each shard's
kernels launch on its own device, and halos move with ``.to(device,
non_blocking=True)``.

A mesh may span processes (``distributed.global_mesh``). A block list then
holds None at the slots of other processes, whose rows this process never
reads; a halo from such a slot, the gathered result and the global max go
through the transport of :mod:`.distributed`, and every process returns
the same whole result, on its own first slot (``mesh.first``). The result
equals the same call on a one-process mesh of the same shape bit for bit:
the shards compute the same values, and the transport copies them.

The kernel paths (``match_pair_sharded_pallas``, the hierarchical, batched
and temporal ones) run the matcher's stage table ``stages``
(``fused_refine.FUSED`` by default; ``fused_refine.PLAIN`` runs every
kernel's plain version instead, on any device).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.match import dense, fused_refine, pyramid
from stepth_tpu_torch.parallel import distributed
from stepth_tpu_torch.parallel.mesh import Mesh, Row, make_mesh

# one entry per slot of a mesh row: a tensor, or None at another process's slot
Blocks = List[Optional[torch.Tensor]]


def required_halo(cfg: MatchConfig) -> int:
    """Rows of neighbour context one tile needs: box window radius + census
    support radius (census only) + 1 for the 3×3 median."""
    r = cfg.window // 2
    if cfg.cost == "census":
        r += cfg.census_window // 2
    return r + 1


def sublane_halo(cfg: MatchConfig, halo: Optional[int] = None) -> int:
    """The halo of the sharded ``pallas`` path: ``halo`` (default
    :func:`required_halo`) rounded up to 8 rows, as the reference's."""
    return ((required_halo(cfg) if halo is None else halo) + 7) // 8 * 8


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return make_mesh() if mesh is None else mesh


def _on(x, device) -> torch.Tensor:
    """A tensor or array as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _map(fn, blocks: Blocks) -> Blocks:
    """``fn`` of each block this process holds; None stays None."""
    return [None if b is None else fn(b) for b in blocks]


def _unzip(outs, k: int):
    """``k`` block lists from one list of ``k``-tuples (None at another
    process's slot)."""
    return tuple([None if o is None else o[j] for o in outs] for j in range(k))


def scatter_rows(x, slots) -> Blocks:
    """Split a whole image (tensor or array) ``[H, ...]`` into equal row
    blocks, block ``i`` contiguous on slot ``i``'s device. ``slots`` is a
    mesh :class:`Row`, or a sequence of devices all this process's; at a
    slot of another process the block is None, and those rows of ``x`` are
    never read."""
    devices, local = ((slots.devices, slots.is_local) if isinstance(slots, Row)
                      else (slots, lambda i: True))
    n, h = len(devices), x.shape[0]
    if h % n != 0:
        raise ValueError(f"H={h} not divisible by tile axis {n}")
    th = h // n
    return [_on(x[i * th:(i + 1) * th], d).contiguous() if local(i) else None
            for i, d in enumerate(devices)]


def gather_rows(blocks: Blocks, device, ranks=None, home: Optional[int] = 0) -> torch.Tensor:
    """The row blocks concatenated on ``device``. ``ranks``, the process
    owning each block, is given when the mesh spans processes: then every
    process gets every block (its list holds None at other processes'
    slots). Else every block but the one at slot ``home`` (None: no block
    sits at the gathering slot) is a ``gather`` move of the traffic tally."""
    if ranks is not None:
        blocks = distributed.all_gather_ordered([b for b in blocks if b is not None], ranks,
                                                device)
    else:
        for i, b in enumerate(blocks):
            if i != home:
                distributed.traffic.move("gather", b.numel() * b.element_size())
    return torch.cat([b.to(device) for b in blocks])


def _gather(mesh: Mesh, row: Row, blocks: Blocks, home: Optional[int] = 0) -> torch.Tensor:
    """A row's blocks gathered on this process's first slot; ``home`` as in
    :func:`gather_rows` (None for a data row other than the first)."""
    return gather_rows(blocks, mesh.first, row.ranks if mesh.spans_processes else None, home)


def _gray_blocks(x, row: Row) -> Blocks:
    return _map(dense.grayscale, scatter_rows(x, row))


def halo_exchange_rows(blocks: Blocks, halo: int, edge: str = "zero",
                       row: Optional[Row] = None):
    """``(top, bottom)`` halo slabs ``[halo, ...]`` of each shard, on its
    device: the last ``halo`` rows of the shard above and the first of the
    shard below. The first and last shards have no neighbour there:
    ``edge="zero"`` gives zeros, ``edge="replicate"`` repeats the shard's
    own boundary row. ``row`` (None: every block is this process's) names
    the owner of each block: slabs to and from a neighbour of another
    process go through one ``distributed.transfer`` (tag ``2i``: slot
    ``i``'s top, ``2i + 1``: its bottom), and the other processes' entries
    are None. Each slab from a neighbour is a ``permute`` move of the
    traffic tally (the transfer counts those this process sends)."""
    if edge not in ("zero", "replicate"):
        raise ValueError(f"edge must be 'zero' or 'replicate', got {edge!r}")
    n = len(blocks)
    local = (lambda j: True) if row is None else row.is_local
    sends, recvs = [], []
    for i, x in enumerate(blocks):
        if x is None:
            continue
        slab = (halo,) + tuple(x.shape[1:])
        for j, mine, tag_in, tag_out in ((i - 1, x[:halo], 2 * i, 2 * i - 1),
                                         (i + 1, x[-halo:], 2 * i + 1, 2 * i + 2)):
            if 0 <= j < n and not local(j):
                recvs.append(distributed.Recv(slab, x.dtype, x.device, row.ranks[j], tag_in))
                sends.append(distributed.Send(mine, row.ranks[j], tag_out))
    got = dict(zip((r.tag for r in recvs), distributed.transfer(sends, recvs)))
    def near(slab: torch.Tensor, device) -> torch.Tensor:
        distributed.traffic.move("permute", slab.numel() * slab.element_size())
        return slab.to(device, non_blocking=True)

    out = []
    for i, x in enumerate(blocks):
        if x is None:
            out.append(None)
            continue
        rows = (halo,) + tuple(x.shape[1:])
        if i > 0:
            top = near(blocks[i - 1][-halo:], x.device) if local(i - 1) else got[2 * i]
        elif edge == "replicate":
            top = x[:1].expand(rows)
        else:
            top = x.new_zeros(rows)
        if i < n - 1:
            bot = near(blocks[i + 1][:halo], x.device) if local(i + 1) else got[2 * i + 1]
        elif edge == "replicate":
            bot = x[-1:].expand(rows)
        else:
            bot = x.new_zeros(rows)
        out.append((top, bot))
    return out


def _with_halo(blocks: Blocks, halo: int, edge: str, row: Optional[Row] = None) -> Blocks:
    """Each shard's rows extended by ``halo`` exchanged rows on both sides."""
    return [None if x is None else torch.cat([tb[0], x, tb[1]])
            for x, tb in zip(blocks, halo_exchange_rows(blocks, halo, edge, row))]


def _median_blocks(median_fn, disps: Blocks, row: Row) -> Blocks:
    """The 3×3 median of each shard's rows over a one-row disparity halo,
    edge-replicated at the image borders."""
    return _map(lambda d: median_fn(d)[1:-1], _with_halo(disps, 1, "replicate", row))


def _result(mesh: Mesh, row: Row, disps: Blocks, valids: Blocks,
            cbests: Optional[Blocks] = None):
    """One pair's whole result from its blocks over ``row``, on this
    process's first slot."""
    disp = _gather(mesh, row, disps)
    cost = torch.zeros_like(disp) if cbests is None else _gather(mesh, row, cbests)
    return dense.MatchResult(disparity=disp, valid=_gather(mesh, row, valids), cost=cost)


# ---- the dense (XLA) matcher ---------------------------------------------


def _match_tiles(row: Row, lgs: Blocks, rgs: Blocks, cfg: MatchConfig, halo: int,
                 h_total: int):
    """Per-shard dense match of gray row blocks on rows extended by ``halo``
    (the reference's ``_match_tile``). Returns per-shard disparity, valid
    and cost blocks."""
    th = h_total // len(lgs)

    def tile(i, lg, rg):
        vol = dense.cost_volume(lg, rg, cfg)  # [th + 2·halo, W, D]
        # zero the cost of rows outside the image: box sums then match the
        # unsharded zero-pad clipping exactly
        gidx = i * th - halo + torch.arange(th + 2 * halo, device=lg.device)
        in_img = (gidx >= 0) & (gidx < h_total)
        vol = vol * in_img[:, None, None].to(vol.dtype)
        agg = dense.box_aggregate(vol, cfg.window)[halo:halo + th]
        disp, valid, cbest = dense.wta(agg, cfg.subpixel, cfg.uniqueness)
        if cfg.lr_threshold is not None:
            disp_r = dense.right_disparity_from_volume(agg)
            valid = valid & dense.lr_consistency(disp, disp_r, cfg.lr_threshold)
        return dense.fill_invalid(disp, valid), valid, cbest

    ext = zip(_with_halo(lgs, halo, "replicate", row), _with_halo(rgs, halo, "replicate", row))
    disps, valids, cbests = _unzip([None if lg is None else tile(i, lg, rg)
                                    for i, (lg, rg) in enumerate(ext)], 3)
    return _median_blocks(dense.median3, disps, row), valids, cbests


def _check_halo(th: int, halo: int, what: str = "halo") -> None:
    if th < halo:
        raise ValueError(f"tile height {th} < {what} {halo}")


def match_pair_sharded(left, right, cfg: MatchConfig = MatchConfig(),
                       mesh: Optional[Mesh] = None, halo: Optional[int] = None
                       ) -> dense.MatchResult:
    """Row-tile-sharded dense match (the ``dense`` backend) of one rectified
    pair over ``mesh``'s ``tile`` axis; equals ``dense.match_pair``."""
    mesh = _mesh(mesh)
    halo = required_halo(cfg) if halo is None else halo
    row = mesh.row(0)
    lgs, rgs = _gray_blocks(left, row), _gray_blocks(right, row)
    _check_halo(left.shape[0] // len(lgs), halo)
    return _result(mesh, row, *_match_tiles(row, lgs, rgs, cfg, halo, left.shape[0]))


def match_batch_sharded(lefts, rights, cfg: MatchConfig = MatchConfig(),
                        mesh: Optional[Mesh] = None, halo: Optional[int] = None
                        ) -> torch.Tensor:
    """Batched pairs ``[B, H, W(, C)]``: the batch shards over ``data``, the
    rows of each pair over that data row's ``tile`` devices. Returns the
    disparity f32[B, H, W] on the mesh's first device (on every process,
    each pair computed by the processes of its data row)."""
    mesh = _mesh(mesh)
    halo = required_halo(cfg) if halo is None else halo
    b, h = lefts.shape[0], lefts.shape[1]
    nd, nt = mesh.shape["data"], mesh.shape["tile"]
    if b % nd != 0:
        raise ValueError(f"B={b} not divisible by data axis {nd}")
    if h % nt != 0:
        raise ValueError(f"H={h} not divisible by tile axis {nt}")
    out = []
    for k in range(b):
        d = k // (b // nd)
        row = mesh.row(d)
        disps, _, _ = _match_tiles(row, _gray_blocks(lefts[k], row),
                                   _gray_blocks(rights[k], row), cfg, halo, h)
        out.append(_gather(mesh, row, disps, 0 if d == 0 else None))
    return torch.stack(out)


# ---- the exhaustive matcher on K1 ----------------------------------------


def match_pair_sharded_pallas(left, right, cfg: MatchConfig = MatchConfig(),
                              mesh: Optional[Mesh] = None, halo: Optional[int] = None,
                              tile_rows: int = 32, *, stages=fused_refine.FUSED
                              ) -> dense.MatchResult:
    """Row-tile sharding of the ``pallas`` backend: each shard runs K1 (+ K4
    with ``cfg.lr_threshold``) on its halo-extended rows, masking costs by
    global rows (``g_row0``/``g_h``), then the occlusion fill and the median
    in torch (``dense.fill_invalid``/``dense.median3``, as the reference).
    Equals ``fused_dense.match_pair_fused``."""
    mesh = _mesh(mesh)
    halo = sublane_halo(cfg, halo)
    row = mesh.row(0)
    lgs, rgs = _gray_blocks(left, row), _gray_blocks(right, row)
    h = left.shape[0]
    th = h // len(lgs)
    _check_halo(th, halo)

    def tile(i, lg, rg):
        disp, _, cbest, valid_f = stages.match(lg, rg, cfg, tile_rows, i * th - halo, h)
        valid = valid_f[halo:halo + th] > 0.5
        return dense.fill_invalid(disp[halo:halo + th], valid), valid, cbest[halo:halo + th]

    ext = zip(_with_halo(lgs, halo, "replicate", row), _with_halo(rgs, halo, "replicate", row))
    disps, valids, cbests = _unzip([None if lg is None else tile(i, lg, rg)
                                    for i, (lg, rg) in enumerate(ext)], 3)
    return _result(mesh, row, _median_blocks(dense.median3, disps, row), valids, cbests)


# ---- the hierarchical paths ----------------------------------------------


def _hierarchical_geometry(h: int, ntile: int, cfg: MatchConfig, pyr: PyramidConfig,
                           tile_rows: int):
    """``(tr, halo)``: the refine ``tile_rows`` shrunk until it divides the
    coarsest shard height, and the per-level halo, a
    multiple of ``tr`` so each shard-local refine tile starts at a global
    row ≡ 0 (mod ``tr``) and plans exactly as the unsharded run's tile at
    the same ``tile_rows``. These decide the refine plans, which are part of
    the output contract."""
    scale = 1 << (pyr.levels - 1)
    if h % ntile != 0:
        raise ValueError(f"H={h} not divisible by tile axis {ntile}")
    th = h // ntile
    if th % scale != 0:
        raise ValueError(f"shard height {th} not divisible by 2^(levels-1)={scale}")
    tr = (tile_rows + 7) // 8 * 8
    th_coarse = th >> (pyr.levels - 1)
    while tr > 8 and th_coarse % tr != 0:
        tr -= 8
    if th_coarse % tr != 0:
        raise ValueError(f"coarsest shard height {th_coarse} not divisible by any "
                         f"sublane-aligned tile_rows ≤ {tile_rows}")
    need = cfg.window // 2 + 1
    halo = -(-need // tr) * tr
    if th // scale < halo:
        raise ValueError(f"coarsest shard height {th // scale} < halo {halo}")
    return tr, halo


def _refine_blocks(stages, row, lgs, rgs, priors, cfg, radius, max_base, tr, halo, h, lr,
                   max_windows):
    """One refine level on every shard's halo-extended rows (image and
    prior). Returns the disparity blocks and, with ``lr``, the right view's."""
    th = h // len(lgs)

    def tile(i, lg, rg, pr):
        out = fused_refine._refine_level(stages, lg, rg, pr, cfg, radius, max_base, tr,
                                         i * th - halo, h, lr, max_windows)
        d, dr = out if lr else (out, None)
        return d[halo:halo + th], (dr[halo:halo + th] if lr else None)

    ext = zip(*(_with_halo(b, halo, "replicate", row) for b in (lgs, rgs, priors)))
    disps, disp_rs = _unzip([None if lg is None else tile(i, lg, rg, pr)
                             for i, (lg, rg, pr) in enumerate(ext)], 2)
    return disps, (disp_rs if lr else None)


def _post_blocks(stages, row, disps, disp_rs, cfg: MatchConfig, max_base: int, lr_check: bool):
    """The epilogue on every shard: LR check (``D = max_base``) and
    occlusion fill with ``lr_check``, then the median."""
    if lr_check:
        thr = 1.0 if cfg.lr_threshold is None else float(cfg.lr_threshold)
        valids = [None if d is None else stages.lr(d, dr, thr, max_base)
                  for d, dr in zip(disps, disp_rs)]
        disps = [None if d is None else stages.fill(d, v) for d, v in zip(disps, valids)]
    else:
        valids = _map(lambda d: d >= 0, disps)
    return _median_blocks(stages.median, disps, row), valids


def _width(blocks: Blocks) -> int:
    """The width of the blocks this process holds (0 if none)."""
    return next((b.shape[1] for b in blocks if b is not None), 0)


def _hierarchical_blocks(stages, row, lgs, rgs, h, cfg, pyr, tr, halo, coarse_backend, sgm,
                         lr_check):
    th = h // len(lgs)
    lefts, rights = [lgs], [rgs]
    for _ in range(pyr.levels - 1):
        lefts.append(_map(pyramid.downsample2, lefts[-1]))
        rights.append(_map(pyramid.downsample2, rights[-1]))
    coarse_cfg = MatchConfig(num_disparities=pyr.coarsest_disparities, window=cfg.window,
                             cost=cfg.cost, census_window=cfg.census_window,
                             subpixel=cfg.subpixel, lr_threshold=None)
    lvl = pyr.levels - 1
    th_l, h_l = th >> lvl, h >> lvl
    if coarse_backend == "sgm":
        # the plain-torch SGM with its exact shard-to-shard carry relay
        from stepth_tpu_torch.parallel import sgm_sharded

        disps, _, _ = sgm_sharded._sgm_tiles(
            row, lefts[-1], rights[-1], cfg=coarse_cfg,
            sgm=SGMConfig() if sgm is None else sgm, halo=required_halo(coarse_cfg), wu=0,
            h_total=h_l, exact=True)
    else:
        ext = zip(_with_halo(lefts[-1], halo, "replicate", row),
                  _with_halo(rights[-1], halo, "replicate", row))
        disps = [None if lg is None else
                 stages.match(lg, rg, coarse_cfg, min(tr, 16), i * th_l - halo, h_l)[0]
                 [halo:halo + th_l] for i, (lg, rg) in enumerate(ext)]
    max_base = pyr.coarsest_disparities
    disp_rs = None
    for lvl in range(pyr.levels - 2, -1, -1):
        th_l, h_l = th >> lvl, h >> lvl
        w_l = _width(lefts[lvl])
        priors = _map(lambda d: pyramid.upsample2_disparity(d, th_l, w_l), disps)
        max_base *= 2
        want_lr = lr_check and lvl == 0
        disps, disp_rs = _refine_blocks(
            stages, row, lefts[lvl], rights[lvl], priors, cfg,
            pyr.final_radius if lvl == 0 else pyr.refine_radius, max_base, tr, halo, h_l,
            want_lr, pyr.final_windows if lvl == 0 else pyr.refine_windows)
    return _post_blocks(stages, row, disps, disp_rs, cfg, max_base, lr_check)


def match_hierarchical_sharded(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr: Optional[PyramidConfig] = None,
    mesh: Optional[Mesh] = None,
    tile_rows: int = 32,
    coarse_backend: str = "wta",
    sgm: Optional[SGMConfig] = None,
    lr_check: bool = False,
    *,
    stages=fused_refine.FUSED,
) -> dense.MatchResult:
    """The hierarchical matcher sharded over the mesh's ``tile`` axis: every
    pyramid level runs its kernel on the shard's rows extended by an
    exchanged halo, costs clipped at global rows; the 2×2 downsampling is
    shard-local (shard heights must divide by 2^(levels−1)). At the coarsest
    level K1 (``coarse_backend="wta"``) or, with ``"sgm"``, the plain-torch
    SGM with its exact carry relay (:mod:`.sgm_sharded`, knobs from
    ``sgm``); K2 at every finer level, with the right view at level 0 under
    ``lr_check``; then K4 and K5 with ``lr_check``, and K3.

    Equal to ``fused_refine.match_hierarchical_fused`` at the same
    effective ``tile_rows`` (the shrunk one, see
    :func:`_hierarchical_geometry`) with the WTA coarse level; with the SGM
    coarse level it equals the reference's sharded path, whose coarse level
    is the XLA-style SGM (it may break exact-cost ties differently from the
    fused SGM)."""
    pyr = PyramidConfig() if pyr is None else pyr
    mesh = _mesh(mesh)
    if coarse_backend not in ("wta", "sgm"):
        raise ValueError(f"coarse_backend must be 'wta' or 'sgm', got {coarse_backend!r}")
    if lr_check and pyr.levels == 1:
        raise ValueError("lr_check needs at least one refine level")
    row = mesh.row(0)
    h = left.shape[0]
    tr, halo = _hierarchical_geometry(h, len(row.devices), cfg, pyr, tile_rows)
    lgs, rgs = _gray_blocks(left, row), _gray_blocks(right, row)
    return _result(mesh, row, *_hierarchical_blocks(stages, row, lgs, rgs, h, cfg, pyr, tr,
                                                    halo, coarse_backend, sgm, lr_check))


def _stack(results) -> dense.MatchResult:
    return dense.MatchResult(*(torch.stack(field) for field in zip(*results)))


def match_batch_hierarchical_sharded(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr: Optional[PyramidConfig] = None,
    mesh: Optional[Mesh] = None,
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    sgm: Optional[SGMConfig] = None,
    *,
    stages=fused_refine.FUSED,
) -> dense.MatchResult:
    """Data-parallel batch of whole frames ``[B, H, W(, C)]``: frame ``k``
    runs the unsharded hierarchical matcher on the first device of data row
    ``k // (B / data)``, in the process owning it; no halos, no relay. Each
    frame equals ``fused_refine.match_hierarchical_fused``. Stacked results
    on the mesh's first device, on every process."""
    pyr = PyramidConfig() if pyr is None else pyr
    mesh = _mesh(mesh)
    b, nd = lefts.shape[0], mesh.shape["data"]
    if b % nd != 0:
        raise ValueError(f"B={b} not divisible by data axis {nd}")
    slots = [(k // (b // nd), 0) for k in range(b)]
    frames = []
    for k, slot in enumerate(slots):
        if mesh.is_local(slot):
            dev = mesh.devices[slot[0]][0]
            res = fused_refine._match_hierarchical(stages, _on(lefts[k], dev),
                                                   _on(rights[k], dev), cfg, pyr, tile_rows,
                                                   lr_check, coarse_backend, None, sgm)
            if slot != (0, 0) and not mesh.spans_processes:
                for f in res:  # a frame of another data row, onto the first slot
                    distributed.traffic.move("gather", f.numel() * f.element_size())
            frames.append([f.to(mesh.first) for f in res])
    if mesh.spans_processes:
        owners = [mesh.ranks[d][t] for d, t in slots]
        fields = [distributed.all_gather_ordered([f[j] for f in frames], owners, mesh.first)
                  for j in range(3)]
        frames = list(zip(*fields))
    return _stack(frames)


def match_temporal_sharded(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr: Optional[PyramidConfig] = None,
    mesh: Optional[Mesh] = None,
    keyframe_interval: int = 8,
    tile_rows: int = 32,
    lr_check: bool = False,
    *,
    stages=fused_refine.FUSED,
) -> dense.MatchResult:
    """Temporally seeded video over the mesh's ``tile`` axis, the sharded
    twin of ``fused_refine.match_temporal_fused``: keyframes (every
    ``keyframe_interval``-th, frame 0 first) run the sharded pyramid of
    :func:`match_hierarchical_sharded`; every other frame runs only the
    level-0 refine on each shard, seeded by the previous frame's disparity
    rows with the same l/r/prior halo exchange, then the same epilogue.
    Equal to the unsharded video at the same effective ``tile_rows``."""
    pyr = PyramidConfig() if pyr is None else pyr
    mesh = _mesh(mesh)
    if keyframe_interval < 1:
        raise ValueError(f"keyframe_interval must be >= 1, got {keyframe_interval}")
    if lr_check and pyr.levels == 1:
        raise ValueError("lr_check needs at least one refine level")
    row = mesh.row(0)
    h = lefts.shape[1]
    tr, halo = _hierarchical_geometry(h, len(row.devices), cfg, pyr, tile_rows)
    max_base = pyr.coarsest_disparities << (pyr.levels - 1)
    frames, prev = [], None
    for t in range(lefts.shape[0]):
        lgs, rgs = _gray_blocks(lefts[t], row), _gray_blocks(rights[t], row)
        if t % keyframe_interval == 0:
            disps, valids = _hierarchical_blocks(stages, row, lgs, rgs, h, cfg, pyr, tr, halo,
                                                 "wta", None, lr_check)
        else:
            d, dr = _refine_blocks(stages, row, lgs, rgs, prev, cfg, pyr.final_radius, max_base,
                                   tr, halo, h, lr_check, pyr.final_windows)
            disps, valids = _post_blocks(stages, row, d, dr, cfg, max_base, lr_check)
        prev = disps
        frames.append(_result(mesh, row, disps, valids))
    return _stack(frames)


def normalize_depth_sharded(raw_depth, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Global max-normalisation of a row-sharded raw u8 depth map: the max
    over shards (and over processes), then each shard's local
    ``v · 255 // max`` to u8; an all-zero input stays all zero. On the
    mesh's first device."""
    mesh = _mesh(mesh)
    row = mesh.row(0)
    blocks = _map(lambda b: b.to(torch.int32), scatter_rows(raw_depth, row))
    m = max([int(b.max()) for b in blocks if b is not None], default=0)
    if mesh.spans_processes:
        m = int(distributed.max_over_ranks(m))
    out = _map(lambda b: (b * 255 // max(m, 1) if m > 0 else torch.zeros_like(b)
                          ).to(torch.uint8), blocks)
    return _gather(mesh, row, out)
