"""Row-tile-sharded semi-global matching in plain torch (twin of
``stepth_tpu/parallel/sgm_sharded.py``, the ``sgm`` backend sharded).

A scanline recurrence carries state across the whole image, so row shards
cut the vertical and diagonal chains at every seam. Two modes:

* ``exact=True``: horizontal scans are row-local. Each vertical or diagonal
  direction relays its ``[W, D]`` carry from shard to shard
  (:func:`_relay_dir`): the owner shard — 0…n−1 for a downward scan, n−1…0
  for an upward one — scans its rows from the upstream shard's final carry
  (``sgm.scan_dir_from``), which is the arithmetic the unsharded scan runs
  on those rows, and hands its own final carry to the next owner's device
  (through ``distributed.transfer`` when that owner is another process).
  Equal to the unsharded ``sgm`` backend bit for bit on integer inputs.
* ``exact=False``: each shard extends its rows by ``warmup`` halo rows and
  scans every direction locally. Approximate at interior seams; true image
  borders start fresh as unsharded (out-of-image rows carry zero cost).
"""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import dense
from stepth_tpu_torch.match import sgm as sgm_mod
from stepth_tpu_torch.parallel import distributed
from stepth_tpu_torch.parallel.mesh import Mesh, Row
from stepth_tpu_torch.parallel.sharded import (
    _check_halo, _gray_blocks, _map, _median_blocks, _mesh, _result, _unzip, _with_halo,
    required_halo,
)


def relay_carry(row: Row, carry, prev: int, i: int, shape, device):
    """The carry of a relay chain, leaving slot ``prev`` for slot ``i``:
    on ``i``'s device when this process owns ``i`` (received from ``prev``'s
    process if that is another), else None (sent on if this process owns
    ``prev``). Every process walks the same chain, so each hop's two ends
    meet. Each hop is a serial ``permute`` move of the traffic tally,
    counted by the process that sends it."""
    src, dst = row.ranks[prev], row.ranks[i]
    if src == dst:
        if not row.is_local(i):
            return None
        distributed.traffic.move("permute", carry.numel() * carry.element_size(), serial=True)
        return carry.to(device, non_blocking=True)
    if row.is_local(prev):
        distributed.transfer([distributed.Send(carry, dst, i)], [], serial=True)
    elif row.is_local(i):
        return distributed.transfer([], [distributed.Recv(shape, torch.float32, device, src,
                                                          i)])[0]
    return None


def _relay_dir(row: Row, vols, *, reverse: bool, shift: int, p1: float, p2: float):
    """One vertical/diagonal direction over the row-sharded volumes ``vols``
    ([th, W, D] each; None at another process's slot), the carry relayed
    shard to shard in owner order. Returns the per-shard path costs."""
    n = len(vols)
    outs = [None] * n
    carry, prev = None, None
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        v = vols[i]
        shape = None if v is None else v.shape[1:]
        if prev is not None:
            carry = relay_carry(row, carry, prev, i, shape, None if v is None else v.device)
        if v is not None:
            if prev is None:
                carry = torch.zeros(shape, dtype=torch.float32, device=v.device)
            carry, outs[i] = sgm_mod.scan_dir_from(v, carry, reverse=reverse, shift=shift,
                                                   p1=p1, p2=p2)
        prev = i
    return outs


def _aggregate_sharded(row: Row, vols, sgm: SGMConfig, p1: float, p2: float, *, exact: bool):
    """Direction sums over the per-shard volumes ``vols`` ([S, W, D]; S is
    th in exact mode, th + 2·warmup in warm-up mode), term for term in
    ``sgm.aggregate``'s order."""
    def relay(reverse, shift):
        if exact:
            return _relay_dir(row, vols, reverse=reverse, shift=shift, p1=p1, p2=p2)
        return _map(lambda v: sgm_mod._aggregate_dir(v, reverse, shift, p1, p2), vols)

    def horizontal(v):
        cols = v.transpose(0, 1)  # [W, S, D]: the horizontal scans, row-local
        out = sgm_mod._aggregate_dir(cols, False, 0, p1, p2)  # →x
        out = out + sgm_mod._aggregate_dir(cols, True, 0, p1, p2)  # ←x
        return out.transpose(0, 1)

    outs = _map(horizontal, vols)
    dirs = []
    if sgm.directions == 8:
        dirs += [(False, +1), (False, -1), (True, +1), (True, -1)]  # ↘ ↙ ↗ ↖
    if sgm.directions >= 4:
        dirs += [(False, 0), (True, 0)]  # ↓y, ↑y
    for reverse, shift in dirs:
        outs = [None if o is None else o + l for o, l in zip(outs, relay(reverse, shift))]
    return outs


def _sgm_tiles(row: Row, lgs, rgs, *, cfg: MatchConfig, sgm: SGMConfig, halo: int, wu: int,
               h_total: int, exact: bool):
    """Per-shard SGM on gray row blocks (the reference's ``_sgm_tile``):
    ``halo`` rows cover the cost window, ``wu`` more (warm-up mode only) warm
    the scans. Returns per-shard disparity, valid and cost blocks."""
    th = h_total // len(lgs)
    ext = halo + wu
    vols = []
    for i, (lg, rg) in enumerate(zip(_with_halo(lgs, ext, "replicate", row),
                                     _with_halo(rgs, ext, "replicate", row))):
        if lg is None:
            vols.append(None)
            continue
        vol = dense.cost_volume(lg, rg, cfg)  # [th + 2·ext, W, D]
        # zero cost outside the image: box sums match the unsharded clipping,
        # and warm-up scans stay zero across out-of-image rows
        gidx = i * th - ext + torch.arange(th + 2 * ext, device=lg.device)
        vol = vol * ((gidx >= 0) & (gidx < h_total))[:, None, None].to(vol.dtype)
        agg = dense.box_aggregate(vol, cfg.window)[halo:halo + th + 2 * wu]
        if wu:
            # box sums leak into out-of-image rows within the window radius;
            # re-zero them so warm-up scans cross true borders from zero
            gidx2 = i * th - wu + torch.arange(th + 2 * wu, device=lg.device)
            agg = agg * ((gidx2 >= 0) & (gidx2 < h_total))[:, None, None].to(agg.dtype)
        vols.append(agg)
    aggs = _aggregate_sharded(row, vols, sgm, *sgm_mod.penalties(cfg, sgm), exact=exact)

    def wta(agg):
        agg = agg[wu:wu + th] if wu else agg
        disp, valid, cbest = dense.wta(agg, cfg.subpixel, cfg.uniqueness)
        if cfg.lr_threshold is not None:
            disp_r = dense.right_disparity_from_volume(agg)
            valid = valid & dense.lr_consistency(disp, disp_r, cfg.lr_threshold,
                                                 cfg.num_disparities)
        return dense.fill_invalid(disp, valid), valid, cbest

    disps, valids, cbests = _unzip(_map(wta, aggs), 3)
    return _median_blocks(dense.median3, disps, row), valids, cbests


def match_pair_sgm_sharded(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    sgm: SGMConfig = SGMConfig(),
    mesh: Optional[Mesh] = None,
    exact: bool = True,
    warmup: int = 32,
    halo: Optional[int] = None,
) -> dense.MatchResult:
    """Row-tile-sharded twin of ``sgm.match_pair_sgm`` over ``mesh``'s
    ``tile`` axis. ``exact=True`` equals the unsharded backend;
    ``exact=False`` trades seam exactness for fully local scans (``warmup``
    halo rows warm the carries)."""
    mesh = _mesh(mesh)
    halo = required_halo(cfg) if halo is None else halo
    wu = 0 if exact else int(warmup)
    row = mesh.row(0)
    lgs, rgs = _gray_blocks(left, row), _gray_blocks(right, row)
    _check_halo(left.shape[0] // len(lgs), halo + wu, "halo+warmup")
    return _result(mesh, row, *_sgm_tiles(row, lgs, rgs, cfg=cfg, sgm=sgm, halo=halo, wu=wu,
                                          h_total=left.shape[0], exact=exact))
