"""Row-tile-sharded semi-global matching on the kernels (twin of
``stepth_tpu/parallel/sgm_pallas_sharded.py``, ``sgm-pallas`` sharded).

Each shard builds its volume with K6 on its rows extended by an exchanged
halo (``g_row0``/``g_h`` mask the rows outside the image), then:

* ``exact=True``: the horizontal directions run shard-local (K7 along the
  columns); each vertical and diagonal direction is one K10 launch per
  shard in owner order — shards 0…n−1 for ↓y, ↘, ↙ and n−1…0 for ↑y, ↗, ↖
  — each seeded with the upstream shard's final carry (f32 ``[D, W]``),
  which then moves to the next owner's device (through
  ``distributed.transfer`` when that owner is another process: a process
  scans only the shards it owns, but sends or receives at every hop that
  ends at one of them). Only the owner runs a round:
  the reference's SPMD rounds, where non-owners scan a garbage seed and are
  masked out, are the same arithmetic. The directions are summed in the
  unsharded order, so the output equals the unsharded ``sgm-pallas``
  backend bit for bit, at 2, 4 and 8 directions (the port never transposes
  a volume). The scans run in f32 whatever ``volume_dtype`` says, as the
  reference's do: a bf16 volume is rounded to bf16, then scanned in f32, so
  bf16 exact mode is not the unsharded bf16 output.
* ``exact=False``: ``warmup`` (rounded up to 8) more halo rows warm the
  scans, zeroed outside the image so true borders start fresh; every
  direction runs shard-local with K7 in the volume's type. Approximate at
  interior seams.

Then each shard runs K9 (with K4 under ``cfg.lr_threshold``) and K5 on its
own rows, and K3 over a one-row disparity halo, the stages of ``stages``
(``fused_refine.PLAIN``: the plain versions). Results land on the mesh's
first device (on every process, for a mesh that spans processes).
"""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import dense, fused_dense, fused_refine, fused_sgm
from stepth_tpu_torch.match import sgm as sgm_mod
from stepth_tpu_torch.parallel.mesh import Mesh, Row
from stepth_tpu_torch.parallel.sgm_sharded import relay_carry
from stepth_tpu_torch.parallel.sharded import (
    _check_halo, _gray_blocks, _map, _median_blocks, _mesh, _result, _unzip, _with_halo,
    required_halo,
)


def _relay_dir(stages, row: Row, vols, accs, *, reverse: bool, shift: int, p1: float,
               p2: float):
    """One relayed direction: a K10 launch per shard this process owns, in
    owner order, each onto its shard's accumulator, the final carry (f32
    ``[D, W]``) moved to the next owner."""
    carry, prev = None, None
    for i in (range(len(vols) - 1, -1, -1) if reverse else range(len(vols))):
        v = vols[i]
        if prev is not None:
            carry = relay_carry(row, carry, prev, i, None if v is None else
                                (v.shape[0], v.shape[2]), None if v is None else v.device)
        if v is not None:
            accs[i], carry = stages.scan_carry(v, accs[i], carry, p1, p2, reverse=reverse,
                                               shift=shift)
        prev = i


def _exact_agg(stages, row: Row, vols, sgm: SGMConfig, p1: float, p2: float):
    """The direction sum of exact mode, in the unsharded order: the
    horizontals shard-local, every other direction relayed."""
    accs = [None] * len(vols)
    for axis, reverse, shift in fused_sgm.directions(sgm.directions):
        if axis == 2:
            accs = [None if v is None else stages.scan(v, a, p1, p2, axis=2, reverse=reverse,
                                                       shift=shift)
                    for v, a in zip(vols, accs)]
        else:
            _relay_dir(stages, row, vols, accs, reverse=reverse, shift=shift, p1=p1, p2=p2)
    return accs


def _wta_epilogue(stages, row: Row, aggs, cfg: MatchConfig):
    """WTA, uniqueness and LR (K9, K4), the fill (K5) on each shard's rows,
    then the median (K3) over a one-row disparity halo."""
    def wta(agg):
        disp, _, cbest, valid_f = stages.wta(agg, cfg)
        valid = valid_f > 0.5
        return stages.fill(disp, valid), valid, cbest

    disps, valids, cbests = _unzip(_map(wta, aggs), 3)
    return _median_blocks(stages.median, disps, row), valids, cbests


def match_pair_sgm_pallas_sharded(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    sgm: SGMConfig = SGMConfig(),
    mesh: Optional[Mesh] = None,
    exact: bool = True,
    warmup: int = 32,
    halo: Optional[int] = None,
    *,
    stages=fused_refine.FUSED,
) -> dense.MatchResult:
    """Row-tile-sharded twin of ``fused_sgm.match_pair_sgm_fused`` over
    ``mesh``'s ``tile`` axis (see the module docstring for the two modes).
    Shard heights must be multiples of 8 and at least ``halo`` (+ the
    rounded ``warmup`` in windowed mode) rows."""
    mesh = _mesh(mesh)
    halo = required_halo(cfg) if halo is None else halo
    fused_dense._check_cfg(cfg)
    fused_sgm.directions(sgm.directions)  # raises on a bad count
    dtype = fused_sgm.volume_dtype(sgm)
    row = mesh.row(0)
    h = left.shape[0]
    if h % len(row.devices) != 0:
        raise ValueError(f"H={h} not divisible by tile axis {len(row.devices)}")
    th = h // len(row.devices)
    if th % 8 != 0:
        raise ValueError(f"tile height {th} must be a multiple of 8")
    wu = 0 if exact else fused_refine._round_up(int(warmup), 8)
    _check_halo(th, halo + wu, "halo+warmup")
    lgs, rgs = _gray_blocks(left, row), _gray_blocks(right, row)
    ext, rows = halo + wu, th + 2 * wu
    vols = []
    for i, (lg, rg) in enumerate(zip(_with_halo(lgs, ext, "replicate", row),
                                     _with_halo(rgs, ext, "replicate", row))):
        if lg is None:
            vols.append(None)
            continue
        vol = stages.volume(lg, rg, cfg, dtype, i * th - ext, h)[:, halo:halo + rows]
        if wu:
            # K6's global row mask already zeroes out-of-image rows' box
            # sums; re-zero the sliced rows too, so warm-up scans cross true
            # borders with an all-zero carry
            gidx = i * th - wu + torch.arange(rows, device=vol.device)
            vol = vol * ((gidx >= 0) & (gidx < h))[None, :, None].to(vol.dtype)
        vols.append(vol.contiguous())
    p1, p2 = sgm_mod.penalties(cfg, sgm)
    if exact:
        aggs = _exact_agg(stages, row, _map(lambda v: v.to(torch.float32), vols), sgm, p1, p2)
    else:
        aggs = _map(lambda v: fused_sgm._aggregate(stages, v, sgm, p1, p2)
                    [:, wu:wu + th].contiguous(), vols)
    return _result(mesh, row, *_wta_epilogue(stages, row, aggs, cfg))
