"""The semi-global matching pipeline on kernels K6–K10, each with its plain
version (twin of ``stepth_tpu/match/pallas_sgm.py``, the ``sgm-pallas``
backend).

- K6 :func:`aggregated_volume`: the box-aggregated cost volume ``[D, H, W]``
  (f32, or bf16 with ``volume_dtype="bf16"``), K1's cost front per ``d``.
- K7 :func:`scan_direction`: one SGM direction, ``acc + L`` stored in the
  volume's type (the carry stays f32). ``axis`` is the scanned volume axis
  (1: rows top to bottom, 2: columns left to right; ``reverse`` flips it),
  ``shift`` the lateral step of a diagonal: ``(axis=1, reverse, shift)`` is
  the reference's ``(reverse, shift)`` on the untransposed volume. The
  accumulator is updated in place (the reference aliases it too); the
  volume is never transposed. A scan over rows with ``128 < D ≤ 256`` on
  rows of 16-byte multiples, whose :func:`ring_schedule` needs no more
  blocks than the card has SMs (:func:`takes_ring`), runs K7's ring of
  TMA-fed step slots over that schedule; a scan with ``256 < D ≤ 512`` the
  staged kernel on its deep tiling (one step a stage over rows); every
  other scan the staged kernel. Each launch adds one to
  ``sgm.scan_ring``, ``sgm.scan_deep`` or ``sgm.scan_staged``.
- K8 :func:`scan_wta_direction`: the final ↑y scan with the whole WTA fused
  in — ``agg = acc + L`` summed in f32, kept a stage at a time in shared
  memory and never written out — returning ``(disp, disp_r, cbest, uok)``. The right view needs other columns' costs:
  the kernel merges ``(f32 bits << 32) | d`` into a u64 buffer with
  ``atomicMin`` (path costs are ≥ 0 for ``p1, p2 ≥ 0``, which the wrapper
  checks), and the wrapper decodes it.
- K9 :func:`wta_from_volume`: the same WTA from a stored volume, then K4 for
  the LR check when ``cfg.lr_threshold`` is set (as K1 does: a block cannot
  see other columns' right view).
- K10 :func:`scan_direction_carry`: K7 over the rows of one row shard,
  seeded from the upstream shard's final carry ``[D, W]`` and returning its
  own — the relay primitive of the sharded ``sgm-pallas`` path
  (``parallel/sgm_pallas_sharded.py``). A split scan relayed through it
  equals one continuous K7 scan bit for bit. It takes ``D ≤ 256``; its
  wrapper refuses more by name.

The pipeline runs the stages of ``fused_refine``'s table and keeps the
reference's rule of which path runs: with 4 or 8 directions and ``D ≤
128``, K7 for every direction but the last and K8 for ↑y (then K4 with
LR); otherwise K7 for every direction and K9.
In f32 both give the same bits; with bf16 they differ where the reference's
do (the unfused path rounds the last sum to bf16 before the WTA). Then K5
and K3. Each frame adds one to the counter ``sgm.wta_fused`` or
``sgm.wta_stored`` by the path it took; under a profiler the volume, each
scan (a diagonal one also inside ``stepth/sgm/diagonal``, and at ``D >
256`` each also inside ``stepth/sgm/deep``), the fused last scan and K9
with its K4 open ``stepth/sgm/`` spans. The reference's
``step_block``/``lane_tile`` and ``tile_rows`` only retile its TPU grid and
cannot change an output: they are accepted and ignored here.

Every wrapper runs the plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors. The plain versions share their
arithmetic with the other backends: the cost front and the WTA are
``fused_dense.box_cost``/``WtaState`` (K1's), the recurrence is
``sgm.dir_step``. With integer-valued gray inputs every cost and path sum is
an exact f32 integer, so the kernels, the plain versions and the reference
agree bit for bit in any order of adds; on float textures they add in the
same order as well.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from typing import Optional

import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import dense, fused_dense, fused_post
from stepth_tpu_torch.match import sgm as sgm_mod
from stepth_tpu_torch.utils import tracing

_SRC = "stepth_tpu_torch/csrc/fused_sgm.cu"
_REF = "stepth_tpu/match/pallas_sgm.py"
PTR, INT, FLOAT = kernels.PTR, kernels.INT, kernels.FLOAT

K6 = kernels.Kernel("K6", "K6 sgm_volume", "stepth_sgm_volume",
                    [PTR] * 4 + [INT, PTR] + [INT] * 8, source=_SRC, replaces=f"{_REF}:71")
K7 = kernels.Kernel("K7", "K7 sgm_scan", "stepth_sgm_scan",
                    [PTR] * 3 + [INT] * 6 + [FLOAT] * 2 + [PTR, INT, PTR], source=_SRC,
                    replaces=f"{_REF}:262")
K8 = kernels.Kernel("K8", "K8 sgm_scan_wta", "stepth_sgm_scan_wta",
                    [PTR, PTR, INT] + [PTR] * 4 + [INT] * 3 + [FLOAT] * 2 + [INT, FLOAT],
                    source=_SRC, replaces=f"{_REF}:748")
K9 = kernels.Kernel("K9", "K9 sgm_wta", "stepth_sgm_wta",
                    [PTR, INT] + [PTR] * 4 + [INT] * 4 + [FLOAT],
                    source=_SRC, replaces=f"{_REF}:581")
K10 = kernels.Kernel("K10", "K10 sgm_scan_carry", "stepth_sgm_scan_carry",
                     [PTR] * 5 + [INT] * 6 + [FLOAT] * 2, source=_SRC, replaces=f"{_REF}:398")

_VOLUME_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_MAX_D = 512  # K7: sixteen path costs per lane of a scan warp (the deep tiling)
_STAGED_MAX_D = 256  # K7's tiles up to here (eight path costs a lane); K8 and K10's limit
_FUSED_MAX_D = 128  # the reference's fused-WTA limit, kept so bf16 outputs agree
_RING_MIN_D = 128  # above it the staged tile's stage falls to 2 steps
RING_BAND = 16  # chains a band of K7's ring (the kernel's kRingBand)

# (axis, reverse, shift) in the reference's order of summation
_HORIZONTAL = ((2, False, 0), (2, True, 0))  # →x, ←x
_DIAGONALS = ((1, False, 1), (1, False, -1), (1, True, 1), (1, True, -1))  # ↘ ↙ ↗ ↖
_VERTICAL = ((1, False, 0), (1, True, 0))  # ↓y, ↑y (last)


def directions(n: int):
    """The ``(axis, reverse, shift)`` of each direction of an ``n``-direction
    aggregation, in the order the sums are taken."""
    if n not in (2, 4, 8):
        raise ValueError(f"directions must be 2, 4 or 8, got {n}")
    return _HORIZONTAL + (_DIAGONALS if n == 8 else ()) + (_VERTICAL if n >= 4 else ())


def volume_dtype(sgm: SGMConfig) -> torch.dtype:
    if sgm.volume_dtype not in _VOLUME_DTYPES:
        raise ValueError(f"volume_dtype must be 'f32' or 'bf16', got {sgm.volume_dtype!r}")
    return _VOLUME_DTYPES[sgm.volume_dtype]


def _check_volume(name: str, vol: torch.Tensor, max_d: int) -> None:
    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: expected f32 or bf16, got {vol.dtype}")
    kernels.check_cuda_tensor(name, vol, vol.dtype, 3)
    if not 1 <= vol.shape[0] <= max_d:
        raise ValueError(f"{name}: this scan kernel takes 1 ≤ D ≤ {max_d}, got {vol.shape[0]}")


# ---- K6 ------------------------------------------------------------------


def aggregated_volume_plain(lg, rg, cfg: MatchConfig, dtype=torch.float32, g_row0: int = 0,
                            g_h: Optional[int] = None) -> torch.Tensor:
    """K6's plain version: K1's cost front per ``d``, stored as ``dtype``
    [D, H, W]. ``g_row0``/``g_h``: the global row window of a row shard."""
    fused_dense._check_cfg(cfg)
    planes, row_ok = fused_dense.cost_inputs(lg, rg, cfg, g_row0, g_h)
    vol = torch.empty((cfg.num_disparities, *lg.shape), dtype=dtype, device=lg.device)
    for d in range(cfg.num_disparities):
        vol[d] = fused_dense.box_cost(lg, rg, planes, cfg, d, row_ok).to(dtype)
    return vol


def aggregated_volume(lg, rg, cfg: MatchConfig, dtype=torch.float32, g_row0: int = 0,
                      g_h: Optional[int] = None) -> torch.Tensor:
    """The box-aggregated cost volume ``dtype`` [D, H, W] of gray f32[H, W]
    images (twin of ``_aggregated_volume`` on the real extent): K6 on CUDA
    tensors, the plain version on CPU tensors."""
    if lg.device.type == "cpu":
        return aggregated_volume_plain(lg, rg, cfg, dtype, g_row0, g_h)
    fused_dense._check_cfg(cfg)
    kernels.check_cuda_tensor("volume left", lg, torch.float32, 2)
    kernels.check_cuda_tensor("volume right", rg, torch.float32, 2)
    if rg.shape != lg.shape or rg.device != lg.device:
        raise ValueError(f"left {tuple(lg.shape)} / right {tuple(rg.shape)} differ")
    if dtype not in (torch.float32, torch.bfloat16) or cfg.num_disparities < 1:
        raise ValueError(f"volume: need f32/bf16 and D ≥ 1, got {dtype}, {cfg.num_disparities}")
    h, w = lg.shape
    vol = torch.empty((cfg.num_disparities, h, w), dtype=dtype, device=lg.device)
    images = (lg.data_ptr(), rg.data_ptr(), None, None, 0)
    if cfg.cost == "census":
        lc, rc = dense.census_pair(lg, rg, cfg.census_window)
        images = (None, None, lc.data_ptr(), rc.data_ptr(), lc.shape[0])
    K6.launch(lg.device, *images, vol.data_ptr(), int(dtype == torch.bfloat16), h, w,
              cfg.num_disparities, cfg.window, int(cfg.cost == "ssd"), int(g_row0),
              h if g_h is None else int(g_h))
    return vol


# ---- K7 ------------------------------------------------------------------


def _plain_steps(vol: torch.Tensor, p1: float, p2: float, axis: int, reverse: bool,
                 shift: int, carry0: Optional[torch.Tensor] = None):
    """The plain scan: ``(s, L [D, T] f32)`` at each position ``s`` along
    ``axis`` of ``vol`` [D, H, W], in scan order, by ``sgm.dir_step`` on a
    ``[T, D]`` carry that starts from ``carry0`` [D, T] (zeros when None)."""
    n = vol.shape[axis]
    if carry0 is None:
        carry = torch.zeros((vol.shape[3 - axis], vol.shape[0]), dtype=torch.float32,
                            device=vol.device)
    else:
        carry = carry0.to(torch.float32).T
    for s in (range(n - 1, -1, -1) if reverse else range(n)):
        c = vol.select(axis, s).to(torch.float32).T
        carry = sgm_mod.dir_step(carry, c, shift, p1, p2)
        yield s, carry.T


def _scan_plain(vol, acc, p1, p2, axis, reverse, shift, carry0=None):
    """``(acc + L, the last L [D, T])``, the sum in ``vol``'s type written
    into ``acc`` in place."""
    _step(axis, reverse, shift)
    out = torch.empty_like(vol) if acc is None else acc
    L = None
    for s, L in _plain_steps(vol, p1, p2, axis, reverse, shift, carry0):
        v = L if acc is None else acc.select(axis, s).to(torch.float32) + L
        out.select(axis, s).copy_(v.to(vol.dtype))
    return out, L


def scan_direction_plain(vol, acc, p1: float, p2: float, *, axis: int, reverse: bool,
                         shift: int = 0) -> torch.Tensor:
    """K7's plain version: ``acc + L`` (``L`` when ``acc`` is None) in
    ``vol``'s type, written into ``acc`` in place."""
    return _scan_plain(vol, acc, p1, p2, axis, reverse, shift)[0]


def _step(axis: int, reverse: bool, shift: int):
    """``(dy, dx)`` of a chain step: ±1 along the scanned axis, ``shift``
    across it."""
    if axis not in (1, 2) or shift not in (-1, 0, 1):
        raise ValueError(f"scan: need axis 1 or 2 and shift in -1..1, got {axis}, {shift}")
    along = -1 if reverse else 1
    return (along, shift) if axis == 1 else (shift, along)


def _check_acc(name: str, acc: Optional[torch.Tensor], vol: torch.Tensor) -> None:
    if acc is not None:
        kernels.check_cuda_tensor(name, acc, vol.dtype, 3)
        if acc.shape != vol.shape or acc.device != vol.device:
            raise ValueError(f"{name} {tuple(acc.shape)} != volume {tuple(vol.shape)}")


def takes_ring(D: int, h: int, w: int, dy: int, dx: int, dtype: torch.dtype, sms: int,
               *ptrs: int) -> bool:
    """Whether a K7 launch takes the ring of TMA-fed step slots rather than
    the staged kernel: a scan that steps over rows (``dy = ±1``: the
    diagonals, ↓y and ↑y), more than 128 disparities (the staged tile's
    stage falls to 2 steps there), rows and base addresses that a bulk
    tensor copy can address (``w·itemsize`` and each pointer a multiple of
    16 bytes), and a :func:`ring_schedule` of no more blocks than the
    card's ``sms`` SMs, so that every block runs at once with all the slots
    one SM holds (wider images keep the staged kernel)."""
    if not (dy != 0 and _RING_MIN_D < D <= _STAGED_MAX_D and w * dtype.itemsize % 16 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return False
    starts, _ = ring_schedule(h, w, dy, dx)
    return len(starts) - 1 <= sms


def ring_bands(h: int, w: int, dy: int, dx: int):
    """``(c0, start, steps)`` of each band of ``RING_BAND`` neighbouring
    chains of a scan over rows (``dy = ±1``; ``dx`` 0, or ±1 for a
    diagonal), in the kernel's geometry (``ScanGeo``): chains are indexed by
    their intercept ``c = x − dx·dy·y``, a band is the chains ``[c0, c0 +
    RING_BAND)``, its steps are the rows where one of them lies in the
    image, and ``start`` is the step of the row-by-row wavefront (row 0
    first going down, row ``h − 1`` going up) at which its first row comes."""
    sl, band = dx * dy, RING_BAND
    if sl == 0:
        return [(c0, 0, h) for c0 in range(0, w, band)]
    lo = -(h - 1) if sl > 0 else 0
    out = []
    for c0 in range(lo, lo + w + h - 1, band):
        if sl > 0:  # x = c + y
            r_lo, r_hi = max(0, -(c0 + band - 1)), min(h - 1, w - 1 - c0)
        else:  # x = c − y
            r_lo, r_hi = max(0, c0 - w + 1), min(h - 1, c0 + band - 1)
        out.append((c0, r_lo if dy > 0 else h - 1 - r_hi, r_hi - r_lo + 1))
    return out


@functools.lru_cache(maxsize=64)
def ring_schedule(h: int, w: int, dy: int, dx: int):
    """The bands of each of K7's persistent ring blocks, so that every
    block's bands keep pace with one wavefront down (or up) the rows:
    neighbouring bands then write the same row at the same time, and the
    L2 merges the 32-byte sectors that a diagonal band's unaligned run
    shares with its neighbours before they reach memory. Bands go in order
    of their ``start``, each to the block whose last band ended latest at or
    before it (a new block when none has): as many blocks as bands meet one
    row, and each block's bands follow one another without overlapping.
    Returns ``(starts, c0s)``: block ``b`` runs the bands
    ``c0s[starts[b]:starts[b + 1]]`` in that order."""
    ends, owners, per = [], [], []  # ends sorted; owners[i] has its last band end at ends[i]
    for c0, start, steps in sorted(ring_bands(h, w, dy, dx), key=lambda b: (b[1], b[0])):
        i = bisect.bisect_right(ends, start) - 1
        if i < 0:
            b = len(per)
            per.append([])
        else:
            b = owners.pop(i)
            ends.pop(i)
        per[b].append(c0)
        j = bisect.bisect_right(ends, start + steps)
        ends.insert(j, start + steps)
        owners.insert(j, b)
    starts = [0]
    for p in per:
        starts.append(starts[-1] + len(p))
    return tuple(starts), tuple(c for p in per for c in p)


@functools.lru_cache(maxsize=64)
def _ring_schedule_on(device: torch.device, h: int, w: int, dy: int, dx: int):
    """``ring_schedule`` as one int32 tensor on ``device``, the kernel's
    ``sched`` (``starts``, then ``c0s``; read only), made once a shape and
    direction; with the number of blocks and of bands."""
    starts, c0s = ring_schedule(h, w, dy, dx)
    return (torch.tensor(starts + c0s, dtype=torch.int32, device=device), len(starts) - 1,
            len(c0s))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_k7(vol, acc, out, dy: int, dx: int, p1: float, p2: float) -> None:
    """K7 onto ``out``: the ring where :func:`takes_ring` says so, with its
    schedule and one word a band of scratch for the bands' progress (the
    launcher sets it), else the staged kernel (on its deep tiling at ``D >
    256``); counts ``sgm.scan_ring``, ``sgm.scan_deep`` or
    ``sgm.scan_staged``."""
    D, h, w = vol.shape
    ptrs = [t.data_ptr() for t in (vol, acc, out) if t is not None]
    sched = prog = None
    blocks = 0
    if takes_ring(D, h, w, dy, dx, vol.dtype, _sm_count(vol.device), *ptrs):
        sched, blocks, bands = _ring_schedule_on(vol.device, h, w, dy, dx)
        prog = torch.empty(bands, dtype=torch.int32, device=vol.device)
    K7.launch(vol.device, vol.data_ptr(), None if acc is None else acc.data_ptr(),
              out.data_ptr(), int(vol.dtype == torch.bfloat16), D, h, w, dy, dx, float(p1),
              float(p2), None if sched is None else sched.data_ptr(), blocks,
              None if prog is None else prog.data_ptr())
    tracing.count("sgm.scan_ring" if sched is not None else
                  "sgm.scan_deep" if D > _STAGED_MAX_D else "sgm.scan_staged")


def scan_direction(vol, acc, p1: float, p2: float, *, axis: int, reverse: bool,
                   shift: int = 0) -> torch.Tensor:
    """One SGM direction over ``vol`` [D, H, W] (twin of
    ``_scan_direction``): returns ``acc + L_dir`` (``L_dir`` when ``acc`` is
    None), updating ``acc`` in place. K7 on CUDA tensors, the plain version
    on CPU tensors."""
    if vol.device.type == "cpu":
        return scan_direction_plain(vol, acc, p1, p2, axis=axis, reverse=reverse, shift=shift)
    dy, dx = _step(axis, reverse, shift)
    _check_volume("scan volume", vol, _MAX_D)
    _check_acc("scan acc", acc, vol)
    out = torch.empty_like(vol) if acc is None else acc
    _launch_k7(vol, acc, out, dy, dx, p1, p2)
    return out


# ---- K10 -----------------------------------------------------------------


def scan_direction_carry_plain(vol, acc, carry0, p1: float, p2: float, *, reverse: bool,
                               shift: int = 0):
    """K10's plain version: K7's plain scan down (``reverse``: up) the rows
    of ``vol`` [D, S, T], started from ``carry0`` [D, T] (zeros when None)
    instead of zeros. Returns ``(acc + L, final_carry)``; the carry is
    f32 [D, T], the last row's ``L``."""
    out, L = _scan_plain(vol, acc, p1, p2, 1, reverse, shift, carry0)
    return out, L.contiguous()


def scan_direction_carry(vol, acc, carry0, p1: float, p2: float, *, reverse: bool,
                         shift: int = 0):
    """One vertical (``shift=0``) or diagonal (``shift=±1``) SGM direction
    over the rows of a row shard ``vol`` [D, S, T], seeded with the upstream
    shard's final carry ``carry0`` f32 [D, T] (None: zeros, a fresh start);
    twin of ``scan_direction_carry``. Returns ``(acc + L, final_carry)``,
    updating ``acc`` in place. K10 on CUDA tensors, the plain version on CPU
    tensors."""
    if vol.device.type == "cpu":
        return scan_direction_carry_plain(vol, acc, carry0, p1, p2, reverse=reverse,
                                          shift=shift)
    dy, dx = _step(1, reverse, shift)
    _check_volume("carry scan volume (K10, the sharded relay)", vol, _STAGED_MAX_D)
    _check_acc("carry scan acc", acc, vol)
    D, h, w = vol.shape
    if carry0 is not None:
        kernels.check_cuda_tensor("carry0", carry0, torch.float32, 2)
        if carry0.shape != (D, w) or carry0.device != vol.device:
            raise ValueError(f"carry0 {tuple(carry0.shape)} on {carry0.device}: want "
                             f"{(D, w)} on {vol.device}")
    out = torch.empty_like(vol) if acc is None else acc
    carry = torch.empty((D, w), dtype=torch.float32, device=vol.device)
    K10.launch(vol.device, vol.data_ptr(), None if acc is None else acc.data_ptr(),
               out.data_ptr(), None if carry0 is None else carry0.data_ptr(), carry.data_ptr(),
               int(vol.dtype == torch.bfloat16), D, h, w, dy, dx, float(p1), float(p2))
    return out, carry


def _aggregate(stages, vol, sgm: SGMConfig, p1: float, p2: float) -> torch.Tensor:
    acc = None
    for axis, reverse, shift in directions(sgm.directions):
        acc = stages.scan(vol, acc, p1, p2, axis=axis, reverse=reverse, shift=shift)
    return acc


def aggregate_fused(vol, sgm: SGMConfig, p1: float, p2: float) -> torch.Tensor:
    """All-directions path-cost sum over ``vol`` [D, H, W] in its type (twin
    of ``aggregate_pallas``): one K7 launch per direction, in the
    reference's order."""
    from stepth_tpu_torch.match.fused_refine import FUSED

    return _aggregate(FUSED, vol, sgm, p1, p2)


# ---- K9 ------------------------------------------------------------------


def _wta_plain(vol: torch.Tensor, uniqueness: Optional[float]):
    wta = fused_dense.WtaState(vol.shape[1:], vol.device, uniqueness)
    for d in range(vol.shape[0]):
        wta.update(vol[d].to(torch.float32), d)
    return wta.result(vol.shape[0])


def wta_from_volume_plain(vol: torch.Tensor, cfg: MatchConfig):
    """K9's plain version: K1's WTA (``fused_dense.WtaState``) over the
    planes of ``vol`` [D, H, W], then the LR check with
    ``cfg.lr_threshold``. Returns ``(disp, disp_r, cbest, valid)``, f32[H, W]."""
    disp, disp_r, cbest, valid = _wta_plain(vol, cfg.uniqueness)
    valid = fused_dense._lr_valid(valid, disp, disp_r, cfg, fused_post.lr_consistency_plain)
    return disp, disp_r, cbest, valid


def wta_from_volume(vol: torch.Tensor, cfg: MatchConfig):
    """WTA, subpixel, uniqueness and right view of ``vol`` [D, H, W] (twin
    of ``_wta_from_volume``): K9, then K4 with ``cfg.lr_threshold``, on
    CUDA tensors; the plain version on CPU tensors."""
    if vol.device.type == "cpu":
        return wta_from_volume_plain(vol, cfg)
    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wta volume: expected f32 or bf16, got {vol.dtype}")
    kernels.check_cuda_tensor("wta volume", vol, vol.dtype, 3)
    D, h, w = vol.shape
    outs = [torch.empty((h, w), dtype=torch.float32, device=vol.device) for _ in range(4)]
    uniq = cfg.uniqueness
    K9.launch(vol.device, vol.data_ptr(), int(vol.dtype == torch.bfloat16),
              *(o.data_ptr() for o in outs), D, h, w, int(uniq is not None),
              1.0 + (uniq or 0.0))
    disp, disp_r, cbest, valid = outs
    valid = fused_dense._lr_valid(valid, disp, disp_r, cfg, fused_post.lr_consistency_fused)
    return disp, disp_r, cbest, valid


# ---- K8 ------------------------------------------------------------------


def scan_wta_direction_plain(vol, acc, p1: float, p2: float, cfg: MatchConfig):
    """K8's plain version: K7's plain ↑y scan, ``acc + L`` summed in f32,
    then K9's plain WTA without the LR check."""
    agg = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    for s, L in _plain_steps(vol, p1, p2, 1, True, 0):
        agg[:, s] = acc[:, s].to(torch.float32) + L
    return _wta_plain(agg, cfg.uniqueness)


def scan_wta_direction(vol, acc, p1: float, p2: float, cfg: MatchConfig):
    """The final ↑y direction over ``vol`` [D, H, W] onto ``acc`` with the
    WTA fused in (twin of ``_scan_wta_direction``): returns
    ``(disp, disp_r, cbest, uok)``, f32[H, W]. K8 (plus a buffer fill and a
    decode) on CUDA tensors, the plain version on CPU tensors."""
    if vol.device.type == "cpu":
        return scan_wta_direction_plain(vol, acc, p1, p2, cfg)
    _check_volume("scan_wta volume", vol, _STAGED_MAX_D)
    kernels.check_cuda_tensor("scan_wta acc", acc, vol.dtype, 3)
    if acc.shape != vol.shape or acc.device != vol.device:
        raise ValueError(f"scan_wta: acc {tuple(acc.shape)} != volume {tuple(vol.shape)}")
    if p1 < 0 or p2 < 0:
        raise ValueError(f"scan_wta: the right view needs p1, p2 ≥ 0, got {p1}, {p2}")
    D, h, w = vol.shape
    disp, cbest, uok = (torch.empty((h, w), dtype=torch.float32, device=vol.device)
                        for _ in range(3))
    # all ones: the u64 start value atomicMin never keeps
    right = torch.full((h, w), -1, dtype=torch.int64, device=vol.device)
    uniq = cfg.uniqueness
    K8.launch(vol.device, vol.data_ptr(), acc.data_ptr(), int(vol.dtype == torch.bfloat16),
              disp.data_ptr(), cbest.data_ptr(), uok.data_ptr(), right.data_ptr(), D, h, w,
              float(p1), float(p2), int(uniq is not None), 1.0 + (uniq or 0.0))
    disp_r = (right & 0xFFFFFFFF).to(torch.float32)
    return disp, disp_r, cbest, uok


# ---- the pipeline --------------------------------------------------------


def _match_pair_sgm(stages, left, right, cfg: MatchConfig, sgm: SGMConfig,
                    device) -> dense.MatchResult:
    fused_dense._check_cfg(cfg)
    dirs = directions(sgm.directions)
    dtype = volume_dtype(sgm)
    lg = dense.grayscale(left, device)
    rg = dense.grayscale(right, device)
    with tracing.span("stepth/sgm/volume"):
        vol = stages.volume(lg, rg, cfg, dtype)
    p1, p2 = sgm_mod.penalties(cfg, sgm)
    fused_wta = sgm.directions in (4, 8) and cfg.num_disparities <= _FUSED_MAX_D
    tracing.count("sgm.wta_fused" if fused_wta else "sgm.wta_stored")
    deep = cfg.num_disparities > _STAGED_MAX_D
    acc = None
    for axis, reverse, shift in dirs[:-1] if fused_wta else dirs:
        with (tracing.span("stepth/sgm/scan"),
              tracing.span("stepth/sgm/diagonal") if shift else contextlib.nullcontext(),
              tracing.span("stepth/sgm/deep") if deep else contextlib.nullcontext()):
            acc = stages.scan(vol, acc, p1, p2, axis=axis, reverse=reverse, shift=shift)
    if fused_wta:
        with tracing.span("stepth/sgm/scan_wta"):
            disp, disp_r, cbest, uok = stages.scan_wta(vol, acc, p1, p2, cfg)
    else:  # K9, and K4's LR check inside its wrapper
        with tracing.span("stepth/sgm/wta"):
            disp, _, cbest, uok = stages.wta(acc, cfg)
    with tracing.span("stepth/post"):
        valid = uok > 0.5
        if fused_wta and cfg.lr_threshold is not None:
            valid = valid & stages.lr(disp, disp_r, float(cfg.lr_threshold),
                                      cfg.num_disparities)
        disp = stages.median(stages.fill(disp, valid))
    return dense.MatchResult(disparity=disp, valid=valid, cost=cbest)


def match_pair_sgm_fused(left, right, cfg: MatchConfig = MatchConfig(),
                         sgm: SGMConfig = SGMConfig(), tile_rows: int = 16,
                         device=None) -> dense.MatchResult:
    """The SGM matcher on kernels K6–K9 (twin of ``match_pair_sgm_pallas``,
    the ``sgm-pallas`` backend); K4, K5 and K3 in the epilogue.
    ``left``/``right``: gray or RGB tensors, or arrays (on ``device``, the card
    by default).
    ``tile_rows`` is accepted for signature parity and ignored."""
    from stepth_tpu_torch.match.fused_refine import FUSED

    return _match_pair_sgm(FUSED, left, right, cfg, sgm, device)


def match_pair_sgm_plain(left, right, cfg: MatchConfig = MatchConfig(),
                         sgm: SGMConfig = SGMConfig(), tile_rows: int = 16,
                         device=None) -> dense.MatchResult:
    """The same pipeline through the kernels' plain versions, on any device."""
    from stepth_tpu_torch.match.fused_refine import PLAIN

    return _match_pair_sgm(PLAIN, left, right, cfg, sgm, device)
