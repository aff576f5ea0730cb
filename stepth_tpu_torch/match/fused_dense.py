"""Fused exhaustive matcher: kernel K1 and its plain version (twin of
``stepth_tpu/match/pallas_dense.py:85-399``).

:func:`raw_match` launches the CUDA kernel for CUDA tensors and runs
:func:`raw_match_plain` for CPU tensors. Both compute, per pixel and over all
``d < D``: the SAD/SSD cost against the right image sampled at ``x − d``
(edge-replicated), or the census Hamming distance against the right
descriptor there (column 0's descriptor where ``x − d < 0``), a zero-padded
``window``² box sum, a first-minimum WTA with parabolic subpixel for
``best ∈ [1, D−2]``, the optional uniqueness test and the right-view WTA
``costR(x, d) = costL(x + d, d)``.

Census descriptors are computed once per pair (``dense.census_pair``: the
census kernel; the plain version takes ``dense.census_pair_plain``), int32
[P, H, W], and handed to the kernel. The
kernel returns its right view packed, ``(f32 cost bits << 32) | d`` per
pixel in an int64 buffer that :func:`raw_match` fills first and decodes
(its blocks merge the right view by ``atomicMin`` on that buffer). It takes
windows up to 17 and census windows up to 11 (4 planes); :func:`raw_match`
raises for larger ones on CUDA tensors. With
``cfg.lr_threshold`` set, the fourth output also carries the LR check: the
Pallas kernel sweeps it in-kernel, but a CUDA block cannot see the right-view
disparity of other blocks' columns, so :func:`raw_match` runs K4 right after
K1 (the same ``dense.lr_consistency`` semantics) and multiplies it in.
:func:`match_pair_fused` is the ``pallas`` backend.
"""

from __future__ import annotations

from typing import Optional

import torch

from stepth_tpu_torch import kernels
from stepth_tpu_torch.config import MatchConfig
from stepth_tpu_torch.match import dense, fused_post

_BIG = 1e30
_MAX_RADIUS = 8  # the kernel's box sums are unrolled for windows up to 17
_MAX_PLANES = 4  # census descriptors of up to 128 bits (census windows up to 11)
# (bits(f32 1e30) << 32) | 0: the right view's start value, candidate "BIG at d = 0"
_RIGHT_START = 0x7149F2CA << 32

K1 = kernels.Kernel(
    "K1",
    "K1 fused_dense",
    "stepth_fused_dense",
    [kernels.PTR] * 4 + [kernels.INT] + [kernels.PTR] * 4 + [kernels.INT] * 6
    + [kernels.FLOAT, kernels.INT, kernels.INT],
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
    if cfg.cost not in ("sad", "ssd", "census"):
        raise NotImplementedError(f"fused matcher: cost {cfg.cost!r} unsupported")


def _lr_valid(valid, disp, disp_r, cfg: MatchConfig, lr_fn):
    """``valid`` times the LR check of ``disp`` against ``disp_r`` when
    ``cfg.lr_threshold`` is set (the Pallas kernel's ``ok * uok``)."""
    if cfg.lr_threshold is None:
        return valid
    ok = lr_fn(disp, disp_r, float(cfg.lr_threshold), cfg.num_disparities)
    return valid * ok.to(torch.float32)


def box_cost(lg, rg, planes, cfg: MatchConfig, d: int, row_ok) -> torch.Tensor:
    """The cost front of K1 and K6 for one disparity ``d``: the SAD/SSD cost
    against the right image at ``x − d`` (column 0 where ``x − d < 0``), or
    the census Hamming distance of ``planes = (lc, rc)`` there, zeroed on
    rows outside ``row_ok`` [H, 1], then the zero-padded ``window``² box sum
    in the kernels' order. Returns f32[H, W]."""
    w = lg.shape[1]
    r = cfg.window // 2
    xs = (torch.arange(w, device=lg.device) - d).clamp(min=0)
    if cfg.cost == "census":
        lc, rc = planes
        cost = dense.popcount32(lc ^ rc[:, :, xs]).sum(0).to(torch.float32)
    else:
        diff = lg - rg[:, xs]
        cost = diff * diff if cfg.cost == "ssd" else diff.abs()
    cost = torch.where(row_ok, cost, 0.0)
    padded = torch.nn.functional.pad(cost, (r, r, r, r))
    return box_sum_ordered(box_sum_ordered(padded, cfg.window, 0), cfg.window, 1)


def cost_inputs(lg, rg, cfg: MatchConfig, g_row0: int = 0, g_h: Optional[int] = None):
    """What :func:`box_cost` reads besides the images: the census planes
    (``dense.census_pair_plain``; ``None`` for SAD/SSD) and the in-image rows [H, 1] of an input that
    starts at global row ``g_row0`` of an image ``g_h`` rows tall."""
    h = lg.shape[0]
    gr = g_row0 + torch.arange(h, device=lg.device)
    row_ok = ((gr >= 0) & (gr < (h if g_h is None else g_h)))[:, None]
    planes = dense.census_pair_plain(lg, rg, cfg.census_window) if cfg.cost == "census" else None
    return planes, row_ok


class WtaState:
    """The running first-minimum WTA over ascending ``d`` of f32[H, W] cost
    planes, shared by the plain versions of K1, K8 and K9 (the kernels'
    ``WtaState`` in ``csrc/common.cuh``): strict ``<`` so the first minimum
    wins, its neighbours for the parabolic subpixel, the best cost outside
    its ±1 zone for ``uniqueness``, and the right view
    ``costR(x, d) = cost(x + d, d)``."""

    def __init__(self, shape, device, uniqueness: Optional[float]):
        def full(v, dtype=torch.float32):
            return torch.full(shape, v, dtype=dtype, device=device)

        self.uniqueness = uniqueness
        self.best, self.cb, self.cp1, self.bestr = full(_BIG), full(_BIG), full(_BIG), full(_BIG)
        self.cm1, self.prev = full(0.0), full(0.0)
        self.runlag2, self.second = full(_BIG), full(_BIG)
        self.bestd = self.bestrd = full(0, torch.int32)
        self.w = shape[1]

    def update(self, agg: torch.Tensor, d: int) -> None:
        upd = agg < self.best
        is_next = ~upd & (self.bestd == d - 1)
        self.cm1 = torch.where(upd, self.prev, self.cm1)
        self.cb = torch.where(upd, agg, self.cb)
        self.cp1 = torch.where(is_next, agg, self.cp1)
        if self.uniqueness is not None:
            # second best outside the ±1 zone: restart from min over [0, d−2]
            # on a new best, else accumulate costs with d > bestd + 1
            far = ~upd & (d > self.bestd + 1)
            self.second = torch.where(upd, self.runlag2, self.second)
            self.second = torch.where(far, torch.minimum(self.second, agg), self.second)
            self.runlag2 = torch.minimum(self.runlag2, self.prev + (_BIG if d < 1 else 0.0))
        self.best = torch.where(upd, agg, self.best)
        self.bestd = torch.where(upd, d, self.bestd)
        self.prev = agg

        aggr = torch.full_like(agg, _BIG)  # right view: costR(x, d) = cost(x + d, d)
        if d < self.w:
            aggr[:, : self.w - d] = agg[:, d:]
        updr = aggr < self.bestr
        self.bestr = torch.where(updr, aggr, self.bestr)
        self.bestrd = torch.where(updr, d, self.bestrd)

    def result(self, D: int):
        """``(disp, disp_r, cbest, uok)``, all f32[H, W]; ``uok`` is the
        uniqueness test as 1.0/0.0 (all ones without ``uniqueness``)."""
        denom = self.cm1 - 2.0 * self.cb + self.cp1
        delta = torch.where(denom.abs() > 1e-6, (self.cm1 - self.cp1) / (2.0 * denom), 0.0)
        delta = delta.clamp(-0.5, 0.5)
        interior = (self.bestd >= 1) & (self.bestd <= D - 2)
        bd = self.bestd.to(torch.float32)
        disp = torch.where(interior, bd + delta, bd)
        if self.uniqueness is None:
            uok = torch.ones_like(disp)
        else:
            uok = (self.cb * (1.0 + self.uniqueness) <= self.second).to(torch.float32)
        return disp, self.bestrd.to(torch.float32), self.cb, uok


def raw_match_plain(
    lg: torch.Tensor,
    rg: torch.Tensor,
    cfg: MatchConfig,
    tile_rows: int = 32,
    g_row0: int = 0,
    g_h: Optional[int] = None,
):
    """K1's plain version on gray f32[H, W] images, on any device. Returns
    ``(disp, disp_r, cbest, valid)``, all f32[H, W] (``valid`` is 1.0/0.0:
    uniqueness, times the LR check when ``cfg.lr_threshold`` is set).
    ``g_row0``/``g_h``: global row window when the inputs are a halo-extended
    row shard (rows outside ``[0, g_h)`` contribute no cost). ``tile_rows``
    is kept for signature parity; the output does not depend on it."""
    _check_cfg(cfg)
    planes, row_ok = cost_inputs(lg, rg, cfg, g_row0, g_h)
    wta = WtaState(lg.shape, lg.device, cfg.uniqueness)
    for d in range(cfg.num_disparities):
        wta.update(box_cost(lg, rg, planes, cfg, d, row_ok), d)
    disp, disp_r, cb, valid = wta.result(cfg.num_disparities)
    valid = _lr_valid(valid, disp, disp_r, cfg, fused_post.lr_consistency_plain)
    return disp, disp_r, cb, valid


def raw_match(
    lg: torch.Tensor,
    rg: torch.Tensor,
    cfg: MatchConfig,
    tile_rows: int = 32,
    g_row0: int = 0,
    g_h: Optional[int] = None,
):
    """Fused exhaustive match of gray f32[H, W] images: K1 (then K4 when
    ``cfg.lr_threshold`` is set) on CUDA tensors, :func:`raw_match_plain` on
    CPU tensors. Returns ``(disp, disp_r, cbest, valid)``, full-size and
    pre-epilogue."""
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
    if cfg.window // 2 > _MAX_RADIUS:
        raise ValueError(f"raw_match: the kernel takes windows up to {2 * _MAX_RADIUS + 1}, "
                         f"got {cfg.window}")
    disp, cbest, valid = (torch.empty_like(lg) for _ in range(3))
    # the right view's packed minima (f32 bits << 32) | d, from (BIG, d = 0)
    right = torch.full((h, w), _RIGHT_START, dtype=torch.int64, device=lg.device)
    images = (lg.data_ptr(), rg.data_ptr(), None, None, 0)
    if cfg.cost == "census":
        lc, rc = dense.census_pair(lg, rg, cfg.census_window)
        if lc.shape[0] > _MAX_PLANES:
            raise ValueError(f"raw_match: the kernel takes census windows up to 11, got "
                             f"{cfg.census_window}")
        images = (None, None, lc.data_ptr(), rc.data_ptr(), lc.shape[0])
    uniq = cfg.uniqueness
    K1.launch(
        lg.device, *images, disp.data_ptr(), right.data_ptr(), cbest.data_ptr(),
        valid.data_ptr(), h, w, D, cfg.window, int(cfg.cost == "ssd"), int(uniq is not None),
        1.0 + (uniq or 0.0), int(g_row0), h if g_h is None else int(g_h),
    )
    disp_r = (right & 0xFFFFFFFF).to(torch.float32)
    valid = _lr_valid(valid, disp, disp_r, cfg, fused_post.lr_consistency_fused)
    return disp, disp_r, cbest, valid


def _match_pair(stages, left, right, cfg, tile_rows, device):
    lg = dense.grayscale(left, device)
    rg = dense.grayscale(right, device)
    disp, _, cbest, valid_f = stages.match(lg, rg, cfg, tile_rows)
    valid = valid_f > 0.5
    disp = stages.median(stages.fill(disp, valid))
    return dense.MatchResult(disparity=disp, valid=valid, cost=cbest)


def match_pair_fused(left, right, cfg: MatchConfig = MatchConfig(), tile_rows: int = 32,
                     device=None) -> dense.MatchResult:
    """The exhaustive matcher with its epilogue (twin of
    ``match_pair_pallas``, the ``pallas`` backend): K1 (+ K4 with
    ``cfg.lr_threshold``), then the occlusion fill K5 and the median K3.
    ``left``/``right``: gray or RGB tensors, or arrays (on ``device``, the card
    by default)."""
    from stepth_tpu_torch.match.fused_refine import FUSED

    return _match_pair(FUSED, left, right, cfg, tile_rows, device)


def match_pair_plain(left, right, cfg: MatchConfig = MatchConfig(), tile_rows: int = 32,
                     device=None) -> dense.MatchResult:
    """The same through the kernels' plain versions, on any device."""
    from stepth_tpu_torch.match.fused_refine import PLAIN

    return _match_pair(PLAIN, left, right, cfg, tile_rows, device)
