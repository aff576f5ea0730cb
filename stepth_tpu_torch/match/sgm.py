"""Semi-global matching in plain PyTorch (twin of
``stepth_tpu/match/sgm.py:80-184``, the ``sgm`` backend).

The cost volume of :mod:`stepth_tpu_torch.match.dense`, box-aggregated, is
regularized along 1-D scanlines (Hirschmüller 2008). Per direction ``r``::

    L_r(p, d) = C(p, d) − min_d' L_r(p−r, d')
                + min( L_r(p−r, d), L_r(p−r, d∓1) + P1, min_d' L_r(p−r, d') + P2 )

and the directions are summed in the reference's order — →x, ←x, then the
diagonals ↘ ↙ ↗ ↖ (8 directions), then ↓y, and ↑y last — which the fused
pipeline (:mod:`stepth_tpu_torch.match.fused_sgm`) keeps too, so f32 sums
agree bit for bit. A scan is a Python loop over scanline positions with a
``[T, D]`` carry; diagonals shift the carry one position along T per step,
zero-filled, so pixels entering from the border start fresh (an all-zero
predecessor gives ``L = C``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stepth_tpu_torch.config import MatchConfig, SGMConfig
from stepth_tpu_torch.match import dense

__all__ = ["SGMConfig", "dir_step", "scan_dir_from", "aggregate", "match_pair_sgm"]


def dir_step(carry: torch.Tensor, c: torch.Tensor, shift: int, p1: float, p2: float):
    """One recurrence step: path costs ``L`` [T, D] at the current scanline
    position from the predecessor's ``carry`` [T, D] and the aggregated
    costs ``c`` [T, D]. ``shift`` displaces the carry along T (±1 for
    diagonals), zero-filling at the border."""
    if shift > 0:
        carry = F.pad(carry, (0, 0, shift, 0))[:-shift]
    elif shift < 0:
        carry = F.pad(carry, (0, 0, 0, -shift))[-shift:]
    min_l = carry.amin(dim=-1, keepdim=True)  # [T, 1]
    padded = F.pad(carry, (1, 1), value=float("inf"))
    cand = torch.minimum(carry, torch.minimum(padded[:, :-2] + p1, padded[:, 2:] + p1))
    cand = torch.minimum(cand, min_l + p2)
    return c + cand - min_l


def scan_dir_from(vol: torch.Tensor, carry0: torch.Tensor, *, reverse: bool, shift: int,
                  p1: float, p2: float):
    """Scan one direction over ``vol`` [S, T, D] along S from ``carry0``
    [T, D]; returns ``(final_carry, L [S, T, D])``."""
    out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    carry = carry0
    order = range(vol.shape[0] - 1, -1, -1) if reverse else range(vol.shape[0])
    for s in order:
        carry = dir_step(carry, vol[s], shift, p1, p2)
        out[s] = carry
    return carry, out


def _aggregate_dir(vol: torch.Tensor, reverse: bool, shift: int, p1: float, p2: float):
    init = torch.zeros(vol.shape[1:], dtype=torch.float32, device=vol.device)
    return scan_dir_from(vol, init, reverse=reverse, shift=shift, p1=p1, p2=p2)[1]


def aggregate(vol: torch.Tensor, sgm: SGMConfig, p1: float, p2: float) -> torch.Tensor:
    """Sum of the per-direction path costs over ``sgm.directions`` scanline
    directions, in the reference's order. ``vol`` is f32[H, W, D]."""
    if sgm.directions not in (2, 4, 8):
        raise ValueError(f"directions must be 2, 4 or 8, got {sgm.directions}")
    cols = vol.transpose(0, 1)  # [W, H, D]: scan over columns
    out = _aggregate_dir(cols, False, 0, p1, p2)  # →x
    out = out + _aggregate_dir(cols, True, 0, p1, p2)  # ←x
    out = out.transpose(0, 1)
    if sgm.directions == 8:
        out = out + _aggregate_dir(vol, False, +1, p1, p2)  # ↘
        out = out + _aggregate_dir(vol, False, -1, p1, p2)  # ↙
        out = out + _aggregate_dir(vol, True, +1, p1, p2)  # ↗
        out = out + _aggregate_dir(vol, True, -1, p1, p2)  # ↖
    if sgm.directions >= 4:
        out = out + _aggregate_dir(vol, False, 0, p1, p2)  # ↓y
        out = out + _aggregate_dir(vol, True, 0, p1, p2)  # ↑y
    return out


def penalties(cfg: MatchConfig, sgm: SGMConfig):
    """``(p1, p2)`` scaled by ``window²`` for a box-aggregated volume."""
    scale = float(cfg.window * cfg.window) if cfg.window > 1 else 1.0
    return sgm.p1 * scale, sgm.p2 * scale


def match_pair_sgm(left, right, cfg: MatchConfig = MatchConfig(),
                   sgm: SGMConfig = SGMConfig(), device=None) -> dense.MatchResult:
    """The full SGM matcher (the ``sgm`` backend): cost volume → box
    aggregation → semi-global path aggregation → WTA/subpixel → LR check →
    occlusion fill → median. Same contract as :func:`dense.match_pair`;
    ``left``/``right`` are tensors, or arrays (on ``device``, the card by
    default)."""
    lg = dense.grayscale(left, device)
    rg = dense.grayscale(right, device)
    vol = dense.box_aggregate(dense.cost_volume(lg, rg, cfg), cfg.window)
    agg = aggregate(vol, sgm, *penalties(cfg, sgm))
    disp, valid, cbest = dense.wta(agg, cfg.subpixel, cfg.uniqueness)
    if cfg.lr_threshold is not None:
        disp_r = dense.right_disparity_from_volume(agg)
        valid = valid & dense.lr_consistency(disp, disp_r, cfg.lr_threshold,
                                             cfg.num_disparities)
    disp = dense.median3(dense.fill_invalid(disp, valid))
    return dense.MatchResult(disparity=disp, valid=valid, cost=cbest)
