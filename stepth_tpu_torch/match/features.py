"""Sparse features (twin of ``stepth_tpu/match/features.py``): Harris
corners, normalised patch descriptors and mutual-nearest matching, the
correspondence front end of :mod:`stepth_tpu_torch.fusion.epipolar`
(images → matched pixels → relative pose → rectification → the dense
matchers).

``max_corners`` corners are always returned, padded with score −inf and
``valid`` False. ``jnp.gradient`` becomes ``torch.gradient`` (central
differences, one-sided at the edges), the ``reduce_window`` max becomes
``max_pool2d`` (its padding is −inf), ``lax.top_k`` becomes ``torch.topk``
(corners of equal finite score may come in another order) and the
descriptor similarity stays a matmul.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from stepth_tpu_torch.match import dense
from stepth_tpu_torch.match.dense import to_tensor


class Corners(NamedTuple):
    xy: torch.Tensor  # f32[N, 2] (x, y), padded entries 0
    score: torch.Tensor  # f32[N], −inf on padding
    valid: torch.Tensor  # bool[N]


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3×3 box sum with zeroed edges: per axis x + x[i−1] + x[i+1], the
    neighbours outside the image 0 (the reference's rolls with the wrapped
    row or column zeroed), in the reference's order of adds."""
    for ax in (0, 1):
        z = torch.zeros_like(x.narrow(ax, 0, 1))
        prev = torch.cat([z, x.narrow(ax, 0, x.shape[ax] - 1)], ax)
        nxt = torch.cat([x.narrow(ax, 1, x.shape[ax] - 1), z], ax)
        x = x + prev + nxt
    return x


def harris_corners(img, max_corners: int = 512, k: float = 0.04, nms_radius: int = 4,
                   border: int = 8, device=None) -> Corners:
    """Harris response + max-pool non-maximum suppression + top-k on a
    grayscale f32[H, W]. Returns exactly ``max_corners`` entries, strongest
    first, padding marked invalid."""
    img = to_tensor(img, device).to(torch.float32)
    h, w = img.shape
    dy, dx = torch.gradient(img)
    ixx = _box3(dx * dx)
    iyy = _box3(dy * dy)
    ixy = _box3(dx * dy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    resp = det - k * tr * tr

    # NMS: keep pixels equal to their neighbourhood max
    win = 2 * nms_radius + 1
    pooled = F.max_pool2d(resp[None, None], win, stride=1, padding=nms_radius)[0, 0]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    cand = torch.where((resp == pooled) & inb, resp, -torch.inf)

    score, idx = torch.topk(cand.reshape(-1), max_corners)
    yi = idx // w
    xi = idx % w
    valid = torch.isfinite(score)

    # subpixel: a 1-D parabola through the response along each axis
    def parab(cm1, c0, cp1):
        denom = cm1 - 2.0 * c0 + cp1
        d = torch.where(torch.abs(denom) > 1e-12, (cm1 - cp1) / (2.0 * denom), 0.0)
        return torch.clamp(d, -0.5, 0.5)

    yc = torch.clamp(yi, 1, h - 2)
    xc = torch.clamp(xi, 1, w - 2)
    ddx = parab(resp[yc, xc - 1], resp[yc, xc], resp[yc, xc + 1])
    ddy = parab(resp[yc - 1, xc], resp[yc, xc], resp[yc + 1, xc])
    xs = xi.to(torch.float32) + ddx
    ys = yi.to(torch.float32) + ddy
    xy = torch.where(valid[:, None], torch.stack([xs, ys], -1), 0.0)
    return Corners(xy=xy, score=score, valid=valid)


def describe_patches(img, xy, size: int = 8, device=None) -> torch.Tensor:
    """Mean/variance-normalised ``(2·size+1)²`` patch descriptors at the
    integer corner locations ``xy`` [N, 2]: f32[N, (2s+1)²], unit-norm rows."""
    img = to_tensor(img, device).to(torch.float32)
    xy = to_tensor(xy, img.device)
    h, w = img.shape
    s = size
    off = torch.arange(-s, s + 1, device=img.device)
    cy = torch.clamp(xy[:, 1].to(torch.int32), s, h - 1 - s)
    cx = torch.clamp(xy[:, 0].to(torch.int32), s, w - 1 - s)
    patch = img[(cy[:, None, None] + off[None, :, None]),
                (cx[:, None, None] + off[None, None, :])].reshape(xy.shape[0], -1)
    patch = patch - patch.mean(-1, keepdim=True)
    return patch / torch.clamp(torch.linalg.vector_norm(patch, dim=-1, keepdim=True), min=1e-6)


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
                      valid2: torch.Tensor, min_similarity: float = 0.7
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-nearest-neighbour matching by cosine similarity (unit-norm
    descriptors, so one [N, N] product). Returns (the index into ``d2`` for
    each row of ``d1``, i64[N]; matched, bool[N])."""
    sim = d1 @ d2.T
    sim = torch.where(valid1[:, None] & valid2[None, :], sim, -torch.inf)
    s12, best12 = sim.max(1)
    best21 = sim.argmax(0)
    mutual = torch.arange(d1.shape[0], device=d1.device) == best21[best12]
    matched = mutual & (s12 >= min_similarity) & valid1
    return best12, matched


def match_pair_features(left, right, max_corners: int = 512, patch_size: int = 8,
                        min_similarity: float = 0.7, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images → matched pixel correspondences: Harris + normalised patches +
    mutual NN. Returns (uv1 f32[M, 2], uv2 f32[M, 2]) on the images' device,
    M data-dependent (the compaction waits for the device)."""
    lg = dense.grayscale(to_tensor(left, device).to(torch.float32))
    rg = dense.grayscale(to_tensor(right, lg.device).to(torch.float32))
    c1 = harris_corners(lg, max_corners=max_corners)
    c2 = harris_corners(rg, max_corners=max_corners)
    d1 = describe_patches(lg, c1.xy, size=patch_size)
    d2 = describe_patches(rg, c2.xy, size=patch_size)
    idx2, ok = match_descriptors(d1, d2, c1.valid, c2.valid, min_similarity)
    return c1.xy[ok], c2.xy[idx2[ok]]
