"""Procedural ground-truth stereo scenes (host-side, NumPy).

A copy of ``stepth_tpu/utils/scenes.py`` (which is NumPy-only), so the port
renders the same scenes without importing JAX; only the photo-texture path
differs: it takes the photographs from the caller.

The reference's only accuracy anchor is its bundled 600×400 pair with a
published-but-JPEG'd output (reference Readme.md:28-37, assets/) — no slanted
surfaces, no occlusions, no photometric mismatch. This module *creates* the
accuracy bar the reference lacks: layered renderings with exact per-pixel
ground truth on the geometry families that break block matchers:

  * slanted planes       — within-window disparity gradients (subpixel stress,
                           and the flagship refine kernel's per-(row×128) tile
                           base quantization stress: tile disparity spread vs
                           its ±R candidate window)
  * curved surfaces      — smoothly varying gradients in both axes
  * depth discontinuities— foreground layers with their OWN texture over a
                           background, so the occluded band behind an object
                           edge shows texture that genuinely does not exist in
                           the other view (no cheat matches)
  * photometric mismatch — gain/bias/noise applied to the right view only

Rendering model (rectified geometry, the framework's convention
``left(y, x) == right(y, x − d)``, d ≥ 0):

Each layer owns a disparity field D(y, x) defined on LEFT-image coordinates
and a texture attached to the left frame. The left view of a layer is its
texture read at integer coordinates; the right view is the warp
``right_k(y, u) = T_k(y, x_k(u))`` where ``x_k(u)`` inverts ``x − D(y,x) = u``
(fixed-point iteration; valid while |∂D/∂x| < 1, scenes keep slopes ≤ ~0.5).
Layers composite back-to-front in both views. A left pixel of a lower layer is
**occluded** when its right-image position is covered by a higher layer (or
falls outside the right frame) — exactly the pixels a left-right consistency
check should reject.

Textures are 4×-oversampled in x and sampled bilinearly, so both views sample
the same continuous surface (the left at exact texel centers).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_OS = 4  # texture oversampling factor along x


@dataclasses.dataclass(frozen=True)
class StereoScene:
    """A rendered ground-truth pair. All arrays are [h, w]."""

    name: str
    left: np.ndarray  # f32 gray
    right: np.ndarray  # f32 gray
    disparity: np.ndarray  # f32 ground-truth disparity on the left image
    occluded: np.ndarray  # bool: left pixels with no counterpart in right
    edges: np.ndarray  # bool: within `edge_band` px of a disparity edge

    @property
    def valid(self) -> np.ndarray:
        """Pixels where a matcher *can* be right: visible in both views."""
        return ~self.occluded


@dataclasses.dataclass(frozen=True)
class _Layer:
    disp: np.ndarray  # f32[h, w] on left coords (defined everywhere)
    mask: Optional[np.ndarray]  # bool[h, w] left-frame support; None = full
    tex: np.ndarray  # f32[h, OS*(w + margin)] texture, left frame


def _smooth_noise(rng: np.random.Generator, h: int, w: int, sigma: float,
                  lo: float = 16.0, hi: float = 240.0) -> np.ndarray:
    """Band-limited texture: uniform noise box-blurred `sigma` times, then
    contrast-stretched to [lo, hi]. Pure NumPy (no scipy dependency)."""
    t = rng.uniform(0.0, 1.0, (h, w)).astype(np.float64)
    reps = max(1, int(round(sigma)))
    for _ in range(reps):
        t = (np.pad(t, ((1, 1), (0, 0)), mode="edge")[:-2]
             + 2.0 * t
             + np.pad(t, ((1, 1), (0, 0)), mode="edge")[2:]) * 0.25
        t = (np.pad(t, ((0, 0), (1, 1)), mode="edge")[:, :-2]
             + 2.0 * t
             + np.pad(t, ((0, 0), (1, 1)), mode="edge")[:, 2:]) * 0.25
    t = t - t.min()
    m = t.max()
    if m > 0:
        t = t / m
    return (lo + t * (hi - lo)).astype(np.float32)


def _sample_x(tex: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Bilinear sample of `tex` [h, W] along x at per-pixel positions
    `xs` [h, w] given in *texture* (oversampled) coordinates."""
    W = tex.shape[1]
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 2)
    f = np.clip(xs.astype(np.float64) - x0, 0.0, 1.0).astype(np.float32)
    rows = np.arange(tex.shape[0])[:, None]
    return tex[rows, x0] * (1.0 - f) + tex[rows, x0 + 1] * f


def _interp_rowwise(field: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Linear interpolation of a per-left-pixel field [h, w] at fractional
    left-x positions `xs` [h, w] (edge-clamped)."""
    h, w = field.shape
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    f = np.clip(xs.astype(np.float64) - x0, 0.0, 1.0).astype(np.float32)
    rows = np.arange(h)[:, None]
    x1 = np.minimum(x0 + 1, w - 1)
    return field[rows, x0] * (1.0 - f) + field[rows, x1] * f


def _invert_warp(disp: np.ndarray, w: int, iters: int = 12) -> np.ndarray:
    """Solve x − D(y, x) = u for x, per right pixel u, by fixed point.
    Returns x(y, u) [h, w] in (fractional) left coordinates."""
    h = disp.shape[0]
    u = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    x = u + _interp_rowwise(disp, u)
    for _ in range(iters):
        x = u + _interp_rowwise(disp, x)
    return x


def _render(layers: List[_Layer], h: int, w: int, edge_band: int,
            name: str,
            photometric: Optional[Dict[str, float]] = None,
            rng: Optional[np.random.Generator] = None) -> StereoScene:
    """Composite `layers` (index 0 = background … last = nearest) into a
    ground-truth stereo pair."""
    # --- left view + ground truth: topmost layer per pixel -----------------
    left = None
    gt = None
    top = np.zeros((h, w), np.int32)  # index of the visible layer per pixel
    xs_left = np.arange(w, dtype=np.float32)[None, :] * _OS
    for k, L in enumerate(layers):
        img = _sample_x(L.tex, np.broadcast_to(xs_left, (h, w)))
        m = np.ones((h, w), bool) if L.mask is None else L.mask
        if left is None:
            left, gt = img.copy(), L.disp.copy()
        else:
            left = np.where(m, img, left)
            gt = np.where(m, L.disp, gt)
        top = np.where(m, k, top)

    # --- right view: back-to-front warp ------------------------------------
    right = np.zeros((h, w), np.float32)
    cover = np.full((h, w), -1, np.int32)  # topmost layer covering right px
    for k, L in enumerate(layers):
        xk = _invert_warp(L.disp, w)  # left x seen at right u
        img = _sample_x(L.tex, xk * _OS)
        if L.mask is None:
            sup = (xk >= 0.0) & (xk <= w - 1.0)
        else:
            sup = (_interp_rowwise(L.mask.astype(np.float32), xk) > 0.5) & (
                xk >= 0.0
            ) & (xk <= w - 1.0)
        right = np.where(sup, img, right)
        cover = np.where(sup, k, cover)

    # --- occlusion: the left pixel's right-image position is covered by a
    # *different* (necessarily nearer) layer, or leaves the right frame ------
    u = np.arange(w, dtype=np.float32)[None, :] - gt
    out = (u < 0.0) | (u > w - 1.0)
    cov_at_u = _interp_rowwise((cover >= 0).astype(np.float32), u) > 0.5
    top_at_u = np.rint(_interp_rowwise(cover.astype(np.float32), u)).astype(
        np.int32
    )
    occluded = out | (cov_at_u & (top_at_u != top))
    # where nothing covers u (bg leaves a hole at image edge): out of data
    occluded |= ~cov_at_u

    # --- disparity-edge band -------------------------------------------------
    gx = np.abs(np.diff(gt, axis=1, prepend=gt[:, :1]))
    gy = np.abs(np.diff(gt, axis=0, prepend=gt[:1, :]))
    e = (gx > 1.0) | (gy > 1.0)
    if edge_band > 0:
        for _ in range(edge_band):
            e = (
                e
                | np.pad(e, ((0, 0), (1, 0)))[:, :-1]
                | np.pad(e, ((0, 0), (0, 1)))[:, 1:]
                | np.pad(e, ((1, 0), (0, 0)))[:-1]
                | np.pad(e, ((0, 1), (0, 0)))[1:]
            )
    edges = e

    if photometric:
        g = photometric.get("gain", 1.0)
        b = photometric.get("bias", 0.0)
        s = photometric.get("noise", 0.0)
        right = right * g + b
        if s > 0.0:
            assert rng is not None
            right = right + rng.normal(0.0, s, right.shape).astype(np.float32)
        right = np.clip(right, 0.0, 255.0).astype(np.float32)

    return StereoScene(
        name=name,
        left=left.astype(np.float32),
        right=right.astype(np.float32),
        disparity=gt.astype(np.float32),
        occluded=occluded,
        edges=edges,
    )


def _coords(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    y = np.arange(h, dtype=np.float32)[:, None] / max(h - 1, 1)
    x = np.arange(w, dtype=np.float32)[None, :] / max(w - 1, 1)
    return np.broadcast_to(y, (h, w)).copy(), np.broadcast_to(x, (h, w)).copy()


def _tex(rng, h: int, w: int, sigma: float = 2.0) -> np.ndarray:
    """A texture wide enough for any in-range warp, oversampled in x."""
    return _smooth_noise(rng, h, _OS * (w + 8), sigma)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable bilinear resample of ``img`` to (h, w), pure NumPy."""
    H0, W0 = img.shape
    ys = np.linspace(0.0, H0 - 1.0, h)
    xs = np.linspace(0.0, W0 - 1.0, w)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H0 - 2)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W0 - 2)
    fy = (ys - y0).astype(np.float32)[:, None]
    fx = (xs - x0).astype(np.float32)[None, :]
    a = img[np.ix_(y0, x0)].astype(np.float32)
    b = img[np.ix_(y0, x0 + 1)].astype(np.float32)
    c = img[np.ix_(y0 + 1, x0)].astype(np.float32)
    d = img[np.ix_(y0 + 1, x0 + 1)].astype(np.float32)
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def load_reference_photos(paths: Tuple[str, str]) -> List[np.ndarray]:
    """Grayscale float arrays of the reference's bundled photographs — the
    only real-image ground truth the reference ships (reference
    Readme.md:28-37). Used as texture sources for photo-textured scenes.
    Unlike ``stepth_tpu.utils.scenes`` there is no default location: pass
    the two photo paths."""
    from PIL import Image  # PIL only at the array edge, like core.io

    out = []
    for p in paths:
        img = Image.open(p).convert("L")
        out.append(np.asarray(img, np.float32))
    return out


def _photo_tex(photos: List[np.ndarray], rng, h: int, w: int,
               counter: List[int]) -> np.ndarray:
    """A texture built from a random crop of a real photograph, resampled to
    the renderer's x-oversampled format. Crops are near-native scale when the
    photo is large enough (VGA scenes ≈ 1:1), so the left view carries real
    photographic statistics: JPEG blocking, low-texture walls, repeated
    structure — exactly where SAD/census matchers diverge from the
    procedural-noise families (VERDICT r4 missing #1). Alternates between
    the available photos per layer."""
    photo = photos[counter[0] % len(photos)]
    counter[0] += 1
    H0, W0 = photo.shape
    ch = min(H0, h)
    cw = min(W0, w + 8)
    y0 = int(rng.integers(0, H0 - ch + 1))
    x0 = int(rng.integers(0, W0 - cw + 1))
    crop = photo[y0 : y0 + ch, x0 : x0 + cw]
    return _resize_bilinear(crop, h, _OS * (w + 8))


def jpeg_roundtrip(img: np.ndarray, quality: int = 85) -> np.ndarray:
    """Re-encode a float gray image through JPEG at ``quality`` — the
    right-view degradation a real rig's second camera stream carries."""
    import io as _io

    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(
        buf, format="JPEG", quality=quality
    )
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32)


def _ellipse(h, w, cy, cx, ry, rx) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


SCENE_NAMES = (
    "fronto",
    "slant",
    "steep",
    "curved",
    "box",
    "ellipses",
    "photometric",
)


def make_scene(name: str, h: int, w: int, dmax: int,
               seed: int = 0, edge_band: int = 8,
               texture: str = "procedural",
               photos: Optional[List[np.ndarray]] = None,
               jpeg_right: Optional[int] = None) -> StereoScene:
    """Render one named scene at (h, w) with disparities within [0, dmax).

    ``fronto``      constant disparity (the old degenerate family; sanity)
    ``slant``       plane, ~6 px disparity spread per 128-px column tile
    ``steep``       plane at the fixed-point limit (~0.1 px/px), ~13 px/tile
    ``curved``      doubly-curved surface (sinusoidal bumps)
    ``box``         two rectangles (Δd ≈ 0.3·dmax) over a slanted background
    ``ellipses``    three elliptical layers at distinct depths
    ``photometric`` the box scene + right-view gain 1.15 / bias +8 / σ=3 noise

    ``texture="photo"`` textures every layer with crops of the real
    photographs ``photos`` (for instance from :func:`load_reference_photos`)
    instead of procedural noise — exact GT on
    real image statistics. ``jpeg_right`` re-encodes the rendered right view
    through JPEG at that quality (camera-stream degradation)."""
    # stable per-name salt: Python's str hash() is randomized per process
    # (PYTHONHASHSEED), which made every pytest process render different
    # textures — crc32 keeps scenes bit-reproducible everywhere
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    if texture == "photo":
        if photos is None:
            raise ValueError("texture='photo' needs photos= (see load_reference_photos)")
        _counter = [0]

        def tex_fn(r, th, tw, _p=photos, _c=_counter):
            return _photo_tex(_p, r, th, tw, _c)
    elif texture == "procedural":
        tex_fn = _tex
    else:
        raise ValueError(f"texture must be 'procedural' or 'photo', got {texture!r}")
    yy, xx = _coords(h, w)
    d_lo, d_hi = 0.08 * dmax, 0.92 * dmax

    def plane(frac_lo, frac_hi, gy=0.08):
        lo = d_lo + frac_lo * (d_hi - d_lo)
        hi = d_lo + frac_hi * (d_hi - d_lo)
        return (lo + (hi - lo) * xx + gy * (d_hi - d_lo) * yy).astype(
            np.float32
        )

    if name == "fronto":
        bg = _Layer(np.full((h, w), 0.4 * dmax, np.float32), None,
                    tex_fn(rng, h, w))
        layers = [bg]
        phot = None
    elif name == "slant":
        # 0.048 px/px: a 128-px column tile spans ~6 px of disparity — past
        # the refine kernel's ±R=4 single-base window but not its 2R+1 span
        base = 0.25 * dmax
        d = base + 0.048 * (xx * (w - 1)) + 0.02 * (yy * (h - 1))
        d = np.clip(d, d_lo, d_hi).astype(np.float32)
        layers = [_Layer(d, None, tex_fn(rng, h, w))]
        phot = None
    elif name == "steep":
        base = 0.15 * dmax
        d = base + 0.10 * (xx * (w - 1)) + 0.03 * (yy * (h - 1))
        d = np.clip(d, d_lo, d_hi).astype(np.float32)
        layers = [_Layer(d, None, tex_fn(rng, h, w))]
        phot = None
    elif name == "curved":
        mid = 0.5 * (d_lo + d_hi)
        amp = 0.35 * (d_hi - d_lo)
        d = mid + amp * np.sin(2 * np.pi * 1.5 * xx) * np.cos(
            2 * np.pi * 1.0 * yy
        )
        layers = [_Layer(d.astype(np.float32), None, tex_fn(rng, h, w))]
        phot = None
    elif name in ("box", "photometric"):
        bg = _Layer(plane(0.05, 0.35), None, tex_fn(rng, h, w))
        d1 = np.full((h, w), 0.70 * dmax, np.float32)
        m1 = np.zeros((h, w), bool)
        m1[int(0.18 * h): int(0.55 * h), int(0.22 * w): int(0.48 * w)] = True
        d2 = np.full((h, w), 0.50 * dmax, np.float32)
        m2 = np.zeros((h, w), bool)
        m2[int(0.50 * h): int(0.88 * h), int(0.58 * w): int(0.86 * w)] = True
        layers = [
            bg,
            _Layer(d2, m2, tex_fn(rng, h, w)),
            _Layer(d1, m1, tex_fn(rng, h, w)),
        ]
        phot = (
            {"gain": 1.15, "bias": 8.0, "noise": 3.0}
            if name == "photometric"
            else None
        )
    elif name == "ellipses":
        bg = _Layer(plane(0.08, 0.28, gy=0.05), None, tex_fn(rng, h, w))
        specs = [
            (0.30, 0.25, 0.18, 0.14, 0.45),
            (0.62, 0.55, 0.22, 0.16, 0.62),
            (0.40, 0.80, 0.16, 0.10, 0.82),
        ]
        layers = [bg]
        for cy, cx, ry, rx, df in specs:
            m = _ellipse(h, w, cy * h, cx * w, ry * h, rx * w)
            layers.append(
                _Layer(np.full((h, w), df * dmax, np.float32), m,
                       tex_fn(rng, h, w))
            )
        phot = None
    else:
        raise ValueError(f"unknown scene {name!r}; one of {SCENE_NAMES}")

    scene = _render(layers, h, w, edge_band, name, phot, rng)
    if jpeg_right is not None:
        scene = dataclasses.replace(
            scene, right=jpeg_roundtrip(scene.right, jpeg_right)
        )
    return scene


def evaluate_disparity(scene: StereoScene, disp, valid=None,
                       trim: int = 8) -> Dict[str, float]:
    """EPE/bad1/bad3 on non-occluded pixels, plus the edge-band and occluded-
    region breakdowns. `trim` crops the image border (window/pyramid apron).
    When the matcher reports a validity mask, `density` is its mean over
    non-occluded pixels and errors are measured on reported-valid pixels."""
    d = np.asarray(disp, np.float64)
    g = scene.disparity.astype(np.float64)
    err = np.abs(d - g)
    sl = (slice(trim, d.shape[0] - trim), slice(trim, d.shape[1] - trim))
    vis = scene.valid[sl]
    e = err[sl]
    edge = scene.edges[sl]
    rep = (
        np.ones(e.shape, bool)
        if valid is None
        else np.asarray(valid, bool)[sl]
    )

    def stats(m):
        if m.sum() == 0:
            return dict(epe=float("nan"), bad1=float("nan"),
                        bad3=float("nan"))
        v = e[m]
        return dict(
            epe=float(v.mean()),
            bad1=float((v > 1.0).mean()),
            bad3=float((v > 3.0).mean()),
        )

    out: Dict[str, float] = {}
    out.update(stats(vis & rep))
    out["density"] = float(rep[vis].mean()) if vis.any() else 0.0
    for k, v in stats(vis & rep & edge).items():
        out["edge_" + k] = v
    occ = ~vis
    if occ.any():
        # occluded pixels: error of whatever the matcher filled in
        vo = e[occ]
        out["occ_epe"] = float(vo.mean())
        # how well validity flags them (if reported): fraction marked invalid
        out["occ_flagged"] = (
            float((~rep)[occ].mean()) if valid is not None else 0.0
        )
    else:
        out["occ_epe"] = float("nan")
        out["occ_flagged"] = float("nan")
    return out
