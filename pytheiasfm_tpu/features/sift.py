"""Upright SIFT in pure JAX — scale-space keypoints + 128-D descriptors.

Replaces the OpenCV SIFT the reference's Python pipelines call
(`pytests/sfm_pipeline.py:175-230`: `cv2.SIFT_create` -> detectAndCompute)
with an on-device implementation:

  pyramid     separable Gaussian convolutions (`lax.conv_general_dilated`)
              over a fixed octave/scale grid — static shapes, dense elementwise/matmul work
  detection   vectorized 26-neighbor DoG extrema + contrast and edge
              (Hessian-ratio) gates, top-K per octave via `lax.top_k`
  descriptor  per-keypoint 16x16 gradient patches (batched dynamic_slice),
              4x4 spatial x 8 orientation bins with bilinear soft
              assignment as one einsum, SIFT normalize-clip-renormalize

Orientation: `SiftParams.upright=True` (default) skips dominant-orientation
assignment — cheapest, and right for the level-horizon photo collections
SfM targets. `upright=False` adds the 36-bin gradient-histogram dominant
orientation + rotated descriptor sampling (full in-plane rotation
invariance, like the reference pipelines' OpenCV SIFT); quality asserted
pixels-to-pose in `tests/test_sift_quality.py`. Every stage is jitted with
static image shape, so a dataset resized to one resolution compiles
exactly once.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SiftParams", "detect_and_describe", "load_grayscale"]


@dataclasses.dataclass(frozen=True)
class SiftParams:
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.015
    edge_ratio: float = 10.0
    max_features_per_octave: int = 1024
    descriptor_patch: int = 16  # 16x16 gradient window -> 4x4x8 = 128-D
    # True (default): axis-aligned descriptors — cheaper, right for
    # level-horizon collections. False: dominant-orientation assignment
    # (36-bin gradient histogram) + rotated descriptor sampling — full
    # in-plane rotation invariance like the reference pipelines' OpenCV
    # SIFT (`pytests/sfm_pipeline.py` cv2.SIFT_create).
    upright: bool = True


def load_grayscale(path: str, max_dim: int | None = 1024) -> np.ndarray:
    """Load an image as float32 grayscale in [0, 1], optionally resized so
    max(H, W) == max_dim (keeps jit shapes uniform across a dataset)."""
    from PIL import Image

    img = Image.open(path).convert("L")
    if max_dim is not None and max(img.size) > max_dim:
        w, h = img.size
        s = max_dim / max(w, h)
        img = img.resize((int(round(w * s)), int(round(h * s))), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(np.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, kernel):
    """Separable Gaussian blur with SAME padding ([H, W] f32)."""
    k = jnp.asarray(kernel)
    r = (len(kernel) - 1) // 2
    x = img[None, None, :, :]
    x = jax.lax.conv_general_dilated(
        x, k[None, None, :, None], (1, 1), [(r, r), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    x = jax.lax.conv_general_dilated(
        x, k[None, None, None, :], (1, 1), [(0, 0), (r, r)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return x[0, 0]


def _octave_keypoints(dogs, params: SiftParams):
    """DoG extrema in one octave. dogs [L, H, W] -> (score [K], yx [K, 2],
    lvl [K], valid [K]) with K = max_features_per_octave."""
    L, H, W = dogs.shape
    thr = params.contrast_threshold
    r_edge = (params.edge_ratio + 1.0) ** 2 / params.edge_ratio

    center = dogs[1 : L - 1]  # [L-2, H, W]

    # 26-neighbor max/min via shifted comparisons (vectorized, no loops
    # over pixels; border pixels are masked off below).
    def shifts(a):
        outs = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                outs.append(jnp.roll(a, (dy, dx), axis=(-2, -1)))
        return outs

    neigh = []
    for dl in (-1, 0, 1):
        plane = dogs[1 + dl : L - 1 + dl]
        for s in shifts(plane):
            neigh.append(s)
    stack = jnp.stack(neigh)  # [27, L-2, H, W]
    is_max = jnp.all(center >= stack, axis=0)
    is_min = jnp.all(center <= stack, axis=0)
    # strict on at least one neighbor (excludes flat regions)
    strict = jnp.any(center != stack, axis=0)
    extremum = (is_max | is_min) & strict & (jnp.abs(center) > thr)

    # Edge gate: 2x2 spatial Hessian trace^2/det ratio (Lowe Sec. 4.1).
    dxx = (
        jnp.roll(center, -1, -1) + jnp.roll(center, 1, -1) - 2 * center
    )
    dyy = (
        jnp.roll(center, -1, -2) + jnp.roll(center, 1, -2) - 2 * center
    )
    dxy = 0.25 * (
        jnp.roll(center, (-1, -1), (-2, -1))
        + jnp.roll(center, (1, 1), (-2, -1))
        - jnp.roll(center, (-1, 1), (-2, -1))
        - jnp.roll(center, (1, -1), (-2, -1))
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / jnp.where(det <= 0, 1.0, det) < r_edge)

    # Mask borders (descriptor window + neighbor shifts must stay inside;
    # rotated sampling reads a sqrt(2)-larger window).
    b = params.descriptor_patch // 2 + (2 if params.upright else 6)
    ys = jnp.arange(H)
    xs = jnp.arange(W)
    inside = (
        (ys[:, None] >= b) & (ys[:, None] < H - b)
        & (xs[None, :] >= b) & (xs[None, :] < W - b)
    )
    good = extremum & edge_ok & inside[None]

    score = jnp.where(good, jnp.abs(center), -jnp.inf).reshape(-1)
    K = params.max_features_per_octave
    top, idx = jax.lax.top_k(score, K)
    lvl = idx // (H * W)
    rem = idx % (H * W)
    y = rem // W
    x = rem % W
    return top, jnp.stack([y, x], -1), lvl, jnp.isfinite(top)


def _descriptors(gauss, yx, lvl, params: SiftParams):
    """Upright SIFT descriptors for one octave's keypoints.

    gauss [L, H, W] Gaussian levels; yx [K, 2] integer coords; lvl [K]
    DoG level index (gradients taken from the matching Gaussian level).
    Returns [K, 128] L2-normalized descriptors.
    """
    P = params.descriptor_patch
    half = P // 2

    dx = 0.5 * (jnp.roll(gauss, -1, -1) - jnp.roll(gauss, 1, -1))
    dy = 0.5 * (jnp.roll(gauss, -1, -2) - jnp.roll(gauss, 1, -2))
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)  # [-pi, pi]

    # Precompute soft-assignment of the PxP grid into 4x4 spatial cells
    # (bilinear) and the Gaussian window, as one [P*P, 16] matrix.
    g = np.arange(P, dtype=np.float64) - (P - 1) / 2.0  # patch coords
    cell = (g + (P - 1) / 2.0) / (P / 4.0) - 0.5  # in [-0.5, 3.5]
    w_sp = np.zeros((P, 4))
    for c in range(4):
        w_sp[:, c] = np.clip(1.0 - np.abs(cell - c), 0.0, 1.0)
    sigma_w = 0.5 * P
    gw = np.exp(-0.5 * (g / sigma_w) ** 2)
    Wspat = (
        (gw[:, None, None, None] * gw[None, :, None, None])
        * w_sp[:, None, :, None]
        * w_sp[None, :, None, :]
    ).reshape(P * P, 16)
    Wspat = jnp.asarray(Wspat, jnp.float32)

    # Rotated-sampling support (upright=False): a sqrt(2)-sized window and
    # the descriptor grid offsets, rotated per keypoint at trace time.
    S = P + 8
    halfS = S // 2
    g_off = jnp.asarray(
        np.arange(P, dtype=np.float32) - (P - 1) / 2.0
    )
    uu, vv = jnp.meshgrid(g_off, g_off, indexing="ij")  # [P,P] (dy, dx)
    gS = np.arange(S, dtype=np.float64) - (S - 1) / 2.0
    ori_w = np.exp(-0.5 * (gS / (0.5 * P)) ** 2)
    OriW = jnp.asarray(
        (ori_w[:, None] * ori_w[None, :]).astype(np.float32)
    )

    def _finish(m, a):
        """m, a [P*P] -> 128-D descriptor (shared tail of both paths)."""
        binf = (a + jnp.pi) / (2 * jnp.pi) * 8.0 - 0.5
        b0 = jnp.floor(binf)
        frac = binf - b0
        b0i = jnp.mod(b0.astype(jnp.int32), 8)
        b1i = jnp.mod(b0i + 1, 8)
        w_ang = jnp.zeros((P * P, 8), m.dtype)
        rows = jnp.arange(P * P)
        w_ang = w_ang.at[rows, b0i].add(1.0 - frac)
        w_ang = w_ang.at[rows, b1i].add(frac)
        hist = jnp.einsum("pc,po,p->co", Wspat, w_ang, m)  # [16, 8]
        d = hist.reshape(-1)
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
        d = jnp.minimum(d, 0.2)
        return d / jnp.maximum(jnp.linalg.norm(d), 1e-12)

    def one_upright(yxi, li):
        lv = jnp.clip(li + 1, 0, gauss.shape[0] - 1)  # matching Gaussian
        y0 = yxi[0] - half
        x0 = yxi[1] - half
        m = jax.lax.dynamic_slice(mag[lv], (y0, x0), (P, P)).reshape(-1)
        a = jax.lax.dynamic_slice(ang[lv], (y0, x0), (P, P)).reshape(-1)
        return _finish(m, a)

    def one_oriented(yxi, li):
        lv = jnp.clip(li + 1, 0, gauss.shape[0] - 1)
        y0 = yxi[0] - halfS
        x0 = yxi[1] - halfS
        dxw = jax.lax.dynamic_slice(dx[lv], (y0, x0), (S, S))
        dyw = jax.lax.dynamic_slice(dy[lv], (y0, x0), (S, S))

        # Dominant orientation: 36-bin Gaussian-weighted histogram of the
        # window gradients, circularly smoothed (Lowe Sec. 5).
        mw = jnp.sqrt(dxw * dxw + dyw * dyw) * OriW
        aw = jnp.arctan2(dyw, dxw)
        bins = jnp.mod(
            jnp.floor((aw + jnp.pi) / (2 * jnp.pi) * 36.0).astype(jnp.int32),
            36,
        )
        hist = jnp.zeros((36,), dxw.dtype).at[bins.reshape(-1)].add(
            mw.reshape(-1)
        )
        for _ in range(2):
            hist = (
                hist * 6.0
                + (jnp.roll(hist, 1) + jnp.roll(hist, -1)) * 4.0
                + (jnp.roll(hist, 2) + jnp.roll(hist, -2))
            ) / 16.0
        theta = (jnp.argmax(hist).astype(dxw.dtype) + 0.5) / 36.0 * (
            2 * jnp.pi
        ) - jnp.pi
        cs, sn = jnp.cos(theta), jnp.sin(theta)

        # Sample the gradient field on the theta-rotated grid (bilinear)
        # and rotate the gradient vectors into the keypoint frame. The
        # grid rotation must be the SAME R(theta) (in x,y axes, theta
        # from atan2(dy, dx)) that gradients are later derotated by —
        # mixing conventions silently breaks rotation invariance.
        ys = sn * vv + cs * uu + (S - 1) / 2.0
        xs = cs * vv - sn * uu + (S - 1) / 2.0
        yf = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, S - 2)
        xf = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, S - 2)
        fy = jnp.clip(ys - yf, 0.0, 1.0)
        fx = jnp.clip(xs - xf, 0.0, 1.0)

        def samp(img2):
            v00 = img2[yf, xf]
            v01 = img2[yf, xf + 1]
            v10 = img2[yf + 1, xf]
            v11 = img2[yf + 1, xf + 1]
            return (
                v00 * (1 - fy) * (1 - fx)
                + v01 * (1 - fy) * fx
                + v10 * fy * (1 - fx)
                + v11 * fy * fx
            )

        dxs, dys = samp(dxw), samp(dyw)
        dxr = cs * dxs + sn * dys
        dyr = -sn * dxs + cs * dys
        m = jnp.sqrt(dxr * dxr + dyr * dyr).reshape(-1)
        a = jnp.arctan2(dyr, dxr).reshape(-1)
        return _finish(m, a)

    one = one_upright if params.upright else one_oriented
    return jax.vmap(one)(yx, lvl)


@partial(jax.jit, static_argnames=("params",))
def _extract_octave(img, params: SiftParams):
    """One octave: pyramid levels, extrema, descriptors (jitted per shape)."""
    s = params.scales_per_octave
    k = 2.0 ** (1.0 / s)
    levels = [img]
    sig_prev = params.sigma0
    for i in range(1, s + 3):
        sig_total = params.sigma0 * (k**i)
        sig_inc = float(np.sqrt(max(sig_total**2 - sig_prev**2, 1e-6)))
        levels.append(_blur(levels[-1], _gaussian_kernel1d(sig_inc)))
        sig_prev = sig_total
    gauss = jnp.stack(levels)  # [s+3, H, W]
    dogs = gauss[1:] - gauss[:-1]  # [s+2, H, W]
    score, yx, lvl, valid = _octave_keypoints(dogs, params)
    desc = _descriptors(gauss, yx, lvl, params)
    next_img = levels[s][::2, ::2]  # 2x-downsampled seed for next octave
    return score, yx, lvl, valid, desc, next_img


def detect_and_describe(image: np.ndarray, params: SiftParams | None = None):
    """Full pyramid over `num_octaves`. Returns
    (keypoints [N, 2] (x, y) original-image pixels, scales [N],
     descriptors [N, 128], responses [N]) as numpy, valid rows only,
    sorted by response."""
    params = params or SiftParams()
    base_sigma = float(np.sqrt(max(params.sigma0**2 - 0.5**2, 1e-6)))
    img = jnp.asarray(image, jnp.float32)
    img = _blur(img, _gaussian_kernel1d(base_sigma))

    k = 2.0 ** (1.0 / params.scales_per_octave)
    kps, scales, descs, resps = [], [], [], []
    for o in range(params.num_octaves):
        if min(img.shape) < 4 * params.descriptor_patch:
            break
        score, yx, lvl, valid, desc, img = _extract_octave(img, params)
        score = np.asarray(score)
        yx = np.asarray(yx)
        lvl = np.asarray(lvl)
        valid = np.asarray(valid)
        desc = np.asarray(desc)
        sel = valid
        xy = np.stack([yx[sel, 1], yx[sel, 0]], -1).astype(np.float64)
        kps.append((xy + 0.5) * (2.0**o) - 0.5)
        scales.append(params.sigma0 * (k ** (lvl[sel] + 1)) * (2.0**o))
        descs.append(desc[sel])
        resps.append(score[sel])
    if not kps:
        return (
            np.zeros((0, 2)),
            np.zeros((0,)),
            np.zeros((0, 128), np.float32),
            np.zeros((0,)),
        )
    kp = np.concatenate(kps)
    sc = np.concatenate(scales)
    de = np.concatenate(descs)
    rs = np.concatenate(resps)
    order = np.argsort(-rs, kind="stable")
    return kp[order], sc[order], de[order], rs[order]
