"""Y-axis voxel-grid rotation resampler — the stage-1 hot kernel.

The reference implements its rotate-and-carve sweep with
``scipy.ndimage.affine_transform(grid, Rinv, offset=c - Rinv @ c, order=1,
mode="constant", cval=0)`` on uint8 grids
(reference: utils/voxel_carving_utils.py:104-126,65-69).  Exact semantics we
reproduce:

* center-pinned inverse mapping: output voxel ``o`` samples the input at
  ``Rinv @ (o - c) + c`` with ``c = shape / 2``;
* trilinear (order=1) interpolation, zero fill outside the grid;
* the uint8 output is the *rounded* interpolant, half away from zero
  (verified empirically against scipy 1.17) — for {0,1} grids that is a
  ``>= 0.5`` threshold.

Design: a rotation about Y only mixes the (x, z) axes, so the 3D
resample is a 2D bilinear warp of the (x, z) planes batched over y.  We
precompute the 4 corner gather indices + weights **once per (shape, angle)**
at trace time (host numpy, float64 — matching scipy's double-precision
coordinate math), embed them as constants, and execute 4 large axis-1 gathers
with fused multiply-adds — no scatter, no dynamic shapes, fully jit/vmap/pjit
compatible.  Exact multiples of 90° reduce to a single permutation gather.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def rotation_matrix_inv(angle_deg: float) -> np.ndarray:
    """Inverse of the Y-axis rotation (reference: voxel_carving_utils.py:65-69)."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return np.linalg.inv(R)


@functools.lru_cache(maxsize=256)
def _coord_plan(W: int, D: int, angle_deg: float):
    """Shared float64 source-coordinate computation for one (shape, angle).

    Returns ``(x0, z0, fx, fz, inside)`` flat arrays over the (W*D) output
    (x, z) lattice.

    Matches scipy's float64 evaluation order bit-for-bit: the y row/col of
    Rinv is exactly [0, 1, 0] so y drops out, and scipy's C kernel
    accumulates ``offset + Σ_j m[i,j]·o[j]`` offset-FIRST (verified against
    scipy 1.17).  ``inside`` implements scipy's mode="constant" (NOT
    "grid-constant"): a sample outside [0, size-1] on any axis is cval (0)
    outright, classified on the unsnapped coordinates.  Coordinates within
    1e-9 of an integer are then snapped for the corner/weight computation,
    collapsing multiples of 90° to exact permutations.
    """
    c = np.array([W, 0.0, D], np.float64) / 2.0  # y center cancels in x/z rows
    Rinv = rotation_matrix_inv(angle_deg)
    offset = c - Rinv @ c
    ox, oz = np.meshgrid(
        np.arange(W, dtype=np.float64), np.arange(D, dtype=np.float64), indexing="ij"
    )
    src_x = (offset[0] + Rinv[0, 0] * ox + Rinv[0, 2] * oz).ravel()
    src_z = (offset[2] + Rinv[2, 0] * ox + Rinv[2, 2] * oz).ravel()

    inside = (src_x >= 0) & (src_x <= W - 1) & (src_z >= 0) & (src_z <= D - 1)

    def _snap(v):
        r = np.round(v)
        return np.where(np.abs(v - r) < 1e-9, r, v)

    src_x = _snap(src_x)
    src_z = _snap(src_z)
    x0 = np.floor(src_x)
    z0 = np.floor(src_z)
    return x0, z0, src_x - x0, src_z - z0, inside


@functools.lru_cache(maxsize=256)
def _gather_plan(
    W: int, D: int, angle_deg: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Corner gather indices & weights for a (W, ·, D) grid rotated by angle.

    Returns ``idx (k, W*D) int32`` flat indices into the (W*D)-flattened (x,z)
    plane and ``w (k, W*D) float32`` weights (zero where the sample falls
    outside the grid -> constant-0 fill).  k is 1 for exact-permutation
    angles, else 4.
    """
    x0, z0, fx, fz, inside = _coord_plan(W, D, float(angle_deg))

    if np.all(fx[inside] < 1e-12) and np.all(fz[inside] < 1e-12):
        # Exact permutation (0/90/180/270 with matching dims).
        xi = x0.astype(np.int64)
        zi = z0.astype(np.int64)
        idx = np.where(inside, np.clip(xi, 0, W - 1) * D + np.clip(zi, 0, D - 1), 0)
        return idx.astype(np.int32)[None], inside.astype(np.float32)[None]

    idxs, ws = [], []
    for ddx, wx in ((0.0, 1.0 - fx), (1.0, fx)):
        for ddz, wz in ((0.0, 1.0 - fz), (1.0, fz)):
            xi = np.clip((x0 + ddx).astype(np.int64), 0, W - 1)
            zi = np.clip((z0 + ddz).astype(np.int64), 0, D - 1)
            idxs.append((xi * D + zi).astype(np.int32))
            ws.append(np.where(inside, wx * wz, 0.0).astype(np.float32))
    return np.stack(idxs), np.stack(ws)


def rotate_y(grid: jax.Array, angle_deg: float) -> jax.Array:
    """Rotate a (W, H, D) float grid about +Y by ``angle_deg`` (trilinear).

    Returns the raw interpolant (no rounding); zeros outside the grid.
    ``angle_deg`` must be a static Python number.
    """
    W, H, D = grid.shape
    if float(angle_deg) % 360.0 == 0.0:
        return grid
    idx, w = _gather_plan(W, D, float(angle_deg))
    # (W,H,D) -> (H, W*D): y becomes the batch axis, gathers hit axis 1.
    g2 = jnp.transpose(grid, (1, 0, 2)).reshape(H, W * D)
    out = jnp.zeros_like(g2)
    for k in range(idx.shape[0]):
        out = out + jnp.asarray(w[k]) * jnp.take(g2, jnp.asarray(idx[k]), axis=1)
    return jnp.transpose(out.reshape(H, W, D), (1, 0, 2))


@functools.lru_cache(maxsize=256)
def _binary_plan(W: int, D: int, angle_deg: float):
    """Decision-LUT plan for bit-exact binary rotation.

    For a {0,1} grid, the rounded interpolant at an output pixel depends only
    on *which* of its 4 corners are occupied — 16 cases.  We evaluate all 16
    subset sums in float64 on the host (same accumulation order as scipy's
    spline kernel) and pack the ``>= 0.5`` decisions into a per-pixel 16-bit
    mask.  The device kernel then needs only integer gathers and bit ops —
    bit-exact against scipy regardless of on-device float precision.

    Returns ``(idx (4, W*D) int32, dec (W*D) int32)`` or None for
    exact-permutation angles (handled by the generic plan).
    """
    idx, w = _gather_plan(W, D, float(angle_deg))
    if idx.shape[0] == 1:
        return None
    # Float64 corner weights from the SAME (snapped) coordinates the gather
    # indices were built from — the f32 cast in _gather_plan loses the bits
    # that decide exact-0.5 ties.
    _, _, fx, fz, inside = _coord_plan(W, D, float(angle_deg))
    corner_w = [
        (1.0 - fx) * (1.0 - fz),
        (1.0 - fx) * fz,
        fx * (1.0 - fz),
        fx * fz,
    ]
    dec = np.zeros(W * D, np.int32)
    for code in range(16):
        s = np.zeros(W * D, np.float64)
        for k in range(4):
            if (code >> k) & 1:
                s = s + corner_w[k]
        dec |= ((s >= 0.5) & inside).astype(np.int32) << code
    return idx, dec


@functools.lru_cache(maxsize=512)
def lut_plan(W: int, D: int, angle_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform LUT form of the binary rotation for ANY angle.

    Returns ``(idx (4, W*D) int32, dec (W*D) int32)`` usable by the scan-based
    carve sweep: gather the 4 corner occupancies, form a 4-bit code, and read
    the per-pixel decision bit.  Exact-permutation angles are encoded with all
    four corners equal to the source cell and decision mask 0xAAAA (out =
    corner-0 bit) gated by the inside mask — so every angle shares one device
    program shape.
    """
    plan = _binary_plan(W, D, float(angle_deg))
    if plan is not None:
        return plan
    idx1, w1 = _gather_plan(W, D, float(angle_deg))  # permutation form
    idx = np.broadcast_to(idx1[0], (4, idx1.shape[1])).copy()
    dec = np.where(w1[0] > 0, np.int32(0xAAAA), np.int32(0)).astype(np.int32)
    return idx, dec


@functools.lru_cache(maxsize=512)
def lut_plan_embedded(
    W: int, D: int, Wp: int, Dp: int, angle_deg: float
) -> Tuple[np.ndarray, np.ndarray]:
    """LUT plan for a (W, ·, D) grid EMBEDDED at the origin of a padded
    (Wp, ·, Dp) grid.

    The corner indices and float64 decisions are computed in the ORIGINAL
    frame (identical bits to :func:`lut_plan`), then re-addressed into the
    padded flat layout; padded output pixels get decision 0 (always empty).
    A sweep on the padded grid therefore produces BIT-IDENTICAL content in
    the original region while sharing one compiled executable across every
    crop that fits the bucket — every distinct program shape would
    otherwise be a fresh compile.
    """
    idx, dec = lut_plan(W, D, float(angle_deg))
    k = idx.shape[0]
    # original flat (xi*D + zi) -> padded flat (xi*Dp + zi)
    xi = idx // D
    zi = idx % D
    idx_p = xi * Dp + zi
    out_idx = np.zeros((k, Wp * Dp), np.int32)
    out_dec = np.zeros((Wp * Dp,), np.int32)
    # positions of original output pixels inside the padded flat layout
    ox, oz = np.meshgrid(np.arange(W), np.arange(D), indexing="ij")
    pos = (ox * Dp + oz).ravel()
    out_idx[:, pos] = idx_p
    out_dec[pos] = dec
    return out_idx, out_dec


def rotate_y_binary_u8(grid: jax.Array, angle_deg: float) -> jax.Array:
    """Rotate a {0,1} grid, bit-exactly reproducing scipy's uint8 path.

    Equivalent to ``affine_transform(uint8_grid, ...)`` for binary grids:
    trilinear-interpolate in float64, round half away from zero.  Implemented
    with the per-pixel decision LUT of :func:`_binary_plan` — integer gathers
    only.  Output is float32 {0., 1.} (kept float for the multiply-carve
    chain).
    """
    if float(angle_deg) % 360.0 == 0.0:
        return grid
    W, H, D = grid.shape
    plan = _binary_plan(W, D, float(angle_deg))
    if plan is None:  # exact permutation — single masked gather
        return (rotate_y(grid, angle_deg) >= 0.5).astype(grid.dtype)
    idx, dec = plan
    g2 = (jnp.transpose(grid, (1, 0, 2)).reshape(H, W * D) > 0).astype(jnp.int32)
    code = jnp.zeros_like(g2)
    for k in range(4):
        code = code | (jnp.take(g2, jnp.asarray(idx[k]), axis=1) << k)
    out = (jnp.right_shift(jnp.asarray(dec)[None, :], code) & 1).astype(grid.dtype)
    return jnp.transpose(out.reshape(H, W, D), (1, 0, 2))
