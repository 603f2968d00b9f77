"""Low-level pinhole-camera math (bottom layer — no pbr3d imports).

See pbr3d.camera.geometry for the user-facing API and the reference-parity
notes (reference: utils/camera_geometry.py:3-27).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def look_at_rotation_np(eye, target) -> np.ndarray:
    """Numpy mirror of :func:`look_at_rotation` for HOST callers.

    Identical branch semantics (same degenerate-up fallback).  Host paths
    (e.g. camera reparameterization in the stage-2 retry starts) must not
    call the jnp version eagerly: every one of its ~10 tiny ops would
    compile as a separate one-off executable per process, which is pure
    cold-start cost."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up_default = np.array([0.0, 1.0, 0.0])
    up_fallback = np.array([0.0, 0.0, 1.0])
    z = target - eye
    z = z / np.linalg.norm(z)
    up = up_fallback if np.isclose(abs(float(np.dot(z, up_default))), 1.0) \
        else up_default
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def look_at_rotation(eye: jax.Array, target: jax.Array) -> jax.Array:
    """World->camera rotation (rows are camera x/y/z axes in world coords)."""
    up_default = jnp.array([0.0, 1.0, 0.0])
    up_fallback = jnp.array([0.0, 0.0, 1.0])
    z = target - eye
    z = z / jnp.linalg.norm(z)
    degenerate = jnp.isclose(jnp.abs(jnp.dot(z, up_default)), 1.0)
    up = jnp.where(degenerate, up_fallback, up_default)
    x = jnp.cross(up, z)
    x = x / jnp.linalg.norm(x)
    y = jnp.cross(z, x)
    return jnp.stack([x, y, z], axis=0)


def camera_rays(pts: jax.Array, cam_pos: jax.Array, target: jax.Array) -> jax.Array:
    """(N, 3) world points -> camera-frame coordinates.

    Precision.HIGHEST is load-bearing: a default-precision f32 matmul may
    run with reduced-precision inputs (TF32 on the GPU, ~3 decimal digits),
    which at 512-scale coordinates puts pixels of error on u/v and voxels
    on camera Z — fatal for z-buffer visibility tests whose epsilon is 1e-3
    (eval_helpers_intra.py:168)."""
    R = look_at_rotation(cam_pos, target)
    return jnp.matmul(pts - cam_pos, R.T, precision=jax.lax.Precision.HIGHEST)


def project_points_soa(
    xs: jax.Array,
    ys: jax.Array,
    zs: jax.Array,
    cam_pos: jax.Array,
    target: jax.Array,
    f: jax.Array,
    cx: jax.Array,
    cy: jax.Array,
    z_clamp: float = 1e-8,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Structure-of-arrays projection: three (N,) coordinate vectors in,
    (u, v, Z_cam) out.

    Nine f32 FMAs over packed (N,) vectors instead of an (N, 3) x (3, 3)
    product whose minor axis of 3 wastes most of every vector op and needs
    a relayout per column slice.  Elementwise f32 arithmetic is exact f32,
    so this is at least as precise as the Precision.HIGHEST matmul in
    :func:`camera_rays`."""
    R = look_at_rotation(cam_pos, target)
    dx = xs - cam_pos[0]
    dy = ys - cam_pos[1]
    dz = zs - cam_pos[2]
    X = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * dz
    Y = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * dz
    Z = R[2, 0] * dx + R[2, 1] * dy + R[2, 2] * dz
    Zc = jnp.where(Z < z_clamp, z_clamp, Z)
    u = (X / Zc) * f + cx
    v = -(Y / Zc) * f + cy
    return u, v, Z


def project_points(
    pts: jax.Array,
    cam_pos: jax.Array,
    target: jax.Array,
    f: jax.Array,
    cx: jax.Array,
    cy: jax.Array,
    z_clamp: float = 1e-8,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Project (N, 3) points; returns (u, v, Z_cam).  Z clamped to z_clamp
    exactly like the reference's vectorized splat path
    (utils/projection_utils.py:9-14).

    Internally SoA (see :func:`project_points_soa`): the column split costs
    one relayout per call (hoisted out of candidate vmaps because it is
    camera-independent), after which all per-point math runs on fully
    packed (N,) vectors."""
    pts = pts.astype(jnp.float32)
    return project_points_soa(
        pts[:, 0], pts[:, 1], pts[:, 2], cam_pos, target, f, cx, cy, z_clamp
    )
