"""Differentiable pinhole camera (look-at parameterization).

The reference camera model is 9 DoF — cam_pos(3), target(3), f, cx, cy; the
up-vector is fixed (0,1,0) with a (0,0,1) fallback when the view direction is
(anti)parallel to it; projection is ``u = (X/Z)·f + cx``, ``v = -(Y/Z)·f + cy``
with Z clamped to >= 1e-8 (reference: utils/camera_geometry.py:3-27).

Everything here is pure jnp — batched over points, jit/vmap/grad friendly, so
the same functions serve the splat projector, the keypoint least-squares fit,
and the vmapped mask-IoU camera search.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

# Implementation lives in the ops layer (pbr3d.ops.cameramath) so the
# projection primitives can use it without a layering cycle.
from pbr3d.ops.cameramath import (
    camera_rays,
    look_at_rotation,
    look_at_rotation_np,
    project_points,
)

__all__ = [
    "look_at_rotation",
    "camera_rays",
    "project_points",
    "project_point",
    "params_to_vector",
    "vector_to_params",
    "reparam_principal_point",
    "yaw_camera_about_center",
    "dolly_zoom",
]


def yaw_camera_about_center(cam: Dict, grid_shape, deg: float) -> Dict:
    """Rotate the camera rig (position AND target) about the voxel grid
    center's vertical (y) axis.

    The monuments are 4-fold symmetric, so the minaret keypoint
    correspondence — and with it the kp camera's azimuth — is only
    determined up to a 90° rotation for oblique (drone) views; the human
    aligner resolved the true azimuth visually.  Yawed copies of the kp
    camera give the automated search one start per symmetry branch.
    """
    center = np.asarray(grid_shape[:3], np.float64)[[2, 1, 0]] / 2.0  # (x,y,z)
    a = np.deg2rad(deg)
    R = np.array(
        [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
         [-np.sin(a), 0.0, np.cos(a)]]
    )
    out = dict(cam)
    out["cam_pos"] = center + R @ (np.asarray(cam["cam_pos"], np.float64) - center)
    out["target"] = center + R @ (np.asarray(cam["target"], np.float64) - center)
    return out


def dolly_zoom(cam: Dict, s: float) -> Dict:
    """Push the camera back s× along the optical axis while zooming f by s —
    image size preserved at the target depth (the multi-FOV init family)."""
    c = np.asarray(cam["cam_pos"], np.float64)
    t = np.asarray(cam["target"], np.float64)
    out = dict(cam)
    out["cam_pos"] = t + (c - t) * s
    out["f"] = float(cam["f"]) * s
    return out


def reparam_principal_point(
    cam: Dict, cx_new: float = 0.0, cy_new: float = 0.0
) -> Dict:
    """Equivalent-projection reparameterization of the principal point.

    Moving the principal point by Δc shifts every projection by Δc;
    tilting the optical axis ẑ toward x̂ by a radians shifts projections by
    ≈ −a·f (and toward ŷ by b shifts v by ≈ +b·f under the v = −Yf/Z + cy
    convention).  So (cx, cy) → (cx', cy') composed with retargeting along

        ẑ' ∝ ẑ + ((cx'−cx)/f)·x̂ + ((cy−cy')/f)·ŷ

    preserves the projection to first order — the (target, cx, cy) ridge a
    per-DoF search cannot walk (each single-DoF probe along it scores
    worse).  The reference's golden Charminar drone camera sits at the FAR
    end of this ridge (cx = cy = 0, exactly the kp-fit's lower bound,
    results/2.*/Charminar_camera_params_final.json); searches seeded from
    this reparameterized start can reach that basin.
    """
    c = np.asarray(cam["cam_pos"], np.float64)
    t = np.asarray(cam["target"], np.float64)
    f = float(cam["f"])
    cx, cy = float(cam["cx"]), float(cam["cy"])
    R = look_at_rotation_np(c, t)
    xhat, yhat, zhat = R[0], R[1], R[2]
    a = (cx_new - cx) / f
    b = (cy - cy_new) / f
    z2 = zhat + a * xhat + b * yhat
    z2 = z2 / np.linalg.norm(z2)
    dist = float(np.linalg.norm(t - c))
    out = dict(cam)
    out["target"] = c + dist * z2
    out["cx"] = float(cx_new)
    out["cy"] = float(cy_new)
    return out


def project_point(pt: jax.Array, cam: Dict) -> jax.Array:
    """Single-point convenience matching the reference ``project`` signature
    (utils/camera_geometry.py:17-27)."""
    u, v, _ = project_points(
        jnp.asarray(pt)[None], cam["cam_pos"], cam["target"],
        cam["f"], cam["cx"], cam["cy"],
    )
    return jnp.stack([u[0], v[0]])


def params_to_vector(cam: Dict) -> np.ndarray:
    """Camera dict -> 9-vector (float32, HOST array).

    Kept in numpy: every caller either hands it to a jit program (device_put
    is free of compiles) or re-wraps it with ``jnp.asarray``; building it
    eagerly in jnp would compile 3 one-off programs per process."""
    return np.concatenate(
        [
            np.asarray(cam["cam_pos"], np.float32).ravel(),
            np.asarray(cam["target"], np.float32).ravel(),
            np.asarray([cam["f"], cam["cx"], cam["cy"]], np.float32),
        ]
    )


def vector_to_params(x, H: int | None = None, W: int | None = None) -> Dict:
    # Host util: device inputs are fetched once (a transfer, not a compile);
    # slicing a device 9-vector eagerly compiled dynamic_slice programs.
    x = np.asarray(x)
    out = {
        "cam_pos": x[0:3],
        "target": x[3:6],
        "f": x[6],
        "cx": x[7],
        "cy": x[8],
    }
    if H is not None:
        out["H"] = H
        out["W"] = W
    return out
