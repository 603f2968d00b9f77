"""Camera initialization & keypoint fitting.

* ``auto_compute_initial_params_matching_bbox`` replicates the reference's
  bbox-alignment heuristic (camera on -Z at 2x the voxel bbox diagonal, focal
  length from a 30° vertical FOV rescaled by the image/projection bbox-width
  ratio; reference: utils/camera_estimation.py:56-108).

* ``optimize_camera_with_keypoints`` replaces the reference's host scipy
  L-BFGS-B (reference: utils/camera_estimation.py:110-170) with a fully
  jit-compiled bounded Levenberg-Marquardt solve over the 9 camera DoF —
  residual Jacobians by ``jax.jacfwd`` (the problem is ~16 residuals x 9
  params, so the normal equations are tiny), box bounds enforced by
  projection, damping adapted per step inside ``lax.while_loop``.  Same
  objective, same bounds, typically a lower final loss than the reference.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.camera.geometry import project_points
from pbr3d.carving.voxel import points_by_parts


def auto_compute_initial_params_matching_bbox(
    grid_labels: np.ndarray,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    fov_deg: float = 30.0,
) -> Dict:
    H_img, W_img = mask_labels.shape[:2]
    voxel_pts, _ = points_by_parts(grid_labels, parts_for_alignment)

    bbox_min = voxel_pts.min(axis=0)
    bbox_max = voxel_pts.max(axis=0)
    center = (bbox_min + bbox_max) / 2
    size = float(np.linalg.norm(bbox_max - bbox_min))

    ids = config.part_ids(parts_for_alignment)
    ys, xs = np.where(np.isin(mask_labels, ids))
    img_min = np.array([xs.min(), ys.min()], np.float64)
    img_max = np.array([xs.max(), ys.max()], np.float64)
    img_width = float(np.linalg.norm(img_max - img_min))

    cam_pos = center + np.array([0.0, 0.0, -size * 2.0])
    f = H_img / (2.0 * np.tan(np.deg2rad(fov_deg) / 2.0))
    approx_proj_width = (size * f) / (size * 2.0)
    f_adjusted = f * (img_width / approx_proj_width)

    return {
        "cam_pos": cam_pos.astype(np.float64),
        "target": center.astype(np.float64),
        "f": float(f_adjusted),
        "cx": W_img / 2.0,
        "cy": H_img / 2.0,
    }


def default_bounds(H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's hand-tuned L-BFGS-B box bounds
    (utils/camera_estimation.py:144-152)."""
    lo = np.array([-W, -H, -2000, -W, -H, -2000, 10, 0, 0], np.float32)
    hi = np.array([2 * W, 2 * H, 100, 2 * W, 2 * H, 100, 2000, W, H], np.float32)
    return lo, hi


MAX_KEYPOINTS = 16  # padded anchor count: one compiled fit for all scenes


@functools.partial(jax.jit, static_argnames=("loss_type", "max_iters"))
def _lm_fit(
    x0: jax.Array,
    vox_kps: jax.Array,  # (MAX_KEYPOINTS, 3), zero-padded
    img_kps: jax.Array,  # (MAX_KEYPOINTS, 2), zero-padded
    kp_mask: jax.Array,  # (MAX_KEYPOINTS,) 1/0 — padded residuals are zeroed
    lo: jax.Array,
    hi: jax.Array,
    loss_type: str = "L2",
    max_iters: int = 200,
):
    def residuals(x):
        u, v, _ = project_points(vox_kps, x[0:3], x[3:6], x[6], x[7], x[8])
        r = (jnp.stack([u, v], axis=1) - img_kps) * kp_mask[:, None]
        if loss_type == "L1":
            # Smooth |r| so the Jacobian exists everywhere.
            r = jnp.sqrt(r * r + 1e-12) * kp_mask[:, None]
        return r.reshape(-1)

    def loss(x):
        r = residuals(x)
        return jnp.sum(r * r) if loss_type == "L2" else jnp.sum(jnp.abs(r))

    # Levenberg-Marquardt on the (always-)squared residual objective; for L1
    # the residuals are the smoothed |.| terms, so LM minimizes Σ|r| via IRLS.
    def lm_res(x):
        r = residuals(x)
        return r if loss_type == "L2" else jnp.sqrt(jnp.abs(r) + 1e-12)

    def step(state):
        x, lam, it, _ = state
        r = lm_res(x)
        J = jax.jacfwd(lm_res)(x)  # (R, 9)
        # HIGHEST: a reduced-precision f32 matmul (TF32 on the GPU) would
        # distort the normal equations
        hi_p = jax.lax.Precision.HIGHEST
        JtJ = jnp.matmul(J.T, J, precision=hi_p)
        g = jnp.matmul(J.T, r, precision=hi_p)
        delta = jnp.linalg.solve(JtJ + lam * jnp.eye(9), -g)
        x_new = jnp.clip(x + delta, lo, hi)
        better = loss(x_new) < loss(x)
        x = jnp.where(better, x_new, x)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-8, 1e12)
        return x, lam, it + 1, jnp.linalg.norm(delta)

    def cond(state):
        _, _, it, dn = state
        return jnp.logical_and(it < max_iters, dn > 1e-10)

    x, _, _, _ = jax.lax.while_loop(
        cond, step, (x0, jnp.float32(1e-3), 0, jnp.float32(1.0))
    )
    return x, loss(x)


def optimize_camera_with_keypoints(
    voxel_keypoints: Dict[str, np.ndarray],
    image_keypoints: Dict[str, Tuple[float, float]],
    image_hw: Tuple[int, int],
    init_params: Dict,
    loss_type: str = "L2",
) -> Dict:
    """Fit the 9-DoF camera to the keypoint correspondences.

    Same objective/bounds as the reference; returns the fitted params dict.
    """
    H, W = image_hw
    keys = list(image_keypoints.keys())
    K = len(keys)
    if K > MAX_KEYPOINTS:
        raise ValueError(f"{K} keypoints exceed MAX_KEYPOINTS={MAX_KEYPOINTS}")
    vox_np = np.zeros((MAX_KEYPOINTS, 3), np.float32)
    img_np = np.zeros((MAX_KEYPOINTS, 2), np.float32)
    mask_np = np.zeros((MAX_KEYPOINTS,), np.float32)
    vox_np[:K] = np.stack([voxel_keypoints[k] for k in keys])
    img_np[:K] = np.stack([image_keypoints[k] for k in keys])
    mask_np[:K] = 1.0
    vox, img, kp_mask = map(jnp.asarray, (vox_np, img_np, mask_np))
    # x0 prep stays on HOST (np.clip + f32 cast): the eager jnp versions
    # compiled two one-off remote programs per process for a 9-vector.
    x0 = np.concatenate(
        [
            np.asarray(init_params["cam_pos"], np.float64),
            np.asarray(init_params["target"], np.float64),
            [init_params["f"], init_params["cx"], init_params["cy"]],
        ]
    )
    lo, hi = default_bounds(H, W)
    x0_clipped = np.clip(
        x0.astype(np.float32),
        np.asarray(lo, np.float32), np.asarray(hi, np.float32),
    )
    x, fun = _lm_fit(
        jnp.asarray(x0_clipped), vox, img, kp_mask,
        jnp.asarray(lo), jnp.asarray(hi), loss_type=loss_type,
    )
    x = np.asarray(x, np.float64)
    return {
        "cam_pos": x[0:3],
        "target": x[3:6],
        "f": float(x[6]),
        "cx": float(x[7]),
        "cy": float(x[8]),
        "loss": float(fun),
    }
