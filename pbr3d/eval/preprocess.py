"""Inter-method data preparation (notebook 5): SfM cloud alignment, symmetric
completion, ICP — the JAX re-design of the reference's Open3D pipeline
(recovered from utils/__pycache__/preprocess_helpers.cpython-38.pyc, method
documented in results/4.Inter-method_3D/README.md:28-46).

Steps (reference bytecode L32-L120):
1. load sparse + dense COLMAP PLYs; crop dense to the sparse bbox;
2. RANSAC facade-plane fit on the sparse cloud (dist 0.01, 3 points,
   1000 iters) + Rodrigues rotation aligning the plane normal to +Z;
3. naive 4-way symmetric completion: back = z-mirror about z-mid; left/right
   = ±90° y-spins about the cloud center with an x-mirror;
4. ordered point-to-point ICP refinement (Left->Front, Right->Front,
   Back->Left; max correspondence distance 0.05);
5. load the carved voxel grid; load the CAD OBJ, swap axes
   [[1,0,0],[0,0,1],[0,1,0]], sample 50k surface points, flip y, align
   ground planes (min-y).

Device replacements: RANSAC scores all candidate planes in ONE vmapped
device program (Open3D iterates); ICP correspondences use the tiled matmul
NN kernel; the rigid estimate is a Kabsch SVD.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d.io.pointcloud import load_obj, load_ply, sample_mesh_surface
from pbr3d.io.artifacts import load_voxel_grid_labels
from pbr3d.ops.neighbors import knn


def flip_y_axis(points: np.ndarray) -> np.ndarray:
    """Negate y (recovered reference L12-17)."""
    p = np.asarray(points, np.float64).copy()
    p[:, 1] = -p[:, 1]
    return p


def rodrigues_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix about ``axis`` by ``angle`` (rad)."""
    a = np.asarray(axis, np.float64)
    a = a / (np.linalg.norm(a) + 1e-12)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


@functools.partial(jax.jit, static_argnames=("n_candidates",))
def _ransac_plane_scores(pts: jax.Array, key, dist_thresh: float, n_candidates: int):
    n = pts.shape[0]
    idx = jax.random.randint(key, (n_candidates, 3), 0, n)
    tri = pts[idx]  # (C, 3, 3)
    normals = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norms = jnp.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / jnp.maximum(norms, 1e-12)
    d = -jnp.sum(normals * tri[:, 0], axis=1)
    # HIGHEST: a reduced-precision f32 matmul (TF32 on the GPU) puts
    # errors of the order of the 0.01 inlier threshold on point-plane
    # distances
    dist = jnp.abs(
        jnp.matmul(pts, normals.T, precision=jax.lax.Precision.HIGHEST)
        + d[None, :]
    )  # (N, C)
    inliers = jnp.sum(dist < dist_thresh, axis=0)
    # Degenerate minimal sets ((near-)collinear samples -> ~zero normal)
    # would count everything as an inlier; disqualify them.
    inliers = jnp.where(norms[:, 0] > 1e-9, inliers, -1)
    return normals, d, inliers


def segment_plane(
    points: np.ndarray,
    distance_threshold: float = 0.01,
    num_iterations: int = 1000,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RANSAC plane fit; returns ((a,b,c,d), inlier index array).

    Open3D's ``segment_plane`` contract (3-point minimal sets, inlier count
    scoring), with all candidates scored in one vmapped device program.
    """
    pts = jnp.asarray(np.asarray(points, np.float32))
    normals, d, inliers = _ransac_plane_scores(
        pts, jax.random.PRNGKey(seed), distance_threshold, num_iterations
    )
    best = int(np.argmax(np.asarray(inliers)))
    n = np.asarray(normals)[best].astype(np.float64)
    dd = float(np.asarray(d)[best])
    dist = np.abs(np.asarray(points, np.float64) @ n + dd)
    idx = np.where(dist < distance_threshold)[0]
    return np.array([n[0], n[1], n[2], dd]), idx


def align_plane_to_z(points: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """Rotate so the plane normal maps to +Z (Rodrigues, reference L52-60)."""
    n = plane[:3] / np.linalg.norm(plane[:3])
    if n[2] < 0:
        n = -n
    target = np.array([0.0, 0.0, 1.0])
    axis = np.cross(n, target)
    s = np.linalg.norm(axis)
    if s < 1e-12:
        return np.asarray(points, np.float64).copy()
    angle = float(np.arctan2(s, np.dot(n, target)))
    R = rodrigues_rotation(axis / s, angle)
    return np.asarray(points, np.float64) @ R.T


def icp_point_to_point(
    source: np.ndarray,
    target: np.ndarray,
    max_correspondence_distance: float = 0.05,
    max_iterations: int = 30,
    tol: float = 1e-7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid point-to-point ICP (Open3D ``registration_icp`` equivalent).

    Returns (aligned source points, 4x4 transform).
    """
    src = np.asarray(source, np.float64).copy()
    tgt = np.asarray(target, np.float64)
    T = np.eye(4)
    prev_err = np.inf
    for _ in range(max_iterations):
        d, idx = knn(src.astype(np.float32), tgt.astype(np.float32), k=1)
        d = d[:, 0]
        idx = idx[:, 0]
        keep = d < max_correspondence_distance
        if keep.sum() < 3:
            break
        P = src[keep]
        Q = tgt[idx[keep]]
        cp, cq = P.mean(0), Q.mean(0)
        H = (P - cp).T @ (Q - cq)
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        t = cq - R @ cp
        src = src @ R.T + t
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        T = Ti @ T
        err = float(np.mean(d[keep] ** 2))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return src, T


def symmetric_completion(front: np.ndarray) -> Dict[str, np.ndarray]:
    """Naive 4-way symmetric completion (reference L67-96):
    back = z-mirror about z-mid; left/right = ±90° y-spins about the cloud
    center composed with an x-mirror."""
    front = np.asarray(front, np.float64)
    center = front.mean(0)
    z_mid = (front[:, 2].min() + front[:, 2].max()) / 2.0

    back = front.copy()
    back[:, 2] = 2 * z_mid - back[:, 2]

    def spin(sign):
        R = rodrigues_rotation(np.array([0.0, 1.0, 0.0]), sign * np.pi / 2)
        p = (front - center) @ R.T
        p[:, 0] = -p[:, 0]  # x-mirror
        return p + center

    return {"front": front, "back": back, "left": spin(+1.0), "right": spin(-1.0)}


def ground_align_y(points: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Shift so min-y matches the reference cloud's min-y (reference L110+)."""
    p = np.asarray(points, np.float64).copy()
    p[:, 1] += reference[:, 1].min() - p[:, 1].min()
    return p


CAD_AXIS_SWAP = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float64)


def build_taj_clouds(
    root: str | Path,
    sparse_ply: str = "segmented_point_cloud_final.ply",
    dense_ply: str = "fused.ply",
    voxel_npz: str = "Taj_voxel_grid.npz",
    cad_obj: str = "synthetic_taj.obj",
    cad_samples: int = 50000,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Assemble the notebook-5 comparison clouds (reference L67-L120).

    Inputs missing from disk are skipped (the reference snapshot itself lacks
    ``fused.ply`` and ``synthetic_taj.obj``).  Returns a dict of point
    clouds; keys follow the reference: "Sparse", "Dense (Cropped)",
    "Completed (ICP Aligned)", "Carved Grid", "Synthetic".
    """
    root = Path(root)
    out: Dict[str, np.ndarray] = {}

    sparse = load_ply(root / sparse_ply)["points"]
    plane, _ = segment_plane(sparse, 0.01, 1000, seed)
    sparse = align_plane_to_z(sparse, plane)
    out["Sparse"] = sparse

    if (root / dense_ply).exists():
        dense = load_ply(root / dense_ply)["points"]
        lo, hi = sparse.min(0), sparse.max(0)
        dense = dense[np.all((dense >= lo) & (dense <= hi), axis=1)]
        dense = align_plane_to_z(dense, plane)
        out["Dense (Cropped)"] = dense

    # 4-way symmetric completion + ordered ICP (L->F, R->F, B->L)
    sides = symmetric_completion(sparse)
    left, _ = icp_point_to_point(sides["left"], sides["front"], 0.05)
    right, _ = icp_point_to_point(sides["right"], sides["front"], 0.05)
    back, _ = icp_point_to_point(sides["back"], left, 0.05)
    out["Completed (ICP Aligned)"] = np.vstack([sides["front"], back, left, right])

    if (root / voxel_npz).exists():
        grid = load_voxel_grid_labels(root / voxel_npz)
        d0, d1, d2 = np.where(grid > 0)
        out["Carved Grid"] = np.stack([d2, d1, d0], 1).astype(np.float64)

    if (root / cad_obj).exists():
        verts, faces = load_obj(root / cad_obj)
        verts = verts @ CAD_AXIS_SWAP.T
        pts = sample_mesh_surface(verts, faces, cad_samples, seed)
        pts = flip_y_axis(pts)
        pts = ground_align_y(pts, out["Completed (ICP Aligned)"])
        out["Synthetic"] = pts

    return out
