"""Inter-method point-cloud / surface metrics (notebook 5 support).

Re-designs ``utils/eval_helpers.py`` on device reductions:

* chamfer / F-score / F1(τ) curves on the tiled matmul NN kernel
  (pbr3d.ops.neighbors) instead of cKDTree/sklearn
  (reference: eval_helpers.py:36-67,248-296);
* pairwise voxel IoU at a shared grid with cross-element dilation
  (reference :83-107);
* NN-regularity stats (reference :114-126);
* PCA shape similarity via a 3x3 eigendecomposition (reference :70-76);
* point-cloud -> smoothed density grid -> marching-cubes surface + normal /
  roughness / curvature statistics (reference :178-244).

Determinism: the reference downsamples with an *unseeded* ``np.random.choice``
for chamfer/F-score (eval_helpers.py:29-34) and a seeded generator for the F1
curves (:253).  Here every downsample is seeded (default 0) for reproducible
tables.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from pbr3d.ops.morphology import binary_dilation, gaussian_filter
from pbr3d.ops.neighbors import knn, min_dist, self_nn_dist


def _downsample(P: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    if len(P) <= n:
        return P
    rng = np.random.default_rng(seed)
    return P[rng.choice(len(P), n, replace=False)]


# ---------------------------------------------------------------------------
# Accuracy
# ---------------------------------------------------------------------------


def chamfer_distance(
    A: np.ndarray, B: np.ndarray, max_points: int = 20000,
    squared: bool = True, seed: int = 0,
) -> float:
    A = _downsample(np.asarray(A, np.float32), max_points, seed)
    B = _downsample(np.asarray(B, np.float32), max_points, seed + 1)
    dA = min_dist(A, B)
    dB = min_dist(B, A)
    if squared:
        return float(np.mean(dA**2) + np.mean(dB**2))
    return float(np.mean(dA) + np.mean(dB))


def fscore_with_threshold(
    A: np.ndarray, B: np.ndarray, tau: float = 0.03,
    max_points: int = 20000, seed: int = 0,
) -> Tuple[float, float, float]:
    A = _downsample(np.asarray(A, np.float32), max_points, seed)
    B = _downsample(np.asarray(B, np.float32), max_points, seed + 1)
    precision = float(np.mean(min_dist(A, B) < tau))
    recall = float(np.mean(min_dist(B, A) < tau))
    f1 = 0.0 if precision + recall == 0 else 2 * precision * recall / (precision + recall)
    return f1, precision, recall


def compute_nn_distances(
    A: np.ndarray, B: np.ndarray, max_points: int = 50000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    A = _downsample(np.asarray(A, np.float32), max_points, seed)
    B = _downsample(np.asarray(B, np.float32), max_points, seed)
    return min_dist(A, B), min_dist(B, A)


def f1_curve_from_distances(d_AB, d_BA, thresholds):
    precs, recs, f1s = [], [], []
    for t in thresholds:
        prec = float(np.mean(d_AB < t))
        rec = float(np.mean(d_BA < t))
        f1s.append(0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec))
        precs.append(prec)
        recs.append(rec)
    return np.asarray(recs), np.asarray(precs), np.asarray(f1s)


def compute_f1_curve(A, B, thresholds, max_points: int = 50000, seed: int = 0):
    d_AB, d_BA = compute_nn_distances(A, B, max_points, seed)
    return f1_curve_from_distances(d_AB, d_BA, thresholds)


def pca_shape_similarity(A: np.ndarray, B: np.ndarray) -> float:
    """1 - L1 distance of explained-variance ratios (reference :70-76)."""

    def ratios(P):
        P = np.asarray(P, np.float64)
        C = np.cov((P - P.mean(0)).T)
        w = np.linalg.eigvalsh(C)[::-1]
        return w / w.sum()

    return float(1.0 - np.sum(np.abs(ratios(A) - ratios(B))))


# ---------------------------------------------------------------------------
# Completeness
# ---------------------------------------------------------------------------


def voxel_iou(
    A: np.ndarray, B: np.ndarray, resolution: int = 96, dilate_frac: float = 0.01
) -> float:
    """Occupancy IoU on a shared grid with relative dilation
    (reference :83-107)."""
    all_pts = np.vstack([A, B])
    lo, hi = all_pts.min(0), all_pts.max(0)
    step = (hi - lo).max() / resolution

    def occ(P):
        idx = np.clip(((P - lo) / step).astype(int), 0, resolution - 1)
        g = np.zeros((resolution,) * 3, bool)
        g[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        return g

    occA, occB = occ(A), occ(B)
    if dilate_frac > 0:
        iters = max(1, int(round(dilate_frac * np.linalg.norm(hi - lo) / step)))
        occA = np.asarray(binary_dilation(jnp.asarray(occA), iters))
        occB = np.asarray(binary_dilation(jnp.asarray(occB), iters))
    union = np.count_nonzero(occA | occB)
    return float(np.count_nonzero(occA & occB) / union) if union else float("nan")


# ---------------------------------------------------------------------------
# Regularity
# ---------------------------------------------------------------------------


def compute_nn_stats(pts: np.ndarray, max_points: int = 50000, seed: int = 0) -> Dict:
    pts = _downsample(np.asarray(pts, np.float32), max_points, seed)
    nn = self_nn_dist(pts)
    return {
        "NN Mean ↓": float(nn.mean()),
        "NN Std ↓": float(nn.std()),
        "NN CV ↓": float(nn.std() / (nn.mean() + 1e-8)),
    }


# ---------------------------------------------------------------------------
# Surface
# ---------------------------------------------------------------------------


def normalize_preserve_aspect(points: np.ndarray) -> np.ndarray:
    """(pts − min)/(size.max()+1e-8), then drop y so its max is 0
    (recovered reference: utils/preprocess_helpers bytecode L19-25)."""
    p = np.asarray(points, np.float64)
    mn = p.min(0)
    size = p.max(0) - mn
    norm = (p - mn) / (size.max() + 1e-8)
    norm[:, 1] -= norm[:, 1].max()
    return norm


def pointcloud_to_voxel_grid(
    points: np.ndarray, grid_size: int = 128, sigma: float = 1.0
) -> np.ndarray:
    """Density grid of the aspect-normalized cloud, Gaussian-smoothed, with
    clamped boundary (reference :178-189)."""
    norm = normalize_preserve_aspect(points)
    vox = (norm * (grid_size - 1)).astype(int)
    grid = np.zeros((grid_size,) * 3, np.float32)
    np.add.at(grid, (vox[:, 0], vox[:, 1], vox[:, 2]), 1.0)
    if sigma > 0:
        grid = np.array(gaussian_filter(jnp.asarray(grid), sigma))
    grid[[0, -1], :, :] = 0
    grid[:, [0, -1], :] = 0
    grid[:, :, [0, -1]] = 0
    return grid


def get_marching_cubes_mesh(
    points: np.ndarray, grid_size: int = 128, sigma: float = 1.0, level: float = 0.1
):
    """Point cloud -> density grid -> iso-surface (reference :191-195).

    Uses classic marching cubes (pbr3d.ops.isosurface.marching_cubes):
    cube-edge vertex topology matching ``skimage.measure.marching_cubes``,
    so the notebook-5 surface statistics (normal spread, roughness,
    curvature) are computed over comparable tessellations.
    """
    from pbr3d.ops.isosurface import marching_cubes

    grid = pointcloud_to_voxel_grid(points, grid_size, sigma)
    verts, faces = marching_cubes(grid, level)
    return verts / grid_size, faces


def filter_mesh(vertices: np.ndarray, faces: np.ndarray, y_thresh: float = 0.2):
    """Keep vertices with y <= y_thresh and faces fully inside
    (reference :18-23)."""
    mask = vertices[:, 1] <= y_thresh
    valid_idx = np.where(mask)[0]
    face_mask = np.all(np.isin(faces, valid_idx), axis=1)
    return vertices[mask], faces[face_mask]


def compute_triangle_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    return n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-8)


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = compute_triangle_normals(vertices, faces)
    vnorm = np.zeros_like(vertices)
    np.add.at(vnorm, faces.reshape(-1), np.repeat(tri, 3, axis=0))
    return vnorm / (np.linalg.norm(vnorm, axis=1, keepdims=True) + 1e-8)


def compute_surface_metrics(vertices: np.ndarray, faces: np.ndarray, k: int = 20) -> Dict:
    """Normal spread / PCA roughness λ3 / Laplacian curvature over k-NN
    neighborhoods — vectorized (the reference loops per vertex, :215-244)."""
    vertices = np.asarray(vertices, np.float32)
    normals = compute_vertex_normals(vertices, faces)
    _, idx = knn(vertices, vertices, k)
    nbr = vertices[idx]  # (N, k, 3)

    nbr_normals = normals[idx]  # (N, k, 3)
    dots = np.clip(np.einsum("nkd,nd->nk", nbr_normals, normals), -1.0, 1.0)
    angles = np.degrees(np.arccos(dots))
    normal_std = angles.std(axis=1)

    centered = nbr - nbr.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / nbr.shape[1]
    eig = np.linalg.eigvalsh(cov)  # ascending
    # sklearn's PCA divides by (k - 1); the covariance above used k.
    roughness = eig[:, 0] * nbr.shape[1] / (nbr.shape[1] - 1)

    laplace = nbr.mean(axis=1) - vertices
    curvature = np.linalg.norm(laplace, axis=1)

    return {
        "Normal StdDev (°)": float(normal_std.mean()),
        "Mean Roughness (λ₃)": float(roughness.mean()),
        "Mean Curvature": float(curvature.mean()),
    }
