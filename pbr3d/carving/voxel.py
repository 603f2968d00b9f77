"""Voxel-grid <-> point-set utilities (label domain).

Coordinate convention preserved from the reference: a label grid is indexed
(d0, d1, d2); point lists are columns (x, y, z) = (d2, d1, d0) in the raster
order of ``np.where`` (reference: utils/voxel_utils.py:17-18,41-43).  That
raster order matters — the splat projector's last-write-wins collision rule
depends on it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.ops.components import connected_components, component_stats


def _xyz_f32(d0: np.ndarray, d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """(N, 3) float32 (x, y, z) from np.where index triples.

    Preallocating float32 and writing columns avoids the int64 transposed
    temporary of ``np.stack([d2, d1, d0], axis=1).astype(np.float32)``
    (identical result, far less memory traffic on multi-million-point
    monuments).
    """
    out = np.empty((len(d0), 3), np.float32)
    out[:, 0] = d2
    out[:, 1] = d1
    out[:, 2] = d0
    return out


class PointCache:
    """One full-grid pass, then per-part point sets by cheap filtering.

    ``points_by_parts`` scans the whole grid per call; with many parts
    those host scans add up in stage 3.  The cache
    extracts ALL occupied voxels once (raster order preserved) and filters
    the flat label vector per part.
    """

    def __init__(self, grid_labels: np.ndarray):
        g = np.asarray(grid_labels)
        d0, d1, d2 = np.where(g > 0)
        self._pts = _xyz_f32(d0, d1, d2)
        self._labels = g[d0, d1, d2]
        # Same-label interior: all 6 face neighbors carry the SAME label.
        # ``~interior`` restricted to one part is exactly that part's own
        # 6-connected shell (surface_points_by_parts of the part's solid) —
        # computed once for every part in the same grid pass.
        interior = np.ones(g.shape, bool)
        for ax in range(3):
            for sh in (1, -1):
                same = np.zeros(g.shape, bool)
                src = [slice(None)] * 3
                dst = [slice(None)] * 3
                if sh == 1:
                    src[ax], dst[ax] = slice(1, None), slice(0, -1)
                else:
                    src[ax], dst[ax] = slice(0, -1), slice(1, None)
                same[tuple(dst)] = g[tuple(src)] == g[tuple(dst)]
                interior &= same
        self._surface = ~interior[d0, d1, d2]

    def points_by_parts(self, part_names: Sequence[str]):
        ids = config.part_ids(part_names)
        keep = np.isin(self._labels, ids)
        return self._pts[keep], self._labels[keep]

    def surface_points_by_parts(self, part_names: Sequence[str]):
        """Each selected part's OWN 6-connected shell (cheap filter; matches
        ``surface_points_by_parts(grid, [part])`` per single part)."""
        ids = config.part_ids(part_names)
        keep = np.isin(self._labels, ids) & self._surface
        return self._pts[keep], self._labels[keep]

    def all_points(self):
        return self._pts, self._labels


def points_by_parts(
    grid_labels: np.ndarray, part_names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y, z) float32 points + uint8 labels of the selected parts.

    Reference ``get_voxel_points_by_parts`` (utils/voxel_utils.py:7-21) in the
    label domain (colors == labels).
    """
    grid_labels = np.asarray(grid_labels)
    ids = config.part_ids(part_names)
    mask = np.isin(grid_labels, ids)
    d0, d1, d2 = np.where(mask)
    pts = _xyz_f32(d0, d1, d2)
    return pts, grid_labels[d0, d1, d2]


def surface_points_by_parts(
    grid_labels: np.ndarray, part_names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """The 6-connected SURFACE shell of the selected parts' solid, as
    (x, y, z) points + labels in raster order.

    Any camera ray entering the solid passes through a shell voxel first, so
    a point-splat silhouette (and a min-Z buffer) of the shell matches the
    full solid's to within pixel-rounding edge cases — at a fraction of the
    points (O(V^2) vs O(V^3)).  Used by the stage-2 mask-IoU camera search,
    whose per-candidate segment reductions scale with the point count.
    """
    grid_labels = np.asarray(grid_labels)
    ids = config.part_ids(part_names)
    sel = np.isin(grid_labels, ids)
    # Crop to the selection's bbox before the 6 neighbor shifts: ``sel`` is
    # False outside it, so the shell inside the crop is identical — and for
    # small parts (e.g. the stage-2 minaret shells) this turns six full-grid
    # boolean passes into six bbox-sized ones.
    proj = [np.any(sel, axis=ax) for ax in ((1, 2), (0, 2), (0, 1))]
    if not proj[0].any():
        return np.empty((0, 3), np.float32), np.empty((0,), grid_labels.dtype)
    lo = [int(np.argmax(p)) for p in proj]
    hi = [len(p) - int(np.argmax(p[::-1])) for p in proj]
    box = tuple(slice(l, h) for l, h in zip(lo, hi))
    sel = sel[box]
    interior = np.ones_like(sel)
    for ax in range(3):
        for sh in (1, -1):
            shifted = np.zeros_like(sel)
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if sh == 1:
                src[ax], dst[ax] = slice(1, None), slice(0, -1)
            else:
                src[ax], dst[ax] = slice(0, -1), slice(1, None)
            shifted[tuple(dst)] = sel[tuple(src)]
            interior &= shifted
    shell = sel & ~interior
    d0, d1, d2 = np.where(shell)
    pts = _xyz_f32(d0 + lo[0], d1 + lo[1], d2 + lo[2])
    return pts, grid_labels[d0 + lo[0], d1 + lo[1], d2 + lo[2]]


def all_points(grid_labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All occupied voxels as (x, y, z) points + labels
    (reference: eval_helpers_intra.py:138-139)."""
    grid_labels = np.asarray(grid_labels)
    d0, d1, d2 = np.where(grid_labels > 0)
    pts = _xyz_f32(d0, d1, d2)
    return pts, grid_labels[d0, d1, d2]


def grid_to_points(
    grid_labels: np.ndarray, stride: int = 2
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]:
    """Strided occupied-voxel extraction for visualization
    (reference ``voxel_grid_to_points``, utils/voxel_utils.py:35-51)."""
    g = np.asarray(grid_labels)
    W, H, D = g.shape[:3]
    ds = g[::stride, ::stride, ::stride]
    d0, d1, d2 = np.where(ds > 0)
    pts = _xyz_f32(d0, d1, d2) * stride
    return pts, ds[d0, d1, d2], (H, W, D)


def extract_top_k_components(
    grid_labels: np.ndarray, part_name: str, k: int = 4
) -> np.ndarray:
    """Keep only the k tallest 26-connected components of one part
    (reference: utils/voxel_utils.py:24-33; height = extent along dim 1)."""
    grid_labels = np.asarray(grid_labels)
    pid = config.PART_IDS[part_name]
    comp, n = connected_components(grid_labels == pid, "full")
    if n == 0:
        return grid_labels.copy()
    stats = component_stats(comp, n)
    heights = (stats["bbox_max"][1:, 1] - stats["bbox_min"][1:, 1]).astype(np.int64)
    top = np.argsort(-heights, kind="stable")[:k] + 1
    out = grid_labels.copy()
    drop = (comp > 0) & ~np.isin(comp, top)
    out[drop] = 0
    return out


def meshify_colored_voxel_grid(grid_labels: np.ndarray, stride: int = 1):
    """Surface mesh of a label grid with nearest-voxel vertex colors.

    Reference ``meshify_colored_voxel_grid`` (utils/voxel_utils.py:53-95):
    marching cubes on the (strided) occupancy at level 0.5, vertices
    reordered (d0,d1,d2) -> (x,y,z), the stage-1 transpose+flip mirror
    compensated by ``z -> D - z``, vertex colors from the nearest occupied
    voxel, normalized to [0, 1].

    Iso-surfacing uses classic marching cubes (pbr3d.ops.isosurface —
    cube-edge vertex topology matching skimage's) and colors use the tiled
    NN kernel instead of sklearn.  Returns
    (verts (N,3) f32, faces (M,3) i32, vertex_colors (N,3) f64 in [0,1],
    normals (M,3) f32 per-face).
    """
    from pbr3d.config import labels_to_rgb
    from pbr3d.ops.isosurface import marching_cubes
    from pbr3d.ops.neighbors import knn

    grid_labels = np.asarray(grid_labels)
    g = grid_labels[::stride, ::stride, ::stride] if stride > 1 else grid_labels
    occ = g > 0
    verts, faces = marching_cubes(occ.astype(np.float32), 0.5)
    verts = verts * stride

    # (d0, d1, d2) -> (x, y, z), then undo the stage-1 reorientation mirror.
    verts = verts[:, [2, 1, 0]].copy()
    verts[:, 2] = grid_labels.shape[2] - verts[:, 2]

    filled = np.argwhere(occ).astype(np.float32)  # (K, 3) in (d0, d1, d2)
    colors = labels_to_rgb(g[occ])
    _, idx = knn(verts[:, [2, 1, 0]] / stride, filled, k=1)
    vertex_colors = colors[idx[:, 0]].astype(np.float64)
    if vertex_colors.max() > 1:
        vertex_colors = vertex_colors / 255.0

    tri = verts[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = normals / (np.linalg.norm(normals, axis=1, keepdims=True) + 1e-8)
    return verts, faces, vertex_colors, normals


def pad_points(
    pts: np.ndarray, labels: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a variable-size point set to a fixed size for jit'd consumers.

    Returns (pts (n,3) f32, labels (n,) uint8, valid (n,) bool).  ``n`` is
    typically the next power-of-two bucket, so the number of distinct
    compiled shapes stays tiny.
    """
    m = pts.shape[0]
    if m > n:
        raise ValueError(f"{m} points exceed pad size {n}")
    out_p = np.zeros((n, 3), np.float32)
    out_l = np.zeros((n,), np.uint8)
    out_v = np.zeros((n,), bool)
    out_p[:m] = pts
    out_l[:m] = labels
    out_v[:m] = True
    return out_p, out_l, out_v


def bucket_size(m: int, minimum: int = 1024) -> int:
    """Next power-of-two >= m (>= minimum)."""
    n = minimum
    while n < m:
        n *= 2
    return n
