"""Stage 1 — orthographic semantic voxel carving.

JAX re-design of the reference's carving engine
(reference: utils/voxel_carving_utils.py).  All grids are uint8 *label*
grids of shape (W, H, D) (0 = empty, 1..10 = part ids); the RGB conversion
happens only at the artifact boundary (pbr3d.io.artifacts).

Pipeline (reference: notebook 1 cells 5-7; utils/voxel_carving_utils.py:269-400):

1. ``global_carve``: silhouette-carve a full (w, h, w) grid with the binary
   front mask under the cumulative rotate-and-carve sweep, then paint part
   labels by extruding the exterior semantic mask along depth.
2. ``part_carve``: re-carve each part group against its own 2D mask.
3. ``component_guided_carve``: per 3D connected component of a part, re-carve
   inside its bbox against the bbox-cropped 2D mask at a finer angle.
4. ``extrude_interior_parts``: extrude doors/windows inward from the first
   occupied surface along ±Z and ±X.
5. ``recolor_backward_components``: reorient the grid (transpose + flip, a
   frame change that *persists* into the saved artifact, reference
   :383-393) and recolor all but the two front-most "front_minarets"
   components to "back_minarets".

Orchestration is eager (concrete shapes for the data-dependent component
bboxes); every heavy op is a jit-compiled XLA kernel.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.config import PART_IDS
from pbr3d.ops.carve import rotate_carve_sweep_jit
from pbr3d.ops.components import (
    component_stats,
    connected_components,
    connected_components_device,
)

Array = jax.Array


def _as_wh(mask: np.ndarray | jax.Array, W: int, H: int):
    """Ensure a 2D mask is (W, H) (reference: voxel_carving_utils.py:19-28).

    Accepts (H, W) or (W, H); square masks are assumed (H, W), matching the
    reference's precedence.
    """
    if mask.shape == (H, W):
        return mask.T
    if mask.shape == (W, H):
        return mask
    raise ValueError(f"Mask shape {mask.shape} incompatible with (W,H)=({W},{H})")


# ---------------------------------------------------------------------------
# 1. Global carving
# ---------------------------------------------------------------------------


def global_carve(
    binary_mask: np.ndarray,
    exterior_labels: np.ndarray,
    angle_interval: int = 90,
    bucket: int | None = 64,
) -> Array:
    """Silhouette-carve + semantic label extrusion.

    ``binary_mask``: (H, W) {0,1}; ``exterior_labels``: (H, W) uint8 labels.
    Returns a uint8 label grid (W, H, W) on device
    (reference: voxel_carving_utils.py:269-298).
    """
    h, w = binary_mask.shape
    occ = jnp.ones((w, h, w), jnp.float32)
    carved = rotate_carve_sweep_jit(
        occ, jnp.asarray(binary_mask).T, angle_interval, bucket=bucket
    )
    # Paint: label of a voxel = exterior label of its (x, y) column
    # (reference ``apply_colored_mask_to_voxel_grid``, :128-136).  Blend/other
    # and background pixels cannot survive the binary carve's own column mask
    # in the reference either way — but note the reference extrudes the RGB
    # exterior mask, whose background pixels DO get painted wherever carving
    # kept the column; the binary mask excludes background columns, so the
    # two agree.
    col = jnp.asarray(exterior_labels).T  # (W, H)
    return (carved.astype(jnp.uint8)) * col[:, :, None]


# ---------------------------------------------------------------------------
# 2. Per-part-group carving
# ---------------------------------------------------------------------------


def part_carve(
    labels_grid: Array,
    exterior_labels: np.ndarray,
    group_jobs: Iterable[Tuple[Sequence[str], int]],
    bucket: int | None = 64,
) -> Array:
    """Re-carve each part group under its own symmetry sweep.

    Groups whose 2D mask is empty are skipped; later groups overwrite earlier
    ones where nonzero (reference: voxel_carving_utils.py:139-160).
    """
    final = jnp.zeros_like(labels_grid)
    for names, angle in group_jobs:
        ids = config.part_ids(names)
        if isinstance(exterior_labels, np.ndarray):
            mask2d = np.isin(exterior_labels, ids)  # (H, W)
            if not mask2d.any():  # host fast path: skip empty groups
                continue
            m_wh = jnp.asarray(np.ascontiguousarray(mask2d.T))  # (W, H)
        else:  # traced: empty groups are a no-op anyway (carve of zeros)
            m_wh = jnp.isin(exterior_labels, jnp.asarray(ids)).T
        sub = labels_grid * m_wh.astype(jnp.uint8)[:, :, None]
        occ = (sub > 0).astype(jnp.float32)
        carved = rotate_carve_sweep_jit(occ, m_wh, int(angle), bucket=bucket)
        part = sub * carved.astype(jnp.uint8)
        final = jnp.where(part > 0, part, final)
    return final


# ---------------------------------------------------------------------------
# 3. Component-guided carving
# ---------------------------------------------------------------------------


def component_guided_carve(
    labels_grid: Array,
    exterior_labels: np.ndarray,
    part_name: str,
    angle: int = 60,
    bucket: int | None = 32,
) -> Array:
    """Finer-angle re-carve of each 3D connected component of one part.

    For every 6-connected component of ``labels == part``: crop the grid to
    the component bbox, sweep-carve the *occupancy of all parts in the bbox*
    against the bbox-cropped 2D part mask, and erase the component's voxels
    wherever the carve removed them
    (reference ``left_right_guided_carve``, voxel_carving_utils.py:163-210).
    """
    target = PART_IDS[part_name]
    mask2d = exterior_labels == target  # (H, W)
    if not mask2d.any():
        return labels_grid

    comp_dev, n = connected_components_device(
        jnp.asarray(labels_grid) == target, "face"
    )
    stats = component_stats(comp_dev, n)

    for i in range(1, n + 1):
        if stats["count"][i] == 0:
            continue
        x0, y0, z0 = stats["bbox_min"][i]
        x1, y1, z1 = stats["bbox_max"][i] + 1
        crop2d = mask2d[y0:y1, x0:x1]  # (H', W')
        sub = labels_grid[x0:x1, y0:y1, z0:z1]
        occ = (sub > 0).astype(jnp.float32)
        m_wh = jnp.asarray(
            np.ascontiguousarray(_as_wh(crop2d, x1 - x0, y1 - y0))
        )
        carved = rotate_carve_sweep_jit(occ, m_wh, int(angle), bucket=bucket)
        comp_sub = comp_dev[x0:x1, y0:y1, z0:z1] == i
        sub_new = jnp.where(comp_sub & (carved < 0.5), 0, sub)
        labels_grid = jax.lax.dynamic_update_slice(
            labels_grid, sub_new.astype(labels_grid.dtype), (int(x0), int(y0), int(z0))
        )
    return labels_grid


# ---------------------------------------------------------------------------
# 4. Interior extrusion
# ---------------------------------------------------------------------------


def extrude_from_surface(
    labels_grid: Array,
    mask2d: np.ndarray,
    axis: int,
    direction: str = "+",
    depth: int = 5,
    fill_id: int | None = None,
) -> Array:
    """Extrude ``depth`` voxels inward from the first occupied surface.

    Replicates the reference exactly (voxel_carving_utils.py:213-248),
    including its quirk for ``axis=0`` where the (H, W) mask's column index
    is read as depth z (harmless because stage-1 grids have W == D).
    ``fill_id=None`` erases instead of painting.
    """
    occ = labels_grid > 0
    W, H, D = occ.shape
    m = jnp.asarray(np.ascontiguousarray(mask2d))

    if axis == 2:
        scan = occ if direction == "+" else occ[:, :, ::-1]
        start = jnp.argmax(scan, axis=2)  # (W, H); all-empty columns -> 0
        if direction == "-":
            start = D - 1 - start
        valid = m.T  # (W, H)
        zs = jax.lax.broadcasted_iota(jnp.int32, (W, H, D), 2)
        filled = jnp.zeros((W, H, D), bool)
        for d in range(depth):
            z = start + d if direction == "+" else start - d
            ok = (z >= 0) & (z < D) & valid
            filled = filled | ((zs == z[:, :, None]) & ok[:, :, None])
    elif axis == 0:
        scan = occ if direction == "+" else occ[::-1]
        start = jnp.argmax(scan, axis=0)  # (H, D)
        if direction == "-":
            start = W - 1 - start
        valid = m  # (H, W) read as (H, D) — reference quirk (W == D)
        xs = jax.lax.broadcasted_iota(jnp.int32, (W, H, D), 0)
        filled = jnp.zeros((W, H, D), bool)
        for d in range(depth):
            x = start + d if direction == "+" else start - d
            ok = (x >= 0) & (x < W) & valid
            filled = filled | ((xs == x[None, :, :]) & ok[None, :, :])
    else:
        raise ValueError("axis must be 0 or 2")

    fill = jnp.uint8(0 if fill_id is None else fill_id)
    return jnp.where(filled, fill, labels_grid)


def extrude_interior_parts(
    labels_grid: Array,
    semantic_labels: np.ndarray,
    extrusion_depths: Iterable[Tuple[str, int]],
) -> Array:
    """Extrude each interior part in all four directions (±Z then ±X)
    (reference: voxel_carving_utils.py:356-373)."""
    for part, depth in extrusion_depths:
        pid = PART_IDS[part]
        mask = semantic_labels == pid  # (H, W) — FULL mask, not exterior
        for axis, direction in ((2, "+"), (2, "-"), (0, "+"), (0, "-")):
            labels_grid = extrude_from_surface(
                labels_grid, mask, axis, direction, int(depth), pid
            )
    return labels_grid


# ---------------------------------------------------------------------------
# 5. Back-minaret recoloring (with the persistent reorientation)
# ---------------------------------------------------------------------------


def reorient(labels_grid: Array) -> Array:
    """The transpose(2,1,0) + flip(axis=1) frame change the reference applies
    before recoloring and never undoes (voxel_carving_utils.py:383-386)."""
    return jnp.flip(jnp.transpose(labels_grid, (2, 1, 0)), axis=1)


def recolor_backward_components(
    labels_grid: Array,
    part_name: str = "front_minarets",
    new_part_name: str = "back_minarets",
    k: int = 2,
    sort_axis: int = 0,
) -> Array:
    """Keep the ``k`` components with smallest mean coordinate along
    ``sort_axis``; recolor the rest (reference: voxel_carving_utils.py:252-266)."""
    pid, new_pid = PART_IDS[part_name], PART_IDS[new_part_name]
    comp, n = connected_components_device(jnp.asarray(labels_grid) == pid, "face")
    if n <= k:
        return labels_grid
    stats = component_stats(comp, n)
    means = stats["centroid"][1 : n + 1, sort_axis]  # comps 1..n
    keep = set((np.argsort(means, kind="stable")[:k] + 1).tolist())
    recolor_ids = np.array(
        [i for i in range(1, n + 1) if i not in keep], dtype=np.int32
    )
    recolor_mask = jnp.isin(comp, jnp.asarray(recolor_ids))
    return jnp.where(recolor_mask, jnp.uint8(new_pid), labels_grid)


# ---------------------------------------------------------------------------
# Full stage-1 driver
# ---------------------------------------------------------------------------


def partwise_carve(
    labels_grid: Array,
    exterior_labels: np.ndarray,
    semantic_labels: np.ndarray,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
) -> Array:
    """Part-wise refinement after global carving
    (reference: voxel_carving_utils.py:302-400)."""
    grid = part_carve(labels_grid, exterior_labels, preset.group_jobs)
    for part, angle in preset.part_symmetry:
        grid = component_guided_carve(grid, exterior_labels, part, angle)
    grid = extrude_interior_parts(grid, semantic_labels, preset.extrusion_depths)
    if preset.recolor_back_minarets:
        grid = recolor_backward_components(reorient(grid))
    return grid


def carve_monument(
    mask_set,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
) -> Array:
    """Full stage 1 for one monument: global + part-wise carving.

    ``mask_set``: a :class:`pbr3d.io.masks.MaskSet`.
    Returns the final uint8 label grid (in the reoriented frame, matching the
    reference's saved stage-1 artifacts).
    """
    grid = global_carve(
        mask_set.binary, mask_set.exterior_labels, preset.global_angle_interval
    )
    return partwise_carve(
        grid, mask_set.exterior_labels, mask_set.semantic_labels, preset
    )
