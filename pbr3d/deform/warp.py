"""The 4-DoF per-part symmetry-preserving warp.

Reference semantics (utils/deformation_estimation.py:70-98, 262-313): for a
part's point set (x, y, z), about its centroid:

    x' = x·scale_xz + shift_xz·(W_vox/W_img)·sign(x)
    y' = y·scale_y  − shift_y ·(H_vox/H_img)
    z' = z·scale_xz + shift_xz·(D_vox/W_img)·sign(z)

applied to 7 jittered copies (±0.25 per axis) then rounded to int — a cheap
hole-free forward warp that preserves left/right and front/back symmetry.
The reference's ``np.unique`` dedup is unnecessary under scatter semantics
(duplicates write the same label) and is omitted on device; point-count
parity is irrelevant because every consumer is a set/scatter.

The pixel→voxel conversion reads the voxel shape as (D, H, W) =
grid.shape[:3] — i.e. dim0 is "D" and dim2 is "W" (reference :76-78); we
replicate that index usage exactly.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_JITTER = np.array(
    [
        [0, 0, 0],
        [0.25, 0, 0], [-0.25, 0, 0],
        [0, 0.25, 0], [0, -0.25, 0],
        [0, 0, 0.25], [0, 0, -0.25],
    ],
    np.float32,
)


def deform_coords(
    coords: jax.Array,  # (N, 3) float32 (x, y, z)
    valid: jax.Array,  # (N,) bool
    image_hw,  # (2,) ints or traced int32 array: (H_img, W_img)
    voxel_shape,  # (3,) ints or traced int32 array: (D, H, W)
    deform: jax.Array,  # (4,): scale_y, shift_y, scale_xz, shift_xz
    center: jax.Array | None = None,  # (3,) f32: the part centroid
    approx: bool = False,  # static: skip the 7-jitter + int rounding
) -> Tuple[jax.Array, jax.Array]:
    """Warp a padded point set; returns (coords_int (7N, 3) int32, valid (7N,)).

    Out-of-grid points are marked invalid (the reference filters them,
    deformation_estimation.py:105-111).  ``image_hw``/``voxel_shape`` may be
    traced arrays so one compiled program serves every scene size.

    ``center`` overrides the centroid the warp pivots on — required when
    ``coords`` is a subset (e.g. the surface shell) of the part whose full
    centroid defines the deform (reference uses the full set's mean,
    deformation_estimation.py:72-74).

    ``coords`` may be int16 (voxel coordinates fit; int16 halves the
    host->device transfer at 512 scale) — cast to float32 here, on device.

    With ``approx=True`` (a static flag) the warped FLOAT coords are
    returned without the 7-jitter replication or integer rounding — (N, 3)
    instead of (7N, 3), 7x less downstream point work.  The jitter exists
    to fill resampling holes in the voxel scatter (reference :84-98); a
    z-buffer/silhouette of the un-jittered float set differs only by
    sub-voxel edge pixels, which is plenty for COARSE search phases (the
    refinement and acceptance passes use the exact path).
    """
    coords = coords.astype(jnp.float32)
    image_hw = jnp.asarray(image_hw, jnp.float32)
    vs = jnp.asarray(voxel_shape, jnp.float32)
    H_img, W_img = image_hw[0], image_hw[1]
    D, H, W = vs[0], vs[1], vs[2]
    scale_y, shift_y, scale_xz, shift_xz = deform[0], deform[1], deform[2], deform[3]

    if center is None:
        # Centroid over VALID original points only (reference uses the raw set).
        n = jnp.maximum(jnp.sum(valid), 1)
        center = jnp.sum(jnp.where(valid[:, None], coords, 0.0), axis=0) / n
    else:
        center = jnp.asarray(center, jnp.float32)

    # In the reference each jittered copy is re-centered on ITS OWN mean, so
    # the constant jitter offset cancels inside the transform and re-appears
    # added to the output (deformation_estimation.py:70-98).  Equivalently:
    # transform the base points once, then add the 7 offsets and round.
    c = coords - center
    px = W / W_img
    py = H / H_img
    pz = D / W_img
    x = c[:, 0] * scale_xz + shift_xz * px * jnp.sign(c[:, 0])
    y = c[:, 1] * scale_y - shift_y * py
    z = c[:, 2] * scale_xz + shift_xz * pz * jnp.sign(c[:, 2])
    warped = jnp.stack([x, y, z], axis=-1) + center  # (N, 3)
    if approx:
        inb = (
            (warped[:, 0] >= -0.5) & (warped[:, 0] < W - 0.5)
            & (warped[:, 1] >= -0.5) & (warped[:, 1] < H - 0.5)
            & (warped[:, 2] >= -0.5) & (warped[:, 2] < D - 0.5)
        )
        return warped, valid & inb
    out = warped[None, :, :] + jnp.asarray(_JITTER)[:, None, :]  # (7, N, 3)
    out = jnp.round(out).astype(jnp.int32).reshape(-1, 3)

    v = jnp.broadcast_to(valid[None, :], (7, valid.shape[0])).reshape(-1)
    inb = (
        (out[:, 0] >= 0) & (out[:, 0] < W)
        & (out[:, 1] >= 0) & (out[:, 1] < H)
        & (out[:, 2] >= 0) & (out[:, 2] < D)
    )
    return out, v & inb


def deform_coords_soa(
    coords: jax.Array,  # (N, 3) f32/int16 (x, y, z)
    valid: jax.Array,  # (N,) bool
    image_hw,
    voxel_shape,
    deform: jax.Array,  # (4,)
    center: jax.Array,  # (3,) f32 — the FULL part centroid (required here)
    approx: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """SoA form of :func:`deform_coords`: returns (xs, ys, zs, valid) as
    (N,) — or (7N,) for the exact path — float32 vectors.

    Same warp, same 7-jitter + rounding, same bounds test; but the result
    never round-trips through an (N, 3) array, so the downstream z-buffer
    (``zbuffer_soa``) runs on fully packed vectors with no relayouts.  The
    exact path's rounded coordinates are returned as float32 holding exact
    integers — identical pixel math, no int cast."""
    coords = coords.astype(jnp.float32)
    image_hw = jnp.asarray(image_hw, jnp.float32)
    vs = jnp.asarray(voxel_shape, jnp.float32)
    H_img, W_img = image_hw[0], image_hw[1]
    D, H, W = vs[0], vs[1], vs[2]
    scale_y, shift_y, scale_xz, shift_xz = deform[0], deform[1], deform[2], deform[3]
    center = jnp.asarray(center, jnp.float32)

    cx = coords[:, 0] - center[0]
    cy = coords[:, 1] - center[1]
    cz = coords[:, 2] - center[2]
    px = W / W_img
    py = H / H_img
    pz = D / W_img
    xw = cx * scale_xz + shift_xz * px * jnp.sign(cx) + center[0]
    yw = cy * scale_y - shift_y * py + center[1]
    zw = cz * scale_xz + shift_xz * pz * jnp.sign(cz) + center[2]
    if approx:
        inb = (
            (xw >= -0.5) & (xw < W - 0.5)
            & (yw >= -0.5) & (yw < H - 0.5)
            & (zw >= -0.5) & (zw < D - 0.5)
        )
        return xw, yw, zw, valid & inb
    jit = jnp.asarray(_JITTER)
    xs = jnp.round(xw[None, :] + jit[:, 0:1]).reshape(-1)
    ys = jnp.round(yw[None, :] + jit[:, 1:2]).reshape(-1)
    zs = jnp.round(zw[None, :] + jit[:, 2:3]).reshape(-1)
    v = jnp.broadcast_to(valid[None, :], (7, valid.shape[0])).reshape(-1)
    inb = (
        (xs >= 0) & (xs <= W - 1)
        & (ys >= 0) & (ys <= H - 1)
        & (zs >= 0) & (zs <= D - 1)
    )
    return xs, ys, zs, v & inb


def scatter_part(
    grid: jax.Array,  # (D, H, W) uint8 label grid (accumulator)
    coords: jax.Array,  # (M, 3) int32 (x, y, z)
    valid: jax.Array,  # (M,)
    label: jax.Array,  # scalar uint8
) -> jax.Array:
    """Scatter a part's deformed points into the grid as ``grid[z, y, x] = label``
    (reference: deformation_estimation.py:120-124, 305-309)."""
    D, H, W = grid.shape
    # Route invalid (padding / out-of-grid) writes to cell (0,0,0) carrying
    # its current value — a no-op write that keeps the scatter fixed-shape.
    z = jnp.where(valid, jnp.clip(coords[:, 2], 0, D - 1), 0)
    y = jnp.where(valid, jnp.clip(coords[:, 1], 0, H - 1), 0)
    x = jnp.where(valid, jnp.clip(coords[:, 0], 0, W - 1), 0)
    upd = jnp.where(valid, label.astype(grid.dtype), grid[0, 0, 0])
    return grid.at[z, y, x].set(upd)


def build_deformed_grid(
    grid_labels: np.ndarray,
    part_points: Dict[str, Tuple[np.ndarray, np.ndarray]],
    deforms: Dict[str, np.ndarray],
    image_hw: Tuple[int, int],
) -> np.ndarray:
    """Assemble the full deformed grid from saved per-part deforms
    (reference ``save_deformed_grid``, deformation_estimation.py:288-313).

    ``part_points``: part -> (coords (N,3) f32, valid (N,) bool) padded sets.
    Parts without an entry in ``deforms`` are skipped (reference behavior).
    """
    from pbr3d import config

    voxel_shape = tuple(int(s) for s in np.asarray(grid_labels).shape[:3])
    out = jnp.zeros(voxel_shape, jnp.uint8)
    for part, (coords, valid) in part_points.items():
        if part not in deforms:
            continue
        c, v = deform_coords(
            jnp.asarray(coords), jnp.asarray(valid), image_hw, voxel_shape,
            jnp.asarray(deforms[part], jnp.float32),
        )
        out = scatter_part(out, c, v, jnp.uint8(config.PART_IDS[part]))
    return np.asarray(out)


@functools.partial(jax.jit, static_argnames=("D", "H", "W"))
def _build_fused(
    coords,  # per-part tuple of (n_i, 3) int16 — scatter order = part order
    labels: jax.Array,  # (N,) uint8
    valid,  # per-part tuple of (n_i,)
    slot: jax.Array,  # (N,) int32 — index into the deform/center tables
    deform_table: jax.Array,  # (S, 4) f32
    center_table: jax.Array,  # (S, 3) f32 — per-part FULL-set centroids
    image_hw: jax.Array,  # (2,) int32
    D: int, H: int, W: int,
) -> jax.Array:
    """Every part's warp + the full grid scatter in ONE program.

    Sequential per-part scatters (reference save_deformed_grid,
    deformation_estimation.py:288-313) resolve voxel collisions by part
    order, later parts winning.  The same result in one pass: warp all
    points with their part's deform (a table gather), then take the
    per-voxel argmax of the scatter-order key ``point_index*7 + jitter`` —
    monotone in the concatenated part order, so the winner matches the
    sequential semantics exactly.
    """
    # device concat INSIDE the program: the part sets stay device-resident
    # (no host round-trip) and no separate eager-concatenate executables
    # have to compile (cold-start) or dispatch (two per rebuild)
    if isinstance(coords, (tuple, list)):
        coords = jnp.concatenate(coords)
    if isinstance(valid, (tuple, list)):
        valid = jnp.concatenate(valid)
    pts = coords.astype(jnp.float32)
    d = deform_table[slot]  # (N, 4)
    ctr = center_table[slot]  # (N, 3)
    hw = jnp.asarray(image_hw, jnp.float32)
    px = W / hw[1]
    py = H / hw[0]
    pz = D / hw[1]
    c = pts - ctr
    x = c[:, 0] * d[:, 2] + d[:, 3] * px * jnp.sign(c[:, 0])
    y = c[:, 1] * d[:, 0] - d[:, 1] * py
    z = c[:, 2] * d[:, 2] + d[:, 3] * pz * jnp.sign(c[:, 2])
    warped = jnp.stack([x, y, z], axis=-1) + ctr
    out = warped[None, :, :] + jnp.asarray(_JITTER)[:, None, :]  # (7, N, 3)
    out = jnp.round(out).astype(jnp.int32)
    N = coords.shape[0]
    inb = (
        (out[..., 0] >= 0) & (out[..., 0] < W)
        & (out[..., 1] >= 0) & (out[..., 1] < H)
        & (out[..., 2] >= 0) & (out[..., 2] < D)
    ) & valid[None, :]
    vox = out[..., 2] * (H * W) + out[..., 1] * W + out[..., 0]  # (7, N)
    # scatter-order key: point-major so later PARTS always win collisions
    order = (jnp.arange(N, dtype=jnp.int32) * 7)[None, :] + jnp.arange(
        7, dtype=jnp.int32
    )[:, None]
    seg = jnp.where(inb, vox, D * H * W)
    winner = jax.ops.segment_max(
        jnp.where(inb, order, -1).reshape(-1),
        seg.reshape(-1),
        num_segments=D * H * W + 1,
    )[: D * H * W]
    lab = jnp.where(
        winner >= 0,
        jnp.take(labels, jnp.clip(winner // 7, 0, N - 1)).astype(jnp.uint8),
        jnp.uint8(0),
    )
    return lab.reshape(D, H, W)


def build_deformed_grid_fused(
    part_points: Dict[str, Tuple[np.ndarray, np.ndarray]],
    deforms: Dict[str, np.ndarray],
    centers: Dict[str, np.ndarray],
    image_hw: Tuple[int, int],
    voxel_shape: Tuple[int, int, int],
    part_order,
) -> jax.Array:
    """One-dispatch rebuild; returns the DEVICE uint8 label grid.

    ``part_points`` may be device-resident padded sets; ``part_order``
    fixes the collision priority (the reference's save order).  Equivalent
    to :func:`build_deformed_grid` (same warp, same collision rule).
    """
    from pbr3d import config

    # Concatenation happens ON DEVICE: ``part_points`` may hold
    # device-resident sets (the point-table path), and re-downloading +
    # re-uploading ~70 MB per rebuild was the dominant verify cost.
    coords, labels, valid, slot = [], [], [], []
    table_d, table_c = [], []
    for s, part in enumerate(p for p in part_order if p in deforms):
        pp, vv = part_points[part]
        n = pp.shape[0]
        coords.append(jnp.asarray(pp))
        valid.append(jnp.asarray(vv))
        # labels/slot are built and concatenated on HOST: they're tiny
        # (uint8/int32 per point, one upload), while the eager jnp.full +
        # jnp.concatenate versions compiled 3 one-off remote programs per
        # part-count shape family per process
        labels.append(np.full((n,), config.PART_IDS[part], np.uint8))
        slot.append(np.full((n,), len(table_d), np.int32))
        table_d.append(np.asarray(deforms[part], np.float32))
        table_c.append(np.asarray(centers[part], np.float32))
    D, H, W = (int(v) for v in voxel_shape)
    return _build_fused(
        tuple(coords),
        jnp.asarray(np.concatenate(labels)),
        tuple(valid),
        jnp.asarray(np.concatenate(slot)),
        jnp.asarray(np.stack(table_d)),
        jnp.asarray(np.stack(table_c)),
        jnp.asarray(np.asarray(image_hw, np.int32)),
        D, H, W,
    )
