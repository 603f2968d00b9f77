"""Point-splat projection, z-buffering, and mask IoU — deterministic device
reductions (no order-dependent scatters).

Reference semantics replicated:

* splat projector (utils/projection_utils.py:5-23): round u/v to ints
  (numpy banker's rounding), keep in-bounds points, write colors with
  numpy fancy assignment — LAST point wins on collisions.  We reproduce
  last-write-wins with a ``segment_max`` over point order (a deterministic
  reduction; plain scatter has unspecified duplicate order in XLA).
* z-buffer (utils/eval_helpers_intra.py:134-160): per-pixel min camera-Z of
  all occupied voxels, Z > 1e-6 validity — a ``segment_min``, replacing the
  reference's per-point interpreted Python loop (its stage-4 bottleneck).
* visibility-aware part projection (utils/eval_helpers_intra.py:168-190):
  pixel on iff some part point has |Z - zbuf| < eps.
* per-part color-exact IoU (utils/camera_estimation.py:770-788) in the
  integer label domain.

All functions are fixed-shape (padded point sets with a validity mask) and
jit/vmap friendly — the mask-IoU camera search vmaps ``splat_labels`` +
``partwise_iou`` over hundreds of candidate cameras at once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from pbr3d.ops.cameramath import project_points


def _pixel_index(
    u: jax.Array, v: jax.Array, valid: jax.Array, H: int, W: int,
    true_hw: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Round to integer pixels; returns (flat index with dump bucket H*W, valid).

    ``H``/``W`` are the (static) plane allocation; ``true_hw`` (2,) int32, if
    given, bounds the VALID image region dynamically — this lets callers pad
    image planes to shared bucket shapes (one compiled program for many
    image sizes) while keeping the reference's exact clipping semantics.
    """
    ui = jnp.round(u).astype(jnp.int32)  # jnp.round == numpy banker's rounding
    vi = jnp.round(v).astype(jnp.int32)
    h = H if true_hw is None else true_hw[0]
    w = W if true_hw is None else true_hw[1]
    ok = valid & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    pix = jnp.where(ok, vi * W + ui, H * W)
    return pix, ok


def splat_labels(
    pts: jax.Array,
    labels: jax.Array,
    point_valid: jax.Array,
    cam_pos, target, f, cx, cy,
    H: int, W: int,
    true_hw: jax.Array | None = None,
) -> jax.Array:
    """Project labeled points to an (H, W) uint8 label image, last-write-wins.

    ``pts (N, 3)`` float32, ``labels (N,)`` uint8/int32, ``point_valid (N,)``
    bool (padding mask).  ``true_hw`` optionally bounds the valid image
    region inside a padded (H, W) plane (see ``_pixel_index``).
    """
    N = pts.shape[0]
    u, v, _ = project_points(pts, cam_pos, target, f, cx, cy)
    pix, ok = _pixel_index(u, v, point_valid, H, W, true_hw)
    order = jnp.arange(N, dtype=jnp.int32)
    if N < (1 << 23):
        # Pack the label into the low byte of the order key: the per-pixel
        # max then carries BOTH the last-write winner and its label, so no
        # (H*W)-sized gather is needed to recover the image (that gather
        # was most of the per-candidate cost in the vmapped camera search).
        val = jnp.where(ok, order * 256 + labels.astype(jnp.int32), -1)
        win = jax.ops.segment_max(
            val, pix, num_segments=H * W + 1, indices_are_sorted=False,
        )[: H * W]
        img = jnp.where(win >= 0, win % 256, 0)
        return img.reshape(H, W).astype(jnp.uint8)
    winner = jax.ops.segment_max(
        jnp.where(ok, order, -1), pix, num_segments=H * W + 1,
        indices_are_sorted=False,
    )[: H * W]
    img = jnp.where(
        winner >= 0,
        jnp.take(labels.astype(jnp.int32), jnp.clip(winner, 0, N - 1)),
        0,
    )
    return img.reshape(H, W).astype(jnp.uint8)


def zbuffer_soa(
    xs: jax.Array,
    ys: jax.Array,
    zs: jax.Array,
    point_valid: jax.Array,
    cam_pos, target, f, cx, cy,
    H: int, W: int,
    z_valid_min: float = 1e-6,
    true_hw: jax.Array | None = None,
) -> jax.Array:
    """(H, W) float32 min-Z buffer from (N,) coordinate vectors (inf where
    nothing projects).  SoA form of :func:`zbuffer` — callers that already
    hold per-axis vectors (the deform search warps them as vectors) skip
    the (N, 3) relayout entirely."""
    from pbr3d.ops.cameramath import project_points_soa

    u, v, Z = project_points_soa(xs, ys, zs, cam_pos, target, f, cx, cy)
    pix, ok = _pixel_index(u, v, point_valid & (Z > z_valid_min), H, W, true_hw)
    INF = jnp.float32(jnp.inf)
    zb = jax.ops.segment_min(
        jnp.where(ok, Z.astype(jnp.float32), INF), pix, num_segments=H * W + 1
    )[: H * W]
    return zb.reshape(H, W)


def zbuffer(
    pts: jax.Array,
    point_valid: jax.Array,
    cam_pos, target, f, cx, cy,
    H: int, W: int,
    z_valid_min: float = 1e-6,
    true_hw: jax.Array | None = None,
) -> jax.Array:
    """(H, W) float32 min-Z buffer (inf where nothing projects)."""
    pts = pts.astype(jnp.float32)
    return zbuffer_soa(
        pts[:, 0], pts[:, 1], pts[:, 2], point_valid,
        cam_pos, target, f, cx, cy, H, W, z_valid_min, true_hw,
    )


def project_visible(
    pts: jax.Array,
    point_valid: jax.Array,
    zbuf: jax.Array,
    cam_pos, target, f, cx, cy,
    eps: float = 1e-3,
    z_valid_min: float = 1e-6,
    true_hw: jax.Array | None = None,
) -> jax.Array:
    """(H, W) bool mask of pixels where some point is within eps of the z-buffer."""
    H, W = zbuf.shape
    u, v, Z = project_points(pts, cam_pos, target, f, cx, cy)
    pix, ok = _pixel_index(u, v, point_valid & (Z > z_valid_min), H, W, true_hw)
    zb_at = jnp.take(zbuf.ravel(), jnp.clip(pix, 0, H * W - 1))
    hit = ok & (jnp.abs(Z - zb_at) < eps)
    count = jax.ops.segment_sum(
        hit.astype(jnp.int32), pix, num_segments=H * W + 1
    )[: H * W]
    return (count > 0).reshape(H, W)


def partwise_zbuffers(
    pts: jax.Array,  # (N, 3) f32/int16 — ALL occupied voxels
    labels: jax.Array,  # (N,) uint8/int32
    point_valid: jax.Array,  # (N,)
    cam_pos, target, f, cx, cy,
    part_ids: jax.Array,  # (K,) int32
    H: int, W: int,
    z_valid_min: float = 1e-6,
    true_hw: jax.Array | None = None,
) -> jax.Array:
    """(K, H, W) min-Z buffer per part in ONE segment reduction.

    Each point belongs to exactly one part (labels are exclusive), so
    offsetting the pixel index by ``part_slot * (H*W+1)`` yields disjoint
    segment ranges — one pass over N points replaces K separate z-buffer
    dispatches (per-dispatch latency and the repeated projection of the
    shared point set dominate stage 3's z-buffer maintenance).
    """
    K = part_ids.shape[0]
    u, v, Z = project_points(pts.astype(jnp.float32), cam_pos, target, f, cx, cy)
    pix, ok = _pixel_index(u, v, point_valid & (Z > z_valid_min), H, W, true_hw)
    # slot of each point's label in part_ids; K = "no part" dump row
    slot = jnp.argmax(labels[None, :] == part_ids[:, None], axis=0)
    known = jnp.any(labels[None, :] == part_ids[:, None], axis=0)
    slot = jnp.where(known, slot, K)
    seg = jnp.where(ok, slot * (H * W + 1) + pix, (K + 1) * (H * W + 1) - 1)
    INF = jnp.float32(jnp.inf)
    zb = jax.ops.segment_min(
        jnp.where(ok, Z.astype(jnp.float32), INF), seg,
        num_segments=(K + 1) * (H * W + 1),
    )
    zb = zb.reshape(K + 1, H * W + 1)[:K, : H * W]
    return zb.reshape(K, H, W)


@functools.partial(jax.jit, static_argnames=("H", "W"))
def partwise_zbuffers_grid(
    grid: jax.Array,  # (D, Hg, Wg) uint8 label grid — DEVICE-resident
    cam_vec: jax.Array,  # (9,)
    part_ids: jax.Array,  # (K,) int32
    true_hw: jax.Array,  # (2,) int32
    H: int, W: int,
) -> jax.Array:
    """(K, H, W) per-part min-Z buffers straight from a dense label grid.

    The voxel coordinates are generated on device (iota), so a grid that
    is already device-resident (e.g. the fused deformed-grid rebuild)
    yields all its parts' z-buffers with ZERO host transfer — the
    stage-3 exact-verify path previously extracted points on the host and
    re-uploaded ~30 MB per grid.
    """
    D, Hg, Wg = grid.shape
    lab = grid.reshape(-1)
    idx = jnp.arange(D * Hg * Wg, dtype=jnp.int32)
    x = (idx % Wg).astype(jnp.float32)
    y = ((idx // Wg) % Hg).astype(jnp.float32)
    z = (idx // (Wg * Hg)).astype(jnp.float32)
    pts = jnp.stack([x, y, z], axis=1)
    return partwise_zbuffers(
        pts, lab, lab > 0,
        cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
        part_ids, H, W, true_hw=true_hw,
    )


def splat_partwise_iou_mm(
    pts: jax.Array,
    labels: jax.Array,
    point_valid: jax.Array,
    cam_pos, target, f, cx, cy,
    gt_labels: jax.Array,
    part_ids: jax.Array,
    H: int, W: int,
    true_hw: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Splat + per-part IoU with the scatter replaced by one-hot coverage
    MATMULS — the matrix-unit formulation of the stage-2 objective.

    Per part p: counts_p = A_pᵀ B where A_p (N, H) one-hots the rounded row
    index of points with label p and B (N, W) one-hots the column index of
    all in-bounds points; coverage_p = counts_p > 0.  Both one-hots are
    int8 and the contraction accumulates int32 — exact counts whatever
    kernel the backend picks, no scatter, no gather.

    SEMANTICS: per-part pixel coverage is exact.  On pixels where SEVERAL
    parts collide, the winner is the last part in ``part_ids`` order,
    whereas the true splat (``splat_labels``) resolves by raster point
    order — so this is a ranking surrogate for search interiors; final
    view scores must come from the exact path (refine_cameras_batched's
    native polish does).  Contract: every valid point's label is in
    ``part_ids``.
    """
    u, v, _ = project_points(pts, cam_pos, target, f, cx, cy)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    h = H if true_hw is None else true_hw[0]
    w = W if true_hw is None else true_hw[1]
    ok = point_valid & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    cols = (ui[:, None] == jnp.arange(W, dtype=jnp.int32)[None, :]) & ok[:, None]
    Bm = cols.astype(jnp.int8)
    iota_h = jnp.arange(H, dtype=jnp.int32)[None, :]
    K = part_ids.shape[0]
    covs = []
    lab32 = labels.astype(jnp.int32)
    for k in range(K):
        rows = (vi[:, None] == iota_h) & (lab32 == part_ids[k])[:, None]
        counts = jax.lax.dot_general(
            rows.astype(jnp.int8), Bm, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        covs.append(counts > 0)
    taken = jnp.zeros((H, W), bool)
    ious = []
    winners = [None] * K
    for k in reversed(range(K)):
        winners[k] = covs[k] & ~taken
        taken = taken | covs[k]
    for k in range(K):
        g = gt_labels == part_ids[k]
        inter = jnp.sum(winners[k] & g).astype(jnp.float32)
        union = jnp.sum(winners[k] | g).astype(jnp.float32)
        ious.append(jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0))
    iou_v = jnp.stack(ious)
    return iou_v, jnp.mean(iou_v)


def partwise_iou(
    proj_labels: jax.Array,
    gt_labels: jax.Array,
    part_ids: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Color-exact per-part IoU + mean (reference: camera_estimation.py:770-788).

    Parts with empty union contribute IoU 0.0 to the mean, as in the
    reference.  Returns (per-part (K,), mean scalar).
    """
    p = proj_labels.reshape(-1)[None, :] == part_ids[:, None]  # (K, HW)
    g = gt_labels.reshape(-1)[None, :] == part_ids[:, None]
    inter = jnp.sum(p & g, axis=1).astype(jnp.float32)
    union = jnp.sum(p | g, axis=1).astype(jnp.float32)
    iou = jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0)
    return iou, jnp.mean(iou)


def binary_iou(a: jax.Array, b: jax.Array) -> jax.Array:
    """IoU of two boolean masks; NaN when the union is empty
    (reference: eval_helpers_intra.py:268-271)."""
    inter = jnp.sum(a & b).astype(jnp.float32)
    union = jnp.sum(a | b).astype(jnp.float32)
    return jnp.where(union > 0, inter / jnp.maximum(union, 1.0), jnp.nan)
