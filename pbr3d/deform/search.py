"""IoU-driven search over the 4-DoF part deformation.

Replaces the reference's interactive slider viewer
(``launch_deform_viewer_fixed_camera``, utils/deformation_estimation.py:15-356)
with an automated optimizer whose objective is the notebook-4 acceptance
metric itself: the *visibility-aware* binary IoU of the deformed part under
the fixed stage-2 camera (utils/eval_helpers_intra.py:168-190,560-748) — a
pixel counts iff the part's nearest point survives the z-test against the
rest of the building.  The reference's live viewer shows exactly this
occlusion to the human; optimizing the unoccluded splat IoU instead can
"improve" a part by hiding it behind the building.

Device shape: a whole *population* of candidate deforms is evaluated in
one vmapped program (warp -> z-buffer -> visible IoU per candidate), chunked
to bound memory; coarse grid search over the slider ranges, then a local
refinement.  Parts are optimized sequentially conditioned on the current
z-buffer of all *other* parts (each part's z-buffer is one segment_min
image, recomputed only when its deform changes).

Point sets are optionally strided during search exactly like the reference's
``project_fast`` (:34-38), with the final IoU computed on the full set.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.camera.geometry import params_to_vector
from pbr3d.carving.voxel import (
    bucket_size,
    points_by_parts,
    surface_points_by_parts,
)
from pbr3d.deform.warp import deform_coords, deform_coords_soa
from pbr3d.ops.projection import (
    partwise_iou,
    partwise_zbuffers,
    splat_labels,
    zbuffer,
    zbuffer_soa,
)

IDENTITY_DEFORM = np.array([1.0, 0.0, 1.0, 0.0], np.float32)  # sy, dy, sxz, dxz

#: Parts pinned to the identity deform by default.  The notebook-4 "minarets"
#: row projects the INIT grid's minaret points into the DEFORMED grid's
#: z-buffer (utils/eval_helpers_intra.py:631-648): any deform that moves the
#: minarets' z-surface makes the init points fail the |z - zbuf| < eps test
#: and the row collapses.  The reference goldens keep minarets at identity
#: (results/3.*: minarets rows 0.846->0.846, 0.837->0.837).
PIN_IDENTITY_PARTS = ("front_minarets", "back_minarets")

#: Visibility epsilon of the intra-method eval (eval_helpers_intra.py:168).
VIS_EPS = 1e-3


@functools.partial(jax.jit, static_argnames=("H", "W"))
def _batch_deform_iou(
    deforms: jax.Array,  # (P, 4)
    coords: jax.Array,  # (N, 3) f32
    valid: jax.Array,  # (N,)
    cam_vec: jax.Array,  # (9,)
    gt_labels: jax.Array,  # (H, W) — PADDED plane
    part_id: jax.Array,  # scalar int32 (traced: one compile serves all parts)
    true_hw: jax.Array,  # (2,) int32 — the real image extent inside the plane
    voxel_shape: jax.Array,  # (3,) int32 (D, H, W) — traced: serves all scenes
    H: int,
    W: int,
) -> jax.Array:
    """Unoccluded color-exact splat IoU per candidate (the reference viewer's
    on-screen number, camera_estimation.py:770-788).  Kept for diagnostics;
    the search optimizes ``_batch_deform_visible_iou``."""
    ids = part_id.reshape(1).astype(jnp.int32)

    def one(d):
        c, v = deform_coords(coords, valid, true_hw, voxel_shape, d)
        img = splat_labels(
            c.astype(jnp.float32),
            jnp.full((c.shape[0],), 1, jnp.uint8) * part_id.astype(jnp.uint8),
            v,
            cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
            H, W, true_hw,
        )
        return partwise_iou(img, gt_labels, ids)[0][0]

    return jax.vmap(one)(deforms)


@functools.partial(jax.jit, static_argnames=("H", "W", "approx"))
def _batch_deform_visible_iou(
    deforms: jax.Array,  # (P, 4)
    coords: jax.Array,  # (N, 3) f32
    valid: jax.Array,  # (N,)
    cam_vec: jax.Array,  # (9,)
    gt_part: jax.Array,  # (H, W) bool — PADDED plane, mask == part id
    rest_zbuf: jax.Array,  # (H, W) f32 — min-Z of all OTHER parts (inf empty)
    true_hw: jax.Array,  # (2,) int32
    voxel_shape: jax.Array,  # (3,) int32 (D, H, W)
    center: jax.Array,  # (3,) f32 — FULL part centroid (coords may be a shell)
    H: int,
    W: int,
    approx: bool = False,
) -> jax.Array:
    """Visibility-aware binary IoU per candidate — the notebook-4 metric.

    The eval marks a pixel visible iff some part point has
    |Z - zbuf| < eps with zbuf = min over the WHOLE grid
    (eval_helpers_intra.py:134-190).  With zbuf = min(rest, part_min) that
    reduces to ``part_min < rest + eps`` (the part's own min-Z point always
    passes against itself), so one segment_min per candidate suffices.
    """

    def one(d):
        xs, ys, zs, v = deform_coords_soa(
            coords, valid, true_hw, voxel_shape, d, center, approx=approx
        )
        zb = zbuffer_soa(
            xs, ys, zs, v,
            cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
            H, W, true_hw=true_hw,
        )
        visible = zb < rest_zbuf + VIS_EPS
        inter = jnp.sum(visible & gt_part).astype(jnp.float32)
        union = jnp.sum(visible | gt_part).astype(jnp.float32)
        return jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0)

    return jax.vmap(one)(deforms)


#: Hinge-penalty weight on regressing another part's visible IoU below its
#: all-identity baseline.  >1 so that stealing a neighbor's pixels is never
#: a net win for the search objective.
NEIGHBOR_PENALTY = 3.0


@functools.partial(jax.jit, static_argnames=("H", "W", "approx"))
def _batch_deform_visible_iou_penalized(
    deforms: jax.Array,  # (P, 4)
    coords: jax.Array,  # (N, 3) f32/int16
    valid: jax.Array,  # (N,)
    cam_vec: jax.Array,  # (9,)
    gt_part: jax.Array,  # (H, W) bool
    rest_zbuf: jax.Array,  # (H, W) f32 — min-Z of all OTHER parts
    true_hw: jax.Array,  # (2,) int32
    voxel_shape: jax.Array,  # (3,) int32
    center: jax.Array,  # (3,) f32
    nb_zb: jax.Array,  # (Q, H/2, W/2) f32 — neighbors' own z-buffers, min-pooled
    nb_base: jax.Array,  # (Q, H/2, W/2) bool — neighbor visible vs rest-
    #                      excluding-{self, this part} (candidate-independent)
    nb_gt: jax.Array,  # (Q, H/2, W/2) bool — neighbor GT planes, max-pooled
    nb_floor: jax.Array,  # (Q,) f32 — neighbor init-state IoU floors (half-res)
    nb_valid: jax.Array,  # (Q,) bool — padding mask over the neighbor axis
    H: int,
    W: int,
    approx: bool = False,
) -> jax.Array:
    """Ensemble search objective COMPONENTS per candidate: (own IoU,
    Σ neighbor visible IoUs under the candidate's occlusion, Σ hinge drops
    below the neighbors' all-identity floors) — shape (P, 3).  The caller
    combines them as ``own + gain_w·gain − NEIGHBOR_PENALTY·drop`` on host,
    so ONE device evaluation scores a candidate batch under every gain
    weight at once (the greedy/ensemble portfolio variants share pass-0
    evaluations this way).

    Rationale: the nb4 table (eval_helpers_intra.py:560-748) z-tests every
    part against the WHOLE deformed grid, so a deform that grows part A in
    front of part B "wins" A's cell while silently collapsing B's — exactly
    the Itimad dome-over-main_door failure.  The human operator judged the
    whole overlay; this objective encodes that judgment.  Summing the
    neighbors' cells (``nb_gain_w=1``, not just hinging on their floors)
    makes the per-part sweep a coordinate ASCENT on the table total: a part
    may no longer grab +0.01 on its own cell at a -0.1 cost to a neighbor
    sitting above its floor (the round-3 Taj full_building failure, where
    the floor-only hinge was inactive and windows/chhatris paid).  The gain
    term is only truthful [gain weight 0 = hinge only on the first greedy
    pass, 1 on the conditioning resweeps] when the neighbors sit near their FINAL
    positions — during the first greedy pass later parts are still at
    identity, and charging a candidate for occluding a neighbor's *current*
    pixels wrongly protects positions the neighbor is about to leave while
    ignoring the GT region it needs to grow into (measured at golden res:
    an ensemble-scored first pass leaves Taj windows at 0.37 vs 0.64 — the
    big parts refuse to clear its growth region).  The
    hinge applies either way: dropping a neighbor below its identity floor
    would get the offender REVERTED by the exact nb4 verify, so those
    trades are charged extra.

    Neighbor q's visible mask under candidate z-buffer zc is
    ``zb_q < min(rest_{q,p}, zc) + eps``; with ``base_q`` precomputed as
    ``zb_q < rest_{q,p} + eps`` that is ``base_q & (zb_q < zc + eps)`` — two
    masked sums per neighbor per candidate, no point work.
    """

    def one(d):
        xs, ys, zs, v = deform_coords_soa(
            coords, valid, true_hw, voxel_shape, d, center, approx=approx
        )
        zc = zbuffer_soa(
            xs, ys, zs, v,
            cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
            H, W, true_hw=true_hw,
        )
        visible = zc < rest_zbuf + VIS_EPS
        inter = jnp.sum(visible & gt_part).astype(jnp.float32)
        union = jnp.sum(visible | gt_part).astype(jnp.float32)
        own = jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0)

        # Neighbor accounting at HALF resolution (the hinge is a guard; its
        # floors are computed at the same resolution, so it is self-
        # consistent and 4x cheaper than full-res planes).
        zc2 = zc.reshape(H // 2, 2, W // 2, 2).min(axis=(1, 3))
        pass_z = nb_zb < zc2[None] + VIS_EPS  # (Q, H/2, W/2)
        vis_q = nb_base & pass_z
        inter_q = jnp.sum(vis_q & nb_gt, axis=(1, 2)).astype(jnp.float32)
        union_q = jnp.sum(vis_q | nb_gt, axis=(1, 2)).astype(jnp.float32)
        iou_q = jnp.where(union_q > 0, inter_q / jnp.maximum(union_q, 1.0), 0.0)
        gain = jnp.where(nb_valid, iou_q, 0.0)
        drop = jnp.where(nb_valid, jnp.maximum(nb_floor - iou_q, 0.0), 0.0)
        return jnp.stack([own, jnp.sum(gain), jnp.sum(drop)])

    return jax.vmap(one)(deforms)


@functools.partial(jax.jit, static_argnames=("H", "W"))
def deformed_zbuffer(
    deform: jax.Array,  # (4,)
    coords: jax.Array,  # (N, 3) f32
    valid: jax.Array,
    cam_vec: jax.Array,
    true_hw: jax.Array,
    voxel_shape: jax.Array,
    center: jax.Array,  # (3,) f32 — FULL part centroid
    H: int,
    W: int,
) -> jax.Array:
    """(H, W) min-Z buffer of one part at one deform (inf where empty)."""
    xs, ys, zs, v = deform_coords_soa(
        coords, valid, true_hw, voxel_shape, deform, center,
    )
    return zbuffer_soa(
        xs, ys, zs, v,
        cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
        H, W, true_hw=true_hw,
    )


#: Fixed part-slot count for the one-dispatch per-part z-buffer program
#: (one executable for every monument; unused slots carry id 255).
_ZB_SLOTS = 10


@functools.partial(jax.jit, static_argnames=("H", "W"))
def _partwise_zbufs(pts, labels, valid, cam_vec, part_ids, true_hw, H, W):
    """(K=_ZB_SLOTS, H, W) min-Z per part from ONE segment reduction over
    the whole grid's point set (pbr3d.ops.projection.partwise_zbuffers)."""
    return partwise_zbuffers(
        pts, labels, valid,
        cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
        part_ids, H, W, true_hw=true_hw,
    )


def all_part_zbuffers(
    pts: np.ndarray,  # (N, 3) int16/f32 — ALL occupied voxels, padded ok
    labels: np.ndarray,  # (N,)
    valid: np.ndarray,  # (N,)
    cam_vec,
    parts,  # part names (<= _ZB_SLOTS)
    true_hw,
    Hp: int,
    Wp: int,
) -> Dict[str, np.ndarray]:
    """part -> (Hp, Wp) min-Z image, all parts in one device dispatch."""
    ids = np.full((_ZB_SLOTS,), 255, np.int32)
    for i, p in enumerate(parts):
        ids[i] = config.PART_IDS[p]
    zbs = np.asarray(_partwise_zbufs(
        jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(valid),
        jnp.asarray(cam_vec), jnp.asarray(ids), jnp.asarray(true_hw), Hp, Wp,
    ))
    return {p: zbs[i] for i, p in enumerate(parts)}


#: Max candidate-points resident per vmapped eval (bounds device memory:
#: each candidate materializes 7x its padded point set plus projections,
#: ~40 B/point -> ~2.7 GB at this budget).  Large batches amortize the
#: per-dispatch cost.
_POINT_BUDGET = 1 << 26


def _auto_chunk(cost_units: int, chunk_cap: int) -> int:
    """Chunk size given per-candidate cost in point-equivalents."""
    c = max(1, _POINT_BUDGET // max(1, cost_units))
    c = 1 << (c.bit_length() - 1)  # floor pow2 -> few distinct compiled shapes
    return int(min(c, chunk_cap))


#: Largest single-dispatch candidate batch.  A blocking dispatch costs a
#: fixed latency on top of the per-point-candidate work, so a 100-candidate
#: stage is cheaper as ONE padded 128-dispatch than as two blocking
#: 64-dispatches.  4x the legacy per-dispatch cap; the memory budget above
#: still bounds resident point work.
_CHUNK_MAX_MULT = 4


def _eval_chunked(deforms: np.ndarray, chunk_cap: int, fn=None, approx=False,
                  **kw) -> np.ndarray:
    """Evaluate P candidates, preferring ONE pow2-padded dispatch.

    Shapes are padded to powers of two (>= 8) so the distinct compiled
    executables stay few; tiny stages (the exact top-k re-eval is ~8
    candidates) get a matching small dispatch instead of padding up to the
    search-stage chunk — at 7x point cost per exact candidate the old
    64-padding was pure waste per part.  When P exceeds the
    memory-bounded chunk, ALL chunks are enqueued before the first blocking
    read so the device queue never drains between them."""
    P = deforms.shape[0]
    n = kw["coords"].shape[0]
    cost = n if approx else 7 * n
    if fn is None:
        fn = _batch_deform_visible_iou
    else:
        # penalized objective: neighbor planes add ~(Q * H/2 * W/2) bool work
        nbq = kw["nb_zb"]
        cost += (nbq.shape[0] * nbq.shape[1] * nbq.shape[2]) // 4
    kw["approx"] = approx
    cap = _auto_chunk(cost, _CHUNK_MAX_MULT * chunk_cap)
    chunk = max(8, 1 << (P - 1).bit_length())  # pow2 >= P
    chunk = min(chunk, cap)
    pad = (-P) % chunk
    d = np.concatenate([deforms, np.tile(IDENTITY_DEFORM, (pad, 1))]) if pad else deforms
    outs = [fn(jnp.asarray(d[i : i + chunk]), **kw)
            for i in range(0, len(d), chunk)]
    return np.concatenate([np.asarray(o) for o in outs])[:P]


def _pad_plane_hw(H: int, W: int) -> Tuple[int, int]:
    return (-(-H // 128) * 128, -(-W // 128) * 128)


def _shell_bucket(m: int) -> int:
    """Search-shell pad size: pow2 OR 1.5x-pow2 (3*2^k).

    The capped coarse shell (24576 points) padded to the next pow2 bucket
    (32768) made every coarse/joint candidate pay 33% padding compute;
    allowing the half-step bucket fits it exactly.  Costs at most one extra
    executable per size class (the candidate evals are compiled per point
    bucket)."""
    b = bucket_size(m)
    return 3 * b // 4 if m <= 3 * b // 4 and 3 * b // 4 >= 1024 else b


def pad_points_i16(pts: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket-pad integer voxel coordinates as int16 (they fit: grids are
    <=512 per axis).  A 5M-point solid pads to an 8M bucket = 100 MB of
    host->device transfer as float32; int16 halves it.  ``deform_coords``
    casts on device.
    """
    m = pts.shape[0]
    if m > n:
        raise ValueError(f"{m} points exceed pad size {n}")
    out_p = np.zeros((n, 3), np.int16)
    out_v = np.zeros((n,), bool)
    out_p[:m] = pts
    out_v[:m] = True
    return out_p, out_v


def optimize_part_deform(
    grid_labels: np.ndarray,
    part: str,
    mask_labels: np.ndarray,
    cam: Dict,
    *,
    rest_zbuf: Optional[np.ndarray] = None,
    search_stride: int = 8,
    surface_stride: int = 2,
    scale_range: Tuple[float, float, int] = (0.5, 2.0, 11),
    shift_range: Tuple[float, float, int] = (-100.0, 100.0, 9),
    refine_steps: int = 3,
    chunk: int = 64,
    mode: str = "separable",
    joint_steps: int = 5,
    exact_topk: int = 12,
    coarse_cap: int = 24576,
    fine_cap: int = 65536,
    _points=None,
    _surface_points=None,
    _device_full=None,
    _zb_identity=None,
    _nb=None,
    _gain_w: float = 0.0,
    _dual_gain_w: Optional[float] = None,
    _dual_out: Optional[Dict] = None,
    _incumbent: Optional[np.ndarray] = None,
    _zb_incumbent: Optional[np.ndarray] = None,
    _window: Optional[Tuple[float, int]] = None,
    _seed_cands: Optional[np.ndarray] = None,
    _return_zb: bool = False,
    _table=None,
    _batcher=None,
) -> Tuple[np.ndarray, float]:
    """Best (scale_y, shift_y, scale_xz, shift_xz) for one part + its IoU.

    The objective is the notebook-4 visibility-aware binary IoU of the part
    (mask == part id vs z-visible deformed points), plus (when ``_nb`` is
    given) ``_gain_w``·(neighbor visible-IoU sum) minus the hinge penalty
    for pushing neighbor parts below their all-identity IoU floors (see
    ``_batch_deform_visible_iou_penalized``).
    ``rest_zbuf`` is the (H, W) min-Z buffer of every OTHER part (defaults
    to no occluders).

    ``_dual_gain_w`` — when set, every evaluation ALSO ranks candidates
    under that gain weight (free: the device returns score components) and
    ``_dual_out["diverged"]`` is set True the first time the two objectives
    would pick different stage winners / top-k sets / accept decisions.
    While they never diverge, a search chain run at ``_dual_gain_w`` is
    PROVABLY identical to this one (the stage machine is deterministic), so
    the caller can skip it (the greedy/ensemble portfolio dedup).

    ``_incumbent``/``_zb_incumbent`` — the part's current accepted deform
    and its full-set z-buffer: when the search lands back on the incumbent,
    the final full-set dispatch is skipped (resweeps mostly keep deforms).

    ``_window=(span, n)`` — resweep mode: replace the global coarse A/B +
    joint stages with two separable n×n offset grids spanning ±span coarse
    steps around the incumbent (plus the identity and incumbent rows), then
    the usual refine rounds.  The global slider-space sweep is pass-0 work;
    conditioning resweeps only need the local neighborhood + the identity
    revert option.

    The default ranges cover the reference's full slider space (scale
    0.5–2.0, shift ±100; deformation_estimation.py:21-25 — the human
    goldens use scale_y up to ~1.4, outside the old ±20% window).

    Search schedule (coarse→exact, all candidates vmapped on device):

    1. separable coarse pass over (scale_y, shift_y) then (scale_xz,
       shift_xz), on the part's surface shell strided 2x wider than
       ``surface_stride`` with the APPROX warp (no 7-jitter, float coords)
       — ~28x less point work per candidate than the exact path;
    2. local refinement round at ±half a coarse step, shell at
       ``surface_stride``, approx warp;
    3. exact refinement round at ±a sixth of a coarse step, shell at
       ``surface_stride``, full 7-jitter + integer rounding;
    4. full-set acceptance: the winner is re-scored on the COMPLETE point
       set with the exact warp and kept only if it beats identity on the
       penalized objective.

    ``mode="full"`` replaces step 1 with the full 4-D cross product.
    """
    pid = config.PART_IDS[part]
    if _table is not None:
        n_pts = _table.count(pid)
    else:
        pts = (_points if _points is not None
               else points_by_parts(grid_labels, [part])[0])
        n_pts = len(pts)
    if n_pts == 0:
        out = (IDENTITY_DEFORM.copy(), 0.0)
        return (out + (None,)) if _return_zb else out
    voxel_shape = np.asarray(grid_labels).shape[:3]
    H, W = mask_labels.shape[:2]
    # pad the image plane to a shared bucket so every scene size reuses the
    # same compiled program; the true extent is a traced argument
    Hp, Wp = _pad_plane_hw(H, W)
    gt_p = np.zeros((Hp, Wp), bool)
    gt_p[:H, :W] = np.asarray(mask_labels) == pid
    if rest_zbuf is None:
        rest = np.full((Hp, Wp), np.inf, np.float32)
    else:
        rest = np.full((Hp, Wp), np.inf, np.float32)
        rest[: rest_zbuf.shape[0], : rest_zbuf.shape[1]] = rest_zbuf

    if _table is not None:
        # Device path: shell windows are extracted ON DEVICE from the point
        # table (one cumsum-rank pass each) — zero host point work.
        n_shell = max(_table.shell_count(pid), 1)
        s_f = max(surface_stride, -(-n_shell // fine_cap))
        s_c = max(2 * surface_stride, -(-n_shell // coarse_cap))
        p_s, v_s = _table.shell_window(
            pid, s_f, _shell_bucket(-(-n_shell // s_f)))
        p_sc, v_sc = _table.shell_window(
            pid, s_c, _shell_bucket(-(-n_shell // s_c)))
        center = jnp.asarray(np.asarray(_table.center(pid), np.float32))
        p_f, v_f = _device_full if _device_full is not None else (
            _table.part_window(pid, 1, bucket_size(n_pts)))
    else:
        shell = _surface_points
        if shell is None:
            shell = surface_points_by_parts(grid_labels, [part])[0]
        if len(shell):
            # Adaptive stride: huge parts (Akbar full_building's shell is
            # ~236k points at 256 scale) get strided harder so the candidate
            # cost per search round stays bounded; the winner is still
            # accepted on the FULL point set and the exact nb4 verify guards
            # the final grid.
            s_f = max(surface_stride, -(-len(shell) // fine_cap))
            s_c = max(2 * surface_stride, -(-len(shell) // coarse_cap))
            sub_fine = shell[::s_f]
            sub_coarse = shell[::s_c]
        else:  # degenerate: every voxel interior-labeled (impossible for >0 pts)
            sub_fine = pts[::search_stride]
            sub_coarse = pts[:: 2 * search_stride]
        center = jnp.asarray(np.asarray(pts.mean(axis=0), np.float32))  # FULL-set centroid
        p_sc, v_sc = pad_points_i16(sub_coarse, _shell_bucket(len(sub_coarse)))
        p_s, v_s = pad_points_i16(sub_fine, _shell_bucket(len(sub_fine)))
        if _device_full is not None:
            p_f, v_f = _device_full  # device-resident: skip the big re-upload
        else:
            p_f, v_f = pad_points_i16(pts, bucket_size(len(pts)))
    gt = jnp.asarray(gt_p)
    rest_j = jnp.asarray(rest)
    cam_vec = jnp.asarray(params_to_vector(cam))
    true_hw = jnp.asarray(np.asarray([H, W], np.int32))
    vs = jnp.asarray(np.asarray(voxel_shape, np.int32))

    if _nb is not None:
        nb_kw = dict(
            fn=_batch_deform_visible_iou_penalized,
            nb_zb=jnp.asarray(_nb["zb"]), nb_base=jnp.asarray(_nb["base"]),
            nb_gt=jnp.asarray(_nb["gt"]), nb_floor=jnp.asarray(_nb["floor"]),
            nb_valid=jnp.asarray(_nb["valid"]),
        )
    else:
        nb_kw = {}

    from pbr3d.utils.profiling import prof

    if _batcher is not None:
        from pbr3d.deform.batched import eval_candidates_batched

        kind = "pen" if _nb is not None else "plain"
        nb_dev = (tuple(nb_kw[k] for k in
                        ("nb_zb", "nb_base", "nb_gt", "nb_floor", "nb_valid"))
                  if _nb is not None else None)

        def ev(deforms, pp, vv, approx):
            common = (jnp.asarray(pp), jnp.asarray(vv), cam_vec, gt, rest_j,
                      true_hw, vs, center)
            return eval_candidates_batched(
                _batcher, np.asarray(deforms, np.float32), chunk, kind,
                approx, common, nb_dev, Hp, Wp,
            )
    else:
        def ev(deforms, pp, vv, approx):
            # (P,) own IoU without _nb; (P, 3) score components with it
            return _eval_chunked(
                np.asarray(deforms, np.float32), chunk, approx=approx,
                coords=jnp.asarray(pp), valid=jnp.asarray(vv), cam_vec=cam_vec,
                gt_part=gt, rest_zbuf=rest_j, true_hw=true_hw,
                voxel_shape=vs, center=center, H=Hp, W=Wp, **nb_kw,
            )

    gw = float(_gain_w)
    dual = (_dual_gain_w is not None and _nb is not None
            and float(_dual_gain_w) != gw)
    diverged = False

    def sc(vals, w):
        """Combine device score components under gain weight ``w``."""
        if vals.ndim == 1:
            return vals
        return vals[:, 0] + w * vals[:, 1] - NEIGHBOR_PENALTY * vals[:, 2]

    def pick(cands, vals):
        nonlocal diverged
        bp = cands[int(np.argmax(sc(vals, gw)))]
        if dual and not diverged:
            be = cands[int(np.argmax(sc(vals, float(_dual_gain_w))))]
            if not np.array_equal(bp, be):
                diverged = True
        return bp

    def _lattice(rng):
        """linspace of one (lo, hi, n) triple, or the sorted UNION of a
        list of triples.  Two different densities over the same span have
        non-nested lattices (linspace(.5,2,11) and (.5,2,16) share only the
        endpoints), so a denser grid can LOSE basins the coarser one found
        — the golden profile unions both (measured: the 16x13-only grid
        dropped Itimad windows 0.923 -> 0.857 while the 11x9 grid held it).
        The step (for the joint/refine windows) follows the FINEST triple."""
        if isinstance(rng[0], (tuple, list)):
            vals = np.unique(np.concatenate(
                [np.linspace(a, b, n) for a, b, n in rng]).round(9))
            step = min((b - a) / max(n - 1, 1) for a, b, n in rng)
            return vals, step
        a, b, n = rng
        return np.linspace(a, b, n), (b - a) / max(n - 1, 1)

    scales, scale_step = _lattice(scale_range)
    shifts, shift_step = _lattice(shift_range)

    seeds = None
    if _seed_cands is not None:
        seeds = np.asarray(_seed_cands, np.float32).reshape(-1, 4)
        if not len(seeds):
            seeds = None

    def with_seeds(c):
        return c if seeds is None else np.concatenate([c, seeds])

    seed_anchor = None
    if _window is not None:
        # Resweep mode: local separable offset grids around the incumbent.
        span, nw = _window
        base0 = (np.asarray(_incumbent, np.float32).copy()
                 if _incumbent is not None else IDENTITY_DEFORM.copy())
        rs_ = np.linspace(-span * scale_step, span * scale_step, nw)
        rd_ = np.linspace(-span * shift_step, span * shift_step, nw)
        ca = np.array(
            [base0 + np.array([a, b, 0.0, 0.0], np.float32)
             for a, b in itertools.product(rs_, rd_)], np.float32)
        ca = with_seeds(np.concatenate([IDENTITY_DEFORM[None], base0[None], ca]))
        with prof(f"opd.{part}.windowA", sync=False):
            best = pick(ca, ev(ca, p_sc, v_sc, True))
        cb = np.array(
            [best + np.array([0.0, 0.0, a, b], np.float32)
             for a, b in itertools.product(rs_, rd_)], np.float32)
        cb = with_seeds(np.concatenate([IDENTITY_DEFORM[None], best[None], cb]))
        with prof(f"opd.{part}.windowB", sync=False):
            best = pick(cb, ev(cb, p_sc, v_sc, True))
    elif mode == "full":  # pragma: no cover - diagnostic mode
        coarse = np.array(
            [(sy, dy, sxz, dxz) for sy, sxz, dy, dxz in
             itertools.product(scales, scales, shifts, shifts)],
            np.float32,
        )
        # Always include identity so we can never regress below it.
        coarse = with_seeds(np.concatenate([IDENTITY_DEFORM[None], coarse]))
        best = pick(coarse, ev(coarse, p_sc, v_sc, True))
    else:
        # stage A: (scale_y, shift_y) with xz identity
        ca = np.array(
            [(sy, dy, 1.0, 0.0) for sy, dy in itertools.product(scales, shifts)],
            np.float32,
        )
        ca = with_seeds(np.concatenate([IDENTITY_DEFORM[None], ca]))
        with prof(f"opd.{part}.coarseA", sync=False):
            best = pick(ca, ev(ca, p_sc, v_sc, True))
        # stage B: (scale_xz, shift_xz) given the best y
        cb = np.array(
            [(best[0], best[1], sxz, dxz)
             for sxz, dxz in itertools.product(scales, shifts)],
            np.float32,
        )
        cb = with_seeds(np.concatenate([best[None], cb]))
        with prof(f"opd.{part}.coarseB", sync=False):
            vb = ev(cb, p_sc, v_sc, True)
        best = pick(cb, vb)
        if seeds is not None:
            # best SEED by the same objective (dual-checked pick): anchors
            # an extra local grid in the joint pass below.  A good seed can
            # sit a full coarse step from its basin floor (e.g. the rigid-
            # consistency seed when the part needs EXTRA growth on top of
            # its neighbor's) — too far for the +-step/2 refine rounds, so
            # without the anchored grid it loses every pick and dies.
            bs = pick(cb[-len(seeds):], vb[-len(seeds):])
            if not np.array_equal(bs, best):
                seed_anchor = bs

    if _window is None and mode != "full" and joint_steps:
        # Joint 4-D pass around the separable winner: the two separable
        # sweeps can miss jointly-coupled optima (measured at golden
        # res: Taj chhatris separable 0.700 vs the full 4-D grid 0.729 —
        # the winner needs scale_y and scale_xz to move TOGETHER).
        # ``joint_steps`` scale values spanning +-1.5 coarse steps,
        # scales only (shifts stay at the separable winner): the
        # measured coupling is between scale_y and scale_xz (Taj
        # chhatris), and the +-step/2 refine window that follows
        # re-opens both shifts anyway.  The old 3x3 shift block
        # multiplied the joint batch 9x for no observed table gain —
        # the 226-candidate joint pass was the single largest
        # coarse-stage cost.
        js = np.linspace(-1.5 * scale_step, 1.5 * scale_step, joint_steps)
        joffs = np.array(
            [(a, 0.0, c, 0.0) for a, c in itertools.product(js, js)],
            np.float32,
        )
        anchors = [best] + ([seed_anchor] if seed_anchor is not None else [])
        joint = np.concatenate(
            [np.concatenate([a[None].astype(np.float32),
                             a[None].astype(np.float32) + joffs])
             for a in anchors])
        joint = with_seeds(joint)
        with prof(f"opd.{part}.joint", sync=False):
            best = pick(joint, ev(joint, p_sc, v_sc, True))

    # local refinement rounds around the coarse optimum: approx at +-step/2,
    # then exact (7-jitter + rounding) at +-step/6
    for span_s, span_d, approx in (
        (scale_step / 2, shift_step / 2, True),
        (scale_step / 6, shift_step / 6, False),
    ):
        rs = np.linspace(-span_s, span_s, refine_steps)
        rd = np.linspace(-span_d, span_d, refine_steps)
        fine = np.array(
            [best + np.array([a, b, c, d], np.float32)
             for a, c, b, d in itertools.product(rs, rs, rd, rd)],
            np.float32,
        )
        fine = with_seeds(np.concatenate([best[None], fine]))
        with prof(f"opd.{part}.refine_approx{int(approx)}", sync=False):
            if not approx and len(fine) > exact_topk > 0:
                # The 7-jitter exact eval costs 7x the approx warp and was
                # the dominant per-part search cost.
                # Pre-rank the window with the approx objective and
                # exact-evaluate only the leaders + the incumbent: at this
                # +-step/6 span the approx-vs-exact gap is pixel-rounding
                # noise, far smaller than the top-k margin, and the
                # full-set exact acceptance below still guards the result.
                pre = ev(fine, p_s, v_s, True)
                kp_ = np.argsort(sc(pre, gw))[-exact_topk:]
                if dual and not diverged:
                    ke_ = np.argsort(sc(pre, float(_dual_gain_w)))[-exact_topk:]
                    if set(kp_.tolist()) != set(ke_.tolist()):
                        # the two objectives would PRUNE differently: the
                        # shadow chain is no longer provably identical
                        diverged = True
                keep = np.unique(np.concatenate([[0], kp_]))
                fine = fine[keep]
            best = pick(fine, ev(fine, p_s, v_s, approx))

    # full-set comparison: accept the searched deform only if it beats
    # identity on the full point set too (strided search can overfit), on
    # the SAME penalized objective the search optimized.
    if _zb_identity is not None:
        zb_id = _zb_identity  # already maintained by refine_parts
    else:
        zb_id = np.asarray(deformed_zbuffer(
            jnp.asarray(IDENTITY_DEFORM), jnp.asarray(p_f), jnp.asarray(v_f),
            cam_vec, true_hw, vs, center, Hp, Wp,
        ))
    iou_id = _visible_iou_from_zb(zb_id, rest, gt_p)

    def _finish(out2, zb):
        if _dual_out is not None and diverged:
            _dual_out["diverged"] = True
        return (out2 + (zb,)) if _return_zb else out2

    if np.array_equal(best, IDENTITY_DEFORM):
        # search kept identity: the full-set dispatch would just recompute
        # the identity z-buffer we already hold
        return _finish((IDENTITY_DEFORM.copy(), float(iou_id)), None)
    if (_zb_incumbent is not None and _incumbent is not None
            and np.array_equal(best, np.asarray(_incumbent, np.float32))):
        # resweep landed back on the incumbent: its full-set z-buffer is
        # already maintained by the caller — skip the accept dispatch (the
        # incumbent passed the identity-acceptance when first accepted)
        iou_inc = _visible_iou_from_zb(_zb_incumbent, rest, gt_p)
        return _finish((np.asarray(best, np.float32), float(iou_inc)),
                       _zb_incumbent)
    with prof(f"opd.{part}.accept_zb", sync=False):
        if _batcher is not None:
            from pbr3d.deform.batched import zbuffer_batched

            zb_best = zbuffer_batched(
                _batcher, best, jnp.asarray(p_f), jnp.asarray(v_f), cam_vec,
                true_hw, vs, center, Hp, Wp,
            )
        else:
            zb_best = np.asarray(deformed_zbuffer(
                jnp.asarray(best), jnp.asarray(p_f), jnp.asarray(v_f), cam_vec,
                true_hw, vs, center, Hp, Wp,
            ))
    iou_best = _visible_iou_from_zb(zb_best, rest, gt_p)
    score_best, score_id = iou_best, iou_id
    if _nb is not None:
        g_b, d_b = _nb_components(_nb, zb_best)
        g_i, d_i = _nb_components(_nb, zb_id)
        score_best = iou_best + gw * g_b - NEIGHBOR_PENALTY * d_b
        score_id = iou_id + gw * g_i - NEIGHBOR_PENALTY * d_i
        if dual and not diverged:
            w2 = float(_dual_gain_w)
            acc_e = ((iou_best + w2 * g_b - NEIGHBOR_PENALTY * d_b)
                     > (iou_id + w2 * g_i - NEIGHBOR_PENALTY * d_i))
            if acc_e != (score_best > score_id):
                diverged = True
    if score_best <= score_id:
        return _finish((IDENTITY_DEFORM.copy(), float(iou_id)), None)
    return _finish((np.asarray(best, np.float32), float(iou_best)), zb_best)


def _min_pool2(z: np.ndarray) -> np.ndarray:
    H, W = z.shape
    return z.reshape(H // 2, 2, W // 2, 2).min(axis=(1, 3))


def _max_pool2(z: np.ndarray) -> np.ndarray:
    H, W = z.shape
    return z.reshape(H // 2, 2, W // 2, 2).max(axis=(1, 3))


def _nb_components(nb: Dict, zb_part: np.ndarray) -> Tuple[float, float]:
    """Host-side mirror of the jitted ensemble neighbor terms: (gain, drop)
    = (sum of the neighbors' half-res visible IoUs, sum of their hinge drops
    below the identity floors).  Callers combine with their gain weight:
    ``own + gain_w*gain - NEIGHBOR_PENALTY*drop`` reproduces the search
    score."""
    zc2 = _min_pool2(np.asarray(zb_part))
    vis = nb["base"] & (nb["zb"] < zc2[None] + VIS_EPS)
    inter = np.sum(vis & nb["gt"], axis=(1, 2)).astype(np.float64)
    union = np.sum(vis | nb["gt"], axis=(1, 2)).astype(np.float64)
    iou = np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)
    gain = np.where(nb["valid"], iou, 0.0)
    drop = np.where(nb["valid"], np.maximum(nb["floor"] - iou, 0.0), 0.0)
    return float(gain.sum()), float(drop.sum())


def _nb_score(nb: Dict, zb_part: np.ndarray, gain_w: float = 1.0) -> float:
    """Combined neighbor score at ``gain_w`` (see ``_nb_components``)."""
    g, d = _nb_components(nb, zb_part)
    return gain_w * g - NEIGHBOR_PENALTY * d


def _visible_iou_from_zb(
    zb_part: np.ndarray, rest_zbuf: np.ndarray, gt_part: np.ndarray
) -> float:
    """The notebook-4 visible IoU given the part's min-Z image — identical to
    ``_batch_deform_visible_iou`` but pure (H, W) image math (the z-buffers
    are already maintained per part, so no point re-evaluation is needed)."""
    visible = zb_part < rest_zbuf + VIS_EPS
    union = np.logical_or(visible, gt_part).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(visible, gt_part).sum() / union)


def _deform_vec(d: Dict) -> np.ndarray:
    return np.array(
        [d["scale_y"], d["shift_y"], d["scale_xz"], d["shift_xz"]], np.float32
    )


def rigid_consistency_seed(
    deform_q: np.ndarray, center_p: np.ndarray, center_q: np.ndarray,
    py: float,
) -> np.ndarray:
    """Part q's deform re-pivoted to part p's centroid.

    The 4-DoF warp scales about each part's own centroid
    (deformation_estimation.py:70-98), so "move p exactly as q's warp moves
    p's centroid" means copying the scales and compensating shift_y for the
    pivot offset: q maps p's centroid to
    ``cp + (cp_y - cq_y)(sy_q - 1) - dy_q*py`` while p's own deform maps it
    to ``cp - dy_p*py``, hence ``dy_p = dy_q - (cp_y - cq_y)(sy_q - 1)/py``.
    xz shifts copy unchanged (the monuments' parts share a near-common
    symmetry center, so the sign-symmetric xz warps coincide)."""
    dq = np.asarray(deform_q, np.float32)
    dy = dq[1] - (float(center_p[1]) - float(center_q[1])) * (dq[0] - 1.0) / py
    return np.array([dq[0], dy, dq[2], dq[3]], np.float32)


def prepare_shared_state(mask_labels, cam, parts, table):
    """(part_sets, centers, zb_identity) for :func:`refine_parts` — computed
    ONCE and shared read-only by the portfolio variants (each variant would
    otherwise re-extract identical per-part device windows and re-dispatch
    the identity z-buffer reduction)."""
    H, W = np.asarray(mask_labels).shape[:2]
    Hp, Wp = _pad_plane_hw(H, W)
    part_sets, centers = {}, {}
    for p in parts:
        pid = config.PART_IDS[p]
        n = table.count(pid)
        pp, vv = table.part_window(pid, 1, bucket_size(n))
        part_sets[p] = (pp, vv, n)
        centers[p] = jnp.asarray(np.asarray(table.center(pid), np.float32))
    zb_identity = all_part_zbuffers(
        table.coords, table.labels, table.valid, params_to_vector(cam),
        parts, np.asarray([H, W], np.int32), Hp, Wp,
    )
    return part_sets, centers, zb_identity


def refine_parts(
    grid_labels: np.ndarray,
    mask_labels: np.ndarray,
    cam: Dict,
    part_names: Sequence[str] | None = None,
    *,
    pin_identity: Sequence[str] = PIN_IDENTITY_PARTS,
    overrides: Optional[Dict[str, Dict]] = None,
    verify: bool = True,
    sweeps: int = 2,
    first_gain_w: float = 0.0,
    cache=None,
    table=None,
    batcher=None,
    zb_identity_out: Optional[Dict[str, np.ndarray]] = None,
    part_sets_out: Optional[Dict] = None,
    zb_identity_in: Optional[Dict[str, np.ndarray]] = None,
    part_sets_in: Optional[Dict] = None,
    centers_in: Optional[Dict] = None,
    dual_gain_w: Optional[float] = None,
    pass0_done=None,
    pass0_snapshot_out: Optional[Dict] = None,
    pass0_prefix: Optional[Dict] = None,
    resweep_window: Optional[Tuple[float, int]] = None,
    seed_cands: Optional[Dict[str, np.ndarray]] = None,
    follow_seeds: bool = True,
    **kw,
) -> Dict[str, Dict]:
    """Optimize every (present) part; returns {part: {deform, iou}} like the
    reference's saved_params (deformation_estimation.py:262-286).

    Parts are searched sequentially, largest first, each conditioned on the
    z-buffer of all other parts at their current deforms (the notebook-4
    occlusion model).  ``pin_identity`` parts keep the identity deform (see
    PIN_IDENTITY_PARTS).  ``overrides`` forces {part: deform-dict} verbatim —
    the escape hatch replacing the reference's human sliders.  With
    ``verify`` each searched deform is re-checked against identity under the
    FINAL z-buffer and reverted if it regresses, so no init->deformed eval
    cell can fall below identity.

    ``sweeps`` — total coordinate-descent passes over the parts.  Parts
    searched early are conditioned on STALE occlusion (every later part was
    still at identity), and the first pass scores candidates selfishly
    (own IoU + neighbor floor hinge).  Pass 2 re-searches every part under
    the near-final conditioning with the ENSEMBLE objective (own IoU + all
    neighbors' IoUs), accepting a move only if the joint score improves —
    coordinate ascent on the table total (measured at golden res: Bibi
    chhatris 0.707 -> 0.761, Itimad main_door 0.890 -> 0.904 from
    re-searching under the final z-buffers — the human slider sessions this
    replaces iterate the same way, deformation_estimation.py:15-356
    re-renders after every change).  Pass 3+ (if requested) re-searches
    only parts whose environment moved again.

    ``zb_identity_in`` / ``part_sets_in`` / ``centers_in`` — precomputed
    shared state from :func:`prepare_shared_state` (the portfolio variants
    share one read-only copy instead of each re-deriving it).

    ``first_gain_w`` — neighbor-gain weight for the FIRST pass (0 = greedy
    selfish, 1 = ensemble-scored from the start).

    ``dual_gain_w`` — shadow gain weight for pass 0: every pass-0 evaluation
    also ranks candidates under this weight (free — the device returns
    score components); ``pass0_done(diverged)`` is then called right after
    pass 0 with whether the two objectives EVER disagreed.  When they never
    did, a chain run at ``dual_gain_w`` is provably identical to this one,
    so the portfolio caller skips it (see run_stage3).

    ``pass0_snapshot_out`` — a dict the pass-0 loop fills with the chain
    state at the FIRST divergence point (``{"idx", "state", "zbs",
    "env"}``): the parts before ``idx`` were decided identically under both
    gain weights, so a sibling chain may adopt them verbatim.

    ``pass0_prefix`` — a snapshot from a dual-scored sibling chain: pass-0
    skips re-searching the parts before ``snapshot["idx"]`` and adopts the
    sibling's accepted deforms/z-buffers for them (provably identical —
    the dual scoring proved every decision up to that part agreed under
    both gain weights, and the search machine is deterministic).

    ``resweep_window=(span, n)`` — run the conditioning resweeps with local
    n×n offset grids spanning ±span coarse steps around each incumbent
    instead of the full slider-space coarse sweep (see optimize_part_deform
    ``_window``).  Neither dominates: the
    greedy start wins Taj (an ensemble-scored first pass refuses to clear
    the windows' growth region), the ensemble start wins Itimad (it finds
    the full_building deform that unlocks main_door 0.904, which the
    greedy start + coordinate ascent cannot reach through any single
    accepted move).  run_stage3 runs both and keeps the state with the
    higher EXACT nb4 table total (deform/verify._nb4_state) — the same
    portfolio-then-eyeball process the reference's human operator ran
    across slider configurations.
    """
    from pbr3d.carving.voxel import PointCache

    if part_names is None:
        part_names = [p for p in config.PART_NAMES if p != "background"]
    overrides = overrides or {}
    if table is not None:
        parts = [p for p in part_names if table.count(config.PART_IDS[p]) > 0]
    else:
        if cache is None:
            cache = PointCache(grid_labels)
        present = set(np.unique(cache._labels))
        parts = [p for p in part_names if config.PART_IDS[p] in present]
    if not parts:
        return {}

    body = functools.partial(
        _refine_parts_body, grid_labels, mask_labels, cam, parts,
        pin_identity=pin_identity, overrides=overrides, verify=verify,
        sweeps=sweeps, first_gain_w=first_gain_w, cache=cache, table=table,
        batcher=batcher, zb_identity_out=zb_identity_out,
        part_sets_out=part_sets_out, zb_identity_in=zb_identity_in,
        part_sets_in=part_sets_in, centers_in=centers_in,
        dual_gain_w=dual_gain_w, pass0_done=pass0_done,
        pass0_snapshot_out=pass0_snapshot_out, pass0_prefix=pass0_prefix,
        resweep_window=resweep_window, seed_cands=seed_cands,
        follow_seeds=follow_seeds, **kw,
    )
    if batcher is not None:
        # register this chain for the lockstep flush policy; the wrapper
        # guarantees exit even when a search raises
        batcher.chain_enter()
        try:
            return body()
        finally:
            batcher.chain_exit()
    return body()


def _refine_parts_body(
    grid_labels,
    mask_labels,
    cam,
    parts,
    *,
    pin_identity,
    overrides,
    verify,
    sweeps,
    first_gain_w,
    cache,
    table,
    batcher,
    zb_identity_out,
    part_sets_out,
    zb_identity_in,
    part_sets_in,
    centers_in,
    dual_gain_w,
    pass0_done,
    pass0_snapshot_out,
    pass0_prefix,
    resweep_window,
    seed_cands,
    follow_seeds,
    **kw,
):
    H, W = np.asarray(mask_labels).shape[:2]
    Hp, Wp = _pad_plane_hw(H, W)
    cam_vec = jnp.asarray(params_to_vector(cam))
    true_hw = jnp.asarray(np.asarray([H, W], np.int32))
    vs = jnp.asarray(np.asarray(np.asarray(grid_labels).shape[:3], np.int32))
    gt_full = np.asarray(mask_labels)

    from pbr3d.utils.profiling import prof

    padded_sets = {}
    centers = {}
    if part_sets_in is not None and centers_in is not None:
        # Precomputed by the caller — the portfolio variants share ONE copy
        # (read-only device arrays; each variant's mutable state lives in
        # its own `state`/`zbs` dicts).
        padded_sets = dict(part_sets_in)
        centers = dict(centers_in)
    else:
        with prof("refine_parts.upload_sets", sync=False):
            for p in parts:
                pid = config.PART_IDS[p]
                if table is not None:
                    # per-part compact sets extracted ON DEVICE from the table
                    # (same bucket shapes as the host pad path -> same
                    # executables downstream, zero upload)
                    n = table.count(pid)
                    pp, vv = table.part_window(pid, 1, bucket_size(n))
                    padded_sets[p] = (pp, vv, n)
                    centers[p] = jnp.asarray(np.asarray(table.center(pid), np.float32))
                else:
                    pts = cache.points_by_parts([p])[0]
                    pp, vv = pad_points_i16(pts, bucket_size(len(pts)))
                    padded_sets[p] = (jnp.asarray(pp), jnp.asarray(vv), len(pts))
                    centers[p] = jnp.asarray(np.asarray(pts.mean(axis=0), np.float32))

    if part_sets_out is not None:
        # export the (device-resident) padded per-part sets for the caller's
        # grid rebuild — extracting them twice is pure waste
        part_sets_out.update({p: padded_sets[p][:2] for p in parts})

    def zb_at(p: str, deform: np.ndarray) -> np.ndarray:
        pp, vv, _ = padded_sets[p]
        if batcher is not None:
            from pbr3d.deform.batched import zbuffer_batched

            return zbuffer_batched(
                batcher, deform, pp, vv, cam_vec, true_hw, vs, centers[p],
                Hp, Wp,
            )
        return np.asarray(deformed_zbuffer(
            jnp.asarray(deform), pp, vv, cam_vec, true_hw, vs, centers[p],
            Hp, Wp,
        ))

    state: Dict[str, np.ndarray] = {p: IDENTITY_DEFORM.copy() for p in parts}
    if zb_identity_in is not None and all(p in zb_identity_in for p in parts):
        zb_identity = {p: zb_identity_in[p] for p in parts}
    else:
        # All parts' identity z-buffers in ONE dispatch (identity deform +
        # the 7-jitter rounding reproduce the raw integer coords exactly, so
        # the direct projection is equivalent to deformed_zbuffer at
        # identity).
        if table is not None:
            pa, la, va = table.coords, table.labels, table.valid
        else:
            pts_all, labels_all = cache.all_points()
            n_all = bucket_size(len(pts_all))
            pa = np.zeros((n_all, 3), np.int16)
            la = np.zeros((n_all,), np.uint8)
            va = np.zeros((n_all,), bool)
            pa[: len(pts_all)] = pts_all
            la[: len(pts_all)] = labels_all
            va[: len(pts_all)] = True
        with prof("refine_parts.identity_zbufs"):
            zb_identity = all_part_zbuffers(
                pa, la, va, params_to_vector(cam), parts,
                np.asarray([H, W], np.int32), Hp, Wp,
            )
    if zb_identity_out is not None:
        # export for the exact-verify pass: identical to the dense-grid
        # z-buffers (same occupied voxels, same projection), saving it the
        # full init-grid re-upload + reduction (deform/verify._nb4_state)
        zb_identity_out.update(zb_identity)
    zbs: Dict[str, np.ndarray] = {}
    for p in parts:
        if p in overrides:
            state[p] = _deform_vec(overrides[p])
            zbs[p] = zb_at(p, state[p])
        else:
            zbs[p] = zb_identity[p]

    def rest_zb(p: str) -> np.ndarray:
        others = [zbs[q] for q in parts if q != p]
        if not others:
            return np.full((Hp, Wp), np.inf, np.float32)
        return np.minimum.reduce(others)

    @functools.lru_cache(maxsize=None)
    def _gt_plane(p: str):
        g = np.zeros((Hp, Wp), bool)
        g[:H, :W] = gt_full == config.PART_IDS[p]
        return g

    # Init-state floors: every part's visible IoU with the WHOLE grid at
    # identity — the notebook-4 "init" column each deformed cell is judged
    # against (eval_helpers_intra.py:560-748).
    floor_full: Dict[str, float] = {}
    floor_half: Dict[str, float] = {}
    zb2_identity = {p: _min_pool2(zb_identity[p]) for p in parts}
    gt2 = {p: _max_pool2(_gt_plane(p)) for p in parts}
    for p in parts:
        others = [zb_identity[q] for q in parts if q != p]
        rest_i = (np.minimum.reduce(others) if others
                  else np.full((Hp, Wp), np.inf, np.float32))
        floor_full[p] = _visible_iou_from_zb(zb_identity[p], rest_i, _gt_plane(p))
        others2 = [zb2_identity[q] for q in parts if q != p]
        rest2 = (np.minimum.reduce(others2) if others2
                 else np.full((Hp // 2, Wp // 2), np.inf, np.float32))
        vis2 = zb2_identity[p] < rest2 + VIS_EPS
        u2 = np.logical_or(vis2, gt2[p]).sum()
        floor_half[p] = float(np.logical_and(vis2, gt2[p]).sum() / u2) if u2 else 0.0

    NB_Q = 8  # fixed neighbor-axis padding: one compiled program for all parts

    def nb_bundle(p: str) -> Optional[Dict]:
        """Half-res neighbor z-buffers/GT/floors for the cross-part terms
        (gain-weight-free: the device returns score components and every
        consumer combines them with its own gain weight)."""
        others = [q for q in parts if q != p]
        if not others or len(others) > NB_Q:
            return None
        h2, w2 = Hp // 2, Wp // 2
        zb2 = {q: _min_pool2(zbs[q]) for q in others}
        nb = {
            "zb": np.full((NB_Q, h2, w2), np.inf, np.float32),
            "base": np.zeros((NB_Q, h2, w2), bool),
            "gt": np.zeros((NB_Q, h2, w2), bool),
            "floor": np.zeros((NB_Q,), np.float32),
            "valid": np.zeros((NB_Q,), bool),
        }
        Z = np.stack([zb2[q] for q in others])  # (Q, h2, w2)
        s = np.sort(Z, axis=0)
        m1 = s[0]
        m2 = s[1] if len(others) > 1 else np.full_like(m1, np.inf)
        for i, q in enumerate(others):
            # min over the others excluding q (ties make m2 == m1, correct)
            rest_excl = np.where(Z[i] == m1, m2, m1)
            nb["zb"][i] = Z[i]
            nb["base"][i] = Z[i] < rest_excl + VIS_EPS
            nb["gt"][i] = gt2[q]
            nb["floor"][i] = floor_half[q]
            nb["valid"][i] = True
        return nb

    # largest parts first: their z-surfaces dominate everyone's occlusion;
    # parts absent from the mask (empty GT) can only score 0 — keep identity
    searched = [
        p for p in sorted(parts, key=lambda q: -padded_sets[q][2])
        if p not in pin_identity and p not in overrides
        and _gt_plane(p).sum() > 0
    ]
    def env_sig(p: str) -> bytes:
        return b"".join(state[q].tobytes() for q in parts if q != p)

    centers_np = {p: np.asarray(centers[p], np.float32) for p in parts}
    py_ratio = float(np.asarray(grid_labels).shape[1]) / float(H)

    def _seeds_for(p: str):
        """Candidate seeds injected into every stage of p's search.

        ``follow_seeds`` adds RIGID-CONSISTENCY seeds: for every other part
        q whose accepted deform has moved, q's deform re-pivoted to p's
        centroid — scales copied, shift_y compensated for the pivot offset
        (y'_q(cp) = cp + (cp-cq)(sy_q-1) - dy_q*py  must equal
        cp - dy_p*py, so dy_p = dy_q - (cp_y-cq_y)(sy_q-1)/py; xz shifts
        copy because the monuments' parts share a near-common symmetry
        center).  Parts of one building move together under a perspective
        camera (the stage-2 fit trades distance against focal length, so
        the whole model is uniformly mis-scaled): measured on Taj at golden
        res, the human's chhatris deform (1.27, -17, 1.09, 5) is exactly
        full_building's growth re-pivoted, and the separable coarse sweeps
        cannot reach its basin (nb4 cell 0.74 without the seed, 0.81 with).
        """
        rows = []
        if seed_cands and p in seed_cands:
            rows.extend(np.asarray(seed_cands[p], np.float32).reshape(-1, 4))
        if follow_seeds:
            cp = centers_np[p]
            for q in parts:
                if q == p or np.array_equal(state[q], IDENTITY_DEFORM):
                    continue
                dq = np.asarray(state[q], np.float32)
                rows.append(rigid_consistency_seed(
                    dq, cp, centers_np[q], py_ratio))
                rows.append(dq.copy())
        if not rows:
            return None
        uniq = []
        for r in rows:
            if not any(np.array_equal(r, u) for u in uniq):
                uniq.append(r)
        return np.stack(uniq)

    def search_part(p: str, gain_w: float = 0.0, dual_out=None,
                    incumbent=None, window=None):
        if table is not None:
            src_kw = dict(_table=table)
        else:
            src_kw = dict(
                _points=cache.points_by_parts([p])[0],
                _surface_points=cache.surface_points_by_parts([p])[0],
            )
        return optimize_part_deform(
            grid_labels, p, mask_labels, cam,
            rest_zbuf=rest_zb(p),
            _batcher=batcher,
            _device_full=padded_sets[p][:2],
            _zb_identity=zb_identity[p],
            _nb=nb_bundle(p),
            _gain_w=gain_w,
            _dual_gain_w=dual_gain_w if dual_out is not None else None,
            _dual_out=dual_out,
            _incumbent=incumbent,
            _zb_incumbent=zbs[p] if incumbent is not None else None,
            _window=window,
            _seed_cands=_seeds_for(p),
            _return_zb=True,
            **src_kw,
            **kw,
        )

    dual_out = {"diverged": False} if dual_gain_w is not None else None
    env_at_search: Dict[str, bytes] = {}
    prefix_idx = -1
    if pass0_prefix is not None and pass0_prefix.get("idx", 0) > 0:
        # Adopt the sibling chain's pass-0 prefix (parts decided before its
        # first gain-weight divergence are provably identical under either
        # weight — skip re-searching them).  The snapshot was taken BEFORE
        # the diverging part's own update, so later parts in it still sit
        # at identity and adopting the whole dicts is safe.
        prefix_idx = int(pass0_prefix["idx"])
        for q, v in pass0_prefix["state"].items():
            state[q] = np.asarray(v, np.float32).copy()
        zbs.update(pass0_prefix["zbs"])
        env_at_search.update(pass0_prefix["env"])
    for i, p in enumerate(searched):
        if i < prefix_idx:
            continue
        env_at_search[p] = env_sig(p)
        with prof(f"refine_parts.search.{p}"):
            deform, _, zb_new = search_part(p, gain_w=first_gain_w,
                                            dual_out=dual_out)
            if (pass0_snapshot_out is not None and dual_out is not None
                    and dual_out["diverged"]
                    and "idx" not in pass0_snapshot_out):
                # first divergence: freeze the pre-update chain state so the
                # sibling chain can adopt parts 0..i-1 verbatim
                pass0_snapshot_out.update(
                    idx=i,
                    state={q: state[q].copy() for q in parts},
                    zbs=dict(zbs),
                    env=dict(env_at_search),
                )
            if not np.array_equal(deform, state[p]):
                state[p] = deform
                # the accept check already computed the full-set z-buffer
                # at the winning deform — reuse it instead of re-dispatching
                zbs[p] = zb_new if zb_new is not None else zb_at(p, deform)
    if pass0_done is not None:
        pass0_done(bool(dual_out["diverged"]) if dual_out else None)

    # Conditioning resweeps under the ENSEMBLE objective (nb gain term on):
    # with every part near its final position the neighbor charging is
    # truthful, so each accepted move is a coordinate-ascent step on the
    # (half-res model of the) nb4 table total.  Sweep 1 re-searches EVERY
    # part — the objective itself changed from the greedy first pass, not
    # just the conditioning; later sweeps only parts whose occlusion
    # environment moved since their last search.
    for sweep in range(1, max(1, sweeps)):
        if sweep == 1 and first_gain_w != 1.0:
            # The first pass scored candidates with a DIFFERENT objective
            # (selfish / partial gain), so every part is due a re-search
            # even if its occlusion environment never moved.  When the
            # first pass already ran the full ensemble objective
            # (first_gain_w=1), only conditioning staleness matters.
            stale = list(searched)
        else:
            stale = [p for p in searched if env_sig(p) != env_at_search[p]]
        if not stale:
            break
        for p in stale:
            env_at_search[p] = env_sig(p)
            with prof(f"refine_parts.resweep{sweep}.{p}"):
                deform, _, zb_new = search_part(
                    p, gain_w=1.0, incumbent=state[p], window=resweep_window)
                if np.array_equal(deform, state[p]):
                    continue
                zb_cand = zb_new if zb_new is not None else zb_identity[p]
                nb = nb_bundle(p)
                rest = rest_zb(p)

                def _score(zb):
                    s = _visible_iou_from_zb(zb, rest, _gt_plane(p))
                    return s + (_nb_score(nb, zb, 1.0) if nb else 0.0)

                if _score(zb_cand) > _score(zbs[p]) + 1e-6:
                    state[p] = deform
                    zbs[p] = zb_cand

    # Final staleness re-score (pure image math, no re-search): a part
    # accepted early in a resweep is scored against the conditioning at ITS
    # search time; later accepts in the same sweep can invalidate that
    # improvement.  Re-score every deformed part against identity under the
    # FINAL conditioning with the full ensemble objective and revert any
    # that ended net-negative (each revert changes the conditioning, so
    # iterate to a fixpoint; monotone — every step removes one deform).
    for _ in range(len(searched)):
        reverted_any = False
        for p in searched:
            if np.array_equal(state[p], IDENTITY_DEFORM):
                continue
            nb = nb_bundle(p)
            rest = rest_zb(p)

            def _score(zb):
                s = _visible_iou_from_zb(zb, rest, _gt_plane(p))
                return s + (_nb_score(nb, zb, 1.0) if nb else 0.0)

            if _score(zb_identity[p]) > _score(zbs[p]) + 1e-6:
                state[p] = IDENTITY_DEFORM.copy()
                zbs[p] = zb_identity[p]
                reverted_any = True
        if not reverted_any:
            break

    if verify:
        # Init-anchored verify (pure image math over the maintained per-part
        # z-buffers): no part's visible IoU under the FINAL occlusion state
        # may fall below its all-identity floor — the notebook-4 acceptance
        # criterion (a deformed cell must not regress vs the init column).
        # A regressed part that is itself deformed is reverted; a regressed
        # part at identity was occluded by a NEIGHBOR's deform — revert the
        # offender whose removal recovers it most.
        def cur_iou(p):
            return _visible_iou_from_zb(zbs[p], rest_zb(p), _gt_plane(p))

        for _ in range(2 * len(parts)):
            reverted = False
            for p in parts:
                if p in overrides:
                    continue  # human-forced deforms are not second-guessed
                if cur_iou(p) + 1e-6 >= floor_full[p]:
                    continue
                if not np.array_equal(state[p], IDENTITY_DEFORM):
                    state[p] = IDENTITY_DEFORM.copy()
                    zbs[p] = zb_identity[p]
                    reverted = True
                    continue
                # p is identity but regressed: find the deformed neighbor
                # whose revert recovers p the most
                offenders = [
                    q for q in searched
                    if q != p and not np.array_equal(state[q], IDENTITY_DEFORM)
                ]
                best_q, best_gain = None, -np.inf
                for q in offenders:
                    saved = zbs[q]
                    zbs[q] = zb_identity[q]
                    gain = cur_iou(p)
                    zbs[q] = saved
                    if gain > best_gain:
                        best_q, best_gain = q, gain
                if best_q is not None and best_gain > cur_iou(p) + 1e-6:
                    state[best_q] = IDENTITY_DEFORM.copy()
                    zbs[best_q] = zb_identity[best_q]
                    reverted = True
            if not reverted:
                break

    out = {}
    for p in parts:
        iou = _visible_iou_from_zb(zbs[p], rest_zb(p), _gt_plane(p))
        out[p] = {
            "deform": {
                "scale_y": float(state[p][0]),
                "shift_y": float(state[p][1]),
                "scale_xz": float(state[p][2]),
                "shift_xz": float(state[p][3]),
            },
            "iou": iou,
            # parts absent from the mask can only ever score 0 (notebook 4
            # prints "--" for them); consumers exclude them from means
            "gt_px": int(_gt_plane(p).sum()),
        }
    return out
