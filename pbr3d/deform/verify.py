"""Exact notebook-4 acceptance verification for stage-3 deforms.

The search in :mod:`pbr3d.deform.search` models visibility with per-part
z-buffers of the *init-grid* point sets warped on the fly.  Notebook 4
(reference ``utils/eval_helpers_intra.py:560-748``) instead evaluates the
REBUILT deformed grid (``build_deformed_grid`` scatter: 7-jitter rounding
AND later parts overwriting earlier ones on voxel collisions) against a
ROUNDED-resize mask (``:31-54``; stage 1/3 use truncated dims).  Those
differences let a deform that passes the search's internal check regress in
the published table (the round-2 Itimad main_door 0.900→0.805 cell).

This module recomputes the actual nb4 cells from the rebuilt grid and
reverts offenders until no init→deformed cell regresses.  It is exact
because for a fixed pixel the nb4 visibility test ``∃ point: |Z−zbuf|<eps``
is decided by the part's min-Z point (zbuf ≤ Z for every grid point, so
|Z−zbuf| is minimized at the part's min), i.e. the per-part z-buffer images
of the REBUILT grid's point sets carry the full information.

Reference anchors: utils/eval_helpers_intra.py:134-190 (z-buffer +
visibility), :560-748 (table driver), utils/deformation_estimation.py:288-313
(grid rebuild).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.camera.geometry import params_to_vector
from pbr3d.carving.voxel import PointCache, bucket_size
from pbr3d.deform.search import (
    IDENTITY_DEFORM,
    VIS_EPS,
    _pad_plane_hw,
    _visible_iou_from_zb,
)

#: The nb4 table's searched-part rows (eval_helpers_intra.py:564).
NB4_PARTS = ("dome", "chhatris", "main_door", "windows", "plinth")


def _part_zbufs(
    cache: PointCache, cam: Dict, H: int, W: int, parts
) -> Dict[str, np.ndarray]:
    """(Hp, Wp) min-Z image per part — ALL parts in one device dispatch
    (pbr3d.deform.search.all_part_zbuffers)."""
    from pbr3d.deform.search import all_part_zbuffers

    Hp, Wp = _pad_plane_hw(H, W)
    pts, labels = cache.all_points()
    n = bucket_size(len(pts))
    pa = np.zeros((n, 3), np.int16)
    la = np.zeros((n,), np.uint8)
    va = np.zeros((n,), bool)
    pa[: len(pts)] = pts
    la[: len(pts)] = labels
    va[: len(pts)] = True
    return all_part_zbuffers(
        pa, la, va, params_to_vector(cam), list(parts),
        np.asarray([H, W], np.int32), Hp, Wp,
    )


def _part_zbufs_grid(grid, cam: Dict, H: int, W: int, parts):
    """Per-part z-buffers from a dense (possibly device-resident) grid —
    one dispatch, zero host transfer (ops.projection.partwise_zbuffers_grid)."""
    import jax.numpy as jnp

    from pbr3d.deform.search import _ZB_SLOTS
    from pbr3d.ops.projection import partwise_zbuffers_grid

    Hp, Wp = _pad_plane_hw(H, W)
    ids = np.full((_ZB_SLOTS,), 255, np.int32)
    for i, p in enumerate(parts):
        ids[i] = config.PART_IDS[p]
    zbs = np.asarray(partwise_zbuffers_grid(
        jnp.asarray(grid), params_to_vector(cam), jnp.asarray(ids),
        jnp.asarray([H, W], np.int32), Hp, Wp,
    ))
    return {p: zbs[i] for i, p in enumerate(parts)}


def _cells_from_zbufs(
    zbufs: Dict[str, np.ndarray], gt_planes: Dict[str, np.ndarray]
) -> Dict[str, float]:
    """part -> visible IoU given every part's min-Z image of one grid."""
    parts = list(zbufs)
    out = {}
    for p in parts:
        others = [zbufs[q] for q in parts if q != p]
        rest = (np.minimum.reduce(others) if others
                else np.full_like(zbufs[p], np.inf))
        out[p] = _visible_iou_from_zb(zbufs[p], rest, gt_planes[p])
    return out


def _rows_from_state(
    zb_i: Dict[str, np.ndarray],
    zb_d: Dict[str, np.ndarray],
    gt_planes: Dict[str, np.ndarray],
    parts,
    mask_p: np.ndarray,
) -> Dict[str, Tuple[float, float]]:
    """All nb4 rows from the two grids' per-part z-buffer stacks."""
    cells_i = _cells_from_zbufs(zb_i, gt_planes)
    cells_d = _cells_from_zbufs(zb_d, gt_planes)
    out = {}
    for p in parts:
        if p not in NB4_PARTS:
            continue
        if gt_planes[p].sum() == 0:
            continue  # nb4 prints "--"
        out[p] = (cells_i[p], cells_d[p])

    # "minarets" row: INIT-grid minaret points z-tested against each grid
    # (eval_helpers_intra.py:631-648).  Minarets exist in the rebuilt grid
    # (pinned/identity), so their min-Z decides visibility in both columns.
    min_parts = [p for p in ("front_minarets", "back_minarets") if p in parts]
    tot_i = np.minimum.reduce(list(zb_i.values()))
    tot_d = np.minimum.reduce(list(zb_d.values()))
    if min_parts:
        zb_min = np.minimum.reduce([zb_i[p] for p in min_parts])
        gt_min = np.logical_or.reduce([gt_planes[p] for p in min_parts])
        # visible iff the minarets' min-Z is within eps of the whole grid's
        # z-buffer; tot <= zb_min in both grids (minarets are pinned), so
        # passing the TOTAL as the "rest" gives exactly zb_min - tot < eps.
        iou_i = _visible_iou_from_zb(zb_min, tot_i, gt_min)
        iou_d = _visible_iou_from_zb(zb_min, tot_d, gt_min)
        out["minarets"] = (iou_i, iou_d)

    # "whole" row: occupied-pixel silhouette of each grid vs the union GT of
    # labels present in the INIT grid (eval_helpers_intra.py:274-285).
    present_ids = [config.PART_IDS[p] for p in parts]
    gt_whole = np.isin(mask_p, present_ids)
    out["whole"] = (
        _iou_bool_np(np.isfinite(tot_i), gt_whole),
        _iou_bool_np(np.isfinite(tot_d), gt_whole),
    )
    return out


def _nb4_state(
    grid_init: np.ndarray,
    grid_def: np.ndarray,
    mask_nb4: np.ndarray,
    cam: Dict,
    cache_init: Optional[PointCache] = None,
    zb_i: Optional[Dict[str, np.ndarray]] = None,
    parts: Optional[list] = None,
):
    """(cells, zb_i, zb_d, gt_planes, parts, mask_p) for the rebuilt grid.
    ``zb_i`` (init z-buffers) can be reused across rebuilds — the init grid
    never changes inside the verify loop.  ``parts`` (the init grid's
    present parts) skips the host PointCache scan when the caller already
    knows them (e.g. from the device point table)."""
    from pbr3d.utils.profiling import prof

    H, W = np.asarray(mask_nb4).shape[:2]
    Hp, Wp = _pad_plane_hw(H, W)
    if parts is None:
        cache_init = cache_init or PointCache(grid_init)
        present_i = set(int(v) for v in np.unique(cache_init._labels))
        parts = [p for p in config.PART_NAMES
                 if p != "background" and config.PART_IDS[p] in present_i]
    gt_planes = {}
    mask_p = np.zeros((Hp, Wp), np.uint8)
    mask_p[:H, :W] = np.asarray(mask_nb4)
    for p in parts:
        gt_planes[p] = mask_p == config.PART_IDS[p]

    if zb_i is not None and (
        any(p not in zb_i for p in parts)
        or any(np.asarray(zb_i[p]).shape != (Hp, Wp) for p in parts)
    ):
        zb_i = None  # incompatible precompute — fall back to the dense pass
    if zb_i is None:
        with prof("verify.zb_init", sync=False):
            zb_i = _part_zbufs_grid(grid_init, cam, H, W, parts)
    # Parts may vanish from the rebuilt grid (fully overwritten): their
    # deformed z-buffer is empty (inf) and the cell reads ~0, as in nb4.
    # ``grid_def`` may be a DEVICE array (the fused rebuild) — the dense
    # z-buffer program reads it without any host round-trip.
    with prof("verify.zb_def", sync=False):
        zb_d = _part_zbufs_grid(grid_def, cam, H, W, parts)
    with prof("verify.rows", sync=False):
        cells = _rows_from_state(zb_i, zb_d, gt_planes, parts, mask_p)
    return cells, zb_i, zb_d, gt_planes, parts, mask_p


def nb4_exact_cells(
    grid_init: np.ndarray,
    grid_def: np.ndarray,
    mask_nb4: np.ndarray,
    cam: Dict,
    cache_init: Optional[PointCache] = None,
    cache_def: Optional[PointCache] = None,
) -> Dict[str, Tuple[float, float]]:
    """The nb4 per-part init→deformed IoU cells, exactly as notebook 4
    computes them.  ``mask_nb4`` must be the ROUNDED-resize label mask."""
    return _nb4_state(grid_init, grid_def, mask_nb4, cam, cache_init)[0]


def _iou_bool_np(a: np.ndarray, b: np.ndarray) -> float:
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 0.0


def enforce_no_regression(
    grid_init: np.ndarray,
    deforms: Dict[str, Dict],
    mask_nb4: np.ndarray,
    cam: Dict,
    build_fn,
    max_rounds: int = 3,
    cache_init: Optional[PointCache] = None,
    zb_i: Optional[Dict[str, np.ndarray]] = None,
    parts: Optional[list] = None,
    first_state: Optional[tuple] = None,
) -> Tuple[Dict[str, Dict], np.ndarray]:
    """Rebuild→verify→revert loop: returns (possibly-updated deforms, grid).

    ``build_fn(deform_vecs) -> np.ndarray`` rebuilds the deformed grid from
    the given {part: (4,) vec} dict (points stay device-resident in the
    caller).  Any nb4 cell that regresses init→deformed gets its part
    reverted to identity; if the regressed part is already identity, the
    deformed part whose revert recovers it most is reverted instead.

    ``zb_i`` — optional precomputed init-grid per-part z-buffers (e.g. the
    search's identity z-buffers, which are point-set equivalents of the
    dense-grid reduction); used only if they cover every present part at
    the right plane shape.

    ``first_state`` — optional (cells, zb_i, zb_d, gt_planes, parts, mask_p,
    grid_def): the `_nb4_state` of ``deforms``' rebuilt grid as already
    computed by the caller (the portfolio pick evaluates exactly this state
    to rank the variants — rebuilding + re-z-buffering it here is waste).
    """
    def vecs():
        return {
            p: np.array(
                [d["deform"]["scale_y"], d["deform"]["shift_y"],
                 d["deform"]["scale_xz"], d["deform"]["shift_xz"]], np.float32)
            for p, d in deforms.items()
        }

    from pbr3d.utils.profiling import prof

    if first_state is not None:
        cells, zb_i, zb_d, gt_planes, parts, mask_p, grid_def = first_state
    else:
        if parts is None:
            cache_init = cache_init or PointCache(grid_init)
        with prof("verify.build", sync=False):
            grid_def = build_fn(vecs())
        with prof("verify.nb4_state", sync=False):
            cells, zb_i, zb_d, gt_planes, parts, mask_p = _nb4_state(
                grid_init, grid_def, mask_nb4, cam, cache_init=cache_init,
                zb_i=zb_i, parts=parts,
            )

    def _tol(p: str) -> float:
        # Part cells must not regress AT ALL.  The aggregate rows get small
        # allowances: the "whole" (occupied-union) row because identity
        # parts sitting on the WRONG pixels still inflate it when those
        # pixels belong to other parts' GT, and the "minarets" row because
        # it z-tests INIT points against the deformed grid, so ANY deform
        # near the minarets costs a fringe of pixels.  The reference
        # goldens accept far larger trades on both (whole: Charminar
        # 0.894→0.889; minarets: Charminar 0.814→0.746, Akbar 0.800→0.779).
        return {"whole": 0.01, "minarets": 0.005}.get(p, 1e-6)

    for _ in range(max_rounds):
        regressed = [p for p, (i, d) in cells.items() if d + _tol(p) < i]
        if not regressed:
            break
        changed = False
        for p in regressed:
            dv = vecs().get(p)
            if dv is not None and not np.array_equal(dv, IDENTITY_DEFORM):
                print(f"[stage3-verify] nb4 regression {p} "
                      f"{cells[p][0]:.3f}->{cells[p][1]:.3f}: revert to identity",
                      file=sys.stderr)
                deforms[p]["deform"] = {
                    "scale_y": 1.0, "shift_y": 0.0,
                    "scale_xz": 1.0, "shift_xz": 0.0,
                }
                changed = True
            else:
                # p itself is identity — rank the deformed neighbors by how
                # much reverting each recovers p's cell, via the z-buffer
                # stacks (swap q's deformed z-buffer for its init one):
                # image math only, no grid rebuild per candidate.  The
                # chosen revert is verified EXACTLY on the rebuilt grid at
                # the top of the next round (the swap ignores scatter-
                # collision effects, which only make the estimate
                # conservative for ranking).
                cands = [
                    q for q, dq in vecs().items()
                    if q != p and not np.array_equal(dq, IDENTITY_DEFORM)
                ]
                best_q, best_iou = None, cells[p][1]
                for q in cands:
                    zb_try = dict(zb_d)
                    zb_try[q] = zb_i[q]
                    rows = _rows_from_state(
                        zb_i, zb_try, gt_planes, parts, mask_p
                    )
                    iou_try = rows.get(p, (0.0, 0.0))[1]
                    if iou_try > best_iou:
                        best_q, best_iou = q, iou_try
                if best_q is not None:
                    print(f"[stage3-verify] nb4 regression {p} "
                          f"{cells[p][0]:.3f}->{cells[p][1]:.3f}: reverting "
                          f"offender {best_q}", file=sys.stderr)
                    deforms[best_q]["deform"] = {
                        "scale_y": 1.0, "shift_y": 0.0,
                        "scale_xz": 1.0, "shift_xz": 0.0,
                    }
                    changed = True
        if not changed:
            break
        grid_def = build_fn(vecs())
        cells, _, zb_d, gt_planes, parts, mask_p = _nb4_state(
            grid_init, grid_def, mask_nb4, cam, cache_init=cache_init,
            zb_i=zb_i, parts=parts,
        )

    # refresh the stored per-part IoUs with the exact nb4 deformed values
    for p, (_, d) in cells.items():
        if p in deforms:
            deforms[p]["iou"] = float(d)
    return deforms, grid_def
