"""Fused, bucket-padded stage-1 pipeline — the production path.

The modular functions in pbr3d.carving.stage1 are semantically exact but
dispatch many small eager ops whose shapes differ per monument and per
component crop.  Every distinct (op, shape) is a fresh compile, so the
cold wall time grows with program COUNT.  This module restructures stage 1
so that:

* global + per-part-group carving is ONE jit program per bucketed mask
  shape, with the true mask extent and the rotation plans passed as traced
  data — every monument sharing a bucket shares the executable;
* component-guided carving slices fixed-size bucket WINDOWS out of a
  once-padded grid (``lax.dynamic_slice``), so all components sharing a
  window bucket share one sweep program;
* interior extrusion for all parts/directions is one jit program per grid
  bucket (traced true sizes reproduce the reference's boundary behavior);
* the reorientation flip and back-minaret recolor run on the padded grid
  with traced sizes.

Outputs are BIT-IDENTICAL to pbr3d.carving.stage1 (and therefore to the
reference implementation) — verified by the fixture tests, which run both
paths.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.config import PART_IDS
from pbr3d.ops.carve import _round_up, _stacked_plans_padded, _sweep_scan

Array = jax.Array


def _sweep_padded(occ_p: Array, m2: Array, plans) -> Array:
    """Run the scan sweep on an already-padded (Wb, Hb, Db) occupancy with a
    (Hb, Wb*Db) column mask; plans are (idx, dec) device arrays."""
    Wb, Hb, Db = occ_p.shape
    g2 = jnp.transpose(occ_p, (1, 0, 2)).reshape(Hb, Wb * Db).astype(jnp.uint8)
    out = _sweep_scan(g2, m2, plans[0], plans[1])
    return jnp.transpose(out.reshape(Hb, Wb, Db), (1, 0, 2))


def _global_and_part_carve_impl(
    binary_wh_p: Array,  # (Wb, Hb) uint8/bool, zero-padded
    ext_wh_p: Array,  # (Wb, Hb) uint8 labels, zero-padded
    true_whd: Array,  # (3,) int32: the true (w, h, d) grid extent
    plan_idx: Array,  # (A, 4, Wb*Db)
    plan_dec: Array,  # (A, Wb*Db)
    group_ids: Tuple[Tuple[int, ...], ...],  # static: label ids per group
) -> Array:
    """Global carve + per-group part carve, one compiled program per bucket.

    All groups use the same (90°) sweep plans as the global carve — true for
    the reference's notebook preset; generalize with per-group plans if a
    preset ever differs.
    """
    Wb, Hb = binary_wh_p.shape
    Db = Wb
    w, h, d = true_whd[0], true_whd[1], true_whd[2]

    ix = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 2)
    in_true = (ix < w) & (iy < h) & (iz < d)

    def col_mask(m_wh):
        return jnp.broadcast_to(
            (m_wh > 0).astype(jnp.uint8).T[:, :, None], (Hb, Wb, Db)
        ).reshape(Hb, Wb * Db)

    plans = (plan_idx, plan_dec)

    # --- global carve: ones in the true extent, sweep, paint labels ---
    occ0 = in_true.astype(jnp.uint8)
    carved = _sweep_padded(occ0, col_mask(binary_wh_p), plans)
    grid = carved.astype(jnp.uint8) * ext_wh_p.astype(jnp.uint8)[:, :, None]

    # --- per-group re-carve (reference part_carve) ---
    final = jnp.zeros_like(grid)
    for ids in group_ids:
        m_wh = jnp.isin(ext_wh_p, jnp.asarray(ids, jnp.uint8))
        sub = grid * m_wh.astype(jnp.uint8)[:, :, None]
        carved = _sweep_padded((sub > 0).astype(jnp.uint8), col_mask(m_wh), plans)
        part = sub * carved.astype(jnp.uint8)
        final = jnp.where(part > 0, part, final)
    return final


_global_and_part_carve = functools.partial(jax.jit, static_argnames=("group_ids",))(
    _global_and_part_carve_impl
)


@functools.partial(jax.jit, static_argnames=("group_ids",))
def _global_and_part_carve_batched(
    binary_b: Array,  # (B, Wb, Hb)
    ext_b: Array,  # (B, Wb, Hb)
    true_whd_b: Array,  # (B, 3) int32
    plan_idx_b: Array,  # (B, A, 4, Wb*Db) — per-scene plans (extents differ)
    plan_dec_b: Array,  # (B, A, Wb*Db)
    group_ids: Tuple[Tuple[int, ...], ...],
) -> Array:
    """All scenes' global+group carves in ONE program (SURVEY §7 M6): the
    scenes are padded to a common bucket and vmapped, so the whole 5-monument
    carve costs one dispatch and one compile."""
    return jax.vmap(
        lambda b, e, t, pi, pd: _global_and_part_carve_impl(
            b, e, t, pi, pd, group_ids
        )
    )(binary_b, ext_b, true_whd_b, plan_idx_b, plan_dec_b)


def _guided_window_step(
    window: Array,  # (Wb, Hb, Db) uint8 labels
    compw: Array,  # (Wb, Hb, Db) int32 component labels
    comp_id: Array,  # scalar int32
    m_wh_p: Array,  # (Wb, Hb) bool — bbox-cropped part mask, zero-padded
    true_whd: Array,  # (3,) int32 true crop extent
    plan_idx: Array,
    plan_dec: Array,
) -> Array:
    Wb, Hb, Db = window.shape
    ix = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 2)
    in_true = (ix < true_whd[0]) & (iy < true_whd[1]) & (iz < true_whd[2])

    # The reference sweeps ONLY this component's occupancy
    # (voxel_carving_utils.py:184-193: occ = labeled == i before the crop) —
    # not everything in the bbox.  Own-component occupancy also makes every
    # window independent of every other window's erasures (a part's carve
    # erases only its own voxels), which the batched path relies on.
    occ = ((compw == comp_id) & in_true).astype(jnp.uint8)
    m2 = jnp.broadcast_to(
        (m_wh_p > 0).astype(jnp.uint8).T[:, :, None], (Hb, Wb, Db)
    ).reshape(Hb, Wb * Db)
    carved = _sweep_padded(occ, m2, (plan_idx, plan_dec))
    erase = (compw == comp_id) & (carved == 0) & in_true
    return jnp.where(erase, jnp.uint8(0), window)


def _guided_window_erase(
    window: Array,
    compw: Array,
    comp_id: Array,
    m_wh_p: Array,
    true_whd: Array,
    plan_idx: Array,
    plan_dec: Array,
) -> Array:
    """Bool erase mask of one window (the carve decision of
    :func:`_guided_window_step`, without applying it)."""
    Wb, Hb, Db = window.shape
    ix = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, (Wb, Hb, Db), 2)
    in_true = (ix < true_whd[0]) & (iy < true_whd[1]) & (iz < true_whd[2])
    occ = ((compw == comp_id) & in_true).astype(jnp.uint8)
    m2 = jnp.broadcast_to(
        (m_wh_p > 0).astype(jnp.uint8).T[:, :, None], (Hb, Wb, Db)
    ).reshape(Hb, Wb * Db)
    carved = _sweep_padded(occ, m2, (plan_idx, plan_dec))
    return (compw == comp_id) & (carved == 0) & in_true


@functools.partial(
    jax.jit, static_argnames=("Wb", "Hb", "Db"), donate_argnums=(0,)
)
def _guided_windows_apply_many(
    grid_b: Array,  # (B, Wp, Hp, Dp) — donated
    starts: Array,  # (K, 4) int32: (scene, x0, y0, z0)
    compws: Array,  # (K, Wb, Hb, Db) int32
    comp_ids: Array,  # (K,) int32 (-1 = padding no-op)
    m_whs: Array,  # (K, Wb, Hb) bool
    true_whds: Array,  # (K, 3) int32
    plan_idxs: Array,
    plan_decs: Array,
    Wb: int,
    Hb: int,
    Db: int,
) -> Array:
    """Many guided windows in ONE dispatch.

    Every window's sweep reads only its own component's occupancy (stale
    labels are exact: no other part/window erases those voxels), so the
    expensive carve decisions are data-parallel — computed vmapped from the
    incoming grid state — and only the cheap erase write-backs run
    sequentially (overlapping windows re-read the current state, so an
    overlap cannot resurrect another window's erasure)."""

    def one(start, compw, comp_id, m_wh, true_whd, pidx, pdec):
        window = jax.lax.dynamic_slice(
            grid_b, (start[0], start[1], start[2], start[3]), (1, Wb, Hb, Db)
        )[0]
        return _guided_window_erase(
            window, compw, comp_id, m_wh, true_whd, pidx, pdec
        )

    erases = jax.vmap(one)(
        starts, compws, comp_ids, m_whs, true_whds, plan_idxs, plan_decs
    )

    def body(i, gb):
        start = starts[i]
        cur = jax.lax.dynamic_slice(
            gb, (start[0], start[1], start[2], start[3]), (1, Wb, Hb, Db)
        )
        new = jnp.where(erases[i][None], jnp.uint8(0), cur)
        return jax.lax.dynamic_update_slice(
            gb, new, (start[0], start[1], start[2], start[3])
        )

    return jax.lax.fori_loop(0, starts.shape[0], body, grid_b)


def _bbox3(occ: np.ndarray):
    """((x0,x1),(y0,y1),(z0,z1)) half-open bbox of True voxels, or None."""
    out = []
    for ax in range(3):
        proj = occ.any(axis=tuple(i for i in range(3) if i != ax))
        nz = np.flatnonzero(proj)
        if nz.size == 0:
            return None
        out.append((int(nz[0]), int(nz[-1]) + 1))
    return out


def _collect_guided_jobs(
    grid_host: np.ndarray,  # (w, h, d) TRUE-extent labels of one scene
    exterior_labels: np.ndarray,
    part_symmetry,
    window_bucket: int,
):
    """Per-scene window jobs (the loop bodies of guided_carve_all /
    _guided_windows_for_part, without applying them).

    Labeling runs on the part's occupied bbox only — identical components
    (face connectivity cannot cross a bbox that contains every part voxel),
    at a fraction of the full-grid labeling cost."""
    from pbr3d.ops.components import _host_scipy_label, _host_component_stats

    jobs = []
    parts = [
        (p, a) for p, a in part_symmetry
        if (exterior_labels == PART_IDS[p]).any()
    ]
    from pbr3d.utils.profiling import prof

    for part, angle in parts:
        target = PART_IDS[part]
        with prof(f"gcj.{part}.eqbbox", sync=False):
            occ = grid_host == target
            bb = _bbox3(occ)
        if bb is None:
            continue
        (X0, X1), (Y0, Y1), (Z0, Z1) = bb
        with prof(f"gcj.{part}.label", sync=False):
            comp_c, n = _host_scipy_label(occ[X0:X1, Y0:Y1, Z0:Z1], "face")
        if n == 0:
            continue
        with prof(f"gcj.{part}.stats", sync=False):
            stats = _host_component_stats(comp_c, n, centroid_axes=())
        mask2d = exterior_labels == target
        for i in range(1, n + 1):
            if stats["count"][i] == 0:
                continue
            # stats are in the crop frame; jobs carry full-frame coords
            x0, y0, z0 = (int(v) + o for v, o in
                          zip(stats["bbox_min"][i], (X0, Y0, Z0)))
            x1, y1, z1 = (int(v) + 1 + o for v, o in
                          zip(stats["bbox_max"][i], (X0, Y0, Z0)))
            w, h, d = x1 - x0, y1 - y0, z1 - z0
            Wb = _round_up(w, window_bucket)
            Hb = _round_up(h, window_bucket)
            Db = _round_up(d, window_bucket)
            compw = np.zeros((Wb, Hb, Db), comp_c.dtype)
            # window content beyond the part bbox is all zeros (no part
            # voxels there by construction), so filling from the crop is
            # exactly the old full-frame fill
            xs = min(X1, x0 + Wb)
            ys = min(Y1, y0 + Hb)
            zs = min(Z1, z0 + Db)
            compw[: xs - x0, : ys - y0, : zs - z0] = comp_c[
                x0 - X0 : xs - X0, y0 - Y0 : ys - Y0, z0 - Z0 : zs - Z0
            ]
            crop2d = mask2d[y0:y1, x0:x1]
            m_wh = np.zeros((Wb, Hb), bool)
            m_wh[:w, :h] = crop2d.T if crop2d.shape == (h, w) else crop2d
            idx, dec = _stacked_plans_padded(w, d, Wb, Db, int(angle))
            jobs.append(dict(
                start=(x0, y0, z0), compw=compw, comp_id=i, m_wh=m_wh,
                true_whd=(w, h, d), idx=idx, dec=dec,
                key=(Wb, Hb, Db, idx.shape[0]),
            ))
    return jobs


#: Per-dispatch window-element budget for the batched guided carve (the
#: vmapped erase phase materializes ~6 window-sized buffers per job).
_GUIDED_BATCH_ELEMS = 1 << 27


def guided_carve_batched(
    grid_b: Array,  # (B, Wp, Hp, Dp) stacked padded scene grids
    scene_jobs: dict,  # scene index -> job list from _collect_guided_jobs
) -> Array:
    """Apply every scene's guided windows in a handful of dispatches.

    Jobs are grouped by (window bucket, rotation count); each group is
    chunked to ``_GUIDED_BATCH_ELEMS`` and padded to a pow2 job count with
    no-op jobs (comp_id=-1 matches nothing), so only a few executables
    exist per bucket shape."""
    flat = []
    for b, jobs in scene_jobs.items():
        for j in jobs:
            flat.append((b, j))
    if not flat:
        return grid_b
    by_key = {}
    for b, j in flat:
        by_key.setdefault(j["key"], []).append((b, j))

    for (Wb, Hb, Db, _), items in sorted(by_key.items()):
        vol = Wb * Hb * Db
        k_chunk = max(1, _GUIDED_BATCH_ELEMS // vol)
        for c0 in range(0, len(items), k_chunk):
            chunk = items[c0 : c0 + k_chunk]
            K = len(chunk)
            Kp = 1 << (K - 1).bit_length()  # pow2 pad -> few executables
            starts = np.zeros((Kp, 4), np.int32)
            compws = np.zeros((Kp, Wb, Hb, Db), chunk[0][1]["compw"].dtype)
            comp_ids = np.full((Kp,), -1, np.int32)
            m_whs = np.zeros((Kp, Wb, Hb), bool)
            true_whds = np.ones((Kp, 3), np.int32)
            idxs = np.stack(
                [j["idx"] for _, j in chunk]
                + [chunk[0][1]["idx"]] * (Kp - K)
            )
            decs = np.stack(
                [j["dec"] for _, j in chunk]
                + [chunk[0][1]["dec"]] * (Kp - K)
            )
            for k, (b, j) in enumerate(chunk):
                starts[k] = (b, *j["start"])
                compws[k] = j["compw"]
                comp_ids[k] = j["comp_id"]
                m_whs[k] = j["m_wh"]
                true_whds[k] = j["true_whd"]
            grid_b = _guided_windows_apply_many(
                grid_b, jnp.asarray(starts), jnp.asarray(compws),
                jnp.asarray(comp_ids), jnp.asarray(m_whs),
                jnp.asarray(true_whds), jnp.asarray(idxs), jnp.asarray(decs),
                Wb, Hb, Db,
            )
    return grid_b


@functools.partial(
    jax.jit, static_argnames=("Wb", "Hb", "Db"), donate_argnums=(0,)
)
def _guided_window_apply(
    grid_p: Array,  # (Wp, Hp, Dp) — donated, updated in place
    start: Array,  # (3,) int32 window origin (TRACED: one program per bucket)
    compw: Array,
    comp_id: Array,
    m_wh_p: Array,
    true_whd: Array,
    plan_idx: Array,
    plan_dec: Array,
    Wb: int,
    Hb: int,
    Db: int,
) -> Array:
    """Slice a window, guided-carve it, write it back — ONE dispatch with the
    window ORIGIN as data, so every component sharing a bucket shape shares
    one executable (eager dynamic_slice bakes concrete starts into fresh
    programs, each a fresh compile)."""
    window = jax.lax.dynamic_slice(grid_p, (start[0], start[1], start[2]), (Wb, Hb, Db))
    new = _guided_window_step(
        window, compw, comp_id, m_wh_p, true_whd, plan_idx, plan_dec
    )
    return jax.lax.dynamic_update_slice(grid_p, new, (start[0], start[1], start[2]))


def _guided_windows_for_part(
    grid_p: Array,
    comp_host: np.ndarray,  # (Wp, Hp, Dp) int32 host component labels
    n: int,
    stats,
    mask2d: np.ndarray,  # (H, W) bool, TRUE extent
    angle: int,
    window_bucket: int,
) -> Array:
    """Apply the per-component window carves given host labeling results."""
    for i in range(1, n + 1):
        if stats["count"][i] == 0:
            continue
        x0, y0, z0 = (int(v) for v in stats["bbox_min"][i])
        x1, y1, z1 = (int(v) + 1 for v in stats["bbox_max"][i])
        w, h, d = x1 - x0, y1 - y0, z1 - z0
        Wb = _round_up(w, window_bucket)
        Hb = _round_up(h, window_bucket)
        Db = _round_up(d, window_bucket)

        # window content MUST come from the live device grid (prior parts'
        # carving applies); the component labels are safely stale (a part's
        # carve only erases its own voxels, reference semantics).  comp_host
        # covers the TRUE extent only; windows reaching into the padding get
        # zero labels there.
        compw = np.zeros((Wb, Hb, Db), comp_host.dtype)
        xs = min(comp_host.shape[0], x0 + Wb)
        ys = min(comp_host.shape[1], y0 + Hb)
        zs = min(comp_host.shape[2], z0 + Db)
        compw[: xs - x0, : ys - y0, : zs - z0] = comp_host[x0:xs, y0:ys, z0:zs]

        crop2d = mask2d[y0:y1, x0:x1]  # (h, w)
        m_wh = np.zeros((Wb, Hb), bool)
        # reference _mask_to_wh precedence: square crops are treated as (H, W)
        m_wh[:w, :h] = crop2d.T if crop2d.shape == (h, w) else crop2d
        idx, dec = _stacked_plans_padded(w, d, Wb, Db, int(angle))

        grid_p = _guided_window_apply(
            grid_p, jnp.asarray([x0, y0, z0], jnp.int32), jnp.asarray(compw),
            jnp.int32(i), jnp.asarray(m_wh), jnp.asarray([w, h, d], jnp.int32),
            jnp.asarray(idx), jnp.asarray(dec), Wb, Hb, Db,
        )
    return grid_p


def guided_carve_all(
    grid_p: Array,
    exterior_labels: np.ndarray,
    part_symmetry,
    window_bucket: int = 32,
) -> Array:
    """Component-guided carving for every part in ``part_symmetry``.

    The padded grid is downloaded ONCE; all component labeling and stats run
    on host (exact scipy, see pbr3d.ops.components).  Only the small
    per-window label crops are uploaded.
    """
    from pbr3d.ops.components import _host_scipy_label, _host_component_stats

    parts = [
        (p, a) for p, a in part_symmetry
        if (exterior_labels == PART_IDS[p]).any()
    ]
    if not parts:
        return grid_p
    # one download; label only the TRUE extent (the padding is empty and the
    # host CPU here is slow enough that array size matters)
    H_img, W_img = exterior_labels.shape
    w, h, d = W_img, H_img, W_img
    grid_host = _scene_get_async(grid_p, 0, w, h, d)()
    for part, angle in parts:
        target = PART_IDS[part]
        comp_true, n = _host_scipy_label(grid_host == target, "face")
        if n == 0:
            continue
        stats = _host_component_stats(comp_true, n, centroid_axes=())
        grid_p = _guided_windows_for_part(
            grid_p, comp_true, n, stats, exterior_labels == target,
            int(angle), window_bucket,
        )
    return grid_p


def guided_carve_fused(
    grid_p: Array,
    exterior_labels: np.ndarray,
    part_name: str,
    angle: int,
    window_bucket: int = 32,
) -> Array:
    """Single-part convenience wrapper over :func:`guided_carve_all`."""
    return guided_carve_all(
        grid_p, exterior_labels, [(part_name, angle)], window_bucket
    )


def _extrude_all_impl(
    grid_p: Array,  # (Wp, Hp, Dp) padded labels
    sem_wh_p: Array,  # (Wp, Hp) full-semantic labels (transposed + padded)
    true_whd: Array,  # (3,) int32
    jobs: Tuple[Tuple[int, int], ...],  # static: (part_id, depth)
) -> Array:
    """All interior extrusions in one program (reference extrude_4dirs x
    parts, voxel_carving_utils.py:356-373), with traced true sizes
    reproducing the reference's boundary behavior (empty columns fill from
    index 0 / size-1)."""
    Wp, Hp, Dp = grid_p.shape
    w, h, d = true_whd[0], true_whd[1], true_whd[2]

    def axis_iota(ax):
        return jax.lax.broadcasted_iota(jnp.int32, (Wp, Hp, Dp), ax)

    ix, iy, iz = axis_iota(0), axis_iota(1), axis_iota(2)
    in_true = (ix < w) & (iy < h) & (iz < d)

    for pid, depth in jobs:
        mask_hw = sem_wh_p.T == pid  # (Hp, Wp)
        for axis, positive in ((2, True), (2, False), (0, True), (0, False)):
            occ = (grid_p > 0) & in_true
            size = d if axis == 2 else w
            it = iz if axis == 2 else ix
            if positive:
                first = jnp.argmax(occ, axis=axis)  # empty columns -> 0 (ref)
            else:
                # reference: start = size-1 - argmax(flipped occupancy)
                # == index of the LAST occupied voxel; empty -> size-1.
                last = (Dp - 1 if axis == 2 else Wp - 1) - jnp.argmax(
                    jnp.flip(occ, axis=axis), axis=axis
                )
                empty = ~jnp.any(occ, axis=axis)
                first = jnp.where(empty, size - 1, last)
            if axis == 2:
                valid = mask_hw.T  # (Wp, Hp)
                coord = iz
                start = first  # (Wp, Hp)
                start_b = start[:, :, None]
                valid_b = valid[:, :, None]
            else:
                valid = mask_hw  # (Hp, Wp) read as (Hp, Dp) — reference quirk
                coord = ix
                start = first  # (Hp, Dp)
                start_b = start[None, :, :]
                valid_b = valid[None, :, :]
            filled = jnp.zeros((Wp, Hp, Dp), bool)
            for k in range(depth):
                pos = start_b + k if positive else start_b - k
                ok = (pos >= 0) & (pos < size) & valid_b
                filled = filled | ((coord == pos) & ok)
            grid_p = jnp.where(filled, jnp.uint8(pid), grid_p)
    return grid_p


_extrude_all = functools.partial(jax.jit, static_argnames=("jobs",))(
    _extrude_all_impl
)


@functools.partial(jax.jit, static_argnames=("jobs",))
def _extrude_all_batched(
    grid_b: Array,  # (B, Wp, Hp, Dp)
    sem_b: Array,  # (B, Wp, Hp)
    true_whd_b: Array,  # (B, 3)
    jobs: Tuple[Tuple[int, int], ...],
) -> Array:
    return jax.vmap(
        lambda g, s, t: _extrude_all_impl(g, s, t, jobs)
    )(grid_b, sem_b, true_whd_b)


def recolor_back_host(
    g: np.ndarray,  # (d, h, w) uint8, ALREADY reoriented, host; edited in place
    k: int = 2,
    sort_axis: int = 0,
) -> np.ndarray:
    """Back-minaret recolor of an already-reoriented grid (reference
    voxel_carving_utils.py:252-266): all but the ``k`` front-most
    front_minaret components become back_minarets.  Labeling runs on the
    part's occupied bbox only (identical components, ~10x less host work —
    the minarets are thin columns)."""
    from pbr3d.ops.components import _host_scipy_label, _host_component_stats

    from pbr3d.utils.profiling import prof

    with prof("rbh.copy", sync=False):
        if not g.flags.writeable:  # np.asarray of a jax array can be read-only
            g = g.copy()
    pid = PART_IDS["front_minarets"]
    new_pid = PART_IDS["back_minarets"]
    with prof("rbh.eqbbox", sync=False):
        occ = g == pid
        bb = _bbox3(occ)
    if bb is None:
        return g
    (X0, X1), (Y0, Y1), (Z0, Z1) = bb
    with prof("rbh.label", sync=False):
        comp, n = _host_scipy_label(occ[X0:X1, Y0:Y1, Z0:Z1], "face")
    if n <= k:
        return g
    with prof("rbh.stats", sync=False):
        stats = _host_component_stats(comp, n, centroid_axes=(sort_axis,))
    # crop-frame centroids: the constant bbox offset does not change the
    # front-most ranking along sort_axis
    means = stats["centroid"][1 : n + 1, sort_axis]
    keep = set((np.argsort(means, kind="stable")[:k] + 1).tolist())
    recolor_ids = np.array([i for i in range(1, n + 1) if i not in keep], np.int32)
    sub = g[X0:X1, Y0:Y1, Z0:Z1]
    sub[np.isin(comp, recolor_ids)] = new_pid
    return g


def reorient_recolor_host(
    grid_true: np.ndarray,  # (w, h, d) uint8, TRUE extent, host
    k: int = 2,
    sort_axis: int = 0,
) -> np.ndarray:
    """The persistent transpose(2,1,0)+flip(1) reorientation followed by the
    back-minaret recolor (reference voxel_carving_utils.py:252-266,383-393),
    entirely on host (production paths reorient on device before the
    download and call :func:`recolor_back_host` directly)."""
    g = np.flip(np.transpose(grid_true, (2, 1, 0)), axis=1).copy()
    return recolor_back_host(g, k, sort_axis)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _scene_crop(grid, i, w, h, d, reorient):
    """Scene-select + true-extent crop (+ optional reorient) in ONE program
    (the eager ``grid_b[i, :w, :h, :d]`` spelling compiles separate
    squeeze / dynamic_slice programs per scene shape)."""
    if grid.ndim == 4:
        g = jax.lax.dynamic_slice(grid, (i, 0, 0, 0), (1, w, h, d))[0]
    else:
        g = jax.lax.slice(grid, (0, 0, 0), (w, h, d))
    if reorient:
        g = jnp.flip(jnp.transpose(g, (2, 1, 0)), 1)
    return g


def _scene_get_async(grid, i, w, h, d, reorient=False):
    """Start the download of one scene's true-extent crop without blocking;
    returns a zero-arg resolver producing the host array.  A caller that
    starts scenes 1..N and then resolves them in order overlaps each
    scene's host work with the next scenes' transfers."""
    crop = _scene_crop(grid, np.int32(i), w, h, d, reorient)
    crop.copy_to_host_async()
    return lambda: np.asarray(crop)


def carve_monument_fused(
    mask_set,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    bucket: int = 64,
    guided_margin: int = 64,
) -> np.ndarray:
    """Full stage 1, program-count-minimized.  Returns the uint8 label grid
    (host numpy, true extent, reoriented frame — identical to
    :func:`pbr3d.carving.stage1.carve_monument`)."""
    binary = mask_set.binary  # (h, w)
    ext = mask_set.exterior_labels
    sem = mask_set.semantic_labels
    h, w = binary.shape
    d = w
    # pad masks to the bucketed extent + guided-carve window margin.  The
    # margin only has to keep window slices in bounds: a bbox rounded up to
    # the 32-voxel window bucket overshoots its grid edge by at most 31, so
    # 64 is safe — and 128 inflated the 256-scale batch past the memory
    # budget, silently demoting carve_monuments_batched to the serial path
    # (and every sweep to 1.7x the voxels).
    Wb = _round_up(w + guided_margin, bucket)
    Hb = _round_up(h + guided_margin, bucket)
    Db = Wb

    def pad_wh(m):
        out = np.zeros((Wb, Hb), m.dtype)
        out[:w, :h] = m.T
        return out

    group_ids = tuple(
        tuple(int(i) for i in config.part_ids(names))
        for names, angle in preset.group_jobs
    )
    angles = {angle for _, angle in preset.group_jobs}
    if angles != {preset.global_angle_interval}:
        raise NotImplementedError(
            "fused stage 1 assumes group angles == global angle; "
            "use pbr3d.carving.stage1.carve_monument for exotic presets"
        )
    idx, dec = _stacked_plans_padded(w, d, Wb, Db, preset.global_angle_interval)
    true_whd = jnp.asarray([w, h, d], jnp.int32)

    grid_p = _global_and_part_carve(
        jnp.asarray(pad_wh(binary)), jnp.asarray(pad_wh(ext)), true_whd,
        jnp.asarray(idx), jnp.asarray(dec), group_ids,
    )

    grid_p = guided_carve_all(grid_p, ext, preset.part_symmetry)

    jobs = tuple((PART_IDS[p], int(depth)) for p, depth in preset.extrusion_depths)
    if jobs:
        grid_p = _extrude_all(grid_p, jnp.asarray(pad_wh(sem)), true_whd, jobs)

    if preset.recolor_back_minarets:
        return recolor_back_host(
            _scene_get_async(grid_p, 0, w, h, d, True)()
        )
    return _scene_get_async(grid_p, 0, w, h, d)()  # final download


#: Stage-1 memory budgets where the backend reports no allocator limit (the
#: CPU backend the tests run on): the batched sweep's working set, and two
#: concurrent per-scene working sets in the serial fallback.
CPU_STAGE1_BATCH_BYTES = 6 << 30
CPU_STAGE1_THREADS_BYTES = 12 << 30
#: Shares of the device allocator limit for the same two budgets.
STAGE1_BATCH_SHARE = 0.25
STAGE1_THREADS_SHARE = 0.5


def _batched_sweep_budget(whd_values, bucket: int, guided_margin: int):
    """(Wb, Hb, Db, bytes-per-scene) for the batched sweep working set
    (~6 int32-equivalent buffers of (Hb, Wb*Db)).  Factored out so tests can
    assert the 256-scale batch stays UNDER the default budget — round 2
    shipped with a margin that silently demoted every bench run to the
    serial fallback."""
    whd_values = list(whd_values)
    Wb = _round_up(max(w for w, _, _ in whd_values) + guided_margin, bucket)
    Hb = _round_up(max(h for _, h, _ in whd_values) + guided_margin, bucket)
    Db = Wb
    return Wb, Hb, Db, 6 * 4 * Wb * Hb * Db


def carve_monuments_batched(
    mask_sets: dict,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    bucket: int = 64,
    guided_margin: int = 64,
    mem_budget_bytes: int | None = None,
    on_grid=None,
    mesh=None,
) -> dict:
    """Stage 1 for MANY monuments with the big sweeps batched (SURVEY §7 M6).

    All scenes are padded to one common bucket; the global+group carve and
    the interior extrusion each run as ONE vmapped program over the scene
    batch (one dispatch, one compile, instead of one per monument).  The
    component-guided carve stays per-monument (host connected-components labeling, see
    guided_carve_all), but its window programs are shared across scenes.

    ``mesh`` — optional ("scene",) device mesh
    (:func:`pbr3d.parallel.sharding.scene_only_mesh`): the stacked scene
    inputs are placed with the batch axis sharded across devices, so the
    vmapped sweep/extrusion programs run data-parallel with zero
    communication (run_all passes this whenever >1 device is visible;
    outputs are unchanged — asserted by tests/test_parallel.py).

    Outputs are bit-identical to :func:`carve_monument_fused` per monument
    (padding-independence of the embedded rotation plans).  Falls back to the
    serial path when the padded batch would exceed ``mem_budget_bytes`` of
    sweep working set (default: ``STAGE1_BATCH_SHARE`` of the device
    allocator limit, ``CPU_STAGE1_BATCH_BYTES`` on a backend without one).

    ``mask_sets``: {monument: MaskSet}.  Returns {monument: label grid}.
    """
    names = list(mask_sets)
    if not names:
        return {}
    whd = {m: (mask_sets[m].binary.shape[1], mask_sets[m].binary.shape[0],
               mask_sets[m].binary.shape[1]) for m in names}
    Wb, Hb, Db, est = _batched_sweep_budget(
        whd.values(), bucket, guided_margin
    )
    B = len(names)
    from pbr3d.utils.runtime import memory_budget

    if mem_budget_bytes is None:
        mem_budget_bytes = memory_budget(
            STAGE1_BATCH_SHARE, CPU_STAGE1_BATCH_BYTES)
    if est * B > mem_budget_bytes:
        # Per-monument fallback.  Two worker threads pipeline the scenes:
        # scene i's host phases (guided-CC labeling, recolor, downloads)
        # overlap scene i+1's device sweeps.  Device memory peaks at ~2
        # sweep working sets, so thread only when that fits the budget.
        from concurrent.futures import ThreadPoolExecutor

        threads_budget = memory_budget(
            STAGE1_THREADS_SHARE, CPU_STAGE1_THREADS_BYTES)
        workers = 2 if (B > 1 and 2 * est <= threads_budget) else 1
        out = {}
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = {
                m: ex.submit(carve_monument_fused, mask_sets[m], preset)
                for m in names
            }
            for m in names:
                out[m] = futs[m].result()
                if on_grid is not None:
                    on_grid(m, out[m])
        return out

    angles = {angle for _, angle in preset.group_jobs}
    if angles != {preset.global_angle_interval}:
        raise NotImplementedError(
            "fused stage 1 assumes group angles == global angle; "
            "use pbr3d.carving.stage1.carve_monument for exotic presets"
        )
    group_ids = tuple(
        tuple(int(i) for i in config.part_ids(ns)) for ns, _ in preset.group_jobs
    )

    def pad_wh(m):
        h, w = m.shape
        out = np.zeros((Wb, Hb), m.dtype)
        out[:w, :h] = m.T
        return out

    binary_b = np.stack([pad_wh(mask_sets[m].binary) for m in names])
    ext_b = np.stack([pad_wh(mask_sets[m].exterior_labels) for m in names])
    sem_b = np.stack([pad_wh(mask_sets[m].semantic_labels) for m in names])
    true_b = np.array([whd[m] for m in names], np.int32)
    plans = [
        _stacked_plans_padded(w, d, Wb, Db, preset.global_angle_interval)
        for w, _, d in (whd[m] for m in names)
    ]
    idx_b = np.stack([p[0] for p in plans])
    dec_b = np.stack([p[1] for p in plans])

    from pbr3d.utils.profiling import prof

    if mesh is not None and binary_b.shape[0] % mesh.shape["scene"] == 0:
        from pbr3d.parallel.sharding import shard_batch_leading

        binary_b, ext_b, sem_b, true_b, idx_b, dec_b = (
            shard_batch_leading(a, mesh)
            for a in (binary_b, ext_b, sem_b, true_b, idx_b, dec_b)
        )

    with prof("stage1.sweep"):
        grid_b = _global_and_part_carve_batched(
            jnp.asarray(binary_b), jnp.asarray(ext_b), jnp.asarray(true_b),
            jnp.asarray(idx_b), jnp.asarray(dec_b), group_ids,
        )

    # Component-guided carving, batched: host-label each scene's parts from
    # one true-extent download, then apply ALL scenes' windows in a few
    # grouped dispatches (every window commutes — see guided_carve_batched).
    scene_jobs = {}
    with prof("stage1.guided_collect"):
        # prefetch every scene, then resolve in order: scene i's host
        # labeling overlaps scenes i+1..'s transfers
        resolvers = {}
        for i, m in enumerate(names):
            w, h, d = whd[m]
            resolvers[i] = _scene_get_async(grid_b, i, w, h, d)
        for i, m in enumerate(names):
            with prof(f"stage1.guided_collect.get.{m}", sync=False):
                host = resolvers[i]()
            with prof(f"stage1.guided_collect.label.{m}", sync=False):
                scene_jobs[i] = _collect_guided_jobs(
                    host, mask_sets[m].exterior_labels,
                    preset.part_symmetry, 32
                )
    with prof("stage1.guided_apply"):
        grid_b = guided_carve_batched(grid_b, scene_jobs)

    jobs = tuple((PART_IDS[p], int(depth)) for p, depth in preset.extrusion_depths)
    if jobs:
        with prof("stage1.extrude"):
            grid_b = _extrude_all_batched(
                grid_b, jnp.asarray(sem_b), jnp.asarray(true_b), jobs
            )
    out = {}
    with prof("stage1.download_reorient"):
        # same prefetch-then-resolve pipelining as guided_collect: scene
        # i's recolor CC overlaps scenes i+1..'s downloads
        final_res = {}
        for i, m in enumerate(names):
            w, h, d = whd[m]
            final_res[m] = _scene_get_async(
                grid_b, i, w, h, d, preset.recolor_back_minarets
            )
        for m in names:
            with prof(f"stage1.final.get.{m}", sync=False):
                true_m = final_res[m]()
            with prof(f"stage1.final.recolor.{m}", sync=False):
                out[m] = (
                    recolor_back_host(true_m)
                    if preset.recolor_back_minarets else true_m
                )
            if on_grid is not None:
                # let the caller start per-scene downstream work (e.g.
                # stage-2 host prep) while the remaining scenes finalize
                on_grid(m, out[m])
    return out
