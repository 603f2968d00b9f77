"""Mask-IoU camera refinement — the device replacement for the
reference's interactive "smart aligner" (utils/camera_estimation.py:479-768).

The reference maximizes mean per-part color-exact IoU between the splat
projection and the selected-parts mask with human-triggered Random Search /
Coordinate Descent / Powell, one 86 ms objective evaluation at a time.  Here
the ENTIRE search runs as one compiled device program (``lax.scan`` over
generations, ``jax.random`` for proposals, a vmapped splat+IoU objective per
candidate), so a whole view costs a single dispatch instead of one per
generation:

  1. random-search generations with the reference's step sizes
     (cam +-[50,50,100], target +-[50,50,100], f +-50, cx/cy +-20),
     shrinking 0.7x after 3 stagnant generations, frozen after 4 shrinks
     (the host-loop early-stop, expressed as a no-op state update);
  2. scanned coordinate-descent polish (all +-delta probes of all 9 DoF per
     round, delta halved on failure, annealed from the reference's fixed 20);
  3. optional ``lock_xy_equal`` tying cam x/y to target x/y.

Deterministic given the seed.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d import config
from pbr3d.camera.geometry import params_to_vector, vector_to_params
from pbr3d.carving.voxel import (
    bucket_size,
    pad_points,
    points_by_parts,
    surface_points_by_parts,
)
from pbr3d.ops.projection import (
    partwise_iou,
    splat_labels,
    splat_partwise_iou_mm,
)

#: Reference step sizes (camera_estimation.py:605-616).
_STEPS0 = np.array([50, 50, 100, 50, 50, 100, 50, 20, 20], np.float32)

#: Plane-size ceiling for the one-hot matmul objective inside search
#: interiors.  Its cost is 2·K·N·H·W MACs per candidate, growing with the
#: plane, while the scatter splat's cost does not; above this size (native
#: polish planes) the scatter path stays.
_MM_PLANE_MAX = 1 << 18


def _candidate_iou(x, pts, labels, valid, gt_labels, part_ids, true_hw, H, W,
                   mm: bool = False):
    if mm:
        return splat_partwise_iou_mm(
            pts, labels, valid, x[0:3], x[3:6], x[6], x[7], x[8],
            gt_labels, part_ids, H, W, true_hw,
        )[1]
    img = splat_labels(
        pts, labels, valid, x[0:3], x[3:6], x[6], x[7], x[8], H, W, true_hw
    )
    return partwise_iou(img, gt_labels, part_ids)[1]


def _batch_iou_impl(cam_vecs, pts, labels, valid, gt_labels, part_ids, true_hw,
                    H: int, W: int, mm: bool = False):
    return jax.vmap(
        lambda x: _candidate_iou(x, pts, labels, valid, gt_labels, part_ids,
                                 true_hw, H, W, mm)
    )(cam_vecs)


@functools.partial(jax.jit, static_argnames=("H", "W"))
def _batch_iou(cam_vecs, pts, labels, valid, gt_labels, part_ids, true_hw,
               H: int, W: int):
    """(H, W) is the padded plane allocation; ``true_hw`` the real extent —
    only bucketed shapes reach the compiler (compiles are expensive here)."""
    return _batch_iou_impl(cam_vecs, pts, labels, valid, gt_labels, part_ids,
                           true_hw, H, W)


def _search_impl(
    seed: jax.Array,  # scalar int32
    init_vec: jax.Array,  # (9,) f32
    pts, labels, valid, gt_labels, part_ids, true_hw,
    H: int, W: int,
    generations: int, population: int, cd_rounds: int,
    lock_xy_equal: bool, pop_chunk: int,
    step_scale: jax.Array | float = 1.0,  # scales all proposal steps
    mm: bool = False,  # one-hot matmul objective (see splat_partwise_iou_mm)
    cd_mags: Tuple[float, ...] = (1.0,),  # multi-scale CD probe magnitudes
) -> Tuple[jax.Array, jax.Array]:
    """Full random-search + coordinate-descent refinement in ONE program.

    ``pop_chunk`` bounds the candidates evaluated concurrently (device
    memory: each candidate materializes a handful of N-length projection
    intermediates); populations larger than it are scanned with ``lax.map``.
    """

    def lock(c):
        return c.at[:, 0:2].set(c[:, 3:5]) if lock_xy_equal else c

    def eval_batch(vecs):
        ev = lambda b: _batch_iou_impl(
            b, pts, labels, valid, gt_labels, part_ids, true_hw, H, W, mm
        )
        P = vecs.shape[0]
        if P > pop_chunk:
            pad = (-P) % pop_chunk
            if pad:  # static-shape pad with repeats of the last row
                vecs = jnp.concatenate(
                    [vecs, jnp.broadcast_to(vecs[-1], (pad, 9))]
                )
            out = jax.lax.map(ev, vecs.reshape(-1, pop_chunk, 9)).reshape(-1)
            return out[:P]
        return ev(vecs)

    init_iou = eval_batch(init_vec[None])[0]

    def gen_step(carry, key):
        best, biou, steps, stall, shrinks = carry
        alive = shrinks < 4  # the host loop broke after 4 shrinks
        u = jax.random.uniform(key, (population, 9), jnp.float32, -1.0, 1.0)
        cand = lock(best[None] + u * steps[None])
        ious = eval_batch(cand)
        i = jnp.argmax(ious)
        imp = (ious[i] > biou) & alive
        best = jnp.where(imp, cand[i], best)
        biou = jnp.where(imp, ious[i], biou)
        stall = jnp.where(imp, 0, stall + jnp.int32(alive))
        do_shrink = (stall >= 3) & alive
        steps = jnp.where(do_shrink, steps * 0.7, steps)
        shrinks = shrinks + jnp.int32(do_shrink)
        stall = jnp.where(do_shrink, 0, stall)
        return (best, biou, steps, stall, shrinks), None

    keys = jax.random.split(jax.random.PRNGKey(seed), generations)
    carry = (init_vec, init_iou, jnp.asarray(_STEPS0) * step_scale,
             jnp.int32(0), jnp.int32(0))
    (best, biou, *_), _ = jax.lax.scan(gen_step, carry, keys)

    # coordinate descent: all +-delta probes of the 9 DoF in one batch.
    # ``cd_mags`` widens each round to per-DoF probes at several magnitudes
    # of the annealed delta in the SAME batch (e.g. (1, .25, 4) gives the
    # quarter-step resolution and a Powell-style extension without extra
    # dispatches); the default (1.0,) is exactly the classic schedule.
    offs = jnp.concatenate([jnp.eye(9, dtype=jnp.float32),
                            -jnp.eye(9, dtype=jnp.float32)])
    mags = jnp.asarray(np.asarray(cd_mags, np.float32))

    def cd_step(carry, _):
        best, biou, delta = carry
        probes = lock(
            (best[None, None]
             + offs[None] * (delta * mags)[:, None, None]).reshape(-1, 9)
        )
        ious = eval_batch(probes)
        i = jnp.argmax(ious)
        imp = ious[i] > biou
        best = jnp.where(imp, probes[i], best)
        biou = jnp.where(imp, ious[i], biou)
        delta = jnp.where(imp, delta, delta * 0.5)
        return (best, biou, delta), None

    (best, biou, _), _ = jax.lax.scan(
        cd_step, (best, biou, jnp.float32(20.0) * step_scale), None,
        length=cd_rounds
    )
    return best, biou


_search_device = functools.partial(
    jax.jit,
    static_argnames=(
        "H", "W", "generations", "population", "cd_rounds", "lock_xy_equal",
        "pop_chunk", "mm", "cd_mags",
    ),
)(_search_impl)


@functools.partial(
    jax.jit,
    static_argnames=(
        "H", "W", "generations", "population", "cd_rounds", "lock_xy_equal",
        "pop_chunk", "mm", "cd_mags",
    ),
)
def _search_device_multi(
    seeds: jax.Array,  # (V,) int32
    init_vecs: jax.Array,  # (V, 9)
    pts,  # (V, N, 3)
    labels,  # (V, N)
    valid,  # (V, N)
    gt_labels,  # (V, Hp, Wp)
    part_ids,  # (K,) — shared across views
    true_hw,  # (V, 2)
    step_scales,  # (V,) f32 — per-view proposal-step scale
    H: int, W: int,
    generations: int, population: int, cd_rounds: int,
    lock_xy_equal: bool, pop_chunk: int,
    mm: bool = False,
    cd_mags: Tuple[float, ...] = (1.0,),
):
    """All V views' searches in ONE program (SURVEY §7 M6 for stage 2):
    views padded to a common point bucket and plane bucket, vmapped over the
    view axis — one dispatch and one executable per (plane, point) bucket
    pair instead of one per view."""
    return jax.vmap(
        lambda s, x, p, l, v, g, t, sc: _search_impl(
            s, x, p, l, v, g, part_ids, t, H, W,
            generations, population, cd_rounds, lock_xy_equal, pop_chunk, sc,
            mm, cd_mags,
        )
    )(seeds, init_vecs, pts, labels, valid, gt_labels, true_hw, step_scales)


def _pad_plane(mask_labels: np.ndarray, to_hw: Tuple[int, int] | None = None):
    H, W = mask_labels.shape[:2]
    if to_hw is None:
        Hp, Wp = (-(-x // 128) * 128 for x in (H, W))
    else:
        Hp, Wp = to_hw
    out = np.zeros((Hp, Wp), mask_labels.dtype)
    out[:H, :W] = mask_labels
    return out, (Hp, Wp)


def refine_cameras_batched(
    jobs: Dict,
    *,
    generations: int = 40,
    population: int = 64,
    cd_rounds: int = 6,
    seed: int = 0,
    lock_xy_equal: bool = False,
    coarse_stride: int = 2,
    polish: bool = True,
    point_cap: int = 32768,
    plane_cap: int = 160_000,
    shard_devices: bool = False,
    cd_mags: Tuple[float, ...] = (1.0,),
) -> Dict:
    # per-job dict may carry "step_scale" (default 1.0): proposal-step
    # multiplier for searches whose init sits at a larger world scale than
    # the reference's absolute step sizes assume
    """All views' mask-IoU camera refinements with cross-view batching.

    ``jobs``: key -> dict(grid_labels=..., mask_labels=..., parts=[...],
    init_params=..., points=optional precomputed (pts, labels) shell).
    Returns key -> (params, best_iou) like :func:`refine_camera_mask_iou`.

    Structure (SURVEY §7 M6 applied to stage 2):

    1. per view, choose a coarse factor s ∈ {1, 2, 4} so the search plane
       stays ≤ ~160k px (candidate cost is linear in plane pixels);
    2. pad every view's strided shell to ONE shared point bucket and group
       views by coarse-plane bucket; run each group's ENTIRE random search
       as one vmapped device program (``_search_device_multi``) — one
       dispatch per group instead of one per view;
    3. enqueue every view's native-resolution coordinate-descent polish
       (full shell, generations=0) back-to-back WITHOUT blocking between
       them — the device queue hides the per-dispatch latency —
       then collect.
    """
    keys = list(jobs)
    prep = {}
    for k in keys:
        j = jobs[k]
        mask = np.asarray(j["mask_labels"])
        H, W = mask.shape[:2]
        if j.get("points") is not None:
            pts, labels = j["points"]
        else:
            pts, labels = surface_points_by_parts(j["grid_labels"], j["parts"])
        sel = mask_labels_selected(mask, j["parts"])
        s = 1
        while (H // s) * (W // s) > plane_cap and s < 8:
            s *= 2
        init = dict(j["init_params"])
        for f in ("f", "cx", "cy"):
            init[f] = float(init[f]) / s
        prep[k] = dict(
            pts=pts, labels=labels, sel=sel, s=s, H=H, W=W,
            coarse_mask=sel[::s, ::s], init=init,
            part_ids=np.asarray(config.part_ids(j["parts"])),
        )

    # ---- phase 1: grouped coarse random search ----
    # per-view stride: at least ``coarse_stride``, and enough to keep every
    # strided shell <= ``point_cap`` points (candidate cost is linear in
    # points)
    for p in prep.values():
        p["stride"] = max(coarse_stride, -(-len(p["pts"]) // point_cap))
        p["bucket"] = bucket_size(len(p["pts"][:: p["stride"]]))
    # group by (plane bucket, point bucket): views in a group share one
    # program AND pay only their own size class
    groups: Dict[Tuple[Tuple[int, int], int], list] = {}
    for k in keys:
        cm = prep[k]["coarse_mask"]
        hw = tuple(-(-x // 128) * 128 for x in cm.shape[:2])
        groups.setdefault((hw, prep[k]["bucket"]), []).append(k)

    from pbr3d.utils.profiling import prof

    coarse_best: Dict = {}
    pending = []
    for ((Hp, Wp), B), gkeys in groups.items():
        V = len(gkeys)
        pts_b = np.zeros((V, B, 3), np.float32)
        lab_b = np.zeros((V, B), np.uint8)
        val_b = np.zeros((V, B), bool)
        gt_b = np.zeros((V, Hp, Wp), np.uint8)
        thw_b = np.zeros((V, 2), np.int32)
        iv_b = np.zeros((V, 9), np.float32)
        sc_b = np.ones((V,), np.float32)
        for i, k in enumerate(gkeys):
            p = prep[k]
            sub = p["pts"][:: p["stride"]]
            lab = p["labels"][:: p["stride"]]
            pts_b[i, : len(sub)] = sub
            lab_b[i, : len(sub)] = lab
            val_b[i, : len(sub)] = True
            cm = p["coarse_mask"]
            gt_b[i, : cm.shape[0], : cm.shape[1]] = cm
            thw_b[i] = cm.shape[:2]
            iv_b[i] = params_to_vector(p["init"])
            sc_b[i] = jobs[k].get("step_scale", 1.0)
        # one-hot matmul objective for coarse planes (see
        # splat_partwise_iou_mm).  Its per-candidate working set is
        # the (N, Hp)+(N, Wp) int8 one-hots, so the chunk budget switches
        # from point-count to one-hot bytes.
        mm = Hp * Wp <= _MM_PLANE_MAX
        if mm:
            pop_chunk = max(
                1, min(population, (1 << 29) // max(1, B * (Hp + Wp) * V))
            )
        else:
            pop_chunk = max(1, min(population, (1 << 26) // max(1, B * V)))
        pop_chunk = 1 << (pop_chunk.bit_length() - 1)
        pop = max(pop_chunk, (population // pop_chunk) * pop_chunk)
        seeds_b = np.full((V,), seed, np.int32)
        args = [seeds_b, iv_b, pts_b, lab_b, val_b, gt_b]
        if shard_devices and len(jax.devices()) > 1:
            # Data-parallel over the view axis: each device runs its share
            # of the group's searches (zero communication — searches are
            # independent).  Outputs are unchanged; per-view programs are
            # deterministic given the seed.
            from pbr3d.parallel.sharding import (
                scene_only_mesh, shard_batch_leading,
            )

            mesh = scene_only_mesh(V)
            if mesh is not None:
                args = [shard_batch_leading(a, mesh) for a in args]
        with prof(f"rcb.group V={V} B={B} hw={Hp}x{Wp} mm={int(mm)} "
                  f"chunk={pop_chunk} pop={pop}", sync=False):
            out = _search_device_multi(
                jnp.asarray(args[0]),
                jnp.asarray(args[1]), jnp.asarray(args[2]),
                jnp.asarray(args[3]),
                jnp.asarray(args[4]), jnp.asarray(args[5]),
                jnp.asarray(prep[gkeys[0]]["part_ids"]),
                jnp.asarray(thw_b), jnp.asarray(sc_b),
                Hp, Wp, generations, pop, 0, lock_xy_equal, pop_chunk,
                mm,
            )
        pending.append((gkeys, out))
    # collect (blocks; all groups were already enqueued)
    coarse_iou: Dict = {}
    for gkeys, (best, biou) in pending:
        with prof(f"rcb.collect {gkeys[0]}..x{len(gkeys)}"):
            best = np.asarray(best, np.float64)
            biou = np.asarray(biou, np.float64)
        for i, k in enumerate(gkeys):
            s = prep[k]["s"]
            vec = best[i].copy()
            vec[6:9] *= s  # f, cx, cy back to native pixels
            coarse_best[k] = vec
            coarse_iou[k] = float(biou[i])

    if not polish:
        # coarse-only mode: rank-quality results without the native CD
        # polish (used to triage second-start families cheaply; the IoU is
        # measured at the coarse resolution — comparable across starts of
        # the same view)
        out = {}
        for k in keys:
            p = prep[k]
            params = vector_to_params(coarse_best[k], H=p["H"], W=p["W"])
            out[k] = (
                {
                    "cam_pos": np.asarray(params["cam_pos"], np.float64),
                    "target": np.asarray(params["target"], np.float64),
                    "f": float(params["f"]),
                    "cx": float(params["cx"]),
                    "cy": float(params["cy"]),
                    "H": p["H"],
                    "W": p["W"],
                },
                coarse_iou[k],
            )
        return out

    # ---- phase 2: native-resolution CD polish, all enqueued async ----
    results = {}
    polish = []
    for k in keys:
        p = prep[k]
        pp, ll, vv = pad_points(p["pts"], p["labels"], bucket_size(len(p["pts"])))
        gt_p, (Hp, Wp) = _pad_plane(p["sel"])
        pop_chunk = max(1, min(population, (1 << 26) // max(1, pp.shape[0])))
        pop_chunk = 1 << (pop_chunk.bit_length() - 1)
        # np scalar/array args: dtype conversions happen on HOST (an eager
        # jnp.int32()/jnp.asarray(x, dtype) each compiles a one-off remote
        # program per process; device_put of a ready np array compiles none)
        out = _search_device(
            np.int32(seed),
            jnp.asarray(np.asarray(coarse_best[k], np.float32)),
            jnp.asarray(pp), jnp.asarray(ll), jnp.asarray(vv),
            jnp.asarray(gt_p),
            jnp.asarray(p["part_ids"]),
            jnp.asarray(np.asarray([p["H"], p["W"]], np.int32)),
            Hp, Wp, 0, pop_chunk, cd_rounds, lock_xy_equal, pop_chunk,
            np.float32(jobs[k].get("step_scale", 1.0)), False,
            tuple(cd_mags),
        )
        polish.append((k, out))
    for k, (best, biou) in polish:
        p = prep[k]
        best = np.asarray(best, np.float64)
        params = vector_to_params(best, H=p["H"], W=p["W"])
        results[k] = (
            {
                "cam_pos": np.asarray(params["cam_pos"], np.float64),
                "target": np.asarray(params["target"], np.float64),
                "f": float(params["f"]),
                "cx": float(params["cx"]),
                "cy": float(params["cy"]),
                "H": p["H"],
                "W": p["W"],
            },
            float(np.asarray(biou)),
        )
    return results


def evaluate_camera_iou(
    grid_labels: np.ndarray,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    cam: Dict,
) -> float:
    """Mean per-part IoU of the splat projection under one camera —
    the reference's ``evaluate`` objective (camera_estimation.py:597-603)."""
    H, W = mask_labels.shape[:2]
    pts, labels = points_by_parts(grid_labels, parts_for_alignment)
    p, l, v = pad_points(pts, labels, bucket_size(len(pts)))
    gt_p, (Hp, Wp) = _pad_plane(mask_labels_selected(mask_labels, parts_for_alignment))
    ious = _batch_iou(
        params_to_vector(cam)[None],
        jnp.asarray(p), jnp.asarray(l), jnp.asarray(v),
        jnp.asarray(gt_p),
        jnp.asarray(config.part_ids(parts_for_alignment)),
        jnp.asarray([H, W], jnp.int32),
        Hp, Wp,
    )
    return float(ious[0])


def mask_labels_selected(mask_labels: np.ndarray, parts: Sequence[str]) -> np.ndarray:
    """Zero out non-selected parts (the aligner compares against the
    selected-parts mask, reference: camera_estimation.py:489)."""
    ids = config.part_ids(parts)
    return np.where(np.isin(mask_labels, ids), mask_labels, 0).astype(np.uint8)


#: Image planes with more pixels than this run their random-search
#: generations at half resolution (the candidate objective is plane-bound:
#: per-candidate splat + IoU histograms cost O(H*W)).  The result is then
#: polished by coordinate descent at NATIVE resolution, and the saved params
#: are the native-resolution optimum.  f/cx/cy live in pixel units and scale
#: linearly with the image; cam_pos/target are world-space and do not.
_COARSE_PLANE_PIXELS = 512 * 512


def refine_camera_mask_iou(
    grid_labels: np.ndarray,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    init_params: Dict,
    *,
    generations: int = 40,
    population: int = 64,
    cd_rounds: int = 6,
    seed: int = 0,
    lock_xy_equal: bool = False,
    step_scale: float = 1.0,
    cd_mags: Tuple[float, ...] = (1.0,),
    _allow_coarse: bool = True,
) -> Tuple[Dict, float]:
    """Automated mask-IoU camera refinement.  Returns (params, best IoU).

    The returned params include H/W like the reference's saved "final" tag
    (camera_estimation.py:536-541).
    """
    H, W = mask_labels.shape[:2]

    if _allow_coarse and H * W > _COARSE_PLANE_PIXELS:
        # Random-search at half resolution (4x cheaper per candidate), then
        # native-resolution coordinate descent from the upscaled optimum.
        half_init = dict(init_params)
        for k in ("f", "cx", "cy"):
            half_init[k] = float(init_params[k]) / 2.0
        half, _ = refine_camera_mask_iou(
            grid_labels, mask_labels[::2, ::2], parts_for_alignment, half_init,
            generations=generations, population=population, cd_rounds=cd_rounds,
            seed=seed, lock_xy_equal=lock_xy_equal, step_scale=step_scale,
            cd_mags=cd_mags, _allow_coarse=False,
        )
        native_init = {
            "cam_pos": half["cam_pos"],
            "target": half["target"],
            "f": half["f"] * 2.0,
            "cx": half["cx"] * 2.0,
            "cy": half["cy"] * 2.0,
        }
        return refine_camera_mask_iou(
            grid_labels, mask_labels, parts_for_alignment, native_init,
            generations=0, population=population, cd_rounds=cd_rounds,
            seed=seed, lock_xy_equal=lock_xy_equal, step_scale=step_scale,
            cd_mags=cd_mags, _allow_coarse=False,
        )

    # Surface shell, not the solid: identical silhouettes (rays enter through
    # the shell), and it keeps the per-candidate segment reductions small.
    pts, labels = surface_points_by_parts(grid_labels, parts_for_alignment)
    p, l, v = map(jnp.asarray, pad_points(pts, labels, bucket_size(len(pts))))
    gt_p, (Hp, Wp) = _pad_plane(mask_labels_selected(mask_labels, parts_for_alignment))

    # Bound per-eval device memory: each concurrent candidate materializes a
    # handful of N-length projection intermediates (~25 B/point -> ~1.7 GB at
    # this budget).  Bigger concurrent batches only help until the ALUs are
    # saturated; beyond that they just raise peak memory.
    pop_chunk = max(1, min(population, (1 << 26) // max(1, p.shape[0])))
    pop_chunk = 1 << (pop_chunk.bit_length() - 1)  # pow2 -> few compiled shapes
    population = max(pop_chunk, (population // pop_chunk) * pop_chunk)

    # one-hot matmul objective for the coarse random-search recursion only:
    # the final (native, generations=0) call keeps the exact splat so the
    # returned score stays the reference objective (splat_partwise_iou_mm).
    mm = (not _allow_coarse) and generations > 0 and Hp * Wp <= _MM_PLANE_MAX
    best, best_iou = _search_device(
        np.int32(seed),
        jnp.asarray(params_to_vector(init_params)),
        p, l, v,
        jnp.asarray(gt_p),
        jnp.asarray(config.part_ids(parts_for_alignment)),
        jnp.asarray(np.asarray([H, W], np.int32)),
        Hp, Wp,
        generations, population, cd_rounds, lock_xy_equal, pop_chunk,
        np.float32(step_scale), mm, tuple(cd_mags),
    )
    best = np.asarray(best, np.float64)

    params = vector_to_params(best, H=H, W=W)
    out = {
        "cam_pos": np.asarray(params["cam_pos"], np.float64),
        "target": np.asarray(params["target"], np.float64),
        "f": float(params["f"]),
        "cx": float(params["cx"]),
        "cy": float(params["cy"]),
        "H": H,
        "W": W,
    }
    return out, float(best_iou)
