#!/usr/bin/env python
"""Smoke test of pbr3d on an NVIDIA GPU: the quickest proof that the system
starts and is right on the card.

    python chip_smoke.py               # one card: phases 1-3 below
    python chip_smoke.py --four-cards  # the multi-device path only

Phases (one card):

1. card: ``nvidia-smi`` name and power limit, JAX and plugin versions;
2. parity of the hot device programs, GPU vs the CPU backend in the same
   process, on the Bibi@512 inputs under ``data/`` — the fused stage-1
   carve (bit-equal), the stage-2 candidate IoUs (exact splat and one-hot
   matmul forms), the per-part z-buffers, the stage-3 deform IoUs, and
   connected components at 512 per side (equal to scipy);
3. main path: ``run_all(["Akbar", "Bibi"], max_dim=None, strict=True)`` on
   the in-repo inputs with the bench's settings, cold then warm, with
   quality checks on every stage.

``--four-cards`` runs ``run_all`` over four monuments at golden resolution
with the scene mesh and the stage-3 eval batcher, against the same run on
one device in the same process.

Exits non-zero, printing no result, unless ``jax.devices()[0]`` is a GPU.
The last line of standard output is one JSON object with ``"ok": true``
and the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The CPU backend is the parity reference: keep it available beside the GPU.
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

#: Tolerances.  IoUs from projected points: rounding of projected
#: coordinates under another summation order can move a few boundary
#: pixels between backends.
IOU_TOL = 1e-3
#: Share of a z-buffer's finite pixels allowed to differ between backends
#: (points whose projection rounds to the other side of a pixel edge).
ZBUF_PIXEL_TOL = 1e-3
STAGE1_COMMITTED_IOU_MIN = 0.98
STAGE3_WHOLE_IOU_MIN = 0.80
STAGE3_MEAN_PART_IOU_MIN = 0.50
#: Warm pass drops Bibi when the cold pass ran longer than this (keeps the
#: whole script inside its time limit on a cold compile cache).
WARM_BIBI_MAX_COLD_S = 480.0
#: Stage settings of bench.py (stage 2: generations/population/seed;
#: stage 3: search stride).
BENCH_KW = dict(
    stage2_kw=dict(generations=12, population=192, seed=0),
    stage3_kw=dict(search_stride=8),
)
#: Phase 2's inputs (monument, resolution) and a second grid for the
#: components check; phase 3's monuments.
PARITY = ("Bibi", 512)
COMPONENTS_SECOND = "Taj"
MAIN_MONUMENTS = ("Akbar", "Bibi")
FOUR_CARD_MONUMENTS = ("Akbar", "Bibi", "Itimad", "Taj")
#: Four cards vs one, at golden resolution: stage-1 grids bit-equal, every
#: part the same chosen deform, and objectives and IoUs within this.  Every
#: slot of a sharded program runs the same per-scene arithmetic as the
#: one-device program; the only expected source of drift is a float sum
#: that the partitioned compilation associates differently.  IoUs are
#: ratios of pixel counts, so that drift is float32 rounding (~1e-7), while
#: one moved pixel on a 512-pixel mask is already of order 1e-5.
FOUR_CARD_TOL = 1e-5
#: Modules the card's machine may lack; none is imported on any path here.
BANNED = ("cv2", "pandas", "tabulate")


def say(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str):
    say(("  ok   " if cond else "  FAIL ") + msg)
    if not cond:
        fail(msg)


def phase_card(jax):
    say("== phase 1: card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(f"nvidia-smi: {out}")
    import jaxlib

    plugin = "none"
    try:
        from importlib.metadata import distributions

        plugin = ", ".join(sorted(
            f"{d.metadata['Name']} {d.version}" for d in distributions()
            if "cuda" in (d.metadata["Name"] or "").lower()
            and "jax" in (d.metadata["Name"] or "").lower()))
    except Exception as e:  # metadata is informative only
        plugin = f"unknown ({e})"
    say(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"plugin: {plugin}")
    d = jax.devices()[0]
    say(f"devices: {len(jax.devices())} x {d.device_kind} ({d.platform})")
    return out


def _both(jax, fn):
    """(gpu result, cpu result, gpu warm seconds, cpu seconds) of ``fn()``
    whose outputs are numpy-convertible; the GPU run is timed warm."""
    import numpy as np

    cpu = jax.devices("cpu")[0]
    jax.block_until_ready(fn())
    t = time.perf_counter()
    g = jax.tree_util.tree_map(np.asarray, fn())
    tg = time.perf_counter() - t
    with jax.default_device(cpu):
        t = time.perf_counter()
        c = jax.tree_util.tree_map(np.asarray, fn())
        tc = time.perf_counter() - t
    return g, c, tg, tc


def phase_parity(jax):
    import jax.numpy as jnp
    import numpy as np

    from pbr3d import config
    from pbr3d.camera.align import (
        _STEPS0, _batch_iou_impl, _pad_plane, mask_labels_selected,
    )
    from pbr3d.camera.geometry import params_to_vector
    from pbr3d.carving.fused import carve_monument_fused
    from pbr3d.carving.voxel import (
        all_points, bucket_size, pad_points, points_by_parts,
        surface_points_by_parts,
    )
    from pbr3d.deform.search import _batch_deform_visible_iou
    from pbr3d.eval.intra import compute_binary_gt
    from pbr3d.io.artifacts import load_camera_json
    from pbr3d.io.masks import load_mask_labels, prepare_masks
    from pbr3d.ops.components import _device_label, _host_scipy_label
    from pbr3d.ops.projection import partwise_zbuffers
    from pbr3d.pipeline import ALIGN_PARTS
    from pbr3d.utils.profiling import StageTimer

    mon, dim = PARITY
    say(f"== phase 2: GPU vs CPU parity on {mon}@{dim}")
    say(f"matmul precision in force: "
        f"{jax.config.jax_default_matmul_precision or 'default'} "
        "(hot matmuls pass Precision.HIGHEST explicitly)")
    cpu = jax.devices("cpu")[0]
    masks = prepare_masks(config.DATA_ROOT, mon, "front", dim)
    t = time.perf_counter()
    grid = carve_monument_fused(masks)
    tg = time.perf_counter() - t
    with jax.default_device(cpu):
        t = time.perf_counter()
        grid_cpu = carve_monument_fused(masks)
        tc = time.perf_counter() - t
    check(np.array_equal(grid, grid_cpu),
          f"stage-1 fused carve bit-equal {grid.shape} "
          f"(gpu {tg:.2f}s cold, cpu {tc:.2f}s)")

    # the drone view: its derived mask is this camera's own projection of
    # the committed grid, so the IoUs compared below are high, not ~0
    view = load_mask_labels(config.DATA_ROOT, mon, "drone")
    H, W = view.shape
    cam = load_camera_json(
        config.REPO_ROOT / "results_temp_golden"
        / f"2.Perspective_Camera_Estimation/{mon}_camera_params_final.json",
        "drone")
    cam_vec = params_to_vector(cam)
    true_hw = np.asarray([H, W], np.int32)

    # ---- stage 2: a 64-camera population ----
    rng = np.random.default_rng(0)
    pop = cam_vec[None] + 0.1 * _STEPS0[None] * rng.standard_normal(
        (64, 9)).astype(np.float32)
    pop[0] = cam_vec
    pts, labels = surface_points_by_parts(grid, list(ALIGN_PARTS))
    stride = max(1, -(-len(pts) // 32768))
    gt_p, (Hp, Wp) = _pad_plane(mask_labels_selected(view, list(ALIGN_PARTS)))
    part_ids = config.part_ids(list(ALIGN_PARTS))
    iou_fn = jax.jit(_batch_iou_impl, static_argnames=("H", "W", "mm"))
    for mm, sub in ((False, 1), (True, stride)):
        p, lab, v = pad_points(pts[::sub], labels[::sub],
                               bucket_size(len(pts[::sub])))
        g, c, tg, tc = _both(jax, lambda: iou_fn(
            np.asarray(pop), np.asarray(p), np.asarray(lab),
            np.asarray(v), np.asarray(gt_p), part_ids, true_hw,
            H=Hp, W=Wp, mm=mm))
        name = ("splat_partwise_iou_mm" if mm else "_batch_iou_impl (splat)")
        check(float(np.abs(g - c).max()) <= IOU_TOL,
              f"{name}: 64 cameras x {p.shape[0]} points, max |dIoU| "
              f"{float(np.abs(g - c).max()):.2e} <= {IOU_TOL} "
              f"(best {float(g.max()):.4f}; gpu {tg * 1e3:.1f} ms, "
              f"cpu {tc * 1e3:.0f} ms)")

    # ---- stage 3: per-part z-buffers and deform IoUs ----
    present = [p for p in config.PART_NAMES
               if p != "background" and (grid == config.PART_IDS[p]).any()]
    allp, alll = all_points(grid)
    p, lab, v = pad_points(allp, alll, bucket_size(len(allp)))
    ids = config.part_ids(present)
    zb_fn = jax.jit(partwise_zbuffers, static_argnames=("H", "W"))
    g, c, tg, tc = _both(jax, lambda: zb_fn(
        np.asarray(p), np.asarray(lab), np.asarray(v), cam_vec[0:3],
        cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8], ids, H=Hp, W=Wp,
        true_hw=true_hw))
    fin_g, fin_c = np.isfinite(g), np.isfinite(c)
    diff = int((fin_g != fin_c).sum())
    both = fin_g & fin_c
    check(diff <= ZBUF_PIXEL_TOL * max(1, int(fin_c.sum())),
          f"partwise_zbuffers: {len(allp)} points x {len(present)} parts, "
          f"{diff} of {int(fin_c.sum())} finite pixels differ, max |dZ| on "
          f"shared {float(np.abs(g[both] - c[both]).max()):.2e} "
          f"(gpu {tg * 1e3:.1f} ms, cpu {tc * 1e3:.0f} ms)")
    gt_whole = compute_binary_gt(view, grid)

    def whole(zb):
        return float((gt_whole & zb.any(0)[:H, :W]).sum()
                     / max(1, (gt_whole | zb.any(0)[:H, :W]).sum()))

    dw = abs(whole(fin_g) - whole(fin_c))
    check(dw <= IOU_TOL, f"whole-silhouette IoU from z-buffers "
          f"{whole(fin_g):.4f}, |d| {dw:.2e} <= {IOU_TOL}")

    part = "dome" if "dome" in present else present[1]
    k = present.index(part)
    rest = np.min(np.delete(c, k, axis=0), axis=0)
    sp, _ = surface_points_by_parts(grid, [part])
    full, _ = points_by_parts(grid, [part])
    center = full.mean(axis=0).astype(np.float32)
    cp, _, cv = pad_points(sp, np.zeros(len(sp), np.uint8),
                           bucket_size(len(sp)))
    gt_part = np.zeros((Hp, Wp), bool)
    gt_part[:H, :W] = view == config.PART_IDS[part]
    sy, shy = np.meshgrid(np.linspace(0.8, 1.4, 4), np.linspace(-20, 20, 4))
    deforms = np.stack([sy.ravel(), shy.ravel(), np.ones(16),
                        np.zeros(16)], 1).astype(np.float32)
    g, c, tg, tc = _both(jax, lambda: _batch_deform_visible_iou(
        np.asarray(deforms), np.asarray(cp), np.asarray(cv),
        np.asarray(cam_vec), np.asarray(gt_part), np.asarray(rest),
        true_hw, np.asarray(np.asarray(grid.shape, np.int32)),
        np.asarray(center), H=Hp, W=Wp))
    check(float(np.abs(g - c).max()) <= IOU_TOL,
          f"_batch_deform_visible_iou ({part}, 16 deforms x 7 x {len(sp)} "
          f"points): max |dIoU| {float(np.abs(g - c).max()):.2e} "
          f"(gpu {tg * 1e3:.1f} ms, cpu {tc * 1e3:.0f} ms)")

    # ---- fencing: StageTimer walls vs blocking on the outputs ----
    args = (jnp.asarray(deforms), jnp.asarray(cp), jnp.asarray(cv),
            jnp.asarray(cam_vec), jnp.asarray(gt_part), jnp.asarray(rest),
            true_hw, jnp.asarray(np.asarray(grid.shape, np.int32)),
            jnp.asarray(center))
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        _batch_deform_visible_iou(*args, H=Hp, W=Wp).block_until_ready()
        walls.append(time.perf_counter() - t)
        timer = StageTimer()
        with timer.stage("eval"):
            out = _batch_deform_visible_iou(*args, H=Hp, W=Wp)
        walls.append(timer.times["eval"])
        out.block_until_ready()
    blocked, fenced = min(walls[0::2]), min(walls[1::2])
    check(abs(fenced - blocked) <= 0.1 * blocked + 2e-3,
          f"StageTimer wall {fenced * 1e3:.2f} ms == blocked-on-output "
          f"wall {blocked * 1e3:.2f} ms (within 10% + 2 ms)")

    # ---- connected components at 512 per side ----
    second = carve_monument_fused(
        prepare_masks(config.DATA_ROOT, COMPONENTS_SECOND, "front", dim))
    dev_s = host_s = 0.0
    for name, g3 in ((mon, grid), (COMPONENTS_SECOND, second)):
        for pn in ("full_building", "front_minarets", "back_minarets",
                   "small_minarets", "chhatris"):
            m = g3 == config.PART_IDS[pn]
            if not m.any():
                continue
            _device_label(m, "face")  # compile
            t = time.perf_counter()
            ld, nd = _device_label(m, "face")
            dev_s += time.perf_counter() - t
            t = time.perf_counter()
            lh, nh = _host_scipy_label(m, "face")
            host_s += time.perf_counter() - t
            check(nd == nh and np.array_equal(ld, lh),
                  f"components {name}@{g3.shape} {pn}: device == scipy "
                  f"(n={nh}, labels and numbering)")
    say(f"components warm totals: device {dev_s:.3f}s, host scipy "
        f"{host_s:.3f}s")
    return {mon: grid_cpu}


def _stage_report(tag, results, wall):
    for m, r in results.items():
        say(f"  [{tag}] {m}: " + ", ".join(
            f"{k} {v:.2f}s" for k, v in r.timings.items()))
    say(f"  [{tag}] pass wall {wall:.2f}s")


def _quality(m, r):
    """({view: aligner objective}, stage-3 whole IoU, mean part IoU) of one
    monument's result, computed as bench.py does."""
    import bench
    from pbr3d import config
    from pbr3d.camera.align import evaluate_camera_iou
    from pbr3d.io.masks import load_mask_labels
    from pbr3d.pipeline import ALIGN_PARTS

    md = int(max(r.grid_stage1.shape))
    objs = {}
    for view, cam in sorted(r.cameras["final"].items()):
        mask = load_mask_labels(config.DATA_ROOT, m, view,
                                md if view == "front" else None)
        objs[view] = evaluate_camera_iou(r.grid_stage1, mask,
                                         list(ALIGN_PARTS), cam)
    whole = float(bench._stage3_whole_iou(m, r))
    scored = [d["iou"] for d in r.deform_params.values()
              if d.get("gt_px", 1) > 0]
    return objs, whole, float(sum(scored) / max(len(scored), 1))


def _camera_distance(m, view, cam) -> str:
    """How far a fitted camera lies from the committed final camera.  The
    derived front plane holds the back minarets as that camera sees them,
    so the front objective partly measures recovery of that camera; this
    distance says how closely it was recovered."""
    import numpy as np

    from pbr3d import config
    from pbr3d.io.artifacts import load_camera_json

    ref = load_camera_json(
        config.REPO_ROOT / "results_temp_golden"
        / f"2.Perspective_Camera_Estimation/{m}_camera_params_final.json",
        view)
    dpos = float(np.linalg.norm(np.asarray(cam["cam_pos"]) - ref["cam_pos"]))
    dtgt = float(np.linalg.norm(np.asarray(cam["target"]) - ref["target"]))
    dc = float(np.hypot(float(cam["cx"]) - ref["cx"],
                        float(cam["cy"]) - ref["cy"]))
    return (f"camera vs committed: |d cam_pos| {dpos:.2f} vox (distance "
            f"{float(np.linalg.norm(ref['cam_pos'] - ref['target'])):.1f}), "
            f"|d target| {dtgt:.2f} vox, d f/f "
            f"{(float(cam['f']) - ref['f']) / ref['f']:+.4f}, "
            f"|d (cx, cy)| {dc:.2f} px")


def phase_main_path(jax, cpu_grids):
    import numpy as np

    from pbr3d import config
    from pbr3d.carving.fused import carve_monument_fused
    from pbr3d.io.artifacts import load_voxel_grid_labels, voxel_grid_iou
    from pbr3d.io.masks import prepare_masks
    from pbr3d.pipeline import RETRY_IOU_FLOOR, run_all

    mons = list(MAIN_MONUMENTS)
    say(f"== phase 3: run_all({mons}, max_dim=None) on data/")
    t = time.perf_counter()
    res = run_all(mons, max_dim=None, strict=True, **BENCH_KW)
    cold = time.perf_counter() - t
    _stage_report("cold", res, cold)
    check(set(res) == set(mons), f"both monuments finished: {sorted(res)}")

    cpu = jax.devices("cpu")[0]
    for m in mons:
        r = res[m]
        g_cpu = cpu_grids.get(m)
        if g_cpu is None:
            masks = prepare_masks(config.DATA_ROOT, m, "front",
                                  config.GOLDEN_MAX_DIM[m])
            with jax.default_device(cpu):
                g_cpu = carve_monument_fused(masks)
        check(np.array_equal(r.grid_stage1, g_cpu),
              f"{m}: stage 1 {r.grid_stage1.shape} bit-equal to CPU carve")
        committed = load_voxel_grid_labels(
            config.REPO_ROOT / "results_temp_golden"
            / f"1.Orthographic_Voxel_Carving/{m}_voxel_grid.npz")
        iou1 = voxel_grid_iou(r.grid_stage1, committed)
        check(iou1 >= STAGE1_COMMITTED_IOU_MIN,
              f"{m}: stage-1 occupancy IoU vs committed grid {iou1:.4f} "
              f">= {STAGE1_COMMITTED_IOU_MIN}")
        check(sorted(r.cameras["final"]) == ["drone", "front"],
              f"{m}: views fitted {sorted(r.cameras['final'])}")
        objs, whole, mean_part = _quality(m, r)
        for view, obj in objs.items():
            check(obj >= RETRY_IOU_FLOOR[view],
                  f"{m}/{view}: aligner objective {obj:.4f} >= "
                  f"{RETRY_IOU_FLOOR[view]}; " + _camera_distance(
                      m, view, r.cameras["final"][view]))
        check(whole >= STAGE3_WHOLE_IOU_MIN,
              f"{m}: stage-3 whole IoU {whole:.4f} >= {STAGE3_WHOLE_IOU_MIN}")
        check(mean_part >= STAGE3_MEAN_PART_IOU_MIN,
              f"{m}: stage-3 mean part IoU {mean_part:.4f} >= "
              f"{STAGE3_MEAN_PART_IOU_MIN}")
    say("  ok   strict=True: no batched phase fell back to the serial path")

    warm_mons = mons if cold <= WARM_BIBI_MAX_COLD_S else mons[:1]
    t = time.perf_counter()
    res_w = run_all(warm_mons, max_dim=None, strict=True, **BENCH_KW)
    warm = time.perf_counter() - t
    _stage_report("warm", res_w, warm)
    for m in warm_mons:
        check(np.array_equal(res_w[m].grid_stage1, res[m].grid_stage1),
              f"{m}: warm stage 1 equals cold")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  peak device memory in use "
        f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB of an "
        f"allocator limit of {stats.get('bytes_limit', 0) / 2**30:.2f} GiB")


def phase_four_cards(jax):
    import numpy as np

    from pbr3d.pipeline import run_all

    n = len(jax.devices())
    say(f"== four cards: run_all over {FOUR_CARD_MONUMENTS} at golden "
        f"resolution (deep polish on), {n} devices vs one")
    if n < 4:
        fail(f"--four-cards needs 4 devices, found {n}")
    out = {}
    for tag, shard in (("mesh", True), ("one", False)):
        t = time.perf_counter()
        out[tag] = run_all(FOUR_CARD_MONUMENTS, strict=True, max_dim=None,
                           _shard=shard, **BENCH_KW)
        _stage_report(tag, out[tag], time.perf_counter() - t)

    for m in FOUR_CARD_MONUMENTS:
        a, b = out["mesh"][m], out["one"][m]
        check(np.array_equal(a.grid_stage1, b.grid_stage1),
              f"{m}: stage-1 grids {a.grid_stage1.shape} bit-equal across "
              "4 cards and one")
        check(sorted(a.cameras["final"]) == sorted(b.cameras["final"])
              == ["drone", "front"],
              f"{m}: views fitted {sorted(a.cameras['final'])} (4 cards), "
              f"{sorted(b.cameras['final'])} (one)")
        (oa, wa, _), (ob, wb, _) = _quality(m, a), _quality(m, b)
        for view in oa:
            check(abs(oa[view] - ob[view]) <= FOUR_CARD_TOL,
                  f"{m}/{view}: objective 4 cards {oa[view]:.6f} vs one "
                  f"{ob[view]:.6f}")
        check(abs(wa - wb) <= FOUR_CARD_TOL,
              f"{m}: stage-3 whole IoU 4 cards {wa:.6f} vs one {wb:.6f}")
        check(sorted(a.deform_params) == sorted(b.deform_params),
              f"{m}: the same {len(a.deform_params)} parts refined")
        worst = max(abs(a.deform_params[p]["iou"] - b.deform_params[p]["iou"])
                    for p in a.deform_params)
        differ = [p for p in a.deform_params
                  if a.deform_params[p]["deform"]
                  != b.deform_params[p]["deform"]]
        check(not differ and worst <= FOUR_CARD_TOL,
              f"{m}: every part chose the same deform (differ: {differ}), "
              f"part IoUs max |d| {worst:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path and its one-device "
                         "comparison")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (jax.devices()[0] is {dev.platform}); "
              "nothing to test", file=sys.stderr)
        return 1
    from pbr3d.utils.runtime import enable_compile_cache

    t0 = time.perf_counter()
    say(f"compile cache: {enable_compile_cache()}")
    phase_card(jax)
    if args.four_cards:
        phase_four_cards(jax)
    else:
        phase_main_path(jax, phase_parity(jax))
    heavy = [m for m in BANNED if m in sys.modules]
    check(not heavy, f"none of {BANNED} imported (found {heavy})")
    say(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
