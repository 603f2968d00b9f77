#!/usr/bin/env python
"""Headline benchmark: full 3-stage reconstruction of all 5 monuments,
with built-in quality gates.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N,
   "stage1_iou_min": ..., "stage3_whole_iou_min": ..., "quality_ok": bool}

Baseline (BASELINE.md): the reference needs 29.7 s/monument at max_dim=256 on
one CPU core for stage 1 ALONE (its stages 2-3 are human-interactive and have
no automated baseline), i.e. >= 148.5 s for the 5-monument batch.
``vs_baseline`` is the speedup factor baseline_seconds / our_seconds, where
our time covers ALL THREE stages (carving + automated camera estimation +
automated part refinement).

Timing protocol: pass 1 is the cold (compile) pass; the reported value is the
MEDIAN of the remaining steady-state passes (default 3 passes total at
golden resolution / 5 @256).

Inputs are the in-repo masks under ``data/`` (``scripts/derive_inputs.py``).
``PBR3D_BENCH_MAX_DIM`` picks the resolution: ``golden`` (the default: every
mask at its own size, loaded with numpy alone) or a number such as ``256``,
which resizes the 512-voxel masks through the reference's INTER_LINEAR
quirk and so needs OpenCV (``cv2``) installed.

Quality gates (computed once from the last pass):
* stage-1 occupancy IoU per monument vs the committed golden-resolution
  grid the inputs were derived from (results_temp_golden/
  1.Orthographic_Voxel_Carving, stride-downsampled to the bench
  resolution).  Threshold 0.92 (= STAGE1_IOU_MIN); bit-exactness vs the
  live reference is asserted separately by tests/test_stage1.py fixtures.
* stage-3 whole-silhouette visibility-aware IoU (the notebook-4 "whole" row,
  eval_helpers_intra.py:560-748) per monument, threshold 0.80.
* stage-3 MEAN per-part visibility-aware IoU per monument, threshold 0.50
  (floor below today's worst monument, Charminar ~0.54) — catches a
  part-level collapse that the whole-silhouette union would hide.

The persistent XLA compilation cache (``pbr3d.utils.runtime.
enable_compile_cache``) carries compiled programs across processes; the
first cold run is compile-dominated.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

from pbr3d import config
from pbr3d.pipeline import run_all
from pbr3d.utils.runtime import enable_compile_cache

# Reference stage-1-only CPU cost for the 5-monument batch (its stages 2-3
# are human-interactive and have no automated baseline): 5 x 29.7 s measured
# at max_dim=256; at golden resolution ~3.5 min/monument (BASELINE.md,
# extrapolated x8 voxel count, consistent with SURVEY's 3-4 min estimate).
BASELINE_S_BY_MODE = {"256": 148.5, "512": 1050.0, "golden": 1050.0}
GOLDEN_DIR = str(config.REPO_ROOT / "results_temp_golden"
                 / "1.Orthographic_Voxel_Carving")
# Cross-resolution occupancy-IoU floor.  The gate compares a @256 run against
# @512 goldens (Akbar @128) after strided downsampling; stage-1 is separately
# proven BIT-EXACT vs the live reference at equal settings
# (tests/test_stage1.py, tests/test_stage1_512.py), so this number measures
# how far the derived front mask's re-carve and the resampling move the
# grid, not implementation quality.
STAGE1_IOU_MIN = 0.92
STAGE3_WHOLE_IOU_MIN = 0.80
STAGE3_MEAN_PART_IOU_MIN = 0.50


def _stage1_iou_vs_golden(monument: str, grid, max_dim: int):
    """Occupancy IoU vs the golden grid, stride-downsampled to a common
    resolution.  The goldens were produced at max_dim=512 (Akbar: 128), so
    whichever grid is larger is strided down, and ceil-vs-floor resize
    truncation (e.g. Charminar 355/2 = 177 vs 178) is absorbed by cropping
    both to the common min shape — every monument gets a gate."""
    import numpy as np

    from pbr3d.io.artifacts import load_voxel_grid_labels, voxel_grid_iou

    path = os.path.join(GOLDEN_DIR, f"{monument}_voxel_grid.npz")
    if not os.path.exists(path):
        return None
    gold = load_voxel_grid_labels(path)
    if max(gold.shape) >= max(grid.shape):
        factor = max(1, round(max(gold.shape) / max(grid.shape)))
        gold = gold[::factor, ::factor, ::factor]
    else:
        factor = max(1, round(max(grid.shape) / max(gold.shape)))
        grid = grid[::factor, ::factor, ::factor]
    if any(abs(a - b) > 2 for a, b in zip(gold.shape, grid.shape)):
        print(f"[bench] {monument}: golden shape {gold.shape} incomparable "
              f"to {grid.shape}, skipping stage-1 gate", file=sys.stderr)
        return None
    lo = tuple(min(a, b) for a, b in zip(gold.shape, grid.shape))
    gold = gold[: lo[0], : lo[1], : lo[2]]
    grid = np.asarray(grid)[: lo[0], : lo[1], : lo[2]]
    return voxel_grid_iou(grid, gold)


def _stage3_whole_iou(monument: str, result) -> float:
    """Notebook-4 'whole' cell: visibility-aware silhouette IoU of the
    deformed grid under the final front camera.

    Computed from the DENSE grid on device (the per-part z-buffer program
    the exact-verify already compiles): a pixel is visible iff its total
    z-buffer is finite — each pixel's min-Z point trivially passes the
    |Z − zbuf| < eps test against itself (eval_helpers_intra.py:168-190).
    The previous host path (np.where over 16.7M voxels per monument) cost
    minutes of single-core time in the quality-gate phase."""
    from pbr3d import config as _cfg
    from pbr3d.deform.verify import _part_zbufs_grid
    from pbr3d.eval.intra import _iou_bool, _load_mask_labels_for_grid, \
        compute_binary_gt

    grid3 = result.grid_stage3
    cam = result.cameras["final"].get("front") or next(
        iter(result.cameras["final"].values())
    )
    mask = _load_mask_labels_for_grid(
        config.DATA_ROOT, monument, "front", result.grid_stage1.shape
    )
    H, W = mask.shape[:2]
    present = [int(v) for v in np.unique(grid3) if 0 < v < 10]
    names = [p for p, i in _cfg.PART_IDS.items() if i in present]
    zbs = _part_zbufs_grid(grid3, cam, H, W, names)
    zb = np.minimum.reduce(list(zbs.values()))
    pr = np.isfinite(zb)[:H, :W]
    gt = compute_binary_gt(mask, result.grid_stage1)
    return _iou_bool(gt, pr)


def main():
    enable_compile_cache()
    raw = os.environ.get("PBR3D_BENCH_MAX_DIM", "golden")
    # "golden" = per-monument golden resolution (512; Akbar 128), the
    # configuration the reference's results/ were produced at.
    max_dim = None if raw == "golden" else int(raw)
    baseline_s = BASELINE_S_BY_MODE.get(raw, 148.5)
    passes = int(os.environ.get("PBR3D_BENCH_PASSES", "5" if raw == "256" else "3"))
    kw = dict(
        max_dim=max_dim,
        stage2_kw=dict(generations=12, population=192, seed=0),
        stage3_kw=dict(search_stride=8),
    )
    # Pass 1 is the fresh-process pass: with a warm compile cache it pays
    # executable deserialization + first-dispatch setup; with a cold cache
    # it pays the full compile wave.  The reported value is the median of the steady-state passes — the
    # serving-relevant number; the cold time is in the JSON as cold_s.
    times = []
    for p in range(passes):
        t0 = time.perf_counter()
        results = run_all(config.MONUMENTS, **kw)
        times.append(time.perf_counter() - t0)
        print(f"[bench] pass {p + 1}/{passes}: {times[-1]:.1f}s", file=sys.stderr)
    steady = times[1:] if len(times) > 1 else times
    value = statistics.median(steady)
    # Cold pass = this process's first pass (cache deserialization, or the
    # compile wave when the cache is cold); reported alongside the steady
    # median so the serving number and the fresh-process number are both in
    # the artifact.
    cold_s = times[0]

    per_stage = {
        m: {k: round(v, 3) for k, v in r.timings.items()} for m, r in results.items()
    }
    print(f"[bench] per-monument stage timings: {per_stage}", file=sys.stderr)

    # ---- quality gates ----
    s1_ious, s3_ious, s3_part_ious = {}, {}, {}
    for m, r in results.items():
        iou1 = _stage1_iou_vs_golden(m, r.grid_stage1, max_dim or 512)
        if iou1 is not None:
            s1_ious[m] = round(float(iou1), 4)
        s3_ious[m] = round(float(_stage3_whole_iou(m, r)), 4)
        # mean over parts PRESENT in the mask (notebook 4 prints "--" for
        # parts with empty GT; their IoU is structurally 0)
        scored = [d["iou"] for d in r.deform_params.values()
                  if d.get("gt_px", 1) > 0]
        s3_part_ious[m] = round(float(sum(scored) / max(len(scored), 1)), 4)
    quality = {
        m: {
            "stage1_iou_vs_golden": s1_ious.get(m),
            "stage3_whole_iou": s3_ious[m],
            "stage3_mean_part_iou": s3_part_ious[m],
            "views": sorted(r.cameras["final"]),
        }
        for m, r in results.items()
    }
    print(f"[bench] quality: {quality}", file=sys.stderr)

    quality_ok = (
        len(results) == len(config.MONUMENTS)
        and all(v >= STAGE1_IOU_MIN for v in s1_ious.values())
        and all(v >= STAGE3_WHOLE_IOU_MIN for v in s3_ious.values())
        and all(v >= STAGE3_MEAN_PART_IOU_MIN for v in s3_part_ious.values())
    )
    if not quality_ok:
        print(
            f"[bench] QUALITY GATE FAILED: {len(results)}/{len(config.MONUMENTS)} "
            f"monuments, stage1 {s1_ious}, stage3_whole {s3_ious}, "
            f"stage3_mean_part {s3_part_ious}",
            file=sys.stderr,
        )

    # Stage-1-only wall of the last pass (the batched carve attributes an
    # equal share per monument) — the apples-to-apples comparison against the
    # reference baseline, which covers stage 1 ONLY (its stages 2-3 are
    # human-interactive sessions with no automated time to compare to).
    stage1_s = sum(r.timings.get("stage1", 0.0) for r in results.values())
    print(
        json.dumps(
            {
                "metric": "full_3stage_pipeline_5monuments_maxdim"
                          f"{'golden' if max_dim is None else max_dim}",
                "value": round(value, 3),
                "unit": "s",
                "vs_baseline": round(baseline_s / value, 3),
                "baseline_scope": "reference stage-1 only (its stages 2-3 "
                                  "are human-interactive; ours are automated "
                                  "and included in value)",
                "cold_s": round(cold_s, 3),
                "stage1_s": round(stage1_s, 3),
                "vs_stage1_baseline": round(baseline_s / stage1_s, 3)
                if stage1_s else None,
                "stage1_iou_min": min(s1_ious.values()) if s1_ious else None,
                "stage3_whole_iou_min": min(s3_ious.values()) if s3_ious else None,
                "stage3_mean_part_iou_min": (
                    min(s3_part_ious.values()) if s3_part_ious else None
                ),
                "quality_ok": quality_ok,
            }
        )
    )


if __name__ == "__main__":
    main()
