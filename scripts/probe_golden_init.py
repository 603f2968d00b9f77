#!/usr/bin/env python
"""VERDICT r4 #5: run pbr3d's stage-3 search FROM THE GOLDEN INIT GRIDS with
the GOLDEN final cameras, and publish the resulting notebook-4 cells.

Round 3 argued that the two remaining >0.05 golden-resolution stage-3 gaps
(Taj chhatris 0.704 vs golden 0.811; Akbar minarets) are init-material
artifacts — our stage-1 grid at those cells simply holds different material
than the goldens' drifted snapshots (reference/results were produced by an
older code state; reference-vs-golden occupancy IoU is only ~0.96).  This
probe converts that argument into a measurement: search from the goldens'
OWN init grids (results/1.Orthographic_Voxel_Carving/*.npz) under the
goldens' OWN final cameras and report the nb4 init->deformed cells next to
the goldens' cells on identical material.

Reference anchors: /root/reference/utils/eval_helpers_intra.py:560-748 (the
nb4 table), /root/reference/utils/deformation_estimation.py:70-98 (slider
space).  Runs on the CPU or a GPU — the result is a quality measurement, not a
perf number.  Order: Akbar (128^3, fast) first, Taj (512) second.

Usage: python scripts/probe_golden_init.py [out_json]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from pbr3d.deform.verify import nb4_exact_cells  # noqa: E402
from pbr3d.eval.intra import _load_mask_labels_for_grid  # noqa: E402
from pbr3d.io.artifacts import load_camera_json, load_voxel_grid_labels  # noqa: E402
from pbr3d.pipeline import run_stage3  # noqa: E402

GOLD = "/root/reference/results"
DATA = "/root/reference/data"


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/golden_init_probe.json"
    report = {}
    for m in ("Akbar", "Taj"):
        t0 = time.time()
        init = load_voxel_grid_labels(
            f"{GOLD}/1.Orthographic_Voxel_Carving/{m}_voxel_grid.npz")
        cam = load_camera_json(
            f"{GOLD}/2.Perspective_Camera_Estimation/{m}_camera_params_final.json",
            "front")
        deforms, deformed = run_stage3(m, init, cam)
        print(f"[probe] {m}: stage3 from golden init done in "
              f"{time.time() - t0:.1f}s", flush=True)
        # nb4 cells of OUR search from golden material
        pad = deformed.shape[1] - init.shape[1]
        init_p = np.pad(init, ((0, 0), (0, pad), (0, 0))) if pad > 0 else init
        mask = _load_mask_labels_for_grid(DATA, m, "front", init.shape)
        ours = nb4_exact_cells(init_p, deformed, mask, cam)
        # the goldens' own cells for the same comparison
        gold_def = load_voxel_grid_labels(
            f"{GOLD}/3.Part-wise_3D_Refinement/{m}_deformed_voxel_grid.npz")
        pad_g = gold_def.shape[1] - init.shape[1]
        init_g = np.pad(init, ((0, 0), (0, pad_g), (0, 0))) if pad_g > 0 else init
        gold = nb4_exact_cells(init_g, gold_def, mask, cam)
        rows = {}
        for p in sorted(set(ours) | set(gold)):
            o = ours.get(p, (float("nan"), float("nan")))
            g = gold.get(p, (float("nan"), float("nan")))
            rows[p] = {"ours_init": round(float(o[0]), 4),
                       "ours_deformed": round(float(o[1]), 4),
                       "golden_init": round(float(g[0]), 4),
                       "golden_deformed": round(float(g[1]), 4)}
            print(f"[probe] {m} {p}: ours {o[0]:.3f}->{o[1]:.3f}  "
                  f"golden {g[0]:.3f}->{g[1]:.3f}", flush=True)
        report[m] = {"wall_s": round(time.time() - t0, 1), "cells": rows}
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[probe] wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
