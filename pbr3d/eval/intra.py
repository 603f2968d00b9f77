"""Intra-method consistency evaluation (notebook 4 drivers).

Re-designs ``utils/eval_helpers_intra.py``:

* ``run_minaret_kp_evaluation`` — keypoint reprojection error tables,
  Θinit -> Θkp (reference :287-424);
* ``run_minaret_iou_evaluation`` — visibility-aware per-minaret IoU,
  Θinit -> Θkp -> Θfinal (reference :427-558);
* ``run_part_minaret_binary_iou`` — per-part / minaret / whole-silhouette
  IoU, init grid -> deformed grid under Θfinal (reference :560-748).

The z-buffer + visibility projection run as device segment reductions
(pbr3d.ops.projection) instead of the reference's per-point Python loops
(its :134-190 hot spot).  Tables keep the reference's formats (pandas +
tabulate, monument short codes, "a→b" cells); pandas and tabulate are
imported by the table functions only, so the pipeline's exact stage-3 verify
(which reads masks through this module) needs neither.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, List, Sequence

import numpy as np

import jax.numpy as jnp

from pbr3d import config
from pbr3d.camera.geometry import project_point
from pbr3d.camera.keypoints import (
    extract_minaret_masks_by_label,
    extract_minaret_voxels_by_label,
    extract_top_bottom_image_points,
    extract_top_bottom_voxel_points,
)
from pbr3d.carving.voxel import all_points, bucket_size, pad_points, points_by_parts
from pbr3d.config import rgb_to_labels
from pbr3d.io.artifacts import load_camera_json, load_voxel_grid_labels
from pbr3d.io.masks import _read_rgb, mask_file, resize_nearest
from pbr3d.ops.projection import binary_iou, project_visible, zbuffer

if TYPE_CHECKING:
    import pandas as pd

MINARETS = ["LM1", "RM1", "LM2", "RM2"]

MONUMENT_SHORT = {
    "Taj": "TM", "Bibi": "BkM", "Itimad": "IuD", "Akbar": "AT", "Charminar": "CM",
}

#: Monuments whose back minarets only expose their tops in the front view
#: (reference: eval_helpers_intra.py:303-309).
BACK_TOP_ONLY = {
    "Itimad": True, "Akbar": True, "Charminar": True, "Taj": False, "Bibi": False,
}


def resize_mask_to_voxel_grid(mask_rgb: np.ndarray, grid_shape) -> np.ndarray:
    """Resize so max(mask dims) == max(grid dims); nearest, rounded dims
    (reference :31-54 — note ROUNDED dims here vs truncated in stage 1)."""
    H, W = mask_rgb.shape[:2]
    target = max(grid_shape[:3])
    scale = target / max(H, W)
    return resize_nearest(
        mask_rgb, int(round(W * scale)), int(round(H * scale)))


def _load_mask_labels_for_grid(root_masks, monument, view, grid_shape) -> np.ndarray:
    img = _read_rgb(mask_file(root_masks, monument, view))
    return rgb_to_labels(resize_mask_to_voxel_grid(img, grid_shape))


def project_keypoints(voxel_kps: Dict[str, np.ndarray], cam: Dict) -> Dict[str, np.ndarray]:
    return {k: np.asarray(project_point(np.asarray(pt, np.float32), cam))
            for k, pt in voxel_kps.items()}


def _zbuf(grid_labels, cam, H, W):
    pts, _ = all_points(grid_labels)
    p, _, v = pad_points(pts, np.zeros(len(pts), np.uint8), bucket_size(len(pts)))
    return zbuffer(
        jnp.asarray(p), jnp.asarray(v),
        cam["cam_pos"], cam["target"], cam["f"], cam["cx"], cam["cy"], H, W,
    )


def _visible(pts, cam, zbuf_img):
    p, _, v = pad_points(
        np.asarray(pts, np.float32), np.zeros(len(pts), np.uint8), bucket_size(len(pts))
    )
    return np.asarray(project_visible(
        jnp.asarray(p), jnp.asarray(v), zbuf_img,
        cam["cam_pos"], cam["target"], cam["f"], cam["cx"], cam["cy"],
    ))


def _iou_bool(a, b) -> float:
    return float(binary_iou(jnp.asarray(a), jnp.asarray(b)))


def _finish_table(cells: Dict, monuments: Sequence[str], header: str) -> "pd.DataFrame":
    import pandas as pd
    from tabulate import tabulate

    df = pd.DataFrame.from_dict(cells, orient="index")
    df = df[[m for m in monuments]]
    df.columns = [MONUMENT_SHORT[m] for m in df.columns]
    print(header)
    print(tabulate(df, headers="keys", tablefmt="grid", showindex=True))
    return df


def run_minaret_kp_evaluation(
    monuments: Sequence[str],
    view: str,
    root_voxels: str,
    root_masks: str,
    cam_dir: str,
) -> "pd.DataFrame":
    """Θinit -> Θkp keypoint reprojection error (px) per minaret."""
    cells = {m: {} for m in MINARETS + ["Average"]}

    for monument in monuments:
        grid = load_voxel_grid_labels(
            os.path.join(root_voxels, f"{monument}_voxel_grid.npz")
        )
        mask = _load_mask_labels_for_grid(root_masks, monument, view, grid.shape)
        cams = {
            "init": load_camera_json(
                os.path.join(cam_dir, f"{monument}_camera_params_init.json"), view),
            "rep": load_camera_json(
                os.path.join(cam_dir, f"{monument}_camera_params_kp.json"), view),
        }
        vox_parts = extract_minaret_voxels_by_label(grid)
        msk_parts = extract_minaret_masks_by_label(mask)
        voxel_kps = extract_top_bottom_voxel_points(vox_parts)
        image_kps = extract_top_bottom_image_points(msk_parts)

        err = {tag: {} for tag in cams}
        for tag, cam in cams.items():
            proj = project_keypoints(voxel_kps, cam)
            for m in MINARETS:
                errs = [np.linalg.norm(np.asarray(image_kps[f"{m}_top"]) - proj[f"{m}_top"])]
                if not (m in ("LM2", "RM2") and BACK_TOP_ONLY[monument]):
                    errs.append(
                        np.linalg.norm(np.asarray(image_kps[f"{m}_bottom"]) - proj[f"{m}_bottom"])
                    )
                err[tag][m] = float(np.mean(errs))

        for m in MINARETS:
            cells[m][monument] = f"{err['init'][m]:.2f}→{err['rep'][m]:.2f}"
        cells["Average"][monument] = (
            f"{np.mean(list(err['init'].values())):.2f}"
            f"→{np.mean(list(err['rep'].values())):.2f}"
        )

    return _finish_table(
        cells, monuments,
        "\n=== Minaret Keypoint Reprojection Error (px) ===\nΘinit → Θkp\n",
    )


def run_minaret_iou_evaluation(
    monuments: Sequence[str],
    view: str,
    root_voxels: str,
    root_masks: str,
    cam_dir: str,
) -> "pd.DataFrame":
    """Visibility-aware per-minaret IoU under Θinit -> Θkp -> Θfinal."""
    cells = {m: {} for m in MINARETS + ["Average"]}

    for monument in monuments:
        grid = load_voxel_grid_labels(
            os.path.join(root_voxels, f"{monument}_voxel_grid.npz")
        )
        mask = _load_mask_labels_for_grid(root_masks, monument, view, grid.shape)
        H, W = mask.shape[:2]
        cams = {
            tag: load_camera_json(
                os.path.join(cam_dir, f"{monument}_camera_params_{name}.json"), view)
            for tag, name in (("init", "init"), ("rep", "kp"), ("final", "final"))
        }
        vox_parts = extract_minaret_voxels_by_label(grid)
        msk_parts = extract_minaret_masks_by_label(mask)

        iou = {m: {} for m in MINARETS}
        for tag, cam in cams.items():
            zb = _zbuf(grid, cam, H, W)
            pts_all = np.vstack([vox_parts[m] for m in MINARETS]).astype(np.float32)
            pr_all = _visible(pts_all, cam, zb)
            for m in MINARETS:
                gt = msk_parts[m].astype(bool)
                pr = _visible(vox_parts[m].astype(np.float32), cam, zb)
                iou[m][tag] = _iou_bool(gt & pr_all, pr)

        for m in MINARETS:
            cells[m][monument] = "→".join(f"{iou[m][t]:.3f}" for t in ("init", "rep", "final"))
        cells["Average"][monument] = "→".join(
            f"{np.mean([iou[m][t] for m in MINARETS]):.3f}" for t in ("init", "rep", "final")
        )

    return _finish_table(
        cells, monuments,
        "\n=== Minaret IoU (INIT voxel grid, visible only) ===\nΘinit → Θkp → Θfinal\n",
    )


def compute_binary_gt(mask_labels: np.ndarray, grid_labels: np.ndarray) -> np.ndarray:
    """GT silhouette = union of mask pixels matching any label present in the
    grid (reference :274-285)."""
    present = np.unique(grid_labels)
    present = present[present > 0]
    return np.isin(mask_labels, present)


def run_part_minaret_binary_iou(
    monuments: Sequence[str],
    view: str,
    root_voxels: str,
    deformed_voxels: str,
    root_masks: str,
    cam_dir: str,
) -> "pd.DataFrame":
    """Per-part + minaret + whole-silhouette IoU, init -> deformed, Θfinal."""
    PARTS = ["dome", "chhatris", "main_door", "windows", "plinth"]
    rows = PARTS + ["minarets", "whole"]
    cells = {r: {} for r in rows}

    for monument in monuments:
        g_init = load_voxel_grid_labels(
            os.path.join(root_voxels, f"{monument}_voxel_grid.npz"))
        g_def = load_voxel_grid_labels(
            os.path.join(deformed_voxels, f"{monument}_deformed_voxel_grid.npz"))
        mask = _load_mask_labels_for_grid(root_masks, monument, view, g_init.shape)
        H, W = mask.shape[:2]
        cam = load_camera_json(
            os.path.join(cam_dir, f"{monument}_camera_params_final.json"), view)

        zb_i = _zbuf(g_init, cam, H, W)
        zb_d = _zbuf(g_def, cam, H, W)

        for part in PARTS:
            gt = mask == config.PART_IDS[part]
            pts_i, _ = points_by_parts(g_init, [part])
            pts_d, _ = points_by_parts(g_def, [part])
            if gt.sum() == 0 or len(pts_i) == 0:
                cells[part][monument] = "--"
                continue
            pr_i = _visible(pts_i, cam, zb_i)
            pr_d = _visible(pts_d, cam, zb_d) if len(pts_d) else np.zeros_like(pr_i)
            cells[part][monument] = f"{_iou_bool(gt, pr_i):.3f}→{_iou_bool(gt, pr_d):.3f}"

        pts_min, _ = points_by_parts(g_init, ["front_minarets", "back_minarets"])
        gt_min = np.isin(mask, config.part_ids(["front_minarets", "back_minarets"]))
        pr_i = _visible(pts_min, cam, zb_i)
        pr_d = _visible(pts_min, cam, zb_d)
        cells["minarets"][monument] = f"{_iou_bool(gt_min, pr_i):.3f}→{_iou_bool(gt_min, pr_d):.3f}"

        gt_whole = compute_binary_gt(mask, g_init)
        pi, _ = all_points(g_init)
        pd_, _ = all_points(g_def)
        pr_i = _visible(pi, cam, zb_i)
        pr_d = _visible(pd_, cam, zb_d)
        cells["whole"][monument] = f"{_iou_bool(gt_whole, pr_i):.3f}→{_iou_bool(gt_whole, pr_d):.3f}"

    return _finish_table(
        cells, monuments,
        "\n=== Part / Minaret / Binary IoU (init → deformed) ===\nCamera: Θfinal, visibility-aware\n",
    )
