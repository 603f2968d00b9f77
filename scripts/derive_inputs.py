#!/usr/bin/env python
"""Derive the in-repo input masks from the committed golden-resolution
artifacts in ``results_temp_golden/``.

For every monument this writes, in the reference's ``data/`` layout,

* ``data/<M>/masks/<M>_front_mask.npz`` — the first-hit orthographic
  projection of the stage-1 grid seen from its front face, in the carve
  frame (the inverse of the reorientation in ``carving/stage1.reorient``),
  at the grid's own ``(H, W)``, with each minaret's silhouette made
  symmetric about its axis (see ``_symmetric_minarets``) and the back
  minarets added where the committed final front camera sees them (see
  ``derive``);
* ``data/<M>/masks/<M>_drone_mask.npz`` — the z-buffered visible label of
  the stage-3 grid under the committed final drone camera, at that
  camera's own ``H x W``.

Each file holds one uint8 label plane under the key ``labels`` (part ids
1..9, ``BACKGROUND_ID`` where nothing is hit).  These are self-consistent
targets made from the pipeline's own outputs, not the reference's
hand-drawn masks.  The script reads only committed files, uses numpy
alone, and is deterministic:

    python scripts/derive_inputs.py [--out DIR] [--monuments Akbar Bibi ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pbr3d import config  # noqa: E402
from pbr3d.io.artifacts import load_voxel_grid_labels  # noqa: E402
from pbr3d.ops.cameramath import look_at_rotation_np  # noqa: E402

GOLDEN = config.REPO_ROOT / "results_temp_golden"
STAGE1 = GOLDEN / "1.Orthographic_Voxel_Carving"
CAMERAS = GOLDEN / "2.Perspective_Camera_Estimation"
STAGE3 = GOLDEN / "3.Part-wise_3D_Refinement"

#: Points projected per z-buffer pass (bounds the float64 temporaries).
_CHUNK = 1 << 22


def front_mask(saved: np.ndarray) -> np.ndarray:
    """First-hit labels of a saved stage-1 grid ``(D, H, W)`` seen from the
    front face (carve-frame z = 0), as an ``(H, W)`` plane in the carve
    frame's row order.  The saved frame is ``flip(transpose(g, (2, 1, 0)),
    axis=1)`` of the carve grid ``g[x, y, z]``, so carve z is saved axis 0
    and carve row y is saved row ``H - 1 - y``.  Minaret silhouettes then
    go through :func:`_symmetric_minarets`."""
    occ = saved > 0
    lab = np.take_along_axis(saved, occ.argmax(axis=0)[None], axis=0)[0]
    lab = np.where(occ.any(axis=0), lab, config.BACKGROUND_ID)
    return _symmetric_minarets(np.ascontiguousarray(lab[::-1]).astype(np.uint8))


def _symmetric_minarets(lab: np.ndarray) -> np.ndarray:
    """Widen each minaret silhouette, row by row, to be symmetric about its
    own column center, and label it ``front_minarets``.

    Stage 1 re-carves every minaret by rotating it about the center of its
    bounding box (the component-guided carve), so a row that reaches
    further on one side of that center than on the other is carved down to
    its narrower half.  A projected minaret is a pixel or so off-center in
    places; at 128 per side (Akbar) that cut the thin minarets into
    fragments on re-carving, and the front/back recolor then kept two
    fragments as the front minarets.  Only background pixels are added."""
    import scipy.ndimage

    ids = config.part_ids(["front_minarets", "back_minarets"])
    fm = config.PART_IDS["front_minarets"]
    out = lab.copy()
    comps, n = scipy.ndimage.label(np.isin(lab, ids))
    for i, sl in enumerate(scipy.ndimage.find_objects(comps), start=1):
        ys, xs = np.nonzero(comps[sl] == i)
        ys, xs = ys + sl[0].start, xs + sl[1].start
        c = (xs.min() + xs.max()) / 2.0
        for y in np.unique(ys):
            r = np.abs(xs[ys == y] - c).max()
            row = out[y, int(np.ceil(c - r)) : int(np.floor(c + r)) + 1]
            row[np.isin(row, [*ids, config.BACKGROUND_ID])] = fm
    return out


def visible_labels(grid: np.ndarray, cam: dict, H: int, W: int) -> np.ndarray:
    """``(H, W)`` label of the nearest occupied voxel per pixel under a
    pinhole camera, in float64 (the projection of ``ops/cameramath`` with
    the z-buffer's ``Z > 1e-6`` validity and banker's rounding of u, v).
    Ties in depth go to the first voxel in raster order."""
    R = look_at_rotation_np(cam["cam_pos"], cam["target"])
    eye = np.asarray(cam["cam_pos"], np.float64)
    f, cx, cy = float(cam["f"]), float(cam["cx"]), float(cam["cy"])
    best_z = np.full(H * W, np.inf)
    best_l = np.full(H * W, config.BACKGROUND_ID, np.uint8)
    flat = np.flatnonzero(grid)
    for c0 in range(0, flat.size, _CHUNK):
        idx = flat[c0 : c0 + _CHUNK]
        d0, d1, d2 = np.unravel_index(idx, grid.shape)
        d = np.stack([d2, d1, d0], axis=1).astype(np.float64) - eye
        X, Y, Z = (d @ R.T).T
        Zc = np.maximum(Z, 1e-8)
        u = np.round(X / Zc * f + cx).astype(np.int64)
        v = np.round(-Y / Zc * f + cy).astype(np.int64)
        ok = (Z > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        pix, Z, lab = v[ok] * W + u[ok], Z[ok], grid.ravel()[idx[ok]]
        order = np.lexsort((Z, pix))  # stable: raster order breaks ties
        pix, Z, lab = pix[order], Z[order], lab[order]
        head = np.ones(pix.size, bool)
        head[1:] = pix[1:] != pix[:-1]
        pix, Z, lab = pix[head], Z[head], lab[head]
        win = Z < best_z[pix]  # strict: earlier chunks keep ties
        best_z[pix[win]] = Z[win]
        best_l[pix[win]] = lab[win]
    return best_l.reshape(H, W)


def derive(monument: str) -> dict:
    """{"front": (H, W) uint8, "drone": (H, W) uint8} for one monument.

    In the orthographic front view the back minarets hide exactly behind
    the front ones, but the stage-2 aligner fits a pinhole camera to the
    front AND back minarets (a photograph shows the back ones peeking out
    beside the front ones).  So the front plane takes ``back_minarets``
    wherever the committed final front camera sees a back minaret over
    orthographic background.  Stage 1 carves no group from
    ``back_minarets`` pixels, so the carve is the same either way."""
    saved1 = load_voxel_grid_labels(STAGE1 / f"{monument}_voxel_grid.npz")
    grid3 = load_voxel_grid_labels(
        STAGE3 / f"{monument}_deformed_voxel_grid.npz")
    with open(CAMERAS / f"{monument}_camera_params_final.json") as fh:
        cams = json.load(fh)
    front = front_mask(saved1)
    cf = cams["front"]
    if (int(cf["H"]), int(cf["W"])) != front.shape:
        raise ValueError(f"{monument}: front camera is {cf['H']}x{cf['W']}, "
                         f"the stage-1 grid's plane {front.shape}")
    seen = visible_labels(grid3, cf, *front.shape)
    back = config.PART_IDS["back_minarets"]
    front[(seen == back) & (front == config.BACKGROUND_ID)] = back
    cd = cams["drone"]
    return {
        "front": front,
        "drone": visible_labels(grid3, cd, int(cd["H"]), int(cd["W"])),
    }


def write(monument: str, out_root: Path) -> None:
    masks = derive(monument)
    d = Path(out_root) / monument / "masks"
    d.mkdir(parents=True, exist_ok=True)
    for view, labels in masks.items():
        np.savez_compressed(d / f"{monument}_{view}_mask.npz", labels=labels)
        print(f"{monument}/{view}: {labels.shape}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(config.DATA_ROOT))
    ap.add_argument("--monuments", nargs="*", default=config.MONUMENTS)
    args = ap.parse_args(argv)
    for m in args.monuments:
        write(m, Path(args.out))


if __name__ == "__main__":
    main()
