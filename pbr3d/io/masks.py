"""Semantic part-mask loading & preparation.

Host-side numpy — this is dataset IO, not the compute path.  Produces
both exact-RGB arrays (for artifact parity) and compact uint8 label planes
(what the device kernels consume).

A mask file is either a ``*.npz`` uint8 label plane (key ``labels``; the
in-repo inputs under ``data/``, see ``scripts/derive_inputs.py``) or the
reference's RGB PNG.  ``.npz`` wins when both exist.  PNG decoding and the
INTER_LINEAR resize quirk below need OpenCV, imported only when reached;
every other path is numpy.

Semantics preserved from the reference:

* ``load_mask``: BGR PNG -> RGB; optional aspect-preserving resize with
  truncating output dims and true INTER_NEAREST
  (reference: utils/mask_utils.py:14-33).
* ``prepare_masks``: interior->exterior part folding happens at FULL
  resolution before resize (reference: utils/mask_utils.py:48-54); the resize
  inside the prepare path accidentally uses the cv2 default INTER_LINEAR
  because the reference passes the interpolation flag positionally into the
  ``dst`` slot (reference: utils/mask_utils.py:57-60).  Golden stage-1 grids
  were produced with that quirk, so it is replicated by default
  (``quirk_linear_resize=True``); pass False for clean nearest resizing.
* Charminar window-variant override (reference: utils/mask_utils.py:66-71).
* binary silhouette = any pixel whose exterior color != background
  (reference: utils/mask_utils.py:74-76).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import numpy as np

from pbr3d import config
from pbr3d.config import BACKGROUND_ID, PART_IDS, rgb_to_labels


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "OpenCV (cv2) is needed to decode PNG masks and for the "
            "INTER_LINEAR resize quirk; .npz label planes at their target "
            "size load without it"
        ) from e
    return cv2


def mask_file(root_path: str | Path, monument_name: str, view_name: str,
              suffix: str = "") -> Path:
    """``<root>/<M>/masks/<M>_<view>_mask<suffix>.npz`` if it exists, else
    the reference's ``.png`` of the same name."""
    stem = Path(root_path) / monument_name / "masks" / (
        f"{monument_name}_{view_name}_mask{suffix}")
    npz = stem.parent / (stem.name + ".npz")
    return npz if npz.exists() else stem.parent / (stem.name + ".png")


def _read_rgb(path: str | os.PathLike) -> np.ndarray:
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return config.labels_to_rgb(z["labels"])
    cv2 = _cv2()
    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """cv2 INTER_NEAREST source index per output index:
    ``min(floor(i / (n_out / n_in)), n_in - 1)`` in float64."""
    inv = 1.0 / (n_out / n_in)
    return np.minimum(
        np.floor(np.arange(n_out) * inv).astype(np.int64), n_in - 1)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bit-exact numpy port of ``cv2.resize(img, (width, height),
    interpolation=cv2.INTER_NEAREST)`` (tests/test_inputs.py checks it)."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    rows = _nearest_index(h, height)
    cols = _nearest_index(w, width)
    return img[rows[:, None], cols[None, :]]


def _resize_to_max(img: np.ndarray, max_dim: int, linear: bool) -> np.ndarray:
    """Aspect-preserving resize: scale = max_dim / max(h, w), truncating dims.
    Returns ``img`` itself when the size already matches."""
    h, w = img.shape[:2]
    s = max_dim / max(h, w)
    size = (int(w * s), int(h * s))
    if size == (w, h):
        return img
    if linear:
        cv2 = _cv2()
        return cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    return resize_nearest(img, *size)


def load_mask_rgb(
    root_path: str | Path,
    monument_name: str,
    view_name: str,
    max_dim: Optional[int] = None,
) -> np.ndarray:
    """RGB uint8 (H, W, 3) part mask; nearest-resized if max_dim is given."""
    mask = _read_rgb(mask_file(root_path, monument_name, view_name))
    if max_dim is not None:
        mask = _resize_to_max(mask, max_dim, linear=False)
    return mask


def load_mask_labels(
    root_path: str | Path,
    monument_name: str,
    view_name: str,
    max_dim: Optional[int] = None,
) -> np.ndarray:
    """uint8 (H, W) label plane version of :func:`load_mask_rgb`."""
    return rgb_to_labels(load_mask_rgb(root_path, monument_name, view_name, max_dim))


@dataclasses.dataclass
class MaskSet:
    """Prepared per-view masks for stage-1 carving.

    RGB fields keep artifact-exact colors; ``*_labels`` fields are the uint8
    label planes fed to the device kernels (part ids 1..10, OTHER_ID for blend
    pixels, BACKGROUND_ID for background).
    """

    semantic: np.ndarray  # (H, W, 3) uint8 — full mask (doors/windows kept)
    exterior: np.ndarray  # (H, W, 3) uint8 — interior folded into full_building
    binary: np.ndarray  # (H, W) uint8 {0,1} — carving silhouette
    semantic_labels: np.ndarray  # (H, W) uint8
    exterior_labels: np.ndarray  # (H, W) uint8

    @property
    def hw(self) -> tuple[int, int]:
        return self.binary.shape[:2]


def prepare_masks(
    root_path: str | Path,
    monument_name: str,
    view_name: str = "front",
    max_dim: int = config.MAX_DIM,
    quirk_linear_resize: bool = True,
) -> MaskSet:
    """Load + fold + resize the semantic masks for one monument view.

    Mirrors ``load_and_prepare_masks`` (reference: utils/mask_utils.py:35-87);
    see module docstring for the replicated behaviors.
    """
    semantic_full = _read_rgb(mask_file(root_path, monument_name, view_name))

    # Interior -> exterior folding at full resolution.
    labels_full = rgb_to_labels(semantic_full)
    interior = np.isin(
        labels_full, [PART_IDS[p] for p in config.INTERIOR_PARTS]
    )
    exterior_full = semantic_full.copy()
    exterior_full[interior] = config.PART_COLORS_NP["full_building"]

    semantic = _resize_to_max(semantic_full, max_dim, linear=quirk_linear_resize)
    exterior = _resize_to_max(exterior_full, max_dim, linear=quirk_linear_resize)

    # Charminar window-variant override of the *semantic* (full) mask only.
    if monument_name == "Charminar":
        win_path = mask_file(root_path, monument_name, view_name, "_win")
        if win_path.exists():
            semantic = _resize_to_max(
                _read_rgb(win_path), max_dim, linear=quirk_linear_resize
            )

    semantic_labels = rgb_to_labels(semantic)
    exterior_labels = rgb_to_labels(exterior)
    binary = (exterior_labels != BACKGROUND_ID).astype(np.uint8)

    return MaskSet(
        semantic=semantic,
        exterior=exterior,
        binary=binary,
        semantic_labels=semantic_labels,
        exterior_labels=exterior_labels,
    )


def mask_parts_from_labels(labels: np.ndarray, part_names) -> np.ndarray:
    """Keep only the selected parts of a label plane (others -> 0).

    Label-domain analogue of ``mask_parts_from_image``
    (reference: utils/mask_utils.py:89-97).
    """
    ids = config.part_ids(part_names)
    keep = np.isin(labels, ids)
    return np.where(keep, labels, 0).astype(labels.dtype)
