"""Monument / part configuration and the label palette.

Re-designs the reference's ``utils/config.py`` (reference: utils/config.py:4-45)
around an integer *label* representation: every RGB part color is assigned a
small integer id so that all on-device compute operates on compact uint8 label
planes/grids instead of (…, 3) uint8 RGB tensors.  RGB appears only at the
artifact boundary (PNG masks in, npz voxel grids out) so saved artifacts stay
byte-compatible with the reference's ``results/`` goldens.

Label convention
----------------
* 3D voxel grids: ``0`` = empty (black), ``1..10`` = the ten parts.
* 2D masks:       ``1..10`` = the ten parts, ``OTHER_ID`` (11) = any pixel
  whose color matches no part color (e.g. bilinear-resize blends — these count
  as foreground for silhouette carving, exactly like the reference's
  "not background" rule, reference: utils/mask_utils.py:74-76).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Part colors (reference: utils/config.py:29-40) — order defines label ids.
# ---------------------------------------------------------------------------

PART_COLORS: Dict[str, Tuple[int, int, int]] = {
    "full_building": (253, 248, 96),
    "chhatris": (1, 220, 5),
    "plinth": (63, 138, 173),
    "dome": (190, 0, 255),
    "front_minarets": (0, 0, 255),
    "back_minarets": (5, 223, 223),
    "small_minarets": (255, 180, 80),
    "main_door": (180, 140, 255),
    "windows": (255, 120, 230),
    "background": (216, 224, 251),
}

PART_COLORS_NP: Dict[str, np.ndarray] = {
    k: np.array(v, dtype=np.uint8) for k, v in PART_COLORS.items()
}

PART_NAMES: List[str] = list(PART_COLORS.keys())

#: name -> label id (1-based; 0 is reserved for "empty").
PART_IDS: Dict[str, int] = {name: i + 1 for i, name in enumerate(PART_NAMES)}

EMPTY_ID: int = 0
BACKGROUND_ID: int = PART_IDS["background"]  # 10
#: 2D-mask label for foreground pixels matching no palette color.
OTHER_ID: int = len(PART_NAMES) + 1  # 11
NUM_LABELS: int = OTHER_ID + 1  # ids 0..11

#: (NUM_LABELS, 3) uint8 — row i is the RGB color of label i.
#: Row 0 is black (empty); row OTHER_ID is a sentinel (never written to
#: artifacts: 2D "other" pixels only ever feed binary silhouettes).
PALETTE: np.ndarray = np.zeros((NUM_LABELS, 3), dtype=np.uint8)
for _name, _i in PART_IDS.items():
    PALETTE[_i] = PART_COLORS[_name]
PALETTE[OTHER_ID] = (1, 1, 1)

INTERIOR_PARTS: List[str] = ["main_door", "windows"]  # utils/config.py:43

MAX_DIM: int = 256  # utils/config.py:45

MONUMENTS: List[str] = ["Akbar", "Bibi", "Charminar", "Itimad", "Taj"]

# Mask-file suffix map (reference: utils/config.py:6-27).
MONUMENT_CONFIG: Dict[str, Dict[str, object]] = {
    "Akbar": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
    "Bibi": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
    "Charminar": {
        "front": ["_front_mask.png", "_front_mask_win.png"],
        "drone": "_drone_mask.png",
    },
    "Itimad": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
    "Taj": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
}

#: Resolution each golden stage-1 grid in ``results/`` was produced at
#: (measured from the golden shapes; notebooks default to 256).
GOLDEN_MAX_DIM: Dict[str, int] = {
    "Akbar": 128,
    "Bibi": 512,
    "Charminar": 512,
    "Itimad": 512,
    "Taj": 512,
}

#: Zero-padding appended to grid dim 1 before stage-3 deformation
#: (measured from the golden stage-3 shapes; the committed notebook-3 cell 6
#: pads by zero, but the golden runs padded these monuments by +60).
STAGE3_PAD: Dict[str, int] = {
    "Akbar": 0,
    "Bibi": 60,
    "Charminar": 0,
    "Itimad": 60,
    "Taj": 60,
}


# ---------------------------------------------------------------------------
# Stage-1 carving presets (reference: notebook 1 cell 7).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CarvePreset:
    """Hyper-parameters of one stage-1 carving run.

    Mirrors the cell-level config of
    ``1.Orthographic_semantic_voxel_carving.ipynb`` cell 7.
    """

    #: (part-name group, sweep angle interval) pairs carved against their own
    #: 2D mask under global symmetry.
    group_jobs: Tuple[Tuple[Tuple[str, ...], int], ...] = (
        (("full_building",), 90),
        (("chhatris",), 90),
        (("plinth",), 90),
        (("front_minarets",), 90),
        (("small_minarets",), 90),
        (("dome",), 90),
    )
    #: part -> finer sweep interval for per-component ("left/right guided")
    #: carving.
    part_symmetry: Tuple[Tuple[str, int], ...] = (
        ("dome", 5),
        ("chhatris", 45),
        ("front_minarets", 5),
        ("small_minarets", 5),
    )
    #: interior part -> inward extrusion depth (voxels).
    extrusion_depths: Tuple[Tuple[str, int], ...] = (
        ("main_door", 20),
        ("windows", 10),
    )
    #: global silhouette sweep interval.
    global_angle_interval: int = 90
    recolor_back_minarets: bool = True


DEFAULT_CARVE_PRESET = CarvePreset()


def labels_to_rgb(labels: np.ndarray) -> np.ndarray:
    """uint8 label array (...,) -> uint8 RGB array (..., 3)."""
    return PALETTE[np.asarray(labels)]


def rgb_to_labels(rgb: np.ndarray, other_id: int = OTHER_ID) -> np.ndarray:
    """uint8 RGB (..., 3) -> uint8 labels.

    Exact palette matches map to their part id; exact black maps to
    ``EMPTY_ID``; anything else (e.g. resize blends) maps to ``other_id``.
    """
    rgb = np.asarray(rgb)
    key = ((rgb[..., 0].astype(np.uint32) << 16)
           | (rgb[..., 1].astype(np.uint32) << 8)
           | rgb[..., 2].astype(np.uint32))
    return _rgb_lut(int(other_id))[key]


@functools.lru_cache(maxsize=None)
def _rgb_lut(other_id: int) -> np.ndarray:
    """(2**24,) uint8 table from packed 0xRRGGBB to label id."""
    lut = np.full(1 << 24, other_id, np.uint8)
    lut[0] = EMPTY_ID
    for i in PART_IDS.values():
        r, g, b = (int(c) for c in PALETTE[i])
        lut[(r << 16) | (g << 8) | b] = i
    return lut


def part_ids(names: Sequence[str]) -> np.ndarray:
    """Part names -> int32 label-id vector."""
    return np.array([PART_IDS[n] for n in names], dtype=np.int32)


#: The checkout this package lives in.
REPO_ROOT: Path = Path(__file__).resolve().parents[1]

#: In-repo inputs in the reference's ``data/`` layout: per-monument front and
#: drone label planes derived from the committed golden-resolution artifacts
#: by ``scripts/derive_inputs.py`` (self-consistent targets, not the
#: reference's hand-drawn masks).
DATA_ROOT: Path = REPO_ROOT / "data"


def data_root(default: str | Path = DATA_ROOT) -> Path:
    """Default dataset root (the reference's ``data/`` layout)."""
    return Path(default)
