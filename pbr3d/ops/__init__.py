"""Device compute primitives (jit-compiled XLA programs)."""

from pbr3d.ops.rotate import rotate_y, rotate_y_binary_u8
from pbr3d.ops.carve import carve_with_mask, rotate_carve_sweep

__all__ = [
    "rotate_y",
    "rotate_y_binary_u8",
    "carve_with_mask",
    "rotate_carve_sweep",
]
