"""pbr3d — part-based 3D reconstruction in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
BarnitaSharma/Part-based-3D-Reconstruction (classical-CV monument
reconstruction from semantic part masks):

  stage 1  orthographic semantic voxel carving   (pbr3d.carving)
  stage 2  perspective camera estimation         (pbr3d.camera)
  stage 3  part-wise symmetry-preserving warping (pbr3d.deform)
  eval     intra-/inter-method metrics           (pbr3d.eval)

Everything compute-heavy runs as jit-compiled XLA programs; artifact formats (npz voxel grids, camera JSONs) are kept
byte-compatible with the reference's ``results/`` goldens.
"""

from pbr3d import config
from pbr3d.utils.hostmem import keep_host_heap

# Retaining the heap makes the repeated large host temporaries fault once
# per process instead of once per use (see pbr3d.utils.hostmem).
keep_host_heap()

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
