"""Device-mesh sharding for batched multi-scene reconstruction.

The reference is strictly single-threaded CPU (SURVEY §2: no DP/TP/PP of any
kind).  The mesh here follows the algorithm, not the hardware:

* ``scene`` axis — data parallelism over monuments/scenes: masks are padded
  to a common shape and the whole carve/project pipeline is vmapped, with
  the batch dimension sharded across devices (zero communication).  This
  is the only axis the production path (``run_all``) uses:
  :func:`scene_only_mesh`.
* ``y`` axis — spatial sharding of the voxel grid's height dimension, used
  by the entry-point dry run (:func:`scene_mesh`).  The Y-rotation sweep
  only mixes the (x, z) axes, so rotate+carve is communication-free under
  Y sharding; XLA inserts the collectives for the projection
  segment-reductions.

Single host only; the same meshes run on several GPUs of one host and on
``--xla_force_host_platform_device_count`` virtual CPU devices (tests).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pbr3d import config
from pbr3d.carving.stage1 import global_carve, part_carve


def scene_mesh(n_devices: int | None = None) -> Mesh:
    """A (scene, y) mesh over the first ``n_devices`` devices."""
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    n = len(devs)
    scene = n // 2 if n % 2 == 0 and n > 1 else n
    return Mesh(np.array(devs).reshape(scene, n // scene), ("scene", "y"))


def scene_only_mesh(batch: int, n_devices: int | None = None) -> Mesh | None:
    """A 1-axis ("scene",) mesh for data-parallel batches of ``batch``
    scenes: uses the largest divisor of ``batch`` that fits the available
    devices (NamedSharding requires the sharded axis to divide evenly).
    Returns None when only one device would be used — callers then skip
    sharding entirely."""
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    k = max(d for d in range(1, min(batch, len(devs)) + 1) if batch % d == 0)
    if k <= 1:
        return None
    return Mesh(np.array(devs[:k]), ("scene",))


def shard_batch_leading(arr, mesh: Mesh):
    """Place an array with its LEADING axis sharded over ``mesh``'s scene
    axis (all other axes replicated) — the zero-communication data-parallel
    layout for scene/view batches."""
    a = jnp.asarray(arr)
    spec = ["scene"] + [None] * (a.ndim - 1)
    return jax.device_put(a, NamedSharding(mesh, P(*spec)))


def pad_masks_to_common(mask_sets: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-monument (binary, exterior-label) masks into common-shape
    batches (zero padding = carve-away region, a no-op for the pipeline)."""
    H = max(m.binary.shape[0] for m in mask_sets)
    W = max(m.binary.shape[1] for m in mask_sets)
    B = len(mask_sets)
    binary = np.zeros((B, H, W), np.uint8)
    exterior = np.zeros((B, H, W), np.uint8)
    for i, m in enumerate(mask_sets):
        h, w = m.binary.shape
        binary[i, :h, :w] = m.binary
        exterior[i, :h, :w] = m.exterior_labels
    return binary, exterior


def shard_scene_batch(arr: jax.Array, mesh: Mesh, y_axis: int | None = 1) -> jax.Array:
    """Place a scene-batched array: batch on ``scene``, optional spatial dim
    on ``y``."""
    spec = [None] * arr.ndim
    spec[0] = "scene"
    if y_axis is not None and arr.ndim > y_axis:
        spec[y_axis] = "y"
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))


def batched_global_carve(
    binary_b: jax.Array,  # (B, H, W)
    exterior_b: jax.Array,  # (B, H, W)
    mesh: Mesh | None = None,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
) -> jax.Array:
    """Global + per-part-group carving for a batch of scenes, sharded over
    the mesh.  Returns (B, W, H, W) uint8 label grids."""

    def one(binary_hw, ext_hw):
        grid = global_carve(binary_hw, ext_hw, preset.global_angle_interval)
        return part_carve(grid, ext_hw, preset.group_jobs)

    fn = jax.jit(jax.vmap(one))
    if mesh is not None:
        binary_b = shard_scene_batch(jnp.asarray(binary_b), mesh)
        exterior_b = shard_scene_batch(jnp.asarray(exterior_b), mesh)
    return fn(binary_b, exterior_b)
