"""The in-repo inputs under ``data/`` and the numpy-only loading path."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from pbr3d import config
from pbr3d.io import masks as masks_mod

GOLDEN = config.REPO_ROOT / "results_temp_golden"


def _derive_module():
    path = config.REPO_ROOT / "scripts" / "derive_inputs.py"
    spec = importlib.util.spec_from_file_location("derive_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _committed(monument, view):
    with np.load(masks_mod.mask_file(config.DATA_ROOT, monument, view)) as z:
        return z["labels"]


@pytest.mark.parametrize("monument", config.MONUMENTS)
def test_committed_data_equals_derivation(monument):
    derived = _derive_module().derive(monument)
    for view, labels in derived.items():
        committed = _committed(monument, view)
        assert committed.dtype == np.uint8
        np.testing.assert_array_equal(committed, labels, err_msg=view)


def test_front_masks_match_committed_grids():
    """Front planes have the stage-1 grid's own (H, W) — exactly the golden
    resolution, so stage 1 needs no resize; drone planes have the final
    drone camera's H x W."""
    from pbr3d.io.artifacts import load_voxel_grid_labels
    import json

    for m in config.MONUMENTS:
        g = load_voxel_grid_labels(
            GOLDEN / "1.Orthographic_Voxel_Carving" / f"{m}_voxel_grid.npz")
        front = _committed(m, "front")
        assert front.shape == g.shape[1:]
        assert max(front.shape) == config.GOLDEN_MAX_DIM[m]
        with open(GOLDEN / "2.Perspective_Camera_Estimation"
                  / f"{m}_camera_params_final.json") as fh:
            cam = json.load(fh)["drone"]
        assert _committed(m, "drone").shape == (cam["H"], cam["W"])


def test_recarve_akbar_matches_committed_grid():
    from pbr3d.carving.fused import carve_monument_fused
    from pbr3d.io.artifacts import load_voxel_grid_labels, voxel_grid_iou
    import scipy.ndimage

    grid = carve_monument_fused(
        masks_mod.prepare_masks(config.DATA_ROOT, "Akbar", "front", 128))
    committed = load_voxel_grid_labels(
        GOLDEN / "1.Orthographic_Voxel_Carving" / "Akbar_voxel_grid.npz")
    assert voxel_grid_iou(grid, committed) >= 0.98
    # the minarets survive as two front + two back columns
    for part in ("front_minarets", "back_minarets"):
        _, n = scipy.ndimage.label(grid == config.PART_IDS[part])
        assert n == 2, part


@pytest.mark.parametrize("view", ["front", "drone"])
@pytest.mark.parametrize("monument", config.MONUMENTS)
def test_minaret_keypoints_on_derived_masks(monument, view):
    from pbr3d.camera.keypoints import (
        extract_minaret_masks_by_label, extract_top_bottom_image_points,
    )

    parts = extract_minaret_masks_by_label(_committed(monument, view))
    kps = extract_top_bottom_image_points(parts)
    assert {"LM1_top", "RM1_top"} <= set(kps)


def test_minaret_keypoints_akbar_grid_and_masks():
    from pbr3d.camera.keypoints import extract_minaret_kps_for_view
    from pbr3d.io.artifacts import load_voxel_grid_labels

    grid = load_voxel_grid_labels(
        GOLDEN / "1.Orthographic_Voxel_Carving" / "Akbar_voxel_grid.npz")
    for view in ("front", "drone"):
        vox, img = extract_minaret_kps_for_view(
            grid, masks_mod.load_mask_labels(
                config.DATA_ROOT, "Akbar", view,
                128 if view == "front" else None))
        assert set(vox) == set(img) and len(img) >= 4


def test_loader_works_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    ms = masks_mod.prepare_masks(config.DATA_ROOT, "Bibi", "front", 512)
    assert ms.binary.shape == (318, 512)
    assert ms.binary.any() and (ms.semantic_labels == 10).any()
    drone = masks_mod.load_mask_labels(config.DATA_ROOT, "Bibi", "drone")
    np.testing.assert_array_equal(drone, _committed("Bibi", "drone"))
    # nearest resizes and the eval loader stay on numpy
    small = masks_mod.load_mask_labels(config.DATA_ROOT, "Bibi", "front", 256)
    assert small.shape == (159, 256)
    from pbr3d.eval.intra import _load_mask_labels_for_grid

    assert _load_mask_labels_for_grid(
        config.DATA_ROOT, "Bibi", "front", (256, 159, 256)).shape == (159, 256)
    # what still needs cv2 says so
    with pytest.raises(ImportError, match="cv2"):
        masks_mod.prepare_masks(config.DATA_ROOT, "Bibi", "front", 256)


def test_npz_wins_over_png(tmp_path):
    d = tmp_path / "M" / "masks"
    d.mkdir(parents=True)
    assert masks_mod.mask_file(tmp_path, "M", "front").suffix == ".png"
    np.savez_compressed(d / "M_front_mask.npz",
                        labels=np.full((4, 6), 10, np.uint8))
    assert masks_mod.mask_file(tmp_path, "M", "front").suffix == ".npz"
    rgb = masks_mod.load_mask_rgb(tmp_path, "M", "front")
    assert rgb.shape == (4, 6, 3)
    assert (rgb == config.PART_COLORS_NP["background"]).all()


_shapes = st.tuples(st.integers(1, 300), st.integers(1, 300))


@settings(max_examples=200, deadline=None)
@given(src=_shapes, max_dim=st.integers(1, 600), channels=st.sampled_from([0, 3]))
def test_nearest_truncated_dims_matches_cv2(src, max_dim, channels):
    cv2 = pytest.importorskip("cv2")
    h, w = src
    rng = np.random.default_rng(h * 1000 + w)
    shape = (h, w, channels) if channels else (h, w)
    img = rng.integers(0, 255, shape, dtype=np.uint8)
    s = max_dim / max(h, w)
    size = (int(w * s), int(h * s))
    if min(size) < 1:
        return
    ref = cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(
        masks_mod._resize_to_max(img, max_dim, linear=False), ref)


@settings(max_examples=200, deadline=None)
@given(src=_shapes, grid=st.integers(1, 600))
def test_nearest_rounded_dims_matches_cv2(src, grid):
    cv2 = pytest.importorskip("cv2")
    from pbr3d.eval.intra import resize_mask_to_voxel_grid

    h, w = src
    img = np.random.default_rng(h * 7 + w).integers(
        0, 255, (h, w, 3), dtype=np.uint8)
    s = grid / max(h, w)
    size = (int(round(w * s)), int(round(h * s)))
    if min(size) < 1:
        return
    ref = cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(
        resize_mask_to_voxel_grid(img, (grid, 1, 1)), ref)


def test_rgb_to_labels_table():
    rng = np.random.default_rng(0)
    pal = np.concatenate([config.PALETTE, [[0, 0, 0], [5, 5, 5]]])
    rgb = pal[rng.integers(0, len(pal), (60, 70))].astype(np.uint8)
    rgb[::7, ::5] = rng.integers(0, 256, rgb[::7, ::5].shape)
    for other in (config.OTHER_ID, 0):
        want = np.full(rgb.shape[:2], other, np.uint8)
        want[np.all(rgb == 0, axis=-1)] = config.EMPTY_ID
        for i in config.PART_IDS.values():
            want[np.all(rgb == config.PALETTE[i], axis=-1)] = i
        np.testing.assert_array_equal(config.rgb_to_labels(rgb, other), want)


def test_compile_cache_follows_env(monkeypatch):
    import jax

    from pbr3d.utils import runtime

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    thresholds = [("jax_persistent_cache_min_entry_size_bytes", 0),
                  ("jax_persistent_cache_min_compile_time_secs", 0.0)]
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert calls == thresholds  # no directory of its own
    calls.clear()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = runtime.enable_compile_cache()
    assert path == str(config.REPO_ROOT / ".jax_cache")
    assert calls == thresholds + [("jax_compilation_cache_dir", path)]
    assert config.REPO_ROOT == type(config.REPO_ROOT)(
        os.path.dirname(os.path.dirname(os.path.abspath(config.__file__))))


def test_memory_budget_cpu_and_device():
    from pbr3d.utils.runtime import memory_budget

    assert memory_budget(0.25, 123) == 123  # CPU reports no limit

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 1000}

    assert memory_budget(0.25, 123, device=Dev()) == 250


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=config.REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
