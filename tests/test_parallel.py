"""Multi-device sharding: batched carve over the virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbr3d.carving.stage1 import global_carve, part_carve
from pbr3d import config
from pbr3d.parallel.sharding import (
    batched_global_carve,
    pad_masks_to_common,
    scene_mesh,
    shard_scene_batch,
)


def _toy_mask(h, w, seed):
    rng = np.random.default_rng(seed)
    ext = np.full((h, w), config.BACKGROUND_ID, np.uint8)
    ext[h // 4 : -2, w // 4 : -w // 4] = config.PART_IDS["full_building"]
    ext[h // 8 : h // 4 + 1, 3 * w // 8 : 5 * w // 8] = config.PART_IDS["dome"]
    binary = (ext != config.BACKGROUND_ID).astype(np.uint8)
    return binary, ext


def test_mesh_shapes():
    mesh = scene_mesh(8)
    assert mesh.devices.size == 8
    assert set(mesh.axis_names) == {"scene", "y"}


def test_batched_carve_matches_single():
    B = 4
    masks = [_toy_mask(24, 24, i) for i in range(B)]
    binary_b = np.stack([b for b, _ in masks])
    ext_b = np.stack([e for _, e in masks])

    mesh = scene_mesh(8)
    grids = np.asarray(batched_global_carve(binary_b, ext_b, mesh))
    assert grids.shape == (B, 24, 24, 24)

    for i, (b, e) in enumerate(masks):
        single = part_carve(
            global_carve(b, e, 90), e, config.DEFAULT_CARVE_PRESET.group_jobs
        )
        np.testing.assert_array_equal(grids[i], np.asarray(single))


def test_pad_masks_to_common():
    from pbr3d.io.masks import prepare_masks

    sets = [prepare_masks(config.DATA_ROOT, m, "front", 64)
            for m in ("Akbar", "Taj")]
    binary, ext = pad_masks_to_common(sets)
    assert binary.shape == ext.shape and binary.shape[0] == 2
    h, w = sets[0].binary.shape
    np.testing.assert_array_equal(binary[0, :h, :w], sets[0].binary)
    assert binary[0, h:, :].sum() == 0


def test_shard_placement():
    mesh = scene_mesh(8)
    x = jnp.zeros((8, 16, 16))
    xs = shard_scene_batch(x, mesh)
    assert xs.sharding.is_equivalent_to(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("scene", "y", None)),
        x.ndim,
    )


@pytest.mark.slow
def test_carve_monuments_batched_bit_exact(data_root):
    """The one-dispatch batched stage 1 must equal the serial fused path
    voxel-for-voxel for every monument in the batch."""
    from pbr3d.carving.fused import carve_monument_fused, carve_monuments_batched
    from pbr3d.io.masks import prepare_masks

    names = ["Akbar", "Taj", "Bibi"]
    sets = {m: prepare_masks(data_root, m, "front", 96) for m in names}
    batched = carve_monuments_batched(sets)
    assert set(batched) == set(names)
    for m in names:
        single = carve_monument_fused(sets[m])
        np.testing.assert_array_equal(batched[m], single)


def test_carve_monuments_batched_memory_fallback():
    """Above the memory budget the batched API transparently degrades to the
    serial fused path."""
    from pbr3d.carving.fused import carve_monument_fused, carve_monuments_batched
    from pbr3d.io.masks import prepare_masks

    sets = {"Akbar": prepare_masks(config.DATA_ROOT, "Akbar", "front", 64)}
    batched = carve_monuments_batched(sets, mem_budget_bytes=1)
    np.testing.assert_array_equal(
        batched["Akbar"], carve_monument_fused(sets["Akbar"])
    )


def test_guided_batched_overlapping_windows():
    """Two same-part components whose bucket windows OVERLAP must carve
    identically batched and serial: the batched write-backs re-read the live
    grid, so one window's slice cannot resurrect the other's erasure."""
    import jax.numpy as jnp

    from pbr3d import config
    from pbr3d.carving.fused import (
        _collect_guided_jobs, guided_carve_all, guided_carve_batched,
    )

    pid = config.PART_IDS["front_minarets"]
    w = h = d = 48
    grid = np.zeros((w, h, d), np.uint8)
    # two tall thin components 6 voxels apart: 32-bucket windows overlap
    grid[4:14, 2:46, 20:30] = pid
    grid[20:30, 2:46, 20:30] = pid
    ext = np.zeros((h, w), np.uint8)
    ext[2:46, 2:30] = pid
    ext[10:20, 8:26] = 0  # carve bites so the windows actually erase
    Wp = Hp = Dp = 64  # padded extent with margin
    grid_p = np.zeros((Wp, Hp, Dp), np.uint8)
    grid_p[:w, :h, :d] = grid

    serial = np.asarray(
        guided_carve_all(jnp.asarray(grid_p), ext, [("front_minarets", 5)])
    )
    jobs = _collect_guided_jobs(grid, ext, [("front_minarets", 5)], 32)
    assert len(jobs) == 2
    x_spans = sorted((j["start"][0], j["start"][0] + j["key"][0]) for j in jobs)
    assert x_spans[0][1] > x_spans[1][0], "windows should overlap in x"
    batched = np.asarray(
        guided_carve_batched(jnp.asarray(grid_p)[None], {0: jobs})[0]
    )
    np.testing.assert_array_equal(batched, serial)
    assert (batched != grid_p).any(), "the carve must actually erase something"


def test_batched_stage1_active_at_bench_resolution():
    """The 5-monument @256 batch must fit the default memory budget — a
    too-generous guided margin once silently demoted every bench run to the
    serial per-monument path."""
    import inspect

    from pbr3d import config
    from pbr3d.carving.fused import _batched_sweep_budget, carve_monuments_batched
    from pbr3d.io.masks import prepare_masks
    from pbr3d.carving.fused import CPU_STAGE1_BATCH_BYTES, STAGE1_BATCH_SHARE
    from pbr3d.utils.runtime import memory_budget

    sig = inspect.signature(carve_monuments_batched)
    bucket = sig.parameters["bucket"].default
    margin = sig.parameters["guided_margin"].default
    assert sig.parameters["mem_budget_bytes"].default is None
    budget = memory_budget(STAGE1_BATCH_SHARE, CPU_STAGE1_BATCH_BYTES)
    whd = []
    for m in config.MONUMENTS:
        b = prepare_masks(config.DATA_ROOT, m, "front", 256).binary
        whd.append((b.shape[1], b.shape[0], b.shape[1]))
    *_, per_scene = _batched_sweep_budget(whd, bucket, margin)
    assert per_scene * len(whd) <= budget, (
        f"batched stage-1 would fall back to serial at 256: "
        f"{per_scene * len(whd) / 1e9:.2f} GB > {budget / 1e9:.2f} GB"
    )


@pytest.mark.slow
def test_run_all_sharded_matches_single_device(data_root, tmp_path):
    """VERDICT r3 #4: the PRODUCTION pipeline on a multi-device mesh.

    Under the 8-virtual-device CPU env, run_all auto-shards the stage-1
    scene batch and the stage-2 view groups (scene_only_mesh /
    shard_devices).  Every output must equal the single-device path:
    stage-1 grids bit-exact vs the unsharded fused carve, stage-2 finals
    identical to an unsharded refine_cameras_batched of the same jobs."""
    from pbr3d.camera.align import refine_cameras_batched
    from pbr3d.carving.fused import carve_monument_fused
    from pbr3d.carving.voxel import surface_points_by_parts
    from pbr3d.io.masks import load_mask_labels, prepare_masks
    from pbr3d.pipeline import ALIGN_PARTS, run_all

    assert len(jax.devices()) >= 2  # conftest forces 8 virtual CPU devices

    monuments = ("Akbar", "Charminar")
    res = run_all(
        monuments, strict=True, max_dim=96, out_dir=tmp_path,
        stage2_kw=dict(generations=2, population=8, seed=0),
        stage3_kw=dict(search_stride=8, chunk=32,
                       part_names=["front_minarets"],
                       scale_range=(0.9, 1.1, 3), shift_range=(-20, 20, 3),
                       refine_steps=3),
    )
    assert set(res) == set(monuments)

    # stage 1: sharded batched carve == unsharded per-monument fused carve
    for m in monuments:
        single = carve_monument_fused(prepare_masks(data_root, m, "front", 96))
        np.testing.assert_array_equal(res[m].grid_stage1, single)

    # stage 2: sharded grouped search == unsharded on identical jobs
    jobs = {}
    for m in monuments:
        grid = res[m].grid_stage1
        mask = load_mask_labels(data_root, m, "front", 96)
        from pbr3d.camera.keypoints import extract_minaret_kps_for_view
        from pbr3d.camera.estimate import (
            auto_compute_initial_params_matching_bbox,
            optimize_camera_with_keypoints,
        )

        vox_kps, img_kps = extract_minaret_kps_for_view(grid, mask)
        init = auto_compute_initial_params_matching_bbox(
            grid, mask, list(ALIGN_PARTS))
        kp = optimize_camera_with_keypoints(vox_kps, img_kps, mask.shape[:2],
                                            init)
        jobs[(m, "front")] = dict(
            grid_labels=grid, mask_labels=mask, parts=list(ALIGN_PARTS),
            init_params=kp,
            points=surface_points_by_parts(grid, list(ALIGN_PARTS)),
        )
    out_sharded = refine_cameras_batched(
        jobs, generations=2, population=8, seed=0, shard_devices=True)
    out_single = refine_cameras_batched(
        jobs, generations=2, population=8, seed=0, shard_devices=False)
    for k in jobs:
        assert out_sharded[k][1] == pytest.approx(out_single[k][1], abs=1e-6)
        for f in ("cam_pos", "target"):
            np.testing.assert_allclose(
                out_sharded[k][0][f], out_single[k][0][f], atol=1e-4)
        for f in ("f", "cx", "cy"):
            assert out_sharded[k][0][f] == pytest.approx(
                out_single[k][0][f], abs=1e-4)


def test_batched_refine_sharded_matches_serial():
    """Stage-3 grouped eval dispatches sharded over the scene mesh axis must
    reproduce the serial unbatched search bit-for-bit (verdict r4 #5: the
    monument axis IS the multi-chip axis; pbr3d/deform/batched.py mesh
    path)."""
    from concurrent.futures import ThreadPoolExecutor

    from pbr3d.deform.batched import DeformEvalBatcher
    from pbr3d.deform.search import refine_parts
    from pbr3d.ops.point_table import build_point_table
    from pbr3d.parallel.sharding import scene_only_mesh

    size = 40
    mid = config.PART_IDS["front_minarets"]
    did = config.PART_IDS["dome"]
    cam = {
        "cam_pos": np.array([size * 2.0, size * 0.6, size * 2.0]),
        "target": np.array([size / 2, size / 2, size / 2]),
        "f": 2.0 * size,
        "cx": size / 2,
        "cy": size / 2,
    }
    grids, masks = [], []
    for s in range(2):
        g = np.zeros((size, size, size), np.uint8)
        g[14 + s : 26, 8 : 30 - 2 * s, 6:12] = mid
        g[12:24, 8 : 20 + s, 16:26] = did
        grids.append(g)
        m = np.zeros((size, size), np.uint8)
        m[6:32, 4 : 12 + s] = mid
        m[12 : 30 - s, 14:30] = did
        masks.append(m)

    kw = dict(
        part_names=["front_minarets", "dome"],
        search_stride=1, chunk=16,
        scale_range=(0.9, 1.1, 3), shift_range=(-8, 8, 3), refine_steps=3,
    )
    serial = [refine_parts(g, m, cam, table=build_point_table(g), **kw)
              for g, m in zip(grids, masks)]

    mesh = scene_only_mesh(2)
    batcher = DeformEvalBatcher(window_s=0.05, mesh=mesh)
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(refine_parts, g, m, cam,
                          table=build_point_table(g), batcher=batcher, **kw)
                for g, m in zip(grids, masks)]
        sharded = [f.result() for f in futs]
    assert batcher.dispatches > 0
    for s, b in zip(serial, sharded):
        assert set(s) == set(b)
        for p in s:
            assert s[p]["deform"] == b[p]["deform"], p
            assert s[p]["iou"] == b[p]["iou"], p


def test_batcher_releases_waiters_on_base_exception(monkeypatch):
    """A failure that is not an Exception (an interrupt, an exit) inside a
    grouped dispatch must still wake every chain waiting on that group."""
    import threading

    from pbr3d.deform import batched

    class Interrupt(BaseException):
        pass

    def boom(*a, **k):
        raise Interrupt()

    monkeypatch.setattr(batched, "_grouped_eval", boom)
    monkeypatch.setattr(batched, "_solo_eval", boom)
    batcher = batched.DeformEvalBatcher(window_s=30.0)
    errors = []
    for _ in range(2):  # both chains live before either submits: one group
        batcher.chain_enter()

    def chain():
        try:
            batcher.submit(("plain", False, 8, 8), (np.zeros(1),))
        except BaseException as e:  # noqa: BLE001 - the point of the test
            errors.append(type(e))
        finally:
            batcher.chain_exit()

    threads = [threading.Thread(target=chain, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads), "a waiter hung"
    assert errors == [Interrupt, Interrupt]
    assert batcher.dispatches == 1
