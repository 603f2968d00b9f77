"""Projection ops vs numpy restatements of the reference semantics."""

import numpy as np
import pytest

from pbr3d.camera.geometry import look_at_rotation, project_point
from pbr3d.ops.projection import (
    binary_iou,
    partwise_iou,
    project_visible,
    splat_labels,
    splat_partwise_iou_mm,
    zbuffer,
)

import jax.numpy as jnp


def _np_look_at(eye, target, up=np.array([0, 1, 0.0])):
    z = target - eye
    z = z / np.linalg.norm(z)
    if np.allclose(abs(np.dot(z, up)), 1.0):
        up = np.array([0, 0, 1.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def _np_project(pts, cam):
    R = _np_look_at(np.asarray(cam["cam_pos"], float), np.asarray(cam["target"], float))
    pc = (pts - cam["cam_pos"]) @ R.T
    X, Y, Z = pc.T
    Zc = np.where(Z < 1e-8, 1e-8, Z)
    u = X / Zc * cam["f"] + cam["cx"]
    v = -Y / Zc * cam["f"] + cam["cy"]
    return u, v, Z


CAM = {
    "cam_pos": np.array([10.0, 12.0, -80.0]),
    "target": np.array([16.0, 14.0, 16.0]),
    "f": 120.0,
    "cx": 32.0,
    "cy": 32.0,
}
H = W = 64


@pytest.fixture()
def pts_labels(rng):
    pts = rng.uniform(0, 32, (500, 3)).astype(np.float32)
    labels = rng.integers(1, 11, 500).astype(np.uint8)
    return pts, labels


def test_look_at_and_project(rng):
    eye = np.array([3.0, -2.0, -50.0])
    tgt = np.array([10.0, 5.0, 7.0])
    np.testing.assert_allclose(
        np.asarray(look_at_rotation(jnp.asarray(eye), jnp.asarray(tgt))),
        _np_look_at(eye, tgt),
        atol=1e-6,
    )
    # degenerate up: view along +Y
    eye2 = np.array([0.0, -10.0, 0.0])
    tgt2 = np.array([0.0, 5.0, 0.0])
    np.testing.assert_allclose(
        np.asarray(look_at_rotation(jnp.asarray(eye2), jnp.asarray(tgt2))),
        _np_look_at(eye2, tgt2),
        atol=1e-6,
    )
    pt = np.array([20.0, 9.0, 4.0])
    u, v, _ = _np_project(pt[None], CAM)
    np.testing.assert_allclose(
        np.asarray(project_point(pt, CAM)), [u[0], v[0]], rtol=1e-5
    )


def test_splat_last_write_wins(pts_labels):
    pts, labels = pts_labels
    ours = np.asarray(
        splat_labels(
            pts, labels, np.ones(len(pts), bool),
            CAM["cam_pos"], CAM["target"], CAM["f"], CAM["cx"], CAM["cy"], H, W,
        )
    )
    # numpy oracle: fancy assignment, last write wins
    u, v, _ = _np_project(pts.astype(np.float64), CAM)
    ui = np.round(u).astype(int)
    vi = np.round(v).astype(int)
    ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    ref = np.zeros((H, W), np.uint8)
    ref[vi[ok], ui[ok]] = labels[ok]
    np.testing.assert_array_equal(ours, ref)


def test_zbuffer_and_visible(pts_labels):
    pts, labels = pts_labels
    valid = np.ones(len(pts), bool)
    zb = np.asarray(
        zbuffer(pts, valid, CAM["cam_pos"], CAM["target"], CAM["f"], CAM["cx"], CAM["cy"], H, W)
    )
    u, v, Z = _np_project(pts.astype(np.float64), CAM)
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    ok = (Z > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    ref = np.full((H, W), np.inf, np.float32)
    for x, y, z in zip(ui[ok], vi[ok], Z[ok]):
        ref[y, x] = min(ref[y, x], np.float32(z))
    np.testing.assert_allclose(zb, ref, rtol=1e-6)

    vis = np.asarray(
        project_visible(
            pts[:100], valid[:100], jnp.asarray(zb),
            CAM["cam_pos"], CAM["target"], CAM["f"], CAM["cx"], CAM["cy"],
        )
    )
    ref_vis = np.zeros((H, W), bool)
    for x, y, z in zip(ui[:100], vi[:100], Z[:100]):
        if z > 1e-6 and 0 <= x < W and 0 <= y < H and abs(z - ref[y, x]) < 1e-3:
            ref_vis[y, x] = True
    np.testing.assert_array_equal(vis, ref_vis)


def test_partwise_iou(rng):
    a = rng.integers(0, 5, (32, 32)).astype(np.uint8)
    b = rng.integers(0, 5, (32, 32)).astype(np.uint8)
    ids = np.array([1, 2, 3, 4], np.int32)
    per, mean = partwise_iou(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids))
    per = np.asarray(per)
    for k, pid in enumerate(ids):
        inter = np.sum((a == pid) & (b == pid))
        union = np.sum((a == pid) | (b == pid))
        expect = inter / union if union else 0.0
        np.testing.assert_allclose(per[k], expect, rtol=1e-6)
    np.testing.assert_allclose(float(mean), per.mean(), rtol=1e-6)


def test_binary_iou_empty():
    z = jnp.zeros((4, 4), bool)
    assert np.isnan(float(binary_iou(z, z)))


def test_splat_partwise_iou_mm_matches_exact(rng):
    """The one-hot matmul objective vs splat_labels+partwise_iou.

    Single part: bit-exact (no cross-part collisions possible).  Two
    parts: equal except on pixels where both parts collide — there the
    surrogate resolves by part order instead of raster point order, so
    the tolerance is a small IoU epsilon (measured ≤5e-4 on random
    clouds)."""
    H, W = 64, 128
    for trial in range(6):
        N = int(rng.integers(100, 2000))
        pts = jnp.asarray(rng.uniform(0, 60, (N, 3)).astype(np.float32))
        valid = jnp.asarray(rng.random(N) > 0.1)
        gt = jnp.asarray(
            rng.choice([0, 4, 5], (H, W), p=[0.8, 0.1, 0.1]).astype(np.uint8))
        thw = jnp.asarray(
            [int(rng.integers(50, H + 1)), int(rng.integers(100, W + 1))],
            jnp.int32)
        cam = (jnp.asarray(rng.uniform(-30, 90, 3).astype(np.float32)),
               jnp.asarray(rng.uniform(0, 60, 3).astype(np.float32)),
               float(rng.uniform(40, 200)), W / 2.0, H / 2.0)
        ids1 = jnp.asarray([4], jnp.int32)
        lab1 = jnp.full((N,), 4, jnp.uint8)
        img = splat_labels(pts, lab1, valid, *cam, H, W, thw)
        exact = np.asarray(partwise_iou(img, gt, ids1)[0])
        mm = np.asarray(
            splat_partwise_iou_mm(pts, lab1, valid, *cam, gt, ids1, H, W,
                                  thw)[0])
        np.testing.assert_array_equal(exact, mm)

        ids2 = jnp.asarray([4, 5], jnp.int32)
        lab2 = jnp.asarray(rng.choice([4, 5], N).astype(np.uint8))
        mm2 = np.asarray(
            splat_partwise_iou_mm(pts, lab2, valid, *cam, gt, ids2, H, W,
                                  thw)[0])
        # numpy oracle of the DOCUMENTED surrogate semantics: per-part
        # pixel coverage, later part in part_ids wins collisions
        from pbr3d.ops.projection import _pixel_index
        from pbr3d.ops.cameramath import project_points

        u, v, _ = project_points(pts, *cam)
        pix, ok = _pixel_index(u, v, valid, H, W, thw)
        pix, okn = np.asarray(pix), np.asarray(ok)
        lab_n, gt_n = np.asarray(lab2), np.asarray(gt).reshape(-1)
        expect = []
        taken = np.zeros(H * W, bool)
        winners = {}
        for pid in [5, 4]:  # reversed part order
            cov = np.zeros(H * W + 1, bool)
            cov[pix[okn & (lab_n == pid)]] = True
            winners[pid] = cov[: H * W] & ~taken
            taken |= cov[: H * W]
        for pid in [4, 5]:
            g = gt_n == pid
            union = np.sum(winners[pid] | g)
            expect.append(
                np.float32(np.sum(winners[pid] & g)) / np.float32(union)
                if union else 0.0)
        np.testing.assert_allclose(mm2, np.asarray(expect, np.float32),
                                   rtol=1e-6)
