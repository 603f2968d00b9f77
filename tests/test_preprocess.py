"""Notebook-5 preprocessing: PLY IO, RANSAC, ICP, symmetric completion."""

import numpy as np
import pytest

from pbr3d.eval.preprocess import (
    align_plane_to_z,
    build_taj_clouds,
    icp_point_to_point,
    rodrigues_rotation,
    segment_plane,
    symmetric_completion,
)
from pbr3d.io.pointcloud import load_ply, save_ply, load_obj, sample_mesh_surface


def test_ply_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(100, 3))
    cols = rng.integers(0, 255, (100, 3)).astype(np.uint8)
    save_ply(tmp_path / "t.ply", pts, cols)
    d = load_ply(tmp_path / "t.ply")
    np.testing.assert_allclose(d["points"], pts)
    np.testing.assert_array_equal(d["colors"], cols)


def test_load_reference_ply(golden_root):
    d = load_ply(f"{golden_root}/4.Inter-method_3D/segmented_point_cloud_final.ply")
    assert d["points"].shape == (52032, 3)
    assert "colors" in d and d["colors"].shape == (52032, 3)


def test_obj_load_and_sample(tmp_path, rng):
    with open(tmp_path / "m.obj", "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n")
    v, fc = load_obj(tmp_path / "m.obj")
    assert v.shape == (4, 3) and fc.shape == (2, 3)
    s = sample_mesh_surface(v, fc, 500)
    assert s.shape == (500, 3)
    assert (s[:, 2] == 0).all() and (s[:, :2] >= 0).all() and (s[:, :2] <= 1).all()


def test_ransac_plane(rng):
    n = np.array([0.3, 0.5, 0.81])
    n = n / np.linalg.norm(n)
    basis = np.linalg.svd(n[None])[2][1:]
    plane_pts = rng.uniform(-1, 1, (1500, 2)) @ basis + 0.37 * n
    plane_pts += rng.normal(scale=0.002, size=plane_pts.shape)
    noise = rng.uniform(-1, 1, (300, 3))
    pts = np.vstack([plane_pts, noise])
    plane, inliers = segment_plane(pts, 0.01, 1000, seed=0)
    est_n = plane[:3] * np.sign(plane[:3] @ n)
    assert np.dot(est_n, n) > 0.999
    assert len(inliers) > 1200
    # rotation takes the plane normal to +Z
    rot = align_plane_to_z(pts, plane)
    plane2, _ = segment_plane(rot, 0.01, 1000, seed=1)
    assert abs(plane2[2]) > 0.999


def test_icp_recovers_rigid_transform(rng):
    P = rng.normal(size=(800, 3))
    R = rodrigues_rotation(np.array([0.2, 1.0, 0.1]), 0.05)
    t = np.array([0.02, -0.01, 0.03])
    Q = P @ R.T + t
    aligned, T = icp_point_to_point(P, Q, max_correspondence_distance=0.5)
    err = np.linalg.norm(aligned - Q, axis=1).mean()
    assert err < 1e-3


def test_symmetric_completion_shapes(rng):
    front = rng.normal(size=(200, 3))
    sides = symmetric_completion(front)
    assert set(sides) == {"front", "back", "left", "right"}
    # back is a z-mirror: z means reflect about mid
    zmid = (front[:, 2].min() + front[:, 2].max()) / 2
    np.testing.assert_allclose(sides["back"][:, 2], 2 * zmid - front[:, 2])
    np.testing.assert_allclose(sides["back"][:, :2], front[:, :2])


@pytest.mark.slow
def test_build_taj_clouds(golden_root, tmp_path, rng):
    # Subsample the 52k-point reference cloud so the 3 ICP runs stay fast on
    # the CPU test backend.
    import shutil
    src = f"{golden_root}/4.Inter-method_3D"
    d = load_ply(f"{src}/segmented_point_cloud_final.ply")
    sel = rng.choice(len(d["points"]), 4000, replace=False)
    save_ply(tmp_path / "segmented_point_cloud_final.ply",
             d["points"][sel], d["colors"][sel])
    shutil.copy(f"{src}/Taj_voxel_grid.npz", tmp_path / "Taj_voxel_grid.npz")
    clouds = build_taj_clouds(tmp_path)
    assert "Sparse" in clouds and "Completed (ICP Aligned)" in clouds
    assert "Carved Grid" in clouds  # Taj_voxel_grid.npz is present
    assert len(clouds["Completed (ICP Aligned)"]) == 4 * len(clouds["Sparse"])
    # the completion quadruples the cloud around the same center region
    c = clouds["Completed (ICP Aligned)"]
    s = clouds["Sparse"]
    assert np.linalg.norm(c.mean(0) - s.mean(0)) < np.linalg.norm(s.std(0)) * 2
