"""Eval ops & metrics vs scipy/sklearn oracles."""

import numpy as np
import pytest
import scipy.ndimage
from scipy.spatial import cKDTree

import jax.numpy as jnp

from pbr3d.eval import inter
from pbr3d.ops.isosurface import marching_tetrahedra
from pbr3d.ops.morphology import binary_dilation, gaussian_filter
from pbr3d.ops.neighbors import knn, min_dist, self_nn_dist


def test_min_dist_matches_kdtree(rng):
    A = rng.normal(size=(777, 3)).astype(np.float32)
    B = rng.normal(size=(1311, 3)).astype(np.float32)
    ours = min_dist(A, B)
    ref, _ = cKDTree(B).query(A, k=1)
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-4)


def test_knn_matches_kdtree(rng):
    A = rng.normal(size=(300, 3)).astype(np.float32)
    B = rng.normal(size=(500, 3)).astype(np.float32)
    d, idx = knn(A, B, k=5)
    ref_d, ref_i = cKDTree(B).query(A, k=5)
    np.testing.assert_allclose(d, ref_d, rtol=2e-3, atol=2e-4)
    # indices can differ on exact ties; distances must agree
    np.testing.assert_allclose(
        np.linalg.norm(A[:, None] - B[idx], axis=-1), ref_d, rtol=2e-3, atol=2e-4
    )


def test_self_nn(rng):
    P = rng.normal(size=(400, 3)).astype(np.float32)
    ours = self_nn_dist(P)
    ref, _ = cKDTree(P).query(P, k=2)
    np.testing.assert_allclose(ours, ref[:, 1], rtol=2e-3, atol=2e-4)


def test_chamfer_and_fscore(rng):
    A = rng.normal(size=(800, 3)).astype(np.float32)
    B = (A + rng.normal(scale=0.01, size=A.shape)).astype(np.float32)
    cd = inter.chamfer_distance(A, B)
    dA, _ = cKDTree(B).query(A, k=1)
    dB, _ = cKDTree(A).query(B, k=1)
    np.testing.assert_allclose(cd, np.mean(dA**2) + np.mean(dB**2), rtol=1e-2)
    f1, p, r = inter.fscore_with_threshold(A, B, tau=0.05)
    assert f1 > 0.9 and p > 0.9 and r > 0.9


def test_voxel_iou_vs_scipy(rng):
    A = rng.uniform(0, 1, (2000, 3))
    B = A + 0.02
    ours = inter.voxel_iou(A, B, resolution=32, dilate_frac=0.01)

    all_pts = np.vstack([A, B])
    lo, hi = all_pts.min(0), all_pts.max(0)
    step = (hi - lo).max() / 32

    def occ(P):
        idx = np.clip(((P - lo) / step).astype(int), 0, 31)
        g = np.zeros((32,) * 3, bool)
        g[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        return g

    oA, oB = occ(A), occ(B)
    iters = max(1, int(round(0.01 * np.linalg.norm(hi - lo) / step)))
    oA = scipy.ndimage.binary_dilation(oA, iterations=iters)
    oB = scipy.ndimage.binary_dilation(oB, iterations=iters)
    ref = (oA & oB).sum() / (oA | oB).sum()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_binary_dilation_matches_scipy(rng):
    m = rng.random((20, 22, 24)) > 0.9
    for iters in (1, 3):
        ours = np.asarray(binary_dilation(jnp.asarray(m), iters))
        ref = scipy.ndimage.binary_dilation(m, iterations=iters)
        np.testing.assert_array_equal(ours, ref)


def test_gaussian_filter_matches_scipy(rng):
    v = rng.normal(size=(24, 20, 18)).astype(np.float32)
    ours = np.asarray(gaussian_filter(jnp.asarray(v), sigma=1.0))
    ref = scipy.ndimage.gaussian_filter(v, sigma=1.0)
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_pca_similarity():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(500, 3)) * np.array([3.0, 2.0, 1.0])
    assert inter.pca_shape_similarity(A, A.copy()) > 0.999
    B = rng.normal(size=(500, 3)) * np.array([1.0, 1.0, 1.0])
    assert inter.pca_shape_similarity(A, B) < 0.95


def test_marching_tetrahedra_sphere():
    n = 32
    x, y, z = np.meshgrid(*([np.arange(n)] * 3), indexing="ij")
    r = np.sqrt((x - 16.0) ** 2 + (y - 16.0) ** 2 + (z - 16.0) ** 2)
    grid = (r < 10).astype(np.float32)
    verts, faces = marching_tetrahedra(grid, 0.5)
    assert len(verts) > 100 and len(faces) > 100
    # vertices lie near the iso radius
    d = np.linalg.norm(verts - 16.0, axis=1)
    assert abs(d.mean() - 10.0) < 1.0
    # closed surface: every edge shared by exactly 2 faces
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    # outward winding: normals point away from center
    tri = verts[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outward = np.einsum("md,md->m", nrm, tri.mean(1) - 16.0)
    assert (outward > 0).mean() > 0.99


def test_surface_metrics_smooth_vs_rough(rng):
    # Perturbing the vertices of the SAME mesh must raise every roughness
    # statistic (same tessellation, so the comparison isolates the metric).
    p = rng.normal(size=(4000, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    verts, faces = inter.get_marching_cubes_mesh(p, grid_size=48, sigma=1.0, level=0.2)
    assert len(verts) and len(faces)
    ms = inter.compute_surface_metrics(verts, faces)
    noisy = verts + rng.normal(scale=0.01, size=verts.shape).astype(np.float32)
    mr = inter.compute_surface_metrics(noisy, faces)
    assert ms["Normal StdDev (°)"] < mr["Normal StdDev (°)"]
    assert ms["Mean Roughness (λ₃)"] < mr["Mean Roughness (λ₃)"]


def test_marching_cubes_sphere_manifold_and_accurate():
    """The generated 256-case table must produce a closed manifold with
    cube-edge-only vertices and near-exact area/volume on a smooth field."""
    from pbr3d.ops.isosurface import marching_cubes

    n, r = 40, 14.0
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    field = (r - np.sqrt((x - 20.0) ** 2 + (y - 20.0) ** 2 + (z - 20.0) ** 2))
    verts, faces = marching_cubes(field.astype(np.float32), 0.0)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    counts = np.unique(np.sort(e, 1), axis=0, return_counts=True)[1]
    assert (counts == 2).all()  # strictly manifold on a smooth field
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    ).sum()
    vol = abs(np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6)
    assert abs(area / (4 * np.pi * r * r) - 1) < 0.01
    assert abs(vol / (4 / 3 * np.pi * r ** 3) - 1) < 0.01
    # skimage-comparable topology: vertices on cube edges only
    fracs = (np.abs(verts - np.round(verts)) > 1e-6).sum(1)
    assert (fracs <= 1).all()
    # outward winding (occupancy convention)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert (np.einsum("ij,ij->i", nrm, tri.mean(1) - 20.0) > 0).mean() > 0.99


def test_marching_cubes_random_volumes_closed(rng):
    """Watertight by construction: no boundary edges on any binary volume
    (pinch edges shared by 4 faces are legitimate MC topology)."""
    from pbr3d.ops.isosurface import marching_cubes

    for _ in range(10):
        g = np.zeros((10, 10, 10), np.float32)
        g[1:-1, 1:-1, 1:-1] = rng.random((8, 8, 8)) > 0.5
        _, faces = marching_cubes(g, 0.5)
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        counts = np.unique(np.sort(e, 1), axis=0, return_counts=True)[1]
        assert (counts % 2 == 0).all()


def test_marching_cubes_agrees_with_tetrahedra():
    """Two independently-derived extractors must agree on integral surface
    properties of a SMOOTH field (cross-validates the generated MC table;
    on binary fields the two resolve ambiguous diagonal cells differently,
    which is inherent, not a bug)."""
    from pbr3d.ops.isosurface import marching_cubes, marching_tetrahedra
    from pbr3d.ops.morphology import gaussian_filter

    rng = np.random.default_rng(7)
    g = np.zeros((18, 18, 18), np.float32)
    g[3:-3, 3:-3, 3:-3] = (rng.random((12, 12, 12)) > 0.4)
    g = np.asarray(gaussian_filter(g, 1.5))
    vols = []
    for fn in (marching_cubes, marching_tetrahedra):
        v, f = fn(g, float(g.max()) * 0.5)
        tri = v[f]
        vols.append(
            abs(np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6)
        )
    assert vols[0] == pytest.approx(vols[1], rel=0.01)
