"""connected_components vs scipy.ndimage.label."""

import numpy as np
import pytest
import scipy.ndimage

from pbr3d.ops.components import connected_components, component_stats


def _same_partition(a, b):
    """Labelings are equivalent up to renaming."""
    assert (a > 0).sum() == (b > 0).sum()
    pairs = set(zip(a[a > 0].ravel(), b[a > 0].ravel()))
    return len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs})


@pytest.mark.parametrize("shape", [(20, 20, 20), (9, 31, 13)])
def test_face_connectivity_3d(rng, shape):
    mask = rng.random(shape) > 0.7
    ours, n = connected_components(mask, "face")
    ref, n_ref = scipy.ndimage.label(mask)
    assert n == n_ref
    assert _same_partition(ours, ref)
    # scipy raster-order numbering should match exactly.
    np.testing.assert_array_equal(ours, ref)


def test_full_connectivity_3d(rng):
    mask = rng.random((16, 16, 16)) > 0.6
    ours, n = connected_components(mask, "full")
    ref, n_ref = scipy.ndimage.label(mask, structure=np.ones((3, 3, 3)))
    assert n == n_ref
    assert _same_partition(ours, ref)


def test_2d_full_connectivity(rng):
    mask = rng.random((40, 33)) > 0.6
    ours, n = connected_components(mask, "full")
    ref, n_ref = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
    assert n == n_ref
    assert _same_partition(ours, ref)


def test_host_label_split_matches_scipy_exactly(rng):
    """The axis-0 divide-and-conquer in _host_scipy_label must reproduce
    scipy's labels AND numbering bit-exactly (the carve windows and the
    minaret ranking both consume them).  Build a volume above the split
    threshold with clustered blobs separated by empty x-slabs — the shape
    that triggers recursive splits."""
    from pbr3d.ops.components import _LABEL_SPLIT_MIN, _host_scipy_label

    shape = (160, 128, 128)
    assert np.prod(shape) >= _LABEL_SPLIT_MIN
    mask = np.zeros(shape, bool)
    for xc in (10, 70, 140):  # clusters with empty slabs between them
        blk = rng.random((20, 128, 128)) > 0.72
        mask[xc : xc + 20] |= blk
    for conn, structure in (("face", None), ("full", np.ones((3, 3, 3)))):
        ours, n = _host_scipy_label(mask, conn)
        ref, n_ref = scipy.ndimage.label(mask, structure=structure)
        assert n == n_ref
        np.testing.assert_array_equal(ours, ref.astype(np.int32))


def test_component_stats(rng):
    mask = rng.random((15, 15, 15)) > 0.75
    labels, n = connected_components(mask, "face")
    stats = component_stats(labels, n)
    for i in range(1, n + 1):
        coords = np.argwhere(labels == i)
        np.testing.assert_array_equal(stats["bbox_min"][i], coords.min(0))
        np.testing.assert_array_equal(stats["bbox_max"][i], coords.max(0))
        np.testing.assert_allclose(stats["centroid"][i], coords.mean(0), rtol=1e-5)
        assert stats["count"][i] == len(coords)


def test_device_components_match_host(rng):
    from pbr3d.ops.components import connected_components_device
    import jax.numpy as jnp

    mask = rng.random((18, 22, 14)) > 0.72
    host, n_host = connected_components(mask, "face")
    dev, n_dev = connected_components_device(jnp.asarray(mask), "face")
    assert n_dev == n_host
    np.testing.assert_array_equal(np.asarray(dev), host)


def test_device_components_overflow_fallback(rng):
    from pbr3d.ops.components import connected_components_device
    import jax.numpy as jnp

    # a checkerboard has ~half the voxels as isolated comps -> overflow
    mask = np.indices((12, 12, 12)).sum(0) % 2 == 0
    dev, n = connected_components_device(jnp.asarray(mask), "face", max_k=16)
    host, n_host = connected_components(mask, "face")
    assert n == n_host
    np.testing.assert_array_equal(np.asarray(dev), host)


def test_auto_path_per_platform(monkeypatch):
    """``auto`` labels on the device on the CPU backend and on the host on
    a GPU; the environment variable forces either."""
    from pbr3d.ops import components

    monkeypatch.delenv("PBR3D_COMPONENTS", raising=False)
    for platform, host in (("cpu", False), ("gpu", True), ("other", True)):
        monkeypatch.setattr(components, "_platform", lambda p=platform: p)
        assert components._use_host() is host
    for mode, host in (("host", True), ("device", False)):
        monkeypatch.setenv("PBR3D_COMPONENTS", mode)
        assert components._use_host() is host
