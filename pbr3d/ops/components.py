"""Connected components on device via min-label relaxation + segmented scans.

The reference leans on ``scipy.ndimage.label`` (3D, 6- or 26-connectivity;
reference: utils/voxel_carving_utils.py:175, utils/voxel_utils.py:26,
utils/camera_estimation.py:181) and ``skimage.measure.label`` (2D,
8-connectivity; utils/camera_estimation.py:264).  Sequential union-find does
not map to XLA, so we use the classic parallel formulation:

1. seed every foreground cell with its own flat index;
2. iterate: take the min label over the (masked) neighborhood — one
   vectorized sweep per step (Gauss-Seidel chained across axes);
3. accelerate with *pointer jumping*: ``label <- label[label]`` (a gather),
   which squashes long label chains logarithmically;
4. stop at fixpoint (``lax.while_loop``).

The final label of a component is the smallest flat index it contains, which
is also the raster order of first occurrence — i.e. scipy's numbering — so a
cheap monotone relabel gives scipy-identical output.

Per-component measurements (bbox / centroid / extent) are computed on device
with ``segment_min/max/sum`` reductions rather than host loops (the
reference's per-component ``np.argwhere`` loops are the stage-2 bottleneck,
~13 s for a 512³ grid; reference: utils/camera_estimation.py:176-210).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.int32(2**30)


def _shift_min(lab: jax.Array, axis: int) -> jax.Array:
    """min(lab, lab shifted ±1 along axis) with BIG fill at the borders."""
    n = lab.shape[axis]
    fwd = jnp.concatenate(
        [
            jax.lax.slice_in_dim(lab, 1, n, axis=axis),
            jnp.full(jax.lax.slice_in_dim(lab, 0, 1, axis=axis).shape, _BIG, lab.dtype),
        ],
        axis=axis,
    )
    bwd = jnp.concatenate(
        [
            jnp.full(jax.lax.slice_in_dim(lab, 0, 1, axis=axis).shape, _BIG, lab.dtype),
            jax.lax.slice_in_dim(lab, 0, n - 1, axis=axis),
        ],
        axis=axis,
    )
    return jnp.minimum(lab, jnp.minimum(fwd, bwd))


def _sweep(lab: jax.Array, mask: jax.Array, full_connectivity: bool) -> jax.Array:
    """One masked neighborhood-min pass."""
    if full_connectivity:
        # Chained 1D min-filters = min over the full 3^d box window.
        out = lab
        for ax in range(lab.ndim):
            out = _shift_min(out, ax)
    else:
        # Cross (face) neighborhood: min over ±1 shifts of the *input*.
        out = lab
        for ax in range(lab.ndim):
            out = jnp.minimum(out, _shift_min(lab, ax))
    return jnp.where(mask, jnp.minimum(lab, out), _BIG)


def _segmented_axis_min(lab: jax.Array, mask: jax.Array, axis: int) -> jax.Array:
    """Min-propagate labels along maximal contiguous mask runs of one axis.

    One forward + one backward segmented min-scan (``associative_scan`` —
    log-depth, fully vectorized, no gathers).
    """
    # f[i] = connected to the previous element along `axis`
    m = mask
    prev = jnp.concatenate(
        [
            jnp.zeros_like(jax.lax.slice_in_dim(m, 0, 1, axis=axis)),
            jax.lax.slice_in_dim(m, 0, m.shape[axis] - 1, axis=axis),
        ],
        axis=axis,
    )
    f_fwd = m & prev

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa & fb, jnp.where(fb, jnp.minimum(va, vb), vb)

    _, fwd = jax.lax.associative_scan(combine, (f_fwd, lab), axis=axis)

    nxt = jnp.concatenate(
        [
            jax.lax.slice_in_dim(m, 1, m.shape[axis], axis=axis),
            jnp.zeros_like(jax.lax.slice_in_dim(m, 0, 1, axis=axis)),
        ],
        axis=axis,
    )
    f_bwd = m & nxt
    _, bwd = jax.lax.associative_scan(
        combine, (f_bwd, lab), axis=axis, reverse=True
    )
    return jnp.minimum(fwd, bwd)


@functools.partial(jax.jit, static_argnames=("full_connectivity", "max_iters"))
def _label_roots(
    mask: jax.Array, full_connectivity: bool, max_iters: int = 1024
) -> jax.Array:
    """Foreground -> smallest flat index of its component; background -> BIG.

    Each iteration: one neighborhood-min sweep (handles the connectivity
    pattern) followed by segmented min-scans along every axis (propagates
    along straight runs arbitrarily far).  Converges in O(#bends) iterations
    — single digits for monument geometry — checked by fixpoint.
    """
    size = int(np.prod(mask.shape))
    idx = jnp.arange(size, dtype=jnp.int32).reshape(mask.shape)
    lab = jnp.where(mask, idx, _BIG)

    def cond(state):
        lab, prev, it = state
        return jnp.logical_and(jnp.any(lab != prev), it < max_iters)

    def body(state):
        lab, _, it = state
        new = _sweep(lab, mask, full_connectivity)
        for ax in range(mask.ndim):
            new = _segmented_axis_min(new, mask, ax)
        return new, lab, it + 1

    lab, _, _ = jax.lax.while_loop(cond, body, (lab, jnp.full_like(lab, -1), 0))
    return lab


def connected_components(
    mask, connectivity: str = "face"
) -> Tuple[np.ndarray, int]:
    """Label connected components of a boolean 2D/3D mask.

    ``connectivity``: "face" (scipy default: 4-conn in 2D, 6-conn in 3D) or
    "full" (3^d box: 8-conn in 2D, 26-conn in 3D — skimage's 2D default and
    ``structure=np.ones((3,3,3))``).

    Returns ``(labels int32 (same shape; 0 = background, 1..n in scipy raster
    order), n)`` as host numpy.  Where it runs is :func:`_use_host`'s
    choice.
    """
    if _use_host():
        return _host_scipy_label(np.asarray(mask), connectivity)
    return _device_label(mask, connectivity)


def _device_label(mask, connectivity: str = "face") -> Tuple[np.ndarray, int]:
    """The device labeling behind :func:`connected_components`, whatever
    the platform (scipy-identical labels and numbering)."""
    mask = jnp.asarray(mask, dtype=bool)
    roots = np.asarray(_label_roots(mask, connectivity == "full"))
    mask_np = roots < _BIG
    uniq = np.unique(roots[mask_np])
    labels = np.zeros(mask.shape, dtype=np.int32)
    if uniq.size:
        labels[mask_np] = np.searchsorted(uniq, roots[mask_np]) + 1
    return labels, int(uniq.size)


@functools.partial(jax.jit, static_argnames=("full_connectivity", "max_k"))
def _label_dense_device(mask: jax.Array, full_connectivity: bool, max_k: int):
    """Device-resident labeling: roots -> dense ids 1..n (0 = background).

    Uses ``jnp.unique(size=max_k+1)`` so shapes stay static; returns
    ``(labels int32, n int32, overflow bool)`` — ``overflow`` is True when
    the mask has more than ``max_k`` components (caller must fall back).
    Component ids follow scipy's raster order (roots are min flat indices).
    """
    roots = _label_roots(mask, full_connectivity)
    uniq = jnp.unique(roots.ravel(), size=max_k + 1, fill_value=_BIG)
    n = jnp.sum(uniq < _BIG).astype(jnp.int32)
    # overflow iff more than max_k distinct real roots exist: then the
    # (sorted, truncated) uniq contains no fill/background slot left
    overflow = uniq[max_k] < _BIG
    idx = jnp.searchsorted(uniq, roots)
    labels = jnp.where(roots >= _BIG, 0, idx + 1).astype(jnp.int32)
    return labels, n, overflow


#: Where ``PBR3D_COMPONENTS=auto`` labels, per platform (others: host).
#: cpu: device — the device program is host code there.  gpu: host — on
#: an H100 (700 W limit) the device labels equal scipy's, numbering
#: included, on nine part masks of the derived Bibi and Taj grids at 512
#: per side, but take 2.98 s warm in total against 1.41 s for host scipy
#: (the relaxation loop's sequential sweeps; see PERF.md).
_AUTO_PATH = {"cpu": "device", "gpu": "host"}


def _platform() -> str:
    return jax.devices()[0].platform


def _use_host() -> bool:
    """``PBR3D_COMPONENTS`` = ``host`` | ``device`` forces a path;
    ``auto`` (default) follows ``_AUTO_PATH``."""
    import os

    mode = os.environ.get("PBR3D_COMPONENTS", "auto")
    if mode == "auto":
        mode = _AUTO_PATH.get(_platform(), "host")
    return mode == "host"


def connected_components_device(
    mask, connectivity: str = "face", max_k: int = 256
) -> Tuple[jax.Array, int]:
    """Like :func:`connected_components` but keeping labels on device — for
    consumers that slice/compare them there (guided carving, recoloring).

    Where it runs is :func:`_use_host`'s choice; host labels are uploaded.
    """
    mask = jnp.asarray(mask, dtype=bool)
    if _use_host():
        labels, n = _host_scipy_label(np.asarray(mask), connectivity)
        return jnp.asarray(labels), n
    labels, n, overflow = _label_dense_device(mask, connectivity == "full", max_k)
    if bool(overflow):
        host_labels, n = connected_components(mask, connectivity)
        return jnp.asarray(host_labels), n
    return labels, int(n)


def _host_component_stats(labels: np.ndarray, n: int, centroid_axes=None):
    """Host bbox/centroid/count: find_objects (fast C) for the bboxes, then
    counts/centroids via weighted bincounts — O(N) total, independent of the
    component count (a per-component argwhere loop is O(N * n)).

    ``centroid_axes``: which centroid columns to fill (None = all axes,
    () = none).  Each axis materializes a float64 weight array the size of
    ``labels`` (~134 MB on near-full-grid crops), so callers that only need
    bboxes/counts skip it."""
    import scipy.ndimage

    nd = labels.ndim
    rows = n + 1
    mins = np.full((rows, nd), _BIG, np.int64)
    maxs = np.full((rows, nd), -1, np.int64)

    slices = scipy.ndimage.find_objects(labels, max_label=n)
    vol = 0
    for i, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        mins[i] = [s.start for s in sl]
        maxs[i] = [s.stop - 1 for s in sl]
        vol += int(np.prod([s.stop - s.start for s in sl]))

    counts = np.zeros((rows,), np.float64)
    centroid = np.zeros((rows, nd), np.float64)
    axes = tuple(range(nd)) if centroid_axes is None else tuple(centroid_axes)

    if vol * (1 + len(axes)) < labels.size:
        # sparse components (e.g. minaret columns inside a near-full-grid
        # crop): per-slice reductions touch only the bbox volumes —
        # axis profiles via sum() then a dot with arange, no argwhere
        for i, sl in enumerate(slices, start=1):
            if sl is None:
                continue
            local = labels[sl] == i
            c = float(local.sum())
            counts[i] = c
            if c == 0.0:
                continue
            for ax in axes:
                other = tuple(a for a in range(nd) if a != ax)
                prof_ax = local.sum(axis=other, dtype=np.float64)
                idx = np.arange(sl[ax].start, sl[ax].stop, dtype=np.float64)
                centroid[i, ax] = float(prof_ax @ idx) / c
        return {
            "bbox_min": mins,
            "bbox_max": maxs,
            "centroid": centroid,
            "count": counts,
        }

    # np.bincount fast-paths ONLY intp input: on this numpy (2.0.2) an int32
    # array goes through a ~500x slower path (measured 10.4 s vs 0.018 s on
    # 5.9M elements) — always upcast
    flat = labels.ravel().astype(np.intp, copy=False)
    counts = np.bincount(flat, minlength=rows)[:rows].astype(np.float64)
    counts[0] = 0.0  # background is not a component
    occupied = counts > 0
    for ax in axes:
        shape = [1] * nd
        shape[ax] = labels.shape[ax]
        w = np.broadcast_to(
            np.arange(labels.shape[ax], dtype=np.float64).reshape(shape),
            labels.shape,
        )
        sums = np.bincount(flat, weights=w.ravel(), minlength=rows)[:rows]
        centroid[occupied, ax] = sums[occupied] / counts[occupied]
    return {
        "bbox_min": mins,
        "bbox_max": maxs,
        "centroid": centroid,
        "count": counts,
    }


#: Below this voxel count the axis-0 divide-and-conquer in
#: ``_host_scipy_label`` stops paying for its occupancy scan.
_LABEL_SPLIT_MIN = 1 << 21


def _host_scipy_label(mask_np: np.ndarray, connectivity: str) -> Tuple[np.ndarray, int]:
    """Connected components, scipy-identical output (labels AND numbering).

    Large 3-D inputs are split along axis 0 at an EMPTY slab when one
    exists: no component can cross an all-empty plane (under either face
    or full connectivity), and scipy numbers components by first-voxel
    scan order with axis 0 outermost, so labeling the two sides
    independently and offsetting the right side's ids reproduces scipy's
    exact numbering.  The carving parts this labels (e.g. minarets at the
    grid's x-extremes inside a near-full-grid bbox) typically halve, and
    each side then recurses on its own tight x-range — full-grid labels
    shrink to the occupied slices."""
    import scipy.ndimage

    structure = None
    if connectivity == "full":
        structure = np.ones((3,) * mask_np.ndim, dtype=bool)

    if mask_np.ndim == 3 and mask_np.size >= _LABEL_SPLIT_MIN:
        colocc = mask_np.any(axis=(1, 2))
        nz = np.flatnonzero(colocc)
        if nz.size == 0:
            return np.zeros(mask_np.shape, np.int32), 0
        x0, x1 = int(nz[0]), int(nz[-1]) + 1
        # largest interior empty run within the occupied x-range
        runs = np.flatnonzero(~colocc[x0:x1])
        split = None
        if runs.size:
            breaks = np.flatnonzero(np.diff(runs) > 1)
            starts = np.concatenate([[0], breaks + 1])
            ends = np.concatenate([breaks, [runs.size - 1]])
            lens = runs[ends] - runs[starts] + 1
            k = int(np.argmax(lens))
            split = x0 + int(runs[starts[k]])  # first empty x of the run
        out = np.zeros(mask_np.shape, np.int32)
        if split is not None:
            left, nl = _host_scipy_label(mask_np[x0:split], connectivity)
            right, nr = _host_scipy_label(mask_np[split:x1], connectivity)
            out[x0:split] = left
            np.add(right, np.int32(nl), out=right, where=right > 0)
            out[split:x1] = right
            return out, nl + nr
        if x1 - x0 < mask_np.shape[0]:
            inner, n = _host_scipy_label(mask_np[x0:x1], connectivity)
            out[x0:x1] = inner
            return out, n

    labels, n = scipy.ndimage.label(mask_np, structure=structure)
    return labels.astype(np.int32), int(n)


@functools.partial(jax.jit, static_argnames=("num_segments",))
def _component_stats_jit(labels: jax.Array, num_segments: int):
    """Per-component bbox/centroid via masked full-array reductions.

    Scatter-free: a ``lax.map`` over the component slots with plain
    min/max/sum reductions, deterministic on every backend (no float
    scatter-adds, whose atomic order varies on the GPU).
    """
    nd = labels.ndim
    coords = [
        jax.lax.broadcasted_iota(jnp.int32, labels.shape, ax) for ax in range(nd)
    ]

    def one(k):
        m = labels == k
        mins = jnp.stack(
            [jnp.min(jnp.where(m, c, _BIG)) for c in coords])
        maxs = jnp.stack(
            [jnp.max(jnp.where(m, c, -1)) for c in coords])
        sums = jnp.stack(
            [jnp.sum(jnp.where(m, c, 0).astype(jnp.float32)) for c in coords])
        count = jnp.sum(m.astype(jnp.float32))
        return mins, maxs, sums, count

    mins, maxs, sums, counts = jax.lax.map(
        one, jnp.arange(num_segments, dtype=jnp.int32)
    )
    return mins, maxs, sums, counts


def component_stats(labels: np.ndarray, n: int):
    """Per-component bbox & centroid, computed on device.

    Returns dict of host arrays indexed by component id 1..n (index 0 unused;
    trailing rows beyond n are padding):
    ``bbox_min (>=n+1, nd)``, ``bbox_max`` (inclusive), ``centroid``,
    ``count``.

    The slot count is bucketed ({17, 65, 257, ...}) so calls share compiled
    programs while the masked-reduction cost stays proportional to the
    actual component count.  Host stats (scipy/bincount) when
    :func:`_use_host` picks the host.
    """
    if _use_host():
        return _host_component_stats(np.asarray(labels), n)
    num_segments = 17
    while num_segments <= n:
        num_segments = (num_segments - 1) * 4 + 1
    mins, maxs, sums, counts = _component_stats_jit(jnp.asarray(labels), num_segments)
    mins, maxs, sums, counts = map(np.asarray, (mins, maxs, sums, counts))
    centroid = sums / np.maximum(counts, 1.0)[:, None]
    return {
        "bbox_min": mins,
        "bbox_max": maxs,
        "centroid": centroid,
        "count": counts,
    }
