"""Cross-monument lockstep batching for the stage-3 deform searches.

The per-part candidate evaluation (`deform/search.py`) is a chain of small
device programs: ~64-128 candidates x a 16-32k-point shell per dispatch,
a fixed per-dispatch cost on top of the per-point-candidate work.
run_all refines monuments on
worker threads, so five monuments' chains hit the device with five separate
small programs per search stage — five blocking dispatches and five program
launches for work that is shape-identical across monuments.

This module gives those chains a shared :class:`DeformEvalBatcher`: each
chain submits its stage evaluation and blocks; the batcher groups
shape-compatible submissions, stacks them along a leading SCENE axis, and
dispatches ONE vmapped program for the whole group (the round-4 verdict's
"monument axis next to the candidate axis").  Grouping changes nothing
numerically — the scene axis is `jax.vmap` over per-slot computations that
are bit-identical to the unbatched programs (tests/test_parallel.py asserts
equality) — so batch composition may vary freely with thread timing.

Flush policy (self-clocking lockstep): a group flushes as soon as EVERY
live chain is blocked inside the batcher (no further submissions can
arrive), or when the oldest submission exceeds the batching window.
Chains register around their refine passes so the batcher knows how many
peers may still submit.

The scene axis is also the multi-device axis: given a `jax.sharding.Mesh`
with a ``scene`` dimension, the batcher shards each group's stacked inputs
over it, so on an N-device mesh the monuments' searches run on N devices
(SURVEY §5 distributed row; `__graft_entry__.dryrun_multichip` exercises
this path on virtual CPU devices).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pbr3d.deform.warp import deform_coords_soa
from pbr3d.ops.projection import zbuffer_soa

#: Arguments of one eval slot, in stacking order (all device/NumPy arrays).
_EV_FIELDS = (
    "deforms", "coords", "valid", "cam_vec", "gt_part", "rest_zbuf",
    "true_hw", "voxel_shape", "center",
)
_NB_FIELDS = ("nb_zb", "nb_base", "nb_gt", "nb_floor", "nb_valid")
_ZB_FIELDS = (
    "deform", "coords", "valid", "cam_vec", "true_hw", "voxel_shape",
    "center",
)


def _one_pen(approx, H, W, a):
    """Per-slot penalized eval — mirrors
    `search._batch_deform_visible_iou_penalized` exactly (same ops, same
    order) so a vmap over slots is bit-identical to the per-monument
    programs."""
    (deforms, coords, valid, cam_vec, gt_part, rest_zbuf, true_hw,
     voxel_shape, center, nb_zb, nb_base, nb_gt, nb_floor, nb_valid) = a
    from pbr3d.deform.search import VIS_EPS

    def one(d):
        xs, ys, zs, v = deform_coords_soa(
            coords, valid, true_hw, voxel_shape, d, center, approx=approx
        )
        zc = zbuffer_soa(
            xs, ys, zs, v,
            cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
            H, W, true_hw=true_hw,
        )
        visible = zc < rest_zbuf + VIS_EPS
        inter = jnp.sum(visible & gt_part).astype(jnp.float32)
        union = jnp.sum(visible | gt_part).astype(jnp.float32)
        own = jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0)
        zc2 = zc.reshape(H // 2, 2, W // 2, 2).min(axis=(1, 3))
        pass_z = nb_zb < zc2[None] + VIS_EPS
        vis_q = nb_base & pass_z
        inter_q = jnp.sum(vis_q & nb_gt, axis=(1, 2)).astype(jnp.float32)
        union_q = jnp.sum(vis_q | nb_gt, axis=(1, 2)).astype(jnp.float32)
        iou_q = jnp.where(union_q > 0, inter_q / jnp.maximum(union_q, 1.0), 0.0)
        gain = jnp.where(nb_valid, iou_q, 0.0)
        drop = jnp.where(nb_valid, jnp.maximum(nb_floor - iou_q, 0.0), 0.0)
        return jnp.stack([own, jnp.sum(gain), jnp.sum(drop)])

    return jax.vmap(one)(deforms)


def _one_plain(approx, H, W, a):
    """Per-slot plain visible-IoU eval (no neighbor terms) — mirrors
    `search._batch_deform_visible_iou`."""
    (deforms, coords, valid, cam_vec, gt_part, rest_zbuf, true_hw,
     voxel_shape, center) = a
    from pbr3d.deform.search import VIS_EPS

    def one(d):
        xs, ys, zs, v = deform_coords_soa(
            coords, valid, true_hw, voxel_shape, d, center, approx=approx
        )
        zc = zbuffer_soa(
            xs, ys, zs, v,
            cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
            H, W, true_hw=true_hw,
        )
        visible = zc < rest_zbuf + VIS_EPS
        inter = jnp.sum(visible & gt_part).astype(jnp.float32)
        union = jnp.sum(visible | gt_part).astype(jnp.float32)
        return jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0)

    return jax.vmap(one)(deforms)


def _one_zb(H, W, a):
    """Per-slot full-set z-buffer — mirrors `search.deformed_zbuffer`."""
    (deform, coords, valid, cam_vec, true_hw, voxel_shape, center) = a
    xs, ys, zs, v = deform_coords_soa(
        coords, valid, true_hw, voxel_shape, deform, center,
    )
    return zbuffer_soa(
        xs, ys, zs, v,
        cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
        H, W, true_hw=true_hw,
    )


@functools.partial(jax.jit, static_argnames=("kind", "approx", "H", "W"))
def _grouped_eval_stacked(kind: str, approx: bool, H: int, W: int, *stacked):
    """Mesh-shardable form of :func:`_grouped_eval`: every argument already
    carries the leading scene axis, so `jit` partitions the program along it
    when the inputs are placed with a ``scene`` `NamedSharding` (each
    monument's slot computes on its own chip; there is no cross-slot
    communication to insert)."""
    if kind == "pen":
        f = functools.partial(_one_pen, approx, H, W)
    elif kind == "plain":
        f = functools.partial(_one_plain, approx, H, W)
    else:
        f = functools.partial(_one_zb, H, W)
    return jax.vmap(lambda *a: f(tuple(a)))(*stacked)


@functools.partial(
    jax.jit, static_argnames=("kind", "approx", "H", "W", "M"))
def _grouped_eval(kind: str, approx: bool, H: int, W: int, M: int, *flat):
    """One device program for an M-slot group.

    ``flat`` holds M tuples of per-slot arrays, flattened; slots are stacked
    along a leading scene axis INSIDE the traced program (no separate
    stack executables) and vmapped."""
    nargs = len(flat) // M
    slots = [flat[i * nargs : (i + 1) * nargs] for i in range(M)]
    stacked = tuple(
        jnp.stack([s[j] for s in slots]) for j in range(nargs)
    )
    if kind == "pen":
        f = functools.partial(_one_pen, approx, H, W)
    elif kind == "plain":
        f = functools.partial(_one_plain, approx, H, W)
    else:
        f = functools.partial(_one_zb, H, W)
    return jax.vmap(f)(stacked)


class _Entry:
    __slots__ = ("arrays", "event", "result", "error")

    def __init__(self, arrays):
        self.arrays = arrays
        self.event = threading.Event()
        self.result = None
        self.error = None


class DeformEvalBatcher:
    """Groups concurrent stage-3 eval submissions into scene-stacked
    dispatches.  Thread-safe; one instance is shared by all monument chains
    of a `run_all` (see module docstring for the flush policy)."""

    def __init__(self, window_s: float = 0.02, mesh=None,
                 max_slots: int = 8):
        self.window_s = float(window_s)
        self.mesh = mesh
        self.max_slots = int(max_slots)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._groups: Dict[Tuple, List[_Entry]] = {}
        self._alive = 0
        self._waiting = 0
        # diagnostics
        self.dispatches = 0
        self.slots_total = 0

    # -- chain bookkeeping -------------------------------------------------
    def chain_enter(self):
        with self._cond:
            self._alive += 1

    def chain_exit(self):
        with self._cond:
            self._alive -= 1
            # a departing chain may have been the one everyone waited for
            self._cond.notify_all()

    # -- submission --------------------------------------------------------
    def submit(self, key: Tuple, arrays: Tuple) -> np.ndarray:
        """Evaluate one slot; blocks until its group's dispatch returns.

        ``key`` captures every static of the group's program
        (kind, approx, H, W, per-slot array shapes); ``arrays`` is the
        per-slot tuple in `_EV_FIELDS`/`_ZB_FIELDS` order."""
        e = _Entry(arrays)
        with self._cond:
            self._groups.setdefault(key, []).append(e)
            self._waiting += 1
            try:
                if len(self._groups.get(key, ())) >= self.max_slots:
                    self._flush_locked(key)
                else:
                    deadline = _now() + self.window_s
                    while not e.event.is_set():
                        mine = self._groups.get(key)
                        if mine is None or e not in mine:
                            # another leader took the group: wait for result
                            break
                        if self._waiting >= self._alive:
                            # every live chain is blocked in the batcher: no
                            # further submissions can arrive — flush now
                            self._flush_all_locked()
                            break
                        left = deadline - _now()
                        if left <= 0:
                            self._flush_locked(key)
                            break
                        self._cond.wait(timeout=min(left, 0.005))
            finally:
                self._waiting -= 1
        e.event.wait()
        if e.error is not None:
            raise e.error
        return e.result

    # -- flushing ----------------------------------------------------------
    def _flush_all_locked(self):
        for key in list(self._groups):
            self._flush_locked(key)

    def _flush_locked(self, key: Tuple):
        entries = self._groups.pop(key, None)
        if not entries:
            return
        # Dispatch OUTSIDE the lock so other chains keep submitting while
        # the device runs — but build the arg list under it (cheap).
        self._cond.notify_all()
        self._lock.release()
        try:
            self._dispatch(key, entries)
        finally:
            self._lock.acquire()
            self._cond.notify_all()

    def _dispatch(self, key: Tuple, entries: List[_Entry]):
        kind, approx, H, W = key[0], key[1], key[2], key[3]
        M = len(entries)
        try:
            if self.mesh is not None and "scene" in getattr(
                    self.mesh, "shape", {}):
                # multi-chip: pad the group to the scene-axis extent and
                # shard slots across chips (zero-communication data
                # parallelism over monuments)
                from jax.sharding import NamedSharding, PartitionSpec

                S = int(self.mesh.shape["scene"])
                Mp = -(-M // S) * S
                slots = [e.arrays for e in entries]
                slots += [entries[0].arrays] * (Mp - M)
                spec = NamedSharding(self.mesh, PartitionSpec("scene"))
                stacked = tuple(
                    jax.device_put(
                        jnp.stack([s[j] for s in slots]), spec)
                    for j in range(len(slots[0]))
                )
                out = _grouped_eval_stacked(kind, approx, H, W, *stacked)
                res = np.asarray(out)
                for i, e in enumerate(entries):
                    e.result = res[i]
            elif M == 1:
                # solo slot: reuse the single-monument executables (already
                # compiled/cached for the serial path) instead of minting
                # M=1 variants of the grouped program
                e = entries[0]
                e.result = np.asarray(_solo_eval(kind, approx, H, W, e.arrays))
            else:
                # pad the group to a pow2 slot count (<= max_slots) with
                # copies of slot 0: few executable shapes; padding discarded
                Mp = 1
                while Mp < M:
                    Mp *= 2
                slots = [e.arrays for e in entries]
                slots += [entries[0].arrays] * (Mp - M)
                flat = tuple(a for s in slots for a in s)
                out = _grouped_eval(kind, approx, H, W, Mp, *flat)
                res = np.asarray(out)
                for i, e in enumerate(entries):
                    e.result = res[i]
        except BaseException as err:
            # every waiter re-raises the failure in its own thread; a
            # non-Exception (interrupt, exit) also propagates here
            for e in entries:
                e.error = err
            if not isinstance(err, Exception):
                raise
        finally:
            self.dispatches += 1
            self.slots_total += M
            for e in entries:
                e.event.set()


def _solo_eval(kind: str, approx: bool, H: int, W: int, arrays: Tuple):
    from pbr3d.deform.search import (
        _batch_deform_visible_iou,
        _batch_deform_visible_iou_penalized,
        deformed_zbuffer,
    )

    if kind == "pen":
        return _batch_deform_visible_iou_penalized(
            *arrays, H=H, W=W, approx=approx)
    if kind == "plain":
        return _batch_deform_visible_iou(*arrays, H=H, W=W, approx=approx)
    return deformed_zbuffer(*arrays, H=H, W=W)


def _now() -> float:
    import time

    return time.monotonic()


def eval_candidates_batched(
    batcher: DeformEvalBatcher,
    deforms: np.ndarray,  # (P, 4) f32 host
    chunk_cap: int,
    kind: str,  # "pen" | "plain"
    approx: bool,
    common: Tuple,  # (coords, valid, cam_vec, gt_part, rest_zbuf,
    #                 true_hw, voxel_shape, center) device arrays
    nb: Optional[Tuple],  # (_NB_FIELDS arrays) when kind == "pen"
    Hp: int,
    Wp: int,
) -> np.ndarray:
    """Batcher-routed equivalent of `search._eval_chunked`: identical chunk
    partitioning and padding, each chunk submitted as one slot."""
    from pbr3d.deform.search import IDENTITY_DEFORM, _auto_chunk, _CHUNK_MAX_MULT

    P = deforms.shape[0]
    n = common[0].shape[0]
    cost = n if approx else 7 * n
    if kind == "pen":
        nbq = nb[0]
        cost += (nbq.shape[0] * nbq.shape[1] * nbq.shape[2]) // 4
    cap = _auto_chunk(cost, _CHUNK_MAX_MULT * chunk_cap)
    chunk = max(8, 1 << (P - 1).bit_length())
    chunk = min(chunk, cap)
    pad = (-P) % chunk
    d = (np.concatenate([deforms, np.tile(IDENTITY_DEFORM, (pad, 1))])
         if pad else deforms)
    tail = tuple(nb) if kind == "pen" else ()
    outs = []
    for i in range(0, len(d), chunk):
        key = (kind, bool(approx), Hp, Wp, chunk, n)
        arrays = (jnp.asarray(d[i : i + chunk]),) + tuple(common) + tail
        outs.append(batcher.submit(key, arrays))
    return np.concatenate(outs)[:P]


def zbuffer_batched(
    batcher: DeformEvalBatcher,
    deform,
    coords,
    valid,
    cam_vec,
    true_hw,
    voxel_shape,
    center,
    Hp: int,
    Wp: int,
) -> np.ndarray:
    """Batcher-routed `search.deformed_zbuffer` (the full-set accepts of
    concurrent chains land in one grouped dispatch)."""
    key = ("zb", False, Hp, Wp, int(coords.shape[0]))
    arrays = (jnp.asarray(deform), coords, valid, cam_vec, true_hw,
              voxel_shape, center)
    return batcher.submit(key, arrays)
