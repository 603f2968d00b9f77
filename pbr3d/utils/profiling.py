"""Tracing & timing helpers (the reference had only tqdm bars and ad-hoc
time.time deltas; SURVEY §5)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import jax


@jax.jit
def _tick(x):
    return x + 1


def device_sync() -> None:
    """Block until all previously dispatched device work has completed.

    Each device runs its programs in the order they were enqueued (one
    compute stream per device), so a trivial program enqueued on every
    local device and blocked on fences everything enqueued before it
    (chip_smoke.py checks this against blocking on a program's outputs).
    """
    import numpy as np

    jax.block_until_ready(
        [_tick(jax.device_put(np.int32(0), d)) for d in jax.local_devices()])


class StageTimer:
    """Accumulates wall times per named stage, fencing the device at both
    edges of each stage so async dispatch can't leak work across stages."""

    def __init__(self, sync: bool = True):
        self.times: Dict[str, float] = {}
        self._sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync:
            device_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                device_sync()
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k:>12}: {v:8.3f} s" for k, v in self.times.items()]
        lines.append(f"{'total':>12}: {total:8.3f} s")
        return "\n".join(lines)


#: ``PBR3D_PROFILE=1`` turns :func:`prof` regions into stderr timing lines
#: (device-fenced); otherwise they are free no-ops.
PROFILE = os.environ.get("PBR3D_PROFILE", "") not in ("", "0")


@contextlib.contextmanager
def prof(name: str, sync: bool = True):
    """Env-gated phase timer: prints ``[prof] name: T s`` when enabled."""
    if not PROFILE:
        yield
        return
    import sys

    if sync:
        device_sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            device_sync()
        print(f"[prof] {name}: {time.perf_counter() - t0:.2f}s",
              file=sys.stderr, flush=True)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a region (inspect with TensorBoard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
