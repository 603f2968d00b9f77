"""Process-level runtime settings: the persistent compile cache and device
memory budgets."""

from __future__ import annotations

import os

import jax

from pbr3d import config


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set.  Otherwise the cache lives in
    ``<checkout>/.jax_cache``, a path fixed by the package location so that
    every process of one checkout finds the same entries.  Either way every
    program is cached, however small or quick to compile: the pipeline runs
    many small per-bucket programs (window steps, crops, fences) that JAX's
    default thresholds would leave out, and a cold pass is mostly compile."""
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(config.REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def memory_budget(share: float, cpu_bytes: int, device=None) -> int:
    """``share`` of the device's allocator limit (``memory_stats()
    ["bytes_limit"]``) in bytes.  A backend that reports no limit (the CPU
    backend the tests run on) gets ``cpu_bytes`` instead."""
    device = device or jax.devices()[0]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        return int(cpu_bytes)
    return int(share * limit)
