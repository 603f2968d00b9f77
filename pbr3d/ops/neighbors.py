"""Tiled nearest-neighbor / pairwise-distance kernels.

The reference's point-cloud metrics sit on ``scipy.spatial.cKDTree`` and
``sklearn.NearestNeighbors`` (reference: utils/eval_helpers.py:36-67,114-126,
248-266).  KD-trees are pointer-chasing machines; the device formulation
is a *tiled brute-force* distance matrix built from one matrix product:

    d²(a, b) = |a|² + |b|² − 2·a·bᵀ

computed chunk-by-chunk over A with a ``lax.map``; each chunk is one
(T, M) matmul + row reduction, so device memory never holds the full N×M
matrix.  Exact (up to f32 rounding) and fully differentiable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_TILE = 2048


def _pad_rows(x: jnp.ndarray, mult: int, fill: float) -> jnp.ndarray:
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])


@functools.partial(jax.jit, static_argnames=("tile",))
def _min_dist2_padded(A: jnp.ndarray, B: jnp.ndarray, b_valid: jnp.ndarray, tile: int):
    """Min squared distance from each row of A to valid rows of B."""
    bb = jnp.sum(B * B, axis=1)
    big = jnp.float32(jnp.inf)
    bb_masked = jnp.where(b_valid, bb, 0.0)
    penalty = jnp.where(b_valid, 0.0, big)

    def chunk_min(a_chunk):
        aa = jnp.sum(a_chunk * a_chunk, axis=1, keepdims=True)
        # HIGHEST: a default-precision f32 matmul may run in reduced
        # precision (TF32 on the GPU), which collapses small distances
        ab = jnp.matmul(a_chunk, B.T, precision=jax.lax.Precision.HIGHEST)
        d2 = aa + bb_masked[None, :] - 2.0 * ab + penalty[None, :]
        return jnp.min(d2, axis=1)

    A_t = A.reshape(-1, tile, A.shape[1])
    return jax.lax.map(chunk_min, A_t).reshape(-1)


def min_dist(A: np.ndarray, B: np.ndarray, tile: int = _TILE) -> np.ndarray:
    """Exact nearest-neighbor distance from each point of A to B (float32)."""
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    n = len(A)
    Ap = _pad_rows(jnp.asarray(A), tile, 0.0)
    Bp = _pad_rows(jnp.asarray(B), 8, 0.0)
    bv = jnp.arange(Bp.shape[0]) < len(B)
    d2 = np.asarray(_min_dist2_padded(Ap, Bp, bv, tile))[:n]
    return np.sqrt(np.maximum(d2, 0.0))


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def _knn_padded(A, B, b_valid, k: int, tile: int):
    bb = jnp.sum(B * B, axis=1)
    bb_masked = jnp.where(b_valid, bb, 0.0)
    penalty = jnp.where(b_valid, 0.0, jnp.float32(jnp.inf))

    def chunk(a_chunk):
        aa = jnp.sum(a_chunk * a_chunk, axis=1, keepdims=True)
        ab = jnp.matmul(a_chunk, B.T, precision=jax.lax.Precision.HIGHEST)
        d2 = aa + bb_masked[None, :] - 2.0 * ab + penalty[None, :]
        neg, idx = jax.lax.top_k(-d2, k)
        return -neg, idx

    A_t = A.reshape(-1, tile, A.shape[1])
    d2s, idxs = jax.lax.map(chunk, A_t)
    return d2s.reshape(-1, k), idxs.reshape(-1, k)


def knn(A: np.ndarray, B: np.ndarray, k: int, tile: int = _TILE):
    """k nearest neighbors in B for each point of A.

    Returns (distances (N, k) float32 ascending, indices (N, k) int32).
    """
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    n = len(A)
    Ap = _pad_rows(jnp.asarray(A), tile, 0.0)
    Bp = _pad_rows(jnp.asarray(B), 8, 0.0)
    bv = jnp.arange(Bp.shape[0]) < len(B)
    d2, idx = _knn_padded(Ap, Bp, bv, k, tile)
    d2 = np.asarray(d2)[:n]
    idx = np.asarray(idx)[:n]
    # When k exceeds the valid point count the trailing columns are
    # inf-distance ties pointing at padding rows; redirect their indices to
    # the nearest valid neighbor (distance stays inf so callers can detect).
    invalid = ~np.isfinite(d2)
    if invalid.any():
        idx = np.where(invalid, idx[:, :1], idx)
    return np.sqrt(np.maximum(d2, 0.0)), idx


def self_nn_dist(P: np.ndarray, tile: int = _TILE) -> np.ndarray:
    """Distance of each point to its nearest OTHER point (k=2 self-query)."""
    d, _ = knn(P, P, k=2, tile=tile)
    return d[:, 1]
