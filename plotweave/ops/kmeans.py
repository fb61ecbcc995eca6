"""Deterministic k-means for color-layer extraction (device Lloyd).

Matches the reference's clustering *procedure* (02_color_extract.py:32-56):
seeded uniform subsample (same numpy Generator stream, so the sample set is
identical), k-means++ init, Lloyd iterations with an epsilon stop, several
attempts keeping the best compactness, then an all-pixel nearest-center
assignment.  Center trajectories differ from cv2.kmeans (whose RNG is
opaque), so masks are equivalence-tested by IoU, not bytes.

The hot parts — distance matrices for assignment — are phrased as
``|x|² − 2·x·cᵀ + |c|²`` matmuls and jitted end-to-end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("iters",))
def _lloyd(data: jax.Array, init_centers: jax.Array, iters: int, eps: float = 0.5):
    """Lloyd iterations with per-center movement epsilon stop."""
    n, d = data.shape
    k = init_centers.shape[0]
    sq = jnp.sum(data * data, axis=1, keepdims=True)
    hi = jax.lax.Precision.HIGHEST  # full-f32 dots — TF32/bf16 passes would
    # corrupt the 200k-row center sums and flip near-tie assignments

    def assign(centers):
        d2 = sq - 2.0 * jnp.matmul(data, centers.T, precision=hi) + jnp.sum(centers * centers, axis=1)
        return jnp.argmin(d2, axis=1), d2

    def body(state):
        centers, _, it, _ = state
        labels, d2 = assign(centers)
        one_hot = jax.nn.one_hot(labels, k, dtype=data.dtype)
        counts = one_hot.sum(axis=0)
        sums = jnp.matmul(one_hot.T, data, precision=hi)
        new_centers = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1), centers)
        shift = jnp.max(jnp.sqrt(jnp.sum((new_centers - centers) ** 2, axis=1)))
        return new_centers, shift, it + 1, jnp.min(d2, axis=1).sum()

    def cond(state):
        _, shift, it, _ = state
        return (shift > eps) & (it < iters)

    centers, _, _, _ = jax.lax.while_loop(
        cond, body, (init_centers, jnp.asarray(jnp.inf, data.dtype), jnp.int32(0), jnp.asarray(0.0, data.dtype))
    )
    labels, d2 = assign(centers)
    compactness = jnp.sum(jnp.min(d2, axis=1))
    return centers, compactness


def _kpp_init(data: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding on the host (tiny: k passes over the sample)."""
    n = data.shape[0]
    centers = np.empty((k, data.shape[1]), dtype=data.dtype)
    centers[0] = data[rng.integers(n)]
    d2 = np.sum((data.astype(np.float64) - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0:  # degenerate: all points coincide with chosen centers
            centers[i] = data[rng.integers(n)]
            continue
        probs = d2 / total
        probs /= probs.sum()  # exact renormalization for rng.choice
        centers[i] = data[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((data.astype(np.float64) - centers[i]) ** 2, axis=1))
    return centers


def kmeans(
    data: np.ndarray,
    k: int,
    sample_limit: int = 200_000,
    attempts: int = 3,
    iters: int = 40,
    seed: int = 42,
    assign: bool = True,
):
    """Cluster (N, D) float32 data; returns (centers [k,D], labels [N] or None
    when ``assign=False`` — callers may fuse the all-point assignment into a
    larger device program).

    The subsample index stream replicates the reference's
    ``np.random.default_rng(42).choice`` (02:41) so the fitted sample is
    identical; attempts use derived seeds for the ++ init.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    if n > sample_limit:
        idx = np.random.default_rng(seed).choice(n, size=sample_limit, replace=False)
        sample = data[idx]
    else:
        sample = data

    sample_j = jnp.asarray(sample)
    best = None
    for a in range(attempts):
        rng = np.random.default_rng(seed + 1000 * a)
        init = jnp.asarray(_kpp_init(sample, k, rng))
        centers, compactness = _lloyd(sample_j, init, iters)
        c = float(compactness)
        if best is None or c < best[1]:
            best = (centers, c)

    centers = best[0]
    if not assign:
        return np.asarray(centers), None
    full = jnp.asarray(data)
    d2 = (
        jnp.sum(full * full, axis=1, keepdims=True)
        - 2.0 * jnp.matmul(full, centers.T, precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(centers * centers, axis=1)
    )
    labels = jnp.argmin(d2, axis=1).astype(jnp.int32)
    return np.asarray(centers), np.asarray(labels)


def _kpp_init_device(sample, k: int, key):
    """k-means++ seeding on device (jax PRNG): uniform first center, then
    d²-weighted categorical draws.  Deterministic for a given key; NOT the
    numpy Generator stream (see PipelineConfig.kmeans_init)."""
    n = sample.shape[0]
    key, k0 = jax.random.split(key)
    first = sample[jax.random.randint(k0, (), 0, n)]
    centers0 = jnp.zeros((k, sample.shape[1]), sample.dtype).at[0].set(first)
    d2_0 = jnp.sum((sample - first) ** 2, axis=1)

    def body(i, state):
        centers, d2, key = state
        key, kc = jax.random.split(key)
        # categorical over d2 (∝ squared distance); guard the all-zero case
        logits = jnp.log(jnp.maximum(d2, 1e-12))
        idx = jax.random.categorical(kc, logits)
        c = sample[idx]
        centers = centers.at[i].set(c)
        d2 = jnp.minimum(d2, jnp.sum((sample - c) ** 2, axis=1))
        return centers, d2, key

    centers, _, _ = jax.lax.fori_loop(1, k, body, (centers0, d2_0, key))
    return centers


# a later attempt must beat the best compactness by this relative margin:
# attempts that end in one basin reach optima a few boundary samples apart,
# ~1e-5 relative in compactness, within the float32 sum's noise across
# backends (another reduction order), so a strict compare picks a different
# winner per backend; distinct optima differ by percents
ATTEMPT_TIE_RTOL = 1e-4


def kmeans_fit_device(sample, k: int, attempts: int, iters: int, seed: int):
    """Device-side fit: ++ inits from derived jax PRNG keys, the same
    ``_lloyd`` fixpoint per attempt; a later attempt wins only when its
    compactness is lower by more than ATTEMPT_TIE_RTOL, so near-ties keep
    the earliest attempt on every backend.  Call inside jit; returns the
    winning (k, D) centers."""
    best_centers = jnp.zeros((k, sample.shape[1]), sample.dtype)
    best_comp = jnp.asarray(jnp.inf, sample.dtype)
    for a in range(attempts):
        init = _kpp_init_device(sample, k, jax.random.PRNGKey(seed + 1000 * a))
        centers, comp = _lloyd(sample, init, iters)
        take = comp < best_comp * (1 - ATTEMPT_TIE_RTOL)
        best_centers = jnp.where(take, centers, best_centers)
        best_comp = jnp.where(take, comp, best_comp)
    return best_centers
