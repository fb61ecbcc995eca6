"""kmeans_init="device" attempt selection: a later attempt replaces the best
only when its compactness is lower by more than ATTEMPT_TIE_RTOL, so two
attempts whose optima differ by less than float32 summation noise resolve
to the earlier one on every backend."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import plotweave.ops.kmeans as K


@pytest.mark.parametrize(
    "comps,winner",
    [((100.0, 100.0 * (1 - 1e-6), 101.0), 0),   # near-tie keeps the earlier attempt
     ((100.0, 99.0, 100.0), 1),                  # a real improvement wins
     ((100.0, 100.0 * (1 - 1e-6), 50.0), 2)],
    ids=["near-tie", "better", "later-better"],
)
def test_attempt_selection(monkeypatch, comps, winner):
    monkeypatch.setattr(K, "_kpp_init_device", lambda sample, k, key: jnp.zeros((k, 3)) + key[1])
    calls = iter(range(len(comps)))

    def fake_lloyd(sample, init, iters):
        a = next(calls)
        return jnp.full((2, 3), float(a)), jnp.float32(comps[a])

    monkeypatch.setattr(K, "_lloyd", fake_lloyd)
    centers = K.kmeans_fit_device(jnp.zeros((5, 3), jnp.float32), 2, len(comps), 10, 0)
    assert np.all(np.asarray(centers) == winner)
