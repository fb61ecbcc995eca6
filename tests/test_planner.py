"""Plot-order planner: tour-length metric (BASELINE: tour ≤ reference greedy)
and the optional 2-opt refinement."""

from __future__ import annotations

import pickle
import tarfile
from pathlib import Path

import numpy as np
import pytest

from plotweave.vector.planner import plan_layer_ops, tour_length, two_opt_refine

GOLDEN = Path(__file__).parent / "golden" / "e2e"


def _reference_ops(tmp_path):
    with tarfile.open(GOLDEN / "ref_artifacts.tar.gz") as tf:
        tf.extractall(tmp_path, filter="data")
    out = {}
    for layer in ["layer_dark", "layer_mid", "layer_skin", "layer_light"]:
        out[layer] = pickle.loads((tmp_path / layer / "ops.pkl").read_bytes())
    return out


def test_tour_length_not_worse_than_reference(tmp_path):
    """plotweave's greedy plan is bit-identical to the reference's, so its
    pen-up tour length is exactly the reference tour (BASELINE metric #3)."""
    for layer, ref_ops in _reference_ops(tmp_path).items():
        lines = [o["points"] for o in ref_ops if o["type"] == "line"]
        taps = [(o["x"], o["y"]) for o in ref_ops if o["type"] == "tap"]
        mine = plan_layer_ops(lines, taps, tap_insert_radius=80.0)
        # note: re-planning from the reference's already-ordered ops is not
        # the pipeline path (plans come from lines_cross), so compare metric
        assert tour_length(mine) <= tour_length(ref_ops) + 1e-6, layer


def test_two_opt_never_worse_and_preserves_geometry(tmp_path):
    rng = np.random.default_rng(5)
    lines = [rng.integers(0, 5000, (int(rng.integers(2, 10)), 2)).astype(np.float32) for _ in range(30)]
    taps = [tuple(int(v) for v in rng.integers(0, 5000, 2)) for _ in range(10)]
    ops = plan_layer_ops(list(lines), taps, 80.0)
    before = tour_length(ops)
    refined = two_opt_refine(ops)
    after = tour_length(refined)
    assert after <= before + 1e-6
    # geometry preserved: same multiset of line point-sets (up to reversal), same taps
    def key(o):
        if o["type"] == "tap":
            return ("tap", o["x"], o["y"])
        p = np.asarray(o["points"])
        f = p.tobytes()
        r = p[::-1].copy().tobytes()
        return ("line", min(f, r))

    assert sorted(map(key, ops)) == sorted(map(key, refined))


def test_two_opt_improves_adversarial_order():
    # zig-zag arrangement the greedy seed handles poorly
    lines = [np.array([[i * 100, 0], [i * 100, 10]], np.float32) for i in range(10)]
    lines = [lines[i] for i in [0, 9, 1, 8, 2, 7, 3, 6, 4, 5]]
    ops = [{"type": "line", "points": p} for p in lines]
    refined = two_opt_refine(ops)
    assert tour_length(refined) < tour_length(ops)


def test_or_opt_never_lengthens_and_preserves_geometry():
    import numpy as np

    from plotweave.vector.planner import or_opt_refine, refine_tour, tour_length, two_opt_refine

    rng = np.random.default_rng(5)
    for trial in range(8):
        ops = []
        for _ in range(int(rng.integers(4, 25))):
            if rng.random() < 0.3:
                ops.append({"type": "tap", "x": float(rng.integers(0, 800)), "y": float(rng.integers(0, 800))})
            else:
                pts = rng.integers(0, 800, size=(int(rng.integers(2, 6)), 2)).astype(np.float32)
                ops.append({"type": "line", "points": pts})
        t0 = tour_length(ops)
        t2 = tour_length(two_opt_refine(ops))
        t3 = tour_length(refine_tour(ops))
        assert t2 <= t0 + 1e-6
        assert t3 <= t2 + 1e-6

        def geom_set(o):
            out = []
            for op in o:
                if op["type"] == "tap":
                    out.append(("t", op["x"], op["y"]))
                else:
                    p = op["points"]
                    k = p.tobytes()
                    kr = p[::-1].copy().tobytes()
                    out.append(("l", min(k, kr)))
            return sorted(out, key=repr)

        assert geom_set(refine_tour(ops)) == geom_set(ops)


def test_split_on_jumps_compares_in_float64():
    """A float32 distance that equals float32(max_jump) but exceeds it in
    float64 must split (the reference compares as Python floats)."""
    import numpy as np

    from plotweave.vector.geometry import split_on_jumps

    # distance 10.100000381... (= float32(10.1)) vs max_jump 10.1 (float64)
    d32 = float(np.float32(10.1))
    poly = np.array([[0.0, 0.0], [d32, 0.0], [d32 + 1.0, 0.0]], np.float32).reshape(-1, 1, 2)
    frags = split_on_jumps(poly, 10.1, keep_singleton=True)
    # the first edge is a jump; with a lone pending point it stays joined,
    # exactly like the reference's scalar loop on the same input
    import numpy as _np

    ref_like = []
    p = poly.reshape(-1, 2).astype(_np.float32)
    cur = [tuple(p[0])]
    for i in range(1, len(p)):
        d = float(_np.linalg.norm(p[i] - p[i - 1]))
        jump = d > 10.1
        if jump and len(cur) >= 2:
            ref_like.append(_np.array(cur, _np.int32).reshape(-1, 1, 2))
            cur = [tuple(p[i])]
        else:
            cur.append(tuple(p[i]))
    if len(cur) >= 2:
        ref_like.append(_np.array(cur, _np.int32).reshape(-1, 1, 2))
    assert len(frags) == len(ref_like)
    for a, b in zip(frags, ref_like):
        _np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,closed_aware", [(300, True), (300, False), (1500, True)])
def test_device_planner_matches_host(n, closed_aware):
    """vector/planner_device.py (the stage-07 auto-switch for huge plans):
    device order+flips must equal the host C++ selection loop.  Coordinates
    span the full A4 canvas (squares far past float32's 2²⁴ integer range)
    with exact and near ties: the integer squares keep every backend's
    distances equal to the host's rounding (module note)."""
    import numpy as np

    from plotweave.vector.planner_device import BUCKETS, greedy_order_device
    from plotweave.vector.sort import _greedy_order_native

    import plotweave.vector.planner_device as P

    rng = np.random.default_rng(n + closed_aware)
    starts = rng.integers(0, 11881, (n, 2))
    starts[rng.choice(n, n // 8)] = starts[rng.choice(n, n // 8)]  # exact ties
    starts[rng.choice(n, n // 8)] = starts[rng.choice(n, n // 8)] + 1  # near ties
    starts = starts.astype(np.float32)
    ends = rng.integers(0, 11881, (n, 2)).astype(np.float32)
    closed = rng.random(n) < 0.3
    seed = int(rng.integers(0, n))
    old = P.BUCKETS
    P.BUCKETS = (2048,)  # shrink the bucket table: a tiny program to compile
    try:
        dev = greedy_order_device(starts, ends, closed, closed_aware, seed)
    finally:
        P.BUCKETS = old
    assert dev is not None
    host = _greedy_order_native(starts, ends, closed, closed_aware, seed)
    assert host is not None, "native library must be available"
    assert dev[0] == host[0]
    assert dev[1] == host[1]
    assert BUCKETS[0] >= 4096  # production buckets stay coarse


def test_device_planner_keeps_non_integer_plans_on_host():
    """Fractional or out-of-range endpoints would break the integer-exact
    distance path, so the device planner declines them."""
    import numpy as np

    import plotweave.vector.planner_device as P

    s = np.array([[0.5, 1.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    e = s + 1
    assert P.greedy_order_device(s, e, [False] * 3, True, 0) is None
    far = np.array([[0, 0], [P.COORD_LIMIT, 1], [5, 6]], np.float32)
    assert P.greedy_order_device(far, far, [False] * 3, True, 0) is None


def test_device_planner_via_sort_contours():
    """sort_contours(device_min_n=...) must produce the identical ordered
    contour list through the device path (eligibility is forced here; the
    production gate requires an accelerator backend)."""
    import numpy as np

    import plotweave.vector.planner_device as P
    from plotweave.vector.sort import sort_contours

    rng = np.random.default_rng(4)
    polys = []
    for _ in range(260):
        m = int(rng.integers(2, 8))
        pts = rng.integers(0, 1500, (m, 2)).astype(np.int32)
        if rng.random() < 0.3:
            pts = np.vstack([pts, pts[:1]])  # closed
        polys.append(pts.reshape(-1, 1, 2))

    host = sort_contours(polys)
    old_b, old_e = P.BUCKETS, P.device_planner_eligible
    P.BUCKETS = (512,)
    P.device_planner_eligible = lambda: True  # sort.py imports lazily → shared
    try:
        dev = sort_contours(polys, device_min_n=10)
    finally:
        P.BUCKETS, P.device_planner_eligible = old_b, old_e
    assert len(dev) == len(host)
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a, b)


def _op_key(o):
    if o["type"] == "tap":
        return ("tap", o["x"], o["y"])
    p = o["points"]
    return ("line", min(p.tobytes(), p[::-1].copy().tobytes()))


def test_device_refiner_preserves_geometry_and_improves():
    """vector/refine_device.py (stage 12's refine auto-switch): the result
    must be a permutation of the input ops (lines possibly reversed), never
    longer than the greedy tour, and at least as short as a couple of host
    passes on an adversarial ordering.  No bit-parity contract here — the
    refiner is a plotweave extension gated behind plotopt_two_opt."""
    import numpy as _np

    import plotweave.vector.refine_device as R
    from plotweave.vector.planner import refine_tour

    rng = _np.random.default_rng(9)
    lines = []
    for _ in range(60):
        m = int(rng.integers(2, 6))
        lines.append(rng.integers(0, 900, (m, 2)).astype(_np.int32).reshape(-1, 1, 2))
    taps = [tuple(map(int, rng.integers(0, 900, 2))) for _ in range(15)]
    ops = plan_layer_ops(lines, taps, 30.0)
    L0 = tour_length(ops)

    old = R.BUCKETS
    R.BUCKETS = (128, 256)  # tiny compile on the CPU test backend
    try:
        dev = R.refine_ops_device(ops)
    finally:
        R.BUCKETS = old
    assert dev is not None
    Ld = tour_length(dev)
    assert sorted(map(_op_key, ops)) == sorted(map(_op_key, dev))
    assert Ld <= L0
    host = two_opt_refine(list(ops), max_passes=2)
    assert Ld <= tour_length(host) * 1.02, (Ld, tour_length(host))

    # the refine_tour auto-switch reaches the same path when eligibility is
    # forced (production gate requires an accelerator backend)
    import plotweave.vector.planner_device as P

    R.BUCKETS = (128, 256)
    old_e = P.device_planner_eligible
    P.device_planner_eligible = lambda: True
    try:
        via = refine_tour(list(ops), device_min_n=10)
    finally:
        P.device_planner_eligible = old_e
        R.BUCKETS = old
    assert sorted(map(_op_key, via)) == sorted(map(_op_key, ops))
    assert tour_length(via) <= L0


def test_device_refiner_perm_stays_valid_every_step():
    """Apply the move loop one step at a time: after EVERY prefix of moves
    the permutation must remain a bijection (catches off-by-ones in the
    2-opt reversal / relocation index arithmetic)."""
    import numpy as _np

    import plotweave.vector.refine_device as R

    rng = _np.random.default_rng(1)
    n = 24
    E = rng.uniform(0, 100, (n, 2)).astype(_np.float32)
    X = rng.uniform(0, 100, (n, 2)).astype(_np.float32)
    old = R.BUCKETS
    R.BUCKETS = (32,)
    try:
        for mm in range(1, 60):
            perm, flip, moves = R.refine_order_device(E, X, max_moves=mm)
            assert sorted(perm.tolist()) == list(range(n)), (mm, perm.tolist())
            if moves < mm:
                break
        else:
            raise AssertionError("refiner did not converge within 60 moves")
    finally:
        R.BUCKETS = old


def test_device_planner_has_no_float_multiplies():
    """GPU compilers fuse a float32 multiply feeding an add into one FMA,
    which rounds differently from the host's product-then-add.  The device
    planner squares in int32, so its program must hold no f32 multiply."""
    import re

    import jax.numpy as jnp

    import plotweave.vector.planner_device as P

    s = jnp.zeros((64, 2), jnp.int32)
    hlo = P._jitted().lower(s, s, jnp.zeros(64, bool), jnp.asarray(0), jnp.asarray(64),
                            closed_aware=True).as_text()
    muls = re.findall(r"stablehlo\.multiply.*", hlo)
    assert muls, "expected the integer squares in the program"
    assert not [m for m in muls if "f32" in m], muls
