"""The exact router past the whole-segment kernel's boundary, on the CPU.

The card takes these settings at m > ``xover_pallas_max_m`` (512): a
128-pivot refactorization cadence, a 2048-pivot budget, a retry of the
uncrossed lanes from the other basis guess before the two-phase fallback,
and one round of dd refinement in the crossover's verification.  Here the
boundary is moved down to m = 16 through the calibration table (which
moves the router's settings and the verification's dd rounds alike), so
seeded batches at m = 24-32 run that path in plain PyTorch; a one-pivot
crossover budget leaves lanes uncrossed, so the retry and the fallback
fire.  Every lane is held to the benchmark's float64 reference
(``lpbench/reference/simplex.py``), and the ``retry`` span and the
``segment`` spans' ``branch`` to what the call did.
"""

import pytest
import torch

from linprog_tpu_torch import calibration
from linprog_tpu_torch import observability as obs
from linprog_tpu_torch import status as st
from linprog_tpu_torch.generators import random_inequality_lps
from linprog_tpu_torch.refine import dd_steps
from linprog_tpu_torch.router import exact_cleanup_config, solve_batch_exact
from lpbench.drivers._common import inequality_problem
from lpbench.reference import compare, simplex

BOUNDARY = 16
# (seed, m): the retry crosses a lane and the fallback takes one; the
# retry crosses none and the fallback takes one; two lanes fall back; every
# lane crosses in the first pass (no retry)
CASES = [(1, 24), (5, 24), (1, 32), (3, 32)]
LANES = 8

# Tolerances.  The program solves in f32 (eps 1.2e-7) and returns a
# vertex whose basic values the crossover's verification refines in dd
# arithmetic: its value, its point and its basis's vertex sit a few eps
# from the float64 optimum at m <= 32 (readings 1.0e-7 to 7.1e-7 in cost,
# under 6e-8 in x, under 3e-7 from the vertex).  Each limit leaves room of
# ten or more above those readings, and stays far below what a wrong
# vertex gives (a neighbouring vertex moves the cost by ~1e-2).
COST_TOL = 1e-5  # |cost - cost_ref| / max(1, |cost_ref|)
X_TOL = 1e-5  # max |x - x_ref| / max(1, max |x_ref|): a unique optimum
INFEAS_TOL = 1e-6  # Gx <= h, x >= 0 in float64, over the data's scale
VERTEX_TOL = 5e-6  # x against its own basis's vertex, over max(1, |x|)


@pytest.fixture(autouse=True)
def _past_boundary():
    """The boundary moved down; recording off before and after."""
    obs.stop()
    calibration.set_table({"default": {"xover_pallas_max_m": BOUNDARY}})
    yield
    calibration.reset_table()
    obs.stop()


def _batch(seed, m):
    return tuple(torch.tensor(a) for a in random_inequality_lps(
        LANES, m, m, seed=seed))


def _solve(seed, m, recording=False):
    """One call at a one-pivot crossover budget; with ``recording`` also
    the call's spans."""
    c, G, h = _batch(seed, m)
    rec = obs.start() if recording else None
    try:
        res, info = solve_batch_exact(c, G, h, maxiters=1)
    finally:
        obs.stop()
    call = rec.calls()[-1] if recording else None
    return (c, G, h), res, info, call


def test_the_past_boundary_settings_are_taken():
    cfg, budget = exact_cleanup_config(24)
    assert (cfg.refactor_every, budget) == (128, 2048)
    assert dd_steps(24) == 1 and dd_steps(BOUNDARY) == 0
    calibration.reset_table()
    cfg, budget = exact_cleanup_config(24)
    assert budget == 512 and cfg.refactor_every != 128
    assert dd_steps(24) == 0


@pytest.mark.parametrize("seed,m", CASES)
def test_every_lane_is_the_reference_optimum(seed, m):
    (c, G, h), res, info, _ = _solve(seed, m)
    prob = inequality_problem(c, G, h, m)
    ref = simplex.solve(prob.c, prob.A, prob.b, prob.lb, prob.ub,
                        slack_start=m, maxiters=40 * m)
    assert ref.outcome == [simplex.OPTIMAL] * LANES
    assert res.status.tolist() == [st.OPTIMAL] * LANES, info
    cost_gap = ((res.cost.double() - ref.cost).abs()
                / ref.cost.abs().clamp_min(1.0))
    assert float(cost_gap.max()) <= COST_TOL
    x_ref = ref.x[:, :m]  # the structural columns
    x_gap = ((res.x.double() - x_ref).abs().amax(dim=1)
             / x_ref.abs().amax(dim=1).clamp_min(1.0))
    assert float(x_gap.max()) <= X_TOL
    infeas, off = compare.point_checks(
        prob, res.x.double(), torch.sort(res.basis.long(), dim=1).values)
    assert float(infeas.max()) <= INFEAS_TOL
    assert float(off.max()) <= VERTEX_TOL


@pytest.mark.parametrize("seed,m", CASES)
def test_retry_and_fallback_fire_as_the_case_says(seed, m):
    _, _, info, _ = _solve(seed, m)
    assert info["crossed"] + info["fallback"] == LANES
    if (seed, m) == (1, 24):
        assert info["retry_crossed"] == 1 and info["fallback"] == 1
    elif (seed, m) == (3, 32):
        assert info["crossed"] == LANES and info["retry_crossed"] == 0
    else:
        assert info["retry_crossed"] == 0 and info["fallback"] >= 1


@pytest.mark.parametrize("seed,m", CASES)
def test_the_retry_span_counts_what_info_says(seed, m):
    """``retry``: the uncrossed lanes before it, the bucket, the lanes it
    crossed (``info["retry_crossed"]``) and the guess, with the retry's
    own ``ipm`` and ``crossover`` spans as its children; none where every
    lane crossed in the first pass."""
    _, _, info, call = _solve(seed, m, recording=True)
    root = call[0]
    top = [s.name for s in call if s.parent is root
           and s.name != "host_read"]
    retries = [s for s in call if s.name == "retry"]
    first_uncrossed = LANES - (info["crossed"] - info["retry_crossed"])
    if first_uncrossed == 0:
        assert retries == [] and top == ["ipm", "crossover"]
        return
    (r,) = retries
    counts = r.read_counts()
    assert counts == {"lanes": first_uncrossed, "bucket": LANES,
                      "crossed": info["retry_crossed"],
                      "guess": "magnitude"}
    assert r.parent is root
    kids = [s.name for s in call if s.parent is r and s.name != "host_read"]
    assert kids == ["ipm", "crossover"]
    want = ["ipm", "crossover", "retry"]
    assert top == (want + ["fallback"] if info["fallback"] else want)
    # the retry's spans nest in it: none of its ipm or crossover spans is
    # the first pass's
    assert [s.parent for s in call if s.name == "ipm"] == [root, r]


@pytest.mark.parametrize("seed,m", CASES)
def test_every_segment_span_carries_its_branch(seed, m):
    """On the CPU every launch is a plain version: ``branch`` ``"plain"``,
    ``cluster`` 0, and ``shape`` A's."""
    _, _, _, call = _solve(seed, m, recording=True)
    segments = [s.read_counts() for s in call if s.name == "segment"]
    assert segments
    for counts in segments:
        assert counts["branch"] == "plain" and counts["cluster"] == 0
        B, rows, cols = counts["shape"]
        assert rows == m and B >= 1 and cols == counts["held_cols"]


@pytest.mark.parametrize("seed,m", CASES)
def test_recording_changes_no_bit(seed, m):
    _, off, off_info, _ = _solve(seed, m)
    _, on, on_info, call = _solve(seed, m, recording=True)
    assert call is not None and off_info == on_info
    for a, b in zip(off, on):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_retry_below_the_boundary():
    """At the packaged boundary m = 24 lies below it: the uncrossed lanes
    go straight to the fallback, with no ``retry`` span."""
    calibration.reset_table()
    _, _, info, call = _solve(1, 24, recording=True)
    assert info["fallback"] > 0 and info["retry_crossed"] == 0
    assert not [s for s in call if s.name == "retry"]
