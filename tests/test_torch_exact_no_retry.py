"""The exact router on its m = 2048 route, on the CPU.

At 1536 <= m < 3072 (``router._ALT_RETRY_MAX_M`` to ``router._LARGE_M``)
the card's route differs from m = 1024's: no alternate-guess retry, the
uncrossed lanes go straight to the two-phase fallback, every simplex
segment runs on kernel 3 (the whole-segment gate is shut there), and every
factorization goes to ``torch.linalg`` (past the batched LU kernel's m =
256).  Here the whole-segment boundary (the calibration table) and the
retry line are moved below m and the whole-segment gate is shut, so seeded
batches at m = 24-32 take that route on kernel 3's plain version; a
one-pivot crossover budget leaves lanes uncrossed.  Every lane is held to
the benchmark's float64 reference (``lpbench/reference/simplex.py``), and
the ``lu_library`` spans to the helpers' ``torch.linalg`` calls.
"""

import inspect

import pytest
import torch

from linprog_tpu_torch import calibration
from linprog_tpu_torch import engine_batched as teb
from linprog_tpu_torch import observability as obs
from linprog_tpu_torch import router
from linprog_tpu_torch import status as st
from linprog_tpu_torch.generators import random_inequality_lps
from lpbench.drivers._common import inequality_problem
from lpbench.reference import compare, simplex

BOUNDARY = 16  # the whole-segment boundary, moved below m
RETRY_LINE = 20  # the alternate-guess retry's upper line, moved below m
LANES = 8
# (seed, m): two lanes fall back; one does; one does at m = 32; two at
# m = 32; every lane crosses in the first pass (no fallback)
CASES = [(1, 24), (5, 24), (2, 32), (1, 32), (3, 32)]

# Tolerances, as ``test_torch_exact_past_boundary.py`` sets them: the
# program's f32 vertex, its basic values dd-refined, lies a few eps from
# the float64 optimum at m <= 32; a neighbouring vertex moves the cost by
# ~1e-2.
COST_TOL = 1e-5  # |cost - cost_ref| / max(1, |cost_ref|)
X_TOL = 1e-5  # max |x - x_ref| / max(1, max |x_ref|): a unique optimum
INFEAS_TOL = 1e-6  # Gx <= h, x >= 0 in float64, over the data's scale
VERTEX_TOL = 5e-6  # x against its own basis's vertex, over max(1, |x|)


@pytest.fixture(autouse=True)
def _m2048_route(monkeypatch):
    """The boundary and the retry line moved below m, every segment on
    kernel 3; recording off, and the recorder that was on put back after."""
    monkeypatch.setattr(obs, "_recorder", None)
    calibration.set_table({"default": {"xover_pallas_max_m": BOUNDARY}})
    monkeypatch.setattr(router, "_ALT_RETRY_MAX_M", RETRY_LINE)
    monkeypatch.setattr(teb, "_mega_kernel_fits",
                        lambda m, n, with_at, **kw: False)
    yield
    calibration.reset_table()


def _batch(seed, m):
    return tuple(torch.tensor(a) for a in random_inequality_lps(
        LANES, m, m, seed=seed))


def _solve(seed, m, recording=False):
    """One call at a one-pivot crossover budget; with ``recording`` also
    the call's spans."""
    c, G, h = _batch(seed, m)
    rec = obs.start() if recording else None
    try:
        res, info = router.solve_batch_exact(c, G, h, maxiters=1)
    finally:
        obs.stop()
    call = rec.calls()[-1] if recording else None
    return (c, G, h), res, info, call


def _under(span, name):
    p = span.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def test_m2048_lies_on_this_route_at_the_packaged_settings(monkeypatch):
    """At the packaged settings m = 2048 lies past the whole-segment
    boundary and between the retry line and ``_LARGE_M``, and its
    crossover and fallback shapes are past the whole-segment gate (the
    crossover's on the reference's ``"stream"`` variant)."""
    monkeypatch.undo()
    calibration.reset_table()
    assert router._ALT_RETRY_MAX_M == 1536 and router._LARGE_M == 3072
    assert router._xover_max_m() < router._ALT_RETRY_MAX_M <= 2048
    assert 2048 < router._LARGE_M
    cfg, budget = router.exact_cleanup_config(2048)
    assert (cfg.refactor_every, budget) == (128, 2048)
    for n in (4096, 6144):
        assert not teb._mega_kernel_fits(2048, n, with_at=False)
    assert teb._stream_variant(2048, 4096) == ("stream", 512)


@pytest.mark.parametrize("seed,m", CASES)
def test_no_retry_and_the_uncrossed_lanes_reach_the_fallback(seed, m):
    _, _, info, call = _solve(seed, m, recording=True)
    root = call[0]
    assert not [s for s in call if s.name == "retry"]
    assert info["retry_crossed"] == 0
    assert info["crossed"] + info["fallback"] == LANES
    top = [s.name for s in call if s.parent is root
           and s.name not in ("host_read", "lu_library")]
    fallbacks = [s for s in call if s.name == "fallback"]
    if (seed, m) == (3, 32):
        assert info["fallback"] == 0 and not fallbacks
        assert top == ["ipm", "crossover"]
    else:
        assert info["fallback"] > 0
        (fb,) = fallbacks
        assert fb.read_counts()["lanes"] == info["fallback"]
        assert top == ["ipm", "crossover", "fallback"]
    # every segment on kernel 3's plain version, in the crossover and, where
    # a lane fell back, in the fallback
    segments = [s for s in call if s.name == "segment"]
    assert segments
    assert {s.counts["kernel"] for s in segments} == {3}
    assert {s.counts["branch"] for s in segments} == {"plain"}
    assert {_under(s, "fallback") for s in segments} == (
        {False, True} if fallbacks else {False})


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
def test_the_lu_library_spans_are_the_helpers_library_calls(seed, m,
                                                            monkeypatch):
    """One ``lu_library`` span for each ``torch.linalg`` call that
    ``engine.inv_or_nan`` / ``solve_or_nan`` made, in order, its ``op``,
    ``shape``, ``dtype`` and ``device`` those of the matrices factored;
    each a leaf inside the call."""
    made = []
    for op, name in (("inv", "inv_ex"), ("solve", "solve_ex")):
        real = getattr(torch.linalg, name)

        def spy(W, *a, _real=real, _op=op, **kw):
            caller = inspect.stack()[1]
            if caller.function in ("inv_or_nan", "solve_or_nan") and \
                    caller.filename.endswith("engine.py"):
                made.append((_op, tuple(W.shape), str(W.dtype)[6:],
                             W.device.type))
            return _real(W, *a, **kw)
        monkeypatch.setattr(torch.linalg, name, spy)
    _, _, _, call = _solve(seed, m, recording=True)
    spans = [s for s in call if s.name == "lu_library"]
    got = [(s.counts["op"], s.counts["shape"], s.counts["dtype"],
            s.counts["device"]) for s in spans]
    assert got == made and len(made) > 0
    for op, shape, dtype, device in got:
        assert dtype == "float32" and device == "cpu"
        B, rows, cols = shape
        assert rows == cols == m and 1 <= B <= LANES
    assert "inv" in {g[0] for g in got} <= {"inv", "solve"}
    assert not [s for s in call if s.parent in spans]
    assert all(s.parent is not None for s in spans)


@pytest.mark.parametrize("seed,m", CASES)
def test_recording_changes_no_bit(seed, m):
    _, off, off_info, _ = _solve(seed, m)
    _, on, on_info, call = _solve(seed, m, recording=True)
    assert [s for s in call if s.name == "lu_library"]
    assert off_info == on_info
    for a, b in zip(off, on):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
