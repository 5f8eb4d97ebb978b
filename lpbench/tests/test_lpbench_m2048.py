"""The m = 2048 exact cell (``ineq_m2048.exact``) and its four readers.

On the CPU the cell runs at a small size with the whole-segment boundary
(the calibration table's ``xover_pallas_max_m``) and the router's
alternate-guess retry line moved below it and the whole-segment gate
shut, so its calls take the m = 2048 route: no retry, the uncrossed lanes
straight to the fallback, every segment on kernel 3 (its plain version
here), every factorization on ``torch.linalg``; no device trace is taken.
The readers are also held to hand-made recorders: a program without the
``branch`` count, or without the ``lu_library`` span, reads None.
"""

import time

import pytest

from lpbench import harness
from lpbench.metrics import _program
from lpbench.roofline_stream import launch_bound_s

CELL = "ineq_m2048.exact"
NEW = ("k3_xover_ms", "k3_fallback_ms", "k3_roofline_pct", "lu_library_ms")
SPAN_READERS = ("k3_xover_ms", "k3_fallback_ms", "lu_library_ms")
# 2 batches of 8 lanes at m = n = 32 from the configuration's data seed: at
# a one-pivot crossover budget the first pass leaves lanes uncrossed, and
# the fallback takes them
SMALL = {"config": {"m": 32, "n": 32, "lanes": 8, "pool_batches": 2},
         "traffic": {"sample_lanes_per_call": 4}}


@pytest.fixture
def m2048_route(monkeypatch):
    import linprog_tpu_torch.engine_batched as eb
    import linprog_tpu_torch.router as router
    from linprog_tpu_torch import calibration

    calibration.set_table({"default": {"xover_pallas_max_m": 16}})
    monkeypatch.setattr(router, "_ALT_RETRY_MAX_M", 20)
    monkeypatch.setattr(eb, "_mega_kernel_fits",
                        lambda m, n, with_at, **kw: False)
    real = router.exact_cleanup_config
    monkeypatch.setattr(router, "exact_cleanup_config",
                        lambda m, maxiters=None: real(m, 1))
    yield
    calibration.reset_table()


def _run(trace):
    return harness.run_cell(harness.manifest(), CELL, 4220000001, 0.5,
                            trace, "cpu", time.time(), SMALL)


def test_the_cell_lists_its_four_metrics_and_no_others():
    man = harness.manifest()
    w = harness.workload(man, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "ineq_m2048", "exact", 1)
    e2e, layer = harness.metrics_of(man, CELL)
    assert {m["name"] for m in e2e} == {"lps_per_s", "solve_mem_gib",
                                        "setup_s"}
    assert {m["name"] for m in layer} == set(NEW)
    for m in man["per_layer"]:
        assert (m["name"] in NEW) == (CELL in m["workloads"])
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
            assert m["moves"] == "lps_per_s"


def test_the_configuration_states_its_cut():
    conf = harness._load(harness.HERE, "configs", "ineq_m2048.json")
    assert (conf["m"], conf["n"], conf["lanes"]) == (2048, 2048, 16)
    assert (conf["dtype"], conf["tf32"]) == ("float32", False)
    assert conf["entries"] == {"solve_batch_exact": {}}
    assert conf["pool_batches"] == 4 and conf["assumed"] == ["pool_batches"]
    assert set(conf["cut"]) == {"lanes"}
    (entry,) = [c for c in harness.manifest()["configs"]
                if c["name"] == "ineq_m2048"]
    assert entry["reduced"] == ["data_seed", "lanes"]
    assert entry["file"] == "lpbench/configs/ineq_m2048.json"


def test_the_cell_end_to_end_on_the_m2048_route(m2048_route):
    """``correct`` against the float64 reference; no retry, the fallback
    fired, every segment on kernel 3, and the span readers report (no
    device trace on the CPU, so no roofline share)."""
    r = _run(True)
    assert r["correct"], r["compared"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(SPAN_READERS)
    assert m["k3_xover_ms"] > 0 and m["lu_library_ms"] > 0
    calls = _program.REC.calls()[-r["calls"]["n"]:]
    names = {s.name for call in calls for s in call}
    assert {"fallback", "segment", "lu_library"} <= names
    assert "retry" not in names
    assert {s.counts["kernel"] for call in calls for s in call
            if s.name == "segment"} == {3}
    assert m["k3_fallback_ms"] > 0


def test_an_untraced_run_reports_none_of_them(m2048_route):
    r = _run(False)
    assert r["correct"]
    assert not set(r["metrics"]) & set(NEW)


class _Span:
    def __init__(self, name, counts, ms=1.0, profiled=True, parent=None):
        self.name, self.counts, self._ms = name, counts, ms
        self.profiled, self.parent = profiled, parent

    def ms(self):
        return self._ms


class _Rec:
    def __init__(self, calls):
        self._calls = calls

    def calls(self):
        return self._calls


class _Run:
    def __init__(self, n, profile=None):
        self.calls, self.profile = n, profile


def _segment(kernel, parent, branch="stream", pivots=100,
             shape=(16, 2048, 4096), ms=2.0, profiled=True):
    counts = {"kernel": kernel, "mode": "dual", "running": 16,
              "pivots": pivots, "shape": shape, "held_cols": shape[2],
              "cluster": 2}
    if branch is not None:
        counts["branch"] = branch
    return _Span("segment", counts, ms, profiled, parent)


def _read(name, run):
    return harness.reader(name).read(run)


def _root(lu_library=None, profiled=True):
    counts = {} if lu_library is None else {"lu_launches": 0,
                                            "lu_library": lu_library}
    return _Span("solve_batch_exact", counts, 100.0, profiled)


def test_every_reader_is_none_without_the_count_or_the_span(monkeypatch):
    """A program whose segment spans carry no ``branch`` reads None in the
    kernel-3 readers; one that counts library calls on its root spans but
    records no ``lu_library`` span (the parent of this cell) reads None in
    ``lu_library_ms``, as does one without the root count, or without a
    recorder at all."""
    from lpbench import devtrace

    prof = devtrace.Profile(1.0, 1.0, {"solve_segment_stream_kernel": 0.5},
                            [])
    root = _root(lu_library=3)
    xo = _Span("crossover", {}, 10.0, parent=root)
    old = [[root, xo, _segment(3, xo, branch=None)]]
    monkeypatch.setattr(_program, "REC", _Rec(old))
    for name in ("k3_xover_ms", "k3_fallback_ms", "k3_roofline_pct"):
        assert _read(name, _Run(1, prof)) is None, name
    # the branch noted, the library counted, no lu_library span
    root = _root(lu_library=3)
    xo = _Span("crossover", {}, 10.0, parent=root)
    monkeypatch.setattr(_program, "REC", _Rec([[root, xo, _segment(3, xo)]]))
    assert _read("lu_library_ms", _Run(1)) is None
    assert _read("k3_xover_ms", _Run(1)) == pytest.approx(2.0)
    # no root count of library calls at all
    root = _root()
    monkeypatch.setattr(_program, "REC", _Rec([[root, _segment(3, root)]]))
    assert _read("lu_library_ms", _Run(1)) is None
    monkeypatch.setattr(_program, "REC", None)
    for name in NEW:
        assert _read(name, _Run(1, prof)) is None, name


def test_the_readers_on_a_program_with_the_span(monkeypatch):
    from lpbench import devtrace

    # call a: the crossover's kernel 3, then a fallback with its two-phase
    # and its repair crossover on kernel 3, and library factorizations in
    # both; call b (outside the profiled stretch): the crossover alone
    ra = _root(lu_library=3)
    xo = _Span("crossover", {}, 50.0, parent=ra)
    fb = _Span("fallback", {"lanes": 2, "bucket": 8}, 900.0, parent=ra)
    tp = _Span("solve_batch_two_phase", {}, 600.0, parent=fb)
    rep = _Span("crossover", {}, 200.0, parent=fb)
    call_a = [ra, xo,
              _Span("lu_library", {"op": "inv"}, 4.0, parent=xo),
              _segment(3, xo, ms=30.0),
              fb, tp,
              _segment(3, tp, pivots=400, shape=(8, 2048, 6144), ms=500.0),
              _Span("lu_library", {"op": "solve"}, 6.0, parent=tp),
              rep, _segment(3, rep, pivots=20, ms=40.0)]
    rb = _root(lu_library=1, profiled=False)
    xb = _Span("crossover", {}, 20.0, profiled=False, parent=rb)
    call_b = [rb, xb,
              _Span("lu_library", {"op": "inv"}, 2.0, profiled=False,
                    parent=xb),
              _segment(3, xb, ms=10.0, profiled=False)]
    monkeypatch.setattr(_program, "REC", _Rec([call_a, call_b]))
    run = _Run(2)
    assert _read("k3_xover_ms", run) == pytest.approx((30.0 + 10.0) / 2)
    assert _read("k3_fallback_ms", run) == pytest.approx((500.0 + 40.0) / 2)
    assert _read("lu_library_ms", run) == pytest.approx((4 + 6 + 2) / 2)
    # no trace: no share
    assert _read("k3_roofline_pct", run) is None
    prof = devtrace.Profile(1.0, 1.0, {
        "lps::solve_segment_stream_kernel": 0.25,
        "lpl::solve_segment_large_kernel": 9.0}, [])
    # the profiled call's kernel-3 launches, crossover and fallback alike:
    # 100 pivots at [2048, 4096], 400 at [2048, 6144], 20 at [2048, 4096]
    least = (launch_bound_s(2048, 4096, 100) + launch_bound_s(2048, 6144, 400)
             + launch_bound_s(2048, 4096, 20))
    assert _read("k3_roofline_pct", _Run(2, prof)) == pytest.approx(
        100.0 * least / 0.25)
    # by hand: a pivot at [2048, 4096] moves 4 (2048 x 4096 + 3 x 2048^2)
    # = 83,886,080 bytes, at [2048, 6144] 100,663,296, at 3.35e12 B/s
    by_hand = (120 * 83_886_080 + 400 * 100_663_296) / 3.35e12
    assert least == pytest.approx(by_hand)
    # the symbol absent from the trace: no share
    run = _Run(2, devtrace.Profile(1.0, 1.0, {"other": 1.0}, []))
    assert _read("k3_roofline_pct", run) is None
    # a window without a fallback reads 0 there; one whose calls made no
    # library call (and say so on their roots) reads 0 in lu_library_ms
    monkeypatch.setattr(_program, "REC", _Rec([call_b]))
    assert _read("k3_fallback_ms", _Run(1)) == 0.0
    assert _read("k3_xover_ms", _Run(1)) == pytest.approx(10.0)
    rc = _root(lu_library=0)
    monkeypatch.setattr(_program, "REC", _Rec([[rc, _segment(3, rc)]]))
    assert _read("lu_library_ms", _Run(1)) == 0.0
