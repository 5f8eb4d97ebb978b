"""The m = 1024 exact cell (``ineq_m1024.exact``) and its five readers.

On the CPU the cell runs at a small size with the whole-segment boundary
moved below it (the calibration table's ``xover_pallas_max_m``), so its
calls take the past-boundary settings, the retry and the fallback; every
launch is a plain version there (``branch`` ``"plain"``), and no device
trace is taken.  The readers are also held to hand-made recorders: a
program without the ``retry`` span and the ``branch`` count reads None,
and the streaming roofline to hand counts.
"""

import time

import pytest

from lpbench import harness
from lpbench.metrics import _program
from lpbench.roofline import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from lpbench.roofline_stream import launch_bound_s, pivot_bytes, pivot_s

CELL = "ineq_m1024.exact"
NEW = ("retry_ms", "retry_lanes", "k1_stream_ms", "k1_stream_roofline_pct",
       "k3_ms")
SPAN_READERS = ("retry_ms", "retry_lanes", "k1_stream_ms", "k3_ms")
# 2 batches of 16 lanes at m = n = 32 from the configuration's data seed:
# at a one-pivot crossover budget the first pass leaves 5 and 2 lanes
# uncrossed, the retry crosses none, the fallback takes them
SMALL = {"config": {"m": 32, "n": 32, "lanes": 16, "pool_batches": 2},
         "traffic": {"sample_lanes_per_call": 4}}


@pytest.fixture
def past_boundary(monkeypatch):
    import linprog_tpu_torch.router as router
    from linprog_tpu_torch import calibration

    calibration.set_table({"default": {"xover_pallas_max_m": 16}})
    real = router.exact_cleanup_config
    monkeypatch.setattr(router, "exact_cleanup_config",
                        lambda m, maxiters=None: real(m, 1))
    yield
    calibration.reset_table()


def _run(trace):
    return harness.run_cell(harness.manifest(), CELL, 4100000001, 0.5,
                            trace, "cpu", time.time(), SMALL)


def test_the_cell_lists_its_five_metrics_and_no_others():
    man = harness.manifest()
    w = harness.workload(man, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "ineq_m1024", "exact", 1)
    e2e, layer = harness.metrics_of(man, CELL)
    assert {m["name"] for m in e2e} == {"lps_per_s", "solve_mem_gib",
                                        "setup_s"}
    assert {m["name"] for m in layer} == set(NEW)
    for m in man["per_layer"]:
        assert (m["name"] in NEW) == (CELL in m["workloads"])
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]


def test_the_configuration_is_the_leg_uncut():
    conf = harness._load(harness.HERE, "configs", "ineq_m1024.json")
    assert (conf["m"], conf["n"], conf["lanes"]) == (1024, 1024, 32)
    assert (conf["dtype"], conf["tf32"]) == ("float32", False)
    assert conf["entries"] == {"solve_batch_exact": {}}
    assert conf["assumed"] == ["pool_batches"]
    (entry,) = [c for c in harness.manifest()["configs"]
                if c["name"] == "ineq_m1024"]
    assert entry["reduced"] == ["data_seed"]


def test_the_cell_end_to_end_past_the_boundary(past_boundary):
    """``correct`` against the float64 reference; the retry and the
    fallback fired, every segment span carries its branch, and the span
    readers report (the kernels' time 0: plain versions on the CPU)."""
    r = _run(True)
    assert r["correct"], r["compared"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(SPAN_READERS)  # no device trace on the CPU
    assert m["retry_lanes"] > 0 and m["retry_ms"] > 0
    assert m["k1_stream_ms"] == 0 and m["k3_ms"] == 0
    calls = _program.REC.calls()[-r["calls"]["n"]:]
    names = {s.name for call in calls for s in call}
    assert {"retry", "fallback", "segment"} <= names
    for call in calls:
        for s in call:
            if s.name == "segment":
                assert s.counts["branch"] == "plain"
            if s.name == "retry":
                assert s.counts["crossed"] == 0 and s.counts["lanes"] > 0
    lanes = sum(s.counts["lanes"] for call in calls for s in call
                if s.name == "retry")
    assert m["retry_lanes"] == pytest.approx(lanes / len(calls))


def test_an_untraced_run_reports_none_of_them(past_boundary):
    r = _run(False)
    assert r["correct"]
    assert not set(r["metrics"]) & set(NEW)


class _Span:
    def __init__(self, name, counts, ms=1.0, profiled=True):
        self.name, self.counts, self._ms = name, counts, ms
        self.profiled = profiled

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


def _segment(kernel, branch=None, pivots=100, shape=(32, 1024, 2048),
             ms=2.0, profiled=True):
    counts = {"kernel": kernel, "mode": "dual", "running": 32,
              "pivots": pivots, "shape": shape, "held_cols": shape[2],
              "cluster": 2}
    if branch is not None:
        counts["branch"] = branch
    return _Span("segment", counts, ms, profiled)


def _read(name, run):
    return harness.reader(name).read(run)


def test_every_reader_is_none_without_the_branch_count(monkeypatch):
    """A program whose segment spans carry no ``branch`` (and which has no
    ``retry`` span), or no recorder at all: no reading."""
    from lpbench import devtrace

    prof = devtrace.Profile(1.0, 1.0, {"solve_segment_large_kernel": 0.5,
                                       "solve_segment_stream_kernel": 0.5},
                            [])
    old = [[_Span("solve_batch_exact", {}), _segment(1), _segment(3)]]
    monkeypatch.setattr(_program, "REC", _Rec(old))
    for name in NEW:
        assert _read(name, _Run(1, prof)) is None, name
    monkeypatch.setattr(_program, "REC", None)
    for name in NEW:
        assert _read(name, _Run(1, prof)) is None, name


def test_the_readers_on_a_program_that_notes_the_branch(monkeypatch):
    from lpbench import devtrace

    call_a = [_Span("solve_batch_exact", {}),
              _segment(1, "stream", ms=3.0),
              _Span("retry", {"lanes": 3, "bucket": 8, "crossed": 1,
                              "guess": "magnitude"}, ms=40.0),
              _segment(1, "stream", ms=5.0),
              _segment(3, "stream", pivots=50, shape=(8, 1024, 3072),
                       ms=7.0)]
    call_b = [_Span("solve_batch_exact", {}, profiled=False),
              _segment(1, "stream", ms=1.0, profiled=False)]
    monkeypatch.setattr(_program, "REC", _Rec([call_a, call_b]))
    run = _Run(2)
    assert _read("retry_ms", run) == pytest.approx(20.0)
    assert _read("retry_lanes", run) == pytest.approx(1.5)
    assert _read("k1_stream_ms", run) == pytest.approx(4.5)
    assert _read("k3_ms", run) == pytest.approx(3.5)
    # no trace: no share
    assert _read("k1_stream_roofline_pct", run) is None
    prof = devtrace.Profile(1.0, 1.0, {
        "lpl::solve_segment_large_kernel": 0.004,
        "lps::solve_segment_stream_kernel": 0.002,
        "at::native::elementwise_kernel": 9.0}, [])
    run = _Run(2, prof)
    # the profiled call's launches only (call_b ran outside the trace)
    least1 = 2 * launch_bound_s(1024, 2048, 100)
    assert _read("k1_stream_roofline_pct", run) == pytest.approx(
        100.0 * least1 / 0.004)
    # the symbol absent from the trace: no share
    run = _Run(2, devtrace.Profile(1.0, 1.0, {"other": 1.0}, []))
    assert _read("k1_stream_roofline_pct", run) is None
    # a window with no retry and no kernel 3 reads 0 where the count exists
    monkeypatch.setattr(_program, "REC", _Rec([call_b]))
    assert _read("retry_ms", _Run(1)) == 0.0
    assert _read("retry_lanes", _Run(1)) == 0.0
    assert _read("k3_ms", _Run(1)) == 0.0


@pytest.mark.parametrize("m,n,bytes_,seconds", [
    # the crossover's [G | I] at m = 1024: A 2,097,152 entries, the factor
    # 3 x 1,048,576; 20,971,520 bytes at 3.35e12 B/s (operations
    # 2mn + 6m^2 = 10,485,760 at 67e12 take 1.565e-7 s, less)
    (1024, 2048, 20_971_520, 20_971_520 / 3.35e12),
    # the fallback's Phase I [A | I] at m = 1024: A 3,145,728 entries
    (1024, 3072, 25_165_824, 25_165_824 / 3.35e12),
    # a tall tiny lane, where the operations bound it: m = 1, n = 4096,
    # 4 (4096 + 3) = 16,396 bytes (4.9e-9 s) against 2 x 4096 + 6 = 8198
    # operations (1.2e-10 s): still the bytes
    (1, 4096, 16_396, 16_396 / 3.35e12),
])
def test_the_streaming_roofline_counts_by_hand(m, n, bytes_, seconds):
    assert pivot_bytes(m, n) == bytes_
    assert pivot_s(m, n) == pytest.approx(seconds)
    assert launch_bound_s(m, n, 7) == pytest.approx(7 * seconds)
    assert pivot_s(m, n) >= (2 * m * n + 6 * m * m) / F32_FLOPS_PER_S
    assert HBM_BYTES_PER_S == 3.35e12
