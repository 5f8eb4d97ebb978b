"""The per-layer metrics read from the program's own span recorder
(``lpbench/metrics/_program.py``): reported in a traced run of each cell,
absent from an untraced one, and counted over the window's calls only."""

import pytest

from lpbench import harness

from ._tiny import CELLS, run

# the readers of lpbench/metrics/_program.py and the cells that list them
PROGRAM = {"newton_steps", "xover_guess_ms", "xover_refactor_ms",
           "xover_verify_ms", "fallback_ms", "segments_per_call",
           "polish_pivots", "host_syncs", "sync_wait_ms"}


def _listed(cell):
    _, layer = harness.metrics_of(harness.manifest(), cell)
    return {m["name"] for m in layer} & PROGRAM


def test_every_reader_is_listed_for_a_cell():
    assert set().union(*(_listed(c) for c in CELLS)) == PROGRAM


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_metrics(cell):
    r = run(cell, trace=True)
    assert r["correct"], r["compared"]
    want = _listed(cell)
    assert want and want <= set(r["metrics"]), (want, r["metrics"])
    for name in want:
        assert r["metrics"][name]["value"] >= 0.0, name
    assert r["metrics"]["segments_per_call"]["value"] > 0
    assert r["metrics"]["host_syncs"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_none_of_them(cell):
    r = run(cell, trace=False)
    assert not set(r["metrics"]) & PROGRAM


def test_newton_steps_count_the_window_calls_only(monkeypatch):
    """One normal factor for the starting point, then one a Newton step:
    counted by a spy while the window runs, the set-up's warm-up call left
    out, they give the reader's steps a call."""
    import linprog_tpu_torch.ipm as tipm

    seen = {"factors": 0, "ipm": 0, "calls": 0}
    real_factor, real_core = tipm._normal_factor, tipm._ipm_core
    in_window = [False]

    def factor(*a, **kw):
        seen["factors"] += in_window[0]
        return real_factor(*a, **kw)

    def core(*a, **kw):
        seen["ipm"] += in_window[0]
        return real_core(*a, **kw)

    real_window = harness.window

    def window(cell, run_, *a, **kw):
        in_window[0] = True
        try:
            return real_window(cell, run_, *a, **kw)
        finally:
            in_window[0] = False
            seen["calls"] = run_.calls

    monkeypatch.setattr(tipm, "_normal_factor", factor)
    monkeypatch.setattr(tipm, "_ipm_core", core)
    monkeypatch.setattr(harness, "window", window)
    r = run("ineq_m256.exact", trace=True)
    assert seen["calls"] > 0 and seen["ipm"] >= seen["calls"]
    want = (seen["factors"] - seen["ipm"]) / seen["calls"]
    assert r["metrics"]["newton_steps"]["value"] == pytest.approx(want)
