"""Every cell end to end at a tiny size on the CPU (the kernels' plain
versions): the driver, the window, the spans, the readers, the reference
and the comparison."""

import pytest

from lpbench import harness

from ._tiny import CELLS, run


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    r = run(cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    e2e, _ = harness.metrics_of(harness.manifest(), cell)
    # no device, so no memory reading: the others are all there
    want = {m["name"] for m in e2e} - {"solve_mem_gib"}
    assert want <= set(r["metrics"])
    assert r["compared"]["status_mismatch"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_every_declared_span_fires(cell, monkeypatch):
    fired = {}
    real = harness.window

    def spy(c, run_, *a, **kw):
        out = real(c, run_, *a, **kw)
        for s in run_.rec.spans:
            fired[s.name] = fired.get(s.name, 0) + 1
        return out

    monkeypatch.setattr(harness, "window", spy)
    r = run(cell, trace=True)
    assert r["correct"]
    _, layer = harness.metrics_of(harness.manifest(), cell)
    declared = set()
    for m in layer:
        declared |= set(getattr(harness.reader(m["name"]), "SPANS", {}))
    assert declared and declared <= set(fired), (declared, fired)
    # span and counter metrics read on the CPU too; device ones do not
    for m in layer:
        if m["source"] != "device_trace":
            assert m["name"] in r["metrics"], m["name"]
        else:
            assert m["name"] not in r["metrics"], m["name"]
