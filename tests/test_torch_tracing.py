"""The span recorder of ``linprog_tpu_torch.observability`` on the three
entry points the benchmark's cells call: off, it records nothing and the
results are those of a run with it on, bit for bit; on, each call gives
its span tree with the counts that the per-layer metrics read; under
``observability.trace`` the spans are nested ranges of the Chrome trace.
"""

import json

import numpy as np
import pytest
import torch

import linprog_tpu_torch.bounded as tbounded
import linprog_tpu_torch.engine_batched as teb
import linprog_tpu_torch.ipm as tipm
import linprog_tpu_torch.refine as trefine
from linprog_tpu_torch import observability as obs
from linprog_tpu_torch.batch import solve_batch_bounded, solve_batch_two_phase
from linprog_tpu_torch.config import SolverConfig
from linprog_tpu_torch.generators import (
    device_bounded_lps,
    device_standard_form_batch,
    random_inequality_lps,
)
from linprog_tpu_torch.router import solve_batch_exact

ENTRIES = ("solve_batch_exact", "solve_batch_two_phase",
           "solve_batch_bounded")


@pytest.fixture(autouse=True)
def _recording_off():
    """Every test starts and ends with recording off."""
    obs.stop()
    yield
    obs.stop()


def _call(entry):
    """One small call of ``entry``: returns ``(result, info)``.  The exact
    call's 1-pivot crossover budget with the magnitude guess leaves a lane
    uncrossed, so the two-phase fallback runs."""
    if entry == "solve_batch_exact":
        c, G, h = (torch.tensor(a) for a in random_inequality_lps(8, 32, 32,
                                                                  seed=8))
        cfg = SolverConfig(pricing="dantzig", refactor_every=128,
                           polish_pivots=4)
        return solve_batch_exact(c, G, h, cfg=cfg, maxiters=1,
                                 guess="magnitude")
    if entry == "solve_batch_two_phase":
        c, G, h = (torch.tensor(a) for a in random_inequality_lps(8, 16, 16,
                                                                  seed=3))
        cfg = SolverConfig(pricing="dantzig", refactor_every=16,
                           polish_pivots=4)
        return solve_batch_two_phase(*device_standard_form_batch(c, G, h),
                                     200, 200, cfg), {}
    gen = torch.Generator().manual_seed(5)
    prob = device_bounded_lps(gen, 8, 12, 12, "cpu")
    basis = torch.arange(12, 24, dtype=torch.int32).expand(8, 12).clone()
    vs = torch.cat([torch.zeros((8, 12), dtype=torch.int8),
                    torch.full((8, 12), 2, dtype=torch.int8)], dim=1)
    cfg = SolverConfig(pricing="dantzig", refactor_every=16, polish_pivots=8)
    return solve_batch_bounded(*prob, basis, vs, 400, cfg), {}


def _same_bits(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _children(call, parent, skip=("host_read", "lu_library")):
    """The layer spans opened directly inside ``parent``: the blocking
    reads and the library factorizations, leaves that any layer opens, are
    left out."""
    return [s for s in call if s.parent is parent and s.name not in skip]


@pytest.mark.parametrize("entry", ENTRIES)
def test_off_records_nothing_and_on_changes_no_bit(entry):
    rec = obs.start()
    obs.stop()
    assert not obs.span("segment") and not obs.current()
    assert obs.span("ipm") is obs.span("polish")  # the shared no-op
    off, off_info = _call(entry)
    assert rec.calls() == []
    obs.start()
    on, on_info = _call(entry)
    assert len(obs.stop().calls()) == 1
    _same_bits(off, on)
    assert off_info == on_info


@pytest.mark.parametrize("entry", ENTRIES)
def test_one_call_gives_its_span_tree_and_counts(entry, monkeypatch):
    """The root, its children in order, every span's parent and root id;
    ``ipm.steps`` is the Newton loop's count (one normal factor a step
    after the starting point's), ``polish.pivots`` what ``polish_batch``
    returned, one ``segment`` span a kernel launch, and
    ``fallback.lanes`` is ``info["fallback"]``."""
    factors, polish_k, launches = [], [], []

    def spy(module, name, log, keep=lambda out: None):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            out = real(*a, **kw)
            log.append(keep(out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    spy(tipm, "_normal_factor", factors)
    spy(trefine, "polish_batch", polish_k, keep=lambda out: out[4])
    spy(teb, "solve_segment", launches)
    spy(tbounded, "solve_bounded_segment", launches)

    rec = obs.start()
    _, info = _call(entry)
    obs.stop()
    (call,) = rec.calls()
    root = call[0]
    assert root.name == entry and root.parent is None
    for i, s in enumerate(call):
        assert s.root == root.root
        if i:
            assert s.parent in call[:i]  # opened inside an open span
        assert s.ms() >= 0.0

    segments = [s for s in call if s.name == "segment"]
    assert len(segments) == len(launches) > 0
    for s in segments:
        counts = s.read_counts()
        assert counts["kernel"] == (4 if entry == "solve_batch_bounded"
                                    else 1)
        assert counts["mode"] in ("primal", "dual")
        assert 0 < counts["running"] <= 8 and counts["pivots"] >= 0
    assert [s.read_counts()["pivots"] for s in call
            if s.name == "polish"] == polish_k
    assert sum(s.name == "host_read" for s in call) > 0
    # a library factorization is a leaf (it opens no span)
    library = [s for s in call if s.name == "lu_library"]
    assert library and not [s for s in call if s.parent in library]

    top = [s.name for s in _children(call, root)]
    if entry == "solve_batch_exact":
        assert top == ["ipm", "crossover", "fallback"]
        (ipm,) = [s for s in call if s.name == "ipm"]
        assert ipm.counts["steps"] == len(factors) - 1 > 0
        xover = [s for s in call if s.name == "crossover"]
        assert len(xover) == 2  # the main pass and the fallback's repair
        for x in xover:
            names = [s.name for s in _children(call, x)]
            assert names[0] == "xover.guess" and names[-1] == "polish"
            assert names.count("xover.refactor") == names.count(
                "xover.verify") == 2
            assert 1 <= x.counts["rounds"] <= 2
        (fb,) = [s for s in call if s.name == "fallback"]
        counts = fb.read_counts()
        assert counts["lanes"] == info["fallback"] > 0
        assert counts["bucket"] == 8 and sum(counts["reason"]) == counts[
            "lanes"]
        assert [s.name for s in _children(call, fb)] == [
            "solve_batch_two_phase", "crossover"]
        assert sum(xover[0].read_counts()["uncrossed"]) == counts["lanes"]
    else:
        assert factors == []
        polish = ("polish" if entry == "solve_batch_two_phase"
                  else "bounded_polish")
        assert top[-1] == polish
        assert set(top[:-1]) == {"segment", "batched_lu"}
        assert top.count("batched_lu") == top.count("segment")
        (p,) = [s for s in call if s.name == polish]
        assert 0 <= p.counts["pivots"] <= 8


def test_spans_are_ranges_nested_in_the_trace(tmp_path):
    obs.start()
    with obs.trace(str(tmp_path / "tr"), label="traced_region"):
        _call("solve_batch_two_phase")
    obs.stop()
    (path,) = (tmp_path / "tr").glob("traced_region.*.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def ranges(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e["name"] == name]

    def inside(inner, outer):
        return all(any(a >= c and b <= d for c, d in outer)
                   for a, b in inner)

    (label,) = ranges("traced_region")
    root = ranges("solve_batch_two_phase")
    assert len(root) == 1 and inside(root, [label])
    for name in ("segment", "batched_lu", "polish", "host_read"):
        assert ranges(name) and inside(ranges(name), root), name
    assert inside(ranges("batched_lu"), root)
    # the reads inside the refactorization nest in it
    lu = ranges("batched_lu")
    assert np.sum([inside([r], lu) for r in ranges("host_read")]) >= len(lu)


@pytest.mark.parametrize("entry", ENTRIES)
def test_segment_spans_count_the_held_columns_and_the_cluster(entry,
                                                             monkeypatch):
    """Each ``segment`` span counts the columns of A the launch held in
    shared memory and its CTAs a lane: on the CPU the plain version holds
    nothing back and launches no cluster (``held_cols`` n, ``cluster`` 0),
    and no map of A's unit columns is made.  Where the unit layout pays (a
    card, made to hold here), the segment loop hands kernel 1 the map of
    A's trailing unit columns (the slack and artificial columns of the
    two-phase and crossover matrices), whose count rides on the loop's
    first read: the same blocking reads and the same bits as without."""
    maps = []
    real = teb.solve_segment

    def spy(A, *args, **kw):
        maps.append((A, kw.get("unit")))
        return real(A, *args, **kw)
    monkeypatch.setattr(teb, "solve_segment", spy)

    def run():
        maps.clear()
        rec = obs.start()
        out = _call(entry)
        obs.stop()
        (call,) = rec.calls()
        return out, call

    (res0, _), call0 = run()
    plain = list(maps)
    segments = [s.read_counts() for s in call0 if s.name == "segment"]
    assert segments and len([s for s in segments if s["kernel"] == 1]) == len(
        plain)
    kernel1 = iter(plain)
    for counts in segments:
        assert counts["cluster"] == 0
        if counts["kernel"] == 1:
            A, unit = next(kernel1)
            assert counts["held_cols"] == A.shape[2] and unit is None

    monkeypatch.setattr(teb, "unit_pays", lambda *args: True)
    (res1, _), call1 = run()
    assert len(maps) == len(plain)
    for A, unit in maps:
        n_u = 0
        while bool(((A[:, :, -1 - n_u] != 0).sum(dim=1) == 1).all()):
            n_u += 1
        assert unit.n_d == -(-(A.shape[2] - n_u) // 4) * 4 < A.shape[2]
        assert bool((torch.gather(A[:, :, unit.n_d:], 1,
                                  unit.rows.long()[:, None])[:, 0]
                     == unit.vals).all())
    reads = lambda call: sum(s.name == "host_read" for s in call)  # noqa: E731
    assert reads(call1) == reads(call0)
    _same_bits(res1, res0)
    if entry == "solve_batch_bounded":
        assert maps == []
