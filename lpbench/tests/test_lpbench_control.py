"""The comparison fails what it must: the control (the reference in
TF32 put in the program's place) and the timed path broken underneath
(a step that leaves its state unchanged, half of the batch left out with
the rest's answers copied over it, an answer altered where it is made).
At a tiny size on the CPU; the control once more at the cells' own size
on the card."""

import pytest
import torch

from lpbench.reference import simplex

from ._tiny import CELLS, run

KERNEL = {  # the segment kernel each cell's entry drives
    "ineq_m256.exact": ("linprog_tpu_torch.engine_batched", "solve_segment"),
    "ineq_m256.simplex": ("linprog_tpu_torch.engine_batched",
                          "solve_segment"),
    "bounded_m256.cold": ("linprog_tpu_torch.bounded",
                          "solve_bounded_segment"),
}


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11,
                      -3.0 - 2.0 ** -10])
    got = simplex.tf32_round(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10,
                            -3.0 - 2.0 ** -9]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = run(cell, control=True)
    assert r["correct"], r["compared"]
    assert not r["control_correct"], r["control"]


def _unchanged_kernel(fn):
    """A segment that returns its state unchanged but counts its
    iterations, so that the driver's loop still ends."""
    def kernel(A, *args, **kw):
        state = next(a for a in args if hasattr(a, "iters"))
        maxiters = next(a for a in args if isinstance(a, int))
        run_ = state.status == 0
        state.iters.copy_(torch.where(
            run_, torch.clamp_max(state.iters + kw["seg_len"], maxiters),
            state.iters))
        return state
    return kernel


def _half_left_out(fn):
    """The second half of the batch takes the first half's answers."""
    def entry(*args, **kw):
        B = args[0].shape[0]
        half = B // 2
        idx = torch.arange(B) % half
        args = [a[:half] if torch.is_tensor(a) and a.dim() >= 1
                and a.shape[0] == B else a for a in args]
        out = fn(*args, **kw)
        res, info = out if isinstance(out, tuple) and len(out) == 2 \
            and isinstance(out[1], dict) else (out, None)
        res = type(res)(*(t[idx] if torch.is_tensor(t) else t for t in res))
        return res if info is None else (res, info)
    return entry


def _answer_altered(fn):
    """Every fourth lane's cost and first x entry moved by 1e-2 of their
    scale as the entry returns them."""
    def entry(*args, **kw):
        out = fn(*args, **kw)
        res, info = out if isinstance(out, tuple) and len(out) == 2 \
            and isinstance(out[1], dict) else (out, None)
        lanes = torch.arange(res.cost.shape[0]) % 4 == 1
        bump = 1e-2 * res.cost.abs().clamp_min(1.0)
        x = res.x.clone()
        x[:, 0] += torch.where(lanes, 1e-2 * x.abs().amax(dim=1).clamp_min(
            1.0), 0.0)
        res = res._replace(cost=torch.where(lanes, res.cost + bump,
                                            res.cost), x=x)
        return res if info is None else (res, info)
    return entry


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """The fault goes in as the window opens, after set-up: the timed path
    alone is broken."""
    import importlib

    from lpbench import harness

    real = harness.window

    def broken_window(c, *args, **kw):
        if fault == "unchanged":
            mod, attr = KERNEL[cell]
            mod = importlib.import_module(mod)
            monkeypatch.setattr(mod, attr,
                                _unchanged_kernel(getattr(mod, attr)))
        else:
            wrap = _half_left_out if fault == "half" else _answer_altered
            c.solve = wrap(c.solve)
        return real(c, *args, **kw)

    monkeypatch.setattr(harness, "window", broken_window)
    r = run(cell)
    assert not r["correct"], r["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(cell, card):
    import time

    from lpbench import harness

    for seed in (7001, 7002, 7003):
        r = harness.run_cell(harness.manifest(), cell, seed, 2.0, False,
                             card, time.time(), control=True)
        assert r["correct"], r["compared"]
        assert not r["control_correct"], r["control"]
