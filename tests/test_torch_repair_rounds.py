"""The two-phase's dual repair of OPTIMAL lanes at a primal-infeasible
basis (``batch._repair_infeasible``), round by round, on the CPU.

On the card, past a few hundred rows, the kernel's f32 eta updates can end
the repair's dual phase OPTIMAL at a basis that a float64 solve still
finds infeasible (the m = 2048 exact cell's fallback lane: x_B -4.3e-4
relative after one round).  Such a lane goes round again from its float64
``x_B``.  Here a dual-feasible, primal-infeasible basis is made by moving
``b`` away from an optimal basis's vertex, and a round that ends OPTIMAL
without moving stands in for the kernel's drift.
"""

import pytest
import torch

from linprog_tpu_torch import batch as tbatch
from linprog_tpu_torch import engine
from linprog_tpu_torch import status as st
from linprog_tpu_torch.config import DEFAULT_CONFIG
from linprog_tpu_torch.engine import basis_matrix
from linprog_tpu_torch.generators import (device_standard_form_batch,
                                          random_inequality_lps)

M, LANES = 12, 4


@pytest.fixture(scope="module")
def infeasible_optimal():
    """``(c2, A1, b, states, allowed)`` as the two-phase hands its repair:
    each lane at its optimal basis for ``b0``, labelled OPTIMAL, with
    ``b`` moved so that its first basic value is -0.01."""
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(
        LANES, M, M, seed=7))
    cs, A, b0 = device_standard_form_batch(c, G, h)
    res = tbatch.solve_batch_two_phase(cs, A, b0, 500, 500)
    assert res.status.tolist() == [st.OPTIMAL] * LANES
    n = A.shape[2]
    A1 = torch.cat([A, torch.eye(M).expand(LANES, M, M)], dim=2)
    c2 = torch.cat([cs, torch.zeros((LANES, M))], dim=1)
    Bm = basis_matrix(A1, res.basis)
    xb = torch.linalg.solve(Bm, b0)
    b = b0 - (xb[:, 0] + 0.01)[:, None] * Bm[:, :, 0]
    states = engine.make_state(A1, b, res.basis, status=st.OPTIMAL)
    allowed = torch.arange(n + M) < n
    return c2, A1, b, states, allowed


def _x64_min(A1, b, basis):
    xb = torch.linalg.solve(basis_matrix(A1, basis).double(), b.double())
    return xb.min(dim=1).values


def _stalled_first_round(monkeypatch):
    """The first dual round ends OPTIMAL where it started; later rounds
    run.  Returns the list of dual rounds' lane counts."""
    run = tbatch._run_chunked
    rounds = []

    def drive(c, A, b, states, allowed, maxiters, cfg, mode):
        rounds.append(A.shape[0])
        if len(rounds) == 1:
            return states._replace(status=torch.full_like(
                states.status, st.OPTIMAL))
        return run(c, A, b, states, allowed, maxiters, cfg, mode)
    monkeypatch.setattr(tbatch, "_run_chunked", drive)
    return rounds


def _repair(args):
    c2, A1, b, states, allowed = args
    return tbatch._repair_infeasible(c2, A1, b, states, allowed, 500,
                                     DEFAULT_CONFIG)


def test_one_round_repairs_the_lanes(infeasible_optimal, monkeypatch):
    _, A1, b, states, _ = infeasible_optimal
    assert bool((_x64_min(A1, b, states.basis) < -5e-3).all())
    run = tbatch._run_chunked
    rounds = []
    monkeypatch.setattr(tbatch, "_run_chunked", lambda *a: rounds.append(
        a[1].shape[0]) or run(*a))
    out = _repair(infeasible_optimal)
    assert rounds == [LANES]
    assert bool((_x64_min(A1, b, out.basis) >= -1e-6).all())
    assert out.status.tolist() == [st.OPTIMAL] * LANES
    assert bool((out.iters > states.iters).all())


def test_a_lane_left_infeasible_goes_round_again(infeasible_optimal,
                                                 monkeypatch):
    """After a round that ends OPTIMAL at the same infeasible basis, every
    lane goes round again from its float64 x_B and is repaired there, as
    the unstalled repair repairs it."""
    _, A1, b, states, _ = infeasible_optimal
    direct = _repair(infeasible_optimal)
    rounds = _stalled_first_round(monkeypatch)
    out = _repair(infeasible_optimal)
    assert rounds == [LANES, LANES]
    assert bool((_x64_min(A1, b, out.basis) >= -1e-6).all())
    assert out.status.tolist() == [st.OPTIMAL] * LANES
    assert torch.equal(torch.sort(out.basis, dim=1).values,
                       torch.sort(direct.basis, dim=1).values)


def test_with_one_round_the_lane_is_left_as_it_was(infeasible_optimal,
                                                   monkeypatch):
    _, _, _, states, _ = infeasible_optimal
    monkeypatch.setattr(tbatch, "REPAIR_ROUNDS", 1)
    rounds = _stalled_first_round(monkeypatch)
    out = _repair(infeasible_optimal)
    assert rounds == [LANES]
    for a, b in zip(out, states):
        assert torch.equal(a, b)


def test_a_lane_stalled_in_every_round_is_left_as_it_was(infeasible_optimal,
                                                          monkeypatch):
    """Every one of the ``REPAIR_ROUNDS`` rounds ends OPTIMAL at the same
    infeasible basis: the lanes go round ``REPAIR_ROUNDS`` times, no more,
    and are left as they were."""
    _, _, _, states, _ = infeasible_optimal
    rounds = []

    def drive(c, A, b, sub, allowed, maxiters, cfg, mode):
        rounds.append(A.shape[0])
        return sub._replace(status=torch.full_like(sub.status, st.OPTIMAL))
    monkeypatch.setattr(tbatch, "_run_chunked", drive)
    out = _repair(infeasible_optimal)
    assert rounds == [LANES] * tbatch.REPAIR_ROUNDS
    for a, b in zip(out, states):
        assert torch.equal(a, b)
