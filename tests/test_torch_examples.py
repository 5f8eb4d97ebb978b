"""The port's examples (``examples/torch_*.py``) run end to end on the
host with ``--device cpu``; without it they ask for a card and raise where
there is none."""

import importlib

import numpy as np
import pytest
import torch

from linprog_tpu_torch import status as st

REFERENCE_COST = 12.081337630748749
EXAMPLES = ("torch_diet", "torch_scenario_batch", "torch_warm_start",
            "torch_warm_ipm", "torch_sparse_batch")


def _main(name):
    return importlib.import_module(f"examples.{name}").main


def test_diet_prints_the_reference_optimum(capsys):
    res = _main("torch_diet")(["--device", "cpu"])
    assert res.optimum
    assert abs(res.cost - REFERENCE_COST) / REFERENCE_COST < 1e-6
    printed = capsys.readouterr().out
    cost = float(printed.split("Optimal Diet Cost:")[1].split()[0])
    assert abs(cost - REFERENCE_COST) / REFERENCE_COST < 1e-6
    np.testing.assert_allclose(
        res.x, [0.0, 0.05359876, 0.44949877, 1.86516786, 0.5, 0.0],
        atol=1e-4)


def test_scenario_batch_solves_every_scenario(capsys):
    res = _main("torch_scenario_batch")(["32", "--device", "cpu"])
    assert (res.status == st.OPTIMAL).all() and res.cost.shape == (32,)
    assert "scenarios: 32" in capsys.readouterr().out


def test_warm_start_needs_fewer_pivots_than_the_base_solve(capsys):
    base, warm = _main("torch_warm_start")(["16", "--device", "cpu"])
    assert (base.status == st.OPTIMAL).all()
    assert (warm.status == st.OPTIMAL).all()
    assert int(warm.iters.sum()) < int(base.iters.sum())
    assert "warm re-solve" in capsys.readouterr().out


def test_warm_ipm_runs_its_periods(capsys):
    res = _main("torch_warm_ipm")(["8", "24", "2", "--device", "cpu"])
    assert res.cost.shape == (8,)
    assert int((res.status == st.OPTIMAL).sum()) >= 7
    assert "period 2 (warm)" in capsys.readouterr().out


def test_sparse_batch_matches_highs(capsys):
    states, worst = _main("torch_sparse_batch")(["4", "--device", "cpu"])
    assert (states.status == st.OPTIMAL).all()
    assert worst < 1e-5
    assert "optimal: 4/4" in capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(name)(["2"] if name != "torch_diet" else [])
