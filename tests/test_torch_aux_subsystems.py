"""The port's auxiliary subsystems against the reference's: observability,
checkpoints (the ``.npz`` layout crosses between the packages both ways),
exact resume, profiling traces, the calibration file override, the port's
NumPy oracle against the reference's, and the per-lane engine against the
port's oracle pivot for pivot."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linprog_tpu import bounded as jbounded
from linprog_tpu import checkpoint as jcheckpoint
from linprog_tpu import engine as jengine
from linprog_tpu import observability as jobs
from linprog_tpu import pdhg as jpdhg
from linprog_tpu.oracle import OracleSimplex as JaxOracleSimplex
from linprog_tpu.oracle import oracle_solve as jax_oracle_solve
from linprog_tpu.results import BatchResult as JaxBatchResult

from linprog_tpu_torch import SolverConfig, calibration, checkpoint, engine
from linprog_tpu_torch import observability as obs
from linprog_tpu_torch import status as st
from linprog_tpu_torch.engine_batched import run_batched
from linprog_tpu_torch.generators import (
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu_torch.oracle import OracleSimplex, oracle_solve
from linprog_tpu_torch.pdhg import DEFAULT_PDHG_CONFIG, _pdhg_core
from linprog_tpu_torch.results import BatchResult


def _quality_inputs():
    rng = np.random.default_rng(2)
    c, A, b = to_standard_form_batch(*random_inequality_lps(4, 6, 9, seed=2))
    x = rng.normal(size=(4, 15)).astype(np.float32)
    return c, A, b, x


@pytest.mark.parametrize("key", ("primal_residual", "bound_violation",
                                 "objective"))
def test_solution_quality_matches_reference(key):
    c, A, b, x = _quality_inputs()
    got = obs.solution_quality(*(torch.as_tensor(a) for a in (c, A, b, x)))
    want = jobs.solution_quality(*(jnp.asarray(a) for a in (c, A, b, x)))
    assert got[key].shape == (4,)
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=1e-6, atol=1e-6)


def test_solve_report_matches_reference():
    c, A, b, x = _quality_inputs()
    fields = dict(x=x, basis=np.zeros((4, 6), np.int32),
                  cost=np.einsum("bn,bn->b", c, x),
                  iters=np.array([3, 7, 0, 12], np.int32),
                  status=np.array([st.OPTIMAL, st.OPTIMAL, st.ITER_LIMIT,
                                   st.PRIMAL_INFEASIBLE], np.int32))
    got = obs.solve_report(
        BatchResult(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        *(torch.as_tensor(a) for a in (c, A, b)))
    want = jobs.solve_report(
        JaxBatchResult(**{k: jnp.asarray(v) for k, v in fields.items()}),
        *(jnp.asarray(a) for a in (c, A, b)))
    for key in ("lanes", "status_counts", "iters"):
        assert got[key] == want[key]
    assert got["status_counts"] == {"OPTIMAL": 2, "ITER_LIMIT": 1,
                                    "PRIMAL_INFEASIBLE": 1}
    for key, value in want["quality"].items():
        assert got["quality"][key] == pytest.approx(value, rel=1e-6, abs=1e-6)


def _random_fields(kind):
    """One state of each type as numpy fields, the reference's dtypes."""
    rng = np.random.default_rng(7)
    B, m, n = 3, 4, 9
    f32 = np.float32
    if kind == "SimplexState":
        return {"basis": rng.integers(0, n, (B, m)).astype(np.int32),
                "inv_B": rng.normal(size=(B, m, m)).astype(f32),
                "bfs": rng.random((B, m)).astype(f32),
                "iters": np.arange(B, dtype=np.int32),
                "status": np.array([0, 1, 9], np.int32)}
    if kind == "BoundedState":
        return {"basis": rng.integers(0, n, (B, m)).astype(np.int32),
                "inv_B": rng.normal(size=(B, m, m)).astype(f32),
                "bfs": rng.random((B, m)).astype(f32),
                "var_state": rng.integers(0, 3, (B, n)).astype(np.int8),
                "iters": np.arange(B, dtype=np.int32),
                "status": np.array([0, 1, 2], np.int32)}
    return {"x": rng.random((B, n)).astype(f32),
            "y": rng.normal(size=(B, m)).astype(f32),
            "x_sum": rng.random((B, n)).astype(f32),
            "y_sum": rng.normal(size=(B, m)).astype(f32),
            "inner_count": np.array([1, 5, 9], np.int32),
            "iters": np.array([64, 128, 64], np.int32),
            "status": np.array([0, 1, 0], np.int32),
            "omega": rng.random(B).astype(f32),
            "x_anchor": rng.random((B, n)).astype(f32),
            "y_anchor": rng.normal(size=(B, m)).astype(f32),
            "last_score": rng.random(B).astype(f32),
            "halpern_off": np.array([True, False, True])}


_JAX_TYPES = {"SimplexState": jengine.SimplexState,
              "BoundedState": jbounded.BoundedState,
              "PDHGState": jpdhg.PDHGState}
KINDS = sorted(_JAX_TYPES)


def _hold_fields(state, fields):
    assert list(state._fields) == list(fields)
    for k, want in fields.items():
        got = np.asarray(getattr(state, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_checkpoint_loads_in_the_port(kind, tmp_path):
    fields = _random_fields(kind)
    path = str(tmp_path / "ref_state.npz")
    jcheckpoint.save_state(path, _JAX_TYPES[kind](
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    state = checkpoint.load_state(path, device="cpu")
    assert type(state).__name__ == kind
    assert all(isinstance(t, torch.Tensor) for t in state)
    _hold_fields(state, fields)


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_loads_in_the_reference(kind, tmp_path):
    fields = _random_fields(kind)
    path = str(tmp_path / "port_state")  # load_state adds .npz
    checkpoint.save_state(path, checkpoint._STATE_TYPES[kind](
        **{k: torch.as_tensor(v) for k, v in fields.items()}))
    state = jcheckpoint.load_state(path)
    assert type(state).__name__ == kind
    _hold_fields(state, fields)


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, checkpoint._STATE_TYPES["SimplexState"](
        **{k: torch.as_tensor(v) for k, v in
           _random_fields("SimplexState").items()}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (checkpoint.load_state, checkpoint.load_state_torch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(path)


def _save_load(fmt, state, tmp_path):
    if fmt == "npz":
        checkpoint.save_state(str(tmp_path / "mid.npz"), state)
        return checkpoint.load_state(str(tmp_path / "mid.npz"), device="cpu")
    checkpoint.save_state_torch(str(tmp_path / "mid.pt"), state)
    return checkpoint.load_state_torch(str(tmp_path / "mid.pt"), device="cpu")


def _same_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(
            np.ascontiguousarray(x.numpy()).view(np.uint8),
            np.ascontiguousarray(y.numpy()).view(np.uint8))


FORMATS = ("npz", "torch")


@pytest.mark.parametrize("fmt", FORMATS)
def test_simplex_resume_equals_the_uninterrupted_run(fmt, tmp_path):
    """Segments of 8 pivots: a run cut after the first segment,
    checkpointed, loaded and resumed gives the uninterrupted run's state
    bit for bit."""
    cs, As, bs = (torch.as_tensor(a) for a in to_standard_form_batch(
        *random_inequality_lps(8, 12, 12, seed=3)))
    basis = torch.arange(12, 24, dtype=torch.int32).expand(8, 12)
    allowed = torch.ones(24, dtype=torch.bool)
    cfg = SolverConfig(pricing="dantzig", refactor_every=8)
    full = run_batched(cs, As, bs, engine.make_state(As, bs, basis), allowed,
                       500, cfg)
    mid = run_batched(cs, As, bs, engine.make_state(As, bs, basis), allowed,
                      8, cfg)
    assert (mid.status == st.RUNNING).all() and (mid.iters == 8).all()
    resumed = run_batched(cs, As, bs, _save_load(fmt, mid, tmp_path),
                          allowed, 500, cfg)
    assert (full.status == st.OPTIMAL).all()
    _same_bits(full, resumed)


@pytest.mark.parametrize("fmt", FORMATS)
def test_pdhg_resume_equals_the_uninterrupted_run(fmt, tmp_path):
    """A PDHG run cut at a restart check (128 steps, two chunks of 64),
    checkpointed and resumed, gives the uninterrupted run's state bit for
    bit (the state carries iterates, sums, anchors and the weight)."""
    c, G, h = (torch.as_tensor(a) for a in random_inequality_lps(4, 6, 9,
                                                                 seed=3))
    lb = torch.zeros((4, 9))
    ub = torch.full((4, 9), float("inf"))
    init, run = _pdhg_core(c, G, h, 0, lb, ub, DEFAULT_PDHG_CONFIG)
    full = run(init(), 100_000)
    mid = run(init(), 128)
    assert (mid.status == st.RUNNING).all()
    resumed = run(_save_load(fmt, mid, tmp_path), 100_000)
    assert (full.status == st.OPTIMAL).all() and (full.iters > 128).all()
    _same_bits(full, resumed)


def test_trace_writes_a_chrome_trace_with_its_label(tmp_path):
    with obs.trace(str(tmp_path / "tr"), label="port_solve_region"):
        with obs.annotate("inner_region"):
            torch.ones(64).cumsum(0)
    files = list((tmp_path / "tr").glob("port_solve_region.*.trace.json"))
    assert len(files) == 1
    text = files[0].read_text()
    json.loads(text)
    assert "port_solve_region" in text and "inner_region" in text
    assert obs.trace.last_elapsed_s > 0


def test_trace_without_logdir_times_the_region():
    obs.trace.last_elapsed_s = None
    with obs.trace(label="untraced"):
        torch.ones(8).sum()
    assert obs.trace.last_elapsed_s is not None


def test_calibration_file_override(tmp_path, monkeypatch):
    """``LINPROG_TPU_TORCH_CALIBRATION`` names a file read in place of the
    packaged one; its entries win key by key."""
    p = tmp_path / "override.json"
    p.write_text(json.dumps({"default": {"exact_simplex_max_m": 5},
                             "made-up-card": {"pdhg_min_m": 77}}))
    monkeypatch.setenv("LINPROG_TPU_TORCH_CALIBRATION", str(p))
    calibration.reset_table()
    try:
        t = calibration.get_table("made-up-card")
        assert t["exact_simplex_max_m"] == 5 and t["pdhg_min_m"] == 77
        assert calibration.get_table("default")["pdhg_min_m"] == 4096
    finally:
        monkeypatch.delenv("LINPROG_TPU_TORCH_CALIBRATION")
        calibration.reset_table()
    assert calibration.get_table("default")["exact_simplex_max_m"] != 5


def test_calibration_override_without_default_falls_back_to_packaged(
        tmp_path, monkeypatch):
    """The port's counterpart of ``tests/test_router.py``'s test of the
    reference's ``LINPROG_TPU_CALIBRATION``: an override file without a
    ``"default"`` entry still resolves every key from the packaged
    defaults."""
    from linprog_tpu_torch.config import tuned_config

    p = tmp_path / "override.json"
    p.write_text(json.dumps({"weird-card": {"exact_simplex_max_m": 9}}))
    monkeypatch.setenv("LINPROG_TPU_TORCH_CALIBRATION", str(p))
    calibration.reset_table()
    try:
        t = calibration.get_table("weird-card")
        assert t["exact_simplex_max_m"] == 9
        assert t["pdhg_min_m"] == 4096
        assert calibration.seg_for_m(256, "weird-card") > 0
        assert tuned_config(256).refactor_every > 0
    finally:
        monkeypatch.delenv("LINPROG_TPU_TORCH_CALIBRATION")
        calibration.reset_table()


def _oracle_instance(rng, m, n):
    """Standard-form LP with a feasible slack start (the generator of
    ``tests/test_oracle_fuzz.py``), rows flipped so that b >= 0."""
    for _ in range(50):
        G = rng.normal(size=(m, n - m))
        b = G @ rng.uniform(0.5, 1.5, size=n - m) + rng.uniform(0.5, 1.5, m)
        y0 = rng.uniform(0.0, 1.0, size=m)
        c = np.concatenate([rng.uniform(0.1, 1.0, size=n - m) - G.T @ y0,
                            np.zeros(m)])
        A = np.concatenate([G, np.eye(m)], axis=1)
        neg = b < 0
        A[neg] *= -1
        b[neg] *= -1
        basis = np.arange(n - m, n)
        if (np.linalg.inv(A[:, basis]) @ b >= 0).all():
            return c, A, b, basis
    raise AssertionError("no feasible start found")


def _dual_instance(seed):
    """An LP optimized from its slack basis, then b perturbed: the old
    optimal basis is a dual-feasible start for the dual simplex."""
    rng = np.random.default_rng(100 + seed)
    m, n = 5, 12
    G = rng.normal(size=(m, n - m))
    b = np.abs(G @ rng.uniform(0.5, 1.5, size=n - m)) + rng.uniform(0.5, 1.5,
                                                                     m)
    y0 = rng.uniform(0.0, 1.0, size=m)
    c = np.concatenate([rng.uniform(0.1, 1.0, size=n - m) - G.T @ y0,
                        np.zeros(m)])
    A = np.concatenate([G, np.eye(m)], axis=1)
    base = OracleSimplex(c, A, b, np.arange(n - m, n), pricing="dantzig")
    assert base.solve(500).status == "optimal"
    b_new = b * (1.0 + 0.3 * rng.standard_normal(m))
    return c, A, b_new, base.basis.copy()


def _checked_oracle(c, A, b, basis, pricing, mode, maxiters):
    """The port's oracle solved to its end, after holding it against the
    reference's on the same instance: pivot trace, basis after every pivot,
    status, flipped rows, primal point and cost."""
    got = OracleSimplex(c, A, b, basis, pricing=pricing).solve(maxiters, mode)
    want = JaxOracleSimplex(c, A, b, basis, pricing=pricing).solve(maxiters,
                                                                   mode)
    assert got.status == want.status
    assert got.trace == want.trace
    assert len(got.basis_trace) == len(want.basis_trace)
    for g, w in zip(got.basis_trace, want.basis_trace):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.A, want.A)
    np.testing.assert_array_equal(got.b, want.b)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.cost == want.cost
    return got


@pytest.mark.parametrize("maxiters", [2, 10_000])
@pytest.mark.parametrize("mode", ["primal", "dual"])
@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_oracle_matches_reference_oracle(seed, pricing, mode, maxiters):
    """The port's copy of the oracle gives the reference's pivot path,
    status and cost, to the bit, for both modes and both rules; a cap of
    two pivots also covers ``iter_limit``."""
    if mode == "primal":
        inst = _oracle_instance(np.random.default_rng(seed), 6, 14)
    else:
        inst = _dual_instance(seed)
    _checked_oracle(*inst, pricing, mode, maxiters)


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_solve_matches_reference(seed):
    """``oracle_solve``, including an unbounded LP (a free improving
    column with no positive entry)."""
    c, A, b, basis = _oracle_instance(np.random.default_rng(seed), 4, 9)
    if seed:
        A = A.copy()
        A[:, 0] = -np.abs(A[:, 0])
        c = c.copy()
        c[0] = -1.0
    got = oracle_solve(c, A, b, basis, pricing="dantzig")
    want = jax_oracle_solve(c, A, b, basis, pricing="dantzig")
    assert got.status == want.status == ("unbounded" if seed else "optimal")
    assert got.trace == want.trace
    np.testing.assert_array_equal(got.x, want.x)


def _engine_path(c, A, b, basis, cfg, mode, steps):
    """The per-lane engine's basis after each of ``steps`` single-pivot
    calls of ``engine.run`` (float64, one lane), then its final state."""
    t = [torch.as_tensor(a, dtype=torch.float64)[None] for a in (c, A, b)]
    state = engine.make_state(t[1], t[2], torch.as_tensor(basis)[None])
    allowed = torch.ones(A.shape[1], dtype=torch.bool)
    path = []
    for _ in range(steps):
        state = engine.run(*t, state, allowed, int(state.iters[0]) + 1, cfg,
                           mode)
        path.append(state.basis[0].numpy().copy())
    final = engine.run(*t, state, allowed, 500, cfg, mode)
    return path, final


@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engine_matches_oracle_pivot_path(pricing, seed):
    c, A, b, basis = _oracle_instance(np.random.default_rng(seed), 6, 14)
    oracle = _checked_oracle(c, A, b, basis, pricing, "primal", 200)
    assert oracle.status == "optimal"
    cfg = SolverConfig(pricing=pricing, opt_tol=1e-7, pivot_tol=1e-9,
                       kernels="torch")
    path, final = _engine_path(c, A, b, basis, cfg, "primal",
                               len(oracle.trace))
    for got, want in zip(path, oracle.basis_trace[1:]):
        np.testing.assert_array_equal(got, want)
    assert int(final.status[0]) == st.OPTIMAL
    cost = float(torch.as_tensor(c)[final.basis[0].long()] @ final.bfs[0])
    assert cost == pytest.approx(oracle.cost, abs=1e-6)


@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_engine_matches_oracle_pivot_path(pricing, seed):
    """Optimize, perturb b, re-optimize with the dual engine and the
    oracle from the old optimal basis: the paths coincide."""
    c, A, b_new, start = _dual_instance(seed)
    oracle = _checked_oracle(c, A, b_new, start, pricing, "dual", 500)
    # the engine sees the oracle's rows, flipped so that b >= 0
    cfg = SolverConfig(pricing=pricing, opt_tol=1e-9, feas_tol=1e-9,
                       pivot_tol=1e-12, kernels="torch")
    path, final = _engine_path(c, oracle.A, oracle.b, start, cfg, "dual",
                               len(oracle.trace))
    for got, want in zip(path, oracle.basis_trace[1:]):
        np.testing.assert_array_equal(got, want)
    want_status = {"optimal": st.OPTIMAL,
                   "dual_unbounded": st.DUAL_UNBOUNDED}[oracle.status]
    assert int(final.status[0]) == want_status
    if oracle.status == "optimal":
        cost = float(torch.as_tensor(c)[final.basis[0].long()] @ final.bfs[0])
        assert cost == pytest.approx(oracle.cost, abs=1e-6)
