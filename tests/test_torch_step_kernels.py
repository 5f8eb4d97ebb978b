"""linprog_tpu_torch's per-step kernels (plain PyTorch versions), the
batched primal step and the per-step loop against the reference package:
the Pallas kernels ``price_entering`` and ``ratio_eta_pivot`` in interpret
mode, ``batched_primal_step`` with ``kernels="pallas"`` and ``"xla"``, and
``run_batched(kernels="xla")``.

Integers (entering column, leaving row, flags, basis, status, iteration
count) must be equal; floats agree to 1e-5 of scale (f32 sums in two
orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's caches around a module that compiles many interpret-mode
    Pallas programs (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.engine_batched import (  # noqa: E402
    batched_primal_step as jax_batched_primal_step,
    run_batched as jax_run_batched,
)
from linprog_tpu.ops.pallas_kernels import (  # noqa: E402
    price_entering as jax_price_entering,
    ratio_eta_pivot as jax_ratio_eta_pivot,
)

from linprog_tpu_torch import engine, status as st  # noqa: E402
from linprog_tpu_torch.config import SolverConfig  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    config_from_reference,
    simplex_state_from_numpy,
    simplex_state_to_numpy,
)
from linprog_tpu_torch.engine_batched import (  # noqa: E402
    batched_primal_step,
    batched_refactorize,
    run_batched,
    run_batched_steps,
)
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402
from linprog_tpu_torch.ops import step_kernels  # noqa: E402
from linprog_tpu_torch.ops.step_kernels import (  # noqa: E402
    price_entering,
    ratio_eta_pivot,
)

F32 = np.float32
OPT_TOL, PIVOT_TOL = 1e-6, 1e-7


def close(got, want, what=""):
    """Floats within 1e-5 of the lane's scale."""
    B = want.shape[0]
    scale = np.maximum(np.abs(want).reshape(B, -1).max(axis=1), 1.0)
    err = np.abs(got - want).reshape(B, -1).max(axis=1)
    assert (err <= 1e-5 * scale).all(), (what, err / scale)


def step_inputs(B, m, n, seed):
    """A mid-solve pricing state: a random well-conditioned ``invB``, costs,
    and a penalty that masks a few columns."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)).astype(F32)
    invB = (np.eye(m, dtype=F32)
            + 0.2 * rng.standard_normal((B, m, m)).astype(F32))
    cB = rng.standard_normal((B, m)).astype(F32)
    c = rng.standard_normal((B, n)).astype(F32)
    pen = np.zeros((B, n), F32)
    pen[:, ::5] = np.inf
    bfs = rng.random((B, m)).astype(F32)
    return A, invB, cB, c, pen, bfs


@pytest.mark.parametrize("B", [8, 3], ids=["B8", "B3"])
@pytest.mark.parametrize("dantzig", [True, False], ids=["dantzig", "bland"])
def test_price_entering_matches_pallas_kernel(B, dantzig):
    """B = 8 and B = 3 take both lane groupings of the reference.  Lane 1
    has no eligible column (costs far above what the duals buy back);
    lane 2 has an exact tie for the most negative reduced cost."""
    A, invB, cB, c, pen, _ = step_inputs(B, 6, 11, seed=B)
    c[1] = 100.0
    cB[2] = 0.0
    c[2] = 1.0
    c[2, [3, 7]] = -2.0  # a tie: the first index wins
    ref = jax_price_entering(jnp.asarray(cB), jnp.asarray(invB),
                             jnp.asarray(A), jnp.asarray(c), jnp.asarray(pen),
                             dantzig=dantzig, opt_tol=OPT_TOL)
    out = price_entering(*(torch.tensor(a) for a in (cB, invB, A, c, pen)),
                         dantzig=dantzig, opt_tol=OPT_TOL)
    enter, elig = (o.numpy() for o in out)
    np.testing.assert_array_equal(enter, np.asarray(ref[0]))
    np.testing.assert_array_equal(elig, np.asarray(ref[1]))
    assert enter.dtype == elig.dtype == np.int32
    assert elig[1] == 0 and elig[0] == 1
    assert enter[2] == 3
    if not dantzig:
        assert enter[1] == 0  # bland zeroes an ineligible lane's column


@pytest.mark.parametrize("B", [8, 3], ids=["B8", "B3"])
def test_ratio_eta_pivot_matches_pallas_kernel(B):
    """Lane 0 has no positive direction entry (unbounded when asked to
    go); lane 1 is told not to go; lane 2 has a tie in the ratio test (the
    first row wins)."""
    A, invB, _, _, _, bfs = step_inputs(B, 6, 11, seed=10 + B)
    acol = A[:, :, 4].copy()
    invB[0] = -np.eye(6, dtype=F32)
    acol[0] = np.abs(acol[0]) + 0.1  # d = -acol < 0 everywhere
    invB[2] = np.eye(6, dtype=F32)
    acol[2] = [1.0, -1.0, 2.0, 0.5, 1.0, 3.0]
    bfs[2] = [2.0, 1.0, 4.0, 1.0, 5.0, 7.0]  # ratios 2, -, 2, 2, 5, 7/3
    go = np.ones((B, 1), np.int32)
    go[1] = 0
    before = invB.copy(), bfs.copy()
    ref = jax_ratio_eta_pivot(jnp.asarray(invB), jnp.asarray(bfs),
                              jnp.asarray(acol), jnp.asarray(go),
                              pivot_tol=PIVOT_TOL)
    t_inv, t_bfs = torch.tensor(invB), torch.tensor(bfs)
    out = ratio_eta_pivot(t_inv, t_bfs, torch.tensor(acol), torch.tensor(go),
                          pivot_tol=PIVOT_TOL)
    assert out[0] is t_inv and out[1] is t_bfs  # in place
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    close(t_inv.numpy(), np.asarray(ref[0]), "invB")
    close(t_bfs.numpy(), np.asarray(ref[1]), "bfs")
    leave, unb = out[2].numpy(), out[3].numpy()
    assert leave[0] == 0 and unb[0] == 1 and unb[1] == 0 and leave[2] == 0
    for lane in (0, 1):  # nothing changes without a pivot
        np.testing.assert_array_equal(t_inv.numpy()[lane], before[0][lane])
        np.testing.assert_array_equal(t_bfs.numpy()[lane], before[1][lane])
    assert (t_inv.numpy()[2] != before[0][2]).any()


def test_ratio_test_divides_the_unclamped_bfs():
    """The kernel's ratio test does not clamp ``bfs`` at zero (the einsum
    branch of the step does): a slightly negative basic value gives a
    negative ratio, which wins."""
    invB = np.eye(3, dtype=F32)[None]
    bfs = np.array([[1.0, -1e-3, 2.0]], F32)
    acol = np.array([[1.0, 1.0, 1.0]], F32)
    go = np.ones((1, 1), np.int32)
    ref = jax_ratio_eta_pivot(jnp.asarray(invB), jnp.asarray(bfs),
                              jnp.asarray(acol), jnp.asarray(go),
                              pivot_tol=PIVOT_TOL)
    t_bfs = torch.tensor(bfs)
    out = ratio_eta_pivot(torch.tensor(invB), t_bfs, torch.tensor(acol),
                          torch.tensor(go), pivot_tol=PIVOT_TOL)
    assert out[2].tolist() == np.asarray(ref[2]).tolist() == [1]
    close(t_bfs.numpy(), np.asarray(ref[1]))
    assert t_bfs[0, 0] > 1.0  # moved by the negative step


def test_step_kernel_wrappers_validate():
    A, invB, cB, c, pen, bfs = (torch.tensor(a)
                                for a in step_inputs(2, 3, 5, seed=0))
    with pytest.raises(TypeError, match="cB is torch.float64"):
        price_entering(cB.double(), invB, A, c, pen, dantzig=True,
                       opt_tol=OPT_TOL)
    with pytest.raises(ValueError, match="penalty has shape"):
        price_entering(cB, invB, A, c, pen[:, :4], dantzig=True,
                       opt_tol=OPT_TOL)
    go = torch.ones((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="go"):
        ratio_eta_pivot(invB, bfs, A[:, :, 0].contiguous(), go.long(),
                        pivot_tol=PIVOT_TOL)
    with pytest.raises(ValueError, match="contiguous"):
        ratio_eta_pivot(invB, bfs, A[:, :, 0], go, pivot_tol=PIVOT_TOL)
    assert step_kernels.launches == {"price_entering": 0,
                                     "ratio_eta_pivot": 0}


def phase1_batch(B=6, m=8, n=10, seed=0, degenerate=False):
    """The Phase-I problem of a two-phase batch (``[G | I | I_art]``, unit
    costs on the artificials) with its slack-crash state, as numpy."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    if degenerate:
        h[:, ::2] = 0.0
    eye = np.broadcast_to(np.eye(m, dtype=F32), (B, m, m))
    As = np.concatenate([G, eye], axis=2)
    neg = h < 0
    As[neg] *= -1
    b = np.abs(h)
    A1 = np.concatenate([As, eye], axis=2)
    c1 = np.concatenate([np.zeros((B, n + m), F32), np.ones((B, m), F32)],
                        axis=1)
    state = engine.slack_crash_state(torch.tensor(A1), torch.tensor(b), n + m)
    return c1, A1, b, simplex_state_to_numpy(state)


def jax_state(s):
    return jengine.SimplexState(**{k: jnp.asarray(v) for k, v in s.items()})


def assert_state_equal(port, ref, what):
    p = simplex_state_to_numpy(port)
    for name in ("basis", "iters", "status"):
        np.testing.assert_array_equal(p[name], np.asarray(getattr(ref, name)),
                                      err_msg=f"{what}: {name}")
    close(p["bfs"], np.asarray(ref.bfs), f"{what}: bfs")
    close(p["inv_B"], np.asarray(ref.inv_B), f"{what}: inv_B")


@pytest.mark.parametrize("kernels,pricing", [
    ("pallas", "bland"), ("pallas", "dantzig"),
    ("xla", "bland"), ("xla", "dantzig"), ("xla", "devex")])
def test_batched_primal_step_matches_reference(kernels, pricing):
    """40 steps from the slack-crash state of a Phase-I batch, both
    branches: the same basis, iteration count and status after every step
    (and devex weights to 1e-5)."""
    c1, A1, b, s0 = phase1_batch()
    B, m, n = A1.shape
    jcfg = JaxSolverConfig(kernels=kernels, pricing=pricing)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    assert cfg.kernels == {"pallas": "cuda", "xla": "torch"}[kernels]
    allowed = np.ones(n, bool)
    jargs = (jnp.asarray(c1), jnp.asarray(A1), jnp.asarray(b),
             jnp.asarray(allowed))
    targs = tuple(torch.tensor(a) for a in (c1, A1, b, allowed))
    jst, tst = jax_state(s0), simplex_state_from_numpy(s0)
    jgamma = jnp.ones((B, n), jnp.float32) if pricing == "devex" else None
    tgamma = torch.ones((B, n)) if pricing == "devex" else None
    moved = 0
    for k in range(40):
        # the reference's kernels donate their state: keep host copies
        jst = jax_state({f: np.array(v) for f, v in jst._asdict().items()})
        jout = jax_batched_primal_step(*jargs, jst, jcfg, 100, gamma=jgamma)
        tout = batched_primal_step(*targs, tst, cfg, 100, gamma=tgamma)
        if pricing == "devex":
            (jst, jgamma), (tst, tgamma) = jout, tout
            close(tgamma.numpy(), np.asarray(jgamma), f"step {k}: gamma")
        else:
            jst, tst = jout, tout
        assert_state_equal(tst, jst, f"step {k}")
        moved += int((tst.status == st.RUNNING).any())
    assert moved >= 5
    assert (simplex_state_to_numpy(tst)["status"] == st.OPTIMAL).all()


def test_batched_primal_step_refuses_devex_on_the_kernel_branch():
    c1, A1, b, s0 = phase1_batch(B=2, m=3, n=4)
    args = tuple(torch.tensor(a) for a in (c1, A1, b,
                                            np.ones(A1.shape[2], bool)))
    state = simplex_state_from_numpy(s0)
    with pytest.raises(ValueError, match="devex"):
        batched_primal_step(*args, state, SolverConfig(pricing="devex"), 10,
                            gamma=torch.ones((2, A1.shape[2])))
    with pytest.raises(ValueError, match="devex"):
        batched_primal_step(*args, state,
                            SolverConfig(pricing="devex", kernels="torch"), 10)


def test_batched_primal_step_clamps_a_nan_entering_column():
    """With a NaN reduced cost the dantzig kernel's ``enter`` is ``n``; the
    reference's gather clamps it, so the step clamps before it gathers and
    the lane goes on (here: no eligible column, OPTIMAL) instead of reading
    out of bounds."""
    c1, A1, b, s0 = phase1_batch(B=2, m=3, n=4)
    n = A1.shape[2]
    c1[1, 0] = np.nan
    cB, invB = np.zeros((2, 3), F32), s0["inv_B"]
    pen = np.zeros((2, n), F32)
    ref = jax_price_entering(jnp.asarray(cB), jnp.asarray(invB),
                             jnp.asarray(A1), jnp.asarray(c1),
                             jnp.asarray(pen), dantzig=True, opt_tol=OPT_TOL)
    out = price_entering(*(torch.tensor(a) for a in (cB, invB, A1, c1, pen)),
                         dantzig=True, opt_tol=OPT_TOL)
    assert int(np.asarray(ref[0])[1]) == n == int(out[0][1])
    assert int(np.asarray(ref[1])[1]) == 0 == int(out[1][1])

    cfg = SolverConfig(pricing="dantzig")
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig")
    allowed = np.ones(n, bool)
    tout = batched_primal_step(*(torch.tensor(a) for a in (c1, A1, b, allowed)),
                               simplex_state_from_numpy(s0), cfg, 10)
    jout = jax_batched_primal_step(jnp.asarray(c1), jnp.asarray(A1),
                                   jnp.asarray(b), jnp.asarray(allowed),
                                   jax_state(s0), jcfg, 10)
    np.testing.assert_array_equal(tout.basis.numpy(), np.asarray(jout.basis))
    np.testing.assert_array_equal(tout.status.numpy(), np.asarray(jout.status))
    assert tout.status.tolist()[1] == st.OPTIMAL
    assert (tout.basis.numpy()[1] < n).all()


@pytest.mark.parametrize("pricing,degenerate,refactor", [
    ("bland", False, 8), ("dantzig", False, 8), ("dantzig", True, 8),
    ("devex", False, 8), ("dantzig", False, 0)],
    ids=["bland", "dantzig", "dantzig-degenerate", "devex", "one-chunk"])
def test_run_batched_torch_matches_reference_xla(pricing, degenerate, refactor):
    """The per-step loop to termination against the reference's XLA batched
    path: chunks of 8 steps with refactorizations, stall escalation (limit
    2, firing on the degenerate batch), devex weights in the carry."""
    c1, A1, b, s0 = phase1_batch(seed=3, degenerate=degenerate)
    n = A1.shape[2]
    jcfg = JaxSolverConfig(kernels="xla", pricing=pricing,
                           refactor_every=refactor, stall_limit=2)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    allowed = np.ones(n, bool)
    ref = jax_run_batched(jnp.asarray(c1), jnp.asarray(A1), jnp.asarray(b),
                          jax_state(s0), jnp.asarray(allowed), 200, jcfg)
    out = run_batched(*(torch.tensor(a) for a in (c1, A1, b)),
                      simplex_state_from_numpy(s0), torch.tensor(allowed),
                      200, cfg)
    assert_state_equal(out, ref, "run_batched")
    assert (out.status.numpy() == st.OPTIMAL).all()
    if not degenerate:  # feasible by construction: Phase I reaches zero
        art = out.basis.numpy() >= n - b.shape[1]
        assert (np.where(art, out.bfs.numpy(), 0.0).sum(axis=1) < 1e-4).all()
    else:  # escalation changed the path
        plain = run_batched_steps(
            *(torch.tensor(a) for a in (c1, A1, b)),
            simplex_state_from_numpy(s0), torch.tensor(allowed), 200,
            cfg.replace(stall_limit=0))
        assert (plain.iters != out.iters).any() or (plain.basis
                                                    != out.basis).any()


def test_run_batched_takes_the_per_step_loop_past_every_streaming_variant(
        monkeypatch):
    """With ``kernels="cuda"`` a shape past every streaming variant raises
    in either mode and names ``kernels="torch"``: the kernel setting never
    runs plain PyTorch on its own (the name dates from when it did).  The
    explicit ``"torch"`` choice runs the per-step loop there in primal mode
    and the per-lane engine in dual mode (the Phase-I start is primal
    feasible, so the dual engine finds it OPTIMAL in one entry)."""
    import linprog_tpu_torch.engine_batched as teb

    c1, A1, b, s0 = phase1_batch(seed=3)
    n = A1.shape[2]
    args = tuple(torch.tensor(a) for a in (c1, A1, b))
    allowed = torch.ones(n, dtype=torch.bool)
    cfg = SolverConfig(pricing="dantzig", refactor_every=8)
    monkeypatch.setattr(teb, "_mega_kernel_fits", lambda m, n, with_at: False)
    monkeypatch.setattr(teb, "_stream_variant", lambda m, n: None)
    for mode in ("primal", "dual"):
        with pytest.raises(NotImplementedError, match="kernels='torch'"):
            run_batched(*args, simplex_state_from_numpy(s0), allowed, 200,
                        cfg, mode=mode)
    got = run_batched(*args, simplex_state_from_numpy(s0), allowed, 200,
                      cfg.replace(kernels="torch"))
    assert (got.status.numpy() == st.OPTIMAL).all()
    dual = run_batched(*args, simplex_state_from_numpy(s0), allowed, 200,
                       cfg.replace(kernels="torch"), mode="dual")
    assert (dual.status.numpy() == st.OPTIMAL).all()
    assert (dual.iters.numpy() == 1).all()
    np.testing.assert_array_equal(dual.basis.numpy(), s0["basis"])


def test_batched_refactorize_refreshes_every_lane():
    c1, A1, b, s0 = phase1_batch(seed=5)
    A, bt = torch.tensor(A1), torch.tensor(b)
    state = simplex_state_from_numpy(s0)
    drift = state._replace(inv_B=state.inv_B + 1e-3, bfs=state.bfs + 1e-3)
    fresh = batched_refactorize(A, bt, drift)
    close(fresh.inv_B.numpy(), s0["inv_B"])
    close(fresh.bfs.numpy(), s0["bfs"])
    np.testing.assert_array_equal(fresh.basis.numpy(), s0["basis"])
