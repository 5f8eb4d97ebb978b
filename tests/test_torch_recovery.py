"""linprog_tpu_torch's pooled IPM straggler recovery against the
reference's, on the same host instances and the same raw IPM results.

The IPM is starved (``maxiters=4``), so every lane is a straggler; the
reference's raw results are carried across with
``convert.batch_result_from_numpy`` so that both recoveries start from the
same iterates.  The reference's crossover runs on its Pallas kernel in
interpret mode, the port's on its kernel's plain version.  Checks: the same
pick list and bucket size (read at each package's ``_recovery_gather``), the
same status per lane (all OPTIMAL), a basis on every recovered lane, costs
within 1e-5 relative of the reference's and of HiGHS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as scipy_linprog


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Same XLA CPU compile-count workaround as tests/test_solve_kernel.py."""
    jax.clear_caches()
    yield
    jax.clear_caches()


import linprog_tpu.ipm as jipm  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.results import BatchResult as JaxBatchResult  # noqa: E402

import linprog_tpu_torch.ipm as tipm  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    batch_result_from_numpy,
    batch_result_to_numpy,
    config_from_reference,
)
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402

JIPM = jipm.IPMConfig(eps_rel=1e-3, maxiters=4)  # starved: all stragglers
JRC = JaxSolverConfig(kernels="pallas", pricing="dantzig", refactor_every=64,
                      polish_pivots=8)
RC = config_from_reference(dataclasses.asdict(JRC))
B, M, N, CHUNKS = 8, 20, 20, 3


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def _highs(c, G, h):
    out = []
    for i in range(c.shape[0]):
        ref = scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                            method="highs")
        assert ref.status == 0
        out.append(ref.fun)
    return np.array(out)


@pytest.fixture(scope="module")
def chunks():
    return [random_inequality_lps(B, M, N, seed=s) for s in range(CHUNKS)]


@pytest.fixture(scope="module")
def raws(chunks):
    """The reference's starved IPM results, as numpy dicts."""
    out = []
    for c, G, h in chunks:
        r = jipm.ipm_solve_batch_canonical(jnp.asarray(c), jnp.asarray(G),
                                           jnp.asarray(h), JIPM)
        out.append({k: None if v is None else np.asarray(v)
                    for k, v in r._asdict().items()})
    assert all((r["status"] != st.OPTIMAL).all() for r in out)
    return out


def _both(chunks, raws, monkeypatch, **kw):
    """Run both recoveries on the same raws; returns (reference results as
    dicts, port results as dicts, reference pick, port pick), a pick being
    the list of (chunk, lane) in bucket order."""
    picks = {}
    jgather, tgather = jipm._recovery_gather, tipm._recovery_gather

    def jspy(cs, Gs, hs, xs, ys, bidx, lidx):
        picks["ref"] = list(zip(np.asarray(bidx).tolist(),
                                np.asarray(lidx).tolist()))
        return jgather(cs, Gs, hs, xs, ys, bidx, lidx)

    def tspy(cs, Gs, hs, xs, ys, bidx, lidx):
        picks["port"] = list(zip(bidx.tolist(), lidx.tolist()))
        return tgather(cs, Gs, hs, xs, ys, bidx, lidx)

    monkeypatch.setattr(jipm, "_recovery_gather", jspy)
    monkeypatch.setattr(tipm, "_recovery_gather", tspy)
    jb = [tuple(jnp.asarray(a) for a in ch) for ch in chunks]
    jr = [JaxBatchResult(**{k: None if v is None else jnp.asarray(v)
                            for k, v in r.items()}) for r in raws]
    ref = jipm.recover_stragglers_pooled(jb, jr, recover_cfg=JRC, **kw)
    tb = [tuple(torch.tensor(a) for a in ch) for ch in chunks]
    tr = [batch_result_from_numpy(r) for r in raws]
    got = tipm.recover_stragglers_pooled(tb, tr, recover_cfg=RC, **kw)
    ref = [{k: None if v is None else np.asarray(v)
            for k, v in r._asdict().items()} for r in ref]
    return ref, [batch_result_to_numpy(r) for r in got], picks.get("ref"), \
        picks.get("port")


def test_pooled_recovery_matches_reference(chunks, raws, monkeypatch):
    ref, got, jpick, tpick = _both(chunks, raws, monkeypatch, maxiters=400)
    # 24 stragglers: the next power of two, 32, capped at the 24 lanes
    assert tpick == jpick and len(tpick) == 24
    assert tpick == sorted(tpick)
    for (c, G, h), r, g, raw in zip(chunks, ref, got, raws):
        np.testing.assert_array_equal(g["status"], r["status"])
        assert (g["status"] == st.OPTIMAL).all()
        assert (g["basis"] >= 0).all() and (g["basis"] < N + M).all()
        assert _rel(g["cost"], r["cost"]).max() < 1e-5
        assert _rel(g["cost"], _highs(c, G, h)).max() < 1e-5
        assert g["x"].shape == (B, N + M) and (g["x"] >= 0).all()
        # the slack half of x is h - Gx of the structural half
        slack = h - np.einsum("bmn,bn->bm", G, g["x"][:, :N])
        assert np.abs(g["x"][:, N:] - np.maximum(slack, 0)).max() < 1e-5
        assert (g["iters"] >= raw["iters"]).all()
        assert g["y"].shape == (B, M)


def test_single_batch_recover_flag_matches_reference(chunks):
    """``ipm_solve_batch_canonical(recover=True)`` end to end in both
    packages (each from its own starved IPM)."""
    c, G, h = chunks[0]
    ref = jipm.ipm_solve_batch_canonical(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), JIPM, recover=True,
        recover_cfg=JRC, recover_maxiters=400)
    cfg = config_from_reference(dataclasses.asdict(JIPM))
    raw = tipm.ipm_solve_batch_canonical(torch.tensor(c), torch.tensor(G),
                                         torch.tensor(h), cfg)
    assert (raw.status != st.OPTIMAL).all() and (raw.basis == -1).all()
    res, state = tipm.ipm_solve_batch_canonical(
        torch.tensor(c), torch.tensor(G), torch.tensor(h), cfg, recover=True,
        recover_cfg=RC, recover_maxiters=400, return_state=True)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert (res.status == st.OPTIMAL).all() and (res.basis >= 0).all()
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 1e-5
    assert _rel(res.cost.numpy(), _highs(c, G, h)).max() < 1e-5
    np.testing.assert_array_equal(state.x.numpy(), raw.x.numpy())  # the IPM's


def test_few_stragglers_fill_a_bucket_of_eight(chunks, raws, monkeypatch):
    """Three stragglers among 24 lanes: bucket 8 with cyclic fill; every
    other lane comes back untouched."""
    marked = [dict(r) for r in raws]
    strag = {(0, 2), (1, 5), (2, 7)}
    for bi, r in enumerate(marked):
        r["status"] = np.array([r["status"][k] if (bi, k) in strag
                                else st.OPTIMAL for k in range(B)], np.int32)
    ref, got, jpick, tpick = _both(chunks, marked, monkeypatch, maxiters=400)
    assert tpick == jpick and len(tpick) == 8 and set(tpick) == strag
    for bi, (r, g, raw) in enumerate(zip(ref, got, marked)):
        np.testing.assert_array_equal(g["status"], r["status"])
        assert (g["status"] == st.OPTIMAL).all()
        assert _rel(g["cost"], r["cost"]).max() < 1e-5
        keep = np.array([(bi, k) not in strag for k in range(B)])
        for key in ("x", "y", "cost", "basis", "iters"):
            np.testing.assert_array_equal(g[key][keep], raw[key][keep])
        assert (g["basis"][~keep] >= 0).all()


def test_bucket_is_capped_at_the_total(chunks, raws, monkeypatch):
    small = [tuple(a[:4] for a in chunks[0])]
    sraw = [{k: v[:4] for k, v in raws[0].items()}]
    ref, got, jpick, tpick = _both(small, sraw, monkeypatch, maxiters=400)
    assert tpick == jpick == [(0, k) for k in range(4)]
    assert (got[0]["status"] == st.OPTIMAL).all()
    assert _rel(got[0]["cost"], ref[0]["cost"]).max() < 1e-5


def test_result_without_duals_takes_the_magnitude_ranking(chunks, raws,
                                                          monkeypatch):
    no_y = [dict(r, y=None) for r in raws]
    seen = {}
    real = tipm._recovery_gather

    def spy(*args):
        out = real(*args)
        seen["indicator"] = out[-1]
        return out

    monkeypatch.setattr(tipm, "_recovery_gather", spy)
    got = tipm.recover_stragglers_pooled(
        [tuple(torch.tensor(a) for a in ch) for ch in chunks],
        [batch_result_from_numpy(r) for r in no_y], recover_cfg=RC,
        maxiters=400)
    assert seen["indicator"] is None
    jb = [tuple(jnp.asarray(a) for a in ch) for ch in chunks]
    jr = [JaxBatchResult(**{k: None if v is None else jnp.asarray(v)
                            for k, v in r.items()}) for r in no_y]
    ref = jipm.recover_stragglers_pooled(jb, jr, recover_cfg=JRC,
                                         maxiters=400)
    for (c, G, h), r, g in zip(chunks, ref, got):
        assert g.y is None and r.y is None
        np.testing.assert_array_equal(g.status.numpy(), np.asarray(r.status))
        ok = g.status.numpy() == st.OPTIMAL
        assert ok.sum() >= B - 1
        assert _rel(g.cost.numpy(), np.asarray(r.cost))[ok].max() < 1e-5
        assert _rel(g.cost.numpy(), _highs(c, G, h))[ok].max() < 1e-5


def test_batch_without_stragglers_is_returned_as_it_is(chunks, raws):
    done = [batch_result_from_numpy(
        dict(r, status=np.full(B, st.OPTIMAL, np.int32))) for r in raws]
    out = tipm.recover_stragglers_pooled(
        [tuple(torch.tensor(a) for a in ch) for ch in chunks], done)
    assert len(out) == CHUNKS and all(o is d for o, d in zip(out, done))


def test_uncrossed_lanes_keep_their_ipm_answer(chunks, raws):
    """A one-pivot budget cannot repair every lane: a lane that does not
    cross keeps its raw x, cost, status and basis -1."""
    tb = [tuple(torch.tensor(a) for a in chunks[0])]
    raw = batch_result_from_numpy(raws[0])
    (out,) = tipm.recover_stragglers_pooled(tb, [raw], recover_cfg=RC,
                                            maxiters=1)
    lost = out.status != st.OPTIMAL
    assert lost.any() and not lost.all()
    for a, b in zip(out, raw):
        np.testing.assert_array_equal(a[lost].numpy(), b[lost].numpy())
    assert (out.basis[~lost] >= 0).all()


def test_recovery_gather_and_extend_match_reference():
    """The gather's Tapia indicator within 1e-6 relative of the
    reference's, its all-finite guard, and ``max(slack, 0)`` with XLA's
    ``+0.0`` for a ``-0.0`` slack."""
    rng = np.random.default_rng(3)
    K, b, m, n = 2, 5, 4, 6
    cs = rng.normal(size=(K, b, n)).astype(np.float32)
    Gs = rng.normal(size=(K, b, m, n)).astype(np.float32)
    hs = rng.normal(size=(K, b, m)).astype(np.float32)
    xs = rng.normal(size=(K, b, n + m)).astype(np.float32)
    ys = -rng.random((K, b, m)).astype(np.float32)
    xs[1, 2, 0] = np.inf  # a lane whose ratios are not all finite
    xs[0, 1, 3] = -0.0
    pick = [(0, 1), (0, 4), (1, 2), (1, 2), (1, 3)]
    bidx = np.array([p[0] for p in pick])
    lidx = np.array([p[1] for p in pick])
    ref = jipm._recovery_gather(*(jnp.asarray(a) for a in (cs, Gs, hs, xs, ys)),
                                jnp.asarray(bidx, jnp.int32),
                                jnp.asarray(lidx, jnp.int32))
    got = tipm._recovery_gather(
        *([torch.tensor(a[k]) for k in range(K)] for a in (cs, Gs, hs, xs, ys)),
        torch.tensor(bidx), torch.tensor(lidx))
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ind, jind = got[4].numpy(), np.asarray(ref[4])
    finite = np.isfinite(jind)
    np.testing.assert_array_equal(np.isfinite(ind), finite)
    np.testing.assert_allclose(ind[finite], jind[finite], rtol=1e-6)
    np.testing.assert_array_equal(np.signbit(ind[finite]),
                                  np.signbit(jind[finite]))
    np.testing.assert_array_equal(ind[2, 1:], np.maximum(xs[1, 2, 1:], 0))

    G = np.zeros((2, 1, 1), np.float32)
    h = np.array([[-0.0], [-3.0]], np.float32)
    x = np.ones((2, 1), np.float32)
    jext = np.asarray(jipm._recovery_extend_x(jnp.asarray(x), jnp.asarray(G),
                                              jnp.asarray(h)))
    ext = tipm._recovery_extend_x(torch.tensor(x), torch.tensor(G),
                                  torch.tensor(h)).numpy()
    np.testing.assert_array_equal(ext, jext)
    np.testing.assert_array_equal(np.signbit(ext), np.signbit(jext))
    assert not np.signbit(ext[:, 1]).any()
