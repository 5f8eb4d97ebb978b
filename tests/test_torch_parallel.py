"""linprog_tpu_torch.parallel against the reference's parallel package.

The port's ranks are processes on ``torch.distributed`` over gloo on the
CPU: one rank in this process (an in-memory store), or 2 and 4 spawned
ranks rendezvousing through a file in ``tmp_path``.  The reference runs
on the 8 virtual CPU devices of ``tests/conftest.py``.  Every spawn has a
time limit and every process group a timeout, so a dead rank fails a test
instead of hanging it.
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linprog_tpu import SolverConfig as JaxSolverConfig
from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase
from linprog_tpu.ipm import IPMConfig as JaxIPMConfig
from linprog_tpu.ipm import ipm_solve_batch_canonical as jax_ipm
from linprog_tpu.parallel import make_model_mesh as jax_model_mesh
from linprog_tpu.parallel import tp_solve as jax_tp_solve
from linprog_tpu.parallel import tp_solve_batch as jax_tp_solve_batch
from linprog_tpu.parallel.distributed import global_2d_mesh as jax_2d_mesh
from linprog_tpu.pdhg import PDHGConfig as JaxPDHGConfig
from linprog_tpu.pdhg import pdhg_solve_batch_canonical as jax_pdhg

from linprog_tpu_torch import SolverConfig
from linprog_tpu_torch import status as st
from linprog_tpu_torch.batch import solve_batch_two_phase
from linprog_tpu_torch.generators import (
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu_torch.ipm import IPMConfig, ipm_solve_batch_canonical
from linprog_tpu_torch.parallel import distributed, dryrun
from linprog_tpu_torch.parallel import make_model_mesh, tp_solve
from linprog_tpu_torch.pdhg import PDHGConfig, pdhg_solve_batch_canonical

SPAWN_TIMEOUT_S = 300
PRICINGS = ("bland", "dantzig")


def _random_standard_lp(rng, m, n):
    """The generator of ``tests/test_tensor_parallel.py``: the slack basis
    is feasible."""
    G = rng.normal(size=(m, n - m))
    b = np.abs(G @ rng.uniform(0.5, 1.5, size=n - m)) + rng.uniform(
        0.5, 1.5, size=m
    )
    y0 = rng.uniform(0.0, 1.0, size=m)
    s = rng.uniform(0.1, 1.0, size=n - m)
    c = np.concatenate([s - G.T @ y0, np.zeros(m)])
    A = np.concatenate([G, np.eye(m)], axis=1)
    return (c.astype(np.float32), A.astype(np.float32), b.astype(np.float32),
            np.arange(n - m, n))


def _inputs():
    """Every input of the spawned checks, made on the host from seeds."""
    c, A, b, basis = _random_standard_lp(np.random.default_rng(0), 8, 32)
    # DP x TP: the batch of tests/test_multiprocess_distributed.py
    cb, Ab, bb = to_standard_form_batch(*random_inequality_lps(8, 6, 10,
                                                               seed=21))
    # DP: the two-process batch of the same file, the dry run's IPM batch,
    # and its PDHG batch
    cs, As, bs = to_standard_form_batch(*random_inequality_lps(8, 6, 8,
                                                               seed=42))
    ci, Gi, hi = random_inequality_lps(8, 6, 9, seed=5)
    rng = np.random.default_rng(4)
    Gp = rng.standard_normal((8, 6, 9)).astype(np.float32)
    x0 = rng.random((8, 9)).astype(np.float32)
    hp = np.einsum("bmn,bn->bm", Gp, x0) + rng.random((8, 6)).astype(
        np.float32)
    cp = (0.2 + rng.random((8, 9)) - np.einsum(
        "bmn,bm->bn", Gp, rng.random((8, 6)))).astype(np.float32)
    return dict(c=c, A=A, b=b, basis=basis, cb=cb, Ab=Ab, bb=bb,
                basis_b=np.broadcast_to(np.arange(10, 16), (8, 6)).copy(),
                cs=cs, As=As, bs=bs, ci=ci, Gi=Gi, hi=hi, cp=cp, Gp=Gp, hp=hp)


DP_CFG = dict(pricing="dantzig", refactor_every=16)
IPM_EPS = 1e-3
PDHG_EPS = 1e-4

# Each rank: the tensor-parallel solves at its world size, and at 4 ranks
# DP x TP on a (2, 2) mesh; at 2 ranks the data-parallel solvers (from
# global tensors and from shard_batch's DTensors) and the refusals.
_WORKER = r"""
import json, sys
import numpy as np, torch
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from linprog_tpu_torch import SolverConfig
from linprog_tpu_torch.ipm import IPMConfig
from linprog_tpu_torch.pdhg import PDHGConfig
from linprog_tpu_torch.parallel import (
    distributed, make_batch_mesh, make_model_mesh, shard_batch,
    sharded_ipm_batch_canonical, sharded_pdhg_batch_canonical,
    sharded_two_phase_solve, tp_solve, tp_solve_batch)
distributed.initialize(init, world, rank, device="cpu", timeout_s=120)
d = {k: torch.as_tensor(v) for k, v in np.load(tmp + "/inputs.npz").items()}
cfg = json.load(open(tmp + "/cfg.json"))
out, errors = {}, {}
for pricing in ("bland", "dantzig"):
    s = tp_solve(d["c"], d["A"], d["b"], d["basis"], 200, make_model_mesh(),
                 SolverConfig(pricing=pricing))
    for k in ("basis", "bfs", "status", "iters"):
        out[f"tp_{pricing}_{k}"] = getattr(s, k).numpy()
if world == 4:
    mesh2d = distributed.global_2d_mesh(2)
    s = tp_solve_batch(d["cb"], d["Ab"], d["bb"], d["basis_b"], 200, mesh2d,
                       SolverConfig(pricing="dantzig"))
    for k in ("basis", "bfs", "status", "iters"):
        out[f"tpb_{k}"] = getattr(s, k).numpy()
if world == 2:
    mesh = make_batch_mesh()
    dp = SolverConfig(**cfg["dp"])
    runs = {
        "two_phase": lambda: sharded_two_phase_solve(
            mesh, d["cs"], d["As"], d["bs"], 200, 200, dp),
        "two_phase_dtensor": lambda: sharded_two_phase_solve(
            mesh, *shard_batch(mesh, d["cs"], d["As"], d["bs"]), 200, 200, dp),
        "ipm": lambda: sharded_ipm_batch_canonical(
            mesh, d["ci"], d["Gi"], d["hi"], IPMConfig(eps_rel=cfg["ipm_eps"])),
        "pdhg": lambda: dict(zip(("x", "cost", "status", "iters"),
            sharded_pdhg_batch_canonical(
                mesh, d["cp"], d["Gp"], d["hp"], maxiters=50_000,
                cfg=PDHGConfig(eps_rel=cfg["pdhg_eps"])))),
    }
    for name, run in runs.items():
        r = run()
        r = r if isinstance(r, dict) else r._asdict()
        for k in ("x", "cost", "status", "iters"):
            out[f"dp_{name}_{k}"] = r[k].numpy()
    refusals = {
        "two_phase": lambda: sharded_two_phase_solve(
            mesh, d["cs"][:3], d["As"][:3], d["bs"][:3]),
        "ipm": lambda: sharded_ipm_batch_canonical(
            mesh, d["ci"][:5], d["Gi"][:5], d["hi"][:5]),
        "pdhg": lambda: sharded_pdhg_batch_canonical(
            mesh, d["cp"][:7], d["Gp"][:7], d["hp"][:7]),
        "tp_solve": lambda: tp_solve(
            torch.zeros(9), torch.zeros((2, 9)), torch.zeros(2),
            torch.tensor([0, 1]), 10, make_model_mesh()),
        "tp_solve_batch_n": lambda: tp_solve_batch(
            torch.zeros((2, 9)), torch.zeros((2, 2, 9)), torch.zeros((2, 2)),
            torch.zeros((2, 2), dtype=torch.int32), 10,
            distributed.global_2d_mesh(2)),
        "tp_solve_batch_B": lambda: tp_solve_batch(
            torch.zeros((3, 8)), torch.zeros((3, 2, 8)), torch.zeros((3, 2)),
            torch.zeros((3, 2), dtype=torch.int32), 10,
            distributed.global_2d_mesh(1)),
        "global_2d_mesh": lambda: distributed.global_2d_mesh(3),
    }
    for name, run in refusals.items():
        try:
            run()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
np.savez(f"{tmp}/rank{rank}.npz", **out)
json.dump(errors, open(f"{tmp}/errors{rank}.json", "w"))
distributed.shutdown()
"""


def _rank_cmds(tmp: pathlib.Path, world: int):
    """The commands of ``world`` ranks of ``_WORKER`` over ``tmp``'s
    inputs."""
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    init = "file://" + str(tmp / "rendezvous")
    return [[sys.executable, str(script), str(r), str(world), init, str(tmp)]
            for r in range(world)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ranks' results at 2 and 4 ranks: ``{world: [per-rank npz]}``
    and the refusals' messages at 2 ranks."""
    inputs = _inputs()
    tmps, cmds = [], []
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        np.savez(tmp / "inputs.npz", **inputs)
        (tmp / "cfg.json").write_text(json.dumps(
            {"dp": DP_CFG, "ipm_eps": IPM_EPS, "pdhg_eps": PDHG_EPS}))
        tmps.append(tmp)
        cmds += _rank_cmds(tmp, world)
    # both groups at once, every rank killed at the first failure
    ranks = dryrun.spawn_ranks(cmds, SPAWN_TIMEOUT_S)
    assert not any(code for code, _ in ranks), dryrun.rank_tails(ranks, 4000)
    out = {world: [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
           for world, tmp in zip((2, 4), tmps)}
    errors = json.loads((tmps[0] / "errors0.json").read_text())
    return inputs, out, errors


@pytest.fixture()
def one_rank():
    """A one-process gloo group in this process, destroyed afterwards."""
    distributed.initialize(device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


def _reference_tp(inputs, world, pricing):
    cfg = JaxSolverConfig(pricing=pricing)
    return jax_tp_solve(jnp.asarray(inputs["c"]), jnp.asarray(inputs["A"]),
                        jnp.asarray(inputs["b"]), inputs["basis"], 200,
                        jax_model_mesh(world), cfg)


def _hold_tp(got: dict, ref):
    assert int(got["status"]) == int(ref.status) == st.OPTIMAL
    np.testing.assert_array_equal(got["basis"], np.asarray(ref.basis))
    assert int(got["iters"]) == int(ref.iters)
    np.testing.assert_allclose(got["bfs"], np.asarray(ref.bfs), atol=1e-4)


@pytest.mark.parametrize("pricing", PRICINGS)
def test_tp_solve_one_rank_matches_reference(pricing, one_rank):
    inputs = _inputs()
    s = tp_solve(torch.as_tensor(inputs["c"]), torch.as_tensor(inputs["A"]),
                 torch.as_tensor(inputs["b"]), torch.as_tensor(inputs["basis"]),
                 200, make_model_mesh(), SolverConfig(pricing=pricing))
    _hold_tp({k: getattr(s, k).numpy() for k in s._fields},
             _reference_tp(inputs, 1, pricing))


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("pricing", PRICINGS)
def test_tp_solve_spawned_ranks_match_reference(spawned, world, pricing):
    """Basis for basis (and pivot count) the reference's ``tp_solve`` on
    a ``world``-device model mesh; every rank returns the same state."""
    inputs, out, _ = spawned
    ref = _reference_tp(inputs, world, pricing)
    for rank_out in out[world]:
        _hold_tp({k: rank_out[f"tp_{pricing}_{k}"]
                  for k in ("basis", "bfs", "status", "iters")}, ref)


def test_tp_solve_batch_on_a_2x2_mesh_matches_reference(spawned):
    inputs, out, _ = spawned
    ref = jax_tp_solve_batch(
        jnp.asarray(inputs["cb"]), jnp.asarray(inputs["Ab"]),
        jnp.asarray(inputs["bb"]), jnp.asarray(inputs["basis_b"], jnp.int32),
        200, jax_2d_mesh(2), JaxSolverConfig(pricing="dantzig"))
    for rank_out in out[4]:
        np.testing.assert_array_equal(rank_out["tpb_status"],
                                      np.asarray(ref.status))
        assert (rank_out["tpb_status"] == st.OPTIMAL).all()
        np.testing.assert_array_equal(rank_out["tpb_basis"],
                                      np.asarray(ref.basis))
        np.testing.assert_array_equal(rank_out["tpb_iters"],
                                      np.asarray(ref.iters))
        np.testing.assert_allclose(rank_out["tpb_bfs"], np.asarray(ref.bfs),
                                   atol=2e-4, rtol=2e-4)


def _unsharded(name, inputs):
    """The port's unsharded solve and the reference's statuses."""
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    if name.startswith("two_phase"):
        res = solve_batch_two_phase(t["cs"], t["As"], t["bs"], 200, 200,
                                    SolverConfig(**DP_CFG))
        ref = jax_two_phase(jnp.asarray(inputs["cs"]),
                            jnp.asarray(inputs["As"]),
                            jnp.asarray(inputs["bs"]), 200, 200,
                            JaxSolverConfig(**DP_CFG))
        return res.cost, res.status, ref.status
    if name == "ipm":
        res = ipm_solve_batch_canonical(t["ci"], t["Gi"], t["hi"],
                                        IPMConfig(eps_rel=IPM_EPS))
        ref = jax_ipm(jnp.asarray(inputs["ci"]), jnp.asarray(inputs["Gi"]),
                      jnp.asarray(inputs["hi"]), JaxIPMConfig(eps_rel=IPM_EPS))
        return res.cost, res.status, ref.status
    _, cost, status, _ = pdhg_solve_batch_canonical(
        t["cp"], t["Gp"], t["hp"], maxiters=50_000,
        cfg=PDHGConfig(eps_rel=PDHG_EPS))
    _, _, ref_status, _ = jax_pdhg(
        jnp.asarray(inputs["cp"]), jnp.asarray(inputs["Gp"]),
        jnp.asarray(inputs["hp"]), maxiters=50_000,
        cfg=JaxPDHGConfig(eps_rel=PDHG_EPS))
    return cost, status, ref_status


@pytest.mark.parametrize("name", ("two_phase", "two_phase_dtensor", "ipm",
                                  "pdhg"))
def test_sharded_solvers_at_two_ranks_equal_the_unsharded_solve(spawned,
                                                                 name):
    """Two ranks of four lanes each: the gathered costs are the port's
    unsharded costs bit for bit on the CPU, the statuses the reference's."""
    inputs, out, _ = spawned
    cost, status, ref_status = _unsharded(name, inputs)
    for rank_out in out[2]:
        np.testing.assert_array_equal(rank_out[f"dp_{name}_cost"],
                                      cost.numpy())
        np.testing.assert_array_equal(rank_out[f"dp_{name}_status"],
                                      status.numpy())
        np.testing.assert_array_equal(rank_out[f"dp_{name}_status"],
                                      np.asarray(ref_status))
        assert (rank_out[f"dp_{name}_status"] == st.OPTIMAL).all()


@pytest.mark.parametrize("name,match", [
    ("two_phase", "batch size 3 not divisible by mesh size 2"),
    ("ipm", "batch size 5 not divisible by mesh size 2"),
    ("pdhg", "batch size 7 not divisible by mesh size 2"),
    ("tp_solve", "n=9 not divisible by mesh axis size 2"),
    ("tp_solve_batch_n", "n=9 not divisible by model axis 2"),
    ("tp_solve_batch_B", "B=3 not divisible by batch axis 2"),
    ("global_2d_mesh", "2 devices not divisible by model_size=3"),
])
def test_not_divisible_raises_the_references_value_error(spawned, name,
                                                         match):
    _, _, errors = spawned
    assert errors[name] == match


def test_process_summary_one_rank(one_rank):
    s = distributed.process_summary()
    assert s == {"process_index": 0, "process_count": 1, "local_devices": 1,
                 "global_devices": 1, "platform": "cpu"}
    distributed.initialize(device="cpu")  # idempotent
    assert distributed.process_summary()["process_count"] == 1


def test_initialize_defaults_to_the_card(monkeypatch):
    """Without a card the default ``device="cuda"`` raises; nothing falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun(2)


def test_entry_returns_a_runnable_step():
    fn, args = dryrun.entry(device="cpu")
    cost, status, iters = fn(*args)
    assert cost.shape == status.shape == iters.shape == (8,)
    assert (status == st.OPTIMAL).all()


@pytest.mark.parametrize("n_procs", (2, 4))
def test_dryrun_on_cpu_ranks(n_procs):
    reports = {r["leg"]: r for r in dryrun.dryrun(n_procs, "cpu",
                                                  timeout_s=SPAWN_TIMEOUT_S)}
    assert set(reports) == {"dp", "tp", "dp_x_tp", "pdhg_dp", "ipm_dp",
                            "exact_router_dp", "bounded_dp", "sparse_dp"}
    assert reports["dp"]["lanes"] == 4 * n_procs
    assert reports["dp_x_tp"]["mesh"] == [n_procs // 2, 2]
    for leg in ("pdhg_dp", "ipm_dp", "exact_router_dp", "bounded_dp"):
        assert reports[leg]["optimal"] == reports[leg]["lanes"] == 2 * n_procs
