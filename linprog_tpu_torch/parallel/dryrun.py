"""Entry points of the port for a compile check and a multi-process dry run
(counterpart of the repository's ``__graft_entry__.py``).

* :func:`entry` -- ``(fn, example_args)``: the batched two-phase solve on
  a tiny batch.
* :func:`dryrun` -- spawn ``n_procs`` processes, one rank each, and run
  every parallel leg once at the reference's tiny shapes: data-parallel
  two-phase, tensor-parallel, DP x TP on a 2-D mesh, PDHG, IPM, the exact
  router, the bounded batch, and the sparse IPM and PDHG over the batch
  mesh (their pattern replicated).  Each leg checks what the reference's
  dry run checks; a failed check, a dead rank or the time limit raises.
* :func:`spawn_ranks` -- run a group's ranks as processes, polled and all
  killed at the first failure or the time limit (the dry run, the tests'
  ranks and the smoke script's two-process phase use it).

Run:  python -m linprog_tpu_torch.parallel.dryrun N [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tiny_batch(batch: int, m: int = 8, n: int = 12, seed: int = 0):
    """Standard-form tensors of ``random_inequality_lps`` on the host."""
    from ..generators import random_inequality_lps, to_standard_form_batch

    return tuple(torch.as_tensor(a) for a in to_standard_form_batch(
        *random_inequality_lps(batch, m, n, seed=seed)))


def _tiny_batch_canonical(batch: int, m: int, n: int, seed: int = 0):
    from ..generators import random_inequality_lps

    return tuple(torch.as_tensor(a)
                 for a in random_inequality_lps(batch, m, n, seed=seed))


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(c, A, b)`` runs the batched two-phase
    solve and returns ``(cost, status, iters)``; the arguments are a tiny
    batch on ``device``."""
    from ..batch import solve_batch_two_phase
    from ..config import SolverConfig
    from ..ipm_sparse import resolve_device

    dev = resolve_device(device)
    cfg = SolverConfig(pricing="dantzig", refactor_every=32)

    def fn(c, A, b):
        res = solve_batch_two_phase(c, A, b, maxiters1=64, maxiters2=64,
                                    cfg=cfg)
        return res.cost, res.status, res.iters

    return fn, tuple(t.to(dev) for t in _tiny_batch(batch=8))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _n_optimal(status) -> int:
    from .. import status as st

    return int((status == st.OPTIMAL).sum())


def _leg_dp(world):
    from ..config import SolverConfig
    from .mesh import make_batch_mesh, sharded_two_phase_solve

    mesh = make_batch_mesh()
    batch = 4 * world
    c, A, b = _tiny_batch(batch, m=8, n=12, seed=1)
    res = sharded_two_phase_solve(
        mesh, c, A, b, 64, 64, SolverConfig(pricing="dantzig",
                                            refactor_every=16))
    _check(tuple(res.cost.shape) == (batch,), f"DP cost {res.cost.shape}")
    return {"leg": "dp", "lanes": batch, "optimal": _n_optimal(res.status),
            "pivots": int(res.iters.sum())}


def _leg_tp(world):
    import torch.distributed as dist

    from ..config import SolverConfig
    from .tp import make_model_mesh, tp_solve

    # the reference's shapes, n = 4 a device (at one device 8 columns, so
    # that the 6 rows leave structural ones)
    tp_devs = min(4, world)
    rng = np.random.default_rng(0)
    m_tp, n_tp = 6, 4 * max(tp_devs, 2)
    G = rng.normal(size=(m_tp, n_tp - m_tp))
    b_tp = np.abs(G @ rng.uniform(0.5, 1.5, size=n_tp - m_tp)) + 1.0
    y0 = rng.uniform(0.0, 1.0, size=m_tp)
    c_tp = np.concatenate(
        [rng.uniform(0.1, 1.0, size=n_tp - m_tp) - G.T @ y0, np.zeros(m_tp)]
    ).astype(np.float32)
    A_tp = np.concatenate([G, np.eye(m_tp)], axis=1).astype(np.float32)
    mesh = make_model_mesh(tp_devs)
    if dist.get_rank() >= tp_devs:
        return {"leg": "tp", "devices": tp_devs}
    state = tp_solve(torch.as_tensor(c_tp), torch.as_tensor(A_tp),
                     torch.as_tensor(b_tp, dtype=torch.float32),
                     torch.arange(n_tp - m_tp, n_tp), 100, mesh,
                     SolverConfig(pricing="dantzig", refactor_every=16))
    _check(int(state.status) == 1,
           f"TP dryrun not optimal: {int(state.status)}")
    return {"leg": "tp", "devices": tp_devs, "pivots": int(state.iters)}


def _leg_dp_tp(world):
    from ..config import SolverConfig
    from .distributed import global_2d_mesh
    from .tp import tp_solve_batch

    model_size = 2 if world % 2 == 0 else 1
    mesh = global_2d_mesh(model_size)
    n_batch = world // model_size
    B2, m2, n2 = 2 * n_batch, 6, 16
    c, A, b = _tiny_batch(B2, m=m2, n=n2 - m2, seed=3)
    basis = torch.arange(n2 - m2, n2, dtype=torch.int32).expand(B2, m2)
    out = tp_solve_batch(c, A, b, basis, 100, mesh,
                         SolverConfig(pricing="dantzig", refactor_every=16))
    n_opt = _n_optimal(out.status)
    _check(n_opt == B2, f"DPxTP dryrun: {n_opt}/{B2} optimal")
    return {"leg": "dp_x_tp", "mesh": [n_batch, model_size], "lanes": B2,
            "optimal": n_opt}


def _leg_pdhg(world, mesh):
    from ..pdhg import PDHGConfig
    from .mesh import sharded_pdhg_batch_canonical

    Bp = 2 * world
    rng = np.random.default_rng(4)
    G = rng.standard_normal((Bp, 6, 9)).astype(np.float32)
    x0 = rng.random((Bp, 9)).astype(np.float32)
    h = np.einsum("bmn,bn->bm", G, x0) + rng.random((Bp, 6)).astype(
        np.float32)
    c = (0.2 + rng.random((Bp, 9)) - np.einsum(
        "bmn,bm->bn", G, rng.random((Bp, 6)))).astype(np.float32)
    _, _, status, iters = sharded_pdhg_batch_canonical(
        mesh, torch.as_tensor(c), torch.as_tensor(G), torch.as_tensor(h),
        maxiters=50_000, cfg=PDHGConfig(eps_rel=1e-4))
    n_opt = _n_optimal(status)
    _check(n_opt == Bp, f"PDHG DP dryrun: {n_opt}/{Bp} optimal")
    return {"leg": "pdhg_dp", "lanes": Bp, "optimal": n_opt,
            "max_iters": int(iters.max())}


def _leg_ipm(world, mesh):
    from ..ipm import IPMConfig
    from .mesh import sharded_ipm_batch_canonical

    Bi = 2 * world
    c, G, h = _tiny_batch_canonical(Bi, 6, 9, seed=5)
    res = sharded_ipm_batch_canonical(mesh, c, G, h, IPMConfig(eps_rel=1e-3))
    n_opt = _n_optimal(res.status)
    _check(n_opt == Bi, f"IPM DP dryrun: {n_opt}/{Bi} optimal")
    return {"leg": "ipm_dp", "lanes": Bi, "optimal": n_opt}


def _leg_exact(world, mesh):
    from ..config import SolverConfig
    from ..router import solve_batch_exact
    from .mesh import _solve_sharded

    Bx = 2 * world
    c, G, h = _tiny_batch_canonical(Bx, 6, 9, seed=6)
    cfg = SolverConfig(pricing="dantzig", refactor_every=64, polish_pivots=4)

    def solve(c, G, h):
        res, info = solve_batch_exact(c, G, h, cfg=cfg)
        counts = torch.tensor([[info["crossed"], info["fallback"]]],
                              device=c.device)
        return res, counts

    res, counts = _solve_sharded(mesh, solve, c, G, h)
    crossed, fallback = (int(v) for v in counts.sum(dim=0))
    n_opt = _n_optimal(res.status)
    _check(n_opt == Bx, f"exact-router DP dryrun: {n_opt}/{Bx} optimal")
    return {"leg": "exact_router_dp", "lanes": Bx, "optimal": n_opt,
            "crossed": crossed, "fallback": fallback}


def _leg_bounded(world, mesh):
    from .. import bounded as bnd
    from ..batch import solve_batch_bounded
    from ..config import SolverConfig
    from ..generators import device_bounded_lps
    from . import distributed
    from .mesh import _solve_sharded

    Bb, mb, nb = 2 * world, 5, 7
    dev = distributed.solve_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    c, A, b, lb, ub = device_bounded_lps(gen, Bb, mb, nb, dev)
    basis = torch.arange(nb, nb + mb, dtype=torch.int32,
                         device=dev).expand(Bb, mb)
    vs = torch.cat([torch.zeros((Bb, nb), dtype=torch.int8, device=dev),
                    torch.full((Bb, mb), bnd.BASIC, dtype=torch.int8,
                               device=dev)], dim=1)
    cfg = SolverConfig(pricing="dantzig", refactor_every=64, polish_pivots=4)
    res = _solve_sharded(
        mesh, lambda *a: solve_batch_bounded(*a, 500, cfg),
        c, A, b, lb, ub, basis, vs)
    n_opt = _n_optimal(res.status)
    _check(n_opt == Bb, f"bounded DP dryrun: {n_opt}/{Bb} optimal")
    return {"leg": "bounded_dp", "lanes": Bb, "optimal": n_opt}


def _leg_sparse(world, mesh):
    from ..generators import random_sparse_inequality_lps
    from ..ipm import IPMConfig
    from ..ipm_sparse import ipm_solve_batch_sparse_canonical
    from ..pdhg import PDHGConfig, pdhg_solve_batch_sparse
    from .mesh import _solve_sharded

    Bs, ms, ns = 2 * world, 12, 12
    c, rows, cols, vals, h = random_sparse_inequality_lps(
        Bs, ms, ns, density=0.3, seed=8)
    c, vals, h = (torch.as_tensor(a) for a in (c, vals, h))
    res = _solve_sharded(
        mesh, lambda c, vals, h: ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, (ms, ns), IPMConfig(eps_rel=1e-3)),
        c, vals, h)
    n_ipm = _n_optimal(res.status)
    _check(n_ipm == Bs, f"sparse-IPM DP dryrun: {n_ipm}/{Bs} optimal")
    lb = torch.zeros((Bs, ns))
    ub = torch.full((Bs, ns), float("inf"))
    state = _solve_sharded(
        mesh, lambda c, vals, h, lb, ub: pdhg_solve_batch_sparse(
            c, rows, cols, vals, h, 0, lb, ub, (ms, ns), maxiters=50_000,
            cfg=PDHGConfig(eps_rel=1e-4)),
        c, vals, h, lb, ub)
    n_pdhg = _n_optimal(state.status)
    _check(n_pdhg == Bs, f"sparse-PDHG DP dryrun: {n_pdhg}/{Bs} optimal")
    return {"leg": "sparse_dp", "lanes": Bs, "ipm_optimal": n_ipm,
            "pdhg_optimal": n_pdhg}


def _worker(rank: int, world: int, init: str, device: str,
            backend: str) -> None:
    """One rank of :func:`dryrun`: every leg, rank 0 printing a JSON line
    for each."""
    import torch.distributed as dist

    from . import distributed
    from .mesh import make_batch_mesh

    torch.set_num_threads(1)
    distributed.initialize(init, world, rank, device=device, backend=backend)
    try:
        reports = [_leg_dp(world), _leg_tp(world), _leg_dp_tp(world)]
        mesh = make_batch_mesh()
        for leg in (_leg_pdhg, _leg_ipm, _leg_exact, _leg_bounded,
                    _leg_sparse):
            reports.append(leg(world, mesh))
        dist.barrier()
        if rank == 0:
            for rep in reports:
                print(json.dumps(rep), flush=True)
    finally:
        distributed.shutdown()


def spawn_ranks(cmds, timeout_s: float, env=None) -> list:
    """Run one process a command of ``cmds`` (the ranks of a group, or of
    several groups at once) from the repository's root, with this
    repository on ``PYTHONPATH`` and one OpenMP thread each; return
    ``[(exit code, output)]`` in their order.

    Polls until every process has exited, one has failed or ``timeout_s``
    has passed, then kills whatever still runs (a rank whose peer died
    waits in its collective forever): a killed rank's code is negative.
    No process outlives the call."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    logs = [tempfile.TemporaryFile("w+") for _ in cmds]
    try:
        procs = []
        try:
            for cmd, log in zip(cmds, logs):
                procs.append(subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, cwd=_REPO,
                    env=env))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                if (None not in codes or any(codes)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for p, log in zip(procs, logs):
            log.seek(0)
            out.append((p.returncode, log.read()))
        return out
    finally:
        for log in logs:
            log.close()


def rank_tails(ranks, chars: int = 3000) -> str:
    """The end of each rank's output with its exit code, for an error."""
    return "\n".join(f"--- rank {r} (exit {code}) ---\n{out[-chars:]}"
                     for r, (code, out) in enumerate(ranks))


def dryrun(n_procs: int, device="cuda", timeout_s: float = 600.0) -> list:
    """Run every leg once over ``n_procs`` spawned ranks on ``device``;
    return rank 0's reports (one dict a leg).

    On a card the ranks use NCCL where each has a card of its own and gloo
    where they share one.  Raises ``RuntimeError`` with the ranks' output
    if a rank fails or the time limit passes; every rank is stopped
    before it returns."""
    from ..ipm_sparse import resolve_device

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and n_procs <= torch.cuda.device_count():
        backend = "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ranks = spawn_ranks(
            [[sys.executable, "-m", "linprog_tpu_torch.parallel.dryrun",
              "--worker", str(r), str(n_procs), init, dev.type, backend]
             for r in range(n_procs)], timeout_s)
    if any(code for code, _ in ranks):
        raise RuntimeError(f"dryrun({n_procs}, {dev.type!r}) failed:\n"
                           + rank_tails(ranks))
    return [json.loads(line) for line in ranks[0][1].splitlines()
            if line.startswith("{")]


def _main(argv) -> None:
    if argv[:1] == ["--worker"]:
        rank, world, init, device, backend = argv[1:6]
        _worker(int(rank), int(world), init, device, backend)
        return
    n = int(argv[0]) if argv and not argv[0].startswith("-") else 2
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    fn, args = entry(device)
    out = fn(*args)
    print("entry() ok:", [tuple(o.shape) for o in out], flush=True)
    for rep in dryrun(n, device):
        print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    _main(sys.argv[1:])
