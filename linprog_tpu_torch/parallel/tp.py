"""Tensor parallelism: one large LP column-sharded across a mesh
(counterpart of :mod:`linprog_tpu.parallel.tp`).

``c [n]`` and ``A [m, n]`` are sharded by columns over the mesh dimension
``"model"``; the O(m^2) basis state (``inv_B``, ``bfs``, ``basis``) is
replicated.  Per pivot:

* pricing ``r = c - (c_B inv_B) A`` is local to each rank (the O(mn) work
  on its n/D columns);
* the entering column: an ``all_gather`` of each rank's candidate (its
  smallest eligible reduced cost and the lowest index attaining it; Bland:
  its first eligible index), from which every rank picks the same column,
  the lowest global index among the smallest values, as one device would;
* the entering column itself, with its cost appended: the owner's entries,
  zeros elsewhere, ``all_reduce(SUM)`` (the cost keeps the replicated
  ``c[basis]`` up to date);
* the ratio test and the rank-1 eta update run replicated (no traffic).

The lanes of :func:`tp_solve_batch` run in lockstep, finished lanes masked.
The loop runs on the host: ranks take a chunk of 16 steps (on a card over
NCCL one captured CUDA graph), then agree with one ``all_reduce(MAX)``
whether any lane still runs.  A step of a finished lane
changes nothing and does not count in ``iters``, so ``iters`` is the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import status as st
from ..config import DEFAULT_CONFIG, SolverConfig
from ..engine import (
    SimplexState,
    _eta,
    _lane_pick,
    _rank1,
    _set_basis,
    in_basis_mask,
    inv_or_nan,
    tree_select,
)
from . import distributed
from .mesh import _all_gather, _batch_coords, _gather

_CHUNK = 16  # steps between two reads of the lanes' statuses


def make_model_mesh(n_devices=None, devices=None):
    """1-D mesh over dimension ``"model"``: every process, the first
    ``n_devices``, or the ranks in ``devices``."""
    if devices is None and n_devices is not None:
        devices = range(n_devices)
    return distributed.make_mesh(("model",), ranks=devices)


def _columns(t, rank: int, n_local: int):
    return t[..., rank * n_local:(rank + 1) * n_local]


def tp_solve(
    c,
    A,
    b,
    basis,
    maxiters,
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    axis: str = "model",
) -> SimplexState:
    """Primal revised simplex on one column-sharded LP.

    ``c [n]``, ``A [m, n]``, ``b [m]`` and the starting ``basis [m]`` are
    the global arrays (each rank takes its columns); ``n`` must divide by
    the mesh size.  Returns the replicated :class:`SimplexState` of the one
    lane (``basis [m]``, ``inv_B [m, m]``, ``bfs [m]``, scalar ``iters`` and
    ``status``) on this rank's device."""
    m, n = A.shape
    group, n_dev, rank = _batch_coords(mesh, axis)
    if n % n_dev != 0:
        raise ValueError(f"n={n} not divisible by mesh axis size {n_dev}")
    dev = distributed.solve_device(mesh)
    nl = n // n_dev
    state = _tp_local_solve(
        _columns(torch.as_tensor(c), rank, nl)[None].to(dev),
        _columns(torch.as_tensor(A), rank, nl)[None].to(dev),
        torch.as_tensor(b)[None].to(dev),
        torch.as_tensor(basis)[None].to(dev),
        maxiters, cfg, group, rank * nl, n)
    return SimplexState(*(t[0] for t in state))


def tp_solve_batch(
    c,
    A,
    b,
    basis,
    maxiters,
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    batch_axis: str = "batch",
    axis: str = "model",
) -> SimplexState:
    """DP x TP: a batch of column-sharded LPs on a 2-D ``(batch, model)``
    mesh (:func:`linprog_tpu_torch.parallel.distributed.global_2d_mesh`).

    ``c [B, n]``, ``A [B, m, n]``, ``b [B, m]``, ``basis [B, m]``: each
    model group takes its block of lanes (no traffic between groups) and
    each rank in it its columns; per pivot each lane pays the collectives
    of :func:`tp_solve` within its model group.  The lanes are gathered
    over ``batch_axis``: every rank returns the whole batch."""
    B, m, n = A.shape
    mgroup, n_model, mrank = _batch_coords(mesh, axis)
    bgroup, n_batch, brank = _batch_coords(mesh, batch_axis)
    if n % n_model != 0:
        raise ValueError(f"n={n} not divisible by model axis {n_model}")
    if B % n_batch != 0:
        raise ValueError(f"B={B} not divisible by batch axis {n_batch}")
    dev = distributed.solve_device(mesh)
    nl, per = n // n_model, B // n_batch

    def lanes(t):
        return torch.as_tensor(t)[brank * per:(brank + 1) * per].to(dev)

    state = _tp_local_solve(
        _columns(lanes(c), mrank, nl), _columns(lanes(A), mrank, nl),
        lanes(b), lanes(basis), maxiters, cfg, mgroup, mrank * nl, n)
    return _gather(state, bgroup)


def _all_reduce(t, op, group):
    """``t`` reduced over ``group`` (in place; through the host where a
    gloo group meets a CUDA tensor)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    dist.all_reduce(t, op=op, group=group)
    return t


class _TPState(NamedTuple):
    """The loop state of :func:`_tp_local_solve`: a :class:`SimplexState`
    and the replicated ``c[basis]``."""

    basis: torch.Tensor
    inv_B: torch.Tensor
    bfs: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor
    cB: torch.Tensor


def _tp_local_solve(c_l, A_l, b, basis0, maxiters, cfg: SolverConfig,
                    group, offset: int, n: int) -> SimplexState:
    """The per-rank solve shared by :func:`tp_solve` and
    :func:`tp_solve_batch`: ``c_l [L, nl]`` and ``A_l [L, m, nl]`` this
    rank's columns ``[offset, offset + nl)`` of ``L`` lanes, ``b [L, m]``
    and ``basis0 [L, m]`` replicated.  A pivot makes two collectives over
    ``group``: an ``all_gather`` of each rank's entering candidate (its
    smallest eligible reduced cost and the lowest index attaining it, or
    Bland's first eligible index), from which every rank picks the same
    entering column, and an ``all_reduce(SUM)`` of the owner's entering
    column with its cost appended (zeros from the other ranks), which
    also keeps ``c[basis]`` up to date.  On a card over NCCL each chunk of
    steps replays as one captured CUDA graph."""
    if cfg.pricing not in ("bland", "dantzig"):
        raise ValueError(f"tp_solve prices by 'bland' or 'dantzig', "
                         f"not {cfg.pricing!r}")
    L, m, nl = A_l.shape
    dev, dt = A_l.device, A_l.dtype
    D = dist.get_world_size(group)
    col_ids = offset + torch.arange(nl, device=dev)
    no_col = torch.tensor(float(n), dtype=torch.float64, device=dev)

    def owned(idx):
        """(this rank owns global column ``idx``, its local position)."""
        pos = idx.long() - offset
        return (pos >= 0) & (pos < nl), pos.clamp(0, nl - 1)

    def gather_candidates(cand):
        """``cand [L, 2]`` float64 (value, index) from every rank: ``[D, L,
        2]``."""
        return _all_gather(cand, group).view(D, L, 2)

    def enter_of(r_l, eligible):
        """The entering global column and whether any is eligible, the
        same on every rank: the lowest index among the smallest eligible
        reduced costs (dantzig) or the lowest eligible index (bland)."""
        idx = torch.where(eligible, col_ids, n)
        if cfg.pricing == "dantzig":
            val = torch.where(eligible, r_l, float("inf"))
            vmin = val.min(dim=1).values
            idx = torch.where(val == vmin[:, None], idx, n)
            cand = torch.stack([vmin.double(), idx.min(dim=1).values.double()],
                               dim=1)
            allc = gather_candidates(cand)
            gmin = allc[:, :, 0].min(dim=0).values
            at_min = allc[:, :, 0] == gmin[None]
            enter = torch.where(at_min, allc[:, :, 1], no_col).min(dim=0).values
            return enter.long(), torch.isfinite(gmin)
        cand = torch.stack([idx.min(dim=1).values.double()] * 2, dim=1)
        enter = gather_candidates(cand)[:, :, 1].min(dim=0).values
        return enter.long(), enter < n

    own0, pos0 = owned(basis0)
    cB0 = _all_reduce(torch.where(own0, torch.gather(c_l, 1, pos0), 0.0),
                      dist.ReduceOp.SUM, group)
    basis0 = basis0.to(torch.int32)
    inv_B0 = inv_or_nan(_replicated_basis_matrix(A_l, basis0, offset, nl,
                                                 group))
    state = _TPState(
        basis=basis0,
        inv_B=inv_B0,
        bfs=torch.einsum("bmk,bk->bm", inv_B0, b),
        iters=torch.zeros((L,), dtype=torch.int32, device=dev),
        status=torch.zeros((L,), dtype=torch.int32, device=dev),
        cB=cB0,
    )

    def step(s: _TPState) -> _TPState:
        live = (s.status == st.RUNNING) & (s.iters < maxiters)
        y = torch.bmm(s.cB[:, None, :], s.inv_B)[:, 0]
        r_l = c_l - torch.einsum("bm,bmn->bn", y, A_l)
        in_basis = in_basis_mask(s.basis, n)[:, offset:offset + nl]
        eligible = (r_l < -cfg.opt_tol) & ~in_basis
        enter, any_elig = enter_of(r_l, eligible)
        # the entering column and its cost, replicated: the owner's
        # entries, zeros elsewhere, summed
        own, pos = owned(enter)
        col = torch.gather(A_l, 2, pos[:, None, None].expand(L, m, 1))[:, :, 0]
        cost = torch.gather(c_l, 1, pos[:, None])
        ext = _all_reduce(torch.where(own[:, None],
                                      torch.cat([col, cost], dim=1), 0.0),
                          dist.ReduceOp.SUM, group)
        a_col, c_enter = ext[:, :m], ext[:, m]

        d = torch.einsum("bmk,bk->bm", s.inv_B, a_col)
        pos_d = d > cfg.pivot_tol
        unbounded = any_elig & ~pos_d.any(dim=1)
        # bfs clamped at 0 for pivot-path parity with engine.primal_step
        bfs_nn = torch.clamp_min(s.bfs, 0.0) + 0.0
        theta = torch.where(pos_d, bfs_nn / torch.where(pos_d, d, 1.0),
                            float("inf"))
        leave = theta.argmin(dim=1)
        do_pivot = any_elig & ~unbounded
        d_l = _lane_pick(d, leave)
        u = torch.where(do_pivot[:, None],
                        _eta(d, leave, torch.where(d_l == 0, 1.0, d_l)), 0.0)
        inv_B, bfs = _rank1(s.inv_B, s.bfs, u, leave)
        new = _TPState(
            basis=torch.where(do_pivot[:, None],
                              _set_basis(s.basis, leave, enter), s.basis),
            inv_B=inv_B,
            bfs=bfs,
            iters=s.iters + 1,
            status=torch.where(~any_elig, st.OPTIMAL,
                               torch.where(unbounded, st.PRIMAL_UNBOUNDED,
                                           st.RUNNING)).to(torch.int32),
            cB=torch.where(do_pivot[:, None],
                           s.cB.scatter(1, leave[:, None], c_enter[:, None]),
                           s.cB),
        )
        return tree_select(live, new, s)

    def chunk(s):
        for _ in range(_CHUNK):
            s = step(s)
        return s

    def running(s) -> bool:
        live = ((s.status == st.RUNNING) & (s.iters < maxiters)).any()
        flag = live.to(torch.int32).reshape(1)
        return bool(_all_reduce(flag, dist.ReduceOp.MAX, group)[0])

    if running(state):
        if dev.type == "cuda" and dist.get_backend(group) == "nccl":
            from ..utils.cuda_graph import graphed

            chunk = graphed(chunk, state)
        while True:
            state = chunk(state)
            if not running(state):
                break
    return SimplexState(*(t.clone() for t in state[:5]))


def _replicated_basis_matrix(A_l, basis, offset, n_local, group):
    """Replicated ``A[:, :, basis]`` from the column-sharded ``A_l`` (one
    sum)."""
    L, m, _ = A_l.shape
    pos = basis.long() - offset
    own = (pos >= 0) & (pos < n_local)
    cols = torch.gather(A_l, 2, pos.clamp(0, n_local - 1)[:, None, :]
                        .expand(L, m, basis.shape[1]))
    return _all_reduce(torch.where(own[:, None, :], cols, 0.0),
                       dist.ReduceOp.SUM, group)
