"""The benchmark's own instances, made on the device from a seed.

Frozen copies, so that a later change to the program's generators cannot
change what the benchmark measures:

* :func:`inequality_lps` -- ``linprog_tpu_torch/generators.py ::
  device_inequality_lps``;
* :func:`bounded_lps` -- ``linprog_tpu_torch/generators.py ::
  device_bounded_lps``;
* :func:`standard_form` -- ``linprog_tpu_torch/generators.py ::
  device_standard_form_batch``;
* :func:`bounded_slack_start` -- ``chip_smoke.py :: _bounded_start`` (the
  start a user passes, without the kernel-layout state).

Every instance is feasible and bounded by construction: ``h = G x0 + s0``
with ``x0, s0 >= 0`` and ``c = s - G' y0`` with ``y0, s >= 0``.
"""

from __future__ import annotations

import torch

BASIC = 2  # the bounded entry's variable state of a basic variable


def inequality_lps(gen: torch.Generator, batch: int, m: int, n: int,
                   device):
    """``(c[B, n], G[B, m, n], h[B, m])`` of ``min c'x, Gx <= h, x >= 0``."""
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    G = torch.randn((batch, m, n), **kw)
    x0 = torch.rand((batch, n), **kw)
    slack = torch.rand((batch, m), **kw)
    h = torch.einsum("bmn,bn->bm", G, x0) + slack
    y0 = torch.rand((batch, m), **kw)
    s = 0.1 + 0.9 * torch.rand((batch, n), **kw)
    c = s - torch.einsum("bmn,bm->bn", G, y0)
    return c, G, h


def bounded_lps(gen: torch.Generator, batch: int, m: int, n: int, device,
                ub_lo: float = 0.5, ub_hi: float = 2.0):
    """``(c[B, n+m], A[B, m, n+m], b[B, m], lb, ub)`` of
    ``min c'z, [G' | I] z = b, 0 <= x <= ub in [ub_lo, ub_hi), s >= 0``
    with ``G'`` row-sign-fixed so that ``b >= 0``: the all-slack basis with
    every structural variable at its lower bound is feasible."""
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    G = torch.randn((batch, m, n), **kw)
    x0 = torch.rand((batch, n), **kw)
    slack = torch.rand((batch, m), **kw)
    h = torch.einsum("bmn,bn->bm", G, x0) + slack
    Gf = torch.where((h < 0)[:, :, None], -G, G)
    b = torch.abs(h)
    eye = torch.eye(m, dtype=torch.float32, device=device).expand(batch, m, m)
    A = torch.cat([Gf, eye], dim=2)
    zeros = torch.zeros((batch, m), dtype=torch.float32, device=device)
    c = torch.cat([2.0 * torch.rand((batch, n), **kw) - 1.0, zeros], dim=1)
    ubx = ub_lo + (ub_hi - ub_lo) * torch.rand((batch, n), **kw)
    lb = torch.zeros((batch, n + m), dtype=torch.float32, device=device)
    ub = torch.cat([ubx, torch.full_like(zeros, float("inf"))], dim=1)
    return c, A, b, lb, ub


def standard_form(c, G, h):
    """``min c'x, Gx <= h`` -> ``[G | I] x = |h|``, the rows of ``h < 0``
    sign-flipped so that ``b >= 0``; columns keep their indices."""
    B, m, n = G.shape
    eye = torch.eye(m, dtype=G.dtype, device=G.device).expand(B, m, m)
    A = torch.cat([G, eye], dim=2)
    A = torch.where((h < 0)[:, :, None], -A, A)
    b = torch.abs(h)
    c_std = torch.cat([c, torch.zeros((B, m), dtype=G.dtype,
                                      device=G.device)], dim=1)
    return c_std, A, b


def bounded_slack_start(batch: int, m: int, n_struct: int, device):
    """The slack basis with every structural variable at its lower bound:
    ``(basis[B, m] int32, var_state[B, n_struct + m] int8)``."""
    ntot = n_struct + m
    basis = torch.arange(n_struct, ntot, dtype=torch.int32,
                         device=device).expand(batch, m).contiguous()
    vs = torch.zeros((batch, ntot), dtype=torch.int8, device=device)
    vs[:, n_struct:] = BASIC
    return basis, vs
