"""The double-word arithmetic of :mod:`linprog_tpu_torch.refine` in one
launch a call (``csrc/dd_residual.cu``).

Replaces no TPU kernel.  The plain version is :mod:`refine`'s own eager
chain, :func:`refine._dd_chunk_products` then
:func:`refine._kahan_sum_chunks`: ~600 launches for one residual at
``[1024, 256, 256]``, each a strided pass over ``M`` or a 1 MB partial, most
of them paced by the host.  Every step of that chain is an IEEE f32 add,
subtract or multiply, so an output is a fixed sequence of roundings; the
kernel runs the same sequence per output with no FMA contraction, and its
outputs equal the plain version's in every bit.

* :func:`chunk_products_sum` -- ``y @ M`` (``bvec`` None) or the residual
  ``bvec - y @ M``: the split products and TwoSum chain per chunk of
  ``chunk`` rows (padded with zero rows), then the compensated sum over
  ``[s, e]`` or ``[bvec, -s, -e]``.  ``M`` is read once through its
  strides, so the transposed view that :func:`refine.dd_residual` passes
  needs no copy.
* :func:`kahan_sum` -- :func:`refine._kahan_sum_chunks` alone over
  ``P[B, K, n]`` (what :func:`refine.dd_rowmat` hands it after its four
  einsums).

Each launch is counted in :data:`launches`, which a caller reads before
and after its work (:mod:`refine`'s polish notes the difference on its
span as ``dd_launches``).
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # CUDA launches of either entry point


def scratch_floats(B: int, m: int, n: int, chunk: int = 8) -> int:
    """Floats of the scratch buffer :func:`chunk_products_sum` needs at
    this shape: 0 where the chunks' ``(s, e)`` pairs fit in shared memory
    beside the tile (the library sizes both against the device's limit)."""
    need = _build.library().lp_dd_rowmat_scratch_floats(B, m, n, chunk)
    if need < 0:
        _build.check(-need, "chunk_products_sum shared-memory plan")
    return need


def _count():
    global launches
    launches += 1


def _check(what, dev, shapes) -> None:
    """Raise unless every ``name: (tensor, shape)`` is float32 of that
    shape on the CUDA device ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel needs a CUDA tensor, got {dev}")
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected float32")
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def chunk_products_sum(bvec, y, M, chunk: int = 8):
    """``bvec - y @ M`` in double-word arithmetic, or ``y @ M`` where
    ``bvec`` is None: ``y[B, m]``, ``M[B, m, n]``, ``bvec[B, n]``, float32
    on one CUDA device, any strides.  Returns a new contiguous ``[B, n]``,
    bit for bit what :func:`refine.dd_residual_rowmat` /
    :func:`refine.dd_rowmat_dd` compute in plain PyTorch."""
    B, m, n = M.shape
    dev = M.device
    shapes = {"M": (M, (B, m, n)), "y": (y, (B, m))}
    if bvec is not None:
        shapes["bvec"] = (bvec, (B, n))
    _check("chunk_products_sum", dev, shapes)
    if bvec is None and m == 0:
        raise ValueError("chunk_products_sum: y @ M needs at least one row")
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out
    need = scratch_floats(B, m, n, chunk)
    scratch = (torch.empty((need,), dtype=torch.float32, device=dev)
               if need else None)
    bp, sbb, sbj = ((0, 0, 0) if bvec is None
                    else (bvec.data_ptr(), *bvec.stride()))
    code = _build.library().lp_dd_rowmat(
        bp, sbb, sbj, y.data_ptr(), *y.stride(), M.data_ptr(), *M.stride(),
        out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        B, m, n, chunk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "chunk_products_sum launch")
    _count()
    return out


def kahan_sum(P):
    """:func:`refine._kahan_sum_chunks` of ``P[B, K, n]`` (float32 on a
    CUDA device, any strides, ``K >= 1``) -> a new contiguous ``[B, n]``,
    bit for bit."""
    B, K, n = P.shape
    dev = P.device
    _check("kahan_sum", dev, {"P": (P, (B, K, n))})
    if K == 0:
        raise ValueError("kahan_sum: P has no partials to sum")
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out
    code = _build.library().lp_dd_kahan_sum(
        P.data_ptr(), *P.stride(), out.data_ptr(), B, K, n,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "kahan_sum launch")
    _count()
    return out
