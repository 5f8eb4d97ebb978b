"""Batched inverse Cholesky factor of small SPD blocks: ``W = L^{-1}``.

Replaces the Pallas kernel ``linprog_tpu/ops/cholinv_kernel.py ::
panel_cholinv`` (body ``_cholinv_kernel``), the base case of the IPM's
block recursion (:func:`linprog_tpu_torch.ipm.block_cholesky_inverse`).

One elimination pass per matrix builds ``L^{-1}`` directly: for each
``k``, a pivot ``d = 1/sqrt(A[k, k])``, the symmetric rank-1 downdate of
``A`` by ``col = A[k, k:] * d``, and the same elimination step applied to
``R`` (which starts at ``I``).  A non-SPD input gives NaN or inf, never an
exception.

On the H100 (``csrc/panel_cholinv.cu``) a matrix is 4 KB at the IPM's
``[B, 32, 32]`` panels, so the kernel is bound neither by bytes nor by
FLOPs but by its ``mb`` dependent steps: by how fast one step's pivot and
column reach the threads that apply them.  For ``mb <= 32`` (every call of
the block recursion at its default ``blk=32``) one warp owns a matrix: lane
``j`` keeps column ``j`` of ``A`` and of ``R`` in registers, the pivot comes
by a warp shuffle, the column passes through 32 floats of shared memory,
and no block barrier is needed; four warps share a block, so
``[1024, 32, 32]`` is resident in one wave.  For ``32 < mb <= 64`` one block
owns a matrix in shared memory (two block barriers a step).  Both versions
take the pivot as ``1.0f / sqrtf(x)`` (two IEEE-rounded operations, not the
approximate ``rsqrtf``) and the CUDA build disables FMA contraction, so each
element sees the same operations in the same order as in the plain version.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # CUDA launches of the kernel (never the plain version)


def panel_cholinv_plain(M):
    """The plain PyTorch version: the same elimination loop, batched."""
    B, mb, _ = M.shape
    A = M.clone()
    R = torch.eye(mb, dtype=M.dtype, device=M.device).expand(B, mb, mb).clone()
    lane = torch.arange(mb, device=M.device)
    for k in range(mb):
        rowA = A[:, k, :]
        d = 1.0 / torch.sqrt(rowA[:, k:k + 1])
        col = torch.where(lane >= k, rowA * d, 0.0)
        A = A - col[:, :, None] * col[:, None, :]
        rowR = R[:, k, :] * d
        R[:, k, :] = rowR
        colb = torch.where(lane > k, col, 0.0)
        R = R - colb[:, :, None] * rowR[:, None, :]
    return R


def panel_cholinv(M):
    """``W = L^{-1}`` with ``M = L L'`` for ``M[B, mb, mb]`` f32, ``mb <= 64``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one warp per matrix up to ``mb = 32``, one block per matrix past it).
    """
    global launches
    if M.dim() != 3 or M.shape[1] != M.shape[2] or M.shape[1] > 64:
        raise ValueError(f"panel_cholinv needs [B, mb, mb] with mb <= 64, "
                         f"got {tuple(M.shape)}")
    if M.dtype != torch.float32:
        raise TypeError(f"panel_cholinv needs float32, got {M.dtype}")
    if not M.is_contiguous():
        raise ValueError("panel_cholinv needs a contiguous M")
    if M.device.type == "cpu":
        return panel_cholinv_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"panel_cholinv: unsupported device {M.device}")
    B, mb, _ = M.shape
    W = torch.empty_like(M)
    if B == 0:
        return W
    lib = _build.library()
    stream = torch.cuda.current_stream(M.device).cuda_stream
    code = lib.lp_panel_cholinv(M.data_ptr(), W.data_ptr(), B, mb, stream)
    _build.check(code, "panel_cholinv launch")
    launches += 1
    return W
