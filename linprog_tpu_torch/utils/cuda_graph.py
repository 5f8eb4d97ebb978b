"""A chunk of small steps captured once as a CUDA graph and replayed.

Shared by the host loops that run a fixed number of steps between two
reads of a flag: PDHG's chunks of ``check_every`` steps
(:mod:`linprog_tpu_torch.pdhg`) and tensor parallelism's chunks of pivots
over NCCL (:mod:`linprog_tpu_torch.parallel.tp`).
"""

from __future__ import annotations

import torch


def graphed(chunk, state):
    """``chunk`` captured once as a CUDA graph over static copies of
    ``state``'s tensors (a NamedTuple); the returned function copies a
    state in, replays the graph and returns the graph's output tensors
    (valid until the next replay).  An eager PDHG step is ~15-25 small
    launches, and launched one by one the host's launch rate, not the
    device, set the step's time (chip_smoke.py phases 17-18 time both).
    The capture refuses only this thread's unsafe calls: a chunk with NCCL
    collectives (``parallel.tp``) has the process group's watchdog thread
    querying events meanwhile."""
    static_in = type(state)(*(t.clone() for t in state))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chunk(static_in)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        static_out = chunk(static_in)

    def replay(s):
        for dst, src in zip(static_in, s):
            dst.copy_(src)
        graph.replay()
        return static_out

    return replay
