"""The batched LU's factorizations on ``torch.linalg`` (the program's
spans ``lu_library``: every ``engine.inv_or_nan`` / ``solve_or_nan`` call
that the batched LU kernel does not take, the crossover's own included),
ms a call over the window; None on a program without the span."""

from ._kernel3 import lu_library_ms


def read(run):
    return lu_library_ms(run)
