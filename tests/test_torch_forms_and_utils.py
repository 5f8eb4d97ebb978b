"""linprog_tpu_torch's canonicalization and numeric utilities against the
reference's, on the cases of tests/test_forms_and_utils.py.

``forms`` is NumPy code in both packages: every output must be equal bit
for bit.  The utilities run on tensors in the port and on jax arrays in
the reference: the masked divisions equal bit for bit (one IEEE division),
the log-space bound within 1e-6 relative (``lgamma``, ``log`` and ``exp``
come from different libraries).  ``to_standard_form_batch`` and
``LinProgResult`` equal the reference's field for field.
"""

import dataclasses
from math import factorial

import numpy as np
import pytest
import torch

from linprog_tpu import forms as jforms
from linprog_tpu.generators import to_standard_form_batch as jax_to_standard
from linprog_tpu.results import LinProgResult as JaxLinProgResult
from linprog_tpu.utils import dual_simplex_div as jax_dual_div
from linprog_tpu.utils import get_bounds_on_bfs as jax_bounds
from linprog_tpu.utils import primal_simplex_div as jax_primal_div

from linprog_tpu_torch import LinProgResult, forms
from linprog_tpu_torch import status as st
from linprog_tpu_torch.generators import (
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu_torch.utils import (
    dual_simplex_div,
    get_bounds_on_bfs,
    primal_simplex_div,
)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


FORMS_CASES = {
    "preprocess_sign_fix": (
        "preprocess_problem",
        ([1, 2], [[1, 2], [-3, 4]], [-5, 6], np.float32), {}),
    "canonical_to_standard": (
        "canonical_to_standard", ([1.0], [[2.0], [3.0]], [4.0, 5.0]), {}),
    "bounds_to_rows_layout": (
        "bounds_to_rows", ([1.0, 1.0], [[1.0, 1.0]], [3.0]),
        dict(lb=[0.5, 0.0], ub=[np.inf, 2.0])),
    "bounds_to_rows_infinite_lb": (
        "bounds_to_rows", ([1.0], [[1.0]], [1.0]),
        dict(lb=[-np.inf], ub=[np.inf])),
    "bounds_to_rows_f64_negative_rhs": (
        "bounds_to_rows", ([1.0, -1.0], [[1.0, -2.0]], [-3.0]),
        dict(lb=[-1.5, 0.0], ub=[4.0, 2.0], dtype=np.float64)),
    "general_eq_only": (
        "general_to_standard", ([1.0, 2.0],),
        dict(A=[[1.0, 1.0]], b=[-2.0])),
    "general_ineq_only": (
        "general_to_standard", ([1.0, 2.0],),
        dict(G=[[1.0, -1.0], [2.0, 0.5]], h=[3.0, -1.0])),
    "general_both": (
        "general_to_standard", ([1.0, 2.0],),
        dict(A=[[1.0, 1.0]], b=[2.0], G=[[1.0, -1.0]], h=[-1.0],
             dtype=np.float64)),
    "pad_problem": (
        "pad_problem",
        (np.array([1.0, 2.0]), np.array([[1.0, 1.0]]), np.array([3.0]), 3, 6),
        {}),
}


@pytest.mark.parametrize("case", sorted(FORMS_CASES))
def test_forms_equal_reference_bit_for_bit(case):
    name, args, kw = FORMS_CASES[case]
    _same(getattr(forms, name)(*args, **kw), getattr(jforms, name)(*args, **kw))


def test_forms_known_layouts():
    """The reference test's own assertions, on the port."""
    c, A, b = forms.preprocess_problem([1, 2], [[1, 2], [-3, 4]], [-5, 6],
                                       np.float32)
    assert (b >= 0).all() and np.allclose(A[0], [-1, -2])
    assert np.allclose(b, [5, 6]) and A.dtype == np.float32
    c, A, b = forms.bounds_to_rows([1.0, 1.0], [[1.0, 1.0]], [3.0],
                                   lb=[0.5, 0.0], ub=[np.inf, 2.0])
    assert A.shape == (3, 4) and np.allclose(b, [3, 0.5, 2])
    assert A[1, 0] == 1 and A[1, 2] == -1 and A[2, 1] == 1 and A[2, 3] == 1
    _, A2, b2, row_mask, col_mask = forms.pad_problem(
        np.array([1.0, 2.0]), np.array([[1.0, 1.0]]), np.array([3.0]), 3, 6)
    assert A2.shape == (3, 6) and row_mask.sum() == 1 and col_mask.sum() == 2
    assert np.allclose(A2[1:, :2], 0) and np.allclose(b2[1:], 0)


@pytest.mark.parametrize("which", ["mismatch", "misspecified", "pad"])
def test_forms_errors_as_reference(which):
    for mod in (forms, jforms):
        with pytest.raises(ValueError):
            if which == "mismatch":
                mod.general_to_standard([1.0], A=[[1.0, 2.0]], b=[1.0])
            elif which == "misspecified":
                mod.general_to_standard([1.0])
            else:
                mod.pad_problem([1.0], [[1.0]], [1.0], 3, 2)


@pytest.mark.parametrize("pivot_tol", [0.0, 0.5])
def test_ratio_divisions_equal_reference(pivot_tol):
    n = np.array([1.0, 2.0, 3.0, -4.0], np.float32)
    d = np.array([2.0, -1.0, 0.0, 0.25], np.float32)
    out = primal_simplex_div(torch.tensor(n), torch.tensor(d), pivot_tol)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax_primal_div(n, d, pivot_tol)))
    out = dual_simplex_div(torch.tensor(n), torch.tensor(d), pivot_tol)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax_dual_div(n, d, pivot_tol)))
    if pivot_tol == 0.0:
        out = primal_simplex_div(n, d).numpy()  # arrays are accepted too
        assert out[0] == pytest.approx(0.5) and np.isinf(out[1:3]).all()
        out = dual_simplex_div(n, d).numpy()
        assert out[1] == pytest.approx(2.0) and np.isinf(out[[0, 2, 3]]).all()


@pytest.mark.parametrize("case", ["small", "large_m", "zero_rhs"])
def test_bfs_bound_matches_reference(case):
    """Within 1e-6 relative of the reference (f32)."""
    if case == "small":
        A = np.array([[2.0, 1.0], [1.0, 3.0]], np.float32)
        b = np.array([4.0, 5.0], np.float32)
    else:
        rng = np.random.default_rng(0)
        A = rng.normal(size=(256, 256)).astype(np.float32)
        b = rng.normal(size=256).astype(np.float32)
        if case == "zero_rhs":
            b = np.zeros_like(b)
    got = float(get_bounds_on_bfs(torch.tensor(A), torch.tensor(b)))
    want = float(jax_bounds(A, b))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    if case == "small":
        assert got == pytest.approx(factorial(2) * 3.0 * 5.0, rel=1e-4)
    if case == "large_m":
        assert got > 0  # capped, not overflowed
    if case == "zero_rhs":
        assert got == 0.0


def test_to_standard_form_batch_equals_reference():
    c, G, h = random_inequality_lps(4, 6, 5, seed=3)
    h[0, :2] *= -1  # rows that need the sign flip
    _same(to_standard_form_batch(c, G, h), jax_to_standard(c, G, h))
    assert (to_standard_form_batch(c, G, h)[2] >= 0).all()


def test_linprog_result_mirrors_reference():
    names = [f.name for f in dataclasses.fields(LinProgResult)]
    assert names == [f.name for f in dataclasses.fields(JaxLinProgResult)]
    kw = dict(x=np.ones(2), basis=None, cost=1.5, iters=3, optimum=False,
              status=st.PRIMAL_UNBOUNDED)
    mine, ref = LinProgResult(**kw), JaxLinProgResult(**kw)
    assert mine.status_name == ref.status_name == "PRIMAL_UNBOUNDED"
    assert mine.y is None and LinProgResult(
        x=np.ones(1), basis=None, cost=0.0, iters=0, optimum=True
    ).status == st.OPTIMAL
