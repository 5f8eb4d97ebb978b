"""Package-level checks of linprog_tpu_torch: it never imports JAX or the
reference package, the converters round-trip, and the kernel wrappers
refuse what their kernels do not take."""

import ast
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linprog_tpu import engine as jengine
from linprog_tpu.config import FAST_CONFIG as JAX_FAST_CONFIG
from linprog_tpu.config import SolverConfig as JaxSolverConfig
from linprog_tpu.engine_batched import _pallas_pack
from linprog_tpu.ipm import IPMConfig as JaxIPMConfig

import linprog_tpu_torch
from linprog_tpu_torch import FAST_CONFIG, IPMConfig, SolverConfig
from linprog_tpu_torch.convert import (
    config_from_reference,
    ipm_state_from_numpy,
    ipm_state_to_numpy,
    packed_from_numpy,
    packed_to_numpy,
    simplex_state_from_numpy,
    simplex_state_to_numpy,
)
from linprog_tpu_torch.engine_batched import run_batched
from linprog_tpu_torch.engine import make_state
from linprog_tpu_torch.ops.cholinv_kernel import panel_cholinv
from linprog_tpu_torch.ops.solve_kernel import SegmentState, solve_segment

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "linprog_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                 REPO / "tools" / "run_phases.py",
                                 REPO / "tools" / "run_calibrate.py",
                                 REPO / "tools" / "time_stream_plans.py",
                                 REPO / "tools" / "time_segment_plans.py",
                                 REPO / "tools" / "time_dd.py",
                                 REPO / "tools" / "time_lu.py",
                                 REPO / "tools" / "diag_m4096.py",
                                 REPO / "tools" / "diag_pdhg_m4096.py",
                                 REPO / "tools" / "diag_sparse_m2048.py",
                                 REPO / "tools" / "diag_general_batch.py",
                                 REPO / "tools" / "trace_check.py"]
    + sorted((REPO / "examples").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_reference_import(path):
    """The port (its subpackages ``parallel``, ``io`` and ``oracle``
    included, with its chip smoke, its tools and its examples) imports
    neither ``jax`` nor the reference package, at any depth of any
    function."""
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "linprog_tpu", "linprog"), (
            f"{path.name} imports {mod}"
        )


def test_config_from_reference():
    assert config_from_reference(dataclasses.asdict(JAX_FAST_CONFIG)) == FAST_CONFIG
    assert config_from_reference(
        dataclasses.asdict(JaxIPMConfig(eps_rel=1e-4))) == IPMConfig(eps_rel=1e-4)
    # the reference's default is its XLA path: the port's per-step loop
    assert config_from_reference(
        dataclasses.asdict(JaxSolverConfig())) == SolverConfig(kernels="torch")
    assert config_from_reference(dataclasses.asdict(
        JaxSolverConfig(kernels="pallas"))) == SolverConfig(kernels="cuda")
    # the per-lane engines and the per-step loop read the update rule
    assert config_from_reference(dataclasses.asdict(
        JaxSolverConfig(update="naive"))) == SolverConfig(kernels="torch",
                                                          update="naive")
    assert config_from_reference(dataclasses.asdict(
        JaxSolverConfig(kernels="pallas", update="naive"))).update == "naive"
    with pytest.raises(ValueError, match="update"):
        SolverConfig(update="lu")
    with pytest.raises(ValueError, match="kernels"):
        config_from_reference(dict(dataclasses.asdict(JaxSolverConfig()),
                                   kernels="triton"))
    # the reference's last modes carry over (they were refused before the
    # port ran them)
    assert config_from_reference(dataclasses.asdict(
        JAX_FAST_CONFIG.replace(split_pricing=True))) == FAST_CONFIG.replace(
            split_pricing=True)
    assert config_from_reference(dataclasses.asdict(
        JaxIPMConfig(gondzio=2))) == IPMConfig(gondzio=2)
    for name in ("pallas", "xla"):
        with pytest.raises(ValueError, match="kernels"):
            SolverConfig(kernels=name)
    assert SolverConfig().kernels == "cuda"
    assert SolverConfig(kernels="torch").kernels == "torch"
    # the working precision of the host-array entry points carries over
    assert SolverConfig().dtype == "float32"
    assert config_from_reference(dataclasses.asdict(
        JaxSolverConfig(dtype="float64"))).dtype == "float64"
    with pytest.raises(ValueError, match="dtype"):
        SolverConfig(dtype="bfloat16")


# a value other than the default for every field the reference accepts
_SOLVER_NONDEFAULT = dict(
    opt_tol=1e-5, feas_tol=1e-5, pivot_tol=1e-6, update="naive",
    pricing="dantzig", refactor_every=64, stall_limit=12,
    split_pricing=True, partial_pricing=True, unroll=2, packed_select=True,
    polish_pivots=4, compact_refactor=False, dtype="float64",
    kernels="pallas", refactor_method="ns", scaling=True)
_IPM_NONDEFAULT = dict(eps_rel=1e-6, maxiters=40, frac=0.95, reg=1e-9,
                       cert_tol=1e-5, gondzio=2, newton_solver="minv",
                       dtype="float64")


@pytest.mark.parametrize("which", ["solver", "ipm"])
def test_config_from_reference_carries_every_field(which):
    """Every field of the reference's configs, each at a value other than
    its default, arrives with that value (``kernels="pallas"`` as
    ``"cuda"``); no field of either class is left out of the table."""
    ref_cls, table = ((JaxSolverConfig, _SOLVER_NONDEFAULT)
                      if which == "solver" else
                      (JaxIPMConfig, _IPM_NONDEFAULT))
    fields = {f.name for f in dataclasses.fields(ref_cls)}
    assert set(table) == fields
    default = dataclasses.asdict(ref_cls())
    assert all(table[k] != default[k] for k in fields)
    got = config_from_reference(dataclasses.asdict(ref_cls(**table)))
    want = dict(table, kernels="cuda") if which == "solver" else table
    assert {k: getattr(got, k) for k in fields} == want
    for key, bad in (("refactor_method", "lu"), ("newton_solver", "chol")):
        if key in fields:
            with pytest.raises(ValueError, match=key.split("_")[0]):
                type(got)(**{key: bad})


def test_package_exports_and_kernel_sources():
    """The public surface, and a CUDA source with a C entry point for each
    of the six kernels (two for kernel 1: its cluster-resident and its
    streaming branch)."""
    for name in ("solve_batch_exact", "solve_batch_two_phase",
                 "solve_batch_bounded", "certify_vertex_batch",
                 "ipm_solve_batch_canonical", "SolverConfig", "tuned_config",
                 "solve_batch_auto", "recover_stragglers_pooled",
                 "reoptimize_ipm_batch_canonical"):
        assert name in linprog_tpu_torch.__all__
        assert callable(getattr(linprog_tpu_torch, name))
    entry_points = {
        "solve_segment.cu": "lp_solve_segment_cluster",
        "solve_segment_large.cu": "lp_solve_segment_large",
        "panel_cholinv.cu": "lp_panel_cholinv",
        "solve_segment_stream.cu": "lp_solve_segment_stream",
        "solve_bounded_segment.cu": "lp_solve_bounded_stream",
        "price_entering.cu": "lp_price_entering",
        "ratio_eta_pivot.cu": "lp_ratio_eta_pivot",
    }
    build_src = (PKG / "ops" / "_build.py").read_text()
    for source, entry in entry_points.items():
        text = (PKG / "csrc" / source).read_text()
        assert f'extern "C" int {entry}(' in text, source
        # the kernel is in the source or in a header of its own it includes
        own = "".join((PKG / "csrc" / h).read_text() for h in re.findall(
            r'#include "(%s\.cuh)"' % source[:-3], text))
        assert "__global__" in text + own and "Replaces linprog_tpu/ops/" in text
        assert f"lib.{entry}.argtypes" in build_src
    from linprog_tpu_torch.ops import (
        bounded_kernel,
        cholinv_kernel,
        solve_kernel,
        step_kernels,
        stream_kernel,
    )
    for mod in (bounded_kernel, cholinv_kernel, solve_kernel, stream_kernel):
        assert isinstance(mod.launches, int)
    assert set(step_kernels.launches) == {"price_entering", "ratio_eta_pivot"}


def test_bounded_packed_layout_carries_across():
    """The reference bounded kernel's [B, 1, .] rows and f32 state codes
    become the port's flat rows and int8 codes."""
    from linprog_tpu_torch.convert import bounded_packed_from_numpy

    rng = np.random.default_rng(2)
    B, m, n = 3, 4, 9
    packed = (rng.normal(size=(B, m, m)).astype(np.float32),
              rng.random((B, 1, m)).astype(np.float32),
              rng.normal(size=(B, 1, m)).astype(np.float32),
              rng.integers(0, n, (B, 1, m)).astype(np.int32),
              rng.integers(0, 3, (B, 1, n)).astype(np.float32),
              np.zeros((B, 1, m), np.float32),
              np.full((B, 1, m), np.inf, np.float32),
              np.arange(B, dtype=np.int32).reshape(B, 1, 1),
              np.array([0, 1, 3], np.int32).reshape(B, 1, 1))
    seg = bounded_packed_from_numpy(packed)
    assert seg.vstate.dtype == torch.int8 and seg.basis.dtype == torch.int32
    for got, want in zip(seg, packed):
        np.testing.assert_array_equal(got.numpy().reshape(want.shape)
                                      .astype(want.dtype), want)
    assert seg.iters.shape == seg.status.shape == (B,)


def test_simplex_and_ipm_state_round_trip():
    rng = np.random.default_rng(0)
    B, m = 3, 4
    simplex = {
        "basis": rng.integers(0, 9, (B, m)).astype(np.int32),
        "inv_B": rng.normal(size=(B, m, m)).astype(np.float32),
        "bfs": rng.normal(size=(B, m)).astype(np.float32),
        "iters": np.arange(B, dtype=np.int32),
        "status": np.array([0, 1, 9], np.int32),
    }
    back = simplex_state_to_numpy(simplex_state_from_numpy(simplex))
    for k, v in simplex.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    ipm = {"x": rng.random((B, 6)), "y": rng.normal(size=(B, m)),
           "s": rng.random((B, 6)), "iters": np.ones(B, np.int32),
           "status": np.zeros(B, np.int32)}
    back = ipm_state_to_numpy(ipm_state_from_numpy(ipm, dtype=torch.float64))
    for k, v in ipm.items():
        np.testing.assert_array_equal(back[k], v)


def test_batch_result_round_trip():
    """A reference ``BatchResult`` (a NamedTuple or a dict of arrays) comes
    across with the port's dtypes; a missing ``y`` stays None."""
    from linprog_tpu.results import BatchResult as JaxBatchResult

    from linprog_tpu_torch.convert import (
        batch_result_from_numpy,
        batch_result_to_numpy,
    )

    rng = np.random.default_rng(4)
    fields = {"x": rng.random((3, 5)).astype(np.float32),
              "basis": rng.integers(0, 5, (3, 2)).astype(np.int32),
              "cost": rng.normal(size=3).astype(np.float32),
              "iters": np.arange(3, dtype=np.int32),
              "status": np.array([1, 2, 9], np.int32),
              "y": rng.normal(size=(3, 2)).astype(np.float32)}
    jres = JaxBatchResult(**{k: jnp.asarray(v) for k, v in fields.items()})
    res = batch_result_from_numpy(jres)
    assert res.basis.dtype == torch.int32 and res.x.dtype == torch.float32
    back = batch_result_to_numpy(res)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    assert bool(res.optimum[0]) and not bool(res.optimum[1])
    no_y = batch_result_from_numpy(dict(fields, y=None), dtype=torch.float64)
    assert no_y.y is None and no_y.cost.dtype == torch.float64
    assert batch_result_to_numpy(no_y)["y"] is None


def test_packed_layout_round_trip():
    """The reference kernel's packed layout survives the trip to torch
    and back, and matches the port's own packing of the same state."""
    from linprog_tpu_torch.engine_batched import _segment_pack

    rng = np.random.default_rng(1)
    B, m, n = 3, 4, 7
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    c = rng.normal(size=(B, n)).astype(np.float32)
    basis = np.stack([rng.permutation(n)[:m] for _ in range(B)]).astype(np.int32)
    allowed = np.arange(n) < 6
    jstate = jengine.SimplexState(
        basis=jnp.asarray(basis),
        inv_B=jnp.asarray(rng.normal(size=(B, m, m)).astype(np.float32)),
        bfs=jnp.asarray(rng.random((B, m)).astype(np.float32)),
        iters=jnp.asarray([0, 3, 5], jnp.int32),
        status=jnp.asarray([0, 0, 1], jnp.int32),
    )
    ref = [np.asarray(a) for a in _pallas_pack(jnp.asarray(c), jnp.asarray(A),
                                                jstate, jnp.asarray(allowed))]
    c_t, apen_t, seg = packed_from_numpy(ref)
    back = packed_to_numpy(c_t, apen_t, seg)
    for want, got in zip(ref, back):
        np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))

    state = simplex_state_from_numpy(jstate._asdict())
    apen, own = _segment_pack(torch.tensor(c), torch.tensor(A), state,
                              torch.tensor(allowed))
    np.testing.assert_array_equal(apen.numpy(), apen_t.numpy())
    for a, b in zip(own, seg):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _segment_args(B=2, m=3, n=5):
    A = torch.zeros((B, m, n))
    c = torch.zeros((B, n))
    state = SegmentState(
        invBT=torch.eye(m).expand(B, m, m).clone(),
        bfs=torch.ones((B, m)), cB=torch.zeros((B, m)),
        basis=torch.zeros((B, m), dtype=torch.int32),
        pen=torch.zeros((B, n)), gamma=torch.ones((B, n)),
        iters=torch.zeros(B, dtype=torch.int32),
        status=torch.zeros(B, dtype=torch.int32),
    )
    return A, c, c.clone(), state


def test_solve_segment_wrapper_validates():
    kw = dict(seg_len=1, pricing=1, opt_tol=1e-6, pivot_tol=1e-7)
    A, c, apen, state = _segment_args()
    with pytest.raises(TypeError, match="A is torch.float64"):
        solve_segment(A.double(), c, apen, 5, state, **kw)
    with pytest.raises(TypeError, match="basis"):
        solve_segment(A, c, apen, 5, state._replace(basis=state.basis.long()), **kw)
    with pytest.raises(ValueError, match="c has shape"):
        solve_segment(A, c[:, :4], apen, 5, state, **kw)
    with pytest.raises(ValueError, match="invBT has shape"):
        solve_segment(A, c, apen, 5, state._replace(invBT=state.invBT[:, :2]), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bad = torch.ones((2, 6))[:, ::2]
        solve_segment(A, c, apen, 5, state._replace(bfs=bad), **kw)


def test_panel_cholinv_wrapper_validates():
    with pytest.raises(TypeError):
        panel_cholinv(torch.eye(4, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        panel_cholinv(torch.eye(65)[None])
    with pytest.raises(ValueError):
        panel_cholinv(torch.zeros((2, 4, 5)))
    with pytest.raises(ValueError, match="contiguous"):
        panel_cholinv(torch.eye(4).expand(2, 4, 4))


def test_large_m_is_not_ported_yet(monkeypatch):
    """m >= 3072 is in the port now (the name dates from when it raised):
    the exact router takes the reference's blocked-regime cleanup settings
    there, and a dual-mode ``run_batched`` at a blocked-factor shape runs
    the streaming kernel unblocked, primal mode blocked.  The route is
    recorded, not run: zero-stride tensors, nothing computed."""
    import linprog_tpu_torch.engine_batched as teb
    from linprog_tpu_torch.engine import SimplexState
    from linprog_tpu_torch.engine_batched import _stream_variant

    cfg, budget = linprog_tpu_torch.exact_cleanup_config(3072)
    assert (cfg.refactor_every, cfg.unroll, cfg.polish_pivots, budget) == (
        384, 1, 4, 2048)
    cfg2048, _ = linprog_tpu_torch.exact_cleanup_config(2048)
    assert cfg2048.refactor_every == 128

    m, n = 3072, 9216
    assert _stream_variant(m, n)[0] == "stream_blocked"
    routes = []

    def recording(c, A, b, state, allowed, maxiters, cfg, mode, variant,
                  n_blk):
        routes.append((mode, variant, n_blk, cfg.packed_select))
        return state

    monkeypatch.setattr(teb, "run_batched_stream", recording)
    zero = torch.zeros(())
    state = SimplexState(basis=torch.zeros((), dtype=torch.int32).expand(1, m),
                         inv_B=zero.expand(1, m, m), bfs=zero.expand(1, m),
                         iters=torch.zeros(1, dtype=torch.int32),
                         status=torch.zeros(1, dtype=torch.int32))
    for mode in ("dual", "primal"):
        run_batched(torch.zeros((1, n)), zero.expand(1, m, n),
                    zero.expand(1, m), state,
                    torch.ones(n, dtype=torch.bool), 10,
                    SolverConfig(packed_select=True), mode=mode)
    assert routes == [("dual", "stream", 256, False),
                      ("primal", "stream_blocked", 256, True)]


def test_singular_basis_is_a_status_not_an_exception():
    """A singular starting basis gives NUMERICAL_ERROR (torch.linalg.inv
    would raise)."""
    A = torch.tensor([[[1.0, 2.0, 0.0], [2.0, 4.0, 1.0]]])
    state = make_state(A, torch.ones((1, 2)), torch.tensor([[0, 1]]))
    assert int(state.status[0]) == linprog_tpu_torch.status.NUMERICAL_ERROR


def test_all_reference_names_are_exported():
    """``linprog_tpu_torch.__all__`` holds every name of the reference's
    ``__all__`` (read from its source, not imported) and the port's own."""
    tree = ast.parse((REPO / "linprog_tpu" / "__init__.py").read_text())
    ref_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and getattr(node.targets[0], "id", "") == "__all__")
    missing = set(ref_all) - set(linprog_tpu_torch.__all__)
    assert not missing, missing
    own = set(linprog_tpu_torch.__all__) - set(ref_all)
    assert own == {"DEFAULT_IPM_CONFIG", "certificate_summary",
                   "certify_vertex_batch", "exact_cleanup_config",
                   "solve_batch_bounded", "solve_batch_two_phase"}
    for name in linprog_tpu_torch.__all__:
        assert getattr(linprog_tpu_torch, name) is not None, name
    assert issubclass(linprog_tpu_torch.PrimalIsInfeasibleError,
                      linprog_tpu_torch.LinProgError)


def _host_entry_points():
    """Every entry point of the general-form surface that takes host
    arrays, called with its default device."""
    import numpy as np

    from linprog_tpu_torch import phase1, presolve_host
    from linprog_tpu_torch.batch import solve_batch_general

    c = np.array([1.0, 1.0, 0.0])
    A = np.array([[1.0, 2.0, 1.0]])
    b = np.array([2.0])
    basis = np.array([2])
    lb, ub = np.zeros(3), np.full(3, 4.0)
    lt = linprog_tpu_torch
    return {
        "SimplexSolver": lambda: lt.SimplexSolver(c, A=A, b=b),
        "PrimalNaiveSimplexSolver": lambda: lt.PrimalNaiveSimplexSolver(
            c, A, b, basis),
        "PrimalRevisedSimplexSolver": lambda: lt.PrimalRevisedSimplexSolver(
            c, A, b, basis),
        "DualNaiveSimplexSolver": lambda: lt.DualNaiveSimplexSolver(
            c, A, b, basis),
        "DualRevisedSimplexSolver": lambda: lt.DualRevisedSimplexSolver(
            c, A, b, basis),
        "BoundedVariablePrimalSimplexSolver":
            lambda: lt.BoundedVariablePrimalSimplexSolver(
                c, A, b, lb, ub, basis, [0, 1], []),
        "PhaseOneSimplexSolver": lambda: lt.PhaseOneSimplexSolver(c, A, b),
        "PrimalDualAlgorithm": lambda: lt.PrimalDualAlgorithm(c, A, b),
        "IPMSolver": lambda: lt.IPMSolver(c, A=A, b=b),
        "solve_phase1": lambda: phase1.solve_phase1(c, A, b),
        "solve_with_presolve": lambda: presolve_host.solve_with_presolve(
            c, A=A, b=b),
        "solve_batch_general": lambda: solve_batch_general(
            [{"c": c, "A": A, "b": b}]),
    }


@pytest.mark.parametrize("name", sorted(_host_entry_points()))
def test_host_entry_points_default_to_the_card(name, monkeypatch):
    """Without a card the default ``device="cuda"`` raises (nothing falls
    back to the CPU); ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _host_entry_points()[name]()


def _module_names(path):
    """The top-level ``def`` and ``class`` names of a module, and its
    ``__all__`` (None where it has none)."""
    tree = ast.parse(path.read_text())
    names = {node.name for node in tree.body
             if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
    exported = next((ast.literal_eval(node.value) for node in tree.body
                     if isinstance(node, ast.Assign)
                     and getattr(node.targets[0], "id", "") == "__all__"),
                    None)
    return names, exported


# Names of the reference that the port does not carry, by module: JAX's
# compiled wrappers, the Pallas kernels' bodies and their interpret
# switches (the kernels themselves are csrc/*.cu; ops/pallas_kernels.py's
# two are ops/step_kernels.py), and the orbax pair, which torch.save
# replaces.
_NOT_PORTED = {
    "bounded.py": {"run_bounded_batched_pallas", "run_bounded_jit"},
    "checkpoint.py": {"load_state_orbax", "save_state_orbax"},
    "engine.py": {"pivot_jit", "run_jit"},
    "engine_batched.py": {"_gather_cols", "_pallas_pack",
                          "run_batched_pallas"},
    "ipm.py": {"_ipm_canonical_jit", "_ipm_canonical_warm_jit",
               "_ipm_standard_warm_jit", "_use_panel_kernel"},
    "ipm_sparse.py": {"_ipm_sparse_jit"},
    "ops/bounded_kernel.py": {"_bounded_kernel", "_dotg",
                              "_interpret_default"},
    "ops/cholinv_kernel.py": {"_cholinv_kernel", "_interpret_default"},
    "ops/solve_kernel.py": {"_dotg", "_interpret_default",
                            "_solve_segment_kernel"},
    "ops/stream_kernel.py": {"_dotg", "_interpret_default", "_stream_kernel"},
    "pdhg.py": {"_solve_jit", "_sparse_batch_jit"},
    "primal_dual.py": {"_device_primal_dual"},
    "router.py": {"_xover_pallas_max_m"},
}


@pytest.mark.parametrize(
    "rel", sorted(str(p.relative_to(REPO / "linprog_tpu"))
                  for p in (REPO / "linprog_tpu").rglob("*.py")
                  if p.name != "pallas_kernels.py"))
def test_every_reference_module_has_its_counterpart(rel):
    """Each module of the reference has a module of the same path in the
    port, with the same ``__all__`` and every top-level name but those of
    ``_NOT_PORTED``."""
    ref_names, ref_all = _module_names(REPO / "linprog_tpu" / rel)
    port = PKG / rel
    assert port.exists(), rel
    names, exported = _module_names(port)
    assert ref_names - names == _NOT_PORTED.get(rel, set())
    # the packages' own __init__ files are held by
    # test_all_reference_names_are_exported; the port's ops/ exports its
    # per-step kernels from ops/step_kernels.py
    if ref_all is not None and rel not in ("__init__.py", "ops/__init__.py"):
        assert set(ref_all) <= set(exported or ())
