"""The port's MPS reader and writer against the reference's, on every
fixture of ``tests/test_mps_io.py``.

Both packages parse with the same C++ source, ``native/mps_reader.cpp``.
The reference here is handed the library the port built (in
``build/linprog_tpu_torch/``), so that this file never runs
``make -C native``: ``tests/test_mps_io.py`` may build that library in
another worker at the same moment."""

import contextlib
import textwrap

import numpy as np
import pytest

import linprog_tpu.io.mps as jmps

from linprog_tpu_torch import SimplexSolver
from linprog_tpu_torch.io import mps as tmps
from linprog_tpu_torch.io import mps_to_solver_inputs, read_mps, write_mps

FIXTURES = {
    "simple": """\
        * sample LP:
        *   min -x - 2y  s.t.  x + y <= 4,  y <= 2,  x + 2y >= 1,  x3 fixed
        NAME          SAMPLE
        ROWS
         N  COST
         L  CAP
         L  YLIM
         G  MIN1
         E  FIX3
        COLUMNS
            X         COST      -1.0       CAP        1.0
            X         MIN1       1.0
            Y         COST      -2.0       CAP        1.0
            Y         YLIM       1.0       MIN1       2.0
            Z         FIX3       1.0
        RHS
            RHS       CAP        4.0       YLIM       2.0
            RHS       MIN1       1.0      FIX3        1.5
        BOUNDS
         UP BND       X          3.0
        ENDATA
        """,
    "objsense_max": """\
        NAME MAXLP
        OBJSENSE
            MAX
        ROWS
         N  OBJ
         L  R1
        COLUMNS
            X   OBJ   1.0   R1   1.0
        RHS
            RHS R1    5.0
        ENDATA
        """,
    "ranges": """\
        NAME RANGED
        ROWS
         N  OBJ
         L  R1
         G  R2
        COLUMNS
            X   OBJ   -1.0   R1   1.0
            X   R2    1.0
            Y   OBJ   -1.0   R1   1.0
        RHS
            RHS R1    8.0    R2   1.0
        RANGES
            RNG R1    3.0
        ENDATA
        """,
    "ranged_e_row": """\
        NAME RANGEDE
        ROWS
         N  OBJ
         E  R1
        COLUMNS
            X   OBJ   -1.0   R1   1.0
        RHS
            RHS R1    2.0
        RANGES
            RNG R1    3.0
        ENDATA
        """,
    "ranged_e_row_negative": """\
        NAME RANGEDEN
        ROWS
         N  OBJ
         E  R1
        COLUMNS
            X   OBJ   1.0   R1   1.0
        RHS
            RHS R1    4.0
        RANGES
            RNG R1    -3.0
        ENDATA
        """,
    "integer_markers": """\
        NAME INTLP
        ROWS
         N  OBJ
         L  R1
        COLUMNS
            M1  'MARKER'  'INTORG'
            X   OBJ   -1.0   R1   1.0
            M2  'MARKER'  'INTEND'
        RHS
            RHS R1    5.0
        ENDATA
        """,
    "unknown_range_row": """\
        NAME ODD
        ROWS
         N  OBJ
         L  R1
        COLUMNS
            X   OBJ   1.0   R1   1.0
        RHS
            RHS R1    5.0
        RANGES
            RNG NOSUCH 1.0
        ENDATA
        """,
}

# the optimum of each fixture: (x of the first column, cost), from the
# fixture's own test in tests/test_mps_io.py
OPTIMA = {"objsense_max": (5.0, -5.0), "ranges": (None, -8.0),
          "ranged_e_row": (5.0, -5.0), "ranged_e_row_negative": (1.0, 1.0),
          "integer_markers": (5.0, -5.0)}


@pytest.fixture()
def reference_reader(monkeypatch):
    """The reference's ``read_mps`` on the library the port built."""
    monkeypatch.setattr(jmps, "_lib", tmps._load())
    return jmps.read_mps


def _write(tmp_path, name, text):
    p = tmp_path / f"{name}.mps"
    p.write_text(textwrap.dedent(text))
    return str(p)


def _read_both(path, reference_reader):
    with _maybe_warns(path):
        got = read_mps(path)
    with _maybe_warns(path):
        want = reference_reader(path)
    return got, want


def _maybe_warns(path):
    if "int" in path.rsplit("/", 1)[-1]:
        return pytest.warns(UserWarning, match="LP relaxation")
    return contextlib.nullcontext()


def _same(got, want):
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_read_mps_matches_reference(name, tmp_path, reference_reader):
    path = _write(tmp_path, name, FIXTURES[name])
    got, want = _read_both(path, reference_reader)
    for field in ("name", "maximize", "row_names", "col_names",
                  "n_integer_sections"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("row_types", "A", "rhs", "ranges", "c", "lb", "ub"):
        _same(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_solver_inputs_match_reference(name, tmp_path, reference_reader):
    path = _write(tmp_path, name, FIXTURES[name])
    got, want = _read_both(path, reference_reader)
    for a, b in zip(mps_to_solver_inputs(got), jmps.mps_to_solver_inputs(want)):
        _same(a, b)


@pytest.mark.parametrize("name", sorted(OPTIMA))
def test_parsed_problem_solves(name, tmp_path):
    """The parsed fixtures through the port's ``SimplexSolver`` on the
    host: the optima of their tests in ``tests/test_mps_io.py``."""
    path = _write(tmp_path, name, FIXTURES[name])
    with _maybe_warns(path):
        prob = read_mps(path)
    c, A, b, G, h, lb, ub = mps_to_solver_inputs(prob)
    res = SimplexSolver(c, A=A, b=b, G=G, h=h, lb=lb, ub=ub,
                        device="cpu").solve()
    assert res.optimum
    x0, cost = OPTIMA[name]
    if x0 is not None:
        assert res.x[0] == pytest.approx(x0, abs=1e-5)
    assert res.cost == pytest.approx(cost, abs=1e-4)


def test_simple_fixture_matches_highs(tmp_path):
    from scipy.optimize import linprog

    prob = read_mps(_write(tmp_path, "simple", FIXTURES["simple"]))
    c, A, b, G, h, lb, ub = mps_to_solver_inputs(prob)
    res = SimplexSolver(c, A=A, b=b, G=G, h=h, lb=lb, ub=ub,
                        device="cpu").solve()
    ref = linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b, method="highs",
                  bounds=list(zip(lb, np.where(np.isinf(ub), None, ub))))
    assert ref.status == 0 and res.optimum
    assert res.cost == pytest.approx(ref.fun, abs=1e-5)


@pytest.mark.parametrize("body,match", [
    ("ROWS\n L  R1\nCOLUMNS\n    X  R1  notanumber\nENDATA\n", "parse"),
    ("ROWS\n Z  R1\nENDATA\n", "bad row type"),
    ("ROWS\n L  R1\nGARBAGE\nENDATA\n", "unknown section"),
])
def test_malformed_files_raise_the_references_message(body, match, tmp_path,
                                                      reference_reader):
    p = tmp_path / "bad.mps"
    p.write_text(body)
    with pytest.raises(ValueError, match=match) as got:
        read_mps(str(p))
    with pytest.raises(ValueError) as want:
        reference_reader(str(p))
    assert str(got.value) == str(want.value)


def test_corrupted_files_parse_or_fail_as_the_reference_does(
        tmp_path, reference_reader):
    """The corruption fuzz of ``tests/test_mps_io.py``: on every file both
    readers accept the same problem or raise the same message."""
    base = textwrap.dedent("""\
        NAME FUZZBASE
        ROWS
         N  OBJ
         L  R1
         G  R2
         E  R3
        COLUMNS
            X1  OBJ  1.0   R1  2.0
            X1  R2   1.0   R3  1.0
            X2  OBJ  -2.0  R1  1.0
            X2  R3   1.0
        RHS
            RHS R1  10.0  R2  1.0
            RHS R3  3.0
        RANGES
            RNG R1  4.0
        BOUNDS
         UP BND X1  8.0
         LO BND X2  0.5
        ENDATA
        """)
    rng = np.random.default_rng(0)
    lines = base.splitlines(keepends=True)
    outcomes = set()
    for trial in range(40):
        kind = trial % 5
        if kind == 0:
            text = base[:int(rng.integers(1, len(base)))]
        elif kind == 1:
            i = int(rng.integers(0, len(lines)))
            text = "".join(lines[:i] + lines[i + 1:])
        elif kind == 2:
            i = int(rng.integers(0, len(lines)))
            text = "".join(lines[:i] + [lines[i]] + lines[i:])
        elif kind == 3:
            toks = base.split(" ")
            j = int(rng.integers(0, len(toks)))
            toks[j] = "\x7f@!" if toks[j].strip() else toks[j]
            text = " ".join(toks)
        else:
            cut = int(rng.integers(0, len(base)))
            junk = bytes(rng.integers(33, 127, 12)).decode("ascii")
            text = base[:cut] + junk + base[cut:]
        p = tmp_path / f"fuzz{trial}.mps"
        p.write_text(text)
        results = []
        for reader in (read_mps, reference_reader):
            try:
                results.append(reader(str(p)))
            except ValueError as e:
                results.append(str(e))
        got, want = results
        if isinstance(want, str):
            assert got == want
            outcomes.add("rejected")
            continue
        for field in ("row_types", "A", "rhs", "ranges", "c", "lb", "ub"):
            _same(getattr(got, field), getattr(want, field))
        outcomes.add("parsed")
    assert outcomes == {"parsed", "rejected"}


def test_write_mps_round_trips(tmp_path):
    """An LP with every kind of bound (free, fixed, lower, upper, both)
    written and read back gives the arrays it was written from."""
    rng = np.random.default_rng(3)
    n = 6
    c = np.round(rng.normal(size=n), 6)
    A = np.round(rng.normal(size=(2, n)), 6)
    A[0, 1] = 0.0  # skipped in COLUMNS, read back as 0
    b = np.round(rng.normal(size=2), 6)
    G = np.round(rng.normal(size=(3, n)), 6)
    h = np.round(rng.uniform(1, 2, size=3), 6)
    lb = np.array([0.0, -np.inf, 1.5, -2.0, 0.25, 0.0])
    ub = np.array([np.inf, np.inf, 1.5, 4.0, np.inf, 3.0])
    path = str(tmp_path / "rt.mps")
    write_mps(path, c, A=A, b=b, G=G, h=h, lb=lb, ub=ub, name="ROUNDTRIP")
    prob = read_mps(path)
    assert prob.name == "ROUNDTRIP" and not prob.maximize
    c2, A2, b2, G2, h2, lb2, ub2 = mps_to_solver_inputs(prob)
    for got, want in ((c2, c), (A2, A), (b2, b), (G2, G), (h2, h),
                      (lb2, lb), (ub2, ub)):
        np.testing.assert_array_equal(got, want)


def test_write_mps_maximize_round_trips(tmp_path):
    path = str(tmp_path / "max.mps")
    write_mps(path, np.array([1.0, 2.0]), G=np.array([[1.0, 1.0]]),
              h=np.array([3.0]), maximize=True)
    prob = read_mps(path)
    assert prob.maximize
    c, A, b, G, h, lb, ub = mps_to_solver_inputs(prob)
    np.testing.assert_array_equal(c, [-1.0, -2.0])
    assert A is None and b is None


def test_reader_builds_beside_the_port(tmp_path):
    """The library is keyed by a hash of its source and flags under
    ``build/linprog_tpu_torch/``, not in ``native/``."""
    path = tmps.library_path()
    assert path.parent.parent.name == "linprog_tpu_torch"
    assert path.parent.parent.parent.name == "build"
    tmps._load()
    assert path.exists()
