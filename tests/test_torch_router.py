"""linprog_tpu_torch's front door against the reference's: the routing
rule, ``solve_batch_auto`` through every ported family, ``auto_summary``,
the cleanup settings, the calibration table's resolution, and
``calibrate()``.

The cases are those of tests/test_router.py (its sparse half is in
tests/test_torch_sparse_router.py).  Both
packages get the same numpy instances; the reference's simplex phases run
on its Pallas kernel in interpret mode (``kernels="pallas"``), the port's on
the kernels' plain versions.  Statuses must agree lane for lane; costs
agree with the reference and with HiGHS within the family's class (1e-5
relative for the vertex families, 5e-3 for the raw interior family, as the
reference test allows).  ``calibrate()`` runs in the port only, at sizes
(8, 16) and 4 lanes on the CPU: its coverage is under test, not its values.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as scipy_linprog


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Same XLA CPU compile-count workaround as tests/test_solve_kernel.py."""
    jax.clear_caches()
    yield
    jax.clear_caches()


from linprog_tpu import calibration as jcal  # noqa: E402
from linprog_tpu import router as jrouter  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

import linprog_tpu_torch  # noqa: E402
from linprog_tpu_torch import calibration, router  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch import choose_family, solve_batch_auto, tuned_config  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402

SCHEMA = {"exact_simplex_max_m", "moderate_simplex_max_m", "pdhg_min_m",
          "exact_eps", "xover_pallas_max_m", "seg_by_m"}


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def _highs(c, G, h):
    return np.array([
        scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                      method="highs").fun for i in range(c.shape[0])])


@pytest.mark.parametrize("accuracy", [1e-6, 1e-5, 1e-4, 1e-3])
def test_routing_rule_matches_reference(accuracy):
    for m in (8, 128, 192, 193, 256, 512, 1024, 2048, 4095, 4096, 8192):
        assert choose_family(m, accuracy) == jrouter.choose_family(m, accuracy)
    if accuracy == 1e-6:
        assert choose_family(128, 1e-6) == "simplex"
        assert choose_family(256, 1e-6) == "ipm+crossover"
        assert choose_family(4096, 1e-6) == "ipm+crossover"
    if accuracy == 1e-3:
        assert choose_family(128, 1e-3) == "simplex"
        assert choose_family(256, 1e-3) == "ipm"
    if accuracy == 1e-4:
        assert choose_family(4096, 1e-4) == "pdhg"


@pytest.mark.parametrize("m", [64, 256, 512, 1024, 1536, 2048])
def test_cleanup_settings_match_reference(m):
    for mine, theirs in ((router.exact_cleanup_config,
                          jrouter.exact_cleanup_config),
                         (router.recovery_cleanup_config,
                          jrouter.recovery_cleanup_config)):
        for maxiters in (None, 77):
            cfg, budget = mine(m, maxiters)
            jcfg, jbudget = theirs(m, maxiters)
            assert budget == jbudget
            assert cfg == config_from_reference(dataclasses.asdict(jcfg))
    if m >= 1536:
        cfg, budget = router.recovery_cleanup_config(m)
        assert (cfg.refactor_every, cfg.unroll, budget) == (256, 2, 1024)


@pytest.mark.parametrize("prefer,tol", [
    ("simplex", 1e-5), ("ipm", 5e-3), ("ipm+crossover", 1e-5),
])
def test_every_ported_family_solves_correctly(prefer, tol):
    B, m, n = 6, 16, 24
    c, G, h = random_inequality_lps(B, m, n, seed=4)
    jcfg = cfg = None
    if prefer == "simplex":
        jcfg = JaxSolverConfig(kernels="pallas", polish_pivots=4,
                               pricing="dantzig", refactor_every=128)
        cfg = config_from_reference(dataclasses.asdict(jcfg))
    ref, jinfo = jrouter.solve_batch_auto(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), accuracy=1e-4,
        prefer=prefer, cfg=jcfg)
    res, info = solve_batch_auto(torch.tensor(c), torch.tensor(G),
                                 torch.tensor(h), accuracy=1e-4,
                                 prefer=prefer, cfg=cfg)
    assert info["family"] == prefer == jinfo["family"]
    assert set(info) == set(jinfo)
    for key in ("m", "n", "lanes", "accuracy", "eps_rel"):
        assert info.get(key) == jinfo.get(key)
    assert res.x.shape == (B, n)  # the structural columns, whatever family
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert (res.status == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < tol
    assert _rel(res.cost.numpy(), _highs(c, G, h)).max() < tol
    if prefer == "ipm+crossover":
        assert info["crossed"] >= jinfo["crossed"]
        assert (res.basis >= 0).all()


def test_ipm_family_recovers_its_stragglers():
    """``maxiters=4`` starves the IPM; the ``ipm`` family's backstop
    (``recover=True``) still returns exact vertices on every lane, as in
    the reference."""
    c, G, h = random_inequality_lps(8, 16, 16, seed=2)
    ref, _ = jrouter.solve_batch_auto(jnp.asarray(c), jnp.asarray(G),
                                      jnp.asarray(h), accuracy=1e-3,
                                      maxiters=4, prefer="ipm")
    res, info = solve_batch_auto(torch.tensor(c), torch.tensor(G),
                                 torch.tensor(h), accuracy=1e-3, maxiters=4,
                                 prefer="ipm")
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert (res.status == st.OPTIMAL).all() and (res.basis >= 0).all()
    assert info["eps_rel"] == 1e-3
    assert _rel(res.cost.numpy(), _highs(c, G, h)).max() < 1e-5


def test_auto_choice_and_summary():
    B, m, n = 4, 12, 18
    c, G, h = random_inequality_lps(B, m, n, seed=6)
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           refactor_every=128)
    ref, jinfo = jrouter.solve_batch_auto(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), accuracy=1e-6,
        cfg=jcfg)
    res, info = solve_batch_auto(
        torch.tensor(c), torch.tensor(G), torch.tensor(h), accuracy=1e-6,
        cfg=config_from_reference(dataclasses.asdict(jcfg)))
    assert info["family"] == "simplex" == jinfo["family"]  # m = 12, exact
    summ = router.auto_summary(res, info)
    assert summ == jrouter.auto_summary(ref, jinfo)
    assert summ["optimal"] == B and summ["iter_limit"] == 0
    assert _rel(res.cost.numpy(), _highs(c, G, h)).max() < 1e-4


def test_unknown_family_rejected():
    c, G, h = random_inequality_lps(2, 4, 6, seed=1)
    with pytest.raises(ValueError) as theirs:
        jrouter.solve_batch_auto(jnp.asarray(c), jnp.asarray(G),
                                 jnp.asarray(h), prefer="neural")
    with pytest.raises(ValueError) as mine:
        solve_batch_auto(torch.tensor(c), torch.tensor(G), torch.tensor(h),
                         prefer="neural")
    assert str(mine.value) == str(theirs.value)


def test_pdhg_family_is_not_ported_yet():
    """(Named for the raise it once pinned.)  The first-order family runs,
    asked for and where the table routes a loose request past
    ``pdhg_min_m``: the reference's info, its statuses, no basis, costs
    within the eps class of HiGHS."""
    c, G, h = random_inequality_lps(4, 6, 8, seed=1)
    ref, jinfo = jrouter.solve_batch_auto(jnp.asarray(c), jnp.asarray(G),
                                          jnp.asarray(h), accuracy=1e-4,
                                          prefer="pdhg")
    ct, Gt, ht = (torch.tensor(a) for a in (c, G, h))
    res, info = solve_batch_auto(ct, Gt, ht, accuracy=1e-4, prefer="pdhg")
    assert info == jinfo and info["family"] == "pdhg"
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert bool((res.status == st.OPTIMAL).all())
    assert bool((res.basis == -1).all()) and res.y is None
    assert res.x.shape == (4, 8)
    assert _rel(res.cost.numpy(), _highs(c, G, h)).max() < 1e-3
    try:
        calibration.set_table({"default": {"pdhg_min_m": 4}})
        assert choose_family(6, 1e-3) == "pdhg"
        routed, rinfo = solve_batch_auto(ct, Gt, ht, accuracy=1e-3)
        assert rinfo["family"] == "pdhg" and rinfo["eps_rel"] == 1e-3
        assert bool((routed.status == st.OPTIMAL).all())
        assert choose_family(6, 1e-6) != "pdhg"  # exact requests still route
    finally:
        calibration.reset_table()


def test_injected_calibration_table_flips_routing():
    fake = {"default": {
        "exact_simplex_max_m": 4, "moderate_simplex_max_m": 4,
        "pdhg_min_m": 64, "exact_eps": 1e-5, "xover_pallas_max_m": 512,
        "seg_by_m": [[0, 96]],
    }}
    assert choose_family(128, 1e-6) == "simplex"
    seg_base = tuned_config(128).refactor_every
    try:
        calibration.set_table(fake)
        jcal.set_table(fake)
        for m, acc in ((128, 1e-6), (128, 1e-3), (32, 1e-6), (4, 1e-3)):
            assert choose_family(m, acc) == jrouter.choose_family(m, acc)
        assert choose_family(128, 1e-6) == "ipm+crossover"
        assert choose_family(128, 1e-3) == "pdhg"
        assert tuned_config(128).refactor_every == 96
    finally:
        calibration.reset_table()
        jcal.reset_table()
    assert choose_family(128, 1e-6) == "simplex"
    assert tuned_config(128).refactor_every == seg_base


def test_partial_table_falls_back_key_by_key(monkeypatch):
    try:
        calibration.set_table({
            "default": dict(calibration.get_table("default")),
            "made-up-card": {"exact_simplex_max_m": 7, "_measured":
                             ["exact_simplex_max_m"]},
        })
        t = calibration.get_table("made-up-card")
        assert t["exact_simplex_max_m"] == 7
        assert t["pdhg_min_m"] == 4096 and t["seg_by_m"]  # inherited
        assert calibration.get_table()["exact_simplex_max_m"] == 192
        # a machine whose card bears that name resolves its entry
        monkeypatch.setattr(calibration, "_device_kind",
                            lambda device=None: "made-up-card")
        assert choose_family(8, 1e-6) == "ipm+crossover"
        assert calibration.seg_for_m(256) == 512
        # an injection without "default" still resolves every key
        calibration.set_table({"made-up-card": {"pdhg_min_m": 9}})
        t = calibration.get_table()
        assert t["pdhg_min_m"] == 9 and SCHEMA <= set(t)
    finally:
        calibration.reset_table()
    monkeypatch.undo()
    assert choose_family(8, 1e-6) == "simplex"


def test_cpu_resolves_the_default_entry_equal_to_the_reference():
    """No card here: the table is the packaged ``"default"`` entry, and
    that entry equals the reference's packaged one, so every CPU parity
    test routes and segments as the reference does.  A card's entry in the
    packaged file names what was measured on it."""
    assert calibration._device_kind() == "default"
    assert calibration._device_kind("cpu") == "default"
    with open(calibration._DATA_PATH) as f:
        mine = json.load(f)
    with open(jcal._DATA_PATH) as f:
        theirs = json.load(f)
    assert mine["default"] == theirs["default"]
    assert calibration.get_table() == mine["default"] == jcal.get_table("default")
    for m in (64, 256, 512, 1024, 2048, 4096):
        assert calibration.seg_for_m(m) == jcal.seg_for_m(m, "default")
    for kind, entry in mine.items():
        if kind in ("_comment", "default"):
            continue
        assert set(entry["_measured"]) <= SCHEMA - {"pdhg_min_m"}
        assert set(entry) - {"_measured", "_provenance"} == set(entry["_measured"])


def test_calibrate_measures_every_key_but_the_pdhg_leg(tmp_path):
    """(Named for the leg it once left out.)  Every key is measured, the
    PDHG boundary too, with the seconds behind each decision."""
    path = tmp_path / "table.json"
    out = calibration.calibrate(sizes=(8, 16), lanes=4, seg_grid=(8, 16),
                                device="cpu", save_path=str(path),
                                pdhg_sizes=(8, 16), pdhg_lanes=2)
    (kind, table), = out.items()
    assert kind == "default"  # the CPU has no card name
    assert SCHEMA <= set(table)
    assert set(table["_measured"]) == SCHEMA
    assert table["pdhg_min_m"] in (8, 16, 32)  # 32: PDHG never won
    pdhg_seconds = table["_provenance"]["pdhg_seconds"]
    assert set(pdhg_seconds) <= {"8", "16"} and "8" in pdhg_seconds
    for rec in pdhg_seconds.values():
        assert set(rec) == {"pdhg", "ipm"} and min(rec.values()) > 0
    assert [r[0] for r in table["seg_by_m"][:2]] == [8, 16]  # measured knees
    assert all(r[1] in (8, 16) for r in table["seg_by_m"][:2])
    assert table["seg_by_m"][-1][0] == 0  # the terminal row stays
    prov = table["_provenance"]
    assert (prov["lanes"], prov["sizes"], prov["seg_grid"],
            prov["pdhg_sizes"], prov["pdhg_lanes"]) == (
        4, [8, 16], [8, 16], [8, 16], 2)
    assert set(prov["seconds"]) == {"8", "16"}  # the times behind each key
    for rec in prov["seconds"].values():
        assert set(rec) == {"simplex_by_seg", "ipm", "exact", "kkt_floor"}
        assert set(rec["simplex_by_seg"]) == {8, 16}
        assert {"mega", "stream"} >= set(rec["exact"]) >= {"stream"}
    assert 1e-7 <= table["exact_eps"] <= 1e-2
    saved = json.loads(path.read_text())
    assert saved["default"]["_measured"] == table["_measured"]
    # the saved file injects as it is
    try:
        calibration.set_table(saved)
        assert calibration.get_table()["seg_by_m"] == table["seg_by_m"]
    finally:
        calibration.reset_table()


def test_package_exports_the_front_door():
    import linprog_tpu

    new = ["solve_batch_auto", "choose_family", "ipm_solve_batch_standard",
           "recover_stragglers_pooled", "reoptimize_ipm_batch_canonical",
           "warm_start_point", "LinProgResult"]
    for name in new:
        assert name in linprog_tpu.__all__  # the reference exports it
        assert name in linprog_tpu_torch.__all__
        assert getattr(linprog_tpu_torch, name) is not None
    assert sorted(linprog_tpu_torch.__all__) == linprog_tpu_torch.__all__
