"""The choosers of ``linprog_tpu_torch.ops.plans`` on fake occupancy
queries, which wrapper takes which rule, and kernel 3's plans as
``streaming_plan`` at one CTA an SM.  No card is needed: a chooser is a
pure function of ``held(plan)``, and a wrapper's ``_choose_plan`` is run
here with its library, its device properties and its device switch
replaced."""

import contextlib
import types

import pytest

from linprog_tpu_torch.ops import _build
from linprog_tpu_torch.ops import bounded_kernel as bk
from linprog_tpu_torch.ops import plans as pl
from linprog_tpu_torch.ops import solve_kernel as sk
from linprog_tpu_torch.ops import stream_kernel as ssk
from tests.test_torch_stream_plan import BATCHES, SHAPES

P8 = pl.StreamingPlan(8, True, 4, 4096, 2, 1024, 120000, 2)
P4 = pl.StreamingPlan(4, True, 4, 8192, 4, 1024, 200000, 1)
P2 = pl.StreamingPlan(2, True, 4, 8192, 4, 1024, 210000, 1)


def _table(held):
    return lambda plan: held[plan]


# ---- fewest_waves: kernels 1 and 4 resident, kernel 3 -----------------------


def test_fewest_waves_ties_go_to_the_earlier_plan():
    """32 lanes: 30 clusters at once and 16 both take two waves; the
    earlier plan wins the tie, and a later one with fewer waves wins."""
    held = _table({P8: 30, P4: 16, P2: 64})
    assert pl.fewest_waves([P8, P4], 32, held, "k") == P8
    assert pl.fewest_waves([P4, P8], 32, held, "k") == P4
    assert pl.fewest_waves([P8, P4, P2], 32, held, "k") == P2


def test_fewest_waves_skips_a_refused_plan():
    held = _table({P8: 0, P4: -3, P2: 1})
    assert pl.fewest_waves([P8, P4, P2], 32, held, "k") == P2


def test_fewest_waves_raises_where_none_is_granted():
    held = _table({P8: 0, P4: -3})
    with pytest.raises(RuntimeError) as e:
        pl.fewest_waves([P8, P4], 32, held, "k", " for m=1, n=2")
    assert str(e.value) == (
        "k: the device holds no cluster of any planned size for m=1, n=2: "
        "(cluster, resident or negated CUDA error) = [(8, 0), (4, -3)]")


# ---- first_granted: kernel 1's streaming branch ---------------------------


def test_first_granted_takes_the_first_held_whatever_its_waves():
    """Two waves on the first plan beat one on a later one: the list's
    order (the estimate) decides."""
    held = _table({P8: 30, P2: 64})
    assert pl.first_granted([P8, P2], held, "k") == P8


def test_first_granted_skips_a_refused_plan():
    held = _table({P8: 0, P4: 2, P2: 64})
    assert pl.first_granted([P8, P4, P2], held, "k") == P4


def test_first_granted_raises_where_none_is_granted():
    held = _table({P8: 0, P2: -2})
    with pytest.raises(RuntimeError) as e:
        pl.first_granted([P8, P2], held, "k", " for m=1, n=2")
    assert str(e.value) == (
        "k: the device holds no cluster of any planned streaming layout for "
        f"m=1, n=2: (plan, resident or negated CUDA error) = "
        f"{[(P8, 0), (P2, -2)]}")


# ---- best_ranked: kernel 4's streaming branch -----------------------------


def test_best_ranked_breaks_a_tie_of_waves_by_sms_then_order():
    """16 lanes in one wave on each plan: 8 CTAs a lane two to an SM fill
    64 SMs, 4 one to an SM 64, 2 one to an SM 32; the listed order breaks
    the tie of 64."""
    held = _table({P8: 16, P4: 16, P2: 66})
    assert pl.best_ranked([P2, P4, P8], 16, held, 132, "k") == P4
    assert pl.best_ranked([P2, P8, P4], 16, held, 132, "k") == P8
    # fewer waves first, whatever the SMs
    held = _table({P8: 8, P4: 16, P2: 66})
    assert pl.best_ranked([P8, P4], 16, held, 132, "k") == P4


def test_best_ranked_skips_a_refused_plan():
    held = _table({P8: -1, P4: 0, P2: 3})
    assert pl.best_ranked([P8, P4, P2], 16, held, 132, "k") == P2


def test_best_ranked_raises_where_none_is_granted():
    held = _table({P8: -1, P4: 0})
    with pytest.raises(RuntimeError) as e:
        pl.best_ranked([P8, P4], 16, held, 132, "k", " for m=1, n=2")
    assert str(e.value) == (
        "k: the device holds no cluster of any planned streaming layout for "
        f"m=1, n=2: (plan, resident or negated CUDA error) = "
        f"{[(P8, -1), (P4, 0)]}")


def test_scalar_for_unaligned_swaps_drops_and_dedupes():
    """Each bulk-copy plan becomes the scalar branch at its size; a size
    without one drops out, and two plans of one size leave one."""
    s8 = pl.StreamingPlan(8, False, 0, 0, 0, 0, 9000, 2)
    scalar = {8: s8, 4: None}.get
    assert pl.scalar_for_unaligned([P8, P4, P8._replace(ctas_per_sm=1), s8],
                                   scalar) == [s8]
    assert pl.scalar_for_unaligned([P4, P2], scalar) == []


# ---- which wrapper takes which rule ----------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Each wrapper's occupancy queries answer from ``table[(cluster,
    smem_bytes)]`` on a card of 132 SMs; the plan caches are emptied around
    the test."""
    table = {}

    def query(cluster, *rest):
        return table[(cluster, rest[-1])]

    lib = types.SimpleNamespace(**{name: query for name in (
        "lp_solve_segment_cluster_max_clusters",
        "lp_solve_segment_large_max_clusters",
        "lp_solve_segment_stream_max_clusters",
        "lp_solve_bounded_cluster_max_clusters",
        "lp_solve_bounded_stream_max_clusters")})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr("torch.cuda.get_device_properties",
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr("torch.cuda.device",
                        lambda index: contextlib.nullcontext())
    chooses = (sk._choose_plan, ssk._choose_plan, bk._choose_plan)
    for choose in chooses:
        choose.cache_clear()
    yield table
    for choose in chooses:
        choose.cache_clear()


def _hold(table, plans, counts):
    for plan, count in zip(plans, counts):
        table[(plan.cluster, plan.smem_bytes)] = count


def test_kernel_1_resident_takes_fewest_waves(fake_card):
    plans = sk.segment_plans(1024, 256, 512)
    assert [p.cluster for p in plans] == [4, 8, 16]
    _hold(fake_card, plans, [1, 15, 9])
    assert sk._choose_plan(1024, 256, 512, False, 0, True) == plans[1]


def test_kernel_1_streaming_takes_the_first_granted(fake_card):
    """At [32, 1024, 2048] the first candidate, 8 CTAs a lane two to an SM,
    runs in two waves of 30 where 2 a lane would take one: it is taken."""
    plans = sk.segment_plans(32, 1024, 2048)
    assert (plans[0].cluster, plans[0].ctas_per_sm) == (8, 2)
    _hold(fake_card, plans, [30] + [64] * (len(plans) - 1))
    assert sk._choose_plan(32, 1024, 2048, False, 0, True) == plans[0]
    # unaligned pointers: the scalar branch at the candidates' sizes
    scalar = sk.large_scalar_plan(8, 1024, 2048)
    _hold(fake_card, [scalar, sk.large_scalar_plan(4, 1024, 2048)], [1, 64])
    assert sk._choose_plan(32, 1024, 2048, False, 0, False) == scalar


def test_kernel_3_takes_fewest_waves(fake_card):
    """Fewer waves on a later plan win; a tie of waves goes to the earlier
    plan even where the later fills more SMs."""
    plans = ssk.stream_plans(8, 2048, 6144)
    assert [p.cluster for p in plans] == [8, 2]
    _hold(fake_card, plans, [3, 66])
    assert ssk._choose_plan(8, 2048, 6144, False, 0, True) == plans[1]
    plans = ssk.stream_plans(32, 2048, 6144)
    assert [p.cluster for p in plans] == [2, 8]
    _hold(fake_card, plans, [32, 32])
    assert ssk._choose_plan(32, 2048, 6144, False, 0, True) == plans[0]
    dual = ssk.stream_plans(8, 2048, 6144, dual=True)
    _hold(fake_card, dual, [0, 66])
    assert ssk._choose_plan(8, 2048, 6144, True, 0, True) == dual[1]


def test_kernel_4_streaming_takes_the_best_ranked(fake_card):
    """At [16, 1280, 2560] the first candidate by the estimate, 8 CTAs a
    lane two to an SM, takes three waves where the card holds 6 of it; 4 a
    lane one to an SM, held 32 times, takes one and is taken."""
    plans = bk.segment_plans(16, 1280, 2560)
    assert [(p.cluster, p.ctas_per_sm) for p in plans] == [(8, 2), (4, 1),
                                                           (8, 1)]
    _hold(fake_card, plans, [6, 32, 15])
    assert bk._choose_plan(16, 1280, 2560, 0, True) == plans[1]
    with pytest.raises(RuntimeError, match="streaming layout for m=1280"):
        _hold(fake_card, plans, [0, 0, 0])
        bk._choose_plan.cache_clear()
        bk._choose_plan(16, 1280, 2560, 0, True)


# ---- kernel 3's plans are streaming_plan at one CTA an SM ------------------


def _kernel3_reference(cluster, m, n, dual, aligned=None,
                       smem_limit=232448):
    """Kernel 3's plan at ``cluster`` as its own arithmetic laid it out: the
    vectors, then on an aligned shape the largest ring of (stages of a
    warp, floats a stage) within a block's limit less 2048 static bytes; the
    scalar branch at 8 CTAs a lane only."""
    ml = (8 // cluster) * -(-m // 8)
    nl = (8 // cluster) * -(-n // 8)
    floats = 3 * m + max(m, n) + (n if dual else 0) + 5 * ml + 4 * nl
    vec = 4 * (-(-floats // 4) * 4)
    if not (m % 4 == 0 and n % 4 == 0 if aligned is None else aligned):
        if cluster != 8 or vec + 2048 > smem_limit:
            return None
        return (cluster, False, 0, 0, 0, 0, vec)
    for warp_stages, chunk in ((4, 1024), (4, 768), (2, 1024), (2, 768),
                               (2, 512), (2, 256)):
        chunk = min(chunk, m)
        ring = 8 * warp_stages * chunk
        if vec + 4 * ring <= smem_limit - 2048:
            return (cluster, True, 4, ring // 4 // 4 * 4, warp_stages, chunk,
                    vec + 4 * ring)
    return None


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("m,n", SHAPES, ids=lambda v: str(v))
def test_kernel_3_plans_match_its_own_arithmetic(m, n, B, dual):
    """Every candidate of kernel 3 is its seven-field layout, byte for byte,
    at one CTA an SM, in the order of the largest size that keeps the batch
    within the SMs; the scalar branch of an unaligned pointer too."""
    order = [8, 2] if B * 8 <= 132 else [2, 8]
    want = [p for p in (_kernel3_reference(cl, m, n, dual) for cl in order)
            if p is not None]
    got = ssk.stream_plans(B, m, n, dual=dual)
    assert [tuple(p)[:7] for p in got] == want
    assert all(p.ctas_per_sm == 1 for p in got)
    scalar = ssk.scalar_plan(8, m, n, dual)
    assert tuple(scalar)[:7] == _kernel3_reference(8, m, n, dual, False)
    assert scalar.ctas_per_sm == 1 and ssk.scalar_plan(2, m, n, dual) is None
