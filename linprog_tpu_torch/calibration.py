"""Per-card calibration of the regime boundaries (counterpart of
:mod:`linprog_tpu.calibration`).

The router's thresholds (simplex / IPM / IPM -> crossover / PDHG) and the
refactor-segment knees are measurements.  They live in one data file,
``linprog_tpu_torch/data/calibration.json``, keyed by the card's name
(``torch.cuda.get_device_name()``).  Its ``"default"`` entry holds the
reference package's values, which were measured on a TPU v5e, not on a GPU:
they are routing-parity constants, and the entry a machine without a CUDA
device resolves to.

* :func:`get_table` -- the thresholds for the current (or a named) card; a
  key the card's entry lacks falls back to ``"default"``.  The variable
  ``LINPROG_TPU_TORCH_CALIBRATION`` names a file to read in place of the
  packaged one (its missing keys still fall back to the packaged
  defaults).
* :func:`set_table` / :func:`reset_table` -- inject a table of the file's
  schema (tests, or a user on a new card).  The injection is plain module
  state.
* :func:`calibrate` -- measure the boundaries on a device and return a
  table (optionally saving it).
"""

from __future__ import annotations

import json
import os
from typing import Optional

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data",
                          "calibration.json")

_file_cache: Optional[dict] = None
_packaged_cache: Optional[dict] = None
_override: Optional[dict] = None


def _load_file() -> dict:
    global _file_cache
    if _file_cache is None:
        path = os.environ.get("LINPROG_TPU_TORCH_CALIBRATION", _DATA_PATH)
        with open(path) as f:
            _file_cache = json.load(f)
    return _file_cache


def _packaged_default() -> dict:
    """The packaged ``"default"`` entry, read from the package's data file
    whatever the environment or :func:`set_table` put over it, so that a
    partial table still resolves every key (read once; a fresh copy each
    call)."""
    global _packaged_cache
    if _packaged_cache is None:
        with open(_DATA_PATH) as f:
            _packaged_cache = json.load(f)["default"]
    return json.loads(json.dumps(_packaged_cache))


def set_table(table: dict) -> None:
    """Inject ``table`` (card names and/or ``"default"`` mapped to threshold
    dicts) over the data file until :func:`reset_table`."""
    global _override
    _override = table


def reset_table() -> None:
    """Drop any :func:`set_table` injection and re-read the data file."""
    global _override, _file_cache
    _override = None
    _file_cache = None


def _device_kind(device=None) -> str:
    """The card's name for ``device`` (default: the current CUDA device),
    ``"default"`` for the CPU or where there is no card."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return "default"
    if torch.cuda.device_count() == 0:
        return "default"
    return torch.cuda.get_device_name(device)


def get_table(device_kind: Optional[str] = None) -> dict:
    """The thresholds for ``device_kind`` (default: the current card):
    the packaged defaults, then the source's ``"default"`` entry, then the
    card's own, key by key."""
    src = _override if _override is not None else _load_file()
    kind = device_kind or _device_kind()
    base = _packaged_default()
    base.update(src.get("default", {}))
    base.update(src.get(kind, {}))
    base["seg_by_m"] = [list(r) for r in base["seg_by_m"]]
    return base


def seg_for_m(m: int, device_kind: Optional[str] = None) -> int:
    """Refactor-segment length for problem size ``m``: rows ``[hi, seg]``,
    ``hi == 0`` meaning everything larger."""
    for hi, seg in get_table(device_kind)["seg_by_m"]:
        if hi == 0 or m <= hi:
            return int(seg)
    raise AssertionError("seg_by_m has no terminal row")


def calibrate(sizes=(128, 256, 512), lanes: int = 64, seed: int = 0,
              save_path: Optional[str] = None,
              seg_grid=(256, 512, 768, 1024), device="cuda",
              pdhg_sizes=(1024, 2048), pdhg_lanes: int = 16) -> dict:
    """Measure the routing thresholds on ``device``.

    For each size in ``sizes``, on ``lanes`` random dense instances made on
    the device from ``seed``, every timing taken after one warm-up run and
    between two synchronisations:

    * ``seg_by_m`` -- the refactor-segment knee: the two-phase simplex at
      each ``seg_grid`` value, the fastest kept (rows past the largest size
      are inherited).
    * ``moderate_simplex_max_m`` -- simplex at its best segment against the
      raw batched IPM, the leg the moderate-accuracy route dispatches.
    * ``exact_simplex_max_m`` -- simplex against IPM -> crossover at its
      best cleanup settings.
    * ``xover_pallas_max_m`` -- the largest size where the whole-segment
      cleanup settings (``tuned_config(m)``, budget 512) beat the
      tight-refactor large-m settings (``refactor_every=128``, budget
      2048); a size past the reference's whole-segment gate at crossover
      shapes ``(m, 2m)`` counts as large.
    * ``exact_eps`` -- from the raw IPM's per-lane KKT floor (median of
      primal residual and duality gap at a tight target): requests below
      ``10^floor(log10(floor / 30))`` need the exact pipeline.

    * ``pdhg_min_m`` -- over ``pdhg_sizes`` (``pdhg_lanes`` instances
      from ``seed + 1``): PDHG (eps 1e-4, fixed-cadence restarts, 40000
      iterations at most) against the raw IPM at eps 1e-4; the smallest
      size where PDHG wins, or twice the largest size if it never does.
      An empty ``pdhg_sizes`` inherits the key.

    Returns ``{card name: thresholds}`` with ``"_measured"`` (the keys
    taken from live timings) and ``"_provenance"`` (the probe's scale:
    boundaries move with the batch size as well as with m, and the seconds
    behind every decision, by size; the PDHG leg's under
    ``"pdhg_seconds"``); ``save_path`` writes a file of the data file's
    schema.
    """
    import math
    import time

    import numpy as np
    import torch

    from .batch import solve_batch_two_phase
    from .config import tuned_config
    from .crossover import ipm_crossover_batch_canonical
    from .engine_batched import _mega_kernel_fits
    from .generators import device_inequality_lps, device_standard_form_batch
    from .ipm import IPMConfig, ipm_solve_batch_canonical

    dev = torch.device(device)
    kind = _device_kind(dev)
    table = dict(get_table(kind))
    measured = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _time(fn):
        fn()  # warm-up
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    exact_wins, moderate_wins, mega_wins, seg_rows = [], [], [], []
    floor_scores, seconds = [], {}
    for m in sizes:
        gen = torch.Generator(device=dev).manual_seed(seed)
        c, G, h = device_inequality_lps(gen, lanes, m, m, dev)
        cs, As, bs = device_standard_form_batch(c, G, h)
        it = max(2000, 4 * m)

        # --- refactor-segment knee ---------------------------------------
        by_seg = {}
        for seg in seg_grid:
            if seg > 2 * it:
                continue
            cfg = tuned_config(m, refactor_every=int(seg))
            by_seg[int(seg)] = _time(lambda cfg=cfg: solve_batch_two_phase(
                cs, As, bs, it, it, cfg))
        best_seg = min(by_seg, key=by_seg.get)  # the first of equal times
        t_simplex = by_seg[best_seg]
        seg_rows.append([int(m), best_seg])

        # --- raw IPM (the moderate-accuracy leg) -------------------------
        t_ipm = _time(lambda: ipm_solve_batch_canonical(c, G, h, IPMConfig()))
        moderate_wins.append((m, t_simplex <= t_ipm))

        # --- KKT floor of the raw IPM (for exact_eps) --------------------
        r = ipm_solve_batch_canonical(
            c, G, h, IPMConfig(eps_rel=1e-7, maxiters=60))
        xu = r.x[:, :c.shape[1]].double()
        hd, cost = h.double(), r.cost.double()
        viol = torch.clamp_min(
            torch.einsum("bmn,bn->bm", G.double(), xu) - hd, 0.0)
        pr = (torch.linalg.vector_norm(viol, dim=1)
              / (1.0 + torch.linalg.vector_norm(hd, dim=1)))
        gap = (torch.abs(cost - (hd * r.y.double()).sum(dim=1))
               / (1.0 + torch.abs(cost)))
        floor_scores.append(
            float(np.median(torch.maximum(pr, gap).cpu().numpy())))

        # --- exact pipeline at its best cleanup settings -----------------
        candidates = []
        if _mega_kernel_fits(m, 2 * m, with_at=False):
            candidates.append(
                ("mega", tuned_config(m), max(256, min(512, 2 * it))))
        candidates.append((
            "stream",
            tuned_config(m, refactor_every=min(128, max(32, m // 4)),
                         unroll=2),
            max(512, min(2048, 4 * it)),
        ))
        times = {
            name: _time(lambda cfg=cfg, b=b: ipm_crossover_batch_canonical(
                c, G, h, crossover_maxiters=b, cfg=cfg))
            for name, cfg, b in candidates
        }
        if "mega" in times:
            mega_wins.append((m, times["mega"] <= times["stream"]))
        exact_wins.append((m, t_simplex <= min(times.values())))
        seconds[str(int(m))] = {"simplex_by_seg": by_seg, "ipm": t_ipm,
                                "exact": times,
                                "kkt_floor": floor_scores[-1]}

    def _largest_win(wins):
        best = 0
        for m, won in wins:
            if not won:
                break
            best = m
        return best

    table["exact_simplex_max_m"] = _largest_win(exact_wins)
    table["moderate_simplex_max_m"] = _largest_win(moderate_wins)
    measured += ["exact_simplex_max_m", "moderate_simplex_max_m"]

    if mega_wins:
        table["xover_pallas_max_m"] = _largest_win(mega_wins)
        measured.append("xover_pallas_max_m")

    floor = float(np.median(floor_scores))
    if floor > 0:
        table["exact_eps"] = float(
            10.0 ** math.floor(math.log10(max(floor / 30.0, 1e-7))))
        measured.append("exact_eps")

    # measured knees for the sizes covered; rows past the measured grid
    # (larger-m knees and the terminal row) are inherited
    keep = [r for r in table["seg_by_m"] if r[0] == 0 or r[0] > max(sizes)]
    table["seg_by_m"] = seg_rows + (keep or [[0, seg_rows[-1][1]]])
    measured.append("seg_by_m")

    pdhg_seconds = {}
    if pdhg_sizes:
        from .pdhg import PDHGConfig, pdhg_solve_batch_canonical

        pcfg = PDHGConfig(eps_rel=1e-4, adaptive=False)
        pdhg_min = None
        for m in pdhg_sizes:
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            c, G, h = device_inequality_lps(gen, pdhg_lanes, m, m, dev)
            t_pdhg = _time(lambda: pdhg_solve_batch_canonical(
                c, G, h, maxiters=40_000, cfg=pcfg))
            t_ipm = _time(lambda: ipm_solve_batch_canonical(
                c, G, h, IPMConfig(eps_rel=1e-4)))
            pdhg_seconds[str(int(m))] = {"pdhg": t_pdhg, "ipm": t_ipm}
            if t_pdhg < t_ipm:
                pdhg_min = int(m)
                break
        table["pdhg_min_m"] = (pdhg_min if pdhg_min is not None
                               else 2 * int(max(pdhg_sizes)))
        measured.append("pdhg_min_m")

    table["_measured"] = measured
    table["_provenance"] = {"lanes": int(lanes),
                            "sizes": [int(s) for s in sizes],
                            "seg_grid": [int(s) for s in seg_grid],
                            "seconds": seconds,
                            "pdhg_sizes": [int(s) for s in pdhg_sizes],
                            "pdhg_lanes": int(pdhg_lanes),
                            "pdhg_seconds": pdhg_seconds}
    out = {kind: table}
    if save_path:
        with open(save_path, "w") as f:
            json.dump({"default": get_table("default"), **out}, f, indent=1)
    return out
