"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import os
import re

import pytest

from lpbench import harness
from lpbench.reference.compare import NAMES

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == TOP
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024
    assert MAN["paths"] == ["lpbench"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[kind]
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key], (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        if kind == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] == 1


def test_metric_entries():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for m in _metrics():
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e, layer = harness.metrics_of(MAN, cell)
        names = {m["name"] for m in e}
        assert "setup_s" in names and len(names) >= 2 and layer, cell


def test_every_name_has_its_files():
    here = harness.HERE
    for c in MAN["configs"]:
        path = os.path.join(harness.ROOT, c["file"])
        with open(path) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert c["file"].startswith("lpbench/")
    for w in MAN["workloads"]:
        with open(os.path.join(here, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(here, "drivers",
                                           traffic["driver"] + ".py"))
        with open(os.path.join(here, "workloads", w["name"] + ".json")) as f:
            limits = json.load(f)["limits"]
        assert set(limits) == set(NAMES)
    for m in _metrics():
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_the_check_fits_its_time_with_24_cells():
    rs = MAN["run_seconds"]
    total = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_command_names_nothing_outside_paths():
    cmd = MAN["command"]
    assert len(cmd) <= 32
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("lpbench/")
