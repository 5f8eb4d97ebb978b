"""The command's refusals, the import check and the trace reader."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from lpbench import devtrace, harness

ROOT = harness.ROOT


def _run(args, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "lpbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


def test_no_card_exits_nonzero_and_prints_no_result():
    p = _run(["--workload", "ineq_m256.exact", "--seed", "3000000000",
              "--seconds", "1", "--trace", "0"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "lpbench"), tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    p = _run(["--workload", "ineq_m256.exact", "--seed", "1", "--seconds",
              "1", "--trace", "0"], cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    """Top-level module names compared whole: ``linprog_tpu_torch`` is the
    program, ``linprog_tpu`` would be the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import lpbench.run as r, lpbench.harness as h, lpbench.control\n"
        "import importlib, glob, os\n"
        "for sub in ('drivers', 'metrics', 'reference'):\n"
        "    for f in glob.glob(os.path.join(h.HERE, sub, '*.py')):\n"
        "        importlib.import_module('lpbench.%%s.%%s' %% (sub, "
        "os.path.basename(f)[:-3]))\n"
        "import linprog_tpu_torch.router, linprog_tpu_torch.batch\n"
        "print(r.forbidden_modules())\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_check_compares_whole_names(monkeypatch):
    from lpbench import run

    monkeypatch.setitem(sys.modules, "linprog_tpu_torch_fake", object())
    assert "linprog_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "linprog_tpu.ops", object())
    assert run.forbidden_modules() == ["linprog_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in ("reference/simplex.py", "reference/compare.py",
                 "instances.py", "roofline.py"):
        with open(os.path.join(harness.HERE, path)) as f:
            src = f.read()
        assert "linprog_tpu" not in src.replace("linprog_tpu_torch/", ""), \
            path


def _event(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}


def test_read_trace_busy_idle_and_gaps(tmp_path):
    ev = [
        _event(devtrace.STRETCH, "user_annotation", 0.0, 1000.0),
        _event("void k1<4>(Args)", "kernel", 100.0, 200.0),
        _event("void k1<4>(Args)", "kernel", 250.0, 100.0),  # overlaps
        _event("Memcpy DtoH", "gpu_memcpy", 600.0, 100.0),
        _event("aten::item", "cpu_op", 340.0, 300.0),
        _event("cudaStreamSynchronize", "cuda_runtime", 720.0, 280.0),
        _event("void late(Args)", "kernel", 1200.0, 50.0),  # outside
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    p = devtrace.read_trace(str(path))
    assert p.window_s == pytest.approx(1e-3)
    assert p.busy_s == pytest.approx(350e-6)  # [100, 350] and [600, 700]
    assert p.kernel_s["k1"] == pytest.approx(300e-6)
    gaps = dict(p.idle_by_host)
    assert gaps["aten::item"] == pytest.approx(250e-6)  # [350, 600]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert gaps["host: none"] == pytest.approx(100e-6)  # [0, 100]


@pytest.mark.parametrize("raw", [
    "void (anonymous namespace)::solve_segment_cluster_kernel<4>(float*)",
    "void <unnamed>::solve_segment_cluster_kernel<4>(float*)",
    "solve_segment_cluster_kernel",
])
def test_short_name_drops_anonymous_namespaces(raw):
    assert devtrace.short_name(raw) == "solve_segment_cluster_kernel"


def _roofline_run(kernel_s):
    from lpbench import spans
    from lpbench.metrics import k1_roofline_pct

    class Run:
        pass

    run = Run()
    run.rec = spans.Recorder(False)
    probe = {"shape": (1024, 256, 512), "running": 1024, "pivots": 65536}
    run.rec.spans.append(spans.Span("k1", None, None, probe, True))
    run.profile = devtrace.Profile(busy_s=1.0, window_s=1.0,
                                   kernel_s=kernel_s, idle_by_host=[])
    return k1_roofline_pct.read(run)


def test_roofline_reads_the_kernels_device_time_or_nothing():
    from lpbench.roofline import launch_bound_s

    least = launch_bound_s(1024, 256, 512, 65536)
    got = _roofline_run({"solve_segment_cluster_kernel": 0.5,
                         "at::native::elementwise_kernel": 9.0})
    assert got == pytest.approx(100.0 * least / 0.5)
    # no symbol of the kernel in the trace: no reading, not the spans'
    assert _roofline_run({"": 0.5}) is None
