"""The port's benchmarking tools (``tools_torch/bench_tpch.py``,
``microbench.py`` and ``scaling_check.py``) against the JAX package's
(``tools/``), on the CPU.

Each tool runs as the JAX tool (``JAX_PLATFORMS=cpu``) and as the port's
(``BMTPU_PLATFORM=cpu`` or ``--cpu``) in subprocesses, and both exit with
0.  bench_tpch's JSON is equal apart from its two times (``build_s``,
``query_s``); microbench prints the same family labels in the same order
and the same BLOB sizes; scaling_check prints the same lines once
``tools_torch.normalised`` has blanked the times, each port line ending in
its launches per step (none on the CPU, where the plain versions run).
In this process, with the kernel wrappers counted as launches,
scaling_check reports one B6 and one K3 per shard per scan and one B5 per
shard per pipeline.  Tolerance: exact equality (integers and text).
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from tools_torch import normalised

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = {"JAX_PLATFORMS": "cpu"}
PORT_ENV = {"BMTPU_PLATFORM": "cpu"}
TPCH_ARGS = ["--customers", "20000", "--nations", "20", "--json"]
MICRO_ARGS = ["--cpu", "--blocks", "4"]
LABEL = re.compile(r"^\[(\w+) *\] ")


def _run(pkg_dir, name, argv, env):
    path = os.path.join(ROOT, pkg_dir, f"{name}.py")
    r = subprocess.run([sys.executable, path] + argv,
                       env=dict(os.environ, OMP_NUM_THREADS="1", **env),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{path}:\n{r.stderr[-3000:]}"
    return r.stdout


def _launch_suffix(per_scan, per_pipe):
    return (f"; launches per step: scan {per_scan} B6 + {per_scan} K3, "
            f"pipeline {per_pipe} B5")


def test_bench_tpch_json_matches_jax():
    want = json.loads(_run("tools", "bench_tpch", TPCH_ARGS, JAX_ENV))
    got = json.loads(_run("tools_torch", "bench_tpch", TPCH_ARGS, PORT_ENV))
    for k in ("build_s", "query_s"):
        assert isinstance(got.pop(k), float)
        want.pop(k)
    assert got == want
    assert got["result_orders"] > 0 and got["index_bytes"] > 0


def test_microbench_labels_and_blobs_match_jax():
    want = _run("tools", "microbench", MICRO_ARGS, {})
    got = _run("tools_torch", "microbench", MICRO_ARGS, {})

    def labels(text):
        return [m.group(1) for m in map(LABEL.match, text.splitlines()) if m]

    def blobs(text):
        return [ln for ln in text.splitlines()
                if ln.lstrip().startswith("blob ")]
    assert labels(got) == labels(want)
    assert len(labels(got)) == 20
    assert blobs(got) == blobs(want) and len(blobs(got)) == 3
    # every timing line is blanked by the normaliser
    timed = [ln for ln in normalised(got) if LABEL.match(ln)]
    assert timed and all(ln.endswith("<rate>") and "<ms>" in ln
                         for ln in timed)


def test_scaling_check_matches_jax():
    want = normalised(_run("tools", "scaling_check", [], JAX_ENV))
    got = normalised(_run("tools_torch", "scaling_check", [], PORT_ENV))
    assert len(got) == len(want) == 5
    assert got[0] == want[0] == "backend=cpu devices=8"
    suffix = _launch_suffix(0, 0)
    for g, w in zip(got[1:], want[1:]):
        assert g == w + suffix
        assert "<ms>" in w


def test_scaling_check_launches_one_kernel_per_shard(monkeypatch):
    """The kernel wrappers, counted as launches in this process: the
    tool's lines give one B6 and one K3 per shard per scan and one B5 per
    shard per pipeline."""
    for name, counter in (("scan_eq", "scan_eq"),
                          ("block_counts_total", "block_counts"),
                          ("pipeline_counts", "pipeline_counts")):
        real = getattr(ck, name)

        def counted(*a, _real=real, _counter=counter, **k):
            ck.launches[_counter] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ck, name, counted)
    monkeypatch.setattr(tbm.config, "device", "cpu")
    from tools_torch import scaling_check
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert scaling_check.main([]) == 0
    lines = buf.getvalue().splitlines()[1:]
    assert len(lines) == 4
    for n, ln in zip((1, 2, 4, 8), lines):
        assert ln.startswith(f"mesh={n}: ")
        assert ln.endswith(_launch_suffix(n, n)), ln


def test_the_new_timing_lines_are_normalised():
    lines = ["[stream  ]    0.003 ms  ->      11.95 GB/s",
             "[select  ]  162.046 ms  ->       0.62 Mq/s",
             "mesh=2: scan 1M elems in 0.8 ms (weak scaling), 16-query "
             "pipeline 1.3 ms, sharded-SV container 8-query pipeline "
             "112.6 ms, count/psum + shard-prefix select OK",
             "multihost OK: 2 processes x 4 devices = 8 global; "
             "popcount/psum, scan (4.3 ms), 8-query pipeline",
             "          blob 4.0 KB",
             "backend=cpu devices=8"]
    assert normalised("\n".join(lines)) == [
        "[stream  ] <ms> ms  -> <rate>",
        "[select  ] <ms> ms  -> <rate>",
        "mesh=2: scan 1M elems in <ms> ms (weak scaling), 16-query "
        "pipeline <ms> ms, sharded-SV container 8-query pipeline "
        "<ms> ms, count/psum + shard-prefix select OK",
        "multihost OK: 2 processes x 4 devices = 8 global; "
        "popcount/psum, scan (<ms> ms), 8-query pipeline"] + lines[4:]


@pytest.mark.parametrize("name", ["bench_tpch", "microbench",
                                  "scaling_check"])
def test_tool_has_main_and_stands_alone(name):
    import importlib
    mod = importlib.import_module(f"tools_torch.{name}")
    assert callable(mod.main)
    with open(os.path.join(ROOT, "tools_torch", f"{name}.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|bitmagic_tpu|bench)\b"
                         r"(?!_torch)", src, re.M)
