"""The port's samples (``samples_torch/``) against the JAX package's
(``samples/``), on the CPU.

Each pair runs in its own subprocesses with ``BMTPU_PLATFORM=cpu`` (the
JAX sample on its virtual 8-device mesh) and must exit with 0 and print
the same lines.  Only two kinds of line may differ, and only in the named
samples: the mesh's repr (07 and 21: a JAX ``Mesh`` against the port's
device list) and the wall times of sample 22, whose counts still compare.
This file holds samples 01-08 and the helpers; 09-16 and 17-24 are in
``test_torch_samples_09_16.py`` and ``test_torch_samples_17_24.py``.
Without a card and without ``BMTPU_PLATFORM=cpu`` every port sample
raises.
"""
import glob
import os
import re
import runpy
import subprocess
import sys

import pytest
import torch

import bitmagic_tpu_torch as tbm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(ROOT, "samples", "[0-9]*.py")))
MESH_LINE = {"07_sharded_scaling.py", "21_sharded_succinct_scan.py"}
TIMED_LINES = {"22_wide_ranges_48bit.py": ("set_range(0, 2^47-1): ",
                                           "invert() @ 2^48     : ")}
_MS = re.compile(r"\d+\.\d ms;")


def samples(first, last):
    return [s for s in SAMPLES if first <= int(s[:2]) <= last]


def _run(path):
    env = dict(os.environ, BMTPU_PLATFORM="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, path], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, f"{path}:\n{r.stderr[-2000:]}"
    return r.stdout.splitlines()


def _normalised(name, lines):
    out = []
    for ln in lines:
        if name in MESH_LINE and ln.startswith("mesh: "):
            ln = "mesh: <repr>"
        elif ln.startswith(TIMED_LINES.get(name, ())):
            ln = _MS.sub("<ms>;", ln)
        out.append(ln)
    return out


def check_sample(name):
    want = _run(os.path.join(ROOT, "samples", name))
    got = _run(os.path.join(ROOT, "samples_torch", name))
    assert got, f"{name} printed nothing"
    assert _normalised(name, got) == _normalised(name, want)


def test_every_sample_has_a_port():
    assert len(SAMPLES) == 24
    port = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ROOT, "samples_torch", "[0-9]*.py")))
    assert port == SAMPLES


def test_the_named_lines_differ_only_where_allowed():
    """The normalisation touches the mesh and timing lines and no other."""
    assert _normalised("07_sharded_scaling.py", ["mesh: A", "mesh:B"]) \
        == ["mesh: <repr>", "mesh:B"]
    line = "set_range(0, 2^47-1): 20.6 ms; count = 1"
    assert _normalised("22_wide_ranges_48bit.py", [line]) == \
        ["set_range(0, 2^47-1): <ms>; count = 1"]
    assert _normalised("01_setalgebra.py", [line, "mesh: A"]) == \
        [line, "mesh: A"]


@pytest.mark.parametrize("name", samples(1, 8))
def test_sample_matches_jax(name):
    check_sample(name)


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_raises_without_card(name, monkeypatch):
    monkeypatch.delenv("BMTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbm.config, "device", "cuda")
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(RuntimeError, match="cuda"):
        runpy.run_path(os.path.join(ROOT, "samples_torch", name),
                       run_name="__main__")
