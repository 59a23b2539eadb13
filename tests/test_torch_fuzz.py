"""The port's container fuzzer (``tools_torch/fuzz_containers.py``)
against the JAX package's (``tools/fuzz_containers.py``), on the CPU.

Every family passes seeds 0-2 in this process on ``Mesh(["cpu"] * 8)``;
each trial takes as many draws from its generator as the JAX trial does
(both leave the generator in the same state), so a seed replays the same
case in either package; ``--trials 6 --seed 0`` picks the same families as
the JAX fuzzer on its virtual 8-device CPU mesh (a subprocess); and a
fault planted in the sharded sparse vector is caught with a ``FAIL seed=``
line and exit code 1.
"""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch.parallel import Mesh
from bitmagic_tpu_torch.parallel.sharded_sv import ShardedSparseVector
from tools_torch import fuzz_containers as fz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = [f.__name__.removeprefix("trial_") for f in fz.TRIALS]
_TRIAL_LINE = re.compile(r"^trial \d+ \(trial_\w+\) ok$")


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")
    monkeypatch.delenv("BMTPU_PLATFORM", raising=False)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fz.main(argv)
    return rc, buf.getvalue()


def test_families_in_the_jax_order():
    with open(os.path.join(ROOT, "tools", "fuzz_containers.py")) as f:
        src = f.read()
    order = re.search(r"TRIALS = \[([^\]]*)\]", src).group(1)
    assert [n.strip() for n in order.split(",")] == \
        [f.__name__ for f in fz.TRIALS]
    assert len(FAMILIES) == 12


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_passes(family, seed):
    rc, out = _main(["--family", family, "--seed", str(seed),
                     "--trials", "1"])
    assert rc == 0
    assert out.splitlines() == [f"trial 0 (trial_{family}) ok",
                                "ALL 1 TRIALS PASSED"]


@pytest.fixture(scope="module")
def jax_fuzz():
    """The JAX fuzzer's module, imported in this process (its mesh is the
    suite's virtual 8-device CPU mesh)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_fuzz_containers",
        os.path.join(ROOT, "tools", "fuzz_containers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", FAMILIES)
def test_trial_takes_the_jax_draws(family, jax_fuzz):
    """A trial leaves its generator where the JAX trial leaves it: the
    same number and kinds of draws, so seeds replay across packages."""
    seed = 0
    rj = np.random.default_rng(seed)
    getattr(jax_fuzz, f"trial_{family}")(rj, seed, 0)
    rt = np.random.default_rng(seed)
    getattr(fz, f"trial_{family}")(rt, seed, 0, Mesh(["cpu"] * fz.SHARDS))
    assert rt.bit_generator.state == rj.bit_generator.state


def test_random_order_matches_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "fuzz_containers.py"),
                        "--trials", "6", "--seed", "0"], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    want = [ln for ln in r.stdout.splitlines() if _TRIAL_LINE.match(ln)]
    rc, out = _main(["--trials", "6", "--seed", "0"])
    assert rc == 0
    got = [ln for ln in out.splitlines() if _TRIAL_LINE.match(ln)]
    assert len(want) == 6 and got == want
    assert out.splitlines()[-1] == "ALL 6 TRIALS PASSED"


def test_planted_fault_is_caught(monkeypatch):
    real = ShardedSparseVector.find_eq_count
    monkeypatch.setattr(ShardedSparseVector, "find_eq_count",
                        lambda self, q: real(self, q) + 1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        fz.main(["--family", "int", "--seed", "0", "--trials", "1"])
    assert e.value.code == 1
    assert buf.getvalue().startswith("FAIL seed=0 trial=0: int "
                                     "find_eq_count(")
