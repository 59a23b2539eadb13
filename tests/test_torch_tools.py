"""The port's BLOB tools (``tools_torch/``) against the JAX package's
(``tools/``), on the CPU.

Each tool's demo runs as the JAX tool (``JAX_PLATFORMS=cpu``) and as the
port's (``BMTPU_PLATFORM=cpu``) in subprocesses; both exit with 0 and
print the same lines apart from the named timing lines (svutil's
``import:``, range_idx's ``index build:`` and ``ms/1k``, lnkutil's
``in ... ms`` and inv_list's ``Mint/s`` column).  On one seeded input the
BLOB files that both write are byte-identical, and each package reads the
other's file to the same output (these run in this process).  Without a
card and without ``BMTPU_PLATFORM=cpu`` every port tool raises, the four
benchmarking tools (``tests/test_torch_bench_tools.py``,
``tests/test_torch_multihost.py``) included.
"""
import contextlib
import importlib
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm
from tools_torch import normalised

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("svutil", "range_idx", "lnkutil", "inv_list")
DEMO_ARGS = {"svutil": ["--demo"], "range_idx": ["--demo"],
             "lnkutil": ["--demo"],
             "inv_list": ["--max-lists", "4", "--levels", "0,6"]}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _jax_tool(name):
    """The JAX package's tool module (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f"tools_torch.{name}")


def _run_in_process(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    assert rc == 0
    return buf.getvalue()


def _outputs(mod, tmp_path, tag, argv):
    """A tool's lines with its output files under ``tmp_path/tag``
    (``{dir}`` in ``argv``), that directory printed as ``<dir>``."""
    d = tmp_path / tag
    d.mkdir()
    text = _run_in_process(mod, [a.replace("{dir}", str(d)) for a in argv])
    return text.replace(str(d), "<dir>")


def _run_subprocess(pkg_dir, name, env):
    path = os.path.join(ROOT, pkg_dir, f"{name}.py")
    r = subprocess.run([sys.executable, path] + DEMO_ARGS[name],
                       env=dict(os.environ, **env), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, f"{path}:\n{r.stderr[-2000:]}"
    return r.stdout


BENCH_TOOLS = ("bench_tpch", "microbench", "scaling_check",
               "multihost_check")


def test_every_tool_has_a_port():
    for name in TOOLS + ("fuzz_containers",) + BENCH_TOOLS:
        assert os.path.isfile(os.path.join(ROOT, "tools_torch",
                                           f"{name}.py")), name


def test_the_named_lines_differ_only_where_allowed():
    lines = ["import: 0.123s (5 values)", "index build: 1.5s for 3 ranges",
             "2000 point queries OK (4.4 ms/1k)",
             "2-hop neighborhood of 7: 41 nodes in 5.2 ms",
             "BMT1         0      5.310    42.483    152.2",
             "ref          6      0.452     3.618      6.1",
             "sv BLOB: 185672 bytes (14.85 bits/value)",
             "size=100000 nonzero=49961 memory_used=262432",
             "format   level  bytes/int  bits/int   Mint/s"]
    assert normalised("\n".join(lines)) == [
        "import: <s> (5 values)", "index build: <s> for 3 ranges",
        "2000 point queries OK (<ms> ms/1k)",
        "2-hop neighborhood of 7: 41 nodes in <ms>",
        "BMT1         0      5.310    42.483 <Mint/s>",
        "ref          6      0.452     3.618 <Mint/s>"] + lines[6:]


@pytest.mark.parametrize("name", TOOLS)
def test_demo_matches_jax(name):
    want = _run_subprocess("tools", name, {"JAX_PLATFORMS": "cpu"})
    got = _run_subprocess("tools_torch", name, {"BMTPU_PLATFORM": "cpu"})
    assert got.strip(), f"{name} printed nothing"
    assert normalised(got) == normalised(want)


# ---------------------------------------------------------------------------
# files across the packages, on one seeded input each
# ---------------------------------------------------------------------------
def _u32_values():
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 1 << 18, 70_000).astype(np.uint32)
    vals[rng.random(vals.size) < 0.4] = 0
    return vals


def test_svutil_files_cross(tmp_path):
    vals = _u32_values()
    src = tmp_path / "vals.u32"
    vals.astype("<u4").tofile(src)
    jt, tt = _jax_tool("svutil"), _port_tool("svutil")
    out = {tag: _outputs(mod, tmp_path, tag, [
        "-u32in", str(src), "-svout", "{dir}/out.sv", "-rscout",
        "{dir}/out.rsc", "-diag", "-timing"])
        for tag, mod in (("jax", jt), ("port", tt))}
    assert normalised(out["port"]) == normalised(out["jax"])
    for ext in ("sv", "rsc"):
        assert (tmp_path / "jax" / f"out.{ext}").read_bytes() == \
            (tmp_path / "port" / f"out.{ext}").read_bytes(), ext
    # each package reads the other's BLOBs back to the input
    for reader, mod, writer in (("port", tt, "jax"), ("jax", jt, "port")):
        for ext, flag in (("sv", "-svin"), ("rsc", "-rscin")):
            dst = tmp_path / f"{reader}_from_{writer}.{ext}.u32"
            got = _run_in_process(mod, [flag, str(tmp_path / writer
                                                  / f"out.{ext}"),
                                        "-u32out", str(dst), "-diag"])
            np.testing.assert_array_equal(np.fromfile(dst, "<u4"), vals)
            assert got.startswith(f"size={vals.size} nonzero="
                                  f"{int((vals != 0).sum())} ")


def test_range_idx_files_cross(tmp_path):
    rng = np.random.default_rng(11)
    n = 3_000
    starts = rng.permutation(np.sort(rng.choice(
        2_000_000, n, replace=False)) * 100)      # unsorted input rows
    ends = starts + rng.integers(10, 90, n)
    payloads = rng.integers(1, 1 << 20, n)
    tab = tmp_path / "ranges.tab"
    np.savetxt(tab, np.stack([starts, ends, payloads], 1), fmt="%d",
               delimiter="\t")
    jt, tt = _jax_tool("range_idx"), _port_tool("range_idx")
    out = {tag: _outputs(mod, tmp_path, tag, ["-i", str(tab), "-t",
                                              "-svout", "{dir}/payload.sv"])
           for tag, mod in (("jax", jt), ("port", tt))}
    assert normalised(out["port"]) == normalised(out["jax"])
    assert (tmp_path / "jax" / "payload.sv").read_bytes() == \
        (tmp_path / "port" / "payload.sv").read_bytes()
    # the payload BLOB of each, read by the other package's svutil
    want = payloads[np.argsort(starts)].astype(np.uint32)
    for mod, writer in ((_port_tool("svutil"), "jax"),
                        (_jax_tool("svutil"), "port")):
        dst = tmp_path / f"from_{writer}.u32"
        _run_in_process(mod, ["-svin", str(tmp_path / writer
                                           / "payload.sv"),
                              "-u32out", str(dst)])
        np.testing.assert_array_equal(np.fromfile(dst, "<u4"), want)


def test_lnkutil_files_cross(tmp_path):
    rng = np.random.default_rng(13)
    src = rng.choice(1 << 22, 200, replace=False)
    frm = np.repeat(src, 30)
    to = np.where(rng.random(frm.size) < 0.5,
                  rng.choice(src, frm.size), rng.integers(0, 1 << 22,
                                                          frm.size))
    tab = tmp_path / "links.tab"
    np.savetxt(tab, np.stack([frm, to], 1), fmt="%d", delimiter="\t")
    jt, tt = _jax_tool("lnkutil"), _port_tool("lnkutil")
    out = {tag: _outputs(mod, tmp_path, tag, ["-lin", str(tab), "-lmout",
                                              "{dir}/links.lm", "-bench"])
           for tag, mod in (("jax", jt), ("port", tt))}
    assert normalised(out["port"]) == normalised(out["jax"])
    assert (tmp_path / "jax" / "links.lm").read_bytes() == \
        (tmp_path / "port" / "links.lm").read_bytes()
    # each reads the other's matrix to the same lines
    cross = {reader: _run_in_process(mod, [
        "-lmin", str(tmp_path / writer / "links.lm"), "-bench"])
        for reader, mod, writer in (("port", tt, "jax"),
                                    ("jax", jt, "port"))}
    built = [ln for ln in normalised(out["jax"])
             if not ln.startswith("saved ")]
    assert normalised(cross["port"]) == normalised(cross["jax"]) == built


# ---------------------------------------------------------------------------
# no card and no BMTPU_PLATFORM=cpu: every port tool raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", TOOLS + ("fuzz_containers",)
                         + BENCH_TOOLS)
def test_tool_raises_without_card(name, monkeypatch):
    mod = _port_tool(name)
    monkeypatch.delenv("BMTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbm.config, "device", "cuda")
    argv = {"inv_list": ["--max-lists", "1", "--levels", "6"],
            "fuzz_containers": ["--trials", "1"],
            "bench_tpch": ["--customers", "1000", "--nations", "2"],
            "microbench": ["--blocks", "1"], "scaling_check": [],
            "multihost_check": ["2"]}.get(name, ["--demo"])
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)
