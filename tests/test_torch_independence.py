"""The PyTorch port stands alone: it imports neither ``jax`` nor
``bitmagic_tpu``, and without a card its default device raises instead of
running on the CPU."""
import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import bitmagic_tpu_torch as tbm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bitmagic_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "bitmagic_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import sys
        BLOCK = ("jax", "jaxlib", "bitmagic_tpu")

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCK):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        import bitmagic_tpu_torch as bt
        from bitmagic_tpu_torch import interop
        import bitmagic_tpu_torch.ops.cuda_kernels
        v = bt.BitVector.from_indices([3, 70000], 1 << 20, device="cpu")
        w = bt.BitVector.from_indices([3, 9], 1 << 20, device="cpu")
        assert (v & w).count() == 1 and bt.count_or(v, w) == 3
        assert v.select(2) == 70000
        assert bt.Aggregator().combine_and_sub([v], [w]).indices().tolist() \\
            == [70000]
        sv = bt.SparseVector.from_array([5, 0, 5, 7], device="cpu")
        assert bt.scanner.find_eq(sv, 5).indices().tolist() == [0, 2]
        assert bt.scanner.prepare_pipeline(sv).counts([5, 7]) == [2, 1]
        assert v.get_enumerator().go_to(4) and list(v.first()) == [3, 70000]
        assert bt.algo.intervals(v).tolist() == [[3, 3], [70000, 70000]]
        blob = bt.serialize(v)
        assert bt.deserialize(blob, device="cpu").equal(v)
        ref = bt.serial.ref_serialize(v)
        assert bt.serial.ref_deserialize(ref, device="cpu").equal(v)
        od = bt.OperationDeserializer()
        assert od.deserialize(w.copy(), blob, bt.constants.SET_COUNT_AND) \\
            == od.deserialize(w.copy(), ref, bt.constants.SET_COUNT_AND) == 1
        bad = [m for m in sys.modules
               if any(m == b or m.startswith(b + ".") for b in BLOCK)]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path} imports {name}"


_JAX_PKG_PATH = re.compile(r"(^|[^\w])bitmagic_tpu([/\\]|$)")


def _strings(tree):
    """The string constants of a module, docstrings left out."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_module_names_a_path_in_the_jax_package():
    """No port module (nor a C++/CUDA include) names a path inside
    ``bitmagic_tpu/``: the port reads nothing of the JAX package."""
    for d, _, files in os.walk(PKG):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py"):
                with open(path) as fh:
                    strings = _strings(ast.parse(fh.read(), path))
            elif f.endswith((".cpp", ".cu", ".cuh")):
                with open(path) as fh:
                    strings = [ln for ln in fh if ln.lstrip().startswith(
                        "#include")]
            else:
                continue
            for s in strings:
                assert not _JAX_PKG_PATH.search(s), f"{path}: {s!r}"


def test_native_library_is_the_ports_own():
    """The codec source the port compiles and the library it loads lie
    under bitmagic_tpu_torch/."""
    from bitmagic_tpu_torch.serial import native
    lib = native.load()
    for p in (native.SOURCE, native.library_path(), lib._name):
        p = os.path.realpath(p)
        assert os.path.commonpath([p, os.path.realpath(PKG)]) == \
            os.path.realpath(PKG), p


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbm.config, "device", "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.BitVector(1 << 20)
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.BitVector.from_indices([1, 2], 1 << 20)
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.BitVector.from_words([1, 2, 3])
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.simd_version()
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.SparseVector()
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.SparseVector.from_array([1, 2])
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.Aggregator().combine_or([])
    # asking for the CPU explicitly runs the plain versions
    v = tbm.BitVector.from_indices([1, 2], 1 << 20, device="cpu")
    assert v.count() == 2 and v.device.type == "cpu"
    monkeypatch.setattr(tbm.config, "device", "cpu")
    assert tbm.simd_version() == "cpu:torch"


def test_sharding_and_sv_serialization_import_alone():
    """The sv serialization and sharding modules load and run with ``jax``
    and ``bitmagic_tpu`` blocked."""
    code = textwrap.dedent("""
        import sys
        BLOCK = ("jax", "jaxlib", "bitmagic_tpu")

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCK):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        import numpy as np
        import bitmagic_tpu_torch as bt
        from bitmagic_tpu_torch import parallel
        from bitmagic_tpu_torch.serial import ref_sv, sv_serial
        bt.config.device = "cpu"
        sv = bt.SparseVector.from_array(
            (np.arange(70000) % 50).astype(np.uint32))
        blob = sv_serial.sparse_vector_serialize(sv)
        assert sv_serial.sparse_vector_deserialize(blob).equal(sv)
        back = ref_sv.deserialize_sv_blob(ref_sv.serialize_sv_blob(sv))
        assert back.gather([69999])[0] == 69999 % 50
        mesh = parallel.Mesh(["cpu"] * 4)
        s = parallel.ShardedSparseVector.from_sparse_vector(sv, mesh)
        assert s.find_eq_count(7) == 1400
        assert s.find_gt(47).count() == 2800
        a = parallel.ShardedBitVector.from_indices([1, 70000], 1 << 20, mesh)
        assert (a & a).count() == 2 and a.select(2) == 70000
        assert parallel.broadcast_bytes(b"x") == b"x"
        bad = [m for m in sys.modules
               if any(m == b or m.startswith(b + ".") for b in BLOCK)]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_blobcast_uses_torch_distributed_only():
    """The BLOB broadcast talks to other processes through
    ``torch.distributed`` and nothing else."""
    path = os.path.join(PKG, "parallel", "blobcast.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            top.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module)
    assert top == {"__future__", "torch", "torch.distributed"}
