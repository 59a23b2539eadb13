"""Top-level and class surface of the port against the JAX package.

Every name of ``bitmagic_tpu.__all__`` resolves in ``bitmagic_tpu_torch``
(to the port's own object), the public methods of each container,
scanner, serializer, enumerator and helper class of the JAX package exist
on the port's class of the same module and name, and the alias identities
of ``tests/test_api_surface.py`` hold for the port.  Over every Python
module of the JAX package, each public function and class defined there
(and each public attribute of such a class) exists in the port's module
of the same path, apart from a named list of what differs by design.
"""
import importlib
import inspect
import os
import types

import pytest

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm

MODULES = [
    "core.bitvector", "core.blocks", "core.enumerator", "core.gapstore",
    "core.rs_index", "algo.intervals", "algo.sampling", "agg.aggregator",
    "agg.arena", "sv.sparse_vector", "sv.rsc_vector", "sv.str_vector",
    "sv.float_vector", "sv.bmatrix", "sv.iterators", "sv.scanner",
    "sv.algo", "sv.util", "serial.serializer", "serial.opdeser",
    "serial.stream_iter", "serial.sv_serial", "serial.refcodec",
    "serial.encoding", "serial.native", "parallel.sharded",
    "parallel.sharded_sv", "parallel.plan", "utils.golden", "utils.timer",
]


@pytest.mark.parametrize("name", jbm.__all__)
def test_jax_top_level_name_resolves(name):
    assert name in tbm.__all__, name
    got = getattr(tbm, name, None)
    assert got is not None, name
    want = getattr(jbm, name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        assert got.__name__ == want.__name__.replace(
            "bitmagic_tpu", "bitmagic_tpu_torch", 1)
    elif callable(want):
        assert callable(got)
        mod = getattr(got, "__module__", "") or ""
        assert mod.startswith("bitmagic_tpu_torch"), (name, mod)


def test_all_names_importable():
    for name in tbm.__all__:
        assert getattr(tbm, name, None) is not None, name


def _classes(module):
    return {n: c for n, c in vars(module).items()
            if inspect.isclass(c) and c.__module__ == module.__name__
            and not n.startswith("_")}


@pytest.mark.parametrize("path", MODULES)
def test_public_methods_exist_on_the_port(path):
    jm = importlib.import_module(f"bitmagic_tpu.{path}")
    tm = importlib.import_module(f"bitmagic_tpu_torch.{path}")
    jcls = _classes(jm)
    assert jcls, path
    for name, jc in jcls.items():
        tc = getattr(tm, name, None)
        assert inspect.isclass(tc), f"{path}.{name}"
        missing = {n for n in dir(jc) if not n.startswith("_")} - set(dir(tc))
        assert not missing, f"{path}.{name} lacks {sorted(missing)}"


def test_top_level_aliases_resolve():
    # container family (reference bm::bvector, bm::sparse_vector, ...)
    assert tbm.BitVector is tbm.core.bitvector.BitVector
    assert tbm.SparseVector is tbm.sv.SparseVector
    assert tbm.RSCSparseVector is tbm.sv.RSCSparseVector
    assert tbm.StrSparseVector is tbm.sv.StrSparseVector
    assert tbm.FloatSparseVector is tbm.sv.FloatSparseVector
    assert tbm.BitMatrix is tbm.sv.BitMatrix
    # algorithms / serialization (bm::aggregator, bm::serializer, ...)
    assert tbm.Aggregator is tbm.agg.Aggregator
    assert tbm.aggregator_pipeline_execute is \
        tbm.agg.aggregator_pipeline_execute
    assert tbm.SparseVectorScanner is tbm.sv.SparseVectorScanner
    assert tbm.Serializer is tbm.serial.Serializer
    assert tbm.Deserializer is tbm.serial.Deserializer
    assert tbm.OperationDeserializer is tbm.serial.OperationDeserializer
    assert tbm.SerialStreamIterator is tbm.serial.SerialStreamIterator
    assert tbm.IteratorDeserializer is tbm.serial.IteratorDeserializer
    # error surface
    assert issubclass(tbm.ReadOnlyError, RuntimeError)


def test_utils_and_capi_submodules():
    for name in ("debug", "timer", "golden"):
        assert isinstance(getattr(tbm.utils, name), types.ModuleType)
    # capi is a submodule, not a top-level name, as in the JAX package
    assert "capi" not in tbm.__all__ and "capi" not in jbm.__all__
    capi = importlib.import_module("bitmagic_tpu_torch.capi")
    assert capi.BM_bvector_construct.__module__ == "bitmagic_tpu_torch.capi"


# What the port leaves out by design: the Pallas kernels' module (their
# place is taken by ops/csrc + ops/cuda_kernels.py), the bridge to the
# reference's C++ (it compiles the reference's headers, which the
# repository does not hold), and the four Pallas switches of Config (the
# tensor's device picks the route).
ABSENT_MODULES = {"ops.pallas_kernels", "serial.refformat"}
ABSENT_NAMES = {"config.Config": {"use_pallas", "pallas_interpret",
                                  "pallas_enabled", "interpret_mode"}}


def _jax_modules():
    root = os.path.dirname(jbm.__file__)
    out = []
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out.append(".".join(parts))
    return sorted(out)


def _defined_here(module):
    """Public functions and classes defined in ``module`` itself."""
    return {n: v for n, v in vars(module).items()
            if not n.startswith("_")
            and (inspect.isclass(v) or inspect.isfunction(v))
            and v.__module__ == module.__name__}


@pytest.mark.parametrize("path", _jax_modules(), ids=lambda p: p or "top")
def test_every_defined_name_exists_in_the_port(path):
    suffix = f".{path}" if path else ""
    if path in ABSENT_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(f"bitmagic_tpu_torch{suffix}")
        return
    jm = importlib.import_module(f"bitmagic_tpu{suffix}")
    tm = importlib.import_module(f"bitmagic_tpu_torch{suffix}")
    for name, jv in _defined_here(jm).items():
        tv = getattr(tm, name, None)
        assert tv is not None, f"{path}.{name}"
        if inspect.isclass(jv):
            assert inspect.isclass(tv), f"{path}.{name}"
            want = {n for n in dir(jv) if not n.startswith("_")}
            absent = ABSENT_NAMES.get(f"{path}.{name}", set())
            missing = want - absent - set(dir(tv))
            assert not missing, f"{path}.{name} lacks {sorted(missing)}"
            assert not absent & set(dir(tv)), f"{path}.{name}"
        else:
            assert callable(tv), f"{path}.{name}"
