"""The operation deserializer of the PyTorch port against the JAX package,
on the CPU.

Every SET_* and SET_COUNT_* op between a live vector and a BLOB — BMT1
(streamed, and run-coded: FULL_RUN records decode first), the reference
format (streamed through the decoder's sink, with XOR references, and with
a wide one-run) — on dense, GAP-resident and run-coded targets, on the
chunked path of a target with more than 1024 GAP blocks and through the
Python record engine; ``deserialize_range``; and the bound on host copies:
one op copies a target's pool to the host a constant number of times,
however many blocks it has.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.serial import refcodec as jrc
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from bitmagic_tpu_torch.serial import native
from bitmagic_tpu_torch.serial import opdeser as tod
from bitmagic_tpu_torch.serial import refcodec as trc
from test_torch_bitvector import assert_same_state, build_pair
from test_torch_refcodec import xor_vectors
from test_torch_serial import _gappy

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
SET_OPS = [C.SET_AND, C.SET_OR, C.SET_XOR, C.SET_SUB, C.SET_ASSIGN]
COUNT_OPS = [C.SET_COUNT, C.SET_COUNT_AND, C.SET_COUNT_XOR, C.SET_COUNT_OR,
             C.SET_COUNT_SUB_AB, C.SET_COUNT_SUB_BA, C.SET_COUNT_A,
             C.SET_COUNT_B]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _wide_run(pkg):
    """A vector whose FULL span is too wide to stream per block."""
    v = pkg.BitVector.from_indices([7, 4300 * BPB + 5], 4400 * BPB)
    v.set_range(BPB, 4200 * BPB - 1)
    return v


def _targets(pkg):
    a, b = build_pair(pkg)
    return {"gap_and_runs": a,          # GAP + BIT + a FULL run
            "dense": b,                 # BIT rows and FULL points
            "gappy": _gappy(pkg)}       # mostly GAP-resident


def _blobs(pkg, rc):
    """{name: (blob, ref_vectors)} written by ``pkg``."""
    a, b = build_pair(pkg, seed=9)
    xt, xrefs = xor_vectors(pkg, size=80 * BPB)
    return {
        "bmt1": (pkg.serialize(b), []),
        "bmt1_runs": (pkg.serialize(a), []),        # FULL_RUN records
        "ref": (rc.ref_serialize(b), []),
        "ref_xor": (rc.RefSerializer(6, ref_vectors=xrefs).serialize(xt),
                    xrefs),
        "ref_wide_run": (rc.ref_serialize(_wide_run(pkg)), []),
    }


@pytest.fixture(scope="module")
def data():
    old = tbm.config.device
    tbm.config.device = "cpu"
    try:
        return {jbm: (_targets(jbm), _blobs(jbm, jrc)),
                tbm: (_targets(tbm), _blobs(tbm, trc))}
    finally:
        tbm.config.device = old


def _run_both(data, tkind, bkind, fn):
    """fn(pkg, target copy, blob, refs) for both packages; answers and
    target states must be equal."""
    out = []
    for pkg in (jbm, tbm):
        targets, blobs = data[pkg]
        blob, refs = blobs[bkind]
        t = targets[tkind].copy()
        out.append((fn(pkg, t, blob, refs), t))
    (jr, jt), (tr, tt) = out
    assert data[jbm][1][bkind][0] == data[tbm][1][bkind][0]
    if isinstance(jr, (int, np.integer)):
        assert int(tr) == int(jr)
    assert_same_state(jt, tt)


@pytest.mark.parametrize("op", SET_OPS + COUNT_OPS)
@pytest.mark.parametrize("bkind", ["bmt1", "bmt1_runs", "ref", "ref_xor",
                                   "ref_wide_run"])
@pytest.mark.parametrize("tkind", ["gap_and_runs", "dense", "gappy"])
def test_ops_match(data, tkind, bkind, op):
    def fn(pkg, t, blob, refs):
        r = pkg.OperationDeserializer(ref_vectors=refs).deserialize(
            t, blob, op)
        return r if op in COUNT_OPS else None
    _run_both(data, tkind, bkind, fn)


@pytest.mark.parametrize("bkind", ["bmt1", "ref"])
@pytest.mark.parametrize("tkind", ["gap_and_runs", "dense"])
def test_python_record_engine(data, monkeypatch, tkind, bkind):
    """The Python record engine (taken when the native one turns a BLOB
    down) gives the native engine's answers."""
    monkeypatch.setattr(native, "bmt1_stream_op", lambda *a, **k: None)
    for op in SET_OPS[:4] + COUNT_OPS:
        def fn(pkg, t, blob, refs):
            return pkg.OperationDeserializer().deserialize(t, blob, op)
        _run_both(data, tkind, bkind, fn)


@pytest.mark.parametrize("bkind", ["bmt1", "bmt1_runs", "ref", "ref_xor"])
@pytest.mark.parametrize("empty", [False, True])
def test_deserialize_range(data, bkind, empty):
    lo, hi = 3 * BPB + 17, 66 * BPB - 5

    def fn(pkg, t, blob, refs):
        if empty:
            t.clear()
        pkg.OperationDeserializer(ref_vectors=refs).deserialize_range(
            t, blob, lo, hi)
    _run_both(data, "gap_and_runs", bkind, fn)


def _chunked(pkg):
    rng = np.random.default_rng(31)
    size = 1100 * BPB
    t = pkg.BitVector.from_indices(rng.integers(0, size, 3000), size,
                                   strategy=C.BM_GAP)
    src = pkg.BitVector.from_indices(rng.integers(0, size, 4000), size)
    src.set_range(10 * BPB, 12 * BPB + 99)
    return t, src


def test_chunked_gap_target():
    """A target of more than 1024 GAP blocks streams in windows of
    _CHUNK records; its results stay succinct and equal the JAX
    package's."""
    jt, jsrc = _chunked(jbm)
    tt, tsrc = _chunked(tbm)
    assert tt._gaps.n_blocks > 1024
    blob = tbm.serialize(tsrc)
    assert blob == jbm.serialize(jsrc)
    for op in SET_OPS[:4]:
        a, b = jt.copy(), tt.copy()
        jbm.OperationDeserializer().deserialize(a, blob, op)
        tbm.OperationDeserializer().deserialize(b, blob, op)
        assert_same_state(a, b)
        assert int((b._struct.cls == C.CLS_BIT).sum()) <= tod._CHUNK
    for op in COUNT_OPS:
        assert tbm.OperationDeserializer().deserialize(tt.copy(), blob, op) \
            == jbm.OperationDeserializer().deserialize(jt.copy(), blob, op)


def _dense_target(n_blocks):
    rng = np.random.default_rng(n_blocks)
    ids = rng.integers(0, n_blocks * BPB, n_blocks * 3000)
    t = tbm.BitVector.from_indices(ids, (n_blocks + 8) * BPB)
    assert int((t._struct.cls == C.CLS_BIT).sum()) >= 64
    return t


def test_bounded_host_copies(monkeypatch):
    """One op copies the target's pool to the host a bounded number of
    times, whatever its number of blocks — on every streamed path,
    the reference format's per-block target reads included."""
    calls = []
    orig = blockops.to_host_words
    monkeypatch.setattr(blockops, "to_host_words",
                        lambda t: calls.append(t.shape[0]) or orig(t))
    src = tbm.BitVector.from_indices(
        np.random.default_rng(1).integers(0, 200 * BPB, 50_000), 200 * BPB)
    blobs = {"bmt1": tbm.serialize(src), "ref": trc.ref_serialize(src)}
    seen = {}
    for n_blocks in (64, 160):
        target = _dense_target(n_blocks)
        for name, blob in blobs.items():
            for op in (C.SET_AND, C.SET_OR, C.SET_COUNT_AND,
                       C.SET_COUNT_OR):
                calls.clear()
                tbm.OperationDeserializer().deserialize(target.copy(), blob,
                                                        op)
                seen.setdefault((name, op), []).append(len(calls))
                assert len(calls) <= 1, (name, op, n_blocks, calls)
    for counts in seen.values():
        assert counts[0] == counts[1]


@pytest.mark.cuda
def test_kernels_on_the_card():
    """On the card the slice's paths launch K1 (deserialize_range), K2
    (COUNT_AND on a run-coded BLOB) and K3 (pass-through counts), and
    their answers equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    a, b = build_pair(tbm)
    blob_runs = tbm.serialize(a)
    blob = tbm.serialize(b)
    ga, gb = (tbm.deserialize(x, device="cuda") for x in (blob_runs, blob))
    want_cnt = tbm.OperationDeserializer().deserialize(b.copy(), blob_runs,
                                                       C.SET_COUNT_AND)
    ck.reset_launches()
    got = tbm.OperationDeserializer().deserialize(gb.copy(), blob_runs,
                                                  C.SET_COUNT_AND)
    assert got == want_cnt and ck.launches["count_op"] >= 1
    ck.reset_launches()
    got = tbm.OperationDeserializer().deserialize(ga.copy(), blob,
                                                  C.SET_COUNT_OR)
    assert got == tbm.OperationDeserializer().deserialize(
        a.copy(), blob, C.SET_COUNT_OR)
    assert ck.launches["block_counts"] >= 1
    ck.reset_launches()
    t = ga.copy()
    tbm.OperationDeserializer().deserialize_range(t, blob, BPB, 30 * BPB)
    w = a.copy()
    tbm.OperationDeserializer().deserialize_range(w, blob, BPB, 30 * BPB)
    assert ck.launches["logical_op_digest"] >= 1
    np.testing.assert_array_equal(t.indices(), w.indices())
