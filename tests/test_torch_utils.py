"""``bitmagic_tpu_torch.utils`` (debug, timer, golden) against the JAX
package's ``utils``, on the CPU.

The debug printers write the JAX package's text character for character
for the same vectors; the file helpers round-trip and write the same
bytes; the numpy oracle gives the same answers on the same seeded ops;
the timer accumulates its statistics and the profiler hook writes a trace
file.
"""
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.utils import debug as jdebug
from bitmagic_tpu.utils import golden as jgolden
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.ops import cuda_kernels
from bitmagic_tpu_torch.utils import debug, golden, timer
from test_torch_bitvector import assert_same_state, build_pair
from test_torch_scanner import assert_same_sv

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _vectors(pkg):
    a, b = build_pair(pkg)
    c = pkg.BitVector(40 * BPB)
    c.set_range(BPB, 3 * BPB - 1)          # FULL blocks, no run
    c.set(5 * BPB + 7)
    c.optimize()
    e = pkg.BitVector(1000)
    return {"a": a, "b": b, "c": c, "empty": e}


def _svs(pkg):
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1 << 12, 70000).astype(np.uint32)
    nulls = rng.random(70000) < 0.1
    nullable = pkg.SparseVector.from_array(vals, nullable=True,
                                           null_mask=nulls)
    signed = pkg.SparseVector.from_array(
        rng.integers(-500, 500, 3000).astype(np.int32))
    return {"nullable": nullable, "signed": signed}


@pytest.fixture(scope="module")
def pairs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbm.config, "device", "cpu")
        return ((_vectors(jbm), _svs(jbm)), (_vectors(tbm), _svs(tbm)))


def _text(fn, *args, **kw):
    out = io.StringIO()
    fn(*args, out=out, **kw)
    return out.getvalue()


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["a", "b", "c", "empty"])
def test_print_stat_text_equal(pairs, name):
    jv, tv = pairs[0][0][name], pairs[1][0][name]
    want = _text(jdebug.print_stat, jv)
    assert _text(debug.print_stat, tv) == want
    assert _text(debug.print_stat, tv, blocks=3) == \
        _text(jdebug.print_stat, jv, blocks=3)
    assert _text(debug.print_bvector_stat, tv) == \
        _text(jdebug.print_bvector_stat, jv)


def test_print_stat_covers_every_block_class(pairs):
    text = "".join(_text(debug.print_stat, pairs[1][0][k]) for k in "abc")
    for kind in ("BIT bc=", "GAP bc=", "FULL"):
        assert kind in text


def test_print_stat_counts_dense_rows_with_one_k3_call(pairs, monkeypatch):
    """The dense rows' counts come from the K3 wrapper in one call."""
    calls = []
    real = cuda_kernels.block_counts
    monkeypatch.setattr(cuda_kernels, "block_counts",
                        lambda pool: calls.append(pool.shape) or real(pool))
    v = pairs[1][0]["a"]
    text = _text(debug.print_stat, v)
    assert calls == [tuple(v._pool.shape)]
    words = v._pool_host()
    slots = v._struct.slots()
    bit = v._struct.cls == C.CLS_BIT
    want = [f"block {int(nb)}: BIT bc={int(np.bitwise_count(words[s]).sum())}"
            for nb, s in zip(v._struct.nb[bit], slots[bit])]
    assert [ln for ln in text.splitlines() if "BIT" in ln] == want


@pytest.mark.parametrize("name", ["nullable", "signed"])
def test_print_svector_stat_text_equal(pairs, name):
    jsv, tsv = pairs[0][1][name], pairs[1][1][name]
    assert _text(debug.print_svector_stat, tsv) == \
        _text(jdebug.print_svector_stat, jsv)


@pytest.mark.parametrize("level", [1, 6])
def test_compute_serialization_size(pairs, level):
    from bitmagic_tpu_torch.serial import Serializer
    from bitmagic_tpu_torch.serial.sv_serial import sparse_vector_serialize
    (jv, js), (tv, ts) = pairs
    for k in tv:
        n = debug.compute_serialization_size(tv[k], level)
        assert n == len(Serializer(level).serialize(tv[k]))
        assert n == jdebug.compute_serialization_size(jv[k], level)
    for k in ts:
        n = debug.compute_serialization_size(ts[k], level)
        assert n == len(sparse_vector_serialize(ts[k], level))
        assert n == jdebug.compute_serialization_size(js[k], level)


def test_save_load_bvector_round_trip(pairs, tmp_path, monkeypatch):
    for k, tv in pairs[1][0].items():
        path = tmp_path / f"{k}.bv"
        jpath = tmp_path / f"{k}.jax.bv"
        debug.save_bvector(path, tv)
        jdebug.save_bvector(jpath, pairs[0][0][k])
        assert path.read_bytes() == jpath.read_bytes()
        back = debug.load_bvector(path)
        assert back.equal(tv) and back.device.type == "cpu"
        assert_same_state(jdebug.load_bvector(path), back)
    # the loader puts the vector on the device it is given
    monkeypatch.setattr(tbm.config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    back = debug.load_bvector(tmp_path / "a.bv", device="cpu")
    assert back.device.type == "cpu" and back.equal(pairs[1][0]["a"])
    with pytest.raises(RuntimeError, match="cuda"):
        debug.load_bvector(tmp_path / "a.bv")


def test_save_load_svector_round_trip(pairs, tmp_path, monkeypatch):
    for k, tsv in pairs[1][1].items():
        path = tmp_path / f"{k}.sv"
        jpath = tmp_path / f"{k}.jax.sv"
        debug.file_save_svector(path, tsv, level=5)
        jdebug.file_save_svector(jpath, pairs[0][1][k], level=5)
        assert path.read_bytes() == jpath.read_bytes()
        back = debug.file_load_svector(path)
        assert back.equal(tsv)
        assert_same_sv(jdebug.file_load_svector(path), back)
    monkeypatch.setattr(tbm.config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    back = debug.file_load_svector(tmp_path / "nullable.sv", device="cpu")
    assert back.device.type == "cpu"
    assert back.equal(pairs[1][1]["nullable"])


# ---------------------------------------------------------------------------
# golden
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("style", ["uniform", "intervals", "borders"])
def test_random_indices_equal(style):
    for seed in range(3):
        want = jgolden.random_indices(np.random.default_rng(seed), 300_000,
                                      density=0.003, style=style)
        got = golden.random_indices(np.random.default_rng(seed), 300_000,
                                    density=0.003, style=style)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        golden.random_indices(np.random.default_rng(0), 10, style="nope")


def test_golden_bitset_equal_on_seeded_ops():
    rng = np.random.default_rng(21)
    size = 5 * BPB + 77
    ids = [rng.integers(0, size, 4000) for _ in range(2)]
    gs = [(jgolden.GoldenBitSet.from_indices(i, size),
           golden.GoldenBitSet.from_indices(i, size)) for i in ids]
    (ja, ta), (jb, tb) = gs
    for op in ("and_", "or_", "xor_", "sub_"):
        jx, tx = ja.copy(), ta.copy()
        getattr(jx, op)(jb)
        getattr(tx, op)(tb)
        np.testing.assert_array_equal(tx.bits, jx.bits)
    for g in (ja, ta):
        g.set(size + 40)                   # grows
        g.flip(3)
        g.set_range(100, 2 * BPB + 5)
        g.set_range(BPB, BPB + 9, False)
        g.resize(size + 100)
    np.testing.assert_array_equal(ta.bits, ja.bits)
    for q in ("count", "any", "find_reverse", "indices"):
        np.testing.assert_array_equal(getattr(ta, q)(), getattr(ja, q)())
    for i in (0, 99, BPB + 3, size + 99, size + 500):
        assert ta.test(i) == ja.test(i) and ta.find(i) == ja.find(i)
        assert ta.count_to(i) == ja.count_to(i)
        assert ta.count_range(i // 2, i) == ja.count_range(i // 2, i)
    for r in (0, 1, 77, ta.count(), ta.count() + 1):
        assert ta.select(r) == ja.select(r)
    assert ta.equal(tb) == ja.equal(jb) and ta.equal(ta.copy())
    # the JAX package's to_words reverses the bytes of each word; the
    # port's writes the containers' layout, which from_words reads back
    np.testing.assert_array_equal(ta.to_words(), ja.to_words().byteswap())
    back = golden.GoldenBitSet.from_words(ta.to_words(), ta.size)
    np.testing.assert_array_equal(back.bits, ta.bits)
    w = ta.to_words()
    np.testing.assert_array_equal(
        golden.GoldenBitSet.from_words(w).bits,
        jgolden.GoldenBitSet.from_words(w).bits)


def test_golden_words_match_the_port(pairs):
    """The oracle's word image is the port's pool layout."""
    v = pairs[1][0]["c"]
    g = golden.GoldenBitSet.from_indices(v.indices(), v.size)
    np.testing.assert_array_equal(
        g.to_words(v.size // BPB).ravel(), v.to_words().ravel())


# ---------------------------------------------------------------------------
# timer
# ---------------------------------------------------------------------------
def test_chrono_taker_statistics(pairs):
    timer.reset_statistics()
    a, b = pairs[1][0]["a"], pairs[1][0]["b"]
    for _ in range(3):
        with timer.ChronoTaker("and", repeats=2, track=a):
            r = a & b
    with timer.ChronoTaker("pool", track=[r._pool, a]):
        r.count()
    st = timer.statistics
    assert st["and"]["calls"] == 3 and st["and"]["repeats"] == 6
    assert st["pool"]["calls"] == 1 and st["pool"]["total_s"] > 0
    out = io.StringIO()
    timer.print_statistics(out)
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["and", "pool"]
    assert "3 calls" in lines[0] and "us/op" in lines[0]
    timer.reset_statistics()
    assert timer.statistics == {}


def test_chrono_taker_waits_for_the_tracked_device(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)

    class OnCard:
        device = torch.device("cuda", 0)

    with timer.ChronoTaker("card", track=OnCard()):
        pass
    with timer.ChronoTaker("cpu", track=torch.zeros(3)):
        pass
    assert waited == [torch.device("cuda", 0)]
    timer.reset_statistics()


def test_profiler_trace_writes_a_file(tmp_path, pairs):
    a, b = pairs[1][0]["a"], pairs[1][0]["b"]
    with timer.profiler_trace(str(tmp_path)):
        (a & b).count()
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
