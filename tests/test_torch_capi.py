"""C-API facade of the PyTorch port (``bitmagic_tpu_torch.capi``) against
the JAX package's (``bitmagic_tpu.capi``), on the CPU.

The same ``BM_*`` calls on the same numpy-seeded handles go to both
facades: every error code and every result must be equal, bit for bit
(vectors through their full state: blocks, dense rows, GAP arrays; BLOBs
byte for byte), and so must the handles the calls wrote to.  The error
paths (out-of-range indexes, writes to a frozen copy, malformed BLOBs)
return the same codes, or raise the same exception where the JAX facade
lets one through.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu import capi as jcapi
from bitmagic_tpu_torch import capi as tcapi
from bitmagic_tpu_torch import constants as C
from test_capi import REFERENCE_FUNCTIONS
from test_torch_bitvector import SIZE, assert_same_state, build_pair

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
CODES = ("BM_OK", "BM_ERR_BADALLOC", "BM_ERR_BADARG", "BM_ERR_RANGE",
         "BM_ERR_CPU", "BM_ERR_SERIALFORMAT", "BM_ERR_BAD_VALUE",
         "BM_ERR_RANK_SELECT_IDX_MISSING", "BM_ERR_DETACHED",
         "BM_ERR_JVM_NOT_SUPPORTED", "BM_ERR_JVM_OUT_OF_MEMORY")
OOR = 1 << 49                   # past every vector's size


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _ids(seed=11):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, SIZE, 3000),
                           rng.integers(3 * BPB, 4 * BPB, 20000),
                           [0, BPB - 1, BPB, SIZE - 1]])


def _handles(capi, pkg):
    """a, b: BIT / GAP / FULL-run mixes; c: built through the facade from
    seeded ids; e: empty."""
    a, b = build_pair(pkg)
    _, c = capi.BM_bvector_construct(SIZE)
    assert capi.BM_bvector_set_bits(c, _ids()) == capi.BM_OK
    _, e = capi.BM_bvector_construct(SIZE)
    return {"a": a, "b": b, "c": c, "e": e}


@pytest.fixture(scope="module")
def base():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbm.config, "device", "cpu")
        return _handles(jcapi, jbm), _handles(tcapi, tbm)


def same(j, t, what):
    """Equal results, bit for bit; vectors through their full state."""
    if isinstance(j, jbm.BitVector):
        assert isinstance(t, tbm.BitVector), what
        assert j.is_ro() == t.is_ro(), what
        assert_same_state(j, t)
    elif isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)) and len(t) == len(j), what
        for k, (x, y) in enumerate(zip(j, t)):
            same(x, y, f"{what}[{k}]")
    elif isinstance(j, dict):
        assert set(t) == set(j), what
        for k in j:
            same(j[k], t[k], f"{what}[{k!r}]")
    elif isinstance(j, np.ndarray):
        np.testing.assert_array_equal(t, j, err_msg=what)
    elif isinstance(j, (bytes, bytearray)):
        assert isinstance(t, (bytes, bytearray)) and bytes(t) == bytes(j), \
            what
    else:
        assert type(t) is type(j) or (np.isscalar(t) and np.isscalar(j)), \
            (what, type(j), type(t))
        assert t == j, (what, j, t)


def _run(scenario, base):
    """Run ``scenario(capi, handles)`` on copies of both packages' handles;
    the results and the handles afterwards must be equal."""
    out = []
    for capi, hs in ((jcapi, base[0]), (tcapi, base[1])):
        h = {k: v.copy() for k, v in hs.items()}
        res = scenario(capi, h)
        out.append((res, h))
    (jr, jh), (tr, th) = out
    for k, (x, y) in enumerate(zip(jr, tr)):
        same(x[1], y[1], x[0])
        assert x[0] == y[0]
    assert len(jr) == len(tr)
    same(jh, th, "handles")


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------
def test_surface_complete():
    missing = [f for f in REFERENCE_FUNCTIONS if not hasattr(tcapi, f)]
    assert not missing, missing


def test_same_functions_as_the_jax_facade():
    def names(m):
        return {n for n in dir(m) if n.startswith("BM_")
                and callable(getattr(m, n))}
    assert names(tcapi) == names(jcapi)
    assert len(names(tcapi)) == 82


@pytest.mark.parametrize("code", CODES)
def test_error_codes_and_messages(code):
    assert getattr(tcapi, code) == getattr(jcapi, code)
    v = getattr(tcapi, code)
    assert tcapi.BM_error_msg(v) == jcapi.BM_error_msg(v)


def test_error_code_numbering():
    # numbering pinned to lang-maps/libbm/include/libbm.h:28-40
    assert tuple(getattr(tcapi, c) for c in CODES[:8]) == tuple(range(8))
    assert tuple(getattr(tcapi, c) for c in CODES[8:]) == (101, 102, 103)
    assert tcapi.BM_error_msg(9999) == jcapi.BM_error_msg(9999)
    assert tcapi.BM_error_msg(9999).startswith("BM-XX")


def test_version_init_and_simd():
    assert tcapi.BM_version() == jcapi.BM_version()
    assert tcapi.BM_init() == jcapi.BM_init() == tcapi.BM_OK
    assert tcapi.BM_init(None) == tcapi.BM_OK
    # each facade reports its own backend
    assert tcapi.BM_simd_version() == (tcapi.BM_OK, tbm.simd_version())
    assert tcapi.BM_simd_version()[0] == jcapi.BM_simd_version()[0]


def test_construct_builds_on_the_configured_device(monkeypatch):
    err, bv = tcapi.BM_bvector_construct(1000)
    assert err == tcapi.BM_OK and bv.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbm.config, "device", "cuda")
    # no card: the constructor's error comes back as a code, never a
    # vector on the CPU
    err, bv = tcapi.BM_bvector_construct(1000)
    assert err == tcapi.BM_ERR_BADARG and bv is None


# ---------------------------------------------------------------------------
# every BM_* function on the same handles
# ---------------------------------------------------------------------------
def sc_construct(capi, h):
    r = [("construct", capi.BM_bvector_construct(SIZE)),
         ("construct_default", capi.BM_bvector_construct()),
         ("construct_copy", capi.BM_bvector_construct_copy(h["a"]))]
    err, ro = capi.BM_bvector_construct_copy_ro(h["a"])
    r += [("copy_ro", (err, ro)), ("is_ro", capi.BM_bvector_is_ro(ro)),
          ("copy_rw", capi.BM_bvector_construct_copy_rw(ro)),
          ("init", capi.BM_bvector_init(h["c"])),
          ("free", capi.BM_bvector_free(h["c"])),
          ("capacity", capi.BM_bvector_get_capacity(h["b"])),
          ("size", capi.BM_bvector_get_size(h["b"])),
          ("set_size", capi.BM_bvector_set_size(h["c"], SIZE - 5 * BPB)),
          ("size_after", capi.BM_bvector_get_size(h["c"])),
          ("grow", capi.BM_bvector_set_size(h["e"], 2 * SIZE)),
          ("swap", capi.BM_bvector_swap(h["a"], h["b"]))]
    return r


def sc_bits(capi, h):
    c = h["c"]
    r = [("set_bit", capi.BM_bvector_set_bit(c, 7 * BPB + 3)),
         ("set_bit_false", capi.BM_bvector_set_bit(c, 0, False)),
         ("no_check", capi.BM_bvector_set_bit_no_check(c, 9 * BPB)),
         ("clear_bit", capi.BM_bvector_clear_bit(c, BPB)),
         ("flip_on", capi.BM_bvector_flip_bit(c, 11)),
         ("flip_off", capi.BM_bvector_flip_bit(c, 11)),
         ("flip_again", capi.BM_bvector_flip_bit(c, 3 * BPB + 100))]
    for i, val, cond in ((20, True, False), (20, True, True),
                         (BPB - 1, False, True), (21, False, False)):
        r.append(("conditional", capi.BM_bvector_set_bit_conditional(
            c, i, val, cond)))
    for i in (30, 30, 31, BPB - 1):
        r.append(("inc_bit", capi.BM_bvector_inc_bit(c, i)))
    for i in (0, 20, 30, BPB, SIZE - 1, OOR):
        r.append(("get_bit", capi.BM_bvector_get_bit(c, i)))
    rng = np.random.default_rng(3)
    r += [("set_bits", capi.BM_bvector_set_bits(
              h["e"], rng.integers(0, SIZE, 5000))),
          ("set_range", capi.BM_bvector_set_range(h["e"], 100, 3 * BPB + 7)),
          ("clear_range", capi.BM_bvector_set_range(h["e"], 5 * BPB,
                                                     5 * BPB + 900, False)),
          ("invert", capi.BM_bvector_invert(h["a"])),
          ("clear", capi.BM_bvector_clear(h["b"])),
          ("clear_keep", capi.BM_bvector_clear(h["c"], False)),
          ("set_all", capi.BM_bvector_set(h["c"])),
          ("swap_bits", capi.BM_bvector_swap_bits(h["e"], 100, 4 * BPB)),
          ("swap_bits_same", capi.BM_bvector_swap_bits(h["e"], 101, 102))]
    prev = 0
    for _ in range(6):
        err, prev = capi.BM_bvector_extract_next(h["e"], prev)
        r.append(("extract_next", (err, prev)))
    return r


def sc_counts(capi, h):
    a, b, c, e = h["a"], h["b"], h["c"], h["e"]
    r = [(f"count_{k}", capi.BM_bvector_count(v)) for k, v in h.items()]
    r += [(f"any_{k}", capi.BM_bvector_any(v)) for k, v in h.items()]
    for lo, hi in ((0, SIZE - 1), (5, 3 * BPB + 17), (21 * BPB + 3, 65 * BPB),
                   (50, 10), (-5, 3), (10, OOR)):
        r += [("count_range", capi.BM_bvector_count_range(v, lo, hi))
              for v in (a, b, c)]
    for x, y in ((a, b), (b, a), (a, c), (a, e), (e, e)):
        for op in ("AND", "OR", "XOR", "SUB"):
            r.append((f"count_{op}", getattr(capi, f"BM_bvector_count_{op}")(
                x, y)))
            r.append((f"any_{op}", getattr(capi, f"BM_bvector_any_{op}")(
                x, y)))
    return r


def sc_find(capi, h):
    a, b, c, e = h["a"], h["b"], h["c"], h["e"]
    r = []
    for v in (a, b, c, e):
        for k in (0, 1, BPB - 1, 12 * BPB + 5, 65 * BPB, SIZE - 1, SIZE):
            r.append(("find", capi.BM_bvector_find(v, k)))
        r += [("find_reverse", capi.BM_bvector_find_reverse(v)),
              ("get_first", capi.BM_bvector_get_first(v))]
        pos = 0
        for _ in range(5):
            err, found, pos = capi.BM_bvector_get_next(v, pos)
            r.append(("get_next", (err, found, pos)))
        n = capi.BM_bvector_count(v)[1]
        for rank in (0, 1, 2, n // 3, n, n + 1):
            r += [("select", capi.BM_bvector_select(v, rank)),
                  ("find_rank", capi.BM_bvector_find_rank(v, rank, 0)),
                  ("find_rank_from", capi.BM_bvector_find_rank(
                      v, rank, 3 * BPB + 11))]
        for i in (0, 77, 3 * BPB + 5, 30 * BPB, SIZE - 1, OOR):
            r += [("rank", capi.BM_bvector_rank(v, i)),
                  ("rank_corrected", capi.BM_bvector_rank_corrected(v, i))]
    for x, y in ((a, b), (b, a), (a, c), (c, e), (e, e)):
        r.append(("mismatch", capi.BM_bvector_find_first_mismatch(x, y)))
    r.append(("mismatch_copy", capi.BM_bvector_find_first_mismatch(
        a, a.copy())))
    return r


def sc_compare(capi, h):
    a, b, c, e = h["a"], h["b"], h["c"], h["e"]
    r = []
    for x, y in ((a, b), (b, a), (a, a.copy()), (c, e), (e, c), (e, e)):
        r += [("compare", capi.BM_bvector_compare(x, y)),
              ("equal", capi.BM_bvector_equal(x, y))]
    return r


def _combine(op):
    def sc(capi, h):
        a, b, c, e = h["a"], h["b"], h["c"], h["e"]
        code = {"AND": 0, "OR": 1, "SUB": 2, "XOR": 3}[op]
        r = [("2sc", getattr(capi, f"BM_bvector_combine_{op}_2sc")(
                 e, a, b)),
             ("2sc_compress", getattr(capi, f"BM_bvector_combine_{op}_2sc")(
                 c, b, a, True)),
             ("combine", getattr(capi, f"BM_bvector_combine_{op}")(a, b))]
        x = b.copy()
        r.append(("operation", capi.BM_bvector_combine_operation(x, a, code)))
        r.append(("bad_opcode", capi.BM_bvector_combine_operation(x, a, 9)))
        arr = np.random.default_rng(5).integers(0, SIZE, 4000)
        arr = np.concatenate([arr, arr[:50], [7, 3 * BPB + 1]])
        r.append(("arr", getattr(capi, f"BM_bvector_combine_{op}_arr")(
            b, arr)))
        if op == "AND":
            r.append(("arr_sorted", capi.BM_bvector_combine_AND_arr_sorted(
                h["c"], np.sort(np.unique(arr)))))
        return r
    return sc


def sc_merge_shift(capi, h):
    return [("merge", capi.BM_bvector_merge(h["a"], h["c"])),
            ("merge_empty", capi.BM_bvector_merge(h["e"], h["b"])),
            ("rshift1", capi.BM_bvector_rshift1(h["b"])),
            ("rshift1_again", capi.BM_bvector_rshift1(h["b"])),
            ("rshift1_c", capi.BM_bvector_rshift1(h["c"]))]


def sc_optimize(capi, h):
    r = [("calc_stat", capi.BM_bvector_calc_stat(h["a"])),
         ("statistics", capi.BM_bvector_statistics(h["c"])),
         ("optimize", capi.BM_bvector_optimize(h["a"])),
         ("optimize_free0", capi.BM_bvector_optimize(h["b"], C.OPT_FREE_0)),
         ("optimize_c", capi.BM_bvector_optimize(h["c"])),
         ("statistics_after", capi.BM_bvector_statistics(h["c"])),
         ("freeze", capi.BM_bvector_freeze(h["b"])),
         ("is_ro", capi.BM_bvector_is_ro(h["b"])),
         ("is_ro_a", capi.BM_bvector_is_ro(h["a"])),
         ("count_frozen", capi.BM_bvector_count(h["b"]))]
    return r


def sc_serialize(capi, h):
    r = []
    blobs = {}
    for k in ("a", "b", "c", "e"):
        for level in (0, 1, 3, 6):
            err, blob = capi.BM_bvector_serialize(h[k], level)
            blobs[k, level] = blob
            r.append((f"serialize_{k}_{level}", (err, blob)))
        r.append((f"deserialize_{k}", capi.BM_bvector_deserialize(
            blobs[k, 6])))
        r.append((f"deserialize_{k}_array", capi.BM_bvector_deserialize(
            np.frombuffer(blobs[k, 1], np.uint8))))
    for op in range(C.SET_AND, C.SET_COUNT_B + 1):
        for k in ("b", "c"):
            r.append((f"opdeser_{op}_{k}", capi.BM_bvector_operation_deserialize(
                h["a"].copy(), blobs[k, 6], op)))
    r.append(("opdeser_into_c", capi.BM_bvector_operation_deserialize(
        h["c"], blobs["a", 3], C.SET_OR)))
    return r


def sc_enumerator(capi, h):
    r = []
    err, it = capi.BM_bvector_enumerator_construct(h["c"], 3 * BPB)
    r.append(("construct_err", err))
    walk = []
    while True:
        step = capi.BM_bvector_enumerator_next(it)
        walk.append(step)
        if not step[1]:
            break
    r.append(("walk", walk))
    err, it = capi.BM_bvector_enumerator_construct(h["a"])
    r.append(("walk_a", [capi.BM_bvector_enumerator_next(it)
                         for _ in range(300)]))
    for v, pos in ((h["a"], 0), (h["a"], 21 * BPB - 7), (h["c"], 17),
                   (h["e"], 0), (h["b"], SIZE)):
        err, en = capi.BM_bvector_enumerator_construct_from(v, pos)
        r += [("from_err", err),
              ("is_valid", capi.BM_bvector_enumerator_is_valid(en)),
              ("get_value", capi.BM_bvector_enumerator_get_value(en))]
        r += [("next_value", capi.BM_bvector_enumerator_next_value(en))
              for _ in range(40)]
        for p in (5, 20 * BPB, 40 * BPB + 3, 62 * BPB, SIZE - 2, SIZE + 9):
            r += [("goto", capi.BM_bvector_enumerator_goto(en, p)),
                  ("value", capi.BM_bvector_enumerator_get_value(en))]
        r.append(("free", capi.BM_bvector_enumerator_free(en)))
    return r


def sc_error_paths(capi, h):
    c = h["c"]
    good = capi.BM_bvector_serialize(c)[1]
    r = [("set_bit_oor", capi.BM_bvector_set_bit(c, OOR)),
         ("set_bit_neg", capi.BM_bvector_set_bit(c, -5)),
         ("clear_bit_oor", capi.BM_bvector_clear_bit(c, SIZE)),
         ("flip_oor", capi.BM_bvector_flip_bit(c, OOR)),
         ("inc_oor", capi.BM_bvector_inc_bit(c, OOR)),
         ("conditional_oor", capi.BM_bvector_set_bit_conditional(
             c, OOR, True, False)),
         ("set_bits_oor", capi.BM_bvector_set_bits(c, [1, OOR])),
         ("set_bits_neg", capi.BM_bvector_set_bits(c, [-3])),
         ("set_range_oor", capi.BM_bvector_set_range(c, 10, OOR)),
         ("arr_oor", capi.BM_bvector_combine_OR_arr(c, [1, 2, OOR])),
         ("arr_neg", capi.BM_bvector_combine_XOR_arr(c, [-1, 2])),
         ("serialize_level", capi.BM_bvector_serialize(c, 9)),
         ("bad_magic", capi.BM_bvector_deserialize(b"XXXX" + good[4:])),
         ("opdeser_garbage", capi.BM_bvector_operation_deserialize(
             h["a"], b"garbage!", C.SET_OR)),
         ("opdeser_truncated", capi.BM_bvector_operation_deserialize(
             h["a"], good[:len(good) // 2], C.SET_AND)),
         ("opdeser_bad_op", capi.BM_bvector_operation_deserialize(
             h["a"], good, 99))]
    err, ro = capi.BM_bvector_construct_copy_ro(c)
    r += [("ro_set_bit", capi.BM_bvector_set_bit(ro, 3)),
          ("ro_set_bits", capi.BM_bvector_set_bits(ro, [3, 4])),
          ("ro_combine", capi.BM_bvector_combine_OR(ro, h["a"])),
          ("ro_2sc", capi.BM_bvector_combine_AND_2sc(ro, h["a"], h["b"])),
          ("ro_arr", capi.BM_bvector_combine_SUB_arr(ro, [1, 2])),
          ("ro_extract", capi.BM_bvector_extract_next(ro, 0)),
          ("ro_swap_bits", capi.BM_bvector_swap_bits(ro, 1, 2)),
          ("ro_invert", capi.BM_bvector_invert(ro)),
          ("ro_opdeser", capi.BM_bvector_operation_deserialize(
              ro, good, C.SET_OR)),
          ("ro_after", ro)]
    return r


SCENARIOS = {"construct": sc_construct, "bits": sc_bits,
             "counts": sc_counts, "find": sc_find, "compare": sc_compare,
             "merge_shift": sc_merge_shift, "optimize": sc_optimize,
             "serialize": sc_serialize, "enumerator": sc_enumerator,
             "error_paths": sc_error_paths}
SCENARIOS.update({f"combine_{op}": _combine(op)
                  for op in ("AND", "OR", "SUB", "XOR")})


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_codes_and_results(name, base):
    _run(SCENARIOS[name], base)


class _Recorder:
    """The facade, noting the name of every function fetched from it."""

    def __init__(self, capi):
        self._capi, self.seen = capi, set()

    def __getattr__(self, name):
        if name.startswith("BM_bvector") or name in (
                "BM_version", "BM_init", "BM_simd_version", "BM_error_msg"):
            self.seen.add(name)
        return getattr(self._capi, name)


def test_every_function_is_driven(base):
    """The scenarios, with the calls of the surface tests above, reach
    every BM_* function of the facade."""
    rec = _Recorder(tcapi)
    for scenario in SCENARIOS.values():
        scenario(rec, {k: v.copy() for k, v in base[1].items()})
    rec.BM_version, rec.BM_init, rec.BM_simd_version, rec.BM_error_msg
    funcs = {n for n in dir(tcapi) if n.startswith("BM_")
             and callable(getattr(tcapi, n))}
    assert funcs - rec.seen == set()


@pytest.mark.parametrize("blob", [b"", b"garbage!", b"BM"],
                         ids=["empty", "garbage", "short"])
def test_malformed_blob_raises_alike(blob, base):
    """A BLOB too short for its header: both facades let the same exception
    through, or return the same code."""
    out = []
    for capi in (jcapi, tcapi):
        try:
            out.append(capi.BM_bvector_deserialize(blob)[0])
        except Exception as e:       # noqa: BLE001 — compared below
            out.append(type(e).__name__)
    assert out[0] == out[1]
    good = tcapi.BM_bvector_serialize(base[1]["c"])[1]
    for cut in (1, 7, len(good) // 2, len(good) - 1):
        got = []
        for capi in (jcapi, tcapi):
            try:
                got.append(capi.BM_bvector_deserialize(good[:cut])[0])
            except Exception as e:   # noqa: BLE001 — compared below
                got.append(type(e).__name__)
        assert got[0] == got[1], cut
