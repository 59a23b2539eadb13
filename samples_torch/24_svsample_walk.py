"""One-to-one walk of the reference's svsample01-10, rscsample01-06 and
strsvsample01-08 programs (samples/readme in the reference tree).

Like 23_bvsample_walk.py for the bvector family: each function mirrors
the API surface its reference sample demonstrates, through this
package's public exports, so a reference user can find every
svsampleNN / rscsampleNN / strsvsampleNN flow by name.

Run: python samples_torch/24_svsample_walk.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402
import bitmagic_tpu_torch.serial as serial  # noqa: E402


# ------------------------------------------------------------------ sv
def svsample01():
    """sparse_vector<> basics: set/get/size (svsample01)."""
    sv = bm.SparseVector(dtype=np.uint32)
    sv.set(0, 17)
    sv.set(5, 1000)
    sv.push_back(42)
    assert len(sv) == 7            # size is a property here
    assert sv.get(5) == 1000 and sv.at(6) == 42
    assert sv.get(3) == 0                     # unassigned reads as 0


def svsample02():
    """Serialization + XOR compression + read-only deserialization
    (svsample02)."""
    sv = bm.SparseVector.from_array(np.arange(0, 100000, 3, dtype=np.uint32))
    blob = serial.sparse_vector_serialize(sv, level=6)
    back = serial.sparse_vector_deserialize(blob)
    assert back.equal(sv)
    # XOR compression across a frame of similar vectors
    svs = [sv, bm.SparseVector.from_array(
        np.arange(0, 100000, 3, dtype=np.uint32) + 1)]
    frame = serial.serialize_group([s.planes[0] for s in svs])
    planes = serial.deserialize_group(frame)
    assert planes[0].equal(svs[0].planes[0])
    back.freeze()                             # read-only succinct vector
    assert back.is_ro() and back.get(3) == 9


def svsample03():
    """import / join / extract (svsample03)."""
    a = bm.SparseVector.from_array(np.asarray([1, 2, 3], np.uint32))
    b = bm.SparseVector()
    b.import_values(np.asarray([0, 0, 0, 40, 50], np.uint32))
    a.join(b)                                 # plane-wise OR, ref semantics
    assert len(a) == 5 and a.get(3) == 40
    ext = a.extract(2, offset=3)              # (n, offset)
    assert ext.tolist() == [40, 50]


def svsample04():
    """NULL-able vectors and values (svsample04)."""
    sv = bm.SparseVector.from_array(
        np.asarray([10, 0, 30], np.uint32),
        null_mask=np.asarray([False, True, False]))   # True = NULL
    assert sv.is_nullable()
    assert sv.is_null(1) and not sv.is_null(0)
    ok, v = sv.try_get(1)
    assert not ok
    sv.set_null(0)
    assert sv.is_null(0)


def svsample05():
    """set2set transformation (image of a set through a translation
    function) (svsample05)."""
    remap = bm.SparseVector.from_array(
        np.asarray([100, 200, 300, 400], np.uint32))
    src = bm.BitVector.from_indices([1, 3], size=10)
    img = bm.set2set_transform(remap, src)
    assert sorted(img.indices().tolist()) == [200, 400]


def svsample06():
    """Back-insert iterator, const_iterator, scanner search
    (svsample06)."""
    sv = bm.SparseVector()
    bi = sv.get_back_inserter()
    for v in (25, 35, 35, 40):
        bi.add(v)
    bi.flush()
    it = sv.get_const_iterator(0)
    assert list(it) == [25, 35, 35, 40]
    sc = bm.SparseVectorScanner()
    hits = sc.find_eq(sv, 35)
    assert sorted(hits.indices().tolist()) == [1, 2]


def svsample07():
    """Insertion sort via scanner lower_bound (svsample07)."""
    sv = bm.SparseVector()
    sc = bm.SparseVectorScanner()
    for v in (50, 10, 30, 20, 40, 10):
        pos = sc.lower_bound(sv, v)
        sv.insert(pos, v)
    assert sv.decode(0, len(sv)).tolist() == [10, 10, 20, 30, 40, 50]


def svsample08():
    """Range + gather deserialization of a sparse_vector BLOB
    (svsample08)."""
    data = np.arange(1000, dtype=np.uint32) * 7
    sv = bm.SparseVector.from_array(data)
    blob = serial.sparse_vector_serialize(sv)
    d = serial.SparseVectorDeserializer()
    rng = d.deserialize_range(blob, 100, 199)
    assert rng.decode(100, 100).tolist() == (data[100:200]).tolist()
    gat = d.deserialize_gather(blob, np.asarray([5, 500, 999]))
    assert [gat.get(i) for i in (5, 500, 999)] == [35, 3500, 6993]


def svsample09():
    """sparse_vector_find_first_mismatch (svsample09)."""
    from bitmagic_tpu_torch.sv.algo import find_first_mismatch
    a = bm.SparseVector.from_array(np.asarray([1, 2, 3, 4], np.uint32))
    b = bm.SparseVector.from_array(np.asarray([1, 2, 9, 4], np.uint32))
    assert find_first_mismatch(a, b) == 2


def svsample10():
    """Ordered searches: find_gt/ge/lt/le/range (svsample10)."""
    sv = bm.SparseVector.from_array(
        np.asarray([5, 15, 25, 35, 45], np.int32))
    sc = bm.SparseVectorScanner()
    assert sorted(sc.find_gt(sv, 25).indices().tolist()) == [3, 4]
    assert sorted(sc.find_ge(sv, 25).indices().tolist()) == [2, 3, 4]
    assert sorted(sc.find_lt(sv, 15).indices().tolist()) == [0]
    assert sorted(sc.find_range(sv, 15, 35).indices().tolist()) == [1, 2, 3]


# ------------------------------------------------------------------ rsc
def rscsample01():
    """rsc_sparse_vector<> basics: load, unload, serialize
    (rscsample01)."""
    rsc = bm.RSCSparseVector()
    rsc.set(10, 7)
    rsc.set(100, 8)
    rsc.set(200, 9)
    assert rsc.at(100) == 8 and rsc.is_null(50)
    assert rsc.count() == 3                   # assigned elements
    blob = serial.serialize_rsc_blob(rsc)
    back = serial.deserialize_rsc_blob(blob)
    assert back.equal(rsc)


def rscsample02():
    """RSC back-insert iterator + gather / range deserialization
    (rscsample02)."""
    rsc = bm.RSCSparseVector()
    bi = rsc.get_back_inserter()
    for i in range(0, 1000, 10):
        bi.add(i * 3)
        for _ in range(9):
            bi.add_null()
    bi.flush()
    assert rsc.at(20) == 60
    got = rsc.gather(np.asarray([0, 10, 20]))
    assert got.tolist() == [0, 30, 60]


def rscsample03():
    """RSC const_iterator (rscsample03)."""
    rsc = bm.RSCSparseVector()
    rsc.set(1, 10)
    rsc.set(3, 30)
    it = rsc.get_const_iterator(0)
    seen = []
    while it.valid():
        seen.append(None if it.is_null() else int(it.value()))
        if not it.advance():
            break
    assert seen[:4] == [None, 10, None, 30]


def rscsample04():
    """Known-NOT-NULL construction + fast set()/inc() in sync mode
    (rscsample04)."""
    rsc = bm.RSCSparseVector()
    for i in (2, 5, 7):                       # known NOT-NULL positions
        rsc.set(i, 0)
    rsc.sync()                                # rank-select index mode
    rsc.set(2, 100)
    rsc.inc(5)
    rsc.inc(5)
    assert rsc.at(2) == 100 and rsc.at(5) == 2 and rsc.at(7) == 0


def rscsample05():
    """Serialize a data-frame of vectors with XOR compression
    (rscsample05)."""
    base = np.arange(0, 65536 * 2, 2, dtype=np.uint32)
    sv1 = bm.SparseVector.from_array(base)
    sv2 = bm.SparseVector.from_array(base + 4)  # XOR-similar planes
    frame = [p for s in (sv1, sv2) for p in s.planes if p is not None]
    blob = serial.serialize_group(frame)
    planes = serial.deserialize_group(blob)
    assert planes[0].equal(frame[0]) and planes[-1].equal(frame[-1])


def rscsample06():
    """RSC gather in random / sorted order (rscsample06)."""
    rsc = bm.RSCSparseVector()
    for i in range(0, 100, 7):
        rsc.set(i, i + 1)
    got = rsc.gather(np.asarray([14, 0, 70]))   # unsorted ids
    assert got.tolist() == [15, 1, 71]


# ------------------------------------------------------------------ strsv
def strsvsample01():
    """str_sparse_vector<> basics: add values, optimize, iterate
    (strsvsample01)."""
    ssv = bm.StrSparseVector()
    for s in ("red", "green", "blue"):
        ssv.push_back(s)
    ssv.optimize()
    assert ssv.get(1) == "green"
    it = ssv.get_const_iterator(0)
    assert list(it) == ["red", "green", "blue"]


def strsvsample02():
    """Insertion sort with scanner lower_bound_str (strsvsample02)."""
    ssv = bm.StrSparseVector()
    sc = bm.SparseVectorScanner()
    for s in ("pear", "apple", "plum", "banana"):
        pos = sc.lower_bound_str(ssv, s)
        ssv.insert(pos, s)
    assert [ssv.get(i) for i in range(4)] == [
        "apple", "banana", "pear", "plum"]


def strsvsample02a():
    """Sort in compressed (remapped read-only) mode via comparator
    (strsvsample02a)."""
    ssv = bm.StrSparseVector.from_strings(["kiwi", "apple", "mango"])
    ssv.remap()
    ssv.freeze()
    order = sorted(range(3), key=lambda i: ssv.get(i))
    assert [ssv.get(i) for i in order] == ["apple", "kiwi", "mango"]
    assert ssv.compare(1, "apple") == 0       # frozen compare works


def strsvsample03():
    """Back inserter + remap + serialization to disk (strsvsample03)."""
    import tempfile
    ssv = bm.StrSparseVector()
    bi = ssv.get_back_inserter()
    for s in ("NC_000001", "NC_000002", "NC_000003"):
        bi.add(s)
    bi.flush()
    ssv.remap()
    blob = serial.sparse_vector_serialize(ssv)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(bytes(blob))
        path = f.name
    back = serial.sparse_vector_deserialize(np.fromfile(path, np.uint8))
    os.unlink(path)
    assert [back.get(i) for i in range(3)] == [
        "NC_000001", "NC_000002", "NC_000003"]


def strsvsample04():
    """NULL values in str vectors (strsvsample04)."""
    ssv = bm.StrSparseVector(nullable=True)
    ssv.push_back("one")
    ssv.push_back_null()
    ssv.push_back("three")
    assert ssv.is_null(1) and not ssv.is_null(2)
    assert ssv.get(2) == "three"


def strsvsample05():
    """Selective (gather) + range deserialization with bookmarks
    (strsvsample05)."""
    words = [f"w{i:05d}" for i in range(2000)]
    ssv = bm.StrSparseVector.from_strings(words)
    blob = serial.sparse_vector_serialize(ssv)
    d = serial.SparseVectorDeserializer()
    rng = d.deserialize_range(blob, 100, 120)
    assert rng.get(110) == "w00110"
    gat = d.deserialize_gather(blob, np.asarray([3, 1500]))
    assert gat.get(1500) == "w01500"


def strsvsample06():
    """const_iterator substring mode + scanner search over result-set
    (strsvsample06)."""
    ssv = bm.StrSparseVector.from_strings(
        ["chr1:100", "chr2:200", "chr1:300"])
    it = ssv.get_const_iterator(0)
    it.set_substr(0, 4)                       # leading 4 chars only
    assert list(it) == ["chr1", "chr2", "chr1"]
    sc = bm.SparseVectorScanner()
    hits = sc.find_eq_str(ssv, "chr2:200")
    assert hits.indices().tolist() == [1]


def strsvsample07():
    """Scanner pipeline: bulk search for many strings (strsvsample07)."""
    ssv = bm.StrSparseVector.from_strings(
        ["aa", "bb", "cc", "bb", "dd", "aa"])
    ssv.remap()
    sc = bm.SparseVectorScanner()
    counts = sc.pipeline_find_eq_str(ssv, ["aa", "dd", "zz"])
    assert list(counts) == [2, 1, 0]
    res = sc.pipeline_find_eq_str(ssv, ["aa", "dd", "zz"],
                                  counts_only=False)
    assert sorted(res[0].indices().tolist()) == [0, 5]
    assert res[1].indices().tolist() == [4]
    assert res[2].count() == 0


def strsvsample08():
    """bfind_eq_str binary search with bound sample index
    (strsvsample08)."""
    words = sorted(f"key{i:04d}" for i in range(0, 4000, 4))
    ssv = bm.StrSparseVector.from_strings(words)
    ssv.remap()
    ssv.optimize()
    ssv.freeze()                              # reduce heap footprint
    sc = bm.SparseVectorScanner()
    sc.bind(ssv)
    pos = sc.bfind_eq_str(ssv, "key2000")
    assert words[pos] == "key2000"
    sc.unbind()


def main():
    fns = [v for k, v in sorted(globals().items())
           if (k.startswith(("svsample", "rscsample", "strsvsample"))
               and callable(v))]
    for fn in fns:
        fn()
        print(f"{fn.__name__}: ok")
    print(f"svsample walk: {len(fns)} programs ok")


if __name__ == "__main__":
    main()
