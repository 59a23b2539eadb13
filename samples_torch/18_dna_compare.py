"""2-bit DNA compression + mismatch search (reference samples/xsample06,
bitmagic.io/dna-compare.html).

Sequences are stored 2 bits/bp in SparseVectors; comparing two genomes
reduces to XOR over two bit-planes, and find_first_mismatch locates the
first divergence without decoding either sequence.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
from bitmagic_tpu_torch.sv import SparseVector
from bitmagic_tpu_torch.sv.algo import find_first_mismatch

rng = np.random.default_rng(6)
CODE = np.frombuffer(b"ACGT", np.uint8)
N = 500_000

a_codes = rng.integers(0, 4, N).astype(np.uint32)
b_codes = a_codes.copy()
mut = np.sort(rng.choice(N, 25, replace=False))       # 25 point mutations
b_codes[mut] = (b_codes[mut] + rng.integers(1, 4, 25)) % 4

sv_a = SparseVector.from_array(a_codes)    # 2 bit-planes each
sv_b = SparseVector.from_array(b_codes)
st = sv_a.calc_stat()
print(f"{N} bp stored in {st['memory_used']} bytes "
      f"({st['memory_used'] * 8 / N:.2f} bits/bp)")

# first divergence, straight on the compressed planes
first = find_first_mismatch(sv_a, sv_b)
assert first == int(mut[0])
print("first mismatch at bp", first)

# all divergences: XOR the planes, OR the deltas
delta = (sv_a.planes[0] ^ sv_b.planes[0]) | (sv_a.planes[1] ^ sv_b.planes[1])
found = delta.indices()
assert np.array_equal(found, mut)
print(len(found), "mutations found:",
      [f"{CODE[a_codes[i]]:c}->{CODE[b_codes[i]]:c}@{i}"
       for i in found[:5]], "...")

# identical sequences -> no mismatch
assert find_first_mismatch(sv_a, sv_a) == -1
print("self-compare clean")
