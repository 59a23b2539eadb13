"""SNP annotation search over a genome coordinate space (reference
samples/xsample03, bitmagic.io/succinct-snp-search.html).

SNP records are sparse in the chromosome coordinate space: an
rsc_sparse_vector drops the NULL columns physically, while rank/select
keeps coordinate lookups O(1)-ish.  The scanner searches the compressed
form directly.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
from bitmagic_tpu_torch.sv import RSCSparseVector, SparseVector, scanner as sc

rng = np.random.default_rng(3)
CHROM = 5_000_000                       # coordinate space (toy chr fragment)
N_SNP = 30_000

pos = np.unique(rng.integers(0, CHROM, N_SNP)).astype(np.int64)
rs_ids = rng.integers(1, 1 << 24, len(pos)).astype(np.uint32)

# dense layout would be CHROM u32 words; RSC stores only assigned columns
arr = np.zeros(CHROM, np.uint32)
arr[pos] = rs_ids
mask = np.ones(CHROM, bool)
mask[pos] = False
snp = RSCSparseVector.from_sparse_vector(
    SparseVector.from_array(arr, nullable=True, null_mask=mask))

# point lookup: is there a SNP at this coordinate?
probe = int(pos[1234])
found, rs = snp.try_get(probe)
assert found and int(rs) == int(rs_ids[1234])
found_miss, _ = snp.try_get(probe + 1 if (probe + 1) not in set(pos[:2000])
                            else probe - 1)
print(f"coordinate {probe}: rs{int(rs)}")

# range query: SNPs inside a window = rank arithmetic on the NULL bvector
lo, hi = 1_000_000, 1_200_000
nn = snp.get_null_bvector()
in_window = nn.count_range(lo, hi)
assert in_window == int(((pos >= lo) & (pos <= hi)).sum())
print(f"window [{lo}, {hi}]: {in_window} SNPs")

# reverse search: which coordinates carry a given annotation id?
target = int(rs_ids[777])
hits = sc.find_eq_rsc(snp, target)
got = hits.indices()
want = pos[rs_ids == target]
assert np.array_equal(got, want)
print(f"annotation {target} found at coordinates {got.tolist()}")

st = snp.calc_stat()
print("succinct memory:", st["memory_used"], "bytes vs dense",
      CHROM * 4, "bytes")
