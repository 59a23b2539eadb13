"""Compressive scrolling for a Model-View-Controller data grid (reference
samples/xsample10, bitmagic.io/bm-mvc.html).

The full column set lives as ONE serialized succinct-vector BLOB; the
view only ever materializes the visible window via range deserialization
(per-plane record lengths act as the reference's bookmarks), so scrolling
costs O(window), not O(dataset).
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
from bitmagic_tpu_torch.serial.sv_serial import (SparseVectorDeserializer,
                                           sparse_vector_serialize)
from bitmagic_tpu_torch.sv import SparseVector

rng = np.random.default_rng(17)
N = 1_000_000                            # a million-row column
col = rng.integers(0, 10_000, N).astype(np.uint32)
blob = sparse_vector_serialize(SparseVector.from_array(col))
print(f"model: {N} rows -> one {len(blob)}-byte BLOB "
      f"({N * 4 // 1024}KB raw)")

PAGE = 50                                # visible rows
de = SparseVectorDeserializer()


def render(top_row):
    """Fetch exactly the visible window out of the compressed model."""
    part = de.deserialize_range(blob, top_row, top_row + PAGE - 1)
    return part.to_numpy()[top_row:top_row + PAGE]


# scroll: jump around the dataset, each render decodes only the window
for top in (0, 123_456, 500_000, 999_950):
    view = render(top)
    assert np.array_equal(view, col[top:top + PAGE])
    print(f"rows {top}..{top + PAGE - 1}: "
          f"first cells {view[:4].tolist()}")
print("scrolled 4 windows; only", 4 * PAGE, "of", N, "rows materialized")
