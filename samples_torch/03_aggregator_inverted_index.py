"""Inverted-index intersection with the aggregator (reference
samples/bvsample16 / xsample02)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.agg import Aggregator

rng = np.random.default_rng(1)
N_DOCS = 1_000_000
# posting lists: term -> documents containing it
postings = {t: bm.BitVector.from_indices(
    np.unique(rng.integers(0, N_DOCS, rng.integers(1000, 400_000))), N_DOCS)
    for t in ["tpu", "bitmap", "jax", "spam"]}

agg = Aggregator()
hits = agg.combine_and_sub(
    and_group=[postings["tpu"], postings["bitmap"], postings["jax"]],
    sub_group=[postings["spam"]])
print("docs with tpu&bitmap&jax minus spam:", hits.count())
print("first hit:", agg.find_first_and_sub(
    [postings["tpu"], postings["bitmap"]], [postings["spam"]]))
