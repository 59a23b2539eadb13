"""Command-line tools of the PyTorch/CUDA port (``bitmagic_tpu_torch``),
after the JAX package's ``tools/``: the BLOB utilities (``svutil``,
``range_idx``, ``lnkutil``, ``inv_list``), the container fuzzer
(``fuzz_containers``) and the benchmarking tools (``bench_tpch``,
``microbench``, ``scaling_check``, ``multihost_check``).  Each runs on the
card, or on the CPU with ``BMTPU_PLATFORM=cpu`` (microbench also with
``--cpu``), and exposes ``main(argv)``."""

import re

import torch

# The tools' timing lines, and the part of each that differs from run to
# run: svutil's import:, range_idx's index build: and ms/1k, lnkutil's
# "in ... ms", inv_list's Mint/s column, microbench's ms and rate columns,
# scaling_check's three times and multihost_check's scan time.
TIMED_LINES = [
    (re.compile(r"^(import: )\d+\.\d+s"), r"\1<s>"),
    (re.compile(r"^(index build: )\d+\.\d+s"), r"\1<s>"),
    (re.compile(r"^(\d+ point queries OK \()\d+\.\d+( ms/1k\))$"),
     r"\1<ms>\2"),
    (re.compile(r"^(2-hop neighborhood of \d+: \d+ nodes in )\d+\.\d+ ms$"),
     r"\1<ms>"),
    (re.compile(r"^((?:BMT1|ref ) +\d+ +\d+\.\d+ +\d+\.\d+) +\d+\.\d+$"),
     r"\1 <Mint/s>"),
    (re.compile(r"^(\[\w+ *\]) +\d+\.\d+ ms  -> +\d+\.\d+ \S+$"),
     r"\1 <ms> ms  -> <rate>"),
    (re.compile(r"^(mesh=\d+: scan \d+M elems in )\d+\.\d+( ms \(weak "
                r"scaling\), 16-query pipeline )\d+\.\d+( ms, sharded-SV "
                r"container 8-query pipeline )\d+\.\d+( ms, .*)$"),
     r"\1<ms>\2<ms>\3<ms>\4"),
    (re.compile(r"^(multihost OK: .*scan \()\d+\.\d+( ms\).*)$"),
     r"\1<ms>\2"),
]


def normalised(text):
    """A tool's printed lines with the numbers of its timing lines
    replaced, for comparing two runs."""
    out = []
    for ln in text.splitlines():
        for pat, rep in TIMED_LINES:
            ln = pat.sub(rep, ln)
        out.append(ln)
    return out


def sync():
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
