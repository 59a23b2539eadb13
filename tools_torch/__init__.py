"""Command-line tools of the PyTorch/CUDA port (``bitmagic_tpu_torch``),
after the JAX package's ``tools/``: the BLOB utilities (``svutil``,
``range_idx``, ``lnkutil``, ``inv_list``) and the container fuzzer
(``fuzz_containers``).  Each runs on the card, or on the CPU with
``BMTPU_PLATFORM=cpu``, and exposes ``main(argv)``."""

import re

# The tools' timing lines, and the part of each that differs from run to
# run: svutil's import:, range_idx's index build: and ms/1k, lnkutil's
# "in ... ms", and inv_list's Mint/s column.
TIMED_LINES = [
    (re.compile(r"^(import: )\d+\.\d+s"), r"\1<s>"),
    (re.compile(r"^(index build: )\d+\.\d+s"), r"\1<s>"),
    (re.compile(r"^(\d+ point queries OK \()\d+\.\d+( ms/1k\))$"),
     r"\1<ms>\2"),
    (re.compile(r"^(2-hop neighborhood of \d+: \d+ nodes in )\d+\.\d+ ms$"),
     r"\1<ms>"),
    (re.compile(r"^((?:BMT1|ref ) +\d+ +\d+\.\d+ +\d+\.\d+) +\d+\.\d+$"),
     r"\1 <Mint/s>"),
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
