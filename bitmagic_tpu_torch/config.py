"""Runtime configuration of the port.

The JAX package chooses between hand-written Pallas kernels and plain XLA
programs (``use_pallas``/``interpret``, ``bitmagic_tpu/config.py:21-38``).
Here the choice follows the tensor: on a CUDA tensor every hot block op
launches its hand-written Hopper kernel (or raises), on a CPU tensor it
runs the kernel's plain PyTorch version.  ``device`` picks where entry
points put new vectors; it defaults to the card.
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass
class Config:
    # Device of new vectors when an entry point is given none.  "cuda" by
    # default: asking for the card where there is none raises, it never
    # falls back to the CPU.
    device: str = "cuda"
    # Strategy of new vectors when an entry point is given none: read by
    # BitVector() and BitVector.from_indices (reference
    # set_new_blocks_strat, src/bm.h:1912)
    strategy: int = 0                    # BM_BIT
    # GAP level length table (reference src/bmconst.h:396-431)
    gap_levels: tuple = (128, 256, 512, 1280)

    def device_from_env(self) -> None:
        """The port's tools and samples start here: ``BMTPU_PLATFORM=cpu``
        sends them to the CPU; otherwise ``device`` stays as it is (the
        card, which raises where there is none)."""
        if os.environ.get("BMTPU_PLATFORM") == "cpu":
            self.device = "cpu"


config = Config()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` or ``config.device``.
    Raises when the card is requested and there is none."""
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bitmagic_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' (or set "
            "config.device = 'cpu') to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N"; name the same device the same way
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def simd_version() -> str:
    """Backend report, analog of ``bm::simd_version()`` (src/bmsimd.h:75-92):
    "cuda:kernel" when the default device is the card, else "cpu:torch"."""
    return ("cuda:kernel" if resolve_device().type == "cuda"
            else "cpu:torch")
