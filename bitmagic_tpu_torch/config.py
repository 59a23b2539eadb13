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

import torch


@dataclasses.dataclass
class Config:
    # Device of new vectors when an entry point is given none.  "cuda" by
    # default: asking for the card where there is none raises, it never
    # falls back to the CPU.
    device: str = "cuda"
    # GAP level length table (reference src/bmconst.h:396-431)
    gap_levels: tuple = (128, 256, 512, 1280)


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
