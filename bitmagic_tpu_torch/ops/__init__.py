"""Block-level ops: plain PyTorch versions and the hand-written CUDA kernels."""
