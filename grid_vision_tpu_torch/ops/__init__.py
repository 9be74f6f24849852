"""Tensor ops of the tick and the hand-written CUDA kernels' wrappers."""
