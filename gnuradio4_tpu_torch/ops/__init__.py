"""Signal-processing ops over torch tensors, and the hand-written CUDA kernels."""
