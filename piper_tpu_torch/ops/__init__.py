"""Primitive ops: NWC convolutions, norms, splines, duration expansion,
and the CUDA vocoder kernels (ops/cuda)."""
