"""Operators of the port: boundary maps, min-path delineation, the fused
inference pipeline, and the hand-written CUDA kernels they launch."""
