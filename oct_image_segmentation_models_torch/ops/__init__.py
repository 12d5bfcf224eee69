"""Operators of the port: the s2d U-Net forward, boundary maps, min-path
delineation, the fused inference pipeline, and the hand-written CUDA
kernels they launch."""
