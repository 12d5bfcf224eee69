"""Min-path ("graph search") boundary delineation with the public API of
the JAX package's ``min_path_processing``; the compute runs in
:mod:`..ops.minpath` (the CUDA kernel on the card)."""

from .utils import generate_boundary  # noqa: F401
