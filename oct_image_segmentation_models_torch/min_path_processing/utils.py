"""Boundary extraction from dense label maps, the port's copy of the JAX
package's ``min_path_processing/utils.py``."""

from __future__ import annotations

import numpy as np


def generate_boundary(img_array, axis=0):
    """First row where ``label == i`` per column, for i in 1..max(label).

    Convention: considering the image top to bottom, a boundary belongs to
    the first pixel of the *next* region.
    """
    img_array = np.asarray(img_array)
    num_classes = int(np.amax(img_array))
    boundaries = [
        np.argmax(img_array == i, axis=axis) for i in range(1, num_classes + 1)
    ]
    return np.array(boundaries)
