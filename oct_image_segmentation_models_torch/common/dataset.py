"""Prediction dataset container, the JAX package's ``common/dataset.py``."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np


class Dataset:
    """
    'images' with shape: (number of images, height, width, channels),
    dtype uint8, values in [0, 255].
    """

    def __init__(
        self,
        images: np.ndarray,
        image_masks: Optional[np.ndarray],
        image_names: List[Path],
        image_output_dirs: List[Path],
    ):
        self.images = images
        self.image_masks = image_masks
        self.image_names = image_names
        self.image_output_dirs = image_output_dirs
