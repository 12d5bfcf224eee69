#!/usr/bin/env python
"""Evaluate a trained model on a test HDF5 dataset with the PyTorch port.

The invocation shape of ``evaluate_model.py`` beside it, with the port's
CLI behind it; further arguments go to the ``evaluate`` subcommand
(``--device cpu`` runs on the CPU, the default is the CUDA card):

    python evaluate_model_torch.py <model-file> <test-dataset.hdf5> <output-dir> [--device cpu]
"""

import sys

from oct_image_segmentation_models_torch.cli import main

if __name__ == "__main__":
    model, dataset, output_dir = sys.argv[1:4]
    sys.exit(main(["evaluate", model, dataset, output_dir, *sys.argv[4:]]))
