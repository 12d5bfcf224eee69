"""Checkpoint I/O and the weights bridge from the JAX package.

- :func:`state_dict_from_flax` turns the JAX package's U-Net ``variables``
  (nested dicts of numpy arrays, ``params`` and ``batch_stats``; plain or
  BN-folded) into a ``state_dict`` of the port's :class:`UNetModule`.
- :func:`read_checkpoint` reads the JAX package's native HDF5 checkpoint
  (``format="octseg-tpu-v1"``: model name and config as attributes, one
  dataset per variable under its collection group, keyed by its tree
  path) with h5py alone. h5py is imported there and nowhere else.
- :func:`load_model` rebuilds a :class:`LoadedModel` from such a file.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models import get_model_class

CHECKPOINT_FORMAT = b"octseg-tpu-v1"


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def read_checkpoint(path) -> tuple:
    """Read a JAX-package checkpoint -> ``(model_name, model_config,
    variables_np)``, the variables as nested dicts of numpy arrays. The
    optimizer state, if any, is skipped."""
    import h5py

    with h5py.File(Path(path), "r") as f:
        fmt = f.attrs.get("format", b"")
        if fmt != CHECKPOINT_FORMAT:
            raise ValueError(
                f"{path}: not a native checkpoint (format={fmt!r}, "
                f"expected {CHECKPOINT_FORMAT!r})"
            )
        model_name = str(f.attrs["model_name"], "utf-8")
        model_config = json.loads(str(f.attrs["model_config"], "utf-8"))
        variables = {}
        for collection in f:
            if collection == "opt_state":
                continue
            flat = {}

            def visit(key, obj, _flat=flat):
                if isinstance(obj, h5py.Dataset):
                    _flat[key] = np.asarray(obj[()])

            f[collection].visititems(visit)
            variables[collection] = _unflatten(flat)
    return model_name, model_config, variables


def state_dict_from_flax(variables_np: dict) -> dict:
    """Flax U-Net ``variables`` -> the port's ``UNetModule`` state_dict.

    ``ConvBlock_i`` maps to ``blocks.{i}``; conv kernels go from HWIO to
    OIHW; BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``
    map to ``bn.weight``/``bn.bias``/``bn.running_mean``/``bn.running_var``.
    A folded tree (no BatchNorm entries) gives a state_dict for
    ``UNetModule(use_bn=False)``.
    """
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def kernel(a):  # HWIO -> OIHW
        return t(a).permute(3, 2, 0, 1).contiguous()

    out = {}
    for name, layer in params.items():
        if name == "Conv_0":
            out["head.weight"] = kernel(layer["kernel"])
            out["head.bias"] = t(layer["bias"])
            continue
        if not name.startswith("ConvBlock_"):
            raise ValueError(f"unexpected U-Net parameter group {name!r}")
        prefix = f"blocks.{int(name[len('ConvBlock_'):])}"
        out[f"{prefix}.conv.weight"] = kernel(layer["Conv_0"]["kernel"])
        out[f"{prefix}.conv.bias"] = t(layer["Conv_0"]["bias"])
        bn = layer.get("BatchNorm_0")
        if bn is not None:
            bstats = stats[name]["BatchNorm_0"]
            out[f"{prefix}.bn.weight"] = t(bn["scale"])
            out[f"{prefix}.bn.bias"] = t(bn["bias"])
            out[f"{prefix}.bn.running_mean"] = t(bstats["mean"])
            out[f"{prefix}.bn.running_var"] = t(bstats["var"])
    return out


def is_folded(state_dict: dict) -> bool:
    """True when ``state_dict`` has no BatchNorm entries."""
    return not any(".bn." in key for key in state_dict)


class LoadedModel:
    """A restored model: ``.name`` is the registry key, ``.module`` the
    ``nn.Module`` in eval mode, ``.output_classes`` the class count and
    ``.model_config`` the container config."""

    def __init__(self, name: str, module: torch.nn.Module, model_config: dict):
        self.name = name
        self.module = module
        self.model_config = model_config
        self.output_classes = model_config["num_classes"]


def load_model(path, device=None) -> LoadedModel:
    """Rebuild a model from a JAX-package checkpoint on ``device`` (None
    means CUDA)."""
    model_name, model_config, variables = read_checkpoint(path)
    state_dict = state_dict_from_flax(variables)
    container = get_model_class(model_name)(**model_config)
    module = container.build_model(device=device, use_bn=not is_folded(state_dict))
    module.load_state_dict(state_dict)
    return LoadedModel(model_name, module, model_config)
