"""Checkpoint I/O and the weights bridge from the JAX package.

- :func:`state_dict_from_flax` turns the JAX package's U-Net or
  DeepLabV3+ ``variables`` (nested dicts of numpy arrays, ``params`` and
  ``batch_stats``; plain or BN-folded) into a ``state_dict`` of the port's
  module; :func:`flax_from_state_dict` is its inverse.
- :func:`save_model` writes a ``state_dict`` as the JAX package's native
  HDF5 checkpoint, which the JAX package's ``load_model`` reads.
- :func:`read_checkpoint` reads the JAX package's native HDF5 checkpoint
  (``format="octseg-tpu-v1"``: model name and config as attributes, one
  dataset per variable under its collection group, keyed by its tree
  path) with h5py alone, imported inside the functions that read files.
- :func:`load_model` rebuilds a :class:`LoadedModel` from such a file;
  :func:`load_model_and_config` does so with the workflows' surface (a
  sidecar ``model_config.json`` wins over the embedded config).
"""

from __future__ import annotations

import json
import logging as log
import re
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


_BLOCK = re.compile(r"(_?)ConvBlock_(\d+)")
# Flax module name -> the port's, and back (``ConvBlock_i`` <-> ``blocks.i``
# apart). ``Conv_0`` at the top of the tree is the head.
_TO_TORCH = {"Conv_0": "conv", "BatchNorm_0": "bn", "DSPP_0": "dspp"}
_TO_FLAX = {"head": "Conv_0", "conv": "Conv_0", "bn": "BatchNorm_0", "dspp": "DSPP_0"}
# BatchNorm leaves: (Flax collection, Flax leaf) <-> the port's leaf.
_BN_LEAVES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _torch_prefix(path: tuple) -> str:
    parts = []
    for part in path:
        block = _BLOCK.fullmatch(part)
        if block:
            parts += ["blocks", block.group(2)]
        elif path == ("Conv_0",):
            parts.append("head")
        else:
            parts.append(_TO_TORCH.get(part, part))
    return ".".join(parts)


def _is_bn(module_name: str) -> bool:
    return module_name == "bn" or module_name.endswith("_bn")


def state_dict_from_flax(variables_np: dict) -> dict:
    """Flax ``variables`` of the JAX package's U-Net or DeepLabV3+ -> the
    port's module state_dict.

    Module names map one for one: ``ConvBlock_i`` (U-Net) and
    ``_ConvBlock_i`` (DeepLabV3+) -> ``blocks.i``, ``Conv_0`` -> ``conv``
    (``head`` at the top of the tree), ``BatchNorm_0`` -> ``bn``, ``DSPP_0``
    -> ``dspp``; the backbone's Keras names stay. Conv kernels go from HWIO
    to OIHW; BatchNorm ``scale``/``bias`` and ``batch_stats``
    ``mean``/``var`` map to ``weight``/``bias``/``running_mean``/
    ``running_var``. A folded tree (no BatchNorm entries) gives a
    state_dict for the module built with ``use_bn=False``.
    """
    out = {}

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def walk(node: dict, stats: dict, path: tuple) -> None:
        prefix = _torch_prefix(path)
        if "kernel" in node:
            out[f"{prefix}.weight"] = t(node["kernel"]).permute(3, 2, 0, 1).contiguous()
            if "bias" in node:
                out[f"{prefix}.bias"] = t(node["bias"])
        elif "scale" in node:
            for (collection, leaf), name in _BN_LEAVES.items():
                out[f"{prefix}.{name}"] = t((node if collection == "params" else stats)[leaf])
        else:
            for name, child in node.items():
                walk(child, stats.get(name, {}), path + (name,))

    walk(variables_np["params"], variables_np.get("batch_stats", {}), ())
    return out


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's U-Net or DeepLabV3+ state_dict -> Flax ``variables``
    (nested dicts of float32 numpy arrays), the inverse of
    :func:`state_dict_from_flax`. A DeepLabV3+ (``resnet50.`` entries) gets
    its ``_ConvBlock_i`` names. A folded state_dict gives ``{"params":
    ...}`` alone."""
    deeplab = any(key.startswith("resnet50.") for key in state_dict)
    block = "_ConvBlock_" if deeplab else "ConvBlock_"
    variables = {}
    bn_leaves = {name: key for key, name in _BN_LEAVES.items()}
    for key, value in state_dict.items():
        a = np.asarray(torch.as_tensor(value).detach().cpu(), dtype=np.float32)
        *modules, leaf = key.split(".")
        path = []
        for i, part in enumerate(modules):
            if part.isdigit():
                continue
            if part == "blocks":
                path.append(f"{block}{int(modules[i + 1])}")
            else:
                path.append(_TO_FLAX.get(part, part))
        if _is_bn(modules[-1]):
            collection, leaf = bn_leaves[leaf]
        else:
            collection = "params"
            if leaf == "weight":
                a, leaf = np.ascontiguousarray(a.transpose(2, 3, 1, 0)), "kernel"
        node = variables.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return variables


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def save_model(path, model_name: str, model_config: dict, state_dict: dict) -> None:
    """Write ``state_dict`` as a native checkpoint (``format`` =
    ``octseg-tpu-v1``): model name and JSON config as attributes, one
    dataset per Flax variable under its collection group, keyed by its
    tree path, as the JAX package's ``save_model`` writes it."""
    import h5py

    def _s_attr(value: str) -> np.ndarray:
        data = value.encode("utf-8")
        return np.array(data, dtype=f"S{max(len(data), 1)}")

    with h5py.File(Path(path), "w") as f:
        f.attrs["model_name"] = _s_attr(model_name)
        f.attrs["model_config"] = _s_attr(json.dumps(model_config))
        f.attrs["format"] = _s_attr(CHECKPOINT_FORMAT.decode())
        for collection, tree in flax_from_state_dict(state_dict).items():
            grp = f.create_group(collection)
            for key, value in _flatten(tree).items():
                grp.create_dataset(key, data=value)


def is_folded(state_dict: dict) -> bool:
    """True when ``state_dict`` has no BatchNorm entries."""
    return not any(key.endswith(".running_var") for key in state_dict)


class LoadedModel:
    """A restored model: ``.name`` is the registry key, ``.module`` the
    ``nn.Module`` in eval mode, ``.output_classes`` the class count and
    ``.model_config`` the container config."""

    def __init__(self, name: str, module: torch.nn.Module, model_config: dict):
        self.name = name
        self.module = module
        self.model_config = model_config
        self.output_classes = model_config["num_classes"]


def _build(model_name: str, model_config: dict, variables: dict, device) -> LoadedModel:
    state_dict = state_dict_from_flax(variables)
    container = get_model_class(model_name)(**model_config)
    module = container.build_model(device=device, use_bn=not is_folded(state_dict))
    module.load_state_dict(state_dict)
    return LoadedModel(model_name, module, model_config)


def load_model(path, device=None) -> LoadedModel:
    """Rebuild a model from a JAX-package checkpoint on ``device`` (None
    means CUDA)."""
    return _build(*read_checkpoint(path), device)


def _is_native_checkpoint(path: Path) -> bool:
    import h5py

    with h5py.File(path, "r") as f:
        return f.attrs.get("format", b"") == CHECKPOINT_FORMAT


def load_model_and_config(
    model_path, mlflow_tracking_uri=None, mlflow_run_uuid=None, device=None
) -> tuple:
    """Restore a model from a native checkpoint -> ``(LoadedModel,
    model_config)``, on ``device`` (None means CUDA), as the JAX
    package's ``load_model_and_config``: a ``model_config.json`` beside
    the checkpoint takes precedence over the embedded config.

    MLflow runs, Keras ``.h5`` checkpoints and Orbax checkpoint
    directories are not ported (ROADMAP A12) and raise
    ``NotImplementedError``."""
    model_path = Path(model_path)
    if mlflow_run_uuid and not mlflow_tracking_uri:
        raise ValueError(
            "mlflow_run_uuid requires mlflow_tracking_uri (the run can "
            "only be resolved against a tracking server/store)"
        )
    if mlflow_tracking_uri:
        raise NotImplementedError(
            "loading a model through MLflow is not ported yet (ROADMAP A12)"
        )
    if model_path.is_dir():
        raise NotImplementedError(
            f"{model_path} is a directory: Orbax checkpoints are not ported "
            "yet (ROADMAP A12)"
        )
    if not _is_native_checkpoint(model_path):
        raise NotImplementedError(
            f"{model_path} is not a native checkpoint: Keras checkpoints are "
            "not ported yet (ROADMAP A12)"
        )
    model_name, model_config, variables = read_checkpoint(model_path)
    sidecar = model_path.parent / "model_config.json"
    if sidecar.exists():
        try:
            with open(sidecar) as fh:
                model_config = json.load(fh)
        except (OSError, json.JSONDecodeError):
            log.warning("Could not read %s; using the embedded config", sidecar)
    return _build(model_name, model_config, variables, device), model_config
