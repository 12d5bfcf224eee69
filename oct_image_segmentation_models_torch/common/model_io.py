"""Checkpoint I/O and the weights bridge from the JAX package.

- :func:`state_dict_from_flax` turns the JAX package's U-Net ``variables``
  (nested dicts of numpy arrays, ``params`` and ``batch_stats``; plain or
  BN-folded) into a ``state_dict`` of the port's :class:`UNetModule`;
  :func:`flax_from_state_dict` is its inverse.
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


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's ``UNetModule`` state_dict -> Flax U-Net ``variables``
    (nested dicts of float32 numpy arrays), the inverse of
    :func:`state_dict_from_flax`: ``blocks.{i}`` -> ``ConvBlock_i``, OIHW ->
    HWIO, ``bn.weight``/``bn.bias`` -> ``BatchNorm_0`` ``scale``/``bias``
    and the running statistics -> ``batch_stats`` ``mean``/``var``. A
    folded state_dict gives ``{"params": ...}`` alone."""
    params, stats = {}, {}
    bn_names = {
        "weight": ("params", "scale"),
        "bias": ("params", "bias"),
        "running_mean": ("batch_stats", "mean"),
        "running_var": ("batch_stats", "var"),
    }
    for key, value in state_dict.items():
        a = np.asarray(torch.as_tensor(value).detach().cpu(), dtype=np.float32)
        parts = key.split(".")
        if parts[0] == "head":
            conv = params.setdefault("Conv_0", {})
        elif parts[0] == "blocks":
            name = f"ConvBlock_{int(parts[1])}"
            if parts[2] == "bn":
                collection, leaf = bn_names[parts[3]]
                tree = params if collection == "params" else stats
                tree.setdefault(name, {}).setdefault("BatchNorm_0", {})[leaf] = a
                continue
            conv = params.setdefault(name, {}).setdefault("Conv_0", {})
        else:
            raise ValueError(f"unexpected U-Net state_dict entry {key!r}")
        if parts[-1] == "weight":
            conv["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        else:
            conv["bias"] = a
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
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
