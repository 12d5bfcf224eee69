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
  path). Every HDF5 file goes through :mod:`.h5`, which needs no h5py.
- :func:`load_model` rebuilds a :class:`LoadedModel` from such a file;
  :func:`load_model_and_config` does so with the workflows' surface: a
  native file, a directory checkpoint, a reference Keras ``.h5`` file, or
  any of them as an MLflow run's artifact (a sidecar ``model_config.json``,
  or the run's logged config, wins over the embedded config).
- :func:`save_model_dir` / :func:`load_model_dir` write and read the
  directory checkpoint, the port's counterpart of the JAX package's Orbax
  backend. :func:`load_checkpoint` reads either format.
- :func:`load_keras_model` imports a reference Keras checkpoint (U-Net by
  layer order, DeepLabV3+ by layer name), :func:`load_keras_resnet50_weights`
  a Keras ResNet50 backbone, and :func:`save_keras_weights` writes the
  reverse, the same file as the JAX package's.
"""

from __future__ import annotations

import json
import logging as log
import re
from pathlib import Path

import numpy as np
import torch

from ..models import get_model_class
from . import h5

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
    with h5.File(Path(path), "r") as f:
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
                if isinstance(obj, h5.Dataset):
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
    state_dict for the module built with ``use_bn=False``. A TransUNet's
    leaves map as Flax's own: a Dense ``kernel`` (in, out) to a Linear
    ``weight`` (out, in), a LayerNorm's or GroupNorm's ``scale`` (no
    statistics beside it) to ``weight``, and a bare parameter (the
    position embedding) to itself.
    """
    out = {}

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def walk(node: dict, stats: dict, path: tuple) -> None:
        prefix = _torch_prefix(path)
        if "kernel" in node:
            kernel = t(node["kernel"])
            kernel = kernel.permute(3, 2, 0, 1) if kernel.dim() == 4 else kernel.t()
            out[f"{prefix}.weight"] = kernel.contiguous()
            if "bias" in node:
                out[f"{prefix}.bias"] = t(node["bias"])
        elif "scale" in node and "mean" in stats:
            for (collection, leaf), name in _BN_LEAVES.items():
                out[f"{prefix}.{name}"] = t((node if collection == "params" else stats)[leaf])
        elif "scale" in node:
            out[f"{prefix}.weight"], out[f"{prefix}.bias"] = t(node["scale"]), t(node["bias"])
        else:
            for name, child in node.items():
                if isinstance(child, dict):
                    walk(child, stats.get(name, {}), path + (name,))
                else:
                    out[f"{prefix}.{name}" if prefix else name] = t(child)

    walk(variables_np["params"], variables_np.get("batch_stats", {}), ())
    return out


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's U-Net, DeepLabV3+ or TransUNet state_dict -> Flax ``variables``
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
            if leaf == "weight" and a.ndim == 1:  # a LayerNorm's or GroupNorm's
                leaf = "scale"
            elif leaf == "weight":
                a, leaf = np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T), "kernel"
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
    def _s_attr(value: str) -> np.ndarray:
        data = value.encode("utf-8")
        return np.array(data, dtype=f"S{max(len(data), 1)}")

    with h5.File(Path(path), "w") as f:
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


def _build(model_name: str, model_config: dict, state_dict: dict, device) -> LoadedModel:
    container = get_model_class(model_name)(**model_config)
    module = container.build_model(device=device, use_bn=not is_folded(state_dict))
    module.load_state_dict(state_dict)
    return LoadedModel(model_name, module, model_config)


def load_model(path, device=None) -> LoadedModel:
    """Rebuild a model from a JAX-package checkpoint on ``device`` (None
    means CUDA)."""
    model_name, model_config, variables = read_checkpoint(path)
    return _build(model_name, model_config, state_dict_from_flax(variables), device)


def _is_native_checkpoint(path: Path) -> bool:
    with h5.File(path, "r") as f:
        return f.attrs.get("format", b"") == CHECKPOINT_FORMAT


# ---------------------------------------------------------------------------
# Directory checkpoints, the counterpart of the JAX package's Orbax backend
# ---------------------------------------------------------------------------

_DIR_META = "octseg_model.json"  # the JAX package's Orbax metadata file
_DIR_WEIGHTS = "state_dict.pt"
_JAX_ORBAX_VARIABLES = "variables"


def save_model_dir(path, model_name: str, model_config: dict, state_dict: dict) -> None:
    """Write a directory checkpoint: ``octseg_model.json`` (the model name
    and config, as the JAX package's Orbax backend writes them) and the
    variables, saved with ``torch.save`` as CPU tensors.

    It stands where the JAX package writes an Orbax directory
    (``save_model_orbax``), but it is not Orbax's format: that needs
    orbax and tensorstore, which the card's machine lacks. Neither package
    reads the other's directories; the native HDF5 file is the format both
    read. Like the HDF5 writer it overwrites an existing checkpoint."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(
        {k: torch.as_tensor(v).detach().cpu() for k, v in state_dict.items()},
        path / _DIR_WEIGHTS,
    )
    with open(path / _DIR_META, "w") as fh:
        json.dump({"model_name": model_name, "model_config": model_config}, fh)


def _is_dir_checkpoint(path: Path) -> bool:
    return Path(path).is_dir() and (Path(path) / _DIR_META).exists()


def load_model_dir(path) -> tuple:
    """Read a directory checkpoint -> ``(model_name, model_config,
    state_dict)``, the tensors on the CPU. A directory that the JAX
    package's Orbax backend wrote raises ``ValueError``."""
    path = Path(path)
    if not (path / _DIR_WEIGHTS).exists():
        if (path / _JAX_ORBAX_VARIABLES).exists():
            raise ValueError(
                f"{path} is an Orbax checkpoint of the JAX package, which the "
                "PyTorch port does not read; convert it to the native HDF5 "
                "format with the JAX package's save_model "
                "(oct_image_segmentation_models_tpu.common.model_io: "
                "load_model_orbax, then save_model), which both packages read"
            )
        raise ValueError(f"{path} holds {_DIR_META} but no {_DIR_WEIGHTS}")
    with open(path / _DIR_META) as fh:
        meta = json.load(fh)
    state_dict = torch.load(path / _DIR_WEIGHTS, map_location="cpu", weights_only=True)
    return meta["model_name"], meta["model_config"], state_dict


def load_checkpoint(path) -> tuple:
    """Format-dispatching restore (a directory checkpoint or a native HDF5
    file) -> ``(model_name, model_config, state_dict)``, for
    ``train_model``'s ``initial_model``."""
    if _is_dir_checkpoint(path):
        return load_model_dir(path)
    model_name, model_config, variables = read_checkpoint(path)
    return model_name, model_config, state_dict_from_flax(variables)


def load_model_and_config(
    model_path, mlflow_tracking_uri=None, mlflow_run_uuid=None, device=None
) -> tuple:
    """Restore a model -> ``(LoadedModel, model_config)`` on ``device``
    (None means CUDA), as the JAX package's ``load_model_and_config``:
    from a native HDF5 checkpoint, a directory checkpoint
    (:func:`save_model_dir`), or a reference Keras checkpoint (imported
    weight for weight, :func:`load_keras_model`).

    With ``mlflow_tracking_uri`` the path is an MLflow artifact URI; with
    ``mlflow_run_uuid`` too, it is relative to that run's artifact root
    (e.g. ``model/model_final.hdf5``) and the run's
    ``model/data/model_config.json`` artifact is the config. Otherwise a
    ``model_config.json`` beside the checkpoint takes precedence over the
    embedded config. ``mlflow`` is imported only here."""
    raw_model_path = str(model_path)  # Path() collapses the // of s3:// URIs
    model_path = Path(model_path)
    mlflow_config = None
    if mlflow_run_uuid and not mlflow_tracking_uri:
        raise ValueError(
            "mlflow_run_uuid requires mlflow_tracking_uri (the run can "
            "only be resolved against a tracking server/store)"
        )
    if mlflow_tracking_uri:
        try:
            import mlflow
        except ImportError as exc:
            raise RuntimeError(
                "mlflow_tracking_uri was provided but mlflow is not "
                "installed; install mlflow or pass a local checkpoint path"
            ) from exc
        mlflow.set_tracking_uri(mlflow_tracking_uri)
        if mlflow_run_uuid:
            if model_path.is_absolute():
                raise ValueError(
                    f"model_path must be relative to the run's artifact "
                    f"root when mlflow_run_uuid is set (e.g. "
                    f"'model/model_final.hdf5'), got absolute path "
                    f"{model_path}"
                )
            run = mlflow.get_run(mlflow_run_uuid)
            artifact_uri = run.info.artifact_uri.rstrip("/")
            local = mlflow.artifacts.download_artifacts(
                f"{artifact_uri}/{model_path.as_posix()}"
            )
            try:
                mlflow_config = mlflow.artifacts.load_dict(
                    f"{artifact_uri}/model/data/model_config.json"
                )
            except Exception:  # noqa: BLE001 - the embedded config stands
                log.warning(
                    "Run %s has no model/data/model_config.json artifact; "
                    "using the checkpoint's embedded config",
                    mlflow_run_uuid,
                )
        else:
            local = mlflow.artifacts.download_artifacts(raw_model_path)
        model_path = Path(local)

    if _is_dir_checkpoint(model_path):
        model_name, model_config, state_dict = load_model_dir(model_path)
    elif model_path.is_dir():
        raise ValueError(
            f"{model_path} is a directory but not a directory checkpoint "
            f"(missing {_DIR_META}); pass the checkpoint directory that "
            "save_model_dir wrote, not a subdirectory"
        )
    elif not _is_native_checkpoint(model_path):
        return load_keras_model(model_path, model_config=mlflow_config, device=device)
    else:
        model_name, model_config, variables = read_checkpoint(model_path)
        state_dict = state_dict_from_flax(variables)

    if mlflow_config is not None:
        model_config = mlflow_config
    else:
        sidecar = model_path.parent / "model_config.json"
        if sidecar.exists():
            try:
                with open(sidecar) as fh:
                    model_config = json.load(fh)
            except (OSError, json.JSONDecodeError):
                log.warning("Could not read %s; using the embedded config", sidecar)
    return _build(model_name, model_config, state_dict, device), model_config


# ---------------------------------------------------------------------------
# Keras import: reference checkpoints and ResNet50 backbones
# ---------------------------------------------------------------------------


def load_keras_resnet50_weights(params: dict, h5_path) -> tuple:
    """Import ResNet50 weights from a Keras ``.h5`` file into the
    backbone's Flax-layout tree ``params`` (layer name -> ``kernel`` /
    ``bias`` or ``scale`` / ``bias``, numpy arrays; the port's Keras layer
    names are the file's). Returns ``(params, batch_stats)``: a new params
    tree with the conv kernels and BN scales and offsets replaced where the
    names match, and the matching ``batch_stats`` tree."""
    params = {name: dict(leaves) for name, leaves in params.items()}
    batch_stats = {}
    with h5.File(h5_path, "r") as f:
        weight_root = f["model_weights"] if "model_weights" in f else f

        def get_layer(name):
            if name in weight_root and name in weight_root[name]:
                return weight_root[name][name]
            return weight_root.get(name)

        for layer_name, target in params.items():
            src = get_layer(layer_name)
            if src is None:
                continue
            if "kernel" in target and "kernel:0" in src:
                target["kernel"] = np.asarray(src["kernel:0"][()])
                if "bias" in target and "bias:0" in src:
                    target["bias"] = np.asarray(src["bias:0"][()])
            if "scale" in target and "gamma:0" in src:
                target["scale"] = np.asarray(src["gamma:0"][()])
                target["bias"] = np.asarray(src["beta:0"][()])
                batch_stats[layer_name] = {
                    "mean": np.asarray(src["moving_mean:0"][()]),
                    "var": np.asarray(src["moving_variance:0"][()]),
                }
    return params, batch_stats


def _keras_layer_index(name: str, prefix: str) -> int:
    """conv2d -> 0, conv2d_3 -> 3 (Keras default layer naming)."""
    rest = name[len(prefix):]
    return int(rest[1:]) if rest else 0


def _keras_indexed_layers(root, prefix: str) -> list:
    """``prefix``, ``prefix_1``, ... layer names in creation order, the
    one scan that the importer and the exporter both index against."""
    return sorted(
        (n for n in root if n == prefix or n.startswith(prefix + "_")),
        key=lambda n: _keras_layer_index(n, prefix),
    )


# DeepLabV3+ head blocks in Keras creation order: entry i is the Flax path
# that conv2d_i / batch_normalization_i map to, the six DSPP conv blocks
# and then the three decoder conv blocks.
_DEEPLAB_HEAD_BLOCKS = tuple(
    [("DSPP_0", f"_ConvBlock_{i}") for i in range(6)]
    + [(f"_ConvBlock_{i}",) for i in range(3)]
)


def _keras_model_name(f, default: str) -> str:
    """The model name from the serialized Keras config attribute (the
    reference names its models after the registry key)."""
    raw_cfg = f.attrs.get("model_config")
    if raw_cfg is None:
        return default
    try:
        cfg = json.loads(raw_cfg.decode() if isinstance(raw_cfg, bytes) else raw_cfg)
        return cfg.get("config", {}).get("name", default)
    except (ValueError, AttributeError):
        return default


def _keras_sidecar_config(model_path: Path, override: dict = None) -> dict:
    """The architecture's hyper-parameters for a Keras import: ``override``
    (an MLflow run's logged config) or the ``model_config.json`` that the
    reference trainer writes beside the checkpoint."""
    if override is not None:
        return override
    sidecar = Path(model_path).parent / "model_config.json"
    if not sidecar.exists():
        raise FileNotFoundError(
            f"Keras checkpoint import needs {sidecar} (written by the "
            "reference trainer) to rebuild the architecture"
        )
    with open(sidecar) as fh:
        return json.load(fh)


def _keras_weights_reader(root):
    """Layer name -> ``{weight name: np.ndarray}`` for a Keras h5 weights
    group (down the nested ``name/name/...`` groups Keras writes)."""

    def weights_of(layer):
        grp = root[layer]
        while layer in grp:
            grp = grp[layer]
        return {k.split(":")[0]: np.asarray(v) for k, v in grp.items()}

    return weights_of


def _template(model_name: str, model_config: dict) -> tuple:
    """A freshly built module's variables as a Flax-layout numpy tree,
    for an importer to overwrite -> ``(params, batch_stats)``."""
    container = get_model_class(model_name)(**model_config)
    variables = flax_from_state_dict(container.build_model(device="cpu").state_dict())
    return variables["params"], variables.get("batch_stats", {})


def _set_conv(target: dict, src: dict, where: str) -> None:
    if tuple(target["kernel"].shape) != src["kernel"].shape:
        raise ValueError(
            f"{where}: kernel {src['kernel'].shape} != {tuple(target['kernel'].shape)}"
        )
    target["kernel"] = src["kernel"]
    if "bias" in target and "bias" in src:
        target["bias"] = src["bias"]


def _set_bn(param: dict, stats: dict, src: dict) -> None:
    param["scale"], param["bias"] = src["gamma"], src["beta"]
    stats["mean"], stats["var"] = src["moving_mean"], src["moving_variance"]


def _loaded(model_name, model_config, params, batch_stats, device) -> tuple:
    state_dict = state_dict_from_flax({"params": params, "batch_stats": batch_stats})
    return _build(model_name, model_config, state_dict, device), model_config


def load_keras_model(model_path, model_config: dict = None, device=None) -> tuple:
    """Import a reference Keras checkpoint -> ``(LoadedModel,
    model_config)`` on ``device``, dispatching on the embedded model name
    (U-Net by layer order, DeepLabV3+ by layer name). ``model_config``
    overrides the sidecar lookup (MLflow run loads)."""
    model_path = Path(model_path)
    with h5.File(model_path, "r") as f:
        name = _keras_model_name(f, "unet")
    if name == "deeplabv3plus":
        return load_keras_deeplab_model(model_path, model_config=model_config, device=device)
    return load_keras_unet_model(
        model_path, model_name=name, model_config=model_config, device=device
    )


def load_keras_unet_model(
    model_path, model_name: str = None, model_config: dict = None, device=None
) -> tuple:
    """Import a reference Keras U-Net checkpoint (the
    ``model_epoch{NN}.hdf5`` files of Keras's ModelCheckpoint).

    Keras names ``conv2d[_k]`` / ``batch_normalization[_k]`` in creation
    order, which is the order of the port's ``blocks.k``, so the weights map
    one to one by index; the head is the last conv. The hyper-parameters
    come from the sidecar ``model_config.json``."""
    model_path = Path(model_path)
    model_config = _keras_sidecar_config(model_path, model_config)
    with h5.File(model_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if model_name is None:
            model_name = _keras_model_name(f, "unet")
        weights_of = _keras_weights_reader(root)
        conv_w = [weights_of(n) for n in _keras_indexed_layers(root, "conv2d")]
        bn_w = [weights_of(n) for n in _keras_indexed_layers(root, "batch_normalization")]

    params, batch_stats = _template(model_name, model_config)
    blocks = sorted(
        (k for k in params if k.startswith("ConvBlock_")),
        key=lambda k: int(k.split("_")[1]),
    )
    if len(blocks) != len(bn_w) or len(conv_w) != len(blocks) + 1:
        raise ValueError(
            f"Keras checkpoint layout mismatch: {len(conv_w)} convs / "
            f"{len(bn_w)} batch-norms vs {len(blocks)} ConvBlocks"
        )
    for i, block in enumerate(blocks):
        _set_conv(params[block]["Conv_0"], conv_w[i], block)
        _set_bn(params[block]["BatchNorm_0"], batch_stats[block]["BatchNorm_0"], bn_w[i])
    _set_conv(params["Conv_0"], conv_w[-1], "softmax head")
    return _loaded(model_name, model_config, params, batch_stats, device)


def load_keras_deeplab_model(model_path, model_config: dict = None, device=None) -> tuple:
    """Import a reference Keras DeepLabV3+ checkpoint.

    The backbone's convs and BatchNorms carry Keras ResNet50 layer names,
    which are the port's, so they map by name. The head's layers carry
    Keras default names in creation order (the DSPP blocks, the low-level
    projection, the two decoder blocks, the softmax head), which is the
    port's order, so they map by index."""
    model_path = Path(model_path)
    model_config = _keras_sidecar_config(model_path, model_config)
    params, batch_stats = _template("deeplabv3plus", model_config)
    with h5.File(model_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        weights_of = _keras_weights_reader(root)
        for layer_name, target in params["resnet50"].items():
            if layer_name not in root:
                raise KeyError(f"backbone layer {layer_name!r} missing from checkpoint")
            src = weights_of(layer_name)
            if "kernel" in target:
                _set_conv(target, src, layer_name)
            if "scale" in target:
                _set_bn(target, batch_stats["resnet50"][layer_name], src)

        convs = _keras_indexed_layers(root, "conv2d")
        bns = _keras_indexed_layers(root, "batch_normalization")
        if len(bns) != len(_DEEPLAB_HEAD_BLOCKS) or len(convs) != len(_DEEPLAB_HEAD_BLOCKS) + 1:
            raise ValueError(
                f"Keras DeepLab head layout mismatch: {len(convs)} convs / "
                f"{len(bns)} batch-norms vs {len(_DEEPLAB_HEAD_BLOCKS)} blocks"
            )
        for i, path in enumerate(_DEEPLAB_HEAD_BLOCKS):
            p, b = params, batch_stats
            for part in path:
                p, b = p[part], b[part]
            _set_conv(p["Conv_0"], weights_of(convs[i]), "/".join(path))
            _set_bn(p["BatchNorm_0"], b["BatchNorm_0"], weights_of(bns[i]))
        _set_conv(
            params["Conv_0"], weights_of(convs[-1]),
            "softmax head (num_classes mismatch between checkpoint and model_config.json?)",
        )
    return _loaded("deeplabv3plus", model_config, params, batch_stats, device)


# ---------------------------------------------------------------------------
# Keras export, the reverse migration
# ---------------------------------------------------------------------------


def _keras_name(prefix: str, index: int) -> str:
    """Keras default layer naming: conv2d, conv2d_1, conv2d_2, ..."""
    return prefix if index == 0 else f"{prefix}_{index}"


def _write_keras_layer(root, layer_name: str, named_weights) -> None:
    """One layer in the Keras HDF5 weights layout: a group with a
    ``weight_names`` attribute, the datasets at
    ``<layer>/<layer>/<weight>:0``."""
    grp = root.create_group(layer_name)
    sub = grp.create_group(layer_name)
    weight_names = []
    for wname, arr in named_weights:
        sub.create_dataset(f"{wname}:0", data=np.asarray(arr, np.float32))
        weight_names.append(f"{layer_name}/{wname}:0".encode())
    size = max(len(n) for n in weight_names)
    grp.attrs["weight_names"] = np.array(weight_names, dtype=f"S{size}")


def _finalize_keras_export(f, layer_names) -> None:
    names = [n.encode() for n in layer_names]
    size = max(len(n) for n in names)
    f.attrs["layer_names"] = np.array(names, dtype=f"S{size}")
    f.attrs["backend"] = np.bytes_("tensorflow")
    # the reference pins TF/Keras 2.9
    f.attrs["keras_version"] = np.bytes_("2.9.0")


def _conv_weights(tree) -> list:
    out = [("kernel", tree["kernel"])]
    if "bias" in tree:
        out.append(("bias", tree["bias"]))
    return out


def _bn_weights(param_tree, stats_tree) -> list:
    return [
        ("gamma", param_tree["scale"]),
        ("beta", param_tree["bias"]),
        ("moving_mean", stats_tree["mean"]),
        ("moving_variance", stats_tree["var"]),
    ]


def _resnet50_pruned_layer_order() -> list:
    """The weighted-layer order of the reference's DeepLabV3+ backbone,
    ``keras.applications.ResNet50`` pruned at ``conv4_block6_2_relu``, in
    the functional graph's topological order (downsampling blocks
    interleave the shortcut as 1,1,2,2,0,3,0,3)."""
    order = ["conv1_conv", "conv1_bn"]
    for stage, n_blocks in ((2, 3), (3, 4), (4, 6)):
        for block in range(1, n_blocks + 1):
            pre = f"conv{stage}_block{block}"
            order += [f"{pre}_1_conv", f"{pre}_1_bn", f"{pre}_2_conv", f"{pre}_2_bn"]
            if stage == 4 and block == 6:  # pruned at the 2_relu tap
                continue
            if block == 1:
                order += [f"{pre}_0_conv", f"{pre}_3_conv", f"{pre}_0_bn", f"{pre}_3_bn"]
            else:
                order += [f"{pre}_3_conv", f"{pre}_3_bn"]
    return order


# The DeepLabV3+ head's weighted-layer order in the reference's graph: the
# five parallel DSPP branch convs come before their batch norms.
_DEEPLAB_HEAD_LAYER_ORDER = (
    ["conv2d", "batch_normalization"]
    + [f"conv2d_{i}" for i in range(1, 5)]
    + [f"batch_normalization_{i}" for i in range(1, 5)]
    + [name for i in range(5, 9) for name in (f"conv2d_{i}", f"batch_normalization_{i}")]
    + ["conv2d_9"]
)


def save_keras_weights(
    path, model_name: str, model_config: dict, state_dict: dict, write_sidecar: bool = True
) -> Path:
    """Write the port's ``state_dict`` as a reference-consumable Keras
    weights ``.h5``, the file the JAX package's ``save_keras_weights``
    writes from the same weights: the reference model's weighted-layer
    order with Keras default names, so that Keras's ``load_weights`` reads
    it by order or by name, and :func:`load_keras_model` reads it back.
    ``write_sidecar`` also writes ``model_config.json`` beside it. Returns
    the written path."""
    path = Path(path)
    variables = flax_from_state_dict(state_dict)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    if model_name not in ("unet", "deeplabv3plus"):
        raise ValueError(
            f"save_keras_weights supports 'unet' and 'deeplabv3plus', got {model_name!r}"
        )
    with h5.File(path, "w") as f:
        if model_name == "deeplabv3plus":
            layer_names = _export_deeplab_layers(f, params, batch_stats)
        else:
            layer_names = _export_unet_layers(f, params, batch_stats)
        _finalize_keras_export(f, layer_names)
        # The model name that load_keras_model dispatches on (Keras's own
        # load_weights never reads it).
        f.attrs["model_config"] = np.bytes_(
            json.dumps({"class_name": "Functional", "config": {"name": model_name}})
        )
    if write_sidecar:
        with open(path.parent / "model_config.json", "w") as fh:
            json.dump(model_config, fh)
    return path


def _export_unet_layers(f, params, batch_stats) -> list:
    """U-Net: block i -> conv2d_i + batch_normalization_i, the softmax
    head last."""
    blocks = sorted(
        (k for k in params if k.startswith("ConvBlock_")),
        key=lambda k: int(k.split("_")[1]),
    )
    layer_names = []
    for i, block in enumerate(blocks):
        conv_name = _keras_name("conv2d", i)
        bn_name = _keras_name("batch_normalization", i)
        _write_keras_layer(f, conv_name, _conv_weights(params[block]["Conv_0"]))
        _write_keras_layer(
            f, bn_name,
            _bn_weights(params[block]["BatchNorm_0"], batch_stats[block]["BatchNorm_0"]),
        )
        layer_names += [conv_name, bn_name]
    head_name = _keras_name("conv2d", len(blocks))
    _write_keras_layer(f, head_name, _conv_weights(params["Conv_0"]))
    layer_names.append(head_name)
    return layer_names


def _export_deeplab_layers(f, params, batch_stats) -> list:
    """DeepLabV3+: the Keras-named backbone by name, the head by index
    (the inverse of :func:`load_keras_deeplab_model`'s mapping)."""
    backbone_order = _resnet50_pruned_layer_order()
    missing = set(backbone_order) - set(params["resnet50"])
    extra = set(params["resnet50"]) - set(backbone_order)
    if missing or extra:
        raise ValueError(
            f"backbone layer set mismatch: missing {sorted(missing)}, "
            f"unexpected {sorted(extra)}"
        )
    for name in backbone_order:
        tree = params["resnet50"][name]
        if "kernel" in tree:
            _write_keras_layer(f, name, _conv_weights(tree))
        else:
            _write_keras_layer(f, name, _bn_weights(tree, batch_stats["resnet50"][name]))
    for i, block_path in enumerate(_DEEPLAB_HEAD_BLOCKS):
        p, b = params, batch_stats
        for part in block_path:
            p, b = p[part], b[part]
        _write_keras_layer(f, _keras_name("conv2d", i), _conv_weights(p["Conv_0"]))
        _write_keras_layer(
            f, _keras_name("batch_normalization", i),
            _bn_weights(p["BatchNorm_0"], b["BatchNorm_0"]),
        )
    _write_keras_layer(f, "conv2d_9", _conv_weights(params["Conv_0"]))
    return backbone_order + _DEEPLAB_HEAD_LAYER_ORDER
