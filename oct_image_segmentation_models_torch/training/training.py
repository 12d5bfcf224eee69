"""Training driver, counterpart of the JAX package's
``training/training.py::train_model``.

The configuration surface, the run artifacts (``model_config.json``,
``training_params.hdf5``, ``model_epochNN.hdf5``, ``stats_epochNN.hdf5``,
``model_final.hdf5``, the performance plot, the tracker's files),
checkpoint naming, best-checkpoint and early-stopping bookkeeping (Keras
2.9 ``restore_best_weights`` semantics), the precise-BN refresh and
finalisation, the rolling train-state file and the SIGTERM/SIGINT stop
are the JAX package's. Checkpoints are the JAX package's native format,
so its ``load_model`` reads them, or with ``checkpoint_format="orbax"``
the port's directory checkpoints (``model_io.save_model_dir``) under the
JAX package's ``.orbax`` names.

The device part is :class:`..common.data_generator.DataGenerator` ->
batches uploaded from pinned memory -> ``train_step`` -> ``eval_step`` ->
:class:`..ops.bn_refresh.BNRefresher`. The train state npz is the port's
own (module and optimizer tensors by name, the ``torch.Generator`` state
in its meta); a JAX train state is refused.

In an initialised ``torch.distributed`` process group the run is data
parallel over the ranks' :class:`..parallel.mesh.Mesh`, as the JAX
``train_model``'s multi-process branches are over its processes and
devices: each node keeps its strided shard of the training and
validation sets (trimmed to floor(N / nodes), dropped samples unlogged
as in JAX) and draws batches of ``batch_size // nodes``, of which each
local rank steps on its rows; the epoch-boundary stop and the finalisation's refresh skip
are agreed over every rank; the precise-BN refresh sums over every rank;
only rank 0 tracks the run and writes artifacts and the train state (with
every rank's step generator); with ``profile_dir`` each rank traces its
first epoch into ``trace_rank{rank}.json``. Without a process group it is
the one-device run, its batches through the same producer thread.

``train_step_impl="spmd"`` over several ranks is the one-device step on
the global batch; every rank's step generator then starts from the run's
seed. The forward that trains is JAX's choice
(:func:`resolve_train_forward`): under ``train_forward_impl`` "auto" and
"s2d" the space-to-depth forward (:mod:`..ops.s2d_train`) wherever the
model and the image dims qualify, else the plain module ("s2d" then
raises ``ValueError`` where JAX raises); "parity" the plain module.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging as log
import os
import re
import types
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..common import custom_losses, custom_metrics
from ..common import data_generator as data_gen
from ..common import dataset_loader, h5, model_io, profiling, utils
from ..common.mlflow_parameters import MLflowParameters
from ..common.tracking import NullTracker, get_tensorboard_writer, get_tracker
from ..models import get_model_class
from ..parallel.input_pipeline import device_prefetch, prefetch_to_mesh
from ..parallel.mesh import Mesh, all_gather_host, any_rank, create_mesh
from ..parallel.train_step import (
    KERAS_OPTIMIZER_NAMES,
    batch_stats,
    build_optimizer,
    create_train_state,
    load_batch_stats,
    make_eval_step,
    make_train_step,
    resolved_optimizer_config,
)
from . import training_callbacks
from .training_parameters import TrainingParams

TRAIN_STATE_FILENAME = "train_state_latest.npz"
TRAIN_STATE_FORMAT = "octseg-torch-train-state-v1"
_STAT_CACHE_BYTES_DEFAULT = 1 << 29


def resolve_train_forward(
    module: torch.nn.Module,
    model_config: Optional[dict],
    image_height: int,
    image_width: int,
    impl: str = "auto",
) -> tuple:
    """The forward that trains, evaluates and refreshes BatchNorm for
    ``module``, as JAX's ``train_model`` picks it: ``(forward, kind)``.

    Unless ``impl`` is "parity", the space-to-depth training forward
    (:func:`..ops.s2d_train.maybe_build_s2d_train`, the same parameters
    and statistics as ``module``) when the model and the image dims
    qualify, ``kind`` "s2d". Otherwise ``module`` itself, ``kind``
    "parity"; under "s2d" a model or geometry that does not qualify
    raises ``ValueError``."""
    if impl not in ("auto", "s2d", "parity"):
        raise ValueError(f"unknown train_forward_impl: {impl}")
    if impl != "parity":
        from ..ops.s2d_train import maybe_build_s2d_train

        forward = maybe_build_s2d_train(module, model_config, image_height, image_width)
        if forward is not None:
            log.info("Using s2d-transformed training forward")
            return forward, "s2d"
        if impl == "s2d":
            raise ValueError(
                "train_forward_impl='s2d' requires an s2d-eligible U-Net "
                "config and image dims divisible by the transformed-level "
                "factor"
            )
    return module, "parity"


def _split_meta_arrays(obj, out: dict):
    """Replace ndarray values inside ``meta`` with npz-key markers.

    Generator sampling states carry the full ``sample_shuffle``
    permutation — dataset-sized int arrays that would otherwise be
    JSON-encoded as Python lists on every epoch's checkpoint. They are
    stored as compact npz arrays instead (keys ``metaarr_<n>``)."""
    if isinstance(obj, np.ndarray):
        key = f"metaarr_{len(out)}"
        out[key] = obj
        return {"__meta_array__": key}
    if isinstance(obj, dict):
        return {k: _split_meta_arrays(v, out) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_split_meta_arrays(v, out) for v in obj]
    return obj


def _join_meta_arrays(obj, data):
    if isinstance(obj, dict):
        if set(obj) == {"__meta_array__"}:
            return np.asarray(data[obj["__meta_array__"]])
        return {k: _join_meta_arrays(v, data) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_join_meta_arrays(v, data) for v in obj]
    return obj


def save_train_state(path: Path, arrays: dict, meta: dict) -> None:
    """Rolling full-train-state checkpoint for exact resume.

    ``arrays`` maps names to numpy arrays (the module and optimizer
    tensors and the best-weight snapshots, see :func:`_state_arrays`);
    ``meta`` carries the epoch, the generator states, the best-monitor
    bookkeeping and the model name/config. Written atomically (tmp +
    rename) so an interruption mid-write cannot corrupt the previous file.
    """
    arrays = {f"arr/{k}": np.asarray(v) for k, v in arrays.items()}
    meta = _split_meta_arrays(dict(meta, format=TRAIN_STATE_FORMAT), arrays)
    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(
            fh, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays
        )
    os.replace(tmp, path)


def load_train_state(path: Path):
    """Returns ``(meta, arrays)`` saved by :func:`save_train_state`. A file
    of another format (the JAX package's train state holds Flax leaves and
    a JAX PRNG key) raises ``ValueError``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if not isinstance(meta, dict) or meta.get("format") != TRAIN_STATE_FORMAT:
            raise ValueError(
                f"{path} is not a train state of the PyTorch port (format "
                f"{TRAIN_STATE_FORMAT!r}); a JAX package train state can only be "
                "resumed by the JAX package"
            )
        meta = _join_meta_arrays(meta, data)
        arrays = {
            k[len("arr/"):]: data[k] for k in data.files if k.startswith("arr/")
        }
    return meta, arrays


def _snapshot(module: torch.nn.Module) -> dict:
    """A host copy of the module's state_dict (weights and statistics)."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _has_bn_stats(state_dict: dict) -> bool:
    return any(k.endswith("running_var") for k in state_dict)


def _state_arrays(state, best: dict, es_best: dict) -> tuple:
    """(arrays, optimizer scalars) of the train state for the npz: the
    module's state_dict, the optimizer's tensors by parameter index and
    slot, and the two snapshots."""
    arrays = {f"module/{k}": v.cpu().numpy() for k, v in state.module.state_dict().items()}
    scalars = {}
    for index, slots in state.optimizer.state_dict()["state"].items():
        for slot, value in slots.items():
            if torch.is_tensor(value):
                # numpy has no bfloat16: a bfloat16 slot is kept as its exact
                # float32 values, and the optimizer rounds it back on load.
                arrays[f"optimizer/{index}/{slot}"] = value.cpu().to(
                    torch.promote_types(value.dtype, torch.float32)
                ).numpy()
            else:
                scalars.setdefault(str(index), {})[slot] = value
    for prefix, snap in (("best", best), ("es_best", es_best)):
        arrays.update({f"{prefix}/{k}": v.numpy() for k, v in snap.items()})
    return arrays, scalars


def _restore_state(state, arrays: dict, scalars: dict) -> tuple:
    """Load the module and optimizer tensors of :func:`_state_arrays` into
    ``state``; returns the (best, es_best) snapshots."""

    def group(prefix):
        return {
            k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in arrays.items()
            if k.startswith(prefix)
        }

    try:
        state.module.load_state_dict(group("module/"))
    except RuntimeError as exc:
        raise ValueError(
            "train-state checkpoint does not match this configuration's "
            f"model: {exc}"
        ) from exc
    opt_state = {int(i): dict(s) for i, s in scalars.items()}
    for key, value in group("optimizer/").items():
        index, slot = key.split("/", 1)
        opt_state.setdefault(int(index), {})[slot] = value
    state.optimizer.load_state_dict(
        {"state": opt_state, "param_groups": state.optimizer.state_dict()["param_groups"]}
    )
    best = group("best/")
    es_best = group("es_best/") or best
    return best, es_best


def _resume_run_config(
    training_params: TrainingParams, dataset_md5: str
) -> dict:
    """The hyperparameters that determine the training trajectory.

    Saved into the train-state meta and compared on resume: a silent
    mismatch (different learning rate, loss, seed, dataset, ...) would
    break the documented bitwise-identical-resume guarantee while the
    flattened state arrays still line up. ``dataset_md5`` identifies
    the training data — the restored generator sampling state
    (``sample_shuffle`` permutation, counters) is only meaningful
    against the exact dataset it was drawn from.
    """
    cfg = {
        # opt_con may be a name, a factory, a functools.partial or a
        # callable instance —
        # all projected address-stably by _stable_json below. A bare
        # getattr(__name__)/str() here would embed memory addresses for
        # the transformation case and reject every legitimate resume.
        "optimizer": training_params.opt_con,
        "opt_params": training_params.opt_params,
        "loss": training_params.loss,
        "loss_fn_kwargs": training_params.loss_fn_kwargs,
        "metric": training_params.metric,
        "batch_size": training_params.batch_size,
        "seed": training_params.seed,
        "class_weight": training_params.class_weight,
        "augmentations": training_params.augmentations,
        "aug_mode": training_params.aug_mode,
        "aug_probs": list(training_params.aug_probs),
        "aug_fly": training_params.aug_fly,
        "aug_val": training_params.aug_val,
        "shuffle": training_params.shuffle,
        "channels_last": training_params.channels_last,
        "train_step_impl": training_params.train_step_impl,
        "train_forward_impl": training_params.train_forward_impl,
        "aug_device": training_params.aug_device,
        # model_hyperparameters can override non-structural config knobs
        # (dtype, pretrained_weights) at rebuild, changing the numeric
        # trajectory — so they are part of the resume identity.
        "model_hyperparameters": training_params.model_hyperparameters,
        # best_monitor/best_variables are restored on resume; comparing
        # them against a different monitored quantity (or direction)
        # silently corrupts best-checkpoint selection.
        "model_save_monitor": list(training_params.model_save_monitor),
        # val metrics (hence the restored best_monitor / best_es values)
        # were computed under one statistics semantics; resuming under
        # the other silently mixes the two selection signals.
        "bn_precise_val": training_params.bn_precise_val,
        "training_dataset_md5": dataset_md5,
    }

    return _stable_json(cfg)


def _stable_json(value):
    """Normalize to JSON-comparable values (tuples vs lists, numpy
    scalars). Callables project to qualified name PLUS their bound data
    (partial args/keywords, closure cells, defaults): ``str()`` would
    embed the memory address, which never matches across processes,
    while a bare qualname would collapse e.g. two learning-rate
    schedules from the same factory with different rates — silently
    passing the resume mismatch check with a different trajectory."""

    def _object_state(v):
        """Project a stateful object to its type plus instance
        attributes; with no introspectable state, stay fail-closed with
        a process-unique marker (two distinct opaque objects must never
        compare equal — the fix is plain data in the config)."""
        state = dict(getattr(v, "__dict__", None) or {})
        for slot in getattr(type(v), "__slots__", ()) or ():
            if hasattr(v, slot):
                state[slot] = getattr(v, slot)
        if state:
            try:
                return {
                    "type": type(v).__qualname__,
                    "state": {k: _coerce(x) for k, x in sorted(state.items())},
                }
            except (TypeError, ValueError):
                # unserializable / circular attribute graph
                pass
        return {"type": type(v).__qualname__, "opaque": id(v)}

    def _project(v):
        if isinstance(v, functools.partial):
            return {
                "partial": _project(v.func),
                "args": [_coerce(a) for a in v.args],
                "keywords": {k: _coerce(a) for k, a in sorted(v.keywords.items())},
            }
        if isinstance(v, types.MethodType):
            # a bound method's state lives on its receiver
            return {
                "method": _project(v.__func__),
                "self": _object_state(v.__self__),
            }
        if not isinstance(
            v, (types.FunctionType, types.BuiltinFunctionType)
        ):
            # A callable INSTANCE (a class with __call__) carries its
            # call-site state in instance attributes, not closure
            # cells — a bare class-name projection would collapse e.g.
            # Sched(1e-3) and Sched(1e-4), failing open.
            state = _object_state(v)
            if "opaque" in state and hasattr(v, "__name__"):
                # a NAMED stateless C callable (e.g. a numpy ufunc) is a
                # module-level singleton — bare name, like any factory
                return getattr(v, "__qualname__", v.__name__)
            return state
        name = getattr(v, "__qualname__", getattr(v, "__name__", type(v).__name__))
        cells = getattr(v, "__closure__", None) or ()
        if not cells and "<locals>" not in str(name):
            # A MODULE-LEVEL factory carries no call-site state: its
            # bound data arrives via opt_params / partial keywords
            # (checked separately) and its ``__defaults__`` are
            # library-version noise — embedding them would falsely
            # reject resume after e.g. a library upgrade that appends a
            # behavior-preserving keyword. The bare name also matches
            # run configs written by older framework versions, which
            # stored just ``__name__``. Nested functions ("<locals>" in
            # the qualname) are call-site-created, so their defaults ARE
            # state and fall through to the full projection.
            return name
        closure = []
        for cell in cells:
            try:
                closure.append(_coerce(cell.cell_contents))
            except ValueError:  # empty cell
                closure.append("<empty cell>")
        defaults = [_coerce(d) for d in (getattr(v, "__defaults__", None) or ())]
        out = {"fn": name, "closure": closure, "defaults": defaults}
        kwdefaults = getattr(v, "__kwdefaults__", None)
        if kwdefaults:
            # only when present, so projections of ordinary closures stay
            # byte-identical to configs saved by earlier versions
            out["kwdefaults"] = {
                k: _coerce(x) for k, x in sorted(kwdefaults.items())
            }
        return out

    def _coerce(v):
        # round-trip nested values through the same projection
        return json.loads(json.dumps(v, default=_default))

    def _default(v):
        if callable(v):
            return _project(v)
        # Reprs may embed per-process memory addresses ("<Foo object at
        # 0x7f...>"), which never match across processes. Scrub ONLY the
        # address pattern (a bare "0x[hex]" scrub would also collapse
        # legitimate hex-literal state like "flags=0x10" vs "0x20").
        text = re.sub(r"\bat 0x[0-9a-fA-F]+", "at 0x", str(v))
        # qualnames of nested classes contain "<locals>", so match any
        # "<... object at 0x>" default-repr shape, not just dotted names
        if re.fullmatch(r"<.+ object at 0x>", text):
            # A default repr carries no state at all: after the scrub,
            # two DIFFERENT values would compare equal (fail-open,
            # silently voiding the bitwise-identical-resume guarantee).
            # Project the instance attributes instead.
            return _object_state(v)
        return text

    return _coerce(value)


_NON_STRUCTURAL_CONFIG_KEYS = frozenset({"dtype", "pretrained_weights"})


def _check_hyperparameter_conflicts(
    model_config: dict, hyperparameters: dict, context: str
) -> None:
    """Reject ``model_hyperparameters`` that contradict a loaded model.

    When training continues from a checkpoint (``resume_train_state`` /
    ``initial_model``), the architecture comes from the saved
    ``model_config``; ``model_hyperparameters`` may only restate saved
    values or change NON-structural knobs: ``dtype`` is a compute dtype
    (the checkpoint's weights are dtype-convertible — e.g. fine-tuning a
    float32 model in bfloat16) and ``pretrained_weights`` only seeds
    from-scratch initialisation, so both are safe to override. Overriding
    a structural key (e.g. ``start_neurons``) would rebuild a module the
    checkpoint's weights don't describe — a shape error at best, silent
    corruption at worst.
    """
    conflicts = {
        k: (model_config[k], v)
        for k, v in hyperparameters.items()
        if k in model_config
        and k not in _NON_STRUCTURAL_CONFIG_KEYS
        and _stable_json(model_config[k]) != _stable_json(v)
    }
    if conflicts:
        raise ValueError(
            f"model_hyperparameters conflict with the {context} model's "
            f"saved architecture on {sorted(conflicts)} "
            f"(saved={ {k: s for k, (s, _) in conflicts.items()} }, "
            f"requested={ {k: r for k, (_, r) in conflicts.items()} }); "
            "continued training must keep the architecture the checkpoint "
            "was built with — only extension knobs absent from the saved "
            "config (e.g. dtype) may be set"
        )


def save_training_params_file(
    save_foldername: Path,
    model_summary: str,
    model_config: dict,
    training_dataset_md5: str,
    class_weight,
    timestamp,
    train_params: TrainingParams,
    opt_config: dict,
):
    """Self-describing run snapshot — reference `training/training.py:40-132`
    (same filenames and attribute keys)."""
    with open(save_foldername / "model_config.json", "w") as config_file:
        json.dump(model_config, config_file)

    with h5.File(save_foldername / "training_params.hdf5", "w") as f:
        f.attrs["timestamp"] = np.array(timestamp, dtype="S100")
        f.attrs["model_summary"] = np.array(model_summary, dtype="S1000")
        f.attrs["train_dataset_md5"] = np.array(training_dataset_md5, dtype="S1000")
        f.attrs["epochs"] = train_params.epochs
        f.attrs["loss_name"] = np.array(train_params.loss, dtype="S1000")
        f.attrs["metric_name"] = np.array(train_params.metric, dtype="S1000")
        if class_weight is None:
            f.attrs["class_weight"] = np.array("None", dtype="S1000")
        else:
            f.attrs["class_weight"] = np.array("array", dtype="S1000")
            f["class_weight"] = np.asarray(class_weight)
        f.attrs["metric"] = np.array(train_params.metric, dtype="S100")
        f.attrs["loss"] = np.array(train_params.loss, dtype="S100")
        f.attrs["batch_size"] = train_params.batch_size
        f.attrs["shuffle"] = train_params.shuffle
        f.attrs["aug_mode"] = np.array(train_params.aug_mode, dtype="S100")

        if train_params.aug_mode != "none":
            for aug_ind, (aug_fn, aug_arg) in enumerate(train_params.aug_fn_args):
                desc = aug_fn(None, None, aug_arg, True)
                if not isinstance(aug_arg, dict):
                    f.attrs[f"aug_{aug_ind + 1}"] = np.array(desc, dtype="S1000")
                else:
                    f.attrs[f"aug_{aug_ind + 1}"] = np.array(
                        aug_fn.__name__, dtype="S100"
                    )
                    for key, val in aug_arg.items():
                        attr = f"aug_{aug_ind + 1}_param: {key}"
                        if isinstance(val, (int, float)):
                            f.attrs[attr] = np.array(val)
                        elif isinstance(val, str):
                            # unbounded bytes — a fixed S-width silently
                            # truncates user-supplied values
                            f.attrs[attr] = np.bytes_(val)
                        elif isinstance(val, list):
                            f.attrs[attr] = np.bytes_(str(val))
            if train_params.aug_mode == "one":
                f.attrs["aug_probs"] = np.array(train_params.aug_probs)
        # Written for every aug_mode, incl. "none" (reference
        # `training/training.py:117-118` dedents these to function level).
        f.attrs["aug_fly"] = train_params.aug_fly
        f.attrs["aug_val"] = train_params.aug_val

        opt_con = train_params.opt_con
        if isinstance(opt_con, str):
            # the reference records the Keras class __name__
            # (`training/training.py:120-122`): "Adam", not "adam" —
            # same table resolved_optimizer_config uses for cfg["name"]
            opt_name = KERAS_OPTIMIZER_NAMES.get(opt_con.lower(), opt_con)
        else:
            # name, not repr: a callable's repr embeds
            # per-process memory addresses (and would truncate at a
            # fixed S-width)
            opt_name = getattr(
                opt_con, "__name__", type(opt_con).__qualname__
            )
        # Framework-only provenance attrs (absent from the reference's
        # writer): record whether the saved checkpoints' batch_stats are
        # precise-BN population statistics rather than Keras rolling
        # statistics, and whether epoch val metrics used the precise-BN
        # refresh — downstream parity comparisons must know which
        # semantics a run used (ADVICE r4).
        f.attrs["bn_precise_stats"] = bool(train_params.bn_precise_stats)
        f.attrs["bn_precise_val"] = bool(train_params.bn_precise_val)
        f.attrs["optimizer"] = np.bytes_(opt_name)
        for key, val in opt_config.items():
            if val is None:
                continue
            if isinstance(val, (bool, int, float, np.integer, np.floating)):
                f.attrs[f"opt_param: {key}"] = val
            elif isinstance(val, str):
                # plain assignment (h5py variable-length unicode) —
                # exactly what the reference's writer stores
                # (`training/training.py:128-130`)
                f.attrs[f"opt_param: {key}"] = val
            elif callable(val):
                # e.g. a learning-rate schedule: record its name, not a
                # repr that embeds a per-process memory address
                f.attrs[f"opt_param: {key}"] = np.bytes_(
                    getattr(val, "__qualname__", type(val).__qualname__)
                )
            else:  # dicts / lists / arbitrary config values
                f.attrs[f"opt_param: {key}"] = np.bytes_(str(val))


def _monitor_improved(current, best, mode):
    if best is None:
        return True
    return current > best if mode == "max" else current < best


def _refresh_seed(seed, epoch: Optional[int] = None) -> int:
    """Seed of the precise-BN refresh's dropout generator: one per epoch
    for the validation refresh, the base one for finalisation."""
    base = (0 if seed is None else int(seed)) * 1_000_003
    return base if epoch is None else base + epoch + 1


def _rank_seed(seed: int, rank: int, world: int) -> int:
    """Seed of a rank's per-replica ("shard_map") step generator (dropout
    and device augmentation): the run's seed on one rank; one stream per
    rank on more, as JAX folds the device index into the step's key."""
    if world == 1:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _mean(values) -> float:
    """Epoch mean of per-batch 0-d tensors, in float32 as the JAX driver
    takes it (one read-back per epoch)."""
    return float(np.mean(torch.stack(values).cpu().numpy()))


def train_model(
    training_params: TrainingParams,
    mlflow_params: Optional[MLflowParameters] = None,
) -> Path:
    """Train a model on ``training_params.device`` (None means CUDA, and
    ``cuda:{local rank}`` in a process group); returns the run's save
    folder."""
    mesh = create_mesh(device=training_params.device) if dist.is_initialized() else None
    device = mesh.device if mesh is not None else resolve_device(training_params.device)
    world, nodes = (mesh.world, mesh.nodes) if mesh is not None else (1, 1)
    rank = mesh.rank if mesh is not None else 0
    is_main_process = rank == 0
    # Tracking (MLflow's network calls included) is rank 0's alone.
    tracker = get_tracker(mlflow_params) if is_main_process else NullTracker()

    training_dataset_path = training_params.training_dataset_path
    with h5.File(training_dataset_path, "r") as hdf5_file:
        train_images, train_labels = dataset_loader.load_training_data(hdf5_file)
        val_images, val_labels = dataset_loader.load_validation_data(hdf5_file)

    num_classes = int(len(np.unique(train_labels)))
    log.info(f"Detected {num_classes} classes")

    if training_params.class_weight == "balanced":
        dataset_labels = np.concatenate((train_labels, val_labels))
        c_weight = custom_losses.compute_balanced_class_weight(dataset_labels)
    elif isinstance(training_params.class_weight, list):
        c_weight = np.array(training_params.class_weight)
    else:
        c_weight = None

    # The class count and weights above come from the full label set, so
    # every node agrees on them; then each node keeps its strided shard,
    # trimmed so that every node runs the same number of steps.
    if world > 1 and training_params.batch_size % world:
        raise ValueError(
            f"batch_size ({training_params.batch_size}) must be divisible by "
            f"the {world} ranks"
        )
    if nodes > 1:
        shard = slice(mesh.node, None, nodes)
        n_tr = len(train_images) // nodes
        n_va = len(val_images) // nodes
        train_images = train_images[shard][:n_tr]
        train_labels = train_labels[shard][:n_tr]
        val_images = val_images[shard][:n_va]
        val_labels = val_labels[shard][:n_va]
        log.info(
            f"Node {mesh.node}/{nodes}: {len(train_images)} train / "
            f"{len(val_images)} val samples"
        )

    _, image_height, image_width, input_channels = train_images.shape
    log.info(
        f"Detected input image dimensions (h x w): {image_height} x {image_width}."
    )
    log.info(f"Detected {input_channels} input channels.")

    tx = build_optimizer(training_params.opt_con, training_params.opt_params)

    loss = custom_losses.custom_loss_objects.get(training_params.loss)
    if loss is None:
        raise ValueError(f"Loss '{training_params.loss}' not found.")

    sparse_labels = loss["takes_sparse"]
    loss_kwargs = dict(training_params.loss_fn_kwargs)
    if c_weight is not None and "class_weight" not in loss_kwargs:
        loss_kwargs["class_weight"] = c_weight
    loss_fn = loss["function"](
        num_classes=num_classes,
        is_y_true_sparse=sparse_labels,
        **loss_kwargs,
    )

    metric = custom_metrics.training_monitor_metric_objects.get(training_params.metric)
    if metric is None:
        raise ValueError(f"Metric '{training_params.metric}' not found.")
    metric_fn = metric(sparse_labels, num_classes)

    if not sparse_labels:
        classes = np.arange(num_classes)
        train_labels_model = (train_labels[..., 0, None] == classes).astype(np.float32)
        val_labels_model = (val_labels[..., 0, None] == classes).astype(np.float32)
    else:
        train_labels_model = train_labels
        val_labels_model = val_labels

    training_dataset_md5 = utils.md5(training_dataset_path)
    seed = training_params.seed or 0
    # The step generator: dropout masks and device augmentation noise. The
    # spmd step draws the global batch's randoms on every rank from one
    # stream: the run's seed on every rank.
    global_batch = world > 1 and training_params.train_step_impl == "spmd"
    generator = torch.Generator(device=device).manual_seed(
        seed if global_batch else _rank_seed(seed, rank, world)
    )

    resume_meta, resume_arrays = None, None
    if training_params.resume_train_state:
        log.info(
            "Resuming full train state from: "
            f"{training_params.resume_train_state}"
        )
        resume_meta, resume_arrays = load_train_state(training_params.resume_train_state)
        saved_cfg = resume_meta.get("run_config", {})
        current_cfg = _resume_run_config(training_params, training_dataset_md5)
        unchecked = sorted(set(current_cfg) - set(saved_cfg))
        if unchecked:
            log.warning(
                "resume_train_state predates run-config keys %s; these "
                "cannot be checked against the checkpoint",
                unchecked,
            )
        mismatched = sorted(k for k in saved_cfg if saved_cfg[k] != current_cfg.get(k))
        if mismatched:
            detail = (
                "resume_train_state run configuration mismatch on "
                f"{mismatched}: resume must use the hyperparameters the "
                "checkpoint was trained with (saved="
                f"{ {k: saved_cfg.get(k) for k in mismatched} }, current="
                f"{ {k: current_cfg.get(k) for k in mismatched} })"
            )
            if training_params.resume_config_check == "warn":
                log.warning(
                    "%s — continuing anyway (resume_config_check='warn'); "
                    "the bitwise-identical-resume guarantee does not hold",
                    detail,
                )
            else:
                raise ValueError(detail)
        model_name = resume_meta["model_name"]
        model_config = resume_meta["model_config"]
        _check_hyperparameter_conflicts(
            model_config, training_params.model_hyperparameters, "resume"
        )
        model_container = get_model_class(model_name)(
            **{**model_config, **training_params.model_hyperparameters}
        )
        module = model_container.build_model(device=device)
        model_architecture = model_name
    elif training_params.initial_model:
        log.info(f"Resuming training from model: {training_params.initial_model}")
        model_name, model_config, initial_state = model_io.load_checkpoint(
            training_params.initial_model
        )
        _check_hyperparameter_conflicts(
            model_config, training_params.model_hyperparameters, "initial_model"
        )
        model_container = get_model_class(model_name)(
            **{**model_config, **training_params.model_hyperparameters}
        )
        module = model_container.build_model(device=device)
        module.load_state_dict(initial_state)
        model_architecture = model_name
    else:
        model_architecture = training_params.model_architecture
        log.info(f"Starting training from scratch {model_architecture} model")
        model_container = get_model_class(model_architecture)(
            input_channels=int(input_channels),
            num_classes=num_classes,
            image_height=int(image_height),
            image_width=int(image_width),
            **training_params.model_hyperparameters,
        )
        module = model_container.build_model(
            generator=torch.Generator().manual_seed(seed), device=device
        )
        # Pretrained initialisation (DeepLabV3+'s Keras ResNet50 backbone);
        # no-op for other containers.
        module.load_state_dict(model_container.apply_pretrained_weights(module.state_dict()))
        model_name = model_architecture

    state = create_train_state(module, tx, mesh)

    start_epoch = 0
    resume_best = None
    resume_es_best = None
    if resume_meta is not None:
        resume_best, resume_es_best = _restore_state(
            state, resume_arrays, resume_meta["optimizer_scalars"]
        )
        state.step = int(resume_meta["step"])
        saved_states = resume_meta.get("generator_states", [resume_meta.get("generator_state")])
        if len(saved_states) != world:
            raise ValueError(
                f"the train state was written by a run of {len(saved_states)} "
                f"rank(s); it resumes only at that world size, not at {world}"
            )
        generator.set_state(torch.from_numpy(np.asarray(saved_states[rank])))
        start_epoch = int(resume_meta["epoch"])
        log.info(f"Resumed at epoch {start_epoch} (step {state.step})")

    # The forward inside the train and eval steps and the refresh.
    compute_module, _ = resolve_train_forward(
        module, model_container.get_config(), image_height, image_width,
        training_params.train_forward_impl,
    )

    preprocess_fn = model_container.get_preprocess_input_fn()
    # Device augmentation: the generator keeps its mode logic (which sample
    # gets which augmentation) and the step applies it batched on the
    # device, from the generator's per-sample choices.
    device_augmenter = None
    if training_params.aug_device == "on" and (
        not training_params.aug_fly or training_params.aug_mode == "none"
    ):
        raise ValueError(
            "aug_device='on' requires aug_fly=True and an augmentation "
            "mode other than 'none'"
        )
    if (
        training_params.aug_device in ("auto", "on")
        and training_params.aug_fly
        and training_params.aug_mode != "none"
    ):
        from ..ops.augment import build_device_augmenter

        device_augmenter = build_device_augmenter(training_params.aug_fn_args)
        if device_augmenter is None and training_params.aug_device == "on":
            raise ValueError(
                "aug_device='on' but an augmentation has no device "
                "equivalent (only flip and gaussian/speckle noise do)"
            )
    use_aug_device = device_augmenter is not None

    input_transform = None
    if use_aug_device:
        log.info("Applying augmentations on device")

        def input_transform(gen, im, lb, ch):
            im, lb = device_augmenter(gen, im, lb, ch)
            return preprocess_fn(im * 255.0), lb

    # Each node assembles its batch; each of its ranks steps on its rows.
    local_batch_size = training_params.batch_size // nodes
    train_step = make_train_step(
        compute_module, loss_fn, metric_fn, mesh,
        impl=training_params.train_step_impl,
        input_transform=input_transform,
    )
    eval_step = make_eval_step(
        compute_module, loss_fn, metric_fn, mesh, impl=training_params.train_step_impl
    )

    monitor_name, monitor_mode = training_params.model_save_monitor
    valid_monitors = {
        "loss",
        "val_loss",
        training_params.metric,
        "val_" + training_params.metric,
    }
    if monitor_name not in valid_monitors:
        raise ValueError(
            f"Unknown model_save_monitor name {monitor_name!r}; valid names "
            f"for this run are {sorted(valid_monitors)}"
        )
    if monitor_mode not in ("min", "max"):
        raise ValueError(
            f"Unknown model_save_monitor mode {monitor_mode!r}; "
            "must be 'min' or 'max'"
        )
    timestamp = utils.get_timestamp()
    tracker.start_run()
    save_foldername = (
        training_params.results_location
        / Path(tracker.run_id)
        / Path(f"{timestamp}_{model_architecture}")
    )
    if is_main_process:
        # The other ranks train and write nothing.
        os.makedirs(save_foldername)
    tracker.set_run_folder(save_foldername)
    tb_writer = (
        get_tensorboard_writer(save_foldername / "tensorboard")
        if training_params.tensorboard and is_main_process
        else None
    )
    if training_params.checkpoint_format == "orbax":
        ckpt_save, ckpt_suffix = model_io.save_model_dir, ".orbax"
    else:
        ckpt_save, ckpt_suffix = model_io.save_model, ".hdf5"

    tracker.log_params(
        {
            "model_architecture": model_architecture,
            "training_dataset_path": str(training_dataset_path),
            "training_dataset_md5": training_dataset_md5,
            "augmentation_mode": training_params.aug_mode,
            "augmentations": training_params.augmentations,
            "loss_name": training_params.loss,
            "loss_fn_kwargs": training_params.loss_fn_kwargs,
            "metric_name": training_params.metric,
            "loss_fn_class_weight": training_params.class_weight,
            "class_weight_array": c_weight,
        }
    )
    tracker.log_dict(model_container.get_config(), "model/data/model_config.json")

    if training_params.aug_val:
        aug_val_mode = training_params.aug_mode
        aug_val_fn_args = training_params.aug_fn_args
        aug_val_probs = training_params.aug_probs
        aug_val_fly = training_params.aug_fly
    else:
        aug_val_mode, aug_val_fn_args, aug_val_probs, aug_val_fly = "none", [], (), False

    history = training_callbacks.SaveEpochInfo(
        save_folder=save_foldername,
        train_params=training_params,
        start_epoch=start_epoch,
    )

    param_count = sum(p.numel() for p in module.parameters())
    model_summary = (
        f"{model_architecture}: {param_count} parameters, input "
        f"({image_height}x{image_width}x{input_channels}), {num_classes} classes"
    )
    opt_config = resolved_optimizer_config(
        training_params.opt_con, training_params.opt_params
    )
    if is_main_process:
        save_training_params_file(
            save_foldername,
            model_summary,
            model_container.get_config(),
            training_dataset_md5,
            c_weight,
            timestamp,
            training_params,
            opt_config,
        )

    train_gen = data_gen.DataGenerator(
        train_images,
        train_labels_model,
        local_batch_size,
        training_params.aug_fn_args,
        training_params.aug_mode,
        training_params.aug_probs,
        training_params.aug_fly,
        preprocess_fn,
        shuffle=training_params.shuffle,
        seed=training_params.seed,
        aug_device=use_aug_device,
    )
    val_gen = data_gen.DataGenerator(
        val_images,
        val_labels_model,
        local_batch_size,
        aug_val_fn_args,
        aug_val_mode,
        aug_val_probs,
        aug_val_fly,
        preprocess_fn,
        shuffle=training_params.shuffle,
        seed=training_params.seed,
    )

    for name, gen in (("training", train_gen), ("validation", val_gen)):
        total = gen.get_total_samples()
        if local_batch_size > total:
            raise ValueError(
                f"The batch size ({local_batch_size}) cannot be "
                f"larger than the number of {name} samples ({total})"
            )
        log.info(f"{name} generator total number of samples: {total}")

    # Precise-BN machinery, shared by the per-epoch validation refresh
    # (bn_precise_val) and the checkpoint finalisation (bn_precise_stats).
    bn_refresher = None
    if (
        training_params.bn_precise_stats or training_params.bn_precise_val
    ) and _has_bn_stats(module.state_dict()):
        from ..ops.bn_refresh import BNRefresher

        bn_refresher = BNRefresher(compute_module)

    # Equal-size batches (the law-of-total-variance aggregation assumes
    # them); one all-images batch when the training set is smaller than
    # the batch size.
    stat_bs = min(local_batch_size, len(train_images))
    n_stat_full = (len(train_images) // stat_bs) * stat_bs

    # Device-resident cache of the preprocessed stat batches: each epoch's
    # refresh reads the same un-augmented training images. Capped so a
    # large dataset streams instead of filling the card.
    stat_cache: list = []
    stat_cache_ok: list = []

    def _stat_batches():
        if len(stat_cache) == n_stat_full // stat_bs:
            yield from stat_cache
            return
        stat_cache.clear()  # partially filled (an interrupted first pass)
        host = (
            preprocess_fn(train_images[start : start + stat_bs].astype(np.float32))
            for start in range(0, n_stat_full, stat_bs)
        )
        for batch in device_prefetch(host, device=device):
            if not stat_cache_ok:
                cap = int(
                    os.environ.get(
                        "OCTSEG_BN_STAT_CACHE_BYTES", str(_STAT_CACHE_BYTES_DEFAULT)
                    )
                )
                stat_cache_ok.append(
                    batch.numel() * batch.element_size() * (n_stat_full // stat_bs) <= cap
                )
            if stat_cache_ok[0]:
                stat_cache.append(batch)
            yield batch

    def _refresh_stats(params, refresh_seed: int) -> dict:
        """Precise population BN statistics of the (un-augmented) training
        images under ``params`` (a snapshot, or None for the module's
        current weights). Over several ranks every rank runs its node's
        batches and the sums cover every node's shard (every rank must
        call this together)."""
        gen = torch.Generator(device=device).manual_seed(refresh_seed)
        return bn_refresher(params, _stat_batches(), generator=gen, cross_process=world > 1)

    use_precise_val = training_params.bn_precise_val and bn_refresher is not None
    if use_precise_val:
        log.info(
            "Epoch val metrics use precise-BN statistics refreshed under "
            "each epoch's weights (bn_precise_val=True; one extra forward "
            "pass over the training set per epoch — set False for "
            "Keras-exact rolling-statistics val metrics)"
        )

    best_monitor = None
    best_es = None
    best_ckpt_path = None
    best_ckpt_variables = None
    best_ckpt_epoch = None
    best_variables = _snapshot(module)
    # Early stopping tracks val_<metric>/max (its own monitor) and, like
    # Keras 2.9 EarlyStopping, restores its best snapshot only when
    # stopping actually triggers.
    es_best_variables = best_variables
    stopped_early = False
    epochs_since_improvement = 0
    if resume_meta is not None:
        train_gen.set_state(resume_meta["train_gen_state"])
        val_gen.set_state(resume_meta["val_gen_state"])
        best_variables = resume_best
        es_best_variables = resume_es_best
        best_monitor = resume_meta["best_monitor"]
        best_es = resume_meta["best_es"]
        epochs_since_improvement = int(resume_meta["epochs_since_improvement"])
        resume_best_epoch = resume_meta.get("best_ckpt_epoch")
        if training_params.model_save_best and resume_best_epoch is not None:
            # Re-materialize the carried best-on-monitor checkpoint in this
            # run's folder, so that it is there (and gets precise
            # statistics at finalisation) even if no later epoch improves.
            best_ckpt_epoch = int(resume_best_epoch)
            best_ckpt_path = (
                save_foldername / f"model_epoch{best_ckpt_epoch:02d}{ckpt_suffix}"
            )
            best_ckpt_variables = resume_best
            if is_main_process:
                ckpt_save(best_ckpt_path, model_name, model_container.get_config(), resume_best)
        if (
            training_params.early_stopping
            and epochs_since_improvement >= training_params.patience
        ):
            # Saved in the very iteration whose patience check stopped the
            # uninterrupted run: finalise only.
            log.info(
                f"Resumed train state is already early-stopped "
                f"(patience {training_params.patience}); "
                "skipping straight to finalization"
            )
            start_epoch = training_params.epochs
            stopped_early = True
    if is_main_process:
        history.on_train_begin()

    # SIGTERM/SIGINT (with train_state_checkpoint on) finish the current
    # batch, skip the remaining epochs and fall through to finalisation;
    # the train-state file of the last completed epoch is the resume point.
    interrupt_flag = []
    # One input pipeline at any world size: the rank's rows of each node
    # batch, assembled on a producer thread (a one-device run is a mesh of
    # one that needs no process group).
    batch_mesh = mesh or Mesh(1, 1, 0, device)
    # Each rank traces its own epoch 0 into a file of its own, as JAX's
    # profiler writes one per process.
    trace_name = profiling.TRACE_FILENAME if world == 1 else f"trace_rank{rank}.json"

    def _collective_any(flag) -> bool:
        """True on every rank when ``flag`` is True on any. Every decision
        that follows from a rank's interrupt flag goes through this one
        helper: the epoch loop's stop and the finalisation's refresh skip
        both gate collectives, and a rank-local decision at either would
        leave the other ranks waiting in the next collective."""
        if world > 1 and training_params.train_state_checkpoint:
            return any_rank(flag, mesh)
        return bool(flag)

    prev_handlers = {}
    if training_params.train_state_checkpoint:
        import signal as _signal

        def _on_signal(signum, frame):
            log.warning(
                "Received signal %s — stopping at the next batch boundary", signum
            )
            interrupt_flag.append(signum)

        for _sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                prev_handlers[_sig] = _signal.signal(_sig, _on_signal)
            except ValueError:  # not the main thread
                break

    try:
        for epoch in range(start_epoch, training_params.epochs):
            if is_main_process:
                history.on_epoch_begin(epoch)
            profile_ctx = (
                profiling.trace(training_params.profile_dir, trace_name)
                if epoch == 0
                else contextlib.nullcontext()
            )
            train_losses, train_metrics = [], []
            with profile_ctx:
                # With device augmentation the generator's per-sample
                # choices ride along as a third array.
                batches = (
                    (np.asarray(b[0], np.float32), np.asarray(b[1]))
                    + ((np.asarray(b[2], np.int32),) if use_aug_device else ())
                    for b in train_gen
                )
                for batch in prefetch_to_mesh(batches, batch_mesh):
                    # The per-batch stop only on one rank: over several, a
                    # rank that stopped alone would leave the others waiting
                    # in the next step's collectives.
                    if interrupt_flag and world == 1:
                        break
                    state, loss_val, metric_val = train_step(
                        state, batch[0], batch[1], generator, *batch[2:]
                    )
                    train_losses.append(loss_val)
                    train_metrics.append(metric_val)
            # Every rank reaches this agreement after the same number of
            # steps, so the run stops on all ranks together or on none.
            if _collective_any(interrupt_flag):
                state_file = save_foldername / TRAIN_STATE_FILENAME
                if state_file.exists():
                    log.warning(
                        "Training interrupted during epoch %d; finalizing. "
                        "Resume with resume_train_state=%s"
                        + (
                            ". NB the precise-BN finalization is SKIPPED on "
                            "interrupt — this folder's checkpoints keep "
                            "rolling BatchNorm statistics; the resumed run "
                            "re-saves the selected best checkpoint with "
                            "precise statistics at its own finalization"
                            if training_params.bn_precise_stats
                            else ""
                        ),
                        epoch + 1,
                        state_file,
                    )
                else:
                    log.warning(
                        "Training interrupted during epoch %d before any "
                        "epoch completed — no train-state resume point was "
                        "written; final artifacts reflect the partial run",
                        epoch + 1,
                    )
                break
            train_gen.on_epoch_end()

            # With bn_precise_val the validation metrics use statistics
            # refreshed under this epoch's weights; the rolling statistics
            # of the train state are put back afterwards.
            rolling = None
            if use_precise_val:
                rolling = batch_stats(module)
                load_batch_stats(module, _refresh_stats(None, _refresh_seed(seed, epoch)))
            val_losses, val_metrics = [], []
            val_batches = ((np.asarray(bi, np.float32), np.asarray(bl)) for bi, bl in val_gen)
            for images, labels in prefetch_to_mesh(val_batches, batch_mesh):
                loss_val, metric_val = eval_step(state, images, labels)
                val_losses.append(loss_val)
                val_metrics.append(metric_val)
            if rolling is not None:
                load_batch_stats(module, rolling)
            val_gen.on_epoch_end()

            logs = {
                "loss": _mean(train_losses),
                training_params.metric: _mean(train_metrics),
                "val_loss": _mean(val_losses),
                "val_" + training_params.metric: _mean(val_metrics),
            }
            log.info(f"Epoch {epoch + 1}/{training_params.epochs}: {logs}")
            if is_main_process:
                history.on_epoch_end(epoch, logs)
            tracker.log_metrics(logs, step=epoch + 1)
            if tb_writer is not None:
                tb_writer.log_metrics(logs, step=epoch + 1)

            monitored = logs[monitor_name]
            improved = _monitor_improved(monitored, best_monitor, monitor_mode)
            state_host = _snapshot(module)
            if improved:
                best_monitor = monitored
                best_variables = state_host
            if improved or not training_params.model_save_best:
                # Remember the file and the weights it holds for the
                # precise-BN re-save at finalisation.
                best_ckpt_path = save_foldername / f"model_epoch{epoch + 1:02d}{ckpt_suffix}"
                best_ckpt_variables = state_host
                best_ckpt_epoch = epoch + 1
                if is_main_process:
                    ckpt_save(
                        best_ckpt_path, model_name, model_container.get_config(), state_host
                    )

            if training_params.early_stopping:
                es_value = logs["val_" + training_params.metric]
                if best_es is None or es_value > best_es:
                    best_es = es_value
                    epochs_since_improvement = 0
                    es_best_variables = state_host
                else:
                    epochs_since_improvement += 1

            if training_params.train_state_checkpoint:
                # Every rank's step generator, gathered before rank 0 writes.
                gen_state = generator.get_state().numpy()
                gen_states = (
                    {"generator_states": all_gather_host(gen_state, mesh)}
                    if world > 1
                    else {"generator_state": gen_state}
                )
            if training_params.train_state_checkpoint and is_main_process:
                arrays, opt_scalars = _state_arrays(state, best_variables, es_best_variables)
                save_train_state(
                    save_foldername / TRAIN_STATE_FILENAME,
                    arrays,
                    {
                        "epoch": epoch + 1,
                        "step": state.step,
                        **gen_states,
                        "optimizer_scalars": opt_scalars,
                        "best_monitor": best_monitor,
                        "best_es": best_es,
                        "best_ckpt_epoch": best_ckpt_epoch,
                        "epochs_since_improvement": epochs_since_improvement,
                        "model_name": model_name,
                        "model_config": model_container.get_config(),
                        "run_config": _resume_run_config(
                            training_params, training_dataset_md5
                        ),
                        "train_gen_state": train_gen.get_state(),
                        "val_gen_state": val_gen.get_state(),
                    },
                )

            if (
                training_params.early_stopping
                and epochs_since_improvement >= training_params.patience
            ):
                log.info(
                    f"Early stopping at epoch {epoch + 1} "
                    f"(patience {training_params.patience})"
                )
                stopped_early = True
                break
    finally:
        # Always restore the process's signal handlers.
        if prev_handlers:
            import signal as _signal

            for _sig, _h in prev_handlers.items():
                # signal.signal() returns None for a handler installed from C
                _signal.signal(_sig, _signal.SIG_DFL if _h is None else _h)

    if is_main_process:
        history.on_train_end()

    # Keras 2.9 EarlyStopping: restore_best_weights applies only when early
    # stopping triggered, and restores its own best (val_<metric>/max).
    if (
        training_params.early_stopping
        and stopped_early
        and training_params.restore_best_weights
    ):
        final_variables = es_best_variables
    else:
        final_variables = _snapshot(module)

    # Precise-BN finalisation: population statistics of the (un-augmented)
    # training data under the final weights, and under the recorded
    # best/last checkpoint's weights for its re-save. Skipped after a
    # SIGTERM/SIGINT: the resumed run's finalisation does it. Over several
    # ranks the skip is agreed (the refresh is a collective).
    interrupted = _collective_any(interrupt_flag)
    precise_stats_applied = (
        training_params.bn_precise_stats
        and _has_bn_stats(final_variables)
        and not interrupted
    )
    if precise_stats_applied:
        log.info(
            "Finalizing BatchNorm statistics: exact population stats over "
            f"{n_stat_full * nodes} training images (bn_precise_stats=True; set False "
            "for reference-exact rolling statistics). Only model_final and the "
            "recorded best/last model_epochNN file carry the precise statistics."
        )

        def _with_precise_stats(variables):
            stats = _refresh_stats(variables, _refresh_seed(seed))
            return {**variables, **{k: v.cpu() for k, v in stats.items()}}

        final_variables = _with_precise_stats(final_variables)
        if best_ckpt_path is not None:
            same_weights = all(
                torch.equal(best_ckpt_variables[k], final_variables[k])
                for k in final_variables
                if not k.endswith(("running_mean", "running_var"))
            )
            # Every rank runs the refresh (it is a collective); rank 0 writes.
            best_final = (
                final_variables if same_weights else _with_precise_stats(best_ckpt_variables)
            )
            if is_main_process:
                ckpt_save(best_ckpt_path, model_name, model_container.get_config(), best_final)

    final_path = save_foldername / f"model_final{ckpt_suffix}"
    if is_main_process:
        try:
            with h5.File(save_foldername / "training_params.hdf5", "a") as f:
                f.attrs["bn_precise_stats_applied"] = bool(precise_stats_applied)
        except OSError:  # artifact missing or unwritable: never fail the run
            log.warning("could not record bn_precise_stats_applied in training_params.hdf5")
        ckpt_save(final_path, model_name, model_container.get_config(), final_variables)
        if final_path.is_file():
            tracker.log_artifact(final_path, artifact_path="model")
    if tb_writer is not None:
        tb_writer.close()
    tracker.end_run()
    return save_foldername
