"""The port's ``train_model`` against the JAX package's, and its own
resume, early-stopping and interruption contracts, on the CPU.

JAX's ``train_model`` and the port's run the same configuration from one
JAX-written initial checkpoint on one ``synth.make_dataset`` file (12
training images at 32x48, 3 classes, batch 2, the U-Net at
start_neurons=4, pool_layers=2, 7 epochs, focal + Dice loss with balanced
class weights, a flip chosen per sample, the train-state file on). The two
artifact trees must have the same files; every HDF5 file the same dataset
names, shapes and dtypes and the same attributes (values equal except the
timestamp; the training-dependent datasets are compared by shape);
``model_config.json``, the tracker's params and the optimizer snapshot
equal. The held-out dice of the two final checkpoints, both read and run
by the port, must lie within 0.05 of each other, the JAX one above 0.8.
JAX's ``load_model`` must read the port's ``model_final.hdf5``
and compute the port's forward within 1e-5.

The port-only tests run the U-Net at start_neurons=2 on 6 images.
"""

import json
import os
import signal
import threading
import time
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common.model_io import load_model as jax_load_model
from oct_image_segmentation_models_tpu.common.model_io import save_model as jax_save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.training import TrainingParams as JaxTrainingParams
from oct_image_segmentation_models_tpu.training import train_model as jax_train_model
from oct_image_segmentation_models_torch.common.model_io import (
    flax_from_state_dict,
    load_model,
    state_dict_from_flax,
)
from oct_image_segmentation_models_torch.training import TrainingParams, train_model
from oct_image_segmentation_models_torch.training.training import (
    load_train_state,
    save_train_state,
)

from synth import make_dataset
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

H, W, C = 32, 48, 3
DICE_BAND = 0.05
FORWARD_ATOL = 1e-5
# Attributes that differ between any two runs.
RUN_ATTRS = {"timestamp"}


@pytest.fixture(scope="module")
def paired_runs(tmp_path_factory):
    """(JAX run folder, port run folder, dataset) from one initial
    checkpoint."""
    root = tmp_path_factory.mktemp("torch_training_pair")
    ds = make_dataset(root / "ds.hdf5", n_train=12, n_val=4, n_test=6, h=H, w=W,
                      num_classes=C, seed=33)
    container = jax_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=2,
    )
    module = container.build_model()
    variables = jax.jit(
        lambda k: module.init(k, jnp.zeros((1, H, W, 1)), training=False)
    )(jax.random.PRNGKey(0))
    init = root / "init.hdf5"
    jax_save_model(init, "unet", container.get_config(),
                   jax.tree_util.tree_map(np.asarray, dict(variables)))
    kwargs = dict(
        model_architecture=None, training_dataset_path=ds, initial_model=init,
        opt_con="adam", opt_params={"learning_rate": 3e-3}, loss="focal_dice_loss",
        metric="dice_coef_macro", epochs=7, batch_size=2, seed=0,
        augmentations=[{"name": "flip", "arguments": {"flip_type": "left-right"}}],
        aug_mode="one", aug_fly=True, class_weight="balanced",
        train_state_checkpoint=True, train_forward_impl="parity",
    )
    jax_folder = jax_train_model(JaxTrainingParams(results_location=root / "jax", **kwargs))
    port_folder = train_model(
        TrainingParams(results_location=root / "port", device="cpu", **kwargs)
    )
    return jax_folder, port_folder, ds


def _tree(folder: Path):
    return sorted(str(p.relative_to(folder)) for p in folder.rglob("*"))


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: obj.attrs[k] for k in obj.attrs}
            if isinstance(obj, h5py.Dataset):
                out[name] = ("dataset", obj.shape, obj.dtype.str, attrs, obj[()])
            else:
                out[name] = ("group", None, None, attrs, None)
        visit("/", f)
        f.visititems(visit)
    return out


def _attrs_equal(a, b, where):
    assert sorted(a) == sorted(b), where
    for k in a:
        if k in RUN_ATTRS:
            continue
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"{where} {k}")
        else:
            assert va == vb, (where, k, va, vb)


def test_artifact_trees_match_jax(paired_runs):
    jax_folder, port_folder, _ = paired_runs
    assert _tree(port_folder) == _tree(jax_folder)
    for rel in _tree(jax_folder):
        j, p = jax_folder / rel, port_folder / rel
        if rel.endswith(".hdf5"):
            ji, pi = _h5_items(j), _h5_items(p)
            assert sorted(ji) == sorted(pi), rel
            for name in ji:
                kind, shape, dtype, attrs, value = ji[name]
                assert pi[name][:3] == (kind, shape, dtype), (rel, name)
                _attrs_equal(attrs, pi[name][3], f"{rel}:{name}")
                if rel == "training_params.hdf5" and kind == "dataset":
                    np.testing.assert_array_equal(pi[name][4], value)
        elif rel.endswith(".json"):
            assert json.loads(p.read_text()) == json.loads(j.read_text()), rel
        elif rel.endswith(".jsonl"):
            jl = [json.loads(x) for x in j.read_text().splitlines()]
            pl = [json.loads(x) for x in p.read_text().splitlines()]
            assert [sorted(x) for x in pl] == [sorted(x) for x in jl]
            assert [x["step"] for x in pl] == [x["step"] for x in jl]
    with h5py.File(port_folder / "training_params.hdf5", "r") as f:
        assert f.attrs["optimizer"] == b"Adam" and f.attrs["opt_param: epsilon"] == 1e-7
        assert bool(f.attrs["bn_precise_stats_applied"]) is True


def _held_out_dice(folder: Path, ds: Path) -> float:
    with h5py.File(ds, "r") as f:
        x, y = f["test_images"][:], f["test_labels"][:][..., 0]
    module = load_model(folder / "model_final.hdf5", device="cpu").module
    with torch.no_grad():
        pred = module(torch.from_numpy(x).float() / 255.0).argmax(-1).numpy()
    return float(np.mean(
        [2 * ((pred == c) & (y == c)).sum() / ((pred == c).sum() + (y == c).sum()) for c in range(C)]
    ))


def test_short_run_reaches_the_jax_dice_band(paired_runs):
    jax_folder, port_folder, ds = paired_runs
    jax_dice = _held_out_dice(jax_folder, ds)
    port_dice = _held_out_dice(port_folder, ds)
    assert jax_dice > 0.8, jax_dice  # the run learns at all
    assert abs(port_dice - jax_dice) <= DICE_BAND, (port_dice, jax_dice)


def test_jax_load_model_reads_port_checkpoint(paired_runs):
    _, port_folder, ds = paired_runs
    path = port_folder / "model_final.hdf5"
    name, config, variables, _ = jax_load_model(path)
    with h5py.File(ds, "r") as f:
        x = (f["test_images"][:3] / 255.0).astype(np.float32)
    module = jax_model_class(name)(**config).build_model()
    want = np.asarray(module.apply(variables, jnp.asarray(x), training=False))
    port = load_model(path, device="cpu")
    with torch.no_grad():
        got = port.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL)
    # the bridge both ways: the checkpoint's Flax tree back to the same state_dict
    sd = port.module.state_dict()
    again = state_dict_from_flax(flax_from_state_dict(sd))
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k
    flat = flax_from_state_dict(sd)
    assert jax.tree_util.tree_structure(flat) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, variables)
    )


def test_jax_train_state_is_refused(paired_runs, tmp_path):
    jax_folder, _, ds = paired_runs
    with pytest.raises(ValueError, match="not a train state of the PyTorch port"):
        load_train_state(jax_folder / "train_state_latest.npz")
    with pytest.raises(ValueError, match="not a train state of the PyTorch port"):
        train_model(_params(ds, tmp_path, model_architecture=None,
                            resume_train_state=jax_folder / "train_state_latest.npz"))


# --- port-only contracts -------------------------------------------------


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("torch_training_small") / "ds.hdf5")


def _params(dataset, tmp_path, **kw):
    defaults = dict(
        model_architecture="unet", training_dataset_path=dataset, initial_model=None,
        results_location=tmp_path, opt_con="adam", opt_params={"learning_rate": 1e-3},
        loss="dice_loss_macro", metric="dice_coef_macro", epochs=2, batch_size=2,
        model_hyperparameters={"start_neurons": 2, "pool_layers": 2}, seed=7,
        device="cpu",
        # device noise: the torch.Generator stream is part of the resume
        augmentations=[
            {"name": "flip", "arguments": {"flip_type": "left-right"}},
            {"name": "add_noise", "arguments": {"mode": "gaussian", "variance": 0.01}},
        ],
        aug_mode="one", aug_fly=True,
    )
    defaults.update(kw)
    return TrainingParams(**defaults)


@pytest.fixture(scope="module")
def part_run(small_dataset, tmp_path_factory):
    """A 2-epoch run with the rolling train state."""
    return train_model(
        _params(small_dataset, tmp_path_factory.mktemp("part"), train_state_checkpoint=True)
    )


def _final_state_dict(folder):
    return load_model(folder / "model_final.hdf5", device="cpu").module.state_dict()


def test_resume_is_bitwise_exact(small_dataset, part_run, tmp_path):
    full = train_model(_params(small_dataset, tmp_path / "full", epochs=4))
    resumed = train_model(
        _params(small_dataset, tmp_path / "resumed", model_architecture=None,
                resume_train_state=part_run / "train_state_latest.npz", epochs=4)
    )
    want, got = _final_state_dict(full), _final_state_dict(resumed)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    stats = sorted(resumed.glob("stats_epoch*.hdf5"))
    assert stats and stats[-1].name == "stats_epoch04.hdf5"
    # a changed hyperparameter is refused
    with pytest.raises(ValueError, match="run configuration mismatch"):
        train_model(
            _params(small_dataset, tmp_path / "bad", model_architecture=None,
                    resume_train_state=part_run / "train_state_latest.npz", epochs=4, seed=0)
        )


def _rewritten_state(part_run, tmp_path, sentinels: bool):
    """A copy of the part run's train state as if its patience check had
    fired; with ``sentinels``, every best/es_best tensor set to 0.25/0.75."""
    meta, arrays = load_train_state(part_run / "train_state_latest.npz")
    meta["epochs_since_improvement"] = 3
    if sentinels:
        for k in arrays:
            if k.startswith("best/"):
                arrays[k] = np.full_like(arrays[k], 0.25)
            elif k.startswith("es_best/"):
                arrays[k] = np.full_like(arrays[k], 0.75)
    path = tmp_path / "train_state_latest.npz"
    save_train_state(path, arrays, {k: v for k, v in meta.items() if k != "format"})
    return path, meta


def test_early_stop_restores_es_best_weights(small_dataset, part_run, tmp_path):
    """Keras 2.9: when early stopping triggers, the final weights are the
    early-stopping callback's own best, not model_save_monitor's."""
    path, _ = _rewritten_state(part_run, tmp_path, sentinels=True)
    resumed = train_model(
        _params(small_dataset, tmp_path / "resumed", model_architecture=None,
                resume_train_state=path, epochs=10, patience=3,
                restore_best_weights=True, bn_precise_stats=False)
    )
    for k, v in _final_state_dict(resumed).items():
        assert torch.all(v == 0.75), f"finalization restored the wrong snapshot ({k})"


def test_resume_from_early_stopped_state_contract(small_dataset, part_run, tmp_path):
    """The port's pin of the JAX code as it stands: resuming a train state
    whose patience was already exhausted trains no new epoch, writes
    model_final, and re-materializes the carried best model_epochNN."""
    path, meta = _rewritten_state(part_run, tmp_path, sentinels=False)
    resumed = train_model(
        _params(small_dataset, tmp_path / "resumed", model_architecture=None,
                resume_train_state=path, epochs=10, patience=3)
    )
    assert (resumed / "model_final.hdf5").exists()
    assert not list(resumed.glob("stats_epoch*.hdf5"))
    n_best = int(meta["best_ckpt_epoch"])
    assert sorted(p.name for p in resumed.glob("model_epoch*.hdf5")) == [
        f"model_epoch{n_best:02d}.hdf5"
    ]


def test_completed_run_keeps_last_epoch_weights(small_dataset, part_run):
    """A run that completes all its epochs finalizes last-epoch weights
    (its statistics are the precise-BN ones): the final checkpoint's
    weights are the train state's after the last epoch."""
    final = _final_state_dict(part_run)
    meta, arrays = load_train_state(part_run / "train_state_latest.npz")
    for k, v in final.items():
        if "running" not in k:
            np.testing.assert_array_equal(v.numpy(), arrays[f"module/{k}"])
    assert meta["epoch"] == 2 and meta["step"] == 6


def test_sigterm_stops_and_resumes(small_dataset, tmp_path):
    run_dir = tmp_path / "interrupted"

    def fire_when_epoch2_done():
        deadline = time.time() + 60
        while time.time() < deadline:
            if any(int(p.name[len("stats_epoch"):-len(".hdf5")]) >= 2
                   for p in run_dir.glob("*/stats_epoch*.hdf5")):
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    thread = threading.Thread(target=fire_when_epoch2_done, daemon=True)
    thread.start()
    folder = train_model(
        _params(small_dataset, run_dir, epochs=500, train_state_checkpoint=True)
    )
    thread.join(timeout=5)
    assert signal.getsignal(signal.SIGTERM) is not None
    assert (folder / "model_final.hdf5").exists()
    with h5py.File(folder / "training_params.hdf5", "r") as f:
        assert bool(f.attrs["bn_precise_stats"]) is True
        assert bool(f.attrs["bn_precise_stats_applied"]) is False
    meta, _ = load_train_state(folder / "train_state_latest.npz")
    assert 2 <= meta["epoch"] < 500
    resumed = train_model(
        _params(small_dataset, tmp_path / "resumed", model_architecture=None,
                resume_train_state=folder / "train_state_latest.npz",
                epochs=meta["epoch"] + 1)
    )
    assert (resumed / f"model_epoch{int(meta['best_ckpt_epoch']):02d}.hdf5").exists()
    with h5py.File(resumed / "training_params.hdf5", "r") as f:
        assert bool(f.attrs["bn_precise_stats_applied"]) is True


def test_train_model_refusals(small_dataset, tmp_path, tmp_path_factory):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_model(_params(small_dataset, tmp_path, device=None))
    # "s2d" trains an eligible U-Net, and refuses an ineligible one as JAX
    # does (odd conv_layers).
    s2d_run = tmp_path_factory.mktemp("s2d_run")
    folder = train_model(_params(small_dataset, s2d_run, train_forward_impl="s2d", epochs=1))
    assert (folder / "model_final.hdf5").exists()
    with pytest.raises(ValueError, match="s2d-eligible"):
        train_model(_params(
            small_dataset, tmp_path, train_forward_impl="s2d",
            model_hyperparameters={"start_neurons": 2, "pool_layers": 2, "conv_layers": 3},
        ))
    with pytest.raises(ValueError, match="needs a mesh"):
        train_model(_params(small_dataset, tmp_path, train_step_impl="shard_map"))
    with pytest.raises(ValueError, match="model_save_monitor name"):
        train_model(_params(small_dataset, tmp_path, model_save_monitor=("val_acc2", "max")))
    with pytest.raises(ValueError, match="model_save_monitor mode"):
        train_model(_params(small_dataset, tmp_path, model_save_monitor=("val_loss", "Max")))
    with pytest.raises(ValueError, match="Exactly one"):
        _params(small_dataset, tmp_path, initial_model=small_dataset)
    assert not list(tmp_path.iterdir())
