"""The port's ``train_model`` over several ranks against the JAX
package's on its mesh, on the CPU.

- Two ranks on one node (gloo, spawned as ``tests/test_torch_dp_step.py``
  spawns them) against JAX's ``train_model`` under this suite's 8 virtual
  CPU devices, which trains batch 2 on a mesh of gcd(2, 8) = 2 devices
  with per-replica BatchNorm: the configuration, initial checkpoint and
  dataset of ``tests/test_torch_training.py``'s pairing. The artifact trees
  must hold the same files, every HDF5 file the same datasets, shapes,
  dtypes and attributes (values equal but the timestamp), JSON files equal;
  only rank 0 writes; the held-out dice of the two final checkpoints,
  both run by the port, within ``DICE_BAND`` of each other. The dropout
  masks differ (a ``torch.Generator`` per rank against JAX's keys), and
  JAX's shard_map step applies the sum of its devices' gradients where
  the port's averages (Adam takes them to nearly one update,
  ``tests/test_torch_dp_step.py``), so the runs agree in dice, not in
  weights.
- Two nodes of one rank, each on its own strided shard, trained with the
  train-state file on: SIGTERM to rank 1 alone stops both at the epoch
  boundary and both finalise (precise BN skipped on every rank, recorded
  in ``training_params.hdf5``); the train state holds both ranks' step
  generators, and one rank cannot resume it.
- Two ranks with ``profile_dir``: each writes its own trace of the first
  epoch, as JAX's profiler writes one per process.
"""

import json
import signal
import time
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oct_image_segmentation_models_tpu.common.model_io import save_model as jax_save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.training import TrainingParams as JaxTrainingParams
from oct_image_segmentation_models_tpu.training import train_model as jax_train_model

from oct_image_segmentation_models_torch.training import TrainingParams, train_model
from oct_image_segmentation_models_torch.training.training import load_train_state

from synth import make_dataset
from test_torch_dp_step import join_ranks, run_ranks, start_ranks
from test_torch_training import (
    C,
    DICE_BAND,
    H,
    W,
    _attrs_equal,
    _h5_items,
    _held_out_dice,
    _tree,
)

TRAIN_BODY = """
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

kwargs = json.loads(open(f"{workdir}/params.json").read())
folder = train_model(
    TrainingParams(results_location=f"{workdir}/rank{rank}", device="cpu", **kwargs)
)
with open(f"{workdir}/result{rank}.json", "w") as fh:
    json.dump({"folder": str(folder)}, fh)
"""


@pytest.fixture(scope="module")
def paired_runs(tmp_path_factory):
    """(JAX run folder, the ranks' folders, dataset) from one initial
    checkpoint, as ``test_torch_training.py`` pairs them."""
    root = tmp_path_factory.mktemp("dp_training_pair")
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
        model_architecture=None, training_dataset_path=str(ds), initial_model=str(init),
        opt_con="adam", opt_params={"learning_rate": 3e-3}, loss="focal_dice_loss",
        metric="dice_coef_macro", epochs=7, batch_size=2, seed=0,
        augmentations=[{"name": "flip", "arguments": {"flip_type": "left-right"}}],
        aug_mode="one", aug_fly=True, class_weight="balanced",
        train_state_checkpoint=True, train_forward_impl="parity",
    )
    ranks = root / "port"
    ranks.mkdir()
    (ranks / "params.json").write_text(json.dumps(kwargs))
    procs = start_ranks(ranks, TRAIN_BODY, world=2, local=2)  # beside JAX's run
    jax_folder = jax_train_model(JaxTrainingParams(results_location=root / "jax", **kwargs))
    join_ranks(procs)
    folders = [Path(json.loads((ranks / f"result{r}.json").read_text())["folder"]) for r in range(2)]
    return jax_folder, folders, ds


def test_two_rank_artifact_tree_matches_jax_mesh(paired_runs):
    jax_folder, (port_folder, other), _ = paired_runs
    assert not other.exists()  # only rank 0 writes
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
    with h5py.File(port_folder / "training_params.hdf5", "r") as f:
        assert f.attrs["batch_size"] == 2
        assert bool(f.attrs["bn_precise_stats_applied"]) is True


def test_two_rank_run_reaches_the_jax_dice_band(paired_runs):
    jax_folder, (port_folder, _), ds = paired_runs
    jax_dice = _held_out_dice(jax_folder, ds)
    port_dice = _held_out_dice(port_folder, ds)
    assert jax_dice > 0.8, jax_dice
    assert abs(port_dice - jax_dice) <= DICE_BAND, (port_dice, jax_dice)


def test_interrupt_on_one_rank_finalizes_both(tmp_path):
    ds = make_dataset(tmp_path / "ds.hdf5", n_train=8, n_val=4, n_test=2, h=16, w=16)
    kwargs = dict(
        model_architecture="unet", training_dataset_path=str(ds), initial_model=None,
        opt_con="adam", loss="dice_loss_macro", metric="dice_coef_macro", epochs=500,
        batch_size=4, model_hyperparameters={"start_neurons": 2, "pool_layers": 2},
        seed=0, train_state_checkpoint=True,
    )
    (tmp_path / "params.json").write_text(json.dumps(kwargs))
    procs = start_ranks(tmp_path, TRAIN_BODY, world=2, local=1)
    fired = False
    try:
        # SIGTERM to rank 1 alone once rank 0 has finished two epochs.
        deadline = time.time() + 90
        while time.time() < deadline and not fired:
            if any(
                int(p.name[len("stats_epoch"):-len(".hdf5")]) >= 2
                for p in (tmp_path / "rank0").glob("*/stats_epoch*.hdf5")
            ):
                procs[1].send_signal(signal.SIGTERM)
                fired = True
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
    finally:
        if not fired:  # a stalled run: end it now rather than at the join's limit
            for p in procs:
                p.kill()
        join_ranks(procs)
    assert fired, "epoch-2 stats never appeared; training stalled"
    folder = Path(json.loads((tmp_path / "result0.json").read_text())["folder"])
    assert (folder / "model_final.hdf5").exists()
    assert len(list(folder.glob("stats_epoch*.hdf5"))) < 500
    with h5py.File(folder / "training_params.hdf5", "r") as f:
        assert bool(f.attrs["bn_precise_stats"]) is True
        assert bool(f.attrs["bn_precise_stats_applied"]) is False
    # The train state holds both ranks' step generators and resumes only
    # at the world size that wrote it.
    meta, _ = load_train_state(folder / "train_state_latest.npz")
    assert len(meta["generator_states"]) == 2 and "generator_state" not in meta
    with pytest.raises(ValueError, match="resumes only at that world size"):
        train_model(TrainingParams(
            **{**kwargs, "model_architecture": None},
            resume_train_state=folder / "train_state_latest.npz",
            results_location=tmp_path / "resumed", device="cpu",
        ))


def test_each_rank_traces_into_its_own_file(tmp_path):
    ds = make_dataset(tmp_path / "ds.hdf5", n_train=4, n_val=2, n_test=2, h=16, w=16)
    kwargs = dict(
        model_architecture="unet", training_dataset_path=str(ds), initial_model=None,
        opt_con="adam", loss="dice_loss_macro", metric="dice_coef_macro", epochs=1,
        batch_size=2, model_hyperparameters={"start_neurons": 2, "pool_layers": 2},
        seed=0, profile_dir=str(tmp_path / "profile"),
    )
    (tmp_path / "params.json").write_text(json.dumps(kwargs))
    run_ranks(tmp_path, TRAIN_BODY, world=2, local=2)
    traces = sorted(p.name for p in (tmp_path / "profile").iterdir())
    assert traces == ["trace_rank0.json", "trace_rank1.json"]
    for name in traces:
        events = json.loads((tmp_path / "profile" / name).read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events), name
