"""JAX's and the port's ``train_model`` under ``train_forward_impl="auto"``
from one JAX-written initial checkpoint, on the CPU.

Both train the U-Net at start_neurons=4, pool_layers=2 (s2d-eligible at
32x48) for 2 epochs on one ``synth.make_dataset`` file (8 training
images, batch 2, focal + Dice, Adam 3e-3, precise BN on), so both train
through their s2d training forward. The port's dropout masks are JAX's:
every key JAX's train steps and precise-BN refreshes draw a mask with is
recorded in order, and the port's ``dropout_mask`` takes JAX's mask for
the next key (``test_torch_train_step._jax_mask``), so the two runs see
the same masks and, with the data generators' shared shuffle, the same
batches. ``train_step_impl="spmd"``: the suite's 8 virtual devices give
JAX's run a mesh of 2 (the batch), on which "auto" would take per-device
BatchNorm and masks; "spmd" is the one-device step on the global batch,
which the port's one device runs.

- Both runs log that they train through the s2d forward, the port draws
  exactly as many masks as JAX, and the two artifact trees have the same
  files.
- Every epoch's loss, metric, val loss and val metric within 5e-3
  relative, and the two final checkpoints' eval forwards (both run by
  the port) on the held-out images within 0.05. Measured on this
  configuration over the dataset seeds 1-7 and 33: at 6 of the 8 the two
  runs agree to float32 rounding (metrics within 3.0e-7 relative,
  parameters within 2.3e-4 of a tensor's max, forwards within 1.9e-6;
  at this test's seed 33, 1.3e-7 and 8.3e-7); at seeds 3 and 7 they part
  within the first epoch (metrics up to 1.2e-3, forwards up to 0.044,
  parameters up to 0.14 of a tensor's max), as the two packages' parity
  runs part at seed 3 (5.4e-3, 0.013): float32 sums taken in another
  order by XLA and by oneDNN, carried on by Adam. So the parameters are
  not held value for value, and the bounds sit just above the parted
  seeds' readings, where a CPU that sums in yet another order could put
  this seed's run.
"""

import json
import logging
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common.model_io import save_model as jax_save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import bn_refresh as jax_bn
from oct_image_segmentation_models_tpu.training import TrainingParams as JaxTrainingParams
from oct_image_segmentation_models_tpu.training import train_model as jax_train_model
from oct_image_segmentation_models_tpu.training import training as jax_training
from oct_image_segmentation_models_torch.common.model_io import load_model
from oct_image_segmentation_models_torch.models import unet as port_unet
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

from synth import make_dataset
from test_torch_train_step import _jax_mask
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

H, W, C = 32, 48, 3
METRIC_RTOL = 5e-3
FORWARD_ATOL = 0.05
S2D_LOG = "Using s2d-transformed training forward"


def _record_jax_keys(monkeypatch) -> list:
    """The dropout keys of JAX's train steps and precise-BN batches, in
    the order the run draws them."""
    keys = []
    make_step = jax_training.make_train_step

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, x, y, key, *rest, **kw):
            keys.append(key)
            return step(state, x, y, key, *rest, **kw)

        return recorded

    refresh = jax_bn.BNRefresher.__call__

    def refresh_recorded(self, params, stats, batches, rng=None, cross_process=False):
        batches = list(batches)
        base = jax.random.PRNGKey(0) if rng is None else rng
        keys.extend(jax.random.fold_in(base, i) for i in range(len(batches)))
        return refresh(self, params, stats, batches, rng=rng, cross_process=cross_process)

    monkeypatch.setattr(jax_training, "make_train_step", make)
    monkeypatch.setattr(jax_bn.BNRefresher, "__call__", refresh_recorded)
    return keys


def _metrics(folder: Path) -> list:
    return [json.loads(x) for x in (folder / "mlflow_metrics.jsonl").read_text().splitlines()]


def test_auto_run_matches_jax(tmp_path, monkeypatch, caplog):
    ds = make_dataset(tmp_path / "ds.hdf5", n_train=8, n_val=2, n_test=2, h=H, w=W,
                      num_classes=C, seed=33)
    container = jax_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=2,
    )
    module = container.build_model()
    # XLA's backend optimisation off: half the compile time, the same
    # weights bit for bit as the default compile's.
    variables = jax.jit(
        lambda k: module.init(k, jnp.zeros((1, H, W, 1)), training=False),
        compiler_options={"xla_backend_optimization_level": 0},
    )(jax.random.PRNGKey(0))
    init = tmp_path / "init.hdf5"
    jax_save_model(init, "unet", container.get_config(),
                   jax.tree_util.tree_map(np.asarray, dict(variables)))
    kwargs = dict(
        model_architecture=None, training_dataset_path=ds, initial_model=init,
        opt_con="adam", opt_params={"learning_rate": 3e-3}, loss="focal_dice_loss",
        metric="dice_coef_macro", epochs=2, batch_size=2, seed=0, train_step_impl="spmd",
    )
    caplog.set_level(logging.INFO)
    keys = _record_jax_keys(monkeypatch)
    jax_folder = jax_train_model(JaxTrainingParams(results_location=tmp_path / "jax", **kwargs))
    assert caplog.text.count(S2D_LOG) == 1
    drawn = len(keys)
    monkeypatch.setattr(
        port_unet, "dropout_mask", lambda x, generator: _jax_mask(keys.pop(0), tuple(x.shape))
    )
    port_folder = train_model(TrainingParams(results_location=tmp_path / "port", device="cpu", **kwargs))
    assert caplog.text.count(S2D_LOG) == 2
    assert drawn > 0 and not keys

    def tree(folder):
        return sorted(str(p.relative_to(folder)) for p in folder.rglob("*"))

    assert tree(port_folder) == tree(jax_folder)
    jax_epochs, port_epochs = _metrics(jax_folder), _metrics(port_folder)
    assert [x["step"] for x in port_epochs] == [x["step"] for x in jax_epochs] == [1, 2]
    for j, p in zip(jax_epochs, port_epochs):
        for k in ("loss", "dice_coef_macro", "val_loss", "val_dice_coef_macro"):
            assert p[k] == pytest.approx(j[k], rel=METRIC_RTOL), (j["step"], k, p[k], j[k])
    with h5py.File(ds, "r") as f:
        x = torch.from_numpy(f["test_images"][:]).float() / 255.0
    with torch.no_grad():
        want, got = (
            load_model(folder / "model_final.hdf5", device="cpu").module(x)
            for folder in (jax_folder, port_folder)
        )
    assert float((got - want).abs().max()) <= FORWARD_ATOL
