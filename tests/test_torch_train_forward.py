"""Which forward the port's ``train_model`` trains, against the JAX
package's rule, on the CPU.

JAX's ``train_model`` (``training/training.py``, where it sets
``compute_module``) trains through ``ops/s2d_train.py::S2DTrainForward``
unless ``train_forward_impl`` is "parity", wherever
``maybe_build_s2d_train`` builds one for the model's config and the
training image dims; "s2d" raises ``ValueError`` where it builds none.

- ``resolve_train_forward`` picks the s2d forward in exactly the cases
  where JAX's rule does (an eligible U-Net at dims that divide, the same
  U-Net at dims that do not, an ineligible U-Net config, DeepLabV3+), for
  each of "auto", "s2d" and "parity", with JAX's number of transformed
  levels, and raises where JAX raises.
- ``train_model`` with the default ``TrainingParams`` trains, evaluates
  and refreshes BatchNorm through ``S2DTrainForward`` for an eligible
  U-Net, in float32 and in bfloat16; with "parity" through the module.
"""

import functools
import json

import numpy as np
import pytest

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import s2d_train as jst
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models.unet import UNetModule
from oct_image_segmentation_models_torch.ops import bn_refresh as port_bn
from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward
from oct_image_segmentation_models_torch.training import TrainingParams, train_model
from oct_image_segmentation_models_torch.training import training as port_training
from oct_image_segmentation_models_torch.training.training import resolve_train_forward

from synth import make_dataset

UNET = dict(input_channels=1, num_classes=3, start_neurons=2, pool_layers=2)
CASES = {
    "eligible U-Net": ("unet", UNET, (32, 48)),
    "dims do not divide": ("unet", UNET, (34, 48)),
    "ineligible config": ("unet", dict(UNET, conv_layers=3), (32, 48)),
    "deeplabv3plus": ("deeplabv3plus", dict(input_channels=3, num_classes=3), (32, 32)),
}


def _jax_choice(name, config, h, w, impl):
    """JAX's ``train_model`` rule: ("s2d", levels), ("parity", None), or
    ValueError for "s2d" where no s2d forward is built."""
    container = jax_model_class(name)(**config, image_height=h, image_width=w)
    if impl == "parity":
        return "parity", None
    fwd = jst.maybe_build_s2d_train(container.build_model(), container.get_config(), h, w)
    if fwd is not None:
        return "s2d", fwd.s2d_levels
    if impl == "s2d":
        return ValueError, None
    return "parity", None


@functools.lru_cache(maxsize=None)
def _port_model(case):
    """(the port's container, its module) for ``case``, built once."""
    name, config, (h, w) = CASES[case]
    container = get_model_class(name)(**config, image_height=h, image_width=w)
    return container, container.build_model(device="cpu")


@pytest.mark.parametrize("impl", ["auto", "s2d", "parity"])
@pytest.mark.parametrize("case", list(CASES))
def test_resolution_matches_jax(case, impl):
    name, config, (h, w) = CASES[case]
    want, levels = _jax_choice(name, config, h, w, impl)
    container, module = _port_model(case)
    if want is ValueError:
        with pytest.raises(ValueError, match="train_forward_impl='s2d'"):
            resolve_train_forward(module, container.get_config(), h, w, impl)
        return
    forward, kind = resolve_train_forward(module, container.get_config(), h, w, impl)
    assert kind == want, (case, impl)
    if kind == "parity":
        assert forward is module
    else:
        assert isinstance(forward, S2DTrainForward) and forward.s2d_levels == levels
        assert forward.blocks is module.blocks and forward.head is module.head


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("torch_train_forward") / "ds.hdf5", n_train=4)


@pytest.mark.parametrize(
    "dtype,impl,want",
    [
        ("float32", None, S2DTrainForward),
        ("bfloat16", None, S2DTrainForward),
        ("float32", "parity", UNetModule),
    ],
)
def test_default_run_trains_through_s2d(dataset, tmp_path, monkeypatch, dtype, impl, want):
    """The forwards handed to the train step, the eval step and the
    precise-BN refresher of a default run."""
    seen = []

    def spy(name, real):
        def wrapped(module, *args, **kwargs):
            seen.append((name, type(module)))
            return real(module, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(port_training, "make_train_step", spy("train", port_training.make_train_step))
    monkeypatch.setattr(port_training, "make_eval_step", spy("eval", port_training.make_eval_step))

    class Refresher(port_bn.BNRefresher):
        def __init__(self, module, *args, **kwargs):
            seen.append(("refresh", type(module)))
            super().__init__(module, *args, **kwargs)

    monkeypatch.setattr(port_bn, "BNRefresher", Refresher)
    hyper = dict(start_neurons=2, pool_layers=2)
    if dtype == "bfloat16":
        hyper["dtype"] = dtype
    params = TrainingParams(
        model_architecture="unet", training_dataset_path=dataset, initial_model=None,
        results_location=tmp_path, opt_con="adam", opt_params={"learning_rate": 1e-3},
        loss="dice_loss_macro", metric="dice_coef_macro", epochs=1, batch_size=2,
        model_hyperparameters=hyper, seed=3, device="cpu",
        **({} if impl is None else {"train_forward_impl": impl}),
    )
    assert params.train_forward_impl == (impl or "auto")
    folder = train_model(params)
    assert seen == [("train", want), ("eval", want), ("refresh", want)]
    assert (folder / "model_final.hdf5").exists()
    last = json.loads((folder / "mlflow_metrics.jsonl").read_text().splitlines()[-1])
    assert np.isfinite(list(last.values())).all()
