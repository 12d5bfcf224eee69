"""The plain reference against the port at small sizes on the CPU: the
same seeded weights load into both; forwards, maps and min-path rows
agree."""

import copy

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.harness.cell import load_json
from portbench.reference import deeplab as deeplab_ref
from portbench.reference import minpath as minpath_ref
from portbench.reference import unet as unet_ref

REFS = {"unet-sn8": unet_ref, "deeplabv3plus-r50": deeplab_ref}


def small(config, h=64, w=128, **kw):
    cfg = copy.deepcopy(load_json("configs", config))
    cfg["model"]["kwargs"].update(image_height=h, image_width=w, **kw)
    return cfg


def port_module(cfg, weights):
    from oct_image_segmentation_models_torch.models import get_model_class

    kw = cfg["model"]["kwargs"]
    module = get_model_class(cfg["model"]["name"])(**kw).build_model(device="cpu")
    module.load_state_dict(weights, strict=True)
    return module


@pytest.mark.parametrize("config", sorted(REFS))
def test_param_spec_is_the_modules_state_dict(config):
    cfg = small(config)
    weights = data.make_weights(REFS[config].param_spec(cfg["model"]["kwargs"]), 5, "cpu")
    module = port_module(cfg, weights)
    assert list(module.state_dict()) == list(weights)


@pytest.mark.parametrize("config", sorted(REFS))
def test_eval_forward_matches_the_port(config):
    cfg = small(config)
    kw = cfg["model"]["kwargs"]
    ref = REFS[config]
    weights = data.make_weights(ref.param_spec(kw), 11, "cpu")
    images = torch.from_numpy(data.rng(3, 0).integers(0, 256, (2, 64, 128, kw["input_channels"]), dtype=np.uint8))
    data.calibrate(ref, weights, kw, images.numpy(), "cpu")
    module = port_module(cfg, weights)
    with torch.no_grad():
        want = torch.softmax(ref.logits(weights, ref.preprocess(images), kw), dim=1).permute(0, 2, 3, 1)
        from oct_image_segmentation_models_torch.models import get_model_class

        pre = get_model_class(cfg["model"]["name"])(**kw).get_preprocess_input_fn()
        got = module(pre(images.to(torch.float32)))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_train_forward_matches_the_port():
    cfg = small("unet-sn8", start_neurons=4)
    kw = cfg["model"]["kwargs"]
    weights = data.make_weights(unet_ref.param_spec(kw), 2, "cpu")
    module = port_module(cfg, weights).train()
    x = torch.rand(2, 64, 128, 1)
    gen = torch.Generator().manual_seed(9)
    got = module(x, generator=gen)
    keep = torch.rand(unet_ref.bottleneck_shape(kw, 2, 64, 128), generator=torch.Generator().manual_seed(9)) < 0.5
    want = torch.softmax(unet_ref.logits(weights, x, kw, train=True, keep=keep), dim=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maps_and_rows_match_the_port(seed):
    from oct_image_segmentation_models_torch.ops.boundary import boundary_maps_from_labels
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference

    _images, labels = data.layered_dataset(data.rng(seed, 0), 3, 48, 96, 4)
    lab = torch.from_numpy(labels[..., 0])
    # Noisy labels too: ties and broken ridges.
    noisy = torch.where(torch.rand(lab.shape, generator=torch.Generator().manual_seed(seed)) < 0.02,
                        torch.randint(0, 4, lab.shape, generator=torch.Generator().manual_seed(seed)), lab)
    for labels_ in (lab, noisy):
        maps = minpath_ref.boundary_maps_from_labels(labels_, 4)
        assert torch.equal(maps, boundary_maps_from_labels(labels_, 4))
        t = maps.transpose(-1, -2).reshape(-1, 96, 48).contiguous()
        assert torch.equal(minpath_ref.delineate_fast(t), delineate_reference(t, tie_parity="fast"))


@pytest.mark.parametrize("family", ["plateau", "sparse", "constant"])
def test_fast_rows_on_tie_heavy_maps(family):
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference

    r = data.rng(7, 1)
    if family == "sparse":
        maps = (r.random((6, 80, 40)) < 0.15).astype(np.uint8) * 255
    elif family == "constant":
        maps = np.broadcast_to(np.array([0, 255, 128, 0, 255, 128], np.uint8)[:, None, None], (6, 80, 40)).copy()
    else:
        rows = np.clip(20 + np.cumsum(r.integers(-1, 2, (6, 80)), 1), 1, 37)
        maps = np.zeros((6, 80, 40), np.uint8)
        maps[np.arange(6)[:, None], np.arange(80)[None], rows] = 255
        maps |= np.roll(maps, 1, axis=2)
    t = torch.from_numpy(maps)
    for g in (1, 2):
        assert torch.equal(minpath_ref.delineate_fast(t, g), delineate_reference(t, g, tie_parity="fast"))
