"""The yardstick's analytic FLOPs against ``torch.utils.flop_counter`` on
the port's plain modules at a small size."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import flops
from portbench.harness.cell import load_json


@pytest.mark.parametrize("config", ["unet-sn8", "deeplabv3plus-r50"])
@pytest.mark.parametrize("hw", [(64, 128), (96, 64)])
def test_forward_flops_match_the_flop_counter(config, hw):
    from oct_image_segmentation_models_torch.models import get_model_class

    cfg = copy.deepcopy(load_json("configs", config))
    kw = cfg["model"]["kwargs"]
    kw.update(image_height=hw[0], image_width=hw[1])
    module = get_model_class(cfg["model"]["name"])(**kw).build_model(device="cpu")
    x = torch.rand(2, hw[0], hw[1], kw["input_channels"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        module(x)
    assert counter.get_total_flops() == 2 * flops.forward_flops(cfg)


def test_full_size_flops():
    # 109.9 and 1271.2 GFLOP a batch of 8 at 512x1024.
    assert flops.forward_flops(load_json("configs", "unet-sn8")) == 13_732_151_296
    assert flops.forward_flops(load_json("configs", "deeplabv3plus-r50")) == 158_897_143_808


def test_minpath_bytes():
    assert flops.minpath_bytes(24, 512, 1024) == 24 * 512 * 1024 + 24 * 1024 * 4
