"""Inputs repeat by seed, and every seed gets the same work per block."""

import collections
import copy

import numpy as np
import pytest
import torch

from portbench.drivers import serve_volumes, train_loop
from portbench.harness import data
from portbench.harness.cell import Cell, load_json

BIG = 2**31 + 987654321


def small_cell(traffic, seed, **tr):
    cfg = copy.deepcopy(load_json("configs", "unet-sn8"))
    cfg["model"]["kwargs"].update(image_height=32, image_width=64)
    t = dict(load_json("traffic", traffic), **tr)
    return Cell("t", cfg, t, seed, 1.0, False, torch.device("cpu"), {})


def test_pool_repeats_by_seed():
    a = data.make_pool(BIG, small_cell("cubes", BIG).config, {"pool": 4})
    b = data.make_pool(BIG, small_cell("cubes", BIG).config, {"pool": 4})
    c = data.make_pool(BIG + 1, small_cell("cubes", BIG).config, {"pool": 4})
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_weights_repeat_by_seed():
    spec = [("w", (4, 3, 3, 3), "conv_w"), ("v", (4,), "bn_var")]
    a, b = data.make_weights(spec, BIG, "cpu"), data.make_weights(spec, BIG, "cpu")
    c = data.make_weights(spec, BIG + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["w"], c["w"])
    assert bool((a["v"] > 0).all())


@pytest.mark.parametrize("mix", [{}, {"volume_bscans": list(range(1, 17)), "block_repeats": 1}])
def test_every_block_is_the_same_work(mix):
    sizes = {}
    for seed in (1, BIG):
        cell = small_cell("cubes", seed, pool=8, **mix)
        pool = data.make_pool(seed, cell.config, cell.traffic)[0]
        vols = serve_volumes.volumes(cell, pool)
        order = serve_volumes.order(cell, blocks=3)
        per = len(vols)
        blocks = [collections.Counter(len(vols[k][0]) for k in order[i : i + per]) for i in range(0, 3 * per, per)]
        assert blocks[0] == blocks[1] == blocks[2]
        sizes[seed] = (blocks[0], order)
    assert sizes[1][0] == sizes[BIG][0] and sizes[1][1] != sizes[BIG][1]
    assert serve_volumes.order(small_cell("cubes", 1, pool=8, **mix), 3) == sizes[1][1]


def test_train_batches_repeat_and_differ_within_the_checked_steps():
    cell = small_cell("train", BIG, pool=24)
    images, labels = data.make_pool(BIG, cell.config, cell.traffic)
    a = train_loop.host_batches(cell, images, labels)
    b = train_loop.host_batches(cell, images, labels)
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    first = np.concatenate([im for im, _l, _c in a[: cell.traffic["check_steps"]]])
    assert len({x.tobytes() for x in first}) == len(first)
