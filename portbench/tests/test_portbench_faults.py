"""A whole run of each cell on the CPU at a small size, past the harness's
look for a card: the sound program comes out correct, and each fault the
cell can have, planted in the timed path, comes out not correct against
the cell's committed limits."""

import copy

import pytest
import torch

from portbench.drivers import serve_volumes, train_loop
from portbench.harness.cell import Cell, load_json

SERVE = {"unet-cubes": ("unet-sn8", "cubes"), "deeplab-cubes": ("deeplabv3plus-r50", "cubes")}
# The training driver has no cell yet (its limits come with one); these are
# the limits it was proven under on the card at start_neurons 32.
TRAIN_LIMITS = {"loss_gap": 4e-3, "grad_norm_gap": 3.5e-3, "change_norm_gap": 8e-2}


def small(workload, config, traffic, limits=None, **tr):
    cfg = copy.deepcopy(load_json("configs", config))
    kw = cfg["model"]["kwargs"]
    kw.update(image_height=64, image_width=128)
    if "start_neurons" in kw:
        kw.update(start_neurons=4, pool_layers=2)
    t = dict(load_json("traffic", traffic), **tr)
    return Cell(workload, cfg, t, 2**31 + 77, 0.5, False, torch.device("cpu"), limits or load_json("limits", workload))


def serve_cell(workload, sizes=(3, 9)):
    """The cell at 64x128; ``sizes`` of whole batches make every row of a
    batch a served B-scan."""
    config, traffic = SERVE[workload]
    return small(workload, config, traffic, pool=8, volume_bscans=list(sizes), block_repeats=1, sample_bscans=12)


def train_cell():
    return small("unet-train", "unet-sn8", "train", TRAIN_LIMITS, pool=24)


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def broken_pipeline(monkeypatch, fault):
    from oct_image_segmentation_models_torch.ops import inference

    forward = inference.FusedPipeline.forward

    def broken(self, images):
        labels, maps, rows = forward(self, images)
        if fault == "altered":
            rows = rows.clone()
            rows[0] = (rows[0].to(torch.int32) + 1).clamp(max=images.shape[1] - 1).to(rows.dtype)
        else:  # half of the batch left out
            half = labels.shape[0] // 2
            labels, rows = labels.clone(), rows.clone()
            labels[half:] = 0
            rows[half:] = 0
        return labels, maps, rows

    monkeypatch.setattr(inference.FusedPipeline, "forward", broken)


@pytest.mark.parametrize("workload", sorted(SERVE))
def test_sound_serving_is_correct(workload):
    out = serve_volumes.run(serve_cell(workload))
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
@pytest.mark.parametrize("workload", sorted(SERVE))
def test_serving_fault_is_not_correct(workload, fault, monkeypatch):
    broken_pipeline(monkeypatch, fault)
    out = serve_volumes.run(serve_cell(workload, sizes=[8, 16]))
    assert not out.correct, out.checks


def test_sound_training_is_correct():
    out = train_loop.run(train_cell())
    assert out.correct, out.checks
    assert out.notes["forward"] == "s2d" and out.failed == 0


def test_training_state_unchanged_is_not_correct(monkeypatch):
    from oct_image_segmentation_models_torch.parallel import train_step

    monkeypatch.setattr(train_step.OptaxRule, "step", lambda self, closure=None: None)
    out = train_loop.run(train_cell())
    assert not out.correct and out.checks["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch_is_not_correct(monkeypatch):
    from oct_image_segmentation_models_torch.ops import losses

    entry = losses.custom_loss_objects["focal_dice_loss"]
    factory = entry["function"]

    def half_batch(**kw):
        fn = factory(**kw)
        return lambda y, p: fn(y[: len(y) // 2], p[: len(p) // 2])

    monkeypatch.setitem(losses.custom_loss_objects, "focal_dice_loss", dict(entry, function=half_batch))
    out = train_loop.run(train_cell())
    assert not out.correct, out.checks


def test_training_loss_altered_is_not_correct(monkeypatch):
    from oct_image_segmentation_models_torch.ops import losses

    entry = losses.custom_loss_objects["focal_dice_loss"]
    factory = entry["function"]

    def altered(**kw):
        fn = factory(**kw)
        return lambda y, p: 1.01 * fn(y, p)

    monkeypatch.setitem(losses.custom_loss_objects, "focal_dice_loss", dict(entry, function=altered))
    out = train_loop.run(train_cell())
    assert not out.correct, out.checks


def test_the_controls_run(monkeypatch):
    from portbench import readings

    serve = readings.control_serve(serve_cell("unet-cubes"))["control_tf32"]
    assert serve["judged_bscans"] >= 12 and serve["label_gap"] >= 0
    train = readings.control_train(train_cell())
    assert set(train) == {"control_tf32", "fault_half_batch"}
    assert train["fault_half_batch"]["loss_gap"] > train["control_tf32"]["loss_gap"]
