"""The workflows on a machine without h5py and matplotlib: the port's
``train_model``, ``predict`` and ``evaluate_model`` run with both blocked,
read and write every HDF5 file through ``common/h5.py``, and write the
tree that the same runs write with both present, less the PNGs. Every
HDF5 file they wrote reads back through real h5py equal to the results
the runs returned in memory and to the files of the runs with h5py and
matplotlib present."""

import sys
from contextlib import contextmanager
from pathlib import Path

import h5py
import numpy as np
import pytest

from oct_image_segmentation_models_torch.common import EVALUATION_METRICS, h5, plotting
from oct_image_segmentation_models_torch.common.dataset import Dataset
from oct_image_segmentation_models_torch.common.model_io import load_model
from oct_image_segmentation_models_torch.evaluation import (
    EvaluationParameters,
    EvaluationSaveParams,
    evaluate_model,
)
from oct_image_segmentation_models_torch.prediction import (
    PredictionParams,
    PredictionSaveParams,
    predict,
)
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

from synth import make_dataset
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

H, W, C = 64, 96, 3
BLOCKED = ("h5py", "matplotlib")


def _run_key(name: str) -> bool:
    """Attributes and datasets that differ between any two runs."""
    return name.split("/")[-1] == "timestamp" or name.endswith("_time")


@contextmanager
def without(names):
    """``import name`` raises ImportError for each of ``names``, as on a
    machine that lacks them."""
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] in names}
    for k in saved:
        del sys.modules[k]
    for name in names:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name in names:
            del sys.modules[name]
        sys.modules.update(saved)


def _workflows(dataset: Path, out: Path) -> dict:
    """train_model (2 epochs), then predict and evaluate_model on the
    trained checkpoint, serially in this process."""
    folder = train_model(TrainingParams(
        model_architecture="unet", training_dataset_path=dataset, initial_model=None,
        results_location=out / "train", opt_con="adam", opt_params={"learning_rate": 3e-3},
        loss="dice_loss_macro", metric="dice_coef_macro", epochs=2, batch_size=2,
        model_hyperparameters={"start_neurons": 2, "pool_layers": 2}, seed=5, device="cpu",
    ))
    model = folder / "model_final.hdf5"
    with h5.File(dataset, "r") as f:
        images = f["test_images"][:]
    names = [Path(f"scan_{i}.png") for i in range(len(images))]
    (out / "predict").mkdir(parents=True)
    predicted = predict(PredictionParams(
        model_path=model, mlflow_tracking_uri=None, mlflow_run_uuid=None,
        dataset=Dataset(images, None, names,
                        [out / "predict" / f"image_{i}" for i in range(len(images))]),
        config_output_dir=out / "predict",
        save_params=PredictionSaveParams(categorical_pred=True, png_images=False),
        graph_search=True, batch_size=2, num_workers=0, device="cpu",
    ))
    evaluated = evaluate_model(EvaluationParameters(
        model_path=model, mlflow_tracking_uri=None, mlflow_run_uuid=None,
        test_dataset_path=dataset, save_foldername=out / "evaluate",
        save_params=EvaluationSaveParams(categorical_pred=True, png_images=False),
        metrics=sorted(EVALUATION_METRICS), graph_search=True, batch_size=2, num_workers=0, device="cpu",
    ))
    return {"folder": folder, "predicted": predicted, "evaluated": evaluated, "root": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5_workflows")
    dataset = make_dataset(root / "ds.hdf5", n_train=6, n_val=2, n_test=2, h=H, w=W,
                           num_classes=C, seed=21)
    # Both runs sum on the module's one thread count, in one order: their
    # files are bit-equal.
    with without(BLOCKED):
        with pytest.raises(ImportError):
            import h5py  # noqa: F401
        assert not plotting.available()
        bare = _workflows(dataset, root / "bare")
    full = _workflows(dataset, root / "full")
    return bare, full


def _files(run: dict) -> list:
    """The run's files, relative to its root, the training folder's
    timestamped name written as <train>."""
    root, folder = run["root"], run["folder"].name
    return sorted(
        str(p.relative_to(root)).replace(folder, "<train>") for p in root.rglob("*")
    )


def _path(run: dict, rel: str) -> Path:
    return run["root"] / rel.replace("<train>", run["folder"].name)


def _h5_items(run: dict, rel: str) -> dict:
    """Members, values and attributes of a file, the run's paths in
    string attributes written as <train> and <root>."""
    def local(value):
        if isinstance(value, bytes):
            return type(value)(
                value.replace(str(run["folder"]).encode(), b"<train>")
                .replace(str(run["root"]).encode(), b"<root>")
            )
        return value

    out = {}
    with h5py.File(_path(run, rel), "r") as f:
        def visit(name, obj):
            attrs = {k: local(obj.attrs[k]) for k in obj.attrs if not _run_key(k)}
            if isinstance(obj, h5py.Dataset):
                value = None if _run_key(name) else obj[()]
                out[name] = ("dataset", obj.shape, obj.dtype.str, attrs, value)
            else:
                out[name] = ("group", attrs)
        visit("/", f)
        f.visititems(visit)
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and (
            a.tobytes() == b.tobytes() if a.dtype.kind != "O" else a.tolist() == b.tolist()
        )
    return type(a) is type(b) and (a == b or (a != a and b != b))


def test_tree_is_the_full_tree_less_the_pngs(runs):
    bare, full = runs
    full_files = _files(full)
    assert any(f.endswith(".png") for f in full_files)
    assert _files(bare) == [f for f in full_files if not f.endswith(".png")]


def test_every_hdf5_file_reads_back_through_h5py_as_the_full_run_wrote_it(runs):
    bare, full = runs
    paths = [p for p in _files(bare) if p.endswith(".hdf5")]
    assert {
        f"train/<train>/{name}"
        for name in ("training_params.hdf5", "stats_epoch02.hdf5", "model_final.hdf5")
    } <= set(paths)
    assert len(paths) >= 10
    for rel in paths:
        assert _equal(_h5_items(bare, rel), _h5_items(full, rel)), rel


def test_training_files_hold_the_run(runs):
    bare, _ = runs
    folder = bare["folder"]
    with h5py.File(folder / "stats_epoch02.hdf5", "r") as f:
        for key in ("train_acc", "val_acc", "train_loss", "val_loss", "epoch_time"):
            assert f[key].shape == (2,) and np.isfinite(f[key][()]).all(), key
    with h5py.File(folder / "training_params.hdf5", "r") as f:
        assert f.attrs["bn_precise_stats_applied"] is np.True_
        assert f.attrs["epochs"] == 2 and f.attrs["loss"] == b"dice_loss_macro"
        assert f.attrs["opt_param: name"] == "Adam"
    loaded = load_model(folder / "model_final.hdf5", device="cpu")
    with h5py.File(folder / "model_final.hdf5", "r") as f:
        assert f.attrs["format"] == b"octseg-tpu-v1"
        kernel = f["params/ConvBlock_0/Conv_0/kernel"][()]
    np.testing.assert_array_equal(
        loaded.module.state_dict()["blocks.0.conv.weight"].numpy(), kernel.transpose(3, 2, 0, 1)
    )


def test_prediction_files_hold_the_returned_results(runs):
    bare, _ = runs
    for out in bare["predicted"]:
        with h5py.File(out.image_output_dir / "prediction_info.hdf5", "r") as f:
            np.testing.assert_array_equal(f["predicted_labels"][()], out.predicted_labels)
            np.testing.assert_array_equal(f["categorical_pred"][()], out.categorical_pred)
            np.testing.assert_array_equal(f["boundary_maps"][()], out.boundary_maps)
            np.testing.assert_array_equal(f["raw_image"][()], out.image)
            assert f.attrs["image_name"] == str(out.image_name).encode()
        with h5py.File(out.image_output_dir / "graph_search_prediction_info.hdf5", "r") as f:
            np.testing.assert_array_equal(f["gs_pred_segs"][()], out.gs_pred_segs)


def test_evaluation_files_hold_the_returned_results(runs):
    bare, _ = runs
    evaluated = bare["evaluated"]
    for out in evaluated:
        with h5py.File(out.image_output_dir / "evaluation_results.hdf5", "r") as f:
            np.testing.assert_array_equal(f["predicted_segmentation_map"][()], out.predicted_labels)
            np.testing.assert_array_equal(f["raw_image"][()], out.image)
        with h5py.File(out.image_output_dir / "gs_evaluation_results.hdf5", "r") as f:
            np.testing.assert_array_equal(f["gs_pred_segs"][()], out.gs_pred_segs)
            np.testing.assert_array_equal(f["errors"][()], out.errors)
    with h5py.File(bare["root"] / "evaluate" / "overall_evaluation_results.hdf5", "r") as f:
        dice = f["dice_coef_classes"][()]
        assert dice.shape[0] == len(evaluated) and np.isfinite(dice).all()
        assert ((dice >= 0) & (dice <= 1)).all()
        assert f["image_names"][()].tolist() == [b"synthetic_0.png", b"synthetic_1.png"]
