"""The port's predict and evaluate workflows against the JAX package's,
on one checkpoint and one HDF5 dataset.

JAX's ``save_model`` writes the goldens' U-Net (start_neurons 4,
pool_layers 3, 4 classes, ``PRNGKey(1234)``) to a native checkpoint;
both packages load that file. The data is ``synth.make_dataset`` at
64x96 with 4 classes, plus a 32x48 image for the mixed-shape cases. The
two artifact trees must have the same file names; every HDF5 dataset of
integers bit-equal and every float dataset within 1e-9 (NaN in the same
places); the same attributes, except ``timestamp`` and the ``*_time``
attributes; CSV and text files byte-equal; the same PNG names.
"""

import functools
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common.dataset import Dataset as JaxDataset
from oct_image_segmentation_models_tpu.common.model_io import save_model
from oct_image_segmentation_models_tpu.evaluation import (
    EvaluationParameters as JaxEvaluationParameters,
    EvaluationSaveParams as JaxEvaluationSaveParams,
    evaluate_model as jax_evaluate_model,
)
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.prediction import (
    PredictionParams as JaxPredictionParams,
    PredictionSaveParams as JaxPredictionSaveParams,
    predict as jax_predict,
)
from oct_image_segmentation_models_torch.common.dataset import Dataset
from oct_image_segmentation_models_torch.common.model_io import (
    load_model,
    load_model_and_config,
)
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
from oct_image_segmentation_models_torch.prediction.prediction import run_pipeline

from synth import make_dataset, make_layered_sample

H, W, C = 64, 96, 4
FLOAT_ATOL = 1e-9
ALL_METRICS = [
    "dice_coef_classes",
    "dice_coef_macro",
    "dice_coef_micro",
    "average_surface_distance",
    "hausdorff_distance",
]

JAX = {
    "Dataset": JaxDataset,
    "PredictionParams": JaxPredictionParams,
    "PredictionSaveParams": JaxPredictionSaveParams,
    "predict": jax_predict,
    "EvaluationParameters": JaxEvaluationParameters,
    "EvaluationSaveParams": JaxEvaluationSaveParams,
    "evaluate_model": jax_evaluate_model,
}
PORT = {
    "Dataset": Dataset,
    "PredictionParams": functools.partial(PredictionParams, device="cpu"),
    "PredictionSaveParams": PredictionSaveParams,
    "predict": predict,
    "EvaluationParameters": functools.partial(EvaluationParameters, device="cpu"),
    "EvaluationSaveParams": EvaluationSaveParams,
    "evaluate_model": evaluate_model,
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(checkpoint, dataset, mixed-shape images) shared by the module."""
    root = tmp_path_factory.mktemp("torch_workflows")
    container = jax_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=3,
    )
    module = container.build_model()
    variables = jax.jit(
        lambda key: module.init(key, np.zeros((1, H, W, 1), np.float32), training=False)
    )(jax.random.PRNGKey(1234))
    model_path = root / "model.hdf5"
    save_model(
        model_path, "unet", container.get_config(),
        jax.tree_util.tree_map(np.asarray, dict(variables)),
    )
    ds = make_dataset(
        root / "ds.hdf5", n_train=1, n_val=1, n_test=3, h=H, w=W, num_classes=C, seed=4
    )
    with h5py.File(ds, "r") as f:
        test_images = f["test_images"][:]
    small = make_layered_sample(np.random.default_rng(9), 32, 48, C)[0][..., None]
    mixed = [test_images[0], small, test_images[1], test_images[2]]
    return model_path, ds, mixed


def _predict(pkg, model_path, images, out, tie, graph_search, png, workers=0,
             batch_size=2):
    out.mkdir(parents=True, exist_ok=True)
    dirs = [out / f"img_{i}" for i in range(len(images))]
    return pkg["predict"](
        pkg["PredictionParams"](
            model_path=model_path,
            mlflow_tracking_uri=None,
            mlflow_run_uuid=None,
            dataset=pkg["Dataset"](
                images, None, [Path(f"scan_{i}.png") for i in range(len(images))], dirs
            ),
            config_output_dir=out,
            save_params=pkg["PredictionSaveParams"](
                categorical_pred=True, png_images=png
            ),
            graph_search=graph_search,
            batch_size=batch_size,
            minpath_tie_parity=tie,
            num_workers=workers,
        )
    )


def _evaluate(pkg, model_path, ds, out, tie, graph_search, metrics, png, workers=0):
    return pkg["evaluate_model"](
        pkg["EvaluationParameters"](
            model_path=model_path,
            mlflow_tracking_uri=None,
            mlflow_run_uuid=None,
            test_dataset_path=ds,
            save_foldername=out,
            save_params=pkg["EvaluationSaveParams"](
                categorical_pred=True, png_images=png
            ),
            graph_search=graph_search,
            metrics=metrics,
            batch_size=2,
            num_workers=workers,
            minpath_tie_parity=tie,
        )
    )


def _skip_attr(name: str) -> bool:
    return name == "timestamp" or name.endswith("_time")


def _assert_values_equal(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, where
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=where)
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL, err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


def _assert_hdf5_equal(got_path, want_path):
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        def items(f):
            out = {}
            f.visititems(lambda k, o: out.__setitem__(k, o))
            return out

        g_items, w_items = items(g), items(w)
        assert sorted(g_items) == sorted(w_items), got_path
        for obj_g, obj_w, where in [(g, w, "/")] + [
            (g_items[k], w_items[k], k) for k in w_items
        ]:
            names = sorted(a for a in obj_w.attrs if not _skip_attr(a))
            assert sorted(a for a in obj_g.attrs if not _skip_attr(a)) == names, where
            for a in names:
                _assert_values_equal(obj_g.attrs[a], obj_w.attrs[a], f"{got_path}:{where}@{a}")
            if isinstance(obj_w, h5py.Dataset):
                _assert_values_equal(obj_g[()], obj_w[()], f"{got_path}:{where}")


def _assert_trees_equal(got_root: Path, want_root: Path):
    def files(root):
        return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())

    names = files(want_root)
    assert files(got_root) == names
    assert names
    for rel in names:
        got, want = got_root / rel, want_root / rel
        if rel.suffix == ".hdf5":
            _assert_hdf5_equal(got, want)
        elif rel.suffix in (".csv", ".txt"):
            assert got.read_bytes() == want.read_bytes(), rel
        else:
            assert rel.suffix == ".png", rel


@pytest.mark.parametrize(
    "tie,graph_search,png",
    [("exact", True, True), ("fast", True, False), ("fast", False, False)],
)
def test_predict_matches_jax_on_mixed_shapes(inputs, tmp_path, tie, graph_search, png):
    model_path, _, mixed = inputs
    want = _predict(JAX, model_path, mixed, tmp_path / "jax", tie, graph_search, png)
    got = _predict(PORT, model_path, mixed, tmp_path / "torch", tie, graph_search, png)
    assert len(got) == len(want) == len(mixed)
    for g, w in zip(got, want):
        for key in ("predicted_labels", "categorical_pred", "boundary_maps", "gs_pred_segs"):
            a, b = getattr(g, key), getattr(w, key)
            if b is None:
                assert a is None
                continue
            assert a.dtype == np.asarray(b).dtype, key
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
    assert got[1].predicted_labels.shape == (32, 48)
    _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    if png:
        assert (tmp_path / "torch" / "img_0" / "categorical_pred_3.png").exists()


@pytest.mark.parametrize(
    "tie,graph_search,metrics,png",
    [
        ("exact", True, ALL_METRICS, True),
        ("fast", True, ALL_METRICS, False),
        ("fast", False, ["dice_coef_macro"], False),
    ],
)
def test_evaluate_matches_jax(inputs, tmp_path, tie, graph_search, metrics, png):
    model_path, ds, _ = inputs
    want = _evaluate(JAX, model_path, ds, tmp_path / "jax", tie, graph_search, metrics, png)
    got = _evaluate(PORT, model_path, ds, tmp_path / "torch", tie, graph_search, metrics, png)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("gs_pred_segs", "errors", "mean_abs_err", "mean_err"):
            a, b = getattr(g, key), getattr(w, key)
            if b is None:
                assert a is None
                continue
            _assert_values_equal(a, np.asarray(b), key)
    _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")


def test_evaluate_workers_match_serial(inputs, tmp_path):
    """Two spawn workers write what the serial loop writes, bit for bit."""
    model_path, ds, _ = inputs
    _evaluate(PORT, model_path, ds, tmp_path / "serial", "exact", True, ALL_METRICS, False)
    _evaluate(PORT, model_path, ds, tmp_path / "pool", "exact", True, ALL_METRICS, False,
              workers=2)
    serial = sorted((tmp_path / "serial").rglob("*.hdf5"))
    assert len(serial) == 8
    for path in serial:
        rel = path.relative_to(tmp_path / "serial")
        with h5py.File(path, "r") as a, h5py.File(tmp_path / "pool" / rel, "r") as b:
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key][()], b[key][()], err_msg=str(rel))
    for path in (tmp_path / "serial").rglob("*.csv"):
        rel = path.relative_to(tmp_path / "serial")
        assert path.read_bytes() == (tmp_path / "pool" / rel).read_bytes()


def test_empty_dataset_as_jax(inputs, tmp_path):
    model_path, ds, _ = inputs
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        out = tmp_path / name
        out.mkdir()
        params = pkg["PredictionParams"](
            model_path=model_path,
            mlflow_tracking_uri=None,
            mlflow_run_uuid=None,
            dataset=pkg["Dataset"](np.zeros((0, H, W, 1), np.uint8), None, [], []),
            config_output_dir=out,
            save_params=pkg["PredictionSaveParams"](),
            col_error_range=range(W),
        )
        assert pkg["predict"](params) == []
    _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")

    empty = tmp_path / "empty.hdf5"
    with h5py.File(ds, "r") as src, h5py.File(empty, "w") as dst:
        for key in ("test_images", "test_labels", "test_images_source"):
            dst.create_dataset(key, data=src[key][:0])
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="contains no\\s+test images"):
            _evaluate(pkg, model_path, empty, tmp_path / "ev_empty", "fast", False,
                      ["dice_coef_macro"], False)


@pytest.mark.parametrize(
    "bad,match",
    [
        ({"batch_size": 0}, "batch_size"),
        ({"batch_size": -1}, "batch_size"),
        ({"minpath_tie_parity": "bogus"}, "minpath_tie_parity"),
        ({"compute_dtype": "float16"}, "compute_dtype"),
        ({"num_workers": "many"}, "num_workers"),
        ({"metrics": ["nope"]}, "metrics are invalid"),
    ],
)
def test_parameters_reject_as_jax(inputs, tmp_path, bad, match):
    model_path, ds, _ = inputs
    for pkg in (JAX, PORT):
        eval_kwargs = dict(
            model_path=model_path,
            mlflow_tracking_uri=None,
            mlflow_run_uuid=None,
            test_dataset_path=ds,
            save_foldername=tmp_path,
            save_params=pkg["EvaluationSaveParams"](),
            graph_search=False,
            metrics=["dice_coef_macro"],
        )
        with pytest.raises(ValueError, match=match):
            pkg["EvaluationParameters"](**{**eval_kwargs, **bad})
        if "metrics" in bad:
            continue
        pred_kwargs = dict(
            model_path=model_path,
            mlflow_tracking_uri=None,
            mlflow_run_uuid=None,
            dataset=pkg["Dataset"](
                np.zeros((1, H, W, 1), np.uint8), None, [tmp_path / "x"], [tmp_path]
            ),
            config_output_dir=tmp_path,
            save_params=pkg["PredictionSaveParams"](),
        )
        with pytest.raises(ValueError, match=match):
            pkg["PredictionParams"](**{**pred_kwargs, **bad})


def test_model_loading_surface(inputs, tmp_path):
    """Native checkpoints load, a sidecar config wins, and what is not
    ported yet raises and says so."""
    model_path, _, _ = inputs
    loaded, config = load_model_and_config(model_path, device="cpu")
    plain = load_model(model_path, device="cpu")
    assert loaded.name == "unet" and loaded.output_classes == C
    for a, b in zip(loaded.module.state_dict().values(), plain.module.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mlflow_tracking_uri"):
        load_model_and_config(model_path, mlflow_run_uuid="abc", device="cpu")
    for kwargs, path in (
        ({"mlflow_tracking_uri": "file:///nowhere"}, model_path),
        ({}, tmp_path),
    ):
        with pytest.raises(NotImplementedError, match="A12"):
            load_model_and_config(path, device="cpu", **kwargs)
    keras = tmp_path / "keras.h5"
    with h5py.File(keras, "w") as f:
        f.attrs["keras_version"] = "2.4.0"
    with pytest.raises(NotImplementedError, match="A12"):
        load_model_and_config(keras, device="cpu")


def test_run_pipeline_needs_cuda_unless_cpu_is_asked(inputs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; device=None resolves to it")
    model_path, _, mixed = inputs
    loaded, config = load_model_and_config(model_path, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline(loaded, config, np.stack(mixed[2:]), 2, True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model_and_config(model_path)


def test_dataset_loader_and_plots_as_jax(tmp_path):
    """The loaders read both label schemas as JAX does (dense labels made
    from boundary rows when only ``*_segs`` is there), and the plots
    that no workflow of the port calls yet still render."""
    from oct_image_segmentation_models_tpu.common import dataset_loader as jax_dl
    from oct_image_segmentation_models_torch.common import dataset_loader as dl
    from oct_image_segmentation_models_torch.common import plotting

    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3, 16, 20), dtype=np.uint8)
    segs = np.sort(rng.integers(1, 16, (3, 2, 20)), axis=1).astype(np.float64)
    segs[0, 0, 3] = np.nan
    segs[1, 1, 5] = 0
    path = tmp_path / "segs.hdf5"
    with h5py.File(path, "w") as f:
        f["test_images"] = images
        f["test_segs"] = segs
        f["train_images"] = images[:2]
        f["train_labels"] = rng.integers(0, 3, (2, 16, 20), dtype=np.uint8)
        f["val_images"] = images[:1]  # and neither labels nor segs
    with h5py.File(path, "r") as f:
        for load in ("load_testing_data", "load_training_data", "load_prediction_images"):
            got, want = getattr(dl, load)(f), getattr(jax_dl, load)(f)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w
        for loader in (dl, jax_dl):
            with pytest.raises(KeyError, match="val_labels"):
                loader.load_validation_data(f)

    curves = tmp_path / "curves.png"
    plotting.save_cur_trainval_plot(
        "dice", "loss", "unet", 4, 3, [np.nan, 0.5, 0.6, 0.7], [np.nan] * 4,
        [1.0, 0.8, 0.7, 0.6], [np.nan, 0.9, 0.8, 0.75], curves,
    )
    crop = tmp_path / "crop.png"
    plotting.save_image_plot_crop(images[0], crop, "gray", ((2, 10), (4, 16)))
    assert curves.stat().st_size > 0 and crop.stat().st_size > 0
