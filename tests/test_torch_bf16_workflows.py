"""The port's predict (through the CLI) and evaluate workflows with
``compute_dtype="bfloat16"`` against the JAX package's, on one checkpoint
and one HDF5 dataset.

The checkpoint and data are ``test_torch_predict_evaluate.py``'s (the
goldens' U-Net written by JAX's ``save_model``, ``synth.make_dataset`` at
64x96, 4 classes). Both serve through the bfloat16 s2d forward, whose
probabilities agree with JAX's to about 6e-8 on this model
(``test_torch_bf16.py``), so the argmax labels, maps and rows come out
equal, and the two artifact trees are held as in
``test_torch_predict_evaluate.py``: the same file names, integer datasets
bit-equal, float datasets within 1e-9, CSV and text files byte-equal.
"""

import pytest
import torch

from oct_image_segmentation_models_tpu import cli as jax_cli
from oct_image_segmentation_models_torch import cli
from oct_image_segmentation_models_torch.ops import inference

from test_torch_predict_evaluate import (
    ALL_METRICS,
    JAX,
    PORT,
    _assert_trees_equal,
    _evaluate,
    inputs,  # noqa: F401 (the module's fixture)
)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def forwards(monkeypatch):
    """The compute dtypes of the forwards the port's pipelines select."""
    seen = []
    select = inference.select_optimized_forward

    def spy(*args, **kwargs):
        forward, kind = select(*args, **kwargs)
        seen.append((kind, forward.compute_dtype))
        return forward, kind

    monkeypatch.setattr(inference, "select_optimized_forward", spy)
    return seen


def test_cli_predict_in_bf16_matches_jax(inputs, tmp_path, forwards):  # noqa: F811
    model_path, ds, _ = inputs
    flags = ["--batch-size", "2", "--num-workers", "0", "--graph-search",
             "--compute-dtype", "bfloat16"]
    jax_cli.main(["predict", str(model_path), str(ds), str(tmp_path / "jax"), *flags])
    cli.main(["predict", str(model_path), str(ds), str(tmp_path / "torch"), *flags,
              "--device", "cpu"])
    assert forwards and set(forwards) == {("s2d", torch.bfloat16)}
    _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")


def test_evaluate_in_bf16_matches_jax(inputs, tmp_path, monkeypatch, forwards):  # noqa: F811
    model_path, ds, _ = inputs
    for pkg in (JAX, PORT):
        make = pkg["EvaluationParameters"]
        monkeypatch.setitem(
            pkg, "EvaluationParameters", lambda *a, _make=make, **k: _make(
                *a, compute_dtype="bfloat16", **k
            )
        )
    want = _evaluate(JAX, model_path, ds, tmp_path / "jax", "fast", True, ALL_METRICS, False)
    got = _evaluate(PORT, model_path, ds, tmp_path / "torch", "fast", True, ALL_METRICS, False)
    assert len(got) == len(want) == 3
    assert forwards and set(forwards) == {("s2d", torch.bfloat16)}
    _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
