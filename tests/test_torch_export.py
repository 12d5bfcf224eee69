"""The port's deployment artifact (``common/export.py``) against the JAX
package's exported StableHLO artifact and against the port's eager
``make_fused_pipeline``, from one native checkpoint.

The port writes each model's seeded weights as a native HDF5 checkpoint,
which both packages load (the U-Net at 32x48, start_neurons 4,
pool_layers 2; the DeepLabV3+ at 32x32; 4 classes). For every case the
port's CPU artifact, JAX's ``export_inference_pipeline(platforms=("cpu",))``
and the port's eager pipeline with the same forward serve the same uint8
batches: labels, maps and rows must be equal bit for bit (a symbolic batch
at two sizes). The rest mirrors JAX's ``tests/test_export.py``: the
geometry guards, input validation, the format and version checks and the
CLI, plus the port's own: ``--platforms cuda`` without a card raises, the
graph of a program holds the min-path operator, and a directory
checkpoint exports and its artifact loads with h5py blocked.
"""

import json
import sys
import zipfile

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common.export import (
    export_inference_pipeline as jax_export,
)
from oct_image_segmentation_models_tpu.common.export import (
    load_exported_pipeline as jax_load_exported,
)
from oct_image_segmentation_models_torch.common.export import (
    EXPORT_FORMAT_VERSION,
    export_inference_pipeline,
    load_exported_pipeline,
)
from oct_image_segmentation_models_torch.common.model_io import (
    load_model_and_config,
    save_model,
    save_model_dir,
)
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops.inference import (
    make_fused_pipeline,
    select_optimized_forward,
)

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

C = 4
GEOMETRY = {"unet": (32, 48, 1), "deeplabv3plus": (32, 32, 3)}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{model name: native checkpoint}, and the U-Net's directory
    checkpoint under ``"unet_dir"``."""
    root = tmp_path_factory.mktemp("torch_export")
    out = {}
    for name, (h, w, ch) in GEOMETRY.items():
        extra = {"start_neurons": 4, "pool_layers": 2} if name == "unet" else {}
        container = get_model_class(name)(
            input_channels=ch, num_classes=C, image_height=h, image_width=w, **extra
        )
        module = container.build_model(
            generator=torch.Generator().manual_seed(11), device="cpu"
        )
        out[name] = root / f"{name}.hdf5"
        save_model(out[name], name, container.get_config(), module.state_dict())
        if name == "unet":
            out["unet_dir"] = root / "unet.orbax"
            save_model_dir(out["unet_dir"], name, container.get_config(), module.state_dict())
    return out


def _images(name, batch, seed):
    h, w, ch = GEOMETRY[name]
    return np.random.default_rng(seed).integers(0, 256, (batch, h, w, ch), dtype=np.uint8)


def _eager(path, optimize, tie, return_maps=True, with_graph_search=True):
    loaded, config = load_model_and_config(path, device="cpu")
    forward, kind = select_optimized_forward(loaded.module, optimize=optimize)
    container = get_model_class(loaded.name)(**config)
    return make_fused_pipeline(
        None if kind == "s2d" else forward,
        container.get_preprocess_input_fn(),
        labels_apply_fn=forward if kind == "s2d" else None,
        num_classes=C,
        minpath_tie_parity=tie,
        return_maps=return_maps,
        with_graph_search=with_graph_search,
        device="cpu",
    )


def _port(path, out, **kwargs):
    return load_exported_pipeline(
        export_inference_pipeline(path, out, platforms=("cpu",), device="cpu", **kwargs),
        device="cpu",
    )


def _as_numpy(outputs):
    return [None if o is None else np.asarray(o) for o in outputs]


def _assert_equal(got, want, what):
    for name, a, b in zip(("labels", "maps", "rows"), _as_numpy(got), _as_numpy(want)):
        if b is None:
            assert a is None, (what, name)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


@pytest.mark.parametrize(
    "name,optimize,tie,batch,extra,kind",
    [
        ("unet", True, "fast", 2, {}, "s2d"),
        ("unet", True, "exact", None, {}, "s2d"),
        ("unet", True, "exact", 2, {}, "s2d"),
        ("unet", True, "fast", None, {}, "s2d"),
        ("unet", False, "fast", 2, {}, "parity"),
        ("unet", False, "exact", None, {}, "parity"),
        ("deeplabv3plus", True, "fast", 2, {}, "folded"),
        ("deeplabv3plus", True, "exact", None, {}, "folded"),
        ("unet", True, "fast", 2, {"return_maps": False}, "s2d"),
        ("unet", False, "fast", None, {"with_graph_search": False}, "parity"),
    ],
)
def test_artifact_matches_jax_artifact_and_eager(
    checkpoints, tmp_path, name, optimize, tie, batch, extra, kind
):
    path = checkpoints[name]
    kwargs = dict(
        batch_size=batch, optimize=optimize, minpath_tie_parity=tie, **extra
    )
    port = _port(path, tmp_path / "port.pt2", **kwargs)
    jax_art = jax_load_exported(
        jax_export(path, tmp_path / "jax.hdf5", platforms=("cpu",), **kwargs)
    )
    eager = _eager(path, optimize, tie, **extra)
    assert port.metadata["optimized_forward"] == jax_art.metadata["optimized_forward"] == kind
    h, w, ch = GEOMETRY[name]
    assert port.input_shape == jax_art.input_shape == (batch, h, w, ch)
    jax_meta = dict(jax_art.metadata, platforms=["cpu"])
    assert {k: v for k, v in port.metadata.items() if k != "torch_version"} == {
        k: v for k, v in jax_meta.items() if k != "jax_version"
    }
    for size in (batch,) if batch else (1, 3):
        images = _images(name, size, seed=size)
        got = port(images)
        assert all(o is None or o.device.type == "cpu" for o in got)
        _assert_equal(got, jax_art(images), f"{name} vs JAX, batch {size}")
        _assert_equal(got, eager(torch.from_numpy(images)), f"{name} vs eager, batch {size}")


def test_programs_hold_the_min_path_operator(checkpoints, tmp_path):
    """The CPU program calls the registered operator, not the plain DP's
    ops: B2's on the s2d forward, B1's on the others."""
    for optimize, op in ((True, "minpath_delineate_s2d"), (False, "minpath_delineate")):
        out = export_inference_pipeline(
            checkpoints["unet"], tmp_path / f"{op}.pt2", platforms=("cpu",),
            device="cpu", optimize=optimize,
        )
        with zipfile.ZipFile(out) as zf:
            assert sorted(zf.namelist()) == ["metadata.json", "program_cpu.pt2"]
        program = load_exported_pipeline(out, device="cpu")._module
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert f"octseg.{op}.default" in targets
        assert not any("minpath" in t and t != f"octseg.{op}.default" for t in targets)


def test_directory_checkpoint_exports_and_serves_without_h5py(checkpoints, tmp_path, monkeypatch):
    want = _port(checkpoints["unet"], tmp_path / "native.pt2", batch_size=1)
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = _port(checkpoints["unet_dir"], tmp_path / "dir.pt2", batch_size=1)
    images = _images("unet", 1, 4)
    _assert_equal(got(images), want(images), "directory checkpoint")


def test_geometry_guards(checkpoints, tmp_path):
    with pytest.raises(ValueError, match="multiple of 4"):
        export_inference_pipeline(
            checkpoints["deeplabv3plus"], tmp_path / "a.pt2", batch_size=1,
            image_height=34, image_width=32, platforms=("cpu",), device="cpu",
        )
    with pytest.raises(ValueError, match="multiple of"):
        export_inference_pipeline(
            checkpoints["unet"], tmp_path / "b.pt2", image_height=30, image_width=48,
            platforms=("cpu",), device="cpu",
        )


def test_input_validation(checkpoints, tmp_path):
    art = _port(checkpoints["unet"], tmp_path / "a.pt2", batch_size=2)
    with pytest.raises(ValueError, match="lowered for input shape"):
        art(_images("unet", 1, 0))
    with pytest.raises(ValueError, match="lowered for input shape"):
        art(np.zeros((2, 32, 24, 1), np.uint8))
    # compute_dtype is honoured by the optimized forwards only: bfloat16
    # without them raises, as in JAX
    with pytest.raises(ValueError, match="compute_dtype"):
        export_inference_pipeline(
            checkpoints["unet"], tmp_path / "bf16.pt2", optimize=False,
            compute_dtype="bfloat16", platforms=("cpu",), device="cpu",
        )
    dyn = _port(checkpoints["unet"], tmp_path / "dyn.pt2", batch_size=None)
    assert dyn.input_shape == (None, 32, 48, 1)
    with pytest.raises(ValueError, match="lowered for input shape"):
        dyn(np.zeros((0, 32, 48, 1), np.uint8))
    with pytest.raises(ValueError, match="lowered for input shape"):
        dyn(np.zeros((2, 32, 48), np.uint8))


def test_rejects_non_uint8_pixels(checkpoints, tmp_path):
    """The artifact takes raw uint8 pixels: a float input raises, integers
    outside [0, 255] raise, integers inside are taken, and a uint8 batch
    is not copied on its way in."""
    art = _port(checkpoints["unet"], tmp_path / "a.pt2", batch_size=2)
    images = _images("unet", 2, 0)
    with pytest.raises(ValueError, match="raw uint8 images"):
        art(images.astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="raw uint8 images"):
        art(torch.from_numpy(images).bool())
    with pytest.raises(ValueError, match=r"outside \[0, 255\]"):
        art(images.astype(np.int32) - 300)
    labels_a, _, _ = art(images)
    labels_b, _, _ = art(images.astype(np.int64))
    assert torch.equal(labels_a, labels_b)

    seen = []
    module = art._module
    art._module = lambda x: seen.append(x) or module(x)
    art(images)
    assert seen[0].data_ptr() == torch.from_numpy(images).data_ptr()


def test_artifact_format_checks(checkpoints, tmp_path):
    not_zip = tmp_path / "not_artifact.pt2"
    not_zip.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="not an octseg export artifact"):
        load_exported_pipeline(not_zip, device="cpu")
    no_meta = tmp_path / "no_meta.pt2"
    with zipfile.ZipFile(no_meta, "w") as zf:
        zf.writestr("x", b"")
    with pytest.raises(ValueError, match="not an octseg export artifact"):
        load_exported_pipeline(no_meta, device="cpu")

    out = export_inference_pipeline(
        checkpoints["unet"], tmp_path / "a.pt2", batch_size=1, platforms=("cpu",),
        device="cpu",
    )
    with pytest.raises(ValueError, match="no program for 'meta'"):
        load_exported_pipeline(out, device="meta")
    bumped = tmp_path / "bumped.pt2"
    with zipfile.ZipFile(out) as src, zipfile.ZipFile(bumped, "w") as dst:
        for item in src.namelist():
            data = src.read(item)
            if item == "metadata.json":
                meta = json.loads(data)
                meta["format_version"] = EXPORT_FORMAT_VERSION + 1
                data = json.dumps(meta)
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="unsupported export format"):
        load_exported_pipeline(bumped, device="cpu")


def test_cuda_platform_needs_a_card(checkpoints, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for platforms in (("cuda",), ("cpu", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_inference_pipeline(
                checkpoints["unet"], tmp_path / "a.pt2", platforms=platforms, device="cpu"
            )
    with pytest.raises(ValueError, match="platforms"):
        export_inference_pipeline(
            checkpoints["unet"], tmp_path / "a.pt2", platforms=("tpu",), device="cpu"
        )
    assert not (tmp_path / "a.pt2").exists()
    out = export_inference_pipeline(
        checkpoints["unet"], tmp_path / "b.pt2", platforms=("cpu",), device="cpu"
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported_pipeline(out)


def test_cli_export(checkpoints, tmp_path, capsys):
    from oct_image_segmentation_models_torch.cli import main

    out = tmp_path / "cli_export.pt2"
    main([
        "export", str(checkpoints["unet"]), str(out), "--batch-size", "1",
        "--platforms", "cpu", "--minpath-tie-parity", "exact", "--device", "cpu",
    ])
    assert "Exported torch.export" in capsys.readouterr().out
    art = load_exported_pipeline(out, device="cpu")
    assert art.metadata["minpath_tie_parity"] == "exact"
    assert art.metadata["platforms"] == ["cpu"]
    labels, maps, rows = art(_images("unet", 1, 2))
    assert rows.shape == (1, C - 1, 48) and rows.dtype == torch.uint16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["export", str(checkpoints["unet"]), str(tmp_path / "c.pt2"),
                  "--platforms", "cuda", "--device", "cpu"])
