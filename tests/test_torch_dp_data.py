"""The port's sharded input and rank-sharded serving against the JAX
package's, on the CPU.

- ``ShardedHDF5Reader``: every node's strided, trimmed shard equal to
  JAX's reader's for the same process index and count.
- ``device_prefetch`` and ``prefetch_to_mesh``: the batches in order, each
  local rank's rows equal to the shard JAX's ``prefetch_to_mesh`` puts on
  that device of a 2-device mesh; an error of the source reaches the
  consumer; a consumer that stops early releases the producer.
- Two ranks (gloo, as ``tests/test_torch_dp_step.py`` spawns them) serve
  the goldens' U-Net (bridged from JAX): ``VolumeSegmenter(mesh=)``
  reproduces ``tests/goldens/streaming_golden.json`` (10 B-scans, batch 4,
  the s2d path) and, on volumes of 7 and 1 B-scans (a padded tail; a
  rank with nothing of its own), the first 7 and 1 of those B-scans' labels
  and rows bit for bit (each B-scan is segmented alone, in per-rank
  batches of 2 either way); ``make_fused_pipeline(mesh=)`` with the
  BN-folded forward gives every rank the one-rank pipeline's labels, maps
  and rows bit for bit (exact ties).
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.parallel import input_pipeline as jax_input
from oct_image_segmentation_models_tpu.parallel.mesh import create_mesh as jax_mesh
from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
from oct_image_segmentation_models_torch.parallel import input_pipeline as port_input
from oct_image_segmentation_models_torch.parallel.mesh import Mesh

from synth import make_dataset
from test_torch_dp_step import run_ranks
from test_torch_pipeline import C, H, W, _golden, _images, _port_model


def _mesh(nodes, local, rank):
    """Rank ``rank`` of a mesh of ``nodes`` x ``local`` ranks, for the
    functions that read only its coordinates (no process group)."""
    return Mesh(nodes, local, rank, torch.device("cpu"))


@pytest.mark.parametrize("count", [1, 2, 3])
def test_sharded_reader_matches_jax(tmp_path, count):
    ds = make_dataset(tmp_path / "ds.hdf5", n_train=7, n_val=2, n_test=1, h=16, w=16)
    for index in range(count):
        got = port_input.ShardedHDF5Reader(ds, "train", index, count).load()
        want = jax_input.ShardedHDF5Reader(ds, "train", index, count).load()
        by_mesh = port_input.ShardedHDF5Reader(ds, mesh=_mesh(count, 2, 2 * index + 1)).load()
        for g, m, w in zip(got, by_mesh, want):
            assert g.shape[0] == (7 // count if count > 1 else 7)
            assert np.array_equal(g, w) and np.array_equal(m, w)


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((4, 8, 8, 1), dtype=np.float32), rng.integers(0, 3, (4, 8, 8, 1)).astype(np.int32))
        for _ in range(n)
    ]


@pytest.mark.parametrize("size", [1, 2, 5])
def test_device_prefetch_keeps_order(size):
    batches = _host_batches(4)
    got = list(port_input.device_prefetch(iter(batches), size=size, device="cpu"))
    assert len(got) == 4
    for (gx, gy), (x, y) in zip(got, batches):
        assert isinstance(gx, torch.Tensor) and np.array_equal(gx.numpy(), x)
        assert np.array_equal(gy.numpy(), y)
    single = list(port_input.device_prefetch((b[0] for b in batches), device="cpu"))
    assert all(np.array_equal(g.numpy(), b[0]) for g, b in zip(single, batches))
    assert list(port_input.device_prefetch([], device="cpu")) == []


def test_prefetch_to_mesh_rows_match_jax_device_shards():
    batches = _host_batches(3)
    mesh = jax_mesh(jax.devices()[:2])
    want = list(jax_input.prefetch_to_mesh(iter(batches), mesh))
    for local in range(2):
        got = list(port_input.prefetch_to_mesh(iter(batches), _mesh(1, 2, local)))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for g_arr, w_arr in zip(g, w):
                shard = [s for s in w_arr.addressable_shards if s.device == mesh.devices.flat[local]][0]
                assert np.array_equal(g_arr.numpy(), np.asarray(shard.data))


def test_prefetch_to_mesh_errors_and_early_stop():
    def failing():
        yield from _host_batches(2)
        raise RuntimeError("source broke")

    got = port_input.prefetch_to_mesh(failing(), _mesh(1, 2, 0))
    assert len([next(got), next(got)]) == 2
    with pytest.raises(RuntimeError, match="source broke"):
        next(got)
    with pytest.raises(ValueError, match="does not split evenly"):
        list(port_input.prefetch_to_mesh(iter(_host_batches(1)), _mesh(1, 3, 0)))

    produced = []

    def endless():
        while True:
            produced.append(1)
            yield _host_batches(1)[0]

    before = threading.active_count()
    it = port_input.prefetch_to_mesh(endless(), _mesh(1, 1, 0), size=2)
    next(it)
    it.close()  # the consumer stops early
    for _ in range(100):
        if threading.active_count() == before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() == before, "the producer thread outlived its consumer"
    assert len(produced) <= 4


SERVE_BODY = """
from oct_image_segmentation_models_torch.common.model_io import LoadedModel
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

data = np.load(f"{workdir}/inputs.npz")
config = json.loads(str(data["config"]))
container = get_model_class("unet")(**config)
module = container.build_model(device="cpu")
module.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")})
seg = VolumeSegmenter(LoadedModel("unet", module, config), config, batch_size=4, mesh=mesh)
assert seg.kind == "s2d" and seg.device == torch.device("cpu")
out = {}
for n in (10, 7, 1):
    out[f"labels{n}"], out[f"rows{n}"] = seg.segment_volume(data["volume"][:n])
pipe = make_fused_pipeline(
    fold_batchnorm(module), container.get_preprocess_input_fn(), mesh=mesh
)
out["fused_labels"], out["fused_maps"], out["fused_rows"] = (
    t.numpy() for t in pipe(torch.from_numpy(data["volume"][:4]))
)
np.savez(f"{workdir}/rank{rank}.npz", **out)
"""


def test_rank_sharded_serving(tmp_path):
    golden = _golden("streaming_golden.json")
    container, module = _port_model()
    config = container.get_config()
    volume = _images(10, 3)
    np.savez(
        tmp_path / "inputs.npz", config=json.dumps(config), volume=volume,
        **{"sd/" + k: v.numpy() for k, v in module.state_dict().items()},
    )
    run_ranks(tmp_path, SERVE_BODY, world=2, local=2)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for k in ranks[0].files:
        assert np.array_equal(ranks[0][k], ranks[1][k]), f"ranks differ in {k}"
    got = ranks[0]

    assert got["labels10"].shape == (10, H, W) and got["labels10"].dtype == np.uint8
    assert got["rows10"].shape == (10, C - 1, W) and got["rows10"].dtype == np.uint16
    assert int(got["labels10"].astype(np.int64).sum()) == golden["labels_sum"]
    assert got["rows10"].tolist() == golden["rows"]
    for n in (7, 1):
        assert np.array_equal(got[f"labels{n}"], got["labels10"][:n])
        assert np.array_equal(got[f"rows{n}"], got["rows10"][:n])
    pipe = make_fused_pipeline(
        fold_batchnorm(module), container.get_preprocess_input_fn(), device="cpu"
    )
    want = pipe(torch.from_numpy(volume[:4]))
    for name, w in zip(("labels", "maps", "rows"), want):
        assert np.array_equal(got[f"fused_{name}"], w.numpy()), name
