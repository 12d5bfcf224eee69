"""The port's spans (``common/profiling.py``): off without a profiler, on
under one, on the exported trace's clock, with self times, parents and
request ids, and never inside an exported program; and the served host
path they cover, at a tiny size: the staging and fetch rings, the padded
last batch, threads, and ``prefetch_to_mesh``."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_torch.common import profiling
from oct_image_segmentation_models_torch.common.model_io import LoadedModel
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops.inference import FusedPipeline, select_optimized_forward
from oct_image_segmentation_models_torch.parallel import input_pipeline
from oct_image_segmentation_models_torch.parallel.mesh import Mesh
from oct_image_segmentation_models_torch.prediction import streaming

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

H, W, C, BATCH = 16, 32, 4, 4
CHAIN = ("serve.forward", "serve.maps", "serve.minpath")


@pytest.fixture(autouse=True)
def clean_recorder():
    torch.manual_seed(0)
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def unet():
    config = get_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=2,
    ).get_config()
    torch.manual_seed(0)
    module = get_model_class("unet")(**config).build_model(device="cpu")
    return LoadedModel("unet", module, config), config


def _segmenter(unet, **kw):
    loaded, config = unet
    return streaming.VolumeSegmenter(loaded, config, batch_size=BATCH, device="cpu", **kw)


def _volume(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 1), dtype=np.uint8)


def _cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_without_a_profiler(unet, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b", request=True, bscans=3)
    labels, rows = _segmenter(unet).segment_volume(_volume(6))
    assert labels.shape == (6, H, W) and rows.shape == (6, C - 1, W)
    assert profiling.spans() == [] and profiling.span_totals() == {}


def test_served_path_spans_under_a_profiler(unet):
    seg = _segmenter(unet)
    vol = _volume(10)  # two whole batches of 4 and one padded by 2
    labels_off, rows_off = seg.segment_volume(vol)
    with _cpu_profiler():
        labels_on, rows_on = seg.segment_volume(vol)
    np.testing.assert_array_equal(labels_on, labels_off)
    np.testing.assert_array_equal(rows_on, rows_off)

    spans = _by_name(profiling.spans())
    assert set(spans) == {"serve.volume", "serve.pad", "serve.stage", "serve.launch",
                          "serve.drain", "serve.fetch", *CHAIN}
    (volume,) = spans["serve.volume"]
    assert volume.parent is None and volume.request is not None
    assert volume.counts == {"bscans": 10, "padded": 2}
    assert [r.counts for r in spans["serve.pad"]] == [{"bscans": 2}]
    # The ring was allocated by the untraced volume: every slot is reused.
    assert [r.counts for r in spans["serve.stage"]] == [
        {"bytes": BATCH * H * W, "slot_alloc": 0, "slot_wait": 0}
    ] * 3
    assert [r.counts for r in spans["serve.launch"]] == [{"bscans": BATCH}] * 3
    for name in ("serve.pad", "serve.stage", "serve.launch", "serve.drain", "serve.fetch"):
        assert all(r.parent is volume for r in spans[name]), name
    for name in CHAIN:
        assert len(spans[name]) == 3 and all(r.parent.name == "serve.launch" for r in spans[name])
    # One fetch a batch, each of a whole (padded) batch, none waiting: on
    # the CPU every copy back is done when it is queued.
    assert [r.counts for r in spans["serve.fetch"]] == [
        {"bytes": BATCH * H * W + BATCH * (C - 1) * W * 2, "slot_alloc": 0, "slot_wait": 0}
    ] * 3
    assert sum(r.counts["bytes"] for r in spans["serve.fetch"]) == 12 * H * W + 12 * (C - 1) * W * 2
    assert len(spans["serve.drain"]) == 1
    assert {r.request for r in profiling.spans()} == {volume.request}
    assert all(volume.start_ns <= r.start_ns <= r.end_ns <= volume.end_ns for r in profiling.spans())

    totals = profiling.span_totals()
    assert totals["serve.volume"]["counts"] == {"bscans": 10, "padded": 2}
    assert totals["serve.launch"]["count"] == 3
    children = sum(totals[n]["total_ns"] for n in
                   ("serve.pad", "serve.stage", "serve.launch", "serve.drain", "serve.fetch"))
    assert totals["serve.volume"]["self_ns"] == totals["serve.volume"]["total_ns"] - children

    # A second volume opens a new request id.
    with _cpu_profiler():
        seg.segment_volume(_volume(4))
    assert len({r.request for r in profiling.spans()}) == 2


def test_staging_ring_is_allocated_once_across_volumes(unet):
    seg = _segmenter(unet)
    with _cpu_profiler():
        for n in (10, 4, 7):
            seg.segment_volume(_volume(n))
    stages = _by_name(profiling.spans())["serve.stage"]
    per_volume = {}
    for r in stages:
        per_volume.setdefault(r.request, []).append(r.counts["slot_alloc"])
    assert list(per_volume.values()) == [[1, 0, 0], [0], [0, 0]]
    assert profiling.span_totals()["serve.stage"]["counts"] == {
        "bytes": 6 * BATCH * H * W, "slot_alloc": 1, "slot_wait": 0
    }
    # Another batch shape allocates the ring again, once.
    profiling.reset_spans()
    other = streaming.VolumeSegmenter(*unet, batch_size=2, device="cpu")
    with _cpu_profiler():
        other.segment_volume(_volume(5))
        other.segment_volume(_volume(3))
    assert [r.counts["slot_alloc"] for r in profiling.spans() if r.name == "serve.stage"] == [1, 0, 0, 0, 0]


@pytest.mark.parametrize(
    "n, layout",
    [(1, "contiguous"), (BATCH - 1, "contiguous"), (BATCH, "contiguous"),
     (BATCH + 1, "contiguous"), (2 * BATCH, "contiguous"), (10, "contiguous"),
     (BATCH - 1, "strided"), (BATCH + 1, "strided"), (10, "strided"),
     (1, "transposed"), (6, "transposed")],
)
def test_streaming_equals_the_explicitly_padded_volume(unet, n, layout):
    """Whole batches are views of the volume and only the short last one is
    built: for one B-scan, less than a batch, whole batches, a remainder and
    volumes that are not contiguous, with ``prefetch`` 1 and 2 (rings of 2
    and 3 slots), the outputs are the pipeline's a batch at a time on the
    volume padded with its last B-scan, and the caller's volume is left as
    it was. The arrays returned for a volume are the caller's: segmenting
    the next volume leaves them as they were."""
    seg = _segmenter(unet)
    volume = _volume(n, seed=n)
    if layout == "strided":  # every other B-scan of a larger array
        volume = np.repeat(volume, 2, axis=0)[::2]
    elif layout == "transposed":  # each B-scan stored column by column
        volume = np.ascontiguousarray(volume.transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    assert volume.flags.c_contiguous == (layout == "contiguous")
    before = volume.copy()
    padded = np.concatenate([before, before[-1:].repeat(-n % BATCH, 0)])
    outs = [seg._pipeline(torch.from_numpy(padded[i : i + BATCH])) for i in range(0, len(padded), BATCH)]
    want_labels = torch.cat([o[0] for o in outs]).numpy()[:n]
    want_rows = torch.cat([o[2] for o in outs]).numpy()[:n]
    for prefetch in (1, 2):
        labels, rows = seg.segment_volume(volume, prefetch=prefetch)
        assert labels.shape == (n, H, W) and rows.shape == (n, C - 1, W)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(volume, before)
        kept = labels.copy(), rows.copy()
        seg.segment_volume(_volume(BATCH + 1, seed=n + 1), prefetch=prefetch)
        np.testing.assert_array_equal(labels, kept[0])
        np.testing.assert_array_equal(rows, kept[1])
        assert labels.flags.owndata and rows.flags.owndata


def test_fetch_ring_is_allocated_once_across_volumes(unet):
    """The first volume's first fetch allocates the ring; later volumes of
    the batch's shape do not; another batch size, or another depth,
    allocates it again."""
    seg = _segmenter(unet)
    other = streaming.VolumeSegmenter(*unet, batch_size=2, device="cpu")
    with _cpu_profiler():
        seg.segment_volume(_volume(10))
        seg.segment_volume(_volume(4))
        other.segment_volume(_volume(5))
        other.segment_volume(_volume(3), prefetch=1)
    per_volume = {}
    for r in _by_name(profiling.spans())["serve.fetch"]:
        per_volume.setdefault(r.request, []).append(r.counts["slot_alloc"])
    assert list(per_volume.values()) == [[1, 0, 0], [0], [1, 0, 0], [1, 0]]
    assert profiling.span_totals()["serve.fetch"]["counts"] == {
        "bytes": 4 * BATCH * (H * W + (C - 1) * W * 2) + 5 * 2 * (H * W + (C - 1) * W * 2),
        "slot_alloc": 3,
        "slot_wait": 0,
    }


def test_one_segmenter_serves_threads_one_volume_at_a_time(unet):
    seg = _segmenter(unet)
    sizes = (10, 3, 7, 4, 9, 1, 6, 8, 5)
    want = {n: _segmenter(unet).segment_volume(_volume(n, seed=n)) for n in set(sizes)}
    got, errors = {}, []

    def serve(k, n):
        try:
            for _ in range(2):
                got[k] = seg.segment_volume(_volume(n, seed=n))
        except Exception as exc:  # re-raised below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(k, n)) for k, n in enumerate(sizes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for k, n in enumerate(sizes):
        np.testing.assert_array_equal(got[k][0], want[n][0])
        np.testing.assert_array_equal(got[k][1], want[n][1])


def test_mesh_path_gathers_under_its_span(unet, monkeypatch):
    monkeypatch.setattr(streaming, "all_gather_host", lambda obj, mesh: [obj])
    seg = _segmenter(unet, mesh=Mesh(1, 1, 0, torch.device("cpu")))
    vol = _volume(5)
    want = _segmenter(unet).segment_volume(vol)
    with _cpu_profiler():
        got = seg.segment_volume(vol)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    spans = _by_name(profiling.spans())
    (gather,) = spans["serve.gather"]
    assert gather.parent is spans["serve.volume"][0]
    assert gather.counts == {"bytes": want[0].nbytes + want[1].nbytes}
    assert spans["serve.volume"][0].counts == {"bscans": 5, "padded": 3}


def test_spans_lie_on_the_exported_trace_clock(tmp_path):
    with _cpu_profiler() as prof:
        for _ in range(3):
            with profiling.span("clock.check"):
                time.sleep(0.002)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    events = sorted(e["ts"] for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation" and e.get("name") == "clock.check")
    records = sorted(r.start_ns for r in profiling.spans())
    assert len(events) == len(records) == 3
    for ts, start in zip(events, records):
        assert abs(ts * 1e3 + base - start) < 2e6


def test_self_time_of_nested_spans(monkeypatch):
    S = profiling.Span
    top = S("top", None, 1, 0, 0, 100, {"bytes": 5})
    records = [
        S("a", top, 1, 0, 10, 30, {"bytes": 2}),
        S("a", top, 1, 0, 20, 50),  # overlaps the first: the union counts once
        S("b", top, 1, 0, 90, 120),  # clipped to its parent's end
        S("leaf", None, None, 0, 0, 7),
        top,
    ]
    records.append(S("c", records[0], 1, 0, 12, 18))
    monkeypatch.setattr(profiling, "_RECORDS", records)
    totals = profiling.span_totals()
    assert totals["top"] == {"count": 1, "total_ns": 100, "self_ns": 100 - 40 - 10, "counts": {"bytes": 5}}
    assert totals["a"] == {"count": 2, "total_ns": 50, "self_ns": 50 - 6, "counts": {"bytes": 2}}
    assert totals["b"]["self_ns"] == 30 and totals["leaf"]["self_ns"] == 7
    assert totals["c"]["self_ns"] == 6


def test_export_under_a_profiler_holds_no_profiler_op(unet):
    loaded, config = unet
    forward, kind = select_optimized_forward(loaded.module)
    chain = FusedPipeline(
        forward.eval(), get_model_class("unet")(**config).get_preprocess_input_fn(),
        s2d_labels=kind == "s2d", num_classes=C, return_maps=False,
    )
    images = torch.zeros((2, H, W, 1), dtype=torch.uint8)
    with _cpu_profiler(), torch.no_grad():
        program = torch.export.export(chain, (images,))
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t], targets
    assert profiling.spans() == []


def test_input_wait_covers_a_slow_source():
    pause, n = 0.05, 3
    produced = []

    def slow():
        for i in range(n):
            time.sleep(pause)
            produced.append(i)
            yield np.full((2, 3), i, np.float32), np.full((2,), i, np.int32)

    mesh = Mesh(1, 1, 0, torch.device("cpu"))
    with _cpu_profiler():
        got = [int(x[0, 0]) for x, _y in input_pipeline.prefetch_to_mesh(slow(), mesh)]
    assert got == list(range(n))
    spans = _by_name(profiling.spans())
    waits = spans["input.wait"]
    assert len(waits) == n + 1 and all(r.thread == threading.get_ident() for r in waits)
    assert sum(r.end_ns - r.start_ns for r in waits) >= 0.9 * n * pause * 1e9
    # The producer thread stages each batch under its own span, through a
    # ring that the first batch allocates.
    stage = {"bytes": 2 * 3 * 4 + 2 * 4, "slot_wait": 0}
    assert [r.counts for r in spans["serve.stage"]] == (
        [{**stage, "slot_alloc": 1}] + [{**stage, "slot_alloc": 0}] * (n - 1))
    assert all(r.thread != threading.get_ident() and r.parent is None for r in spans["serve.stage"])


def test_prefetch_to_mesh_stages_through_one_ring():
    """Each rank's rows of every node batch arrive in order, through one
    ring of ``size + 1`` slots that the first batch allocates and later
    batches reuse; the batches the consumer kept are not overwritten by the
    reuse, and an error of the source reaches the consumer after the
    batches before it."""
    rng = np.random.default_rng(7)
    batches = [(rng.random((4, 3, 5), dtype=np.float32), rng.integers(0, 9, (4, 3)).astype(np.int32))
               for _ in range(5)]

    def failing():
        yield from batches
        raise RuntimeError("source failed")

    stage = {"bytes": 2 * 3 * 5 * 4 + 2 * 3 * 4, "slot_wait": 0}
    for rank in range(2):
        mesh = Mesh(1, 2, rank, torch.device("cpu"))
        profiling.reset_spans()
        got = []
        with _cpu_profiler(), pytest.raises(RuntimeError, match="source failed"):
            for batch in input_pipeline.prefetch_to_mesh(failing(), mesh, size=2):
                got.append(batch)
        assert len(got) == len(batches)
        for (gx, gy), (x, y) in zip(got, batches):
            rows = mesh.local_rows(len(x))
            np.testing.assert_array_equal(gx.numpy(), x[rows])
            np.testing.assert_array_equal(gy.numpy(), y[rows])
        stages = [r.counts for r in profiling.spans() if r.name == "serve.stage"]
        assert stages == [{**stage, "slot_alloc": 1}] + [{**stage, "slot_alloc": 0}] * 4
