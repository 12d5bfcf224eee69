"""The readers of the program's spans (``stage_ms_per_bscan``,
``fetch_ms_per_bscan``, ``launch_ms_per_batch``): nothing on an empty
recorder, the right value on planted spans, and a whole serving cell's
spans counted as the serving cell counts its B-scans."""

import math

import pytest
import torch
from test_portbench_faults import few_threads, serve_cell  # noqa: F401

from oct_image_segmentation_models_torch.common import profiling
from portbench.drivers import serve_volumes
from portbench.run import read_metric

READERS = ("stage_ms_per_bscan", "fetch_ms_per_bscan", "launch_ms_per_batch")


@pytest.fixture(autouse=True)
def clean_recorder():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(name):
    assert read_metric(name, {}) is None


def test_planted_spans(monkeypatch):
    S = profiling.Span
    ms = 1_000_000
    volumes = [S("serve.volume", None, 1, 0, 0, 100 * ms, {"bscans": 10, "padded": 6}),
               S("serve.volume", None, 2, 0, 200 * ms, 300 * ms, {"bscans": 30, "padded": 2})]
    v1, v2 = volumes
    planted = volumes + [
        S("serve.pad", v1, 1, 0, 0, 4 * ms, {"bscans": 6}),
        S("serve.stage", v1, 1, 0, 5 * ms, 7 * ms, {"bytes": 1}),
        S("serve.stage", v2, 2, 0, 201 * ms, 203 * ms, {"bytes": 1}),
        S("serve.launch", v1, 1, 0, 10 * ms, 13 * ms, {"bscans": 8}),
        S("serve.launch", v2, 2, 0, 210 * ms, 215 * ms, {"bscans": 8}),
        S("serve.fetch", v2, 2, 0, 280 * ms, 300 * ms, {"bytes": 1}),
    ]
    # A child of serve.fetch takes its part off serve.fetch's self time.
    planted.append(S("inner", planted[-1], 2, 0, 290 * ms, 298 * ms))
    monkeypatch.setattr(profiling, "_RECORDS", planted)
    assert read_metric("stage_ms_per_bscan", {}) == pytest.approx((4 + 2 + 2) / 40)
    assert read_metric("fetch_ms_per_bscan", {}) == pytest.approx((20 - 8) / 40)
    assert read_metric("launch_ms_per_batch", {}) == pytest.approx((3 + 5) / 2)


def test_the_readers_on_a_profiled_serving_cell():
    cell = serve_cell("unet-cubes")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = serve_volumes.run(cell)
    assert out.correct, out.checks
    warm_up = 2 * min(cell.traffic["volume_bscans"])  # serve_volumes.run warms up on two volumes
    totals = profiling.span_totals()
    assert totals["serve.volume"]["counts"]["bscans"] == out.context["useful_bscans"] + warm_up
    for name in READERS:
        value = read_metric(name, out.context)
        assert value is not None and math.isfinite(value) and value > 0, name
