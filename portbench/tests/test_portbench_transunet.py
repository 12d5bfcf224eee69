"""The ``transunet-cubes`` cell's pieces on the CPU: the FLOP counts, the
two copies of the plain reference, the readers ``attention_roofline`` and
``encoder_launch_ms_per_batch``, the cell's files as ``run.py`` reads
them, and a whole run of the cell at a tiny size."""

import copy
import importlib.util
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from oct_image_segmentation_models_torch.common import profiling
from portbench.drivers import serve_volumes
from portbench.harness import data, flops
from portbench.harness.cell import Cell, load_json
from portbench.harness.trace import Trace
from portbench.reference import transunet as ref
from portbench.run import cell_entries, read_metric

CELL, CONFIG = "transunet-cubes", "transunet-r50-vitb16"
TINY = dict(hidden=32, layers=2, heads=4, mlp=64, resnet_units=[1, 1, 1], resnet_width=32,
            decoder_channels=[16, 8, 8, 4])
FMHA = "fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<float>::Params)"


@pytest.fixture(autouse=True)
def clean_recorder():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def full_kwargs():
    return load_json("configs", CONFIG)["model"]["kwargs"]


def tiny_kwargs(h=64, w=96):
    return dict(full_kwargs(), image_height=h, image_width=w, **TINY)


def hand_count(h=512, w=1024) -> int:
    """R50-ViT-B/16 at ``h`` x ``w`` counted by hand, 2 FLOPs a multiply-add."""
    conv = flops._conv
    total = conv(3, 64, 7, 7, h // 2, w // 2)
    p = (h // 2 - 3) // 2 + 1, (w // 2 - 3) // 2 + 1  # the max-pool's 127 x 255
    s2 = (p[0] - 1) // 2 + 1, (p[1] - 1) // 2 + 1
    s3 = (s2[0] - 1) // 2 + 1, (s2[1] - 1) // 2 + 1
    for (n, mid, cin, here, out) in ((3, 64, 64, p, p), (4, 128, 256, p, s2), (9, 256, 512, s2, s3)):
        total += conv(cin, mid, 1, 1, *here) + conv(mid, mid, 3, 3, *out) + conv(mid, 4 * mid, 1, 1, *out)
        total += conv(cin, 4 * mid, 1, 1, *out)  # the projected residual
        total += (n - 1) * (conv(4 * mid, mid, 1, 1, *out) + conv(mid, mid, 3, 3, *out) + conv(mid, 4 * mid, 1, 1, *out))
    n = (h // 16) * (w // 16)
    total += 2 * 1024 * 768 * n + 12 * (2 * n * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * n * n * 768)
    g = h // 16, w // 16
    total += conv(768, 512, 3, 3, *g)
    for i, (cin, cout) in enumerate(((512 + 512, 256), (256 + 256, 128), (128 + 64, 64), (64, 16))):
        total += conv(cin, cout, 3, 3, g[0] * 2 ** (i + 1), g[1] * 2 ** (i + 1))
        total += conv(cout, cout, 3, 3, g[0] * 2 ** (i + 1), g[1] * 2 ** (i + 1))
    return total + conv(16, 4, 3, 3, h, w)


def test_forward_flops_at_the_cell_size():
    cfg = load_json("configs", CONFIG)
    assert flops.forward_flops(cfg) == ref.forward_flops(full_kwargs(), 512, 1024) == hand_count()
    assert flops.forward_flops(cfg) == 750_206_287_872  # about 750 GFLOP a B-scan
    assert ref.attention_flops(full_kwargs(), 512, 1024) == 12 * 4 * 2048**2 * 768


@pytest.mark.parametrize("size", ["tiny", "cell"])
def test_forward_flops_match_the_flop_counter(size):
    """The counter on the reference's explicit matmuls and convs, shapes
    only (meta tensors), so the cell's size runs here."""
    kw = tiny_kwargs() if size == "tiny" else full_kwargs()
    h, w = kw["image_height"], kw["image_width"]
    params = {n: torch.empty(s, device="meta") for n, s, _k in ref.param_spec(kw)}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.logits(params, torch.empty(1, h, w, 3, device="meta"), kw)
    assert counter.get_total_flops() == ref.forward_flops(kw, h, w)


def _tests_copy():
    spec = importlib.util.spec_from_file_location("plain_transunet_tests_copy", ROOT / "tests" / "plain_transunet.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("train", [False, True])
def test_the_two_copies_of_the_reference_agree(train):
    other = _tests_copy()
    kw = tiny_kwargs()
    assert other.param_spec(kw) == ref.param_spec(kw)
    weights = data.make_weights(ref.param_spec(kw), 3, "cpu")
    images = torch.from_numpy(data.rng(4, 0).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8))
    stats_a, stats_b = {}, {}
    with torch.no_grad():
        a = ref.logits(weights, ref.preprocess(images), kw, train=train, stats=stats_a)
        b = other.logits(weights, other.preprocess(images), kw, train=train, stats=stats_b)
    assert torch.equal(a, b)
    assert stats_a.keys() == stats_b.keys() and all(torch.equal(stats_a[k][1], stats_b[k][1]) for k in stats_a)


def _planted(monkeypatch, layers_counted, batches=3, ms=40.0):
    S = profiling.Span
    records = [S("transunet.encoder", None, None, 0, 0, int(ms * 1e6) * (i + 1),
                 {"tokens": 8 * 2048, "layers": layers_counted}) for i in range(batches)]
    monkeypatch.setattr(profiling, "_RECORDS", records)


def _ctx(trace, batches=3):
    cfg = load_json("configs", CONFIG)
    return {"trace": trace, "computed_bscans": 8 * batches, "forward_flops": flops.forward_flops(cfg),
            "peak_flops": flops.PEAK_FLOPS["float32"], "height": 512, "width": 1024}


def _trace(launches, seconds, name=FMHA):
    by_name = {name: seconds, "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n": 5.0}
    counts = {name: launches, "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n": 999}
    return Trace(window_s=51.0, busy_s=50.0, by_name=by_name, counts=counts)


def test_attention_roofline_on_planted_readings(monkeypatch):
    _planted(monkeypatch, 12)
    seconds = 1.5
    want = 100.0 * (24 * 12 * 4 * 2048**2 * 768 / 495e12) / seconds
    assert read_metric("attention_roofline", _ctx(_trace(36, seconds))) == pytest.approx(want)


@pytest.mark.parametrize("fault", ["launches", "name", "no_spans", "no_trace", "other_config"])
def test_attention_roofline_reads_none(monkeypatch, fault):
    _planted(monkeypatch, 12)
    ctx = _ctx(_trace(36, 1.5))
    if fault == "launches":  # a name that matched one kernel too many
        ctx = _ctx(_trace(37, 1.5))
    elif fault == "name":  # attention run unfused: GEMMs and a softmax
        ctx = _ctx(_trace(36, 1.5, name="cunn_SoftMaxForward"))
    elif fault == "no_spans":  # a program without the encoder's span
        monkeypatch.setattr(profiling, "_RECORDS", [])
    elif fault == "no_trace":
        ctx["trace"] = None
    else:  # a model of other FLOPs (another cell)
        ctx["forward_flops"] += 1
    assert read_metric("attention_roofline", ctx) is None


def test_encoder_launch_ms_per_batch(monkeypatch):
    assert read_metric("encoder_launch_ms_per_batch", {}) is None
    _planted(monkeypatch, 12, batches=3, ms=40.0)
    assert read_metric("encoder_launch_ms_per_batch", {}) == pytest.approx((40 + 80 + 120) / 3)


def test_run_reads_the_cells_files():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    w, config_entry, e2e, layer = cell_entries(manifest, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "cubes", 1)
    assert config_entry["file"] == f"portbench/configs/{CONFIG}.json"
    assert [m["name"] for m in e2e] == ["serve_bscans_per_s", "setup_s"]
    assert [m["name"] for m in layer] == ["attention_roofline", "encoder_launch_ms_per_batch"]
    config = json.loads((ROOT / config_entry["file"]).read_text())
    assert config["reference"] == "transunet" and config["model"]["name"] == "transunet"
    assert set(load_json("limits", CELL)) == {"malformed", "rows_mismatch", "label_gap"}


def test_the_cell_runs_correct_at_a_tiny_size():
    """``serve_volumes`` end to end at 64x96 with the tiny widths, under a
    CPU profiler: correct, and the encoder's spans read."""
    cfg = copy.deepcopy(load_json("configs", CONFIG))
    cfg["model"]["kwargs"] = tiny_kwargs()
    t = dict(load_json("traffic", "cubes"), pool=8, volume_bscans=[3, 9], block_repeats=1, sample_bscans=12)
    cell = Cell(CELL, cfg, t, 2**31 + 91, 0.5, False, torch.device("cpu"), load_json("limits", CELL))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = serve_volumes.run(cell)
    finally:
        torch.set_num_threads(prev)
    assert out.correct, out.checks
    assert out.context["forward_flops"] == ref.forward_flops(cfg["model"]["kwargs"], 64, 96)
    assert read_metric("encoder_launch_ms_per_batch", out.context) > 0
    assert read_metric("attention_roofline", out.context) is None  # no device trace
