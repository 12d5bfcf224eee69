#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``BENCHMARK.json`` names the cell; its
configuration, traffic mix, driver, limits and per-layer metric readers
are files under ``portbench/`` found by name (see ``portbench/README.md``).
The run loads, warms up, measures for ``--seconds``, checks the outputs
against the plain reference and prints one JSON line last on standard
output. Without a CUDA card, or with fewer than the cell asks for, it
exits with 2 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "oct_image_segmentation_models_tpu")


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr)
    sys.exit(code)


def cell_entries(manifest: dict, workload: str) -> tuple:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return w, config, e2e, layer


def read_metric(name: str, context: dict):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(context)


def card_lines() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    pin_caches()
    sys.path.insert(0, str(ROOT))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    w, config_entry, e2e, layer = cell_entries(manifest, args.workload)

    import torch

    # One intra-op thread: the host share of a run (padding copies, pinned
    # staging, the loop itself) is one process's, steady on a host whose
    # cores other work shares.
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        fail(f"the cell needs {w['chips']} CUDA device(s); "
             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import oct_image_segmentation_models_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not in this checkout: {exc}")

    from portbench.harness.cell import Cell, load_json

    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = load_json("traffic", w["traffic"])
    cell = Cell(args.workload, config, traffic, args.seed, args.seconds, bool(args.trace),
                torch.device("cuda", 0), load_json("limits", args.workload), started=STARTED)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    outcome = driver.run(cell)

    if args.trace:
        context = dict(outcome.context, trace=outcome.trace)
        metrics = {}
        for m in layer:
            value = read_metric(m["name"], context)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        missing = [m["name"] for m in e2e if m["name"] not in outcome.end_to_end]
        if missing:
            fail(f"the driver reported no {missing}", 1)
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]), "unit": m["unit"]} for m in e2e}

    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        fail(f"modules of the JAX package or JAX were loaded: {loaded}", 3)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": w["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": bool(outcome.correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if args.trace:
        if outcome.trace is None or outcome.trace.busy_s <= 0:
            fail("the traced run holds no device activity", 1)
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        result["breakdown"] = outcome.trace.breakdown()
    result["checks"] = outcome.checks

    print(f"portbench: {json.dumps(outcome.notes, default=str)}", file=sys.stderr)
    print(f"portbench: {args.workload} seed {args.seed}; card after the run: {card_lines()}", file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
