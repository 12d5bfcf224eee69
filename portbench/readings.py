#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the card.

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 8 --out readings.json

For every seed of ``--seeds`` a run of the cell (``--seconds`` long) with
no limits, so that every number it compares is read. For every seed of
``--control-seeds`` the control: the plain reference in TF32 (the nearest
precision below the configuration's float32) in the program's place. A
training cell also reads the planted fault "half of the batch left out,
the mean taken over the rest" (the reference on half of each batch). The
benchmark's own runs never run this script.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control_serve(cell):
    from portbench.drivers import serve_volumes
    from portbench.harness import data, judge

    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    pool, _ = data.make_pool(cell.seed, cell.config, cell.traffic)
    weights = data.make_weights(ref.param_spec(cell.model), cell.seed, cell.device)
    data.calibrate(ref, weights, cell.model,
                   judge.gray_to_input(pool[: cell.traffic["batch_size"]], cell.model["input_channels"]), cell.device)
    requests = [{"idx": idx, "labels": None, "rows": None} for idx, _v in serve_volumes.volumes(cell, pool)]
    out = judge.serve_readings(ref, weights, cell.model, pool, requests, cell.seed,
                               cell.traffic["sample_bscans"], cell.device, control=True)
    return {"control_tf32": out}


def control_train(cell):
    from portbench.drivers import train_loop
    from portbench.harness import data, judge

    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    images, labels = data.make_pool(cell.seed, cell.config, cell.traffic)
    weights = data.make_weights(ref.param_spec(cell.model), cell.seed, cell.device)
    batches = train_loop.host_batches(cell, images, labels)[: cell.traffic["check_steps"]]
    want = train_loop.reference_run(cell, ref, weights, batches)
    out = {}
    half = slice(0, cell.traffic["batch_size"] // 2)
    for name, got in (("control_tf32", train_loop.reference_run(cell, ref, weights, batches, precise=False)),
                      ("fault_half_batch", train_loop.reference_run(cell, ref, weights, batches, rows=half))):
        out[name] = judge.train_readings(got["losses"], got["grads"], got["changes"],
                                         want["losses"], want["grads"], want["changes"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.cell import Cell, free, load_json
    from portbench.run import cell_entries, pin_caches

    pin_caches()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    w, config_entry, _e2e, _layer = cell_entries(manifest, args.workload)
    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = load_json("traffic", w["traffic"])
    names = list(load_json("limits", args.workload))
    unlimited = {n: float("inf") for n in names}
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    dev = torch.device("cuda", 0)
    result = {"workload": args.workload, "program": [], "control": []}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        cell = Cell(args.workload, config, traffic, seed, args.seconds, False, dev, unlimited, started=t0)
        out = driver.run(cell)
        row = {"seed": seed, **{n: c["value"] for n, c in out.checks.items()}, **out.end_to_end, **out.notes}
        result["program"].append(row)
        print(json.dumps(row, default=str), file=sys.stderr, flush=True)
        free(dev)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        cell = Cell(args.workload, config, traffic, seed, args.seconds, False, dev, unlimited)
        row = {"seed": seed, **(control_train(cell) if traffic["driver"] == "train_loop" else control_serve(cell))}
        result["control"].append(row)
        print(json.dumps(row, default=str), file=sys.stderr, flush=True)
        free(dev)
    summary = {n: {"program_max": max((r[n] for r in result["program"]), default=None)} for n in names}
    for row in result["control"]:
        for kind, values in row.items():
            for n in set(names) & set(values if isinstance(values, dict) else ()):
                key = f"{kind}_min"
                summary[n][key] = min(summary[n].get(key, values[n]), values[n])
    result["summary"] = summary
    result["seconds"] = time.perf_counter() - STARTED
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
