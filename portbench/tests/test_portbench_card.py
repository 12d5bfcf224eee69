"""The controls on the card, at the cells' own widths and sizes: the plain
reference in TF32 in the program's place must come out not correct
against the committed limits.

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_card.py
"""

import json

import pytest

from conftest import ROOT
from portbench import readings
from portbench.harness.cell import Cell, load_json

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
CONFIGS = {c["name"]: c["file"] for c in MANIFEST["configs"]}
SEEDS = (3500000001, 3500000002, 3500000003)


def cell_of(workload, seed, device):
    w = CELLS[workload]
    config = json.loads((ROOT / CONFIGS[w["config"]]).read_text())
    return Cell(workload, config, load_json("traffic", w["traffic"]), seed, 1.0, False, device,
                load_json("limits", workload))


def fails(values: dict, limits: dict) -> bool:
    return any(values[n] > lim for n, lim in limits.items() if n in values)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w for w, c in CELLS.items() if load_json("traffic", c["traffic"])["driver"] == "serve_volumes"])
def test_serving_control_is_not_correct(card, workload, seed):
    cell = cell_of(workload, seed, card)
    assert fails(readings.control_serve(cell)["control_tf32"], cell.limits)
