"""BENCHMARK.json against the benchmark's contract, and every file a cell
names."""

import json
import re

import pytest

from conftest import ROOT

BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(word) for word in cmd)
    for word in cmd:
        if "/" in word and (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"]), word


def test_run_seconds_fits_the_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert (BENCH / "reference" / f"{body['reference']}.py").exists()
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_workloads_name_their_files():
    pairs = set()
    configs = {c["name"] for c in MANIFEST["configs"]}
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()


def _e2e_of(cell):
    return {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}


def test_end_to_end_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = _e2e_of(cell)
        assert "setup_s" in e2e and len(e2e) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    reported = set()
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert cell in cells and m["moves"] in _e2e_of(cell), (m["name"], cell)
        reported |= set(m["workloads"])
    assert reported == cells


def test_layer_names_are_consistent():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_limits_hold_the_compared_numbers():
    for w in MANIFEST["workloads"]:
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_files_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
