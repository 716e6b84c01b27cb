"""BENCHMARK.json against the rules its reader applies: keys, names,
units, lengths, and every file a name leads to."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in B["paths"])
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
    assert all(NAME.match(k) for k in c["reduced"])
    assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
    assert w["chips"] in (1, 4) and w["config"] in {c["name"] for c in B["configs"]}
    mix = json.load(open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")))
    assert os.path.isfile(os.path.join(BENCH, "traffic", mix["kind"] + ".py"))
    assert os.path.isfile(os.path.join(BENCH, "limits", w["name"] + ".json"))


def four_chip_cells_allowed(workloads) -> bool:
    """At most a quarter of the cells, rounded down, ask for four chips;
    one always may."""
    four = sum(1 for w in workloads if w["chips"] == 4)
    return four <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("chips,ok", [([4], True), ([1, 4], True), ([1, 1, 4, 4], False),
                                      ([1, 1, 1, 1, 1, 1, 1, 4, 4], True),
                                      ([1, 1, 1, 1, 1, 1, 4, 4, 4], False)])
def test_four_chip_rule(chips, ok):
    assert four_chip_cells_allowed([{"chips": c} for c in chips]) == ok


def test_four_chip_cells_within_the_rule():
    assert four_chip_cells_allowed(B["workloads"])


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"], ids=lambda m: m["name"])
def test_metrics(m):
    cells = {w["name"] for w in B["workloads"]}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(m.get("workloads", [])) <= cells
    if m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"]) and os.path.isfile(
            os.path.join(BENCH, "metrics", m["name"] + ".py"))
        moves = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in B["per_layer"])
