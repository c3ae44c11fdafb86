"""BENCHMARK.json against the contract, and the data-driven layout: every
name it gives is a file of benchmark/, and a cell is added by adding
files and entries.  The parked cells' entries are held to the same rules,
so that adding them back makes a sound file."""
import json
import re

import pytest

import tiny
from harness.spec import Cell

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    assert len(json.dumps(SPEC)) <= 64 * 1024


PARKED = tiny.parked()


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group] + PARKED.get(group, []):
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_names_units_and_lines(group, entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    lines = [entry[k] for k in ("why", "layer") if k in entry]
    if group == "configs":
        lines.append(entry["source"])
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text
        assert "\t" not in text


def test_unique_names_and_counts():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group] + PARKED.get(group, [])]
        assert len(names) == len(set(names))
    metrics = [m["name"] for g in ("end_to_end", "per_layer")
               for m in SPEC[g] + PARKED.get(g, [])]
    assert len(metrics) == len(set(metrics))
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])


def test_entries_name_what_the_file_holds():
    """Every metric's cells are cells of the file, every configuration
    serves a cell, and no parked cell is in the file."""
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert {c["name"] for c in SPEC["configs"]} == {
        w["config"] for w in SPEC["workloads"]}
    assert not cells & {w["name"] for w in PARKED.get("workloads", [])}


def test_bounds_and_run_seconds():
    for m in SPEC["end_to_end"] + PARKED.get("end_to_end", []):
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]
                               + PARKED.get("workloads", [])])
def test_every_cell_finds_its_files(full_root, w):
    cell = Cell(full_root, w)
    assert cell.driver().serve
    assert set(cell.limits)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in names


def test_config_files():
    for c in SPEC["configs"] + PARKED.get("configs", []):
        data = json.loads((tiny.REPO / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == []
        assert c["file"].startswith("benchmark/configs/")
        assert data["assumed"]


def test_a_cell_is_added_by_files_and_entries(tiny_root, capsys):
    """A new mix and cell: two data files and one entry, no code."""
    bench = tiny_root / "benchmark"
    (bench / "traffic" / "clip2s.json").write_text(json.dumps(
        {"kind": "clip", "seconds": 2, "profile_requests": 1,
         "check": {"requests": 1, "window": 1}}))
    (bench / "workloads" / "ser-clip2s.json").write_text(json.dumps(
        {"config": "float512-ser", "traffic": "clip2s", "why": "added",
         "limits": {"frame_mae_max": 0.02}}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "ser-clip2s", "config": "float512-ser",
                              "traffic": "clip2s", "chips": 1,
                              "why": "added"})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("ser-clip2s")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    code, result, _err = tiny.run(tiny_root, "ser-clip2s", capsys)
    assert code == 0 and result["correct"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert result["attempted"] >= 1
