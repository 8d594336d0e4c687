"""BENCHMARK.json and the files it names: every name, unit and line within
the allowed characters and lengths, every cell's files found by name,
every metric with a reader of its own."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert 1 <= len(s["paths"]) <= 16
    for p in s["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(s["command"]) <= 32 and all(line(w) for w in s["command"])
    for word in s["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in s["paths"])


def test_configs():
    s = spec()
    assert 1 <= len(s["configs"]) <= 24
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["why"]) and line(c["source"])
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        importlib.import_module(f"portbench.references.{cfg['reference']}")
        used = [w for w in s["workloads"] if w["config"] == c["name"]]
        assert used, f"configuration {c['name']} has no cell"
    assert len({c["file"] for c in s["configs"]}) == len(s["configs"])


def test_cells_find_their_files():
    s = spec()
    names = {c["name"] for c in s["configs"]}
    assert 1 <= len(s["workloads"]) <= 24
    pairs = set()
    four = 0
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        wl = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"]
        importlib.import_module(f"portbench.entries.{wl['entry']}")
    assert four <= max(1, len(s["workloads"]) // 4)


def test_metrics():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(s["end_to_end"]) <= 16
    assert 1 <= len(s["per_layer"]) <= 128
    cells = {w["name"] for w in s["workloads"]}
    seen = set()
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(reader.read)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in s["end_to_end"] if cell in m.get("workloads",
                                                              cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in s["per_layer"])


@pytest.mark.parametrize("cell", sorted(p.stem for p in
                                        (HERE / "workloads").glob("*.json")))
def test_workload_files(cell):
    wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{wl['config']}.json").read_text())
    assert set(wl["checks"]["limits"]) <= {"loss", "grad", "change", "cv",
                                           "left_out"}
    assert all(v > 0 for v in wl["checks"]["limits"].values())
    # the chaos rule leaves out replicas only, and is counted
    assert set(wl["checks"].get("chaos", {})) <= set(wl["checks"]["limits"])
    assert ("chaos" in wl["checks"]) == ("left_out" in wl["checks"]["limits"])
    assert ("chaos" not in wl["checks"]) or "replicas" in wl
    assert cfg["data"]["recipe"] in importlib.import_module(
        "portbench.data").RECIPES
    assert line(wl["why"])
