"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, bounds, and files under its paths."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert len(c["reduced"]) <= 16
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == names


def test_workloads():
    seen, pairs = set(), set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in seen
        seen.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    names = set()
    e2e = {}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert "workloads" not in moved or c in moved["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if "workloads" not in m or c in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(c in m.get("workloads", cells) for m in SPEC["per_layer"])
