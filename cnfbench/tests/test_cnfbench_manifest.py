"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names and
units, and every cell's configuration, traffic, limits and metric readers
resolve to files of the benchmark's folder."""

import json
import re

import pytest

from cnfbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = cells.benchmark()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section in ("end_to_end", "per_layer"):
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")


def test_configs_and_cells_resolve():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert (cells.ROOT / c["file"]).is_file() and c["file"].startswith("cnfbench/")
        data = json.loads((cells.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        used.add(w["config"])
        cell = cells.load(w["name"])
        assert cell.traffic["kind"] in ("train", "serve") and cell.limits
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert callable(cells.reader(m["name"]))
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_bounds_and_layers():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_are_named_from_name_characters():
    for path in (cells.ROOT / "cnfbench").rglob("*"):
        rel = path.relative_to(cells.ROOT).as_posix()
        if "__pycache__" in rel or not path.is_file():
            continue
        assert PATH.match(rel), rel
