"""`BENCHMARK.json` keeps to the benchmark's contract, and every
configuration, traffic mix, metric and limit it names has its file."""
import json
import re

from rcbench import cell as C
from rcbench.metrics import reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return C.read_json(C.ROOT / "BENCHMARK.json")


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["rcbench"] and b["command"] == ["python3", "rcbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((C.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_workloads_have_their_files():
    b = _bench()
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("rcbench/") and (C.ROOT / c["file"]).exists()
        cfg = C.read_json(C.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (C.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        cell = C.load(w["name"], b)
        assert cell.limits is not None and "logit_gap" in cell.limits


def test_metrics_keep_to_the_contract_and_have_readers():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved) and set(m["workloads"]) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        reader(m["name"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for cell in cells:
        reported = [m for m in b["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    json.dumps(b)
