"""BENCHMARK.json against the rules it is read by (names, units, sizes,
bounds), and every file that a cell, a configuration, a traffic mix or a
metric is found by."""

import json
import re

import pytest

from port_bench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expan|"
                   r"experts_per_tok|channels|width|feature")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert not p.endswith("_torch") and (harness.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (harness.ROOT / word).exists()


def test_run_seconds_fit_the_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (s + 60) * (2 + 14 * 24) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_uniqueness():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and "assumed" in cfg
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_workloads_find_their_files():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = harness.Cell(w["name"])
        assert cell.driver_path.exists()
        assert hasattr(cell.driver(), "Driver")
        assert cell.mix["limits"] and all(v > 0 for v in cell.mix["limits"].values())
        assert cell.mix["flops_per_unit"] > 0
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)


def test_end_to_end_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    layers: dict = {}
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in moved.get("workloads", cells), (m["name"], c)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert layers


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_shares_of_a_peak_are_percent(name):
    m = next(x for x in BENCH["per_layer"] if x["name"] == name)
    if name.endswith("_roofline") or "mfu" in name:
        assert m["unit"] == "%" and m["better"] == "higher"
