"""BENCHMARK.json against the contract's shape rules, and every file it
names present."""

import json
import re

import pytest

from slambench import cell

B = json.load(open(cell.ROOT / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level():
    assert set(B) == KEYS
    assert 1 <= B["run_seconds"] <= 51
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    assert len(B["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in B["command"])
    assert len(json.dumps(B)) < 64 * 1024


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
    for c in B["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]


def test_bounds():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_each_cell_reports_what_it_must(w):
    c = cell.load_cell(w)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (w, m["name"])


def test_every_named_file_is_there():
    here = cell.HERE
    for c in B["configs"]:
        assert (cell.ROOT / c["file"]).is_file()
        assert c["file"].startswith("slambench/configs/")
        assert json.load(open(cell.ROOT / c["file"]))["source"] \
            == c["source"]
    for w in B["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
    for m in B["end_to_end"] + B["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()
        assert callable(cell.metric_reader(m["name"]))
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


def test_layers_are_named_alike():
    for m in B["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
