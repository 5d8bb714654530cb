"""The benchmark finds its cells, configurations, traffic mixes and metric
readers by name, a cell is added by adding files only, and BENCHMARK.json
keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from otmb_bench import spec as S

BENCH = S.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_and_readers(cell):
    sp = S.load(cell)
    assert sp.config["name"] == sp.cell["config"]
    assert hasattr(S.entry(sp.traffic), "Program")
    assert {"samples", "sample_from", "limits"} <= set(sp.workload)
    names = [m["name"] for m in sp.end_to_end + sp.per_layer]
    assert "setup_s" in names
    for name in names:
        assert callable(S.reader(name))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        S.load("no.such-cell")
    with pytest.raises(ValueError):
        S.load("../escape")


def test_a_cell_is_added_by_files_alone(tmp_path):
    home = tmp_path / "otmb_bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(S.HERE / sub, home / sub)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "esm1deg.age-short", "config": "access-esm1-5-1deg",
                               "traffic": "age_short", "chips": 1, "why": "a new mix"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (home / "traffic" / "age_short.json").write_text(json.dumps(
        dict(json.loads((S.HERE / "traffic" / "age_refined_seasons4.json").read_text()),
             snapshots=2)))
    shutil.copy(S.HERE / "workloads" / "esm1deg.age.json",
                home / "workloads" / "esm1deg.age-short.json")
    sp = S.load("esm1deg.age-short", root=tmp_path, home=home)
    assert sp.traffic["snapshots"] == 2 and sp.traffic["entry"] == "steady_age"
    assert [m["name"] for m in sp.end_to_end] == ["setup_s"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((S.ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert S.reports(e2e[m["moves"]], cell)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        sp = S.load(cell)
        assert len(sp.end_to_end) >= 2 and sp.per_layer
    assert len(json.dumps(BENCH)) <= 64 * 1024

