"""BENCHMARK.json against the contract's shape, and every cell's pieces
found by name: configuration, traffic mix, limits and metric readers."""

import json
import os
import re

import pytest

from benchmark import cells

BENCH = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries(group, keys):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for w in e.get("workloads", []):
            assert w in WORKLOADS


def test_metrics_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"api", "drivers", "sweep", "ops", "device", "diagnostics"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    cell = cells.load_cell(workload)
    assert cell.chips == 1
    assert cell.traffic["chains"] in (64, 512) and cell.traffic["chunk_sweeps"] == 250
    assert cell.config["reduced"] == [] and cell.config["program"]["dtype"] == "float32"
    ref = cells.load_module("reference", cell.config["reference"])
    assert cell.limits and set(cell.limits) <= set(ref.NUMBERS)
    reported = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "sweeps_per_s", "peak_mem_gib"} <= reported
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(cells.load_module("metrics", metric).read)


def test_config_files_match_their_data():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.load(open(os.path.join(cells.ROOT, c["file"])))
        raw, y, C = cells.load_data(cfg)
        assert (cfg["n"], cfg["m"], cfg["C"]) == (y.shape[0], y.shape[1], C)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_names_its_modules(config):
    """A configuration's data set, inits, reference and sweep count are
    files found by the names it gives, and the reference follows its
    program settings and refuses others."""
    from gpirt_tpu_torch.models.config import GPIRTConfig

    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    cfg = json.load(open(os.path.join(cells.ROOT, entry["file"])))
    assert set(cfg) <= set(cells.CONFIG_KEYS)
    assert callable(cells.load_module("datasets", cfg["dataset"]).raw)
    assert callable(cells.load_module("inits", cfg["inits"]).inits)
    ref = cells.load_module("reference", cfg["reference"])
    assert callable(cells.load_module("counts", cfg["reference"]).sweep_flops)
    config = GPIRTConfig(n=cfg["n"], m=cfg["m"], horizon=cfg["H"], C=cfg["C"], **cfg["program"])
    ref.follows(config)
    for other in (dict(theta_method="ess"), dict(threshold_method="newton"),
                  dict(f_method="two_stage"), dict(mix_subsweeps=2)):
        with pytest.raises(ValueError):
            ref.follows(GPIRTConfig(n=cfg["n"], m=cfg["m"], horizon=cfg["H"], C=cfg["C"],
                                    **dict(cfg["program"], **other)))


def test_unread_config_key_is_refused(tmp_path):
    """A configuration file with a key the harness does not read is refused
    when its cell is loaded."""
    root = tmp_path
    bench = dict(BENCH)
    (root / "benchmark" / "configs").mkdir(parents=True)
    cfg = json.load(open(os.path.join(cells.ROOT, BENCH["configs"][0]["file"])))
    cfg["tf32"] = False
    (root / BENCH["configs"][0]["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = next(w["name"] for w in BENCH["workloads"]
                    if w["config"] == BENCH["configs"][0]["name"])
    with pytest.raises(ValueError, match="tf32"):
        cells.load_cell(workload, root=str(root))


def test_check_budget_fits():
    """A full check of 24 cells at this run length fits its clock."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
