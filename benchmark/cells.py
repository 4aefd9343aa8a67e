"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its limits
(``limits/<workload>.json``), the readers of its metrics
(``metrics/<metric>.py``), and the modules its configuration names: the
data set's reader (``datasets/<dataset>.py``), the theta inits
(``inits/<inits>.py``), the plain reference of its sweep with that
sweep's draw order (``reference/<reference>.py``) and the sweep's
operation count (``counts/<reference>.py``). A cell, a
configuration, a data set, a sampler, a mix or a metric is added by adding
files and entries, without editing any file here.

A configuration file holds exactly the keys of :data:`CONFIG_KEYS`; the
harness honours each, and refuses a file with any other."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# every key of a configuration file, each read by the harness: ``program``
# holds GPIRTConfig's keyword arguments, handed over whole
CONFIG_KEYS = {
    "dataset": "the data set's reader, datasets/<name>.py",
    "source_detail": "what the data and the settings are, in words",
    "vote_codes": '"voteview" (the program recodes Voteview cast codes) or null',
    "n": "respondents, checked against the data", "m": "items, checked against the data",
    "C": "categories, checked against the data", "H": "sessions, checked against the data",
    "program": "GPIRTConfig's keyword arguments besides n, m, horizon and C",
    "reference": "the plain sweep and its draw order, reference/<name>.py",
    "beta_prior_sd": "the sd of the N(0, sd^2) prior on each beta coefficient",
    "inits": "the theta inits, inits/<name>.py",
    "smc_steps": "the SMC anneal's steps (0: the prior init)",
    "smc_max_temp": "the anneal's first temperature", "burn": "burn-in sweeps",
    "reduced": "keys changed from the source (also in BENCHMARK.json)",
    "assumed": "the settings the source leaves open, and what was taken",
    "rows": "keep the first rows respondents (the CPU tests)",
    "cols": "keep the first cols items (the CPU tests)",
}


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration file, with its BENCHMARK.json entry's name
    traffic: dict
    limits: dict  # compared number -> limit
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def _read(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json; KeyError if none."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _read(os.path.join(root, cfg_entry["file"]))
    unknown = set(config) - set(CONFIG_KEYS)
    if unknown:
        raise ValueError(f"{cfg_entry['file']}: keys the harness does not read: "
                         f"{sorted(unknown)}")
    config["name"] = cfg_entry["name"]
    traffic = dict(_read(os.path.join(HERE, "traffic", entry["traffic"] + ".json")),
                   name=entry["traffic"])
    limits = _read(os.path.join(HERE, "limits", workload + ".json"))
    return Cell(workload, int(entry["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


@functools.lru_cache(maxsize=None)
def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (``kind`` "metrics",
    "datasets", "inits", "reference" or "counts")."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_data(cfg: dict):
    """(raw matrix for the program, (n, m) categories 1..C with 0 missing for
    the reference, C) of a configuration's ``dataset``, cut to its ``rows``
    and ``cols`` (items counted after the reader's drops)."""
    reader = load_module("datasets", cfg["dataset"])
    raw = reader.raw()[: cfg.get("rows")]
    y, keep = reader.categories(raw)
    cols = cfg.get("cols")
    if cols is not None:
        y, raw = y[:, :cols], raw[:, keep[:cols]]
    return raw, y, int(y.max())
