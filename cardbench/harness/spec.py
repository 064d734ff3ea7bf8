"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  Its
configuration is the file its ``configs`` entry gives, its traffic is
``traffic/<traffic>.json``, its correctness limits ``limits/<cell>.json``,
and each metric it reports is read by ``metrics/<metric>.py``.  Adding a
cell, a mix or a metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's content
    config_entry: dict  # its BENCHMARK.json entry
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_load_json(root / entry["file"]),
        config_entry=entry,
        traffic_name=w["traffic"],
        traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """``read(rec)`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("cardbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
