"""The benchmark's data: BENCHMARK.json at the checkout's root, and the files
it names by name under `benchmark/` (configurations, traffic mixes, limits,
metric readers). Nothing here names a cell, a configuration or a metric:
a new one is a new file and a new entry."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, with its path
    traffic: dict         # the traffic mix file
    limits: dict          # the limits of the numbers `correct` compares
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = _read(root / conf["file"])
    config["_dir"] = str((root / conf["file"]).parent)
    traffic = _read(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _read(BENCH / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """`read(run) -> float | None` of benchmark/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
