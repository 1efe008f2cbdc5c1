"""Finds what a cell names: its entry in BENCHMARK.json, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``) and the reader of each of its metrics
(``metrics/<name>.py``), all by name.  A new cell, mix, configuration or
metric is new files and new entries; no file here changes for it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class SetupError(ValueError):
    """A cell that cannot be run as its files state it: found at set-up,
    before the ring is made and before any call of the engine."""


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def settings(cell_name: str, overrides: Optional[dict] = None):
    """(cell, configuration, traffic, ring, sample) of a cell, each dict
    updated by `overrides` ({"config": ..., "traffic": ..., "ring": ...,
    "sample": ...}; the CPU tests cut a cell to a tiny size with them)."""
    o = overrides or {}
    cell = workload(benchmark(), cell_name)
    cfg = {**config(cell["config"]), **o.get("config", {})}
    mix = {**traffic(cell["traffic"]), **o.get("traffic", {})}
    return (cell, cfg, mix, {**mix["ring"], **o.get("ring", {})},
            {**mix["sample"], **o.get("sample", {})})


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports in its traced run: those
    that list it, and those without a list whose end-to-end metric it
    reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str):
    """The module of ``metrics/<name>.py``; its ``read(run)`` gives the
    metric's value, or None where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
