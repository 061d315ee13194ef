"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by its name:

* a configuration: the ``file`` of its entry under ``configs``
  (``port_bench/configs/<name>.json``);
* a traffic mix: ``port_bench/traffic/<traffic>.json``, read by
  ``flight.Flight``;
* a metric: ``port_bench/metrics/<name>.py``, a reader with ``read(rec)``
  that returns the metric's value, or None where it finds nothing to read;
* a cell's limits on the numbers that decide ``correct``:
  ``port_bench/limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _one(items, name: str, what: str) -> dict:
    found = [x for x in items if x["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries")
    return found[0]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT,
                 here: Path = HERE):
        self.name = name
        self.entry = _one(bench["workloads"], name, "workload")
        self.config_entry = _one(bench["configs"], self.entry["config"],
                                 "config")
        self.config = _json(root / self.config_entry["file"])
        self.traffic = _json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(here / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
        self.here = here

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics a run reports: the end-to-end ones with ``--trace
        0``, the per-layer ones with ``--trace 1``."""
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"port_bench.metrics.{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _reports(metric: dict, workload: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or workload in cells


def engine_config(cfg: dict, classes) -> object:
    """The ``EngineConfig`` of a configuration file, from its top-level
    keys that are ``EngineConfig``'s fields (every field is written out),
    built from ``classes``, a module with the dataclasses ``WorldConfig``,
    ``TerrainConfig``, ``LightingConfig``, ``RenderConfig`` and
    ``EngineConfig`` (the port's or the reference's)."""
    groups = {"world": classes.WorldConfig, "terrain": classes.TerrainConfig,
              "lighting": classes.LightingConfig,
              "render": classes.RenderConfig}
    kw = {}
    for f in dataclasses.fields(classes.EngineConfig):
        k, v = f.name, cfg[f.name]
        if k in groups:
            kw[k] = groups[k](**{f: tuple(x) if isinstance(x, list) else x
                                 for f, x in v.items()})
        else:
            kw[k] = tuple(v) if isinstance(v, list) else v
    return classes.EngineConfig(**kw)
