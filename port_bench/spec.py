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

A configuration's frame loop is its ``loop`` group: ``scale``, ``post``
(the post stage), ``rates``, ``gi_cadence``, ``include_gi``, ``warp_taps``
and ``sub_frames``, and two optional keys: ``net``, the path from the
repository's root of the learned upscaler's parameter checkpoint (a pickle
of flax's tree, as ``checkpoints/upscaler.pkl``), which ``post`` ``"net"``
needs, and ``comp_cadence``, a GI composite every that many frames (1
where it is left out).
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
        check_loop(self.config["loop"])
        self.traffic = _json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(here / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
        self.here = here
        self.root = root

    def net_path(self) -> Path | None:
        """The learned upscaler's checkpoint, or None where the loop names
        none."""
        net = self.config["loop"].get("net")
        return None if net is None else self.root / net

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


def check_loop(loop: dict) -> None:
    """Refuse a ``loop`` group whose optional keys (module docstring) are
    missing where they are needed or out of their range."""
    net = loop.get("net")
    if (loop["post"] == "net") != (net is not None):
        raise ValueError('post "net", and it alone, needs the key '
                         '"loop.net": the path of its parameter checkpoint')
    if loop["post"] == "net" and loop["scale"] != 3:
        raise ValueError('post "net" upscales 3x: "loop.scale" must be 3')
    if net is not None and (not isinstance(net, str) or net.startswith("/")
                            or ".." in Path(net).parts):
        raise ValueError(f'"loop.net" {net!r}: a path inside the repository')
    cad = loop.get("comp_cadence", 1)
    if not isinstance(cad, int) or isinstance(cad, bool) or cad < 1:
        raise ValueError(f'"loop.comp_cadence" {cad!r}: a whole number >= 1')


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
