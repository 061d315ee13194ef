"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name; a new configuration and traffic pair is found from
new files alone."""

import json
import re
import shutil

import pytest

from port_bench import spec

NAME = spec.NAME
UNIT = spec.UNIT
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_pb_keys_and_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert TEXT.match(word) and not word.startswith("/") \
            and ".." not in word
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_pb_budget_fits_24_cells(bench):
    rs = bench["run_seconds"]
    cells = 24
    need = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_pb_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"].lower(), m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(names) == len(set(names))


def test_pb_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.config["loop"] and cell.traffic and cell.limits
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_pb_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_pb_engine_config_matches_the_ports(bench):
    import dataclasses

    from port_bench.reference import config as rcfg
    from rvgrt_tpu_torch import config as pcfg
    from rvgrt_tpu_torch.bench import headline_config, native_config

    head = spec.Cell(bench, "headline_1024.fly").config
    want = headline_config(10, 1280, 800)
    assert spec.engine_config(head, pcfg) == want
    nat = spec.Cell(bench, "native_1080p.fly").config
    assert spec.engine_config(nat, pcfg) == native_config(want, 1920, 1080)
    ref = spec.engine_config(head, rcfg)
    assert dataclasses.asdict(ref) == dataclasses.asdict(want)


def test_pb_a_new_pair_needs_only_new_files(tmp_path, bench):
    """A configuration, a traffic mix and a cell added by files and
    entries alone: nothing that exists is edited."""
    root = tmp_path / "repo"
    here = root / "port_bench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "headline_1024.json").read_text())
    cfg["render"]["width"], cfg["render"]["height"] = 960, 600
    (here / "configs" / "headline_960.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "fly.json").read_text())
    traffic["segments_rad_per_frame"] = {"fast_turn": 0.05}
    (here / "traffic" / "pan.json").write_text(json.dumps(traffic))
    (here / "limits" / "headline_960.pan.json").write_text(
        (here / "limits" / "headline_1024.fly.json").read_text())
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="headline_960",
        file="port_bench/configs/headline_960.json")]
    new["workloads"] = bench["workloads"] + [dict(
        bench["workloads"][0], name="headline_960.pan",
        config="headline_960", traffic="pan")]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.Cell(spec.load_benchmark(root), "headline_960.pan",
                     root=root, here=here)
    assert cell.config["render"]["width"] == 960
    assert cell.traffic["segments_rad_per_frame"] == {"fast_turn": 0.05}
    assert callable(cell.reader("fps"))
    after = {p: p.read_bytes() for p in before}
    assert after == before
