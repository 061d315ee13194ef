"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can hold: a
128^3 world and a 64x40 render (80x48 native), a GI window over the whole
grid (the first windows of a small grid lie in the solid floor, which an
update leaves as it is), every other setting the cell's own."""

from __future__ import annotations

import copy

from port_bench import spec

SHIFT = 7
RENDER = {"headline_1024": (64, 40), "native_1080p": (80, 48)}


def small_cell(name: str) -> spec.Cell:
    cell = spec.Cell(spec.load_benchmark(), name)
    cfg = copy.deepcopy(cell.config)
    cfg["world"].update(shift_x=SHIFT, shift_y=SHIFT, shift_z=SHIFT)
    w, h = RENDER[cell.entry["config"]]
    s = cfg["loop"]["scale"]
    cfg["render"].update(width=w, height=h, display_width=s * w,
                         display_height=s * h)
    cfg["gi_sweep_frames"] = 1
    cell.config = cfg
    return cell
