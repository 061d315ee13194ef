"""Cells of configurations that no entry of ``BENCHMARK.json`` has yet, cut
to the CPU tests' size as ``small.py`` cuts the entries' own: the learned
upscaler at 64x40 -> 192x120 on a 128^3 world, at full rate, with a
checkpoint of seeded weights or the repository's ``checkpoints/
upscaler.pkl``; and the headline with a GI composite every 2nd frame."""

from __future__ import annotations

import pickle

import numpy as np

from port_bench import spec
from port_bench.tests.small import small_cell

#: the layers of ``checkpoints/upscaler.pkl`` (variant ``up-l``): input
#: channels, features, feature convs, shuffle channels
IN_CHANNELS, FEATURES, LAYERS, SHUFFLE = 35, 64, 4, 36
REPO_NET = "checkpoints/upscaler.pkl"


def seeded_net(path, seed: int) -> None:
    """A checkpoint of ``up-l``'s shapes with every kernel and bias drawn
    from ``seed``: kernels at flax's lecun-normal scale, biases at 0.1,
    the shuffle conv's too, so that every layer moves the image."""
    g = np.random.default_rng(seed)
    tree = {}
    for i in range(LAYERS + 1):
        cin = IN_CHANNELS if i == 0 else FEATURES
        cout = SHUFFLE if i == LAYERS else FEATURES
        name = "shuffle" if i == LAYERS else f"feat{i}"
        k = g.normal(0.0, (1.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout))
        tree[name] = {"kernel": k.astype(np.float32),
                      "bias": g.normal(0.0, 0.1, cout).astype(np.float32)}
    with open(path, "wb") as f:
        pickle.dump({"variant": "up-l", "params": {"params": tree}}, f)


def net_cell(root, net: str) -> spec.Cell:
    """The headline's small cell with the post stage ``"net"`` of the
    checkpoint ``root / net``, every frame at full rate."""
    cell = small_cell("headline_1024.fly")
    cell.config["loop"].update(post="net", net=net, rates="full")
    spec.check_loop(cell.config["loop"])
    cell.root = root
    return cell


#: a start column of the 128^3 world with lit terrain in view: from the
#: traffic's own column the small cell sees water and sky alone, where the
#: composite adds nothing
TERRAIN_COLUMN = [0.2, 0.2]


def cadence_cell(cadence: int = 2) -> spec.Cell:
    """The headline's small cell with a GI composite every ``cadence``-th
    frame, started over ``TERRAIN_COLUMN``."""
    cell = small_cell("headline_1024.fly")
    cell.config["loop"]["comp_cadence"] = cadence
    spec.check_loop(cell.config["loop"])
    cell.traffic = dict(cell.traffic, start_column=TERRAIN_COLUMN)
    return cell
