"""The port's checkpoints (``rvgrt_tpu_torch/driver/checkpoint.py``) against
the JAX package's (``rvgrt_tpu/driver/checkpoint.py``), on the CPU.

A file written by either package loads in the other, bit for bit:

* parameters: the port writes a variant-tagged ``up-m`` tree of random
  weights (``model.params_to_flax``); the JAX package's
  ``load_checkpoint`` reads the same variant and arrays.  The JAX package
  writes an ``up-s`` tree with its ``save_params``; the port's
  ``load_checkpoint`` reads the same weights;
* worlds: the port saves its 64^3 world (heightfield GI init) with frame
  and GI-offset counters; the JAX package's ``load_world`` reads every
  array and counter and derives ``sky_y`` and ``trace_table`` equal to the
  port's; its ``save_world`` writes that world back, and the port's
  ``load_world`` reads it with the same derived arrays.

The JAX side runs in one child process (tests/torch_jaxref.py).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.driver import checkpoint, engine
from rvgrt_tpu_torch.models import upscaler
from rvgrt_tpu_torch.upscale import model
from tests import torch_jaxref as ref

SPEC = {"cube": 6, "engine": dict(gi_init_mode="heightfield")}
WORLD_KEYS = ("bits", "sdf", "gi", "atlas", "sky_y", "trace_table")
FRAME_COUNT, GI_OFFSET = 37, 4096


def _random_net():
    net = upscaler.build("up-m")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # the parameters are trainable
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return net


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    ecfg = ref.make_ecfg(tcfg, SPEC)
    world = engine.build_world(ecfg, verbose=False, device="cpu")
    checkpoint.save_world(str(d / "port_world.npz"), world, ecfg,
                          frame_count=FRAME_COUNT, gi_offset=GI_OFFSET)
    net = _random_net()
    checkpoint.save_params(str(d / "port_params.pkl"), {
        "variant": "up-m", "params": model.params_to_flax(net)})
    params, jworld = ref.run([
        ("ref_params_checkpoint", dict(port_path=str(d / "port_params.pkl"),
                                       jax_path=str(d / "jax_params.pkl"))),
        ("ref_world_checkpoint", dict(spec=SPEC,
                                      port_path=str(d / "port_world.npz"),
                                      jax_path=str(d / "jax_world.npz"),
                                      frame_count=FRAME_COUNT,
                                      gi_offset=GI_OFFSET))])
    return dict(dir=d, ecfg=ecfg, world=engine.world_to_numpy(world),
                net=net, params=params, jworld=jworld)


def test_port_params_load_in_jax(case):
    got = case["params"]
    assert (got["features"], got["layers"]) == (32, 3)
    want = model.params_to_flax(case["net"])["params"]
    read = got["read"]["params"]
    assert set(read) == set(want)
    for layer, p in want.items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(read[layer][k], p[k],
                                          err_msg=f"{layer}.{k}")


def test_jax_params_load_in_port(case):
    net = model.load_checkpoint(str(case["dir"] / "jax_params.pkl"),
                                device="cpu")
    assert (net.features, net.depth_layers) == (16, 2)
    assert model.params_to_flax(net)["params"].keys() == \
        case["params"]["written"]["params"].keys()
    for layer, p in case["params"]["written"]["params"].items():
        conv = getattr(net, layer)
        np.testing.assert_array_equal(
            conv.weight.detach().numpy(),
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.bias.detach().numpy(), p["bias"])


def test_params_pickle_needs_only_numpy(case):
    """A port-written pickle holds dicts, strings and numpy arrays only."""
    found = set()

    class Spy(pickle.Unpickler):
        def find_class(self, module, name):
            found.add(module.split(".")[0])
            return super().find_class(module, name)

    with open(case["dir"] / "port_params.pkl", "rb") as f:
        Spy(f).load()
    assert found <= {"numpy"}, found


def test_port_world_loads_in_jax(case):
    got = case["jworld"]
    assert (got["frame_count"], got["gi_offset"]) == (FRAME_COUNT,
                                                      GI_OFFSET)
    assert got["gi_occ"] is None
    for k in WORLD_KEYS:
        np.testing.assert_array_equal(got["world"][k], case["world"][k],
                                      err_msg=k)


def test_jax_world_loads_in_port(case):
    world, fc, go = checkpoint.load_world(
        str(case["dir"] / "jax_world.npz"), case["ecfg"], device="cpu")
    assert (fc, go) == (FRAME_COUNT, GI_OFFSET)
    got = engine.world_to_numpy(world)
    for k in WORLD_KEYS:
        np.testing.assert_array_equal(got[k], case["jworld"]["world"][k],
                                      err_msg=k)


def test_world_checkpoint_refuses_another_world(case):
    other = ref.make_ecfg(tcfg, {"cube": 5})
    with pytest.raises(AssertionError, match="shift_x"):
        checkpoint.load_world(str(case["dir"] / "port_world.npz"), other,
                              device="cpu")
