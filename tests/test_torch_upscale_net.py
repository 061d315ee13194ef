"""Parity of the port's learned upscaler and residual head with JAX.

``rvgrt_tpu_torch/upscale/model.py``, ``residual.py`` and ``models/``
against ``rvgrt_tpu/upscale/model.py``, ``residual.py`` and ``models/``, at
one size (24x32 low-res, 72x96 display), inputs from numpy seeds:

* ``depth_to_space_cf`` and the three ``warp_history`` modes: bit-exact
  (the same gathers and the same arithmetic in the same order);
* ``UpscalerNet`` ``up-s`` / ``up-m`` / ``up-l`` with random weights,
  every bias and the shuffle conv non-zero (the trained nets give an
  almost constant alpha, so only random weights exercise the alpha channel
  and the three channel orders): float32 within 1e-5, bf16 >= 50 dB on the
  image and on alpha; ``ResidualHead`` with random weights in float32
  within 1e-5;
* each of the five committed checkpoints, loaded and run by the port in a
  process that never imports ``jax`` (asserted there), against the JAX
  package's net of the same file: >= 50 dB; the residual head also keeps
  the JAX suite's "safe" properties (``tests/test_upscale.py``);
* the CLI's ``--upscale fresh``: bit-equal to JAX's fresh output (a zero
  shuffle conv, so the PRNG does not matter: the output is the bilinear
  anchor blended with the history, and the anchor is
  ``jax.image.resize``'s to the bit);
* ``models.get`` and ``VARIANTS`` as JAX's.

The JAX side runs without FMA contraction in one child process
(tests/torch_jaxref.py).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvgrt_tpu import models as jmodels
from rvgrt_tpu_torch import models
from rvgrt_tpu_torch.models import upscaler
from rvgrt_tpu_torch.upscale import model, residual
from tests import torch_jaxref as ref

H, W = 24, 32
SPECS = {"up-s": (16, 2), "up-m": (32, 3), "up-l": (64, 4)}
CHECKPOINTS = ["upscaler.pkl", "upscaler_r2.pkl", "upscaler_r2b.pkl",
               "upscaler_r2c.pkl", "residual_head.pkl"]
WARP_MODES = ["bilinear", "bilinear_packed", "nearest_packed"]


def _inputs(seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        color=rng.random((H, W, 3), np.float32),
        motion=rng.normal(0.0, 0.02, (H, W, 2)).astype(np.float32),
        depth=rng.random((H, W), np.float32),
        jitter=np.array([0.011, -0.017], np.float32),
        warped_history=rng.random((3 * H, 3 * W, 3), np.float32))


def _head_inputs(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        color=rng.random((H, W, 3), np.float32),
        motion=rng.normal(0.0, 0.01, (H, W, 2)).astype(np.float32),
        depth=rng.random((H, W), np.float32),
        jitter=np.zeros(2, np.float32),
        acc_out=rng.random((3 * H, 3 * W, 3), np.float32),
        acc_conf=(rng.random((3 * H, 3 * W), np.float32) * 12))


def _random_tree(cin: int, features: int, layers: int, cout: int,
                 seed: int) -> dict:
    """A flax tree with every kernel and bias drawn at random (kernels at
    lecun scale; the shuffle conv's at three times it, so that alpha
    spreads over (0, 1))."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(layers + 1):
        ci = cin if i == 0 else features
        co = cout if i == layers else features
        k = rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)
        tree["shuffle" if i == layers else f"feat{i}"] = dict(
            kernel=(k * (3.0 if i == layers else 1.0)).astype(np.float32),
            bias=(0.1 * rng.standard_normal(co)).astype(np.float32))
    return {"params": tree}


def _upscaler_tree(name: str) -> dict:
    f, n = SPECS[name]
    return _random_tree(model.IN_CHANNELS, f, n, 36, seed=f + n)


HEAD_TREE = _random_tree(residual.IN_CHANNELS, 32, 3, 27, seed=44)


def _parts_inputs() -> dict:
    rng = np.random.default_rng(11)
    hist = rng.random((3 * H, 3 * W, 3), np.float32)
    # whole and half pixels of motion, so that the nearest tap's rounding
    # and the bilinear weights' ends are both reached
    mot = (rng.integers(-8, 9, (H, W, 2)) * 0.5
           / np.array([1.5 * W, 1.5 * H])).astype(np.float32)
    mot[::3] += rng.normal(0.0, 0.01, mot[::3].shape).astype(np.float32)
    return dict(x_hwc=rng.standard_normal((H, W, 36)).astype(np.float32),
                s=3, c_out=4, history=hist, motion=mot)


#: the port's side of the checkpoint test, run in a process of its own
_NO_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from rvgrt_tpu_torch.upscale import model, residual
args = json.loads(sys.argv[1])
inp = {k: torch.from_numpy(v) for k, v in np.load(args["inputs"]).items()}
head = {k: torch.from_numpy(v) for k, v in np.load(args["head"]).items()}
out = {}
for name in args["files"]:
    path = "checkpoints/" + name
    if name.startswith("residual"):
        net = residual.load_checkpoint(path, device="cpu")
        out[name] = residual.apply(net, **head).numpy()
    else:
        net = model.load_checkpoint(path, device="cpu")
        with torch.no_grad():
            img, alpha = net(**inp)
        out[name] = img.numpy()
        out[name + ":alpha"] = alpha.numpy()
assert "jax" not in sys.modules and not any(
    m == "rvgrt_tpu" or m.startswith(("jax.", "jaxlib", "flax", "rvgrt_tpu."))
    for m in sys.modules), sorted(sys.modules)
np.savez(args["out"], **out)
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX results, and the port's checkpoint outputs from a process
    without jax (run while the JAX child runs)."""
    d = tmp_path_factory.mktemp("nets")
    cases = [dict(kind="upscaler", features=SPECS[n][0], layers=SPECS[n][1],
                  dtype=dt, params=_upscaler_tree(n), inputs=_inputs())
             for n in SPECS for dt in ("float32", "bfloat16")]
    cases.append(dict(kind="residual", features=32, layers=3,
                      dtype="float32", params=HEAD_TREE,
                      inputs=_head_inputs()))
    for f in CHECKPOINTS:
        kind = "residual" if f.startswith("residual") else "upscaler"
        cases.append(dict(kind=kind, features=32, layers=3,
                          dtype="bfloat16", path=str(ref.REPO / "checkpoints"
                                                     / f),
                          inputs=_head_inputs() if kind == "residual"
                          else _inputs()))
    fresh_in = _inputs(9)
    child = ref.start([
        ("ref_upscale_parts", _parts_inputs()),
        ("ref_nets", dict(cases=cases)),
        ("ref_fresh", dict(height=H, width=W, inputs=fresh_in,
                           history=fresh_in["warped_history"]))])
    try:
        np.savez(d / "in.npz", **_inputs())
        np.savez(d / "head.npz", **_head_inputs())
        args = dict(inputs=str(d / "in.npz"), head=str(d / "head.npz"),
                    out=str(d / "out.npz"), files=CHECKPOINTS)
        proc = subprocess.run(
            [sys.executable, "-c", _NO_JAX_SCRIPT, json.dumps(args)],
            cwd=str(ref.REPO), capture_output=True, text=True, timeout=300)
    finally:
        parts, nets, fresh = child.result()
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as f:
        port_ckpt = dict(f)
    n = 2 * len(SPECS)
    return dict(parts=parts, nets=dict(zip(
        [(nm, dt) for nm in SPECS for dt in ("float32", "bfloat16")],
        nets[:n])), head=nets[n], ckpt=dict(zip(CHECKPOINTS, nets[n + 1:])),
        port_ckpt=port_ckpt, fresh=fresh, fresh_in=fresh_in)


def _t(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def test_depth_to_space_cf_bit_exact(case):
    p = _parts_inputs()
    got = model.depth_to_space_cf(torch.from_numpy(p["x_hwc"]), 3, 4)
    assert got.shape == (4, 3 * H, 3 * W)
    np.testing.assert_array_equal(got.numpy(), case["parts"]["d2s"])
    # and space_to_depth_cf inverts it
    back = model.space_to_depth_cf(got)
    np.testing.assert_array_equal(back.permute(1, 2, 0).numpy(), p["x_hwc"])


@pytest.mark.parametrize("mode", WARP_MODES)
def test_warp_history_bit_exact(case, mode):
    p = _parts_inputs()
    got = model.warp_history(torch.from_numpy(p["history"]),
                             torch.from_numpy(p["motion"]), mode=mode)
    assert got.shape == (3 * H, 3 * W, 3)
    np.testing.assert_array_equal(got.numpy(), case["parts"]["warps"][mode])


def _port_net(name: str, dtype) -> model.UpscalerNet:
    f, n = SPECS[name]
    net = model.UpscalerNet(features=f, depth_layers=n, dtype=dtype)
    net.load_state_dict(model.params_from_flax(_upscaler_tree(name)))
    return net.requires_grad_(False)  # applied as served: no graph


@pytest.mark.parametrize("name", list(SPECS))
def test_upscaler_random_weights_f32(case, name):
    img, alpha = _port_net(name, torch.float32)(**_t(_inputs()))
    want_img, want_alpha = case["nets"][(name, "float32")]
    assert img.shape == (3 * H, 3 * W, 3) and alpha.shape == (3 * H, 3 * W)
    # the random shuffle conv moves alpha over most of (0, 1)
    assert float(want_alpha.std()) > 0.1
    np.testing.assert_allclose(img.numpy(), want_img, atol=1e-5, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(SPECS))
def test_upscaler_random_weights_bf16_50db(case, name):
    img, alpha = _port_net(name, torch.bfloat16)(**_t(_inputs()))
    want_img, want_alpha = case["nets"][(name, "bfloat16")]
    assert ref.psnr(img.numpy(), want_img) >= 50.0
    assert ref.psnr(alpha.numpy(), want_alpha) >= 50.0


def test_residual_head_random_weights_f32(case):
    net = residual.ResidualHead(features=32, depth_layers=3,
                                dtype=torch.float32)
    net.load_state_dict(model.params_from_flax(HEAD_TREE))
    got = residual.apply(net, **_t(_head_inputs()))
    assert float(np.abs(case["head"] - np.clip(
        _head_inputs()["acc_out"], 0, 1)).mean()) > 0.01
    np.testing.assert_allclose(got.numpy(), case["head"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_checkpoint_without_jax_50db(case, name):
    got = case["port_ckpt"]
    want = case["ckpt"][name]
    if name.startswith("residual"):
        assert ref.psnr(got[name], want) >= 50.0
        return
    assert ref.psnr(got[name], want[0]) >= 50.0
    assert ref.psnr(got[name + ":alpha"], want[1]) >= 50.0


def test_residual_head_checkpoint_is_safe():
    """The JAX suite's properties of the committed head: a bounded,
    deterministic correction on top of the accumulator."""
    net = residual.load_checkpoint(str(ref.REPO / "checkpoints"
                                       / "residual_head.pkl"), device="cpu")
    inp = _t(_head_inputs())
    out = residual.apply(net, **inp)
    assert out.shape == inp["acc_out"].shape
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert float((out - torch.clamp(inp["acc_out"], 0, 1)).abs().mean()) \
        < 0.05
    assert torch.equal(out, residual.apply(net, **inp))


def test_fresh_bit_equal_to_jax(case):
    inp = _t(case["fresh_in"])
    net = model.init_params(H, W, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    got, alpha = model.upscale(net, inp["color"], inp["motion"],
                               inp["depth"], inp["jitter"],
                               inp["warped_history"])
    assert float(alpha.min()) == float(alpha.max())  # sigmoid(-3)
    np.testing.assert_array_equal(got.numpy(), case["fresh"])


def test_models_registry_as_jax():
    assert {k: tuple(v) for k, v in upscaler.VARIANTS.items()} == {
        k: tuple(v) for k, v in jmodels.upscaler.VARIANTS.items()}
    for name in ("upscaler/up-s", "upscaler/up-l", "upscaler"):
        got, want = models.get(name), jmodels.get(name)
        assert (got.features, got.depth_layers) == (want.features,
                                                    want.depth_layers)
    with pytest.raises(KeyError):
        models.get("nope/x")


def test_params_flax_round_trip():
    net = upscaler.init("up-m", torch.Generator().manual_seed(2), H, W,
                        device="cpu")
    tree = model.params_to_flax(net)
    assert tree["params"]["feat0"]["kernel"].shape == (3, 3, 35, 32)
    assert tree["params"]["shuffle"]["kernel"].shape == (3, 3, 32, 36)
    np.testing.assert_array_equal(tree["params"]["shuffle"]["bias"][3::4],
                                  -3.0)
    back = model.params_from_flax(tree)
    for k, v in net.state_dict().items():
        assert torch.equal(v, back[k]), k
