"""Parity of the port's training path with the JAX trainers.

``rvgrt_tpu_torch/upscale/train.py``, ``residual.py``'s trainer and
``tools/train_residual.py`` against ``rvgrt_tpu/upscale/train.py``,
``residual.py`` and ``scripts/train_residual.py``, inputs and weights from
numpy seeds (a flax tree carried across by ``model.params_from_flax``):

* ``loss_fn``'s value and every parameter's gradient against
  ``jax.value_and_grad``, for up-s and the residual head, on inputs with
  ties put in on purpose (blocks of exact 0 and 1, flat regions, a target
  equal to the output over a block - exact in both packages because the
  nets start from a zero shuffle conv, as a fresh net does): float32 nets
  within rtol 1e-6 on the loss and 1e-5 x the tensor's max |g| on each
  gradient; bf16 nets within rtol 1e-3 and a gradient cosine >= 0.999;
* ``make_optimizer``: the cosine schedule equal to optax's at every count,
  and five Adam updates within 4 ulp of optax's, with and without decay;
* the closed loop (``train_closed_loop``) and the head's loop, float32, two
  synthetic segments, 6 steps from the same numpy rng: the losses within
  rtol 1e-4, the parameters after one step within 1e-3 x lr wherever the
  first gradient's |g| > 1e-6;
* ``accumulate_samples`` >= 50 dB a frame (``test_torch_upscale.py``'s
  temporal gate);
* ``render_pair_dataset`` at the 64^3 slice world with the clock pinned:
  the jitter and the history resets exact, the images >= 50 dB with the
  same hit classification;
* both trainers' ``evaluate`` within 1e-3 dB, ``temporal_ratio`` within
  1e-4;
* checkpoints: the port's trainers write files the JAX package reads (as
  ``bench.py`` reads the head), and the port reads the JAX trainers'
  files bit for bit; ``tools/train_residual.py --cpu`` and
  ``tools/eval_upscale.py --cpu`` at a tiny size;
* the port's own counterparts of ``tests/test_upscale.py``'s training
  tests (bf16), and serving calls that build no autograd graph.

The JAX side runs without FMA contraction in child processes
(tests/torch_jaxref.py): the pair renderer in one, the rest in another.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.driver import checkpoint as ck
from rvgrt_tpu_torch.driver import engine, frame_loop
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
from rvgrt_tpu_torch.tools import eval_upscale, train_residual
from rvgrt_tpu_torch.upscale import model, residual, temporal, train
from tests import torch_jaxref as ref

H, W = 16, 24              # low res; display 48x72
UP_S = (16, 2)             # up-s: features, layers
HEAD = (32, 3)             # the residual head's defaults
LR = 1e-3
STEPS = 6
CLOCK = 1000.0
PAIRS = dict(spec=ref.SLICE_SPEC, n_frames=5, low_w=48, low_h=32,
             clock=CLOCK, include_gi=True, segment_len=3, path_seed=7,
             ssaa=2, jitter_seq=phase_jitter_sequence(3))


def _tree(cin: int, features: int, layers: int, cout: int, seed: int,
          zero_shuffle: bool) -> dict:
    """A flax tree: lecun-scale feature kernels and small biases drawn at
    random; the shuffle conv zero (a fresh net's) or random.  An upscaler
    tree (``cout`` 36) gets the blend logit's bias -3, as a fresh net."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(layers + 1):
        ci = cin if i == 0 else features
        co = cout if i == layers else features
        k = rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)
        b = 0.1 * rng.standard_normal(co)
        if i == layers and zero_shuffle:
            k, b = np.zeros_like(k), np.zeros_like(b)
            if cout == 4 * 9:
                b[3::4] = -3.0
        tree["shuffle" if i == layers else f"feat{i}"] = dict(
            kernel=k.astype(np.float32), bias=b.astype(np.float32))
    return {"params": tree}


def _up_tree(seed: int, zero_shuffle: bool) -> dict:
    return _tree(model.IN_CHANNELS, *UP_S, 36, seed, zero_shuffle)


def _head_tree(seed: int, zero_shuffle: bool) -> dict:
    return _tree(residual.IN_CHANNELS, *HEAD, 27, seed, zero_shuffle)


def _port_net(kind: str, tree: dict, dtype):
    net = (model.UpscalerNet(*UP_S, dtype=dtype) if kind == "upscaler"
           else residual.ResidualHead(*HEAD, dtype=dtype))
    net.load_state_dict(model.params_from_flax(tree))
    return net


def _blocks(a: np.ndarray, rng) -> np.ndarray:
    """``a`` with flat blocks at exactly 0 and 1 and a grey one."""
    a = a.copy()
    hh, ww = a.shape[:2]
    a[:hh // 3, :ww // 3] = 1.0
    a[hh // 3:hh // 2, :ww // 3] = 0.0
    a[-hh // 4:, -ww // 4:] = 0.5
    a[rng.random((hh, ww)) < 0.05] = 1.0
    return a


def _up_sample(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        color=_blocks(rng.random((H, W, 3), np.float32), rng),
        motion=rng.normal(0.0, 0.01, (H, W, 2)).astype(np.float32),
        depth=rng.random((H, W), np.float32),
        jitter=np.array([0.013, -0.021], np.float32),
        history=_blocks(rng.random((3 * H, 3 * W, 3), np.float32), rng),
        target=_blocks(rng.random((3 * H, 3 * W, 3), np.float32), rng))


def _head_sample(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    acc = rng.uniform(-0.2, 1.2, (3 * H, 3 * W, 3)).astype(np.float32)
    return dict(
        color=_blocks(rng.random((H, W, 3), np.float32), rng),
        motion=rng.normal(0.0, 0.01, (H, W, 2)).astype(np.float32),
        depth=rng.random((H, W), np.float32),
        jitter=np.zeros(2, np.float32),
        acc_out=_blocks(acc, rng),
        acc_conf=(rng.random((3 * H, 3 * W), np.float32) * 12),
        target=_blocks(rng.random((3 * H, 3 * W, 3), np.float32), rng))


def _t(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            d.items()}


def _port_sample(kind: str, d: dict):
    cls = train.Sample if kind == "upscaler" else residual.ResSample
    return cls(**_t({k: d[k] for k in cls._fields}))


def _with_tie_block(kind: str, tree: dict, d: dict) -> dict:
    """``d`` with its target equal to the f32 net's output over a block
    (the output of a zero shuffle conv is the same to the bit in both
    packages: the bilinear anchor blended with the history, or the
    clipped accumulator)."""
    net = _port_net(kind, tree, torch.float32)
    with torch.no_grad():
        if kind == "upscaler":
            _, out = train.loss_fn(net, _port_sample(kind, d))
        else:
            _, out = residual.loss_fn(net, _port_sample(kind, d))
    d = dict(d)
    d["target"] = d["target"].copy()
    d["target"][10:30, 20:50] = out.numpy()[10:30, 20:50]
    return d


#: the gradient cases' names, in ``_grad_cases``'s order
GRAD_CASES = ["up-s fresh f32", "up-s random f32", "head fresh f32",
              "head random f32", "up-s random bf16", "head random bf16"]


@functools.lru_cache(maxsize=None)
def _grad_cases() -> list:
    """The gradient cases: (name, kind, dtype, tree, sample)."""
    up0, head0 = _up_tree(1, True), _head_tree(2, True)
    up1, head1 = _up_tree(3, False), _head_tree(4, False)
    return [
        ("up-s fresh f32", "upscaler", "float32", up0,
         _with_tie_block("upscaler", up0, _up_sample(5))),
        ("up-s random f32", "upscaler", "float32", up1, _up_sample(6)),
        ("head fresh f32", "residual", "float32", head0,
         _with_tie_block("residual", head0, _head_sample(7))),
        ("head random f32", "residual", "float32", head1, _head_sample(8)),
        ("up-s random bf16", "upscaler", "bfloat16", up1, _up_sample(6)),
        ("head random bf16", "residual", "bfloat16", head1,
         _head_sample(8)),
    ]


def _segments(kind: str, seed: int) -> list:
    """Two segments of three samples."""
    make = _up_sample if kind == "upscaler" else _head_sample
    return [[make(seed + 3 * j + k) for k in range(3)] for j in range(2)]


def _moving_frames(n: int = 4) -> list:
    """Low-res frames of a texture panning right, with matching motion
    vectors and the 9-phase jitter, as ``train.Sample`` dicts."""
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    seq = phase_jitter_sequence(3)
    frames = []
    for f in range(n):
        sx = xx + 0.7 * f
        col = np.stack([0.5 + 0.4 * np.sin(sx * 0.5 + yy * 0.2),
                        0.5 + 0.4 * np.cos(yy * 0.3 - sx * 0.1),
                        0.5 + 0.3 * np.sin((sx + yy) * 0.2)], axis=-1)
        col = np.clip(col + rng.normal(0.0, 0.02, col.shape), 0, 1)
        mot = np.zeros((H, W, 2), np.float32)
        mot[..., 0] = 0.7 * 2.0 / W
        jit = seq[f % len(seq)] * 0.5 * 2.0 / np.array([W, H], np.float32)
        tgt = rng.random((3 * H, 3 * W, 3), np.float32)
        frames.append(dict(color=col.astype(np.float32), motion=mot,
                           depth=np.ones((H, W), np.float32),
                           jitter=jit.astype(np.float32),
                           history=np.zeros((3 * H, 3 * W, 3), np.float32),
                           target=tgt))
    return frames


def _opt_case(seed: int = 9):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 3, 4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
        -6, 1, v.shape)).astype(np.float32) for k, v in params.items()}
        for _ in range(5)]
    return params, grads


def _flax_grads(net, grads) -> dict:
    return {n: g for (n, _), g in zip(net.named_parameters(), grads)}


def _port_loop(kind: str, tree: dict, segments: list, steps: int):
    """The port's loops as the JAX job runs them: (net, losses, params
    after one step, first gradient)."""
    segs = [[_port_sample(kind, s) for s in seg] for seg in segments]

    def run(n):
        net = _port_net(kind, tree, torch.float32)
        opt = train.make_optimizer(LR, decay_steps=steps)
        st = opt.init(list(net.parameters()))
        rng = np.random.default_rng(0)
        if kind == "upscaler":
            _, losses = train.train_closed_loop(net, opt, st, segs, n,
                                                rng=rng, verbose=False)
            return net, losses
        flat = [s for seg in segs for s in seg]
        losses = []
        for _ in range(n):
            s = flat[rng.integers(len(flat))]
            st, loss, _ = residual.train_step(net, opt, st, s)
            losses.append(float(loss))
        return net, losses

    rng = np.random.default_rng(0)
    net0 = _port_net(kind, tree, torch.float32)
    if kind == "upscaler":
        seg = segs[rng.integers(len(segs))]
        loss, _ = train.loss_fn(net0, seg[0]._replace(
            history=torch.zeros_like(seg[0].history)))
    else:
        flat = [s for seg in segs for s in seg]
        loss, _ = residual.loss_fn(net0, flat[rng.integers(len(flat))])
    g0 = torch.autograd.grad(loss, list(net0.parameters()))
    p1 = dict(run(1)[0].state_dict())
    net, losses = run(steps)
    return dict(net=net, losses=losses, params1=p1,
                grads0=_flax_grads(net0, g0))


def _eval_case() -> dict:
    frames = _moving_frames()
    head = [dict(f, acc_out=np.clip(f["target"] + 0.05, 0, 1),
                 acc_conf=np.full((3 * H, 3 * W), 6.0, np.float32))
            for f in frames]
    return dict(upscaler=dict(features=UP_S[0], layers=UP_S[1],
                              params=_up_tree(11, False), samples=frames),
                head=dict(features=HEAD[0], layers=HEAD[1],
                          params=_head_tree(12, False), samples=head))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX results and the port's, the slow parts of each side
    overlapped: the JAX pair renderer starts first in a child of its own;
    the port writes its checkpoints (the tool's head and the closed loop's
    up-s) and then starts the second child, which reads them; the port
    renders its pairs while both children run."""
    d = tmp_path_factory.mktemp("train")
    pairs_child = ref.start([("ref_render_pairs", PAIRS)])
    other = None
    try:
        tool_out = d / "port_head.pkl"
        tool = train_residual.main([
            "--cpu", "--cube", "6", "--low-w", "48", "--low-h", "32",
            "--frames", "3", "--eval-frames", "2", "--seg", "3",
            "--steps", "2", "--ssaa", "1", "--out", str(tool_out)])
        loops = {k: _port_loop(k, tree, _segments(k, seed), STEPS)
                 for k, tree, seed in (
                     ("upscaler", _up_tree(21, True), 30),
                     ("residual", _head_tree(22, True), 40))}
        port_up = d / "port_up_s.pkl"
        train.save_params({"variant": "up-s", "params": model.params_to_flax(
            loops["upscaler"]["net"])}, str(port_up))
        net_in = _up_sample(50)
        head_in = _head_sample(51)
        cases = _grad_cases()
        opt_params, opt_grads = _opt_case()
        other = ref.start([
            ("ref_train_grads", dict(cases=[dict(
                kind=k, features=(UP_S if k == "upscaler" else HEAD)[0],
                layers=(UP_S if k == "upscaler" else HEAD)[1], dtype=dt,
                params=tree, sample=s) for _, k, dt, tree, s in cases])),
            *[("ref_optimizer", dict(params=opt_params, grads=opt_grads,
                                     lr=LR, decay_steps=ds))
              for ds in (None, 3)],
            *[("ref_closed_loop", dict(
                kind=k, features=(UP_S if k == "upscaler" else HEAD)[0],
                params=tree, segments=_segments(k, seed), steps=STEPS,
                lr=LR, seed=0, out_path=str(d / f"jax_{k}.pkl")))
              for k, tree, seed in (("upscaler", _up_tree(21, True), 30),
                                    ("residual", _head_tree(22, True), 40))],
            ("ref_accumulate", dict(samples=_moving_frames())),
            ("ref_evaluate", _eval_case()),
            ("ref_nets", dict(cases=[
                dict(kind="upscaler", dtype="bfloat16", path=str(port_up),
                     inputs={k: net_in[k] for k in (
                         "color", "motion", "depth", "jitter")}
                     | dict(warped_history=net_in["history"])),
                dict(kind="residual", dtype="bfloat16", path=str(tool_out),
                     features=HEAD[0], layers=HEAD[1],
                     inputs={k: head_in[k] for k in (
                         "color", "motion", "depth", "jitter", "acc_out",
                         "acc_conf")})]))])
        real_time = time.time
        time.time = lambda: CLOCK
        try:
            spec = {k: v for k, v in PAIRS.items() if k not in (
                "spec", "clock")}
            pairs = list(train.render_pair_dataset(
                ref.make_ecfg(tcfg, PAIRS["spec"]), device="cpu", **spec))
        finally:
            time.time = real_time
        tiny = ref.make_ecfg(tcfg, {"cube": 6})
        trained = train.train(tiny, steps=1, low_w=48, low_h=32,
                              segment_len=1, verbose=False, device="cpu")
        up_main = train.main([
            "--device", "cpu", "--variant", "up-s", "--cube", "6",
            "--low-w", "48", "--low-h", "32", "--frames", "3", "--steps",
            "3", "--eval-w", "48", "--eval-h", "32", "--eval-frames", "2",
            "--out", str(d / "main_up_s.pkl")])
        evals = eval_upscale.main([
            "--cpu", "--cube", "6", "--low-w", "48", "--low-h", "32",
            "--frames", "4", "--seg", "2", "--ssaa", "1", "--jitter9",
            "--taps", "bilinear_shift", "nearest", "--decay", "0.35", "0.5",
            "--depth-reject", "--net", str(port_up), "--residual",
            str(tool_out)])
    finally:
        want_pairs = pairs_child.result()[0]
        res = other.result() if other is not None else None
    grads, opt_none, opt_decay, loop_up, loop_head, acc, ev, nets = res
    return dict(tool=tool, tool_out=tool_out, evals=evals, trained=trained,
                up_main=up_main, loops=loops, port_up=port_up,
                pairs=pairs, want_pairs=want_pairs, grads=grads,
                opt={None: opt_none, 3: opt_decay},
                want_loops={"upscaler": loop_up, "residual": loop_head},
                acc=acc, eval=ev, nets=nets, net_in=net_in, head_in=head_in,
                dir=d)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_loss_and_grads_as_jax(case, name):
    i = GRAD_CASES.index(name)
    _, kind, dt, tree, d = _grad_cases()[i]
    want = case["grads"][i]
    net = _port_net(kind, tree, getattr(torch, dt))
    fn = train.loss_fn if kind == "upscaler" else residual.loss_fn
    loss, out = fn(net, _port_sample(kind, d))
    grads = torch.autograd.grad(loss, list(net.parameters()))
    got = _flax_grads(net, grads)
    expect = model.params_from_flax(want["grads"])
    assert sorted(got) == sorted(expect)
    if dt == "float32":
        if "fresh" in name:
            # the ties are real in both packages: the block of the target
            # equals the output to the bit, and the output sits on 0 and 1
            np.testing.assert_array_equal(out.detach().numpy(), want["out"])
            assert int((want["out"] == d["target"]).sum()) > 1000
            assert int(((want["out"] == 0) | (want["out"] == 1)).sum()) > 100
        np.testing.assert_allclose(float(loss.detach()), want["loss"],
                                   rtol=1e-6)
        for k, g in got.items():
            w = expect[k].numpy()
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * scale, err_msg=k)
    else:
        np.testing.assert_allclose(float(loss.detach()), want["loss"],
                                   rtol=1e-3)
        for k, g in got.items():
            a = g.double().flatten()
            b = expect[k].double().flatten()
            cos = float(a @ b / (a.norm() * b.norm()))
            assert cos >= 0.999, (k, cos)


def test_torch_tie_rules_differ_from_jax():
    """The two tie rules matter on these inputs: with ``torch.abs`` and
    ``torch.clamp`` the fresh head's gradient is not JAX's."""
    _, kind, _, tree, d = _grad_cases()[2]
    net = _port_net(kind, tree, torch.float32)
    s = _port_sample(kind, d)
    out = net(s.color, s.motion, s.depth, s.jitter, s.acc_out, s.acc_conf)
    naive = torch.mean(torch.abs(out - s.target))
    g = torch.autograd.grad(naive, [net.shuffle.bias])[0]
    jax_rule = torch.autograd.grad(
        torch.mean(train.abs_jax(net(s.color, s.motion, s.depth, s.jitter,
                                     s.acc_out, s.acc_conf) - s.target)),
        [net.shuffle.bias])[0]
    assert not torch.allclose(g, jax_rule, rtol=0, atol=1e-6)


@pytest.mark.parametrize("decay_steps", [None, 3])
def test_optimizer_as_optax(case, decay_steps):
    want = case["opt"][decay_steps]
    opt = train.make_optimizer(LR, decay_steps=decay_steps)
    if decay_steps:
        got = [np.float32(opt.learning_rate(c))
               for c in range(decay_steps + 3)]
        np.testing.assert_array_equal(got, want["schedule"])
    params, grads = _opt_case()
    p = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    st = opt.init(p)
    for step, g in enumerate(grads):
        upd, st = opt.update([torch.from_numpy(g[k]) for k in ("a", "b")],
                             st)
        opt.apply_updates(p, upd)
        for t, k in zip(p, ("a", "b")):
            np.testing.assert_array_max_ulp(t.numpy(),
                                            want["params"][step][k],
                                            maxulp=4)
    assert st.count == len(grads)


def test_schedule_floor():
    """optax's cosine schedule: 1e-3 at count 0, the floor alpha x lr past
    decay_steps (1e-3, 9.7626e-4, 3.0e-5, 3.0e-5 at 0, 1, 10, 11 of 10)."""
    opt = train.make_optimizer(1e-3, decay_steps=10)
    got = [opt.learning_rate(c) for c in (0, 1, 10, 11)]
    np.testing.assert_allclose(got, [1e-3, 9.7626e-4, 3.0e-5, 3.0e-5],
                               rtol=1e-4)
    assert train.make_optimizer(1e-3).learning_rate(10 ** 6) == \
        float(np.float32(1e-3))


@pytest.mark.parametrize("kind", ["upscaler", "residual"])
def test_training_loop_as_jax(case, kind):
    got = case["loops"][kind]
    want = case["want_loops"][kind]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    p1 = model.params_from_flax(want["params1"])
    g0 = model.params_from_flax(want["grads0"])
    moved = 0
    for k, v in got["params1"].items():
        mask = np.abs(g0[k].numpy()) > 1e-6
        moved += int(mask.sum())
        np.testing.assert_allclose(v.numpy()[mask], p1[k].numpy()[mask],
                                   rtol=0, atol=1e-3 * LR, err_msg=k)
        # the port's first gradient is JAX's on the same sample
        np.testing.assert_allclose(
            got["grads0"][k].numpy(), g0[k].numpy(), rtol=0,
            atol=1e-5 * max(float(g0[k].abs().max()), 1e-30), err_msg=k)
    assert moved > 100


def test_accumulate_samples_50db(case):
    frames = _moving_frames()
    got = list(residual.accumulate_samples(
        [_port_sample("upscaler", f) for f in frames]))
    assert len(got) == len(case["acc"])
    for g, w, f in zip(got, case["acc"], frames):
        assert g.acc_out.shape == (3 * H, 3 * W, 3)
        assert ref.psnr(g.acc_out.numpy(), w["acc_out"]) >= 50.0
        assert ref.psnr(g.acc_conf.numpy() / 12.0,
                        w["acc_conf"] / 12.0) >= 50.0
        np.testing.assert_array_equal(g.target.numpy(), f["target"])


def test_render_pairs_as_jax(case):
    got, want = case["pairs"], case["want_pairs"]
    assert len(got) == len(want) == PAIRS["n_frames"]
    seg = PAIRS["segment_len"]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.jitter.numpy(), w["jitter"])
        assert g.target.shape == (3 * 32, 3 * 48, 3)
        if i % seg == 0:
            # each segment restarts the history from zeros
            assert not g.history.any() and not w["history"].any()
        else:
            assert ref.psnr(g.history.numpy(), w["history"]) >= 50.0
            assert torch.equal(g.history, got[i - 1].target)
        for f in ("color", "motion", "depth", "target"):
            a = getattr(g, f).numpy()
            b = w[f]
            scale = max(float(np.abs(b).max()), 1.0)
            assert ref.psnr(a / scale, b / scale) >= 50.0, (i, f)
        np.testing.assert_array_equal(g.depth.numpy() == 1.0,
                                      w["depth"] == 1.0)
    # the path sees terrain, and the segments turn to their own headings
    assert float((got[0].depth < 1).float().mean()) > 0.2
    assert float((got[0].color - got[seg].color).abs().mean()) > 1e-2


def test_evaluate_as_jax(case):
    ev = _eval_case()
    u = ev["upscaler"]
    unet = _port_net("upscaler", u["params"], torch.float32)
    got = train.evaluate(unet, [_port_sample("upscaler", s)
                                for s in u["samples"]])
    want = case["eval"]["upscaler"]
    assert sorted(got) == sorted(want)
    for k in ("psnr_net", "psnr_bilinear"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert abs(got["temporal_ratio"] - want["temporal_ratio"]) <= 1e-4
    h = ev["head"]
    hnet = _port_net("residual", h["params"], torch.float32)
    got = residual.evaluate(hnet, [_port_sample("residual", s)
                                   for s in h["samples"]])
    want = case["eval"]["head"]
    for k in ("psnr_head", "psnr_accumulator"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_port_checkpoints_read_by_jax(case):
    """The port's up-s checkpoint through JAX's ``load_checkpoint`` and
    the tool's head through ``bench.py``'s reader, each applied by the JAX
    net and by the port's loader: >= 50 dB (bf16 nets)."""
    up_want, head_want = case["nets"]
    net = model.load_checkpoint(str(case["port_up"]), device="cpu")
    assert (net.features, net.depth_layers) == UP_S
    i = _t(case["net_in"])
    with torch.no_grad():
        img, _ = net(i["color"], i["motion"], i["depth"], i["jitter"],
                     i["history"])
    assert ref.psnr(img.numpy(), up_want[0]) >= 50.0
    head = residual.load_checkpoint(str(case["tool_out"]), device="cpu")
    got = residual.apply(head, **_t({k: case["head_in"][k] for k in (
        "color", "motion", "depth", "jitter", "acc_out", "acc_conf")}))
    assert ref.psnr(got.numpy(), head_want) >= 50.0


@pytest.mark.parametrize("kind", ["upscaler", "residual"])
def test_jax_checkpoints_read_by_port(case, kind):
    path = str(case["dir"] / f"jax_{kind}.pkl")
    want = model.params_from_flax(case["want_loops"][kind]["final"])
    net = (model.load_checkpoint(path, device="cpu") if kind == "upscaler"
           else residual.load_checkpoint(path, device="cpu"))
    sd = net.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_train_residual_tool_cpu(case):
    rep = case["tool"]
    assert rep["device"] == "cpu"
    assert len(rep["losses"]) == 2 and all(map(math.isfinite,
                                               rep["losses"]))
    assert len(rep["step_ms"]) == 2
    assert len(rep["render_s"]) == len(rep["accumulate_s"]) == 2
    assert set(rep["eval"][0]) == {"psnr_head", "psnr_accumulator"}
    blob = ck.load_params(str(case["tool_out"]))
    assert blob["kind"] == "residual_head"
    assert (blob["features"], blob["layers"]) == HEAD
    back = residual.load_checkpoint(str(case["tool_out"]), device="cpu")
    for k, v in rep["net"].state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_train_and_main_cpu(case):
    """``train`` (a fresh up-m, one step on one rendered pair) and the
    trainer's ``main`` (up-s, 3 steps, a held-out segment at
    ``--eval-w``): finite losses, an evaluation, and a checkpoint that the
    port reads back as the trained net."""
    net, losses = case["trained"]
    assert (net.features, net.depth_layers) == (32, 3)
    assert len(losses) == 1 and math.isfinite(losses[0])
    rep = case["up_main"]
    assert rep["variant"] == "up-s" and len(rep["losses"]) == 3
    assert all(map(math.isfinite, rep["losses"]))
    assert len(rep["eval"]) == 1
    assert set(rep["eval"][0]) == {"psnr_net", "psnr_bilinear",
                                   "temporal_ratio"}
    back = model.load_checkpoint(rep["out"], device="cpu")
    for k, v in rep["net"].state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_eval_upscale_tool_cpu(case):
    """``tools/eval_upscale.py --cpu`` at a tiny size: bilinear, the
    accumulator over two taps, a second decay and depth rejection, the
    port-trained up-s and the tool's head, each a PSNR and a temporal
    ratio."""
    ev = case["evals"]
    assert sorted(ev) == sorted([
        "bilinear", "temporal[bilinear_shift d=0.35]",
        "temporal[nearest d=0.35]", "temporal[bilinear_shift d=0.5]",
        "temporal[bilinear_shift d=0.35 +depth]",
        "residual[port_head.pkl]", "port_up_s.pkl"])
    for name, (p, ratio) in ev.items():
        assert math.isfinite(p) and p > 10.0, (name, p)
        assert math.isfinite(ratio) and ratio > 0.0, (name, ratio)


def _inputs(h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        color=torch.from_numpy(rng.random((h, w, 3)).astype(np.float32)),
        motion=torch.zeros(h, w, 2),
        depth=torch.ones(h, w),
        jitter=torch.zeros(2),
        history=torch.zeros(h * model.SCALE, w * model.SCALE, 3))


def test_train_step_reduces_loss():
    """``tests/test_upscale.py::test_train_step_reduces_loss`` on the
    port: ten steps on one sample (bf16 net) cut the loss by a fifth."""
    i = _inputs()
    net = model.init_params(16, 24, features=8,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    target = model._resize_bilinear_cf(i["color"].permute(2, 0, 1),
                                       3).permute(1, 2, 0)
    s = train.Sample(target=target, **i)
    opt = train.make_optimizer(1e-2)
    ost = opt.init(list(net.parameters()))
    losses = []
    for _ in range(10):
        ost, loss, out = train.train_step(net, opt, ost, s)
        losses.append(float(loss))
    assert out.shape == s.target.shape and not out.requires_grad
    assert losses[-1] < losses[0] * 0.8, losses


def test_upscaler_beats_nearest_after_training():
    """``tests/test_upscale.py``'s tiny sanity on the port: on a fixed
    checkerboard target, a few steps of training beat the untrained
    net."""
    i = _inputs(8, 12, seed=3)
    net = model.init_params(8, 12, features=8,
                            generator=torch.Generator().manual_seed(1),
                            device="cpu")
    yy, xx = np.meshgrid(np.arange(24), np.arange(36), indexing="ij")
    target = torch.from_numpy(
        np.stack([(yy // 3 + xx // 3) % 2] * 3, -1).astype(np.float32))
    s = train.Sample(target=target, **i)
    with torch.no_grad():
        loss0 = float(train.loss_fn(net, s)[0])
    opt = train.make_optimizer(1e-2)
    ost = opt.init(list(net.parameters()))
    for _ in range(25):
        ost, _, _ = train.train_step(net, opt, ost, s)
    with torch.no_grad():
        loss1 = float(train.loss_fn(net, s)[0])
    assert loss1 < loss0


def test_serving_builds_no_graph():
    """The nets' parameters are trainable, and every serving call returns
    outputs that carry no autograd graph: ``model.upscale``,
    ``residual.apply`` and ``FrameLoop``'s ``"net"`` and ``"residual"``
    post stages."""
    i = _inputs()
    net = model.init_params(16, 24, features=8, device="cpu")
    head = residual.init_params(16, 24, features=8, depth_layers=2,
                                device="cpu")
    assert all(p.requires_grad for p in net.parameters())
    assert all(p.requires_grad for p in head.parameters())
    img, alpha = model.upscale(net, **i)
    assert not img.requires_grad and not alpha.requires_grad
    acc = temporal.init_state(16, 24, device="cpu")
    out = residual.apply(head, i["color"], i["motion"], i["depth"],
                         i["jitter"], acc.history, acc.conf)
    assert not out.requires_grad
    world = engine.World(bits=torch.zeros(1, dtype=torch.int32),
                         sdf=torch.zeros(1, dtype=torch.uint8),
                         gi=torch.zeros(1, dtype=torch.int32),
                         atlas=torch.zeros(1, dtype=torch.int32))
    ecfg = tcfg.EngineConfig(render=tcfg.RenderConfig(width=24, height=16))
    frame = pipeline.FrameOutputs(
        color=i["color"], motion=i["motion"], depth=i["depth"],
        **{f: None for f in pipeline.FrameOutputs._fields
           if f not in ("color", "motion", "depth")})
    cam = engine.camera_arrays(
        engine.Camera(pos=np.zeros(3), forward=np.array([0.0, 0.0, 1.0]),
                      right=np.array([1.0, 0.0, 0.0]),
                      up=np.array([0.0, 1.0, 0.0])), device="cpu")
    for mode, m in (("net", net), ("residual", head)):
        loop = frame_loop.FrameLoop(world, ecfg, upscaler=mode, net=m)
        image = loop._post(frame, cam, None)
        assert image.shape == (48, 72, 3) and not image.requires_grad, mode
