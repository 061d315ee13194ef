"""The traffic generator: seeded, lazy, and driven by its data file."""

import itertools

import numpy as np
import pytest

from port_bench import flight
from port_bench.tests.small import small_cell

SEEDS = (1, 2 ** 31 + 11, 4_000_000_007)


def make(seed, cell="headline_1024.fly"):
    c = small_cell(cell)
    r = c.config["render"]
    return flight.Flight(c.traffic, seed, (30, 20), 40.0, 64,
                         (r["width"], r["height"], r["display_width"],
                          r["display_height"], r["fov_degrees"]),
                         c.config["loop"]["post"])


def yaws(seed, n):
    f = make(seed)
    return [f.next() for _ in range(n)], f


@pytest.mark.parametrize("seed", SEEDS)
def test_pb_same_seed_same_poses(seed):
    a, _ = yaws(seed, 300)
    b, _ = yaws(seed, 300)
    for p, q in zip(a, b):
        for x, y in zip(p.arrays(), q.arrays()):
            assert np.array_equal(x, y)


def test_pb_other_seed_other_poses():
    a, _ = yaws(SEEDS[0], 50)
    b, _ = yaws(SEEDS[1], 50)
    assert not np.array_equal(a[10].forward, b[10].forward)


def test_pb_flight_never_ends_and_keeps_its_rates():
    f = make(SEEDS[1])
    prev = None
    turns = []
    for p in itertools.islice(iter(f.next, None), 5000):
        turns.append(f.yaw - (prev if prev is not None else 0.0))
        prev = f.yaw
    rates = f.traffic["segments_rad_per_frame"]
    mags = {round(abs(t), 6) for t in turns[1:]}
    assert mags == {round(v, 6) for v in rates.values()}
    assert f.frame == 4999


def test_pb_segments_share_the_kinds():
    """Every kind comes once a cycle, so over many segments each takes
    about a third of the frames."""
    f = make(SEEDS[2])
    rates = {round(v, 6): k
             for k, v in f.traffic["segments_rad_per_frame"].items()}
    f.next()
    count = dict.fromkeys(rates.values(), 0)
    for _ in range(6000):
        before = f.yaw
        f.next()
        count[rates[round(abs(f.yaw - before), 6)]] += 1
    for k, n in count.items():
        assert 0.2 < n / 6000 < 0.47, (k, n)


def test_pb_hold_keeps_the_pose():
    f = make(SEEDS[0])
    a = f.next(hold=True)
    b = f.next(hold=True)
    assert np.array_equal(a.forward, b.forward)
    assert np.array_equal(b.vp, b.prev_vp)
    assert not np.array_equal(a.jitter, b.jitter)


def test_pb_start_column_is_the_traffics():
    c = small_cell("headline_1024.fly")
    fx, fz = c.traffic["start_column"]
    assert flight.start_column(c.traffic, 1024, 1024) == (int(1024 * fx),
                                                          int(1024 * fz))


def test_pb_fly_never_translates():
    poses, _ = yaws(SEEDS[1], 400)
    assert all(np.array_equal(p.pos, poses[0].pos) for p in poses)


def test_pb_moves_come_from_the_mix_alone():
    """A mix that holds a key through one kind of segment translates the
    camera in those segments alone, by the Character's dynamics, and turns
    as the mix without moves does: a traffic that moves is a data file."""
    c = small_cell("headline_1024.fly")
    r = c.config["render"]
    moving = dict(c.traffic, segment_moves={"slow_look": [0, 0, 1]})
    f = flight.Flight(moving, SEEDS[0], (30, 20), 40.0, 64,
                      (r["width"], r["height"], r["display_width"],
                       r["display_height"], r["fov_degrees"]),
                      c.config["loop"]["post"])
    still, _ = yaws(SEEDS[0], 300)
    slow = round(c.traffic["segments_rad_per_frame"]["slow_look"], 6)
    prev = f.next()
    moved = 0
    for k in range(1, 300):
        before = f.yaw
        p = f.next()
        assert np.array_equal(p.forward, still[k].forward)
        step = float(np.linalg.norm(p.pos - prev.pos))
        if round(abs(f.yaw - before), 6) == slow:
            moved += step > 0
        prev = p
    assert moved > 20
    assert not np.array_equal(prev.pos, still[-1].pos)
