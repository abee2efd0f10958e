"""The generator: one seed gives the same bits, the lap closes, and every
scan has its raw points, all within range."""

import numpy as np
import torch
from conftest import tiny

from yardstick import cell as cellmod, world


def _setup(seed):
    from yardstick import replay

    return replay.Setup(tiny(cellmod.load_cell("lio_hdl64.drive")), seed, "cpu")


def test_same_seed_same_bits_other_seed_other_bits():
    a, b, c = _setup(2 ** 31 + 7), _setup(2 ** 31 + 7), _setup(5)
    assert np.array_equal(a.raw, b.raw)
    assert np.array_equal(a.lap_packets.gyro, b.lap_packets.gyro)
    assert np.array_equal(a.static[2], b.static[2])
    assert not np.array_equal(a.raw, c.raw)


def test_the_lap_closes():
    cell = cellmod.load_cell("lio_hdl64.drive")
    r = world.make_route(cell.traffic, cell.config["sensor"])
    T = world.poses_at(r, world.SCAN_DT * (r.ramp + np.arange(r.lap + 1)))
    assert np.allclose(T[-1], T[0], atol=1e-9)
    speed = np.linalg.norm(T[1:, :3, 3] - T[:-1, :3, 3], axis=1) / world.SCAN_DT
    # the speed swings about its mean and the lap leaves at the speed it arrives with
    assert speed.min() < r.speed - 0.9 * r.swing and speed.max() > r.speed + 0.9 * r.swing
    assert speed.max() <= r.speed + r.swing + 1e-9
    tau = world.SCAN_DT * r.ramp + np.array([0.0, r.lap_seconds])
    (_, u0, a0), (_, u1, a1) = (world._arc(r, tau[:1]), world._arc(r, tau[1:]))
    assert np.allclose([u0, a0], [u1, a1])
    assert np.allclose(np.linalg.norm(T[:, :2, 3], axis=1), r.radius)   # centred on the world
    g = world.generator(3, "cpu")
    _, _, lap = world.make_imu(r, cell.config["imu_noise"], 64, g)
    # the replayed lap's stamps run on across the seam: a packet every scan period
    last = world.stamps32(lap.rel[-1, :10])[-1]
    first = world.stamps32(lap.rel[0, :10], r.lap_seconds)[0]
    assert abs((first - last) - world.IMU_DT) < 1e-4


def test_every_scan_has_its_points_within_range():
    s = _setup(11)
    cfg = tiny(cellmod.load_cell("lio_hdl64.drive")).config["sensor"]
    assert s.raw.shape[1] == cfg["raw_points"] and s.mask.all()
    rng = np.linalg.norm(s.raw, axis=2)
    assert rng.max() <= cfg["max_range_m"] + 6 * cfg["noise_m"] * np.sqrt(3)
    assert np.isfinite(s.raw).all()


def test_the_prior_map_puts_the_ground_in_one_layer():
    g = world.generator(1, "cpu")
    pts = world.make_world({"points": 30000, "extent_m": 20.0, "walls": 4, "pillars": 4}, g, "cpu")
    m = world.voxel_filter_map(pts, 0.5)
    ground = m[torch.abs(m[:, 2]) < 0.2]
    assert torch.unique(torch.floor(ground[:, 2] / 0.5 + 0.5)).numel() == 1
