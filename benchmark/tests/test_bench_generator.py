"""The generator: one seed gives the same bits, the lap closes, and every
scan has its raw points, all within range."""

import numpy as np
import pytest
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


def test_without_renders_set_up_draws_what_it_drew_before_the_key():
    # one render of the ramp and the lap in one call, after the world and the IMU: set-up's
    # order before traffic mixes could render the lap more than once
    cell = tiny(cellmod.load_cell("lio_hdl64.drive"))
    assert "renders" not in cell.traffic
    s = _setup(2 ** 31 + 13)
    cfg, g = cell.config, world.generator(2 ** 31 + 13, "cpu")
    pts = world.make_world(cfg["world"], g, "cpu")
    r = world.make_route(cell.traffic, cfg["sensor"])
    static, ramp, lap = world.make_imu(r, cfg["imu_noise"], cfg["engine_options"]["imu_capacity"],
                                       g)
    poses = np.concatenate([world.poses_at(r, world.ramp_times(r)),
                            world.poses_at(r, world.lap_times(r))])
    assert np.array_equal(s.raw, world.render_scans(pts, poses, cfg["sensor"], g).numpy())
    assert np.array_equal(s.true_world, poses)
    for got, want in ((s.ramp_packets, ramp), (s.lap_packets, lap)):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(s.static[0], world.stamps32(static[0]))
    assert all(np.array_equal(a, b) for a, b in zip(s.static[1:], static[1:]))


def test_each_render_draws_the_lap_anew_at_the_same_poses():
    from yardstick import replay

    cell = tiny(cellmod.load_cell("lio_hdl64.drive"))
    short = {**cell.traffic, "radius_m": 12.0, "speed_mps": 6.0, "ramp_s": 2.0}
    one = replay.Setup(cell._replace(traffic=short), 9, "cpu")
    two = replay.Setup(cell._replace(traffic={**short, "renders": 2}), 9, "cpu")
    r = two.route
    assert two.raw.shape[0] == r.ramp + 2 * r.lap
    # the first render is what a single render draws; the second a fresh draw at the same poses
    assert np.array_equal(two.raw[:r.ramp + r.lap], one.raw)
    assert np.array_equal(two.true_world[r.ramp + r.lap:], two.true_world[r.ramp:r.ramp + r.lap])
    for f in (0, 1, r.lap - 1):
        assert not np.array_equal(two.raw[r.ramp + f], two.raw[r.ramp + r.lap + f])
    # pass p replays render p mod 2, with the same IMU packet and stamps a lap on
    src, packets = zip(*[x for _, x in zip(range(r.ramp + 3 * r.lap), two.stream())])
    lap_src = np.array(src[r.ramp:]).reshape(3, r.lap)
    assert np.array_equal(lap_src[0], r.ramp + np.arange(r.lap))
    assert np.array_equal(lap_src[1], r.ramp + r.lap + np.arange(r.lap))
    assert np.array_equal(lap_src[2], lap_src[0])
    stamps = lambda p: p[2][p[3]]
    f = r.ramp + r.lap + 5
    assert np.array_equal(packets[f][0], packets[f - r.lap][0])
    assert np.allclose(stamps(packets[f]) - stamps(packets[f - r.lap]), r.lap_seconds, atol=1e-3)


def test_every_scan_has_its_points_within_range():
    s = _setup(11)
    cfg = tiny(cellmod.load_cell("lio_hdl64.drive")).config["sensor"]
    assert s.raw.shape[1] == cfg["raw_points"] and s.mask.all()
    rng = np.linalg.norm(s.raw, axis=2)
    assert rng.max() <= cfg["max_range_m"] + 6 * cfg["noise_m"] * np.sqrt(3)
    assert np.isfinite(s.raw).all()


@pytest.mark.parametrize("n_walls", [24, 5])
def test_the_walls_run_both_ways_over_the_whole_extent(n_walls):
    e = 80.0
    axis, offset, ends = world.wall_layout(n_walls, e, world.generator(2 ** 31 + 5, "cpu"), "cpu")
    axis, offset, ends = axis[:, 0], offset[:, 0], ends
    assert (axis == 0).sum() - (axis == 1).sum() in (0, 1)
    for a in (0, 1):
        o = torch.sort(offset[axis == a]).values
        band = 2 * e / len(o)
        # one wall to a band of the extent
        assert torch.equal(torch.floor((o + e) / band), torch.arange(len(o), dtype=o.dtype))
    length = ends[:, 1] - ends[:, 0]
    assert bool(((length >= e) & (length <= 2 * e)).all())
    assert bool(((ends >= -e) & (ends <= e)).all())


def test_the_prior_map_puts_the_ground_in_one_layer():
    g = world.generator(1, "cpu")
    pts = world.make_world({"points": 30000, "extent_m": 20.0, "walls": 4, "pillars": 4}, g, "cpu")
    m = world.voxel_filter_map(pts, 0.5)
    ground = m[torch.abs(m[:, 2]) < 0.2]
    assert torch.unique(torch.floor(ground[:, 2] / 0.5 + 0.5)).numel() == 1
