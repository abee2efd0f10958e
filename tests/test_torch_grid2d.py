"""Port parity: loc_lib_tpu_torch.models.grid2d (occupancy carve, likelihood
field, SE(2) field matching) and the 2D generators against the JAX package,
on tests/test_mapping2d.py's small grid (500 x 500 at 10 px/m) and, where
the reference's own test uses it, the default 1000 x 1000 grid.

Stated tolerances:
  * generators: bit for bit;
  * the polar carve and the sampled oracle: endpoint occupancy identical;
    counts may differ only where a cell's angle bin moves with a last-bit
    difference of atan2, at most MAX_EDGE_CELLS cells a scan (measured: 0);
  * the likelihood field: bit for bit on equal counts;
  * the field linearization, GN and LM on a field carried across from JAX:
    within twice JAX's own change under a 1-ulp nudge of the input pose,
    floored at two float32 ulps of the value; counts and flags exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import synthetic as jsyn
from loc_lib_tpu.models import grid2d as jg
from loc_lib_tpu_torch.io import convert, synthetic
from loc_lib_tpu_torch.models import grid2d

torch.set_num_threads(2)

GARGS = dict(image_size=500, resolution=10.0, ray_steps=128, max_beam_range=14.0)
GOPTS, JGOPTS = grid2d.Grid2dOptions(**GARGS), jg.Grid2dOptions(**GARGS)
MAX_EDGE_CELLS = 20


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _bound(ref, nudged):
    """Twice JAX's own change under a 1-ulp input nudge, floored at two
    float32 ulps of the largest value."""
    ref, nudged = np.asarray(ref, np.float32), np.asarray(nudged, np.float32)
    return 2 * max(np.abs(nudged - ref).max(), 2 * np.spacing(np.abs(ref).max()))


def _scan(seed=5, theta=0.3, t=(0.5, -0.4), world_seed=3, extent=15.0):
    world = synthetic.make_world_2d(extent=extent, seed=world_seed)
    return synthetic.render_scan_2d(world, theta, np.array(t), seed=seed)


def _both_grids(opts, jopts, scans):
    """Carve the (points, valid, origin) scans in order with both packages."""
    g, jgr = grid2d.empty_grid(opts, "cpu"), jg.empty_grid(jopts)
    for pts, valid, org in scans:
        g = grid2d.add_scan(g, opts, _t(pts), _t(valid), _t(org))
        jgr = jg.add_scan(jgr, jopts, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(org))
    return g, jgr


def _field_from_jax_scan(opts, jopts, seed=0):
    """A JAX grid and field from one scan, and the port's field of the same
    counts carried across."""
    xy, valid = _scan(seed=seed, theta=0.0, t=(0.0, 0.0), world_seed=2, extent=10.0)
    jgr = jg.add_scan(jg.empty_grid(jopts), jopts, jnp.asarray(xy), jnp.asarray(valid),
                      jnp.zeros(2))
    g = convert.occupancy_grid_from_numpy(
        {"counts": np.asarray(jgr.counts), "touched": np.asarray(jgr.touched)}, "cpu")
    return g, jg.likelihood_field(jgr, jopts), grid2d.likelihood_field(g, opts)


def test_2d_generators_are_bit_identical():
    for seed in (0, 3, 7):
        w, jw = synthetic.make_world_2d(extent=10.0, seed=seed), jsyn.make_world_2d(
            extent=10.0, seed=seed)
        np.testing.assert_array_equal(w, jw)
        for k in range(3):
            a = synthetic.render_scan_2d(w, 0.2 * k, np.array([0.3 * k, -0.1]), seed=k)
            b = jsyn.render_scan_2d(jw, 0.2 * k, np.array([0.3 * k, -0.1]), seed=k)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("full", [False, True], ids=["500px", "1000px"])
def test_polar_carve_and_field_match_jax(full):
    """Three scans carved in turn from three origins: occupancy identical,
    counts equal except on bin edges, the field bit-equal."""
    opts, jopts = ((grid2d.Grid2dOptions(), jg.Grid2dOptions()) if full else (GOPTS, JGOPTS))
    scans = []
    for k, (th, t, org) in enumerate(((0.3, (0.5, -0.4), (0.0, 0.0)),
                                      (1.1, (-2.0, 1.5), (0.37, -0.21)),
                                      (-2.5, (3.0, 2.0), (-1.2, 0.8)))):
        xy, valid = _scan(seed=k, theta=th, t=t)
        scans.append(((xy + np.float32(org)).astype(np.float32), valid,
                      np.array(org, np.float32)))
    g, jgr = _both_grids(opts, jopts, scans)
    c, jc = g.counts.numpy(), np.asarray(jgr.counts)
    np.testing.assert_array_equal(c > opts.unknown, jc > opts.unknown)
    assert (c != jc).sum() <= MAX_EDGE_CELLS * len(scans)
    assert (jc < opts.unknown).sum() > 1000            # the carve freed something
    np.testing.assert_array_equal(g.touched.numpy() != np.asarray(jgr.touched), c != jc)
    np.testing.assert_array_equal(grid2d.likelihood_field(g, opts).numpy(),
                                  np.asarray(jg.likelihood_field(jgr, jopts)))


def test_sampled_oracle_matches_jax():
    xy, valid = _scan()
    org = np.array([0.37, -0.21], np.float32)
    pts = (xy + org).astype(np.float32)
    g = grid2d.add_scan_sampled(grid2d.empty_grid(GOPTS, "cpu"), GOPTS, _t(pts), _t(valid),
                                _t(org))
    jgr = jg.add_scan_sampled(jg.empty_grid(JGOPTS), JGOPTS, jnp.asarray(pts),
                              jnp.asarray(valid), jnp.asarray(org))
    c, jc = g.counts.numpy(), np.asarray(jgr.counts)
    np.testing.assert_array_equal(c > GOPTS.unknown, jc > GOPTS.unknown)
    assert (c != jc).sum() <= MAX_EDGE_CELLS


def test_field_is_bit_equal_on_equal_counts_edges_and_wrap_included():
    """Random occupancy (edges and corners included, where the shifts wrap
    around) carried across: the same field bits, including the wrapped
    distances the reference keeps."""
    rng = np.random.default_rng(0)
    counts = np.full((500, 500), 127, np.int32)
    counts[rng.integers(0, 500, 300), rng.integers(0, 500, 300)] = 130
    counts[0, 0] = counts[499, 250] = counts[250, 0] = counts[3, 497] = 128
    d = {"counts": counts, "touched": counts != 127}
    f = grid2d.likelihood_field(convert.occupancy_grid_from_numpy(d, "cpu"), GOPTS)
    jf = jg.likelihood_field(jg.OccupancyGrid(jnp.asarray(counts), jnp.asarray(d["touched"])),
                             JGOPTS)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert f[499, 0].item() == 1.0      # (0, 0) wraps in one row away


def test_occupancy_and_field():
    """test_mapping2d.py:17 on the port: endpoints raise counts, traversed
    cells lower them, the field is 0 on occupied cells and grows with
    distance."""
    g = grid2d.add_scan(grid2d.empty_grid(GOPTS, "cpu"), GOPTS, _t([[5.0, 0.0], [0.0, 5.0]],
                                                                  np.float32),
                        torch.ones(2, dtype=torch.bool), torch.zeros(2))
    counts = g.counts.numpy()
    c = int(GOPTS.center)
    px = int(round(5.0 * GOPTS.resolution + GOPTS.center))
    assert counts[c, px] > GOPTS.unknown
    assert counts[c, c + 10] < GOPTS.unknown
    field = grid2d.likelihood_field(g, GOPTS).numpy()
    assert field[c, px] == 0.0
    assert field[c, px - 5] == pytest.approx(5.0, abs=0.01)
    assert field[c, c] == GOPTS.field_radius


def test_polar_carve_vs_sampled_oracle():
    """test_mapping2d.py:35 on the port: identical endpoint occupancy and
    fields, no occupied cell freed, freed regions agreeing both ways > 90%."""
    world = synthetic.make_world_2d(seed=3)
    xy, valid = synthetic.render_scan_2d(world, 0.3, np.array([0.5, -0.4]), seed=5)
    g0 = grid2d.empty_grid(GOPTS, "cpu")
    gp = grid2d.add_scan(g0, GOPTS, _t(xy), _t(valid), torch.zeros(2))
    gs = grid2d.add_scan_sampled(g0, GOPTS, _t(xy), _t(valid), torch.zeros(2))
    cp, cs = gp.counts.numpy(), gs.counts.numpy()
    occ_p, occ_s = cp > GOPTS.unknown, cs > GOPTS.unknown
    free_p, free_s = cp < GOPTS.unknown, cs < GOPTS.unknown
    np.testing.assert_array_equal(occ_p, occ_s)
    assert not np.any(occ_p & free_p) and not np.any(occ_s & free_s)
    np.testing.assert_array_equal(grid2d.likelihood_field(gp, GOPTS).numpy(),
                                  grid2d.likelihood_field(gs, GOPTS).numpy())
    inter = np.sum(free_p & free_s)
    assert inter / max(free_s.sum(), 1) > 0.9
    assert inter / max(free_p.sum(), 1) > 0.9


def test_add_scans_and_field_applies_the_first_count_scans():
    """count = 2 of a K = 4 stack equals two add_scan calls and one field,
    bit for bit; the rows past count are ignored."""
    rng = np.random.default_rng(1)
    pts = np.zeros((4, 720, 2), np.float32)
    val = np.zeros((4, 720), bool)
    orgs = rng.normal(0, 0.5, (4, 2)).astype(np.float32)
    for k in range(4):
        xy, v = _scan(seed=k, theta=0.4 * k, t=(0.2 * k, 0.1))
        pts[k], val[k] = xy + orgs[k], v
    g, f = grid2d.add_scans_and_field(grid2d.empty_grid(GOPTS, "cpu"), GOPTS, _t(pts), _t(val),
                                      _t(orgs), 2)
    ref = grid2d.empty_grid(GOPTS, "cpu")
    for k in range(2):
        ref = grid2d.add_scan(ref, GOPTS, _t(pts[k]), _t(val[k]), _t(orgs[k]))
    assert torch.equal(g.counts, ref.counts) and torch.equal(g.touched, ref.touched)
    assert torch.equal(f, grid2d.likelihood_field(ref, GOPTS))
    jgr, jf = jg.add_scans_and_field(jg.empty_grid(JGOPTS), JGOPTS, jnp.asarray(pts),
                                     jnp.asarray(val), jnp.asarray(orgs), jnp.int32(2))
    np.testing.assert_array_equal(g.counts.numpy() > 127, np.asarray(jgr.counts) > 127)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def _offset_scan(theta=0.05, t=(0.3, -0.2), seed=7):
    return _scan(seed=seed, theta=theta, t=t, world_seed=2, extent=10.0)


def test_field_terms_match_jax():
    """H, b, chi2 and the inlier ratio at an offset pose on a carried field,
    within twice JAX's change under a 1-ulp nudge of the pose; n_eff
    exactly."""
    g, jf, f = _field_from_jax_scan(GOPTS, JGOPTS)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    xy, valid = _offset_scan()
    ao = jg.Align2dOptions()
    th, t = np.float32(0.02), np.array([0.1, -0.05], np.float32)
    ref = jg._field_terms(jf, JGOPTS, ao, jnp.asarray(xy), jnp.asarray(valid), jnp.float32(th),
                          jnp.asarray(t))
    nud = jg._field_terms(jf, JGOPTS, ao, jnp.asarray(xy), jnp.asarray(valid),
                          jnp.float32(np.nextafter(th, np.float32(1))),
                          jnp.asarray(np.nextafter(t, np.float32(1))))
    got = grid2d._field_terms(f, GOPTS, grid2d.Align2dOptions(), _t(xy), _t(valid),
                              torch.tensor(th), _t(t))
    for name, a, r, n in zip(("H", "b", "n_eff", "chi2", "inl"), got, ref, nud):
        if name == "n_eff":
            assert int(a) == int(r) > 100
            continue
        assert np.abs(a.numpy() - np.asarray(r)).max() <= _bound(r, n), name


@pytest.mark.parametrize("method", ["gn", "lm"])
def test_align_matches_jax_on_a_carried_field(method):
    """GN and LM from the origin to the 0.05 rad / (0.3, -0.2) m offset:
    the pose within twice JAX's 1-ulp sensitivity, converged and n_eff
    equal (n_eff of the last linearization for GN, of the final pose for
    LM, as in JAX)."""
    _, jf, f = _field_from_jax_scan(GOPTS, JGOPTS)
    xy, valid = _offset_scan()
    ao, jao = (mod.Align2dOptions(method=method, max_iterations=30) for mod in (grid2d, jg))
    args = (jnp.asarray(xy), jnp.asarray(valid))
    ref = jg.align_gauss_newton(jf, JGOPTS, *args, jnp.float32(0.0), jnp.zeros(2), jao)
    nud = jg.align_gauss_newton(jf, JGOPTS, jnp.asarray(np.nextafter(xy, np.float32(99))),
                                args[1], jnp.float32(0.0), jnp.zeros(2), jao)
    got = grid2d.align_gauss_newton(f, GOPTS, _t(xy), _t(valid), 0.0, torch.zeros(2), ao)
    for name in ("theta", "t"):
        r = np.asarray(getattr(ref, name))
        assert np.abs(getattr(got, name).numpy() - r).max() <= _bound(r, getattr(nud, name)), name
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.num_effective) == int(ref.num_effective)
    assert abs(float(got.theta) - 0.05) < 0.02
    np.testing.assert_allclose(got.t.numpy(), [0.3, -0.2], atol=0.08)


def test_align_2d_recovers_offset():
    """test_mapping2d.py:75 on the port."""
    world = synthetic.make_world_2d(seed=1)
    xy, valid = synthetic.render_scan_2d(world, 0.0, np.zeros(2), seed=0)
    g = grid2d.add_scan(grid2d.empty_grid(GOPTS, "cpu"), GOPTS, _t(xy), _t(valid),
                        torch.zeros(2))
    field = grid2d.likelihood_field(g, GOPTS)
    true_th, true_t = 0.05, np.array([0.3, -0.2], np.float32)
    xy2, valid2 = synthetic.render_scan_2d(world, true_th, true_t, seed=7)
    res = grid2d.align_gauss_newton(field, GOPTS, _t(xy2), _t(valid2), 0.0, torch.zeros(2))
    assert abs(float(res.theta) - true_th) < 0.02
    np.testing.assert_allclose(res.t.numpy(), true_t, atol=0.08)
    assert float(res.inlier_ratio) > 0.5


def test_align_lm_recovers_where_gn_loses():
    """test_mapping2d.py:339 on the port, at the default 1000 x 1000 grid:
    both methods recover a nominal offset within 2 cm; on a sparse scan with
    6 gross outliers of 16 beams GN stops > 10 cm off and LM within 5 cm."""
    gopts = grid2d.Grid2dOptions()
    world = synthetic.make_world_2d(extent=10.0, seed=2)
    xy, valid = synthetic.render_scan_2d(world, 0.0, np.zeros(2, np.float32), seed=0)
    g = grid2d.add_scan(grid2d.empty_grid(gopts, "cpu"), gopts, _t(xy), _t(valid),
                        torch.zeros(2))
    field = grid2d.likelihood_field(g, gopts)
    xy2, v2 = synthetic.render_scan_2d(world, 0.05, np.array([0.15, -0.1], np.float32), seed=3)
    for m in ("gn", "lm"):
        r = grid2d.align_gauss_newton(field, gopts, _t(xy2), _t(v2), 0.0, torch.zeros(2),
                                      grid2d.Align2dOptions(method=m, max_iterations=30))
        assert np.linalg.norm(r.t.numpy() - [0.15, -0.1]) < 0.02
    init = np.array([0.25, 0.2], np.float32)
    rng = np.random.default_rng(12)
    xys, vs = synthetic.render_scan_2d(world, 0.0, np.zeros(2, np.float32), seed=7)
    sel = rng.choice(np.where(vs)[0], 16, replace=False)
    pts = xys[sel].copy()
    pts[:6] = rng.uniform(-8, 8, (6, 2))
    obs = (pts - init).astype(np.float32)
    errs = {}
    for m in ("gn", "lm"):
        r = grid2d.align_gauss_newton(field, gopts, _t(obs), torch.ones(16, dtype=torch.bool),
                                      0.0, torch.zeros(2),
                                      grid2d.Align2dOptions(method=m, max_iterations=30,
                                                            min_effective=5))
        errs[m] = float(np.linalg.norm(r.t.numpy() - init))
    assert errs["gn"] > 0.1 and errs["lm"] < 0.05, errs


def test_nan_pose_and_nan_beam_stay_finite_or_masked_like_jax():
    """A NaN beam and a NaN initial pose: the clamped gather never raises,
    and the result has JAX's finiteness pattern (a NaN beam leaves the pose
    where it was and finite; a NaN pose gives no effective beam)."""
    _, jf, f = _field_from_jax_scan(GOPTS, JGOPTS)
    xy, valid = _offset_scan()
    bad = xy.copy()
    bad[3] = np.nan
    cases = [(bad, 0.0, np.zeros(2, np.float32)),
             (xy, np.float32(np.nan), np.zeros(2, np.float32)),
             (xy, 0.0, np.array([np.nan, 0.0], np.float32))]
    for method in ("gn", "lm"):
        ao, jao = (mod.Align2dOptions(method=method) for mod in (grid2d, jg))
        for pts, th0, t0 in cases:
            got = grid2d.align_gauss_newton(f, GOPTS, _t(pts), _t(valid), th0, _t(t0), ao)
            ref = jg.align_gauss_newton(jf, JGOPTS, jnp.asarray(pts), jnp.asarray(valid),
                                        jnp.float32(th0), jnp.asarray(t0), jao)
            for name in ("theta", "t", "chi2", "inlier_ratio"):
                np.testing.assert_array_equal(np.isfinite(getattr(got, name).numpy()),
                                              np.isfinite(np.asarray(getattr(ref, name))),
                                              err_msg=f"{method} {name}")
            assert int(got.num_effective) == int(ref.num_effective)
            assert bool(got.converged) == bool(ref.converged)
            if np.isfinite(th0) and np.all(np.isfinite(t0)):
                assert np.all(np.isfinite(got.t.numpy()))


def test_lm_reports_converged_when_lambda_saturates_like_jax():
    """The reference's quirk, kept: on a field with nothing occupied no
    step is ever accepted, lambda saturates and LM reports converged=True
    (GN reports False); the port reports what JAX reports."""
    empty_f = grid2d.likelihood_field(grid2d.empty_grid(GOPTS, "cpu"), GOPTS)
    jempty = jg.likelihood_field(jg.empty_grid(JGOPTS), JGOPTS)
    xy, valid = _offset_scan()
    for method, want in (("lm", True), ("gn", False)):
        got = grid2d.align_gauss_newton(empty_f, GOPTS, _t(xy), _t(valid), 0.0, torch.zeros(2),
                                        grid2d.Align2dOptions(method=method))
        ref = jg.align_gauss_newton(jempty, JGOPTS, jnp.asarray(xy), jnp.asarray(valid),
                                    jnp.float32(0.0), jnp.zeros(2),
                                    jg.Align2dOptions(method=method))
        assert bool(got.converged) == bool(ref.converged) == want


def test_scan_to_points_and_out_of_bounds_match_jax():
    rng = np.random.default_rng(3)
    ranges = rng.uniform(0, 40, 360).astype(np.float32)
    ranges[[0, 5, 9]] = [np.nan, 0.05, np.inf]
    xy, v = grid2d.scan_to_points(_t(ranges), -np.pi, np.pi / 180)
    jxy, jv = jg.scan_to_points(jnp.asarray(ranges), -np.pi, np.pi / 180)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), atol=2e-5)
    frac = grid2d.out_of_bounds_fraction(GOPTS, xy, v)
    jfrac = jg.out_of_bounds_fraction(JGOPTS, jxy, jv)
    assert float(frac) == float(jfrac) and 0 < float(frac) < 1
    assert dataclasses.asdict(grid2d.Grid2dOptions()) == dataclasses.asdict(jg.Grid2dOptions())
    assert dataclasses.asdict(grid2d.Align2dOptions()) == dataclasses.asdict(jg.Align2dOptions())
