"""Port parity: loc_lib_tpu_torch.models.eskf against the JAX package on an
IMU stream from the synthetic trajectory and on the tests/test_eskf_odom.py
workloads (wheel odometry: the stillness gate, the gated static init, the
wheel-speed observation, the odometry and velocity logs), plus the IMU
integrator and the noise seeding from the initializer. Tolerance atol 1e-5
(float32 state, same formulas; the per-sample updates differ by ulps); the
numpy log classes exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import replay as jreplay, synthetic as jsyn
from loc_lib_tpu.models import eskf as jeskf
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.io import convert, replay
from loc_lib_tpu_torch.models import eskf

torch.set_num_threads(2)

ATOL = 1e-5


def _packet(cap=64, n_valid=23):
    traj = jsyn.make_trajectory(num_frames=8, dt=0.1, yaw_rate=0.3)
    st, gy, ac = jsyn.ideal_imu(traj, static_secs=0.0)
    g = np.zeros((cap, 3), np.float32)
    a = np.zeros((cap, 3), np.float32)
    s = np.zeros((cap,), np.float32)
    v = np.zeros((cap,), bool)
    g[:n_valid], a[:n_valid], s[:n_valid], v[:n_valid] = gy[:n_valid], ac[:n_valid], \
        st[:n_valid], True
    s[5] = s[4] + 0.2               # a dt > 5 * imu_dt gap: skipped, time advances
    return g, a, s, v


def _state_pair():
    rng = np.random.default_rng(0)
    js = jeskf.init_state(bg=rng.normal(size=3) * 1e-3, ba=rng.normal(size=3) * 1e-2,
                          gravity=[0.0, 0.0, -9.81], time=-0.01)
    js = js._replace(v=jnp.asarray([1.9, 0.1, 0.0], jnp.float32))
    return js, convert.eskf_state_from_numpy(jax.tree_util.tree_map(np.asarray, js)._asdict(), "cpu")


def _assert_state_close(ts, js, atol=ATOL):
    for name in eskf.EskfState._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=atol, err_msg=name)


def test_predict_scan_matches_jax():
    js, ts = _state_pair()
    g, a, s, v = _packet()
    jout = jeskf.predict_scan(js, jnp.asarray(g), jnp.asarray(a), jnp.asarray(s),
                              jnp.asarray(v), jeskf.EskfOptions())
    tout = eskf.predict_scan(ts, g, a, s, v, eskf.EskfOptions())
    _assert_state_close(tout, jout)
    # an all-invalid packet leaves the state's bits as they were (the host
    # never reads `valid`, so the state comes back as new tensors)
    same = eskf.predict_scan(ts, g, a, s, np.zeros_like(v), eskf.EskfOptions())
    for name in eskf.EskfState._fields:
        assert torch.equal(getattr(same, name), getattr(ts, name)), name


def _gate_case(case):
    """A 64-sample packet with one kind of skipped or masked sample."""
    g, a, s, v = _packet()
    s[5] = s[4]                          # no gap at 5: `_packet`'s gap is the "gap" case
    if case == "gap":                    # dt > 5 imu_dt: skipped, time advances
        s[9] = s[8] + 0.2
        s[10:23] += 0.2
    elif case == "backwards":            # dt < 0: skipped, time advances (backwards)
        s[7] = s[6] - 0.03
    elif case == "all_invalid":
        v[:] = False
    elif case == "holes":                # invalid samples between valid ones
        v[[3, 4, 11]] = False
    return g, a, s, v


@pytest.mark.parametrize("case", ["padding", "gap", "backwards", "all_invalid", "holes",
                                  "valid_tensor"])
def test_predict_scan_gate_cases_match_jax(case):
    """predict_scan against JAX's on packets with padding, a dt > 5 imu_dt
    gap, a dt < 0 step, no valid sample, invalid samples between valid ones,
    and `valid` handed over as a tensor (the packet on the state's device):
    every field within atol 1e-5, time exactly."""
    js, ts = _state_pair()
    g, a, s, v = _gate_case("padding" if case == "valid_tensor" else case)
    jout = jeskf.predict_scan(js, jnp.asarray(g), jnp.asarray(a), jnp.asarray(s),
                              jnp.asarray(v), jeskf.EskfOptions())
    if case == "valid_tensor":
        g, a, s, v = (torch.from_numpy(x) for x in (g, a, s, v))
    tout = eskf.predict_scan(ts, g, a, s, v, eskf.EskfOptions())
    _assert_state_close(tout, jout)
    assert float(tout.time) == float(jout.time)
    for name in ("bg", "ba", "g"):
        assert getattr(tout, name) is getattr(ts, name), name


def test_predict_scan_kernel_cpu_path_is_the_plain_version():
    """On CPU tensors kernels.eskf_predict_scan takes its plain version:
    the same bits as eskf_predict_scan_plain and as eskf.predict_scan, and
    the plain version over a packet is eskf.predict over its valid samples;
    the launch counter has the kernel's key and a CPU call leaves it."""
    from loc_lib_tpu_torch.ops import kernels

    _, ts = _state_pair()
    g, a, s, v = _gate_case("gap")
    v[[3, 40]] = False
    opts = eskf.EskfOptions()
    Q = eskf.process_noise(opts, "cpu")
    before = dict(kernels.LAUNCHES)
    assert "eskf_predict_scan" in before
    got = kernels.eskf_predict_scan(*ts, g, a, s, v, Q, opts.imu_dt)
    plain = kernels.eskf_predict_scan_plain(*ts, g, a, s, v, Q, opts.imu_dt)
    scan = eskf.predict_scan(ts, g, a, s, v, opts)
    loop = ts
    for k in np.flatnonzero(v):
        loop = eskf.predict(loop, torch.from_numpy(g[k]), torch.from_numpy(a[k]),
                            torch.tensor(s[k]), opts)
    assert kernels.LAUNCHES == before
    predicted = ("p", "v", "R", "cov", "time")
    assert len(got) == len(plain) == len(predicted)
    for name, x, y in zip(predicted, got, plain):
        assert torch.equal(x, y), name
        for other in (scan, loop):
            assert torch.equal(x, getattr(other, name)), name
    for name in ("bg", "ba", "g"):
        assert getattr(scan, name) is getattr(ts, name), name
    # the packet the kernel reads: one row a sample, [gyro | acce | stamp | valid]
    packet = kernels.imu_packet(g, a, s, v, torch.device("cpu"))
    assert packet.shape == (64, kernels.ESKF_PACKET_WORDS) and packet.dtype == torch.float32
    np.testing.assert_array_equal(packet.numpy(), np.concatenate(
        [g, a, s[:, None], v[:, None].astype(np.float32)], axis=1))
    same = kernels.imu_packet(*(torch.from_numpy(x) for x in (g, a, s, v)), torch.device("cpu"))
    assert torch.equal(same, packet)


@pytest.mark.parametrize("seed", range(2))
def test_observe_se3_matches_jax(seed):
    js, ts = _state_pair()
    g, a, s, v = _packet()
    js = jeskf.predict_scan(js, jnp.asarray(g), jnp.asarray(a), jnp.asarray(s),
                            jnp.asarray(v), jeskf.EskfOptions())
    ts = convert.eskf_state_from_numpy(jax.tree_util.tree_map(np.asarray, js)._asdict(), "cpu")
    rng = np.random.default_rng(seed)
    R_obs = np.array(js.R) @ np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.01,
                                                                   jnp.float32)))
    t_obs = (np.asarray(js.p) + rng.normal(size=3) * 0.05).astype(np.float32)
    jout = jeskf.observe_se3(js, jnp.asarray(R_obs), jnp.asarray(t_obs), jeskf.EskfOptions())
    tout = eskf.observe_se3(ts, torch.from_numpy(R_obs.astype(np.float32)),
                            torch.from_numpy(t_obs), eskf.EskfOptions())
    _assert_state_close(tout, jout)


@pytest.mark.parametrize("kind", ["se3", "wheel"])
@pytest.mark.parametrize("update_bg,update_ba", [(True, True), (False, False), (True, False),
                                                 (False, True)])
def test_eskf_update_plain_matches_jax(kind, update_bg, update_ba):
    """kernels.eskf_update on CPU tensors (its plain version: the
    observation build and the Kalman update as torch ops) against JAX's
    observe_se3 / observe_wheel_speed with the bias flags on and off, on a
    propagated state with a full covariance: the state within atol 1e-5;
    with a flag off that bias keeps its bits."""
    from loc_lib_tpu_torch.ops import kernels

    js, _ = _state_pair()
    g, a, s, v = _packet()
    js = jeskf.predict_scan(js, jnp.asarray(g), jnp.asarray(a), jnp.asarray(s),
                            jnp.asarray(v), jeskf.EskfOptions())
    ts = convert.eskf_state_from_numpy(jax.tree_util.tree_map(np.asarray, js)._asdict(), "cpu")
    jopts = jeskf.EskfOptions(update_bias_gyro=update_bg, update_bias_acce=update_ba)
    opts = eskf.EskfOptions(update_bias_gyro=update_bg, update_bias_acce=update_ba)
    rng = np.random.default_rng(3)
    if kind == "se3":
        R_obs = (np.asarray(js.R) @ np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(size=3) * 0.02, jnp.float32)))).astype(np.float32)
        t_obs = (np.asarray(js.p) + rng.normal(size=3) * 0.05).astype(np.float32)
        jout = jeskf.observe_se3(js, jnp.asarray(R_obs), jnp.asarray(t_obs), jopts)
        obs, noise = (torch.from_numpy(R_obs), torch.from_numpy(t_obs)), (0.1, np.pi / 180.0)
    else:
        left, right = np.float32(30.0), np.float32(34.0)
        jout = jeskf.observe_wheel_speed(js, left, right, jopts)
        wheel = opts.wheel_radius * 2.0 * np.pi / opts.circle_pulse / opts.odom_span
        obs, noise = (left, torch.tensor(right), wheel), (opts.odom_var,)
    got = kernels.eskf_update(*ts[:7], kind, obs, noise, update_bg, update_ba)
    _assert_state_close(ts._replace(**dict(zip(eskf._UPDATED, got))), jout)
    for flag, name, k in ((update_bg, "bg", 3), (update_ba, "ba", 4)):
        if not flag:
            assert torch.equal(got[k], getattr(ts, name)), name
    assert not torch.equal(got[6], ts.cov)


@pytest.mark.parametrize("gated", [False, True])
def test_static_imu_init_matches_jax(gated):
    rng = np.random.default_rng(0)
    n = 200
    acce = (np.tile([0.0, 0.0, 9.81], (n, 1)) + rng.normal(0, 1e-2, (n, 3))).astype(np.float32)
    gyro = rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    gyro[: n // 2] += rng.normal(0, 2.0, (n // 2, 3)).astype(np.float32)
    valid = np.ones((n,), bool)
    is_static = np.ones((n,), bool)
    is_static[: n // 2] = False
    kw_j = dict(is_static=jnp.asarray(is_static)) if gated else {}
    kw_t = dict(is_static=torch.from_numpy(is_static)) if gated else {}
    jr = jeskf.static_imu_init(jnp.asarray(gyro), jnp.asarray(acce), jnp.asarray(valid), **kw_j)
    tr = eskf.static_imu_init(torch.from_numpy(gyro), torch.from_numpy(acce),
                              torch.from_numpy(valid), **kw_t)
    assert bool(tr.success) == bool(jr.success) == gated
    for name in ("bg", "ba", "gravity", "cov_gyro", "cov_acce"):
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                   atol=ATOL, rtol=1e-5, err_msg=name)


def test_process_noise_is_built_once_per_options_and_device():
    """Q depends only on (opts, device): predict_scan asks for it on every
    scan and must get the one tensor built at the first call (on the card the
    element fills that build it are a host round trip each), with the bits a
    fresh build has; other options, another Q."""
    opts = eskf.EskfOptions()
    dev = torch.device("cpu")
    Q = eskf.process_noise(opts, dev)
    assert eskf.process_noise(opts, device="cpu") is Q
    assert eskf.process_noise(eskf.EskfOptions(), dev) is Q
    fresh = torch.diag(torch.tensor([0.0] * 3 + [opts.acce_var] * 3 + [opts.gyro_var] * 3
                                    + [opts.bias_gyro_var] * 3 + [opts.bias_acce_var] * 3
                                    + [0.0] * 3))
    assert torch.equal(Q, fresh)
    other = eskf.process_noise(eskf.EskfOptions(gyro_var=2e-5), dev)
    assert other is not Q and float(other[6, 6]) == np.float32(2e-5)
    # a scan's propagation reads Q and leaves it as it was; two scans give the same bits
    _, ts = _state_pair()
    g, a, s, v = _packet()
    builds = eskf._diag_on.cache_info().misses
    one = eskf.predict_scan(ts, g, a, s, v, opts)
    two = eskf.predict_scan(ts, g, a, s, v, opts)
    assert eskf._diag_on.cache_info().misses == builds
    assert torch.equal(Q, fresh)
    for name in eskf.EskfState._fields:
        assert torch.equal(getattr(one, name), getattr(two, name)), name


def test_odom_is_static_matches_jax():
    """test_eskf_odom.py:12: both wheels under static_odom_pulse (5)."""
    opts, jopts = eskf.ImuInitOptions(), jeskf.ImuInitOptions()
    assert (opts.static_odom_pulse, opts.init_imu_queue_max_size) == \
        (jopts.static_odom_pulse, jopts.init_imu_queue_max_size) == (5, 400)
    left = np.array([4.0, 6.0, 4.0, 5.0, 0.0], np.float32)
    right = np.array([4.0, 4.0, 6.0, 4.9, 0.0], np.float32)
    want = np.asarray(jeskf.odom_is_static(jnp.asarray(left), jnp.asarray(right), jopts))
    got = eskf.odom_is_static(torch.from_numpy(left), torch.from_numpy(right), opts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [True, False, False, False, True])
    assert eskf.odom_is_static(4.0, 4.0) and not eskf.odom_is_static(6.0, 4.0)


def test_static_init_clears_everything_before_a_movement_blip_like_jax():
    """test_eskf_odom.py:41: a movement blip inside the static tail leaves
    only the samples after it (19 here): success, from the tail alone."""
    rng = np.random.default_rng(0)
    n = 200
    acce = np.tile([0.0, 0.0, 9.81], (n, 1)).astype(np.float32)
    gyro = rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    gyro[: n // 2] += rng.normal(0, 2.0, (n // 2, 3)).astype(np.float32)
    is_static = np.ones((n,), bool)
    is_static[: n // 2] = False
    is_static[n - 20] = False
    valid = np.ones((n,), bool)
    jr = jeskf.static_imu_init(jnp.asarray(gyro), jnp.asarray(acce), jnp.asarray(valid),
                               is_static=jnp.asarray(is_static))
    tr = eskf.static_imu_init(torch.from_numpy(gyro), torch.from_numpy(acce),
                              torch.from_numpy(valid), is_static=torch.from_numpy(is_static))
    assert bool(tr.success) and bool(jr.success)
    for name in ("bg", "ba", "gravity", "cov_gyro", "cov_acce"):
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                   atol=ATOL, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(tr.bg.numpy(), gyro[n - 19:].mean(0), atol=1e-6)


@pytest.mark.parametrize("mps", [0.0, 1.0])
def test_observe_wheel_speed_matches_jax(mps):
    """test_eskf_odom.py:50: the nominal velocity says 2 m/s along +x, the
    wheels say `mps`; the update pulls v towards the wheels, with the same
    state as JAX's within atol 1e-5."""
    opts, jopts = eskf.EskfOptions(), jeskf.EskfOptions()
    pulses = np.float32(mps / (opts.wheel_radius * 2 * np.pi / opts.circle_pulse
                               / opts.odom_span))
    js, _ = _state_pair()
    js = js._replace(v=jnp.array([2.0, 0.0, 0.0], jnp.float32),
                     R=jlie.so3_exp(jnp.array([0.0, 0.0, 0.4], jnp.float32)),
                     cov=jnp.eye(18, dtype=jnp.float32) * 1.0)
    ts = convert.eskf_state_from_numpy(jax.tree_util.tree_map(np.asarray, js)._asdict(), "cpu")
    jout = jeskf.observe_wheel_speed(js, jnp.float32(pulses), jnp.float32(pulses), jopts)
    tout = eskf.observe_wheel_speed(ts, pulses, torch.tensor(pulses), opts)
    _assert_state_close(tout, jout)
    want = np.asarray(js.R) @ np.array([mps, 0.0, 0.0])
    assert np.linalg.norm(tout.v.numpy() - want) < 0.5 * np.linalg.norm(np.asarray(js.v) - want)


def test_odom_and_velocity_logs_match_jax():
    """test_eskf_odom.py:67 and :76 on the port's numpy copies: zero-order
    hold, lerp, lever arm, NED -> ENU; equal to the JAX package's."""
    args = dict(stamps=np.array([0.0, 1.0, 2.0]), left_pulse=np.array([10.0, 20.0, 30.0]),
                right_pulse=np.array([11.0, 21.0, 31.0]))
    times = np.array([-0.5, 0.0, 0.5, 1.0, 1.9, 5.0])
    l, r = replay.OdomLog(**args).sample_at(times)
    np.testing.assert_array_equal(l, [10, 10, 10, 20, 20, 30])
    np.testing.assert_array_equal(r, [11, 11, 11, 21, 21, 31])
    for a, b in zip((l, r), jreplay.OdomLog(**args).sample_at(times)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    vargs = dict(stamps=np.array([0.0, 1.0, 2.5]), linear=rng.normal(size=(3, 3)),
                 angular=rng.normal(size=(3, 3)))
    ours, ref = replay.VelocityLog(**vargs), jreplay.VelocityLog(**vargs)
    T = np.eye(4)
    T[:3, :3] = np.asarray(jlie.so3_exp(jnp.array([0.1, -0.2, 0.3], jnp.float32)))
    T[:3, 3] = [0.0, 1.0, 0.2]
    for t in (-1.0, 0.5, 1.7, 9.0):
        np.testing.assert_array_equal(ours.sync_to(t), ref.sync_to(t))
    for a, b in ((ours.transform_coordinate(T), ref.transform_coordinate(T)),
                 (ours.ned2enu(), ref.ned2enu())):
        np.testing.assert_array_equal(a.linear, b.linear)
        np.testing.assert_array_equal(a.angular, b.angular)
    lever = replay.VelocityLog(stamps=np.array([0.0, 1.0]),
                               linear=np.array([[1.0, 0, 0], [1.0, 0, 0]]),
                               angular=np.array([[0, 0, 1.0], [0, 0, 1.0]]))
    np.testing.assert_allclose(lever.sync_to(0.5), [1, 0, 0, 0, 0, 1], atol=1e-7)
    T = np.eye(4)
    T[:3, 3] = [0, 1, 0]
    np.testing.assert_allclose(lever.transform_coordinate(T).linear[0], [0, 0, 0], atol=1e-7)
    np.testing.assert_allclose(lever.ned2enu().angular[0], [0, 0, -1], atol=1e-7)


def test_eskf_options_from_init_matches_jax():
    """The initializer's variances seed gyro_var / acce_var (their square
    roots), every other option from `base`."""
    rng = np.random.default_rng(2)
    n = 120
    gyro = rng.normal(0, 3e-3, (n, 3)).astype(np.float32)
    acce = (np.tile([0.1, -0.2, 9.8], (n, 1)) + rng.normal(0, 2e-2, (n, 3))).astype(np.float32)
    valid = np.ones((n,), bool)
    jr = jeskf.static_imu_init(jnp.asarray(gyro), jnp.asarray(acce), jnp.asarray(valid))
    tr = eskf.static_imu_init(torch.from_numpy(gyro), torch.from_numpy(acce),
                              torch.from_numpy(valid))
    base, jbase = eskf.EskfOptions(imu_dt=0.005), jeskf.EskfOptions(imu_dt=0.005)
    ours, ref = eskf.eskf_options_from_init(tr, base), jeskf.eskf_options_from_init(jr, jbase)
    np.testing.assert_allclose([ours.gyro_var, ours.acce_var], [ref.gyro_var, ref.acce_var],
                               rtol=1e-5)
    assert ours.imu_dt == 0.005 and ours.odom_var == ref.odom_var
    assert ours.gyro_var == float(np.sqrt(tr.cov_gyro[0].numpy()))


def test_imu_integrate_matches_jax():
    """Dead reckoning through the synthetic trajectory's ideal IMU stream
    (a negative dt clamps to 0): the port's state within atol 1e-5 of JAX's
    after every sample."""
    traj = jsyn.make_trajectory(num_frames=6, dt=0.1, yaw_rate=0.3)
    st, gy, ac = jsyn.ideal_imu(traj, static_secs=0.0)
    bg, ba = np.float32([1e-3, -2e-3, 5e-4]), np.float32([0.01, 0.0, -0.02])
    grav = np.float32([0.0, 0.0, -9.81])
    z = np.zeros(3, np.float32)
    js = jeskf.ImuIntegState(p=jnp.asarray(z), v=jnp.asarray([2.0, 0.0, 0.0], jnp.float32),
                             R=jnp.eye(3, dtype=jnp.float32), time=jnp.float32(st[0]))
    ts = eskf.ImuIntegState(p=torch.zeros(3), v=torch.tensor([2.0, 0.0, 0.0]), R=torch.eye(3),
                            time=torch.tensor(np.float32(st[0])))
    stamps = st.astype(np.float32).copy()
    stamps[7] = stamps[6] - 0.01                      # out of order: dt clamps to 0
    for k in range(1, 40):
        js = jeskf.imu_integrate(js, jnp.asarray(gy[k]), jnp.asarray(ac[k]),
                                 jnp.float32(stamps[k]), bg, ba, grav)
        ts = eskf.imu_integrate(ts, gy[k], ac[k], stamps[k], bg, ba, grav)
        for name in eskf.ImuIntegState._fields:
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       atol=ATOL, err_msg=f"{name} at sample {k}")


# ---------------------------------------------------------------------------
# The two sum orders of csrc/eskf_predict.cu, emulated in float32
# ---------------------------------------------------------------------------
#
# The redesigned kernels (a lane a column, F's and (I - K H)'s nonzeros in
# index order, the column-parallel Gauss-Jordan, a finiteness vote that takes
# the dense sums) and the earlier ones (one thread an entry, the dense
# 18-term sums in index order, thread 0's serial inverse) are emulated with
# numpy float32 ops, each product and sum rounded on its own as under
# nvcc -fmad=false. Both share the nominal chain and the innovation (torch's
# lie.so3_exp / so3_log), so what the tests below hold equal is the sum order.

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


F32 = np.float32


def _dense_product(A, B):
    """A @ B, each entry summed over the 18 terms in index order."""
    s = A[:, 0:1] * B[0:1, :]
    for m in range(1, A.shape[1]):
        s = s + A[:, m:m + 1] * B[m:m + 1, :]
    return s


def _nominal_steps(state, packet, imu_dt):
    """The nominal chain of `predict_scan` (torch float32 ops, the plain
    version's formulas), shared by both emulations: the F of every updating
    sample in order, then (p, v, R, time)."""
    from loc_lib_tpu_torch.utils import lie

    p, v, R, bg, ba, g = (x.clone() for x in state[:6])
    time, max_dt = F32(state[7]), F32(5.0 * imu_dt)
    gyros, acces, stamps, valid = (np.asarray(x) for x in packet)
    eye = torch.eye(3)
    Fs = []
    for k in range(len(stamps)):
        if not valid[k]:
            continue
        dt = F32(F32(stamps[k]) - time)
        time = F32(stamps[k])
        if not (dt <= max_dt and dt >= 0):
            continue
        gyro, acce, d = torch.from_numpy(gyros[k]), torch.from_numpy(acces[k]), torch.tensor(dt)
        acc_w = R @ (acce - ba)
        p = p + v * d + 0.5 * acc_w * d * d + 0.5 * g * d * d
        v = v + acc_w * d + g * d
        R = R @ lie.so3_exp((gyro - bg) * d)
        F = torch.eye(18)
        F[0:3, 3:6] = eye * d
        F[3:6, 6:9] = -R @ lie.hat(acce - ba) * d
        F[3:6, 12:15] = -R * d
        F[3:6, 15:18] = eye * d
        F[6:9, 6:9] = lie.so3_exp(-(gyro - bg) * d)
        F[6:9, 9:12] = -eye * d
        Fs.append(F.numpy())
    return Fs, (p, v, R, torch.tensor(time))


def _cov_dense(cov, F, Q):
    """The earlier kernel: T = F cov and cov' = T F^T + Q, every entry over
    its 18 terms in index order."""
    return _dense_product(_dense_product(F, cov), F.T) + Q


def _cov_columns(cov, F, Q, dense):
    """The redesign: lane j's column of T = F cov and of cov' = T F^T + Q
    over F's structural nonzeros only, in index order, as the kernel writes
    them out; where the result holds a non-finite value (a NaN or Inf of cov
    or T always reaches it), the dense sums from cov, for this sample and
    every later one. Returns (cov', dense)."""
    if not dense:
        d, nd, c = F[0, 3], F[6, 9], cov
        T = np.empty_like(cov)
        for r in range(3):
            T[r] = c[r] + d * c[r + 3]
            s = c[3 + r] + F[3 + r, 6] * c[6]
            for m in (7, 8, 12, 13, 14):
                s = s + F[3 + r, m] * c[m]
            T[3 + r] = s + d * c[15 + r]
            s = F[6 + r, 6] * c[6] + F[6 + r, 7] * c[7]
            s = s + F[6 + r, 8] * c[8]
            T[6 + r] = s + nd * c[9 + r]
        T[9:] = c[9:]
        out = np.empty_like(cov)
        for j in range(18):
            if j < 3:
                terms = ((j, F32(1)), (j + 3, d))
            elif j < 6:
                terms = ((j, F32(1)),) + tuple((m, F[j, m]) for m in (6, 7, 8, 12, 13, 14)) \
                    + ((j + 12, d),)
            elif j < 9:
                terms = tuple((m, F[j, m]) for m in (6, 7, 8)) + ((j + 3, nd),)
            else:
                terms = ((j, F32(1)),)
            s = T[:, terms[0][0]] * terms[0][1]
            for m, w in terms[1:]:
                s = s + T[:, m] * w
            out[:, j] = s + Q[:, j]
        if np.isfinite(out).all():
            return out, False
    return _cov_dense(cov, F, Q), True


def _predict_emulated(state, packet, Q, imu_dt, order):
    """(p, v, R, cov, time) of `predict_scan` with the covariance summed in
    `order` ("dense" or "columns")."""
    Fs, (p, v, R, time) = _nominal_steps(state, packet, imu_dt)
    cov, Qn, dense = state[6].numpy().copy(), Q.numpy(), False
    with np.errstate(all="ignore"):        # NaN and Inf cases
        for F in Fs:
            if order == "dense":
                cov = _cov_dense(cov, F, Qn)
            else:
                cov, dense = _cov_columns(cov, F, Qn, dense)
    return p, v, R, torch.from_numpy(cov), time


def _invert_serial(S):
    """The earlier kernel's `invert<M>`: Gauss-Jordan on thread 0, the first
    row of largest |s_ik| as pivot, rows swapped, row k divided, the others
    eliminated."""
    M = S.shape[0]
    A, X = S.copy(), np.eye(M, dtype=F32)
    for k in range(M):
        p, best = k, abs(A[k, k])
        for i in range(k + 1, M):
            if abs(A[i, k]) > best:
                best, p = abs(A[i, k]), i
        A[[k, p]], X[[k, p]] = A[[p, k]], X[[p, k]]
        piv = A[k, k]
        A[k], X[k] = A[k] / piv, X[k] / piv
        for i in range(M):
            if i != k:
                f = A[i, k]
                A[i], X[i] = A[i] - f * A[k], X[i] - f * X[k]
    return X


def _invert_columns(S):
    """The redesign: the 2M columns of [S | I], a lane each; at step k every
    column takes a copy of column k, finds the pivot in it, exchanges rows k
    and p, divides its row k by the pivot and eliminates with the copy."""
    M = S.shape[0]
    cols = [S[:, c].copy() for c in range(M)] + [np.eye(M, dtype=F32)[:, c] for c in range(M)]
    for k in range(M):
        ck = cols[k].copy()
        p, best = k, abs(ck[k])
        for i in range(k + 1, M):
            if abs(ck[i]) > best:
                best, p = abs(ck[i]), i
        ck[[k, p]] = ck[[p, k]]
        piv = ck[k]
        for col in cols:
            col[[k, p]] = col[[p, k]]
            col[k] = col[k] / piv
            for i in range(M):
                if i != k:
                    col[i] = col[i] - ck[i] * col[k]
    return np.stack(cols[M:], axis=1)


def _update_emulated(state, kind, obs, noise, flags, order):
    """(p, v, R, bg, ba, g, cov) of `eskf_update` with P H^T, S, the inverse,
    (I - K H) P and J cov J^T in `order` ("dense": the 18-term sums in index
    order and the serial inverse, which are the earlier kernel's values on
    finite inputs; "columns": the redesign); the observation build, the
    injection and R's update shared (`kernels.eskf_observation_plain`,
    torch's so3_exp and so3_renormalize)."""
    with np.errstate(all="ignore"):        # NaN and Inf cases
        return _update_sums(state, kind, obs, noise, flags, order)


def _update_sums(state, kind, obs, noise, flags, order):
    from loc_lib_tpu_torch.ops import kernels
    from loc_lib_tpu_torch.utils import lie

    p, v, R, bg, ba, g, cov = state
    sel = (0, 1, 2, 6, 7, 8) if kind == "se3" else (3, 4, 5)
    M = len(sel)
    H, V, innov = kernels.eskf_observation_plain(p, v, R, kind, obs, noise)
    H, V, innov, P = H.numpy(), V.numpy(), innov.numpy(), cov.numpy()
    if order == "dense" or not np.isfinite(P).all():
        PHt = _dense_product(P, H.T)                 # H's zeros carry a NaN of P
        S = _dense_product(H, PHt) + V
    else:
        PHt = P[:, sel]                              # selections
        S = P[np.ix_(sel, sel)] + V
    Si = (_invert_serial if order == "dense" else _invert_columns)(S)
    K = PHt[:, 0:1] * Si[0][None, :]
    for r in range(1, M):
        K = K + PHt[:, r:r + 1] * Si[r][None, :]
    dx = K[:, 0] * innov[0]
    for c in range(1, M):
        dx = dx + K[:, c] * innov[c]
    A = np.eye(18, dtype=F32)
    for r, k in enumerate(sel):
        A[:, k] = A[:, k] - K[:, r]
    if order == "dense" or not np.isfinite(P).all():
        C = _dense_product(A, P)
    else:
        C = np.empty_like(P)
        for i in range(18):
            nz = sorted(set(sel) | {i})
            s = A[i, nz[0]] * P[nz[0]]
            for k in nz[1:]:
                s = s + A[i, k] * P[k]
            C[i] = s
    d = dx[6:9]
    J = np.eye(18, dtype=F32)
    for r in range(3):
        for c in range(3):
            h = F32(0) if r == c else (-d[3 - r - c] if (c - r + 3) % 3 == 1 else d[3 - r - c])
            J[6 + r, 6 + c] = J[6 + r, 6 + c] - F32(0.5) * h
    if order == "columns":
        T = C.copy()
        T[6:9] = (J[6:9, 6:7] * C[6] + J[6:9, 7:8] * C[7]) + J[6:9, 8:9] * C[8]
        out = T.copy()
        out[:, 6:9] = (T[:, 6:7] * J[6:9, 6] + T[:, 7:8] * J[6:9, 7]) + T[:, 8:9] * J[6:9, 8]
    if order == "dense" or not np.isfinite(out).all():    # a NaN or Inf of C or T reaches it
        out = _dense_product(_dense_product(J, C), J.T)
    dxt = torch.from_numpy(dx)
    return (p + dxt[0:3], v + dxt[3:6], lie.so3_renormalize(R @ lie.so3_exp(dxt[6:9])),
            bg + dxt[9:12] * (1.0 if flags[0] else 0.0),
            ba + dxt[12:15] * (1.0 if flags[1] else 0.0), g + dxt[15:18],
            torch.from_numpy(out))


def _same_values(a, b) -> bool:
    """Equal float32 values, a zero's sign aside; NaN where the other has NaN."""
    return all(np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
               for x, y in zip(a, b))


_EMU_LOG = {}


def _emulation_log():
    """The demo log's IMU stream (chip_smoke's trajectory: 40 frames, 2 m/s,
    no yaw; a small world, whose scans nothing here reads), the state after
    the static IMU init, the measure groups and Q."""
    if not _EMU_LOG:
        from loc_lib_tpu_torch.io import logdir
        from loc_lib_tpu_torch.pipeline import lio

        log = logdir.make_demo_log(num_frames=40, capacity=64, yaw_rate=0.0, speed=2.0,
                                   world_points=2000)
        init = lio.ImuStaticInit(device="cpu")
        state = None
        for t, g, a in zip(log.imu.stamps, log.imu.gyro, log.imu.acce):
            state = init.add(g, a, t)
            if state is not None:
                break
        _EMU_LOG.update(log=log, state=state, mgs=list(log.measures(imu_capacity=64)),
                        Q=eskf.process_noise(eskf.EskfOptions(), "cpu"))
    return _EMU_LOG


def _emulation_cases(case):
    """(label, state, packet) triples of one test case: the demo log's 40
    packets (the dense emulation's state carried, observed at the true pose
    after each), or one of chip_smoke's gate packets, or a random state, or
    a covariance with a NaN at [17, 17] / an Inf at [4, 4]."""
    cs, e = _chip_smoke(), _emulation_log()
    log, state, mgs, Q = e["log"], e["state"], e["mgs"], e["Q"]
    imu_dt = eskf.EskfOptions().imu_dt
    mid = (state, (mgs[20].imu_gyro, mgs[20].imu_acce, mgs[20].imu_stamp, mgs[20].imu_valid))
    if case == "demo":
        out, s = [], state
        for i, mg in enumerate(mgs):
            packet = (mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
            out.append((f"demo packet {i}", s, packet))
            s = s._replace(**dict(zip(cs.ESKF_OUT, _predict_emulated(s, packet, Q, imu_dt,
                                                                     "dense"))))
            T = torch.from_numpy(log.gt_poses[mg.scan_index])
            s = eskf.observe_se3(s, T[:3, :3], T[:3, 3], eskf.EskfOptions())
        return out
    if case.startswith("random"):
        rng = np.random.default_rng(int(case[-1]))
        return [(f"random state {k}", eskf.EskfState(*cs._random_eskf_state(rng, "cpu"),
                                                      state.time), mid[1]) for k in range(6)]
    if case in ("nan", "inf"):
        bad = state._replace(cov=state.cov.clone())
        bad.cov[(17, 17) if case == "nan" else (4, 4)] = float(case)
        return [(f"cov with {case}", bad, mid[1])]
    gates = cs._eskf_gate_packets(log, float(mgs[20].imu_stamp[0]) - 0.01)
    s = state._replace(time=torch.tensor(np.float32(mgs[20].imu_stamp[0]) - np.float32(0.01)))
    return [(case, s, gates[case])]


@pytest.mark.parametrize("case", ["demo", "padding", "dt > 5 imu_dt", "dt < 0", "holes",
                                  "all invalid", "random0", "random1", "nan", "inf"])
def test_eskf_predict_column_order_equals_dense_order(case):
    """eskf_predict_scan's covariance a lane a column over F's nonzeros
    gives the same float32 values as the dense 18-term sums of the earlier
    kernel (a zero's sign aside), on the demo log's packets, every gate case,
    random states, and a covariance holding a NaN or an Inf (the same
    non-finite entries: the vote takes the dense sums); on finite inputs
    each order stays within chip_smoke's bound of the float64 plain version."""
    from loc_lib_tpu_torch.ops import kernels

    cs, Q = _chip_smoke(), _emulation_log()["Q"]
    imu_dt = eskf.EskfOptions().imu_dt
    for label, s, packet in _emulation_cases(case):
        dense = _predict_emulated(s, packet, Q, imu_dt, "dense")
        cols = _predict_emulated(s, packet, Q, imu_dt, "columns")
        assert _same_values(dense, cols), label
        p32 = kernels.eskf_predict_scan_plain(*s, *packet, Q, imu_dt)
        if case in ("nan", "inf"):
            assert not np.isfinite(cols[3].numpy()).all(), label
            cs._nonfinite_pattern_equal(label, cols, p32)
            continue
        p64 = kernels.eskf_predict_scan_plain(*(x.double() for x in s), *packet, Q.double(),
                                              imu_dt)
        for got in (dense, cols):
            cs._eskf_close(label, got, p32, p64)


def _update_cases(source):
    cs, e = _chip_smoke(), _emulation_log()
    rng = np.random.default_rng(11)
    if source == "demo":
        s, out = e["state"], []
        for i, mg in enumerate(e["mgs"][:20]):
            s = eskf.predict_scan(s, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid,
                                  eskf.EskfOptions())
            if i % 4 == 3:
                out.append((f"demo state {i}", s[:7]))
        return out, rng
    states = [(f"random state {k}", cs._random_eskf_state(rng, "cpu")) for k in range(4)]
    if source in ("nan", "inf"):
        bad = states[0][1][:6] + (states[0][1][6].clone(),)
        bad[6][(17, 17) if source == "nan" else (4, 4)] = float(source)
        return [(f"cov with {source}", bad)], rng
    return states, rng


@pytest.mark.parametrize("source", ["demo", "random", "nan", "inf"])
@pytest.mark.parametrize("flags", [(True, True), (False, False), (True, False), (False, True)])
def test_eskf_update_column_order_equals_dense_order(source, flags):
    """eskf_update with the column-parallel Gauss-Jordan, (I - K H) P over
    its rows' nonzeros and J cov J^T over rows and columns 6-8 gives the same
    float32 values as the serial inverse and dense 18-term sums of the
    earlier kernel, for a pose and a wheel speed, every bias-flag pair, on
    the demo log's states, random states, and a covariance holding a NaN or
    an Inf (the same non-finite entries); on finite inputs each order stays
    within chip_smoke's bound of the float64 plain version."""
    from loc_lib_tpu_torch.ops import kernels

    cs = _chip_smoke()
    states, rng = _update_cases(source)
    for label, state in states:
        for kind, (obs, noise) in cs._eskf_observations(rng, state, "cpu", ang=0.05).items():
            dense = _update_emulated(state, kind, obs, noise, flags, "dense")
            cols = _update_emulated(state, kind, obs, noise, flags, "columns")
            assert _same_values(dense, cols), (label, kind)
            if source in ("nan", "inf"):
                assert not np.isfinite(cols[6].numpy()).all(), (label, kind)
                cs._nonfinite_pattern_equal(f"{label} {kind}", cols, kernels.eskf_update_plain(
                    *state, kind, obs, noise, *flags))
                continue
            for got in (dense, cols):
                cs._eskf_update_close(f"{label} {kind}", got, state, kind, obs, noise, flags)
