"""Port parity: loc_lib_tpu_torch.models.eskf against the JAX package on an
IMU stream from the synthetic trajectory (tests/test_eskf_odom.py style
workloads). Tolerance atol 1e-5 (float32 state, same formulas; the
per-sample updates differ by ulps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import synthetic as jsyn
from loc_lib_tpu.models import eskf as jeskf
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.io import convert
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
    # an all-invalid packet leaves the state untouched
    same = eskf.predict_scan(ts, g, a, s, np.zeros_like(v), eskf.EskfOptions())
    assert same is ts


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
