"""18-dim error-state Kalman filter, static IMU initializer and IMU
dead-reckoning integrator (port of loc_lib_tpu/models/eskf.py).

A pure `(state, measurement) -> state` function pair (`predict`,
`observe_se3`) over an `EskfState` NamedTuple of tensors. State order
matches the reference: p, v, R, bg, ba, g. `predict_scan` propagates a
padded IMU packet; JAX's `lax.scan` of `predict` with a per-sample
keep/skip select, which XLA fuses into one program, is ONE launch of the
hand-written kernel `ops.kernels.eskf_predict_scan` on the card, and its
plain version (the same scan as torch ops, the select a `torch.where`) on
the CPU. Each update (`observe_se3`, `observe_wheel_speed`: the observation
build and the Kalman update, one jitted program each in the reference) is
ONE launch of `ops.kernels.eskf_update`, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.pointcloud import card_device
from ..utils import lie, mathx

DEG2RAD = math.pi / 180.0


@dataclasses.dataclass(frozen=True)
class EskfOptions:
    """Mirror of the JAX package's EskfOptions (same names and defaults).
    Noise terms are discrete-time (not multiplied by dt), as in the
    reference. The GNSS and lidar noise fields are read by nothing, as in
    JAX."""

    imu_dt: float = 0.01
    gyro_var: float = 1e-5
    acce_var: float = 1e-2
    bias_gyro_var: float = 1e-6
    bias_acce_var: float = 1e-4
    gnss_pos_noise: float = 0.1
    gnss_height_noise: float = 0.1
    gnss_ang_noise_deg: float = 1.0
    lidar_pos_noise: float = 0.1
    lidar_height_noise: float = 0.1
    lidar_ang_noise_deg: float = 1.0
    update_bias_gyro: bool = True
    update_bias_acce: bool = True
    # wheel odometry
    odom_var: float = 0.5
    odom_span: float = 0.1          # odometer measurement interval [s]
    wheel_radius: float = 0.155     # [m]
    circle_pulse: float = 1024.0    # encoder pulses per wheel revolution


class EskfState(NamedTuple):
    """Nominal state + covariance (the error state is reset after every
    update)."""

    p: torch.Tensor          # (3,)
    v: torch.Tensor          # (3,)
    R: torch.Tensor          # (3, 3)
    bg: torch.Tensor         # (3,)
    ba: torch.Tensor         # (3,)
    g: torch.Tensor          # (3,)
    cov: torch.Tensor        # (18, 18)
    time: torch.Tensor       # () float32 seconds


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_state(bg=None, ba=None, gravity=None, cov_scale: float = 1e-4,
               time: float = 0.0, *, device=None) -> EskfState:
    """Initial conditions on `device` (default: the card, see
    `pointcloud.card_device`): cov = I * cov_scale."""
    device = card_device(device)
    z = torch.zeros(3, dtype=torch.float32, device=device)
    return EskfState(
        p=z, v=z.clone(), R=torch.eye(3, dtype=torch.float32, device=device),
        bg=z.clone() if bg is None else _f32(bg, device),
        ba=z.clone() if ba is None else _f32(ba, device),
        g=_f32([0.0, 0.0, -9.8], device) if gravity is None else _f32(gravity, device),
        cov=torch.eye(18, dtype=torch.float32, device=device) * cov_scale,
        time=_f32(time, device),
    )


def process_noise(opts: EskfOptions, device=None) -> torch.Tensor:
    """Process noise on `device` (default: the card): the reference uses the
    variances directly. Q depends only on (opts, device), so it is built once
    per pair and shared: callers read it, never write it."""
    return _diag_on(card_device(device), (0.0,) * 3 + (opts.acce_var,) * 3 + (opts.gyro_var,) * 3
                    + (opts.bias_gyro_var,) * 3 + (opts.bias_acce_var,) * 3 + (0.0,) * 3)


@functools.lru_cache(maxsize=16)
def _diag_on(device, values: tuple) -> torch.Tensor:
    """diag(values) made on the device by fills (no host-to-device copy,
    which would wait for the stream on the card), once per (device, values):
    the element fills are a host round trip each on the card, and the
    filter asks for the same Q on every scan. The cache is
    bounded, so a caller that varies its noise from call to call rebuilds
    and pins no more than 16 matrices."""
    d = torch.zeros(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        if v:
            d[i] = v
    return torch.diag(d)


_PREDICTED = ("p", "v", "R", "cov", "time")     # what propagation changes; bg, ba, g do not


def predict(s: EskfState, gyro, acce, timestamp, opts: EskfOptions) -> EskfState:
    """One IMU propagation step (`kernels.eskf_predict_plain` with the
    options' Q). Skips the update (time still advances) when dt > 5*imu_dt
    or dt < 0."""
    return s._replace(**dict(zip(_PREDICTED, kernels.eskf_predict_plain(
        *s, gyro, acce, timestamp, process_noise(opts, s.p.device), opts.imu_dt))))


def predict_scan(s: EskfState, gyros, acces, timestamps, valid,
                 opts: EskfOptions) -> EskfState:
    """Propagate through a padded IMU packet (host arrays or tensors);
    `valid` masks padding, and an invalid sample leaves the state, time
    included, unchanged. One launch of `kernels.eskf_predict_scan` on the
    card; the host reads nothing back."""
    return s._replace(**dict(zip(_PREDICTED, kernels.eskf_predict_scan(
        *s, gyros, acces, timestamps, valid, process_noise(opts, s.p.device), opts.imu_dt))))


_UPDATED = ("p", "v", "R", "bg", "ba", "g", "cov")     # what an update changes; time does not


def observe_se3(s: EskfState, R_obs, t_obs, opts: EskfOptions,
                trans_noise: float = 0.1,
                ang_noise_rad: float = 1.0 * math.pi / 180.0) -> EskfState:
    """Pose observation + update/reset: one launch of `kernels.eskf_update`
    on the card (the observation build, the Kalman update, the injection and
    the covariance projection). Like the reference, V holds the noise
    values, not their squares."""
    return s._replace(**dict(zip(_UPDATED, kernels.eskf_update(
        *s[:7], "se3", (R_obs, t_obs), (trans_noise, ang_noise_rad), opts.update_bias_gyro,
        opts.update_bias_acce))))


def observe_wheel_speed(s: EskfState, left_pulse, right_pulse,
                        opts: EskfOptions) -> EskfState:
    """Wheel-odometry velocity observation: per-wheel speed from the pulses
    over one odom_span, averaged, taken as the body-x velocity, rotated to
    the world and observed on the v block; one launch of
    `kernels.eskf_update` on the card. Unlike observe_se3, the noise is the
    SQUARED odom_var, as the reference builds it."""
    wheel = opts.wheel_radius * 2.0 * math.pi / opts.circle_pulse / opts.odom_span
    return s._replace(**dict(zip(_UPDATED, kernels.eskf_update(
        *s[:7], "wheel", (left_pulse, right_pulse, wheel), (opts.odom_var,),
        opts.update_bias_gyro, opts.update_bias_acce))))


def nominal_se3(s: EskfState):
    return s.R, s.p


def set_pose(s: EskfState, R, t, gravity=None) -> EskfState:
    dev = s.p.device
    out = s._replace(R=_f32(R, dev), p=_f32(t, dev))
    if gravity is not None:
        out = out._replace(g=_f32(gravity, dev))
    return out


# ---------------------------------------------------------------------------
# Static IMU initializer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImuInitOptions:
    init_time_seconds: float = 1.0
    init_imu_queue_max_size: int = 400
    static_odom_pulse: int = 5
    max_static_gyro_var: float = 0.5
    max_static_acce_var: float = 0.05
    gravity_norm: float = 9.81


class ImuInitResult(NamedTuple):
    success: torch.Tensor     # () bool
    bg: torch.Tensor          # (3,) gyro bias
    ba: torch.Tensor          # (3,) acce bias (gravity-compensated residual)
    gravity: torch.Tensor     # (3,)
    cov_gyro: torch.Tensor    # (3,) diagonal variance
    cov_acce: torch.Tensor    # (3,)


def odom_is_static(left_pulse, right_pulse, opts: ImuInitOptions = ImuInitOptions()):
    """Wheel-odometry stillness test: both wheels under the pulse-noise
    floor. Tensors or host numbers in, the same kind out."""
    return (left_pulse < opts.static_odom_pulse) & (right_pulse < opts.static_odom_pulse)


def static_imu_init(gyros, acces, valid, opts: ImuInitOptions = ImuInitOptions(),
                    is_static=None) -> ImuInitResult:
    """Static-init math as one reduction over a padded buffer of stationary
    IMU samples. `is_static` (optional (N,) bool) keeps only the trailing
    contiguous static run, like the reference's queue clearing."""
    if is_static is not None:
        trailing = torch.flip(torch.cumprod(torch.flip(is_static.to(torch.int32), [0]), 0), [0])
        valid = valid & trailing.to(torch.bool)

    mean_gyro, cov_gyro, n = mathx.masked_mean_and_cov_diag(gyros, valid)
    mean_acce, cov_acce, _ = mathx.masked_mean_and_cov_diag(acces, valid)
    gravity = -mean_acce / torch.linalg.vector_norm(mean_acce) * opts.gravity_norm
    mean_acce2, cov_acce2, _ = mathx.masked_mean_and_cov_diag(acces + gravity, valid)
    ok = ((n >= 10)
          & (torch.linalg.vector_norm(cov_gyro) <= opts.max_static_gyro_var)
          & (torch.linalg.vector_norm(cov_acce2) <= opts.max_static_acce_var))
    return ImuInitResult(success=ok, bg=mean_gyro, ba=mean_acce2, gravity=gravity,
                         cov_gyro=cov_gyro, cov_acce=cov_acce2)


def eskf_options_from_init(init: ImuInitResult, base: EskfOptions = EskfOptions()) -> EskfOptions:
    """ESKF noise seeded from the initializer, as the reference's Lio does:
    gyro_var = sqrt(cov_gyro[0]), acce_var = sqrt(cov_acce[0])."""
    return dataclasses.replace(
        base,
        gyro_var=float(np.sqrt(init.cov_gyro[0].cpu().numpy())),
        acce_var=float(np.sqrt(init.cov_acce[0].cpu().numpy())),
    )


# ---------------------------------------------------------------------------
# Plain IMU dead reckoning
# ---------------------------------------------------------------------------

class ImuIntegState(NamedTuple):
    p: torch.Tensor          # (3,)
    v: torch.Tensor          # (3,)
    R: torch.Tensor          # (3, 3)
    time: torch.Tensor       # () float32 seconds


def imu_integrate(s: ImuIntegState, gyro, acce, timestamp, bg, ba, gravity) -> ImuIntegState:
    """One dead-reckoning step with fixed biases and gravity (no
    covariance, no dt gate beyond clamping a negative dt to 0)."""
    dev = s.p.device
    timestamp = _f32(timestamp, dev)
    dt = torch.clamp(timestamp - s.time, min=0.0)
    acc_w = s.R @ (_f32(acce, dev) - _f32(ba, dev)) + _f32(gravity, dev)
    return ImuIntegState(
        p=s.p + s.v * dt + 0.5 * acc_w * dt * dt,
        v=s.v + acc_w * dt,
        R=s.R @ lie.so3_exp((_f32(gyro, dev) - _f32(bg, dev)) * dt),
        time=timestamp,
    )
