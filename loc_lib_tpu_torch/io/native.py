"""ctypes bindings for the native host runtime (csrc/loc_runtime.cpp; port of
loc_lib_tpu/io/native.py).

Vendor point conversion, fixed-capacity packing, per-scan IMU grouping and
KITTI formatting run as multithreaded C++ so the Python driver only ships
finished buffers to the device. The library is built with g++ at first use
into `csrc/build/<hash of the source and flags>/`, under a temporary name
and renamed into place, so processes that start together (test workers,
`multihost.launch` ranks) never load a half-written file. Everything here
degrades gracefully: without a C++ toolchain the callers take the numpy
implementations below, which are the behavioural oracle the native code is
tested against (tests/test_torch_io.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "loc_runtime.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return CSRC / "build" / h.hexdigest()[:16] / "libloc_runtime.so"


def _build(lib: Path) -> bool:
    if lib.exists():
        return True
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        lib.lr_version.restype = ctypes.c_int
        if lib.lr_version() != 1:
            return None
        lib.lr_convert_cloud.restype = ctypes.c_int64
        lib.lr_convert_cloud.argtypes = [
            _f32p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int64,
            _f32p, _f32p, _i32p, _u8p]
        lib.lr_convert_cloud_batch.restype = None
        lib.lr_convert_cloud_batch.argtypes = [
            _f32p, ctypes.c_void_p, ctypes.c_void_p, _i64p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int64,
            _f32p, _f32p, _i32p, _u8p, _i64p]
        lib.lr_sync_measures.restype = None
        lib.lr_sync_measures.argtypes = [
            _f64p, ctypes.c_int64, _f64p, _f32p, _f32p, ctypes.c_int64,
            ctypes.c_int64, _f32p, _f32p, _f32p, _u8p]
        lib.lr_format_kitti.restype = ctypes.c_int64
        lib.lr_format_kitti.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native runtime could be built and loaded."""
    return _load() is not None


def convert_cloud(xyz: np.ndarray, capacity: int,
                  point_time: Optional[np.ndarray] = None,
                  ring: Optional[np.ndarray] = None,
                  min_range: float = 0.0, max_range: float = np.inf,
                  pad_value: float = 1e6):
    """Vendor cloud -> padded (xyz, rel_time, ring, mask, count): NaN cull,
    min/max-range cull, per-point time relative to the scan start,
    fixed-capacity padding (the reference's CloudConver)."""
    lib = _load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    if lib is None:
        return _convert_cloud_np(xyz, capacity, point_time, ring, min_range,
                                 max_range, pad_value)
    out_xyz = np.empty((capacity, 3), np.float32)
    out_rel = np.empty((capacity,), np.float32)
    out_ring = np.empty((capacity,), np.int32)
    out_mask = np.empty((capacity,), np.uint8)
    # keep converted arrays alive across the call (ctypes.data is a raw ptr)
    tp_arr = (np.ascontiguousarray(point_time, np.float64)
              if point_time is not None else None)
    rp_arr = np.ascontiguousarray(ring, np.int32) if ring is not None else None
    tp = tp_arr.ctypes.data if tp_arr is not None else None
    rp = rp_arr.ctypes.data if rp_arr is not None else None
    max_r = np.float32(np.finfo(np.float32).max if np.isinf(max_range) else max_range)
    m = lib.lr_convert_cloud(xyz, tp, rp, n, np.float32(min_range), max_r,
                             np.float32(pad_value), capacity,
                             out_xyz, out_rel, out_ring, out_mask)
    return out_xyz, out_rel, out_ring, out_mask.astype(bool), int(m)


def _convert_cloud_np(xyz, capacity, point_time, ring, min_range, max_range,
                      pad_value):
    """Numpy fallback with identical semantics."""
    finite = np.isfinite(xyz).all(axis=1)
    r2 = np.einsum("ij,ij->i", xyz, xyz)
    keep = finite & (r2 >= min_range ** 2) & (r2 <= min(max_range, 1e18) ** 2)
    idx = np.nonzero(keep)[0][:capacity]
    m = len(idx)
    out_xyz = np.full((capacity, 3), pad_value, np.float32)
    out_rel = np.zeros((capacity,), np.float32)
    out_ring = np.full((capacity,), -1, np.int32)
    out_mask = np.zeros((capacity,), bool)
    out_xyz[:m] = xyz[idx]
    if point_time is not None and len(point_time):
        out_rel[:m] = (np.asarray(point_time, np.float64)[idx]
                       - np.min(point_time)).astype(np.float32)
    if ring is not None:
        out_ring[:m] = np.asarray(ring, np.int32)[idx]
    out_mask[:m] = True
    return out_xyz, out_rel, out_ring, out_mask, m


def sync_measures_batch(scan_stamps: np.ndarray, imu_stamps: np.ndarray,
                        imu_gyro: np.ndarray, imu_acce: np.ndarray,
                        capacity: int):
    """All frames' IMU packets in one native call.

    Returns (stamp (F,C) f32, gyro (F,C,3) f32, acce (F,C,3) f32,
    valid (F,C) bool). Matches replay.sync_measures packet for packet.
    """
    lib = _load()
    scan_stamps = np.ascontiguousarray(scan_stamps, np.float64)
    f = len(scan_stamps)
    if lib is None or len(imu_stamps) == 0:
        return _sync_measures_np(scan_stamps, imu_stamps, imu_gyro, imu_acce,
                                 capacity)
    stamp = np.empty((f, capacity), np.float32)
    gyro = np.empty((f, capacity, 3), np.float32)
    acce = np.empty((f, capacity, 3), np.float32)
    valid = np.empty((f, capacity), np.uint8)
    lib.lr_sync_measures(
        scan_stamps, f,
        np.ascontiguousarray(imu_stamps, np.float64),
        np.ascontiguousarray(imu_gyro, np.float32),
        np.ascontiguousarray(imu_acce, np.float32),
        len(imu_stamps), capacity, stamp, gyro, acce, valid)
    return stamp, gyro, acce, valid.astype(bool)


def _sync_measures_np(scan_stamps, imu_stamps, imu_gyro, imu_acce, capacity):
    from . import replay

    f = len(scan_stamps)
    stamp = np.zeros((f, capacity), np.float32)
    gyro = np.zeros((f, capacity, 3), np.float32)
    acce = np.zeros((f, capacity, 3), np.float32)
    valid = np.zeros((f, capacity), bool)
    imu = (replay.ImuLog(np.asarray(imu_stamps), np.asarray(imu_gyro),
                         np.asarray(imu_acce))
           if len(imu_stamps) else None)
    for mg in replay.sync_measures(scan_stamps, imu, None, capacity):
        k = mg.scan_index
        stamp[k], gyro[k], acce[k], valid[k] = (
            mg.imu_stamp, mg.imu_gyro, mg.imu_acce, mg.imu_valid)
    return stamp, gyro, acce, valid


def format_kitti(poses: np.ndarray) -> Optional[bytes]:
    """Native KITTI trajectory formatting; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    poses = np.ascontiguousarray(poses, np.float32)
    cap = max(64, 12 * 32 * len(poses))
    buf = ctypes.create_string_buffer(cap)
    w = lib.lr_format_kitti(poses.reshape(-1), len(poses), buf, cap)
    if w < 0:
        return None
    return buf.raw[:w]
