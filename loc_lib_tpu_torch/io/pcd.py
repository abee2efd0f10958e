"""Minimal PCD reader/writer (ASCII and binary, xyz[+intensity]; numpy, a
copy of loc_lib_tpu/io/pcd.py, kept here because the JAX package cannot be
imported without jax).

Replaces the reference's pcl::io::loadPCDFile / savePCDFileBinary usage for
keyframe and global-map storage (lio.cpp:116-129, loc.cpp:268-283) without a
PCL dependency. Only the fields the pipelines use are supported; unknown
fields are skipped on read.
"""

from __future__ import annotations

import numpy as np

_SIZES = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4", ("I", 1): "i1",
          ("I", 2): "i2", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def load_pcd(path: str) -> np.ndarray:
    """Returns (N, 3) float32 xyz (intensity and other fields dropped)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        mode = header["DATA"]

        if mode == "ascii":
            data = np.loadtxt(f, max_rows=n)
            cols = []
            c = 0
            for name, cnt in zip(fields, counts):
                if name in ("x", "y", "z"):
                    cols.append(c)
                c += cnt
            return data[:, cols].astype(np.float32)

        if mode == "binary":
            dt = []
            for i, (name, cnt) in enumerate(zip(fields, counts)):
                base = _SIZES[(types[i], sizes[i])]
                if cnt == 1:
                    dt.append((name, base))
                else:
                    dt.append((name, base, (cnt,)))
            arr = np.frombuffer(f.read(), dtype=np.dtype(dt), count=n)
            return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)

        raise ValueError(f"unsupported PCD DATA mode {mode!r}")


def load_pcd_full(path: str) -> dict:
    """PCD reader that KEEPS every scalar field (the vendor-layout analog
    of the reference's FullPointType ingestion, point_types.h:40-169 +
    cloud_subscriber.cpp:31-58): returns {field_name: (N,) array} for
    fields with COUNT 1 — x/y/z plus whatever the driver wrote (intensity,
    ring, timestamp, time, ...). Multi-count fields are skipped."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        mode = header["DATA"]

        if mode == "ascii":
            data = np.loadtxt(f, max_rows=n)
            if data.ndim == 1:
                data = data[None, :]
            out, c = {}, 0
            for i, (name, cnt) in enumerate(zip(fields, counts)):
                if cnt == 1:
                    out[name] = data[:, c]
                c += cnt
            return out

        if mode == "binary":
            dt = []
            for i, (name, cnt) in enumerate(zip(fields, counts)):
                base = _SIZES[(types[i], sizes[i])]
                dt.append((name, base) if cnt == 1 else (name, base, (cnt,)))
            arr = np.frombuffer(f.read(), dtype=np.dtype(dt), count=n)
            return {name: np.asarray(arr[name])
                    for name, cnt in zip(fields, counts) if cnt == 1}

        raise ValueError(f"unsupported PCD DATA mode {mode!r}")


_PCD_TYPE = {"f4": ("F", 4), "f8": ("F", 8), "i4": ("I", 4), "i2": ("I", 2),
             "i1": ("I", 1), "u1": ("U", 1), "u2": ("U", 2), "u4": ("U", 4)}


def save_pcd(path: str, xyz: np.ndarray, binary: bool = True,
             extra_fields: dict | None = None) -> None:
    """xyz plus optional per-point scalar fields (vendor-layout writer:
    e.g. {"intensity": f32, "ring": u2, "timestamp": f8} reproduces the
    Robosense row layout `load_pcd_full`/`kitti.from_vendor_pcd` ingest)."""
    xyz = np.ascontiguousarray(np.asarray(xyz, dtype=np.float32).reshape(-1, 3))
    n = len(xyz)
    extra = extra_fields or {}
    dt = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    for name, arr in extra.items():
        dt.append((name, np.asarray(arr).dtype.str.lstrip("<>=")))
    names = [d[0] for d in dt]
    sizes = " ".join(str(np.dtype(d[1]).itemsize) for d in dt)
    types = " ".join(_PCD_TYPE[np.dtype(d[1]).str.lstrip("<>=")][0]
                     for d in dt)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        f"VERSION 0.7\nFIELDS {' '.join(names)}\nSIZE {sizes}\n"
        f"TYPE {types}\nCOUNT {' '.join(['1'] * len(dt))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    rows = np.zeros(n, dtype=np.dtype(dt))
    rows["x"], rows["y"], rows["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for name, arr in extra.items():
        rows[name] = np.asarray(arr)[:n]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rows.tobytes())
        else:
            np.savetxt(f, np.stack([rows[nm].astype(np.float64)
                                    for nm in names], axis=1), fmt="%.9g")
