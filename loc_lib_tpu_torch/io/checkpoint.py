"""Checkpoint / resume and the keyframe store (port of
loc_lib_tpu/io/checkpoint.py).

The reference's persistence is file-based and coarse: every keyframe cloud
is written as a PCD, keyframe poses live in memory and export as KITTI/TUM,
the global map is re-assembled from the keyframe files, and output dirs are
wiped at startup, so mapping runs are NOT resumable mid-stream.

This module makes them resumable: the whole pipeline state (a NamedTuple of
tensors, nested NamedTuples, `None` leaves and host ints: LioState /
LocState / EskfState) snapshots atomically into one npz keyed by each leaf's
dotted field path (`eskf.cov`, `icp_target.grid.voxel_keys`, ...), and a
`KeyframeStore` fills the per-keyframe-file role with npz/PCD blobs and a
manifest. The JAX package's `Checkpointer` can also write through orbax, a
JAX library; here the npz branch is the only one.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from . import pcd as pcd_io


# ---------------------------------------------------------------------------
# State snapshots
# ---------------------------------------------------------------------------

def _children(node):
    """(name, child) pairs of a NamedTuple (its field names) or of a plain
    tuple / list (its indices)."""
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return [(str(i), c) for i, c in enumerate(node)]


def _flatten(node, prefix: str, out: dict[str, np.ndarray]) -> None:
    if node is None:
        return
    if isinstance(node, (tuple, list)):
        for name, child in _children(node):
            _flatten(child, f"{prefix}{name}.", out)
        return
    key = prefix[:-1]
    if isinstance(node, torch.Tensor):
        out[key] = node.detach().cpu().numpy()
    else:
        out[key] = np.asarray(node)


def _restore(like, prefix: str, data) -> Any:
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        kids = [_restore(child, f"{prefix}{name}.", data) for name, child in _children(like)]
        return type(like)(*kids) if hasattr(like, "_fields") else type(like)(kids)
    key = prefix[:-1]
    if key not in data:
        raise ValueError(f"checkpoint has no leaf {key!r}: options differ from the saving run")
    arr = data[key]
    if arr.shape != tuple(np.shape(like)):
        raise ValueError(
            f"checkpoint leaf {key} shape {arr.shape} != expected {tuple(np.shape(like))}"
            " — options/capacities differ from the saving run")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=like.device,
                                                               dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr.astype(np.asarray(like).dtype)


def save_state(path: str, state: Any, step: Optional[int] = None) -> str:
    """Atomic snapshot of a state (LioState / LocState / EskfState / ...).

    Writes `<path>` as an .npz (appending the suffix if missing) through a
    temporary file and a rename, so a crash never leaves a torn checkpoint.
    Returns the final path.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrays: dict[str, np.ndarray] = {}
    _flatten(state, "", arrays)
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_state(path: str, like: Any) -> tuple[Any, Optional[int]]:
    """Restore a state saved by `save_state`. `like` gives the structure,
    dtypes and devices (an example state built by the pipeline's
    init_state); tensors land on `like`'s devices. Returns (state, step)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        state = _restore(like, "", data)
        step = int(data["__step__"]) if "__step__" in data.files else None
    return state, step


class Checkpointer:
    """Rolling checkpoint manager over npz snapshots: save(step, state) /
    latest() / restore(like), keeping the newest `max_to_keep`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _kept(self) -> list[str]:
        return sorted(p for p in os.listdir(self.directory)
                      if p.startswith("ckpt_") and p.endswith(".npz"))

    def save(self, step: int, state: Any) -> None:
        save_state(os.path.join(self.directory, f"ckpt_{step:08d}"), state, step)
        for old in self._kept()[: -self.max_to_keep]:
            os.unlink(os.path.join(self.directory, old))

    def latest(self) -> Optional[int]:
        kept = self._kept()
        return int(kept[-1][5:13]) if kept else None

    def restore(self, like: Any, step: Optional[int] = None) -> tuple[Any, int]:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state, _ = load_state(os.path.join(self.directory, f"ckpt_{step:08d}"), like)
        return state, step


# ---------------------------------------------------------------------------
# Keyframe store (per-keyframe cloud files + manifest)
# ---------------------------------------------------------------------------

class KeyframeStore:
    """Directory of keyframe clouds + poses with a JSON manifest.

    Keyframes persist as individual cloud files named key_frame_<i> and
    the global map re-assembles from them, as in the reference, but
    resumable: the manifest records poses and count, so a restarted run
    continues appending instead of wiping (the reference's
    delete-and-recreate is opt-in via fresh=True).
    """

    def __init__(self, directory: str, fresh: bool = False,
                 fmt: str = "npz"):
        if fmt not in ("npz", "pcd"):
            raise ValueError(f"fmt must be 'npz' or 'pcd', got {fmt!r}")
        self.directory = os.path.abspath(directory)
        self.fmt = fmt
        if fresh and os.path.isdir(self.directory):
            shutil.rmtree(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self._manifest = os.path.join(self.directory, "manifest.json")
        if os.path.exists(self._manifest):
            with open(self._manifest) as f:
                m = json.load(f)
            self.poses = [np.asarray(p, np.float32) for p in m["poses"]]
        else:
            self.poses: list[np.ndarray] = []

    def __len__(self) -> int:
        return len(self.poses)

    def _path(self, i: int) -> str:
        return os.path.join(self.directory, f"key_frame_{i}.{self.fmt}")

    def append(self, xyz: np.ndarray, pose: np.ndarray) -> int:
        """Store one keyframe cloud (lidar frame) and its 4x4 world pose.
        Returns the keyframe index."""
        i = len(self.poses)
        xyz = np.asarray(xyz, np.float32)
        if self.fmt == "pcd":
            pcd_io.save_pcd(self._path(i), xyz)
        else:
            np.savez(self._path(i), xyz=xyz)
        self.poses.append(np.asarray(pose, np.float32))
        with open(self._manifest, "w") as f:
            json.dump({"count": len(self.poses),
                       "poses": [p.tolist() for p in self.poses]}, f)
        return i

    def load_cloud(self, i: int) -> np.ndarray:
        if self.fmt == "pcd":
            return pcd_io.load_pcd(self._path(i))
        return np.load(self._path(i))["xyz"]

    def assemble_global_map(self, voxel_size: float = 0.0) -> np.ndarray:
        """Reload every keyframe, transform by its pose, concatenate;
        optional host-side voxel thinning (first point of each voxel)."""
        parts = []
        for i, T in enumerate(self.poses):
            xyz = self.load_cloud(i)
            parts.append(xyz @ T[:3, :3].T + T[:3, 3])
        if not parts:
            return np.zeros((0, 3), np.float32)
        out = np.concatenate(parts).astype(np.float32)
        if voxel_size > 0:
            keys = np.floor(out / voxel_size).astype(np.int64)
            _, idx = np.unique(keys, axis=0, return_index=True)
            out = out[np.sort(idx)]
        return out
