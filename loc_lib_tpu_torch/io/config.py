"""YAML config: path-style getters and option-struct construction (port of
loc_lib_tpu/io/config.py).

The reference's `Parameters::GetParamFromYaml<T>("a/b/c", default)` plus
the option wiring its app flows do. Unlike the reference, which re-reads
the YAML file on every query, the file is parsed once: by PyYAML where it
is installed, else by the small scalar-only parser below (the machine with
the card may lack PyYAML, so there that parser is the path that runs).
"""

from __future__ import annotations

from typing import Any

try:
    import yaml as _yaml
except ImportError:  # pragma: no cover
    _yaml = None

from ..models import icp as icp_mod, ndt as ndt_mod, loam as loam_mod
from ..pipeline import lio as lio_mod, loc as loc_mod


class Config:
    def __init__(self, tree: dict):
        self.tree = tree

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            text = f.read()
        if _yaml is not None:
            return cls(_yaml.safe_load(text) or {})
        return cls(_mini_yaml(text))

    def get(self, path: str, default: Any = None) -> Any:
        """GetParamFromYaml('a/b/c', default)."""
        node: Any = self.tree
        for part in path.split("/"):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _mini_yaml(text: str) -> dict:
    """Indentation-based scalar-only YAML subset (enough for slam.yaml)."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        while stack and stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if not val:
            child: dict = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = _coerce(val)
    return root


def _coerce(v: str):
    if v.startswith("[") and v.endswith("]"):
        return [_coerce(x.strip()) for x in v[1:-1].split(",") if x.strip()]
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v.strip("'\"")


# ---------------------------------------------------------------------------
# Option construction (the config->options wiring of the app flows)
# ---------------------------------------------------------------------------

_MATCHERS = {0: "loam", 1: "icp", 2: "ndt"}  # slam.yaml matching_method enum


def lio_options(cfg: Config, root: str = "lio_mapping") -> lio_mod.LioOptions:
    """slam.yaml `lio_mapping` tree -> LioOptions
    (lio_mapping_flow.cpp:51-135)."""
    g = cfg.get
    method = _MATCHERS.get(g(f"{root}/matching_method", 1), "icp")
    icp_method = {0: "p2p", 1: "p2line", 2: "p2plane"}.get(
        g(f"{root}/icp_option/method", 2), "p2plane")
    icp_opts = icp_mod.IcpOptions(
        method=icp_method,
        max_iteration=g(f"{root}/icp_option/max_iteration", 20),
        max_nn_distance=g(f"{root}/icp_option/max_nn_distance", 1.0),
        max_plane_distance=g(f"{root}/icp_option/max_plane_distance", 0.1),
        max_line_distance=g(f"{root}/icp_option/max_line_distance", 0.5),
        min_effective_pts=g(f"{root}/icp_option/min_effective_pts", 10),
        eps=g(f"{root}/icp_option/eps", 1e-2),
    )
    ndt_method = g(f"{root}/ndt_option/method", 0)
    ndt_opts = ndt_mod.NdtOptions(
        method="incremental" if ndt_method == 1 else "direct",
        voxel_size=g(f"{root}/ndt_option/voxel_size", 1.0),
        min_pts_in_voxel=g(f"{root}/ndt_option/min_pts_in_voxel", 3),
        max_pts_in_voxel=g(f"{root}/ndt_option/max_pts_in_voxel", 50),
        nearby=("center" if g(f"{root}/ndt_option/nearby_type", 1) == 0 else "nearby6"),
        max_iteration=g(f"{root}/ndt_option/max_iteration", 20),
        eps=g(f"{root}/ndt_option/eps", 1e-2),
        res_outlier_th=g(f"{root}/ndt_option/res_outlier_th", 20.0),
        min_effective_pts=g(f"{root}/ndt_option/min_effective_pts", 10),
    )
    if method == "ndt" and ndt_method == 1:
        method = "ndt_inc"
    return lio_mod.LioOptions(
        matcher=method,
        icp=icp_opts,
        ndt=ndt_opts,
        loam=loam_mod.LoamOption(),
        kf_distance=g(f"{root}/lio_option/kf_distance", 0.5),
        kf_angle_deg=g(f"{root}/lio_option/kf_angle_deg", 30.0),
        num_kfs_in_local_map=g(f"{root}/lio_option/num_kfs_in_local_map", 10),
        scan_filter_leaf=g(f"{root}/lio_option/cur_scan_filter_size", 1.0),
        map_filter_leaf=g(f"{root}/lio_option/local_map_filter_size", 0.5),
        with_eskf=bool(g(f"{root}/lio_option/with_eskf", True)),
    )


def loc_options(cfg: Config, root: str = "lio_matching") -> loc_mod.LocOptions:
    g = cfg.get
    method = _MATCHERS.get(g(f"{root}/matching_method", 1), "icp")
    if method == "loam":
        method = "icp"  # the reference's LOAM Loc path is an empty stub (loc.cpp:249-254)
    box = g(f"{root}/box_filter_size", [150.0, 150.0, 150.0])
    return loc_mod.LocOptions(
        matcher=method,
        box_size=float(box[0] if isinstance(box, list) else box),
        scan_filter_leaf=g(f"{root}/scan_filter_size", 1.0),
    )


def extrinsic_from_config(cfg: Config, root: str = "lio_mapping"):
    """T_imu_lidar from RPY (degrees) + t. Returns numpy (R_il (3, 3),
    t_il (3,)) float32."""
    import numpy as np
    from ..utils import lie as lie_mod

    g = cfg.get
    rpy = [g(f"{root}/imu_lidar/roll", 0.0), g(f"{root}/imu_lidar/pitch", 0.0),
           g(f"{root}/imu_lidar/yaw", 0.0)]
    t = [g(f"{root}/imu_lidar/x", 0.0), g(f"{root}/imu_lidar/y", 0.0),
         g(f"{root}/imu_lidar/z", 0.0)]
    R = lie_mod.rotm_from_rpy(np.deg2rad(rpy[0]), np.deg2rad(rpy[1]), np.deg2rad(rpy[2]))
    return R.numpy(), np.asarray(t, np.float32)
