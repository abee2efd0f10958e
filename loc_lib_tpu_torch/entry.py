"""Driver entry points: one LIO step on the card, and a multi-rank dry run
(port of the JAX repo's __graft_entry__.py).

entry(device=None)          -> (fn, args): one LIO forward step (p2plane
                               ICP scan-to-local-map, ESKF, keyframe
                               local-map upkeep) at tiny options, on the
                               card unless a device is named.
dryrun_multichip(n, device) -> runs, in n ranks started by
                               `multihost.launch`, the distributed
                               compositions of the JAX dry run: the LIO
                               step on every rank, the data-parallel ICP
                               match, the mp-sharded plane-table match,
                               LocSharded, LioSharded with the pose-graph
                               correction written through its map, and the
                               edge-sharded two-phase pose graph.

    python -m loc_lib_tpu_torch.entry [N]    # entry() on the card, then N ranks
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


def _tiny_opts(scan_capacity: int = 256):
    from .models import icp
    from .pipeline import lio

    return lio.LioOptions(
        matcher="icp",
        icp=icp.IcpOptions(method="p2plane", max_iteration=3, bucket_size=4),
        scan_capacity=scan_capacity,
        num_kfs_in_local_map=2,
        imu_capacity=8,
        kf_distance=0.2,
        with_eskf=True,
    )


def _tiny_scan(capacity: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-10, 10, (capacity, 3)).astype(np.float32)
    xyz[:, 2] = np.abs(xyz[:, 2]) * 0.2
    return (torch.from_numpy(xyz).to(device),
            torch.ones((capacity,), dtype=torch.bool, device=device))


def entry(device=None):
    """(fn, args) of one LIO step on the flagship pipeline (p2plane ICP +
    ESKF): `fn(*args)` returns (new_state, StepResult)."""
    from .ops.pointcloud import PointCloud, card_device
    from .pipeline import lio

    device = card_device(device)
    opts = _tiny_opts()
    state = lio.init_state(opts, device=device)
    xyz, mask = _tiny_scan(opts.scan_capacity, device)

    def fn(state, xyz, mask):
        return lio.step(state, PointCloud(xyz=xyz, mask=mask), opts)

    return fn, (state, xyz, mask)


def _imu_packet(n: int, device):
    gyro = torch.zeros((n, 3), dtype=torch.float32, device=device)
    acce = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float32, device=device).repeat(n, 1)
    stamps = torch.linspace(0.0, 0.07, n, dtype=torch.float32, device=device)
    return gyro, acce, stamps, np.ones((n,), bool)


def dryrun_rank(n_devices: int, device_type: str) -> str:
    """One rank of `dryrun_multichip`: every composition on this rank's
    device (its card, the current one, or the CPU), finite results
    asserted. Returns a one-line summary."""
    from .graph import pose_graph as pg
    from .models import icp, ndt as ndt_mod
    from .ops.pointcloud import PointCloud, card_device
    from .parallel import graph as pgraph, map_shard, match as pmatch, mesh as mesh_mod
    from .pipeline import lio, lio_sharded, loc as loc_mod, loc_sharded
    from .utils import lie

    def finite(x, what):
        if not torch.isfinite(x).all():
            raise AssertionError(f"dryrun_multichip({n_devices}): {what} is not finite")

    device = torch.device("cpu") if device_type == "cpu" else card_device(None)
    cap = max(256, 64 * n_devices)
    opts = _tiny_opts(scan_capacity=cap)
    mesh = mesh_mod.make_mesh(n_devices)
    gyro, acce, stamps, valid = _imu_packet(opts.imu_capacity, device)

    # the LIO step on every rank (the second exercises the keyframe rebuild)
    state = lio.init_state(opts, device=device)
    xyz, mask = _tiny_scan(cap, device)
    for _ in range(2):
        state, out = lio.step_measure(state, PointCloud(xyz=xyz, mask=mask), gyro, acce,
                                      stamps, valid, opts)
    finite(out.t, "the LIO step")

    # data-parallel ICP: source rows over "dp", one reduction per iteration
    iopts = icp.IcpOptions(method="p2plane", max_iteration=3, bucket_size=4)
    tgt_xyz, tgt_mask = _tiny_scan(cap, device, seed=1)
    target = icp.set_target(PointCloud(xyz=tgt_xyz, mask=tgt_mask), iopts)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    res = pmatch.icp_scan_match(mesh, target, iopts, PointCloud(xyz=xyz, mask=mask), eye, z3)
    finite(res.t, "the data-parallel ICP match")
    done = ["LIO step", "psum GN"]

    if n_devices >= 2 and n_devices % 2 == 0:
        mesh2d = mesh_mod.make_mesh_2d(2, n_devices // 2)
        # the plane table sharded over "mp"
        vopts = icp.IcpOptions(method="p2plane_vox", max_iteration=3, plane_min_pts=3)
        st = map_shard.set_target_sharded(mesh2d, PointCloud(xyz=tgt_xyz, mask=tgt_mask),
                                          vopts, shard_capacity=max(cap // (n_devices // 2) * 2,
                                                                    64))
        res2 = map_shard.icp_scan_match_sharded(mesh2d, st, vopts,
                                                PointCloud(xyz=xyz, mask=mask), eye, z3)
        finite(res2.t, "the mp-sharded plane-table match")
        # the sharded Loc pipeline
        lopts = loc_mod.LocOptions(icp=vopts, scan_capacity=cap, local_map_capacity=4 * cap,
                                   box_size=40.0, recrop_margin=10.0)
        eng = loc_sharded.LocSharded(mesh2d, tgt_xyz.cpu().numpy(), lopts,
                                     shard_capacity=2 * cap, device=device)
        eng.set_init_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        out2 = eng.update_measure(PointCloud(xyz=xyz, mask=mask), gyro, acce, stamps, valid)
        finite(out2.t, "the sharded Loc step")
        # the sharded mapping pipeline: the first frame seeds the slabs, the
        # second runs the distributed match and the shard-local absorption
        sopts = dataclasses.replace(
            _tiny_opts(scan_capacity=cap), matcher="ndt_inc",
            ndt=ndt_mod.NdtOptions(method="incremental", voxel_size=1.0, map_capacity=2048))
        seng = lio_sharded.LioSharded(mesh2d, sopts, device=device)
        seng.imu_inited = True
        for seed in (0, 2):
            sxyz, smask = _tiny_scan(cap, device, seed=seed)
            out3 = seng.add_measure(PointCloud(xyz=sxyz, mask=smask), gyro, acce, stamps,
                                    valid)
        finite(out3.t, "the sharded mapping step")
        if seng.live_voxels_per_shard().sum() <= 0:
            raise AssertionError("the sharded voxel map is empty")
        # a pose-graph correction written through the sharded map, then one
        # more distributed match against the corrected map
        dR = lie.so3_exp(torch.tensor([0.0, 0.0, 0.03])).numpy()
        seng.apply_correction(dR, np.array([0.2, -0.1, 0.0], np.float32))
        out4 = seng.add_measure(PointCloud(xyz=sxyz, mask=smask), gyro, acce, stamps, valid)
        finite(out4.t, "the match after the correction")
        done += ["mp-sharded plane-table match", "sharded Loc", "sharded mapping",
                 "correction write-through"]

    # the edge-sharded two-phase pose graph
    m_nodes = 12
    ang = np.linspace(0, np.pi, m_nodes).astype(np.float32)
    nodes_t = torch.from_numpy(np.stack([np.cos(ang) * 4, np.sin(ang) * 4,
                                         np.zeros(m_nodes, np.float32)], 1)).to(device)
    nodes_R = torch.eye(3, dtype=torch.float32, device=device).expand(m_nodes, 3, 3)
    edges = pg.odometry_edges(nodes_R.contiguous(), nodes_t)
    loop = pg.Se3Edges(
        i=torch.tensor([0], device=device), j=torch.tensor([m_nodes - 1], device=device),
        R=torch.eye(3, dtype=torch.float32, device=device)[None],
        t=(nodes_t[-1] - nodes_t[0])[None],
        info=torch.eye(6, dtype=torch.float32, device=device)[None] * 1e4,
        is_loop=torch.tensor([True], device=device),
        valid=torch.tensor([True], device=device))
    popts = dataclasses.replace(pg.PgoOptions(), max_iterations=3, max_cg_iterations=30)
    _, tg, _ = pgraph.optimize_two_phase(mesh, nodes_R.contiguous(), nodes_t,
                                         pg.concat_edges(edges, loop), popts)
    finite(tg, "the edge-sharded pose graph")
    done.append("edge-sharded two-phase PGO")
    return f"dryrun_multichip({n_devices}) on {device}: OK ({', '.join(done)})"


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run `dryrun_rank` in n ranks on this machine (`multihost.launch`):
    device="cuda" puts rank r on card r mod the cards (NCCL when there are
    n cards, else gloo with the ranks sharing them); device="cpu" runs them
    on the CPU over gloo. Returns each rank's summary."""
    from .parallel import multihost

    backend = None
    if str(device) == "cuda" and torch.cuda.is_available():
        backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
    return multihost.launch("loc_lib_tpu_torch.entry:dryrun_rank", n_devices,
                            (n_devices, torch.device(device).type), device=device,
                            backend=backend)


if __name__ == "__main__":
    fn, args = entry()
    new_state, out = fn(*args)
    print(f"entry(): one LIO step OK on {args[1].device} (t = {out.t.cpu().numpy()})")
    print("\n".join(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)[:1]))
