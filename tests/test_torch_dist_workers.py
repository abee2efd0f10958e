"""Rank functions of the distributed parity tests (tests/test_torch_parallel.py,
test_torch_map_shard.py, test_torch_multihost.py, test_torch_apps.py).

`loc_lib_tpu_torch.parallel.multihost.launch` runs each of them in spawned
CPU processes joined over gloo, one per rank, with this directory on the
path. They import torch, numpy and the port only, never jax: a rank is what
a user's process on a machine without jax runs. Each takes one dict of
numpy inputs (made by the test from a seed) and returns numpy results. The
module holds no test of its own.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import time

from loc_lib_tpu_torch.graph import pose_graph as pg, scan_context as sc
from loc_lib_tpu_torch.io import convert, logdir
from loc_lib_tpu_torch.models import icp, ndt
from loc_lib_tpu_torch.ops import voxel
from loc_lib_tpu_torch.ops.pointcloud import PointCloud
from loc_lib_tpu_torch.parallel import graph as pgraph, map_shard, match as pmatch
from loc_lib_tpu_torch.parallel import mesh as mesh_mod
from loc_lib_tpu_torch.pipeline import lio, lio_sharded, loc, loc_sharded, slam3d
from loc_lib_tpu_torch.pipeline.slam3d_sharded import Slam3dSharded

DEV = torch.device("cpu")


def _pc(xyz, mask) -> PointCloud:
    return PointCloud(xyz=torch.from_numpy(np.array(xyz, np.float32)),
                      mask=torch.from_numpy(np.array(mask, bool)))


def _np(res) -> dict:
    """A match result as numpy (iterations as an int)."""
    return {"R": res.R.numpy(), "t": res.t.numpy(), "converged": bool(res.converged),
            "num_effective": int(res.num_effective), "iterations": int(res.iterations),
            "chi2": float(res.chi2)}


def _edges(d) -> pg.Se3Edges:
    return pg.Se3Edges(*[np.asarray(d[k]) for k in pg.Se3Edges._fields])


def _mesh(shape):
    return mesh_mod.make_mesh(shape[0]) if len(shape) == 1 else mesh_mod.make_mesh_2d(*shape)


def _rank() -> dict:
    return {"rank": dist.get_rank(), "world": dist.get_world_size()}


# ---------------------------------------------------------------------------
# parallel/match.py and parallel/graph.py (1-D "dp" mesh)
# ---------------------------------------------------------------------------

def parallel_case(case: dict) -> dict:
    mesh = mesh_mod.make_mesh(dist.get_world_size())
    tgt, src = _pc(*case["tgt"]), _pc(*case["src"])
    eye, z = torch.eye(3), torch.zeros(3)
    out = _rank()
    iopts = icp.IcpOptions(method="p2plane")
    out["icp"] = _np(pmatch.icp_scan_match(mesh, icp.set_target(tgt, iopts), iopts, src,
                                           eye, z))
    nopts = ndt.NdtOptions(voxel_size=2.0, method="direct")
    out["ndt"] = _np(pmatch.ndt_scan_match(mesh, ndt.build_direct(tgt, nopts), nopts, src,
                                           eye, z))
    R0, t0 = torch.from_numpy(case["R_est"]), torch.from_numpy(case["t_est"])
    R, t, chi2 = pgraph.optimize(mesh, R0, t0, _edges(case["edges_good"]))
    out["pgo"] = {"R": R.numpy(), "t": t.numpy(), "chi2": chi2.numpy()}
    R, t, inl = pgraph.optimize_two_phase(mesh, R0, t0, _edges(case["edges_all"]))
    out["two_phase"] = {"R": R.numpy(), "t": t.numpy(), "inlier": inl.numpy()}
    return out


# ---------------------------------------------------------------------------
# parallel/map_shard.py and the sharded pipelines ("dp" x "mp" mesh)
# ---------------------------------------------------------------------------

def _icp_shard(st: map_shard.ShardedIcpTarget, me: int) -> dict:
    """This rank's shard: the global voxel coords of its grid keys, which of
    them answer (plane_valid), and the slab bookkeeping."""
    coords = voxel.key_to_coords(st.target.grid.voxel_keys)
    live = st.target.grid.voxel_keys != voxel.INVALID_KEY
    gx = coords[:, 0] + st.kx[me]
    return {"coords": torch.stack([gx, coords[:, 1], coords[:, 2]], 1)[live].numpy(),
            "valid": st.target.plane_valid[live].numpy(),
            "lo": st.lo.numpy(), "hi": st.hi.numpy(), "kx": st.kx.numpy(),
            "overflow": st.overflow.numpy()}


def _ndt_shard(sm: map_shard.ShardedNdtMap) -> dict:
    live = sm.map.keys != voxel.INVALID_KEY
    m = sm.map
    return {"keys": m.keys[live].numpy(), "count": m.count[live].numpy(),
            "mean": m.mean[live].numpy(), "cov": m.cov[live].numpy(),
            "estimated": m.estimated[live].numpy(), "age": m.age[live].numpy(),
            "lo": sm.lo.numpy(), "hi": sm.hi.numpy(), "overflow": sm.overflow.numpy()}


def _single_matchers(case: dict) -> dict:
    """The single-device matches of `_matchers`, for the one-rank mesh to
    be held to bit for bit in the same process."""
    tgt, src = _pc(*case["tgt"]), _pc(*case["src"])
    eye, z = torch.eye(3), torch.zeros(3)
    iopts = icp.IcpOptions(method="p2plane_vox")
    dopts = ndt.NdtOptions(voxel_size=2.0, method="direct")
    nopts = ndt.NdtOptions(**case["ndt_inc_opts"])
    m = ndt.empty_incremental(nopts, device=DEV)
    for w in ("w0", "w1"):
        m = ndt.update_incremental(m, _pc(*case[w]), nopts)
    R0, t0 = (torch.from_numpy(case["pose2"][k]) for k in ("R", "t"))
    return {"icp": _np(icp.scan_match(icp.set_target(tgt, iopts), iopts, src, eye, z)),
            "ndt_direct": _np(ndt.scan_match(ndt.build_direct(tgt, dopts), dopts, src, eye, z)),
            "ndt_inc": _np(ndt.scan_match(m, nopts, _pc(*case["scan2"]), R0, t0))}


def _matchers(mesh, case: dict) -> dict:
    """The sharded targets, maps and matches of test_map_shard.py: shards
    of 4,096 points (one shard holds the whole 8,192-point target)."""
    me = mesh_mod.axis_index(mesh, "mp")
    tgt, src = _pc(*case["tgt"]), _pc(*case["src"])
    cap = 4096 if mesh_mod.axis_size(mesh, "mp") > 1 else tgt.capacity
    eye, z = torch.eye(3), torch.zeros(3)
    out = {"single": _single_matchers(case)} if mesh.size() == 1 else {}
    iopts = icp.IcpOptions(method="p2plane_vox")
    st = map_shard.set_target_sharded(mesh, tgt, iopts, shard_capacity=cap)
    out["icp_shard"] = _icp_shard(st, me)
    out["icp"] = _np(map_shard.icp_scan_match_sharded(mesh, st, iopts, src, eye, z))
    out["icp_overflow_512"] = map_shard.set_target_sharded(
        mesh, tgt, iopts, shard_capacity=512).overflow.numpy()
    dopts = ndt.NdtOptions(voxel_size=2.0, method="direct")
    sm = map_shard.build_direct_sharded(mesh, tgt, dopts, shard_capacity=cap)
    out["ndt_direct_overflow"] = sm.overflow.numpy()
    out["ndt_direct"] = _np(map_shard.ndt_scan_match_sharded(mesh, sm, dopts, src, eye, z))
    nopts = ndt.NdtOptions(**case["ndt_inc_opts"])
    sm = map_shard.build_incremental_sharded(mesh, _pc(*case["w0"]), nopts)
    sm = map_shard.update_incremental_sharded(mesh, sm, _pc(*case["w1"]), nopts)
    out["ndt_inc_shard"] = _ndt_shard(sm)
    R0, t0 = (torch.from_numpy(case["pose2"][k]) for k in ("R", "t"))
    out["ndt_inc"] = _np(map_shard.ndt_scan_match_sharded(mesh, sm, nopts, _pc(*case["scan2"]),
                                                          R0, t0))
    dR, dt = (torch.from_numpy(case["correction"][k]) for k in ("R", "t"))
    out["corrected_shard"] = _ndt_shard(map_shard.apply_correction_sharded(mesh, sm, dR, dt,
                                                                           nopts))
    if "ndt_inc_carried" in case:
        # the JAX engine's shards corrected by the port: the correction's
        # own arithmetic, without the build's
        fr = case["ndt_inc_carried"]
        sm = map_shard.ShardedNdtMap(map=convert.ndt_map_from_numpy(fr["shards"][me], DEV),
                                     lo=_t(fr["lo"]), hi=_t(fr["hi"]), overflow=_t(fr["overflow"]))
        out["carried_corrected_shard"] = _ndt_shard(
            map_shard.apply_correction_sharded(mesh, sm, dR, dt, nopts))
    return out


def lio_options(kw: dict) -> lio.LioOptions:
    """The LIO options of a case: matcher ndt_inc with the NdtOptions
    fields in kw["ndt"], the LioOptions fields in the rest."""
    kw = dict(kw)
    return lio.LioOptions(ndt=ndt.NdtOptions(**kw.pop("ndt")), **kw)


def loc_options(kw: dict) -> loc.LocOptions:
    kw = dict(kw)
    return loc.LocOptions(icp=icp.IcpOptions(**kw.pop("icp")), **kw)


def slam_options(kw: dict) -> slam3d.Slam3dOptions:
    kw = dict(kw)
    return slam3d.Slam3dOptions(lio=lio_options(kw.pop("lio")),
                                sc=sc.ScanContextOptions(**kw.pop("sc")),
                                loop=slam3d.LoopOptions(**kw.pop("loop")),
                                loop_icp=icp.IcpOptions(**kw.pop("loop_icp")), **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _imu(fr: dict):
    return [_t(fr[k]) for k in ("imu_gyro", "imu_acce", "imu_stamp", "imu_valid")]


def _step_out(res) -> dict:
    return {"R": res.R.numpy(), "t": res.t.numpy(), "converged": bool(res.converged),
            "num_effective": int(res.num_effective), "chi2": float(res.chi2)}


def _lio_state(f: dict) -> lio_sharded.LioShardedState:
    """A LioShardedState from the JAX engine's state as numpy."""
    return lio_sharded.LioShardedState(
        **{k: _t(f[k]) for k in ("R", "t", "last_R", "last_t", "last_kf_R", "last_kf_t",
                                 "R_il", "t_il")},
        num_kfs=int(f["num_kfs"]), frame_idx=int(f["frame_idx"]),
        eskf=convert.eskf_state_from_numpy(f["eskf"], DEV))


def _ndt_sharded(fr: dict, me: int) -> map_shard.ShardedNdtMap:
    """This rank's shard (me along "mp") of the JAX engine's sharded map."""
    return map_shard.ShardedNdtMap(map=convert.ndt_map_from_numpy(fr["shards"][me], DEV),
                                   lo=_t(fr["lo"]), hi=_t(fr["hi"]), overflow=_t(fr["overflow"]))


def _lio_carried(mesh, case: dict) -> list:
    """One sharded LIO step per frame, from the JAX engine's replicated
    state and this rank's shard of its map before the frame; on a keyframe
    the shard absorbs the scan and every shard's live count comes back."""
    me = mesh_mod.axis_index(mesh, "mp")
    opts = lio_options(case["lio_opts"])
    out = []
    for fr in case["lio_carried"]:
        state, sm = _lio_state(fr["state"]), _ndt_sharded(fr, me)
        scan = _pc(*fr["scan"])
        _, res = lio_sharded.step_measure(mesh, sm, state, scan, *_imu(fr), opts)
        rec = dict(_step_out(res), is_keyframe=res.is_keyframe, iterations=res.iterations)
        if res.is_keyframe:
            sm = map_shard.update_incremental_sharded(
                mesh, sm, lio._world_scan(scan.xyz, scan.mask, res.R, res.t), opts.ndt_inc)
            rec["live"] = map_shard.live_voxels(mesh, sm).numpy()
        out.append(rec)
    return out


def _loc_carried(mesh, case: dict) -> list:
    """One sharded Loc step per frame, from the JAX engine's replicated state
    and this rank's shard of its target before the frame."""
    me = mesh_mod.axis_index(mesh, "mp")
    opts = loc_options(case["loc_opts"])
    out = []
    for fr in case["loc_carried"]:
        state = convert.loc_state_from_numpy(fr["state"], DEV)
        st = map_shard.ShardedIcpTarget(
            target=convert.icp_target_from_numpy(fr["shards"][me], DEV),
            **{k: _t(fr[k]) for k in ("lo", "hi", "kx", "overflow")})
        _, res = loc_sharded.step_measure(mesh, st, state, _pc(*fr["scan"]), *_imu(fr), opts)
        out.append(dict(_step_out(res), need_recrop=bool(res.need_recrop)))
    return out


def _drive(eng, log, imu_init: int, step):
    for t, g, a in zip(log.imu.stamps[:imu_init], log.imu.gyro[:imu_init],
                       log.imu.acce[:imu_init]):
        eng.init_imu(g, a, t)
    for mg in log.measures(imu_capacity=64):
        step(log.frame(mg.scan_index, "cpu"), *[_t(x) for x in (
            mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)])


def _lio_free(mesh, case: dict) -> dict:
    """LioSharded over a demo log: poses, keyframes, live voxels per shard."""
    log = logdir.make_demo_log(**case["lio_log"])
    eng = lio_sharded.LioSharded(mesh, lio_options(case["lio_opts"]), device=DEV)
    _drive(eng, log, 150, eng.add_measure)
    out = {"poses": np.stack(eng.poses), "kf_poses": eng.keyframe_poses(),
           "live": eng.live_voxels_per_shard(), "health": eng.health.status}
    if mesh.size() == 1:        # the single-device engine, in this process
        one = lio.Lio(lio_options(case["lio_opts"]), device=DEV)
        _drive(one, log, 150, one.add_measure)
        out["single_poses"] = np.stack(one.poses)
        out["single_kf_poses"] = one.keyframe_poses()
    return out


def _loc_free(mesh, case: dict) -> dict:
    """LocSharded over a demo log against its world."""
    log = logdir.make_demo_log(**case["loc_log"])
    world = case["loc_world"]
    eng = loc_sharded.LocSharded(mesh, world, loc_options(case["loc_opts"]),
                                 shard_capacity=case["loc_shard_capacity"], device=DEV)
    mgs = list(log.measures(imu_capacity=64))
    T0 = log.gt_poses[mgs[0].scan_index]
    eng.set_init_pose(T0[:3, :3], T0[:3, 3])
    overflow = eng.shard_overflow()
    for mg in mgs:
        eng.update_measure(log.frame(mg.scan_index, "cpu"), *[_t(x) for x in (
            mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)])
    return {"poses": np.stack(eng.poses), "overflow": overflow,
            "num_recrops": eng.num_recrops, "health": eng.health.status,
            "first_scan": mgs[0].scan_index}


def _slam_free(mesh, case: dict) -> dict:
    """Slam3dSharded over a loop log: keyframe poses, loops, live voxels."""
    log = logdir.make_demo_log(**case["slam_log"])
    eng = Slam3dSharded(mesh, slam_options(case["slam_opts"]), device=DEV)
    _drive(eng, log, 150, eng.add_measure)
    return {"kf_t": np.stack(eng.kf_t), "kf_frame": np.array(eng.kf_frame),
            "loops": len(eng.loops), "loop_pairs": [(l.i, l.j) for l in eng.loops],
            "live": eng.live_voxels_per_shard(),
            "inliers": None if eng.loop_inliers is None else eng.loop_inliers.copy()}


def _slam_carried(mesh, case: dict) -> dict:
    """Slam3dSharded.optimize() on the JAX engine's state before its last
    pose-graph solve: its keyframe poses and loop edges, its front end's
    state and this rank's shard of its map. Returns the optimized poses,
    the loop inliers, the corrected front-end state and map shard."""
    fr = case["slam_carried"]
    eng = Slam3dSharded(mesh, slam_options(case["slam_opts"]), device=DEV)
    eng.kf_R, eng.kf_t = list(fr["kf_R"]), list(fr["kf_t"])
    eng.loops = [slam3d.LoopEdge(*edge) for edge in fr["loops"]]
    eng.lio.state = _lio_state(fr["state"])
    eng.lio.sm = _ndt_sharded(fr, mesh_mod.axis_index(mesh, "mp"))
    assert eng.optimize()
    st = eng.lio.state
    return {"kf_R": np.stack(eng.kf_R), "kf_t": np.stack(eng.kf_t),
            "inliers": eng.loop_inliers.copy(),
            "state": {k: getattr(st, k).numpy() for k in ("R", "t", "last_kf_R", "last_kf_t")},
            "shard": _ndt_shard(eng.lio.sm), "live": eng.live_voxels_per_shard()}


def _lio_imbalance(mesh, case: dict) -> dict:
    """LioSharded (ndt_inc, no ESKF) on the exploring corridor, its slab
    imbalance checked every 4 keyframes: positions, warnings, live voxels."""
    eng = lio_sharded.LioSharded(mesh, lio_options(case["imbalance_opts"]), device=DEV)
    eng.imbalance_check_every = 4
    z, s, v = np.zeros((4, 3), np.float32), np.zeros(4), np.zeros(4, bool)
    ts = [eng.add_measure(_pc(xyz, mask), z, z, s, v).t.numpy()
          for xyz, mask in zip(case["corridor_xyz"], case["corridor_mask"])]
    return {"t": np.stack(ts), "warnings": list(eng.imbalance_warnings),
            "live": eng.live_voxels_per_shard(), "warn_ratio": eng.imbalance_warn_ratio}


def map_shard_case(case: dict) -> dict:
    """Every scenario the case names, on a case["mesh"] = (dp, mp) mesh;
    the seconds each took come back under "seconds"."""
    mesh = mesh_mod.make_mesh_2d(*case["mesh"])
    out = dict(_rank(), mp_index=mesh_mod.axis_index(mesh, "mp"), seconds={})
    for name, fn in (("matchers", _matchers), ("lio_carried", _lio_carried),
                     ("loc_carried", _loc_carried), ("lio_free", _lio_free),
                     ("loc_free", _loc_free), ("slam_free", _slam_free),
                     ("slam_carried", _slam_carried), ("lio_imbalance", _lio_imbalance)):
        if name in case["run"]:
            t0 = time.perf_counter()
            out[name] = fn(mesh, case)
            out["seconds"][name] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# parallel/multihost.py: two processes set up from the environment
# ---------------------------------------------------------------------------

def multihost_main(store: str, out_path: str) -> None:
    """One of two ranks that join through `multihost.init` (RANK and
    WORLD_SIZE from the environment, the file store given): a psum over the
    global mesh, a DTensor assembled from each process's rows, the sharded
    voxel-plane match with the map split over "mp" ACROSS the two
    processes, and one sharded Loc step. Writes its results to out_path."""
    import pickle

    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    assert multihost.init(init_method=store, device="cpu")
    try:
        assert multihost.is_multiprocess() and dist.get_world_size() == 2
        mesh = multihost.global_mesh(dp=1, mp=2)
        pid = dist.get_rank()
        out = {"rank": pid, "mp_index": mesh_mod.axis_index(mesh, "mp")}
        local = np.arange(2 * pid, 2 * pid + 2, dtype=np.float32).reshape(2, 1)
        g = multihost.host_local_to_global(mesh, local)
        out["global_shape"] = tuple(g.shape)
        out["global_sum"] = float(g.full_tensor().sum())
        out["psum"] = float(mesh_mod.psum(torch.tensor([float(pid + 1)]), mesh))

        world = synthetic.make_world(num_points=20000, extent=30.0, seed=3)
        traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
        scans = [synthetic.render_scan(world, traj.R[k], traj.t[k], max_points=2048,
                                       noise=0.005, seed=k, capacity=2048, device=DEV)
                 for k in range(2)]
        opts = icp.IcpOptions(method="p2plane_vox", max_iteration=10, plane_min_pts=3,
                              max_plane_distance=0.5)
        st = map_shard.set_target_sharded(mesh, scans[0], opts, shard_capacity=2048)
        res = map_shard.icp_scan_match_sharded(mesh, st, opts, scans[1], torch.eye(3),
                                               torch.zeros(3))
        out["t"] = res.t.numpy()
        out["t_rel"] = traj.R[0].T @ (traj.t[1] - traj.t[0])
        out["overflow"] = st.overflow.numpy()

        lopts = loc.LocOptions(icp=opts, local_map_capacity=8192, box_size=40.0,
                               recrop_margin=10.0)
        eng = loc_sharded.LocSharded(mesh, np.asarray(world, np.float32), lopts,
                                     shard_capacity=4096, device=DEV)
        eng.set_init_pose(traj.R[0], traj.t[0])
        step = eng.update_measure(scans[1], torch.zeros((8, 3)),
                                  torch.tensor([[0.0, 0.0, 9.81]]).repeat(8, 1),
                                  torch.linspace(0.0, 0.07, 8),
                                  torch.ones((8,), dtype=torch.bool))
        out["loc_t"] = step.t.numpy()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def failing_rank() -> None:
    """Rank 1 raises; rank 0 waits at a collective it never completes."""
    if dist.get_rank() == 1:
        raise RuntimeError("this rank fails on purpose")
    dist.barrier()


def one_rank_group_case(case: dict) -> dict:
    """In a world of one rank: the pose graph's assembly and PCG solve with
    group=WORLD (an all-reduce that adds nothing) against group=None, and
    the GN loops' reduction hook of a 1-rank mesh (None: no collective)."""
    R0, t0 = torch.from_numpy(case["R_est"]), torch.from_numpy(case["t_est"])
    edges = pg.edges_to(_edges(case["edges_good"]), DEV)
    m = R0.shape[0]
    seg = pg.edge_segments(edges.i, edges.j, m)
    out = {}
    for name, group in (("none", None), ("world", dist.group.WORLD)):
        Hd, Hij, b, chi2 = pg._assemble_blocks(R0, t0, edges, pg.PgoOptions(), m, seg,
                                               group=group)
        dx, n = pg.solve_pcg(Hd, Hij, edges.i, edges.j, b, m, 50, 1e-7, seg, group=group)
        out[name] = {"Hdiag": Hd.numpy(), "b": b.numpy(), "dx": dx.numpy(), "n": int(n)}
    out["hook"] = pmatch.psum_terms(mesh_mod.make_mesh(1), ("dp", "mp"))
    return out


def sharded_apps_case(case: dict) -> dict:
    """The mapping and matching apps with --mp-shards at the world size, on
    the logs and options the test passes (one out dir per rank, so a dir a
    rank must not write can be checked). Returns each app's report and its
    KITTI trajectory where this rank wrote one."""
    import os

    from loc_lib_tpu_torch.apps.mapping import run_mapping
    from loc_lib_tpu_torch.apps.matching import run_matching
    from loc_lib_tpu_torch.io import trajectory

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {"rank": rank}
    for app, run in (("mapping", lambda d: run_mapping(
                          case["map_log"], lio_options(case["lio_opts"]), d,
                          mp_shards=world, device=DEV)),
                     ("matching", lambda d: run_matching(
                          case["loc_log"], case["world"], loc_options(case["loc_opts"]), d,
                          init_pose=case["loc_log"].gt_poses[0], mp_shards=world,
                          device=DEV))):
        d = os.path.join(case["out"], f"{app}_rank{rank}")
        out[app] = run(d)
        path = os.path.join(d, "trajectory_kitti.txt")
        out[app + "_poses"] = trajectory.load_kitti(path) if os.path.exists(path) else None
        out[app + "_dir_exists"] = os.path.isdir(d)
    return out
