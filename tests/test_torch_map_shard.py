"""Port parity: loc_lib_tpu_torch.parallel.map_shard and the sharded pipelines
(pipeline/loc_sharded.py, lio_sharded.py, slam3d_sharded.py) against the JAX
package, on tests/test_map_shard.py's workloads.

The port runs in spawned CPU processes joined over gloo, one rank each
(`multihost.launch`, rank functions in tests/test_torch_dist_workers.py), on
(dp, mp) meshes of (2, 2), (1, 4) and (1, 1); JAX runs its shard_map
programs on the same mesh shapes of the conftest's CPU devices. One launch
per mesh shape runs every scenario of that shape (module-scoped fixture),
plus one at (2, 2) for the free runs, which need nothing from JAX and so
start at once; the tests assert on their results, one case per scenario
and shape.

Stated tolerances:
  * slab bounds (lo, hi, kx), overflow counts and each slab's points: equal
    to JAX's (integers and selected rows exact);
  * the sharded ICP target: each shard's voxel keys and which of them answer
    (plane_valid) equal to JAX's shard, every voxel answered on one shard
    only;
  * the incremental NDT shards (before the correction, rows with the bits
    of the port's single-device map) and the correction written through
    them (the port's own shards and JAX's carried across): keys, counts,
    ages and flags equal to JAX's, means and covariances within the
    raw-moment rounding at the voxel's range, per row 8 u |mu| and
    16 u (|mu|^2 + max |cov|), u = 2^-24 (ROADMAP.md section 3);
  * sharded matches: the pose within 2e-3 of the port's single-device
    `scan_match` (test_map_shard.py's bound; measured under 3e-8) and no
    farther from JAX's sharded pose than the port's single-device pose is
    from JAX's single-device one, plus 1e-5; iterations equal to JAX's,
    effective counts equal to the single-device count and as far from
    JAX's as it is;
  * at (1, 1) the sharded matchers and LioSharded give the bits of the
    port's single-device scan_match / Lio(ndt_inc), run in the same
    process (the CPU's sums depend on the thread count): the sharded ICP's
    election outside the kernel followed by K1 plane given, on a plane
    table keyed from the slab's own origin, gives K2's bits;
  * one LioSharded / LocSharded step on a state and map shard carried across
    from the JAX engine: keyframe flags, iterations and counts equal, poses
    within 1e-5 m / 1e-5 rad, chi2 within rtol 1e-4 (the single-device
    carried-state bounds of test_torch_lio.py / test_torch_loc.py); every
    shard's live voxel count after a keyframe equal to JAX's;
  * free runs against the port's single-device engines, test_map_shard.py's
    bounds: LioSharded within 0.02 m of Lio(ndt_inc) with the live map
    larger than one shard's table and no shard full; LocSharded within 0.02
    m of Loc; Slam3dSharded closes loops and stays within 0.15 m of Slam3d,
    keyframe ATE < 0.25 m;
  * Slam3dSharded against JAX's at (2, 2) (test_torch_slam3d.py's rules):
    the free runs keep the same keyframes, loop pairs and inlier mask,
    keyframes within 0.02 m; optimize() on JAX's state before its last
    pose-graph solve gives the same inlier mask, keyframe and front-end
    poses within twice JAX's own 1-ulp sensitivity, and the map corrected
    through the shards with JAX's keys, counts, ages and flags (moments
    within the raw-moment bounds below plus the corrections' difference);
  * every rank returns the same poses, bit for bit.
"""
import concurrent.futures
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.graph import scan_context as jsc
from loc_lib_tpu.io import synthetic as jsynthetic
from loc_lib_tpu.models import icp as jicp, ndt as jndt
from loc_lib_tpu.ops import pointcloud as jpc
from loc_lib_tpu.ops.pointcloud import PointCloud as JPointCloud, PAD_COORD
from loc_lib_tpu.parallel import map_shard as jmap_shard, mesh as jmesh
from loc_lib_tpu.pipeline import lio as jlio, lio_sharded as jlio_sharded
from loc_lib_tpu.pipeline import loc as jloc, loc_sharded as jloc_sharded
from loc_lib_tpu.pipeline import slam3d as jslam
from loc_lib_tpu.pipeline.slam3d_sharded import Slam3dSharded as JSlam3dSharded
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.io import logdir
from loc_lib_tpu_torch.models import icp, ndt
from loc_lib_tpu_torch.ops import voxel
from loc_lib_tpu_torch.ops.pointcloud import PointCloud
from loc_lib_tpu_torch.parallel import map_shard, multihost
from loc_lib_tpu_torch.pipeline import lio, loc, slam3d
import oracles
import test_torch_dist_workers as workers

torch.set_num_threads(2)
TESTS = pathlib.Path(__file__).resolve().parent
MESHES = ((2, 2), (1, 4))
CAP = 8192
# the incremental NDT map of test_map_shard.py:117 (dense window 128 x 128 x
# 64 m: the 60 m world)
NDT_INC = dict(voxel_size=2.0, method="incremental", map_capacity=16384, dense_dims=(64, 64, 32))
U = 2.0 ** -24

# the sharded pipelines' configurations, one dict for both packages
LIO_LOG = dict(num_frames=14, capacity=4096, yaw_rate=0.0, speed=2.0, world_points=60000,
               extent=40.0, max_range=35.0)
LIO_OPTS = dict(matcher="ndt_inc", scan_capacity=4096, with_eskf=True, kf_distance=0.5,
                ndt=dict(method="incremental", voxel_size=1.0, map_capacity=4096,
                         dense_dims=(128, 128, 32)))
LIO_CARRIED = (2, 3, 4)               # measure groups stepped from a carried state
# test_map_shard.py:307-338: the exploring corridor, 80 frames, no ESKF
IMBALANCE_FRAMES = 80
IMBALANCE_OPTS = dict(with_eskf=False, kf_distance=0.4, ndt={})
LOC_LOG = dict(num_frames=8, capacity=2048, yaw_rate=0.0, speed=2.0, world_points=20000,
               extent=60.0, max_range=35.0)
LOC_OPTS = dict(local_map_capacity=32768, box_size=120.0, recrop_margin=50.0,
                icp=dict(method="p2plane_vox", dense_dims=(128, 128, 32)))
LOC_SHARD_CAPACITY = 16384            # < the crop's 20,000 points: no one shard holds it
LOC_CARRIED = (1, 2, 3)
SLAM_LOG = dict(num_frames=40, capacity=2048, dt=0.2, speed=1.4, yaw_rate=0.72,
                world_points=60000, extent=16.0, max_range=14.0)
SLAM_OPTS = dict(
    lio=dict(LIO_OPTS, scan_capacity=2048, kf_distance=0.4,
             ndt=dict(method="incremental", voxel_size=1.0, map_capacity=1024)),
    sc=dict(exclude_recent=8, dist_threshold=0.3),
    loop=dict(min_keyframe_gap=8, max_candidate_dist=10.0, min_effective_pts=60,
              max_chi2_per_pt=0.1, optimize_every=1),
    loop_icp=dict(method="p2plane", max_iteration=20, max_plane_distance=0.5, grid_leaf=2.0,
                  bucket_size=8),
    warm_start=False)


def _jopts(kw, mod, ndt_mod):
    kw = dict(kw)
    return mod.LioOptions(ndt=ndt_mod.NdtOptions(**kw.pop("ndt")), **kw)


def _plain(x):
    """A JAX pytree of NamedTuples as nested dicts of numpy arrays (what a
    rank process unpickles without the JAX package)."""
    if x is None:
        return None
    if hasattr(x, "_asdict"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _take(d, s):
    """Shard s of a plain pytree whose leaves carry a leading mp axis."""
    if d is None:
        return None
    if isinstance(d, dict):
        return {k: _take(v, s) for k, v in d.items()}
    return d[s]


def _jcloud(xyz, mask):
    return JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask))


def _cloud(xyz, mask):
    return PointCloud(xyz=torch.from_numpy(np.array(xyz)), mask=torch.from_numpy(np.array(mask)))


def _world_scan(xyz, mask, R, t):
    w = xyz @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    return np.where(mask[:, None], w, PAD_COORD).astype(np.float32), mask


def _measure_dict(mg) -> dict:
    return {k: np.asarray(getattr(mg, k)) for k in ("imu_gyro", "imu_acce", "imu_stamp",
                                                    "imu_valid")}


def _jimu(mg):
    return [jnp.asarray(getattr(mg, k)) for k in ("imu_gyro", "imu_acce", "imu_stamp",
                                                  "imu_valid")]


def _pose_gap(Ra, ta, Rb, tb):
    rot = np.linalg.norm(oracles.so3_log(np.asarray(Ra, np.float64).T
                                         @ np.asarray(Rb, np.float64)))
    return float(np.linalg.norm(np.asarray(ta) - np.asarray(tb))), rot


# ---------------------------------------------------------------------------
# Inputs and the JAX package's results
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    """test_map_shard.py's pair (8,192-point target and source), its three
    4,096-point incremental scans and a rigid correction."""
    world = jsynthetic.make_world(num_points=20000, extent=60.0, seed=3)
    traj = jsynthetic.make_trajectory(num_frames=3, dt=0.1, speed=2.0)
    scan = lambda k, cap: jsynthetic.render_scan(world, traj.R[k], traj.t[k], max_points=cap,
                                                 noise=0.005, seed=k, capacity=cap)
    pair = [(np.asarray(s.xyz), np.asarray(s.mask)) for s in (scan(0, CAP), scan(1, CAP))]
    inc = [(np.asarray(s.xyz), np.asarray(s.mask)) for s in (scan(k, 4096) for k in range(3))]
    dR = np.asarray(jlie.so3_exp(jnp.array([0.01, -0.02, 0.05], jnp.float32)))
    return {"tgt": pair[0], "src": pair[1],
            "gt_t": traj.R[0].T @ (traj.t[1] - traj.t[0]),
            "w0": _world_scan(*inc[0], traj.R[0], traj.t[0]),
            "w1": _world_scan(*inc[1], traj.R[1], traj.t[1]),
            "scan2": inc[2],
            "pose2": {"R": np.asarray(traj.R[2], np.float32),
                      "t": np.asarray(traj.t[2], np.float32)},
            "correction": {"R": dR, "t": np.array([0.3, -0.2, 0.05], np.float32)},
            "ndt_inc_opts": NDT_INC}


def _jax_matchers(data, shape):
    m = jmesh.make_mesh_2d(*shape)
    tgt, src = _jcloud(*data["tgt"]), _jcloud(*data["src"])
    eye, z = jnp.eye(3), jnp.zeros(3)
    iopts = jicp.IcpOptions(method="p2plane_vox")
    st = jmap_shard.set_target_sharded(m, tgt, iopts, shard_capacity=4096)
    dopts = jndt.NdtOptions(voxel_size=2.0, method="direct")
    dsm = jmap_shard.build_direct_sharded(m, tgt, dopts, shard_capacity=4096)
    nopts = jndt.NdtOptions(**NDT_INC)
    sm = jmap_shard.build_incremental_sharded(m, _jcloud(*data["w0"]), nopts)
    sm = jmap_shard.update_incremental_sharded(m, sm, _jcloud(*data["w1"]), nopts)
    cor = jmap_shard.apply_correction_sharded(m, sm, data["correction"]["R"],
                                              data["correction"]["t"], nopts)
    return {
        "icp_target": st, "icp": jmap_shard.icp_scan_match_sharded(m, st, iopts, src, eye, z),
        "icp_overflow_512": np.asarray(jmap_shard.set_target_sharded(
            m, tgt, iopts, shard_capacity=512).overflow),
        "ndt_direct_overflow": np.asarray(dsm.overflow),
        "ndt_direct": jmap_shard.ndt_scan_match_sharded(m, dsm, dopts, src, eye, z),
        "ndt_inc_map": sm,
        "ndt_inc_carried": dict(shards=[_take(_plain(sm.map), s) for s in range(shape[1])],
                                lo=np.asarray(sm.lo), hi=np.asarray(sm.hi),
                                overflow=np.asarray(sm.overflow)),
        "ndt_inc": jmap_shard.ndt_scan_match_sharded(m, sm, nopts, _jcloud(*data["scan2"]),
                                                     data["pose2"]["R"], data["pose2"]["t"]),
        "corrected": cor}


def _lio_carried(shape):
    """The JAX LioSharded's state and map shards before each of LIO_CARRIED's
    measure groups, the groups themselves, and its step outputs on them."""
    log = logdir.make_demo_log(**LIO_LOG)
    eng = jlio_sharded.LioSharded(jmesh.make_mesh_2d(*shape), _jopts(LIO_OPTS, jlio, jndt))
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    frames, outs = [], []
    for k, mg in enumerate(log.measures(imu_capacity=64)):
        if k > max(LIO_CARRIED):
            break
        scan = (log.scan_xyz[mg.scan_index], log.scan_mask[mg.scan_index])
        if k in LIO_CARRIED:
            sm = _plain(eng.sm)
            frames.append(dict(_measure_dict(mg), scan=scan, state=_plain(eng.state),
                               shards=[_take(sm["map"], s) for s in range(shape[1])],
                               lo=sm["lo"], hi=sm["hi"], overflow=sm["overflow"]))
        out = eng.add_measure(_jcloud(*scan), *_jimu(mg))
        if k in LIO_CARRIED:
            outs.append({"out": out, "live": eng.live_voxels_per_shard()})
    return frames, outs


def _loc_world():
    return jsynthetic.make_world(num_points=LOC_LOG["world_points"], extent=LOC_LOG["extent"],
                                 seed=0)


def _loc_carried(shape):
    """The same for JAX's LocSharded over LOC_CARRIED's measure groups."""
    log = logdir.make_demo_log(**LOC_LOG)
    kw = dict(LOC_OPTS)
    opts = jloc.LocOptions(icp=jicp.IcpOptions(**kw.pop("icp")), scan_capacity=2048, **kw)
    eng = jloc_sharded.LocSharded(jmesh.make_mesh_2d(*shape), np.asarray(_loc_world()), opts,
                                  shard_capacity=LOC_SHARD_CAPACITY)
    mgs = list(log.measures(imu_capacity=64))
    T0 = log.gt_poses[mgs[0].scan_index]
    eng.set_init_pose(T0[:3, :3], T0[:3, 3])
    frames, outs = [], []
    for k, mg in enumerate(mgs[:max(LOC_CARRIED) + 1]):
        scan = (log.scan_xyz[mg.scan_index], log.scan_mask[mg.scan_index])
        if k in LOC_CARRIED:
            st = _plain(eng.target)
            frames.append(dict(_measure_dict(mg), scan=scan, state=_plain(eng.state),
                               shards=[_take(st["target"], s) for s in range(shape[1])],
                               lo=st["lo"], hi=st["hi"], kx=st["kx"], overflow=st["overflow"]))
        out = eng.update_measure(_jcloud(*scan), *_jimu(mg))
        if k in LOC_CARRIED:
            outs.append(out)
    return frames, outs


def _jslam_opts() -> jslam.Slam3dOptions:
    kw = dict(SLAM_OPTS)
    return jslam.Slam3dOptions(lio=_jopts(kw.pop("lio"), jlio, jndt),
                               sc=jsc.ScanContextOptions(**kw.pop("sc")),
                               loop=jslam.LoopOptions(**kw.pop("loop")),
                               loop_icp=jicp.IcpOptions(**kw.pop("loop_icp")), **kw)


def _slam_snapshot(eng):
    """A copy of a JAX Slam3dSharded that optimize() can change without
    touching `eng` (its arrays are immutable; the lists are copied)."""
    s = copy.copy(eng)
    s.__dict__.pop("optimize", None)
    for k in ("kf_R", "kf_t", "kf_frame", "loops"):
        setattr(s, k, list(getattr(eng, k)))
    s.lio = copy.copy(eng.lio)
    return s


def _slam_carried(shape):
    """JAX's Slam3dSharded free run over SLAM_LOG; a copy of it taken just
    before its last optimize(), that copy optimized, and the same with its
    keyframe poses nudged by one ulp; the copy as numpy for the ranks."""
    log = logdir.make_demo_log(**SLAM_LOG)
    eng = JSlam3dSharded(jmesh.make_mesh_2d(*shape), _jslam_opts())
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    before = []
    optimize = eng.optimize

    def spy():
        before[:] = [_slam_snapshot(eng)]
        return optimize()

    eng.optimize = spy
    for mg in log.measures(imu_capacity=64):
        eng.add_measure(_jcloud(log.scan_xyz[mg.scan_index], log.scan_mask[mg.scan_index]),
                        *_jimu(mg))
    pre = before[0]
    done, nudged = _slam_snapshot(pre), _slam_snapshot(pre)
    nudged.kf_R = [np.nextafter(r, np.float32(np.inf)) for r in pre.kf_R]
    nudged.kf_t = [np.nextafter(t, np.float32(np.inf)) for t in pre.kf_t]
    assert done.optimize() and nudged.optimize()
    sm = _plain(pre.lio.sm)
    carried = dict(kf_R=[np.asarray(r) for r in pre.kf_R], kf_t=[np.asarray(t) for t in pre.kf_t],
                   loops=[(int(l.i), int(l.j), np.asarray(l.R), np.asarray(l.t),
                           float(l.chi2_per_pt), int(l.num_effective)) for l in pre.loops],
                   state=_plain(pre.lio.state), shards=[_take(sm["map"], s) for s in range(shape[1])],
                   lo=sm["lo"], hi=sm["hi"], overflow=sm["overflow"])
    return {"engine": eng, "pre": pre, "done": done, "nudged": nudged, "carried": carried}


@pytest.fixture(scope="module")
def ref(data):
    out = {shape: _jax_matchers(data, shape) for shape in MESHES}
    out["lio"] = _lio_carried((2, 2))
    out["loc"] = _loc_carried((2, 2))
    out["slam"] = _slam_carried((2, 2))
    return out


# ---------------------------------------------------------------------------
# The port: one launch per mesh shape, and its single-device engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port(data, request):
    """The launches run side by side, with the JAX package's and the port's
    single-device work of this process in between: the (1, 1) launch and
    the (2, 2) free runs need nothing from JAX, the others carry its states
    across."""
    base = dict(data, lio_opts=LIO_OPTS, lio_log=LIO_LOG, loc_opts=LOC_OPTS, loc_log=LOC_LOG,
                loc_world=np.asarray(_loc_world()), loc_shard_capacity=LOC_SHARD_CAPACITY,
                slam_log=SLAM_LOG, slam_opts=SLAM_OPTS)

    def launch(case):
        shape = case["mesh"]
        return multihost.launch("test_torch_dist_workers:map_shard_case", shape[0] * shape[1],
                                (case,), device="cpu", extra_paths=[TESTS])

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        runs = {(1, 1): pool.submit(launch, dict(
            base, mesh=(1, 1), run=("matchers", "lio_free"),
            lio_opts=dict(LIO_OPTS, ndt=dict(LIO_OPTS["ndt"], map_capacity=65536)))),
            "free": pool.submit(launch, dict(base, mesh=(2, 2), run=("loc_free", "slam_free")))}
        ref = request.getfixturevalue("ref")
        runs[(2, 2)] = pool.submit(launch, dict(
            base, mesh=(2, 2), lio_carried=ref["lio"][0], loc_carried=ref["loc"][0],
            ndt_inc_carried=ref[(2, 2)]["ndt_inc_carried"],
            slam_carried=ref["slam"]["carried"],
            run=("matchers", "lio_carried", "loc_carried", "slam_carried")))
        corridor = request.getfixturevalue("corridor")
        runs[(1, 4)] = pool.submit(launch, dict(
            base, mesh=(1, 4), ndt_inc_carried=ref[(1, 4)]["ndt_inc_carried"],
            corridor_xyz=corridor["xyz"], corridor_mask=corridor["mask"],
            imbalance_opts=IMBALANCE_OPTS, run=("matchers", "lio_free", "lio_imbalance")))
        request.getfixturevalue("single")
        request.getfixturevalue("jax_single")
        request.getfixturevalue("jax_imbalance")
        out = {key: f.result() for key, f in runs.items()}
    for r, free in zip(out[(2, 2)], out.pop("free")):
        r.update(loc_free=free["loc_free"], slam_free=free["slam_free"])
    return out


@pytest.fixture(scope="module")
def corridor():
    """The reference's exploring-corridor scans (tests/test_pipeline.py's
    generators, one rng for the world and the scans' noise) as numpy, and
    the true positions."""
    from tests.test_pipeline import _corridor_scan, _pillar_corridor

    rng = np.random.default_rng(0)
    world = _pillar_corridor(rng)
    t = np.array([[0.45 * k, 0.0, 0.0] for k in range(IMBALANCE_FRAMES)], np.float32)
    clouds = [_corridor_scan(world, tk, rng) for tk in t]
    return {"t": t, "xyz": np.stack([np.asarray(c.xyz) for c in clouds]),
            "mask": np.stack([np.asarray(c.mask) for c in clouds])}


@pytest.fixture(scope="module")
def jax_imbalance(corridor):
    """JAX's LioSharded on the corridor at mp = 4, dp = 1."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("mp", "dp"))
    eng = jlio_sharded.LioSharded(mesh, _jopts(IMBALANCE_OPTS, jlio, jndt))
    eng.imbalance_check_every = 4
    z, s, v = np.zeros((4, 3), np.float32), np.zeros(4), np.zeros(4, bool)
    ts = [np.asarray(eng.add_measure(_jcloud(xyz, mask), z, z, s, v).t)
          for xyz, mask in zip(corridor["xyz"], corridor["mask"])]
    return {"t": np.stack(ts), "warnings": list(eng.imbalance_warnings),
            "live": np.asarray(eng.live_voxels_per_shard())}


def _single_lio(map_capacity):
    log = logdir.make_demo_log(**LIO_LOG)
    opts = workers.lio_options(dict(LIO_OPTS, ndt=dict(LIO_OPTS["ndt"],
                                                       map_capacity=map_capacity)))
    eng = lio.Lio(opts, device="cpu")
    workers._drive(eng, log, 150, eng.add_measure)
    return eng


@pytest.fixture(scope="module")
def single(data):
    """The port's single-device engines on the same inputs."""
    tgt, src = _cloud(*data["tgt"]), _cloud(*data["src"])
    eye, z = torch.eye(3), torch.zeros(3)
    iopts = icp.IcpOptions(method="p2plane_vox")
    dopts = ndt.NdtOptions(voxel_size=2.0, method="direct")
    nopts = ndt.NdtOptions(**NDT_INC)
    m = ndt.empty_incremental(nopts, device="cpu")
    for w in ("w0", "w1"):
        m = ndt.update_incremental(m, _cloud(*data[w]), nopts)
    pose2 = [torch.from_numpy(data["pose2"][k]) for k in ("R", "t")]
    out = {"icp": icp.scan_match(icp.set_target(tgt, iopts), iopts, src, eye, z),
           "ndt_direct": ndt.scan_match(ndt.build_direct(tgt, dopts), dopts, src, eye, z),
           "ndt_inc": ndt.scan_match(m, nopts, _cloud(*data["scan2"]), *pose2),
           "ndt_inc_map": m, "lio": _single_lio(65536)}
    log = logdir.make_demo_log(**LOC_LOG)
    eng = loc.Loc(np.asarray(_loc_world()), workers.loc_options(LOC_OPTS), device="cpu")
    mgs = list(log.measures(imu_capacity=64))
    T0 = log.gt_poses[mgs[0].scan_index]
    eng.set_init_pose(T0[:3, :3], T0[:3, 3])
    for mg in mgs:
        eng.update_measure(log.frame(mg.scan_index, "cpu"), *[torch.from_numpy(np.array(x)) for x in (
            mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)])
    out["loc"] = eng
    slog = logdir.make_demo_log(**SLAM_LOG)
    sopts = workers.slam_options(dict(SLAM_OPTS, lio=dict(
        SLAM_OPTS["lio"], ndt=dict(SLAM_OPTS["lio"]["ndt"], map_capacity=16384))))
    seng = slam3d.Slam3d(sopts, device="cpu")
    workers._drive(seng, slog, 150, seng.add_measure)
    out["slam"], out["slam_log"] = seng, slog
    return out


@pytest.fixture(scope="module")
def jax_single(data):
    """JAX's single-device matches: the port-vs-JAX gap the sharded gaps are
    held to."""
    tgt, src = _jcloud(*data["tgt"]), _jcloud(*data["src"])
    eye, z = jnp.eye(3), jnp.zeros(3)
    iopts = jicp.IcpOptions(method="p2plane_vox")
    dopts = jndt.NdtOptions(voxel_size=2.0, method="direct")
    nopts = jndt.NdtOptions(**NDT_INC)
    m = jndt.empty_incremental(nopts)
    for w in ("w0", "w1"):
        m = jndt.update_incremental(m, _jcloud(*data[w]), nopts)
    return {"icp": jicp.scan_match(jicp.set_target(tgt, iopts), iopts, src, eye, z),
            "ndt_direct": jndt.scan_match(jndt.build_direct(tgt, dopts), dopts, src, eye, z),
            "ndt_inc": jndt.scan_match(m, nopts, _jcloud(*data["scan2"]),
                                       data["pose2"]["R"], data["pose2"]["t"]),
            "ndt_inc_map": m}


# ---------------------------------------------------------------------------
# Slab partition (in this process: it computes every shard)
# ---------------------------------------------------------------------------

def _lattice():
    """Integer voxel-x everywhere: every percentile falls on (or between)
    equal values, where an interpolation rounding would move a bound."""
    rng = np.random.default_rng(11)
    xyz = np.stack([rng.integers(-20, 21, 3000) + 0.5, rng.uniform(-5, 5, 3000),
                    rng.uniform(-2, 2, 3000)], 1).astype(np.float32)
    mask = rng.random(3000) > 0.1
    return np.where(mask[:, None], xyz, PAD_COORD).astype(np.float32), mask


@pytest.mark.parametrize("cfg", [
    ("pair", 1.0, 4, 4096, 1, "floor"), ("pair", 2.0, 2, 8192, 0, "trunc"),
    ("pair", 1.0, 3, 3000, 1, "floor"), ("pair", 0.7, 5, 2048, 2, "trunc"),
    ("lattice", 1.0, 4, 1024, 1, "floor"), ("lattice", 1.0, 7, 600, 0, "trunc"),
    ("lattice", 3.0, 2, 4096, 1, "floor")])
def test_partition_slabs_equals_jax(data, cfg):
    name, leaf, mp, cap, halo, mode = cfg
    xyz, mask = data["tgt"] if name == "pair" else _lattice()
    got = map_shard.partition_slabs(_cloud(xyz, mask), leaf, mp, cap, halo, mode)
    want = jmap_shard.partition_slabs(_jcloud(xyz, mask), leaf, mp, cap, halo, mode)
    for f in ("lo", "hi", "kx", "overflow", "mask", "xyz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    lo, hi = got.lo.numpy(), got.hi.numpy()
    np.testing.assert_array_equal(hi[:-1], lo[1:])       # the slabs tile the axis
    if name == "pair" and mode == "floor" and leaf == 1.0 and mp == 4:
        assert not got.overflow.any()
        per = got.mask.sum(1).numpy()
        assert per.max() < 2.2 * max(per.min(), 1)      # percentile bounds balance


# ---------------------------------------------------------------------------
# The sharded matchers
# ---------------------------------------------------------------------------

def _rank_of(runs, mp_index):
    return next(r for r in runs if r["mp_index"] == mp_index)


@pytest.mark.parametrize("shape", MESHES + ((1, 1),))
def test_ranks_return_the_same_bits(port, shape):
    runs = port[shape]
    assert [r["rank"] for r in runs] == list(range(shape[0] * shape[1]))
    for r in runs[1:]:
        for key in ("icp", "ndt_direct", "ndt_inc"):
            for f in ("R", "t", "num_effective", "iterations", "chi2"):
                np.testing.assert_array_equal(r["matchers"][key][f],
                                              runs[0]["matchers"][key][f], err_msg=key)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_icp_target_equals_jax_shards(port, ref, shape):
    st = ref[shape]["icp_target"]
    seen = {}
    for s in range(shape[1]):
        got = _rank_of(port[shape], s)["matchers"]["icp_shard"]
        for f in ("lo", "hi", "kx", "overflow"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(st, f)), err_msg=f)
        keys = np.array(st.target.grid.voxel_keys[s])
        live = keys != voxel.INVALID_KEY
        coords = voxel.key_to_coords(torch.from_numpy(keys)).numpy()[live]
        coords[:, 0] += int(np.asarray(st.kx[s]))
        want = {tuple(c): bool(v) for c, v in zip(coords, np.asarray(st.target.plane_valid[s])[live])}
        have = {tuple(c): bool(v) for c, v in zip(got["coords"], got["valid"])}
        assert have == want, s
        for c, v in have.items():           # every voxel answers on one shard only
            if v:
                assert c not in seen, f"voxel {c} valid on shards {seen[c]} and {s}"
                seen[c] = s
    assert len(seen) > 100
    assert not np.asarray(st.overflow).any()


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_overflow_is_reported_like_jax(port, ref, shape):
    got = port[shape][0]["matchers"]
    np.testing.assert_array_equal(got["icp_overflow_512"], ref[shape]["icp_overflow_512"])
    assert got["icp_overflow_512"].sum() > 0
    np.testing.assert_array_equal(got["ndt_direct_overflow"], ref[shape]["ndt_direct_overflow"])
    assert not got["ndt_direct_overflow"].any()


def _gap(a, b, f):
    return np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max()


@pytest.mark.parametrize("shape", MESHES + ((1, 1),))
@pytest.mark.parametrize("key", ["icp", "ndt_direct", "ndt_inc"])
def test_sharded_match_matches_single_device_and_jax(port, ref, single, jax_single, data,
                                                     key, shape):
    got, one = port[shape][0]["matchers"][key], single[key]
    jone = jax_single[key]
    np.testing.assert_allclose(got["t"], one.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(got["R"], one.R.numpy(), atol=2e-3)
    if key == "icp":
        assert np.linalg.norm(got["t"] - data["gt_t"]) < 0.1
        assert got["num_effective"] > 100
    if shape == (1, 1):      # the single-device bits (computed in the rank's process)
        for f, v in port[shape][0]["matchers"]["single"][key].items():
            np.testing.assert_array_equal(got[f], v, err_msg=f)
        return
    want = ref[shape][key]
    for f in ("t", "R"):
        assert np.abs(got[f] - np.asarray(getattr(want, f))).max() \
            <= _gap(one, jone, f) + 1e-5, f
    assert got["iterations"] == int(want.iterations)
    assert got["num_effective"] == int(one.num_effective)
    assert (abs(got["num_effective"] - int(want.num_effective))
            <= abs(int(one.num_effective) - int(jone.num_effective)))


def _rows(keys):
    """key -> row of the live rows of a table's keys."""
    return {k: i for i, k in enumerate(np.asarray(keys)) if k != voxel.INVALID_KEY}


def _assert_shard_equals_jax(got, jm, s):
    """Keys, counts, ages and flags equal; means and covariances within the
    raw-moment rounding at the voxel's range (ROADMAP.md section 3), per
    row 8 u |mu| and 16 u (|mu|^2 + max |cov|) (measured up to 4.1 and
    8.0 u on the corrected maps, 2.5 and 1.8 u before the correction)."""
    rows, jrows = _rows(got["keys"]), _rows(jm.keys[s])
    assert set(rows) == set(jrows), s
    idx = np.array([rows[k] for k in jrows], np.int64)
    jidx = np.array(list(jrows.values()), np.int64)
    for f in ("count", "age", "estimated"):
        np.testing.assert_array_equal(got[f][idx], np.asarray(getattr(jm, f)[s])[jidx], err_msg=f)
    mu = np.asarray(jm.mean[s], np.float64)[jidx]
    cov = np.asarray(jm.cov[s], np.float64)[jidx]
    r2 = np.sum(mu * mu, 1)
    assert (np.abs(got["mean"][idx] - mu).max(1) <= 8 * U * np.sqrt(r2) + 1e-30).all()
    assert (np.abs(got["cov"][idx] - cov).max((1, 2))
            <= 16 * U * (r2 + np.abs(cov).max((1, 2)))).all()
    return len(rows)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("which", ["ndt_inc", "corrected", "carried_corrected"])
def test_sharded_incremental_map_equals_jax_shards(port, ref, single, shape, which):
    """Each shard of the incremental map (two absorbed scans) against JAX's
    shard; the same map after apply_correction_sharded moved, re-binned and
    re-slabbed it; and JAX's own shards corrected by the port (the
    correction's arithmetic alone). Slab bounds equal; before the
    correction each shard's rows have the bits of the port's single-device
    map's rows."""
    sm = ref[shape]["ndt_inc_map" if which == "ndt_inc" else "corrected"]
    m1 = single["ndt_inc_map"]
    one = _rows(m1.keys.numpy())
    total = 0
    for s in range(shape[1]):
        got = _rank_of(port[shape], s)["matchers"][f"{which}_shard"]
        np.testing.assert_array_equal(got["lo"], np.asarray(sm.lo))
        np.testing.assert_array_equal(got["hi"], np.asarray(sm.hi))
        total += _assert_shard_equals_jax(got, sm.map, s)
        if which == "ndt_inc":
            idx = np.array([one[k] for k in got["keys"]], np.int64)
            for f in ("count", "mean", "cov", "age", "estimated"):
                np.testing.assert_array_equal(got[f], getattr(m1, f).numpy()[idx], err_msg=f)
    assert total > 500


# ---------------------------------------------------------------------------
# The sharded pipelines
# ---------------------------------------------------------------------------

def test_lio_sharded_step_matches_jax_on_carried_state(port, ref):
    _, want = ref["lio"]
    kfs = 0
    for r in port[(2, 2)]:
        for got, w in zip(r["lio_carried"], want):
            out = w["out"]
            assert got["is_keyframe"] == bool(out.is_keyframe)
            assert got["iterations"] == int(out.iterations)
            assert got["num_effective"] == int(out.num_effective)
            dt, rot = _pose_gap(out.R, out.t, got["R"], got["t"])
            assert dt < 1e-5 and rot < 1e-5, (dt, rot)
            np.testing.assert_allclose(got["chi2"], float(out.chi2), rtol=1e-4)
            if got["is_keyframe"]:
                np.testing.assert_array_equal(got["live"], w["live"])
                kfs += 1
    assert kfs >= 4          # each of the 4 ranks saw a keyframe


def test_loc_sharded_step_matches_jax_on_carried_state(port, ref):
    _, want = ref["loc"]
    for r in port[(2, 2)]:
        for got, out in zip(r["loc_carried"], want):
            assert got["need_recrop"] == bool(out.need_recrop)
            assert got["converged"] == bool(out.converged)
            assert got["num_effective"] == int(out.num_effective)
            dt, rot = _pose_gap(out.R, out.t, got["R"], got["t"])
            assert dt < 1e-5 and rot < 1e-5, (dt, rot)
            np.testing.assert_allclose(got["chi2"], float(out.chi2), rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 4), (1, 1)])
def test_lio_sharded_free_run_tracks_single_device(port, single, shape):
    """test_map_shard.py:247 at (1, 4): per-shard tables of 4,096 voxels, a
    live map larger than one of them; at (1, 1) one 65,536-row shard gives
    the single-device engine's bits."""
    eng = single["lio"]
    for r in port[shape]:
        got = r["lio_free"]
        ps, pd = np.stack(eng.poses), got["poses"]
        assert len(ps) == len(pd)
        assert got["health"] == "ok"
        if shape == (1, 1):      # the single-device bits (computed in the rank's process)
            np.testing.assert_array_equal(pd, got["single_poses"])
            np.testing.assert_array_equal(got["kf_poses"], got["single_kf_poses"])
            continue
        assert np.linalg.norm(ps[:, :3, 3] - pd[:, :3, 3], axis=1).max() < 0.02
        cap = LIO_OPTS["ndt"]["map_capacity"]
        live = got["live"]
        assert live.sum() > cap and (live < cap).all(), live
        single_live = int((eng.state.ndt_map.keys != voxel.INVALID_KEY).sum())
        assert abs(int(live.sum()) - single_live) <= 2, (live.sum(), single_live)


def test_lio_sharded_surfaces_slab_imbalance_like_jax(port, jax_imbalance, corridor):
    """test_map_shard.py:307-338 at mp = 4 (the port's (dp, mp) = (1, 4),
    JAX's mesh (4, 1); dp does not change slab ownership): slab ownership
    is fixed at the first keyframe, so the exploring corridor funnels the
    map's growth into one shard, and LioSharded says so. On every rank:
    position RMSE < 0.1 m (within 0.01 m of JAX's), a "slab imbalance"
    warning (as many as JAX raises, within one), live max / mean above
    imbalance_warn_ratio, and each shard's live voxels within 2 of JAX's
    (the single-device bound of the free run above)."""
    def rmse(t):
        return float(np.sqrt(np.mean(np.sum((t - corridor["t"]) ** 2, axis=1))))

    for r in port[(1, 4)]:
        got = r["lio_imbalance"]
        assert rmse(got["t"]) < 0.1
        assert abs(rmse(got["t"]) - rmse(jax_imbalance["t"])) < 0.01
        assert got["warnings"] and "slab imbalance" in got["warnings"][-1], got["live"]
        assert abs(len(got["warnings"]) - len(jax_imbalance["warnings"])) <= 1
        live = got["live"].astype(float)
        assert live.max() / live.mean() > got["warn_ratio"]
        assert np.abs(got["live"] - jax_imbalance["live"]).max() <= 2, (got["live"],
                                                                         jax_imbalance["live"])


def test_loc_sharded_free_run_tracks_single_device(port, single):
    """test_map_shard.py:157's check on a smaller Loc workload: within 0.02 m
    of Loc (measured 1e-8 m), the crop larger than one shard's budget and
    nothing dropped."""
    ps = np.stack(single["loc"].poses)
    log = logdir.make_demo_log(**LOC_LOG)
    for r in port[(2, 2)]:
        got = r["loc_free"]
        assert not got["overflow"].any()
        pd = got["poses"]
        assert np.linalg.norm(ps[:, :3, 3] - pd[:, :3, 3], axis=1).max() < 0.02
        k0 = got["first_scan"]
        gt = log.gt_poses[k0:k0 + len(pd), :3, 3]
        # test_map_shard.py's 0.4 m: the ESKF, at rest while the log moves
        # at 2 m/s, has a transient (0.22 m at its peak on these 8 frames)
        assert np.linalg.norm(pd[:, :3, 3] - gt, axis=1).max() < 0.4


def test_slam3d_sharded_closes_loops_like_single_device(port, single):
    """test_map_shard.py:342 at (2, 2): the sharded front end's live map
    exceeds one shard's 1,024-voxel table, loops close and the correction
    is written through the shards."""
    eng, log = single["slam"], single["slam_log"]
    for r in port[(2, 2)]:
        got = r["slam_free"]
        assert len(got["kf_t"]) == len(eng.kf_t)
        assert got["loops"] > 0 and eng.loops
        assert np.linalg.norm(got["kf_t"] - np.stack(eng.kf_t), axis=1).max() < 0.15
        cap = SLAM_OPTS["lio"]["ndt"]["map_capacity"]
        assert got["live"].sum() > cap and (got["live"] < cap).all(), got["live"]
        gt = log.gt_poses[got["kf_frame"]]
        gt_rel = np.linalg.inv(log.gt_poses[0])[None] @ gt
        ate = np.linalg.norm(got["kf_t"] - gt_rel[:, :3, 3], axis=1)
        assert float(np.sqrt(np.mean(ate ** 2))) < 0.25, ate


def test_slam3d_sharded_free_run_matches_jax(port, ref):
    """The same keyframes, loop pairs and inlier mask as JAX's Slam3dSharded
    free run at (2, 2); keyframe positions within 0.02 m of JAX's (measured
    5.7 mm); every rank the same bits."""
    jeng = ref["slam"]["engine"]
    runs = port[(2, 2)]
    got = runs[0]["slam_free"]
    for r in runs[1:]:
        for f in ("kf_t", "inliers", "live"):
            np.testing.assert_array_equal(r["slam_free"][f], got[f], err_msg=f)
    assert list(got["kf_frame"]) == list(jeng.kf_frame)
    assert got["loop_pairs"] == [(l.i, l.j) for l in jeng.loops] and got["loop_pairs"]
    np.testing.assert_array_equal(got["inliers"], jeng.loop_inliers)
    gap = np.linalg.norm(got["kf_t"] - np.stack(jeng.kf_t), axis=1).max()
    assert gap < 0.02, gap


def test_slam3d_sharded_optimize_matches_jax_on_carried_state(port, ref):
    """Slam3dSharded.optimize() on JAX's state just before its last
    pose-graph solve (keyframe poses, loop edges, the front end's state and
    map shards carried across): the same inlier mask; keyframe poses and
    the corrected front-end poses within twice the change a 1-ulp nudge of
    the keyframe poses makes in JAX's own optimize() (measured: no more
    than JAX's own change); each shard of the map corrected through the
    shards with JAX's live count, keys, counts, ages and flags, its means
    and covariances within _assert_shard_equals_jax's raw-moment bounds
    plus what the two corrections' difference moves a voxel at its range
    (measured up to 4.9 u |mu|); every rank the same bits."""
    jr = ref["slam"]
    done, nudged, pre = jr["done"], jr["nudged"], jr["pre"]
    runs = port[(2, 2)]
    got = runs[0]["slam_carried"]
    for r in runs[1:]:
        for f in ("kf_R", "kf_t", "inliers", "live"):
            np.testing.assert_array_equal(r["slam_carried"][f], got[f], err_msg=f)
    np.testing.assert_array_equal(got["inliers"], done.loop_inliers)
    assert got["inliers"].any()
    for f in ("kf_t", "kf_R"):
        want = np.stack(getattr(done, f))
        self_gap = np.abs(np.stack(getattr(nudged, f)) - want).max()
        port_gap = np.abs(got[f] - want).max()
        assert 0 < self_gap and port_gap <= 2 * self_gap, (f, port_gap, self_gap)
    for f in ("R", "t", "last_kf_R", "last_kf_t"):
        want = np.asarray(getattr(done.lio.state, f))
        self_gap = np.abs(np.asarray(getattr(nudged.lio.state, f)) - want).max()
        port_gap = np.abs(got["state"][f] - want).max()
        assert port_gap <= 2 * self_gap, (f, port_gap, self_gap)
    # the two corrections' difference, and how far it moves a point at range r
    k = len(done.kf_R) - 1
    pre_R = np.asarray(pre.kf_R[k], np.float64)
    dR_gap = np.abs((got["kf_R"][k] - np.asarray(done.kf_R[k], np.float64)) @ pre_R.T).max()
    dt_gap = (np.abs(got["kf_t"][k] - np.asarray(done.kf_t[k])).max()
              + 3 * dR_gap * np.abs(np.asarray(pre.kf_t[k])).max())
    sm = done.lio.sm
    np.testing.assert_array_equal(got["live"], done.live_voxels_per_shard())
    for s in range(2):
        shard = _rank_of(runs, s)["slam_carried"]["shard"]
        np.testing.assert_array_equal(shard["lo"], np.asarray(sm.lo))
        np.testing.assert_array_equal(shard["hi"], np.asarray(sm.hi))
        rows, jrows = _rows(shard["keys"]), _rows(sm.map.keys[s])
        assert set(rows) == set(jrows), s
        idx = np.array([rows[key] for key in jrows], np.int64)
        jidx = np.array(list(jrows.values()), np.int64)
        for f in ("count", "age", "estimated"):
            np.testing.assert_array_equal(shard[f][idx], np.asarray(getattr(sm.map, f)[s])[jidx],
                                          err_msg=f)
        mu = np.asarray(sm.map.mean[s], np.float64)[jidx]
        cov = np.asarray(sm.map.cov[s], np.float64)[jidx]
        r = np.sqrt(np.sum(mu * mu, 1))
        big = np.abs(cov).max((1, 2))
        assert (np.abs(shard["mean"][idx] - mu).max(1)
                <= 8 * U * r + 3 * dR_gap * r + dt_gap + 1e-30).all()
        assert (np.abs(shard["cov"][idx] - cov).max((1, 2))
                <= 16 * U * (r * r + big) + 6 * dR_gap * big).all()
