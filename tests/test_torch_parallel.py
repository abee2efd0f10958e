"""Port parity: loc_lib_tpu_torch.parallel.match and parallel.graph against the
JAX package, on tests/test_parallel.py's workloads.

The port runs in spawned CPU processes joined over gloo, one rank each
(`multihost.launch`, rank functions in tests/test_torch_dist_workers.py), on a
1-D "dp" mesh of 2 and of 4 ranks; JAX runs its shard_map programs on the
same number of the conftest's CPU devices. One launch per mesh size runs
every scenario of this file (module-scoped fixture), side by side with
JAX's work; the tests assert on its results.

Stated tolerances:
  * every rank returns the same bits (the all-reduce is replicated);
  * ICP (p2plane) and direct NDT: the distributed pose within 1e-5 of the
    port's single-device `scan_match` (test_parallel.py allows 1e-3), and
    no farther from JAX's distributed pose at the same rank count than the
    port's single-device pose is from JAX's single-device one, plus 1e-5
    (that single-device gap is 1.08e-4 m for p2plane on this workload: the
    knn normals' rounding; JAX's own distributed-vs-single gap is 1.7e-8);
    iterations equal to JAX's, effective counts equal to the port's
    single-device count and as far from JAX's as that one is (p2plane: 1050
    against 1051, a point at the knn distance gate);
  * the edge-sharded pose graph: within 3e-3 of the port's single-device
    solve and of JAX's edge-sharded solve at the same count
    (test_parallel.py:106's bound), per-edge chi2 within 5% / 1e-3; the
    two-phase loop inlier set equal to JAX's and to the single-device one.
"""
import concurrent.futures
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.graph import pose_graph as jpg
from loc_lib_tpu.io import synthetic as jsynthetic
from loc_lib_tpu.models import icp as jicp, ndt as jndt
from loc_lib_tpu.ops import pointcloud as jpc
from loc_lib_tpu.parallel import graph as jpgraph, match as jpmatch, mesh as jmesh
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.graph import pose_graph as pg
from loc_lib_tpu_torch.models import icp, ndt
from loc_lib_tpu_torch.ops.pointcloud import PointCloud
from loc_lib_tpu_torch.parallel import multihost

torch.set_num_threads(2)
TESTS = pathlib.Path(__file__).resolve().parent
RANKS = (2, 4)


def _pair(capacity=2048):
    world = jsynthetic.make_world(num_points=20000, extent=60.0, seed=3)
    traj = jsynthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    scans = [jsynthetic.render_scan(world, traj.R[k], traj.t[k], max_points=capacity,
                                    noise=0.005, seed=k, capacity=capacity) for k in range(2)]
    return [(np.asarray(s.xyz), np.asarray(s.mask)) for s in scans]


def _pgo_chain(m=12, seed=0, drift=0.05):
    """test_parallel.py's drifted 12-node arc with one good loop and one
    wrong one, as numpy edges."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 1.5 * np.pi, m)
    t_gt = np.stack([np.cos(ang) * 5, np.sin(ang) * 5, np.zeros(m)], axis=1)
    R_gt = np.stack([np.asarray(jlie.so3_exp(jnp.array([0, 0, a], jnp.float32))) for a in ang])
    R_est, t_est = [R_gt[0]], [t_gt[0].astype(np.float32)]
    for i in range(1, m):
        Rrel = R_gt[i - 1].T @ R_gt[i]
        trel = R_gt[i - 1].T @ (t_gt[i] - t_gt[i - 1]) + rng.normal(0, drift, 3)
        R_est.append((R_est[-1] @ Rrel).astype(np.float32))
        t_est.append((t_est[-1] + R_est[-1] @ trel).astype(np.float32))
    R_est, t_est = np.stack(R_est).astype(np.float32), np.stack(t_est).astype(np.float32)
    odo = jpg.odometry_edges(jnp.asarray(R_est), jnp.asarray(t_est))
    odo = {k: np.asarray(v) for k, v in odo._asdict().items()}

    def loop(i, j, R, t):
        return {"i": np.array([i], np.int32), "j": np.array([j], np.int32),
                "R": np.asarray(R, np.float32)[None], "t": np.asarray(t, np.float32)[None],
                "info": np.eye(6, dtype=np.float32)[None] * 1e4,
                "is_loop": np.array([True]), "valid": np.array([True])}

    good = loop(0, m - 1, R_gt[0].T @ R_gt[-1], R_gt[0].T @ (t_gt[-1] - t_gt[0]))
    bad = loop(1, m - 2, np.eye(3), [30.0, -20.0, 5.0])
    cat = lambda a, b: {k: np.concatenate([a[k], b[k]]) for k in a}
    edges_good = cat(odo, good)
    return R_est, t_est, edges_good, cat(edges_good, bad)


def _jedges(d):
    return jpg.Se3Edges(**{k: jnp.asarray(v) for k, v in d.items()})


def _pc(xyz, mask):
    return PointCloud(xyz=torch.from_numpy(xyz.copy()), mask=torch.from_numpy(mask.copy()))


@pytest.fixture(scope="module")
def case():
    (tx, tm), (sx, sm) = _pair()
    R_est, t_est, edges_good, edges_all = _pgo_chain()
    return {"tgt": (tx, tm), "src": (sx, sm), "R_est": R_est, "t_est": t_est,
            "edges_good": edges_good, "edges_all": edges_all}


def _launch(target, n, case):
    return multihost.launch(f"test_torch_dist_workers:{target}", n, (case,), device="cpu",
                            extra_paths=[TESTS])


@pytest.fixture(scope="module")
def port(case, request):
    """The port's ranks (one launch per mesh size, and a world of one rank
    for the group= test), run side by side with JAX's distributed results
    and the port's single-device ones."""
    with concurrent.futures.ThreadPoolExecutor(len(RANKS) + 1) as pool:
        launches = {n: pool.submit(_launch, "parallel_case", n, case) for n in RANKS}
        launches["one_rank"] = pool.submit(_launch, "one_rank_group_case", 1, case)
        request.getfixturevalue("ref")
        tgt, src = _pc(*case["tgt"]), _pc(*case["src"])
        eye, z = torch.eye(3), torch.zeros(3)
        iopts = icp.IcpOptions(method="p2plane")
        nopts = ndt.NdtOptions(voxel_size=2.0, method="direct")
        R0, t0 = torch.from_numpy(case["R_est"]), torch.from_numpy(case["t_est"])
        edges = lambda d: pg.Se3Edges(**{k: torch.from_numpy(v) for k, v in d.items()})
        single = {"icp": icp.scan_match(icp.set_target(tgt, iopts), iopts, src, eye, z),
                  "ndt": ndt.scan_match(ndt.build_direct(tgt, nopts), nopts, src, eye, z),
                  "pgo": pg.optimize(R0, t0, edges(case["edges_good"])),
                  "two_phase": pg.optimize_two_phase(R0, t0, edges(case["edges_all"]))}
        runs = {key: f.result() for key, f in launches.items()}
    return runs, single


@pytest.fixture(scope="module")
def ref(case):
    """JAX's distributed results at each rank count."""
    src = jpc.PointCloud(xyz=jnp.asarray(case["src"][0]), mask=jnp.asarray(case["src"][1]))
    tgt = jpc.PointCloud(xyz=jnp.asarray(case["tgt"][0]), mask=jnp.asarray(case["tgt"][1]))
    eye, z = jnp.eye(3), jnp.zeros(3)
    iopts = jicp.IcpOptions(method="p2plane")
    nopts = jndt.NdtOptions(voxel_size=2.0, method="direct")
    target, nmap = jicp.set_target(tgt, iopts), jndt.build_direct(tgt, nopts)
    R0, t0 = jnp.asarray(case["R_est"]), jnp.asarray(case["t_est"])
    out = {"single": {"icp": jicp.scan_match(target, iopts, src, eye, z),
                      "ndt": jndt.scan_match(nmap, nopts, src, eye, z)}}
    for n in RANKS:
        m = jmesh.make_mesh(n)
        out[n] = {"icp": jpmatch.icp_scan_match(m, target, iopts, src, eye, z),
                  "ndt": jpmatch.ndt_scan_match(m, nmap, nopts, src, eye, z),
                  "pgo": jpgraph.optimize(m, R0, t0, _jedges(case["edges_good"])),
                  "two_phase": jpgraph.optimize_two_phase(m, R0, t0,
                                                          _jedges(case["edges_all"]))}
    return out


@pytest.mark.parametrize("n", RANKS)
def test_ranks_return_the_same_bits(port, n):
    runs, _ = port
    assert [r["rank"] for r in runs[n]] == list(range(n))
    for r in runs[n][1:]:
        for key in ("icp", "ndt", "pgo", "two_phase"):
            for field, v in r[key].items():
                np.testing.assert_array_equal(v, runs[n][0][key][field], err_msg=f"{key}.{field}")


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("method", ["icp", "ndt"])
def test_distributed_match_matches_single_device_and_jax(port, ref, case, method, n):
    runs, single = port
    got, one, want = runs[n][0][method], single[method], ref[n][method]
    np.testing.assert_allclose(got["t"], one.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["R"], one.R.numpy(), atol=1e-5)
    jone = ref["single"][method]
    for f in ("t", "R"):
        gap = np.abs(getattr(one, f).numpy() - np.asarray(getattr(jone, f))).max()
        assert np.abs(got[f] - np.asarray(getattr(want, f))).max() <= gap + 1e-5, f
    assert got["iterations"] == int(want.iterations) == int(one.iterations)
    assert got["converged"] == bool(want.converged)
    if method == "ndt":
        # direct mode reports every source point over all ranks (the JAX
        # package's distributed matcher does; its single-device one, the
        # residual count)
        assert got["num_effective"] == int(want.num_effective) == int(case["src"][1].sum())
    else:
        assert got["num_effective"] == int(one.num_effective)
        assert (abs(got["num_effective"] - int(want.num_effective))
                <= abs(int(one.num_effective) - int(jone.num_effective)))
        assert got["num_effective"] > 100


@pytest.mark.parametrize("n", RANKS)
def test_edge_sharded_pgo_matches_single_device_and_jax(port, ref, case, n):
    runs, single = port
    got, one = runs[n][0]["pgo"], single["pgo"]
    Rj, tj, chi2_j = ref[n]["pgo"]
    e = len(case["edges_good"]["i"])
    assert len(got["chi2"]) % n == 0 and len(got["chi2"]) >= e
    np.testing.assert_allclose(got["t"], one.t.numpy(), atol=3e-3)
    np.testing.assert_allclose(got["R"], one.R.numpy(), atol=3e-3)
    np.testing.assert_allclose(got["t"], np.asarray(tj), atol=3e-3)
    np.testing.assert_allclose(got["R"], np.asarray(Rj), atol=3e-3)
    np.testing.assert_allclose(got["chi2"][:e], one.chi2.numpy(), rtol=0.05, atol=1e-3)
    np.testing.assert_allclose(got["chi2"][:e], np.asarray(chi2_j)[:e], rtol=0.05, atol=1e-3)


@pytest.mark.parametrize("n", RANKS)
def test_edge_sharded_two_phase_gates_loops_like_jax(port, ref, case, n):
    runs, single = port
    got = runs[n][0]["two_phase"]
    R1, t1, inl1 = single["two_phase"]
    Rj, tj, inl_j = ref[n]["two_phase"]
    e = len(case["edges_all"]["i"])
    np.testing.assert_array_equal(got["inlier"][:e], inl1.numpy())
    np.testing.assert_array_equal(got["inlier"], np.asarray(inl_j))
    assert not got["inlier"][e:].any()                 # padded rows are not loops
    assert got["inlier"][e - 2] and not got["inlier"][e - 1]
    np.testing.assert_allclose(got["t"], t1.numpy(), atol=3e-3)
    np.testing.assert_allclose(got["t"], np.asarray(tj), atol=3e-3)


def test_hooks_left_unset_give_the_single_device_bits(case):
    """The reduction hooks the distributed layer added to the single-device
    GN loops change nothing when unset: an identity reduction gives the
    bits of the plain call (ICP, direct and incremental NDT)."""
    tgt, src = _pc(*case["tgt"]), _pc(*case["src"])
    eye, z = torch.eye(3), torch.zeros(3)
    same = lambda *x: x
    for method in ("p2plane_vox", "p2plane"):
        opts = icp.IcpOptions(method=method)
        target = icp.set_target(tgt, opts)
        a = icp.scan_match(target, opts, src, eye, z)
        b = icp._gauss_newton(icp._TERM_FNS[method], target, opts, src, eye, z, reduce=same)
        for f in a._fields:
            assert torch.equal(torch.as_tensor(getattr(a, f)), torch.as_tensor(getattr(b, f))), f
    for method in ("direct", "incremental"):
        opts = ndt.NdtOptions(voxel_size=2.0, method=method)
        m = (ndt.build_direct(tgt, opts) if method == "direct" else
             ndt.update_incremental(ndt.empty_incremental(opts, device="cpu"), tgt, opts))
        a = ndt.scan_match(m, opts, src, eye, z)
        b = ndt.scan_match(m, opts, src, eye, z, reduce=same, n_points=src.count())
        for f in a._fields:
            assert torch.equal(torch.as_tensor(getattr(a, f)), torch.as_tensor(getattr(b, f))), f


def test_pose_graph_group_of_one_rank_gives_the_bits_of_none(port):
    """graph/pose_graph.py's group= path in a world of one rank: the node
    sums and the off-diagonal matvec all-reduced over it give the bits of
    group=None; and a 1-rank mesh gives the GN loops no reduction hook."""
    res = port[0]["one_rank"][0]
    assert res["hook"] is None
    for k, v in res["none"].items():
        np.testing.assert_array_equal(res["world"][k], v, err_msg=k)
    assert res["none"]["n"] > 0
