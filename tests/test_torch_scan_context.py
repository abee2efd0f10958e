"""Port parity: loc_lib_tpu_torch.graph.scan_context against the JAX package
on the tests/test_graph.py workloads (retrieval :79, ring-buffer eviction
:182, top-k :276), plus ties.

Stated tolerances: descriptors cell by cell equal to JAX's, except a cell
whose winning point sits within float32 rounding of a sector edge (atan2 and
the modulo differ by an ulp between libm and XLA:CPU): such cells are
counted and each must be explained by a point within 1e-5 rad of an edge
(measured: 0 on these scans). Ring keys, distances and the retrieved
insertion ids equal JAX's (distances within 1e-6: the contraction over
rings may add in another order). The ring-key and distance selections keep
jax.lax.top_k's order among ties (lower index first).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.graph import scan_context as jsc
from loc_lib_tpu.ops.pointcloud import PointCloud as JPointCloud
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.graph import scan_context as sc
from loc_lib_tpu_torch.io import synthetic

torch.set_num_threads(2)

POSES = [(-20.0, -20.0), (0.0, 20.0), (25.0, 5.0), (-10.0, 15.0), (15.0, -25.0), (5.0, 5.0)]


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(num_points=30000, extent=60.0, seed=5)


def _scan(world, x, y, seed, R=None):
    R = np.eye(3, dtype=np.float32) if R is None else R
    return synthetic.render_scan(world, R, np.array([x, y, 1.5], np.float32), max_range=50.0,
                                 max_points=4096, seed=seed, capacity=4096, device="cpu")


def _jax(pc):
    return JPointCloud(xyz=jnp.asarray(pc.xyz.numpy()), mask=jnp.asarray(pc.mask.numpy()))


def _dbs(world, capacity, opts_kw, poses=POSES):
    """The port's DB on the CPU and JAX's, fed the same scans."""
    db = sc.ScanContextDb(capacity=capacity, opts=sc.ScanContextOptions(**opts_kw), device="cpu")
    jdb = jsc.ScanContextDb(capacity=capacity, opts=jsc.ScanContextOptions(**opts_kw))
    for k, (x, y) in enumerate(poses):
        pc = _scan(world, x, y, k)
        assert db.add(pc) == jdb.add(_jax(pc)) == k
    return db, jdb


def _edge_explained(pc, ours, ref, opts):
    """The differing cells, and whether each has a point within 1e-5 rad of
    a sector edge in the cell's ring."""
    xyz = pc.xyz.numpy()[pc.mask.numpy()].astype(np.float64)
    theta = np.mod(np.arctan2(xyz[:, 1], xyz[:, 0]), 2 * np.pi)
    frac = theta / (2 * np.pi) * opts.num_sector
    near_edge = np.abs(frac - np.round(frac)) < 1e-5 * opts.num_sector / (2 * np.pi)
    ring = np.clip((np.hypot(xyz[:, 0], xyz[:, 1]) / opts.max_radius * opts.num_ring)
                   .astype(int), 0, opts.num_ring - 1)
    cells = np.argwhere(ours != ref)
    return cells, all(np.any(near_edge & (ring == r)) for r, _ in cells)


def test_descriptor_and_ring_key_match_jax(world):
    """The descriptor of every test scan (and of a rotated revisit) against
    JAX's, cell by cell; ring keys exact."""
    opts, jopts = sc.ScanContextOptions(), jsc.ScanContextOptions()
    yaw = np.asarray(jlie.so3_exp(jnp.array([0, 0, 1.1], jnp.float32)))
    scans = [_scan(world, x, y, k) for k, (x, y) in enumerate(POSES)]
    scans.append(_scan(world, -20.0, -20.0, 99, R=yaw))
    for pc in scans:
        ours = sc.descriptor(pc, opts).numpy()
        ref = np.asarray(jsc.descriptor(_jax(pc), jopts))
        cells, explained = _edge_explained(pc, ours, ref, opts)
        assert explained, cells                       # measured: no differing cell here
        assert (ours != 0).sum() > 100
        np.testing.assert_array_equal(sc.ring_key(torch.from_numpy(ours)).numpy(),
                                      np.asarray(jsc.ring_key(jnp.asarray(ref))))
    # masked points and points past max_radius do not count
    pc = scans[0]
    none = sc.descriptor(pc._replace(mask=torch.zeros_like(pc.mask)), opts)
    assert torch.equal(none, torch.zeros(opts.num_ring, opts.num_sector))
    far = sc.descriptor(pc._replace(xyz=pc.xyz + torch.tensor([200.0, 0.0, 0.0])), opts)
    assert float(far.abs().sum()) == 0.0


def test_shifted_distance_matches_jax(world):
    """Every shift of every column: the min-over-shifts cosine distance of a
    query against a DB of descriptors (one empty, one with empty columns)
    within 1e-6 of JAX's; a rolled copy of the query is at distance ~0."""
    opts = sc.ScanContextOptions()
    descs = [sc.descriptor(_scan(world, x, y, k), opts) for k, (x, y) in enumerate(POSES)]
    q = descs[0]
    db = torch.stack(descs + [torch.zeros_like(q), torch.roll(q, 17, dims=-1)])
    db[2, :, ::3] = 0.0
    ours = sc._shifted_distance(q, db).numpy()
    ref = np.asarray(jsc._shifted_distance(jnp.asarray(q.numpy()), jnp.asarray(db.numpy())))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    assert ours[0] < 1e-6 and ours[-1] < 1e-6 and ours[-2] == 1.0


def test_scan_context_retrieval_matches_jax(world):
    """test_graph.py:79 in the port: a yawed revisit of place 0 retrieves
    insertion 0, a novel place does not match it; index, distance and found
    equal JAX's."""
    kw = dict(exclude_recent=2, dist_threshold=0.35)
    db, jdb = _dbs(world, 64, kw)
    yaw = np.asarray(jlie.so3_exp(jnp.array([0, 0, 1.1], jnp.float32)))
    revisit = _scan(world, -20.0, -20.0, 99, R=yaw)
    novel = _scan(world, 55.0, 55.0, 98)
    for pc in (revisit, novel):
        res, jres = db.query(pc), jdb.query(_jax(pc))
        assert int(res.index) == int(jres.index) and bool(res.found) == bool(jres.found)
        np.testing.assert_allclose(float(res.distance), float(jres.distance), atol=1e-6)
    res = db.query(revisit)
    assert bool(res.found) and int(res.index) == 0, float(res.distance)
    res2 = db.query(novel)
    assert int(res2.index) != 0 or not bool(res2.found)


def test_scan_context_db_ring_buffer_eviction_matches_jax(world):
    """test_graph.py:182 in the port: capacity 4, six insertions: ids 0 and
    1 evicted and counted, an evicted place does not match, a live place
    returns its original insertion id; the buffers equal JAX's slot by
    slot."""
    kw = dict(exclude_recent=2, dist_threshold=0.35)
    db, jdb = _dbs(world, 4, kw)
    assert db.count == jdb.count == 6 and db.evicted == jdb.evicted == 2
    assert set(db.ids.tolist()) == {2, 3, 4, 5}
    np.testing.assert_array_equal(db.ids.numpy(), np.asarray(jdb.ids))
    np.testing.assert_array_equal(db.keys.numpy(), np.asarray(jdb.keys))
    np.testing.assert_array_equal(db.desc.numpy(), np.asarray(jdb.desc))
    res = db.query(_scan(world, -20.0, -20.0, 99))
    assert int(res.index) != 0
    live = _scan(world, 25.0, 5.0, 98)
    res2, jres2 = db.query(live), jdb.query(_jax(live))
    assert bool(res2.found) and int(res2.index) == int(jres2.index) == 2


def test_scan_context_topk_retrieval_matches_jax(world):
    """test_graph.py:276 in the port: lane 0 equals the 1-best result,
    distances ascend, both nearby places come back, lanes past the found
    ones carry -1; every lane equals JAX's. An ask larger than the ring-key
    gate pads with not-found lanes, like JAX."""
    kw = dict(exclude_recent=2, dist_threshold=0.45)
    poses = [(-20.0, -20.0), (-18.0, -20.0), (0.0, 20.0), (25.0, 5.0), (15.0, -25.0), (5.0, 5.0)]
    db, jdb = _dbs(world, 64, kw, poses)
    revisit = _scan(world, -20.0, -20.0, 99)
    one, top = db.query(revisit), db.query_topk(revisit, 4)
    jtop = jdb.query_topk(_jax(revisit), 4)
    ids, dist, found = top.index.numpy(), top.distance.numpy(), top.found.numpy()
    assert ids.shape == (4,)
    np.testing.assert_array_equal(ids, np.asarray(jtop.index))
    np.testing.assert_array_equal(found, np.asarray(jtop.found))
    np.testing.assert_allclose(dist, np.asarray(jtop.distance), atol=1e-6)
    assert bool(found[0]) == bool(one.found) and int(ids[0]) == int(one.index)
    assert float(dist[0]) == float(one.distance)
    fin = dist[np.isfinite(dist)]
    assert (np.diff(fin) >= 0).all()
    got = set(ids[found].tolist())
    assert 0 in got and 1 in got, got
    assert (ids[~found] == -1).all()
    # 64 slots keep k = 6 ring-key candidates: an ask of 8 pads two lanes
    big, jbig = db.query_topk(revisit, 8), jdb.query_topk(_jax(revisit), 8)
    np.testing.assert_array_equal(big.index.numpy(), np.asarray(jbig.index))
    assert big.index.shape == (8,) and not big.found[6:].any()
    assert math.isinf(float(big.distance[7]))


def test_ties_keep_the_lower_index_first_like_jax(world):
    """A DB holding the same descriptor in several slots: equal ring-key
    distances and equal descriptor distances. The ring-key gate (k = 3 of
    32 slots) and the top-k both keep the lowest slots first, as
    jax.lax.top_k does; ids, found and distances equal JAX's."""
    opts = dict(exclude_recent=0, dist_threshold=0.5)
    d = sc.descriptor(_scan(world, -20.0, -20.0, 0), sc.ScanContextOptions())
    other = sc.descriptor(_scan(world, 15.0, -25.0, 4), sc.ScanContextOptions())
    n = 32
    dup = [3, 7, 8, 20, 30]                # five copies of the query's descriptor
    desc = torch.stack([d if s in dup else other for s in range(n)])
    keys = sc.ring_key(desc)
    ids = torch.arange(100, 100 + n, dtype=torch.int32)   # insertion ids != slots
    res = sc.detect_loop_topk(d, desc, keys, ids, 200, sc.ScanContextOptions(**opts), topk=3)
    jres = jsc.detect_loop_topk(jnp.asarray(d.numpy()), jnp.asarray(desc.numpy()),
                                jnp.asarray(keys.numpy()), jnp.asarray(ids.numpy()),
                                jnp.int32(200), jsc.ScanContextOptions(**opts), topk=3)
    np.testing.assert_array_equal(res.index.numpy(), np.asarray(jres.index))
    np.testing.assert_array_equal(res.found.numpy(), np.asarray(jres.found))
    np.testing.assert_allclose(res.distance.numpy(), np.asarray(jres.distance), atol=1e-6)
    assert res.index.tolist() == [103, 107, 108]
    # the same with the tie in the ring-key gate alone: 3 of the 5 copies
    # pass it, the lowest slots
    assert sc._smallest(torch.tensor([2.0, 1.0, 1.0, 0.5, 1.0, 1.0]), 4).tolist() == [3, 1, 2, 4]
