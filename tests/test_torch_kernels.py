"""Port parity: the plain PyTorch versions of K1 (p2plane_fused_terms), K2
(p2plane_pick_fused_terms) and K3 (ndt_fused_terms) against the JAX
package's Pallas kernels in interpret mode, plus the seam's dispatch rules.

Tolerance: H, b, chi2 within rtol 1e-5, atol 1e-4 (the bounds of
test_icp.py's fused-vs-unfused check); counts exact. The two sides sum the
same rows in different orders (tile-wise MXU-style dot vs one float32
matmul), which the tolerance absorbs. K3 sums 3 S rows per point (43,008
rows at N = 2048, S = 7), so its entries also get the rounding of a
reordered float32 sum: 64 u (|A|^T |A|)_ij, u = 2^-24, on top of that rule
(measured up to 3x the plain rule, on entries that cancel to near 0)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from loc_lib_tpu.ops import pallas_kernels
from loc_lib_tpu_torch.ops import kernels
import oracles

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4


def _pose(rng):
    R = oracles.so3_exp(rng.normal(size=3) * 0.05).astype(np.float32)
    t = (rng.normal(size=3) * 0.2).astype(np.float32)
    return R, t


def _planes(rng, n):
    nvec = rng.normal(size=(n, 3)).astype(np.float32)
    nvec /= np.linalg.norm(nvec, axis=1, keepdims=True)
    d = rng.uniform(-1, 1, size=(n, 1)).astype(np.float32)
    return np.concatenate([nvec, d], axis=1)


def _k1_inputs(rng, n, frac_valid=0.8):
    q = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    plane = _planes(rng, n)
    # put most points near their plane so the gate keeps a real share
    qs_dist = rng.normal(scale=0.1, size=n).astype(np.float32)
    plane[:, 3] = (-(plane[:, :3] * q).sum(1) + qs_dist).astype(np.float32)
    w = (rng.uniform(size=n) < frac_valid).astype(np.float32)
    return q, plane, w


def _k2_inputs(rng, n, S=7):
    q = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    rows = np.zeros((n, S, 8), np.float32)
    for s in range(S):
        pl = _planes(rng, n)
        mu = q + rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)
        pl[:, 3] = (-(pl[:, :3] * mu).sum(1)).astype(np.float32)
        rows[:, s, 0:4] = pl
        rows[:, s, 4:7] = mu
        rows[:, s, 7] = rng.uniform(size=n) < 0.6
    w = (rng.uniform(size=n) < 0.9).astype(np.float32)
    return q, rows, w


def _k3_inputs(rng, n, S, scale=2.0):
    """Points within +-scale m, voxel means 0.4 m from their world points,
    random SPD information W W^T, 70% of the (point, voxel) pairs valid."""
    q = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    R, t = _pose(rng)
    qs = (q @ R.T + t).astype(np.float32)
    mu = (qs[:, None, :] + rng.normal(scale=0.4, size=(n, S, 3))).astype(np.float32)
    B = rng.normal(size=(n, S, 3, 3))
    info = B @ np.swapaxes(B, -1, -2) + 0.5 * np.eye(3)
    W = np.linalg.cholesky(info).astype(np.float32).reshape(n, S, 9)
    valid = (rng.uniform(size=(n, S)) < 0.7).astype(np.float32)
    return q, qs, mu, W, valid, R, t


def _compare(jax_out, torch_out):
    Hj, bj, nj, cj = (np.asarray(a) for a in jax_out)
    Ht, bt, nt, ct = (a.numpy() for a in torch_out)
    assert int(nj) == int(nt)
    np.testing.assert_allclose(Ht, Hj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bt, bj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(ct), float(cj), rtol=RTOL, atol=ATOL)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n", [4096, 3001])
def test_k1_plain_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    q, plane, w = _k1_inputs(rng, n)
    R, t = _pose(rng)
    gate = 0.1
    ref = pallas_kernels.p2plane_fused_terms(
        jnp.asarray(q), jnp.asarray(plane), jnp.asarray(w), jnp.asarray(R),
        jnp.asarray(t), gate, interpret=True)
    out = kernels.p2plane_fused_terms(*_t(q, plane, w, R, t), gate)
    assert int(out[2]) > n // 10
    _compare(ref, out)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("S", [7, 1])
@pytest.mark.parametrize("n", [2048, 2047])
def test_k3_plain_matches_pallas_interpret(n, S, weighted):
    rng = np.random.default_rng(10 * n + S + weighted)
    args = _k3_inputs(rng, n, S)
    ref = pallas_kernels.ndt_fused_terms(*(jnp.asarray(a) for a in args), 20.0, weighted,
                                         interpret=True)
    targs = _t(*args)
    out = kernels.ndt_fused_terms(*targs, 20.0, weighted)
    A = kernels.ndt_rows_plain(*targs, 20.0, weighted).to(torch.float64)
    S_abs = (A.abs().T @ A.abs()).numpy()
    Hj, bj, nj, cj = (np.asarray(a) for a in ref)
    Ht, bt, nt, ct = (a.numpy() for a in out)
    assert int(nt) == int(nj) and 0.5 * n * S < int(nj) < 0.9 * n * S
    for got, want, sab in ((Ht, Hj, S_abs[:6, :6]), (bt, bj, S_abs[:6, 6]),
                           (ct, cj, S_abs[6, 6])):
        tol = ATOL + RTOL * np.abs(want) + 64 * 2.0 ** -24 * sab
        assert (np.abs(got - want) <= tol).all(), np.max(np.abs(got - want) / tol)


@pytest.mark.parametrize("n", [2048, 1500])
def test_k2_plain_matches_pallas_interpret(n):
    rng = np.random.default_rng(100 + n)
    q, rows, w = _k2_inputs(rng, n)
    R, t = _pose(rng)
    gate = 0.3
    ref = pallas_kernels.p2plane_pick_fused_terms(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(w), jnp.asarray(R),
        jnp.asarray(t), gate, interpret=True)
    out = kernels.p2plane_pick_fused_terms(*_t(q, rows, w, R, t), gate)
    assert int(out[2]) > 0
    _compare(ref, out)


def test_all_masked_gives_zero_and_stays_finite():
    """Padded points sit at PAD_COORD = 1e6 with w = 0: G must be exactly 0."""
    n = 1000
    q = np.full((n, 3), 1e6, np.float32)
    plane = np.tile(np.array([[0, 0, 1, 0]], np.float32), (n, 1))
    w = np.zeros(n, np.float32)
    rows = np.zeros((n, 7, 8), np.float32)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for out in (kernels.p2plane_fused_terms(*_t(q, plane, w, R, t), 0.1),
                kernels.p2plane_pick_fused_terms(*_t(q, rows, w, R, t), 0.1)):
        H, b, cnt, chi2 = out
        assert int(cnt) == 0
        assert torch.all(H == 0) and torch.all(b == 0) and float(chi2) == 0.0


@pytest.mark.parametrize("weighted", [True, False])
def test_k3_all_invalid_gives_zero_and_stays_finite(weighted):
    """No valid (point, voxel) pair -- padded points at PAD_COORD, zero
    means, zero factors (the rows of missing or non-estimated voxels):
    G must be exactly 0, as in JAX."""
    n, S = 1000, 7
    q = np.full((n, 3), 1e6, np.float32)
    zeros = np.zeros((n, S, 3), np.float32), np.zeros((n, S, 9), np.float32)
    args = (q, q.copy(), *zeros, np.zeros((n, S), np.float32), np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32))
    H, b, cnt, chi2 = kernels.ndt_fused_terms(*_t(*args), 20.0, weighted)
    assert int(cnt) == 0
    assert torch.all(H == 0) and torch.all(b == 0) and float(chi2) == 0.0
    ref = pallas_kernels.ndt_fused_terms(*(jnp.asarray(a) for a in args), 20.0, weighted,
                                         interpret=True)
    assert int(ref[2]) == 0 and not np.asarray(ref[0]).any()


def test_k2_tie_first_candidate_wins():
    """Two candidates exactly equidistant from the point: the first stencil
    entry must win (strict '<' in the running minimum), as in JAX."""
    n = 64
    rng = np.random.default_rng(5)
    q = (rng.integers(-40, 40, size=(n, 3)) / 8.0).astype(np.float32)
    rows = np.zeros((n, 7, 8), np.float32)
    # candidates 2 and 4 valid, at +-0.5 m along x: identical distance
    for s, off, normal in ((2, 0.5, [0, 0, 1]), (4, -0.5, [0, 1, 0])):
        mu = q + np.array([off, 0, 0], np.float32)
        rows[:, s, 0:3] = normal
        rows[:, s, 3] = -(mu * np.array(normal, np.float32)).sum(1)
        rows[:, s, 4:7] = mu
        rows[:, s, 7] = 1.0
    w = np.ones(n, np.float32)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    out = kernels.p2plane_pick_fused_terms(*_t(q, rows, w, R, t), 1.0)
    # with only candidate 2 valid, the result must be the same
    only_first = rows.copy()
    only_first[:, 4, 7] = 0.0
    first = kernels.p2plane_pick_fused_terms(*_t(q, only_first, w, R, t), 1.0)
    for a, b_ in zip(out, first):
        assert torch.equal(a, b_)
    ref = pallas_kernels.p2plane_pick_fused_terms(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(w), jnp.asarray(R),
        jnp.asarray(t), 1.0, interpret=True)
    _compare(ref, out)


def test_cpu_tensors_never_touch_launch_counters():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    q, plane, w = _k1_inputs(rng, 256)
    R, t = _pose(rng)
    kernels.p2plane_fused_terms(*_t(q, plane, w, R, t), 0.1)
    q2, rows, w2 = _k2_inputs(rng, 256)
    kernels.p2plane_pick_fused_terms(*_t(q2, rows, w2, R, t), 0.1)
    kernels.ndt_fused_terms(*_t(*_k3_inputs(rng, 256, 7)), 20.0, True)
    assert kernels.LAUNCHES == {"p2plane_fused_terms": 0, "p2plane_pick_fused_terms": 0,
                                "ndt_fused_terms": 0}


def test_non_cpu_non_cuda_tensors_raise():
    """The seam takes the plain version ONLY for CPU tensors; any other
    device goes to the kernel path, which refuses what it cannot launch."""
    q = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError):
        kernels.p2plane_fused_terms(q, torch.zeros((8, 4), device="meta"),
                                    torch.zeros(8, device="meta"),
                                    torch.eye(3, device="meta"),
                                    torch.zeros(3, device="meta"), 0.1)


def test_grid_size_depends_only_on_n():
    assert kernels.num_blocks(0) == 1
    assert kernels.num_blocks(8191) == kernels.num_blocks(8192) == 32
    assert kernels.num_blocks(65536) == 256
    assert kernels.num_blocks(10 ** 7) == kernels.MAX_BLOCKS


def test_port_fused_pick_matches_unfused_pick():
    """test_icp.py:179 in the port: K2's in-kernel election gives the same
    normal equations as the argmin election feeding K1."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import pointcloud as pcm
    from loc_lib_tpu_torch.utils import lie

    rng = np.random.default_rng(11)
    n = 600
    scene = np.concatenate([
        np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), np.zeros(n)], 1),
        np.stack([rng.uniform(-10, 10, n), np.full(n, -10.0), rng.uniform(0, 5, n)], 1),
        np.stack([np.full(n, -10.0), rng.uniform(-10, 10, n), rng.uniform(0, 5, n)], 1),
    ]).astype(np.float32)
    R_true = oracles.so3_exp(np.array([0.02, -0.03, 0.04]))
    src = ((scene - np.array([0.3, -0.2, 0.15])) @ R_true).astype(np.float32)
    opts = icp.IcpOptions(method="p2plane_vox", dense_dims=(64, 64, 32))
    tgt = icp.set_target(pcm.from_numpy(scene, capacity=2048), opts)
    src_pc = pcm.from_numpy(src, capacity=2048)
    for w, trans in (([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                     ([0.01, -0.02, 0.03], [0.1, -0.05, 0.2])):
        R = lie.so3_exp(torch.tensor(w))
        t = torch.tensor(trans)
        H1, b1, n1, c1 = icp._p2plane_vox_terms(tgt, opts, src_pc, R, t)
        H2, b2, n2, c2 = icp._p2plane_vox_terms_unfused_pick(tgt, opts, src_pc, R, t)
        assert int(n1) == int(n2) and int(n1) > 0
        np.testing.assert_allclose(H1.numpy(), H2.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b1.numpy(), b2.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(c1), float(c2), rtol=RTOL, atol=ATOL)


def _kernel_order_sum(A: torch.Tensor, rows_per_point: int = 1):
    """The CUDA kernels' float32 summation order, emulated on the CPU: one
    thread per point (N <= 256 * MAX_BLOCKS here) summing its rows serially
    (K3: 3 S rows, stencil-major), a 5-level warp-shuffle tree, a serial
    sum over the block's 8 warps, then a serial sum over the blocks.
    Returns (H, b, count, chi2) as the kernel would."""
    n = A.shape[0] // rows_per_point
    nb = kernels.num_blocks(n)
    assert n <= nb * kernels.THREADS
    iu = torch.triu_indices(8, 8)
    P = torch.zeros((nb * kernels.THREADS, iu.shape[1]), dtype=torch.float32)
    for r in range(rows_per_point):
        Ar = A[r::rows_per_point]
        P[:n] = P[:n] + Ar[:, iu[0]] * Ar[:, iu[1]]
    v = P.reshape(nb, kernels.THREADS // 32, 32, -1)
    for off in (16, 8, 4, 2, 1):
        v = v[:, :, :off] + v[:, :, off:2 * off]
    blocks = torch.zeros((nb, iu.shape[1]), dtype=torch.float32)
    for w in range(kernels.THREADS // 32):
        blocks = blocks + v[:, w, 0]
    g = torch.zeros(iu.shape[1], dtype=torch.float32)
    for k in range(nb):
        g = g + blocks[k]
    G = torch.zeros((8, 8), dtype=torch.float32)
    G[iu[0], iu[1]] = g
    G[iu[1], iu[0]] = g
    return G[:6, :6], -G[:6, 6], G[7, 7].to(torch.int32), G[6, 6]


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,n", [("k1", 8192), ("k1", 8191), ("k1", 65536),
                                      ("k2", 8192), ("k2", 8191),
                                      ("k3w", 8192), ("k3d", 8191), ("k3w1", 8192)])
def test_card_check_accepts_kernel_order_and_rejects_planted_errors(kernel, n):
    """The per-entry check chip_smoke holds the CUDA kernels to
    (kernels.check_against_rows, with the kernel's reduction depth): a sum
    of the plain rows in the kernels' own float32 order passes, and a
    result with chi2 = 0, b's translation part dropped, one H entry off by
    1e-3, or a wrong count fails. k3w / k3d: K3 weighted / direct, S = 7;
    k3w1: weighted, S = 1 (the p2line_vox shape)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(n + (kernel == "k2"))
    R, t = (torch.from_numpy(a) for a in _pose(rng))
    if kernel.startswith("k3"):
        S = 1 if kernel == "k3w1" else 7
        weighted = kernel != "k3d"
        *args, R, t = _t(*_k3_inputs(rng, n, S, scale=50.0))   # the card's 50 m scale
        A = kernels.ndt_rows_plain(*args, R, t, 20.0, weighted)
        got = _kernel_order_sum(A, 3 * S)
        plain = kernels.ndt_fused_terms_plain(*args, R, t, 20.0, weighted)
        err, ratio = cs._compare("emulated", got, plain, A, 3 * S)
        assert ratio <= 1.0 and int(got[2]) > n * S // 3
        cs._planted_errors_are_caught("emulated", got, A, 3 * S)
        with pytest.raises(AssertionError):
            cs._compare("planted", (got[0], got[1], got[2] + 1, got[3]), plain, A, 3 * S)
        return
    if kernel == "k1":
        q, x, w = _t(*_k1_inputs(rng, n))
        q = q * 10.0                               # the 50 m scale of the card's cases
        x[:, 3] = -(x[:, :3] * (q @ R.T + t)).sum(1) + torch.from_numpy(
            rng.normal(scale=0.1, size=n).astype(np.float32))
        rows_fn, plain_fn, gate = kernels.p2plane_rows_plain, kernels.p2plane_fused_terms_plain, 0.1
    else:
        q, x, w = _t(*_k2_inputs(rng, n))
        rows_fn, plain_fn, gate = (kernels.p2plane_pick_rows_plain,
                                   kernels.p2plane_pick_fused_terms_plain, 0.3)
    A = rows_fn(q, x, w, R, t, gate)
    got = _kernel_order_sum(A)
    err, ratio = cs._compare("emulated", got, plain_fn(q, x, w, R, t, gate), A)
    assert ratio <= 1.0 and int(got[2]) > n // 10
    cs._planted_errors_are_caught("emulated", got, A)
    H, b, cnt, chi2 = got
    for bad in ((H, b, cnt, torch.zeros_like(chi2)), (H, b, cnt + 1, chi2)):
        with pytest.raises(AssertionError):
            cs._compare("planted", bad, plain_fn(q, x, w, R, t, gate), A)


@pytest.mark.parametrize("pose", ["identity", "perturbed"])
def test_k3_plain_on_p2line_vox_views_matches_pallas_interpret(pose):
    """K3 at S = 1, weighted, on the inputs p2line_vox hands it: the picked
    line rows of a real line table (JAX-built, carried across), with mu and
    W strided views of the (N, 1, 13) rows. The Pallas kernel in interpret
    mode gets the same values; counts exact, entries within the K3 rule of
    this module (the bound of the other K3 cases)."""
    import jax
    from loc_lib_tpu.models import icp as jicp
    from loc_lib_tpu.ops import pointcloud as jpc
    from loc_lib_tpu_torch.io import convert
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import pointcloud as pcm
    from test_torch_icp import _line_pair

    scene, src, _, _ = _line_pair()
    jo = jicp.IcpOptions(method="p2line_vox", dense_dims=(64, 64, 32))
    to = icp.IcpOptions(method="p2line_vox", dense_dims=(64, 64, 32))
    tt = convert.icp_target_from_numpy(jax.tree_util.tree_map(
        np.asarray, jicp.set_target(jpc.from_numpy(scene, capacity=8192), jo))._asdict(), "cpu")
    tsrc = pcm.from_numpy(src, capacity=8192)
    w = [0.0, 0.0, 0.0] if pose == "identity" else [0.01, -0.015, 0.02]
    R = torch.from_numpy(oracles.so3_exp(np.array(w)).astype(np.float32))
    t = torch.tensor([0.0, 0.0, 0.0] if pose == "identity" else [0.15, -0.1, 0.05])
    qs, rows, wt = icp._p2line_vox_rows(tt, to, tsrc, R, t)
    mu, W = rows[..., 0:3], rows[..., 3:12]
    assert mu.shape == (8192, 1, 3) and W.stride() == (13, 13, 1)
    th = to.max_line_distance ** 2
    out = kernels.ndt_fused_terms(tsrc.xyz, qs, mu, W, wt, R, t, th, True)
    ref = pallas_kernels.ndt_fused_terms(
        *(jnp.asarray(np.ascontiguousarray(a.numpy())) for a in (tsrc.xyz, qs, mu, W, wt, R, t)),
        th, True, interpret=True)
    A = kernels.ndt_rows_plain(tsrc.xyz, qs, mu, W, wt, R, t, th, True).to(torch.float64)
    S_abs = (A.abs().T @ A.abs()).numpy()
    Hj, bj, nj, cj = (np.asarray(a) for a in ref)
    Ht, bt, nt, ct = (a.numpy() for a in out)
    assert int(nt) == int(nj) > 1000
    for got, want, sab in ((Ht, Hj, S_abs[:6, :6]), (bt, bj, S_abs[:6, 6]),
                           (ct, cj, S_abs[6, 6])):
        tol = ATOL + RTOL * np.abs(want) + 64 * 2.0 ** -24 * sab
        assert (np.abs(got - want) <= tol).all(), np.max(np.abs(got - want) / tol)
