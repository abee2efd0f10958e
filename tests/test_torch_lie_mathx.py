"""Port parity: loc_lib_tpu_torch.utils.lie / mathx against the JAX package
and the float64 oracles. Tolerance atol 1e-6 against JAX (same float32
formulas; ulp-level differences from libm/eigen kernels), oracle tolerances
as in tests/test_lie.py; eigenvectors compared up to sign."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from loc_lib_tpu.utils import lie as jlie, mathx as jmathx
from loc_lib_tpu_torch.utils import lie, mathx
import oracles

torch.set_num_threads(2)

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rotvecs(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:8] *= 1e-5                      # Taylor branch
    w[8:16] *= 3.0 / np.linalg.norm(w[8:16], axis=1, keepdims=True)  # near pi
    return w


@pytest.mark.parametrize("seed", range(3))
def test_so3_exp_log_hat_vee_match_jax(seed):
    w = _rotvecs(seed)
    R_t = lie.so3_exp(_t(w))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(jlie.so3_exp(jnp.asarray(w))), atol=ATOL)
    for i in (20, 40):
        np.testing.assert_allclose(R_t[i].numpy(), oracles.so3_exp(w[i].astype(np.float64)),
                                   atol=1e-5)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(lie.so3_log(_t(R)).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-5)
    np.testing.assert_allclose(lie.hat(_t(w)).numpy(), np.asarray(jlie.hat(jnp.asarray(w))))
    np.testing.assert_array_equal(lie.vee(lie.hat(_t(w))).numpy(), w)


def test_se3_compose_inverse_retract_renormalize_match_jax():
    rng = np.random.default_rng(1)
    Ra = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3), jnp.float32)))
    Rb = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3), jnp.float32)))
    ta, tb = rng.normal(size=(2, 3)).astype(np.float32)
    dx = (rng.normal(size=6) * 0.1).astype(np.float32)
    pairs = [
        (lie.se3_compose(_t(Ra), _t(ta), _t(Rb), _t(tb)),
         jlie.se3_compose(jnp.asarray(Ra), jnp.asarray(ta), jnp.asarray(Rb), jnp.asarray(tb))),
        (lie.se3_inverse(_t(Ra), _t(ta)), jlie.se3_inverse(jnp.asarray(Ra), jnp.asarray(ta))),
        (lie.se3_retract(_t(Ra), _t(ta), _t(dx)),
         jlie.se3_retract(jnp.asarray(Ra), jnp.asarray(ta), jnp.asarray(dx))),
    ]
    for ours, ref in pairs:
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    noisy = (Ra + rng.normal(scale=1e-3, size=(3, 3))).astype(np.float32)
    ours = lie.so3_renormalize(_t(noisy)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jlie.so3_renormalize(jnp.asarray(noisy))),
                               atol=ATOL)
    np.testing.assert_allclose(ours.T @ ours, np.eye(3), atol=1e-5)


def _sym(seed, n=256):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    A = A @ np.swapaxes(A, -1, -2)
    A[:32, 2] = A[:32, 1] = 0.0          # rank-1 / degenerate rows
    A[:32, :, 2] = A[:32, :, 1] = 0.0
    A[32:64] = np.eye(3) * rng.uniform(1, 2, size=(32, 1, 1))  # spherical
    return A.astype(np.float32)


@pytest.mark.parametrize("seed", range(2))
def test_eigh_sym3x3_matches_jax_and_numpy(seed):
    A = _sym(seed)
    vals, vecs = mathx.eigh_sym3x3(_t(A))
    jvals, jvecs = jmathx.eigh_sym3x3(jnp.asarray(A))
    # An exactly spherical A makes p^3 a float32 denormal (1e-45); XLA:CPU
    # flushes it to zero and returns NaN, torch keeps it and returns the
    # triple eigenvalue. Either way the plane-validity gate rejects such a
    # voxel (vals[1] >= 3 vals[0] fails), so compare where JAX is finite and
    # require the port to be finite everywhere.
    jfin = np.isfinite(np.asarray(jvals)).all(axis=1)
    assert jfin[:32].all() and jfin[64:].all()
    assert torch.isfinite(vals).all() and torch.isfinite(vecs).all()
    np.testing.assert_allclose(vals.numpy()[jfin], np.asarray(jvals)[jfin], atol=1e-5, rtol=1e-5)
    # against float64 LAPACK: the closed form's error scales with the
    # largest eigenvalue of the row, and at a double eigenvalue (the rank-1
    # rows) grows to sqrt(float32 eps) ~ 3.5e-4 of it
    ref_vals = np.linalg.eigvalsh(A.astype(np.float64))
    scale = np.maximum(1.0, np.abs(ref_vals).max(axis=1, keepdims=True))
    assert (np.abs(vals.numpy() - ref_vals) <= 3.5e-4 * scale).all()
    # eigenvectors up to sign, where the eigenvalue is well separated
    v, jv = vecs.numpy(), np.asarray(jvecs)
    gaps = np.diff(ref_vals, axis=1)
    for k, sep in ((0, gaps[:, 0]), (2, gaps[:, 1])):
        ok = (sep > 1e-2) & jfin
        dots = np.abs(np.sum(v[ok, :, k] * jv[ok, :, k], axis=1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-5)


def test_solve_gn_6x6_and_masked_stats_match_jax():
    rng = np.random.default_rng(4)
    J = rng.normal(size=(50, 6))
    H = (J.T @ J).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(mathx.solve_gn_6x6(_t(H), _t(b)).numpy(),
                               np.asarray(jmathx.solve_gn_6x6(jnp.asarray(H), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-6)
    # singular H: non-finite like jnp.linalg.solve, never an exception
    assert not torch.isfinite(mathx.solve_gn_6x6(torch.zeros(6, 6), _t(b))).all()
    x = rng.normal(size=(4, 20, 3)).astype(np.float32)
    m = rng.uniform(size=(4, 20)) < 0.7
    ours = mathx.masked_mean_and_cov_diag(_t(x), torch.from_numpy(m))
    ref = jmathx.masked_mean_and_cov_diag(jnp.asarray(x), jnp.asarray(m))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("fit", ["plane", "line", "mean_and_cov"])
def test_neighbour_fits_match_jax(fit):
    """mathx.fit_plane / fit_line / masked_mean_and_cov on batches of 5-NN
    sets (near-planar, near-collinear, and too few points): validity exact,
    values within atol 1e-5 (1e-4 for the plane's 4 coefficients;
    eigenvectors up to sign, on the sets whose scatter determines them)."""
    rng = np.random.default_rng(7)
    n, k = 200, 5
    base = rng.uniform(-20, 20, size=(n, 1, 3))
    if fit == "line":
        d = rng.normal(size=(n, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts = base + d * rng.uniform(-0.5, 0.5, size=(n, k, 1)) \
            + rng.normal(scale=0.01, size=(n, k, 3))
    else:
        u, v = rng.normal(size=(2, n, 1, 3))
        pts = base + u * rng.uniform(-0.5, 0.5, size=(n, k, 1)) \
            + v * rng.uniform(-0.5, 0.5, size=(n, k, 1)) + rng.normal(scale=0.005, size=(n, k, 3))
    pts[:20] += rng.normal(scale=0.5, size=(20, k, 3))        # fits that fail the residual gate
    pts = pts.astype(np.float32)
    mask = rng.uniform(size=(n, k)) < 0.9
    mask[20:30, 1:] = False                                    # a single neighbour
    tp, tm, jp, jm = _t(pts), torch.from_numpy(mask), jnp.asarray(pts), jnp.asarray(mask)
    if fit == "mean_and_cov":
        for a, r in zip(mathx.masked_mean_and_cov(tp, tm), jmathx.masked_mean_and_cov(jp, jm)):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
        return
    if fit == "plane":
        (coef, valid), (jcoef, jvalid) = mathx.fit_plane(tp, tm), jmathx.fit_plane(jp, jm)
        vecs = [(coef.numpy(), np.asarray(jcoef))]
    else:
        (o, d_, valid), (jo, jd, jvalid) = mathx.fit_line(tp, tm, eps=0.5), \
            jmathx.fit_line(jp, jm, eps=0.5)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
        vecs = [(d_.numpy(), np.asarray(jd))]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 100 < int(valid.sum()) < n
    # compare the direction where the scatter determines it: its eigenvalue
    # next to the wanted one at least 5 % of the largest away (float64)
    c = np.where(mask[..., None], pts.astype(np.float64), 0.0)
    cnt = np.maximum(mask.sum(1), 1)[:, None, None]
    dd = (c - c.sum(1, keepdims=True) / cnt) * mask[..., None]
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", dd, dd))
    gap = (lam[:, 1] - lam[:, 0]) if fit == "plane" else (lam[:, 2] - lam[:, 1])
    ok = valid.numpy() & (gap > 0.05 * lam[:, 2])
    assert ok.sum() > 100
    for a, r in vecs:
        sign = np.where(np.sum(a[:, :3] * r[:, :3], axis=1) < 0, -1.0, 1.0)[:, None]
        np.testing.assert_allclose((a * sign)[ok], r[ok], atol=1e-4 if fit == "plane" else 1e-5)


def test_matmul3_solve_and_retract_do_not_depend_on_the_batch():
    """What lets a batched match equal B scalar ones bit for bit: lane k of
    lie.matmul3, of so3_exp, se3_retract and so3_renormalize taken with it
    (as the pose-update plain versions take them), and of
    mathx.solve_gn_6x6 on a (B, ...) batch has the bits of the call on lane
    k alone, for B = 1, 3 and 64; and matmul3 is the matrix product (1e-6)."""
    rng = np.random.default_rng(8)
    B = 64
    mm = lie.matmul3
    R = lie.so3_exp(_t(rng.normal(scale=0.5, size=(B, 3))))
    t = _t(rng.normal(size=(B, 3)))
    dx = _t(rng.normal(scale=0.02, size=(B, 6)))
    J = rng.normal(size=(B, 40, 6))
    H = _t(np.einsum("bni,bnj->bij", J, J))
    b = _t(rng.normal(size=(B, 6)))
    np.testing.assert_allclose(lie.matmul3(R, R.transpose(-1, -2)).numpy(),
                               (R @ R.transpose(-1, -2)).numpy(), atol=1e-6)
    for nb in (1, 3, B):
        Rb, tb = lie.se3_retract(R[:nb], t[:nb], dx[:nb], mm)
        Rn = lie.so3_renormalize(Rb, mm)
        sol = mathx.solve_gn_6x6(H[:nb], b[:nb])
        for k in range(nb):
            Rk, tk = lie.se3_retract(R[k], t[k], dx[k], mm)
            assert torch.equal(Rb[k], Rk) and torch.equal(tb[k], tk)
            assert torch.equal(Rn[k], lie.so3_renormalize(Rk, mm))
            assert torch.equal(sol[k], mathx.solve_gn_6x6(H[k], b[k]))
            assert torch.equal(lie.so3_exp(dx[:nb, :3], mm)[k], lie.so3_exp(dx[k, :3], mm))


def test_lie_products_default_to_the_library_matmul():
    """so3_exp, se3_retract and so3_renormalize multiply with `@` unless a
    product is passed (one launch a product on the card, where the
    op-by-op lie.matmul3 is three); both agree to 1e-6 and match JAX."""
    rng = np.random.default_rng(9)
    w = rng.normal(scale=0.5, size=(16, 3)).astype(np.float32)
    dx = rng.normal(scale=0.05, size=(16, 6)).astype(np.float32)
    R = lie.so3_exp(_t(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jlie.so3_exp(jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(R.numpy(), lie.so3_exp(_t(w), lie.matmul3).numpy(), atol=1e-6)
    Rr, tr = lie.se3_retract(R, _t(w), _t(dx))
    assert torch.equal(Rr, R @ lie.so3_exp(_t(dx)[:, :3]))
    assert torch.equal(lie.so3_renormalize(Rr),
                       lie.so3_renormalize(Rr, torch.matmul))
    np.testing.assert_allclose(lie.so3_renormalize(Rr).numpy(),
                               lie.so3_renormalize(Rr, lie.matmul3).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# SE(3) exp / log, adjoint and the closed-form inverse Jacobians of the pose
# graph (tests/test_lie.py:47, :83, :112), and schur_marginalize
# (tests/test_mathx.py:96). Against JAX: atol 1e-5 (the same float32
# formulas; libm's sin / cos differ by ulps, and the general branch of the
# Jacobian coefficients cancels just above the Taylor threshold, where an ulp
# of 1 - x cot x is ~6e-8 of W^2 entries of ~1e-6).
# ---------------------------------------------------------------------------

def _twists(seed, n=48):
    """Twists with rotation angles across the Taylor branch (theta^2 < 1e-8),
    just above it, small, moderate and close to pi."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    mags = np.array([1e-6, 5e-5, 1e-3, 0.3, 1.5, 2.8], np.float32)
    xi[:, :3] *= (np.resize(mags, n) / np.linalg.norm(xi[:, :3], axis=1))[:, None]
    return xi


@pytest.mark.parametrize("seed", range(2))
def test_se3_exp_log_match_jax(seed):
    xi = _twists(seed)
    R, t = lie.se3_exp(_t(xi))
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    log = lie.se3_log(_t(np.asarray(jR)), _t(np.asarray(jt)))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlie.se3_log(jR, jt)), atol=1e-5)
    # the round trip of test_lie.py:47 (away from pi, where log is ill-posed)
    ok = np.linalg.norm(xi[:, :3], axis=1) < 2.0
    np.testing.assert_allclose(log.numpy()[ok], xi[ok], atol=1e-4)
    xi1 = _t([0.2, -0.1, 0.3, 1.0, 2.0, -0.5])
    np.testing.assert_allclose(lie.se3_log(*lie.se3_exp(xi1)).numpy(), xi1.numpy(), atol=1e-4)


def test_se3_jacobian_inverses_match_jax_and_its_autodiff_oracle():
    """se3_jl_inv / se3_jr_inv (and so3_jl_inv, _se3_Q inside them) equal
    JAX's closed forms (atol 1e-5), and JAX's forward-mode derivative of the
    compositions they claim to differentiate (test_lie.py:83's bounds,
    atol 2e-4, rtol 1e-3)."""
    import jax

    xi = _twists(3, n=12)
    Jl, Jr = lie.se3_jl_inv(_t(xi)), lie.se3_jr_inv(_t(xi))
    np.testing.assert_allclose(Jl.numpy(), np.asarray(jlie.se3_jl_inv(jnp.asarray(xi))),
                               atol=1e-5)
    np.testing.assert_allclose(Jr.numpy(), np.asarray(jlie.se3_jr_inv(jnp.asarray(xi))),
                               atol=1e-5)
    np.testing.assert_allclose(lie.so3_jl_inv(_t(xi[:, :3])).numpy(),
                               np.asarray(jlie.so3_jl_inv(jnp.asarray(xi[:, :3]))), atol=1e-5)
    def left(e, x):
        return jlie.se3_log(*jlie.se3_compose(*jlie.se3_exp(e), *jlie.se3_exp(x)))

    def right(e, x):
        return jlie.se3_log(*jlie.se3_compose(*jlie.se3_exp(x), *jlie.se3_exp(e)))

    z = jnp.zeros(6, jnp.float32)
    for J, f in ((Jl, left), (Jr, right)):
        oracle = jax.jit(jax.vmap(jax.jacfwd(f), in_axes=(None, 0)))(z, jnp.asarray(xi))
        np.testing.assert_allclose(J.numpy(), np.asarray(oracle), atol=2e-4, rtol=1e-3)


def test_se3_adjoint_retract_and_matrix_match_jax():
    """Ad(T) (test_lie.py:112: T Exp(xi) T^-1 = Exp(Ad(T) xi)), the full
    retraction T Exp(dx) and the 4x4 packing, against JAX (atol 1e-5)."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.8, (8, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    t = rng.normal(0, 2, (8, 3)).astype(np.float32)
    xi = rng.normal(0, 0.5, (8, 6)).astype(np.float32)
    Ad = lie.se3_adjoint(_t(R), _t(t))
    np.testing.assert_allclose(Ad.numpy(), np.asarray(jlie.se3_adjoint(jnp.asarray(R),
                                                                       jnp.asarray(t))), atol=1e-5)
    lhs = lie.se3_compose(*lie.se3_compose(_t(R), _t(t), *lie.se3_exp(_t(xi))),
                          *lie.se3_inverse(_t(R), _t(t)))
    rhs = lie.se3_exp(torch.einsum("bij,bj->bi", Ad, _t(xi)))
    np.testing.assert_allclose(lhs[0].numpy(), rhs[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(lhs[1].numpy(), rhs[1].numpy(), atol=1e-4)
    Rr, tr = lie.se3_retract_full(_t(R), _t(t), _t(xi))
    jRr, jtr = jlie.se3_retract_full(jnp.asarray(R), jnp.asarray(t), jnp.asarray(xi))
    np.testing.assert_allclose(Rr.numpy(), np.asarray(jRr), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), atol=1e-5)
    M = lie.se3_matrix(_t(R), _t(t))
    assert torch.equal(M, _t(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(t))))
    back = lie.se3_from_matrix(M)
    assert torch.equal(back[0], _t(R)) and torch.equal(back[1], _t(t))
    assert lie.se3_matrix(_t(R[0]), _t(t[0])).shape == (4, 4)


def test_schur_marginalize_matches_jax_and_the_full_solve():
    """test_mathx.py:96: eliminating the first 3 states leaves the system
    whose solution is the last 6 states of the full solve (atol 1e-3, the
    JAX test's bound); H' and b' within rtol 1e-4 of JAX's."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(9, 9))
    H = (A @ A.T + np.eye(9)).astype(np.float32)
    b = rng.normal(size=9).astype(np.float32)
    Hp, bp = mathx.schur_marginalize(_t(H), _t(b), 3)
    jHp, jbp = jmathx.schur_marginalize(jnp.asarray(H), jnp.asarray(b), 3)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(jHp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bp.numpy(), np.asarray(jbp), rtol=1e-4, atol=1e-4)
    x_full = np.linalg.solve(H.astype(np.float64), b.astype(np.float64))
    x_b = np.linalg.solve(Hp.numpy().astype(np.float64), bp.numpy().astype(np.float64))
    np.testing.assert_allclose(x_b, x_full[3:], atol=1e-3)
