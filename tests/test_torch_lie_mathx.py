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
