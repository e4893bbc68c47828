"""Tests for the FISTA coder mode — the fully parallel opt-in
alternative to the reference's Gauss-Seidel sweeps (same objective
``0.5|X - WH|^2 + alpha|H|_1``, H >= 0; no sequential row chain).

Not a parity path: quality is asserted against the BCD coder's objective
at equal sweep counts (FISTA should match or beat it), not element-wise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from onmf_ontf_ndl_tpu.ops.coder import nonneg_code_gram

RNG = np.random.default_rng(5)


def _problem(d=80, r=20, n=300, alpha=0.0, seed=None):
    rng = np.random.default_rng(seed) if seed is not None else RNG
    W = rng.random((d, r)).astype(np.float32)
    X = rng.random((d, n)).astype(np.float32)
    H0 = rng.random((r, n)).astype(np.float32)
    A = jnp.asarray(W.T @ W)
    B = jnp.asarray(W.T @ X)

    def obj(H):
        H = np.asarray(H)
        return (0.5 * np.linalg.norm(X - W @ H) ** 2
                + alpha * np.abs(H).sum())

    return A, B, jnp.asarray(H0), obj


@pytest.mark.parametrize("alpha", [0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fista_objective_beats_or_matches_bcd(alpha, seed):
    A, B, H0, obj = _problem(alpha=alpha, seed=seed)
    H_bcd = nonneg_code_gram(A, B, H0, alpha=alpha, sub_iter=10,
                             stopping_diff=None, backend="xla")
    H_fista = nonneg_code_gram(A, B, H0, alpha=alpha, sub_iter=10,
                               stopping_diff=None, method="fista")
    assert (np.asarray(H_fista) >= 0).all()
    # measured: FISTA-10 lands below GS-10 on dense random Grams; allow
    # a few percent of slack for seeds where they tie
    assert obj(H_fista) <= obj(H_bcd) * 1.05
    assert obj(H_fista) < obj(H0) * 0.05


def test_fista_early_stop_converges():
    A, B, H0, obj = _problem()
    H_full = nonneg_code_gram(A, B, H0, sub_iter=50, stopping_diff=None,
                              method="fista")
    H_stop = nonneg_code_gram(A, B, H0, sub_iter=50, stopping_diff=0.01,
                              method="fista")
    # the stopped iterate is a valid approximate solution: within a few
    # percent of the 50-sweep objective
    assert obj(H_stop) <= obj(H_full) * 1.10
    assert (np.asarray(H_stop) >= 0).all()


def test_fista_rejects_radius_and_bad_method():
    A, B, H0, _ = _problem()
    with pytest.raises(ValueError):
        nonneg_code_gram(A, B, H0, radius=1.0, method="fista")
    with pytest.raises(ValueError):
        nonneg_code_gram(A, B, H0, method="jacobi")


def test_train_dict_fista_learns():
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state

    rng = np.random.default_rng(3)
    d, r, n = 60, 10, 400
    Wt = np.abs(rng.standard_normal((d, r))).astype(np.float32)
    Wt /= np.linalg.norm(Wt, axis=0)
    Ht = (np.abs(rng.standard_normal((r, n)))
          * (rng.random((r, n)) < 0.3)).astype(np.float32)
    X = jnp.asarray(Wt @ Ht + 0.01 * rng.random((d, n)), jnp.float32)

    state = init_state(jax.random.key(0), d, r)
    st_f, _, metrics = train_dict(
        state, X, iterations=60, batch_size=100, coder="fista",
        stopping_diff=None, return_metrics=True)
    st_b, _ = train_dict(
        state, X, iterations=60, batch_size=100, coder="bcd",
        stopping_diff=None)

    W_f, W_b = np.asarray(st_f.W), np.asarray(st_b.W)
    assert (W_f >= 0).all()
    assert (np.linalg.norm(W_f, axis=0) <= 1.0 + 1e-5).all()
    # training objective decreased over the run
    m = np.asarray(metrics)
    assert m[-5:].mean() < m[:5].mean()

    # both coders reach comparable reconstruction error
    def recon_err(W):
        A = jnp.asarray(W.T @ W)
        B = jnp.asarray(W.T @ np.asarray(X))
        H = nonneg_code_gram(A, B, jnp.asarray(
            np.random.default_rng(0).random((r, n), ).astype(np.float32)),
            sub_iter=20, stopping_diff=None, backend="xla")
        return float(np.linalg.norm(np.asarray(X) - W @ np.asarray(H))
                     / np.linalg.norm(np.asarray(X)))

    ef, eb = recon_err(W_f), recon_err(W_b)
    assert ef < eb * 1.15, (ef, eb)


def test_onlinenmf_shell_fista():
    from onmf_ontf_ndl_tpu import OnlineNMF

    rng = np.random.default_rng(9)
    X = rng.random((40, 200)).astype(np.float32)
    nmf = OnlineNMF(X, n_components=8, iterations=20, batch_size=50,
                    coder="fista", stopping_diff=None)
    W, A, B, C, code = nmf.train_dict()
    assert W.shape == (40, 8)
    assert (np.asarray(W) >= 0).all()
    H = nmf.sparse_code(X, W)
    err = (np.linalg.norm(X - np.asarray(W) @ np.asarray(H))
           / np.linalg.norm(X))
    assert err < 0.5


def test_image_app_fista_smoke():
    from onmf_ontf_ndl_tpu.apps.image import ImageReconstructor

    rng = np.random.default_rng(2)
    img = rng.random((24, 24)).astype(np.float32)
    rec = ImageReconstructor(data=img, n_components=6, iterations=3,
                             sub_iterations=3, num_patches=16, batch_size=8,
                             patch_size=4, is_color=False, coder="fista",
                             downscale_factor=1)
    W = np.asarray(rec.train_dict())
    assert W.shape == (16, 6) and (W >= 0).all() and W.max() > 0
    out = rec.reconstruct_image(data=img, patch_size=4)
    assert np.asarray(out).shape == (24, 24)


def test_dp_fista_matches_single_device():
    # fista is deterministic given H0, so DP (psum'd statistics) must be
    # numerically equal to the single-device step on the same batch
    import jax
    from onmf_ontf_ndl_tpu.models.onmf import onmf_step
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.parallel.dp import dp_onmf_step, shard_batch
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_mesh({"dp": 4}, jax.devices()[:4])
    d, r, n = 24, 6, 32
    state = init_state(jax.random.key(0), d, r)
    X = jax.random.uniform(jax.random.key(1), (d, n))
    H0 = jax.random.uniform(jax.random.key(2), (r, n))

    st1, H1 = onmf_step(state, X, H0=H0, stopping_diff=None, coder="fista",
                        backend="xla")
    st2, H2 = dp_onmf_step(mesh, state, shard_batch(mesh, X),
                           H0=shard_batch(mesh, H0), stopping_diff=None,
                           coder="fista", backend="xla")
    np.testing.assert_allclose(np.asarray(H2), np.asarray(H1), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(st2.W), np.asarray(st1.W),
                               rtol=2e-5, atol=1e-6)


def test_coder_typo_rejected_everywhere():
    from onmf_ontf_ndl_tpu.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state

    state = init_state(jax.random.key(0), 8, 3)
    X = jnp.ones((8, 10))
    with pytest.raises(ValueError, match="coder"):
        train_dict(state, X, iterations=3, batch_size=4, coder="fsita")
    rec = ImageReconstructor(data=np.ones((12, 12), np.float32),
                             n_components=3, iterations=2, sub_iterations=2,
                             num_patches=8, batch_size=4, patch_size=3,
                             is_color=False, coder="FISTA")
    with pytest.raises(ValueError, match="coder"):
        rec.train_dict()


def test_fista_bf16_objective_quality():
    """coder='fista_bf16' (bf16 matmul inputs, f32 accumulation and
    pointwise) must land within a small relative objective gap of the
    f32 FISTA at equal sweeps — the gradient rounding perturbs the
    iterate path but not solution quality. Opt-in production mode."""
    for alpha, seed in ((0.0, 0), (1.0, 3)):
        A, B, H0, obj = _problem(alpha=alpha, seed=seed)
        H32 = nonneg_code_gram(A, B, H0, alpha=alpha, sub_iter=20,
                               stopping_diff=None, backend="xla",
                               method="fista")
        H16 = nonneg_code_gram(A, B, H0, alpha=alpha, sub_iter=20,
                               stopping_diff=None, backend="xla",
                               method="fista_bf16")
        o32, o16 = obj(H32), obj(H16)
        assert o16 <= o32 * 1.005 + 1e-6, (o16, o32)
        assert (np.asarray(H16) >= 0).all()


def test_train_dict_fista_bf16_learns():
    """End-to-end training with coder='fista_bf16' reaches an objective
    comparable to the f32 FISTA run (same seeds)."""
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.ops.coder import nonneg_code

    rng = np.random.default_rng(7)
    d, r, n = 60, 8, 400
    Wt = np.abs(rng.standard_normal((d, r)))
    Wt /= np.linalg.norm(Wt, axis=0)
    X = jnp.asarray(
        (Wt @ (np.abs(rng.standard_normal((r, n)))
               * (rng.random((r, n)) < 0.4))).astype(np.float32))
    outs = {}
    for coder in ("fista", "fista_bf16"):
        st = init_state(jax.random.key(0), d, r, dtype=jnp.float32)
        st, _ = train_dict(st, X, iterations=60, batch_size=64,
                           stopping_diff=None, coder=coder)
        H = nonneg_code(X, st.W, key=jax.random.key(1), alpha=0.0,
                        sub_iter=30, stopping_diff=None, method="fista")
        outs[coder] = float(jnp.linalg.norm(X - st.W @ H)
                            / jnp.linalg.norm(X))
    assert outs["fista_bf16"] <= outs["fista"] * 1.1 + 1e-3, outs
