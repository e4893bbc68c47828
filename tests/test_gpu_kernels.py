"""The GPU sweep kernels (ops/pallas/coder_kernel.py) and what surrounds
them: the kernels under the Pallas interpreter against the XLA loops and
the NumPy oracle, their lowering for CUDA at real widths, the wrapper's
shape rules and padding, the choice of backend, and the run-time helpers
(compile cache, peaks, mesh order)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oracle_np import code_oracle, dict_oracle
from onmf_ontf_ndl_tpu.ops.coder import _code_impl, nonneg_code_gram
from onmf_ontf_ndl_tpu.ops.dict_update import dict_update_bcd
from onmf_ontf_ndl_tpu.ops.pallas import (
    coder_kernel_fits, coder_sweeps, dict_kernel_fits, dict_update_sweep,
    resolve_backend)
from onmf_ontf_ndl_tpu.ops.pallas.coder_kernel import coder_tile

F32 = jnp.float32


def _coder_problem(r, n, seed=0, asym=False):
    rng = np.random.default_rng(seed * 1000 + r * 10 + n)
    d = 3 * r + 5
    W = rng.random((d, r)).astype(np.float32)
    X = rng.random((d, n)).astype(np.float32)
    H0 = rng.random((r, n)).astype(np.float32)
    A = W.T @ W
    if asym:
        A = A + 0.3 * rng.random((r, r)).astype(np.float32)
    return W, X, H0, jnp.asarray(A), jnp.asarray(W.T @ X)


def _xla_code(A, B, H0, alpha, sub_iter, stop=None):
    return _code_impl(A, B, jnp.asarray(H0), F32(alpha), F32(stop or 0.0),
                      F32(0.0), sub_iter, stop is not None, False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# --------------------------------------------------------------- coder


@pytest.mark.parametrize("n,alpha,sub_iter", [(50, 0.0, 10), (300, 0.7, 4)])
@pytest.mark.parametrize("r", [1, 7, 25, 32, 100])
def test_coder_kernel_matches_xla(r, n, alpha, sub_iter):
    # n = 50 and 300 are not multiples of the tile: padded instances
    _, _, H0, A, B = _coder_problem(r, n)
    want = _xla_code(A, B, H0, alpha, sub_iter)
    got = coder_sweeps(A, B, jnp.asarray(H0), alpha, sub_iter=sub_iter,
                       interpret=True)
    assert got.shape == (r, n)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("r", [1, 7, 25, 32, 100])
def test_coder_kernel_matches_numpy_oracle(r):
    W, X, H0, A, B = _coder_problem(r, 90, seed=1)
    want = code_oracle(X.astype(np.float64), W.astype(np.float64),
                       H0.astype(np.float64), alpha=0.2, sub_iter=10,
                       stopping_diff=None)
    got = coder_sweeps(A, B, jnp.asarray(H0), 0.2, sub_iter=10,
                       interpret=True)
    # f32 kernel against the f64 oracle
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("r", [7, 25])
def test_coder_kernel_asymmetric_gram(r):
    # the kernel reads row k of A for variable k, as the XLA loop does
    _, _, H0, A, B = _coder_problem(r, 70, asym=True)
    want = _xla_code(A, B, H0, 0.1, 6)
    got = coder_sweeps(A, B, jnp.asarray(H0), 0.1, sub_iter=6,
                       interpret=True)
    assert _rel(got, want) < 1e-5


def _oracle_sweeps_taken(W, X, H0, stop, sub_iter):
    """Sweeps the reference's global rule runs before it stops."""
    gram, proj = W.T @ W, W.T @ X
    H, i, rel = H0.astype(np.float64).copy(), 0, np.inf
    while i < sub_iter and rel > stop:
        Hp = H.copy()
        for k in range(H.shape[0]):
            g = gram[k] @ H - proj[k]
            H[k] = np.maximum(H[k] - g / (np.sqrt(i + 10.0)
                                          * (gram[k, k] + 1.0)), 0.0)
        rel = np.linalg.norm(H - Hp, 2) / np.linalg.norm(Hp, 2)
        i += 1
    return i


@pytest.mark.parametrize("n", [64, 513])
@pytest.mark.parametrize("stop", [0.01, 0.05, 0.2])
def test_earlystop_matches_xla_global_rule(stop, n):
    # one launch per sweep inside the global rule: same sweep count and
    # same iterate as the XLA while_loop (n = 513 spans many tiles)
    W, X, H0, A, B = _coder_problem(25, n, seed=2)
    want = _xla_code(A, B, H0, 0.0, 10, stop)
    got = coder_sweeps(A, B, jnp.asarray(H0), 0.0, sub_iter=10,
                       stopping_diff=stop, interpret=True)
    assert _rel(got, want) < 1e-5
    sweeps = _oracle_sweeps_taken(W.astype(np.float64),
                                  X.astype(np.float64), H0, stop, 10)
    fixed = coder_sweeps(A, B, jnp.asarray(H0), 0.0, sub_iter=sweeps,
                         interpret=True)
    assert _rel(got, fixed) < 1e-6


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_coder_kernel_keeps_dtype_and_shape(dtype):
    _, _, H0, A, B = _coder_problem(5, 33)
    got = coder_sweeps(A.astype(dtype), B.astype(dtype),
                       jnp.asarray(H0, dtype), 0.0, sub_iter=2,
                       interpret=True)
    assert got.shape == (5, 33) and got.dtype == dtype
    assert (np.asarray(got) >= 0).all()


def test_wide_rank_runs_the_xla_sweeps():
    # the documented shape rule, not a caught failure: r > 128 runs
    # _code_impl itself, so the result is bit-identical
    r = 130
    assert not coder_kernel_fits(r)
    _, _, H0, A, B = _coder_problem(r, 20)
    want = _xla_code(A, B, H0, 0.0, 2)
    got = coder_sweeps(A, B, jnp.asarray(H0), 0.0, sub_iter=2,
                       interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("r,n,block_n,tn", [
    (25, 32768, None, 64), (100, 16384, None, 16), (1, 50, None, 64),
    (7, 1000, None, 256), (25, 10, None, 16), (25, 5000, 100, 128)])
def test_coder_tile_rule(r, n, block_n, tn):
    # 2048 elements of X a program, powers of two, at least 16, never
    # past n rounded up to a power of two
    assert coder_tile(r, n, block_n) == tn


@pytest.mark.parametrize("fits,expected", [
    (lambda: coder_kernel_fits(128), True),
    (lambda: coder_kernel_fits(129), False),
    (lambda: dict_kernel_fits(300, 25), True),
    (lambda: dict_kernel_fits(400, 100), False)])
def test_kernel_shape_rules(fits, expected):
    assert fits() is expected


# ---------------------------------------------------------------- dict


@pytest.mark.parametrize("d,r,asym", [(1, 3, True), (20, 3, False),
                                      (129, 8, False),
                                      (300, 25, False), (90, 33, False),
                                      (40, 9, True)])
def test_dict_kernel_matches_xla(d, r, asym):
    rng = np.random.default_rng(d + r)
    W = jnp.asarray(rng.random((d, r)), F32)
    H = rng.random((r, 64)).astype(np.float32)
    if asym:
        A = jnp.asarray(rng.random((r, r)), F32)
    else:
        A = jnp.asarray(H @ H.T / 64)
    B = jnp.asarray(H @ rng.random((64, d)).astype(np.float32) / 64)
    want = dict_update_bcd(W, A, B)
    got = dict_update_sweep(W, A, B, interpret=True)
    assert got.shape == (d, r)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("d,r", [(30, 4), (75, 25), (300, 25)])
def test_dict_kernel_matches_numpy_oracle(d, r):
    rng = np.random.default_rng(3 * d + r)
    W = rng.random((d, r))
    H = rng.random((r, 40))
    X = W @ H + 0.01 * rng.random((d, 40))
    A, B = H @ H.T / 40, H @ X.T / 40
    got = dict_update_sweep(jnp.asarray(W, F32), jnp.asarray(A, F32),
                            jnp.asarray(B, F32), interpret=True)
    assert _rel(got, dict_oracle(W, A, B)) < 1e-4
    g = np.asarray(got)
    assert (g >= 0).all() and (np.linalg.norm(g, axis=0) <= 1 + 1e-5).all()


def test_dict_too_large_runs_dict_update_bcd():
    d, r = 400, 100
    assert not dict_kernel_fits(d, r)
    rng = np.random.default_rng(9)
    W = jnp.asarray(rng.random((d, r)), F32)
    A = jnp.asarray(rng.random((r, r)), F32)
    B = jnp.asarray(rng.random((r, d)), F32)
    np.testing.assert_array_equal(
        np.asarray(dict_update_sweep(W, A, B, interpret=True)),
        np.asarray(dict_update_bcd(W, A, B)))


# ------------------------------------------------- lowering for CUDA


def _lowers_for_cuda(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, F32) for s in shapes]
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    return text.count("__gpu$xla.gpu.triton")


@pytest.mark.parametrize("d,r,n", [(300, 25, 32768), (9, 25, 32768),
                                   (400, 100, 16384)])
def test_kernels_lower_for_cuda_at_real_widths(d, r, n):
    # Pallas -> Triton lowering runs without a GPU: every kernel of the
    # trainer step lowers at the widths the chip runs (what the GPU's
    # compiler then accepts shows only on the card)
    assert _lowers_for_cuda(
        lambda A, B, H: coder_sweeps(A, B, H, 0.0, sub_iter=10),
        (r, r), (r, n), (r, n)) == 1
    assert _lowers_for_cuda(
        lambda A, B, H: coder_sweeps(A, B, H, 0.0, sub_iter=10,
                                     stopping_diff=0.01),
        (r, r), (r, n), (r, n)) == 1
    dict_calls = _lowers_for_cuda(dict_update_sweep, (d, r), (r, r), (r, d))
    assert dict_calls == (1 if dict_kernel_fits(d, r) else 0)


# ------------------------------------------------------------ routing


@pytest.mark.parametrize("backend,want", [
    ("auto", "xla"), ("xla", "xla"),
    ("pallas_interpret", "pallas_interpret")])
def test_resolve_backend_on_cpu(backend, want):
    assert resolve_backend(backend) == want


def test_explicit_pallas_without_gpu_raises():
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_backend("pallas")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("cuda")


def test_resolve_backend_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_backend("auto") == "pallas"
    assert resolve_backend("pallas") == "pallas"
    assert resolve_backend("xla") == "xla"


def test_resolve_backend_follows_default_device(monkeypatch):
    # a GPU process that runs work on its CPU device takes the XLA loops
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert resolve_backend("auto") == "xla"


@pytest.mark.parametrize("stop", [None, 0.05])
def test_nonneg_code_gram_routes_to_the_kernel(stop):
    _, _, H0, A, B = _coder_problem(6, 40)
    xla = nonneg_code_gram(A, B, jnp.asarray(H0), sub_iter=5,
                           stopping_diff=stop, backend="xla")
    ker = nonneg_code_gram(A, B, jnp.asarray(H0), sub_iter=5,
                           stopping_diff=stop, backend="pallas_interpret")
    assert _rel(ker, xla) < 1e-5


def test_radius_coder_stays_xla():
    _, _, H0, A, B = _coder_problem(6, 40)
    want = nonneg_code_gram(A, B, jnp.asarray(H0), sub_iter=3,
                            stopping_diff=None, radius=0.5, backend="xla")
    got = nonneg_code_gram(A, B, jnp.asarray(H0), sub_iter=3,
                           stopping_diff=None, radius=0.5,
                           backend="pallas_interpret")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------ trainer


@pytest.mark.parametrize("stop", [None, 0.05])
@pytest.mark.parametrize("sampling", ["iid", "block"])
def test_train_dict_kernels_match_xla(sampling, stop):
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state

    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.random((30, 120)), F32)
    st0 = init_state(jax.random.key(0), 30, 6, dtype=F32)
    out = {}
    for backend in ("xla", "pallas_interpret"):
        st, code = train_dict(st0, X, iterations=5, batch_size=24,
                              stopping_diff=stop, sampling=sampling,
                              backend=backend)
        out[backend] = (st.W, st.A, code)
    for a, b in zip(out["pallas_interpret"], out["xla"]):
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("stop", [None, 0.05])
def test_dp_train_dict_kernels_match_xla(stop):
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.parallel.dp import dp_train_dict
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 8})
    rng = np.random.default_rng(12)
    X = jnp.asarray(rng.random((20, 128)), F32)
    st0 = init_state(jax.random.key(1), 20, 5, dtype=F32)
    W = {b: dp_train_dict(mesh, st0, X, iterations=4,
                          batch_size_per_device=4, stopping_diff=stop,
                          backend=b).W
         for b in ("xla", "pallas_interpret")}
    assert _rel(W["pallas_interpret"], W["xla"]) < 1e-4


# ------------------------------------------------------ runtime helpers


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    from onmf_ontf_ndl_tpu.utils.runtime import compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed(monkeypatch):
    import onmf_ontf_ndl_tpu
    from onmf_ontf_ndl_tpu.utils.runtime import compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(
        os.path.abspath(onmf_ontf_ndl_tpu.__file__)))
    assert compile_cache_dir() == os.path.join(checkout, ".jax_cache")
    assert compile_cache_dir() == compile_cache_dir()


def test_peaks_known_and_unknown_device():
    from onmf_ontf_ndl_tpu.utils.runtime import peaks_for

    h100 = peaks_for("NVIDIA H100 80GB HBM3")
    assert h100["bf16_flops"] == 989e12 and h100["source"]
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("cpu")


def test_require_gpu_fails_on_cpu():
    from onmf_ontf_ndl_tpu.utils.runtime import require_gpu

    with pytest.raises(SystemExit):
        require_gpu()


def test_precision_policy_names_the_reference_precision():
    from onmf_ontf_ndl_tpu.utils.runtime import describe_precision

    assert "highest" in describe_precision()


def test_mesh_is_row_major_device_order():
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 4, "tp": 2})
    want = np.asarray(jax.devices()).reshape(4, 2)
    assert (mesh.devices == want).all()
    assert (make_mesh().devices == np.asarray(jax.devices())).all()


# ------------------------------------------------------- on the card


@pytest.mark.gpu
def test_compiled_coder_kernel_matches_xla_on_gpu(gpu):
    _, _, H0, A, B = _coder_problem(25, 4096)
    with jax.default_device(gpu), jax.default_matmul_precision("highest"):
        want = _xla_code(A, B, H0, 0.1, 10)
        got = coder_sweeps(A, B, jnp.asarray(H0), 0.1, sub_iter=10)
    assert _rel(got, want) < 1e-5


@pytest.mark.gpu
def test_compiled_dict_kernel_matches_xla_on_gpu(gpu):
    rng = np.random.default_rng(4)
    W = jnp.asarray(rng.random((300, 25)), F32)
    A = jnp.asarray(rng.random((25, 25)), F32)
    B = jnp.asarray(rng.random((25, 300)), F32)
    with jax.default_device(gpu):
        assert _rel(dict_update_sweep(W, A, B),
                    dict_update_bcd(W, A, B)) < 1e-5
