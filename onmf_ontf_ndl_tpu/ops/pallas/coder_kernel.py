"""Pallas kernels (Triton route) for the sequential BCD sweeps on a GPU.

The two sequential loops of online NMF are Gauss-Seidel sweeps over the
r variables of a nonnegative least-squares problem: the coder updates the
r rows of the code H (sub_iter sweeps), the dictionary update the r
columns of W (one sweep). As XLA loops each variable update is one
dependent loop iteration over the whole iterate. Here one kernel runs the
whole sweep schedule, with the iterate held in registers.

Both kernels share one body, :func:`_sweep_kernel`. It works on an
``(N, R)`` matrix ``X`` whose column ``k`` is variable ``k`` and whose
rows are independent instances (code columns, or dictionary rows):

    X[:, k] <- max(X[:, k] - step_k * (X @ G[k, :] - Bt[:, k] + alpha), 0)

for ``k = 0 .. r-1`` in order, with ``step_k = rs / (G[k, k] + 1)``. The
coder runs it on ``X = H^T`` with ``G = A``, ``Bt = B^T`` and
``rs = rsqrt(i + 10)`` at sweep ``i``; the dictionary update on ``X = W``
with ``G = A^T``, ``Bt = B^T``, ``rs = 1`` and a unit-ball projection of
each updated column.

Each program owns a ``(TN, R)`` tile of instances for all sweeps. One
variable update is one multiply of the tile by a length-R row plus one
reduction along R, fused as

    new_k = max(sum_j X[:, j] * (e_k - step_k G[k, j]) + step_k (Bt[:, k] - alpha), 0)

so the only cross-thread traffic per update is one warp reduction. ``R``
is the rank rounded up to a power of two; padded variables carry zero
Gram rows and columns, padded instances zero data, so neither changes a
real entry. The kernels read ``G``, ``Bt`` and ``X0`` once and write
``X`` once; an XLA loop moves the whole iterate on each of its
``sub_iter * r`` dependent iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["coder_kernel_fits", "coder_sweeps", "dict_kernel_fits",
           "dict_update_sweep"]

# Elements of X one coder program holds, and its warps: 32 f32 registers
# a thread for the tile of X and as many for the tile of Bt. On an H100
# SXM (700 W) 10 sweeps at r=25, n=32768 took 0.77 ms at (64 x 32, 2
# warps) against 0.74-1.13 ms for tiles of 32-256 instances and 1-4
# warps, and 5.48 ms as XLA's loop.
_TILE_ELEMS = 2048
_CODER_WARPS = 2
# Largest padded (D, R) the one-program dictionary kernel takes. On the
# same card it beat XLA's column loop at (d, r) = (300, 25), 512 x 32
# padded (0.28 against 0.79 ms), and lost at (400, 100), 512 x 128
# (1.17 against 1.11 ms).
_DICT_MAX_ELEMS = 16384
# Widest rank the coder keeps in registers (16-row tiles at R = 128).
_CODER_MAX_RANK = 128


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _rank_pad(r: int) -> int:
    return max(8, _pow2(r))


def _dict_rows(d: int) -> int:
    return max(16, _pow2(d))


def coder_kernel_fits(r: int) -> bool:
    """Whether the coder kernel takes rank ``r``. Wider ranks would hold
    tiles of fewer than 16 instances per program; they run the XLA
    sweeps (``ops/coder.py::_code_impl``), which compute the same
    thing."""
    return r <= _CODER_MAX_RANK


def dict_kernel_fits(d: int, r: int) -> bool:
    """Whether the dictionary kernel takes a (d, r) dictionary: one
    program holds all of it, padded to powers of two, and the unit-ball
    projection needs whole columns. Larger ones run
    ``ops/dict_update.py::dict_update_bcd``."""
    return _dict_rows(d) * _rank_pad(r) <= _DICT_MAX_ELEMS


def _sweep_kernel(p_ref, g_ref, b_ref, x0_ref, x_ref, *, r, sweeps,
                  normalize):
    """``sweeps`` Gauss-Seidel sweeps on one (TN, R) tile of X.

    p_ref: (2,) ``[alpha, index of the first sweep]``. normalize=False is
    the coder (step ``rsqrt(i + 10) / (G[k, k] + 1)``); True is the
    dictionary update (step ``1 / (G[k, k] + 1)``, then each new column
    is divided by ``max(1, its norm)``, which needs the whole column in
    this one tile).
    """
    tn, R = x_ref.shape
    alpha = p_ref[0]
    first = p_ref[1]
    b = b_ref[...]
    cols = lax.broadcasted_iota(jnp.int32, (tn, R), 1)
    var = lax.broadcasted_iota(jnp.int32, (R,), 0)

    def sweep(s, x):
        if normalize:
            rs = jnp.float32(1.0)
        else:
            rs = lax.rsqrt(first + s.astype(jnp.float32) + 10.0)

        def update(k, x):
            g = g_ref[k, :]
            step = rs / (g_ref[k, k] + 1.0)
            c = jnp.where(var == k, 1.0, 0.0) - step * g
            sel = jnp.where(cols == k, b - alpha, 0.0)
            new = jnp.maximum(jnp.sum(x * c[None, :] + step * sel, axis=1),
                              0.0)
            if normalize:
                new = new / jnp.maximum(1.0, jnp.sqrt(jnp.sum(new * new)))
            return jnp.where(cols == k, new[:, None], x)

        return lax.fori_loop(0, r, update, x)

    x_ref[...] = lax.fori_loop(0, sweeps, sweep, x0_ref[...])


def _launch(params, G, Bt, X, *, r, sweeps, normalize, tn, num_warps,
            interpret):
    N, R = X.shape
    tile = pl.BlockSpec((tn, R), lambda i: (i, 0))
    return pl.pallas_call(
        functools.partial(_sweep_kernel, r=r, sweeps=sweeps,
                          normalize=normalize),
        out_shape=jax.ShapeDtypeStruct((N, R), jnp.float32),
        grid=(N // tn,),
        in_specs=[pl.BlockSpec((2,), lambda i: (0,)),
                  pl.BlockSpec((R, R), lambda i: (0, 0)), tile, tile],
        out_specs=tile,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="dict_sweep" if normalize else "coder_sweeps",
    )(params, G, Bt, X)


def _pad(M, rows: int, cols: int):
    M = M.astype(jnp.float32)
    return jnp.pad(M, ((0, rows - M.shape[0]), (0, cols - M.shape[1])))


def coder_tile(r: int, n: int, block_n: int | None = None) -> int:
    """Instances per coder program: ``_TILE_ELEMS / R`` (a power of two,
    at least 16), or ``block_n`` when given, never wider than ``n``
    rounded up to a power of two."""
    tn = block_n or max(16, _TILE_ELEMS // _rank_pad(r))
    return min(_pow2(tn), max(16, _pow2(n)))


@functools.partial(
    jax.jit, static_argnames=("sub_iter", "use_stopping", "block_n",
                              "num_warps", "interpret"))
def _coder_sweeps(A, B, H0, alpha, stopping_diff, *, sub_iter, use_stopping,
                  block_n, num_warps, interpret):
    from onmf_ontf_ndl_tpu.ops.coder import _spectral_norm

    r, n = B.shape
    R = _rank_pad(r)
    tn = coder_tile(r, n, block_n)
    N = -(-n // tn) * tn
    G = _pad(A, R, R)
    Bt = _pad(B.T, N, R)
    X = _pad(H0.T, N, R)
    alpha = jnp.asarray(alpha, jnp.float32)
    launch = functools.partial(
        _launch, G=G, Bt=Bt, r=r, normalize=False, tn=tn,
        num_warps=num_warps or _CODER_WARPS, interpret=interpret)

    if not use_stopping:
        X = launch(jnp.stack([alpha, jnp.float32(0.0)]), X=X, sweeps=sub_iter)
    else:
        # the reference's global rule: stop once the relative spectral
        # change of the whole batch over one sweep is <= stopping_diff.
        # It reduces over every tile, so each sweep is one launch.
        def cond(c):
            i, dist, _ = c
            return jnp.logical_and(i < sub_iter, dist > stopping_diff)

        def body(c):
            i, _, X = c
            Xn = launch(jnp.stack([alpha, i.astype(jnp.float32)]), X=X,
                        sweeps=1)
            return i + 1, _spectral_norm(Xn - X) / _spectral_norm(X), Xn

        _, _, X = lax.while_loop(
            cond, body, (jnp.int32(0), jnp.float32(jnp.inf), X))
    return X[:n, :r].T.astype(B.dtype)


def coder_sweeps(A: jax.Array, B: jax.Array, H0: jax.Array, alpha=0.0, *,
                 sub_iter: int = 10, stopping_diff: float | None = None,
                 block_n: int | None = None, num_warps: int | None = None,
                 interpret: bool = False) -> jax.Array:
    """Nonnegative sparse-coding sweeps from Gram form, as one kernel.

    Args:
      A: (r, r) = W^T W.   B: (r, n) = W^T X.   H0: (r, n) start iterate.
      stopping_diff: ``None`` runs exactly ``sub_iter`` sweeps in one
        launch. A float keeps the reference's global stopping rule: an
        XLA ``while_loop`` launches one sweep at a time (with that
        sweep's step) and stops when the relative spectral change of
        the whole batch is ``<= stopping_diff``.
      block_n, num_warps: tile width and warps of a program (defaults:
        :func:`coder_tile` and 2).
      interpret: run under the Pallas interpreter (tests on the CPU).

    Returns the (r, n) code. Computes what ``ops/coder.py::_code_impl``
    computes, up to f32 summation order. Ranks that
    :func:`coder_kernel_fits` refuses run ``_code_impl`` itself.
    """
    r = B.shape[0]
    use_stopping = stopping_diff is not None
    sd = jnp.asarray(stopping_diff if use_stopping else 0.0, B.dtype)
    if not coder_kernel_fits(r):
        from onmf_ontf_ndl_tpu.ops.coder import _code_impl

        return _code_impl(A, B, H0, jnp.asarray(alpha, B.dtype), sd,
                          jnp.asarray(0.0, B.dtype), int(sub_iter),
                          use_stopping, False)
    return _coder_sweeps(A, B, H0, alpha, sd, sub_iter=int(sub_iter),
                         use_stopping=use_stopping, block_n=block_n,
                         num_warps=num_warps, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("interpret",))
def dict_update_sweep(W: jax.Array, A: jax.Array, B: jax.Array, *,
                      interpret: bool = False) -> jax.Array:
    """Column-BCD dictionary update (one sweep over all columns) as one
    single-program kernel.

    Args: W (d, r), A (r, r), B (r, d). Returns the updated W (d, r).
    Computes what ``ops/dict_update.py::dict_update_bcd`` computes, for
    any A (the kernel reads rows of ``A^T``, the columns of A that the
    XLA path reads), up to f32 summation order. Shapes that
    :func:`dict_kernel_fits` refuses run ``dict_update_bcd`` itself.
    """
    d, r = W.shape
    if not dict_kernel_fits(d, r):
        from onmf_ontf_ndl_tpu.ops.dict_update import dict_update_bcd

        return dict_update_bcd(W, A, B)
    R, D = _rank_pad(r), _dict_rows(d)
    out = _launch(jnp.zeros((2,), jnp.float32), _pad(A.T, R, R),
                  _pad(B.T, D, R), _pad(W, D, R), r=r, sweeps=1,
                  normalize=True, tn=D,
                  num_warps=max(4, D * R // (64 * 32)),
                  interpret=interpret)
    return out[:d, :r].astype(W.dtype)
