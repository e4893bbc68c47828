"""Online nonnegative matrix factorization (ONMF) for streaming/Markovian data.

Implements the online NMF of Lyu-Needell-Balzano (JMLR 21(251), 2020) as
one compiled program: the whole inner training loop is a single jitted
``lax.scan`` over an immutable :class:`OnmfState` pytree — no
per-iteration host round trips.

Algorithm parity with the reference ``Online_NMF``
(``/root/reference/src/onmf.py:20-226``):

- per-step: sparse-code the batch, update the streaming aggregates with
  weight ``t^-beta``, then run one column-BCD pass on the dictionary
  (``/root/reference/src/onmf.py:119-167``);
- the dictionary update uses the *pre-update* aggregates, exactly as the
  reference does (``/root/reference/src/onmf.py:161``, same in
  ``/root/reference/src/ontf.py:151``); opt into fresh aggregates with
  ``dict_from="fresh"``;
- the ``t^-beta`` schedule and its "history" bookkeeping (final counter =
  ``t0 + iterations``, leaving a one-step gap between warm-started runs)
  are preserved so resume semantics match
  (``/root/reference/src/onmf.py:162,197-204``).

Deliberate, documented deviations (SURVEY.md §3.1):

- aggregates are threaded *correctly* across inner iterations (the
  reference's ``train_dict`` rebuilds them from the initial values each
  iteration — ``/root/reference/src/onmf.py:217`` — while its drivers and
  ``ontf.py:236`` assume correct threading; we implement the paper
  semantics that all callers assume);
- the public contract is the canonical 5-tuple
  ``(W, At, Bt, Ct, H)`` with separate ``ini_A/ini_B/ini_C`` kwargs that
  every reference driver uses (``/root/reference/image_reconstruction.py:289-312``);
- code accumulation at duplicate subsample indices adds every
  contribution (NumPy's fancy ``+=`` silently drops duplicates).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu.ops.coder import nonneg_code_gram
from onmf_ontf_ndl_tpu.ops.dict_update import dict_update_bcd

__all__ = ["OnlineNMF", "onmf_step", "train_dict"]


def onmf_step(
    state: OnmfState,
    X: jax.Array,
    t: jax.Array | None = None,
    *,
    H0: jax.Array | None = None,
    alpha: float | jax.Array = 0.0,
    beta: float | jax.Array = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = 0.01,
    dict_from: str = "stale",
    backend: str = "auto",
    coder: str = "bcd",
) -> tuple[OnmfState, jax.Array]:
    """One online-NMF step on a data batch ``X`` (d, n).

    Args:
      state: current optimizer state.
      t: step index driving the ``t^-beta`` aggregate weight; defaults to
        ``state.t + 1``.
      H0: optional (r, n) initial code iterate; drawn uniform [0,1) from
        the state's PRNG key when omitted.
      dict_from: "stale" updates W from the pre-step aggregates (reference
        semantics, ``/root/reference/src/onmf.py:161``); "fresh" uses the
        just-updated ones (paper semantics).
      backend: "auto" | "xla" | "pallas" | "pallas_interpret" — "auto"
        runs the bcd sweeps and dictionary update as GPU kernels on a GPU
        and as XLA loops elsewhere (``ops.pallas.resolve_backend``).
      coder: "bcd" (reference-parity Gauss-Seidel sweeps), "fista"
        (fully parallel accelerated projected gradient — same
        objective, typically a better final objective at equal sweeps;
        an opt-in non-parity mode), or
        "fista_bf16" (fista with bf16 matmul inputs + f32 accumulation
        — the mixed-precision production mode; objective-level quality
        asserted in tests/test_fista.py).

    Returns:
      (new_state, H) where H is the (r, n) nonnegative code of the batch.
    """
    if dict_from not in ("stale", "fresh"):
        raise ValueError(f"dict_from must be 'stale' or 'fresh', got {dict_from!r}")
    if coder not in ("bcd", "fista", "fista_bf16"):
        raise ValueError(
            f"coder must be 'bcd', 'fista' or 'fista_bf16', got {coder!r}")
    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    key = state.key
    if t is None:
        t = state.t + 1.0
    t = jnp.asarray(t, state.W.dtype)

    if H0 is None:
        key, hkey = jax.random.split(key)
        H0 = jax.random.uniform(hkey, (state.r, X.shape[1]),
                                dtype=state.W.dtype)

    use_stopping = stopping_diff is not None
    sd = jnp.asarray(stopping_diff if use_stopping else 0.0, state.W.dtype)
    new_state, H = _step_inner(
        state, X, t, H0, alpha, beta, sub_iter, use_stopping, sd, dict_from,
        resolve_backend(backend), coder=coder,
    )
    return dataclasses.replace(new_state, key=key), H


@functools.partial(
    jax.jit,
    static_argnames=(
        "iterations", "batch_size", "subsample", "sub_iter",
        "use_stopping", "track_code", "dict_from", "backend",
        "track_metrics", "psum_axis", "coder", "sampling",
    ),
)
def _train_scan(
    state: OnmfState,
    X: jax.Array,
    code0: jax.Array,
    alpha: jax.Array,
    beta: jax.Array,
    stopping_diff: jax.Array,
    iterations: int,
    batch_size: int,
    subsample: bool,
    sub_iter: int,
    use_stopping: bool,
    track_code: bool,
    dict_from: str,
    backend: str = "xla",
    track_metrics: bool = False,
    psum_axis: str | None = None,
    coder: str = "bcd",
    sampling: str = "iid",
):
    # every training path (apps, DP layer, CLI configs) funnels through
    # here — validate at trace time so a typo'd coder can't silently run
    # the default bcd path
    if sampling not in ("iid", "block"):
        raise ValueError(f"sampling must be 'iid' or 'block', got {sampling!r}")
    if coder not in ("bcd", "fista", "fista_bf16"):
        raise ValueError(
            f"coder must be 'bcd', 'fista' or 'fista_bf16', got {coder!r}")
    n = X.shape[1]
    r = state.r
    t0 = state.t

    use_block = subsample and sampling == "block"
    if use_block:
        # Block sampling (opt-in; PARITY.md deviation #12): permute the
        # pool once, then each step takes a CONTIGUOUS wrap-around block
        # at a random offset, a dynamic_slice that streams at memory
        # bandwidth instead of a random-column gather. Uniform
        # per-column marginal; within-batch sampling is
        # without-replacement per pool pass (vs the reference's
        # iid-with-replacement draw).
        key, pkey = jax.random.split(state.key)
        state = dataclasses.replace(state, key=key)
        perm = jax.random.permutation(pkey, n)
        reps = -(-(n + batch_size) // n)          # ceil, wrap-around room
        Xp = jnp.take(X, perm, axis=1)
        X_tiled = jnp.tile(Xp, (1, reps))[:, :n + batch_size]
        perm_tiled = jnp.tile(perm, reps)[:n + batch_size]

    def body(carry, i):
        st, code = carry
        key, skey, hkey = jax.random.split(st.key, 3)
        st = dataclasses.replace(st, key=key)
        if psum_axis is not None:
            # replicated key -> per-device subsample/H0 streams
            me = lax.axis_index(psum_axis)
            skey = jax.random.fold_in(skey, me)
            hkey = jax.random.fold_in(hkey, me)
        if use_block:
            off = jax.random.randint(skey, (), 0, n)
            Xb = lax.dynamic_slice(X_tiled, (0, off), (X.shape[0], batch_size))
            idx = (lax.dynamic_slice(perm_tiled, (off,), (batch_size,))
                   if track_code else None)
        elif subsample:
            idx = jax.random.randint(skey, (batch_size,), 0, n)
            Xb = jnp.take(X, idx, axis=1)
        else:
            # full-batch path: no gather of the identity index set
            idx = None
            Xb = X
        H0 = jax.random.uniform(hkey, (r, Xb.shape[1]), dtype=X.dtype)
        st, H = _step_inner(
            st, Xb, t0 + jnp.asarray(i, X.dtype), H0, alpha, beta,
            sub_iter, use_stopping, stopping_diff, dict_from, backend,
            psum_axis, coder=coder,
        )
        if track_code:
            code = code.at[:, idx].add(H) if subsample else code + H
        if track_metrics:
            # per-step batch objective 0.5|Xb - W H|^2 + alpha|H|_1
            # (post-update W), a structured training signal the reference
            # only exposes as prints (SURVEY.md §5 metrics plan)
            obj = (0.5 * jnp.sum((Xb - st.W @ H) ** 2)
                   + alpha * jnp.sum(H))
        else:
            obj = None
        return (st, code), obj

    (state, code), metrics = lax.scan(
        body, (state, code0), jnp.arange(1, max(iterations, 1))
    )
    if iterations > 1:
        # mirror the reference's history convention: final counter is
        # t0 + iterations (one past the last step's t).
        state = dataclasses.replace(
            state, t=t0 + jnp.asarray(iterations, X.dtype)
        )
    return state, code, metrics


def _step_inner(
    st, Xb, t, H0, alpha, beta, sub_iter, use_stopping, stopping_diff,
    dict_from, backend="xla", psum_axis=None, coder="bcd",
):
    """onmf_step with the stopping rule threaded as a traced value.

    backend="pallas" (or "pallas_interpret") runs the Gauss-Seidel
    sweeps and the BCD dictionary update as GPU kernels
    (ops/pallas/coder_kernel.py); with early stopping, one launch per
    sweep inside the same global stopping rule. Numerics agree with the
    XLA path to float32 summation-order tolerance (~1e-3 relative after
    10 ReLU-thresholded sweeps).

    psum_axis: when running inside shard_map with the batch columns
    sharded over that mesh axis, the sufficient statistics are psum'd so
    the step equals the single-device step on the concatenated batch
    (the aggregates are linear in the samples; parallel/dp.py).
    """
    if coder not in ("bcd", "fista", "fista_bf16"):
        raise ValueError(
            f"coder must be 'bcd', 'fista' or 'fista_bf16', got {coder!r}")
    W, A, B, C = st.W, st.A, st.B, st.C
    use_kernels = backend != "xla"
    interpret = backend == "pallas_interpret"
    # jax.named_scope: phases show up as annotated regions in
    # jax.profiler traces (SURVEY.md §5 tracing plan)
    with jax.named_scope("onmf.sparse_code"):
        gram = W.T @ W
        proj = W.T @ Xb
        alpha_ = jnp.asarray(alpha, W.dtype)
        if coder in ("fista", "fista_bf16"):
            from onmf_ontf_ndl_tpu.ops.coder import _fista_impl

            H = _fista_impl(gram, proj, H0, alpha_, stopping_diff,
                            int(sub_iter), use_stopping,
                            bf16_matmul=coder == "fista_bf16")
        elif use_kernels:
            from onmf_ontf_ndl_tpu.ops.pallas import coder_sweeps

            H = coder_sweeps(gram, proj, H0, alpha_, sub_iter=int(sub_iter),
                             stopping_diff=stopping_diff if use_stopping
                             else None, interpret=interpret)
        else:
            from onmf_ontf_ndl_tpu.ops.coder import _code_impl

            H = _code_impl(
                gram, proj, H0, alpha_, stopping_diff,
                jnp.asarray(0.0, W.dtype), int(sub_iter), use_stopping, False,
            )
    with jax.named_scope("onmf.aggregates"):
        w_t = t ** (-jnp.asarray(beta, W.dtype))
        hht = H @ H.T
        hxt = H @ Xb.T
        xxt = Xb @ Xb.T if st.tracks_xxt else None
        if psum_axis is not None:
            hht = lax.psum(hht, psum_axis)
            hxt = lax.psum(hxt, psum_axis)
            xxt = lax.psum(xxt, psum_axis) if xxt is not None else None
        A1 = (1.0 - w_t) * A + w_t * hht
        B1 = (1.0 - w_t) * B + w_t * hxt
        C1 = (1.0 - w_t) * C + w_t * xxt if st.tracks_xxt else C
    A_u, B_u = (A, B) if dict_from == "stale" else (A1, B1)
    with jax.named_scope("onmf.dict_update"):
        if use_kernels:
            from onmf_ontf_ndl_tpu.ops.pallas import dict_update_sweep

            W1 = dict_update_sweep(W, A_u, B_u, interpret=interpret)
        else:
            W1 = dict_update_bcd(W, A_u, B_u)
    return dataclasses.replace(st, W=W1, A=A1, B=B1, C=C1, t=t), H


def train_dict(
    state: OnmfState,
    X: jax.Array,
    *,
    iterations: int,
    batch_size: int,
    subsample: bool = True,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = 0.01,
    track_code: bool = True,
    dict_from: str = "stale",
    code0: jax.Array | None = None,
    backend: str = "auto",
    return_metrics: bool = False,
    coder: str = "bcd",
    sampling: str = "iid",
) -> tuple[OnmfState, jax.Array]:
    """Run ``iterations - 1`` online steps over minibatches of ``X`` (d, n).

    The loop count and schedule mirror the reference's
    ``for i in np.arange(1, iterations)`` with step weight
    ``(t0 + i)^-beta`` (``/root/reference/src/onmf.py:206-220``).

    ``sampling`` (only with ``subsample=True``): ``"iid"`` (default)
    draws batch columns iid with replacement like the reference
    (``src/onmf.py:212-214``); ``"block"`` is the opt-in block sampler —
    a contiguous wrap-around block of a once-permuted pool at a random
    per-step offset (uniform marginal, without-replacement per pool
    pass; PARITY.md deviation #12). It replaces the random-column gather
    with a slice that streams at memory bandwidth.

    Returns the final state and the (r, n) accumulated code matrix.
    """
    if dict_from not in ("stale", "fresh"):
        raise ValueError(f"dict_from must be 'stale' or 'fresh', got {dict_from!r}")
    if coder not in ("bcd", "fista", "fista_bf16"):
        raise ValueError(
            f"coder must be 'bcd', 'fista' or 'fista_bf16', got {coder!r}")
    if code0 is None:
        code0 = jnp.zeros((state.r, X.shape[1]), X.dtype)
    use_stopping = stopping_diff is not None
    sd = jnp.asarray(stopping_diff if use_stopping else 0.0, X.dtype)
    if iterations <= 1:
        if return_metrics:
            return state, code0, jnp.zeros((0,), X.dtype)
        return state, code0
    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    state, code, metrics = _train_scan(
        state, X, code0,
        jnp.asarray(alpha, X.dtype), jnp.asarray(beta, X.dtype), sd,
        int(iterations), int(batch_size), bool(subsample), int(sub_iter),
        use_stopping, bool(track_code), dict_from,
        backend=resolve_backend(backend),
        track_metrics=bool(return_metrics), coder=coder, sampling=sampling,
    )
    if return_metrics:
        return state, code, metrics
    return state, code


class OnlineNMF:
    """Ergonomic shell matching the reference driver contract.

    ``OnlineNMF(X, ...).train_dict()`` returns the canonical 5-tuple
    ``(W, At, Bt, Ct, H)`` with warm-start kwargs ``ini_dict / ini_A /
    ini_B / ini_C / history`` — the interface every reference driver uses
    (``/root/reference/image_reconstruction.py:289-312``,
    ``/root/reference/ising_reconstruction.py:116-127,149-163``).
    """

    def __init__(
        self,
        X,
        n_components: int = 100,
        iterations: int = 500,
        batch_size: int = 20,
        ini_dict=None,
        ini_A=None,
        ini_B=None,
        ini_C=None,
        history: float = 0.0,
        alpha: float | None = None,
        beta: float | None = None,
        # reference default: inner steps train on the FULL column matrix
        # (src/onmf.py:32, subsample=False; batch_size only applies when
        # subsampling is enabled)
        subsample: bool = False,
        track_xxt: bool | None = None,
        sub_iter: int = 10,
        stopping_diff: float | None = 0.01,
        dict_from: str = "stale",
        coder: str = "bcd",
        key: jax.Array | None = None,
        seed: int = 0,
        dtype=jnp.float32,
    ):
        self.X = jnp.asarray(X, dtype)
        self.n_components = n_components
        self.iterations = iterations
        self.batch_size = batch_size
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.subsample = subsample
        self.sub_iter = sub_iter
        self.stopping_diff = stopping_diff
        self.dict_from = dict_from
        self.coder = coder
        self.dtype = dtype
        if track_xxt is None:
            track_xxt = ini_C is not None
        if key is None:
            key = jax.random.key(seed)
        self.state = init_state(
            key, self.X.shape[0], n_components,
            track_xxt=track_xxt, dtype=dtype,
            W=ini_dict, A=ini_A, B=ini_B, C=ini_C, t=float(history),
        )
        self.code = jnp.zeros((n_components, self.X.shape[1]), dtype)
        # the configured initial state (immutable pytree), so fit() can
        # restart from it; also remembers the init recipe for a fit(X)
        # with a different feature dimension
        self._init_state = self.state
        self._init_key = key
        self._track_xxt = track_xxt

    @property
    def history(self) -> float:
        return float(self.state.t)

    def sparse_code(self, X, W):
        """Code a batch against W with the instance's alpha (reference
        ``Online_NMF.sparse_code``, ``/root/reference/src/onmf.py:51-90``)."""
        X = jnp.asarray(X, self.dtype)
        W = jnp.asarray(W, self.dtype)
        # deterministic H0 key (str hashes are randomized per process)
        key = jax.random.fold_in(jax.random.key(101), X.shape[1])
        from onmf_ontf_ndl_tpu.ops.coder import nonneg_code

        return nonneg_code(
            X, W, key=key, alpha=self.alpha,
            sub_iter=self.sub_iter, stopping_diff=self.stopping_diff,
            method=self.coder,
        )

    def partial_fit(self, X_batch):
        """True-streaming ingestion: one online step on an incoming batch
        (d, n) — the convenience form of the reference's warm-start
        threading across ``Online_NMF`` instances
        (``image_reconstruction.py:289-312``). Returns self."""
        X_batch = jnp.asarray(X_batch, self.dtype)
        self.state, H = onmf_step(
            self.state, X_batch, alpha=self.alpha, beta=self.beta,
            sub_iter=self.sub_iter, stopping_diff=self.stopping_diff,
            dict_from=self.dict_from, coder=self.coder,
        )
        return self

    def train_dict(self):
        """Learn/refine the dictionary; returns ``(W, At, Bt, Ct, H)``."""
        self.state, self.code = train_dict(
            self.state, self.X,
            iterations=self.iterations, batch_size=self.batch_size,
            subsample=self.subsample, alpha=self.alpha, beta=self.beta,
            sub_iter=self.sub_iter, stopping_diff=self.stopping_diff,
            track_code=True, dict_from=self.dict_from, code0=self.code,
            coder=self.coder,
        )
        st = self.state
        Ct = st.C if st.tracks_xxt else None
        return st.W, st.A, st.B, Ct, self.code

    # ------------------------------------------------------ sklearn-style
    # Convenience shims for users coming from sklearn's NMF/SparseCoder
    # (the reference itself leans on sklearn for coding, src/ontf.py:80-86).
    # Conventions follow sklearn decomposition: samples are ROWS here,
    # while the native API is columns-as-samples.

    @property
    def components_(self):
        """(r, d) dictionary with atoms as rows (sklearn convention)."""
        return self.state.W.T

    def fit(self, X=None):
        """FRESH fit on ``X`` (samples x features; the instance's matrix
        when omitted): the optimizer restarts from the configured initial
        state, per the sklearn contract (a second ``fit`` refits, it does
        not continue — use :meth:`partial_fit` / :meth:`train_dict` for
        incremental training). Returns self."""
        if X is not None:
            self.X = jnp.asarray(X, self.dtype).T
        if self._init_state.W.shape[0] == self.X.shape[0]:
            self.state = self._init_state
        else:
            # feature dimension changed: re-derive a fresh state with the
            # same init recipe (any configured ini_dict no longer fits)
            self.state = init_state(
                self._init_key, self.X.shape[0], self.n_components,
                track_xxt=self._track_xxt, dtype=self.dtype)
        self.code = jnp.zeros((self.n_components, self.X.shape[1]),
                              self.dtype)
        self.train_dict()
        return self

    def transform(self, X):
        """Nonnegative codes of ``X`` (samples x features) against the
        learned dictionary; returns (samples, r)."""
        return self.sparse_code(jnp.asarray(X, self.dtype).T,
                                self.state.W).T

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, H):
        """(samples, r) codes -> (samples, d) reconstruction."""
        return (self.state.W @ jnp.asarray(H, self.dtype).T).T
