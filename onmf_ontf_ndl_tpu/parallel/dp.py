"""Data-parallel online NMF over a device mesh.

The reference is strictly single-process NumPy (SURVEY.md §2: no
parallelism of any kind). The online-NMF aggregates are *linear* in the
batch samples — ``A`` accumulates ``H H^T`` and ``B`` accumulates
``H X^T`` (``/root/reference/src/onmf.py:155-158``) — which makes the
algorithm exactly data-parallel: shard the patch batch over the ``dp``
mesh axis, sparse-code locally (columns of H are independent given W),
``psum`` the per-shard statistics, and run the identical dictionary
update on every device. The DP result equals the single-device result on
the concatenated batch, which the tests assert on a virtual 8-device CPU
mesh.

All DP entry points run the SAME step/scan code as the single-device
path (``models/onmf.py`` ``_step_inner`` / ``_train_scan`` with
``psum_axis`` set) — no forked math. The shard_map-wrapped jitted
callables are memoized per (mesh, statics) so repeated calls hit the jit
cache instead of retracing.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from onmf_ontf_ndl_tpu.models.state import OnmfState
from onmf_ontf_ndl_tpu.models.onmf import _step_inner, _train_scan

__all__ = ["dp_onmf_step", "dp_train_dict", "dp_train_image_dict",
           "dp_ndl_train", "dp_reconstruct_network_sparse",
           "merge_recon_shards", "dp_recons_edges", "shard_batch",
           "dp_ising_learning", "dp_train_tensor_dict"]


def shard_batch(mesh: Mesh, X: jax.Array, axis: str = "dp") -> jax.Array:
    """Place a (d, n) batch with columns sharded over the mesh axis."""
    return jax.device_put(X, NamedSharding(mesh, P(None, axis)))


@functools.lru_cache(maxsize=64)
def _dp_step_fn(mesh, sub_iter, use_stopping, dict_from, axis, backend,
                coder):
    def local(st, X, t, H0, sd, alpha, beta):
        return _step_inner(st, X, t, H0, alpha, beta, sub_iter,
                           use_stopping, sd, dict_from, backend, axis,
                           coder=coder)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(None, axis), P(), P(None, axis), P(), P(), P()),
        out_specs=(P(), P(None, axis)),
        check_vma=False,
    ))


def dp_onmf_step(
    mesh: Mesh,
    state: OnmfState,
    X: jax.Array,
    t=None,
    *,
    H0: jax.Array | None = None,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = None,
    dict_from: str = "stale",
    axis: str = "dp",
    backend: str = "auto",
    coder: str = "bcd",
):
    """One data-parallel online-NMF step.

    ``X`` (d, n) is column-sharded over ``axis``; ``H0`` (r, n) likewise
    (drawn from the state key when omitted). State is replicated. Returns
    (state, H) with H column-sharded.

    With ``stopping_diff=None`` (fixed ``sub_iter`` sweeps, the default
    here) the DP step is numerically identical to the single-device step
    on the concatenated batch. With early stopping the coder's stopping
    rule becomes shard-local (each shard's relative-change test sees only
    its columns) — semantically a per-shard variant of the batched rule.
    """
    if t is None:
        t = state.t + 1.0
    t = jnp.asarray(t, state.W.dtype)
    if H0 is None:
        key, hkey = jax.random.split(state.key)
        state = dataclasses.replace(state, key=key)
        H0 = jax.random.uniform(hkey, (state.r, X.shape[1]),
                                dtype=state.W.dtype)
        H0 = shard_batch(mesh, H0, axis)

    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    use_stopping = stopping_diff is not None
    sd = jnp.asarray(stopping_diff if use_stopping else 0.0, state.W.dtype)
    step = _dp_step_fn(mesh, int(sub_iter), use_stopping, dict_from, axis,
                       resolve_backend(backend), coder)
    return step(state, X, t, H0, sd,
                jnp.asarray(alpha, state.W.dtype),
                jnp.asarray(beta, state.W.dtype))


@functools.lru_cache(maxsize=64)
def _dp_train_fn(mesh, iterations, batch_size, sub_iter, dict_from, axis,
                 backend, coder, use_stopping, sampling="iid"):
    def local(st, X_local, alpha, beta, sd):
        st, _, _ = _train_scan(
            st, X_local, jnp.zeros((st.r, X_local.shape[1]), X_local.dtype),
            alpha, beta, sd,
            iterations, batch_size, True, sub_iter,
            use_stopping, False, dict_from, backend=backend, psum_axis=axis,
            coder=coder, sampling=sampling,
        )
        return st

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(None, axis), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    ))


def dp_train_dict(
    mesh: Mesh,
    state: OnmfState,
    X: jax.Array,
    *,
    iterations: int,
    batch_size_per_device: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = None,
    dict_from: str = "stale",
    axis: str = "dp",
    backend: str = "auto",
    coder: str = "bcd",
    sampling: str = "iid",
):
    """Data-parallel ``train_dict``: every device subsamples its own
    ``batch_size_per_device`` columns from its shard each iteration;
    aggregate statistics are psum'd. The global effective batch is
    ``batch_size_per_device * mesh.shape[axis]``. Runs the shared
    ``_train_scan`` with ``psum_axis`` set — identical math to the
    single-device path. Returns the final replicated state.

    ``stopping_diff``: defaults to ``None`` (fixed ``sub_iter`` coder
    sweeps — unlike the single-device ``train_dict`` default of 0.01).
    Pass a value to enable the reference early-stopping rule; under DP
    it is evaluated SHARD-LOCALLY (each shard's relative-change test
    sees only its columns), the per-shard analogue of the batched rule.

    ``sampling="block"`` applies the block pool sampler (PARITY.md
    deviation #12) shard-locally: each device permutes and block-slices
    its own shard.
    """
    ndev = mesh.shape[axis]
    n = X.shape[1]
    if n % ndev != 0:
        raise ValueError(
            f"dp_train_dict: data columns ({n}) must divide evenly over "
            f"the {ndev}-way '{axis}' mesh axis")
    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    use_stopping = stopping_diff is not None
    train = _dp_train_fn(mesh, int(iterations), int(batch_size_per_device),
                         int(sub_iter), dict_from, axis,
                         resolve_backend(backend), coder,
                         use_stopping, sampling)
    sd = jnp.asarray(stopping_diff if use_stopping else 0.0, X.dtype)
    return train(state, shard_batch(mesh, X, axis),
                 jnp.asarray(alpha, X.dtype), jnp.asarray(beta, X.dtype),
                 sd)


@functools.lru_cache(maxsize=64)
def _dp_image_fn(mesh, outer_iterations, num_patches, inner_iterations,
                 batch_size, patch_size, sub_iter, dict_from, axis, backend,
                 coder="bcd", use_stopping=False):
    from onmf_ontf_ndl_tpu.ops.patches import (
        extract_patches, random_patch_corners)

    k = patch_size

    def local(st: OnmfState, img, alpha, beta, sd):
        me = lax.axis_index(axis)

        def outer(st, o):
            key, pkey = jax.random.split(st.key)
            pkey = jax.random.fold_in(pkey, me)
            st = dataclasses.replace(st, key=key)
            corners = random_patch_corners(pkey, img.shape[:2], k,
                                           num_patches)
            X = extract_patches(img, corners, k)
            st, _, _ = _train_scan(
                st, X, jnp.zeros((st.r, num_patches), img.dtype),
                alpha, beta, sd,
                inner_iterations, batch_size, True, sub_iter,
                use_stopping, False, dict_from, backend=backend,
                psum_axis=axis, coder=coder,
            )
            return st, None

        st, _ = lax.scan(outer, st, jnp.arange(outer_iterations))
        return st

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    ))


def dp_train_image_dict(
    mesh: Mesh,
    state: OnmfState,
    img: jax.Array,
    *,
    outer_iterations: int,
    num_patches_per_device: int,
    inner_iterations: int,
    batch_size_per_device: int,
    patch_size: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float | None = None,
    dict_from: str = "stale",
    axis: str = "dp",
    backend: str = "auto",
    coder: str = "bcd",
):
    """Data-parallel fused image trainer: every device samples its own
    random patches from the (replicated) image and runs the shared inner
    scan with psum'd aggregate statistics — the multi-chip version of
    :func:`onmf_ontf_ndl_tpu.apps.image.train_image_dict`.

    ``stopping_diff``: ``None`` (default) runs fixed coder sweeps; a
    value enables the early-stopping rule, evaluated shard-locally.
    """
    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    use_stopping = stopping_diff is not None
    train = _dp_image_fn(mesh, int(outer_iterations),
                         int(num_patches_per_device), int(inner_iterations),
                         int(batch_size_per_device), int(patch_size),
                         int(sub_iter), dict_from, axis,
                         resolve_backend(backend), coder,
                         use_stopping)
    sd = jnp.asarray(stopping_diff if use_stopping else 0.0, img.dtype)
    return train(state, img, jnp.asarray(alpha, img.dtype),
                 jnp.asarray(beta, img.dtype), sd)


@functools.lru_cache(maxsize=64)
def _dp_ising_fn(mesh, ising_iterations, nsteps, num_patches,
                 inner_iterations, batch_size, patch_size, sampler,
                 update_lattice, sub_iter, use_stopping, backend,
                 subsample, coder, axis):
    from onmf_ontf_ndl_tpu.apps.ising import ising_trajectory_learning

    def local(st, lattices, key, J, H_field, T, alpha, beta, sd):
        st, dict_stack, errors, lat, _ = ising_trajectory_learning(
            st, lattices[0], key,
            ising_iterations=ising_iterations, nsteps=nsteps,
            num_patches=num_patches, inner_iterations=inner_iterations,
            batch_size=batch_size, patch_size=patch_size,
            J=J, H_field=H_field, T=T, alpha=alpha, beta=beta,
            sub_iter=sub_iter, stopping_diff=sd, sampler=sampler,
            update_lattice=update_lattice, keep_trajectory=False,
            use_stopping=use_stopping, backend=backend,
            subsample=subsample, coder=coder, psum_axis=axis,
        )
        return st, dict_stack, errors, lat[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis, None, None), P(), P(), P(), P(), P(), P(),
                  P()),
        out_specs=(P(), P(), P(), P(axis, None, None)),
        check_vma=False,
    ))


def dp_ising_learning(
    mesh: Mesh,
    state: OnmfState,
    lattices: jax.Array,
    key: jax.Array,
    *,
    ising_iterations: int,
    nsteps: int,
    num_patches_per_device: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    J: float = 1.0,
    H_field: float = 0.0,
    T: float = 0.5,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    sampler: str = "checkerboard",
    update_lattice: bool = True,
    use_stopping: bool = True,
    subsample: bool = False,
    coder: str = "bcd",
    axis: str = "dp",
    backend: str = "auto",
):
    """Data-parallel Ising trajectory learning: an ENSEMBLE of lattices,
    one per device, each advanced by its own MCMC chain (key streams
    decorrelated by device index), with the full aggregate statistics —
    including ``C = agg X X^T`` for the surrogate error — psum'd every
    inner step. Each dictionary update therefore sees the cross-device
    ``num_patches_per_device * ndev`` patch sample: the multi-chip form
    of :func:`onmf_ontf_ndl_tpu.apps.ising.ising_trajectory_learning`
    (reference loop ``/root/reference/ising_reconstruction.py:99-179``,
    which runs ONE lattice; the ensemble is the data-parallel scale-out of
    the trajectory, like the NDL chain ensembles).

    ``lattices``: (ndev, L, L) int8 spin configurations, sharded over
    ``axis`` (one lattice per device). Returns
    ``(state, dict_stack, errors, lattices)`` with state/dict_stack/
    errors replicated (identical on every device — the surrogate error
    is computed from the psum'd aggregates) and ``lattices`` the final
    sharded ensemble.
    """
    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    ndev = mesh.shape[axis]
    if lattices.ndim != 3 or lattices.shape[0] != ndev:
        raise ValueError(
            f"dp_ising_learning: lattices must be (ndev={ndev}, L, L), "
            f"got {lattices.shape}")
    if state.C is None:
        # the surrogate error needs the C = agg X X^T statistic; catch
        # the default init_state(track_xxt=False) here instead of a
        # jnp.trace(None) TypeError deep inside the shard_map trace
        raise ValueError(
            "dp_ising_learning needs state.C (the X X^T aggregate) for "
            "the surrogate error — build the state with "
            "init_state(..., track_xxt=True)")
    run = _dp_ising_fn(
        mesh, int(ising_iterations), int(nsteps),
        int(num_patches_per_device), int(inner_iterations),
        int(batch_size), int(patch_size), sampler, bool(update_lattice),
        int(sub_iter), bool(use_stopping),
        resolve_backend(backend), bool(subsample),
        coder, axis)
    dt = state.W.dtype
    lattices = jax.device_put(
        lattices, NamedSharding(mesh, P(axis, None, None)))
    return run(state, lattices, key,
               jnp.asarray(J, dt), jnp.asarray(H_field, dt),
               jnp.asarray(T, dt), jnp.asarray(alpha, dt),
               jnp.asarray(beta, dt), jnp.asarray(stopping_diff, dt))


def dp_train_tensor_dict(
    mesh: Mesh,
    state: OnmfState,
    X,
    *,
    mode: int,
    learn_joint_dict: bool = False,
    iterations: int,
    batch_size_per_device: int,
    alpha: float = 2.0,
    beta: float = 1.0,
    sub_iterations: int = 10,
    coder: str = "exact",
    coder_sub_iter: int | None = None,
    stopping_diff: float | None = 0.01,
    axis: str = "dp",
    backend: str = "auto",
):
    """Data-parallel ONTF: mode-unfold the patch tensor (the whole ONTF
    trick, ``/root/reference/src/ontf.py:203-208``), shard the unfolded
    sample columns over the mesh, and run the shared DP scan with psum'd
    aggregates — the multi-chip form of
    :meth:`onmf_ontf_ndl_tpu.models.ontf.OnlineNTF.train_dict_single`.

    Defaults mirror the ONTF surface (PARITY.md deviation #11):
    ``alpha=2`` (the sklearn SparseCoder default the reference tensor
    coder uses) and ``coder="exact"`` (converged accelerated PGD, sweep
    floor 100). The unfolded sample count must divide evenly over the
    mesh axis. Returns the final replicated state.
    """
    from onmf_ontf_ndl_tpu.models.ontf import resolve_tensor_coder
    from onmf_ontf_ndl_tpu.ops.unfold import unfold

    Xu = unfold(jnp.asarray(X, state.W.dtype), mode)
    if learn_joint_dict:
        Xu = Xu.T
    if Xu.shape[0] != state.W.shape[0]:
        raise ValueError(
            f"dp_train_tensor_dict: unfolded feature dim {Xu.shape[0]} "
            f"!= state dim {state.W.shape[0]} (mode={mode}, "
            f"joint={learn_joint_dict})")
    method, sub_iter = resolve_tensor_coder(coder, sub_iterations,
                                            coder_sub_iter)
    return dp_train_dict(
        mesh, state, Xu, iterations=iterations,
        batch_size_per_device=batch_size_per_device, alpha=alpha,
        beta=beta, sub_iter=sub_iter, stopping_diff=stopping_diff,
        coder=method, axis=axis, backend=backend)


@functools.lru_cache(maxsize=64)
def _dp_ndl_fn(mesh, B_bytes, parents, mcmc_iterations, sample_size_pd,
               inner_iterations, batch_size, use_glauber, weighted,
               sub_iter, use_stopping, chains_pd, subsample, discard_first,
               coder, axis, backend):
    from onmf_ontf_ndl_tpu.apps.network import ndl_train

    def local(st, g, emb0, alpha, beta, sd):
        if chains_pd == 1:
            emb0 = emb0[0]          # local (1, k) -> (k,) single chain
        st, code, emb = ndl_train(
            st, g, emb0, B_bytes, parents,
            mcmc_iterations=mcmc_iterations, sample_size=sample_size_pd,
            inner_iterations=inner_iterations, batch_size=batch_size,
            alpha=alpha, beta=beta, sub_iter=sub_iter,
            stopping_diff=sd, use_glauber=use_glauber, weighted=weighted,
            use_stopping=use_stopping, backend=backend,
            num_chains=chains_pd, subsample=subsample,
            discard_first=discard_first,
            coder=coder, psum_axis=axis,
        )
        if chains_pd == 1:
            emb = emb[None]         # (k,) -> (1, k) for the sharded out
        return st, code, emb

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(), P(), P()),
        out_specs=(P(), P(None, axis), P(axis, None)),
        check_vma=False,
    ))


def dp_ndl_train(
    mesh: Mesh,
    state: OnmfState,
    g,
    emb0: jax.Array,
    B_bytes: bytes,
    parents: tuple[int, ...],
    *,
    mcmc_iterations: int,
    sample_size_per_device: int,
    inner_iterations: int,
    batch_size: int,
    num_chains_per_device: int = 1,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    use_glauber: bool = True,
    weighted: bool = False,
    use_stopping: bool = True,
    subsample: bool = False,
    discard_first: bool = True,
    coder: str = "bcd",
    axis: str = "dp",
    backend: str = "auto",
):
    """Data-parallel network dictionary learning: every device runs its
    own MCMC chain ensemble (``num_chains_per_device`` chains sampling
    ``sample_size_per_device`` patches per round; key streams
    decorrelated by device index) and the sufficient statistics are
    psum'd — each dictionary update sees the full
    ``sample_size_per_device * ndev`` cross-device sample, the exact DP
    semantics of ``dp_train_dict`` applied to the NDL pipeline.

    ``batch_size`` only takes effect with ``subsample=True`` (the
    default trains every inner step on the full per-device sample, like
    the single-device NDL default).

    ``emb0``: (ndev * num_chains_per_device, k), sharded over the chain
    axis. The graph ``g`` is replicated. Returns ``(state, code, emb)``
    with ``code`` (r, sample_size_per_device * ndev) column-sharded and
    ``emb`` the final chain embeddings, same sharding as ``emb0``.
    """
    from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

    sd = jnp.asarray(stopping_diff, state.W.dtype)
    train = _dp_ndl_fn(
        mesh, B_bytes, parents, int(mcmc_iterations),
        int(sample_size_per_device), int(inner_iterations),
        int(batch_size), bool(use_glauber), bool(weighted), int(sub_iter),
        bool(use_stopping), int(num_chains_per_device), bool(subsample),
        bool(discard_first), coder, axis,
        resolve_backend(backend))
    return train(state, g, emb0,
                 jnp.asarray(alpha, state.W.dtype),
                 jnp.asarray(beta, state.W.dtype), sd)


@functools.lru_cache(maxsize=64)
def _dp_recon_fn(mesh, B_bytes, parents, recons_iter_pd, sub_iter,
                 use_glauber, weighted, chains_pd, method, axis,
                 include_self=True):
    from onmf_ontf_ndl_tpu.apps.network import (_group_painted,
                                                _recon_sample_vals)

    def local(W, g, key, alpha):
        key = jax.random.fold_in(key, lax.axis_index(axis))
        embs, vals_T = _recon_sample_vals(
            W, g, key, B_bytes, parents, recons_iter_pd, alpha, sub_iter,
            use_glauber, weighted, chains_pd, method)
        ii, jj, sums, cnt = _group_painted(embs, vals_T, g.num_nodes,
                                           include_self=include_self)
        n_seg = jnp.sum(cnt > 0).astype(jnp.int32)[None]
        return ii, jj, sums, cnt, n_seg

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    ))


def dp_reconstruct_network_sparse(
    mesh: Mesh,
    W: jax.Array,
    g,
    key: jax.Array,
    B_bytes: bytes,
    parents: tuple[int, ...],
    *,
    recons_iter_per_device: int,
    num_chains_per_device: int = 1,
    alpha: float = 0.0,
    sub_iter: int = 30,
    use_glauber: bool = False,
    weighted: bool = False,
    method: str = "bcd",
    axis: str = "dp",
    include_self: bool = True,
):
    """Chain-sharded sparse network reconstruction over a device mesh.

    Every device runs its own ``num_chains_per_device``-chain MCMC
    ensemble (key streams decorrelated by device index), codes and
    paints its ``recons_iter_per_device`` samples locally, and groups
    them into per-pair (sum, count) segments — the multi-chip version
    of :func:`onmf_ontf_ndl_tpu.apps.network.reconstruct_network_sparse`.
    Because the reference's per-edge running average
    (``network_reconstruction_nx.py:453-491``) equals the per-edge mean
    over ALL painted samples, merging shards is exact: the global mean
    of a pair is the ratio of summed shard sums to summed shard counts
    (see :func:`merge_recon_shards`) — no approximation is introduced by
    the sharding, only the sample budget is partitioned.

    This shards the reconstruction's device-memory footprint (code
    iterate, painted values, sort keys — the binding constraint at the
    262,144-node single-chip scale, docs/DESIGN.md §6) along with the
    wall-clock: per-device cost is that of a ``1/ndev`` sample budget.

    Returns ``(ii, jj, sums, cnt, n_seg)`` — the first four
    device-sharded over ``axis`` (each device's block holds its real
    segments as a prefix), ``n_seg`` the (ndev,) per-device real-segment
    counts. Feed to :func:`merge_recon_shards` /
    :func:`dp_recons_edges` for the global result.
    """
    run = _dp_recon_fn(mesh, B_bytes, parents, int(recons_iter_per_device),
                       int(sub_iter), bool(use_glauber), bool(weighted),
                       int(num_chains_per_device), method, axis,
                       bool(include_self))
    return run(W, g, key, jnp.asarray(alpha, W.dtype))


def merge_recon_shards(ii, jj, sums, cnt, n_seg, n: int):
    """Host-side exact merge of per-device grouped painted-pair shards.

    Copies only each shard's real-segment PREFIX to the host
    (real segments are contiguous from slot 0 because segment ids are a
    cumsum), concatenates, regroups by (i, j), and returns
    ``(pi, pj, mean, count)`` over the distinct global pairs with
    ``mean = sum(shard sums) / sum(shard counts)`` — exactly the
    reference's per-edge running average over the union of all devices'
    samples (``network_reconstruction_nx.py:453-491``)."""
    counts = np.asarray(n_seg).ravel()
    ndev = counts.shape[0]
    per = ii.shape[0] // ndev

    def prefixes(arr):
        shards = {int(s.index[0].start or 0): s for s in
                  arr.addressable_shards}
        out = []
        for d in range(ndev):
            lo, c = d * per, int(counts[d])
            # slice BEFORE np.asarray: only the real-segment prefix may
            # be copied to the host, never the padded block
            block = shards[lo].data[:c] if lo in shards \
                else arr[lo:lo + c]
            out.append(np.asarray(block))
        return np.concatenate(out)

    pi = prefixes(ii).astype(np.int64)
    pj = prefixes(jj).astype(np.int64)
    ps = prefixes(sums).astype(np.float64)
    pc = prefixes(cnt).astype(np.float64)
    key = pi * n + pj
    uk, inv = np.unique(key, return_inverse=True)
    gs = np.zeros(uk.shape[0])
    gc = np.zeros(uk.shape[0])
    np.add.at(gs, inv, ps)
    np.add.at(gc, inv, pc)
    return uk // n, uk % n, gs / np.maximum(gc, 1.0), gc


def dp_recons_edges(mesh, W, g, key, B_bytes, parents, **kwargs):
    """Convenience wrapper: DP sparse reconstruction -> host merge ->
    undirected simple-graph edge array (pairs whose rounded global mean
    is positive, self-loops dropped), matching
    ``NetworkReconstructor.recons_edges`` semantics."""
    from onmf_ontf_ndl_tpu.apps.network import _undirected_simple_edges

    # self-pairs only ever produce self-loops, which the simple-graph
    # edges drop — skip a third of each shard's grouping sort
    kwargs.setdefault("include_self", False)
    ii, jj, sums, cnt, n_seg = dp_reconstruct_network_sparse(
        mesh, W, g, key, B_bytes, parents, **kwargs)
    pi, pj, mean, _ = merge_recon_shards(ii, jj, sums, cnt, n_seg,
                                         g.num_nodes)
    keep = np.round(mean) > 0
    return _undirected_simple_edges(pi[keep], pj[keep])
