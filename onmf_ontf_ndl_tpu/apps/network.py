"""Network dictionary learning (NDL) and network reconstruction.

A compiled re-design of ``Network_Reconstructor``
(``/root/reference/network_reconstruction_nx.py:19-533``): the MCMC motif
chain, patch extraction, and warm-started online NMF all run inside one
jitted ``lax.scan``; reconstruction batches the whole chain's patches
through one coder call and scatter-adds overlap-averaged edge weights
into a dense reconstruction matrix.

Parity notes:
- training follows ``train_dict`` (``:342-391``): per MCMC iteration,
  ``sample_size`` Glauber (or Pivot) moves each emitting one k x k patch,
  then ``sub_iterations`` online-NMF steps on random ``batch_size``
  column subsamples, with state threading across iterations;
- reconstruction follows ``reconstruct_network`` (``:444-511``): a fresh
  chain emits patches; each patch is sparse-coded against W with
  ``alpha=0`` and its W@code values are painted onto the edges of the
  embedding with a running average, finally rounded to a simple graph.
  The per-edge running average equals the per-edge mean, so the batched
  scatter-add form is semantically identical. The reference codes each
  patch separately with sklearn lasso_lars; we batch-code all patches
  with the PGD coder (same objective; reconstruction-level parity);
- accuracy metric: ``|E(G_recons & G)| / |E(G)|`` (``:513-524``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.data.graphs import (
    BitsetGraph, CsrGraph, Graph, graph_from_adjacency, load_edgelist)
from onmf_ontf_ndl_tpu.models.onmf import _train_scan
from onmf_ontf_ndl_tpu.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu.ops.coder import nonneg_code
from onmf_ontf_ndl_tpu.samplers.motif import (
    pair_matrices_T,
    _pair_membership,
    _sample_patches,
    _sample_patches_ensemble_impl,
    glauber_update,
    path_adj,
    pivot_update,
    tree_parents,
    tree_sample,
)

__all__ = ["NetworkReconstructor", "ndl_train", "reconstruct_network",
           "reconstruct_network_sparse",
           "reconstruct_network_sparse_chunked"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "B_bytes", "parents", "mcmc_iterations", "sample_size",
        "inner_iterations", "batch_size", "use_glauber", "weighted",
        "sub_iter", "use_stopping", "backend", "num_chains", "subsample",
        "discard_first", "coder", "psum_axis",
    ),
)
def ndl_train(
    state: OnmfState,
    g: Graph,
    emb0: jax.Array,
    B_bytes: bytes,
    parents: tuple[int, ...],
    *,
    mcmc_iterations: int,
    sample_size: int,
    inner_iterations: int,
    batch_size: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    use_glauber: bool = True,
    weighted: bool = False,
    use_stopping: bool = True,
    backend: str = "xla",
    num_chains: int = 1,
    subsample: bool = False,
    discard_first: bool = True,
    coder: str = "bcd",
    psum_axis: str | None = None,
):
    """Fused NDL trainer. Returns ``(state, code, emb)`` where code is the
    accumulated (r, sample_size) code matrix.

    ``discard_first=True`` drops the code contribution of the first MCMC
    iteration, matching the reference's per-call behavior (code += H only
    for t > 0, ``network_reconstruction_nx.py:360-377``); a chunked
    continuation of an interrupted run passes ``False`` so the discard
    happens exactly once per logical training run.

    ``num_chains > 1`` samples each MCMC iteration's patch matrix from an
    ensemble of independent chains (``sample_size / num_chains`` moves
    per chain) instead of one chain — the accelerator's lever against
    the sequential chain depth (the reference runs one chain,
    ``network_reconstruction_nx.py:315-329``). ``emb0`` must then be
    (num_chains, k).

    ``psum_axis``: set when running inside ``shard_map`` with the chain
    ensemble sharded over that mesh axis (``parallel.dp.dp_ndl_train``):
    per-device chain key streams are decorrelated by device index and
    the sufficient statistics are psum'd, so every device's dictionary
    update sees the full cross-device sample."""
    dtype = state.W.dtype
    alpha_t = jnp.asarray(alpha, dtype)
    beta_t = jnp.asarray(beta, dtype)
    sd_t = jnp.asarray(stopping_diff, dtype)
    if num_chains > 1:
        per = -(-sample_size // num_chains)
        sample_size = per * num_chains
    code = jnp.zeros((state.r, sample_size), dtype)

    def sample(ck, emb):
        if num_chains <= 1:
            return _sample_patches(ck, g, emb, B_bytes, parents,
                                   sample_size, use_glauber, weighted)
        return _sample_patches_ensemble_impl(
            ck, g, emb, B_bytes, parents, per, use_glauber, weighted)

    def body(carry, i):
        st, emb, code = carry
        key, ck, = jax.random.split(st.key)
        st = dataclasses.replace(st, key=key)
        if psum_axis is not None:
            ck = jax.random.fold_in(ck, lax.axis_index(psum_axis))
        X, emb = sample(ck, emb)
        st, code_new, _ = _train_scan(
            st, X.astype(dtype), code, alpha_t, beta_t, sd_t,
            inner_iterations, batch_size, subsample, sub_iter,
            use_stopping, True, "stale", backend=backend, coder=coder,
            psum_axis=psum_axis,
        )
        if discard_first:
            code = jnp.where(i == 0, code, code_new)
        else:
            code = code_new
        return (st, emb, code), None

    (state, emb, code), _ = lax.scan(
        body, (state, emb0, code), jnp.arange(mcmc_iterations))
    return state, code, emb


@functools.partial(
    jax.jit,
    static_argnames=("B_bytes", "parents", "recons_iter", "use_glauber",
                     "weighted", "sub_iter", "num_chains", "method"),
)
def reconstruct_network(
    W: jax.Array,
    g: Graph,
    key: jax.Array,
    B_bytes: bytes,
    parents: tuple[int, ...],
    *,
    recons_iter: int,
    alpha: float = 0.0,
    sub_iter: int = 30,
    use_glauber: bool = False,
    weighted: bool = False,
    num_chains: int = 1,
    method: str = "bcd",
):
    """Chain-sample ``recons_iter`` patches, code them all at once, and
    overlap-average onto the node-pair grid. Returns
    ``(recon_weights, overlap_count)`` — dense (N, N) arrays; the
    rounded simple graph is ``(recon_weights.round() > 0) & (count > 0)``.

    Every chain starts fresh from a uniform random pivot, exactly as the
    reference does (``network_reconstruction_nx.py:458-463``).
    ``num_chains > 1`` runs an ensemble of independent chains
    contributing ``recons_iter / num_chains`` patches each — chains are
    sequential by definition, so the ensemble is the way to cut the
    wall-clock of a long reconstruction chain (the reference runs one
    chain for up to 1e5 steps, ``network_reconstruction_nx.py:601``).
    """
    embs, vals_T = _recon_sample_vals(
        W, g, key, B_bytes, parents, recons_iter, alpha, sub_iter,
        use_glauber, weighted, num_chains, method)
    recons_iter, k = embs.shape

    n = g.num_nodes
    eT = embs.T                                       # (k, M)
    rows = jnp.broadcast_to(eT[:, None, :], (k, k, recons_iter))
    cols = jnp.broadcast_to(eT[None, :, :], (k, k, recons_iter))
    vals = vals_T.reshape(k, k, recons_iter)
    acc = jnp.zeros((n, n), W.dtype).at[rows, cols].add(vals)
    cnt = jnp.zeros((n, n), W.dtype).at[rows, cols].add(1.0)
    recon = acc / jnp.maximum(cnt, 1.0)
    return recon, cnt


def _recon_sample_vals(W, g, key, B_bytes, parents, recons_iter, alpha,
                       sub_iter, use_glauber, weighted, num_chains,
                       method="bcd"):
    """Shared reconstruction front half: chain-sample ``recons_iter``
    embeddings, batch-code their patches, return the painted values.

    Returns ``(embs (M, k) int32, vals_T (k*k, M))`` with
    ``M = recons_iter`` rounded up to a multiple of ``num_chains``;
    ``vals_T[q*k + r, m]`` is the painted value of pair ``(q, r)`` in
    sample ``m``. The sample axis stays MINOR end to end (patch gather,
    coding, W @ H): a per-sample (k, k) layout pads every intermediate
    to full tile extents, a many-fold expansion of device memory (see
    ``samplers/motif.py::pair_matrices_T``).
    """
    k = len(parents) + 1
    ck, hk = jax.random.split(key)
    B = np.frombuffer(B_bytes, dtype=np.int8).reshape(k, -1)

    def step(emb, kk):
        if use_glauber:
            emb = glauber_update(kk, B, parents, g, emb)
        else:
            emb = pivot_update(kk, B, parents, g, emb)
        return emb, emb

    chains = max(1, num_chains)
    per = -(-recons_iter // chains)
    recons_iter = per * chains
    ck, pk, tk = jax.random.split(ck, 3)
    pivots = jax.random.randint(pk, (chains,), 0, g.num_nodes)
    emb0s = jax.vmap(lambda kk, x: tree_sample(kk, parents, g, x))(
        jax.random.split(tk, chains), pivots)

    def run_chain(kk, e0):
        return lax.scan(step, e0, jax.random.split(kk, per))

    _, embs = jax.vmap(run_chain)(
        jax.random.split(ck, chains), emb0s)          # (C, per, k)
    embs = embs.reshape(chains * per, k)

    if weighted and getattr(g, "weight", None) is None:
        raise ValueError("weighted reconstruction needs a weighted Graph")
    X = pair_matrices_T(g, embs, weighted=weighted).astype(W.dtype)

    # fixed sweeps (no spectral-norm stopping): one kernel launch on a
    # GPU, and no eigensolve per sweep at recon widths
    H = nonneg_code(X, W, key=hk, alpha=alpha, sub_iter=sub_iter,
                    stopping_diff=None, method=method)
    return embs, W @ H


@functools.partial(
    jax.jit,
    static_argnames=("B_bytes", "parents", "recons_iter", "use_glauber",
                     "weighted", "sub_iter", "num_chains", "method",
                     "include_self"),
)
def reconstruct_network_sparse(
    W: jax.Array,
    g: Graph,
    key: jax.Array,
    B_bytes: bytes,
    parents: tuple[int, ...],
    *,
    recons_iter: int,
    alpha: float = 0.0,
    sub_iter: int = 30,
    use_glauber: bool = False,
    weighted: bool = False,
    num_chains: int = 1,
    method: str = "bcd",
    include_self: bool = True,
):
    """Memory-scalable reconstruction: per-edge segment means instead of
    dense (N, N) canvases.

    The reference paints sparsely into a DiGraph with a per-edge running
    average (``network_reconstruction_nx.py:453-491``); the running
    average equals the per-edge mean, so grouping the ``recons_iter*k^2``
    painted values by their (i, j) node pair and averaging is
    semantically identical — and touches O(samples) memory instead of
    O(N^2), which is what lets the 18k-node arxiv graph (and anything the
    BitsetGraph representation holds) reconstruct on one chip without
    multi-GB canvases or a dense result copied back to the host.

    Grouping is a lexicographic sort of the (i, j) keys plus segment
    sums — no dynamic shapes (the unique count stays implicit; unused
    slots have count 0).

    Returns ``(ii, jj, mean, cnt)``, each of length ``recons_iter*k^2``
    (``recons_iter*k*(k-1)`` with ``include_self=False``, which drops
    the self-pair slots that the simple-graph rounding discards anyway —
    see :func:`_group_painted`): for slots with ``cnt > 0``, the mean
    painted value of directed pair ``(ii, jj)``; slots with ``cnt == 0``
    are padding. The rounded simple graph consists of pairs with
    ``round(mean) > 0``.
    """
    embs, vals_T = _recon_sample_vals(
        W, g, key, B_bytes, parents, recons_iter, alpha, sub_iter,
        use_glauber, weighted, num_chains, method)
    out_i, out_j, sums, cnt = _group_painted(embs, vals_T, g.num_nodes,
                                             include_self=include_self)
    mean = sums / jnp.maximum(cnt, 1.0)
    return out_i, out_j, mean, cnt


@functools.partial(
    jax.jit,
    static_argnames=("B_bytes", "parents", "recons_iter", "use_glauber",
                     "weighted", "sub_iter", "num_chains", "method"),
)
def _grouped_chunk_sums(W, g, key, B_bytes, parents, *, recons_iter,
                        alpha, sub_iter, use_glauber, weighted,
                        num_chains, method):
    """One chunk of the chunked reconstruction: sample, code, paint and
    group ``recons_iter`` patches, returning (ii, jj, SUMS, cnt) —
    sums + counts, not means, so chunks fold exactly downstream."""
    embs, vals_T = _recon_sample_vals(
        W, g, key, B_bytes, parents, recons_iter, alpha, sub_iter,
        use_glauber, weighted, num_chains, method)
    return _group_painted(embs, vals_T, g.num_nodes, include_self=False)


def _bitonic_merge(si, sj, sv, sc):
    """Ascending two-key merge of a BITONIC (si, sj) key sequence of
    power-of-two length, payloads carried along: log2(n) compare-
    exchange stages instead of a full sort's log^2(n) — both fold
    inputs are already sorted (grouped output is sorted by
    construction), so a merge network is all the fold needs.

    Stages run as (blocks, 2, d) reshapes only while ``d >= 128`` —
    the compare distance stays a lane-multiple so every view is
    tile-dense (a stage at small d materializes (…, 2, d)-shaped
    operands whose d-minor pads to full 128-wide tiles, many times the
    array's own size). After the d=128 stage the
    array is a sequence of independent 128-long bitonic blocks, which
    one row-wise ``lax.sort`` over a (n/128, 128) view finishes at
    full lane utilization."""
    n = si.shape[0]
    assert n & (n - 1) == 0, "bitonic merge needs a power-of-two length"
    if n <= 256:
        return lax.sort((si, sj, sv, sc), num_keys=2)
    d = n // 2
    while d >= 128:
        blocks = n // (2 * d)

        def halves(x):
            x = x.reshape(blocks, 2, d)
            return x[:, 0], x[:, 1]

        li, hi_ = halves(si)
        lj, hj = halves(sj)
        lv, hv = halves(sv)
        lc, hc = halves(sc)
        swap = (li > hi_) | ((li == hi_) & (lj > hj))

        def ex(lo, hi__):
            return (jnp.where(swap, hi__, lo), jnp.where(swap, lo, hi__))

        (li, hi_), (lj, hj) = ex(li, hi_), ex(lj, hj)
        (lv, hv), (lc, hc) = ex(lv, hv), ex(lc, hc)

        def join(lo, hi__):
            return jnp.stack([lo, hi__], axis=1).reshape(n)

        si, sj = join(li, hi_), join(lj, hj)
        sv, sc = join(lv, hv), join(lc, hc)
        d //= 2
    rows = n // 128
    si, sj, sv, sc = lax.sort(
        tuple(x.reshape(rows, 128) for x in (si, sj, sv, sc)),
        dimension=1, num_keys=2)
    return (si.reshape(n), sj.reshape(n), sv.reshape(n), sc.reshape(n))


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3),
                   static_argnames=("out_len",))
def _fold_grouped(ai, aj, asum, acnt, ci, cj, csum, ccnt, *, out_len=None):
    """Fold a chunk's grouped (sum, count) segments into the
    accumulator — the on-device analogue of
    ``parallel.dp.merge_recon_shards`` (exact: the global mean of a
    pair is summed sums over summed counts).

    Both inputs are SORTED by (i, j) with padding at the tail (grouped
    output is sorted by construction), so the combined sequence
    [accumulator asc | pad | chunk REVERSED] is bitonic and one
    log2(n)-stage merge network replaces a full log^2(n) sort —
    padding slots (cnt == 0) ride as int32-max keys. When the
    power-of-two padding would exceed 25% of the real total, an
    exact-width two-key ``lax.sort`` replaces the merge network — the
    padded merge peaks at 2x the memory, more than one device holds at
    a heavy-tail fold's ~2^28 distinct pairs. Returns the
    merged arrays, real segments in a prefix, truncated to ``out_len``
    slots (default: the accumulator's length; the returned width is
    ``min(out_len, merged width)`` — callers re-derive the accumulator
    length from the arrays) — the returned real-segment count is
    computed BEFORE truncation, so the caller can detect overflow
    exactly."""
    cap = ai.shape[0]
    if out_len is None:
        out_len = cap
    L = ci.shape[0]
    big = jnp.int32(2**31 - 1)
    total = cap + L
    T = 1 << (total - 1).bit_length()

    def keyed(i_, j_, c_):
        v = c_ > 0
        return jnp.where(v, i_, big), jnp.where(v, j_, big)

    ai_k, aj_k = keyed(ai, aj, acnt)
    ci_k, cj_k = keyed(ci, cj, ccnt)
    if T > total + (total >> 2):
        # Exact-width full sort instead of the padded merge network:
        # the bitonic merge needs a power-of-two length, and when the
        # accumulator bucket sits just above one (e.g. a 2^28-slot
        # accumulator + a small chunk) the padding nearly DOUBLES the
        # merge's peak device memory (in+out at 2^29 slots x 16 B ≈
        # 17 GB, on a heavy-tail fold where distinct painted pairs reach
        # ~2^28). A two-key 4-operand lax.sort at the exact width costs
        # a full sort against the merge's one pass, but peaks at half the
        # memory; it only runs when padding waste exceeds 25%.
        si = jnp.concatenate([ai_k, ci_k])
        sj = jnp.concatenate([aj_k, cj_k])
        sv = jnp.concatenate([asum, csum])
        sc = jnp.concatenate([acnt, ccnt])
        si, sj, sv, sc = lax.sort((si, sj, sv, sc), num_keys=2)
    else:
        padn = T - total

        def cat(a, pad_val, c):
            mid = jnp.full((padn,), pad_val, a.dtype)
            return jnp.concatenate([a, mid, c[::-1]])

        si = cat(ai_k, big, ci_k)
        sj = cat(aj_k, big, cj_k)
        sv = cat(asum, jnp.zeros((), asum.dtype), csum)
        sc = cat(acnt, jnp.zeros((), acnt.dtype), ccnt)
        si, sj, sv, sc = _bitonic_merge(si, sj, sv, sc)
    # Both inputs have UNIQUE keys, so after the merge every real key
    # occupies <= 2 adjacent slots: the whole segment reduction is one
    # shift-add (the first slot of a duplicate pair absorbs the second)
    # — no segment_sum/segment_max scatter at this width. Padding runs (equal
    # int32-max keys) are longer but carry zeros, so pairwise
    # absorption loses nothing. Killed slots become int32-max-keyed
    # zeros and ONE two-key payload sort (0.8 s — cheaper than a single
    # segment op) restores the sorted-reals-prefix invariant.
    same = (si[1:] == si[:-1]) & (sj[1:] == sj[:-1])
    zero = jnp.zeros((1,), sv.dtype)
    sums = sv + jnp.concatenate([jnp.where(same, sv[1:], 0), zero])
    cnt = sc + jnp.concatenate([jnp.where(same, sc[1:], 0), zero])
    killed = jnp.concatenate([jnp.zeros((1,), bool), same])
    si = jnp.where(killed, big, si)
    sj = jnp.where(killed, big, sj)
    sums = jnp.where(killed, 0, sums)
    cnt = jnp.where(killed, 0, cnt)
    out_i, out_j, sums, cnt = lax.sort((si, sj, sums, cnt), num_keys=2)
    n_real = jnp.sum(cnt > 0)
    return (out_i[:out_len], out_j[:out_len], sums[:out_len],
            cnt[:out_len], n_real.astype(jnp.int32))


@jax.jit
def _split_positions(i_, j_, c_, ti, tj):
    """Number of REAL (``cnt > 0``) sorted (i, j) keys strictly below
    each boundary key ``(ti[p], tj[p])`` — the per-part split indices
    of a grouped array whose real segments occupy a sorted prefix.
    Padding is excluded by the ``cnt`` gate rather than by key value:
    the fused grouping path (n <= 65536) pads with (0, 0) keys, which
    would otherwise count below every boundary (the two-key path pads
    with int32-max). A packed 64-bit key + ``searchsorted`` would be
    the obvious form, but the package runs with x64 disabled; the two-key
    prefix predicate reduces in one bandwidth-bound pass instead."""
    lt = ((i_[None, :] < ti[:, None])
          | ((i_[None, :] == ti[:, None]) & (j_[None, :] < tj[:, None])))
    return jnp.sum(lt & (c_ > 0)[None, :], axis=1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("size",))
def _part_slice(i_, j_, v_, c_, start, count, *, size):
    """Copy ``size`` slots starting at dynamic ``start`` out of grouped
    (i, j, sum, cnt) arrays, masking offsets ``>= count`` to padding
    (int32-max keys / zero payloads). ``jnp.roll`` handles the dynamic
    start without the silent start-clamping hazard of ``dynamic_slice``
    at the array tail; the full-width rotate is bandwidth-only. Static
    ``size`` keeps the jit-shape count logarithmic (callers pass
    power-of-two buckets)."""
    m = jnp.arange(size, dtype=jnp.int32) < count
    big = jnp.int32(2**31 - 1)

    def take(a, fill):
        return jnp.where(m, jnp.roll(a, -start)[:size], fill)

    return (take(i_, big), take(j_, big),
            take(v_, jnp.zeros((), v_.dtype)),
            take(c_, jnp.zeros((), c_.dtype)))


def _bucket(count: int, lo: int = 1 << 10) -> int:
    """Smallest power-of-two ``>= max(count, 1)``, floored at ``lo`` —
    the accumulator/chunk size-bucket rule (bounds the number of
    distinct fold shapes, hence jit compiles, logarithmically)."""
    return max(lo, 1 << (max(count, 1) - 1).bit_length())


def reconstruct_network_sparse_chunked(
    W: jax.Array,
    g,
    key: jax.Array,
    B_bytes: bytes,
    parents: tuple[int, ...],
    *,
    recons_iter: int,
    chunks: int,
    cap: int | None = None,
    alpha: float = 0.0,
    sub_iter: int = 30,
    use_glauber: bool = False,
    weighted: bool = False,
    num_chains: int = 1,
    method: str = "bcd",
    fold_parts: int | None = None,
):
    """Sample budgets beyond one device's memory: run the sparse
    reconstruction pipeline in ``chunks`` independent pieces and fold
    each piece's grouped per-pair (sum, count) segments into a
    fixed-capacity on-device accumulator between pieces.

    The per-piece working set (code iterate, painted values, sort keys
    — the memory bound of large reconstructions, docs/DESIGN.md §6) is
    that of a ``recons_iter / chunks`` budget, while the accumulator
    only holds the DISTINCT painted pairs seen so far (``cap`` slots,
    default twice a piece's paint count). The fold is the single-chip
    analogue of the DP layer's exact shard merge: the reference's
    per-edge running average is the per-edge mean, and a mean folds
    exactly from (sum, count) pieces. Chunk key streams are decorrelated
    by ``fold_in``; every chunk runs fresh chains from fresh uniform
    pivots — exactly ``chunks`` repetitions of the reference's
    fresh-chain reconstruction loop with pooled painting.

    Raises if the distinct-pair count outgrows ``cap`` (raise ``cap``
    or use more/fewer chunks; the check is exact, not a truncation).
    Returns ``(ii, jj, mean, cnt)`` of length ``<= cap`` rounded to
    size buckets; slots with ``cnt == 0`` are padding. On the
    single-accumulator path real segments occupy a sorted prefix; once
    the fold PARTITIONS (below) padding may sit between parts — every
    consumer (:func:`_kept_edge_bits`, :func:`_kept_pairs`,
    :func:`_pack_recon_edges`) masks on ``cnt > 0`` and none requires
    global order. Otherwise the same contract as
    :func:`reconstruct_network_sparse` with ``include_self=False``.

    **Partitioned fold** (``fold_parts``, default from
    ``ONMF_FOLD_PARTS`` env, 8; activation threshold from
    ``ONMF_FOLD_PART_AT`` env, 2**27 accumulator slots): the fold's
    exact-width sort peaks at ~2x the merged width (in + out), which
    at a ~2**28-slot distinct-pair accumulator is the one-device memory
    wall of large heavy-tail budgets. When the accumulator bucket
    reaches the threshold
    mid-run, it is split ONCE into ``fold_parts`` contiguous key
    ranges at its own (i, j) quantiles; each subsequent chunk is
    sliced at the same boundaries (:func:`_split_positions`) and
    folded part-by-part in separate jit calls, so the sort scratch is
    ~2x a PART (1/parts of the width) while the other parts just sit
    in device memory. Identical math: every (i, j) key lands in exactly one
    part, and per-pair (sum, count) folding is key-local. ``fold_parts
    <= 1`` disables."""
    k = len(parents) + 1
    per_chunk = -(-recons_iter // chunks)
    # the pipeline rounds each chunk's budget UP to a multiple of
    # num_chains (every chain contributes whole steps), so size the
    # default overflow bound from the ROUNDED paint count — the nominal
    # one under-sizes it for wide ensembles (review finding)
    m_chunk = -(-per_chunk // max(num_chains, 1)) * max(num_chains, 1)
    if cap is None:
        cap = 2 * m_chunk * k * max(k - 1, 1)
    # The accumulator GROWS by power-of-two buckets from the measured
    # real-segment count instead of allocating ``cap`` slots up front:
    # the fold's merge width is accumulator + chunk reals, and distinct
    # painted pairs are typically far fewer than total paints (hub
    # pairs repeat heavily), so fixed-cap folds paid 2-4x the width for
    # padding. ``cap`` stays the exact overflow bound; bucketing keeps
    # the number of distinct fold shapes (= recompiles) logarithmic.
    if fold_parts is None:
        fold_parts = int(os.environ.get("ONMF_FOLD_PARTS", "8"))
    part_at = int(os.environ.get("ONMF_FOLD_PART_AT", str(1 << 27)))
    progress = os.environ.get("ONMF_CHUNK_PROGRESS")
    A = min(1 << 10, cap)
    acc = (jnp.zeros((A,), jnp.int32), jnp.zeros((A,), jnp.int32),
           jnp.zeros((A,), W.dtype), jnp.zeros((A,), W.dtype))
    pacc = None     # per-part accumulators once the fold partitions
    pA: list[int] = []
    pn: list[int] = []
    bounds_i = bounds_j = None

    def _overflow(n_tot, c):
        raise ValueError(
            f"chunked reconstruction overflowed the {cap}-slot "
            f"accumulator at chunk {c + 1}/{chunks} "
            f"({n_tot} distinct pairs); raise cap")

    for c in range(chunks):
        ck = jax.random.fold_in(key, c)
        chunk = _grouped_chunk_sums(
            W, g, ck, B_bytes, parents, recons_iter=per_chunk,
            alpha=alpha, sub_iter=sub_iter, use_glauber=use_glauber,
            weighted=weighted, num_chains=num_chains, method=method)
        # fold only the chunk's real-segment prefix (grouped output is
        # sorted with real segments contiguous from slot 0): the merge
        # network's cost scales with accumulator + REAL chunk segments,
        # not the chunk's padded paint count. Power-of-two size buckets
        # bound the number of fold recompiles.
        n_seg_c = int(jnp.sum(chunk[3] > 0))
        S = min(chunk[0].shape[0], _bucket(n_seg_c))
        chunk = tuple(x[:S] for x in chunk)
        if pacc is None:
            # merged reals <= A + S, so an out_len covering A + S
            # (capped at the overflow bound) never truncates a real
            # segment unless the run overflows cap — which raises
            # below, exactly
            out_len = min(_bucket(A + S), cap)
            *acc, n_real = _fold_grouped(*acc, *chunk, out_len=out_len)
            n_tot = int(n_real)
            if n_tot > cap:
                _overflow(n_tot, c)
            if progress:
                # distinct-pair growth per fold (n_real is fetched
                # above anyway, so this costs nothing): the
                # accumulator's bucket width — and hence the fold's
                # memory footprint — follows this count, which on heavy-tail
                # graphs grows much faster with samples than on
                # lattices (hub 2-paths)
                print(f"  chunk {c + 1}/{chunks}: {n_tot} distinct "
                      f"pairs (fold width {out_len})",
                      file=sys.stderr, flush=True)
            # shrink back to the real-segment bucket for the next fold;
            # A is re-derived from the RETURNED array length, not
            # out_len — the fold's merge width T can undercut out_len
            # for tiny caps/chunks (the [:out_len] slice clamps), and
            # out_len would then overstate the accumulator
            A = min(acc[0].shape[0], _bucket(n_tot))
            if A < acc[0].shape[0]:
                acc = tuple(x[:A] for x in acc)
            if fold_parts > 1 and A >= part_at and c + 1 < chunks:
                # partition ONCE at the accumulator's own key
                # quantiles: reals occupy a sorted UNIQUE-key prefix,
                # so the split position of the key AT quantile slot q
                # is exactly q — no search needed for the accumulator
                # itself, only boundary-key fetches
                qpos = [n_tot * p // fold_parts
                        for p in range(1, fold_parts)]
                bounds_i = jnp.asarray([int(acc[0][q]) for q in qpos],
                                       jnp.int32)
                bounds_j = jnp.asarray([int(acc[1][q]) for q in qpos],
                                       jnp.int32)
                starts = [0] + qpos
                ends = qpos + [n_tot]
                pacc, pA, pn = [], [], []
                for p in range(fold_parts):
                    cnt_p = ends[p] - starts[p]
                    sz = min(_bucket(cnt_p), A)
                    pacc.append(list(_part_slice(
                        *acc, starts[p], cnt_p, size=sz)))
                    pA.append(sz)
                    pn.append(cnt_p)
                acc = None
                if progress:
                    print(f"  fold partitioned into {fold_parts} key "
                          f"ranges at {n_tot} distinct pairs "
                          f"(buckets {pA})", file=sys.stderr, flush=True)
        else:
            # partitioned fold: slice the chunk at the standing key
            # boundaries and fold each slice into its part in its own
            # jit call — the sort scratch is ~2x a part, not 2x the
            # whole accumulator
            pos = [int(x) for x in np.asarray(_split_positions(
                chunk[0], chunk[1], chunk[3], bounds_i, bounds_j))]
            starts = [0] + pos
            ends = pos + [n_seg_c]
            nouts: list = [None] * fold_parts
            for p in range(fold_parts):
                cnt_p = ends[p] - starts[p]
                if cnt_p <= 0:
                    continue
                sz = min(_bucket(cnt_p), S)
                cpart = _part_slice(*chunk, starts[p], cnt_p, size=sz)
                out_len = min(_bucket(pA[p] + sz), cap)
                out = _fold_grouped(*pacc[p], *cpart, out_len=out_len)
                pacc[p] = list(out[:4])
                nouts[p] = out[4]
            # ONE host round-trip for all per-part real counts (a
            # scalar fetch per part per chunk is a sync each),
            # then shrink each part back to its real-count bucket
            live = [x for x in nouts if x is not None]
            fetched = iter(int(v) for v in np.asarray(jnp.stack(live))) \
                if live else iter(())
            for p in range(fold_parts):
                if nouts[p] is None:
                    continue
                pn[p] = next(fetched)
                Ap = min(pacc[p][0].shape[0], _bucket(pn[p]))
                if Ap < pacc[p][0].shape[0]:
                    pacc[p] = [x[:Ap] for x in pacc[p]]
                pA[p] = Ap
            n_tot = sum(pn)
            if n_tot > cap:
                _overflow(n_tot, c)
            if progress:
                print(f"  chunk {c + 1}/{chunks}: {n_tot} distinct "
                      f"pairs (part buckets {pA})",
                      file=sys.stderr, flush=True)
    if pacc is not None:
        # assemble: slice every part to its EXACT real count first
        # (host-known, reals occupy each part's sorted prefix), freeing
        # the bucketed buffers before the concat — concatenating the
        # bucketed parts directly would peak at ~2x the total
        # accumulator (parts + output), the very OOM the partitioned
        # fold exists to avoid. Exact widths here cost one final
        # compile each; downstream consumers re-bucket on their own.
        for p in range(fold_parts):
            pacc[p] = [x[:pn[p]] for x in pacc[p]]
        acc = tuple(jnp.concatenate([pacc[p][t]
                                     for p in range(fold_parts)])
                    for t in range(4))
        pacc = None
    ii, jj, sums, cnt = acc
    mean = sums / jnp.maximum(cnt, 1.0)
    return ii, jj, mean, cnt


def _group_painted(embs, vals_T, n, include_self=True):
    """Group the painted per-sample pair values by (i, j) node pair.

    ``embs`` (M, k) int32, ``vals_T`` (k*k, M). Returns
    ``(ii, jj, sums, cnt)``, each of length ``M*k*k``: per distinct
    painted pair, the SUM of painted values and the number of paints;
    slots with ``cnt == 0`` are padding (their ``ii``/``jj`` carry
    (0, 0) on the fused-key path — the segment_max identity — and
    int32 max on the two-key path). Sums+counts — not means — so shards
    of
    a chain ensemble can be merged exactly downstream (the global mean
    is ``sum(sums)/sum(cnt)`` over shards; a mean cannot be re-weighted
    without the counts).

    ``include_self=False`` drops the k diagonal (q == q) pair slots
    before grouping — arrays shrink to ``M*k*(k-1)``. Self-pair means
    only ever produce self-loops, which the simple-graph rounding drops
    (``network_reconstruction_nx.py:501-508``; no representation here
    stores self-loops), so the EDGES consumers use this form — the
    grouping sort is a large share of big sparse reconstructions and
    the diagonal is a third of it."""
    M, k = embs.shape
    if k == 1:
        # a single-node motif paints only self-pairs; grouping them and
        # letting the simple-graph rounding drop them downstream gives
        # the same edges as an empty off-diagonal grouping without
        # 0-length-array corner cases
        include_self = True

    # pair-major flat order (q, r, m) — matches vals_T's (k*k, M) layout
    # elementwise, and the grouping below is order-agnostic; the
    # sample-major (M, k, k) form would materialize tiny-minor-dim
    # intermediates that XLA pads ~43x (see _recon_sample_vals)
    eT = embs.T                                       # (k, M)
    if include_self:
        ii = jnp.broadcast_to(eT[:, None, :], (k, k, M)).reshape(-1)
        jj = jnp.broadcast_to(eT[None, :, :], (k, k, M)).reshape(-1)
        vv = vals_T.reshape(-1)
    else:
        qs = np.asarray([q for q in range(k) for r in range(k) if q != r],
                        dtype=np.int32)
        rs = np.asarray([r for q in range(k) for r in range(k) if q != r],
                        dtype=np.int32)
        ii = eT[qs].reshape(-1)                       # (k*(k-1)*M,)
        jj = eT[rs].reshape(-1)
        vv = vals_T[qs * k + rs].reshape(-1)
    total = ii.shape[0]

    # group by (i, j): sort with the painted values as a PAYLOAD operand
    # of lax.sort — one fused sort, no post-sort gathers (an argsort +
    # three random gathers of the sample width cost more than the sort).
    # n <= 65536: one uint32 fused key (i*n+j fits exactly at 65536);
    # larger: a single two-key lexicographic sort (was TWO argsort
    # passes + gathers).
    fused = n <= 65536
    if fused:
        key32 = (ii.astype(jnp.uint32) * jnp.uint32(n)
                 + jj.astype(jnp.uint32))
        skey, sv = lax.sort((key32, vv), num_keys=1)
        diff = skey[1:] != skey[:-1]
        new_seg = jnp.concatenate([
            jnp.ones((1,), jnp.int32),
            diff.astype(jnp.int32),
        ])
        seg = jnp.cumsum(new_seg) - 1                 # (total,) segment ids
        sums = jax.ops.segment_sum(sv, seg, num_segments=total,
                                   indices_are_sorted=True)
        cnt = jax.ops.segment_sum(jnp.ones_like(sv), seg,
                                  num_segments=total,
                                  indices_are_sorted=True)
        # one segment_max on the fused key, then divmod — padding slots
        # take the uint32 identity 0 (pair (0, 0)) and carry cnt == 0
        kmax = jax.ops.segment_max(skey, seg, num_segments=total,
                                   indices_are_sorted=True)
        out_i = (kmax // jnp.uint32(n)).astype(jnp.int32)
        out_j = (kmax % jnp.uint32(n)).astype(jnp.int32)
        return out_i, out_j, sums, cnt
    si, sj, sv = lax.sort((ii, jj, vv), num_keys=2)
    diff = (si[1:] != si[:-1]) | (sj[1:] != sj[:-1])
    new_seg = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        diff.astype(jnp.int32),
    ])
    seg = jnp.cumsum(new_seg) - 1                     # (total,) segment ids
    # segment_sum keeps the paint sums EXACT (sorted left-to-right adds,
    # ~1.2 s/128M scatter) — a cumsum-difference would cancel
    # catastrophically in f32 at these widths. The other three segment
    # ops (cnt and the two key maxes) carry no accumulation, so one
    # compaction sort replaces all three: mark segment ENDS, sink
    # non-ends to the tail with int32-max keys (node ids < n << 2^31),
    # and read counts off adjacent end-position differences. Segment t's
    # end lands at compacted slot t (both orders are ascending (i, j)),
    # aligning with segment_sum's slot-t output for free. Three scatters
    # -> one 3-operand sort: ~2.4x fewer pass-seconds at the 115M-slot
    # chunk widths of the 9.4M-node records (docs/DESIGN.md §5).
    big = jnp.int32(2**31 - 1)
    is_end = jnp.concatenate([diff, jnp.ones((1,), bool)])
    sums = jax.ops.segment_sum(sv, seg, num_segments=total,
                               indices_are_sorted=True)
    idx = lax.iota(jnp.int32, total)
    ei = jnp.where(is_end, si, big)
    ej = jnp.where(is_end, sj, big)
    out_i, out_j, eidx = lax.sort((ei, ej, idx), num_keys=2)
    real = out_i != big
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), eidx[:-1]])
    # the int32 position difference is exact; the cast to the value
    # dtype (f32) loses exactness for per-pair counts above 2^24
    # (~16.8M paints of ONE pair within one chunk — far past any
    # recorded budget, and the pre-sort segment_sum-of-ones path
    # saturated identically). Documented ceiling, not a regression.
    cnt = jnp.where(real, eidx - prev, 0).astype(sv.dtype)
    return out_i, out_j, sums, cnt


@jax.jit
def _pack_recon_edges(ii, jj, mean, cnt, n):
    """Pack kept directed recon pairs into sorted uint32 ``i*n + j``
    keys; non-kept slots become the all-ones sentinel and sort to the
    tail. Returns ``(sorted_keys, n_keep)``.

    EXACT only for ``n <= 65536`` (``i*n + j`` wraps mod 2^32 beyond
    that, silently corrupting edges) — the caller must branch to the
    prefix-fetch path for larger graphs."""
    keep = (cnt > 0) & (jnp.round(mean) > 0)
    key32 = (ii.astype(jnp.uint32) * jnp.asarray(n, jnp.uint32)
             + jj.astype(jnp.uint32))
    packed = jnp.where(keep, key32, jnp.uint32(0xFFFFFFFF))
    return jnp.sort(packed), jnp.sum(keep)


# explicit-pair fetch bytes above which the CSR-slot bitmask fetch
# wins (see _edges_from_sparse_result). With the membership-slot
# lookup the mask path's device cost is a few sort passes over
# kept + 2E, so the crossover is set by the device-to-host copy rate;
# the mask bytes are ~100x smaller than the pairs'. The value was set
# on an earlier host and is not yet measured on a GPU host.
_MASK_FETCH_BYTES = 24 << 20


@functools.partial(jax.jit, static_argnames=("size",))
def _kept_edge_bits(ii, jj, mean, cnt, g, size):
    """Split the kept directed pairs (rounded mean > 0) into (a) a
    BITMASK over the graph's CSR slots for pairs that are true edges —
    one bit per directed edge slot, ~bits-per-edge device-to-host bytes
    instead of 8 bytes per kept pair — and (b) the canonical (lo, hi)
    extras that are NOT graph edges (compacted to a ``size`` prefix).
    Both orientations of a kept true edge set the SAME canonical slot
    (lo's row position of hi), so the mask is orientation-deduped for
    free; extras dedup on the host.

    Edge lookup rides the ``_pair_membership`` slot kernels (binary
    search or sort-join by the query-count cost model) — degree-
    distribution-independent, so the mask path serves hub graphs too
    (the earlier (size, max_deg) whole-row gather put a 13k-wide hub
    factor on every kept pair of a 4.2M-node BA graph and had to be
    byte-gated off)."""
    keep = (cnt > 0) & (jnp.round(mean) > 0)
    # compact kept pairs first so the membership queries below run
    # over the kept count, not the full slot-capacity arrays
    idx = jnp.nonzero(keep, size=size, fill_value=0)[0]
    valid = (jnp.arange(size) < jnp.sum(keep))
    ki, kj = ii[idx], jj[idx]
    lo = jnp.minimum(ki, kj)
    hi = jnp.maximum(ki, kj)
    member, slot = _pair_membership(g, lo, hi, with_slots=True)
    is_edge = member & (lo != hi) & valid
    e2 = g.nbr_flat.shape[0]
    # non-members may carry a clamped/stale slot — send them OOB so the
    # scatter drops them
    slot = jnp.where(is_edge, slot, e2)
    words = -(-e2 // 32)
    bools = jnp.zeros((words * 32,), bool).at[slot].max(
        is_edge, mode="drop")
    bits = jnp.sum(
        bools.reshape(words, 32).astype(jnp.uint32)
        << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1,
        dtype=jnp.uint32)
    extra = valid & ~is_edge
    n_extra = jnp.sum(extra)
    # extras to a prefix: two-key sort with int32-max sentinels (no
    # int64: x64 is disabled). They are few — near-misses
    # of the rounding; self-pairs land here too and the host
    # simple-graph fold drops them.
    big = jnp.int32(2**31 - 1)
    elo = jnp.where(extra, lo, big)
    ehi = jnp.where(extra, hi, big)
    elo, ehi = lax.sort((elo, ehi), num_keys=2)
    return bits, elo, ehi, n_extra


@functools.partial(jax.jit, static_argnames=("size",))
def _kept_pairs(ii, jj, mean, cnt, size):
    """Compact the kept directed pairs (rounded mean > 0) to a prefix of
    a ``size``-slot buffer via a sized ``nonzero`` — no sort, works for
    any n. Slots past the kept count are filled with the (0, 0) pair
    (never fetched: callers slice to the true count first)."""
    keep = (cnt > 0) & (jnp.round(mean) > 0)
    idx = jnp.nonzero(keep, size=size, fill_value=0)[0]
    return ii[idx], jj[idx]


def _edges_from_sparse_result(ii, jj, mean, cnt, n, g=None):
    """Host-side simple-graph edges from a `reconstruct_network_sparse`
    result, minimizing device-to-host bytes.

    For n <= 65536: ship ONE packed uint32 array — on device, keep the
    pairs whose rounded mean is an edge, pack (i, j) into i*n+j, sort so
    the kept keys occupy a prefix, fetch the kept-count scalar, then
    ship only that prefix (~1/4 the bytes of the three-array prefix
    fetch). The all-ones sentinel can only
    collide with the (n-1, n-1) self-pair, which the simple-graph filter
    drops anyway.

    Beyond 65536 nodes i*n+j wraps mod 2^32. When the graph's host CSR
    copies are available (builder-constructed graphs), ship ONE BIT per
    directed CSR slot for the kept pairs that are true edges plus the
    few non-edge extras — ~bits-per-edge bytes (a 9.4M-node torus's
    31M directed pairs are ~250 MB as pairs, ~4.7 MB as a mask).
    Otherwise compact
    the kept pairs to a prefix on device (sized ``nonzero``) and ship
    the two prefixes."""
    if n <= 65536:
        packed, n_keep = _pack_recon_edges(ii, jj, mean, cnt, n)
        pk = np.asarray(packed[:int(n_keep)]).astype(np.int64)
        pi, pj = pk // n, pk % n
        return _undirected_simple_edges(pi, pj)
    from onmf_ontf_ndl_tpu.data.graphs import host_csr

    hcsr = host_csr(g) if g is not None else None
    n_keep = int(jnp.sum((cnt > 0) & (jnp.round(mean) > 0)))
    # pad the compaction size to the next power of two so repeat
    # reconstructions at similar scales reuse the jit cache
    size = max(1024, 1 << (max(n_keep, 1) - 1).bit_length())
    size = min(size, ii.shape[0])
    # the mask path's own device compaction/membership/scatter and host
    # decode have a fixed cost at the multi-million-pair scale, so it
    # only wins when the explicit-pair fetch bytes dwarf that — route by
    # kept-pair fetch size.
    if hcsr is not None and n_keep * 8 > _MASK_FETCH_BYTES:
        offs_np, dst_np = hcsr
        bits, elo, ehi, n_extra = _kept_edge_bits(ii, jj, mean, cnt, g,
                                                  size)
        n_extra = int(n_extra)
        # decode the slot mask on the host via the retained CSR arrays
        w = np.asarray(bits)
        bools = np.unpackbits(w.view(np.uint8), bitorder="little")
        slots = np.flatnonzero(bools[:dst_np.shape[0]])
        src = np.searchsorted(offs_np, slots, side="right").astype(
            np.int64) - 1
        dst = dst_np[slots].astype(np.int64)
        pi = np.concatenate([src, np.asarray(elo[:n_extra], np.int64)])
        pj = np.concatenate([dst, np.asarray(ehi[:n_extra], np.int64)])
        return _undirected_simple_edges(pi, pj)
    ki, kj = _kept_pairs(ii, jj, mean, cnt, size)
    pi = np.asarray(ki[:n_keep]).astype(np.int64)
    pj = np.asarray(kj[:n_keep]).astype(np.int64)
    return _undirected_simple_edges(pi, pj)


def _undirected_simple_edges(pi, pj):
    """Host-side simple-graph fold shared by the single-device and DP
    reconstruction paths: directed kept pairs -> sorted unique
    undirected edges, self-loops dropped (the reference's rounding to a
    simple graph, ``network_reconstruction_nx.py:501-508``).

    Dedup via a packed 64-bit key + 1-D ``np.unique`` — the structured
    ``np.unique(axis=0)`` sorts rows ~10x slower, a multi-second host
    phase of million-node reconstructions. Same output: (lo << 32) | hi orders identically to
    (lo, hi) lexicographic for node ids < 2^31."""
    lo, hi = np.minimum(pi, pj), np.maximum(pi, pj)
    off_diag = lo != hi
    key = (lo[off_diag].astype(np.int64) << 32) | hi[off_diag].astype(
        np.int64)
    uk = np.unique(key)
    return np.stack([uk >> 32, uk & 0xFFFFFFFF], axis=1)


class NetworkReconstructor:
    """Driver shell mirroring ``Network_Reconstructor``
    (``network_reconstruction_nx.py:19-48,535-574``)."""

    def __init__(
        self,
        source: str | Graph | None = None,
        adjacency=None,
        n_components: int = 100,
        MCMC_iterations: int = 500,
        sub_iterations: int = 100,
        sample_size: int = 1000,
        batch_size: int = 10,
        k1: int = 1,
        k2: int = 2,
        loc_avg_depth: int = 1,
        alpha: float | None = None,
        is_WAN: bool = False,
        is_glauber_dict: bool = True,
        is_glauber_recons: bool = True,
        weighted_patches: bool = False,
        fast: bool = False,
        coder: str = "bcd",
        num_chains: int = 1,
        subsample: bool = False,
        seed: int = 0,
        dtype=jnp.float32,
    ):
        if isinstance(source, (Graph, BitsetGraph, CsrGraph)):
            self.G = source
        elif source is not None:
            self.G = load_edgelist(source)
        elif adjacency is not None:
            self.G = graph_from_adjacency(adjacency, normalize=is_WAN)
        else:
            raise ValueError("NetworkReconstructor: provide source or adjacency")
        self.n_components = n_components
        self.MCMC_iterations = MCMC_iterations
        self.sub_iterations = sub_iterations
        self.sample_size = sample_size
        self.batch_size = batch_size
        self.k1, self.k2 = k1, k2
        # stored-but-unused in the reference too ("keep it at 1",
        # network_reconstruction_nx.py:20,33,564) — kept for
        # constructor-surface parity, documented inert (PARITY.md C9)
        self.loc_avg_depth = loc_avg_depth
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.is_glauber_dict = is_glauber_dict
        self.is_glauber_recons = is_glauber_recons
        self.weighted_patches = weighted_patches
        # fast=True: fixed coder sweeps (no spectral-norm stopping), one
        # kernel launch per coder call on a GPU
        self.fast = fast
        self.coder = coder
        self.subsample = subsample
        self.dtype = dtype

        self.num_chains = max(1, int(num_chains))
        self.B = path_adj(k1, k2)
        self._B_bytes = np.asarray(self.B, np.int8).tobytes()
        self._parents = tree_parents(self.B)
        k = k1 + k2 + 1
        self.key = jax.random.key(seed)
        # 4-way split keeps the driver stream disjoint from the state's
        self.key, xk, tk, sk = jax.random.split(self.key, 4)
        if self.num_chains > 1:
            x0 = jax.random.randint(xk, (self.num_chains,), 0,
                                    self.G.num_nodes)
            self.emb = jax.vmap(
                lambda kk, x: tree_sample(kk, self._parents, self.G, x)
            )(jax.random.split(tk, self.num_chains), x0)
        else:
            x0 = jax.random.randint(xk, (), 0, self.G.num_nodes)
            self.emb = tree_sample(tk, self._parents, self.G, x0)
        self.state = init_state(sk, k * k, n_components, dtype=dtype)
        self.code = jnp.zeros((n_components, sample_size), dtype)
        self.G_recons = None
        self.G_recons_edges = None
        self.recon_weights = None

    @property
    def W(self):
        return self.state.W

    @W.setter
    def W(self, value):
        self.state = dataclasses.replace(
            self.state, W=jnp.asarray(value, self.dtype))

    def train_dict(self, checkpoint_path: str | None = None,
                   checkpoint_every: int = 0, resume: bool = False):
        """Run the fused NDL training; returns the dictionary (k^2, r).

        ``checkpoint_path`` + ``checkpoint_every=N`` chunk the MCMC outer
        loop into runs of N iterations with a checkpoint between chunks
        carrying the FULL training state — optimizer pytree, chain
        embedding(s), and accumulated code matrix — so chunked training
        equals the uninterrupted run exactly. ``resume=True`` restarts an
        interrupted run from the checkpoint, recovering the completed
        MCMC-iteration count from the schedule counter ``state.t`` and
        running only the remainder (the reference's first-iteration code
        discard is applied exactly once per logical run).

        ``checkpoint_every=N`` WITHOUT a path chunks the same way but
        skips the file writes: pure execution chunking. Use it to bound
        the single-device-program runtime — at million-node scale the
        one fused 50-iteration scan can run minutes, and runtimes that
        cap program duration (or preempt long programs) kill it;
        N-iteration programs are equal math in equal total time."""
        from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

        if (checkpoint_path or resume) and checkpoint_every <= 0:
            raise ValueError(
                "checkpoint_path/resume require checkpoint_every > 0 "
                "(otherwise the request would be silently ignored and "
                "training restarted from scratch)")

        def run(mcmc, discard_first):
            self.state, code_new, self.emb = ndl_train(
                self.state, self.G, self.emb, self._B_bytes, self._parents,
                mcmc_iterations=mcmc,
                sample_size=self.sample_size,
                inner_iterations=self.sub_iterations,
                batch_size=self.batch_size,
                alpha=self.alpha,
                use_glauber=self.is_glauber_dict,
                weighted=self.weighted_patches,
                use_stopping=not self.fast,
                backend=resolve_backend("auto"),
                coder=self.coder,
                num_chains=self.num_chains,
                subsample=self.subsample,
                discard_first=discard_first,
            )
            return code_new

        if checkpoint_every > 0 and not checkpoint_path:
            # pure execution chunking: identical math to the fused run
            # (the carried state, embedding, and PRNG key all round-trip
            # through self), split into bounded device programs
            total = None
            done = 0
            while done < self.MCMC_iterations:
                chunk = min(checkpoint_every, self.MCMC_iterations - done)
                code_new = run(chunk, discard_first=(done == 0))
                total = code_new if total is None else total + code_new
                done += chunk
            # same cross-call accumulation rule as the fused branch
            if self.code.shape == total.shape:
                self.code = self.code + total
            else:
                self.code = total
        elif checkpoint_path and checkpoint_every > 0:
            import os as _os

            from onmf_ontf_ndl_tpu.utils.checkpoint import (
                checkpoint_exists, load_state, save_state)

            # the resume count is derived from the schedule counter,
            # which only advances when the inner loop runs > 1
            # iterations (models/onmf.py _train_scan) and assumes a
            # zero-based schedule — guard both
            if self.sub_iterations <= 1:
                raise ValueError(
                    "checkpointed training needs sub_iterations > 1 "
                    "(the resume count is recovered from the schedule "
                    "counter, which sub_iterations <= 1 does not "
                    "advance)")
            if float(self.state.t) != 0.0 and not resume:
                raise ValueError(
                    "checkpointed training starts from a fresh state "
                    "(t = 0); for a warm-started state the t-derived "
                    "resume count would be wrong")
            done = 0
            if resume and checkpoint_exists(checkpoint_path):
                self.state, extra = load_state(
                    checkpoint_path, dtype=self.dtype, with_extra=True)
                self.emb = jnp.asarray(extra["emb"], jnp.int32)
                self.code = jnp.asarray(extra["code"], self.dtype)
                done = (int(round(float(self.state.t)))
                        // self.sub_iterations)
            while done < self.MCMC_iterations:
                chunk = min(checkpoint_every, self.MCMC_iterations - done)
                code_new = run(chunk, discard_first=(done == 0))
                # chunks accumulate into the instance code matrix
                self.code = self.code + code_new if done else code_new
                done += chunk
                save_state(checkpoint_path, self.state,
                           extra={"emb": self.emb, "code": self.code})
        else:
            # the reference ACCUMULATES self.code across train_dict
            # calls (network_reconstruction_nx.py:356,384; each call
            # discards its own first iteration's H) — match that.
            # (ndl_train rounds the code width up to a chain-ensemble
            # multiple; the first call defines the accumulator width.)
            code_new = run(self.MCMC_iterations, discard_first=True)
            if self.code.shape == code_new.shape:
                self.code = self.code + code_new
            else:
                self.code = code_new
        return self.state.W

    def reconstruct_network(self, recons_iter: int = 100, alpha: float = 0.0,
                            num_chains: int | None = None,
                            sparse: bool | None = None,
                            chunks: int = 1, cap: int | None = None):
        """Reconstruct the network (``reconstruct_network``, ``:444-511``).

        ``sparse=False`` returns a dense boolean (N, N) matrix;
        ``sparse=True`` returns a (num_edges, 2) int array of undirected
        simple-graph edges, computed with O(samples) memory — the path
        that scales to the arxiv/facebook graphs. ``sparse=None`` keeps
        the return type a function of the graph REPRESENTATION only
        (type-stable for callers): dense for a dense :class:`Graph`,
        sparse for a :class:`BitsetGraph` (whose whole point is never
        materializing (N, N)); pass ``sparse=True`` explicitly for a
        large dense-represented graph. Both paths implement the same
        per-edge-mean + rounding semantics. ``num_chains`` defaults to
        the instance's ensemble width; > 1 splits the chain work over an
        ensemble. ``chunks > 1`` (sparse path only) runs the budget in
        pieces folded through a fixed-capacity accumulator — sample
        budgets beyond one device's memory; see
        :func:`reconstruct_network_sparse_chunked`."""
        if num_chains is None:
            num_chains = self.num_chains
        if sparse is None:
            sparse = isinstance(self.G, (BitsetGraph, CsrGraph))
        if chunks > 1 and not sparse:
            raise ValueError("chunks > 1 requires the sparse path")
        self.key, rk = jax.random.split(self.key)
        if not sparse:
            recon, cnt = reconstruct_network(
                self.state.W, self.G, rk, self._B_bytes, self._parents,
                recons_iter=recons_iter, alpha=alpha,
                use_glauber=self.is_glauber_recons,
                weighted=self.weighted_patches, num_chains=num_chains,
                method=self.coder,
            )
            self.recon_weights = recon
            simple = jnp.logical_and(jnp.round(recon) > 0, cnt > 0)
            simple = jnp.logical_or(simple, simple.T)
            self.G_recons = simple
            self.G_recons_edges = None
            return simple
        if chunks > 1:
            ii, jj, mean, cnt = reconstruct_network_sparse_chunked(
                self.state.W, self.G, rk, self._B_bytes, self._parents,
                recons_iter=recons_iter, chunks=chunks, cap=cap,
                alpha=alpha, use_glauber=self.is_glauber_recons,
                weighted=self.weighted_patches, num_chains=num_chains,
                method=self.coder,
            )
        else:
            ii, jj, mean, cnt = reconstruct_network_sparse(
                self.state.W, self.G, rk, self._B_bytes, self._parents,
                recons_iter=recons_iter, alpha=alpha,
                use_glauber=self.is_glauber_recons,
                weighted=self.weighted_patches, num_chains=num_chains,
                method=self.coder,
                # self-pair means only ever produce self-loops, which
                # the simple-graph edges drop — skip a third of the
                # grouping sort
                include_self=False,
            )
        edges = _edges_from_sparse_result(ii, jj, mean, cnt,
                                          self.G.num_nodes, g=self.G)
        self.recon_weights = None
        self.G_recons = None
        self.G_recons_edges = edges
        return edges

    def recons_edges(self):
        """Undirected (num_edges, 2) edge array (interned indices) of the
        last reconstruction, whichever form it was computed in."""
        if self.G_recons_edges is not None:
            return self.G_recons_edges
        if self.G_recons is None:
            raise ValueError("no reconstruction yet; call "
                             "reconstruct_network() first")
        rec = np.array(self.G_recons)
        np.fill_diagonal(rec, False)
        return np.argwhere(np.triu(rec))

    def write_edgelist(self, path: str, delimiter: str = ","):
        """Export the reconstructed simple graph as an edge list in the
        ORIGINAL node labels — the reference's
        ``nx.write_edgelist(G_recons, data=False, delimiter=',')`` export
        (``network_reconstruction_nx.py:601-609``)."""
        edges = self.recons_edges()
        ids = np.asarray(self.G.node_ids)
        with open(path, "w") as f:
            for i, j in edges:
                f.write(f"{ids[i]}{delimiter}{ids[j]}\n")
        return path

    def compute_A_recons(self, path: str, delimiter: str = ","):
        """Read a reconstructed-graph edge list and return its dense
        adjacency **in this graph's node ordering** — the reference's
        ``compute_A_recons`` (``network_reconstruction_nx.py:526-533``),
        whose crucial detail is ``nodelist=self.G.nodes``: the same node
        order as A, so the matrices are comparable entry-wise. Edges
        touching labels outside this graph are dropped (the reference's
        ``to_numpy_matrix(nodelist=...)`` does the same)."""
        idx = {label: i for i, label in enumerate(self.G.node_ids)}
        n = self.G.num_nodes
        A = np.zeros((n, n), np.float64)
        raw = np.genfromtxt(path, delimiter=delimiter, dtype=np.int64)
        raw = raw.reshape(-1, 2)
        for a, b in raw:
            ia, ib = idx.get(int(a)), idx.get(int(b))
            if ia is not None and ib is not None:
                A[ia, ib] = A[ib, ia] = 1.0
        return A

    def label_of(self, index: int):
        """Array index -> original node label (``np2nx``,
        ``network_reconstruction_nx.py:74-78``)."""
        return self.G.node_ids[int(index)]

    def index_of(self, label) -> int:
        """Original node label -> array index (``nx2np``, ``:80-84``)."""
        return self.G.node_ids.index(label)

    def display_dict(self, title: str = "", save_filename: str | None = None,
                     show: bool = False):
        """Motif-dictionary grid (``display_dict``,
        ``network_reconstruction_nx.py:393-419``)."""
        from onmf_ontf_ndl_tpu.utils.viz import display_network_dictionary

        k = self.k1 + self.k2 + 1
        return display_network_dictionary(
            self.W, k, title=title or None, save_path=save_filename,
            show=show)

    def show_cov(self, save_path=None, show=False):
        """Trace-normalized covariance of the accumulated code matrix
        (``show_cov``, ``network_reconstruction_nx.py:429-442``)."""
        from onmf_ontf_ndl_tpu.utils.metrics import code_covariance

        cov = code_covariance(self.code)
        if save_path or show:
            import matplotlib
            if save_path and not show:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(4, 4.5),
                                   subplot_kw={"xticks": [], "yticks": []})
            im = ax.imshow(np.asarray(cov))
            fig.colorbar(im)
            if save_path:
                fig.savefig(save_path, bbox_inches="tight")
            if show:
                plt.show()
            plt.close(fig)
        return cov

    def has_edge(self, i, j) -> np.ndarray:
        """Vectorized edge test on either graph representation.

        Gathers on DEVICE and fetches only the E tested words — never the
        full adjacency (the bitset matrix is tens of MB at arxiv
        scale)."""
        i = np.asarray(i)
        j = np.asarray(j)
        from onmf_ontf_ndl_tpu.data.graphs import host_csr

        hcsr = host_csr(self.G)
        if hcsr is not None:
            # membership entirely on the host: one sorted packed-key
            # array per graph (cached), then a vectorized searchsorted —
            # no device round trip (uploading a 15M-pair query costs
            # ~35 s over this link at the 9.4M-node scale)
            offs_np, dst_np = hcsr
            keys = getattr(self, "_host_edge_keys", None)
            if keys is None or keys[0] is not self.G:
                n = self.G.num_nodes
                src = np.searchsorted(
                    offs_np, np.arange(len(dst_np)), side="right") - 1
                keys = (self.G,
                        np.sort(src.astype(np.int64) * n + dst_np))
                self._host_edge_keys = keys
            q = i.astype(np.int64) * self.G.num_nodes + j.astype(np.int64)
            pos = np.searchsorted(keys[1], q)
            pos = np.minimum(pos, len(keys[1]) - 1)
            return (keys[1][pos] == q) if len(keys[1]) else \
                np.zeros(q.shape, bool)
        if isinstance(self.G, BitsetGraph):
            # per-dim (row, word) gather: no linear index to overflow,
            # no flattened view (see the BitsetGraph layout note)
            words = np.asarray(self.G.bits.at[
                jnp.asarray(i.astype(np.int32)),
                jnp.asarray((j // 32).astype(np.int32))].get(mode="clip"))
            return ((words >> (j % 32).astype(np.uint32)) & 1).astype(bool)
        if isinstance(self.G, CsrGraph):
            from onmf_ontf_ndl_tpu.samplers.motif import _csr_row_slots
            slots, ok = _csr_row_slots(self.G, jnp.asarray(
                i.astype(np.int32)))                   # (E, D)
            hit = (slots == jnp.asarray(j.astype(np.int32))[:, None]) & ok
            return np.asarray(jnp.any(hit, axis=1))
        return np.asarray(self.G.adj[jnp.asarray(i), jnp.asarray(j)])

    def compute_recons_accuracy(self, G_recons=None):
        """``|E(G & G_recons)| / |E(G)|``
        (``network_reconstruction_nx.py:513-524``).

        Accepts either the dense boolean matrix or the sparse
        (num_edges, 2) edge array from :meth:`reconstruct_network`;
        defaults to whichever the last reconstruction produced."""
        if G_recons is None:
            G_recons = (self.G_recons if self.G_recons is not None
                        else self.G_recons_edges)
        G_recons_np = np.asarray(G_recons)
        if G_recons_np.ndim == 2 and G_recons_np.shape[1] == 2 and \
                G_recons_np.dtype != bool:
            # sparse undirected edge list (i < j rows, unique)
            edges = G_recons_np
            if isinstance(self.G, (BitsetGraph, CsrGraph)):
                total = int(np.asarray(self.G.deg).sum()) // 2
            else:
                total = int(np.asarray(self.G.adj).sum()) // 2
            if len(edges) == 0:
                return 0.0
            common = int(self.has_edge(edges[:, 0], edges[:, 1]).sum())
            return float(common) / max(total, 1)
        if isinstance(self.G, BitsetGraph):
            # unpack the bit rows to a dense boolean matrix on the host
            bits = np.ascontiguousarray(np.asarray(self.G.bits))
            n = self.G.num_nodes
            adj = (np.unpackbits(
                bits.view(np.uint8), axis=1, bitorder="little")[:, :n]
                .astype(bool))
        elif isinstance(self.G, CsrGraph):
            n = self.G.num_nodes
            deg = np.asarray(self.G.deg)
            adj = np.zeros((n, n), bool)
            adj[np.repeat(np.arange(n), deg),
                np.asarray(self.G.nbr_flat)] = True
        else:
            adj = np.asarray(self.G.adj)
        rec = np.array(G_recons)  # writable copy
        np.fill_diagonal(rec, False)
        common = np.logical_and(adj, rec).sum() // 2
        total = adj.sum() // 2
        return float(common) / max(int(total), 1)
