"""MCMC motif-homomorphism samplers for network dictionary learning.

Re-designs the reference's networkx-based Glauber / Pivot chains
(``/root/reference/network_reconstruction_nx.py:108-340``) as jitted
device kernels over the dense :class:`~onmf_ontf_ndl_tpu.data.graphs.Graph`
pytree:

- the Glauber move's common-neighbor set intersection (``:160-166``)
  becomes a row-wise AND over adjacency rows + masked categorical draw;
- the pivot move is the reference's actually-running variant: an MH
  random walk on the root with acceptance ``min(1, deg(x)/deg(y))``
  (``RW_update``, ``:175-199``) followed by re-growing the tree
  (``Pivot_update``, ``:265-278``). (The degree-power
  ``pivot_acceptance_prob`` variant at ``:201-209`` references an
  undefined attribute and is dead code in the reference; per SURVEY.md §7
  we keep MH-walk pivoting as the pivot kernel.)
- k x k patches gather ``adj[emb[q], emb[r]]`` directly (``:301-305``);
  weighted graphs gather ``weight`` instead.

Chains are sequential by definition; throughput comes from vmapping
ensembles of chains (the reference runs exactly one chain;
:func:`sample_patches` keeps that for parity and
:func:`sample_patches_ensemble` scales it).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.data.graphs import BitsetGraph, CsrGraph, Graph

# Glauber kernel selection for BitsetGraph: the candidate-list
# intersection does O(max_deg) scattered single-word lookups per chain
# step; the packed-AND kernel streams O(words_per_row) contiguous words.
# Scattered lookups cost roughly a cache-line granule each, so the
# candidate kernel wins when max_deg * FACTOR <= words_per_row
# (conservative; at the 512^2 torus the ratio is 4 vs 8192).
_CANDIDATE_DEG_FACTOR = 8

# Above this max_deg the CsrGraph membership tests switch from
# whole-row gathers + broadcast compares (O(max_deg) elements and
# O(max_deg^2) compares per query batch — the right trade for
# near-regular low-degree graphs) to per-query binary search on the
# ascending CSR rows (O(log2 max_deg) gathered elements per query,
# INDEPENDENT of the degree distribution). Skewed/power-law graphs put
# max_deg orders of magnitude above the typical row (a 1M-node
# Barabasi-Albert m=2 graph: max_deg ~2,000, mean 4), so every padded
# per-row shape pays the hub tax for every query; the binary search
# pays ~11 elements regardless.
_BSEARCH_DEG_THRESHOLD = 256

# byte gate for the (D, k, M) slot-block forms in pair_matrices_T: past
# about a device's memory the compiler stops fusing the block gather
# into its consumer and buffer assignment fails outright (facebook's
# D=1045 x M=1.2M, 15 GB nominal)
_SLOT_BLOCK_BYTES = 8 << 30

__all__ = [
    "path_adj",
    "tree_parents",
    "tree_sample",
    "rw_update",
    "glauber_update",
    "pivot_update",
    "patch_from_embedding",
    "sample_patches",
    "sample_patches_ensemble",
]


def path_adj(k1: int, k2: int) -> np.ndarray:
    """Adjacency of the path motif with k1 left / k2 right arms rooted at
    node 0 (``network_reconstruction_nx.py:86-95``)."""
    if k1 == 0 or k2 == 0:
        k3 = max(k1, k2)
        return np.eye(k3 + 1, k=1, dtype=int)
    A = np.eye(k1 + k2 + 1, k=1, dtype=int)
    A[k1, k1 + 1] = 0
    A[0, k1 + 1] = 1
    return A


def tree_parents(B: np.ndarray) -> tuple[int, ...]:
    """Parent of each non-root motif node under depth-first ordering:
    the minimum in-neighbor index (``find_parent``,
    ``network_reconstruction_nx.py:100-106``). Host-side/static.

    A node with no in-neighbor gets parent ``-1``, meaning "embed as a
    uniform random node" — the reference's edgeless-motif branch
    (``tree_sample``, ``:119-122``) generalized per node (the reference
    itself would crash on a partially rooted motif)."""
    B = np.asarray(B)
    parents = []
    for i in range(1, B.shape[0]):
        js = np.flatnonzero(B[:, i] == 1)
        parents.append(int(js.min()) if len(js) else -1)
    return tuple(parents)


def _uniform_neighbor(key: jax.Array, g, x: jax.Array) -> jax.Array:
    """Uniform draw from the neighbors of x; returns x itself when x is
    isolated (the reference's tree_sample fallback, ``:128-131``)."""
    d = g.deg[x]
    idx = jax.random.randint(key, (), 0, jnp.maximum(d, 1))
    pad = getattr(g, "nbr_pad_T", None)
    if pad is not None:
        y = pad[idx, x]          # idx < deg(x): never reads a pad slot
    elif isinstance(g, (BitsetGraph, CsrGraph)):
        y = g.nbr_flat[g.offsets[x] + idx]
    else:
        y = g.nbr[x, idx]
    return jnp.where(d > 0, y, x)


def _csr_row_slots(g, u):
    """Padded CSR rows of (possibly batched) node indices ``u``: returns
    ``(slots, ok)`` with shapes ``u.shape + (max_deg,)`` — the ascending
    neighbor candidates of each node and their validity mask. Uses the
    padded ``nbr_pad_T`` table when the graph carries one (one gather of
    ``max_deg`` elements per row instead of offset + deg + slots —
    a gather costs per gathered element); valid
    slots are identical either way, so draws are too."""
    D = max(g.max_deg, 1)
    pad = getattr(g, "nbr_pad_T", None)
    if pad is not None:
        slots = jnp.moveaxis(pad.at[:, u].get(mode="clip"), 0, -1)
        return slots, slots != g.num_nodes
    d_idx = jnp.arange(D, dtype=jnp.int32)
    slots = g.nbr_flat.at[g.offsets[u][..., None] + d_idx].get(mode="clip")
    ok = d_idx < g.deg[u][..., None]
    return slots, ok


def _pair_membership_bsearch(g, row: jax.Array, col: jax.Array,
                             with_slots: bool = False):
    """Edge indicators for ordered index pairs on a CSR-backed graph by
    binary search of ``col`` in ``row``'s ascending CSR row segment.
    ``row``/``col`` are equal-shaped int32 arrays; returns a bool array
    of the same shape (with ``with_slots=True``, a ``(member, slot)``
    pair where ``slot`` is the flat CSR index of the ``row -> col``
    directed edge, valid only where ``member``).

    Cost: ``ceil(log2(max_deg)) + 3`` gathered elements per query,
    independent of the degree distribution — the membership kernel for
    skewed-degree (power-law) graphs, where hub rows make ``max_deg``
    (and with it every padded per-row block shape) orders of magnitude
    larger than the typical row. Unrolled fixed-trip lower-bound search:
    no data-dependent control flow, all intermediates query-shaped with
    the sample axis minor (the pair_matrices_T layout rule)."""
    off = g.offsets.at[row].get(mode="clip")
    deg = g.deg.at[row].get(mode="clip")
    lo = jnp.zeros(row.shape, jnp.int32)
    hi = deg.astype(jnp.int32)
    for _ in range(max(int(g.max_deg).bit_length(), 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        v = g.nbr_flat.at[off + mid].get(mode="clip")
        go_right = active & (v < col)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    v = g.nbr_flat.at[off + lo].get(mode="clip")
    member = (lo < deg) & (v == col)
    if with_slots:
        return member, off + lo
    return member


def _pair_membership_sortjoin(g, row: jax.Array, col: jax.Array,
                              with_slots: bool = False):
    """Edge indicators for ordered index pairs on a CSR-backed graph by
    a SORT-JOIN against the edge list: same contract as
    :func:`_pair_membership_bsearch` (equal-shaped int32 ``row``/``col``
    in, bool out; ``(member, slot)`` with ``with_slots=True``), chosen
    for LARGE query batches.

    Rationale (docs/DESIGN.md §5 "one sort beats many gathers"): the
    binary search gathers ``log2(max_deg) + 3`` random elements per
    query, while a two-key ``lax.sort`` streams its operands. The CSR (src, dst) edge list is ALREADY sorted
    (rows ascending, ascending within each row — the builders' lexsort
    contract), so membership for Q queries is: stable-sort the
    ``Q + 2E`` concatenated (i, j) pairs (edges first, so within an
    equal-key run the edge precedes every query), mark a query a member
    iff the latest edge at-or-before it lies in its own run (two
    ``cummax`` passes — no gathers at all), and restore query order
    with one payload sort. Total ~5 element·operand sort passes over
    ``Q + 2E`` versus ``Q * (log2(max_deg) + 3)`` gathered elements —
    the win at reconstruction batch sizes on hub graphs (the cost
    model that chooses between them was tuned on an earlier device and
    is not yet measured on a GPU).
    """
    shape = row.shape
    qi = row.reshape(-1).astype(jnp.int32)
    qj = col.reshape(-1).astype(jnp.int32)
    q = qi.shape[0]
    twoE = g.nbr_flat.shape[0]
    # edge sources from the CSR row starts: +1 at each row boundary,
    # cumsum. Empty rows stack their boundary bumps; trailing empties
    # index at twoE and drop.
    bump = jnp.zeros((twoE,), jnp.int32).at[g.offsets[1:]].add(
        1, mode="drop")
    src = jnp.cumsum(bump)
    ki = jnp.concatenate([src, qi])
    kj = jnp.concatenate([g.nbr_flat.astype(jnp.int32), qj])
    payload = jnp.concatenate([jnp.full((twoE,), -1, jnp.int32),
                               jnp.arange(q, dtype=jnp.int32)])
    ki, kj, payload = lax.sort((ki, kj, payload), num_keys=2,
                               is_stable=True)
    is_edge = payload < 0
    iota = jnp.arange(twoE + q, dtype=jnp.int32)
    runstart = jnp.concatenate(
        [jnp.ones((1,), bool), (ki[1:] != ki[:-1]) | (kj[1:] != kj[:-1])])
    last_edge = lax.cummax(jnp.where(is_edge, iota, -1))
    run_start_idx = lax.cummax(jnp.where(runstart, iota, -1))
    member = (last_edge >= run_start_idx) & ~is_edge
    if not with_slots:
        payload, member = lax.sort((payload, member.astype(jnp.int32)),
                                   num_keys=1, is_stable=True)
        return member[twoE:].astype(bool).reshape(shape)
    # the t-th edge in sorted order IS flat CSR slot t (the CSR edge
    # list ascends by (src, dst) and the stable sort preserves the
    # edges' relative order), so the matching edge's slot at any query
    # is a running edge count — no gathers
    slot_at = jnp.cumsum(is_edge.astype(jnp.int32)) - 1
    payload, member, slot = lax.sort(
        (payload, member.astype(jnp.int32), slot_at), num_keys=1,
        is_stable=True)
    return (member[twoE:].astype(bool).reshape(shape),
            slot[twoE:].reshape(shape))


def _pair_membership(g, row: jax.Array, col: jax.Array,
                     with_slots: bool = False):
    """Membership kernel dispatch for CSR graphs: binary search for
    small query batches, sort-join once the gathered-element bill
    exceeds the sort bill (cost model in the kernel docstrings; the
    ~3x gather-vs-sort per-element price folds into the constant).
    ``with_slots=True`` additionally returns the flat CSR slot of each
    member pair's directed edge."""
    q = int(np.prod(row.shape))
    twoE = g.nbr_flat.shape[0]
    bsearch_elems = q * (max(int(g.max_deg).bit_length(), 1) + 3)
    sortjoin_equiv = (q + twoE) * 2
    if bsearch_elems > sortjoin_equiv:
        return _pair_membership_sortjoin(g, row, col, with_slots)
    return _pair_membership_bsearch(g, row, col, with_slots)


def _bitset_rows(g, idx: jax.Array) -> jax.Array:
    """(len(idx), W32) packed adjacency rows: a whole-row gather from
    the canonical 2-D bitset: one gather instead of vmapped
    ``dynamic_slice`` from a flattened copy — see the layout note on
    :class:`BitsetGraph`."""
    return g.bits[idx]


def _adj_rows(g, emb: jax.Array) -> jax.Array:
    """(k, N) boolean adjacency rows of the embedded nodes, for any
    graph representation (bitset rows are unpacked on the fly; CSR rows
    are scattered into one-hot rows)."""
    if isinstance(g, BitsetGraph):
        n = g.num_nodes
        words = _bitset_rows(g, emb)               # (k, W32)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bools = (words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
        return bools.reshape(emb.shape[0], -1)[:, :n].astype(bool)
    if isinstance(g, CsrGraph):
        slots, ok = _csr_row_slots(g, emb)         # (k, D)
        k = emb.shape[0]
        return jnp.zeros((k, g.num_nodes), bool).at[
            jnp.arange(k, dtype=jnp.int32)[:, None], slots].max(ok)
    return g.adj[emb]


def _pair_matrix(g, emb: jax.Array) -> jax.Array:
    """(k, k) float edge-indicator matrix among the embedded nodes."""
    if isinstance(g, BitsetGraph):
        cols = emb[None, :]
        words = g.bits.at[emb[:, None], cols // 32].get(mode="clip")
        bit = (words >> cols.astype(jnp.uint32) % 32) & jnp.uint32(1)
        return bit.astype(jnp.float32)
    if isinstance(g, CsrGraph):
        slots, ok = _csr_row_slots(g, emb)         # (k, D)
        hit = (slots[:, None, :] == emb[None, :, None]) & ok[:, None, :]
        return jnp.any(hit, axis=-1).astype(jnp.float32)
    return g.adj[emb[:, None], emb[None, :]].astype(jnp.float32)


def pair_matrices_T(g, embs: jax.Array, *,
                    weighted: bool = False) -> jax.Array:
    """Flattened pair matrices for a BATCH of embeddings, transposed:
    ``(k*k, M)`` with entry ``(q*k + r, m) = patch value of pair (q, r)
    in sample m`` — identical values/order to
    ``vmap(_pair_matrix)(embs).reshape(M, k*k).T``.

    The batch axis is kept MINOR throughout. The vmapped form builds
    gather index tensors whose minor dims are (k, k); XLA pads those to
    full tile extents, a many-fold expansion of device memory at
    reconstruction scale. Here every
    intermediate is (k*k, M) with M minor, i.e. tile-dense.

    Every gather indexes the matrix operand with PER-DIMENSION (row,
    col) index pairs — never a flattened view plus a linear index: an
    on-device ``reshape(-1)`` of a tiled 2-D array is a full relayout
    copy (8 GB at 512^2-torus scale), and a linear index wraps int32
    past 2^31 elements (the 512^2 bitset is exactly 2^31 words; a dense
    adjacency wraps at 46,341 nodes) while per-dim indices each stay
    < N. ``mode="clip"`` is a no-op (indices in-bounds by construction)
    that skips ``jnp.take``'s negative-index wraparound, whose
    ``+ size`` Python-int constant overflows the jit argument boundary
    at >= 2^31 elements.
    """
    M, k = embs.shape
    eT = embs.T.astype(jnp.int32)                    # (k, M)
    row = jnp.broadcast_to(eT[:, None, :], (k, k, M)).reshape(k * k, M)
    col = jnp.broadcast_to(eT[None, :, :], (k, k, M)).reshape(k * k, M)

    if weighted:
        if getattr(g, "weight", None) is None:
            raise ValueError("weighted patches need a weighted Graph")
        return g.weight.at[row, col].get(mode="clip").astype(jnp.float32)
    pad = getattr(g, "nbr_pad_T", None)
    # The (D, k, M) slot block must fuse into the compare+any reduction
    # (as at arxiv's D=504 x M=1.2M, 7.3 GB nominal) — but past about a
    # device's memory the compiler stops fusing and buffer assignment
    # fails outright (facebook's D=1045 x M=1.2M, 15 GB nominal), so
    # gate by the nominal block bytes
    # and fall back to the word/triple paths for high-degree graphs at
    # large sample counts.
    if pad is not None and pad.shape[0] * k * M * 4 <= _SLOT_BLOCK_BYTES:
        # padded-row membership (CSR and bitset alike): ONE gather of
        # the (D, k, M) per-NODE slot block + broadcast compare — see
        # the CsrGraph branch below for the layout rules.
        slots = pad.at[:, eT].get(mode="clip")             # (D, k, M)
        hit = slots[:, :, None, :] == eT[None, None, :, :]
        return jnp.any(hit, axis=0).reshape(k * k, M).astype(jnp.float32)
    if isinstance(g, BitsetGraph):
        words = g.bits.at[row, col // 32].get(mode="clip")
        shift = col.astype(jnp.uint32) % 32
        return ((words >> shift) & jnp.uint32(1)).astype(jnp.float32)
    if isinstance(g, CsrGraph):
        if (g.max_deg > _BSEARCH_DEG_THRESHOLD
                or max(g.max_deg, 1) * k * M * 4 > _SLOT_BLOCK_BYTES):
            # skewed-degree / hub-row regime: the (D, k, M) slot block
            # pays max_deg elements per row for every row (28 GB
            # nominal at a 1M-node BA graph's D~2000, M=1.2M — it
            # would not even buffer-assign); binary search pays
            # ~log2(max_deg) elements per PAIR instead. Membership is
            # symmetric (the CSR stores both directions) and the
            # builders drop self-loops (native/graph_loader.cpp:278,
            # _intern_edges), so only the k(k-1)/2 unordered pairs are
            # searched — diagonal entries are A[v, v] = 0 by the
            # simple-graph contract and (q, r) mirrors (r, q). At the
            # k=3 path motif this cuts the dominant reconstruction
            # gather count 3x.
            iu, ju = np.triu_indices(k, 1)            # static, P pairs
            P = len(iu)
            mem = _pair_membership(
                g, eT[jnp.asarray(iu)], eT[jnp.asarray(ju)])   # (P, M)
            pairidx = np.full((k, k), P, np.int32)    # P = the zeros row
            pairidx[iu, ju] = np.arange(P)
            pairidx[ju, iu] = np.arange(P)
            stacked = jnp.concatenate(
                [mem.astype(jnp.float32), jnp.zeros((1, M), jnp.float32)])
            return stacked[jnp.asarray(pairidx.reshape(-1))]  # (k*k, M)
        # CSR-triple fallback (no padded table): membership by
        # candidate-row compare, rows gathered once per motif NODE —
        # (D, k, M), k rows — and every ordered pair (q, r) tests
        # eT[r] against node q's slots by broadcast compare. (The
        # k^2-pair form gathered the same rows per ORDERED PAIR, 3x
        # the elements; values identical.) Slot axis OUTERMOST, sample
        # axis minor — a (.., M, D) layout with D ~ 4 would pad the
        # minor dim to a full 128-wide tile (the blowup this function
        # exists to avoid).
        D = max(g.max_deg, 1)
        d_idx = jnp.arange(D, dtype=jnp.int32)[:, None, None]
        off = g.offsets.at[eT].get(mode="clip")            # (k, M)
        slots = g.nbr_flat.at[off[None] + d_idx].get(mode="clip")
        ok = d_idx < g.deg.at[eT].get(mode="clip")[None]   # (D, k, M)
        hit = ((slots[:, :, None, :] == eT[None, None, :, :])
               & ok[:, :, None, :])                        # (D, k, k, M)
        return jnp.any(hit, axis=0).reshape(k * k, M).astype(jnp.float32)
    return g.adj.at[row, col].get(mode="clip").astype(jnp.float32)


def _uniform_from_mask(key: jax.Array, mask: jax.Array) -> jax.Array:
    """Uniform draw from the True entries of a boolean vector; uniform
    over all indices when the mask is empty (the reference's rejected
    Glauber move fallback, ``:167-172``).

    Implemented as ONE uniform draw + cumsum rank-select (identical law
    to a masked categorical): a Gumbel categorical generates N random
    floats per draw, which at ensemble scale (8192 chains x 65536
    nodes) is ~0.5G threefry evaluations per chain step. Rank
    selection needs no
    per-node randomness at all."""
    c = jnp.cumsum(mask.astype(jnp.int32))
    total = c[-1]
    ku, kf = jax.random.split(key)
    u = jax.random.uniform(ku, ())
    target = jnp.minimum((u * total).astype(jnp.int32) + 1,
                         jnp.maximum(total, 1))
    idx = jnp.argmax(c >= target)
    fallback = jax.random.randint(kf, (), 0, mask.shape[0])
    return jnp.where(total > 0, idx, fallback).astype(jnp.int32)


def _select_uniform_bit(key: jax.Array, words: jax.Array,
                        n: int) -> jax.Array:
    """Uniform draw from the set bits of a packed uint32 bitset row
    (words beyond ``n`` must already be masked off); uniform over
    [0, n) when no bit is set. Packed counterpart of
    :func:`_uniform_from_mask`: popcount + cumsum locate the target
    word, then a 32-lane scan finds the in-word bit — the (n,)-wide
    boolean vector is never materialized."""
    pc = lax.population_count(words).astype(jnp.int32)
    c = jnp.cumsum(pc)
    total = c[-1]
    ku, kf = jax.random.split(key)
    u = jax.random.uniform(ku, ())
    target = jnp.minimum((u * total).astype(jnp.int32) + 1,
                         jnp.maximum(total, 1))
    widx = jnp.argmax(c >= target)
    rank = target - jnp.where(widx > 0, c[jnp.maximum(widx - 1, 0)], 0)
    word = words[widx]
    bits = ((word >> jnp.arange(32, dtype=jnp.uint32)) & 1).astype(jnp.int32)
    bpos = jnp.argmax(jnp.cumsum(bits) >= rank)
    fallback = jax.random.randint(kf, (), 0, n)
    return jnp.where(total > 0, widx * 32 + bpos, fallback).astype(jnp.int32)


def tree_sample(key: jax.Array, parents: tuple[int, ...], g,
                x: jax.Array) -> jax.Array:
    """Grow a motif embedding from pivot x by sampling, for each node in
    depth-first order, a uniform neighbor of its parent's image
    (``tree_sample``, ``network_reconstruction_nx.py:108-134``)."""
    k = len(parents) + 1
    emb = jnp.zeros((k,), jnp.int32).at[0].set(jnp.asarray(x, jnp.int32))
    keys = jax.random.split(key, max(k - 1, 1))
    for i in range(1, k):
        if parents[i - 1] < 0:
            # parentless motif node: uniform over all nodes (reference
            # edgeless branch, network_reconstruction_nx.py:119-122)
            y = jax.random.randint(keys[i - 1], (), 0, g.num_nodes)
        else:
            y = _uniform_neighbor(keys[i - 1], g, emb[parents[i - 1]])
        emb = emb.at[i].set(jnp.asarray(y, jnp.int32))
    return emb


def rw_update(key: jax.Array, g, x: jax.Array) -> jax.Array:
    """MH random walk step with uniform stationary distribution:
    propose a uniform neighbor y, accept w.p. min(1, deg x / deg y)
    (``RW_update``, ``network_reconstruction_nx.py:175-199``); isolated
    x jumps to a uniform node."""
    kn, ku, kj = jax.random.split(key, 3)
    y = _uniform_neighbor(kn, g, x)
    accept = (jax.random.uniform(ku, ())
              < g.deg[x].astype(jnp.float32)
              / jnp.maximum(g.deg[y], 1).astype(jnp.float32))
    y = jnp.where(accept, y, x)
    jump = jax.random.randint(kj, (), 0, g.num_nodes)
    return jnp.where(g.deg[x] > 0, y, jump).astype(jnp.int32)


def _motif_neighbor_table(B: np.ndarray) -> np.ndarray:
    """Static (k, max_deg) table of each motif node's neighbors in the
    symmetrized motif, padded with -1. Lets the Glauber move gather only
    the <= max_deg constraining adjacency rows instead of all k (for a
    path motif max_deg = 2 regardless of arm length — a 10x row-gather
    cut on the reference main()'s 21-node motif)."""
    Bsym = np.asarray((np.asarray(B) + np.asarray(B).T) > 0)
    k = Bsym.shape[0]
    deg = Bsym.sum(axis=1).astype(int)
    tbl = np.full((k, max(int(deg.max()), 1)), -1, np.int32)
    for i in range(k):
        js = np.flatnonzero(Bsym[i])
        tbl[i, :len(js)] = js
    return tbl


def glauber_update(key: jax.Array, B: np.ndarray, parents: tuple[int, ...],
                   g: Graph, emb: jax.Array) -> jax.Array:
    """One Glauber move: pick a uniform motif node j and resample its
    image uniformly from the common neighbors of the images of j's motif
    neighbors (``glauber_gen_update``,
    ``network_reconstruction_nx.py:136-173``).

    Ensemble-scale design (docs/DESIGN.md §4): only the images of j's
    motif NEIGHBORS constrain the draw, so exactly ``max_deg`` adjacency
    rows are gathered (static table, padding rows read row 0 and are
    masked to all-True); for a :class:`BitsetGraph` the common-neighbor
    intersection is computed on the PACKED words (bitwise AND +
    popcount) and the winner located by rank-select — the (N,)-wide
    boolean row per chain is never materialized, and no per-node random
    bits are drawn."""
    k = emb.shape[0]
    if k == 1:
        # single-node motif behaves as the MH walk (reference :144-153)
        return emb.at[0].set(rw_update(key, g, emb[0]))
    kj, ks = jax.random.split(key)
    j = jax.random.randint(kj, (), 0, k)
    tbl = jnp.asarray(_motif_neighbor_table(B))      # (k, max_deg) static
    sel_idx = tbl[j]                                  # (max_deg,)
    valid = sel_idx >= 0
    imgs = emb[jnp.maximum(sel_idx, 0)]               # images of constraints
    use_candidates = valid.shape[0] > 0 and (
        isinstance(g, CsrGraph)
        or (isinstance(g, BitsetGraph)
            and 0 < g.max_deg * _CANDIDATE_DEG_FACTOR <= g.words_per_row))
    if (valid.shape[0] > 0 and isinstance(g, CsrGraph)
            and g.max_deg > _BSEARCH_DEG_THRESHOLD):
        # sorted-multiplicity intersection for the hub-row regime.
        # Gathers cost per ELEMENT, so the per-candidate binary search
        # below (log2(max_deg) * max_deg gathered elements per
        # constraint per chain step) dominates training on power-law
        # graphs — hub rows are not rare visits there, the
        # chain's stationary law WEIGHTS nodes by homomorphism count.
        # Instead gather every constraint row once (slots * max_deg
        # elements), sentinel-fill the dead slots, and sort the values:
        # a node is a common neighbor of all m valid constraint images
        # exactly when its value run has length m (each row lists a
        # value at most once, inactive rows contribute only distinct
        # sentinels, so run length counts constraint membership). The
        # sort is ascending, so rank-selecting the target-th run start
        # picks the same VALUE as the candidate-list cumsum below —
        # identical draws (tested hub-vs-dense), ~14x fewer gathered
        # elements.
        n = g.num_nodes
        S = valid.shape[0]
        D = max(int(g.max_deg), 1)
        rows, oks = _csr_row_slots(g, imgs)           # (S, D)
        live = valid[:, None] & oks
        sent = jnp.int32(n) + jnp.arange(S * D, dtype=jnp.int32)
        v = jnp.where(live.reshape(-1), rows.reshape(-1), sent)
        sv = jnp.sort(v)                              # (S*D,) ascending
        m = jnp.sum(valid.astype(jnp.int32))          # required run length
        runstart = jnp.concatenate(
            [jnp.ones((1,), bool), sv[1:] != sv[:-1]])
        # ge after round r holds "run length >= r+1" at run starts;
        # multiplicity cannot exceed m, so "length >= m" is "length == m"
        tail = jnp.int32(n) + jnp.int32(S * D)        # > every sentinel
        ge = runstart
        member = ge
        for r in range(1, S):
            shifted = jnp.concatenate(
                [sv[r:], jnp.full((r,), tail, sv.dtype)])
            ge = ge & (shifted == sv)
            member = jnp.where(m >= r + 1, ge, member)
        member = member & (sv < n) & (m > 0)
        c = jnp.cumsum(member.astype(jnp.int32))
        total = c[-1]
        ku, kf = jax.random.split(ks)
        u = jax.random.uniform(ku, ())
        target = jnp.minimum((u * total).astype(jnp.int32) + 1,
                             jnp.maximum(total, 1))
        y = sv[jnp.argmax(c >= target)]
        y = jnp.where(total > 0, y, jax.random.randint(kf, (), 0, n))
    elif use_candidates:
        # candidate-list intersection for LOW-DEGREE graphs: the common
        # neighbors of the constraint images are a subset of the FIRST
        # valid constraint's neighbor list, so enumerate its <= max_deg
        # CSR candidates and test each against the other constraints —
        # single-word bitset lookups for a BitsetGraph, CSR row
        # compares for a CsrGraph — O(max_deg) work per chain step
        # instead of O(N/32) packed words. At the 512^2 torus (degree
        # 4, 8192 words/row) this is the difference between the chain
        # scan dominating the reconstruction and vanishing from it.
        # CSR rows are ascending (data/graphs.py lexsort), so the
        # rank-select draw picks the same element as the packed/dense
        # kernels for the same key — identical draws, tested.
        n = g.num_nodes
        first = jnp.argmax(valid)                     # first valid slot
        c0 = imgs[first]
        cand, ok = _csr_row_slots(g, c0)              # (D,), (D,)
        for t in range(valid.shape[0]):               # static, tiny
            active = valid[t] & (jnp.int32(t) != first)
            if isinstance(g, BitsetGraph):
                word = g.bits.at[imgs[t], cand // 32].get(mode="clip")
                member = ((word >> cand.astype(jnp.uint32) % 32)
                          & jnp.uint32(1)) > 0
            else:
                rowt, okt = _csr_row_slots(g, imgs[t])    # (D,)
                member = jnp.any(
                    (rowt[None, :] == cand[:, None]) & okt[None, :], axis=1)
            ok = ok & (member | ~active)
        # no valid constraint at all (edgeless motif): empty candidate
        # set -> the fallback's uniform-over-[0, n) draw, matching the
        # reference's unconstrained resample
        ok = ok & jnp.any(valid)
        c = jnp.cumsum(ok.astype(jnp.int32))
        total = c[-1]
        ku, kf = jax.random.split(ks)
        u = jax.random.uniform(ku, ())
        target = jnp.minimum((u * total).astype(jnp.int32) + 1,
                             jnp.maximum(total, 1))
        y = cand[jnp.argmax(c >= target)]
        y = jnp.where(total > 0, y, jax.random.randint(kf, (), 0, n))
    elif isinstance(g, BitsetGraph):
        n = g.num_nodes
        words = _bitset_rows(g, imgs)                 # (max_deg, W32)
        # padding rows impose no constraint: all-ones
        words = jnp.where(valid[:, None], words, jnp.uint32(0xFFFFFFFF))
        cmn = words[0]
        for t in range(1, words.shape[0]):            # static, max_deg tiny
            cmn = cmn & words[t]
        # mask tail bits beyond n (static per-word mask)
        W32 = g.words_per_row
        word_mask = np.zeros(W32, np.uint32)
        word_mask[:n // 32] = 0xFFFFFFFF
        if n % 32:
            word_mask[n // 32] = (1 << (n % 32)) - 1
        cmn = cmn & jnp.asarray(word_mask)
        y = _select_uniform_bit(ks, cmn, n)
    else:
        rows = g.adj[imgs]                            # (max_deg, N)
        rows = jnp.logical_or(rows, jnp.logical_not(valid)[:, None])
        cmn = jnp.all(rows, axis=0)
        y = _uniform_from_mask(ks, cmn)
    return emb.at[j].set(y.astype(jnp.int32))


def pivot_update(key: jax.Array, B: np.ndarray, parents: tuple[int, ...],
                 g: Graph, emb: jax.Array) -> jax.Array:
    """Pivot move: MH-walk the root, then re-grow the whole tree
    (``Pivot_update``, ``network_reconstruction_nx.py:265-278``)."""
    kw, kt = jax.random.split(key)
    x0 = rw_update(kw, g, emb[0])
    return tree_sample(kt, parents, g, x0)


def patch_from_embedding(g: Graph, emb: jax.Array, *,
                         weighted: bool = False) -> jax.Array:
    """k x k induced adjacency (or weight) patch of an embedding
    (``chd_gen_mx``, ``network_reconstruction_nx.py:301-305``)."""
    if weighted:
        if getattr(g, "weight", None) is None:
            raise ValueError("weighted patches need a weighted Graph")
        return g.weight[emb[:, None], emb[None, :]].astype(jnp.float32)
    return _pair_matrix(g, emb)


@functools.partial(
    jax.jit,
    static_argnames=("B_bytes", "parents", "num", "use_glauber", "weighted"),
)
def _sample_patches(key, g, emb0, B_bytes, parents, num, use_glauber, weighted):
    B = np.frombuffer(B_bytes, dtype=np.int8).reshape(emb0.shape[0], -1)

    def step(emb, k):
        if use_glauber:
            emb = glauber_update(k, B, parents, g, emb)
        else:
            emb = pivot_update(k, B, parents, g, emb)
        patch = patch_from_embedding(g, emb, weighted=weighted)
        return emb, patch.reshape(-1)

    keys = jax.random.split(key, num)
    emb, patches = lax.scan(step, emb0, keys)
    return patches.T, emb  # (k*k, num), final embedding


def sample_patches(key: jax.Array, g: Graph, emb0: jax.Array, B: np.ndarray,
                   num: int, *, use_glauber: bool = True,
                   weighted: bool = False):
    """Run one chain for ``num`` steps emitting a patch per step —
    the reference's ``get_patches_glauber``
    (``network_reconstruction_nx.py:315-329``, each step advancing the
    chain by one move as ``chd_gen_mx(iterations=1)`` does).

    Returns ``(X, emb)`` with X of shape (k^2, num).
    """
    parents = tree_parents(B)
    B_bytes = np.asarray(B, np.int8).tobytes()
    return _sample_patches(key, g, emb0, B_bytes, parents, int(num),
                           bool(use_glauber), bool(weighted))


def _sample_patches_ensemble_impl(key, g, emb0s, B_bytes, parents, per,
                                  use_glauber, weighted):
    """Shared ensemble body: (C, k) embeddings, per steps each ->
    ((k^2, C*per) patches, (C, k) final embeddings)."""
    chains = emb0s.shape[0]
    Xs, embs = jax.vmap(
        lambda kk, e: _sample_patches(kk, g, e, B_bytes, parents, int(per),
                                      bool(use_glauber), bool(weighted))
    )(jax.random.split(key, chains), emb0s)
    k2 = Xs.shape[1]
    return jnp.moveaxis(Xs, 1, 0).reshape(k2, -1), embs


def sample_patches_ensemble(key: jax.Array, g: Graph, emb0: jax.Array,
                            B: np.ndarray, num: int, *,
                            use_glauber: bool = True,
                            weighted: bool = False):
    """Vmapped chain ensemble: ``emb0`` is (C, k); returns
    ``(X, embs)`` with X of shape (k^2, C*num) — C chains advanced
    ``num`` steps each. The parallel replacement for one long chain."""
    parents = tree_parents(B)
    B_bytes = np.asarray(B, np.int8).tobytes()
    return _sample_patches_ensemble_impl(key, g, emb0, B_bytes, parents,
                                         num, use_glauber, weighted)
