"""Device-resident graph representation for network dictionary learning.

The reference keeps a ``networkx.Graph`` and does per-node Python set
intersections (``/root/reference/network_reconstruction_nx.py:50-54,
136-173``). Here a graph is a pytree of fixed-shape device arrays:

- ``adj``  — (N, N) dense boolean adjacency (the common-neighbor
  intersections of the Glauber kernel become row-wise ANDs);
- ``weight`` — (N, N) float edge weights (binary graphs: 0/1; WAN
  matrices keep their normalized weights);
- ``nbr``  — (N, max_deg) padded neighbor table for O(1) uniform
  neighbor draws;
- ``deg``  — (N,) degrees;
- ``node_ids`` — host-side mapping from array index to original node
  label (networkx orders nodes by first appearance in the edge list; we
  preserve that so reconstructions map back to the same labels,
  mirroring ``np2nx``/``nx2np`` at ``:74-84``).

Dense (N, N) storage is the right trade for the reference's graphs
(torus 100, WAN 211, facebook ~4k, arxiv ~5k nodes); a blocked/bitset
variant is the documented scaling path beyond ~30k nodes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["Graph", "BitsetGraph", "CsrGraph", "graph_from_edgelist",
           "graph_from_adjacency", "load_edgelist",
           "load_edgelist_dense", "load_edgelist_csr",
           "bitset_graph_from_edges", "load_edgelist_bitset",
           "csr_graph_from_edges"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    adj: jax.Array      # (N, N) bool
    weight: jax.Array | None   # (N, N) float32, or None for binary graphs
                               # (avoids shipping a dense f32 copy of adj)
    nbr: jax.Array      # (N, max_deg) int32, padded with 0
    deg: jax.Array      # (N,) int32
    # static metadata: original node labels by array index (hashable
    # tuple so jitted functions taking a Graph can cache on it)
    node_ids: tuple = dataclasses.field(
        metadata=dict(static=True), default=())

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_edges(self) -> int:
        return int(np.asarray(self.deg).sum()) // 2


def _build(adj_np: np.ndarray, weight_np, node_ids) -> Graph:
    n = adj_np.shape[0]
    deg = adj_np.sum(axis=1).astype(np.int32)
    max_deg = max(int(deg.max()), 1)
    nbr = np.zeros((n, max_deg), np.int32)
    for i in range(n):
        nz = np.flatnonzero(adj_np[i])
        nbr[i, : len(nz)] = nz
    return Graph(
        adj=jnp.asarray(adj_np, jnp.bool_),
        weight=(None if weight_np is None
                else jnp.asarray(weight_np, jnp.float32)),
        nbr=jnp.asarray(nbr),
        deg=jnp.asarray(deg),
        node_ids=tuple(int(v) for v in np.asarray(node_ids)),
    )


def graph_from_edgelist(edges, num_nodes: int | None = None) -> Graph:
    """Build a simple undirected graph from an (E, 2) edge array.

    Node labels may be arbitrary ints; indices are assigned by first
    appearance (networkx ``Graph(edgelist)`` ordering, matching the
    reference ingest at ``network_reconstruction_nx.py:50-54``).
    ``num_nodes`` may only pad with extra isolated nodes (labeled by
    their index); fewer nodes than distinct labels is an error.
    """
    e, node_ids = _intern_edges(edges)
    n = len(node_ids) if num_nodes is None else int(num_nodes)
    if n < len(node_ids):
        raise ValueError(
            f"num_nodes={n} < {len(node_ids)} distinct labels")
    if n > len(node_ids):
        node_ids = np.concatenate(
            [node_ids, np.arange(len(node_ids), n, dtype=np.int64)])
    adj = np.zeros((n, n), bool)
    adj[e[:, 0], e[:, 1]] = True
    adj[e[:, 1], e[:, 0]] = True
    return _build(adj, None, node_ids)


def graph_from_adjacency(A, *, normalize: bool = False) -> Graph:
    """Build a graph from a (weighted) adjacency matrix.

    ``normalize=True`` divides by the max (the WAN convention,
    ``network_reconstruction_nx.py:64-67``). Binary structure is
    ``A > 0``; weights are kept for weighted-patch extraction.

    Weight convention for directed inputs (explicit, matching the
    reference's direct ``A[i, j]`` reads): structure is symmetrized
    (``adj | adj.T``), and the weight of pair (i, j) is ``A[i, j]`` when
    that direction is present, else backfilled from ``A[j, i]``. When
    both directions carry different weights, each orientation keeps its
    own value — weighted patches are orientation-dependent exactly as in
    the reference, which indexes the raw matrix.
    """
    A = np.array(A, np.float64)          # copy: never mutate the caller
    if normalize and A.max() > 0:
        A = A / A.max()
    np.fill_diagonal(A, 0.0)
    adj = A > 0
    adj = adj | adj.T
    W = np.where(A > 0, A, A.T)
    return _build(adj, W.astype(np.float32), np.arange(A.shape[0]))


def load_edgelist(path: str, delimiter: str = ",",
                  use_native: str = "auto") -> Graph:
    """Read a comma-delimited integer edge list file
    (``network_reconstruction_nx.py:50-54``).

    ``use_native="auto"`` parses with the C++ loader
    (``native/graph_loader.cpp``) when it builds on this host — the
    first-appearance node ordering and table layout are identical to the
    Python path (tested) — and falls back to Python otherwise.
    """
    if use_native in ("auto", "always"):
        try:
            from onmf_ontf_ndl_tpu.data.native import load_edgelist_native

            adj, nbr, deg, node_ids = load_edgelist_native(path)
            return Graph(
                adj=jnp.asarray(adj),
                weight=None,
                nbr=jnp.asarray(nbr),
                deg=jnp.asarray(deg),
                node_ids=tuple(int(v) for v in node_ids),
            )
        except Exception:
            if use_native == "always":
                raise
    return graph_from_edgelist(_parse_edge_file(path, delimiter))


def _parse_edge_file(path: str, delimiter: str = ",") -> np.ndarray:
    """Permissive integer edge-list file parse shared by the loaders:
    tries ``delimiter`` then whitespace (SNAP-style files), demanding an
    integral (E, 2) table either way."""
    def _try(delim):
        """Parse as float (NaN marks unparseable tokens), demand an
        integral (E, 2) table; None on any failure."""
        try:
            e = np.genfromtxt(path, delimiter=delim, dtype=np.float64,
                              comments="#")
        except Exception:
            return None
        if e.ndim == 1:
            if e.size % 2:
                return None
            e = e.reshape(-1, 2)
        if e.ndim != 2 or (e.size and e.shape[1] != 2):
            return None
        if e.size and (np.isnan(e).any() or (e != np.round(e)).any()):
            return None
        return e.astype(np.int64)

    def _ok(e):
        return e is not None

    # the native parser accepts comma/space/tab; keep the Python
    # fallback equally permissive so "auto" behaves the same with or
    # without a C++ toolchain (SNAP-style space-delimited files)
    edges = _try(delimiter)
    if not _ok(edges):
        ws = _try(None)            # whitespace-delimited
        if _ok(ws):
            edges = ws
    if edges is None:
        raise ValueError(f"could not parse edge list {path!r}")
    return edges


def load_edgelist_csr(path: str, delimiter: str = ",",
                      use_native: str = "auto",
                      cache_dir: str | None = None) -> CsrGraph:
    """Edge-list file -> :class:`CsrGraph` (the O(E) million-node
    representation), through the C++ builder when available and the
    optional built-CSR npz cache."""
    return csr_graph_from_edges(_parse_edge_file(path, delimiter),
                                use_native=use_native,
                                cache_dir=cache_dir)


def load_edgelist_dense(path: str, delimiter: str = ",") -> np.ndarray:
    """Edge-list file -> dense (N, N) 0/1 adjacency ndarray — the
    reference's ``read_networks`` (``network_reconstruction_nx.py:56-62``,
    dead code there: nothing calls it). Node order is first appearance
    in the file, matching ``nx.read_edgelist`` + ``nx.to_numpy_matrix``
    insertion order and this module's interning invariant. One
    deviation: self-loop lines are DROPPED by the shared edge interning
    (every graph type here is simple), whereas ``nx.to_numpy_matrix``
    would keep a self-loop as a nonzero diagonal entry — moot for the
    reference's own use (its function is dead code and its datasets are
    simple graphs), but a diagonal difference if you feed a loopy edge
    list. Built
    entirely on host — the result is an ndarray nothing on the device
    needs, so copying an N^2 adjacency to the device and back (as
    building a :class:`Graph` first would) is pure waste."""
    e, node_ids = _intern_edges(_parse_edge_file(path, delimiter))
    n = len(node_ids)
    a = np.zeros((n, n), np.float64)
    a[e[:, 0], e[:, 1]] = 1.0
    a[e[:, 1], e[:, 0]] = 1.0
    return a


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BitsetGraph:
    """Bit-packed graph for beyond-dense-adjacency scale (N^2/8 bytes of
    adjacency instead of N^2; CSR neighbor storage instead of a padded
    table). The documented scaling path past ~30k nodes — same sampler
    semantics as :class:`Graph` via the dispatch helpers in
    ``samplers/motif.py``. Binary graphs only (no edge weights)."""

    # CANONICAL adjacency storage is the 2-D (N, ceil(N/32)) packed-row
    # array. Device consumers gather whole rows
    # (``samplers/motif.py::_bitset_rows``) or words by per-dimension
    # (row, word) index pairs — never through a flattened view or a
    # linear index. Rationale:
    #  * row gathers from the 2-D operand are one gather op; vmapped
    #    ``dynamic_slice`` from a flat array is many unaligned slices;
    #  * an on-device ``reshape(-1)`` of the 2-D array is a full
    #    relayout copy (8 GB at the 512^2-torus scale), so no consumer
    #    may flatten it inside jit;
    #  * per-dimension indices each stay < N, so int32 index arithmetic
    #    never overflows where a LINEAR index wraps past 2^31 elements
    #    (the 512^2 bitset is exactly 2^31 words; a dense adjacency
    #    wraps at 46,341 nodes). Gathers use ``mode="clip"`` — in-bounds
    #    by construction; it also skips ``jnp.take``'s negative-index
    #    wraparound, whose ``+ size`` constant is a Python int >= 2^31
    #    at that scale and overflows at the jit argument boundary.
    bits: jax.Array      # (N, ceil(N/32)) uint32 packed adjacency rows
    nbr_flat: jax.Array  # (2E,) int32 CSR neighbors, ascending per row
    offsets: jax.Array   # (N,) int32 CSR row starts
    deg: jax.Array       # (N,) int32
    node_ids: tuple = dataclasses.field(
        metadata=dict(static=True), default=())
    # static max degree: lets samplers choose candidate-list kernels
    # with a (max_deg,)-shaped slot axis (samplers/motif.py)
    max_deg: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    # optional padded-row fast path — see CsrGraph.nbr_pad_T
    nbr_pad_T: jax.Array | None = None

    @property
    def num_nodes(self) -> int:
        return self.bits.shape[0]

    @property
    def words_per_row(self) -> int:
        return self.bits.shape[1]

    @property
    def num_edges(self) -> int:
        return int(np.asarray(self.deg).sum()) // 2

    # no weights for the bitset representation
    weight = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """Pure-CSR graph: O(E) memory, no packed adjacency at all. The
    scaling representation for LOW-DEGREE graphs past the bitset's
    N^2/32-word memory ceiling (262,144 nodes take 8.6 GB): a
    million-node degree-4 torus costs ~16 MB. Every adjacency query
    enumerates a node's ascending CSR row and compares — O(max_deg)
    work — so the samplers dispatch to their candidate-list kernels
    (``samplers/motif.py``), which for low degree are also the fastest
    kernels. High-degree graphs should prefer :class:`BitsetGraph` (the
    candidate Glauber move is O(max_deg^2) per step here and there is
    no packed fallback). Binary graphs only; same sampler semantics and
    draw-for-draw identical chains as the other representations
    (ascending rank-select order, tested)."""

    nbr_flat: jax.Array  # (2E,) int32 CSR neighbors, ascending per row
    offsets: jax.Array   # (N,) int32 CSR row starts
    deg: jax.Array       # (N,) int32
    node_ids: tuple = dataclasses.field(
        metadata=dict(static=True), default=())
    max_deg: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    # Optional padded-row fast path: (max_deg, N) int32, column u =
    # u's ascending neighbors, padded with N (matches no real node).
    # One gather replaces the (offsets, deg, nbr_flat) triple and the
    # validity mask — a gather costs per gathered element, and
    # adjacency queries drop from
    # 2 + max_deg to max_deg elements per row. Stored TRANSPOSED so
    # batched gathers land (D, ..., M) with the sample axis minor
    # (pair_matrices_T layout rule). Built when the padded table is
    # small (low-degree graphs — the CsrGraph regime); None otherwise.
    nbr_pad_T: jax.Array | None = None

    @property
    def num_nodes(self) -> int:
        return self.offsets.shape[0]

    @property
    def num_edges(self) -> int:
        return self.nbr_flat.shape[0] // 2

    # no weights for the CSR representation
    weight = None


def _normalize_edges(edges) -> np.ndarray:
    """Shared (E, 2) int64 validation/normalization for every builder."""
    edges = np.asarray(edges, dtype=np.int64)
    if edges.ndim == 1:
        if edges.size % 2:
            raise ValueError("flat edge array must have even length")
        edges = edges.reshape(-1, 2)
    if edges.ndim != 2 or (edges.size and edges.shape[1] != 2):
        raise ValueError(
            f"edge list must be (E, 2) node pairs, got shape "
            f"{edges.shape} (weighted multi-column edge files are not "
            f"supported — pass the first two columns)")
    return edges


def _intern_edges(edges):
    """First-appearance node interning (the shared load-bearing ordering
    invariant for both graph representations); returns deduped,
    self-loop-free (E, 2) index pairs plus node_ids."""
    edges = _normalize_edges(edges)
    # vectorized first-appearance interning over the interleaved
    # [a0, b0, a1, b1, ...] label stream (identical ordering to the
    # obvious dict loop, which costs seconds at half-million-edge
    # scale). pandas.factorize IS hash-based first-appearance interning
    # (verified equal to the sort-based path, including arbitrary and
    # negative labels) and runs ~2x faster at the 75M-label scale of
    # the 9.4M-node flagship; the numpy path is the fallback.
    flat = edges.reshape(-1)
    try:
        import pandas as pd

        codes, node_ids = pd.factorize(flat, sort=False)
        e = codes.reshape(-1, 2)
    except ImportError:
        uniq, first_idx = np.unique(flat, return_index=True)
        appearance = np.argsort(first_idx, kind="stable")
        node_ids = uniq[appearance]
        index_of_sorted = np.empty(len(uniq), np.int64)
        index_of_sorted[appearance] = np.arange(len(uniq))
        e = index_of_sorted[np.searchsorted(uniq, flat)].reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    # packed-key dedup: identical output order to the structured
    # ``np.unique(axis=0)`` (both sort by (lo, hi)) but much faster —
    # the structured unique sorts void-dtype rows. lo*n+hi fits int64
    # for any graph whose ids fit the int32 CSR arrays (n < 2^31).
    n = np.int64(len(node_ids))
    key = np.unique(lo * n + hi)
    e = np.stack([key // n, key % n], axis=1) if len(node_ids) else e[:0]
    return e, node_ids


def _csr_arrays(e, n):
    """Shared CSR prep from deduped (E, 2) undirected pairs: directed
    both ways, then lexsorted by (src, dst) so each row lists its
    neighbors ASCENDING — the same index order as the packed bitset and
    the dense nbr table, which makes rank-select draws agree bit for
    bit across representations."""
    # packed-key sort: one int64 sort replaces the two-key lexsort +
    # two gathers (28 s -> ~3 s at 38M directed pairs on this host);
    # identical (src, dst) order — src*n+dst sorts by src then dst, and
    # the keys are unique so the permutation is fully determined
    nn = np.int64(max(n, 1))
    key = np.concatenate([e[:, 0] * nn + e[:, 1], e[:, 1] * nn + e[:, 0]])
    key.sort()
    src, dst = key // nn, key % nn
    deg = np.bincount(src, minlength=n).astype(np.int32)
    # [:n] so an EMPTY graph gets (0,) offsets like everything else
    # (the concatenate otherwise leaves a phantom [0] row at n=0)
    offsets = np.concatenate([[0], np.cumsum(deg)[:-1]])[:n].astype(np.int32)
    return src, dst, deg, offsets


def _host_csr_build(edges, use_native: str = "auto"):
    """Host-side CSR build shared by the CSR and bitset builders:
    intern + dedup + per-row-ascending CSR. ``use_native="auto"`` runs
    the C++ builder (``native/graph_loader.cpp::gl_csr_from_edges``)
    when it builds on this host — identical arrays to the NumPy
    packed-key path (tested; ~3x faster at the 9.4M-node flagship on
    this 1-core host, the load-wall fix) — and falls back to NumPy
    otherwise. Returns ``(dst_i32, offsets, deg, node_ids, max_deg)``;
    the directed ``src`` array is recoverable as
    ``np.repeat(np.arange(n), deg)`` (CSR rows are contiguous)."""
    edges = _normalize_edges(edges)
    if use_native in ("auto", "always"):
        try:
            from onmf_ontf_ndl_tpu.data.native import csr_from_edges_native

            dst, offsets, deg, node_ids, max_deg = \
                csr_from_edges_native(edges)
            return dst, offsets, deg, node_ids, max_deg
        except Exception:
            if use_native == "always":
                raise
    e, node_ids = _intern_edges(edges)
    n = len(node_ids)
    _, dst, deg, offsets = _csr_arrays(e, n)
    max_deg = int(deg.max()) if n else 0
    return dst.astype(np.int32), offsets, deg, np.asarray(node_ids), max_deg


# padded-table budget: (max_deg, N) int32 — for near-regular low-degree
# graphs this is ~the CSR arrays' own size; for skewed degree
# distributions it can blow up N*max_deg-fold, so it is gated by bytes
# and the gather paths fall back to the CSR triple when absent
_PAD_TABLE_BYTES = 256 << 20

# Host-side CSR retention: the reconstruction's edge fetch can ship a
# ~bits-per-edge MASK over the graph's CSR slots instead of explicit
# (i, j) pairs (30-50x fewer bytes copied to the host), but
# decoding slot indices back to node pairs needs the offsets/dst arrays
# ON THE HOST. The graph pytrees carry device arrays only (a host copy
# as a pytree leaf would re-upload on every jit call; as static
# metadata it would break hashing), so the builders park the host
# arrays here, keyed weakly by the graph object — graphs that cross a
# jit boundary (fresh unflattened objects) simply miss the cache and
# take the explicit-pair fetch path.
import weakref

# keyed by id(g) with a weakref finalizer (the graph dataclasses hash
# their jax-array fields, so they are unhashable — a WeakKeyDictionary
# cannot hold them)
_HOST_CSR: dict = {}


def register_host_csr(g, offsets: np.ndarray, dst: np.ndarray) -> None:
    gid = id(g)

    def _drop(_ref, gid=gid):
        _HOST_CSR.pop(gid, None)

    try:
        ref = weakref.ref(g, _drop)
    except TypeError:        # object does not support weakrefs
        return
    _HOST_CSR[gid] = (ref, np.asarray(offsets), np.asarray(dst))


def host_csr(g):
    """(offsets, dst) host copies for a builder-constructed graph, or
    None when unavailable (e.g. the object was rebuilt by a jit)."""
    ent = _HOST_CSR.get(id(g))
    if ent is None or ent[0]() is not g:
        return None
    return ent[1], ent[2]
# above this size, build the pad table on device from the CSR arrays
# instead of assembling + shipping it from host RAM (the one-off
# scatter compile loses below it — same trade as _DEVICE_BUILD_BYTES)
_PAD_DEVICE_BUILD_BYTES = 64 << 20


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _scatter_pad_table(max_deg, n, e2, dst, offsets):
    # src recovered on device from the offsets (CSR rows are
    # contiguous), so only arrays the graph ships anyway are needed
    src = jnp.searchsorted(offsets, jnp.arange(e2, dtype=jnp.int32),
                           side="right").astype(jnp.int32) - 1
    pos = jnp.arange(e2, dtype=jnp.int32) - offsets[src]
    return jnp.full((max_deg, n), n, jnp.int32).at[pos, src].set(dst)


def _build_nbr_pad_T(src, dst, deg, offsets, n, max_deg,
                     dst_dev=None, offsets_dev=None):
    """(max_deg, N) int32 padded neighbor table (pad value N), ascending
    per column — same neighbor order as the CSR rows. Large tables are
    built ON DEVICE from the (2E,) CSR arrays (one fused full+scatter
    program — same rationale as the bitset device build above: never
    allocate the big array in host RAM or ship it over the link).
    ``dst_dev``/``offsets_dev`` are the graph's own already-shipped
    device copies — passing them avoids a second ~16E-byte transfer.
    ``src=None`` recovers the directed sources from (offsets, deg) when
    the host branch needs them (the native CSR builder does not
    materialize src)."""
    D = max(max_deg, 1)
    if D * n * 4 >= _PAD_DEVICE_BUILD_BYTES and len(dst):
        return _scatter_pad_table(
            D, n, len(dst),
            jnp.asarray(dst.astype(np.int32)) if dst_dev is None
            else dst_dev,
            jnp.asarray(offsets) if offsets_dev is None else offsets_dev)
    if src is None:
        src = np.repeat(np.arange(n, dtype=np.int64), deg)
    tbl = np.full((D, n), n, np.int32)
    pos = np.arange(len(dst), dtype=np.int64) - offsets.astype(np.int64)[src]
    tbl[pos, src] = dst
    return jnp.asarray(tbl)


# Bump when the cached-CSR array contract changes (dtype, ordering, new
# field): the version is folded into the cache key so old files are
# simply missed, never silently reused with a stale schema.
_CSR_CACHE_VERSION = 1


def _csr_cache_key(edges: np.ndarray) -> str:
    import hashlib

    h = hashlib.sha256()
    h.update(f"v{_CSR_CACHE_VERSION}:".encode())
    h.update(np.ascontiguousarray(edges, np.int64).tobytes())
    return h.hexdigest()[:24]


def csr_graph_from_edges(edges, *, use_native: str = "auto",
                         cache_dir: str | None = None) -> CsrGraph:
    """Build a :class:`CsrGraph` from an (E, 2) edge array — O(E) host
    work and O(E) device memory; the loader for million-node low-degree
    graphs.

    ``use_native``: "auto" (default) builds the CSR with the C++
    builder when available (identical arrays, tested), "never" forces
    the NumPy path, "always" errors if the native library is missing.
    ``cache_dir``: directory for a built-CSR npz cache keyed by the
    content hash of the edge array — a rerun skips the whole host
    build (intern/dedup/sort) and pays only the device ship."""
    edges = _normalize_edges(edges)
    cache_path = None
    if cache_dir is not None:
        import os

        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(
            cache_dir, f"csr_{_csr_cache_key(edges)}.npz")
        dst = None
        if os.path.exists(cache_path):
            # a killed run can leave a truncated npz behind — treat any
            # unreadable cache file as a miss and rebuild over it
            try:
                z = np.load(cache_path)
                dst, offsets, deg, node_ids = (z["dst"], z["offsets"],
                                               z["deg"], z["node_ids"])
                max_deg = int(z["max_deg"])
            except Exception:
                dst = None
        if dst is None:
            dst, offsets, deg, node_ids, max_deg = _host_csr_build(
                edges, use_native)
            # write-to-temp + atomic rename so a kill mid-save never
            # leaves a half-written file under the final name (.npz
            # suffix keeps np.savez from appending its own)
            tmp_path = cache_path + f".{os.getpid()}.tmp.npz"
            np.savez(tmp_path, dst=dst, offsets=offsets, deg=deg,
                     node_ids=node_ids, max_deg=max_deg)
            os.replace(tmp_path, cache_path)
    else:
        dst, offsets, deg, node_ids, max_deg = _host_csr_build(
            edges, use_native)
    n = len(node_ids)
    nbr_dev = jnp.asarray(dst)
    off_dev = jnp.asarray(offsets)
    pad = None
    if n and 0 < max_deg * n * 4 <= _PAD_TABLE_BYTES:
        pad = _build_nbr_pad_T(None, dst, deg, offsets, n, max_deg,
                               dst_dev=nbr_dev, offsets_dev=off_dev)
    g = CsrGraph(
        nbr_flat=nbr_dev,
        offsets=off_dev,
        deg=jnp.asarray(deg),
        node_ids=tuple(int(v) for v in node_ids),
        max_deg=max_deg,
        nbr_pad_T=pad,
    )
    register_host_csr(g, offsets, dst)
    return g


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _scatter_bits(n, words, e2, dst, offsets):
    # rows recovered on device from the CSR offsets (contiguous rows),
    # word columns and bit values from dst — so the build ships ONLY the
    # (2E,) nbr_flat + (N,) offsets arrays the graph needs anyway,
    # instead of three extra 2E-wide scatter operands
    rows = jnp.searchsorted(offsets, jnp.arange(e2, dtype=jnp.int32),
                            side="right").astype(jnp.int32) - 1
    vals = (jnp.uint32(1) << (dst.astype(jnp.uint32) & jnp.uint32(31)))
    return jnp.zeros((n, words), jnp.uint32).at[rows, dst // 32].add(vals)


# device-build threshold: above this bitset size the one-off scatter
# compile is taken to beat copying the host-built array to the device.
# The value was set on an earlier host link and is not yet measured on
# a GPU host.
_DEVICE_BUILD_BYTES = 4 << 30


def bitset_graph_from_edges(edges, *,
                            device_build: bool | None = None,
                            use_native: str = "auto") -> BitsetGraph:
    """Build a :class:`BitsetGraph` from an (E, 2) edge array without ever
    materializing the dense adjacency (E-sized host work).

    ``device_build`` picks where the packed adjacency is assembled:
    ``None`` (default) auto-selects by size — host build + ship below
    ``_DEVICE_BUILD_BYTES``, on-device scatter build above (ships only
    the (2E,) index arrays and never allocates the bitset in host RAM);
    pass True/False to force a path (tests exercise both).
    ``use_native`` as in :func:`csr_graph_from_edges`."""
    dst, offsets, deg, node_ids, max_deg_host = _host_csr_build(
        edges, use_native)
    n = len(node_ids)
    src = None
    words = (n + 31) // 32
    nbr_dev = jnp.asarray(dst)
    off_dev = jnp.asarray(offsets)
    if device_build is None:
        device_build = n * words * 4 >= _DEVICE_BUILD_BYTES
    if device_build:
        # build the packed adjacency ON DEVICE from the graph's own
        # (2E,) nbr_flat + (N,) offsets device arrays: ships ~8E bytes
        # instead of N*ceil(N/32)*4 (8.6 GB at the 512^2-torus scale)
        # and never allocates the bitset in host RAM. scatter-ADD is
        # exact here: the directed pairs are unique (deduped undirected
        # edges, both orientations), so each bit is added exactly once
        # and a sum of distinct powers of two IS their bitwise OR. The
        # zeros init and the scatter MUST live in one jitted program:
        # as separate ops the scatter cannot alias its operand, and two
        # live copies of the bitset (2 x 8.6 GB at 512^2) would be
        # needed.
        bits = _scatter_bits(n, words, len(dst), nbr_dev, off_dev)
    else:
        src = np.repeat(np.arange(n, dtype=np.int64), deg)
        host_bits = np.zeros((n, words), np.uint32)
        np.bitwise_or.at(host_bits, (src, dst // 32),
                         np.uint32(1) << (dst % 32).astype(np.uint32))
        bits = jnp.asarray(host_bits)
    max_deg = max_deg_host
    pad = None
    if n and 0 < max_deg * n * 4 <= _PAD_TABLE_BYTES:
        pad = _build_nbr_pad_T(src, dst, deg, offsets, n, max_deg,
                               dst_dev=nbr_dev, offsets_dev=off_dev)
    g = BitsetGraph(
        bits=bits,
        nbr_flat=nbr_dev,
        offsets=off_dev,
        deg=jnp.asarray(deg),
        node_ids=tuple(int(v) for v in node_ids),
        max_deg=max_deg,
        nbr_pad_T=pad,
    )
    register_host_csr(g, offsets, dst)
    return g


def load_edgelist_bitset(path: str, delimiter: str = ",") -> BitsetGraph:
    """Edge-list file -> BitsetGraph."""
    edges = np.genfromtxt(path, delimiter=delimiter, dtype=np.int64)
    return bitset_graph_from_edges(edges)
