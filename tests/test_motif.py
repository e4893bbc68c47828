"""Tests for the graph container and MCMC motif samplers."""

import numpy as np
import jax
import jax.numpy as jnp

from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency, graph_from_edgelist
from onmf_ontf_ndl_tpu.samplers.motif import (
    glauber_update,
    patch_from_embedding,
    path_adj,
    rw_update,
    sample_patches,
    sample_patches_ensemble,
    tree_parents,
    tree_sample,
)


def torus_graph(m=8):
    n = m * m
    A = np.zeros((n, n), bool)
    for i in range(m):
        for j in range(m):
            u = i * m + j
            for (di, dj) in [(1, 0), (0, 1)]:
                v = ((i + di) % m) * m + (j + dj) % m
                A[u, v] = A[v, u] = True
    return graph_from_adjacency(A)


def test_path_adj_structure():
    B = path_adj(0, 2)
    assert B.tolist() == [[0, 1, 0], [0, 0, 1], [0, 0, 0]]
    B = path_adj(1, 2)
    # left arm 0-1, right arm 0-2-3
    want = np.zeros((4, 4), int)
    want[0, 1] = 1
    want[0, 2] = 1
    want[2, 3] = 1
    assert (B == want).all()
    assert tree_parents(path_adj(1, 2)) == (0, 0, 2)
    assert tree_parents(path_adj(0, 3)) == (0, 1, 2)
    assert path_adj(0, 0).shape == (1, 1)


def test_graph_from_edgelist_first_appearance_order():
    g = graph_from_edgelist([[7, 3], [3, 9], [9, 7]])
    assert g.node_ids == (7, 3, 9)
    assert g.num_nodes == 3 and g.num_edges == 3
    assert np.asarray(g.deg).tolist() == [2, 2, 2]


def test_tree_sample_embeds_motif():
    g = torus_graph(6)
    parents = tree_parents(path_adj(1, 2))
    adj = np.asarray(g.adj)
    for s in range(20):
        emb = np.asarray(tree_sample(jax.random.key(s), parents, g,
                                     jnp.int32(s % 36)))
        for i, p in enumerate(parents):
            assert adj[emb[i + 1], emb[p]], (emb, i)


def test_rw_update_preserves_uniform():
    # MH walk with min(1, deg x/deg y) has uniform stationary law; on a
    # non-regular graph check one step from uniform stays uniform.
    edges = [[0, 1], [1, 2], [2, 0], [2, 3], [3, 4], [4, 2], [0, 4]]
    g = graph_from_edgelist(edges)
    n = g.num_nodes
    reps = 40000
    keys = jax.random.split(jax.random.key(0), reps)
    xs = jnp.arange(reps, dtype=jnp.int32) % n
    ys = jax.vmap(lambda k, x: rw_update(k, g, x))(keys, xs)
    counts = np.bincount(np.asarray(ys), minlength=n) / reps
    assert np.abs(counts - 1.0 / n).max() < 0.01


def test_glauber_single_step_conditional_law():
    # exact one-step law: pick j uniform; resample emb[j] uniform over the
    # common neighborhood of its motif-neighbor images (reference
    # glauber_gen_update), with uniform-over-all fallback.
    edges = [[0, 1], [1, 2], [2, 0], [2, 3], [3, 4], [4, 0], [1, 3]]
    g = graph_from_edgelist(edges)
    adj = np.asarray(g.adj)
    n = g.num_nodes
    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb0 = np.array([0, 1, 2], np.int32)

    Bsym = ((B + B.T) > 0)
    want = {}
    k = 3
    for j in range(k):
        mask = np.ones(n, bool)
        for r in range(k):
            if Bsym[r, j]:
                mask &= adj[emb0[r]]
        support = np.flatnonzero(mask) if mask.any() else np.arange(n)
        for y in support:
            e = emb0.copy()
            e[j] = y
            key = tuple(e)
            want[key] = want.get(key, 0.0) + 1.0 / (k * len(support))

    reps = 60000
    keys = jax.random.split(jax.random.key(1), reps)
    outs = jax.vmap(
        lambda kk: glauber_update(kk, B, parents, g, jnp.asarray(emb0))
    )(keys)
    outs = np.asarray(outs)
    counts = {}
    for row in outs:
        key = tuple(int(v) for v in row)
        counts[key] = counts.get(key, 0) + 1
    tv = 0.5 * sum(abs(counts.get(s, 0) / reps - p) for s, p in want.items())
    tv += 0.5 * sum(c / reps for s, c in counts.items() if s not in want)
    assert tv < 0.02, (tv, want, counts)


def test_patch_from_embedding():
    g = torus_graph(4)
    emb = jnp.asarray([0, 1, 2], jnp.int32)
    P = np.asarray(patch_from_embedding(g, emb))
    adj = np.asarray(g.adj)
    for q in range(3):
        for r in range(3):
            assert P[q, r] == float(adj[emb[q], emb[r]])


def test_sample_patches_shapes_and_validity():
    g = torus_graph(6)
    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb0 = tree_sample(jax.random.key(0), parents, g, jnp.int32(0))
    X, emb = sample_patches(jax.random.key(1), g, emb0, B, 50)
    assert X.shape == (9, 50)
    x = np.asarray(X)
    assert set(np.unique(x)).issubset({0.0, 1.0})
    # path entries: each sampled patch must contain the motif's edges
    # (emb[i] ~ emb[parent[i]] edges hold after a glauber move)
    assert emb.shape == (3,)

    Xe, embs = sample_patches_ensemble(
        jax.random.key(2), g, jnp.stack([emb0] * 4), B, 25)
    assert Xe.shape == (9, 100) and embs.shape == (4, 3)


def test_weighted_patches():
    A = np.array([[0, 2.0, 0], [2.0, 0, 1.0], [0, 1.0, 0]])
    g = graph_from_adjacency(A, normalize=True)
    emb = jnp.asarray([0, 1, 2], jnp.int32)
    P = np.asarray(patch_from_embedding(g, emb, weighted=True))
    assert np.isclose(P[0, 1], 1.0) and np.isclose(P[1, 2], 0.5)


def test_bitset_graph_equivalence():
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import _adj_rows, _pair_matrix

    rng = np.random.default_rng(17)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, 70, (300, 2))
             if a != b]
    gd = graph_from_edgelist(np.asarray(edges))
    gb = bitset_graph_from_edges(np.asarray(edges))
    assert gd.node_ids == gb.node_ids
    assert gd.num_edges == gb.num_edges
    np.testing.assert_array_equal(np.asarray(gd.deg), np.asarray(gb.deg))

    emb = jnp.asarray([0, 3, 7, 12], jnp.int32)
    np.testing.assert_array_equal(np.asarray(_adj_rows(gd, emb)),
                                  np.asarray(_adj_rows(gb, emb)))
    np.testing.assert_array_equal(np.asarray(_pair_matrix(gd, emb)),
                                  np.asarray(_pair_matrix(gb, emb)))

    # uniform-neighbor draws hit exactly the neighbor sets
    from onmf_ontf_ndl_tpu.samplers.motif import _uniform_neighbor
    adj = np.asarray(gd.adj)
    for x in (0, 5, 11):
        ys = {int(_uniform_neighbor(jax.random.key(s), gb, jnp.int32(x)))
              for s in range(80)}
        assert ys <= set(np.flatnonzero(adj[x]))


def test_bitset_glauber_law_matches_dense():
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges

    edges = [[0, 1], [1, 2], [2, 0], [2, 3], [3, 4], [4, 0], [1, 3]]
    gd = graph_from_edgelist(edges)
    gb = bitset_graph_from_edges(edges)
    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb0 = jnp.asarray([0, 1, 2], jnp.int32)
    reps = 20000
    outs_d = jax.vmap(lambda k: glauber_update(k, B, parents, gd, emb0))(
        jax.random.split(jax.random.key(3), reps))
    outs_b = jax.vmap(lambda k: glauber_update(k, B, parents, gb, emb0))(
        jax.random.split(jax.random.key(3), reps))
    # identical keys + identical conditional law => identical draws
    np.testing.assert_array_equal(np.asarray(outs_d), np.asarray(outs_b))


def test_edgeless_motif_embeds_uniformly():
    # reference tree_sample: an edgeless motif embeds k-1 uniform nodes
    g = torus_graph(4)
    B = np.zeros((3, 3), int)
    parents = tree_parents(B)
    assert parents == (-1, -1)
    reps = 8000
    outs = jax.vmap(
        lambda k: tree_sample(k, parents, g, jnp.int32(0))
    )(jax.random.split(jax.random.key(9), reps))
    counts = np.bincount(np.asarray(outs)[:, 1], minlength=16) / reps
    assert np.abs(counts - 1 / 16).max() < 0.02  # uniform over ALL nodes


def test_graph_num_nodes_padding():
    import pytest
    g = graph_from_edgelist([[0, 1], [1, 2]], num_nodes=5)
    assert g.num_nodes == 5 and len(g.node_ids) == 5
    assert np.asarray(g.deg)[3:].tolist() == [0, 0]
    with pytest.raises(ValueError, match="distinct labels"):
        graph_from_edgelist([[0, 7]], num_nodes=1)


def test_bitset_loader_on_reference_facebook():
    import os
    import pytest
    path = "/root/reference/Data/Networks/facebook_combined.txt"
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    from onmf_ontf_ndl_tpu.data.graphs import load_edgelist_bitset

    g = load_edgelist_bitset(path)
    assert g.num_nodes == 4039
    assert g.num_edges == 88234
    assert g.bits.shape == (4039, (4039 + 31) // 32)


def test_bitset_rows_matches_host_view():
    """_bitset_rows (whole-row gather from the canonical 2-D bitset)
    must return exactly the host view's rows."""
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import _bitset_rows

    rng = np.random.default_rng(7)
    edges = np.asarray([(int(a), int(b))
                        for a, b in rng.integers(0, 70, (300, 2)) if a != b])
    g = bitset_graph_from_edges(edges)
    idx = jnp.asarray(rng.integers(0, g.num_nodes, 13), jnp.int32)
    got = np.asarray(jax.jit(_bitset_rows, static_argnums=())(g, idx))
    np.testing.assert_array_equal(got, np.asarray(g.bits)[np.asarray(idx)])


def test_select_uniform_bit_law():
    """Packed rank-select draw: uniform over set bits across word
    boundaries; uniform over [0, n) on an empty mask."""
    from onmf_ontf_ndl_tpu.samplers.motif import _select_uniform_bit

    n = 100                                   # spans 4 uint32 words
    set_bits = [0, 31, 32, 33, 64, 97]
    words = np.zeros(4, np.uint32)
    for b in set_bits:
        words[b // 32] |= np.uint32(1) << (b % 32)
    reps = 30000
    outs = jax.vmap(lambda k: _select_uniform_bit(k, jnp.asarray(words), n))(
        jax.random.split(jax.random.key(5), reps))
    counts = np.bincount(np.asarray(outs), minlength=n)
    assert set(np.flatnonzero(counts)) == set(set_bits)
    freq = counts[set_bits] / reps
    np.testing.assert_allclose(freq, 1.0 / len(set_bits), atol=0.01)

    # empty mask -> uniform over [0, n)
    outs = jax.vmap(lambda k: _select_uniform_bit(
        k, jnp.zeros(4, jnp.uint32), n))(
        jax.random.split(jax.random.key(6), 5000))
    o = np.asarray(outs)
    assert o.min() >= 0 and o.max() < n and len(np.unique(o)) > 50


def test_motif_neighbor_table_path():
    """For a path motif every node has <= 2 motif neighbors regardless of
    arm length — the static table the Glauber move gathers rows by."""
    from onmf_ontf_ndl_tpu.samplers.motif import _motif_neighbor_table

    tbl = _motif_neighbor_table(path_adj(0, 20))
    assert tbl.shape == (21, 2)
    Bsym = (path_adj(0, 20) + path_adj(0, 20).T) > 0
    for i in range(21):
        want = set(np.flatnonzero(Bsym[i]))
        got = set(int(v) for v in tbl[i] if v >= 0)
        assert got == want


def test_glauber_law_long_motif():
    """One-step conditional law on a 5-node path motif (multi-row
    constraint sets exercised through the neighbor-table gather)."""
    g = torus_graph(5)
    adj = np.asarray(g.adj)
    n = g.num_nodes
    B = path_adj(0, 4)
    parents = tree_parents(B)
    emb0 = np.asarray(
        tree_sample(jax.random.key(8), parents, g, jnp.int32(7)))
    k = B.shape[0]
    Bsym = (B + B.T) > 0

    want = {}
    for j in range(k):
        mask = np.ones(n, bool)
        for r in range(k):
            if Bsym[r, j]:
                mask &= adj[emb0[r]]
        support = np.flatnonzero(mask) if mask.any() else np.arange(n)
        for y in support:
            e = emb0.copy()
            e[j] = y
            want[tuple(e)] = want.get(tuple(e), 0.0) + 1.0 / (k * len(support))

    reps = 60000
    outs = np.asarray(jax.vmap(
        lambda kk: glauber_update(kk, B, parents, g, jnp.asarray(emb0))
    )(jax.random.split(jax.random.key(9), reps)))
    counts = {}
    for row in outs:
        counts[tuple(int(v) for v in row)] = \
            counts.get(tuple(int(v) for v in row), 0) + 1
    tv = 0.5 * sum(abs(counts.get(s, 0) / reps - p) for s, p in want.items())
    tv += 0.5 * sum(c / reps for s, c in counts.items() if s not in want)
    assert tv < 0.03, tv


def test_pair_matrices_T_matches_vmapped_single():
    """pair_matrices_T (batch-minor layout, 1-D linear gathers) must
    equal the vmapped per-sample _pair_matrix on every representation:
    it exists purely to avoid the tiny-minor-dim padding blowup of the
    vmapped gather (a many-fold memory expansion at reconstruction
    scale)."""
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import (
        _pair_matrix, pair_matrices_T)

    rng = np.random.default_rng(23)
    edges = np.asarray([(int(a), int(b))
                        for a, b in rng.integers(0, 40, (150, 2)) if a != b])
    g = graph_from_edgelist(edges)
    bg = bitset_graph_from_edges(edges)   # same interning order
    M, k = 37, 3
    embs = jax.random.randint(jax.random.key(3), (M, k), 0, g.num_nodes)
    want = np.stack([np.asarray(_pair_matrix(g, e)) for e in embs])
    got = np.asarray(pair_matrices_T(g, embs))
    assert got.shape == (k * k, M)
    np.testing.assert_array_equal(got, want.reshape(M, k * k).T)

    got_b = np.asarray(pair_matrices_T(bg, embs))
    np.testing.assert_array_equal(got_b, want.reshape(M, k * k).T)

    # weighted: matches the dense weight-matrix gather elementwise
    A = np.asarray(g.adj, np.float64) * 2.0
    gw = graph_from_adjacency(A, normalize=True)
    got_w = np.asarray(pair_matrices_T(gw, embs, weighted=True))
    wantw = np.asarray(gw.weight)[np.asarray(embs)[:, :, None],
                                  np.asarray(embs)[:, None, :]]
    np.testing.assert_allclose(got_w, wantw.reshape(M, k * k).T, rtol=1e-6)


def test_intern_edges_matches_dict_loop_oracle():
    """The vectorized first-appearance interning must order and index
    nodes exactly like the obvious dict loop (the load-bearing
    networkx-compatible ordering invariant)."""
    from onmf_ontf_ndl_tpu.data.graphs import _intern_edges

    rng = np.random.default_rng(11)
    labels = rng.choice([3, 900, 17, -4, 12345678, 0, 55], size=(400, 2))
    e, node_ids = _intern_edges(labels)

    order = {}
    for a, b in labels:
        for v in (int(a), int(b)):
            if v not in order:
                order[v] = len(order)
    assert node_ids.tolist() == list(order)
    oe = np.asarray([(order[int(a)], order[int(b)]) for a, b in labels])
    oe = oe[oe[:, 0] != oe[:, 1]]
    lo = np.minimum(oe[:, 0], oe[:, 1])
    hi = np.maximum(oe[:, 0], oe[:, 1])
    oe = np.unique(np.stack([lo, hi], 1), axis=0)
    np.testing.assert_array_equal(e, oe)


def test_intern_edges_numpy_fallback_matches_pandas_path(monkeypatch):
    """`_intern_edges` prefers pandas.factorize; the numpy fallback must
    produce identical interning when pandas is unavailable (and the
    non-fallback call verifies the two paths agree)."""
    import sys

    from onmf_ontf_ndl_tpu.data.graphs import _intern_edges

    rng = np.random.default_rng(29)
    labels = rng.choice(np.arange(-2_000_000_000, 2_000_000_000, 99991),
                        size=(700, 2))
    e_pd, ids_pd = _intern_edges(labels)
    # blocking the pandas import drives the numpy unique/searchsorted path
    monkeypatch.setitem(sys.modules, "pandas", None)
    e_np, ids_np = _intern_edges(labels)
    np.testing.assert_array_equal(e_pd, e_np)
    np.testing.assert_array_equal(np.asarray(ids_pd), np.asarray(ids_np))


def test_csr_arrays_packed_sort_matches_lexsort_oracle():
    """The one-key packed sort in `_csr_arrays` must order the directed
    pairs exactly like the two-key lexsort it replaced (src asc, dst asc
    within src) — the order rank-select draws depend on."""
    from onmf_ontf_ndl_tpu.data.graphs import _csr_arrays, _intern_edges

    rng = np.random.default_rng(31)
    raw = rng.integers(0, 60, size=(800, 2))
    e, ids = _intern_edges(raw)
    n = len(ids)
    src, dst, deg, off = _csr_arrays(e, n)

    both = np.concatenate([e, e[:, ::-1]], axis=0)
    order = np.lexsort((both[:, 1], both[:, 0]))
    np.testing.assert_array_equal(src, both[order, 0])
    np.testing.assert_array_equal(dst, both[order, 1])
    np.testing.assert_array_equal(deg, np.bincount(both[:, 0], minlength=n))
    np.testing.assert_array_equal(
        off, np.concatenate([[0], np.cumsum(deg)[:-1]]))


def test_bitset_device_build_matches_host_oracle():
    """The on-device scatter-add bitset build (a sum of distinct powers
    of two IS the bitwise OR, because directed pairs are unique) must
    reproduce the host np.bitwise_or build bit for bit."""
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges

    rng = np.random.default_rng(23)
    # 40 nodes -> 2 words per row, exercising a word boundary
    edges = np.asarray([(int(a), int(b))
                        for a, b in rng.integers(0, 40, (150, 2)) if a != b])
    g_dev = bitset_graph_from_edges(edges, device_build=True)
    g_host = bitset_graph_from_edges(edges, device_build=False)
    n = g_dev.num_nodes

    idx = {v: i for i, v in enumerate(g_dev.node_ids)}
    oracle = np.zeros((n, (n + 31) // 32), np.uint32)
    for a, b in edges:
        i, j = idx[int(a)], idx[int(b)]
        oracle[i, j // 32] |= np.uint32(1) << np.uint32(j % 32)
        oracle[j, i // 32] |= np.uint32(1) << np.uint32(i % 32)
    np.testing.assert_array_equal(np.asarray(g_dev.bits), oracle)
    np.testing.assert_array_equal(np.asarray(g_host.bits), oracle)


def test_glauber_candidate_kernel_matches_dense_draws():
    """On a low-degree graph large enough to select the candidate-list
    Glauber kernel (max_deg * 8 <= words_per_row), bitset draws must be
    IDENTICAL to the dense-representation draws for the same keys: the
    candidate set enumerates the first constraint's ascending CSR row,
    so the rank-select picks the same element as the dense (N,)-mask
    rank-select."""
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers import motif

    # 2048-node ring + chords: max_deg 4, words_per_row 64 -> candidate
    n = 2048
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + 7) % n) for i in range(0, n, 3)]
    gd = graph_from_edgelist(np.asarray(edges))
    gb = bitset_graph_from_edges(np.asarray(edges))
    assert gb.max_deg * motif._CANDIDATE_DEG_FACTOR <= gb.words_per_row

    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb0 = jnp.asarray([0, 1, 2], jnp.int32)
    reps = 4000
    keys = jax.random.split(jax.random.key(5), reps)
    outs_d = jax.vmap(lambda k: glauber_update(k, B, parents, gd, emb0))(keys)
    outs_b = jax.vmap(lambda k: glauber_update(k, B, parents, gb, emb0))(keys)
    np.testing.assert_array_equal(np.asarray(outs_d), np.asarray(outs_b))

    # and a multi-step chain stays identical (errors would compound)
    def chain(g):
        def step(emb, k):
            emb = glauber_update(k, B, parents, g, emb)
            return emb, emb
        _, out = jax.lax.scan(step, emb0, jax.random.split(
            jax.random.key(9), 500))
        return out
    np.testing.assert_array_equal(np.asarray(chain(gd)),
                                  np.asarray(chain(gb)))


def test_csr_graph_matches_dense_everywhere():
    """CsrGraph (pure O(E) representation) must agree with the dense
    representation on every sampler surface — identical glauber draws
    (same ascending rank-select order), identical pair matrices and
    adjacency rows, equal metadata."""
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import (
        _adj_rows, _pair_matrix, pair_matrices_T)

    n = 2048
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + 7) % n) for i in range(0, n, 3)]
    gd = graph_from_edgelist(np.asarray(edges))
    gc = csr_graph_from_edges(np.asarray(edges))
    assert gd.node_ids == gc.node_ids
    assert gd.num_edges == gc.num_edges
    assert gc.max_deg == int(np.asarray(gd.deg).max())

    emb = jnp.asarray([0, 3, 7, 12], jnp.int32)
    np.testing.assert_array_equal(np.asarray(_adj_rows(gd, emb)),
                                  np.asarray(_adj_rows(gc, emb)))
    np.testing.assert_array_equal(np.asarray(_pair_matrix(gd, emb)),
                                  np.asarray(_pair_matrix(gc, emb)))

    rng = np.random.default_rng(2)
    embs = jnp.asarray(rng.integers(0, n, (500, 3)), jnp.int32)
    np.testing.assert_array_equal(np.asarray(pair_matrices_T(gd, embs)),
                                  np.asarray(pair_matrices_T(gc, embs)))

    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb0 = jnp.asarray([0, 1, 2], jnp.int32)
    keys = jax.random.split(jax.random.key(5), 4000)
    outs_d = jax.vmap(lambda k: glauber_update(k, B, parents, gd, emb0))(keys)
    outs_c = jax.vmap(lambda k: glauber_update(k, B, parents, gc, emb0))(keys)
    np.testing.assert_array_equal(np.asarray(outs_d), np.asarray(outs_c))

    def chain(g):
        def step(emb, k):
            emb = glauber_update(k, B, parents, g, emb)
            return emb, emb
        _, out = jax.lax.scan(step, emb0, jax.random.split(
            jax.random.key(9), 500))
        return out
    np.testing.assert_array_equal(np.asarray(chain(gd)),
                                  np.asarray(chain(gc)))


def test_bsearch_membership_skewed_degree_matches_dense():
    """On a heavy-tailed graph whose max_deg exceeds the binary-search
    threshold, the CsrGraph pair fetch and the Glauber candidate
    membership route through `_pair_membership_bsearch` — values and
    DRAWS must stay identical to the dense representation (hub rows are
    the regime the padded/(D, k, M) block forms are gated off for)."""
    import dataclasses

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers import motif
    from onmf_ontf_ndl_tpu.samplers.motif import (
        _pair_membership_bsearch, pair_matrices_T)

    n = 2048
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + 7) % n) for i in range(0, n, 3)]
    # hub: node 0 connected to a 300-node block (deg ~300 > threshold)
    edges += [(0, j) for j in range(1000, 1300)]
    gd = graph_from_edgelist(np.asarray(edges))
    gc = csr_graph_from_edges(np.asarray(edges))
    # drop the padded table so the fetch exercises the hub paths
    gc = dataclasses.replace(gc, nbr_pad_T=None)
    assert gc.max_deg > motif._BSEARCH_DEG_THRESHOLD

    # direct membership oracle on random pairs, hub rows included
    rng = np.random.default_rng(0)
    row = np.concatenate([rng.integers(0, n, 3000),
                          np.zeros(1000, np.int64)])
    col = rng.integers(0, n, 4000)
    got = np.asarray(_pair_membership_bsearch(
        gc, jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32)))
    want = np.asarray(gd.adj)[row, col]
    np.testing.assert_array_equal(got, want)

    # batched pair-matrix fetch (the reconstruction fetch)
    embs = jnp.asarray(
        np.concatenate([rng.integers(0, n, (400, 3)),
                        np.stack([np.zeros(100, np.int64),
                                  rng.integers(1000, 1300, 100),
                                  rng.integers(0, n, 100)], axis=1)]),
        jnp.int32)
    np.testing.assert_array_equal(np.asarray(pair_matrices_T(gd, embs)),
                                  np.asarray(pair_matrices_T(gc, embs)))

    # identical Glauber chains through the hub (the bsearch candidate
    # membership must select the same rank as the dense mask)
    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb0 = jnp.asarray([1000, 0, 1050], jnp.int32)

    def chain(g):
        def step(emb, k):
            emb = glauber_update(k, B, parents, g, emb)
            return emb, emb
        _, out = jax.lax.scan(step, emb0, jax.random.split(
            jax.random.key(11), 600))
        return out

    np.testing.assert_array_equal(np.asarray(chain(gd)),
                                  np.asarray(chain(gc)))


def test_bsearch_membership_fuzz_random_graphs():
    """Property fuzz of the binary-search membership against the dense
    oracle across random graph sizes/densities, with the threshold
    forced low so even small-degree graphs route through bsearch
    (distinct node counts per case keep the jit caches disjoint)."""
    import dataclasses

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers import motif
    from onmf_ontf_ndl_tpu.samplers.motif import (
        _pair_membership_bsearch, pair_matrices_T)

    rng = np.random.default_rng(12)
    old = motif._BSEARCH_DEG_THRESHOLD
    try:
        motif._BSEARCH_DEG_THRESHOLD = 1
        for n, e_count in ((51, 60), (130, 800), (257, 4000)):
            e = rng.integers(0, n, (e_count, 2))
            e = e[e[:, 0] != e[:, 1]]
            gd = graph_from_edgelist(e, num_nodes=n)
            gc = dataclasses.replace(csr_graph_from_edges(e),
                                     nbr_pad_T=None)
            if gc.num_nodes != n:      # isolated-node padding differs
                gd = graph_from_edgelist(e)
            row = jnp.asarray(rng.integers(0, gc.num_nodes, 500),
                              jnp.int32)
            col = jnp.asarray(rng.integers(0, gc.num_nodes, 500),
                              jnp.int32)
            got = np.asarray(_pair_membership_bsearch(gc, row, col))
            want = np.asarray(gd.adj)[np.asarray(row), np.asarray(col)]
            np.testing.assert_array_equal(got, want)
            embs = jnp.asarray(
                rng.integers(0, gc.num_nodes, (64, 3)), jnp.int32)
            np.testing.assert_array_equal(
                np.asarray(pair_matrices_T(gd, embs)),
                np.asarray(pair_matrices_T(gc, embs)))
            # chains stay identical through the forced-bsearch branch
            B = path_adj(0, 2)
            parents = tree_parents(B)
            emb0 = tree_sample(jax.random.key(n), parents, gd,
                               jnp.int32(0))
            def chain(g, e0=emb0, B=B, parents=parents):
                def step(emb, k):
                    emb = glauber_update(k, B, parents, g, emb)
                    return emb, emb
                _, out = jax.lax.scan(
                    step, e0, jax.random.split(jax.random.key(n + 1), 200))
                return out
            np.testing.assert_array_equal(np.asarray(chain(gd)),
                                          np.asarray(chain(gc)))
    finally:
        motif._BSEARCH_DEG_THRESHOLD = old


def test_sorted_multiplicity_glauber_star_motif_matches_dense():
    """The hub-regime Glauber intersection counts equal-value runs to
    find common neighbors (samplers/motif.py sorted-multiplicity path);
    a STAR motif makes the resampled center carry 3+ constraints, and
    repeated constraint images make duplicate rows — both must still
    draw identically to the dense mask path. (The path-motif fuzz above
    only ever exercises 2 constraints.)"""
    import dataclasses

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers import motif

    # K4 star: center 0, leaves 1..3 (center degree 3 in the motif)
    B = np.zeros((4, 4), np.int8)
    B[0, 1] = B[0, 2] = B[0, 3] = 1
    parents = tree_parents(B)

    rng = np.random.default_rng(5)
    n = 700
    e = rng.integers(0, n, (5000, 2))
    e = e[e[:, 0] != e[:, 1]]
    e = np.concatenate([e, np.stack(
        [np.zeros(500, np.int64), rng.integers(1, n, 500)], axis=1)])
    gd = graph_from_edgelist(e)
    gc = dataclasses.replace(csr_graph_from_edges(e), nbr_pad_T=None)
    assert gd.num_nodes == gc.num_nodes

    old = motif._BSEARCH_DEG_THRESHOLD
    try:
        motif._BSEARCH_DEG_THRESHOLD = 1   # force the sorted path

        def chain(g, e0):
            def step(emb, k):
                emb = glauber_update(k, B, parents, g, emb)
                return emb, emb
            _, out = jax.lax.scan(
                step, e0, jax.random.split(jax.random.key(3), 500))
            return out

        e0 = tree_sample(jax.random.key(2), parents, gd, jnp.int32(0))
        np.testing.assert_array_equal(np.asarray(chain(gd, e0)),
                                      np.asarray(chain(gc, e0)))

        # duplicate constraint images: two leaves on the same node
        e0d = jnp.asarray([0, 5, 5, 9], jnp.int32)
        np.testing.assert_array_equal(np.asarray(chain(gd, e0d)),
                                      np.asarray(chain(gc, e0d)))
    finally:
        motif._BSEARCH_DEG_THRESHOLD = old


def test_sortjoin_membership_matches_dense_and_bsearch():
    """The sort-join membership kernel (large-batch path of the hub
    regime) must agree exactly with the dense oracle and the binary
    search on every query — hub rows, self pairs, duplicate queries,
    isolated/trailing empty rows included."""
    import dataclasses

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import (
        _pair_membership_bsearch, _pair_membership_sortjoin)

    rng = np.random.default_rng(21)
    for n, e_count in ((51, 60), (257, 4000), (400, 900)):
        e = rng.integers(0, n, (e_count, 2))
        e = e[e[:, 0] != e[:, 1]]
        e = np.concatenate([e, [[0, 1]]])
        gd = graph_from_edgelist(e)
        gc = dataclasses.replace(csr_graph_from_edges(e), nbr_pad_T=None)
        m = min(gc.num_nodes, gd.num_nodes)
        row = rng.integers(0, m, 2000)
        col = rng.integers(0, m, 2000)
        # self pairs + duplicate queries in the batch
        row[:50] = col[:50]
        row[50:100] = row[0]
        col[50:100] = col[0]
        rj = jnp.asarray(row, jnp.int32)
        cj = jnp.asarray(col, jnp.int32)
        got = np.asarray(_pair_membership_sortjoin(gc, rj, cj))
        want = np.asarray(gd.adj)[row, col]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(_pair_membership_bsearch(gc, rj, cj)))
        # 2-D query shape (the (P, M) reconstruction layout)
        r2, c2 = rj.reshape(4, -1), cj.reshape(4, -1)
        np.testing.assert_array_equal(
            np.asarray(_pair_membership_sortjoin(gc, r2, c2)),
            got.reshape(4, -1))


def test_membership_slots_match_oracle():
    """``with_slots=True`` on both membership kernels returns the flat
    CSR slot of each member pair's directed edge (the bitmask edge-
    fetch path scatters per-slot bits through it) — checked against a
    searchsorted oracle on the host CSR arrays, hub rows and empty
    rows included."""
    import dataclasses

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import (
        _pair_membership_bsearch, _pair_membership_sortjoin)

    rng = np.random.default_rng(33)
    e = rng.integers(0, 200, (1500, 2))
    e = e[e[:, 0] != e[:, 1]]
    # a hub: node 0 adjacent to half the graph
    hub = np.stack([np.zeros(100, np.int64), np.arange(1, 101)], 1)
    e = np.concatenate([e, hub])
    gc = dataclasses.replace(csr_graph_from_edges(e), nbr_pad_T=None)
    offs = np.asarray(gc.offsets)
    dst = np.asarray(gc.nbr_flat)
    deg = np.asarray(gc.deg)
    n = gc.num_nodes
    row = rng.integers(0, n, 3000).astype(np.int32)
    col = rng.integers(0, n, 3000).astype(np.int32)
    row[:200] = 0                         # hammer the hub row
    want_m = np.zeros(3000, bool)
    want_s = np.zeros(3000, np.int64)
    for t in range(3000):
        r, c = row[t], col[t]
        seg = dst[offs[r]:offs[r] + deg[r]]
        p = np.searchsorted(seg, c)
        if p < deg[r] and seg[p] == c:
            want_m[t] = True
            want_s[t] = offs[r] + p
    rj, cj = jnp.asarray(row), jnp.asarray(col)
    for kern in (_pair_membership_bsearch, _pair_membership_sortjoin):
        got_m, got_s = kern(gc, rj, cj, True)
        got_m = np.asarray(got_m)
        np.testing.assert_array_equal(got_m, want_m, err_msg=kern.__name__)
        np.testing.assert_array_equal(np.asarray(got_s)[want_m],
                                      want_s[want_m],
                                      err_msg=kern.__name__)
        # membership unchanged vs the slot-less form
        np.testing.assert_array_equal(got_m, np.asarray(kern(gc, rj, cj)))


def test_membership_dispatch_cost_model():
    """_pair_membership routes small batches to binary search and
    edge-list-dominating batches to the sort-join (both sides already
    value-tested; this pins the dispatch itself)."""
    from unittest import mock

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers import motif

    e = np.asarray([(i, (i + 1) % 64) for i in range(64)])
    g = csr_graph_from_edges(e)   # 2E = 128, max_deg 2
    small = jnp.zeros((4,), jnp.int32)
    large = jnp.zeros((1024,), jnp.int32)
    with mock.patch.object(motif, "_pair_membership_sortjoin",
                           wraps=motif._pair_membership_sortjoin) as sj, \
         mock.patch.object(motif, "_pair_membership_bsearch",
                           wraps=motif._pair_membership_bsearch) as bs:
        motif._pair_membership(g, small, small)
        assert bs.call_count == 1 and sj.call_count == 0
        motif._pair_membership(g, large, large)
        assert sj.call_count == 1
