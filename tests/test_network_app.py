"""End-to-end network dictionary learning + reconstruction test."""

import numpy as np
import jax.numpy as jnp

from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency


def torus_adjacency(m=10):
    n = m * m
    A = np.zeros((n, n), bool)
    for i in range(m):
        for j in range(m):
            u = i * m + j
            for (di, dj) in [(1, 0), (0, 1)]:
                v = ((i + di) % m) * m + (j + dj) % m
                A[u, v] = A[v, u] = True
    return A


def test_ndl_torus_end_to_end():
    g = graph_from_adjacency(torus_adjacency(10))
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=10, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2, alpha=0.1,
        is_glauber_dict=True, is_glauber_recons=False, dtype=jnp.float64,
    )
    W = rec.train_dict()
    assert W.shape == (9, 16)
    assert (np.asarray(W) >= 0).all()
    assert float(rec.state.t) == 10 * 10

    recon = rec.reconstruct_network(recons_iter=4000)
    acc = rec.compute_recons_accuracy()
    # the torus is homogeneous; NDL should reconstruct most visited edges
    assert 0.0 < acc <= 1.0
    assert acc > 0.5, acc


def test_ndl_glauber_recons_and_code():
    g = graph_from_adjacency(torus_adjacency(6))
    rec = NetworkReconstructor(
        source=g, n_components=9, MCMC_iterations=5, sub_iterations=5,
        sample_size=50, batch_size=10, k1=1, k2=1, alpha=0.0,
        is_glauber_recons=True, dtype=jnp.float64,
    )
    rec.train_dict()
    assert rec.code.shape == (9, 50)
    assert np.asarray(rec.code).sum() > 0  # code accumulated
    recon = rec.reconstruct_network(recons_iter=500)
    assert recon.shape == (36, 36)
    acc = rec.compute_recons_accuracy()
    assert 0.0 <= acc <= 1.0


def test_ensemble_reconstruction_matches_accuracy():
    g = graph_from_adjacency(torus_adjacency(10))
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2, alpha=0.1,
        is_glauber_recons=False, dtype=jnp.float64,
    )
    rec.train_dict()
    rec.reconstruct_network(recons_iter=4000, num_chains=8)
    acc = rec.compute_recons_accuracy()
    assert acc > 0.5, acc


def test_fast_mode_trains():
    g = graph_from_adjacency(torus_adjacency(6))
    rec = NetworkReconstructor(
        source=g, n_components=9, MCMC_iterations=4, sub_iterations=5,
        sample_size=50, batch_size=10, k1=0, k2=2, fast=True,
        dtype=jnp.float64,
    )
    W = rec.train_dict()
    assert (np.asarray(W) >= 0).all()
    assert float(rec.state.t) == 4 * 5


def test_ensemble_training_chains():
    g = graph_from_adjacency(torus_adjacency(10))
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=96, batch_size=20, k1=0, k2=2, alpha=0.1,
        num_chains=8, is_glauber_recons=False, dtype=jnp.float64,
    )
    W = rec.train_dict()
    assert (np.asarray(W) >= 0).all()
    assert rec.emb.shape == (8, 3)
    rec.reconstruct_network(recons_iter=4000, num_chains=8)
    acc = rec.compute_recons_accuracy()
    assert acc > 0.5, acc


def test_ndl_on_bitset_graph():
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges

    A = torus_adjacency(10)
    edges = np.argwhere(np.triu(A))
    g = bitset_graph_from_edges(edges)
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2, alpha=0.1,
        is_glauber_recons=False, dtype=jnp.float64,
    )
    rec.train_dict()
    # BitsetGraph auto-routes to the sparse reconstruction
    edges = rec.reconstruct_network(recons_iter=4000)
    assert rec.G_recons is None and edges.shape[1] == 2
    # accuracy vs the dense ground truth (edges are in interned node
    # order; map back to the original labels)
    ids = np.asarray(g.node_ids)
    common = A[ids[edges[:, 0]], ids[edges[:, 1]]].sum()
    acc = common / (A.sum() // 2)
    assert acc > 0.5, acc
    # the shell metric must agree with the hand computation
    assert abs(rec.compute_recons_accuracy() - acc) < 1e-12


def test_bitset_accuracy_method():
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges

    A = torus_adjacency(6)
    g = bitset_graph_from_edges(np.argwhere(np.triu(A)))
    rec = NetworkReconstructor(
        source=g, n_components=9, MCMC_iterations=4, sub_iterations=5,
        sample_size=50, batch_size=10, k1=0, k2=1, dtype=jnp.float64,
    )
    rec.train_dict()
    rec.reconstruct_network(recons_iter=1000)
    acc = rec.compute_recons_accuracy()
    assert 0.0 <= acc <= 1.0


def test_weighted_wan_reconstruction():
    # weighted patches + weighted reconstruction path: the recon matrix
    # approximates the normalized weight matrix on visited pairs
    rng = np.random.default_rng(31)
    n = 40
    Wts = np.triu(rng.random((n, n)) * (rng.random((n, n)) < 0.2), 1)
    A = Wts + Wts.T
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency
    g = graph_from_adjacency(A, normalize=True)
    rec = NetworkReconstructor(
        source=g, n_components=9, MCMC_iterations=5, sub_iterations=8,
        sample_size=64, batch_size=16, k1=0, k2=1, weighted_patches=True,
        is_glauber_recons=False, dtype=jnp.float64,
    )
    rec.train_dict()
    rec.reconstruct_network(recons_iter=2000)
    r = np.asarray(rec.recon_weights)
    wt = np.asarray(g.weight)
    visited = np.asarray(rec.recon_weights) > 0
    # on visited true edges the reconstructed weights should correlate
    # with the normalized WAN weights
    mask = (wt > 0) & visited
    if mask.sum() > 10:
        corr = np.corrcoef(r[mask], wt[mask])[0, 1]
        assert corr > 0.2, corr


def test_label_index_mapping_and_display(tmp_path):
    import os
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_edgelist

    g = graph_from_edgelist([[7, 3], [3, 9], [9, 7]])
    rec = NetworkReconstructor(source=g, n_components=4, MCMC_iterations=2,
                               sub_iterations=3, sample_size=20,
                               batch_size=5, k1=0, k2=1, dtype=jnp.float64)
    assert rec.label_of(0) == 7 and rec.index_of(9) == 2
    rec.train_dict()
    p = rec.display_dict("t", save_filename=str(tmp_path / "d.png"))
    assert os.path.getsize(p) > 0


def test_sparse_recon_matches_dense():
    # same key through both low-level paths: the sparse segment-mean
    # result must reproduce the dense overlap-average exactly
    import jax
    from onmf_ontf_ndl_tpu.apps.network import (
        reconstruct_network, reconstruct_network_sparse)

    g = graph_from_adjacency(torus_adjacency(6))
    rec = NetworkReconstructor(
        source=g, n_components=9, MCMC_iterations=3, sub_iterations=5,
        sample_size=50, batch_size=10, k1=1, k2=1, dtype=jnp.float64,
    )
    rec.train_dict()
    key = jax.random.key(42)
    dense, cnt = reconstruct_network(
        rec.state.W, g, key, rec._B_bytes, rec._parents,
        recons_iter=300, use_glauber=False)
    ii, jj, mean, scnt = reconstruct_network_sparse(
        rec.state.W, g, key, rec._B_bytes, rec._parents,
        recons_iter=300, use_glauber=False)
    dense, cnt = np.asarray(dense), np.asarray(cnt)
    ii, jj = np.asarray(ii), np.asarray(jj)
    mean, scnt = np.asarray(mean), np.asarray(scnt)
    valid = scnt > 0
    np.testing.assert_allclose(mean[valid], dense[ii[valid], jj[valid]],
                               rtol=1e-9)
    np.testing.assert_allclose(scnt[valid], cnt[ii[valid], jj[valid]],
                               rtol=0)
    assert scnt[valid].sum() == cnt.sum()  # every painted value grouped


def test_sparse_recon_shell_and_accuracy():
    g = graph_from_adjacency(torus_adjacency(8))
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2, alpha=0.1,
        is_glauber_recons=False, dtype=jnp.float64, seed=5,
    )
    rec.train_dict()
    # dense and sparse shells draw different chain keys; compare the
    # accuracy statistic at converged sampling instead
    dense = rec.reconstruct_network(recons_iter=4000, sparse=False)
    acc_dense = rec.compute_recons_accuracy()
    edges = rec.reconstruct_network(recons_iter=4000, sparse=True)
    acc_sparse = rec.compute_recons_accuracy()
    assert edges.shape[1] == 2
    assert (edges[:, 0] < edges[:, 1]).all()
    assert abs(acc_dense - acc_sparse) < 0.15
    assert acc_sparse > 0.5


def test_edges_from_sparse_result_beyond_uint32_packing():
    """Edge decode above the 65,536-node uint32-packing bound must take
    the prefix-fetch path and decode exactly (the packed path would wrap
    i*n+j mod 2^32 and fabricate phantom edges — review finding)."""
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.network import _edges_from_sparse_result

    n = 70000
    # segment-style result: real segments in a prefix, padding after
    ii = jnp.asarray([69999, 69999, 123, 8643, 0, 0], jnp.int32)
    jj = jnp.asarray([69999, 69998, 456, 22703, 0, 0], jnp.int32)
    mean = jnp.asarray([1.0, 0.9, 0.2, 1.0, 0.0, 0.0])
    cnt = jnp.asarray([2.0, 1.0, 3.0, 1.0, 0.0, 0.0])
    edges = _edges_from_sparse_result(ii, jj, mean, cnt, n)
    # kept: (69999,69999) self-pair dropped; (69998,69999) kept;
    # (123,456) mean rounds to 0 -> dropped; (8643,22703) kept
    np.testing.assert_array_equal(
        edges, np.asarray([[8643, 22703], [69998, 69999]]))

    # the packed path below the bound produces identical decisions
    edges_small = _edges_from_sparse_result(
        jnp.asarray([100, 5, 7, 0], jnp.int32),
        jnp.asarray([200, 5, 3, 0], jnp.int32),
        jnp.asarray([1.2, 1.0, 0.1, 0.0]),
        jnp.asarray([1.0, 2.0, 1.0, 0.0]), 300)
    np.testing.assert_array_equal(edges_small,
                                  np.asarray([[100, 200]]))


def test_group_painted_both_sort_paths():
    """_group_painted (fused uint32 single-key sort for n <= 65536,
    two-key payload sort beyond) groups identically to a NumPy
    reference groupby, with real segments in a contiguous prefix."""
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.network import _group_painted

    rng = np.random.default_rng(3)
    M, k = 200, 3
    e_np = rng.integers(0, 40, size=(M, k))
    # include the last representable node: at n = 65536 the pair
    # (65535, 65535) packs to the all-ones uint32 — the exact fused-key
    # boundary (and _pack_recon_edges' sentinel value)
    e_np[:2] = 65535
    embs = jnp.asarray(e_np, jnp.int32)
    vals_T = jnp.asarray(rng.random((k * k, M)))

    def np_group(n):
        e = np.asarray(embs)
        ii = np.broadcast_to(e.T[:, None, :], (k, k, M)).reshape(-1)
        jj = np.broadcast_to(e.T[None, :, :], (k, k, M)).reshape(-1)
        vv = np.asarray(vals_T).reshape(-1)
        out = {}
        for a, b, v in zip(ii, jj, vv):
            s, c = out.get((a, b), (0.0, 0))
            out[(a, b)] = (s + v, c + 1)
        return out

    for n in (65_536, 70_000):    # fused path at its boundary / two-key
        oi, oj, sums, cnt = _group_painted(embs, vals_T, n)
        oi, oj = np.asarray(oi), np.asarray(oj)
        sums, cnt = np.asarray(sums), np.asarray(cnt)
        n_seg = int((cnt > 0).sum())
        # contiguous prefix of real segments
        assert (cnt[:n_seg] > 0).all() and (cnt[n_seg:] == 0).all()
        expected = np_group(n)
        got = {(int(a), int(b)): (float(s), int(c)) for a, b, s, c in
               zip(oi[:n_seg], oj[:n_seg], sums[:n_seg], cnt[:n_seg])}
        assert set(got) == set(expected)
        for pair, (s, c) in expected.items():
            gs, gc = got[pair]
            assert gc == c
            np.testing.assert_allclose(gs, s, rtol=1e-12)


def test_csr_graph_ndl_end_to_end():
    """NetworkReconstructor over a CsrGraph: train + sparse
    reconstruction + accuracy, the O(E)-memory path for million-node
    low-degree graphs (tiny torus here)."""
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges

    m = 16
    edges = []
    for i in range(m):
        for j in range(m):
            u = i * m + j
            edges.append((u, ((i + 1) % m) * m + j))
            edges.append((u, i * m + (j + 1) % m))
    g = csr_graph_from_edges(edges)
    assert g.num_nodes == 256 and g.max_deg == 4

    rec = NetworkReconstructor(source=g, n_components=16,
                               MCMC_iterations=12, sub_iterations=20,
                               sample_size=200, batch_size=50, k1=0,
                               k2=2, num_chains=8, fast=True, seed=0)
    rec.train_dict()
    edges_out = rec.reconstruct_network(recons_iter=20000, num_chains=64)
    assert edges_out.ndim == 2 and edges_out.shape[1] == 2
    acc = float(rec.compute_recons_accuracy())
    assert acc > 0.9

    # has_edge agrees with the true torus structure on the found edges
    he = rec.has_edge(edges_out[:, 0], edges_out[:, 1])
    assert he.mean() > 0.9


def test_group_painted_include_self_matches_off_diagonal():
    """include_self=False must reproduce exactly the off-diagonal
    segments of the full grouping (self-pair slots dropped, nothing
    else changed) on both sort paths."""
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.network import _group_painted

    rng = np.random.default_rng(7)
    M, k = 150, 3
    embs = jnp.asarray(rng.integers(0, 30, size=(M, k)), jnp.int32)
    vals_T = jnp.asarray(rng.random((k * k, M)))

    for n in (30, 70_000):        # fused uint32 path / two-key path
        fi, fj, fs, fc = (np.asarray(a) for a in
                          _group_painted(embs, vals_T, n))
        oi, oj, os_, oc = (np.asarray(a) for a in
                           _group_painted(embs, vals_T, n,
                                          include_self=False))
        assert oi.shape[0] == M * k * (k - 1)
        full = {(int(a), int(b)): (float(s), int(c))
                for a, b, s, c in zip(fi, fj, fs, fc) if c > 0}
        # the full grouping mixes self and non-self paints of the SAME
        # (u, u) pair only when a sample maps two motif nodes to one
        # graph node — reconstruct the expected off-diag content from
        # scratch instead of filtering `full`
        e = np.asarray(embs)
        expected = {}
        for q in range(k):
            for r in range(k):
                if q == r:
                    continue
                for m in range(M):
                    pair = (int(e[m, q]), int(e[m, r]))
                    s, c = expected.get(pair, (0.0, 0))
                    expected[pair] = (
                        s + float(np.asarray(vals_T)[q * k + r, m]), c + 1)
        n_seg = int((oc > 0).sum())
        assert (oc[:n_seg] > 0).all() and (oc[n_seg:] == 0).all()
        got = {(int(a), int(b)): (float(s), int(c)) for a, b, s, c in
               zip(oi[:n_seg], oj[:n_seg], os_[:n_seg], oc[:n_seg])}
        assert set(got) == set(expected)
        for pair, (s, c) in expected.items():
            gs, gc = got[pair]
            assert gc == c
            np.testing.assert_allclose(gs, s, rtol=1e-6)
        # and every off-diag pair that exists in the full grouping with
        # only off-diag paints must agree exactly
        for pair, (s, c) in expected.items():
            if pair in full and pair[0] != pair[1]:
                assert full[pair][1] >= c


def test_csr_pad_table_paths_identical():
    """The padded nbr_pad_T fast path must produce identical chain
    draws and identical patch matrices to the CSR-triple path (same
    graph with the table stripped)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers.motif import (
        glauber_update, pair_matrices_T, path_adj, tree_parents,
        tree_sample)

    rng = np.random.default_rng(11)
    # irregular low-degree graph (varying degrees exercise the padding)
    edges = set()
    n = 60
    for _ in range(140):
        a, b = rng.integers(0, n, 2)
        if a != b:
            edges.add((min(a, b), max(a, b)))
    g = csr_graph_from_edges(sorted(edges))
    assert g.nbr_pad_T is not None
    g0 = dataclasses.replace(g, nbr_pad_T=None)
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges
    gb = bitset_graph_from_edges(sorted(edges))
    assert gb.nbr_pad_T is not None
    gb0 = dataclasses.replace(gb, nbr_pad_T=None)

    B = path_adj(0, 2)
    parents = tree_parents(B)
    emb = tree_sample(jax.random.key(1), parents, g, jnp.int32(0))
    embv = {id(gg): emb for gg in (g, g0, gb, gb0)}
    for s in range(300):
        kk = jax.random.fold_in(jax.random.key(2), s)
        for gg in (g, g0, gb, gb0):
            embv[id(gg)] = glauber_update(kk, B, parents, gg, embv[id(gg)])
    ref = np.asarray(embv[id(g0)])
    for gg in (g, gb, gb0):
        np.testing.assert_array_equal(np.asarray(embv[id(gg)]), ref)

    embs = jnp.asarray(rng.integers(0, g.num_nodes, size=(50, B.shape[0])),
                       jnp.int32)
    pref = np.asarray(pair_matrices_T(g0, embs))
    for gg in (g, gb, gb0):
        np.testing.assert_array_equal(np.asarray(pair_matrices_T(gg, embs)),
                                      pref)


def test_chunked_sparse_recon_fold_and_end_to_end():
    """The chunked reconstruction's fold must merge grouped (sum, cnt)
    segments exactly (numpy groupby oracle), the end-to-end chunked
    path must reach unchunked-level accuracy, and an undersized
    accumulator must raise rather than truncate."""
    import jax
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.network import (
        _fold_grouped, _group_painted, reconstruct_network_sparse_chunked)
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges

    # --- fold exactness: two painted batches grouped separately then
    # folded == one batch grouped (same multiset of paints)
    rng = np.random.default_rng(5)
    M, k, n = 120, 3, 40
    embs = jnp.asarray(rng.integers(0, n, size=(2 * M, k)), jnp.int32)
    vals = jnp.asarray(rng.random((k * k, 2 * M)))
    a = _group_painted(embs[:M], vals[:, :M], n, include_self=False)
    b = _group_painted(embs[M:], vals[:, M:], n, include_self=False)
    cap = 2 * a[0].shape[0]      # > the distinct-pair count (898 here)
    acc = (jnp.zeros((cap,), jnp.int32), jnp.zeros((cap,), jnp.int32),
           jnp.zeros((cap,)), jnp.zeros((cap,)))
    *acc, _ = _fold_grouped(*acc, *a)
    fi, fj, fs, fc, n_real = _fold_grouped(*acc, *b)
    whole_i, whole_j, whole_s, whole_c = (
        np.asarray(x) for x in _group_painted(embs, vals, n,
                                              include_self=False))
    want = {(int(i), int(j)): (float(s), float(c)) for i, j, s, c in
            zip(whole_i, whole_j, whole_s, whole_c) if c > 0}
    fi, fj, fs, fc = (np.asarray(x) for x in (fi, fj, fs, fc))
    got = {(int(i), int(j)): (float(s), float(c)) for i, j, s, c in
           zip(fi, fj, fs, fc) if c > 0}
    assert int(n_real) == len(want) == len(got)
    assert set(got) == set(want)
    for pair, (s, c) in want.items():
        gs, gc = got[pair]
        assert gc == c
        np.testing.assert_allclose(gs, s, rtol=1e-6)
    # real segments occupy a prefix
    nz = int((fc > 0).sum())
    assert (fc[:nz] > 0).all() and (fc[nz:] == 0).all()

    # --- end to end: chunked reconstruction reaches unchunked-level
    # accuracy on a small torus
    m = 16
    edges = []
    for i in range(m):
        for j in range(m):
            u = i * m + j
            edges.append((u, ((i + 1) % m) * m + j))
            edges.append((u, i * m + (j + 1) % m))
    g = csr_graph_from_edges(edges)
    rec = NetworkReconstructor(source=g, n_components=16,
                               MCMC_iterations=12, sub_iterations=20,
                               sample_size=200, batch_size=50, k1=0,
                               k2=2, num_chains=8, fast=True, seed=0)
    rec.train_dict()
    edges_out = rec.reconstruct_network(recons_iter=24000, num_chains=32,
                                        chunks=3)
    acc3 = float(rec.compute_recons_accuracy())
    assert acc3 > 0.9

    # --- undersized accumulator raises, never truncates
    import pytest
    with pytest.raises(ValueError, match="accumulator"):
        reconstruct_network_sparse_chunked(
            rec.state.W, g, jax.random.key(1), rec._B_bytes,
            rec._parents, recons_iter=6000, chunks=2, cap=64,
            use_glauber=True, num_chains=32)

    # dense path refuses chunks
    with pytest.raises(ValueError, match="sparse"):
        rec.reconstruct_network(recons_iter=100, chunks=2, sparse=False)


def test_pad_table_device_build_and_k1_and_cap(monkeypatch):
    """Review-finding regressions: (a) the device-built pad table equals
    the host-built one (incl. zero-degree rows); (b) k=1 motifs
    reconstruct through the sparse edges path (include_self=False used
    to crash on empty float64 indexers); (c) the chunked default cap
    accounts for the per-chunk budget ROUNDING to whole chains."""
    import jax
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.data import graphs as G
    from onmf_ontf_ndl_tpu.apps.network import (
        reconstruct_network_sparse_chunked)

    # (a) device build == host build, with an isolated (degree-0) node
    edges = [(0, 1), (0, 2), (1, 2), (3, 4), (5, 0)]
    # label 6 never appears; use a graph with a zero-degree row by
    # interning a node via a self-loop-free trick: intern order keeps
    # first appearance, so add (6, 0) then remove? Instead: degree
    # skew suffices (node 3 deg 1 vs node 0 deg 3)
    g_host = G.csr_graph_from_edges(edges)
    monkeypatch.setattr(G, "_PAD_DEVICE_BUILD_BYTES", 1)
    g_dev = G.csr_graph_from_edges(edges)
    np.testing.assert_array_equal(np.asarray(g_host.nbr_pad_T),
                                  np.asarray(g_dev.nbr_pad_T))

    # (b) k=1 motif end-to-end through the sparse edges path
    m = 8
    tor = [(i * m + j, ((i + 1) % m) * m + j) for i in range(m)
           for j in range(m)] + \
          [(i * m + j, i * m + (j + 1) % m) for i in range(m)
           for j in range(m)]
    g = G.csr_graph_from_edges(tor)
    rec = NetworkReconstructor(source=g, n_components=4,
                               MCMC_iterations=3, sub_iterations=5,
                               sample_size=50, batch_size=10, k1=0,
                               k2=0, num_chains=4, fast=True, seed=0)
    rec.train_dict()
    edges_out = rec.reconstruct_network(recons_iter=500, num_chains=8)
    assert edges_out.shape[1] == 2       # empty or not: no crash
    # a 1-node motif paints only self-pairs -> no undirected edges
    assert len(edges_out) == 0

    # (c) wide ensembles: rounded per-chunk budget must not overflow
    # the default cap (nominal per_chunk = 100 << num_chains = 256)
    rec2 = NetworkReconstructor(source=g, n_components=9,
                                MCMC_iterations=3, sub_iterations=5,
                                sample_size=50, batch_size=10, k1=0,
                                k2=1, num_chains=4, fast=True, seed=0)
    rec2.train_dict()
    ii, jj, mean, cnt = reconstruct_network_sparse_chunked(
        rec2.state.W, g, jax.random.key(3), rec2._B_bytes,
        rec2._parents, recons_iter=200, chunks=2, num_chains=256,
        use_glauber=True)
    assert int((np.asarray(cnt) > 0).sum()) > 0


def test_bitonic_merge_fold_property():
    """Property test of the fold's bitonic merge network: random SORTED
    grouped inputs of awkward (non-power-of-two) sizes with heavy key
    duplication across inputs must fold to the exact NumPy groupby."""
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.network import _fold_grouped

    rng = np.random.default_rng(17)
    # caps exceed the worst-case union (<= 100 real segments): the raw
    # fold truncates past cap by contract (the API wrapper raises)
    for cap, L, nkeys in ((101, 91, 25), (128, 100, 60), (513, 1023, 64),
                          (4096, 8191, 2000)):  # multi-stage + row sort
        def sorted_grouped(slots, n_real):
            keys = rng.integers(0, nkeys, size=(n_real, 2))
            keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
            # dedup within one grouped input (segments are unique)
            _, first = np.unique(keys[:, 0] * 1000 + keys[:, 1],
                                 return_index=True)
            keys = keys[np.sort(first)]
            r = len(keys)
            ii = np.zeros(slots, np.int32)
            jj = np.zeros(slots, np.int32)
            ss = np.zeros(slots)
            cc = np.zeros(slots)
            ii[:r], jj[:r] = keys[:, 0], keys[:, 1]
            ss[:r] = rng.random(r)
            cc[:r] = rng.integers(1, 5, r)
            return (jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(ss),
                    jnp.asarray(cc))

        a = sorted_grouped(cap, min(cap, 30))
        c = sorted_grouped(L, min(L, 70))
        # snapshot before the fold: the accumulator args are DONATED
        want = {}
        for t in (a, c):
            i_, j_, s_, c_ = (np.asarray(x) for x in t)
            for iv, jv, sv, cv in zip(i_, j_, s_, c_):
                if cv > 0:
                    ps, pc = want.get((iv, jv), (0.0, 0.0))
                    want[(iv, jv)] = (ps + sv, pc + cv)
        fi, fj, fs, fc, n_real = _fold_grouped(*a, *c)
        fi, fj, fs, fc = (np.asarray(x) for x in (fi, fj, fs, fc))
        got = {(int(i), int(j)): (float(s), float(c)) for i, j, s, c in
               zip(fi, fj, fs, fc) if c > 0}
        assert int(n_real) == len(want)
        assert set(got) == set(want)
        for pair, (s, c_) in want.items():
            np.testing.assert_allclose(got[pair][0], s, rtol=1e-9)
            assert got[pair][1] == c_
        # output keys ascending over the real prefix (the next fold's
        # bitonic precondition)
        nz = int((fc > 0).sum())
        kk = fi[:nz].astype(np.int64) * 10**6 + fj[:nz]
        assert (np.diff(kk) > 0).all()

        # out_len widening (the adaptive-accumulator growth step):
        # identical reals, pre-truncation n_real, padded tail. The
        # returned width is min(out_len, merged width): the exact-width
        # full-sort path (taken when power-of-two padding would exceed
        # 25% — the heavy-tail fold's memory guard) merges at cap+L slots
        # and the [:out_len] slice clamps; the caller re-derives the
        # accumulator length from the returned arrays either way
        a2 = sorted_grouped(cap, min(cap, 30))
        c2 = sorted_grouped(L, min(L, 70))
        wide = 1 << (cap + L - 1).bit_length()
        gi, gj, gs, gc, n2 = _fold_grouped(*a2, *c2, out_len=wide)
        total = cap + L
        t_pow2 = 1 << (total - 1).bit_length()
        merged_w = total if t_pow2 > total + (total >> 2) else t_pow2
        assert gi.shape[0] == min(wide, merged_w)
        gc = np.asarray(gc)
        nz2 = int((gc > 0).sum())
        assert nz2 == int(n2) and (gc[nz2:] == 0).all()


def test_edge_fetch_mask_path_matches_pair_path(monkeypatch):
    """>65,536-node edge decode via the CSR-slot bitmask (host-CSR
    retained by the builders) must return exactly the explicit-pair
    path's edges — true edges, non-edge extras, self-pairs, rounding
    drops, and padding all covered. (The mask path engages only past a
    fetch-size threshold in production; force it here.)"""
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps import network as net
    from onmf_ontf_ndl_tpu.apps.network import _edges_from_sparse_result
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges, host_csr

    monkeypatch.setattr(net, "_MASK_FETCH_BYTES", 0)

    m = 260                           # 67,600 nodes > the uint32 bound
    edges = []
    for i in range(m):
        for j in range(m):
            u = i * m + j
            edges.append((u, ((i + 1) % m) * m + j))
            edges.append((u, i * m + (j + 1) % m))
    g = csr_graph_from_edges(edges)
    assert host_csr(g) is not None
    n = g.num_nodes

    rng = np.random.default_rng(23)
    # synthetic grouped result: some true edges (both orientations),
    # some non-edges, a self-pair, sub-threshold means, padding
    e = np.asarray(edges[:300])
    ii = np.concatenate([e[:, 0], e[:, 1],
                         rng.integers(0, n, 40), [5, 7], [0] * 10])
    jj = np.concatenate([e[:, 1], e[:, 0],
                         rng.integers(0, n, 40), [5, 9], [0] * 10])
    total = len(ii)
    mean = np.ones(total); mean[600:640:2] = 0.3   # some extras dropped
    mean[-10:] = 0.0
    cnt = np.ones(total); cnt[-10:] = 0.0          # padding slots
    args = (jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
            jnp.asarray(mean), jnp.asarray(cnt), n)
    got_mask = _edges_from_sparse_result(*args, g=g)
    got_pairs = _edges_from_sparse_result(*args)       # no g: pair path
    np.testing.assert_array_equal(got_mask, got_pairs)
    assert len(got_mask) > 300     # the true edges survived

    # heavy-tailed variant: a >65,536-node graph with a dominant hub —
    # the slot lookup must route through the degree-independent
    # membership kernels (the old (size, max_deg) row gather was
    # byte-gated off exactly here) and still match the pair path
    hub_e = [(0, v) for v in range(1, 70_001)] \
        + [(v, v + 1) for v in range(3000, 3300)]
    gh = csr_graph_from_edges(hub_e)
    nh = gh.num_nodes
    assert nh > 65536 and gh.max_deg == 70_000
    he = np.asarray(hub_e[:600])
    hii = np.concatenate([he[:, 0], he[:, 1], rng.integers(0, nh, 64)])
    hjj = np.concatenate([he[:, 1], he[:, 0], rng.integers(0, nh, 64)])
    hmean = np.ones(len(hii))
    hcnt = np.ones(len(hii))
    hargs = (jnp.asarray(hii, jnp.int32), jnp.asarray(hjj, jnp.int32),
             jnp.asarray(hmean), jnp.asarray(hcnt), nh)
    np.testing.assert_array_equal(
        _edges_from_sparse_result(*hargs, g=gh),
        _edges_from_sparse_result(*hargs))


def test_heavy_tail_ba_ndl_end_to_end():
    """End-to-end NDL on a small Barabási–Albert (power-law) CsrGraph:
    hub rows exceed the binary-search threshold, so this drives the
    skewed-degree kernel-selection path through train (Glauber) +
    pivot-chain reconstruction — the reference's recommended
    real-network configuration (network_reconstruction_nx.py:573-574).
    The reconstruction must recover a solid majority of the edges."""
    import os
    import sys

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks"))
    from scale_extras import ba_edges

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.samplers import motif

    edges = ba_edges(5000, 2, seed=0)
    g = csr_graph_from_edges(edges)
    assert g.max_deg > motif._BSEARCH_DEG_THRESHOLD  # genuine hub regime
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=30, sub_iterations=20,
        sample_size=200, batch_size=50, k1=0, k2=2, num_chains=8,
        fast=True, seed=0, is_glauber_recons=False)
    rec.train_dict()
    W = np.asarray(rec.W)
    assert np.isfinite(W).all() and (W >= 0).all()
    rec.reconstruct_network(recons_iter=60000, num_chains=256)
    acc = float(rec.compute_recons_accuracy())
    assert acc > 0.6, acc


def test_partitioned_fold_matches_single_accumulator(monkeypatch):
    """The key-range-partitioned fold (the memory guard that lifts the
    16.7M-node heavy-tail budget cap: sort scratch ~2x a PART instead
    of 2x the whole accumulator) must produce exactly the same
    per-pair (mean, cnt) map as the single-accumulator path on the
    same key."""
    import jax
    from onmf_ontf_ndl_tpu.apps.network import (
        reconstruct_network_sparse_chunked)
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges

    m = 16
    edges = []
    for i in range(m):
        for j in range(m):
            u = i * m + j
            edges.append((u, ((i + 1) % m) * m + j))
            edges.append((u, i * m + (j + 1) % m))
    g = csr_graph_from_edges(edges)
    rec = NetworkReconstructor(source=g, n_components=16,
                               MCMC_iterations=6, sub_iterations=10,
                               sample_size=100, batch_size=50, k1=0,
                               k2=2, num_chains=8, fast=True, seed=0)
    rec.train_dict()
    key = jax.random.key(7)
    kw = dict(recons_iter=12000, chunks=4, use_glauber=True,
              num_chains=32)
    base = reconstruct_network_sparse_chunked(
        rec.state.W, g, key, rec._B_bytes, rec._parents,
        fold_parts=1, **kw)
    # force activation after the first fold (the bucket floor is 1024)
    monkeypatch.setenv("ONMF_FOLD_PART_AT", "1024")
    part = reconstruct_network_sparse_chunked(
        rec.state.W, g, key, rec._B_bytes, rec._parents,
        fold_parts=4, **kw)

    def as_map(ii, jj, mean, cnt):
        ii, jj, mean, cnt = (np.asarray(x) for x in (ii, jj, mean, cnt))
        return {(int(i), int(j)): (float(v), float(c))
                for i, j, v, c in zip(ii, jj, mean, cnt) if c > 0}

    want, got = as_map(*base), as_map(*part)
    assert set(want) == set(got) and len(want) > 100
    for pair, (v, c) in want.items():
        gv, gc = got[pair]
        assert gc == c
        np.testing.assert_allclose(gv, v, rtol=1e-10)
