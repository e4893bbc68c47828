"""Native C++ graph loader vs the pure-Python ingest path."""

import os
import time

import numpy as np
import pytest

from onmf_ontf_ndl_tpu.data.graphs import graph_from_edgelist, load_edgelist
from onmf_ontf_ndl_tpu.data.native import native_available, load_edgelist_native

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no C++ toolchain")


def write_edges(tmp_path, edges):
    p = tmp_path / "edges.txt"
    p.write_text("\n".join(f"{a},{b}" for a, b in edges) + "\n")
    return str(p)


def test_native_matches_python(tmp_path):
    rng = np.random.default_rng(11)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, 200, (2000, 2))
             if a != b]
    path = write_edges(tmp_path, edges)

    g_native = load_edgelist(path, use_native="always")
    g_py = graph_from_edgelist(np.asarray(edges))

    assert g_native.node_ids == g_py.node_ids
    np.testing.assert_array_equal(np.asarray(g_native.adj),
                                  np.asarray(g_py.adj))
    np.testing.assert_array_equal(np.asarray(g_native.deg),
                                  np.asarray(g_py.deg))
    # neighbor rows are sorted in both paths -> exact equality
    nb_n = np.asarray(g_native.nbr)
    nb_p = np.asarray(g_py.nbr)
    deg = np.asarray(g_py.deg)
    for i in range(g_py.num_nodes):
        np.testing.assert_array_equal(nb_n[i, :deg[i]], nb_p[i, :deg[i]])


def test_native_dedupes_and_drops_self_loops(tmp_path):
    path = write_edges(tmp_path, [(1, 2), (2, 1), (1, 2), (3, 3), (2, 4)])
    g = load_edgelist(path, use_native="always")
    assert g.num_edges == 2
    assert np.asarray(g.deg).tolist() == [1, 2, 0, 1]
    assert g.node_ids == (1, 2, 3, 4)


def test_native_skips_comments_and_rejects_floats(tmp_path):
    p = tmp_path / "snap.txt"
    p.write_text("# Nodes: 5 Edges: 4\n1,2\n2,3\n")
    g = load_edgelist(str(p), use_native="always")
    assert g.node_ids == (1, 2, 3)
    assert g.num_edges == 2

    p2 = tmp_path / "weighted.txt"
    p2.write_text("0,1,0.5\n1,2,0.25\n")
    with pytest.raises(RuntimeError, match="integer tokens"):
        load_edgelist_native(str(p2))


def test_native_missing_file():
    with pytest.raises(RuntimeError, match="cannot open"):
        load_edgelist_native("/nonexistent/file.txt")


def test_native_on_reference_facebook_graph():
    # the big reference graph: the native PARSE must be fast and agree on
    # summary stats (device transfer is excluded — it is orthogonal to
    # the loader)
    path = "/root/reference/Data/Networks/facebook_combined.txt"
    if not os.path.exists(path):
        pytest.skip("the reference checkout's data is not present")
    t0 = time.perf_counter()
    adj, nbr, deg, node_ids = load_edgelist_native(path)
    dt = time.perf_counter() - t0
    assert adj.shape == (4039, 4039)
    assert int(deg.sum()) // 2 == 88234
    assert dt < 5.0


def test_native_rejects_integer_weight_columns(tmp_path):
    """3-column INTEGER files must error (stream-wise token pairing
    previously built a silently wrong graph)."""
    p = tmp_path / "intweights.txt"
    p.write_text("0,1,5\n1,2,7\n")
    with pytest.raises(RuntimeError, match="integer tokens"):
        load_edgelist(str(p), use_native="always")


def test_python_fallback_accepts_whitespace_delimited(tmp_path):
    """'auto' must behave the same with or without the native parser:
    the Python fallback retries whitespace-delimited files."""
    p = tmp_path / "snap_space.txt"
    p.write_text("0 1\n1 2\n")
    g = load_edgelist(str(p), use_native="never")
    assert g.num_edges == 2 and g.node_ids == (0, 1, 2)


def test_native_csr_builder_matches_numpy():
    """The C++ in-memory CSR builder (gl_csr_from_edges) must produce
    byte-identical arrays to the NumPy packed-key path: same
    first-appearance interning, dedup, per-row-ascending CSR."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    from onmf_ontf_ndl_tpu.data.graphs import _host_csr_build

    rng = np.random.default_rng(3)
    # arbitrary labels incl. negatives, duplicates both ways, self-loops
    labels = np.concatenate([rng.integers(-50, 50, 300),
                             rng.integers(10**9, 10**9 + 40, 100)])
    e = rng.choice(labels, (2000, 2))
    e = np.concatenate([e, e[:, ::-1][:200], np.stack([labels[:30]] * 2, 1)])
    got = _host_csr_build(e, use_native="always")
    want = _host_csr_build(e, use_native="never")
    for g_, w_, name in zip(got, want,
                            ("dst", "offsets", "deg", "node_ids", "max_deg")):
        np.testing.assert_array_equal(np.asarray(g_), np.asarray(w_),
                                      err_msg=name)
    assert got[0].dtype == np.int32 and got[3].dtype == np.int64


def test_native_csr_builder_through_graph_builders():
    """csr/bitset builders with use_native forced both ways agree on
    every graph field."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    from onmf_ontf_ndl_tpu.data.graphs import (bitset_graph_from_edges,
                                               csr_graph_from_edges)

    edges = [(i, (i + 1) % 40) for i in range(40)] + [(0, j) for j in
                                                      range(5, 15)]
    ga = csr_graph_from_edges(np.asarray(edges), use_native="always")
    gb = csr_graph_from_edges(np.asarray(edges), use_native="never")
    assert ga.node_ids == gb.node_ids and ga.max_deg == gb.max_deg
    np.testing.assert_array_equal(np.asarray(ga.nbr_flat),
                                  np.asarray(gb.nbr_flat))
    np.testing.assert_array_equal(np.asarray(ga.offsets),
                                  np.asarray(gb.offsets))
    np.testing.assert_array_equal(np.asarray(ga.nbr_pad_T),
                                  np.asarray(gb.nbr_pad_T))
    ba = bitset_graph_from_edges(np.asarray(edges), use_native="always")
    bb = bitset_graph_from_edges(np.asarray(edges), use_native="never")
    np.testing.assert_array_equal(np.asarray(ba.bits), np.asarray(bb.bits))
    np.testing.assert_array_equal(np.asarray(ba.nbr_flat),
                                  np.asarray(bb.nbr_flat))


def test_csr_cache_roundtrip(tmp_path):
    """cache_dir: second build loads the npz (same arrays) instead of
    re-running the host build."""
    import os

    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges

    edges = np.asarray([(i, (i + 1) % 25) for i in range(25)])
    g1 = csr_graph_from_edges(edges, cache_dir=str(tmp_path))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 1
    g2 = csr_graph_from_edges(edges, cache_dir=str(tmp_path))
    assert g1.node_ids == g2.node_ids and g1.max_deg == g2.max_deg
    np.testing.assert_array_equal(np.asarray(g1.nbr_flat),
                                  np.asarray(g2.nbr_flat))
    np.testing.assert_array_equal(np.asarray(g1.offsets),
                                  np.asarray(g2.offsets))
    # a different edge set gets a different cache key
    g3 = csr_graph_from_edges(edges[:-1], cache_dir=str(tmp_path))
    assert g3.num_edges == g1.num_edges - 1
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".npz")]) == 2
