"""Direct parity against the reference's OWN code, part 2.

``test_reference_parity.py`` covers ``src/onmf.py``; this file extends
the direct-comparison evidence to the remaining reference modules:

- ``src/ontf.py``: the ONTF dictionary update and the full ``step``
  (with the sklearn coder injection point held fixed, so the
  transposed-code aggregate convention ``A1 = H^T H`` / ``B1 = H^T X^T``
  of ``src/ontf.py:147-148`` is compared number-for-number);
- ``ising_simulator.py``: ``hamiltonian`` and ``deltaE``;
- ``network_reconstruction_nx.py``: ``path_adj``, ``find_parent``, the
  ``chd_gen_mx`` patch construction, and the one-step law of
  ``glauber_gen_update`` (reference empirical vs the exact conditional
  law, and our sampler empirical vs the same law).

``src/ontf.py`` / ``ising_simulator.py`` import packages absent from
this environment (``tensorly``, ``progressbar``); minimal module stubs
are installed in ``sys.modules`` before import.  None of the stubbed
symbols are exercised by these tests.
"""

import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF, "src", "onmf.py")),
    reason="reference checkout not mounted")


def _install_stubs():
    """Shared stubs (benchmarks/refstubs.py): callable ProgressBar so the
    ising e2e harness and this module agree regardless of import order."""
    bench_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import refstubs
    finally:
        sys.path.remove(bench_dir)
    refstubs.install_stubs()


@pytest.fixture(scope="module")
def ref():
    """Namespace with the reference ontf / ising / network modules."""
    _install_stubs()
    sys.path.insert(0, REF)
    try:
        from src import ontf
        import ising_simulator
        import network_reconstruction_nx as network
        yield types.SimpleNamespace(ontf=ontf, ising=ising_simulator,
                                    network=network)
    finally:
        sys.path.remove(REF)


RNG = np.random.default_rng(7)


# --------------------------------------------------------------- ONTF

def test_ontf_update_dict_matches_reference(ref):
    """src/ontf.py:91-115 duplicates the onmf BCD update; prove our
    single dict_update_bcd matches this copy too."""
    from onmf_ontf_ndl_tpu.ops.dict_update import dict_update_bcd

    d, r = 18, 7
    W = RNG.random((d, r))
    H = RNG.random((r, 40))
    A = H @ H.T
    B = H @ RNG.random((40, d))
    obj = ref.ontf.Online_NTF(RNG.random((4, 5, 3)), n_components=r)
    want = obj.update_dict(W.copy(), A.copy(), B.copy())
    got = np.asarray(dict_update_bcd(jnp.asarray(W), jnp.asarray(A),
                                     jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_ontf_step_matches_reference_with_injected_code(ref):
    """Full src/ontf.py:117-154 step vs our onmf_step, with the sklearn
    coder replaced by a fixed H on the reference side and the same H
    injected on ours (H0 given, sub_iter=0): the transposed aggregate
    convention, the t^-beta weighting, and the stale dictionary update
    must agree number-for-number."""
    import dataclasses
    from onmf_ontf_ndl_tpu.models.onmf import onmf_step
    from onmf_ontf_ndl_tpu.models.state import init_state

    d, r, n = 12, 6, 20
    X = RNG.random((d, n))
    W = RNG.random((d, r))
    Hf = RNG.random((r, n))          # fixed code, (topics, samples)
    A0 = np.eye(r) + 0.1 * RNG.random((r, r))
    A0 = 0.5 * (A0 + A0.T)
    B0 = RNG.random((r, d))
    beta, t = 0.8, 5.0

    obj = ref.ontf.Online_NTF(RNG.random((4, 5, 3)), n_components=r,
                              beta=beta)
    obj.joint_sparse_code_tensor = lambda X_, W_: Hf.T  # samples x topics
    H1, A1, B1, W1 = obj.step(X.copy(), A0.copy(), B0.copy(), W.copy(),
                              np.float64(t))

    state = init_state(jax.random.key(0), d, r,
                       W=jnp.asarray(W), A=jnp.asarray(A0),
                       B=jnp.asarray(B0), dtype=jnp.float64)
    st, H = onmf_step(state, jnp.asarray(X), t=t, H0=jnp.asarray(Hf),
                      beta=beta, sub_iter=0, stopping_diff=None,
                      dict_from="stale", backend="xla")

    np.testing.assert_allclose(np.asarray(H), H1.T, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(st.A), A1, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st.B), B1, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st.W), W1, rtol=1e-12)


# -------------------------------------------------------------- Ising

def test_hamiltonian_matches_reference(ref):
    from onmf_ontf_ndl_tpu.samplers.ising import hamiltonian

    for seed, (J, H) in enumerate([(1.0, 0.0), (0.7, -0.3), (2.0, 1.5)]):
        lat = np.random.default_rng(seed).choice([-1, 1], size=(6, 6))
        want = ref.ising.hamiltonian(lat, J, H)
        got = float(hamiltonian(jnp.asarray(lat, jnp.float64), J, H))
        # our hamiltonian computes in f32 by design
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_delta_e_matches_reference(ref):
    from onmf_ontf_ndl_tpu.samplers.ising import delta_e

    for s0 in (-1.0, 1.0):
        for sn in range(-4, 5):
            for (J, H) in [(1.0, 0.0), (0.5, 2.0)]:
                want = ref.ising.deltaE(s0, float(sn), J, H)
                got = float(delta_e(s0, float(sn), J, H))
                np.testing.assert_allclose(got, want, rtol=1e-15)


# ------------------------------------------------------------ Network

def _ref_reconstructor(ref, nx_graph):
    """Reference Network_Reconstructor with only .G set (its __init__
    does file ingest we don't need for the sampler methods)."""
    cls = ref.network.Network_Reconstructor
    obj = cls.__new__(cls)
    obj.G = nx_graph
    return obj


def _small_graph(n=10, p=0.45, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < p
    A = np.triu(A, 1)
    A = A | A.T
    A |= np.eye(n, k=1, dtype=bool) | np.eye(n, k=-1, dtype=bool)  # connected
    A[0, -1] = A[-1, 0] = True
    return A


def test_path_adj_matches_reference(ref):
    from onmf_ontf_ndl_tpu.samplers.motif import path_adj

    obj = _ref_reconstructor(ref, None)
    for k1, k2 in [(0, 1), (0, 3), (1, 1), (1, 2), (2, 3), (3, 2), (0, 0)]:
        want = obj.path_adj(k1, k2)
        got = path_adj(k1, k2)
        assert got.shape == want.shape and (got == want).all(), (k1, k2)


def test_tree_parents_match_reference_find_parent(ref):
    from onmf_ontf_ndl_tpu.samplers.motif import path_adj, tree_parents

    obj = _ref_reconstructor(ref, None)
    for k1, k2 in [(0, 2), (1, 2), (2, 3), (0, 5), (3, 1)]:
        B = path_adj(k1, k2)
        got = tree_parents(B)
        want = tuple(obj.find_parent(B, i) for i in range(1, B.shape[0]))
        assert got == want, (k1, k2)


def test_patch_matches_reference_chd_matrix(ref):
    """The k x k patch the reference paints in chd_gen_mx
    (network_reconstruction_nx.py:301-305) vs patch_from_embedding, on
    the same graph, for arbitrary node tuples (including repeats)."""
    import networkx as nx
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency
    from onmf_ontf_ndl_tpu.samplers.motif import patch_from_embedding

    A = _small_graph()
    G = nx.from_numpy_array(A)
    g = graph_from_adjacency(A)
    rng = np.random.default_rng(11)
    k = 4
    for _ in range(25):
        emb = rng.integers(0, A.shape[0], size=k)
        want = np.zeros((k, k))
        for q in range(k):
            for r_ in range(k):
                want[q, r_] = int(G.has_edge(int(emb[q]), int(emb[r_])))
        got = np.asarray(patch_from_embedding(g, jnp.asarray(emb, jnp.int32)))
        assert (got == want).all(), emb


def _exact_glauber_law(A, B, emb):
    """Exact one-step law of the Glauber move on a dense adjacency A:
    P(emb') for emb' differing from emb in at most one coordinate.

    Derived independently from network_reconstruction_nx.py:136-173: pick
    j uniform over the k motif nodes; resample emb[j] uniformly from the
    common graph-neighbors of the images of j's motif neighbors (in- and
    out-), falling back to uniform over all nodes when the intersection
    is empty."""
    n = A.shape[0]
    k = len(emb)
    law = {}
    Bsym = (B + B.T) > 0
    for j in range(k):
        sel = np.flatnonzero(Bsym[:, j])
        mask = np.ones(n, bool)
        for r_ in sel:
            mask &= A[emb[r_]]
        if not mask.any():
            mask = np.ones(n, bool)
        ys = np.flatnonzero(mask)
        for y in ys:
            new = tuple(emb[:j]) + (int(y),) + tuple(emb[j + 1:])
            law[new] = law.get(new, 0.0) + 1.0 / (k * len(ys))
    return law


def test_glauber_one_step_law_matches_reference_empirically(ref):
    """Three-way agreement on the one-step Glauber law: the reference's
    own glauber_gen_update (empirical), our glauber_update (empirical),
    and the exact law enumerated from the adjacency matrix."""
    import networkx as nx
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency
    from onmf_ontf_ndl_tpu.samplers.motif import (glauber_update, path_adj,
                                                  tree_parents)

    A = _small_graph()
    G = nx.from_numpy_array(A)
    g = graph_from_adjacency(A)
    B = path_adj(0, 2)                  # 3-node path motif
    emb0 = np.array([0, 1, 2])          # valid along the ring backbone
    assert A[0, 1] and A[1, 2]
    law = _exact_glauber_law(A, B, emb0)

    M = 30_000
    obj = _ref_reconstructor(ref, G)
    np.random.seed(123)
    ref_counts = {}
    for _ in range(M):
        out = tuple(int(v) for v in obj.glauber_gen_update(B, emb0.copy()))
        ref_counts[out] = ref_counts.get(out, 0) + 1

    keys = jax.random.split(jax.random.key(0), M)
    ours = jax.vmap(lambda kk: glauber_update(
        kk, B, tree_parents(B), g, jnp.asarray(emb0, jnp.int32)))(keys)
    ours = np.asarray(ours)
    our_counts = {}
    for row in ours:
        out = tuple(int(v) for v in row)
        our_counts[out] = our_counts.get(out, 0) + 1

    support = set(law) | set(ref_counts) | set(our_counts)
    tv_ref = 0.5 * sum(abs(ref_counts.get(s, 0) / M - law.get(s, 0.0))
                       for s in support)
    tv_ours = 0.5 * sum(abs(our_counts.get(s, 0) / M - law.get(s, 0.0))
                        for s in support)
    # multinomial TV fluctuation at M=30k over ~30 outcomes is ~0.013
    assert tv_ref < 0.03, tv_ref
    assert tv_ours < 0.03, tv_ours
