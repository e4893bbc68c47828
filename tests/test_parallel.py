"""Distributed tests on the 8-virtual-device CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from onmf_ontf_ndl_tpu.models.state import init_state
from onmf_ontf_ndl_tpu.models.onmf import onmf_step
from onmf_ontf_ndl_tpu.models.onmf import onmf_step as lib_onmf_step
from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh
from onmf_ontf_ndl_tpu.parallel.dp import dp_onmf_step, dp_train_dict
from onmf_ontf_ndl_tpu.parallel.ising_sharded import sharded_checkerboard_sweeps
from onmf_ontf_ndl_tpu.samplers.ising import init_lattice

RNG = np.random.default_rng(7)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def test_dp_step_equals_single_device():
    mesh = make_mesh({"dp": 8})
    d, r, n = 24, 6, 64
    W = RNG.random((d, r))
    st = init_state(jax.random.key(0), d, r, dtype=jnp.float64, W=W)
    X = jnp.asarray(RNG.random((d, n)))
    H0 = jnp.asarray(RNG.random((r, n)))

    st1, H1 = onmf_step(st, X, t=2.0, H0=H0, alpha=0.4, beta=0.9,
                        stopping_diff=None)
    st2, H2 = dp_onmf_step(mesh, st, X, t=2.0, H0=H0, alpha=0.4, beta=0.9,
                           stopping_diff=None)
    np.testing.assert_allclose(np.asarray(H2), np.asarray(H1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(st2.A), np.asarray(st1.A), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(st2.B), np.asarray(st1.B), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(st2.W), np.asarray(st1.W), rtol=1e-10)


def test_dp_step_tracks_xxt():
    mesh = make_mesh({"dp": 8})
    d, r, n = 16, 4, 32
    st = init_state(jax.random.key(1), d, r, track_xxt=True, dtype=jnp.float64)
    X = jnp.asarray(RNG.random((d, n)))
    H0 = jnp.asarray(RNG.random((r, n)))
    st2, _ = dp_onmf_step(mesh, st, X, t=1.0, H0=H0, stopping_diff=None)
    np.testing.assert_allclose(np.asarray(st2.C), np.asarray(X @ X.T),
                               rtol=1e-10)


def test_dp_train_dict_runs():
    mesh = make_mesh({"dp": 8})
    d, r, n = 20, 5, 80
    st = init_state(jax.random.key(2), d, r, dtype=jnp.float64)
    X = jnp.asarray(RNG.random((d, n)))
    st2 = dp_train_dict(mesh, st, X, iterations=6, batch_size_per_device=4)
    assert float(st2.t) == 6.0
    W = np.asarray(st2.W)
    assert (W >= 0).all()
    assert (np.linalg.norm(W, axis=0) <= 1 + 1e-9).all()
    # aggregates REPLICATED IDENTICALLY across devices: a dropped psum
    # would leave per-device copies diverged (shard_map out_specs=P()
    # with check_vma=False would silently return one of them)
    shards = [np.asarray(sh.data) for sh in st2.A.addressable_shards]
    for sh in shards[1:]:
        np.testing.assert_array_equal(sh, shards[0])
    assert np.isfinite(shards[0]).all()


def test_halo_neighbor_sum_matches_roll():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from onmf_ontf_ndl_tpu.parallel.ising_sharded import _halo_neighbor_sum
    from onmf_ontf_ndl_tpu.samplers.ising import _neighbor_sum

    mesh = make_mesh({"dp": 8})
    lat = jnp.asarray(RNG.random((16, 16)), jnp.float32)
    want = np.asarray(_neighbor_sum(lat))
    fn = shard_map(
        lambda x: _halo_neighbor_sum(x, "dp"), mesh=mesh,
        in_specs=(P("dp", None),), out_specs=P("dp", None),
        check_vma=False)
    got = np.asarray(jax.jit(fn)(lat))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sharded_ising_physics():
    mesh = make_mesh({"dp": 8})
    lat = init_lattice(jax.random.key(3), 32)
    out = sharded_checkerboard_sweeps(mesh, jax.random.key(4), lat, 300,
                                      T=1.5)
    s = np.asarray(out, np.float32)
    corr = np.mean(s * np.roll(s, 1, 0))
    assert corr > 0.85  # strong local order below Tc
    assert set(np.unique(s)).issubset({-1.0, 1.0})


def test_dp_image_trainer():
    from onmf_ontf_ndl_tpu.parallel.dp import dp_train_image_dict

    mesh = make_mesh({"dp": 8})
    yy, xx = np.mgrid[0:40, 0:40]
    img = jnp.asarray(
        0.5 + 0.4 * np.sin(xx / 3.0) * np.cos(yy / 4.0), jnp.float64)
    st = init_state(jax.random.key(5), 25, 6, dtype=jnp.float64)
    st2 = dp_train_image_dict(
        mesh, st, img, outer_iterations=6, num_patches_per_device=20,
        inner_iterations=4, batch_size_per_device=8, patch_size=5)
    W = np.asarray(st2.W)
    assert (W >= 0).all()
    assert (np.linalg.norm(W, axis=0) <= 1 + 1e-9).all()
    assert float(st2.t) > 0
    # the learned dictionary should beat the random init at coding
    from onmf_ontf_ndl_tpu.ops.patches import extract_patches_grid
    from onmf_ontf_ndl_tpu.ops.coder import nonneg_code
    X = extract_patches_grid(img, 5, 3)
    def err(Wm):
        H = nonneg_code(X, jnp.asarray(Wm), key=jax.random.key(9),
                        alpha=0.0, sub_iter=20, stopping_diff=None)
        return float(jnp.linalg.norm(X - jnp.asarray(Wm) @ H)
                     / jnp.linalg.norm(X))
    W0 = np.asarray(st.W) / np.maximum(1, np.linalg.norm(np.asarray(st.W), axis=0))
    assert err(W) < err(W0)


def test_auto_train_dict_matches_single_device():
    from onmf_ontf_ndl_tpu.parallel.auto import auto_train_dict
    from onmf_ontf_ndl_tpu.models.onmf import train_dict

    mesh = make_mesh({"dp": 4, "tp": 2})
    d, r, n = 24, 8, 64
    st = init_state(jax.random.key(7), d, r, dtype=jnp.float64)
    X = jnp.asarray(RNG.random((d, n)))

    st_single, code_single = train_dict(st, X, iterations=5, batch_size=16,
                                        stopping_diff=None)
    st_auto, code_auto = auto_train_dict(
        mesh, st, X, dp_axis="dp", tp_axis="tp",
        iterations=5, batch_size=16, stopping_diff=None)
    # GSPMD changes layout, not semantics
    np.testing.assert_allclose(np.asarray(st_auto.W),
                               np.asarray(st_single.W), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(code_auto),
                               np.asarray(code_single), rtol=1e-12)


def test_dp_ndl_train_virtual_mesh():
    """Data-parallel NDL: chains sharded over a 4-device mesh, psum'd
    statistics; the run must produce a valid advancing state, sharded
    code/embeddings, and be deterministic."""
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.parallel.dp import dp_ndl_train
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh
    from onmf_ontf_ndl_tpu.samplers.motif import (path_adj, tree_parents,
                                                  tree_sample)

    m = 6
    n = m * m
    A = np.zeros((n, n), bool)
    for i in range(m):
        for j in range(m):
            u = i * m + j
            for (di, dj) in [(1, 0), (0, 1)]:
                v = ((i + di) % m) * m + (j + dj) % m
                A[u, v] = A[v, u] = True
    g = graph_from_adjacency(A)
    B = path_adj(0, 2)
    parents = tree_parents(B)
    k = B.shape[0]

    ndev, chains_pd = 4, 2
    mesh = make_mesh({"dp": ndev}, jax.devices()[:ndev])
    keys = jax.random.split(jax.random.key(3), ndev * chains_pd)
    emb0 = jnp.stack([tree_sample(kk, parents, g, jnp.int32(i * 4))
                      for i, kk in enumerate(keys)])
    state = init_state(jax.random.key(0), k * k, 6)

    def run():
        return dp_ndl_train(
            mesh, state, g, emb0,
            np.asarray(B, np.int8).tobytes(), parents,
            mcmc_iterations=4, sample_size_per_device=24,
            inner_iterations=5, batch_size=12,
            num_chains_per_device=chains_pd)

    st, code, emb = run()
    assert float(st.t) == 4 * 5
    W = np.asarray(st.W)
    assert (W >= 0).all() and np.isfinite(W).all()
    assert (np.linalg.norm(W, axis=0) <= 1 + 1e-5).all()
    assert code.shape == (6, 24 * ndev)
    assert emb.shape == (ndev * chains_pd, k)
    adj = np.asarray(g.adj)
    for row in np.asarray(emb):
        for a, b in zip(row[:-1], row[1:]):
            assert adj[a, b]
    # deterministic
    st2, code2, _ = run()
    np.testing.assert_array_equal(np.asarray(st.W), np.asarray(st2.W))


def test_dp_ndl_train_bitset_graph():
    """DP NDL over the bit-packed graph representation (the scale path)
    on a virtual mesh."""
    from onmf_ontf_ndl_tpu.data.graphs import bitset_graph_from_edges
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.parallel.dp import dp_ndl_train
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh
    from onmf_ontf_ndl_tpu.samplers.motif import (path_adj, tree_parents,
                                                  tree_sample)

    edges = [(i, (i + 1) % 30) for i in range(30)] + \
            [(i, (i + 2) % 30) for i in range(30)]
    g = bitset_graph_from_edges(edges)
    B = path_adj(0, 2)
    parents = tree_parents(B)
    k = B.shape[0]

    ndev = 4
    mesh = make_mesh({"dp": ndev}, jax.devices()[:ndev])
    keys = jax.random.split(jax.random.key(5), ndev)
    emb0 = jnp.stack([tree_sample(kk, parents, g, jnp.int32(i * 7))
                      for i, kk in enumerate(keys)])
    state = init_state(jax.random.key(0), k * k, 4)
    st, code, emb = dp_ndl_train(
        mesh, state, g, emb0, np.asarray(B, np.int8).tobytes(), parents,
        mcmc_iterations=3, sample_size_per_device=16, inner_iterations=4,
        batch_size=8)
    W = np.asarray(st.W)
    assert (W >= 0).all() and np.isfinite(W).all()
    assert code.shape == (4, 16 * ndev)
    assert emb.shape == (ndev, k)


def test_dp_train_dict_block_sampling():
    """The block sampler works shard-locally under DP
    (PARITY.md deviation #12): valid replicated result, deterministic."""
    mesh = make_mesh({"dp": 8})
    d, r, n = 20, 5, 80
    st = init_state(jax.random.key(4), d, r, dtype=jnp.float64)
    X = jnp.asarray(RNG.random((d, n)))
    run = lambda: dp_train_dict(mesh, st, X, iterations=6,
                                batch_size_per_device=4, sampling="block")
    st2 = run()
    W = np.asarray(st2.W)
    assert (W >= 0).all() and np.isfinite(W).all()
    assert (np.linalg.norm(W, axis=0) <= 1 + 1e-9).all()
    assert float(st2.t) == 6.0
    shards = [np.asarray(sh.data) for sh in st2.A.addressable_shards]
    for sh in shards[1:]:
        np.testing.assert_array_equal(sh, shards[0])
    st3 = run()
    np.testing.assert_array_equal(np.asarray(st2.W), np.asarray(st3.W))


def test_dp_ising_learning_virtual_mesh():
    """DP Ising trajectory learning: an 8-lattice ensemble (one per
    device), psum'd full aggregates incl. C; replicated outputs,
    deterministic, and the surrogate error is computed from the psum'd
    statistics (finite, correct trace shape)."""
    from onmf_ontf_ndl_tpu.parallel.dp import dp_ising_learning
    from onmf_ontf_ndl_tpu.samplers.ising import init_lattice

    ndev = 8
    mesh = make_mesh({"dp": ndev})
    lats = jnp.stack([init_lattice(k, 12) for k in
                      jax.random.split(jax.random.key(0), ndev)])
    st = init_state(jax.random.key(1), 16, 5, track_xxt=True,
                    dtype=jnp.float64)

    run = lambda: dp_ising_learning(
        mesh, st, lats, jax.random.key(2), ising_iterations=3, nsteps=20,
        num_patches_per_device=10, inner_iterations=4, batch_size=5,
        patch_size=4, T=1.0)
    st2, dstack, errs, lats2 = run()
    assert dstack.shape == (4, 16, 5)
    assert errs.shape == (4,)
    assert np.isfinite(np.asarray(errs)).all()
    W = np.asarray(st2.W)
    assert (W >= 0).all() and np.isfinite(W).all()
    assert (np.linalg.norm(W, axis=0) <= 1 + 1e-9).all()
    # lattices stay valid +-1 spins and are per-device distinct
    s = np.asarray(lats2, np.float64)
    assert s.shape == (ndev, 12, 12)
    assert set(np.unique(s)).issubset({-1.0, 1.0})
    assert any(not np.array_equal(s[0], s[d]) for d in range(1, ndev))
    # aggregates (incl. the full C statistic) replicated identically:
    # a dropped psum would leave per-device copies diverged
    for arr in (st2.A, st2.B, st2.C):
        shards = [np.asarray(sh.data) for sh in arr.addressable_shards]
        for sh in shards[1:]:
            np.testing.assert_array_equal(sh, shards[0])
    # deterministic
    st3, _, errs3, _ = run()
    np.testing.assert_array_equal(np.asarray(st2.W), np.asarray(st3.W))
    np.testing.assert_array_equal(np.asarray(errs), np.asarray(errs3))


def test_dp_tensor_trainer_virtual_mesh():
    """DP ONTF: unfolded tensor columns sharded over the mesh; the ONTF
    surface defaults (alpha=2, exact coder) apply; replicated result,
    deterministic, learns."""
    from onmf_ontf_ndl_tpu.parallel.dp import dp_train_tensor_dict

    mesh = make_mesh({"dp": 8})
    # (k^2, 3, n) color patch tensor, joint mode-2 dictionary (the
    # reference driver's configuration)
    Xt = jnp.asarray(RNG.random((9, 3, 16)), jnp.float64)
    st = init_state(jax.random.key(3), 27, 4, dtype=jnp.float64)
    run = lambda: dp_train_tensor_dict(
        mesh, st, Xt, mode=2, learn_joint_dict=True, iterations=5,
        batch_size_per_device=2, coder_sub_iter=20)
    st2 = run()
    assert float(st2.t) == 5.0
    W = np.asarray(st2.W)
    assert (W >= 0).all() and np.isfinite(W).all()
    assert (np.linalg.norm(W, axis=0) <= 1 + 1e-9).all()
    shards = [np.asarray(sh.data) for sh in st2.A.addressable_shards]
    for sh in shards[1:]:
        np.testing.assert_array_equal(sh, shards[0])
    st3 = run()
    np.testing.assert_array_equal(np.asarray(st2.W), np.asarray(st3.W))
    # shape guard: marginal mode-0 dictionary has d=k^2
    st0 = init_state(jax.random.key(4), 9, 4, dtype=jnp.float64)
    st0b = dp_train_tensor_dict(
        mesh, st0, Xt, mode=0, iterations=3, batch_size_per_device=2,
        coder_sub_iter=5)
    assert st0b.W.shape == (9, 4)
    with pytest.raises(ValueError, match="unfolded feature dim"):
        dp_train_tensor_dict(mesh, st0, Xt, mode=1, iterations=2,
                             batch_size_per_device=2)


def test_merge_recon_shards_exact():
    """The DP recon host merge is exactly the global per-pair mean:
    sum-of-shard-sums / sum-of-shard-counts, regrouped by pair."""
    from onmf_ontf_ndl_tpu.parallel.dp import merge_recon_shards

    n = 5
    # two devices, 4 grouped slots each; real segments are a prefix
    ii = jnp.asarray([0, 1, 0, 0, 0, 2, 0, 0], jnp.int32)
    jj = jnp.asarray([1, 2, 0, 0, 1, 0, 0, 0], jnp.int32)
    sums = jnp.asarray([3.0, 1.0, 0, 0, 1.0, 4.0, 0, 0])
    cnt = jnp.asarray([2.0, 1.0, 0, 0, 2.0, 1.0, 0, 0])
    n_seg = jnp.asarray([2, 2], jnp.int32)
    pi, pj, mean, gc = merge_recon_shards(ii, jj, sums, cnt, n_seg, n)
    got = {(int(a), int(b)): (float(m), float(c))
           for a, b, m, c in zip(pi, pj, mean, gc)}
    assert got == {(0, 1): (1.0, 4.0), (1, 2): (1.0, 1.0),
                   (2, 0): (4.0, 1.0)}


def test_dp_sparse_recon_virtual_mesh():
    """Chain-sharded DP reconstruction on the 8-device virtual mesh:
    deterministic, and the merged global edge set reconstructs the torus
    as accurately as a single-device run of the same total budget."""
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency
    from onmf_ontf_ndl_tpu.parallel.dp import dp_recons_edges

    m = 8
    n = m * m
    A = np.zeros((n, n), bool)
    for i in range(m):
        for j in range(m):
            u = i * m + j
            for (di, dj) in [(1, 0), (0, 1)]:
                v = ((i + di) % m) * m + (j + dj) % m
                A[u, v] = A[v, u] = True
    g = graph_from_adjacency(A)
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2, alpha=0.1,
        is_glauber_recons=False, dtype=jnp.float64,
    )
    rec.train_dict()

    mesh = make_mesh({"dp": 8})
    run = lambda: dp_recons_edges(
        mesh, rec.state.W, g, jax.random.key(7), rec._B_bytes,
        rec._parents, recons_iter_per_device=500,
        num_chains_per_device=1, alpha=0.1, sub_iter=30,
        use_glauber=False)
    edges = run()
    acc_dp = rec.compute_recons_accuracy(G_recons=edges)

    rec.reconstruct_network(recons_iter=4000, num_chains=8)
    acc_single = rec.compute_recons_accuracy()
    assert acc_dp > 0.5, acc_dp
    assert abs(acc_dp - acc_single) < 0.2, (acc_dp, acc_single)
    np.testing.assert_array_equal(edges, run())


def test_dp_sparse_recon_csr_graph():
    """The chain-sharded DP reconstruction replicates a CsrGraph (pure
    O(E) representation) across the mesh and merges exactly — the
    multi-chip path for million-node low-degree graphs."""
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges
    from onmf_ontf_ndl_tpu.parallel.dp import dp_recons_edges

    m = 12
    edges = []
    for i in range(m):
        for j in range(m):
            u = i * m + j
            edges.append((u, ((i + 1) % m) * m + j))
            edges.append((u, i * m + (j + 1) % m))
    g = csr_graph_from_edges(edges)
    rec = NetworkReconstructor(
        source=g, n_components=16, MCMC_iterations=8, sub_iterations=10,
        sample_size=100, batch_size=20, k1=0, k2=2,
        dtype=jnp.float64,
    )
    rec.train_dict()

    mesh = make_mesh({"dp": 8})
    run = lambda: dp_recons_edges(
        mesh, rec.state.W, g, jax.random.key(7), rec._B_bytes,
        rec._parents, recons_iter_per_device=2000,
        num_chains_per_device=8, sub_iter=30, use_glauber=True)
    edges_dp = run()
    acc_dp = rec.compute_recons_accuracy(G_recons=edges_dp)
    assert acc_dp > 0.9, acc_dp
    np.testing.assert_array_equal(edges_dp, run())


def test_dp_tensor_trainer_equals_single_device():
    """dp_train_tensor_dict == a single-device run on the concatenated
    per-device batches (round-4 verdict #3: replication tests alone
    would pass a consistently-misplaced psum; this oracle rebuilds the
    per-device draws with the library's own key discipline and drives
    plain onmf_step — no psum code path — on the concatenation)."""
    import dataclasses

    from onmf_ontf_ndl_tpu.models.ontf import resolve_tensor_coder
    from onmf_ontf_ndl_tpu.ops.unfold import unfold
    from onmf_ontf_ndl_tpu.parallel.dp import dp_train_tensor_dict

    ndev, iters, bpd, r = 8, 5, 2, 4
    mesh = make_mesh({"dp": ndev})
    Xt = jnp.asarray(RNG.random((9, 3, 16)), jnp.float64)
    st = init_state(jax.random.key(11), 27, r, dtype=jnp.float64)
    # fixed sweeps: the early-stopping rule is shard-local under DP
    # (documented deviation), so exact equality needs stopping_diff=None
    st_dp = dp_train_tensor_dict(
        mesh, st, Xt, mode=2, learn_joint_dict=True, iterations=iters,
        batch_size_per_device=bpd, coder_sub_iter=20, stopping_diff=None)

    # oracle: mirror _train_scan's key discipline (split 3, fold skey/
    # hkey by device index), draw each device's iid batch from its
    # column shard, and take ONE single-device onmf_step per iteration
    # on the concatenated batch with the concatenated H0
    method, sub_iter = resolve_tensor_coder("exact", 10, 20)
    Xu = unfold(Xt, 2).T                       # joint dict: transpose
    npl = Xu.shape[1] // ndev
    shards = [Xu[:, d * npl:(d + 1) * npl] for d in range(ndev)]
    st_o = st
    key = st.key
    for i in range(1, iters):
        key, skey, hkey = jax.random.split(key, 3)
        xb, h0 = [], []
        for d in range(ndev):
            sk = jax.random.fold_in(skey, d)
            hk = jax.random.fold_in(hkey, d)
            idx = jax.random.randint(sk, (bpd,), 0, npl)
            xb.append(jnp.take(shards[d], idx, axis=1))
            h0.append(jax.random.uniform(hk, (r, bpd), dtype=jnp.float64))
        st_o, _ = lib_onmf_step(
            st_o, jnp.concatenate(xb, axis=1), t=float(i),
            H0=jnp.concatenate(h0, axis=1), alpha=2.0, beta=1.0,
            sub_iter=sub_iter, stopping_diff=None, coder=method)
    np.testing.assert_allclose(np.asarray(st_dp.W), np.asarray(st_o.W),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_dp.A), np.asarray(st_o.A),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_dp.B), np.asarray(st_o.B),
                               rtol=0, atol=1e-12)
    assert float(st_dp.t) == float(iters)


def test_dp_ising_learning_equals_single_device():
    """dp_ising_learning == a single-device 8-lattice ensemble driven
    through the library's non-psum primitives (round-4 verdict #3): the
    oracle advances each lattice with the same per-device key stream,
    extracts the same patches, and takes single-device onmf_steps on
    the cross-device patch concatenation; the surrogate-error trace,
    aggregates, dictionary, and final lattices must all match."""
    from onmf_ontf_ndl_tpu.ops.patches import (extract_patches,
                                               random_patch_corners)
    from onmf_ontf_ndl_tpu.parallel.dp import dp_ising_learning
    from onmf_ontf_ndl_tpu.samplers.ising import (checkerboard_sweeps,
                                                  init_lattice)
    from onmf_ontf_ndl_tpu.utils.metrics import surrogate_error

    ndev, L, k, r = 8, 12, 4, 5
    isit, inner, npd = 3, 4, 10
    mesh = make_mesh({"dp": ndev})
    lats = jnp.stack([init_lattice(kk, L) for kk in
                      jax.random.split(jax.random.key(0), ndev)])
    st = init_state(jax.random.key(1), k * k, r, track_xxt=True,
                    dtype=jnp.float64)
    base_key = jax.random.key(2)
    # fixed sweeps (see tensor test above for why)
    st_dp, dstack, errs, lats_dp = dp_ising_learning(
        mesh, st, lats, base_key, ising_iterations=isit, nsteps=20,
        num_patches_per_device=npd, inner_iterations=inner, batch_size=5,
        patch_size=k, T=1.0, use_stopping=False)

    dt = jnp.float64
    J = jnp.asarray(1.0, dt)
    Hf = jnp.asarray(0.0, dt)
    T = jnp.asarray(1.0, dt)

    def patches_cat(lats_o, rkeys):
        cols = [extract_patches(
            lats_o[d].astype(dt),
            random_patch_corners(rkeys[d], (L, L), k, npd), k)
            for d in range(ndev)]
        return jnp.concatenate(cols, axis=1)

    st_o = st
    key_state = st.key
    t0 = 0.0

    def inner_rounds(st_o, key_state, t0, X_cat):
        for i in range(1, inner):
            key_state, _skey, hkey = jax.random.split(key_state, 3)
            h0 = jnp.concatenate(
                [jax.random.uniform(jax.random.fold_in(hkey, d), (r, npd),
                                    dtype=dt) for d in range(ndev)], axis=1)
            st_o, _ = lib_onmf_step(st_o, X_cat, t=t0 + i, H0=h0,
                                    alpha=0.0, beta=1.0, sub_iter=10,
                                    stopping_diff=None)
        return st_o, key_state, t0 + inner

    # per-device key streams: fold by device index, then the initial
    # round's split (apps/ising.py ising_trajectory_learning)
    kd = [jax.random.fold_in(base_key, d) for d in range(ndev)]
    kd, rk0 = zip(*[jax.random.split(kk) for kk in kd])
    st_o, key_state, t0 = inner_rounds(st_o, key_state, t0,
                                       patches_cat(lats, rk0))
    err_trace = [surrogate_error(st_o.W, st_o.A, st_o.B, st_o.C)]
    lats_o = [lats[d] for d in range(ndev)]
    iter_keys = [jax.random.split(kk, isit) for kk in kd]
    for j in range(isit):
        rkeys = []
        for d in range(ndev):
            skey, rkey = jax.random.split(iter_keys[d][j])
            # nsteps=20 on a 12x12 lattice rounds up to 1 sweep
            lats_o[d] = checkerboard_sweeps(skey, lats_o[d], 1, J, Hf, T)
            rkeys.append(rkey)
        st_o, key_state, t0 = inner_rounds(st_o, key_state, t0,
                                           patches_cat(lats_o, rkeys))
        err_trace.append(surrogate_error(st_o.W, st_o.A, st_o.B, st_o.C))

    np.testing.assert_allclose(np.asarray(st_dp.W), np.asarray(st_o.W),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_dp.A), np.asarray(st_o.A),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_dp.B), np.asarray(st_o.B),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_dp.C), np.asarray(st_o.C),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(errs), np.asarray(err_trace),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(lats_dp),
                                  np.stack([np.asarray(x) for x in lats_o]))
