"""Tests for checkpointing, configs, viz, and the CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from onmf_ontf_ndl_tpu.models.state import init_state
from onmf_ontf_ndl_tpu.models.onmf import train_dict
from onmf_ontf_ndl_tpu.utils.checkpoint import save_state, load_state
from onmf_ontf_ndl_tpu.utils.metrics import surrogate_error

RNG = np.random.default_rng(9)


def test_checkpoint_roundtrip_exact_resume(tmp_path):
    d, r, n = 20, 5, 60
    X = jnp.asarray(RNG.random((d, n)))
    st = init_state(jax.random.key(0), d, r, track_xxt=True,
                    dtype=jnp.float64)

    # uninterrupted: 4 + 4 iterations
    st_a, _ = train_dict(st, X, iterations=4, batch_size=8)
    st_ab, _ = train_dict(st_a, X, iterations=4, batch_size=8)

    # interrupted: save after first half, load, continue
    path = str(tmp_path / "ckpt.npz")
    save_state(path, st_a)
    st_loaded = load_state(path)
    assert float(st_loaded.t) == float(st_a.t)
    st_resumed, _ = train_dict(st_loaded, X, iterations=4, batch_size=8)

    np.testing.assert_array_equal(np.asarray(st_resumed.W),
                                  np.asarray(st_ab.W))
    np.testing.assert_array_equal(np.asarray(st_resumed.A),
                                  np.asarray(st_ab.A))
    np.testing.assert_array_equal(np.asarray(st_resumed.C),
                                  np.asarray(st_ab.C))
    assert float(st_resumed.t) == float(st_ab.t)


def test_surrogate_error_formula():
    d, r = 12, 4
    W = RNG.random((d, r))
    A = RNG.random((r, r))
    B = RNG.random((r, d))
    C = RNG.random((d, d))
    want = np.trace(W @ A @ W.T) - 2 * np.trace(W @ B) + np.trace(C)
    got = float(surrogate_error(jnp.asarray(W), jnp.asarray(A),
                                jnp.asarray(B), jnp.asarray(C)))
    assert np.isclose(got, want, rtol=1e-10)


def test_viz_writes_files(tmp_path):
    from onmf_ontf_ndl_tpu.utils import viz

    W = RNG.random((75, 9))
    p1 = viz.display_dictionary(W, 5, is_color=True,
                                save_path=str(tmp_path / "d.png"))
    assert os.path.getsize(p1) > 0
    Wg = RNG.random((9, 4))
    p2 = viz.display_network_dictionary(Wg, 3,
                                        save_path=str(tmp_path / "n.png"))
    assert os.path.getsize(p2) > 0
    imgs = [RNG.random((10, 10, 3)) for _ in range(2)]
    p3 = viz.display_recons_panel([W, W], imgs, imgs, 5,
                                  save_path=str(tmp_path / "p.png"))
    assert os.path.getsize(p3) > 0


def test_configs_build():
    from onmf_ontf_ndl_tpu.utils.config import IsingConfig, NetworkConfig

    app = IsingConfig(n_components=4, lattice_size=8, ising_iterations=1,
                      ising_subsampling_steps=10, sub_iterations=2,
                      num_patches=5, batch_size=3, patch_size=3).build()
    assert app.lattice.shape == (8, 8)


def test_cli_ising_end_to_end(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from onmf_ontf_ndl_tpu.cli import main;"
        f"main(['ising','--out-dir',{str(tmp_path)!r},"
        "'--n-components','4','--lattice-size','8',"
        "'--ising-iterations','2','--ising-subsampling-steps','64',"
        "'--sub-iterations','3','--num-patches','10',"
        "'--batch-size','5','--patch-size','3'])"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    assert "final_surrogate_error" in meta
    assert os.path.exists(tmp_path / "state.npz")
    assert os.path.exists(tmp_path / "dict.png")
    assert os.path.exists(tmp_path / "errors.npy")


def test_check_state_catches_violations():
    import dataclasses
    import pytest
    from onmf_ontf_ndl_tpu.utils.debug import check_state

    st = init_state(jax.random.key(0), 8, 3, dtype=jnp.float64)
    st_ok = dataclasses.replace(
        st, W=st.W / jnp.maximum(1.0, jnp.linalg.norm(st.W, axis=0)))
    check_state(st_ok)  # no raise

    bad = dataclasses.replace(st_ok, W=st_ok.W.at[0, 0].set(jnp.nan))
    with pytest.raises(FloatingPointError, match="non-finite"):
        check_state(bad)
    bad = dataclasses.replace(st_ok, W=st_ok.W.at[0, 0].set(-1.0))
    with pytest.raises(FloatingPointError, match="negative"):
        check_state(bad)


def test_throughput_counter():
    from onmf_ontf_ndl_tpu.utils.profiling import Throughput

    tp = Throughput()
    X = jnp.ones((64, 64))
    with tp.measure(items=100):
        y = X @ X
        tp.fence(y)
    assert tp.items_per_sec > 0 and tp.elapsed > 0


def test_sparse_code_key_deterministic():
    # H0 keys must not depend on process hash randomization
    from onmf_ontf_ndl_tpu.models.onmf import OnlineNMF

    X = RNG.random((12, 9))
    W = RNG.random((12, 4))
    nmf = OnlineNMF(X, n_components=4, dtype=jnp.float64)
    h1 = np.asarray(nmf.sparse_code(X, W))
    h2 = np.asarray(nmf.sparse_code(X, W))
    np.testing.assert_array_equal(h1, h2)


def test_cli_top_level_out_dir(tmp_path):
    # a --out-dir given before the subcommand must not be clobbered by
    # the subparser default
    import argparse
    from onmf_ontf_ndl_tpu.cli import main as cli_main
    out = tmp_path / "toplevel"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from onmf_ontf_ndl_tpu.cli import main;"
        f"main(['--out-dir',{str(out)!r},'ising',"
        "'--n-components','3','--lattice-size','8',"
        "'--ising-iterations','1','--ising-subsampling-steps','16',"
        "'--sub-iterations','2','--num-patches','5',"
        "'--batch-size','3','--patch-size','3'])"
    )
    env = dict(os.environ)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-1500:]
    assert os.path.exists(out / "state.npz")


def test_invalid_sampler_rejected():
    import pytest
    from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor

    with pytest.raises(ValueError, match="sampler"):
        IsingReconstructor(sampler="metropolis")


def test_viz_color_combine(tmp_path):
    from onmf_ontf_ndl_tpu.utils import viz

    W = RNG.random((25, 6))
    H = RNG.random((3, 6))
    p = viz.display_dictionary_color_combine(
        W, H, 5, save_path=str(tmp_path / "cc.png"))
    assert os.path.getsize(p) > 0


def test_show_array(tmp_path):
    from onmf_ontf_ndl_tpu.utils.viz import show_array

    p = show_array(RNG.random((8, 8)), cmap="gray",
                   save_path=str(tmp_path / "arr.png"))
    assert os.path.getsize(p) > 0


def test_load_edgelist_dense(tmp_path):
    # read_networks parity: dense adjacency, first-appearance node order
    import numpy as np

    from onmf_ontf_ndl_tpu.data.graphs import load_edgelist_dense

    p = tmp_path / "e.txt"
    p.write_text("5,7\n7,2\n2,5\n")
    A = load_edgelist_dense(str(p))
    # nodes interned as 5->0, 7->1, 2->2: a triangle
    expect = np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]], np.float64)
    np.testing.assert_array_equal(A, expect)


def test_cli_network_bitset_sparse_end_to_end(tmp_path):
    # exercise the scale knobs: bitset ingest + chain ensembles + the
    # sparse (edge-list) reconstruction export
    import numpy as np
    edges = []
    m = 6
    for i in range(m):
        for j in range(m):
            u = i * m + j
            edges.append((u, ((i + 1) % m) * m + j))
            edges.append((u, i * m + (j + 1) % m))
    ef = tmp_path / "torus_edges.txt"
    with open(ef, "w") as f:
        for a, b in edges:
            f.write(f"{a},{b}\n")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from onmf_ontf_ndl_tpu.cli import main;"
        f"main(['network','--out-dir',{str(tmp_path)!r},"
        f"'--source',{str(ef)!r},'--use-bitset','true','--fast','true',"
        "'--n-components','4','--mcmc-iterations','2',"
        "'--sub-iterations','3','--sample-size','20','--batch-size','5',"
        "'--k1','0','--k2','1','--num-chains','2','--recons-chains','2',"
        "'--recons-iter','200'])"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    assert "recons_accuracy" in meta
    # BitsetGraph auto-routes to the sparse reconstruction -> edge list
    assert os.path.exists(tmp_path / "recons_edges.txt")
    assert np.genfromtxt(tmp_path / "recons_edges.txt",
                         delimiter=",").shape[1] == 2


def test_cli_network_csr_representation(tmp_path):
    # --representation csr: the O(E) million-node path from the CLI,
    # with the built-CSR npz cache
    import numpy as np
    ef = tmp_path / "ring.txt"
    with open(ef, "w") as f:
        for i in range(30):
            f.write(f"{i},{(i + 1) % 30}\n")
            f.write(f"{i},{(i + 2) % 30}\n")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""
    cache = tmp_path / "gcache"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from onmf_ontf_ndl_tpu.cli import main;"
        f"main(['network','--out-dir',{str(tmp_path)!r},"
        f"'--source',{str(ef)!r},'--representation','csr',"
        f"'--graph-cache-dir',{str(cache)!r},'--fast','true',"
        "'--n-components','4','--mcmc-iterations','2',"
        "'--sub-iterations','3','--sample-size','20','--batch-size','5',"
        "'--k1','0','--k2','1','--num-chains','2','--recons-chains','2',"
        "'--recons-iter','200'])"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    assert "recons_accuracy" in meta
    # CsrGraph auto-routes to the sparse reconstruction -> edge list,
    # and the cache holds one built-CSR npz
    assert os.path.exists(tmp_path / "recons_edges.txt")
    assert len([f for f in os.listdir(cache)
                if f.endswith(".npz")]) == 1


def test_network_config_representation_validation():
    import pytest

    from onmf_ontf_ndl_tpu.utils.config import NetworkConfig

    with pytest.raises(ValueError, match="representation must be"):
        NetworkConfig(source="x.txt", representation="sparse").build()
    with pytest.raises(ValueError, match="dense representation"):
        NetworkConfig(source="x.txt", is_WAN=True,
                      representation="csr").build()


def test_checkpoint_path_suffix_and_extra_dtypes(tmp_path):
    """save/load/exists agree on suffix-less paths, and extras keep
    their saved dtypes (ints are not float-cast)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.utils.checkpoint import (
        checkpoint_exists, load_state, save_state)

    st = init_state(jax.random.key(0), 6, 3)
    p = str(tmp_path / "ck")            # no .npz suffix
    save_state(p, st, extra={"emb": np.arange(5, dtype=np.int32),
                             "mask": np.array([True, False])})
    assert checkpoint_exists(p)
    st2, extra = load_state(p, dtype=jnp.float32, with_extra=True)
    np.testing.assert_array_equal(np.asarray(st2.W), np.asarray(st.W))
    assert extra["emb"].dtype == jnp.int32
    assert extra["mask"].dtype == jnp.bool_


def test_edge_list_shape_validation():
    import numpy as np
    import pytest

    from onmf_ontf_ndl_tpu.data.graphs import graph_from_edgelist

    with pytest.raises(ValueError, match="node pairs"):
        graph_from_edgelist(np.array([[1, 2, 5], [2, 3, 7]]))


def test_graph_from_adjacency_does_not_mutate_input():
    import numpy as np

    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency

    A = np.array([[2.0, 1.0], [1.0, 3.0]])
    graph_from_adjacency(A)
    np.testing.assert_array_equal(A, [[2.0, 1.0], [1.0, 3.0]])
