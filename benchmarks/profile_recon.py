"""Phase profile of the sparse NDL reconstruction at torus scale.

Times fused PREFIXES of the real reconstruction pipeline (chain scan,
+patches, +coding, +grouping), each as one jit ending in a scalar, so
XLA's layout/fusion choices match the production program. (An ISOLATED
chain-scan jit can be far slower than the same scan inside the real
program: the stacked (M, k) embs output gets a padded tiny-minor-dim
layout that nothing consumes — docs/DESIGN.md §5.)
Phase costs are successive differences. Run manually:

    python benchmarks/profile_recon.py --side 360 [--csr] [--chains N]
    python benchmarks/profile_recon.py --side 512 --csr --whole
    python benchmarks/profile_recon.py --ba 4194304 --pivot  # heavy tail
"""

import argparse
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def fence(x):
    """Wait until every array in ``x`` is computed; returns ``x``."""
    return jax.block_until_ready(x)


def steady(fn):
    fence(fn())
    t0 = time.time()
    out = fence(fn())
    return time.time() - t0, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=360)
    ap.add_argument("--ba", type=int, default=None, metavar="N",
                    help="profile an N-node Barabási–Albert m=2 graph "
                         "(CsrGraph, heavy-tailed) instead of a torus")
    ap.add_argument("--pivot", action="store_true",
                    help="profile the Pivot chain (the reference's "
                         "real-network recon default) instead of Glauber")
    ap.add_argument("--csr", action="store_true")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--whole", action="store_true",
                    help="time the real reconstruct_network_sparse jit "
                         "instead of the per-phase breakdown")
    args = ap.parse_args()

    from scale_extras import ba_edges, torus_edges
    from onmf_ontf_ndl_tpu.data.graphs import (
        bitset_graph_from_edges, csr_graph_from_edges)
    from onmf_ontf_ndl_tpu.samplers.motif import (
        path_adj, tree_parents, glauber_update, pivot_update, tree_sample,
        pair_matrices_T)
    from onmf_ontf_ndl_tpu.apps.network import _group_painted
    from onmf_ontf_ndl_tpu.ops.coder import nonneg_code

    if args.ba:
        n_nom = args.ba
        scale = n_nom / 1_048_576
        cap = 19_200_000
        samples = args.samples or min(int(5 * n_nom), cap)
        chains = args.chains or 16384
    else:
        side = args.side
        scale = (side / 180.0) ** 2
        cap = 19_200_000 if args.csr else 4_800_000
        samples = args.samples or min(int(1_200_000 * scale), cap)
        chains = args.chains or (4096 if side <= 180 else (
            8192 if side <= 360 else (16384 if side <= 512 else 32768)))

    fence(jnp.ones(8))
    t0 = time.time()
    if args.ba:
        g = csr_graph_from_edges(ba_edges(n_nom))
    else:
        build = csr_graph_from_edges if args.csr else bitset_graph_from_edges
        g = build(torus_edges(side))
    print(f"load {time.time()-t0:.1f}s  n={g.num_nodes} "
          f"max_deg={g.max_deg} chains={chains} samples={samples} "
          f"chain={'pivot' if args.pivot else 'glauber'}", file=sys.stderr)

    B = path_adj(0, 2)
    parents = tree_parents(B)
    k = B.shape[0]
    W = jnp.abs(jax.random.normal(jax.random.key(3), (k * k, 25),
                                  jnp.float32))
    W = W / jnp.linalg.norm(W, axis=0)

    per = -(-samples // chains)
    M = per * chains
    key = jax.random.key(0)
    ck, pk, tk, hk = jax.random.split(key, 4)

    if args.whole:
        from onmf_ontf_ndl_tpu.apps.network import (
            reconstruct_network_sparse)
        import functools

        run = functools.partial(
            reconstruct_network_sparse, W, g, jax.random.key(0),
            B.astype(np.int8).tobytes(), parents,
            recons_iter=samples, alpha=0.0, sub_iter=30,
            use_glauber=not args.pivot, num_chains=chains,
            include_self=False)
        t_whole, _ = steady(run)
        print(f"whole sparse recon {t_whole:7.2f}s", file=sys.stderr)
        return

    def pipeline(g, ck, upto):
        pivots = jax.random.randint(pk, (chains,), 0, g.num_nodes)
        emb0s = jax.vmap(lambda kk, x: tree_sample(kk, parents, g, x))(
            jax.random.split(tk, chains), pivots)

        def step(emb, kk):
            if args.pivot:
                emb = pivot_update(kk, B, parents, g, emb)
            else:
                emb = glauber_update(kk, B, parents, g, emb)
            return emb, emb

        def run_chain(kk, e0):
            return jax.lax.scan(step, e0, jax.random.split(kk, per))

        _, embs = jax.vmap(run_chain)(jax.random.split(ck, chains), emb0s)
        embs = embs.reshape(M, k)
        if upto == 0:
            return jnp.sum(embs)
        X = pair_matrices_T(g, embs).astype(W.dtype)
        if upto == 1:
            return jnp.sum(X)
        H = nonneg_code(X, W, key=hk, alpha=0.0, sub_iter=30,
                        stopping_diff=None)
        vals_T = W @ H
        if upto == 2:
            return jnp.sum(vals_T)
        ii, jj, sums, cnt = _group_painted(embs, vals_T, g.num_nodes,
                                           include_self=False)
        return jnp.sum(sums) + jnp.sum(cnt)

    jitted = jax.jit(pipeline, static_argnames=("upto",))
    names = ["chain scan", "+patches", "+code/vals", "+grouping"]
    prev = 0.0
    for upto in range(4):
        t, _ = steady(lambda u=upto: jitted(g, ck, u))
        print(f"{names[upto]:<12} {t:7.2f}s  (delta {t - prev:+7.2f}s)",
              file=sys.stderr)
        prev = t
    print(f"[scan @ {chains} chains x {per} steps; {M} samples]",
          file=sys.stderr)


if __name__ == "__main__":
    main()
