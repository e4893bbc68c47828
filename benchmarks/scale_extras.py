"""Beyond-reference-scale extras: large-graph NDL and a long-run soak.

Not part of ``run_all.py``: run manually with
``python benchmarks/scale_extras.py [--out F]``; prints one JSON line
(``--out`` also merges the records into F).

1. **32,400-node torus NDL** (180x180; 1.7x the arxiv node count, 2.6x
   the dense-representation limit in memory terms): trains and sparsely
   reconstructs via ``BitsetGraph`` on one chip — the structured-graph
   analogue of the arxiv run with a known-good target (torus recon
   should be ~perfect).
2. **500k-step training soak**: one fused scan of 500,000 online steps
   at the bench shape — numerical-stability evidence for long
   production runs (finite objective, valid dictionary, no NaN).
"""

import json
import os
import sys
import time

import numpy as np

def _write_results(results, out):
    """Merge ``results`` into the JSON file ``out`` (when given), over
    its current on-disk contents, so a record written to the file while
    a long run is in flight survives this run's writes."""
    if not out:
        return
    merged = {}
    if os.path.exists(out):
        try:
            with open(out) as f:
                merged = json.load(f)
        except (OSError, json.JSONDecodeError):
            merged = {}
    merged.update(results)
    with open(out, "w") as f:
        json.dump(merged, f, indent=2)


def probe_steady():
    """Fixed probe program timed steady-state right before a scale
    record: ~7 TFLOP of chained 4096x4096 matmuls in one jit,
    second-run (cached-compile) wall. Storing the probe wall in the
    record makes walls from different runs (and cards at different
    power limits) comparable — compare record walls only after scaling
    by the probe ratio."""
    import jax
    import jax.numpy as jnp
    from run_all import steady

    @jax.jit
    def prog(x, w):
        def body(c, _):
            c = c @ w
            c = c * (2.0 / (1.0 + jnp.max(jnp.abs(c))))
            return c, ()
        c, _ = jax.lax.scan(body, x, None, length=50)
        return jnp.sum(c)

    x = jnp.full((4096, 4096), 0.5, jnp.float32)
    w = jnp.eye(4096, dtype=jnp.float32)
    t, _ = steady(lambda: prog(x, w))
    print(f"probe {t:.3f}s", file=sys.stderr)
    return round(t, 3)


def torus_edges(m):
    # vectorized, preserving the per-node (down, right) edge order of
    # the obvious double loop exactly — node interning in the graph
    # builders is first-appearance, so edge ORDER determines node ids
    # and hence the seeded chain draws of the standing records
    u = np.arange(m * m, dtype=np.int64).reshape(m, m)
    src = u.reshape(-1)
    down = np.roll(u, -1, axis=0).reshape(-1)
    right = np.roll(u, -1, axis=1).reshape(-1)
    e = np.empty((2 * m * m, 2), np.int64)
    e[0::2, 0] = src
    e[0::2, 1] = down
    e[1::2, 0] = src
    e[1::2, 1] = right
    return e


def ba_edges(n, m=2, seed=0, chunk=4096):
    """Preferential-attachment (Barabási–Albert) edge list: the
    heavy-tailed benchmark input (max_deg ~ m*sqrt(n) vs mean 2m — a
    1M-node m=2 graph has hubs near degree 2,000 against a mean of 4).
    Standard repeated-endpoint bag; targets for a chunk of new nodes
    are drawn against the bag as of the chunk start (chunk-stale
    weights — same tail exponent, vectorized: an exact per-node loop is
    minutes of Python at 1M nodes). Seeded from an
    (m+1)-clique; duplicate targets within a node are deduped by the
    graph builders. Node labels equal first-appearance order by
    construction (sources ascend, targets precede their sources)."""
    rng = np.random.default_rng(seed)
    if not n > m >= 1:
        raise ValueError(f"need n > m >= 1, got n={n} m={m}")
    init = np.asarray([(i, j) for i in range(m + 1) for j in range(i)],
                      np.int64)
    cap = 2 * (m * n + init.shape[0])
    bag = np.empty(cap, np.int64)
    bl = init.size
    bag[:bl] = init.reshape(-1)
    pieces = [init]
    node = m + 1
    while node < n:
        # cap each chunk so it adds at most as many bag entries as
        # already exist (staleness bounded 2x): an unbounded first
        # chunk would attach thousands of nodes to the seed clique and
        # inflate the hubs far past the BA max_deg ~ m*sqrt(n) tail
        c = min(chunk, n - node, max(1, bl // (2 * m)))
        tgt = bag[rng.integers(0, bl, c * m)]
        src = np.repeat(np.arange(node, node + c, dtype=np.int64), m)
        e = np.stack([src, tgt], axis=1)
        pieces.append(e)
        bag[bl:bl + e.size] = e.reshape(-1)
        bl += e.size
        node += c
    return np.concatenate(pieces, axis=0)


def big_ba_ndl(n=1_048_576, m=2, recons_iter=4_800_000, num_chains=16384,
               chunks=1, cap=None, train_chunk=0):
    """Heavy-tailed (power-law) NDL at scale: CsrGraph train + sparse
    reconstruction on a Barabási–Albert graph. Training uses the Glauber
    chain and reconstruction the Pivot chain — the reference's own
    recommended configuration for real networks ("keep false to use
    Pivot chain for recons.", network_reconstruction_nx.py:573-574);
    the Glauber move routes through the sorted-multiplicity
    intersection and the reconstruction pair fetch through the
    sort-join membership kernel (samplers/motif.py) that hub rows
    require."""
    from run_all import fence, steady
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges

    import jax.numpy as jnp
    fence(jnp.ones(8))
    t0 = time.time()
    edges = ba_edges(n, m)
    t_gen = time.time() - t0
    t0 = time.time()
    g = csr_graph_from_edges(edges)
    t_load = time.time() - t0
    print(f"BA n={n} m={m}: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"max_deg {g.max_deg}, gen {t_gen:.1f}s, csr built+shipped in "
          f"{t_load:.1f}s", file=sys.stderr)

    def make():
        return NetworkReconstructor(
            source=g, n_components=25, MCMC_iterations=50,
            sub_iterations=30, sample_size=500, batch_size=100, k1=0,
            k2=2, num_chains=16, fast=True, seed=0,
            is_glauber_recons=False)

    probe = probe_steady()
    fence(make().train_dict(checkpoint_every=train_chunk))
    rec = make()
    t0 = time.time()
    rec.train_dict(checkpoint_every=train_chunk); fence(rec.W)
    t_train = time.time() - t0
    t_rec, _ = steady(lambda: rec.reconstruct_network(
        recons_iter=recons_iter, num_chains=num_chains, chunks=chunks,
        cap=cap))
    acc = float(rec.compute_recons_accuracy())
    print(f"train {t_train:.1f}s  recon {t_rec:.1f}s  accuracy {acc:.4f}",
          file=sys.stderr)
    out = {"nodes": int(g.num_nodes), "edges": int(g.num_edges),
           "max_deg": int(g.max_deg), "repr": "csr", "graph": f"ba_m{m}",
           "recon_chain": "pivot",
           "gen_s": round(t_gen, 2), "load_s": round(t_load, 2),
           "train_s": round(t_train, 2), "recon_s": round(t_rec, 2),
           "recons_accuracy": round(acc, 4),
           "recon_samples_m": round(recons_iter / 1e6, 1),
           "recon_chains": num_chains, "probe_s": probe}
    if chunks > 1:
        out["recon_chunks"] = chunks
    if train_chunk:
        out["train_chunk"] = train_chunk
    return out


def facebook_csr(data_dir="/root/reference/Data"):
    """The reference main()'s facebook config (4,039 nodes, max_deg
    1,045 — a REAL skewed-degree graph, 21-node path motif) through the
    CsrGraph + binary-search membership paths, for direct comparison
    with run_all.py's dense-representation config
    (``facebook_ndl_reference_main_config``)."""
    from run_all import fence, steady
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import load_edgelist_csr
    from onmf_ontf_ndl_tpu.samplers import motif

    import jax.numpy as jnp
    fence(jnp.ones(8))
    g = load_edgelist_csr(f"{data_dir}/Networks/facebook_combined.txt")
    assert g.max_deg > motif._BSEARCH_DEG_THRESHOLD

    def make():
        return NetworkReconstructor(
            source=g, n_components=25, MCMC_iterations=20,
            sub_iterations=20, sample_size=500, batch_size=20, k1=0,
            k2=20, alpha=0.1, is_glauber_dict=True,
            is_glauber_recons=False, fast=True, num_chains=8)

    fence(make().train_dict())
    rec = make()
    t0 = time.time()
    rec.train_dict(); fence(rec.W)
    train_s = time.time() - t0
    recon_s, _ = steady(lambda: rec.reconstruct_network(
        recons_iter=100_000, num_chains=256))
    acc = float(rec.compute_recons_accuracy())
    print(f"facebook csr: train {train_s:.1f}s recon {recon_s:.1f}s "
          f"accuracy {acc:.4f}", file=sys.stderr)
    return {"nodes": int(g.num_nodes), "max_deg": int(g.max_deg),
            "repr": "csr", "train_s": round(train_s, 2),
            "recon_s": round(recon_s, 2), "recons_accuracy": round(acc, 4)}


def big_torus_ndl(m=180, recons_iter=1_200_000, num_chains=4096,
                  use_csr=False, chunks=1, cap=None):
    from run_all import fence, steady   # shared fencing/steady helpers
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import (
        bitset_graph_from_edges, csr_graph_from_edges)

    import jax.numpy as jnp
    fence(jnp.ones(8))   # backend init OUTSIDE the load timer
    t0 = time.time()
    build = csr_graph_from_edges if use_csr else bitset_graph_from_edges
    g = build(torus_edges(m))
    t_load = time.time() - t0
    print(f"torus {m}x{m}: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"{'csr' if use_csr else 'bitset'} built+shipped in "
          f"{t_load:.1f}s", file=sys.stderr)

    def make():
        return NetworkReconstructor(
            source=g, n_components=25, MCMC_iterations=50,
            sub_iterations=30, sample_size=500, batch_size=100, k1=0,
            k2=2, num_chains=16, fast=True, seed=0)

    # steady-state walls: the FIRST invocation includes the compile;
    # run each phase twice and report the cached-compile second wall
    probe = probe_steady()
    fence(make().train_dict())
    rec = make()
    t0 = time.time()
    rec.train_dict(); fence(rec.W)
    t_train = time.time() - t0
    t_rec, _ = steady(lambda: rec.reconstruct_network(
        recons_iter=recons_iter, num_chains=num_chains, chunks=chunks,
        cap=cap))
    # accuracy OUTSIDE the timer (same methodology as run_all's network
    # benches)
    acc = float(rec.compute_recons_accuracy())
    print(f"train {t_train:.1f}s  recon {t_rec:.1f}s  accuracy {acc:.4f}",
          file=sys.stderr)
    out = {"nodes": int(g.num_nodes), "edges": int(g.num_edges),
           "repr": "csr" if use_csr else "bitset",
           "load_s": round(t_load, 2), "train_s": round(t_train, 2),
           "recon_s": round(t_rec, 2), "recons_accuracy": round(acc, 4),
           "recon_samples_m": round(recons_iter / 1e6, 1),
           "recon_chains": num_chains, "probe_s": probe}
    if chunks > 1:
        out["recon_chunks"] = chunks
    return out


def soak_500k():
    import jax
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state

    d, r, batch = 300, 25, 1024
    steps = 500_000
    pool = jax.random.uniform(jax.random.key(1), (d, 8192))
    state0 = init_state(jax.random.key(0), d, r)

    def run():
        st, _ = train_dict(state0, pool, iterations=steps + 1,
                           batch_size=batch, alpha=0.0, beta=1.0,
                           stopping_diff=None, track_code=False)
        return st

    jax.block_until_ready(run())           # compile
    t0 = time.time()
    state = jax.block_until_ready(run())
    wall = time.time() - t0
    W = np.asarray(state.W)
    from onmf_ontf_ndl_tpu.ops.coder import nonneg_code

    H = nonneg_code(pool, state.W, key=jax.random.key(2), alpha=0.0,
                    sub_iter=20, stopping_diff=None)
    obj = float(jnp.linalg.norm(pool - state.W @ H)
                / jnp.linalg.norm(pool))
    assert np.isfinite(W).all() and (W >= 0).all()
    assert (np.linalg.norm(W, axis=0) <= 1.0 + 1e-5).all()
    assert np.isfinite(obj), "soak objective went non-finite"
    print(f"soak: {steps} steps in {wall:.1f}s "
          f"({steps * batch / wall / 1e6:.1f}M patches/s), recon proxy "
          f"{obj:.4f}, W finite/nonneg/normed", file=sys.stderr)
    return {"steps": steps, "batch": batch, "wall_s": round(wall, 2),
            "patches_per_s": round(steps * batch / wall),
            "w_finite_nonneg_normed": True}


def serving_throughput():
    """Pure inference (serving) throughput: sparse-code request batches
    against a fixed dictionary — the serving workload is coding, there
    is no dictionary update. Measured per coder mode over a 200-batch
    fused scan (dispatch amortized)."""
    import jax
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.ops.coder import nonneg_code_gram

    d, r, batch, reps = 300, 25, 16384, 200
    W = jax.random.uniform(jax.random.key(0), (d, r))
    X = jax.random.uniform(jax.random.key(1), (d, batch))
    gram = W.T @ W

    out = {}
    for label, kw in (
        ("bcd10_fixed", dict(sub_iter=10, stopping_diff=None)),
        ("fista20", dict(sub_iter=20, stopping_diff=None,
                         method="fista")),
        ("fista20_bf16", dict(sub_iter=20, stopping_diff=None,
                              method="fista_bf16")),
    ):
        def many(x):
            def body(c, _):
                # per-request cost INCLUDES the projection W^T x (the
                # c*0 anti-hoist keeps it inside the scan body)
                proj = W.T @ (x + c * 0)
                H = nonneg_code_gram(gram, proj, proj * 0 + 0.5,
                                     alpha=1.0, **kw)
                return jnp.sum(H) * 1e-20, ()

            c, _ = jax.lax.scan(body, jnp.float32(0), (), length=reps)
            return c

        g = jax.jit(many)
        jax.block_until_ready(g(X))
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(g(X))
            best = min(best, time.time() - t0)
        pps = reps * batch / best
        print(f"serving {label}: {pps/1e6:.0f}M patches/s", file=sys.stderr)
        out[label + "_patches_per_s"] = round(pps)
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=180,
                    help="torus side (256 = the 65,536-node packed-key "
                         "host-fetch boundary)")
    ap.add_argument("--torus-only", action="store_true",
                    help="record only the torus point (skip re-measuring "
                         "serving/soak)")
    ap.add_argument("--csr", action="store_true",
                    help="use the pure-CSR O(E) representation (the "
                         "million-node path)")
    ap.add_argument("--recon-samples", type=int, default=None,
                    help="override the reconstruction sample budget")
    ap.add_argument("--chains", type=int, default=None,
                    help="override the recon chain-ensemble width")
    ap.add_argument("--chunks", type=int, default=1,
                    help="fold the recon budget through the chunked "
                         "accumulator (sample budgets beyond device "
                         "memory; "
                         "apps/network.py "
                         "reconstruct_network_sparse_chunked)")
    ap.add_argument("--cap", type=int, default=None,
                    help="chunked-accumulator capacity (distinct painted "
                         "pairs; default 2x a chunk's paint count — for "
                         "a degree-d graph with the k=3 path motif, "
                         "~(d^2+d) * N is a safe structural bound)")
    ap.add_argument("--facebook-csr", action="store_true",
                    help="run the reference's facebook config through "
                         "CsrGraph + binary-search membership (real "
                         "skewed-degree graph, max_deg 1045)")
    ap.add_argument("--ba", type=int, default=0, metavar="N",
                    help="heavy-tailed mode: run a Barabási–Albert graph "
                         "with N nodes instead of a torus (Glauber "
                         "training + Pivot reconstruction, the "
                         "reference's recommended real-network config)")
    ap.add_argument("--ba-m", type=int, default=2,
                    help="BA attachment count (mean degree 2m)")
    ap.add_argument("--train-chunk", type=int, default=0,
                    help="split training into device programs of this "
                         "many MCMC iterations (0 = one fused scan). "
                         "Identical math.")
    ap.add_argument("--out", default=None,
                    help="JSON record file to merge the results into")
    args = ap.parse_args()
    results = {}
    scale = (args.side / 180.0) ** 2
    if args.facebook_csr:
        results["facebook_ndl_csr_bsearch"] = facebook_csr()
        _write_results(results, args.out)
        print(json.dumps(
            {"facebook_ndl_csr_bsearch": results["facebook_ndl_csr_bsearch"]}))
        return
    if args.ba:
        key = f"ba_{args.ba}_scale_ndl_csr"
        chains = args.chains or 16384
        samples = (args.recon_samples
                   or min(5 * args.ba, 19_200_000) * max(args.chunks, 1))
        sections = [(key, lambda: big_ba_ndl(
            args.ba, args.ba_m, recons_iter=samples, num_chains=chains,
            chunks=args.chunks, cap=args.cap,
            train_chunk=args.train_chunk))]
        for name, fn in sections:
            results[name] = fn()
            _write_results(results, args.out)
        print(json.dumps({key: results[key]}))
        return
    key = "torus_32k_scale_ndl" if args.side == 180 else (
        f"torus_{args.side * args.side}_scale_ndl")
    if args.csr:
        key += "_csr"
    # recon sample budget scales with the node count, CAPPED at 4.8M
    # samples (19.2M with CSR): at side 512 the flat bitset alone is
    # 8.6 GB. The cap is a budget statement, not a semantics change
    # (accuracy at the capped budget is what gets recorded). Chain
    # ensemble width: accuracy at a fixed sample budget is
    # coverage-limited (docs/DESIGN.md §4), and wider ensembles are
    # free until the chain-state overhead bites.
    chains = args.chains or (4096 if args.side <= 180 else (
        8192 if args.side <= 360 else (16384 if args.side <= 512
                                       else 65536)))
    cap = 19_200_000 if args.csr else 4_800_000
    samples = args.recon_samples or min(int(1_200_000 * scale), cap)
    # the chunked accumulator lifts the per-piece working set off the
    # device-memory budget, so --chunks also lifts the sample cap
    samples = samples * max(args.chunks, 1) if args.recon_samples is None \
        else samples
    sections = [(key, lambda: big_torus_ndl(
        args.side, recons_iter=samples, num_chains=chains,
        use_csr=args.csr, chunks=args.chunks, cap=args.cap))]
    if not args.torus_only:
        sections += [("serving_throughput", serving_throughput),
                     ("soak_500k_steps", soak_500k)]
    for name, fn in sections:
        try:
            results[name] = fn()
        except Exception as e:          # noqa: BLE001 — record and go on
            print(f"{name} FAILED: {e}", file=sys.stderr)
        _write_results(results, args.out)
    print(json.dumps({k: results[k] for k in
                      (key, "serving_throughput", "soak_500k_steps")
                      if k in results}))


if __name__ == "__main__":
    main()
