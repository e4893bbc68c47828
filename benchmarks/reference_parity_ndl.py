"""End-to-end NDL reconstruction-accuracy parity vs the reference.

Runs the reference's OWN network-dictionary-learning code
(``network_reconstruction_nx.py``: Glauber motif sampling, warm-started
``Online_NMF`` rounds, per-patch exact-LARS reconstruction coding with
running per-edge averages, rounding to a simple graph) next to our
``NetworkReconstructor`` on the same torus graph at the same config, and
compares the reconstruction accuracies ``|E(G ∩ G_recons)| / |E(G)|``
(``:444-524``).

Both sides run their own MCMC chains (different RNGs — the comparison is
statistical, at the accuracy level), their own training, and their own
reconstruction; the criterion is that both accuracies land at the same
level (torus: ~1.0) within a small absolute gap.

Replica-loop notes: the reference's driver methods are mid-refactor
(``train_dict`` calls ``Online_NMF(ini_A=...)`` which ``src/onmf.py`` no
longer accepts — SURVEY.md §1 API drift), so training threads the state
across ``Online_NMF`` instances the way the driver intends
(``ini_agg=[A, B]`` + accumulated history), calling only reference code
for sampling (``get_patches_glauber``) and numerics (``train_dict``).

Runs on CPU. Usage:
  python benchmarks/reference_parity_ndl.py [--adj PATH] [--out JSON]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REF = "/root/reference"
RANK = 25
K1, K2 = 0, 2            # 3-node path motif
MCMC_ITER = 25           # outer rounds
SAMPLE_SIZE = 200        # patches per round
INNER = 30               # Online_NMF iterations per round
BATCH = 20
RECONS_ITER = 3000


def _ref_reconstructor(nx_graph):
    sys.path.insert(0, REF)
    try:
        import network_reconstruction_nx as net
    finally:
        sys.path.remove(REF)
    cls = net.Network_Reconstructor
    obj = cls.__new__(cls)
    obj.G = nx_graph
    obj.k1, obj.k2 = K1, K2
    obj.sample_size = SAMPLE_SIZE
    obj.is_glauber_dict = True
    obj.is_glauber_recons = True
    return obj


def run_reference(A):
    import networkx as nx

    sys.path.insert(0, REF)
    try:
        from src.onmf import Online_NMF
    finally:
        sys.path.remove(REF)
    from sklearn.decomposition import SparseCoder

    np.random.seed(5)
    G = nx.from_numpy_array(A)
    obj = _ref_reconstructor(G)
    B = obj.path_adj(K1, K2)
    k = B.shape[0]
    x0 = np.random.choice(np.asarray([i for i in G]))
    emb = obj.tree_sample(B, x0)

    W, Ag, Bg, hist, nmf = None, None, None, 0.0, None
    for _ in range(MCMC_ITER):
        X, emb = obj.get_patches_glauber(B, emb)
        nmf = Online_NMF(X, n_components=RANK, iterations=INNER,
                         batch_size=BATCH, ini_dict=W,
                         ini_agg=None if W is None else [Ag, Bg],
                         history=hist, alpha=None)
        W, aggs, _ = nmf.train_dict()
        Ag, Bg = aggs[0], aggs[1]
        hist = nmf.history   # the reference's own bookkeeping

    # reference reconstruction loop (network_reconstruction_nx.py:444-508)
    n = A.shape[0]
    recon_w = np.zeros((n, n))
    cnt = np.zeros((n, n))
    x0 = np.random.choice(np.asarray([i for i in G]))
    emb = obj.tree_sample(B, x0)
    for _ in range(RECONS_ITER):
        patch, emb = obj.get_single_patch_glauber(B, emb)
        coder = SparseCoder(dictionary=W.T, transform_n_nonzero_coefs=None,
                            transform_alpha=0,
                            transform_algorithm="lasso_lars",
                            positive_code=True)
        code = coder.transform(patch.T)
        pr = (W @ code.T).reshape(k, k)
        for qi in range(k):
            for qj in range(k):
                a, b = emb[qi], emb[qj]
                j = cnt[a, b]
                recon_w[a, b] = (j * recon_w[a, b] + pr[qi, qj]) / (j + 1)
                cnt[a, b] += 1
    simple = (np.round(recon_w) > 0) & (cnt > 0)
    simple = simple | simple.T
    hits = int(np.triu(simple & (A > 0), 1).sum())
    acc = hits / int(np.triu(A > 0, 1).sum())
    return float(acc)


def run_ours(A):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency

    g = graph_from_adjacency(A > 0)
    rec = NetworkReconstructor(
        source=g, n_components=RANK, MCMC_iterations=MCMC_ITER,
        sub_iterations=INNER, sample_size=SAMPLE_SIZE, batch_size=BATCH,
        k1=K1, k2=K2, is_glauber_dict=True, is_glauber_recons=True, seed=5)
    rec.train_dict()
    rec.reconstruct_network(recons_iter=RECONS_ITER)
    return float(rec.compute_recons_accuracy())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--adj", default=f"{REF}/Data/torus_adj.txt")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    A = np.loadtxt(args.adj)
    t0 = time.time()
    acc_ref = run_reference(A)
    t_ref = time.time() - t0
    print(f"reference ndl torus accuracy {acc_ref:.4f} ({t_ref:.0f}s)",
          file=sys.stderr)
    t0 = time.time()
    acc_ours = run_ours(A)
    t_ours = time.time() - t0
    print(f"ours      ndl torus accuracy {acc_ours:.4f} ({t_ours:.0f}s)",
          file=sys.stderr)
    result = {
        "config": {"rank": RANK, "k1": K1, "k2": K2,
                   "mcmc_iterations": MCMC_ITER,
                   "sample_size": SAMPLE_SIZE, "inner": INNER,
                   "batch": BATCH, "recons_iter": RECONS_ITER,
                   "graph": os.path.basename(args.adj)},
        "recons_accuracy_reference": round(acc_ref, 4),
        "recons_accuracy_ours": round(acc_ours, 4),
        "abs_gap": round(abs(acc_ours - acc_ref), 4),
        "within_5pts": bool(abs(acc_ours - acc_ref) <= 0.05),
        "wall_s_reference": round(t_ref, 2),
        "wall_s_ours_cpu": round(t_ours, 2),
    }
    print(json.dumps(result))
    if args.out:
        data_out = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                data_out = json.load(f)
        data_out["ndl_accuracy_vs_reference"] = result
        with open(args.out, "w") as f:
            json.dump(data_out, f, indent=2)


if __name__ == "__main__":
    main()
