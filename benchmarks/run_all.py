"""Run the five reference evaluation configs and print wall-clock +
quality metrics as one JSON line (``--out F`` also merges them into F).

Configs:
  1. grayscale ONMF on renoir        (image_reconstruction.py main)
  2. color ONTF joint dictionary     (image_reconstruction_tensor.py main)
  3. Ising trajectory learning       (ising_reconstruction.py ising_sim)
  4. NDL on the torus + a WAN matrix (network_reconstruction_nx.py main)
  5. streaming video                 (online_learning_video demo)

Usage: python benchmarks/run_all.py [--data /root/reference/Data]
[--reference-semantics]

Fast mode (fixed coder sweeps) is the default; pass
--reference-semantics for the early-stopping coder and sequential parity
samplers. Every config reads the reference checkout's data files.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def fence(x):
    """Wait until every array in ``x`` is computed; returns ``x``."""
    import jax

    return jax.block_until_ready(x)


def steady(fn):
    """Run fn twice, fencing each, and return (second_wall, result): the
    first invocation pays the compile, the second is the steady-state
    wall."""
    r = fn()
    fence(r)
    t0 = time.time()
    r = fn()
    fence(r)
    return time.time() - t0, r


def bench_image(data_dir, fast):
    from onmf_ontf_ndl_tpu.apps.image import ImageReconstructor

    path = f"{data_dir}/renoir/0.jpg"
    rec = ImageReconstructor(path=path, n_components=25, iterations=100,
                             sub_iterations=10, num_patches=100,
                             batch_size=32, patch_size=10, is_color=False,
                             fast=fast)
    t0 = time.time()
    W = rec.train_dict(); fence(W)
    train_s = time.time() - t0
    # steady state: same shapes, compile cached, fresh state — robust to
    # the remote compile service's variable latency
    rec_b = ImageReconstructor(path=path, n_components=25, iterations=100,
                               sub_iterations=10, num_patches=100,
                               batch_size=32, patch_size=10, is_color=False,
                               fast=fast, seed=1)
    t0 = time.time()
    Wb = rec_b.train_dict(); fence(Wb)
    train_steady_s = time.time() - t0
    t0 = time.time()
    out = rec.reconstruct_image(path=path, downscale_factor=2)
    fence(out)
    recon_s = time.time() - t0
    # steady-state inference (serving) throughput: the same full-grid
    # reconstruction with the compile cached — every overlapping patch
    # coded (10 sweeps) + overlap-folded
    t0 = time.time()
    out2 = rec.reconstruct_image(path=path, downscale_factor=2)
    fence(out2)
    recon_steady_s = time.time() - t0
    k = rec.patch_size
    n_grid_patches = (out.shape[0] - k + 1) * (out.shape[1] - k + 1)
    from onmf_ontf_ndl_tpu.data.images import load_image, downscale_local_mean
    ref = downscale_local_mean(load_image(path, is_color=False), 2)
    err = float(np.linalg.norm(np.asarray(out) - np.asarray(ref))
                / np.linalg.norm(np.asarray(ref)))
    # subsample=False: every inner step trains on the full num_patches
    # columns; train_dict runs (sub_iterations - 1) inner steps per outer
    steps = rec.iterations * (rec.sub_iterations - 1) * rec.num_patches
    return {"train_s": round(train_s, 2),
            "train_steady_s": round(train_steady_s, 3),
            "recon_s": round(recon_s, 2),
            "recon_steady_s": round(recon_steady_s, 3),
            "inference_patches_per_s": round(n_grid_patches / recon_steady_s),
            "patches_per_s": round(steps / train_steady_s),
            "recon_rel_err": round(err, 4)}


def bench_tensor(data_dir, fast):
    from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor

    def make():
        return ImageReconstructorTensor(
            path=f"{data_dir}/renoir/0.jpg", n_components=100,
            iterations=20, sub_iterations=2, batch_size=100,
            block_iterations=4, num_patches=100, patch_size=20, fast=fast)

    fence(make().train_dict(mode=2, learn_joint_dict=True))  # compile+fence
    rec = make()
    t0 = time.time()
    W = rec.train_dict(mode=2, learn_joint_dict=True); fence(W)
    return {"train_s": round(time.time() - t0, 2), "W_shape": list(W.shape)}


def bench_ising(fast):
    from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor

    def make():
        return IsingReconstructor(
            n_components=100, lattice_size=200, ising_iterations=20,
            temperature=5.0, ising_subsampling_steps=40000,
            sub_iterations=20, batch_size=50, num_patches=1000,
            patch_size=20, beta=1.0,
            sampler="checkerboard",
            fast=fast)

    fence(make().ising_mcmc_learning()[2])               # compile+fence
    rec = make()
    t0 = time.time()
    _, dicts, errors = rec.ising_mcmc_learning(); fence(errors)
    e = np.asarray(errors)
    return {"wall_s": round(time.time() - t0, 2),
            "surrogate_first": round(float(e[0]), 1),
            "surrogate_last": round(float(e[-1]), 1)}


def bench_network(data_dir, fast):
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import graph_from_adjacency

    A = np.genfromtxt(f"{data_dir}/torus_adj.txt")

    def make():
        return NetworkReconstructor(
            source=graph_from_adjacency(A), n_components=25,
            MCMC_iterations=50, sub_iterations=50, sample_size=500,
            batch_size=20, k1=0, k2=2, alpha=0.1,
            is_glauber_recons=False, fast=fast)

    fence(make().train_dict())            # compile + fence the warm-up
    rec = make()
    t0 = time.time()
    rec.train_dict(); fence(rec.W)
    train_s = time.time() - t0
    recon_s, _ = steady(lambda: rec.reconstruct_network(
        recons_iter=20000, num_chains=64 if fast else 1))
    # accuracy is computed OUTSIDE the recon timer: it ships the (N, N)
    # reconstruction to the host
    acc = rec.compute_recons_accuracy()

    # WAN matrix — reference semantics: the weighted matrix shapes the
    # graph STRUCTURE (A/max > 0) but patches are binary has_edge
    # indicators even for WAN (chd_gen_mx,
    # network_reconstruction_nx.py:301-305)
    wan = np.genfromtxt(f"{data_dir}/WAN/austen_1.txt", usecols=range(211))
    def make_wan(weighted):
        return NetworkReconstructor(adjacency=wan, is_WAN=True,
                                    weighted_patches=weighted,
                                    n_components=25,
                                    MCMC_iterations=10, sub_iterations=20,
                                    sample_size=200, batch_size=20,
                                    k1=0, k2=2, fast=fast)

    fence(make_wan(False).train_dict())   # compile + fence
    rec2 = make_wan(False)
    t0 = time.time()
    rec2.train_dict(); fence(rec2.W)
    wan_s = time.time() - t0
    # weighted-patch EXTENSION (patches carry the normalized weights —
    # beyond the reference's binary patches)
    fence(make_wan(True).train_dict())    # compile + fence
    rec3 = make_wan(True)
    t0 = time.time()
    rec3.train_dict(); fence(rec3.W)
    wan_w_s = time.time() - t0
    return {"torus_train_s": round(train_s, 2),
            "torus_recon_s": round(recon_s, 2),
            "torus_accuracy": round(acc, 4),
            "wan_train_s": round(wan_s, 2),
            "wan_weighted_train_s": round(wan_w_s, 2)}


def bench_arxiv(data_dir, fast):
    """Beyond-dense scale: NDL + sparse reconstruction on the 18,772-node
    arxiv graph (BitsetGraph + segment-mean reconstruction — the dense
    (N, N) canvases would be ~2.8 GB and the result could never come back
    over the host link)."""
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor
    from onmf_ontf_ndl_tpu.data.graphs import load_edgelist_bitset

    g = load_edgelist_bitset(f"{data_dir}/Networks/arxiv.txt")

    def make():
        return NetworkReconstructor(
            source=g, n_components=25, MCMC_iterations=50,
            sub_iterations=30, sample_size=1000, batch_size=50, k1=0,
            k2=2, alpha=0.1, is_glauber_recons=False, fast=fast,
            num_chains=16)

    fence(make().train_dict())            # compile + fence the warm-up
    rec = make()
    t0 = time.time()
    rec.train_dict(); fence(rec.W)
    train_s = time.time() - t0
    # 1.2M samples / 1024 chains: same recon wall as 400k/256 (the
    # chains are vmapped), much better coverage -> accuracy 0.994
    recon_s, edges = steady(lambda: rec.reconstruct_network(
        recons_iter=1_200_000, num_chains=1024))
    acc = rec.compute_recons_accuracy()   # host fetch outside the timer
    return {"nodes": g.num_nodes, "edges": g.num_edges,
            "train_s": round(train_s, 2), "recon_s": round(recon_s, 2),
            "recon_edges": int(len(edges)),
            "recons_accuracy": round(acc, 4)}


def bench_facebook(data_dir, fast):
    """The reference main()'s own config: facebook_combined (4039 nodes,
    88k edges), 21-node path motif k1=0/k2=20, rank 25
    (``network_reconstruction_nx.py:536-574``)."""
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor

    def make():
        return NetworkReconstructor(
            source=f"{data_dir}/Networks/facebook_combined.txt",
            n_components=25, MCMC_iterations=20, sub_iterations=20,
            sample_size=500, batch_size=20, k1=0, k2=20, alpha=0.1,
            is_glauber_dict=True, is_glauber_recons=False, fast=fast,
            num_chains=8)

    fence(make().train_dict())            # compile + fence the warm-up
    rec = make()
    t0 = time.time()
    rec.train_dict(); fence(rec.W)
    train_s = time.time() - t0
    # 100k samples / 256 chains: faster than 20k/64 (fewer sequential
    # steps per chain) and much better coverage -> accuracy 0.995
    recon_s, _ = steady(lambda: rec.reconstruct_network(
        recons_iter=100_000, num_chains=256))
    acc = rec.compute_recons_accuracy()   # host fetch outside the timer
    return {"nodes": rec.G.num_nodes,
            "train_s": round(train_s, 2), "recon_s": round(recon_s, 2),
            "recons_accuracy": round(acc, 4)}


def bench_video(data_dir, fast):
    from onmf_ontf_ndl_tpu.apps.video import VideoDictionaryLearner

    def make():
        return VideoDictionaryLearner(
            path=f"{data_dir}/Video/giphy-2.gif", n_components=25,
            sub_iterations=5, num_patches=100, batch_size=25,
            patch_size=7, fast=fast)

    fence(make().train_dict(epochs=2))                   # compile+fence
    v = make()
    t0 = time.time()
    W = v.train_dict(epochs=2); fence(W)
    return {"train_s": round(time.time() - t0, 2),
            "frames": int(v.frames.shape[0])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="/root/reference/Data")
    # fast mode is the default (see module docstring); kept as an
    # explicit flag so "--fast" remains valid in scripts
    ap.add_argument("--fast", action="store_true", default=True)
    ap.add_argument("--reference-semantics", dest="fast",
                    action="store_false")
    ap.add_argument("--out", default=None,
                    help="JSON record file to merge the results into")
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings: refresh only the "
                         "matching record keys (e.g. --only arxiv,video); "
                         "other standing records are left untouched")
    args = ap.parse_args()

    only = [s for s in (args.only or "").split(",") if s]
    results = {} if only else {"fast_mode": args.fast}
    for name, fn in [
        ("image_grayscale_onmf", lambda: bench_image(args.data, args.fast)),
        ("color_ontf_joint", lambda: bench_tensor(args.data, args.fast)),
        ("ising_trajectory", lambda: bench_ising(args.fast)),
        ("network_dictionary_learning",
         lambda: bench_network(args.data, args.fast)),
        ("arxiv_scale_ndl", lambda: bench_arxiv(args.data, args.fast)),
        ("facebook_ndl_reference_main_config",
         lambda: bench_facebook(args.data, args.fast)),
        ("streaming_video", lambda: bench_video(args.data, args.fast)),
    ]:
        if only and not any(s in name for s in only):
            continue
        try:
            results[name] = fn()
            print(f"{name}: {results[name]}", file=sys.stderr, flush=True)
        except Exception as e:  # keep going; record the failure
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"{name}: FAILED {e}", file=sys.stderr, flush=True)

    # merge over existing keys instead of clobbering the file
    merged = {}
    if args.out and os.path.exists(args.out):
        try:
            with open(args.out) as f:
                merged = json.load(f)
        except (OSError, json.JSONDecodeError):
            merged = {}
    merged.update(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=2)
    print(json.dumps(merged))


if __name__ == "__main__":
    main()
