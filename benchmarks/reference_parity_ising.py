"""End-to-end Ising trajectory-learning parity vs the reference.

Runs the reference's OWN code — ``ising_simulator.ising_update`` for the
lattice and ``src/onmf.py``'s ``Online_NMF`` with the full-aggregate
``C = agg X X^T`` path (``train_dict(full_code=True)``) — through a
replica of ``Ising_Reconstructor.ising_mcmc_learning``
(``/root/reference/ising_reconstruction.py:99-179``; the driver itself
raises TypeError as-is, SURVEY.md §1 API drift), next to our
``IsingReconstructor`` at the matched config, comparing the surrogate
error trace ``tr(W A W^T) - 2 tr(W B) + tr(C)`` (``:133,164``).

Matching the reference exactly: the lattice is NOT updated between
rounds (the reference's update line is commented out, ``:144``), both
sides start from the SAME burned-in lattice, and training subsampling is
off (``Online_NMF`` default ``subsample=False``, ``src/onmf.py:32``).

Known semantic difference (PARITY.md deviation #1): the reference's
``train_dict`` rebuilds the aggregates from the call's INITIAL values
every inner iteration (``src/onmf.py:217``), so its aggregates advance
~once per outer round while ours advance every step. The raw surrogate
values are therefore at different points of the ``C``-saturation
schedule (the reference's even increases as tr(C) grows) and are
reported for color only; the parity CRITERION is final dictionary
quality — relative reconstruction error of a held-out patch set, coded
against each side's W by the reference's own coder
(``update_code_within_radius``).

Runs on CPU. Usage:
  python benchmarks/reference_parity_ising.py [--out JSON]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# refstubs lives next to this file: resolves when run as a script
# (script dir is sys.path[0]) and when the e2e tests import this module
# with benchmarks/ temporarily on sys.path (cached for later calls).
import refstubs

REF = "/root/reference"
N = 64              # lattice side
RANK = 25
PATCH = 10
ROUNDS = 12         # ising_iterations (outer)
INNER = 20          # Online_NMF iterations per round
NUM_PATCHES = 300
BATCH = 100
T = 0.5
BETA = 0.8
BURN_SWEEPS = 30    # burn-in sweeps on the shared initial lattice


def extract_random_patches(data, k, num):
    """Reference patch sampling (``ising_reconstruction.py:46-66``)."""
    cols = []
    for _ in range(num):
        a = np.random.choice(data.shape[0] - k)
        b = np.random.choice(data.shape[1] - k)
        cols.append(data[a:a + k, b:b + k].reshape(k * k, 1))
    return np.concatenate(cols, axis=1)


def make_lattice():
    """Shared burned-in lattice from the reference's own sampler."""
    refstubs.install_stubs()
    sys.path.insert(0, REF)
    try:
        import ising_simulator as sim
    finally:
        sys.path.remove(REF)
    np.random.seed(9)
    lattice = np.random.choice([1, -1], size=(N, N))
    lattice, _, _ = sim.ising_update(lattice, nsteps=BURN_SWEEPS * N * N,
                                     J=1, H=0, T=T)
    return lattice


def surrogate(W, A, B, C):
    return float(np.trace(W @ A @ W.T) - 2 * np.trace(W @ B) + np.trace(C))


def run_reference(lattice):
    sys.path.insert(0, REF)
    try:
        from src.onmf import Online_NMF
    finally:
        sys.path.remove(REF)

    np.random.seed(13)
    X = extract_random_patches(lattice, PATCH, NUM_PATCHES)
    nmf = Online_NMF(X, n_components=RANK, iterations=INNER,
                     batch_size=BATCH, beta=BETA)
    W, aggs, _ = nmf.train_dict(full_code=True)
    A, B, C = aggs
    hist = nmf.history
    errors = [surrogate(W, A, B, C)]
    for _ in range(ROUNDS):
        X = extract_random_patches(lattice, PATCH, NUM_PATCHES)
        nmf = Online_NMF(X, n_components=RANK, iterations=INNER,
                         batch_size=BATCH, ini_dict=W, ini_agg=[A, B, C],
                         history=hist, beta=BETA)
        W, aggs, _ = nmf.train_dict(full_code=True)
        A, B, C = aggs
        hist = nmf.history
        errors.append(surrogate(W, A, B, C))
    return errors, W


def run_ours(lattice):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor

    rec = IsingReconstructor(
        n_components=RANK, lattice_size=N, ising_iterations=ROUNDS,
        temperature=T, sub_iterations=INNER, num_patches=NUM_PATCHES,
        batch_size=BATCH, patch_size=PATCH, beta=BETA,
        update_lattice=False, seed=13)
    _, _, errors = rec.ising_mcmc_learning(initial_lattice=lattice)
    return [float(e) for e in np.asarray(errors)], np.asarray(rec.W)


def heldout_recon_err(lattice, W):
    """Relative recon error of a fixed held-out patch set under W, coded
    by the reference's own ``update_code_within_radius`` (alpha=0)."""
    sys.path.insert(0, REF)
    try:
        from src.onmf import update_code_within_radius
    finally:
        sys.path.remove(REF)

    np.random.seed(99)
    X = extract_random_patches(lattice, PATCH, 500)
    H = update_code_within_radius(X, np.asarray(W, np.float64), H0=None,
                                  r=None, alpha=0, sub_iter=50,
                                  stopping_diff=1e-4)
    return float(np.linalg.norm(X - W @ H) / np.linalg.norm(X))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    lattice = make_lattice()
    t0 = time.time()
    err_ref, W_ref = run_reference(lattice)
    t_ref = time.time() - t0
    print(f"reference surrogate: first {err_ref[0]:.1f} last "
          f"{err_ref[-1]:.1f} ({t_ref:.0f}s)", file=sys.stderr)
    t0 = time.time()
    err_ours, W_ours = run_ours(lattice)
    t_ours = time.time() - t0
    print(f"ours      surrogate: first {err_ours[0]:.1f} last "
          f"{err_ours[-1]:.1f} ({t_ours:.0f}s)", file=sys.stderr)

    rec_ref = heldout_recon_err(lattice, W_ref)
    rec_ours = heldout_recon_err(lattice, W_ours)
    print(f"held-out recon rel-err: reference {rec_ref:.5f} "
          f"ours {rec_ours:.5f}", file=sys.stderr)
    rel = abs(rec_ours - rec_ref) / rec_ref
    result = {
        "config": {"lattice": N, "rank": RANK, "patch": PATCH,
                   "rounds": ROUNDS, "inner": INNER,
                   "num_patches": NUM_PATCHES, "batch": BATCH,
                   "temperature": T, "beta": BETA},
        "heldout_recon_err_reference": round(rec_ref, 5),
        "heldout_recon_err_ours": round(rec_ours, 5),
        "relative_gap": round(rel, 5),
        "within_10pct": bool(rel <= 0.10),
        # informational: the raw surrogate traces sit at different points
        # of the C-saturation schedule (PARITY.md deviation #1 — the
        # reference's aggregates advance ~once per round, ours every
        # step), so they are not directly comparable
        "surrogate_trace_reference": [round(e, 1) for e in err_ref],
        "surrogate_trace_ours": [round(e, 1) for e in err_ours],
        "wall_s_reference": round(t_ref, 2),
        "wall_s_ours_cpu": round(t_ours, 2),
    }
    print(json.dumps(result))
    if args.out:
        data_out = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                data_out = json.load(f)
        data_out["ising_surrogate_vs_reference"] = result
        with open(args.out, "w") as f:
            json.dump(data_out, f, indent=2)


if __name__ == "__main__":
    main()
