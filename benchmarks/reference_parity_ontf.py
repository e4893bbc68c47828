"""End-to-end ONTF (color tensor) recon-error parity vs the reference.

The ONMF-path criterion lives in ``reference_parity.py``; this harness
measures the TENSOR pipeline: the reference's
``Image_Reconstructor_tensor`` flow — per-outer-iteration ``Online_NTF``
(mode-2 unfolding, ``learn_joint_dict=True``) warm-started across
instances (``/root/reference/image_reconstruction_tensor.py:220-262``),
then the strided color reconstruction with per-patch sklearn
``SparseCoder(transform_alpha=1, lasso_lars, positive_code)`` coding
(``:287-328``) — next to our ``ImageReconstructorTensor`` at the same
config and seeds.

The two sides use different SOLVERS by design (the reference codes with
sklearn's exact LARS; the tensor app's default coder="exact" solves the
same objective to convergence by accelerated projected gradient —
SURVEY.md §7 hard-part b), so the comparison is reconstruction-level:
both errors must land at the model-class floor, within 5% of each
other, NOT coefficient-level equality. The opt-in "bcd" coder (the ONMF
apps' reference-semantics damped sweeps) is also recorded for color.

Runs on CPU. Usage:
  python benchmarks/reference_parity_ontf.py [--image PATH] [--out JSON]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REF = "/root/reference"
RANK = 24
PATCH = 10
OUTER = 15          # outer warm-started Online_NTF rounds
INNER = 10          # iterations per Online_NTF instance
BLOCK = 2           # sub_iterations (the tensor driver's block_iterations)
NUM_PATCHES = 100
BATCH = 50
DOWNSCALE = 8
STRIDE = 3          # recons_resolution


# refstubs lives next to this file, so it resolves both when run as a
# script (script dir is sys.path[0]) and when the e2e tests import this
# module with benchmarks/ temporarily on sys.path; importing at module
# level caches it for calls made after the tests pop the path again.
import refstubs


def _install_stubs():
    """src/ontf.py imports tensorly + progressbar (absent here); the
    shared installer in ``refstubs.py`` provides real ``unfold``
    semantics and a callable ProgressBar."""
    refstubs.install_stubs()


def extract_random_patches(data, k, num):
    """Reference color patch tensor sampling
    (``image_reconstruction_tensor.py:87-111``): (k^2, 3, num)."""
    cols = []
    for _ in range(num):
        a = np.random.choice(data.shape[0] - k)
        b = np.random.choice(data.shape[1] - k)
        cols.append(data[a:a + k, b:b + k, :].reshape(k * k, 3, 1))
    return np.concatenate(cols, axis=2)


def run_reference(data):
    _install_stubs()
    sys.path.insert(0, REF)
    try:
        from src.ontf import Online_NTF
    finally:
        sys.path.remove(REF)
    from sklearn.decomposition import SparseCoder

    np.random.seed(11)
    W, At, Bt = None, None, None
    ntf = None
    hist = 0
    for t in range(OUTER):
        X = extract_random_patches(data, PATCH, NUM_PATCHES)
        ntf = Online_NTF(X, RANK, iterations=INNER, sub_iterations=BLOCK,
                         batch_size=BATCH, ini_dict=W, ini_A=At, ini_B=Bt,
                         learn_joint_dict=True, mode=2, history=hist)
        W, At, Bt, H = ntf.train_dict_single()
        hist = ntf.history

    # strided color reconstruction, reference coding (alpha=1 LARS) and
    # running overlap average (image_reconstruction_tensor.py:287-328),
    # vectorized over the paint loop (identical arithmetic per patch)
    k = PATCH
    A_recons = np.zeros(data.shape)
    count = np.zeros(data.shape[:2])
    for i in range(0, data.shape[0] - k, STRIDE):
        for j in range(0, data.shape[1] - k, STRIDE):
            patch = data[i:i + k, j:j + k, :].reshape(-1, 1)
            coder = SparseCoder(dictionary=W.T,
                                transform_n_nonzero_coefs=None,
                                transform_alpha=1,
                                transform_algorithm="lasso_lars",
                                positive_code=True)
            code = coder.transform(patch.T)
            pr = (W @ code.T).reshape(k, k, 3)
            c = count[i:i + k, j:j + k][:, :, None]
            A_recons[i:i + k, j:j + k, :] = (
                c * A_recons[i:i + k, j:j + k, :] + pr) / (c + 1)
            count[i:i + k, j:j + k] += 1
    painted = count > 0
    err = (np.linalg.norm((A_recons - data)[painted])
           / np.linalg.norm(data[painted]))
    return float(err), W


def run_ours(data, coder=None):
    """coder=None runs the app DEFAULT (coder="exact": converged
    accelerated PGD, the parity match for the reference's exact sklearn
    LARS solve)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor

    kwargs = {} if coder is None else {
        "coder": coder,
        "coder_sub_iter": (50 if coder == "fista" else None)}
    rec = ImageReconstructorTensor(
        data=jnp.asarray(data), n_components=RANK, iterations=OUTER,
        sub_iterations=INNER, block_iterations=BLOCK,
        num_patches=NUM_PATCHES, batch_size=BATCH, patch_size=PATCH,
        dtype=jnp.float64, seed=11, **kwargs)
    rec.train_dict(mode=2, learn_joint_dict=True)
    img = np.asarray(rec.reconstruct_image_color(
        data=data, recons_resolution=STRIDE, alpha=1.0))
    # compare on the same painted region the reference covers (our
    # conv-grid recon paints the full strided grid; the strided loops
    # cover the same area up to the exclusive end)
    k = PATCH
    count = np.zeros(data.shape[:2])
    for i in range(0, data.shape[0] - k, STRIDE):
        for j in range(0, data.shape[1] - k, STRIDE):
            count[i:i + k, j:j + k] += 1
    painted = count > 0
    err = (np.linalg.norm((img - data)[painted])
           / np.linalg.norm(data[painted]))
    return float(err), np.asarray(rec.W)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=f"{REF}/Data/renoir/0.jpg")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from PIL import Image
    img = np.asarray(Image.open(args.image).convert("RGB")) / 255.0
    H = img.shape[0] // DOWNSCALE * DOWNSCALE
    W = img.shape[1] // DOWNSCALE * DOWNSCALE
    data = img[:H, :W].reshape(H // DOWNSCALE, DOWNSCALE,
                               W // DOWNSCALE, DOWNSCALE, 3).mean((1, 3))

    t0 = time.time()
    err_ref, _ = run_reference(data)
    t_ref = time.time() - t0
    print(f"reference ontf recon_rel_err {err_ref:.5f} ({t_ref:.0f}s)",
          file=sys.stderr)
    t0 = time.time()
    err_ours, _ = run_ours(data)           # DEFAULT path (coder="exact")
    t_ours = time.time() - t0
    print(f"ours default(exact) ontf recon_rel_err {err_ours:.5f} "
          f"({t_ours:.0f}s)", file=sys.stderr)
    t0 = time.time()
    err_bcd, _ = run_ours(data, coder="bcd")
    t_bcd = time.time() - t0
    print(f"ours bcd   ontf recon_rel_err {err_bcd:.5f} ({t_bcd:.0f}s)",
          file=sys.stderr)
    rel = abs(err_ours - err_ref) / err_ref
    rel_bcd = abs(err_bcd - err_ref) / err_ref
    result = {
        "config": {"rank": RANK, "patch": PATCH, "outer": OUTER,
                   "inner": INNER, "block": BLOCK,
                   "num_patches": NUM_PATCHES, "batch": BATCH,
                   "stride": STRIDE, "downscale": DOWNSCALE,
                   "image": os.path.basename(args.image),
                   "mode": 2, "joint": True},
        "recon_rel_err_reference": round(err_ref, 5),
        "recon_rel_err_ours_default": round(err_ours, 5),
        "recon_rel_err_ours_bcd": round(err_bcd, 5),
        "relative_gap_default": round(rel, 5),
        "relative_gap_bcd": round(rel_bcd, 5),
        # the reference codes with an EXACT lasso solver (sklearn LARS)
        # in both training and reconstruction; the DEFAULT tensor-app
        # coder ("exact", converged accelerated PGD on the same
        # objective) must land within 5% of it. The opt-in "bcd" run
        # (the ONMF apps' reference-semantics sweeps) is recorded for
        # color — its damped t-schedule is NOT the tensor reference's
        # coder and lands several percent higher.
        "within_5pct_default": bool(rel <= 0.05),
        "wall_s_reference": round(t_ref, 2),
        "wall_s_ours_default": round(t_ours, 2),
        "wall_s_ours_bcd": round(t_bcd, 2),
    }
    print(json.dumps(result))
    if args.out:
        data_out = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                data_out = json.load(f)
        data_out["ontf_recon_err_vs_reference"] = result
        with open(args.out, "w") as f:
            json.dump(data_out, f, indent=2)


if __name__ == "__main__":
    main()
