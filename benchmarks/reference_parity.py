"""End-to-end reconstruction-error parity vs the reference pipeline.

Runs the REFERENCE'S OWN code (``/root/reference/src/onmf.py``) through a
minimal replica of its image driver loop
(``/root/reference/image_reconstruction.py:277-356``) and our
``ImageReconstructor`` side by side on the same grayscale image at the
same config (rank 25, 10x10 patches, fixed seeds), then compares the
relative reconstruction errors — the BASELINE.md "recon error within 1%
of reference" criterion, measured rather than assumed.

Driver notes (why a replica loop and not the reference driver itself):
the reference repo is mid-refactor — its drivers call ``Online_NMF`` with
``ini_A=/ini_B=`` kwargs and unpack a 5-tuple, while ``src/onmf.py``
takes ``ini_agg=[A, B]`` and returns 3 values (SURVEY.md §1 "API drift";
the drivers raise TypeError as-is). This harness threads the state across
``Online_NMF`` instances exactly as the drivers intend (warm-started
dict + aggregates + accumulated history), calling only reference code for
every numerical step: ``Online_NMF.train_dict`` for training and
``Online_NMF.sparse_code`` (= ``update_code_within_radius`` with its
driver defaults) for reconstruction coding. The patch fold uses sklearn's
``reconstruct_from_patches_2d``, the reference's own grayscale recon
(``image_reconstruction.py:340-356``).

Runs on CPU (float64) — this measures numerics parity, not speed.

Usage: python benchmarks/reference_parity.py [--image PATH] [--out JSON]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REF = "/root/reference"
RANK = 25
PATCH = 10
OUTER = 50
INNER = 10
NUM_PATCHES = 100
DOWNSCALE = 4


def extract_random_patches(rng, data, k, num):
    """Reference random patch sampling (grayscale branch of
    ``image_reconstruction.py:173-206``), batched."""
    a = rng.integers(0, data.shape[0] - k, size=num)
    b = rng.integers(0, data.shape[1] - k, size=num)
    cols = [data[a[i]:a[i] + k, b[i]:b[i] + k].reshape(k * k)
            for i in range(num)]
    return np.stack(cols, axis=1)


def all_grid_patches(data, k):
    """Every overlapping k x k patch, row-major — the order of sklearn's
    ``extract_patches_2d`` used by the reference recon path."""
    H, W = data.shape
    out = np.empty(((H - k + 1) * (W - k + 1), k, k), data.dtype)
    idx = 0
    for i in range(H - k + 1):
        for j in range(W - k + 1):
            out[idx] = data[i:i + k, j:j + k]
            idx += 1
    return out


def run_reference(data):
    sys.path.insert(0, REF)
    try:
        from src.onmf import Online_NMF
    finally:
        sys.path.remove(REF)
    from sklearn.feature_extraction.image import reconstruct_from_patches_2d

    rng = np.random.default_rng(7)
    np.random.seed(7)
    W, A, B = None, None, None
    hist = 0.0
    nmf = None
    for t in range(OUTER):
        X = extract_random_patches(rng, data, PATCH, NUM_PATCHES)
        nmf = Online_NMF(X, n_components=RANK, iterations=INNER,
                         batch_size=NUM_PATCHES,
                         ini_dict=W, ini_agg=None if W is None else [A, B],
                         history=hist, alpha=None)
        W, aggs, _ = nmf.train_dict()
        A, B = aggs[0], aggs[1]
        hist += INNER  # the schedule continuation the drivers intend
    patches = all_grid_patches(data, PATCH)
    code = nmf.sparse_code(patches.reshape(len(patches), -1).T, W)
    recons = (W @ code).T.reshape(len(patches), PATCH, PATCH)
    img = reconstruct_from_patches_2d(recons, data.shape)
    return float(np.linalg.norm(img - data) / np.linalg.norm(data))


def run_ours(data):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.image import ImageReconstructor

    rec = ImageReconstructor(
        data=jnp.asarray(data), n_components=RANK, iterations=OUTER,
        sub_iterations=INNER, num_patches=NUM_PATCHES,
        batch_size=NUM_PATCHES, patch_size=PATCH, is_color=False,
        dtype=jnp.float64, seed=7)
    rec.train_dict()
    img = rec.reconstruct_image(data=data, downscale_factor=1)
    return float(np.linalg.norm(np.asarray(img) - data)
                 / np.linalg.norm(data))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=f"{REF}/Data/renoir/0.jpg")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from PIL import Image
    img = np.asarray(Image.open(args.image).convert("L")) / 255.0
    # downscale by local mean (both sides get the SAME array)
    H = img.shape[0] // DOWNSCALE * DOWNSCALE
    W = img.shape[1] // DOWNSCALE * DOWNSCALE
    data = img[:H, :W].reshape(H // DOWNSCALE, DOWNSCALE,
                               W // DOWNSCALE, DOWNSCALE).mean((1, 3))

    t0 = time.time()
    err_ref = run_reference(data)
    t_ref = time.time() - t0
    print(f"reference recon_rel_err {err_ref:.5f} ({t_ref:.0f}s)",
          file=sys.stderr)
    t0 = time.time()
    err_ours = run_ours(data)
    t_ours = time.time() - t0
    print(f"ours      recon_rel_err {err_ours:.5f} ({t_ours:.0f}s)",
          file=sys.stderr)
    rel = abs(err_ours - err_ref) / err_ref
    result = {
        "config": {"rank": RANK, "patch": PATCH, "outer": OUTER,
                   "inner": INNER, "num_patches": NUM_PATCHES,
                   "image": os.path.basename(args.image),
                   "downscale": DOWNSCALE},
        "recon_rel_err_reference": round(err_ref, 5),
        "recon_rel_err_ours": round(err_ours, 5),
        "relative_gap": round(rel, 5),
        "within_1pct": bool(rel <= 0.01),
        # walls at the matched config (ours here runs on CPU float64 for
        # numerics parity)
        "wall_s_reference": round(t_ref, 2),
        "wall_s_ours_cpu": round(t_ours, 2),
    }
    print(json.dumps(result))
    if args.out:
        # merge into an existing results file under this key
        data_out = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                data_out = json.load(f)
        data_out["recon_err_vs_reference"] = result
        with open(args.out, "w") as f:
            json.dump(data_out, f, indent=2)


if __name__ == "__main__":
    main()
