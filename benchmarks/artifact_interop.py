"""Artifact interop with the reference: load ITS shipped dictionaries.

The reference's workflow warm-starts from saved ``.npy`` dictionaries
(``/root/reference/network_reconstruction_nx.py:581-584``,
``ising_reconstruction.py:102``); the cheapest proof that the two
ecosystems' artifacts are exchangeable is to load a dictionary the
REFERENCE trained and shipped, reconstruct with it here, and land at a
sane error:

- image: ``Image_dictionary/dict_learned_renoir_color.npy`` — a (75, 25)
  5x5 color dictionary — loaded into ``ImageReconstructor`` via the
  ``W`` setter, reconstructing the renoir the reference trained it on;
  compared against a random dictionary of the same shape and our own
  freshly-trained one.
- network: the WAN corpus driver (``examples/wan_corpus.py``) performs
  the mirror-image check with ``Network_dictionary/WAN/
  dict_learned_2_45_1.npy`` (accuracy under the shipped dict vs ours).

Runs on CPU. Usage:
  python benchmarks/artifact_interop.py [--out JSON]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REF = "/root/reference"
DICT = f"{REF}/Image_dictionary/dict_learned_renoir_color.npy"
IMAGE = f"{REF}/Data/renoir/0.jpg"
PATCH, RANK = 5, 25
DOWNSCALE = 4
STRIDE = 2


def rel_err(img, data):
    return float(np.linalg.norm(img - data) / np.linalg.norm(data))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from onmf_ontf_ndl_tpu.apps.image import ImageReconstructor

    from PIL import Image
    img = np.asarray(Image.open(IMAGE).convert("RGB")) / 255.0
    H = img.shape[0] // DOWNSCALE * DOWNSCALE
    W = img.shape[1] // DOWNSCALE * DOWNSCALE
    data = img[:H, :W].reshape(H // DOWNSCALE, DOWNSCALE,
                               W // DOWNSCALE, DOWNSCALE, 3).mean((1, 3))

    W_ref = np.load(DICT)                       # (75, 25) reference-made
    assert W_ref.shape == (3 * PATCH * PATCH, RANK), W_ref.shape

    def recon_with(Wd):
        rec = ImageReconstructor(data=jnp.asarray(data), patch_size=PATCH,
                                 n_components=RANK, dtype=jnp.float64,
                                 seed=7)
        rec.W = jnp.asarray(Wd)
        out = rec.reconstruct_image_color(data=jnp.asarray(data),
                                          recons_resolution=STRIDE)
        return rel_err(np.asarray(out), data)

    t0 = time.time()
    err_shipped = recon_with(W_ref)
    rng = np.random.default_rng(0)
    W_rand = rng.random(W_ref.shape)
    W_rand /= np.maximum(1.0, np.linalg.norm(W_rand, axis=0))
    err_random = recon_with(W_rand)

    # our own training at the shipped dictionary's config, for scale
    rec = ImageReconstructor(data=jnp.asarray(data), patch_size=PATCH,
                             n_components=RANK, iterations=50,
                             sub_iterations=10, num_patches=200,
                             batch_size=100, dtype=jnp.float64, seed=7)
    rec.train_dict()
    err_ours = rel_err(
        np.asarray(rec.reconstruct_image_color(data=jnp.asarray(data),
                                               recons_resolution=STRIDE)),
        data)
    wall = time.time() - t0

    result = {
        "shipped_dict": os.path.basename(DICT),
        "recon_rel_err_shipped_dict": round(err_shipped, 5),
        "recon_rel_err_our_trained_dict": round(err_ours, 5),
        "recon_rel_err_random_dict": round(err_random, 5),
        # the shipped dictionary must WORK here: clearly better than a
        # random dictionary and at least as good as our quick-budget
        # trained one (it was trained by the reference at full
        # resolution with a larger budget, so it typically WINS)
        "interop_ok": bool(err_shipped < err_random
                           and err_shipped < 1.2 * err_ours),
        "wall_s": round(wall, 2),
    }
    print(json.dumps(result))
    if args.out:
        data_out = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                data_out = json.load(f)
        data_out["artifact_interop_image"] = result
        with open(args.out, "w") as f:
            json.dump(data_out, f, indent=2)


if __name__ == "__main__":
    main()
