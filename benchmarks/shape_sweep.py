"""Trainer and kernel characterization off the headline shape, on one GPU.

The reference's own configs run rank 25 at d=300 (10x10 colour patches),
rank 100 at d=400 (the Ising driver's 20x20 patches, the reference's
`ising_reconstruction.py:223-232`) and d=441 NDL patches
(k=21 arms, `network_reconstruction_nx.py:536-574`). This sweep times
the real trainer (`train_dict`, block sampling, fixed 10 sweeps) across
those shapes for each coder, a tile/warp microsweep of the standalone
coder kernel per shape, and (``--decomp``) a fused-prefix decomposition
of the step.

Usage: python benchmarks/shape_sweep.py [--quick] [--decomp] [--out F]
Fails when JAX finds no GPU; prints one JSON line.
"""

import json
import statistics
import sys
import time

SUB_ITER = 10

# (label, d, r) — the reference's config space + a rank-scaling probe
SHAPES = [
    ("r25_d300_color10", 300, 25),    # headline: 10x10x3 color, rank 25
    ("r25_d100_gray10", 100, 25),     # grayscale 10x10
    ("r100_d400_ising20", 400, 100),  # ising driver: 20x20, rank 100
    ("r25_d441_ndl_k21", 441, 25),    # NDL k1=0,k2=20 -> 21x21 patches
    ("r100_d300", 300, 100),          # rank scaling at fixed d
]


def _median_time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def flops_per_patch(d, r, sub_iter=SUB_ITER):
    # same analytic model as bench.py: proj + sweeps + aggregates,
    # per-patch terms only
    return 4 * d * r + 2 * (sub_iter + 1) * r * r


def measure_train(d, r, batch, coder, iters=None):
    import jax
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state

    iters = iters or max(400, 8_000_000 // batch)
    pool = jax.random.uniform(jax.random.key(1), (d, 8192))
    state = init_state(jax.random.key(0), d, r)

    def run():
        st, _ = train_dict(state, pool, iterations=iters + 1,
                           batch_size=batch, alpha=0.0, beta=1.0,
                           sub_iter=SUB_ITER, stopping_diff=None,
                           track_code=False, coder=coder,
                           sampling="block")
        return st.W

    return iters * batch / _median_time(run)


def measure_kernel_tile(d, r, batch, block_n, num_warps):
    """Standalone fixed-sweep coder kernel at one tile width and warp
    count (ops/pallas/coder_kernel.py); patches/s."""
    import jax
    from onmf_ontf_ndl_tpu.ops.pallas import coder_sweeps

    W = jax.random.uniform(jax.random.key(0), (d, r))
    X = jax.random.uniform(jax.random.key(1), (d, batch))
    gram, proj = W.T @ W, W.T @ X
    H0 = jax.random.uniform(jax.random.key(2), (r, batch))
    return batch / _median_time(lambda: coder_sweeps(
        gram, proj, H0, 0.5, sub_iter=SUB_ITER, block_n=block_n,
        num_warps=num_warps))


def measure_step_prefixes(d, r, batch, reps=None, interpret=False):
    """Fused-prefix decomposition of the bcd trainer step.

    Times PREFIXES of the real per-step pipeline inside one fused scan
    (an isolated per-phase jit can change the layouts XLA picks for
    outputs nobody reads) — successive differences attribute the
    per-step wall to (1) gram+projection
    matmuls, (2) coder sweeps, (3) streaming aggregate updates, and
    (4) the column-BCD dictionary update (``onmf_step``'s stale-
    aggregate default, models/onmf.py). Pool width equals the batch so
    block sampling is the identity slice."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from onmf_ontf_ndl_tpu.ops.pallas import coder_sweeps, dict_update_sweep

    reps = reps or max(400, 8_000_000 // batch)
    X = jax.random.uniform(jax.random.key(1), (d, batch))
    W0 = jax.random.uniform(jax.random.key(0), (d, r))
    W0 = W0 / jnp.linalg.norm(W0, axis=0)
    H0 = jax.random.uniform(jax.random.key(2), (r, batch))
    A0 = jnp.zeros((r, r))
    B0 = jnp.zeros((r, d))
    alpha = jnp.float32(0.0)

    def make(depth):
        def body(carry, i):
            W, A, B, acc = carry
            # anti-hoist: without this, a prefix that never updates W
            # would let XLA hoist gram/proj out of the scan entirely
            Wc = W + acc * 0
            gram = Wc.T @ Wc
            proj = Wc.T @ X
            acc = acc + jnp.sum(gram) * 1e-20 + jnp.sum(proj) * 1e-20
            if depth >= 2:
                H = coder_sweeps(gram, proj, H0, alpha,
                                 sub_iter=SUB_ITER, interpret=interpret)
                acc = acc + jnp.sum(H) * 1e-20
            if depth >= 3:
                w = 1.0 / (1.0 + i.astype(jnp.float32))
                A1 = (1 - w) * A + w * (H @ H.T) / batch
                B1 = (1 - w) * B + w * (H @ X.T) / batch
                acc = acc + jnp.sum(A1) * 1e-20 + jnp.sum(B1) * 1e-20
                A, B = A1, B1
            if depth >= 4:
                # stale-aggregate default: W steps with the pre-update
                # A, B (models/onmf.py dict_from="stale")
                W = dict_update_sweep(W, A, B, interpret=interpret)
            return (W, A, B, acc), ()

        @jax.jit
        def run():
            carry, _ = lax.scan(
                body, (W0, A0, B0, jnp.float32(0.0)),
                jnp.arange(reps, dtype=jnp.int32))
            return carry[3] + jnp.sum(carry[0])

        return run

    out = {}
    names = ["gram_proj", "coder", "aggregates", "dict_update"]
    prev = 0.0
    for depth in (1, 2, 3, 4):
        us = _median_time(make(depth)) / reps * 1e6
        out[f"prefix{depth}_us_per_step"] = round(us, 1)
        out[f"{names[depth - 1]}_us"] = round(us - prev, 1)
        print(f"  prefix {depth} ({'+'.join(names[:depth])}): "
              f"{us:.1f} us/step (+{us - prev:.1f})", file=sys.stderr)
        prev = us
    out["batch"] = batch
    out["patches_per_s_full_step"] = round(batch / (prev / 1e6))
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one batch, no kernel tile sweep")
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[16384, 65536])
    ap.add_argument("--decomp", action="store_true",
                    help="fused-prefix step decomposition at the r=100 "
                         "ising shape and the headline shape")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import jax

    from onmf_ontf_ndl_tpu.utils.runtime import (
        enable_compile_cache, peaks_for, require_gpu)

    dev = require_gpu()
    f32_peak = peaks_for(dev.device_kind)["f32_flops"]
    enable_compile_cache()
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", file=sys.stderr)
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}}

    if args.decomp:
        decomp = {}
        for label, d, r in (("r100_d400_ising20", 400, 100),
                            ("r25_d300_color10", 300, 25)):
            print(f"{label} step decomposition:", file=sys.stderr)
            decomp[label] = measure_step_prefixes(d, r, 65536)
        result["trainer_step_decomp"] = decomp
    else:
        batches = args.batches[:1] if args.quick else args.batches
        sweep = {}
        for label, d, r in SHAPES:
            fpp = flops_per_patch(d, r)
            entry = {"d": d, "r": r, "flops_per_patch": fpp}
            for coder in ("bcd", "fista", "fista_bf16"):
                # bcd sweeps the batch grid; the fista modes are measured
                # at the widest batch only, to bound the compile count
                coder_batches = batches if coder == "bcd" else batches[-1:]
                best, best_b = 0.0, None
                for b in coder_batches:
                    pps = measure_train(d, r, b, coder)
                    print(f"{label} {coder} batch {b}: {pps / 1e6:.3f}M "
                          f"patches/s", file=sys.stderr)
                    if pps > best:
                        best, best_b = pps, b
                entry[f"{coder}_patches_per_s"] = best
                entry[f"{coder}_batch"] = best_b
                entry[f"{coder}_f32_peak_share"] = best * fpp / f32_peak
            if not args.quick:
                tiles = {}
                for bn, nw in ((16, 1), (32, 1), (64, 2), (128, 2),
                               (128, 4), (256, 4)):
                    pps = measure_kernel_tile(d, r, batches[-1], bn, nw)
                    tiles[f"{bn}x{nw}"] = pps
                    print(f"{label} kernel block_n={bn} warps={nw}: "
                          f"{pps / 1e6:.3f}M patches/s", file=sys.stderr)
                entry["kernel_tile_patches_per_s"] = tiles
            sweep[label] = entry
        result["shape_sweep"] = sweep
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
