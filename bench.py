"""ONMF trainer throughput (patches/s) on one GPU.

Times ``train_dict`` at the headline shape, rank 25 on 10x10 colour
patches (d=300), batch 32768, drawn from a seeded pool of 65536 patches,
for the bcd coder with fixed sweeps and with the reference's early stop
(relative spectral change 0.01, at most 10 sweeps), and for the opt-in
FISTA coder; each with block and with iid sampling. Each number is the
median of 5 timed runs of 400 steps after one compiling run, fenced with
``jax.block_until_ready``.

Usage: python bench.py [--steps 400] [--reps 5]

Fails when JAX finds no GPU. Prints the card, its power limit and the
precision policy on stderr, and one JSON line on stdout.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

D, R, BATCH, POOL = 300, 25, 32768, 65536
SUB_ITER = 10
STOP = 0.01


def flops_per_patch(d=D, r=R, sub_iter=SUB_ITER):
    """Analytic FLOPs per patch of one online step: the projection
    W^T X (2dr), sub_iter Gauss-Seidel sweeps of r length-r dot products
    (2r^2 each), and the aggregates H H^T (2r^2) and H X^T (2rd). The
    O(dr^2) per-batch terms vanish at this batch."""
    return 4 * d * r + 2 * (sub_iter + 1) * r * r


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import jax

    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.utils.runtime import (
        describe_precision, enable_compile_cache, peaks_for, require_gpu)

    dev = require_gpu()
    peaks = peaks_for(dev.device_kind)
    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), file=sys.stderr)
    print(f"{dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"{describe_precision()}; compile cache {cache}", file=sys.stderr)

    pool = jax.random.uniform(jax.random.key(1), (D, POOL))
    state = init_state(jax.random.key(0), D, R)
    results = {}
    for coder, stop in (("bcd", None), ("bcd", STOP), ("fista", None)):
        for sampling in ("block", "iid"):
            def run():
                st, _ = train_dict(
                    state, pool, iterations=args.steps + 1,
                    batch_size=BATCH, sub_iter=SUB_ITER, stopping_diff=stop,
                    track_code=False, coder=coder, sampling=sampling)
                return st.W

            jax.block_until_ready(run())
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(run())
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            name = (f"{coder}_{'fixed' if stop is None else 'earlystop'}"
                    f"_{sampling}")
            results[name] = {
                "patches_per_s": args.steps * BATCH / med,
                "median_s": med, "min_s": min(times), "max_s": max(times)}
            print(f"  {name}: {args.steps * BATCH / med:,.0f} patches/s "
                  f"(median {med:.4f} s, spread {min(times):.4f}-"
                  f"{max(times):.4f} s)", file=sys.stderr)

    fixed = results["bcd_fixed_block"]["patches_per_s"]
    print(json.dumps({
        "metric": "onmf_train_patches_per_sec_rank25_10x10color",
        "value": fixed,
        "unit": "patches/s",
        "results": results,
        "flops_per_patch": flops_per_patch(),
        "f32_peak_share": fixed * flops_per_patch() / peaks["f32_flops"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "power": smi.stdout.strip(),
    }))


if __name__ == "__main__":
    main()
