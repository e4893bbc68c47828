"""Smoke test of the package's main paths on one GPU.

Runs, in one process, through the entry points the README documents:

0. the device: fails unless JAX's first device is a GPU; prints the card,
   its power limit, JAX's view of it, the precision policy and the
   compile-cache directory;
1. the sweep kernels at real widths against the plain XLA loops at
   ``highest`` matmul precision;
2. ``train_dict`` at d=300, r=25, batch 32768 for 400 steps (block and
   iid sampling, fixed sweeps and early stop), kernels and
   ``backend="xla"``, against an XLA run at ``highest`` precision by
   held-out reconstruction error; then ``ImageReconstructor`` on a
   seeded 512x512x3 image;
3. network dictionary learning on a 1,048,576-node Barabasi-Albert graph
   (CSR, Glauber training, Pivot reconstruction), then a 4,096-node one
   on the GPU and on the CPU device of the same process;
4. the Ising app and sampler on a 1024^2 lattice (GPU against the CPU
   device), and a short ONTF run.

``--four`` runs only the data-parallel paths on four GPUs against their
one-GPU counterparts. Every input is generated from a seed. A failed
check raises; the last line of stdout is a JSON object naming the
device.

Usage: python chip_smoke.py [--four]
"""

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np

# Sizes of each phase (module constants so that a rehearsal on the CPU
# can shrink them).
KERNEL_SHAPES = ((300, 25, 32768), (9, 25, 32768), (400, 100, 16384))
TRAIN = dict(d=300, r=25, batch=32768, steps=400, pool=65536, test=4096)
IMAGE_SIDE = 512
NDL_NODES, NDL_SAMPLES, NDL_CHAINS = 1 << 20, 1 << 21, 16384
NDL_SMALL = dict(nodes=4096, samples=1 << 17, chains=1024)
ISING_SIDE, ISING_SWEEPS = 1024, 300
FOUR = dict(steps=400, ndl_nodes=1 << 16, ndl_samples=1 << 20,
            ndl_chains=4096)


def check(name, value, tol, unit="rel err"):
    """Print ``value`` beside its tolerance and fail when it exceeds it."""
    ok = bool(value <= tol)
    print(f"  {'PASS' if ok else 'FAIL'} {name}: {unit} {value:.3e} "
          f"(tolerance {tol:.1e})", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {value} > {tol}")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def median_time(fn, reps=5):
    """Median wall seconds of ``fn`` over ``reps`` runs after one warm-up,
    each fenced with ``jax.block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def synthetic_patches(key, d, r, n, n_test):
    """Seeded sparse-dictionary data: X = W* H + noise, with W* (d, r)
    nonnegative unit columns and H 30% dense; returns (pool, held-out)."""
    import jax
    import jax.numpy as jnp

    kw, kh, km, kn = jax.random.split(key, 4)
    W = jax.random.uniform(kw, (d, r))
    W = W / jnp.linalg.norm(W, axis=0)
    m = n + n_test
    H = (jax.random.uniform(kh, (r, m))
         * (jax.random.uniform(km, (r, m)) < 0.3))
    X = W @ H + 0.01 * jax.random.uniform(kn, (d, m))
    return X[:, :n], X[:, n:]


def heldout_error(W, X):
    """Relative error of ``X`` coded against ``W`` by one shared coder
    (XLA, 20 fixed sweeps, fixed start, highest precision)."""
    import jax
    import jax.numpy as jnp

    from onmf_ontf_ndl_tpu.ops.coder import nonneg_code

    with jax.default_matmul_precision("highest"):
        H = nonneg_code(X, W, key=jax.random.key(99), sub_iter=20,
                        stopping_diff=None, backend="xla")
        return float(jnp.linalg.norm(X - W @ H) / jnp.linalg.norm(X))


def seeded_image(key, size=512):
    """A smooth seeded colour image in [0, 1]: random Gaussian blobs of
    random colours over low-frequency waves."""
    import jax
    import jax.numpy as jnp

    kc, ks, kw, kp = jax.random.split(key, 4)
    yy, xx = jnp.mgrid[0:size, 0:size] / size
    centers = jax.random.uniform(kc, (40, 2))
    scales = 0.02 + 0.1 * jax.random.uniform(ks, (40,))
    colors = jax.random.uniform(kw, (40, 3))
    blobs = jnp.exp(-((xx[..., None] - centers[:, 0]) ** 2
                      + (yy[..., None] - centers[:, 1]) ** 2)
                    / (2 * scales ** 2))
    img = blobs @ colors
    phase = jax.random.uniform(kp, (3,)) * 6.28
    img = img + 0.3 * (1 + jnp.sin(6 * xx[..., None] + 4 * yy[..., None]
                                   + phase))
    return img / jnp.max(img)


def ba_graph(n, seed=0):
    from benchmarks.scale_extras import ba_edges
    from onmf_ontf_ndl_tpu.data.graphs import csr_graph_from_edges

    return csr_graph_from_edges(ba_edges(n, 2, seed=seed))


def ndl_reconstructor(g, num_chains=16):
    """The heavy-tail configuration of benchmarks/scale_extras.py:
    Glauber training, Pivot reconstruction, 3-node path motif, rank 25."""
    from onmf_ontf_ndl_tpu.apps.network import NetworkReconstructor

    return NetworkReconstructor(
        source=g, n_components=25, MCMC_iterations=50, sub_iterations=30,
        sample_size=500, batch_size=100, k1=0, k2=2, num_chains=num_chains,
        fast=True, seed=0, is_glauber_recons=False)


def ising_stats(lat):
    """(mean |magnetisation|, energy per site) of one lattice."""
    from onmf_ontf_ndl_tpu.samplers.ising import hamiltonian

    s = np.asarray(lat, np.float64)
    return abs(s.mean()), float(hamiltonian(lat, 1.0, 0.0)) / s.size


# ----------------------------------------------------------------- phases


def phase_device():
    import jax

    from onmf_ontf_ndl_tpu.utils.runtime import (
        describe_precision, enable_compile_cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"phase 0: no GPU (JAX's first device is "
                         f"{dev.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print("phase 0: device")
    print(smi.stdout.strip())
    import jaxlib

    print(f"  {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
          f"bytes_limit {dev.memory_stats()['bytes_limit']}")
    print(f"  jax {jax.__version__} jaxlib {jaxlib.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  precision: {describe_precision()}")
    print(f"  compile cache: {enable_compile_cache()}", flush=True)
    return dev


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from onmf_ontf_ndl_tpu.ops.coder import _code_impl
    from onmf_ontf_ndl_tpu.ops.dict_update import dict_update_bcd
    from onmf_ontf_ndl_tpu.ops.pallas import (
        coder_sweeps, dict_kernel_fits, dict_update_sweep)

    print("phase 1: kernels at real widths against the XLA loops "
          "(references at highest precision; kernels multiply in f32)")
    f32 = jnp.float32
    for d, r, n in KERNEL_SHAPES:
        k = jax.random.split(jax.random.key(d * 1000 + r), 3)
        W = jax.random.uniform(k[0], (d, r))
        X = jax.random.uniform(k[1], (d, n))
        H0 = jax.random.uniform(k[2], (r, n))
        with jax.default_matmul_precision("highest"):
            A, B = W.T @ W, W.T @ X
            for sweeps, tol in ((1, 1e-5), (10, 1e-4)):
                want = _code_impl(A, B, H0, f32(0.1), f32(0), f32(0),
                                  sweeps, False, False)
                got = coder_sweeps(A, B, H0, 0.1, sub_iter=sweeps)
                check(f"coder d={d} r={r} n={n} {sweeps} sweep(s)",
                      rel_err(got, want), tol)
            want = _code_impl(A, B, H0, f32(0.1), f32(0.01), f32(0), 10,
                              True, False)
            got = coder_sweeps(A, B, H0, 0.1, sub_iter=10,
                               stopping_diff=0.01)
            check(f"coder d={d} r={r} n={n} early stop 0.01",
                  rel_err(got, want), 1e-4)
            Ad, Bd = H0 @ H0.T / n, H0 @ X.T / n
            got = dict_update_sweep(W, Ad, Bd)
            route = "kernel" if dict_kernel_fits(d, r) else "XLA (shape rule)"
            check(f"dict d={d} r={r} [{route}]",
                  rel_err(got, dict_update_bcd(W, Ad, Bd)), 1e-5)
        compiled = jax.jit(lambda A, B, H: coder_sweeps(
            A, B, H, 0.1, sub_iter=10)).lower(A, B, H0).compile()
        print(f"  coder d={d} r={r} n={n} memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)


def phase_trainer():
    import jax

    from onmf_ontf_ndl_tpu.apps.image import ImageReconstructor
    from onmf_ontf_ndl_tpu.models.onmf import train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state

    d, r, batch, steps = (TRAIN[k] for k in ("d", "r", "batch", "steps"))
    print(f"phase 2: trainer d={d} r={r} batch {batch}, {steps} steps")
    pool, test = synthetic_patches(jax.random.key(1), d, r, TRAIN["pool"],
                                   TRAIN["test"])
    st0 = init_state(jax.random.key(0), d, r)
    for stop in (None, 0.01):
        for sampling in ("block", "iid"):
            def run(backend):
                st, _ = train_dict(st0, pool, iterations=steps + 1,
                                   batch_size=batch, stopping_diff=stop,
                                   sampling=sampling, backend=backend,
                                   track_code=False)
                return st.W

            name = (f"{'fixed' if stop is None else 'early-stop'} "
                    f"{sampling}")
            with jax.default_matmul_precision("highest"):
                ref = heldout_error(run("xla"), test)
            for backend in ("auto", "xla"):
                secs = median_time(lambda: run(backend))
                err = heldout_error(run(backend), test)
                label = "kernels" if backend == "auto" else "xla"
                print(f"  {name} {label}: {steps * batch / secs:,.0f} "
                      f"patches/s (median of 5: {secs:.4f} s), held-out "
                      f"error {err:.5f} vs {ref:.5f} (XLA, highest)",
                      flush=True)
                check(f"{name} {label} held-out error vs reference",
                      abs(err - ref) / ref, 0.02, "rel diff")

    img = seeded_image(jax.random.key(5), IMAGE_SIDE)

    def recon_error(rec):
        out = jax.block_until_ready(rec.reconstruct_image_color(data=img))
        assert out.shape == img.shape
        return float(np.linalg.norm(np.asarray(out) - np.asarray(img))
                     / np.linalg.norm(np.asarray(img)))

    def reconstructor():
        return ImageReconstructor(data=img, n_components=25, patch_size=10,
                                  iterations=30, sub_iterations=20,
                                  num_patches=4096, batch_size=512)

    err0 = recon_error(reconstructor())      # the untrained dictionary
    t0 = time.perf_counter()
    rec = reconstructor()
    W = jax.block_until_ready(rec.train_dict())
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    err = recon_error(rec)
    t_rec = time.perf_counter() - t0
    assert np.isfinite(np.asarray(W)).all()
    print(f"  image {IMAGE_SIDE}^2 x3 patch 10 r=25: train {t_train:.2f} s, "
          f"reconstruct {t_rec:.2f} s; error {err:.4f}, untrained "
          f"dictionary {err0:.4f}")
    check("image reconstruction error over the untrained one", err / err0,
          1.0, "ratio")


def phase_ndl(dev):
    import jax

    print("phase 3: network dictionary learning")
    t0 = time.perf_counter()
    g = ba_graph(NDL_NODES)
    t_build = time.perf_counter() - t0
    rec = ndl_reconstructor(g)
    t0 = time.perf_counter()
    jax.block_until_ready(rec.train_dict())
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec.reconstruct_network(recons_iter=NDL_SAMPLES, num_chains=NDL_CHAINS)
    t_rec = time.perf_counter() - t0
    acc = rec.compute_recons_accuracy()
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    print(f"  BA n={g.num_nodes} m=2 (max_deg {g.max_deg}): build "
          f"{t_build:.2f} s, train {t_train:.2f} s, reconstruct "
          f"{NDL_SAMPLES} samples {t_rec:.2f} s (first calls, with "
          f"compile), accuracy "
          f"{acc:.4f}, peak_bytes_in_use {peak}", flush=True)
    assert np.isfinite(np.asarray(rec.W)).all() and 0.0 < acc <= 1.0

    accs = {}
    for name, device in (("gpu", dev), ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(device), \
                jax.default_matmul_precision("highest"):
            small = ndl_reconstructor(ba_graph(NDL_SMALL["nodes"], seed=1))
            small.train_dict()
            small.reconstruct_network(recons_iter=NDL_SMALL["samples"],
                                      num_chains=NDL_SMALL["chains"])
            accs[name] = small.compute_recons_accuracy()
    print(f"  BA n={NDL_SMALL['nodes']}, highest precision: accuracy gpu "
          f"{accs['gpu']:.4f} "
          f"cpu {accs['cpu']:.4f}")
    check(f"BA {NDL_SMALL['nodes']} accuracy gpu vs cpu", abs(accs["gpu"] - accs["cpu"]),
          0.01, "abs diff")


def phase_ising_ontf(dev):
    import jax
    import jax.numpy as jnp

    from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor
    from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor
    from onmf_ontf_ndl_tpu.samplers.ising import (
        checkerboard_sweeps, init_lattice)

    print("phase 4: Ising and ONTF")
    n, T, sweeps = ISING_SIDE, 3.0, ISING_SWEEPS
    lat = init_lattice(jax.random.key(7), n)
    secs = median_time(lambda: checkerboard_sweeps(
        jax.random.key(8), lat, sweeps, 1.0, 0.0, T), reps=3)
    print(f"  checkerboard {n}^2: {sweeps * n * n / secs:,.0f} "
          f"site-updates/s (median of 3: {secs:.4f} s for {sweeps} sweeps)")
    stats = {}
    for name, device in (("gpu", dev), ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(device):
            out = checkerboard_sweeps(jax.random.key(8),
                                      jax.device_put(lat, device), sweeps,
                                      1.0, 0.0, T)
            stats[name] = ising_stats(out)
    print(f"  T={T} after {sweeps} sweeps: |m| gpu {stats['gpu'][0]:.5f} "
          f"cpu {stats['cpu'][0]:.5f}; E/site gpu {stats['gpu'][1]:.5f} "
          f"cpu {stats['cpu'][1]:.5f}")
    check("Ising |m| gpu vs cpu", abs(stats["gpu"][0] - stats["cpu"][0]),
          0.01, "abs diff")
    check("Ising E/site gpu vs cpu", abs(stats["gpu"][1] - stats["cpu"][1]),
          0.01, "abs diff")

    app = IsingReconstructor(
        n_components=25, lattice_size=n, ising_iterations=5,
        temperature=T, ising_subsampling_steps=20 * n * n,
        sub_iterations=20, num_patches=1000, batch_size=100,
        patch_size=10, seed=0)
    t0 = time.perf_counter()
    _, dicts, errors = app.ising_mcmc_learning()
    errors = np.asarray(jax.block_until_ready(errors))
    print(f"  IsingReconstructor {n}^2, 5 rounds of 20 sweeps: "
          f"{time.perf_counter() - t0:.2f} s (first call, with compile), "
          f"surrogate errors {errors.round(2).tolist()}")
    assert np.isfinite(errors).all() and dicts.shape == (6, 100, 25)

    img = seeded_image(jax.random.key(9), 128)
    ten = ImageReconstructorTensor(
        data=img, n_components=16, iterations=3, sub_iterations=5,
        num_patches=200, batch_size=50, patch_size=6, fast=True)
    W = jax.block_until_ready(ten.train_dict(mode=2, learn_joint_dict=True))
    assert bool(jnp.isfinite(W).all()) and bool((W >= 0).all())
    print(f"  ImageReconstructorTensor mode 2 joint: W {W.shape} finite")


def phase_four():
    import jax
    import jax.numpy as jnp

    from onmf_ontf_ndl_tpu.models.onmf import onmf_step, train_dict
    from onmf_ontf_ndl_tpu.models.state import init_state
    from onmf_ontf_ndl_tpu.parallel.dp import (
        dp_onmf_step, dp_recons_edges, dp_train_dict, shard_batch)
    from onmf_ontf_ndl_tpu.parallel.ising_sharded import (
        sharded_checkerboard_sweeps)
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh
    from onmf_ontf_ndl_tpu.samplers.ising import (
        checkerboard_sweeps, init_lattice)

    devs = jax.devices()
    if len(devs) != 4 or any(d.platform != "gpu" for d in devs):
        raise SystemExit(f"--four needs 4 GPUs, have {devs}")
    mesh = make_mesh({"dp": 4})
    print("phase 5: data-parallel paths on 4 GPUs")

    def on_all_four(x):
        return len(x.sharding.device_set) == 4

    # exact step: 20 dp_onmf_step against onmf_step on the same batches
    d, r, n = TRAIN["d"], TRAIN["r"], TRAIN["batch"]
    pool, test = synthetic_patches(jax.random.key(1), d, r, TRAIN["pool"],
                                   TRAIN["test"])
    st0 = init_state(jax.random.key(0), d, r)
    with jax.default_matmul_precision("highest"):
        s1 = s4 = st0
        for i in range(20):
            kx, kh = jax.random.split(jax.random.key(100 + i))
            idx = jax.random.randint(kx, (n,), 0, pool.shape[1])
            X = pool[:, idx]
            H0 = jax.random.uniform(kh, (r, n))
            s1, _ = onmf_step(s1, X, H0=H0, stopping_diff=None)
            s4, H4 = dp_onmf_step(mesh, s4, shard_batch(mesh, X),
                                  H0=shard_batch(mesh, H0),
                                  stopping_diff=None)
        assert on_all_four(H4)
        check("20 dp_onmf_step vs onmf_step, W (psum order differs)",
              rel_err(s4.W, s1.W), 1e-4)

    # dp_train_dict (each card draws its own 8192 columns) against one
    # card drawing 32768: same effective batch, compared by held-out error
    steps = FOUR["steps"]

    def dp_run():
        return dp_train_dict(mesh, st0, pool, iterations=steps + 1,
                             batch_size_per_device=n // 4, sampling="block",
                             backend="auto").W

    def one_run():
        return train_dict(st0, pool, iterations=steps + 1, batch_size=n,
                          sampling="block", stopping_diff=None,
                          track_code=False)[0].W

    t4, t1 = median_time(dp_run), median_time(one_run)
    W4 = dp_run()
    assert on_all_four(W4)
    e4, e1 = heldout_error(W4, test), heldout_error(one_run(), test)
    print(f"  dp_train_dict 4x{n // 4}: {steps * n / t4:,.0f} patches/s; "
          f"one card {n}: {steps * n / t1:,.0f} patches/s; held-out error "
          f"{e4:.5f} vs {e1:.5f}")
    check("dp_train_dict held-out error vs one card", abs(e4 - e1) / e1,
          0.02, "rel diff")

    # chain-sharded NDL reconstruction + host merge, against one card
    # spending the same sample budget
    g = ba_graph(FOUR["ndl_nodes"])
    rec = ndl_reconstructor(g)
    rec.train_dict()
    budget, chains = FOUR["ndl_samples"], FOUR["ndl_chains"]
    rec.reconstruct_network(recons_iter=budget, num_chains=chains)
    acc1 = rec.compute_recons_accuracy()
    edges = dp_recons_edges(
        mesh, rec.W, g, jax.random.key(3), rec._B_bytes, rec._parents,
        recons_iter_per_device=budget // 4,
        num_chains_per_device=chains // 4, sub_iter=30)
    acc4 = rec.compute_recons_accuracy(G_recons=edges)
    peaks = [(dv.memory_stats() or {}).get("peak_bytes_in_use")
             for dv in devs]
    print(f"  BA n={g.num_nodes}: accuracy one card {acc1:.4f}, 4 cards merged "
          f"{acc4:.4f}; peak_bytes_in_use per card {peaks}")
    assert all(p is None or p > 0 for p in peaks)
    check("dp_recons_edges accuracy vs one card", abs(acc4 - acc1), 0.02,
          "abs diff")

    # halo-exchange Ising against the one-card sweep from the same key
    lat = init_lattice(jax.random.key(7), ISING_SIDE)
    out4 = sharded_checkerboard_sweeps(mesh, jax.random.key(8), lat,
                                       ISING_SWEEPS, T=3.0)
    out1 = checkerboard_sweeps(jax.random.key(8), lat, ISING_SWEEPS, 1.0,
                               0.0, 3.0)
    assert on_all_four(out4)
    (m4, e4), (m1, e1) = ising_stats(out4), ising_stats(out1)
    print(f"  Ising {ISING_SIDE}^2 T=3 {ISING_SWEEPS} sweeps: |m| "
          f"{m4:.5f} vs {m1:.5f}, "
          f"E/site {e4:.5f} vs {e1:.5f} (the shards draw their own "
          f"random streams)")
    check("sharded Ising |m| vs one card", abs(m4 - m1), 0.01, "abs diff")
    check("sharded Ising E/site vs one card", abs(e4 - e1), 0.01,
          "abs diff")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the data-parallel paths on four GPUs")
    args = p.parse_args(argv)
    import jax

    dev = phase_device()
    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        for phase in (phase_kernels, phase_trainer,
                      lambda: phase_ndl(dev), lambda: phase_ising_ontf(dev)):
            t0 = time.perf_counter()
            phase()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
