"""Distributional tests for the Ising samplers + trajectory-learning app."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.samplers.ising import (
    checkerboard_sweeps,
    delta_e,
    hamiltonian,
    init_lattice,
    metropolis_chain,
)
from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor


def boltzmann_2x2(J, H, T):
    """Exact stationary distribution implied by the acceptance rule
    dE = 2 s0 (H + J Sn): energy E = -(J/2) sum_i s_i Sn_i - H sum_i s_i."""
    states, probs = [], []
    for bits in itertools.product([1, -1], repeat=4):
        s = np.array(bits).reshape(2, 2)
        sn = (np.roll(s, 1, 0) + np.roll(s, -1, 0)
              + np.roll(s, 1, 1) + np.roll(s, -1, 1))
        E = -(J / 2) * np.sum(s * sn) - H * np.sum(s)
        states.append(bits)
        probs.append(np.exp(-E / T))
    probs = np.array(probs)
    return {st: p for st, p in zip(states, probs / probs.sum())}


def encode(lat):
    flat = np.asarray(lat).reshape(-1)
    return tuple(int(v) for v in flat)


def ensemble_counts(finals):
    counts = {}
    for row in np.asarray(finals).reshape(len(finals), -1):
        st = tuple(int(v) for v in row)
        counts[st] = counts.get(st, 0) + 1
    return counts


def tv_distance(counts, target):
    total = sum(counts.values())
    return 0.5 * sum(
        abs(counts.get(st, 0) / total - p) for st, p in target.items()
    )


def random_lattices(key, num):
    return jax.random.choice(
        key, jnp.asarray([1, -1], jnp.int8), shape=(num, 2, 2))


def test_metropolis_matches_boltzmann_2x2():
    # Ensemble of independent chains: the data-parallel way to sample a
    # sequential-by-definition Markov chain. High T for fast mixing.
    J, H, T = 1.0, 0.3, 5.0
    target = boltzmann_2x2(J, H, T)
    num = 8192
    lat0 = random_lattices(jax.random.key(10), num)
    keys = jax.random.split(jax.random.key(0), num)
    finals = jax.vmap(
        lambda k, l: metropolis_chain(k, l, 400, J=J, H=H, T=T)[0]
    )(keys, lat0)
    assert tv_distance(ensemble_counts(finals), target) < 0.03


def test_checkerboard_matches_boltzmann_2x2():
    J, H, T = 1.0, 0.0, 4.0
    target = boltzmann_2x2(J, H, T)
    num = 8192
    lat0 = random_lattices(jax.random.key(11), num)
    keys = jax.random.split(jax.random.key(1), num)
    finals = jax.vmap(
        lambda k, l: checkerboard_sweeps(k, l, 200, J=J, H=H, T=T)
    )(keys, lat0)
    assert tv_distance(ensemble_counts(finals), target) < 0.03


def test_low_temperature_orders():
    key = jax.random.key(2)
    lat = init_lattice(key, 16)
    m0 = abs(float(jnp.sum(lat))) / 256
    lat = checkerboard_sweeps(jax.random.key(3), lat, 200, T=1.0)
    m1 = abs(float(jnp.sum(lat))) / 256
    assert m1 > max(m0, 0.5)  # below Tc the lattice magnetizes


def test_hamiltonian_consistent_with_delta_e():
    key = jax.random.key(4)
    lat = init_lattice(key, 6)
    J, H = 1.3, 0.2
    n = 6
    for (i, j) in [(0, 0), (3, 4), (5, 5)]:
        sn = (lat[(i-1) % n, j] + lat[(i+1) % n, j]
              + lat[i, (j-1) % n] + lat[i, (j+1) % n]).astype(jnp.float32)
        dE = float(delta_e(lat[i, j].astype(jnp.float32), sn, J, H))
        flipped = lat.at[i, j].multiply(-1)
        # reference hamiltonian double-counts pairs -> dE relates via
        # E = (ham + H-field part)/2 correction; check via direct recompute
        dham = float(hamiltonian(flipped, J, H) - hamiltonian(lat, J, H))
        # dham = 2*J*s0*Sn*2 + 2*H*s0 ; dE = 2*s0*(H + J*Sn)
        s0 = float(lat[i, j])
        assert np.isclose(dham, 4 * J * s0 * float(sn) + 2 * H * s0, rtol=1e-5)
        assert np.isclose(dE, 2 * s0 * (H + J * float(sn)), rtol=1e-6)


def test_ising_app_end_to_end():
    rec = IsingReconstructor(
        n_components=8, lattice_size=16, ising_iterations=4,
        temperature=3.0, ising_subsampling_steps=256, sub_iterations=4,
        num_patches=30, batch_size=10, patch_size=4, beta=0.8,
        dtype=jnp.float64,
    )
    traj, dict_stack, errors = rec.ising_mcmc_learning()
    assert dict_stack.shape == (5, 16, 8)
    assert errors.shape == (5,)
    assert np.isfinite(np.asarray(errors)).all()
    assert (np.asarray(rec.W) >= 0).all()
    # surrogate error should broadly decrease along the trajectory
    assert float(errors[-1]) < float(errors[0])

    out = rec.reconstruct_config(rec.lattice)
    assert out.shape == (16, 16)
    assert np.isfinite(np.asarray(out)).all()


def test_exact_sampler_in_app():
    rec = IsingReconstructor(
        n_components=4, lattice_size=8, ising_iterations=2,
        temperature=2.0, ising_subsampling_steps=50, sub_iterations=3,
        num_patches=10, batch_size=5, patch_size=3, sampler="exact",
        dtype=jnp.float64,
    )
    _, dict_stack, errors = rec.ising_mcmc_learning()
    assert dict_stack.shape == (3, 9, 4)
    assert np.isfinite(np.asarray(errors)).all()


def test_keep_trajectory_flag():
    rec = IsingReconstructor(
        n_components=4, lattice_size=8, ising_iterations=3,
        temperature=2.0, ising_subsampling_steps=64, sub_iterations=3,
        num_patches=10, batch_size=5, patch_size=3, dtype=jnp.float64,
    )
    traj, _, _ = rec.ising_mcmc_learning(keep_trajectory=True)
    assert traj.shape == (3, 8, 8)
    vals = set(np.unique(np.asarray(traj)))
    assert vals.issubset({-1.0, 1.0, -1, 1})


def test_initial_lattice_accepts_float_arrays():
    """The reference warm-starts from saved FLOAT trajectories
    (ising_reconstruction.py:102); was a scan carry dtype crash."""
    from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor

    rec = IsingReconstructor(n_components=4, lattice_size=8,
                             ising_iterations=2, sub_iterations=3,
                             num_patches=10, batch_size=5, patch_size=3,
                             ising_subsampling_steps=10)
    lat = np.random.default_rng(0).choice([-1.0, 1.0], size=(8, 8))
    _, dict_stack, errors = rec.ising_mcmc_learning(initial_lattice=lat)
    assert np.isfinite(np.asarray(errors)).all()


def test_rectangular_lattice_patches_cover_full_width():
    """Patch corners must be drawn from the actual lattice shape (was
    (n, n) from lattice_size, silently truncating wide lattices)."""
    from onmf_ontf_ndl_tpu.apps.ising import IsingReconstructor

    rec = IsingReconstructor(n_components=4, lattice_size=8,
                             ising_iterations=2, sub_iterations=3,
                             num_patches=30, batch_size=10, patch_size=3,
                             ising_subsampling_steps=0,
                             update_lattice=False)
    lat = np.ones((8, 24), np.int8)
    lat[:, 16:] = -1                      # right third all -1
    _, dict_stack, _ = rec.ising_mcmc_learning(initial_lattice=lat)
    # patches from the right third contain -1 -> mapped features differ;
    # with corners drawn from (8, 8) the -1 region would never be seen.
    # extract a patch batch directly to assert coverage
    import jax
    from onmf_ontf_ndl_tpu.ops.patches import (extract_patches,
                                               random_patch_corners)
    _, cols = random_patch_corners(jax.random.key(0), lat.shape, 3, 200)
    assert int(np.asarray(cols).max()) > 16
