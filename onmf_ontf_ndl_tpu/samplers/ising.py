"""2-D Ising model samplers on the torus.

Two kernels with the same Hamiltonian/acceptance semantics as the
reference simulator (``/root/reference/ising_simulator.py:9-147``):

- :func:`metropolis_chain` — the exact sequential single-site Metropolis
  chain (one random site per step), as a ``lax.scan``; bit-for-bit the
  reference's update rule ``dE = 2*S0*(H + J*Sn)``, accept iff ``dE < 0``
  or ``u < exp(-dE/T)``. This is the tolerance-test kernel.
- :func:`checkerboard_sweeps` — the data-parallel kernel: alternating
  red/black half-lattice updates. Sites of one color are conditionally
  independent given the other, so the parallel update targets the same
  stationary distribution. The per-site acceptance here is heat-bath
  (Gibbs), ``p_flip = 1 / (1 + exp(dE/T))``, not Metropolis: the
  Metropolis rule accepts ``dE = 0`` flips with probability 1, which
  makes the *synchronous* kernel flip zero-field sites deterministically
  every half-sweep — a periodic, reducible chain on small or striped
  configurations (verified by exact transition-matrix analysis on the
  2x2 torus). Heat-bath has the same stationary distribution with
  strictly positive flip probabilities, so the parallel chain stays
  ergodic. One sweep performs n^2 single-site updates in two vectorized
  steps instead of n^2 sequential ones.

Both vmap over an ensemble of lattices — the way to scale a
sequential-by-definition Markov chain (SURVEY.md §5 long-context note).

Deviation (documented): the reference returns a ragged list of energies
appended only on accepted flips; we return fixed-shape per-step traces
(cumulative energy and magnetization), which jit requires. Distributional
tests, not trace comparisons, establish parity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "init_lattice",
    "hamiltonian",
    "delta_e",
    "metropolis_chain",
    "checkerboard_sweeps",
    "ising_diagnostics",
]


def init_lattice(key: jax.Array, n: int) -> jax.Array:
    """Random +-1 spin configuration (``ising_simulator.py:9-12``)."""
    return jax.random.choice(key, jnp.asarray([1, -1], jnp.int8), shape=(n, n))


def _neighbor_sum(lattice: jax.Array) -> jax.Array:
    """Sum of the 4 torus neighbors at every site."""
    return (
        jnp.roll(lattice, 1, 0) + jnp.roll(lattice, -1, 0)
        + jnp.roll(lattice, 1, 1) + jnp.roll(lattice, -1, 1)
    )


def hamiltonian(lattice: jax.Array, J: float, H: float) -> jax.Array:
    """``-J * sum_adj s_i s_j - H * sum s_i`` with the reference's
    neighbor convention (each adjacent pair counted twice;
    ``ising_simulator.py:14-27``)."""
    s = lattice.astype(jnp.float32)
    return jnp.sum(s * (-J * _neighbor_sum(s) - H))


def delta_e(s0, sn, J, H):
    """Energy difference of flipping spin s0 with neighbor sum sn
    (``ising_simulator.py:30-39``)."""
    return 2.0 * s0 * (H + J * sn)


@functools.partial(jax.jit, static_argnames=("nsteps",))
def metropolis_chain(
    key: jax.Array,
    lattice: jax.Array,
    nsteps: int,
    J: float = 1.0,
    H: float = 0.0,
    T: float = 0.5,
):
    """Exact sequential single-site Metropolis
    (``ising_simulator.py:110-147``).

    Returns (lattice, energy_trace, magnetization_trace) where the traces
    are per-step cumulative values.
    """
    n = lattice.shape[0]
    lattice = lattice.astype(jnp.int8)
    Jf = jnp.float32(J)
    Hf = jnp.float32(H)
    Tf = jnp.float32(T)

    def step(carry, k):
        lat, energy, mag = carry
        ki, kj, ku = jax.random.split(k, 3)
        i = jax.random.randint(ki, (), 0, n)
        j = jax.random.randint(kj, (), 0, n)
        s0 = lat[i, j].astype(jnp.float32)
        sn = (
            lat[(i - 1) % n, j] + lat[(i + 1) % n, j]
            + lat[i, (j - 1) % n] + lat[i, (j + 1) % n]
        ).astype(jnp.float32)
        dE = delta_e(s0, sn, Jf, Hf)
        u = jax.random.uniform(ku, ())
        accept = jnp.logical_or(dE < 0, u < jnp.exp(-dE / Tf))
        lat = lat.at[i, j].multiply(jnp.where(accept, -1, 1).astype(jnp.int8))
        energy = energy + jnp.where(accept, dE, 0.0)
        mag = mag + jnp.where(accept, -2.0 * s0, 0.0)
        return (lat, energy, mag), (energy, mag)

    keys = jax.random.split(key, nsteps)
    mag0 = jnp.sum(lattice).astype(jnp.float32)
    (lattice, _, _), (energies, mags) = lax.scan(
        step, (lattice, jnp.float32(0.0), mag0), keys
    )
    return lattice, energies, mags


@functools.partial(jax.jit, static_argnames=("nsweeps",))
def checkerboard_sweeps(
    key: jax.Array,
    lattice: jax.Array,
    nsweeps: int,
    J: float = 1.0,
    H: float = 0.0,
    T: float = 0.5,
):
    """Red/black parallel heat-bath sweeps — the hot sampling kernel.

    One sweep = update all even-parity sites simultaneously, then all
    odd-parity ones, each flipped with the heat-bath probability
    ``1 / (1 + exp(dE/T))`` (see module docstring for why not
    Metropolis). Requires even lattice side for a consistent torus
    coloring.
    """
    n = lattice.shape[0]
    if n % 2 != 0:
        raise ValueError("checkerboard_sweeps needs an even lattice side")
    lattice = lattice.astype(jnp.int8)
    Jf, Hf, Tf = jnp.float32(J), jnp.float32(H), jnp.float32(T)
    ii = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    parity = (ii + jj) % 2

    def half_update(lat, color, k):
        s = lat.astype(jnp.float32)
        sn = _neighbor_sum(s)
        dE = delta_e(s, sn, Jf, Hf)
        u = jax.random.uniform(k, (n, n))
        p_flip = jax.nn.sigmoid(-dE / Tf)
        accept = jnp.logical_and(parity == color, u < p_flip)
        return jnp.where(accept, -lat, lat)

    def sweep(lat, k):
        k0, k1 = jax.random.split(k)
        lat = half_update(lat, 0, k0)
        lat = half_update(lat, 1, k1)
        return lat, None

    keys = jax.random.split(key, nsweeps)
    lattice, _ = lax.scan(sweep, lattice, keys)
    return lattice


@functools.partial(jax.jit, static_argnames=("nsteps",))
def ising_diagnostics(
    key: jax.Array,
    lattice: jax.Array,
    nsteps: int,
    J: float = 1.0,
    H: float = 0.0,
    T: float = 0.5,
    site: tuple[int, int] = (1, 1),
    corr_r: int = 1,
):
    """Single-site observables of the Metropolis chain: the tracked spin
    value, the distance-``corr_r`` 4-neighbor correlation ``Si*Sn/4``, and
    the per-step flip indicator of the tracked site — the quantities the
    reference's full simulator collects with ``count_spins`` /
    ``correlation`` (``/root/reference/ising_simulator.py:42-105``).

    Returns (lattice, Sis, SiSjs, flips) with per-step traces; flip
    *intervals* (the reference's ``counted_intervals``) are
    ``np.diff(np.flatnonzero(flips))`` on the host.
    """
    n = lattice.shape[0]
    lattice = lattice.astype(jnp.int8)
    Jf, Hf, Tf = jnp.float32(J), jnp.float32(H), jnp.float32(T)
    ic, jc = site

    def step(lat, k):
        ki, kj, ku = jax.random.split(k, 3)
        i = jax.random.randint(ki, (), 0, n)
        j = jax.random.randint(kj, (), 0, n)
        s0 = lat[i, j].astype(jnp.float32)
        sn = (
            lat[(i - 1) % n, j] + lat[(i + 1) % n, j]
            + lat[i, (j - 1) % n] + lat[i, (j + 1) % n]
        ).astype(jnp.float32)
        dE = delta_e(s0, sn, Jf, Hf)
        u = jax.random.uniform(ku, ())
        accept = jnp.logical_or(dE < 0, u < jnp.exp(-dE / Tf))
        prev = lat[ic, jc]
        lat = lat.at[i, j].multiply(jnp.where(accept, -1, 1).astype(jnp.int8))
        si = lat[ic, jc].astype(jnp.float32)
        snc = (
            lat[(ic - corr_r) % n, jc] + lat[(ic + corr_r) % n, jc]
            + lat[ic, (jc - corr_r) % n] + lat[ic, (jc + corr_r) % n]
        ).astype(jnp.float32)
        flipped = lat[ic, jc] != prev
        return lat, (si, si * snc / 4.0, flipped)

    keys = jax.random.split(key, nsteps)
    lattice, (sis, sisjs, flips) = lax.scan(step, lattice, keys)
    return lattice, sis, sisjs, flips
