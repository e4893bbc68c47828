"""Dictionary learning along an Ising MCMC trajectory.

A compiled re-design of ``Ising_Reconstructor``
(``/root/reference/ising_reconstruction.py:14-201``): the whole
trajectory loop — spin updates, random patch extraction, warm-started
online NMF with the full ``C = agg X X^T`` statistic, surrogate-error
tracking, per-step dictionary snapshots — is one jitted ``lax.scan``.

Parity notes:
- patches are taken from the raw +-1 lattice, exactly as the reference's
  ``extract_random_patches`` reads ``self.data = lattice`` without
  rescaling (``ising_reconstruction.py:46-66,114,147``);
- the reference tracks the surrogate error
  ``tr(W A W^T) - 2 tr(W B) + tr(C)`` after the initial round and every
  trajectory step (``:133,164``), so ``errors`` has
  ``ising_iterations + 1`` entries and ``dict_stack`` has
  ``ising_iterations + 1`` snapshots (``:136,168``);
- the reference's released driver has the in-loop lattice update
  commented out (``:144``); ``update_lattice=False`` reproduces that,
  while the default ``True`` follows the documented intent
  (``ising_subsampling_steps`` between learning rounds);
- ``sampler="exact"`` runs the sequential Metropolis chain;
  ``sampler="checkerboard"`` (default) runs red/black sweeps covering at
  least the same number of single-site updates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.models.onmf import _train_scan
from onmf_ontf_ndl_tpu.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend as _resolve_backend
from onmf_ontf_ndl_tpu.ops.patches import extract_patches, random_patch_corners
from onmf_ontf_ndl_tpu.samplers.ising import (
    checkerboard_sweeps,
    init_lattice,
    metropolis_chain,
)
from onmf_ontf_ndl_tpu.utils.metrics import surrogate_error

__all__ = ["IsingReconstructor", "ising_trajectory_learning", "display_errors"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "ising_iterations", "nsteps", "num_patches", "inner_iterations",
        "batch_size", "patch_size", "sampler", "update_lattice",
        "sub_iter", "keep_trajectory", "use_stopping", "backend",
        "subsample", "coder", "psum_axis",
    ),
)
def ising_trajectory_learning(
    state: OnmfState,
    lattice: jax.Array,
    key: jax.Array,
    *,
    ising_iterations: int,
    nsteps: int,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    J: float = 1.0,
    H_field: float = 0.0,
    T: float = 0.5,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    sampler: str = "checkerboard",
    update_lattice: bool = True,
    keep_trajectory: bool = False,
    use_stopping: bool = True,
    backend: str = "xla",
    subsample: bool = False,
    coder: str = "bcd",
    psum_axis: str | None = None,
):
    """Fused trajectory learner. Returns
    ``(state, dict_stack, errors, lattice, trajectory)`` where
    ``dict_stack`` is (ising_iterations+1, d, r), ``errors`` is
    (ising_iterations+1,) and ``trajectory`` is the per-step lattice stack
    (or a zero-length placeholder when ``keep_trajectory=False``)."""
    k = patch_size
    n = lattice.shape[0]
    if psum_axis is not None:
        # per-device lattice/patch key streams (the state-key streams
        # inside _train_scan fold themselves); each device advances its
        # OWN lattice and the aggregate statistics are psum'd
        key = jax.random.fold_in(key, lax.axis_index(psum_axis))
    dummy_code = jnp.zeros((state.r, num_patches), state.W.dtype)
    alpha_t = jnp.asarray(alpha, state.W.dtype)
    beta_t = jnp.asarray(beta, state.W.dtype)
    sd_t = jnp.asarray(stopping_diff, state.W.dtype)

    def train_round(st, lat, rkey):
        corners = random_patch_corners(rkey, lat.shape, k, num_patches)
        X = extract_patches(lat.astype(st.W.dtype), corners, k)
        st, _, _ = _train_scan(
            st, X, dummy_code, alpha_t, beta_t, sd_t,
            inner_iterations, batch_size, subsample, sub_iter,
            use_stopping, False, "stale", backend=backend, coder=coder,
            psum_axis=psum_axis,
        )
        return st

    def advance(lat, skey):
        if not update_lattice:
            return lat
        if sampler == "exact":
            lat, _, _ = metropolis_chain(skey, lat, nsteps, J, H_field, T)
            return lat
        nsweeps = max(1, -(-nsteps // (n * n)))
        return checkerboard_sweeps(skey, lat, nsweeps, J, H_field, T)

    # initial round (reference :113-136)
    key, rkey = jax.random.split(key)
    state = train_round(state, lattice, rkey)
    err0 = surrogate_error(state.W, state.A, state.B, state.C)
    W0 = state.W

    def body(carry, skey):
        st, lat = carry
        skey, rkey = jax.random.split(skey)
        lat = advance(lat, skey)
        st = train_round(st, lat, rkey)
        err = surrogate_error(st.W, st.A, st.B, st.C)
        out = (st.W, err, lat if keep_trajectory else jnp.zeros((0, 0), lat.dtype))
        return (st, lat), out

    keys = jax.random.split(key, ising_iterations)
    (state, lattice), (W_steps, errs, traj) = lax.scan(
        body, (state, lattice), keys
    )
    dict_stack = jnp.concatenate([W0[None], W_steps], axis=0)
    errors = jnp.concatenate([err0[None], errs])
    return state, dict_stack, errors, lattice, traj


class IsingReconstructor:
    """Driver shell mirroring ``Ising_Reconstructor``
    (``/root/reference/ising_reconstruction.py:14-43,222-233``)."""

    def __init__(
        self,
        n_components: int = 100,
        lattice_size: int = 200,
        ising_iterations: int = 500,
        temperature: float = 0.5,
        ising_subsampling_steps: int = 100,
        sub_iterations: int = 20,
        num_patches: int = 1000,
        batch_size: int = 20,
        patch_size: int = 20,
        beta: float = 0.5,
        J: float = 1.0,
        field: float = 0.0,
        alpha: float = 0.0,
        sampler: str = "checkerboard",
        update_lattice: bool = True,
        fast: bool = False,
        coder: str = "bcd",
        subsample: bool = False,
        seed: int = 0,
        dtype=jnp.float32,
    ):
        self.n_components = n_components
        self.lattice_size = lattice_size
        self.ising_iterations = ising_iterations
        self.temperature = temperature
        self.ising_subsampling_steps = ising_subsampling_steps
        self.sub_iterations = sub_iterations
        self.num_patches = num_patches
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.beta = beta
        self.J = J
        self.field = field
        self.alpha = alpha
        if sampler not in ("exact", "checkerboard"):
            raise ValueError(
                f"sampler must be 'exact' or 'checkerboard', got {sampler!r}")
        self.sampler = sampler
        self.update_lattice = update_lattice
        self.fast = fast
        self.coder = coder
        self.subsample = subsample
        self.dtype = dtype
        key = jax.random.key(seed)
        self.key, lkey, skey = jax.random.split(key, 3)
        self.lattice = init_lattice(lkey, lattice_size)
        d = patch_size**2
        # full-aggregate path: the Ising driver is the one that tracks
        # C = agg X X^T for the surrogate error (SURVEY.md C12).
        # NOTE: skey (not self.key) seeds the state so the driver key
        # stream stays disjoint from the optimizer key stream.
        self.state = init_state(skey, d, n_components, track_xxt=True,
                                dtype=dtype)
        self.W = self.state.W
        self.errors = None
        self.dict_stack = None

    def ising_mcmc_learning(self, initial_lattice=None, keep_trajectory=False):
        """Learn along the trajectory; returns
        ``(trajectory, dict_stack, errors)`` like the reference
        (``ising_reconstruction.py:179``)."""
        if initial_lattice is not None:
            # the reference warm-starts from saved float trajectories
            # (ising_reconstruction.py:102); the samplers carry int8
            self.lattice = jnp.asarray(initial_lattice, jnp.int8)
        self.key, lkey = jax.random.split(self.key)
        (self.state, self.dict_stack, self.errors, self.lattice, traj
         ) = ising_trajectory_learning(
            self.state, self.lattice, lkey,
            ising_iterations=self.ising_iterations,
            nsteps=self.ising_subsampling_steps,
            num_patches=self.num_patches,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            J=self.J, H_field=self.field, T=self.temperature,
            alpha=self.alpha, beta=self.beta,
            sampler=self.sampler, update_lattice=self.update_lattice,
            keep_trajectory=keep_trajectory,
            use_stopping=not self.fast,
            backend=_resolve_backend("auto"),
            coder=self.coder,
            subsample=self.subsample,
        )
        self.W = self.dict_stack[-1]
        return traj, self.dict_stack, self.errors

    def reconstruct_config(self, config, patch_size: int | None = None):
        """Reconstruct a spin configuration from the learned dictionary
        (``ising_reconstruction.py:190-201``): full patch grid on the
        (x+1)/2 rescaled config, overlap-averaged."""
        from onmf_ontf_ndl_tpu.apps.image import reconstruct

        k = patch_size or self.patch_size
        data = (jnp.asarray(config, self.dtype) + 1.0) / 2.0
        return reconstruct(
            data, self.W, jax.random.key(23), patch_size=k,
            alpha=self.alpha, full_grid=True, method=self.coder,
        )


def display_errors(error_files: dict, *, lattice_sites: float = 40000.0,
                   total_updates: float = 500.0,
                   save_path: str | None = None, show: bool = False):
    """Errors-over-subsampling comparison plot — the reference's
    ``display_errors`` (``ising_reconstruction.py:203-221``): one surrogate
    error trace per subsampling epoch, x rescaled to a common span of
    ``total_updates``, y normalized by the lattice site count.

    ``error_files`` maps a label (e.g. "subsampling epoch of 1000") to a
    saved ``errors`` .npy path or an array.
    """
    import numpy as np

    from onmf_ontf_ndl_tpu.utils.viz import display_errors_comparison

    traces = {}
    for label, src in error_files.items():
        traces[label] = np.load(src) if isinstance(src, str) else np.asarray(src)
    return display_errors_comparison(
        traces, total_updates=total_updates, normalize=lattice_sites,
        xlabel="effective epoch", ylabel="surrogate error / site",
        save_path=save_path, show=show)
