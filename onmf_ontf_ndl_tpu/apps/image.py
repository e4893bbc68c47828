"""Image dictionary learning + reconstruction (the canonical ONMF pipeline).

A compiled re-design of ``Image_Reconstructor``
(``/root/reference/image_reconstruction.py:14-406``): the entire outer
training loop — random patch extraction, inner online-NMF iterations,
state threading — is ONE jitted ``lax.scan``; training never leaves the
device. Reconstruction codes every grid patch in a single batched coder
call and paints with a scatter-add overlap average (vs. the reference's
per-patch Python loop, ``:375-392``).

Parity notes:
- training patches are sampled from the full-resolution image (the
  reference's ``extract_random_patches`` reads ``self.data``, which is
  never downscaled; downscaling only applies to the
  ``image_to_patches``-based grayscale reconstruction path);
- color reconstruction codes patches with ``alpha=1, sub_iter=10``
  exactly as ``:384``; the early-stopping rule is evaluated on the whole
  batch rather than per patch — the same batched-stopping semantics the
  reference's own grayscale path uses (``:349-350``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.data.images import load_image, downscale_local_mean
from onmf_ontf_ndl_tpu.models.onmf import _train_scan
from onmf_ontf_ndl_tpu.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu.ops.coder import nonneg_code
from onmf_ontf_ndl_tpu.ops.patches import (
    extract_patches,
    extract_patches_grid,
    overlap_average_grid,
    random_patch_corners,
)

__all__ = ["ImageReconstructor", "train_image_dict", "reconstruct"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "outer_iterations", "num_patches", "inner_iterations", "batch_size",
        "patch_size", "sub_iter", "use_stopping", "dict_from", "backend",
        "subsample", "coder",
    ),
    donate_argnums=(0,),
)
def train_image_dict(
    state: OnmfState,
    img: jax.Array,
    *,
    outer_iterations: int,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    use_stopping: bool = True,
    stopping_diff: float = 0.01,
    dict_from: str = "stale",
    backend: str = "xla",
    subsample: bool = False,
    coder: str = "bcd",
) -> OnmfState:
    """Fused streaming trainer: outer scan samples patches, inner scan runs
    online-NMF steps; mirrors the two-level loop of
    ``/root/reference/image_reconstruction.py:286-312`` +
    ``/root/reference/src/onmf.py:206-220``."""
    k = patch_size
    dummy_code = jnp.zeros((state.r, num_patches), img.dtype)
    alpha_t = jnp.asarray(alpha, img.dtype)
    beta_t = jnp.asarray(beta, img.dtype)
    sd_t = jnp.asarray(stopping_diff, img.dtype)

    def outer(st, _):
        key, pkey = jax.random.split(st.key)
        st = dataclasses.replace(st, key=key)
        corners = random_patch_corners(pkey, img.shape[:2], k, num_patches)
        X = extract_patches(img, corners, k)
        st, _, _ = _train_scan(
            st, X, dummy_code, alpha_t, beta_t, sd_t,
            inner_iterations, batch_size, subsample, sub_iter,
            use_stopping, False, dict_from, backend=backend, coder=coder,
        )
        return st, None

    state, _ = lax.scan(outer, state, length=outer_iterations)
    return state


@functools.partial(
    jax.jit, static_argnames=("patch_size", "stride", "sub_iter",
                              "use_stopping", "full_grid", "method")
)
def reconstruct(
    img: jax.Array,
    W: jax.Array,
    key: jax.Array,
    *,
    patch_size: int,
    stride: int = 1,
    alpha: float = 1.0,
    sub_iter: int = 10,
    use_stopping: bool = False,
    stopping_diff: float = 0.01,
    full_grid: bool = False,
    method: str = "bcd",
) -> jax.Array:
    """Reconstruct an image from its dictionary by coding every grid patch
    at once and overlap-averaging (``/root/reference/image_reconstruction.py:358-406``).

    ``full_grid=True`` uses every patch position (the
    ``extract_patches_2d``/``reconstruct_from_patches_2d`` grayscale path,
    ``:340-356``); otherwise a strided grid exclusive of the last start.

    Default ``use_stopping=False``: reconstruction runs the full fixed
    sweep count (one kernel launch on a GPU). The reference's
    batched early-stopping rule needs a spectral norm of the whole
    (r, num_patches) iterate per sweep, which is prohibitively slow at
    reconstruction widths; fixed sweeps only ever run MORE coder
    iterations, never fewer.
    """
    k = patch_size
    # gather/scatter-free regular-grid forms: conv-patches extraction and
    # pad-dilation folding (the generic corner-based ops cost ~200s of XLA
    # scatter compilation at real image sizes)
    X = extract_patches_grid(img, k, stride, inclusive=full_grid)
    H = nonneg_code(
        X, W, key=key, alpha=alpha, sub_iter=sub_iter,
        stopping_diff=(stopping_diff if use_stopping else None),
        method=method,
    )
    recon_patches = W @ H
    return overlap_average_grid(recon_patches, k, stride, img.shape,
                                inclusive=full_grid)


class ImageReconstructor:
    """Driver-ergonomics shell over the fused pipeline; constructor knobs
    mirror ``Image_Reconstructor.__init__``
    (``/root/reference/image_reconstruction.py:15-71``)."""

    def __init__(
        self,
        path: str | None = None,
        data=None,
        n_components: int = 100,
        iterations: int = 200,
        sub_iterations: int = 20,
        num_patches: int = 1000,
        batch_size: int = 20,
        downscale_factor: int = 2,
        patch_size: int = 7,
        is_matrix: bool = False,
        is_stack: bool = False,
        is_color: bool = True,
        alpha: float | None = None,
        beta: float | None = None,
        fast: bool = False,
        subsample: bool = False,
        coder: str = "bcd",
        seed: int = 0,
        dtype=jnp.float32,
    ):
        if data is None:
            if path is None:
                raise ValueError("ImageReconstructor: provide path or data")
            if is_stack:
                # stack of matrices, e.g. an Ising trajectory .npy
                # (reference stack_to_patches,
                # image_reconstruction.py:208-229): the +-1 -> [0, 1]
                # mapping is load_image's is_matrix transform
                data = load_image(path, is_matrix=True, is_color=False,
                                  dtype=dtype)
            else:
                data = load_image(path, is_matrix=is_matrix,
                                  is_color=is_color, dtype=dtype)
        self.data = jnp.asarray(data, dtype)
        self.is_stack = is_stack
        if is_stack:
            if self.data.ndim != 3:
                raise ValueError("is_stack expects a (m, H, W) array")
            # matrix stacks are grayscale by construction (the reference's
            # stack path handles +-1 matrices); the dictionary dim is k^2
            is_color = False
            self.is_color = False
        self.path = path
        self.n_components = n_components
        self.iterations = iterations
        self.sub_iterations = sub_iterations
        self.num_patches = num_patches
        self.batch_size = batch_size
        self.downscale_factor = downscale_factor
        self.patch_size = patch_size
        self.is_matrix = is_matrix
        self.is_color = is_color
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.fast = fast
        self.subsample = subsample
        self.coder = coder
        self.dtype = dtype

        d = (3 if is_color else 1) * patch_size**2
        self.state = init_state(jax.random.key(seed), d, n_components,
                                dtype=dtype)
        self.A_recons = None

    @property
    def W(self):
        return self.state.W

    @W.setter
    def W(self, value):
        self.state = dataclasses.replace(
            self.state, W=jnp.asarray(value, self.dtype))

    def train_dict(self, checkpoint_path: str | None = None,
                   checkpoint_every: int = 0, resume: bool = False):
        """Run the full streaming training; returns the dictionary (d, r).

        ``checkpoint_path`` + ``checkpoint_every=N`` chunk the outer loop
        (outer iterations; epochs on the ``is_stack`` path) into runs of
        N with a full-state checkpoint written between chunks. Chunked
        training equals the uninterrupted run exactly (the checkpoint
        carries the PRNG key and the t^-beta schedule counter;
        ``tests/test_production_api.py``). ``resume=True`` restarts an
        interrupted run from the checkpoint: the completed outer count is
        recovered from the schedule counter ``state.t`` (each outer
        iteration advances it by ``sub_iterations``), so only the
        REMAINING iterations run.

        With ``is_stack=True`` the outer loop streams over the stacked
        matrices (one warm-started round per frame,
        ``epochs = max(1, iterations // n_frames)`` passes — i.e.
        ``iterations`` approximates the TOTAL number of rounds), the stack
        analogue of the reference's ``read_patches_stack`` path
        (``image_reconstruction.py:106-115,208-229``)."""
        from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend

        if (checkpoint_path or resume) and checkpoint_every <= 0:
            raise ValueError(
                "checkpoint_path/resume require checkpoint_every > 0 "
                "(otherwise the request would be silently ignored and "
                "training restarted from scratch)")
        if self.is_stack:
            from onmf_ontf_ndl_tpu.apps.video import train_video_dict

            total = max(1, self.iterations // self.data.shape[0])
            # one outer unit on this path = one epoch over all frames,
            # advancing state.t by sub_iterations * n_frames
            t_per_unit = self.sub_iterations * self.data.shape[0]

            def run(st, units):
                return train_video_dict(
                    st, self.data,
                    num_patches=self.num_patches,
                    inner_iterations=self.sub_iterations,
                    batch_size=self.batch_size,
                    patch_size=self.patch_size,
                    epochs=units,
                    alpha=self.alpha, beta=self.beta,
                    use_stopping=not self.fast,
                    backend=resolve_backend("auto"),
                    coder=self.coder,
                )
        else:
            total = self.iterations
            t_per_unit = self.sub_iterations

            def run(st, units):
                return train_image_dict(
                    st, self.data,
                    outer_iterations=units,
                    num_patches=self.num_patches,
                    inner_iterations=self.sub_iterations,
                    batch_size=self.batch_size,
                    patch_size=self.patch_size,
                    alpha=self.alpha, beta=self.beta,
                    use_stopping=not self.fast,
                    backend=resolve_backend("auto"),
                    subsample=self.subsample,
                    coder=self.coder,
                )

        if checkpoint_path and checkpoint_every > 0:
            import os as _os

            from onmf_ontf_ndl_tpu.utils.checkpoint import (
                checkpoint_exists, load_state, save_state)

            done = 0
            if resume and checkpoint_exists(checkpoint_path):
                self.state = load_state(checkpoint_path, dtype=self.dtype)
                done = int(round(float(self.state.t))) // t_per_unit
            while done < total:
                chunk = min(checkpoint_every, total - done)
                self.state = run(self.state, chunk)
                done += chunk
                save_state(checkpoint_path, self.state)
        else:
            self.state = run(self.state, total)
        return self.state.W

    def extract_patches(self, num_patches: int | None = None, seed: int = 23):
        """Sample a (d, n) random-patch matrix from the training image —
        the sampler the fused trainer uses internally
        (``extract_random_patches``, ``image_reconstruction.py:173-206``)."""
        from onmf_ontf_ndl_tpu.ops.patches import (
            extract_patches, random_patch_corners)

        n = num_patches or self.num_patches
        corners = random_patch_corners(
            jax.random.key(seed), self.data.shape[:2], self.patch_size, n)
        return extract_patches(self.data, corners, self.patch_size)

    def save_patches(self, filename: str, num_patches: int | None = None):
        """Sample and save a patch matrix to ``filename`` (.npy) — the
        reference's ``save_patches`` (``image_reconstruction.py:231-235``;
        there it saves the constructor-loaded ``self.patches``, which the
        fused pipeline never materializes — so this samples them)."""
        import numpy as _np

        X = self.extract_patches(num_patches)
        _np.save(filename, _np.asarray(X))
        return filename

    def display_dictionary(self, W=None, save_path: str | None = None,
                           show: bool = False):
        """Dictionary patch grid (``display_dictionary``,
        ``image_reconstruction.py:237-260``)."""
        from onmf_ontf_ndl_tpu.utils.viz import display_dictionary

        return display_dictionary(
            W if W is not None else self.W, self.patch_size,
            is_color=self.is_color, save_path=save_path, show=show)

    def reconstruct_image_color(self, path: str | None = None, data=None,
                                recons_resolution: int = 1, alpha: float = 1.0):
        """Color reconstruction on a strided grid
        (``/root/reference/image_reconstruction.py:358-406``)."""
        if data is None:
            data = load_image(path or self.path, is_matrix=self.is_matrix,
                              is_color=True, dtype=self.dtype)
        key = jax.random.key(17)
        self.A_recons = reconstruct(
            jnp.asarray(data, self.dtype), self.state.W, key,
            patch_size=self.patch_size, stride=recons_resolution, alpha=alpha,
            method=self.coder,
        )
        return self.A_recons

    def reconstruct_image(self, path: str | None = None, data=None,
                          downscale_factor: int | None = None,
                          patch_size: int | None = None,
                          alpha: float = 0.0):
        """Grayscale full-grid reconstruction
        (``/root/reference/image_reconstruction.py:340-356``). The coder
        runs with ``alpha=0`` regardless of the training alpha — the
        reference builds a fresh ``Online_NMF`` with alpha defaulting to None -> 0
        for this path (``:349-350``)."""
        if downscale_factor is None:
            downscale_factor = self.downscale_factor
        k = patch_size or self.patch_size
        if data is None:
            data = load_image(path or self.path, is_matrix=self.is_matrix,
                              is_color=False, dtype=self.dtype)
        data = downscale_local_mean(jnp.asarray(data, self.dtype),
                                    downscale_factor)
        key = jax.random.key(17)
        self.A_recons = reconstruct(
            data, self.state.W, key, patch_size=k,
            alpha=alpha, full_grid=True, method=self.coder,
        )
        return self.A_recons
