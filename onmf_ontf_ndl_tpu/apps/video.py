"""Streaming video dictionary learning.

The online-learning-over-video demo of the reference (C15 in SURVEY.md §2:
``online_learning_video.ipynb``, stripped upstream but enumerated in
``BASELINE.json`` configs as "streaming bruce frames, incremental dict").
Frames arrive as a stream; each step extracts random patches from the
current frame and advances the warm-started online NMF — the Markovian-
data setting the JMLR paper is about. The whole pass over the video is
one jitted ``lax.scan`` over frames.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.data.video import load_video_frames
from onmf_ontf_ndl_tpu.models.onmf import _train_scan
from onmf_ontf_ndl_tpu.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend as _resolve_backend
from onmf_ontf_ndl_tpu.ops.patches import extract_patches, random_patch_corners

__all__ = ["VideoDictionaryLearner", "train_video_dict"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_patches", "inner_iterations", "batch_size", "patch_size",
        "epochs", "sub_iter", "use_stopping", "backend", "subsample",
        "coder",
    ),
    donate_argnums=(0,),
)
def train_video_dict(
    state: OnmfState,
    frames: jax.Array,
    *,
    num_patches: int,
    inner_iterations: int,
    batch_size: int,
    patch_size: int,
    epochs: int = 1,
    alpha: float = 0.0,
    beta: float = 1.0,
    sub_iter: int = 10,
    stopping_diff: float = 0.01,
    use_stopping: bool = True,
    backend: str = "xla",
    subsample: bool = False,
    coder: str = "bcd",
) -> OnmfState:
    """Stream over frames (in order, ``epochs`` passes), one warm-started
    online-NMF round per frame."""
    k = patch_size
    F = frames.shape[0]
    dummy_code = jnp.zeros((state.r, num_patches), frames.dtype)
    alpha_t = jnp.asarray(alpha, frames.dtype)
    beta_t = jnp.asarray(beta, frames.dtype)
    sd_t = jnp.asarray(stopping_diff, frames.dtype)

    def per_frame(st, f_idx):
        key, pkey = jax.random.split(st.key)
        st = dataclasses.replace(st, key=key)
        frame = frames[f_idx]
        corners = random_patch_corners(pkey, frames.shape[1:3], k, num_patches)
        X = extract_patches(frame, corners, k)
        st, _, _ = _train_scan(
            st, X, dummy_code, alpha_t, beta_t, sd_t,
            inner_iterations, batch_size, subsample, sub_iter,
            use_stopping, False, "stale", backend=backend, coder=coder,
        )
        return st, None

    order = jnp.tile(jnp.arange(F), epochs)
    state, _ = lax.scan(per_frame, state, order)
    return state


class VideoDictionaryLearner:
    """Streaming learner over a GIF/video; reconstructs individual frames
    with the shared image reconstruction path."""

    def __init__(
        self,
        path: str | None = None,
        frames=None,
        n_components: int = 100,
        sub_iterations: int = 10,
        num_patches: int = 200,
        batch_size: int = 20,
        patch_size: int = 7,
        is_color: bool = True,
        alpha: float | None = None,
        beta: float | None = None,
        max_frames: int | None = None,
        fast: bool = False,
        coder: str = "bcd",
        subsample: bool = False,
        seed: int = 0,
        dtype=jnp.float32,
    ):
        if frames is None:
            if path is None:
                raise ValueError("provide path or frames")
            frames = load_video_frames(path, max_frames=max_frames,
                                       is_color=is_color, dtype=dtype)
        self.frames = jnp.asarray(frames, dtype)
        self.is_color = self.frames.ndim == 4
        self.n_components = n_components
        self.sub_iterations = sub_iterations
        self.num_patches = num_patches
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.fast = fast
        self.coder = coder
        # batch_size only takes effect with subsample=True (otherwise
        # every inner step trains on the full num_patches columns)
        self.subsample = subsample
        self.dtype = dtype
        d = (3 if self.is_color else 1) * patch_size**2
        self.state = init_state(jax.random.key(seed), d, n_components,
                                dtype=dtype)

    @property
    def W(self):
        return self.state.W

    def train_dict(self, epochs: int = 1):
        self.state = train_video_dict(
            self.state, self.frames,
            num_patches=self.num_patches,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            epochs=epochs, alpha=self.alpha, beta=self.beta,
            use_stopping=not self.fast,
            backend=_resolve_backend("auto"),
            coder=self.coder, subsample=self.subsample,
        )
        return self.state.W

    def reconstruct_frame(self, index: int, stride: int = 1,
                          alpha: float = 1.0):
        from onmf_ontf_ndl_tpu.apps.image import reconstruct

        return reconstruct(
            self.frames[index], self.state.W, jax.random.key(31),
            patch_size=self.patch_size, stride=stride, alpha=alpha,
            method=self.coder,
        )
