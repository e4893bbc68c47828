"""Color-image dictionary learning on (k^2, 3, n) patch tensors via ONTF.

A compiled re-design of ``Image_Reconstructor_tensor``
(``/root/reference/image_reconstruction_tensor.py:15-328``): per outer
iteration, random color patches are gathered into a (k^2, 3, n) tensor,
mode-unfolded (``/root/reference/src/ontf.py:203-208``), and fed through
the shared online-factorization scan. The whole outer loop is one jitted
``lax.scan``.

Mode semantics (reference ``train_dict_single`` docstring):
- ``mode=0, joint=False`` — marginal spatial dictionary, d = k^2
  (channels become extra samples);
- ``mode=1, joint=False`` — channel dictionary, d = 3;
- ``mode=2, joint=True``  — joint color dictionary, d = 3 k^2 (the
  configuration the reference driver runs,
  ``image_reconstruction_tensor.py:361``).

The coder default is ``alpha=2`` (sklearn ``SparseCoder`` default the
reference ONTF uses, ``src/ontf.py:79-82``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from onmf_ontf_ndl_tpu.data.images import load_image
from onmf_ontf_ndl_tpu.models.onmf import _train_scan
from onmf_ontf_ndl_tpu.models.state import init_state
from onmf_ontf_ndl_tpu.ops.pallas import resolve_backend as _resolve_backend
from onmf_ontf_ndl_tpu.ops.patches import extract_patches, random_patch_corners
from onmf_ontf_ndl_tpu.ops.unfold import unfold

__all__ = ["ImageReconstructorTensor", "unfolded_dim"]


def unfolded_dim(k: int, num_patches: int, mode: int, joint: bool,
                 channels: int = 3) -> int:
    """Feature dimension of the mode-unfolded patch tensor:
    (k^2, 3, n) for color, (k^2, n, 1) for grayscale (the reference's
    layouts, ``image_reconstruction_tensor.py:101-124``)."""
    shape = ((k * k, channels, num_patches) if channels == 3
             else (k * k, num_patches, 1))
    if joint:
        rest = 1
        for i, s in enumerate(shape):
            if i != mode:
                rest *= s
        return rest
    return shape[mode]


@functools.partial(
    jax.jit,
    static_argnames=(
        "outer_iterations", "num_patches", "inner_iterations", "batch_size",
        "patch_size", "mode", "joint", "sub_iter", "use_stopping", "backend",
        "subsample", "coder",
    ),
    donate_argnums=(0,),
)
def _train_tensor(
    state, img, *,
    outer_iterations: int, num_patches: int, inner_iterations: int,
    batch_size: int, patch_size: int, mode: int, joint: bool,
    alpha: float, beta: float, sub_iter: int, stopping_diff: float = 0.01,
    use_stopping: bool = True, backend: str = "xla",
    subsample: bool = True, coder: str = "bcd",
):
    k = patch_size
    alpha_t = jnp.asarray(alpha, img.dtype)
    beta_t = jnp.asarray(beta, img.dtype)
    sd_t = jnp.asarray(stopping_diff, img.dtype)

    def outer(st, _):
        key, pkey = jax.random.split(st.key)
        st = dataclasses.replace(st, key=key)
        corners = random_patch_corners(pkey, img.shape[:2], k, num_patches)
        X = extract_patches(img, corners, k)
        if img.ndim == 3:                                     # (3k^2, n)
            T = jnp.moveaxis(X.T.reshape(num_patches, k * k, 3), 0, 2)
        else:                                                 # (k^2, n)
            # grayscale patch tensor (k^2, n, 1) — the reference's b/w
            # layout (samples on axis 1, a singleton channel axis)
            T = X[:, :, None]
        Xu = unfold(T, mode)
        if joint:
            Xu = Xu.T
        dummy_code = jnp.zeros((st.r, Xu.shape[1]), img.dtype)
        st, _, _ = _train_scan(
            st, Xu, dummy_code, alpha_t, beta_t, sd_t,
            inner_iterations, batch_size, subsample, sub_iter,
            use_stopping, False, "stale", backend=backend, coder=coder,
        )
        return st, None

    state, _ = lax.scan(outer, state, None, length=outer_iterations)
    return state


class ImageReconstructorTensor:
    """Driver shell mirroring ``Image_Reconstructor_tensor.__init__``
    (``image_reconstruction_tensor.py:16-53``)."""

    def __init__(
        self,
        path: str | None = None,
        data=None,
        n_components: int = 100,
        iterations: int = 50,
        sub_iterations: int = 20,
        batch_size: int = 20,
        block_iterations: int = 20,
        num_patches: int = 1000,
        sub_num_patches: int = 10000,
        downscale_factor: int = 2,
        patch_size: int = 7,
        learn_joint_dict: bool = False,
        is_matrix: bool = False,
        is_color: bool = True,
        alpha: float | None = None,
        beta: float | None = None,
        fast: bool = False,
        coder: str = "exact",
        coder_sub_iter: int | None = None,
        seed: int = 0,
        dtype=jnp.float32,
    ):
        if data is None:
            if path is None:
                raise ValueError("provide path or data")
            data = load_image(path, is_matrix=is_matrix, is_color=is_color,
                              dtype=dtype)
        self.data = jnp.asarray(data, dtype)
        self.path = path
        self.n_components = n_components
        self.iterations = iterations
        self.sub_iterations = sub_iterations
        self.block_iterations = block_iterations
        self.num_patches = num_patches
        # sub_num_patches mirrors the reference ctor knob; its
        # second_factor H-optimization path is dead code in the
        # reference's own drivers and is not ported (PARITY.md)
        self.sub_num_patches = sub_num_patches
        self.downscale_factor = downscale_factor
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.learn_joint_dict = learn_joint_dict
        # sklearn SparseCoder default transform_alpha=2 (src/ontf.py:79-82)
        self.alpha = 2.0 if alpha is None else float(alpha)
        self.beta = 1.0 if beta is None else float(beta)
        self.fast = fast
        self.coder = coder
        # ONTF-surface coder policy (exact-by-default — the reference's
        # tensor coder is an exact sklearn LARS solve in BOTH training
        # and reconstruction, image_reconstruction_tensor.py:309-312;
        # measured default-path e2e recon gap 0.7%,
        # benchmarks/reference_parity_ontf.py): see resolve_tensor_coder
        from onmf_ontf_ndl_tpu.models.ontf import resolve_tensor_coder

        self._coder_method, self.coder_sub_iter = resolve_tensor_coder(
            coder, block_iterations, coder_sub_iter)
        self.seed = seed
        self.dtype = dtype
        self.state = None
        self.W = None

    def train_dict(self, mode: int, learn_joint_dict: bool | None = None):
        """Learn the mode-``mode`` dictionary; returns W
        (``image_reconstruction_tensor.py:220-262``)."""
        joint = (self.learn_joint_dict if learn_joint_dict is None
                 else learn_joint_dict)
        channels = 3 if self.data.ndim == 3 else 1
        d = unfolded_dim(self.patch_size, self.num_patches, mode, joint,
                         channels)
        self.state = init_state(jax.random.key(self.seed), d,
                                self.n_components, dtype=self.dtype)
        self.state = _train_tensor(
            self.state, self.data,
            outer_iterations=self.iterations,
            num_patches=self.num_patches,
            inner_iterations=self.sub_iterations,
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            mode=mode, joint=joint,
            alpha=self.alpha, beta=self.beta,
            sub_iter=self.coder_sub_iter,
            use_stopping=not self.fast,
            backend=_resolve_backend("auto"),
            coder=self._coder_method,
        )
        self.W = self.state.W
        return self.W

    def reconstruct_image_color(self, path: str | None = None, data=None,
                                recons_resolution: int = 1,
                                alpha: float = 1.0):
        """Color reconstruction from the joint (3k^2, r) dictionary
        (``image_reconstruction_tensor.py:287-328``; coder alpha=1 per
        ``:309-310``)."""
        from onmf_ontf_ndl_tpu.apps.image import reconstruct

        k = self.patch_size
        if self.W is None or self.W.shape[0] != 3 * k * k:
            raise ValueError(
                "color reconstruction needs a trained joint (3k^2, r) "
                "dictionary (train with mode=2, learn_joint_dict=True)")
        if data is None:
            data = load_image(path or self.path, is_color=True,
                              dtype=self.dtype)
        return reconstruct(
            jnp.asarray(data, self.dtype), self.W, jax.random.key(29),
            patch_size=self.patch_size, stride=recons_resolution, alpha=alpha,
            sub_iter=self.coder_sub_iter, method=self._coder_method,
        )

    def reconstruct_image(self, path: str | None = None, data=None,
                          downscale_factor: int | None = None,
                          patch_size: int | None = None):
        """Grayscale full-grid reconstruction from a spatial (k^2, r)
        dictionary — the tensor app's ``reconstruct_image``
        (``image_reconstruction_tensor.py:260-275``): every overlapping
        patch is coded at once with the instance's NTF coder alpha and
        folded with ``reconstruct_from_patches_2d`` semantics. Requires a
        mode-0 marginal dictionary (d = k^2)."""
        from onmf_ontf_ndl_tpu.apps.image import reconstruct
        from onmf_ontf_ndl_tpu.data.images import downscale_local_mean

        if downscale_factor is None:
            downscale_factor = self.downscale_factor
        k = patch_size or self.patch_size
        if self.W is None or self.W.shape[0] != k * k:
            raise ValueError(
                "grayscale reconstruction needs a (k^2, r) spatial "
                "dictionary (train with mode=0, learn_joint_dict=False)")
        if data is None:
            data = load_image(path or self.path, is_color=False,
                              dtype=self.dtype)
        data = downscale_local_mean(jnp.asarray(data, self.dtype),
                                    downscale_factor)
        return reconstruct(
            data, self.W, jax.random.key(29), patch_size=k,
            alpha=self.alpha, full_grid=True,
            sub_iter=self.coder_sub_iter, method=self._coder_method,
        )

    def display_second_dictionary(self, H, save_path: str | None = None,
                                  show: bool = False):
        """Heatmap of the second (channel) factor
        (``image_reconstruction_tensor.py:177-185``)."""
        from onmf_ontf_ndl_tpu.utils.viz import display_second_dictionary

        return display_second_dictionary(
            H, patch_size=self.patch_size, save_path=save_path, show=show)
