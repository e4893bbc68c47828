"""Tests for the ONTF color-tensor app and the streaming video app."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor, unfolded_dim
from onmf_ontf_ndl_tpu.apps.video import VideoDictionaryLearner


def make_image(h=40, w=40, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.4 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    img = np.stack([base, base**2, 1 - base], axis=-1)
    return np.clip(img + 0.02 * rng.random(img.shape), 0, 1)


def test_unfolded_dims():
    assert unfolded_dim(5, 100, 0, False) == 25
    assert unfolded_dim(5, 100, 1, False) == 3
    assert unfolded_dim(5, 100, 2, False) == 100
    assert unfolded_dim(5, 100, 2, True) == 75   # joint: 3k^2
    assert unfolded_dim(5, 100, 0, True) == 300  # 3 * n


def test_tensor_joint_mode2_pipeline():
    img = make_image()
    rec = ImageReconstructorTensor(
        data=img, n_components=12, iterations=10, sub_iterations=5,
        batch_size=16, block_iterations=6, num_patches=40, patch_size=5,
        dtype=jnp.float64,
    )
    W = rec.train_dict(mode=2, learn_joint_dict=True)
    assert W.shape == (75, 12)
    assert (np.asarray(W) >= 0).all()
    assert float(rec.state.t) == 10 * 5
    out = rec.reconstruct_image_color(data=img, recons_resolution=2)
    assert out.shape == img.shape
    assert np.isfinite(np.asarray(out)).all()


def test_tensor_marginal_modes():
    img = make_image()
    rec = ImageReconstructorTensor(
        data=img, n_components=8, iterations=5, sub_iterations=4,
        batch_size=10, block_iterations=4, num_patches=30, patch_size=4,
        dtype=jnp.float64,
    )
    W0 = rec.train_dict(mode=0, learn_joint_dict=False)
    assert W0.shape == (16, 8)
    W1 = rec.train_dict(mode=1, learn_joint_dict=False)
    assert W1.shape == (3, 8)


def test_video_streaming():
    rng = np.random.default_rng(6)
    base = make_image()
    frames = np.stack([np.roll(base, s, axis=1) for s in range(6)])
    learner = VideoDictionaryLearner(
        frames=frames, n_components=9, sub_iterations=4, num_patches=30,
        batch_size=10, patch_size=5, dtype=jnp.float64,
    )
    W = learner.train_dict(epochs=2)
    assert W.shape == (75, 9)
    assert (np.asarray(W) >= 0).all()
    # streamed 6 frames x 2 epochs x (4-1+1) history bumps of 4 each
    assert float(learner.state.t) == 12 * 4
    out = learner.reconstruct_frame(0, stride=2)
    assert out.shape == base.shape


def test_video_gif_loader():
    from onmf_ontf_ndl_tpu.data.video import load_video_frames

    from test_reference_parity import REF

    if not os.path.isdir(REF):
        pytest.skip("the reference checkout is not present")
    frames = load_video_frames("/root/reference/Data/Video/giphy-2.gif",
                               max_frames=3)
    assert frames.ndim == 4 and frames.shape[0] == 3 and frames.shape[3] == 3
    f = np.asarray(frames)
    assert f.min() >= 0.0 and f.max() <= 1.0


def test_tensor_app_grayscale_training():
    """The reference's b/w patch-tensor layout (k^2, n, 1): training a
    marginal mode-0 dictionary on a 2-D input must work (was a crash)."""
    from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor

    rng = np.random.default_rng(0)
    img = rng.random((30, 40)).astype(np.float32)
    rec = ImageReconstructorTensor(
        data=img, n_components=5, iterations=3, sub_iterations=3,
        block_iterations=2, num_patches=20, batch_size=10, patch_size=4,
        is_color=False)
    W = np.asarray(rec.train_dict(mode=0, learn_joint_dict=False))
    assert W.shape == (16, 5) and (W >= 0).all()
    out = rec.reconstruct_image(data=img, downscale_factor=1, patch_size=4)
    assert np.asarray(out).shape == (30, 40)


def test_tensor_app_downscale_factor_stored():
    from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor

    rng = np.random.default_rng(1)
    img = rng.random((24, 24)).astype(np.float32)
    rec = ImageReconstructorTensor(
        data=img, n_components=4, iterations=2, sub_iterations=2,
        num_patches=10, batch_size=5, patch_size=3, is_color=False,
        downscale_factor=2)
    rec.train_dict(mode=0, learn_joint_dict=False)
    out = rec.reconstruct_image(data=img)      # uses ctor downscale (2)
    assert np.asarray(out).shape == (12, 12)


def test_tensor_color_recon_requires_joint_dict():
    import pytest
    from onmf_ontf_ndl_tpu.apps.image_tensor import ImageReconstructorTensor

    rec = ImageReconstructorTensor(
        data=np.random.default_rng(2).random((16, 16, 3)).astype(np.float32),
        n_components=4, iterations=1, sub_iterations=2, num_patches=8,
        batch_size=4, patch_size=3)
    with pytest.raises(ValueError, match="joint"):
        rec.reconstruct_image_color(data=np.zeros((16, 16, 3)))
