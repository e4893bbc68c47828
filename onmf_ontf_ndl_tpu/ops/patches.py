"""Device-resident patch extraction and overlap-averaged reconstruction.

The reference extracts random patches one by one with ``np.append``
(``/root/reference/image_reconstruction.py:173-206``) and paints
reconstructions with a per-pixel Python running average
(``/root/reference/image_reconstruction.py:389-392``). Here both are
single XLA ops: a batched gather for extraction and a scatter-add
(values + counts, then divide) for reconstruction. The running average
``(c*acc + v)/(c+1)`` over the patches covering a pixel equals the plain
mean of those values, so the scatter-add form is mathematically identical
(up to float association) while being order-independent and parallel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "random_patch_corners",
    "grid_patch_corners",
    "all_patch_corners",
    "extract_patches",
    "extract_patches_grid",
    "overlap_average",
    "overlap_average_grid",
]


def random_patch_corners(
    key: jax.Array, img_shape: tuple[int, int], k: int, num: int
) -> tuple[jax.Array, jax.Array]:
    """Uniform top-left corners for ``num`` random k x k patches.

    Matches the reference's ``np.random.choice(H - k)`` support
    {0, ..., H-k-1} (``/root/reference/image_reconstruction.py:185-186``).
    """
    if img_shape[0] <= k or img_shape[1] <= k:
        # the reference's np.random.choice(H - k) raises for H <= k;
        # jax.random.randint with maxval <= 0 would silently return 0s
        # and train on clamped-gather garbage
        raise ValueError(
            f"image {tuple(img_shape[:2])} too small for {k}x{k} patches "
            f"(needs both dims > patch_size)")
    ka, kb = jax.random.split(key)
    a = jax.random.randint(ka, (num,), 0, img_shape[0] - k)
    b = jax.random.randint(kb, (num,), 0, img_shape[1] - k)
    return a, b


def grid_patch_corners(
    img_shape: tuple[int, int], k: int, stride: int
) -> tuple[jax.Array, jax.Array]:
    """Strided-grid corners, exclusive of the last row/col start, matching
    ``np.arange(0, H - k, stride)``
    (``/root/reference/image_reconstruction.py:375-376``)."""
    ii = jnp.arange(0, img_shape[0] - k, stride)
    jj = jnp.arange(0, img_shape[1] - k, stride)
    a = jnp.repeat(ii, jj.shape[0])
    b = jnp.tile(jj, ii.shape[0])
    return a, b


def all_patch_corners(img_shape: tuple[int, int], k: int) -> tuple[jax.Array, jax.Array]:
    """Every patch position (inclusive of H-k), row-major — the
    ``extract_patches_2d`` full-coverage order used by the grayscale
    reconstruction path (``/root/reference/image_reconstruction.py:163``)."""
    ii = jnp.arange(0, img_shape[0] - k + 1)
    jj = jnp.arange(0, img_shape[1] - k + 1)
    a = jnp.repeat(ii, jj.shape[0])
    b = jnp.tile(jj, ii.shape[0])
    return a, b


def extract_patches(
    img: jax.Array, corners: tuple[jax.Array, jax.Array], k: int
) -> jax.Array:
    """Gather k x k patches at the given corners into a data matrix.

    Args:
      img: (H, W) grayscale or (H, W, C) color image.
      corners: (a, b) arrays of n top-left coordinates.
      k: patch side.

    Returns:
      (d, n) matrix, d = k*k*C (or k*k), each column a patch flattened
      row-major in (row, col[, channel]) order — the reference's
      ``patch.reshape(-1, 1)`` convention
      (``/root/reference/image_reconstruction.py:187-188``).
    """
    a, b = corners
    di = jnp.arange(k)
    rows = a[:, None, None] + di[None, :, None]   # (n, k, 1)
    cols = b[:, None, None] + di[None, None, :]   # (n, 1, k)
    patches = img[rows, cols]                     # (n, k, k[, C])
    return patches.reshape(a.shape[0], -1).T


def overlap_average(
    patch_values: jax.Array,
    corners: tuple[jax.Array, jax.Array],
    k: int,
    out_shape: tuple[int, ...],
) -> jax.Array:
    """Overlap-averaged reconstruction canvas from per-patch values.

    Args:
      patch_values: (d, n) reconstructed patch columns (same flattening as
        :func:`extract_patches`).
      corners: (a, b) corner arrays of length n.
      k: patch side.
      out_shape: (H, W) or (H, W, C) canvas shape.

    Returns:
      Canvas where every painted pixel is the mean of all patch values
      covering it; unpainted pixels are 0 (the reference's zero-initialized
      canvas, ``/root/reference/image_reconstruction.py:367``).
    """
    a, b = corners
    n = a.shape[0]
    channels = out_shape[2] if len(out_shape) == 3 else 1
    vals = patch_values.T.reshape(n, k, k, channels)
    di = jnp.arange(k)
    rows = a[:, None, None] + di[None, :, None]
    cols = b[:, None, None] + di[None, None, :]
    acc = jnp.zeros((out_shape[0], out_shape[1], channels), patch_values.dtype)
    acc = acc.at[rows, cols].add(vals)
    cnt = jnp.zeros((out_shape[0], out_shape[1]), patch_values.dtype)
    cnt = cnt.at[rows, cols].add(1.0)
    out = acc / jnp.maximum(cnt, 1.0)[..., None]
    return out.reshape(out_shape)


def _grid_counts(img_shape, k: int, stride: int, inclusive: bool):
    """Number of grid starts per axis: ``arange(0, H-k, s)`` (exclusive,
    the reference's strided recon grid) or every position (inclusive)."""
    def count(m):
        if inclusive:
            return m - k + 1
        return max(0, -(-(m - k) // stride))
    return count(img_shape[0]), count(img_shape[1])


def extract_patches_grid(img: jax.Array, k: int, stride: int = 1,
                         *, inclusive: bool = False) -> jax.Array:
    """Gather-free regular-grid patch extraction via
    ``conv_general_dilated_patches`` (XLA lowers it as a convolution —
    far cheaper to compile and run than a big gather).

    Equivalent to ``extract_patches(img, grid_patch_corners(...), k)``
    (or ``all_patch_corners`` when ``inclusive=True``): returns (d, n)
    with the same row-major corner order and (row, col[, channel])
    flattening.
    """
    from jax import lax

    if inclusive:
        stride = 1  # the full-coverage grid is stride-1 by definition
    squeeze = img.ndim == 2
    x = img[None, ..., None] if squeeze else img[None]
    C = x.shape[-1]
    ni, nj = _grid_counts(img.shape, k, stride, inclusive)
    patches = lax.conv_general_dilated_patches(
        x, (k, k), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )  # (1, NI, NJ, C*k*k) with feature order (C, kh, kw)
    patches = patches[0, :ni, :nj]
    # reorder features (C, kh, kw) -> (kh, kw, C) to match the
    # reshape(-1) convention of extract_patches
    patches = patches.reshape(ni, nj, C, k, k)
    patches = jnp.moveaxis(patches, 2, 4)
    return patches.reshape(ni * nj, k * k * C).T


def overlap_average_grid(patch_values: jax.Array, k: int, stride: int,
                         out_shape: tuple[int, ...],
                         *, inclusive: bool = False) -> jax.Array:
    """Scatter-free overlap average for a regular patch grid.

    For each of the k x k in-patch offsets, the patch values land on a
    disjoint strided lattice of pixels, which is expressible as
    ``lax.pad`` with interior (dilation) padding — XLA handles the k^2
    pad+add sequence orders of magnitude faster than one giant scatter.
    The overlap counts are shape-deterministic and precomputed on the
    host. Result is identical to
    ``overlap_average(vals, grid/all_patch_corners(...), ...)``.
    """
    from jax import lax
    import numpy as np

    if inclusive:
        stride = 1  # must mirror extract_patches_grid
    H, W = out_shape[0], out_shape[1]
    C = out_shape[2] if len(out_shape) == 3 else 1
    ni, nj = _grid_counts(out_shape, k, stride, inclusive)
    if patch_values.shape[1] != ni * nj:
        raise ValueError(
            f"expected {ni * nj} patches for this grid, got "
            f"{patch_values.shape[1]}")
    if ni == 0 or nj == 0:
        # empty exclusive grid (image dim == k with stride > 1): the
        # reference's empty range loop paints nothing — zero canvas
        out = jnp.zeros((H, W, C), patch_values.dtype)
        return out if len(out_shape) == 3 else out[:, :, 0]
    vals = patch_values.T.reshape(ni, nj, k, k, C)

    acc = jnp.zeros((H, W, C), patch_values.dtype)
    cnt = np.zeros((H, W), np.float64)
    for di in range(k):
        for dj in range(k):
            hi_i = H - (di + (ni - 1) * stride + 1)
            hi_j = W - (dj + (nj - 1) * stride + 1)
            pad_cfg = [(di, hi_i, stride - 1), (dj, hi_j, stride - 1),
                       (0, 0, 0)]
            acc = acc + lax.pad(vals[:, :, di, dj, :],
                                jnp.asarray(0.0, patch_values.dtype), pad_cfg)
            cnt[di:di + (ni - 1) * stride + 1:stride,
                dj:dj + (nj - 1) * stride + 1:stride] += 1.0
    cnt = jnp.asarray(np.maximum(cnt, 1.0), patch_values.dtype)
    out = acc / cnt[..., None]
    return out.reshape(out_shape)
