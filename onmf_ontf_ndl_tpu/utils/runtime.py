"""Run-time setup shared by the CLI, the benchmark and the chip smoke test:
the persistent compile cache, the matmul-precision policy, the device
check and the table of published device peaks."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["PEAKS", "compile_cache_dir", "describe_precision",
           "enable_compile_cache", "peaks_for", "require_gpu"]

# The checkout that holds this package.
_CHECKOUT = Path(__file__).resolve().parents[2]

# Published dense peaks, keyed by ``jax.devices()[0].device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part (dense rates,
# no sparsity), at its full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM5, dense",
    },
}


def peaks_for(device_kind: str) -> dict:
    """The published peaks of ``device_kind``. A device not in
    :data:`PEAKS` is an error, not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add them "
            f"to onmf_ontf_ndl_tpu.utils.runtime.PEAKS with their source"
        ) from None


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when it is set, else the fixed
    ``<checkout>/.jax_cache`` (a fixed path, so later runs hit it)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_CHECKOUT / ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    and return the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def describe_precision() -> str:
    """The matmul-precision policy of the timed path, for logs: f32
    products run at JAX's configured default, which on an H100 lets XLA
    use TF32 tensor cores (about three decimal digits in each product).
    The bcd coder and dictionary kernels multiply on CUDA cores in f32.
    Plain references run under ``jax.default_matmul_precision("highest")``.
    """
    cur = jax.config.jax_default_matmul_precision or "default"
    return (f"timed path: jax_default_matmul_precision={cur} (XLA may run "
            f"f32 products as TF32 on this card; the sweep kernels are "
            f"f32 on CUDA cores); references: highest")


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: a measurement that finds no
    GPU fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r} "
                         f"({dev.device_kind})")
    return dev
