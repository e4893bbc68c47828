"""GPU kernels (Pallas, Triton route) and the choice of backend."""

import jax

from onmf_ontf_ndl_tpu.ops.pallas.coder_kernel import (
    coder_kernel_fits,
    coder_sweeps,
    dict_kernel_fits,
    dict_update_sweep,
)

__all__ = [
    "BACKENDS", "coder_kernel_fits", "coder_sweeps", "dict_kernel_fits",
    "dict_update_sweep", "resolve_backend",
]

# Platforms the kernels compile for.
_KERNEL_PLATFORMS = ("gpu",)

# "pallas_interpret" runs the same kernels under the Pallas interpreter,
# on any platform: it is how the tests drive them on the CPU.
BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")


def _platform() -> str:
    """Platform that uncommitted work runs on: the ``jax.default_device``
    in force, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    if isinstance(dev, str):
        return "gpu" if dev in ("cuda", "rocm") else dev
    return dev.platform


def resolve_backend(backend: str) -> str:
    """Resolve a ``backend=`` option to "xla", "pallas" or
    "pallas_interpret".

    "auto" takes the kernels on a GPU and the XLA loops elsewhere (the
    platform is that of the ``jax.default_device`` in force, if any). An
    explicit "pallas" on a platform the kernels do not compile for
    raises.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    platform = _platform()
    if backend == "auto":
        return "pallas" if platform in _KERNEL_PLATFORMS else "xla"
    if backend == "pallas" and platform not in _KERNEL_PLATFORMS:
        raise ValueError(
            f"backend='pallas' needs a GPU; this process runs on "
            f"{platform!r} (use 'auto', 'xla' or, for tests, "
            f"'pallas_interpret')")
    return backend
