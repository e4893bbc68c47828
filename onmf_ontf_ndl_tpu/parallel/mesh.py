"""Device-mesh helpers."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh over the available devices.

    ``axes`` maps axis names to sizes, laid out row-major over the device
    list (the cards of one host reach each other all to all at one rate,
    so no order is better than another); default is a 1-D
    ``{"dp": <all devices>}`` mesh.
    """
    if devices is None:
        devices = jax.devices()
    if axes is None:
        axes = {"dp": len(devices)}
    sizes = tuple(axes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(
            f"mesh axes {axes} need {np.prod(sizes)} devices, "
            f"have {len(devices)}")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, tuple(axes.keys()))
