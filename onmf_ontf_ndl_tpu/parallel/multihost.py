"""Multi-host (multi-process) entry point.

The reference is single-process NumPy (SURVEY.md §2: no communication
backend of any kind); this framework's multi-host story is the JAX
runtime itself: ``jax.distributed.initialize`` brings every process's
local devices into one global device set, and the existing data-parallel
layer (``parallel/dp.py`` shard_map + psum, ``parallel/auto.py`` GSPMD)
runs unchanged over a mesh built from ``jax.devices()`` — the psum'd
sufficient statistics ride NVLink within a host and the network across
hosts, with XLA (NCCL) choosing the collective implementation.

Typical multi-host launch (same command on every host)::

    from onmf_ontf_ndl_tpu.parallel import multihost
    multihost.initialize()                  # cluster autodetection
    mesh = multihost.global_mesh()          # dp over ALL devices
    ... dp_train_dict(mesh, state, X_local_shard, ...)

or explicitly, e.g. under a generic scheduler::

    multihost.initialize(coordinator_address="host0:8476",
                         num_processes=4, process_id=rank)

Every process must call :func:`initialize` before any other JAX API
touches the backend. The degenerate single-process mode
(``num_processes=1``) starts and connects to a local coordinator — the
same code path, testable without a cluster.
"""

from __future__ import annotations

import jax

__all__ = ["initialize", "shutdown", "global_mesh", "is_initialized",
           "process_count", "process_index", "local_device_count"]

_initialized = False


def _runtime_initialized() -> bool:
    """Whether the jax.distributed runtime is live — consults the actual
    global state, so initialization done OUTSIDE this wrapper (a
    launcher, another library) is recognized."""
    try:
        from jax._src.distributed import global_state

        return global_state.client is not None
    except Exception:
        return _initialized


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Join (or start) the distributed JAX runtime.

    With no arguments, defers to JAX's cluster autodetection (SLURM,
    ...); elsewhere pass the coordinator address, process count and id. Explicit arguments follow
    ``jax.distributed.initialize``; the process with ``process_id == 0``
    hosts the coordinator service at ``coordinator_address``.

    Idempotent within a process (a second call is a no-op, matching the
    runtime's single-initialization requirement).
    """
    global _initialized
    if _initialized or _runtime_initialized():
        _initialized = True
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True


def shutdown() -> None:
    """Leave the distributed runtime (for clean teardown in tests)."""
    global _initialized
    if _initialized:
        jax.distributed.shutdown()
        _initialized = False


def is_initialized() -> bool:
    return _initialized or _runtime_initialized()


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def local_device_count() -> int:
    return jax.local_device_count()


def global_mesh(axes: dict[str, int] | None = None):
    """Mesh over the GLOBAL device set (all processes' chips).

    Default is 1-D data parallelism over every chip in the job:
    ``{"dp": jax.device_count()}``. For 2-D layouts pass explicit sizes,
    e.g. ``{"dp": jax.process_count(), "tp": jax.local_device_count()}``
    — dp across hosts (DCN), tp within a host (ICI), the ordering
    ``jax.devices()`` returns.
    """
    from onmf_ontf_ndl_tpu.parallel.mesh import make_mesh

    return make_mesh(axes, jax.devices())
