"""Online nonnegative matrix/tensor factorization & network dictionary learning in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
HanbaekLyu/ONMF_ONTF_NDL (online NMF/NTF for Markovian data + image /
network / Ising-trajectory dictionary-learning applications).

Layers (mirrors the reference's implicit 4-layer structure, see SURVEY.md §1):

- ``ops``      — factorization numerics: nonnegative sparse coder, BCD
                 dictionary update, tensor unfolding, patch ops, Pallas kernels.
- ``models``   — the online factorization cores: ``OnmfState`` pytree,
                 ``onmf_step`` / ``train_dict`` (lax.scan), ONTF via matricization.
- ``samplers`` — on-device stochastic data generators: Ising Metropolis /
                 checkerboard-Gibbs, MCMC motif (Glauber / Pivot) chains.
- ``apps``     — reconstructors: image (gray/color), color tensor, network
                 dictionary learning, Ising trajectory, streaming video.
- ``parallel`` — device-mesh data parallelism (shard_map + psum of the
                 streaming sufficient statistics).
- ``utils``    — checkpointing, metrics, configs, visualization.
"""

from onmf_ontf_ndl_tpu.models.state import OnmfState, init_state
from onmf_ontf_ndl_tpu.models.onmf import OnlineNMF, onmf_step, train_dict
from onmf_ontf_ndl_tpu.models.ontf import OnlineNTF
from onmf_ontf_ndl_tpu.ops.coder import nonneg_code, nonneg_code_gram

__version__ = "0.1.0"

__all__ = [
    "OnmfState",
    "init_state",
    "OnlineNMF",
    "OnlineNTF",
    "onmf_step",
    "train_dict",
    "nonneg_code",
    "nonneg_code_gram",
    "ImageReconstructor",
    "ImageReconstructorTensor",
    "IsingReconstructor",
    "NetworkReconstructor",
    "VideoDictionaryLearner",
]


def __getattr__(name):
    # lazy app exports (they pull in matplotlib/PIL only when used)
    apps = {
        "ImageReconstructor": "onmf_ontf_ndl_tpu.apps.image",
        "ImageReconstructorTensor": "onmf_ontf_ndl_tpu.apps.image_tensor",
        "IsingReconstructor": "onmf_ontf_ndl_tpu.apps.ising",
        "NetworkReconstructor": "onmf_ontf_ndl_tpu.apps.network",
        "VideoDictionaryLearner": "onmf_ontf_ndl_tpu.apps.video",
    }
    if name in apps:
        import importlib

        return getattr(importlib.import_module(apps[name]), name)
    raise AttributeError(name)
