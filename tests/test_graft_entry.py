"""Tests for __graft_entry__'s multi-device dry run.

``dryrun_multichip(n, cpu=True)`` runs on n virtual CPU devices even from
an interpreter that has one device; without ``cpu=True`` it runs on the
process's own devices and raises when there are too few.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_raises_on_too_few_devices():
    import jax

    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="need"):
        g.dryrun_multichip(len(jax.devices()) + 1)


@pytest.mark.slow
def test_dryrun_multichip_cpu_from_one_device():
    env = dict(os.environ)
    # mimic the driver: no virtual-device flags, single-device backend
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');"
         "assert len(jax.devices()) == 1, jax.devices();"
         "import __graft_entry__ as g; g.dryrun_multichip(8, cpu=True)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
