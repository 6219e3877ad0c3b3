"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic is
exercised without GPUs. Must set XLA flags before jax import.
"""

import os
import sys

# jax may already be imported before conftest runs, when the env vars are
# too late; the config update below still works because backends are
# initialized lazily.
os.environ["JAX_PLATFORMS"] = "cpu"
prev = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in prev:
    os.environ["XLA_FLAGS"] = (
        prev + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1729)


@pytest.fixture(scope="session")
def mini_genome(tmp_path_factory, rng):
    """A small synthetic genome: FASTA + initialized reference dir."""
    from tests.synth import make_fasta

    root = tmp_path_factory.mktemp("genome")
    os.environ["WGBS_TPU_REFDIR"] = str(root / "references")
    fasta = make_fasta(
        str(root / "mini.fa"),
        {"chr1": 50000, "chr2": 30000, "chrX": 10000},
        rng,
    )
    from wgbs_tools_tpu.genome import init_genome

    refdir = init_genome("mini", fasta, force=True, set_default=True)
    from wgbs_tools_tpu.genome import Genome

    return Genome("mini")
