"""The one device decision (wgbs_tools_tpu/device.py) and the paths that
follow it, on a mocked "gpu"/"cpu" platform: with a GPU the device paths
are chosen and a device failure raises instead of falling back."""

import os

import jax
import numpy as np
import pytest

from tests.synth import random_frags
from wgbs_tools_tpu import device


@pytest.fixture(params=["gpu", "cpu"])
def plat(request, monkeypatch):
    monkeypatch.setattr(device, "platform", lambda: request.param)
    for k in ("WGBS_TPU_PILEUP", "WGBS_TPU_DEVICE_CALLING",
              "WGBS_TPU_SEGMENT_EXACT_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    return request.param


def test_has_gpu(plat):
    assert device.has_gpu() is (plat == "gpu")


def test_pileup_accumulator_choice(plat):
    from wgbs_tools_tpu.native import get_lib
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator

    acc = PileupAccumulator((1, 1001))
    if plat == "gpu":
        assert acc.backend == "xla" and acc.device_total
    else:
        assert acc.backend == ("native" if get_lib() else "xla")
        assert not acc.device_total and isinstance(acc.total, np.ndarray)


def test_exact_segment_device_choice(plat, monkeypatch):
    from wgbs_tools_tpu.models.segment import _use_exact_device

    assert _use_exact_device() is False  # host C++ by default, GPU or not
    monkeypatch.setenv("WGBS_TPU_SEGMENT_EXACT_DEVICE", "0")
    assert _use_exact_device() is False
    monkeypatch.setenv("WGBS_TPU_SEGMENT_EXACT_DEVICE", "1")
    assert _use_exact_device() is True


def test_sharded_pileup_choice(plat, monkeypatch, tmp_path):
    """pat2beta on several devices: one device's accumulator unless
    sharding is asked for, then the clipped per-device scatter on every
    platform."""
    from wgbs_tools_tpu.formats.pat import write_pat
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator
    from wgbs_tools_tpu.parallel import sharded
    from wgbs_tools_tpu.pipeline.pat2beta import _accumulate_pat

    assert len(jax.devices()) > 1
    frags = random_frags(np.random.default_rng(3), 300, 4000, max_len=8)
    pat = str(tmp_path / "s.pat.gz")
    write_pat(frags, pat)
    acc, nf = _accumulate_pat(pat, 4096)
    assert type(acc) is PileupAccumulator and nf == frags.nr_frags
    acc, nf = _accumulate_pat(pat, 4096, sharded=True)
    assert type(acc) is sharded.ShardedPileup and nf == frags.nr_frags
    assert acc.n_shards == len(jax.devices())


def _boom(*a, **k):
    raise RuntimeError("device step failed")


def test_gpu_pileup_failure_raises(monkeypatch):
    """A failing device pileup raises; it does not fall back to native."""
    from wgbs_tools_tpu.ops import pileup

    monkeypatch.setattr(device, "platform", lambda: "gpu")
    monkeypatch.delenv("WGBS_TPU_PILEUP", raising=False)
    monkeypatch.setattr(pileup, "_pileup_batch_xla", _boom)
    acc = pileup.PileupAccumulator((1, 2001))
    with pytest.raises(RuntimeError, match="device step failed"):
        acc.add(random_frags(np.random.default_rng(4), 50, 1900, max_len=6))
    assert acc.backend == "xla"


def test_gpu_exact_segment_failure_raises(monkeypatch, tmp_path):
    from wgbs_tools_tpu.formats.beta import save_beta
    from wgbs_tools_tpu.models import segment, segment_exact_tpu
    from wgbs_tools_tpu.models.segment import SegmentConfig, segment_ranges

    monkeypatch.setattr(device, "platform", lambda: "gpu")
    monkeypatch.setenv("WGBS_TPU_SEGMENT_EXACT_DEVICE", "1")
    monkeypatch.setattr(segment, "DEVICE_EXACT_MIN_SITES", 2)
    monkeypatch.setattr(segment_exact_tpu, "segment_exact_device_batch",
                        _boom)
    rng = np.random.default_rng(5)
    cov = rng.integers(0, 9, size=600)
    p = str(tmp_path / "a.beta")
    save_beta(p, np.stack([rng.binomial(cov, 0.5), cov], axis=1))

    class _Idx:
        loci = np.cumsum(rng.integers(2, 60, size=601))

    cfg = SegmentConfig(max_cpg=32, chunk_size=300, threads=1)
    with pytest.raises(RuntimeError, match="device step failed"):
        segment_ranges([p], [(1, 601)], _Idx(), cfg)


def test_gpu_calling_failure_raises(monkeypatch, mini_genome):
    from tests.bisim import dump_bam, simulate_reads
    from wgbs_tools_tpu.genome.cpg_index import read_fasta
    from wgbs_tools_tpu.ops import calling_tpu
    from wgbs_tools_tpu.pipeline.bam2pat_run import bam2pat

    monkeypatch.setattr(device, "platform", lambda: "gpu")
    monkeypatch.delenv("WGBS_TPU_DEVICE_CALLING", raising=False)
    monkeypatch.setattr(calling_tpu, "call_reads_device", _boom)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, np.random.default_rng(6), n_reads=60,
                              paired=False)
    bam = dump_bam(reads, seqs, os.path.join(
        os.path.dirname(mini_genome.refdir), "fail.bam"))
    with pytest.raises(RuntimeError, match="device step failed"):
        bam2pat(bam, genome=mini_genome, write_output=False, stream=False)


def test_require_gpu_exits_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(device.jax, "devices",
                        lambda: [type("D", (), {"platform": "cpu"})()])
    with pytest.raises(SystemExit) as e:
        device.require_gpu("bench")
    assert e.value.code == 1
    assert "no GPU" in capsys.readouterr().err


def test_card_lines_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert device.card_lines() == []
