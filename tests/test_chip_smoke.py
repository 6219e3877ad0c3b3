"""chip_smoke.py: refuses to run without a GPU, and its phases pass at
tiny sizes on the CPU with the device paths forced onto the CPU backend."""

import os
import os.path as op
import shutil
import subprocess
import sys

ROOT = op.dirname(op.dirname(op.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero and prints no result on the CPU."""
    r = subprocess.run([sys.executable, op.join(ROOT, "chip_smoke.py")],
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository fails, no result."""
    shutil.copy(op.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                PYTHONPATH=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_rehearsal(tmp_path):
    """Every phase of the one-card run at tiny sizes: device outputs
    (forced onto the CPU backend) byte-identical to the host paths."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one device, as on a one-card machine
    r = subprocess.run(
        [sys.executable, op.join(ROOT, "chip_smoke.py"), "--rehearse",
         "--workdir", str(tmp_path / "w")],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert r.stdout.count("PASS ") >= 12
    assert "rehearsal ok" in r.stdout and '"ok"' not in r.stdout


def test_chip_smoke_rehearsal_four_cards(tmp_path):
    """The four-card phase on four virtual CPU devices: `pat2beta
    --sharded`, plain pat2beta, `pat2beta --procs 4` and `segment --procs
    4` all byte-identical."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, op.join(ROOT, "chip_smoke.py"), "--rehearse",
         "--cards", "4", "--workdir", str(tmp_path / "w")],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert r.stdout.count("PASS phase 5") == 4
    assert "rehearsal ok" in r.stdout and '"ok"' not in r.stdout
