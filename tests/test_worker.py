"""Persistent worker mode (cli/worker.py): a long-lived process serves CLI
invocations over a unix socket, so per-process start-up and device
initialization are paid once."""

import os
import os.path as op
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = op.dirname(op.dirname(op.abspath(__file__)))


@pytest.fixture()
def worker(tmp_path, mini_genome):
    sock = str(tmp_path / "w.sock")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               WGBS_TPU_WORKER_SOCKET=sock)
    p = subprocess.Popen(
        [sys.executable, "-m", "wgbs_tools_tpu", "worker", "serve"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for _ in range(100):
        if op.exists(sock):
            break
        if p.poll() is not None:
            raise RuntimeError(p.communicate()[0].decode()[-2000:])
        time.sleep(0.1)
    else:
        p.kill()
        raise RuntimeError("worker socket never appeared")
    yield sock, env
    subprocess.run([sys.executable, "-m", "wgbs_tools_tpu", "worker", "stop"],
                   env=env, timeout=30)
    p.wait(timeout=30)


def test_worker_runs_commands_and_streams_output(worker, tmp_path):
    sock, env = worker
    from tests.synth import random_frags
    from wgbs_tools_tpu.formats.pat import write_pat

    frags = random_frags(np.random.default_rng(5), 500, 4000,
                         max_len=10).sort().collapse()
    pat = str(tmp_path / "w.pat.gz")
    write_pat(frags, pat)

    def run(args):
        return subprocess.run(
            [sys.executable, "-m", "wgbs_tools_tpu", "worker", "run"] + args,
            env=env, capture_output=True, timeout=120)

    # same worker process serves consecutive invocations; output streams
    # back byte-for-byte (beta written by the worker in the client's cwd)
    r1 = run(["beta_cov", "--help"])
    assert r1.returncode == 0 and b"beta_cov" in r1.stdout
    r2 = run(["frag_len", pat, "-v"])
    assert r2.returncode == 0, r2.stderr[-1500:]
    direct = subprocess.run(
        [sys.executable, "-m", "wgbs_tools_tpu", "frag_len", pat, "-v"],
        env=dict(env, WGBS_TPU_WORKER=""), capture_output=True, timeout=120)
    assert r2.stdout == direct.stdout

    # bad command: nonzero rc, error text relayed on stderr/stdout
    r3 = run(["frag_len", "/nonexistent.pat.gz"])
    assert r3.returncode != 0

    # transparent routing via WGBS_TPU_WORKER=1
    r4 = subprocess.run(
        [sys.executable, "-m", "wgbs_tools_tpu", "frag_len", pat, "-v"],
        env=dict(env, WGBS_TPU_WORKER="1"), capture_output=True, timeout=120)
    assert r4.returncode == 0 and r4.stdout == direct.stdout


def test_worker_run_without_server():
    r = subprocess.run(
        [sys.executable, "-m", "wgbs_tools_tpu", "worker", "run", "view",
         "--help"],
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                 WGBS_TPU_WORKER_SOCKET="/tmp/definitely_missing.sock"),
        capture_output=True, timeout=60)
    assert r.returncode == 1
    assert b"no worker running" in r.stderr


def test_stale_socket_runs_in_process(tmp_path):
    """A socket file nobody listens on: no worker, so in-process is safe."""
    import socket

    from wgbs_tools_tpu.cli.worker import run_via_worker

    path = str(tmp_path / "stale.sock")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.close()
    assert run_via_worker(["view", "--help"], path=path) is None


def test_unreachable_worker_refuses(tmp_path, monkeypatch, capsys):
    """A worker that exists but cannot take the connection: refuse (rc 1)
    rather than open the card it holds in this process."""
    import socket

    from wgbs_tools_tpu.cli.worker import run_via_worker

    def busy(self, addr):
        raise BlockingIOError(11, "Resource temporarily unavailable")

    monkeypatch.setattr(socket.socket, "connect", busy)
    assert run_via_worker(["view", "--help"],
                          path=str(tmp_path / "w.sock")) == 1
    assert "holds the device" in capsys.readouterr().err
