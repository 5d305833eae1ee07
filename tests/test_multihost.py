"""Genuine multi-process SPMD: two spawned processes, one shared (2, 4) mesh.

Exercises explicit-args ``runtime.initialize`` (coordinator/num_processes/
process_id — the wiring every process of a GPU cluster passes), cross-process
``host_local_to_global`` ingest, and sharded descriptor programs whose halo
ppermutes and global-stat pmeans cross the process boundary (Gloo transport
on CPU; NCCL between GPUs).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_spmd():
    worker = Path(__file__).with_name("multihost_worker.py")
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        str(Path(__file__).resolve().parents[1])
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    # the workers set their own XLA_FLAGS / platform
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(rank), coordinator],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {rank} failed:\n{out[-3000:]}"
        assert f"proc {rank} OK" in out
