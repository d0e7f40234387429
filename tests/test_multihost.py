"""Multi-host scale-out: a REAL 2-process jax.distributed CPU cluster.

Two fresh processes each own 4 virtual CPU devices, join a coordinator,
build the 8-device global mesh, feed ONLY their own frame shard
(per-host input pipeline), and run the fused register+stack. Every
process must produce exactly the single-process result (SURVEY §5.8).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "siril-0.9")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster_matches_single_process(tmp_path):
    # the workers find mh_input.ser in the outdir and switch to the
    # DISK-fed per-host pipeline: each process reads only its own frame
    # shard from the shared SER file
    sys.path.insert(0, _PKG)
    from siriltpu.parallel._mh_worker import write_test_ser
    write_test_ser(str(tmp_path / "mh_input.ser"))

    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["PYTHONPATH"] = _PKG + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "siriltpu.parallel._mh_worker",
             str(port), str(pid), "2", "4", str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker hung")
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"mh_worker {pid}/2: OK" in out

    from siriltpu.parallel._mh_worker import singlehost_expected
    want = singlehost_expected()
    got0 = np.load(tmp_path / "out_0.npy")
    got1 = np.load(tmp_path / "out_1.npy")
    np.testing.assert_array_equal(got0, got1)
    np.testing.assert_array_equal(got0, want)


def test_local_frame_indices_partition():
    # every frame is owned by exactly the right process-local devices
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from siriltpu.parallel.mesh import make_mesh
    from siriltpu.parallel.multihost import local_frame_indices

    mesh = make_mesh(("frames",))
    sharding = NamedSharding(mesh, P("frames", None, None))
    n = len(jax.devices())
    idx = local_frame_indices(sharding, (4 * n, 32, 32))
    # single process: addressable = all devices = all frames
    assert idx == list(range(4 * n))
