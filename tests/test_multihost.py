"""2-process ``jax.distributed`` smoke test on CPU (local coordinator).

Exercises the real multi-host runtime path — ``init_distributed`` +
``make_mesh`` over a cross-process device set + ``put_global``/
``fetch_global`` + the ppermute/psum solver — without a cluster.  The subprocesses force the CPU platform with 2 virtual
devices each, so this runs anywhere the normal suite runs.
"""

import os
import socket
import subprocess
import sys

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_solve():
    here = os.path.dirname(os.path.abspath(__file__))
    runner = os.path.join(here, "multihost_runner.py")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # runner sets its own device count
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, runner, str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "MULTIHOST_OK" in out
