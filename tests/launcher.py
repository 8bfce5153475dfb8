"""The launcher of tests/test_torch_distributed.py, whose tests start
processes of their own: a free port, the processes' environment, and
`run_all`, which waits for every process against one deadline.

Each command runs in a session of its own. Once one exits non-zero, or
the deadline passes, every process group is killed: a dead rank fails
its test at once instead of leaving its peer waiting in a collective,
and no rank, nor a worker it forked, outlives the test.
"""

import os
import signal
import socket
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# About 3x the slowest launch of a tier-1 run on 4 cores (48.8 s, the
# port's `find_circ --nproc 2` ranks on the ~10k-read library).
DEADLINE_S = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env() -> dict:
    """This environment with the tree under test first on PYTHONPATH."""
    out = dict(os.environ)
    out["PYTHONPATH"] = ROOT + os.pathsep + out.get("PYTHONPATH", "")
    return out


def run_all(cmds, logdir):
    """Runs the commands side by side, the output of command i in
    `logdir`/i.log, for at most DEADLINE_S, and returns their exit codes
    and the logs' last 3000 characters. A process killed here has exit
    code -9."""
    deadline_s = DEADLINE_S
    os.makedirs(logdir, exist_ok=True)
    logs = [os.path.join(logdir, f"{i}.log") for i in range(len(cmds))]
    deadline = time.monotonic() + deadline_s
    procs, late = [], False
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "wb") as fh:
                procs.append(subprocess.Popen(
                    cmd, env=env(), stdout=fh, stderr=subprocess.STDOUT,
                    start_new_session=True))
        while True:
            rcs = [p.poll() for p in procs]
            if (None not in rcs or any(rcs)
                    or time.monotonic() >= deadline):
                break
            time.sleep(0.1)
        late = not any(rcs) and None in rcs
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    tails = []
    for log in logs:
        with open(log, "rb") as fh:
            tail = fh.read().decode(errors="replace")[-3000:]
        tails.append(tail + (f"\n[killed at the {deadline_s} s deadline]"
                             if late else ""))
    return [p.returncode for p in procs], tails
