"""Multi-process launcher for the ``torch.distributed`` backend (counterpart
of ``jstsp19_tpu/parallel/launch.py``).

Starts N workers of ``python <args>`` on this host, hands each its rank and
the rendezvous address through the ``JSTSP19_DIST_*`` env protocol
(``parallel/distributed.py``) and waits for them against one deadline for
all.  It fails fast: the first worker to exit non-zero stops the others, and
the launcher raises with that worker's output.  The reference launcher
waited on each worker in turn with a fresh timeout and reported a dead
worker only after the others ended.

CLI (everything after ``--`` goes to each worker's ``python``)::

    python -m jstsp19_torch.parallel.launch -n 2 -- \\
        -m jstsp19_torch.parallel.distributed --methods ls --cpu --out out.json
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from jstsp19_torch.parallel.distributed import ENV_COORD, ENV_NPROC, ENV_PID

TAIL_CHARS = 4000  # of a failed worker's output, in the error
# the directory that holds this checkout's jstsp19_torch, so that the workers
# import it from wherever they start
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _output(spool) -> str:
    spool.flush()
    spool.seek(0)
    return spool.read()


def launch(
    num_processes: int,
    python_args: Sequence[str],
    env_extra: Optional[Dict[str, str]] = None,
    timeout: Optional[float] = 600,
    cwd: Optional[str] = None,
) -> List[subprocess.CompletedProcess]:
    """Run ``num_processes`` workers of ``python <python_args...>`` and wait
    for all of them; returns their ``CompletedProcess`` (output in
    ``stdout``) in rank order.

    Raises ``RuntimeError`` as soon as one worker exits non-zero (the others
    are killed first), and ``TimeoutError`` when ``timeout`` seconds pass
    from the start before all have ended (all are killed); either names the
    workers and ends with their output.  ``env_extra`` adds to each worker's
    environment; the collectives bind to the loopback interface unless the
    caller's environment names another, and the workers import this
    checkout's package.
    """
    port = free_port()
    env_base = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
                    NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"),
                    PYTHONPATH=os.pathsep.join(filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    env_base.update(env_extra or {})
    deadline = None if timeout is None else time.monotonic() + timeout
    procs, spools = [], []
    try:
        for rank in range(num_processes):
            env = dict(env_base, **{ENV_COORD: f"127.0.0.1:{port}", ENV_NPROC: str(num_processes),
                                    ENV_PID: str(rank)})
            # a file, not a pipe: a worker that fills a pipe nobody reads
            # blocks inside a collective and stalls every other rank
            spools.append(tempfile.TemporaryFile(mode="w+", encoding="utf-8"))
            procs.append(subprocess.Popen([sys.executable, *python_args], env=env, cwd=cwd, stdout=spools[-1],
                                          stderr=subprocess.STDOUT, text=True))
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None:
                _stop(procs)
                raise RuntimeError(
                    f"worker {failed} of {num_processes} exited {codes[failed]}; the others were stopped\n"
                    f"--- worker {failed} ---\n{_output(spools[failed])[-TAIL_CHARS:]}")
            if all(c == 0 for c in codes):
                return [subprocess.CompletedProcess(p.args, 0, _output(s), None) for p, s in zip(procs, spools)]
            if deadline is not None and time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                _stop(procs)
                tails = "\n".join(f"--- worker {r} ---\n{_output(spools[r])[-TAIL_CHARS:]}" for r in running)
                raise TimeoutError(f"workers {running} of {num_processes} still ran at the {timeout} s deadline; "
                                   f"all were stopped\n{tails}")
            time.sleep(0.05)
    finally:
        _stop(procs)
        for s in spools:
            s.close()


def _stop(procs) -> None:
    """Kill every worker still running and reap them all."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def main(argv=None) -> int:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    argv, worker_args = argv[:split], argv[split + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600, help="one deadline for all workers, in seconds")
    args = ap.parse_args(argv)
    if not worker_args:
        ap.error("no worker command; pass it after `--`")
    for i, r in enumerate(launch(args.num_processes, worker_args, timeout=args.timeout)):
        sys.stdout.write(f"===== worker {i} =====\n{r.stdout}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
