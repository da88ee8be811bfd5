"""Local job launcher: N identical worker processes, one rank each.

The port's copy of the repo's ``tools/launch.py`` (``launch_local``; the
reference's ``tools/launch.py`` and dmlc tracker). Every worker runs the
same command; ``parallel.dist.initialize()`` reads the variables set here
and joins the ranks into one ``torch.distributed`` process group (NCCL on
the card, gloo when the program asks for the CPU)::

    python -m incubator_mxnet_tpu_torch.tools.launch -n 2 \\
        python -m incubator_mxnet_tpu_torch.models.bert_pretraining --dp 2

Variables set per worker (the reference's names):
  DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT  the rendezvous host:port
  DMLC_NUM_WORKER                       total workers
  DMLC_WORKER_ID                        this worker's rank
  DMLC_ROLE=worker                      (every process is a worker)
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import List, Optional


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(base: dict, uri: str, port: int, n: int, rank: int) -> dict:
    env = dict(base)
    env.update({
        "DMLC_PS_ROOT_URI": uri,
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(n),
        "DMLC_WORKER_ID": str(rank),
        "DMLC_ROLE": "worker",
    })
    return env


def launch_local(n: int, command: List[str], port: Optional[int] = None,
                 env: Optional[dict] = None,
                 timeout: Optional[float] = None) -> int:
    """Run ``n`` workers of ``command`` on this host; returns the first
    non-zero exit code (0 when every worker succeeds). With ``timeout``
    (seconds for each wait), a worker still running then is killed with
    the rest, and the code is -9."""
    port = port or _free_port()
    base = dict(os.environ if env is None else env)
    procs = [subprocess.Popen(
        command, env=worker_env(base, "127.0.0.1", port, n, rank))
        for rank in range(n)]
    rc = 0
    try:
        for p in procs:
            code = p.wait(timeout=timeout)
            if code and not rc:
                rc = code
    except subprocess.TimeoutExpired:
        rc = -9
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="total worker processes")
    ap.add_argument("-p", "--port", type=int, default=None,
                    help="rendezvous port (default: a free one)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the command every worker runs")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    command = args.command[1:] if args.command[0] == "--" else args.command
    return launch_local(args.num_workers, command, args.port)


if __name__ == "__main__":
    sys.exit(main())
