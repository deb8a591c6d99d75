"""Launch a collective (data-parallel) training job: one worker process a
rank on this node.

Counterpart of the collective half of ``paddle_tpu/distributed/launch.py``
(the reference's ``distributed/launch.py``): ``--nproc_per_node`` workers,
each started with the PADDLE_* env contract (``get_cluster_env``:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``FLAGS_selected_gpus``), which ``dygraph.parallel.prepare_context`` turns
into ``torch.distributed.init_process_group`` over the first endpoint.
The launcher supervises them: a worker that exits nonzero is relaunched
up to ``--max_restarts`` times (default 0: the other ranks of a collective
job wait in a collective for the dead one, so a failure brings the job
down), then every worker is stopped and the launcher exits with the
failed rank's code. The parameter-server, serving and steering roles of
the JAX launcher are not ported.

Usage:  python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
            [--started_port=6170] [--log_dir=DIR] train.py --your-args
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch", "get_cluster_env"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this node")
    p.add_argument("--ips", default="127.0.0.1",
                   help="comma-separated node IPs (this node included)")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--max_restarts", type=int,
                   default=int(os.environ.get(
                       "PADDLE_LAUNCH_MAX_RESTARTS", "0")),
                   help="relaunches per rank after an abnormal exit "
                        "before the job is brought down")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_cluster_env(node_ips, node_rank, nproc_per_node, started_port,
                    local_rank):
    """The PADDLE_* env contract for one worker."""
    nranks = len(node_ips) * nproc_per_node
    rank = node_rank * nproc_per_node + local_rank
    endpoints = ["%s:%d" % (ip, started_port + i)
                 for ip in node_ips for i in range(nproc_per_node)]
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nranks),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "FLAGS_selected_gpus": str(local_rank),
    }


def _log(msg: str) -> None:
    print("[launch] %s" % msg, file=sys.stderr, flush=True)


class _Worker:
    """One supervised rank: its command, env, restarts and log."""

    def __init__(self, local_rank: int, cmd, env, log_dir):
        self.local_rank = local_rank
        self.cmd = list(cmd)
        self.env = dict(env)
        self.log_dir = log_dir
        self.restarts = 0
        self.proc: subprocess.Popen = None
        self._fp = None

    def spawn(self) -> None:
        env = dict(self.env)
        env["PADDLE_RESTART_COUNT"] = str(self.restarts)
        self.close_log()
        out = None
        if self.log_dir:
            self._fp = open(os.path.join(
                self.log_dir, "workerlog.%d" % self.local_rank), "a")
            out = self._fp
        self.proc = subprocess.Popen(self.cmd, env=env, stdout=out,
                                     stderr=out)

    def close_log(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def launch(args=None) -> int:
    args = args if args is not None else _parse_args()
    node_ips = [ip for ip in args.ips.split(",") if ip]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    cmd = [sys.executable, "-u", args.training_script] + \
        list(args.training_script_args)
    workers = []
    for local_rank in range(args.nproc_per_node):
        env = dict(os.environ)
        env.update(get_cluster_env(node_ips, args.node_rank,
                                   args.nproc_per_node, args.started_port,
                                   local_rank))
        workers.append(_Worker(local_rank, cmd, env, args.log_dir))

    def _terminate_all(sig=signal.SIGTERM):
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.send_signal(sig)
                except OSError:
                    pass
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()

    live = set(range(args.nproc_per_node))
    rc = 0
    try:
        for w in workers:
            w.spawn()
        while live:
            time.sleep(0.1)
            for w in workers:
                if w.local_rank not in live:
                    continue
                code = w.proc.poll()
                if code is None:
                    continue
                if code == 0:
                    live.discard(w.local_rank)
                    continue
                if w.restarts >= args.max_restarts:
                    _log("rank %d exited %d; restart budget (%d) spent: "
                         "bringing the job down"
                         % (w.local_rank, code, args.max_restarts))
                    rc = code if code > 0 else 1
                    _terminate_all()
                    live = set()
                    break
                w.restarts += 1
                _log("rank %d exited %d; relaunching (restart %d/%d)"
                     % (w.local_rank, code, w.restarts, args.max_restarts))
                w.spawn()
        return rc
    except KeyboardInterrupt:
        _terminate_all()
        return 1
    finally:
        for w in workers:
            w.close_log()


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
