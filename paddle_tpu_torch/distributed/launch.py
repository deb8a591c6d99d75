"""Launch a training job: one worker process a rank on this node, and
beside them the job's parameter servers, serving replicas and a steering
daemon when asked.

Counterpart of ``paddle_tpu/distributed/launch.py`` (the reference's
``distributed/launch.py``): ``--nproc_per_node`` workers, each started
with the PADDLE_* env contract (``get_cluster_env``:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``FLAGS_selected_gpus``), which ``dygraph.parallel.prepare_context`` turns
into ``torch.distributed.init_process_group`` over the first endpoint.
The launcher supervises them: a worker that exits nonzero is relaunched
up to ``--max_restarts`` times (default 0: the other ranks of a collective
job wait in a collective for the dead one, so a failure brings the job
down), then every worker is stopped and the launcher exits with the
failed rank's code. Every child is a new process (``subprocess``): the
launcher never forks a process that holds CUDA.

Parameter servers: ``--server_script=serve.py`` with
``--pserver_endpoints=ep0,ep1,ep2,ep3`` and ``--pserver_shards=2`` starts
one server process an endpoint, the endpoints sliced into contiguous
groups of a primary and its backups, one group a shard (env contract:
``PADDLE_ROLE=pserver``, ``PADDLE_PSERVER_ENDPOINTS`` = its shard's
group, ``PADDLE_PSERVER_SHARDS``, ``PADDLE_PSERVER_SHARD``,
``PADDLE_PSERVER_INDEX``, ``PADDLE_PSERVER_GLOBAL_INDEX``,
``PSERVER_ENDPOINT`` = its own endpoint, ``PADDLE_TRAINERS_NUM``,
``PADDLE_PS_WITNESSES``). Trainers get the full list in
``PADDLE_PSERVER_ENDPOINTS`` and the count in ``PADDLE_PSERVER_SHARDS``
(``ps_shard.client_from_env``). A server of a group with backups that
dies is relaunched (within ``--max_restarts``) with
``PADDLE_PS_REJOIN=1``: it comes back as a backup that catches up from
the group's active server, never as a primary. A server of a group of
one holds the only copy of its shard, so its death brings the job down.
``--ps_witness_endpoints`` starts one ``PSWitness`` process an endpoint
(``--server_script`` run with ``PADDLE_ROLE=witness``), whose grant every
election then needs.

Durable rounds: ``--ps_durable_dir=DIR`` gives every server
``PADDLE_PS_DURABLE_DIR`` (the active primary of each group writes its
round frames there) and keeps ``job.json`` (the incarnation and the
restore cut). When DIR holds round frames, or with ``--restore``, the
launch is a cold restart: the cut is the newest round every shard can
restore (``checkpoint.job_restore_round``; ``RestoreMissingShard`` names
a shard without one), every server restores it (``PADDLE_PS_RESTORE=1``,
``PADDLE_PS_RESTORE_ROUND``) and every trainer gets
``PADDLE_PS_RESTORE_ROUND`` to resume after it. ``PADDLE_INCARNATION``
counts the launches of the job.

Serving replicas: ``--serving_script=replica.py`` with
``--serving_replicas=N`` starts N replica processes (env contract:
``PADDLE_ROLE=serving``, ``PADDLE_SERVING_REPLICAS``,
``PADDLE_SERVING_REPLICA_INDEX``, ``PADDLE_SERVING_ENDPOINTS`` = the
``host:port`` list, from ``--serving_endpoints`` or
``--serving_started_port`` + i, ``PADDLE_SERVING_ENDPOINT`` = its own).
A replica is stateless: one that dies is relaunched in place (within
``--max_restarts``) and rejoins the fleet router's rotation once its
``/healthz`` answers. Trainers see ``PADDLE_SERVING_ENDPOINTS`` too.
Servers and replicas serve until every trainer exits, then are stopped.

Job telemetry: with ``PADDLE_TPU_METRICS_DIR`` set the launcher clears the
directory's stale dumps, dumps as ``launcher-<node_rank>``, mints one job
trace id (``PADDLE_TPU_TRACE_ID``) for every rank, runs the clock
handshake with each child (``observability.distributed``) and, at
teardown, merges every process's dump into ``metrics.json`` and
``trace.json`` (``merge_job_dir``). ``--steering`` supervises a steering
daemon (``observability/steering_daemon.py``) over that directory, polled
every ``--steering_interval`` seconds: it proposes plans and applies none.

Usage:  python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
            [--started_port=6170] [--log_dir=DIR] [--steering] \\
            [--server_script=serve.py --pserver_endpoints=ep0,ep1 \\
             --pserver_shards=2 [--ps_witness_endpoints=ep] \\
             [--ps_durable_dir=DIR [--restore]]] \\
            [--serving_script=replica.py --serving_replicas=2] \\
            train.py --your-args
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from ..observability import distributed as _dobs
from ..observability import flight as _flight

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
    p.add_argument("--server_script", default=None,
                   help="script run once per --pserver_endpoints entry "
                        "as a parameter-server process")
    p.add_argument("--pserver_endpoints", default="",
                   help="comma-separated pserver endpoints, a primary "
                        "and its backups a shard (requires "
                        "--server_script)")
    p.add_argument("--pserver_shards", type=int,
                   default=int(os.environ.get("PADDLE_PSERVER_SHARDS",
                                              "1")),
                   help="slice --pserver_endpoints into this many "
                        "contiguous primary+backup groups (key-range "
                        "sharded PS; the endpoint count must divide "
                        "evenly)")
    p.add_argument("--ps_durable_dir",
                   default=os.environ.get("PADDLE_PS_DURABLE_DIR", ""),
                   help="root of the round-fenced durable PS rounds: "
                        "each shard's primary writes its applied rounds "
                        "here, and a cold restart resumes from the "
                        "newest round present on every shard")
    p.add_argument("--restore", action="store_true",
                   help="cold restart from --ps_durable_dir (detected "
                        "by itself when the directory holds round "
                        "frames; with this flag an empty or "
                        "unrestorable directory is an error)")
    p.add_argument("--ps_witness_endpoints", default="",
                   help="comma-separated external quorum witness "
                        "endpoints: one --server_script process each, "
                        "with PADDLE_ROLE=witness; every pserver's "
                        "election then needs a live witness grant")
    p.add_argument("--serving_script", default=None,
                   help="script run once per serving replica as a "
                        "stateless serving process")
    p.add_argument("--serving_replicas", type=int, default=0,
                   help="number of serving replicas (requires "
                        "--serving_script)")
    p.add_argument("--serving_endpoints", default="",
                   help="comma-separated host:port per replica "
                        "(default: 127.0.0.1:<serving_started_port>+i)")
    p.add_argument("--serving_started_port", type=int, default=8200)
    p.add_argument("--steering", action="store_true",
                   help="supervise a steering daemon over the job's "
                        "PADDLE_TPU_METRICS_DIR: it watches the merged "
                        "telemetry and writes proposed plans, applying "
                        "none")
    p.add_argument("--steering_interval", type=float, default=5.0,
                   help="seconds between steering-daemon polls")
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
    """One supervised process: its command, env, restarts, log and the
    clock handshake's bookkeeping."""

    def __init__(self, local_rank: int, cmd, env, log_dir,
                 role: str = "trainer", metrics_dir=None, global_rank=None):
        self.local_rank = local_rank
        # the rank the child dumps under (``process_identity`` reads the
        # global PADDLE_TRAINER_ID): its clock record carries that name
        self.global_rank = (local_rank if global_rank is None
                            else int(global_rank))
        self.cmd = list(cmd)
        self.env = dict(env)
        self.log_dir = log_dir
        self.role = role
        self.metrics_dir = metrics_dir
        self.restarts = 0
        self.proc: subprocess.Popen = None
        self._fp = None
        # the ping file this incarnation writes, its dump name, the spawn
        # time and the last poll that saw no ping (on the launcher's clock)
        self.clock_ping_path = None
        self.clock_proc = None
        self.spawned_at_us = None
        self.last_absent_poll_us = None
        self.group_size = 1  # a pserver's group: itself and its backups

    def _proc_base(self) -> str:
        """The name this incarnation dumps under."""
        base = "%s-%d" % (self.role, self.global_rank)
        if self.restarts:
            base += ".r%d" % self.restarts
        return base

    def spawn(self) -> None:
        env = dict(self.env)
        env["PADDLE_RESTART_COUNT"] = str(self.restarts)
        if self.role == "pserver" and self.restarts > 0:
            # a relaunched server comes back as a catching-up backup: the
            # trainers have failed over, and a second primary would split
            # the brain
            env["PADDLE_PS_REJOIN"] = "1"
        if self.metrics_dir:
            self.clock_proc = self._proc_base()
            self.clock_ping_path = os.path.join(
                self.metrics_dir, self.clock_proc + ".clockping")
            env[_dobs.CLOCK_PING_ENV] = self.clock_ping_path
        self.close_log()
        out = None
        if self.log_dir:
            name = {"pserver": "serverlog.%d",
                    "serving": "servinglog.%d",
                    "witness": "witnesslog.%d",
                    "steering": "steeringlog.%d"}.get(
                        self.role, "workerlog.%d") % self.local_rank
            self._fp = open(os.path.join(self.log_dir, name), "a")
            out = self._fp
        self.spawned_at_us = time.time() * 1e6
        self.last_absent_poll_us = None
        self.proc = subprocess.Popen(self.cmd, env=env, stdout=out,
                                     stderr=out)
        _flight.record("launch.spawn", role=self.role,
                       rank=self.local_rank, restart=self.restarts,
                       pid=self.proc.pid)

    def poll_clock_ping(self) -> None:
        """Finish the clock handshake once the child's ping file exists:
        record its skew against the launcher's clock, remove the file."""
        path = self.clock_ping_path
        if not path:
            return
        if not os.path.exists(path):
            # the ping comes after now: the skew's window shrinks to one
            # poll period
            self.last_absent_poll_us = time.time() * 1e6
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                child_wall = float(json.load(f).get("wall_us") or 0.0)
        except (OSError, ValueError):
            return  # a torn write: the next poll reads the whole file
        self.clock_ping_path = None
        try:
            os.unlink(path)
        except OSError:
            pass
        if child_wall and self.spawned_at_us:
            t0 = max(self.spawned_at_us,
                     self.last_absent_poll_us or self.spawned_at_us)
            skew, unc = _dobs.record_clock_offset(
                self.metrics_dir, self.clock_proc, child_wall, t0,
                time.time() * 1e6)
            _flight.record("launch.clock_sync", role=self.role,
                           rank=self.local_rank, skew_us=round(skew),
                           uncertainty_us=round(unc))

    def close_log(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def _pserver_groups(args):
    """(endpoints, one group of endpoints a shard, witness endpoints)."""
    eps = [e.strip() for e in (getattr(args, "pserver_endpoints", "")
                               or "").split(",") if e.strip()]
    witnesses = [e.strip() for e in (getattr(
        args, "ps_witness_endpoints", "") or "").split(",") if e.strip()]
    if (eps or witnesses) and not getattr(args, "server_script", None):
        raise SystemExit("--pserver_endpoints / --ps_witness_endpoints "
                         "require --server_script")
    if witnesses and not eps:
        raise SystemExit("--ps_witness_endpoints requires "
                         "--pserver_endpoints")
    if not eps:
        return [], [], []
    from .ps_shard import split_endpoint_groups

    try:
        groups = split_endpoint_groups(
            eps, max(1, int(getattr(args, "pserver_shards", 1))))
    except ValueError as e:
        raise SystemExit(str(e))
    return eps, groups, witnesses


def _restore_cut(args, pserver_eps, nshards):
    """Decide, before anything spawns, whether this launch is a fresh
    start or a cold restart: the restore cut (or None), after bumping the
    incarnation in the durable root's ``job.json``. The cut is the newest
    round restorable on every shard, never a mixed one."""
    root = (getattr(args, "ps_durable_dir", "") or "").strip()
    if getattr(args, "restore", False) and not root:
        raise SystemExit("--restore requires --ps_durable_dir")
    if not root or not pserver_eps:
        if root:
            raise SystemExit("--ps_durable_dir requires "
                             "--pserver_endpoints")
        return None, None
    from .. import checkpoint as _ckpt

    prev = _ckpt.read_job_manifest(root)
    cut = None
    if getattr(args, "restore", False) \
            or _ckpt.job_has_durable_state(root):
        # RestoreMissingShard names a shard without a usable round
        cut = _ckpt.job_restore_round(root, nshards)
    incarnation = int(prev.get("incarnation", -1)) + 1
    _ckpt.write_job_manifest(root, {
        "incarnation": incarnation, "restore_round": cut,
        "shards": nshards, "endpoints": pserver_eps})
    # every child env and the launcher's own dump carry it
    os.environ["PADDLE_INCARNATION"] = str(incarnation)
    if cut is not None:
        _log("cold restart: incarnation %d resumes from durable round %d "
             "(%s)" % (incarnation, cut, root))
    return root, cut


def _serving_endpoints(args):
    n = max(0, int(getattr(args, "serving_replicas", 0) or 0))
    eps = [e.strip() for e in (getattr(args, "serving_endpoints", "")
                               or "").split(",") if e.strip()]
    if eps and not n:
        n = len(eps)
    if n and not getattr(args, "serving_script", None):
        raise SystemExit("--serving_replicas/--serving_endpoints "
                         "require --serving_script")
    if n and not eps:
        eps = ["127.0.0.1:%d" % (args.serving_started_port + i)
               for i in range(n)]
    if n and len(eps) != n:
        raise SystemExit("--serving_endpoints names %d endpoint(s) for "
                         "%d replicas" % (len(eps), n))
    return eps


def launch(args=None) -> int:
    args = args if args is not None else _parse_args()
    node_ips = [ip for ip in args.ips.split(",") if ip]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    pserver_eps, shard_groups, witness_eps = _pserver_groups(args)
    durable_root, restore_round = _restore_cut(args, pserver_eps,
                                               len(shard_groups))
    metrics_dir = _dobs.metrics_dir()
    if metrics_dir:
        # the launcher dumps too, and a fresh job starts from an empty
        # directory: a merge must not read another job's dumps. A cold
        # restart keeps the dead incarnation's dumps (its postmortem);
        # this incarnation's carry their own suffix
        _dobs.set_identity("launcher", args.node_rank)
        if restore_round is None:
            removed = _dobs.clear_stale_dumps(metrics_dir)
            if removed:
                _log("cleared %d stale dump(s) from %s"
                     % (removed, metrics_dir))
        _dobs.arm(metrics_dir)
        if restore_round is not None:
            _flight.record("launch.cold_start",
                           incarnation=int(os.environ[
                               "PADDLE_INCARNATION"]),
                           restore_round=restore_round,
                           shards=len(shard_groups))
        # one job trace id, in every worker's env: each rank derives the
        # same round span from it (``distributed.fleet_round_args``)
        os.environ.setdefault(_dobs.JOB_TRACE_ENV, os.urandom(8).hex())
    serving_eps = _serving_endpoints(args)
    # children import the package even when it runs from a checkout (the
    # script's directory replaces the launcher's cwd on sys.path)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def child_env(extra):
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH",
                                                            "")
        env.update(extra)
        return env

    cmd = [sys.executable, "-u", args.training_script] + \
        list(args.training_script_args)
    nranks = len(node_ips) * args.nproc_per_node
    workers = []
    for local_rank in range(args.nproc_per_node):
        env = dict(os.environ)
        env.update(get_cluster_env(node_ips, args.node_rank,
                                   args.nproc_per_node, args.started_port,
                                   local_rank))
        env["PADDLE_ROLE"] = "trainer"  # its dump's name: trainer-<rank>
        if pserver_eps:
            env["PADDLE_PSERVER_ENDPOINTS"] = ",".join(pserver_eps)
            env["PADDLE_PSERVER_SHARDS"] = str(len(shard_groups))
        if restore_round is not None:
            # the trainer resumes after the job's cut
            env["PADDLE_PS_RESTORE_ROUND"] = str(restore_round)
        if serving_eps:
            # a trainer that sends traffic builds its FleetRouter from it
            env["PADDLE_SERVING_ENDPOINTS"] = ",".join(serving_eps)
        workers.append(_Worker(
            local_rank, cmd, env, args.log_dir, metrics_dir=metrics_dir,
            global_rank=int(env["PADDLE_TRAINER_ID"])))
    servers = []
    for shard, group in enumerate(shard_groups):
        for i, ep in enumerate(group):
            extra = {
                "PADDLE_ROLE": "pserver",
                # each server sees only its group; the witnesses serve
                # every shard (their lease views are keyed by shard)
                "PADDLE_PS_WITNESSES": ",".join(witness_eps),
                "PADDLE_PSERVER_ENDPOINTS": ",".join(group),
                "PADDLE_PSERVER_SHARDS": str(len(shard_groups)),
                "PADDLE_PSERVER_SHARD": str(shard),
                "PADDLE_PSERVER_INDEX": str(i),
                "PADDLE_PSERVER_GLOBAL_INDEX": str(pserver_eps.index(ep)),
                "PSERVER_ENDPOINT": ep,
                "PADDLE_TRAINERS_NUM": str(nranks)}
            if durable_root:
                extra["PADDLE_PS_DURABLE_DIR"] = durable_root
            if restore_round is not None:
                # every member restores the job's cut, never its own
                # newest round, and fences the dead incarnation out
                extra["PADDLE_PS_RESTORE"] = "1"
                extra["PADDLE_PS_RESTORE_ROUND"] = str(restore_round)
            w = _Worker(pserver_eps.index(ep),
                        [sys.executable, "-u", args.server_script],
                        child_env(extra), args.log_dir, role="pserver",
                        metrics_dir=metrics_dir)
            w.group_size = len(group)
            servers.append(w)
    for i, ep in enumerate(witness_eps):
        # a witness holds no parameter state: relaunched like a replica
        servers.append(_Worker(
            len(pserver_eps) + i,
            [sys.executable, "-u", args.server_script],
            child_env({"PADDLE_ROLE": "witness",
                       "PSERVER_ENDPOINT": ep,
                       "PADDLE_PS_WITNESSES": ",".join(witness_eps),
                       "PADDLE_TRAINER_ID": str(i)}),
            args.log_dir, role="witness", metrics_dir=metrics_dir,
            global_rank=i))
    for i, ep in enumerate(serving_eps):
        # stateless: a relaunch needs no rejoin protocol, the router
        # re-admits the endpoint once /healthz answers
        servers.append(_Worker(
            i, [sys.executable, "-u", args.serving_script],
            child_env({
                "PADDLE_ROLE": "serving",
                "PADDLE_SERVING_REPLICAS": str(len(serving_eps)),
                "PADDLE_SERVING_REPLICA_INDEX": str(i),
                "PADDLE_SERVING_ENDPOINTS": ",".join(serving_eps),
                "PADDLE_SERVING_ENDPOINT": ep}),
            args.log_dir, role="serving", metrics_dir=metrics_dir))
    if args.steering:
        if not metrics_dir:
            _log("--steering ignored: PADDLE_TPU_METRICS_DIR is unset (the "
                 "daemon watches the job's merged dumps)")
        else:
            # supervised as a server: relaunched on a crash (it only
            # reads telemetry and writes proposals), stopped after the
            # trainers
            env = child_env({"PADDLE_ROLE": "steering",
                             "PADDLE_TRAINER_ID": "0",
                             "PADDLE_TPU_METRICS_DIR": metrics_dir})
            servers.append(_Worker(
                0, [sys.executable, "-u", "-m",
                    "paddle_tpu_torch.observability.steering_daemon",
                    "--interval", str(args.steering_interval)],
                env, args.log_dir, role="steering",
                metrics_dir=metrics_dir))

    def _terminate_all(sig=signal.SIGTERM):
        for w in workers + servers:
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.send_signal(sig)
                except OSError:
                    pass
        for w in workers + servers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()

    live = set(range(args.nproc_per_node))
    rc = 0
    try:
        for s in servers:
            s.spawn()
        for w in workers:
            w.spawn()
        while live:
            time.sleep(0.1)
            for w in workers + servers:
                w.poll_clock_ping()
            for s in servers:
                code = s.proc.poll()
                if code is None or code == 0:
                    continue
                _flight.record("launch.exit", role=s.role,
                               rank=s.local_rank, code=code)
                if s.role == "pserver" and s.group_size < 2:
                    # the only copy of its shard is gone: a relaunch has
                    # no group to catch up from
                    _log("pserver %d exited %d; its group has no backup: "
                         "bringing the job down" % (s.local_rank, code))
                    rc = code if code > 0 else 1
                    _terminate_all()
                    live = set()
                    break
                if s.restarts >= args.max_restarts:
                    _log("%s exited %d; restart budget (%d) spent: "
                         "bringing the job down"
                         % (s.role, code, args.max_restarts))
                    rc = code if code > 0 else 1
                    _terminate_all()
                    live = set()
                    break
                s.restarts += 1
                _log("%s %d exited %d; relaunching%s (restart %d/%d)"
                     % (s.role, s.local_rank, code,
                        " as a catching-up backup"
                        if s.role == "pserver" else "",
                        s.restarts, args.max_restarts))
                s.spawn()
            for w in workers:
                if w.local_rank not in live:
                    continue
                code = w.proc.poll()
                if code is None:
                    continue
                if code == 0:
                    live.discard(w.local_rank)
                    continue
                _flight.record("launch.exit", role="trainer",
                               rank=w.local_rank, code=code)
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
        rc = 1
        _terminate_all()
        return 1
    finally:
        # the trainers are done: stop the daemon
        for s in servers:
            if s.proc is not None and s.proc.poll() is None:
                try:
                    s.proc.terminate()
                except OSError:
                    pass
        for s in servers:
            if s.proc is not None:
                try:
                    s.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    s.proc.kill()
                    s.proc.wait()
        for w in workers + servers:
            w.close_log()
        if metrics_dir:
            # one merged picture even of a job whose children were
            # killed: their periodic and at-exit dumps, and the exits the
            # launcher saw, on the shared wall clock
            _flight.record("launch.done", rc=rc if sys.exc_info()[0] is None
                           else 1)
            try:
                for w in workers + servers:
                    w.poll_clock_ping()
                _dobs.dump_process()
                mpath, tpath = _dobs.merge_job_dir(metrics_dir)
                if mpath:
                    _log("merged job telemetry: %s + %s" % (mpath, tpath))
            except Exception as e:  # noqa: BLE001 telemetry must not fail
                # a job
                _log("job telemetry merge failed: %s: %s"
                     % (type(e).__name__, e))


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
