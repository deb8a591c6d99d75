"""Chaos drill of the port's survivable parameter server: seeded fault
schedules against the replicated (and sharded) PS, gated on the
bit-for-bit exactly-once invariant.

    python3 tools/torch_chaos_drill.py [--rounds 1] [--sync-rounds 6]
        [--seed 1234] [--shards 2 [--partition | --migrate]]
        [--inprocess]

One seed gives one schedule (``make_schedule``, a pure function of its
arguments, draw for draw the JAX package's ``tools/chaos_drill.py``):
a ``PADDLE_TPU_FAULTS`` plan from ``fault.random_plan`` (drop / dup /
delay frames), a trainer SIGKILLed at a seeded round and a primary
pserver SIGKILLed at a seeded round.

- The multi-process drill (default) runs the sync job under
  ``paddle_tpu_torch.distributed.launch`` with
  ``tests/dist_worker_ft_torch.py`` as trainer and server: 2 trainers,
  and a primary + backup a shard. The killed server's backup wins its
  election once the lease expires, the trainers fail over and replay,
  the launcher relaunches the dead server as a rejoining backup and the
  dead trainer resumes from its checkpoint. Gated on exit 0, every var
  bitwise equal to the clean computation on both trainers, and the
  merged telemetry (the promotion, delta rounds below the anchors).
- ``--shards 2``: two shard groups; the schedule picks which shard's
  primary dies, and the sister shard must not notice.
- ``--partition`` (with ``--shards 2``): the other shard's primary and
  backup are severed for the whole run; that backup's lease expires, it
  loses every election and is never promoted.
- ``--migrate`` (with ``--shards 2``): trainer 0 asks for the live
  migration of the dying shard's var to its sister, and the donor's
  primary is SIGKILLed between the install and the commit
  (``PADDLE_PS_CHAOS_DIE_AFTER_INSTALL``); the promoted donor backup
  completes the re-asked migration, with a witness and clock jitter.
- ``--inprocess``: the same schedule's frame faults and primary kill
  against servers in this process (``run_inprocess``, what the tests
  use): two trainer threads, params bitwise equal to the clean run.

A failing drill prints the seed to replay it with.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import threading

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker_ft_torch.py")
if REPO not in sys.path:  # the script's directory is tools/
    sys.path.insert(0, REPO)

DIM = 4
LR = 0.1


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_schedule(seed: int, sync_rounds: int = 6, shards: int = 1,
                  partition: bool = False, migrate: bool = False,
                  evict: bool = False, migrate_range: bool = False,
                  total_loss: bool = False,
                  corrupt_newest: bool = False, fault=None) -> dict:
    """The fault schedule as a pure function of its arguments: the same
    dict as the JAX package's ``chaos_drill.make_schedule`` (the same
    draws in the same order). ``fault`` is the fault module to draw the
    plan with (the port's by default)."""
    if fault is None:
        from paddle_tpu_torch.distributed import fault

    rng = random.Random(int(seed))
    hi = max(1, int(sync_rounds) - 1)
    sched = {
        "seed": int(seed),
        "sync_rounds": int(sync_rounds),
        "plan": fault.random_plan(rng),
        "trainer_kill_rank": rng.randint(0, 1),
        "trainer_kill_round": rng.randint(1, hi),
        "server_kill_round": rng.randint(1, hi),
        "shards": max(1, int(shards)),
        "partition": bool(partition),
        "migrate": bool(migrate),
        "evict": bool(evict),
    }
    sched["die_shard"] = (rng.randrange(sched["shards"])
                          if sched["shards"] > 1 else 0)
    # the partitioned pair belongs to a surviving shard: one shard must
    # promote, the other must be denied the quorum
    sched["partition_shard"] = (
        (sched["die_shard"] + 1) % sched["shards"]
        if sched["partition"] and sched["shards"] > 1 else None)
    if sched["migrate"]:
        # asked at m, executed (and the donor killed) at m+1, asked
        # again at m+2, complete by m+4
        sched["migrate_round"] = rng.randint(
            1, max(1, int(sync_rounds) - 4))
        sched["migrate_from"] = sched["die_shard"]
        sched["migrate_to"] = ((sched["die_shard"] + 1)
                               % sched["shards"])
    else:
        sched["migrate_round"] = None
    if sched["evict"]:
        sched["trainer_kill_round"] = min(
            sched["trainer_kill_round"], max(1, int(sync_rounds) - 2))
        sched["evict_shard"] = 1
    sched["migrate_range"] = bool(migrate_range)
    if sched["migrate_range"]:
        sched["mr_base_round"] = rng.randint(2, 3)
        sched["mr_hot_shard"] = sched["die_shard"]
        sched["mr_to_shard"] = ((sched["die_shard"] + 1)
                                % sched["shards"])
    sched["total_loss"] = bool(total_loss)
    sched["corrupt_newest"] = bool(corrupt_newest)
    if sched["total_loss"]:
        sched["total_kill_round"] = rng.randint(
            2, max(2, int(sync_rounds) - 2))
    else:
        sched["total_kill_round"] = None
    return sched


def grad_for(tid: int, rnd: int, var: int = 0) -> np.ndarray:
    """Trainer ``tid``'s grad of var ``var`` at round ``rnd``
    (``dist_worker_ft_torch.grad_for``)."""
    return np.full(DIM, (tid + 1) * 0.01 * rnd + var * 0.001,
                   dtype=np.float32)


def oracle_w(rounds: int, var: int = 0, trainers: int = 2) -> np.ndarray:
    """The clean computation: the server's float32 ops in its order."""
    w = np.zeros(DIM, dtype=np.float32)
    for rnd in range(1, rounds + 1):
        total = grad_for(0, rnd, var)
        for t in range(1, trainers):
            total = total + grad_for(t, rnd, var)
        w = w - np.float32(LR) * total
    return w


def var_names(nshards: int, shard_for_key) -> list:
    """One var a shard, var i routed to shard i (the worker's rule)."""
    if nshards <= 1:
        return ["w"]
    names = []
    for s in range(nshards):
        i = 0
        while True:
            cand = "w%d" % i
            if shard_for_key(cand, nshards) == s and cand not in names:
                names.append(cand)
                break
            i += 1
    return names


class _Scope(dict):
    """A dict scope; with ``torch_tensors`` it holds CPU torch tensors,
    as the port's executor does."""

    torch_tensors = False

    def __setitem__(self, name, val):
        if self.torch_tensors and isinstance(val, np.ndarray):
            import torch

            val = torch.from_numpy(np.ascontiguousarray(val))
        super().__setitem__(name, val)

    def local_var_names(self):
        return list(self)


class _Exec:
    device = "cpu"

    def _read_var(self, scope, name):
        return scope.get(name)

    def _write_var(self, scope, name, val):
        if type(val).__module__.split(".")[0] != "torch":
            val = np.asarray(val)
        scope[name] = val

    def run_block(self, block, scope):
        block(scope)


def _sgd(name):
    def block(scope):
        scope[name] = scope[name] - LR * scope[name + "@GRAD"]
    return block


def run_inprocess(sched: dict, ps_rpc=None, ps_shard=None, fault=None,
                  torch_tensors: bool = True,
                  timeout: float = 120.0) -> dict:
    """The schedule's frame faults and primary kill against in-process
    servers (a primary + backup a shard) and two trainer threads.
    Returns ``{tid: {var: bytes}}`` of each trainer's final params. The
    modules default to the port's; passing the JAX package's runs the
    same drill through it."""
    if ps_rpc is None:
        from paddle_tpu_torch.distributed import fault, ps_rpc, ps_shard
    nshards = sched["shards"]
    rounds = sched["sync_rounds"]
    kill_at = sched["server_kill_round"]
    env = {"PADDLE_TPU_FAULTS": sched["plan"],
           "PADDLE_TPU_FAULT_SEED": str(sched["seed"]),
           # a dead in-process server refuses at once: a short connect
           # window moves the trainers on to the backup
           "PADDLE_PS_CONNECT_TIMEOUT": "0.3",
           "PADDLE_PS_FAILOVER_CONNECT_TIMEOUT": "0.3",
           "PADDLE_PS_RPC_BACKOFF_MS": "10",
           # faults are absorbed by retries on a short deadline (a
           # dropped frame costs one deadline), never turned into a
           # failover off a healthy primary: 20 x 0.5 s also covers a
           # barrier waiting out the other trainer's failover
           "PADDLE_PS_RPC_DEADLINE": "0.5",
           "PADDLE_PS_RPC_RETRIES": "20",
           # the dead primary's lease: the failover's wait
           "PADDLE_PS_LEASE_MS": "600"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    fault.reset_injector()
    names = var_names(nshards, ps_shard.shard_for_key)
    groups, servers = [], []
    try:
        for si in range(nshards):
            grp = ["127.0.0.1:%d" % _free_port() for _ in range(2)]
            groups.append(grp)
            for ep in grp:
                scope = _Scope()
                scope.torch_tensors = torch_tensors
                scope[names[si]] = np.zeros(DIM, dtype=np.float32)
                srv = ps_rpc.PSServer(
                    ep, _Exec(), scope, {names[si] + "@GRAD":
                                         _sgd(names[si])},
                    fanin=2, endpoints=grp, shard=si)
                srv.start_background()
                servers.append(srv)
        gate = threading.Barrier(3)
        errors, ws = [], {}

        def trainer(tid):
            try:
                if nshards > 1:
                    c = ps_shard.ShardedPSClient(
                        [",".join(g) for g in groups], trainer_id=tid)
                else:
                    c = ps_rpc.PSClient(",".join(groups[0]),
                                        trainer_id=tid)
                w = {}
                for rnd in range(1, rounds + 1):
                    for vi, n in enumerate(names):
                        c.send_grad(n + "@GRAD", grad_for(tid, rnd, vi),
                                    round=rnd)
                    if rnd == kill_at:
                        gate.wait(timeout=timeout)  # grads are in
                        gate.wait(timeout=timeout)  # the primary died
                    c.send_barrier(round=rnd)
                    w = {n: c.get_param(n).tobytes() for n in names}
                    c.fetch_barrier()
                ws[tid] = w
                c.close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((tid, e))

        ts = [threading.Thread(target=trainer, args=(t,), daemon=True)
              for t in (0, 1)]
        for t in ts:
            t.start()
        gate.wait(timeout=timeout)
        servers[2 * sched["die_shard"]].stop()
        gate.wait(timeout=timeout)
        for t in ts:
            t.join(timeout=timeout)
        if any(t.is_alive() for t in ts):
            raise RuntimeError("in-process drill deadlocked (seed %d)"
                               % sched["seed"])
        if errors:
            raise RuntimeError("in-process drill failed (seed %d): %s"
                               % (sched["seed"], errors))
        return ws
    finally:
        for s in servers:
            s.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        fault.reset_injector()


def _check_inprocess(sched: dict) -> int:
    from paddle_tpu_torch.distributed.ps_shard import shard_for_key

    print("[chaos] in-process schedule %s"
          % json.dumps(sched, sort_keys=True))
    ws = run_inprocess(sched)
    names = var_names(sched["shards"], shard_for_key)
    ok = True
    for tid in (0, 1):
        for vi, n in enumerate(names):
            good = ws[tid][n] == oracle_w(sched["sync_rounds"],
                                          var=vi).tobytes()
            print("[chaos] %s: trainer %d var %s %s the clean run"
                  % ("PASS" if good else "FAIL", tid, n,
                     "matches" if good else "DIVERGES FROM"))
            ok = ok and good
    return 0 if ok else 1


def _env(sched: dict, tmp: str, eps: list) -> dict:
    from paddle_tpu_torch.distributed.ps_shard import \
        split_endpoint_groups

    groups = split_endpoint_groups(eps, sched["shards"])
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_PS_HEARTBEAT_MS", None)
    plan = sched["plan"]
    if sched["partition_shard"] is not None:
        pg = groups[sched["partition_shard"]]
        plan = "%s,partition:1:%s|%s" % (plan, pg[0], pg[1])
    if sched.get("migrate"):
        plan = "%s,clock_jitter:0.3:300" % plan
    env.update({
        "FT_ROLE": "trainer",
        "PSERVER_ENDPOINT": ",".join(eps),
        "FT_ROUNDS": str(sched["sync_rounds"]),
        "FT_DIE_AT_ROUND": str(sched["trainer_kill_round"]),
        "FT_DIE_RANK": str(sched["trainer_kill_rank"]),
        "FT_SERVER_DIE_AT_ROUND": str(sched["server_kill_round"]),
        "FT_DIE_SHARD": str(sched["die_shard"]),
        "FT_OUT": os.path.join(tmp, "out"),
        "FT_CKPT_ROOT": os.path.join(tmp, "ckpt"),
        "PADDLE_TPU_FAULTS": plan,
        "PADDLE_TPU_FAULT_SEED": str(sched["seed"]),
        # exactness over availability: every death is followed by a
        # relaunch, so no trainer is evicted
        "PADDLE_PS_EVICT_AFTER": "0",
        "PADDLE_PS_RPC_RETRIES": "12",
        "PADDLE_PS_RPC_BACKOFF_MS": "30",
        "PADDLE_PS_RPC_DEADLINE": "8",
        "PADDLE_PS_CONNECT_TIMEOUT": "4",
        "PADDLE_PS_FAILOVER_CONNECT_TIMEOUT": "3",
        "PADDLE_PS_REPL_DEADLINE": "5",
        "PADDLE_PS_LEASE_MS": "1200",
        "PADDLE_TPU_METRICS_DIR": os.path.join(tmp, "metrics"),
        "PADDLE_TPU_DUMP_PERIOD": "0.5",
    })
    if sched.get("migrate"):
        env.update({
            "FT_SERVER_DIE_AT_ROUND": "0",
            "FT_MIGRATE_AT_ROUND": str(sched["migrate_round"]),
            "FT_MIGRATE_FROM_SHARD": str(sched["migrate_from"]),
            "FT_MIGRATE_TO_SHARD": str(sched["migrate_to"]),
            "PADDLE_PS_CHAOS_DIE_AFTER_INSTALL":
                groups[sched["migrate_from"]][0],
        })
    return env


def _rerun_hint(sched: dict) -> str:
    return ("tools/torch_chaos_drill.py --seed %d --sync-rounds %d%s%s%s"
            % (sched["seed"], sched["sync_rounds"],
               " --shards %d" % sched["shards"]
               if sched["shards"] > 1 else "",
               " --partition" if sched["partition"] else "",
               " --migrate" if sched.get("migrate") else ""))


def _check_telemetry(sched: dict, mdir: str, groups: list,
                     outs: dict) -> bool:
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_ft_timeline

    ok = True

    def chk(what, passed):
        nonlocal ok
        print("[chaos] %s: %s" % ("PASS" if passed else "FAIL", what))
        ok = ok and passed

    mpath = os.path.join(mdir, "metrics.json")
    chk("job-level metrics.json merged", os.path.exists(mpath))
    if not ok:
        return False
    totals = json.load(open(mpath)).get("counters_total", {})
    events = torch_ft_timeline.load_events(mdir)
    died = set(groups[sched["die_shard"]])
    promo = [e for e in events if e["kind"] == "ps.promotion"
             and e["fields"].get("endpoint") in died]
    chk("the killed shard's backup was promoted", bool(promo))
    chk("delta rounds ran (ps.delta_rounds=%s)"
        % totals.get("ps.delta_rounds"),
        totals.get("ps.delta_rounds", 0) > 0)
    delta_b = totals.get("ps.replication_bytes{mode=delta}", 0)
    full_b = totals.get("ps.replication_bytes{mode=full}", 0)
    chk("delta bytes (%d) below the anchors' (%d)" % (delta_b, full_b),
        0 < delta_b < full_b)
    if sched["partition_shard"] is not None:
        part = set(groups[sched["partition_shard"]])
        chk("no promotion in the partitioned shard",
            not [e for e in events if e["kind"] == "ps.promotion"
                 and e["fields"].get("endpoint") in part])
        chk("the partitioned backup's lease expired",
            any(e["kind"] == "ps.lease_expired"
                and e["fields"].get("endpoint") in part
                for e in events))
    if sched.get("migrate"):
        chk("every trainer adopted the bumped shard map (%s)"
            % [outs[t].get("map_version") for t in outs],
            all((outs[t].get("map_version") or 0) >= 1 for t in outs))
        chk("witness votes were cast",
            any(k.startswith("ps.witness_votes") and v > 0
                for k, v in totals.items()))
    return ok


def run_drill(sched: dict, timeout: float = 600.0) -> int:
    from paddle_tpu_torch.distributed.ps_shard import (
        shard_for_key, split_endpoint_groups)

    tmp = tempfile.mkdtemp(prefix="torch_chaos_drill_")
    eps = ["127.0.0.1:%d" % _free_port()
           for _ in range(2 * sched["shards"])]
    print("[chaos] schedule %s" % json.dumps(sched, sort_keys=True))
    args = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
            "--nproc_per_node=2", "--max_restarts=3",
            "--started_port=%d" % _free_port(),
            "--server_script=%s" % WORKER,
            "--pserver_shards=%d" % sched["shards"],
            "--pserver_endpoints=%s" % ",".join(eps)]
    if sched.get("migrate"):
        args.append("--ps_witness_endpoints=127.0.0.1:%d"
                    % _free_port())
    args.append(WORKER)
    sup = subprocess.run(args, env=_env(sched, tmp, eps),
                         timeout=timeout, cwd=REPO)
    if sup.returncode != 0:
        print("[chaos] FAIL: job exited %d (rerun: %s)"
              % (sup.returncode, _rerun_hint(sched)))
        return 1
    names = var_names(sched["shards"], shard_for_key)
    ok = True
    outs = {}
    for tid in (0, 1):
        with open(os.path.join(tmp, "out.t%d.json" % tid)) as f:
            outs[tid] = json.load(f)
        for vi, n in enumerate(names):
            got = np.asarray(outs[tid]["vars"][n], dtype=np.float32)
            good = got.tobytes() == oracle_w(sched["sync_rounds"],
                                             var=vi).tobytes()
            print("[chaos] %s: trainer %d var %s %s the clean run "
                  "(failovers=%s)" % ("PASS" if good else "FAIL", tid, n,
                                      "matches" if good
                                      else "DIVERGES FROM",
                                      outs[tid].get("failovers")))
            ok = ok and good
    ok = _check_telemetry(sched, os.path.join(tmp, "metrics"),
                          split_endpoint_groups(eps, sched["shards"]),
                          outs) and ok
    if not ok:
        print("[chaos] reproduce with: %s" % _rerun_hint(sched))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser("torch_chaos_drill")
    ap.add_argument("--rounds", type=int, default=1,
                    help="drills to run (drill i uses seed + i)")
    ap.add_argument("--sync-rounds", type=int, default=6)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--partition", action="store_true")
    ap.add_argument("--migrate", action="store_true")
    ap.add_argument("--inprocess", action="store_true")
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("PADDLE_TPU_FAULT_SEED",
                                               "1234")))
    args = ap.parse_args()
    if (args.partition or args.migrate) and args.shards < 2:
        ap.error("--partition / --migrate need --shards >= 2")
    if args.partition and args.migrate:
        ap.error("--partition and --migrate are separate drills")
    if args.inprocess and (args.partition or args.migrate):
        ap.error("--inprocess drills the frame faults and the kill")
    rc = 0
    for i in range(args.rounds):
        sched = make_schedule(args.seed + i, args.sync_rounds,
                              shards=args.shards,
                              partition=args.partition,
                              migrate=args.migrate)
        rc |= (_check_inprocess(sched) if args.inprocess
               else run_drill(sched))
    if rc == 0:
        print("[chaos] ALL %d DRILL(S) PASS" % args.rounds)
    return rc


if __name__ == "__main__":
    sys.exit(main())
