"""Worker of ``chip_smoke.py``'s parameter-server phases (67-69): bench.py's
Wide&Deep with its tables row-sliced over the pservers, as a pserver or a
trainer under the port's launcher (``PADDLE_ROLE``).

Settings (env):

- ``PS_WD_CFG``: json of the model's widths (``batch`` is the GLOBAL batch,
  split over the trainers), default bench.py's: batch 2048, vocab 100000,
  26 slots, 13 dense features, embeddings of 16, hidden (64, 32), Adam
  1e-3; and the transpiler's ``min_block_size`` (8192: the fc weights
  above it are sliced into a row block a server);
- ``PS_WD_MODE``: ``sync`` (the round protocol) or ``async`` (through the
  Communicator, fed by an InMemoryDataset after its global shuffle);
- ``PS_WD_STEPS``: sync rounds; ``PS_WD_DEVICE``: the trainers' device
  (``cuda`` or ``cpu``); ``PS_WD_OUT``: the directory for the results;
- ``PS_TEST_PSERVERS``: every pserver endpoint (the launcher gives a
  server only its own shard's);
- async: ``PS_WD_DATA`` holds ``part-<rank>`` MultiSlot files, and
  ``PADDLE_SHUFFLE_ENDPOINTS`` the trainers' shuffle endpoints.

A pserver runs on the CPU, as this script asks, and serves until the
launcher stops it. A trainer first takes every dense param from its
server, so both trainers and the servers start from one state; trainer 0
writes that state (``init.npz``: the dense params and every table, pulled
whole) for ``chip_smoke.py``'s reference run. In sync mode each trainer
also writes its push ops' inputs a round (``pushes<rank>.npz``) and, after
the last round, the rows it pushed as its servers hold them, with their
Adam moments and the beta powers (``final<rank>.npz``), for the replay of
``check_table_pushes``. Each trainer writes
``trainer<rank>.json``: losses, step times, rows pulled and pushed, RPC
bytes and host copies a step, its card's idle share over one profiled
step, its kernel launches, and its seconds to the first step and in all.

With ``PADDLE_SERVING_ENDPOINTS`` set (the launcher's serving role beside
the PS job), trainer 0 also sends the requests of ``PS_SERVING_REQUESTS``
(an npz) through a ``FleetRouter`` over the replicas and writes their
outputs to ``serving_out.npz``.

``PS_WD_SURVIVE=1`` (phase 69, sync): the launcher's groups are a
primary and its backups (a backup serves its primary's program), a
``witness`` role serves a ``PSWitness``, and the trainers run
``train_survive``: the steps' records outlive a kill (``pushes<rank>.npz``,
``progress<rank>.json``), a cold-restarted trainer resumes after the
job's restore cut, and the knobs ``PS_WD_KILL_AT`` / ``PS_WD_KILL_EP``
(kill a server before a step), ``PS_WD_PAUSE_AFTER`` (after a step,
read the state back and wait to be killed), ``PS_WD_MIGRATE_AFTER``
(migrate the steerer's hot range after a step) and ``PS_WD_HOT`` (a hot
row range in the feeds) drive the drills. After the last step every server must answer caught up; the
final state is pulled by global row, wherever the row lives
(``final<rank>.npz``), for ``check_survive_pushes``.
"""
import json
import os
import time

T_START = time.perf_counter()

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import models  # noqa: E402
from paddle_tpu_torch.models.wide_deep import random_batch  # noqa: E402

CFG = dict(batch=2048, vocab=100000, slots=26, dense_dim=13, embed=16,
           hidden=[64, 32], lr=1e-3, min_block_size=8192)
CFG.update(json.loads(os.environ.get("PS_WD_CFG", "{}")))
MODE = os.environ.get("PS_WD_MODE", "sync")


def build(batch, is_distributed=True, is_sparse=False, loss_scale=1.0,
          optimize=True):
    """(main, startup, loss) of bench.py's Wide&Deep at ``batch`` rows;
    the minimized loss is ``loss_scale`` times the fetched mean. Without
    ``optimize`` the program stops at the grads."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        dense = fluid.data(name="dense", shape=[batch, CFG["dense_dim"]],
                           dtype="float32")
        sparse = fluid.data(name="sparse", shape=[batch, CFG["slots"]],
                            dtype="int64")
        label = fluid.data(name="label", shape=[batch, 1], dtype="int64")
        pred = models.wide_deep(dense, sparse, vocab_size=CFG["vocab"],
                                embed_dim=CFG["embed"],
                                hidden_sizes=tuple(CFG["hidden"]),
                                is_sparse=is_sparse,
                                is_distributed=is_distributed)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        opt_loss = (loss if loss_scale == 1.0
                    else fluid.layers.scale(loss, scale=loss_scale))
        if optimize:
            fluid.optimizer.AdamOptimizer(CFG["lr"]).minimize(opt_loss)
        else:
            fluid.backward.append_backward(opt_loss)
    return main, startup, loss


def reference_run(exe, steps, out_dir):
    """The untranspiled program at the global batch, its tables sparse, its
    minimized loss the trainers' summed half-batch losses (the grad sum
    the round protocol applies), from the servers' start (init.npz): the
    loss a round."""
    import torch

    main, startup, loss = build(CFG["batch"], is_distributed=False,
                                is_sparse=True, loss_scale=2.0)
    init = np.load(os.path.join(out_dir, "init.npz"))
    scope = fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for name in init.files:
            scope.var(name).get_tensor().set(
                torch.from_numpy(init[name]).to(exe.device))
        for feed in global_batches(steps):
            (l,) = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(np.asarray(l).ravel()[0]))
    return losses


def check_first_round(exe, out_dir, first_losses):
    """Each trainer's first round against the untranspiled program at its
    half batch, from the servers' start with the table rows this trainer
    pulled: a push is round-free, so another trainer's first push may
    land on a server before this trainer's pull. Returns the largest
    loss gap (relative), the largest gap of a table's merged push against
    the program's table grad (relative to the largest grad; a row set
    that differs reads inf), and the rows pulled that the other trainer
    had already moved."""
    import torch

    trainers = len(first_losses)
    # no optimizer: nothing for bench.py's fused-optimizer knob to fold
    main, startup, loss = build(CFG["batch"] // trainers,
                                is_distributed=False, is_sparse=True,
                                optimize=False)
    tables = [op.input("W")[0] for op in main.global_block().ops
              if op.type == "lookup_table"]
    keep_in_scope(main, [w + "@GRAD" for w in tables])
    init = np.load(os.path.join(out_dir, "init.npz"))
    feed = global_batches(1)[0]
    loss_gap, grad_gap, moved = 0.0, 0.0, 0
    for r in range(trainers):
        with np.load(os.path.join(out_dir, "pushes%d.npz" % r)) as z:
            rec = {k: z[k] for k in z.files if k.startswith("0/")}
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            for name in init.files:
                arr = init[name]
                if name in tables:
                    ids = rec["0/%s/ids" % name].astype(np.int64)
                    pulled = rec["0/%s/pulled" % name]
                    moved += int((pulled != arr[ids]).any(axis=1).sum())
                    arr = arr.copy()
                    arr[ids] = pulled
                scope.var(name).get_tensor().set(
                    torch.from_numpy(arr).to(exe.device))
            (l,) = exe.run(main, feed=half(feed, r, trainers),
                           fetch_list=[loss])
            ref = float(np.asarray(l).ravel()[0])
            loss_gap = max(loss_gap, abs(first_losses[r] - ref) / abs(ref))
            for w in tables:
                sr = exe._core._read_var(scope, w + "@GRAD")
                rows, want = merged_push(np.asarray(sr.rows()),
                                         to_host(sr.get_tensor().array))
                uniq, got = merged_push(rec["0/%s/ids" % w],
                                        rec["0/%s/grad" % w])
                if not np.array_equal(rows, uniq):
                    return loss_gap, np.inf, moved
                grad_gap = max(grad_gap, float(
                    np.abs(got - want).max()
                    / max(np.abs(want).max(), 1e-30)))
    return loss_gap, grad_gap, moved


def global_batches(steps, seed=24, hot=None):
    """bench.py's feeds (``models.wide_deep.random_batch``) at the global
    batch, one a round. ``hot`` = (lo, hi, share): that share of every
    slot's ids is redrawn from rows [lo, hi) (a hot row range)."""
    rng = np.random.RandomState(seed)
    feeds = [random_batch(
        rng, CFG["batch"], CFG["vocab"], CFG["slots"], CFG["dense_dim"])
        for _ in range(steps)]
    if hot:
        lo, hi, share = hot
        hrng = np.random.RandomState(seed + 1)
        for f in feeds:
            ids = f["sparse"]
            pick = hrng.random_sample(ids.shape) < share
            ids[pick] = hrng.randint(lo, hi, size=int(pick.sum()))
    return feeds


def hot_window():
    """``PS_WD_HOT`` = "lo,hi,share" (the survivable phase's hot rows)."""
    raw = os.environ.get("PS_WD_HOT", "")
    if not raw:
        return None
    lo, hi, share = raw.split(",")
    return int(lo), int(hi), float(share)


def half(feed, rank, trainers):
    n = next(iter(feed.values())).shape[0] // trainers
    return {k: v[rank * n:(rank + 1) * n] for k, v in feed.items()}


def transpile(pservers, trainers, trainer_id):
    main, startup, loss = build(CFG["batch"] // trainers)
    cfg = fluid.DistributeTranspilerConfig()
    cfg.min_block_size = CFG["min_block_size"]
    t = fluid.DistributeTranspiler(config=cfg)
    t.transpile(trainer_id=trainer_id, program=main,
                startup_program=startup, pservers=",".join(pservers),
                trainers=trainers, sync_mode=(MODE == "sync"))
    return t, main, startup, loss


def idle_share(fn):
    """(share of ``fn``'s wall time the card runs no kernel, wall ms), from
    the profiler's device records of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return (max(0.0, 1.0 - busy / wall_us) if spans else None,
            wall_us / 1e3)


def serve_pserver(pservers, trainers):
    """Serve this endpoint's slice. A backup (a later member of its group,
    ``PADDLE_PSERVER_ENDPOINTS``) runs its primary's program: the
    transpiler knows the primaries only, and ``listen_and_serv`` listens
    on ``PSERVER_ENDPOINT``. In the survivable phase the server also
    writes its pid (``pid-<host>_<port>`` in ``PS_WD_OUT``) for the
    trainer that kills it."""
    ep = os.environ["PSERVER_ENDPOINT"]
    os.environ["PADDLE_PSERVER_RPC"] = "1"
    group = [e for e in os.environ.get("PADDLE_PSERVER_ENDPOINTS",
                                       "").split(",") if e]
    prog_ep = group[0] if ep in group else ep
    if SURVIVE:
        with open(pid_path(ep), "w") as f:
            f.write(str(os.getpid()))
    t = transpile(pservers, trainers, 0)[0]
    ps = t.get_pserver_program(prog_ep)
    exe = fluid.Executor(fluid.CPUPlace())
    exe._core.rng.seed = 123
    exe.run(t.get_startup_program(prog_ep, ps))
    exe.run(ps)  # serves until the launcher stops this process


def pid_path(ep):
    return os.path.join(os.environ["PS_WD_OUT"],
                        "pid-%s" % ep.replace(":", "_"))


def ps_client(ep):
    """The trainer's client of the server (group) whose primary is ``ep``:
    the PS ops' own cached client, over the group's whole chain."""
    from paddle_tpu_torch.ops.distributed_ops import _rpc_client

    return _rpc_client(ep)


def held_round(t, rank, fn):
    """Run ``fn`` inside an empty sync round (a get_param waits out an open
    round), then hold every trainer in a second empty round until each has
    run its ``fn``: a table push is round-free."""
    def barrier(kind):
        for ep in t.pserver_endpoints:
            getattr(ps_client(ep), kind)()

    barrier("send_barrier")
    fn()
    barrier("fetch_barrier")
    barrier("send_barrier")
    barrier("fetch_barrier")


def take_server_state(t, scope, exe, rank, out_dir, write_init=True):
    """Every dense param from its server into this trainer's scope. In sync
    mode trainer 0 also writes the whole start (dense params and tables)
    to init.npz, inside a held round (``write_init``; a trainer resumed
    after a cold restart writes none)."""
    from paddle_tpu_torch.distributed.ps_rpc import write_array

    eps = t.pserver_endpoints
    state = {}

    def pull():
        for p, _g in t.params_grads:
            if p in t.dense_blocks:  # sliced: a row block a server
                arr = np.concatenate([
                    ps_client(e["ep"]).get_param(
                        e["pname"]) for e in t.dense_blocks[p]])
            else:
                arr = ps_client(t.param_to_ep[p]).get_param(p)
            write_array(exe._core, scope, p, arr)
            state[p] = arr
        if MODE == "sync" and rank == 0 and write_init:
            for w, tb in t.dist_tables.items():
                parts = [ps_client(eps[k]).pull_sparse(
                    w, np.arange(c)) for k, c in enumerate(tb["counts"])
                    if c]
                state[w] = np.concatenate(parts)
            np.savez(os.path.join(out_dir, "init.npz"), **state)

    if MODE == "sync":
        held_round(t, rank, pull)
    else:
        pull()


# the server's Adam on a table (the optimizer's attrs, bench.py's defaults)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def to_host(val):
    """A scope value as numpy, copied outside the PS ops' copy counters."""
    import torch

    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def keep_in_scope(program, names):
    """Mark ``names`` persistable, so the executor keeps them in the scope
    after a run (it frees a temporary after its last use)."""
    for n in names:
        program.global_block().var(n).persistable = True


def record_round(rec, step, main, exe, scope):
    """Each distributed_push_sparse op's inputs of this step (its ids and
    the lookup output's grad), and in the first step each pulled lookup,
    as the ops read and wrote them (kept in the scope by
    ``keep_in_scope``)."""
    for op in main.global_block().ops:
        w = op.attrs.get("table_name")
        if op.type == "distributed_push_sparse":
            rec["%d/%s/ids" % (step, w)] = to_host(
                exe._core._read_var(scope, op.input("Ids")[0])).reshape(-1)
            og = to_host(exe._core._read_var(scope, op.input("OutGrad")[0]))
            rec["%d/%s/grad" % (step, w)] = og.reshape(-1, og.shape[-1])
        elif op.type == "distributed_lookup_table" and step == 0:
            out = to_host(exe._core._read_var(scope,
                                              op.output("Outputs")[0]))
            rec["0/%s/pulled" % w] = out.reshape(-1, out.shape[-1])


def merged_push(ids, grad):
    """(unique rows, summed grad rows): the trainer's merge before a push."""
    uniq, inv = np.unique(ids.astype(np.int64), return_inverse=True)
    merged = np.zeros((uniq.size, grad.shape[-1]), dtype=grad.dtype)
    np.add.at(merged, inv, grad)
    return uniq, merged


def take_final_state(t, rank, out_dir, rec):
    """After the last sync round: each dist table's rows that this trainer
    pushed, with their Adam moments and the table's beta powers, from
    every server (``final<rank>.npz``)."""
    eps = t.pserver_endpoints
    state = {}

    def pull():
        for k, ep in enumerate(eps):
            slots = {}
            for blk in t.get_pserver_program(ep).blocks[1:]:
                for op in blk.ops:
                    if op.type == "adam" and op.input("Param")[0] in \
                            t.dist_tables:
                        slots[op.input("Param")[0]] = op
            cl = ps_client(ep)
            for w, tb in t.dist_tables.items():
                s, c = tb["starts"][k], tb["counts"][k]
                ids = np.concatenate([v for key, v in rec.items()
                                      if key.endswith("/%s/ids" % w)])
                ids = np.unique(ids.astype(np.int64))
                local = ids[(ids >= s) & (ids < s + c)] - s
                key = "%s/%d/" % (w, k)
                state[key + "rows"] = local
                state[key + "start"] = np.int64(s)
                state[key + "count"] = np.int64(c)
                if not local.size:
                    continue
                op = slots[w]
                state[key + "param"] = cl.pull_sparse(w, local)
                for slot in ("Moment1", "Moment2"):
                    state[key + slot] = cl.pull_sparse(op.input(slot)[0],
                                                       local)
                for slot in ("Beta1Pow", "Beta2Pow"):
                    state[key + slot] = cl.get_param(op.input(slot)[0])

    held_round(t, rank, pull)
    np.savez(os.path.join(out_dir, "final%d.npz" % rank), **state)


def _adam_step(p, m1, m2, b1p, b2p, g, lr):
    """One Adam step of a table's rows, as the pserver's adam op takes it
    (Fluid's adam: the bias-corrected rate from the beta powers)."""
    import torch

    b1, b2 = ADAM_BETAS
    m1 = b1 * m1 + (1 - b1) * g
    m2 = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p = p - lr_t * m1 / (torch.sqrt(m2) + ADAM_EPS)
    return p, m1, m2, b1p * b1, b2p * b2


def check_table_pushes(out_dir, trainers, steps, drop=()):
    """The servers' table rows after ``steps`` sync rounds against a replay
    of every trainer's recorded pushes from init.npz: each push its own
    Adam step on the server that hosts its rows (the round protocol leaves
    the two pushes of a round to arrive in either order, so each
    (table, server) takes the best of every order). ``drop`` holds
    (trainer, step) pushes to leave out: a planted fault. Returns, over
    every (table, server), the worst score of its rows (param error in
    Adam steps of ``lr``, moment errors relative to their largest) and of
    its beta powers (relative), the least rows score of any pair, and the
    number of pairs."""
    import torch

    def load(name):  # an npz member is read anew at each access
        with np.load(os.path.join(out_dir, name)) as z:
            return {k: z[k] for k in z.files}

    init = load("init.npz")
    recs = [load("pushes%d.npz" % r) for r in range(trainers)]
    finals = [load("final%d.npz" % r) for r in range(trainers)]
    lr = torch.tensor([CFG["lr"]], dtype=torch.float32).reshape(())
    worst = {"rows": 0.0, "rows_least": np.inf, "pows": 0.0, "pairs": 0}
    for key in sorted(k[:-len("rows")] for k in finals[0]
                      if k.endswith("/rows")):
        w = key.split("/")[0]
        start = int(finals[0][key + "start"])
        count = int(finals[0][key + "count"])
        rows = np.unique(np.concatenate([f[key + "rows"] for f in finals]))
        if not rows.size:
            continue
        got = {}
        for f in finals:  # each trainer pulled the rows it pushed
            if not f[key + "rows"].size:
                continue
            pos = np.searchsorted(rows, f[key + "rows"])
            for slot in ("param", "Moment1", "Moment2"):
                arr = got.setdefault(slot, np.full(
                    (rows.size,) + f[key + slot].shape[1:], np.nan,
                    np.float32))
                arr[pos] = f[key + slot]
            for slot in ("Beta1Pow", "Beta2Pow"):
                got[slot] = f[key + slot]

        def grad(r, step):
            ids = recs[r]["%d/%s/ids" % (step, w)]
            uniq, merged = merged_push(
                ids, recs[r]["%d/%s/grad" % (step, w)])
            mask = (uniq >= start) & (uniq < start + count)
            if not mask.any():
                return None
            g = np.zeros((rows.size, merged.shape[1]), np.float32)
            g[np.searchsorted(rows, uniq[mask] - start)] = merged[mask]
            return torch.from_numpy(g)

        zero = torch.zeros((rows.size, init[w].shape[1]), dtype=torch.float32)
        states = [(torch.from_numpy(init[w][start + rows]), zero, zero,
                   torch.tensor(ADAM_BETAS[0], dtype=torch.float32),
                   torch.tensor(ADAM_BETAS[1], dtype=torch.float32))]
        for step in range(steps):
            gs = [g for g in (grad(r, step) for r in range(trainers)
                              if (r, step) not in drop) if g is not None]
            orders = [gs] if len(gs) < 2 else [gs, gs[::-1]]
            nxt = []
            for st in states:
                for order in orders:
                    s = st
                    for g in order:
                        s = _adam_step(*s, g, lr)
                    nxt.append(s)
            states = nxt
        want = {k: torch.from_numpy(np.asarray(got[k]))
                for k in ("param", "Moment1", "Moment2", "Beta1Pow",
                          "Beta2Pow")}
        best_rows, best_pows = np.inf, np.inf
        for p, m1, m2, b1p, b2p in states:
            r_score = max(
                float((p - want["param"]).abs().max() / lr),
                float((m1 - want["Moment1"]).abs().max()
                      / want["Moment1"].abs().max().clamp_min(1e-30)),
                float((m2 - want["Moment2"]).abs().max()
                      / want["Moment2"].abs().max().clamp_min(1e-30)))
            p_score = max(
                float((b1p - want["Beta1Pow"].reshape(())).abs() / b1p),
                float((b2p - want["Beta2Pow"].reshape(())).abs() / b2p))
            if (r_score, p_score) < (best_rows, best_pows):
                best_rows, best_pows = r_score, p_score
        worst["rows"] = max(worst["rows"], best_rows)
        worst["rows_least"] = min(worst["rows_least"], best_rows)
        worst["pows"] = max(worst["pows"], best_pows)
        worst["pairs"] += 1
    return worst


def counters():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.ps_rpc import PSClient, copy_counts

    c = copy_counts()
    tr = PSClient.traffic()
    return {"rows_pulled": obs.counter("ps.rows_pulled").value,
            "rows_pushed": obs.counter("ps.rows_pushed").value,
            "rpc_bytes": tr["sent"] + tr["recv"], **c}


def per_step(before, after, steps):
    return {k: (after[k] - before[k]) / float(steps) for k in after}


def drive_serving(out_dir):
    """Send ``PS_SERVING_REQUESTS`` at once through a FleetRouter over the
    launched replicas; write their outputs."""
    from paddle_tpu_torch import serving

    eps = os.environ["PADDLE_SERVING_ENDPOINTS"].split(",")
    reqs = np.load(os.environ["PS_SERVING_REQUESTS"])
    n = len({k.split("/")[0] for k in reqs.files})
    router = serving.FleetRouter(eps, serving.FleetConfig(
        health_interval_ms=100, request_timeout_s=120)).start()
    try:
        deadline = time.time() + 300
        while router.healthy_count() < len(eps):
            if time.time() > deadline:
                raise RuntimeError("serving replicas not healthy: %s"
                                   % [r.snapshot() for r in router.replicas])
            time.sleep(0.1)
        # every request at once; a request's latency is its submit to
        # its result, on the host clock
        done, futs = {}, []
        for i in range(n):
            feed = {k.split("/")[1]: reqs[k] for k in reqs.files
                    if k.startswith("%d/" % i)}
            t_sub = time.perf_counter()
            fut = router.submit(feed, request_id="ps-req-%d" % i)
            fut.add_done_callback(
                lambda _f, i=i, t=t_sub: done.__setitem__(
                    i, (time.perf_counter() - t) * 1e3))
            futs.append(fut)
        outs = {}
        for i, fut in enumerate(futs):
            for name, arr in fut.result(timeout=120).items():
                outs["%d/%s" % (i, name)] = np.asarray(arr)
        while len(done) < n:  # a callback runs just after its result
            time.sleep(0.001)
        lat = [done[i] for i in range(n)]
        np.savez(os.path.join(out_dir, "serving_out.npz"), **outs)
        served = [r.snapshot()["served"] for r in router.replicas]
        return {"requests": n, "latency_ms": lat, "replicas": len(eps),
                "served_by_replica": served}
    finally:
        router.stop()


def train_sync(t, exe, scope, loss, rank, trainers, steps):
    feeds = [half(f, rank, trainers) for f in global_batches(steps)]
    main = t.get_trainer_program()
    keep_in_scope(main, [
        n for op in main.global_block().ops
        if op.type in ("distributed_push_sparse", "distributed_lookup_table")
        for n in op.input_arg_names + op.output_arg_names])
    losses, step_ms, rec = [], [], {}
    before = None
    for i, feed in enumerate(feeds):
        if i == 1:
            before = counters()  # step 1 pays the first-run costs
        t0 = time.perf_counter()
        (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(l).ravel()[0]))
        record_round(rec, i, main, exe, scope)  # copies not counted
    return losses, step_ms, per_step(before, counters(), len(feeds) - 1), \
        rec


# -- the survivable PS (phase 69) ----------------------------------------------

SURVIVE = os.environ.get("PS_WD_SURVIVE") == "1"


def _save_npz(path, arrays):
    """np.savez by tmp + rename: a SIGKILLed trainer leaves the last whole
    file, never a torn one."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load_npz(path):
    if not os.path.exists(path):
        return {}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _kill_server(ep):
    import signal

    with open(pid_path(ep)) as f:
        pid = int(f.read())
    os.kill(pid, signal.SIGKILL)
    return time.time()


def _propose_and_migrate(t, out):
    """The hot range, from the job's own merged dumps: the ``ps_migrate_range``
    steerer's plan over the servers' row-heat census, applied through the
    donor group's primary (it runs at the donor's next round apply)."""
    from paddle_tpu_torch.distributed.ps_shard import split_endpoint_groups
    from paddle_tpu_torch.observability import distributed as dist
    from paddle_tpu_torch.observability import ps_steering

    mdir = os.environ["PADDLE_TPU_METRICS_DIR"]
    # every server's periodic dump lands before the merge
    time.sleep(2.5 * float(os.environ.get("PADDLE_TPU_DUMP_PERIOD", "0.5")))
    mpath, _ = dist.merge_job_dir(mdir)
    with open(mpath) as f:
        doc = json.load(f)
    eps = t.pserver_endpoints
    plan = ps_steering.propose_migrate_range(
        doc=doc, height=CFG["vocab"], nshards=len(eps), by="row_heat")
    src = plan["lo"] - t.dist_tables[plan["table"]]["starts"][
        plan["from_shard"]]
    groups = split_endpoint_groups(
        os.environ["PADDLE_PSERVER_ENDPOINTS"].split(","), len(eps))
    resp = ps_client(eps[plan["from_shard"]]).migrate_range(
        plan["table"], plan["lo"], plan["hi"], src,
        src + plan["hi"] - plan["lo"], plan["to_shard"],
        ",".join(groups[plan["to_shard"]]))
    out["migration"] = {"plan": plan, "begin": resp, "wall": time.time()}


def wait_caught_up(timeout=120.0):
    """Until every server of every group answers caught up (a relaunched
    one has rejoined): (seconds waited, the answers)."""
    from paddle_tpu_torch.distributed.ps_rpc import _bare_rpc

    eps = os.environ["PADDLE_PSERVER_ENDPOINTS"].split(",")
    t0 = time.time()
    while True:
        got = {}
        for ep in eps:
            try:
                got[ep] = _bare_rpc(ep, {"kind": "repl_status"}, timeout=2.0)
            except (OSError, ValueError):
                got[ep] = {}
        if all(r.get("caught_up") for r in got.values()) \
                or time.time() - t0 > timeout:
            return time.time() - t0, {
                ep: {k: r.get(k) for k in ("active", "caught_up", "round",
                                           "epoch")}
                for ep, r in got.items()}
        time.sleep(0.2)


def wait_servers_up(timeout=600.0):
    """Until every server of every group answers ``repl_status`` (they boot
    beside the trainers): the clients' connect window can then be short,
    so a dead server is given up at once."""
    from paddle_tpu_torch.distributed.ps_rpc import _bare_rpc

    deadline = time.time() + timeout
    for ep in os.environ["PADDLE_PSERVER_ENDPOINTS"].split(","):
        while True:
            try:
                _bare_rpc(ep, {"kind": "repl_status"}, timeout=2.0)
                break
            except (OSError, ValueError):
                if time.time() > deadline:
                    raise RuntimeError("pserver %s never answered" % ep)
                time.sleep(0.2)


def train_survive(t, exe, scope, loss, rank, trainers, steps, out_dir):
    """Sync rounds through the survivable PS. The records outlive a kill of
    the whole job: the pushes (``pushes<rank>.npz``) and each step's server
    round (``progress<rank>.json``) are rewritten after every step, and a
    relaunch after a cold restart resumes at the step after the job's
    restore cut (``PADDLE_PS_RESTORE_ROUND``). ``PS_WD_KILL_AT`` /
    ``PS_WD_KILL_EP``: trainer 0 SIGKILLs that server before that step
    (1-based). ``PS_WD_PAUSE_AFTER``: after that step each trainer waits
    until every server is caught up, pulls the state so far
    (``mid<rank>.npz``), writes ``paused<rank>.json`` and waits to be
    killed. ``PS_WD_MIGRATE_AFTER``: after that step trainer 0 migrates
    the steerer's hot range."""
    feeds = [half(f, rank, trainers)
             for f in global_batches(steps, hot=hot_window())]
    main = t.get_trainer_program()
    keep_in_scope(main, [
        n for op in main.global_block().ops
        if op.type in ("distributed_push_sparse", "distributed_lookup_table")
        for n in op.input_arg_names + op.output_arg_names])
    eps = t.pserver_endpoints
    push_path = os.path.join(out_dir, "pushes%d.npz" % rank)
    prog_path = os.path.join(out_dir, "progress%d.json" % rank)
    progress = {}
    if os.path.exists(prog_path):
        with open(prog_path) as f:
            progress = {int(k): v for k, v in json.load(f).items()}
    rec = _load_npz(push_path)
    cut = int(os.environ.get("PADDLE_PS_RESTORE_ROUND") or 0)
    start = 0
    if cut:
        done = [i for i, p in progress.items() if p["server_round"] <= cut]
        start = max(done) + 1 if done else 0
        rec = {k: v for k, v in rec.items() if int(k.split("/")[0]) < start}
    kill_at = int(os.environ.get("PS_WD_KILL_AT") or 0)
    pause_after = int(os.environ.get("PS_WD_PAUSE_AFTER") or 0)
    migrate_after = int(os.environ.get("PS_WD_MIGRATE_AFTER") or 0)
    first = int(os.environ.get("PADDLE_RESTART_COUNT", "0")) == 0
    out = {"start_step": start, "losses": {}, "step_ms": {},
           "round_wall": {}}
    for i in range(start, steps):
        if rank == 0 and first and kill_at == i + 1:
            out["kill_wall"] = _kill_server(os.environ["PS_WD_KILL_EP"])
        t0 = time.perf_counter()
        (l,) = exe.run(main, feed=feeds[i], fetch_list=[loss], scope=scope)
        out["step_ms"][i] = (time.perf_counter() - t0) * 1e3
        out["round_wall"][i] = time.time()
        out["losses"][i] = float(np.asarray(l).ravel()[0])
        record_round(rec, i, main, exe, scope)
        _save_npz(push_path, rec)
        progress[i] = {"server_round": ps_client(eps[0])._round,
                       "wall": time.time()}
        with open(prog_path + ".tmp", "w") as f:
            json.dump(progress, f)
        os.replace(prog_path + ".tmp", prog_path)
        if rank == 0 and migrate_after == i + 1:
            _propose_and_migrate(t, out)
        if pause_after == i + 1:
            # every server serves again (a relaunched one caught up), the
            # state so far is read back, and chip_smoke.py kills the job
            out["caught_up_s"], out["caught_up"] = wait_caught_up()
            take_final_state_global(t, rank, out_dir, rec, name="mid")
            from paddle_tpu_torch.ops.cuda import support

            out["launches"] = support.launch_counts()
            with open(os.path.join(out_dir, "paused%d.json" % rank),
                      "w") as f:
                json.dump(out, f)
            time.sleep(3600)
    out["caught_up_s"], out["caught_up"] = wait_caught_up()
    from paddle_tpu_torch.ops import distributed_ops

    out["shard_map"] = distributed_ops.shard_map()
    return out, rec


def take_final_state_global(t, rank, out_dir, rec, name="final"):
    """Every row this trainer pushed so far, by global id, with its Adam
    moments, pulled from where it lives now (the adopted moved ranges
    included), its owner shard, whether it moved, and every shard's beta
    powers (``<name><rank>.npz``)."""
    from paddle_tpu_torch.ops import distributed_ops as dops

    eps = t.pserver_endpoints
    slots = {}
    for blk in t.get_pserver_program(eps[0]).blocks[1:]:
        for op in blk.ops:
            if op.type == "adam" and op.input("Param")[0] in t.dist_tables:
                slots[op.input("Param")[0]] = op
    state = {}

    def pull():
        for w, tb in t.dist_tables.items():
            ids = np.unique(np.concatenate(
                [v for k, v in rec.items() if k.endswith("/%s/ids" % w)])
                .astype(np.int64))
            op = slots[w]
            args = (ids, tb["starts"], tb["counts"], eps, tb["dim"])
            # the param first: a wrong_shard answer adopts the map the
            # moments are then routed by
            state[w + "/param"] = dops.pull_table_rows(w, *args)
            for slot in ("Moment1", "Moment2"):
                state[w + "/" + slot] = dops.pull_table_rows(
                    w, *args, var=op.input(slot)[0])
            owner = np.full(ids.shape, -1, np.int64)
            for k, mask, _local in dops._table_partition(
                    ids, tb["starts"], tb["counts"], w):
                owner[mask] = k
            moved = np.zeros(ids.shape, bool)
            for lo, hi, _s, _b in dops.shard_map()["ranges"].get(w, ()):
                moved |= (ids >= lo) & (ids < hi)
            state[w + "/rows"] = ids
            state[w + "/owner"] = owner
            state[w + "/moved"] = moved
            for k, ep in enumerate(eps):
                for slot in ("Beta1Pow", "Beta2Pow"):
                    state["%s/%s/%d" % (w, slot, k)] = \
                        ps_client(ep).get_param(op.input(slot)[0])

    held_round(t, rank, pull)
    _save_npz(os.path.join(out_dir, "%s%d.npz" % (name, rank)), state)


def check_survive_pushes(out_dir, trainers, steps, drops=((),),
                         final="final"):
    """Every pushed row of every table, where it lives after the last
    round, against a replay of the recorded pushes from init.npz, each
    push one Adam step of the server holding the row (the non-lazy Adam
    steps every row of its slice a push). The rows are grouped by
    (table, final owner, moved): each group's two pushes of a round arrive
    in either order on its server, so the order of every round is found
    on a few probe rows (every combination), then the whole group is
    replayed in that order. Every push reaches every shard (asserted).
    Each entry of ``drops`` is a replay: the (trainer, step) pushes it
    leaves out (a planted fault), the files read once for all. Returns,
    a replay, the worst scores over the groups (param in Adam steps of
    lr, moments relative to their largest, beta powers relative), the
    least rows score, and the number of groups."""
    import itertools

    import torch

    init = _load_npz(os.path.join(out_dir, "init.npz"))
    recs = [_load_npz(os.path.join(out_dir, "pushes%d.npz" % r))
            for r in range(trainers)]
    finals = [_load_npz(os.path.join(out_dir, "%s%d.npz" % (final, r)))
              for r in range(trainers)]
    lr = torch.tensor([CFG["lr"]], dtype=torch.float32).reshape(())
    worsts = [{"rows": 0.0, "rows_least": np.inf, "pows": 0.0, "groups": 0}
              for _ in drops]
    tables = sorted({k.split("/")[0] for k in finals[0]})
    for w in tables:
        rows = np.unique(np.concatenate([f[w + "/rows"] for f in finals]))
        got = {}
        for f in finals:
            pos = np.searchsorted(rows, f[w + "/rows"])
            for slot in ("param", "Moment1", "Moment2", "owner", "moved"):
                arr = got.setdefault(slot, np.zeros(
                    (rows.size,) + f[w + "/" + slot].shape[1:],
                    f[w + "/" + slot].dtype))
                arr[pos] = f[w + "/" + slot]
        merged = {}
        for r in range(trainers):
            for step in range(steps):
                ids = recs[r]["%d/%s/ids" % (step, w)]
                if ids.size == 0:
                    raise RuntimeError("push (%d, %d) of %s reached no "
                                       "shard" % (r, step, w))
                merged[(r, step)] = merged_push(
                    ids, recs[r]["%d/%s/grad" % (step, w)])
        groups = sorted({(int(o), bool(m))
                         for o, m in zip(got["owner"], got["moved"])})
        for owner, mv in groups:
            sel = np.nonzero((got["owner"] == owner)
                             & (got["moved"] == mv))[0]
            grows = rows[sel]

            # each push's grad on the group's rows, once (zero where the
            # push had none of them: the non-lazy step still moves them)
            gfull = {}
            for key, (uniq, m) in merged.items():
                g = np.zeros((grows.size, m.shape[1]), np.float32)
                hit = np.isin(uniq, grows)
                g[np.searchsorted(grows, uniq[hit])] = m[hit]
                gfull[key] = torch.from_numpy(g)

            def replay(sub, order, drop):
                d = init[w].shape[1]
                n = int(np.arange(grows.size)[sub].size)
                st = (torch.from_numpy(init[w][grows[sub]]),
                      torch.zeros((n, d)), torch.zeros((n, d)),
                      torch.tensor(ADAM_BETAS[0], dtype=torch.float32),
                      torch.tensor(ADAM_BETAS[1], dtype=torch.float32))
                for step, flip in enumerate(order):
                    gs = [gfull[(r, step)][sub] for r in range(trainers)
                          if (r, step) not in drop]
                    for g in (gs[::-1] if flip else gs):
                        st = _adam_step(*st, g, lr)
                return st

            k = str(owner)
            want = {"param": got["param"][sel],
                    "Moment1": got["Moment1"][sel],
                    "Moment2": got["Moment2"][sel],
                    "Beta1Pow": finals[0]["%s/Beta1Pow/%s" % (w, k)],
                    "Beta2Pow": finals[0]["%s/Beta2Pow/%s" % (w, k)]}

            def score(st, sub=slice(None)):
                p, m1, m2, b1p, b2p = st
                wt = {n: torch.from_numpy(np.asarray(want[n][sub]))
                      for n in ("param", "Moment1", "Moment2")}
                r_score = max(
                    float((p - wt["param"]).abs().max() / lr),
                    float((m1 - wt["Moment1"]).abs().max()
                          / wt["Moment1"].abs().max().clamp_min(1e-30)),
                    float((m2 - wt["Moment2"]).abs().max()
                          / wt["Moment2"].abs().max().clamp_min(1e-30)))
                p_score = max(
                    float((b1p - float(want["Beta1Pow"].reshape(())))
                          .abs() / b1p),
                    float((b2p - float(want["Beta2Pow"].reshape(())))
                          .abs() / b2p))
                return r_score, p_score

            def all_orders_scores(sub, drop):
                """Each combination of round orders' distance from the
                servers' state on rows ``sub`` (0 where it matches)."""
                n_orders = 2 ** steps
                p = torch.from_numpy(init[w][grows[sub]]).expand(
                    n_orders, -1, -1).clone()
                st = (p, torch.zeros_like(p), torch.zeros_like(p),
                      torch.full((n_orders, 1, 1), ADAM_BETAS[0]),
                      torch.full((n_orders, 1, 1), ADAM_BETAS[1]))
                for step in range(steps):
                    gs = [gfull[(r, step)][sub] for r in range(trainers)
                          if (r, step) not in drop]
                    a = st
                    for g in gs:
                        a = _adam_step(*a, g, lr)
                    if len(gs) < 2:
                        st = a
                        continue
                    b = st
                    for g in gs[::-1]:
                        b = _adam_step(*b, g, lr)
                    flip = torch.tensor(
                        [(c >> (steps - 1 - step)) & 1
                         for c in range(n_orders)],
                        dtype=torch.bool).reshape(-1, 1, 1)
                    st = tuple(torch.where(flip, y, x)
                               for x, y in zip(a, b))
                p, m1, m2, b1p, b2p = st
                wt = {n: torch.from_numpy(np.asarray(want[n][sub]))
                      for n in ("param", "Moment1", "Moment2")}
                return ((p - wt["param"]).abs().amax((1, 2))
                        + (m1 - wt["Moment1"]).abs().amax((1, 2))
                        + (m2 - wt["Moment2"]).abs().amax((1, 2))
                        + (b1p.reshape(-1) - float(
                            want["Beta1Pow"].reshape(()))).abs()
                        + (b2p.reshape(-1) - float(
                            want["Beta2Pow"].reshape(()))).abs()).numpy()

            # the order of every round, from probe rows each round's
            # pushes touched (an untouched row cannot tell the orders
            # apart): every combination of orders at once, on a leading
            # axis, then the whole group in the matching one
            pick = set(range(min(16, grows.size)))
            for step in range(steps):
                for r in range(trainers):
                    hit = np.nonzero(np.isin(grows,
                                             merged[(r, step)][0]))[0]
                    pick.update(hit[:4].tolist())
            probe = np.array(sorted(pick), dtype=np.int64)
            orders = list(itertools.product((False, True), repeat=steps))
            for drop, worst in zip(drops, worsts):
                dist = all_orders_scores(probe, drop)
                # the best on the probe first, then any other that
                # matched it
                tries = [int(np.argmin(dist))] + [
                    int(i) for i in np.nonzero(dist == 0)[0]
                    if int(i) != int(np.argmin(dist))][:7]
                r_score, p_score = np.inf, np.inf
                for i in tries:
                    sc = score(replay(slice(None), orders[i], drop))
                    if sc < (r_score, p_score):
                        r_score, p_score = sc
                    if sc == (0.0, 0.0):
                        break
                worst["rows"] = max(worst["rows"], r_score)
                worst["rows_least"] = min(worst["rows_least"], r_score)
                worst["pows"] = max(worst["pows"], p_score)
                worst["groups"] += 1
    return worsts


def train_async(t, exe, scope, loss, rank, out_dir):
    """Load this rank's part, shuffle it over the trainers, train it through
    the Communicator; the losses come from the dump fields."""
    main = t.get_trainer_program()
    blk = main.global_block()
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(CFG["batch"] // int(os.environ["PADDLE_TRAINERS_NUM"]))
    ds.set_use_var([blk.var("dense"), blk.var("sparse"), blk.var("label")])
    ds.set_filelist([os.path.join(os.environ["PS_WD_DATA"],
                                  "part-%d" % rank)])
    ds.load_into_memory()
    n_before = ds.get_memory_data_size()
    t0 = time.perf_counter()
    ds.global_shuffle()
    shuffle_s = time.perf_counter() - t0
    # a record's global index rides as its last sparse id
    record_ids = sorted(int(np.asarray(r["sparse"]).ravel()[-1])
                        for r in ds._records)
    dump = os.path.join(out_dir, "dump%d" % rank)
    main._fleet_opt = {"dump_fields": [loss.name], "dump_fields_path": dump}
    comm = fluid.Communicator(main).start()
    before = counters()
    t0 = time.perf_counter()
    stats = exe.train_from_dataset(main, ds, scope=scope, thread=1,
                                   fetch_list=[loss], print_period=1 << 30)
    train_s = time.perf_counter() - t0
    comm.stop()
    after = counters()
    losses = []
    with open(os.path.join(dump, "worker_0.txt")) as f:
        for line in f:
            losses.append(float(line.split("\t")[2].split()[0]))
    steps = max(1, stats["total_steps"])
    return {"records_before": n_before,
            "records_after": ds.get_memory_data_size(),
            "record_ids": record_ids, "shuffle_s": shuffle_s,
            "losses": losses, "steps": stats["total_steps"],
            "step_ms": [train_s * 1e3 / steps],
            "communicator_pushes": comm.pushes,
            "per_step": per_step(before, after, steps)}


def main():
    import sys

    import torch

    role = os.environ["PADDLE_ROLE"]
    if role == "witness":
        from paddle_tpu_torch.distributed.ps_rpc import PSWitness

        PSWitness(os.environ["PSERVER_ENDPOINT"]).serve_forever()
        return
    pservers = os.environ["PS_TEST_PSERVERS"].split(",")
    trainers = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    # the host's cores go to the servers' CPU math: a trainer's math is
    # the card's, and its host work (RPC, numpy, the interpreter) is one
    # Python thread
    if role == "pserver":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // len(pservers)
                                  - 1))
        serve_pserver(pservers, trainers)
        return
    torch.set_num_threads(1)
    out_dir = os.environ["PS_WD_OUT"]
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    device = os.environ.get("PS_WD_DEVICE", "cuda")
    from paddle_tpu_torch.distributed.ps_rpc import reset_copy_counts
    from paddle_tpu_torch.ops.cuda import support

    setup = {"imports": time.perf_counter() - T_START}
    t, main_prog, startup, loss = transpile(pservers, trainers, rank)
    setup["transpile"] = time.perf_counter() - T_START
    support.reset_launch_counts()
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu" else None)
    setup["executor"] = time.perf_counter() - T_START
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    setup["startup"] = time.perf_counter() - T_START
    resumed = bool(os.environ.get("PADDLE_PS_RESTORE_ROUND"))
    if SURVIVE:
        wait_servers_up()
    take_server_state(t, scope, exe, rank, out_dir, write_init=not resumed)
    ready_s = time.perf_counter() - T_START
    reset_copy_counts()
    if SURVIVE:
        steps = int(os.environ.get("PS_WD_STEPS", "6"))
        result, rec = train_survive(t, exe, scope, loss, rank, trainers,
                                    steps, out_dir)
        take_final_state_global(t, rank, out_dir, rec)
    elif MODE == "sync":
        steps = int(os.environ.get("PS_WD_STEPS", "4"))
        losses, step_ms, ps, rec = train_sync(t, exe, scope, loss, rank,
                                              trainers, steps)
        np.savez(os.path.join(out_dir, "pushes%d.npz" % rank), **rec)
        take_final_state(t, rank, out_dir, rec)
        result = {"losses": losses, "step_ms": step_ms, "per_step": ps}
        if device != "cpu":
            feed = half(global_batches(1, seed=99)[0], rank, trainers)
            result["idle_share"], result["profiled_step_ms"] = idle_share(
                lambda: exe.run(t.get_trainer_program(), feed=feed,
                                fetch_list=[loss], scope=scope))
    else:
        result = train_async(t, exe, scope, loss, rank, out_dir)
    result["launches"] = support.launch_counts()
    result["device"] = str(exe.device)
    # seconds from the process's start to each set-up stage's end, to its
    # first step, and to its end
    result["setup_s"] = setup
    result["ready_s"] = ready_s
    result["process_s"] = time.perf_counter() - T_START
    if rank == 0 and os.environ.get("PADDLE_SERVING_ENDPOINTS"):
        result["serving"] = drive_serving(out_dir)
    with open(os.path.join(out_dir, "trainer%d.json" % rank), "w") as f:
        json.dump(result, f)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
