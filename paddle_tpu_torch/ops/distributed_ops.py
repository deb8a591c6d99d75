"""Parameter-server ops: send / recv / barriers / listen_and_serv, the
distributed table's pull and push, geo-SGD's delta push and the FL server.

The port of ``paddle_tpu/ops/distributed_ops.py`` (the reference's
``operators/distributed_ops/``). Local endpoints are served by an
in-process emulated server registry: ``listen_and_serv`` registers its
optimize sub-blocks, ``send`` routes a grad to the matching sub-block and
runs it, ``recv`` copies the updated param back. Any other endpoint goes
over the socket RPC of ``distributed/ps_rpc.py``; with
``PADDLE_PSERVER_RPC=1`` ``listen_and_serv`` blocks serving it.

Every op here is a host op: a program holding one runs on the
interpreter (the whole-program route declines it by name, as the JAX
engine does). On the card the trainer copies at these ops only, each
copy counted by ``ps_rpc.copy_counts``:
- ``send`` / ``geo_send`` / ``distributed_push_sparse``: the grad (or
  param and snapshot, or ids and grad) down to the host;
- ``recv``: the param up to the card;
- ``distributed_lookup_table``: the ids down, the pulled rows up.
The table ops count the rows they pull and push (``ps.rows_pulled`` /
``ps.rows_pushed`` in the observability registry).

A table's rows live where the transpiler sliced them until a row range
migrates (``ps_shard.ShardedPSClient.migrate_range``, or the donor
primary's ``migrate_range`` rpc): the donor then answers a pull or push of
the moved rows with ``wrong_shard`` and its shard map, and the ops adopt
the map (``adopt_shard_map``, newest version wins) and route those rows to
their new owner from then on; a push re-sends only the redirected slice,
so every row is applied once. The endpoints of an op are the shard
groups' primaries in shard order, the order the map's shard indexes name.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Dict

import numpy as np

from ..core.registry import In, Out, register_host_op
from ..distributed.ps_rpc import (WrongShard, _counter, gather_rows,
                                  host_array, selected_rows, write_array)

# endpoint -> dict(executor=, scope=, grad_to_block=)
_EMULATED_SERVERS: Dict[str, dict] = {}


def reset_emulated_servers():
    _EMULATED_SERVERS.clear()
    reset_shard_map()
    # drop the cached RPC clients too: a fresh server on a reused
    # endpoint must not inherit a dead connection
    from ..distributed.ps_rpc import PSClient

    PSClient.reset()


def _grad_to_block(op) -> Dict:
    g2b = {}
    blocks = op.attrs.get("optimize_blocks", [])
    for entry in op.attrs.get("grad_to_block_id", []):
        gname, bid = entry.rsplit(":", 1)
        for b in blocks:
            if b.idx == int(bid):
                g2b[gname] = b
    return g2b


@register_host_op(
    "listen_and_serv",
    inputs=[In("X", duplicable=True, dispensable=True, no_grad=True)],
    outputs=[],
    attrs={"endpoint": "", "optimize_blocks": [], "grad_to_block_id": [],
           "sync_mode": True, "Fanin": 1},
)
def _listen_and_serv(executor, op, scope):
    """Register this endpoint's server: in process (the default; sends
    drive the optimize blocks at once), or, with
    ``PADDLE_PSERVER_RPC=1``, a TCP server that blocks serving the round
    protocol until a shutdown message (the reference's
    listen_and_serv_op.cc). A backup runs its primary's program: when
    ``PSERVER_ENDPOINT`` is a later member of the group
    (``PADDLE_PSERVER_ENDPOINTS``) whose primary the op names, the server
    listens on it. The server's survivability knobs come from the env
    (``ps_rpc.PSServer``); a range migrating in keeps the recipient's own
    optimize block for its table (``block_factory``)."""
    grad_to_block = _grad_to_block(op)
    if os.environ.get("PADDLE_PSERVER_RPC") == "1":
        from ..distributed.ps_rpc import PSServer, _endpoints_from_env

        ep = op.attrs["endpoint"]
        own = os.environ.get("PSERVER_ENDPOINT", "")
        group = _endpoints_from_env()
        if own and own != ep and group and group[0] == ep and own in group:
            ep = own
        server = PSServer(ep, executor, scope, grad_to_block,
                          fanin=int(op.attrs.get("Fanin", 1)),
                          sync_mode=bool(op.attrs.get("sync_mode", True)),
                          block_factory=grad_to_block.get)
        server.serve_forever()
        return
    _EMULATED_SERVERS[op.attrs["endpoint"]] = {
        "executor": executor,
        "scope": scope,
        "grad_to_block": grad_to_block,
    }


def _rpc_client(ep):
    """The client of one endpoint. ``PADDLE_PSERVER_ENDPOINTS`` sliced by
    ``PADDLE_PSERVER_SHARDS`` names the groups: the client of a group's
    primary gets the whole chain (its backups), to fail over along it."""
    from ..distributed.ps_rpc import PSClient, _endpoints_from_env
    from ..distributed.ps_shard import (shards_from_env,
                                        split_endpoint_groups)

    listed = _endpoints_from_env()
    if listed:
        for group in split_endpoint_groups(listed, shards_from_env()):
            if group and group[0] == ep:
                ep = ",".join(group)
                break
    c = PSClient.for_endpoint(
        ep, trainer_id=int(os.environ.get("PADDLE_TRAINER_ID", "0")))
    if _SHARD_MAP["version"]:
        # the adopted map's version rides every rpc (``mv``): a
        # recipient commits a staged range only for a client that saw
        # the donor's bump
        c._map_version_hint = _SHARD_MAP["version"]
    return c


# -- migrated row ranges -------------------------------------------------------

# the adopted shard map: its version and, per table, the moved ranges
# [(global lo, global hi, owner shard, owner-local id of lo)], newest last
_SHARD_MAP: Dict = {"version": 0, "ranges": {}}
_SHARD_MAP_LOCK = threading.Lock()


def adopt_shard_map(payload) -> bool:
    """Adopt a server's shard map when it is newer than the adopted one;
    True when it was."""
    if not isinstance(payload, dict):
        return False
    ver = int(payload.get("version", 0))
    with _SHARD_MAP_LOCK:
        if ver <= _SHARD_MAP["version"]:
            return False
        _SHARD_MAP["version"] = ver
        _SHARD_MAP["ranges"] = {
            str(t): [tuple(int(x) for x in r[:4]) for r in rs]
            for t, rs in (payload.get("ranges") or {}).items()}
    from ..distributed.ps_rpc import PSClient

    with PSClient._lock:
        for c in PSClient._clients.values():
            c._map_version_hint = ver
    return True


def shard_map() -> Dict:
    """A copy of the adopted shard map."""
    with _SHARD_MAP_LOCK:
        return {"version": _SHARD_MAP["version"],
                "ranges": {t: list(rs)
                           for t, rs in _SHARD_MAP["ranges"].items()}}


def reset_shard_map() -> None:
    with _SHARD_MAP_LOCK:
        _SHARD_MAP["version"] = 0
        _SHARD_MAP["ranges"] = {}


def deliver_grad(name, ep, val, trainer_id=None):
    """Push one gradient to a pserver endpoint, in process or over the
    socket RPC. Shared by the sync ``send`` op and the async
    Communicator's flusher."""
    server = _EMULATED_SERVERS.get(ep)
    if server is not None:
        if server.get("mode") == "fl":
            # a federated round: trainers send locally trained PARAMS;
            # once Fanin distinct trainers contributed, the server
            # installs their mean (FedAvg). Keyed by trainer id: a
            # duplicate send from one trainer replaces its entry
            if trainer_id is None:
                trainer_id = int(os.environ.get("PADDLE_TRAINER_ID",
                                                "0"))
            pend = server["pending"].setdefault(name, {})
            pend[trainer_id] = host_array(val)
            if len(pend) >= server["fanin"]:
                write_array(server["executor"], server["scope"], name,
                            np.mean(np.stack(list(pend.values())),
                                    axis=0))
                server["pending"][name] = {}
            return
        write_array(server["executor"], server["scope"], name,
                    host_array(val))
        sub = server["grad_to_block"].get(name)
        if sub is not None:
            server["executor"].run_block(sub, server["scope"])
    elif ep:
        _rpc_client(ep).send_grad(name, host_array(val))
    else:
        raise RuntimeError(
            "send: no server at %r — run the pserver program "
            "(listen_and_serv) first, or use the collective fleet "
            "for multi-host" % ep)


@register_host_op(
    "send",
    inputs=[In("X", duplicable=True, no_grad=True)],
    outputs=[Out("Out", duplicable=True, dispensable=True)],
    attrs={"epmap": [], "sync_mode": True, "table_name": ""},
)
def _send(executor, op, scope):
    eps = op.attrs.get("epmap", [])
    names = op.input("X")
    if not bool(op.attrs.get("sync_mode", True)):
        from ..communicator import global_communicator

        comm = global_communicator()
        if comm is not None and comm.is_running():
            # async mode: the Communicator merges and pushes in the
            # background (the reference's AsyncCommunicator)
            for name, ep in zip(names, eps or [""] * len(names)):
                comm.enqueue(name, ep,
                             host_array(executor._read_var(scope, name)))
            return
    for name, ep in zip(names, eps or [""] * len(names)):
        deliver_grad(name, ep, executor._read_var(scope, name))


@register_host_op(
    "recv",
    inputs=[In("X", duplicable=True, dispensable=True, no_grad=True)],
    outputs=[Out("Out", duplicable=True)],
    attrs={"epmap": [], "table_name": ""},
)
def _recv(executor, op, scope):
    names = op.output("Out")
    eps = op.attrs.get("epmap", [])
    for name, ep in zip(names, eps or [""] * len(names)):
        server = _EMULATED_SERVERS.get(ep)
        if server is not None:
            val = server["executor"]._read_var(server["scope"], name)
            if val is None:
                raise RuntimeError("recv: server %r has no var %r"
                                   % (ep, name))
            write_array(executor, scope, name, host_array(val))
        elif ep:
            write_array(executor, scope, name,
                        _rpc_client(ep).get_param(name))
        else:
            raise RuntimeError("recv: no server at %r" % ep)


@register_host_op(
    "send_barrier",
    inputs=[In("X", duplicable=True, dispensable=True, no_grad=True)],
    outputs=[Out("Out", duplicable=True, dispensable=True)],
    attrs={"endpoints": [], "trainer_id": 0},
)
def _send_barrier(executor, op, scope):
    # the emulation applies sends at once; RPC endpoints need the real
    # barrier to close the sync round
    for ep in op.attrs.get("endpoints", []):
        if ep and ep not in _EMULATED_SERVERS:
            _rpc_client(ep).send_barrier()


@register_host_op(
    "fetch_barrier",
    inputs=[In("X", duplicable=True, dispensable=True, no_grad=True)],
    outputs=[Out("Out", duplicable=True, dispensable=True)],
    attrs={"endpoints": [], "trainer_id": 0},
)
def _fetch_barrier(executor, op, scope):
    for ep in op.attrs.get("endpoints", []):
        if ep and ep not in _EMULATED_SERVERS:
            _rpc_client(ep).fetch_barrier()


# -- distributed sparse tables (the pslib path) ------------------------------
# The table lives ROW-SLICED across pservers; the trainer partitions global
# ids by row range, pulls each server's rows, and pushes merged sparse
# grads back; the server applies its optimize sub-block a push.


def _table_partition(ids_flat, starts, counts, table=None):
    """Yield (ep_index, mask, local_rows) per hosting server: the
    transpiler's row slices, then the adopted moved ranges of ``table``.
    ``ids_flat`` may be int32 (the JAX package's ids with x64 off) or
    int64: the rows are the same either way."""
    ids = np.asarray(ids_flat).astype(np.int64)
    owner = np.full(ids.shape, -1, dtype=np.int64)
    local = np.zeros(ids.shape, dtype=np.int64)
    for k, (s, c) in enumerate(zip(starts, counts)):
        m = (ids >= s) & (ids < s + c)
        owner[m] = k
        local[m] = ids[m] - s
    if table is not None:
        with _SHARD_MAP_LOCK:
            moved = list(_SHARD_MAP["ranges"].get(table, ()))
        for lo, hi, shard, base in moved:
            m = (ids >= lo) & (ids < hi)
            owner[m] = shard
            local[m] = base + ids[m] - lo
    for k in range(len(starts)):
        mask = owner == k
        if mask.any():
            yield k, mask, local[mask]


def pull_table_rows(table, ids, starts, counts, endpoints, width,
                    dtype="float32", var=None) -> np.ndarray:
    """Rows ``ids`` (global) of ``var`` (default ``table``, or one of its
    row-sliced companions) from the servers holding them, routed by the
    transpiler's slices and the adopted moved ranges of ``table``; a
    ``wrong_shard`` answer adopts the server's map and the pull re-runs
    (a pull is idempotent)."""
    flat = np.asarray(ids).reshape(-1).astype(np.int64)
    var = var or table
    for _ in range(len(endpoints) + 2):
        out = np.zeros((flat.size, int(width)), dtype=np.dtype(dtype))
        try:
            for k, mask, local in _table_partition(flat, starts, counts,
                                                   table):
                ep = endpoints[k]
                server = _EMULATED_SERVERS.get(ep)
                if server is not None:
                    out[mask] = _emulated_pull(server, var, local)
                else:
                    out[mask] = _rpc_client(ep).pull_sparse(var, local)
            return out
        except WrongShard as e:
            adopt_shard_map(e.shard_map)
    raise RuntimeError("pull of %r still redirected after %d wrong_shard "
                       "answers (map version %d)"
                       % (table, len(endpoints) + 2,
                          _SHARD_MAP["version"]))


def _emulated_pull(server, name, local_rows):
    tbl = server["executor"]._read_var(server["scope"], name)
    if tbl is None:
        raise RuntimeError("pull_sparse: server has no table %r" % name)
    return gather_rows(tbl, local_rows)


def _emulated_push(server, grad_name, param_name, local_rows, values):
    exe = server["executor"]
    tbl = exe._read_var(server["scope"], param_name)
    height = int(tbl.shape[0]) if tbl is not None \
        else int(local_rows.max()) + 1
    exe._write_var(server["scope"], grad_name,
                   selected_rows(exe, local_rows, values, height))
    sub = server["grad_to_block"].get(grad_name)
    if sub is not None:
        exe.run_block(sub, server["scope"])


@register_host_op(
    "distributed_lookup_table",
    inputs=[In("Ids", no_grad=True), In("W", dispensable=True,
                                        no_grad=True)],
    outputs=[Out("Outputs")],
    attrs={"table_name": "", "endpoints": [], "row_starts": [],
           "row_counts": [], "embed_dim": 0, "padding_idx": -1,
           "squeeze_last": True, "dtype": "float32"},
)
def _distributed_lookup_table(executor, op, scope):
    """Sparse pull: route each id to the pserver hosting its row block,
    pull its rows, reassemble [ids shape..., D]."""
    ids = host_array(executor._read_var(scope, op.input("Ids")[0]))
    squeeze = bool(op.attrs.get("squeeze_last", True)) \
        and ids.ndim >= 2 and ids.shape[-1] == 1
    out_shape = (tuple(ids.shape[:-1]) if squeeze else tuple(ids.shape))
    flat = ids.reshape(-1).astype(np.int64)
    d = int(op.attrs["embed_dim"])
    _counter("ps.rows_pulled").inc(int(flat.size))
    out = pull_table_rows(op.attrs["table_name"], flat,
                          op.attrs["row_starts"], op.attrs["row_counts"],
                          op.attrs["endpoints"], d,
                          op.attrs.get("dtype", "float32"))
    pad = int(op.attrs.get("padding_idx", -1))
    if pad >= 0:
        out[flat == pad] = 0.0
    write_array(executor, scope, op.output("Outputs")[0],
                out.reshape(out_shape + (d,)))


@register_host_op(
    "distributed_push_sparse",
    inputs=[In("Ids", no_grad=True), In("OutGrad", no_grad=True)],
    outputs=[],
    attrs={"table_name": "", "grad_name": "", "endpoints": [],
           "row_starts": [], "row_counts": [], "padding_idx": -1,
           "squeeze_last": True},
)
def _distributed_push_sparse(executor, op, scope):
    """Sparse push: merge duplicate ids on the trainer (the reference's
    MergeAdd before a push), partition by row range, push each server its
    local (rows, grads); the server applies its optimizer sub-block."""
    ids = host_array(executor._read_var(scope, op.input("Ids")[0]))
    og = host_array(executor._read_var(scope, op.input("OutGrad")[0]))
    flat = ids.reshape(-1).astype(np.int64)
    d = og.shape[-1]
    vals = og.reshape(-1, d)
    pad = int(op.attrs.get("padding_idx", -1))
    if pad >= 0:
        keep = flat != pad
        flat, vals = flat[keep], vals[keep]
    uniq, inv = np.unique(flat, return_inverse=True)
    merged = np.zeros((uniq.size, d), dtype=vals.dtype)
    np.add.at(merged, inv, vals)
    table = op.attrs["table_name"]
    gname = op.attrs.get("grad_name") or (table + "@GRAD")
    eps = op.attrs["endpoints"]
    _counter("ps.rows_pushed").inc(int(uniq.size))
    # a server answering ``wrong_shard`` applied none of its slice (the
    # redirect is all or nothing): only that slice is pushed again, under
    # the adopted map
    pending = np.arange(uniq.size, dtype=np.int64)
    for _ in range(len(eps) + 2):
        if not pending.size:
            return
        redirected = []
        for k, mask, local in _table_partition(
                uniq[pending], op.attrs["row_starts"],
                op.attrs["row_counts"], table):
            ep = eps[k]
            sel = pending[mask]
            server = _EMULATED_SERVERS.get(ep)
            if server is not None:
                _emulated_push(server, gname, table, local, merged[sel])
                continue
            try:
                _rpc_client(ep).push_sparse(gname, local, merged[sel],
                                            param=table)
            except WrongShard as e:
                adopt_shard_map(e.shard_map)
                redirected.append(sel)
        pending = (np.concatenate(redirected) if redirected
                   else np.empty(0, dtype=np.int64))
    raise RuntimeError("push of %r: %d rows still redirected after %d "
                       "wrong_shard answers" % (table, pending.size,
                                                len(eps) + 2))


# scope -> {table@epmap: count}; weak keys, so a dead trainer scope's
# counters go with it
_GEO_COUNTERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@register_host_op(
    "geo_send",
    inputs=[In("Param", no_grad=True), In("Snapshot", no_grad=True)],
    outputs=[Out("SnapshotOut")],
    attrs={"epmap": [], "table_name": "", "push_nums": 100, "trainers": 1},
)
def _geo_send(executor, op, scope):
    """Geo-SGD delta push (the reference's GeoSgdCommunicator): every
    ``push_nums`` calls, ship (param - snapshot) to the hosting pserver,
    which applies param += delta, and refresh the snapshot; other calls
    bump a counter. As in the JAX package, the delta goes to an
    in-process server only: there is no RPC route for it."""
    table = op.attrs.get("table_name", "")
    # per-trainer cadence: counters live per calling scope
    key = "%s@%s" % (table, ",".join(op.attrs.get("epmap", [])))
    counters = _GEO_COUNTERS.setdefault(scope, {})
    counters[key] = counters.get(key, 0) + 1
    if counters[key] % max(int(op.attrs.get("push_nums", 100)), 1):
        return
    ep = (op.attrs.get("epmap") or [""])[0]
    server = _EMULATED_SERVERS.get(ep)
    if server is None:
        raise RuntimeError(
            "geo_send: no server at %r — run the pserver program first"
            % ep)
    param = host_array(executor._read_var(scope, op.input("Param")[0]))
    snap = host_array(executor._read_var(scope, op.input("Snapshot")[0]))
    dname = "%s.geo.delta" % table
    sexe, sscope = server["executor"], server["scope"]
    write_array(sexe, sscope, dname, param - snap)
    sub = server["grad_to_block"].get(dname)
    if sub is not None:
        # param += delta through the server's optimize sub-block
        sexe.run_block(sub, sscope)
    else:
        cur = host_array(sexe._read_var(sscope, table))
        write_array(sexe, sscope, table, cur + (param - snap))
    write_array(executor, scope, op.output("SnapshotOut")[0], param)


def reset_geo_counters():
    _GEO_COUNTERS.clear()


@register_host_op(
    "ref_by_trainer_id",
    inputs=[In("X", duplicable=True, no_grad=True),
            In("TrainerId", no_grad=True)],
    outputs=[Out("Out")])
def _ref_by_trainer_id(executor, op, scope):
    """Select X[trainer_id] (the reference's ref_by_trainer_id_op.h)."""
    tid = int(host_array(
        executor._read_var(scope, op.input("TrainerId")[0])).reshape(-1)[0])
    names = op.input("X")
    if not 0 <= tid < len(names):
        raise IndexError("trainer id %d out of range for %d inputs"
                         % (tid, len(names)))
    executor._write_var(scope, op.output("Out")[0],
                        executor._read_var(scope, names[tid]))


@register_host_op(
    "fl_listen_and_serv",
    inputs=[In("X", duplicable=True, dispensable=True, no_grad=True)],
    outputs=[],
    attrs={"endpoint": "", "optimize_blocks": [], "sync_mode": True,
           "Fanin": 1},
)
def _fl_listen_and_serv(executor, op, scope):
    """Federated-learning server round (the reference's
    fl_listen_and_serv_op.cc): trainers GET the global params, train
    locally and SEND their params back; once Fanin copies of a param
    arrived the server installs their FedAvg mean (``deliver_grad``'s fl
    mode)."""
    _EMULATED_SERVERS[op.attrs["endpoint"]] = {
        "executor": executor,
        "scope": scope,
        "grad_to_block": {},
        "mode": "fl",
        "fanin": int(op.attrs.get("Fanin", 1)),
        "pending": {},
    }
