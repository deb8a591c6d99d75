"""Lazy (queued) dygraph dispatch: one flush a step, one CUDA graph a step.

Counterpart of ``paddle_tpu/dygraph/lazy.py:1-325``. Ops queue as nodes;
VarBase values become ``PendingValue`` s whose shape and dtype are known
(from the op run on ``meta`` tensors) and whose value is not; a FLUSH runs
the queued graph and materializes only the values a live VarBase (or a
tape record) still holds. Flush triggers, as in the JAX package: a host
read (``numpy()``, ``float()``, ``gradient()``), ``optimizer.minimize``
(the step boundary), the end of a guard, and the ``MAX_NODES`` valve,
which flushes conservatively (everything materializes: owners are not
attached yet when it fires).

A flush is keyed by its structure, the JAX package's key: each node's
signature and wiring, the outputs needed, the external inputs' shapes and
dtypes, and here also how each backward node reaches its forward and
which updated values go back into their input's buffer. Where the JAX
package jits one replay a key, this engine

- on the CPU runs the queued nodes in order, every flush (a repeated key
  still counts a cache hit);
- on the card runs a key's first flush eagerly and captures its second
  into a CUDA graph (``core/cuda_graph``, as the whole-program route
  does); later flushes of the key replay it. External values (parameters, optimizer state,
  the step's ``[1]`` learning-rate tensor, inputs) are copied into the
  graph's static input buffers before a replay, unless a buffer already
  is that tensor. A needed output that replaces an external input in
  its owner (a parameter's or a moment's update: ``PendingValue.replaces``)
  is written into that input's buffer at the end of the captured region
  and handed out as the buffer itself, so the next step's input needs no
  copy; any other needed output is cloned out of the pool. A key seen
  once never captures.

Memory caps the live graphs, not the structural keys: an engine's
graphs share one memory pool, whose size is the largest step's working
set, and at most ``core/cuda_graph.GRAPH_CAP`` of them (LRU) stay
captured; an evicted key's next flush captures again. ``JIT_CACHE_CAP``
structural keys are remembered, as in the JAX package.

Backward without a second forward: a backward node (queued by a tape
record's ``lazy_vjp``) names its forward node. When both are in one flush
the forward runs with autograd on over its differentiable inputs and the
backward pulls the cotangents through that saved graph
(``torch.autograd.grad``); the last backward node to use it frees it.
When the forward was flushed earlier (a host read mid-step, the valve),
the backward node runs the forward again from its inputs, with the same
seed, as the JAX package's backward node always does.

RNG: an RNG op's node carries its seed (the tracer's per-op seed) outside
the key. Eagerly it draws from a generator seeded with it; a captured
graph registers one generator per RNG node and seeds it before every
replay, so a replay draws the step's own numbers.

Counters (``COUNTERS``, as ``core/compiler_engine`` keeps its own, each
also counted in the observability registry, so a process's dump carries
them): ``lazy.flushes``, ``lazy.graph_nodes`` (nodes flushed),
``lazy.recompiles`` (a new structural key), ``lazy.cache_hits``, and on
the card ``lazy.captures`` and ``lazy.replays``.

Policy steering: a ``JIT_CACHE_CAP`` below the working set of keys turns
the steady state into evictions and recaptures (``lazy.recompiles`` grows,
``lazy.cache_hits`` stalls). ``plan_lazy_policy`` turns those counts into
``{"jit_cache_cap": N}`` (the ``lazy_policy`` steerer), and
``apply_lazy_policy`` installs a promoted plan.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from .. import observability as _obs
from ..core.cuda_graph import CapturedGraph, GraphCache, same_memory

__all__ = ["PendingValue", "LazyEngine", "is_pending", "aval_of",
           "counters", "reset_counters", "plan_lazy_policy",
           "apply_lazy_policy", "JIT_CACHE_CAP_MAX"]

COUNTERS: Dict[str, int] = {"lazy.flushes": 0, "lazy.graph_nodes": 0,
                            "lazy.recompiles": 0, "lazy.cache_hits": 0,
                            "lazy.captures": 0, "lazy.replays": 0}
_counters_lock = threading.Lock()


def _inc(name: str, n: int = 1) -> None:
    with _counters_lock:
        COUNTERS[name] += n
    _obs.inc(name, n)


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(COUNTERS)


def reset_counters() -> None:
    with _counters_lock:
        for k in COUNTERS:
            COUNTERS[k] = 0


# captured graphs' input buffers that are handed out as values (updated
# parameters and state): id -> weakref. A replay overwrites them in place,
# so ``VarBase.detach`` / ``clone`` copy such a tensor.
_state_buffers: Dict[int, "weakref.ref"] = {}


def is_state_buffer(t: torch.Tensor) -> bool:
    r = _state_buffers.get(id(t))
    return r is not None and r() is t


def is_pending(x) -> bool:
    return isinstance(x, PendingValue)


def aval_of(h) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, dtype) of a handle, a tensor or a pending value."""
    return tuple(h.shape), h.dtype


class PendingValue:
    """Placeholder for a value not computed yet. Shape and dtype read
    without a flush; a value read flushes."""

    __slots__ = ("shape", "dtype", "value", "_resolved", "engine",
                 "_owners", "_pinned", "replaces", "_pos", "__weakref__")

    def __init__(self, shape, dtype, engine, pos=None):
        self._pos = pos           # (node, output) in its engine's batch
        self.shape = tuple(shape)
        self.dtype = dtype
        self.value = None
        self._resolved = False
        self.engine = engine
        self._owners: List = []   # [(weakref(obj), attr or None)]
        self._pinned = False      # force() in flight: must materialize
        self.replaces = None      # the tensor this value replaced

    def add_owner(self, obj, attr: Optional[str]):
        """attr None: needed while obj is alive (tape records); otherwise
        needed while ``getattr(obj, attr) is self``."""
        self._owners.append((weakref.ref(obj), attr))

    def is_needed(self) -> bool:
        if self._pinned:
            return True
        for ref, attr in self._owners:
            o = ref()
            if o is None:
                continue
            if attr is None or getattr(o, attr, None) is self:
                return True
        return False

    def force(self) -> torch.Tensor:
        if not self._resolved:
            # forcing proves the value is needed, whoever holds it
            self._pinned = True
            self.engine.flush()
        if not self._resolved:
            raise RuntimeError("pending value did not resolve on flush")
        if self.value is None:
            raise RuntimeError(
                "pending value was dead at flush time (no live owner) "
                "but was read later")
        return self.value

    def __repr__(self):
        return "PendingValue(shape=%s, dtype=%s, resolved=%s)" % (
            self.shape, self.dtype, self._resolved)


class _Node:
    """One queued computation. ``fn(vals, generator) -> tuple``. A forward
    op node may carry ``wrt`` (its differentiable input positions) and
    ``seed`` (an RNG op's seed); a backward node carries ``fwd`` (its
    forward node) and ``cots`` (the forward outputs its cotangents, the
    inputs after ``fwd.ins``, belong to)."""

    __slots__ = ("fn", "ins", "outs", "sig", "wrt", "seed", "fwd", "cots",
                 "batch", "idx", "wiring", "mode")

    def __init__(self, fn, ins, outs, sig, wrt=None, seed=None, fwd=None,
                 cots=None):
        self.fn = fn
        self.ins = ins
        self.outs = outs
        self.sig = sig
        self.wrt = wrt
        self.seed = seed
        self.fwd = fwd
        self.cots = cots
        # set by the engine: the batch (flush) and position it joined, its
        # inputs' wiring and, for a backward node, how it reaches its
        # forward
        self.batch = self.idx = self.wiring = self.mode = None


class _Plan:
    """How one structural key runs: each node's input wiring and mode
    (None: plain; "G": forward with its autograd graph kept; ("L", i,
    last): backward through node i's graph, freeing it when last; ("R",):
    backward that runs its forward again), the outputs to hand out, the
    outputs written back into an input's buffer, the RNG nodes, and after
    each node the outputs nothing later reads (freed there, so a captured
    step's pool holds its working set, not every intermediate)."""

    __slots__ = ("wiring", "modes", "needed", "pairs", "rng", "drops",
                 "runs")

    def __init__(self, nodes, modes, needed, pairs, rng):
        self.wiring = tuple(nd.wiring for nd in nodes)
        self.modes = modes
        self.needed = needed
        self.pairs = pairs
        self.rng = rng
        last: Dict[Tuple[int, int], int] = {}
        for k, nd in enumerate(nodes):
            for e in _reads(nd, modes[k], nd.wiring):
                if e[0] == "n":
                    last[e[1:]] = k
            for oj in range(len(nd.outs)):
                last.setdefault((k, oj), k)
        drops: List[List] = [[] for _ in nodes]
        keep = set(needed)
        for pos, k in last.items():
            if pos not in keep:
                drops[k].append(pos)
        self.drops = tuple(tuple(d) for d in drops)
        self.runs = 0


def _reads(nd: _Node, mode, vals):
    """What of a node's inputs it reads: a backward through its forward's
    saved graph reads its cotangents alone."""
    if isinstance(mode, tuple) and mode[0] == "L":
        return vals[len(nd.fwd.ins):]
    return vals


def _forward_graph(nd: _Node, vals, gen):
    """Run a forward node with autograd on over its ``wrt`` inputs:
    (leaves, outputs with their graph)."""
    vv = list(vals)
    leaves = []
    for p in nd.wrt:
        leaf = vv[p].detach().requires_grad_(True)
        vv[p] = leaf
        leaves.append(leaf)
    with torch.enable_grad():
        outs = nd.fn(vv, gen)
    return leaves, outs


def pull(leaves, outs, cots, retain=False, create_graph=False):
    """The grads of ``leaves`` given cotangents of ``outs`` (None where an
    output has none); an output that does not depend on a leaf, or a
    leaf that no output depends on, contributes zeros."""
    ys, gs = [], []
    for y, c in zip(outs, cots):
        if c is None or not (isinstance(y, torch.Tensor)
                             and y.requires_grad):
            continue
        ys.append(y)
        gs.append(c)
    if not ys:
        return tuple(torch.zeros_like(x) for x in leaves)
    grads = torch.autograd.grad(ys, leaves, gs, retain_graph=retain,
                                create_graph=create_graph, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads))


def _cots_for(nd: _Node, cot_vals):
    cots = [None] * len(nd.fwd.outs)
    for j, c in zip(nd.cots, cot_vals):
        cots[j] = c
    return cots


def _run_nodes(nodes: List[_Node], plan: _Plan, ext_vals, gens) -> List:
    """Run a flush's nodes in order over the external values."""
    results: List = []
    saved: Dict[int, Tuple] = {}
    for ni, nd in enumerate(nodes):
        mode = plan.modes[ni]
        vals = [ext_vals[e[1]] if e[0] == "e" else results[e[1]][e[2]]
                for e in _reads(nd, mode, plan.wiring[ni])]
        gen = gens.get(ni)
        if mode is None:
            out = nd.fn(vals, gen)
        elif mode == "G":
            leaves, outs = _forward_graph(nd, vals, gen)
            saved[ni] = (leaves, outs)
            out = tuple(o.detach() if isinstance(o, torch.Tensor) else o
                        for o in outs)
        elif mode[0] == "L":
            leaves, outs = saved[mode[1]]
            if mode[2]:
                del saved[mode[1]]
            out = pull(leaves, outs, _cots_for(nd, vals),
                       retain=not mode[2])
        else:  # "R": the forward ran in an earlier flush
            n = len(nd.fwd.ins)
            leaves, outs = _forward_graph(nd.fwd, vals[:n], gen)
            out = pull(leaves, outs, _cots_for(nd, vals[n:]))
        results.append(list(out))
        for pj, oj in plan.drops[ni]:
            results[pj][oj] = None
    return results


class _Graph(CapturedGraph):
    """One captured flush: the graph, its static input buffers, the
    outputs it hands out (in the pool), its generators and its kernel
    launches."""

    def __init__(self, eng: "LazyEngine", plan: _Plan, nodes, ext):
        self.plan = plan
        self.bufs = []
        for t in ext:
            b = torch.empty_like(t)
            b.copy_(t)
            self.bufs.append(b)
        for k in plan.pairs.values():
            _state_buffers[id(self.bufs[k])] = weakref.ref(self.bufs[k])
        self.gens = {ni: torch.Generator(device=eng.device)
                     for ni in plan.rng}
        self.outs: Dict = self.capture(eng.graphs,
                                       lambda: self._body(nodes),
                                       self.gens.values())

    def _body(self, nodes) -> Dict:
        """The captured region: the nodes over the buffers, the outputs to
        hand out, then each updated value written into its input's
        buffer."""
        plan = self.plan
        results = _run_nodes(nodes, plan, self.bufs, self.gens)
        paired = {self.bufs[k].untyped_storage().data_ptr()
                  for k in plan.pairs.values()}
        outs = {}
        for ni, oj in plan.needed:
            if (ni, oj) in plan.pairs:
                continue
            v = results[ni][oj]
            # a view of a buffer written below keeps its value
            if v.untyped_storage().data_ptr() in paired:
                v = v.clone()
            outs[(ni, oj)] = v
        for (ni, oj), k in plan.pairs.items():
            v, buf = results[ni][oj], self.bufs[k]
            if not same_memory(v, buf):
                buf.copy_(v)
        return outs

    def stage(self, ext) -> None:
        for t, buf in zip(ext, self.bufs):
            if t is not buf:
                buf.copy_(t)

    def replay(self, seeds: Dict[int, int]) -> Dict:
        for ni, g in self.gens.items():
            g.manual_seed(seeds[ni])
        self.launch()
        _inc("lazy.replays")
        vals = {pos: v.clone() for pos, v in self.outs.items()}
        for pos, k in self.plan.pairs.items():
            vals[pos] = self.bufs[k]
        return vals

    def release(self) -> None:
        for k in self.plan.pairs.values():
            _state_buffers.pop(id(self.bufs[k]), None)


class LazyEngine:
    """Queue of nodes, the structural plan cache and, on the card, the
    captured graphs."""

    MAX_NODES = 4000      # safety valve: auto-flush beyond this
    JIT_CACHE_CAP = 64    # structural keys remembered

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        # what captures a key's second flush: a CUDA graph on the card,
        # nothing on the CPU (every flush runs eagerly)
        self.graph_cls = _Graph if self.device.type == "cuda" else None
        # the batch being queued: its nodes, its external inputs (tensors
        # by first use) and, per forward node, its last backward node
        self.nodes: List[_Node] = []
        self._ext: List[torch.Tensor] = []
        self._ext_ids: Dict[int, int] = {}
        self._last_use: Dict[int, int] = {}
        self._batch = 0
        self._jit_cache: "OrderedDict" = OrderedDict()
        self.graphs = GraphCache(self.device)
        self._flushing = False
        # optimizer-op shape cache (backward_utils._lazy_opt_op)
        self._opt_aval_cache: Dict = {}

    # -- graph building ---------------------------------------------------
    def add_node(self, fn, in_handles, out_avals, sig, wrt=None, seed=None,
                 fwd=None, cots=None) -> _Node:
        ni = len(self.nodes)
        outs = [PendingValue(s, d, self, (ni, j))
                for j, (s, d) in enumerate(out_avals)]
        nd = _Node(fn, list(in_handles), outs, sig, wrt, seed, fwd, cots)
        # the wiring, as the flush's key reads it: an unresolved pending
        # was made in this batch (every flush resolves all of its own)
        w = []
        for h in nd.ins:
            if isinstance(h, PendingValue):
                if not h._resolved:
                    w.append(("n",) + h._pos)
                    continue
                if h.value is None:
                    raise RuntimeError(
                        "pending value was dead at flush time (no live "
                        "owner) but was read later")
                h = h.value
            k = self._ext_ids.get(id(h))
            if k is None:
                k = len(self._ext)
                self._ext_ids[id(h)] = k
                self._ext.append(h)
            w.append(("e", k))
        nd.batch, nd.idx, nd.wiring = self._batch, ni, tuple(w)
        if fwd is not None:
            if fwd.batch == self._batch:
                nd.mode = ("L", fwd.idx)
                self._last_use[fwd.idx] = ni
            else:
                nd.mode = ("R",)
        self.nodes.append(nd)
        if len(self.nodes) >= self.MAX_NODES:
            # owners attach after add_node returns, and mid-backward
            # cotangents live in local dicts: liveness is unknowable
            # here, so materialize everything
            self.flush(conservative=True)
        return nd

    def add(self, a, b) -> PendingValue:
        """a + b, queued (a grad sum)."""
        shape, dtype = aval_of(a)
        return self.add_node(lambda vals, gen: (vals[0] + vals[1],), [a, b],
                             [(shape, dtype)],
                             ("grad_add", shape, str(dtype))).outs[0]

    def ones_like(self, h) -> PendingValue:
        """Ones of h's shape and dtype, queued (a backward's seed)."""
        shape, dtype = aval_of(h)
        dev = self.device
        return self.add_node(
            lambda vals, gen: (torch.ones(shape, dtype=dtype, device=dev),),
            [], [(shape, dtype)], ("ones", shape, str(dtype))).outs[0]

    # -- flush ------------------------------------------------------------
    def flush(self, conservative=False):
        if self._flushing or not self.nodes:
            return
        self._flushing = True
        try:
            self._flush_impl(conservative)
        finally:
            self._flushing = False

    def _flush_impl(self, conservative=False):
        nodes, ext, last_use = self.nodes, self._ext, self._last_use
        self.nodes, self._ext, self._ext_ids, self._last_use = [], [], {}, {}
        self._batch += 1
        _inc("lazy.flushes")
        _inc("lazy.graph_nodes", len(nodes))
        modes = [nd.mode for nd in nodes]
        for fi in last_use:
            modes[fi] = "G"
        modes = [("L", m[1], last_use[m[1]] == ni)
                 if isinstance(m, tuple) and m[0] == "L" else m
                 for ni, m in enumerate(modes)]
        ext_ids = {id(t): k for k, t in enumerate(ext)}

        needed = tuple(p._pos for nd in nodes for p in nd.outs
                       if conservative or p.is_needed())
        pairs: Dict[Tuple[int, int], int] = {}
        taken = set()
        for ni, oj in needed:
            p = nodes[ni].outs[oj]
            k = ext_ids.get(id(p.replaces)) if p.replaces is not None \
                else None
            if k is None or ext[k] is not p.replaces or k in taken or \
                    aval_of(ext[k]) != (p.shape, p.dtype):
                continue
            pairs[(ni, oj)] = k
            taken.add(k)
        # a node draws with its own seed, a backward that runs its
        # forward again with the forward's
        seeds: Dict[int, int] = {}
        for ni, nd in enumerate(nodes):
            m = modes[ni]
            src = nd.fwd if m == ("R",) else nd if m in (None, "G") \
                else None
            if src is not None and src.seed is not None:
                seeds[ni] = src.seed
        key = (tuple((nd.sig, nd.wiring, m) for nd, m in zip(nodes, modes)),
               needed,
               tuple((tuple(t.shape), t.dtype, t.device) for t in ext),
               tuple(sorted(pairs.items())))

        plan = self._jit_cache.get(key)
        if plan is not None:
            self._jit_cache.move_to_end(key)
            _inc("lazy.cache_hits")
        else:
            # a new structure: on the card, a new eager run and capture
            # of the whole queued step (signature churn shows here)
            from ..analysis import verify_enabled

            if verify_enabled():
                # the wiring of the graph about to run, checked once a
                # structure (PADDLE_TPU_VERIFY_IR)
                from ..analysis import verify_lazy_graph

                verify_lazy_graph([nd.wiring for nd in nodes],
                                  [len(nd.outs) for nd in nodes], len(ext),
                                  needed)
            _inc("lazy.recompiles")
            plan = _Plan(nodes, tuple(modes), needed, dict(pairs),
                         tuple(sorted(seeds)))
            self._jit_cache[key] = plan
            while len(self._jit_cache) > self.JIT_CACHE_CAP:
                old, _ = self._jit_cache.popitem(last=False)
                self.graphs.drop(old)

        if self.graph_cls is not None:
            values = self._run_captured(key, plan, nodes, ext, seeds)
        else:
            values = self._run_eager(plan, nodes, ext, seeds)
        for ni, nd in enumerate(nodes):
            for oj, p in enumerate(nd.outs):
                p.value = values.get((ni, oj))
                p._resolved = True
                p._owners = []
                p.replaces = None
                p.engine = None   # a VarBase may outlive the engine

    def _run_eager(self, plan, nodes, ext, seeds) -> Dict:
        gens = {}
        for ni, s in seeds.items():
            g = torch.Generator(device=self.device)
            g.manual_seed(s)
            gens[ni] = g
        results = _run_nodes(nodes, plan, ext, gens)
        return {(ni, oj): results[ni][oj] for ni, oj in plan.needed}

    def _run_captured(self, key, plan, nodes, ext, seeds) -> Dict:
        graph = self.graphs.get(key)
        if graph is not None:
            graph.stage(ext)
        else:
            plan.runs += 1
            if plan.runs == 1:
                return self._run_eager(plan, nodes, ext, seeds)
            _inc("lazy.captures")
            graph = self.graph_cls(self, plan, nodes, ext)
            self.graphs.put(key, graph)
        return graph.replay(seeds)

    def close(self) -> None:
        """Free the captured graphs (the pool returns to the device at the
        caller's ``torch.cuda.empty_cache()``)."""
        self.graphs.clear()
        self._jit_cache.clear()


# -- the recapture-against-reuse policy --------------------------------------------

JIT_CACHE_CAP_MAX = 512


def plan_lazy_policy(recompiles, cache_hits, cache_cap=None):
    """A structural-key cap from observed recompile and hit counts: double
    the cap (up to ``JIT_CACHE_CAP_MAX``) while recompiles are most of the
    flushes and outnumber the cap (a working set larger than the cache);
    keep it otherwise."""
    cap = int(cache_cap if cache_cap is not None
              else LazyEngine.JIT_CACHE_CAP)
    r, h = max(0, int(recompiles)), max(0, int(cache_hits))
    total = r + h
    frac = (r / total) if total else 0.0
    new_cap = cap
    if total and frac > 0.5 and r > cap:
        new_cap = min(JIT_CACHE_CAP_MAX, cap * 2)
    return {"jit_cache_cap": new_cap, "prev_cap": cap,
            "recompile_frac": round(frac, 6),
            "recompiles": r, "cache_hits": h}


def _steer_lazy_policy(report, recompiles=None, cache_hits=None,
                       cache_cap=None, **_ctx):
    """``steer("lazy_policy", report, ...)``: the counts come from the
    context (the daemon reads them off merged counters), else from this
    process's ``counters()``."""
    if recompiles is None or cache_hits is None:
        c = counters()
        recompiles = c["lazy.recompiles"]
        cache_hits = c["lazy.cache_hits"]
    return plan_lazy_policy(recompiles, cache_hits, cache_cap=cache_cap)


def apply_lazy_policy(plan, engine_cls=None):
    """Install a promoted policy plan: the class-level structural-key cap
    (a canary's apply and rollback hooks call it with the proposed and the
    incumbent plan)."""
    cls = engine_cls or LazyEngine
    cap = int(plan["jit_cache_cap"])
    if not 1 <= cap <= JIT_CACHE_CAP_MAX:
        raise ValueError("jit_cache_cap %d outside [1, %d]"
                         % (cap, JIT_CACHE_CAP_MAX))
    cls.JIT_CACHE_CAP = cap
    return cap


from ..observability import steering as _steering  # noqa: E402

_steering.register_steerer(
    "lazy_policy", _steer_lazy_policy,
    "structural-key cap of the lazy queue from its flush counters")
