"""Paged KV-cache manager: fixed-size blocks over ONE preallocated arena.

Counterpart of ``paddle_tpu/serving/decode/kvcache.py``. An autoregressive
batch is ragged and churns: sequences join, grow one token a step and leave
at unpredictable lengths. Fixed-size blocks over one arena make allocation
a pop from a free list, growth at most one new block per token step, and a
leaving sequence's blocks free for the next admit at once.

The block accounting stays in Python on the host, as in the reference: the
free list, each sequence's blocks and length, ``reserve``, ``release``,
``check`` and ``block_table``. The arenas live on the cache's device:
K and V are ``[num_layers, num_blocks, block_tokens, num_heads, head_dim]``
in the storage type, and int8 scales ``[num_layers, num_blocks, num_heads]``
per side.

Storage (``dtype``): ``f32``; ``bf16``, held as ``torch.bfloat16``, whose
round-to-nearest-even conversion gives the reference's uint16 patterns bit
for bit; ``int8``, EQuARX-style shared-scale codes, one scale per (layer,
block, head, k|v). A row that raises a block's amax requantizes the block's
earlier codes in place, so every code of a block shares one scale. The
rounding compounds token by token, so the order of the writes matters: a
write of many tokens stores them in rounds, the r-th round taking each
block's r-th new token, all blocks at once. Blocks never interact, so this
gives the codes and scales of writing the tokens one at a time, and it
takes one round for a decode step (one token per sequence) and at most
``block_tokens`` rounds for a prompt chunk.

Thread contract: the decode engine mutates the cache only from its step
thread; readers of ``stats()``/``occupancy()`` take the same lock the
mutators do.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import CUDAPlace

__all__ = ["KVCacheConfig", "PagedKVCache", "KVCacheFull", "Slots"]


class KVCacheFull(RuntimeError):
    """No free block: the arena is exhausted. The scheduler's move, not the
    cache's: preempt a lower-priority sequence or defer the admit; the
    cache itself never evicts silently."""


class KVCacheConfig:
    """Arena geometry + storage type.

    ``num_blocks * block_tokens`` is the total token capacity shared by
    every resident sequence; ``dtype`` is the STORAGE format (compute is
    always float32): ``f32``, ``bf16`` (2x capacity per byte) or ``int8``
    (shared-scale codes, 4x)."""

    DTYPES = ("f32", "bf16", "int8")

    def __init__(self, num_blocks: int = 64, block_tokens: int = 16,
                 num_layers: int = 1, num_heads: int = 2,
                 head_dim: int = 8, dtype: str = "f32"):
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        if min(self.num_blocks, self.block_tokens, self.num_layers,
               self.num_heads, self.head_dim) < 1:
            raise ValueError("all KVCacheConfig dims must be >= 1")
        if dtype not in self.DTYPES:
            raise ValueError("dtype must be one of %s, got %r"
                             % (self.DTYPES, dtype))
        self.dtype = dtype

    @property
    def capacity_tokens(self) -> int:
        return self.num_blocks * self.block_tokens

    def arena_bytes(self) -> int:
        """Total K+V arena bytes (scales excluded)."""
        per_val = {"f32": 4, "bf16": 2, "int8": 1}[self.dtype]
        return (2 * self.num_layers * self.num_blocks
                * self.block_tokens * self.num_heads * self.head_dim
                * per_val)


class _Seq:
    __slots__ = ("blocks", "length")

    def __init__(self):
        self.blocks: List[int] = []
        self.length = 0


_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}


def to_device(values, dtype, device: torch.device) -> torch.Tensor:
    """A host list or array as a tensor on ``device``. To the card it goes
    from pinned memory without blocking the host, so the step thread keeps
    queueing work while the card runs."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class Slots:
    """The arena slots of the tokens one write stores, made once and used
    for every layer: for each round, the rows of the write it takes and
    their (block, offset), on the cache's device. For f32 and bf16 one
    round holds every token."""

    __slots__ = ("rounds", "count")

    def __init__(self, rounds, count: int):
        self.rounds = rounds
        self.count = count


class PagedKVCache:
    """The arenas + block tables; see the module docstring. ``place`` is
    where the arenas live: the card (``CUDAPlace(0)``) unless the caller
    asks for ``CPUPlace()``."""

    def __init__(self, config: Optional[KVCacheConfig] = None, place=None):
        self.config = c = config or KVCacheConfig()
        self.place = place if place is not None else CUDAPlace(0)
        self.device = dev = self.place.device()
        shape = (c.num_layers, c.num_blocks, c.block_tokens,
                 c.num_heads, c.head_dim)
        storage = _STORAGE[c.dtype]
        self.k_arena = torch.zeros(shape, dtype=storage, device=dev)
        self.v_arena = torch.zeros(shape, dtype=storage, device=dev)
        if c.dtype == "int8":
            sshape = (c.num_layers, c.num_blocks, c.num_heads)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)
            # a tensor, not a Python number: on the card torch divides by
            # a host scalar as a multiply by its reciprocal, which rounds
            # otherwise than the reference's division
            self._c127 = torch.tensor(127.0, device=dev)
            self._slot = torch.arange(c.block_tokens, device=dev)
        else:
            self.k_scale = self.v_scale = None
        self._free: List[int] = list(range(c.num_blocks - 1, -1, -1))
        self._seqs: Dict[str, _Seq] = {}
        self._lock = threading.Lock()
        self.allocs = 0          # lifetime block allocations
        self.frees = 0           # lifetime block frees

    # -- accounting ---------------------------------------------------------

    def register(self, seq_id: str) -> None:
        with self._lock:
            if seq_id in self._seqs:
                raise ValueError("sequence %r already registered" % seq_id)
            self._seqs[seq_id] = _Seq()

    def release(self, seq_id: str) -> int:
        """Free every block the sequence owns; returns how many."""
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is None:
                return 0
            self._free.extend(reversed(seq.blocks))
            self.frees += len(seq.blocks)
            return len(seq.blocks)

    def has(self, seq_id: str) -> bool:
        with self._lock:
            return seq_id in self._seqs

    def seq_len(self, seq_id: str) -> int:
        with self._lock:
            return self._seqs[seq_id].length

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def blocks_needed(self, seq_id: Optional[str], n_tokens: int) -> int:
        """New blocks appending ``n_tokens`` to ``seq_id`` would take
        (``seq_id=None`` -> a fresh sequence)."""
        with self._lock:
            used = self._seqs[seq_id].length if seq_id in self._seqs else 0
        bt = self.config.block_tokens
        return -(-(used + n_tokens) // bt) - (-(-used // bt))

    def blocks_needed_each(self, seq_ids, n_tokens: int) -> int:
        """New blocks appending ``n_tokens`` to each of ``seq_ids`` would
        take, in all."""
        bt = self.config.block_tokens
        with self._lock:
            used = [self._seqs[s].length if s in self._seqs else 0
                    for s in seq_ids]
        return sum(-(-(u + n_tokens) // bt) - (-(-u // bt)) for u in used)

    def can_fit(self, seq_id: Optional[str], n_tokens: int) -> bool:
        return self.blocks_needed(seq_id, n_tokens) <= self.free_blocks()

    def occupancy(self) -> float:
        with self._lock:
            return 1.0 - len(self._free) / float(self.config.num_blocks)

    def stats(self) -> Dict:
        with self._lock:
            used = self.config.num_blocks - len(self._free)
            return {
                "num_blocks": self.config.num_blocks,
                "used_blocks": used,
                "free_blocks": len(self._free),
                "occupancy": used / float(self.config.num_blocks),
                "sequences": len(self._seqs),
                "resident_tokens": sum(s.length
                                       for s in self._seqs.values()),
                "block_allocs": self.allocs,
                "block_frees": self.frees,
                "dtype": self.config.dtype,
                "arena_bytes": self.config.arena_bytes(),
            }

    def check(self) -> None:
        """Invariant audit: free + owned partitions the arena exactly (no
        leak, no double-own), and every length fits its blocks."""
        with self._lock:
            owned = [b for s in self._seqs.values() for b in s.blocks]
            all_ids = sorted(owned + self._free)
            if all_ids != list(range(self.config.num_blocks)):
                missing = set(range(self.config.num_blocks)) - set(all_ids)
                dupes = {b for b in all_ids if all_ids.count(b) > 1}
                raise AssertionError(
                    "block accounting broken: %d owned + %d free != %d "
                    "(leaked=%s double-owned=%s)"
                    % (len(owned), len(self._free),
                       self.config.num_blocks, sorted(missing)[:8],
                       sorted(dupes)[:8]))
            bt = self.config.block_tokens
            for sid, s in self._seqs.items():
                if len(s.blocks) != -(-s.length // bt) and not (
                        s.length == 0 and not s.blocks):
                    raise AssertionError(
                        "seq %r: length %d needs %d block(s), owns %d"
                        % (sid, s.length, -(-s.length // bt),
                           len(s.blocks)))

    # -- writes -------------------------------------------------------------

    def reserve(self, seq_id: str, n_tokens: int) -> int:
        """Allocate blocks for ``n_tokens`` new positions and advance the
        sequence length; returns the first new position. Atomic: raises
        ``KVCacheFull`` with NOTHING changed when the free list cannot
        cover the whole reservation. Until the last ``write_rows`` the
        tail positions hold stale values: callers mask them with an
        explicit attention length."""
        c = self.config
        if n_tokens < 1:
            raise ValueError("reserve needs n_tokens >= 1")
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise KeyError("sequence %r not registered" % seq_id)
            need = (-(-(seq.length + n_tokens) // c.block_tokens)
                    - len(seq.blocks))
            if need > len(self._free):
                raise KVCacheFull(
                    "reserving %d token(s) for %r needs %d block(s), "
                    "%d free" % (n_tokens, seq_id, need,
                                 len(self._free)))
            for _ in range(need):
                seq.blocks.append(self._free.pop())
                self.allocs += 1
            start = seq.length
            seq.length += n_tokens
            return start

    def slots(self, runs: Sequence[Tuple[str, int, int]]) -> Slots:
        """The slots of the tokens of ``runs`` = [(seq id, first position,
        count)], already reserved, in that order, for ``write_slots``."""
        bt = self.config.block_tokens
        with self._lock:
            parts = []
            for sid, start, count in runs:
                seq = self._seqs.get(sid)
                if seq is None:
                    raise KeyError("sequence %r not registered" % sid)
                if start < 0 or start + count > seq.length:
                    raise ValueError(
                        "positions [%d, %d) of %r are not reserved "
                        "(length %d)" % (start, start + count, sid,
                                         seq.length))
                parts.append((seq.blocks, start, count))
        n = sum(count for _, _, count in parts)
        blk = np.empty(n, np.int64)
        off = np.empty(n, np.int64)
        at = 0
        for blocks, start, count in parts:
            if count == 1:
                blk[at], off[at] = blocks[start // bt], start % bt
            else:
                pos = np.arange(start, start + count)
                blk[at:at + count] = np.asarray(blocks)[pos // bt]
                off[at:at + count] = pos % bt
            at += count
        if self.config.dtype != "int8":
            both = to_device(np.stack([blk, off]), torch.int64, self.device)
            return Slots([(None, both[0], both[1])], n)
        # round of a token: how many earlier tokens of this write share
        # its block
        order = np.argsort(blk, kind="stable")
        sorted_blk = blk[order]
        first = np.r_[0, np.flatnonzero(np.diff(sorted_blk)) + 1]
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - np.repeat(first, np.diff(np.r_[first,
                                                                    n]))
        order = np.argsort(rank, kind="stable")           # by round
        packed = to_device(np.stack([order, blk[order], off[order]]),
                           torch.int64, self.device)
        rounds, start = [], 0
        for count in np.bincount(rank):
            rounds.append(tuple(packed[:, start:start + count]))
            start += count
        return Slots(rounds, n)

    def write_slots(self, layer: int, slots: Slots, k_rows: torch.Tensor,
                    v_rows: torch.Tensor) -> None:
        """Store ``[T, H, D]`` float32 K/V rows for ONE layer into the
        slots ``slots`` names (row i into slot i)."""
        if k_rows.shape[0] != slots.count or v_rows.shape[0] != slots.count:
            raise ValueError("write of %d/%d rows into %d slots"
                             % (k_rows.shape[0], v_rows.shape[0],
                                slots.count))
        for arena, scales, rows in ((self.k_arena, self.k_scale, k_rows),
                                    (self.v_arena, self.v_scale, v_rows)):
            rows = rows.to(device=self.device, dtype=torch.float32)
            for idx, blk, off in slots.rounds:
                if scales is None:
                    arena[layer, blk, off] = rows.to(arena.dtype)
                else:
                    self._write_int8(arena[layer], scales[layer], blk, off,
                                     rows[idx])

    def _write_int8(self, arena, scales, blk, off, rows) -> None:
        """One round of int8 writes: token i stores ``rows[i]`` ([H, D])
        at (``blk[i]``, ``off[i]``), every ``blk[i]`` distinct. A head
        whose amax grows requantizes the block's codes before ``off[i]``
        to the new scale (the reference's ``_write``, in float32)."""
        codes = arena[blk]                                # [n, BT, H, D]
        cur = scales[blk]                                 # [n, H]
        new = torch.maximum(cur, rows.abs().amax(dim=2) / self._c127)
        # the reference's `new > cur * (1 + 1e-12)`: 1 + 1e-12 is 1.0 in
        # float32, where its product is taken
        requant = (new > cur) & (cur > 0) & (off > 0)[:, None]   # [n, H]
        earlier = self._slot[None, :] < off[:, None]              # [n, BT]
        mask = (earlier[:, :, None] & requant[:, None, :])[..., None]
        safe = torch.where(new > 0, new, torch.ones_like(new))
        vals = codes.float() * cur[:, None, :, None]
        moved = torch.round(vals / safe[:, None, :, None]).clamp_(-127, 127)
        codes = torch.where(mask, moved.to(torch.int8), codes)
        codes[torch.arange(codes.shape[0], device=codes.device), off] = (
            torch.round(rows / safe[:, :, None]).clamp_(-127, 127)
            .to(torch.int8))
        arena[blk] = codes
        scales[blk] = new

    def write_rows(self, seq_id: str, layer: int, start: int,
                   k_rows, v_rows) -> None:
        """Store ``[T, H, D]`` float32 K/V rows for ONE layer at positions
        ``start .. start+T-1`` (already reserved)."""
        k_rows = torch.as_tensor(k_rows, dtype=torch.float32)
        v_rows = torch.as_tensor(v_rows, dtype=torch.float32)
        T = k_rows.shape[0]
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise KeyError("sequence %r not registered" % seq_id)
            if start + T > seq.length:
                raise ValueError(
                    "write_rows [%d, %d) past reserved length %d of %r"
                    % (start, start + T, seq.length, seq_id))
        self.write_slots(layer, self.slots([(seq_id, start, T)]), k_rows,
                         v_rows)

    def append(self, seq_id: str, k, v) -> None:
        """Append ``T`` tokens' K/V (``[T, num_layers, num_heads,
        head_dim]`` float32) across all layers at once. Raises
        ``KVCacheFull`` with NOTHING written when the free list cannot
        cover the append."""
        c = self.config
        k = torch.as_tensor(k, dtype=torch.float32)
        v = torch.as_tensor(v, dtype=torch.float32)
        want = (k.shape[0], c.num_layers, c.num_heads, c.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError("append expects k/v %s, got %s / %s"
                             % (want, tuple(k.shape), tuple(v.shape)))
        start = self.reserve(seq_id, k.shape[0])
        slots = self.slots([(seq_id, start, k.shape[0])])
        for layer in range(c.num_layers):
            self.write_slots(layer, slots, k[:, layer], v[:, layer])

    # -- reads --------------------------------------------------------------

    def views(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         object, object]:
        """The attention kernel's operands for one layer: ``(k_arena,
        v_arena, k_scales, v_scales)``, where the scales slot is None
        (f32), ``"bf16"`` or the per-(block, head) scales (int8): the
        contract of ``ops.cuda.paged_attention``. Each is contiguous."""
        d = self.config.dtype
        if d == "f32":
            return self.k_arena[layer], self.v_arena[layer], None, None
        if d == "bf16":
            return (self.k_arena[layer], self.v_arena[layer],
                    "bf16", "bf16")
        return (self.k_arena[layer], self.v_arena[layer],
                self.k_scale[layer], self.v_scale[layer])

    def block_table(self, seq_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """``([B, max_blocks] int32 table (-1 padded), [B] int32
        lengths)`` on the host over the given sequences. Unknown ids get an
        empty row (length 0), which the kernel masks to zeros; that is how
        padded batch slots ride."""
        with self._lock:
            rows = [self._seqs[s].blocks if s in self._seqs else []
                    for s in seq_ids]
            lens = [self._seqs[s].length if s in self._seqs else 0
                    for s in seq_ids]
        counts = np.fromiter(map(len, rows), np.int64, count=len(rows))
        width = max(1, int(counts.max(initial=0)))
        table = np.full((len(rows), width), -1, np.int32)
        table[np.arange(width)[None, :] < counts[:, None]] = np.fromiter(
            itertools.chain.from_iterable(rows), np.int32,
            count=int(counts.sum()))
        return torch.from_numpy(table), torch.tensor(lens, dtype=torch.int32)

    def gather(self, seq_id: str, layer: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense float32 ``([T, H, D] k, [T, H, D] v)`` for one
        sequence/layer, on the cache's device: the tests' oracle."""
        c = self.config
        with self._lock:
            seq = self._seqs[seq_id]
            blocks = list(seq.blocks)
            n = seq.length
        if n == 0:
            z = torch.zeros((0, c.num_heads, c.head_dim), device=self.device)
            return z, z.clone()
        ids = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
        tok_blocks = ids.repeat_interleave(c.block_tokens)[:n]
        out = []
        for arena, scales in ((self.k_arena, self.k_scale),
                              (self.v_arena, self.v_scale)):
            flat = arena[layer, ids].reshape(
                -1, c.num_heads, c.head_dim)[:n].float()
            if scales is not None:
                flat = flat * scales[layer][tok_blocks][:, :, None]
            out.append(flat)
        return out[0], out[1]
