"""TinyDecodeLM: the decode engine's deterministic transformer.

Counterpart of ``paddle_tpu/serving/decode/model.py``: a seeded pre-norm
transformer whose geometry comes from the cache config (layers, heads,
head_dim; embedding width ``num_heads * head_dim``), greedy decoding, float32
throughout. Its weights are drawn with ``numpy.random.RandomState(seed)`` in
the reference's order, so they are the reference's arrays bit for bit, and
then move to the cache's device; ``load_numpy`` loads another model's
arrays.

Determinism is load-bearing, not a test convenience: fleet failover
regenerates a stream on another replica and expects the same tokens, though
that replica sees other prefill chunk boundaries, other decode batches and
perhaps a preemption with re-prefill. The reference gets this from
single-row numpy operations. On the card a matrix product's bits for one row
may change with the number of rows M, since cuBLAS picks its algorithm by
shape, and a reduction over ``[M, E]`` may split its rows otherwise. So
every product and every row reduction here runs on groups of exactly
``rows`` rows, zero-padded (``_pad_rows``, ``_by_rows``), and the logits on
groups of ``logit_rows``. The engine takes ``rows`` = a full decode batch
plus one step's prompt budget, the most rows one of its passes carries, so
a pass issues each product once, whatever its mix of prompt and decode
rows. Elementwise operations are per element whatever the shape, and the
paged-attention kernel's result for a row depends only on that row. A
prompt chunk runs
layer by layer over all its T tokens: project the rows, write their K/V,
then one attention call in which the T rows share the sequence's table and
row t attends over positions ``<= start + t``. That is what the reference's
per-token ``_token_step`` computes, with the same bits as a decode step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.cuda.paged_attention import paged_decode_attention
from .kvcache import PagedKVCache, to_device

__all__ = ["TinyDecodeLM", "decode_state_from_numpy"]

# block_table() id that is registered to no sequence: a padded batch row,
# zero-length, attends to nothing, output discarded
_PAD_SEQ = "__pad__"
# the arrays of a model, in the reference's attribute names; the per-layer
# ones are lists
STATE_KEYS = ("embed", "wq", "wk", "wv", "wo", "w1", "w2", "_pos_freq",
              "_pos_bias")
_PER_LAYER = ("wq", "wk", "wv", "wo", "w1", "w2")


def _draw_numpy(vocab_size: int, num_layers: int, E: int,
                seed: int) -> Dict:
    """The reference's arrays for ``seed``, drawn in its order."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    state = {"embed": rng.randn(vocab_size, E).astype(np.float32)}
    state["wq"] = [w(E, E) for _ in range(num_layers)]
    state["wk"] = [w(E, E) for _ in range(num_layers)]
    state["wv"] = [w(E, E) for _ in range(num_layers)]
    state["wo"] = [w(E, E) for _ in range(num_layers)]
    state["w1"] = [w(E, 2 * E) for _ in range(num_layers)]
    state["w2"] = [w(2 * E, E) for _ in range(num_layers)]
    state["_pos_freq"] = (0.3 * (np.arange(E, dtype=np.float32) + 1.0) / E)
    state["_pos_bias"] = (4.0 * rng.randn(257, vocab_size)).astype(
        np.float32)
    return state


def decode_state_from_numpy(state: Dict, device: torch.device) -> Dict:
    """A model's numpy arrays (``embed, wq[], wk[], wv[], wo[], w1[],
    w2[], _pos_freq, _pos_bias``, as the reference's attributes hold them)
    as float32 tensors on ``device``, unchanged bit for bit."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError("decode state lacks %s" % missing)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {k: ([t(a) for a in state[k]] if k in _PER_LAYER
                else t(state[k])) for k in STATE_KEYS}


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.rms_norm(x, (x.shape[-1],), eps=1e-6)


class TinyDecodeLM(torch.nn.Module):
    """Seeded toy autoregressive LM over a paged KV cache, on the cache's
    device. ``eos_token`` is vocab id 0 (None: streams end on max_tokens
    or a deadline only). ``attn_backend`` is kept for the reference's
    signature; on the card only None is taken. ``rows`` is the fixed row
    count of every product and row reduction, ``logit_rows`` that of the
    logits (None: ``rows``; see the module doc)."""

    def __init__(self, cache: PagedKVCache, vocab_size: int = 97,
                 seed: int = 0xD0DE, attn_backend: Optional[str] = None,
                 eos_token: Optional[int] = 0, rows: int = 8,
                 logit_rows: Optional[int] = None):
        super().__init__()
        self.cache = cache
        c = cache.config
        self.device = cache.device
        self.vocab_size = int(vocab_size)
        self.eos_token = eos_token
        self.num_layers = c.num_layers
        self.num_heads = c.num_heads
        self.head_dim = c.head_dim
        self.embed_dim = c.num_heads * c.head_dim
        self.attn_backend = attn_backend
        self.rows = int(rows)
        self.logit_rows = int(logit_rows or rows)
        if min(self.rows, self.logit_rows) < 1:
            raise ValueError("rows and logit_rows must be >= 1")
        self.passes = 0                  # passes of the model run so far
        self.load_numpy(_draw_numpy(self.vocab_size, self.num_layers,
                                    self.embed_dim, seed))

    # -- weights --------------------------------------------------------------

    def load_numpy(self, state: Dict) -> None:
        """Load a model's numpy arrays (see ``decode_state_from_numpy``)."""
        E, V = self.embed_dim, self.vocab_size
        t = decode_state_from_numpy(state, self.device)
        want = {"embed": (V, E), "wq": (E, E), "wk": (E, E), "wv": (E, E),
                "wo": (E, E), "w1": (E, 2 * E), "w2": (2 * E, E),
                "_pos_freq": (E,), "_pos_bias": (257, V)}
        for k, shape in want.items():
            for a in (t[k] if k in _PER_LAYER else [t[k]]):
                if tuple(a.shape) != shape:
                    raise ValueError("%s has shape %s, the model takes %s"
                                     % (k, tuple(a.shape), shape))
            if k in _PER_LAYER and len(t[k]) != self.num_layers:
                raise ValueError("%s holds %d layers, the model has %d"
                                 % (k, len(t[k]), self.num_layers))
        for k in ("embed", "_pos_freq", "_pos_bias"):
            self.register_buffer(k.lstrip("_"), t[k], persistent=True)
        for k in _PER_LAYER:
            for i, a in enumerate(t[k]):
                self.register_buffer("%s_%d" % (k, i), a, persistent=True)
        # one product for q, k and v
        self._wqkv = [torch.cat([t["wq"][i], t["wk"][i], t["wv"][i]], dim=1)
                      for i in range(self.num_layers)]

    def numpy_state(self) -> Dict:
        """The model's arrays under the reference's names, as numpy."""
        out = {"embed": self.embed, "_pos_freq": self.pos_freq,
               "_pos_bias": self.pos_bias}
        for k in _PER_LAYER:
            out[k] = [getattr(self, "%s_%d" % (k, i))
                      for i in range(self.num_layers)]
        return {k: ([a.cpu().numpy() for a in v] if isinstance(v, list)
                    else v.cpu().numpy()) for k, v in out.items()}

    def layer(self, name: str, i: int) -> torch.Tensor:
        return getattr(self, "%s_%d" % (name, i))

    # -- fixed-row pieces ---------------------------------------------------

    def _pad_rows(self, x: torch.Tensor,
                  rows: Optional[int] = None) -> torch.Tensor:
        """``x`` with zero rows appended up to a multiple of ``rows``
        (default ``self.rows``)."""
        pad = -x.shape[0] % (rows or self.rows)
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad \
            else x

    def _by_rows(self, fn, *xs: torch.Tensor,
                 rows: Optional[int] = None) -> torch.Tensor:
        """``fn`` over groups of exactly ``rows`` (default ``self.rows``)
        rows of ``xs``, whose row count is a multiple of it,
        concatenated."""
        n, R = xs[0].shape[0], rows or self.rows
        if n == R:
            return fn(*xs)
        return torch.cat([fn(*(x[i:i + R] for x in xs))
                          for i in range(0, n, R)])

    def _embed(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        pos = positions.to(torch.float32)[:, None] * self.pos_freq[None, :]
        return self.embed[tokens] + 0.3 * torch.sin(pos)

    def _project(self, layer: int, h: torch.Tensor):
        """q, k, v of the (padded) rows ``h`` as ``[N, H, D]`` each."""
        w = self._wqkv[layer]
        qkv = self._by_rows(lambda x: _rms_norm(x) @ w, h)
        hd = (h.shape[0], self.num_heads, self.head_dim)
        E = self.embed_dim
        return (qkv[:, :E].reshape(hd), qkv[:, E:2 * E].reshape(hd),
                qkv[:, 2 * E:].reshape(hd))

    def _mlp(self, layer: int, h: torch.Tensor,
             attn: torch.Tensor) -> torch.Tensor:
        wo, w1, w2 = (self.layer(n, layer) for n in ("wo", "w1", "w2"))

        def block(h, a):
            h = torch.addmm(h, a, wo)
            return torch.addmm(h, torch.tanh(_rms_norm(h) @ w1), w2)

        return self._by_rows(block, h, attn.reshape(h.shape[0], -1))

    def logits_rows(self, h: torch.Tensor,
                    next_pos: torch.Tensor) -> torch.Tensor:
        """``[N, vocab]`` logits of the tokens at ``next_pos`` from the
        final hidden rows of the positions before them; the hidden part is
        down-weighted so the position bias can vary the argmax."""
        n, R = h.shape[0], self.logit_rows
        bias = self.pos_bias[next_pos % self.pos_bias.shape[0]]
        return self._by_rows(
            lambda x, b: torch.addmm(b, _rms_norm(x), self.embed.T,
                                     alpha=0.5),
            self._pad_rows(h, R), self._pad_rows(bias, R), rows=R)[:n]

    def logits1(self, h_row: torch.Tensor, next_pos: int) -> torch.Tensor:
        """Logits for the token AT ``next_pos`` given the final hidden row
        of position ``next_pos - 1``."""
        pos = torch.tensor([int(next_pos)], device=self.device)
        return self.logits_rows(h_row[None], pos)[0]

    def next_token(self, h_row: torch.Tensor, next_pos: int) -> int:
        """The greedy token at ``next_pos``: one copy to the host."""
        return int(torch.argmax(self.logits1(h_row, next_pos)))

    def _attend(self, layer: int, q: torch.Tensor, table: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
        k_ar, v_ar, ks, vs = self.cache.views(layer)
        return paged_decode_attention(
            q, k_ar, v_ar, table, lens,
            block_tokens=self.cache.config.block_tokens,
            k_scales=ks, v_scales=vs, backend=self.attn_backend)

    # -- one pass over decode rows and prompt chunks -------------------------

    def _pass(self, decode, pad_to: Optional[int], chunks) -> torch.Tensor:
        """Final hidden rows of one pass of the model: first the decode rows
        (``decode`` = (seq ids, last tokens, positions)), then each prompt
        chunk's rows (``chunks`` = [(seq id, tokens, start position)]), every
        position already reserved. Layer by layer all rows are projected,
        their K/V written, then attention runs once over the decode rows
        (one row per sequence, padded to ``pad_to`` zero-length rows) and
        once per chunk (its rows sharing the sequence's table, row t of
        length start + t + 1)."""
        self.passes += 1
        ids, last, dpos = decode or ([], [], [])
        B = len(ids)
        spans, runs = [], [(sid, p, 1) for sid, p in zip(ids, dpos)]
        toks, poss, at = [np.asarray(last, np.int64)], [
            np.asarray(dpos, np.int64)], B
        for sid, ctoks, start in chunks:
            n = len(ctoks)
            spans.append((at, n))
            runs.append((sid, start, n))
            toks.append(np.asarray(ctoks, np.int64))
            poss.append(np.arange(start, start + n))
            at += n
        N = at
        dev = self.device
        tok, pos = to_device(np.stack([np.concatenate(toks),
                                       np.concatenate(poss)]),
                             torch.int64, dev)
        # every row-wise product and reduction below runs on whole groups
        # of `rows` rows; the zero rows padded on here ride along
        h = self._pad_rows(self._embed(tok, pos))
        slots = self.cache.slots(runs)
        # every table and length list of the pass, in one copy
        groups = []
        if B:
            pad = max(pad_to or B, B) - B
            groups.append((list(ids) + [_PAD_SEQ] * pad,
                           [p + 1 for p in dpos] + [0] * pad))
        for (s0, n), (sid, _, start) in zip(spans, chunks):
            groups.append(([sid], np.arange(start + 1, start + n + 1)))
        tables = self._tables_and_lens(groups)
        q_pad = (torch.zeros((len(groups[0][0]), self.num_heads,
                              self.head_dim), device=dev) if B else None)
        for layer in range(self.num_layers):
            q, k, v = self._project(layer, h)
            self.cache.write_slots(layer, slots, k[:N], v[:N])
            attn = torch.zeros_like(q)
            if B:
                q_pad[:B] = q[:B]
                attn[:B] = self._attend(layer, q_pad, *tables[0])[:B]
            for (s0, n), tl in zip(spans, tables[1 if B else 0:]):
                attn[s0:s0 + n] = self._attend(layer, q[s0:s0 + n], *tl)
            h = self._mlp(layer, h, attn)
        return h[:N]

    def _tables_and_lens(self, groups):
        """[(table, lengths)] on the device, one per (seq ids, lengths)
        group, int32, from one copy."""
        host = [(self.cache.block_table(sids)[0].numpy(),
                 np.asarray(lens, np.int32)) for sids, lens in groups]
        packed = to_device(np.concatenate(
            [a.ravel() for t, ln in host for a in (ln, t)]), torch.int32,
            self.device)
        out, at = [], 0
        for t, ln in host:
            lens = packed[at:at + ln.size]
            at += ln.size
            out.append((packed[at:at + t.size].view(t.shape), lens))
            at += t.size
        return out

    # -- prefill ------------------------------------------------------------

    def prefill_chunk(self, seq_id: str, tokens) -> torch.Tensor:
        """Run one prompt chunk through the model, writing its K/V into
        the cache; returns the LAST position's final hidden row (the engine
        takes logits from it when the prompt completes). Caller guarantees
        cache fit (``can_fit``); the chunk's positions are reserved at
        once, so ``KVCacheFull`` surfaces before anything is written."""
        tokens = [int(t) for t in tokens]
        start = self.cache.reserve(seq_id, len(tokens))
        return self._pass(None, None, [(seq_id, tokens, start)])[-1]

    # -- decode -------------------------------------------------------------

    def decode_step(self, seq_ids: List[str], last_tokens: Sequence[int],
                    pad_to: Optional[int] = None
                    ) -> Tuple[torch.Tensor, np.ndarray]:
        """One token step for the active batch: reserve a position per
        sequence, write each layer's K/V rows, one batched paged-attention
        call per layer (padded to ``pad_to`` rows; padded rows are
        zero-length and discarded). Returns ``([B, vocab] logits on the
        device, [B] greedy next tokens on the host)``: one copy to the
        host. Caller guarantees fit for one token per sequence."""
        pos = [self.cache.reserve(sid, 1) for sid in seq_ids]
        h = self._pass((seq_ids, last_tokens, pos), pad_to, [])
        logits = self.logits_rows(h, to_device(pos, torch.int64,
                                               self.device) + 1)
        nxt = torch.argmax(logits, dim=1).cpu().numpy().astype(np.int64)
        return logits, nxt

    def step(self, seq_ids: List[str], last_tokens: Sequence[int],
             pad_to: Optional[int], chunks) -> Tuple[np.ndarray, List]:
        """The engine's token step in one pass: a decode step for
        ``seq_ids`` (positions reserved here) and the prompt ``chunks``
        [(seq id, tokens, start, wants_token)] (positions reserved by the
        caller). Returns the decode rows' greedy next tokens and, for each
        chunk, the greedy token after its last position where
        ``wants_token`` (the prompt is complete), else None: one copy to
        the host. A row's bits are those of ``decode_step`` and
        ``prefill_chunk``."""
        pos = [self.cache.reserve(sid, 1) for sid in seq_ids]
        h = self._pass((seq_ids, last_tokens, pos) if seq_ids else None,
                       pad_to, [c[:3] for c in chunks])
        B = len(seq_ids)
        rows, nxt_pos, at = list(range(B)), [p + 1 for p in pos], B
        for sid, toks, start, wants in chunks:
            at += len(toks)
            if wants:
                rows.append(at - 1)
                nxt_pos.append(start + len(toks))
        if not rows:
            return np.zeros(0, np.int64), [None] * len(chunks)
        idx, npos = to_device([rows, nxt_pos], torch.int64, self.device)
        nxt = torch.argmax(self.logits_rows(h[idx], npos), dim=1).cpu()
        nxt = nxt.numpy().astype(np.int64)
        it = iter(nxt[B:].tolist())
        return nxt[:B], [next(it) if c[3] else None for c in chunks]
