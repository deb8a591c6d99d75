"""The port's decode tier on the CPU, held to the JAX package.

The classes ``TestKVCacheAccounting``, ``TestQuantizedKV``,
``TestPagedAttention``, ``TestDeterministicRegeneration`` and
``TestDecodeEngine`` are the counterparts of those of
``tests/test_serving_decode.py``, driven through ``paddle_tpu_torch`` with
``CPUPlace()``. The rest hold the port to the JAX package from the same
seeded numpy inputs:

- the cache: one register/append/reserve/write_rows/release sequence in
  both packages gives equal block tables, lengths and ``stats()``, and
  arenas equal bit for bit in f32 and bf16, int8 codes and scales too,
  through a growing-amax sequence that requantizes several times;
- the model's weights are the reference's bit for bit, and ``load_numpy``
  of the reference's arrays gives the same model;
- ``prefill_chunk`` hidden rows and ``decode_step`` logits, with the same
  token history fed to both, within ``LOGIT_TOL`` = 1e-4 absolute on a
  float32 arena: float32 products, norms and softmax summed in other orders
  by numpy and torch (readings up to 1.5e-5 on logits of magnitude about
  15). On bf16 and int8 arenas a K or V value 1e-6 apart on the two sides
  may round to neighbouring codes, one storage step apart (2^-8 relative
  in bf16, a block's amax / 127 in int8), so there the bound is
  ``QUANT_TOL`` (readings up to 2.9e-4 and 5.0e-2);
- greedy streams equal the JAX engine's wherever the reference's top-2
  logit gap exceeds 10 x ``LOGIT_TOL``;
- exact invariance in the port: a stream's tokens and logits are the same
  prefilled in one chunk or in several, decoded alone or in a batch of 8,
  and with or without a preemption plus re-prefill.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving.decode.kvcache import _to_bf16_bits

import paddle_tpu_torch as fluid
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_attention_reference, paged_decode_attention)
from paddle_tpu_torch.serving import (DeadlineExpired, ServerOverloaded,
                                      metrics as sm)
from paddle_tpu_torch.serving.decode import (DecodeConfig, DecodeEngine,
                                             KVCacheConfig, KVCacheFull,
                                             PagedKVCache, TinyDecodeLM,
                                             decode_state_from_numpy)

CPU = fluid.CPUPlace()
LOGIT_TOL = 1e-4
HIDDEN_TOL = 1e-5
QUANT_TOL = {"f32": LOGIT_TOL, "bf16": 2e-3, "int8": 0.1}


@pytest.fixture(autouse=True)
def _clean_flight():
    flight.clear()
    yield
    flight.clear()


def _cache(**kw):
    kw.setdefault("num_blocks", 8)
    kw.setdefault("block_tokens", 4)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("head_dim", 4)
    return PagedKVCache(KVCacheConfig(**kw), CPU)


def _kv(rng, n, layers=2, heads=2, dim=4):
    """``[T, layers, heads, dim]`` float32 rows for ``append``."""
    return rng.randn(n, layers, heads, dim).astype(np.float32)


def _bits(t):
    """A port arena as numpy in the reference's storage (uint16 for
    bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# -- KV cache block accounting ------------------------------------------------

class TestKVCacheAccounting:
    def test_alloc_free_parity_join_leave(self):
        c = _cache()
        rng = np.random.RandomState(0)
        total = c.free_blocks()
        for round_ in range(3):
            ids = ["s%d_%d" % (round_, i) for i in range(3)]
            for sid in ids:
                c.register(sid)
                c.append(sid, _kv(rng, 5), _kv(rng, 5))
            c.check()
            for sid in ids:
                c.release(sid)
            assert c.free_blocks() == total
            c.check()

    def test_evict_readmit_parity(self):
        c = _cache(num_blocks=4)
        rng = np.random.RandomState(1)
        free0 = c.free_blocks()
        c.register("a")
        c.append("a", _kv(rng, 9), _kv(rng, 9))
        used = free0 - c.free_blocks()
        assert used == 3  # ceil(9/4)
        c.release("a")
        assert c.free_blocks() == free0
        c.register("a")
        c.append("a", _kv(rng, 9), _kv(rng, 9))
        assert free0 - c.free_blocks() == used
        c.release("a")
        assert c.free_blocks() == free0
        c.check()

    def test_reserve_is_atomic_when_full(self):
        c = _cache(num_blocks=2, num_layers=1)
        c.register("a")
        start = c.reserve("a", 7)  # 2 blocks of 4
        assert start == 0 and c.free_blocks() == 0
        with pytest.raises(KVCacheFull):
            c.reserve("a", 2)  # needs a 3rd block
        assert c.seq_len("a") == 7 and c.free_blocks() == 0
        c.check()

    def test_seeded_churn_zero_leaks(self):
        rng = np.random.RandomState(0xC4A0)
        c = _cache(num_blocks=16, num_layers=1)
        total = c.free_blocks()
        live = {}
        for step in range(300):
            op = rng.rand()
            if op < 0.45 and len(live) < 6:
                sid = "s%d" % step
                c.register(sid)
                live[sid] = 0
            elif op < 0.8 and live:
                sid = list(live)[rng.randint(len(live))]
                n = int(rng.randint(1, 6))
                try:
                    c.append(sid, _kv(rng, n, layers=1),
                             _kv(rng, n, layers=1))
                    live[sid] += n
                except KVCacheFull:
                    c.release(sid)
                    del live[sid]
            elif live:
                sid = list(live)[rng.randint(len(live))]
                c.release(sid)
                del live[sid]
            c.check()
            for sid, n in live.items():
                assert c.seq_len(sid) == n
        for sid in list(live):
            c.release(sid)
        assert c.free_blocks() == total
        c.check()

    def test_block_table_shapes_and_padding(self):
        c = _cache(num_layers=1)
        rng = np.random.RandomState(2)
        c.register("a")
        c.append("a", _kv(rng, 6, layers=1), _kv(rng, 6, layers=1))
        c.register("b")
        c.append("b", _kv(rng, 1, layers=1), _kv(rng, 1, layers=1))
        table, lens = c.block_table(["a", "b", "__pad__"])
        assert tuple(table.shape) == (3, 2) and lens.tolist() == [6, 1, 0]
        assert table[0, 0] >= 0 and table[0, 1] >= 0
        assert table[1, 1] == -1
        assert table[2].tolist() == [-1, -1]


# -- quantized storage --------------------------------------------------------

class TestQuantizedKV:
    @pytest.mark.parametrize("dtype,tol", [("bf16", 2e-2), ("int8", 6e-2)])
    def test_quantized_vs_f32_divergence_bounded(self, dtype, tol):
        rng = np.random.RandomState(3)
        k = _kv(rng, 11)
        v = _kv(rng, 11)
        exact = _cache(dtype="f32")
        quant = _cache(dtype=dtype)
        for c in (exact, quant):
            c.register("s")
            c.append("s", k, v)
        for layer in range(2):
            ke, ve = exact.gather("s", layer)
            kq, vq = quant.gather("s", layer)
            scale = max(ke.abs().max(), ve.abs().max())
            assert (ke - kq).abs().max() / scale < tol
            assert (ve - vq).abs().max() / scale < tol

    def test_int8_requantize_on_amax_growth(self):
        c = _cache(dtype="int8", num_layers=1)
        c.register("s")
        small = np.full((1, 1, 2, 4), 0.01, np.float32)
        big = np.full((1, 1, 2, 4), 10.0, np.float32)
        c.append("s", small, small)
        c.append("s", big, big)
        k, _ = c.gather("s", 0)
        assert abs(k[1, 0, 0] - 10.0) < 0.1
        assert abs(k[0, 0, 0]) <= 10.0 / 127 + 1e-6

    def test_arena_bytes_ordering(self):
        f32 = KVCacheConfig(dtype="f32").arena_bytes()
        bf16 = KVCacheConfig(dtype="bf16").arena_bytes()
        i8 = KVCacheConfig(dtype="int8").arena_bytes()
        assert f32 > bf16 > i8


# -- paged attention over the cache -------------------------------------------

class TestPagedAttention:
    def _setup(self, dtype="f32", pkg="port"):
        rng = np.random.RandomState(7)
        kw = dict(num_blocks=16, block_tokens=8, num_layers=1,
                  num_heads=2, head_dim=8, dtype=dtype)
        c = (_cache(**kw) if pkg == "port"
             else jdec.PagedKVCache(jdec.KVCacheConfig(**kw)))
        lens = [13, 1, 20]
        for i, n in enumerate(lens):
            c.register("s%d" % i)
            c.append("s%d" % i, _kv(rng, n, layers=1, dim=8),
                     _kv(rng, n, layers=1, dim=8))
        q = rng.randn(3, 2, 8).astype(np.float32)
        table, ln = c.block_table(["s0", "s1", "s2"])
        return c, q, table, ln

    def test_dense_matches_bruteforce(self):
        c, q, table, lens = self._setup()
        k_ar, v_ar, _, _ = c.views(0)
        out = paged_attention_reference(torch.from_numpy(q), k_ar, v_ar,
                                        table, lens, block_tokens=8)
        for i in range(3):
            k, v = (t.numpy() for t in c.gather("s%d" % i, 0))
            s = np.einsum("hd,thd->ht", q[i], k) / np.sqrt(8.0)
            p = np.exp(s - s.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            want = np.einsum("ht,thd->hd", p, v)
            np.testing.assert_allclose(out[i].numpy(), want, rtol=1e-5,
                                       atol=1e-5)

    def test_pallas_interpret_parity(self):
        """The port's attention over its own cache against the JAX Pallas
        kernel (interpret mode) over the JAX cache, same appends."""
        c, q, table, lens = self._setup()
        jc, _, jtable, jlens = self._setup(pkg="jax")
        jk, jv, _, _ = jc.views(0)
        want = jax_paged(q, jk, jv, jtable, jlens, block_tokens=8,
                         backend="pallas_interpret")
        k_ar, v_ar, _, _ = c.views(0)
        got = paged_decode_attention(torch.from_numpy(q), k_ar, v_ar, table,
                                     lens, block_tokens=8)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    def test_quantized_arena_attention(self):
        c, q, table, lens = self._setup(dtype="int8")
        k_ar, v_ar, ks, vs = c.views(0)
        out = paged_decode_attention(torch.from_numpy(q), k_ar, v_ar, table,
                                     lens, block_tokens=8, k_scales=ks,
                                     v_scales=vs)
        cf, qf, tf, lf = self._setup(dtype="f32")
        kf, vf, _, _ = cf.views(0)
        exact = paged_decode_attention(torch.from_numpy(qf), kf, vf, tf,
                                       lf, block_tokens=8)
        assert (out - exact).abs().max() < 0.2


# -- deterministic regeneration (the failover contract) -----------------------

def _gen_model(prompt, n, chunks, head_dim=8):
    """Greedy tokens and every step's logits of a fresh model, the prompt
    prefilled in ``chunks``."""
    c = _cache(num_blocks=32, block_tokens=4, num_layers=2, num_heads=2,
               head_dim=head_dim)
    m = TinyDecodeLM(c, eos_token=None)
    c.register("s")
    h, i = None, 0
    for size in chunks:
        h = m.prefill_chunk("s", prompt[i:i + size])
        i += size
    logits = [m.logits1(h, len(prompt))]
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n - 1):
        lg, nxt = m.decode_step(["s"], [out[-1]])
        logits.append(lg[0])
        out.append(int(nxt[0]))
    return out, logits


class TestDeterministicRegeneration:
    def test_chunking_invariance(self):
        prompt = list(range(1, 12))
        a, la = _gen_model(prompt, 8, [11])
        b, lb = _gen_model(prompt, 8, [3, 5, 2, 1])
        d, ld = _gen_model(prompt, 8, [4, 7])
        assert a == b == d
        assert len(set(a)) > 2  # not a degenerate constant stream
        # not only the tokens: every logit, bit for bit
        for x, y, z in zip(la, lb, ld):
            assert torch.equal(x, y) and torch.equal(x, z)


# -- decode engine ------------------------------------------------------------

def _engine(**kw):
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("eos_token", None)
    kw.setdefault("place", CPU)
    return DecodeEngine(DecodeConfig(**kw)).start()


def _tokens(events):
    return [e["token"] for e in events if e["type"] == "token"]


class TestDecodeEngine:
    def test_stream_events_and_metrics(self):
        e = _engine()
        try:
            evs = list(e.submit([1, 2, 3], max_tokens=6))
            toks = [x for x in evs if x["type"] == "token"]
            assert [t["index"] for t in toks] == list(range(6))
            assert evs[-1] == {"type": "finish", "reason": "max_tokens",
                               "tokens": 6, "preemptions": 0}
            st = e.stats()
            assert st[sm.STREAMS] == 1
            assert st[sm.TOKENS] == 6
            assert st[sm.TTFT_MS]["count"] == 1
            assert st[sm.ITL_MS]["count"] == 5
            assert st[sm.PREFILL_TOKENS] == 3 and st[sm.PREFILL_CHUNKS] == 1
            assert st[sm.DECODE_STEPS] == 5
        finally:
            e.stop()

    def test_one_product_group_a_pass_and_the_host_split(self):
        """The engine's model runs its products on a full decode batch
        plus the prompt budget and its logits on the ladder's top, so a
        pass of decode rows and a prompt chunk runs each product once;
        stats() splits the steps' host time from their passes'."""
        e = _engine(max_batch_size=4, prefill_chunk_tokens=12)
        try:
            assert e.config.pass_rows == 16
            assert (e.model.rows, e.model.logit_rows) == (16, 4)
            _tokens(e.submit([1, 2, 3], max_tokens=4))
            st = e.stats()
            assert 0 < st["pass_seconds"] <= st["step_seconds"]
        finally:
            e.stop()
        c = _cache(num_blocks=16, block_tokens=4, head_dim=8)
        m = TinyDecodeLM(c, eos_token=None, rows=16, logit_rows=4)
        c.register("a")
        first = m.next_token(m.prefill_chunk("a", [1, 2, 3]), 3)
        c.register("b")
        start = c.reserve("b", 12)
        sizes, by_rows = [], m._by_rows
        m._by_rows = lambda fn, *xs, **kw: sizes.append(
            xs[0].shape[0]) or by_rows(fn, *xs, **kw)
        m.step(["a"], [first], 1, [("b", list(range(1, 13)), start, True)])
        # project and MLP once a layer on 16 rows, the logits on 4
        assert sizes == [16] * (2 * m.num_layers) + [4]

    def test_dedup_replay_and_resume_from(self):
        e = _engine()
        try:
            first = list(e.submit([4, 5], max_tokens=5,
                                  request_id="rid1"))
            again = list(e.submit([4, 5], max_tokens=5,
                                  request_id="rid1"))
            assert again == first
            tail = list(e.submit([4, 5], max_tokens=5,
                                 request_id="rid1", resume_from=3))
            toks = [x for x in tail if x["type"] == "token"]
            assert [t["index"] for t in toks] == [3, 4]
            want = [x for x in first if x["type"] == "token"][3:]
            assert toks == want
            assert e.stats()[sm.DEDUP_HITS] == 2
        finally:
            e.stop()

    def test_mixed_length_concurrent_streams(self):
        e = _engine(max_batch_size=4)
        try:
            lens = [3, 9, 1, 6, 12, 2]
            streams = [e.submit([i + 1, i + 2], max_tokens=n,
                                request_id="m%d" % i)
                       for i, n in enumerate(lens)]
            outs = [list(s) for s in streams]
            for n, evs in zip(lens, outs):
                toks = [x for x in evs if x["type"] == "token"]
                assert [t["index"] for t in toks] == list(range(n))
                assert evs[-1]["reason"] == "max_tokens"
            # the same values alone, at the same row count
            solo = _engine(max_batch_size=4)
            try:
                alone = list(solo.submit([2, 3], max_tokens=9,
                                         request_id="m1"))
                assert _tokens(alone) == _tokens(outs[1])
            finally:
                solo.stop()
        finally:
            e.stop()

    def test_deadline_finish_event(self):
        e = _engine(kv_blocks=128, prefill_chunk_tokens=4,
                    max_prompt_tokens=512)
        try:
            evs = list(e.submit([1] * 300, max_tokens=500,
                                deadline_s=0.05))
            assert evs[-1]["type"] == "finish"
            assert evs[-1]["reason"] == "deadline_expired"
            with pytest.raises(DeadlineExpired):
                e.submit([1] * 300, max_tokens=500,
                         deadline_s=0.05).result()
            assert e.stats()[sm.STREAM_ERRORS] == 2
        finally:
            e.stop()

    def test_preemption_low_evicted_first_zero_leaks(self):
        # arena of 5 blocks * 4 tokens: two 14-token streams cannot
        # coexist; the LOW one must be evicted (re-prefilled later)
        e = _engine(kv_blocks=5, kv_block_tokens=4, num_layers=1,
                    max_batch_size=2, prefill_chunk_tokens=4)
        try:
            lo = e.submit([1, 2], max_tokens=14, cost_class="low",
                          request_id="lo")
            hi = e.submit([3, 4], max_tokens=14, cost_class="high",
                          request_id="hi")
            lo_evs, hi_evs = list(lo), list(hi)
            for evs in (lo_evs, hi_evs):
                assert evs[-1]["reason"] == "max_tokens"
                assert len(_tokens(evs)) == 14
            st = e.stats()
            assert st.get(sm.PREEMPTIONS, 0) >= 1
            ev = [f for _, kind, f in flight.events()
                  if kind == "serving.kv_preempt"]
            assert ev and ev[0]["priority"] == 2  # low shed first
            assert e.health_doc()["kv_occupancy"] == 0.0
            e.cache.check()
        finally:
            e.stop()

    def test_overload_and_health_doc(self):
        e = _engine(max_waiting=1, max_batch_size=1,
                    prefill_chunk_tokens=2)
        try:
            doc = e.health_doc()
            assert doc["engine_kind"] == "decode"
            assert set(doc) >= {"status", "kv_occupancy", "kv_blocks",
                                "kv_dtype", "active_streams"}
            streams = []
            with pytest.raises(ServerOverloaded):
                for i in range(50):
                    streams.append(e.submit([1] * 30, max_tokens=50,
                                            request_id="ov%d" % i))
            assert e.stats()[sm.REJECTED] == 1
            for s in streams:
                s.cancel()
        finally:
            e.stop(drain=False)

    def test_cancel_while_running_and_while_waiting(self):
        """A stream cancelled mid-decode ends ``cancelled`` and one
        cancelled while it waits never starts; the engine serves on and
        leaks no block."""
        e = _engine(max_batch_size=1)
        try:
            running = e.submit([1, 2, 3], max_tokens=400)
            waiting = e.submit([4, 5, 6], max_tokens=400)
            it = iter(running)
            next(it)
            waiting.cancel()
            running.cancel()
            assert list(it)[-1]["reason"] == "cancelled"
            assert list(waiting)[-1]["reason"] == "cancelled"
            after = e.submit([7, 8], max_tokens=3).result(timeout_s=30)
            assert len(after[0]) == 3 and e.health() == "serving"
            assert e.health_doc()["kv_occupancy"] == 0.0
            e.cache.check()
        finally:
            e.stop()

    def test_engine_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card; the rule is about "
                        "hosts without one")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(DecodeConfig())
        e = DecodeEngine(DecodeConfig(place=CPU))
        assert e.device.type == "cpu" and e.cache.k_arena.device.type == "cpu"


# -- the cache, bit for bit against the JAX package ---------------------------

def _cache_ops(pkg_cache, dtype, k_of):
    """One register/append/reserve/write_rows/release sequence; returns a
    snapshot (tables, lengths, stats) after each operation. ``k_of(n,
    seed)`` makes ``[n, L, H, D]`` rows."""
    kw = dict(num_blocks=12, block_tokens=4, num_layers=2, num_heads=2,
              head_dim=4, dtype=dtype)
    c = pkg_cache(kw)
    snaps = []

    def snap():
        table, lens = c.block_table(["a", "b", "c", "__pad__"])
        snaps.append((np.asarray(table).tolist(), np.asarray(lens).tolist(),
                      c.stats()))

    c.register("a")
    c.append("a", k_of(5, 1), k_of(5, 2))
    snap()
    c.register("b")
    start = c.reserve("b", 3)
    for layer in range(2):
        c.write_rows("b", layer, start, k_of(3, 3 + layer)[:, layer],
                     k_of(3, 5 + layer)[:, layer])
    snap()
    c.append("b", k_of(6, 7), k_of(6, 8))
    snap()
    c.release("a")
    snap()
    c.register("c")
    c.append("c", k_of(9, 9), k_of(9, 10))
    snap()
    start = c.reserve("c", 1)
    for layer in range(2):
        c.write_rows("c", layer, start, k_of(1, 11)[:, layer],
                     k_of(1, 12)[:, layer])
    snap()
    return c, snaps


def _rows_growing(n, seed):
    """Rows whose magnitude grows by 10x every token: every token of an
    int8 block raises the block's amax and requantizes it."""
    rng = np.random.RandomState(seed)
    mag = (10.0 ** (np.arange(n) % 4 - 2))[:, None, None, None]
    return (rng.randn(n, 2, 2, 4) * mag).astype(np.float32)


def _rows_plain(n, seed):
    return np.random.RandomState(seed).randn(n, 2, 2, 4).astype(np.float32)


class TestCacheParity:
    @pytest.mark.parametrize("rows", [_rows_plain, _rows_growing],
                             ids=["plain", "growing_amax"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    def test_same_sequence_same_cache(self, dtype, rows):
        jc, jsnaps = _cache_ops(
            lambda kw: jdec.PagedKVCache(jdec.KVCacheConfig(**kw)), dtype,
            rows)
        pc, psnaps = _cache_ops(
            lambda kw: PagedKVCache(KVCacheConfig(**kw), CPU), dtype, rows)
        assert psnaps == jsnaps
        assert np.array_equal(_bits(pc.k_arena), jc.k_arena)
        assert np.array_equal(_bits(pc.v_arena), jc.v_arena)
        if dtype == "int8":
            assert np.array_equal(pc.k_scale.numpy(), jc.k_scale)
            assert np.array_equal(pc.v_scale.numpy(), jc.v_scale)
        pc.check()

    def test_int8_chunk_write_equals_token_by_token(self):
        """A 13-token write (rounds over 4 blocks) gives the codes and
        scales of 13 one-token writes, through repeated requantization."""
        k = _rows_growing(13, 21)[:, :1]
        v = _rows_growing(13, 22)[:, :1]
        at_once = _cache(dtype="int8", num_layers=1)
        one_by_one = _cache(dtype="int8", num_layers=1)
        for c in (at_once, one_by_one):
            c.register("s")
        at_once.append("s", k, v)
        for t in range(13):
            one_by_one.append("s", k[t:t + 1], v[t:t + 1])
        assert torch.equal(at_once.k_arena, one_by_one.k_arena)
        assert torch.equal(at_once.v_scale, one_by_one.v_scale)
        # the sequence did requantize: scales grew past the first row's
        first = np.abs(k[0, 0]).max(axis=1) / 127.0
        assert (at_once.k_scale[0, at_once.block_table(["s"])[0][0, 0]]
                .numpy() > first).all()

    def test_bf16_storage_holds_the_reference_bits(self):
        x = np.random.RandomState(4).randn(64).astype(np.float32) * 7
        x[:4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -0.0, 1e-40]  # ties
        port = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(_bits(port), _to_bf16_bits(x))

    def test_gather_matches_the_reference(self):
        jc, _ = _cache_ops(
            lambda kw: jdec.PagedKVCache(jdec.KVCacheConfig(**kw)), "int8",
            _rows_growing)
        pc, _ = _cache_ops(
            lambda kw: PagedKVCache(KVCacheConfig(**kw), CPU), "int8",
            _rows_growing)
        for sid in ("b", "c"):
            for layer in range(2):
                for a, b in zip(pc.gather(sid, layer), jc.gather(sid, layer)):
                    assert np.array_equal(a.numpy(), b)


# -- the model against the JAX package ----------------------------------------

def _both_models(head_dim=8, dtype="f32", seed=0xD0DE):
    kw = dict(num_blocks=48, block_tokens=4, num_layers=2, num_heads=2,
              head_dim=head_dim, dtype=dtype)
    jm = jdec.TinyDecodeLM(jdec.PagedKVCache(jdec.KVCacheConfig(**kw)),
                           seed=seed, eos_token=None)
    pm = TinyDecodeLM(PagedKVCache(KVCacheConfig(**kw), CPU), seed=seed,
                      eos_token=None)
    return jm, pm


def _assert_same_arrays(port_state, ref):
    for k, v in port_state.items():
        want = getattr(ref, k)
        pairs = zip(v, want) if isinstance(v, list) else [(v, want)]
        for a, b in pairs:
            assert a.dtype == np.float32 and np.array_equal(a, b), k


class TestModelParity:
    @pytest.mark.parametrize("seed", [0xD0DE, 7])
    def test_weights_are_the_reference_bits(self, seed):
        jm, pm = _both_models(seed=seed)
        _assert_same_arrays(pm.numpy_state(), jm)

    def test_load_numpy_gives_the_reference_model(self):
        jm, _ = _both_models(seed=11)
        _, pm = _both_models(seed=12)
        state = {k: getattr(jm, k) for k in
                 ("embed", "wq", "wk", "wv", "wo", "w1", "w2", "_pos_freq",
                  "_pos_bias")}
        pm.load_numpy(state)
        _assert_same_arrays(pm.numpy_state(), jm)
        _, twin = _both_models(seed=11)
        for m in (pm, twin):
            m.cache.register("s")
        a = pm.prefill_chunk("s", [3, 1, 4, 1, 5])
        b = twin.prefill_chunk("s", [3, 1, 4, 1, 5])
        assert torch.equal(a, b)
        t = decode_state_from_numpy(state, torch.device("cpu"))
        assert torch.equal(t["wq"][1], torch.from_numpy(jm.wq[1]))
        with pytest.raises(KeyError):
            decode_state_from_numpy({"embed": jm.embed},
                                    torch.device("cpu"))

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("head_dim", [8, 64])
    def test_teacher_forced_hidden_rows_and_logits(self, head_dim, dtype):
        jm, pm = _both_models(head_dim, dtype)
        for m in (jm, pm):
            m.cache.register("s")
        rng = np.random.RandomState(head_dim)
        prompt = [int(t) for t in rng.randint(1, 97, size=13)]
        hj = jm.prefill_chunk("s", prompt)
        hp = pm.prefill_chunk("s", prompt)
        tol = QUANT_TOL[dtype]
        h_tol = HIDDEN_TOL if dtype == "f32" else tol
        np.testing.assert_allclose(hp.numpy(), hj, rtol=0,
                                   atol=h_tol * max(1, np.abs(hj).max()))
        lj, lp = jm.logits1(hj, 13), pm.logits1(hp, 13)
        np.testing.assert_allclose(lp.numpy(), lj, rtol=0, atol=tol)
        for t in rng.randint(1, 97, size=6):
            lj, _ = jm.decode_step(["s"], [int(t)], pad_to=4)
            lp, _ = pm.decode_step(["s"], [int(t)], pad_to=4)
            np.testing.assert_allclose(lp.numpy(), lj, rtol=0, atol=tol)

    def test_greedy_streams_match_the_jax_engine(self):
        rng = np.random.RandomState(0x5EED)
        prompts = [[int(t) for t in rng.randint(1, 97, size=n)]
                   for n in (2, 5, 9, 17, 30, 3)]
        n_tok = 16
        cfg = dict(kv_blocks=64, eos_token=None, max_batch_size=4,
                   prefill_chunk_tokens=8)
        je = jdec.DecodeEngine(jdec.DecodeConfig(**cfg)).start()
        pe = _engine(**cfg)
        try:
            jstreams = [je.submit(p, max_tokens=n_tok) for p in prompts]
            pstreams = [pe.submit(p, max_tokens=n_tok) for p in prompts]
            jtoks = [_tokens(s) for s in jstreams]
            ptoks = [_tokens(s) for s in pstreams]
        finally:
            je.stop()
            pe.stop()
        compared = 0
        for prompt, jt, pt in zip(prompts, jtoks, ptoks):
            for i, gap in enumerate(_reference_gaps(prompt, jt)):
                if gap <= 10 * LOGIT_TOL:
                    break  # the reference itself is too close to call
                assert pt[i] == jt[i], (prompt, i, pt, jt)
                compared += 1
        assert compared >= 0.9 * n_tok * len(prompts)


def _reference_gaps(prompt, tokens):
    """The JAX model's top-2 logit gap at each generated position, the
    stream fed back (teacher forcing)."""
    c = jdec.PagedKVCache(jdec.KVCacheConfig(
        num_blocks=64, block_tokens=16, num_layers=2, num_heads=2,
        head_dim=8))
    m = jdec.TinyDecodeLM(c, eos_token=None)
    c.register("s")
    logits = [m.logits1(m.prefill_chunk("s", prompt), len(prompt))]
    for t in tokens[:-1]:
        logits.append(m.decode_step(["s"], [t])[0][0])
    gaps = []
    for lg in logits:
        top = np.sort(lg)[-2:]
        gaps.append(float(top[1] - top[0]))
    return gaps


# -- exact invariance in the port ---------------------------------------------

class TestInvariance:
    def test_decoded_alone_or_in_a_batch_of_8(self):
        """A sequence's logits, bit for bit, decoding alone and as row 5
        of a batch of 8 (the model's products run at 8 rows either way)."""
        rng = np.random.RandomState(8)
        prompts = [[int(t) for t in rng.randint(1, 97, size=n)]
                   for n in (4, 11, 2, 7, 13, 5, 9, 3)]

        def run(ids):
            c = _cache(num_blocks=64, block_tokens=4, head_dim=8)
            m = TinyDecodeLM(c, eos_token=None, rows=8)
            last = []
            for i in ids:
                c.register("s%d" % i)
                h = m.prefill_chunk("s%d" % i, prompts[i])
                last.append(m.next_token(h, len(prompts[i])))
            steps = []
            for _ in range(6):
                lg, nxt = m.decode_step(["s%d" % i for i in ids], last,
                                        pad_to=8)
                steps.append(lg)
                last = [int(t) for t in nxt]
            return steps

        batch = run(range(8))
        alone = run([5])
        for b, a in zip(batch, alone):
            assert torch.equal(b[5], a[0])

    def test_preempted_and_reprefilled_stream_is_unchanged(self):
        """The low stream of a 5-block arena is evicted and re-prefilled
        from prompt + generated; its tokens equal a run with room to
        spare, at the same row count."""
        cfg = dict(kv_block_tokens=4, num_layers=1, max_batch_size=2,
                   prefill_chunk_tokens=4)
        tight = _engine(kv_blocks=5, **cfg)
        roomy = _engine(kv_blocks=64, **cfg)
        try:
            lo = tight.submit([1, 2], max_tokens=14, cost_class="low",
                              request_id="lo")
            hi = tight.submit([3, 4], max_tokens=14, cost_class="high",
                              request_id="hi")
            lo_evs, hi_evs = list(lo), list(hi)
            assert tight.stats()[sm.PREEMPTIONS] >= 1
            assert lo_evs[-1]["preemptions"] >= 1
            alone_lo = list(roomy.submit([1, 2], max_tokens=14))
            alone_hi = list(roomy.submit([3, 4], max_tokens=14))
            assert _tokens(lo_evs) == _tokens(alone_lo)
            assert _tokens(hi_evs) == _tokens(alone_hi)
            assert roomy.stats()[sm.PREEMPTIONS] == 0
        finally:
            tight.stop()
            roomy.stop()

    @pytest.mark.parametrize("chunk", [1, 3, 64])
    def test_engine_chunk_budget_does_not_move_tokens(self, chunk):
        """At one row count, the prompt budget moves no token. The streams
        run one at a time, so the batch limit only sets the row count:
        budget + limit = 132 rows for both engines."""
        rng = np.random.RandomState(12)
        prompts = [[int(t) for t in rng.randint(1, 97, size=n)]
                   for n in (9, 20, 5)]
        outs = []
        for budget in (chunk, 128):
            e = _engine(prefill_chunk_tokens=budget,
                        max_batch_size=132 - budget)
            assert e.config.pass_rows == 132
            try:
                outs.append([_tokens(e.submit(p, max_tokens=10))
                             for p in prompts])
            finally:
                e.stop()
        assert outs[0] == outs[1]
