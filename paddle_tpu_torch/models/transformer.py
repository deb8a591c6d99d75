"""Transformer family: the BERT-base encoder, its masked-LM head and the
Transformer-base WMT seq2seq model, with bench.py's two training scripts.

Counterpart of ``paddle_tpu/models/transformer.py``: ``multi_head_attention``
(:33), ``encoder_layer`` (:136), ``transformer_encoder`` (:154),
``bert_base_pretrain`` (:173), ``decoder_layer`` (:198), ``transformer_wmt``
(:229) and the masks ``_padding_bias`` (:21) and ``_causal_bias`` (:220):
the same layers, ops, attrs and parameter names, and the same decision of
when attention takes the ``flash_attention`` op (self-attention with key
lengths, at inference, or at T >= 2048), whose hand-written CUDA kernels
run on the card. Every other attention runs dense: ``scale``, ``matmul``,
the additive masks, ``softmax``, ``matmul``.

``build_transformer_wmt`` and ``build_bert_base`` are bench.py's
``_build_transformer_wmt`` (:490-538) and ``_build_bert_base`` (:422-449),
built with this package only and trained with ``AdamOptimizer``, wrapped
in ``contrib.mixed_precision.decorate`` under ``use_bf16`` (bench.py's
default: bfloat16 products on float32 master parameters, with
``flash_attention`` in float32 as the AMP lists leave it;
``use_bf16=False`` is the ``--no-bf16`` float32 program); ``*_batch`` make
their feeds as bench.py's ``bench_*`` functions do. Dropout (the
``dropout`` op) comes with a later slice: ``dropout > 0`` raises.
"""
from __future__ import annotations

import numpy as np

from .. import framework, layers, optimizer
from ..contrib import mixed_precision as mp
from ..layer_helper import LayerHelper
from ..layers.io import fluid_data
from ..utils import unique_name

WMT = dict(batch=64, seq_len=256, vocab=32000, num_layers=6, num_heads=8,
           d_model=512, d_ff=2048)
BERT_BASE = dict(batch=32, seq_len=128, vocab=30522, num_layers=12,
                 num_heads=12, d_model=768, d_ff=3072, masked=20)


def _no_dropout(dropout):
    if dropout:
        raise NotImplementedError(
            "dropout > 0 needs the dropout op, not yet ported (ROADMAP.md, "
            "queue 1)")


def _dense(x, size, act=None):
    return layers.fc(x, size=size, act=act, num_flatten_dims=2)


def _padding_bias(lengths, maxlen, batch, dtype="float32"):
    """Additive key-padding mask [B, 1, 1, maxlen]: 0 for visible keys,
    -1e9 past ``lengths``, as ``(vis - 1) * 1e9`` (the bias before the
    scale: scaled first, a -1e9 bias would round both cases to one
    float32 value)."""
    vis = layers.cast(layers.sequence_mask(lengths, maxlen=int(maxlen)),
                      dtype)
    return layers.reshape(
        layers.scale(vis, scale=1e9, bias=-1.0, bias_after_scale=False),
        [batch, 1, 1, int(maxlen)])


def _causal_bias(T, dtype="float32"):
    """Additive causal mask [1, 1, T, T]: 0 on and below the diagonal,
    -1e9 above (future positions)."""
    m = np.triu(np.full((T, T), -1e9, dtype=dtype), k=1)
    return layers.assign(m.reshape(1, 1, T, T))


def multi_head_attention(q_in, num_heads, d_model, dropout=0.0,
                         is_test=False, attn_bias=None, kv_in=None,
                         use_flash=None, kv_lengths=None, causal=False):
    """Attention over [B, T, D]: self-attention, or cross attention over
    ``kv_in`` ([B, T_kv, D]). ``attn_bias`` is an additive mask
    broadcastable to [B, H, T, T_kv]; ``kv_lengths`` ([B] int) masks keys
    past each row's length, inside the flash kernel or as a dense
    ``_padding_bias``; ``causal`` composes with it. ``use_flash=None``
    picks the flash op under the JAX package's rule; True or False
    force it."""
    B, T, D = q_in.shape
    kv = q_in if kv_in is None else kv_in
    T_kv = kv.shape[1]
    head = d_model // num_heads
    q = _dense(q_in, d_model)
    k = _dense(kv, d_model)
    v = _dense(kv, d_model)

    def split_heads(x, t):
        x = layers.reshape(x, [B, t, num_heads, head])
        return layers.transpose(x, [0, 2, 1, 3])  # [B, H, t, head]

    q = split_heads(q, T)
    k, v = split_heads(k, T_kv), split_heads(v, T_kv)
    if use_flash is None:
        # self-attention only, as the JAX package decides
        use_flash = attn_bias is None and kv_in is None and (
            is_test or dropout == 0) and (
            kv_lengths is not None or is_test or T >= 2048)
    elif use_flash:
        if attn_bias is not None:
            raise ValueError(
                "use_flash=True: the flash kernel has no additive-mask "
                "support; express the mask as causal=True and/or "
                "kv_lengths (padding)")
        if dropout != 0 and not is_test:
            raise ValueError(
                "use_flash=True: attention dropout is not supported in "
                "the flash kernel; set dropout=0")
    if use_flash and attn_bias is None and (is_test or dropout == 0):
        helper = LayerHelper("flash_attention", input=q_in)
        ctx = helper.create_variable_for_type_inference(q_in.dtype)
        ins = {"Q": [q], "K": [k], "V": [v]}
        if kv_lengths is not None:
            ins["Lengths"] = [kv_lengths]
        helper.append_op("flash_attention", inputs=ins,
                         outputs={"Out": [ctx]},
                         attrs={"causal": bool(causal),
                                "scale": float(head) ** -0.5},
                         infer_shape=False)
        ctx.shape = (B, num_heads, T, head)
    else:
        _no_dropout(dropout)
        q = layers.scale(q, scale=float(head) ** -0.5)
        scores = layers.matmul(q, k, transpose_y=True)  # [B, H, T, T_kv]
        if attn_bias is not None:
            scores = layers.elementwise_add(scores, attn_bias)
        if kv_lengths is not None:
            scores = layers.elementwise_add(
                scores, _padding_bias(kv_lengths, T_kv, B, scores.dtype))
        if causal:
            scores = layers.elementwise_add(
                scores, _causal_bias(T, dtype=scores.dtype))
        ctx = layers.matmul(layers.softmax(scores), v)  # [B, H, T, head]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [B, T, d_model])
    return _dense(ctx, d_model)


def encoder_layer(x, num_heads, d_model, d_ff, dropout=0.0, is_test=False,
                  attn_bias=None, kv_lengths=None):
    _no_dropout(dropout)
    attn = multi_head_attention(x, num_heads, d_model, dropout, is_test,
                                attn_bias, kv_lengths=kv_lengths)
    x = layers.layer_norm(layers.elementwise_add(x, attn),
                          begin_norm_axis=2)
    ff = _dense(x, d_ff, act="gelu")
    ff = _dense(ff, d_model)
    return layers.layer_norm(layers.elementwise_add(x, ff),
                             begin_norm_axis=2)


def transformer_encoder(src_ids, pos_ids, vocab_size, max_len=512,
                        num_layers=12, num_heads=12, d_model=768,
                        d_ff=3072, dropout=0.0, is_test=False,
                        attn_bias=None, src_lengths=None):
    """BERT-style encoder over int64 [B, T] token + position ids; returns
    [B, T, d_model] encodings. ``src_lengths`` ([B] int) masks padded
    keys inside the flash-attention kernel."""
    emb = layers.embedding(src_ids, size=[vocab_size, d_model])
    pos = layers.embedding(pos_ids, size=[max_len, d_model])
    x = layers.elementwise_add(emb, pos)
    x = layers.layer_norm(x, begin_norm_axis=2)
    for _ in range(num_layers):
        x = encoder_layer(x, num_heads, d_model, d_ff, dropout, is_test,
                          attn_bias, kv_lengths=src_lengths)
    return x


def bert_base_pretrain(src_ids, pos_ids, masked_positions, vocab_size=30522,
                       max_len=512, num_layers=12, num_heads=12,
                       d_model=768, d_ff=3072, dropout=0.0, is_test=False,
                       attn_bias=None):
    """The masked-LM head over the encoder: vocabulary logits [B, M, V] at
    ``masked_positions`` (int64 [B, M] indices into T)."""
    enc = transformer_encoder(src_ids, pos_ids, vocab_size, max_len,
                              num_layers, num_heads, d_model, d_ff,
                              dropout, is_test, attn_bias)
    B, T, D = enc.shape
    M = masked_positions.shape[1]
    flat = layers.reshape(enc, [B * T, D])
    # flat row index = b * T + position
    row_base = layers.reshape(layers.range(0, B * T, T, "int64"), [B, 1])
    gather_idx = layers.reshape(
        layers.elementwise_add(masked_positions,
                               layers.expand(row_base, [1, M])),
        [B * M])
    picked = layers.gather(flat, gather_idx)  # [B * M, D]
    logits = layers.fc(picked, size=vocab_size, num_flatten_dims=1)
    return layers.reshape(logits, [B, M, vocab_size])


def decoder_layer(y, enc, num_heads, d_model, d_ff, dropout=0.0,
                  is_test=False, self_bias=None, cross_bias=None,
                  tgt_lengths=None):
    """Post-LN decoder block: causal self-attention (the flash kernels
    when ``tgt_lengths`` is given), cross attention over ``enc``, FFN."""
    sa = multi_head_attention(y, num_heads, d_model, dropout, is_test,
                              self_bias, kv_lengths=tgt_lengths,
                              causal=tgt_lengths is not None)
    y = layers.layer_norm(layers.elementwise_add(y, sa), begin_norm_axis=2)
    ca = multi_head_attention(y, num_heads, d_model, dropout, is_test,
                              cross_bias, kv_in=enc)
    y = layers.layer_norm(layers.elementwise_add(y, ca), begin_norm_axis=2)
    ff = _dense(y, d_ff, act="gelu")
    ff = _dense(ff, d_model)
    return layers.layer_norm(layers.elementwise_add(y, ff),
                             begin_norm_axis=2)


def transformer_wmt(src_ids, src_pos, tgt_ids, tgt_pos, vocab_size,
                    max_len=256, num_layers=6, num_heads=8, d_model=512,
                    d_ff=2048, dropout=0.0, is_test=False,
                    src_lengths=None, tgt_lengths=None):
    """Transformer-base seq2seq: the encoder over source tokens, a decoder
    stack of causal self-attention and cross attention, vocabulary logits
    [B, T_tgt, V]. With ``src_lengths`` / ``tgt_lengths`` the padded
    encoder self-attention and the causal, padded decoder self-attention
    run the flash kernels; cross attention (T_tgt x T_src) stays dense
    with an additive bias built from ``src_lengths``. Without lengths the
    decoder's self-attention is dense under ``_causal_bias``."""
    enc = transformer_encoder(src_ids, src_pos, vocab_size, max_len,
                              num_layers, num_heads, d_model, d_ff,
                              dropout, is_test, src_lengths=src_lengths)
    emb = layers.embedding(tgt_ids, size=[vocab_size, d_model])
    pos = layers.embedding(tgt_pos, size=[max_len, d_model])
    y = layers.layer_norm(layers.elementwise_add(emb, pos),
                          begin_norm_axis=2)
    B, T, _ = y.shape
    self_bias = None if tgt_lengths is not None else _causal_bias(int(T))
    cross_bias = None
    if src_lengths is not None:
        cross_bias = _padding_bias(src_lengths, src_ids.shape[1], B)
    for _ in range(num_layers):
        y = decoder_layer(y, enc, num_heads, d_model, d_ff, dropout,
                          is_test, self_bias=self_bias,
                          cross_bias=cross_bias, tgt_lengths=tgt_lengths)
    return layers.fc(y, size=vocab_size, num_flatten_dims=2)


def _optimizer(learning_rate, use_bf16):
    opt = optimizer.AdamOptimizer(learning_rate)
    return mp.decorate(opt) if use_bf16 else opt


def build_transformer_wmt(batch, seq_len, use_lengths=True, vocab=32000,
                          num_layers=6, num_heads=8, d_model=512, d_ff=2048,
                          learning_rate=1e-4, seed=0, use_bf16=True):
    """(main, startup, loss, params_grads) of bench.py's WMT script under
    fresh names: with ``use_lengths``, the loss is the softmax cross
    entropy summed over non-pad target tokens over their count (plus
    1e-6), else its mean. ``seed`` is the startup program's random
    seed; ``use_bf16`` wraps the optimizer in ``mp.decorate``."""
    main, startup = framework.Program(), framework.Program()
    startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        src, spos, tgt, tpos = (
            fluid_data(name=n, shape=[batch, seq_len], dtype="int64")
            for n in ("src", "spos", "tgt", "tpos"))
        lbl = fluid_data(name="lbl", shape=[batch, seq_len, 1],
                         dtype="int64")
        slen = tlen = None
        if use_lengths:
            slen = fluid_data(name="slen", shape=[batch], dtype="int32")
            tlen = fluid_data(name="tlen", shape=[batch], dtype="int32")
        logits = transformer_wmt(src, spos, tgt, tpos, vocab_size=vocab,
                                 max_len=seq_len, num_layers=num_layers,
                                 num_heads=num_heads, d_model=d_model,
                                 d_ff=d_ff, src_lengths=slen,
                                 tgt_lengths=tlen)
        ce = layers.softmax_with_cross_entropy(
            layers.reshape(logits, [batch * seq_len, vocab]),
            layers.reshape(lbl, [batch * seq_len, 1]))
        if use_lengths:
            w = layers.cast(layers.sequence_mask(tlen, maxlen=seq_len),
                            "float32")
            w = layers.reshape(w, [batch * seq_len, 1])
            loss = layers.reduce_sum(layers.elementwise_mul(ce, w)) / (
                layers.reduce_sum(w) + 1e-6)
        else:
            loss = layers.mean(ce)
        _, params_grads = _optimizer(learning_rate, use_bf16).minimize(loss)
    return main, startup, loss, params_grads


def wmt_batch(rng, batch, seq_len, vocab=32000, use_lengths=True):
    """bench.py's WMT feeds (``bench_transformer_wmt``) from a numpy
    ``RandomState``: random source, target and label tokens, positions
    0..S-1, and lengths drawn from [S/2, S]."""
    pos = np.tile(np.arange(seq_len), (batch, 1)).astype("int64")
    feed = {"src": rng.randint(0, vocab, (batch, seq_len)).astype("int64"),
            "spos": pos, "tpos": pos,
            "tgt": rng.randint(0, vocab, (batch, seq_len)).astype("int64"),
            "lbl": rng.randint(0, vocab,
                               (batch, seq_len, 1)).astype("int64")}
    if use_lengths:
        for n in ("slen", "tlen"):
            feed[n] = rng.randint(seq_len // 2, seq_len + 1,
                                  (batch,)).astype("int32")
    return feed


def build_bert_base(batch, seq_len, vocab=30522, num_layers=12,
                    num_heads=12, d_model=768, d_ff=3072, masked=20,
                    learning_rate=1e-4, seed=0, use_bf16=True):
    """(main, startup, loss, params_grads) of bench.py's BERT masked-LM
    script under fresh names: the mean softmax cross entropy of the
    vocabulary logits at ``masked`` positions a row. ``seed`` is the
    startup program's random seed; ``use_bf16`` wraps the optimizer in
    ``mp.decorate``."""
    M = masked
    main, startup = framework.Program(), framework.Program()
    startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        src = fluid_data(name="src", shape=[batch, seq_len], dtype="int64")
        pos = fluid_data(name="pos", shape=[batch, seq_len], dtype="int64")
        mpos = fluid_data(name="mpos", shape=[batch, M], dtype="int64")
        labels = fluid_data(name="labels", shape=[batch, M, 1],
                            dtype="int64")
        logits = bert_base_pretrain(src, pos, mpos, vocab_size=vocab,
                                    max_len=seq_len, num_layers=num_layers,
                                    num_heads=num_heads, d_model=d_model,
                                    d_ff=d_ff)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, [batch * M, vocab]),
            layers.reshape(labels, [batch * M, 1])))
        _, params_grads = _optimizer(learning_rate, use_bf16).minimize(loss)
    return main, startup, loss, params_grads


def bert_batch(rng, batch, seq_len, vocab=30522, masked=20):
    """bench.py's BERT feeds (``bench_bert_base``) from a numpy
    ``RandomState``: random tokens, positions 0..S-1, masked positions
    and labels."""
    return {"src": rng.randint(0, vocab, (batch, seq_len)).astype("int64"),
            "pos": np.tile(np.arange(seq_len), (batch, 1)).astype("int64"),
            "mpos": rng.randint(0, seq_len, (batch, masked)).astype("int64"),
            "labels": rng.randint(0, vocab,
                                  (batch, masked, 1)).astype("int64")}
