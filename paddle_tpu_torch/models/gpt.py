"""gpt_long: a small causal language model at long sequence, trained with
Adam.

Counterpart of ``_build_gpt_long`` in bench.py (:794-839), the
configuration that exists to exercise the flash-attention training
kernels: an embedding, ``n_layers`` pre-norm blocks of causal
``flash_attention`` and a gelu MLP with residual adds, a final layer norm
and a vocabulary projection, the mean softmax cross entropy, and
``AdamOptimizer(learning_rate).minimize``. Full width is d_model 1024, 16
heads of 64, vocab 8192, 2 layers, batch 2, seq 4096: 83,912,704
parameters, since ``layer_norm`` normalises over S x D from its default
``begin_norm_axis=1`` and so carries S * D scales and biases, as the model
is written.

With ``use_bf16`` (bench.py's default) the optimizer is wrapped in
``contrib.mixed_precision.decorate``, as bench.py wraps it: the products
run in bfloat16 on float32 master parameters, ``flash_attention`` (on no
AMP list) in float32; ``use_bf16=False`` is bench.py's ``--no-bf16``
float32 program. It builds with this package only; the tests write the
same script against each package to hold the two against each other.
"""
from __future__ import annotations

from .. import framework, layers, optimizer
from ..contrib import mixed_precision as mp
from ..layers.io import fluid_data
from ..utils import unique_name

GPT_LONG = dict(batch=2, seq_len=4096, d_model=1024, n_heads=16,
                n_layers=2, vocab=8192)


def build_gpt_long(batch, seq_len, d_model=1024, n_heads=16, n_layers=2,
                   vocab=8192, learning_rate=1e-4, seed=0, use_bf16=True):
    """(main, startup, loss, params_grads) of the training program, built
    under fresh names; ``seed`` is the startup program's random seed,
    ``use_bf16`` wraps the optimizer in ``mp.decorate``."""
    head = d_model // n_heads
    main, startup = framework.Program(), framework.Program()
    startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        ids = fluid_data(name="ids", shape=[batch, seq_len], dtype="int64")
        lbl = fluid_data(name="lbl", shape=[batch * seq_len, 1],
                         dtype="int64")
        x = layers.embedding(ids, size=(vocab, d_model))
        for _ in range(n_layers):
            h = layers.layer_norm(x)
            q = layers.fc(h, d_model, num_flatten_dims=2)
            k = layers.fc(h, d_model, num_flatten_dims=2)
            v = layers.fc(h, d_model, num_flatten_dims=2)

            def heads(t):
                t = layers.reshape(t, [batch, seq_len, n_heads, head])
                return layers.transpose(t, [0, 2, 1, 3])

            ctx = layers.flash_attention(heads(q), heads(k), heads(v),
                                         causal=True)
            ctx = layers.transpose(ctx, [0, 2, 1, 3])
            ctx = layers.reshape(ctx, [batch, seq_len, d_model])
            x = x + layers.fc(ctx, d_model, num_flatten_dims=2)
            m = layers.layer_norm(x)
            m = layers.fc(m, d_model * 4, num_flatten_dims=2, act="gelu")
            x = x + layers.fc(m, d_model, num_flatten_dims=2)
        logits = layers.fc(layers.layer_norm(x), vocab, num_flatten_dims=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, [batch * seq_len, vocab]), lbl))
        opt = optimizer.AdamOptimizer(learning_rate)
        if use_bf16:
            opt = mp.decorate(opt)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def random_batch(rng, batch, seq_len, vocab):
    """Seeded ids and next-token labels (numpy ``RandomState``)."""
    return {"ids": rng.randint(0, vocab, (batch, seq_len)).astype("int64"),
            "lbl": rng.randint(0, vocab,
                               (batch * seq_len, 1)).astype("int64")}
