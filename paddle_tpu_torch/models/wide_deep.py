"""Wide&Deep CTR model (north-star config 5), and bench.py's training
script of it.

Counterpart of ``paddle_tpu/models/wide_deep.py``: one embedding table a
sparse slot (or one shared table) looked up through ``slice``, the
embeddings ``concat``-ed with the dense features into a ReLU MLP (the
deep part), a linear layer over the dense features (the wide part), both
``concat``-ed into a softmax over two classes. The same layers, ops,
attrs and parameter names as the JAX model.

``build_wide_deep`` is bench.py's ``_build_wide_deep`` (:596-611): batch
2048, vocab 100000, 26 sparse slots, 13 dense features, embeddings of 16,
hidden (64, 32), the mean cross entropy and ``AdamOptimizer(1e-3)``:
34 parameters, 41,629,794 elements, under one Adam instance, so on the
card one K4 launch a step once the fused-optimizer pass runs.
``random_batch`` makes the feeds as ``bench_wide_deep`` (:623-627) does.
"""
from __future__ import annotations

from .. import framework, layers, optimizer
from ..layers.io import fluid_data
from ..param_attr import ParamAttr
from ..utils import unique_name

WIDE_DEEP = dict(batch=2048, vocab=100000, slots=26, dense_dim=13)


def wide_deep(dense_input, sparse_ids, vocab_size, embed_dim=16,
              hidden_sizes=(64, 32), is_sparse=False,
              is_distributed=False, shared_table_name=None):
    """``dense_input`` [N, Dd] float32, ``sparse_ids`` [N, S] int64 feature
    ids; returns the [N, 2] softmax. ``shared_table_name`` makes every slot
    look up one table of that name."""
    embs = []
    for i in range(int(sparse_ids.shape[1])):
        ids = layers.slice(sparse_ids, axes=[1], starts=[i], ends=[i + 1])
        emb = layers.embedding(
            ids, size=[vocab_size, embed_dim], is_sparse=is_sparse,
            is_distributed=is_distributed,
            param_attr=(None if shared_table_name is None else
                        ParamAttr(name=shared_table_name)))
        embs.append(layers.reshape(emb, [-1, embed_dim]))
    deep = layers.concat(embs + [dense_input], axis=1)
    for h in hidden_sizes:
        deep = layers.fc(deep, size=h, act="relu")
    wide = layers.fc(dense_input, size=8, act=None)
    merged = layers.concat([wide, deep], axis=1)
    return layers.fc(merged, size=2, act="softmax")


def build_wide_deep(batch, vocab=100000, slots=26, dense_dim=13,
                    learning_rate=1e-3, seed=0):
    """(main, startup, loss, params_grads) of bench.py's Wide&Deep script,
    built under fresh names; ``seed`` is the startup program's random
    seed."""
    main, startup = framework.Program(), framework.Program()
    startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        dense = fluid_data(name="dense", shape=[batch, dense_dim],
                           dtype="float32")
        sparse = fluid_data(name="sparse", shape=[batch, slots],
                            dtype="int64")
        label = fluid_data(name="label", shape=[batch, 1], dtype="int64")
        pred = wide_deep(dense, sparse, vocab_size=vocab)
        loss = layers.mean(layers.cross_entropy(pred, label))
        _, params_grads = optimizer.AdamOptimizer(learning_rate).minimize(
            loss)
    return main, startup, loss, params_grads


def random_batch(rng, batch, vocab=100000, slots=26, dense_dim=13):
    """bench.py's Wide&Deep feeds from a numpy ``RandomState``: dense
    features in [0, 1), ids in [0, vocab), labels in {0, 1}."""
    return {"dense": rng.rand(batch, dense_dim).astype("float32"),
            "sparse": rng.randint(0, vocab, (batch, slots)).astype("int64"),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}
