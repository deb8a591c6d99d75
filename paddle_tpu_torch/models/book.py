"""The Fluid book's chapters, as ``tests/test_book.py`` builds them.

Each function writes its chapter against the Fluid API of the package
module it is given (``fluid``, this package when None) and returns a
``Chapter``: the training program and its startup, the loss, the feed
names and targets of the chapter's inference model, and, where the chapter
has one, the program it saves for inference (``infer``; None means the
training program, which ``save_inference_model`` prunes to the targets).
The defaults are ``test_book.py``'s widths, the tables sized by this
package's offline readers; ``chip_smoke.py`` passes the book's widths and
the published tables (``PUBLISHED``).

- ``fit_a_line``: uci_housing's 13 features to one price, ``fc`` and
  ``square_error_cost``.
- ``word2vec``: four context words through one shared embedding, a hidden
  ``fc``, a softmax over the imikolov dictionary.
- ``recommender_system``: the dual tower (user id, gender, age and job
  embeddings against the movie id's), ``cos_sim`` scaled by 5,
  ``square_error_cost`` against the rating. The book's movie title and
  category towers (LoD) are not built, as in ``test_book.py``.
- ``understand_sentiment``: an ``LSTMCell`` over padded tokens with their
  lengths, max-pooled, a softmax classifier.
- ``machine_translation``: a GRU encoder-decoder trained by teacher
  forcing; ``mt_decode`` is its beam-search generator, sharing the
  trained embeddings and output layer by name.
- ``label_semantic_roles``: word, verb and mark embeddings, one LSTM
  layer, a ``linear_chain_crf``; its ``infer`` program adds
  ``crf_decoding`` and ``chunk_eval`` (IOB) to the test clone.

``batches(chapter, ...)`` yields a chapter's feed dicts from this
package's ``dataset`` readers, as ``test_book.py`` batches them.
``seeded_batches`` draws them from a seed over the published tables, which
the offline readers' small dictionaries do not fill.
"""
from __future__ import annotations

import collections
import math

import numpy as np

from .. import dataset

__all__ = ["Chapter", "fit_a_line", "word2vec", "recommender_system",
           "understand_sentiment", "machine_translation", "mt_decode",
           "label_semantic_roles", "batches", "seeded_batches",
           "CHAPTERS", "PUBLISHED"]

Chapter = collections.namedtuple(
    "Chapter", "main startup loss feed_names targets infer")

# The tables of the published datasets, for the chapters whose offline
# readers draw from small dictionaries: imikolov's PTB dictionary at
# min_word_freq 50; MovieLens-1M's user and movie ids (1-based);
# CoNLL-05's word, verb and label dictionaries (B-/I- of each argument
# type and O).
PUBLISHED = {
    "word2vec": dict(dict_size=2073),
    "recommender_system": dict(users=6040, movies=3952),
    "label_semantic_roles": dict(words=44068, verbs=3162, labels=59),
}


def _pkg(fluid):
    if fluid is None:
        import paddle_tpu_torch as fluid
    return fluid


def _optimizer(fluid, kind, lr):
    return (fluid.optimizer.SGD(lr) if kind == "sgd"
            else fluid.optimizer.AdamOptimizer(lr))


def fit_a_line(fluid=None, batch=20, lr=0.01, optimizer="sgd"):
    fluid = _pkg(fluid)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[batch, 13], dtype="float32")
        y = fluid.data(name="y", shape=[batch, 1], dtype="float32")
        pred = L.fc(x, size=1)
        loss = L.mean(L.square_error_cost(pred, y))
        _optimizer(fluid, optimizer, lr).minimize(loss)
    return Chapter(main, startup, loss, ["x"], [pred], None)


def word2vec(fluid=None, batch=32, embed=16, hidden=64, lr=5e-3,
             optimizer="adam", dict_size=None):
    fluid = _pkg(fluid)
    L = fluid.layers
    V = dict_size or len(dataset.imikolov.build_dict())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ws = [fluid.data(name="w%d" % i, shape=[batch, 1], dtype="int64")
              for i in range(4)]
        nxt = fluid.data(name="nxt", shape=[batch, 1], dtype="int64")
        embs = [L.embedding(w, size=[V, embed],
                            param_attr=fluid.ParamAttr(name="shared_emb"))
                for w in ws]
        concat = L.reshape(L.concat(embs, axis=-1), [batch, 4 * embed])
        h = L.fc(concat, size=hidden, act="sigmoid")
        pred = L.fc(h, size=V, act="softmax")
        loss = L.mean(L.cross_entropy(pred, nxt))
        _optimizer(fluid, optimizer, lr).minimize(loss)
    return Chapter(main, startup, loss, ["w%d" % i for i in range(4)],
                   [pred], None)


def recommender_system(fluid=None, batch=32, uid_embed=16, feat_embed=16,
                       mov_embed=32, hidden=32, act="relu", lr=1e-2,
                       optimizer="adam", users=None, movies=None):
    fluid = _pkg(fluid)
    L = fluid.layers
    ml = dataset.movielens
    users = users or ml.max_user_id()
    movies = movies or ml.max_movie_id()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        def slot(name, dtype="int64"):
            return fluid.data(name=name, shape=[batch, 1], dtype=dtype)

        uid, gender, age, job, mid = (slot(n) for n in
                                      ("uid", "gender", "age", "job", "mid"))
        rating = slot("rating", "float32")
        usr = L.concat([
            L.reshape(L.embedding(v, size=[n, d]), [batch, d])
            for v, n, d in [(uid, users + 1, uid_embed),
                            (gender, 2, feat_embed),
                            (age, len(ml.age_table), feat_embed),
                            (job, ml.max_job_id() + 1, feat_embed)]],
            axis=1)
        usr = L.fc(usr, size=hidden, act=act)
        mov = L.reshape(L.embedding(mid, size=[movies + 1, mov_embed]),
                        [batch, mov_embed])
        mov = L.fc(mov, size=hidden, act=act)
        pred = L.scale(L.cos_sim(usr, mov), scale=5.0)
        loss = L.mean(L.square_error_cost(pred, rating))
        _optimizer(fluid, optimizer, lr).minimize(loss)
    return Chapter(main, startup, loss,
                   ["uid", "gender", "age", "job", "mid"], [pred], None)


def understand_sentiment(fluid=None, batch=32, seq=16, embed=16, hidden=32,
                         lr=5e-3):
    fluid = _pkg(fluid)
    L = fluid.layers
    V = len(dataset.imdb.word_dict())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        toks = fluid.data(name="toks", shape=[batch, seq], dtype="int64")
        lens = fluid.data(name="lens", shape=[batch], dtype="int64")
        lab = fluid.data(name="lab", shape=[batch, 1], dtype="int64")
        emb = L.embedding(toks, size=[V, embed])
        outs, _ = L.rnn(L.LSTMCell(hidden_size=hidden), emb,
                        sequence_length=lens)
        pred = L.fc(L.reduce_max(outs, dim=1), size=2, act="softmax")
        loss = L.mean(L.cross_entropy(pred, lab))
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return Chapter(main, startup, loss, ["toks", "lens"], [pred], None)


def machine_translation(fluid=None, batch=16, seq=10, vocab=30, embed=16,
                        hidden=32, lr=5e-3):
    fluid = _pkg(fluid)
    L = fluid.layers
    B, T = batch, seq
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data(name="src", shape=[B, T], dtype="int64")
        trg_in = fluid.data(name="trg_in", shape=[B, T], dtype="int64")
        trg_out = fluid.data(name="trg_out", shape=[B, T], dtype="int64")
        src_emb = L.embedding(src, size=[vocab, embed],
                              param_attr=fluid.ParamAttr(name="semb"))
        _, enc_final = L.rnn(L.GRUCell(hidden_size=hidden, name="enc"),
                             src_emb)
        dec_emb = L.embedding(trg_in, size=[vocab, embed],
                              param_attr=fluid.ParamAttr(name="temb"))
        dec_out, _ = L.rnn(L.GRUCell(hidden_size=hidden, name="dec"),
                           dec_emb, initial_states=enc_final)
        logits = L.fc(L.reshape(dec_out, [B * T, hidden]), size=vocab,
                      param_attr=fluid.ParamAttr(name="out_w"),
                      bias_attr=False)
        loss = L.mean(L.cross_entropy(L.softmax(logits),
                                      L.reshape(trg_out, [B * T, 1])))
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return Chapter(main, startup, loss, ["src"], [], None)


def mt_decode(fluid=None, batch=16, seq=10, vocab=30, embed=16, hidden=32,
              beam=3, steps=None):
    """The generator: a new encoder cell whose projection is the trained
    ``enc_proj_w``, a new decoder cell, and the trained embeddings and
    output layer, by name. Returns (program, its startup, the ids
    ``[B, steps, beam]``)."""
    fluid = _pkg(fluid)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data(name="src", shape=[batch, seq], dtype="int64")
        src_emb = L.embedding(src, size=[vocab, embed],
                              param_attr=fluid.ParamAttr(name="semb"))
        enc_cell = L.GRUCell(hidden_size=hidden, name="enc2")
        enc_cell._proj_attr = fluid.ParamAttr(name="enc_proj_w")
        _, enc_final = L.rnn(enc_cell, src_emb)
        decoder = L.BeamSearchDecoder(
            L.GRUCell(hidden_size=hidden, name="dec2"), start_token=0,
            end_token=1, beam_size=beam,
            embedding_fn=lambda ids: L.embedding(
                ids, size=[vocab, embed],
                param_attr=fluid.ParamAttr(name="temb")),
            output_fn=lambda x: L.fc(
                x, size=vocab, param_attr=fluid.ParamAttr(name="out_w"),
                bias_attr=False))
        outs, _ = L.dynamic_decode(decoder, inits=enc_final,
                                   max_step_num=steps or seq)
    return main, startup, outs


def label_semantic_roles(fluid=None, batch=8, seq=5, embed=16, mark=4,
                         hidden=32, lr=0.05, words=None, verbs=None,
                         labels=None):
    fluid = _pkg(fluid)
    L = fluid.layers
    wd, vd, ld = dataset.conll05.get_dict()
    NW, NV = words or len(wd), verbs or len(vd)
    B, T, NL = batch, seq, labels or len(ld)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.data(name="words", shape=[B, T], dtype="int64")
        verb = fluid.data(name="verb", shape=[B, T], dtype="int64")
        mk = fluid.data(name="mark", shape=[B, T], dtype="int64")
        target = fluid.data(name="target", shape=[B, T], dtype="int64")
        feats = L.concat([L.embedding(words, size=[NW, embed]),
                          L.embedding(verb, size=[NV, embed]),
                          L.embedding(mk, size=[2, mark])], axis=-1)
        outs, _ = L.rnn(L.LSTMCell(hidden_size=hidden), feats)
        emission = L.reshape(L.fc(L.reshape(outs, [B * T, hidden]),
                                  size=NL), [B, T, NL])
        crfw = fluid.ParamAttr(name="crfw")
        loss = L.mean(L.linear_chain_crf(emission, target, param_attr=crfw))
        fluid.optimizer.SGD(lr).minimize(loss)
    infer = main.clone(for_test=True)
    with fluid.unique_name.guard(), fluid.program_guard(infer, startup):
        blk = infer.global_block()
        path = L.crf_decoding(blk.var(emission.name), param_attr=crfw)
        chunks = L.chunk_eval(path, blk.var(target.name), chunk_scheme="IOB",
                              num_chunk_types=int(math.ceil((NL - 1) / 2.0)))
    return Chapter(main, startup, loss, ["words", "verb", "mark", "target"],
                   [path] + list(chunks[:3]), infer)


CHAPTERS = {"fit_a_line": fit_a_line, "word2vec": word2vec,
            "recommender_system": recommender_system,
            "understand_sentiment": understand_sentiment,
            "machine_translation": machine_translation,
            "label_semantic_roles": label_semantic_roles}


# -- the feeds ----------------------------------------------------------------


def _pad(ids, seq, fill=0):
    out = np.full((seq,), fill, "int64")
    n = min(len(ids), seq)
    out[:n] = ids[:n]
    return out, n


def _samples(name, vocab):
    """One pass over chapter ``name``'s reader."""
    if name == "fit_a_line":
        return ((x, np.asarray(y, "float32").reshape(1))
                for x, y in dataset.uci_housing.train()())
    if name == "word2vec":
        return dataset.imikolov.train(dataset.imikolov.build_dict(), 5)()
    if name == "recommender_system":
        return ((s[0], s[1], s[2], s[3], s[4], s[7])
                for s in dataset.movielens.train()())
    if name == "understand_sentiment":
        return dataset.imdb.train(dataset.imdb.word_dict())()
    if name == "machine_translation":
        return dataset.wmt14.train(vocab)()
    if name == "label_semantic_roles":
        return dataset.conll05.test()()
    raise KeyError(name)


def _feed(name, buf, seq):
    B = len(buf)
    if name == "fit_a_line":
        return {"x": np.asarray([s[0] for s in buf], "float32"),
                "y": np.asarray([s[1] for s in buf], "float32")}
    if name == "word2vec":
        cols = ["w0", "w1", "w2", "w3", "nxt"]
        return {c: np.asarray([s[i] for s in buf], "int64").reshape(B, 1)
                for i, c in enumerate(cols)}
    if name == "recommender_system":
        cols = ["uid", "gender", "age", "job", "mid", "rating"]
        return {c: np.asarray([s[i] for s in buf],
                              "float32" if c == "rating" else "int64"
                              ).reshape(B, 1) for i, c in enumerate(cols)}
    if name == "understand_sentiment":
        padded = [_pad(ids, seq) for ids, _ in buf]
        return {"toks": np.stack([p[0] for p in padded]),
                "lens": np.asarray([p[1] for p in padded], "int64"),
                "lab": np.asarray([l for _, l in buf],
                                  "int64").reshape(B, 1)}
    if name == "machine_translation":
        return {k: np.stack([_pad(s[i], seq, fill=1)[0] for s in buf])
                for i, k in enumerate(("src", "trg_in", "trg_out"))}
    return {k: np.asarray([s[i] for s in buf], "int64")
            for k, i in (("words", 0), ("verb", 6), ("mark", 7),
                         ("target", 8))}


def batches(name, batch, epochs=1, limit=None, seq=None, vocab=30):
    """Feed dicts of ``batch`` samples of chapter ``name`` over ``epochs``
    passes of its reader, as ``test_book.py`` batches them: with
    ``limit``, at most that many batches an epoch, each epoch from a fresh
    buffer (fit_a_line, word2vec); without, one buffer across the epochs.
    ``seq`` pads the sentiment and translation sentences (16 and 10 by
    default), ``vocab`` is the translation dictionary's size."""
    seq = seq or (16 if name == "understand_sentiment" else 10)
    buf = []
    for _ in range(epochs):
        if limit:
            buf, count = [], 0
        for s in _samples(name, vocab):
            buf.append(s)
            if len(buf) == batch:
                yield _feed(name, buf, seq)
                buf = []
                if limit:
                    count += 1
                    if count >= limit:
                        break


def seeded_batches(name, n, rng, cfg):
    """``n`` feed dicts of chapter ``name`` built with keyword arguments
    ``cfg`` (those of ``PUBLISHED`` among them), every id drawn from
    ``rng`` uniformly over its table: word2vec's five words; MovieLens'
    user, gender, age, job, movie and a rating of 1-5; CoNLL-05 sentences
    of ``cfg["seq"]`` words, one predicate each (its id on every token,
    the mark 1 within two words of it) and a label a word."""
    B = cfg["batch"]

    def ids(high, shape, low=0):
        return rng.randint(low, high, shape).astype("int64")

    out = []
    for _ in range(n):
        if name == "word2vec":
            feed = {k: ids(cfg["dict_size"], (B, 1))
                    for k in ("w0", "w1", "w2", "w3", "nxt")}
        elif name == "recommender_system":
            ml = dataset.movielens
            feed = {"uid": ids(cfg["users"] + 1, (B, 1), 1),
                    "gender": ids(2, (B, 1)),
                    "age": ids(len(ml.age_table), (B, 1)),
                    "job": ids(ml.max_job_id() + 1, (B, 1)),
                    "mid": ids(cfg["movies"] + 1, (B, 1), 1),
                    "rating": ids(6, (B, 1), 1).astype("float32")}
        elif name == "label_semantic_roles":
            T = cfg["seq"]
            at = rng.randint(0, T, (B, 1))
            feed = {"words": ids(cfg["words"], (B, T)),
                    "verb": np.repeat(ids(cfg["verbs"], (B, 1)), T, 1),
                    "mark": (np.abs(np.arange(T)[None] - at) <= 2
                             ).astype("int64"),
                    "target": ids(cfg["labels"], (B, T))}
        else:
            raise KeyError(name)
        out.append(feed)
    return out
