"""RNNsearch (Bahdanau, Cho and Bengio, ICLR 2015) as the Fluid 1.x
models repository wrote it on ``DynamicRNN``
(``fluid/PaddleNLP/neural_machine_translation/rnn_search/
attention_model.py``, and its ``--no_attention`` twin
``no_attention_model.py``), written against the Fluid API of the package
module it is given (this package when None), as ``models/book.py`` is, so
that the same script builds the JAX package's program.

- The encoder: source embeddings, ``fc`` to 4 x ``enc`` (tanh, no bias)
  into ``dynamic_lstm`` forward and again into a reversed one (no
  peepholes), concatenated; ``encoder_proj`` is an ``fc`` of that to
  ``dec`` without a bias; the decoder's boot is ``fc(sequence_pool(
  reversed, 'first'), dec, act='tanh')``.
- ``train_program``: a ``DynamicRNN`` decoder over the target embeddings.
  With attention its static inputs are the encoded vectors and their
  projection, and each step's context is ``simple_attention``
  (``sequence_expand`` of the projected state onto the source rows, an
  ``fc`` to one score a row, ``sequence_softmax``, the weighted rows
  summed by ``sequence_pool``); without it, the encoder's last step is the
  one static input. ``lstm_step`` is the script's, four ``fc`` gates and
  ``sums``; the output layer is ``fc(trg_dict, act='softmax')``; the loss
  is ``mean(cross_entropy)`` over the LoD target; Adam.
- ``generate_program``: the same encoder, then a ``While`` over arrays
  of ids, scores and states, as the book's generator loops: each trip
  expands the states to the live beams with ``sequence_expand`` by the
  scores' LoD, recomputes attention and ``lstm_step``, takes ``topk`` of
  the softmax, adds the log probabilities to the accumulated scores,
  runs ``beam_search`` and stops at ``max_len`` trips or when every beam
  has ended (``is_empty``); ``beam_search_decode`` backtraces after the
  loop. The encoder rows reach each beam padded to ``max_src`` rows
  (``sequence_pad``), expanded with the states, and attention masks the
  padding (-1e9 before the softmax), so a trip needs no LoD of the
  source.

The cell's memory starts at zeros through ``memory(shape=...)`` where the
script boots it from ``fill_constant_batch_size_like``: the same values.
Every parameter is named, so the generator reads the trained weights.
The outputs of ``array_read`` and ``beam_search`` get their shapes here,
which the layers leave unset (both packages' shape inference needs them).
"""
from __future__ import annotations

import numpy as np

__all__ = ["RNN_SEARCH", "NARROW", "train_program", "generate_program",
           "train_batch", "source_batch", "n_params"]

# The widths recalled from the models repository's args.py; batch 64 is
# this port's choice. Ids 0, 1 and 2 are <s>, <e> and <unk>.
RNN_SEARCH = dict(src_dict=30000, trg_dict=30000, emb=512, enc=512, dec=512,
                  beam=3, max_len=50, max_src=50, batch=64, lr=2e-4,
                  lengths=(10, 50), start=0, end=1)
NARROW = dict(src_dict=50, trg_dict=50, emb=8, enc=8, dec=16, beam=3,
              max_len=6, max_src=6, batch=4, lr=2e-4, lengths=(2, 6),
              start=0, end=1)


def _pkg(fluid):
    if fluid is None:
        import paddle_tpu_torch as fluid
    return fluid


def _attr(fluid, name):
    return fluid.ParamAttr(name=name)


def _encoder(fluid, cfg):
    L = fluid.layers
    H = cfg["enc"]
    src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(src, size=[cfg["src_dict"], cfg["emb"]],
                      param_attr=_attr(fluid, "src_emb"))

    def direction(name, reverse):
        proj = L.fc(emb, size=4 * H, act="tanh", bias_attr=False,
                    param_attr=_attr(fluid, name + "_proj_w"))
        hidden, _ = L.dynamic_lstm(
            proj, size=4 * H, use_peepholes=False, is_reverse=reverse,
            param_attr=_attr(fluid, name + "_lstm_w"),
            bias_attr=_attr(fluid, name + "_lstm_b"))
        return hidden

    forward, backward = direction("fwd", False), direction("bwd", True)
    encoded = L.concat([forward, backward], axis=1)
    encoded_proj = L.fc(encoded, size=cfg["dec"], bias_attr=False,
                        param_attr=_attr(fluid, "enc_proj_w"))
    boot = L.fc(L.sequence_pool(backward, "first"), size=cfg["dec"],
                act="tanh", bias_attr=False,
                param_attr=_attr(fluid, "boot_w"))
    return encoded, encoded_proj, boot


def _lstm_step(fluid, x_t, h_prev, c_prev, size):
    L = fluid.layers

    def gate(name, act):
        return act(L.fc([h_prev, x_t], size=size,
                        param_attr=[_attr(fluid, name + "_h"),
                                    _attr(fluid, name + "_x")],
                        bias_attr=_attr(fluid, name + "_b")))

    forget = gate("dec_forget", L.sigmoid)
    inp = gate("dec_input", L.sigmoid)
    out = gate("dec_output", L.sigmoid)
    cand = gate("dec_cell", L.tanh)
    c_t = L.sums([L.elementwise_mul(forget, c_prev),
                  L.elementwise_mul(inp, cand)])
    return L.elementwise_mul(out, L.tanh(c_t)), c_t


def _output(fluid, h, cfg):
    return fluid.layers.fc(h, size=cfg["trg_dict"], act="softmax",
                           param_attr=_attr(fluid, "out_w"),
                           bias_attr=_attr(fluid, "out_b"))


def _simple_attention(fluid, enc_vec, enc_proj, state, cfg):
    L = fluid.layers
    state_proj = L.fc(state, size=cfg["dec"], bias_attr=False,
                      param_attr=_attr(fluid, "att_state_w"))
    mixed = L.elementwise_add(enc_proj, L.sequence_expand(state_proj,
                                                          enc_proj))
    weights = L.sequence_softmax(L.fc(mixed, size=1, bias_attr=False,
                                      param_attr=_attr(fluid, "att_w")))
    scaled = L.elementwise_mul(enc_vec, L.reshape(weights, shape=[-1]),
                               axis=0)
    return L.sequence_pool(scaled, "sum")


def train_program(fluid=None, cfg=RNN_SEARCH, attention=True,
                  optimizer=True):
    """(main, startup, loss): one training step of RNNsearch, or of the
    ``no_attention`` model. The feeds are ``src``, ``trg`` and ``label``
    (``train_batch``)."""
    fluid = _pkg(fluid)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        encoded, encoded_proj, boot = _encoder(fluid, cfg)
        trg = L.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        trg_emb = L.embedding(trg, size=[cfg["trg_dict"], cfg["emb"]],
                              param_attr=_attr(fluid, "trg_emb"))
        context_all = None if attention else L.sequence_last_step(encoded)
        rnn = L.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(trg_emb)
            if attention:
                enc_vec = rnn.static_input(encoded)
                enc_proj = rnn.static_input(encoded_proj)
            else:
                context = rnn.static_input(context_all)
            h_mem = rnn.memory(init=boot)
            c_mem = rnn.memory(shape=[cfg["dec"]], value=0.0)
            if attention:
                context = _simple_attention(fluid, enc_vec, enc_proj, h_mem,
                                            cfg)
            h, c = _lstm_step(fluid, L.concat([context, word], axis=1),
                              h_mem, c_mem, cfg["dec"])
            rnn.update_memory(h_mem, h)
            rnn.update_memory(c_mem, c)
            rnn.output(_output(fluid, h, cfg))
        prediction = rnn()
        label = L.data(name="label", shape=[1], dtype="int64", lod_level=1)
        loss = L.mean(L.cross_entropy(prediction, label))
        if optimizer:
            fluid.optimizer.AdamOptimizer(cfg["lr"]).minimize(loss)
    return main, startup, loss


def _shaped(var, shape, dtype):
    var.shape = tuple(shape)
    var.dtype = dtype
    return var


def generate_program(fluid=None, cfg=RNN_SEARCH, attention=True):
    """(main, startup, sentence ids, sentence scores): beam search over
    ``max_len`` trips at most. The feeds are ``src``, ``init_ids`` and
    ``init_scores`` (``source_batch``); the outputs carry a 2-level LoD
    (source -> sentences -> words)."""
    fluid = _pkg(fluid)
    L = fluid.layers
    S, H, beam = cfg["max_src"], cfg["dec"], cfg["beam"]
    E2 = 2 * cfg["enc"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        encoded, encoded_proj, boot = _encoder(fluid, cfg)
        init_ids = L.data(name="init_ids", shape=[1], dtype="int64",
                          lod_level=2)
        init_scores = L.data(name="init_scores", shape=[1],
                             dtype="float32", lod_level=2)
        carried = [("state", boot, [-1, H], "float32"),
                   ("cell", L.zeros_like(boot), [-1, H], "float32")]
        if attention:
            pad = L.fill_constant([1], "float32", 0.0)
            enc_pad, length = L.sequence_pad(encoded, pad, maxlen=S)
            proj_pad, _ = L.sequence_pad(encoded_proj, pad, maxlen=S)
            mask = L.reshape(L.sequence_mask(length, maxlen=S,
                                             dtype="float32"), [-1, S])
            carried += [
                ("enc", L.reshape(enc_pad, [-1, S * E2]), [-1, S * E2],
                 "float32"),
                ("proj", L.reshape(proj_pad, [-1, S * H]), [-1, S * H],
                 "float32"),
                ("bias", L.scale(mask, scale=1e9, bias=-1e9), [-1, S],
                 "float32")]
        else:
            carried.append(("context", L.sequence_last_step(encoded),
                            [-1, E2], "float32"))
        counter = L.zeros([1], "int64")
        array_len = L.fill_constant([1], "int64", cfg["max_len"])
        ids_arr = L.array_write(init_ids, counter)
        scores_arr = L.array_write(init_scores, counter)
        arrays = [(name, L.array_write(v, counter), shape, dtype)
                  for name, v, shape, dtype in carried]
        cond = L.less_than(counter, array_len)
        loop = L.While(cond, is_test=True)
        with loop.block():
            pre_ids = _shaped(L.array_read(ids_arr, counter), [-1, 1],
                              "int64")
            pre_scores = _shaped(L.array_read(scores_arr, counter), [-1, 1],
                                 "float32")
            # each carried row to the beams it grew into
            cur = {name: L.sequence_expand(
                _shaped(L.array_read(arr, counter), shape, dtype),
                pre_scores) for name, arr, shape, dtype in arrays}
            emb = L.embedding(pre_ids, size=[cfg["trg_dict"], cfg["emb"]],
                              param_attr=_attr(fluid, "trg_emb"))
            if attention:
                state_proj = L.fc(cur["state"], size=H, bias_attr=False,
                                  param_attr=_attr(fluid, "att_state_w"))
                mixed = L.elementwise_add(
                    L.reshape(cur["proj"], [-1, S, H]),
                    L.unsqueeze(state_proj, [1]))
                logits = L.reshape(
                    L.fc(mixed, size=1, num_flatten_dims=2, bias_attr=False,
                         param_attr=_attr(fluid, "att_w")), [-1, S])
                weights = L.softmax(L.elementwise_add(logits, cur["bias"]))
                context = L.reshape(
                    L.matmul(L.unsqueeze(weights, [1]),
                             L.reshape(cur["enc"], [-1, S, E2])), [-1, E2])
            else:
                context = cur["context"]
            h, c = _lstm_step(fluid, L.concat([context, emb], axis=1),
                              cur["state"], cur["cell"], H)
            probs = _output(fluid, h, cfg)
            top_scores, top_ids = L.topk(probs, k=beam)
            accumulated = L.elementwise_add(
                L.log(top_scores), L.reshape(pre_scores, [-1]), axis=0)
            sel_ids, sel_scores = L.beam_search(
                pre_ids, pre_scores, top_ids, accumulated, beam,
                end_id=cfg["end"], level=0)
            _shaped(sel_ids, [-1, 1], "int64")
            _shaped(sel_scores, [-1, 1], "float32")
            L.increment(counter, value=1, in_place=True)
            L.array_write(sel_ids, counter, array=ids_arr)
            L.array_write(sel_scores, counter, array=scores_arr)
            new = dict(cur, state=h, cell=c)
            for name, arr, _, _ in arrays:
                L.array_write(new[name], counter, array=arr)
            L.logical_and(L.less_than(counter, array_len),
                          L.logical_not(L.is_empty(sel_ids)), out=cond)
        ids, scores = L.beam_search_decode(ids_arr, scores_arr, beam,
                                           end_id=cfg["end"])
    return main, startup, ids, scores


def _lengths(rng, cfg, n):
    lo, hi = cfg["lengths"]
    return rng.randint(lo, hi + 1, size=n)


def _words(rng, cfg, dict_size, length):
    return rng.randint(3, dict_size, size=length).astype("int64")


def train_batch(fluid, rng, cfg=RNN_SEARCH, n=None, trg_lengths=None):
    """A seeded batch: ``src`` sentences, ``trg`` (<s> then the words)
    and ``label`` (the words then <e>), source and target lengths drawn
    independently (or the target lengths given)."""
    fluid = _pkg(fluid)
    n = n or cfg["batch"]
    src_len = _lengths(rng, cfg, n)
    trg_len = (np.asarray(trg_lengths) if trg_lengths is not None
               else _lengths(rng, cfg, n))
    src = np.concatenate([_words(rng, cfg, cfg["src_dict"], k)
                          for k in src_len])
    trg, label = [], []
    for k in trg_len:
        w = _words(rng, cfg, cfg["trg_dict"], k - 1)
        trg.append(np.concatenate([[cfg["start"]], w]))
        label.append(np.concatenate([w, [cfg["end"]]]))

    def lod(ids, lens):
        return fluid.create_lod_tensor(
            np.asarray(ids, "int64").reshape(-1, 1), [list(map(int, lens))])

    return {"src": lod(src, src_len), "trg": lod(np.concatenate(trg),
                                                  trg_len),
            "label": lod(np.concatenate(label), trg_len)}


def source_batch(fluid, rng, cfg=RNN_SEARCH, n=None):
    """The generator's feeds: seeded ``src`` sentences, and one <s> with
    score 0 a source as the first step's ids and scores (2-level LoD)."""
    fluid = _pkg(fluid)
    n = n or cfg["batch"]
    src_len = _lengths(rng, cfg, n)
    src = np.concatenate([_words(rng, cfg, cfg["src_dict"], k)
                          for k in src_len]).reshape(-1, 1)
    ones = [[1] * n, [1] * n]
    return {"src": fluid.create_lod_tensor(src, [list(map(int, src_len))]),
            "init_ids": fluid.create_lod_tensor(
                np.full((n, 1), cfg["start"], "int64"), ones),
            "init_scores": fluid.create_lod_tensor(
                np.zeros((n, 1), "float32"), ones)}


def n_params(program) -> int:
    return int(sum(np.prod(p.shape) for p in program.all_parameters()))
