"""The dense recurrent layers of ``paddle_tpu/layers/rnn.py``: ``lstm``
(:85, over the ``cudnn_lstm`` op), ``StaticRNN`` (:124), the cells
``RNNCell``, ``LSTMCell`` and ``GRUCell`` (:302-390), ``rnn`` (:392),
``Decoder``, ``BeamSearchDecoder`` (:454-654) and ``dynamic_decode``
(:656): the same ops, slots, attrs, var and parameter names from the same
script.

Every loop is unrolled when the program is built, as the JAX package
unrolls it: ``StaticRNN`` copies its step block once a step into the
parent with the names renamed ``<name>@t<step>``, ``rnn`` slices the time
axis and calls the cell once a step (padded steps of a ``sequence_length``
keep the old state), and ``dynamic_decode`` calls the decoder's ``step``
``max_step_num`` times (finished beams go on emitting the end token). The
programs have static shapes and no control-flow op, so they take the
whole-program route: one CUDA graph a step on the card. A cell names its
parameters once an instance, so every step shares them by name.
``BeamSearchDecoder`` keeps everything dense, ``[batch, beam]`` and
``[batch * beam, ...]``; its selection is ``topk`` over beam x vocab and
its backtrace the ``gather_tree`` op.

The LoD layers ``dynamic_lstm`` (:21) and ``dynamic_gru`` (:57) take the
pre-projected rows ([T, size] for the LSTM, whose hidden width is size /
4; [T, 3 * size] for the GRU) and emit one ``lstm`` / ``gru`` op each
(``ops/rnn_ops.py``); their outputs keep the input's LoD. ``beam_search``
(:701) and ``beam_search_decode`` (:733) emit the LoD beam-search host
ops (``ops/beam_search_ops.py``) that a ``While`` loop of the Fluid
seq2seq API calls once a step and once after it.
"""
from __future__ import annotations

from collections import namedtuple as _namedtuple

from ..layer_helper import LayerHelper

__all__ = ["lstm", "StaticRNN", "RNNCell", "LSTMCell", "GRUCell", "rnn",
           "Decoder", "BeamSearchDecoder", "dynamic_decode", "dynamic_lstm",
           "dynamic_gru", "beam_search", "beam_search_decode"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """The LoD LSTM over pre-projected [T, size] rows: (hidden, cell),
    each [T, size / 4] with the input's LoD."""
    helper = LayerHelper("lstm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[d, 4 * d], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr,
        shape=[1, 7 * d] if use_peepholes else [1, 4 * d], dtype=dtype,
        is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        "lstm", inputs=inputs, outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation},
        infer_shape=False)
    for v in (hidden, cell):
        v.shape = tuple(input.shape[:-1]) + (d,)
        v.lod_level = input.lod_level
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                name=None):
    """The LoD GRU over pre-projected [T, 3 * size] rows: hidden [T,
    size] with the input's LoD."""
    helper = LayerHelper("gru", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = helper.input_dtype()
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        "gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"activation": candidate_activation,
               "gate_activation": gate_activation,
               "is_reverse": is_reverse, "origin_mode": origin_mode},
        infer_shape=False)
    hidden.shape = tuple(input.shape[:-1]) + (size,)
    hidden.lod_level = input.lod_level
    return hidden


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Dense multi-layer (bi)LSTM over [T, N, D], one ``cudnn_lstm`` op
    over a flat weight. Returns (out, last_h, last_c)."""
    helper = LayerHelper("cudnn_lstm", input=input, name=name)
    dtype = helper.input_dtype()
    ndir = 2 if is_bidirec else 1
    in_size = input.shape[-1]
    n_weight = 0
    din = in_size
    for layer in range(num_layers):
        for _ in range(ndir):
            n_weight += din * 4 * hidden_size + hidden_size * 4 * hidden_size
            n_weight += 4 * hidden_size
        din = hidden_size * ndir
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[n_weight], dtype=dtype,
        default_initializer=default_initializer)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "cudnn_lstm",
        inputs={"Input": [input], "InitH": [init_h], "InitC": [init_c],
                "W": [weight]},
        outputs={"Out": [out], "LastH": [last_h], "LastC": [last_c]},
        attrs={"max_len": max_len, "hidden_size": hidden_size,
               "num_layers": num_layers, "is_bidirec": is_bidirec,
               "dropout_prob": dropout_prob, "is_test": is_test,
               "input_size": in_size, "seed": seed},
        infer_shape=False)
    t, n = input.shape[0], input.shape[1]
    out.shape = (t, n, hidden_size * ndir)
    last_h.shape = (num_layers * ndir, n, hidden_size)
    last_c.shape = (num_layers * ndir, n, hidden_size)
    return out, last_h, last_c


class StaticRNN:
    """Fixed-length RNN builder. The step body is built in a sub-block
    once; on exit it is unrolled: copied once a step into the parent
    block, step inputs becoming time slices, memories threading from step
    to step and step outputs stacked along time, every copy an ordinary op
    with its outputs renamed ``<name>@t<step>``.

    Usage::

        rnn = StaticRNN()
        with rnn.step():
            w = rnn.step_input(x_tbd)          # x [T, B, D] -> w [B, D]
            prev = rnn.memory(shape=[-1, H], batch_ref=w)
            h = layers.fc([w, prev], size=H)
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()                             # [T, B, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._step_inputs = []   # (sub_var, source_var)
        self._mems = []          # (sub_var, init_var); _next set later
        self._mem_next = {}      # sub_var.name -> sub-block var
        self._step_outputs = []  # sub-block vars
        self._seq_len = None
        self._sub = None
        self._result = None

    def step(self):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            main = self.helper.main_program
            self._parent_block = main.current_block()
            self._sub = main._create_block()
            try:
                yield
            finally:
                main._rollback()
                self._unroll()

        return _ctx()

    def _require_step(self):
        if self._sub is None:
            raise RuntimeError("call inside `with rnn.step():`")

    def step_input(self, x):
        self._require_step()
        if self._seq_len is None:
            self._seq_len = int(x.shape[0])
        elif int(x.shape[0]) != self._seq_len:
            raise ValueError("step inputs disagree on seq_len")
        v = self._sub.create_var(
            name=self.helper.unique_var_name("step_in"),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._step_inputs.append((v, x))
        return v

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1,
               value=None, dtype="float32"):
        """``init_value`` (or its alias ``value``) fills a memory of
        ``shape`` batched as ``batch_ref``'s dim 0; the batch-dim indices
        are accepted and not read."""
        self._require_step()
        if value is not None:
            init_value = value
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            from .tensor import fill_constant

            dims = [int(batch_ref.shape[0])] + [int(s) for s in shape
                                                if int(s) != -1]
            # init belongs to the parent block, before the unroll
            cur = self.helper.main_program.current_block()
            self.helper.main_program._current_block_idx = \
                self._parent_block.idx
            try:
                init = fill_constant(shape=dims, dtype=dtype,
                                     value=init_value)
            finally:
                self.helper.main_program._current_block_idx = cur.idx
        v = self._sub.create_var(
            name=self.helper.unique_var_name("mem"),
            shape=tuple(init.shape), dtype=init.dtype)
        self._mems.append((v, init))
        return v

    def update_memory(self, mem, new_val):
        self._require_step()
        self._mem_next[mem.name] = new_val

    def step_output(self, o):
        self._require_step()
        self._step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _unroll(self):
        if self._seq_len is None:
            raise ValueError("StaticRNN needs at least one step_input")
        parent = self._parent_block
        state = {}  # sub mem name -> parent var name (current value)
        for mem, init in self._mems:
            state[mem.name] = init.name
        per_step_outs = {o.name: [] for o in self._step_outputs}

        for t in range(self._seq_len):
            mapping = dict(state)
            for v, src in self._step_inputs:
                mapping[v.name] = self._slice_t(parent, src, t).name
            for op in self._sub.ops:
                new_ins = {
                    slot: [mapping.get(n, n) for n in names]
                    for slot, names in op.inputs.items()}
                new_outs = {}
                for slot, names in op.outputs.items():
                    outs = []
                    for n in names:
                        sv = self._sub.vars.get(n)
                        nn = "%s@t%d" % (n, t)
                        if sv is not None and nn not in parent.vars:
                            parent.create_var(name=nn, shape=sv.shape,
                                              dtype=sv.dtype)
                        mapping[n] = nn
                        outs.append(nn)
                    new_outs[slot] = outs
                parent.append_op(op.type, inputs=new_ins, outputs=new_outs,
                                 attrs=dict(op.attrs), infer_shape=False)
            for mem, _init in self._mems:
                nxt = self._mem_next.get(mem.name)
                if nxt is not None:
                    state[mem.name] = mapping[nxt.name]
            for o in self._step_outputs:
                per_step_outs[o.name].append(parent.vars[mapping[o.name]])

        results = []
        cur = self.helper.main_program._current_block_idx
        self.helper.main_program._current_block_idx = parent.idx
        try:
            from .nn import stack

            for o in self._step_outputs:
                results.append(stack(per_step_outs[o.name], axis=0))
        finally:
            self.helper.main_program._current_block_idx = cur
        self._result = results

    def _slice_t(self, parent, src, t):
        from .nn import slice as nn_slice

        cur = self.helper.main_program._current_block_idx
        self.helper.main_program._current_block_idx = parent.idx
        try:
            s = nn_slice(src, axes=[0], starts=[t], ends=[t + 1])
            from .nn import squeeze

            return squeeze(s, axes=[0])
        finally:
            self.helper.main_program._current_block_idx = cur

    def __call__(self):
        if self._result is None:
            raise RuntimeError("StaticRNN not built — use `with rnn.step()`")
        return self._result[0] if len(self._result) == 1 else self._result


class RNNCell:
    """Base cell: call(inputs, states) -> (outputs, new_states)."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0):
        from .tensor import fill_constant

        b = int(batch_ref.shape[0])
        shapes = shape if isinstance(shape, (list, tuple)) and shape and \
            isinstance(shape[0], (list, tuple)) else [shape]
        outs = [fill_constant([b] + [int(s) for s in sh], dtype,
                              init_value) for sh in shapes]
        return outs if len(outs) > 1 else outs[0]


class LSTMCell(RNNCell):
    """One LSTM step, fc + the lstm_unit op; state = [hidden, cell]. The
    parameters are named once an instance, so every step of an unroll
    shares them (LayerHelper reuses a parameter by name)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 name="LSTMCell"):
        from .. import framework
        from ..param_attr import ParamAttr

        self.hidden_size = hidden_size
        base = framework.unique_name.generate(name)
        self._param_attr = param_attr if param_attr is not None else             ParamAttr(name=base + "_w")
        self._bias_attr = bias_attr if bias_attr is not None else             ParamAttr(name=base + "_b")

    def call(self, inputs, states):
        from .extras import lstm_unit

        h_prev, c_prev = states
        h, c = lstm_unit(inputs, h_prev, c_prev,
                         param_attr=self._param_attr,
                         bias_attr=self._bias_attr)
        return h, [h, c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


class GRUCell(RNNCell):
    """An fc projection + the gru_unit op; state = hidden. The projection
    and recurrent weights get distinct names an instance (shared across
    steps, never across the two ops, whose shapes differ)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 name="GRUCell"):
        from .. import framework
        from ..param_attr import ParamAttr

        self.hidden_size = hidden_size
        base = framework.unique_name.generate(name)
        # a user-supplied NAMED param_attr cannot serve both ops (their
        # shapes differ); derive distinct names from it
        user_name = getattr(param_attr, "name", None) if param_attr else             None
        prefix = user_name or base
        self._proj_attr = ParamAttr(name=prefix + "_proj_w")
        self._rec_attr = ParamAttr(name=prefix + "_rec_w")
        self._bias_attr = bias_attr if bias_attr is not None else             ParamAttr(name=prefix + "_b")

    def call(self, inputs, states):
        from .extras import gru_unit
        from .nn import fc

        h_prev = states[0] if isinstance(states, (list, tuple)) else states
        x = fc(inputs, size=3 * self.hidden_size,
               param_attr=self._proj_attr, bias_attr=False)
        h, _, _ = gru_unit(x, h_prev, 3 * self.hidden_size,
                           param_attr=self._rec_attr,
                           bias_attr=self._bias_attr)
        return h, [h]

    @property
    def state_shape(self):
        return [[self.hidden_size]]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run ``cell`` over the time axis of dense inputs, unrolled one slice
    a step. Returns (outputs, final_states)."""
    from .nn import slice as nn_slice
    from .nn import squeeze, stack
    from .tensor import cast, fill_constant

    time_axis = 0 if time_major else 1
    batch_axis = 1 if time_major else 0
    T = int(inputs.shape[time_axis])
    B = int(inputs.shape[batch_axis])
    states = initial_states
    if states is None:
        shapes = cell.state_shape
        states = [fill_constant([B] + [int(d) for d in sh], "float32",
                                0.0) for sh in shapes]
    if not isinstance(states, (list, tuple)):
        states = [states]
    states = list(states)
    len_mask = None
    if sequence_length is not None:
        # [T, B] step-validity mask; padded steps carry the old state
        from .sequence_lod import sequence_mask

        m = sequence_mask(sequence_length, maxlen=T)  # [B, T]
        len_mask = cast(m, inputs.dtype)
    outs = []
    steps = range(T - 1, -1, -1) if is_reverse else range(T)
    for i in steps:
        x_t = squeeze(nn_slice(inputs, axes=[time_axis], starts=[i],
                               ends=[i + 1]), axes=[time_axis])
        o, new_states = cell.call(x_t, list(states))
        if len_mask is not None:
            from .nn import elementwise_add, elementwise_mul
            from .ops import scale as _scale_op

            m_t = nn_slice(len_mask, axes=[1], starts=[i], ends=[i + 1])
            inv_m = _scale_op(m_t, scale=-1.0, bias=1.0)
            new_states = [
                elementwise_add(elementwise_mul(n, m_t),
                                elementwise_mul(s, inv_m))
                for n, s in zip(new_states, states)]
            o = elementwise_mul(o, m_t)
        states = new_states
        outs.append(o)
    if is_reverse:
        outs = outs[::-1]
    outputs = stack(outs, axis=time_axis)
    return outputs, states


class Decoder:
    """The step-decoder contract:
    ``initialize`` -> (initial_inputs, initial_states, initial_finished);
    ``step`` -> (outputs, next_states, next_inputs, finished);
    ``finalize`` -> (final_outputs, final_states)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """Beam-search decoding over a wrapped cell, dense and of static
    shapes: ``[batch, beam]`` and ``[batch * beam, ...]``, no LoD. The
    backtrace is the gather_tree op.

    States and inputs handed to ``cell.call`` are shaped
    [batch*beam, ...]; use ``tile_beam_merge_with_batch`` for any extra
    tensor the cell closes over (e.g. attention memory)."""

    OutputWrapper = _namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = _namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        # the step constants, built once a decode (on the first step,
        # which knows V) and shared by the unrolled steps
        self._consts = None

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch*beam, ...] with each row repeated
        beam_size times."""
        from .nn import expand, reshape, unsqueeze

        x = unsqueeze(x, [1])
        times = [1] * len(x.shape)
        times[1] = beam_size
        x = expand(x, times)
        shp = [int(s) for s in x.shape]
        lead = -1 if shp[0] < 0 else shp[0] * shp[1]
        return reshape(x, [lead] + shp[2:])

    def _merge(self, x):
        from .nn import reshape

        shp = [int(s) for s in x.shape]
        return reshape(x, [shp[0] * shp[1]] + shp[2:])

    def initialize(self, initial_cell_states):
        """Start tokens everywhere; beam 0 carries log-prob 0, the rest
        -1e9 so step 1 expands only beam 0."""
        import numpy as np

        from .tensor import assign, fill_constant

        states = initial_cell_states
        if not isinstance(states, (list, tuple)):
            states = [states]
        B = int(states[0].shape[0])
        if B < 0:
            raise ValueError(
                "BeamSearchDecoder needs a static batch size; declare the "
                "initial state with fluid.data(..., shape=[batch, ...]) "
                "instead of a -1 batch dim (the unrolled decode has "
                "static shapes)")
        K = self.beam_size
        cell_states = [self.tile_beam_merge_with_batch(s, K)
                       for s in states]
        init_lp = assign(np.array(
            [[0.0] + [-1e9] * (K - 1)] * B, dtype="float32"))
        finished = fill_constant([B, K], "bool", False)
        lengths = fill_constant([B, K], "int64", 0)
        start = fill_constant([B, K], "int64", self.start_token)
        self._consts = None  # rebuilt lazily on the first step (needs V)
        init_inputs = start
        if self.embedding_fn is not None:
            # [B, K, E] -> [B*K, E]: the wrapped cell always sees the
            # beam dim merged into batch
            init_inputs = self._merge(self.embedding_fn(start))
        return init_inputs, self.StateWrapper(
            cell_states, init_lp, finished, lengths), finished

    def _step_consts(self, B, K, V):
        """The step-invariant constants, built once a decode: the
        unrolled loop would otherwise make a [V] literal and eight
        fill_constants every step."""
        if self._consts is not None:
            return self._consts
        import numpy as np

        from .nn import expand, reshape
        from .tensor import assign, cast, fill_constant, range as t_range

        noend = np.full((V,), -1e9, dtype="float32")
        noend[self.end_token] = 0.0
        self._consts = {
            "noend_bkv": expand(reshape(assign(noend), [1, 1, V]),
                                [B, K, 1]),
            "vconst": fill_constant([B, K], "int64", V),
            "kconst": fill_constant([B, K], "int64", K),
            "endconst": fill_constant([B, K], "int64", self.end_token),
            "one_i": fill_constant([B, K], "int64", 1),
            "neg_one_i": fill_constant([B, K], "int64", -1),
            "offs": expand(reshape(cast(t_range(0, B, 1, "int32"),
                                        "int64"), [B, 1]), [1, K]),
            "eps": fill_constant([1], "float32", 1e-20),
            "one_f": fill_constant([1], "float32", 1.0),
            "neg_one_f": fill_constant([1], "float32", -1.0),
        }
        return self._consts

    def _beam_search_step(self, logits, beam_state):
        """One topk-over-(beam x vocab) selection."""
        from .nn import (elementwise_add, elementwise_floordiv,
                         elementwise_mod, elementwise_mul, expand, gather,
                         reshape, softmax, topk, unsqueeze)
        from .ops import log
        from .tensor import cast
        from .control_flow import equal, logical_or

        K, B = self.beam_size, int(beam_state.log_probs.shape[0])
        V = int(logits.shape[-1])
        c = self._step_consts(B, K, V)
        probs = softmax(reshape(logits, [B, K, V]))
        step_lp = log(elementwise_add(probs, c["eps"]))
        # finished beams may only extend with end_token at no cost
        fin_f = expand(unsqueeze(cast(beam_state.finished, "float32"), [2]),
                       [1, 1, V])
        keep_f = elementwise_add(
            elementwise_mul(fin_f, c["noend_bkv"]),
            elementwise_mul(
                step_lp,
                elementwise_add(elementwise_mul(fin_f, c["neg_one_f"]),
                                c["one_f"])))
        total = elementwise_add(
            keep_f, expand(unsqueeze(beam_state.log_probs, [2]), [1, 1, V]))
        scores, idx = topk(reshape(total, [B, K * V]), K)  # [B, K]
        beam_idx = elementwise_floordiv(idx, c["vconst"])
        token_idx = elementwise_mod(idx, c["vconst"])
        # flat parent rows into [B*K, ...] cell states
        flat_parent = reshape(
            elementwise_add(elementwise_mul(c["offs"], c["kconst"]),
                            beam_idx),
            [B * K])
        next_cell = [gather(s, flat_parent) for s in beam_state.cell_states]
        parent_finished = reshape(
            gather(reshape(beam_state.finished, [B * K]), flat_parent),
            [B, K])
        parent_lengths = reshape(
            gather(reshape(beam_state.lengths, [B * K]), flat_parent),
            [B, K])
        next_finished = logical_or(parent_finished,
                                   equal(token_idx, c["endconst"]))
        grow = elementwise_add(
            elementwise_mul(cast(parent_finished, "int64"),
                            c["neg_one_i"]),
            c["one_i"])  # 1 - finished
        next_lengths = elementwise_add(parent_lengths, grow)
        next_state = self.StateWrapper(next_cell, scores, next_finished,
                                       next_lengths)
        output = self.OutputWrapper(scores, token_idx, beam_idx)
        return output, next_state

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell = self.cell.call(inputs, states.cell_states)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        probing = self.StateWrapper(next_cell, states.log_probs,
                                    states.finished, states.lengths)
        output, next_state = self._beam_search_step(cell_out, probing)
        next_inputs = output.predicted_ids
        if self.embedding_fn is not None:
            next_inputs = self._merge(self.embedding_fn(next_inputs))
        return output, next_state, next_inputs, next_state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrace beams through parent pointers (gather_tree)."""
        from .extras import gather_tree

        predicted = gather_tree(outputs.predicted_ids, outputs.parent_ids)
        return predicted, final_states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, **kwargs):
    """Drive ``decoder`` for ``max_step_num`` steps, unrolled when the
    program is built, with dense static shapes; finished beams keep
    emitting the end token, so the fixed trip count costs compute after
    every beam ended and changes no result."""
    from .nn import stack, transpose

    if max_step_num is None:
        raise ValueError("dynamic_decode requires max_step_num (the "
                         "unrolled trip count)")
    inputs, states, finished = decoder.initialize(inits)
    step_outputs = []
    for t in range(int(max_step_num)):
        output, states, inputs, finished = decoder.step(t, inputs, states,
                                                        **kwargs)
        step_outputs.append(output)
    stacked = type(step_outputs[0])(*[
        stack([getattr(o, f) for o in step_outputs], axis=0)
        for f in step_outputs[0]._fields])
    final_outputs, final_states = decoder.finalize(
        stacked, states, getattr(states, "lengths", None))
    if not output_time_major:
        from .. import framework as _fw

        def _batch_major(x):
            if isinstance(x, _fw.Variable):
                return transpose(x, [1, 0] + list(range(2, len(x.shape))))
            return x

        if isinstance(final_outputs, tuple) and hasattr(final_outputs,
                                                        "_fields"):
            final_outputs = type(final_outputs)(
                *[_batch_major(f) for f in final_outputs])
        else:
            final_outputs = _batch_major(final_outputs)
    return final_outputs, final_states


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One LoD beam-search step: the top ``beam_size`` candidates of each
    source sentence, from each prefix's candidates (``ids``, ``scores``)."""
    helper = LayerHelper("beam_search", input=pre_ids, name=name)
    selected_ids = helper.create_variable_for_type_inference("int64")
    selected_scores = helper.create_variable_for_type_inference("float32")
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    outputs = {"selected_ids": [selected_ids],
               "selected_scores": [selected_scores]}
    if return_parent_idx:
        parent_idx = helper.create_variable_for_type_inference("int32")
        outputs["parent_idx"] = [parent_idx]
    helper.append_op("beam_search", inputs=inputs, outputs=outputs,
                     attrs={"level": level, "beam_size": beam_size,
                            "end_id": end_id,
                            "is_accumulated": is_accumulated},
                     infer_shape=False)
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """The whole hypotheses, backtraced from the arrays of each step's
    ``beam_search`` outputs."""
    helper = LayerHelper("beam_search_decode", input=ids, name=name)
    sentence_ids = helper.create_variable_for_type_inference("int64")
    sentence_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op("beam_search_decode",
                     inputs={"Ids": [ids], "Scores": [scores]},
                     outputs={"SentenceIds": [sentence_ids],
                              "SentenceScores": [sentence_scores]},
                     attrs={"beam_size": beam_size, "end_id": end_id},
                     infer_shape=False)
    return sentence_ids, sentence_scores
