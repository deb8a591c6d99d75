"""``flash_attention`` (:960), ``gru_unit`` (:489), ``lstm_unit`` (:520),
``Print`` (:760), ``gather_tree`` (:782), ``lod_reset`` (:606),
``sequence_slice`` (:689), ``sequence_unpad`` (:703), ``im2sequence``
(:714), ``cos_sim`` (:186), ``linear_chain_crf`` (:623), ``crf_decoding``
(:654), ``chunk_eval`` (:1012), ``size`` (:322), ``is_empty`` (:333),
``while_loop`` (:436), ``sequence_reverse`` (:581),
``get_tensor_from_selected_rows`` (:592), ``merge_selected_rows``
(:596), ``bilinear_tensor_product`` (:166), ``row_conv`` (:233), ``sum``
(:345), ``spectral_norm`` (:805) and ``switch_moe`` (:978) of
``paddle_tpu/layers/extras.py``: the same ops, slots, attrs and
parameter names. ``is_empty`` counts the elements through ``shape`` and
``reduce_prod``, as the JAX layer does, not through the ``is_empty`` op;
``while_loop`` is a ``While`` whose body assigns the new loop vars over
the old and recomputes the condition. ``flash_attention`` is fused
attention over ``[B, H, S, D]``, the hand-written CUDA kernels on the
card; ``lengths`` ([B] int) masks padded keys inside the kernel."""
from __future__ import annotations

from .. import framework
from ..layer_helper import LayerHelper

__all__ = ["flash_attention", "gru_unit", "lstm_unit", "Print",
           "gather_tree", "lod_reset", "sequence_slice", "sequence_unpad",
           "im2sequence", "cos_sim", "linear_chain_crf", "crf_decoding",
           "chunk_eval", "size", "is_empty", "while_loop",
           "sequence_reverse", "get_tensor_from_selected_rows",
           "merge_selected_rows", "sum", "row_conv", "spectral_norm",
           "bilinear_tensor_product", "switch_moe"]


def flash_attention(q, k, v, causal=False, scale=0.0, lengths=None):
    helper = LayerHelper("flash_attention", input=q)
    out = helper.create_variable_for_type_inference(q.dtype)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if lengths is not None:
        ins["Lengths"] = [lengths]
    helper.append_op("flash_attention", inputs=ins, outputs={"Out": [out]},
                     attrs={"causal": bool(causal), "scale": float(scale)})
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step over the projected ``input`` [B, size]; returns
    (hidden, reset hidden prev, gate)."""
    helper = LayerHelper("gru_unit", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = helper.input_dtype()
    d = size // 3
    w = helper.create_parameter(attr=helper.param_attr, shape=[d, 3 * d],
                                dtype=dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, 3 * d], dtype=dtype,
            is_bias=True)]
    gate = helper.create_variable_for_type_inference(dtype)
    rhp = helper.create_variable_for_type_inference(dtype)
    hid = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gru_unit", inputs=inputs,
                     outputs={"Gate": [gate], "ResetHiddenPrev": [rhp],
                              "Hidden": [hid]},
                     attrs={"origin_mode": origin_mode}, infer_shape=False)
    b = int(hidden.shape[0])
    hid.shape = (b, d)
    rhp.shape = (b, d)
    gate.shape = (b, 3 * d)
    return hid, rhp, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an ``fc`` over [x, h_prev] to the four gates, then
    the ``lstm_unit`` op; returns (h, c)."""
    from .nn import fc
    from .tensor import concat

    helper = LayerHelper("lstm_unit", input=x_t)
    d = int(cell_t_prev.shape[-1])
    gates = fc(concat([x_t, hidden_t_prev], axis=1), size=4 * d,
               param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias}, infer_shape=False)
    c.shape = tuple(cell_t_prev.shape)
    h.shape = tuple(cell_t_prev.shape)
    return h, c


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    helper = LayerHelper("print", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "print", inputs={"In": [input]}, outputs={"Out": [out]},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_tensor_lod": print_tensor_lod,
               "print_phase": print_phase.upper()},
        infer_shape=False)
    out.shape = tuple(input.shape or ())
    return out


def gather_tree(ids, parents):
    helper = LayerHelper("gather_tree", input=ids)
    out = helper.create_variable_for_type_inference(ids.dtype)
    helper.append_op("gather_tree",
                     inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]}, infer_shape=False)
    out.shape = tuple(ids.shape)
    return out


def lod_reset(x, y=None, target_lod=None):
    """x's rows with a new LoD: Y's (its LoD, else its values) or
    ``target_lod``."""
    helper = LayerHelper("lod_reset", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    else:
        attrs["target_lod"] = [int(v) for v in (target_lod or [])]
    helper.append_op("lod_reset", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs, infer_shape=False)
    out.shape = tuple(x.shape)
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = 1
    out.shape = (-1,) + tuple(input.shape[1:])
    helper.append_op("sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    out.shape = (-1,) + tuple(x.shape[2:])
    helper.append_op("sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    if input_image_size is not None:
        raise NotImplementedError(
            "im2sequence with per-sample input_image_size is not "
            "supported (nor in the JAX package)")

    def pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    helper = LayerHelper("im2sequence", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    pads = pair(padding)
    helper.append_op(
        "im2sequence", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"kernels": pair(filter_size), "strides": pair(stride),
               "paddings": pads * 2 if len(pads) == 2 else pads,
               "out_stride": pair(out_stride)},
        infer_shape=False)
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim", input=X)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]},
                     infer_shape=False)
    if X.shape is not None:
        out.shape = (int(X.shape[0]), 1)
    return out


def linear_chain_crf(input, label, param_attr=None, length=None):
    """The CRF's negative log-likelihood over dense ``[B, T, K]`` input;
    creates the ``[K+2, K]`` transition parameter. ``length`` is not
    taken, as in the JAX package: pad the labels with the repeated last
    label (the padded tail's NLL is then constant in the emissions)."""
    if length is not None:
        raise NotImplementedError(
            "linear_chain_crf(length=...) is not supported; pad labels "
            "with the repeated final label instead")
    helper = LayerHelper("linear_chain_crf", input=input,
                         param_attr=param_attr)
    dtype = helper.input_dtype()
    k = int(input.shape[-1])
    trans = helper.create_parameter(attr=helper.param_attr,
                                    shape=[k + 2, k], dtype=dtype)
    alpha, em_exps, tr_exps, ll = (
        helper.create_variable_for_type_inference(dtype) for _ in range(4))
    helper.append_op(
        "linear_chain_crf",
        inputs={"Emission": [input], "Transition": [trans],
                "Label": [label]},
        outputs={"Alpha": [alpha], "EmissionExps": [em_exps],
                 "TransitionExps": [tr_exps], "LogLikelihood": [ll]},
        infer_shape=False)
    ll.shape = (int(input.shape[0]) if len(input.shape) == 3 else 1, 1)
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the transition ``linear_chain_crf`` learned:
    the parameter ``param_attr`` names, else the newest ``[K+2, K]``
    parameter of the program (name it where there are several CRFs)."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("crf_decoding", input=input)
    name = param_attr.name if isinstance(param_attr, ParamAttr) else None
    blk = helper.main_program.global_block()
    trans = blk._find_var_recursive(name) if name else None
    if trans is None:
        k = int(input.shape[-1])
        matches = [p for p in blk.all_parameters
                   if p.shape and len(p.shape) == 2
                   and p.shape[0] == k + 2 and p.shape[1] == k]
        trans = matches[-1] if matches else None
    if trans is None:
        raise ValueError("crf_decoding: no transition parameter found; "
                         "run linear_chain_crf first or name the param")
    out = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [trans]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out]}, infer_shape=False)
    out.shape = tuple(input.shape[:-1])
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk precision, recall and F1 and the three chunk counts
    (reference layers/nn.py:866, the NER evaluation layer)."""
    helper = LayerHelper("chunk_eval", input=input)

    def mk(dtype):
        v = helper.create_variable_for_type_inference(dtype,
                                                      stop_gradient=True)
        v.shape = (1,)
        return v

    precision, recall, f1 = mk("float32"), mk("float32"), mk("float32")
    n_infer, n_label, n_correct = mk("int64"), mk("int64"), mk("int64")
    inputs = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        inputs["SeqLength"] = [seq_length]
    helper.append_op(
        "chunk_eval", inputs=inputs,
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1], "NumInferChunks": [n_infer],
                 "NumLabelChunks": [n_label],
                 "NumCorrectChunks": [n_correct]},
        attrs={"num_chunk_types": int(num_chunk_types),
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": list(excluded_chunk_types or [])},
        infer_shape=False)
    return precision, recall, f1, n_infer, n_label, n_correct


def size(input):
    """The element count at run time, int64, from the ``shape`` op (a -1
    dim is known only then)."""
    from .nn import reduce_prod, shape
    from .tensor import cast

    return cast(reduce_prod(cast(shape(input), "int64")), "int64")


def is_empty(x, cond=None):
    from .control_flow import equal
    from .tensor import assign, cast, fill_constant

    zero = fill_constant([1], "int64", 0)
    out = equal(cast(size(x), "int64"), zero)
    if cond is not None:
        assign(out, output=cond)
        return cond
    return out


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    from .control_flow import While
    from .tensor import assign

    c = cond(*loop_vars)
    w = While(c)  # the JAX layer's: is_test is not passed on
    with w.block():
        new_vars = body(*loop_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        for old, new in zip(loop_vars, new_vars):
            assign(new, output=old)
        assign(cond(*loop_vars), output=c)
    return list(loop_vars)


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = getattr(x, "lod_level", 0)
    helper.append_op("sequence_reverse", inputs={"X": [x]},
                     outputs={"Y": [out]}, infer_shape=False)
    out.shape = tuple(x.shape) if x.shape else None
    return out


def get_tensor_from_selected_rows(x, name=None):
    helper = LayerHelper("get_tensor_from_selected_rows", input=x,
                         name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("get_tensor_from_selected_rows", inputs={"X": [x]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def merge_selected_rows(x, name=None):
    helper = LayerHelper("merge_selected_rows", input=x)
    out = helper.main_program.current_block().create_var(
        name=framework.unique_name.generate("merged_sr"),
        type="selected_rows", dtype=x.dtype)
    helper.append_op("merge_selected_rows", inputs={"X": [x]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", input=x,
                         param_attr=param_attr, bias_attr=bias_attr)
    dtype = helper.input_dtype()
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[size, int(x.shape[1]), int(y.shape[1])], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=dtype,
            is_bias=True)]
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", input=input, param_attr=param_attr)
    dtype = helper.input_dtype()
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[future_context_size + 1, int(input.shape[-1])], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def sum(x):
    """Elementwise sum of a list of tensors (the ``sum`` op; not
    ``reduce_sum``)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum", input=xs[0])
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", inputs={"X": list(xs)}, outputs={"Out": [out]},
                     infer_shape=False)
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` over its largest singular value by power iteration; U
    and V are persistable, drawn from Normal(0, 1) in the startup."""
    from ..initializer import NormalInitializer

    helper = LayerHelper("spectral_norm", input=weight)
    h = int(weight.shape[dim])
    w = 1
    for i, s in enumerate(weight.shape):
        if i != dim:
            w *= int(s)
    uv = []
    for key, n in (("spectral_norm_u", h), ("spectral_norm_v", w)):
        var = helper.main_program.global_block().create_var(
            name=framework.unique_name.generate(key), shape=(n,),
            dtype="float32", persistable=True)
        var.stop_gradient = True
        helper.set_variable_initializer(var, NormalInitializer(0.0, 1.0))
        uv.append(var)
    u, v = uv
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op("spectral_norm",
                     inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out], "UOut": [u], "VOut": [v]},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps},
                     infer_shape=False)
    out.shape = tuple(weight.shape)
    return out


def switch_moe(input, num_experts, hidden_dim, capacity_factor=1.0,
               num_groups=1, param_attr=None, name=None):
    """Switch-routed mixture-of-experts FFN over ``[T, D]`` tokens: top-1
    gating, a fixed capacity per expert, overflow tokens dropped. The
    ``moe`` op; ``apply_expert_parallel`` shards its experts over an
    ``ep`` axis (``parallel/moe.py``)."""
    helper = LayerHelper("moe", input=input, param_attr=param_attr,
                         name=name)
    dtype = helper.input_dtype()
    d = int(input.shape[-1])
    gate_w = helper.create_parameter(
        attr=helper.param_attr, shape=[d, num_experts], dtype=dtype)
    w_in = helper.create_parameter(
        attr=helper.param_attr, shape=[num_experts, d, hidden_dim],
        dtype=dtype)
    w_out = helper.create_parameter(
        attr=helper.param_attr, shape=[num_experts, hidden_dim, d],
        dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "moe",
        inputs={"X": [input], "GateW": [gate_w], "WIn": [w_in],
                "WOut": [w_out]},
        outputs={"Out": [out]},
        attrs={"shard_axis": "", "num_groups": int(num_groups),
               "capacity_factor": float(capacity_factor)})
    return out
