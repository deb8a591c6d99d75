"""The port's reference-format codec (``paddle_tpu_torch/core/proto_format``)
against the JAX package's, on the CPU.

- Twins of ``tests/test_proto_interop.py``: hand-computed wire bytes,
  ``protoc`` decoding what the codec encodes from a schema made from its
  field tables, the LoD tensor stream and the combined file, packed
  floats and bools, a multi-block program, the 2.x version refusal, and a
  save, load and predict round trip in both parameter layouts.
- The two codecs byte for byte: the same messages, tensor streams
  (bfloat16 included: the JAX package writes it through ``ml_dtypes``,
  the port as raw 16-bit words) and attribute typing (bool before int, a
  64-bit seed as ``LONG``, an empty list, a sub-block).
- Narrow BERT, the seq2seq beam decoder (sub-blocks none: ``rnn`` unrolls;
  a ``while`` program has one) and word2vec: each package encodes its
  program of the same script, and each decodes the other's bytes; the
  decoded programs must be equal op by op (type, slots, attrs, with float
  attributes at their float32 value) and var by var (shape, dtype,
  persistable).
"""
import shutil
import struct
import subprocess

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu.core import proto_format as jpf
from paddle_tpu_torch.core import proto_format as pf
from paddle_tpu_torch.core.tensor import from_host_array, to_host_array
from paddle_tpu_torch.models import book

import test_proto_interop as JT  # noqa: E402
import test_torch_transformer_training as TT  # noqa: E402
from test_torch_control_flow import _while_program  # noqa: E402
from test_torch_rnn import S2S, seq2seq_decode  # noqa: E402


# -- twins of test_proto_interop.py -------------------------------------------

def test_wire_primitives_hand_computed():
    assert pf.encode_message({"version": 1}, pf.VERSION) == b"\x08\x01"
    assert pf.decode_message(b"\x08\x01", pf.VERSION) == {"version": 1}
    enc = pf.encode_message({"data_type": 5, "dims": [2, -1]},
                            pf.TENSOR_DESC)
    assert enc.startswith(b"\x08\x05\x10\x02\x10")
    assert pf.decode_message(enc, pf.TENSOR_DESC) == {"data_type": 5,
                                                      "dims": [2, -1]}
    packed = b"\x08\x05\x12\x02\x02\x03"
    assert pf.decode_message(packed, pf.TENSOR_DESC)["dims"] == [2, 3]


@pytest.mark.skipif(shutil.which("protoc") is None,
                    reason="protoc not available")
def test_codec_matches_protoc(tmp_path):
    proto_path = tmp_path / "check.proto"
    proto_path.write_text(JT._table_to_proto_src())
    textpb = (b'type: "mul"\n'
              b'inputs { parameter: "X" arguments: "a" arguments: "b" }\n'
              b'outputs { parameter: "Out" arguments: "o" }\n'
              b'attrs { name: "x_num_col_dims" type: 0 i: 1 }\n'
              b'attrs { name: "alpha" type: 1 f: 1.5 }\n')
    cmd = ["protoc", "--proto_path", str(tmp_path)]
    official = subprocess.run(cmd + ["--encode=pt_check.OpDesc",
                                     str(proto_path)], input=textpb,
                              capture_output=True, check=True).stdout
    ours = pf.encode_message(
        {"type": "mul",
         "inputs": [{"parameter": "X", "arguments": ["a", "b"]}],
         "outputs": [{"parameter": "Out", "arguments": ["o"]}],
         "attrs": [{"name": "x_num_col_dims", "type": 0, "i": 1},
                   {"name": "alpha", "type": 1, "f": 1.5}]}, pf.OP_DESC)
    assert pf.decode_message(official, pf.OP_DESC) == \
        pf.decode_message(ours, pf.OP_DESC)
    back = subprocess.run(cmd + ["--decode=pt_check.OpDesc",
                                 str(proto_path)], input=ours,
                          capture_output=True, check=True).stdout
    assert b'type: "mul"' in back and b"alpha" in back


def test_lod_tensor_stream_roundtrip(tmp_path):
    arr = np.arange(12, dtype="float32").reshape(3, 4)
    data = pf.serialize_lod_tensor(arr, lod=[[0, 2, 3]])
    assert struct.unpack_from("<I", data, 0)[0] == 0
    assert struct.unpack_from("<Q", data, 4)[0] == 1
    out, lod, pos = pf.parse_lod_tensor(data)
    assert pos == len(data) and lod == [[0, 2, 3]]
    np.testing.assert_array_equal(out, arr)
    b = np.arange(6, dtype="int64").reshape(2, 3)
    path = str(tmp_path / "combined")
    pf.save_combine([("a", arr), ("b", b)], path)
    loaded = pf.load_combine(path, ["a", "b"])
    np.testing.assert_array_equal(loaded["a"], arr)
    np.testing.assert_array_equal(loaded["b"], b)
    with pytest.raises(ValueError, match="trailing"):
        pf.load_combine(path, ["a"])


def test_packed_floats_and_bools_decode():
    payload = struct.pack("<2f", 1.5, -2.0)
    data = bytes([7 << 3 | 2, len(payload)]) + payload
    assert pf.decode_message(data, pf.OP_DESC_ATTR)["floats"] == [1.5, -2.0]
    data = bytes([11 << 3 | 2, 2, 1, 0])
    assert pf.decode_message(data, pf.OP_DESC_ATTR)["bools"] == [True,
                                                                 False]


def test_multi_block_program_roundtrip():
    desc = {
        "blocks": [
            {"idx": 0, "parent_idx": -1,
             "vars": [{"name": "x",
                       "type": {"type": 7, "lod_tensor": {"tensor": {
                           "data_type": 5, "dims": [2]}}},
                       "persistable": False}],
             "ops": [{"type": "conditional_block",
                      "inputs": [{"parameter": "Cond",
                                  "arguments": ["x"]}],
                      "outputs": [],
                      "attrs": [{"name": "sub_block", "type": 8,
                                 "block_idx": 1}]}]},
            {"idx": 1, "parent_idx": 0, "vars": [], "ops": []},
        ],
        "version": {"version": 1007000},
    }
    prog, _, _ = pf.proto_bytes_to_program(
        pf.encode_message(desc, pf.PROGRAM_DESC))
    assert len(prog.blocks) == 2
    assert prog.blocks[1].parent_block is prog.blocks[0]
    assert prog.global_block().ops[0].attrs["sub_block"] is prog.blocks[1]


def test_rejects_2x_format_version():
    raw = pf.encode_message({"blocks": [{"idx": 0, "parent_idx": -1}],
                             "version": {"version": 2000000}},
                            pf.PROGRAM_DESC)
    with pytest.raises(RuntimeError, match="2.x"):
        pf.proto_bytes_to_program(raw)


def _fc_model(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4, 6], dtype="float32")
        h = pkg.layers.fc(x, size=8, act="relu")
        pred = pkg.layers.fc(h, size=3, act="softmax")
    return main, startup, pred


@pytest.mark.parametrize("params", [None, "__params__"])
def test_save_load_reference_format_roundtrip(tmp_path, params):
    main, startup, pred = _fc_model(fluid)
    x = np.random.RandomState(0).rand(4, 6).astype("float32")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        (want,) = exe.run(main, feed={"x": x}, fetch_list=[pred])
        fluid.io.save_inference_model(str(tmp_path), ["x"], [pred], exe,
                                      main_program=main,
                                      model_filename="__model__",
                                      params_filename=params)
    assert (tmp_path / "__model__").read_bytes()[:1] != b"{"
    with fluid.scope_guard(fluid.Scope()):
        prog, feeds, fetches = fluid.io.load_inference_model(
            str(tmp_path), exe, params_filename=params)
        assert feeds == ["x"]
        (got,) = exe.run(prog, feed={"x": x}, fetch_list=fetches)
    np.testing.assert_array_equal(got, want)


# -- the two codecs byte for byte ---------------------------------------------

def test_tensor_streams_are_the_jax_package_bytes():
    rng = np.random.RandomState(1)
    for arr in (rng.randn(3, 5).astype("float32"),
                rng.randint(-9, 9, (4,)).astype("int64"),
                rng.randint(-9, 9, (2, 2)).astype("int32"),
                np.asarray(2.5, "float64"), rng.rand(3) > 0.5):
        data = pf.serialize_lod_tensor(arr, lod=[[0, 1, len(arr)]]
                                       if arr.ndim else None)
        assert data == jpf.serialize_lod_tensor(
            arr, lod=[[0, 1, len(arr)]] if arr.ndim else None)
        np.testing.assert_array_equal(pf.parse_lod_tensor(data)[0], arr)


def test_bfloat16_streams_cross_as_raw_bits():
    """The JAX package writes bfloat16 through ml_dtypes; the port reads
    the stream as ``|V2`` words, the tensor as ``torch.bfloat16`` with
    the same bits, and writes the same bytes back."""
    vals = np.asarray([1.0, -2.5, 3.140625, 1e-3], "float32")
    data = jpf.serialize_lod_tensor(vals.astype(ml_dtypes.bfloat16))
    arr, _, _ = pf.parse_lod_tensor(data)
    assert arr.dtype == np.dtype("V2")
    t = from_host_array(arr)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  vals.astype(ml_dtypes.bfloat16)
                                  .astype("float32"))
    assert pf.serialize_lod_tensor(to_host_array(t)) == data
    back, _, _ = jpf.parse_lod_tensor(pf.serialize_lod_tensor(
        to_host_array(t)))
    np.testing.assert_array_equal(back.astype("float32"), t.float().numpy())


ATTRS = {"flag": True, "n": 3, "seed": 2 ** 40, "neg": -7, "f": 0.1,
         "s": "x", "ints": [1, -2], "bools": [True, False], "empty": [],
         "floats": [0.5, 1e-12], "strs": ["a", "b"],
         "longs": [1, 2 ** 35], "npint": np.int64(4)}


def test_attribute_typing_is_the_jax_package_s():
    for name, v in sorted(ATTRS.items()):
        if name == "npint":
            continue  # the JAX copy drops numpy scalars
        assert pf._py_to_attr(name, v) == jpf._py_to_attr(name, v), name
    assert pf._py_to_attr("seed", 2 ** 40)["type"] == pf.ATTR_LONG
    assert pf._py_to_attr("flag", True)["type"] == pf.ATTR_BOOLEAN
    assert pf._py_to_attr("npint", np.int64(4)) == {
        "name": "npint", "type": pf.ATTR_INT, "i": 4}


def _attr_program(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[2], dtype="float32")
    sub = main._create_block()
    main._rollback()
    attrs = {k: v for k, v in ATTRS.items() if k != "npint"}
    attrs["sub_block"] = sub
    attrs["_device"] = "dropped"
    blk.append_op("conditional_block", inputs={"Cond": ["x"]},
                  outputs={}, attrs=attrs, infer_shape=False)
    return main


def test_attributes_cross_both_ways():
    """bool before int, the 64-bit seed, an empty list, f32 floats, a
    sub-block; ``_``-prefixed attrs are not written."""
    pbytes = pf.program_to_proto_bytes(_attr_program(fluid), ["x"], [])
    jbytes = jpf.program_to_proto_bytes(_attr_program(jfluid), ["x"], [])
    assert pbytes == jbytes
    for prog in (pf.proto_bytes_to_program(jbytes)[0],
                 jpf.proto_bytes_to_program(pbytes)[0]):
        a = prog.global_block().ops[0].attrs
        assert a["sub_block"] is prog.blocks[1] and "_device" not in a
        assert a["flag"] is True and a["seed"] == 2 ** 40
        assert a["empty"] == [] and a["longs"] == [1, 2 ** 35]
        assert a["f"] == float(np.float32(0.1)) != 0.1
        assert a["floats"][1] == float(np.float32(1e-12))


# -- real programs, each package's bytes decoded by the other -----------------

def _f32(v):
    if isinstance(v, float):
        return float(np.float32(v))
    if isinstance(v, (list, tuple)):
        return [_f32(x) for x in v]
    return v


def _int_class(dtype):
    return "int" if dtype in ("int32", "int64") else dtype


def desc(program):
    """Blocks as ([(type, inputs, outputs, attrs)], {var: (shape, dtype,
    persistable)}); a sub-block attr as its index, int64 and int32 alike
    where the JAX package (x64 off) records one for the other."""
    out = []
    for b in program.blocks:
        ops = []
        for op in b.ops:
            attrs = {}
            for k, v in op.attrs.items():
                if k.startswith("_"):
                    continue
                if hasattr(v, "idx") and hasattr(v, "ops"):
                    v = ("block", v.idx)
                if k in ("in_dtype", "out_dtype", "dtype") and v in (2, 3):
                    v = 3
                attrs[k] = _f32(v)
            ops.append((op.type, op.inputs, op.outputs, attrs))
        vars_ = {n: (tuple(v.shape or ()), _int_class(str(v.dtype)),
                     bool(v.persistable)) for n, v in b.vars.items()}
        out.append((b.idx, b.parent_idx, ops, vars_))
    return out


def _bert(pkg):
    return TT.build_bert(pkg)[0]


def _seq2seq(pkg):
    return seq2seq_decode(pkg, S2S, beam=3, steps=4)[0]


def _word2vec(pkg):
    return book.word2vec(pkg).main


def _while(pkg):
    return _while_program(pkg)[0]


PROGRAMS = {"bert": _bert, "seq2seq_decode": _seq2seq,
            "word2vec": _word2vec, "while": _while}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_each_package_decodes_the_other_s_program(name):
    jprog, pprog = PROGRAMS[name](jfluid), PROGRAMS[name](fluid)
    jbytes = jpf.program_to_proto_bytes(jprog, ["a"], ["b"])
    pbytes = pf.program_to_proto_bytes(pprog, ["a"], ["b"])
    p_of_j, feeds, fetches = pf.proto_bytes_to_program(jbytes)
    assert (feeds, fetches) == (["a"], ["b"])
    j_of_p = jpf.proto_bytes_to_program(pbytes)[0]
    assert desc(p_of_j) == desc(jpf.proto_bytes_to_program(jbytes)[0])
    assert desc(j_of_p) == desc(pf.proto_bytes_to_program(pbytes)[0])
    assert desc(p_of_j) == desc(j_of_p)
    assert len(p_of_j.blocks) == len(pprog.blocks)
    # the port's decode of its own bytes is its program, floats at f32
    assert desc(pf.proto_bytes_to_program(pbytes)[0])[0][2] == \
        desc(pprog)[0][2]
