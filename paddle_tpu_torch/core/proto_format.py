"""The reference's model format: protobuf ``__model__`` + tensor streams.

Counterpart of ``paddle_tpu/core/proto_format.py``, kept as its own copy
(numpy and the port's ``core/dtypes`` only). The reference serializes a
ProgramDesc as a protobuf message (framework.proto:211) and loads it in
inference through LoadModel (inference/io.cc). This module writes the WIRE
format directly, a hand-written proto2 codec driven by field tables
transcribed from the schema, so a model directory saved by the reference,
by the JAX package or by the port loads in the others. JSON stays the
native format (``io.py``); this is the compatibility path.

Tensor data uses the reference's stream framing (lod_tensor.cc:219
SerializeToStream + tensor_util.cc:383 TensorToStream): u32 version, u64
lod_level, per level u64 byte size + u64 offsets, then u32 version, i32
TensorDesc size, TensorDesc, raw bytes. A combined params file is these
streams back to back in sorted-name order (inference/io.cc:111).

Where the port differs from the JAX copy:

- bfloat16 streams are read as raw 16-bit words under numpy's ``|V2``
  (``core/tensor.from_host_array`` makes them ``torch.bfloat16``); the
  JAX package relies on ``ml_dtypes`` for that;
- a var's ``lod_level`` is written into its LoDTensorDesc and read back
  (the JAX copy leaves the field out and ignores it, so the bytes stay
  readable by both);
- a list of sub-blocks is a ``BLOCKS`` attribute, and numpy scalars in
  attributes are written as the Python numbers they hold.

Float attributes are 32-bit on the wire (proto ``FLOAT``): a reload holds
each float attribute's float32 rounding (``epsilon=1e-12`` comes back as
``9.99999996e-13``).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from . import dtypes as _dt

# ---------------------------------------------------------------------------
# proto2 wire primitives
# ---------------------------------------------------------------------------

_WT_VARINT, _WT_64BIT, _WT_LEN, _WT_32BIT = 0, 1, 2, 5


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, val: int) -> None:
    if val < 0:
        val &= (1 << 64) - 1  # negative int32/64 → 10-byte varint
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, payload). payload is an int for
    varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        fno, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(data, pos)
        elif wt == _WT_LEN:
            ln, pos = _read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wt == _WT_32BIT:
            val = struct.unpack("<I", data[pos:pos + 4])[0]
            pos += 4
        elif wt == _WT_64BIT:
            val = struct.unpack("<Q", data[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError("unsupported wire type %d (field %d)"
                             % (wt, fno))
        yield fno, wt, val


def _to_signed(val: int, bits: int = 64) -> int:
    if val >= 1 << (bits - 1):
        val -= 1 << bits
    return val


# ---------------------------------------------------------------------------
# framework.proto field tables (framework.proto:42-216)
# kind: int / bool / float / str / enum / msg:<table> ; '*' = repeated
# ---------------------------------------------------------------------------

TENSOR_DESC = {1: ("data_type", "enum"), 2: ("dims", "int*")}
LOD_TENSOR_DESC = {1: ("tensor", "msg", TENSOR_DESC),
                   2: ("lod_level", "int")}
VAR_TYPE = {
    1: ("type", "enum"),
    2: ("selected_rows", "msg", TENSOR_DESC),
    3: ("lod_tensor", "msg", LOD_TENSOR_DESC),
    4: ("tensor_array", "msg", LOD_TENSOR_DESC),
}
VAR_DESC = {1: ("name", "str"), 2: ("type", "msg", VAR_TYPE),
            3: ("persistable", "bool"), 4: ("need_check_feed", "bool")}
OP_DESC_VAR = {1: ("parameter", "str"), 2: ("arguments", "str*")}
OP_DESC_ATTR = {
    1: ("name", "str"), 2: ("type", "enum"),
    3: ("i", "int"), 4: ("f", "float"), 5: ("s", "str"),
    6: ("ints", "int*"), 7: ("floats", "float*"), 8: ("strings", "str*"),
    10: ("b", "bool"), 11: ("bools", "bool*"), 12: ("block_idx", "int"),
    13: ("l", "int"), 14: ("blocks_idx", "int*"), 15: ("longs", "int*"),
}
OP_DESC = {
    1: ("inputs", "msg*", OP_DESC_VAR), 2: ("outputs", "msg*", OP_DESC_VAR),
    3: ("type", "str"), 4: ("attrs", "msg*", OP_DESC_ATTR),
    5: ("is_target", "bool"),
}
BLOCK_DESC = {
    1: ("idx", "int"), 2: ("parent_idx", "int"),
    3: ("vars", "msg*", VAR_DESC), 4: ("ops", "msg*", OP_DESC),
    5: ("forward_block_idx", "int"),
}
VERSION = {1: ("version", "int")}
PROGRAM_DESC = {1: ("blocks", "msg*", BLOCK_DESC),
                4: ("version", "msg", VERSION)}

# AttrType enum (framework.proto:25)
(ATTR_INT, ATTR_FLOAT, ATTR_STRING, ATTR_INTS, ATTR_FLOATS, ATTR_STRINGS,
 ATTR_BOOLEAN, ATTR_BOOLEANS, ATTR_BLOCK, ATTR_LONG, ATTR_BLOCKS,
 ATTR_LONGS) = range(12)


def decode_message(data: bytes, table: Dict) -> Dict:
    """Decode one message into a plain dict via its field table."""
    out: Dict = {}
    for fno, wt, val in _iter_fields(data):
        spec = table.get(fno)
        if spec is None:
            continue  # unknown field: skip (forward compat)
        name, kind = spec[0], spec[1]
        repeated = kind.endswith("*")
        base = kind[:-1] if repeated else kind
        if base == "msg":
            v = decode_message(val, spec[2])
        elif base == "str":
            v = val.decode("utf-8")
        elif base == "float":
            if wt == _WT_LEN:  # packed repeated f32 (proto3 writers)
                vs = [float(x) for x in
                      struct.unpack("<%df" % (len(val) // 4), val)]
                if repeated:
                    out.setdefault(name, []).extend(vs)
                    continue
                v = vs[-1] if vs else 0.0
            elif wt == _WT_32BIT:
                v = struct.unpack("<f", struct.pack("<I", val))[0]
            else:
                v = float(val)
        elif base in ("int", "enum", "bool"):
            if wt == _WT_LEN:  # packed repeated varints
                pos, vs = 0, []
                while pos < len(val):
                    x, pos = _read_varint(val, pos)
                    vs.append(bool(x) if base == "bool"
                              else _to_signed(x))
                if repeated:
                    out.setdefault(name, []).extend(vs)
                    continue
                v = vs[-1] if vs else (False if base == "bool" else 0)
            elif base == "bool":
                v = bool(val)
            else:
                v = _to_signed(val) if base == "int" else val
        else:
            raise ValueError("bad field kind %r" % kind)
        if repeated:
            out.setdefault(name, []).append(v)
        else:
            out[name] = v
    return out


def encode_message(msg: Dict, table: Dict) -> bytes:
    """Encode a plain dict into proto2 wire bytes via its field table.
    proto2 convention: repeated scalars unpacked."""
    out = bytearray()
    for fno in sorted(table):
        spec = table[fno]
        name, kind = spec[0], spec[1]
        if name not in msg or msg[name] is None:
            continue
        repeated = kind.endswith("*")
        base = kind[:-1] if repeated else kind
        vals = msg[name] if repeated else [msg[name]]
        for v in vals:
            if base == "msg":
                payload = encode_message(v, spec[2])
                _write_varint(out, (fno << 3) | _WT_LEN)
                _write_varint(out, len(payload))
                out.extend(payload)
            elif base == "str":
                payload = v.encode("utf-8")
                _write_varint(out, (fno << 3) | _WT_LEN)
                _write_varint(out, len(payload))
                out.extend(payload)
            elif base == "float":
                _write_varint(out, (fno << 3) | _WT_32BIT)
                out.extend(struct.pack("<f", float(v)))
            elif base in ("int", "enum", "bool"):
                _write_varint(out, (fno << 3) | _WT_VARINT)
                _write_varint(out, int(v))
            else:
                raise ValueError("bad field kind %r" % kind)
    return bytes(out)


# ---------------------------------------------------------------------------
# ProgramDesc dict <-> Program
# ---------------------------------------------------------------------------

# VarType.Type values of the var kinds written here (framework.proto:104)
_VT_LOD_TENSOR, _VT_FEED, _VT_FETCH = 7, 9, 10


def _attr_to_py(attr: Dict):
    t = attr.get("type", ATTR_INT)
    if t == ATTR_INT:
        return attr.get("i", 0)
    if t == ATTR_FLOAT:
        return attr.get("f", 0.0)
    if t == ATTR_STRING:
        return attr.get("s", "")
    if t == ATTR_INTS:
        return list(attr.get("ints", []))
    if t == ATTR_FLOATS:
        return list(attr.get("floats", []))
    if t == ATTR_STRINGS:
        return list(attr.get("strings", []))
    if t == ATTR_BOOLEAN:
        return bool(attr.get("b", False))
    if t == ATTR_BOOLEANS:
        return [bool(b) for b in attr.get("bools", [])]
    if t == ATTR_BLOCK:
        return ("__block__", attr.get("block_idx", 0))
    if t == ATTR_BLOCKS:
        return ("__blocks__", list(attr.get("blocks_idx", [])))
    if t == ATTR_LONG:
        return attr.get("l", 0)
    if t == ATTR_LONGS:
        return list(attr.get("longs", []))
    raise ValueError("unknown AttrType %r" % t)


def _plain(v):
    """A numpy scalar as the Python number it holds."""
    return v.item() if isinstance(v, np.generic) else v


def _py_to_attr(name: str, v) -> Dict:
    """The AttrDesc of one attribute, or {} for a value the format has no
    type for. ``bool`` is tested before ``int`` (a bool is an int in
    Python); an int outside int32 is a ``LONG`` (a 64-bit seed); an empty
    list has no element type and goes as ``BOOLEANS``, as in the JAX
    copy, and reads back as []."""
    v = _plain(v)
    a: Dict = {"name": name}
    if isinstance(v, bool):
        a["type"], a["b"] = ATTR_BOOLEAN, v
    elif isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            a["type"], a["i"] = ATTR_INT, v
        else:
            a["type"], a["l"] = ATTR_LONG, v
    elif isinstance(v, float):
        a["type"], a["f"] = ATTR_FLOAT, v
    elif isinstance(v, str):
        a["type"], a["s"] = ATTR_STRING, v
    elif isinstance(v, (list, tuple)):
        v = [_plain(x) for x in v]
        if all(isinstance(x, bool) for x in v):
            a["type"], a["bools"] = ATTR_BOOLEANS, [bool(x) for x in v]
        elif all(isinstance(x, int) for x in v):
            if any(not -(1 << 31) <= x < (1 << 31) for x in v):
                a["type"], a["longs"] = ATTR_LONGS, v
            else:
                a["type"], a["ints"] = ATTR_INTS, v
        elif all(isinstance(x, str) for x in v):
            a["type"], a["strings"] = ATTR_STRINGS, list(v)
        else:
            a["type"], a["floats"] = ATTR_FLOATS, [float(x) for x in v]
    else:
        return {}
    return a


def _col_op(typ: str, slot_in, slot_out, col: int) -> Dict:
    return {"type": typ,
            "inputs": [{"parameter": "X", "arguments": [slot_in]}],
            "outputs": [{"parameter": "Out", "arguments": [slot_out]}],
            "attrs": [{"name": "col", "type": ATTR_INT, "i": col}]}


def program_to_proto_bytes(program, feed_names=(), fetch_names=()) -> bytes:
    """Serialize a Program as a reference-format ProgramDesc, with the
    feed ops prepended and the fetch ops appended as the reference's
    save_inference_model does (io.py prepend_feed_ops/append_fetch_ops).
    Attributes whose name starts with ``_`` (the executors' reserved
    ones) are not written."""
    from ..framework import Block

    blocks = []
    for b in program.blocks:
        vars_pb = []
        for name, v in b.vars.items():
            desc = {"tensor": {
                "data_type": _dt.dtype_to_enum(v.dtype or "float32"),
                "dims": [int(d) for d in (v.shape or ())]}}
            if v.lod_level:
                desc["lod_level"] = int(v.lod_level)
            vars_pb.append({"name": name,
                            "type": {"type": _VT_LOD_TENSOR,
                                     "lod_tensor": desc},
                            "persistable": bool(v.persistable)})
        ops_pb = []
        if b.idx == 0:
            vars_pb.append({"name": "feed", "type": {"type": _VT_FEED},
                            "persistable": True})
            vars_pb.append({"name": "fetch", "type": {"type": _VT_FETCH},
                            "persistable": True})
            ops_pb += [_col_op("feed", "feed", fn, i)
                       for i, fn in enumerate(feed_names)]
        for op in b.ops:
            attrs = []
            for k, v in sorted(op.attrs.items()):
                if k.startswith("_"):
                    continue
                if isinstance(v, Block):
                    attrs.append({"name": k, "type": ATTR_BLOCK,
                                  "block_idx": int(v.idx)})
                elif isinstance(v, (list, tuple)) and v and all(
                        isinstance(x, Block) for x in v):
                    attrs.append({"name": k, "type": ATTR_BLOCKS,
                                  "blocks_idx": [int(x.idx) for x in v]})
                else:
                    a = _py_to_attr(k, v)
                    if a:
                        attrs.append(a)
            ops_pb.append({
                "type": op.type,
                "inputs": [{"parameter": k, "arguments": list(v)}
                           for k, v in sorted(op.inputs.items())],
                "outputs": [{"parameter": k, "arguments": list(v)}
                            for k, v in sorted(op.outputs.items())],
                "attrs": attrs})
        if b.idx == 0:
            ops_pb += [_col_op("fetch", fn, "fetch", i)
                       for i, fn in enumerate(fetch_names)]
        blocks.append({"idx": b.idx, "parent_idx": b.parent_idx,
                       "vars": vars_pb, "ops": ops_pb})
    return encode_message({"blocks": blocks, "version": {"version": 0}},
                          PROGRAM_DESC)


def _col(od: Dict) -> int:
    for a in od.get("attrs", []):
        if a.get("name") == "col":
            return a.get("i", 0)
    return 0


def _place(names: List[str], col: int, name: str) -> None:
    while len(names) <= col:
        names.append("")
    names[col] = name


def proto_bytes_to_program(data: bytes):
    """Parse a reference ``__model__`` into (Program, feed_names,
    fetch_names). The feed and fetch ops are stripped: the executor feeds
    and fetches scope vars directly."""
    from .. import framework

    desc = decode_message(data, PROGRAM_DESC)
    # the reference stamps PADDLE_VERSION_INTEGER (major*1e6 + minor*1e3
    # + patch, 1007000 for the fluid 1.7 line this format tracks); 2.x
    # programs use another op surface, so they are refused, not misread
    ver = desc.get("version", {}).get("version", 0)
    if ver >= 2000000:
        raise RuntimeError(
            "__model__ program version %d is from the 2.x format line; "
            "this build reads fluid-era (<2.0) models" % ver)
    program = framework.Program()
    # every block first: a sub-block attribute names its block by index
    while len(program.blocks) < len(desc.get("blocks", [])):
        program._create_block()
        program._rollback()
    feed_names: List[str] = []
    fetch_names: List[str] = []
    for bd in desc.get("blocks", []):
        b = program.blocks[bd["idx"]]
        if bd["idx"] > 0:
            b.parent_idx = bd.get("parent_idx", -1)
        for vd in bd.get("vars", []):
            name = vd["name"]
            if name in ("feed", "fetch"):
                continue
            vt = vd.get("type", {})
            lt = vt.get("lod_tensor") or vt.get("selected_rows") or {}
            td = lt.get("tensor", lt if "data_type" in lt else {})
            try:
                dtype = (_dt.convert_dtype(td["data_type"])
                         if "data_type" in td else None)
            except (KeyError, ValueError):
                dtype = None
            v = b.create_var(name=name)
            v.shape = tuple(td.get("dims", ())) or None
            if dtype is not None:
                v.dtype = dtype
            v.lod_level = int(lt.get("lod_level", 0))
            v.persistable = bool(vd.get("persistable", False))
        for od in bd.get("ops", []):
            typ = od["type"]
            if typ == "feed":
                _place(feed_names, _col(od),
                       od.get("outputs", [{}])[0].get("arguments", [""])[0])
                continue
            if typ == "fetch":
                _place(fetch_names, _col(od),
                       od.get("inputs", [{}])[0].get("arguments", [""])[0])
                continue
            attrs = {}
            for a in od.get("attrs", []):
                v = _attr_to_py(a)
                if isinstance(v, tuple) and v and v[0] == "__block__":
                    v = program.blocks[v[1]]
                elif isinstance(v, tuple) and v and v[0] == "__blocks__":
                    v = [program.blocks[i] for i in v[1]]
                attrs[a["name"]] = v
            op = framework.Operator(b, typ, None, None, attrs)
            op.inputs = {d["parameter"]: list(d.get("arguments", []))
                         for d in od.get("inputs", [])}
            op.outputs = {d["parameter"]: list(d.get("arguments", []))
                          for d in od.get("outputs", [])}
            op._id = program._next_op_id()
            b.ops.append(op)
    return (program, [n for n in feed_names if n],
            [n for n in fetch_names if n])


# ---------------------------------------------------------------------------
# LoDTensor stream format (lod_tensor.cc:219 + tensor_util.cc:383)
# ---------------------------------------------------------------------------


def _dtype_name(arr: np.ndarray) -> str:
    """The canonical dtype name of a host array; ``|V2`` is bfloat16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return "bfloat16"
    return _dt.convert_dtype(arr.dtype)


def serialize_lod_tensor(arr, lod=None) -> bytes:
    """One tensor stream of a host array (``core/tensor.to_host_array``
    makes one of a tensor)."""
    arr = np.asarray(arr)
    out = bytearray()
    out += struct.pack("<I", 0)                      # LoDTensor version
    lod = lod or []
    out += struct.pack("<Q", len(lod))               # lod_level
    for level in lod:
        out += struct.pack("<Q", len(level) * 8)
        out += np.asarray(level, dtype="<u8").tobytes()
    out += struct.pack("<I", 0)                      # Tensor version
    desc = encode_message(
        {"data_type": _dt.dtype_to_enum(_dtype_name(arr)),
         "dims": [int(d) for d in arr.shape]}, TENSOR_DESC)
    out += struct.pack("<i", len(desc))
    out += desc
    out += arr.tobytes(order="C")
    return bytes(out)


def _np_dtype(enum: int) -> np.dtype:
    name = _dt.convert_dtype(int(enum))
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def parse_lod_tensor(data: bytes, pos: int = 0):
    """Returns (array, lod, next_pos); a bfloat16 stream as ``|V2``."""
    (ver,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if ver != 0:
        raise ValueError("unsupported LoDTensor version %d" % ver)
    (lod_level,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        level = np.frombuffer(data, dtype="<u8", count=nbytes // 8,
                              offset=pos)
        pos += nbytes
        lod.append([int(x) for x in level])
    (tver,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if tver != 0:
        raise ValueError("unsupported Tensor version %d" % tver)
    (dlen,) = struct.unpack_from("<i", data, pos)
    pos += 4
    desc = decode_message(data[pos:pos + dlen], TENSOR_DESC)
    pos += dlen
    dtype = _np_dtype(desc["data_type"])
    dims = desc.get("dims", [])
    numel = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(data, dtype=dtype, count=numel,
                        offset=pos).reshape(dims)
    pos += numel * dtype.itemsize
    return arr, lod, pos


def save_combine_bytes(named_arrays) -> bytes:
    """The reference save_combine_op framing: streams back to back, in the
    given order (callers pass sorted names, as inference/io.cc does)."""
    return b"".join(serialize_lod_tensor(arr) for _, arr in named_arrays)


def save_combine(named_arrays, path: str) -> None:
    with open(path, "wb") as f:
        f.write(save_combine_bytes(named_arrays))


def load_combine(path: str, names: List[str]):
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    out = {}
    for n in names:
        arr, _lod, pos = parse_lod_tensor(data, pos)
        out[n] = arr
    if pos != len(data):
        raise ValueError(
            "combined param file has %d trailing bytes (name list "
            "mismatch?)" % (len(data) - pos))
    return out
