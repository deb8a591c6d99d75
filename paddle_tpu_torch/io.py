"""Inference model save/load.

Counterpart of ``save_inference_model`` (:253) and ``load_inference_model``
(:334) of ``paddle_tpu/io.py``, writing and reading the same directory:

- ``__model__.json``: the pruned program as JSON, plus ``feed_names`` and
  ``fetch_names``;
- ``__params__.npz``: the persistables as numpy arrays;
- ``__manifest__.json``: sha256 and size of each file, written last.

Every file lands through tmp + fsync + rename, and the load side verifies
the manifest before it reads a byte of the model, so a model saved by
either package loads in the other. The reference's protobuf ``__model__``
format comes with a later slice.

``scope_from_numpy`` carries parameters given as numpy arrays (for
example the JAX package's scope) into the port's scope.
"""
from __future__ import annotations

import hashlib
import io as _pyio
import json
import os
import threading
import time
import zipfile
import zlib
from typing import Dict, List

import numpy as np
import torch

from . import framework
from .core import LoDTensor, global_scope

__all__ = ["save_inference_model", "load_inference_model",
           "scope_from_numpy", "CheckpointCorrupt"]

MANIFEST_NAME = "__manifest__.json"


class CheckpointCorrupt(RuntimeError):
    """A saved model directory failed its manifest check or is unreadable."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """The file at ``path`` is always the old content or all of ``data``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, ".tmp-%s-%d-%d-%d" % (
        os.path.basename(path), os.getpid(), threading.get_ident() % 100000,
        time.monotonic_ns() % 1_000_000))
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def _write_manifest(dirname: str, files: List[str]) -> None:
    listed = {}
    for fn in sorted(files):
        p = os.path.join(dirname, fn)
        listed[fn] = {"sha256": _sha256(p), "bytes": os.path.getsize(p)}
    _atomic_write_bytes(
        os.path.join(dirname, MANIFEST_NAME),
        json.dumps({"version": 1, "files": listed}, indent=1,
                   sort_keys=True).encode())


def _verify_manifest(dirname: str) -> None:
    """Check every file a manifest lists; a directory without one (saved
    before manifests existed) stays loadable."""
    mpath = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            listed = json.load(f)["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorrupt("manifest %r is unreadable: %s"
                                % (mpath, e)) from e
    for fn, meta in listed.items():
        p = os.path.join(dirname, fn)
        if not os.path.exists(p):
            raise CheckpointCorrupt("%r is missing file %r listed in its "
                                    "manifest" % (dirname, fn))
        if os.path.getsize(p) != int(meta.get("bytes", -1)):
            raise CheckpointCorrupt("%r is %d bytes, manifest says %s"
                                    % (p, os.path.getsize(p),
                                       meta.get("bytes")))
        if _sha256(p) != meta.get("sha256"):
            raise CheckpointCorrupt("%r fails sha256 verification" % p)


def scope_from_numpy(scope, arrays: Dict[str, np.ndarray], place) -> None:
    """Set each named array as a tensor in ``scope`` on ``place``'s
    device. ``place`` is required, as every entry point states its
    device: ``CUDAPlace(0)`` for the card (raising on a host without
    one), ``CPUPlace()`` for the CPU."""
    device = place.device()
    for name, arr in arrays.items():
        scope.var(name).set(LoDTensor(torch.tensor(np.asarray(arr),
                                                   device=device)))


def _serialize_program(program) -> Dict:
    blocks = []
    for b in program.blocks:
        ops = []
        for op in b.ops:
            attrs = {k: {"__block__": v.idx} if isinstance(v, framework.Block)
                     else list(v) if isinstance(v, tuple) else v
                     for k, v in op.attrs.items()}
            ops.append({"type": op.type, "inputs": op.inputs,
                        "outputs": op.outputs, "attrs": attrs,
                        "id": op._id})
        vars_ = {}
        for name, v in b.vars.items():
            vars_[name] = {
                "shape": list(v.shape) if v.shape is not None else None,
                "dtype": v.dtype,
                "lod_level": v.lod_level,
                "persistable": v.persistable,
                "stop_gradient": v.stop_gradient,
                "is_parameter": isinstance(v, framework.Parameter),
                "type": v.type,
            }
        blocks.append({"idx": b.idx, "parent_idx": b.parent_idx,
                       "ops": ops, "vars": vars_})
    return {"blocks": blocks, "version": 1}


def _deserialize_program(data: Dict) -> framework.Program:
    version = data.get("version", 1)
    if version > 1:
        raise RuntimeError("model format version %d is newer than this "
                           "build supports (1)" % version)
    program = framework.Program()
    program.blocks = [framework.Block(program, bd["idx"], bd["parent_idx"])
                      for bd in data["blocks"]]
    for bd, b in zip(data["blocks"], program.blocks):
        for name, vd in bd["vars"].items():
            if vd.get("is_parameter"):
                v = framework.Parameter(b, shape=vd["shape"],
                                        dtype=vd["dtype"], name=name)
            else:
                v = framework.Variable(
                    b, name=name, shape=vd["shape"], dtype=vd["dtype"],
                    lod_level=vd.get("lod_level", 0),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    type=vd.get("type", "lod_tensor"))
            b.vars[name] = v
        for od in bd["ops"]:
            attrs = {k: program.blocks[v["__block__"]]
                     if isinstance(v, dict) and "__block__" in v else v
                     for k, v in (od.get("attrs") or {}).items()}
            op = framework.Operator(b, od["type"], None, None, attrs)
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            op._id = od.get("id")
            b.ops.append(op)
            program._op_id = max(program._op_id, op._id or 0)
    return program


def _prune_for_inference(program, fetch_names):
    """Keep only the ops on the path to the fetches."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_arg_names):
            keep.append(op)
            needed.update(op.input_arg_names)
    block.ops = list(reversed(keep))
    return pruned


def _check_json_format(model_filename):
    if model_filename is not None and not model_filename.endswith(".json"):
        raise NotImplementedError(
            "model file %r: the reference's protobuf __model__ format is "
            "not yet ported (ROADMAP.md, queue 1); use the JSON format"
            % model_filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Write ``dirname`` as the JAX package's ``save_inference_model``
    does (JSON program + npz params + manifest); returns the fetch
    names."""
    _check_json_format(model_filename)
    main_program = main_program or framework.default_main_program()
    fetch_names = [v.name for v in target_vars]
    pruned = _prune_for_inference(main_program, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    model = _serialize_program(pruned)
    model["feed_names"] = list(feeded_var_names)
    model["fetch_names"] = fetch_names
    model_file = model_filename or "__model__.json"
    _atomic_write_bytes(os.path.join(dirname, model_file),
                        json.dumps(model).encode("utf-8"))
    written = [model_file]
    if not program_only:
        scope = global_scope()
        arrays = {}
        for v in pruned.list_vars():
            var = scope.find_var(v.name) if v.persistable else None
            if var is not None and var.is_initialized():
                arrays[v.name] = var.raw().numpy()
        pfile = params_filename or "__params__.npz"
        if not pfile.endswith(".npz"):
            pfile += ".npz"
        buf = _pyio.BytesIO()
        np.savez(buf, **arrays)
        _atomic_write_bytes(os.path.join(dirname, pfile), buf.getvalue())
        written.append(pfile)
    _write_manifest(dirname, written)
    return fetch_names


def _load_params(path: str, scope, device: torch.device) -> None:
    try:
        with np.load(path, allow_pickle=False) as data:
            arrays = {n: data[n] for n in data.files}
    except (ValueError, OSError, EOFError, zipfile.BadZipFile,
            zlib.error) as e:
        raise CheckpointCorrupt("parameter file %r is unreadable (%s: %s)"
                                % (path, type(e).__name__, e)) from e
    for name, arr in arrays.items():
        scope.var(name).set(LoDTensor(torch.from_numpy(arr).to(device)))


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load a directory written by either package's
    ``save_inference_model``: returns ``(program, feed_names,
    fetch_vars)`` with the parameters placed in the current scope on
    ``executor``'s device."""
    _check_json_format(model_filename)
    if not os.path.isdir(dirname):
        raise FileNotFoundError("model dir %r does not exist" % dirname)
    json_path = os.path.join(dirname, model_filename or "__model__.json")
    if not os.path.exists(json_path):
        raise FileNotFoundError(
            "no model file %r in %r — dir contains %s"
            % (os.path.basename(json_path), dirname,
               sorted(os.listdir(dirname))[:10] or "nothing"))
    _verify_manifest(dirname)
    with open(json_path) as f:
        model = json.load(f)
    program = _deserialize_program(model)
    params_path = os.path.join(dirname, params_filename or "__params__.npz")
    if not os.path.exists(params_path) and os.path.exists(
            params_path + ".npz"):
        params_path += ".npz"
    if os.path.exists(params_path):
        _load_params(params_path, global_scope(), executor.device)
    elif params_filename is not None:
        raise FileNotFoundError("no parameter file %r in %r"
                                % (params_filename, dirname))
    fetch_vars = [program.global_block().var(n)
                  for n in model.get("fetch_names", [])]
    return program, list(model.get("feed_names", [])), fetch_vars
