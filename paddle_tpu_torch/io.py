"""Model save/load.

Counterpart of ``paddle_tpu/io.py``, writing and reading the same files, so
a model or a set of vars saved by either package loads in the other:

- the var-level APIs (``save_vars`` / ``save_params`` /
  ``save_persistables`` and their ``load_*``, :108-157): one ``.npz``
  (``__params__.npz`` unless ``filename`` names another) and a manifest
  covering it;
- ``save_inference_model`` / ``load_inference_model`` (:253, :334), in two
  formats. JSON: ``__model__.json`` (the pruned program, ``feed_names``,
  ``fetch_names``) + ``__params__.npz``. The reference's protobuf format,
  chosen by a ``model_filename`` that does not end in ``.json``:
  ``core/proto_format``'s ``__model__`` + one tensor stream a persistable,
  or one combined stream file (``params_filename``) holding the
  persistables of all blocks in sorted-name order (inference/io.cc:111).
  A directory holding only a ``__model__`` is read in that format.
  ``keep_training_ops=True`` saves the whole program, backward and
  optimizer ops included;
- ``save`` / ``load`` (:446): ``<path>.pdparams.npz`` (parameters),
  ``<path>.pdopt.npz`` (the other persistables), ``<path>.pdmodel.json``.

Every file lands through ``checkpoint.atomic_write_bytes`` (tmp + fsync +
rename), a manifest of sha256 sums is written last, and a load verifies it
before it reads a byte, raising ``CheckpointCorrupt``.

Tensors cross to disk through ``core/tensor.to_host_array`` and come back
through ``from_host_array`` onto the executor's device (bfloat16 as raw
16-bit words); a load given no executor keeps the device of the tensor
the scope already holds under that name, and puts a new var on the card
(the CPU on a host without one). One rule for integer widths: the JAX
package runs with x64 off, so an int64 var it saves arrives as int32; a
loader that knows the program casts a loaded tensor to its VarDesc's
dtype where the two differ only in integer width, and keeps every other
dtype as saved.

``scope_from_numpy`` carries parameters given as numpy arrays (for
example the JAX package's scope) into the port's scope.
"""
from __future__ import annotations

import io as _pyio
import json
import os
import zipfile
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from . import framework
from .checkpoint import (CheckpointCorrupt, atomic_write_bytes,
                         verify_manifest, write_manifest)
from .core import LoDTensor, global_scope
from .core import dtypes as _dt
from .core import proto_format
from .core.tensor import from_host_array, to_host_array

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "save", "load", "scope_from_numpy",
           "CheckpointCorrupt"]

_INTS = ("int8", "uint8", "int16", "int32", "int64")


def is_persistable(var) -> bool:
    return bool(getattr(var, "persistable", False))


def is_parameter(var) -> bool:
    return isinstance(var, framework.Parameter)


def _collect_vars(program, predicate):
    return [v for v in program.list_vars() if predicate(v)]


def _device(executor, scope, name) -> torch.device:
    """Where a loaded var lands: the executor's device; without an
    executor, the device of the tensor ``scope`` already holds under
    ``name``; without one, the card where the host has one (the CPU
    where it has none)."""
    if executor is not None:
        return executor.device
    var = scope.find_var(name)
    h = var.raw() if var is not None and var.is_initialized() else None
    if isinstance(h, LoDTensor) and h.array is not None:
        return h.array.device
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def _desc_dtypes(program) -> Dict[str, str]:
    return ({v.name: v.dtype for v in program.list_vars()}
            if program is not None else {})


def _tensor(arr, device, want: Optional[str]) -> torch.Tensor:
    """A loaded array as a tensor on ``device``, cast to ``want`` (its
    VarDesc's dtype) where the two differ only in integer width."""
    t = from_host_array(arr, device)
    if want in _INTS and _dt.convert_dtype(t.dtype) in _INTS and \
            _dt.convert_dtype(t.dtype) != want:
        t = t.to(_dt.to_torch_dtype(want))
    return t


def scope_from_numpy(scope, arrays: Dict[str, np.ndarray], place) -> None:
    """Set each named array as a tensor in ``scope`` on ``place``'s
    device. ``place`` is required, as every entry point states its
    device: ``CUDAPlace(0)`` for the card (raising on a host without
    one), ``CPUPlace()`` for the CPU."""
    device = place.device()
    for name, arr in arrays.items():
        scope.var(name).set(LoDTensor(torch.tensor(np.asarray(arr),
                                                   device=device)))


# -- the npz container --------------------------------------------------------


def _host_arrays(names, scope) -> Dict[str, np.ndarray]:
    """The initialized tensors among ``names`` as host arrays."""
    arrays = {}
    for n in names:
        var = scope.find_var(n)
        if var is None or not var.is_initialized():
            continue
        h = var.raw()
        if isinstance(h, LoDTensor) and h.array is not None:
            arrays[n] = to_host_array(h)
    return arrays


def _save_var_dict(names: List[str], scope, path: str) -> str:
    """The named scope vars as one ``.npz`` at ``path``, staged in memory
    and written atomically; returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez would append it; the rename must agree
    buf = _pyio.BytesIO()
    np.savez(buf, **_host_arrays(names, scope))
    atomic_write_bytes(path, buf.getvalue())
    return path


def _load_var_dict(path: str, scope, executor, dtypes=None) -> set:
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path += ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(
            "no parameter file %r in %r — expected an .npz written by "
            "save_vars/save_persistables (was the model saved with a "
            "different `filename`?)"
            % (os.path.basename(path), os.path.dirname(path) or "."))
    try:
        with np.load(path, allow_pickle=False) as data:
            loaded = {n: data[n] for n in data.files}
    except (ValueError, OSError, EOFError, zipfile.BadZipFile,
            zlib.error) as e:
        # a truncated or damaged archive raises BadZipFile or zlib.error,
        # neither of which is an OSError
        raise CheckpointCorrupt(
            "parameter file %r is unreadable (%s: %s) — the save was "
            "interrupted or the file was damaged; fall back to an older "
            "checkpoint" % (path, type(e).__name__, e)) from e
    dtypes = dtypes or {}
    for n, arr in loaded.items():
        scope.var(n).set(LoDTensor(_tensor(arr, _device(executor, scope, n),
                                           dtypes.get(n))))
    return set(loaded)


# -- the var-level APIs -------------------------------------------------------


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = _collect_vars(main_program, predicate or is_persistable)
    names = [v.name if isinstance(v, framework.Variable) else v
             for v in vars]
    path = _save_var_dict(names, global_scope(), os.path.join(
        dirname, filename or "__params__.npz"))
    # the manifest covers only the file this save wrote: hashing the
    # whole dir would pin unrelated, mutable files into it
    write_manifest(dirname, files=[os.path.basename(path)])


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Verify ``dirname``'s manifest (a directory saved before manifests
    existed stays loadable), then load its ``.npz`` onto ``executor``'s
    device. Raises ``RuntimeError`` naming the vars of an explicit
    ``vars`` list that the file lacks."""
    verify_manifest(dirname, required=False)
    main_program = main_program or framework.default_main_program()
    loaded = _load_var_dict(os.path.join(dirname,
                                         filename or "__params__.npz"),
                            global_scope(), executor,
                            _desc_dtypes(main_program))
    want = {v.name if isinstance(v, framework.Variable) else v
            for v in (vars or _collect_vars(main_program,
                                            predicate or is_persistable))}
    missing = want - loaded - {"feed", "fetch"}
    if missing and vars is not None:
        raise RuntimeError("missing vars in checkpoint: %s"
                           % sorted(missing))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


# -- the JSON program form ----------------------------------------------------


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
    """Keep only the ops on the path to the fetches: every op that writes
    a needed var, a ``while`` or ``conditional_block`` whose sub-block
    writes one included, and what each kept op reads (a loop's reads are
    its body's too). The JAX package's prune (``paddle_tpu/io.py:238``)
    looks at an op's own outputs only, so it drops a loop that rewrites
    the fetch target and the loaded model answers without it."""
    from .analysis.verifier import _op_reads_writes

    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        reads, writes = _op_reads_writes(op)
        if any(n in needed for n in writes):
            keep.append(op)
            needed.update(reads)
    block.ops = list(reversed(keep))
    return pruned


def _is_proto(model_filename) -> bool:
    return model_filename is not None and not model_filename.endswith(
        ".json")


# -- inference models ---------------------------------------------------------


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False, keep_training_ops=False):
    """Write ``dirname`` as the JAX package's ``save_inference_model``
    does; returns the fetch names. ``keep_training_ops=True`` saves the
    whole program instead of its inference pruning."""
    main_program = main_program or framework.default_main_program()
    fetch_names = [v.name for v in target_vars]
    pruned = (main_program if keep_training_ops
              else _prune_for_inference(main_program, fetch_names))
    os.makedirs(dirname, exist_ok=True)
    if _is_proto(model_filename):
        written = _save_proto(dirname, pruned, list(feeded_var_names),
                              fetch_names, model_filename, params_filename,
                              program_only)
    else:
        model = _serialize_program(pruned)
        model["feed_names"] = list(feeded_var_names)
        model["fetch_names"] = fetch_names
        model_file = model_filename or "__model__.json"
        atomic_write_bytes(os.path.join(dirname, model_file),
                           json.dumps(model).encode("utf-8"))
        written = [model_file]
        if not program_only:
            path = _save_var_dict(
                [v.name for v in pruned.list_vars() if is_persistable(v)],
                global_scope(),
                os.path.join(dirname, params_filename or "__params__.npz"))
            written.append(os.path.basename(path))
    write_manifest(dirname, files=written)
    return fetch_names


def _save_proto(dirname, program, feed_names, fetch_names, model_filename,
                params_filename, program_only) -> List[str]:
    """The protobuf ``__model__`` and its tensor streams; returns the
    files written."""
    atomic_write_bytes(os.path.join(dirname, model_filename),
                       proto_format.program_to_proto_bytes(
                           program, feed_names, fetch_names))
    written = [model_filename]
    if program_only:
        return written
    names = sorted(v.name for v in program.list_vars() if is_persistable(v))
    arrays = _host_arrays(names, global_scope())
    if params_filename:
        missing = [n for n in names if n not in arrays]
        if missing:
            # the combined loader reads one stream for every persistable
            # of the program in this order: leaving one out would shift
            # every later stream into the wrong var
            raise RuntimeError(
                "save_inference_model(combined): persistable var(s) %s "
                "are not initialized in the scope; run the startup "
                "program (or load params) before saving"
                % ", ".join(missing))
        atomic_write_bytes(os.path.join(dirname, params_filename),
                           proto_format.save_combine_bytes(
                               (n, arrays[n]) for n in names))
        written.append(params_filename)
    else:
        # the reference's default: one tensor-stream file a var
        for n in names:
            if n in arrays:
                atomic_write_bytes(os.path.join(dirname, n),
                                   proto_format.serialize_lod_tensor(
                                       arrays[n]))
                written.append(n)
    return written


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load a directory written by either package's (or the reference's)
    ``save_inference_model``: returns ``(program, feed_names,
    fetch_vars)`` with the parameters placed in the current scope on
    ``executor``'s device."""
    if not os.path.isdir(dirname):
        raise FileNotFoundError(
            "model dir %r does not exist — save_inference_model writes a "
            "directory, pass that directory (not a file inside it)"
            % dirname)
    json_path = os.path.join(dirname, model_filename or "__model__.json")
    if model_filename is None and not os.path.exists(json_path) and \
            os.path.exists(os.path.join(dirname, "__model__")):
        model_filename = "__model__"  # a reference-format directory
    if _is_proto(model_filename):
        return _load_proto(dirname, executor, model_filename,
                           params_filename)
    if not os.path.exists(json_path):
        raise FileNotFoundError(
            "no model file %r (or '__model__') in %r — dir contains %s"
            % (os.path.basename(json_path), dirname,
               sorted(os.listdir(dirname))[:10] or "nothing"))
    verify_manifest(dirname, required=False)
    with open(json_path) as f:
        model = json.load(f)
    program = _deserialize_program(model)
    _verify_loaded_program(program, model.get("fetch_names", []))
    params_path = os.path.join(dirname, params_filename or "__params__.npz")
    if not os.path.exists(params_path) and os.path.exists(
            params_path + ".npz"):
        params_path += ".npz"
    if os.path.exists(params_path):
        _load_var_dict(params_path, global_scope(), executor,
                       _desc_dtypes(program))
    elif params_filename is not None:
        # only the default name may be absent (a program_only save)
        raise FileNotFoundError("no parameter file %r in %r — dir contains "
                                "%s" % (params_filename, dirname,
                                        sorted(os.listdir(dirname))[:10]))
    fetch_vars = [program.global_block().var(n)
                  for n in model.get("fetch_names", [])]
    return program, list(model.get("feed_names", [])), fetch_vars


def _verify_loaded_program(program, fetch_names):
    """Verify a program just read from disk (``PADDLE_TPU_VERIFY_IR``;
    off, one probe): a model file corrupted on disk, or saved by a faulty
    rewrite, fails here with the op and the invariant named, not at its
    first run."""
    from .analysis import maybe_verify_program

    maybe_verify_program(program, where="io.load_inference_model",
                         fetch_names=list(fetch_names))


def _load_proto(dirname, executor, model_filename, params_filename):
    """A reference-format directory: the protobuf ``__model__`` and the
    persistables as tensor streams, one file a var or one combined file
    in sorted-name order over all blocks (inference/io.cc:111)."""
    model_path = os.path.join(dirname, model_filename)
    if not os.path.exists(model_path):
        raise FileNotFoundError(
            "no model file %r in %r — dir contains %s"
            % (model_filename, dirname,
               sorted(os.listdir(dirname))[:10] or "nothing"))
    verify_manifest(dirname, required=False)
    with open(model_path, "rb") as f:
        program, feed_names, fetch_names = \
            proto_format.proto_bytes_to_program(f.read())
    _verify_loaded_program(program, fetch_names)
    names = sorted(v.name for v in program.list_vars() if is_persistable(v))
    dtypes = _desc_dtypes(program)
    scope = global_scope()
    if params_filename:
        arrays = proto_format.load_combine(
            os.path.join(dirname, params_filename), names)
        for n, arr in arrays.items():
            scope.var(n).set(LoDTensor(_tensor(
                arr, _device(executor, scope, n), dtypes[n])))
    else:
        missing = [n for n in names
                   if not os.path.exists(os.path.join(dirname, n))]
        if missing:
            raise FileNotFoundError(
                "model dir %r is missing parameter file(s): %s — the "
                "program lists %d persistables; was the model saved with "
                "a combined params_filename?"
                % (dirname, ", ".join(missing[:10]), len(names)))
        for n in names:
            with open(os.path.join(dirname, n), "rb") as f:
                arr, lod, _ = proto_format.parse_lod_tensor(f.read())
            scope.var(n).set(LoDTensor(_tensor(
                arr, _device(executor, scope, n), dtypes[n]), lod))
    fetch_vars = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


# -- save / load --------------------------------------------------------------


def save(program, model_path):
    """``fluid.save``: ``<path>.pdparams.npz`` (parameters),
    ``<path>.pdopt.npz`` (the other persistables) and the program as
    ``<path>.pdmodel.json``."""
    params = [v.name for v in program.list_vars() if is_parameter(v)]
    opt = [v.name for v in program.list_vars()
           if is_persistable(v) and not is_parameter(v)]
    _save_var_dict(params, global_scope(), model_path + ".pdparams.npz")
    _save_var_dict(opt, global_scope(), model_path + ".pdopt.npz")
    atomic_write_bytes(model_path + ".pdmodel.json",
                       json.dumps(_serialize_program(program)).encode())


def load(program, model_path, executor=None, var_list=None):
    """``fluid.load``: the files ``save`` wrote that exist, onto
    ``executor``'s device; without one, each var onto the device its
    tensor in the scope is on (the card for a new var)."""
    for suffix in (".pdparams.npz", ".pdopt.npz"):
        p = model_path + suffix
        if os.path.exists(p):
            _load_var_dict(p, global_scope(), executor,
                           _desc_dtypes(program))
