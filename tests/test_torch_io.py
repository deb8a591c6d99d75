"""The port's ``io.py`` against the JAX package's, on the CPU: every file
one package writes, the other reads.

- The var-level APIs (``save_vars`` / ``save_params`` /
  ``save_persistables`` and their loads), ``save`` / ``load``, and
  ``save_inference_model(keep_training_ops=True)``, each direction; the
  missing-vars ``RuntimeError``; twins of ``tests/test_fault_tolerance.py``
  's manifest cases (a flipped byte is ``CheckpointCorrupt``, a missing
  file or directory is named).
- Inference models of each book chapter, of narrow BERT and of the
  seq2seq beam decoder, in the three formats (JSON; protobuf with one
  tensor file a var; protobuf with a combined params file), saved by each
  package and loaded by the other: the loaded program's fetches must be
  within 1e-6 of the saving package's own fetches, relative to each
  output's scale (integer outputs, beam ids and chunk counts, exactly).
  Both packages start from the JAX startup's persistables.
- Twins of ``tests/test_inference_io.py``'s cases: the combined protobuf
  format through ``AnalysisConfig.set_prog_file`` / ``set_params_file``;
  the combined save refusing an uninitialized persistable; the separate
  files skipping it. bfloat16 persistables cross as their bits.
- The ``save`` / ``load`` / ``save_combine`` / ``load_combine`` ops, as
  in ``tests/test_tail_ops.py``.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import book

import test_torch_lr_schedule as LS  # noqa: E402
import test_torch_transformer_training as TT  # noqa: E402
from paddle_tpu_torch.models import transformer as T  # noqa: E402
from test_torch_rnn import S2S, seq2seq_decode, seq2seq_feeds  # noqa: E402

FETCH_RTOL = 1e-6
FORMATS = {"json": (None, None),
           "proto_separate": ("__model__", None),
           "proto_combined": ("__model__", "__params__")}


def _fc_model(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4, 5], dtype="float32")
        pred = pkg.layers.fc(pkg.layers.fc(x, 7, act="relu"), 2)
        loss = pkg.layers.mean(pred)
        pkg.optimizer.AdamOptimizer(0.1).minimize(loss)
    return main, startup, pred, loss


def _x():
    return np.random.RandomState(3).rand(4, 5).astype("float32")


def _jax_exe():
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe._core.rng.seed = 11
    exe._core.rng.step = 0
    return exe


def _arrays(scope, names):
    return {n: np.asarray(scope.find_var(n).get_tensor()) for n in names}


def _persistable_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


# -- the var-level APIs, save / load, keep_training_ops -----------------------

@pytest.mark.parametrize("api", ["persistables", "params", "vars"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_var_level_apis_cross_packages(tmp_path, api, direction):
    jmain, jstartup, _, _ = _fc_model(jfluid)
    pmain, pstartup, _, _ = _fc_model(fluid)
    names = _persistable_names(pmain)
    params = sorted(p.name for p in pmain.all_parameters())
    want = names if api != "params" else params
    d = str(tmp_path)
    src, dst = ((jfluid, jmain, jstartup, _jax_exe()),
                (fluid, pmain, pstartup, fluid.Executor(fluid.CPUPlace())))
    if direction == "port_to_jax":
        src, dst = dst, src
    pkg, main, startup, exe = src
    with pkg.scope_guard(pkg.Scope()) as _:
        scope = pkg.global_scope()
        exe.run(startup)
        saved = _arrays(scope, names)
        if api == "vars":
            pkg.io.save_vars(exe, d, main, vars=[main.global_block().var(n)
                                                 for n in want])
        else:
            getattr(pkg.io, "save_" + api)(exe, d, main)
    pkg, main, _, exe = dst
    with pkg.scope_guard(pkg.Scope()):
        if api == "vars":
            pkg.io.load_vars(exe, d, main, vars=[
                main.global_block().var(n) for n in want])
        else:
            getattr(pkg.io, "load_" + api)(exe, d, main)
        got = _arrays(pkg.global_scope(), want)
    for n in want:
        np.testing.assert_array_equal(got[n].astype(saved[n].dtype),
                                      saved[n], err_msg=n)


def test_load_vars_names_the_missing_vars(tmp_path):
    main, startup, _, _ = _fc_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_params(exe, str(tmp_path), main)
        with pytest.raises(RuntimeError, match="missing vars.*moment"):
            fluid.io.load_vars(exe, str(tmp_path), main,
                               vars=_persistable_names(main))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_and_load_cross_packages(tmp_path, direction):
    """``fluid.save`` / ``fluid.load``: parameters in ``.pdparams.npz``,
    the optimizer state in ``.pdopt.npz``, the program as JSON."""
    jmain, jstartup, _, _ = _fc_model(jfluid)
    pmain, pstartup, _, _ = _fc_model(fluid)
    path = str(tmp_path / "model")
    names = _persistable_names(pmain)
    if direction == "jax_to_port":
        with jfluid.scope_guard(jfluid.Scope()):
            _jax_exe().run(jstartup)
            saved = _arrays(jfluid.global_scope(), names)
            jfluid.save(jmain, path)
        with fluid.scope_guard(fluid.Scope()):
            fluid.load(pmain, path, fluid.Executor(fluid.CPUPlace()))
            got = _arrays(fluid.global_scope(), names)
    else:
        with fluid.scope_guard(fluid.Scope()):
            fluid.Executor(fluid.CPUPlace()).run(pstartup)
            saved = _arrays(fluid.global_scope(), names)
            fluid.save(pmain, path)
        with jfluid.scope_guard(jfluid.Scope()):
            jfluid.load(jmain, path)
            got = _arrays(jfluid.global_scope(), names)
    assert {os.path.basename(path) + s for s in
            (".pdparams.npz", ".pdopt.npz", ".pdmodel.json")} <= set(
        os.listdir(tmp_path))
    with np.load(path + ".pdparams.npz") as f:
        assert sorted(f.files) == sorted(
            p.name for p in pmain.all_parameters())
    for n in names:
        np.testing.assert_array_equal(got[n].astype(saved[n].dtype),
                                      saved[n], err_msg=n)


@pytest.mark.parametrize("api", ["load", "load_persistables"])
def test_a_load_without_an_executor_keeps_each_var_s_device(tmp_path, api):
    """Given no executor, a load puts each var where the scope's tensor of
    that name already is (a ``meta`` tensor here stands for one on a
    device other than the host), and a var the scope lacks on the card,
    which on this host without one is the CPU."""
    main, startup, _, _ = _fc_model(fluid)
    names = _persistable_names(main)
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        fluid.save(main, str(tmp_path / "model"))
        fluid.io.save_persistables(None, str(tmp_path), main)
    load = {"load": lambda: fluid.load(main, str(tmp_path / "model")),
            "load_persistables": lambda: fluid.io.load_persistables(
                None, str(tmp_path), main)}[api]
    kept, new = names[0], names[1:]
    with fluid.scope_guard(fluid.Scope()):
        scope = fluid.global_scope()
        scope.var(kept).set(fluid.LoDTensor(torch.zeros(1, device="meta")))
        load()
        assert scope.find_var(kept).get_tensor().array.device.type == \
            "meta"
        want = "cuda" if torch.cuda.is_available() else "cpu"
        for n in new:
            assert scope.find_var(n).get_tensor().array.device.type == \
                want, n


@pytest.mark.parametrize("fmt", ["json", "proto_combined"])
def test_keep_training_ops_saves_the_whole_program(tmp_path, fmt):
    """The port saves the training program whole; each package loads it
    and takes two Adam steps. The steps of the two reloads agree within
    1e-6: a reload is held to the other package's reload of the same
    bytes, as a protobuf float attribute (Adam's betas and epsilon) comes
    back at its float32 value; the first step, before any update, is the
    original program's."""
    model, params = FORMATS[fmt]
    main, startup, pred, loss = _fc_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    x = _x()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["x"], [loss], exe,
                                      main_program=main,
                                      model_filename=model,
                                      params_filename=params,
                                      keep_training_ops=True)
        (first,) = exe.run(main, feed={"x": x}, fetch_list=[loss])
    steps = []
    for pkg in (fluid, jfluid):
        with pkg.scope_guard(pkg.Scope()):
            e = pkg.Executor(pkg.CPUPlace())
            prog, _, fetches = pkg.io.load_inference_model(
                str(tmp_path), e, model_filename=model,
                params_filename=params)
            types = [op.type for op in prog.global_block().ops]
            assert "adam" in types and "mul_grad" in types
            steps.append(np.ravel([e.run(prog, feed={"x": x},
                                         fetch_list=fetches)[0]
                                   for _ in range(2)]))
    np.testing.assert_allclose(steps[0], steps[1], rtol=FETCH_RTOL)
    np.testing.assert_array_equal(steps[0][0], np.ravel(first)[0])
    pruned = str(tmp_path / "pruned")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(pruned, ["x"], [loss], exe,
                                      main_program=main)
        prog, _, _ = fluid.io.load_inference_model(pruned, exe)
    assert "adam" not in [op.type for op in prog.global_block().ops]


# -- inference models of the book, BERT and the seq2seq decoder ---------------

def _chapter(name):
    def build(pkg):
        c = book.CHAPTERS[name](pkg)
        prog = c.infer or c.main
        return c.main, c.startup, prog, c.feed_names, c.targets
    return build


def _mt(pkg):
    c = book.machine_translation(pkg)
    main, startup, outs = book.mt_decode(pkg)
    # the decode program's own params join the trained ones'
    return c.main, [c.startup, startup], main, ["src"], [outs]


def _bert(pkg):
    main, startup, loss, _ = TT.build_bert(pkg)
    return main, startup, main, ["src", "pos", "mpos", "labels"], [loss]


def _s2s(pkg):
    main, startup, fetches = seq2seq_decode(pkg, S2S, beam=3, steps=4)
    return main, startup, main, ["src", "src_len"], fetches


MODELS = {n: _chapter(n) for n in book.CHAPTERS
          if n != "machine_translation"}
MODELS.update(machine_translation=_mt, bert=_bert, seq2seq_decode=_s2s)


def _feed(name, feed_names):
    if name == "bert":
        return T.bert_batch(np.random.RandomState(7), TT.BATCH, TT.SEQ,
                            TT.NARROW["vocab"], TT.MASKED)
    if name == "seq2seq_decode":
        f = seq2seq_feeds(S2S, 1, seed=1)[0]
        return {"src": f["src"], "src_len": f["src_len"]}
    chapter = "machine_translation" if name == "machine_translation" else name
    c = book.CHAPTERS[chapter]()
    B = c.main.global_block().var(c.feed_names[0]).shape[0]
    return next(book.batches(chapter, B))


def _setup(name):
    """Both packages' programs from the JAX startup's persistables: ((JAX
    executor, scope, program, targets), (the port's ...), feed names,
    feed)."""
    jm, jst, jprog, feed_names, jt = MODELS[name](jfluid)
    pm, _, pprog, _, pt = MODELS[name](fluid)
    jexe, jscope = _jax_exe(), jfluid.Scope()
    for st in (jst if isinstance(jst, list) else [jst]):
        jexe.run(st, scope=jscope)
    pscope = fluid.Scope()
    for prog in {id(jm): jm, id(jprog): jprog}.values():
        LS.carry(prog, jscope, pm if prog is jm else pprog, pscope)
    return ((jexe, jscope, jprog, jt),
            (fluid.Executor(fluid.CPUPlace()), pscope, pprog, pt),
            feed_names, _feed(name, feed_names))


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=what)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=FETCH_RTOL * scale,
                                       err_msg=what)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_inference_models_cross_packages_in_every_format(tmp_path, name):
    (jexe, jscope, jprog, jt), (pexe, pscope, pprog, pt), feed_names, \
        feed = _setup(name)
    # the saving package's own fetches: its test clone on the whole batch
    # (labels too, where the program still computes a loss); the loaded
    # model takes its feeds alone
    jwant = jexe.run(jprog.clone(for_test=True), feed=feed, fetch_list=jt,
                     scope=jscope)
    pwant = pexe.run(pprog.clone(for_test=True), feed=feed, fetch_list=pt,
                     scope=pscope)
    feed = {k: feed[k] for k in feed_names}
    _close(pwant, jwant, name + ": the two packages")
    for fmt, (model, params) in FORMATS.items():
        jd, pd = str(tmp_path / ("j_" + fmt)), str(tmp_path / ("p_" + fmt))
        with jfluid.scope_guard(jscope):
            jfluid.io.save_inference_model(
                jd, feed_names, jt, jexe, main_program=jprog,
                model_filename=model, params_filename=params)
        with fluid.scope_guard(pscope):
            fluid.io.save_inference_model(
                pd, feed_names, pt, pexe, main_program=pprog,
                model_filename=model, params_filename=params)
        with fluid.scope_guard(fluid.Scope()):
            prog, feeds, fetches = fluid.io.load_inference_model(
                jd, pexe, model_filename=model, params_filename=params)
            assert feeds == feed_names
            got = pexe.run(prog, feed=feed, fetch_list=fetches)
        _close(got, jwant, "%s %s: the port loads the JAX package's"
               % (name, fmt))
        with jfluid.scope_guard(jfluid.Scope()):
            prog, feeds, fetches = jfluid.io.load_inference_model(
                pd, jexe, model_filename=model, params_filename=params)
            assert feeds == feed_names
            got = jexe.run(prog, feed=feed, fetch_list=fetches)
        _close(got, pwant, "%s %s: the JAX package loads the port's"
               % (name, fmt))


# -- twins of test_inference_io.py and test_fault_tolerance.py ----------------

def _predictor_model():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 5], dtype="float32")
        pred = fluid.layers.fc(fluid.layers.fc(x, 7, act="relu"), 2)
    return main, startup, pred


def test_combined_proto_roundtrip_via_predictor_config(tmp_path):
    main, startup, pred = _predictor_model()
    exe, x = fluid.Executor(fluid.CPUPlace()), _x()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        (ref,) = exe.run(main, feed={"x": x}, fetch_list=[pred])
        fluid.io.save_inference_model(
            str(tmp_path), ["x"], [pred], exe, main_program=main,
            model_filename="__model__", params_filename="__params__")
    config = AnalysisConfig(str(tmp_path))
    config.set_prog_file("__model__")
    config.set_params_file("__params__")
    config.disable_gpu()
    assert (config.prog_file(), config.params_file()) == ("__model__",
                                                          "__params__")
    predictor = create_paddle_predictor(config)
    assert predictor.get_input_names() == ["x"]
    (out,) = predictor.run({"x": x})
    np.testing.assert_array_equal(out.data, ref)
    config.set_model(str(tmp_path / "elsewhere"))
    assert config.model_dir().endswith("elsewhere") and \
        config.params_file() is None


def test_save_combined_uninitialized_persistable_raises(tmp_path):
    main, _, pred = _predictor_model()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(RuntimeError, match="not initialized in the "
                                               "scope"):
            fluid.io.save_inference_model(
                str(tmp_path), ["x"], [pred], exe, main_program=main,
                model_filename="__model__", params_filename="__params__")


def test_save_separate_files_skips_uninitialized(tmp_path):
    main, _, pred = _predictor_model()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        fluid.io.save_inference_model(str(tmp_path), ["x"], [pred], exe,
                                      main_program=main,
                                      model_filename="__model__")
    assert sorted(os.listdir(tmp_path)) == ["__manifest__.json",
                                            "__model__"]
    with pytest.raises(FileNotFoundError, match="missing parameter"):
        fluid.io.load_inference_model(str(tmp_path), exe)


def test_a_lone_model_file_is_read_in_the_protobuf_format(tmp_path):
    main, startup, pred = _predictor_model()
    exe, x = fluid.Executor(fluid.CPUPlace()), _x()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        (ref,) = exe.run(main, feed={"x": x}, fetch_list=[pred])
        fluid.io.save_inference_model(str(tmp_path), ["x"], [pred], exe,
                                      main_program=main,
                                      model_filename="__model__")
    with fluid.scope_guard(fluid.Scope()):
        prog, _, fetches = fluid.io.load_inference_model(str(tmp_path), exe)
        (out,) = exe.run(prog, feed={"x": x}, fetch_list=fetches)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("fmt", ["json", "proto_separate"])
def test_bfloat16_persistables_cross_as_bits(tmp_path, fmt):
    """A bfloat16 parameter goes to disk as its 16-bit words and comes
    back as the same ``torch.bfloat16`` bits; the JAX package reads the
    protobuf stream as ``ml_dtypes.bfloat16``."""
    model, params = FORMATS[fmt]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[2, 3], dtype="float32")
        out = fluid.layers.fc(x, 2, param_attr=fluid.ParamAttr(name="w"),
                              bias_attr=False)
    exe = fluid.Executor(fluid.CPUPlace())
    w = torch.tensor([[1.5, -2.25], [3.0, 1e-3], [7.0, 0.1]]).bfloat16()
    with fluid.scope_guard(fluid.Scope()):
        fluid.global_scope().var("w").set(fluid.LoDTensor(w))
        main.global_block().var("w").dtype = "bfloat16"
        fluid.io.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                      main_program=main,
                                      model_filename=model,
                                      params_filename=params)
    with fluid.scope_guard(fluid.Scope()):
        fluid.io.load_inference_model(str(tmp_path), exe,
                                      model_filename=model)
        got = fluid.global_scope().find_var("w").get_tensor().array
    assert got.dtype == torch.bfloat16 and torch.equal(
        got.view(torch.int16), w.view(torch.int16))
    if fmt == "proto_separate":
        with jfluid.scope_guard(jfluid.Scope()):
            jfluid.io.load_inference_model(str(tmp_path),
                                           jfluid.Executor(
                                               jfluid.CPUPlace()))
            jw = np.asarray(jfluid.global_scope().find_var("w")
                            .get_tensor()).astype("float32")
        np.testing.assert_array_equal(jw, w.float().numpy())


def test_save_persistables_manifest_roundtrip(tmp_path):
    main, startup, _, _ = _fc_model(fluid)
    exe, d = fluid.Executor(fluid.CPUPlace()), str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_persistables(exe, d, main)
        assert os.path.exists(os.path.join(d, "__manifest__.json"))
        fluid.io.load_persistables(exe, d, main)
        p = os.path.join(d, "__params__.npz")
        data = bytearray(open(p, "rb").read())
        data[30] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(fluid.io.CheckpointCorrupt, match="sha256"):
            fluid.io.load_persistables(exe, d, main)


def test_load_names_the_missing_file_and_dir(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(FileNotFoundError) as ei:
        fluid.io.load_persistables(exe, str(empty))
    assert "__params__.npz" in str(ei.value) and str(empty) in str(ei.value)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        fluid.io.load_inference_model(str(tmp_path / "nope"), exe)
    with pytest.raises(FileNotFoundError, match="__model__"):
        fluid.io.load_inference_model(str(empty), exe)


# -- the save / load ops (test_tail_ops.py) ----------------------------------

def _run_op(op_type, ins, outs, attrs, feeds, fetch):
    prog = fluid.Program()
    blk = prog.global_block()
    for names in list(ins.values()) + list(outs.values()):
        for n in names:
            blk.create_var(name=n, dtype="float32")
    blk.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs,
                  infer_shape=False)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(prog, feed=feeds, scope=scope,
                                         fetch_list=list(fetch))
    return [scope.find_var(f).get_tensor().numpy() for f in fetch]


def test_save_load_ops_roundtrip(tmp_path):
    val = np.random.RandomState(4).randn(3, 2).astype("float32")
    p = str(tmp_path / "var")
    _run_op("save", {"X": ["v"]}, {}, {"file_path": p}, {"v": val}, [])
    (back,) = _run_op("load", {}, {"Out": ["w"]}, {"file_path": p}, {},
                      ["w"])
    np.testing.assert_array_equal(back, val)
    np.testing.assert_array_equal(np.load(p + ".npy"), val)
    pc = str(tmp_path / "combined")
    a, b = np.ones((2, 2), "float32"), np.full((3,), 2.0, "float32")
    _run_op("save_combine", {"X": ["a", "b"]}, {}, {"file_path": pc},
            {"a": a, "b": b}, [])
    a2, b2 = _run_op("load_combine", {}, {"Out": ["a", "b"]},
                     {"file_path": pc}, {}, ["a", "b"])
    np.testing.assert_array_equal(a2, a)
    np.testing.assert_array_equal(b2, b)
    # by position where the names differ; fp16 on request
    c2, d2 = _run_op("load_combine", {}, {"Out": ["c", "d"]},
                     {"file_path": pc, "load_as_fp16": True}, {},
                     ["c", "d"])
    assert c2.dtype == np.float16
    np.testing.assert_array_equal(d2, b.astype(np.float16))
    with pytest.raises(RuntimeError, match="do not match"):
        _run_op("load_combine", {}, {"Out": ["c"]}, {"file_path": pc}, {},
                ["c"])


def test_save_op_overwrite_guard_and_the_jax_op_reads_it(tmp_path):
    val = np.ones((2,), "float32")
    p = str(tmp_path / "guarded")
    _run_op("save", {"X": ["v1"]}, {}, {"file_path": p}, {"v1": val}, [])
    with pytest.raises(RuntimeError, match="overwrite=False"):
        _run_op("save", {"X": ["v2"]}, {},
                {"file_path": p, "overwrite": False}, {"v2": val}, [])
    import test_tail_ops as JT

    (back,) = JT._run_op("load", {}, {"Out": ["w"]}, {"file_path": p}, {},
                         ["w"])
    np.testing.assert_array_equal(back, val)
