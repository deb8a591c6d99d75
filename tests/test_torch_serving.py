"""The serving slice end to end, the port against the JAX package.

A small version of the BERT encoder (2 layers, 2 heads, d_model 32, d_ff
64, vocab 101, T 16) with ``src_lengths``, so self-attention runs the
``flash_attention`` op:

(a) saved by the JAX package, loaded by the port's predictor on the CPU
    and served by the port's ServingEngine: the same answers as the JAX
    ServingEngine on the same ragged requests;
(b) the port's ``transformer_encoder`` emits the JAX one's ops, slots,
    attrs and parameter names;
(c) JAX startup parameters carried by ``scope_from_numpy`` give the port's
    Executor the JAX Executor's fetch;
(d) a model saved by the port loads and predicts the same in paddle_tpu.

Tolerance 1e-4 (float32; both predictors fuse mul + add into fc, and XLA
sums in another order).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.inference as jinf
import paddle_tpu.serving as jserving
import paddle_tpu_torch as fluid
import paddle_tpu_torch.inference as pinf
import paddle_tpu_torch.serving as pserving
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.models import transformer as ptransformer

T, VOCAB, MAX_LEN = 16, 101, 64
SMALL = dict(num_layers=2, num_heads=2, d_model=32, d_ff=64)
FEEDS = ["src_ids", "pos_ids", "lengths"]
TOL = 1e-4


def _build(pkg, transformer, seed=0):
    """(main, startup, encoder output) built by ``pkg`` under fresh
    names; the startup seed fixes the init ops' streams."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src_ids", shape=[-1, T], dtype="int64")
        pos = pkg.data(name="pos_ids", shape=[-1, T], dtype="int64")
        lens = pkg.data(name="lengths", shape=[-1], dtype="int32")
        enc = transformer.transformer_encoder(
            src, pos, VOCAB, max_len=MAX_LEN, is_test=True,
            src_lengths=lens, **SMALL)
    return main, startup, enc


def _requests(seed, n=12):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        rows = 1 + i % 4
        lens = rng.randint(0, T + 1, rows).astype("int32")
        lens[0] = [0, T, 1][i % 3]
        reqs.append({
            "src_ids": rng.randint(0, VOCAB, (rows, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T), (rows, 1)).astype("int64"),
            "lengths": lens})
    return reqs


def _serve(engine_mod, pred, reqs):
    engine = engine_mod.ServingEngine(
        pred, engine_mod.ServingConfig(max_batch_size=4, num_workers=2))
    engine.start()
    try:
        futures = [engine.submit(r) for r in reqs]
        return [next(iter(f.result(timeout=120).values()))
                for f in futures], engine.stats()
    finally:
        engine.stop()


def _save_jax(dirname):
    main, startup, enc = _build(jfluid, jtransformer)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(dirname, FEEDS, [enc], exe,
                                       main_program=main)


def _port_predictor(dirname):
    cfg = pinf.AnalysisConfig(dirname)
    cfg.disable_gpu()
    return pinf.create_paddle_predictor(cfg)


def test_port_serves_a_jax_saved_model(tmp_path):
    _save_jax(str(tmp_path))
    reqs = _requests(seed=1)
    jpred = jinf.create_paddle_predictor(jinf.AnalysisConfig(str(tmp_path)))
    want, _ = _serve(jserving, jpred, reqs)
    ppred = _port_predictor(str(tmp_path))
    assert ppred.device.type == "cpu"
    got, stats = _serve(pserving, ppred, reqs)
    for r, g, w in zip(reqs, got, want):
        assert g.shape == (r["src_ids"].shape[0], T, SMALL["d_model"])
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert stats["serving.requests"] == len(reqs)
    assert stats["serving.errors"] == 0
    assert tuple(stats["warmed_buckets"]) == (1, 2, 4)


def _op_list(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def test_encoder_emits_the_jax_program():
    jmain, jstartup, jenc = _build(jfluid, jtransformer)
    pmain, pstartup, penc = _build(fluid, ptransformer)
    assert _op_list(pmain) == _op_list(jmain)
    assert _op_list(pstartup) == _op_list(jstartup)
    assert penc.name == jenc.name and penc.shape == jenc.shape
    jparams = {p.name: (p.shape, p.dtype) for p in jmain.all_parameters()}
    pparams = {p.name: (p.shape, p.dtype) for p in pmain.all_parameters()}
    assert pparams == jparams
    assert {"embedding.w_0", "fc.w_0", "layer_norm.w_0"} <= set(pparams)
    jvars = {v.name: (v.shape, v.dtype) for v in jmain.list_vars()}
    pvars = {v.name: (v.shape, v.dtype) for v in pmain.list_vars()}
    # every var's inferred shape agrees (-1 batch included)
    assert {n: s for n, (s, _) in pvars.items()} == \
        {n: s for n, (s, _) in jvars.items()}
    assert {t for t, *_ in _op_list(pmain)} == {
        "lookup_table", "elementwise_add", "layer_norm", "mul", "reshape2",
        "transpose2", "gelu", "flash_attention"}


def test_jax_parameters_carried_by_scope_from_numpy():
    jmain, jstartup, jenc = _build(jfluid, jtransformer)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    feed = {k: np.concatenate([r[k] for r in _requests(seed=2, n=3)])
            for k in FEEDS}
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        (want,) = jexe.run(jmain, feed=feed, fetch_list=[jenc])
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}

    pmain, _, penc = _build(fluid, ptransformer)
    pscope = fluid.Scope()
    fluid.io.scope_from_numpy(pscope, params, fluid.CPUPlace())
    pexe = fluid.Executor(fluid.CPUPlace())
    (got,) = pexe.run(pmain, feed=feed, fetch_list=[penc], scope=pscope)
    assert got.shape == (feed["src_ids"].shape[0], T, SMALL["d_model"])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # parameters and the fetch stay, intermediates are freed after last
    # use, and the feeds are never written (as in the JAX package's route)
    assert set(pscope.local_var_names()) == set(params) | {penc.name}


def test_port_saved_model_loads_in_paddle_tpu(tmp_path):
    main, startup, enc = _build(fluid, ptransformer, seed=5)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fetch = fluid.io.save_inference_model(str(tmp_path), FEEDS, [enc],
                                              exe, main_program=main)
    assert fetch == [enc.name]
    ppred = _port_predictor(str(tmp_path))
    jpred = jinf.create_paddle_predictor(jinf.AnalysisConfig(str(tmp_path)))
    assert jpred.get_input_names() == ppred.get_input_names() == FEEDS
    for feed in _requests(seed=3, n=4):
        (got,) = ppred.run(feed)
        (want,) = jpred.run(feed)
        assert got.name == want.name == enc.name
        np.testing.assert_allclose(got.data, want.data, rtol=TOL, atol=TOL)


def test_port_load_verifies_the_manifest(tmp_path):
    _save_jax(str(tmp_path))
    params = tmp_path / "__params__.npz"
    params.write_bytes(params.read_bytes()[:-8] + b"\0" * 8)
    with pytest.raises(fluid.io.CheckpointCorrupt, match="sha256"):
        _port_predictor(str(tmp_path))
