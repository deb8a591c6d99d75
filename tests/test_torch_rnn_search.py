"""RNNsearch (``models/rnn_search.py``) through the port against the JAX
package, both variants (attention and ``no_attention``), at a narrow
width (dictionaries of 50, embeddings 8, encoder 8, decoder 16, batch 4,
lengths 2-6).

- The one script builds the JAX package's programs: the forward training
  program (before the optimizer) and the generator, op for op in every
  block.
- Training from the JAX startup's persistables (``carry``): at equal
  target lengths, step 1's loss and the decoder's grads agree with the
  JAX package's. The JAX package makes no grad for the encoder (its
  ``reorder_lod_tensor_by_rank`` has none) and raises on ragged targets
  (its ``static_input`` does not shrink); the port's encoder gets its
  grads, and three Adam steps over ragged targets lower the loss and move
  the source embedding and the encoder's ``fc``.
- Generation from the same weights: at beam 1, where no beam ends, the
  two packages' ids and both LoD levels are equal and the scores agree;
  at beam 3 the JAX
  package raises from its second trip on (its ``beam_search`` reads a
  two-level LoD's level 0 as rows, ``tests/test_torch_beam_search_lod.py``)
  and the port's every step matches a numpy oracle of the search: the
  model's step in numpy over each live beam, attention over each
  source's own rows, the reference's selection rule.

Tolerances: losses, grads and scores within 1e-5 of each tensor's scale;
ids and LoDs exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import rnn_search as R

import test_torch_lr_schedule as LS  # noqa: E402
from test_torch_dynamic_rnn import Held, close  # noqa: E402

CFG = R.NARROW
VARIANTS = {"attention": True, "no_attention": False}
DECODER = ["out_w", "out_b", "dec_forget_h", "dec_forget_x", "dec_cell_b",
           "trg_emb"]
ENCODER = ["src_emb", "fwd_proj_w", "bwd_lstm_w", "boot_w"]


def block_ops(program):
    def attrs(op):
        a = {k: (v.idx if hasattr(v, "ops") else v)
             for k, v in op.attrs.items()}
        if op.type == "cast" and a.get("in_dtype") == 2:
            a["in_dtype"] = 3  # int64 reads int32 in the JAX package
        return a

    return [[(op.type, op.inputs, op.outputs, attrs(op)) for op in b.ops]
            for b in program.blocks]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_the_script_builds_the_jax_packages_programs(variant):
    """The generator op for op; the training program's global block op
    for op, and its step block too but for the port's shrink of each
    static input (repair 1 of ``test_torch_dynamic_rnn.py``), one
    ``shrink_rnn_memory`` over a ``drnn_static`` var each."""
    att = VARIANTS[variant]
    gen = [block_ops(R.generate_program(pkg, CFG, att)[0])
           for pkg in (fluid, jfluid)]
    assert gen[0] == gen[1]
    (p_main, p_step), (j_main, j_step) = [
        block_ops(R.train_program(pkg, CFG, att, optimizer=False)[0])
        for pkg in (fluid, jfluid)]
    assert p_main == j_main
    static = [op for op in p_step if op[0] == "shrink_rnn_memory"
              and op[1]["X"][0].startswith("drnn_static")]
    assert len(static) == (2 if att else 1)
    assert [op[0] for op in p_step if op not in static] == \
        [op[0] for op in j_step]


def startup_state(variant, seed):
    """The JAX startup's persistables of the training program."""
    jmain, jstart, _ = R.train_program(jfluid, CFG, VARIANTS[variant])
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe._core.rng.seed = seed
    scope = jfluid.Scope()
    exe.run(jstart, scope=scope)
    return jmain, scope


def train_run(pkg, variant, jmain, jscope, feeds, fetch):
    main, startup, loss = R.train_program(pkg, CFG, VARIANTS[variant])
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is jfluid:
        scope = jscope
    else:
        # the port's own startup first: Adam's state of the encoder,
        # which the JAX program does not update, has no JAX value
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        LS.carry(jmain, jscope, main, scope)
    runs = [[Held(h) for h in exe.run(main, feed=f(pkg),
                                       fetch_list=[loss] + fetch,
                                       scope=scope, return_numpy=False)]
            for f in feeds]
    return runs, scope


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_one_matches_the_jax_package_at_equal_target_lengths(variant):
    jmain, jscope = startup_state(variant, 41)

    def feed(pkg):
        return R.train_batch(pkg, np.random.RandomState(42), CFG,
                             trg_lengths=[4] * CFG["batch"])

    names = [n + "@GRAD" for n in DECODER]
    if variant == "attention":
        names += ["att_w@GRAD", "att_state_w@GRAD"]
    (p,), _ = train_run(fluid, variant, jmain, jscope, [feed],
                        names + [n + "@GRAD" for n in ENCODER])
    (j,), _ = train_run(jfluid, variant, jmain, jscope, [feed], names)
    for name, a, b in zip(["loss"] + names, p, j):
        close(a.array, b.array, name)
    for name, g in zip(ENCODER, p[len(names) + 1:]):
        assert np.abs(g.array).max() > 0, name
    assert not any(n + "@GRAD" in jmain.global_block().vars
                   for n in ENCODER), "the JAX package makes encoder grads"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ragged_targets_train_the_encoder_in_the_port(variant):
    """Ragged targets (lengths 2-6, one batch three times): the JAX
    package raises in the ``while``; the port's loss falls and the source
    embedding and the encoder's fc move."""
    jmain, jscope = startup_state(variant, 43)

    def feed(pkg):
        return R.train_batch(pkg, np.random.RandomState(44), CFG)

    assert len(set(feed(fluid)["trg"].recursive_sequence_lengths()[0])) > 1
    with pytest.raises(Exception, match="concat|shape|broadcast"):
        train_run(jfluid, variant, jmain, jscope, [feed], [])
    before = {n: np.asarray(jscope.find_var(n).get_tensor()).copy()
              for n in ENCODER}
    runs, scope = train_run(fluid, variant, jmain, jscope, [feed] * 3, [])
    losses = [float(r[0].array.reshape(-1)[0]) for r in runs]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for n in ENCODER:
        moved = np.abs(scope.find_var(n).get_tensor().numpy()
                       - before[n]).max()
        assert moved > 0, n


def trained_weights(variant):
    """The JAX startup's persistables, one shared state for generation."""
    jmain, jscope = startup_state(variant, 45)
    return {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
            for v in jmain.global_block().vars.values()
            if v.persistable and jscope.find_var(v.name) is not None
            and jscope.find_var(v.name).is_initialized()}


def generate(pkg, cfg, variant, weights, extra=()):
    main, _, ids, scores = R.generate_program(pkg, cfg, VARIANTS[variant])
    scope = pkg.Scope()
    if pkg is fluid:
        fluid.io.scope_from_numpy(scope, weights, fluid.CPUPlace())
    else:
        for k, v in weights.items():
            scope.var(k).get_tensor().set(v)
    feed = R.source_batch(pkg, np.random.RandomState(46), cfg)
    out = pkg.Executor(pkg.CPUPlace()).run(
        main, feed=feed, fetch_list=[ids, scores] + list(extra), scope=scope,
        return_numpy=False)
    return out, main, scope


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam_one_generation_matches_the_jax_package(variant):
    """Beam 1 with an end id no step can select (the dictionary's size):
    no beam ends and no source is dropped, so every step's LoD holds one
    row a prefix, where the two packages' ``beam_search`` rules agree
    (once a source is dropped, the JAX package's indexes past its rows);
    ``max_len`` trips."""
    weights = trained_weights(variant)
    cfg = dict(CFG, beam=1, end=CFG["trg_dict"])
    (pi, ps), _, _ = generate(fluid, cfg, variant, weights)
    (ji, js), _, _ = generate(jfluid, cfg, variant, weights)
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ji))
    assert pi.lod() == ji.lod()
    assert len(pi.lod()) == 2 and pi.lod()[0] == list(range(CFG["batch"]
                                                              + 1))
    close(np.asarray(ps), np.asarray(js), "scores")


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def search_oracle(w, enc, proj, boot, src_lod, cfg, attention):
    """Each step's (ids, scores, LoD) of the beam search, in numpy: the
    model's step for every live beam over its own source's rows, then the
    reference's selection (top ``beam`` a source by score, ties to the
    lower row; an ended beam offers its end id and score; a source whose
    best items and beams all ended is dropped)."""
    K, end = cfg["beam"], cfg["end"]
    srcs = [(enc[a:b], proj[a:b]) for a, b in zip(src_lod[:-1],
                                                  src_lod[1:])]
    last = [e[-1] for e, _ in srcs]
    rows = [dict(src=i, h=boot[i], c=np.zeros_like(boot[i]),
                 id=cfg["start"], score=0.0) for i in range(len(srcs))]
    steps = []
    for _ in range(cfg["max_len"]):
        for r in rows:
            e, p = srcs[r["src"]]
            if attention:
                s = (p + r["h"] @ w["att_state_w"]) @ w["att_w"][:, 0]
                ctx = softmax(s) @ e
            else:
                ctx = last[r["src"]]
            x = np.concatenate([ctx, w["trg_emb"][r["id"]]])

            def gate(name):
                return (r["h"] @ w[name + "_h"] + x @ w[name + "_x"]
                        + w[name + "_b"])

            c = (sigmoid(gate("dec_forget")) * r["c"]
                 + sigmoid(gate("dec_input")) * np.tanh(gate("dec_cell")))
            h = sigmoid(gate("dec_output")) * np.tanh(c)
            probs = softmax(h @ w["out_w"] + w["out_b"])
            top = np.argsort(-probs, kind="stable")[:K]
            r.update(next_h=h, next_c=c,
                     cands=[(r["score"] + np.log(probs[k]), int(k))
                            for k in top])
        chosen = []
        for s in range(len(srcs)):
            items = []
            for ri, r in enumerate(rows):
                if r["src"] != s:
                    continue
                if r["id"] == end:
                    items.append((r["score"], ri, end))
                else:
                    items += [(sc, ri, tok) for sc, tok in r["cands"]]
            best = sorted(items, key=lambda it: (-it[0], it[1]))[:K]
            if not all(tok == end and rows[ri]["id"] == end
                       for _, ri, tok in best):
                chosen += best
        chosen.sort(key=lambda it: it[1])
        per_src = [0] + list(np.cumsum([sum(1 for r in rows if r["src"] == s)
                                        for s in range(len(srcs))]))
        low = [0]
        for ri in range(len(rows)):
            low.append(low[-1] + sum(1 for it in chosen if it[1] == ri))
        steps.append((np.array([it[2] for it in chosen]),
                      np.array([it[0] for it in chosen]),
                      [per_src, low]))
        rows = [dict(src=rows[ri]["src"], h=rows[ri]["next_h"],
                     c=rows[ri]["next_c"], id=tok, score=sc)
                for sc, ri, tok in chosen]
        if not rows:
            break
    return steps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam_three_generation_matches_the_search_oracle(variant):
    """The end id's output bias raised by 1.5, so that beams end and
    sources are dropped within ``max_len`` trips (random weights over 50
    words rarely end)."""
    weights = trained_weights(variant)
    weights["out_b"] = weights["out_b"].copy()
    weights["out_b"][..., CFG["end"]] += 1.5
    attention = VARIANTS[variant]
    with pytest.raises(Exception, match="concat|shape|broadcast|index"):
        generate(jfluid, CFG, variant, weights)
    main = R.generate_program(fluid, CFG, attention)[0]
    blk = main.global_block()
    (dec,) = [op for op in blk.ops if op.type == "beam_search_decode"]
    (boot,) = [op.input("X")[0] for op in blk.ops
               if op.type == "fill_zeros_like"]
    encoded = [op for op in blk.ops if op.type == "concat"][0] \
        .output("Out")[0]
    proj = [op for op in blk.ops if op.type == "mul"
            and op.input("Y") == ["enc_proj_w"]][0].output("Out")[0]
    extra = [dec.input("Ids")[0], dec.input("Scores")[0], encoded, proj,
             boot]
    out, _, scope = generate(fluid, CFG, variant, weights, extra)
    ids_arr, scores_arr = out[2], out[3]
    w = {n: scope.find_var(n).get_tensor().numpy() for n in weights
         if scope.find_var(n) is not None}
    want = search_oracle(w, np.asarray(out[4]), np.asarray(out[5]),
                         np.asarray(out[6]), out[4].lod()[0], CFG,
                         attention)
    got = list(zip(ids_arr, scores_arr))[1:]  # entry 0: the start ids
    assert len(got) == len(want) >= 2
    ended = 0
    for t, ((gi, gs), (wi, ws, wlod)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(gi).reshape(-1), wi,
                                      err_msg="step %d" % t)
        assert gi.lod() == wlod, t
        close(np.asarray(gs).reshape(-1), ws, "scores, step %d" % t)
        ended += int((wi == CFG["end"]).sum())
    assert ended > 0, "no beam ended: the ended-beam path never ran"
    sent = out[0]
    assert len(sent.lod()) == 2 and sent.lod()[0][-1] == len(
        sent.lod()[1]) - 1
