"""bench.py's four training scripts under mixed precision (``mp.decorate``,
bfloat16, bench.py's default), the port against the JAX package.

Narrow versions of gpt_long (Adam), Transformer-base WMT with lengths and
BERT MLM (Adam), and ResNet-50 NHWC at 64², batch 4 (Momentum, lr 1e-3,
every viable conv routed to K5's plain version) are built by the float32
tests' own ``build*`` functions with ``use_bf16=True``. The JAX package runs its
startup and three steps; the port runs each step from the JAX package's
state before it (``io.scope_from_numpy``), so every step is compared
alone.

What is compared, and why so. The JAX package runs in a child process
whose XLA rounds each op's result to its type
(``--xla_allow_excess_precision=false``): by default XLA on the CPU
keeps the intermediates of a fused bfloat16 chain in float32, which the
program does not say, and which hides a gray-list op forced to float32.
So rounded, the two packages differ only where they sum a product's
terms in another order and land one bfloat16 ulp apart. Per step:

- the loss, relative to the JAX package's;
- for every persistable the JAX step changes (the float32 masters,
  Adam's moments, the velocities, batch norm's running stats), the
  relative L2 of the port's change against the JAX package's. Parameters
  whose grad is zero by symmetry (``symmetric``) are left out.
- ResNet-50 (Momentum) also: each master's update against the port's own
  velocity, ``p_new = p - lr * v_new`` to float32 rounding, relative to
  the update's largest magnitude: the masters are updated in float32.

The limits, from the readings this file prints when run as a script
(``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_amp_training.py``), and the two planted faults: one
gray-list op forced to float32 (``elementwise_add`` taken off the port's
gray list) and one parameter's cast dropped (the parameter itself runs
in bfloat16, so its grad and its update are bfloat16, with no float32
master).

- gpt_long, WMT, BERT: losses 0 to 2.3e-6 (gpt), 2.1e-5 (WMT), 1.0e-7
  (BERT) relative; changes at most 0.35 (one sign flip of Adam's step-1
  move in a 32-element bias: 2 / sqrt(32)), mostly below 0.02. Limits:
  loss 1e-5 (WMT 1e-4), changes 0.75. The gray-list fault moves the
  losses by 4.4e-5 (gpt), 3.9e-4 (WMT), 3.1e-4 (BERT); the dropped cast
  scores 2.25-5.6 on its parameter's change.
- ResNet-50 at batch 4 is chaotic under bfloat16: a one-ulp difference
  in the first conv grows about 1.4x a layer through batch norm over
  16-64 values a channel, so the forward ends 0.8-6.1% apart and the
  conv filters' changes read 0.5-0.9 (uncorrelated changes read 1).
  Limits: loss 0.15, changes 2.0 (a change of the wrong sign or 3x too
  large). The master update reads 0.0016-0.0024 (float32 rounding of a
  parameter near 1 beside a move near 1e-5): limit 0.01; the dropped
  cast scores 0.080-0.106 there. The gray-list fault touches only the fc
  bias add here and stays below every limit: the rewrite-parity tests of
  ``test_torch_amp.py`` catch both faults as program differences, for
  every script.
"""
import functools
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib.mixed_precision import fp16_lists, fp16_utils
from paddle_tpu_torch.core.tensor import LoDTensor
from paddle_tpu_torch.models.resnet import random_batch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_resnet_training as RT  # noqa: E402
import test_torch_training as GT  # noqa: E402
import test_torch_transformer_training as TT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
SCRIPTS = ["gpt", "wmt_lengths", "bert", "resnet50_nhwc"]
KNOB = "PADDLE_TPU_FUSED_OPTIMIZER"
N_SYMMETRIC = {"gpt": 2, "wmt_lengths": 6, "bert": 2, "resnet50_nhwc": 0}
# set from the readings (see the module docstring and PERF.md)
LOSS_RTOL = {"gpt": 1e-5, "wmt_lengths": 1e-4, "bert": 1e-5,
             "resnet50_nhwc": 0.15}
UPDATE_RELL2 = {"gpt": 0.75, "wmt_lengths": 0.75, "bert": 0.75,
                "resnet50_nhwc": 2.0}
MASTER_RTOL = 1e-2
# the faults the numbers resolve, by script (see the docstring)
FAULT_SCRIPTS = ["gpt", "wmt_lengths", "bert"]


def build(pkg, script):
    if script == "gpt":
        return GT.build_gpt(pkg, use_bf16=True)
    if script == "resnet50_nhwc":
        return RT.build(pkg, RT.CONFIGS[script], use_bf16=True)
    return TT.build(pkg, script, use_bf16=True)


def feeds(script):
    if script == "gpt":
        return GT.batches(STEPS)
    if script == "resnet50_nhwc":
        cfg = RT.CONFIGS[script]
        rng = np.random.RandomState(0)
        return [random_batch(rng, RT.BATCH, cfg["image_size"], RT.CLASSES,
                             cfg["data_format"]) for _ in range(STEPS)]
    return TT.feeds(script)


def state(main, scope):
    """Every initialised persistable as float32 numpy."""
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is None or not var.is_initialized():
            continue
        t = var.get_tensor()
        arr = getattr(t, "array", None)
        if isinstance(arr, torch.Tensor):
            out[v.name] = arr.detach().float().cpu().numpy()
        else:
            out[v.name] = np.array(t, dtype=np.float32)
    return out


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_steps(script):
    """The JAX startup and three steps (fused optimizer off): the state
    before and after each step, each step's loss and the step-1 grads."""
    main, startup, loss = build(jfluid, script)[:3]
    grad_names = [p.name + "@GRAD" for p in main.all_parameters()
                  if p.trainable]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        states, losses, grads = [state(main, scope)], [], None
        for i, feed in enumerate(feeds(script)):
            res = exe.run(main, feed=feed, fetch_list=[loss] + grad_names)
            losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
            if i == 0:
                grads = {n: np.asarray(g, np.float32)
                         for n, g in zip(grad_names, res[1:])}
            states.append(state(main, scope))
    return states, losses, grads


@functools.lru_cache(maxsize=None)
def _jax_run(script):
    """``_jax_steps`` in a child process whose XLA rounds every op's
    result to its type (``--xla_allow_excess_precision=false``): by
    default XLA on the CPU keeps the intermediates of a fused bfloat16
    chain in float32, which no per-op program states, and which hides a
    gray op forced to float32 in the port."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop(KNOB, None)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run.pkl")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-steps", script, out], env=env, check=True,
                       cwd=REPO, timeout=600)
        with open(out, "rb") as f:
            return pickle.load(f)


def _port_run(script):
    """The port's three steps, each from the JAX package's state before
    it (a persistable the program declares bfloat16, as the dropped-cast
    fault makes one, is loaded as bfloat16). Returns each step's loss and
    the state after each step."""
    jstates = _jax_run(script)[0]
    main, _, loss = build(fluid, script)[:3]
    low = [v.name for v in main.global_block().vars.values()
           if v.persistable and v.dtype == "bfloat16"]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    losses, states = [], []
    for i, feed in enumerate(feeds(script)):
        fluid.io.scope_from_numpy(scope, jstates[i], fluid.CPUPlace())
        for name in low:
            t = scope.find_var(name).get_tensor().array
            scope.var(name).set(LoDTensor(t.to(torch.bfloat16)))
        (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                         return_numpy=False)
        losses.append(float(out.array.float().reshape(-1)[0]))
        states.append(state(main, scope))
    return losses, states


def symmetric(script):
    """Parameters whose grad is zero by symmetry and float noise on both
    sides (the key projections' biases shift every score of a row alike,
    which softmax ignores): the largest of their step-1 grads is below
    1e-3, every other's above 2e-3. Adam moves each element of them by up
    to lr either way, so their changes are not compared."""
    grads = _jax_run(script)[2]
    return {n[:-len("@GRAD")] for n, g in grads.items()
            if np.abs(g).max() < 1e-3}


def master_update(script, before, after):
    """ResNet's Momentum masters: the largest ``|p_new - (p - lr *
    v_new)|`` over the update's largest magnitude (0 for Adam)."""
    if script != "resnet50_nhwc":
        return 0.0
    worst = 0.0
    for name in after:
        v = after.get(name + "_velocity_0")
        if v is None:
            continue
        want = before[name].astype(np.float64) - RT.LR * v
        step = max(float(np.abs(RT.LR * v).max()), 1e-30)
        worst = max(worst, float(np.abs(after[name] - want).max()) / step)
    return worst


def readings(script, run):
    """Per step: the loss's relative difference, the largest relative L2
    over every persistable the JAX step changes (but the symmetric
    parameters' and their accumulators') of the port's change against the
    JAX package's, and ``master_update``."""
    jstates, jlosses, _ = _jax_run(script)
    sym = symmetric(script)
    plosses, pstates = run
    out = []
    for i in range(STEPS):
        before, want, got = jstates[i], jstates[i + 1], pstates[i]
        worst = 0.0
        for name, w in want.items():
            if np.array_equal(w, before[name]) or any(
                    name == p or name.startswith(p + "_") for p in sym):
                continue
            worst = max(worst, rel_l2(got[name] - before[name],
                                      w - before[name]))
        out.append((abs(plosses[i] - jlosses[i]) / abs(jlosses[i]), worst,
                    master_update(script, before, got)))
    return out


@pytest.fixture
def route_all():
    old = fluid.get_flags("FLAGS_use_pallas_conv")
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    yield
    fluid.set_flags(old)


@pytest.fixture
def no_fusion():
    old = os.environ.pop(KNOB, None)
    yield
    if old is not None:
        os.environ[KNOB] = old


@pytest.mark.parametrize("script", SCRIPTS)
def test_three_amp_steps_match_the_jax_package(no_fusion, route_all, script):
    run = _port_run(script)
    assert len(symmetric(script)) == N_SYMMETRIC[script]
    for loss_rel, update_rel, master_rel in readings(script, run):
        assert loss_rel <= LOSS_RTOL[script], (script, loss_rel)
        assert update_rel <= UPDATE_RELL2[script], (script, update_rel)
        assert master_rel <= MASTER_RTOL, (script, master_rel)
    assert np.isfinite(run[0]).all()


def _gray_op_forced_f32(monkeypatch):
    monkeypatch.setattr(fp16_lists, "gray_list",
                        fp16_lists.gray_list - {"elementwise_add"})


def _dropped_param_cast(monkeypatch):
    """The first parameter a cast would bring down to bfloat16 becomes
    bfloat16 itself: no cast op, its grad and optimizer state bfloat16."""
    plain = fp16_utils.insert_cast_op
    dropped = []

    def insert(block, new_ops, var, dest, cache):
        if not dropped and dest == "bfloat16" and \
                isinstance(var, fluid.framework.Parameter):
            dropped.append(var.name)
            var.dtype = dest
            return var.name
        return plain(block, new_ops, var, dest, cache)

    monkeypatch.setattr(fp16_utils, "insert_cast_op", insert)
    return dropped


FAULTS = {"gray_op_forced_f32": _gray_op_forced_f32,
          "param_cast_dropped": _dropped_param_cast}


def _fault_score(monkeypatch, script, fault):
    """The largest reading with ``fault`` planted, over its limit."""
    FAULTS[fault](monkeypatch)
    run = _port_run(script)
    monkeypatch.undo()
    return max(max(lr / LOSS_RTOL[script], ur / UPDATE_RELL2[script],
                   mr / MASTER_RTOL)
               for lr, ur, mr in readings(script, run))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("script", FAULT_SCRIPTS)
def test_a_planted_amp_fault_exceeds_the_limits(no_fusion, route_all,
                                                monkeypatch, script, fault):
    assert _fault_score(monkeypatch, script, fault) > 1.0


def test_resnet_dropped_cast_fails_the_master_update(no_fusion, route_all,
                                                     monkeypatch):
    assert _fault_score(monkeypatch, "resnet50_nhwc",
                        "param_cast_dropped") > 1.0


def _fmt(r):
    return "; ".join("%s %s" % (what, ["%.3g" % x[i] for x in r])
                     for i, what in enumerate(("loss rel", "change rel-L2",
                                               "master update")))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-steps"]:
        with open(sys.argv[3], "wb") as f:
            pickle.dump(_jax_steps(sys.argv[2]), f)
        sys.exit(0)
    os.environ.pop(KNOB, None)
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    scripts = sys.argv[1:] or SCRIPTS
    for script in scripts:
        print("%s: %s" % (script, _fmt(readings(script, _port_run(script)))))
    with pytest.MonkeyPatch.context() as mp:
        for script in scripts:
            for fault in sorted(FAULTS):
                FAULTS[fault](mp)
                r = readings(script, _port_run(script))
                mp.undo()
                print("%s planted %s: %s" % (script, fault, _fmt(r)))
