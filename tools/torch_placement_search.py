"""Write a model's placement plan: search its parallelism space against a
saved profile report and save the winner as a ``PADDLE_TPU_PLACEMENT_PLAN``
artifact.

The twin of ``tools/placement_search.py`` over the port. The search runs
nothing: every candidate is rewritten on a fresh program and gated through
``verify_program``, ``check_collective_schedule`` and ``check_cross_rank``
before the cost model fitted to the report scores it. ``--audit`` writes
every candidate with its status, predicted step time and the provenance of
its price (fitted | analytic).

Usage:
  python tools/torch_placement_search.py --model gpt_long \\
      --report profile.json --out plan.json [--devices 2] [--beam 4]
      [--seed 0] [--audit audit.json] [--no-quant]

``--report``: a ``profile_step`` dict or a record wrapping one under
``profile`` (take one with ``observability.profiler.profile_step`` of a
data-parallel step on the card); without it the search runs on the
analytic model and says so in every provenance tag. The models are
bench.py's: ``mlp`` (the MNIST MLP at batch 512, Adam), ``gpt_long``,
``bert_base`` (float32, one sequence of 4096 / 128 tokens a replica) and
``resnet50`` (16 images of 96² a replica).

Run the plan: ``PADDLE_TPU_PLACEMENT_PLAN=plan.json`` in the environment
of the data-parallel job.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def builder(model: str, devices: int):
    """``() -> (main, loss name)``: a fresh training program of ``model``
    at its per-replica batch each call."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import gpt, transformer

    def build_mlp():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data(name="x", shape=[512, 784], dtype="float32")
            label = fluid.data(name="label", shape=[512, 1], dtype="int64")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(
                models.mlp(x), label))
            fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
        return main, loss.name

    def build_gpt():
        cfg = dict(gpt.GPT_LONG, batch=max(1, gpt.GPT_LONG["batch"]
                                           // devices))
        main, _, loss, _ = gpt.build_gpt_long(use_bf16=False, **cfg)
        return main, loss.name

    def build_bert():
        main, _, loss, _ = transformer.build_bert_base(
            max(1, 8 // devices), 128, use_bf16=False)
        return main, loss.name

    def build_resnet():
        from paddle_tpu_torch.models import resnet

        main, _, loss = resnet.build_resnet_train(16, image_size=96)
        return main, loss.name

    builders = {"mlp": build_mlp, "gpt_long": build_gpt,
                "bert_base": build_bert, "resnet50": build_resnet}
    if model not in builders:
        raise SystemExit("torch_placement_search: unknown model %r (have: "
                         "%s)" % (model, ", ".join(sorted(builders))))
    return builders[model]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="gpt_long",
                    help="mlp | gpt_long | bert_base | resnet50")
    ap.add_argument("--report", default=None,
                    help="saved profile report; none: the analytic model")
    ap.add_argument("--out", required=True, help="the plan's path")
    ap.add_argument("--audit", default=None,
                    help="also write every candidate's row here")
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-quant", action="store_true",
                    help="leave out the compressed-payload candidates")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.observability import steering
    from paddle_tpu_torch.placement import save_plan

    report = None
    if args.report:
        report = steering.load_report(args.report)
        if report is None:
            raise SystemExit(
                "torch_placement_search: %r is not a usable profile report "
                "(it needs per_bucket and backward_segments)" % args.report)
    plan, audit = steering.steer(
        "placement", report, builder=builder(args.model, args.devices),
        n_devices=args.devices, beam_width=args.beam, seed=args.seed,
        model=args.model, include_quant=not args.no_quant)
    if args.audit:
        with open(args.audit, "w") as f:
            json.dump(audit, f, indent=2, sort_keys=True)
            f.write("\n")
    print("torch_placement_search: %s: %d candidate(s) (%d verified, %d "
          "rejected, %d deduplicated, %d pruned, %d unsupported mesh(es)); "
          "cost model: %s"
          % (args.model, audit["enumerated"], audit["verified"],
             audit["rejected"], audit["deduped"], audit["pruned"],
             len(audit["unsupported"]), audit["cost_provenance"]))
    if plan is None:
        print("torch_placement_search: no candidate passed the gate; no "
              "plan written", file=sys.stderr)
        return 1
    digest = save_plan(plan, args.out)
    w = audit["winner"]
    print("torch_placement_search: winner mesh=%s sharded_update=%s "
          "bucket=%s strategy=%s quant=%s ef=%s async=%s"
          % (w["mesh"], w["sharded_update"], w["bucket"], w["strategy"],
             w["quant"]["mode"], w["quant"]["error_feedback"],
             w["async_collectives"]))
    print("torch_placement_search: predicted step %.3f ms (%s); plan %s -> "
          "%s" % (plan.predicted_step_ms or 0.0, plan.cost_provenance,
                  digest[:12], args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
