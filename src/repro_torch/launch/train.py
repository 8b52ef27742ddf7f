"""Training launcher CLI (port of `repro.launch.train` at pp = 1, tp = 1).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
      --seq 2048 --batch 4 --steps 20 --comm-precision fp8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 --dtype float32 --comm-precision fp8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 --bucket-mode auto_dp --comm-precision auto \\
      --remat auto:0.5
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --metrics-jsonl m.jsonl --profile-out p.json \\
      --replan-threshold 0 --replan-patience 2 --replan-apply
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3_moe_30b_a3b --smoke --device cpu --steps 3 \\
      --dtype float32 --seq 16 --batch 4

`--arch` takes every id of `models.registry.PORTED`: the dense family
(llama3_8b, qwen3_1_7b, deepseek_coder_33b, phi3_medium_14b), the moe
family (qwen3_moe_30b_a3b, qwen2_moe_a2_7b; each step logs the router's
load-balance term apart as `moe_aux`), zamba2_1_2b, xlstm_1_3b,
seamless_m4t_large_v2 and internvl2_26b (the vlm family: its batches carry
seeded image embeddings, and `--seq` counts the n_img_tokens image
positions ahead of the text):

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_1_3b \
      --smoke --device cpu --steps 3 --dtype float32 --seq 40 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2_26b \
      --smoke --device cpu --steps 3 --dtype float32 --seq 40 --batch 2

Runs on the card unless `--device cpu` is given.  At world size 1 it
creates its own one-rank process group on an in-process store (no
network); a multi-rank run initialises `torch.distributed` itself (one
process per card, `--mesh D,1`) before calling `main`.  The default
schedule is the reference's: the bucket+reorder prefetch stack;
`--no-reorder` runs the vanilla bucketed schedule.  `--bucket-mode
auto|auto_dp` runs the bucket planners, `--comm-precision auto` picks a
wire precision per bucket, and `--remat auto:<GB>` lets the memory plan
choose the remat policy under a per-device budget; the printed plan shows
the choices (`comm=auto(...)`, `mem[...]`).  `--metrics-jsonl` appends the
metrics registry every step; `--replan-threshold` arms profile-guided
replanning (`--replan-apply` restarts onto the new plan); after the run
the launcher prints the drift report and the last replan, and writes the
measured profile (`--profile-out`) and a Chrome trace of the plan
(`--trace-out`, or `<profile-out>.trace.json` with the measured overlay).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.core.dist import COMM_PRECISIONS

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1,1",
                    help="'data,model'; the model (tp) axis must be 1")
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--cp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--bucket-mode", default="block",
                    choices=("none", "block", "auto", "auto_dp"),
                    help="block: one bucket a layer; none: one a param; "
                         "auto: greedy Algorithm 1; auto_dp: the "
                         "exposure-minimizing DP (core/autowrap)")
    ap.add_argument("--comm-precision", default="bf16",
                    choices=COMM_PRECISIONS,
                    help="collective wire precision (kernels/quant): bf16 "
                         "off; *_ag quantize the param all-gathers; fp8 / "
                         "int8 also the grad reduce-scatter; *_ef add error "
                         "feedback; auto: the planner picks per bucket")
    ap.add_argument("--remat", default="fsdp_only",
                    help="none | fsdp_only | full | save_dots, a "
                         "per-segment vector (attn=full,mlp=fsdp_only), or "
                         "auto:<GB> (the memory plan picks under a "
                         "per-device budget in GiB)")
    ap.add_argument("--no-reorder", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="compute (param) dtype; storage and reduce are fp32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append a metrics-registry snapshot (step time, "
                         "tokens/s, wire bytes, drift gauges) here every "
                         "step (core/obs)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the executed "
                         "plan's modeled timeline here after the run "
                         "(core/obs.plan_trace)")
    ap.add_argument("--profile-out", default=None,
                    help="after the run, write the MeasuredProfile JSON "
                         "here (the last replan's, else a profile_step of "
                         "the executed plan) plus a modeled-vs-measured "
                         "overlay trace next to it "
                         "(<profile-out>.trace.json)")
    ap.add_argument("--replan-threshold", type=float, default=None,
                    help="arm profile-guided replanning: |rel| step-time "
                         "drift above this for --replan-patience "
                         "consecutive steps triggers profile_step + replan "
                         "(core/obs)")
    ap.add_argument("--replan-patience", type=int, default=3)
    ap.add_argument("--replan-apply", action="store_true",
                    help="restart the loop onto the replanned ParallelPlan "
                         "(default: log the delta only)")
    return ap.parse_args(argv)


def build_trainer(args):
    from repro_torch.core.dist import DistConfig
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.pp > 1 or args.cp > 1:
        raise NotImplementedError(
            f"--pp {args.pp} / --cp {args.cp}: pipeline and context "
            "parallelism are not yet ported to repro_torch")
    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    if len(mesh_shape) != 2:
        raise SystemExit(f"--mesh must be 'data,model', got {args.mesh!r}")
    dcfg = DistConfig(
        mesh_shape=mesh_shape, param_dtype=DTYPES[args.dtype],
        reduce_dtype=torch.float32, bucket_mode=args.bucket_mode,
        reorder=not args.no_reorder, remat=args.remat,
        comm_precision=args.comm_precision, microbatches=args.microbatches,
        grad_compression=args.grad_compression)
    _, model = get_arch(args.arch, smoke=args.smoke)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.steps,
                         log_every=1, warmup=10, ckpt_dir=args.ckpt_dir,
                         metrics_jsonl=args.metrics_jsonl,
                         replan_threshold=args.replan_threshold,
                         replan_patience=args.replan_patience,
                         replan_apply=args.replan_apply)
    return Trainer(model, dcfg, shape, AdamWConfig(lr=args.lr), tcfg,
                   device=args.device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    trainer = build_trainer(args)
    print(f"plan: {trainer.plan.describe()}")
    _, _, hist = trainer.run()
    for h in hist:
        moe = "".join(f" {k} {h[k]:.6g}" for k in ("moe_aux", "moe_drops")
                      if k in h)
        print(f"step {h['step']} loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6f} lr {h['lr']:.3e} {h['dt'] * 1e3:.1f}ms"
              f"{moe}")
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    report_obs(trainer, args)
    return trainer, hist


def report_obs(trainer, args):
    """What the reference's launcher prints after a run: the drift report,
    the last replan, and the profile and trace files it writes."""
    from repro_torch.core.obs import plan_trace, profile_step
    if trainer.drift.records:
        print(trainer.drift.report())
    if trainer.replans:
        last = trainer.replans[-1]
        print(f"replan: changed={last['changed']} "
              f"applied={last['applied']} gain={last['modeled_gain_s']}")
    profile = trainer.profile
    if args.profile_out and profile is None:
        # reuse the measured wall from the run so the profiler only has to
        # time segments and codecs, not re-drive full steps
        rows = trainer.drift.records.get("step_time", [])
        wall = rows[-1]["measured"] if rows else None
        profile = profile_step(trainer.model, trainer.plan, trainer.shape,
                               wall_step_s=wall, device=trainer.par.device)
    if trainer.par.mesh.rank != 0:
        return                      # every rank profiles; rank 0 writes
    if args.profile_out:
        profile.save(args.profile_out)
        print(f"profile: {args.profile_out} "
              f"(wall {profile.wall_step_s:.4f}s, "
              f"{len(profile.spans)} spans)")
    if args.trace_out or args.profile_out:
        out = args.trace_out or f"{args.profile_out}.trace.json"
        tb = plan_trace(trainer.model, trainer.plan, trainer.shape,
                        profile=profile)
        tb.save(out)
        print(f"trace: {out} ({len(tb.events)} events; "
              f"{'overlay' if profile is not None else 'modeled only'}; "
              f"open in Perfetto)")


if __name__ == "__main__":
    main()
