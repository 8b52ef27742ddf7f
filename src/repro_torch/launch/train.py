"""Training launcher CLI (port of `repro.launch.train` at pp = 1, tp = 1).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
      --seq 2048 --batch 4 --steps 20 --comm-precision fp8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 --dtype float32 --comm-precision fp8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 --bucket-mode auto_dp --comm-precision auto \\
      --remat auto:0.5

Runs on the card unless `--device cpu` is given.  At world size 1 it
creates its own one-rank process group on an in-process store (no
network); a multi-rank run initialises `torch.distributed` itself (one
process per card, `--mesh D,1`) before calling `main`.  The default
schedule is the reference's: the bucket+reorder prefetch stack;
`--no-reorder` runs the vanilla bucketed schedule.  `--bucket-mode
auto|auto_dp` runs the bucket planners, `--comm-precision auto` picks a
wire precision per bucket, and `--remat auto:<GB>` lets the memory plan
choose the remat policy under a per-device budget; the printed plan shows
the choices (`comm=auto(...)`, `mem[...]`).  The reference's
observability and replanning flags are accepted and raise "not yet
ported".
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.core.dist import COMM_PRECISIONS

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_OBS_FLAGS = ("metrics_jsonl", "trace_out", "profile_out",
              "replan_threshold")


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
    ap.add_argument("--metrics-jsonl", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--profile-out", default=None)
    ap.add_argument("--replan-threshold", type=float, default=None)
    return ap.parse_args(argv)


def build_trainer(args):
    from repro_torch.core.dist import DistConfig
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    unported = [f"--{f.replace('_', '-')}" for f in _OBS_FLAGS
                if getattr(args, f) is not None]
    if unported:
        raise NotImplementedError(
            f"{unported}: the observability slice (metrics registry, "
            "traces, profile-guided replanning) is not yet ported to "
            "repro_torch")
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
                         log_every=1, warmup=10, ckpt_dir=args.ckpt_dir)
    return Trainer(model, dcfg, shape, AdamWConfig(lr=args.lr), tcfg,
                   device=args.device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    trainer = build_trainer(args)
    print(f"plan: {trainer.plan.describe()}")
    _, _, hist = trainer.run()
    for h in hist:
        print(f"step {h['step']} loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6f} lr {h['lr']:.3e} {h['dt'] * 1e3:.1f}ms")
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return trainer, hist


if __name__ == "__main__":
    main()
