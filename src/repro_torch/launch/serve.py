"""Serving launcher CLI: prefill a synthetic batch, greedy-decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
      --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3_moe_30b_a3b --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --int8-kv --metrics-jsonl serve.jsonl

Serves the dense, moe, zamba, xlstm, encdec and vlm families (`--arch`
any id in `models.registry.PORTED`):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1_2b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1_3b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless_m4t_large_v2 --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2_26b \
      --smoke --device cpu

Mirrors `repro.launch.serve` at world size 1: seeded weights, prompts of
random tokens padded with token 3 up to T = prompt_len + gen (so the first
greedy token comes from the logits of position T-1, a pad, as in the
reference), one untimed warm-up call of each step, then timed windows that
end in a device synchronize.  The padding is kept so that the two
launchers' timings compare; for zamba2 the pads enter the SSD and conv
states, for xlstm the mLSTM, sLSTM and conv states, before decode starts
at prompt_len (attention's decode overwrites their keys instead).  encdec's
prefill also takes seeded frames (`make_frames`: T // 2 of them, as its
`input_specs` sizes a prefill cell).  The vlm's prefill takes seeded
image embeddings ahead of the text (`make_img_embeds`: n_img_tokens of
them), so its cell spans n_img_tokens + T positions and decode starts at
n_img_tokens + prompt_len; the reference's launcher passes no images and
decodes at prompt_len, so it cannot serve the vlm.  The first call on the
card also
builds the kernels.  `--int8-kv` stores the KV cache as int8 with
per-128-chunk scales (the quant kernels on the card); `--metrics-jsonl`
appends one `MetricsRegistry` line of `serve/*` gauges with the
reference launcher's keys (its `*_compile_s` are the port's warm-up
calls, the kernel build included).
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.core.dist import resolve_device, single_device_config
from repro_torch.core.obs import MetricsRegistry
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as SV

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def setup(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          device="cuda", dtype="float32", seed: int = 0,
          kv_codec: str | None = None):
    """(cfg, model, dcfg, params, prefill, decode) of one serving run;
    `kv_codec` ('int8' | 'fp8' | None) quantizes the KV cache."""
    dev = resolve_device(device)
    dcfg = single_device_config(param_dtype=DTYPES[dtype],
                                kv_cache_codec=kv_codec)
    cfg, model = get_arch(arch, smoke=smoke)
    # the vlm's cell counts its image positions ahead of the text
    T = cfg.n_img_tokens + prompt_len + gen
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = SV.init_serve_params(model, dcfg, generator, dev)
    prefill = SV.make_prefill_step(model, dcfg,
                                   ShapeConfig("p", T, batch, "prefill"))
    decode = SV.make_decode_step(model, dcfg,
                                 ShapeConfig("d", T, batch, "decode"))
    return cfg, model, dcfg, params, prefill, decode


def make_prompts(cfg, batch: int, prompt_len: int, gen: int, device,
                 seed: int = 1):
    """(B, prompt_len + gen) int64: random prompts padded with token 3."""
    g = torch.Generator().manual_seed(seed)
    prompts = torch.randint(3, cfg.vocab, (batch, prompt_len), generator=g)
    return F.pad(prompts, (0, gen), value=3).to(device)


def make_frames(model, dcfg, batch: int, seq_len: int, device,
                seed: int = 2):
    """encdec's stub frontend input for a prefill over `seq_len` target
    tokens: (B, seq_len // 2, frontend_dim) fp32 frames, the shape its
    `input_specs` gives a prefill cell, 0.3 x a seeded normal (the scale
    `data.pipeline.adapt_batch` synthesises frames at).  The reference's
    launcher passes no frames, so it cannot serve encdec."""
    spec = model.input_specs(ShapeConfig("p", seq_len, batch, "prefill"),
                             dcfg)["frames"]
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(spec.shape, generator=g) * 0.3).to(device)


def make_img_embeds(model, dcfg, batch: int, seq_len: int, device,
                    seed: int = 2):
    """The vlm's stub frontend input for a prefill cell of `seq_len`
    positions (image and text): (B, n_img_tokens, vit_dim) fp32 patch
    embeddings, the shape its `input_specs` gives a prefill cell, 0.3 x a
    seeded normal (the scale `data.pipeline.adapt_batch` synthesises them
    at)."""
    spec = model.input_specs(ShapeConfig("p", seq_len, batch, "prefill"),
                             dcfg)["img_embeds"]
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(spec.shape, generator=g) * 0.3).to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, prefill, decode, padded, prompt_len: int, gen: int,
             frames=None, img_embeds=None):
    """Warm-up, then timed prefill and greedy decode; `frames` (encdec)
    and `img_embeds` (vlm) join the prefill's batch, and the images take
    the positions ahead of the text, so decode starts at n_img +
    prompt_len.

    Returns (tokens (B, gen), timings) with timings in seconds:
    prefill_warmup_s, decode_warmup_s, prefill_s, decode_step_s (the mean
    of gen - 2 steady steps) and decode_tok_s (tokens per second)."""
    dev = padded.device
    B = padded.shape[0]
    batch = {"tokens": padded}
    if frames is not None:
        batch["frames"] = frames
    start = prompt_len
    if img_embeds is not None:
        batch["img_embeds"] = img_embeds
        start += img_embeds.shape[1]
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(dev)
    t_pf_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(dev)
    t_pf = time.perf_counter() - t0

    tok = logits.argmax(-1)
    outs = [tok]
    pos = torch.full((B,), start, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    logits, cache = decode(params, cache, tok, pos)
    _sync(dev)
    t_dec_warm = time.perf_counter() - t0
    tok = logits.argmax(-1)
    outs.append(tok)
    t0 = time.perf_counter()
    for i in range(1, gen - 1):
        logits, cache = decode(params, cache, tok, pos + i)
        tok = logits.argmax(-1)
        outs.append(tok)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    n_steady = max(1, gen - 2)
    return torch.stack(outs, 1), dict(
        prefill_warmup_s=t_pf_warm, decode_warmup_s=t_dec_warm,
        prefill_s=t_pf, decode_step_s=t_dec / n_steady,
        decode_tok_s=B * n_steady / max(1e-9, t_dec))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append a metrics-registry snapshot (warm-up and "
                         "steady prefill/decode timings) here (core/obs)")
    args = ap.parse_args(argv)

    cfg, model, dcfg, params, prefill, decode = setup(
        args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
        device=args.device, dtype=args.dtype,
        kv_codec="int8" if args.int8_kv else None)
    dev = resolve_device(args.device)
    padded = make_prompts(cfg, args.batch, args.prompt_len, args.gen, dev)
    frames = make_frames(model, dcfg, args.batch, padded.shape[1], dev) \
        if cfg.family == "encdec" else None
    img = make_img_embeds(model, dcfg, args.batch,
                          cfg.n_img_tokens + padded.shape[1], dev) \
        if cfg.family == "vlm" else None
    tokens, t = generate(params, prefill, decode, padded, args.prompt_len,
                         args.gen, frames, img)
    print("generated:", tokens.cpu().numpy())
    print(f"warm-up: prefill {t['prefill_warmup_s']*1e3:.1f}ms, "
          f"first-decode {t['decode_warmup_s']*1e3:.1f}ms")
    print(f"steady:  prefill {t['prefill_s']*1e3:.1f}ms; "
          f"decode {t['decode_step_s']*1e3:.1f}ms/tok; "
          f"tp={dcfg.tp_size} dtype={args.dtype} device={args.device} "
          f"int8_kv={args.int8_kv}")
    if args.metrics_jsonl:
        reg = MetricsRegistry()
        reg.gauge("serve/prefill_compile_s").set(t["prefill_warmup_s"])
        reg.gauge("serve/decode_compile_s").set(t["decode_warmup_s"])
        reg.gauge("serve/prefill_s").set(t["prefill_s"])
        reg.gauge("serve/decode_step_s").set(t["decode_step_s"])
        reg.gauge("serve/decode_tok_s").set(t["decode_tok_s"])
        reg.dump_jsonl(args.metrics_jsonl, arch=args.arch,
                       batch=args.batch, gen=args.gen)
        print(f"metrics: {args.metrics_jsonl}")


if __name__ == "__main__":
    main()
