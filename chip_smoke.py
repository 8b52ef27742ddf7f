#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases (every phase runs; any failure makes the script exit non-zero
without printing the final line):
  1. device: the nvidia-smi name and power limit; the kernel build, timed.
  2. kernels vs plain: each CUDA kernel against its plain PyTorch version
     on the card at the serving path's shapes, with its time, the plain
     version's time, a PyTorch yardstick's time (timed only; the port never
     calls it) and the least time the card could take (bound).
  3. port on the card vs port on the CPU: llama3 and qwen3 SMOKE configs,
     fp32, the same numpy-seeded weights; prefill and 4 decode steps.
  4. full-width serve: llama3-8b, bf16, seeded weights made on the card,
     batch 4, prompt 2000, gen 64 (T = 2064) through
     `repro_torch.launch.serve`; launch counters; and a consistency check,
     prefill over p+1 tokens against prefill over p tokens + one decode step.
  5. a {"kernels": [...]} line, then {"ok": true, "device": {...}}.

TF32 is switched off for matmuls and cuDNN, so fp32 comparisons run in full
fp32.  Tolerances: TOL32 (rtol 2e-4, atol 2e-5) for fp32 and TOL (rtol 2e-2,
atol 2e-2) for bf16, those of tests/test_kernels.py; the full-width bf16
consistency check holds to an absolute 6e-2 (TOL_BF16_CONSISTENCY) and an
equal argmax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-5)
# full-width bf16 prefill over p+1 tokens vs prefill over p + one decode
# step, llama3-8b with seeded weights: 32 layers of bf16 rounding on two
# orders of summation read 4.0e-2 max abs error on a sound build (and the
# bf16 prefill is 3.9e-2 from the fp32 one on the same weights); the
# limit sits above that with room for run-to-run order changes
TOL_BF16_CONSISTENCY = dict(rtol=0.0, atol=6e-2)
# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 rate and peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
B, PROMPT, GEN = 4, 2000, 64
T = PROMPT + GEN


def say(*a):
    print(*a, flush=True)


def time_ms(fn, budget_s=0.3):
    """Mean ms per call from CUDA events, after a warm-up, over enough calls
    to fill about `budget_s`."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    iters = int(min(100, max(3, budget_s / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def check_close(what, got, want, tol):
    err = max_err(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and torch.allclose(
        got.float(), want.float(), **tol)
    say(f"  {what}: max_abs_err {err:.3e} (rtol {tol['rtol']}, atol "
        f"{tol['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: outside tolerance (max abs err "
                             f"{err:.3e})")
    return err


# ---------------------------------------------------------------------------
def phase_device(state):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    state["smi"] = smi
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels import build
    lib = build.library()
    say(f"kernel build: {lib.seconds:.1f}s -> {lib.path.relative_to(ROOT)}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("  " + line.strip())


def phase_kernels(state):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    say("rmsnorm kernel vs plain (ms: kernel / plain / F.rms_norm / bound):")
    rms_cases = [  # (name, x shape, x dtype, w dtype, unit_offset)
        ("prefill B*T x 4096 bf16", (B * T, 4096), torch.bfloat16,
         torch.bfloat16, False),
        ("prefill B*T x 4096 fp32", (B * T, 4096), torch.float32,
         torch.float32, False),
        ("qk-norm (B,T,32,128) bf16", (B, T, 32, 128), torch.bfloat16,
         torch.bfloat16, False),
        ("odd rows 8255 x 4096 bf16, fp32 w, unit_offset", (8255, 4096),
         torch.bfloat16, torch.float32, True),
        ("rows 1001 x 7168 fp32", (1001, 7168), torch.float32,
         torch.float32, False),
        ("decode B x 4096 bf16", (B, 1, 4096), torch.bfloat16,
         torch.bfloat16, False),
    ]
    for i, (name, shape, xdt, wdt, uo) in enumerate(rms_cases):
        x = randn(*shape, dtype=xdt) * 2
        w = randn(shape[-1], dtype=wdt)
        tol = TOL32 if xdt == torch.float32 else TOL
        err = check_close(name, rms_ops.rmsnorm(x, w, 1e-5, uo),
                          rms_ref.rmsnorm(x, w, 1e-5, uo), tol)
        ms = time_ms(lambda: rms_ops.rmsnorm(x, w, 1e-5, uo))
        plain = time_ms(lambda: rms_ref.rmsnorm(x, w, 1e-5, uo))
        w_lib = (w.float() + 1).to(xdt) if uo else w.to(xdt)
        lib = time_ms(lambda: F.rms_norm(x, (shape[-1],), w_lib, 1e-5))
        # x read once and written once, w read once; ~4 fp32 ops an element
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        t_ops, t_bytes = 4 * x.numel() / PEAK_FLOPS[torch.float32], \
            nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} "
            f"({nbytes / ms / 1e6:.0f} GB/s)")
        if i == 0:
            state["rmsnorm"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                library_ms=lib)

    say("flash kernel vs plain (ms: kernel / plain / SDPA / bound):")
    flash_cases = [  # (name, B, S, H, Kh, hd, dtype, kwargs, sdpa)
        (f"prefill B{B} T{T} H32 Kh8 hd128 causal bf16", B, T, 32, 8, 128,
         torch.bfloat16, dict(causal=True), True),
        (f"B{B} T2048 H32 Kh8 hd128 causal bf16", B, 2048, 32, 8, 128,
         torch.bfloat16, dict(causal=True), True),
        ("B2 T1000 H8 Kh2 hd128 window 256 softcap 50 bf16", 2, 1000, 8, 2,
         128, torch.bfloat16, dict(causal=True, window=256, softcap=50.0),
         False),
        ("B2 T777 H8 Kh8 hd64 non-causal fp32", 2, 777, 8, 8, 64,
         torch.float32, dict(causal=False), True),
        ("B2 T300 H4 Kh2 hd16 causal fp32", 2, 300, 4, 2, 16,
         torch.float32, dict(causal=True), True),
    ]
    for i, (name, b, s, h, kh, hd, dt, kw, sdpa) in enumerate(flash_cases):
        q = randn(b, s, h, hd, dtype=dt)
        k = randn(b, s, kh, hd, dtype=dt)
        v = randn(b, s, kh, hd, dtype=dt)
        tol = TOL32 if dt == torch.float32 else TOL
        err = check_close(name, flash_ops.flash_attention(q, k, v, **kw),
                          flash_ref.attention(q, k, v, **kw), tol)
        ms = time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: flash_ref.attention(q, k, v, **kw))
        lib = None
        if sdpa:
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=True))
        # work this input needs: unmasked (q, k) pairs, 4*hd flops each
        qi = torch.arange(s, device=dev)[:, None]
        ki = torch.arange(s, device=dev)[None, :]
        keep = torch.ones((s, s), dtype=torch.bool, device=dev)
        if kw.get("causal"):
            keep &= ki <= qi
        if kw.get("window"):
            keep &= qi - ki < kw["window"]
        flops = 4.0 * hd * b * h * keep.sum().item()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16], \
            nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        say(f"    {ms:.4f} / {plain:.4f} / "
            f"{'n/a' if lib is None else f'{lib:.4f}'} / {bound:.4f} "
            f"({flops / ms / 1e9:.1f} TFLOP/s)")
        if i == 0:
            state["flash"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib)

    # strided inputs: q/k/v as head slices of one packed projection
    q, k, v = randn(2, 515, 32 + 2 * 8, 128, dtype=torch.bfloat16).split(
        [32, 8, 8], dim=2)
    check_close("strided q/k/v slices of a packed (B,T,48,128) bf16",
                flash_ops.flash_attention(q, k, v),
                flash_ref.attention(q, k, v), TOL)


def _numpy_params(model, dcfg, seed):
    """Reference-layout numpy weights from one seed (norms near 1)."""
    from repro_torch.core.meta import tree_map
    rng = np.random.default_rng(seed)
    sk = model.stacked_keys

    def one(m, n):
        shape = (n, *m.global_shape) if n else m.global_shape
        a = rng.standard_normal(shape).astype(np.float32)
        return 1 + 0.1 * a if len(m.global_shape) == 1 else 0.05 * a

    return {k: tree_map(lambda m: one(m, sk.get(k)), v)
            for k, v in model.metas(dcfg).items()}


def phase_smoke_parity(state):
    from repro_torch.core.dist import single_device_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    b, prompt, gen = 2, 12, 4
    t_len = prompt + gen
    for arch in ("llama3_8b", "qwen3_1_7b"):
        cfg, model = get_arch(arch, smoke=True)
        dcfg = single_device_config(param_dtype=torch.float32)
        tree = _numpy_params(model, dcfg, seed=0)
        rng = np.random.default_rng(1)
        tokens = np.pad(rng.integers(3, cfg.vocab, (b, prompt)),
                        ((0, 0), (0, gen)), constant_values=3)
        runs = {}
        for dev in ("cpu", "cuda"):
            params = SV.serve_params_from_jax(tree, model, dcfg, device=dev)
            pf = SV.make_prefill_step(model, dcfg,
                                      ShapeConfig("p", t_len, b, "prefill"))
            dec = SV.make_decode_step(model, dcfg,
                                      ShapeConfig("d", t_len, b, "decode"))
            rms_ops.launches = flash_ops.launches = 0
            logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)
                                        .to(dev)})
            if dev == "cuda" and not (rms_ops.launches and flash_ops.launches):
                raise AssertionError(f"{arch}: the smoke prefill on the card "
                                     "did not launch both kernels")
            runs[dev] = dict(params=params, dec=dec, cache=cache,
                             logits=[logits.cpu()])
        check_close(f"{arch} smoke prefill logits cuda vs cpu",
                    runs["cuda"]["logits"][0], runs["cpu"]["logits"][0],
                    TOL32)
        for got, want in zip(runs["cuda"]["cache"], runs["cpu"]["cache"]):
            check_close(f"{arch} smoke kv cache cuda vs cpu", got.cpu(),
                        want, TOL32)
        for i in range(4):
            tok = runs["cpu"]["logits"][-1].argmax(-1)
            if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1), tok):
                raise AssertionError(f"{arch}: greedy tokens differ at {i}")
            pos = torch.full((b,), prompt + i, dtype=torch.int64)
            for dev, r in runs.items():
                logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                              tok.to(dev), pos.to(dev))
                r["logits"].append(logits.cpu())
            check_close(f"{arch} smoke decode {i} logits cuda vs cpu",
                        runs["cuda"]["logits"][-1], runs["cpu"]["logits"][-1],
                        TOL32)


def phase_full_width(state):
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import tree_map
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        "llama3_8b", False, B, PROMPT, GEN, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    say(f"llama3-8b bf16: {n / 1e9:.3f}B params made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    torch.cuda.reset_peak_memory_stats()

    rms_ops.launches = flash_ops.launches = 0
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN)
    counts = dict(rmsnorm=rms_ops.launches, flash=flash_ops.launches)

    peak = torch.cuda.max_memory_allocated()
    say(f"serve B={B} prompt={PROMPT} gen={GEN} T={T}: "
        f"prefill {t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} tokens/s"
        f", max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"launches in the serve run: {counts}")
    state["launches"] = counts
    state["serve"] = dict(t, max_memory_allocated=peak)
    if tokens.shape != (B, GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")

    # where the time goes: device kernel time against wall time
    pos = torch.full((B,), PROMPT, dtype=torch.int64, device=dev)
    logits, cache = prefill(params, {"tokens": padded})
    _profile("prefill", lambda: prefill(params, {"tokens": padded}), 1)
    _profile("decode step",
             lambda: decode(params, cache, logits.argmax(-1), pos), 8)
    del cache

    g = torch.Generator().manual_seed(2)
    x = torch.randint(3, cfg.vocab, (B, T), generator=g).to(dev)
    want, got, per_call = _consistency(params, prefill, decode, x, "bf16")
    say(f"launches per call: {per_call}")
    state["per_call"] = per_call

    # the same weights widened to fp32: here the two paths must agree to
    # fp32 rounding, which separates a fault from bf16 noise
    dcfg32 = single_device_config(param_dtype=torch.float32)
    params32 = tree_map(lambda a: a.float(), params)
    del params
    want32, got32, _ = _consistency(
        params32,
        SV.make_prefill_step(model, dcfg32, ShapeConfig("p", T, B, "prefill")),
        SV.make_decode_step(model, dcfg32, ShapeConfig("d", T, B, "decode")),
        x, "fp32 (same weights widened)")
    check_close("fp32: prefill vs prefill + decode", got32, want32, TOL32)
    say(f"  bf16 prefill vs fp32 prefill, same weights: max_abs_err "
        f"{max_err(want, want32):.4e} (for scale; not a limit)")
    check_close("bf16: prefill vs prefill + decode", got, want,
                TOL_BF16_CONSISTENCY)
    for name, a, b in (("fp32", got32, want32), ("bf16", got, want)):
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            raise AssertionError(f"{name}: argmax differs")
    say("  argmax equal in fp32 and bf16")


def _consistency(params, prefill, decode, x, label):
    """Last logits of prefill over x (B, T) and of prefill over x with a pad
    at T-1 followed by one decode step of x[:, -1] at position T-1."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    rms_ops.launches = flash_ops.launches = 0
    want, _ = prefill(params, {"tokens": x})
    per_call = dict(prefill=dict(rmsnorm=rms_ops.launches,
                                 flash=flash_ops.launches))
    xp = x.clone()
    xp[:, -1] = 3
    _, cache = prefill(params, {"tokens": xp})
    rms_ops.launches = flash_ops.launches = 0
    got, _ = decode(params, cache, x[:, -1],
                    torch.full((B,), T - 1, dtype=torch.int64,
                               device=x.device))
    per_call["decode"] = dict(rmsnorm=rms_ops.launches,
                              flash=flash_ops.launches)
    top2 = want.topk(2, dim=-1).values
    say(f"  {label}: max|logit| {want.abs().max().item():.4f}, max abs err "
        f"{max_err(got, want):.4e}, mean abs err "
        f"{(got - want).abs().mean().item():.4e}, top-2 gaps "
        f"{[round(v, 5) for v in (top2[:, 0] - top2[:, 1]).tolist()]}, "
        f"argmax {want.argmax(-1).tolist()} vs {got.argmax(-1).tolist()}")
    return want, got, per_call


def _profile(label, fn, n):
    """Prints device kernel time against wall time over n calls, and the
    kernels that take most of it (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        say(f"{label}: device time not measured (the profiler saw no "
            f"kernels); wall {wall / n * 1e3:.3f} ms per call")
        return
    dev_us = sum(e.self_device_time_total for e in rows)
    say(f"{label}: wall {wall / n * 1e3:.3f} ms, device kernels "
        f"{dev_us / n / 1e3:.3f} ms per call "
        f"({100 * dev_us / 1e6 / wall:.1f}% busy), "
        f"{sum(e.count for e in rows) / n:.0f} device ops per call")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / n / 1e3:9.3f} ms "
            f"{e.count // n:5d}x  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernels_line(state):
    src = "src/repro_torch/csrc/"
    rows = [
        dict(name="rmsnorm", route="cuda", source=src + "rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:29",
             launches=state["launches"]["rmsnorm"], **state["rmsnorm"]),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:77",
             launches=state["launches"]["flash"], **state["flash"]),
    ]
    return json.dumps({"kernels": rows})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    state, failed = {}, []
    for name, phase in [("device", phase_device),
                        ("kernels vs plain", phase_kernels),
                        ("smoke cuda vs cpu", phase_smoke_parity),
                        ("full-width serve", phase_full_width)]:
        say(f"== {name}")
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            say(f"== {name}: FAILED")
        say(f"== {name}: {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    say(state["smi"])
    say(kernels_line(state))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
