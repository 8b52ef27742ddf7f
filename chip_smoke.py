#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases (every phase runs; any failure makes the script exit non-zero
without printing the final line):
  1. device: the nvidia-smi name and power limit; the kernel build, timed;
     each kernel's registers, static shared memory and spills from the
     ptxas log (the flash and rmsnorm kernels must not spill).
  2. kernels vs plain: each CUDA kernel against its plain PyTorch version
     on the card at the serving and training paths' shapes, with its time
     (and for flash and rmsnorm its device time, less the host's cost),
     the plain version's time, a PyTorch yardstick's time (timed only; the
     port never calls it) and the least time the card could take (bound:
     elementwise work at PEAK_FLOPS, matrix products at PRODUCT_FLOPS);
     flash's bf16 cases on the wgmma kernel, its fp32 cases on the TF32
     mma.sync kernel (three TF32 products a product), whose one-product
     variant must miss TOL32, and every flash case's wall time beside its
     and SDPA's device time; a bf16 stride TMA cannot read rejected; every
     bf16 flash output also held to FLASH_BF16_RMS_REL, which a P rounded
     to one bf16 part and a dropped 128-key tile, planted in the plain
     version, must fail; the rmsnorm
     gradient (kernel forward, plain backward) against autograd through
     the plain version; the flash gradient (`flash_grad_case`: kernel
     forward + the backward kernels, bf16 at qwen3-1.7b's layer shape B4
     T2048 H16 Kh8 hd128 causal, fp32 at B2 T777 H8 Kh8 hd64 non-causal)
     against autograd through the plain version (TOL / TOL32), the
     forward's lse against `ref.attention_lse` (TOL32), the backward alone
     against the plain reverse pass `ref.attention_bwd` (bf16 also to
     FLASH_BF16_GRAD_RMS_REL, which P or dS in one bf16 part, a query head
     left out of dK/dV and D = 0, planted there, must fail; fp32 at TOL32,
     which one TF32 product must miss), two backward calls bit-identical,
     (bf16) each dQ tile's count of key blocks' partials equal to
     `ops.bwd_schedule`'s, and the ms of fwd + bwd and of the backward
     alone (wall, device) beside SDPA's backward and the bound.
  3. quant kernels vs plain: the wire codec's quant and dequant kernels,
     fp8 / int8 x RTN / SR x f32 / bf16 inputs at 129, 5000, the largest
     bucket of the full-width path, one pass of the SR seed kernel's grid
     -128, -1, 0, +1 and +128 elements, and a view one element off
     alignment (plus the largest error-feedback leaf, fp8 RTN), on buffers
     with all-zero chunks, ties and values at exactly +-QMAX*scale: wire
     bytes, scales, decoded values and the seed the SR launch used must
     equal the plain version EXACTLY; two planted wrong results (RTN in
     place of SR, one per-tensor scale in place of per-chunk) must be told
     apart; wall and device times of four variants, SR's share above RTN,
     and byte bounds.
 3b. quantized reduce-scatter, card vs CPU: the largest full-width bucket's
     gradients through `finalize_grad_bucket` (fp8_ef, int8_ef, fp8 with
     grad_compression) and the error-feedback hop: bit for bit.
  4. port on the card vs port on the CPU: llama3 and qwen3 SMOKE configs,
     fp32, the same numpy-seeded weights; prefill and 4 decode steps.
  5. smoke training, card vs CPU: `repro_torch.launch.train`'s trainer,
     qwen3 SMOKE, fp32, --no-reorder, 3 steps from one CPU-made checkpoint
     (loss, grad norm, storage at TOL32); a restart after an injected
     failure that must end bit-exact; launch counters of every kernel;
     one bf16 loss step, card vs CPU, at TOL.
  6. smoke quantized training, card vs CPU: the same trainer with the
     prefetch stack (reorder on) at int8_ag and fp8_ef, from one CPU-made
     checkpoint: int8_ag's first loss step (loss, gradients) at TOL32 and
     its quantized gathered weights byte-equal; every later step, and
     every fp8_ef step, within the harness bounds (losses rtol 5e-2,
     per-coordinate weight drift <= 4*lr*steps: the stochastic-rounding
     seed depends on every bit of the gradient); a non-zero error-feedback
     accumulator; a bit-exact fp8_ef restart, EF included; both quant
     kernels launched.
 6a. ssd kernels vs plain: the Mamba-2 SSD chunk scan at zamba2-1.2b's
     layer shape (B 4, T 2048, H 64, P 64, N 64, chunk 128; bf16 and fp32,
     the model's own dt and A ranges, B and C as strided halves of one
     packed projection), the reference sweep's shapes and the smoke shape
     with a ragged last chunk; both dtypes on the chunk-parallel forward of
     ssd_sm90.cu (fp32 on TF32 tensor cores, counted in `launches_f32`);
     every bf16 output also held to SSD_BF16_RMS_REL, which two planted
     results (the state not carried across chunks, M in one bf16 part)
     must fail, and the fp32 forward with one TF32 product must fail its
     check; the full-width serve's prefill shapes (T 2064 and 2063: last
     chunks of 16 and 15 rows) in both dtypes; the final state
     (`ssd_with_state`) against the plain S at every full-width shape and
     every ragged one (bf16 to SSD_BF16_RMS_REL, fp32 at TOL32 on the
     summed |terms|), the state entering the last chunk planted in its
     place; kernel / plain ms, device ms and the bound; the backward
     kernels (kernel forward + kernel backward) against autograd through
     the plain version at the full shape in bf16 and fp32, with the
     backward's own ms (wall, device) beside its bound and the plain
     version's; bf16 dx, ddt, dB and dC also held to SSD_BF16_GRAD_RMS_REL
     of the plain reverse-pass backward, which that backward with M and dM
     o L in one bf16 part must fail, and so must the bf16 backward kernel
     run with M and the dCB sum in one bf16 part (`bf16_parts=1`); two
     calls of the bf16 backward bit-identical; dA and dD planted from half
     the chunks' partials and as 0 must fail their checks.
 6b. zamba2 smoke training, card vs CPU: the launcher's trainer, zamba2
     SMOKE (shared block hd 32, T 40: a ragged SSD chunk), fp32, 3 steps
     from one CPU-made checkpoint, vanilla and prefetch: loss, grad norm,
     storage at TOL32; ssd (fp32 route) and its backward, flash,
     rmsnorm, xent and adamw launched.
  7. full-width serve: llama3-8b, bf16, seeded weights made on the card,
     batch 4, prompt 2000, gen 64 (T = 2064) through
     `repro_torch.launch.serve`; launch counters (every full-width phase
     asserts that flash's bf16 route launched and its fp32 route did not);
     and a consistency check,
     prefill over p+1 tokens against prefill over p tokens + one decode step.
  8. full-width training: qwen3-1.7b, bf16 compute, fp32 storage, B 4,
     T 2048, remat fsdp_only, block buckets, reorder off, through
     `parallelize(...).train_step` on `SyntheticC4` batches: 1 warm-up
     step, 6 timed steps; step ms, tokens/s, MFU, peak memory, a profiler
     window's device busy share, launches per step (every training phase:
     one flash backward launch a differentiated attention call on the bf16
     route, none on the fp32 route; the fp32 smoke phases the reverse;
     serving windows none), finite losses.
  9. full-width prefetch training: the same with reorder on (the
     bucket+reorder prefetch stack, the reference launcher's default
     schedule), bf16 wire: the reorder on / off comparison in one call.
 10. full-width quantized training (the main path of the third slice):
     the prefetch stack with comm_precision fp8_ef; the same readings plus
     the collectives per step, the error-feedback accumulator and the
     codec's device time by kernel and variant.
 10b. full-width zamba2-1.2b training (the main path of the fourth slice):
     bf16, B 4, T 2048, the prefetch stack at a bf16 wire, remat fsdp_only,
     block buckets; the same readings, MFU from the FLOPs the step applies
     (the Mamba layers once, the shared block once per invocation, the head,
     attention and the SSD products), ssd forward and backward launches
     per step and none on the fp32 route; the profiled step's SSD
     backward on ssd_grad_sm90_kernel, one launch a backward call, and
     none of the fp32 chunk_grad_kernel.
 10c. full-width auto-planned training (the main path of the eighth
     slice): qwen3-1.7b B4 T2048 through `Trainer` with bucket_mode
     auto_dp, comm_precision auto and remat auto:AUTO_BUDGET_GB under the
     H100 profile: the plan, the modeled peak per component beside
     max_memory_allocated over one step (`Trainer.memory_report`), the
     first step's loss bit-equal to a loss step of `parallelize(plan.
     exec_dcfg)` on the same storage and batch, the gathers and
     reduce-scatters per step equal to the executed buckets x layers, and
     the readings of 8.
 10d. full-width mixed-precision training: qwen3-1.7b's blocks planned for
     a modeled 4 x 8 mesh (auto_dp + auto, host math) and its
     exposed_comm_time; the plan's groups at bf16 / fp8_ef / int8_ag (the
     groups halved when the planner's precisions are not mixed) trained at
     world size 1; quant and dequant calls per step equal to what the
     precisions imply, error feedback non-zero only in fp8_ef buckets.
 10e. planner lines: zamba2-1.2b's resolved plans and modeled peaks, the
     H100 profile's HBM size beside the card's total memory, pinned 1 GiB
     host <-> device copies beside the profile's host DMA rate.
 10f. full-width observability (the main path of the ninth slice): 10c's
     configuration through `Trainer.run` for OBS_STEPS steps with
     replan_threshold 0, patience 2, no apply: the drift report (the H100
     prior's modeled step beside the measured one), `train/steps`, wire
     bytes by precision equal to `step_wire_metrics` x steps, a replan
     delta, the profile's segment ms beside their modeled ms and scales,
     the closure factor, fp8 and int8 rates from the CUDA codec (its
     launch counts rose in each harvest) beside the analytic prior, no
     collective bandwidth at world size 1, the calibrated step within 2%
     of the wall, and the trace (build/obs/) whose non-overlapped comm
     equals exposed_s exactly.
 10g. smoke replan on the card: qwen3 SMOKE bf16 through `Trainer` with
     replan_apply: every changed replan is applied (save,
     `parallelize(plan=...)`, restore), the loop ends at its last step on
     the last applied plan.
 10h. moe kernels vs plain (the main path of the tenth slice, the moe
     family): bf16 flash at qwen3-moe-30b-a3b's attention (B 4, T 2048,
     H 32 on Kh 4: a GQA group of 8) against its plain version at TOL and
     FLASH_BF16_RMS_REL with its two planted faults, beside SDPA and the
     bound; its training gradient (`flash_grad_case`: dK and dV summed
     over a group of 8); AdamW at the path's
     largest leaf (4 layers of a 128-expert stack, 805,306,368 elements).
 10i. moe smoke, card vs CPU: both moe SMOKE configs, fp32, 3 steps of the
     launcher's trainer on the vanilla and the prefetch stack from one
     CPU-made checkpoint (losses, grad norms, storage at TOL32; the expert
     ids of every dispatch equal; no choice dropped), a bit-exact prefetch
     restart, a loss step at capacity_factor 1.0 with the aux in the loss
     (loss, aux, drop count, gradients at TOL32), prefill and 4 decode
     steps card vs CPU, and on the card prefill over p+1 tokens against
     prefill over p + one decode step, with no choice dropped.
 10j. full-width qwen3-moe-30b-a3b training: every published width, 4 of
     48 layers (MOE_TRAIN_LAYERS), B 4, T 2048, bf16 compute, fp32 storage,
     the prefetch stack at a bf16 wire: the readings of 8 with MFU on the
     active FLOPs (k experts a token), the executed routed-expert FLOPs
     apart, the modeled peak and step (H100 profile) beside the measured,
     the drop share and the aux; then one forward pass on the last batch
     and one on uniform random tokens read the router (drop share by
     layer; in layer 0 the experts' occupancy, the logit spread across
     tokens and across experts, the common share of the router's input and
     of the embeddings).  The drop share and the readings that explain it
     are held to bands (MOE_DROP_BAND and the two beside it).
 10k. full-width qwen2-moe-a2.7b training: the same at 4 of 24 layers (60
     experts padded to 64, top-4 unnormalised, the gated shared expert).
 10l. full-width qwen3-moe-30b-a3b serving at all 48 layers: bf16 weights
     made on the card, B 4, prompt 2000 padded to T 2064, 64 generated
     tokens; prefill ms, decode ms/token beside the decode step's byte
     bound (every routed expert is read: the capacity dispatch at T = B),
     the prefill's drop share (held to MOE_PREFILL_DROP_BAND) by layer,
     device time a decode step.
 10m. gemma2 kernels vs plain (the main path of the eleventh slice,
     gemma2-27b): bf16 flash at the training (B 1) and prefill (B 2)
     shapes, T 8192, H 32 on Kh 16, hd 128, q_scale 1/16, for the local
     layer (window 4096, softcap 50) and the global one (softcap 50),
     against its plain version (evaluated two kv heads at a time) at TOL
     and FLASH_BF16_RMS_REL with its two planted faults, beside the bound
     (the pairs inside the window) and SDPA without the softcap (it takes
     none); the local layer's training gradient (`flash_grad_case`, the
     plain versions by 2 kv heads); rmsnorm with unit offset
     at (8192, 4608) with a planted missing offset; xent at (8192, 256000)
     on softcapped logits; AdamW on the tied embedding's
     1,179,648,000-element leaf.
 10n. gemma2 smoke, card vs CPU: SMOKE (one pair, window 8), fp32, 3 steps
     of the launcher's trainer at T 32 on the vanilla and the prefetch
     stack from one CPU-made checkpoint (losses, grad norms, storage at
     TOL32; launch counters); prefill and 4 decode steps of a 12-token
     prompt across the window, logits and both caches card vs CPU; prefill
     over p+1 tokens against prefill over p + one decode step on the card.
 10o. full-width gemma2-27b training: every published width, one
     local/global pair (GEMMA2_TRAIN_LAYERS), B 1, T 8192 (above the
     window), bf16 compute, fp32 storage, the prefetch stack at a bf16
     wire: the readings of 8, the windows flash was launched with, the
     modeled peak and step (H100 profile) beside the measured.
 10p. full-width gemma2-27b serving at all 46 layers: bf16 weights made on
     the card, B 2, prompt 8128 padded to T 8192, 64 generated tokens;
     prefill ms, decode ms/token beside its byte bound, device time a
     decode step, the windows flash was launched with; the consistency
     check of 7 at p = 8191, past the window, in bf16 and at TOL32 on the
     first GEMMA2_F32_LAYERS layers widened to fp32.
 10q. paged serving smoke, card vs CPU (the main path of the twelfth
     slice, paged serving): qwen3 SMOKE with no KV codec, int8 and fp8,
     gemma2 SMOKE (window 8, page 4) and qwen2-moe SMOKE, fp32: prefill,
     `dense_to_pages`, 4 paged decode steps, the card's logits held to the
     CPU's at TOL32 and on the card paged equal to dense bit for bit at
     each step, the paged and the dense steps each in a launch-count
     window of its own with the same counts; qwen3 at B 2: a ragged-position
     step and chunked prefill (4 + 4, 3 + 4 + 1) against a full prefill at
     2e-5.
 10r. full-width paged serve: llama3-8b bf16, 32 layers, B 4, prompt
     2000, page 16, dense T = 129 pages x 16 = 2064: with the bf16, int8 and
     fp8 caches, prefill, repage and 16 decode steps, paged equal to dense
     bit for bit at each, the paged and the dense steps each in a
     launch-count window of its own (65 rmsnorm a step; 64 quant_fwd and 64
     dequant_fwd under a codec); decode ms/token paged and dense, each
     codec's logits within PAGED_CODEC_DIFF of the bf16 cache's, and the
     cache with its scales zeroed outside it; then a server answering
     requests: `plan_serve` under the H100 profile with a 1 GiB arena (512
     pages), max_batch 8, max_seq 2304, the plan's chunk; 16 synthetic
     requests and 4 that share request 0's first 1024 tokens, a prefix
     cache, the scheduler's contract driving one paged step an action with
     the measured wall time; every request finishes, `pool.check()` after
     every action, no page leaked, a preemption and a prefix hit, 65
     rmsnorm launches a paged step and no other kernel; every finished
     prefill (prefix hits and recomputes after a preemption included)
     equal bit for bit to a standalone paged prefill with the same chunks
     on a fresh arena, which a table with two pages swapped fails; the
     first token's logits of the first 4 finished requests, a prefix hit
     and a preempted one against a dense prefill of the prompt at
     TOL_BF16_CONSISTENCY, the argmax equal where the top-2 gap is above
     twice the error, and on the weights widened to fp32 at TOL32 with an
     equal argmax; tokens/s, p50/p99 latency and time to first token, arena
     use, decode steps, prefill chunks, the device time of one decode step
     (after the run).
 10s. zamba2 serve smoke, card vs CPU (the main path of the fourteenth
     slice, zamba2 serving): SMOKE in fp32, the same numpy-seeded weights,
     a padded 40-token batch (a ragged SSD chunk), prefill and 4 decode
     steps, logits and every state leaf (S, conv_x, conv_bc, the shared
     block's keys and values) at TOL32; the prefill's launches (an fp32
     SSD forward a layer, an fp32 flash forward a shared-block call), none
     of the SSD or flash in a decode step; on the card prefill over p + 1
     tokens against prefill over p into a cache of capacity p + 1 and one
     decode step at p = ZAMBA2_SMOKE_P (token p opens a chunk), logits and
     state at TOL32.
 10t. full-width zamba2-1.2b serve: all 38 layers, bf16 weights made on the
     card, B 4, prompt 2000 padded to T 2064, 64 generated tokens through
     `repro_torch.launch.serve`: prefill ms, decode ms/token beside its byte
     bound (the weights, the 38 layers' SSD and conv states read and
     written, the 6 shared-block caches), device time of a decode step,
     peak memory; 38 SSD and 6 flash forwards a prefill on their bf16
     routes, none in a decode step, no backward and no fp32 route; the
     p+1 check at p = 2063 in bf16 (TOL_BF16_CONSISTENCY, the argmax where
     the top-2 gap is clear; a decode with the conv states dropped must
     fail) and on the weights widened to fp32 at TOL32.
 10u. xlstm kernels vs plain (the main path of the fifteenth slice,
     xlstm-1.3b, which runs no kernel of its own): rmsnorm at (8192,
     2048) and (8256, 2048) bf16, xent forward and backward at (8192,
     50304) fp32, AdamW at the 103,022,592-element embedding, each against
     its plain version with wall, device, plain and library ms and the
     bound.
 10v. xlstm smoke, card vs CPU: SMOKE fp32 on the same numpy-seeded
     weights: the loss and every gradient of one loss step at T 40 (a
     ragged mLSTM chunk) on the vanilla and the prefetch stack; prefill
     and 3 decode steps, logits and every state leaf (each mLSTM's C, n,
     m, conv; the sLSTM's h, c, n, m); all at TOL32; no flash or SSD
     launch.
 10w. full-width xlstm-1.3b training: all 48 layers, B4 T2048, bf16
     compute, fp32 storage, through `launch.train`'s Trainer (the prefetch
     stack, bf16 wire), XLSTM_TRAIN_STEPS timed steps, the last profiled:
     the readings of 8, MFU on `_xlstm_flops` (the projections, the
     chunkwise mLSTM's products, the sLSTM's recurrent products), the
     memory plan's modeled peak and step beside the measured, the host ms
     of the sLSTM loops a step (their forwards and their backwards, timed
     in the step); rmsnorm 3 a layer + 1, xent 1 + 1 and AdamW one a
     storage leaf a step, no flash and no SSD.
 10x. full-width xlstm-1.3b serve: all 48 layers, bf16 weights made on the
     card, B 4, prompt 2000 padded to T 2064, 64 generated tokens through
     `repro_torch.launch.serve`: prefill ms, decode ms/token beside its
     byte bound, device time of a decode step, peak memory, one rmsnorm a
     layer + 1 a call and no other kernel; the p+1 check at p = 2063 (a
     ragged last chunk of 15 rows) in bf16 on the weights of each of
     XLSTM_SEEDS (XLSTM_BF16_CONSISTENCY_REL of the logits' RMS, the
     argmax where the top-2 gap is clear; a decode with the conv states
     dropped must fail) and on all 48 layers widened to fp32 at TOL32;
     the bf16 residual stream against the fp32 one after every sub-block
     (and a control: the fp32 stream rounded to bf16 once); each sub-block
     of the first superblock in bf16 against fp32 on the same input
     (XLSTM_BLOCK_BF16_REL of the output's RMS); the cells' calls in the
     first superblock's bf16 prefill and decode step against the same
     calls on their inputs widened to fp32, bit for bit (XLSTM_PLANT, the
     cells' calls rounded to bf16, must fail).
 10y. encdec kernels vs plain (the main path of the sixteenth slice,
     seamless-m4t-large-v2, an encoder-decoder: hd 64, 16 heads on 16
     kv heads): rmsnorm at (4096, 1024), (8256, 1024) and (4128, 1024)
     bf16, xent forward and backward at (4096, 256208) fp32, AdamW at its
     262,356,992-element embedding; the bf16 flash forward at B4 S = T
     1024, non-causal (the encoder, the cross-attention) and causal (the
     decoder), and at the serve prefill's cross-attention B4 S2064 T1032,
     with FLASH_BF16_RMS_REL and its plants, beside SDPA and the bound;
     the flash backward (`flash_grad_case`) at B4 S = T 1024, non-causal
     and causal.
 10z. encdec smoke, card vs CPU: SMOKE fp32 on the same numpy-seeded
     weights: the loss and every gradient of one loss step at seq 32 (the
     encoder's leaves included) on the vanilla and the prefetch stack;
     prefill over 20 tokens and 10 frames and 3 decode steps, logits and
     both caches; on the card the p+1 check at p = 19, which a cross cache
     of the decoder's keys must fail; all at TOL32 on flash's fp32 routes.
 10aa. full-width seamless-m4t-large-v2 training: all 48 layers, B4 at seq
     2048 (1024 frames, 1024 target tokens), bf16 compute, fp32 storage,
     on the vanilla and on the prefetch stack: the readings of 8, MFU on
     `_encdec_flops`, the memory plan's modeled peak beside the measured,
     launches a step asserted (flash 72 / 144, its backward 72, rmsnorm
     122 / 242, xent 1 + 1, AdamW 26).
 10ab. full-width seamless-m4t-large-v2 serve: all 48 layers in bf16, B 4,
     prompt 2000 padded to T 2064 over 1032 seeded frames, 64 generated
     tokens through `repro_torch.launch.serve`: prefill ms, decode
     ms/token beside its byte bound, device time of a decode step, peak
     memory, launches a prefill (rmsnorm 122, flash 72) and a decode step
     (rmsnorm 73, no flash); the p+1 check at p = 2063 in bf16
     (ENCDEC_BF16_CONSISTENCY_REL of the logits' RMS; a cross cache of the
     decoder's keys, planted, must fail it) and on the weights widened to
     fp32 at TOL32.
 10ac. vlm kernels vs plain (the main path of the seventeenth slice,
     internvl2-26b: an image prefix of 1025 positions, GQA 48 on 8 heads):
     rmsnorm at d 6144 (training and prefill rows), xent at V 92560 with
     the image rows masked (their dlogits exactly 0), AdamW at the
     568,688,640-element embedding, the bf16 flash forward at a GQA group
     of 6 at the training shape (B2 T2048) and the prefill's (B4 T3089)
     with its plants, the flash backward at the training shape.
 10ad. vlm smoke, card vs CPU: SMOKE fp32 on the same numpy-seeded
     weights, loss and every gradient (the projector's too) on the vanilla
     and prefetch stacks; prefill over 8 images + 20 text tokens and 3
     decode steps from position 8 + 17; the p+1 check on the card with the
     reference launcher's decode position (no image offset) planted.
 10ae. full-width internvl2-26b training: every published width, 6 of 48
     layers (VLM_TRAIN_LAYERS), B2 at seq 2048 (1025 image positions +
     1023 text tokens), vanilla and prefetch: step ms, tokens/s, MFU
     (`_model_flops`, the projector over the image positions), peak against
     the modeled peak, busy share, launches a step.
 10af. full-width internvl2-26b serve: all 48 layers in bf16, B 4, 1025
     images + a 2000-token prompt padded to 2064 (a cell of 3089), 64
     generated tokens, decode from position 1025 + 2000: prefill ms, decode
     ms/token against its byte bound and its device time, peak, launches;
     the p+1 check at p = 2063 in bf16 (VLM_BF16_CONSISTENCY_REL of the
     logits' RMS, the decode at p planted), and on the first
     VLM_F32_LAYERS layers widened to fp32 at TOL32.
 11. a {"kernels": [...]} line, then {"ok": true, "device": {...}}.

TF32 is switched off for matmuls and cuDNN, so fp32 comparisons run in full
fp32.  Tolerances: TOL32 (rtol 2e-4, atol 2e-5) for fp32 and TOL (rtol 2e-2,
atol 2e-2) for bf16, those of tests/test_kernels.py; the full-width bf16
consistency check holds to an absolute 6e-2 (TOL_BF16_CONSISTENCY; 2e-1
for gemma2-27b's 46 layers, TOL_GEMMA2_BF16_CONSISTENCY; for
xlstm-1.3b's 48, XLSTM_BF16_CONSISTENCY_REL of the logits' RMS) and an
equal argmax; the bf16 flash outputs are also held to an RMS error of
FLASH_BF16_RMS_REL of the plain output's RMS, the bf16 ssd outputs to
SSD_BF16_RMS_REL and its bf16 gradients to SSD_BF16_GRAD_RMS_REL, the
bf16 flash gradients to FLASH_BF16_GRAD_RMS_REL; the fp32
ssd check at zamba2's layer shape applies TOL32's rtol to the summed |terms|
of each element (`check_terms`: 33.5M outputs of 128-term fp32 sums, some
cancelling), as do its final state and its fp32 gradients but dA and dD,
per-head sums over B*T held to TOL32 of their array's largest |value|
(`check_scaled`); the quant
kernels are held to zero difference; quantized
training runs that dither differently on the two devices are held to the
bounds of tests/dist_harness.py's quant case (QUANT_LOSS_RTOL, drift).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import re
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
# the same check on gemma2-27b at 46 layers, p = 8191 past its window,
# seeded weights: a sound build read 1.432e-1 and 1.380e-1 on two inputs,
# and 8.41e-2 on the first 12 layers, where the bf16 prefill is 7.78e-2
# from the fp32 one on the same weights (the fp32 paths agree to 2.2e-5):
# bf16 rounding through 46 layers with embeddings scaled by sqrt(4608).
# The limit keeps llama3's room above the readings; the decode step with
# its local layers unwindowed, a planted fault, reads 3.42 (NVIDIA H100
# 80GB HBM3, 700 W)
TOL_GEMMA2_BF16_CONSISTENCY = dict(rtol=0.0, atol=2e-1)
# bf16 flash attention, besides TOL: RMS of the error over RMS of the plain
# output.  A kernel that differs from the plain version only in the order of
# its fp32 sums rounds to the same bf16 almost everywhere: the tensor-core
# kernel read at most 1.6e-4 over this script's and the card tests' shapes
# (NVIDIA H100 80GB HBM3).  Rounding P to one bf16 part reads 1.7e-3 to
# 2.5e-3 at the same shapes, a dropped 128-key tile far more; TOL passes
# the first and, on long rows, can pass the second.
FLASH_BF16_RMS_REL = 5e-4
# bf16 SSD outputs, besides TOL: RMS of the error over RMS of the plain
# output, as for flash.  The kernels keep every fp32 operand in two bf16
# parts, so their y rounds to the plain version's bf16 almost everywhere:
# they read 0 to 8.3e-5 over this script's shapes.  M = (C B^T) o L o dt
# in one bf16 part reads 4.6e-4 to 2.5e-3 at the same shapes (lowest where
# dt is small and the D skip dominates y), the state not carried 1.4e-2;
# TOL passes both (NVIDIA H100 80GB HBM3).
SSD_BF16_RMS_REL = 2e-4
# bf16 SSD gradients dx, ddt, dB and dC at zamba2-1.2b's layer shape,
# besides TOL against autograd: RMS of the error over RMS of the plain
# reverse-pass backward's (`ref.ssd_chunked_bwd`, fp32 inside, one rounding
# to bf16).  Autograd through the plain version is no yardstick for this:
# it rounds dx twice in bf16 (its x dt and D x paths are cast before they
# are summed), 2.8e-3 from the reverse-pass backward.  The kernels read
# 4.4e-6 (ddt) to 1.1e-4 (dB); the reverse-pass backward with M and dM o L
# in one bf16 part 6.0e-4 (dx) to 2.6e-3 (dC), and TOL passes its dx
# (NVIDIA H100 80GB HBM3).
SSD_BF16_GRAD_RMS_REL = 3e-4
# bf16 flash gradients dq, dk and dv, besides TOL against autograd: RMS of
# the error over RMS of the plain reverse pass's (`ref.attention_bwd` on
# the forward's o and lse, fp32 inside, one rounding to bf16).  Autograd
# through the plain version rounds its bf16 output before the cotangent
# meets it, so it is no yardstick at this grain.  The one-pass backward
# kernel reads 9.1e-5 (dq) to 5.7e-4 (dv at qwen3-moe's group of 8: the
# longest sums) at this script's six bf16 shapes (the two-kernel one
# before it read 1.1e-4 to 4.4e-4 at three); P in one bf16 part reads
# 2.48e-3 to 2.51e-3 (dv), dS in one bf16 part 2.56e-3 to 2.63e-3 (dq,
# dk), and TOL passes both (NVIDIA H100 80GB HBM3, 700 W).  The limit
# sits between, ~1.8x above the kernel's highest reading.
FLASH_BF16_GRAD_RMS_REL = 1e-3
# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 rate and peak rates;
# PEAK_FLOPS for elementwise work (fp32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# matrix products: bf16 on the tensor cores; an fp32-accurate product at
# its cheapest is three TF32 products (hi*hi + hi*lo + lo*hi of operands
# split into TF32 hi + lo; one TF32 product misses fp32 tolerances), so
# 495 / 3 = 165 TFLOP/s
PRODUCT_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
B, PROMPT, GEN = 4, 2000, 64
T = PROMPT + GEN
# full-width training cell: qwen3-1.7b at the reference launcher's default
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 2048, 6
# quantized runs that dither differently: tests/dist_harness.py case_quant
QUANT_LOSS_RTOL, QUANT_LR = 5e-2, 1e-3


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


def device_ms(fn, bound, n=20):
    """Device ms per call of fn: CUDA events around n calls queued behind a
    sleep kernel (about 0.1 s), so that the host has issued every call
    before the first one runs and the reading holds none of the host's
    time.  Raises where the sleep ended before the host had issued the
    calls, or the reading falls below `bound`, the least time the calls'
    work can take on the card.  (torch.profiler's kernel events are not
    summed here: they lose launches, 15 of 20 flash calls in one window.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2 * 10 ** 8)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    ahead = not start.query()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    if not ahead or ms < bound:
        raise AssertionError(
            f"device reading {ms:.4f} ms against the bound {bound:.4f} ms"
            + ("" if ahead else "; the sleep ended before the host had "
               "issued the calls"))
    return ms


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


def check_terms(what, got, want, terms, tol):
    """`tol` with its rtol applied to `terms`, the sum of the absolute
    values of the terms that make up each element of `want`, in place of
    |want|: where a long fp32 sum cancels, any two summation orders differ
    by rounding of the terms, not of the result."""
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * terms.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((err <= lim).all())
    say(f"  {what}: max_abs_err {err.max().item():.3e}, max err / limit "
        f"{(err / lim).max().item():.3f} (rtol {tol['rtol']} of the summed "
        f"|terms|, atol {tol['atol']}); elementwise against |y|: "
        f"{'within' if torch.allclose(got, want, **tol) else 'outside'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: outside tolerance")
    return err.max().item()


def scaled(want):
    """The largest |value| of `want`, at least 1: the scale of a per-head
    sum over B*T (the SSD's dA and dD), as tests/test_torch_ssd.py's
    `_close` takes it."""
    return max(1.0, want.float().abs().max().item())


def check_scaled(what, got, want, tol):
    """`tol` on got and want divided by `scaled(want)`."""
    s = scaled(want)
    return s * check_close(f"{what} / max|want|", got.float() / s,
                           want.float() / s, tol)


def check_rejects(what, planted, want, tol):
    """A planted wrong result must fail the check that `want`'s kernel
    passed: the check then depends on the term the plant leaves out."""
    if torch.allclose(planted.float(), want.float(), **tol):
        raise AssertionError(f"{what}: the check cannot tell it apart")
    say(f"  {what}: rejected (max abs err {max_err(planted, want):.3e})")


def check_rejects_terms(what, planted, want, terms, tol):
    """A planted wrong result must fail `check_terms` at `tol`."""
    err = (planted.float() - want.float()).abs()
    ratio = (err / (tol["atol"] + tol["rtol"] * terms.float().abs())).max()
    if ratio <= 1:
        raise AssertionError(f"{what}: the check cannot tell it apart")
    say(f"  {what}: rejected (max err / limit {ratio.item():.3f}, max abs "
        f"err {err.max().item():.3e})")


def rms_rel(got, want):
    """RMS of got - want over the RMS of want."""
    e, w = got.float() - want.float(), want.float()
    return (e.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()).item()


def check_rms(what, got, want, limit):
    """A bf16 output: TOL, and an RMS error of `limit` of the plain
    output's (FLASH_BF16_RMS_REL, SSD_BF16_RMS_REL)."""
    err = check_close(what, got, want, TOL)
    rel = rms_rel(got, want)
    say(f"    RMS error / RMS {rel:.3e} (limit {limit}) "
        f"{'ok' if rel <= limit else 'FAIL'}")
    if rel > limit:
        raise AssertionError(f"{what}: RMS error {rel:.3e} of the output's")
    return err


def check_plant_rejected(what, planted, want, limit):
    """A planted bf16 result must fail TOL or the RMS limit."""
    rel = rms_rel(planted, want)
    within = torch.allclose(planted.float(), want.float(), **TOL)
    if within and rel <= limit:
        raise AssertionError(f"{what}: the check cannot tell it apart "
                             f"(RMS error / RMS {rel:.3e})")
    say(f"    planted {what}: rejected (RMS error / RMS {rel:.3e}, max abs "
        f"err {max_err(planted, want):.3e}, "
        f"{'within' if within else 'outside'} TOL)")


def flash_plants(q, k, v, causal=True, window=None, softcap=None,
                 q_scale=None):
    """The plain attention with a planted fault: P rounded to one bf16 part
    before P V, and (where T > 256) the keys of one 128-key tile in the
    middle left out."""
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    scale = q_scale if q_scale is not None else hd ** -0.5
    qg = q.float().reshape(B, S, Kh, H // Kh, hd) * scale
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pq = torch.arange(S, device=q.device)[:, None]
    pk = torch.arange(T, device=q.device)[None, :]
    keep = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        keep &= pk <= pq
    if window:
        keep &= pq - pk < window
    s_kept = s.masked_fill(~keep, -float("inf"))
    p = torch.exp(s_kept - s_kept.amax(-1, True))
    out = {"P in one bf16 part": p.to(torch.bfloat16).float()
           / p.sum(-1, True)}
    if T > 256:
        t0 = 128 * (T // 256)
        drop = keep.clone()
        drop[:, t0:t0 + 128] = False
        out[f"keys {t0}..{t0 + 127} dropped"] = torch.softmax(
            s.masked_fill(~drop, -1e30), dim=-1)
    return {n: torch.einsum("bkgst,btkh->bskgh", pp, v.float())
            .reshape(B, S, H, hd).to(q.dtype) for n, pp in out.items()}


def check_flash_plants(what, q, k, v, want, **kw):
    """Each planted fault must fail TOL or FLASH_BF16_RMS_REL."""
    for name, planted in flash_plants(q, k, v, **kw).items():
        check_plant_rejected(f"{what}, {name}", planted, want,
                             FLASH_BF16_RMS_REL)


def ssd_one_part_m(x, dt, A, Bm, Cm, D, chunk):
    """The plain SSD with a planted fault: the intra-chunk matrix M = (C
    B^T) o L o dt_s rounded to one bf16 part before its product with x (the
    kernels split it into bf16 hi + lo)."""
    from repro_torch.kernels.ssd import ref as ssd_ref
    T = x.shape[1]
    xc, dtc, Bh, Ch, cum = ssd_ref._chunks(x, dt, A, Bm, Cm, chunk)
    Lc = xc.shape[2]
    states, _ = ssd_ref.ssd_chunk_states(x, dt, A, Bm, Cm, chunk)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri[:, :, None],
                              cum[:, :, :, None] - cum[:, :, None],
                              float("-inf")))
    M = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh) * L * dtc[:, :, None]
    y = torch.einsum("bctsh,bcshp->bcthp", M.bfloat16().float(), xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcthn,bhcpn->bcthp", Ch, states)
    y = y.reshape(x.shape[0], -1, *x.shape[2:])[:, :T]
    return (y + x.float() * D[None, None, :, None]).to(x.dtype)


def per_g(dx, g):
    """dlogits with each row divided by |its cotangent|: ±(softmax −
    onehot), so every softmax term meets the tolerance at its own size."""
    return dx.float() / g.float().abs()[:, None]


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
    say("kernels (ptxas -v: registers a thread, static shared memory, "
        "spill stores / loads in bytes):")
    spilled = []
    for name, regs, smem, spills in _kernel_resources(lib.log):
        say(f"  {name}: {regs} registers, {smem} B static smem, spills "
            f"{spills[0]} / {spills[1]}")
        if any(spills) and ("flash" in name or "rmsnorm" in name):
            spilled.append(name)
    smem = lib.cdll.flash_attention_bwd_sm90_smem
    smem.restype = ctypes.c_int
    say("  flash_bwd_sm90_kernel dynamic shared memory a block: " + ", ".join(
        f"hd {hd} {smem(hd)} B" for hd in (16, 32, 64, 128)))
    if spilled:
        raise AssertionError(f"the flash or rmsnorm kernels spill: {spilled}")


def _kernel_resources(log):
    """(kernel, registers, static smem bytes, (spill stores, spill loads))
    for every entry function in an nvcc -Xptxas -v log."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            short = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_\d+_", "", name)
            out.append((short, int(m.group(1)), int(m.group(2) or 0), spills))
            name, spills = None, (0, 0)
    return out


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
        on_card = device_ms(lambda: rms_ops.rmsnorm(x, w, 1e-5, uo), bound)
        say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} "
            f"({nbytes / ms / 1e6:.0f} GB/s); device {_ms(on_card)}")
        if i == 0:
            state["rmsnorm"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                library_ms=lib)

    say("flash kernel vs plain (ms: kernel / plain / SDPA / bound; the "
        "kernel's and SDPA's device time, and wall - device, the host's "
        "share):")
    flash_cases = [  # (name, B, S, H, Kh, hd, dtype, kwargs, sdpa)
        (f"prefill B{B} T{T} H32 Kh8 hd128 causal bf16", B, T, 32, 8, 128,
         torch.bfloat16, dict(causal=True), True),
        (f"B{TRAIN_B} T{TRAIN_T} H32 Kh32 hd128 causal bf16 (zamba2-1.2b's "
         "shared attention)", TRAIN_B, TRAIN_T, 32, 32, 128,
         torch.bfloat16, dict(causal=True), True),
        ("B2 T1000 H8 Kh2 hd128 window 256 softcap 50 bf16", 2, 1000, 8, 2,
         128, torch.bfloat16, dict(causal=True, window=256, softcap=50.0),
         False),
        ("B2 T777 H8 Kh8 hd64 non-causal fp32", 2, 777, 8, 8, 64,
         torch.float32, dict(causal=False), True),
        ("B2 T300 H4 Kh2 hd16 causal fp32", 2, 300, 4, 2, 16,
         torch.float32, dict(causal=True), True),
        ("B2 T300 H4 Kh4 hd32 causal fp32 (zamba2 smoke's shared block)", 2,
         300, 4, 4, 32, torch.float32, dict(causal=True), True),
        ("B2 T300 H4 Kh4 hd32 causal bf16", 2, 300, 4, 4, 32,
         torch.bfloat16, dict(causal=True), True),
    ]
    for i, (name, b, s, h, kh, hd, dt, kw, sdpa) in enumerate(flash_cases):
        q = randn(b, s, h, hd, dtype=dt)
        k = randn(b, s, kh, hd, dtype=dt)
        v = randn(b, s, kh, hd, dtype=dt)
        want = flash_ref.attention(q, k, v, **kw)
        got = flash_ops.flash_attention(q, k, v, **kw)
        if dt == torch.float32:
            err = check_close(name, got, want, TOL32)
            if i == 3:
                # the planted fault: one TF32 product (hi*hi) in place of
                # three must miss TOL32
                check_rejects(f"{name} planted: one TF32 product",
                              flash_ops.flash_attention_cuda(
                                  q, k, v, kw["causal"], None, None, None,
                                  tf32_products=1), want, TOL32)
        else:
            err = check_rms(name, got, want, FLASH_BF16_RMS_REL)
            check_flash_plants(name, q, k, v, want, **kw)
        del got, want
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
        bound, by = _bound(nbytes, flops, dt, products=True)
        fwd = lambda: flash_ops.flash_attention(q, k, v, **kw)
        ms = time_ms(fwd)
        on_card = device_ms(fwd, bound)
        plain = time_ms(lambda: flash_ref.attention(q, k, v, **kw))
        lib = lib_dev = None
        if sdpa:
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            sdpa_fn = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
            lib = time_ms(sdpa_fn)
            lib_dev = device_ms(sdpa_fn, bound)
        route = ("wgmma, flash_attention_sm90.cu" if dt == torch.bfloat16
                 else "TF32 mma.sync x3, flash_attention.cu")
        say(f"    {ms:.4f} / {plain:.4f} / {_ms(lib)} / {bound:.4f} ({by}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s; {route}); device {_ms(on_card)}"
            f", SDPA device {_ms(lib_dev)}; wall - device "
            f"{_ms(None if on_card is None else ms - on_card)}")
        # the prefill case for the bf16 route, the first fp32 case for the
        # fp32 route
        key = "flash" if i == 0 else "flash_f32" if i == 3 else None
        if key:
            state[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, device_ms=on_card,
                library_device_ms=lib_dev)

    # strided inputs: q/k/v as head slices of one packed projection
    q, k, v = randn(2, 515, 32 + 2 * 8, 128, dtype=torch.bfloat16).split(
        [32, 8, 8], dim=2)
    check_rms("strided q/k/v slices of a packed (B,T,48,128) bf16",
              flash_ops.flash_attention(q, k, v),
              flash_ref.attention(q, k, v), FLASH_BF16_RMS_REL)
    # a stride TMA cannot read must raise, not fall back
    wide = randn(2, 64, 8, 138, dtype=torch.bfloat16)[..., :128]
    try:
        flash_ops.flash_attention(wide, wide[:, :, :2], wide[:, :, :2])
    except ValueError as e:
        if "TMA" not in str(e):
            raise
        say("  bf16 q/k/v with a head stride of 138 elements: rejected")
    else:
        raise AssertionError("a bf16 input TMA cannot read was taken")


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def _bound(nbytes, flops, dtype=torch.float32, products=False):
    """(least ms, what bounds it) for `nbytes` moved and `flops` done:
    elementwise FLOPs at PEAK_FLOPS, matrix products at PRODUCT_FLOPS."""
    rate = (PRODUCT_FLOPS if products else PEAK_FLOPS)[dtype]
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes"


def _grads(fn, inputs, ct):
    inputs = [a.detach().requires_grad_() for a in inputs]
    out = fn(*inputs)
    return (out, *torch.autograd.grad(out, inputs, ct))


def flash_grad_case(state, key, what, b, s, h, kh, hd, kw, dtype, g,
                    by_heads=False):
    """The flash backward kernels at one shape of a training path, inputs
    from generator `g`:
      * kernel forward + kernel backward (one launch each, counted) against
        autograd through the plain version: TOL (fp32: TOL32), the bf16
        output also to FLASH_BF16_RMS_REL;
      * the forward's row lse against `ref.attention_lse` at TOL32;
      * the backward alone on the forward's o and lse, two calls
        bit-identical, against the plain reverse pass `ref.attention_bwd`:
        bf16 at TOL and FLASH_BF16_GRAD_RMS_REL, which each of
        `ref.PLANTS` must fail; fp32 at TOL32, which the kernel with one
        TF32 product must miss;
      * ms: fwd + bwd (op / plain / SDPA / bound, as before this kernel),
        and the backward alone (wall, device behind the sleep kernel, the
        plain reverse pass, SDPA's backward, the bound: 2.5 forward
        products' FLOPs).
    `by_heads`: the plain versions two kv heads at a time (T 8192).  SDPA
    takes no softcap: under one it is timed without.  Stores state[key]."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v, ct = randn(b, s, h, hd), randn(b, s, kh, hd), \
        randn(b, s, kh, hd), randn(b, s, h, hd)
    bf16 = dtype == torch.bfloat16
    tol = TOL if bf16 else TOL32

    def plain(fn, *q_like):
        return _by_kv_heads(fn, q, k, v, *q_like) if by_heads \
            else fn(q, k, v, *q_like)

    n = (flash_ops.launches, flash_ops.launches_f32, flash_ops.bwd_launches,
         flash_ops.bwd_launches_f32)
    op = lambda: _grads(lambda *a: flash_ops.flash_attention(*a, **kw),
                        (q, k, v), ct)
    got = op()
    routes = (flash_ops.launches - n[0], flash_ops.launches_f32 - n[1],
              flash_ops.bwd_launches - n[2],
              flash_ops.bwd_launches_f32 - n[3])
    if routes != ((1, 0, 1, 0) if bf16 else (0, 1, 0, 1)):
        raise AssertionError(f"{what}: launches (fwd, fwd_f32, bwd, bwd_f32)"
                             f" {routes}, want one of each on the "
                             f"{dtype} route")
    plain_grads = lambda: plain(lambda qq, kk, vv, cc: _grads(
        lambda *a: flash_ref.attention(*a, **kw), (qq, kk, vv), cc), ct)
    want = plain_grads()
    err = max((check_rms if bf16 else check_close)(
        f"{what} o", got[0], want[0],
        FLASH_BF16_RMS_REL if bf16 else TOL32),
        *(check_close(f"{what} {n_} vs autograd through the plain version",
                      a, b_, tol)
          for n_, a, b_ in zip(("dq", "dk", "dv"), got[1:], want[1:])))
    del got
    o, lse = flash_ops.flash_attention_cuda(
        q, k, v, kw.get("causal", True), kw.get("window"), kw.get("softcap"),
        kw.get("q_scale"), with_lse=True)
    check_close(f"{what} lse", lse, plain(
        lambda qq, kk, vv: flash_ref.attention_lse(qq, kk, **kw)
        .transpose(1, 2)).transpose(1, 2), TOL32)

    bwd = lambda: flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct,
                                                     **kw)
    if bf16:
        *got, counts = flash_ops.flash_attention_bwd_cuda(
            q, k, v, o, lse, ct, with_counts=True, **kw)
        want_counts = torch.tensor(
            [len(x) for x in flash_ops.bwd_schedule(
                s, s, kw.get("causal", True), kw.get("window"))],
            dtype=torch.int32, device=dev).expand(b, h, -1)
        if not torch.equal(counts, want_counts):
            raise AssertionError(f"{what}: the dQ tiles' counts of partials "
                                 "differ from ops.bwd_schedule's")
        say(f"  {what}: every dQ tile took the {int(want_counts.sum())} "
            "key-block partials ops.bwd_schedule lists, in its order")
        del counts, want_counts
    else:
        got = bwd()
    again = bwd()
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError(f"{what}: two backward calls differ")
    say(f"  {what}: two backward calls bit-identical")
    del again
    oracle = lambda plant=None: plain(
        lambda qq, kk, vv, oo, ll, cc: flash_ref.attention_bwd(
            qq, kk, vv, oo, ll.transpose(1, 2), cc, plant=plant, **kw),
        o, lse.transpose(1, 2), ct)
    ref_bwd = oracle()
    names = ("dq", "dk", "dv")
    if bf16:
        err_ref = max(check_rms(f"{what} {n_} vs the plain reverse pass", a,
                                b_, FLASH_BF16_GRAD_RMS_REL)
                      for n_, a, b_ in zip(names, got, ref_bwd))
        for plant in flash_ref.PLANTS:
            planted = oracle(plant)
            out = [(n_, rms_rel(a, b_), torch.allclose(
                a.float(), b_.float(), **TOL))
                for n_, a, b_ in zip(names, planted, ref_bwd)]
            caught = [n_ for n_, rel, within in out
                      if rel > FLASH_BF16_GRAD_RMS_REL or not within]
            say(f"    planted {plant}: RMS error / RMS "
                + ", ".join(f"{n_} {rel:.3e}{'' if within else ' (outside TOL)'}"
                            for n_, rel, within in out)
                + (f"; rejected by {caught}" if caught else "; NOT rejected"))
            if not caught:
                raise AssertionError(f"{what}: the check cannot tell the "
                                     f"plant {plant!r} apart")
            del planted
    else:
        err_ref = max(check_close(f"{what} {n_} vs the plain reverse pass",
                                  a, b_, TOL32)
                      for n_, a, b_ in zip(names, got, ref_bwd))
        one = flash_ops.flash_attention_bwd_cuda(q, k, v, o, lse, ct,
                                                 tf32_products=1, **kw)
        if all(torch.allclose(a, b_, **TOL32)
               for a, b_ in zip(one, want[1:])):
            raise AssertionError(f"{what}: one TF32 product holds TOL32")
        say(f"    planted one TF32 product: rejected (max abs err "
            f"{max(max_err(a, b_) for a, b_ in zip(one, want[1:])):.3e})")
        del one
    del got, want, ref_bwd
    torch.cuda.empty_cache()

    if kw.get("causal", True):
        pairs = _attn_pairs(s, kw.get("window"))
    elif kw.get("window") is None:
        pairs = s * s
    else:
        raise ValueError("no pair count for a non-causal window")
    flops = 4.0 * hd * b * h * pairs
    bound, by = _bound(0, 3.5 * flops, dtype, products=True)
    ms, plain_ms = time_ms(op), time_ms(plain_grads)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    sdpa = _sdpa_fn(*leaves, kw.get("window"), kw.get("q_scale"),
                    causal=kw.get("causal", True))
    ctt = ct.transpose(1, 2)
    lib = time_ms(lambda: sdpa().backward(ctt))
    say(f"  {what} fwd+bwd ms: op {ms:.4f} / plain {plain_ms:.4f} / SDPA "
        f"{lib:.4f} / bound {bound:.4f} ({3.5 * flops / ms / 1e9:.1f} "
        "TFLOP/s)")
    bwd_bound, bwd_by = _bound(0, 2.5 * flops, dtype, products=True)
    bwd_ms, bwd_dev = time_ms(bwd), device_ms(bwd, bwd_bound, n=10)
    bwd_plain = time_ms(oracle)
    so = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(so, leaves, ctt,
                                           retain_graph=True)
    lib_bwd, lib_bwd_dev = time_ms(sdpa_bwd), device_ms(sdpa_bwd, bwd_bound,
                                                         n=10)
    say(f"  {what} backward alone ms: kernels {bwd_ms:.4f} (device "
        f"{bwd_dev:.4f}, {2.5 * flops / bwd_dev / 1e9:.1f} TFLOP/s) / plain "
        f"reverse pass {bwd_plain:.4f} / SDPA's backward {lib_bwd:.4f} "
        f"(device {lib_bwd_dev:.4f}) / bound {bwd_bound:.4f} ({bwd_by}); "
        f"device / SDPA's {bwd_dev / lib_bwd_dev:.2f}x")
    state[key] = dict(
        shape=f"B{b} T{s} H{h} Kh{kh} hd{hd} {kw} {dtype}".replace(
            "torch.", ""),
        max_abs_err=err_ref, max_abs_err_vs_autograd=err, ms=bwd_ms,
        device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
        library_device_ms=lib_bwd_dev, library="SDPA's backward"
        + (", no softcap" if kw.get("softcap") else ""), bound_ms=bwd_bound,
        bound_by=bwd_by, tflops=2.5 * flops / bwd_dev / 1e9,
        fwd_bwd=dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                     bound_ms=bound))
    del so, sdpa, leaves, o, lse, q, k, v, ct
    torch.cuda.empty_cache()


def phase_train_kernels(state):
    import torch.nn.functional as F
    from repro_torch.core.dist import DistConfig
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.adamw import ref as adamw_ref
    from repro_torch.kernels.cross_entropy import ops as xent_ops
    from repro_torch.kernels.cross_entropy import ref as xent_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.models.registry import get_arch
    from repro_torch.models.runtime import model_abstract_storage
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    R, V = TRAIN_B * TRAIN_T, 151_936
    say("xent kernels vs plain (ms: kernel / plain / F.cross_entropy / "
        "bound):")
    for i, (name, r, v, dt) in enumerate([
            (f"training logits ({R}, {V}) fp32", R, V, torch.float32),
            ("odd 9 x 5000 bf16", 9, 5000, torch.bfloat16)]):
        x = randn(r, v, dtype=dt) * 3
        t = torch.randint(0, v, (r,), device=dev, generator=g)
        gr = randn(r) / r
        loss, lse = xent_ops.xent_fwd_cuda(x, t)
        want_loss, want_lse = xent_ref.xent(x, t)
        err_f = max(check_close(f"{name} loss", loss, want_loss, TOL32),
                    check_close(f"{name} lse", lse, want_lse, TOL32))
        ms_f = time_ms(lambda: xent_ops.xent_fwd_cuda(x, t))
        plain_f = time_ms(lambda: xent_ref.xent(x, t))
        lib_f = time_ms(lambda: F.cross_entropy(x, t, reduction="none"))
        # read the logits once and the targets, write loss and lse;
        # ~4 fp32 operations an element (max, subtract, exp, add)
        bound_f, by_f = _bound(x.numel() * x.element_size() + 16 * r,
                               4.0 * x.numel())
        say(f"    fwd {ms_f:.4f} / {plain_f:.4f} / {lib_f:.4f} / "
            f"{bound_f:.4f} ({x.numel() * x.element_size() / ms_f / 1e6:.0f}"
            " GB/s)")
        # rows held as dlogits / |g|: at the path's g of about 1/R every
        # raw softmax term would sit below the absolute tolerance
        tol = TOL32 if dt == torch.float32 else TOL
        want_dx = per_g(xent_ref.dlogits(x, t, want_lse, gr), gr)
        err_b = check_close(f"{name} dlogits / |g|", per_g(
            xent_ops.xent_bwd_cuda(x, t, lse, gr), gr), want_dx, tol)
        onehot_only = torch.zeros_like(x).scatter_(
            1, t[:, None], -gr[:, None].to(dt))
        check_rejects(f"{name} planted -onehot*g", per_g(onehot_only, gr),
                      want_dx, tol)
        del want_dx, onehot_only
        ms_b = time_ms(lambda: xent_ops.xent_bwd_cuda(x, t, lse, gr))
        plain_b = time_ms(lambda: xent_ref.dlogits(x, t, lse, gr))
        # read the logits, write dlogits; ~5 operations an element
        bound_b, by_b = _bound(2 * x.numel() * x.element_size() + 16 * r,
                               5.0 * x.numel())
        say(f"    bwd {ms_b:.4f} / {plain_b:.4f} / n/a / {bound_b:.4f} "
            f"({2 * x.numel() * x.element_size() / ms_b / 1e6:.0f} GB/s)")
        if i == 0:
            state["xent_fwd"] = dict(max_abs_err=err_f, ms=ms_f,
                                     plain_ms=plain_f, bound_ms=bound_f,
                                     bound_by=by_f, library_ms=lib_f)
            state["xent_bwd"] = dict(max_abs_err=err_b, ms=ms_b,
                                     plain_ms=plain_b, bound_ms=bound_b,
                                     bound_by=by_b, library_ms=None)
        del x, loss, lse, want_loss, want_lse
        torch.cuda.empty_cache()

    _, model = get_arch("qwen3_1_7b")
    largest = max(a.numel() for a in _leaves(model_abstract_storage(
        model, DistConfig())))
    say("adamw kernel vs plain (ms: kernel / plain / AdamW(fused=True) / "
        "bound):")
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    for i, n in enumerate((largest, 5000)):
        p, gd, m = randn(n), randn(n), randn(n) * 0.1
        v = randn(n).abs() * 0.01
        step = torch.tensor(7, dtype=torch.int32, device=dev)
        scale = torch.tensor(0.5, device=dev)
        # the update dp = p_new - p is held, not p_new: beside |p| ~ 1 the
        # decay term lr*wd*p would hide inside the tolerance.  The path's
        # lr 3e-4, wd 0.1, then lr 1e-2, wd 1, where a kernel that dropped
        # the decay would be off by 1e-2*|p|
        for lr_f, wd in ((3e-4, 0.1), (1e-2, 1.0)):
            lr = torch.tensor(lr_f, device=dev)
            kw = dict(hyper, wd=wd, lr=lr, t=step, scale=scale)
            want = adamw_ref.adamw_update(p, gd, m, v, **kw)
            got = [a.clone() for a in (p, m, v)]
            adamw_ops.adamw_update(got[0], gd, got[1], got[2], **kw)
            errs = [check_close(f"adamw n={n} lr {lr_f} wd {wd} dp",
                                got[0] - p, want[0] - p, TOL32)]
            errs += [check_close(f"adamw n={n} lr {lr_f} wd {wd} {k}", a, b,
                                 TOL32)
                     for k, a, b in zip("mv", got[1:], want[1:])]
            if wd == 0.1:
                err = max(errs)
            else:
                no_decay = adamw_ref.adamw_update(p, gd, m, v,
                                                  **dict(kw, wd=0.0))
                check_rejects(f"adamw n={n} planted update without decay",
                              no_decay[0] - p, want[0] - p, TOL32)
                del no_decay
            del want, got
        lr = torch.tensor(3e-4, device=dev)
        got = [a.clone() for a in (p, m, v)]
        ms = time_ms(lambda: adamw_ops.adamw_update(
            got[0], gd, got[1], got[2], lr=lr, t=step, scale=scale,
            **hyper))
        plain = time_ms(lambda: adamw_ref.adamw_update(
            p, gd, m, v, lr=lr, t=step, scale=scale, **hyper))
        q = p.clone().requires_grad_()
        q.grad = gd
        opt = torch.optim.AdamW([q], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
        lib = time_ms(opt.step)
        # p, g, m, v read once, p, m, v written once; ~15 operations each
        bound, by = _bound(28 * n, 15.0 * n)
        say(f"    n={n}: {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} "
            f"({28 * n / ms / 1e6:.0f} GB/s)")
        if i == 0:
            state["adamw"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=lib)
        del p, gd, m, v, got, q, opt
        torch.cuda.empty_cache()

    say("rmsnorm gradients: kernel forward + plain backward vs autograd "
        "through the plain version (ms fwd+bwd: op / plain / library / "
        "bound):")
    x = randn(R, 2048, dtype=torch.bfloat16) * 2
    w = randn(2048, dtype=torch.bfloat16)
    ct = randn(R, 2048, dtype=torch.bfloat16)
    got = _grads(lambda a, b: rms_ops.rmsnorm(a, b, 1e-5), (x, w), ct)
    want = _grads(lambda a, b: rms_ref.rmsnorm(a, b, 1e-5), (x, w), ct)
    err = max(check_close(f"rmsnorm ({R}, 2048) bf16 {k}", a, b, TOL)
              for k, a, b in zip(("y", "dx", "dw"), got, want))
    ms = time_ms(lambda: _grads(lambda a, b: rms_ops.rmsnorm(a, b, 1e-5),
                                (x, w), ct))
    plain = time_ms(lambda: _grads(lambda a, b: rms_ref.rmsnorm(a, b, 1e-5),
                                   (x, w), ct))
    lib = time_ms(lambda: _grads(lambda a, b: F.rms_norm(a, (2048,), b, 1e-5),
                                 (x, w), ct))
    # forward reads x, writes y; backward reads x and ct, writes dx
    bound, _ = _bound(5 * x.numel() * 2, 12.0 * x.numel())
    say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f}")
    state["rmsnorm_grad"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 library_ms=lib, bound_ms=bound)
    del x, w, ct, got, want

    say("flash backward kernels (kernel forward + kernel backward) at "
        "qwen3-1.7b's layer shape, and the fp32 route at the main fp32 "
        "shape:")
    flash_grad_case(state, "flash_bwd", f"flash B{TRAIN_B} T{TRAIN_T} H16 "
                    "Kh8 hd128 causal bf16", TRAIN_B, TRAIN_T, 16, 8, 128,
                    dict(causal=True), torch.bfloat16, g)
    flash_grad_case(state, "flash_bwd_f32", "flash B2 T777 H8 Kh8 hd64 "
                    "non-causal fp32", 2, 777, 8, 8, 64, dict(causal=False),
                    torch.float32, g)


def _codec_input(n, dtype, seed):
    """A wire buffer on the card: random values, an all-zero first chunk
    and, where n allows, a chunk with absmax 127 holding int8 ties k + 0.5
    at scale 1.0 and one with absmax 448 holding e4m3 ties (1.0625, 17,
    ...); both hold values at exactly +-QMAX * scale."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 3
    c = 128
    x[:c] = 0
    if n >= 3 * c:
        x[c:c + 20] = torch.arange(-10, 10, device="cuda") + 0.5
        x[c + 20], x[c + 21] = 127.0, -127.0
        x[2 * c:2 * c + 6] = torch.tensor(
            [448.0, -448.0, 1.0625, -17.0, 0.5 + 2 ** -5, 208.0],
            device="cuda")
    return x.to(dtype)


def _bits(a):
    return a.float().view(torch.int32)


def check_exact(what, got, want):
    """Zero difference, bit for bit (as int32 patterns of the f32 values,
    or as bytes of the wire values)."""
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {want.numel()} differ")


def check_rejects_exact(what, planted, want):
    bad = int((planted != want).sum())
    if not bad:
        raise AssertionError(f"{what}: the exact check cannot tell it apart")
    say(f"  {what}: rejected ({bad} of {want.numel()} values differ)")


def _largest_bucket(dcfg):
    """The param metas of the largest bucket of the full-width prefetch
    path (qwen3-1.7b, block buckets split at the segments)."""
    from repro_torch.core.bucketing import plan_for, split_plan_at_segments
    from repro_torch.core.meta import named_leaves
    from repro_torch.models.registry import get_arch
    _, model = get_arch("qwen3_1_7b")
    tree = model.block_metas(dcfg)
    metas = [m for _, m in named_leaves(tree)]
    plan = split_plan_at_segments(plan_for(tree, dcfg), tree,
                                  model.block_segments(dcfg))
    return max(([metas[i] for i in g] for g in plan.index_groups(tree)),
               key=lambda ms: sum(m.chunk_len(dcfg) for m in ms))


def _quant_sizes():
    """(largest bucket of the full-width prefetch path, largest storage
    leaf = the error-feedback hop's largest call), in elements."""
    from repro_torch.core.dist import DistConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.models.runtime import model_abstract_storage
    _, model = get_arch("qwen3_1_7b")
    dcfg = DistConfig(comm_precision="fp8_ef")
    bucket = sum(m.chunk_len(dcfg) for m in _largest_bucket(dcfg))
    leaf = max(a.numel() for a in _leaves(model_abstract_storage(model,
                                                                dcfg)))
    return bucket, leaf


def _codec_case(what, x, codec, sr):
    """The quant and dequant kernels against the plain version, bit for bit:
    wire bytes, scales, decoded values and, under SR, the seed the launch
    used against `ref.buffer_seed`.  Returns the largest |kernel - plain|
    of quant (wire values, scales) and of dequant."""
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    n = x.numel()
    seed = torch.empty(1, dtype=torch.int32, device="cuda") if sr else None
    q, sc = qops.quantize_cuda(x, codec, sr, seed_out=seed)
    wq, ws = qref.quantize(x, codec, sr)
    check_exact(f"{what} wire bytes", q.view(torch.uint8),
                wq.view(torch.uint8))
    check_exact(f"{what} scales", _bits(sc), _bits(ws))
    if sr:
        check_exact(f"{what} SR seed", torch.tensor(
            int(seed.item()) & qref.M32), torch.tensor(
            int(qref.buffer_seed(qref.chunk(x)[0]))))
    out = qops.dequantize_cuda(q, sc, n, x.shape, x.dtype)
    want = qref.dequantize(wq, ws, n, x.shape, x.dtype)
    check_exact(f"{what} decoded", _bits(out), _bits(want))
    return max(max_err(q, wq), max_err(sc, ws)), max_err(out, want)


def phase_quant_kernels(state):
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    bucket, leaf = _quant_sizes()
    edge = {dt: qops.sr_seed_pass(dt) for dt in (torch.float32,
                                                  torch.bfloat16)}
    say(f"quant / dequant kernels vs plain, exact (largest bucket {bucket}, "
        f"largest error-feedback leaf {leaf} elements; one pass of the SR "
        f"seed kernel's grid covers {edge[torch.float32]} f32 / "
        f"{edge[torch.bfloat16]} bf16 elements):")
    # the largest |kernel - plain| over every case: wire values and scales
    # for quant, decoded values for dequant (the exact checks raise on
    # any bit of difference)
    cases, err_q, err_d = 0, 0.0, 0.0
    for dt in (torch.float32, torch.bfloat16):
        c = edge[dt]
        inputs = [(f"n={n}", _codec_input(n, dt, seed=n % 9973))
                  for n in (129, 5000, bucket, c - 128, c - 1, c, c + 1,
                            c + 128)]
        # one element past a 16-byte boundary: the element loads
        inputs.append(("n=5000 at a 1-element offset",
                       _codec_input(5001, dt, seed=5)[1:]))
        for label, x in inputs:
            for codec in qref.CODECS:
                for sr in (False, True):
                    eq, ed = _codec_case(f"{label} {str(dt)[6:]} {codec} "
                                         f"{'SR' if sr else 'RTN'}", x,
                                         codec, sr)
                    err_q, err_d = max(err_q, eq), max(err_d, ed)
                    cases += 1
        del inputs, x
    say(f"  {cases} cases (n = 129, 5000, the largest bucket, one pass of "
        "the seed grid -128, -1, 0, +1, +128, and a misaligned view; f32 / "
        "bf16 x fp8 / int8 x RTN / SR): wire bytes, scales, decoded values "
        "and SR seeds equal the plain version bit for bit")
    x = _codec_input(leaf, torch.float32, seed=1)
    q, sc = qops.quantize_cuda(x, "fp8", False)
    wq, ws = qref.quantize(x, "fp8", False)
    check_exact(f"n={leaf} f32 fp8 RTN wire bytes", q.view(torch.uint8),
                wq.view(torch.uint8))
    check_exact(f"n={leaf} f32 fp8 RTN scales", _bits(sc), _bits(ws))
    err_q = max(err_q, max_err(q, wq), max_err(sc, ws))
    say(f"  the error-feedback leaf (n={leaf}, f32 fp8 RTN): equal")
    say(f"  max abs err over every case: quant {err_q:.3e}, dequant "
        f"{err_d:.3e}")
    del x, q, sc, wq, ws
    torch.cuda.empty_cache()

    # planted wrong results: the exact check must see each
    x = _codec_input(bucket, torch.float32, seed=2)
    got = qops.roundtrip(x, "fp8", True)
    want = qref.roundtrip(x, "fp8", True)
    check_exact("fp8 SR round trip", _bits(got), _bits(want))
    check_rejects_exact("planted RTN in place of SR",
                        _bits(qref.roundtrip(x, "fp8", False)), _bits(want))
    x2, _ = qref.chunk(x)
    one_scale = torch.full_like(x2[:, :1], float(x2.abs().max()) / 448.0)
    per_tensor = (qref.encode_chunks(x2, one_scale, "fp8", False)
                  .float() * one_scale).reshape(-1)[:bucket]
    check_rejects_exact("planted per-tensor scale in place of per-chunk",
                        _bits(per_tensor), _bits(qref.roundtrip(x, "fp8")))
    del got, want, x2, one_scale, per_tensor

    say("timing at the largest bucket (ms: kernel wall, device / plain / "
        "bound; SR: the RTN launch's device time on the same x, and the "
        "share of SR's device time above it, the seed pass and the "
        "dither):")
    variants = {}
    for dt, codec, sr in ((torch.float32, "fp8", True),
                          (torch.bfloat16, "fp8", False),
                          (torch.float32, "int8", True),
                          (torch.float32, "fp8", False)):
        x = _codec_input(bucket, dt, seed=3)
        q, sc = qops.quantize_cuda(x, codec, sr)
        # quant reads x once, writes one byte an element and a f32 scale a
        # chunk; dequant the reverse; ~8 fp32 operations an element
        wire = bucket + 4 * sc.numel()
        nbytes = bucket * x.element_size() + wire
        bound_q, by_q = _bound(nbytes, 8.0 * bucket)
        bound_d, by_d = _bound(nbytes, 2.0 * bucket)
        quant = lambda: qops.quantize_cuda(x, codec, sr)
        ms_q, dev_q = time_ms(quant), device_ms(quant, bound_q)
        plain_q = time_ms(lambda: qref.quantize(x, codec, sr))
        deq = lambda: qops.dequantize_cuda(q, sc, bucket, x.shape, dt)
        ms_d, dev_d = time_ms(deq), device_ms(deq, bound_d)
        plain_d = time_ms(lambda: qref.dequantize(q, sc, bucket, x.shape,
                                                  dt))
        label = f"{str(dt)[6:]} {codec} {'SR' if sr else 'RTN'}"
        seed_note = ""
        rtn_dev = None
        if sr:
            rtn_dev = device_ms(lambda: qops.quantize_cuda(x, codec, False),
                                bound_q)
            if dev_q and rtn_dev:
                seed_note = (f"; RTN device {rtn_dev:.4f}, SR above it "
                             f"{100 * (dev_q - rtn_dev) / dev_q:.1f}%")
        say(f"  {label}: quant {ms_q:.4f}, device {_ms(dev_q)} / "
            f"{plain_q:.4f} / {bound_q:.4f} ({nbytes / ms_q / 1e6:.0f} GB/s"
            f"{seed_note}); dequant {ms_d:.4f}, device {_ms(dev_d)} / "
            f"{plain_d:.4f} / {bound_d:.4f} ({nbytes / ms_d / 1e6:.0f} GB/s)")
        variants[label] = dict(ms=ms_q, device_ms=dev_q, bound_ms=bound_q,
                               rtn_device_ms=rtn_dev, dequant_ms=ms_d,
                               dequant_device_ms=dev_d)
        if dt == torch.float32 and codec == "fp8" and sr:
            state["quant_fwd"] = dict(max_abs_err=err_q, ms=ms_q,
                                      plain_ms=plain_q, bound_ms=bound_q,
                                      bound_by=by_q, library_ms=None,
                                      device_ms=dev_q)
            state["dequant_fwd"] = dict(max_abs_err=err_d, ms=ms_d,
                                        plain_ms=plain_d, bound_ms=bound_d,
                                        bound_by=by_d, library_ms=None,
                                        device_ms=dev_d)
        del x, q, sc
        torch.cuda.empty_cache()
    state["quant_fwd"]["variants"] = variants


def phase_quant_grad_bucket(state):
    """The gradient half of the quantized path on the largest full-width
    bucket, card against CPU, bit for bit: the same bf16 gradients packed
    and finalized by `finalize_grad_bucket` (the stochastic codec per
    class buffer in the quant kernels, the NCCL reduce-scatter, mean,
    split; on the CPU the plain codec and gloo), then the error-feedback
    hop (fp8 RTN in the kernels) on the reduced chunks."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.dist import DistConfig, make_mesh
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.optim.adamw import error_feedback
    for precision, kw in (("fp8_ef", {}), ("int8_ef", {}),
                          ("fp8", dict(grad_compression=True))):
        dcfg = DistConfig(comm_precision=precision, **kw)
        make_mesh(dcfg)
        metas = _largest_bucket(dcfg)
        shapes = [m.shard_shape(dcfg) for m in metas]
        gen = torch.Generator(device="cuda").manual_seed(7)
        grads = [(torch.randn(m.local_shape(dcfg), generator=gen,
                              device="cuda") * 1e-3).to(dcfg.param_dtype)
                 for m in metas]
        efs = [torch.randn(s, generator=gen, device="cuda") * 1e-6
               for s in shapes]
        got = {}
        for dev in ("cuda", "cpu"):
            n0 = qops.quant_launches + qops.dequant_launches
            chunks = coll.finalize_grad_bucket(
                coll.pack_grad_bucket([g.to(dev) for g in grads], metas,
                                      dcfg),
                metas, dcfg, shapes).wait()
            outs = list(chunks)
            if dcfg.needs_ef:
                ef = {str(i): e.to(dev, copy=True)
                      for i, e in enumerate(efs)}
                gq = error_feedback(
                    {str(i): c for i, c in enumerate(chunks)}, ef)
                outs += [gq[str(i)] for i in range(len(chunks))]
                outs += [ef[str(i)] for i in range(len(chunks))]
            launched = qops.quant_launches + qops.dequant_launches - n0
            if (launched > 0) != (dev == "cuda"):
                raise AssertionError(f"{precision} on {dev}: {launched} "
                                     "quant kernel launches")
            got[dev] = outs
        n = sum(m.chunk_len(dcfg) for m in metas)
        for k, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
            check_exact(f"{precision}{'+gc' if kw else ''} bucket output "
                        f"{k}", _bits(a.cpu()), _bits(b))
        say(f"  {precision}{' + grad_compression' if kw else ''}, bucket "
            f"of {len(metas)} params / {n} elements: reduced chunks"
            f"{', EF hop (gq, ef)' if dcfg.needs_ef else ''} equal the "
            "CPU's bit for bit")
        del grads, efs, got
        torch.cuda.empty_cache()


def _train_counts():
    from repro_torch.core import collectives as coll
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.cross_entropy import ops as xent_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return dict(rmsnorm=rms_ops.launches, flash=flash_ops.launches,
                flash_f32=flash_ops.launches_f32,
                flash_bwd=flash_ops.bwd_launches,
                flash_bwd_f32=flash_ops.bwd_launches_f32,
                xent_fwd=xent_ops.fwd_launches,
                xent_bwd=xent_ops.bwd_launches, adamw=adamw_ops.launches,
                quant_fwd=quant_ops.quant_launches,
                dequant_fwd=quant_ops.dequant_launches,
                ssd=ssd_ops.launches, ssd_f32=ssd_ops.launches_f32,
                ssd_bwd=ssd_ops.bwd_launches,
                ssd_bwd_f32=ssd_ops.bwd_launches_f32,
                gathers=coll.gathers, reduce_scatters=coll.reduce_scatters)


def _reset_counts():
    from repro_torch.core import collectives as coll
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.cross_entropy import ops as xent_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    rms_ops.launches = flash_ops.launches = adamw_ops.launches = 0
    flash_ops.launches_f32 = ssd_ops.launches = 0
    flash_ops.bwd_launches = flash_ops.bwd_launches_f32 = 0
    ssd_ops.launches_f32 = ssd_ops.bwd_launches = 0
    ssd_ops.bwd_launches_f32 = 0
    xent_ops.fwd_launches = xent_ops.bwd_launches = 0
    quant_ops.quant_launches = quant_ops.dequant_launches = 0
    coll.gathers = coll.reduce_scatters = 0


def _serve_counts():
    """The rmsnorm and flash counts of a serving window (opened by
    _reset_counts): no backward runs there."""
    c = _train_counts()
    return {k: c[k] for k in ("rmsnorm", "flash", "flash_f32", "flash_bwd",
                              "flash_bwd_f32")}


COLLECTIVES = ("gathers", "reduce_scatters")
QUANT = ("quant_fwd", "dequant_fwd")
# kernels the dense paths do not run at a bf16 wire
NOT_DENSE = QUANT + ("ssd", "ssd_f32", "ssd_bwd", "ssd_bwd_f32")
# fp32 runs take flash's fp32 routes, bf16 runs its bf16 routes (the ssd's
# fp32 calls count in both ssd and ssd_f32, ssd_bwd and ssd_bwd_f32)
NOT_F32 = ("flash", "flash_bwd")
NOT_BF16 = ("flash_f32", "flash_bwd_f32", "ssd_f32", "ssd_bwd_f32")


def phase_smoke_train(state):
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core.meta import named_leaves
    from repro_torch.ft.failures import InjectedFailures
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.trainer import Trainer
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        def trainer(dev, sub):
            return launch_train.build_trainer(launch_train.parse_args([
                "--arch", "qwen3_1_7b", "--smoke", "--no-reorder",
                "--steps", "3", "--seq", "32", "--batch", "4", "--dtype",
                "float32", "--device", dev, "--ckpt-dir", str(root / sub)]))

        # one CPU-made step-0 checkpoint starts every run
        cpu = trainer("cpu", "cpu")
        storage, opt = init_train_state(cpu.par,
                                        torch.Generator().manual_seed(0))
        cpu.ckpt.save(0, cpu.par.unshard(storage), dict(
            m=cpu.par.unshard(opt["m"]), v=cpu.par.unshard(opt["v"]),
            step=opt["step"]), cpu.model, cpu.dcfg)
        for sub in ("cuda", "restart"):
            shutil.copytree(root / "cpu", root / sub)
        runs = {}
        for dev, tr in (("cpu", cpu), ("cuda", trainer("cuda", "cuda"))):
            _reset_counts()
            storage, _, hist = tr.run()
            runs[dev] = (storage, hist, _train_counts())
        counts = runs["cuda"][2]
        state["smoke_train_launches"] = counts
        say(f"  launches in the smoke run on the card: {counts}")
        if min(v for k, v in counts.items()
               if k not in NOT_DENSE + NOT_F32) <= 0 or any(
                   counts[k] for k in NOT_F32):
            raise AssertionError(f"a kernel never launched, or fp32 took "
                                 f"flash's bf16 route: {counts}")
        _check_bwd_calls(counts, tr.model, 3, "flash_bwd_f32")
        if max(v for k, v in runs["cpu"][2].items()
               if k not in COLLECTIVES) > 0:
            raise AssertionError("the CPU run launched a kernel")
        for hc, hg in zip(runs["cpu"][1], runs["cuda"][1]):
            for k in ("loss", "grad_norm"):
                check_close(f"smoke step {hc['step']} {k} cuda vs cpu",
                            torch.tensor(hg[k]), torch.tensor(hc[k]), TOL32)
        errs = [check_close(f"smoke storage {n}", a.cpu(), b, TOL32)
                for (n, a), (_, b) in zip(named_leaves(runs["cuda"][0]),
                                          named_leaves(runs["cpu"][0]))]
        say(f"  smoke storage cuda vs cpu: {len(errs)} leaves, max abs err "
            f"{max(errs):.3e}")

        cuda = trainer("cuda", "restart")
        tr = Trainer(cuda.model, cuda.dcfg, cuda.shape, cuda.ocfg,
                     dataclasses.replace(cuda.tcfg, ckpt_every=1),
                     failure_source=InjectedFailures((2,)), device="cuda")
        resumed, _, _ = tr.run()
        diff = max(max_err(a, b) for (_, a), (_, b) in zip(
            named_leaves(resumed), named_leaves(runs["cuda"][0])))
        exact = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            named_leaves(resumed), named_leaves(runs["cuda"][0])))
        say(f"  restart after a failure at step 2: restarts {tr.restarts}, "
            f"max abs diff to the uninterrupted run {diff:.3e}, "
            f"{'bit-exact' if exact else 'NOT bit-exact'}")
        if tr.restarts != 1 or not exact:
            raise AssertionError("the restarted run is not bit-exact")

        # bf16 compute: the card's logits product (torch.mm with an fp32
        # out_dtype) and bf16 head backward against the CPU's fp32 product
        from repro_torch.core.api import parallelize
        from repro_torch.core.meta import tree_map
        dcfg16 = cpu.dcfg.with_(param_dtype=torch.bfloat16)
        storage = parallelize(cpu.model, dcfg16, cpu.shape,
                              device="cpu").init_storage(
            torch.Generator().manual_seed(0))
        batch = cpu.data.batch(0)
        out = {}
        for dev in ("cpu", "cuda"):
            par = parallelize(cpu.model, dcfg16, cpu.shape, device=dev)
            out[dev] = par.loss_step()(
                tree_map(lambda a: a.to(dev), storage), batch)
        check_close("smoke bf16 loss cuda vs cpu", out["cuda"][0].cpu(),
                    out["cpu"][0], TOL)
        errs = [check_close(f"smoke bf16 grad {n}", a.cpu(), b, TOL)
                for (n, a), (_, b) in zip(named_leaves(out["cuda"][1]),
                                          named_leaves(out["cpu"][1]))]
        say(f"  smoke bf16 grads cuda vs cpu: max abs err {max(errs):.3e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_smoke_quant_train(state):
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core import collectives as coll
    from repro_torch.core.meta import leaves, named_leaves, tree_map
    from repro_torch.ft.failures import InjectedFailures
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.trainer import Trainer
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_qtrain_"))
    steps = 3
    try:
        def trainer(dev, sub, precision):
            return launch_train.build_trainer(launch_train.parse_args([
                "--arch", "qwen3_1_7b", "--smoke", "--steps", str(steps),
                "--seq", "32", "--batch", "4", "--dtype", "float32",
                "--device", dev, "--comm-precision", precision, "--lr",
                str(QUANT_LR), "--ckpt-dir", str(root / sub)]))

        # one CPU-made step-0 checkpoint (EF at zero) starts every run
        cpu = trainer("cpu", "seed", "fp8_ef")
        storage, opt = init_train_state(cpu.par,
                                        torch.Generator().manual_seed(0))
        cpu.ckpt.save(0, cpu.par.unshard(storage), {
            k: v if k == "step" else cpu.par.unshard(v)
            for k, v in opt.items()}, cpu.model, cpu.dcfg)
        drift_bound = 4.0 * QUANT_LR * steps
        for precision in ("int8_ag", "fp8_ef"):
            runs = {}
            for dev in ("cpu", "cuda"):
                shutil.copytree(root / "seed", root / f"{precision}_{dev}")
                tr = trainer(dev, f"{precision}_{dev}", precision)
                if precision == "int8_ag":
                    # the first loss step and the quantized gathered weights
                    whole, _, _ = tr.ckpt.restore(0, tr.model, tr.dcfg)
                    st = tree_map(lambda a: a.to(tr.par.device),
                                  tr.par.shard(whole))
                    runs[f"{dev}_step"] = tr.par.loss_step()(
                        st, tr.data.batch(0))
                    blk = tree_map(lambda a: a[0], st["blocks"])
                    metas = tr.model.block_metas(tr.dcfg)
                    runs[f"{dev}_gathered"] = coll.gather_group_start(
                        leaves(blk), leaves(metas), tr.dcfg).wait()
                _reset_counts()
                st, opt_state, hist = tr.run()
                runs[dev] = (st, opt_state, hist, _train_counts())
            counts = runs["cuda"][3]
            say(f"  {precision} launches on the card: {counts}")
            if min(counts[k] for k in QUANT + ("flash_bwd_f32",)) <= 0 \
                    or any(counts[k] for k in NOT_F32):
                raise AssertionError(f"{precision}: a quant kernel or the "
                                     f"fp32 flash backward never launched, "
                                     f"or fp32 took a bf16 route: {counts}")
            _check_bwd_calls(counts, tr.model, steps, "flash_bwd_f32")
            if max(v for k, v in runs["cpu"][3].items()
                   if k not in COLLECTIVES) > 0:
                raise AssertionError("the CPU run launched a kernel")
            if precision == "int8_ag":
                (lc, gc), (lg, gg) = runs["cpu_step"], runs["cuda_step"]
                check_close("int8_ag first loss cuda vs cpu", lg.cpu(), lc,
                            TOL32)
                errs = [check_close(f"int8_ag first grad {n}", a.cpu(), b,
                                    TOL32)
                        for (n, a), (_, b) in zip(named_leaves(gg),
                                                  named_leaves(gc))]
                say(f"  int8_ag first-step grads: max abs err "
                    f"{max(errs):.3e}")
                for a, b in zip(runs["cuda_gathered"],
                                runs["cpu_gathered"]):
                    check_exact("int8_ag gathered quantized weights",
                                _bits(a.cpu()), _bits(b))
                say("  int8_ag quantized gathered weights: byte-equal")
            hc, hg = runs["cpu"][2], runs["cuda"][2]
            for c, g in zip(hc, hg):
                check_close(f"{precision} step {c['step']} loss cuda vs cpu",
                            torch.tensor(g["loss"]), torch.tensor(c["loss"]),
                            dict(rtol=QUANT_LOSS_RTOL, atol=0.0))
            drift = max(max_err(a.cpu(), b) for (_, a), (_, b) in zip(
                named_leaves(runs["cuda"][0]), named_leaves(runs["cpu"][0])))
            say(f"  {precision} weight drift cuda vs cpu after {steps} steps:"
                f" {drift:.3e} (bound {drift_bound:.1e})")
            if not drift <= drift_bound:
                raise AssertionError(f"{precision}: drift {drift:.3e}")
            if precision == "fp8_ef":
                ef = max(a.abs().max().item()
                         for a in leaves(runs["cuda"][1]["ef"]))
                say(f"  fp8_ef accumulator on the card: max |ef| {ef:.3e}")
                if not ef > 0:
                    raise AssertionError("the EF accumulator stayed zero")
                state["smoke_fp8_ef"] = runs["cuda"]

        # restart after an injected failure: bit-exact, EF included
        shutil.copytree(root / "seed", root / "restart")
        ref = trainer("cuda", "restart", "fp8_ef")
        tr = Trainer(ref.model, ref.dcfg, ref.shape, ref.ocfg,
                     dataclasses.replace(ref.tcfg, ckpt_every=1),
                     failure_source=InjectedFailures((2,)), device="cuda")
        resumed, opt_r, _ = tr.run()
        clean, opt_c = state["smoke_fp8_ef"][:2]
        pairs = list(zip(leaves(resumed), leaves(clean))) + list(zip(
            leaves(opt_r["ef"]), leaves(opt_c["ef"])))
        exact = all(torch.equal(a, b) for a, b in pairs)
        say(f"  fp8_ef restart after a failure at step 2: restarts "
            f"{tr.restarts}, {'bit-exact' if exact else 'NOT bit-exact'} "
            "(storage and EF)")
        if tr.restarts != 1 or not exact:
            raise AssertionError("the restarted fp8_ef run is not bit-exact")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_full_train(state):
    # the reference's DistConfig defaults but reorder: bf16 compute, fp32
    # storage and reduce, bf16 gathers, block buckets, remat fsdp_only
    from repro_torch.core.dist import DistConfig
    _full_train(state, "train", DistConfig(reorder=False))


def phase_full_prefetch_train(state):
    # the reference launcher's defaults: the prefetch stack, bf16 wire
    from repro_torch.core.dist import DistConfig
    _full_train(state, "train_prefetch", DistConfig())


def phase_full_quant_train(state):
    # the reference launcher's defaults (the prefetch stack) at fp8_ef
    from repro_torch.core.dist import DistConfig
    _full_train(state, "train_fp8_ef", DistConfig(comm_precision="fp8_ef"),
                need=QUANT)


# remat="auto:<GB>" for the auto-planned phase (qwen3-1.7b B4 T2048, world
# size 1, auto_dp buckets, comm_precision auto, the H100 profile).  The
# port's planner models, with the error-feedback state 'auto' carries,
# full at 44.90 GiB and none at 45.32-45.37 GiB; below 45.25 GiB the
# search takes residual offload (which no step executes, a fault of the
# reference).  45.3 lies between and picks attn=fsdp_only,mlp=none (45.30
# GiB), a non-'none' vector without offload.
AUTO_BUDGET_GB = 45.3
# the modeled mesh the mixed-precision phase plans for: 4 nodes x 8 GPUs,
# ZeRO-3 over both axes ('pod' prices NDR InfiniBand, 'data' NVLink)
MIXED_MESH = dict(mesh_axes=("pod", "data", "model"), mesh_shape=(4, 8, 1),
                  fsdp_axes=("pod", "data"))
MIXED_CYCLE = ("bf16", "fp8_ef", "int8_ag")


def _exec_groups(par):
    """(groups as leaf indices, their precisions, the block metas) of the
    blocks' plan as the prefetch stack executes it (split at the
    segments)."""
    from repro_torch.core.bucketing import split_plan_at_segments
    d = par.plan.exec_dcfg
    metas = par.model.block_metas(d)
    plan = split_plan_at_segments(par.plan.bucket_plan("blocks"), metas,
                                  par.model.block_segments(d))
    return plan.index_groups(metas), plan.group_precisions(metas, d), metas


def _expected_collectives(par):
    """Gathers and reduce-scatters one prefetch step issues: every
    executed bucket of every layer gathered in the forward and again in
    the backward, reduce-scattered once; plus the embedding, the final
    norm and the tied head outside the stack, once each."""
    groups, _, _ = _exec_groups(par)
    n = len(groups) * par.model.n_steps
    return 2 * n + 3, n + 3


def _expected_codec_calls(par):
    """Quant (= dequant) wrapper calls one prefetch step makes under the
    plan's precisions: an all-gather codec twice a bucket and layer
    (forward, backward re-gather), a reduce-scatter codec once a TP class
    of the bucket and layer, and the error-feedback hop once a stacked
    leaf of an *_ef bucket; the other groups gather at bf16."""
    from repro_torch.core.dist import precision_codecs
    groups, precs, metas = _exec_groups(par)
    ms = [m for _, m in _named(metas)]
    per_layer, ef = 0, 0
    for grp, p in zip(groups, precs):
        ag, rs = precision_codecs(p)
        per_layer += 2 * (ag is not None)
        per_layer += (rs is not None) * len({ms[i].tp_dim is None
                                             for i in grp})
        ef += len(grp) * p.endswith("_ef")
    return per_layer * par.model.n_steps + ef


def phase_full_auto_train(state):
    """qwen3-1.7b B4 T2048 through `Trainer` with bucket_mode auto_dp,
    comm_precision auto and remat auto:<AUTO_BUDGET_GB>, the prefetch stack,
    world size 1, the H100 profile."""
    import tempfile
    from repro_torch.core import hw
    from repro_torch.core.api import parallelize, plan_parallel
    from repro_torch.core.dist import DistConfig
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    if hw.active() is not hw.H100:
        raise AssertionError(f"planning with {hw.active().name}, not H100")
    _, model = get_arch("qwen3_1_7b")
    shape = ShapeConfig("train", TRAIN_T, TRAIN_B, "train")
    dcfg = DistConfig(bucket_mode="auto_dp", comm_precision="auto",
                      remat=f"auto:{AUTO_BUDGET_GB}")
    fixed = {pol: plan_parallel(model, dcfg.with_(remat=pol), shape).memory
             for pol in ("none", "fsdp_only", "save_dots", "full")}
    say("modeled peaks of the fixed policies (H100 profile): " + ", ".join(
        f"{p} {m.peak / 2**30:.4f} GiB" for p, m in fixed.items()))
    budget = AUTO_BUDGET_GB * 2**30
    if not fixed["full"].peak < budget < fixed["none"].peak:
        raise AssertionError(f"budget {AUTO_BUDGET_GB} GiB is not between "
                             "full's and none's modeled peaks")
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(model, dcfg, shape, AdamWConfig(),
                          TrainerConfig(total_steps=100, warmup=10,
                                        ckpt_dir=ckpt), device="cuda")
    plan, mem = trainer.plan, trainer.plan.memory
    say(f"auto plan: {plan.describe()}")
    for b in mem.breakdown:
        say(f"  {b.describe()}")
    say(f"  exec_dcfg: remat={plan.exec_dcfg.remat!r}, bucket_mode "
        f"{'the memory plan' if mem.bucket_plan else 'auto_dp'}'s "
        f"{plan.bucket_plan('blocks').n_buckets} buckets a layer, "
        f"precisions {plan.bucket_plan('blocks').precisions}")
    if set(mem.policies) == {"none"} or mem.offload_opt_state \
            or mem.offload_residuals:
        raise AssertionError(f"the search picked {mem.describe()}, not a "
                             "non-'none' policy without offload")
    rep = trainer.memory_report()
    say(f"  modeled peak {rep['modeled_peak_bytes'] / 2**30:.4f} GiB, "
        f"measured max_memory_allocated over one step "
        f"{rep['measured_peak_bytes'] / 2**30:.4f} GiB: modeled / measured "
        f"{rep['modeled_over_measured']:.4f}")
    state["auto_memory"] = rep
    exec_par = parallelize(model, plan.exec_dcfg, shape, device="cuda")

    def first_loss(storage, batch):
        loss, grads = exec_par.loss_step()(storage, batch)
        del grads
        return loss.detach().clone()

    par, _, _ = _full_train(state, "train_auto", dcfg, par=trainer.par,
                            step=trainer.step_fn, first_loss=first_loss)
    want = _expected_collectives(par)
    got = tuple(state["train_auto_launches"][k] / TRAIN_STEPS
                for k in COLLECTIVES)
    say(f"  gathers, reduce-scatters per step {got}; the plan's "
        f"{len(_exec_groups(par)[0])} executed buckets x "
        f"{model.n_steps} layers give {want}")
    if got != want:
        raise AssertionError(f"collectives per step {got} != {want}")


def phase_full_mixed_train(state):
    """The runtime of a per-bucket precision plan at full width: qwen3-1.7b's
    blocks planned for a modeled 4 x 8 mesh (host math, H100 profile),
    trained at world size 1 as an explicit bucket_mode."""
    from repro_torch.core.autowrap import exposed_comm_time
    from repro_torch.core.bucketing import BucketPlan, plan_for
    from repro_torch.core.dist import DistConfig
    from repro_torch.models.registry import get_arch
    _, model = get_arch("qwen3_1_7b")
    dm = DistConfig(bucket_mode="auto_dp", comm_precision="auto",
                    **MIXED_MESH)
    metas, segs = model.block_metas(dm), model.block_segments(dm)
    stats = model.block_stats(dm, (TRAIN_B, TRAIN_T))
    plan = plan_for(metas, dm, stats, segments=segs)
    r = exposed_comm_time(plan, metas, dm, stats, segments=segs)
    say(f"planned for {dm.mesh_shape} {dm.mesh_axes}, fsdp {dm.fsdp_axes}, "
        f"B{TRAIN_B} T{TRAIN_T} a rank: groups "
        f"{[len(g) for g in plan.groups]}, precisions {plan.precisions}")
    say("  exposed_comm_time: " + ", ".join(
        f"{k}={v}" for k, v in r.items()))
    groups = list(plan.groups)
    if len(set(plan.precisions)) > 1:
        say("  the planner's precisions are mixed: trained as planned")
        precs = list(plan.precisions)
    else:
        # not mixed: give the planner's groups alternating precisions; with
        # fewer groups than precisions, halve each group (in order) first
        if len(groups) < len(MIXED_CYCLE):
            groups = [h for g in groups
                      for h in (g[:len(g) // 2], g[len(g) // 2:]) if h]
        precs = [MIXED_CYCLE[i % len(MIXED_CYCLE)]
                 for i in range(len(groups))]
        say(f"  the planner's precisions are not mixed ({plan.precisions});"
            f" trained with its groups halved: "
            f"{[len(g) for g in groups]} at {precs}")
    dcfg = DistConfig(comm_precision="auto",
                      bucket_mode=BucketPlan(tuple(groups), tuple(precs)))
    par, _, _ = _full_train(state, "train_mixed", dcfg, need=QUANT)
    counts = state["train_mixed_launches"]
    want = _expected_codec_calls(par)
    got = tuple(counts[k] / TRAIN_STEPS for k in QUANT)
    say(f"  quant, dequant calls per step {got}; the plan's precisions "
        f"imply {want} each")
    if got != (want, want):
        raise AssertionError(f"codec calls per step {got} != {want}")


def phase_planner_lines(state):
    """Host math and two readings of the card beside the H100 profile."""
    from repro_torch.core import hw
    from repro_torch.core.api import plan_parallel
    from repro_torch.core.dist import DistConfig
    from repro_torch.core.memory import to_device, to_host
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    _, zamba = get_arch("zamba2_1_2b")
    shape = ShapeConfig("train", TRAIN_T, TRAIN_B, "train")
    for pol in ("none", "fsdp_only", "save_dots", "full"):
        p = plan_parallel(zamba, DistConfig(remat=pol, bucket_mode="auto_dp",
                                            comm_precision="auto"), shape)
        say(f"zamba2-1.2b B{TRAIN_B} T{TRAIN_T}: {p.describe()}")
    for b in p.memory.breakdown:
        say(f"  {b.describe()}")
    total = torch.cuda.get_device_properties(0).total_memory
    say(f"H100 profile hbm_bytes {hw.H100.hbm_bytes} "
        f"({hw.H100.hbm_bytes / 2**30:.2f} GiB) against the card's "
        f"total_memory {total} ({total / 2**30:.2f} GiB): "
        f"{total / hw.H100.hbm_bytes:.4f}")
    x = torch.arange(2**28, device="cuda", dtype=torch.float32)   # 1 GiB
    host = to_host({"x": x})
    if not host["x"].is_pinned() or not torch.equal(
            to_device(host, "cuda")["x"], x):
        raise AssertionError("the pinned host round trip failed")
    h = host["x"]
    rates = {}
    for _ in range(2):            # the second of two: no first-touch cost
        for name, dst, src in (("device->host", h, x),
                               ("host->device", x, h)):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            dst.copy_(src, non_blocking=True)
            ev[1].record()
            torch.cuda.synchronize()
            rates[name] = x.numel() * 4 / (ev[0].elapsed_time(ev[1]) / 1e3)
    say("pinned 1 GiB copies (CUDA events, second of two): " +
        ", ".join(f"{k} {v / 1e9:.2f} GB/s" for k, v in rates.items()) +
        f"; the H100 profile's host_dma_bw {hw.H100.host_dma_bw / 1e9:.0f} "
        "GB/s (printed, not installed)")
    state["planner"] = dict(total_memory=total, copy_rates=rates)


# the observability phases: steps of the Trainer's loop; the smoke replan's
# workload (qwen3 SMOKE, bf16)
OBS_STEPS, REPLAN_STEPS, REPLAN_B, REPLAN_T = 4, 5, 4, 64


def _obs_trainer(model, dcfg, shape, steps, ckpt, apply, jsonl=None):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(model, dcfg, shape, AdamWConfig(), TrainerConfig(
        total_steps=steps, ckpt_every=steps, log_every=1, warmup=10,
        ckpt_dir=ckpt, metrics_jsonl=jsonl, replan_threshold=0.0,
        replan_patience=2, replan_apply=apply), device="cuda")


def phase_full_obs(state):
    """qwen3-1.7b B4 T2048 through `Trainer` at the auto-planned phase's
    configuration (auto_dp + auto + remat auto:AUTO_BUDGET_GB), OBS_STEPS
    steps with replan_threshold 0 and patience 2, replan_apply off: every
    step in the registry and the drift monitor, a `profile_step` of the
    executed plan at each replan (segments, both codecs, the wall the loop
    measured), the calibrated replan's delta, and the trace with the
    measured overlay.  The loop's final checkpoint (~27 GB at full width)
    is skipped: nothing here restarts from it."""
    import math
    import tempfile
    from repro_torch.core import hw
    from repro_torch.core.autowrap import exposed_comm_time
    from repro_torch.core.dist import DistConfig
    from repro_torch.core.obs import (calibrated_step_time,
                                      nonoverlapped_comm_s, plan_trace)
    from repro_torch.core.obs import profile as obs_profile
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train.train_step import step_wire_metrics
    if hw.active() is not hw.H100:
        raise AssertionError(f"planning with {hw.active().name}, not H100")
    _, model = get_arch("qwen3_1_7b")
    shape = ShapeConfig("train", TRAIN_T, TRAIN_B, "train")
    dcfg = DistConfig(bucket_mode="auto_dp", comm_precision="auto",
                      remat=f"auto:{AUTO_BUDGET_GB}")
    out = ROOT / "build" / "obs"
    out.mkdir(parents=True, exist_ok=True)
    jsonl = out / "metrics.jsonl"
    jsonl.unlink(missing_ok=True)
    # the quant launches of each harvest, so the codec timed is the kernel
    harvests = []
    real = obs_profile.harvest_quant_timing

    def harvest(elems, codec="fp8", **kw):
        before = (quant_ops.quant_launches, quant_ops.dequant_launches)
        q = real(elems, codec=codec, **kw)
        harvests.append((codec, before, (quant_ops.quant_launches,
                                         quant_ops.dequant_launches), q))
        return q
    obs_profile.harvest_quant_timing = harvest
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            tr = _obs_trainer(model, dcfg, shape, OBS_STEPS, ckpt, False,
                              str(jsonl))
            tr._save = lambda *a: None
            say(f"plan: {tr.plan.describe()}")
            say(f"  H100 prior's modeled step {tr._modeled_step_s * 1e3:.3f}"
                " ms (modeled_step_time)")
            _reset_counts()
            storage, opt_state, _ = tr.run()
            counts = _train_counts()
            del storage, opt_state
    finally:
        obs_profile.harvest_quant_timing = real
    state["train_obs_launches"] = counts
    say(f"  launches over {OBS_STEPS} steps and "
        f"{len(tr.replans)} profiles: {counts}")
    if min(counts[k] for k in ("rmsnorm", "flash", "flash_bwd", "xent_fwd",
                               "xent_bwd", "adamw", *QUANT)) <= 0 \
            or any(counts[k] for k in NOT_BF16):
        raise AssertionError(f"a kernel of the path never launched, or one "
                             f"off it did: {counts}")
    # the profiles time segments without a gradient and take the loop's
    # measured wall, so no step is differentiated outside the loop
    _check_bwd_calls(counts, model, OBS_STEPS)
    say(tr.drift.report())
    r, prof = tr.registry, tr.profile
    steps = r.counter("train/steps").value
    if steps != OBS_STEPS:
        raise AssertionError(f"train/steps {steps} != {OBS_STEPS}")
    wire = step_wire_metrics(model, tr.plan)["by_precision"]
    got = {k: r.counter(f"train/wire_bytes/{k}").value for k in wire}
    say(f"  wire bytes by precision over {OBS_STEPS} steps: {got}")
    if got != {k: v * OBS_STEPS for k, v in wire.items()}:
        raise AssertionError(f"wire bytes {got} != {OBS_STEPS} x {wire}")
    if not tr.replans or r.counter("replan/count").value < 1:
        raise AssertionError("no replan delta was recorded")
    if sorted(prof.seg_scales) != ["attn", "mlp"] or not all(
            math.isfinite(v) and v > 0 for v in prof.seg_scales.values()):
        raise AssertionError(f"segment scales {prof.seg_scales}")
    g = prof.meta["closure_factor"]
    say(f"  profile ({prof.meta['backend']}): wall step "
        f"{prof.wall_step_s * 1e3:.3f} ms (the loop's), closure factor "
        f"{g!r}")
    for sp in prof.spans:
        if sp["cat"] == "compute":
            seg = sp["segment"]
            say(f"  segment {seg}: measured {sp['dur_s'] * 1e3:.4f} ms, "
                f"modeled {sp['modeled_s'] * 1e3:.4f} ms (H100 roofline), "
                f"measured / modeled {sp['dur_s'] / sp['modeled_s']:.4f}, "
                f"scale with closure {prof.seg_scales[seg]:.4f}")
    prior = hw.active().hbm_bandwidth / 2.0
    for codec, rate in sorted(prof.quant_rates.items()):
        say(f"  codec {codec}: measured {rate / 1e9:.2f} GB/s of bf16 "
            f"input, analytic prior {prior / 1e9:.2f} GB/s "
            f"(HBM / 2): {rate / prior:.4f} of it")
    if sorted(prof.quant_rates) != ["fp8", "int8"]:
        raise AssertionError(f"quant rates {prof.quant_rates}")
    for codec, before, after, q in harvests:
        times = [(x["n_elems"], round(x["t_us"], 2)) for x in q["samples"]]
        say(f"  harvest {codec}: {times} (elements, us); quant / dequant "
            f"launches {before} -> {after}")
        if not (after[0] > before[0] and after[1] > before[1]):
            raise AssertionError(f"{codec}: the CUDA codec was not timed")
    if prof.comm_bandwidth != {}:
        raise AssertionError(f"one card measured a collective bandwidth: "
                             f"{prof.comm_bandwidth}")
    closed = calibrated_step_time(model, tr.plan, shape, prof)
    say(f"  calibrated step {closed * 1e3:.3f} ms against the wall "
        f"{prof.wall_step_s * 1e3:.3f} ms: "
        f"{abs(closed / prof.wall_step_s - 1):.3e} off")
    if abs(closed - prof.wall_step_s) > 0.02 * prof.wall_step_s:
        raise AssertionError("calibration does not close within 2%")
    for d in tr.replans:
        say(f"  replan at step {d['step']}: changed={d['changed']} "
            f"fields={d['fields']} modeled before "
            f"{d['modeled_step_before_s'] * 1e3:.3f} ms, after "
            f"{d['modeled_step_after_s'] * 1e3:.3f} ms")
        say(f"    before: {d['before']}")
        say(f"    after:  {d['after']}")
    prof.save(str(out / "profile.json"))
    tb = plan_trace(model, tr.plan, shape, profile=prof)
    tb.save(str(out / "trace.json"))
    d = tr.plan.dcfg
    stats = model.block_stats(d, (TRAIN_B, TRAIN_T))
    exposed = exposed_comm_time(tr.plan.bucket_plan("blocks"),
                                model.block_metas(d), d, stats,
                                segments=model.block_segments(d))
    doc = json.loads((out / "trace.json").read_text())
    got = nonoverlapped_comm_s(doc)
    say(f"  trace build/obs/trace.json: {len(tb.events)} events; "
        f"non-overlapped comm {got!r} s, exposed_s {exposed['exposed_s']!r}")
    if got != exposed["exposed_s"]:
        raise AssertionError("the trace's non-overlapped comm is not "
                             "exposed_s")
    state["obs"] = dict(modeled_step_s=tr._modeled_step_s,
                        wall_step_s=prof.wall_step_s, closure=g,
                        seg_scales=prof.seg_scales,
                        quant_rates=prof.quant_rates,
                        replans=len(tr.replans))


def phase_smoke_replan(state):
    """qwen3 SMOKE, bf16, through `Trainer` on the card with
    replan_threshold 0, patience 2 and replan_apply: the apply path (save,
    `parallelize(plan=...)`, restore) runs, and the loop trains to its
    last step on the replanned plan."""
    import tempfile
    from repro_torch.core.dist import DistConfig
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("train", REPLAN_T, REPLAN_B, "train")
    with tempfile.TemporaryDirectory() as ckpt:
        tr = _obs_trainer(model, DistConfig(), shape, REPLAN_STEPS, ckpt,
                          True)
        _reset_counts()
        tr.run()
        counts = _train_counts()
    state["smoke_replan_launches"] = counts
    for d in tr.replans:
        say(f"  replan at step {d['step']}: changed={d['changed']} "
            f"applied={d['applied']} fields={d['fields']}")
        say(f"    after: {d['after']}")
    steps = tr.registry.counter("train/steps").value
    applied = [d for d in tr.replans if d["applied"]]
    say(f"  train/steps {steps}; {len(applied)} of {len(tr.replans)} "
        f"replans applied; launches {counts}")
    if steps != REPLAN_STEPS:
        raise AssertionError(f"train/steps {steps} != {REPLAN_STEPS}")
    if not applied or any(d["applied"] != d["changed"] for d in tr.replans):
        raise AssertionError("the apply path did not run on every changed "
                             "replan")
    if tr.plan.describe() != applied[-1]["after"]:
        raise AssertionError("the trainer does not run the replanned plan")
    if min(counts[k] for k in ("rmsnorm", "flash", "flash_bwd", "xent_fwd",
                               "xent_bwd", "adamw")) <= 0 \
            or any(counts[k] for k in NOT_BF16):
        raise AssertionError(f"a kernel of the path never launched, or one "
                             f"off it did: {counts}")
    # an applied replan restores at the step it was taken: none is repeated
    _check_bwd_calls(counts, tr.model, REPLAN_STEPS)


def _ssd_flops(b, t, h, p, n, lc):
    """FLOPs of one SSD chunk-scan forward: per (b, h) and chunk, the
    causal lower triangle of C B^T (2N a pair) and of its product with x (2P
    a pair), the inter-chunk product C S (2PN a row) and, before every chunk
    but the last, the state update (2PN a row)."""
    n_c = -(-t // lc)
    pairs = lc * (lc + 1) / 2
    return b * h * (n_c * (2 * n + 2 * p) * pairs + n_c * 2 * lc * p * n
                    + (n_c - 1) * 2 * lc * p * n)


def _attn_pairs(seq, window=None):
    """(query, key) pairs a causal attention over seq tokens scores: inside
    the sliding window where one is given."""
    if window is None or window >= seq:
        return seq * (seq + 1) / 2
    return window * (window + 1) / 2 + (seq - window) * window


def _attn_calls(model):
    """Attention calls a training step differentiates: one a layer, for
    zamba one a shared-block invocation, for xlstm none, for encdec one an
    encoder layer and two a decoder layer (self and cross)."""
    if model.cfg.family == "xlstm":
        return 0
    if model.cfg.family == "encdec":
        return model.n_enc + 2 * model.n_dec
    return model.n_super if model.cfg.family == "zamba" else \
        model.cfg.n_layers


def _check_bwd_calls(counts, model, steps, key="flash_bwd"):
    """One flash backward launch (`key`: the bf16 or the fp32 route) a
    differentiated attention call in `steps` steps, however often remat
    runs the forward."""
    calls = _attn_calls(model) * steps
    if counts[key] != calls:
        raise AssertionError(f"{counts[key]} {key} launches in {steps} "
                             f"steps, want {calls}")


def _model_flops(cfg, model, batch, seq):
    """Model FLOPs of one training step (forward and backward, 3 x the
    forward; remat's recompute not counted): 6 x the matmul parameters
    applied per token x tokens (for moe the active ones), plus causal
    attention (4*hd a pair, inside the window on gemma2's local layers)
    and, for zamba, the SSD's own products; xlstm: `_xlstm_flops`; encdec:
    `_encdec_flops`.  The vlm's backbone and head apply at every position
    of the sequence, image and text (the reference computes logits at the
    image positions too), its projector at the n_img_tokens image
    positions only."""
    if cfg.family == "encdec":
        return _encdec_flops(cfg, model, batch, seq)
    tokens = batch * seq
    lay = cfg.gqa_layout(1)
    hd = cfg.head_dim
    pairs = seq * (seq + 1) / 2
    if cfg.family in ("dense", "moe", "vlm"):
        d = cfg.d_model
        if cfg.local_global_alternate:   # half the layers are windowed
            pairs = (_attn_pairs(seq, cfg.sliding_window) + pairs) / 2
        elif cfg.sliding_window:
            pairs = _attn_pairs(seq, cfg.sliding_window)
        if cfg.family != "moe":
            ffn = (2 if cfg.gated_mlp == "gelu" else 3) * d * cfg.d_ff
        else:
            # the k routed experts a token visits, the router over the
            # padded experts and the gated shared expert; the capacity
            # padding of the dispatch is not counted
            from repro_torch.models.moe import experts_padded
            ffn = (3 * d * cfg.d_ff_expert * cfg.n_experts_active
                   + d * experts_padded(cfg, 1)
                   + (3 * d * cfg.d_ff_shared + d if cfg.d_ff_shared else 0))
        mm = cfg.n_layers * (2 * d * lay["hq"] * hd + 2 * d * lay["kvp"] * hd
                             + ffn) + cfg.vocab * d
        attn = 3 * cfg.n_layers * 4.0 * batch * lay["hq"] * hd * pairs
        proj = 6.0 * (cfg.vit_dim * d + d * d) * batch * cfg.n_img_tokens
        return 6.0 * mm * tokens + attn + proj
    # zamba: the Mamba layers once, the shared block once per invocation
    # (on the 2d-wide concat), the head once; the lookup has none
    if cfg.family == "xlstm":
        return _xlstm_flops(cfg, model, batch, seq)
    d, d2, di = cfg.d_model, 2 * cfg.d_model, model.d_inner
    mamba = d * (2 * di + 2 * cfg.ssm_state + model.nh) + di * d
    shared = (d2 * lay["hq"] * hd + 2 * lay["kvp"] * hd * d2
              + lay["hq"] * hd * d + 2 * d2 * cfg.d_ff + cfg.d_ff * d)
    mm = cfg.n_layers * mamba + model.n_super * shared + d * cfg.vocab
    attn = 3 * model.n_super * 4.0 * batch * lay["hq"] * hd * pairs
    ssd = 3 * cfg.n_layers * _ssd_flops(batch, seq, model.nh, model.hd,
                                        model.ds, min(cfg.ssm_chunk, seq))
    return 6.0 * mm * tokens + attn + ssd


def _encdec_flops(cfg, model, batch, seq):
    """FLOPs of one encdec training step at a cell's seq (S_src = S_tgt =
    seq / 2; forward and backward, 3 x the forward, remat's recompute not
    counted): 6 x the matrix-product parameters x the tokens they apply to
    (the frontend projection and the encoder's over the S_src frames; the
    decoder's self-attention, cross-attention queries and output, FFN and
    the head over the S_tgt tokens; the cross-attention keys and values
    over the memory's S_src rows), plus attention at 4*hd a (query, key)
    pair: the encoder's bidirectional S_src^2, the decoder's causal
    S_tgt (S_tgt + 1) / 2 and the cross-attention's S_tgt x S_src."""
    d, hd = cfg.d_model, cfg.head_dim
    lay = cfg.gqa_layout(1)
    hq, kvp = lay["hq"], lay["kvp"]
    s_src = s_tgt = seq // 2
    attn = 2 * d * hq * hd + 2 * d * kvp * hd
    ffn = 2 * d * cfg.d_ff
    enc = cfg.frontend_dim * d + model.n_enc * (attn + ffn)
    dec = model.n_dec * (attn + d * hq * hd + hq * hd * d + ffn) \
        + d * cfg.vocab
    xkv = model.n_dec * 2 * d * kvp * hd
    mm = 6.0 * batch * (enc * s_src + dec * s_tgt + xkv * s_src)
    pairs = (model.n_enc * s_src * s_src
             + model.n_dec * (s_tgt * (s_tgt + 1) / 2 + s_tgt * s_src))
    return mm + 3 * 4.0 * batch * hq * hd * pairs


def _full_train(state, key, dcfg, need=(), arch="qwen3_1_7b", par=None,
                step=None, first_loss=None, layers=None, batch=TRAIN_B,
                seq=TRAIN_T, steps=TRAIN_STEPS):
    """Trains `arch` at full width (at `layers` layers where given, else
    its published depth) on (batch, seq) batches: 1 warm-up step and
    `steps` timed steps, the last of them under the profiler (the median
    is the unprofiled steps'), through `par` / `step` when given (else
    `parallelize(dcfg)` and its train step).  Every path needs rmsnorm,
    xent and adamw; the attention families flash and its backward too, and
    xlstm none of flash or the SSD.  `first_loss(storage, batch)`, when
    given, runs before the warm-up step on its storage and batch and
    returns a loss the warm-up step's must equal bit for bit.  Returns
    (par, storage, opt_state)."""
    import dataclasses
    from repro_torch.core.api import parallelize
    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import default_schedule, ef_mask, \
        init_train_state
    cfg, model = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg)
    shape = ShapeConfig("train", seq, batch, "train")
    if par is None:
        par = parallelize(model, dcfg, shape, device="cuda")
    model = par.model
    say(f"plan: {par.plan.describe()} reorder={dcfg.reorder}")
    t0 = time.perf_counter()
    storage, opt_state = init_train_state(
        par, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(a.numel() for a in _leaves(storage))
    say(f"{cfg.name}: {n / 1e9:.4f}B storage elements (padded), fp32 "
        f"storage + {' + '.join(k for k in opt_state if k != 'step')} made "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    if step is None:
        ocfg = AdamWConfig()
        step = par.train_step(ocfg, default_schedule(ocfg, 100, 10))
    data = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0))
    batches = [data.batch(i) for i in range(steps + 1)]
    if cfg.family in ("encdec", "vlm"):
        # encdec: frames synthesised, token fields cropped to S_tgt = seq /
        # 2; vlm: image embeddings synthesised, token fields cropped to the
        # seq - n_img_tokens text positions
        from repro_torch.data.pipeline import adapt_batch
        specs = model.input_specs(shape, dcfg)
        batches = [adapt_batch(b_, specs, i) for i, b_ in enumerate(batches)]
    want_first = first_loss(storage, batches[0]) if first_loss else None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    storage, opt_state, m = step(storage, opt_state, batches[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    warm_loss = float(m["loss"])
    if want_first is not None:
        same = torch.equal(m["loss"].float().view(torch.int32),
                           want_first.float().view(torch.int32))
        say(f"  first step's loss {warm_loss!r} against the reference "
            f"loss step's {float(want_first)!r}: "
            f"{'bit-equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("the first step's loss is not bit-equal "
                                 "to the reference loss step's")
    _reset_counts()
    times, losses, aux_steps = [], [], []
    for i in range(1, steps + 1):
        with _cuda_profiler() if i == steps else contextlib.nullcontext() \
                as prof:
            t0 = time.perf_counter()
            storage, opt_state, m = step(storage, opt_state, batches[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        aux_steps.append({k: float(m[k]) for k in ("moe_aux", "moe_drops")
                          if k in m})
    aux = aux_steps[-1]
    if aux:
        say(f"  aux terms per timed step: {aux_steps}")
    counts = _train_counts()
    per_step = {k: v / steps for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = batch * seq
    plain = times[:-1] or times
    step_s = sorted(plain)[len(plain) // 2]
    flops = _model_flops(cfg, model, batch, seq)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    say(f"train B={batch} T={seq}: warm-up step {warm * 1e3:.1f} ms; "
        f"steps {[round(t * 1e3, 2) for t in times]} ms (the last "
        f"profiled), median "
        f"{step_s * 1e3:.2f} ms, {tokens / step_s:.1f} tokens/s, "
        f"{flops / 1e12:.2f} model TFLOP/step, MFU {100 * mfu:.2f}% of "
        f"989 TFLOP/s (bound {flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.1f}"
        f" ms), max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"  losses {losses} (warm-up step {warm_loss:.4f}; "
        f"{'falling' if losses[-1] < warm_loss else 'NOT falling'}); "
        f"grad_norm {float(m['grad_norm']):.4f}; lr {float(m['lr']):.3e}")
    say(f"  launches per step: {per_step}")
    state[f"{key}_launches"] = counts
    if not all(np.isfinite([warm_loss, *losses])):
        raise AssertionError(f"non-finite loss: {warm_loss}, {losses}")
    attn = () if cfg.family == "xlstm" else ("flash", "flash_bwd")
    need = ("rmsnorm", *attn, "xent_fwd", "xent_bwd", "adamw", *need)
    unused = [k for k in NOT_DENSE + NOT_BF16 + NOT_F32
              if k not in need and counts[k]]
    if min(counts[k] for k in need) <= 0 or unused:
        raise AssertionError(f"a kernel of the path never launched, or one "
                             f"off the path did: {counts}")
    _check_bwd_calls(counts, model, steps)
    if "ef" in opt_state:
        # the hop applies to the leaves of *_ef buckets alone: every
        # non-zero leaf must be one, and some must be non-zero if any is
        mask = dict(_named(ef_mask(par)))
        ef = {n: a.abs().max().item() for n, a in _named(opt_state["ef"])}
        live = {n for n, v in ef.items() if v > 0}
        on = {n for n, v in mask.items() if v}
        say(f"  error-feedback accumulator: max |ef| "
            f"{max(ef.values()):.3e}; non-zero in {len(live)} of "
            f"{len(ef)} leaves, {len(on)} leaves in *_ef buckets")
        if not live <= on or (on and not live):
            raise AssertionError(f"ef non-zero outside the *_ef buckets or "
                                 f"zero in all of them: {sorted(live - on)}"
                                 f" / {sorted(on)}")
    names = {}
    busy, dev_s = _report(f"{key} step (the last timed one)", prof,
                          times[-1], 1, top=24, launches=names)
    state[f"{key}_kernel_names"] = names
    if dev_s is not None:
        # the profiler costs host time per op: set the device time against
        # the unprofiled median step as well
        say(f"  device kernels {dev_s * 1e3:.2f} ms against the unprofiled "
            f"median step {step_s * 1e3:.2f} ms: {100 * dev_s / step_s:.1f}%"
            " busy")
    state[key] = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                      mfu=mfu, max_memory_allocated=peak, busy=busy,
                      busy_vs_median=None if dev_s is None
                      else dev_s / step_s, **aux)
    return par, storage, opt_state


def phase_full_zamba_train(state):
    # zamba2-1.2b at the reference launcher's defaults: the prefetch stack,
    # bf16 wire, remat fsdp_only, block buckets
    from repro_torch.core.dist import DistConfig
    _full_train(state, "train_zamba2", DistConfig(),
                need=("ssd", "ssd_bwd"), arch="zamba2_1_2b")
    # the profiled step's SSD backward ran on the wgmma kernel: one launch
    # of ssd_grad_sm90_kernel a backward call, none of the fp32 FMA kernel
    names = state["train_zamba2_kernel_names"]
    per_step = state["train_zamba2_launches"]["ssd_bwd"] // TRAIN_STEPS
    grads = sum(c for k, c in names.items() if "ssd_grad_sm90_kernel" in k)
    old = sum(c for k, c in names.items() if "chunk_grad_kernel" in k)
    say(f"  profiled step: ssd_grad_sm90_kernel {grads} launches "
        f"(ssd_bwd calls a step {per_step}), chunk_grad_kernel {old}")
    if names and (grads != per_step or old):
        raise AssertionError("the zamba2 step's SSD backward did not run on "
                             "ssd_grad_sm90_kernel alone")


def _ssd_inputs(g, b, t, h, p, grp, n, dtype, zamba=False):
    """SSD inputs on the card.  `zamba`: the model's own ranges (A = -(1..H)
    from A_log = log(1..H), dt = softplus(dt_pre + dt_bias) with dt_bias at
    dt in [1e-3, 1e-1]); else the reference sweep's.  B and C are the two
    halves of one packed projection, read through their strides."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(b, t, h, p).to(dtype)
    if zamba:
        A = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
        u = torch.rand(h, generator=g, device=dev) * (np.log(1e-1) - np.log(
            1e-3)) + np.log(1e-3)
        dt_bias = torch.log(torch.expm1(torch.exp(u)))
        dt = torch.nn.functional.softplus(randn(b, t, h) + dt_bias)
    else:
        A = -torch.exp(randn(h) * 0.3)
        dt = torch.nn.functional.softplus(randn(b, t, h))
    bc = (randn(b, t, grp, 2 * n) * 0.4).to(dtype)
    D = 1 + 0.1 * randn(h)
    return x, dt, A, bc[..., :n], bc[..., n:], D


def _ssd_bwd_bound(b, t, h, p, grp, n, lc, dtype):
    """(bytes, FLOPs) of one SSD backward: x, dt, A, B, C, D and dy read
    once, dx, ddt, dA, dB, dC and dD written once; the products of the
    lower triangles (C B^T and dy x^T, 2N and 2P a pair; M^T dy, 2P; dCB
    B and dCB^T C, 2N each) and, per row, the four (P, N) products with
    the states (dS_out's own part, dy S_in, B dS_out^T, x dS_out)."""
    e = torch.tensor([], dtype=dtype).element_size()
    n_c = -(-t // lc)
    pairs = lc * (lc + 1) / 2
    nbytes = (3 * b * t * h * p * e            # x, dy; dx
              + 2 * b * t * h * 4              # dt; ddt (fp32)
              + 4 * b * t * grp * n * e        # B, C; dB, dC
              + 4 * h * 4)                     # A, D; dA, dD
    flops = b * h * n_c * ((6 * n + 4 * p) * pairs + 4 * 2 * lc * p * n)
    return nbytes, flops


def _check_ssd_bwd_kernel(ins, ct, lc, plain):
    """The bf16 backward kernel itself (`csrc/ssd_bwd_sm90.cu`), given the
    forward's states: two calls bit-identical, one launch counted a call,
    and the kernel with M and the dCB sum in one bf16 part (`bf16_parts=1`,
    a planted fault inside the kernel) must miss SSD_BF16_GRAD_RMS_REL on
    dx, ddt, dB and dC against the plain reverse-pass backward `plain`."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    _, states, _ = ssd_ops._forward(*ins, lc)
    n0 = ssd_ops.bwd_launches
    one = ssd_ops.ssd_bwd_cuda(*ins, ct, lc, states=states)
    two = ssd_ops.ssd_bwd_cuda(*ins, ct, lc, states=states)
    if ssd_ops.bwd_launches != n0 + 2:
        raise AssertionError("ssd backward: a call did not count one launch")
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    differ = [k for k, a, b in zip(names, one, two) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"ssd backward: two calls differ in {differ}")
    Bsz, T, H, _ = ins[0].shape
    G, N = ins[3].shape[2:]
    say(f"    bf16 backward kernel: two calls bit-identical; "
        f"{ssd_ops.bwd_heads(H, G)} heads a block, dB / dC partials "
        f"{ssd_ops.bwd_buffers(Bsz, T, H, G, N, lc, True)['dBh']}")
    planted = ssd_ops.ssd_bwd_cuda(*ins, ct, lc, states=states, bf16_parts=1)
    for i, k in ((0, "dx"), (1, "ddt"), (3, "dB"), (4, "dC")):
        rel = rms_rel(planted[i], plain[i])
        if rel <= SSD_BF16_GRAD_RMS_REL:
            raise AssertionError(f"ssd backward planted in the kernel (M and "
                                 f"dCB in one bf16 part): {k} within "
                                 f"SSD_BF16_GRAD_RMS_REL ({rel:.3e})")
        say(f"    planted in the kernel, M and the dCB sum in one bf16 part: "
            f"{k} rejected (RMS error / RMS {rel:.3e})")


def _check_ssd_final(name, ins, lc, bf16, tol):
    """The state leaving the sequence from `ops.ssd_with_state` against
    `ref.ssd_chunked`'s S: bf16 to SSD_BF16_RMS_REL, fp32 at TOL32 on the
    summed |terms| (the S of |x|, |B|); the state entering the last chunk
    (the forward's saved states[:, :, -1]), planted in its place, must
    fail."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    x, dt, A, Bm, Cm, D = ins
    n0 = ssd_ops.launches
    _, got = ssd_ops.ssd_with_state(*ins, chunk=lc)
    _, states, _ = ssd_ops._forward(*ins, lc)
    if ssd_ops.launches != n0 + 2:
        raise AssertionError(f"{name}: the final state took no kernel")
    want = ssd_ref.ssd_chunked(*ins, chunk=lc)[1]
    planted = states[:, :, -1]
    what = f"{name} final state"
    if bf16:
        check_rms(what, got, want, SSD_BF16_RMS_REL)
        check_plant_rejected("final state: the state entering the last "
                             "chunk", planted, want, SSD_BF16_RMS_REL)
    else:
        terms = ssd_ref.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(),
                                    None, lc)[1]
        check_terms(what, got, want, terms, tol)
        check_rejects_terms(f"{what} planted: the state entering the last "
                            "chunk", planted, want, terms, tol)


def phase_ssd_kernels(state):
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    g = torch.Generator(device="cuda").manual_seed(4)
    full = (TRAIN_B, TRAIN_T, 64, 64, 1, 64, 128)   # zamba2-1.2b's layers
    say("ssd forward kernels vs plain (ms: kernel / plain / bound):")
    cases = [  # (name, (B, T, H, P, G, N, chunk), dtype, zamba ranges)
        ("full zamba2-1.2b B4 T2048 H64 P64 N64 chunk 128 bf16", full,
         torch.bfloat16, True),
        ("full zamba2-1.2b shape fp32", full, torch.float32, True),
        ("sweep T96 H4 P16 G2 N8 chunk 32 fp32", (2, 96, 4, 16, 2, 8, 32),
         torch.float32, False),
        ("sweep T96 H4 P16 G2 N8 chunk 32 bf16", (2, 96, 4, 16, 2, 8, 32),
         torch.bfloat16, False),
        ("sweep T128 H2 P32 G1 N16 chunk 64 fp32",
         (2, 128, 2, 32, 1, 16, 64), torch.float32, False),
        ("sweep T64 H4 P16 G4 N8 chunk 64 fp32", (2, 64, 4, 16, 4, 8, 64),
         torch.float32, False),
        ("T300 H4 P64 N64 chunk 128 (ragged) bf16",
         (1, 300, 4, 64, 1, 64, 128), torch.bfloat16, False),
        ("T12 H2 P32 N16 chunk 16 (12-row chunk) bf16",
         (1, 12, 2, 32, 1, 16, 16), torch.bfloat16, False),
        ("smoke T40 H8 P16 N8 chunk 16 (ragged) fp32",
         (4, 40, 8, 16, 1, 8, 16), torch.float32, True),
        ("smoke T40 H8 P16 N8 chunk 16 (ragged) bf16",
         (4, 40, 8, 16, 1, 8, 16), torch.bfloat16, True),
    ]
    # the full-width serve's prefills: T 2064 and, in its p + 1 check,
    # 2063 (last chunks of 16 and 15 rows)
    for t_serve in (T, T - 1):
        for dt_, label in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            cases.append((f"full zamba2-1.2b serve prefill T{t_serve} "
                          f"(ragged) {label}", (TRAIN_B, t_serve) + full[2:],
                          dt_, True))
    for i, (name, (b, t, h, p, grp, n, lc), dt_, zamba) in enumerate(cases):
        ins = _ssd_inputs(g, b, t, h, p, grp, n, dt_, zamba)
        bf16 = dt_ == torch.bfloat16
        tol = TOL if bf16 else TOL32
        wide = h * p == full[2] * full[3]
        n0, n32 = ssd_ops.launches, ssd_ops.launches_f32
        got = ssd_ops.ssd_cuda(*ins, chunk=lc)
        if (ssd_ops.launches, ssd_ops.launches_f32) != \
                (n0 + 1, n32 if bf16 else n32 + 1):
            raise AssertionError(f"{name}: took the wrong route")
        want, _ = ssd_ref.ssd_chunked(*ins, chunk=lc)
        x, dt, A, Bm, Cm, D = ins
        if bf16:
            err = check_rms(name, got, want, SSD_BF16_RMS_REL)
        elif wide:
            err = check_terms(name, got, want, ssd_ref.ssd_chunked(
                x.abs(), dt, A, Bm.abs(), Cm.abs(), D.abs(), lc)[0], tol)
        else:
            err = check_close(name, got, want, tol)
        if i in (0, 1):
            # the state not carried: each chunk from S = 0, the inter-chunk
            # term dropped
            planted = torch.cat([ssd_ref.ssd_chunked(
                x[:, c:c + lc], dt[:, c:c + lc], A, Bm[:, c:c + lc],
                Cm[:, c:c + lc], D, lc)[0] for c in range(0, t, lc)], dim=1)
            if bf16:
                check_plant_rejected("state not carried", planted, want,
                                     SSD_BF16_RMS_REL)
            else:
                check_rejects(f"{name} planted: state not carried", planted,
                              want, tol)
            del planted
        if bf16:
            check_plant_rejected("M in one bf16 part",
                                 ssd_one_part_m(*ins, lc), want,
                                 SSD_BF16_RMS_REL)
        elif i in (1, 8):
            # one TF32 product in place of three
            planted = ssd_ops.ssd_cuda(*ins, chunk=lc, tf32_products=1)
            terms = ssd_ref.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(),
                                        D.abs(), lc)[0]
            check_rejects_terms(f"{name} planted: one TF32 product", planted,
                                want, terms, tol)
            if i == 8:
                check_rejects(f"{name} planted: one TF32 product "
                              "(elementwise)", planted, want, tol)
            del planted, terms
        if wide or t % lc:
            _check_ssd_final(name, ins, lc, bf16, tol)
        del want, got
        if i > 1:
            continue
        ms = time_ms(lambda: ssd_ops.ssd_cuda(*ins, chunk=lc))
        plain = time_ms(lambda: ssd_ref.ssd_chunked(*ins, chunk=lc))
        # x, dt, B, C, A, D read once, y written once
        nbytes = sum(a.numel() * a.element_size() for a in (x, dt, A, D)) \
            + 2 * Bm.numel() * Bm.element_size() \
            + x.numel() * x.element_size()
        flops = _ssd_flops(b, t, h, p, n, lc)
        bound, by = _bound(nbytes, flops, dt_, products=True)
        dev_ms = device_ms(lambda: ssd_ops.ssd_cuda(*ins, chunk=lc), bound)
        say(f"    {ms:.4f} / {plain:.4f} / {bound:.4f} ({by}; "
            f"{nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s);"
            f" device {_ms(dev_ms)} ms")
        state["ssd" if bf16 else "ssd_f32"] = dict(
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None)
        torch.cuda.empty_cache()

    say("ssd gradients: kernel forward + kernel backward vs autograd "
        "through the plain version (ms fwd+bwd: kernels / plain):")
    names = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")
    b, t, h, p, grp, n, lc = full
    for dt_ in (torch.bfloat16, torch.float32):
        bf16 = dt_ == torch.bfloat16
        tol = TOL if bf16 else TOL32
        ins = _ssd_inputs(g, b, t, h, p, grp, n, dt_, True)
        ct = torch.randn((b, t, h, p), generator=g, device="cuda").to(dt_)
        n0, nb = ssd_ops.launches, ssd_ops.bwd_launches
        got = _grads(lambda *a: ssd_ops.ssd(*a, chunk=lc), ins, ct)
        if (ssd_ops.launches, ssd_ops.bwd_launches) != (n0 + 1, nb + 1):
            raise AssertionError("ssd: the backward kernels did not launch")
        want = _grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=lc)[0], ins,
                      ct)
        x, dt, A, Bm, Cm, D = ins
        label = "bf16" if bf16 else "fp32"
        errs = {}
        if bf16:
            for k, a, b_ in zip(names, got, want):
                what = f"ssd full bf16 {k}"
                errs[k] = check_rms(what, a, b_, SSD_BF16_RMS_REL) \
                    if k == "y" else check_close(what, a, b_, tol)
            # dx, ddt, dB, dC against the plain reverse-pass backward, and
            # that backward with M and dM o L in one bf16 part (the kernels
            # split them into hi + lo), which must fail the limit
            plain = ssd_ref.ssd_chunked_bwd(*ins, ct, lc)
            say(f"    autograd's dx vs the plain reverse-pass backward: RMS "
                f"error / RMS {rms_rel(want[1], plain[0]):.3e}")
            states, _ = ssd_ref.ssd_chunk_states(x, dt, A, Bm, Cm, lc)
            one_part = ssd_ref._chunk_grads(
                *ins, ct, states, ssd_ref.ssd_chunk_dstates(ct, dt, A, Cm, lc),
                lc, one_part=True)
            for i, k in ((0, "dx"), (1, "ddt"), (3, "dB"), (4, "dC")):
                check_rms(f"ssd full bf16 {k} vs the plain reverse-pass "
                          "backward", got[i + 1], plain[i],
                          SSD_BF16_GRAD_RMS_REL)
                check_plant_rejected(f"{k}, M and dM o L in one bf16 part",
                                     one_part[i].to(plain[i].dtype), plain[i],
                                     SSD_BF16_GRAD_RMS_REL)
            _check_ssd_bwd_kernel(ins, ct, lc, plain)
            del plain, states, one_part
        else:
            terms = (ssd_ref.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(),
                                         D.abs(), lc)[0],
                     *ssd_ref.ssd_grad_terms(*ins, ct, lc))
            for k, a, b_, tm in zip(names, got, want, terms):
                what = f"ssd full fp32 {k}"
                errs[k] = check_scaled(what, a, b_, tol) \
                    if k in ("dA", "dD") else check_terms(what, a, b_, tm, tol)
            del terms
        # dA and dD: one per head, summed over B*T; a group sum that took
        # the first half of the (batch, chunk) partials (the first B/2
        # sequences' dA), and dD = 0, must fail their checks
        half = ssd_ref.ssd_chunked_bwd(
            *(a[:b // 2] if a.dim() > 1 else a for a in ins), ct[:b // 2],
            lc)[2]
        for k, planted, w in (("dA from half the chunks' partials", half,
                               want[3]),
                              ("dD = 0", torch.zeros_like(want[6]), want[6])):
            s = 1.0 if bf16 else scaled(w)
            check_rejects(f"ssd full {label} planted {k}"
                          f"{'' if bf16 else ' (/ max|want|)'}", planted / s,
                          w / s, tol)
        del got, want, half
        # the backward's own time, given the forward's states
        _, states, _ = ssd_ops._forward(*ins, lc)
        bwd = lambda: ssd_ops.ssd_bwd_cuda(*ins, ct, lc, states=states)
        nbytes, flops = _ssd_bwd_bound(b, t, h, p, grp, n, lc, dt_)
        bound, by = _bound(nbytes, flops, dt_, products=True)
        ms_bwd = time_ms(bwd)
        dev_bwd = device_ms(bwd, bound)
        plain_bwd = time_ms(lambda: ssd_ref.ssd_chunked_bwd(*ins, ct, lc))
        ms = time_ms(lambda: _grads(lambda *a: ssd_ops.ssd(*a, chunk=lc),
                                    ins, ct))
        plain = time_ms(lambda: _grads(
            lambda *a: ssd_ref.ssd_chunked(*a, chunk=lc)[0], ins, ct))
        say(f"    backward alone: {ms_bwd:.4f} ms (device {_ms(dev_bwd)}), "
            f"plain reverse-pass backward {plain_bwd:.4f}, bound "
            f"{bound:.4f} ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP); fwd+bwd {ms:.4f} / plain {plain:.4f}")
        state["ssd_bwd" if bf16 else "ssd_bwd_f32"] = dict(
            max_abs_err=max(errs[k] for k in names[1:]), ms=ms_bwd,
            device_ms=dev_bwd, plain_ms=plain_bwd, bound_ms=bound,
            bound_by=by, library_ms=None, fwd_bwd_ms=ms,
            plain_fwd_bwd_ms=plain)
        del states
        torch.cuda.empty_cache()


def phase_zamba_smoke_train(state):
    import shutil
    import tempfile
    from repro_torch.core.meta import named_leaves
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_step import init_train_state
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_zamba_"))
    try:
        def trainer(dev, sub, reorder):
            return launch_train.build_trainer(launch_train.parse_args([
                "--arch", "zamba2_1_2b", "--smoke", "--steps", "3", "--seq",
                "40", "--batch", "4", "--dtype", "float32", "--device", dev,
                "--ckpt-dir", str(root / sub)]
                + ([] if reorder else ["--no-reorder"])))

        # one CPU-made step-0 checkpoint starts every run
        cpu = trainer("cpu", "seed", False)
        storage, opt = init_train_state(cpu.par,
                                        torch.Generator().manual_seed(0))
        cpu.ckpt.save(0, cpu.par.unshard(storage), dict(
            m=cpu.par.unshard(opt["m"]), v=cpu.par.unshard(opt["v"]),
            step=opt["step"]), cpu.model, cpu.dcfg)
        need = ("rmsnorm", "flash_f32", "flash_bwd_f32", "xent_fwd",
                "xent_bwd", "adamw", "ssd", "ssd_f32", "ssd_bwd",
                "ssd_bwd_f32")
        for reorder in (False, True):
            runs = {}
            for dev in ("cpu", "cuda"):
                sub = f"{dev}_{reorder}"
                shutil.copytree(root / "seed", root / sub)
                tr = trainer(dev, sub, reorder)
                _reset_counts()
                st, _, hist = tr.run()
                runs[dev] = (st, hist, _train_counts())
            label = "prefetch" if reorder else "vanilla"
            counts = runs["cuda"][2]
            state["zamba_smoke_launches"] = counts
            say(f"  zamba2 smoke {label}: launches on the card {counts}")
            if (min(counts[k] for k in need) <= 0
                    or any(counts[k] for k in NOT_F32)
                    or counts["ssd_f32"] != counts["ssd"]
                    or counts["ssd_bwd_f32"] != counts["ssd_bwd"]):
                raise AssertionError(f"a kernel never launched, or fp32 "
                                     f"took a bf16 route: {counts}")
            _check_bwd_calls(counts, tr.model, 3, "flash_bwd_f32")
            if max(v for k, v in runs["cpu"][2].items()
                   if k not in COLLECTIVES) > 0:
                raise AssertionError("the CPU run launched a kernel")
            for hc, hg in zip(runs["cpu"][1], runs["cuda"][1]):
                for k in ("loss", "grad_norm"):
                    check_close(f"zamba2 smoke {label} step {hc['step']} {k} "
                                "cuda vs cpu", torch.tensor(hg[k]),
                                torch.tensor(hc[k]), TOL32)
            errs = [check_close(f"zamba2 smoke {label} storage {n}", a.cpu(),
                                b, TOL32)
                    for (n, a), (_, b) in zip(named_leaves(runs["cuda"][0]),
                                              named_leaves(runs["cpu"][0]))]
            say(f"  zamba2 smoke {label} storage cuda vs cpu after 3 steps: "
                f"{len(errs)} leaves, max abs err {max(errs):.3e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
            flash_ops.launches_f32 = 0
            logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)
                                        .to(dev)})
            if dev == "cuda" and not (rms_ops.launches
                                      and flash_ops.launches_f32
                                      and not flash_ops.launches):
                raise AssertionError(f"{arch}: the fp32 smoke prefill on the "
                                     "card did not launch rmsnorm and flash's"
                                     " fp32 route (and only that route)")
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

    _reset_counts()
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN)
    counts = _serve_counts()

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
    if counts["rmsnorm"] <= 0 or counts["flash"] <= 0 or any(
            counts[k] for k in ("flash_f32", "flash_bwd", "flash_bwd_f32")):
        raise AssertionError(f"a kernel of the path never launched, bf16 "
                             f"took flash's fp32 route, or a backward ran: "
                             f"{counts}")

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
    b, t = x.shape
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    _reset_counts()
    want, _ = prefill(params, {"tokens": x})
    per_call = dict(prefill=_serve_counts())
    xp = x.clone()
    xp[:, -1] = 3
    _, cache = prefill(params, {"tokens": xp})
    _reset_counts()
    got, _ = decode(params, cache, x[:, -1],
                    torch.full((b,), t - 1, dtype=torch.int64,
                               device=x.device))
    per_call["decode"] = _serve_counts()
    top2 = want.topk(2, dim=-1).values
    say(f"  {label}: max|logit| {want.abs().max().item():.4f}, max abs err "
        f"{max_err(got, want):.4e}, mean abs err "
        f"{(got - want).abs().mean().item():.4e}, top-2 gaps "
        f"{[round(v, 5) for v in (top2[:, 0] - top2[:, 1]).tolist()]}, "
        f"argmax {want.argmax(-1).tolist()} vs {got.argmax(-1).tolist()}")
    return want, got, per_call


# ---------------------------------------------------------------------------
# The moe family (the main path of the tenth slice)
# ---------------------------------------------------------------------------
MOE_ARCHS = ("qwen3_moe_30b_a3b", "qwen2_moe_a2_7b")
# full-width moe training keeps every published width and cuts the depth
# (48 and 24 layers) to 4: fp32 storage, grads and AdamW moments take 16
# bytes a parameter, 46.4 GiB at 4 layers of qwen3-moe-30b-a3b (623.1M a
# layer, 622.3M in the embedding and head); the plan's modeled peak is
# 60.52 GiB under the H100 profile's 74.51
MOE_TRAIN_LAYERS = 4
# the router at these seeds has collapsed: a full-width moe training step
# on SyntheticC4 drops 0.8002 (qwen3-moe-30b-a3b) and 0.8038
# (qwen2-moe-a2.7b) of its choices in the last timed step, 0.73-0.80 over
# the steps (H100).  SyntheticC4's Zipf head gives layer 0's router input a
# vector common to all tokens (common share 0.945 / 0.963; the embeddings'
# 0.076 / 0.070), which uniform random tokens do not give it (0.036 /
# 0.028): layer 0 drops 0.64 / 0.69 on SyntheticC4 and 0.078 / 0.078 on
# uniform tokens.  The 48-layer prefill of uniform random prompts drops
# 0.3946, rising from 0.0054 in layer 0.  The gates hold these readings
MOE_DROP_BAND = (0.70, 0.90)
MOE_COMMON_SHARE = 0.5          # SyntheticC4's above it, uniform's below
MOE_UNIFORM_LAYER0_DROPS = 0.2
MOE_PREFILL_DROP_BAND = (0.30, 0.50)


def _spy_routes(model):
    """Records the expert ids of every `_route` call of `model` (on the
    CPU, in call order)."""
    seen, route = [], model._route

    def spy(x2d, router):
        w, ids, aux = route(x2d, router)
        seen.append(ids.cpu())
        return w, ids, aux

    model._route = spy
    return seen


def _spy_drops(model):
    """Records, as device scalars, the (token, choice) pairs each dispatch
    of `model` drops over capacity."""
    seen, dispatch = [], model._dispatch

    def spy(ids, C, ep):
        pos, keep, slot = dispatch(ids, C, ep)
        seen.append((~keep).sum())
        return pos, keep, slot

    model._dispatch = spy
    return seen


def phase_moe_kernels(state):
    """The kernels at the moe path's new shapes: bf16 flash at
    qwen3-moe-30b-a3b's attention (a GQA group of 8), its training
    gradient (`flash_grad_case`: forward and backward kernels) against
    autograd through the plain version, and AdamW on the path's largest
    leaf (an expert stack of MOE_TRAIN_LAYERS layers)."""
    import torch.nn.functional as F
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.adamw import ref as adamw_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    b, s, h, kh, hd = TRAIN_B, TRAIN_T, 32, 4, 128
    name = (f"flash B{b} T{s} H{h} Kh{kh} hd{hd} causal bf16 "
            "(qwen3-moe-30b-a3b, GQA group 8)")
    q = randn(b, s, h, hd, dtype=torch.bfloat16)
    k = randn(b, s, kh, hd, dtype=torch.bfloat16)
    v = randn(b, s, kh, hd, dtype=torch.bfloat16)
    want = flash_ref.attention(q, k, v, causal=True)
    n = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=True)
    if flash_ops.launches != n + 1:
        raise AssertionError("the bf16 flash kernel did not launch")
    say("flash kernel vs plain at the moe shape (ms: kernel / plain / SDPA "
        "/ bound):")
    err = check_rms(name, got, want, FLASH_BF16_RMS_REL)
    check_flash_plants(name, q, k, v, want, causal=True)
    del got, want
    flops = 4.0 * hd * b * h * s * (s + 1) / 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = _bound(nbytes, flops, torch.bfloat16, products=True)
    fwd = lambda: flash_ops.flash_attention(q, k, v, causal=True)
    ms, on_card = time_ms(fwd), device_ms(fwd, bound)
    plain = time_ms(lambda: flash_ref.attention(q, k, v, causal=True))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    lib, lib_dev = time_ms(sdpa), device_ms(sdpa, bound)
    say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} ({by}; "
        f"{flops / ms / 1e9:.1f} TFLOP/s); device {_ms(on_card)}, SDPA "
        f"device {_ms(lib_dev)}")
    state["flash_group8"] = dict(
        shape=f"B{b} T{s} H{h} Kh{kh} hd{hd} causal bf16", max_abs_err=err,
        ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib,
        library_device_ms=lib_dev, bound_ms=bound, bound_by=by)

    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    say("flash backward kernels at the moe shape (a GQA group of 8: dK and "
        "dV summed over 8 query heads):")
    flash_grad_case(state, "flash_bwd_group8", f"flash B{b} T{s} H{h} "
                    f"Kh{kh} hd{hd} causal bf16", b, s, h, kh, hd,
                    dict(causal=True), torch.bfloat16, g)

    n = MOE_TRAIN_LAYERS * 128 * 2048 * 768
    say(f"adamw kernel vs plain at the moe path's largest leaf (n={n}; ms: "
        "kernel / plain / bound):")
    p, gd, m = randn(n), randn(n), randn(n) * 0.1
    v = randn(n).abs() * 0.01
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
              lr=torch.tensor(3e-4, device=dev),
              t=torch.tensor(7, dtype=torch.int32, device=dev),
              scale=torch.tensor(0.5, device=dev))
    want = adamw_ref.adamw_update(p, gd, m, v, **kw)
    got = [a.clone() for a in (p, m, v)]
    adamw_ops.adamw_update(got[0], gd, got[1], got[2], **kw)
    err = max(check_close(f"adamw n={n} dp", got[0] - p, want[0] - p,
                          TOL32),
              *(check_close(f"adamw n={n} {k_}", a, b_, TOL32)
                for k_, a, b_ in zip("mv", got[1:], want[1:])))
    del want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: adamw_ops.adamw_update(got[0], gd, got[1], got[2],
                                                **kw))
    plain = time_ms(lambda: adamw_ref.adamw_update(p, gd, m, v, **kw))
    bound, by = _bound(28 * n, 15.0 * n)
    say(f"    {ms:.4f} / {plain:.4f} / {bound:.4f} ({28 * n / ms / 1e6:.0f}"
        " GB/s)")
    state["adamw_moe_leaf"] = dict(n=n, max_abs_err=err, ms=ms,
                                   plain_ms=plain, bound_ms=bound,
                                   bound_by=by)


def phase_moe_smoke(state):
    """Both moe SMOKE configs, fp32, card vs CPU: 3 training steps through
    the launcher's trainer on the vanilla and the prefetch stack from one
    CPU-made checkpoint (losses, grad norms, storage at TOL32, the routing
    ids of every dispatch EQUAL), a bit-exact prefetch restart, one loss
    step at capacity_factor 1.0 (tokens dropped) with the aux in the loss,
    and serving: prefill and 4 decode steps card vs CPU, and prefill over
    p+1 tokens against prefill over p + one decode step on the card."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core.api import parallelize
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import named_leaves, tree_map
    from repro_torch.ft.failures import InjectedFailures
    from repro_torch.launch import train as launch_train
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.train import serve as SV
    from repro_torch.train.train_step import _loss_and_grads, \
        init_train_state
    from repro_torch.train.trainer import Trainer
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    need = ("rmsnorm", "flash_f32", "flash_bwd_f32", "xent_fwd", "xent_bwd",
            "adamw")
    try:
        for arch in MOE_ARCHS:
            def trainer(dev, sub, reorder):
                return launch_train.build_trainer(launch_train.parse_args([
                    "--arch", arch, "--smoke", "--steps", "3", "--seq", "32",
                    "--batch", "4", "--dtype", "float32", "--device", dev,
                    "--ckpt-dir", str(root / arch / sub)]
                    + ([] if reorder else ["--no-reorder"])))

            cpu = trainer("cpu", "seed", False)
            storage, opt = init_train_state(
                cpu.par, torch.Generator().manual_seed(0))
            cpu.ckpt.save(0, cpu.par.unshard(storage), dict(
                m=cpu.par.unshard(opt["m"]), v=cpu.par.unshard(opt["v"]),
                step=opt["step"]), cpu.model, cpu.dcfg)
            for reorder in (False, True):
                label = f"{arch} smoke {'prefetch' if reorder else 'vanilla'}"
                runs = {}
                for dev in ("cpu", "cuda"):
                    sub = f"{dev}_{reorder}"
                    shutil.copytree(root / arch / "seed", root / arch / sub)
                    tr = trainer(dev, sub, reorder)
                    ids = _spy_routes(tr.model)
                    _reset_counts()
                    st, _, hist = tr.run()
                    runs[dev] = (st, hist, _train_counts(), ids)
                counts = runs["cuda"][2]
                state[f"moe_smoke_{arch}_launches"] = counts
                say(f"  {label}: launches on the card {counts}")
                if min(counts[k] for k in need) <= 0 \
                        or any(counts[k] for k in NOT_DENSE + NOT_F32):
                    raise AssertionError(f"a kernel never launched, or one "
                                         f"off the path did: {counts}")
                _check_bwd_calls(counts, tr.model, 3, "flash_bwd_f32")
                if max(v for k, v in runs["cpu"][2].items()
                       if k not in COLLECTIVES) > 0:
                    raise AssertionError("the CPU run launched a kernel")
                cids, gids = runs["cpu"][3], runs["cuda"][3]
                diff = [i for i, (a, b_) in enumerate(zip(cids, gids))
                        if not torch.equal(a, b_.cpu())]
                same = not diff and len(cids) == len(gids)
                say(f"  {label}: routing ids of {len(gids)} dispatches, "
                    f"{'all equal' if same else 'DIFFERENT'} card vs CPU")
                if not same:
                    i = diff[0] if diff else min(len(cids), len(gids))
                    rows = 0 if not diff else int(
                        (cids[i] != gids[i]).any(-1).sum())
                    raise AssertionError(
                        f"{label}: routing ids differ card vs CPU at "
                        f"dispatch {i} of {len(cids)} / {len(gids)} "
                        f"({rows} rows)")
                for hc, hg in zip(runs["cpu"][1], runs["cuda"][1]):
                    for k in ("loss", "grad_norm", "moe_drops"):
                        check_close(f"{label} step {hc['step']} {k} cuda vs "
                                    "cpu", torch.tensor(hg[k]),
                                    torch.tensor(hc[k]), TOL32)
                    if hg["moe_drops"]:
                        raise AssertionError(f"{label}: SMOKE dropped "
                                             f"{hg['moe_drops']} choices")
                errs = [check_close(f"{label} storage {n}", a.cpu(), b_,
                                    TOL32)
                        for (n, a), (_, b_) in zip(
                            named_leaves(runs["cuda"][0]),
                            named_leaves(runs["cpu"][0]))]
                say(f"  {label} storage cuda vs cpu after 3 steps: "
                    f"{len(errs)} leaves, max abs err {max(errs):.3e}")

            shutil.copytree(root / arch / "seed", root / arch / "restart")
            cuda = trainer("cuda", "restart", True)
            tr = Trainer(cuda.model, cuda.dcfg, cuda.shape, cuda.ocfg,
                         dataclasses.replace(cuda.tcfg, ckpt_every=1),
                         failure_source=InjectedFailures((2,)),
                         device="cuda")
            resumed, _, _ = tr.run()
            exact = all(torch.equal(a, b_) for (_, a), (_, b_) in zip(
                named_leaves(resumed), named_leaves(runs["cuda"][0])))
            say(f"  {arch} smoke prefetch restart after a failure at step 2:"
                f" restarts {tr.restarts}, "
                f"{'bit-exact' if exact else 'NOT bit-exact'}")
            if tr.restarts != 1 or not exact:
                raise AssertionError("the restarted run is not bit-exact")

            # tokens dropped over capacity and the aux in the loss
            model = build_model(dataclasses.replace(
                cpu.model.cfg, capacity_factor=1.0, router_aux_coef=1e-2))
            dcfg = cpu.dcfg.with_(reorder=True)
            st = parallelize(model, dcfg, cpu.shape, device="cpu") \
                .init_storage(torch.Generator().manual_seed(1))
            out = {}
            for dev in ("cpu", "cuda"):
                par = parallelize(model, dcfg, cpu.shape, device=dev)
                out[dev] = _loss_and_grads(
                    par, tree_map(lambda a: a.to(dev), st),
                    par.local_batch(cpu.data.batch(0)))
            tag = f"{arch} capacity_factor 1.0 loss step"
            check_close(f"{tag} loss cuda vs cpu", out["cuda"][0].cpu(),
                        out["cpu"][0], TOL32)
            for k in ("moe_aux", "moe_drops"):
                check_close(f"{tag} {k} cuda vs cpu", out["cuda"][2][k].cpu(),
                            out["cpu"][2][k], TOL32)
            errs = [check_close(f"{tag} grad {n}", a.cpu(), b_, TOL32)
                    for (n, a), (_, b_) in zip(named_leaves(out["cuda"][1]),
                                               named_leaves(out["cpu"][1]))]
            drops = float(out["cuda"][2]["moe_drops"])
            say(f"  {tag}: grads max abs err {max(errs):.3e}; {drops:.0f} "
                f"choices dropped, aux {float(out['cuda'][2]['moe_aux']):.4e}")
            if drops <= 0:
                raise AssertionError(f"{tag}: nothing was dropped")

            # serving
            cfg, model = get_arch(arch, smoke=True)
            dcfg = single_device_config(param_dtype=torch.float32)
            tree = _numpy_params(model, dcfg, seed=0)
            b, prompt, gen = 2, 12, 4
            t_len = prompt + gen
            rng = np.random.default_rng(1)
            tokens = torch.from_numpy(np.pad(
                rng.integers(3, cfg.vocab, (b, prompt)), ((0, 0), (0, gen)),
                constant_values=3))
            runs = {}
            for dev in ("cpu", "cuda"):
                params = SV.serve_params_from_jax(tree, model, dcfg,
                                                  device=dev)
                pf = SV.make_prefill_step(
                    model, dcfg, ShapeConfig("p", t_len, b, "prefill"))
                dec = SV.make_decode_step(
                    model, dcfg, ShapeConfig("d", t_len, b, "decode"))
                logits, cache = pf(params, {"tokens": tokens.to(dev)})
                runs[dev] = dict(params=params, pf=pf, dec=dec, cache=cache,
                                 logits=[logits.cpu()])
            check_close(f"{arch} smoke prefill logits cuda vs cpu",
                        runs["cuda"]["logits"][0], runs["cpu"]["logits"][0],
                        TOL32)
            for i in range(gen):
                tok = runs["cpu"]["logits"][-1].argmax(-1)
                if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1),
                                   tok):
                    raise AssertionError(f"{arch}: greedy tokens differ at "
                                         f"{i}")
                pos = torch.full((b,), prompt + i, dtype=torch.int64)
                for dev, r in runs.items():
                    logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                                  tok.to(dev), pos.to(dev))
                    r["logits"].append(logits.cpu())
                check_close(f"{arch} smoke decode {i} logits cuda vs cpu",
                            runs["cuda"]["logits"][-1],
                            runs["cpu"]["logits"][-1], TOL32)
            # prefill over p+1 tokens against prefill over p + a decode
            # step holds only where no choice is dropped: capacity depends
            # on the tokens in a call (B*T in prefill, B in decode), so a
            # dropping prefill routes differently from the decode.  SMOKE's
            # capacity_factor 8 gives every expert room for all the tokens
            # of a call, so its drop count must be 0
            r = runs["cuda"]
            drops = _spy_drops(model)
            x = torch.from_numpy(rng.integers(3, cfg.vocab, (b, t_len))) \
                .to("cuda")
            want, _ = r["pf"](r["params"], {"tokens": x})
            xp = x.clone()
            xp[:, -1] = 3
            _, cache = r["pf"](r["params"], {"tokens": xp})
            got, _ = r["dec"](r["params"], cache, x[:, -1], torch.full(
                (b,), t_len - 1, dtype=torch.int64, device="cuda"))
            dropped = int(sum(d.item() for d in drops))
            del model._dispatch
            check_close(f"{arch} smoke on the card: prefill over p+1 vs "
                        "prefill over p + one decode step", got, want, TOL32)
            say(f"  {arch}: {len(drops)} dispatches, {dropped} choices "
                "dropped")
            if dropped:
                raise AssertionError(f"{arch}: SMOKE dropped {dropped}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _moe_expert_flops(cfg, tokens, executed):
    """FLOPs of one training step's routed-expert products (3 x the
    forward, 2 a multiply-add): of the k choices a token makes
    (`executed` False: what the model applies) or of every capacity slot
    of every padded expert (`executed` True: what the step computes)."""
    from repro_torch.models.moe import capacity, experts_padded
    ep = experts_padded(cfg, 1)
    rows = ep * capacity(cfg, tokens, ep) if executed \
        else tokens * cfg.n_experts_active
    return 6.0 * cfg.n_layers * 3 * cfg.d_model * cfg.d_ff_expert * rows


def _common_share(x):
    """||the rows' mean||^2 / the mean of ||row||^2 of a (T, D) tensor: 1
    where every row is one vector, about 1/T where the rows are
    independent."""
    x = x.float()
    return float(x.mean(0).square().sum() / x.square().sum(1).mean())


def _route_reading(par, storage, batch, label):
    """One forward pass (no grad) of the moe model `par.model` on `batch`:
    the drop share of every layer, and in layer 0 the experts' occupancy
    (choices an expert against its capacity), the spread of the router
    logits across tokens (the std over tokens, averaged over experts) and
    across experts (the std of the experts' mean logits), and the common
    share (`_common_share`) of the router's input, over the batch and
    within a sequence, and of the embeddings.  Returns the readings."""
    from repro_torch.models import layers as LY
    from repro_torch.models.moe import capacity
    model, cfg = par.model, par.model.cfg
    seen, attn, route = {}, model._attn_half, model._route

    def attn_spy(p, rope, x, dcfg, window):
        seen.setdefault("emb", x.detach())
        return attn(p, rope, x, dcfg, window)

    def route_spy(x2d, router):
        w, ids, aux = route(x2d, router)
        seen.setdefault("route", (x2d.detach(), router.detach(), ids))
        return w, ids, aux

    model._attn_half, model._route = attn_spy, route_spy
    drops = _spy_drops(model)
    try:
        with torch.no_grad():
            model.loss_local(storage, par.local_batch(batch),
                             par.plan.exec_dcfg,
                             par.plan.bucket_plan("blocks"))
    finally:
        del model._attn_half, model._route, model._dispatch
    x2d, router, ids = seen["route"]
    emb = seen["emb"]
    b, s, d = emb.shape
    T, k = x2d.shape[0], cfg.n_experts_active
    C = capacity(cfg, T, router.shape[1])
    shares = [float(n) / (T * k) for n in drops]
    occ = torch.bincount(ids.reshape(-1), minlength=router.shape[1])
    occ = occ[:cfg.n_experts].sort(descending=True).values.tolist()
    logits = LY.matmul_f32(x2d, router)[:, :cfg.n_experts]
    r = dict(
        drop_share_by_layer=shares,
        top_k_experts_share=sum(occ[:k]) / (T * k),
        experts_over_capacity=sum(c > C for c in occ),
        experts_empty=sum(c == 0 for c in occ),
        logit_spread_tokens=float(logits.std(0).mean()),
        logit_spread_experts=float(logits.mean(0).std()),
        common_share_router_input=_common_share(x2d),
        common_share_in_a_sequence=float(np.mean([
            _common_share(x2d.view(b, s, d)[i]) for i in range(b)])),
        common_share_embeddings=_common_share(emb.reshape(-1, d)))
    say(f"  routing on {label}: drop share by layer "
        f"{[round(v, 4) for v in shares]}; layer 0: choices an expert "
        f"(capacity {C}) top {k} {occ[:k]}, median {occ[len(occ) // 2]}; "
        f"{r['experts_over_capacity']} experts over capacity, "
        f"{r['experts_empty']} empty; the top {k} hold "
        f"{r['top_k_experts_share']:.4f} of the choices")
    say(f"    layer 0 router logits: spread across tokens "
        f"{r['logit_spread_tokens']:.4f}, across experts "
        f"{r['logit_spread_experts']:.4f}; common share of the router "
        f"input {r['common_share_router_input']:.4f} (within a sequence "
        f"{r['common_share_in_a_sequence']:.4f}), of the embeddings "
        f"{r['common_share_embeddings']:.4f}")
    return r


def _full_moe_train(state, arch):
    """Full-width moe training, MOE_TRAIN_LAYERS layers, the reference
    launcher's defaults (the prefetch stack, bf16 wire, fsdp_only, block
    buckets), through `_full_train`, with the moe readings besides: the
    modeled peak and step, the drop share and the aux."""
    from repro_torch.core.dist import DistConfig
    from repro_torch.core.obs import drift
    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.moe import capacity, experts_padded
    key = f"train_{arch}"
    par, storage, _ = _full_train(state, key, DistConfig(), arch=arch,
                                  layers=MOE_TRAIN_LAYERS)
    cfg, tokens = par.model.cfg, TRAIN_B * TRAIN_T
    # the router's choices on the last timed step's batch, and on uniform
    # random tokens of the same shape, with the trained weights
    c4 = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_T,
                                global_batch=TRAIN_B, seed=0)) \
        .batch(TRAIN_STEPS)
    toks = np.random.default_rng(5).integers(
        3, cfg.vocab, (TRAIN_B, TRAIN_T + 1)).astype(np.int32)
    uniform = dict(tokens=toks[:, :-1],
                   targets=np.ascontiguousarray(toks[:, 1:]),
                   valid=np.ones((TRAIN_B, TRAIN_T), np.float32))
    routing = {"SyntheticC4": _route_reading(
        par, storage, c4, "SyntheticC4, the last timed step's batch"),
        "uniform": _route_reading(par, storage, uniform,
                                  "uniform random tokens")}
    del storage
    ep = experts_padded(cfg, 1)
    C = capacity(cfg, tokens, ep)
    r = state[key]
    share = r["moe_drops"] / (cfg.n_layers * tokens * cfg.n_experts_active)
    active = _moe_expert_flops(cfg, tokens, False)
    executed = _moe_expert_flops(cfg, tokens, True)
    modeled_s = drift.modeled_step_time(
        par.model, par.plan, ShapeConfig("train", TRAIN_T, TRAIN_B, "train"))
    say(f"  {cfg.name} x{cfg.n_layers} layers: {cfg.n_params() / 1e9:.4f}B "
        f"params, capacity {C} slots an expert ({tokens} tokens x top-"
        f"{cfg.n_experts_active} over {ep} experts: "
        f"{tokens * cfg.n_experts_active / ep:.0f} on average)")
    say(f"  drop share (choices over capacity / T*k, last step, all layers) "
        f"{share:.6f} ({r['moe_drops']:.0f} of "
        f"{cfg.n_layers * tokens * cfg.n_experts_active}); aux "
        f"(router_aux_coef x load balance, summed over layers) "
        f"{r['moe_aux']:.6e}")
    say(f"  routed-expert FLOPs a step: active (k a token, counted in MFU) "
        f"{active / 1e12:.3f} TFLOP; executed (every capacity slot) "
        f"{executed / 1e12:.3f} TFLOP ({executed / active:.3f}x)")
    say(f"  modeled peak {par.plan.memory.peak / 2**30:.2f} GiB against "
        f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB "
        f"({par.plan.memory.peak / r['max_memory_allocated']:.3f}); modeled "
        f"step (H100 profile, drift.modeled_step_time) "
        f"{modeled_s * 1e3:.3f} ms against the measured "
        f"{r['step_ms']:.2f} ms")
    r.update(drop_share=share, routing=routing,
             modeled_peak=par.plan.memory.peak,
             modeled_step_ms=modeled_s * 1e3, capacity=C,
             expert_tflop_active=active / 1e12,
             expert_tflop_executed=executed / 1e12)
    c4, uni = routing["SyntheticC4"], routing["uniform"]
    if not (MOE_DROP_BAND[0] <= share <= MOE_DROP_BAND[1]
            and r["moe_aux"] > 0
            and uni["drop_share_by_layer"][0] < MOE_UNIFORM_LAYER0_DROPS
            and c4["common_share_router_input"] > MOE_COMMON_SHARE
            > uni["common_share_router_input"]):
        raise AssertionError(
            f"drop share {share} (band {MOE_DROP_BAND}), aux "
            f"{r['moe_aux']}, uniform tokens' layer-0 drop share "
            f"{uni['drop_share_by_layer'][0]} (under "
            f"{MOE_UNIFORM_LAYER0_DROPS}), layer 0's common share "
            f"{c4['common_share_router_input']} / "
            f"{uni['common_share_router_input']} (either side of "
            f"{MOE_COMMON_SHARE})")


def phase_full_moe_train(state):
    _full_moe_train(state, "qwen3_moe_30b_a3b")


def phase_full_qwen2_moe_train(state):
    _full_moe_train(state, "qwen2_moe_a2_7b")


def phase_full_moe_serve(state):
    """qwen3-moe-30b-a3b served at its published depth: bf16 weights made
    on the card layer by layer, B 4, prompt 2000 padded to T 2064, 64
    generated tokens through `repro_torch.launch.serve`; prefill ms and
    decode ms/token beside the decode step's byte bound (every weight and
    the KV cache read once: the capacity dispatch at T = B runs all 128
    experts) and its device kernel time."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch import serve as launch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        "qwen3_moe_30b_a3b", False, B, PROMPT, GEN, device="cuda",
        dtype="bfloat16")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    say(f"{cfg.name} bf16, {cfg.n_layers} layers: {n / 1e9:.3f}B params, "
        f"{wbytes / 2**30:.2f} GiB, made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN)
    counts = _serve_counts()
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads every weight but the embedding table (B rows of
    # it) and the whole KV cache once
    experts = sum(params["blocks"]["mlp"][k].numel() * 2
                  for k in ("we_g", "we_u", "we_d"))
    step_bytes = wbytes - params["embed"].numel() * 2 + B * cfg.d_model * 2 \
        + 2 * cfg.n_layers * B * T * cfg.gqa_layout(1)["kvp"] \
        * cfg.head_dim * 2
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    say(f"serve B={B} prompt={PROMPT} gen={GEN} T={T}: prefill "
        f"{t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"  decode byte bound {bound:.3f} ms/token ({step_bytes / 1e9:.2f} "
        f"GB a step, of it the routed experts {experts / 1e9:.2f} GB: "
        f"{experts / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    say(f"launches in the serve run: {counts}")
    state["serve_moe_launches"] = counts
    if tokens.shape != (B, GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    if counts["rmsnorm"] <= 0 or counts["flash"] <= 0 or any(
            counts[k] for k in ("flash_f32", "flash_bwd", "flash_bwd_f32")):
        raise AssertionError(f"a kernel of the path never launched, bf16 "
                             f"took flash's fp32 route, or a backward ran: "
                             f"{counts}")
    drops = _spy_drops(model)
    logits, cache = prefill(params, {"tokens": padded})
    by_layer = [d.item() / (B * T * cfg.n_experts_active) for d in drops]
    dropped = sum(d.item() for d in drops)
    del model._dispatch
    choices = cfg.n_layers * B * T * cfg.n_experts_active
    say(f"  prefill drop share {dropped / choices:.6f} ({dropped:.0f} of "
        f"{choices} choices); by layer: first four "
        f"{[round(v, 4) for v in by_layer[:4]]}, least "
        f"{min(by_layer):.4f}, most {max(by_layer):.4f}")
    _profile("prefill", lambda: prefill(params, {"tokens": padded}), 1)
    pos = torch.full((B,), PROMPT, dtype=torch.int64, device=dev)
    busy, dev_s = _profile("decode step", lambda: decode(
        params, cache, logits.argmax(-1), pos), 8, top=12)
    state["serve_moe"] = dict(
        t, max_memory_allocated=peak, decode_bound_ms=bound,
        decode_device_ms=None if dev_s is None else dev_s * 1e3,
        prefill_drop_share=dropped / choices)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    lo, hi = MOE_PREFILL_DROP_BAND
    if not lo <= dropped / choices <= hi:
        raise AssertionError(f"prefill drop share {dropped / choices} "
                             f"outside {MOE_PREFILL_DROP_BAND}")


# ---------------------------------------------------------------------------
# gemma2-27b (the main path of the eleventh slice)
# ---------------------------------------------------------------------------
GEMMA2 = "gemma2_27b"
# full-width gemma2 training keeps every published width and cuts the depth
# (46 layers) to one local/global pair: fp32 storage, grads and AdamW
# moments take 16 bytes a parameter, 37.0 GB for the pair's 2,312,151,552
# (1,179,648,000 of them the tied 256000 x 4608 embedding).  T is above
# the 4096-token window, so the local layer's window masks keys
GEMMA2_TRAIN_LAYERS = 2
GEMMA2_TRAIN_B, GEMMA2_TRAIN_T = 1, 8192
# served at all 46 layers: a prompt above the window, T = 8192
GEMMA2_SERVE_B, GEMMA2_PROMPT, GEMMA2_GEN = 2, 8128, 64
# the fp32 consistency check runs the served weights' first layers widened
# to fp32: 46 layers of fp32 weights (109 GB) do not fit the card
GEMMA2_F32_LAYERS = 12


def _by_kv_heads(fn, q, k, v, *q_like, n=2):
    """fn(q, k, v, *q_like) evaluated n kv heads (and the q heads that read
    them) at a time, joined on the head dim: the plain attention's scores
    for every head at once do not fit the card at T 8192.  fn returns a
    tensor, a tuple of tensors or a dict of them."""
    g = q.shape[2] // k.shape[2]
    parts = [fn(q[:, :, j * g:(j + n) * g], k[:, :, j:j + n],
                v[:, :, j:j + n], *(a[:, :, j * g:(j + n) * g]
                                    for a in q_like))
             for j in range(0, k.shape[2], n)]
    if isinstance(parts[0], dict):
        return {key: torch.cat([p[key] for p in parts], 2)
                for key in parts[0]}
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(ts, 2) for ts in zip(*parts))
    return torch.cat(parts, 2)


def _spy_flash_calls():
    """Records (window, softcap, q_scale) of every flash kernel launch until
    the returned restore() is called."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    seen, launch = set(), flash_ops.flash_attention_cuda

    def spy(q, k, v, causal, window, softcap, q_scale, **kw):
        seen.add((window, softcap, q_scale))
        return launch(q, k, v, causal, window, softcap, q_scale, **kw)

    def restore():
        flash_ops.flash_attention_cuda = launch

    flash_ops.flash_attention_cuda = spy
    return seen, restore


def _check_gemma2_flash_calls(seen, cfg, q_scale, what):
    """gemma2's layers launched flash with the window on the local layer,
    none on the global one, the softcap and query_pre_attn scale on
    both."""
    want = {(cfg.sliding_window, cfg.attn_softcap, q_scale),
            (None, cfg.attn_softcap, q_scale)}
    say(f"  {what}: flash launched with (window, softcap, q_scale) "
        f"{sorted(seen, key=str)}")
    if seen != want:
        raise AssertionError(f"{what}: flash calls {seen}, want {want}")


def _sdpa_fn(q, k, v, window, q_scale, causal=True):
    """SDPA on the same inputs, without the softcap (SDPA takes none):
    causal (or not), and under a window an explicit boolean mask over kv
    heads repeated to the q heads (SDPA's GQA path takes no mask)."""
    import torch.nn.functional as F
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True, scale=q_scale)
    g = q.shape[2] // k.shape[2]
    kt, vt = (a.repeat_interleave(g, dim=1) for a in (kt, vt))
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=q_scale)


def phase_gemma2_kernels(state):
    """The kernels at gemma2-27b's shapes: bf16 flash at the training
    (B1) and prefill (B2) shapes, T 8192, H32 on Kh16, hd 128, local
    (window 4096 + softcap 50) and global (softcap 50), q_scale 1/16, each
    with its two plants, beside SDPA without the softcap; the local
    layer's training gradient (`flash_grad_case`); rmsnorm with unit offset at d
    4608; xent at (8192, 256000) on softcapped logits; AdamW on the tied
    embedding's leaf."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.core.dist import DistConfig
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.adamw import ref as adamw_ref
    from repro_torch.kernels.cross_entropy import ops as xent_ops
    from repro_torch.kernels.cross_entropy import ref as xent_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.models.runtime import model_abstract_storage
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cfg, model = get_arch(GEMMA2)
    h, kh, hd, t = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, GEMMA2_TRAIN_T
    qs, cap = model._q_scale, cfg.attn_softcap
    say("flash kernel vs plain at gemma2-27b's shapes (ms: kernel / plain, "
        "by 2 kv heads / SDPA without the softcap / bound):")
    flash = {}
    for b, path in ((GEMMA2_TRAIN_B, "training"),
                    (GEMMA2_SERVE_B, "prefill")):
        q = randn(b, t, h, hd, dtype=torch.bfloat16)
        k = randn(b, t, kh, hd, dtype=torch.bfloat16)
        v = randn(b, t, kh, hd, dtype=torch.bfloat16)
        for layer, window in (("local", cfg.sliding_window),
                              ("global", None)):
            kw = dict(causal=True, window=window, softcap=cap, q_scale=qs)
            shape = (f"B{b} T{t} H{h} Kh{kh} hd{hd} causal "
                     + (f"window {window} " if window else "")
                     + f"softcap {cap:g} q_scale 1/16 bf16")
            name = f"flash {shape} ({path}, {layer} layer)"
            plain = lambda: _by_kv_heads(
                lambda *a: flash_ref.attention(*a, **kw), q, k, v)
            want = plain()
            n = flash_ops.launches
            got = flash_ops.flash_attention(q, k, v, **kw)
            if flash_ops.launches != n + 1:
                raise AssertionError("the bf16 flash kernel did not launch")
            err = check_rms(name, got, want, FLASH_BF16_RMS_REL)
            del got
            for pname, planted in _by_kv_heads(
                    lambda *a: flash_plants(*a, **kw), q, k, v).items():
                check_plant_rejected(f"{name}, {pname}", planted, want,
                                     FLASH_BF16_RMS_REL)
                del planted
            del want
            torch.cuda.empty_cache()
            # the pairs inside the causal window, 4*hd flops each
            flops = 4.0 * hd * b * h * _attn_pairs(t, window)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            bound, by = _bound(nbytes, flops, torch.bfloat16, products=True)
            fwd = lambda: flash_ops.flash_attention(q, k, v, **kw)
            ms, on_card = time_ms(fwd), device_ms(fwd, bound)
            plain_ms = time_ms(plain)
            sdpa = _sdpa_fn(q, k, v, window, qs)
            lib, lib_dev = time_ms(sdpa), device_ms(sdpa, bound)
            del sdpa
            torch.cuda.empty_cache()
            say(f"    {ms:.4f} / {plain_ms:.4f} / {lib:.4f} / {bound:.4f} "
                f"({by}; {flops / ms / 1e9:.1f} TFLOP/s); device "
                f"{on_card:.4f}, SDPA (no softcap) device {lib_dev:.4f}")
            flash[f"{path}_{layer}"] = dict(
                shape=shape, max_abs_err=err, ms=ms, device_ms=on_card,
                plain_ms=plain_ms, library_ms=lib, library_device_ms=lib_dev,
                library="SDPA, no softcap", bound_ms=bound, bound_by=by)
        del q, k, v
        torch.cuda.empty_cache()
        if path == "training":
            say("flash backward kernels at the local layer's training shape "
                "(the plain versions by 2 kv heads; SDPA without the "
                "softcap):")
            flash_grad_case(
                state, "flash_bwd_gemma2", f"flash B{b} T{t} H{h} Kh{kh} "
                f"hd{hd} local layer bf16", b, t, h, kh, hd,
                dict(causal=True, window=cfg.sliding_window, softcap=cap,
                     q_scale=qs), torch.bfloat16, g, by_heads=True)
    state["gemma2_flash"] = flash

    R, d = GEMMA2_TRAIN_B * GEMMA2_TRAIN_T, cfg.d_model
    say(f"rmsnorm kernel vs plain with unit offset at ({R}, {d}) bf16 (ms: "
        "kernel / plain / F.rms_norm / bound):")
    x = randn(R, d, dtype=torch.bfloat16) * 2
    w = randn(d, dtype=torch.bfloat16) * 0.1      # stores w - 1
    ct = randn(R, d, dtype=torch.bfloat16)
    name = f"rmsnorm ({R}, {d}) bf16 unit_offset"
    n = rms_ops.launches
    got = _grads(lambda a, b_: rms_ops.rmsnorm(a, b_, cfg.norm_eps, True),
                 (x, w), ct)
    if rms_ops.launches != n + 1:
        raise AssertionError("the rmsnorm kernel did not launch")
    want = _grads(lambda a, b_: rms_ref.rmsnorm(a, b_, cfg.norm_eps, True),
                  (x, w), ct)
    err = max(check_close(f"{name} {k_}", a, b_, TOL)
              for k_, a, b_ in zip(("y", "dx", "dw"), got, want))
    check_rejects(f"{name} planted: no unit offset",
                  rms_ref.rmsnorm(x, w, cfg.norm_eps, False), want[0], TOL)
    del got, want
    fwd = lambda: rms_ops.rmsnorm(x, w, cfg.norm_eps, True)
    nbytes = 2 * x.numel() * 2 + d * 2
    bound, by = _bound(nbytes, 4.0 * x.numel())
    ms, on_card = time_ms(fwd), device_ms(fwd, bound)
    plain = time_ms(lambda: rms_ref.rmsnorm(x, w, cfg.norm_eps, True))
    w_lib = (w.float() + 1).to(torch.bfloat16)
    lib = time_ms(lambda: F.rms_norm(x, (d,), w_lib, cfg.norm_eps))
    say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} "
        f"({nbytes / ms / 1e6:.0f} GB/s); device {on_card:.4f}")
    state["gemma2_rmsnorm"] = dict(
        shape=f"({R}, {d}) bf16 unit_offset", max_abs_err=err, ms=ms,
        device_ms=on_card, plain_ms=plain, library_ms=lib, bound_ms=bound,
        bound_by=by)
    del x, w, ct, w_lib

    V = cfg.vocab
    say(f"xent kernels vs plain at ({R}, {V}) fp32, logits softcapped at "
        f"{cfg.final_softcap:g} (ms: kernel / plain / F.cross_entropy / "
        "bound):")
    x = randn(R, V)
    x.mul_(3.0 / cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    tg = torch.randint(0, V, (R,), device=dev, generator=g)
    gr = randn(R) / R
    name = f"xent ({R}, {V}) fp32"
    loss, lse = xent_ops.xent_fwd_cuda(x, tg)
    want_loss, want_lse = xent_ref.xent(x, tg)
    err_f = max(check_close(f"{name} loss", loss, want_loss, TOL32),
                check_close(f"{name} lse", lse, want_lse, TOL32))
    want_dx = per_g(xent_ref.dlogits(x, tg, want_lse, gr), gr)
    del want_loss, want_lse
    nbytes = x.numel() * 4 + 16 * R
    bound_f, by_f = _bound(nbytes, 4.0 * x.numel())
    ms_f = time_ms(lambda: xent_ops.xent_fwd_cuda(x, tg))
    plain_f = time_ms(lambda: xent_ref.xent(x, tg))
    torch.cuda.empty_cache()
    lib_f = time_ms(lambda: F.cross_entropy(x, tg, reduction="none"))
    torch.cuda.empty_cache()
    say(f"    fwd {ms_f:.4f} / {plain_f:.4f} / {lib_f:.4f} / {bound_f:.4f} "
        f"({nbytes / ms_f / 1e6:.0f} GB/s)")
    got_dx = per_g(xent_ops.xent_bwd_cuda(x, tg, lse, gr), gr)
    err_b = check_close(f"{name} dlogits / |g|", got_dx, want_dx, TOL32)
    del got_dx
    onehot_only = torch.zeros_like(x).scatter_(1, tg[:, None],
                                               -gr[:, None])
    check_rejects(f"{name} planted -onehot*g", per_g(onehot_only, gr),
                  want_dx, TOL32)
    del want_dx, onehot_only
    torch.cuda.empty_cache()
    bound_b, by_b = _bound(2 * x.numel() * 4 + 16 * R, 5.0 * x.numel())
    ms_b = time_ms(lambda: xent_ops.xent_bwd_cuda(x, tg, lse, gr))
    plain_b = time_ms(lambda: xent_ref.dlogits(x, tg, lse, gr))
    say(f"    bwd {ms_b:.4f} / {plain_b:.4f} / n/a / {bound_b:.4f} "
        f"({2 * x.numel() * 4 / ms_b / 1e6:.0f} GB/s)")
    state["gemma2_xent_fwd"] = dict(
        shape=f"({R}, {V}) fp32", max_abs_err=err_f, ms=ms_f,
        plain_ms=plain_f, library_ms=lib_f, bound_ms=bound_f, bound_by=by_f)
    state["gemma2_xent_bwd"] = dict(
        shape=f"({R}, {V}) fp32", max_abs_err=err_b, ms=ms_b,
        plain_ms=plain_b, library_ms=None, bound_ms=bound_b, bound_by=by_b)
    del x, tg, gr, loss, lse
    torch.cuda.empty_cache()

    pair = build_model(dataclasses.replace(cfg,
                                           n_layers=GEMMA2_TRAIN_LAYERS))
    n = model_abstract_storage(pair, DistConfig())["embed"].numel()
    say(f"adamw kernel vs plain at the tied embedding's leaf (n={n}; ms: "
        "kernel / plain / bound):")
    p, gd, m = randn(n), randn(n), randn(n) * 0.1
    v = randn(n).abs() * 0.01
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
              lr=torch.tensor(3e-4, device=dev),
              t=torch.tensor(7, dtype=torch.int32, device=dev),
              scale=torch.tensor(0.5, device=dev))
    want = adamw_ref.adamw_update(p, gd, m, v, **kw)
    got = [a.clone() for a in (p, m, v)]
    n_before = adamw_ops.launches
    adamw_ops.adamw_update(got[0], gd, got[1], got[2], **kw)
    if adamw_ops.launches != n_before + 1:
        raise AssertionError("the adamw kernel did not launch")
    err = max(check_close(f"adamw n={n} dp", got[0] - p, want[0] - p,
                          TOL32),
              *(check_close(f"adamw n={n} {k_}", a, b_, TOL32)
                for k_, a, b_ in zip("mv", got[1:], want[1:])))
    del want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: adamw_ops.adamw_update(got[0], gd, got[1], got[2],
                                                **kw))
    plain = time_ms(lambda: adamw_ref.adamw_update(p, gd, m, v, **kw))
    bound, by = _bound(28 * n, 15.0 * n)
    say(f"    {ms:.4f} / {plain:.4f} / {bound:.4f} ({28 * n / ms / 1e6:.0f}"
        " GB/s)")
    state["gemma2_adamw_leaf"] = dict(n=n, max_abs_err=err, ms=ms,
                                      plain_ms=plain, bound_ms=bound,
                                      bound_by=by)


def phase_gemma2_smoke(state):
    """gemma2 SMOKE (one pair, window 8), fp32, card vs CPU: 3 training
    steps through the launcher's trainer at T 32 on the vanilla and the
    prefetch stack from one CPU-made checkpoint (losses, grad norms,
    storage at TOL32; the launch counters); serving with a 12-token prompt,
    prefill and 4 decode steps that cross the window (logits and both
    caches at TOL32); on the card, prefill over p+1 tokens against prefill
    over p + one decode step past the window."""
    import shutil
    import tempfile
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import named_leaves
    from repro_torch.launch import train as launch_train
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    from repro_torch.train.train_step import init_train_state
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gemma2_"))
    need = ("rmsnorm", "flash_f32", "flash_bwd_f32", "xent_fwd", "xent_bwd",
            "adamw")
    try:
        def trainer(dev, sub, reorder):
            return launch_train.build_trainer(launch_train.parse_args([
                "--arch", GEMMA2, "--smoke", "--steps", "3", "--seq", "32",
                "--batch", "4", "--dtype", "float32", "--device", dev,
                "--ckpt-dir", str(root / sub)]
                + ([] if reorder else ["--no-reorder"])))

        cpu = trainer("cpu", "seed", False)
        storage, opt = init_train_state(
            cpu.par, torch.Generator().manual_seed(0))
        cpu.ckpt.save(0, cpu.par.unshard(storage), dict(
            m=cpu.par.unshard(opt["m"]), v=cpu.par.unshard(opt["v"]),
            step=opt["step"]), cpu.model, cpu.dcfg)
        for reorder in (False, True):
            label = f"gemma2 smoke {'prefetch' if reorder else 'vanilla'}"
            runs = {}
            for dev in ("cpu", "cuda"):
                sub = f"{dev}_{reorder}"
                shutil.copytree(root / "seed", root / sub)
                tr = trainer(dev, sub, reorder)
                _reset_counts()
                st, _, hist = tr.run()
                runs[dev] = (st, hist, _train_counts())
            counts = runs["cuda"][2]
            state["gemma2_smoke_launches"] = counts
            say(f"  {label}: launches on the card {counts}")
            if min(counts[k] for k in need) <= 0 \
                    or any(counts[k] for k in NOT_DENSE + NOT_F32):
                raise AssertionError(f"a kernel never launched, or one off "
                                     f"the path did: {counts}")
            _check_bwd_calls(counts, tr.model, 3, "flash_bwd_f32")
            if max(v for k, v in runs["cpu"][2].items()
                   if k not in COLLECTIVES) > 0:
                raise AssertionError("the CPU run launched a kernel")
            for hc, hg in zip(runs["cpu"][1], runs["cuda"][1]):
                for k in ("loss", "grad_norm"):
                    check_close(f"{label} step {hc['step']} {k} cuda vs cpu",
                                torch.tensor(hg[k]), torch.tensor(hc[k]),
                                TOL32)
            errs = [check_close(f"{label} storage {n}", a.cpu(), b_, TOL32)
                    for (n, a), (_, b_) in zip(named_leaves(runs["cuda"][0]),
                                               named_leaves(runs["cpu"][0]))]
            say(f"  {label} storage cuda vs cpu after 3 steps: {len(errs)} "
                f"leaves, max abs err {max(errs):.3e}")

        cfg, model = get_arch(GEMMA2, smoke=True)
        dcfg = single_device_config(param_dtype=torch.float32)
        tree = _numpy_params(model, dcfg, seed=0)
        b, prompt, gen = 2, 12, 4
        t_len = prompt + gen
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(np.pad(
            rng.integers(3, cfg.vocab, (b, prompt)), ((0, 0), (0, gen)),
            constant_values=3))
        runs = {}
        for dev in ("cpu", "cuda"):
            params = SV.serve_params_from_jax(tree, model, dcfg, device=dev)
            pf = SV.make_prefill_step(model, dcfg,
                                      ShapeConfig("p", t_len, b, "prefill"))
            dec = SV.make_decode_step(model, dcfg,
                                      ShapeConfig("d", t_len, b, "decode"))
            logits, cache = pf(params, {"tokens": tokens.to(dev)})
            runs[dev] = dict(params=params, pf=pf, dec=dec, cache=cache,
                             logits=[logits.cpu()])
        check_close("gemma2 smoke prefill logits cuda vs cpu",
                    runs["cuda"]["logits"][0], runs["cpu"]["logits"][0],
                    TOL32)
        for i in range(gen):
            tok = runs["cpu"]["logits"][-1].argmax(-1)
            if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1), tok):
                raise AssertionError(f"gemma2: greedy tokens differ at {i}")
            pos = torch.full((b,), prompt + i, dtype=torch.int64)
            for dev, r in runs.items():
                logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                              tok.to(dev), pos.to(dev))
                r["logits"].append(logits.cpu())
            check_close(f"gemma2 smoke decode {i} (position {prompt + i}, "
                        f"window {cfg.sliding_window}) logits cuda vs cpu",
                        runs["cuda"]["logits"][-1],
                        runs["cpu"]["logits"][-1], TOL32)
        for (layer, got), want in zip(
                (("local", runs["cuda"]["cache"][0]),
                 ("global", runs["cuda"]["cache"][1])),
                runs["cpu"]["cache"]):
            for kv, a, b_ in zip("kv", got, want):
                check_close(f"gemma2 smoke {layer} {kv} cache cuda vs cpu",
                            a.cpu(), b_, TOL32)
        r = runs["cuda"]
        x = torch.from_numpy(rng.integers(3, cfg.vocab, (b, t_len))) \
            .to("cuda")
        want, got, _ = _consistency(r["params"], r["pf"], r["dec"], x,
                                    "gemma2 smoke fp32 on the card")
        check_close("gemma2 smoke on the card: prefill over p+1 vs prefill "
                    "over p + one decode step", got, want, TOL32)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_full_gemma2_train(state):
    """gemma2-27b at every published width, one local/global pair
    (GEMMA2_TRAIN_LAYERS), B 1, T 8192, bf16 compute, fp32 storage, the
    prefetch stack at a bf16 wire, through `_full_train`; the flash
    launches' windows; the modeled peak and step (H100 profile) beside
    the measured."""
    from repro_torch.core.dist import DistConfig
    from repro_torch.core.obs import drift
    from repro_torch.models.common import ShapeConfig
    key = "train_gemma2_27b"
    seen, restore = _spy_flash_calls()
    try:
        par, _, _ = _full_train(state, key, DistConfig(), arch=GEMMA2,
                                layers=GEMMA2_TRAIN_LAYERS,
                                batch=GEMMA2_TRAIN_B, seq=GEMMA2_TRAIN_T)
    finally:
        restore()
    cfg, r = par.model.cfg, state[key]
    _check_gemma2_flash_calls(seen, cfg, par.model._q_scale,
                              "full-width gemma2 training")
    shape = ShapeConfig("train", GEMMA2_TRAIN_T, GEMMA2_TRAIN_B, "train")
    modeled_s = drift.modeled_step_time(par.model, par.plan, shape)
    say(f"  {cfg.name} x{cfg.n_layers} layers: {cfg.n_params() / 1e9:.4f}B "
        f"params; modeled peak {par.plan.memory.peak / 2**30:.2f} GiB "
        f"against max_memory_allocated "
        f"{r['max_memory_allocated'] / 2**30:.2f} GiB "
        f"({par.plan.memory.peak / r['max_memory_allocated']:.3f}); modeled "
        f"step (H100 profile, drift.modeled_step_time) "
        f"{modeled_s * 1e3:.3f} ms against the measured "
        f"{r['step_ms']:.2f} ms")
    r.update(modeled_peak=par.plan.memory.peak,
             modeled_step_ms=modeled_s * 1e3)


def phase_full_gemma2_serve(state):
    """gemma2-27b served at its published depth: bf16 weights made on the
    card layer by layer, B 2, prompt GEMMA2_PROMPT padded to T 8192, 64
    generated tokens through `repro_torch.launch.serve`; prefill ms and
    decode ms/token beside the decode step's byte bound and its device
    kernel time; the flash launches' windows; prefill over p+1 tokens
    against prefill over p + one decode step at p = 8191, past the window,
    in bf16 and, on the first GEMMA2_F32_LAYERS layers widened to fp32,
    at TOL32."""
    import dataclasses
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import tree_map
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build_model
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    b, prompt, gen = GEMMA2_SERVE_B, GEMMA2_PROMPT, GEMMA2_GEN
    t_len = prompt + gen
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        GEMMA2, False, b, prompt, gen, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    say(f"{cfg.name} bf16, {cfg.n_layers} layers: {n / 1e9:.3f}B params, "
        f"{wbytes / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, b, prompt, gen, dev)
    torch.cuda.reset_peak_memory_stats()
    seen, restore = _spy_flash_calls()
    _reset_counts()
    try:
        tokens, t = launch.generate(params, prefill, decode, padded, prompt,
                                    gen)
    finally:
        restore()
    counts = _serve_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_gemma2_flash_calls(seen, cfg, model._q_scale, "46-layer prefill")
    # a decode step reads every weight once (the tied table as the head;
    # the lookup reads B rows of it) and, at the first decode position,
    # the keys and values its attention needs: the window on local
    # layers, every position on global ones
    lay = cfg.gqa_layout(1)
    kv_token = 2 * lay["kvp"] * cfg.head_dim * 2
    kv_read = cfg.n_layers // 2 * b * kv_token * (
        min(prompt + 1, cfg.sliding_window) + prompt + 1)
    step_bytes = wbytes + b * cfg.d_model * 2 + kv_read
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    cache_bytes = cfg.n_layers * b * t_len * kv_token
    say(f"serve B={b} prompt={prompt} gen={gen} T={t_len}: prefill "
        f"{t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB (KV cache "
        f"{cache_bytes / 1e9:.2f} GB)")
    say(f"  decode byte bound {bound:.3f} ms/token ({step_bytes / 1e9:.2f} "
        f"GB a step, of it the keys and values {kv_read / 1e9:.2f} GB)")
    say(f"launches in the serve run: {counts}")
    state["serve_gemma2_launches"] = counts
    if tokens.shape != (b, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    if counts["rmsnorm"] <= 0 or counts["flash"] <= 0 or any(
            counts[k] for k in ("flash_f32", "flash_bwd", "flash_bwd_f32")):
        raise AssertionError(f"a kernel of the path never launched, bf16 "
                             f"took flash's fp32 route, or a backward ran: "
                             f"{counts}")
    logits, cache = prefill(params, {"tokens": padded})
    _profile("prefill", lambda: prefill(params, {"tokens": padded}), 1)
    pos = torch.full((b,), prompt, dtype=torch.int64, device=dev)
    busy, dev_s = _profile("decode step", lambda: decode(
        params, cache, logits.argmax(-1), pos), 8, top=12)
    state["serve_gemma2"] = dict(
        t, max_memory_allocated=peak, decode_bound_ms=bound,
        decode_device_ms=None if dev_s is None else dev_s * 1e3)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    del cache, logits

    # prefill over p+1 tokens against prefill over p + one decode step at
    # p = T - 1, past the window, on two inputs; the same check with the
    # decode step's local layers unwindowed is a planted fault
    xs = {seed: torch.randint(3, cfg.vocab, (b, t_len),
                              generator=torch.Generator().manual_seed(seed))
          .to(dev) for seed in (2, 3)}
    bf16 = {seed: _consistency(params, prefill, decode, x,
                               f"bf16, {cfg.n_layers} layers, input {seed}")
            for seed, x in xs.items()}
    say(f"launches per call: {bf16[2][2]}")
    state["gemma2_per_call"] = bf16[2][2]
    decode_nw = SV.make_decode_step(
        build_model(dataclasses.replace(cfg, sliding_window=None)), dcfg,
        ShapeConfig("d", t_len, b, "decode"))
    _, planted, _ = _consistency(params, prefill, decode_nw, xs[2],
                                 "planted: the decode step's local layers "
                                 "without the window")
    # the first layers, in bf16 and widened to fp32: in fp32 the two paths
    # must agree to fp32 rounding, which separates a fault from bf16 noise
    f32_layers = dataclasses.replace(cfg, n_layers=GEMMA2_F32_LAYERS)
    kept = dict(embed=params["embed"], final_norm=params["final_norm"],
                blocks=tree_map(lambda a: a[:GEMMA2_F32_LAYERS // 2].clone(),
                                params["blocks"]))
    del params
    torch.cuda.empty_cache()
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        d = single_device_config(param_dtype=dt)
        m = build_model(f32_layers)
        runs[dt] = _consistency(
            tree_map(lambda a: a.to(dt), kept),
            SV.make_prefill_step(m, d, ShapeConfig("p", t_len, b, "prefill")),
            SV.make_decode_step(m, d, ShapeConfig("d", t_len, b, "decode")),
            xs[2], f"{str(dt)[6:]}, the first {GEMMA2_F32_LAYERS} layers")
    del kept
    want32, got32, _ = runs[torch.float32]
    say(f"  bf16 prefill vs fp32 prefill, the first {GEMMA2_F32_LAYERS} "
        f"layers, same weights: max_abs_err "
        f"{max_err(runs[torch.bfloat16][0], want32):.4e} (for scale; not a "
        "limit)")
    check_close(f"fp32 ({GEMMA2_F32_LAYERS} layers): prefill vs prefill + "
                "decode", got32, want32, TOL32)
    if not torch.equal(got32.argmax(-1), want32.argmax(-1)):
        raise AssertionError("fp32: argmax differs")
    for seed, (want, got, _) in bf16.items():
        what = f"bf16 ({cfg.n_layers} layers, input {seed})"
        err = check_close(f"{what}: prefill vs prefill + decode", got, want,
                          TOL_GEMMA2_BF16_CONSISTENCY)
        # the argmax must agree where the top-2 gap is above twice the error
        top2 = want.float().topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        same = got.argmax(-1) == want.argmax(-1)
        say(f"  {what}: argmax equal {same.tolist()}, top-2 gap above "
            f"2 x {err:.3e} {clear.tolist()}")
        if not bool(same[clear].all()):
            raise AssertionError(f"{what}: argmax differs where the gap is "
                                 "clear")
    check_rejects("planted: the decode step's local layers without the "
                  "window", planted, bf16[2][0], TOL_GEMMA2_BF16_CONSISTENCY)


# ---------------------------------------------------------------------------
# Paged serving (the main path of the twelfth slice)
# ---------------------------------------------------------------------------
PAGED_SMOKE = (("qwen3_1_7b", None), ("qwen3_1_7b", "int8"),
               ("qwen3_1_7b", "fp8"), ("gemma2_27b", None),
               ("qwen2_moe_a2_7b", None))
# full-width paged serving: llama3-8b at the phase-7 shape, 16 decode
# steps a cache; the dense cache's T = PAGED_MAX_PAGES * PAGED_PAGE = 2064
# so both reads have one shape and one stride (paged == dense bit for bit)
PAGED_PAGE, PAGED_STEPS = 16, 16
PAGED_MAX_PAGES = T // PAGED_PAGE
PAGED_CODECS = (None, "int8", "fp8")
# the batcher run: plan_serve under the H100 profile; 1 GiB at 131,072
# bytes a token is 512 pages, fewer than 8 slots of up to 2064-token
# requests need, so the trace preempts
BATCH_ARENA_BYTES = 1 << 30
# each KV codec's largest logit difference from the bf16 cache over the
# paged steps of llama3-8b (B 4, T 2064, seeded weights): a sound build read
# 7.02e-2 (int8) and 1.93e-1 (fp8) (NVIDIA H100 80GB HBM3, 700 W); each
# limit keeps TOL_BF16_CONSISTENCY's room (1.5 times the reading), and
# the cache with its scales zeroed, a planted codec fault, must fail it
PAGED_CODEC_DIFF = {"int8": 1.1e-1, "fp8": 3e-1}
BATCH_MAX_BATCH, BATCH_MAX_SEQ = 8, 2304
BATCH_TRACE = dict(n=16, seed=0, prompt_lens=(256, 1024, 2000),
                   gen_lens=(16, 32, 64))
# 4 requests of request 0's first 1024 tokens + 256 of their own
BATCH_SHARED, BATCH_SHARED_PREFIX, BATCH_SHARED_SUFFIX = 4, 1024, 256
BATCH_SHARED_GEN = 16


def _kv_clone(tree):
    from repro_torch.core.serving import pages as PG
    return PG.kv_map(lambda a: a.clone(), tree)


def _repage(cache, lengths, page, n_pages_local, max_pages):
    """dense_to_pages + the pages each row needs up to max_pages (the
    decode steps' positions), as the reference's parity test does."""
    from repro_torch.core.serving import dense_to_pages
    arena, table, pools = dense_to_pages(cache, lengths, page,
                                         n_pages_local, max_pages)
    tbl = table.cpu().clone()
    for b, n in enumerate(lengths):
        filled = -(-int(n) // page)
        ids = pools[0].alloc(max_pages - filled)
        tbl[b, filled:filled + len(ids)] = torch.tensor(ids)
    return arena, tbl.to(table.device)


def _zero_counts():
    return {k: 0 for k in _train_counts()}


def _counted(into, fn):
    """fn() in a launch-count window of its own: every count is set to 0
    just before the call and read just after it, and added into `into`."""
    _reset_counts()
    out = fn()
    for k, v in _train_counts().items():
        into[k] += v
    return out


# kernels no serving step launches: the steps' attention is the reference's
# einsum, and nothing trains
NOT_IN_STEPS = ("flash", "flash_f32", "flash_bwd", "flash_bwd_f32",
                "xent_fwd", "xent_bwd", "adamw", "ssd",
                "ssd_f32", "ssd_bwd")


def _check_step_counts(paged, dense, codec, steps, layers, what, norms=None):
    """The launch-count windows of `steps` paged steps and of as many dense
    decode steps over one cache: the same kernels the same number of times;
    under a codec one quant_fwd and one dequant_fwd launch for the K and
    the V leaf of each layer a step (the new token's encode, the read's
    decode), none without; `norms` rmsnorm launches a step where given,
    some in any case; none of NOT_IN_STEPS."""
    for name, counts in (("paged", paged), ("dense", dense)):
        want = 2 * layers * steps if codec else 0
        if (counts["quant_fwd"], counts["dequant_fwd"]) != (want, want):
            raise AssertionError(
                f"{what}, {name} steps: {counts['quant_fwd']} quant and "
                f"{counts['dequant_fwd']} dequant launches, {want} each "
                f"expected ({codec or 'no codec'}): {counts}")
        if counts["rmsnorm"] <= 0 or (norms is not None
                                      and counts["rmsnorm"] != norms * steps):
            raise AssertionError(f"{what}, {name} steps: rmsnorm launched "
                                 f"{counts['rmsnorm']} times in {steps} "
                                 f"steps ({norms} a step expected)")
        if any(counts[k] for k in NOT_IN_STEPS):
            raise AssertionError(f"{what}, {name} steps launched a kernel "
                                 f"the steps do not run: {counts}")
    if paged != dense:
        raise AssertionError(f"{what}: paged steps launched {paged}, dense "
                             f"decode steps {dense}")


def phase_paged_smoke(state):
    """Paged serving, card vs CPU, fp32 SMOKE configs: qwen3 with no codec,
    int8 and fp8, gemma2 (window 8, page 4: decode crosses pages and the
    window) and qwen2-moe.  Prefill of a 12-token prompt, `dense_to_pages`,
    4 paged decode steps fed the CPU's greedy tokens: the card's logits
    held to the CPU's at TOL32, and on the card paged equal to dense bit
    for bit at each step; the paged and the dense steps each in
    launch-count windows of their own (`_check_step_counts`).  Then on the card, qwen3 at B 2: a ragged-position
    step and chunked prefill (chunk 4, and 3 + 4 + 1) against a full
    prefill and dense decode at the reference test's 2e-5."""
    from repro_torch.core.dist import single_device_config
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    b, prompt, gen, page = 4, 12, 4, 4
    t_len = prompt + gen
    max_pages = t_len // page
    n_local = b * max_pages + 2
    counts_by_case = {}
    for arch, codec in PAGED_SMOKE:
        what = f"{arch}/{codec or 'no codec'}"
        cfg, model = get_arch(arch, smoke=True)
        if arch == GEMMA2 and cfg.sliding_window != 8:
            raise AssertionError(f"gemma2 SMOKE window {cfg.sliding_window}")
        dcfg = single_device_config(param_dtype=torch.float32,
                                    kv_cache_codec=codec)
        tree = _numpy_params(model, dcfg, seed=0)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(np.pad(
            rng.integers(3, cfg.vocab, (b, prompt)), ((0, 0), (0, gen)),
            constant_values=3))
        runs = {}
        for dev in ("cpu", "cuda"):
            params = SV.serve_params_from_jax(tree, model, dcfg, device=dev)
            pf = SV.make_prefill_step(model, dcfg,
                                      ShapeConfig("p", t_len, b, "prefill"))
            dec = SV.make_decode_step(model, dcfg,
                                      ShapeConfig("d", t_len, b, "decode"))
            pstep = SV.make_paged_step(
                model, dcfg, ShapeConfig("d", t_len, b, "decode"),
                page=page, n_pages_local=n_local, max_pages=max_pages)
            logits, cache = pf(params, {"tokens": tokens.to(dev)})
            arena, table = _repage(cache, [prompt] * b, page, n_local,
                                   max_pages)
            runs[dev] = dict(params=params, dec=dec, pstep=pstep,
                             cache=cache, arena=arena, table=table,
                             logits=logits.cpu())
        check_close(f"{what} smoke prefill logits cuda vs cpu",
                    runs["cuda"]["logits"], runs["cpu"]["logits"], TOL32)
        tok = runs["cpu"]["logits"].argmax(-1)
        # a launch-count window around each step: the paged steps' and the
        # dense steps' counts apart, the CPU's (plain versions, no launch)
        # apart from the card's
        paged_n = {dev: _zero_counts() for dev in runs}
        dense_n = {dev: _zero_counts() for dev in runs}
        for i in range(gen):
            pos = torch.full((b,), prompt + i, dtype=torch.int64)
            out = {}
            for dev, r in runs.items():
                ld, r["cache"] = _counted(dense_n[dev], lambda: r["dec"](
                    r["params"], r["cache"], tok.to(dev), pos.to(dev)))
                lp, r["arena"] = _counted(paged_n[dev], lambda: r["pstep"](
                    r["params"], r["arena"], r["table"],
                    tok.to(dev)[:, None], pos.to(dev)[:, None]))
                if dev == "cuda" and not torch.equal(ld, lp):
                    raise AssertionError(
                        f"{what}: paged != dense on the card at step {i} "
                        f"(max abs diff {max_err(lp, ld):.3e})")
                out[dev] = lp.cpu()
            check_close(f"{what} paged decode {i} cuda vs cpu", out["cuda"],
                        out["cpu"], TOL32)
            tok = out["cpu"].argmax(-1)
        if any(paged_n["cpu"].values()) or any(dense_n["cpu"].values()):
            raise AssertionError(f"{what}: a CPU step counted a launch: "
                                 f"{paged_n['cpu']}, {dense_n['cpu']}")
        counts = paged_n["cuda"]
        _check_step_counts(counts, dense_n["cuda"], codec, gen, cfg.n_layers,
                           what)
        counts_by_case[what] = counts
        say(f"  {what}: paged == dense bit for bit at {gen} steps on the "
            f"card; launches in the {gen} paged steps (as many in the "
            f"dense ones): rmsnorm {counts['rmsnorm']}, quant "
            f"{counts['quant_fwd']}, dequant {counts['dequant_fwd']}")
    state["serve_paged_smoke_launches"] = {
        k: sum(c[k] for c in counts_by_case.values())
        for k in _train_counts()}
    _paged_ragged_and_chunked()


def _paged_ragged_and_chunked():
    """qwen3 SMOKE on the card at the reference tests' ragged and chunked
    shapes (B 2, prompt 8, gen 8, page 4)."""
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    b, prompt, gen, page = 2, 8, 8, 4
    t_len = prompt + gen
    max_pages = t_len // page
    n_local = b * max_pages + 2
    cfg, model = get_arch("qwen3_1_7b", smoke=True)
    dcfg = single_device_config(param_dtype=torch.float32)
    params = SV.serve_params_from_jax(_numpy_params(model, dcfg, seed=0),
                                      model, dcfg, device=dev)
    pf = SV.make_prefill_step(model, dcfg,
                              ShapeConfig("p", t_len, b, "prefill"))
    dec = SV.make_decode_step(model, dcfg,
                              ShapeConfig("d", t_len, b, "decode"))
    pstep = SV.make_paged_step(model, dcfg,
                               ShapeConfig("d", t_len, b, "decode"),
                               page=page, n_pages_local=n_local,
                               max_pages=max_pages, chunk=4)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(3, cfg.vocab, (b, prompt), generator=g).to(dev)
    logits, cache = pf(params, {"tokens": torch.nn.functional.pad(
        toks, (0, gen), value=3)})
    tol = dict(rtol=2e-5, atol=2e-5)
    # ragged: row 0 two greedy steps ahead of row 1
    cache_d = _kv_clone(cache)
    tok = logits.argmax(-1)
    by_step = [tok]
    for i in range(2):
        lg, cache_d = dec(params, cache_d, tok, torch.full(
            (b,), prompt + i, dtype=torch.int64, device=dev))
        tok = lg.argmax(-1)
        by_step.append(tok)
    lengths = [prompt + 2, prompt]
    ragged = PG.kv_map(lambda adv, base: torch.cat([adv[:, :1], base[:, 1:]],
                                                   1), cache_d, cache)
    arena, table = _repage(ragged, lengths, page, n_local, max_pages)
    rtok = torch.stack([by_step[2][0], by_step[0][1]])
    rpos = torch.tensor(lengths, device=dev)
    lp, _ = pstep(params, arena, table, rtok[:, None], rpos[:, None])
    l0, _ = dec(params, _kv_clone(cache_d), by_step[2], torch.full(
        (b,), prompt + 2, dtype=torch.int64, device=dev))
    l1, _ = dec(params, _kv_clone(cache), by_step[0], torch.full(
        (b,), prompt, dtype=torch.int64, device=dev))
    check_close("ragged paged step, row 0 (pos p+2) vs dense", lp[0].cpu(),
                l0[0].cpu(), tol)
    check_close("ragged paged step, row 1 (pos p) vs dense", lp[1].cpu(),
                l1[1].cpu(), tol)
    # chunked prefill into an empty arena against a prompt-length prefill
    pf2 = SV.make_prefill_step(model, dcfg,
                               ShapeConfig("p2", prompt, b, "prefill"))
    want, _ = pf2(params, {"tokens": toks})
    for chunks in ((4, 4), (3, 4, 1)):
        arena, table = _repage(PG.kv_map(torch.zeros_like, cache), [0] * b,
                               page, n_local, max_pages)
        s0 = 0
        for n in chunks:
            qpos = torch.arange(s0, s0 + n, device=dev)[None].repeat(b, 1)
            lp, arena = pstep(params, arena, table, toks[:, s0:s0 + n], qpos)
            s0 += n
        check_close(f"chunked prefill {chunks} vs full prefill", lp.cpu(),
                    want.cpu(), tol)
        tok = want.argmax(-1)
        pos = torch.full((b,), prompt, dtype=torch.int64, device=dev)
        ld, _ = dec(params, _kv_clone(cache), tok, pos)
        lp2, _ = pstep(params, arena, table, tok[:, None], pos[:, None])
        check_close(f"chunked prefill {chunks}, next decode vs dense",
                    lp2.cpu(), ld.cpu(), tol)


def _zero_scales(tree):
    """A copy of a codec cache or arena with every scale zeroed."""
    if isinstance(tree, dict):
        return {k: torch.zeros_like(v) if k in ("ks", "vs")
                else _zero_scales(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zero_scales(t) for t in tree)
    return tree.clone()


def _timed_steps(step, n):
    """Runs step(i) for i < n; returns (outputs, ms a step over steps
    1..n-1: the first call is left out as the warm-up)."""
    outs = [step(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n):
        outs.append(step(i))
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) / (n - 1) * 1e3


def phase_full_paged_serve(state):
    """llama3-8b bf16 at every published width, 32 layers, weights made on
    the card: B 4, prompt 2000 padded to T 2064 = 129 pages of 16.
    For the bf16, int8 and fp8 caches: prefill, repage, then 16 decode
    steps of the paged arena and 16 of the dense cache fed the same
    tokens (the bf16 paged run's greedy ones), paged equal to dense bit for
    bit at each step, each run in a launch-count window of its own;
    decode ms/token of each, each codec's logits held to PAGED_CODEC_DIFF
    of the bf16 cache's and its zeroed-scales plant rejected; the device
    time of one paged decode step.  Then the batcher: `_serve_batcher`."""
    from repro_torch.core.serving import pages as PG
    from repro_torch.launch import serve as launch
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, _, _ = launch.setup(
        "llama3_8b", False, B, PROMPT, GEN, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    say(f"llama3-8b bf16 made on the card in {time.perf_counter() - t0:.1f}s")
    if PAGED_MAX_PAGES * PAGED_PAGE != T:
        raise AssertionError("the dense T must equal max_pages * page")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    n_local = B * PAGED_MAX_PAGES + 2
    norms = 2 * cfg.n_layers + 1        # llama3: ln1, ln2 a layer, final
    ref_logits, toks, readings = None, None, {}
    counts_all = {k: 0 for k in _train_counts()}
    for codec in PAGED_CODECS:
        name = codec or "bf16"
        d = dcfg.with_(kv_cache_codec=codec)
        pf = SV.make_prefill_step(model, d, ShapeConfig("p", T, B,
                                                        "prefill"))
        dec = SV.make_decode_step(model, d, ShapeConfig("d", T, B, "decode"))
        pstep = SV.make_paged_step(model, d, ShapeConfig("d", T, B, "decode"),
                                   page=PAGED_PAGE, n_pages_local=n_local,
                                   max_pages=PAGED_MAX_PAGES)
        pre_n = _zero_counts()
        logits, cache = _counted(pre_n, lambda: pf(params,
                                                   {"tokens": padded}))
        if (pre_n["rmsnorm"], pre_n["quant_fwd"], pre_n["dequant_fwd"]) != (
                norms, 2 * cfg.n_layers if codec else 0, 0):
            raise AssertionError(f"{name} cache: the prefill launched "
                                 f"{pre_n}")
        arena, table = _repage(cache, [PROMPT] * B, PAGED_PAGE, n_local,
                               PAGED_MAX_PAGES)
        pos = [torch.full((B,), PROMPT + i, dtype=torch.int64, device=dev)
               for i in range(PAGED_STEPS)]
        if toks is None:
            # the bf16 paged run's greedy tokens feed every run
            toks = [logits.argmax(-1)]

        def paged_step(i):
            lp = pstep(params, arena, table, toks[i][:, None],
                       pos[i][:, None])[0]
            if len(toks) == i + 1 < PAGED_STEPS:
                toks.append(lp.argmax(-1))
            return lp

        # the paged steps and the dense steps each in a launch-count window
        counts, dense_n = _zero_counts(), _zero_counts()
        paged, paged_ms = _counted(
            counts, lambda: _timed_steps(paged_step, PAGED_STEPS))
        dense, dense_ms = _counted(dense_n, lambda: _timed_steps(
            lambda i: dec(params, cache, toks[i], pos[i])[0], PAGED_STEPS))
        _check_step_counts(counts, dense_n, codec, PAGED_STEPS, cfg.n_layers,
                           f"llama3-8b {name} cache", norms=norms)
        for k in counts_all:
            counts_all[k] += counts[k]
        for i, (ld, lp) in enumerate(zip(dense, paged)):
            if not torch.equal(ld, lp):
                raise AssertionError(
                    f"{name}: paged != dense at step {i} (max abs diff "
                    f"{max_err(lp, ld):.3e})")
            if not torch.isfinite(lp).all():
                raise AssertionError(f"{name}: non-finite logits at {i}")
        diff = None
        if ref_logits is None:
            ref_logits = [lp.float() for lp in paged]
        else:
            diff = max(max_err(lp, r) for lp, r in zip(paged, ref_logits))
        leaf_bytes = sum(a.numel() * a.element_size()
                         for a in PG.kv_leaves(arena))
        readings[name] = dict(dense_ms=dense_ms, paged_ms=paged_ms,
                              max_diff_vs_bf16=diff, arena_bytes=leaf_bytes,
                              launches=counts)
        say(f"  {name} cache: paged == dense bit for bit at {PAGED_STEPS} "
            f"steps; decode {paged_ms:.3f} ms/token paged, {dense_ms:.3f} "
            f"dense (B {B}, T {T}); arena {leaf_bytes / 1e9:.3f} GB"
            + ("" if diff is None else f"; largest logit difference from "
               f"the bf16 cache {diff:.4e}")
            + f"; launches in the {PAGED_STEPS} paged steps (as many in the "
            f"dense ones) {dict((k, v) for k, v in counts.items() if v)}, "
            f"in the prefill {dict((k, v) for k, v in pre_n.items() if v)}")
        if codec is None:
            _profile("paged decode step (bf16 cache)", lambda: pstep(
                params, arena, table, toks[-1][:, None],
                pos[-1][:, None]), 4)
            _profile("dense decode step (bf16 cache)", lambda: dec(
                params, cache, toks[-1], pos[-1]), 4)
        else:
            # the codec against the bf16 cache, and a planted codec fault
            # (every page's scales zeroed) that the limit must reject
            tol = dict(rtol=0.0, atol=PAGED_CODEC_DIFF[codec])
            check_close(f"{name} cache: the {PAGED_STEPS} steps' logits vs "
                        "the bf16 cache's", torch.stack(paged),
                        torch.stack(ref_logits), tol)
            planted = pstep(params, _zero_scales(arena), table,
                            toks[-1][:, None], pos[-1][:, None])[0]
            check_rejects(f"planted: the {name} cache with its scales "
                          "zeroed", planted, ref_logits[-1], tol)
        del dense, paged, cache, arena
        torch.cuda.empty_cache()
    state["serve_paged"] = readings
    state["serve_paged_launches"] = counts_all
    _serve_batcher(state, cfg, model, dcfg, params)


def _serve_batcher(state, cfg, model, dcfg, params):
    """A server answering requests: `plan_serve` (H100 profile) with a
    BATCH_ARENA_BYTES arena, the synthetic trace plus BATCH_SHARED requests
    that share request 0's first BATCH_SHARED_PREFIX tokens, a prefix
    cache, and the scheduler's documented contract: each `next_action()`
    is one paged-step call over the rows it names (a prefill chunk: its
    sequence's row at the chunk's true length; a decode step: the live
    rows), then `on_prefill` / `on_decode` with the measured wall time.
    The run's launch counts are read right after the loop; then the device
    time of one decode step and `_check_batcher_prefills`."""
    import random
    from repro_torch.core import hw
    from repro_torch.core.serving import (ContinuousBatcher, PrefixCache,
                                          Request, plan_serve,
                                          synthetic_trace)
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    if hw.active() is not hw.H100:
        raise AssertionError(f"active profile {hw.active().name}")
    plan = plan_serve(model, dcfg, arena_bytes=BATCH_ARENA_BYTES,
                      max_batch=BATCH_MAX_BATCH, max_seq=BATCH_MAX_SEQ,
                      page=PAGED_PAGE)
    say(f"  plan: {plan}")
    reqs = synthetic_trace(mean_interarrival_s=plan.decode_step_s,
                           vocab=cfg.vocab, **BATCH_TRACE)
    r0 = reqs[0].prompt
    if len(r0) < BATCH_SHARED_PREFIX:
        raise AssertionError(f"request 0's prompt is {len(r0)} tokens")
    rng = random.Random(1)
    last = reqs[-1].arrival
    for j in range(BATCH_SHARED):
        suffix = tuple(rng.randrange(3, cfg.vocab)
                       for _ in range(BATCH_SHARED_SUFFIX))
        reqs.append(Request(rid=len(reqs),
                            prompt=r0[:BATCH_SHARED_PREFIX] + suffix,
                            max_new=BATCH_SHARED_GEN,
                            arrival=last + 1e-3 * (j + 1)))
    prompts = {r.rid: r.prompt for r in reqs}
    prefix = PrefixCache()
    batcher = ContinuousBatcher(plan, prefix_cache=prefix)
    for r in reqs:
        batcher.submit(r)
    max_pages = plan.max_pages_per_seq
    arena = SV.alloc_arena(model, dcfg, page=plan.page,
                           n_pages_local=plan.n_pages, device=dev)
    arena_bytes = sum(a.numel() * a.element_size()
                      for a in PG.kv_leaves(arena))
    pstep = SV.make_paged_step(
        model, dcfg, ShapeConfig("d", max_pages * plan.page, plan.max_batch,
                                 "decode"),
        page=plan.page, n_pages_local=plan.n_pages, max_pages=max_pages,
        chunk=plan.prefill_chunk)

    def table(seqs):
        t = torch.full((len(seqs), max_pages), -1, dtype=torch.int32)
        for i, sq in enumerate(seqs):
            t[i, :len(sq.table)] = torch.tensor(sq.table, dtype=torch.int32)
        return t.to(dev)

    page = plan.page
    # each prefill attempt (a preempted request starts a new one, its prompt
    # extended by the tokens it had generated), keyed by its sequence: its
    # index among the request's attempts, the chunks it ran, the attempt
    # that wrote each prefix page it shares, and its last chunk's logits;
    # `writer` maps a page to the attempt whose prefill last wrote it
    attempts, writer, first, nxt = {}, {}, {}, {}
    batch_sizes, n_calls, prof_args = [], 0, None
    _reset_counts()
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    idle = 0
    while not batcher.finished():
        act = batcher.next_action()
        if act is None:
            idle += 1
            if idle > 100_000:
                raise AssertionError("scheduler stalled")
            continue
        idle = 0
        n_calls += 1
        t0 = time.perf_counter()
        if act[0] == "prefill":
            _, seq, start, toks = act
            n, rid = len(toks), seq.req.rid
            if seq not in attempts:
                attempts[seq] = dict(
                    rid=rid, prompt=seq.req.prompt, shared=seq.pos,
                    srcs=[writer[p] for p in seq.table[:seq.shared]],
                    chunks=[], logits=None,
                    n=sum(r["rid"] == rid for r in attempts.values()))
            rec = attempts[seq]
            rec["chunks"].append((start, n))
            for j in range(start // page, (start + n - 1) // page + 1):
                writer[seq.table[j]] = rec
            logits, arena = pstep(
                params, arena, table([seq]), torch.tensor([toks], device=dev),
                torch.arange(start, start + n, device=dev)[None])
            if start + n == seq.prompt_len:
                rec["logits"] = logits[0].float().cpu()
                nxt[rid] = int(rec["logits"].argmax())
                first.setdefault(rid, rec)
            else:
                torch.cuda.synchronize()
            batcher.on_prefill(seq, n, wall_s=time.perf_counter() - t0)
        else:
            _, seqs = act
            toks = [nxt[sq.req.rid] for sq in seqs]
            args = (table(seqs), torch.tensor(toks, device=dev)[:, None],
                    torch.tensor([sq.pos for sq in seqs],
                                 device=dev)[:, None])
            logits, arena = pstep(params, arena, *args)
            for i, sq in enumerate(logits.argmax(-1).tolist()):
                nxt[seqs[i].req.rid] = sq
            wall = time.perf_counter() - t0
            batch_sizes.append(len(seqs))
            if prof_args is None and len(seqs) >= plan.max_batch // 2:
                prof_args = args
            batcher.on_decode(seqs, toks, wall_s=wall)
        batcher.pool.check()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    counts = _train_counts()
    m = batcher.metrics()
    say(f"  {m['requests']} requests, {m['gen_tokens']} tokens in "
        f"{m['virtual_s']:.3f} s on the batcher's clock (measured walls; "
        f"the loop {loop_s:.3f} s): {m['tok_s']:.2f} tokens/s; latency p50 "
        f"{m['p50_s']:.3f} s, p99 {m['p99_s']:.3f} s; time to first token "
        f"p50 {m['p50_first_s']:.3f} s, p99 {m['p99_first_s']:.3f} s")
    say(f"  decode steps {m['decode_steps']} (mean batch "
        f"{sum(batch_sizes) / max(1, len(batch_sizes)):.2f}), prefill "
        f"chunks {m['prefill_chunks']}, preemptions {m['preemptions']}, "
        f"prefix hit tokens {m['prefix_hit_tokens']} (rate "
        f"{m['prefix_hit_rate']:.4f}), arena use {m['arena_util']:.4f} of "
        f"{plan.n_pages} pages ({arena_bytes / 2**30:.3f} GiB), decode "
        f"EWMA {batcher.decode_ewma * 1e3:.3f} ms against the plan's "
        f"{plan.decode_step_s * 1e3:.3f} ms (ratio "
        f"{batcher.decode_ratio:.2f})")
    say(f"  launches in the batcher run ({n_calls} paged steps): "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    if m["requests"] != len(reqs):
        raise AssertionError(f"{m['requests']} of {len(reqs)} finished")
    if m["preemptions"] < 1:
        raise AssertionError("the trace did not preempt: lower "
                             "BATCH_ARENA_BYTES")
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError("no prefix-cache hit")
    if batcher.pool.used != len(prefix):
        raise AssertionError(f"{batcher.pool.used} pages held, the prefix "
                             f"cache holds {len(prefix)}")
    # llama3: ln1 and ln2 a layer and the final norm, every paged step
    norms = 2 * cfg.n_layers + 1
    if counts["rmsnorm"] != norms * n_calls or any(
            counts[k] for k in NOT_IN_STEPS + QUANT):
        raise AssertionError(f"{n_calls} paged steps launched {counts} "
                             f"({norms} rmsnorm a step and nothing else "
                             "expected)")
    # the device time of one decode step of at least half the slots, after
    # the loop and outside its count window (the step rewrites its slots)
    profiled, profiled_rows = (None, None), None
    if prof_args is not None:
        profiled_rows = prof_args[0].shape[0]
        profiled = _profile(f"batcher decode step x{profiled_rows}",
                            lambda: pstep(params, arena, *prof_args), 4)
    del arena
    torch.cuda.empty_cache()
    _check_batcher_prefills(model, dcfg, params, plan, attempts,
                            [first[sq.req.rid] for sq in batcher.done[:4]])
    state["serve_batcher"] = dict(
        m, loop_s=loop_s, arena_bytes=arena_bytes, plan=str(plan),
        n_calls=n_calls, decode_device_ms=None if profiled[1] is None
        else profiled[1] * 1e3, decode_device_rows=profiled_rows)
    state["serve_batcher_launches"] = counts


def _prefill_chunk(rec, step, weights, arena, start, n, table):
    """One paged step over rec's prompt[start:start + n] on `table` (1,
    max_pages); the logits (V,) of its last position."""
    dev = table.device
    return step(weights, arena, table, torch.tensor(
        [rec["prompt"][start:start + n]], device=dev),
        torch.arange(start, start + n, device=dev)[None])[0][0]


def _replay_prefill(rec, step, weights, arena, upto, free, page, max_pages):
    """Runs the chunks of the prefill attempt `rec` that start below
    position `upto` on pages drawn from the iterator `free`; each page it
    shares is the page that a replay of the attempt that wrote it (on
    pages of its own, the same way) wrote.  Returns (rec's table, on the
    arena's device, and the last chunk's logits)."""
    from repro_torch.core.serving import pages as PG
    dev = PG.kv_leaves(arena)[0].device
    t = torch.full((1, max_pages), -1, dtype=torch.int32)
    shared = min(len(rec["srcs"]), -(-upto // page))
    for src in {id(w): w for w in rec["srcs"][:shared]}.values():
        js = [j for j in range(shared) if rec["srcs"][j] is src]
        ts, _ = _replay_prefill(src, step, weights, arena,
                                (js[-1] + 1) * page, free, page, max_pages)
        t[0, js] = ts[0, js].cpu()
    runs = [(s, n) for s, n in rec["chunks"] if s < upto]
    for j in range(shared, -(-max([s + n for s, n in runs], default=0)
                             // page)):
        t[0, j] = next(free)
    t, lp = t.to(dev), None
    for start, n in runs:
        lp = _prefill_chunk(rec, step, weights, arena, start, n, t)
    return t, lp


def _check_batcher_prefills(model, dcfg, params, plan, attempts, firsts):
    """The batcher run's prefill logits against standalone runs.

    1. Every attempt that finished its prefill, prefix hits and recomputes
       after a preemption included, against a standalone paged prefill of
       its prompt on a fresh arena with the same chunk boundaries, its
       shared pages written there by standalone runs of the attempts that
       wrote them: the same arithmetic on the same shapes, so bit for bit.
       A table that reads prefix page 0 from page 1, a planted fault, must
       fail it.
    2. The prefills `firsts` (those that gave the first finished requests
       their first token), one with a prefix hit and one recomputed after a
       preemption: the last chunk's logits against a dense (flash) prefill
       of the attempt's prompt alone at TOL_BF16_CONSISTENCY, the
       argmax equal where the top-2 gap is above twice the error; and, on
       the same weights widened to fp32, the paged replay against the fp32
       dense prefill at TOL32 with an equal argmax: in fp32 the two paths
       must agree, which separates a fault from bf16 rounding in a near
       tie."""
    from repro_torch.core.meta import tree_map
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    page, max_pages = plan.page, plan.max_pages_per_seq
    # a replay's pages: its own and its prefix sources', each run apart
    n_fresh = 4 * max_pages

    def fresh(d):
        arena = SV.alloc_arena(model, d, page=page, n_pages_local=n_fresh,
                               device=dev)
        step = SV.make_paged_step(
            model, d, ShapeConfig("d", max_pages * page, plan.max_batch,
                                  "decode"),
            page=page, n_pages_local=n_fresh, max_pages=max_pages,
            chunk=plan.prefill_chunk)

        def run(rec, weights):
            for a in PG.kv_leaves(arena):
                a.zero_()
            return _replay_prefill(rec, step, weights, arena,
                                   len(rec["prompt"]), iter(range(n_fresh)),
                                   page, max_pages)
        return arena, step, run

    done = [r for r in attempts.values() if r["logits"] is not None]
    for rec in done:
        ends = [rec["shared"]] + [s + n for s, n in rec["chunks"]]
        if [s for s, _ in rec["chunks"]] != ends[:-1] or ends[-1] != len(
                rec["prompt"]):
            raise AssertionError(f"request {rec['rid']}: chunks "
                                 f"{rec['chunks']} from {rec['shared']}")
    hits = [r for r in done if r["shared"]]
    recomputed = [r for r in done if r["n"]]
    if not hits or not recomputed:
        raise AssertionError(f"{len(hits)} prefix hits and {len(recomputed)}"
                             " recomputes among the finished prefills")
    arena, step, run = fresh(dcfg)
    worst = 0.0
    for rec in done:
        got = run(rec, params)[1].float().cpu()
        worst = max(worst, max_err(got, rec["logits"]))
        if not torch.equal(got, rec["logits"]):
            raise AssertionError(
                f"request {rec['rid']} (attempt {rec['n']}, {rec['shared']} "
                f"shared tokens): the batcher's prefill logits differ from a "
                f"standalone paged prefill (max abs err "
                f"{max_err(got, rec['logits']):.3e})")
    mixed = sum(len({id(w) for w in r["srcs"]}) > 1 for r in hits)
    say(f"  {len(done)} finished prefills ({len(hits)} with a prefix hit, "
        f"{mixed} of them on pages of more than one writer; {len(recomputed)}"
        f" recomputed after a preemption) equal bit for bit to standalone "
        f"paged prefills on a fresh arena (max abs err {worst:.1e})")
    rec = hits[0]
    tbl, good = run(rec, params)
    # (a table with two pages swapped would not do: attention sums over
    # its keys in any order, and the keys carry their rotary positions)
    bad = tbl.clone()
    bad[0, 0] = tbl[0, 1]
    start, n = rec["chunks"][-1]
    check_rejects_exact(f"planted: request {rec['rid']}'s last chunk with "
                        "prefix page 0 read from page 1", _prefill_chunk(
                            rec, step, params, arena, start, n, bad), good)
    del arena, run
    torch.cuda.empty_cache()

    compared = firsts + [r for r in (hits[0], recomputed[0])
                         if all(r is not f for f in firsts)]
    dense = []
    for rec in compared:
        rid, prompt = rec["rid"], rec["prompt"]
        pf = SV.make_prefill_step(model, dcfg, ShapeConfig(
            "p", len(prompt), 1, "prefill"))
        want, _ = pf(params, {"tokens": torch.tensor([prompt], device=dev)})
        want, got = want.float().cpu(), rec["logits"][None]
        what = (f"request {rid} ({len(prompt)} tokens, attempt {rec['n']}, "
                f"{rec['shared']} shared): next token logits")
        err = check_close(f"{what}, paged chunked prefill vs dense prefill",
                          got, want, TOL_BF16_CONSISTENCY)
        top2 = want.topk(2, dim=-1).values[0]
        gap = (top2[0] - top2[1]).item()
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        say(f"  {what}: argmax equal {same}, top-2 gap {gap:.4e} "
            f"(clear above 2 x {err:.3e}: {gap > 2 * err})")
        if gap > 2 * err and not same:
            raise AssertionError(f"{what}: argmax differs where the gap is "
                                 "clear")
        dense.append(want)
    d32 = dcfg.with_(param_dtype=torch.float32)
    params32 = tree_map(lambda a: a.float(), params)
    arena, _, run = fresh(d32)
    for rec, want in zip(compared, dense):
        got32 = run(rec, params32)[1]
        pf = SV.make_prefill_step(model, d32, ShapeConfig(
            "p", len(rec["prompt"]), 1, "prefill"))
        want32 = pf(params32, {"tokens": torch.tensor(
            [rec["prompt"]], device=dev)})[0][0]
        what = (f"request {rec['rid']} (attempt {rec['n']}), the same weights "
                "widened to fp32")
        check_close(f"{what}: paged chunked prefill vs dense prefill",
                    got32, want32, TOL32)
        if not torch.equal(got32.argmax(-1), want32.argmax(-1)):
            raise AssertionError(f"{what}: argmax differs")
        say(f"  {what}: argmax equal; bf16 dense prefill vs fp32 "
            f"{max_err(want[0], want32.cpu()):.4e} (for scale; not a limit)")
    del params32, arena, run
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# zamba2 serving (the main path of the fourteenth slice)
# ---------------------------------------------------------------------------
ZAMBA2 = "zamba2_1_2b"
ZAMBA2_STATE = ("S", "conv_x", "conv_bc")
# the p+1 checks' p at SMOKE: two whole chunks of 16, so token p opens the
# third
ZAMBA2_SMOKE_P = 32


def _zamba_state_close(what, got, want, tol, upto=None):
    """Every leaf of a zamba2 serving state on two devices; the shared
    block's keys and values over their first `upto` positions."""
    errs = [check_close(f"{what} {k}", got[k].cpu(), want[k].cpu(), tol)
            for k in ZAMBA2_STATE]
    for i, (g, w) in enumerate(zip(got["sh_kv"], want["sh_kv"])):
        for name, a, b in zip("kv", g, w):
            errs.append(check_close(f"{what} sh_kv[{i}] {name}",
                                    a[:, :upto].cpu(), b[:, :upto].cpu(),
                                    tol))
    return max(errs)


def _zamba_p1(model, dcfg, params, x, label, plant=False):
    """Prefill over x (B, p + 1) against prefill over x[:, :p] into a cache
    of capacity p + 1 and one decode step of x[:, p] at position p.
    Returns (want logits, got logits, launch counts of the long prefill and
    of the decode step, the long prefill's cache, the decoded cache, and
    with `plant` the logits of the same decode from a cache whose conv
    states were zeroed)."""
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    b, t = x.shape
    shape = ShapeConfig("p", t, b, "prefill")
    pos = torch.full((b,), t - 1, dtype=torch.int64, device=x.device)
    with torch.inference_mode():
        _reset_counts()
        want, full = model.prefill_local(
            params, {"tokens": x}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        counts = dict(prefill=_train_counts())
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :-1]}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        planted = None
        if plant:
            dropped = PG.kv_map(torch.clone, cache)
            dropped["conv_x"].zero_()
            dropped["conv_bc"].zero_()
            planted, _ = model.decode_local(params, dropped, x[:, -1], pos,
                                            dcfg)
            del dropped
        _reset_counts()
        got, cache = model.decode_local(params, cache, x[:, -1], pos, dcfg)
        counts["decode"] = _train_counts()
    top2 = want.float().topk(2, dim=-1).values
    say(f"  {label}: max|logit| {want.abs().max().item():.4f}, max abs err "
        f"{max_err(got, want):.4e}, top-2 gaps "
        f"{[round(v, 5) for v in (top2[:, 0] - top2[:, 1]).tolist()]}, "
        f"argmax {want.argmax(-1).tolist()} vs {got.argmax(-1).tolist()}")
    return want, got, counts, full, cache, planted


def _check_zamba_counts(counts, model, what, prefills=1):
    """`prefills` bf16 prefills: one SSD forward a Mamba layer and one flash
    forward a shared-block invocation; no backward and no fp32 route."""
    want = dict(ssd=prefills * model.cfg.n_layers,
                flash=prefills * model.n_super)
    off = [k for k in ("ssd_f32", "flash_f32", "ssd_bwd", "ssd_bwd_f32",
                       "flash_bwd", "flash_bwd_f32") if counts[k]]
    if any(counts[k] != v for k, v in want.items()) or off \
            or (prefills and counts["rmsnorm"] <= 0):
        raise AssertionError(f"{what}: launches {counts}, want {want} and "
                             "no backward or fp32-route launch")


def phase_zamba_serve_smoke(state):
    """zamba2 SMOKE served in fp32 with the same numpy-seeded weights on
    the card and on the CPU: prefill of a padded 40-token batch (a ragged
    SSD chunk) and 4 decode steps, logits and every state leaf at TOL32;
    then on the card prefill over p + 1 tokens against prefill over p into
    a cache of capacity p + 1 and one decode step at position p."""
    from repro_torch.core.dist import single_device_config
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    b, prompt, gen = 2, 36, 4
    t_len = prompt + gen
    cfg, model = get_arch(ZAMBA2, smoke=True)
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
        _reset_counts()
        logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)
                                    .to(dev)})
        runs[dev] = dict(params=params, dec=dec, cache=cache,
                         logits=[logits.cpu()], prefill=_train_counts())
    counts = runs["cuda"]["prefill"]
    say(f"  launches in the card's prefill: {counts}")
    if counts["ssd"] != cfg.n_layers or counts["ssd_f32"] != cfg.n_layers \
            or counts["flash_f32"] != model.n_super or counts["rmsnorm"] <= 0:
        raise AssertionError(f"the fp32 prefill on the card: {counts}")
    if any(runs["cpu"]["prefill"][k] for k in counts if k not in COLLECTIVES):
        raise AssertionError("the CPU prefill launched a kernel")
    check_close("zamba2 smoke prefill logits cuda vs cpu",
                runs["cuda"]["logits"][0], runs["cpu"]["logits"][0], TOL32)
    _zamba_state_close("zamba2 smoke prefill cuda vs cpu",
                       runs["cuda"]["cache"], runs["cpu"]["cache"], TOL32)
    _reset_counts()
    for i in range(gen):
        tok = runs["cpu"]["logits"][-1].argmax(-1)
        if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1), tok):
            raise AssertionError(f"zamba2: greedy tokens differ at {i}")
        pos = torch.full((b,), prompt + i, dtype=torch.int64)
        for dev, r in runs.items():
            logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                          tok.to(dev), pos.to(dev))
            r["logits"].append(logits.cpu())
        check_close(f"zamba2 smoke decode {i} logits cuda vs cpu",
                    runs["cuda"]["logits"][-1], runs["cpu"]["logits"][-1],
                    TOL32)
    decode_counts = _train_counts()
    if any(decode_counts[k] for k in ("ssd", "flash", "flash_f32")):
        raise AssertionError(f"a decode step launched an SSD or flash "
                             f"kernel: {decode_counts}")
    _zamba_state_close(f"zamba2 smoke after {gen} decode steps cuda vs cpu",
                       runs["cuda"]["cache"], runs["cpu"]["cache"], TOL32)
    state["zamba_serve_smoke_launches"] = counts
    # prefill over p + 1 tokens against prefill over p + one decode step
    p = ZAMBA2_SMOKE_P
    x = torch.from_numpy(rng.integers(3, cfg.vocab, (b, p + 1))).cuda()
    want, got, _, full, cache, _ = _zamba_p1(
        model, dcfg, runs["cuda"]["params"], x, f"smoke p {p}: prefill "
        f"{p + 1} vs prefill {p} + decode")
    check_close(f"zamba2 smoke p {p}: prefill vs prefill + decode logits",
                got, want, TOL32)
    _zamba_state_close(f"zamba2 smoke p {p}: prefill vs prefill + decode",
                       cache, full, TOL32)


def phase_full_zamba_serve(state):
    """zamba2-1.2b served at its published depth: bf16 weights made on the
    card layer by layer, B 4, prompt 2000 padded to T 2064, 64 generated
    tokens through `repro_torch.launch.serve`; prefill ms and decode
    ms/token beside the decode step's byte bound and its device kernel
    time, peak memory, the launch counts; then prefill over p + 1 tokens
    against prefill over p into a cache of capacity p + 1 and one decode
    step at p = T - 1, in bf16 (with a planted fault, the conv states
    dropped) and on the weights widened to fp32 at TOL32."""
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import tree_map
    from repro_torch.launch import serve as launch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        ZAMBA2, False, B, PROMPT, GEN, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    say(f"{cfg.name} bf16, {cfg.n_layers} layers ({model.n_super} shared-"
        f"block invocations): {n / 1e9:.3f}B params, {wbytes / 1e9:.2f} GB, "
        f"made on the card in {time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN)
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads every weight but the embedding table (B rows of
    # it), reads and writes the 38 layers' SSD and conv states (fp32), and
    # reads the shared block's keys and values at the first decode
    # position (PROMPT + 1 of them, 6 invocations), writing one of each
    L, K = cfg.n_layers, cfg.ssm_conv
    states = 4 * L * B * (model.nh * model.hd * model.ds
                          + (K - 1) * (model.nh * model.hd + 2 * model.ds))
    kv_token = 2 * cfg.gqa_layout(1)["kvp"] * cfg.head_dim * 2
    kv = model.n_super * B * (PROMPT + 2) * kv_token
    step_bytes = wbytes - params["embed"].numel() * 2 \
        + B * cfg.d_model * 2 + 2 * states + kv
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    say(f"serve B={B} prompt={PROMPT} gen={GEN} T={T}: prefill "
        f"{t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"  decode byte bound {bound:.3f} ms/token ({step_bytes / 1e9:.3f} "
        f"GB a step: the SSD and conv states {2 * states / 1e9:.3f} GB read "
        f"and written, the shared block's keys and values {kv / 1e9:.3f} "
        "GB)")
    say(f"launches in the serve run (2 prefills, {GEN - 1} decode steps): "
        f"{counts}")
    state["serve_zamba2_launches"] = counts
    if tokens.shape != (B, GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    _check_zamba_counts(counts, model, "the serve run", prefills=2)
    logits, cache = prefill(params, {"tokens": padded})
    _profile("prefill", lambda: prefill(params, {"tokens": padded}), 1)
    pos = torch.full((B,), PROMPT, dtype=torch.int64, device=dev)
    busy, dev_s = _profile("decode step", lambda: decode(
        params, cache, logits.argmax(-1), pos), 8, top=12)
    state["serve_zamba2"] = dict(
        t, max_memory_allocated=peak, decode_bound_ms=bound,
        decode_device_ms=None if dev_s is None else dev_s * 1e3,
        decode_busy=busy)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    del cache, logits

    # prefill over p + 1 tokens against prefill over p + one decode step,
    # p = T - 1; the decode from a cache with its conv states zeroed is a
    # planted fault
    x = torch.randint(3, cfg.vocab, (B, T),
                      generator=torch.Generator().manual_seed(2)).to(dev)
    want, got, per_call, _, _, planted = _zamba_p1(
        model, dcfg, params, x, f"bf16, {L} layers, p {T - 1}", plant=True)
    say(f"launches per call: {per_call}")
    state["zamba2_per_call"] = per_call
    _check_zamba_counts(per_call["prefill"], model, "one prefill")
    _check_zamba_counts(per_call["decode"], model, "one decode step",
                        prefills=0)
    # the weights widened to fp32: there the two paths must agree to fp32
    # rounding, which separates a fault from bf16 noise
    dcfg32 = single_device_config(param_dtype=torch.float32)
    params32 = tree_map(lambda a: a.float(), params)
    del params
    torch.cuda.empty_cache()
    want32, got32, per32, *_ = _zamba_p1(
        model, dcfg32, params32, x,
        f"fp32 (the same weights widened, all {L} layers)")
    if per32["prefill"]["ssd_f32"] != L or per32["decode"]["ssd"]:
        raise AssertionError(f"the fp32 prefill's routes: {per32}")
    del params32
    say(f"  bf16 prefill vs fp32 prefill, same weights: max_abs_err "
        f"{max_err(want, want32):.4e} (for scale; not a limit)")
    check_close("fp32: prefill vs prefill + decode", got32, want32, TOL32)
    if not torch.equal(got32.argmax(-1), want32.argmax(-1)):
        raise AssertionError("fp32: argmax differs")
    err = check_close("bf16: prefill vs prefill + decode", got, want,
                      TOL_BF16_CONSISTENCY)
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    say(f"  bf16: argmax equal {same.tolist()}, top-2 gap above 2 x "
        f"{err:.3e} {clear.tolist()}")
    if not bool(same[clear].all()):
        raise AssertionError("bf16: argmax differs where the gap is clear")
    check_rejects("planted: the decode step with the conv states dropped",
                  planted, want, TOL_BF16_CONSISTENCY)
    state["zamba2_consistency"] = dict(bf16=err, fp32=max_err(got32, want32))


XLSTM = "xlstm_1_3b"
XLSTM_MLSTM = ("C", "n", "m", "conv")
XLSTM_SLSTM = ("h", "c", "n", "m")
# full-width xlstm-1.3b training: every sLSTM time step is a round of small
# ops issued by the host (slstm_seq's loop), so a step takes some 42 s,
# not milliseconds; 2 timed steps (the second profiled) after the warm-up
# step: the phase read 196.9 s of the script's 1200 s limit (NVIDIA H100
# 80GB HBM3, 700.00 W)
XLSTM_TRAIN_STEPS = 2
# the p+1 check of the full-width bf16 serve: max |prefill(p+1) -
# prefill(p)+decode| over the logits' RMS, on the weights of each of
# XLSTM_SEEDS.  The two paths differ in the order of their bf16 roundings
# (the chunkwise form against the one-token recurrence in 42 mLSTM
# blocks), and at these random weights each mLSTM block carries a
# difference on at 1.3-2x its size (`_xlstm_drift`'s control), so 48
# layers make much of a rounding.  Seeds 0, 1 and 2 read 2.48e-1, 3.08e-1
# and 3.65e-1; a decode with the conv states dropped, a planted fault,
# 6.15 to 6.51 (NVIDIA H100 80GB HBM3, 700.00 W).  The limit lies 2.7x
# above the largest reading and 6.2x under the smallest plant's
XLSTM_BF16_CONSISTENCY_REL = 1.0
XLSTM_SEEDS = (0, 1, 2)
# bf16 against fp32 one sub-block deep (`_xlstm_drift`): the RMS of the
# difference of the sub-block's outputs over the fp32 one's.  Every
# projection's bf16 rounding enters it: the first superblock's sub-blocks
# read 2.39e-3 (the sLSTM) to 1.228e-2 (the first mLSTM), and with the
# cells' exp, einsum, baddbmm, cumsum, tanh and sigmoid rounded to bf16
# (XLSTM_PLANT) at most 1.516e-2, a fault within bf16's own noise here;
# `_xlstm_cells_widen` catches it (NVIDIA H100 80GB HBM3, 700.00 W)
XLSTM_BLOCK_BF16_REL = 3e-2
# the planted fault of the bf16 checks: the cells' torch calls named
# rounded to bf16 (`_CellOpsInBf16`), as if they ran in the compute dtype
XLSTM_PLANT = ("exp", "einsum", "baddbmm", "cumsum", "tanh", "sigmoid")


def _xlstm_flops(cfg, model, batch, seq):
    """FLOPs of one xlstm training step (forward and backward, 3 x the
    forward; remat's recomputes not counted): 6 x the matrix-product
    parameters applied per token x tokens (every block's projections and
    the head; R is counted with the recurrence), plus the products the
    chunkwise mLSTM computes a chunk and (b, h) (q k^T, (S o W) v and W k
    over the whole Lc x Lc square, 2 Lc^2 (2 dk + dv); q C and the state
    update k^T v, 4 Lc dk dv) and the sLSTM's recurrent products (h R over
    the four gates, 8 hd^2 a token and head)."""
    d, di, H, dk = cfg.d_model, model.d_inner, model.n_heads, model.dk
    hd, per = d // H, model.per
    mlstm = 2 * d * di + 3 * di * di + di * 2 * H + di * d
    slstm = d * 4 * d + d * d
    mm = model.n_steps * ((per - 1) * mlstm + slstm) + d * cfg.vocab
    lc = min(cfg.ssm_chunk, seq)
    chunks = -(-seq // lc)
    chunk = 2 * lc * lc * (2 * dk + dk) + 4 * lc * dk * dk
    cells = model.n_steps * (per - 1) * chunks * batch * H * chunk \
        + model.n_steps * seq * batch * H * 8 * hd * hd
    return 6.0 * mm * batch * seq + 3.0 * cells


def phase_xlstm_kernels(state):
    """The kernels xlstm-1.3b's path runs, at its shapes: rmsnorm at (8192,
    2048) bf16 (the training rows) and (8256, 2048) bf16 (the serve
    prefill's rows, B4 T2064); xent forward and backward at (8192, 50304)
    fp32; AdamW at the path's largest flat leaf (`_path_kernels`)."""
    _path_kernels(state, "xlstm", XLSTM, ((TRAIN_B * TRAIN_T, "training"),
                                          (B * T, "prefill")),
                  TRAIN_B * TRAIN_T)


# H100 SXM's L2 holds 50 MB: `_cold` cycles a call's input and output
# through this many bytes of copies, so that each call reads and writes
# HBM as the byte bound assumes (at d 1024 rmsnorm's whole traffic fits in
# L2, and a warm call read 0.0092 ms against a 0.0101 ms bound)
COLD_BYTES = 256 * 2**20


def _cold(fn, x):
    """A call of fn on the next of a ring of copies of x, which keeps the
    ring's outputs alive: inputs and outputs together span COLD_BYTES."""
    import collections
    import itertools
    n = max(1, -(-COLD_BYTES // (2 * x.numel() * x.element_size())))
    ring = itertools.cycle([x] + [x.clone() for _ in range(n - 1)])
    kept = collections.deque(maxlen=n)
    return lambda: kept.append(fn(next(ring)))


def _path_kernels(state, prefix, arch, rms_rows, xent_rows, xent_valid=None,
                  adamw_n=None):
    """rmsnorm at each (rows, path) of `rms_rows` bf16 at `arch`'s width,
    xent forward and backward at (xent_rows, vocab) fp32 and AdamW at the
    arch's largest flat storage leaf (or at `adamw_n` elements), each
    against its plain version, with the kernel's wall and device ms, the
    plain version's, a PyTorch call's and the bound; the readings go to
    state[prefix + "_rmsnorm" | "_xent_fwd" | "_xent_bwd" | "_adamw_leaf"].
    `xent_valid` (xent_rows,) masks rows as a loss's `valid` does: their
    cotangent is 0, so their dlogits must be exactly 0 and the masked mean
    of the losses equal the plain version's."""
    import torch.nn.functional as F
    from repro_torch.core.dist import DistConfig
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.adamw import ref as adamw_ref
    from repro_torch.kernels.cross_entropy import ops as xent_ops
    from repro_torch.kernels.cross_entropy import ref as xent_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.models.registry import get_arch
    from repro_torch.models.runtime import model_abstract_storage
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cfg, model = get_arch(arch)
    d, V = cfg.d_model, cfg.vocab
    say(f"rmsnorm kernel vs plain at {cfg.name}'s shapes (ms: kernel / "
        "plain / F.rms_norm / bound):")
    rms = {}
    for rows, path in rms_rows:
        x = randn(rows, d, dtype=torch.bfloat16) * 2
        w = randn(d, dtype=torch.bfloat16)
        name = f"rmsnorm ({rows}, {d}) bf16 ({path})"
        n = rms_ops.launches
        got = rms_ops.rmsnorm(x, w, cfg.norm_eps)
        if rms_ops.launches != n + 1:
            raise AssertionError("the rmsnorm kernel did not launch")
        err = check_close(name, got, rms_ref.rmsnorm(x, w, cfg.norm_eps), TOL)
        fwd = _cold(lambda a: rms_ops.rmsnorm(a, w, cfg.norm_eps), x)
        nbytes = 2 * x.numel() * 2 + d * 2
        bound, by = _bound(nbytes, 4.0 * x.numel())
        ms, on_card = time_ms(fwd), device_ms(fwd, bound)
        plain = time_ms(_cold(lambda a: rms_ref.rmsnorm(a, w, cfg.norm_eps),
                              x))
        lib = time_ms(_cold(lambda a: F.rms_norm(a, (d,), w, cfg.norm_eps),
                            x))
        say(f"    {path}: {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} "
            f"({nbytes / ms / 1e6:.0f} GB/s); device {on_card:.4f} (inputs "
            "and outputs cycled past the L2, `_cold`)")
        rms[path] = dict(shape=f"({rows}, {d}) bf16", max_abs_err=err, ms=ms,
                         device_ms=on_card, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by)
        del x, w, got
    state[f"{prefix}_rmsnorm"] = rms

    R = xent_rows
    say(f"xent kernels vs plain at ({R}, {V}) fp32 (ms: kernel / plain / "
        "F.cross_entropy / bound):")
    x = randn(R, V) * 3
    tg = torch.randint(0, V, (R,), device=dev, generator=g)
    gr = randn(R) / R
    live = slice(None)
    if xent_valid is not None:
        gr = gr * xent_valid
        live = xent_valid > 0
    name = f"xent ({R}, {V}) fp32"
    n = xent_ops.fwd_launches, xent_ops.bwd_launches
    loss, lse = xent_ops.xent_fwd_cuda(x, tg)
    want_loss, want_lse = xent_ref.xent(x, tg)
    err_f = max(check_close(f"{name} loss", loss, want_loss, TOL32),
                check_close(f"{name} lse", lse, want_lse, TOL32))
    want_dx = xent_ref.dlogits(x, tg, want_lse, gr)
    got_dx = xent_ops.xent_bwd_cuda(x, tg, lse, gr)
    if (xent_ops.fwd_launches, xent_ops.bwd_launches) != (n[0] + 1,
                                                           n[1] + 1):
        raise AssertionError("the xent kernels did not launch")
    if xent_valid is not None:
        dead = ~live
        nz = int(got_dx[dead].count_nonzero())
        mean = lambda a: (a * xent_valid).sum() / xent_valid.sum()
        say(f"  {name}: {int(dead.sum())} of {R} rows masked: non-zero "
            f"dlogits in them {nz}; masked mean loss "
            f"{mean(loss).item():.6f} against the plain "
            f"{mean(want_loss).item():.6f}")
        if nz or int(want_dx[dead].count_nonzero()):
            raise AssertionError(f"{name}: masked rows have dlogits")
        check_close(f"{name} masked mean loss", mean(loss), mean(want_loss),
                    TOL32)
    err_b = check_close(f"{name} dlogits / |g|", per_g(got_dx[live],
                                                       gr[live]),
                        per_g(want_dx[live], gr[live]), TOL32)
    onehot_only = torch.zeros_like(x).scatter_(1, tg[:, None], -gr[:, None])
    check_rejects(f"{name} planted -onehot*g", per_g(onehot_only[live],
                                                     gr[live]),
                  per_g(want_dx[live], gr[live]), TOL32)
    del got_dx, want_dx, onehot_only, want_loss, want_lse
    torch.cuda.empty_cache()
    # forward: read the logits and targets, write loss and lse, ~4
    # operations an element; backward: read the logits, write dlogits, ~5
    bound_f, by_f = _bound(x.numel() * 4 + 16 * R, 4.0 * x.numel())
    bound_b, by_b = _bound(2 * x.numel() * 4 + 16 * R, 5.0 * x.numel())
    fwd = lambda: xent_ops.xent_fwd_cuda(x, tg)
    bwd = lambda: xent_ops.xent_bwd_cuda(x, tg, lse, gr)
    ms_f, dev_f = time_ms(fwd), device_ms(fwd, bound_f, n=10)
    plain_f = time_ms(lambda: xent_ref.xent(x, tg))
    torch.cuda.empty_cache()
    lib_f = time_ms(lambda: F.cross_entropy(x, tg, reduction="none"))
    torch.cuda.empty_cache()
    ms_b, dev_b = time_ms(bwd), device_ms(bwd, bound_b, n=10)
    torch.cuda.empty_cache()
    plain_b = time_ms(lambda: xent_ref.dlogits(x, tg, lse, gr))
    torch.cuda.empty_cache()
    # the library's backward: autograd of F.cross_entropy (forward too)
    xr = x.detach().requires_grad_()

    def lib_bwd():
        torch.autograd.grad(F.cross_entropy(xr, tg, reduction="none"), xr,
                            gr)
    lib_fb = time_ms(lib_bwd)
    torch.cuda.empty_cache()
    say(f"    fwd {ms_f:.4f} / {plain_f:.4f} / {lib_f:.4f} / {bound_f:.4f} "
        f"({x.numel() * 4 / ms_f / 1e6:.0f} GB/s); device {dev_f:.4f}")
    say(f"    bwd {ms_b:.4f} / {plain_b:.4f} / n/a / {bound_b:.4f} "
        f"({2 * x.numel() * 4 / ms_b / 1e6:.0f} GB/s); device {dev_b:.4f}; "
        f"F.cross_entropy forward + autograd backward {lib_fb:.4f} (no "
        "backward-alone library call)")
    state[f"{prefix}_xent_fwd"] = dict(
        shape=f"({R}, {V}) fp32", max_abs_err=err_f, ms=ms_f, device_ms=dev_f,
        plain_ms=plain_f, library_ms=lib_f, bound_ms=bound_f, bound_by=by_f)
    state[f"{prefix}_xent_bwd"] = dict(
        shape=f"({R}, {V}) fp32", max_abs_err=err_b, ms=ms_b, device_ms=dev_b,
        plain_ms=plain_b, library_ms=None, library_fwd_bwd_ms=lib_fb,
        bound_ms=bound_b, bound_by=by_b)
    del x, xr, tg, gr, loss, lse
    torch.cuda.empty_cache()

    n = adamw_n or max(a.numel() for a in _leaves(model_abstract_storage(
        model, DistConfig())))
    say(f"adamw kernel vs plain at {cfg.name}'s "
        f"{'leaf' if adamw_n else 'largest flat leaf'} (n={n}; "
        "ms: kernel / plain / AdamW(fused=True) / bound):")
    p, gd, m = randn(n), randn(n), randn(n) * 0.1
    v = randn(n).abs() * 0.01
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
              lr=torch.tensor(3e-4, device=dev),
              t=torch.tensor(7, dtype=torch.int32, device=dev),
              scale=torch.tensor(0.5, device=dev))
    want = adamw_ref.adamw_update(p, gd, m, v, **kw)
    got = [a.clone() for a in (p, m, v)]
    n_before = adamw_ops.launches
    adamw_ops.adamw_update(got[0], gd, got[1], got[2], **kw)
    if adamw_ops.launches != n_before + 1:
        raise AssertionError("the adamw kernel did not launch")
    err = max(check_close(f"adamw n={n} dp", got[0] - p, want[0] - p, TOL32),
              *(check_close(f"adamw n={n} {k_}", a, b_, TOL32)
                for k_, a, b_ in zip("mv", got[1:], want[1:])))
    del want
    torch.cuda.empty_cache()
    upd = lambda: adamw_ops.adamw_update(got[0], gd, got[1], got[2], **kw)
    bound, by = _bound(28 * n, 15.0 * n)
    ms, on_card = time_ms(upd), device_ms(upd, bound, n=10)
    plain = time_ms(lambda: adamw_ref.adamw_update(p, gd, m, v, **kw))
    torch.cuda.empty_cache()
    q = p.clone().requires_grad_()
    q.grad = gd
    opt = torch.optim.AdamW([q], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=True)
    lib = time_ms(opt.step)
    say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} "
        f"({28 * n / ms / 1e6:.0f} GB/s); device {on_card:.4f}")
    state[f"{prefix}_adamw_leaf"] = dict(
        n=n, max_abs_err=err, ms=ms, device_ms=on_card, plain_ms=plain,
        library_ms=lib, bound_ms=bound, bound_by=by)
    del p, gd, m, v, got, q, opt
    torch.cuda.empty_cache()


def _storage_from_full(model, dcfg, tree, dev):
    """The port's storage from reference-layout full params (numpy)."""
    from repro_torch.core.api import shard_params
    from repro_torch.core.meta import tree_map
    metas = model.metas(dcfg)
    return {k: tree_map(lambda a: a.to(dev), shard_params(
        tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                 tree[k]), metas[k], dcfg)) for k in metas}


def _xlstm_state_close(what, got, want, tol):
    """Every leaf of an xlstm serving state, on two devices."""
    errs = []
    for sub in sorted(want):
        for k in XLSTM_SLSTM if sub == "s" else XLSTM_MLSTM:
            errs.append(check_close(f"{what} {sub}.{k}", got[sub][k].cpu(),
                                    want[sub][k].cpu(), tol))
    return max(errs)


def phase_xlstm_smoke(state):
    """xlstm SMOKE in fp32 with the same numpy-seeded weights on the card
    and on the CPU: the loss and every gradient of one loss step at T 40 (a
    ragged mLSTM chunk) on the vanilla and the prefetch stack; prefill of a
    padded 40-token batch and 3 decode steps, logits and every state leaf;
    all at TOL32.  No flash or SSD launch, on any of them."""
    from repro_torch.core.api import parallelize
    from repro_torch.core.dist import DistConfig, single_device_config
    from repro_torch.core.meta import named_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    cfg, model = get_arch(XLSTM, smoke=True)
    tree = _numpy_params(model, single_device_config(
        param_dtype=torch.float32), seed=0)
    b, t = 4, 40
    batch = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=t,
                                   global_batch=b, seed=0)).batch(0)
    off = ("flash", "flash_f32", "flash_bwd", "flash_bwd_f32", "ssd",
           "ssd_f32", "ssd_bwd", "ssd_bwd_f32")
    for reorder in (False, True):
        label = "prefetch" if reorder else "vanilla"
        dcfg = DistConfig(param_dtype=torch.float32, reorder=reorder)
        runs = {}
        for dev in ("cpu", "cuda"):
            par = parallelize(model, dcfg, ShapeConfig("t", t, b, "train"),
                              device=dev)
            storage = _storage_from_full(model, dcfg, tree, dev)
            _reset_counts()
            loss, grads = par.loss_step()(storage, batch)
            runs[dev] = (loss, grads, _train_counts())
        counts = runs["cuda"][2]
        say(f"  xlstm smoke {label} loss step: launches on the card {counts}")
        if min(counts[k] for k in ("rmsnorm", "xent_fwd", "xent_bwd")) <= 0 \
                or any(counts[k] for k in off):
            raise AssertionError(f"xlstm smoke {label}: launches {counts}")
        if max(v for k, v in runs["cpu"][2].items()
               if k not in COLLECTIVES) > 0:
            raise AssertionError("the CPU loss step launched a kernel")
        check_close(f"xlstm smoke {label} loss cuda vs cpu",
                    runs["cuda"][0].cpu(), runs["cpu"][0], TOL32)
        errs = [check_close(f"xlstm smoke {label} grad {n}", a.cpu(), b_,
                            TOL32)
                for (n, a), (_, b_) in zip(named_leaves(runs["cuda"][1]),
                                           named_leaves(runs["cpu"][1]))]
        say(f"  xlstm smoke {label}: loss {float(runs['cuda'][0]):.6f}, "
            f"{len(errs)} gradient leaves, max abs err {max(errs):.3e}")

    prompt, gen = 36, 4
    t_len = prompt + gen
    dcfg = single_device_config(param_dtype=torch.float32)
    rng = np.random.default_rng(1)
    tokens = np.pad(rng.integers(3, cfg.vocab, (2, prompt)),
                    ((0, 0), (0, gen)), constant_values=3)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = SV.serve_params_from_jax(tree, model, dcfg, device=dev)
        pf = SV.make_prefill_step(model, dcfg,
                                  ShapeConfig("p", t_len, 2, "prefill"))
        dec = SV.make_decode_step(model, dcfg,
                                  ShapeConfig("d", t_len, 2, "decode"))
        _reset_counts()
        logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)
                                    .to(dev)})
        runs[dev] = dict(params=params, dec=dec, cache=cache,
                         logits=[logits.cpu()], prefill=_train_counts())
    counts = runs["cuda"]["prefill"]
    say(f"  launches in the card's prefill: {counts}")
    if counts["rmsnorm"] != cfg.n_layers + 1 or any(counts[k] for k in off):
        raise AssertionError(f"the fp32 prefill on the card: {counts}")
    check_close("xlstm smoke prefill logits cuda vs cpu",
                runs["cuda"]["logits"][0], runs["cpu"]["logits"][0], TOL32)
    _xlstm_state_close("xlstm smoke prefill cuda vs cpu",
                       runs["cuda"]["cache"], runs["cpu"]["cache"], TOL32)
    for i in range(3):
        tok = runs["cpu"]["logits"][-1].argmax(-1)
        if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1), tok):
            raise AssertionError(f"xlstm: greedy tokens differ at {i}")
        pos = torch.full((2,), prompt + i, dtype=torch.int64)
        for dev, r in runs.items():
            logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                          tok.to(dev), pos.to(dev))
            r["logits"].append(logits.cpu())
        check_close(f"xlstm smoke decode {i} logits cuda vs cpu",
                    runs["cuda"]["logits"][-1], runs["cpu"]["logits"][-1],
                    TOL32)
        err = _xlstm_state_close(f"xlstm smoke decode {i} cuda vs cpu",
                                 runs["cuda"]["cache"], runs["cpu"]["cache"],
                                 TOL32)
    say(f"  xlstm smoke serve: prefill + 3 decode steps, logits and "
        f"{len(list(_leaves(runs['cuda']['cache'])))} state leaves at TOL32 "
        f"(last state max abs err {err:.3e})")
    state["xlstm_smoke_launches"] = counts


def phase_full_xlstm_train(state):
    """xlstm-1.3b at every published width and depth (48 layers), B4 T2048,
    bf16 compute, fp32 storage, through `repro_torch.launch.train`'s
    Trainer (the reference launcher's defaults: the prefetch stack, bf16
    wire, remat fsdp_only, block buckets), XLSTM_TRAIN_STEPS timed steps,
    the last profiled: the readings of 8 with MFU on `_xlstm_flops`, the
    memory plan's modeled peak and the modeled step (H100 profile) beside
    the measured, the host ms the sLSTM time loops take a step, launch
    counts (rmsnorm 3 a layer + 1, xent 1 + 1, AdamW one a storage leaf;
    no flash, no SSD)."""
    import tempfile
    from repro_torch.core.obs import drift
    from repro_torch.launch import train as launch_train
    from repro_torch.models import xlstm as XM
    from repro_torch.models.common import ShapeConfig
    trainer = launch_train.build_trainer(launch_train.parse_args([
        "--arch", XLSTM, "--seq", str(TRAIN_T), "--batch", str(TRAIN_B),
        "--steps", "100", "--ckpt-dir", tempfile.mkdtemp(
            prefix="chip_smoke_xlstm_")]))
    # host seconds of each sLSTM time loop: forward (each call of
    # slstm_seq) and backward (from the gradient's arrival at the loop's
    # output to its arrival at the gate inputs, read by tensor hooks on
    # the graph that the backward walks)
    fwd, bwd, orig = [], [], XM.slstm_seq

    def timed(xg, R, state=None):
        t0 = time.perf_counter()
        out = orig(xg, R, state)
        fwd.append(time.perf_counter() - t0)
        if out[0].requires_grad:
            t = [0.0]

            def start(g):
                t[0] = time.perf_counter()

            def stop(g):
                bwd.append(time.perf_counter() - t[0])
            out[0].register_hook(start)
            xg.register_hook(stop)
        return out

    key = "train_xlstm_1_3b"
    XM.slstm_seq = timed
    try:
        par, storage, opt = _full_train(
            state, key, trainer.dcfg, arch=XLSTM, par=trainer.par,
            step=trainer.step_fn, steps=XLSTM_TRAIN_STEPS)
    finally:
        XM.slstm_seq = orig
    del storage, opt
    torch.cuda.empty_cache()
    cfg, model, r = par.model.cfg, par.model, state[key]
    counts = state[f"{key}_launches"]
    n_leaves = len(list(_leaves(model.metas(par.dcfg))))
    want = dict(rmsnorm=3 * cfg.n_layers + 1, xent_fwd=1, xent_bwd=1,
                adamw=n_leaves)
    per_step = {k: counts[k] / XLSTM_TRAIN_STEPS for k in want}
    if per_step != want:
        raise AssertionError(f"launches a step {per_step}, want {want}")
    off = [k for k in ("flash", "flash_f32", "flash_bwd", "flash_bwd_f32",
                       "ssd", "ssd_f32", "ssd_bwd", "ssd_bwd_f32")
           if counts[k]]
    if off:
        raise AssertionError(f"xlstm launched {off}: {counts}")
    # a step runs each block's loop three times forward (the stack's
    # forward, its recompute, the checkpoint's recompute) and once
    # backward; the warm-up step's come first
    steps = 1 + XLSTM_TRAIN_STEPS
    if (len(fwd), len(bwd)) != (3 * model.n_steps * steps,
                                model.n_steps * steps):
        raise AssertionError(f"{len(fwd)} sLSTM loop forwards and "
                             f"{len(bwd)} backwards over {steps} steps, "
                             f"want {3 * model.n_steps} and "
                             f"{model.n_steps} a step")
    # the unprofiled timed steps, which the median is taken over
    k = XLSTM_TRAIN_STEPS - 1
    f_ms = sum(fwd[3 * model.n_steps:3 * model.n_steps * (1 + k)]) * 1e3 / k
    b_ms = sum(bwd[model.n_steps:model.n_steps * (1 + k)]) * 1e3 / k
    loop_ms = f_ms + b_ms
    shape = ShapeConfig("train", TRAIN_T, TRAIN_B, "train")
    modeled_s = drift.modeled_step_time(model, par.plan, shape)
    flops = _xlstm_flops(cfg, model, TRAIN_B, TRAIN_T)
    say(f"  {cfg.name}: {cfg.n_params() / 1e9:.4f}B params (the metas), "
        f"{flops / 1e12:.2f} TFLOP a step (_xlstm_flops); the sLSTM time "
        f"loops take {loop_ms:.1f} ms of host time a step "
        f"({100 * loop_ms / r['step_ms']:.1f}% of the median step): their "
        f"{3 * model.n_steps} forwards {f_ms:.1f} ms, their "
        f"{model.n_steps} backwards {b_ms:.1f} ms")
    say(f"  modeled peak {par.plan.memory.peak / 2**30:.2f} GiB against "
        f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB "
        f"({par.plan.memory.peak / r['max_memory_allocated']:.3f}); modeled "
        f"step (H100 profile, drift.modeled_step_time) "
        f"{modeled_s * 1e3:.3f} ms against the measured "
        f"{r['step_ms']:.2f} ms")
    r.update(modeled_peak=par.plan.memory.peak,
             modeled_step_ms=modeled_s * 1e3, model_tflop=flops / 1e12,
             slstm_loop_host_ms=loop_ms, slstm_loop_fwd_host_ms=f_ms,
             slstm_loop_bwd_host_ms=b_ms)


def _xlstm_p1(model, dcfg, params, x, label, plant=False):
    """Prefill over x (B, p + 1) against prefill over x[:, :p] and one
    decode step of x[:, p].  Returns (want logits, got logits, launch
    counts of the long prefill and of the decode step, and with `plant` the
    logits of the same decode from a cache whose conv states were
    zeroed)."""
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    b, t = x.shape
    shape = ShapeConfig("p", t, b, "prefill")
    pos = torch.full((b,), t - 1, dtype=torch.int64, device=x.device)
    with torch.inference_mode():
        _reset_counts()
        want, full = model.prefill_local(
            params, {"tokens": x}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        counts = dict(prefill=_train_counts())
        del full
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :-1]}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        planted = None
        if plant:
            dropped = PG.kv_map(torch.clone, cache)
            for sub, leaves in dropped.items():
                if sub != "s":
                    leaves["conv"].zero_()
            planted, _ = model.decode_local(params, dropped, x[:, -1], pos,
                                            dcfg)
            del dropped
        _reset_counts()
        got, cache = model.decode_local(params, cache, x[:, -1], pos, dcfg)
        counts["decode"] = _train_counts()
    top2 = want.float().topk(2, dim=-1).values
    say(f"  {label}: logits RMS {want.float().pow(2).mean().sqrt().item():.4e}"
        f", max|logit| {want.abs().max().item():.4f}, max abs err "
        f"{max_err(got, want):.4e}, top-2 gaps "
        f"{[round(v, 5) for v in (top2[:, 0] - top2[:, 1]).tolist()]}, "
        f"argmax {want.argmax(-1).tolist()} vs {got.argmax(-1).tolist()}")
    return want, got, counts, planted


def _check_xlstm_serve_counts(counts, cfg, what, prefills=1, decodes=0):
    """One rmsnorm a block and the final norm a call; nothing else."""
    want = (prefills + decodes) * (cfg.n_layers + 1)
    off = [k for k, v in counts.items()
           if v and k not in ("rmsnorm", *COLLECTIVES)]
    if counts["rmsnorm"] != want or off:
        raise AssertionError(f"{what}: launches {counts}, want {want} "
                             "rmsnorm and no other kernel")


def phase_full_xlstm_serve(state):
    """xlstm-1.3b served at its published depth: bf16 weights made on the
    card, B 4, prompt 2000 padded to T 2064, 64 generated tokens through
    `repro_torch.launch.serve`: prefill ms, decode ms/token beside its byte
    bound, the device time of a decode step, peak memory, launch counts;
    then the p+1 check at p = T - 1 = 2063 (the prefill over p ends in a
    ragged chunk of 15 rows), prefill over p + 1 tokens against prefill
    over p and one decode step, in bf16 on the weights of each of
    XLSTM_SEEDS (XLSTM_BF16_CONSISTENCY_REL, with a planted fault: the
    conv states dropped) and on all 48 layers of seed 0's widened to fp32
    at TOL32; then on seed 0's, `_xlstm_drift` (the bf16 residual stream
    against the fp32 one after every sub-block; one sub-block deep to
    XLSTM_BLOCK_BF16_REL) and `_xlstm_cells_widen` (bit for bit, with
    XLSTM_PLANT as a planted fault)."""
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import tree_map
    from repro_torch.launch import serve as launch
    from repro_torch.train import serve as SV
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        XLSTM, False, B, PROMPT, GEN, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n = sum(a.numel() for a in _leaves(params))
    wbytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    say(f"{cfg.name} bf16, {cfg.n_layers} layers ({model.n_steps} "
        f"superblocks): {n / 1e9:.3f}B params, {wbytes / 1e9:.2f} GB, made "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN)
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads every weight but the embedding table (B rows of
    # it) and reads and writes every block's state (fp32)
    states = sum(a.numel() * 4 for a in _leaves(
        model.init_state(B, dcfg)))
    step_bytes = wbytes - params["embed"].numel() * 2 \
        + B * cfg.d_model * 2 + 2 * states
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    say(f"serve B={B} prompt={PROMPT} gen={GEN} T={T}: prefill "
        f"{t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"  decode byte bound {bound:.3f} ms/token ({step_bytes / 1e9:.3f} "
        f"GB a step: the states {2 * states / 1e9:.3f} GB read and written)")
    say(f"launches in the serve run (2 prefills, {GEN - 1} decode steps): "
        f"{counts}")
    state["serve_xlstm_launches"] = counts
    if tokens.shape != (B, GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    _check_xlstm_serve_counts(counts, cfg, "the serve run", prefills=2,
                              decodes=GEN - 1)
    logits, cache = prefill(params, {"tokens": padded})
    pos = torch.full((B,), PROMPT, dtype=torch.int64, device=dev)
    busy, dev_s = _profile("decode step", lambda: decode(
        params, cache, logits.argmax(-1), pos), 8, top=12)
    state["serve_xlstm"] = dict(
        t, max_memory_allocated=peak, decode_bound_ms=bound,
        decode_device_ms=None if dev_s is None else dev_s * 1e3,
        decode_busy=busy)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    del cache, logits

    dcfg32 = single_device_config(param_dtype=torch.float32)
    L = cfg.n_layers
    rel, planted_rel = [], []
    for seed in XLSTM_SEEDS:
        if seed:
            params = SV.init_serve_params(
                model, dcfg, torch.Generator(device=dev).manual_seed(seed),
                dev)
        x = torch.randint(3, cfg.vocab, (B, T), generator=torch.Generator()
                          .manual_seed(2 + seed)).to(dev)
        want, got, per_call, planted = _xlstm_p1(
            model, dcfg, params, x, f"bf16, {L} layers, p {T - 1}, weights "
            f"seed {seed}", plant=True)
        rms = want.float().pow(2).mean().sqrt().item()
        rel.append(max_err(got, want) / rms)
        planted_rel.append(max_err(planted, want) / rms)
        say(f"  bf16 seed {seed}: max abs err {rel[-1]:.4e} x the logits' "
            f"RMS; planted (conv states dropped) {planted_rel[-1]:.4e}")
        if not seed:
            _check_xlstm_serve_counts(per_call["prefill"], cfg, "one prefill")
            _check_xlstm_serve_counts(per_call["decode"], cfg,
                                      "one decode step", prefills=0,
                                      decodes=1)
            params0, x0, want0, got0 = params, x, want, got
        del params, planted
        torch.cuda.empty_cache()
    params, x, want, got = params0, x0, want0, got0
    del params0, x0, want0, got0
    params32 = tree_map(lambda a: a.float(), params)
    want32, got32, *_ = _xlstm_p1(
        model, dcfg32, params32, x,
        f"fp32 (seed 0's weights widened, all {L} layers)")
    drift = _xlstm_drift(model, dcfg, dcfg32, params, params32, x)
    widen = _xlstm_cells_widen(model, dcfg, params, x)
    widen_planted = _xlstm_cells_widen(model, dcfg, params, x, plant=True)[1]
    del params, params32
    torch.cuda.empty_cache()
    say(f"  bf16 prefill vs fp32 prefill, same weights, {L} layers: max abs "
        f"err {max_err(want, want32):.4e} (logits' RMS "
        f"{want32.pow(2).mean().sqrt().item():.4e}; for scale, not a limit)")
    check_close("fp32: prefill vs prefill + decode", got32, want32, TOL32)
    if not torch.equal(got32.argmax(-1), want32.argmax(-1)):
        raise AssertionError("fp32: argmax differs")
    say(f"  bf16 p+1 over {len(XLSTM_SEEDS)} weight seeds: "
        f"{[f'{v:.4e}' for v in rel]} x the logits' RMS (limit "
        f"{XLSTM_BF16_CONSISTENCY_REL:g}); planted: "
        f"{[f'{v:.4e}' for v in planted_rel]}")
    if max(rel) > XLSTM_BF16_CONSISTENCY_REL:
        raise AssertionError("bf16: prefill vs prefill + decode")
    if min(planted_rel) <= XLSTM_BF16_CONSISTENCY_REL:
        raise AssertionError("the planted fault (conv states dropped) "
                             "passed the bf16 limit")
    err = max_err(got, want)
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    say(f"  bf16 seed 0: argmax equal {same.tolist()}, top-2 gap above 2 x "
        f"{err:.3e} {clear.tolist()}")
    if not bool(same[clear].all()):
        raise AssertionError("bf16: argmax differs where the gap is clear")
    worst = max(drift["block"])
    say(f"  bf16 vs fp32 one sub-block deep: at most {worst:.4e} of the "
        f"output's RMS (limit {XLSTM_BLOCK_BF16_REL:g}); under the plant "
        f"{max(drift['planted']):.4e}, within bf16's own noise")
    if worst > XLSTM_BLOCK_BF16_REL:
        raise AssertionError("bf16 vs fp32, one sub-block deep")
    calls, diff = widen
    say(f"  the cells on bf16 inputs against the same inputs widened to "
        f"fp32 ({calls} calls: the first superblock's prefill and decode "
        f"step): max abs difference {diff:.3e} (must be 0); with the plant "
        f"in the bf16 calls {widen_planted:.3e}")
    if diff:
        raise AssertionError("the cells' bf16 calls differ from their "
                             "widened inputs'")
    if not widen_planted:
        raise AssertionError("the planted fault (the cells' calls rounded "
                             "to bf16) passed the widening check")
    state["xlstm_consistency"] = dict(
        bf16_rel=rel, planted_rel=planted_rel, fp32=max_err(got32, want32),
        block_rel=drift["block"], block_planted_rel=drift["planted"],
        cells_widen=widen[1], cells_widen_planted=widen_planted,
        gap=drift["gap"], control_gap=drift["control"])


class _CellOpsInBf16:
    """A planted fault for `_xlstm_drift`: stands in for `torch` inside
    `repro_torch.models.xlstm` and rounds the result of each of the cells'
    torch calls named in `rounded` to bf16, as if the cells computed them
    in the compute dtype instead of widening to fp32."""

    def __init__(self, rounded):
        self.rounded = rounded

    def __getattr__(self, name):
        fn = getattr(torch, name)
        if name not in self.rounded:
            return fn
        return lambda *a, **kw: fn(*a, **kw).bfloat16().float()


def _xlstm_cells_widen(model, dcfg, params, x, plant=False):
    """The cells compute in fp32 whatever their inputs' dtype.  Through the
    first superblock of a bf16 prefill over x[:, :-1] and one decode step
    of x[:, -1], each call of `mlstm_chunked`, `mlstm_step` and
    `slstm_seq` is repeated on its inputs widened to fp32: every fp32
    tensor it returns (the states; slstm_seq's hs) must equal the bf16
    call's bit for bit, the same fp32 values having gone through the same
    fp32 operations.  `plant`: the bf16 calls run under
    `_CellOpsInBf16(XLSTM_PLANT)`.  Returns (the calls, the largest abs
    difference)."""
    from repro_torch.core.meta import tree_map
    from repro_torch.models import layers as LY
    from repro_torch.models import xlstm as XM
    cells = {n: getattr(XM, n) for n in ("mlstm_chunked", "mlstm_step",
                                         "slstm_seq")}
    real, diffs = XM.torch, []

    def widen(a):
        return a.float() if torch.is_tensor(a) and \
            a.dtype == torch.bfloat16 else a

    def pairs(out, wide):
        """(bf16 call's, widened call's) leaf where the first is fp32."""
        if torch.is_tensor(out):
            return [(out, wide)] if out.dtype == torch.float32 else []
        return [p for o, w in zip(out, wide, strict=True)
                for p in pairs(o, w)]

    def checked(fn):
        def call(*a, **kw):
            if plant:
                XM.torch = _CellOpsInBf16(XLSTM_PLANT)
            try:
                out = fn(*a, **kw)
            finally:
                XM.torch = real
            wide = fn(*map(widen, a), **{k: widen(v) for k, v in kw.items()})
            diffs.append(max(max_err(g, w) for g, w in pairs(out, wide)))
            return out
        return call

    subs = [f"m{i}" for i in range(model.per - 1)] + ["s"]
    p = tree_map(lambda a: a[0], params["blocks"])
    cfg = model.cfg
    for n, fn in cells.items():
        setattr(XM, n, checked(fn))
    try:
        with torch.inference_mode():
            h = LY.embed_apply(params["embed"], x[:, :-1], cfg, dcfg)
            t = LY.embed_apply(params["embed"], x[:, -1:], cfg, dcfg)
            for k in subs:
                fn = model._slstm if k == "s" else model._mlstm
                h, st = fn(p[k], h)
                t = fn(p[k], t, st)[0]
    finally:
        for n, fn in cells.items():
            setattr(XM, n, fn)
    return len(diffs), max(diffs)


def _xlstm_drift(model, dcfg, dcfg32, params, params32, x):
    """Where the bf16 prefill leaves the fp32 one.  The residual streams of
    the bf16 weights and of the same weights widened to fp32, run over x
    from the empty state sub-block by sub-block: the RMS of their
    difference over the fp32 stream's RMS after each sub-block (`gap`),
    and `control`, the fp32 stream rounded to bf16 once after the first
    sub-block, against the fp32 stream: how far the fp32 model itself
    carries one perturbation of bf16's size.  One sub-block deep, where
    the two agree (`block`): each sub-block of the first superblock in
    bf16 against fp32 on the fp32 stream's input (rounded to bf16 for
    the bf16 one), the RMS of the difference of their outputs over the
    fp32 output's RMS; the same for the bf16 sub-blocks under XLSTM_PLANT
    (`planted`)."""
    from repro_torch.core.meta import tree_map
    from repro_torch.models import layers as LY
    from repro_torch.models import xlstm as XM
    cfg = model.cfg
    subs = [f"m{i}" for i in range(model.per - 1)] + ["s"]

    def rel(a, b):
        return ((a.float() - b).pow(2).mean().sqrt()
                / b.pow(2).mean().sqrt()).item()

    def out(p, k, h):
        return (model._slstm if k == "s" else model._mlstm)(p[k], h)[0]

    gap, control, block = [], [], []
    planted = []
    real = XM.torch
    with torch.inference_mode():
        h16 = LY.embed_apply(params["embed"], x, cfg, dcfg)
        h32 = LY.embed_apply(params32["embed"], x, cfg, dcfg32)
        hc = None
        for li in range(model.n_steps):
            p16 = tree_map(lambda a: a[li], params["blocks"])
            p32 = tree_map(lambda a: a[li], params32["blocks"])
            for k in subs:
                if li == 0:
                    want = out(p32, k, h32)
                    block.append(rel(out(p16, k, h32.bfloat16()), want))
                    XM.torch = _CellOpsInBf16(XLSTM_PLANT)
                    try:
                        planted.append(rel(out(p16, k, h32.bfloat16()),
                                           want))
                    finally:
                        XM.torch = real
                    del want
                fn = model._slstm if k == "s" else model._mlstm
                h16 = fn(p16[k], h16)[0]
                h32 = fn(p32[k], h32)[0]
                hc = h32.bfloat16().float() if hc is None \
                    else fn(p32[k], hc)[0]
                gap.append(rel(h16, h32))
                control.append(rel(hc, h32))
        del h16, h32, hc
    say(f"  bf16 vs fp32 residual stream, RMS of the difference over the "
        f"fp32 RMS after each sub-block ({', '.join(subs)} a superblock):")
    for li in range(model.n_steps):
        row = slice(li * model.per, (li + 1) * model.per)
        say(f"    superblock {li}: bf16 "
            f"{' '.join(f'{v:.2e}' for v in gap[row])}")
        say(f"    {'':13s}control "
            f"{' '.join(f'{v:.2e}' for v in control[row])}")
    say("  one sub-block deep (superblock 0, the fp32 stream's input), bf16 "
        "vs fp32 output, RMS of the difference over the fp32 RMS:")
    say(f"    sound   {' '.join(f'{v:.3e}' for v in block)}")
    say(f"    planted {' '.join(f'{v:.3e}' for v in planted)}")
    return dict(gap=gap, control=control, block=block, planted=planted)


ENCDEC = "seamless_m4t_large_v2"
# the p+1 check of the full-width bf16 serve (24 decoder layers over 2064
# target tokens, 1032 frames): max |prefill(p+1) - prefill(p)+decode| over
# the logits' RMS.  The two paths round differently in bf16 (the flash
# kernel's P against the decode's fp32 softmax cast once, products over
# B x T rows against B rows), and 24 residual layers carry that on.  The
# limit was set before the first full-width run, from xlstm-1.3b's 48
# layers, which read up to 0.37 of the logits' RMS on sound builds: half
# of the RMS leaves that room while a cross cache of the decoder's own keys
# (the planted fault) moves every logit by about its RMS.  A sound build
# read 7.45e-2 and the plant 4.29 (NVIDIA H100 80GB HBM3, 700.00 W)
ENCDEC_BF16_CONSISTENCY_REL = 0.5


def phase_encdec_kernels(state):
    """The kernels seamless-m4t-large-v2's path runs, at its shapes: rmsnorm
    at (4096, 1024) bf16 (the training rows: B4 x 1024 frames or target
    tokens), (8256, 1024) and (4128, 1024) (the serve prefill's decoder and
    encoder rows), xent forward and backward at (4096, 256208) fp32, AdamW
    at the path's largest flat leaf (`_path_kernels`); the bf16 flash
    forward at B4 S = T 1024 H16 Kh16 hd64 non-causal (the encoder's
    self-attention and the cross-attention) and causal (the decoder's
    self-attention), and at the serve prefill's cross-attention, B4 S2064
    T1032 non-causal: each against its plain version (FLASH_BF16_RMS_REL
    with its two planted faults), with wall and device ms beside SDPA's and
    the bound; the flash backward (`flash_grad_case`) at B4 S = T 1024
    hd64, non-causal and causal."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    rows = TRAIN_B * TRAIN_T // 2
    _path_kernels(state, "encdec", ENCDEC, (
        (rows, "training"), (B * T, "prefill decoder"),
        (B * (T // 2), "prefill encoder")), rows)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    h, hd, s_tr = 16, 64, TRAIN_T // 2
    cases = [  # (name, B, S, T, causal)
        (f"B{TRAIN_B} S{s_tr} T{s_tr} H16 Kh16 hd64 non-causal bf16 (the "
         "encoder's self-attention, the cross-attention)", TRAIN_B, s_tr,
         s_tr, False),
        (f"B{TRAIN_B} S{s_tr} T{s_tr} H16 Kh16 hd64 causal bf16 (the "
         "decoder's self-attention)", TRAIN_B, s_tr, s_tr, True),
        (f"B{B} S{T} T{T // 2} H16 Kh16 hd64 non-causal bf16 (the serve "
         "prefill's cross-attention)", B, T, T // 2, False),
    ]
    say("flash kernel vs plain at seamless-m4t-large-v2's shapes (ms: "
        "kernel / plain / SDPA / bound; the kernel's and SDPA's device "
        "time):")
    out = []
    for name, b, s, t, causal in cases:
        q, k, v = randn(b, s, h, hd), randn(b, t, h, hd), randn(b, t, h, hd)
        kw = dict(causal=causal)
        n = flash_ops.launches
        got = flash_ops.flash_attention(q, k, v, **kw)
        if flash_ops.launches != n + 1:
            raise AssertionError(f"{name}: the bf16 flash kernel did not "
                                 "launch")
        want = flash_ref.attention(q, k, v, **kw)
        err = check_rms(name, got, want, FLASH_BF16_RMS_REL)
        check_flash_plants(name, q, k, v, want, **kw)
        del got, want
        # causal only where S == T: the lower triangle; else every pair
        pairs = s * (s + 1) / 2 if causal else s * t
        flops = 4.0 * hd * b * h * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound, by = _bound(nbytes, flops, torch.bfloat16, products=True)
        fwd = lambda: flash_ops.flash_attention(q, k, v, **kw)  # noqa: E731
        ms, on_card = time_ms(fwd), device_ms(fwd, bound)
        plain = time_ms(lambda: flash_ref.attention(q, k, v, **kw))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal)
        lib, lib_dev = time_ms(sdpa), device_ms(sdpa, bound)
        say(f"    {ms:.4f} / {plain:.4f} / {lib:.4f} / {bound:.4f} ({by}; "
            f"{flops / on_card / 1e9:.1f} TFLOP/s on the device); device "
            f"{on_card:.4f}, SDPA device {lib_dev:.4f} (kernel / SDPA "
            f"{on_card / lib_dev:.2f}x)")
        out.append(dict(shape=name, max_abs_err=err, ms=ms,
                        device_ms=on_card, plain_ms=plain, library_ms=lib,
                        library_device_ms=lib_dev, bound_ms=bound,
                        bound_by=by))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    state["encdec_flash"] = out
    for causal in (False, True):
        mask = "causal" if causal else "non-causal"
        flash_grad_case(state, f"encdec_flash_bwd_{mask}",
                        f"flash grad B{TRAIN_B} T{s_tr} H16 Kh16 hd64 {mask} "
                        "bf16", TRAIN_B, s_tr, h, h, hd, dict(causal=causal),
                        torch.bfloat16, g)


def _encdec_inputs(cfg, b, t, dev, seed):
    """(tokens (b, t) int64, frames (b, t // 2, frontend_dim) fp32) from a
    seed: the serve launcher's frames, random tokens."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(3, cfg.vocab, (b, t), generator=g)
    frames = torch.randn((b, t // 2, cfg.frontend_dim), generator=g) * 0.3
    return tokens.to(dev), frames.to(dev)


def _encdec_p1(model, dcfg, params, x, frames, label, plant=False):
    """Prefill over x (B, p + 1) against prefill over x[:, :p] into a self
    cache of capacity p + 1 and one decode step of x[:, p] at p, the same
    frames (p + 1) // 2 of them.  Returns (want logits, got logits, launch
    counts of the long prefill and of the decode step, and with `plant`
    the logits of the same decode from a cache whose cross keys and values
    are the decoder's self keys and values of the first S_src positions,
    not the memory's)."""
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    b, t = x.shape
    shape = ShapeConfig("p", t, b, "prefill")
    pos = torch.full((b,), t - 1, dtype=torch.int64, device=x.device)
    with torch.inference_mode():
        _reset_counts()
        want, full = model.prefill_local(
            params, {"tokens": x, "frames": frames}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        counts = dict(prefill=_train_counts())
        del full
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :-1], "frames": frames}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        planted = None
        if plant:
            bad = PG.kv_map(torch.clone, cache)
            for a, s_ in zip(bad["cross"], bad["self"]):
                a.copy_(s_[:, :, :a.shape[2]])
            planted, _ = model.decode_local(params, bad, x[:, -1], pos, dcfg)
            del bad
        _reset_counts()
        got, cache = model.decode_local(params, cache, x[:, -1], pos, dcfg)
        counts["decode"] = _train_counts()
    top2 = want.float().topk(2, dim=-1).values
    say(f"  {label}: logits RMS {want.float().pow(2).mean().sqrt().item():.4e}"
        f", max|logit| {want.abs().max().item():.4f}, max abs err "
        f"{max_err(got, want):.4e}, top-2 gaps "
        f"{[round(v, 5) for v in (top2[:, 0] - top2[:, 1]).tolist()]}, "
        f"argmax {want.argmax(-1).tolist()} vs {got.argmax(-1).tolist()}")
    return want, got, counts, planted


def _check_encdec_serve_counts(counts, model, what, route, prefills=0,
                               decodes=0):
    """rmsnorm and flash's `route` ("flash" or "flash_f32") launched for
    `prefills` prefills and `decodes` decode steps, and no other kernel: a
    prefill 2 norms an encoder layer, 3 a decoder layer, the encoder's and
    the final norm, one flash forward an encoder layer and two a decoder
    layer; a decode step 3 norms a decoder layer and the final norm, no
    flash."""
    norms = 2 * model.n_enc + 3 * model.n_dec + 2
    want = {"rmsnorm": prefills * norms
            + decodes * (3 * model.n_dec + 1),
            route: prefills * (model.n_enc + 2 * model.n_dec)}
    got = {k: counts[k] for k in want}
    off = [k for k, v in counts.items()
           if v and k not in (*want, *COLLECTIVES)]
    if got != want or off:
        raise AssertionError(f"{what}: launches {counts}, want {want} and "
                             "no other kernel")


def phase_encdec_smoke(state):
    """seamless-m4t-large-v2 SMOKE in fp32 with the same numpy-seeded
    weights on the card and on the CPU: the loss and every gradient of one
    loss step at seq 32 (16 frames, 16 target tokens) on the vanilla and
    the prefetch stack (the decoder's carry {"h", "mem"}), the encoder's
    leaves included; prefill of 20 target tokens over 10 frames and 3
    decode steps, logits and both caches; on the card, the p+1 check at p
    = 19; all at TOL32, on flash's fp32 routes."""
    from repro_torch.core.api import parallelize
    from repro_torch.core.dist import DistConfig, single_device_config
    from repro_torch.core.meta import named_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticC4, \
        adapt_batch
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    cfg, model = get_arch(ENCDEC, smoke=True)
    tree = _numpy_params(model, single_device_config(
        param_dtype=torch.float32), seed=0)
    b, t = 4, 32
    shape = ShapeConfig("t", t, b, "train")
    batch = adapt_batch(SyntheticC4(DataConfig(
        vocab=cfg.vocab, seq_len=t, global_batch=b, seed=0)).batch(0),
        model.input_specs(shape, DistConfig()), 0)
    off = ("flash", "flash_bwd", "ssd", "ssd_f32", "ssd_bwd", "ssd_bwd_f32")
    for reorder in (False, True):
        label = "prefetch" if reorder else "vanilla"
        dcfg = DistConfig(param_dtype=torch.float32, reorder=reorder)
        runs = {}
        for dev in ("cpu", "cuda"):
            par = parallelize(model, dcfg, shape, device=dev)
            storage = _storage_from_full(model, dcfg, tree, dev)
            _reset_counts()
            loss, grads = par.loss_step()(storage, batch)
            runs[dev] = (loss, grads, _train_counts())
        counts = runs["cuda"][2]
        say(f"  encdec smoke {label} loss step: launches on the card "
            f"{counts}")
        if min(counts[k] for k in ("rmsnorm", "flash_f32", "flash_bwd_f32",
                                   "xent_fwd", "xent_bwd")) <= 0 \
                or any(counts[k] for k in off):
            raise AssertionError(f"encdec smoke {label}: launches {counts}")
        if max(v for k, v in runs["cpu"][2].items()
               if k not in COLLECTIVES) > 0:
            raise AssertionError("the CPU loss step launched a kernel")
        check_close(f"encdec smoke {label} loss cuda vs cpu",
                    runs["cuda"][0].cpu(), runs["cpu"][0], TOL32)
        errs = []
        for (n, a), (_, b_) in zip(named_leaves(runs["cuda"][1]),
                                   named_leaves(runs["cpu"][1])):
            if n.split("/")[0] in ("enc_blocks", "front_proj", "enc_norm") \
                    and not float(b_.abs().max()) > 0:
                raise AssertionError(f"encdec smoke: zero gradient {n}")
            errs.append(check_close(f"encdec smoke {label} grad {n}", a.cpu(),
                                    b_, TOL32))
        say(f"  encdec smoke {label}: loss {float(runs['cuda'][0]):.6f}, "
            f"{len(errs)} gradient leaves, max abs err {max(errs):.3e}")

    prompt, gen = 17, 3
    t_len = prompt + gen
    dcfg = single_device_config(param_dtype=torch.float32)
    x, frames = _encdec_inputs(cfg, 2, t_len, "cpu", seed=1)
    x[:, prompt:] = 3                     # padded as the launchers pad
    runs = {}
    for dev in ("cpu", "cuda"):
        params = SV.serve_params_from_jax(tree, model, dcfg, device=dev)
        pf = SV.make_prefill_step(model, dcfg,
                                  ShapeConfig("p", t_len, 2, "prefill"))
        dec = SV.make_decode_step(model, dcfg,
                                  ShapeConfig("d", t_len, 2, "decode"))
        _reset_counts()
        logits, cache = pf(params, {"tokens": x.to(dev),
                                    "frames": frames.to(dev)})
        runs[dev] = dict(params=params, dec=dec, cache=cache,
                         logits=[logits.cpu()], prefill=_train_counts())
    _check_encdec_serve_counts(runs["cuda"]["prefill"], model,
                               "the card's fp32 prefill", "flash_f32",
                               prefills=1)
    check_close("encdec smoke prefill logits cuda vs cpu",
                runs["cuda"]["logits"][0], runs["cpu"]["logits"][0], TOL32)

    def caches(what):
        for part in ("self", "cross"):
            for name, a, b_ in zip("kv", runs["cuda"]["cache"][part],
                                   runs["cpu"]["cache"][part]):
                check_close(f"{what} {part} {name} cuda vs cpu", a.cpu(), b_,
                            TOL32)
    caches("encdec smoke prefill")
    for i in range(3):
        tok = runs["cpu"]["logits"][-1].argmax(-1)
        if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1), tok):
            raise AssertionError(f"encdec: greedy tokens differ at {i}")
        pos = torch.full((2,), prompt + i, dtype=torch.int64)
        for dev, r in runs.items():
            logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                          tok.to(dev), pos.to(dev))
            r["logits"].append(logits.cpu())
        check_close(f"encdec smoke decode {i} logits cuda vs cpu",
                    runs["cuda"]["logits"][-1], runs["cpu"]["logits"][-1],
                    TOL32)
        caches(f"encdec smoke decode {i}")
    params = runs["cuda"]["params"]
    xc, fc = _encdec_inputs(cfg, 2, t_len, "cuda", seed=2)
    want, got, per_call, planted = _encdec_p1(
        model, dcfg, params, xc, fc, f"encdec smoke p+1 at p {t_len - 1}",
        plant=True)
    check_close("encdec smoke: prefill vs prefill + decode", got, want,
                TOL32)
    check_rejects("encdec smoke p+1 planted: a cross cache of the decoder's "
                  "keys", planted, want, TOL32)
    _check_encdec_serve_counts(per_call["decode"], model,
                               "an fp32 decode step", "flash_f32", decodes=1)
    state["encdec_smoke_launches"] = runs["cuda"]["prefill"]


def phase_full_encdec_train(state):
    """seamless-m4t-large-v2 at every published width and depth (24 + 24
    layers), B4 at seq 2048 (S_src = S_tgt = 1024), bf16 compute, fp32
    storage, remat fsdp_only, block buckets, through `parallelize(...)
    .train_step` on the vanilla stack and on the prefetch stack (bf16 wire):
    the readings of 8 with MFU on `_encdec_flops`, the memory plan's
    modeled peak (H100 profile) beside the measured, and launches a step:
    flash forward one an attention call (72) on the vanilla stack and two
    (144) on the prefetch stack, which recomputes each layer in its
    backward; one flash backward an attention call; rmsnorm 2 an encoder
    layer + 3 a decoder layer (+ their recompute) + the encoder's and the
    final norm; xent 1 + 1; AdamW one a storage leaf."""
    from repro_torch.core.dist import DistConfig
    from repro_torch.core.memory import plan_memory
    from repro_torch.models.common import ShapeConfig
    for reorder, key in ((False, "train_encdec"),
                         (True, "train_encdec_prefetch")):
        par, storage, opt = _full_train(state, key,
                                        DistConfig(reorder=reorder),
                                        arch=ENCDEC)
        del storage, opt
        torch.cuda.empty_cache()
        model, r = par.model, state[key]
        counts = state[f"{key}_launches"]
        times = 2 if reorder else 1
        norms = 2 * model.n_enc + 3 * model.n_dec
        want = dict(flash=times * _attn_calls(model),
                    flash_bwd=_attn_calls(model),
                    rmsnorm=times * norms + 2, xent_fwd=1, xent_bwd=1,
                    adamw=len(list(_leaves(model.metas(par.dcfg)))))
        per_step = {k: counts[k] / TRAIN_STEPS for k in want}
        say(f"  launches a step {per_step} (want {want})")
        if per_step != want:
            raise AssertionError(f"launches a step {per_step}, want {want}")
        mem = par.plan.memory
        say(f"  modeled peak {mem.peak / 2**30:.2f} GiB ({mem.describe()}) "
            f"against max_memory_allocated "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB (modeled / "
            f"measured {mem.peak / r['max_memory_allocated']:.3f})")
        for b_ in mem.breakdown:
            say(f"    {b_.describe()}")
        # the reference prices the decoder block's workload and the logits
        # at the cell's seq rows, where each stack sees seq / 2: the same
        # plan priced at seq / 2
        half = plan_memory(model, par.dcfg, ShapeConfig(
            "train", TRAIN_T // 2, TRAIN_B, "train"))
        say(f"  the same plan priced at seq {TRAIN_T // 2} (the rows each "
            f"stack sees): {half.peak / 2**30:.2f} GiB (modeled / measured "
            f"{half.peak / r['max_memory_allocated']:.3f})")
        r.update(modeled_peak=mem.peak, modeled_peak_half_seq=half.peak,
                 model_tflop=_encdec_flops(model.cfg, model, TRAIN_B,
                                           TRAIN_T) / 1e12)


def phase_full_encdec_serve(state):
    """seamless-m4t-large-v2 served at its published depth: bf16 weights
    made on the card, B 4, prompt 2000 padded to T 2064 over 1032 seeded
    frames, 64 generated tokens through `repro_torch.launch.serve`:
    prefill ms, decode ms/token beside its byte bound, the device time of a
    decode step, peak memory, launch counts (`_check_encdec_serve_counts`);
    then the p+1 check at p = 2063 over the same 1032 frames, in bf16
    (ENCDEC_BF16_CONSISTENCY_REL of the logits' RMS, the argmax where the
    top-2 gap is clear; a cross cache of the decoder's keys planted must
    fail it) and on the weights widened to fp32 at TOL32."""
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import tree_map
    from repro_torch.launch import serve as launch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        ENCDEC, False, B, PROMPT, GEN, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n = sum(a.numel() for a in _leaves(params))
    wbytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    say(f"{cfg.name} bf16, {model.n_enc} + {model.n_dec} layers: "
        f"{n / 1e9:.3f}B params, {wbytes / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    frames = launch.make_frames(model, dcfg, B, T, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN,
                                frames)
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads the decoder's weights, the final norm, the head
    # and B rows of the embedding; the self keys and values up to its
    # position and the whole cross cache; it writes one self key and value
    # a row and layer (2 bytes an element)
    it = 2
    dec_w = sum(a.numel() for a in _leaves(params["dec_blocks"])) \
        + cfg.d_model + params["head"].numel() + B * cfg.d_model
    kv_row = model.n_dec * B * cfg.n_kv_heads * cfg.head_dim * 2
    step_bytes = it * (dec_w + kv_row * (PROMPT + 1) + kv_row * (T // 2)
                       + kv_row)
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    say(f"serve B={B} prompt={PROMPT} gen={GEN} T={T} frames={T // 2}: "
        f"prefill {t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"  decode byte bound {bound:.4f} ms/token ({step_bytes / 1e9:.4f} "
        f"GB a step at position {PROMPT})")
    say(f"launches in the serve run (2 prefills, {GEN - 1} decode steps): "
        f"{counts}")
    state["serve_encdec_launches"] = counts
    if tokens.shape != (B, GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    _check_encdec_serve_counts(counts, model, "the serve run", "flash",
                               prefills=2, decodes=GEN - 1)
    logits, cache = prefill(params, {"tokens": padded, "frames": frames})
    pos = torch.full((B,), PROMPT, dtype=torch.int64, device=dev)
    busy, dev_s = _profile("decode step", lambda: decode(
        params, cache, logits.argmax(-1), pos), 8, top=12)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    state["serve_encdec"] = dict(
        t, max_memory_allocated=peak, decode_bound_ms=bound,
        decode_device_ms=None if dev_s is None else dev_s * 1e3,
        decode_busy=busy)
    del cache, logits

    x, fr = _encdec_inputs(cfg, B, T, dev, seed=3)
    want, got, per_call, planted = _encdec_p1(
        model, dcfg, params, x, fr, f"bf16, {model.n_dec} decoder layers, p "
        f"{T - 1}, {T // 2} frames", plant=True)
    _check_encdec_serve_counts(per_call["prefill"], model, "one prefill",
                               "flash", prefills=1)
    _check_encdec_serve_counts(per_call["decode"], model, "one decode step",
                               "flash", decodes=1)
    rms = want.float().pow(2).mean().sqrt().item()
    err = max_err(got, want)
    rel, planted_rel = err / rms, max_err(planted, want) / rms
    say(f"  bf16 p+1: max abs err {err:.4e} = {rel:.4e} x the logits' RMS "
        f"(limit {ENCDEC_BF16_CONSISTENCY_REL:g}); planted (a cross cache "
        f"of the decoder's keys) {planted_rel:.4e}")
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    say(f"  bf16: argmax equal {same.tolist()}, top-2 gap above 2 x "
        f"{err:.3e} {clear.tolist()}")
    dcfg32 = single_device_config(param_dtype=torch.float32)
    params32 = tree_map(lambda a: a.float(), params)
    del params
    torch.cuda.empty_cache()
    want32, got32, per32, _ = _encdec_p1(
        model, dcfg32, params32, x, fr,
        f"fp32 (the weights widened, all {cfg.n_layers} layers)")
    del params32
    torch.cuda.empty_cache()
    say(f"  bf16 prefill vs fp32 prefill, same weights: max abs err "
        f"{max_err(want, want32):.4e} (for scale, not a limit)")
    state["encdec_consistency"] = dict(
        bf16_rel=rel, planted_rel=planted_rel, fp32=max_err(got32, want32),
        bf16_vs_fp32=max_err(want, want32))
    _check_encdec_serve_counts(per32["prefill"], model, "one fp32 prefill",
                               "flash_f32", prefills=1)
    check_close("fp32: prefill vs prefill + decode", got32, want32, TOL32)
    if not torch.equal(got32.argmax(-1), want32.argmax(-1)):
        raise AssertionError("fp32: argmax differs")
    if rel > ENCDEC_BF16_CONSISTENCY_REL:
        raise AssertionError("bf16: prefill vs prefill + decode")
    if planted_rel <= ENCDEC_BF16_CONSISTENCY_REL:
        raise AssertionError("the planted fault (a cross cache of the "
                             "decoder's keys) passed the bf16 limit")
    if not bool(same[clear].all()):
        raise AssertionError("bf16: argmax differs where the gap is clear")


# ---------------------------------------------------------------------------
# The vlm family (the main path of the seventeenth slice)
# ---------------------------------------------------------------------------
VLM = "internvl2_26b"
# full-width training: B 2 at seq 2048 (1025 image positions + 1023 text
# tokens), 6 of the 48 layers: the fp32 training state is 17.8 GiB for the
# embedding, head and projector and 5.81 GiB a layer, so 8 layers would
# leave ~8 GiB of the card for activations, logits and the gathered bf16
# weights (the memory plan prints its modeled peak at 6 and at 8 layers)
VLM_TRAIN_LAYERS, VLM_TRAIN_B = 6, 2
# the full-width serve's p+1 check in fp32: the first layers widened
VLM_F32_LAYERS = 8
# the p+1 check of the full-width bf16 serve (48 layers over 1025 image
# positions and 2064 text tokens): max |prefill(p+1) - prefill(p)+decode|
# over the logits' RMS.  The two paths round differently in bf16 (the
# flash kernel's P against the decode's fp32 softmax cast once, products
# over B x T rows against B rows), and 48 residual layers carry that on.
# Set before the first full-width run, from seamless-m4t-large-v2's 24
# decoder layers (7.45e-2 of the RMS on a sound build) and xlstm-1.3b's 48
# (up to 0.37): half the RMS leaves room for twice the depth, while the
# reference launcher's decode position (p, no image offset: the token
# overwrites an image position and sees the images only), the planted
# fault, moves every logit by about its RMS
VLM_BF16_CONSISTENCY_REL = 0.5


def phase_vlm_kernels(state):
    """The kernels internvl2-26b's path runs, at its shapes: rmsnorm at
    (4096, 6144) bf16 (the training rows: B2 x 2048 positions) and (12356,
    6144) (the serve prefill's: B4 x 3089), xent forward and backward at
    (4096, 92560) fp32 with the 1025 image rows of every 2048 masked as
    `stage_loss` masks them, AdamW at the 568,688,640-element embedding
    (`_path_kernels`); the bf16 flash forward at a GQA group of 6 (H48 on
    Kh8, hd128, causal) at the training shape B2 T2048 and the serve
    prefill's B4 T3089, each against its plain version (FLASH_BF16_RMS_REL
    with its two planted faults), with wall and device ms beside SDPA's
    and the bound; the flash backward (`flash_grad_case`) at the training
    shape, dK and dV summed over a group of 6."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models.registry import get_arch
    cfg, _ = get_arch(VLM)
    n_img, dev = cfg.n_img_tokens, torch.device("cuda")
    rows, cell = VLM_TRAIN_B * TRAIN_T, n_img + T
    valid = (torch.arange(rows, device=dev) % TRAIN_T >= n_img).float()
    _path_kernels(state, "vlm", VLM, ((rows, "training"),
                                      (B * cell, "prefill")), rows,
                  xent_valid=valid, adamw_n=cfg.vocab * cfg.d_model)
    g = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    say("flash kernel vs plain at internvl2-26b's shapes, a GQA group of "
        f"{h // kh} (ms: kernel / plain / SDPA / bound; the kernel's and "
        "SDPA's device time):")
    out = []
    for b, s_, by_heads in ((VLM_TRAIN_B, TRAIN_T, False),
                            (B, cell, True)):
        name = f"B{b} T{s_} H{h} Kh{kh} hd{hd} causal bf16"
        q, k, v = randn(b, s_, h, hd), randn(b, s_, kh, hd), \
            randn(b, s_, kh, hd)
        n = flash_ops.launches
        got = flash_ops.flash_attention(q, k, v, causal=True)
        if flash_ops.launches != n + 1:
            raise AssertionError(f"{name}: the bf16 flash kernel did not "
                                 "launch")
        ref = lambda *a: flash_ref.attention(*a, causal=True)  # noqa: E731
        plain = (lambda: _by_kv_heads(ref, q, k, v)) if by_heads else \
            (lambda: ref(q, k, v))
        want = plain()
        err = check_rms(name, got, want, FLASH_BF16_RMS_REL)
        if by_heads:
            for pname, planted in _by_kv_heads(
                    lambda *a: flash_plants(*a, causal=True), q, k,
                    v).items():
                check_plant_rejected(f"{name}, {pname}", planted, want,
                                     FLASH_BF16_RMS_REL)
                del planted
        else:
            check_flash_plants(name, q, k, v, want, causal=True)
        del got, want
        torch.cuda.empty_cache()
        flops = 4.0 * hd * b * h * s_ * (s_ + 1) / 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound, by = _bound(nbytes, flops, torch.bfloat16, products=True)
        fwd = lambda: flash_ops.flash_attention(q, k, v,  # noqa: E731
                                                causal=True)
        ms, on_card = time_ms(fwd), device_ms(fwd, bound)
        plain_ms = time_ms(plain)
        torch.cuda.empty_cache()
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib, lib_dev = time_ms(sdpa), device_ms(sdpa, bound)
        say(f"    {name}: {ms:.4f} / {plain_ms:.4f} / {lib:.4f} / "
            f"{bound:.4f} ({by}; {flops / on_card / 1e9:.1f} TFLOP/s on the "
            f"device); device {on_card:.4f}, SDPA device {lib_dev:.4f} "
            f"(kernel / SDPA {on_card / lib_dev:.2f}x)")
        out.append(dict(shape=name, max_abs_err=err, ms=ms,
                        device_ms=on_card, plain_ms=plain_ms,
                        library_ms=lib, library_device_ms=lib_dev,
                        bound_ms=bound, bound_by=by))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    state["vlm_flash"] = out
    say(f"flash backward kernels at the training shape (a GQA group of "
        f"{h // kh}: dK and dV summed over {h // kh} query heads):")
    flash_grad_case(state, "vlm_flash_bwd", f"flash grad B{VLM_TRAIN_B} "
                    f"T{TRAIN_T} H{h} Kh{kh} hd{hd} causal bf16",
                    VLM_TRAIN_B, TRAIN_T, h, kh, hd, dict(causal=True),
                    torch.bfloat16, g)


def _vlm_inputs(cfg, b, t, dev, seed):
    """(text tokens (b, t) int64, image embeddings (b, n_img, vit_dim)
    fp32 at 0.3 x N(0, 1), the launcher's scale) from a seed."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(3, cfg.vocab, (b, t), generator=gen)
    img = torch.randn((b, cfg.n_img_tokens, cfg.vit_dim), generator=gen) \
        * 0.3
    return tokens.to(dev), img.to(dev)


def _vlm_p1(model, dcfg, params, x, img, label, plant=False):
    """Prefill over the images and x (B, p + 1) against prefill over the
    images and x[:, :p] into a cache of capacity n_img + p + 1 and one
    decode of x[:, p] at position n_img + p.  Returns (want logits, got
    logits, launch counts of the long prefill and of the decode step, and
    with `plant` the logits of the same decode at position p, the
    reference launcher's, from a copy of the cache)."""
    from repro_torch.core.serving import pages as PG
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train import serve as SV
    b, t = x.shape
    n_img = model.cfg.n_img_tokens
    shape = ShapeConfig("p", n_img + t, b, "prefill")
    at = lambda p: torch.full((b,), p, dtype=torch.int64,  # noqa: E731
                              device=x.device)
    with torch.inference_mode():
        _reset_counts()
        want, full = model.prefill_local(
            params, {"tokens": x, "img_embeds": img}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        counts = dict(prefill=_train_counts())
        del full
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :-1], "img_embeds": img}, dcfg,
            SV.alloc_cache(model, shape, dcfg, x.device))
        planted = None
        if plant:
            bad = PG.kv_map(torch.clone, cache)
            planted, _ = model.decode_local(params, bad, x[:, -1], at(t - 1),
                                            dcfg)
            del bad
        _reset_counts()
        got, cache = model.decode_local(params, cache, x[:, -1],
                                        at(n_img + t - 1), dcfg)
        counts["decode"] = _train_counts()
    top2 = want.float().topk(2, dim=-1).values
    say(f"  {label}: logits RMS {want.float().pow(2).mean().sqrt().item():.4e}"
        f", max|logit| {want.abs().max().item():.4f}, max abs err "
        f"{max_err(got, want):.4e}, top-2 gaps "
        f"{[round(v, 5) for v in (top2[:, 0] - top2[:, 1]).tolist()]}, "
        f"argmax {want.argmax(-1).tolist()} vs {got.argmax(-1).tolist()}")
    return want, got, counts, planted


def _check_vlm_serve_counts(counts, model, what, route, prefills=0,
                            decodes=0):
    """rmsnorm and flash's `route` ("flash" or "flash_f32") launched for
    `prefills` prefills and `decodes` decode steps, and no other kernel: 2
    norms a layer and the final norm a call, one flash forward a layer a
    prefill, none in a decode step."""
    layers = model.cfg.n_layers
    want = {"rmsnorm": (prefills + decodes) * (2 * layers + 1),
            route: prefills * layers}
    got = {k: counts[k] for k in want}
    off = [k for k, v in counts.items()
           if v and k not in (*want, *COLLECTIVES)]
    if got != want or off:
        raise AssertionError(f"{what}: launches {counts}, want {want} and "
                             "no other kernel")


def phase_vlm_smoke(state):
    """internvl2-26b SMOKE in fp32 with the same numpy-seeded weights on the
    card and on the CPU: the loss and every gradient (the projector's
    included) of one loss step at seq 40 (8 image positions + 32 text
    tokens) on the vanilla and the prefetch stack; prefill of 8 images +
    20 text tokens and 3 decode steps from position 8 + 17, logits and
    cache; on the card, the p+1 check at p = 19 with the reference
    launcher's decode position planted; all at TOL32, on flash's fp32
    routes."""
    from repro_torch.core.api import parallelize
    from repro_torch.core.dist import DistConfig, single_device_config
    from repro_torch.core.meta import named_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticC4, \
        adapt_batch
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.train import serve as SV
    cfg, model = get_arch(VLM, smoke=True)
    n_img = cfg.n_img_tokens
    tree = _numpy_params(model, single_device_config(
        param_dtype=torch.float32), seed=0)
    b, t = 2, 40
    shape = ShapeConfig("t", t, b, "train")
    batch = adapt_batch(SyntheticC4(DataConfig(
        vocab=cfg.vocab, seq_len=t, global_batch=b, seed=0)).batch(0),
        model.input_specs(shape, DistConfig()), 0)
    off = ("flash", "flash_bwd", "ssd", "ssd_f32", "ssd_bwd", "ssd_bwd_f32")
    for reorder in (False, True):
        label = "prefetch" if reorder else "vanilla"
        dcfg = DistConfig(param_dtype=torch.float32, reorder=reorder)
        runs = {}
        for dev in ("cpu", "cuda"):
            par = parallelize(model, dcfg, shape, device=dev)
            storage = _storage_from_full(model, dcfg, tree, dev)
            _reset_counts()
            loss, grads = par.loss_step()(storage, batch)
            runs[dev] = (loss, grads, _train_counts())
        counts = runs["cuda"][2]
        say(f"  vlm smoke {label} loss step: launches on the card {counts}")
        if min(counts[k] for k in ("rmsnorm", "flash_f32", "flash_bwd_f32",
                                   "xent_fwd", "xent_bwd")) <= 0 \
                or any(counts[k] for k in off):
            raise AssertionError(f"vlm smoke {label}: launches {counts}")
        if max(v for k, v in runs["cpu"][2].items()
               if k not in COLLECTIVES) > 0:
            raise AssertionError("the CPU loss step launched a kernel")
        check_close(f"vlm smoke {label} loss cuda vs cpu",
                    runs["cuda"][0].cpu(), runs["cpu"][0], TOL32)
        errs = []
        for (n, a), (_, b_) in zip(named_leaves(runs["cuda"][1]),
                                   named_leaves(runs["cpu"][1])):
            if n.startswith("proj_") and not float(b_.abs().max()) > 0:
                raise AssertionError(f"vlm smoke: zero gradient {n}")
            errs.append(check_close(f"vlm smoke {label} grad {n}", a.cpu(),
                                    b_, TOL32))
        say(f"  vlm smoke {label}: loss {float(runs['cuda'][0]):.6f}, "
            f"{len(errs)} gradient leaves, max abs err {max(errs):.3e}")

    prompt, gen = 17, 3
    t_len = prompt + gen
    cell = n_img + t_len
    dcfg = single_device_config(param_dtype=torch.float32)
    x, img = _vlm_inputs(cfg, 2, t_len, "cpu", seed=1)
    x[:, prompt:] = 3                     # padded as the launchers pad
    runs = {}
    for dev in ("cpu", "cuda"):
        params = SV.serve_params_from_jax(tree, model, dcfg, device=dev)
        pf = SV.make_prefill_step(model, dcfg,
                                  ShapeConfig("p", cell, 2, "prefill"))
        dec = SV.make_decode_step(model, dcfg,
                                  ShapeConfig("d", cell, 2, "decode"))
        _reset_counts()
        logits, cache = pf(params, {"tokens": x.to(dev),
                                    "img_embeds": img.to(dev)})
        runs[dev] = dict(params=params, dec=dec, cache=cache,
                         logits=[logits.cpu()], prefill=_train_counts())
    _check_vlm_serve_counts(runs["cuda"]["prefill"], model,
                            "the card's fp32 prefill", "flash_f32",
                            prefills=1)
    check_close("vlm smoke prefill logits cuda vs cpu",
                runs["cuda"]["logits"][0], runs["cpu"]["logits"][0], TOL32)

    def caches(what):
        for name, a, b_ in zip("kv", runs["cuda"]["cache"],
                               runs["cpu"]["cache"]):
            check_close(f"{what} {name} cuda vs cpu", a.cpu(), b_, TOL32)
    caches("vlm smoke prefill")
    for i in range(3):
        tok = runs["cpu"]["logits"][-1].argmax(-1)
        if not torch.equal(runs["cuda"]["logits"][-1].argmax(-1), tok):
            raise AssertionError(f"vlm: greedy tokens differ at {i}")
        pos = torch.full((2,), n_img + prompt + i, dtype=torch.int64)
        for dev, r in runs.items():
            logits, r["cache"] = r["dec"](r["params"], r["cache"],
                                          tok.to(dev), pos.to(dev))
            r["logits"].append(logits.cpu())
        check_close(f"vlm smoke decode {i} logits cuda vs cpu",
                    runs["cuda"]["logits"][-1], runs["cpu"]["logits"][-1],
                    TOL32)
        caches(f"vlm smoke decode {i}")
    params = runs["cuda"]["params"]
    xc, ic = _vlm_inputs(cfg, 2, t_len, "cuda", seed=2)
    want, got, per_call, planted = _vlm_p1(
        model, dcfg, params, xc, ic, f"vlm smoke p+1 at p {t_len - 1}",
        plant=True)
    check_close("vlm smoke: prefill vs prefill + decode", got, want, TOL32)
    check_rejects("vlm smoke p+1 planted: the decode at p, the reference "
                  "launcher's position", planted, want, TOL32)
    _check_vlm_serve_counts(per_call["decode"], model,
                            "an fp32 decode step", "flash_f32", decodes=1)
    state["vlm_smoke_launches"] = runs["cuda"]["prefill"]


def phase_full_vlm_train(state):
    """internvl2-26b at every published width, VLM_TRAIN_LAYERS of its 48
    layers, B 2 at seq 2048 (1025 image positions + 1023 text tokens),
    bf16 compute, fp32 storage, remat fsdp_only, block buckets, through
    `parallelize(...).train_step` on the vanilla stack and on the prefetch
    stack (bf16 wire): `_full_train`'s readings with MFU on `_model_flops`
    (the projector over the image positions only), the memory plan's
    modeled peak (H100 profile) beside the measured, and launches a step:
    flash forward one a layer on the vanilla stack and two on the prefetch
    stack, which recomputes each layer in its backward; one flash backward
    a layer; rmsnorm 2 a layer (+ their recompute) + the final norm; xent
    1 + 1; AdamW one a storage leaf."""
    import dataclasses
    from repro_torch.core.dist import DistConfig
    from repro_torch.core.memory import plan_memory
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build_model, get_arch
    cfg, _ = get_arch(VLM)
    shape = ShapeConfig("train", TRAIN_T, VLM_TRAIN_B, "train")
    for layers in (VLM_TRAIN_LAYERS, 8):
        mem = plan_memory(build_model(dataclasses.replace(
            cfg, n_layers=layers)), DistConfig(), shape)
        say(f"  memory plan at {layers} of {cfg.n_layers} layers, B"
            f"{VLM_TRAIN_B} seq {TRAIN_T} (H100 profile): modeled peak "
            f"{mem.peak / 2**30:.2f} GiB")
    for reorder, key in ((False, "train_vlm"), (True, "train_vlm_prefetch")):
        par, storage, opt = _full_train(state, key,
                                        DistConfig(reorder=reorder),
                                        arch=VLM, layers=VLM_TRAIN_LAYERS,
                                        batch=VLM_TRAIN_B)
        del storage, opt
        torch.cuda.empty_cache()
        model, r = par.model, state[key]
        counts = state[f"{key}_launches"]
        times = 2 if reorder else 1
        layers = model.cfg.n_layers
        want = dict(flash=times * layers, flash_bwd=layers,
                    rmsnorm=times * 2 * layers + 1, xent_fwd=1, xent_bwd=1,
                    adamw=len(list(_leaves(model.metas(par.dcfg)))))
        per_step = {k: counts[k] / TRAIN_STEPS for k in want}
        say(f"  launches a step {per_step} (want {want})")
        if per_step != want:
            raise AssertionError(f"launches a step {per_step}, want {want}")
        mem = par.plan.memory
        say(f"  {cfg.name} x{layers} layers: "
            f"{model.cfg.n_params() / 1e9:.4f}B params; modeled peak "
            f"{mem.peak / 2**30:.2f} GiB ({mem.describe()}) against "
            f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} "
            f"GiB (modeled / measured "
            f"{mem.peak / r['max_memory_allocated']:.3f})")
        for b_ in mem.breakdown:
            say(f"    {b_.describe()}")
        r.update(modeled_peak=mem.peak, layers=layers,
                 model_tflop=_model_flops(model.cfg, model, VLM_TRAIN_B,
                                          TRAIN_T) / 1e12)


def phase_full_vlm_serve(state):
    """internvl2-26b served at its published depth: bf16 weights made on
    the card layer by layer, B 4, 1025 seeded image embeddings and a
    2000-token prompt padded to 2064 text tokens (a cell of 3089
    positions), 64 generated tokens through `repro_torch.launch.serve`,
    decode from position 1025 + 2000: prefill ms, decode ms/token beside
    its byte bound, the device time of a decode step, peak memory, launch
    counts (`_check_vlm_serve_counts`); then the p+1 check at p = 2063
    over the same images, in bf16 on all 48 layers
    (VLM_BF16_CONSISTENCY_REL of the logits' RMS, the argmax where the
    top-2 gap is clear; the decode at p, the reference launcher's
    position, planted, must fail it) and on the first VLM_F32_LAYERS
    layers widened to fp32 at TOL32."""
    import dataclasses
    from repro_torch.core.dist import single_device_config
    from repro_torch.core.meta import tree_map
    from repro_torch.launch import serve as launch
    from repro_torch.models.registry import build_model
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        VLM, False, B, PROMPT, GEN, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n_img = cfg.n_img_tokens
    cell = n_img + T
    n = sum(a.numel() for a in _leaves(params))
    wbytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    say(f"{cfg.name} bf16, {cfg.n_layers} layers: {n / 1e9:.3f}B params, "
        f"{wbytes / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    padded = launch.make_prompts(cfg, B, PROMPT, GEN, dev)
    img = launch.make_img_embeds(model, dcfg, B, cell, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens, t = launch.generate(params, prefill, decode, padded, PROMPT, GEN,
                                img_embeds=img)
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads the blocks' weights, the final norm, the head and
    # B rows of the embedding (the projector runs in the prefill only);
    # the keys and values up to its position; it writes one key and value
    # a row and layer (2 bytes an element)
    it = 2
    dec_w = sum(a.numel() for a in _leaves(params["blocks"])) \
        + cfg.d_model + params["head"].numel() + B * cfg.d_model
    kv_row = cfg.n_layers * B * cfg.n_kv_heads * cfg.head_dim * 2
    step_bytes = it * (dec_w + kv_row * (n_img + PROMPT + 1) + kv_row)
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    say(f"serve B={B} images={n_img} prompt={PROMPT} gen={GEN} cell={cell}:"
        f" prefill {t['prefill_s'] * 1e3:.2f} ms (warm-up "
        f"{t['prefill_warmup_s'] * 1e3:.2f}), decode "
        f"{t['decode_step_s'] * 1e3:.3f} ms/token (warm-up "
        f"{t['decode_warmup_s'] * 1e3:.2f}), {t['decode_tok_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"  decode byte bound {bound:.4f} ms/token ({step_bytes / 1e9:.4f} "
        f"GB a step at position {n_img + PROMPT})")
    say(f"launches in the serve run (2 prefills, {GEN - 1} decode steps): "
        f"{counts}")
    state["serve_vlm_launches"] = counts
    if tokens.shape != (B, GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(tokens.shape)}")
    _check_vlm_serve_counts(counts, model, "the serve run", "flash",
                            prefills=2, decodes=GEN - 1)
    batch = {"tokens": padded, "img_embeds": img}
    logits, cache = prefill(params, batch)
    _profile("prefill", lambda: prefill(params, batch), 1)
    pos = torch.full((B,), n_img + PROMPT, dtype=torch.int64, device=dev)
    busy, dev_s = _profile("decode step", lambda: decode(
        params, cache, logits.argmax(-1), pos), 8, top=12)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    state["serve_vlm"] = dict(
        t, max_memory_allocated=peak, decode_bound_ms=bound,
        decode_device_ms=None if dev_s is None else dev_s * 1e3,
        decode_busy=busy)
    del cache, logits

    x, im = _vlm_inputs(cfg, B, T, dev, seed=3)
    want, got, per_call, planted = _vlm_p1(
        model, dcfg, params, x, im, f"bf16, {cfg.n_layers} layers, p "
        f"{T - 1} after {n_img} image positions", plant=True)
    _check_vlm_serve_counts(per_call["prefill"], model, "one prefill",
                            "flash", prefills=1)
    _check_vlm_serve_counts(per_call["decode"], model, "one decode step",
                            "flash", decodes=1)
    rms = want.float().pow(2).mean().sqrt().item()
    err = max_err(got, want)
    rel, planted_rel = err / rms, max_err(planted, want) / rms
    say(f"  bf16 p+1: max abs err {err:.4e} = {rel:.4e} x the logits' RMS "
        f"(limit {VLM_BF16_CONSISTENCY_REL:g}); planted (the decode at p "
        f"{T - 1}, the reference launcher's position) {planted_rel:.4e}")
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    say(f"  bf16: argmax equal {same.tolist()}, top-2 gap above 2 x "
        f"{err:.3e} {clear.tolist()}")
    # the first layers, in bf16 and widened to fp32: in fp32 the two paths
    # must agree to fp32 rounding, which separates a fault from bf16 noise
    kept = {k: v for k, v in params.items() if k != "blocks"}
    kept["blocks"] = tree_map(lambda a: a[:VLM_F32_LAYERS].clone(),
                              params["blocks"])
    del params
    torch.cuda.empty_cache()
    short = build_model(dataclasses.replace(cfg, n_layers=VLM_F32_LAYERS))
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        runs[dt] = _vlm_p1(short, single_device_config(param_dtype=dt),
                           tree_map(lambda a: a.to(dt), kept), x, im,
                           f"{str(dt)[6:]}, the first {VLM_F32_LAYERS} "
                           "layers")
        torch.cuda.empty_cache()
    del kept
    want32, got32, per32, _ = runs[torch.float32]
    say(f"  bf16 prefill vs fp32 prefill, the first {VLM_F32_LAYERS} "
        f"layers, same weights: max abs err "
        f"{max_err(runs[torch.bfloat16][0], want32):.4e} (for scale, not a "
        "limit)")
    state["vlm_consistency"] = dict(
        bf16_rel=rel, planted_rel=planted_rel, fp32=max_err(got32, want32),
        bf16_vs_fp32_short=max_err(runs[torch.bfloat16][0], want32))
    _check_vlm_serve_counts(per32["prefill"], short, "one fp32 prefill",
                            "flash_f32", prefills=1)
    check_close(f"fp32 ({VLM_F32_LAYERS} layers): prefill vs prefill + "
                "decode", got32, want32, TOL32)
    if not torch.equal(got32.argmax(-1), want32.argmax(-1)):
        raise AssertionError("fp32: argmax differs")
    if rel > VLM_BF16_CONSISTENCY_REL:
        raise AssertionError("bf16: prefill vs prefill + decode")
    if planted_rel <= VLM_BF16_CONSISTENCY_REL:
        raise AssertionError("the planted fault (the decode at the "
                             "reference launcher's position) passed the "
                             "bf16 limit")
    if not bool(same[clear].all()):
        raise AssertionError("bf16: argmax differs where the gap is clear")


# kernel families summed in every profiler window
FAMILIES = {"quant codec (seed + quant + dequant kernels)":
            ("quant_kernel", "seed_kernel", "dequant_kernel"),
            "NCCL collectives": ("nccl",)}
# the codec's kernels by variant: quant_kernel<T, codec, SR?> (SR: the
# gradients, after seed_kernel<T>; RTN: the gathered weights and the
# error-feedback hop), dequant_kernel<out T>; codec 0 = fp8, 1 = int8
CODEC_VARIANT = r"((?:seed|quant|dequant)_kernel<[^>]*>)"


def _cuda_profiler():
    """torch.profiler recording device activity only: the host-side op
    records would cost each of a step's millions of ops host time."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _report(label, prof, wall, n, top=8, launches=None):
    """Prints the device kernel time of `prof`'s window against its wall
    time over n calls, the `top` kernels that take most of it, the FAMILIES
    and the codec variants: the kineto events summed by name as they come
    (`key_averages()` takes minutes over a million ops).  `launches`, a
    dict, gets each kernel name's count in the window.  Returns (the device
    busy share of the window, device seconds per call), or (None, None)
    when the profiler saw no kernels."""
    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    rows = {}                           # name -> [ns, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            r = rows.setdefault(e.name(), [0, 0])
            r[0] += e.duration_ns()
            r[1] += 1
    read_s = time.perf_counter() - t0
    if launches is not None:
        launches.update({k: c for k, (_, c) in rows.items()})
    if not rows:
        say(f"{label}: device time not measured (the profiler saw no "
            f"kernels); wall {wall / n * 1e3:.3f} ms per call")
        return None, None
    dev_s = sum(ns for ns, _ in rows.values()) / 1e9
    say(f"{label}: wall {wall / n * 1e3:.3f} ms, device kernels "
        f"{dev_s / n * 1e3:.3f} ms per call ({100 * dev_s / wall:.1f}% busy),"
        f" {sum(c for _, c in rows.values()) / n:.0f} device ops per call "
        f"(the events read in {read_s:.1f} s)")
    for name, (ns, c) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"    {ns / n / 1e6:9.3f} ms {c // n:7d}x  {name[:90]}")
    for family, keys in FAMILIES.items():
        fam = [r for k, r in rows.items() if any(s in k for s in keys)]
        if fam:
            say(f"  {family}: {sum(ns for ns, _ in fam) / n / 1e6:.3f} ms, "
                f"{sum(c for _, c in fam) // n} kernels per call")
    for name, (ns, c) in sorted(rows.items()):
        m = re.search(CODEC_VARIANT, name)
        if m:
            say(f"    {m.group(1)}: {ns / n / 1e6:.3f} ms in {c // n} "
                f"launches, {ns / c / 1e6:.4f} ms each")
    return dev_s / wall, dev_s / n


def _profile(label, fn, n, top=8):
    """One warm-up call of fn, then n calls under the profiler
    (`_report`)."""
    fn()
    torch.cuda.synchronize()
    with _cuda_profiler() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _report(label, prof, wall, n, top)


def _named(tree, prefix=""):
    """(name, leaf) of a nested dict, names joined with '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernels_line(state):
    """One row per ported kernel.  `launches` counts the run of the path
    that brought the kernel in: the full-width quantized qwen3 training
    (fp8_ef, the prefetch stack) for the first seven, which it runs all,
    and the full-width zamba2 training for the ssd rows; `launches_by_path`
    adds the serving run's, the bf16 qwen3 training runs' (vanilla,
    prefetch, auto-planned, mixed precision, observability), the smoke
    replan's, the zamba2 run's, the moe runs' (qwen3-moe and qwen2-moe
    training, qwen3-moe serving), the gemma2 runs' (training, serving)
    and the paged-serving runs' counts (`serve_paged`: the paged steps of
    llama3-8b's three caches; `serve_batcher`: the batcher's paged steps;
    `serve_paged_smoke`: the SMOKE cases' paged steps on the card; each
    without the dense steps it is compared with), the zamba2-1.2b serve
    run's (`serve_zamba2`: two prefills and 63 decode steps) and the
    xlstm-1.3b runs' (`train_xlstm`: 2 timed steps at 48 layers;
    `serve_xlstm`: two prefills and 63 decode steps; xlstm launches
    rmsnorm, xent and AdamW and no other kernel) and the
    seamless-m4t-large-v2 runs' (`train_encdec`, `train_encdec_prefetch`:
    6 timed steps at 48 layers on each stack; `serve_encdec`: two prefills
    and 63 decode steps; the fp32 routes' `encdec_smoke_prefill_f32`: the
    SMOKE prefill on the card); the flash
    row carries
    its readings at qwen3-moe's group-8
    shape (`group8`) and at gemma2's four shapes (`gemma2`), the
    flash_attention_bwd row (the backward alone, at qwen3's layer shape;
    `fwd_bwd` the gradient's forward + backward) its readings at the group-8
    shape and gemma2's local layer, the adamw row at the moe path's largest
    leaf (`moe_leaf`), at gemma2's embedding (`gemma2_leaf`), at
    xlstm's (`xlstm_leaf`) and at seamless-m4t-large-v2's
    (`encdec_leaf`) and at internvl2-26b's embedding (`vlm_leaf`), the
    rmsnorm and xent rows at gemma2's shapes (`gemma2`), at xlstm's
    (`xlstm`), at seamless-m4t-large-v2's (`encdec`) and at internvl2-26b's
    (`vlm`: xent with the image rows masked), which the flash rows also
    carry (encdec: its three forward shapes, its two backward ones; vlm:
    the training and prefill forwards at a GQA group of 6, the training
    backward).  `launches_by_path` also holds the internvl2-26b runs'
    (`train_vlm`, `train_vlm_prefetch`: 6 timed steps at 6 of 48 layers
    on each stack; `serve_vlm`: two prefills and 63 decode steps at 48
    layers; the fp32 routes' `vlm_smoke_prefill_f32`: the SMOKE prefill on
    the card).
    flash_attention_f32, flash_attention_bwd_f32, ssd_fwd_f32 and
    ssd_bwd_f32 are the fp32 routes: no bf16 path runs them (their count is
    0 on each, and each path asserts so); `launches_by_path` adds the fp32
    smoke training runs' counts and, for the ssd rows, the fp32 zamba2
    serve smoke prefill's (`zamba2_serve_smoke_f32`).  A count is one call of the kernel's
    wrapper: the ssd forward is two launches a call, its backward three, an
    SR quant call two (the seed pass and the quant kernel)."""
    src = "src/repro_torch/csrc/"
    main, train, prefetch, serve, zamba = (
        state["train_fp8_ef_launches"], state["train_launches"],
        state["train_prefetch_launches"], state["launches"],
        state["train_zamba2_launches"])

    def row(name, key, source, replaces, serve_key=None, home=main,
            **extra):
        by_path = dict(train=train[key], train_prefetch=prefetch[key],
                       train_fp8_ef=main[key], train_zamba2=zamba[key],
                       train_auto=state["train_auto_launches"][key],
                       train_mixed=state["train_mixed_launches"][key],
                       train_obs=state["train_obs_launches"][key],
                       smoke_replan=state["smoke_replan_launches"][key],
                       train_qwen3_moe=state[
                           "train_qwen3_moe_30b_a3b_launches"][key],
                       train_qwen2_moe=state[
                           "train_qwen2_moe_a2_7b_launches"][key],
                       train_gemma2=state["train_gemma2_27b_launches"][key],
                       train_xlstm=state["train_xlstm_1_3b_launches"][key],
                       train_encdec=state["train_encdec_launches"][key],
                       train_encdec_prefetch=state[
                           "train_encdec_prefetch_launches"][key],
                       train_vlm=state["train_vlm_launches"][key],
                       train_vlm_prefetch=state[
                           "train_vlm_prefetch_launches"][key])
        for path in ("serve_paged", "serve_batcher", "serve_paged_smoke",
                     "serve_zamba2", "serve_xlstm", "serve_encdec",
                     "serve_vlm"):
            by_path[path] = state[f"{path}_launches"][key]
        if serve_key:
            by_path["serve"] = serve[serve_key]
            by_path["serve_qwen3_moe"] = state["serve_moe_launches"][
                serve_key]
            by_path["serve_gemma2"] = state["serve_gemma2_launches"][
                serve_key]
        if key in ("flash_f32", "flash_bwd_f32"):
            by_path["smoke_train_f32"] = state["smoke_train_launches"][key]
            by_path["encdec_smoke_prefill_f32"] = state[
                "encdec_smoke_launches"][key]
            by_path["vlm_smoke_prefill_f32"] = state[
                "vlm_smoke_launches"][key]
        if key.startswith("ssd"):
            by_path["zamba2_smoke_f32"] = state["zamba_smoke_launches"][key]
            by_path["zamba2_serve_smoke_f32"] = state[
                "zamba_serve_smoke_launches"][key]
        return dict(name=name, route="cuda", source=src + source,
                    replaces="src/repro/kernels/" + replaces,
                    launches=home[key], **state[key],
                    launches_by_path=by_path, **extra)

    rows = [
        row("rmsnorm", "rmsnorm", "rmsnorm.cu", "rmsnorm/kernel.py:29",
            "rmsnorm", gemma2=state["gemma2_rmsnorm"],
            xlstm=state["xlstm_rmsnorm"], encdec=state["encdec_rmsnorm"],
            vlm=state["vlm_rmsnorm"]),
        row("flash_attention", "flash", "flash_attention_sm90.cu",
            "flash_attention/kernel.py:77", "flash",
            group8=state["flash_group8"], gemma2=state["gemma2_flash"],
            encdec=state["encdec_flash"], vlm=state["vlm_flash"]),
        # fp32 inputs only: the card-vs-CPU checks, off every bf16 path
        row("flash_attention_f32", "flash_f32", "flash_attention.cu",
            "flash_attention/kernel.py:77", "flash_f32",
            kernel="flash_fwd_tf32_kernel: mma.sync m16n8k8 TF32, "
                   "hi*hi + hi*lo + lo*hi"),
        row("flash_attention_bwd", "flash_bwd", "flash_attention_bwd_sm90.cu",
            "flash_attention/ops.py:62", "flash_bwd",
            group8=state["flash_bwd_group8"],
            gemma2=state["flash_bwd_gemma2"],
            encdec=[state["encdec_flash_bwd_non-causal"],
                    state["encdec_flash_bwd_causal"]],
            vlm=state["vlm_flash_bwd"],
            kernel="flash_bwd_prep_sm90_kernel (lse, D), then one pass "
                   "flash_bwd_sm90_kernel (S^T, dP^T once a pair; dK, dV; "
                   "dQ partials summed in a fixed order by bulk reduce), "
                   "then flash_bwd_dq_sm90_kernel (dq): wgmma, TMA"),
        # fp32 inputs only: the card-vs-CPU checks, off every bf16 path
        row("flash_attention_bwd_f32", "flash_bwd_f32", "flash_attention.cu",
            "flash_attention/ops.py:62", "flash_bwd_f32",
            kernel="flash_bwd_dq_tf32_kernel, then "
                   "flash_bwd_dkdv_tf32_kernel: mma.sync m16n8k8 TF32 x3"),
        row("xent_fwd", "xent_fwd", "cross_entropy.cu",
            "cross_entropy/kernel.py:61", gemma2=state["gemma2_xent_fwd"],
            xlstm=state["xlstm_xent_fwd"], encdec=state["encdec_xent_fwd"],
            vlm=state["vlm_xent_fwd"]),
        row("xent_bwd", "xent_bwd", "cross_entropy.cu",
            "cross_entropy/kernel.py:96", gemma2=state["gemma2_xent_bwd"],
            xlstm=state["xlstm_xent_bwd"], encdec=state["encdec_xent_bwd"],
            vlm=state["vlm_xent_bwd"]),
        row("adamw_flat", "adamw", "adamw.cu", "adamw/kernel.py:40",
            moe_leaf=state["adamw_moe_leaf"],
            gemma2_leaf=state["gemma2_adamw_leaf"],
            xlstm_leaf=state["xlstm_adamw_leaf"],
            encdec_leaf=state["encdec_adamw_leaf"],
            vlm_leaf=state["vlm_adamw_leaf"]),
        row("quant_fwd", "quant_fwd", "quant.cu", "quant/kernel.py:46",
            kernel="quant_kernel (RTN); seed_kernel + quant_kernel (SR)"),
        row("dequant_fwd", "dequant_fwd", "quant.cu", "quant/kernel.py:78"),
        row("ssd_fwd", "ssd", "ssd_sm90.cu", "ssd/kernel.py:65", home=zamba),
        row("ssd_bwd", "ssd_bwd", "ssd_bwd_sm90.cu", "ssd/ops.py:57",
            home=zamba,
            kernel="chunk_scan_kernel (reverse state scan, ssd_sm90.cu), "
                   "ssd_grad_sm90_kernel (wgmma; one block per (b, chunk, "
                   "16 heads); dB, dC from the heads' dCB sum), "
                   "group_sum_kernel"),
        # fp32 inputs only: the card-vs-CPU checks, off every bf16 path
        row("ssd_fwd_f32", "ssd_f32", "ssd_sm90.cu", "ssd/kernel.py:65",
            home=zamba,
            kernel="chunk_scan_kernel, then chunk_out_kernel: mma.sync "
                   "m16n8k8 TF32, hi*hi + hi*lo + lo*hi"),
        row("ssd_bwd_f32", "ssd_bwd_f32", "ssd_sm90.cu", "ssd/ops.py:57",
            home=zamba,
            kernel="chunk_scan_kernel (TF32 x3), chunk_grad_kernel (fp32 "
                   "FMAs), group_sum_kernel"),
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
                        ("training kernels vs plain", phase_train_kernels),
                        ("quant kernels vs plain", phase_quant_kernels),
                        ("quantized reduce-scatter cuda vs cpu",
                         phase_quant_grad_bucket),
                        ("smoke cuda vs cpu", phase_smoke_parity),
                        ("smoke training cuda vs cpu", phase_smoke_train),
                        ("smoke quantized training cuda vs cpu",
                         phase_smoke_quant_train),
                        ("ssd kernel vs plain", phase_ssd_kernels),
                        ("zamba2 smoke training cuda vs cpu",
                         phase_zamba_smoke_train),
                        ("full-width serve", phase_full_width),
                        ("full-width training", phase_full_train),
                        ("full-width prefetch training",
                         phase_full_prefetch_train),
                        ("full-width quantized training",
                         phase_full_quant_train),
                        ("full-width zamba2 training",
                         phase_full_zamba_train),
                        ("full-width auto-planned training",
                         phase_full_auto_train),
                        ("full-width mixed-precision training",
                         phase_full_mixed_train),
                        ("planner lines", phase_planner_lines),
                        ("full-width observability", phase_full_obs),
                        ("smoke replan on the card", phase_smoke_replan),
                        ("moe kernels vs plain", phase_moe_kernels),
                        ("moe smoke cuda vs cpu", phase_moe_smoke),
                        ("full-width qwen3-moe-30b-a3b training",
                         phase_full_moe_train),
                        ("full-width qwen2-moe-a2.7b training",
                         phase_full_qwen2_moe_train),
                        ("full-width qwen3-moe-30b-a3b serve",
                         phase_full_moe_serve),
                        ("gemma2 kernels vs plain", phase_gemma2_kernels),
                        ("gemma2 smoke cuda vs cpu", phase_gemma2_smoke),
                        ("full-width gemma2-27b training",
                         phase_full_gemma2_train),
                        ("full-width gemma2-27b serve",
                         phase_full_gemma2_serve),
                        ("paged serving smoke cuda vs cpu",
                         phase_paged_smoke),
                        ("full-width paged serve: llama3-8b",
                         phase_full_paged_serve),
                        ("zamba2 serve smoke cuda vs cpu",
                         phase_zamba_serve_smoke),
                        ("full-width zamba2-1.2b serve",
                         phase_full_zamba_serve),
                        ("xlstm kernels vs plain", phase_xlstm_kernels),
                        ("xlstm smoke cuda vs cpu", phase_xlstm_smoke),
                        ("full-width xlstm-1.3b training",
                         phase_full_xlstm_train),
                        ("full-width xlstm-1.3b serve",
                         phase_full_xlstm_serve),
                        ("encdec kernels vs plain", phase_encdec_kernels),
                        ("encdec smoke cuda vs cpu", phase_encdec_smoke),
                        ("full-width seamless-m4t-large-v2 training",
                         phase_full_encdec_train),
                        ("full-width seamless-m4t-large-v2 serve",
                         phase_full_encdec_serve),
                        ("vlm kernels vs plain", phase_vlm_kernels),
                        ("vlm smoke cuda vs cpu", phase_vlm_smoke),
                        ("full-width internvl2-26b training",
                         phase_full_vlm_train),
                        ("full-width internvl2-26b serve",
                         phase_full_vlm_serve)]:
        say(f"== {name}")
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            say(f"== {name}: FAILED")
        say(f"== {name}: {time.perf_counter() - t0:.1f}s")
        gc.collect()        # a failed phase's frames hold its tensors
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
