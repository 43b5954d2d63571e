#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each one raises, and the script exits non-zero, if it fails):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, five sources, all started together);
2. each kernel against its plain PyTorch version on the card, at the shapes
   the llama3-8b serving and training paths give it: the DiP matmul (M = 4,
   256 and the training batch's 4096; and at M = 4 and 256 the
   deepseek-v2-lite-16b projections, N = 64 included; at M = 1, 4 and 256
   the zamba2-2.7b and mamba2-370m projections through the registry, in_proj's
   padded last tile (10448 and 4384 columns) and out_proj's residual at K =
   5120 included; at M = 4096, the training batch, the DeepSeek, Zamba2,
   Mamba2 and musicgen-medium projections in bf16) and flash attention in float32 and
   bfloat16, each call on the route ``flash_plan`` gives (by the launch
   counts): Zamba2's D = 80 at Sq = 256 (on the tensor cores) and at Sq =
   1 (on ``split_kv``), every tensor-core pair (D = Dv in 32, 48, 64, 80,
   96, 112, 128, the reduced MLA pair (48, 32) and DeepSeek-V2-Lite's (192,
   128)) in both dtypes at Sq = 256 and at Sq = 1, 3, 16 and 64 with kv_len
   0 rows exactly 0, two ``split_kv`` calls equal bit for bit; the fused
   lm_head + cross-entropy in its three dtype pairs (f32 x f32, bf16 x f32
   — the training dtypes — and bf16 x bf16, all on the tensor cores) at
   ragged T with padding-only vocab splits and labels at -100, and bf16 x
   f32 and f32 x f32 at the training heads of the four families of phases
   6b-6e (the tied one a transposed view); then the
   quantized serving slice's kernels:
   the DiP matmul on int8 (exact), the quantized DiP matmul (int8 and fp8
   weights, f32 and bf16 activations, M = 4, 37 and 256; int8 without an
   epilogue bit for bit) and the wavefront kernel over its plans (f32, bf16,
   and int8 exact, M = 1, 4, 13 and 256), at the q, gate+up, down and
   lm_head shapes; the fp8 route on the tensor cores (bf16 x) at M = 1, 4,
   32, 33, 256 and 4096, every epilogue with and without the rmsnorm
   prologue, both plans and K splits, and every e4m3 code upcast exactly;
   the int8 route's quantizing pass (codes and scales byte for byte) and
   the int8 route on the tensor cores at the same M, epilogues, prologues
   and plans (epilogue none bit for bit); the quantized families' projections
   (deepseek-v2-lite-16b's, zamba2-2.7b's and mamba2-370m's, in_proj's
   padded columns included) through the registry in int8 and fp8 at M = 1,
   4 and 256 (int8: the activation codes byte for byte, epilogue none bit
   for bit); fp8 with f32 x (its cast pass to bf16 byte for byte, then the
   e4m3 mainloops with an f32 output) at those projections and with the
   bias epilogues, M = 1, 4 and 256, within f32 TOL, one cast pass and one
   tensor-core product a call; lm_head_ce's bf16 x f32 function with the head cut to two bf16
   parts instead of the kernel's three, and its f32 x f32 function with 3,
   5 and the kernel's 6 bf16 part products, in plain torch (printed: whether
   fewer would hold TOL); and views at storage offsets that
   are not 16-byte aligned, refused by flash, lm_head_ce and dip_matmul_q
   with the CUDA context still usable;
3. the reduced llama3-8b served on the card against the same weights served
   on the CPU (plain versions): identical greedy tokens, close logits — the
   float model on ``dip``, then ``dip_int8w`` with the int8 KV pool,
   ``dip_fp8`` and ``pallas_systolic``; and the reduced
   deepseek-v2-lite-16b (MoE + MLA), zamba2-2.7b (hybrid) and mamba2-370m
   (SSM, tied head) on ``dip``, prompts that take the SSM prefill tail, and
   the same three with ``dip_fp8`` (bf16); the reduced llama3-8b with
   ``dip_fp8`` in f32 compute, held against the plain versions on the card
   (every projection a cast pass and a tensor-core product); the reduced yi-9b and
   codeqwen1.5-7b on ``dip`` in bf16; the reduced phi-3-vision-4.2b and
   musicgen-medium (the stub frontends' decoders) from tokens on ``dip``;
   each variant's flash launches by route printed, none on the CUDA cores
   (head dim 32 and the MLA pair (48, 32) on the tensor cores, f32 and bf16);
4. the reduced llama3-8b trained on the card against the CPU (f32, 3
   ``Trainer`` steps): close losses and gradient norms, and a run stopped by
   ``fail_at_step`` that resumes from its checkpoint and repeats the
   uninterrupted one; the reduced deepseek-v2-lite-16b, qwen3-moe-235b-a22b,
   zamba2-2.7b, mamba2-370m, musicgen-medium and phi-3-vision-4.2b (the last
   two fed the pipeline's embeddings) the same, 3 steps each, with their
   launches; then with int8 and with fp8 weights, the loss and the
   gradient of every float leaf through the quantized straight-through
   backward, card against CPU;
5. llama3-8b at full width (32 layers, d_model 4096, vocab 128256) in bf16
   served through ``Server``, with the kernels' launch counts checked:
   193 DiP-matmul launches per forward, 32 flash launches per prefill chunk,
   all of them on flash's tensor-core routes; one decode step and one prefill
   chunk profiled on their last inputs (device ms by kernel, launches, device
   time against wall time); then quantized through ``launch.serve`` (``--quantize int8 --kv-quant
   int8``, then ``--quantize fp8_e4m3``; the same 4 requests, 16 greedy
   tokens): 193 quantized launches per forward, all on the tensor-core
   route, and no DiP launch; for int8 one quantizing pass per projection;
   one decode step profiled, its dip_matmul_q kernels counted by name (one
   product per projection, one quantizing pass per int8 projection, one
   split-K reduce wherever the plan at the step's M splits); and the
   first prefill chunk's and first decode step's logits held against the
   plain versions on the card on the same inputs; then one request of 256
   prompt tokens through ``pallas_systolic`` (the wavefront kernel), its
   logits held against the ``dip`` backend's on the same weights, and both
   backends' last decode step and prefill chunk profiled;
5d. deepseek-v2-lite-16b at full width (27 layers, MLA, 64 routed experts
   top-6 and 2 shared) in bf16 through ``launch.serve`` (4 slots, max_seq
   1024, prefill chunk 256, 4 requests, 16 greedy tokens): one MLA block and
   one MoE block against their plain versions on the same input (identical
   routing), 163 DiP launches per forward and no flash launch, 497,664 KV
   bytes per block, the first prefill chunk's and decode step's logits
   against the plain versions on the card (the routing choices that differ
   counted), the dropped (token, slot) pairs of the first chunk, wall
   medians, peak memory, and one decode step and prefill chunk profiled;
   then the 541-token request's whole-prompt forward with no cache through
   ``decode_step_fn(cfg, attn_backend="flash")``: 27 flash launches, all on
   the tensor cores at (192, 128), its logits against the dense attention
   core with the expert choices replayed, both profiled;
5e. zamba2-2.7b at full width (54 Mamba2 layers and one shared attention+FFN
   block at 9 call sites) and
5f. mamba2-370m at full width (48 Mamba2 layers, tied head; the launcher's
   first 2 requests), each in bf16
   through ``launch.serve`` as in 5d: layer 0's Mamba2 block (a 256-token
   chunk from zero state, then one decode token: outputs, conv history and
   state) and zamba2's shared block against their plain versions on one
   input, the first prefill chunk's and decode step's logits against the
   plain versions on the card, the prefill run as whole chunks and then the
   tail token by token, 163 / 96 DiP launches per forward and 9 / 0 flash
   launches per prefill call (a chunk's on the tensor cores unsplit, a tail
   token's on ``split_kv``, none on the CUDA cores),
   1,474,560 / 0 KV bytes per block and 72,479,232 / 50,995,200 state bytes
   per slot, peak memory, wall times, and a decode step, a prefill chunk
   and a single-token forward of the tail profiled;
5g. deepseek-v2-lite-16b at full width as in 5d with ``--quantize int8
   --kv-quant int8``: the same gates, 163 dip_matmul_q launches per forward
   (counted from the template) all on the tensor-core route with one
   quantizing pass each and no bf16 DiP launch, 252,288 KV bytes per
   block, the int8 latent rows of the first prefill import byte-identical
   to ``quantize_rows`` on the CPU, weights, peak memory and the captured
   steps against the eager ones;
5h. zamba2-2.7b (``--quantize int8 --kv-quant int8``) and mamba2-370m
   (``--quantize int8``) at full width as in 5e / 5f (the launcher's first
   2 requests): 163 / 96 dip_matmul_q
   launches per forward, flash's routes unchanged, 774,144 / 0 KV bytes
   per block, the state bytes per slot unchanged, the hybrid's first
   import checked as in 5g;
6. llama3-8b at full width cut to 2 layers,
6b. deepseek-v2-lite-16b at full width cut to 2 layers,
6c. zamba2-2.7b cut to 6 of its 54 layers (the shared block at 1 site),
6d. mamba2-370m cut to 24 of its 48 layers (the tied head) and
6e. musicgen-medium cut to 6 of its 48 layers (fed the pipeline's
   embeddings), each trained
   through ``launch.train`` and its ``Trainer`` (f32 parameters, bf16
   compute, block remat, batch 4 x seq 1024, 4 steps, the launcher's
   warm-up schedule) by one function, ``train_family``: the first step's
   loss, gradient norm and every gradient leaf through the kernels against
   plain PyTorch (``torch.matmul``, unfused loss) on the same weights and
   batch in f32 and bf16 compute (the f32 step's lm_head_ce launch, f32 x
   f32 on the tensor cores, printed; DeepSeek's plain run replaying the
   kernels' expert ids; a recurrent stack's bf16 step, where it misses the
   bound, held to no further from the f32 plain run than 1.5x the bf16
   plain run, and its kernels' distance with the unfused loss printed
   beside), the expert ids of the remat rerun against the forward's (0
   differ), exact DiP launches per step (each projection of a forward but
   the head, twice: forward and remat rerun; llama3-8b's 2 x 6 x 2), 1
   lm_head_ce launch per step and no flash launch, every padded DiP leaf's
   padding (Zamba2's and Mamba2's in_proj) and both its AdamW moments
   exactly 0 after the steps, finite losses, step time, tokens/s, peak
   allocated and reserved memory, one more step split into forward,
   backward and AdamW and profiled, and (6c and 6d) a run resumed from the
   step-3 checkpoint whose step 4 repeats the uninterrupted one; after 6, the same
   4 llama3-8b steps through plain PyTorch, printed beside the kernels';
7. kernel times (CUDA events, L2 flushed between launches; ``ms`` with the
   launch queued behind a device sleep, so the wrapper's host time is
   hidden, and ``host_ms`` without, as the first versions timed) beside their bound,
   the plain version's time and one library call's time, the quantized and
   wavefront kernels and the int8 route's quantizing pass included
   (lm_head_ce with the bound of its three (bf16 x) or six (f32 x) bf16
   part products on the tensor cores beside the f32 CUDA-core bound; the DiP matmul also at the
   deepseek-v2-lite-16b projections in bf16, and at the zamba2-2.7b and
   mamba2-370m projections at M = 1, 4 and 256 with flash at D = 80 on its
   planned routes and at D = 128, Sq = 1; a sweep of flash over Sq = 1..256
   at every tensor-core head dim on both tensor-core routes, from which
   ``SPLIT_MAX_SQ`` is read; the wavefront with the f32
   CUDA-core bound beside its bf16 one; the int8 route beside torch._int_mm
   of its codes and beside its whole function in library calls; the fp8
   route with f32 x and its cast pass; flash at (192, 128) beside the
   CUDA-core kernel that ran it before; flash in f32 at D = 32, 80 and 128
   and at (192, 128), at the chunk and at Sq = 1, each beside the CUDA-core
   kernel and bound by six bf16 part products; both quantized routes at the quantized families'
   projections, with their launches per forward; lm_head_ce with bf16 and f32 x at the training
   heads of 6b-6e, the tied head with its contiguous copy of ``embed.t()``,
   timed on its own too);
8. the reliability layer at full width, run where its weights are: 8a and
   8b inside phase 5 on its llama3-8b weights, 8c after 6e.  8a:
   ``api.matmul(..., verify=True)`` at layer 0's shapes, M = 4 and 256 (wq
   on ``dip`` and ``systolic``, the probe; gate+up under swiglu, the
   storage rung; wq quantized on ``dip_int8w`` and ``dip_fp8``): outputs
   bit for bit the unverified calls', clean audits, a flipped storage bit
   flagged, the audit's device ms beside the dispatch's.  8b: the verified
   engine at phase 5's settings: phase 5's prompts give its first 8 tokens
   with a ``ttl_s=0`` request swept and the decode graph's launches
   unchanged; a NaN in a victim's first K block gives one fault and one
   retry with the peer's tokens unchanged; ``max_retries=0`` degrades the
   victim to the captured ``torch``-backend decode step (replayed against
   its eager step and timed); the int8 weights + int8 KV engine's drill
   poisons ``k_scale``.  8c: llama3-8b cut to 2 layers through a guarded
   ``Trainer``, its losses and norms phase 6's bit for bit, the
   fingerprint's device ms; mamba2-370m cut to 24 layers with a NaN planted at
   data step 3: one weight fault, a skipped step, one recovery, finite
   parameters at the step count;
9. the explicit sharded backends and llama3-8b tensor-parallel, run after
   phase 5 (each rank draws phase 5's weights from the same seed and keeps
   its slice), in a 2-rank world sharing the card over the ``host``
   transport (gloo groups, payloads copied through host memory; the steps
   run eagerly, since a gloo collective cannot be captured): 9a ``dip_tp``
   column and row, ``dip_fsdp`` and ``dip_sp`` column and row at llama3-8b's
   gate+up and down, M = 4 and 256, bf16, and ``dip_int8w`` on the tp row,
   each against the single-rank dispatch on the card (the int8 row against
   its shard body byte for byte), the communicator's counts against the
   reference's contract, each rank's launch device ms beside the single-rank
   dispatch's; 9c llama3-8b at full width through ``Server(plan=)`` at phase
   5's settings and its first two requests: first-token logits within FULL_TOL of phase
   5's, the greedy streams beside phase 5's, 66 collectives and 193 DiP
   launches (each a shard) per step and rank, wall and device ms per step,
   peak memory per rank; 9d the reduced llama3-8b in f32 over the 2 ranks
   serving the single-rank engine's tokens exactly; then 9b the 9a calls in
   a 1-rank NCCL world.  9i: llama3-8b sequence-parallel (``sp``) in the
   same world on 9c's rank parameters (``dip_sp`` consumes ``tp``'s column
   and row shards) through ``Server(plan=)`` on 9c's requests, 8 greedy
   tokens each: first-token logits within FULL_TOL of phase 5's, the
   streams printed beside 9c's and phase 5's, 195 collectives (the
   embedding's reduce-scatter, 4 ring hops and 2 reduce-scatters a layer,
   the lm_head's hop and the logits' gather of vocab) and 322 launches a
   step and rank, no replicated weight, walls and device ms, then every
   launch shape against its plain version (the column shards at the rank's
   2 and 128 rows, the row partials at all 4 and 256);
9e. deepseek-v2-lite-16b expert-parallel (``ep``) at full width in a 2-rank
   world sharing the card (``host`` transport), after 5d with its engine
   freed, held to what 5d recorded from its whole weights: (a) each rank
   draws only its slice (``init_params(plan=)``: 32 of the 64 experts a
   layer, the shared experts whole), its layer-0 experts equal to 5d's by
   checksum, the build peak a rank; (b) a (2, 256) forward split by batch
   within FULL_TOL of 5d's logits with 5d's expert choices replayed and its
   dropped pairs equal by layer (the free-routing run's flips printed),
   164 collectives; (c) layer 0's MoE on a (1, 256) chunk split by sequence
   within bf16 TOL of 5d's plain ``moe_ffn`` on each half at
   moe_capacity(128), drops and expert ids equal, 2 all-to-alls, 1 psum, 1
   all-gather, the dispatch before the 2 shared-expert launches; (d)
   ``Engine(plan=)`` serving 5d's first 2 requests, 8 greedy tokens each: per
   step and rank 164 collectives (27 x (2 all-to-alls, 2 all-reduces, 2
   all-gathers) + 2), 163 DiP launches, each dispatch before its
   shared-expert launches, walls, kernel and copy device ms, peak memory;
   first-token logits and greedy streams beside 5d's (printed, not held:
   the sequence split drops other pairs); (e) each launch shape of that
   forward on the rank's own storage against its plain version, with
   device ms beside plain, bound and the library call; (f) the reduced
   deepseek-v2-lite-16b under ``tp`` and the reduced deepseek-v2-lite-16b
   and qwen3-moe-235b-a22b under ``ep`` (capacity factor E / k, no drops)
   in f32 serving the single-rank engines' tokens.  9k, in the same world:
   deepseek-v2-lite-16b under ``fsdp`` at full width cut to its first 2 of
   27 layers (the time budget), each rank drawing its slice from the seed
   (K / 2 of every projection, half of each expert bank's contraction dim
   and of the router's d), ``Engine(plan=)`` with 2 slots on 5d's first
   two requests cut to 256 tokens, 2 greedy tokens each: first-token logits
   within FULL_TOL of the single-rank cut model's prefill step on the same
   seed (its expert choices replayed where a prompt's differ), 28
   all-gathers a prefill call and 29 a decode step, 13 launches a forward,
   the storage bytes a forward gathers, peak memory, then every launch
   shape on the gathered storage against its plain version.
9f-9h. zamba2-2.7b at full width (all 54 layers) in one 2-rank world
   sharing the card (``host`` transport), after 5e with its engine freed,
   each rank drawing only its slice of 5e's weights (``init_params(plan=)``),
   ``Engine(plan=)`` with 2 slots: 9f under ``tp`` on 5e's requests 1 and
   0 cut to 256 + 3 and 512 + 2 tokens (4 greedy tokens each), 9g under
   ``fsdp`` on request 2 cut to 256 + 1 (2 greedy tokens: a decode step's
   slots split 1 / 1; one request, the time budget). 5e's engine records their first-token
   logits, and an f32 run of its bf16 weights its own; the sharded engine's
   must sit no further from the f32 run than F32_DRIFT times 5e's (both
   run freely in bf16; 5e-2 of max|5e| is printed beside). Every call's
   collectives and launches are held exactly (9f 182 and 163 a call and
   rank; 9g 173 all-gathers a prefill call, 174 a decode step, 163
   launches), the state pool's heads a rank, then every launch shape of
   the forward (9f the rank's column shards and f32-store row partials at
   M = 1, 2, 256; 9g the gathered storage at M = 1, 256) against its plain
   version with device, plain and library ms; the steps' wall, kernel and
   copy device ms by kind, storage and gathered bytes and peak memory a
   rank are printed. 9h: the reduced Zamba2 (``in_proj`` replicated, and
   column-parallel with ``ssm_state=32``) and Mamba2 under ``tp``, the
   reduced llama3-8b and Zamba2 under ``fsdp``, in f32, serving the
   single-rank engines' tokens.  9j, in the same world after 9f:
   zamba2-2.7b under ``sp`` on 9f's rank parameters and prompts (the tail
   tokens one real row, rank 1 a pad row), held as 9f is, with 273
   collectives and 254 launches a call; 9l, after 9h: the reduced
   llama3-8b, Zamba2 (both ``in_proj`` layouts) and Mamba2 under ``sp``,
   the reduced DeepSeek-V2-Lite and Qwen3-MoE under ``fsdp``, in f32,
   serving the single-rank engines' tokens.
10. Training under a plan over 2 ranks sharing the card (``host``
   transport), with no fallback.  10a, in phase 9's world after 9d:
   llama3-8b under ``tp`` at full width cut to 2 layers (f32 parameters,
   bf16 compute, block remat), 3 AdamW steps at batch 2 x 1024, each rank
   drawing its slice; the first step's loss, global norm and every
   gradient slice held to a single-rank step on the same whole weights and
   batch (``FIRST_STEP_TOL["bfloat16"]``), each step's collectives and
   launches exactly, finite losses, the step walls, a profiled step's
   kernel and copy device ms and the peak memory a rank.  10b, in 9e's
   world after 9k: DeepSeek-V2-Lite under ``ep``, the same, the
   single-rank step replaying the ranks' expert ids.  10d, after 10a:
   llama3-8b over 2 pipeline stages (``pp``) at full width cut to 2
   layers (1 a stage), batch 4 x 256 in 4 microbatches, held as 10a is, and the
   embedding, final norm and lm_head bit-equal on the ranks after every
   step.  10e: 10d's first-step gradients compressed under the plan
   against the single-rank step's compressed whole (codes one apart at a
   rounding boundary excused and counted) and steps 2-3 with
   ``--compress-grads``; one compressed step of the reduced f32 dense
   model under ``pp`` and ``tp`` against the single-rank compressed step;
   ``compressed_psum`` against its numpy formula.  10c, after 10e:
   every (strategy, family) pair on the reduced f32 models (``pp`` dense
   included), one step against the single-rank step on the card (1e-4),
   and the checkpoint drill (save under the plan, the one-rank restore
   bit-equal, the same mesh's bit-equal resume) on five of them (``pp``
   with the compression's buffers).  The full-width drill runs in
   ``tools/torch_sharded_ckpt.py`` (its ~18 GB states take minutes).

Each phase's wall seconds are printed on a line of their own when the next
phase opens, and all of them together before the ``kernels`` line.

Each path's launch counts are set to 0 just before it runs and read just
after.  It prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX or of the JAX package.
"""

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# NVIDIA H100 SXM data sheet, dense rates: the least time a launch could take
# is the larger of its bytes over the memory rate and its operations over the
# peak rate for its input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# kernel vs plain: max|err| <= TOL * max(1, max|plain|).  float32: both sides
# multiply the same operands in IEEE f32 (no TF32) and differ only in the
# order of the sums, as do the bf16 mainloops' f32 store (exact bf16
# products summed in f32) and its plain version, where a bf16 rounding of
# the output would be ~2^-9 of it; bfloat16: both accumulate the same bf16 operands in f32,
# so after the final cast they differ by about one bf16 step (2^-8) at most
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# reduced model, card against CPU, f32 logits: two layers of the above
MODEL_TOL = 1e-4
# reduced fp8 model in bf16 compute, card against CPU: both sides multiply the
# same bf16 activations by the same (exactly upcast) weights in f32, but every
# activation and the logits themselves are rounded to bf16, and where the two
# sides' f32 sums straddle a rounding midpoint they land one bf16 step (2^-8
# relative) apart; two layers give a few such steps
BF16_MODEL_TOL = 3e-2
# full width, 32 layers in bf16: the quantized kernels against the plain
# versions on the same card and inputs, and the wavefront against the dip
# kernel on the same weights.  The same argument over 32 layers: each
# kernel alone stays within TOL at these shapes (phase 2), but every layer's
# bf16 activations round apart wherever the two sides' f32 sums straddle a
# midpoint, and the layers carry those steps on; for int8 each logit may
# also move by one activation-code step of every lm_head input.  The share
# of logits within the kernel tolerance TOL alone is printed beside it
FULL_TOL = 5e-2
# full width, SSM and hybrid models running freely: the kernels' logits may
# sit at most this many times as far from an f32 run of the same bf16
# weights and inputs as the plain run's do (both bf16 runs drift from it by
# their roundings alike; a faulty kernel adds an error of order 1)
F32_DRIFT = 1.5
# reduced training, card against CPU, losses and gradient norms over 3 AdamW
# steps: each step starts from parameters that differ by the f32 rounding of
# the step before, which AdamW's m/(sqrt(n) + eps) amplifies where a gradient
# is near 0 (the same bound the CPU tests hold the port to the reference with)
TRAIN_TOL = 1e-4
# a resumed step against the uninterrupted one: the same kernels on the same
# bytes; held to f32 rounding, and whether it is bit-exact is printed
RESUME_TOL = 1e-6
# full-width first step, kernels against plain PyTorch on the same weights and
# batch: (loss, global gradient norm) relative to max(1, |plain|), and each
# leaf's relative L2 gradient error.  float32: the same IEEE arithmetic in
# another order, as TRAIN_TOL.  bfloat16: the plain path rounds the logits and
# every backward product to bf16 (a relative step of 2^-8) where the kernel
# path keeps them in f32; on the reduced model that gives about 1e-4 in the
# loss, 1e-3 in the norm and 1e-2 in the worst leaf (CPU), and a faulty tile
# or dispatch gives an error of order 1 in some leaf
FIRST_STEP_TOL = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (1e-3, 1e-2, 5e-2)}


def device_ms(fn, flush, iters=10, warmup=3, queued=True):
    """Median CUDA-event time of fn() in ms, after ``warmup`` calls, with
    the card's buffer ``flush`` written before each call (the L2 holds
    none of fn's inputs).  queued: the call is enqueued behind a ~1 ms
    device sleep, so the events time the device's work alone; else the
    host's launch time counts wherever the device waits for it (as the
    first versions of this script timed).  Phase 7's timer, which
    ``tools/torch_kernel_times.py`` imports."""
    import torch

    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        flush.zero_()
        if queued:
            torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


PHASE_S = {}  # phase -> wall seconds, from one "phase X:" line to the next
_PHASE = {"name": None, "t": None}


def log(msg):
    """Print a line; a line that opens another phase ("phase 5d: ...";
    "phase 9e(b): ..." stays in 9e) first closes the open one with a line
    of its wall seconds."""
    m = re.match(r"phase (\w+)[:( ]", msg)
    if m and m.group(1) != _PHASE["name"]:
        close_phase()
        _PHASE.update(name=m.group(1), t=time.perf_counter())
    print(msg, flush=True)


def close_phase():
    """Print the open phase's wall seconds on a line of its own and add
    them to ``PHASE_S``."""
    if _PHASE["name"] is not None:
        dt = time.perf_counter() - _PHASE["t"]
        PHASE_S[_PHASE["name"]] = PHASE_S.get(_PHASE["name"], 0.0) + dt
        print(f"  [wall of phase {_PHASE['name']}: {dt:.1f} s]", flush=True)
        _PHASE["name"] = None


def close(name, got, want, tol):
    """Check one comparison; returns max|err|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    ok = err <= tol * scale
    log(f"  {name}: max|err| {err:.3e} (limit {tol:g} x {scale:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def step_grads(params, cfg, batch, tree, tf_model, moe_trace=None, fused_ce=None):
    """One step's loss and every leaf's gradient through ``cfg``'s backend
    (the fused loss unless ``fused_ce`` is False, and for the ``torch``
    backend always the unfused one); a leaf
    the loss does not reach (the embedding of a model fed embeddings) gets
    zeros, as the optimizer sees it."""
    import torch

    leaves = [leaf.requires_grad_(True) for leaf in tree.leaves(params)]
    loss = tf_model.loss_fn(params, cfg, batch, fused_ce=False if cfg.matmul_backend == "torch" else fused_ce,
                            moe_trace=moe_trace)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def grad_norm(grads):
    import torch

    return float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)))


def rel_l2(a, b):
    import torch

    return float(torch.linalg.vector_norm((a - b).float()) / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def first_step_against_plain(params, cfg, batch, tree, tf_model, replay=False, keep=False):
    """Loss and every leaf's gradient of one step through the kernels (the
    configured backend and the fused loss) and through plain PyTorch (the
    ``torch`` backend: ``torch.matmul`` on the de-sheared weights, and the
    unfused loss), on the same weights and batch.  ``replay``: the plain
    run of a MoE model routes with the kernel run's expert ids (every
    layer's, its remat rerun's too).  Returns a dict: ``losses`` and
    ``norms`` (kernels, plain), ``rel`` (each leaf's relative L2 gradient
    error), ``worst`` (the largest, with its path), ``mismatches`` (under
    remat, the kernel run's rerun's expert ids that differ from its
    forward's, over every MoE layer; None without MoE) and with ``keep``
    both runs' gradients, ``grads`` (kernels, plain)."""
    import dataclasses

    named = tree.paths(params)
    plain = dataclasses.replace(cfg, matmul_backend="torch")
    trace = {} if cfg.is_moe else None
    lk, gk = step_grads(params, cfg, batch, tree, tf_model, moe_trace=trace)
    mismatches = None
    if trace is not None:
        rerun = trace.get("recompute_ids", {})
        if cfg.remat == "block" and sorted(rerun) != list(range(cfg.n_layers)):
            raise AssertionError(f"the remat rerun recorded the routing of layers {sorted(rerun)}")
        mismatches = sum(int((rerun[i] != ids).sum()) for i, ids in enumerate(trace["ids"]) if i in rerun)
    lp, gp = step_grads(params, plain, batch, tree, tf_model,
                        moe_trace={"replay_ids": trace["ids"]} if replay and trace is not None else None)
    rel = {path: rel_l2(a, b) for (path, _), a, b in zip(named, gk, gp)}
    out = {"losses": (lk, lp), "norms": (grad_norm(gk), grad_norm(gp)), "rel": rel,
           "worst": max((v, k) for k, v in rel.items()), "mismatches": mismatches}
    if keep:
        out["grads"] = (gk, gp)
    return out


def clone_tree(t):
    """A deep copy of a cache / pool tree (dicts of tensors, ints)."""
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    return t.clone() if hasattr(t, "clone") else t


def copy_tree(dst, src):
    """Copy a cache tree's tensors into a tree of the same structure, in place."""
    if isinstance(dst, dict):
        for k in dst:
            copy_tree(dst[k], src[k])
    elif hasattr(dst, "copy_"):
        dst.copy_(src)


def trees_equal(a, b):
    """Whether two cache trees hold the same values bit for bit (a NaN
    equals the same NaN: the rows of a block poisoned by a fault drill)."""
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if not hasattr(a, "shape"):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def keep_last(store, kind, a):
    """Keep a step call's arguments (its integer inputs copied: the engine
    reuses their host arrays) and a device copy of its cache as the call
    found it, for the replay-against-eager check after serving: one copy per
    kind of call, overwritten call by call."""
    a = tuple(a[:2]) + tuple(t.clone() for t in a[2:])
    held = store.get(kind)
    if held is None:
        store[kind] = (a, clone_tree(a[1]))
    else:
        copy_tree(held[1], a[1])
        store[kind] = (a, held[1])


# pool leaves with a block axis (dim 1)
PAGED = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope", "c_kv_scale", "k_rope_scale")


def live_rows(a):
    """The batch rows of a step call that the engine reads: for a paged
    decode step the slots whose block table is not all null (a free slot
    writes its K/V to the null block's row 0, as every other free slot
    does, so which write lands there is not defined); otherwise every row."""
    if len(a) != 5 or not bool((a[4] != 0).any()):
        return slice(None)
    return (a[4] != 0).any(-1)


def served_cache(t, rows, name=""):
    """A cache tree without the null block (block 0) of its paged pools and
    with the per-slot state pools (``conv``, ``state``: slot axis 1) cut to
    ``rows`` (``live_rows``; a hybrid's free slot attends over the null
    block): what a step's result may be held to bit for bit."""
    if isinstance(t, dict):
        return {k: served_cache(v, rows, k) for k, v in t.items()}
    if name in PAGED and hasattr(t, "shape"):
        return t[:, 1:]
    return t[:, rows] if name in ("conv", "state") else t


def plain_backends(capture=None):
    """A context in which every kernel-backed matmul backend runs its plain
    PyTorch version on the card (a reference run on the same inputs);
    ``capture`` keeps the input of the last lm_head-wide quantized call."""
    from repro_torch.api import registry
    from repro_torch.kernels.dip_matmul import dip_matmul_plain
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q_plain
    from repro_torch.kernels.dip_systolic import dip_systolic_plain

    def q_plain(x2, q2, ws, *eops, **kw):
        if capture is not None and q2.shape[1] == capture["vocab"]:
            capture["head_x"] = x2
        return dip_matmul_q_plain(x2, q2, ws, *eops, **kw)

    fns = {"dip": lambda x2, p2, *e, **kw: dip_matmul_plain(x2, p2, *e, fuse_deshear=True, **kw),
           "ws": lambda x2, p2, *e, **kw: dip_matmul_plain(x2, p2, *e, fuse_deshear=False, **kw),
           "systolic": dip_systolic_plain, "dip_int8w": q_plain, "dip_fp8": q_plain}

    @contextlib.contextmanager
    def swap():
        saved = dict(registry._REGISTRY)
        for name, fn in fns.items():
            registry._REGISTRY[name] = dataclasses.replace(saved[name], fn=fn)
        try:
            yield
        finally:
            registry._REGISTRY.clear()
            registry._REGISTRY.update(saved)

    return swap()


@contextlib.contextmanager
def block_tape(tf_model, mode, tape):
    """A context in which every block of the model (a Mamba2 block, an
    attention+FFN block of a forward or of the paged decode step) is taped
    in call order: ``"record"`` keeps each block's input and output;
    ``"replay"`` feeds each block the input that the recorded run gave the
    block of the same call index, in place of its own, and keeps the
    output.  A plain run replaying a kernels' run so compares the two block
    by block on the same inputs, without the drift of the bf16 roundings
    that the blocks before it carry on."""
    names = ("_mamba_block", "_transformer_block", "_paged_block")
    saved = {nm: getattr(tf_model, nm) for nm in names}

    def taped(fn):
        def block(x, *a, **kw):
            rows = tape.setdefault(mode, [])
            if mode == "replay":
                x = tape["record"][len(rows)][0]
            out = fn(x, *a, **kw)
            rows.append((x.clone() if mode == "record" else None, (out[0] if isinstance(out, tuple) else out).clone()))
            return out
        return block

    for nm in names:
        setattr(tf_model, nm, taped(saved[nm]))
    try:
        yield tape
    finally:
        for nm in names:
            setattr(tf_model, nm, saved[nm])


def head_step(head, head_x, vocab):
    """Per-logit change when every int8 activation code of the lm_head's
    input row moves one step: x_scale[m] * sum_k |Q[k, n]| * w_scale[n]."""
    from repro_torch.core import permute
    from repro_torch.kernels.ref import quantize_acts_int8

    _, x_scale = quantize_acts_int8(head_x)
    colsum = permute.unpermute_tiled(head.data, head.perm_tile)[:, :vocab].float().abs().sum(0)
    return x_scale * colsum * head.scale[0, :vocab]


# ------------------------------------------------- phase 9: the ranks' side --
# Module-level, so that the ranks ``distributed.run_world`` spawns (``spawn``
# start method: they import this file as a module) can reach them.
SHARDED_SHAPES = {"gate+up": (4096, 14336), "down": (14336, 4096)}


def _sharded_cases():
    """(label, backend, plan kind, shape, epilogue, scheme) of phase 9a / 9b:
    llama3-8b's gate+up and down at M = 4 and 256, bf16."""
    cases = []
    for m in (4, 256):
        cases += [(f"dip_tp column gate+up M={m}", "dip_tp", "column", "gate+up", "swiglu", None, m),
                  (f"dip_tp row down M={m}", "dip_tp", "row", "down", "residual", None, m),
                  (f"dip_fsdp gate+up M={m}", "dip_fsdp", "column", "gate+up", "swiglu", None, m),
                  (f"dip_fsdp down M={m}", "dip_fsdp", "row", "down", "residual", None, m),
                  (f"dip_sp column gate+up M={m}", "dip_sp", "column", "gate+up", "swiglu", None, m),
                  (f"dip_sp row down M={m}", "dip_sp", "row", "down", "residual", None, m),
                  (f"dip_tp row down dip_int8w M={m}", "dip_tp", "row", "down", "none", "int8", m)]
    return cases


# the reference's placement contract (tests/test_sharded_backends.py:121-140,
# :253-262) at T ranks: collectives and launches of one call
def _sharded_want(backend, kind, epilogue, t):
    if backend == "dip_tp":
        return {"psum": 0, "launch": 1} if kind == "column" else {"psum": 1, "launch": 2 if epilogue == "swiglu"
                                                                  else 1}
    if backend == "dip_fsdp":
        return {"all_gather": 2 if epilogue == "swiglu" else 1, "psum": 0, "launch": 1}
    if kind == "column":
        return {"ppermute": t - 1, "all_gather": 0, "psum": 0, "launch": t}
    return {"reduce_scatter": 1, "psum": 0, "launch": 1}


def record_first_logits(eng, vocab, into):
    """Hook ``eng`` so that each request's first-token logits (the last
    prompt row's first ``vocab`` columns) land in ``into`` by request id:
    phase 9c holds the sharded engine's to phase 5's."""
    finish = eng._finish_prefill

    def record(req, plen, last_logits):
        row = (plen - 1) - (eng._prefill_done - last_logits.shape[1])
        into[req.rid] = last_logits[0, row, :vocab].float().cpu().numpy()
        return finish(req, plen, last_logits)

    eng._finish_prefill = record


def _held_launch(launch, plain, exact, tol):
    """One kernel launch beside its plain version on the same card inputs:
    bit for bit where ``exact``, else max|err| <= tol * max(1, max|plain|);
    the kernels' counters must show the one launch.  Returns the record and
    the kernel's output."""
    import torch

    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q

    before = dip_matmul.launches + dip_matmul_q.launches
    got = launch()
    counted = dip_matmul.launches + dip_matmul_q.launches - before
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    bound = 0.0 if exact else tol * max(1.0, float(want.float().abs().max()))
    ok = counted == 1 and got.dtype == want.dtype and (bool(torch.equal(got, want)) if exact else err <= bound)
    return {"max_abs_err": err, "bound": bound, "exact": exact, "out_dtype": str(got.dtype), "counted": counted,
            "ok": ok}, got


def _phase9_dispatch(transport):
    """9a / 9b on this rank: every case through its sharded backend on the
    rank's shard, the single-rank dispatch of the whole weight and its plain
    version beside it on the same card, this rank's own launch held against
    its plain version on the same inputs (the row partials' f32 store; int8
    bit for bit), the communicator's counts, the kernels' own counters, and
    the device ms of this rank's launch (and of the single-rank dispatch)."""
    import torch

    from repro_torch import api
    from repro_torch.distributed import WeightPlan, comm, make_local_mesh, shard_weight
    from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    dev = torch.device("cuda", 0 if transport == "host" else rank)
    torch.cuda.set_device(dev)
    meshes = {"m": make_local_mesh(data=1, model=world, transport=transport, device=dev),
              "f": make_local_mesh(data=world, model=1, transport=transport, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    f32 = torch.float32

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    weights = {nm: [api.DipWeight.from_natural(draw(k, n, scale=k ** -0.5)) for _ in range(2)]
               for nm, (k, n) in SHARDED_SHAPES.items()}
    out, timers = [], []
    for label, backend, kind, shape, epilogue, scheme, m in _sharded_cases():
        k, n = SHARDED_SHAPES[shape]
        mesh = meshes["f" if backend == "dip_fsdp" else "m"]
        axis = "data" if backend == "dip_fsdp" else "model"
        t, me = mesh.shape[axis], mesh.coord(axis)
        x, resid = draw(m, k), draw(m, n)
        full = weights[shape][:2 if epilogue == "swiglu" else 1]
        if scheme:
            full = [api.quant.quantize(w.to_natural().float(), scheme) for w in full]
        plan = WeightPlan(kind, axis="model", fsdp="data", mesh=mesh)
        loc = [shard_weight(w, plan, along="fsdp" if backend == "dip_fsdp" else "tp") for w in full]
        xl, rl = x, resid
        if kind == "row" and backend != "dip_fsdp":
            xl = x[:, me * (k // t):(me + 1) * (k // t)].contiguous()
        if backend == "dip_fsdp" or (backend == "dip_sp" and kind == "column"):
            xl = x[me * (m // t):(me + 1) * (m // t)]
        if backend == "dip_fsdp" or (backend == "dip_sp" and kind == "row"):
            rl = resid[me * (m // t):(me + 1) * (m // t)]
        ops = (rl,) if epilogue == "residual" else ()
        w_arg = tuple(loc) if epilogue == "swiglu" else loc[0]
        before = dip_matmul.launches + dip_matmul_q.launches
        comm.reset()
        got = api.matmul(xl, w_arg, backend=backend, epilogue=epilogue, epilogue_operands=ops)
        torch.cuda.synchronize(dev)
        counted = dip_matmul.launches + dip_matmul_q.launches - before
        counts = comm.counts()

        def whole(x=x, full=full, epilogue=epilogue, scheme=scheme, resid=resid):
            return api.matmul(x, tuple(full) if epilogue == "swiglu" else full[0],
                              backend=None if scheme else "dip", epilogue=epilogue,
                              epilogue_operands=(resid,) if epilogue == "residual" else ())

        single = whole()
        with plain_backends():
            plain = whole()
        # this rank's launch alone, the per-shard product at the shard's
        # shape, beside its plain version on the same inputs
        if kind == "row" and backend != "dip_fsdp":
            q = loc[0]
            if scheme:
                pair = (lambda xs=xl, q=q: dip_matmul_q(xs, q.data, q.scale, out_dtype=f32),
                        lambda xs=xl, q=q: dip_matmul_q_plain(xs, q.data, q.scale, out_dtype=f32))
            else:
                pair = (lambda xs=xl, q=q: dip_matmul(xs, q.data, out_dtype=f32),
                        lambda xs=xl, q=q: dip_matmul_plain(xs, q.data, out_dtype=f32))
            held, part = _held_launch(*pair, exact=bool(scheme), tol=TOL["float32"])
        else:
            # fsdp: the gathered weight on the local rows; sp: one ring step
            wl = [w.data for w in (full if backend == "dip_fsdp" else loc)]
            args = (wl[0], wl[1]) if epilogue == "swiglu" else (wl[0], rl)
            pair = (lambda xs=xl, a=args, e=epilogue: dip_matmul(xs, *a, epilogue=e),
                    lambda xs=xl, a=args, e=epilogue: dip_matmul_plain(xs, *a, epilogue=e))
            held, part = _held_launch(*pair, exact=False, tol=TOL["bfloat16"])
        timers.append((pair[0], lambda x=x, full=full, epilogue=epilogue, scheme=scheme: api.matmul(
            x, tuple(full) if epilogue == "swiglu" else full[0], backend=None if scheme else "dip",
            epilogue="swiglu" if epilogue == "swiglu" else None)))
        out.append({"label": label, "backend": backend, "kind": kind, "epilogue": epilogue, "scheme": scheme,
                    "ranks": t, "got": got.float().cpu().numpy(), "single": single.float().cpu().numpy(),
                    "plain": plain.float().cpu().numpy(), "held": held,
                    "partial": part.float().cpu().numpy() if scheme else None, "counts": counts,
                    "counted": counted, "want_counts": _sharded_want(backend, kind, epilogue, t)})
        del got, single, plain, part
    # the ranks share the card: each times its launches while the others wait
    for r in range(world):
        torch.distributed.barrier()
        if r == rank:
            for row, (launch, single_call) in zip(out, timers):
                row["rank_ms"] = device_ms(launch, flush)
                row["single_ms"] = device_ms(single_call, flush)
        torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    return out


def _library_call(x, nats, kw, ops=()):
    """The same function in library calls: ``torch.matmul`` of the natural
    weight(s), after ``F.rms_norm`` where the launch fuses the prologue,
    with the swiglu epilogue in torch, or the residual ``ops`` added (a row
    partial's f32 store: the bf16 ``torch.matmul``, whose sums cuBLAS also
    keeps in f32)."""
    import torch.nn.functional as F

    from repro_torch.kernels.prologue import DEFAULT_EPS

    gain = kw.get("prologue_operands")

    def run():
        h = x if gain is None else F.rms_norm(x, (x.shape[-1],), gain[0].to(x.dtype), DEFAULT_EPS)
        if len(nats) == 2:
            return F.silu(h @ nats[0]) * (h @ nats[1])
        return h @ nats[0] + ops[0] if ops else h @ nats[0]

    return run


def _held_shapes(shapes, dev, seed):
    """Each launch shape (``(label, kind, m, datas, kw)``: the rank's own
    storage, the ``dip_matmul`` keywords) on random bf16 x, the kernel
    against its plain version on the same card inputs (``_held_launch``;
    the row partials' f32 store within f32 TOL, the rest within bf16 TOL);
    each one's device ms beside the plain version's and the library call's
    (``_library_call``), timed while the other ranks wait.  A ``residual``
    epilogue gets a random (m, n) residual."""
    import torch

    from repro_torch.core import permute
    from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain

    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out, calls = [], []
    for label, kind, m, data, kw in shapes:
        k, n = data[0].shape
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        if kw.get("prologue") == "rmsnorm":
            kw = dict(kw, prologue_operands=(torch.rand(k, generator=gen, device=dev) + 0.5,))
        ops = (torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16),) if kw.get(
            "epilogue") == "residual" else ()
        pair = (lambda x=x, d=data, kw=kw, o=ops: dip_matmul(x, *d, *o, **kw),
                lambda x=x, d=data, kw=kw, o=ops: dip_matmul_plain(x, *d, *o, **kw))
        held, _ = _held_launch(*pair, exact=False, tol=TOL["float32" if kind == "row" else "bfloat16"])
        nats = [permute.unpermute_tiled(d, 64) for d in data]
        out.append(dict(held, launch=label, kind=kind, m=m, k=k, n=n, epilogue=kw.get("epilogue", "none"),
                        prologue=kw.get("prologue", "none")))
        calls.append(pair + (_library_call(x, nats, kw, ops),))
    for r in range(world):
        torch.distributed.barrier()
        if r == rank:
            for rec, (launch, plain, library) in zip(out, calls):
                rec["ms"], rec["plain_ms"] = device_ms(launch, flush), device_ms(plain, flush)
                rec["library_ms"] = device_ms(library, flush)
        torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    return out


def _held_served_launches(eng, dev, rows=None):
    """9c / 9i on this rank, after serving: each DiP launch of the served
    forward at its shard's shape, on the engine's own storage (layer 0's and
    the lm_head's slices) through ``_held_shapes``: the column shards (q, k,
    v, gate+up under swiglu, the lm_head) with the rmsnorm prologue fused;
    the row partials of o and down (the f32 store).  ``rows``: each kind's
    two M, a decode step's and a prefill chunk's: 4 and 256 under ``tp``;
    under ``sp`` the column shards run the rank's 2 and 128 rows, the row
    partials all 4 and 256."""
    import torch

    rows = rows or {"column": (4, 256), "row": (4, 256)}
    lyr = eng.params["layers"]
    shards = [("wq", [lyr["wq"]]), ("wk", [lyr["wk"]]), ("wv", [lyr["wv"]]),
              ("w_gate + w_up", [lyr["w_gate"], lyr["w_up"]]), ("wo", [lyr["wo"]]), ("w_down", [lyr["w_down"]]),
              ("lm_head", [eng.params["lm_head"]])]
    shapes = []
    for i in range(2):
        for label, ws in shards:
            kind = ws[0].plan.kind
            m = rows[kind][i]
            data = [w.data[0] if w.data.dim() == 3 else w.data for w in ws]
            kw = dict(out_dtype=torch.float32) if kind == "row" else dict(
                epilogue="swiglu" if len(data) == 2 else "none", prologue="rmsnorm")
            shapes.append((label, kind, m, data, kw))
    return _held_shapes(shapes, dev, SEED + 1)


def _phase9_serve(prompts):
    """9c on this rank: llama3-8b at full width through
    ``Server(plan=make_plan(mesh(model=2), cfg_tp, "decode"))`` on the
    ``host`` transport, phase 5's settings and requests: the rank draws
    phase 5's weights from the same seed on the card, keeping only its
    slice (``init_params(plan=)``).  Each step's collectives and launches,
    wall ms, the device ms of one profiled decode step and prefill chunk,
    the first-token logits, peak memory while building and while serving,
    and each launch shape held to its plain version."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.runtime import Request, Server, ServerConfig

    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(data=1, model=torch.distributed.get_world_size(), transport="host", device=dev)
    cfg = dataclasses.replace(get_config("llama3-8b"), matmul_backend="dip_tp", sharding="tp",
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    plan = make_plan(mesh, cfg, "decode")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # phase 5's weights (the same draws), of which the rank keeps only its slice
    params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
    server = Server(cfg, ServerConfig(batch_slots=4, max_seq=1024, max_new_tokens=16, temperature=0.0,
                                      prefill_chunk=256), params, device=dev, plan=plan)
    del params
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    weights_gib = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    eng = server.engine
    steps, profiled, first = {"_prefill_fwd": [], "_decode": []}, {}, {}
    record_first_logits(eng, cfg.vocab_size, first)
    _traced_steps(eng, dev, steps, profiled)
    reqs = [Request(rid=i, prompt=np.asarray(p)) for i, p in enumerate(prompts)]
    dip_matmul.launches = dip_matmul.launches_f32 = fa.flash_attention.launches = 0
    comm.reset()
    t0 = time.perf_counter()
    results = server.serve(reqs)
    wall = time.perf_counter() - t0
    launches = {"dip_matmul": dip_matmul.launches, "dip_matmul_f32_x": dip_matmul.launches_f32,
                "flash_attention": fa.flash_attention.launches}
    # the host transport alone, no kernels in flight: one all-reduce of a
    # decode step's and of a prefill chunk's f32 partials from the card, and
    # the same bytes over gloo from host memory
    transport = {}
    for rows in (4, 256):
        t_dev = torch.ones((rows, cfg.d_model), device=dev)
        t_host = torch.ones((rows, cfg.d_model))
        for what, fn in (("card", lambda: comm.psum(t_dev, mesh, "model")),
                         ("host", lambda: torch.distributed.all_reduce(t_host, group=mesh.group("model")))):
            ts = []
            for _ in range(12):
                torch.distributed.barrier()
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                ts.append(1e3 * (time.perf_counter() - t))
            transport[f"{what}_{rows}x{cfg.d_model}_f32_ms"] = statistics.median(ts[2:])
    out = {"results": results, "first_logits": first, "steps": steps, "profiled_device_ms": profiled,
           "transport_ms": transport, "launches": launches,
           "wall_s": wall, "build_s": build_s, "weights_gib": weights_gib, "build_peak_gib": build_peak_gib,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
           "transport": mesh.transport, "eager_reason": eng.eager_reason, "captured": eng.captured,
           "kv_heads": int(eng.kv.pools["layers"]["k"].shape[3])}
    out["held_launches"] = _held_served_launches(eng, dev)  # after the peaks: its plain versions' f32 copies
    return out, eng.params, mesh


def _phase9i(params, mesh, prompts):
    """9i on this rank: llama3-8b under ``sp`` on 9c's rank parameters
    (``dip_sp`` consumes the column / row shards ``dip_tp`` does: nothing is
    drawn again) through ``Server(plan=)`` at 9c's settings on its
    requests, 8 greedy tokens each: tokens, first-token logits, each step's
    collectives, launches, replicated dispatches, wall and device ms, peak
    memory; then each launch shape of the forward on the rank's storage
    against its plain version (the column shards at the rank's 2 and 128
    rows, the row partials at all 4 and 256)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import make_plan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.runtime import Request, Server, ServerConfig

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("llama3-8b"), matmul_backend="dip_sp", sharding="sp",
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    plan = make_plan(mesh, cfg, "decode")
    torch.cuda.reset_peak_memory_stats(dev)
    server = Server(cfg, ServerConfig(batch_slots=4, max_seq=1024, max_new_tokens=SP_TOKENS, temperature=0.0,
                                      prefill_chunk=256), params, device=dev, plan=plan)
    eng = server.engine
    steps, profiled, first = {"_prefill_fwd": [], "_decode": []}, {}, {}
    record_first_logits(eng, cfg.vocab_size, first)
    _traced_steps(eng, dev, steps, profiled)
    reqs = [Request(rid=i, prompt=np.asarray(p)) for i, p in enumerate(prompts)]
    dip_matmul.launches = dip_matmul.launches_f32 = fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    results = server.serve(reqs)
    wall = time.perf_counter() - t0
    out = {"results": results, "first_logits": first, "steps": steps, "profiled_device_ms": profiled,
           "launches": {"dip_matmul": dip_matmul.launches, "dip_matmul_f32_x": dip_matmul.launches_f32,
                        "flash_attention": fa.flash_attention.launches},
           "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30, "eager_reason": eng.eager_reason,
           "kv_heads": int(eng.kv.pools["layers"]["k"].shape[3])}
    out["held_launches"] = _held_served_launches(eng, dev, {"column": (2, 128), "row": (4, 256)})
    del server, eng
    return out


def _phase9_reduced(prompts):
    """9d on this rank: the reduced llama3-8b in f32, ``dip_tp`` over the
    ranks on the card (host transport), seeded weights drawn on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.distributed import make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(data=1, model=torch.distributed.get_world_size(), transport="host", device=dev)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip", compute_dtype="float32",
                              param_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(SEED, dev), dev)
    tp = dataclasses.replace(cfg, matmul_backend="dip_tp", sharding="tp")
    eng = Engine(tp, params, engine_cfg=EngineConfig(slots=2, max_seq=64, prefill_chunk=16), device=dev,
                 plan=make_plan(mesh, tp, "decode"))
    for rid, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=8), rid=rid)
    dip_matmul.launches = dip_matmul.launches_f32 = 0
    results = eng.run()
    return {"results": results, "dip_launches": dip_matmul.launches, "dip_f32_x_launches": dip_matmul.launches_f32}


def phase9_rank(rank, serve_prompts, reduced_prompts):
    """One rank of the 2-rank world sharing the card (host transport): 9a,
    then 9c on phase 5's weights and requests, 9i on 9c's rank parameters,
    then 9d, then training under a plan: 10a (llama3-8b ``tp``), 10d
    (llama3-8b over 2 pipeline stages, with 10e's compressed steps), 10e
    (the reduced compressed pairs, ``compressed_psum``) and 10c (the
    reduced pairs and their checkpoint drills).  Returns numpy and numbers
    only."""
    import warnings

    # before this rank's first CUDA allocation: freed blocks are given back to
    # the card for the other rank, which 10d's two full-width stages need (PERF.md §4)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    warnings.simplefilter("ignore", UserWarning)  # the reduced model's K/V replicate (announced once)
    out = {"9a": _phase9_dispatch("host")}
    out["9c"], params, mesh = _phase9_serve(serve_prompts)
    t0 = time.perf_counter()
    out["9i"] = _phase9i(params, mesh, serve_prompts)
    out["9i"]["phase_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["9d"] = _phase9_reduced(reduced_prompts)
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out["10a"] = _phase10_model(train10_config("llama3-8b"), train10_config("llama3-8b", "tp"),
                                os.path.join(ROOT, "build", "chip_smoke_ckpt", "10a"), dev)
    out["10a"]["world_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["10d"] = _phase10_model(train10_config("llama3-8b", layers=TRAIN10D_LAYERS),
                                train10_config("llama3-8b", "pp", layers=TRAIN10D_LAYERS),
                                os.path.join(ROOT, "build", "chip_smoke_ckpt", "10d"), dev, batch=TRAIN10D_BATCH,
                                compress=True)
    out["10d"]["world_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["10e"] = _phase10e(dev)
    out["10e"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["10c"] = {"pairs": _phase10c(dev), "drills": {}}
    for strategy, fam in TRAIN10_DRILLS:  # the checkpoint drill on the reduced models (PERF.md §4)
        base = train10_reduced_config(fam)
        drill = _phase10_model(base, _plan_config(base, strategy),
                               os.path.join(ROOT, "build", "chip_smoke_ckpt", f"10c_{strategy}_{fam}"), dev,
                               replay=base.is_moe, checkpoint=True, batch=(TRAIN10_ROWS.get(strategy, 2), 32),
                               compress=strategy == "pp")
        out["10c"]["drills"][f"{strategy}/{fam}"] = dict(drill, world_phase_s=drill["phase_s"])
    out["10c"]["phase_s"] = time.perf_counter() - t0
    return out


def phase9_nccl_rank(rank):
    """9b: the dispatch cases in a 1-rank NCCL world on the card."""
    return _phase9_dispatch("nccl")


# ----------------------------------------------- phase 9e: the ranks' side --
EP_CHUNK = 256  # 9e's prefill chunk and (B, S) = (2, EP_CHUNK) forward
# (name, arch, strategy, ample capacity)
DS_REDUCED = (("deepseek_tp", "deepseek-v2-lite-16b", "tp", False), ("deepseek_ep", "deepseek-v2-lite-16b", "ep", True),
              ("qwen3_ep", "qwen3-moe-235b-a22b", "ep", True))


def ds_config(strategy=None):
    """Phase 5d's DeepSeek-V2-Lite configuration (the launcher's: bf16,
    ``dip``), or under ``strategy`` its plan's (``dip_tp`` / ``dip_ep``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), matmul_backend="dip", param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    return cfg if strategy is None else dataclasses.replace(cfg, matmul_backend=f"dip_{strategy}",
                                                            sharding=strategy)


def reduced_moe_config(arch, strategy=None, ample=False):
    """9e(f)'s reduced model in f32 on ``dip``, or under ``strategy`` its
    plan's; ``ample``: the capacity factor E / k, so that an expert can take
    every token of a group and no pair drops on either side (finite
    capacity is held in 9e(c))."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(), matmul_backend="dip", compute_dtype="float32",
                              param_dtype="float32")
    if ample:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    if strategy is not None:
        cfg = dataclasses.replace(cfg, matmul_backend=f"dip_{strategy}", sharding=strategy)
    return cfg


def bank_sums(bank):
    """Per expert, the integer sum of a layer's bank's bf16 bit patterns:
    a checksum that no summation order changes."""
    import torch

    return bank.view(torch.int16).long().sum((1, 2)).cpu().numpy()


def _step_kind(attr, args):
    """A step call's kind (phases 9f and 9g): a ``decode`` step, a prefill
    ``chunk`` or a single-token forward of the prefill ``tail``."""
    return "decode" if attr == "_decode" else "chunk" if args[2].shape[1] > 1 else "tail"


def _traced_steps(eng, dev, steps, profiled, kind_of=None):
    """Wrap the engine's two steps (phases 9c, 9e, 9f, 9g and 9i-9k): each
    call's wall ms, collectives by name (``comm.reset(schedule=True)``
    before it), DiP launches, the replicated weights the ``sp`` path
    dispatched and, for the expert-parallel layer, whether each dispatch
    all-to-all came before its two shared-expert launches; the second call
    of each kind under the profiler (kernel and copy device ms).  A call's
    kind is its step's name, or ``kind_of(name, args)``."""
    import torch

    from repro_torch.distributed import comm
    from repro_torch.kernels.dip_matmul import dip_matmul

    def traced(attr):
        f = getattr(eng, attr)

        def run(*a):
            kind = attr if kind_of is None else kind_of(attr, a)
            calls = steps.setdefault(kind, [])
            comm.reset(schedule=True)
            l0 = dip_matmul.launches
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            if len(calls) == 1:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    res = f(*a)
                    torch.cuda.synchronize(dev)
                dev_ev = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
                ms = {e.key: (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) / 1e3
                      for e in dev_ev}
                copies = {k: v for k, v in ms.items() if k.startswith("Memcpy") or k.startswith("Memset")}
                profiled[kind] = {"kernels_ms": sum(ms.values()) - sum(copies.values()),
                                  "copies_ms": sum(copies.values()),
                                  "kernel_launches": sum(e.count for e in dev_ev if e.key not in copies)}
            else:
                res = f(*a)
            torch.cuda.synchronize(dev)
            wall = 1e3 * (time.perf_counter() - t)
            sched = comm.schedule()
            # each dispatch all-to-all (the first of a layer's pair) is followed
            # by the two plan-free shared-expert launches, then the combine
            a2a = [i for i, nm in enumerate(sched) if nm == "all_to_all"]
            order_ok = bool(a2a) and len(a2a) % 2 == 0 and all(
                sched[i + 1:i + 4] == ["launch", "launch", "all_to_all"] for i in a2a[::2])
            calls.append({"wall_ms": wall, "collectives": {k: v for k, v in comm.counts().items() if k != "launch"},
                          "dip_launches": dip_matmul.launches - l0, "dispatch_first": order_ok,
                          "replicated": comm.replicated()})
            return res
        setattr(eng, attr, run)

    traced("_prefill_fwd")
    traced("_decode")


def _phase9e_serve(rec):
    """9e (a)-(e) on this rank: DeepSeek-V2-Lite at full width under the
    ``ep`` plan over the ranks sharing the card (``host`` transport), the
    rank drawing only its slice of phase 5d's weights from the seed."""
    import numpy as np
    import torch

    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(data=1, model=torch.distributed.get_world_size(), transport="host", device=dev)
    cfg = ds_config("ep")
    plan = make_plan(mesh, cfg, "decode")
    me, vocab = plan.tp_rank, cfg.vocab_size
    out = {}

    # (a) the rank's slice of 5d's weights, drawn from the seed
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
    torch.cuda.synchronize(dev)
    e0, n = plan.experts_local(cfg.n_experts)
    lyr = params["layers"]
    out["a"] = {"build_s": time.perf_counter() - t0, "build_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "weights_gib": torch.cuda.memory_allocated(dev) / 2**30, "experts": [e0, n],
                "banks_equal": all(np.array_equal(bank_sums(lyr[nm][0]), rec["bank_sums"][nm][e0:e0 + n])
                                   for nm in ("w_gate", "w_up", "w_down")),
                "bank_shape": list(lyr["w_gate"].shape), "shared_storage": list(lyr["shared_w_gate"].data.shape),
                "shared_plan": lyr["shared_w_gate"].plan.kind}

    # (b) the (2, 256) forward, split by batch: free routing, then 5d's choices replayed
    toks = torch.as_tensor(rec["tokens"], device=dev)
    ref = torch.as_tensor(rec["logits"], device=dev)
    scale = max(1.0, float(ref.abs().max()))
    replay_ids = [torch.as_tensor(a, device=dev) for a in rec["ids"]]
    b = {"scale": scale}
    for what, trace in (("free", {}), ("replayed", {"replay_ids": replay_ids})):
        comm.reset()
        with torch.no_grad():
            logits = tf_model.forward(params, cfg, tokens=toks, plan=plan, moe_trace=trace)[0][..., :vocab].float()
        mine = [r.narrow(0, me, 1) for r in replay_ids]  # the batch split: this rank's row
        flips = sum(int((~(ik[..., :, None] == ir[..., None, :]).any(-1)).sum()) for ik, ir in zip(trace["ids"], mine))
        b[what] = {"max_abs_err": float((logits - ref).abs().max()), "finite": bool(torch.isfinite(logits).all()),
                   "dropped": [int(v) for v in trace["dropped"]], "choices_differing": flips,
                   "collectives": {k: v for k, v in comm.counts().items() if k != "launch"}}
        del logits
    out["b"] = b
    del ref

    # (c) layer 0 on the chunk shape (1, 256), split by sequence
    lp0 = tf_model._layers(lyr, cfg.n_layers)[0]
    x = torch.as_tensor(rec["chunk_x"], device=dev).to(torch.bfloat16)
    comm.reset(schedule=True)
    with torch.no_grad():
        y, aux, dropped, ids = moe.moe_ffn(x, lp0, cfg, plan=plan, return_routing=True)
    want = torch.as_tensor(rec["halves_out"], device=dev)
    out["c"] = {"max_abs_err": float((y.float() - want).abs().max()),
                "bound": TOL["bfloat16"] * max(1.0, float(want.abs().max())), "dropped": int(dropped),
                "ids_equal": bool(np.array_equal(ids.cpu().numpy(), rec["halves_ids"][me])),
                "counts": comm.counts(), "schedule": comm.schedule(), "capacity": moe.moe_capacity(x.shape[1] // 2, cfg)}
    del x, y, want, lp0

    # (d) the engine at 5d's settings, 5d's requests, 8 greedy tokens each
    torch.cuda.reset_peak_memory_stats(dev)
    eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=4, max_seq=1024, prefill_chunk=EP_CHUNK), device=dev,
                 plan=plan)
    del params, lyr
    steps, profiled, first = {"_prefill_fwd": [], "_decode": []}, {}, {}
    record_first_logits(eng, vocab, first)
    _traced_steps(eng, dev, steps, profiled)
    for rid, p in enumerate(rec["prompts"][:SHARDED_REQUESTS]):
        eng.add_request(np.asarray(p), SamplingParams(max_new_tokens=8), rid=rid)
    dip_matmul.launches = dip_matmul.launches_f32 = 0
    t0 = time.perf_counter()
    results = eng.run()
    out["d"] = {"results": results, "first_logits": first, "steps": steps, "profiled_device_ms": profiled,
                "launches": {"dip_matmul": dip_matmul.launches, "dip_matmul_f32_x": dip_matmul.launches_f32},
                "wall_s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
                "eager_reason": eng.eager_reason, "captured": eng.captured,
                "pools": {k: list(v.shape) for k, v in eng.kv.pools["layers"].items()}}

    # (e) each launch shape of the served forward on the rank's own storage
    lp = eng.params["layers"]

    def layer0(w):
        return [w.data[0]]

    col = dict(prologue="rmsnorm")
    shapes = []
    for m in (4, 256):
        shapes += [("wq", "column", m, layer0(lp["wq"]), col), ("w_dkv", "column", m, layer0(lp["w_dkv"]), col),
                   ("w_krope", "replicated", m, layer0(lp["w_krope"]), col),
                   ("wo", "row", m, layer0(lp["wo"]), dict(out_dtype=torch.float32)),
                   ("lm_head", "column", m, [eng.params["lm_head"].data], {})]
    for m in (2, EP_CHUNK // 2):  # the rank's own tokens: half the decode slots, half the chunk
        shapes += [("shared gate+up", "plan-free", m, layer0(lp["shared_w_gate"]) + layer0(lp["shared_w_up"]),
                    dict(epilogue="swiglu")),
                   ("shared down", "plan-free", m, layer0(lp["shared_w_down"]), {})]
    out["e"] = _held_shapes(shapes, dev, SEED + 11)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _phase9e_reduced(prompts):
    """9e (f) on this rank: the reduced DeepSeek-V2-Lite under ``tp``, and
    the reduced DeepSeek-V2-Lite and Qwen3-MoE under ``ep``, in f32 on the
    card: each engine's tokens, its launches, and the dropped pairs of one
    forward of the first prompt."""
    import torch

    from repro_torch.device import make_generator
    from repro_torch.distributed import make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(data=1, model=torch.distributed.get_world_size(), transport="host", device=dev)
    out = {}
    for name, arch, strategy, ample in DS_REDUCED:
        cfg = reduced_moe_config(arch, strategy, ample)
        plan = make_plan(mesh, cfg, "decode")
        params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
        trace = {}
        with torch.no_grad():
            tf_model.forward(params, cfg, tokens=torch.as_tensor([prompts[0]], device=dev), plan=plan,
                             moe_trace=trace)
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=64, prefill_chunk=16), device=dev,
                     plan=plan)
        for rid, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(max_new_tokens=8), rid=rid)
        dip_matmul.launches = dip_matmul.launches_f32 = 0
        results = eng.run()
        out[name] = {"results": results, "dropped": sum(int(v) for v in trace["dropped"]),
                     "dip_launches": dip_matmul.launches, "dip_f32_x_launches": dip_matmul.launches_f32}
    return out


def _choices_differing(a, b):
    """(token, slot) pairs of expert ids ``a`` whose expert is not among the
    same token's choices in ``b`` (both (B, S, k), a layer each)."""
    import numpy as np

    return sum(int((~(np.asarray(x)[..., :, None] == np.asarray(y)[..., None, :]).any(-1)).sum())
               for x, y in zip(a, b))


def _phase9k(rec):
    """9k on this rank: DeepSeek-V2-Lite at full width cut to its first
    ``DS_CUT_LAYERS`` layers under ``fsdp`` over the ranks sharing the card
    (a (data 2, model 1) mesh, ``host`` transport): the rank draws its slice
    from the seed (K / 2 of every projection, half of each expert bank's
    contraction dim and of the router's d), ``Engine(plan=)`` with 2 slots
    serves ``rec``'s two prompts (one 256-token chunk each, whole on both
    ranks), 2 greedy tokens each (a decode step's 2 slots split 1 / 1):
    tokens, first-token logits and each prefill's expert ids, each step's
    all-gathers, launches, wall and device ms, the storage bytes a forward
    gathers, peak memory.  A prompt whose expert choices differ from the
    single-rank step's runs its prefill again with those choices replayed.
    Then each launch shape of the forward on the gathered storage against
    its plain version, at M = 1 (a decode step's slot a rank) and 256 (the
    chunk)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    dev = torch.device("cuda", 0)
    world = torch.distributed.get_world_size()
    mesh = make_local_mesh(data=world, model=1, transport="host", device=dev)
    cfg = dataclasses.replace(ds_config("fsdp"), n_layers=DS_CUT_LAYERS)
    plan = make_plan(mesh, cfg, "decode")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
    torch.cuda.synchronize(dev)
    out = {"build_s": time.perf_counter() - t0, "build_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "weights_gib": torch.cuda.memory_allocated(dev) / 2**30}
    # the storage one forward assembles: every leaf the plan cut, whole, once
    # (the MLA up-projections in their de-shear, the banks and the router at
    # their layer, every other projection in its dispatch)
    cut = [w.data if isinstance(w, api.DipWeight) else w for nm, w in _dip_items(params, (api.DipWeight, torch.Tensor))
           if (isinstance(w, api.DipWeight) and w.plan.fsdp) or nm.split("/")[-1] in ("router", "w_gate", "w_up",
                                                                                       "w_down")]
    out["gathered_bytes"] = world * sum(t.numel() * t.element_size() for t in cut)
    out["shards"] = {nm: list(w.shape) for nm, w in _dip_items(params["layers"], torch.Tensor)
                     if nm in ("router", "w_gate", "w_up", "w_down")}
    out["shards"].update({nm: [list(w.data.shape), w.plan.kind, w.plan.fsdp]
                          for nm, w in _dip_items(params["layers"], api.DipWeight)})
    eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=DS_CUT_MAX_SEQ, prefill_chunk=DS_CUT_TOKENS),
                 device=dev, plan=plan)
    del params
    steps, profiled, first, ids = {}, {}, {}, []
    record_first_logits(eng, cfg.vocab_size, first)
    prefill = eng._prefill_fwd

    def recorded(p, c, t):  # each prefill call's expert ids, by layer
        trace = {}
        res = prefill(p, c, t, moe_trace=trace)
        ids.append([i.cpu().numpy() for i in trace["ids"]])
        return res

    eng._prefill_fwd = recorded
    _traced_steps(eng, dev, steps, profiled)
    for rid, p in enumerate(rec["prompts"]):
        eng.add_request(np.asarray(p), SamplingParams(max_new_tokens=2), rid=rid)
    dip_matmul.launches = dip_matmul.launches_f32 = 0
    t0 = time.perf_counter()
    results = eng.run()
    out.update({"results": results, "first_logits": first, "ids": ids, "steps": steps,
                "profiled_device_ms": profiled,
                "launches": {"dip_matmul": dip_matmul.launches, "dip_matmul_f32_x": dip_matmul.launches_f32},
                "wall_s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
                "eager_reason": eng.eager_reason,
                "pools": {k: list(v.shape) for k, v in eng.kv.pools["layers"].items()}})
    # where a prompt's choices differ from the single-rank step's: its prefill
    # again with those choices replayed (uncounted: not the served path)
    out["flips"] = [_choices_differing(a, b) for a, b in zip(ids, rec["ids"])]
    out["replayed_logits"] = {}
    step = tf_model.decode_step_fn(cfg, plan=plan)
    saved = dip_matmul.launches, dip_matmul.launches_f32
    for rid, flips in enumerate(out["flips"]):
        if flips:
            cache = tf_model.init_cache(cfg, 1, DS_CUT_MAX_SEQ, device=dev, plan=plan)
            trace = {"replay_ids": [torch.as_tensor(a, device=dev) for a in rec["ids"][rid]]}
            with torch.no_grad():
                logits = step(eng.params, cache, torch.as_tensor([rec["prompts"][rid]], device=dev), trace)[0]
            out["replayed_logits"][rid] = logits[0, -1, :cfg.vocab_size].float().cpu().numpy()
            del logits, cache
    dip_matmul.launches, dip_matmul.launches_f32 = saved
    # each launch shape on the gathered storage (every rank gathers each
    # weight's K shards, as dip_fsdp does)
    lyr = eng.params["layers"]

    def whole(w):
        return comm.all_gather(w.data[0] if w.data.dim() == 3 else w.data, mesh, "data", dim=0)

    g = {nm: whole(lyr[nm]) for nm in ("wq", "w_dkv", "w_krope", "wo", "shared_w_gate", "shared_w_up",
                                       "shared_w_down")}
    g["lm_head"] = whole(eng.params["lm_head"])
    col, res = dict(prologue="rmsnorm"), dict(epilogue="residual")
    shapes = []
    for m in (1, DS_CUT_TOKENS):
        shapes += [("wq", "gathered", m, [g["wq"]], col), ("w_dkv", "gathered", m, [g["w_dkv"]], col),
                   ("w_krope", "gathered", m, [g["w_krope"]], col), ("wo", "gathered", m, [g["wo"]], res),
                   ("shared gate+up", "gathered", m, [g["shared_w_gate"], g["shared_w_up"]],
                    dict(epilogue="swiglu")),
                   ("shared down", "gathered", m, [g["shared_w_down"]], {}),
                   ("lm_head", "gathered", m, [g["lm_head"]], {})]
    out["held_launches"] = _held_shapes(shapes, dev, SEED + 23)
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase9e_rank(rank, rec, reduced_prompts, rec_9k):
    """One rank of 9e's 2-rank world sharing the card (host transport):
    (a)-(e) at full width on phase 5d's weights and requests, then (f), then
    9k held to ``rec_9k``, then 10b (DeepSeek-V2-Lite trained under ``ep``).
    Returns numpy and numbers only."""
    import warnings

    import torch

    warnings.simplefilter("ignore", UserWarning)  # the width fallbacks (w_krope; the reduced widths) announce once
    out = _phase9e_serve(rec)
    out["f"] = _phase9e_reduced(reduced_prompts)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["9k"] = _phase9k(rec_9k)
    out["9k"]["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["10b"] = _phase10_model(train10_config("deepseek-v2-lite-16b"), train10_config("deepseek-v2-lite-16b", "ep"),
                                os.path.join(ROOT, "build", "chip_smoke_ckpt", "10b"), torch.device("cuda", 0),
                                replay=True)
    out["10b"]["world_phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------- phases 9f-9h: the ranks' side --
def zamba2_config(strategy=None):
    """Phase 5e's Zamba2-2.7B configuration (the launcher's: bf16,
    ``dip``), or under ``strategy`` its plan's (``dip_tp`` / ``dip_fsdp``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), matmul_backend="dip", param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    return cfg if strategy is None else dataclasses.replace(cfg, matmul_backend=f"dip_{strategy}",
                                                            sharding=strategy)


# phases 9c and 9e(d) serve the first two of their phase's requests (the time
# budget, PERF.md §4)
SHARDED_REQUESTS = 2
# 9i: greedy tokens a request under sp
SP_TOKENS = 8
# 9k: DeepSeek-V2-Lite under fsdp at full width cut to its first 2 of 27
# layers (each forward gathers ~1.17 GB a layer through host memory: the
# time budget, PERF.md §4), on two prompts cut to one 256-token chunk
DS_CUT_LAYERS = 2
DS_CUT_TOKENS = 256
DS_CUT_MAX_SEQ = 2 * DS_CUT_TOKENS  # 9k's engines' max_seq, and so the length of their prefill caches

# 9h: (name, arch, reduced() overrides, strategy): the reduced models in f32;
# zamba2_col's in_proj is column-parallel under tp (640 storage columns)
Z_REDUCED = (("zamba2_tp", "zamba2-2.7b", {}, "tp"), ("zamba2_col_tp", "zamba2-2.7b", {"ssm_state": 32}, "tp"),
             ("mamba2_tp", "mamba2-370m", {}, "tp"), ("llama3_fsdp", "llama3-8b", {}, "fsdp"),
             ("zamba2_fsdp", "zamba2-2.7b", {}, "fsdp"))
# 9l: the same under sp, and the moe family under fsdp
L_REDUCED = (("llama3_sp", "llama3-8b", {}, "sp"), ("zamba2_sp", "zamba2-2.7b", {}, "sp"),
             ("zamba2_col_sp", "zamba2-2.7b", {"ssm_state": 32}, "sp"), ("mamba2_sp", "mamba2-370m", {}, "sp"),
             ("deepseek_fsdp", "deepseek-v2-lite-16b", {}, "fsdp"), ("qwen3_fsdp", "qwen3-moe-235b-a22b", {}, "fsdp"))


def reduced_f32_config(arch, overrides, strategy=None):
    """9h's reduced model in f32 on ``dip``, or under ``strategy`` its
    plan's backend."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(**overrides), matmul_backend="dip",
                              compute_dtype="float32", param_dtype="float32")
    return cfg if strategy is None else dataclasses.replace(cfg, matmul_backend=f"dip_{strategy}", sharding=strategy)


def _dip_items(t, cls, path=""):
    """(path, weight) of every ``cls`` leaf of a parameter tree."""
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _dip_items(v, cls, f"{path}/{k}" if path else k)
    elif isinstance(t, cls):
        yield path, t


def _zamba2_served(strategy, prompts, max_new, params=None, mesh=None):
    """9f / 9g / 9j on this rank: Zamba2-2.7B at full width under
    ``strategy`` over the ranks sharing the card (``host`` transport), the
    rank drawing only its slice of phase 5e's weights from the seed
    (``init_params(plan=)``; 9j takes 9f's slice and mesh, ``params`` and
    ``mesh``), ``Engine(plan=)`` with 2 slots on ``prompts``: tokens,
    first-token logits, each step's kind, wall, collectives and launches,
    one profiled call of each kind, the pools' bytes, the rank's storage
    bytes, peak memory."""
    import torch

    from repro_torch import api
    from repro_torch.device import make_generator
    from repro_torch.distributed import make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    world = torch.distributed.get_world_size()
    axes = dict(data=1, model=world) if strategy in ("tp", "sp") else dict(data=world, model=1)
    if mesh is None:
        mesh = make_local_mesh(**axes, transport="host", device=dev)
    cfg = zamba2_config(strategy)
    plan = make_plan(mesh, cfg, "decode")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = {}
    if params is None:
        params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
        torch.cuda.synchronize(dev)
        out = {"build_s": time.perf_counter() - t0, "build_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    out["weights_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    dips = list(_dip_items(params, api.DipWeight))
    out["storage_bytes"] = sum(w.data.numel() * w.data.element_size() for _, w in dips)
    out["shards"] = {nm: [list(w.data.shape), w.plan.kind, w.plan.fsdp] for nm, w in dips}
    torch.cuda.reset_peak_memory_stats(dev)
    eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=1024, prefill_chunk=256), device=dev,
                 plan=plan)
    del params
    steps, profiled, first = {}, {}, {}
    record_first_logits(eng, cfg.vocab_size, first)
    _traced_steps(eng, dev, steps, profiled, kind_of=_step_kind)
    for rid, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=max_new), rid=rid)
    dip_matmul.launches = dip_matmul.launches_f32 = 0
    t0 = time.perf_counter()
    results = eng.run()
    pools = eng.kv.pools["layers"]
    out.update({"results": results, "first_logits": first, "steps": steps, "profiled_device_ms": profiled,
                "launches": {"dip_matmul": dip_matmul.launches, "dip_matmul_f32_x": dip_matmul.launches_f32},
                "wall_s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30, "eager_reason": eng.eager_reason,
                "captured": eng.captured, "pools": {k: list(v.shape) for k, v in pools.items() if k != "attn"},
                "state_pool_bytes": pools["state"].numel() * pools["state"].element_size(),
                "conv_pool_bytes": pools["conv"].numel() * pools["conv"].element_size(),
                "attn_pools": {k: list(v.shape) for k, v in pools["attn"].items()}})
    return eng, mesh, out


def _phase9f(rec):
    """9f on this rank: Zamba2-2.7B under ``tp``, then each launch shape of
    its forward on the rank's own storage against its plain version: the
    column shards (in_proj; the shared block's q, k, v and gate+up with
    the rmsnorm prologue; the lm_head) and the row partials (out_proj, wo,
    w_down: the f32 store), at M = 1 (the tail), 2 (a decode step's slots)
    and 256 (a chunk)."""
    import torch

    eng, mesh, out = _zamba2_served("tp", rec["tp_prompts"], 4)
    dev = torch.device("cuda", 0)
    lyr, sh = eng.params["layers"], eng.params["shared_attn"]

    def l0(w):
        return w.data[0] if w.data.dim() == 3 else w.data

    col, row = dict(prologue="rmsnorm"), dict(out_dtype=torch.float32)
    shapes = []
    for m in (1, 2, 256):
        shapes += [("in_proj", "column", m, [l0(lyr["in_proj"])], {}),
                   ("out_proj", "row", m, [l0(lyr["out_proj"])], row),
                   ("wq", "column", m, [l0(sh["wq"])], col), ("wk", "column", m, [l0(sh["wk"])], col),
                   ("wv", "column", m, [l0(sh["wv"])], col),
                   ("w_gate + w_up", "column", m, [l0(sh["w_gate"]), l0(sh["w_up"])], dict(col, epilogue="swiglu")),
                   ("wo", "row", m, [l0(sh["wo"])], row), ("w_down", "row", m, [l0(sh["w_down"])], row),
                   ("lm_head", "column", m, [eng.params["lm_head"].data], {})]
    out["held_launches"] = _held_shapes(shapes, dev, SEED + 13)
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, params, mesh


def _phase9j(rec, params, mesh):
    """9j on this rank: Zamba2-2.7B under ``sp`` on 9f's rank parameters and
    mesh (``dip_sp`` consumes ``tp``'s shards: nothing is drawn again), 9f's
    prompts, 4 greedy tokens each, then each launch shape of the forward
    against its plain version: the column shards (in_proj; the shared
    block's q, k, v and gate+up with the rmsnorm prologue; the lm_head) at
    the rank's 1 row (a tail token, rank 1's a pad row; a 2-slot decode) and
    128 (a chunk), the f32-store row partials (out_proj, wo, w_down) at all
    2 and 256 rows."""
    import torch

    eng, _, out = _zamba2_served("sp", rec["tp_prompts"], 4, params=params, mesh=mesh)
    dev = torch.device("cuda", 0)
    lyr, sh = eng.params["layers"], eng.params["shared_attn"]

    def l0(w):
        return w.data[0] if w.data.dim() == 3 else w.data

    col, row = dict(prologue="rmsnorm"), dict(out_dtype=torch.float32)
    shapes = []
    for m_col, m_row in ((1, 2), (128, 256)):
        shapes += [("in_proj", "column", m_col, [l0(lyr["in_proj"])], {}),
                   ("out_proj", "row", m_row, [l0(lyr["out_proj"])], row),
                   ("wq", "column", m_col, [l0(sh["wq"])], col), ("wk", "column", m_col, [l0(sh["wk"])], col),
                   ("wv", "column", m_col, [l0(sh["wv"])], col),
                   ("w_gate + w_up", "column", m_col, [l0(sh["w_gate"]), l0(sh["w_up"])],
                    dict(col, epilogue="swiglu")),
                   ("wo", "row", m_row, [l0(sh["wo"])], row), ("w_down", "row", m_row, [l0(sh["w_down"])], row),
                   ("lm_head", "column", m_col, [eng.params["lm_head"].data], {})]
    out["held_launches"] = _held_shapes(shapes, dev, SEED + 19)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _phase9g(rec):
    """9g on this rank: Zamba2-2.7B under ``fsdp``, then each launch shape
    of its forward on the gathered storage (every rank gathers each
    weight's K shards, as ``dip_fsdp`` does) against its plain version, at
    M = 1 (the tail, and a decode step's slot a rank) and 256 (a chunk):
    whole-width launches with the epilogues and prologues the forward
    fuses."""
    import torch

    from repro_torch.distributed import comm

    eng, mesh, out = _zamba2_served("fsdp", rec["fsdp_prompts"], 2)
    dev = torch.device("cuda", 0)
    lyr, sh = eng.params["layers"], eng.params["shared_attn"]

    def whole(w):
        return comm.all_gather(w.data[0] if w.data.dim() == 3 else w.data, mesh, "data", dim=0)

    g = {nm: whole(lyr[nm]) for nm in ("in_proj", "out_proj")}
    g.update({nm: whole(sh[nm]) for nm in ("wq", "wk", "wv", "w_gate", "w_up", "wo", "w_down")})
    g["lm_head"] = whole(eng.params["lm_head"])
    col, res = dict(prologue="rmsnorm"), dict(epilogue="residual")
    shapes = []
    for m in (1, 256):
        shapes += [("in_proj", "gathered", m, [g["in_proj"]], {}), ("out_proj", "gathered", m, [g["out_proj"]], res),
                   ("wq", "gathered", m, [g["wq"]], col), ("wk", "gathered", m, [g["wk"]], col),
                   ("wv", "gathered", m, [g["wv"]], col),
                   ("w_gate + w_up", "gathered", m, [g["w_gate"], g["w_up"]], dict(col, epilogue="swiglu")),
                   ("wo", "gathered", m, [g["wo"]], res), ("w_down", "gathered", m, [g["w_down"]], res),
                   ("lm_head", "gathered", m, [g["lm_head"]], {})]
    out["held_launches"] = _held_shapes(shapes, dev, SEED + 17)
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _phase9h(prompts, cases=Z_REDUCED):
    """9h / 9l on this rank: the reduced models in f32 under their plans
    (``Z_REDUCED`` / ``L_REDUCED``), seeded weights drawn on the card: each
    engine's tokens, DiP launches and replicated dispatches."""
    import torch

    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    dev = torch.device("cuda", 0)
    world = torch.distributed.get_world_size()
    meshes = {"tp": make_local_mesh(data=1, model=world, transport="host", device=dev),
              "fsdp": make_local_mesh(data=world, model=1, transport="host", device=dev)}
    meshes["sp"] = meshes["tp"]
    out = {}
    for name, arch, overrides, strategy in cases:
        cfg = reduced_f32_config(arch, overrides, strategy)
        plan = make_plan(meshes[strategy], cfg, "decode")
        params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=64, prefill_chunk=16), device=dev,
                     plan=plan)
        for rid, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(max_new_tokens=8), rid=rid)
        dip_matmul.launches = dip_matmul.launches_f32 = 0
        comm.reset()
        out[name] = {"results": eng.run(), "dip_launches": dip_matmul.launches,
                     "dip_f32_x_launches": dip_matmul.launches_f32, "replicated": comm.replicated(),
                     "in_proj": getattr(eng.params["layers"].get("in_proj"), "plan", None) and
                     eng.params["layers"]["in_proj"].plan.kind}
    return out


def phase9z_rank(rank, rec, reduced_prompts):
    """One rank of the 2-rank world of phases 9f-9h, 9j and 9l sharing the
    card (host transport): 9f on phase 5e's weights, 9j on 9f's rank
    parameters, 9g, then 9h and 9l.  Returns numpy and numbers only."""
    import warnings

    import torch

    warnings.simplefilter("ignore", UserWarning)  # the reduced widths replicate (announced once)
    out = {}
    out["9f"], params, mesh = _phase9f(rec)
    t0 = time.perf_counter()
    out["9j"] = _phase9j(rec, params, mesh)
    out["9j"]["phase_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["9g"] = _phase9g(rec)
    out["9h"] = _phase9h(reduced_prompts)
    t0 = time.perf_counter()
    out["9l"] = _phase9h(reduced_prompts, L_REDUCED)
    out["9l_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------ phase 10: the ranks' side --
TRAIN10_STEPS = 3  # 10a / 10b: AdamW steps under the plan
TRAIN10_BATCH = (2, 1024)  # 10a / 10b: rows x tokens of each step's batch
TRAIN10_LR = 1e-4
TRAIN10_LAYERS = 2  # phase 6's and 6b's cut
# 10a / 10b: one step's collectives and launches a rank (forward, block
# remat's reruns, backward, the whole leaves' psum and the norm's), the
# counts tests/test_torch_sharded_train_models.py pins on configurations
# that split every projection as the full widths do
TRAIN10_COUNTS = {
    "10a": dict(psum=14, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=25),
    "10b": dict(psum=16, all_gather=7, reduce_scatter=5, ppermute=0, all_to_all=12, launch=21),
}
# 10a / 10b: one step's dip_matmul launches a rank: the shard launches, and
# under ep w_krope's (64 columns split into no 64-tile shard, so the rank
# runs the whole weight) in each layer's forward and remat rerun
TRAIN10_DIP = {"10a": 25, "10b": 25}
# 10c: (strategy, family) -> the reduced configuration of the CPU tests'
# pairs (tests/_torch_train_pairs.py: f32, batch 2 x 32) and one step's
# collectives and launches a rank, the counts those tests pin
TRAIN10_FAMILIES = {"dense": "llama3-8b", "moe": "deepseek-v2-lite-16b", "ssm": "mamba2-370m",
                    "hybrid": "zamba2-2.7b"}
TRAIN10_PAIRS = {
    ("tp", "dense"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=9),
    ("fsdp", "dense"): dict(psum=2, all_gather=17, reduce_scatter=17, ppermute=0, all_to_all=0, launch=13),
    ("sp", "dense"): dict(psum=2, all_gather=10, reduce_scatter=10, ppermute=10, all_to_all=0, launch=14),
    ("ep", "dense"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=9),
    ("tp", "moe"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=3),
    ("fsdp", "moe"): dict(psum=6, all_gather=29, reduce_scatter=29, ppermute=0, all_to_all=0, launch=13),
    ("ep", "moe"): dict(psum=12, all_gather=3, reduce_scatter=3, ppermute=0, all_to_all=8, launch=7),
    ("tp", "ssm"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=2),
    ("fsdp", "ssm"): dict(psum=2, all_gather=7, reduce_scatter=7, ppermute=0, all_to_all=0, launch=4),
    ("sp", "ssm"): dict(psum=6, all_gather=7, reduce_scatter=7, ppermute=0, all_to_all=0, launch=2),
    ("tp", "hybrid"): dict(psum=28, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=13),
    ("fsdp", "hybrid"): dict(psum=2, all_gather=25, reduce_scatter=25, ppermute=0, all_to_all=0, launch=21),
    ("sp", "hybrid"): dict(psum=10, all_gather=18, reduce_scatter=18, ppermute=10, all_to_all=0, launch=18),
    ("pp", "dense"): dict(psum=4, all_gather=0, reduce_scatter=0, ppermute=10, all_to_all=0, launch=0),
}


# 10c: the checkpoint drill (save at step 2 under the plan, the one-rank
# restore, the same mesh's resume) on these pairs' reduced models, batch 2 x 32
# (pp: 4 x 32, and from step 2 the compressing AdamW, so that the checkpoint
# holds the transform's error-feedback buffers)
TRAIN10_DRILLS = (("tp", "dense"), ("ep", "moe"), ("fsdp", "hybrid"), ("sp", "ssm"), ("pp", "dense"))
# 10c's pp pair runs 4 rows in the default 4 microbatches (2 x stages)
TRAIN10_ROWS = {"pp": 4}
# 10d: llama3-8b over 2 pipeline stages at full width, cut to 2 layers (1 a
# stage) and batch 4 x 256 in 4 microbatches (4 layers at 4 x 1024, then 2
# layers at 4 x 1024 and at 4 x 512, ran out of the card's memory with both
# ranks on it: the untied embedding and head with their moments and buffers
# on each rank, the replicated head's f32 logits and their backward, PERF.md
# §4); a step's collectives a rank: 6
# ticks' ppermutes forward and 4 reverse hops, 4 psums (the outputs'
# broadcast, its transpose, the whole leaves' shares, the norm), as
# tests/test_torch_pipeline_train.py pins them on pp_t; from step 2 (10e) a
# pmax of the compressed leaves' maxima (tests/test_torch_compression.py);
# DiP launches: 6 ticks x the stage's layers x 6 + the head
TRAIN10D_LAYERS = 2
TRAIN10D_BATCH = (4, 256)
TRAIN10_COUNTS["10d"] = dict(psum=4, all_gather=0, reduce_scatter=0, ppermute=10, all_to_all=0, launch=0)
TRAIN10_DIP["10d"] = 6 * (TRAIN10D_LAYERS // 2) * 6 + 1
# 10e: one compressed step of the reduced f32 pp and tp pairs against the
# single-rank compressed step on the card, batch 4 x 32 (pp: 2 microbatches),
# the counts tests/test_torch_compression.py pins
TRAIN10E_PAIRS = {
    "pp": dict(psum=4, all_gather=0, reduce_scatter=0, ppermute=6, all_to_all=0, launch=0, pmax=1),
    "tp": dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=9, pmax=1),
}


def train10_reduced_config(fam):
    """10c's reduced ``fam`` configuration in f32 on ``dip`` (the CPU
    tests' pairs)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN10_FAMILIES[fam]).reduced(), matmul_backend="dip",
                               compute_dtype="float32", param_dtype="float32")


def train10_config(arch, strategy=None, layers=TRAIN10_LAYERS):
    """10a / 10b / 10d's configuration: ``arch`` at full width cut to
    ``layers`` layers, phase 6's settings (f32 parameters, bf16 compute,
    block remat) on ``dip``, or under ``strategy`` its plan's (``pp``'s
    stages keep ``dip``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), matmul_backend="dip", n_layers=layers)
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat) == ("float32", "bfloat16", "block")
    return cfg if strategy is None else _plan_config(cfg, strategy)


def _plan_config(cfg, strategy):
    """``cfg`` under ``strategy``: its sharded backend, or under ``pp`` the
    config's own (a stage axis, not a backend)."""
    backend = cfg.matmul_backend if strategy == "pp" else f"dip_{strategy}"
    return dataclasses.replace(cfg, sharding=strategy, matmul_backend=backend)


def _train_mesh(strategy, dev):
    """The 2-rank training mesh of ``strategy`` on the card (host
    transport): the data axis under ``fsdp``, the stage axis under ``pp``,
    the model axis otherwise."""
    import torch

    from repro_torch.distributed import make_local_mesh

    return make_local_mesh(**_mesh_axes(strategy), transport="host" if dev.type == "cuda" else None, device=dev)


def _mesh_axes(strategy):
    """The axes of ``strategy``'s training mesh over the world's ranks."""
    import torch

    t = torch.distributed.get_world_size()
    return {"fsdp": dict(data=t, model=1), "pp": dict(data=1, model=1, stage=t)}.get(strategy, dict(data=1, model=t))


def _in_turn(fn):
    """``fn()`` on each rank in turn (a barrier between turns), so that two
    ranks sharing the card never hold its transients at once."""
    import torch

    out = None
    for r in range(torch.distributed.get_world_size()):
        if torch.distributed.get_rank() == r:
            out = fn()
        torch.distributed.barrier()
    return out


def _crcs(t):
    """The crc32 of every leaf's bytes of the tree ``t``, in ``tree.leaves``
    order (a device leaf copied to the host first)."""
    import zlib

    import numpy as np
    import torch

    from repro_torch import tree

    return [zlib.crc32(np.ascontiguousarray(leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()))
            for leaf in tree.leaves(t)]


def _empty_state(cfg, opt, device):
    """A whole-shaped train state on ``device`` (uninitialized parameters,
    zero moments): the target of a one-rank restore."""
    import torch

    from repro_torch import api
    from repro_torch.device import dtype_of
    from repro_torch.models import transformer as tf_model

    def build(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = build(v)
                continue
            shape, dt, _, dip = v
            data = torch.empty(shape, dtype=dtype_of(dt), device=device)
            out[k] = data if dip is None else api.DipWeight(data, *dip)
        return out

    params = build(tf_model.param_template(cfg))
    return {"params": params, "opt_state": opt.init(params), "step": 0}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiled_step(step, state, batch, dev):
    """One training step under the profiler: (new state, metrics, kernel
    device ms, copy device ms)."""
    import torch

    if dev.type != "cuda":
        state, m = step(state, batch)
        return state, m, 0.0, 0.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
    kernel = copy = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            ms = (us if us is not None else e.self_cuda_time_total) / 1e3
            if "memcpy" in e.key.lower() or "memset" in e.key.lower():
                copy += ms
            else:
                kernel += ms
    return state, m, kernel, copy


def _phase10_model(cfg, plan_cfg, ckpt_dir, dev, replay=False, checkpoint=False, batch=TRAIN10_BATCH,
                   compress=False):
    """10a / 10b / 10d on this rank: ``cfg`` (the single-rank configuration
    at full width, cut in depth) trained under ``plan_cfg``'s strategy over
    the 2 ranks sharing the card.  The first step's loss, global norm and
    every leaf's gradient slice against the single-rank step on the same
    whole weights and batch (each rank runs it in turn and keeps its slices
    in host memory; ``replay``: the single-rank run routes with the ranks'
    expert ids, their layers' ids all-gathered); steps 2 and 3; a
    checkpoint at step 2 (every rank gathers, rank 0 writes); that
    checkpoint restored on one rank (on the host, no plan), cut to this
    rank's slices, bit-equal to its live step-2 slices; restored on the
    same mesh, giving step 3 bit for bit.  Each step's collectives and
    launches, walls, a profiled step's kernel and copy device ms, peak
    memory.  The checkpoint drill runs with ``checkpoint`` only
    (``tools/torch_sharded_ckpt.py`` at full width, 10c on the reduced
    models: phase 10's full-width states are 18 GB, PERF.md §4); ``batch``
    is (rows, tokens).

    ``compress`` (10e): the first step's gradients also go through the
    compression transform with a fresh error-feedback buffer and the
    whole leaves' scales (``comm.pmax``), held against the single-rank
    step's gradients compressed whole: each leaf's scale, the slices'
    relative L2, the codes one apart (excused, counted) and further apart
    (counted), the compressed norm; steps 2 and 3 then take the
    compressing AdamW (``--compress-grads``; its buffers join the state,
    and the step-2 checkpoint)."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, compression_transform, make_plan
    from repro_torch.distributed.compression import dequantize_int8, quantize_int8
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lm_head_ce as ce
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import global_norm

    def reset_launches():
        comm.reset()
        dip_matmul.launches = dip_matmul.launches_f32 = ce.lm_head_ce.launches = fa.flash_attention.launches = 0

    def launches():
        return {"counts": comm.counts(), "dip_launches": dip_matmul.launches, "dip_f32_x": dip_matmul.launches_f32,
                "lm_head_ce": ce.lm_head_ce.launches, "flash": fa.flash_attention.launches}

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 recompute backward: IEEE products
    mesh = _train_mesh(plan_cfg.sharding, dev)
    plan = make_plan(mesh, plan_cfg, "train")
    axis = tf_model._rank_axis(plan)
    rows, seq = batch
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows, seed=SEED)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in data.batch(i).items()} for i in range(TRAIN10_STEPS)]
    out = {"layers": cfg.n_layers, "compressed_from_step": 2 if compress else None}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    opt = AdamW(lr=TRAIN10_LR)
    step = tf_model.train_step_fn(plan_cfg, opt, plan=plan)

    def sharded_first(params):
        trace = {} if cfg.is_moe else None
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        loss, grads, gnorm = step.loss_and_grads(params, batches[0], moe_trace=trace)
        _sync(dev)
        rec = dict(launches(), wall_ms=1e3 * (time.perf_counter() - t0), loss=float(loss), grad_norm=float(gnorm))
        if trace is not None:
            rec["dropped"] = [int(d) for d in trace["dropped"]]
        return loss, grads, gnorm, trace, rec

    def single(ids=None):
        """The single-rank step's loss, global norm and this rank's slices of
        its gradients (unfused loss, as the plan's), in host memory, in
        turn on each rank; with ``compress`` also its gradients compressed
        whole (a zero buffer: each leaf's own quantization), their norm,
        this rank's slices of them and each leaf's scale."""
        def run():
            whole = tf_model.init_params(cfg, make_generator(SEED, dev), dev)
            trace = None if ids is None else {"replay_ids": ids}
            leaves = [t.requires_grad_(True) for t in tree.leaves(whole)]
            loss = tf_model.loss_fn(whole, cfg, batches[0], fused_ce=False, moe_trace=trace)
            grads = list(torch.autograd.grad(loss, leaves))
            gn = float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)))

            def mine(flat):
                return [t.detach().to("cpu") for t in tree.leaves(plan.shard_params(tree.unflatten(whole, flat)))]

            got = {"loss": float(loss), "grad_norm": gn, "grads": mine(grads),
                   "dropped": None if trace is None else [int(d) for d in trace["dropped"]]}
            if compress:
                scales = []
                for k, g in enumerate(grads):  # leaf by leaf: one leaf's transients at a time
                    q, sc = quantize_int8(g.detach())
                    grads[k] = dequantize_int8(q, sc).to(g.dtype)
                    scales.append(float(sc))
                got.update(scales=scales, compressed=mine(grads),
                           compressed_norm=float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))))
            del whole, leaves, grads
            if cuda:
                torch.cuda.empty_cache()
            return got
        return _in_turn(run)

    t_phase = time.perf_counter()
    if not replay:
        want = single()
    params = tf_model.init_params(plan_cfg, make_generator(SEED, dev), dev, plan=plan)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    loss, grads, gnorm, trace, first = sharded_first(params)
    if replay:  # every layer's ids of the whole batch: the ranks' rows in order (ep's batch split)
        ids = [comm.all_gather(i, mesh, plan.tp, dim=0) for i in trace["ids"]]
        want = single(ids)
    paths = [p for p, _ in tree.paths(params)]
    rel = {p: rel_l2(g, w.to(g.device)) for p, g, w in zip(paths, tree.leaves(grads), want["grads"])}
    first.update(single_loss=want["loss"], single_grad_norm=want["grad_norm"], single_dropped=want["dropped"],
                 worst_leaf=max((v, k) for k, v in rel.items()))
    opt.update(grads, state["opt_state"], params, gnorm=gnorm)
    state["step"] = 1
    if compress:
        # the step-1 gradients compressed as a compressing step would (the
        # update above read them already), against the single-rank step's
        gt = compression_transform()
        flat = tree.leaves(grads)
        local = torch.stack([g.detach().float().abs().amax() for g in flat])
        amax = comm.pmax(local, mesh, axis)  # the whole leaves' maxima, to read each leaf's scale back
        err = gt.init(grads)
        grads, err = gt.fn(grads, err, reduce_max=lambda t: comm.pmax(t, mesh, axis))
        del err  # the step's buffers come fresh below
        flat = tree.leaves(grads)
        cnorm = global_norm(flat, replicated=tf_model.replicated_parts(params, plan_cfg),
                            psum=lambda t: comm.psum(t, mesh, axis))
        if cuda:
            torch.cuda.empty_cache()
        scale_err, codes = 0.0, {"elements": 0, "one_apart": 0, "further": 0}
        crel = {}
        for p, g, w, s_ref, m in zip(paths, flat, want["compressed"], want["scales"], amax.tolist()):
            s_got = m / 127.0 + 1e-12
            scale_err = max(scale_err, abs(s_got - s_ref) / s_ref)
            sg = torch.full((), s_got, dtype=torch.float32, device=g.device)
            sr = torch.full((), s_ref, dtype=torch.float32, device=g.device)
            num = den = 0.0
            rows_at = max(1, 2**24 // max(1, g[0].numel())) if g.dim() else 1
            # in blocks of rows: a full-width embedding's transients are a block's
            for gb, wb in zip(g.detach().reshape(-1, *g.shape[1:]).split(rows_at),
                              w.reshape(-1, *w.shape[1:]).split(rows_at)):
                gb, wb = gb.float(), wb.to(g.device).float()
                apart = (torch.round(gb / sg) - torch.round(wb / sr)).abs()
                codes["elements"] += apart.numel()
                codes["one_apart"] += int((apart == 1).sum())
                codes["further"] += int((apart > 1).sum())
                same = apart == 0  # the excused elements, codes apart, left out of the slice's error
                num += float(torch.square(gb[same] - wb[same]).sum())
                den += float(torch.square(wb[same]).sum())
            crel[p] = (num ** 0.5) / max(den ** 0.5, 1e-30)
        first["compressed"] = dict(codes, scale_rel_err=scale_err, worst_leaf=max((v, k) for k, v in crel.items()),
                                   grad_norm=float(cnorm), single_grad_norm=want["compressed_norm"])
        del flat
        grads = None
        if cuda:
            torch.cuda.empty_cache()
        # from step 2 the compressing AdamW: the same moments, its buffers added
        opt = AdamW(lr=TRAIN10_LR, grad_transform=gt)
        state["opt_state"]["transform"] = gt.init(params)
        step = tf_model.train_step_fn(plan_cfg, opt, plan=plan)
    del want, grads, loss
    steps = [first]
    ckpt = CheckpointManager(ckpt_dir, keep=1)
    for i in (1, 2):
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        if i == 1:
            state, m, kms, cms = _profiled_step(step, state, batches[i], dev)
        else:
            state, m = step(state, batches[i])
            _sync(dev)
        rec = dict(launches(), wall_ms=1e3 * (time.perf_counter() - t0), loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]))
        if i == 1:
            rec.update(profiled=True, kernel_device_ms=kms, copy_device_ms=cms)
        if plan.strategy == "pp":  # the leaves every stage holds whole: alike on the ranks
            rec["whole_crc"] = _crcs({k: state["params"][k] for k in ("embed", "final_norm", "lm_head")
                                      if k in state["params"]})
        if i == 1 and checkpoint:
            # the checkpoint at step 2: gathered on every rank, written by rank 0
            t0 = time.perf_counter()
            ckpt.save(2, state, plan=plan, blocking=True)
            torch.distributed.barrier()
            out["save_s"] = time.perf_counter() - t0
            # restored on one rank (rank 0: the whole state on the host, no
            # plan), each leaf cut to every rank's slice: the slices' crc32
            # against each rank's live step-2 slices' (compared on the main side)
            kept = ("mu", "nu", "transform") if compress else ("mu", "nu")
            out["live_crc"] = _crcs({"params": state["params"], **{k: state["opt_state"][k] for k in kept}})
            if torch.distributed.get_rank() == 0:
                host = CheckpointManager(ckpt_dir, keep=1).restore(_empty_state(cfg, opt, "cpu"), step=2)[0]
                out["one_rank_crc"] = []
                for coord in range(mesh.size):
                    cut = make_plan(comm.Mesh(dict(mesh.shape), rank=coord), plan_cfg, "train")
                    out["one_rank_crc"].append(_crcs({"params": cut.shard_params(host["params"]),
                                                      **{k: cut.shard_params(host["opt_state"][k]) for k in kept}}))
                del host
            torch.distributed.barrier()
            out["one_rank_s"] = time.perf_counter() - t0
        steps.append(rec)
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["peak_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
    if checkpoint:
        after = [t.detach().cpu() for t in tree.leaves(state["params"])]  # in host memory: 10d's are 5 GB
        # the same mesh resumes from the step-2 checkpoint: step 3 bit for bit
        t0 = time.perf_counter()
        state, meta = ckpt.restore(state, step=2, plan=plan)
        out["restore_s"] = time.perf_counter() - t0
        state, m = step(state, batches[2])
        out["resumed"] = {"step": int(meta["step"]), "loss": float(m["loss"]),
                          "loss_equal": float(m["loss"]) == steps[2]["loss"],
                          "params_equal": all(torch.equal(a, b.detach().cpu())
                                              for a, b in zip(after, tree.leaves(state["params"])))}
        del after
    out["steps"] = steps
    out["phase_s"] = time.perf_counter() - t_phase
    del state, params, step, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if torch.distributed.get_rank() == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def _phase10c(dev):
    """10c on this rank: one ``train_step_fn(plan=)`` step of every
    (strategy, family) pair of ``TRAIN10_PAIRS`` on the reduced f32 models
    (each rank draws its slice of the seeded weights on the card), against
    the single-rank step on the card through the same kernels: the loss,
    and every parameter leaf after the step gathered whole; the step's
    collectives and launches.  Returns, a pair, the largest errors and the
    counts."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    meshes, out = {}, {}
    lr = 1e-3
    b2, eps = AdamW().b2, AdamW().eps
    for (strategy, fam), want_counts in TRAIN10_PAIRS.items():
        base = train10_reduced_config(fam)
        cfg = _plan_config(base, strategy)
        mesh = meshes.setdefault(tuple(_mesh_axes(strategy).items()), _train_mesh(strategy, dev))
        plan = make_plan(mesh, cfg, "train")
        rows = TRAIN10_ROWS.get(strategy, 2)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                                                                        global_batch=rows).batch(1).items()}
        whole = tf_model.init_params(base, make_generator(SEED, dev), dev)
        opt = AdamW(lr=lr)
        ref = {"params": whole, "opt_state": opt.init(whole), "step": 0}
        ref, rm = tf_model.train_step_fn(base, opt, fused_ce=False)(ref, batch)
        params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        comm.reset()
        dip_matmul.launches = dip_matmul.launches_f32 = 0
        state, m = tf_model.train_step_fn(cfg, opt, plan=plan)(state, batch)
        counts, launches, f32_x = comm.counts(), dip_matmul.launches, dip_matmul.launches_f32
        got = tree.leaves(plan.gather_params(state["params"]))
        worst_clear = worst = 0.0
        for g, w, nu in zip(got, tree.leaves(ref["params"]), tree.leaves(ref["opt_state"]["nu"])):
            err = (g - w).abs()
            clear = torch.sqrt(nu / (1 - b2)) > 1000 * eps
            scale = max(1.0, float(w.abs().max()))
            worst_clear = max(worst_clear, float(err[clear].max()) / scale if clear.any() else 0.0)
            worst = max(worst, float(err.max()))
        out[f"{strategy}/{fam}"] = {"loss": (float(m["loss"]), float(rm["loss"])),
                                   "grad_norm": (float(m["grad_norm"]), float(rm["grad_norm"])),
                                   "param_err_clear": worst_clear, "param_err": worst, "counts": counts,
                                   "want_counts": want_counts, "dip_launches": launches, "f32_x_launches": f32_x,
                                   "lr": lr}
        del whole, ref, params, state, got
    return out


def _phase10e(dev):
    """10e on this rank: one compressed step (``AdamW(grad_transform=
    compression_transform())``) of the reduced f32 dense model under ``pp``
    (2 microbatches) and under ``tp``, against the single-rank compressed
    step on the card through the same kernels: the loss, the compressed
    gradients' norm, every parameter after the step gathered whole (the
    elements a code at a rounding boundary moved by up to 2 lr counted),
    the counts; and ``compressed_psum`` of this rank's row of
    ``arange(16).reshape(2, 8) / 7``."""
    import torch

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.distributed import (comm, compressed_psum, compression_transform, make_plan,
                                         pipeline_train_step_fn)
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    lr, out = 1e-3, {}
    base = train10_reduced_config("dense")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in SyntheticLM(vocab_size=base.vocab_size, seq_len=32,
                                                                    global_batch=4).batch(1).items()}
    for strategy, want_counts in TRAIN10E_PAIRS.items():
        cfg = _plan_config(base, strategy)
        plan = make_plan(_train_mesh(strategy, dev), cfg, "train")
        whole = tf_model.init_params(base, make_generator(SEED, dev), dev)
        opt = AdamW(lr=lr, grad_transform=compression_transform())
        ref, rm = tf_model.train_step_fn(base, opt, fused_ce=False)(
            {"params": whole, "opt_state": opt.init(whole), "step": 0}, batch)
        params = tf_model.init_params(cfg, make_generator(SEED, dev), dev, plan=plan)
        opt = AdamW(lr=lr, grad_transform=compression_transform())
        step = (pipeline_train_step_fn(cfg, opt, plan, n_micro=2) if strategy == "pp"
                else tf_model.train_step_fn(cfg, opt, plan=plan))
        comm.reset()
        dip_matmul.launches = dip_matmul.launches_f32 = 0
        state, m = step({"params": params, "opt_state": opt.init(params), "step": 0}, batch)
        rec = {"loss": (float(m["loss"]), float(rm["loss"])), "grad_norm": (float(m["grad_norm"]),
               float(rm["grad_norm"])), "counts": comm.counts(), "want_counts": want_counts,
               "dip_launches": dip_matmul.launches, "f32_x_launches": dip_matmul.launches_f32, "lr": lr}
        worst = worst_clear = 0.0
        excused = total = 0
        for g, w in zip(tree.leaves(plan.gather_params(state["params"])), tree.leaves(ref["params"])):
            err = (g - w).detach().abs()
            base_tol = 1e-4 * max(1.0, float(w.detach().abs().max()))
            over = err > base_tol
            excused += int(over.sum())
            total += err.numel()
            worst = max(worst, float(err.max()))
            worst_clear = max(worst_clear, float(err[~over].max()) / (base_tol / 1e-4) if (~over).any() else 0.0)
        rec.update(param_err=worst, param_err_clear=worst_clear, excused=excused, elements=total)
        out[strategy] = rec
        del whole, ref, params, state
    # made on the host: CUDA divides by a Python scalar through its rounded reciprocal
    x = (torch.arange(16, dtype=torch.float32).reshape(2, 8) / 7.0).to(dev)
    mesh = _train_mesh("tp", dev)
    comm.reset()
    out["compressed_psum"] = {"got": compressed_psum(x[mesh.coord("model")], mesh, "model").cpu().numpy(),
                              "counts": comm.counts()}
    return out


def check_train10e(ranks_out, gpu):
    """10e on the main side: each compressed pair's loss and compressed
    norm within 1e-4 of the single-rank compressed step's, every parameter
    within 1e-4 of max(1, |leaf|) but the excused elements (at most 2 lr
    off, at most 1 in 1000), the CPU tests' counts, every launch f32 x;
    ``compressed_psum`` equal to its numpy formula."""
    import numpy as np

    log(f"phase 10e: one compressed step (int8 gradients with error feedback) of the reduced f32 dense model under "
        f"pp and tp over 2 ranks against the single-rank compressed step on the card; the rank's wall "
        f"{[round(o['phase_s'], 1) for o in ranks_out]} s")
    rows = {}
    for strategy in TRAIN10E_PAIRS:
        for r, o in enumerate(ranks_out):
            g = o[strategy]
            (lk, lp), (nk, npl) = g["loss"], g["grad_norm"]
            ok = (abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)) and abs(nk - npl) <= 1e-4 * max(1.0, npl)
                  and g["param_err"] <= 1e-4 + 2 * g["lr"] and g["excused"] <= g["elements"] // 1000
                  and g["counts"] == g["want_counts"] and g["dip_launches"] == g["f32_x_launches"] > 0)
            if not ok:
                raise AssertionError(f"phase 10e {strategy} rank {r}: {g}")
        g = ranks_out[0][strategy]
        rows[strategy] = {k: g[k] for k in ("loss", "grad_norm", "param_err_clear", "param_err", "excused",
                                            "elements", "counts", "dip_launches")}
        log(f"  {strategy}: loss {g['loss'][0]:.7f} / single {g['loss'][1]:.7f}, compressed norm "
            f"{g['grad_norm'][0]:.6f} / {g['grad_norm'][1]:.6f}, parameters after the step max|err| "
            f"{g['param_err_clear']:.2e} of max(1, |leaf|) but {g['excused']} of {g['elements']} elements excused "
            f"(a code at a rounding boundary; {g['param_err']:.2e} anywhere, bound {1e-4 + 2 * g['lr']:.1e}), "
            f"{g['counts']} a step and rank, {g['dip_launches']} dip_matmul launches, every one f32 x ({gpu})")
    x = np.arange(16, dtype=np.float32).reshape(2, 8) / np.float32(7.0)
    scale = np.float32(max(np.float32(np.abs(row).max()) / np.float32(127.0) + np.float32(1e-12) for row in x))
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int32)
    want = (q.sum(0).astype(np.float32) * scale / np.float32(2.0)).astype(np.float32)
    for r, o in enumerate(ranks_out):
        c = o["compressed_psum"]
        if c["got"].tobytes() != want.tobytes() or c["counts"].get("pmax") != 1 or c["counts"]["psum"] != 1:
            raise AssertionError(f"phase 10e rank {r}: compressed_psum {c} against the numpy formula {want}")
    log(f"  compressed_psum over the 2 ranks: {want.tolist()}, bit-equal to the numpy formula on both ranks "
        f"(one pmax, one psum)")
    return {"pairs": rows, "compressed_psum": want.tolist(),
            "dip_matmul": sum(o[s]["dip_launches"] for o in ranks_out for s in TRAIN10E_PAIRS)}


def check_train10(tag, ranks_out, what, gpu, want=None, want_dip=None, dtype="bfloat16"):
    """10a / 10b on the main side (``gpu``: the card's nvidia-smi line;
    ``want`` / ``want_dip``: a step's collectives and launches, and its
    dip_matmul launches, by default ``TRAIN10_COUNTS`` / ``TRAIN10_DIP``):
    the first step against the single-rank step (``FIRST_STEP_TOL[dtype]``),
    each step's collectives and launches exactly (bf16: every launch on the
    tensor cores; f32: every one on the f32-x route), no lm_head_ce and no
    flash, finite losses, the ranks alike; where the checkpoint drill ran,
    the resume bit for bit and the one-rank restore bit-equal (crc32 of
    every leaf); the walls, device ms and peak memory printed."""
    import numpy as np

    want = TRAIN10_COUNTS[tag] if want is None else want
    want_dip = TRAIN10_DIP[tag] if want_dip is None else want_dip
    tl, tn, tg = FIRST_STEP_TOL[dtype]
    compressed_from = ranks_out[0].get("compressed_from_step")
    log(f"phase {tag}: {what}, {ranks_out[0]['layers']} layers, over 2 ranks sharing the card (host transport); "
        f"the rank's wall {[round(o['world_phase_s'], 1) for o in ranks_out]} s")
    per_rank = []
    for r, o in enumerate(ranks_out):
        first = o["steps"][0]
        lk, lp, nk, npl = first["loss"], first["single_loss"], first["grad_norm"], first["single_grad_norm"]
        err, path = first["worst_leaf"]
        ok = (abs(lk - lp) <= tl * max(1.0, abs(lp)), abs(nk - npl) <= tn * max(1.0, npl), err <= tg)
        log(f"  rank {r} first step, sharded / single-rank: loss {lk:.6f} / {lp:.6f}, gradient norm {nk:.5f} / "
            f"{npl:.5f}, worst gradient slice relative L2 {err:.2e} ({path}); limits {tl:g}, {tn:g}, {tg:g}: "
            f"{'within' if all(ok) else 'FAIL'}")
        if not all(ok):
            raise AssertionError(f"phase {tag} rank {r}: the first sharded step differs from the single-rank one")
        if "dropped" in first:
            log(f"  rank {r} dropped (token, slot) pairs by layer, sharded / single-rank replaying its ids: "
                f"{first['dropped']} / {first['single_dropped']}")
            if first["dropped"] != first["single_dropped"]:
                raise AssertionError(f"phase {tag}: the replayed single-rank step dropped other pairs")
        if "compressed" in first:
            # the first step's gradients compressed under the plan against the
            # single-rank step's compressed whole: the slices within the
            # gradient bound, each leaf's scale within the norm's, a code one
            # apart excused and counted (bf16 moves a value across a rounding
            # boundary), codes further apart at most 1 in 10^4
            c = first["compressed"]
            ok = (c["worst_leaf"][0] <= tg and c["scale_rel_err"] <= tn and c["further"] <= c["elements"] // 10**4
                  and abs(c["grad_norm"] - c["single_grad_norm"]) <= tn * max(1.0, c["single_grad_norm"]))
            log(f"  rank {r} first step's gradients compressed (int8, the whole leaves' scales by pmax) / the "
                f"single-rank step's compressed whole: norm {c['grad_norm']:.5f} / {c['single_grad_norm']:.5f}, "
                f"worst slice relative L2 {c['worst_leaf'][0]:.2e} ({c['worst_leaf'][1]}), scales within "
                f"{c['scale_rel_err']:.2e}; codes one apart (excused) {c['one_apart']} and further apart "
                f"{c['further']} of {c['elements']}; limits {tg:g}, {tn:g}, 1e-4 of the elements: "
                f"{'within' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"phase {tag} rank {r}: the compressed first step differs from the "
                                     "single-rank one")
        for i, st in enumerate(o["steps"]):
            want_i = dict(want, pmax=1) if compressed_from and i + 1 >= compressed_from else want
            route_ok = st["dip_f32_x"] == (st["dip_launches"] if dtype == "float32" else 0)
            bad = (st["counts"] != want_i or st["dip_launches"] != want_dip or not route_ok
                   or st["lm_head_ce"] or st["flash"] or not np.isfinite(st["loss"]))
            if bad:
                raise AssertionError(f"phase {tag} rank {r} step {i + 1}: {st} (want {want_i}, {want_dip} "
                                     f"dip_matmul launches, each {dtype} x, no lm_head_ce, no flash, a finite loss)")
            if "whole_crc" in st and st["whole_crc"] != ranks_out[0]["steps"][i]["whole_crc"]:
                raise AssertionError(f"phase {tag} rank {r} step {i + 1}: embed / final_norm / lm_head differ "
                                     "between the ranks")
        rec = {"rank": r, "losses": [st["loss"] for st in o["steps"]],
               "grad_norms": [st["grad_norm"] for st in o["steps"]],
               "step_wall_ms": [st["wall_ms"] for st in o["steps"]],
               "step2_kernel_device_ms": o["steps"][1]["kernel_device_ms"],
               "step2_copy_device_ms": o["steps"][1]["copy_device_ms"],
               "peak_gib": o["peak_gib"], "peak_reserved_gib": o["peak_reserved_gib"],
               "collectives_and_launches_per_step": want, "dip_matmul_per_step": want_dip, "phase_s": o["phase_s"]}
        if "resumed" in o:
            o["one_rank_equal"] = o["live_crc"] == ranks_out[0]["one_rank_crc"][r]
            res_ = o["resumed"]
            log(f"  rank {r}: checkpoint at step 2 saved in {o['save_s']:.1f} s (gathered on both ranks, written by "
                f"rank 0); restored on rank 0 alone (host, no plan) and cut to this rank's slices in "
                f"{o['one_rank_s']:.1f} s, crc32 of every leaf against the live ones: "
                f"{'bit-equal' if o['one_rank_equal'] else 'DIFFERENT'}; restored on the same mesh in "
                f"{o['restore_s']:.1f} s (warm page cache), step 3 loss {res_['loss']:.7f} against "
                f"{o['steps'][2]['loss']:.7f}: "
                f"{'bit for bit' if res_['loss_equal'] and res_['params_equal'] else 'DIFFERENT'}")
            if not (o["one_rank_equal"] and res_["loss_equal"] and res_["params_equal"] and res_["step"] == 2):
                raise AssertionError(f"phase {tag} rank {r}: the checkpoint did not restore bit for bit")
            rec.update(save_s=o["save_s"], one_rank_s=o["one_rank_s"], restore_s=o["restore_s"])
        log(f"  rank {r}: {json.dumps(rec)} ({gpu})")
        per_rank.append(dict(rec, first_step=first))
    if any(o["steps"][i]["loss"] != ranks_out[0]["steps"][i]["loss"] for o in ranks_out for i in range(3)):
        raise AssertionError(f"phase {tag}: the ranks report different losses")
    if "whole_crc" in ranks_out[0]["steps"][1]:
        log("  after steps 2 and 3 the embedding, the final norm and the lm_head are bit-equal on the ranks (crc32)")
    log(f"  per step and rank: {want} (forward, block remat's reruns, the backward's transposes, the whole "
        f"leaves' psum and the norm's psum){f', and from step {compressed_from} a pmax' if compressed_from else ''}, "
        f"{want_dip} dip_matmul launches")
    return {"ranks": per_rank, "counts_per_step": want, "compressed_from_step": compressed_from}


def check_train10c(ranks_out):
    """10c on the main side: every pair's loss and parameters against the
    single-rank step on the card within 1e-4 (two steps of lr where a
    gradient sits within 1000 eps of 0), the CPU tests' counts, every
    launch on the f32-x route."""
    log(f"phase 10c: one step of every (strategy, family) pair on the reduced models in f32 over 2 ranks against "
        f"the single-rank step on the card; the rank's wall {[round(o['phase_s'], 1) for o in ranks_out]} s")
    rows = {}
    for name in ranks_out[0]["pairs"]:
        got = [o["pairs"][name] for o in ranks_out]
        for g in got:
            (lk, lp), lr = g["loss"], g["lr"]
            ok = (abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)) and g["param_err_clear"] <= 1e-4
                  and g["param_err"] <= 1e-4 + 2 * lr and g["counts"] == g["want_counts"]
                  and g["dip_launches"] == g["f32_x_launches"] >= g["counts"]["launch"])
            if not ok:
                raise AssertionError(f"phase 10c {name}: {g}")
        g = got[0]
        rows[name] = {k: g[k] for k in ("loss", "grad_norm", "param_err_clear", "param_err", "counts")}
        log(f"  {name}: loss {g['loss'][0]:.7f} / single {g['loss'][1]:.7f}, parameters after the step max|err| "
            f"{g['param_err_clear']:.2e} of max(1, |leaf|) where clear of eps ({g['param_err']:.2e} anywhere), "
            f"{g['counts']} a step and rank, {g['dip_launches']} dip_matmul launches (the shards' and the "
            f"replicated weights'), every one f32 x")
    return {"pairs": rows, "f32_x_launches": sum(o["pairs"][n]["f32_x_launches"] for o in ranks_out
                                                 for n in o["pairs"])}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api, tree
    from repro_torch.configs import get_config
    from repro_torch.core import permute
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.kernels import _bf16_parts as bp
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import lm_head_ce as ce
    from repro_torch.kernels import prologue as pro
    from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain, matmul_plan
    from repro_torch.kernels.dip_matmul_q import (cast_pass, cast_pass_plain, dip_matmul_q, dip_matmul_q_plain,
                                                  q_route, quantize_pass, quantize_pass_plain)
    from repro_torch.kernels.dip_systolic import dip_systolic, dip_systolic_plain, systolic_plan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS, attention_plain, flash_attention, flash_plan
    from repro_torch.kernels.ref import quantize_acts_int8
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import graphs
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.models import attention, layers, moe, ssm
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import Request, Server, ServerConfig, Trainer, TrainerConfig
    from repro_torch import reliability as rel
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    import numpy as np
    import torch.nn.functional as F

    def flash_routes():
        """The flash launches counted since the counts were last set to 0, by route."""
        return {"tensor_cores": flash_attention.launches_tc - flash_attention.launches_split,
                "split_kv": flash_attention.launches_split,
                "cuda_cores": flash_attention.launches - flash_attention.launches_tc}

    @contextlib.contextmanager
    def uncounted():
        """A context whose launches compare a step with its eager or plain
        version: every counter is put back after it, so that a path counts
        its own launches only."""
        saved = graphs.launch_counts()
        try:
            yield
        finally:
            for (fn, nm), n in saved.items():
                setattr(fn, nm, n)

    counters = {"dip_matmul": dip_matmul, "dip_matmul_q": dip_matmul_q, "dip_systolic": dip_systolic,
                "flash_attention": flash_attention, "lm_head_ce": ce.lm_head_ce}

    def reset_counts():
        """Every launch counter to 0, the per-route ones included."""
        for c in counters.values():
            c.launches = 0
        flash_attention.launches_tc = flash_attention.launches_split = 0
        dip_matmul_q.launches_tc = dip_matmul_q.launches_quant = dip_matmul_q.launches_cast = 0

    def read_counts():
        """Each kernel's launches since the counts were last set to 0."""
        return {k: c.launches for k, c in counters.items()}

    def kernels_by_name(by_kernel):
        """A profiler trace's kernels (demangled names) in the groups of
        ``graphs.kernels_by_group``."""
        base = {}
        for key, (count, _) in by_kernel.items():
            m = re.search(r"(\w+_kernel)\s*[<(]", key)
            if m:
                base[m.group(1)] = base.get(m.group(1), 0) + count
        return graphs.kernels_by_group(base)

    def profile_call(fn, reset, what, top=12):
        """One synchronised call under the profiler (``reset()`` first,
        outside it): device ms by kernel, launches, the summed device time
        against the wall time of the call, and the host operators by their
        own CPU time."""
        reset()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof, torch.no_grad():
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
        by_kernel = {}
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                us = getattr(ev, "self_device_time_total", None)
                by_kernel[ev.key] = (ev.count, (us if us is not None else ev.self_cuda_time_total) / 1e3)
        device_ms = sum(v[1] for v in by_kernel.values())
        launches = sum(v[0] for v in by_kernel.values())
        host = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                       if not str(getattr(ev, "device_type", "")).endswith("CUDA")), reverse=True)
        host_ms = sum(h[0] for h in host)
        log(f"  {what} (profiled): device ms of all kernels {device_ms:.2f} in {launches} launches; wall "
            f"{wall_ms:.2f} ms (profiler on), device idle {100 * max(0.0, 1 - device_ms / wall_ms):.1f}% of it; "
            f"host ms of all operators (self time) {host_ms:.2f}")
        if top:
            ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
            for key, (count, ms) in ranked[:top] + [kv for kv in ranked[top:] if "flash_" in kv[0]]:
                log(f"    {ms:8.3f} ms  x{count:<5d} {key[:100]}")
            for ms, count, key in host[:6]:
                log(f"    host {ms:8.3f} ms  x{count:<5d} {key[:100]}")
        return {"device_ms": device_ms, "wall_ms": wall_ms, "launches": launches, "host_ms": host_ms,
                "flash_ms": sum(v[1] for key, v in by_kernel.items() if "flash_" in key), "by_kernel": by_kernel}

    def graph_check(what, captured, eager, held, vocab, counted=True):
        """A replay of the engine's captured step against the uncaptured
        step function, both from the cache as the call in ``held`` found it
        (``keep_last``) with its inputs: the logits of the rows the engine
        reads equal bit for bit, their argmax equal and the caches after the
        call equal but for the null block (``live_rows``); then 10 timed
        calls of each after 2 warm-ups (the cache put back before each,
        outside the clock), one profiled call of each, and the captured
        graph's kernel nodes counted by name (``CapturedStep.kernel_nodes``:
        what every replay launches) against the counters' increase over one
        replay, exactly; the profiled replay's trace gives the device time,
        and its kernels by name are printed beside them.  No launch made
        here counts on the path.  ``counted=False``: a step that launches none
        of the counted kernels (the degraded ``torch`` decode step), whose
        graph must hold none either."""
        a, snap = held
        params, cache, inputs = a[0], a[1], a[2:]
        dev_in = tuple(t.to(dev) for t in inputs)
        scratch = clone_tree(snap)

        def replay():
            return captured(params, cache, *inputs)

        def run_eager():
            return eager(params, scratch, *dev_in)

        def reset_replay():
            copy_tree(cache, snap)

        def reset_eager():
            copy_tree(scratch, snap)

        rows = live_rows(a)
        with uncounted(), torch.no_grad():
            reset_replay()
            got = replay()[0][rows].clone()
            got_cache = clone_tree(cache)
            reset_eager()
            want = run_eager()[0][rows]
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            bit_equal = torch.equal(got, want)
            caches_equal = trees_equal(served_cache(got_cache, rows), served_cache(scratch, rows))
            tokens_equal = torch.equal(got[..., :vocab].argmax(-1), want[..., :vocab].argmax(-1))
            del got, want, got_cache
            wall = {}
            for name, fn, reset in (("replay", replay, reset_replay), ("eager", run_eager, reset_eager)):
                ts = []
                for _ in range(12):
                    reset()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t)
                wall[name] = 1e3 * statistics.median(ts[2:])
            before = graphs.launch_counts()
            prof_r = profile_call(replay, reset_replay, f"{what}, one replay")
            by_counter = graphs.counters_by_group(
                {k: n - before[k] for k, n in graphs.launch_counts().items()})
            prof_e = profile_call(run_eager, reset_eager, f"{what}, the eager step", top=0)
        del scratch
        replay_kernels[what] = prof_r["by_kernel"]
        key = tuple(tuple(t.shape) for t in inputs)
        graph_nodes[what] = captured.kernel_nodes(key)
        by_graph = graphs.kernels_by_group(graph_nodes[what])
        by_trace = kernels_by_name(prof_r["by_kernel"])
        trace_short = sum(by_graph.values()) - sum(by_trace.values())
        trace_checks.append((what, trace_short))
        cap = captured.captures[key]
        out = {"replay_ms": wall["replay"], "eager_ms": wall["eager"], "replay_device_ms": prof_r["device_ms"],
               "replay_launches": prof_r["launches"], "eager_device_ms": prof_e["device_ms"],
               "eager_launches": prof_e["launches"],
               "replay_idle": max(0.0, 1 - prof_r["device_ms"] / wall["replay"]),
               "eager_idle": max(0.0, 1 - prof_e["device_ms"] / wall["eager"]),
               "replay_profiled_wall_ms": prof_r["wall_ms"], "eager_profiled_wall_ms": prof_e["wall_ms"],
               "eager_host_ms": prof_e["host_ms"], "flash_ms": prof_r["flash_ms"],
               "capture_s": cap["seconds"], "bit_equal": bit_equal, "max_abs_diff": diff,
               "tokens_equal": tokens_equal, "caches_equal": caches_equal, "graph_kernels": by_graph,
               "trace_kernels": by_trace}
        log(f"  {what}: replay {wall['replay']:.3f} ms against the eager step's {wall['eager']:.3f} ms of wall "
            f"(median of 10); one replay {prof_r['device_ms']:.3f} ms of device time in {prof_r['launches']} "
            f"launches, idle {100 * out['replay_idle']:.1f}% (eager: {prof_e['device_ms']:.3f} ms in "
            f"{prof_e['launches']}, idle {100 * out['eager_idle']:.1f}%); capture {cap['seconds']:.2f} s; "
            f"logits bit-equal {bit_equal} (max|diff| {diff:.3e}), argmax equal {tokens_equal}, caches equal "
            f"{caches_equal}; ({gpu})")
        log(f"  {what}: the graph's kernel nodes by name {by_graph}; by the counters {by_counter}; in the "
            f"profiled replay's trace {by_trace} ({trace_short} fewer than the graph's)")
        if not (bit_equal and tokens_equal and caches_equal):
            raise AssertionError(f"{what}: the replay differs from the eager step on the same inputs")
        if by_graph != by_counter or any(by_graph.values()) != counted:
            raise AssertionError(f"{what}: the captured graph's kernels differ from the counters' increase")
        return out

    replay_kernels = {}  # graph_check's profiled replay: device ms by kernel, by what it checked
    graph_nodes = {}  # graph_check's captured graph: its kernel nodes by function name, by what it checked
    trace_checks = []  # graph_check: (what, the graph's counted kernels missing from the profiled trace)

    def graph_pool_gib(*steps):
        """The device memory the captures of an engine's steps reserved in
        their shared pool: what its graphs keep resident."""
        return sum(c["reserved_bytes"] for st_ in steps for c in st_.captures.values()) / 2**30

    def dev_args(a):
        """A step call's integer inputs (host tensors, as the engine stages
        them) on the card, for the uncaptured step functions."""
        return tuple(t.to(dev) for t in a[2:])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} ({gpu}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. build --
    log("phase 1: build")
    took = _build.build()
    log(f"  built {list(_build.SOURCES)} in {took:.1f} s")
    def kernel_of(line):
        """The kernel a ptxas 'Compiling entry function' line names: the
        shortest length-prefixed identifier ending in _kernel, with its
        mangled template arguments (ILi2ELb1E: <2, true>)."""
        mangled = line.split("'")[1]
        found = []
        for mm in re.finditer(r"(?=(\d+))", mangled):  # every digit run and each of its suffixes
            n, start = int(mm.group(1)), mm.start() + len(mm.group(1))
            ident = mangled[start:start + n]
            if len(ident) == n and ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
                rest = mangled[start + n:]
                found.append(ident + (rest[:rest.index("EE") + 1] if rest.startswith("I") and "EE" in rest else ""))
        return min(found, key=len) if found else mangled

    for name in _build.SOURCES:  # ptxas -v: each kernel's registers, stack and spills
        kernel = "?"
        for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_of(line)
            elif "registers" in line or "spill" in line:
                log(f"  {name} {kernel}: {line.split(':', 1)[-1].strip()}")

    # ---------------------------------------------- 2. kernels vs plain -----
    log("phase 2: each kernel against its plain version on the card")
    g = torch.Generator(device=dev).manual_seed(SEED)
    arch = get_config("llama3-8b")
    # vocab is the lm_head's width: 128256 padded to a multiple of 2048
    d, d_ff, kv, vocab = arch.d_model, arch.d_ff, arch.n_kv_heads * arch.resolved_head_dim, arch.padded_vocab
    assert (d, d_ff, kv, vocab) == (4096, 14336, 1024, 129024)
    # (label, K, N, epilogue, prologue): every projection of the main path
    proj = [
        ("q", d, d, "none", "rmsnorm"),
        ("k/v", d, kv, "none", "rmsnorm"),
        ("o", d, d, "residual", "none"),
        ("gate+up", d, d_ff, "swiglu", "rmsnorm"),
        ("down", d_ff, d, "residual", "none"),
        ("lm_head", d, vocab, "none", "none"),
    ]
    extra = [("bias", d, d, "bias", "none"), ("bias_gelu", d, d, "bias_gelu", "none"),
             ("bias_silu", d, d, "bias_silu", "none")]
    # the DeepSeek-V2-Lite path's projections (phase 5d): the MLA ones (N = 64
    # for the shared RoPE key: half the prefill tile), the shared experts'
    # gate+up (N = 2816) and down (K = 2816), the lm_head (N = 102400)
    ds = get_config("deepseek-v2-lite-16b")
    ds_d, ds_sff = ds.d_model, ds.n_shared_experts * ds.d_ff_expert
    ds_proj = [
        ("deepseek wq", ds_d, ds.n_heads * (ds.qk_nope_head_dim + ds.qk_rope_head_dim), "none", "rmsnorm"),
        ("deepseek w_dkv", ds_d, ds.kv_lora_rank, "none", "rmsnorm"),
        ("deepseek w_krope", ds_d, ds.qk_rope_head_dim, "none", "rmsnorm"),
        ("deepseek wo", ds.n_heads * ds.v_head_dim, ds_d, "residual", "none"),
        ("deepseek shared gate+up", ds_d, ds_sff, "swiglu", "none"),
        ("deepseek shared down", ds_sff, ds_d, "none", "none"),
        ("deepseek lm_head", ds_d, ds.padded_vocab, "none", "none"),
    ]
    assert [(k, n) for _, k, n, _, _ in ds_proj] == [(2048, 3072), (2048, 512), (2048, 64), (2048, 2048),
                                                      (2048, 2816), (2816, 2048), (2048, 102400)]
    # the Zamba2-2.7B and Mamba2-370M paths' projections (phases 5e, 5f) at
    # their logical widths: in_proj's is not a multiple of 64 (10448 and
    # 4384, stored as 10496 and 4416, so the last tile is padding), out_proj
    # carries the residual at K = 5120 / 2048; zamba2's shared block (wq, wk
    # and wv alike, head_dim 80) and lm_head (N = 32768); mamba2's head is
    # the tied embedding (torch.matmul, as in the reference)
    zb, mb = get_config("zamba2-2.7b"), get_config("mamba2-370m")
    ssm_proj = [
        ("zamba2 in_proj", zb.d_model, 2 * zb.d_inner + 2 * zb.ssm_state + zb.n_ssm_heads, "none", "none"),
        ("zamba2 out_proj", zb.d_inner, zb.d_model, "residual", "none"),
        ("zamba2 wq", zb.d_model, zb.n_heads * zb.resolved_head_dim, "none", "rmsnorm"),
        ("zamba2 wo", zb.n_heads * zb.resolved_head_dim, zb.d_model, "residual", "none"),
        ("zamba2 gate+up", zb.d_model, zb.d_ff, "swiglu", "rmsnorm"),
        ("zamba2 down", zb.d_ff, zb.d_model, "residual", "none"),
        ("zamba2 lm_head", zb.d_model, zb.padded_vocab, "none", "none"),
        ("mamba2 in_proj", mb.d_model, 2 * mb.d_inner + 2 * mb.ssm_state + mb.n_ssm_heads, "none", "none"),
        ("mamba2 out_proj", mb.d_inner, mb.d_model, "residual", "none"),
    ]
    assert [(k, n) for _, k, n, _, _ in ssm_proj] == [(2560, 10448), (5120, 2560), (2560, 2560), (2560, 2560),
                                                       (2560, 10240), (10240, 2560), (2560, 32768),
                                                       (1024, 4384), (2048, 1024)]

    def dip_inputs(m, k, n, epilogue, prologue, dtype):
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        p = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(dtype)
        s = epi.spec(epilogue)
        if s.dual_weight:
            eops = ((torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(dtype),)
        elif s.bias:
            eops = (torch.randn(n, generator=g, device=dev),)
        elif s.residual:
            eops = (torch.randn(m, n, generator=g, device=dev).to(dtype),)
        else:
            eops = ()
        pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
        return x, p, eops, dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops)

    # musicgen-medium's projections (phase 6e's training path): wq / wk /
    # wv / wo 1536 x 1536, gate+up 1536 -> 6144, down 6144 -> 1536
    mg = get_config("musicgen-medium")
    mg_proj = [("musicgen wq", mg.d_model, mg.n_heads * mg.resolved_head_dim, "none", "rmsnorm"),
               ("musicgen wo", mg.n_heads * mg.resolved_head_dim, mg.d_model, "residual", "none"),
               ("musicgen gate+up", mg.d_model, mg.d_ff, "swiglu", "rmsnorm"),
               ("musicgen down", mg.d_ff, mg.d_model, "residual", "none")]
    assert [(k, n) for _, k, n, _, _ in mg_proj] == [(1536, 1536), (1536, 1536), (1536, 6144), (6144, 1536)]

    # M = 4 and 256: a serving decode step and prefill chunk; M = 4096: the
    # training paths' batch 4 x seq 1024 through every projection they send
    # to this kernel (llama3-8b's, DeepSeek-V2-Lite's with w_krope's single
    # 64-wide tile, musicgen-medium's; their lm_heads go through
    # lm_head_ce), so tiles past row 256 are held too; M = 4092: a ragged
    # last row tile at that size
    dip_cases = [(4, proj + ds_proj), (256, proj + extra + ds_proj), (4096, proj[:5] + ds_proj[:-1] + mg_proj),
                 (4092, proj[2:3])]
    worst = {"dip_matmul": 0.0, "flash_attention": 0.0, "lm_head_ce": 0.0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan_label(m, n, k, epilogue, dt_name):
        """The bf16 kernel's plan for this call (the f32 kernel has none)."""
        if dt_name != "bfloat16":
            return ""
        pl = matmul_plan(m, n, k, epi.spec(epilogue).dual_weight, sms)
        return f" [{pl.regime} {pl.bm}x{pl.bn}, {pl.splits} split(s), {pl.blocks} blocks]"

    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for m, cases in dip_cases:
            for label, k, n, e, pr in cases:
                x, p, eops, kw = dip_inputs(m, k, n, e, pr, dtype)
                got = dip_matmul(x, p, *eops, **kw)
                want = dip_matmul_plain(x, p, *eops, **kw)
                err = close(f"dip {dt_name} M={m} {label} K={k} N={n} {e}/{pr}{plan_label(m, n, k, e, dt_name)}",
                            got, want, TOL[dt_name])
                worst["dip_matmul"] = max(worst["dip_matmul"], err)
                del x, p, eops, got, want
        x, p, eops, kw = dip_inputs(256, d, d, "residual", "none", dtype)
        err = close(f"ws {dt_name} M=256 K={d} N={d} residual (fuse_deshear=False)",
                    dip_matmul(x, p, *eops, fuse_deshear=False, **kw),
                    dip_matmul_plain(x, p, *eops, fuse_deshear=False, **kw), TOL[dt_name])
        worst["dip_matmul"] = max(worst["dip_matmul"], err)
        # one ragged shape through the registry shim: the same call with the
        # same inputs on the CPU runs the plain version behind the same shim
        x = torch.randn(3, 37, 1000, generator=g, device=dev).to(dtype)
        w = api.DipWeight.from_natural((torch.randn(1000, 700, generator=g, device=dev)
                                        * 1000 ** -0.5).to(dtype))
        r = torch.randn(3, 37, 700, generator=g, device=dev).to(dtype)
        gain = torch.rand(1000, generator=g, device=dev) + 0.5
        err = close(f"registry dip {dt_name} ragged (3,37,1000)@(1000,700) residual/rmsnorm",
                    api.matmul(x, w, backend="dip", epilogue="residual", epilogue_operands=(r,),
                               prologue="rmsnorm", prologue_operands=(gain,)).cpu(),
                    api.matmul(x.cpu(), w.with_data(w.data.cpu()), backend="dip", epilogue="residual",
                               epilogue_operands=(r.cpu(),), prologue="rmsnorm",
                               prologue_operands=(gain.cpu(),)), TOL[dt_name])
        worst["dip_matmul"] = max(worst["dip_matmul"], err)

    # the SSM paths' projections through the registry on a DipWeight of the
    # logical width (the shim pads K, N and the residual and crops the
    # output), against the same call with the plain versions on the card:
    # M = 1 (the prefill tail's single-token forwards), 4 (a decode step),
    # 256 (a prefill chunk); and in bf16 M = 4096, the training batch (phases
    # 6c / 6d: in_proj's padded tile, out_proj's K = 5120; the heads go
    # through lm_head_ce)
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for m in (1, 4, 256) + ((4096,) if dt_name == "bfloat16" else ()):
            for label, k, n, e, pr in ssm_proj:
                if m == 4096 and label.endswith("lm_head"):
                    continue
                x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                ws = [api.DipWeight.from_natural((torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(dtype))
                      for _ in range(2 if epi.spec(e).dual_weight else 1)]
                eops = (torch.randn(m, n, generator=g, device=dev).to(dtype),) if epi.spec(e).residual else ()
                kw = dict(backend="dip", epilogue=e, epilogue_operands=eops, prologue=pr,
                          prologue_operands=(torch.rand(k, generator=g, device=dev) + 0.5,) if pr == "rmsnorm" else ())
                w = tuple(ws) if len(ws) == 2 else ws[0]
                before = dip_matmul.launches
                got = api.matmul(x, w, **kw)
                if dip_matmul.launches != before + 1:
                    raise AssertionError(f"dip {label}: the registry call did not launch the kernel once")
                with plain_backends():
                    want = api.matmul(x, w, **kw)
                storage = ws[0].data.shape[1]
                err = close(f"dip {dt_name} M={m} {label} K={k} N={n} (storage {storage}) {e}/{pr}"
                            f"{plan_label(m, storage, k, e, dt_name)}", got, want, TOL[dt_name])
                worst["dip_matmul"] = max(worst["dip_matmul"], err)
                del x, ws, eops, got, want

    bh, sq, sk, hd = 32, 256, 1024, 128
    kv_full = lambda n: torch.full((bh,), n, dtype=torch.int32, device=dev)  # noqa: E731
    kv_quarter_dead = lambda top: torch.tensor([0 if i % 4 == 0 else top - 5 * i for i in range(bh)],  # noqa: E731
                                               dtype=torch.int32, device=dev)
    # (label, Sq, D, Dv, q_offset, kv_len per row); DeepSeek-V2-Lite's MLA
    # pair (q and k of nope + rope = 192 columns, v of 128) on both bf16
    # routes: Sq = 256 on the 64-row tiles, Sq = 1, 16 and 64 on split_kv
    flash_cases = [
        ("q_offset 0", sq, hd, hd, 0, kv_full(sk)),
        ("q_offset 512", sq, hd, hd, 512, kv_full(768)),
        ("kv_len 0 on every 4th row", sq, hd, hd, 512, kv_quarter_dead(700)),
        ("Dv != D (192/128)", sq, 192, 128, 512, kv_full(768)),
        ("MLA pair, kv_len 0 on every 4th row", sq, 192, 128, 512, kv_quarter_dead(700)),
        ("MLA pair, a token at q_offset 700", 1, 192, 128, 700, kv_full(701)),
        ("MLA pair, kv_len 0 on every 4th row", 16, 192, 128, 800, kv_quarter_dead(816)),
        ("MLA pair at the split limit", 64, 192, 128, 900, kv_full(964)),
    ]

    def flash_inputs(fsq, dk, dvv, dtype):
        return (torch.randn(bh, fsq, dk, generator=g, device=dev).to(dtype),
                torch.randn(bh, sk, dk, generator=g, device=dev).to(dtype),
                torch.randn(bh, sk, dvv, generator=g, device=dev).to(dtype))

    def flash_checked(label, q, k, v, kw, dt_name):
        """One flash call against attention_plain on the card: one launch,
        on the route flash_plan gives (by the counts), within TOL; fully
        masked rows exactly 0.  Returns the output and the plan."""
        plan = flash_plan(q.shape[0], q.shape[1], v.shape[1], q.shape[2], v.shape[2], q.dtype, sms)
        before = flash_routes()
        got = flash_attention(q, k, v, **kw)
        moved = {r: n - before[r] for r, n in flash_routes().items()}
        if moved != {r: int(r == plan[0]) for r in moved}:
            raise AssertionError(f"flash {label}: launched {moved}, planned {plan}")
        err = close(f"flash {dt_name} BH={q.shape[0]} Sq={q.shape[1]} Sk={k.shape[1]} D={q.shape[2]} "
                    f"Dv={v.shape[2]} {label} [{plan[0]}, {plan[2]} split(s)]", got, attention_plain(q, k, v, **kw),
                    TOL[dt_name])
        worst["flash_attention"] = max(worst["flash_attention"], err)
        kvl = kw["kv_len"]
        dead = (kvl == 0) if isinstance(kvl, torch.Tensor) else torch.full((q.shape[0],), kvl == 0, device=dev)
        if dead.any():
            if not bool((got[dead] == 0).all()):
                raise AssertionError(f"flash {label}: fully masked rows are not exactly 0")
            log(f"  flash {dt_name} {label}: {int(dead.sum())} fully masked rows are exactly 0")
        return got, plan

    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for label, fsq, dk, dvv, qo, kvl in flash_cases:
            q, k, v = flash_inputs(fsq, dk, dvv, dtype)
            kw = dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=True)
            got, plan = flash_checked(label, q, k, v, kw, dt_name)
            want_route = ("cuda_cores" if (dk, dvv) not in fa.TC_PAIRS
                          else "tensor_cores" if fsq > fa.SPLIT_MAX_SQ else "split_kv")
            if plan[0] != want_route:
                raise AssertionError(f"flash {dt_name} Sq={fsq} D={dk} Dv={dvv} planned {plan}, not {want_route}")
            if plan[0] == "split_kv" and not torch.equal(got, flash_attention(q, k, v, **kw)):
                raise AssertionError(f"flash split_kv Sq={fsq} D={dk} Dv={dvv}: two calls differ")
            del q, k, v, got
    # Zamba2's shared attention at prefill (phase 5e): 32 heads of D = 80; a
    # 256-token chunk at q_offset 0 and 512, and one token of the prefill
    # tail at q_offset 700, against the 1024 rows of the prefill cache; in
    # both dtypes the chunk on the tensor cores unsplit and the tail on
    # split_kv.  And the tail's shape at D = 128
    zb_flash = [(256, 0, 256), (256, 512, 768), (1, 700, 701)]  # (Sq, q_offset, kv_len)
    zb_route = {256: "tensor_cores", 1: "split_kv"}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for zsq, qo, kvl in zb_flash:
            q = torch.randn(bh, zsq, 80, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(bh, sk, 80, generator=g, device=dev).to(dtype) for _ in range(2))
            _, plan = flash_checked(f"q_offset {qo} kv_len {kvl}", q, k, v,
                                    dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=True), dt_name)
            if plan[0] != zb_route[zsq]:
                raise AssertionError(f"flash at D = 80, Sq = {zsq} ({dt_name}) planned {plan}")
            del q, k, v
    # every pair of the tensor-core routes in both dtypes (the reduced
    # models' D = 32, 48 and (48, 32) among them): the chunk's shape with a
    # kv_len 0 row on every 4th (tensor_cores), and Sq = 1, 3, 16 and 64,
    # which the plan sends to split_kv, against the end of the cache with the same
    # dead rows and live keys ending mid-tile; two split calls on the same
    # inputs must be equal bit for bit (the merge sums the splits in order)
    kv_dead = torch.tensor([0 if i % 4 == 0 else 1024 - 7 * i for i in range(bh)], dtype=torch.int32, device=dev)
    for dt_name in ("bfloat16", "float32"):
        for dk, dvv in sorted(fa.TC_PAIRS):
            for fsq in (256, 1, 3, 16, 64):
                q, k, v = flash_inputs(fsq, dk, dvv, getattr(torch, dt_name))
                kw = dict(q_offset=torch.tensor(sk - fsq - 16 if fsq > 16 else 700, device=dev), kv_len=kv_dead,
                          causal=True)
                got, plan = flash_checked("kv_len 0 on every 4th row", q, k, v, kw, dt_name)
                if plan[0] != ("tensor_cores" if fsq > fa.SPLIT_MAX_SQ else "split_kv"):
                    raise AssertionError(f"flash {dt_name} D = {dk}, Dv = {dvv}, Sq = {fsq} planned {plan}")
                if plan[0] == "split_kv" and not torch.equal(got, flash_attention(q, k, v, **kw)):
                    raise AssertionError(f"flash split_kv {dt_name} D = {dk}, Dv = {dvv}, Sq = {fsq}: two calls differ")
                del q, k, v, got
    # the CUDA-core kernel keeps the pairs the tensor-core routes do not
    # take (a pair Dv != D, D not a multiple of 16, D above 128 other than
    # (192, 128)), in both dtypes: the chunk's shape and one token, with a
    # kv_len 0 row on every 4th
    for dt_name in ("float32", "bfloat16"):
        for dk, dvv in ((128, 64), (40, 40), (256, 256)):
            for fsq in (256, 1):
                q, k, v = flash_inputs(fsq, dk, dvv, getattr(torch, dt_name))
                kw = dict(q_offset=torch.tensor(sk - fsq - 16 if fsq > 16 else 700, device=dev), kv_len=kv_dead,
                          causal=True)
                _, plan = flash_checked("kv_len 0 on every 4th row", q, k, v, kw, dt_name)
                if plan[0] != "cuda_cores":
                    raise AssertionError(f"flash {dt_name} D = {dk}, Dv = {dvv}, Sq = {fsq} planned {plan}")
                del q, k, v
    q, k, v = (torch.randn(bh, s_, 128, generator=g, device=dev).to(torch.bfloat16) for s_ in (1, sk, sk))
    flash_checked("q_offset 700 kv_len 701", q, k, v, dict(q_offset=torch.tensor(700, device=dev), kv_len=701,
                                                           causal=True), "bfloat16")
    log("  flash split_kv: two calls on the same inputs are equal bit for bit at every pair, dtype and Sq")
    del q, k, v
    torch.cuda.synchronize()

    # lm_head_ce at the training shape: T = 4 x 1023 tokens (the shifted
    # batch), D = 4096, Vp = 129024, vocab 128256; and a ragged T = 37, whose
    # vocab split puts one 128-column tile in each block, so six splits lie
    # wholly in the padding
    lm_vocab, sms = arch.vocab_size, torch.cuda.get_device_properties(dev).multi_processor_count
    lm_pairs = [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]

    def lm_inputs(t, x_name, w_name):
        x = torch.randn(t, d, generator=g, device=dev).to(getattr(torch, x_name))
        w = (torch.randn(d, vocab, generator=g, device=dev) * d ** -0.5).to(getattr(torch, w_name))
        labels = torch.randint(0, lm_vocab, (t,), generator=g, device=dev, dtype=torch.int32)
        labels[::5] = ce.IGNORE_INDEX
        return x, w, labels

    pad_splits_seen = 0
    for t in (4092, 37):
        tiles, splits = ce.split_plan(t, vocab, sms, lm_vocab)
        pad_splits = sum(1 for sp in range(splits) if sp * tiles * ce.BLOCK_V >= lm_vocab)
        pad_splits_seen += pad_splits
        for x_name, w_name in lm_pairs:
            x, w, labels = lm_inputs(t, x_name, w_name)
            with torch.no_grad():
                got = ce.lm_head_ce(x, w, labels, vocab_size=lm_vocab)
            want = ce.lm_head_ce_plain(x, w, labels, vocab_size=lm_vocab)
            # f32 W: IEEE f32 products on both sides; bf16 x bf16: tensor cores
            tol = TOL[w_name]
            label = (f"lm_head_ce {x_name} x {w_name} T={t} D={d} Vp={vocab} vocab={lm_vocab} "
                     f"({splits} splits, {pad_splits} all padding)")
            err = max(close(f"{label} logz", got[0], want[0], tol), close(f"{label} label logit", got[1], want[1], tol))
            worst["lm_head_ce"] = max(worst["lm_head_ce"], err)
            if not bool((got[1][labels == ce.IGNORE_INDEX] == 0).all()):
                raise AssertionError("lm_head_ce: a label at -100 matched a column")
            del x, w, got, want
    if not pad_splits_seen:
        raise AssertionError("lm_head_ce: no case had a vocab split wholly in the padding")
    # the families' training heads (phases 6b-6e), bf16 x (bf16 compute) and
    # f32 x (the f32 first steps) against the f32
    # head at T = 4092: (d_model, padded vocab, vocab) of DeepSeek-V2-Lite,
    # Zamba2 (32000 of 32768 real), Mamba2 (the tied head: embed.t(), a
    # (d, Vp) view of the (Vp, d) embedding, which the wrapper copies
    # contiguous; 50280 of 51200 real) and musicgen-medium; the split count
    # stays under the grid limit and the padded lanes are masked
    fam_heads = [(f.name, f.d_model, f.padded_vocab, f.vocab_size, f.tie_embeddings)
                 for f in (ds, zb, mb, mg)]
    assert [h[1:] for h in fam_heads] == [(2048, 102400, 102400, False), (2560, 32768, 32000, False),
                                          (1024, 51200, 50280, True), (1536, 2048, 2048, False)]

    def fam_head_inputs(t, fd, fvp, fvocab, tied, x_dtype=torch.bfloat16):
        x = torch.randn(t, fd, generator=g, device=dev).to(x_dtype)
        w = torch.randn(fvp, fd, generator=g, device=dev).t() if tied else torch.randn(fd, fvp, generator=g,
                                                                                        device=dev)
        labels = torch.randint(0, fvocab, (t,), generator=g, device=dev, dtype=torch.int32)
        labels[::5] = ce.IGNORE_INDEX
        return x, w * fd ** -0.5, labels

    for (fname, fd, fvp, fvocab, tied), x_dtype in ((h, xd) for xd in (torch.bfloat16, torch.float32)
                                                    for h in fam_heads):
        x, w, labels = fam_head_inputs(4092, fd, fvp, fvocab, tied, x_dtype)
        tiles, splits = ce.split_plan(4092, fvp, sms, fvocab)
        before = ce.lm_head_ce.launches
        with torch.no_grad():
            got = ce.lm_head_ce(x, w, labels, vocab_size=fvocab)
        want = ce.lm_head_ce_plain(x, w, labels, vocab_size=fvocab)
        if ce.lm_head_ce.launches != before + 1 or splits > 65535:
            raise AssertionError(f"lm_head_ce {fname}: {ce.lm_head_ce.launches - before} launches, {splits} splits")
        label = (f"lm_head_ce {str(x_dtype).split('.')[-1]} x float32 {fname} T=4092 D={fd} Vp={fvp} "
                 f"vocab={fvocab} ({splits} splits{', the tied head embed.t()' if tied else ''})")
        err = max(close(f"{label} logz", got[0], want[0], TOL["float32"]),
                  close(f"{label} label logit", got[1], want[1], TOL["float32"]))
        worst["lm_head_ce"] = max(worst["lm_head_ce"], err)
        if not bool((got[1][labels == ce.IGNORE_INDEX] == 0).all()):
            raise AssertionError(f"lm_head_ce {fname}: a label at -100 matched a column")
        del x, w, labels, got, want
    # the part count: the bf16 x f32 function with the head cut to two bf16
    # parts (hi + mid, whose f32 sum is exact), in plain torch at the training
    # shape, against the same TOL; printed for the record (the kernel takes
    # ce.W_PARTS = 3, which sum to the head exactly and are held above)
    x, w, labels = lm_inputs(4092, "bfloat16", "float32")
    want = ce.lm_head_ce_plain(x, w, labels, vocab_size=lm_vocab)
    hi, mid = ce.bf16_parts(w, 2)
    w2 = hi.float() + mid.float()
    del hi, mid
    got = ce.lm_head_ce_plain(x, w2, labels, vocab_size=lm_vocab)
    errs = [(got[i] - want[i]).abs().max().item() for i in (0, 1)]
    lims = [TOL["float32"] * max(1.0, want[i].abs().max().item()) for i in (0, 1)]
    log(f"  lm_head_ce bfloat16 x float32 T=4092, head cut to 2 bf16 parts (plain torch): logz max|err| "
        f"{errs[0]:.3e} (limit {lims[0]:.3e}), label logit {errs[1]:.3e} (limit {lims[1]:.3e}): "
        + ("within TOL" if all(e <= lim for e, lim in zip(errs, lims)) else "OUTSIDE TOL")
        + f" [the kernel takes {ce.W_PARTS}]")
    del x, w, w2, labels, want, got
    # the product count of f32 x f32: logz and the label logit with f32 x
    # and the head both split into bf16 parts and only the largest part
    # products kept (bp.part_products, bp.split_matmul), in plain torch at
    # the training shape against the f32 plain version, the same TOL;
    # printed for the record (the kernel takes ce.F32_PRODUCTS = 6, held
    # above)
    x, w, labels = lm_inputs(4092, "float32", "float32")
    want = ce.lm_head_ce_plain(x, w, labels, vocab_size=lm_vocab)
    lims = [TOL["float32"] * max(1.0, want[i].abs().max().item()) for i in (0, 1)]
    live = labels != ce.IGNORE_INDEX
    for n in (3, 5, ce.F32_PRODUCTS):
        z = torch.cat([bp.split_matmul(x, w[:, c0:min(c0 + 8192, lm_vocab)], n)
                       for c0 in range(0, lm_vocab, 8192)], dim=1)
        got = (torch.logsumexp(z, dim=1),
               torch.where(live, z.gather(1, labels.long().clamp(min=0).view(-1, 1)).view(-1), 0.0))
        del z
        errs = [(got[i] - want[i]).abs().max().item() for i in (0, 1)]
        log(f"  lm_head_ce float32 x float32 T=4092, {n} bf16 part products {bp.part_products(n)} (plain torch): "
            f"logz max|err| {errs[0]:.3e} (limit {lims[0]:.3e}), label logit {errs[1]:.3e} (limit {lims[1]:.3e}): "
            + ("within TOL" if all(e <= lim for e, lim in zip(errs, lims)) else "OUTSIDE TOL")
            + f" [the kernel takes {ce.F32_PRODUCTS}]")
        del got
    del x, w, labels, want
    torch.cuda.synchronize()

    # the quantized serving slice: (label, K, N, epilogue, prologue) of the
    # projections the quantized path gives these kernels
    qproj = [("q", d, d, "none", "rmsnorm"), ("gate+up", d, d_ff, "swiglu", "rmsnorm"),
             ("down", d_ff, d, "residual", "none"), ("lm_head", d, vocab, "none", "none")]
    worst.update({"dip_matmul_q_int8": 0.0, "dip_matmul_q_fp8": 0.0, "dip_systolic": 0.0})

    def int8_operands(m, k, n, epilogue):
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        p = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        s = epi.spec(epilogue)
        eops = ((torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8),) if s.dual_weight
                else (torch.randint(-127, 128, (m, n), generator=g, device=dev, dtype=torch.int8),)
                if s.residual else ())
        return x, p, eops

    # int8 x int8: no epilogue returns the exact int32 sums (held bit for
    # bit); swiglu and residual widen them to f32 and are held to TOL
    for m in (4, 256):
        for label, k, n, e, _ in proj:
            x, p, eops = int8_operands(m, k, n, e)
            got, want = dip_matmul(x, p, *eops, epilogue=e), dip_matmul_plain(x, p, *eops, epilogue=e)
            if e == "none":
                if got.dtype != torch.int32 or not torch.equal(got, want):
                    raise AssertionError(f"dip int8 M={m} {label}: not the exact int32 sums")
                log(f"  dip int8 M={m} {label} K={k} N={n}: int32, exact")
            else:
                close(f"dip int8 M={m} {label} K={k} N={n} {e} (f32 out)", got, want, TOL["float32"])
            del x, p, eops, got, want

    # quantized DiP matmul: both sides multiply the same operands (for int8
    # the same activation codes, byte-identical from the quantizing pass and
    # the plain quantizer, into exact int32 sums, so with no epilogue the
    # outputs are equal bit for bit; for fp8 the same bf16 values into f32
    # sums), so TOL of the output dtype holds
    for scheme in ("int8", "fp8_e4m3"):
        key = "dip_matmul_q_int8" if scheme == "int8" else "dip_matmul_q_fp8"
        for label, k, n, e, pr in qproj:
            s = epi.spec(e)
            qws = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5, scheme)
                   for _ in range(2 if s.dual_weight else 1)]
            for dt_name in ("float32", "bfloat16"):
                dtype = getattr(torch, dt_name)
                for m in (4, 37, 256):
                    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                    eops = ((qws[1].data, qws[1].scale) if s.dual_weight else
                            (torch.randn(m, n, generator=g, device=dev).to(dtype),) if s.residual else ())
                    kw = dict(epilogue=e, prologue=pr, prologue_operands=(
                        (torch.rand(k, generator=g, device=dev) + 0.5,) if pr == "rmsnorm" else ()))
                    got = dip_matmul_q(x, qws[0].data, qws[0].scale, *eops, **kw)
                    want = dip_matmul_q_plain(x, qws[0].data, qws[0].scale, *eops, **kw)
                    err = close(f"{key} {dt_name} M={m} {label} K={k} N={n} {e}/{pr}", got, want, TOL[dt_name])
                    if scheme == "int8" and e == "none" and not torch.equal(got, want):
                        raise AssertionError(f"{key} {dt_name} M={m} {label}: epilogue none is not bit-exact")
                    worst[key] = max(worst[key], err)
                    del got, want
                    del x, eops
            del qws

    # the one-byte routes on the tensor cores (bf16 x, csrc/dip_matmul.cu):
    # every epilogue with and without the prologue at the decode and prefill
    # M, at the projections' widths (swiglu at gate+up, residual at down,
    # none also at the lm_head), each through its plan; TOL, and for int8
    # with no epilogue bit for bit, each call with its quantizing pass
    for scheme, key in (("fp8_e4m3", "dip_matmul_q_fp8"), ("int8", "dip_matmul_q_int8")):
        plans = set()
        for m in (1, 4, 32, 33, 256, 4096):
            for e in epi.EPILOGUES:
                s = epi.spec(e)
                k, n = (d_ff, d) if s.residual else (d, d_ff if s.dual_weight else d)
                shapes = [(k, n), (d, vocab)] if e == "none" else [(k, n)]
                for k, n in shapes:
                    qws = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5, scheme)
                           for _ in range(2 if s.dual_weight else 1)]
                    for pr in ("none", "rmsnorm"):
                        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
                        eops = ((qws[1].data, qws[1].scale) if s.dual_weight else
                                (torch.randn(n, generator=g, device=dev),) if s.bias else
                                (torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16),) if s.residual else ())
                        kw = dict(epilogue=e, prologue=pr, prologue_operands=(
                            (torch.rand(k, generator=g, device=dev) + 0.5,) if pr == "rmsnorm" else ()))
                        pl = matmul_plan(m, n, k, s.dual_weight, sms, weight_bytes=1)
                        plans.add((pl.regime, pl.splits > 1))
                        before = (dip_matmul_q.launches_tc, dip_matmul_q.launches_quant)
                        got = dip_matmul_q(x, qws[0].data, qws[0].scale, *eops, **kw)
                        if (dip_matmul_q.launches_tc, dip_matmul_q.launches_quant) != (
                                before[0] + 1, before[1] + (scheme == "int8")):
                            raise AssertionError(f"{scheme} route: a bf16 call left the tensor-core route")
                        want = dip_matmul_q_plain(x, qws[0].data, qws[0].scale, *eops, **kw)
                        name = (f"{key} tensor cores M={m} K={k} N={n} {e}/{pr} [{pl.regime} {pl.bm}x{pl.bn}, "
                                f"{pl.splits} split(s), {pl.blocks} blocks]")
                        if scheme == "int8" and e == "none":
                            if not torch.equal(got, want):
                                raise AssertionError(f"{name}: not bit for bit the plain version")
                            log(f"  {name}: bit-exact")
                        else:
                            worst[key] = max(worst[key], close(name, got, want, TOL["bfloat16"]))
                        del x, eops, got, want
                    del qws
        if plans != {("decode", False), ("decode", True), ("prefill", False), ("prefill", True)}:
            raise AssertionError(f"{scheme} route: the cases missed a plan: {sorted(plans)}")
    # every e4m3 code but the two NaNs (subnormals and zeros included): rows
    # of the identity read the de-sheared upcast weight back, bit for bit,
    # through both mainloops
    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8, device=dev)
    nat = codes.repeat(64 * 128 // codes.numel() + 1)[:64 * 128].reshape(64, 128).view(torch.float8_e4m3fn)
    q_all = permute.permute_tiled(nat.float()).to(torch.float8_e4m3fn)
    for m in (8, 64):
        got = dip_matmul_q(torch.eye(m, 64, device=dev).to(torch.bfloat16), q_all, torch.ones(1, 128, device=dev))
        if not torch.equal(got, (torch.eye(m, 64, device=dev) @ nat.float()).to(torch.bfloat16)):
            raise AssertionError(f"fp8 route: an e4m3 code did not upcast exactly (M={m})")
        log(f"  dip_matmul_q_fp8 tensor cores M={m}: all 254 e4m3 codes upcast exactly "
            f"[{matmul_plan(m, 128, 64, False, sms, weight_bytes=1).regime}]")
    del codes, nat, q_all
    torch.cuda.synchronize()

    # the int8 route's quantizing pass: codes and per-row scales byte for
    # byte those of the plain quantizer (the same inv_rms on both sides),
    # f32 and bf16 x, with and without the prologue, an all-zero row
    worst["quantize_pass"] = 0.0
    for dt_name in ("float32", "bfloat16"):
        for m, k in ((4, d), (256, d), (37, d_ff)):
            for pr in ("none", "rmsnorm"):
                x = (torch.randn(m, k, generator=g, device=dev) * 3).to(getattr(torch, dt_name))
                x[1] = 0
                gain = torch.rand(k, generator=g, device=dev) + 0.5 if pr == "rmsnorm" else None
                inv = pro.inv_rms(x) if gain is not None else None
                before = dip_matmul_q.launches_quant
                codes, scale = quantize_pass(x, inv, gain)
                want_c, want_s = quantize_pass_plain(x, inv, gain)
                if dip_matmul_q.launches_quant != before + 1:
                    raise AssertionError("quantizing pass: the wrapper did not launch its kernel")
                if not (torch.equal(codes, want_c) and torch.equal(scale, want_s)):
                    raise AssertionError(f"quantizing pass {dt_name} M={m} K={k} {pr}: codes or scales differ "
                                         f"({int((codes != want_c).sum())} codes, {int((scale != want_s).sum())} scales)")
                log(f"  quantizing pass {dt_name} M={m} K={k} {pr}: codes and scales byte-identical")
                del x, codes, scale, want_c, want_s

    # the fp8 route's cast pass for f32 x: bf16 bytes those of the plain
    # version (the same inv_rms on both sides), with and without the
    # prologue, an all-zero row and a row of exact bf16 rounding midpoints
    worst["cast_pass"] = 0.0  # byte-identical, or the phase fails
    for m, k in ((1, d), (4, d), (256, d), (37, d_ff)):
        for pr in ("none", "rmsnorm"):
            x = torch.randn(m, k, generator=g, device=dev) * 3
            if m > 2:
                x[1] = 0
                x[2] = ((torch.randint(0x3C00, 0x4400, (k,), generator=g, device=dev, dtype=torch.int32) << 16)
                        + 0x8000).view(torch.float32)
            gain = torch.rand(k, generator=g, device=dev) + 0.5 if pr == "rmsnorm" else None
            inv = pro.inv_rms(x) if gain is not None else None
            before = dip_matmul_q.launches_cast
            got = cast_pass(x, inv, gain)
            if dip_matmul_q.launches_cast != before + 1:
                raise AssertionError("cast pass: the wrapper did not launch its kernel")
            want_b = cast_pass_plain(x, inv, gain)
            if not torch.equal(got.view(torch.int16), want_b.view(torch.int16)):
                n_diff = int((got.view(torch.int16) != want_b.view(torch.int16)).sum())
                raise AssertionError(f"cast pass M={m} K={k} {pr}: {n_diff} bf16 values differ from the plain "
                                     f"version's")
            log(f"  cast pass float32 -> bfloat16 M={m} K={k} {pr}: byte-identical")
            del x, got, want_b

    torch.cuda.synchronize()

    # the quantized families' projections (phases 5g, 5h; fp8 is held at
    # full width here only) through the registry on a QuantizedDipWeight of
    # the logical width (the shim pads K and crops the padded columns, which
    # carry scale 1.0), bf16 x as served, M = 1 (the SSM prefill tail), 4 (a
    # decode step) and 256 (a prefill chunk): one launch on the tensor-core
    # route each, for int8 with one quantizing pass whose codes and scales
    # are byte-identical to the plain quantizer's; against the same call
    # with the plain versions on the card, TOL, and for int8 with no
    # epilogue bit for bit
    for scheme, key in (("int8", "dip_matmul_q_int8"), ("fp8_e4m3", "dip_matmul_q_fp8")):
        backend = api.quant.scheme_info(scheme).backend
        for label, k, n, e, pr in ds_proj + ssm_proj:
            s = epi.spec(e)
            qws = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5, scheme)
                   for _ in range(2 if s.dual_weight else 1)]
            for m in (1, 4, 256):
                x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
                gain = torch.rand(k, generator=g, device=dev) + 0.5 if pr == "rmsnorm" else None
                kw = dict(backend=backend, epilogue=e, prologue=pr, prologue_operands=() if gain is None else (gain,),
                          epilogue_operands=(torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16),)
                          if s.residual else ())
                w = tuple(qws) if s.dual_weight else qws[0]
                before = (dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_quant)
                got = api.matmul(x, w, **kw)
                if (dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_quant) != (
                        before[0] + 1, before[1] + 1, before[2] + (scheme == "int8")):
                    raise AssertionError(f"{key} {label} M={m}: not one launch on the tensor-core route")
                with plain_backends():
                    want = api.matmul(x, w, **kw)
                name = (f"{key} registry M={m} {label} K={k} N={n} (storage {qws[0].data.shape[1]}) {e}/{pr} "
                        f"[{matmul_plan(m, qws[0].data.shape[1], k, s.dual_weight, sms, weight_bytes=1).regime}]")
                if scheme == "int8":
                    inv = pro.inv_rms(x) if gain is not None else None
                    codes, scale = quantize_pass(x, inv, gain)
                    want_c, want_s = quantize_pass_plain(x, inv, gain)
                    if not (torch.equal(codes, want_c) and torch.equal(scale, want_s)):
                        raise AssertionError(f"{name}: the activation codes or scales differ from the plain quantizer")
                    del codes, scale, want_c, want_s
                if scheme == "int8" and e == "none":
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name}: not bit for bit the plain version")
                    log(f"  {name}: codes byte-identical, output bit-exact")
                else:
                    worst[key] = max(worst[key], close(name, got, want, TOL["bfloat16"]))
                del x, got, want, kw
            del qws
    torch.cuda.synchronize()

    # fp8 weights with f32 x, as an f32-compute model gives them (phase 3
    # serves one): one cast pass to bf16, then the e4m3 mainloops with an
    # f32 output, through the registry at every family projection of 5g / 5h
    # and with the bias epilogues at DeepSeek-V2-Lite's shared gate width,
    # M = 1, 4 and 256; one product on the tensor-core route and one cast
    # pass a call; against the same call with the plain versions on the
    # card, f32 TOL (the same bf16 operands, summed in IEEE f32 across K)
    fp8_backend = api.quant.scheme_info("fp8_e4m3").backend
    worst["dip_matmul_q_fp8_f32"] = 0.0
    bias_proj = [(f"deepseek shared gate {e}", ds_d, ds_sff, e, "rmsnorm") for e in ("bias", "bias_gelu", "bias_silu")]
    for label, k, n, e, pr in ds_proj + ssm_proj + bias_proj:
        s = epi.spec(e)
        qws = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5, "fp8_e4m3")
               for _ in range(2 if s.dual_weight else 1)]
        for m in (1, 4, 256):
            x = torch.randn(m, k, generator=g, device=dev)
            gain = torch.rand(k, generator=g, device=dev) + 0.5 if pr == "rmsnorm" else None
            eops = ((torch.randn(m, n, generator=g, device=dev),) if s.residual else
                    (torch.randn(n, generator=g, device=dev),) if s.bias else ())
            kw = dict(backend=fp8_backend, epilogue=e, prologue=pr, prologue_operands=() if gain is None else (gain,),
                      epilogue_operands=eops)
            w = tuple(qws) if s.dual_weight else qws[0]
            before = (dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_cast,
                      dip_matmul_q.launches_quant)
            got = api.matmul(x, w, **kw)
            moved = tuple(a_ - b_ for a_, b_ in zip((dip_matmul_q.launches, dip_matmul_q.launches_tc,
                                                     dip_matmul_q.launches_cast, dip_matmul_q.launches_quant), before))
            if moved != (1, 1, 1, 0):
                raise AssertionError(f"fp8 f32 x {label} M={m}: launches (product, tensor cores, cast, quantize) "
                                     f"{moved}, not (1, 1, 1, 0)")
            with plain_backends():
                want = api.matmul(x, w, **kw)
            name = (f"dip_matmul_q_fp8 float32 x registry M={m} {label} K={k} N={n} (storage {qws[0].data.shape[1]}) "
                    f"{e}/{pr} [{matmul_plan(m, qws[0].data.shape[1], k, s.dual_weight, sms, weight_bytes=1).regime}]")
            if got.dtype != torch.float32:
                raise AssertionError(f"{name}: out dtype {got.dtype}")
            worst["dip_matmul_q_fp8_f32"] = max(worst["dip_matmul_q_fp8_f32"], close(name, got, want, TOL["float32"]))
            del x, got, want, kw, eops
        del qws
    torch.cuda.synchronize()

    # views at a storage offset that is not 16-byte aligned: refused before
    # the launch (a misaligned 16-byte load would fault and poison the
    # context), after which the same calls on aligned tensors run
    buf = torch.randn(32 * 256 * 128 + 8, generator=g, device=dev).to(torch.bfloat16)
    off = buf[1:1 + 32 * 256 * 128].view(32, 256, 128)
    ok_q = off.clone()
    xo = buf[3:3 + 37 * d].view(37, d)
    head = torch.randn(d, 1024, generator=g, device=dev) * d ** -0.5
    lab37 = torch.randint(0, 1000, (37,), generator=g, device=dev, dtype=torch.int32)
    q_small = api.quant.quantize(torch.randn(d, 128, generator=g, device=dev) * d ** -0.5, "fp8_e4m3")
    refused = 0
    for what, call in (("flash q", lambda: flash_attention(off, ok_q, ok_q)),
                       ("flash v", lambda: flash_attention(ok_q, ok_q, off)),
                       ("lm_head_ce x", lambda: ce.lm_head_ce(xo, head, lab37, vocab_size=1000)),
                       ("dip_matmul_q x", lambda: dip_matmul_q(xo[:4], q_small.data, q_small.scale))):
        try:
            with torch.no_grad():
                call()
        except ValueError as exc:
            if "16-byte aligned" not in str(exc):
                raise
            refused += 1
            log(f"  offset view, {what}: refused ({exc})")
        else:
            raise AssertionError(f"{what}: a misaligned view was launched")
    torch.cuda.synchronize()
    close("after the refusals: flash on aligned copies", flash_attention(ok_q, ok_q, ok_q),
          attention_plain(ok_q, ok_q, ok_q), TOL["bfloat16"])
    with torch.no_grad():
        got = ce.lm_head_ce(xo.clone(), head, lab37, vocab_size=1000)
    close("after the refusals: lm_head_ce on an aligned copy", got[0],
          ce.lm_head_ce_plain(xo.clone(), head, lab37, vocab_size=1000)[0], TOL["float32"])
    close("after the refusals: dip_matmul_q on an aligned copy", dip_matmul_q(xo[:4].clone(), q_small.data, q_small.scale),
          dip_matmul_q_plain(xo[:4].clone(), q_small.data, q_small.scale), TOL["bfloat16"])
    torch.cuda.synchronize()
    del buf, off, ok_q, xo, head, lab37, q_small

    # the wavefront over its plans (systolic_plan: M = 1 and 13 leave decode
    # warps past M, M = 4 and 13 split K at decode, M = 256 fills the last
    # wave by a split): f32 and bf16 within TOL, int8 exact without an
    # epilogue (int32 partial sums where K is split)
    for dt_name in ("float32", "bfloat16", "int8"):
        for m in (1, 4, 13, 256):
            for label, k, n, e, pr in qproj:
                if dt_name == "int8":
                    x, p, eops = int8_operands(m, k, n, e)
                    kw = dict(epilogue=e)
                else:
                    x, p, eops, kw = dip_inputs(m, k, n, e, pr, getattr(torch, dt_name))
                got, want = dip_systolic(x, p, *eops, **kw), dip_systolic_plain(x, p, *eops, **kw)
                pl = systolic_plan(m, n, k, sms, epi.spec(e).dual_weight)
                name = (f"systolic {dt_name} M={m} {label} K={k} N={n} {e}/{kw.get('prologue', 'none')} "
                        f"[{pl.regime} {pl.bm}x{pl.bn}, {pl.splits} split(s), {pl.blocks} blocks]")
                if dt_name == "int8" and e == "none":
                    if got.dtype != torch.int32 or not torch.equal(got, want):
                        raise AssertionError(f"{name}: not the exact int32 sums")
                    log(f"  {name}: int32, exact")
                else:
                    err = close(name, got, want, TOL["float32" if dt_name == "int8" else dt_name])
                    worst["dip_systolic"] = max(worst["dip_systolic"], err)
                del x, p, eops, got, want
    torch.cuda.synchronize()

    def dip_per_forward(c):
        """The DiP projections a forward launches, counted from the
        template: every DiP-stored linear of a layer (gate and up one
        swiglu launch) times the layers, the hybrid's shared block times
        its sites, and a separate head.  MLA's w_uk and w_uv are absorbed
        (de-sheared and contracted per head outside the kernel, as in the
        reference), so they launch nothing."""
        t = tf_model.param_template(c)

        def count(sub):
            names = {nm for nm, leaf in sub.items() if leaf[3] is not None and nm not in ("w_uk", "w_uv")}
            return len(names) - len({nm for nm in names if nm.endswith("w_up") and nm[:-2] + "gate" in names})

        n = count(t["layers"]) * c.n_layers + int("lm_head" in t)
        if "shared_attn" in t:
            n += count(t["shared_attn"]) * (c.n_layers // c.attn_every)
        return n

    # ---------------------------------------- 3. reduced model, card vs CPU --
    log("phase 3: reduced llama3-8b served on the card against the CPU: dip (f32), dip_int8w with the "
        "int8 KV pool (f32), dip_fp8 (bf16), pallas_systolic (f32); reduced deepseek-v2-lite-16b, "
        "zamba2-2.7b and mamba2-370m (dip, f32; dip_fp8, bf16); reduced "
        "yi-9b and codeqwen1.5-7b (dip, bf16); reduced phi-3-vision-4.2b and musicgen-medium from tokens (dip, f32)")
    rcfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip",
                               param_dtype="float32", compute_dtype="float32")
    cpu_params = tf_model.init_params(rcfg, make_generator(SEED, "cpu"), "cpu")

    def to_dev(t):
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        if isinstance(t, api.DipWeight):
            return t.with_data(t.data.to(dev))
        if isinstance(t, api.QuantizedDipWeight):
            return t.with_data(t.data.to(dev), t.scale.to(dev))
        return t.to(dev)

    def recorded(server):
        """Wrap the engine's two steps to keep their logits (on the CPU)."""
        eng, seen = server.engine, []
        for attr in ("_prefill_fwd", "_decode"):
            def wrap(*a, _f=getattr(eng, attr), _tag=attr):
                out = _f(*a)
                seen.append((_tag, out[0][..., :rcfg.vocab_size].float().cpu()))
                return out
            setattr(eng, attr, wrap)
        return seen

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, rcfg.vocab_size, size=n) for n in (11, 19)]
    scfg = ServerConfig(batch_slots=2, max_seq=64, max_new_tokens=4, temperature=0.0, prefill_chunk=16)

    # each backend on its own seeded weights: (label, config fields, bound
    # on |card - cpu| per logit)
    def int8_envelope(params, c):
        """MODEL_TOL, plus one activation-code step of every lm_head input at
        the largest x_scale an RMS-normed row allows (sqrt(d) max|gain| / 127):
        a code flips where the card's and the CPU's f32 activations straddle
        a rounding midpoint"""
        head = params["lm_head"]
        x_scale = c.d_model ** 0.5 * float(params["final_norm"].abs().max()) / 127.0
        colsum = permute.unpermute_tiled(head.data, head.perm_tile)[:, :c.vocab_size].float().abs().sum(0)
        return lambda want: MODEL_TOL * max(1.0, want.abs().max().item()) + x_scale * colsum * head.scale[0, :c.vocab_size]

    f32_dip = dict(matmul_backend="dip", param_dtype="float32", compute_dtype="float32")
    variants = [
        ("dip, f32", "llama3-8b", f32_dip, "f32"),
        ("dip_int8w, int8 KV, f32", "llama3-8b", dict(quantization="int8", matmul_backend="dip_int8w",
                                                      kv_quant="int8", param_dtype="float32",
                                                      compute_dtype="float32"), "int8"),
        ("dip_fp8, bf16", "llama3-8b", dict(quantization="fp8_e4m3", matmul_backend="dip_fp8",
                                            param_dtype="bfloat16", compute_dtype="bfloat16"), "bf16"),
        ("pallas_systolic, f32", "llama3-8b", dict(matmul_backend="pallas_systolic", param_dtype="float32",
                                                   compute_dtype="float32"), "f32"),
        # phase 5d's gate 3: the MoE + MLA model, reduced (its w_krope 16
        # columns wide, padded to one 64-wide tile)
        ("deepseek-v2-lite-16b reduced, dip, f32", "deepseek-v2-lite-16b", f32_dip, "f32"),
        # phases 5e and 5f's gate 3: the hybrid and the pure SSM model,
        # reduced; prompts of 11 and 19 tokens in chunks of 16 take the
        # single-token prefill tail
        ("zamba2-2.7b reduced, dip, f32", "zamba2-2.7b", f32_dip, "f32"),
        ("mamba2-370m reduced, dip, f32", "mamba2-370m", f32_dip, "f32"),
    ]
    # the fp8 families: the MoE/MLA, hybrid and SSM models, reduced, with
    # fp8 weights in bf16 (as served; fp8 at full width is held in phase 2
    # only); and the dense yi-9b (GQA kv = 4) and codeqwen1.5-7b (QKV bias)
    # in bf16.  Their int8 runs are held at full width (5g, 5h) against the
    # plain versions on the card with the routing or block inputs replayed,
    # not here: the card's and the CPU's f32 sums differ in the last bit,
    # which moves an activation across an int8 rounding midpoint now and
    # then (llama3-8b's dense int8 run above happens to meet none); in the
    # reduced deepseek-v2-lite-16b one such code of wo's input changes the
    # next layers' routing inputs enough to change a greedy token
    for arch_name in ("deepseek-v2-lite-16b", "zamba2-2.7b", "mamba2-370m"):
        variants.append((f"{arch_name} reduced, dip_fp8, bf16", arch_name,
                         dict(quantization="fp8_e4m3", matmul_backend="dip_fp8", param_dtype="bfloat16",
                              compute_dtype="bfloat16"), "bf16"))
    variants += [(f"{nm} reduced, dip, bf16", nm, dict(matmul_backend="dip", param_dtype="bfloat16",
                                                      compute_dtype="bfloat16"), "bf16")
                 for nm in ("yi-9b", "codeqwen1.5-7b")]
    # the stub frontends' dense decoders, served from tokens as the
    # reference serves them (training feeds them embeddings: phase 4)
    variants += [(f"{nm} reduced, dip, f32", nm, f32_dip, "f32") for nm in ("phi-3-vision-4.2b", "musicgen-medium")]
    reduced_flash_routes = {}  # each variant's flash launches on the card, by route
    for label, arch_name, fields, kind in variants:
        vcfg = dataclasses.replace(get_config(arch_name).reduced(), **fields)
        vparams = cpu_params if vcfg == rcfg else tf_model.init_params(vcfg, make_generator(SEED, "cpu"), "cpu")
        bound = (int8_envelope(vparams, vcfg) if kind == "int8" else
                 (lambda want: BF16_MODEL_TOL * max(1.0, want.abs().max().item())) if kind == "bf16" else
                 (lambda want: MODEL_TOL * max(1.0, want.abs().max().item())))
        vouts, vlogits = {}, {}
        for where, params in (("cuda", to_dev(vparams)), ("cpu", vparams)):
            reset_counts()
            server = Server(vcfg, scfg, params, device=where)
            vlogits[where] = recorded(server)
            vouts[where] = server.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
            if where == "cuda":
                v_routes = flash_routes()
        # the reduced models' attention (D = 32, the MLA pair (48, 32)) on the
        # tensor-core routes in f32 and bf16: no flash launch on the CUDA cores
        reduced_flash_routes[label] = v_routes
        dims = ("no attention" if not vcfg.n_heads else
                f"MLA D {vcfg.qk_nope_head_dim + vcfg.qk_rope_head_dim} / Dv {vcfg.v_head_dim}" if vcfg.use_mla
                else f"head dim {vcfg.resolved_head_dim}")
        log(f"  {label}: flash launches by route {v_routes} ({dims})")
        if v_routes["cuda_cores"]:
            raise AssertionError(f"reduced model, {label}: {v_routes['cuda_cores']} flash launches on the CUDA cores")
        log(f"  {label}: greedy tokens card {vouts['cuda']} / cpu {vouts['cpu']}")
        if vouts["cuda"] != vouts["cpu"]:
            raise AssertionError(f"reduced model, {label}: greedy tokens differ between card and CPU")
        if [t for t, _ in vlogits["cuda"]] != [t for t, _ in vlogits["cpu"]]:
            raise AssertionError(f"reduced model, {label}: the engines took different steps")
        worst_err, over = 0.0, 0
        for (tag, a), (_, b) in zip(vlogits["cuda"], vlogits["cpu"]):
            err = (a - b).abs()
            lim = bound(b)
            if not bool((err <= lim).all()):
                raise AssertionError(f"reduced model, {label}: {tag} logits outside the stated bound")
            worst_err = max(worst_err, err.max().item())
            over += int((err > MODEL_TOL * max(1.0, b.abs().max().item())).sum())
        log(f"  {label}: {len(vlogits['cuda'])} steps, logits max|card - cpu| {worst_err:.3e} within the "
            f"bound; {over} logits above {MODEL_TOL:g} x max(1, max|cpu|)")

    # fp8 weights in f32 compute: every projection a cast pass to bf16 and the
    # e4m3 mainloops with an f32 output.  Held against the plain versions on
    # the card, not against the CPU: on the card both sides multiply
    # bf16-cast activations (fp8_compute_dtype), where the CPU multiplies f32
    # ones.  The same weights served twice on the card, the kernels and then
    # the plain versions (flash on both sides); greedy tokens and steps equal,
    # every step's logits within BF16_MODEL_TOL, every dip_matmul_q launch on
    # the tensor-core route with one cast pass
    fcfg = dataclasses.replace(get_config("llama3-8b").reduced(), quantization="fp8_e4m3", matmul_backend="dip_fp8",
                               param_dtype="float32", compute_dtype="float32")
    fparams = to_dev(tf_model.init_params(fcfg, make_generator(SEED, "cpu"), "cpu"))
    fruns = {}
    for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_backends)):
        reset_counts()
        with ctx():
            server = Server(fcfg, scfg, fparams, device="cuda")
            seen = recorded(server)
            outs = server.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
        fruns[label] = (outs, seen, read_counts(), dip_matmul_q.launches_tc, dip_matmul_q.launches_cast,
                        dip_matmul_q.launches_quant, flash_routes())
        del server
    (outs_k, seen_k, counts_k, tc_k, cast_k, quant_k, fp8_f32_routes), (outs_p, seen_p, counts_p, *_) = (
        fruns["kernels"], fruns["plain"])
    log(f"  llama3-8b reduced, dip_fp8, f32: greedy tokens kernels {outs_k} / plain {outs_p}; launches {counts_k} "
        f"({tc_k} on the tensor-core route, {cast_k} cast passes, {quant_k} quantizing passes; the plain run's "
        f"{counts_p})")
    n_q = counts_k["dip_matmul_q"]
    if not n_q or tc_k != n_q or cast_k != n_q or quant_k or counts_k["dip_matmul"] or counts_p["dip_matmul_q"]:
        raise AssertionError("reduced fp8 model, f32: a projection left the tensor-core route or its cast pass")
    if outs_k != outs_p or [t for t, _ in seen_k] != [t for t, _ in seen_p]:
        raise AssertionError("reduced fp8 model, f32: greedy tokens or steps differ between kernels and plain")
    worst_err = 0.0
    for (tag, a), (_, b) in zip(seen_k, seen_p):
        err = (a - b).abs().max().item()
        if err > BF16_MODEL_TOL * max(1.0, b.abs().max().item()):
            raise AssertionError(f"reduced fp8 model, f32: {tag} logits outside {BF16_MODEL_TOL:g} x "
                                 f"max(1, max|plain|)")
        worst_err = max(worst_err, err)
    log(f"  llama3-8b reduced, dip_fp8, f32: {len(seen_k)} steps, logits max|kernels - plain| {worst_err:.3e} within "
        f"{BF16_MODEL_TOL:g} x max(1, max|plain|)")
    fp8_f32_path = dict(counts_k, cast_pass=cast_k)
    del fparams, fruns

    # ------------------------------------ 4. reduced training, card vs CPU --
    log("phase 4: reduced llama3-8b, f32, dip backend: 3 Trainer steps, card against CPU, "
        "with a checkpoint and a resume; then the reduced MoE, SSM, hybrid and stub-frontend families the same")
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def reduced_trainer(where, name, fail_at=None):
        return Trainer(rcfg, TrainerConfig(steps=3, ckpt_every=2, ckpt_dir=os.path.join(ckpt_root, name),
                                           keep=3, fail_at_step=fail_at, log_every=1),
                       seq_len=64, global_batch=4, device=where)

    def fresh(where):
        return to_dev(cpu_params) if where == "cuda" else tree.map_tree(lambda t: t.clone(), cpu_params)

    runs = {"cpu": reduced_trainer("cpu", "cpu").run(params=fresh("cpu"))}
    dip_matmul.launches = flash_attention.launches = ce.lm_head_ce.launches = 0
    runs["cuda"] = reduced_trainer("cuda", "cuda").run(params=fresh("cuda"))
    got = (dip_matmul.launches, flash_attention.launches, ce.lm_head_ce.launches)
    want = (6 * rcfg.n_layers * 3, 0, 3)  # no remat in the reduced config
    log(f"  card launches (dip_matmul, flash_attention, lm_head_ce) {got}; expected {want}")
    if got != want:
        raise AssertionError("reduced training: the card run did not launch the kernels as expected")
    for a, b in zip(runs["cuda"]["metrics"], runs["cpu"]["metrics"]):
        for k in ("loss", "grad_norm"):
            err = abs(a[k] - b[k])
            log(f"  step {int(a['step'])} {k}: card {a[k]:.7f} cpu {b[k]:.7f} |err| {err:.2e} "
                f"(limit {TRAIN_TOL:g} x {max(1.0, abs(b[k])):.3g})")
            if err > TRAIN_TOL * max(1.0, abs(b[k])):
                raise AssertionError(f"reduced training: step {a['step']} {k} differs between card and CPU")
    try:
        reduced_trainer("cuda", "resumed", fail_at=2).run(params=fresh("cuda"))
    except RuntimeError as e:  # the injected stop is the expected outcome
        if "injected failure" not in str(e):
            raise
    else:
        raise AssertionError("reduced training: fail_at_step did not stop the run")
    resumed = reduced_trainer("cuda", "resumed").run()
    whole, again = runs["cuda"]["metrics"][-1], resumed["metrics"]
    if [int(m["step"]) for m in again] != [3]:
        raise AssertionError(f"resume: expected to run step 3 only, ran {[m['step'] for m in again]}")
    bit_exact = all(m1 == m2 for m1, m2 in ((again[0]["loss"], whole["loss"]), (again[0]["grad_norm"], whole["grad_norm"])))
    for x1, x2 in zip(tree.leaves(resumed["state"]["params"]), tree.leaves(runs["cuda"]["state"]["params"])):
        close_p = (x1 - x2).abs().max().item()
        bit_exact = bit_exact and close_p == 0.0
        if close_p > RESUME_TOL * max(1.0, x2.abs().max().item()):
            raise AssertionError("resume: parameters after the resumed step differ from the uninterrupted run")
    for k in ("loss", "grad_norm"):
        if abs(again[0][k] - whole[k]) > RESUME_TOL * max(1.0, abs(whole[k])):
            raise AssertionError(f"resume: step 3 {k} {again[0][k]} differs from {whole[k]}")
    log(f"  resumed from the step-2 checkpoint: step 3 loss {again[0]['loss']:.7f} against "
        f"{whole['loss']:.7f} uninterrupted; bit-exact: {bit_exact}")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    del cpu_params, runs, resumed

    # the families that train since phases 6b-6e, reduced, f32 on dip: the
    # MoE + MLA and the MoE + GQA models, the hybrid, the SSM (tied head) and
    # the stub frontends' decoders fed the pipeline's embeddings; 3 Trainer
    # steps on the card against the CPU from the same weights, within
    # TRAIN_TOL; per step one forward's DiP launches but the head (remat is
    # off in the reduced configurations; the fused loss takes the head) and
    # one lm_head_ce launch
    reduced_training = {}
    for arch_name in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "mamba2-370m",
                      "musicgen-medium", "phi-3-vision-4.2b"):
        fcfg = dataclasses.replace(get_config(arch_name).reduced(), **f32_dip)
        fparams = tf_model.init_params(fcfg, make_generator(SEED, "cpu"), "cpu")
        fruns = {}
        for where in ("cpu", "cuda"):
            reset_counts()
            fruns[where] = Trainer(fcfg, TrainerConfig(steps=3, ckpt_every=10 ** 9, ckpt_dir=os.path.join(
                ckpt_root, arch_name, where), log_every=10 ** 9), seq_len=64, global_batch=4, device=where).run(
                params=to_dev(fparams) if where == "cuda" else tree.map_tree(lambda t: t.clone(), fparams))
        got = read_counts()
        head = int("lm_head" in tf_model.param_template(fcfg))
        want = dict(dip_matmul=3 * (dip_per_forward(fcfg) - head), dip_matmul_q=0, dip_systolic=0,
                    flash_attention=0, lm_head_ce=3)
        if got != want:
            raise AssertionError(f"reduced {arch_name} training: card launches {got}, expected {want}")
        errs = []
        for a, b in zip(fruns["cuda"]["metrics"], fruns["cpu"]["metrics"]):
            for k in ("loss", "grad_norm"):
                errs.append(abs(a[k] - b[k]) / max(1.0, abs(b[k])))
                if errs[-1] > TRAIN_TOL or not np.isfinite(a[k]):
                    raise AssertionError(f"reduced {arch_name} training: step {a['step']} {k} card {a[k]} cpu {b[k]}")
        reduced_training[arch_name] = {"losses_card": [m["loss"] for m in fruns["cuda"]["metrics"]],
                                       "worst_rel": max(errs), "launches": got}
        log(f"  {arch_name} reduced, f32, 3 Trainer steps: card losses "
            f"{[round(m['loss'], 6) for m in fruns['cuda']['metrics']]}, worst |card - cpu| "
            f"{max(errs):.2e} of max(1, |cpu|) over losses and gradient norms (limit {TRAIN_TOL:g}); card launches "
            f"{got}")
        del fparams, fruns
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # the quantized straight-through backward: the reduced llama3-8b in f32
    # with int8 and with fp8 weights, the loss (the fused head, the int8 /
    # fp8 projections on the kernels) and the gradient of every float leaf
    # (the embedding, the norms and the lm_head's scales, which the fused
    # loss dequantizes; the projections' scales take none) on the card.
    # int8: against the CPU within TRAIN_TOL of max(1, |cpu|) (loss) or of
    # max|cpu leaf| (gradients): the same activation codes into exact
    # int32 sums.  fp8: the card multiplies bf16-cast activations by the
    # upcast weights (fp8_compute_dtype) where the CPU multiplies f32 ones,
    # and even against the plain versions on the card (the same bf16
    # products) an f32 difference in the last bit upstream now and then
    # casts an activation to the next bf16 value, so both runs are bf16
    # runs: FIRST_STEP_TOL's bf16 bounds (loss, largest leaf)
    def float_leaves(t, prefix=""):
        if isinstance(t, dict):
            return [pl for k in sorted(t) for pl in float_leaves(t[k], f"{prefix}/{k}")]
        return [(f"{prefix}.scale", t.scale)] if isinstance(t, api.QuantizedDipWeight) else [(prefix, t)]

    def loss_and_grads(qparams, qcfg, where, ctx):
        named = float_leaves(qparams)
        for _, t in named:
            t.requires_grad_(True)
        reset_counts()
        batch = {"tokens": toks.to(where), "labels": toks.to(where)}
        with ctx():
            loss = tf_model.loss_fn(qparams, qcfg, batch)
            grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
        return (float(loss.detach()), {p: None if gr is None else gr.cpu() for (p, _), gr in zip(named, grads)},
                read_counts())

    def held_to(what, got, want, loss_tol, leaf_tol):
        """The loss and each float leaf's gradient of ``got`` against ``want``;
        returns the worst leaf's error relative to max|want leaf| and the
        leaves without a gradient (on both sides, or it raises)."""
        if abs(got[0] - want[0]) > loss_tol * max(1.0, abs(want[0])):
            raise AssertionError(f"{what}: loss {got[0]} against {want[0]}")
        worst_g, none = 0.0, []
        for path, gw in want[1].items():
            gg = got[1][path]
            if (gw is None) != (gg is None):
                raise AssertionError(f"{what}: {path} has a gradient on one side only")
            if gw is None:
                none.append(path)
                continue
            rel = float((gg - gw).abs().max()) / max(float(gw.abs().max()), 1e-30)
            worst_g = max(worst_g, rel)
            if rel > leaf_tol:
                raise AssertionError(f"{what}: {path} {rel:.3e} of max|leaf| apart (limit {leaf_tol:g})")
        if "/lm_head.scale" in none or not all(p.endswith(".scale") for p in none):
            raise AssertionError(f"{what}: the leaves without a gradient are {none}")
        return worst_g, none

    qgrad = {}
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(2, rcfg.vocab_size, (2, 64)))
    for scheme in ("int8", "fp8_e4m3"):
        qcfg = dataclasses.replace(rcfg, quantization=scheme, matmul_backend=api.quant.scheme_info(scheme).backend)
        qcpu = tf_model.init_params(qcfg, make_generator(SEED, "cpu"), "cpu")
        card = loss_and_grads(to_dev(qcpu), qcfg, "cuda", contextlib.nullcontext)
        want_n = dict(dip_matmul=0, dip_matmul_q=6 * qcfg.n_layers, dip_systolic=0, flash_attention=0, lm_head_ce=1)
        if card[2] != want_n:
            raise AssertionError(f"quantized loss ({scheme}): card launches {card[2]}, expected {want_n}")
        cpu = loss_and_grads(qcpu, qcfg, "cpu", contextlib.nullcontext)
        loss_tol, leaf_tol = (TRAIN_TOL, TRAIN_TOL) if scheme == "int8" else FIRST_STEP_TOL["bfloat16"][::2]
        worst_g, none = held_to(f"quantized loss ({scheme}), card vs cpu", card, cpu, loss_tol, leaf_tol)
        qgrad[scheme] = {"loss_card": card[0], "loss_cpu": cpu[0], "launches": card[2], "worst_leaf_rel": worst_g,
                         "no_grad": len(none)}
        log(f"  quantized loss ({scheme}, f32, the straight-through backward): card {card[0]:.7f} cpu {cpu[0]:.7f} "
            f"(limit {loss_tol:g} x max(1, |cpu|)); {len(cpu[1]) - len(none)} float leaves' gradients, the worst "
            f"{worst_g:.3e} of max|cpu leaf| (limit {leaf_tol:g}); {len(none)} projection scales without one on both "
            f"sides; card launches {card[2]}")
        del qcpu, card, cpu

    # ------------------------------------- 9. the sharded backends and TP ---
    # Run once phase 5's weights are freed, against its first-token logits
    # and tokens (each rank draws the same weights from the seed); 9b after.
    def check_dispatch(phase, rows_by_rank):
        """9a / 9b: each case's ranks assembled into the global output, held
        to the plain version of the whole product and to the single-rank
        dispatch on the card (bf16 TOL of the output's magnitude: f32 sums
        cast once on each side); each rank's own launch to its plain version
        on the same inputs (``_held_launch``: the row partials' f32 store
        within f32 TOL, int8 bit for bit); the int8 row path to its shard
        body byte for byte (the ranks' f32 partials summed, two shards:
        order-free, then the one cast); the communicator's counts to the
        reference's contract, the kernels' counters to the logged launches;
        each rank's launch device ms beside the single-rank one."""
        out = []
        for i, row in enumerate(rows_by_rank[0]):
            per = [r[i] for r in rows_by_rank]
            kind, backend = row["kind"], row["backend"]
            if backend == "dip_tp" and kind == "row":
                got = per[0]["got"]
                if any(not np.array_equal(p["got"], got) for p in per):
                    raise AssertionError(f"phase {phase}: {row['label']}: the ranks' whole outputs differ")
            elif backend == "dip_fsdp" or (backend == "dip_sp" and kind == "row"):
                got = np.concatenate([p["got"] for p in per], 0)
            else:
                got = np.concatenate([p["got"] for p in per], -1)
            errs, ok = {}, True
            # int8: each K shard quantizes x with its own rows' maxima, so the
            # whole product is held within the quantization error (bf16 TOL
            # is not it) and the shard body byte for byte
            for what in ("plain", "single") if not row["scheme"] else ():
                want = row[what]
                errs[what] = float(np.abs(got - want).max())
                ok = ok and errs[what] <= TOL["bfloat16"] * max(1.0, float(np.abs(want).max()))
            body_equal = None
            if row["scheme"]:
                body = torch.from_numpy(sum(p["partial"] for p in per[1:]) + per[0]["partial"]).bfloat16().float()
                body_equal = bool(np.array_equal(got, body.numpy()))
                errs["plain"] = float(np.abs(got - row["plain"]).max())
                ok = ok and body_equal
            held = [p["held"] for p in per]
            ok = ok and all(h["ok"] for h in held)
            counts_ok = all(row["counts"].get(k, 0) == v for k, v in row["want_counts"].items()) and all(
                p["counted"] == p["counts"]["launch"] for p in per)
            rec = {"case": row["label"], "max_abs_err_vs_plain": errs["plain"],
                   "max_abs_err_vs_single": errs.get("single"), "within_tol": ok,
                   "int8_body_byte_equal": body_equal, "rank_launch_vs_plain": held, "counts": row["counts"],
                   "kernel_launches_counted": [p["counted"] for p in per],
                   "rank_launch_ms": [p["rank_ms"] for p in per], "single_rank_ms": per[0]["single_ms"]}
            tol_note = ("int8: the shard body byte for byte" if row["scheme"] else
                        f"tol {TOL['bfloat16']} x max(1, max|want|)")
            log(f"  {phase} {row['label']}: max|err| vs plain {errs['plain']:.3e}, vs the single-rank dispatch "
                f"{errs.get('single', float('nan')):.3e} ({tol_note})"
                f"{'' if body_equal is None else f', shard body byte-equal {body_equal}'}; each rank's launch "
                f"({held[0]['out_dtype']}) vs plain {['%.3e' % h['max_abs_err'] for h in held]} "
                f"({'bit for bit' if held[0]['exact'] else 'bounds ' + str(['%.3e' % h['bound'] for h in held])}); "
                f"counts {row['counts']} (want {row['want_counts']}), kernel counters "
                f"{rec['kernel_launches_counted']}; "
                f"each rank's launch {['%.4f' % v for v in rec['rank_launch_ms']]} ms, the single-rank dispatch "
                f"{per[0]['single_ms']:.4f} ms ({gpu})")
            if not (ok and counts_ok):
                raise AssertionError(f"phase {phase}: {row['label']}: {rec}")
            out.append(rec)
        return out

    def phase9(reqs, results, first_logits, serving):
        from repro_torch.distributed import run_world

        # 9d's single-rank engine: the reduced llama3-8b in f32 on dip, the same seed
        rcfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip",
                                   compute_dtype="float32", param_dtype="float32")
        prompts = [list(range(2, 9)), list(range(40, 57))]
        with uncounted():
            eng1 = Engine(rcfg, tf_model.init_params(rcfg, make_generator(SEED, "cuda"), "cuda"),
                          engine_cfg=EngineConfig(slots=2, max_seq=64, prefill_chunk=16), device="cuda")
            for rid, p in enumerate(prompts):
                eng1.add_request(p, SamplingParams(max_new_tokens=8), rid=rid)
            want_reduced = eng1.run()
            del eng1
        gc.collect()
        torch.cuda.empty_cache()  # the ranks share the card with this process
        t0 = time.perf_counter()
        # phase 5's first two requests (the time budget, PERF.md §4)
        outs = run_world(phase9_rank, 2, [r.prompt.tolist() for r in reqs[:SHARDED_REQUESTS]], prompts,
                         timeout=1100.0)
        world_s = time.perf_counter() - t0
        res = {"world_s": world_s}
        log(f"phase 9a: dip_tp / dip_fsdp / dip_sp at llama3-8b's gate+up and down, M = 4 and 256, bf16, and "
            f"dip_int8w for the dip_tp row, over 2 ranks sharing the card ({outs[0]['9c']['transport']} "
            f"transport)")
        res["9a"] = check_dispatch("9a", [o["9a"] for o in outs])

        # ---- 9c: llama3-8b tensor-parallel at full width ----
        n_layers = 32
        want_per_step = {"psum": 2 * n_layers + 1, "all_gather": 1, "reduce_scatter": 0, "ppermute": 0, "all_to_all": 0}
        log(f"phase 9c: llama3-8b full width, bf16, dip_tp over 2 ranks ({outs[0]['9c']['transport']} transport: "
            f"{outs[0]['9c']['eager_reason']}); phase 5's settings and its first {SHARDED_REQUESTS} requests")
        tp = [o["9c"] for o in outs]
        if any(t["results"] != tp[0]["results"] for t in tp):
            raise AssertionError("phase 9c: the ranks served different tokens")
        got = tp[0]["results"]
        cmp = {}
        if sorted(got) != list(range(SHARDED_REQUESTS)):
            raise AssertionError(f"phase 9c: not every request was served: {sorted(got)}")
        for rid in sorted(got):
            want_l, got_l = first_logits[rid], tp[0]["first_logits"][rid]
            scale = max(1.0, float(np.abs(want_l).max()))
            err = float(np.abs(got_l - want_l).max())
            a, b = list(results[rid]), list(got[rid])
            prefix = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            cmp[rid] = {"first_logits_max_abs_err": err, "scale": scale, "within": err <= FULL_TOL * scale,
                        "equal_prefix": prefix, "phase5": a, "tp": b}
            log(f"  request {rid}: first-token logits max|err| {err:.4e} against phase 5's (bound {FULL_TOL} x "
                f"{scale:.2f}); tokens equal for the first {prefix} of {len(a)}: tp {b} | phase 5 {a}")
        if not all(c["within"] for c in cmp.values()):
            raise AssertionError(f"phase 9c: first-token logits off phase 5's: {cmp}")
        per_rank = []
        for r, t in enumerate(tp):
            dec, pre = t["steps"]["_decode"], t["steps"]["_prefill_fwd"]
            bad = [s["collectives"] for s in dec + pre if s["collectives"] != want_per_step]
            bad_launches = [s["dip_launches"] for s in dec + pre if s["dip_launches"] != 193]
            # every launch bf16 x on the tensor cores: none on the f32-x route
            want_l = {"dip_matmul": 193 * (len(dec) + len(pre)), "dip_matmul_f32_x": 0, "flash_attention": 0}
            rec = {"rank": r, "decode_steps": len(dec), "prefill_chunks": len(pre),
                   "collectives_per_step": dec[0]["collectives"], "launches": t["launches"],
                   "median_decode_step_wall_ms": statistics.median(s["wall_ms"] for s in dec),
                   "median_prefill_chunk_wall_ms": statistics.median(s["wall_ms"] for s in pre),
                   "decode_step_device": t["profiled_device_ms"].get("_decode"),
                   "prefill_chunk_device": t["profiled_device_ms"].get("_prefill_fwd"),
                   "transport_ms": t["transport_ms"],
                   "peak_gib": t["peak_gib"], "peak_reserved_gib": t["peak_reserved_gib"],
                   "build_peak_gib": t["build_peak_gib"],
                   "weights_gib": t["weights_gib"], "kv_heads": t["kv_heads"], "build_s": t["build_s"],
                   "wall_s": t["wall_s"]}
            log(f"  rank {r}: {json.dumps(rec)} ({gpu})")
            if bad or bad_launches or t["launches"] != want_l:
                raise AssertionError(f"phase 9c rank {r}: collectives or launches off the design: {bad[:3]} "
                                     f"{bad_launches[:3]} {t['launches']} (want {want_per_step}, 193 a step, {want_l})")
            per_rank.append(rec)
            # each launch shape of the served forward, on the rank's own
            # storage, held to its plain version (``_held_served_launches``)
            for h in t["held_launches"]:
                log(f"  rank {r} {h['launch']} ({h['kind']}) M={h['m']} K={h['k']} N={h['n']} {h['epilogue']}/"
                    f"{h['prologue']} -> {h['out_dtype']}: max|err| vs plain {h['max_abs_err']:.3e} (bound "
                    f"{h['bound']:.3e}), {h['ms']:.4f} ms, plain {h['plain_ms']:.4f} ms, library "
                    f"{h['library_ms']:.4f} ms ({gpu})")
            if not all(h["ok"] for h in t["held_launches"]):
                raise AssertionError(f"phase 9c rank {r}: a served launch shape off its plain version: "
                                     f"{[h for h in t['held_launches'] if not h['ok']]}")
            rec["held_launches"] = t["held_launches"]
        log(f"  per step and rank: {sum(want_per_step.values())} collectives ({want_per_step}: one all-reduce "
            f"after wo and one after w_down in each of the {n_layers} layers, the embedding's all-reduce, the "
            f"logits' all-gather) and 193 DiP launches, each a shard (q/k/v, gate+up and the lm_head N/2; o and "
            f"down K/2); phase 5 single-rank: decode step {serving['median_decode_step_ms']:.3f} ms wall "
            f"(captured), prefill chunk {serving['median_prefill_chunk_ms']:.3f} ms")
        res["9c"] = {"requests": cmp, "ranks": per_rank, "transport": tp[0]["transport"],
                     "eager_reason": tp[0]["eager_reason"], "collectives_per_step": want_per_step}

        # ---- 9i: llama3-8b sequence-parallel on 9c's rank parameters ----
        # per step and rank: the embedding's reduce-scatter; per layer the
        # ring hops of wq, wk, wv and gate+up and the reduce-scatters of wo and
        # w_down; the lm_head's hop and the logits' all-gather of vocab.  Per
        # step 32 x 10 + 2 launches: each column projection T = 2 launches
        sp_step = {"psum": 0, "all_gather": 1, "reduce_scatter": 2 * n_layers + 1, "ppermute": 4 * n_layers + 1,
                   "all_to_all": 0}
        sp_launches = 10 * n_layers + 2
        sp = [o["9i"] for o in outs]
        log(f"phase 9i: llama3-8b full width, bf16, sequence parallel (dip_sp) over 2 ranks on 9c's rank parameters "
            f"({sp[0]['eager_reason']}); 9c's settings and requests, {SP_TOKENS} greedy tokens each; the rank's "
            f"wall {[round(o['phase_s'], 1) for o in sp]} s")
        if any(t["results"] != sp[0]["results"] for t in sp):
            raise AssertionError("phase 9i: the ranks served different tokens")
        got_sp = sp[0]["results"]
        if sorted(got_sp) != list(range(SHARDED_REQUESTS)) or any(len(v) != SP_TOKENS for v in got_sp.values()):
            raise AssertionError(f"phase 9i: not every request got its {SP_TOKENS} tokens: {got_sp}")
        cmp_sp = {}
        for rid in sorted(got_sp):
            want_l, got_l = first_logits[rid], sp[0]["first_logits"][rid]
            scale = max(1.0, float(np.abs(want_l).max()))
            err = float(np.abs(got_l - want_l).max())
            a, b, c9 = list(results[rid]), list(got_sp[rid]), list(got[rid])
            prefix = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            cmp_sp[rid] = {"first_logits_max_abs_err": err, "scale": scale, "within": err <= FULL_TOL * scale,
                           "equal_prefix_phase5": prefix, "sp": b, "tp": c9, "phase5": a}
            log(f"  request {rid}: first-token logits max|err| {err:.4e} against phase 5's (bound {FULL_TOL} x "
                f"{scale:.2f}); tokens equal to phase 5's for the first {prefix}: sp {b} | 9c tp {c9[:SP_TOKENS]} | "
                f"phase 5 {a[:SP_TOKENS]}")
        if not all(c["within"] for c in cmp_sp.values()):
            raise AssertionError(f"phase 9i: first-token logits off phase 5's: {cmp_sp}")
        per_rank_sp = []
        for r, t in enumerate(sp):
            dec, pre = t["steps"]["_decode"], t["steps"]["_prefill_fwd"]
            bad = [(s["collectives"], s["dip_launches"], s["replicated"]) for s in dec + pre
                   if s["collectives"] != sp_step or s["dip_launches"] != sp_launches or s["replicated"]]
            want_l = {"dip_matmul": sp_launches * (len(dec) + len(pre)), "dip_matmul_f32_x": 0, "flash_attention": 0}
            rec = {"rank": r, "decode_steps": len(dec), "prefill_chunks": len(pre),
                   "collectives_per_step": dec[0]["collectives"], "launches": t["launches"],
                   "replicated_per_step": dec[0]["replicated"],
                   "median_decode_step_wall_ms": statistics.median(s["wall_ms"] for s in dec),
                   "median_prefill_chunk_wall_ms": statistics.median(s["wall_ms"] for s in pre),
                   "decode_step_device": t["profiled_device_ms"].get("_decode"),
                   "prefill_chunk_device": t["profiled_device_ms"].get("_prefill_fwd"),
                   "peak_gib": t["peak_gib"], "peak_reserved_gib": t["peak_reserved_gib"],
                   "kv_heads": t["kv_heads"], "wall_s": t["wall_s"]}
            log(f"  rank {r}: {json.dumps(rec)} ({gpu})")
            if bad or t["launches"] != want_l:
                raise AssertionError(f"phase 9i rank {r}: collectives, launches or replicated weights off the "
                                     f"design: {bad[:3]} {t['launches']} (want {sp_step}, {sp_launches} a step, "
                                     f"no replicated weight, {want_l})")
            for h in t["held_launches"]:
                log(f"  rank {r} {h['launch']} ({h['kind']}) M={h['m']} K={h['k']} N={h['n']} {h['epilogue']}/"
                    f"{h['prologue']} -> {h['out_dtype']}: max|err| vs plain {h['max_abs_err']:.3e} (bound "
                    f"{h['bound']:.3e}), {h['ms']:.4f} ms, plain {h['plain_ms']:.4f} ms, library "
                    f"{h['library_ms']:.4f} ms ({gpu})")
            if not all(h["ok"] for h in t["held_launches"]):
                raise AssertionError(f"phase 9i rank {r}: a served launch shape off its plain version: "
                                     f"{[h for h in t['held_launches'] if not h['ok']]}")
            rec["held_launches"] = t["held_launches"]
            per_rank_sp.append(rec)
        log(f"  per step and rank: {sum(sp_step.values())} collectives ({sp_step}) and {sp_launches} DiP launches "
            f"(each column projection on both ranks' rows in turn: 128 of a chunk's 256, 2 of a decode step's 4; "
            f"the row projections on all rows, K / 2); 9c's tp step {sum(want_per_step.values())} and 193")
        res["9i"] = {"requests": cmp_sp, "ranks": per_rank_sp, "collectives_per_step": sp_step,
                     "launches_per_step": sp_launches, "phase_s": [o["phase_s"] for o in sp]}

        # ---- 9d: reduced f32 TP against the single-rank engine, exactly ----
        got_r = [o["9d"]["results"] for o in outs]
        log(f"phase 9d: reduced llama3-8b, f32, dip_tp over 2 ranks on the card: tokens {got_r[0]}; the single-rank "
            f"engine's {want_reduced}")
        if any(g != want_reduced for g in got_r):
            raise AssertionError("phase 9d: the sharded engine's tokens differ from the single-rank engine's")
        f32_x = [o["9d"]["dip_f32_x_launches"] for o in outs]
        log(f"  9d's DiP launches a rank {[o['9d']['dip_launches'] for o in outs]}, of them on the f32-x route "
            f"(IEEE FMAs on the CUDA cores, the first design): {f32_x}")
        res["9d"] = {"equal": True, "tokens": want_reduced, "f32_x_launches": f32_x}

        # ---- 9b: the same dispatch in a 1-rank NCCL world ----
        log("phase 9b: the 9a calls in a 1-rank NCCL world on the card")
        t0 = time.perf_counter()
        nccl = run_world(phase9_nccl_rank, 1, timeout=600.0)
        log(f"  the 1-rank NCCL world {time.perf_counter() - t0:.1f} s")
        res["9b"] = check_dispatch("9b", nccl)
        res["launches"] = {"serve_tp": {"dip_matmul": sum(t["launches"]["dip_matmul"] for t in tp),
                                        "dip_matmul_f32_x": 0, "flash_attention": 0},
                           "serve_sp": {"dip_matmul": sum(t["launches"]["dip_matmul"] for t in sp),
                                        "dip_matmul_f32_x": 0, "flash_attention": 0},
                           "serve_tp_reduced": {"dip_matmul": sum(o["9d"]["dip_launches"] for o in outs),
                                                "dip_matmul_f32_x": sum(f32_x)}}
        res["10a"] = check_train10("10a", [o["10a"] for o in outs], "llama3-8b tensor-parallel training at full width cut to "
                                   f"{TRAIN10_LAYERS} layers (f32 parameters, bf16 compute, block remat, "
                                   f"{TRAIN10_STEPS} AdamW steps at batch {TRAIN10_BATCH[0]} x {TRAIN10_BATCH[1]})",
                                   gpu)
        res["10d"] = check_train10("10d", [o["10d"] for o in outs], "llama3-8b over 2 pipeline stages at full width "
                                   f"cut to {TRAIN10D_LAYERS} layers (f32 parameters, bf16 compute, {TRAIN10_STEPS} "
                                   f"AdamW steps at batch {TRAIN10D_BATCH[0]} x {TRAIN10D_BATCH[1]} in 4 "
                                   "microbatches; 10e: the first step's gradients compressed, steps 2-3 with "
                                   "--compress-grads)", gpu)
        res["10e"] = check_train10e([o["10e"] for o in outs], gpu)
        res["10c"] = check_train10c([o["10c"] for o in outs])
        for strategy, fam in TRAIN10_DRILLS:
            name = f"{strategy}/{fam}"
            res["10c"][f"drill {name}"] = check_train10(
                "10c", [o["10c"]["drills"][name] for o in outs],
                f"{name}, the checkpoint drill on the reduced model in f32 (3 AdamW steps at batch "
                f"{TRAIN10_ROWS.get(strategy, 2)} x 32)", gpu,
                want=TRAIN10_PAIRS[(strategy, fam)], want_dip=outs[0]["10c"]["pairs"][name]["dip_launches"],
                dtype="float32")
        res["launches"]["train_tp_llama3"] = {
            "dip_matmul": sum(st["dip_launches"] for o in outs for st in o["10a"]["steps"]), "dip_matmul_f32_x": 0,
            "lm_head_ce": 0, "flash_attention": 0}
        res["launches"]["train_reduced_pairs"] = {
            "dip_matmul": sum(p["dip_launches"] for o in outs for p in o["10c"]["pairs"].values()),
            "dip_matmul_f32_x": res["10c"]["f32_x_launches"]}
        res["launches"]["train_pp_llama3"] = {
            "dip_matmul": sum(st["dip_launches"] for o in outs for st in o["10d"]["steps"]), "dip_matmul_f32_x": 0,
            "lm_head_ce": 0, "flash_attention": 0}
        res["launches"]["train_reduced_compressed"] = {"dip_matmul": res["10e"]["dip_matmul"],
                                                       "dip_matmul_f32_x": res["10e"]["dip_matmul"]}
        log(f"  phase 9 wall: the 2-rank world {world_s:.1f} s (9a-9d, 10a, 10d, 10e, 10c)")
        return res

    # ------------------------- 9e. expert parallelism at full width --------
    def phase9e(rec):
        """DeepSeek-V2-Lite under ``ep`` over 2 ranks sharing the card
        (``phase9e_rank``), held to 5d's records (``ep_records``); (f)'s
        reduced models against single-rank engines on the card from the
        same seed; then 9k, DeepSeek-V2-Lite cut to ``DS_CUT_LAYERS`` layers
        under ``fsdp`` in the same world, held to the single-rank cut model
        on the same seed (its prefill step's first-token logits and expert
        ids on each prompt, its engine's tokens)."""
        from repro_torch.distributed import run_world

        prompts = [list(range(2, 9)), list(range(40, 57))]
        cut = dataclasses.replace(ds_config(), n_layers=DS_CUT_LAYERS)
        rec_9k = {"prompts": [[int(t) for t in p[:DS_CUT_TOKENS]] for p in rec["prompts"][:2]], "ids": []}
        first_9k = []
        with uncounted():
            p1 = tf_model.init_params(cut, make_generator(SEED, "cuda"), "cuda")
            # the engine's prefill step on a cache of its prefill cache's
            # length (MLA with a cache is the absorbed form, which attends
            # over every row of it)
            step = tf_model.decode_step_fn(cut)
            for p in rec_9k["prompts"]:
                trace = {}
                with torch.no_grad():
                    logits = step(p1, tf_model.init_cache(cut, 1, DS_CUT_MAX_SEQ, device="cuda"),
                                  torch.as_tensor([p], device=dev), trace)[0]
                first_9k.append(logits[0, -1, :cut.vocab_size].float().cpu().numpy())
                rec_9k["ids"].append([i.cpu().numpy() for i in trace["ids"]])
                del logits
            e1 = Engine(cut, p1, engine_cfg=EngineConfig(slots=2, max_seq=DS_CUT_MAX_SEQ, prefill_chunk=DS_CUT_TOKENS),
                        device="cuda")
            for rid, p in enumerate(rec_9k["prompts"]):
                e1.add_request(p, SamplingParams(max_new_tokens=2), rid=rid)
            tokens_9k = e1.run()
            del e1, p1, step
        single = {}
        with uncounted():
            for name, arch, strategy, ample in DS_REDUCED:
                c1 = reduced_moe_config(arch, ample=ample)
                p1 = tf_model.init_params(c1, make_generator(SEED, "cuda"), "cuda")
                trace = {}
                with torch.no_grad():
                    tf_model.forward(p1, c1, tokens=torch.as_tensor([prompts[0]], device=dev), moe_trace=trace)
                e1 = Engine(c1, p1, engine_cfg=EngineConfig(slots=2, max_seq=64, prefill_chunk=16), device="cuda")
                for rid, p in enumerate(prompts):
                    e1.add_request(p, SamplingParams(max_new_tokens=8), rid=rid)
                single[name] = {"results": e1.run(), "dropped": sum(int(v) for v in trace["dropped"])}
                del e1, p1, trace
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_world(phase9e_rank, 2, rec, prompts, rec_9k, timeout=1100.0)
        world_s = time.perf_counter() - t0
        n_layers = 27
        want_step = {"psum": 2 * n_layers + 1, "all_gather": 2 * n_layers + 1, "reduce_scatter": 0, "ppermute": 0,
                     "all_to_all": 2 * n_layers}
        res = {"world_s": world_s, "collectives_per_step": want_step}

        log("phase 9e(a): each rank's slice of 5d's weights, drawn from the seed (init_params(plan=))")
        for r, o in enumerate(outs):
            a = o["a"]
            log(f"  rank {r}: {json.dumps(a)} ({gpu})")
            if not a["banks_equal"] or a["experts"] != [32 * r, 32] or a["shared_storage"] != [27, 2048, 2816]:
                raise AssertionError(f"phase 9e(a) rank {r}: the rank's experts or shared experts are not 5d's: {a}")
        res["a"] = [o["a"] for o in outs]

        log(f"phase 9e(b): the (2, {EP_CHUNK}) forward split by batch against 5d's logits (bound {FULL_TOL} x "
            f"max(1, max|5d|))")
        for r, o in enumerate(outs):
            b = o["b"]
            bound = FULL_TOL * b["scale"]
            log(f"  rank {r}: free routing: max|err| {b['free']['max_abs_err']:.4e}, {b['free']['choices_differing']} "
                f"of the rank's {EP_CHUNK * 6 * n_layers} top-6 choices differ from 5d's, dropped "
                f"{sum(b['free']['dropped'])} (5d {sum(rec['dropped'])}); 5d's choices replayed: max|err| "
                f"{b['replayed']['max_abs_err']:.4e} (bound {bound:.4f}), dropped by layer equal "
                f"{b['replayed']['dropped'] == rec['dropped']}; collectives {b['replayed']['collectives']}")
            if (b["replayed"]["max_abs_err"] > bound or not b["replayed"]["finite"] or b["replayed"]["dropped"] !=
                    rec["dropped"] or b["replayed"]["collectives"] != want_step):
                raise AssertionError(f"phase 9e(b) rank {r}: the expert-parallel forward is off 5d's: {b}")
        res["b"] = [o["b"] for o in outs]

        log(f"phase 9e(c): layer 0's MoE on the chunk shape (1, {EP_CHUNK}), split by sequence, against 5d's "
            f"plain moe_ffn on each half")
        want_c = {"psum": 1, "all_gather": 1, "reduce_scatter": 0, "ppermute": 0, "all_to_all": 2, "launch": 2}
        for r, o in enumerate(outs):
            c = o["c"]
            log(f"  rank {r}: max|err| {c['max_abs_err']:.4e} (bound {c['bound']:.4e}), dropped {c['dropped']} (5d's "
                f"halves {rec['halves_dropped']}, capacity {c['capacity']}), the rank's ids equal 5d's half's "
                f"{c['ids_equal']}; counts {c['counts']}, schedule {c['schedule']}")
            if (c["max_abs_err"] > c["bound"] or c["dropped"] != rec["halves_dropped"] or not c["ids_equal"]
                    or c["counts"] != want_c or c["schedule"] != ["all_to_all", "launch", "launch", "all_to_all",
                                                                  "psum", "all_gather"]):
                raise AssertionError(f"phase 9e(c) rank {r}: the expert-parallel layer is off 5d's halves: {c}")
        res["c"] = [o["c"] for o in outs]

        d0 = outs[0]["d"]
        log(f"phase 9e(d): Engine(plan=) at 5d's settings (4 slots, max_seq 1024, chunk {EP_CHUNK}) over 2 ranks "
            f"({d0['eager_reason']}); 5d's first {SHARDED_REQUESTS} requests, 8 greedy tokens each")
        if any(o["d"]["results"] != d0["results"] for o in outs):
            raise AssertionError("phase 9e(d): the ranks served different tokens")
        if sorted(d0["results"]) != list(range(SHARDED_REQUESTS)) or any(len(v) != 8 for v in d0["results"].values()):
            raise AssertionError(f"phase 9e(d): not every request got its 8 tokens: {d0['results']}")
        cmp = {}
        for rid in sorted(d0["first_logits"]):
            want_l = rec["first_logits"][rid]
            got_l = d0["first_logits"][rid]
            a, bb = list(rec["results"][rid][:8]), list(d0["results"][rid])
            prefix = next((i for i, (x, y) in enumerate(zip(a, bb)) if x != y), len(bb))
            cmp[rid] = {"first_logits_max_abs_err": float(np.abs(got_l - want_l).max()),
                        "scale": max(1.0, float(np.abs(want_l).max())), "equal_prefix": prefix, "ep": bb, "phase5d": a}
            log(f"  request {rid} ({len(rec['prompts'][rid])} tokens): first-token logits max|err| "
                f"{cmp[rid]['first_logits_max_abs_err']:.4e} against 5d's (max|5d| {cmp[rid]['scale']:.3g}; printed, "
                f"not held: the sequence split drops other pairs); tokens equal for the first {prefix} of 8: ep {bb} "
                f"| 5d {a}")
        per_rank = []
        for r, o in enumerate(outs):
            d = o["d"]
            dec, pre = d["steps"]["_decode"], d["steps"]["_prefill_fwd"]
            bad = [s_["collectives"] for s_ in dec + pre if s_["collectives"] != want_step]
            bad_launches = [s_["dip_launches"] for s_ in dec + pre if s_["dip_launches"] != 163]
            order = all(s_["dispatch_first"] for s_ in dec + pre)
            rec_r = {"rank": r, "decode_steps": len(dec), "prefill_chunks": len(pre),
                     "collectives_per_step": dec[0]["collectives"], "launches": d["launches"],
                     "dispatch_before_shared_launches": order,
                     "median_decode_step_wall_ms": statistics.median(s_["wall_ms"] for s_ in dec),
                     "median_prefill_chunk_wall_ms": statistics.median(s_["wall_ms"] for s_ in pre),
                     "decode_step_device": d["profiled_device_ms"].get("_decode"),
                     "prefill_chunk_device": d["profiled_device_ms"].get("_prefill_fwd"),
                     "peak_gib": d["peak_gib"], "peak_reserved_gib": d["peak_reserved_gib"],
                     "weights_gib": o["a"]["weights_gib"], "build_peak_gib": o["a"]["build_peak_gib"],
                     "build_s": o["a"]["build_s"], "wall_s": d["wall_s"], "pools": d["pools"]}
            log(f"  rank {r}: {json.dumps(rec_r)} ({gpu})")
            want_l = {"dip_matmul": 163 * (len(dec) + len(pre)), "dip_matmul_f32_x": 0}
            if bad or bad_launches or not order or d["launches"] != want_l:
                raise AssertionError(f"phase 9e(d) rank {r}: collectives, launches or the dispatch order off the "
                                     f"design: {bad[:3]} {bad_launches[:3]} {order} {d['launches']} (want {want_step}, "
                                     f"163 a forward)")
            per_rank.append(rec_r)
        log(f"  per step and rank: {sum(want_step.values())} collectives ({want_step}: in each of the {n_layers} "
            f"layers w_dkv's all-gather, wo's all-reduce, the MoE's dispatch and combine all-to-alls, its stats' "
            f"all-reduce and its tokens' all-gather; the embedding's all-reduce, the logits' all-gather) and 163 DiP "
            f"launches; each dispatch before the shared experts' launches")
        res["d"] = {"requests": cmp, "ranks": per_rank, "eager_reason": d0["eager_reason"]}

        log("phase 9e(e): each launch shape of the served forward on the rank's own storage against its plain "
            "version")
        for r, o in enumerate(outs):
            for h in o["e"]:
                log(f"  rank {r} {h['launch']} ({h['kind']}) M={h['m']} K={h['k']} N={h['n']} {h['epilogue']}/"
                    f"{h['prologue']} -> {h['out_dtype']}: max|err| vs plain {h['max_abs_err']:.3e} (bound "
                    f"{h['bound']:.3e}), {h['ms']:.4f} ms, plain {h['plain_ms']:.4f} ms, library "
                    f"{h['library_ms']:.4f} ms ({gpu})")
            if not all(h["ok"] for h in o["e"]):
                raise AssertionError(f"phase 9e(e) rank {r}: a launch shape off its plain version: "
                                     f"{[h for h in o['e'] if not h['ok']]}")
        res["e"] = outs[0]["e"]

        log("phase 9e(f): the reduced models in f32 over the 2 ranks against single-rank engines on the card "
            "(ep: capacity factor E / k)")
        for name, arch, strategy, ample in DS_REDUCED:
            got = [o["f"][name] for o in outs]
            log(f"  {name}: tokens {got[0]['results']}; the single-rank engine's {single[name]['results']}; dropped "
                f"pairs in a forward of the first prompt: ranks {[g['dropped'] for g in got]}, single rank "
                f"{single[name]['dropped']}; DiP launches a rank {[g['dip_launches'] for g in got]} (f32 x "
                f"{[g['dip_f32_x_launches'] for g in got]})")
            if any(g["results"] != single[name]["results"] for g in got):
                raise AssertionError(f"phase 9e(f) {name}: the sharded engine's tokens differ from the single rank's")
            if ample and (single[name]["dropped"] or any(g["dropped"] for g in got)):
                raise AssertionError(f"phase 9e(f) {name}: pairs dropped at capacity factor E / k")
        res["f"] = {name: {"tokens": single[name]["results"]} for name, *_ in DS_REDUCED}
        res["9k"] = check_9k(outs, rec_9k, first_9k, tokens_9k)
        res["launches"] = {
            "serve_fsdp_deepseek": {"dip_matmul": sum(o["9k"]["launches"]["dip_matmul"] for o in outs),
                                    "dip_matmul_f32_x": sum(o["9k"]["launches"]["dip_matmul_f32_x"] for o in outs)},
            "serve_ep": {"dip_matmul": sum(o["d"]["launches"]["dip_matmul"] for o in outs), "dip_matmul_f32_x": 0},
            "serve_ep_reduced": {"dip_matmul": sum(o["f"][nm]["dip_launches"] for o in outs for nm, *_ in DS_REDUCED),
                                 "dip_matmul_f32_x": sum(o["f"][nm]["dip_f32_x_launches"] for o in outs
                                                         for nm, *_ in DS_REDUCED)}}
        res["10b"] = check_train10("10b", [o["10b"] for o in outs], "DeepSeek-V2-Lite expert-parallel training at "
                                   f"full width cut to {TRAIN10_LAYERS} layers (as 10a; the single-rank step "
                                   "replaying the ranks' expert ids)", gpu)
        res["launches"]["train_ep_deepseek"] = {
            "dip_matmul": sum(st["dip_launches"] for o in outs for st in o["10b"]["steps"]), "dip_matmul_f32_x": 0,
            "lm_head_ce": 0, "flash_attention": 0}
        log(f"  phase 9e wall: the 2-rank world {world_s:.1f} s (9e, 9k, 10b)")
        return res

    def check_9k(outs, rec_9k, first_9k, tokens_9k):
        """9k: the ranks' DeepSeek-V2-Lite under ``fsdp`` (``_phase9k``)
        against the single-rank cut model: first-token logits within
        FULL_TOL (with the single-rank expert choices replayed where a
        prompt's differ), every call's all-gathers and launches exactly,
        every launch shape against its plain version."""
        n_layers = DS_CUT_LAYERS
        # per layer: the router and 3 banks, wq, w_dkv, w_krope, wo, w_uk and
        # w_uv, the 3 shared experts' storage; the embedding's columns and the
        # lm_head's storage; a decode step's logits' rows (its 2 slots split)
        per_layer = 13
        want = {k: {"psum": 0, "all_gather": per_layer * n_layers + 2 + (k == "_decode"), "reduce_scatter": 0,
                    "ppermute": 0, "all_to_all": 0} for k in ("_prefill_fwd", "_decode")}
        per_forward = 6 * n_layers + 1  # wq, w_dkv, w_krope, wo, shared gate+up and down; the lm_head
        o0 = outs[0]["9k"]
        log(f"phase 9k: deepseek-v2-lite-16b full width cut to {n_layers} of 27 layers, bf16, fsdp (ZeRO-3: each "
            f"rank K / 2 of every projection and half of each expert bank's contraction dim and the router's d) over "
            f"2 ranks sharing the card ({o0['eager_reason']}); 2 slots, 2 prompts of {DS_CUT_TOKENS} tokens cut from "
            f"5d's, 2 greedy tokens each; the rank's wall {[round(o['9k']['phase_s'], 1) for o in outs]} s")
        if any(o["9k"]["results"] != o0["results"] for o in outs):
            raise AssertionError("phase 9k: the ranks served different tokens")
        if sorted(o0["results"]) != [0, 1] or any(len(v) != 2 for v in o0["results"].values()):
            raise AssertionError(f"phase 9k: not every request got its 2 tokens: {o0['results']}")
        firsts = []
        for rid, want_l in enumerate(first_9k):
            scale = max(1.0, float(np.abs(want_l).max()))
            row = {"scale": scale, "flips": [o["9k"]["flips"][rid] for o in outs]}
            for r, o in enumerate(outs):
                err = float(np.abs(o["9k"]["first_logits"][rid] - want_l).max())
                rep_l = o["9k"]["replayed_logits"].get(rid)
                rep_err = None if rep_l is None else float(np.abs(rep_l - want_l).max())
                row[f"rank{r}"] = {"max_abs_err_free": err, "max_abs_err_replayed": rep_err}
                if not (err <= FULL_TOL * scale or (rep_err is not None and rep_err <= FULL_TOL * scale)):
                    raise AssertionError(f"phase 9k request {rid} rank {r}: first-token logits off the single-rank "
                                         f"cut model's: {row}")
            log(f"  request {rid}: first-token logits against the single-rank cut model (bound {FULL_TOL} x "
                f"{scale:.3g}): {json.dumps(row)}; tokens {o0['results'][rid]} | single rank {tokens_9k[rid]}")
            firsts.append(row)
        per_rank = []
        for r, o in enumerate(outs):
            d = o["9k"]
            bad = [(k, c["collectives"], c["dip_launches"]) for k, calls in d["steps"].items() for c in calls
                   if c["collectives"] != want[k] or c["dip_launches"] != per_forward]
            n_calls = sum(len(v) for v in d["steps"].values())
            rec_r = {"rank": r, "calls": {k: len(v) for k, v in d["steps"].items()},
                     "collectives_per_step": {k: v[0]["collectives"] for k, v in d["steps"].items()},
                     "dip_launches_per_step": per_forward, "launches": d["launches"],
                     "median_wall_ms": {k: statistics.median(c["wall_ms"] for c in v) for k, v in d["steps"].items()},
                     "profiled_device_ms": d["profiled_device_ms"], "gathered_bytes_per_forward": d["gathered_bytes"],
                     "peak_gib": d["peak_gib"], "peak_reserved_gib": d["peak_reserved_gib"],
                     "weights_gib": d["weights_gib"], "build_peak_gib": d["build_peak_gib"], "build_s": d["build_s"],
                     "wall_s": d["wall_s"], "pools": d["pools"]}
            log(f"  rank {r}: {json.dumps(rec_r)} ({gpu})")
            if bad or d["launches"] != {"dip_matmul": per_forward * n_calls, "dip_matmul_f32_x": 0} \
                    or set(d["steps"]) != {"_prefill_fwd", "_decode"}:
                raise AssertionError(f"phase 9k rank {r}: all-gathers or launches off the design: {bad[:3]} "
                                     f"{d['launches']} (want {want}, {per_forward} a forward)")
            per_rank.append(rec_r)
        log(f"  per call and rank: {want['_prefill_fwd']['all_gather']} all-gathers a prefill chunk, "
            f"{want['_decode']['all_gather']} a decode step, {per_forward} DiP launches; the weights' storage "
            f"assembled a forward {o0['gathered_bytes']} bytes, half of it from the other rank through host memory; "
            f"the rank's shards {json.dumps(o0['shards'])}")
        log("phase 9k: each launch shape of the forward on the gathered storage against its plain version")
        for r, o in enumerate(outs):
            for h in o["9k"]["held_launches"]:
                log(f"  rank {r} {h['launch']} ({h['kind']}) M={h['m']} K={h['k']} N={h['n']} {h['epilogue']}/"
                    f"{h['prologue']} -> {h['out_dtype']}: max|err| vs plain {h['max_abs_err']:.3e} (bound "
                    f"{h['bound']:.3e}), {h['ms']:.4f} ms, plain {h['plain_ms']:.4f} ms, library "
                    f"{h['library_ms']:.4f} ms ({gpu})")
            if not all(h["ok"] for h in o["9k"]["held_launches"]):
                raise AssertionError(f"phase 9k rank {r}: a launch shape off its plain version: "
                                     f"{[h for h in o['9k']['held_launches'] if not h['ok']]}")
        return {"ranks": per_rank, "first_logits": firsts, "tokens": o0["results"], "single_tokens": tokens_9k,
                "held": o0["held_launches"], "gathered_bytes": o0["gathered_bytes"],
                "phase_s": [o["9k"]["phase_s"] for o in outs]}

    # ----------------- 9f-9h. the SSM / hybrid families under tp and fsdp ----
    def z_records(eng, orig, reqs):
        """What phases 9f and 9g are held to, from 5e's single-rank engine
        (its captured steps, the hooks taken off): the first-token logits of
        9f's prompts (5e's requests 1 and 0 cut to 256 + 3 and 512 + 2
        tokens) and 9g's (request 2 cut to 256 + 1: one request, the time
        budget, PERF.md §4; its decode steps still split 2 slots 1 / 1),
        uncounted."""
        for attr, f in orig.items():
            setattr(eng, attr, f)
        tp_prompts = [reqs[1].prompt[:259], reqs[0].prompt[:514]]
        fsdp_prompts = [reqs[2].prompt[:257]]
        first = {}
        record_first_logits(eng, eng.cfg.vocab_size, first)
        with uncounted():
            for rid, p in enumerate(tp_prompts + fsdp_prompts):
                eng.add_request(p, SamplingParams(max_new_tokens=1), rid=100 + rid)
            eng.run()
        del eng._finish_prefill
        # the same bf16 weights in f32 (torch.matmul), each whole prompt at
        # once: the yardstick of a free-running bf16 run's drift (gate 2)
        c32 = dataclasses.replace(eng.cfg, param_dtype="float32", compute_dtype="float32", matmul_backend="torch")

        def f32_of(t):
            if isinstance(t, dict):
                return {k: f32_of(x) for k, x in t.items()}
            return t.with_data(t.data.float()) if isinstance(t, api.DipWeight) else t.float()

        p32, f32 = f32_of(eng.params), []
        with uncounted(), torch.no_grad():
            for p in tp_prompts + fsdp_prompts:
                logits = tf_model.forward(p32, c32, tokens=torch.as_tensor(np.asarray(p), device=dev)[None])[0]
                f32.append(logits[0, -1, :c32.vocab_size].float().cpu().numpy())
                del logits
        del p32
        torch.cuda.empty_cache()
        log(f"  recorded for phases 9f / 9g: the first-token logits of {[len(p) for p in tp_prompts]}- and "
            f"{[len(p) for p in fsdp_prompts]}-token prompts cut from requests 1, 0 and 2, and of the same "
            f"bf16 weights in f32")
        n_tp = len(tp_prompts)
        firsts = [first[100 + i] for i in range(n_tp + len(fsdp_prompts))]
        return {"tp_prompts": [p.tolist() for p in tp_prompts], "fsdp_prompts": [p.tolist() for p in fsdp_prompts],
                "tp_first": firsts[:n_tp], "fsdp_first": firsts[n_tp:], "tp_f32": f32[:n_tp], "fsdp_f32": f32[n_tp:]}

    def check_9j(outs, rec):
        """9j: Zamba2-2.7B under ``sp`` on 9f's rank parameters
        (``_phase9j``), held as 9f is: first-token logits no further from
        the f32 run than F32_DRIFT times 5e's (FULL_TOL printed beside),
        every call's collectives, launches and replicated dispatches
        exactly, every launch shape against its plain version."""
        n_layers, sites = 54, 9
        # per call and rank: the embedding's reduce-scatter; per Mamba2 layer
        # in_proj's ring hop and gather of columns, the gated norm's psum,
        # out_proj's reduce-scatter; per site the hops of wq, wk, wv and
        # gate+up and the reduce-scatters of wo and w_down; the lm_head's hop
        # and the logits' gather of vocab
        step = {"psum": n_layers, "all_gather": n_layers + 1, "reduce_scatter": 1 + n_layers + 2 * sites,
                "ppermute": n_layers + 4 * sites + 1, "all_to_all": 0}
        per_call = 3 * n_layers + 10 * sites + 2
        o0 = outs[0]["9j"]
        log(f"phase 9j: zamba2-2.7b full width, bf16, sequence parallel (dip_sp) over 2 ranks on 9f's rank parameters "
            f"({o0['eager_reason']}); 9f's prompts {[len(p) for p in rec['tp_prompts']]}, 4 greedy tokens each (the "
            f"tail tokens one real row: rank 1 a pad row); the rank's wall {[round(o['9j']['phase_s'], 1) for o in outs]}"
            f" s")
        if any(o["9j"]["results"] != o0["results"] for o in outs):
            raise AssertionError("phase 9j: the ranks served different tokens")
        if sorted(o0["results"]) != [0, 1] or any(len(v) != 4 for v in o0["results"].values()):
            raise AssertionError(f"phase 9j: not every request got its 4 tokens: {o0['results']}")
        firsts = []
        for rid, want_l in enumerate(rec["tp_first"]):
            got_l, f32 = o0["first_logits"][rid], rec["tp_f32"][rid]
            err, scale = float(np.abs(got_l - want_l).max()), max(1.0, float(np.abs(want_l).max()))
            s32, r32 = float(np.abs(got_l - f32).max()), float(np.abs(want_l - f32).max())
            log(f"  request {rid}: first-token logits max|err| {err:.4e} against 5e's single-rank engine "
                f"({FULL_TOL} x max(1, max|5e|) = {FULL_TOL * scale:.4f}: "
                f"{'within' if err <= FULL_TOL * scale else 'beyond'}); against the f32 run {s32:.4e}, 5e's "
                f"{r32:.4e} (bound {F32_DRIFT} x 5e's); argmax {int(np.argmax(got_l))} | 5e {int(np.argmax(want_l))} "
                f"| f32 {int(np.argmax(f32))}; tokens sp {o0['results'][rid]} | 9f tp {outs[0]['9f']['results'][rid]}")
            if not s32 <= F32_DRIFT * r32:
                raise AssertionError(f"phase 9j request {rid}: the first-token logits drift from the f32 run "
                                     f"({s32:.4e}) beyond {F32_DRIFT} x 5e's ({r32:.4e})")
            firsts.append({"max_abs_err_5e": err, "scale": scale, "within_full_tol": err <= FULL_TOL * scale,
                           "max_abs_err_f32": s32, "max_abs_err_5e_f32": r32})
        per_rank = []
        for r, o in enumerate(outs):
            d = o["9j"]
            bad = [(k, c["collectives"], c["dip_launches"], c["replicated"]) for k, calls in d["steps"].items()
                   for c in calls if c["collectives"] != step or c["dip_launches"] != per_call or c["replicated"]]
            n_calls = sum(len(v) for v in d["steps"].values())
            rec_r = {"rank": r, "calls": {k: len(v) for k, v in d["steps"].items()},
                     "collectives_per_step": {k: v[0]["collectives"] for k, v in d["steps"].items()},
                     "dip_launches_per_step": per_call, "launches": d["launches"],
                     "median_wall_ms": {k: statistics.median(c["wall_ms"] for c in v) for k, v in d["steps"].items()},
                     "profiled_device_ms": d["profiled_device_ms"], "peak_gib": d["peak_gib"],
                     "peak_reserved_gib": d["peak_reserved_gib"], "wall_s": d["wall_s"],
                     "state_pool_bytes": d["state_pool_bytes"], "conv_pool_bytes": d["conv_pool_bytes"]}
            log(f"  rank {r}: {json.dumps(rec_r)} ({gpu})")
            if bad or d["launches"] != {"dip_matmul": per_call * n_calls, "dip_matmul_f32_x": 0} \
                    or set(d["steps"]) != {"chunk", "tail", "decode"}:
                raise AssertionError(f"phase 9j rank {r}: collectives, launches or replicated weights off the design: "
                                     f"{bad[:3]} {d['launches']} (want {step}, {per_call} a call)")
            per_rank.append(rec_r)
        log(f"  per call and rank: {sum(step.values())} collectives ({step}) and {per_call} DiP launches; 9f's tp "
            f"call 182 and 163")
        log("phase 9j: each launch shape of the served forward against its plain version")
        for r, o in enumerate(outs):
            for h in o["9j"]["held_launches"]:
                log(f"  rank {r} {h['launch']} ({h['kind']}) M={h['m']} K={h['k']} N={h['n']} {h['epilogue']}/"
                    f"{h['prologue']} -> {h['out_dtype']}: max|err| vs plain {h['max_abs_err']:.3e} (bound "
                    f"{h['bound']:.3e}), {h['ms']:.4f} ms, plain {h['plain_ms']:.4f} ms, library "
                    f"{h['library_ms']:.4f} ms ({gpu})")
            if not all(h["ok"] for h in o["9j"]["held_launches"]):
                raise AssertionError(f"phase 9j rank {r}: a launch shape off its plain version: "
                                     f"{[h for h in o['9j']['held_launches'] if not h['ok']]}")
        return {"ranks": per_rank, "first_logits": firsts, "tokens": o0["results"], "held": o0["held_launches"],
                "collectives_per_call": step, "launches_per_call": per_call, "phase_s": [o["9j"]["phase_s"] for o in outs]}

    def phase9z(rec):
        """Zamba2-2.7B over 2 ranks sharing the card (``phase9z_rank``): 9f
        under ``tp``, 9j under ``sp`` and 9g under ``fsdp``, held to 5e's
        records (``z_records``); 9h's and 9l's reduced models against
        single-rank engines on the card from the same seed."""
        from repro_torch.distributed import run_world

        prompts = [list(range(2, 9)), list(range(40, 57))]  # 7 tokens: all tail; 17: a chunk and a tail token
        single = {}
        with uncounted():
            for name, arch, overrides, strategy in Z_REDUCED + L_REDUCED:
                c1 = reduced_f32_config(arch, overrides)
                e1 = Engine(c1, tf_model.init_params(c1, make_generator(SEED, "cuda"), "cuda"),
                            engine_cfg=EngineConfig(slots=2, max_seq=64, prefill_chunk=16), device="cuda")
                for rid, p in enumerate(prompts):
                    e1.add_request(p, SamplingParams(max_new_tokens=8), rid=rid)
                single[name] = e1.run()
                del e1
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_world(phase9z_rank, 2, rec, prompts, timeout=1200.0)
        world_s = time.perf_counter() - t0
        n_layers, sites = 54, 9
        res = {"world_s": world_s}
        # per step and rank.  tp: the embedding's all-reduce; per Mamba2 layer
        # in_proj's all-gather, the gated norm's and out_proj's all-reduces;
        # per site wo's and w_down's all-reduces; the logits' all-gather.
        # fsdp: one all-gather per weight (in_proj, out_proj; wq, wk, wv, wo,
        # w_gate, w_up, w_down at each site; the lm_head), the embedding's
        # columns, and in a decode step (2 slots split 1 / 1) the logits' rows
        want = {"9f": {k: {"psum": 1 + 2 * n_layers + 2 * sites, "all_gather": n_layers + 1, "reduce_scatter": 0,
                           "ppermute": 0, "all_to_all": 0} for k in ("chunk", "tail", "decode")},
                "9g": {k: {"psum": 0, "all_gather": 2 * n_layers + 7 * sites + 1 + 1 + (k == "decode"),
                           "reduce_scatter": 0, "ppermute": 0, "all_to_all": 0}
                       for k in ("chunk", "tail", "decode")}}
        per_forward = 2 * n_layers + 6 * sites + 1
        for ph, strategy, firsts, max_new in (("9f", "tp", rec["tp_first"], 4), ("9g", "fsdp", rec["fsdp_first"], 2)):
            f32s = rec[strategy + "_f32"]
            o0 = outs[0][ph]
            log(f"phase {ph}: zamba2-2.7b under {strategy} at full width, 2 ranks sharing the card "
                f"({o0['eager_reason']}); 2 slots, max_seq 1024, chunk 256, prompts "
                f"{[len(p) for p in rec[strategy + '_prompts']]}, {max_new} greedy tokens each")
            if any(o[ph]["results"] != o0["results"] for o in outs):
                raise AssertionError(f"phase {ph}: the ranks served different tokens")
            if sorted(o0["results"]) != list(range(len(firsts))) or any(len(v) != max_new
                                                                      for v in o0["results"].values()):
                raise AssertionError(f"phase {ph}: not every request got its {max_new} tokens: {o0['results']}")
            # both engines run freely in bf16, in other orders of rounding, and
            # two such runs of this 54-layer stack drift apart by ~6% of the
            # largest logit (5e's gate 2: its kernels against its plain
            # versions), so, as 5e's gate 2 holds a free run, the sharded
            # engine's first-token logits must sit no further from the f32 run
            # of the same weights than F32_DRIFT times 5e's engine's; the
            # FULL_TOL comparison with 5e's engine is printed beside it
            firsts_cmp = []
            for rid, want_l in enumerate(firsts):
                got_l = o0["first_logits"][rid]
                err, scale = float(np.abs(got_l - want_l).max()), max(1.0, float(np.abs(want_l).max()))
                s32, r32 = float(np.abs(got_l - f32s[rid]).max()), float(np.abs(want_l - f32s[rid]).max())
                log(f"  request {rid}: first-token logits max|err| {err:.4e} against 5e's single-rank engine "
                    f"(max|5e| {scale:.3g}; {FULL_TOL} x max(1, max|5e|) = {FULL_TOL * scale:.4f}: "
                    f"{'within' if err <= FULL_TOL * scale else 'beyond'}); against the f32 run {s32:.4e}, 5e's "
                    f"{r32:.4e} (bound {F32_DRIFT} x 5e's); argmax {int(np.argmax(got_l))} | 5e "
                    f"{int(np.argmax(want_l))} | f32 {int(np.argmax(f32s[rid]))}; tokens {o0['results'][rid]}")
                if not s32 <= F32_DRIFT * r32:
                    raise AssertionError(f"phase {ph} request {rid}: the sharded engine's first-token logits drift "
                                         f"from the f32 run ({s32:.4e}) beyond {F32_DRIFT} x 5e's ({r32:.4e})")
                firsts_cmp.append({"max_abs_err_5e": err, "scale": scale, "within_full_tol": err <= FULL_TOL * scale,
                                   "max_abs_err_f32": s32, "max_abs_err_5e_f32": r32})
            per_rank = []
            for r, o in enumerate(outs):
                d = o[ph]
                bad = [(k, c["collectives"], c["dip_launches"]) for k, calls in d["steps"].items() for c in calls
                       if c["collectives"] != want[ph][k] or c["dip_launches"] != per_forward]
                n_calls = sum(len(v) for v in d["steps"].values())
                rec_r = {"rank": r, "calls": {k: len(v) for k, v in d["steps"].items()},
                         "collectives_per_step": {k: v[0]["collectives"] for k, v in d["steps"].items()},
                         "dip_launches_per_step": per_forward, "launches": d["launches"],
                         "median_wall_ms": {k: statistics.median(c["wall_ms"] for c in v)
                                            for k, v in d["steps"].items()},
                         "profiled_device_ms": d["profiled_device_ms"], "peak_gib": d["peak_gib"],
                         "peak_reserved_gib": d["peak_reserved_gib"], "weights_gib": d["weights_gib"],
                         "build_peak_gib": d["build_peak_gib"], "build_s": d["build_s"], "wall_s": d["wall_s"],
                         "storage_bytes": d["storage_bytes"], "state_pool_bytes": d["state_pool_bytes"],
                         "conv_pool_bytes": d["conv_pool_bytes"], "pools": d["pools"], "attn_pools": d["attn_pools"]}
                log(f"  rank {r}: {json.dumps(rec_r)} ({gpu})")
                want_l = {"dip_matmul": per_forward * n_calls, "dip_matmul_f32_x": 0}
                if bad or d["launches"] != want_l or set(d["steps"]) != {"chunk", "tail", "decode"}:
                    raise AssertionError(f"phase {ph} rank {r}: collectives or launches off the design: {bad[:3]} "
                                         f"{d['launches']} (want {want[ph]}, {per_forward} a forward)")
                per_rank.append(rec_r)
            heads = 80 // 2 if strategy == "tp" else 80
            state_want = n_layers * 2 * heads * 64 * 64 * 4
            if any(o[ph]["state_pool_bytes"] != state_want for o in outs):
                raise AssertionError(f"phase {ph}: a rank's state pool is not {heads} heads a slot")
            shards = outs[0][ph]["shards"]
            if strategy == "tp":
                log(f"  per step and rank: {sum(want[ph]['chunk'].values())} collectives ({want[ph]['chunk']}) and "
                    f"{per_forward} DiP launches; state pool {state_want} bytes a rank (40 of 80 heads), conv "
                    f"{outs[0][ph]['conv_pool_bytes']} bytes; in_proj {shards['layers/in_proj']}, out_proj "
                    f"{shards['layers/out_proj']}")
            else:
                gathered = 2 * outs[0][ph]["storage_bytes"] + (sites - 1) * 2 * sum(
                    w[0][0] * w[0][1] * 2 for nm, w in shards.items() if nm.startswith("shared_attn/"))
                log(f"  per step and rank: {want[ph]['chunk']['all_gather']} all-gathers in a prefill call, "
                    f"{want[ph]['decode']['all_gather']} in a decode step ({per_forward} DiP launches): one a weight "
                    f"(the shared block's 7 at each of its {sites} sites), the embedding's columns, the logits' rows "
                    f"in the split decode; the weights' storage assembled a step {gathered} bytes, half of it "
                    f"received from the other rank through host memory; the rank's storage "
                    f"{outs[0][ph]['storage_bytes']} bytes (K / 2 of every projection: in_proj "
                    f"{shards['layers/in_proj']}); peak memory a rank {[o[ph]['peak_gib'] for o in outs]} GiB")
                res[ph + "_gathered_bytes"] = gathered
            log(f"phase {ph}: each launch shape of the served forward against its plain version")
            for r, o in enumerate(outs):
                for h in o[ph]["held_launches"]:
                    log(f"  rank {r} {h['launch']} ({h['kind']}) M={h['m']} K={h['k']} N={h['n']} {h['epilogue']}/"
                        f"{h['prologue']} -> {h['out_dtype']}: max|err| vs plain {h['max_abs_err']:.3e} (bound "
                        f"{h['bound']:.3e}), {h['ms']:.4f} ms, plain {h['plain_ms']:.4f} ms, library "
                        f"{h['library_ms']:.4f} ms ({gpu})")
                if not all(h["ok"] for h in o[ph]["held_launches"]):
                    raise AssertionError(f"phase {ph} rank {r}: a launch shape off its plain version: "
                                         f"{[h for h in o[ph]['held_launches'] if not h['ok']]}")
            res[ph] = {"ranks": per_rank, "held": outs[0][ph]["held_launches"], "tokens": o0["results"],
                       "first_logits": firsts_cmp}

        res["9j"] = check_9j(outs, rec)
        log("phase 9h: the reduced models in f32 over the 2 ranks against single-rank engines on the card")
        for name, arch, overrides, strategy in Z_REDUCED:
            got = [o["9h"][name] for o in outs]
            log(f"  {name} ({arch}{overrides or ''} under {strategy}; in_proj {got[0]['in_proj']}): tokens "
                f"{got[0]['results']}; the single-rank engine's {single[name]}; DiP launches a rank "
                f"{[g['dip_launches'] for g in got]} (f32 x {[g['dip_f32_x_launches'] for g in got]})")
            if any(g["results"] != single[name] for g in got):
                raise AssertionError(f"phase 9h {name}: the sharded engine's tokens differ from the single rank's")
        log(f"phase 9l: the reduced models in f32 under sp and the moe family under fsdp over the 2 ranks against "
            f"single-rank engines on the card; the rank's wall {[round(o['9l_s'], 1) for o in outs]} s")
        for name, arch, overrides, strategy in L_REDUCED:
            got = [o["9l"][name] for o in outs]
            log(f"  {name} ({arch}{overrides or ''} under {strategy}; in_proj {got[0]['in_proj']}): tokens "
                f"{got[0]['results']}; the single-rank engine's {single[name]}; DiP launches a rank "
                f"{[g['dip_launches'] for g in got]} (f32 x {[g['dip_f32_x_launches'] for g in got]}); replicated "
                f"weights dispatched under sp {[g['replicated'] for g in got]}")
            if any(g["results"] != single[name] for g in got):
                raise AssertionError(f"phase 9l {name}: the sharded engine's tokens differ from the single rank's")
        res["9l"] = {name: {"tokens": single[name], "replicated": outs[0]["9l"][name]["replicated"]}
                     for name, *_ in L_REDUCED}
        res["launches"] = {
            "serve_sp_zamba2": {"dip_matmul": sum(o["9j"]["launches"]["dip_matmul"] for o in outs),
                                "dip_matmul_f32_x": sum(o["9j"]["launches"]["dip_matmul_f32_x"] for o in outs)},
            "serve_sp_fsdp_reduced": {"dip_matmul": sum(o["9l"][nm]["dip_launches"] for o in outs
                                                        for nm, *_ in L_REDUCED),
                                      "dip_matmul_f32_x": sum(o["9l"][nm]["dip_f32_x_launches"] for o in outs
                                                              for nm, *_ in L_REDUCED)},
            "serve_tp_zamba2": {"dip_matmul": sum(o["9f"]["launches"]["dip_matmul"] for o in outs),
                                "dip_matmul_f32_x": 0},
            "serve_fsdp_zamba2": {"dip_matmul": sum(o["9g"]["launches"]["dip_matmul"] for o in outs),
                                  "dip_matmul_f32_x": 0},
            "serve_ssm_fsdp_reduced": {"dip_matmul": sum(o["9h"][nm]["dip_launches"] for o in outs
                                                         for nm, *_ in Z_REDUCED),
                                       "dip_matmul_f32_x": sum(o["9h"][nm]["dip_f32_x_launches"] for o in outs
                                                               for nm, *_ in Z_REDUCED)}}
        log(f"  phases 9f-9h wall: the 2-rank world {world_s:.1f} s")
        return res

    # --------------------------------------- 8. reliability at full width ---
    # Run where the weights are: 8a and 8b on phase 5's llama3-8b weights
    # before they are freed, 8c after phase 6e (the weights phases 6 and 6d
    # draw from the seed).  The audits and the comparisons count no launch;
    # the serving and training drills are paths of their own.
    def verified_dispatch(params):
        """Phase 8a: ``api.matmul(..., verify=True)`` at llama3-8b's layer-0
        shapes, M = 4 and 256, bf16 x: ``wq`` on ``dip`` and ``systolic``
        (the probe), gate+up under ``swiglu`` on ``dip`` (the storage rung),
        ``wq`` quantized on ``dip_int8w`` and ``dip_fp8`` (the probe with the
        exact storage compare folded in).  Each clean call reports ok, and
        its output equals the unverified call bit for bit; a seeded flip in
        the storage (bit 14 of a bf16 element, bit 6 of an int8 or e4m3
        code, the checksum left as it was) is flagged.  The audit's and the
        dispatch's device ms (phase 7's timer) are printed side by side."""
        flush8 = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        lay = params["layers"]

        def stamped(w):
            return rel.attach_checksums(w.with_data(w.data[0]))

        wq = stamped(lay["wq"])
        pair = (stamped(lay["w_gate"]), stamped(lay["w_up"]))
        quant = {s: rel.attach_checksums(api.quant.quantize(wq, s)) for s in ("int8", "fp8_e4m3")}
        cases = (("wq", "dip", wq, "none", "probe"), ("wq", "systolic", wq, "none", "probe"),
                 ("gate+up", "dip", pair, "swiglu", "storage"),
                 ("wq", "dip_int8w", quant["int8"], "none", "probe"),
                 ("wq", "dip_fp8", quant["fp8_e4m3"], "none", "probe"))
        g = torch.Generator(device="cuda").manual_seed(SEED)
        rows = []
        with uncounted():
            for m in (4, 256):
                x = torch.randn(m, 4096, generator=g, device=dev).to(torch.bfloat16)
                for what, backend, w, epi, mode in cases:
                    plain = api.matmul(x, w, backend=backend, epilogue=epi)
                    out, rep = api.matmul(x, w, backend=backend, epilogue=epi, verify=True)
                    weights = w if isinstance(w, tuple) else (w,)
                    w0 = weights[0]
                    bad = rel.bitflip(w0.data, seed=SEED, bit=14 if w0.data.dtype == torch.bfloat16 else 6)
                    flipped = (w0.with_data(bad, w0.scale, checksum=w0.checksum)
                               if isinstance(w0, api.QuantizedDipWeight) else w0.with_data(bad, checksum=w0.checksum))
                    fw = (flipped,) + weights[1:] if isinstance(w, tuple) else flipped
                    frep = api.matmul(x, fw, backend=backend, epilogue=epi, verify=True)[1]
                    row = {"shape": f"M={m} {what}", "backend": backend, "mode": rep["mode"],
                           "bit_equal": torch.equal(out, plain), "ok": bool(rep["ok"]),
                           "max_excess": float(rep["max_excess"]), "flip_flagged": not bool(frep["ok"]),
                           "flip_rows_flagged": int(frep["rows_flagged"]),
                           "dispatch_ms": device_ms(lambda: api.matmul(x, w, backend=backend, epilogue=epi), flush8),
                           "audit_ms": device_ms(lambda: rel.verify_matmul(x, weights, out, epilogue=epi), flush8)}
                    log(f"  8a {json.dumps(row)} ({gpu})")
                    rows.append(row)
                    if not (row["bit_equal"] and row["ok"] and row["mode"] == mode and row["flip_flagged"]):
                        raise AssertionError(f"phase 8a: {what} on {backend} at M={m}: {row}")
                    del plain, out, rep, frep, bad, flipped, fw
        del flush8, wq, pair, quant
        return rows

    def drill_counts():
        """Each kernel's launches since the counts were set to 0, and the
        int8 route's quantizing passes."""
        return dict(read_counts(), quantize_pass=dip_matmul_q.launches_quant)

    def drill_engine(ecfg_kw, c, p):
        return Engine(c, p, engine_cfg=EngineConfig(**dict(dict(slots=4, max_seq=1024, prefill_chunk=256,
                                                                  verify=True), **ecfg_kw)), device="cuda")

    def kv_fault_drill(what, c, p, prompts, max_retries, degraded_held=None):
        """Two requests of 8 greedy tokens; once both decode (and two more
        ticks), the victim's first KV block is poisoned with NaN in place
        (``corrupt_kv_block``: ``k``, or ``k_scale`` under the int8 pool)
        and the engine runs to the end.  ``degraded_held``: a dict that
        keeps the degraded step's last call for ``graph_check``."""
        eng = drill_engine(dict(max_retries=max_retries), c, p)
        r0, r1 = [eng.add_request(q, SamplingParams(max_new_tokens=8)) for q in prompts]
        if degraded_held is not None:
            get = eng._get_decode_xla

            def recording():
                step = get()

                def run(*a):
                    keep_last(degraded_held, "_decode_xla", a)
                    return step(*a)
                return run
            eng._get_decode_xla = recording
        reset_counts()
        t0 = time.perf_counter()
        while sum(r is not None and r.state == "running" for r in eng._slots) < 2:
            eng.step()
        for _ in range(2):
            eng.step()
        victim = next(r for r in eng._slots if r is not None and r.rid == r0)
        pool = rel.corrupt_kv_block(eng.kv, eng.kv.owned[victim.slot][0], mode="nan")
        got = eng.run()
        torch.cuda.synchronize()
        out = {"pool": pool, "wall_s": time.perf_counter() - t0, "launches": drill_counts(),
               "stats": {k: eng.last_stats[k] for k in ("faults_detected", "retries", "deadline_evictions",
                                                        "degraded_requests", "decode_steps", "prefill_chunks")},
               "victim": {k: eng.request_stats[r0][k] for k in ("retries", "degraded", "fault_failed",
                                                                "new_tokens")},
               "peer_tokens": got[r1], "victim_tokens": got[r0]}
        log(f"  8b {what}: {json.dumps({k: v for k, v in out.items() if 'tokens' not in k})} ({gpu})")
        if len(got[r0]) != 8 or len(got[r1]) != 8:
            raise AssertionError(f"phase 8b {what}: a request did not complete: {got}")
        return eng, out

    def reliability_serving(params, cfg, reqs, want, decode_step):
        """Phase 8b: the verified engine at phase 5's settings (4 slots,
        max_seq 1024, chunk 256) on its weights, greedy, 8 new tokens.
        (1) No fault: phase 5's 4 prompts and, behind the full slot pool, a
        request with ``ttl_s=0``: the 4 give phase 5's first 8 tokens, the
        fifth is swept, and the decode graph's counted launches are phase
        5's.  (2) A NaN in the victim's first K block mid-decode: one fault,
        one retry, the victim completes, the peer's tokens are the clean
        run's.  (3) ``max_retries=0``: the victim completes degraded through
        the captured ``torch``-backend decode step (built on that fault, in
        the engine's graph pool, launching none of the counted kernels),
        whose replay is held to its eager step and timed (``graph_check``).
        (4) The int8 weights + int8 KV pool (phase 5's weights quantized, as
        5b serves them): a clean run, then the drill of (2) with ``k_scale``
        poisoned."""
        out, path = {}, {}

        def add(launches):
            for k, n in launches.items():
                path[k] = path.get(k, 0) + n

        eng = drill_engine({}, cfg, params)
        rids = [eng.add_request(r.prompt, SamplingParams(max_new_tokens=8), rid=r.rid) for r in reqs]
        late = eng.add_request(reqs[0].prompt, SamplingParams(max_new_tokens=8), ttl_s=0.0)
        reset_counts()
        got = eng.run()
        add(drill_counts())
        key = ((4, 1), (4,), (4, eng.kv.blocks_per_seq))
        same_launches = eng._decode.captures[key]["launches"] == decode_step.captures[key]["launches"]
        # what verify adds to a decode tick: the host screen of the rows it copies anyway
        rows = np.random.default_rng(SEED).standard_normal((4, cfg.padded_vocab)).astype(np.float32)
        screen = []
        for _ in range(50):
            t = time.perf_counter()
            [bool(np.isfinite(rows[i]).all()) for i in range(4)]
            screen.append(time.perf_counter() - t)
        out["clean"] = {"tokens_equal_phase5": all(got[r] == want[r][:8] for r in rids), "swept": got[late] == [],
                        "screen_host_ms": 1e3 * statistics.median(screen),
                        "stats": {k: eng.last_stats[k] for k in ("faults_detected", "deadline_evictions",
                                                                 "decode_steps")},
                        "decode_graph_launches": eng._decode.captures[key]["launches"],
                        "decode_graph_launches_equal_phase5": same_launches}
        log(f"  8b clean, verify=True: {json.dumps(out['clean'])}")
        if not (out["clean"]["tokens_equal_phase5"] and out["clean"]["swept"] and same_launches
                and eng.last_stats["faults_detected"] == 0 and eng.last_stats["deadline_evictions"] == 1
                and eng._decode_xla is None):
            raise AssertionError(f"phase 8b: the clean verified run: {out['clean']}")
        del eng
        torch.cuda.empty_cache()

        pair = [reqs[0].prompt, reqs[1].prompt]
        eng, out["retry"] = kv_fault_drill("retry, bf16", cfg, params, pair, 1)
        add(out["retry"]["launches"])
        st = out["retry"]["stats"]
        if (out["retry"]["pool"], st["faults_detected"], st["retries"], eng._decode_xla) != ("k", 1, 1, None) or \
                out["retry"]["peer_tokens"] != want[reqs[1].rid][:8]:
            raise AssertionError(f"phase 8b: the retry drill: {out['retry']}")
        del eng
        torch.cuda.empty_cache()

        held8 = {}
        eng, out["degrade"] = kv_fault_drill("degrade, bf16", cfg, params, pair, 0, degraded_held=held8)
        add(out["degrade"]["launches"])
        st, v = out["degrade"]["stats"], out["degrade"]["victim"]
        xla = eng._decode_xla
        if not (st["degraded_requests"] == 1 and v["degraded"] and not v["fault_failed"]
                and isinstance(xla, graphs.CapturedStep) and xla.pool is eng._decode.pool
                and not xla.captures[key]["launches"]):
            raise AssertionError(f"phase 8b: the degrade drill: {out['degrade']}")
        out["degrade"]["peer_tokens_equal_clean"] = out["degrade"]["peer_tokens"] == want[reqs[1].rid][:8]
        out["degrade"]["graph"] = graph_check(
            "degraded decode step (torch backend)", xla,
            tf_model.paged_decode_step_fn(dataclasses.replace(eng.cfg, matmul_backend="torch")),
            held8["_decode_xla"], cfg.vocab_size, counted=False)
        del eng, xla, held8
        torch.cuda.empty_cache()

        qcfg = dataclasses.replace(cfg, quantization="int8", matmul_backend="dip_int8w", kv_quant="int8")
        qparams = tf_model.quantize_params(params, "int8")
        eng = drill_engine({}, qcfg, qparams)
        rq = [eng.add_request(q, SamplingParams(max_new_tokens=8)) for q in pair]
        reset_counts()
        clean_q = eng.run()
        add(drill_counts())
        del eng
        eng, out["retry_int8"] = kv_fault_drill("retry, int8 weights + int8 KV", qcfg, qparams, pair, 1)
        add(out["retry_int8"]["launches"])
        st = out["retry_int8"]["stats"]
        out["retry_int8"]["peer_tokens_equal_clean"] = out["retry_int8"]["peer_tokens"] == clean_q[rq[1]]
        if (out["retry_int8"]["pool"], st["faults_detected"], st["retries"]) != ("k_scale", 1, 1) or \
                not out["retry_int8"]["peer_tokens_equal_clean"]:
            raise AssertionError(f"phase 8b: the int8 drill: {out['retry_int8']}")
        del eng, qparams
        torch.cuda.empty_cache()
        for k in ("dip_matmul", "flash_attention", "dip_matmul_q", "quantize_pass"):
            if not path.get(k):
                raise AssertionError(f"phase 8b: the reliability serving path launched no {k}: {path}")
        out["launches"] = path
        return out

    def reliability_training(losses, grad_norms):
        """Phase 8c: llama3-8b at full width cut to 2 layers through a
        guarded ``Trainer`` with phase 6's launcher settings (the weights
        from the seed, 4 steps, no checkpoint): no fault, and its losses and
        gradient norms equal phase 6's unguarded run bit for bit; the
        fingerprint's device ms a pass (two a step).  Then mamba2-370m at
        full depth (phase 6d's configuration), guarded, ``ckpt_every=2``, a
        NaN planted in the first ``layers`` leaf through ``step_hook`` before
        step 4 (data step 3): one weight fault, at least one skipped step,
        one recovery from the step-2 checkpoint, and the run reaches its
        step count with finite parameters."""
        out, path = {}, {}
        ck = os.path.join(ckpt_root, "guarded")
        c = dataclasses.replace(arch, n_layers=2, matmul_backend="dip")
        tr = Trainer(c, TrainerConfig(steps=t_steps, ckpt_every=100, ckpt_dir=ck, log_every=1, guard=True),
                     optimizer=AdamW(lr=cosine_schedule(t_lr, 10, t_steps)), seq_len=t_seq, global_batch=t_batch,
                     device="cuda")
        reset_counts()
        run = tr.run(seed=SEED)
        path["llama3-8b"] = read_counts()
        ms = run["metrics"]
        flush8 = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        fp_ms = device_ms(lambda: rel.fingerprint(run["state"]["params"]), flush8, iters=5, warmup=1)
        out["llama3-8b"] = {"losses": [m["loss"] for m in ms], "grad_norms": [m["grad_norm"] for m in ms],
                            "step_s": [m["step_time_s"] for m in ms], "skipped": run["skipped"],
                            "weight_faults": run["weight_faults"], "fingerprint_ms": fp_ms,
                            "leaves": len(rel.fingerprint_paths(run["state"]["params"])),
                            "equal_phase6": [m["loss"] for m in ms] == losses
                            and [m["grad_norm"] for m in ms] == grad_norms}
        log(f"  8c llama3-8b, 2 layers, guarded: {json.dumps(out['llama3-8b'])}; phase 6 unguarded: losses "
            f"{losses}, gradient norms {grad_norms} ({gpu})")
        if not out["llama3-8b"]["equal_phase6"] or run["skipped"] or run["weight_faults"]:
            raise AssertionError(f"phase 8c: the guarded llama3-8b run differs from phase 6's: {out['llama3-8b']}")
        del tr, run, ms
        gc.collect()
        torch.cuda.empty_cache()

        hit = {}

        def hook(step_no, state):
            if step_no == 3:
                params, hit["path"] = rel.corrupt_pytree(state["params"], "layers", seed=SEED, mode="nan")
                state = dict(state, params=params)
            return state

        cm = dataclasses.replace(get_config("mamba2-370m"), matmul_backend="dip", n_layers=24)
        tr = Trainer(cm, TrainerConfig(steps=t_steps, ckpt_every=2, ckpt_dir=os.path.join(ck, "mamba2"), keep=5,
                                       log_every=1, guard=True, async_ckpt=False),
                     optimizer=AdamW(lr=cosine_schedule(t_lr, 10, t_steps)), seq_len=t_seq, global_batch=t_batch,
                     step_hook=hook, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        run = tr.run(seed=SEED)
        wall = time.perf_counter() - t0
        path["mamba2-370m"] = read_counts()
        finite = all(bool(torch.isfinite(t).all()) for t in tree.leaves(run["state"]["params"]))
        out["mamba2-370m"] = {"hit": hit.get("path"), "weight_faults": run["weight_faults"],
                              "skipped": run["skipped"], "recoveries": run["recoveries"],
                              "final_step": run["state"]["step"], "steps_run": len(run["metrics"]),
                              "losses": [m["loss"] for m in run["metrics"]], "params_finite": finite, "wall_s": wall}
        log(f"  8c mamba2-370m, guarded, NaN at data step 3: {json.dumps(out['mamba2-370m'])} ({gpu})")
        if not (run["weight_faults"] == 1 and run["skipped"] >= 1 and run["recoveries"] == 1
                and run["state"]["step"] == t_steps and finite):
            raise AssertionError(f"phase 8c: the mamba2-370m drill: {out['mamba2-370m']}")
        del tr, run, flush8
        shutil.rmtree(ck, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        for name, n in path.items():
            if not (n.get("dip_matmul") and n.get("lm_head_ce")):
                raise AssertionError(f"phase 8c: the guarded {name} run launched no dip_matmul or lm_head_ce: {n}")
        out["launches"] = path
        return out

    # ------------------------------------------- 5. full-width serving -----
    log("phase 5: llama3-8b full width, bf16, dip storage, through Server")
    cfg = dataclasses.replace(get_config("llama3-8b"), matmul_backend="dip",
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (32, 4096, 128256)
    t0 = time.perf_counter()
    params = tf_model.init_params(cfg, make_generator(SEED, "cuda"), "cuda")
    torch.cuda.synchronize()
    log(f"  parameters drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    server = Server(cfg, ServerConfig(batch_slots=4, max_seq=1024, max_new_tokens=16, temperature=0.0,
                                      prefill_chunk=256), params, device="cuda")
    eng = server.engine
    times = {"_prefill_fwd": [], "_decode": []}

    last_args, held = {}, {}

    def timed(attr):
        f = getattr(eng, attr)
        last_args[attr + "_fn"] = f

        def run(*a):
            keep_last(held, attr, a)  # checked against the eager step after the run
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = f(*a)
            torch.cuda.synchronize()
            times[attr].append(time.perf_counter() - t)
            if not bool(torch.isfinite(out[0][..., :cfg.vocab_size]).all()):
                raise AssertionError(f"full width: non-finite logits from {attr}")
            return out
        setattr(eng, attr, run)

    timed("_prefill_fwd")
    timed("_decode")
    first_logits = {}  # each request's first-token logits (phase 9c holds the sharded engine's to them)
    record_first_logits(eng, cfg.vocab_size, first_logits)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=int(rng.integers(200, 601))))
            for i in range(4)]
    st_reqs_phase5 = reqs
    torch.cuda.reset_peak_memory_stats()
    dip_matmul.launches = flash_attention.launches = ce.lm_head_ce.launches = 0
    flash_attention.launches_tc = flash_attention.launches_split = 0
    t0 = time.perf_counter()
    results = server.serve(reqs)
    wall = time.perf_counter() - t0
    launches = {"dip_matmul": dip_matmul.launches, "flash_attention": flash_attention.launches,
                "lm_head_ce": ce.lm_head_ce.launches}
    flash_tc = flash_attention.launches_tc
    routes_by_path = {"serve": flash_routes()}
    peak, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    st = server.last_stats
    n_prefill, n_decode = len(times["_prefill_fwd"]), len(times["_decode"])
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    generated = sum(len(v) for v in results.values())
    log(f"  results: { {k: v[:6] for k, v in results.items()} }")
    log(f"  prompts {[len(r.prompt) for r in reqs]}, {generated} tokens generated, "
        f"{n_prefill} prefill chunks, {n_decode} decode steps, wall {wall:.2f} s")
    if sorted(results) != [0, 1, 2, 3] or any(not v for v in results.values()):
        raise AssertionError("full width: not every request was served")
    if (n_prefill, n_decode) != (st["prefill_chunks"], st["decode_steps"]):
        raise AssertionError("full width: step counts disagree with the engine's stats")
    want = {"dip_matmul": 193 * (n_prefill + n_decode), "flash_attention": 32 * n_prefill, "lm_head_ce": 0}
    log(f"  launches {launches}; expected {want} (193 DiP launches per forward, 32 flash launches per prefill "
        f"chunk; replays counted)")
    if launches != want:
        raise AssertionError("full width: launch counts differ from 193/forward and 32/prefill chunk")
    log(f"  flash launches on the tensor-core routes {flash_tc} of {launches['flash_attention']}, by route "
        f"{routes_by_path['serve']}")
    if flash_tc != want["flash_attention"]:
        raise AssertionError("full width: a prefill flash launch left the tensor-core routes")
    prefill_s, decode_s = sum(times["_prefill_fwd"]), sum(times["_decode"])
    serving = {
        "prefill_tok_per_s": prompt_tokens / prefill_s,
        "decode_tok_per_s": (generated - len(reqs)) / decode_s,
        "median_prefill_chunk_ms": 1e3 * statistics.median(times["_prefill_fwd"]),
        "median_decode_step_ms": 1e3 * statistics.median(times["_decode"]),
        "peak_memory_gib": peak / 2**30,
        "peak_reserved_gib": peak_reserved / 2**30,
        "graph_pool_gib": graph_pool_gib(last_args["_prefill_fwd_fn"], last_args["_decode_fn"]),
        "wall_s": wall,
        "prefill_chunks": n_prefill,
        "decode_steps": n_decode,
    }
    log("  serving " + json.dumps(serving))

    # the bf16 steps on their last inputs, replayed and eager
    ecfg = eng.cfg
    serving["graphs"] = {
        "decode": graph_check("decode step", last_args["_decode_fn"], tf_model.paged_decode_step_fn(ecfg),
                              held["_decode"], cfg.vocab_size),
        "prefill": graph_check("prefill chunk", last_args["_prefill_fwd_fn"],
                               tf_model.decode_step_fn(ecfg, attn_backend="flash"), held["_prefill_fwd"],
                               cfg.vocab_size)}
    log("  graphs " + json.dumps(serving["graphs"]))
    log("phase 8a: verified dispatch at llama3-8b's shapes (phase 5's weights, layer 0)")
    reliability_out = {"dispatch": verified_dispatch(params)}
    log("phase 8b: the verified engine at full width, phase 5's settings and weights: the retry -> degrade ladder, "
        "a request TTL, int8 weights + int8 KV")
    reliability_out["serving"] = reliability_serving(params, cfg, reqs, results, last_args["_decode_fn"])
    del server, eng, params, last_args, held
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 9 (after phase 5, against its logits and tokens): the sharded backends and llama3-8b "
        "tensor-parallel over a 2-rank world sharing the card")
    sharded_out = phase9(reqs, results, first_logits, serving)
    serve_launches = launches
    serve_launches.update(dip_matmul_q=0, dip_systolic=0)

    # ------------------------------- 5b. full-width quantized serving -------
    qserve = {}
    for scheme, kvq in (("int8", "int8"), ("fp8_e4m3", None)):
        log(f"phase 5b: llama3-8b full width, bf16 compute, --quantize {scheme}"
            + (f" --kv-quant {kvq}" if kvq else "") + ", through launch.serve")
        argv = ["--arch", "llama3-8b", "--full", "--dtype", "bfloat16", "--requests", "4", "--max-new", "16",
                "--slots", "4", "--max-seq", "1024", "--prefill-chunk", "256", "--seed", str(SEED),
                "--prompt-len", "200", "601", "--temperature", "0", "--quantize", scheme]
        argv += ["--kv-quant", kvq] if kvq else []
        st = {"times": {"_prefill_fwd": [], "_decode": []}, "checked": {}, "held": {}}

        def hook(server, reqs, st=st):
            """Time both engine steps; on the first call of each, keep the
            kernels' logits and run the same step on a copy of its inputs
            through the plain versions on the card."""
            eng = server.engine
            torch.cuda.synchronize()
            st.update(server=server, reqs=reqs, allocated_at_start_gib=torch.cuda.memory_allocated() / 2**30)
            plain = {"_prefill_fwd": tf_model.decode_step_fn(eng.cfg, attn_backend="dense"),
                     "_decode": tf_model.paged_decode_step_fn(eng.cfg)}
            flash_kept = tf_model.decode_step_fn(eng.cfg, attn_backend="flash")
            eager_steps = {"_prefill_fwd": flash_kept, "_decode": plain["_decode"]}
            st["orig"] = {attr: getattr(eng, attr) for attr in ("_prefill_fwd", "_decode")}
            for attr in ("_prefill_fwd", "_decode"):
                def run(*a, _f=getattr(eng, attr), _attr=attr):
                    keep_last(st["held"], _attr, a)  # checked against the eager step after the run
                    first = _attr not in st["checked"]
                    inputs = clone_tree(a[1]) if first else None
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = _f(*a)
                    torch.cuda.synchronize()
                    st["times"][_attr].append(time.perf_counter() - t)
                    if not bool(torch.isfinite(out[0][..., :cfg.vocab_size]).all()):
                        raise AssertionError(f"quantized full width: non-finite logits from {_attr}")
                    if first:
                        # the uncaptured step (the same kernels) on a copy of
                        # the inputs: its logits must be the captured step's
                        # first call's (an eager run on the capture stream) bit
                        # for bit
                        rows = live_rows(a)
                        with uncounted(), torch.no_grad():
                            eager = eager_steps[_attr](a[0], clone_tree(inputs), *dev_args(a))[0]
                        diff = (eager[rows].float() - out[0][rows].float()).abs().max().item()
                        log(f"  {_attr} first call (eager on the capture stream, then captured) against the "
                            f"uncaptured step, max|diff| {diff:.3e}")
                        if not torch.equal(eager[rows], out[0][rows]):
                            raise AssertionError(f"quantized full width ({scheme}): the captured {_attr} differs from "
                                                 f"the eager step")
                        del eager
                        if _attr == "_prefill_fwd":
                            # the quantized kernels alone: plain matmuls with the
                            # flash kernel kept on both sides (its launches here
                            # are a comparison's, so they are not counted)
                            again = clone_tree(inputs)
                            with uncounted(), plain_backends(), torch.no_grad():
                                ref_l = flash_kept(a[0], again, *dev_args(a))[0][..., :cfg.vocab_size].float()
                            st["flash_kept"] = (out[0][..., :cfg.vocab_size].float() - ref_l).abs().max().item()
                            del again, ref_l
                        cap = {"vocab": cfg.padded_vocab}
                        with plain_backends(cap), torch.no_grad():
                            want = plain[_attr](a[0], inputs, *dev_args(a))[0]
                        # a copy: the logits are the captured step's static buffer, which the
                        # next replay overwrites
                        st["checked"][_attr] = (out[0][..., :cfg.vocab_size].float().clone(),
                                                want[..., :cfg.vocab_size].float(), cap.get("head_x"))
                        del inputs, want
                    return out
                setattr(eng, attr, run)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        results = serve_cli.main(argv, on_server=hook)
        wall = time.perf_counter() - t0
        launches = read_counts()
        q_tc, q_quant = dip_matmul_q.launches_tc, dip_matmul_q.launches_quant
        routes_by_path["serve_int8" if scheme == "int8" else "serve_fp8"] = routes = flash_routes()
        peak, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        server, reqs, times = st["server"], st["reqs"], st["times"]
        n_prefill, n_decode = len(times["_prefill_fwd"]), len(times["_decode"])
        if [len(r.prompt) for r in reqs] != [len(r.prompt) for r in st_reqs_phase5]:
            raise AssertionError("quantized full width: the launcher's requests differ from phase 5's")
        if sorted(results) != [0, 1, 2, 3] or any(not v for v in results.values()):
            raise AssertionError("quantized full width: not every request was served")
        want = {"dip_matmul": 0, "dip_matmul_q": 193 * (n_prefill + n_decode), "dip_systolic": 0,
                "flash_attention": 32 * n_prefill, "lm_head_ce": 0}
        log(f"  launches {launches}; expected {want} (193 quantized launches per forward, no DiP launch; replays "
            f"counted); "
            f"{q_tc} of the dip_matmul_q launches on the tensor-core route; {q_quant} quantizing passes")
        if launches != want:
            raise AssertionError(f"quantized full width ({scheme}): launch counts differ from the expected ones")
        if q_tc != launches["dip_matmul_q"]:
            raise AssertionError(f"quantized full width ({scheme}): a projection left the tensor-core route")
        if q_quant != (launches["dip_matmul_q"] if scheme == "int8" else 0):
            raise AssertionError(f"quantized full width ({scheme}): not one quantizing pass per int8 projection")
        log(f"  flash launches by route {routes}")
        if routes["cuda_cores"]:
            raise AssertionError(f"quantized full width ({scheme}): a bf16 flash launch left the tensor-core routes")
        head = server.params["lm_head"]
        if not (isinstance(head, api.QuantizedDipWeight) and head.scheme == scheme):
            raise AssertionError("quantized full width: the lm_head is not quantized")
        for attr, (got, want_l, head_x) in st["checked"].items():
            err = (got - want_l).abs()
            scale = max(1.0, want_l.abs().max().item())
            lim = FULL_TOL * scale
            if scheme == "int8":
                lim = lim + head_step(head, head_x, cfg.vocab_size).reshape(got.shape)
            within = float((err <= TOL["bfloat16"] * scale).float().mean())
            log(f"  {attr} first call, kernels against plain on the card: logits max|err| {err.max().item():.3e} "
                f"(max|plain| {scale:.3g}); {100 * within:.4f}% within {TOL['bfloat16']:g} x scale; "
                f"bound {FULL_TOL:g} x scale" + (" + one code step of every lm_head input" if scheme == "int8" else ""))
            if not bool((err <= lim).all()):
                raise AssertionError(f"quantized full width ({scheme}): {attr} logits outside the stated bound")
        if set(st["checked"]) != {"_prefill_fwd", "_decode"}:
            raise AssertionError("quantized full width: a step was never checked against plain")
        log(f"  _prefill_fwd first call with the flash kernel on both sides (the quantized kernels against "
            f"their plain versions alone): logits max|err| {st['flash_kept']:.3e}")
        generated = sum(len(v) for v in results.values())
        qserve[scheme] = {
            "launches": launches,
            "dip_matmul_q_tensor_core_launches": q_tc,
            "dip_matmul_q_quantizing_passes": q_quant,
            "median_prefill_chunk_ms": 1e3 * statistics.median(times["_prefill_fwd"]),
            "median_decode_step_ms": 1e3 * statistics.median(times["_decode"]),
            "prefill_tok_per_s": sum(len(r.prompt) for r in reqs) / sum(times["_prefill_fwd"]),
            "decode_tok_per_s": (generated - len(reqs)) / sum(times["_decode"]),
            "peak_memory_gib": peak / 2**30,
            "peak_reserved_gib": peak_reserved / 2**30,
            "graph_pool_gib": graph_pool_gib(st["orig"]["_prefill_fwd"], st["orig"]["_decode"]),
            "allocated_at_start_gib": st["allocated_at_start_gib"],
            "kv_bytes_per_block": kvc.bytes_per_block(server.engine.cfg),
            "kv_quant": server.engine.kv_quant,
            "prefill_max_err_vs_plain_flash_kept": st["flash_kept"],
            "wall_s": wall, "prefill_chunks": n_prefill, "decode_steps": n_decode,
        }
        log(f"  results: { {k: v[:6] for k, v in results.items()} }")
        log("  serving " + json.dumps(dict(qserve[scheme], scheme=scheme)))
        # the last decode step and prefill chunk replayed against the eager
        # step; the replay's kernels by name below
        ecfg = server.engine.cfg
        qserve[scheme]["graphs"] = {
            "decode": graph_check(f"{scheme} decode step", st["orig"]["_decode"], tf_model.paged_decode_step_fn(ecfg),
                                  st["held"]["_decode"], cfg.vocab_size),
            "prefill": graph_check(f"{scheme} prefill chunk", st["orig"]["_prefill_fwd"],
                                   tf_model.decode_step_fn(ecfg, attn_backend="flash"), st["held"]["_prefill_fwd"],
                                   cfg.vocab_size)}
        log("  graphs " + json.dumps(qserve[scheme]["graphs"]))
        by_kernel = replay_kernels[f"{scheme} decode step"]
        step_ms, step_launches = sum(v[1] for v in by_kernel.values()), sum(v[0] for v in by_kernel.values())
        # the decode step's dip_matmul_q kernels by name: per projection one
        # product (and for int8 one quantizing pass), plus a split-K reduce
        # wherever the plan at the step's M splits K; counted in the captured
        # graph's kernel nodes (what every replay launches), since the
        # profiler's trace of a replay may lack a record (``trace_checks``)
        m_dec = st["held"]["_decode"][0][2].numel()
        per_layer = [(d, d, False), (d, kv, False), (d, kv, False), (d, d, False), (d, d_ff, True), (d_ff, d, False)]
        projections = per_layer * cfg.n_layers + [(d, vocab, False)]
        split = sum(matmul_plan(m_dec, n, k, dual, sms, weight_bytes=1).splits > 1 for k, n, dual in projections)
        names = ({"product": ("dip_mma_s8_kernel", "dip_wgmma_s8_kernel"), "quantize": ("quantize_int8_kernel",),
                  "reduce": ("splitk_reduce_s8_kernel",)} if scheme == "int8" else
                 {"product": ("dip_mma_kernel", "dip_wgmma_kernel"), "quantize": ("quantize_int8_kernel",),
                  "reduce": ("splitk_reduce_kernel",)})
        nodes = graph_nodes[f"{scheme} decode step"]
        split_by = {role: sum(nodes.get(nm, 0) for nm in nms) for role, nms in names.items()}
        q_ms = sum(ms for key, (_, ms) in by_kernel.items()
                   if any(nm + "<" in key for nms in names.values() for nm in nms))
        want_split = {"product": len(projections), "quantize": len(projections) if scheme == "int8" else 0,
                      "reduce": split}
        log(f"  decode step replayed, M={m_dec}: dip_matmul_q kernel nodes of its graph {split_by} (expected "
            f"{want_split}), {q_ms:.3f} ms of device time")
        if split_by != want_split:
            raise AssertionError(f"quantized full width ({scheme}): the decode step's launch split differs")
        qserve[scheme].update(decode_step_device_ms=step_ms, decode_step_launches=step_launches,
                              decode_step_dip_matmul_q_ms=q_ms, decode_step_dip_matmul_q_kernels=split_by)
        st.clear()
        del server, reqs, st, results, head, hook, by_kernel
        gc.collect()
        torch.cuda.empty_cache()

    # ----------------------------- 5c. full-width wavefront serving ---------
    log("phase 5c: llama3-8b full width, bf16, pallas_systolic (the wavefront kernel): one request of "
        "256 prompt tokens, 4 new tokens, against the dip backend on the same weights")
    cfg_sys = dataclasses.replace(get_config("llama3-8b"), matmul_backend="pallas_systolic",
                                  param_dtype="bfloat16", compute_dtype="bfloat16")
    params = tf_model.init_params(cfg_sys, make_generator(SEED, "cuda"), "cuda")
    prompt = np.random.default_rng(SEED).integers(2, cfg_sys.vocab_size, size=256)
    sys_runs, profiles = {}, {}
    for backend in ("pallas_systolic", "dip"):
        c = dataclasses.replace(cfg_sys, matmul_backend=backend)
        server = Server(c, ServerConfig(batch_slots=1, max_seq=512, max_new_tokens=4, temperature=0.0,
                                        prefill_chunk=256), params, device="cuda")
        eng, seen, steps, last, held = server.engine, [], {"_prefill_fwd": [], "_decode": []}, {}, {}
        for attr in ("_prefill_fwd", "_decode"):
            last[attr + "_fn"] = getattr(eng, attr)

            def run(*a, _f=getattr(eng, attr), _attr=attr, _seen=seen, _steps=steps, _held=held):
                keep_last(_held, _attr, a)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _f(*a)
                torch.cuda.synchronize()
                _steps[_attr].append(time.perf_counter() - t)
                _seen.append((_attr, out[0][..., :c.vocab_size].float().clone()))  # the next replay overwrites out
                return out
            setattr(eng, attr, run)
        reset_counts()
        out = server.serve([Request(rid=0, prompt=prompt)])
        sys_runs[backend] = (out, seen, steps, read_counts(), flash_routes())
        # the two steps on their last inputs, replayed and eager: device time
        # against wall time
        steps_fn = {"_decode": tf_model.paged_decode_step_fn(eng.cfg),
                    "_prefill_fwd": tf_model.decode_step_fn(eng.cfg, attn_backend="flash")}
        profiles[backend] = {what: graph_check(f"{backend} {what}", last[attr + "_fn"], steps_fn[attr], held[attr],
                                               c.vocab_size)
                             for attr, what in (("_decode", "decode step"), ("_prefill_fwd", "prefill chunk"))}
        del server, eng, last, held, run  # run's defaults hold the captured step, its weights and graphs
        gc.collect()
    (out_s, seen_s, steps_s, launches_s, routes_s), (out_d, seen_d, steps_d, launches_d, routes_d) = (
        sys_runs["pallas_systolic"], sys_runs["dip"])
    routes_by_path["serve_systolic"] = routes_s  # the dip run beside it is a comparison's
    n_fwd = len(seen_s)
    want_s = {"dip_matmul": 0, "dip_matmul_q": 0, "dip_systolic": 193 * n_fwd,
              "flash_attention": 32 * len(steps_s["_prefill_fwd"]), "lm_head_ce": 0}
    log(f"  launches {launches_s}; expected {want_s}; tokens systolic {out_s[0]} / dip {out_d[0]}")
    if launches_s != want_s or launches_d["dip_matmul"] != 193 * len(seen_d) or launches_d["dip_systolic"]:
        raise AssertionError("full-width wavefront serving: launch counts differ from the expected ones")
    if routes_s["cuda_cores"] or routes_d["cuda_cores"]:
        raise AssertionError("full-width wavefront serving: a bf16 flash launch left the tensor-core routes")
    if [t for t, _ in seen_s] != [t for t, _ in seen_d][:n_fwd] or n_fwd < 2:
        raise AssertionError("full-width wavefront serving: the two backends took different steps")
    # step i's logits pick token i; after a token that differs (a near tie in
    # bf16) the two runs feed different tokens, so the comparison stops there
    same = next((i for i, (a, b) in enumerate(zip(out_s[0], out_d[0])) if a != b), len(out_s[0]))
    # bound: FULL_TOL, as for the quantized paths (32 layers of bf16
    # activations whose roundings differ where the two kernels' f32 sums,
    # taken in another order, straddle a midpoint); each kernel alone is
    # held to TOL at these shapes in phase 2
    sys_err = 0.0
    for i, ((tag, a), (_, b)) in enumerate(zip(seen_s[:same + 1], seen_d)):
        scale = max(1.0, b.abs().max().item())
        within = float(((a - b).abs() <= TOL["bfloat16"] * scale).float().mean())
        log(f"  {tag} call {i}: {100 * within:.4f}% of logits within {TOL['bfloat16']:g} x scale")
        sys_err = max(sys_err, close(f"systolic vs dip {tag} call {i} logits (bf16)", a, b, FULL_TOL))
    sys_serving = {"prefill_chunk_ms": 1e3 * statistics.median(steps_s["_prefill_fwd"]),
                   "decode_step_ms": 1e3 * statistics.median(steps_s["_decode"]),
                   "dip_prefill_chunk_ms": 1e3 * statistics.median(steps_d["_prefill_fwd"]),
                   "dip_decode_step_ms": 1e3 * statistics.median(steps_d["_decode"]),
                   "profiles": profiles}
    log("  serving " + json.dumps(sys_serving))
    del params, sys_runs, seen_s, seen_d
    torch.cuda.empty_cache()

    # ----------------- helpers of the full-width families (5d - 5h) -------
    def weight_stats(params):
        """(parameters, GiB) of a parameter tree; a quantized weight counts
        its codes and its scales."""
        n = nbytes = 0
        for leaf in tree.leaves(params):
            ts = (leaf.data, leaf.scale) if isinstance(leaf, api.QuantizedDipWeight) else (leaf,)
            n += ts[0].numel()
            nbytes += sum(t.numel() * t.element_size() for t in ts)
        return n, nbytes / 2**30

    def check_first_import(eng, record):
        """Wrap the engine's prefill import: after its first call, the int8
        rows it wrote into the slot's pool blocks (MLA's latent rows, one
        scale per token; the hybrid's shared-attention k and v, one scale
        per (token, head)) must be byte-identical to ``quantize_rows`` of
        the same prefill-cache rows run on the CPU."""
        imp, bs = eng._import, eng.block_size

        def wrapped(pools, prefill, slot, plen, block_row):
            out = imp(pools, prefill, slot, plen, block_row)
            if not record:
                got, rows = (out["attn"], prefill["attn"]) if "attn" in out else (out, prefill)
                pos = np.arange(plen)
                blk = torch.as_tensor(block_row[pos // bs].astype(np.int64), device=dev)
                off = torch.as_tensor(pos % bs, device=dev)
                for nm in rows:
                    codes, scale = api.quant.quantize_rows(rows[nm][:, 0, :plen].cpu(), "int8")
                    same = (torch.equal(got[nm][:, blk, off].cpu(), codes)
                            and torch.equal(got[f"{nm}_scale"][:, blk, off].cpu(), scale[..., 0]))
                    record[nm] = {"rows": int(codes[..., 0].numel()), "byte_identical": same}
                    log(f"  first prefill import, {nm}: {codes[..., 0].numel()} int8 rows written on the card, "
                        f"codes and scales byte-identical to quantize_rows on the CPU: {same}")
                    if not same:
                        raise AssertionError(f"the int8 {nm} pool rows differ from quantize_rows on the CPU")
            return out

        eng._import = wrapped

    def block_tol(scheme):
        """Gate 1's bound on one block, kernels against plain on one input:
        TOL in bf16.  Under int8 a block's bf16 roundings (an epilogue's,
        flash's against the dense attention) feed the next projection's
        quantizer, where an activation one bf16 step from a rounding
        midpoint takes the next code, so the block is held to FULL_TOL, the
        bound that carries such steps over a model."""
        return TOL["bfloat16"] if scheme is None else FULL_TOL

    def check_quantized_launches(what, scheme, launches, per_forward, n_fwd, want_other):
        """A quantized path's launches: ``per_forward`` dip_matmul_q launches
        per forward, all on the tensor-core route, for int8 one quantizing
        pass each; no bf16 DiP launch; the rest as ``want_other``."""
        want = dict(want_other, dip_matmul=0, dip_matmul_q=per_forward * n_fwd)
        q_tc, q_quant = dip_matmul_q.launches_tc, dip_matmul_q.launches_quant
        passes = launches["dip_matmul_q"] if scheme == "int8" else 0
        log(f"  {what}: {launches['dip_matmul_q'] / n_fwd:g} dip_matmul_q launches per forward ({per_forward} DiP "
            f"projections in the template), {q_tc} on the tensor-core route, {q_quant} quantizing passes, "
            f"{launches['dip_matmul']} bf16 DiP launches")
        if launches != want or q_tc != launches["dip_matmul_q"] or q_quant != passes:
            raise AssertionError(f"{what}: launches {launches}, {q_tc} on the tensor cores, {q_quant} quantizing "
                                 f"passes; expected {want}, all on the tensor cores with one pass each")
        return q_tc, q_quant

    # --------------- 5d / 5g. DeepSeek-V2-Lite-16B at full width -----------
    def whole_prompt_forward(params, c, reqs):
        """The whole-prompt forward with no cache (the naive MLA form: q and
        k of nope + rope = 192 columns, v of 128, per head), through the
        engine's step function ``decode_step_fn(c, attn_backend="flash")``
        on the 541-token request: 163 DiP launches and 27 flash launches,
        every one on the tensor-core route (D = 192, Dv = 128, Sq = 541);
        its logits against ``attn_backend="dense"`` replaying its expert
        choices (the two differ only in the attention core), within
        FULL_TOL; then both profiled for device time."""
        prompt = next(r.prompt for r in reqs if len(r.prompt) == 541)
        toks = torch.as_tensor(prompt, device=dev)[None]
        flash_step = tf_model.decode_step_fn(c, attn_backend="flash")
        dense_step = tf_model.decode_step_fn(c, attn_backend="dense")
        stats = {}
        reset_counts()
        with torch.no_grad():
            got, cache = flash_step(params, None, toks, moe_trace=stats)
        torch.cuda.synchronize()
        launches, routes = read_counts(), flash_routes()
        want_l = {"dip_matmul": 163, "dip_matmul_q": 0, "dip_systolic": 0, "flash_attention": c.n_layers,
                  "lm_head_ce": 0}
        log(f"  whole-prompt forward, no cache (541 tokens, flash): launches {launches}, flash by route {routes}")
        if cache is not None or launches != want_l or routes != {"tensor_cores": c.n_layers, "split_kv": 0,
                                                                  "cuda_cores": 0}:
            raise AssertionError(f"deepseek whole-prompt forward: launches {launches}, routes {routes}; expected "
                                 f"163 DiP and {c.n_layers} flash launches, all on tensor_cores, and no cache")
        replay = {"replay_ids": stats["ids"]}
        with uncounted(), torch.no_grad():
            want, _ = dense_step(params, None, toks, moe_trace=replay)
        got_v, want_v = got[..., :c.vocab_size].float(), want[..., :c.vocab_size].float()
        if not bool(torch.isfinite(got_v).all()):
            raise AssertionError("deepseek whole-prompt forward: non-finite logits")
        err, scale = (got_v - want_v).abs().max().item(), max(1.0, want_v.abs().max().item())
        with uncounted():
            prof_f = profile_call(lambda: flash_step(params, None, toks, moe_trace={"replay_ids": stats["ids"]}),
                                  lambda: None, "whole-prompt forward, flash", top=6)
            prof_d = profile_call(lambda: dense_step(params, None, toks, moe_trace={"replay_ids": stats["ids"]}),
                                  lambda: None, "whole-prompt forward, dense attention", top=6)
        log(f"  whole-prompt forward: logits against the dense attention core (expert choices replayed) max|err| "
            f"{err:.3e} (max|dense| {scale:.3g}, bound {FULL_TOL:g} x scale); device ms flash "
            f"{prof_f['device_ms']:.3f} (of it flash kernels {prof_f['flash_ms']:.3f}) against dense "
            f"{prof_d['device_ms']:.3f} ({gpu})")
        if err > FULL_TOL * scale:
            raise AssertionError("deepseek whole-prompt forward: logits outside the stated bound of the dense run")
        del got, want, got_v, want_v, stats, replay
        return {"tokens": int(toks.shape[1]), "launches": launches, "flash_routes": routes, "max_err": err,
                "max_dense": scale, "device_ms_flash": prof_f["device_ms"], "flash_kernel_ms": prof_f["flash_ms"],
                "device_ms_dense": prof_d["device_ms"], "wall_ms_flash": prof_f["wall_ms"],
                "wall_ms_dense": prof_d["wall_ms"]}

    def ep_records(server, reqs, results, first):
        """What phase 9e is held to, from 5d's whole weights: the logits of
        a (2, 256) forward (the first 256 tokens of 5d's first two prompts;
        dense attention, as a plan's forward takes it) with its expert ids
        and dropped pairs by layer; layer 0's ``moe_ffn`` through the plain
        versions on each half of a seeded (1, 256) bf16 input, at
        moe_capacity(128) (the reference's ``ep`` semantics for a sequence
        split); layer 0's banks' checksums by expert; 5d's prompts, tokens
        and first-token logits.  No launch here counts on 5d's path."""
        c, params = server.engine.cfg, server.params
        toks = torch.as_tensor(np.stack([r.prompt[:EP_CHUNK] for r in reqs[:2]]), device=dev)
        trace = {}
        with uncounted(), torch.no_grad():
            logits = tf_model.forward(params, c, tokens=toks, moe_trace=trace)[0][..., :c.vocab_size].float()
        lp0 = tf_model._layers(params["layers"], c.n_layers)[0]
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        x = torch.randn((1, EP_CHUNK, c.d_model), generator=gen, device=dev).to(torch.bfloat16)
        with uncounted(), plain_backends(), torch.no_grad():
            halves = [moe.moe_ffn(h.contiguous(), lp0, c, return_routing=True) for h in x.chunk(2, 1)]
        rec = {"prompts": [r.prompt.tolist() for r in reqs], "results": {k: list(v) for k, v in results.items()},
               "first_logits": dict(first), "tokens": toks.cpu().numpy(), "logits": logits.cpu().numpy(),
               "ids": [i.cpu().numpy() for i in trace["ids"]], "dropped": [int(v) for v in trace["dropped"]],
               "chunk_x": x.float().cpu().numpy(),
               "halves_out": torch.cat([h[0] for h in halves], 1).float().cpu().numpy(),
               "halves_dropped": sum(int(h[2]) for h in halves), "halves_ids": [h[3].cpu().numpy() for h in halves],
               "bank_sums": {nm: bank_sums(params["layers"][nm][0]) for nm in ("w_gate", "w_up", "w_down")}}
        log(f"  recorded for phase 9e: a (2, {EP_CHUNK}) forward's logits (max|logit| "
            f"{float(logits.abs().max()):.3g}, {sum(rec['dropped'])} pairs dropped over {c.n_layers} layers); layer "
            f"0 on each half of a (1, {EP_CHUNK}) input at capacity {moe.moe_capacity(EP_CHUNK // 2, c)}, "
            f"{rec['halves_dropped']} pairs dropped; layer 0's bank checksums")
        del logits, x, halves, trace
        return rec

    ds_for_9e = {}  # 5d's records, for phase 9e

    def serve_deepseek(phase, extra_argv=(), scheme=None):
        """Serve deepseek-v2-lite-16b through ``launch.serve --full`` (4
        slots, max_seq 1024, prefill chunk 256, the launcher's 4 seeded
        requests, 16 greedy tokens; ``extra_argv`` quantizes) and hold its
        gates: one MLA block and one MoE block against plain on one input,
        the launch counts per forward, the KV bytes per block, the first
        prefill chunk's and decode step's logits against plain on the card,
        the captured steps against the eager ones; under int8 KV the first
        import's pool rows against the CPU's quantizer.  Returns the
        launches and the serving numbers."""
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        log(f"  allocated before the phase: {left:.2f} GiB")
        if left > 4:
            raise AssertionError(f"phase {phase}: the earlier phases left weights or pools on the card")
        ds_argv = ["--arch", "deepseek-v2-lite-16b", "--full", "--dtype", "bfloat16", "--requests", "4",
                   "--max-new", "16", "--slots", "4", "--max-seq", "1024", "--prefill-chunk", "256",
                   "--seed", str(SEED), "--prompt-len", "200", "601", "--temperature", "0"] + list(extra_argv)
        dst = {"times": {"_prefill_fwd": [], "_decode": []}, "checked": {}, "held": {}, "orig": {}, "imported": {},
               "first": {}}

        def ds_hook(server, reqs):
            """Gate 1 (one MLA block and one MoE block, kernels against plain
            on the same input), then every count to 0; the engine's two steps
            timed, and on the first call of each the routing kept and the same
            step run on a copy of its inputs through the plain versions."""
            eng, c = server.engine, server.engine.cfg
            torch.cuda.synchronize()
            dst.update(server=server, reqs=reqs, allocated_after_init_gib=torch.cuda.memory_allocated() / 2**30,
                       init_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            lp = tf_model._layers(server.params["layers"], c.n_layers)[0]
            pos = torch.arange(256, device=dev)
            x = server.params["embed"][torch.as_tensor(reqs[0].prompt[:256], device=dev)][None].to(
                getattr(torch, c.compute_dtype))
            rope = layers.rope_tables(pos, c.qk_rope_head_dim, c.rope_theta)
            blocks = {}
            for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_backends)):
                cache = tf_model.init_cache(c, 1, 1024, device=dev)
                lcache = dict({nm: t[0] for nm, t in cache["layers"].items()}, pos=0)
                with ctx(), torch.no_grad():
                    a, _ = attention.mla_attention(x, lp, c, positions=pos, cache=lcache, rope=rope, residual=x,
                                                   norm=lp["attn_norm"])
                    h = blocks["kernels"][0] if label == "plain" else a  # the MoE block on one input
                    f, _, dropped, ids = moe.moe_ffn(layers.rms_norm(h, lp["ffn_norm"], c.norm_eps), lp, c,
                                                     return_routing=True)
                blocks[label] = (a, h + f, ids, int(dropped))
                del cache, lcache
            (a_k, m_k, ids_k, drop_k), (a_p, m_p, ids_p, drop_p) = blocks["kernels"], blocks["plain"]
            close("MLA block (absorbed form, 256 tokens) kernels vs plain", a_k, a_p, block_tol(scheme))
            close("MoE block (routed + shared experts, 256 tokens) kernels vs plain", m_k, m_p, block_tol(scheme))
            if not torch.equal(ids_k, ids_p) or drop_k != drop_p:
                raise AssertionError(f"phase {phase}: the MoE block routed differently on the same input")
            log(f"  MoE block: routing ids identical ({ids_k.numel()} choices), {drop_k} (token, slot) pairs dropped "
                f"at capacity {moe.moe_capacity(256, c)}")
            del blocks, a_k, m_k, a_p, m_p, x
            if eng.kv_quant == "int8":
                check_first_import(eng, dst["imported"])
            if scheme is None:
                record_first_logits(eng, c.vocab_size, dst["first"])
            plain_steps = {"_prefill_fwd": tf_model.decode_step_fn(c, attn_backend="flash"),
                           "_decode": tf_model.paged_decode_step_fn(c)}
            for attr in ("_prefill_fwd", "_decode"):
                dst["orig"][attr] = getattr(eng, attr)

                def run(*a, _f=getattr(eng, attr), _attr=attr):
                    keep_last(dst["held"], _attr, a)  # checked against the eager step after the run
                    first = _attr not in dst["checked"]
                    inputs = clone_tree(a[1]) if first else None
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = _f(*a)
                    torch.cuda.synchronize()
                    dst["times"][_attr].append(time.perf_counter() - t)
                    if not bool(torch.isfinite(out[0][..., :c.vocab_size]).all()):
                        raise AssertionError(f"deepseek full width: non-finite logits from {_attr}")
                    if first:
                        # the captured step takes no trace: the kernels' expert
                        # choices come from the uncaptured step on a copy of the
                        # inputs (the same kernels; its logits must be the
                        # captured step's first call's, an eager run, bit for
                        # bit), then the plain step twice:
                        # routing freely, and replaying those choices
                        stats, free = {}, {}
                        with uncounted(), torch.no_grad():
                            eager = plain_steps[_attr](a[0], clone_tree(inputs), *dev_args(a), moe_trace=stats)[0]
                        if not torch.equal(eager[live_rows(a)], out[0][live_rows(a)]):
                            raise AssertionError(f"deepseek full width: the captured {_attr} differs from the eager "
                                                 f"step")
                        replay, cap = {"replay_ids": stats["ids"]}, {"vocab": c.padded_vocab}
                        with plain_backends(), torch.no_grad():
                            want_free = plain_steps[_attr](a[0], clone_tree(inputs), *dev_args(a), moe_trace=free)[0]
                        with plain_backends(cap), torch.no_grad():
                            want = plain_steps[_attr](a[0], inputs, *dev_args(a), moe_trace=replay)[0]
                        dst["checked"][_attr] = (out[0][..., :c.vocab_size].float().clone(),
                                                 want[..., :c.vocab_size].float(), want_free[..., :c.vocab_size].float(),
                                                 stats, free, replay, cap.get("head_x"))
                        del inputs, want, want_free, eager
                    return out
                setattr(eng, attr, run)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = serve_cli.main(ds_argv, on_server=ds_hook)
        wall = time.perf_counter() - t0
        launches_ds = read_counts()
        peak, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        server, reqs, times = dst["server"], dst["reqs"], dst["times"]
        dcfg = server.engine.cfg
        assert (dcfg.n_layers, dcfg.d_model, dcfg.vocab_size, dcfg.n_experts, dcfg.moe_top_k, dcfg.kv_lora_rank) == (
            27, 2048, 102400, 64, 6, 512)
        n_prefill, n_decode = len(times["_prefill_fwd"]), len(times["_decode"])
        n_params, weights_gib = weight_stats(server.params)
        log(f"  {n_params} parameters, {weights_gib:.3f} GiB of weights ({dst['allocated_after_init_gib']:.2f} GiB "
            f"allocated after init, init peak {dst['init_peak_gib']:.2f} GiB); prompts {[len(r.prompt) for r in reqs]}, "
            f"{n_prefill} prefill chunks, {n_decode} decode steps, wall {wall:.2f} s")
        if sorted(results) != [0, 1, 2, 3] or any(not v for v in results.values()):
            raise AssertionError("deepseek full width: not every request was served")
        st = server.last_stats
        if (n_prefill, n_decode) != (st["prefill_chunks"], st["decode_steps"]):
            raise AssertionError("deepseek full width: step counts disagree with the engine's stats")
        # per forward: wq, w_dkv, w_krope (rmsnorm prologue), wo (residual) and the
        # shared experts' gate+up and down in each of 27 layers, and the lm_head;
        # the routed experts are einsums, MLA's attention is latent-space torch
        n_fwd = n_prefill + n_decode
        per_forward = dip_per_forward(dcfg)
        if per_forward != 163:
            raise AssertionError(f"deepseek: the template gives {per_forward} DiP launches per forward, not 163")
        other = {"dip_systolic": 0, "flash_attention": 0, "lm_head_ce": 0}
        q_tc = q_quant = 0
        if scheme is None:
            want = dict(other, dip_matmul=per_forward * n_fwd, dip_matmul_q=0)
            log(f"  launches {launches_ds}; expected {want}: {launches_ds['dip_matmul'] / n_fwd:g} dip_matmul launches "
                f"per forward (163 = 6 x 27 + 1; replays counted)")
            if launches_ds != want:
                raise AssertionError("deepseek full width: launch counts differ from 163 DiP launches per forward")
        else:
            q_tc, q_quant = check_quantized_launches(f"deepseek {scheme}", scheme, launches_ds, per_forward, n_fwd, other)
        kv_bytes = kvc.bytes_per_block(dcfg)
        pool_bytes = sum(t.numel() * t.element_size() for t in server.engine.kv.pools["layers"].values())
        kv_want = 252_288 if server.engine.kv_quant == "int8" else 497_664
        log(f"  KV bytes per 16-token block {kv_bytes} (the pool: {pool_bytes} bytes in {server.engine.kv.num_blocks} "
            f"blocks); peak memory while serving {peak / 2**30:.2f} GiB allocated, {peak_reserved / 2**30:.2f} GiB "
            f"reserved")
        if kv_bytes != kv_want or pool_bytes != kv_bytes * server.engine.kv.num_blocks:
            raise AssertionError(f"deepseek full width: the latent pool does not cost {kv_want} bytes per block")
        if server.engine.kv_quant == "int8" and set(dst["imported"]) != {"c_kv", "k_rope"}:
            raise AssertionError("deepseek full width: the int8 latent rows of an import were never checked")
        # gate 2: the first prefill chunk's and decode step's logits against the
        # plain versions on the card, on the same inputs.  A bf16 difference
        # upstream can flip a near tie in a token's top-6, and at capacity a
        # flipped choice also changes which of its expert's tokens are dropped,
        # which moves logits by far more than any rounding (measured: up to 0.86
        # at max|plain| 4.78 with 1711 of 41472 choices flipped, H100 80GB HBM3,
        # 700 W); so the routing choices that differ from a freely routing plain
        # run are counted and printed, and the bound FULL_TOL holds the plain
        # run that replays this run's choices: every other difference is the
        # kernels' arithmetic over 27 bf16 layers
        # under int8 each logit may also move by one activation-code step of
        # every lm_head input (as in 5b): the layers' bf16 roundings move an
        # activation across a rounding midpoint now and then
        ds_checked = {}
        for attr, (got, want_l, free_l, stats, free, replay, head_x) in dst["checked"].items():
            if not all(torch.equal(ik, ir) for ik, ir in zip(stats["ids"], replay["ids"])):
                raise AssertionError("deepseek full width: the replayed plain run did not route as the kernels' run")
            err, err_free = (got - want_l).abs(), (got - free_l).abs().max().item()
            scale = max(1.0, want_l.abs().max().item())
            within = float((err <= TOL["bfloat16"] * scale).float().mean())
            flips = sum(int((~(ik[..., :, None] == ip[..., None, :]).any(-1)).sum())
                        for ik, ip in zip(stats["ids"], free["ids"]))
            choices = sum(ik.numel() for ik in stats["ids"])
            dropped = [int(v) for v in stats["dropped"]]
            log(f"  {attr} first call, kernels against plain on the card: routing freely, logits max|err| "
                f"{err_free:.3e}, {flips} of {choices} top-6 choices differ, dropped (token, slot) pairs over the 27 "
                f"layers {sum(dropped)} (plain {sum(int(v) for v in free['dropped'])}); replaying the kernels' choices, "
                f"logits max|err| {err.max().item():.3e} (max|plain| {scale:.3g}, bound {FULL_TOL:g} x scale), "
                f"{100 * within:.4f}% within {TOL['bfloat16']:g} x scale")
            lim = FULL_TOL * scale
            if scheme == "int8":
                lim = lim + head_step(server.params["lm_head"], head_x, dcfg.vocab_size).reshape(got.shape)
            if not bool((err <= lim).all()):
                raise AssertionError(f"deepseek full width: {attr} logits outside the stated bound")
            ds_checked[attr] = {"max_err_replayed_routing": err.max().item(), "max_err_free_routing": err_free,
                                "max_plain": scale, "routing_choices_differing": flips, "routing_choices": choices,
                                "dropped": sum(dropped)}
        if set(ds_checked) != {"_prefill_fwd", "_decode"}:
            raise AssertionError("deepseek full width: a step was never checked against plain")
        whole = whole_prompt_forward(server.params, dcfg, reqs) if scheme is None else None
        if scheme is None:
            ds_for_9e.update(ep_records(server, reqs, results, dst["first"]))
        prompt_tokens, generated = sum(len(r.prompt) for r in reqs), sum(len(v) for v in results.values())
        ds_serving = {
            "median_prefill_chunk_ms": 1e3 * statistics.median(times["_prefill_fwd"]),
            "median_decode_step_ms": 1e3 * statistics.median(times["_decode"]),
            "prefill_tok_per_s": prompt_tokens / sum(times["_prefill_fwd"]),
            "decode_tok_per_s": (generated - len(reqs)) / sum(times["_decode"]),
            "peak_memory_gib": peak / 2**30, "peak_reserved_gib": peak_reserved / 2**30,
            "graph_pool_gib": graph_pool_gib(dst["orig"]["_prefill_fwd"], dst["orig"]["_decode"]),
            "kv_bytes_per_block": kv_bytes, "parameters": n_params, "weights_gib": weights_gib,
            "dip_launches_per_forward": per_forward, "dip_matmul_q_tensor_core_launches": q_tc,
            "dip_matmul_q_quantizing_passes": q_quant, "int8_import_rows": dst["imported"],
            "first_prefill_chunk_dropped": ds_checked["_prefill_fwd"]["dropped"], "checked": ds_checked,
            "wall_s": wall, "prefill_chunks": n_prefill, "decode_steps": n_decode, "whole_prompt_forward": whole,
        }
        log(f"  results: { {k: v[:6] for k, v in results.items()} }")
        tag = "deepseek" if scheme is None else f"deepseek {scheme}"
        ds_serving["graphs"] = {
            "decode": graph_check(f"{tag} decode step", dst["orig"]["_decode"], tf_model.paged_decode_step_fn(dcfg),
                                  dst["held"]["_decode"], dcfg.vocab_size),
            "prefill": graph_check(f"{tag} prefill chunk", dst["orig"]["_prefill_fwd"],
                                   tf_model.decode_step_fn(dcfg, attn_backend="flash"), dst["held"]["_prefill_fwd"],
                                   dcfg.vocab_size)}
        log("  serving " + json.dumps(ds_serving))
        dst.clear()
        del server, reqs, results
        gc.collect()
        torch.cuda.empty_cache()
        return launches_ds, ds_serving

    log("phase 5d: deepseek-v2-lite-16b full width (27 layers, d_model 2048, MLA with kv_lora_rank 512, "
        "64 routed experts top-6 + 2 shared), bf16, dip storage, through launch.serve")
    launches_ds, ds_serving = serve_deepseek("5d")
    log("phase 9e: deepseek-v2-lite-16b expert-parallel (ep) at full width over 2 ranks sharing the card (host "
        "transport), after 5d with its engine freed, held to 5d's records")
    ep_out = phase9e(ds_for_9e)
    ds_for_9e.clear()
    log("phase 5g: deepseek-v2-lite-16b full width, bf16 compute, --quantize int8 --kv-quant int8 (the MLA and "
        "shared-expert projections and the head int8, the router and expert banks bf16), through launch.serve")
    launches_dsq, dsq_serving = serve_deepseek("5g", ["--quantize", "int8", "--kv-quant", "int8"], "int8")

    # --------------- 5e / 5f. Zamba2-2.7B and Mamba2-370M at full width ------
    def serve_ssm(phase, arch, per_forward, flash_per_call, kv_bytes_want, slot_bytes_want, dims, extra_argv=(),
                  scheme=None, sharded_records=None, requests=4):
        """Serve ``arch`` through ``launch.serve --full`` (4 slots, max_seq
        1024, prefill chunk 256, the launcher's first ``requests`` seeded requests, 16
        greedy tokens; ``extra_argv`` quantizes) and hold its gates: layer
        0's Mamba2 block (and the hybrid's shared block) against plain on
        one input, the first prefill chunk's and decode step's logits
        against plain on the card, the launch counts per forward (the
        prefill tail's single-token forwards included; ``per_forward`` DiP
        projections, as the template counts them), the KV bytes per block
        and the per-slot state bytes; under int8 KV the first import's
        shared-attention rows against the CPU's quantizer.  With
        ``sharded_records`` (a dict), the same engine then serves the
        prompts of phases 9f and 9g (``z_records``) for their first-token
        logits, uncounted.  Returns the launches, flash's routes and the
        serving numbers."""
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        log(f"  allocated before the phase: {left:.2f} GiB")
        if left > 4:
            raise AssertionError(f"phase {phase}: the earlier phases left weights or pools on the card")
        argv = ["--arch", arch, "--full", "--dtype", "bfloat16", "--requests", str(requests), "--max-new", "16",
                "--slots",
                "4", "--max-seq", "1024", "--prefill-chunk", "256", "--seed", str(SEED), "--prompt-len", "200",
                "601", "--temperature", "0"] + list(extra_argv)
        st = {"times": {"chunk": [], "tail": [], "decode": []}, "checked": {}, "held": {}, "orig": {}, "imported": {}}

        def copy_to(t, where):
            """A copy of a cache tree (dicts of tensors and ints) on ``where``."""
            if isinstance(t, dict):
                return {k: copy_to(x, where) for k, x in t.items()}
            return t.to(where, copy=True) if isinstance(t, torch.Tensor) else t

        def as_f32(t):
            """A copy of a parameter or cache tree with every float leaf in f32."""
            if isinstance(t, dict):
                return {k: as_f32(x) for k, x in t.items()}
            if isinstance(t, api.DipWeight):
                return t.with_data(t.data.float())
            if isinstance(t, torch.Tensor):
                return t.to(torch.float32 if t.is_floating_point() else t.dtype, copy=True)
            return t

        def hook(server, reqs):
            """Gate 1, then every count to 0; the engine's steps timed by
            kind (a prefill chunk, a single-token forward of the prefill
            tail, a decode step), and the first chunk and decode step run
            again on a copy of their inputs through the plain versions."""
            eng, c = server.engine, server.engine.cfg
            cd = getattr(torch, c.compute_dtype)
            torch.cuda.synchronize()
            st.update(server=server, reqs=reqs, allocated_after_init_gib=torch.cuda.memory_allocated() / 2**30,
                      init_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            lp = tf_model._layers(server.params["layers"], c.n_layers)[0]
            x = server.params["embed"][torch.as_tensor(reqs[0].prompt[:257], device=dev)][None].to(cd)
            blocks = {}
            for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_backends)):
                with ctx(), torch.no_grad():
                    y0, c0 = tf_model._mamba_block(x[:, :256], lp, c, ssm.init_ssm_cache(1, c, cd, device=dev))
                    y1, c1 = tf_model._mamba_block(x[:, 256:], lp, c, c0)
                    blocks[label] = {"chunk output": y0, "chunk state": c0["state"], "chunk conv": c0["conv"],
                                     "decode output": y1, "decode state": c1["state"]}
                    if c.is_hybrid:  # the shared block on the kernels' Mamba2 output, the same on both sides
                        pos = torch.arange(256, device=dev)
                        acache = attention.init_gqa_cache(1, c.n_kv_heads, 1024, c.resolved_head_dim, cd, dev)
                        blocks[label]["shared block"] = tf_model._transformer_block(
                            blocks["kernels"]["chunk output"], server.params["shared_attn"], c, positions=pos,
                            rope=layers.rope_tables(pos, c.resolved_head_dim, c.rope_theta), cache=acache,
                            attn_backend="flash" if label == "kernels" else None)[0]
            for key in blocks["kernels"]:
                close(f"layer 0 {key} (256-token chunk from zero state, then one decode token) kernels vs plain"
                      if "shared" not in key else "shared attention+FFN block (256 tokens, flash vs dense) "
                      "kernels vs plain", blocks["kernels"][key], blocks["plain"][key], block_tol(scheme))
            del blocks, x
            if eng.kv_quant == "int8" and c.is_hybrid:
                check_first_import(eng, st["imported"])
            plain_steps = {"_prefill_fwd": tf_model.decode_step_fn(c), "_decode": tf_model.paged_decode_step_fn(c)}
            c32 = dataclasses.replace(c, param_dtype="float32", compute_dtype="float32", matmul_backend="torch")
            f32_steps = {"_prefill_fwd": tf_model.decode_step_fn(c32), "_decode": tf_model.paged_decode_step_fn(c32)}
            st["eager"] = eager_steps = {"_prefill_fwd": tf_model.decode_step_fn(c, attn_backend="flash"),
                                         "_decode": tf_model.paged_decode_step_fn(c)}
            for attr in ("_prefill_fwd", "_decode"):
                st["orig"][attr] = getattr(eng, attr)

                def run(*a, _f=getattr(eng, attr), _attr=attr):
                    kind = "decode" if _attr == "_decode" else "chunk" if a[2].shape[1] > 1 else "tail"
                    keep_last(st["held"], kind, a)  # checked against the eager step after the run
                    first = kind != "tail" and kind not in st["checked"]
                    inputs = copy_to(a[1], "cpu") if first else None  # on the host: no card memory
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = _f(*a)
                    torch.cuda.synchronize()
                    st["times"][kind].append(time.perf_counter() - t)
                    if not bool(torch.isfinite(out[0][..., :c.vocab_size]).all()):
                        raise AssertionError(f"{arch} full width: non-finite logits from a {kind} call")
                    if first:
                        # the kernels' block inputs, taped: the uncaptured
                        # step (the same kernels; its logits must be the
                        # captured step's first call's, an eager run, bit for
                        # bit) on a copy of the inputs; then
                        # the plain step on copies: replaying those block
                        # inputs, and running freely; and the same bf16
                        # weights and inputs in f32 (torch.matmul).  The
                        # serving peak is read before, and reset after
                        st["peak"] = max(st.get("peak", 0), torch.cuda.max_memory_allocated())
                        st["peak_reserved"] = max(st.get("peak_reserved", 0), torch.cuda.max_memory_reserved())
                        v, tape = c.vocab_size, {}
                        with uncounted(), torch.no_grad(), block_tape(tf_model, "record", tape):
                            eager = eager_steps[_attr](a[0], copy_to(inputs, dev), *dev_args(a))[0]
                        if not torch.equal(eager[live_rows(a)], out[0][live_rows(a)]):
                            raise AssertionError(f"{arch} full width: the captured {kind} call differs from the eager "
                                                 f"step")
                        del eager
                        cap = {"vocab": c.padded_vocab}
                        with plain_backends(), torch.no_grad():
                            with block_tape(tf_model, "replay", tape), plain_backends(cap):
                                forced = plain_steps[_attr](a[0], copy_to(inputs, dev), *dev_args(a))[0][..., :v].float()
                            free = plain_steps[_attr](a[0], copy_to(inputs, dev), *dev_args(a))[0][..., :v].float()
                        with torch.no_grad():
                            f32 = f32_steps[_attr](as_f32(a[0]), as_f32(copy_to(inputs, dev)),
                                                   *dev_args(a))[0][..., :v].float()
                        if len(tape["record"]) != len(tape["replay"]):
                            raise AssertionError(f"{arch}: the plain run took other blocks than the kernels' run")
                        st["checked"][kind] = dict(
                            got=out[0][..., :v].float().clone(), forced=forced, free=free, f32=f32,
                            head_x=cap.get("head_x"),
                            blocks=[((ok - op).abs().max() / op.abs().max().clamp(min=1.0)).item()
                                    for (_, ok), (_, op) in zip(tape["record"], tape["replay"])])
                        del inputs, forced, free, f32, tape
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats()
                    return out
                setattr(eng, attr, run)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = serve_cli.main(argv, on_server=hook)
        wall = time.perf_counter() - t0
        launches, routes = read_counts(), flash_routes()
        peak = max(st.get("peak", 0), torch.cuda.max_memory_allocated())
        peak_reserved = max(st.get("peak_reserved", 0), torch.cuda.max_memory_reserved())
        server, reqs, times = st["server"], st["reqs"], st["times"]
        c = server.engine.cfg
        assert (c.n_layers, c.d_model, c.vocab_size) == dims
        n_chunk, n_tail, n_decode = (len(times[k]) for k in ("chunk", "tail", "decode"))
        n_params, weights_gib = weight_stats(server.params)
        plens = [len(r.prompt) for r in reqs]
        log(f"  {n_params} parameters, {weights_gib:.3f} GiB of weights ({st['allocated_after_init_gib']:.2f} GiB "
            f"allocated after init, init peak "
            f"{st['init_peak_gib']:.2f} GiB); prompts {plens}: {n_chunk} prefill chunks, {n_tail} single-token "
            f"forwards of the prefill tail, {n_decode} decode steps, wall {wall:.2f} s")
        if sorted(results) != list(range(requests)) or any(not v for v in results.values()):
            raise AssertionError(f"{arch} full width: not every request was served")
        if (n_chunk, n_tail) != (sum(n // 256 for n in plens), sum(n % 256 for n in plens)):
            raise AssertionError(f"{arch} full width: the prefill did not run whole chunks, then the tail token "
                                 f"by token")
        if n_decode != server.last_stats["decode_steps"]:
            raise AssertionError(f"{arch} full width: decode steps disagree with the engine's stats")
        n_fwd = n_chunk + n_tail + n_decode
        if dip_per_forward(c) != per_forward:
            raise AssertionError(f"{arch}: the template gives {dip_per_forward(c)} DiP launches per forward, not "
                                 f"{per_forward}")
        other = {"dip_systolic": 0, "flash_attention": flash_per_call * (n_chunk + n_tail), "lm_head_ce": 0}
        want = dict(other, dip_matmul=per_forward * n_fwd, dip_matmul_q=0)
        q_tc = q_quant = 0
        if scheme is not None:
            q_tc, q_quant = check_quantized_launches(f"{arch} {scheme}", scheme, launches, per_forward, n_fwd, other)
            want = dict(other, dip_matmul=0, dip_matmul_q=per_forward * n_fwd)
        # flash: the chunks (Sq = 256) on the tensor cores unsplit, the tail's
        # single tokens on split_kv, none on the CUDA cores
        want_routes = {"tensor_cores": flash_per_call * n_chunk, "split_kv": flash_per_call * n_tail,
                       "cuda_cores": 0}
        log(f"  launches {launches}, flash by route {routes}; expected {want}, flash {want_routes} (replays "
            f"counted): {(launches['dip_matmul'] + launches['dip_matmul_q']) / n_fwd:g} DiP launches per forward, "
            f"{launches['flash_attention'] / max(1, n_chunk + n_tail):g} flash launches per prefill call")
        if launches != want or routes != want_routes:
            raise AssertionError(f"{arch} full width: launch counts differ from {per_forward} DiP launches per "
                                 f"forward and {flash_per_call} flash launches per prefill call, the chunks' on the "
                                 f"tensor cores and the tail's on split_kv")
        pools = server.engine.kv.pools["layers"]
        kv_bytes = kvc.bytes_per_block(c)
        slot_bytes = sum(pools[nm].numel() * pools[nm].element_size() for nm in ("conv", "state")) // 4
        attn_bytes = sum(t.numel() * t.element_size() for t in pools.get("attn", {}).values())
        log(f"  KV bytes per 16-token block {kv_bytes} (the paged pool: {attn_bytes} bytes in "
            f"{server.engine.kv.num_blocks} blocks); state bytes per slot {slot_bytes} (conv history and f32 "
            f"state); peak memory while serving {peak / 2**30:.2f} GiB")
        if (kv_bytes, slot_bytes) != (kv_bytes_want, slot_bytes_want) or (
                attn_bytes != kv_bytes * server.engine.kv.num_blocks if c.is_hybrid else attn_bytes != 0):
            raise AssertionError(f"{arch} full width: the pools do not cost {kv_bytes_want} bytes per block and "
                                 f"{slot_bytes_want} per slot")
        if server.engine.kv_quant == "int8" and c.is_hybrid and set(st["imported"]) != {"k", "v"}:
            raise AssertionError(f"{arch} full width: the int8 shared-attention rows of an import were never checked")
        # gate 2: the first prefill chunk's and decode step's logits against
        # the plain versions on the card on the same inputs.  Two bf16 runs
        # of these random-weight SSM stacks drift apart block by block (each
        # block's roundings feed every later one): running freely, zamba2's
        # first chunk differs by 2.97e-01 at max|plain| 5.06, while the
        # kernels' and the plain run sit 3.10e-01 and 3.17e-01 from an f32
        # run of the same bf16 weights (H100 80GB HBM3, 700 W).  So the
        # plain run replays the kernels' run's input to every block, and
        # FULL_TOL holds each block's output and the logits; running freely,
        # the kernels' logits must be no further from the f32 run than
        # F32_DRIFT times the plain run's, and the free difference is printed
        checked = {}
        for kind, r in st["checked"].items():
            got, forced = r["got"], r["forced"]
            scale = max(1.0, forced.abs().max().item())
            err = (got - forced).abs()
            # under int8 with a quantized head, one activation-code step of
            # every lm_head input more (as in 5b; a tied head is float)
            lim = FULL_TOL * scale
            if scheme == "int8" and "lm_head" in server.params:
                lim = lim + head_step(server.params["lm_head"], r["head_x"], c.vocab_size).reshape(got.shape)
            within = float((err <= TOL["bfloat16"] * scale).float().mean())
            worst_block = max(r["blocks"])
            free_err = (got - r["free"]).abs().max().item()
            k32, p32 = (got - r["f32"]).abs().max().item(), (r["free"] - r["f32"]).abs().max().item()
            log(f"  first {kind} call, kernels against plain on the card, the plain run replaying the kernels' "
                f"block inputs: logits max|err| {err.max().item():.3e} (max|plain| {scale:.3g}, bound {FULL_TOL:g} x "
                f"scale), {100 * within:.4f}% within {TOL['bfloat16']:g} x scale; the worst of {len(r['blocks'])} "
                f"blocks {worst_block:.3e} of its scale (bound {FULL_TOL:g}), "
                f"{sum(b <= TOL['bfloat16'] for b in r['blocks'])} within {TOL['bfloat16']:g}; running freely: "
                f"logits max|kernels - plain| {free_err:.3e}, max|kernels - f32| {k32:.3e}, max|plain - f32| "
                f"{p32:.3e} (bound {F32_DRIFT:g} x the plain run's)")
            if not bool((err <= lim).all()) or worst_block > FULL_TOL:
                raise AssertionError(f"{arch} full width: {kind} logits or a block outside the stated bound")
            if k32 > F32_DRIFT * p32:
                raise AssertionError(f"{arch} full width: the kernels' {kind} logits drift from the f32 run more "
                                     f"than the plain run's")
            checked[kind] = {"max_err_replayed_inputs": err.max().item(), "max_plain": scale,
                             "within_tol_share": within, "worst_block_rel": worst_block,
                             "max_err_free": free_err, "max_err_kernels_f32": k32, "max_err_plain_f32": p32}
        if set(checked) != {"chunk", "decode"}:
            raise AssertionError(f"{arch} full width: a step was never checked against plain")
        generated = sum(len(v) for v in results.values())
        serving = {
            "median_prefill_chunk_ms": 1e3 * statistics.median(times["chunk"]),
            "median_decode_step_ms": 1e3 * statistics.median(times["decode"]),
            "tail_forwards": n_tail, "mean_tail_forward_ms": 1e3 * statistics.mean(times["tail"]),
            "median_tail_forward_ms": 1e3 * statistics.median(times["tail"]),
            "tail_s": sum(times["tail"]), "chunks_s": sum(times["chunk"]),
            "prefill_tok_per_s": sum(plens) / (sum(times["chunk"]) + sum(times["tail"])),
            "decode_tok_per_s": (generated - len(reqs)) / sum(times["decode"]),
            "peak_memory_gib": peak / 2**30, "peak_reserved_gib": peak_reserved / 2**30,
            "graph_pool_gib": graph_pool_gib(st["orig"]["_prefill_fwd"], st["orig"]["_decode"]),
            "kv_bytes_per_block": kv_bytes, "state_bytes_per_slot": slot_bytes,
            "parameters": n_params, "weights_gib": weights_gib, "dip_launches_per_forward": per_forward,
            "dip_matmul_q_tensor_core_launches": q_tc, "dip_matmul_q_quantizing_passes": q_quant,
            "int8_import_rows": st["imported"], "checked": checked, "wall_s": wall, "prefill_chunks": n_chunk,
            "decode_steps": n_decode,
        }
        log(f"  results: { {k: v[:6] for k, v in results.items()} }")
        # the last decode step, chunk and tail token replayed against the
        # eager step; and the prompts' whole tails as the engine ran them
        tag = arch if scheme is None else f"{arch} {scheme}"
        serving["graphs"] = {
            kind: graph_check(f"{tag} {what}", st["orig"][attr], st["eager"][attr], st["held"][kind], c.vocab_size)
            for kind, attr, what in (("decode", "_decode", "decode step"), ("chunk", "_prefill_fwd", "prefill chunk"),
                                     ("tail", "_prefill_fwd", "single-token forward of the prefill tail"))}
        tail_capture = st["orig"]["_prefill_fwd"].captures[((1, 1),)]["seconds"]
        log(f"  the prompts' {n_tail} tail forwards as served: {serving['tail_s']:.3f} s of wall under graphs, the "
            f"first call (the eager step, then its capture of {tail_capture:.3f} s) included; "
            f"{sum(times['tail'][1:]):.3f} s for the other "
            f"{n_tail - 1} ({gpu})")
        serving["tail_capture_s"] = tail_capture
        log("  serving " + json.dumps(serving))
        if sharded_records is not None:
            sharded_records.update(z_records(server.engine, st["orig"], reqs))
        st.clear()
        del server, reqs, results, pools
        gc.collect()
        torch.cuda.empty_cache()
        return launches, routes, serving

    log("phase 5e: zamba2-2.7b full width (54 Mamba2 layers, d_model 2560, state 64; one shared attention+FFN "
        "block at 9 call sites, 32 heads of 80), bf16, dip storage, through launch.serve")
    # per forward: in_proj and out_proj (residual) of each of 54 Mamba2
    # layers; wq, wk, wv (rmsnorm prologue), wo (residual), gate+up and down
    # of the shared block at each of 9 sites; the lm_head.  Flash: the 9
    # sites of every prefill call, a single-token one of the tail included.
    # KV: 9 instances x 16 tokens x (k, v) x 32 heads x 80 x 2 bytes
    z_rec = {}  # 5e's records, for phases 9f / 9g
    launches_zb, routes_zb, zb_serving = serve_ssm(
        "5e", "zamba2-2.7b", 54 * 2 + 9 * 6 + 1, 9, 9 * 16 * 2 * 32 * 80 * 2,
        54 * (3 * 5248 * 2 + 80 * 64 * 64 * 4), (54, 2560, 32000), sharded_records=z_rec)
    log("phase 9f: zamba2-2.7b tensor-parallel (tp) at full width over 2 ranks sharing the card (host transport), "
        "after 5e with its engine freed, held to 5e's records; then 9g under fsdp and 9h, in the same world")
    z_out = phase9z(z_rec)
    z_rec.clear()
    log("phase 5f: mamba2-370m full width (48 Mamba2 layers, d_model 1024, state 128, tied head), bf16, dip "
        "storage, through launch.serve")
    # per forward: in_proj and out_proj of each of 48 layers; the tied head
    # is torch.matmul of the embedding, as in the reference; nothing paged
    launches_mb, routes_mb, mb_serving = serve_ssm(
        "5f", "mamba2-370m", 48 * 2, 0, 0, 48 * (3 * 2304 * 2 + 32 * 64 * 128 * 4), (48, 1024, 50280), requests=2)
    routes_by_path.update(serve_zamba2=routes_zb, serve_mamba2=routes_mb)
    log("phase 5h: zamba2-2.7b full width, bf16 compute, --quantize int8 --kv-quant int8 (its projections and the "
        "shared block int8, the SSM scalars, conv and norms bf16), through launch.serve")
    # KV: 9 instances x 16 tokens x (k, v) x 32 heads x (80 int8 codes + one f32 scale); the state unchanged
    launches_zbq, routes_zbq, zbq_serving = serve_ssm(
        "5h", "zamba2-2.7b", 54 * 2 + 9 * 6 + 1, 9, 9 * 16 * (2 * 32 * 80 + 2 * 32 * 4),
        54 * (3 * 5248 * 2 + 80 * 64 * 64 * 4), (54, 2560, 32000), ["--quantize", "int8", "--kv-quant", "int8"], "int8",
        requests=2)
    log("phase 5h: mamba2-370m full width, bf16 compute, --quantize int8 (in_proj and out_proj int8, the tied head "
        "the bf16 embedding), through launch.serve")
    launches_mbq, routes_mbq, mbq_serving = serve_ssm(
        "5h", "mamba2-370m", 48 * 2, 0, 0, 48 * (3 * 2304 * 2 + 32 * 64 * 128 * 4), (48, 1024, 50280),
        ["--quantize", "int8"], "int8", requests=2)
    routes_by_path.update(serve_zamba2_int8=routes_zbq, serve_mamba2_int8=routes_mbq)

    short = [(w, n) for w, n in trace_checks if n]
    log(f"  the profiler's trace of a replay lacked records of counted kernels in {len(short)} of "
        f"{len(trace_checks)} graph checks: {short}")

    # ------------------------------------------- 6. full-width training -----
    t_batch, t_seq, t_steps, t_lr = 4, 1024, 4, 3e-4

    def padding_nonzero(w):
        """Nonzero elements of a ``DipWeight``'s padding (rows past d_in,
        columns past d_out of each natural matrix), one layer at a time."""
        n = 0
        for mat in w.data.reshape((-1,) + tuple(w.data.shape[-2:])):
            nat = permute.unpermute_tiled(mat, w.perm_tile)
            n += int((nat[w.d_in:] != 0).sum()) + int((nat[:, w.d_out:] != 0).sum())
        return n

    def padded_dips(t, keys=()):
        """(keys, DipWeight) of every DiP leaf whose logical shape leaves padding."""
        if isinstance(t, dict):
            for k, v in t.items():
                yield from padded_dips(v, keys + (k,))
        elif isinstance(t, api.DipWeight) and (t.d_in % t.perm_tile or t.d_out % t.perm_tile):
            yield keys, t

    def at(t, keys):
        for k in keys:
            t = t[k]
        return t

    def train_family(phase, arch_name, layers=None, resume=True):
        """One model trained at full width through ``launch.train`` (f32
        parameters, bf16 compute, block remat, batch 4 x 1024, 4 AdamW steps,
        the launcher's schedule), with its gates: the first step through the
        kernels against plain PyTorch in f32 and bf16 compute (a MoE model's
        plain run replaying the kernels' expert ids; a recurrent stack's bf16
        step, where it misses FIRST_STEP_TOL, held to no further from the f32
        plain run than F32_DRIFT times the bf16 plain run), 0 expert ids of
        the remat rerun that differ from the forward's, the launches of the
        4 steps (per step, twice every DiP projection of a forward but the
        head, which the fused loss takes: forward and remat rerun; one
        lm_head_ce, no flash), every padded DiP leaf's padding and both its
        moments exactly 0 after the steps, finite losses, and (``resume``) a
        run resumed from the step-3 checkpoint whose step 4 is the
        uninterrupted one's."""
        base = get_config(arch_name)
        c = dataclasses.replace(base, matmul_backend="dip", n_layers=layers or base.n_layers)
        assert (c.param_dtype, c.compute_dtype, c.remat) == ("float32", "bfloat16", "block")
        cut = f"{c.n_layers} of {base.n_layers} layers" + (" (cut)" if layers else " (all)")
        data = SyntheticLM(vocab_size=c.vocab_size, seq_len=t_seq, global_batch=t_batch, seed=SEED,
                           emit_embeddings=c.d_model if c.frontend != "none" else None)
        head = int("lm_head" in tf_model.param_template(c))
        per_step = 2 * (dip_per_forward(c) - head)
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        log(f"  {arch_name}: {cut}, d_model {c.d_model}, vocab {c.vocab_size} (padded {c.padded_vocab}), "
            f"{'tied head, ' if c.tie_embeddings else ''}{'fed embeddings, ' if c.frontend != 'none' else ''}"
            f"{per_step} DiP launches per step expected; allocated before the phase: {left:.2f} GiB")
        if left > 1.0:
            raise AssertionError(f"phase {phase}: the earlier phases left tensors on the card")
        result = {"layers": c.n_layers, "published_layers": base.n_layers}
        t_phase = time.perf_counter()

        # the first step: the launcher's weights from the seed and its first batch
        params = tf_model.init_params(c, make_generator(SEED, "cuda"), "cuda")
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(0).items()}
        drift = bool(c.ssm_state)
        f32_plain = None
        with uncounted():
            for cd in ("float32", "bfloat16"):
                ce_before = ce.lm_head_ce.launches
                first = first_step_against_plain(params, dataclasses.replace(c, compute_dtype=cd), batch, tree,
                                                 tf_model, replay=c.is_moe, keep=drift)
                ce_first = ce.lm_head_ce.launches - ce_before
                if cd == "float32":  # the fused loss's head: f32 x against the f32 head, one launch
                    log(f"  first step, f32 compute: {ce_first} lm_head_ce launch(es), f32 x f32 on the tensor cores "
                        f"({ce.F32_PRODUCTS} bf16 part products; lm_head_ce has no CUDA-core route)")
                    if ce_first < 1:
                        raise AssertionError(f"phase {phase}: the f32 first step launched no lm_head_ce")
                    result["first_step_float32_lm_head_ce_launches"] = ce_first
                (lk, lp), (nk, npl), (err, path) = first["losses"], first["norms"], first["worst"]
                mismatches, grads, leaf_rel = first["mismatches"], first.get("grads"), first["rel"]
                del first
                tl, tn, tg = FIRST_STEP_TOL[cd]
                direct = (abs(lk - lp) <= tl * max(1.0, abs(lp)), abs(nk - npl) <= tn * max(1.0, npl), err <= tg)
                row = {"loss": (lk, lp), "grad_norm": (nk, npl), "worst_leaf": (err, path),
                       "expert_id_mismatches_remat": mismatches, "within_tol": all(direct)}
                replayed = " (its routing replayed)" if c.is_moe else ""
                log(f"  first step, {cd} compute, kernels / plain PyTorch{replayed}: loss {lk:.6f} / {lp:.6f}, "
                    f"gradient norm {nk:.5f} / {npl:.5f}, worst leaf relative L2 error {err:.2e} ({path}); "
                    f"limits {tl:g}, {tn:g}, {tg:g}: {'within' if all(direct) else 'outside'}")
                if mismatches is not None:
                    log(f"  first step, {cd}: expert ids of the remat rerun that differ from the forward's, over "
                        f"{c.n_layers} MoE layers: {mismatches}")
                    if mismatches:
                        raise AssertionError(f"phase {phase}: the remat rerun routed differently from the forward")
                if cd == "float32":
                    if not all(direct):
                        raise AssertionError(f"phase {phase}: the first f32 step through the kernels differs from "
                                             f"plain PyTorch")
                    if drift:
                        f32_plain = (lp, npl, grads[1])
                elif drift:
                    # the kernels' projections with the unfused loss (bf16
                    # logits, as the plain run's): how far the fused loss
                    # alone moves the bf16 step from the f32 plain run
                    lu, gu = step_grads(params, dataclasses.replace(c, compute_dtype=cd), batch, tree, tf_model,
                                        fused_ce=False)
                    nu = grad_norm(gu)
                    l32, n32, g32 = f32_plain
                    row["kernels_unfused_loss"] = {"loss": lu, "grad_norm": nu, "f32_distance": {
                        "loss": abs(lu - l32), "grad_norm": abs(nu - n32),
                        "worst_leaf": max(rel_l2(a, b) for a, b in zip(gu, g32))}}
                    del gu
                    log(f"  first step, bf16, the kernels' projections with the unfused loss: loss {lu:.6f}, gradient "
                        f"norm {nu:.5f}; distance to the f32 plain run: loss {abs(lu - l32):.3e}, gradient norm "
                        f"{abs(nu - n32):.3e}, worst leaf relative L2 "
                        f"{row['kernels_unfused_loss']['f32_distance']['worst_leaf']:.3e}")
                if cd == "bfloat16" and not all(direct):
                    if not drift:
                        raise AssertionError(f"phase {phase}: the first bf16 step through the kernels differs from "
                                             f"plain PyTorch")
                    # each bound the bf16 step misses is held instead to the
                    # f32 plain run: the kernels' value (the loss, the norm,
                    # each leaf missing the leaf bound) may sit no further
                    # from it than F32_DRIFT x the bf16 plain run's
                    l32, n32, g32 = f32_plain
                    (dlk, dnk, dgk), (dlp, dnp, dgp) = (
                        (abs(lx - l32), abs(nx - n32), [rel_l2(a, b) for a, b in zip(gx, g32)])
                        for lx, nx, gx in ((lk, nk, grads[0]), (lp, npl, grads[1])))
                    missed = [nm for nm, ok in zip(("loss", "gradient norm", "leaves"), direct) if not ok]
                    bad = [path for (path, _), a, b, rel in zip(tree.paths(params), dgk, dgp, leaf_rel.values())
                           if rel > tg and a > F32_DRIFT * b]
                    ok = ((direct[0] or dlk <= F32_DRIFT * dlp) and (direct[1] or dnk <= F32_DRIFT * dnp)
                          and (direct[2] or not bad))
                    beyond = {path: (round(a, 5), round(b, 5)) for (path, _), a, b, rel in
                              zip(tree.paths(params), dgk, dgp, leaf_rel.values()) if rel > tg}
                    row["f32_distance"] = {"loss": (dlk, dlp), "grad_norm": (dnk, dnp),
                                           "leaves_beyond_tol_kernels_plain": beyond}
                    log(f"  first step, bf16: outside the bound in {missed}; distance to the f32 plain run, kernels / "
                        f"plain: loss {dlk:.3e} / {dlp:.3e}, gradient norm {dnk:.3e} / {dnp:.3e}, each leaf beyond "
                        f"{tg:g} against plain (relative L2, kernels / plain): {beyond}; limit {F32_DRIFT:g} x the plain "
                        f"run's: {'met' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"phase {phase}: the bf16 first step through the kernels drifts further "
                                             f"from f32 than plain PyTorch does ({bad or missed})")
                result[f"first_step_{cd}"] = row
                del grads
        del params, batch, f32_plain
        torch.cuda.empty_cache()
        result["first_step_checks_s"] = time.perf_counter() - t_phase

        # 4 steps through the launcher, a checkpoint at step 3
        ckdir = os.path.join(ckpt_root, arch_name)
        shutil.rmtree(ckdir, ignore_errors=True)
        argv = ["--arch", arch_name, "--full", "--steps", str(t_steps), "--batch", str(t_batch), "--seq", str(t_seq),
                "--lr", str(t_lr), "--seed", str(SEED), "--ckpt-dir", ckdir, "--ckpt-every", "3"]
        argv += ["--layers", str(layers)] if layers else []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = train_cli.main(argv)
        run_s = time.perf_counter() - t0
        launches = read_counts()
        peak = (torch.cuda.max_memory_allocated() / 2**30, torch.cuda.max_memory_reserved() / 2**30)
        metrics = out["metrics"]
        if len(metrics) != t_steps or not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
            raise AssertionError(f"phase {phase}: expected {t_steps} finite steps, got {metrics}")
        want = dict(dip_matmul=per_step * t_steps, dip_matmul_q=0, dip_systolic=0, flash_attention=0,
                    lm_head_ce=t_steps)
        log(f"  launches {launches}; expected {want}")
        if launches != want:
            raise AssertionError(f"phase {phase}: launch counts differ from the expected ones")
        state = out["state"]
        pads = {}
        for keys, w in padded_dips(state["params"]):
            pads["/".join(keys)] = [padding_nonzero(w)] + [padding_nonzero(at(state["opt_state"][m], keys))
                                                           for m in ("mu", "nu")]
        log(f"  nonzero padding elements after {t_steps} steps (parameter, mu, nu) of each padded DiP leaf: {pads}")
        if any(any(v) for v in pads.values()):
            raise AssertionError(f"phase {phase}: a DiP leaf's padding moved")
        n_params = sum(t.numel() for t in tree.leaves(state["params"]))
        step_s = statistics.median(m["step_time_s"] for m in metrics[1:])
        result.update(parameters=n_params, losses=[m["loss"] for m in metrics],
                      grad_norms=[m["grad_norm"] for m in metrics], step_times_s=[m["step_time_s"] for m in metrics],
                      median_step_s_steps_2_to_4=step_s, tokens_per_s=t_batch * t_seq / step_s,
                      peak_allocated_gib=peak[0], peak_reserved_gib=peak[1], run_s=run_s,
                      launches_per_step={k: v / t_steps for k, v in launches.items()}, padding_nonzero=pads)

        # one more step, split by CUDA events (loss forward, backward, AdamW)
        # and profiled: device time by kernel
        opt = AdamW(lr=cosine_schedule(t_lr, 10, t_steps))
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(t_steps).items()}
        leaves = [leaf.requires_grad_(True) for leaf in tree.leaves(state["params"])]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with uncounted(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                             torch.profiler.ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            loss = tf_model.loss_fn(state["params"], c, batch)
            ev[1].record()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            ev[2].record()
            grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(leaves, grads)]
            opt.update(tree.unflatten(state["params"], grads), state["opt_state"], state["params"])
            ev[3].record()
            torch.cuda.synchronize()
        split = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(("forward_ms", "backward_ms", "adamw_ms"))}
        kernel_ms = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                kernel_ms[e.key] = (e.count, (us if us is not None else e.self_cuda_time_total) / 1e3)
        device_ms = sum(v[1] for v in kernel_ms.values())
        top = sorted(kernel_ms.items(), key=lambda kv: -kv[1][1])[:10]
        result.update(profiled_step=dict(split, device_ms=device_ms,
                                         top_kernels=[(k[:90], n, ms) for k, (n, ms) in top]))
        log(f"  step {t_steps + 1} (profiled): " + json.dumps(split) + f"; device ms of all kernels {device_ms:.1f}")
        for key, (count, ms) in top:
            log(f"    {ms:9.2f} ms  x{count:<5d} {key[:110]}")
        del grads, loss, leaves, batch, prof, out, state, opt
        torch.cuda.empty_cache()

        if not resume:
            shutil.rmtree(ckdir, ignore_errors=True)
            result["phase_s"] = time.perf_counter() - t_phase
            log(f"  {phase} " + json.dumps({k: v for k, v in result.items() if k != "profiled_step"}) + f" ({gpu})")
            return result, launches

        # the run resumed from its step-3 checkpoint: step 4 again
        t0 = time.perf_counter()
        again = train_cli.main(argv)
        resume_s = time.perf_counter() - t0
        am = again["metrics"]
        if [int(m["step"]) for m in am] != [t_steps]:
            raise AssertionError(f"phase {phase}: the resumed run ran steps {[m['step'] for m in am]}")
        bit_exact = all(am[0][k] == metrics[-1][k] for k in ("loss", "grad_norm"))
        for k in ("loss", "grad_norm"):
            if abs(am[0][k] - metrics[-1][k]) > RESUME_TOL * max(1.0, abs(metrics[-1][k])):
                raise AssertionError(f"phase {phase}: resumed step {t_steps} {k} {am[0][k]} against {metrics[-1][k]}")
        result.update(resumed_step=dict(loss=am[0]["loss"], grad_norm=am[0]["grad_norm"], bit_exact=bit_exact,
                                        run_s=resume_s))
        log(f"  resumed from the step-3 checkpoint: step {t_steps} loss {am[0]['loss']:.7f} against "
            f"{metrics[-1]['loss']:.7f}, gradient norm {am[0]['grad_norm']:.6f} against {metrics[-1]['grad_norm']:.6f}; "
            f"bit-exact: {bit_exact} (run {resume_s:.1f} s with the restore)")
        del again
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        result["phase_s"] = time.perf_counter() - t_phase
        log(f"  {phase} " + json.dumps({k: v for k, v in result.items() if k != "profiled_step"}) + f" ({gpu})")
        return result, launches

    log("phase 6: llama3-8b full width cut to 2 layers (f32 params, bf16 compute, dip, block remat) "
        "through launch.train")
    c = dataclasses.replace(arch, n_layers=2, matmul_backend="dip")
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.resolved_head_dim, c.d_ff, c.vocab_size, c.padded_vocab) == (
        4096, 32, 8, 128, 14336, 128256, 129024)
    # the resume from a checkpoint is held once for the transformer stacks
    # (6c, the hybrid with its shared block's tree) and once for the pure SSM (6d)
    training, train_launches = train_family("6", "llama3-8b", c.n_layers, resume=False)
    data = SyntheticLM(vocab_size=c.vocab_size, seq_len=t_seq, global_batch=t_batch, seed=SEED)
    plain = dataclasses.replace(c, matmul_backend="torch")

    # the same 4 steps through plain PyTorch from the same weights: what the
    # configuration does under the launcher's schedule without any kernel
    opt = AdamW(lr=cosine_schedule(t_lr, 10, t_steps))
    params = tf_model.init_params(c, make_generator(SEED, "cuda"), "cuda")
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    step_fn = tf_model.train_step_fn(plain, opt, fused_ce=False)
    before = (dip_matmul.launches, flash_attention.launches, ce.lm_head_ce.launches)
    plain_metrics = []
    for i in range(t_steps):
        state, m = step_fn(state, {k: torch.as_tensor(v).to(dev) for k, v in data.batch(i).items()})
        plain_metrics.append({k: float(v) for k, v in m.items()})
    if (dip_matmul.launches, flash_attention.launches, ce.lm_head_ce.launches) != before:
        raise AssertionError("the plain PyTorch path launched a kernel")
    training["plain_losses"] = [m["loss"] for m in plain_metrics]
    training["plain_grad_norms"] = [m["grad_norm"] for m in plain_metrics]
    log(f"  the same steps through plain PyTorch (torch.matmul, unfused loss): losses "
        f"{training['plain_losses']}, gradient norms {training['plain_grad_norms']}; "
        f"through the kernels: {training['losses']}, {training['grad_norms']}")
    if not all(np.isfinite(m["loss"]) for m in plain_metrics):
        raise AssertionError("full-width training: the plain path gave a non-finite loss")
    del params, state, step_fn
    torch.cuda.empty_cache()

    # ------------------- 6b-6e. the families' training at full width -------
    family_training, family_launches = {}, {}
    for phase, arch_name, layers, resume, what in (
            ("6b", "deepseek-v2-lite-16b", 2, False, "MLA and 64 routed experts top-6 + 2 shared in every layer, "
                                                     "cut to 2 layers"),
            ("6c", "zamba2-2.7b", 6, True, "cut to 6 of its 54 Mamba2 layers, the shared attention+FFN block at "
                                           "1 of its 9 sites"),
            ("6d", "mamba2-370m", 24, True, "cut to 24 of its 48 Mamba2 layers, the tied head"),
            ("6e", "musicgen-medium", 6, False, "cut to 6 of its 48 dense layers, fed the pipeline's "
                                                 "embeddings")):
        log(f"phase {phase}: {arch_name} full width ({what}; f32 params, bf16 compute, dip, block remat) "
            f"through launch.train")
        family_training[arch_name], family_launches[arch_name] = train_family(phase, arch_name, layers, resume)
    log("phase 8c: guarded training: llama3-8b cut to 2 layers without a fault against phase 6, then mamba2-370m "
        "(24 of its 48 layers) with a NaN planted mid-run")
    reliability_out["training"] = reliability_training(training["losses"], training["grad_norms"])
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # --------------------------------------------------------- 7. times -----
    log("phase 7: times (ms, median of 10 after 3 warm-ups, L2 flushed before each; ms: device time, "
        "host_ms: with the host's launch time)")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=10, warmup=3, queued=True):
        return device_ms(fn, flush, iters, warmup, queued)

    def bound_ms(nbytes, flops, dt_name):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt_name]
        return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    def flash_bounds(nbytes, flops, dt_name, route):
        """A flash row's bound: bf16 products at the bf16 rate; f32 on the
        tensor cores at f32 accuracy is six bf16 part products of each
        product (ce.F32_PRODUCTS) at the bf16 rate, with the f32 CUDA-core
        bound beside it; f32 on the CUDA cores the f32 rate."""
        if dt_name == "float32" and route != "cuda_cores":
            f32_ms, f32_by = bound_ms(nbytes, flops, "float32")
            b_ms, b_by = bound_ms(nbytes, ce.F32_PRODUCTS * flops, "bfloat16")
            return dict(bound_ms=b_ms, bound_by=b_by, bound_ms_f32_cuda_cores=f32_ms, bound_by_f32_cuda_cores=f32_by)
        b_ms, b_by = bound_ms(nbytes, flops, dt_name)
        return dict(bound_ms=b_ms, bound_by=b_by)

    rows_out = []
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        isz = torch.finfo(dtype).bits // 8
        for m in (4, 256):
            for label, k, n, e, pr in (proj + ds_proj if dt_name == "bfloat16" else proj):
                x, p, eops, kw = dip_inputs(m, k, n, e, pr, dtype)
                s = epi.spec(e)
                nw = 2 if s.dual_weight else 1
                wn = [api.DipWeight(w, k, n).to_natural().contiguous() for w in (p,) + eops[:nw - 1]]
                gain = kw["prologue_operands"][0] if pr == "rmsnorm" else None

                def library():
                    xx = pro.apply("rmsnorm", x, gain) if gain is not None else x
                    z = torch.matmul(xx, wn[0])
                    if s.dual_weight:
                        return F.silu(z) * torch.matmul(xx, wn[1])
                    return z + eops[0] if s.residual else z

                nbytes = (m * k + nw * k * n + m * n * (2 if s.residual else 1)) * isz
                nbytes += (4 * (k + m) if gain is not None else 0)
                b_ms, b_by = bound_ms(nbytes, 2 * m * k * n * nw, dt_name)
                row = dict(kernel="dip_matmul", dtype=dt_name, shape=f"M={m} {label} K={k} N={n} {e}/{pr}",
                           plan=plan_label(m, n, k, e, dt_name).strip(" []"),
                           ms=time_ms(lambda: dip_matmul(x, p, *eops, **kw)),
                           host_ms=time_ms(lambda: dip_matmul(x, p, *eops, **kw), queued=False),
                           plain_ms=time_ms(lambda: dip_matmul_plain(x, p, *eops, **kw)),
                           library_ms=time_ms(library),
                           library_host_ms=time_ms(library, queued=False), bound_ms=b_ms, bound_by=b_by)
                rows_out.append(row)
                log("  " + json.dumps(row))
                if label == "gate+up":  # the ws baseline: the same kernel reading natural storage
                    ws_kw = dict(kw, fuse_deshear=False)
                    row = dict(row, kernel="ws_matmul", ms=time_ms(lambda: dip_matmul(x, p, *eops, **ws_kw)),
                               host_ms=time_ms(lambda: dip_matmul(x, p, *eops, **ws_kw), queued=False),
                               plain_ms=time_ms(lambda: dip_matmul_plain(x, p, *eops, **ws_kw)))
                    rows_out.append(row)
                    log("  " + json.dumps(row))
                del x, p, eops, wn
        for label, fsq, dk, dvv, qo, kvl in flash_cases:
            q, k, v = flash_inputs(fsq, dk, dvv, dtype)
            kw = dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=True)
            i = torch.arange(fsq, device=dev)
            live = torch.clamp(torch.minimum(kvl.view(-1, 1).long(), qo + i.view(1, -1) + 1), min=0).sum().item()
            # only the keys some query of the row can see must be read: those
            # below min(Sk, kv_len, q_offset + Sq)
            keys = torch.clamp(torch.clamp(kvl.long(), max=min(sk, qo + fsq)), min=0).sum().item()
            nbytes = (q.numel() + keys * (dk + dvv) + bh * fsq * dvv) * isz + 8 * bh
            mask = (torch.arange(sk, device=dev).view(1, 1, -1) < kvl.view(-1, 1, 1)) & (
                qo + i.view(1, -1, 1) >= torch.arange(sk, device=dev).view(1, 1, -1))
            q4, k4, v4, m4 = q[None], k[None], v[None], mask[None]
            pl = flash_plan(bh, fsq, sk, dk, dvv, dtype, sms)
            row = dict(kernel="flash_attention", dtype=dt_name,
                       shape=f"BH={bh} Sq={fsq} Sk={sk} D={dk} Dv={dvv} {label}", route=pl[0], splits=pl[2],
                       ms=time_ms(lambda: flash_attention(q, k, v, **kw)),
                       host_ms=time_ms(lambda: flash_attention(q, k, v, **kw), queued=False),
                       plain_ms=time_ms(lambda: attention_plain(q, k, v, **kw)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                           q4, k4, v4, attn_mask=m4, scale=dk ** -0.5)),
                       **flash_bounds(nbytes, 2 * live * (dk + dvv), dt_name, pl[0]))
            if pl[0] != "cuda_cores":  # the CUDA-core kernel, which ran these shapes before, in the same call
                row["cuda_cores_ms"] = time_ms(lambda: fa._launch(q, k, v, ("cuda_cores", 64, 1), scale=None, **kw))
            rows_out.append(row)
            log("  " + json.dumps(row))
            del q, k, v, mask

    # the SSM paths' projections (phases 5e, 5f) in bf16, as served, at M = 1
    # (the prefill tail), 4 (a decode step) and 256 (a prefill chunk): the
    # kernel at the storage width (10496 / 4416 for in_proj), the bound and
    # the library call at the logical width, the work the function needs;
    # and zamba2's shared attention at D = 80 on flash's CUDA-core route
    ssm_rows = []
    for m in (1, 4, 256):
        for label, k, n, e, pr in ssm_proj:
            ns = -(-n // 64) * 64
            x, p, eops, kw = dip_inputs(m, k, ns, e, pr, torch.bfloat16)
            s = epi.spec(e)
            nw = 2 if s.dual_weight else 1
            wn = [api.DipWeight(w, k, ns).to_natural()[:, :n].contiguous() for w in (p,) + eops[:nw - 1]]
            res = eops[0][:, :n].contiguous() if s.residual else None
            gain = kw["prologue_operands"][0] if pr == "rmsnorm" else None

            def library():
                xx = pro.apply("rmsnorm", x, gain) if gain is not None else x
                z = torch.matmul(xx, wn[0])
                if s.dual_weight:
                    return F.silu(z) * torch.matmul(xx, wn[1])
                return z + res if s.residual else z

            nbytes = (m * k + nw * k * n + m * n * (2 if s.residual else 1)) * 2 + (4 * (k + m) if gain is not None else 0)
            b_ms, b_by = bound_ms(nbytes, 2 * m * k * n * nw, "bfloat16")
            row = dict(kernel="dip_matmul", dtype="bfloat16", shape=f"M={m} {label} K={k} N={n} (storage {ns}) {e}/{pr}",
                       plan=plan_label(m, ns, k, e, "bfloat16").strip(" []"),
                       ms=time_ms(lambda: dip_matmul(x, p, *eops, **kw)),
                       host_ms=time_ms(lambda: dip_matmul(x, p, *eops, **kw), queued=False),
                       plain_ms=time_ms(lambda: dip_matmul_plain(x, p, *eops, **kw)),
                       library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
            rows_out.append(row)
            ssm_rows.append(row)
            log("  " + json.dumps(row))
            del x, p, eops, wn, res
    def flash_row(fsq, fd, qo, kvl, ms_of=None, dt_name="bfloat16", fdv=None):
        """A flash row at BH = 32, Sk = 1024, D = fd, Dv = fdv (fd): the
        planned launch (or ms_of's plan), its bound (only the keys some
        query of a row can see are read), the plain version and SDPA on the
        same mask; off the CUDA cores, the CUDA-core kernel beside it."""
        fdv, dtype = fdv or fd, getattr(torch, dt_name)
        q, k, v = flash_inputs(fsq, fd, fdv, dtype)
        kw = dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=True)
        i = torch.arange(fsq, device=dev)
        live = int(torch.clamp(torch.minimum(torch.tensor(kvl, device=dev), qo + i + 1), min=0).sum()) * bh
        keys = min(sk, kvl, qo + fsq) * bh
        nbytes = (q.numel() + keys * (fd + fdv) + bh * fsq * fdv) * q.element_size() + 8 * bh
        mask = (torch.arange(sk, device=dev).view(1, -1) < kvl) & (qo + i.view(-1, 1) >= torch.arange(sk, device=dev).view(1, -1))
        pl = flash_plan(bh, fsq, sk, fd, fdv, dtype, sms)
        row = dict(kernel="flash_attention", dtype=dt_name,
                   shape=f"BH={bh} Sq={fsq} Sk={sk} D={fd} Dv={fdv} q_offset {qo} kv_len {kvl}",
                   route=pl[0], splits=pl[2],
                   ms=time_ms(lambda: flash_attention(q, k, v, **kw)),
                   host_ms=time_ms(lambda: flash_attention(q, k, v, **kw), queued=False),
                   plain_ms=time_ms(lambda: attention_plain(q, k, v, **kw)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                                             attn_mask=mask[None, None],
                                                                             scale=fd ** -0.5)),
                   **flash_bounds(nbytes, 2 * live * (fd + fdv), dt_name, pl[0]))
        if pl[0] != "cuda_cores" and ms_of is None:  # the CUDA-core kernel, which ran these shapes before
            row["cuda_cores_ms"] = time_ms(lambda: fa._launch(q, k, v, ("cuda_cores", 64, 1), scale=None, **kw))
        if ms_of is not None:  # the same call on other plans (the threshold sweep below)
            row["ms_by_plan"] = {f"{p_[0]}/{p_[2]}": time_ms(lambda: fa._launch(q, k, v, p_, scale=None, **kw))
                                 for p_ in ms_of}
        del q, k, v, mask
        return row

    # zamba2's shared attention at D = 80 on its planned routes, and the
    # tail's shape at D = 128
    for zsq, qo, kvl in zb_flash:
        row = flash_row(zsq, 80, qo, kvl)
        rows_out.append(row)
        ssm_rows.append(row)
        log("  " + json.dumps(row))
    row = flash_row(1, 128, 700, 701)
    rows_out.append(row)
    log("  " + json.dumps(row))
    # f32 on the tensor cores: the reduced models' D = 32, Zamba2's 80, 128
    # and the MLA pair at the chunk (q_offset 512) and at one token against
    # the end of the cache, each beside the CUDA-core kernel that ran them
    # before (phase 7's flash_cases rows above hold D = 128 and (192, 128)
    # at the chunk in f32 as well)
    f32_flash_rows = []
    for fd, fdv in ((32, 32), (80, 80), (128, 128), (192, 128)):
        for fsq, qo, kvl in ((256, 512, 768), (1, 700, 701)):
            row = flash_row(fsq, fd, qo, kvl, dt_name="float32", fdv=fdv)
            rows_out.append(row)
            f32_flash_rows.append(row)
            log("  " + json.dumps(row))
    # where split_kv pays, and how many splits: every tensor-core head dim at
    # the end of the cache (q_offset = Sk - Sq, every key live), timed on the
    # unsplit 64-row tiles and on split_kv with 1 to 16 splits, beside SDPA;
    # SPLIT_MAX_SQ and split_count's one-wave rule are read off these rows
    sweep = []
    for fd in TC_HEAD_DIMS:
        for fsq in ((1, 2, 4, 8, 16, 32, 64, 128, 256) if fd in (80, 128) else (1, 16, 256)):
            plans = [("tensor_cores", 64, 1)] + [("split_kv", 16, n) for n in (1, 2, 4, 8, 16)]
            row = flash_row(fsq, fd, sk - fsq, sk, ms_of=plans)
            sweep.append(row)
            log("  sweep " + json.dumps(row))

    # lm_head_ce at the full-width training shape, in both training dtypes;
    # the work needed is the first vocab columns only (the rest are masked)
    t = 4 * (1024 - 1)
    for x_name, w_name in lm_pairs[:2]:
        x, w, labels = lm_inputs(t, x_name, w_name)
        x32 = x.float()
        nbytes = t * d * x.element_size() + d * lm_vocab * 4 + 4 * t + 8 * t
        f32_ms, f32_by = bound_ms(nbytes, 2 * t * d * lm_vocab, "float32")
        # the least time at f32 accuracy: bf16 x, three bf16 part products
        # of the head; f32 x, six of x and the head (fewer miss TOL, phase
        # 2), at the bf16 rate; the f32 CUDA-core bound stays beside it
        products = ce.F32_PRODUCTS if x_name == "float32" else ce.W_PARTS
        b_ms, b_by = bound_ms(nbytes, products * 2 * t * d * lm_vocab, "bfloat16")
        with torch.no_grad():
            row = dict(kernel="lm_head_ce", dtype=f"{x_name} x {w_name}",
                       shape=f"T={t} D={d} Vp={vocab} vocab={lm_vocab}",
                       ms=time_ms(lambda: ce.lm_head_ce(x, w, labels, vocab_size=lm_vocab), iters=5, warmup=1),
                       plain_ms=time_ms(lambda: ce.lm_head_ce_plain(x, w, labels, vocab_size=lm_vocab),
                                        iters=5, warmup=1),
                       library_ms=time_ms(lambda: torch.matmul(x32, w), iters=5, warmup=1),
                       library="torch.matmul of the same f32 product alone (no logsumexp)",
                       bound_ms=b_ms, bound_by=b_by)
            row.update(host_ms=time_ms(lambda: ce.lm_head_ce(x, w, labels, vocab_size=lm_vocab), iters=5,
                                       warmup=1, queued=False),
                       bound_ms_f32_cuda_cores=f32_ms, bound_by_f32_cuda_cores=f32_by)
            row.update({"f32_products": ce.F32_PRODUCTS} if x_name == "float32" else {"bf16_parts": ce.W_PARTS})
        rows_out.append(row)
        log("  " + json.dumps(row))
        if x_name == "bfloat16":  # the training step's backward of the fused loss, plain torch f32

            def fwd_bwd():
                xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
                logz, lab = ce.lm_head_ce(xx, ww, labels, vocab_size=lm_vocab)
                torch.autograd.grad(logz.sum() - lab.sum(), (xx, ww))

            both = time_ms(fwd_bwd, iters=5, warmup=1)
            log("  " + json.dumps(dict(kernel="lm_head_ce backward (chunked f32 recompute, torch)",
                                       dtype=row["dtype"], shape=row["shape"], forward_and_backward_ms=both,
                                       backward_ms=both - row["ms"])))
        del x, w, x32

    # lm_head_ce at the families' training heads (phases 6b-6e), bf16 x (bf16
    # compute) and f32 x (the f32 first step) against the f32 head, T = 4092;
    # bound as above, by three or six bf16 part products of the real
    # columns.  The tied head (Mamba2) is embed.t(), which the wrapper
    # copies contiguous before the launch: its ms include the copy, whose
    # time is given on its own too
    fam_ce_rows = []
    for (fname, fd, fvp, fvocab, tied), x_name in ((h, xn) for xn in ("bfloat16", "float32") for h in fam_heads):
        x, w, labels = fam_head_inputs(t, fd, fvp, fvocab, tied, getattr(torch, x_name))
        x32 = x.float()
        nbytes = t * fd * x.element_size() + fd * fvocab * 4 + 4 * t + 8 * t
        f32_ms, f32_by = bound_ms(nbytes, 2 * t * fd * fvocab, "float32")
        products = ce.F32_PRODUCTS if x_name == "float32" else ce.W_PARTS
        b_ms, b_by = bound_ms(nbytes, products * 2 * t * fd * fvocab, "bfloat16")
        with torch.no_grad():
            row = dict(kernel="lm_head_ce", dtype=f"{x_name} x float32",
                       shape=f"{fname} T={t} D={fd} Vp={fvp} vocab={fvocab}" + (" tied: embed.t()" if tied else ""),
                       ms=time_ms(lambda: ce.lm_head_ce(x, w, labels, vocab_size=fvocab), iters=5, warmup=1),
                       plain_ms=time_ms(lambda: ce.lm_head_ce_plain(x, w, labels, vocab_size=fvocab),
                                        iters=5, warmup=1),
                       library_ms=time_ms(lambda: torch.matmul(x32, w), iters=5, warmup=1),
                       library="torch.matmul of the same f32 product alone (no logsumexp)",
                       bound_ms=b_ms, bound_by=b_by, bound_ms_f32_cuda_cores=f32_ms, bound_by_f32_cuda_cores=f32_by,
                       launches_per_step=1)
            if tied:
                wc = w.contiguous()
                row.update(copy_ms=time_ms(lambda: w.contiguous(), iters=5, warmup=1), copy_bytes=2 * 4 * fd * fvp,
                           ms_without_copy=time_ms(lambda: ce.lm_head_ce(x, wc, labels, vocab_size=fvocab),
                                                   iters=5, warmup=1))
                del wc
        rows_out.append(row)
        fam_ce_rows.append(row)
        log("  " + json.dumps(row))
        del x, w, x32, labels

    # the quantized serving slice's kernels at the two launches that bound a
    # forward (gate+up, the widest projection, and the lm_head), M = 4 (a
    # decode step) and 256 (a prefill chunk): bf16 activations as served
    def int_mm(a, b):
        """torch._int_mm of the int8 operands (int32 accumulator only); it
        takes more than 16 rows, so a decode step's rows are zero-padded to
        32 (noted in the row)."""
        if a.shape[0] <= 16:
            a = F.pad(a, (0, 0, 0, 32 - a.shape[0]))
        return torch._int_mm(a, b)

    def int_mm_operand(b):
        """b as torch._int_mm takes it: as it is if a probe call accepts a
        row-major weight, else a column-major copy (made once, untimed)."""
        try:
            int_mm(torch.zeros(32, b.shape[0], dtype=torch.int8, device=dev), b)
            return b
        except RuntimeError:
            return b.t().contiguous().t()

    for m in (4, 256):
        for label, k, n, e, pr in (qproj[1], qproj[3]):
            s = epi.spec(e)
            nw = 2 if s.dual_weight else 1
            shape = f"M={m} {label} K={k} N={n} {e}/{pr}"
            pad_note = " (torch._int_mm rows zero-padded to 32)" if m <= 16 else ""
            kw = dict(epilogue=e, prologue=pr, prologue_operands=(
                (torch.rand(k, generator=g, device=dev) + 0.5,) if pr == "rmsnorm" else ()))
            gbytes = 4 * (k + m) if pr == "rmsnorm" else 0
            # dip_matmul on int8 (the repaired route): exact int32 sums
            xi, pi, ei = int8_operands(m, k, n, e)
            nat_i = [int_mm_operand(permute.unpermute_tiled(w, 64).contiguous()) for w in (pi,) + ei[:nw - 1]]
            b_ms, b_by = bound_ms(m * k + nw * k * n + 4 * m * n + (m * n if s.residual else 0),
                                  2 * m * k * n * nw, "int8")
            row = dict(kernel="dip_matmul", dtype="int8", shape=f"M={m} {label} K={k} N={n} {e}/none",
                       ms=time_ms(lambda: dip_matmul(xi, pi, *ei, epilogue=e)),
                       plain_ms=time_ms(lambda: dip_matmul_plain(xi, pi, *ei, epilogue=e)),
                       library_ms=time_ms(lambda: [int_mm(xi, w) for w in nat_i]),
                       library="torch._int_mm per weight" + pad_note, bound_ms=b_ms, bound_by=b_by)
            rows_out.append(row)
            log("  " + json.dumps(row))
            del xi, pi, ei, nat_i
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            for scheme in ("int8", "fp8_e4m3"):
                qws = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5, scheme)
                       for _ in range(nw)]
                eops = (qws[1].data, qws[1].scale) if s.dual_weight else ()
                if scheme == "int8":
                    xq, _ = quantize_acts_int8(pro.apply(pr, x, *kw["prologue_operands"]))
                    nat = [int_mm_operand(permute.unpermute_tiled(q.data, 64).contiguous()) for q in qws]
                    library = lambda: [int_mm(xq, w) for w in nat]  # noqa: E731
                    lib_name = "torch._int_mm of the int8 codes on natural storage, per weight" + pad_note
                    scales = [q.scale.reshape(1, -1).float() for q in qws]
                    col_major = [permute.unpermute_tiled(q.data, 64).t().contiguous().t() for q in qws]

                    def library_function():  # the kernel's whole function
                        codes, x_scale = quantize_acts_int8(pro.apply(pr, x, *kw["prologue_operands"]))
                        z = [int_mm(codes, w)[:m].float() * x_scale * sc for w, sc in zip(nat, scales)]
                        return (F.silu(z[0]) * z[1] if s.dual_weight else z[0]).to(x.dtype)
                else:
                    nat = [permute.unpermute_tiled(q.data, 64).to(torch.bfloat16).contiguous() for q in qws]
                    scales = [q.scale.reshape(1, -1).float() for q in qws]

                    def library():  # the kernel's whole function
                        xx = pro.apply(pr, x, *kw["prologue_operands"])
                        z = torch.matmul(xx, nat[0]) * scales[0]
                        return F.silu(z) * (torch.matmul(xx, nat[1]) * scales[1]) if s.dual_weight else z
                    lib_name = (("rmsnorm, " if pr == "rmsnorm" else "") + "torch.matmul by the bf16-upcast natural "
                                "weight, per-channel scales" + (", swiglu" if s.dual_weight else "")
                                + ": the kernel's whole function")
                b_ms, b_by = bound_ms(2 * m * k + nw * (k * n + 4 * n) + 2 * m * n + gbytes, 2 * m * k * n * nw,
                                      "int8" if scheme == "int8" else "bfloat16")
                row = dict(kernel="dip_matmul_q_int8" if scheme == "int8" else "dip_matmul_q_fp8",
                           dtype="bfloat16", shape=shape,
                           ms=time_ms(lambda: dip_matmul_q(x, qws[0].data, qws[0].scale, *eops, **kw)),
                           host_ms=time_ms(lambda: dip_matmul_q(x, qws[0].data, qws[0].scale, *eops, **kw),
                                           queued=False),
                           plain_ms=time_ms(lambda: dip_matmul_q_plain(x, qws[0].data, qws[0].scale, *eops, **kw)),
                           library_ms=time_ms(library), library=lib_name, bound_ms=b_ms, bound_by=b_by)
                if scheme == "int8":
                    # the whole function through library calls, and the same
                    # _int_mm with a column-major weight (the layout it runs
                    # fastest on; a copy made once, untimed)
                    row.update(library_function_ms=time_ms(library_function),
                               library_function=("rmsnorm, " if pr == "rmsnorm" else "") + "quantize_acts_int8, "
                               "torch._int_mm per weight, the scales" + (", swiglu" if s.dual_weight else "")
                               + ": the kernel's whole function" + pad_note,
                               library_ms_int_mm_column_major=time_ms(lambda: [int_mm(xq, w) for w in col_major]))
                    del col_major
                rows_out.append(row)
                log("  " + json.dumps(row))
                if pr == "rmsnorm":
                    # the same launch without the prologue: the kernel's own
                    # share, without the wrapper's inv_rms reduction (torch)
                    b_ms, b_by = bound_ms(2 * m * k + nw * (k * n + 4 * n) + 2 * m * n, 2 * m * k * n * nw,
                                          "int8" if scheme == "int8" else "bfloat16")
                    row = dict(row, shape=f"M={m} {label} K={k} N={n} {e}/none (prologue off)",
                               ms=time_ms(lambda: dip_matmul_q(x, qws[0].data, qws[0].scale, *eops, epilogue=e)),
                               host_ms=time_ms(lambda: dip_matmul_q(x, qws[0].data, qws[0].scale, *eops, epilogue=e),
                                               queued=False), bound_ms=b_ms, bound_by=b_by)
                    for key in ("plain_ms", "library_ms", "library", "library_function_ms", "library_function",
                                "library_ms_int_mm_column_major"):
                        row.pop(key, None)
                    rows_out.append(row)
                    log("  " + json.dumps(row))
                if scheme == "int8" and label == "gate+up":
                    # the quantizing pass alone: x read, codes and scales
                    # written (inv_rms and gain read); no one library call
                    # computes it
                    gain = kw["prologue_operands"][0] if pr == "rmsnorm" else None
                    inv = pro.inv_rms(x) if gain is not None else None
                    b_ms, b_by = bound_ms(3 * m * k + 4 * m + (4 * (k + m) if gain is not None else 0), 0, "int8")
                    qrow = dict(kernel="quantize_pass", dtype="bfloat16", shape=f"M={m} K={k} {pr}",
                                ms=time_ms(lambda: quantize_pass(x, inv, gain)),
                                host_ms=time_ms(lambda: quantize_pass(x, inv, gain), queued=False),
                                plain_ms=time_ms(lambda: quantize_pass_plain(x, inv, gain)),
                                library_ms=None, bound_ms=b_ms, bound_by=b_by)
                    rows_out.append(qrow)
                    log("  " + json.dumps(qrow))
                if scheme == "fp8_e4m3":
                    # the fp8 route with f32 x (the cast pass to bf16, then the
                    # e4m3 mainloops with an f32 output): f32 x read and f32
                    # out written, the products at the bf16 rate
                    x32 = x.float()
                    b_ms, b_by = bound_ms(4 * m * k + nw * (k * n + 4 * n) + 4 * m * n + gbytes, 2 * m * k * n * nw,
                                          "bfloat16")

                    def library_f32():  # the kernel's whole function on f32 x
                        xx = pro.apply(pr, x32, *kw["prologue_operands"]).to(torch.bfloat16)
                        z = torch.matmul(xx, nat[0]).float() * scales[0]
                        return F.silu(z) * (torch.matmul(xx, nat[1]).float() * scales[1]) if s.dual_weight else z

                    row = dict(kernel="dip_matmul_q_fp8", dtype="float32", shape=shape,
                               route=q_route(x32.dtype, qws[0].data.dtype),
                               ms=time_ms(lambda: dip_matmul_q(x32, qws[0].data, qws[0].scale, *eops, **kw)),
                               plain_ms=time_ms(lambda: dip_matmul_q_plain(x32, qws[0].data, qws[0].scale, *eops,
                                                                           **kw)),
                               library_ms=time_ms(library_f32),
                               library=(("rmsnorm, " if pr == "rmsnorm" else "") + "x cast to bf16, torch.matmul by "
                                        "the bf16-upcast natural weight, f32 per-channel scales"
                                        + (", swiglu" if s.dual_weight else "") + ": the kernel's whole function"),
                               bound_ms=b_ms, bound_by=b_by)
                    rows_out.append(row)
                    log("  " + json.dumps(row))
                    if label == "gate+up":
                        # the cast pass alone, with and without the prologue:
                        # f32 x read, bf16 written (inv_rms and gain read);
                        # without the prologue one library call computes it
                        for cpr in ("none", "rmsnorm"):
                            gain = kw["prologue_operands"][0] if cpr == "rmsnorm" else None
                            inv = pro.inv_rms(x32) if gain is not None else None
                            b_ms, b_by = bound_ms(6 * m * k + (4 * (k + m) if gain is not None else 0), 0, "float32")
                            crow = dict(kernel="cast_pass", dtype="float32", shape=f"M={m} K={k} {cpr}",
                                        ms=time_ms(lambda: cast_pass(x32, inv, gain)),
                                        host_ms=time_ms(lambda: cast_pass(x32, inv, gain), queued=False),
                                        plain_ms=time_ms(lambda: cast_pass_plain(x32, inv, gain)),
                                        library_ms=time_ms(lambda: x32.to(torch.bfloat16)) if gain is None else None,
                                        library="x.to(torch.bfloat16)" if gain is None else None,
                                        bound_ms=b_ms, bound_by=b_by)
                            rows_out.append(crow)
                            log("  " + json.dumps(crow))
                    del x32
                del qws, eops, nat
            # the wavefront on bf16 DiP storage
            x, p, eops, kw = dip_inputs(m, k, n, e, pr, torch.bfloat16)
            wn = [api.DipWeight(w, k, n).to_natural().contiguous() for w in (p,) + eops[:nw - 1]]
            gain = kw["prologue_operands"][0] if pr == "rmsnorm" else None

            def library():
                xx = pro.apply("rmsnorm", x, gain) if gain is not None else x
                z = torch.matmul(xx, wn[0])
                return F.silu(z) * torch.matmul(xx, wn[1]) if s.dual_weight else z

            b_ms, b_by = bound_ms(2 * (m * k + nw * k * n + m * n) + gbytes, 2 * m * k * n * nw, "bfloat16")
            # its own yardstick: the same bytes, the products at the f32
            # CUDA-core rate (the wavefront runs on the CUDA cores by design)
            f32_ms, f32_by = bound_ms(2 * (m * k + nw * k * n + m * n) + gbytes, 2 * m * k * n * nw, "float32")
            pl = systolic_plan(m, n, k, sms, s.dual_weight)
            row = dict(kernel="dip_systolic", dtype="bfloat16", shape=shape,
                       plan=f"{pl.regime} {pl.bm}x{pl.bn}, {pl.splits} split(s), {pl.blocks} blocks",
                       ms=time_ms(lambda: dip_systolic(x, p, *eops, **kw)),
                       host_ms=time_ms(lambda: dip_systolic(x, p, *eops, **kw), queued=False),
                       plain_ms=time_ms(lambda: dip_systolic_plain(x, p, *eops, **kw)),
                       library_ms=time_ms(library), library="torch.matmul (the same products)",
                       bound_ms=b_ms, bound_by=b_by, bound_ms_f32_cuda_cores=f32_ms, bound_by_f32_cuda_cores=f32_by)
            row["f32_core_share"] = 2 * m * k * n * nw / (row["ms"] * 1e-3) / PEAK_FLOPS["float32"]
            rows_out.append(row)
            log("  " + json.dumps(row))
            del x, p, eops, wn

    # the quantized families' projections (phases 5g, 5h; fp8 at full width
    # is held in phase 2 only), bf16 x as served: DeepSeek's at M = 4 and
    # 256, Zamba2's and Mamba2's also at M = 1 (the prefill tail).  The
    # kernel at the storage width (in_proj's padded last tile); the bound
    # and the library calls at the logical width: the weights read once
    # (one byte each and an f32 scale a column), x read and the output
    # written; the library call torch._int_mm of the int8 codes (int8) or
    # torch.matmul by the bf16-upcast weight and the scales (fp8), and for
    # int8 the whole function in library calls beside it.  Launches per
    # forward: how often the path's forward runs the projection
    per_fwd = {"deepseek wq": 27, "deepseek w_dkv": 27, "deepseek w_krope": 27, "deepseek wo": 27,
               "deepseek shared gate+up": 27, "deepseek shared down": 27, "deepseek lm_head": 1,
               "zamba2 in_proj": 54, "zamba2 out_proj": 54, "zamba2 wq": 27, "zamba2 wo": 9, "zamba2 gate+up": 9,
               "zamba2 down": 9, "zamba2 lm_head": 1, "mamba2 in_proj": 48, "mamba2 out_proj": 48}
    qfam_rows = []
    for label, k, n, e, pr in ds_proj + ssm_proj:
        s = epi.spec(e)
        nw = 2 if s.dual_weight else 1
        for scheme in ("int8", "fp8_e4m3"):
            qws = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5, scheme)
                   for _ in range(nw)]
            ns = qws[0].data.shape[1]
            eq = (qws[1].data, qws[1].scale) if s.dual_weight else ()
            scales = [q.scale[:, :n].float() for q in qws]
            if scheme == "int8":
                nat = [int_mm_operand(permute.unpermute_tiled(q.data, 64)[:, :n].contiguous()) for q in qws]
            else:
                nat = [permute.unpermute_tiled(q.data, 64)[:, :n].to(torch.bfloat16).contiguous() for q in qws]
            for m in ((4, 256) if label.startswith("deepseek") else (1, 4, 256)):
                x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
                gain = torch.rand(k, generator=g, device=dev) + 0.5 if pr == "rmsnorm" else None
                pops = () if gain is None else (gain,)
                res = (torch.randn(m, ns, generator=g, device=dev).to(torch.bfloat16),) if s.residual else ()
                kw = dict(epilogue=e, prologue=pr, prologue_operands=pops)
                pad_note = " (torch._int_mm rows zero-padded to 32)" if m <= 16 else ""

                def finish(z):  # the epilogue on the f32 products, one cast
                    out = F.silu(z[0]) * z[1] if s.dual_weight else z[0] + res[0][:, :n].float() if s.residual else z[0]
                    return out.to(torch.bfloat16)

                if scheme == "int8":
                    xq, _ = quantize_acts_int8(pro.apply(pr, x, *pops))
                    library = lambda: [int_mm(xq, w) for w in nat]  # noqa: E731
                    lib_name = "torch._int_mm of the int8 codes on natural storage, per weight" + pad_note

                    def library_function():  # the kernel's whole function
                        codes, x_scale = quantize_acts_int8(pro.apply(pr, x, *pops))
                        return finish([int_mm(codes, w)[:m].float() * x_scale * sc for w, sc in zip(nat, scales)])
                else:
                    def library():  # the kernel's whole function
                        xx = pro.apply(pr, x, *pops)
                        return finish([torch.matmul(xx, w).float() * sc for w, sc in zip(nat, scales)])
                    lib_name = (("rmsnorm, " if pr == "rmsnorm" else "") + "torch.matmul by the bf16-upcast natural "
                                "weight, per-channel scales, the epilogue: the kernel's whole function")
                nbytes = 2 * m * k + nw * (k * n + 4 * n) + 2 * m * n * (2 if s.residual else 1)
                nbytes += 4 * (k + m) if gain is not None else 0
                b_ms, b_by = bound_ms(nbytes, 2 * m * k * n * nw, "int8" if scheme == "int8" else "bfloat16")
                pl = matmul_plan(m, ns, k, s.dual_weight, sms, weight_bytes=1)
                row = dict(kernel="dip_matmul_q_int8" if scheme == "int8" else "dip_matmul_q_fp8", dtype="bfloat16",
                           shape=f"M={m} {label} K={k} N={n} (storage {ns}) {e}/{pr}",
                           plan=f"{pl.regime} {pl.bm}x{pl.bn}, {pl.splits} split(s), {pl.blocks} blocks",
                           launches_per_forward=per_fwd[label],
                           ms=time_ms(lambda: dip_matmul_q(x, qws[0].data, qws[0].scale, *eq, *res, **kw)),
                           plain_ms=time_ms(lambda: dip_matmul_q_plain(x, qws[0].data, qws[0].scale, *eq, *res, **kw)),
                           library_ms=time_ms(library), library=lib_name, bound_ms=b_ms, bound_by=b_by)
                if scheme == "int8":
                    row.update(library_function_ms=time_ms(library_function),
                               library_function=("rmsnorm, " if pr == "rmsnorm" else "") + "quantize_acts_int8, "
                               "torch._int_mm per weight, the scales, the epilogue: the kernel's whole function"
                               + pad_note)
                rows_out.append(row)
                qfam_rows.append(row)
                log("  " + json.dumps(row))
                del x, res
            del qws, nat, eq

    # no call can beat the least time the card needs for its work: a row
    # under its bound means a wrong bound or a wrong timing
    under = [f"{r['kernel']} {r['dtype']} {r['shape']}: {r['ms']:.4f} < {r['bound_ms']:.4f} ms"
             for r in rows_out if r["ms"] < r["bound_ms"]]
    if under:
        raise AssertionError("timed under the bound: " + "; ".join(under))

    # one line per kernel: the served dtype at the prefill chunk's largest
    # launch; lm_head_ce in the training dtypes (bf16 x, f32 head)
    pick = {"dip_matmul": ("bfloat16", "M=256 gate+up"), "flash_attention": ("bfloat16", "q_offset 512"),
            "lm_head_ce": ("bfloat16 x float32", "T=4092"), "dip_matmul_q_int8": ("bfloat16", "M=256 gate+up"),
            "quantize_pass": ("bfloat16", "M=256 K=4096 rmsnorm"), "cast_pass": ("float32", "M=256 K=4096 rmsnorm"),
            "dip_matmul_q_fp8": ("bfloat16", "M=256 gate+up"), "dip_systolic": ("bfloat16", "M=256 gate+up")}
    # the int8 route: its product on dip_matmul.cu's int8 mainloops, its
    # quantizing pass in dip_matmul_q.cu (the reference quantizes x outside
    # its kernel, src/repro/kernels/dip_matmul_q.py:177)
    q_src = ("src/repro_torch/kernels/csrc/dip_matmul.cu", "src/repro/kernels/dip_matmul_q.py:117")
    quant_src = ("src/repro_torch/kernels/csrc/dip_matmul_q.cu", "src/repro/kernels/dip_matmul_q.py:117")
    fp8_src = ("src/repro_torch/kernels/csrc/dip_matmul.cu", "src/repro/kernels/dip_matmul_q.py:117")
    sources = {"dip_matmul": ("src/repro_torch/kernels/csrc/dip_matmul.cu", "src/repro/kernels/dip_matmul.py:100"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:117"),
               "lm_head_ce": ("src/repro_torch/kernels/csrc/lm_head_ce.cu", "src/repro/kernels/lm_head_ce.py:102"),
               "dip_matmul_q_int8": q_src, "quantize_pass": quant_src, "cast_pass": quant_src,
               "dip_matmul_q_fp8": fp8_src,
               "dip_systolic": ("src/repro_torch/kernels/csrc/dip_systolic.cu",
                                "src/repro/kernels/dip_systolic.py:82")}
    # each kernel's launches on each main path, counted from 0 around it
    paths = {"serve": serve_launches, "train": train_launches, "serve_int8": qserve["int8"]["launches"],
             "serve_fp8": qserve["fp8_e4m3"]["launches"], "serve_systolic": launches_s,
             "serve_deepseek": launches_ds, "serve_zamba2": launches_zb, "serve_mamba2": launches_mb,
             "serve_deepseek_int8": launches_dsq, "serve_zamba2_int8": launches_zbq,
             "serve_mamba2_int8": launches_mbq}
    paths.update({f"train_{nm.split('-')[0]}": n for nm, n in family_launches.items()})
    paths["serve_fp8_f32_reduced"] = fp8_f32_path  # phase 3: fp8 weights in f32 compute, the cast pass each call
    routes_by_path["serve_fp8_f32_reduced"] = fp8_f32_routes  # its flash launches: the reduced head dim 32
    paths["deepseek_whole_prompt"] = ds_serving["whole_prompt_forward"]["launches"]
    paths["serve_reliability"] = reliability_out["serving"]["launches"]  # phase 8b, every drill's engine
    paths.update(sharded_out["launches"])  # phase 9c / 9d, both ranks' counters
    paths.update(ep_out["launches"])  # phase 9e (d) / (f), both ranks' counters
    paths.update(z_out["launches"])  # phases 9f / 9g / 9h, both ranks' counters
    for nm, n in reliability_out["training"]["launches"].items():  # phase 8c
        paths[f"train_guarded_{nm.split('-')[0]}"] = n
    paths["serve_int8"]["quantize_pass"] = qserve["int8"]["dip_matmul_q_quantizing_passes"]
    for pth, served in (("serve_deepseek_int8", dsq_serving), ("serve_zamba2_int8", zbq_serving),
                        ("serve_mamba2_int8", mbq_serving)):
        paths[pth]["quantize_pass"] = served["dip_matmul_q_quantizing_passes"]
    int8_paths = ("serve_int8", "serve_deepseek_int8", "serve_zamba2_int8", "serve_mamba2_int8",
                  "serve_reliability")  # phase 8b's int8 + int8 KV drill
    counter_of = {"dip_matmul_q_int8": "dip_matmul_q", "dip_matmul_q_fp8": "dip_matmul_q"}
    path_of = {"dip_matmul_q_int8": int8_paths, "dip_matmul_q_fp8": ("serve_fp8", "serve_fp8_f32_reduced"),
               "quantize_pass": int8_paths, "cast_pass": ("serve_fp8_f32_reduced",)}
    kernels = []
    for name in pick:
        row = next(r for r in rows_out if r["kernel"] == name and r["dtype"] == pick[name][0]
                   and pick[name][1] in r["shape"])
        counter = counter_of.get(name, name)
        by_path = {pth: paths[pth].get(counter, 0) for pth in path_of.get(name, paths)}
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": worst[name], "ms": row["ms"], "host_ms": row.get("host_ms"),
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": f"{pick[name][0]} {row['shape']}"})
        for key in ("bound_ms_f32_cuda_cores", "bf16_parts", "library_function_ms", "f32_core_share"):
            if key in row:
                kernels[-1][key] = row[key]
    # phase 9c: each launch shape of the tensor-parallel forward on rank 0's
    # storage, against its plain version; and the launches with f32 x (the
    # first-design route) by path
    dip_line = next(kk for kk in kernels if kk["name"] == "dip_matmul")
    dip_line["tp_shard_launches"] = []
    for h in sharded_out["9c"]["ranks"][0]["held_launches"]:
        dual = 2 if h["epilogue"] == "swiglu" else 1
        out_bytes = 4 if h["kind"] == "row" else 2
        b_ms, b_by = bound_ms(2 * (h["m"] * h["k"] + dual * h["k"] * h["n"]) + out_bytes * h["m"] * h["n"],
                              2 * dual * h["m"] * h["k"] * h["n"], "bfloat16")
        dip_line["tp_shard_launches"].append(
            {key: h[key] for key in ("launch", "kind", "m", "k", "n", "epilogue", "prologue", "out_dtype",
                                     "max_abs_err", "bound", "ms", "plain_ms", "library_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
    # phase 9e: each launch shape of the expert-parallel forward on rank 0's
    # storage (the row partial's f32 store; the plan-free shared experts)
    dip_line["ep_shard_launches"] = []
    for h in ep_out["e"]:
        dual = 2 if h["epilogue"] == "swiglu" else 1
        out_bytes = 4 if h["kind"] == "row" else 2
        b_ms, b_by = bound_ms(2 * (h["m"] * h["k"] + dual * h["k"] * h["n"]) + out_bytes * h["m"] * h["n"],
                              2 * dual * h["m"] * h["k"] * h["n"], "bfloat16")
        dip_line["ep_shard_launches"].append(
            {key: h[key] for key in ("launch", "kind", "m", "k", "n", "epilogue", "prologue", "out_dtype",
                                     "max_abs_err", "bound", "ms", "plain_ms", "library_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
    # phases 9f / 9g / 9j / 9i / 9k: each launch shape of the zamba2-2.7b
    # forward under tp and sp (rank 0's shards) and under fsdp (the gathered
    # storage), of llama3-8b's under sp and of DeepSeek-V2-Lite's under fsdp
    for held, key in ((z_out["9f"]["held"], "tp_zamba2_shard_launches"), (z_out["9g"]["held"], "fsdp_zamba2_launches"),
                      (z_out["9j"]["held"], "sp_zamba2_shard_launches"),
                      (sharded_out["9i"]["ranks"][0]["held_launches"], "sp_shard_launches"),
                      (ep_out["9k"]["held"], "fsdp_deepseek_launches")):
        dip_line[key] = []
        for h in held:
            dual = 2 if h["epilogue"] == "swiglu" else 1
            out_bytes = (4 if h["kind"] == "row" else 2) * (2 if h["epilogue"] == "residual" else 1)
            b_ms, b_by = bound_ms(2 * (h["m"] * h["k"] + dual * h["k"] * h["n"]) + out_bytes * h["m"] * h["n"],
                                  2 * dual * h["m"] * h["k"] * h["n"], "bfloat16")
            dip_line[key].append(
                {kk: h[kk] for kk in ("launch", "kind", "m", "k", "n", "epilogue", "prologue", "out_dtype",
                                      "max_abs_err", "bound", "ms", "plain_ms", "library_ms")}
                | {"bound_ms": b_ms, "bound_by": b_by})
    dip_line["launches_f32_x_by_path"] = {pth: v["dip_matmul_f32_x"] for pth, v in paths.items()
                                          if "dip_matmul_f32_x" in v}
    flash_line = next(kk for kk in kernels if kk["name"] == "flash_attention")
    routes_by_path["deepseek_whole_prompt"] = ds_serving["whole_prompt_forward"]["flash_routes"]
    flash_line["launches_by_route"] = {r: sum(v[r] for v in routes_by_path.values())
                                       for r in ("tensor_cores", "split_kv", "cuda_cores")}
    # DeepSeek-V2-Lite's MLA pair (D = 192, Dv = 128), bf16, on its planned
    # routes, beside the CUDA-core kernel on the same call
    flash_line["mla_pair_192_128"] = [
        {key: r[key] for key in ("shape", "route", "splits", "ms", "host_ms", "cuda_cores_ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by") if key in r}
        for r in rows_out
        if r["kernel"] == "flash_attention" and r["dtype"] == "bfloat16" and "D=192 Dv=128" in r["shape"]]
    # the SSM slice's shapes: each kernel's rows at them (phase 7 above)
    for kk in kernels:
        if kk["name"] in ("dip_matmul", "flash_attention"):
            kk["zamba2_mamba2_shapes"] = [
                {key: r[key] for key in ("shape", "route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
                 if key in r} for r in ssm_rows if r["kernel"] == kk["name"]]
    ce_line = next(kk for kk in kernels if kk["name"] == "lm_head_ce")
    ce_line["family_training_shapes"] = [
        {key: r[key] for key in ("dtype", "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                 "bound_ms_f32_cuda_cores", "copy_ms", "copy_bytes", "ms_without_copy",
                                 "launches_per_step") if key in r}
        for r in fam_ce_rows]
    # f32 x f32 at llama3-8b's head: six bf16 part products on the tensor
    # cores (the f32 first steps of phases 6-6e launch it)
    ce_line["f32_x"] = next({key: r[key] for key in ("shape", "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "bound_ms_f32_cuda_cores", "f32_products")}
                            for r in rows_out if r["kernel"] == "lm_head_ce" and r["dtype"] == "float32 x float32")
    # f32 flash on the tensor-core routes, each row beside the CUDA-core kernel
    flash_line["f32"] = [
        {key: r[key] for key in ("shape", "route", "splits", "ms", "cuda_cores_ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by", "bound_ms_f32_cuda_cores") if key in r}
        for r in rows_out if r["kernel"] == "flash_attention" and r["dtype"] == "float32"]
    flash_line["reduced_models"] = reduced_flash_routes  # phase 3: each variant's launches by route
    flash_line["route_of_timed_shape"] = next(r for r in rows_out if r["kernel"] == "flash_attention"
                                              and r["dtype"] == "bfloat16" and "q_offset 512" in r["shape"])["route"]
    for name, scheme in (("dip_matmul_q_fp8", "fp8_e4m3"), ("dip_matmul_q_int8", "int8")):
        line = next(kk for kk in kernels if kk["name"] == name)
        line["launches_tensor_cores"] = qserve[scheme]["dip_matmul_q_tensor_core_launches"] + (
            sum(sv["dip_matmul_q_tensor_core_launches"] for sv in (dsq_serving, zbq_serving, mbq_serving))
            if scheme == "int8" else 0)
        if name == "dip_matmul_q_fp8":  # f32 x: the cast pass, then the mainloops with an f32 output
            line["f32_x"] = [{key: r[key] for key in ("shape", "route", "ms", "plain_ms", "library_ms", "bound_ms",
                                                      "bound_by") if key in r}
                             for r in rows_out if r["kernel"] == name and r["dtype"] == "float32"]
            line["f32_x_max_abs_err"] = worst["dip_matmul_q_fp8_f32"]
        # the quantized families' shapes (phase 7 above)
        line["quantized_family_shapes"] = [
            {key: r[key] for key in ("shape", "plan", "launches_per_forward", "ms", "plain_ms", "library_ms",
                                     "library_function_ms", "bound_ms", "bound_by") if key in r}
            for r in qfam_rows if r["kernel"] == name]
    close_phase()
    log("wall seconds by phase " + json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
