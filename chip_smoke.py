"""Chip smoke test of the PyTorch / CUDA port (``paddle_ray_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device  -- the card, from ``nvidia-smi`` and torch; exits non-zero
   without CUDA.
2. build   -- builds every kernel source under
   ``paddle_ray_tpu_torch/ops/csrc/`` with ``nvcc`` (one process per
   source, all started together); then ``sass``: the flash kernels' and
   the paged kernel's ``HGMMA`` / ``HMMA`` counts in the libraries' SASS
   (``cuobjdump``) beside ptxas's registers and spills, failing if a bf16
   flash tensor-core kernel (forward, dq, dk/dv; dq at all four head dims)
   holds no ``HGMMA``, a float32 flash kernel holds one, or a paged kernel
   with bf16 q (over an int8 or a bf16 pool) holds no ``HMMA``, an
   ``int8_matmul`` kernel (the TMA and the masked path, either output
   type) holds no ``IGMMA`` (integer ``wgmma``) or a bf16
   ``int8_stream_matmul`` kernel no ``HMMA``, or a GroupNorm cluster
   kernel (forward and backward, float32 and bf16, with and without the
   modulation) holds no ``LDGSTS`` (16-byte ``cp.async``) or no split
   cluster barrier (``UCGABAR_ARV`` / ``UCGABAR_WAIT``), or any GroupNorm
   kernel touches local memory or spills, or a dropout kernel lacks the
   funnel shifts of its rotates (``SHF.L.W``), its 16-byte-vector variant
   16-byte loads and stores (``LDG.E.128`` / ``STG.E.128``), or any
   dropout kernel touches local memory or spills; the decode-attention,
   dropout-add-LN and both int8 matmuls' kernels' registers and spills are
   reported beside them.
3. kernel  -- the paged-attention kernel against its plain PyTorch
   version at the shapes the serving path gives it (float32
   ``atol=1e-4``, bfloat16 ``atol=2e-2`` and each row's ``max|err| /
   max|ref|`` ``PAGED_BF16_REL_TOL``, null page poisoned, pad rows 0), over
   pools in the model's dtype and int8 ones alike (page 32/64/128,
   head_dim 64/80/96/128, GQA 1/2/4, a long ragged decode of 1-8192 tokens
   over many splits with a dead slot, 128-wide mixed chunks, speculative
   verify steps of width 8 and 16: decode lanes of 5, 5, 3 and 1 rows
   beside a 16-row prefill lane and a dead slot), the lengths
   handed over on the host as the engine does; each timed with CUDA
   events beside its bound and one PyTorch library call on the same
   inputs, with the split plan the launch used.
4. flash_kernel -- the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions on the same inputs: the training shape
   (B 8, S 1024, H 16, D 64, bf16, causal), float32 causal and full, GQA,
   head_dim 128, and in bf16 gpt3-760m's attention (B 4, S 1024, H 16,
   D 96), gpt3-2.7b's (B 2, S 1024, H 32, D 80), GQA (Hkv 4) and a ragged
   S 320.  Forward within ``atol`` 1e-4 (float32) / 2e-2
   (bfloat16); gradients within ``max|err| / max|ref|`` 1e-4 / 2e-2.
   Timed beside the bound, the plain version and
   ``scaled_dot_product_attention``.  Then the modes BERT and the fused
   encoder run, non-causal at B 8, S 512, H 16, D 64, bf16: segment ids
   with padding, a ``[B, 1, 1, S]`` mask-bias read in place (its result
   equal to the materialised bias's), a full ``[B, H, S, S]`` bias with
   dbias from the dq kernel; and causal with segment ids that leave
   fourteen rows no visible key (each the mean of v over the keys below
   ``(r // 64 + 1) * 64``); each timed beside its bound and SDPA with the
   same mask.
5. decode_kernel -- the decode kernels against their plain versions:
   fused decode attention at B 8, h 16, d 64 over the 512-row cache of
   ``generate()`` (pos 0, 127, 255, 383; bfloat16, float32 and int8), at
   gpt3-760m's h 16, d 96 and gpt3-2.7b's h 32, d 80 (pos 255; bfloat16
   and int8), and one stream (B 1, h 16, d 64) at the end of a 2048-row
   cache (bfloat16 and int8), where the kernel splits each pair's rows;
   each case the same bits in two calls, with the split plan it used; and
   ``int8_stream_matmul`` at gpt3-350m's decode shapes (8 rows x 1024->3072,
   1024->1024, 1024->4096, 4096->1024, the 1024->50304 head), float32,
   N = 97, 1 and 128 rows, each the same bits in two calls with its split
   plan, float32 besides within ``STREAM_SPLIT_TOL`` of the plain
   split-and-merge at that plan; each timed beside its bound and one
   library call.
5b. int8_one_call -- the device kernels of one call under
   ``torch.profiler`` (counted between two marker kernels on the stream,
   see ``profiled``): ``int8_stream_matmul`` (gpt3-350m's qkv, bf16
   bias) its own kernel alone; a bf16 ``QuantizedLinear`` (1024->4096,
   bf16 bias, 8 x 512 rows) one ``int8_matmul`` kernel besides the
   per-tensor quantize, no bias or cast pass; run again after ``qat``.
6. serve   -- GPT-3 350m (bf16, random weights from seed 0) served by the
   port's ``ServingEngine`` through the 12-request mixed-length workload
   of ``bench.py:bench_serving``; every request must return its full
   budget, and the paged-attention kernel must have been launched once
   per layer per step.
7. check   -- two requests through an engine on a float32 copy of the
   weights, against greedy decoding by plain ``GPT.forward``.
8. serve_int8 -- the same workload with ``kv_cache_dtype="int8"``, every
   other request sampled (temperature 0.8, top_k 50, top_p 0.95, fixed
   seeds); full budgets, the int8 paged kernel launched once per layer per
   step.  Four sampled requests with 8-token prompts served by a fresh
   engine and in reverse order by another draw the same tokens; the
   workload's first four sampled requests resubmitted alone report the
   share of their tokens equal to the 12-request run's.
9. generate -- ``bench.py``'s two generation rows: gpt3-350m, batch 8,
   prompt 128, 256 new tokens, (a) bf16 ``generate()`` and (b)
   ``quantize_for_decode`` + ``kv_cache_dtype="int8"``; a 16-token warm-up
   and one timed call each, with launch counts per call, then a short
   call of each
   under ``torch.profiler``, where the int8 call's ``int8_stream_matmul``
   kernels must number its launches (one kernel a call, no second merging
   kernel).
10. generate_check -- 4-layer float32 models of GPT-3 350m's and
   gpt3-760m's widths (head dims 64 and 96): the kernels' greedy tokens
   against ``fused_attention=False`` (dense and int8 KV) and the paged
   layout against the dense one, equal up to a step where the reference's
   top-2 logit gap is below 1e-3, every kernel of the chain launched; and
   the threefry bits of 4,096 (seed, position) keys equal on the card and
   the CPU.
10b. serve_760m -- (after ``generate_check``) ``serve``'s workload on
   gpt3-760m at full width (24 layers, hidden 1536, 16 heads of 96; bf16,
   random weights from the seed) over a bf16 pool, page 64, greedy; the
   same fields as ``serve``, the paged kernel launched once per layer a
   step.
10c. check_760m -- a 4-layer float32 model of gpt3-760m's width: two
   requests served greedily against greedy ``generate()`` on each prompt,
   equal up to a step where the reference's top-2 logit gap is below
   1e-3, both kernels launched at head dim 96.
   The serving engine's other paths follow, on gpt3-350m at full width
   (bf16, random weights from the seed), each engine's paged kernel
   launched once a layer a step and no fault-free request ending other
   than ``OK``.  Where two runs' tokens are compared, they must be equal
   until they part, and they may part only at a near tie of the reference
   run: a new token whose top-2 gap in one teacher-forced ``GPT.forward``
   (its LM head in float32; perturbed by the request's keys if it
   samples) -- over an int8 pool, in one teacher-forced pass of
   ``paged_mixed_step`` through a fresh int8 pool, which sees the pool's
   quantization -- is below ``SERVE_TIE`` (bf16 logits move between step
   shapes; see there).
10d. serve_spec -- ``bench.py:bench_serving_spec``'s workload (8 prompts
   of 16 tokens, 128 new, ``max_batch`` 4, ``spec_k`` 4, n-gram drafts,
   token budget 148) with speculation off and on: decode tokens/s, steps,
   drafts, acceptance, steps shrunk; then a 4-layer float32 model, spec
   on, against greedy ``generate()`` up to ``CHECK_TIE``.
10e. serve_async -- ``serve``'s 12 requests with ``async_dispatch`` off and
   on over a bf16 pool, and over an int8 pool with every other request
   sampled: one ``_fetch`` a dispatched step, every ``_dispatch`` after
   the first under ``torch.cuda.set_sync_debug_mode("error")`` (a
   host-device sync in it fails the phase); decode tokens/s, p50 / p99,
   the wall time a step over 16 steps of steady decode and (bf16) the
   device's idle share: the device time a step of the next 16 steps under
   ``torch.profiler`` against that wall time.
10f. serve_prefix -- ``bench.py:bench_serving_prefix``'s workload (8
   requests of one 512-token prefix and 16-token suffixes, 16 new tokens,
   ``max_batch`` 4, the cache warmed by one request) with the prefix cache
   on and off: TTFT p50 / p99, prefill tokens/s, prefix hits (above 0 on).
10g. serve_lifecycle -- with ``sanitize=True``, sync and async: a
   mid-flight cancel, deadlines expiring a request mid-flight and one
   queued, ``stream=True`` queues equal to the drained output and ended by
   ``None``, preempt-and-restore under a pool that forces a priority-1
   request to preempt, ``park_all`` and resubmission with ``committed=``
   on a second engine; pagesan's drain check and a pool free but for the
   cache's pages after every drain.
10h. serve_chaos -- a seeded ``FaultPlan.random`` over sync, async and
   spec engines (every fault kind): requests ending ``OK`` equal to the
   fault-free run; ``max_step_failures`` consecutive dispatch faults
   drain with every live request ``FAILED``; a loop that stops scheduling
   raises ``EngineStallError``.
11. train  -- the training main path of ``bench.py``'s headline: GPT-3
   350m (bf16 parameters, flash attention, remat off, seq 1024, batch 8
   of ``(ids, ids)``), ``AdamW(1e-4)`` through ``build_train_step``, 2
   warm-up and 10 timed steps; every loss finite, the last below the
   first, each flash kernel launched 24 times a step; then one step under
   ``torch.profiler``.
12. train_check -- a 4-layer float32 model of GPT-3 350m's width (B 2,
   S 512) built twice from one set of weights, flash kernels against
   plain dense attention: step-1 gradients within ``max|err| / max|ref|``
   1e-3 per parameter, three ``AdamW(1e-4)`` losses within ``rtol`` 1e-3.
13. gn_kernel -- the fused GroupNorm forward and backward kernels against
   their plain versions on the same inputs (run after ``decode_kernel``):
   every (rows, C, mode) of the SD-UNet training step at batch 32 in
   bfloat16 (14 shapes; modes act none, act silu, scale+shift+silu), then
   ``GN_EXTRA_CASES``: float32 cases, an odd row count, group counts other
   than 32, and each route of ``group_norm_plan`` -- the cluster route at
   one and at 16 blocks a cluster, the rowwise route for C 36 (not a whole
   number of 16-byte vectors in bf16), for a slice past 16 blocks' shared
   memory and for a view 2 bytes into its buffer -- and large batches of
   one-row slices at 4 channels a group and four-row ones at 1 (group-sets
   of many groups).  Each case's line gives both kernels' plans and routes; each
   kernel runs twice and must give the same bits in every output.  The C
   entries must refuse a cluster plan with more groups a set than threads
   a block, and one whose shared memory is not the kernels' layout.
   Forward within ``atol`` 1e-4 (float32) / 2e-2 plus one bfloat16
   rounding (``rtol`` 2**-8; bfloat16); statistics within 1e-4; gradients
   within ``max|err| / max|ref|`` 1e-4 / 2e-2.  The step's cases timed
   beside the bound, the plain version and
   ``torch.nn.functional.group_norm``, and summed over the step's 56 calls.
14. unet_train -- ``bench.py:bench_unet``'s SD-UNet (base 320, mults
   1/2/4/4, attention at levels 2 and 3, 8 heads, 32 groups, bf16
   parameters, batch 32 of 64x64x4 latents, t in [0, 1000)) through
   ``build_train_step`` with ``AdamW(1e-4)``: 2 warm-up and 10 timed
   steps, every loss finite, the last below the first, each GroupNorm
   kernel launched 56 times a step; images/s, MFU from
   ``FlopCounterMode``'s forward count x 3, then one step under
   ``torch.profiler``.
15. unet_check -- a shallow float32 UNet of SD width (base 320, mults
   1/2, attention at level 1) on the card and as a copy on the CPU (the
   plain versions), TF32 off: forward within ``max|err| / max|ref|``
   1e-4, step-1 gradients within 1e-3 per parameter, three
   ``AdamW(1e-4)`` losses within ``rtol`` 1e-3.
16. dal_kernel -- the fused dropout-add-LayerNorm forward and backward
   kernels against their plain versions (run after ``gn_kernel``) at the
   fused encoder's shape ``[8 x 512, 1024]``: bfloat16 and float32, p 0.1
   and 0, training on and off, an odd row count, with and without the h
   output's cotangent; widths 768, 8192 and 1020 / 1022 (not a whole
   number of 16-byte vectors); the keep mask bit-identical to
   ``keep_mask_plain`` (h of x = 1, residual 0 is the scaled mask), the
   forward and the backward each the same bits in two calls.  y and h
   within ``atol`` 1e-4 (float32) / 2e-2 plus one bfloat16 rounding step
   (``rtol`` 2**-7), statistics within 1e-4, gradients within ``max|err|
   / max|ref|`` 1e-4 / 2e-2.  The encoder's case and the new widths timed beside the bound,
   the plain version and ``torch.nn.functional.layer_norm`` on h alone
   (and its autograd backward).
16b. dropout_kernel -- the threefry dropout kernel against its plain
   version (``dropout_plain``, JAX's threefry mask as tensor operations)
   bit for bit, forward, twice, and backward (the kernel on dy through
   autograd): the recipe's ``[8, 1024, 1024]`` bf16 at p 0.1, float32, p
   0.5, ``[3, 1000, 1001]`` (no whole number of 16-byte vectors) and a
   float32 view 4 bytes into its buffer (element loads); each timed beside
   its bound (``DROPOUT_INT_OPS`` int32 operations an element at
   ``INT32_OPS_PER_S``, or the bytes), the plain version and
   ``torch.nn.functional.dropout`` (the same work with PyTorch's Philox
   bits).
17. bert_train -- ``bench.py:bench_bert("bert-large", 512, 8, 10, {},
   zero_stage=0)``: BERT-large (bf16, flash), batch 8 of 512 random ids
   with ``mlm_labels = ids`` and NSP labels 0, ``AdamW(1e-4)`` through
   ``build_train_step``, 2 warm-up and 10 timed steps; every loss finite,
   the last below the first, each flash kernel launched 24 times a step;
   tokens/s, step ms, MFU by bench's ``6 N + 12 L H S`` over 989 TFLOP/s,
   peak memory; then one step under ``torch.profiler``.
18. bert_check -- BERT-large width in float32, 4 layers, batch 2 of 512
   padded to lengths 512 and 333 (segment ids on the flash path), on the
   card and as a copy on the CPU (the plain versions), TF32 off: MLM
   logits within ``max|err| / max|ref|`` 1e-4, step-1 gradients within
   1e-3 per parameter, three ``AdamW(1e-4)`` losses within ``rtol`` 1e-3.
19. encoder_train -- 24 ``FusedTransformerEncoderLayer(1024, 16, 4096,
   dropout_rate=0.1, activation="gelu", attn_dropout_rate=0.0,
   act_dropout_rate=0.0)`` (post-LN), bf16, batch 8 of 512 with a
   ``[8, 1, 1, 512]`` padding mask over lengths 288-512, an MSE loss
   against a seeded target, ``AdamW(1e-4)``, the key ``fold_in(PRNGKey(0),
   step)`` folded with the layer index: 2 warm-up and 10 timed steps,
   losses finite and falling, 48 launches each of the dropout-add-LN
   kernels and 24 of each flash kernel a step; tokens/s and one profiled
   step.
20. int8_mm_kernel -- the int8 matmul kernel (on the K-major weight, as
   ``QuantizedLinear`` keeps it) against ``int8_matmul_plain`` on random
   int8 values and positive scales, ``torch.equal`` and the same bits in
   two calls in every case: the fused encoder's four linears at M = 8 x
   512 (1024->3072, 1024->1024, 1024->4096, 4096->1024) and gpt3-350m's
   fc1 at 8192 rows, each timed beside its bound, the plain version and
   ``torch._int_mm`` followed by the two scale products (and
   ``torch._int_mm``'s int32 product alone); the four linears again in
   the ``QuantizedLinear`` form with a bfloat16 bias and a bfloat16 output
   (no x scale, the bias added before the cast), timed beside
   ``(torch._int_mm(xq, w).float() * w_scale + bias).to(bfloat16)``;
   bfloat16 output, the float32 ``QuantizedLinear`` form, ragged M = 4093,
   N = 97 or 1000, K = 1000 or 1040 (K 1000 and 5 x 37 x 3 take the
   masked path), each timed.
21. ptq_encoder -- ``encoder_train``'s 24-layer stack (same seed, bf16)
   in eval mode, batch 8 of 512 with the padding mask: one warm-up and 5
   timed forwards under ``torch.no_grad()`` in bf16, then
   ``PTQ(QuantConfig())`` and the same in int8 (ms, tokens/s, peak
   memory); per forward 96 ``int8_matmul`` launches (int8), 24 of the
   flash forward, 48 of the dropout-add-LN forward, no backward kernel;
   the int8 output's ``max|err| / max|ref|`` and cosine against the bf16
   one on the valid rows (reported, not gated); one profiled forward of
   each.
22. ptq_check -- a 4-layer float32 stack of that width, TF32 off, batch
   2 of 512 padded to 512 and 333, quantized on the card and as a CPU
   copy (plain versions): equal int8 weights, the first projection and a
   ``QuantizedLinear`` on one shared input equal bit for bit, the outputs
   within ``max|err| / max|ref|`` 0.05 -- the int8 error's own level: a
   last-bit difference that moves one tensor's largest activation moves
   its per-tensor scale (see the phase, which also reports the CPU
   stack's change under a 1e-7 relative input perturbation).
23. qat -- ``QAT().quantize`` on a 4-layer bf16 stack of that width, 5
   ``AdamW(1e-4)`` steps with ``encoder_train``'s loss and keys, losses
   finite and falling; ``QAT().convert`` and one eval forward with 16
   ``int8_matmul`` launches.
24. train_760m -- (run after ``train_check``) ``bench.py``'s gpt3-760m row:
   bf16, flash at head dim 96, remat off, batch 4 x 1024, ``AdamW(1e-4)``,
   2 warm-up and 3 timed steps; losses finite and falling, each flash
   kernel launched 24 times a step; tokens/s and MFU.
25. train_recipe -- (after ``train_760m``) GPT pretraining with the GPT-3
   paper's options (``RECIPE_CFG``): gpt3-350m at full width (bf16,
   flash), batch 8 x 1024 in two micro-batches (``grad_accum=2``), dropout
   0.1 under the key ``fold_in(PRNGKey(0), step)``, remat ``"dots"``,
   ``ce_chunk`` 256, ``AdamW(LinearWarmup(CosineAnnealingDecay(3e-4,
   10000, 3e-5), 2), beta2=0.95, weight_decay=0.1,
   grad_clip=ClipGradByGlobalNorm(1.0))``: 2 warm-up and 10 timed steps,
   losses finite and falling, the dropout kernel and the flash kernels
   launched as ``recipe_launches`` says (244 drops, 96 flash forwards, 48
   of each backward kernel a step); step ms, tokens/s, MFU by bench's
   count, peak memory; one more step under
   ``torch.cuda.set_sync_debug_mode("error")``, so any host-device sync in
   the step fails the phase; one profiled step.
26. train_seq8k -- ``bench.py``'s seq-8192 row (gpt3-350m, batch 1, remat
   ``"dots_attn"``) with the recipe's other options: the same checks and
   numbers (122 drops, 24 launches of each flash kernel a step).
27. train_recipe_check -- a 4-layer float32 model of gpt3-350m's width
   (flash, dropout 0.1, B 2, S 512) built from one set of weights: remat
   off, ``"none"``, ``"dots"`` and ``"dots_attn"`` losses and gradients
   within 1e-6, each policy's peak memory against remat off's;
   ``ce_chunk`` 256 against the full cross-entropy; without dropout,
   ``grad_accum`` 2 against one batch of the same four rows.

28. me_adamw_kernel -- the ``MemoryEfficientAdamW`` update kernel against
   its plain version (``me_adamw_plain``) on the card, 3 updates from the
   same state and gradients, ``torch.equal`` on the parameter, codes,
   scales, moments and master, and the same bits in a second run: every
   leaf shape of gpt3-1.3b (bf16 parameters, int8 moments, stochastic
   rounding; ``me_step_cases``: the kernel's vector path) and
   ``ME_EXTRA_CASES`` (1,000 elements, float32 parameters, bf16 and
   float32 moments, float32 masters of bf16 and float16 parameters, an L2
   decay; blocks of 100 and a parameter 2 bytes into its buffer, the
   general path); each timed (median of 20, L2
   flushed) beside its bound, the plain version and
   ``torch._fused_adamw_`` over float32 parameters and moments of the same
   size (a reference point: no PyTorch call computes this function); the
   sums over one step's 292 leaves (``me_adamw_step``).
29. train_1p3b -- ``bench.py``'s gpt3-1.3b row (24 layers, hidden 2048,
   16 heads of 128; bf16, flash, remat off, batch 7 x 1024,
   ``MemoryEfficientAdamW(1e-4, moment_dtype="int8")``): 2 warm-up and 10
   timed steps, losses finite and falling, 24 launches of each flash
   kernel and 292 of the update kernel a step; step ms, tokens/s, MFU,
   peak memory, the state's bytes; one more step under
   ``torch.cuda.set_sync_debug_mode("error")``; one profiled step with
   the update kernel's and each flash kernel's device ms and calls.
30. train_1p3b_offload -- the same with ``offload_opt_state=True``, 3
   steps under ``set_sync_debug_mode("error")``: every state tensor in
   pinned host memory, nothing of the state on the device but the
   staging buffers, the losses ``train_1p3b``'s first three bit for
   bit.
31. amp_train -- gpt3-350m with float32 parameters (flash, batch 4 x
   1024) under ``amp.auto_cast(dtype="bfloat16")`` (O1) with AdamW: the
   qkv projection's output bf16 (so the bf16 flash kernels run), each
   flash kernel launched once a layer, losses falling; then
   ``amp.decorate`` (O2) with float32 masters, the same.
32. optimizers_check -- a 4-layer float32 GPT of gpt3-350m's width
   (vocabulary 8192) on the card and a CPU copy of its parameters fed the
   card's gradients, TF32 off: 3 steps of SGD, Momentum (Nesterov), Lamb, Adamax, Adadelta,
   Adagrad, RMSProp, LARS and ``MemoryEfficientAdamW`` (the kernel on the
   card, its plain version on the CPU), each parameter within
   ``OPT_CHECK_TOL`` of the CPU's.
33. scaler_check -- a 4-layer bf16 GPT with ``MemoryEfficientAdamW`` and
   a ``GradScaler``: a step with an infinite loss leaves the parameters,
   every state tensor and the step count bit-equal and halves the scale;
   the next clean step updates.
34. train_resilient -- checkpointing and the resilient train loop:
   gpt3-350m at full width (bf16, flash, remat off, dropout 0.1 under the
   key ``fold_in(PRNGKey(0), step)``, batch 8 x 1024, ``AdamW(1e-4)``),
   8 steps of ``ResilientTrainLoop(save_interval_steps=2, commit_lag=1)``
   through ``RES_PLAN`` (a kill inside an overlapped write, so that the
   next life resumes from a checkpoint written in the background while a
   step updated the state in place, a loss-fetch failure, a save-IO
   failure and a preempt), each life on a train state built afresh,
   relaunched until the run completes: the curve assembled across the
   three lives equal to the uninterrupted one bit for bit, each flash
   kernel launched once a layer and the dropout kernel 98 times for every
   step the lives executed; the save-dispatch, commit-wait and restore
   ms, the checkpoint's bytes and directory (under the system temp
   directory), and the step ms with and without an overlapped write,
   beside the card's name and power limit.
35. train_resilient_check -- 4 layers at gpt3-1.3b's width (bf16, flash,
   dropout 0.1, batch 4 x 1024) with ``MemoryEfficientAdamW(1e-4,
   moment_dtype="int8")`` and its state offloaded to pinned host memory,
   one kill inside an overlapped write: the curve bit for bit, the update
   kernel launched once a parameter for every step executed.

Then the card's name and power limit (as ``nvidia-smi`` prints them), the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failure raises, so the script exits non-zero and prints no result.
Long logs (``nvcc -Xptxas -v``) go to ``chiprun_out/``.
"""
from __future__ import annotations

import copy
import gc
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # tensor cores, bf16
                  torch.float32: 67e12,     # CUDA cores, fp32
                  torch.int8: 1979e12}      # tensor cores, int8
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 paged attention, besides TOL: max|err| / max|ref| of every output
# row and head (``_row_rel_err``).  A long decode's outputs are averages over
# thousands of keys, as small as 0.015, so TOL alone could pass a wrong scale
# or a mis-weighted split.  The kernel's and the plain version's outputs,
# each rounded to bf16 once, may differ by one unit in the last place, at
# most 2^-7 (0.0078) of the row's largest value; the tensor cores' bf16 P
# moves the unrounded value far less than that
PAGED_BF16_REL_TOL = 1e-2
# int8_stream_matmul with float32 x against its plain split-and-merge twin
# at the kernel's own split plan, max|err| / max|ref|: the same runs of K
# summed in float32, so only summation order within a run and the final
# roundings differ (a few ulps of the largest output)
STREAM_SPLIT_TOL = 1e-6

MODEL = "gpt3-350m"
PAGE, MAX_BATCH, SEED = 64, 8, 0
# bench.py's headline training run: batch 8 of seq 1024, AdamW(1e-4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 1024, 1e-4
WARMUP_STEPS, TIMED_STEPS = 2, 10
# bench.py's gpt3-760m row: batch 4 of seq 1024, remat off
M760, M760_BATCH, M760_TIMED = "gpt3-760m", 4, 3
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# bench.py:bench_unet: the SD-UNet config, batch 32 of 64x64 latents
UNET_CFG = dict(in_channels=4, out_channels=4, base_channels=320,
                channel_mults=(1, 2, 4, 4), attn_levels=(2, 3), num_heads=8,
                groups=32, blocks_per_level=2, upsample="interp")
UNET_BATCH, UNET_IMG, UNET_LR = 32, 64, 1e-4
GN_KERNELS = ("fused_group_norm", "fused_group_norm_bwd")
# bench.py:bench_bert("bert-large", 512, 8, 10, {}, zero_stage=0)
BERT_MODEL, BERT_SEQ, BERT_BATCH, BERT_LR = "bert-large", 512, 8, 1e-4
# the fused encoder: 24 FusedTransformerEncoderLayer of BERT-large width
ENC_LAYERS, ENC_D, ENC_HEADS, ENC_FFN, ENC_RATE = 24, 1024, 16, 4096, 0.1
ENC_BATCH, ENC_SEQ, ENC_LR = 8, 512, 1e-4
ENC_LENGTHS = tuple(int(x) for x in np.linspace(288, 512, ENC_BATCH))
DAL_KERNELS = ("fused_dropout_add_layernorm",
               "fused_dropout_add_layernorm_bwd")
DAL_EPS, DAL_SEED = 1e-5, 12345
# dynamic-PTQ int8 inference of the fused encoder: its four linears at
# M = 8 x 512 rows, (name, K, N); four a layer, 96 a forward
ENC_LINEARS = (("qkv", ENC_D, 3 * ENC_D), ("out_proj", ENC_D, ENC_D),
               ("linear1", ENC_D, ENC_FFN), ("linear2", ENC_FFN, ENC_D))
PTQ_TIMED, QAT_LAYERS, QAT_STEPS = 5, 4, 5
# ptq_check: max|err| / max|ref| of the int8 stack on the card against its
# CPU copy, at the level of the int8 error itself (see phase_ptq_check)
PTQ_CHECK_TOL = 0.05
# GPT pretraining with the options of the GPT-3 paper (Brown et al. 2020,
# app. B): dropout 0.1, AdamW beta2 0.95, decoupled decay 0.1 (the JAX
# package's mask: tensors of rank 2 and up), global-norm clip 1.0, linear
# warm-up into a cosine decay to 10 % of gpt3-350m's peak lr 3e-4 -- the
# schedule's lengths cut to the run's 12 steps -- with remat "dots",
# chunked cross-entropy and two micro-batches a step
RECIPE_CFG = dict(dropout=0.1, remat=True, remat_policy="dots",
                  ce_chunk=256)
RECIPE_ACCUM = 2
RECIPE_LR, RECIPE_LR_MIN, RECIPE_WARMUP, RECIPE_DECAY = 3e-4, 3e-5, 2, 10000
# bench.py's seq-8192 row (gpt3-350m, batch 1, remat "dots_attn") with the
# recipe's other options
SEQ8K, SEQ8K_BATCH, SEQ8K_POLICY = 8192, 1, "dots_attn"
DROPOUT_KERNELS = ("threefry_dropout",)
# int32 operations of the dropout kernel an element: the threefry2x32 hash
# (2 key adds, 20 rounds of add, rotate and xor, 5 injections of 2 adds),
# the xor of its two words, the shift and the or of the float32 uniform
DROPOUT_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1 + 2
# the H100 SXM's int32 rate: 64 INT32 lanes an SM (NVIDIA's Hopper
# architecture white paper) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# bench.py's gpt3-1.3b row: bench_gpt("gpt3-1.3b", 1024, 7, 10,
# remat="off", opt_name="me-int8"), MemoryEfficientAdamW(1e-4, int8)
M1P3B, M1P3B_BATCH, M1P3B_LR, M1P3B_OFFLOAD_STEPS = "gpt3-1.3b", 7, 1e-4, 3
ME_KERNELS = ("me_adamw",)
# amp_train: gpt3-350m in float32 under auto_cast, batch 4 x 1024
AMP_BATCH, AMP_STEPS = 4, 4
# optimizers_check: the parameters after 3 steps on the card against a CPU
# copy fed the same gradients, max|err| / max|ref| a tensor: both run the
# JAX order one float32 operation at a time, but PyTorch's CPU sqrt may be
# an ulp off the correctly rounded one, and Lamb's and LARS's norms sum in
# other orders
OPT_CHECK_TOL = 1e-5
OPT_CHECK_VOCAB = 8192


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - _START, 1)}),
          flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, flush="zero") -> float:
    """Median CUDA-event time of ``fn`` (ms) on the device, with the 50 MB
    L2 flushed before every timed launch: the serving path reads each
    layer's pages cold.  A device-side sleep longer than the host's
    enqueue of ``fn`` sits before the start event, so the events bracket
    the device work alone and not the Python around it (a kernel of a few
    microseconds would otherwise time its wrapper).  ``flush`` is
    ``"zero"`` (64 MB of zeros written, the L2 left full of dirty lines),
    another callable run in its place, or None (no flush)."""
    if flush == "zero":
        flush = torch.empty(64 << 20, dtype=torch.uint8,
                            device="cuda").zero_
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # at most 1.98 GHz on an H100 SXM: this many cycles last 2x the enqueue
    sleep_cycles = int(2 * max(host_s, 50e-6) * 1.98e9)
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# idle seconds on each side of a profiled call (see ``profiled``)
PROFILE_GAP_S = 0.2
# the kernel ``torch.cuda._sleep`` launches: ``profiled`` puts one on the
# stream on each side of the measured call, of this many cycles
MARKER, MARKER_CYCLES = "spin_kernel", 1000
# profiles ``profiled`` takes at most before it gives up on the markers
PROFILE_ATTEMPTS = 3


def profiled(fn, on_active=None):
    """``torch.profiler`` over one call of ``fn`` (CPU and CUDA activity),
    after a warm-up call under the profiler that it discards, with a
    marker kernel on the stream on each side of the measured call and the
    device idle for ``PROFILE_GAP_S`` before and after it.  The measured
    call's device kernels are those that ran between the two markers
    (:func:`marked_rows`): stream order, not the profiler's window, sets
    them apart from the warm-up call's.  The profiler keeps the device
    kernels that fall inside its window by their timestamps, and late in a
    long run of this script on an NVIDIA H100 it dropped a window's first
    kernels or all of a short one, or took in the warm-up call's last
    ones: a profile that lacks a marker is taken again,
    ``PROFILE_ATTEMPTS`` times at most.  ``on_active`` runs just before the measured call.  Returns
    ``(prof, rows, attempts)``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for active in (False, True):
                if active:
                    time.sleep(PROFILE_GAP_S)
                    if on_active is not None:
                        on_active()
                    torch.cuda._sleep(MARKER_CYCLES)
                fn()
                if active:
                    torch.cuda._sleep(MARKER_CYCLES)
                torch.cuda.synchronize()
                time.sleep(PROFILE_GAP_S)
                prof.step()
        rows = marked_rows(prof)
        if rows is not None:
            return prof, rows, attempt
    raise AssertionError(f"torch.profiler kept both marker kernels in none "
                         f"of {PROFILE_ATTEMPTS} profiles")


def marked_rows(prof):
    """(name, device us, calls) of the device kernels that ran between the
    two marker kernels of a :func:`profiled` call, or None if the profile
    does not hold exactly two markers."""
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("ProfilerStep")),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(dev) if MARKER in e.name]
    if len(marks) != 2:
        return None
    rows = {}
    for e in dev[marks[0] + 1:marks[1]]:
        t, c = rows.get(e.name, (0.0, 0))
        rows[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    return [(k, t, c) for k, (t, c) in rows.items()]


def kernel_rows(prof):
    """(name, device us, calls) of the device-side kernel events of a
    ``torch.profiler`` run only: the CPU op rows repeat their kernels'
    device time, and the user-annotation rows (``torch.optim``'s
    ``Optimizer.step#...``) span it."""
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def annotation_spans(prof):
    """(name, us) of the user-annotated ranges on the device timeline:
    from the first kernel launched inside the range to the end of the
    last, gaps included."""
    return [(e.key, e.device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "is_user_annotation", False)]


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _row_rel_err(got, want) -> float:
    """The largest ``max|err| / max|ref|`` over the vectors of the last
    axis whose reference is not all zero."""
    err = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    live = ref > 0
    return float((err[live] / ref[live]).max()) if bool(live.any()) else 0.0


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # float32 products in full float32, as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from paddle_ray_tpu_torch.ops import _build
    csrc = os.path.join(HERE, "paddle_ray_tpu_torch", "ops", "csrc")
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build_all(names)
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, log in logs.items():
        with open(os.path.join(OUT_DIR, f"nvcc_{name}.log"), "w") as f:
            f.write(log)
    spills = sorted({line.strip() for log in logs.values()
                     for line in log.splitlines()
                     if "spill" in line and not line.strip().startswith(
                         "0 bytes spill")})
    emit("build", kernels=names, seconds=round(build_s, 3),
         spill_lines=spills)
    _sass_check(logs)


_KERNEL_NAME = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_tc)?_kernel)"
                          r"I(f|13__nv_bfloat16)?Li(\d+)ELb([01])E")
# paged_kernel<T, KV, D, PAGE>: KV int8 (``a``), float, or T again (a
# substitution, ``S..._``)
_PAGED_NAME = re.compile(r"(paged_kernel)I(f|13__nv_bfloat16)(a|f|S\d*_)"
                         r"Li(\d+)ELi(\d+)E")


def _flash_short(mangled):
    m = _KERNEL_NAME.search(mangled)
    if m is None:
        return None
    base, t, d, extras = m.groups()
    return f"{base}<{'float' if t == 'f' else 'bf16'},{d},{extras}>"


def _paged_short(mangled):
    m = _PAGED_NAME.search(mangled)
    if m is None:
        return None
    base, t, kv, d, page = m.groups()
    t = "float" if t == "f" else "bf16"
    kv = {"a": "int8", "f": "float"}.get(kv, t)
    return f"{base}<{t},{kv},{d},{page}>"


# fused decode attention's and the dropout-add-LN kernels' instantiations,
# by their mangled names
_ROW_NAME = re.compile(r"(fused_decode_attention_kernel|dal_fwd_kernel|"
                       r"dal_bwd_kernel)I\w+")


def _row_short(mangled):
    m = _ROW_NAME.search(mangled)
    return m.group(0) if m else None


# int8_matmul_kernel<kTma, T> and int8_stream_matmul_kernel<T, kVec>
_INT8_NAME = re.compile(r"int8_matmul_kernelILb([01])E(f|13__nv_bfloat16)E")
_STREAM_NAME = re.compile(r"int8_stream_matmul_kernelI(f|13__nv_bfloat16)Lb([01])EE")


# the GroupNorm kernels: gn_{fwd,bwd}_cluster_kernel<T[, MOD]> (the cluster
# route), gn_{fwd,bwd}_kernel<T> and gn_bwd_reduce_kernel (the rowwise route
# and the reduction over N)
_GN_NAME = re.compile(r"(gn_(?:fwd|bwd)(?:_cluster)?_kernel)I(f|13__nv_bfloat16)"
                      r"(?:Lb([01])E)?|gn_bwd_reduce_kernel")
# what the cluster kernels' SASS must hold: 16-byte asynchronous copies
# (cp.async), the split cluster barrier; and what none may: local memory
GN_SASS_OPCODES = ("LDGSTS", "UCGABAR_ARV", "UCGABAR_WAIT", "LDL", "STL")


def _gn_short(mangled):
    m = _GN_NAME.search(mangled)
    if m is None:
        return None
    if m.group(1) is None:
        return "gn_bwd_reduce_kernel"
    base, t, mod = m.groups()
    t = "float" if t == "f" else "bf16"
    return f"{base}<{t}{'' if mod is None else ',mod' if mod == '1' else ''}>"


# dropout_kernel<T, VEC>: what it must hold -- the rotates as funnel shifts,
# and with VEC 16-byte loads and stores -- and what it may not: local memory
_DROPOUT_NAME = re.compile(r"dropout_kernelI(f|13__nv_bfloat16)Lb([01])E")
DROPOUT_SASS_OPCODES = ("SHF.L.W", "LDG.E.128", "STG.E.128", "LDL", "STL")


def _dropout_short(mangled):
    m = _DROPOUT_NAME.search(mangled)
    if m is None:
        return None
    t, vec = m.groups()
    return (f"dropout_kernel<{'float' if t == 'f' else 'bf16'},"
            f"{'vec' if vec == '1' else 'element'}>")


def _dropout_sass_check(kernels: dict) -> None:
    """The four dropout kernels each rotate by funnel shifts (at least the
    hash's 20 a counter), touch no local memory and spill nothing; the
    16-byte-vector ones load and store 16 bytes at a time."""
    bad = [n for n, k in kernels.items()
           if k.get("SHF.L.W", 0) < 20 or k.get("LDL") or k.get("STL")
           or k.get("spill_store_bytes") or k.get("spill_load_bytes")
           or ("vec" in n and not (k.get("LDG.E.128")
                                   and k.get("STG.E.128")))]
    if len(kernels) != 4 or bad:
        raise AssertionError(f"dropout SASS: kernels {sorted(kernels)}; "
                             f"failing {bad}: {kernels}")


def _int8_short(mangled):
    m = _INT8_NAME.search(mangled)
    if m:
        tma, t = m.groups()
        return (f"int8_matmul_kernel<{'tma' if tma == '1' else 'masked'},"
                f"{'float' if t == 'f' else 'bf16'}>")
    m = _STREAM_NAME.search(mangled)
    if m:
        t, vec = m.groups()
        return (f"int8_stream_matmul_kernel<{'float' if t == 'f' else 'bf16'},"
                f"{'vec' if vec == '1' else 'masked'}>")
    return None


def _sass_counts(library, log, short, out_name, opcodes=()) -> dict:
    """Each kernel's tensor-core instructions in the built library's SASS
    (``cuobjdump --dump-sass``: ``HGMMA`` is wgmma, ``IGMMA`` integer wgmma,
    ``HMMA`` mma.sync), the lines holding each of ``opcodes`` and
    its instruction count, beside ptxas's registers and spills from the
    build log (which holds them only when the library was built in this
    run); the MMA lines (and those of ``opcodes``) go to
    ``OUT_DIR/<out_name>``.  None without ``cuobjdump``."""
    from paddle_ray_tpu_torch.ops import _build
    kernels = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and short(line):
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 1])
            loads = re.search(r"(\d+) bytes spill loads", lines[i + 1])
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            kernels[short(line)] = {
                "spill_store_bytes": int(spill.group(1)) if spill else None,
                "spill_load_bytes": int(loads.group(1)) if loads else None,
                "registers": int(regs.group(1)) if regs else None}
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        emit("sass", library=library, cuobjdump=None, kernels=kernels)
        return None
    sass = subprocess.run([tool, "--dump-sass", _build._target(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    name, kept = None, []
    for line in sass.splitlines():
        if "Function :" in line:
            name = short(line.split("Function :")[1].strip())
            if name:
                kernels.setdefault(name, {}).update(
                    hgmma=0, igmma=0, hmma=0, instructions=0,
                    **{op: 0 for op in opcodes})
                kept.append(line)
        elif name and line.lstrip().startswith("/*") and ";" in line:
            kernels[name]["instructions"] += 1
            found = [op for op in opcodes if op in line]
            for op in found:
                kernels[name][op] += 1
            if found and "MMA" not in line:
                kept.append(line)
            if "MMA" in line:
                kernels[name]["hgmma"] += "HGMMA" in line
                kernels[name]["igmma"] += "IGMMA" in line
                kernels[name]["hmma"] += "HMMA" in line
                kept.append(line)
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write("\n".join(kept) + "\n")
    emit("sass", library=library, cuobjdump=tool, kernels=kernels)
    return kernels


def _sass_check(logs: dict) -> None:
    """The flash kernels', the paged kernel's and the int8 matmuls' SASS.
    Fails if a bf16 flash tensor-core kernel (the forward, dq and dk/dv)
    holds no ``HGMMA`` or a float32 flash kernel holds one, if any of the
    four head dims lacks a bf16 dq tensor-core kernel, if a paged kernel
    with bf16 q (over an int8 or a bf16 pool) holds no ``HMMA`` (its
    prefill tiles' ``mma.sync``), if an ``int8_matmul`` kernel (TMA or
    masked path, float32 or bf16 output) holds no ``IGMMA``, if an
    ``int8_stream_matmul`` kernel for bf16 x holds no ``HMMA``, or if the
    GroupNorm kernels fail ``_gn_sass_check`` or the dropout kernels
    ``_dropout_sass_check``."""
    kernels = _sass_counts("flash_attention", logs["flash_attention"],
                           _flash_short, "sass_flash_mma.txt")
    paged = _sass_counts("paged_attention", logs["paged_attention"],
                         _paged_short, "sass_paged_mma.txt")
    for library in ("decode_attention", "fused"):
        _sass_counts(library, logs[library], _row_short,
                     f"sass_{library}_mma.txt")
    int8 = {library: _sass_counts(library, logs[library], _int8_short,
                                  f"sass_{library}_mma.txt")
            for library in ("int8_matmul", "decode_matmul")}
    gn = _sass_counts("groupnorm", logs["groupnorm"], _gn_short,
                      "sass_groupnorm.txt", GN_SASS_OPCODES)
    if gn is not None:
        _gn_sass_check(gn)
    drop = _sass_counts("dropout", logs["dropout"], _dropout_short,
                        "sass_dropout.txt", DROPOUT_SASS_OPCODES)
    if drop is not None:
        _dropout_sass_check(drop)
    if kernels is None or paged is None or None in int8.values():
        return
    tc = [n for n in kernels if "_tc_kernel" in n]
    without = [n for n in tc if not kernels[n].get("hgmma")]
    f32_with = [n for n in kernels
                if "<float," in n and kernels[n].get("hgmma")]
    dq_dims = {n.split(",")[1] for n in tc if "bwd_dq_tc" in n}
    if without or f32_with or dq_dims != {"64", "80", "96", "128"}:
        raise AssertionError(
            f"flash SASS: tensor-core kernels without HGMMA {without}, "
            f"float32 kernels with HGMMA {f32_with}, bf16 dq tensor-core "
            f"head dims {sorted(dq_dims)}")
    no_hmma = [n for n, k in paged.items()
               if "<bf16," in n and not k.get("hmma")]
    kinds = {n.split(",")[1] for n in paged if "<bf16," in n}
    if no_hmma or kinds != {"int8", "bf16"}:
        raise AssertionError(f"paged kernels with bf16 q without HMMA in "
                             f"their SASS: {no_hmma}; pools with bf16 q "
                             f"found: {sorted(kinds)}")
    mm, stream = int8["int8_matmul"], int8["decode_matmul"]
    no_igmma = [n for n, k in mm.items() if not k.get("igmma")]
    no_hmma = [n for n, k in stream.items()
               if "<bf16," in n and not k.get("hmma")]
    if no_igmma or len(mm) != 4 or no_hmma or len(stream) != 4:
        raise AssertionError(
            f"int8 SASS: int8_matmul kernels without IGMMA {no_igmma} (of "
            f"{sorted(mm)}), bf16 int8_stream_matmul kernels without HMMA "
            f"{no_hmma} (of {sorted(stream)})")


def _gn_sass_check(gn: dict) -> None:
    """The GroupNorm cluster kernels (forward and backward, float32 and
    bf16, the backward with and without modulation: six) each hold
    ``LDGSTS`` (16-byte ``cp.async``) and the split cluster barrier
    (``UCGABAR_ARV``, ``UCGABAR_WAIT``); no GroupNorm kernel touches local
    memory (``LDL`` / ``STL``) or spills in ptxas's report."""
    cluster = {n: k for n, k in gn.items() if "_cluster_" in n}
    missing = [n for n, k in cluster.items()
               if not (k.get("LDGSTS") and k.get("UCGABAR_ARV")
                       and k.get("UCGABAR_WAIT"))]
    local = [n for n, k in gn.items()
             if k.get("LDL") or k.get("STL") or k.get("spill_store_bytes")
             or k.get("spill_load_bytes")]
    if len(cluster) != 6 or missing or local:
        raise AssertionError(
            f"groupnorm SASS: cluster kernels {sorted(cluster)}; without "
            f"LDGSTS or the cluster barrier {missing}; with local memory or "
            f"spills {local}")


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------
def _attention_case(name, *, dtype, width, q_lens, lengths, h_q=16,
                    h_kv=16, d=64, blocks=32, page=PAGE, q8=False, seed=0):
    """Inputs at the serving path's shapes: 8 slots, pages of ``page`` rows
    scattered over a 1 + 8 * ``blocks`` page pool, page 0 poisoned.  With
    ``q8`` the pool is int8 per (token, head), as the engine writes it."""
    from paddle_ray_tpu_torch.models.generation import _kv_quant
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b = len(q_lens)
    n = 1 + b * blocks
    k = torch.randn(n, page, h_kv, d, generator=g, device="cuda")
    v = torch.randn(n, page, h_kv, d, generator=g, device="cuda")
    perm = torch.randperm(n - 1, generator=g, device="cuda") + 1
    table = perm.reshape(b, blocks).to(torch.int32)
    q = torch.randn(b, width, h_q, d, generator=g, device="cuda")
    if q8:
        (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
        for t in (kq, vq):
            t[0] = 127
        for t in (ks, vs):
            t[0] = 1e4
        pool = (kq, ks[..., 0], vq, vs[..., 0])
    else:
        k[0] = 1e4
        v[0] = 1e4
        pool = (k.to(dtype), v.to(dtype))
    return dict(name=name, q=q.to(dtype), pool=pool, table=table,
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device="cuda"),
                q_lens=torch.tensor(q_lens, dtype=torch.int32,
                                    device="cuda"))


def _attention_bound(c) -> dict:
    """The least time for this call's work: bytes (q and out once, the K/V
    rows the live slots own once -- int8 values plus a float32 scale per
    row and head for an int8 pool --, table and lengths) over the HBM rate,
    and 4 * (visible keys) * h_q * d operations over the peak for q's type;
    the larger of the two."""
    q, pool = c["q"], c["pool"]
    es = q.element_size()
    _, _, h_q, d = q.shape
    h_kv = pool[0].shape[2]
    row_bytes = (d + 4 if len(pool) == 4 else d * es) * h_kv
    lengths = c["lengths"].tolist()
    q_lens = c["q_lens"].tolist()
    rows = sum(ln for ln, ql in zip(lengths, q_lens) if ln > 0 and ql > 0)
    n_bytes = (2 * q.numel() * es + 2 * rows * row_bytes
               + c["table"].numel() * 4 + 2 * len(lengths) * 4)
    keys = sum(ln - ql + i + 1 for ln, ql in zip(lengths, q_lens)
               for i in range(ql) if ln > 0)
    ops = 4 * keys * h_q * d
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _sdpa_inputs(c):
    """The same K/V gathered into contiguous ``[B, h, T, d]`` (outside the
    timed call; an int8 pool dequantised) and the ragged causal mask as a
    boolean ``[B, 1, C, T]``."""
    q, pool, table = c["q"], c["pool"], c["table"]
    b, width, h_q, d = q.shape
    _, page, h_kv, _ = pool[0].shape
    if len(pool) == 4:
        k = (pool[0].float() * pool[1][..., None]).to(q.dtype)
        v = (pool[2].float() * pool[3][..., None]).to(q.dtype)
    else:
        k, v = pool
    t_len = table.shape[1] * page
    kd = k[table.long()].reshape(b, t_len, h_kv, d).transpose(1, 2)
    vd = v[table.long()].reshape(b, t_len, h_kv, d).transpose(1, 2)
    rep = h_q // h_kv
    kd = kd.repeat_interleave(rep, dim=1).contiguous()
    vd = vd.repeat_interleave(rep, dim=1).contiguous()
    t = torch.arange(t_len, device="cuda")
    qi = torch.arange(width, device="cuda")
    ln = c["lengths"].long()[:, None, None]
    ql = c["q_lens"].long()[:, None, None]
    mask = ((t[None, None, :] <= ln - ql + qi[None, :, None])
            & (qi[None, :, None] < ql))
    # SDPA has no zero-row convention: give dead rows key 0 (timing only)
    mask[:, :, 0] |= ~mask.any(-1)
    return q.transpose(1, 2).contiguous(), kd, vd, mask[:, None]


def paged_cases() -> list:
    """``(name, keyword arguments of _attention_case)`` of every paged
    attention case, the serving path's shapes first."""
    decode = dict(width=8, q_lens=[1] * 7 + [0],
                  lengths=[1, 63, 64, 65, 700, 2048, 1500, 0])
    mixed = dict(width=128, q_lens=[128, 1, 1, 1, 1, 1, 1, 0],
                 lengths=[1664, 1, 64, 65, 700, 2048, 1000, 0])
    decode_2048 = dict(width=1, q_lens=[1] * 8, lengths=[2048] * 8)
    # a long ragged decode over many splits (page-boundary lengths, a dead
    # slot), GQA 4 with pages of 32 and 128, a 128-wide chunk without GQA
    # (the serving shape), and gpt3-2.7b's head dim 80 / gpt3-760m's 96
    long_decode = dict(width=1, q_lens=[1] * 7 + [0],
                       lengths=[1, 64, 65, 777, 2048, 4096, 8192, 0])
    bf16, f32 = torch.bfloat16, torch.float32
    # the same over a pool in q's dtype, and gpt3-2.7b's / gpt3-760m's head
    # dims there
    cases = [
        ("long_decode_bf16", dict(dtype=bf16, blocks=128, **long_decode)),
        ("decode_gqa4_page32_bf16", dict(dtype=bf16, page=32, h_kv=4,
                                         blocks=64, **decode)),
        ("mixed_gqa4_page128_bf16", dict(dtype=bf16, page=128, h_kv=4,
                                         blocks=16, **mixed)),
        ("decode_d80_bf16", dict(dtype=bf16, d=80, h_q=32, h_kv=32,
                                 **decode)),
        ("mixed_d96_bf16", dict(dtype=bf16, d=96, **mixed)),
        ("decode_d96_f32", dict(dtype=f32, d=96, **decode)),
    ]
    for dtype in (f32, bf16):
        tag = "f32" if dtype == f32 else "bf16"
        cases += [
            (f"decode_{tag}", dict(dtype=dtype, **decode)),
            (f"decode_gqa_{tag}", dict(dtype=dtype, h_kv=8, **decode)),
            (f"mixed_{tag}", dict(dtype=dtype, **mixed)),
            (f"mixed_gqa_{tag}", dict(dtype=dtype, h_kv=8, **mixed)),
            (f"decode_q8_{tag}", dict(dtype=dtype, q8=True, **decode)),
            (f"mixed_gqa_q8_{tag}", dict(dtype=dtype, h_kv=8, q8=True,
                                         **mixed)),
        ]
    cases += [
        ("decode_q8_page32_d128_bf16", dict(dtype=bf16, q8=True, page=32,
                                            d=128, h_q=8, h_kv=8, blocks=64,
                                            **decode)),
        ("decode_gqa_q8_page128_f32", dict(dtype=f32, q8=True, page=128,
                                           h_kv=8, blocks=16, **decode)),
        ("long_decode_q8_bf16", dict(dtype=bf16, q8=True, blocks=128,
                                     **long_decode)),
        ("long_decode_q8_f32", dict(dtype=f32, q8=True, blocks=128,
                                    **long_decode)),
        ("decode_gqa_q8_bf16", dict(dtype=bf16, q8=True, h_kv=8, **decode)),
        ("decode_gqa4_q8_page32_bf16", dict(dtype=bf16, q8=True, page=32,
                                            h_kv=4, blocks=64, **decode)),
        ("mixed_gqa4_q8_page128_bf16", dict(dtype=bf16, q8=True, page=128,
                                            h_kv=4, blocks=16, **mixed)),
        ("mixed_q8_bf16", dict(dtype=bf16, q8=True, **mixed)),
        ("decode_q8_d80_bf16", dict(dtype=bf16, q8=True, d=80, h_q=32,
                                    h_kv=32, **decode)),
        ("mixed_q8_d80_bf16", dict(dtype=bf16, q8=True, d=80, h_q=32,
                                   h_kv=32, **mixed)),
        ("decode_q8_d96_f32", dict(dtype=f32, q8=True, d=96, **decode)),
        ("mixed_gqa_q8_d96_bf16", dict(dtype=bf16, q8=True, d=96, h_kv=8,
                                       **mixed)),
    ]
    # speculative verify steps: decode lanes of 2 to spec_k + 1 rows (the
    # tensor-core tiles) beside a one-row decode lane, a 16-row prefill
    # lane and a dead slot, page 64, D 64, over either pool
    verify8 = dict(width=8, q_lens=[5, 5, 3, 1, 0],
                   lengths=[200, 457, 731, 1000, 0])
    verify16 = dict(width=16, q_lens=[16, 5, 5, 3, 1, 0],
                    lengths=[528, 205, 640, 999, 1000, 0])
    cases += [(f"verify_w{w}{'_q8' if q8 else ''}_bf16",
               dict(dtype=bf16, q8=q8, **kw))
              for w, kw in ((8, verify8), (16, verify16))
              for q8 in (False, True)]
    # the serving path's headline shapes first
    return [("decode_2048_bf16", dict(dtype=bf16, **decode_2048)),
            ("decode_2048_q8_bf16", dict(dtype=bf16, q8=True, **decode_2048)),
            *cases]


def phase_kernel() -> dict:
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.paged_attention import (
        kernel_plan, paged_ragged_attention, paged_ragged_attention_plain)
    bf16 = torch.bfloat16
    cases = [_attention_case(name, **kw) for name, kw in paged_cases()]
    results = {}
    for c in cases:
        scale = 1.0 / c["q"].shape[-1] ** 0.5
        args = (c["q"], c["pool"], c["table"], c["lengths"], c["q_lens"])
        # the lengths on the host, as the serving engine hands them over
        host = c["lengths"].tolist()
        kernel = lambda: paged_ragged_attention(  # noqa: E731
            *args, scale=scale, host_lengths=host)
        got = kernel()
        torch.cuda.synchronize()
        want = paged_ragged_attention_plain(*args, scale=scale)
        q8 = len(c["pool"]) == 4
        tol = TOL[c["q"].dtype]
        rel_tol = PAGED_BF16_REL_TOL if c["q"].dtype == bf16 else None
        err = float((got.float() - want.float()).abs().max())
        rel = _row_rel_err(got, want)
        if not (err <= tol and torch.isfinite(got).all()
                and (rel_tol is None or rel <= rel_tol)):
            raise AssertionError(f"{c['name']}: kernel vs plain max_abs_err "
                                 f"{err} (tolerance {tol}), a row's "
                                 f"max|err| / max|ref| {rel} (tolerance "
                                 f"{rel_tol})")
        for b, ql in enumerate(c["q_lens"].tolist()):
            if not bool((got[b, ql:] == 0).all()):
                raise AssertionError(f"{c['name']}: slot {b} pad rows not 0")
        qs, kd, vd, mask = _sdpa_inputs(c)
        r = {
            "max_abs_err": err, "tol": tol, "row_rel_err": rel,
            "rel_tol": rel_tol, "q8": q8,
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: paged_ragged_attention_plain(
                *args, scale=scale), iters=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, scale=scale)),
            **_attention_bound(c),
        }
        r["splits"], r["pages_per_split"] = kernel_plan(
            c["q"], c["pool"], c["table"], host)
        results[c["name"]] = r
        pool = c["pool"]
        emit("kernel", kernel="paged_ragged_attention", case=c["name"],
             shape=list(c["q"].shape), page=pool[0].shape[1],
             h_kv=pool[0].shape[2], kv_dtype=str(pool[0].dtype),
             lengths=c["lengths"].tolist(), q_lens=c["q_lens"].tolist(), **r)
        del qs, kd, vd, mask
    return results


# ---------------------------------------------------------------------------
# 4. the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------
# name, B, S, H, Hkv, D, dtype, causal; the first is the training path's
FLASH_CASES = (
    ("train_bf16", TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, torch.bfloat16, True),
    ("causal_f32", 2, 512, 16, 16, 64, torch.float32, True),
    ("full_f32", 2, 512, 16, 16, 64, torch.float32, False),
    ("gqa_hkv4_f32", 2, 512, 16, 4, 64, torch.float32, True),
    ("d128_bf16", 2, 512, 8, 8, 128, torch.bfloat16, True),
    # gpt3-1.3b's attention at train_1p3b's shape (head dim 128)
    ("d128_1p3b_bf16", M1P3B_BATCH, TRAIN_SEQ, 16, 16, 128, torch.bfloat16,
     True),
    # gpt3-760m's attention at its bench.py batch (head dim 96) and
    # gpt3-2.7b's (head dim 80), GQA, and a ragged S (5 tiles of 64)
    ("d96_760m_bf16", 4, TRAIN_SEQ, 16, 16, 96, torch.bfloat16, True),
    ("d80_2p7b_bf16", 2, TRAIN_SEQ, 32, 32, 80, torch.bfloat16, True),
    ("gqa_hkv4_bf16", 2, 512, 16, 4, 64, torch.bfloat16, True),
    ("ragged_s320_bf16", 4, 320, 16, 16, 64, torch.bfloat16, True),
)


def _flash_bound(kind, b, s, h, hkv, d, dtype, causal, extra_bytes=0) -> dict:
    """The least time for one kernel's work at this shape: its products
    (forward 2, dq 3, dk/dv 4 ``[S, D] x [D, S]``-shaped ones, each 2 *
    pairs * D operations per head, pairs the visible (row, key) pairs)
    over the peak for the inputs' type, against its inputs and outputs
    read and written once over the HBM rate (``extra_bytes``: a bias or
    segment ids read, dbias written); the larger of the two."""
    pairs = s * (s + 1) // 2 if causal else s * s
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    ops = 2 * products * pairs * d * b * h
    es = torch.tensor([], dtype=dtype).element_size()
    nq, nkv, row = b * s * h * d * es, b * s * hkv * d * es, b * h * s * 4
    n_bytes = {"fwd": 2 * nq + 2 * nkv + row,             # q k v -> o lse
               "dq": 3 * nq + 2 * nkv + 2 * row,          # q k v do lse delta -> dq
               "dkv": 2 * nq + 4 * nkv + 2 * row}[kind]   # q k v do lse delta -> dk dv
    n_bytes += extra_bytes
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def phase_flash_kernel() -> dict:
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.flash_attention import (
        _fold_heads, _prescale_q, flash_backward_dkv, flash_backward_dkv_plain,
        flash_backward_dq, flash_backward_dq_plain, flash_forward,
        flash_forward_plain)
    results = {}
    for name, b, s, h, hkv, d, dtype, causal in FLASH_CASES:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        shape_q, shape_kv = (b, s, h, d), (b, s, hkv, d)
        q, do = (torch.randn(shape_q, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(shape_kv, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        qf, kf, vf, dof = (_fold_heads(t) for t in (q, k, v, do))
        kw = dict(causal=causal, scale=1.0 / d ** 0.5)
        tol = TOL[dtype]

        o, lse = flash_forward(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_forward_plain(qf, kf, vf, **kw)
        # the backward wrappers' one-pass pre-scaling rounds once, as JAX's
        if not torch.equal(_prescale_q(qf, kw["scale"]), (qf.float() * (
                kw["scale"] * 1.4426950408889634)).to(dtype)):
            raise AssertionError(f"flash {name}: q * c is not one rounding")
        delta = (o_ref.float() * dof.float()).sum(-1)
        bwd = (qf, kf, vf, dof, lse_ref, delta)
        dq = flash_backward_dq(*bwd, **kw)
        dk, dv = flash_backward_dkv(*bwd, **kw)
        torch.cuda.synchronize()
        dq_ref = flash_backward_dq_plain(*bwd, **kw)
        dk_ref, dv_ref = flash_backward_dkv_plain(*bwd, **kw)
        err = {"fwd": max(float((o.float() - o_ref.float()).abs().max()),
                          float((lse - lse_ref).abs().max())),
               "dq": float((dq.float() - dq_ref.float()).abs().max()),
               "dkv": max(float((dk.float() - dk_ref.float()).abs().max()),
                          float((dv.float() - dv_ref.float()).abs().max()))}
        rel = {"dq": _rel_err(dq, dq_ref),
               "dkv": max(_rel_err(dk, dk_ref), _rel_err(dv, dv_ref))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse, dq, dk, dv))
        if not (finite and err["fwd"] <= tol and rel["dq"] <= tol
                and rel["dkv"] <= tol):
            raise AssertionError(f"flash {name}: kernel vs plain: forward "
                                 f"max_abs_err {err['fwd']}, gradient "
                                 f"rel_err {rel} (tolerance {tol})")

        # yardstick: SDPA on [B, H, S, D] (the moves and the GQA
        # repetition are not timed); its backward is fwd+bwd minus fwd
        rep = h // hkv
        qh, doh = (t.transpose(1, 2).contiguous() for t in (q, do))
        kh, vh = (t.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
                  for t in (k, v))
        sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
            *a, is_causal=causal, scale=kw["scale"])
        lib_fwd = time_ms(lambda: sdpa(qh, kh, vh))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves), leaves, doh))
        r = {
            "fwd": {"ms": time_ms(lambda: flash_forward(qf, kf, vf, **kw)),
                    "plain_ms": time_ms(lambda: flash_forward_plain(
                        qf, kf, vf, **kw), iters=5),
                    "library_ms": lib_fwd},
            "dq": {"ms": time_ms(lambda: flash_backward_dq(*bwd, **kw)),
                   "plain_ms": time_ms(lambda: flash_backward_dq_plain(
                       *bwd, **kw), iters=5),
                   "library_ms": lib_fwd_bwd - lib_fwd},
            "dkv": {"ms": time_ms(lambda: flash_backward_dkv(*bwd, **kw)),
                    "plain_ms": time_ms(lambda: flash_backward_dkv_plain(
                        *bwd, **kw), iters=5),
                    "library_ms": lib_fwd_bwd - lib_fwd},
        }
        for kind in r:
            r[kind].update(max_abs_err=err[kind], **_flash_bound(
                kind, b, s, h, hkv, d, dtype, causal))
            if kind in rel:
                r[kind]["rel_err"] = rel[kind]
        results[name] = r
        emit("flash_kernel", case=name, shape=[b, s, h, d], h_kv=hkv,
             dtype=str(dtype), causal=causal, tol=tol,
             library="scaled_dot_product_attention (dq and dkv entries: "
                     "its backward, for the two kernels together)", **r)
        del q, k, v, do, qf, kf, vf, dof, qh, kh, vh, doh, leaves
    results.update(_flash_mode_cases())
    return results


# B 8, S 512, H 16, D 64, bf16, non-causal: the shape of BERT-large's and the
# fused encoder's attention, with the masking each runs; then causal with
# segment ids that leave some rows no visible key (the 64-key visit rule)
FLASH_MODES = ("segments_bf16", "mask_bias_bf16", "bias_dbias_bf16",
               "causal_segments_bf16")
# rows of batch 0 whose q segment id no key shares: first, middle and last
# of their 64-row tile, and a run of eleven
LONELY_ROWS = (5, 70, 127, *range(300, 311))


def _flash_mode_cases() -> dict:
    """The flash kernels with segment ids (padding over the encoder's
    lengths), a ``[B, 1, 1, S]`` mask-bias read in place (equal to the
    materialised bias), a full float32 bias with dbias, and causal with
    segment ids where the rows ``LONELY_ROWS`` of batch 0 see no key
    (each must give the mean of v over the keys below ``(r // 64 + 1) *
    64``), against the plain versions; each timed beside its bound, the
    plain version and SDPA with the same mask (a boolean mask, or the bias
    as a float mask without its gradient)."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.flash_attention import (
        _fold_heads, flash_backward_dkv, flash_backward_dkv_plain,
        flash_backward_dq, flash_backward_dq_plain, flash_forward,
        flash_forward_plain)
    b, s, h, d, dtype = ENC_BATCH, ENC_SEQ, ENC_HEADS, 64, torch.bfloat16
    tol = TOL[dtype]
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    qf, kf, vf, dof = (_fold_heads(t) for t in (q, k, v, do))
    valid = (torch.arange(s, device="cuda")[None, :]
             < torch.tensor(ENC_LENGTHS, device="cuda")[:, None])
    seg = valid.to(torch.int32).contiguous()
    mask_bias = torch.where(valid, 0.0, -1e30)[:, None, None, :].float()
    full_bias = torch.randn(b, h, s, s, generator=g, device="cuda")
    lonely = seg.clone()
    lonely[0, list(LONELY_ROWS)] = 2
    tril = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    modes = {
        "segments_bf16": (dict(segment_ids=(seg, seg)),
                          seg[:, None, :, None] == seg[:, None, None, :],
                          2 * b * s * 4, False),
        "mask_bias_bf16": (dict(bias=mask_bias.expand(b, h, s, s)),
                           valid[:, None, None, :], b * s * 4, False),
        "bias_dbias_bf16": (dict(bias=full_bias), full_bias.to(dtype),
                            b * h * s * s * 4, False),
        "causal_segments_bf16": (
            dict(segment_ids=(lonely, seg)),
            (lonely[:, None, :, None] == seg[:, None, None, :]) & tril,
            2 * b * s * 4, True),
    }
    results = {}
    for name, (extra, sdpa_mask, extra_bytes, causal) in modes.items():
        kw = dict(causal=causal, scale=1.0 / d ** 0.5, **extra)
        need = name == "bias_dbias_bf16"
        o, lse = flash_forward(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_forward_plain(qf, kf, vf, **kw)
        delta = (o_ref.float() * dof.float()).sum(-1)
        bwd = (qf, kf, vf, dof, lse_ref, delta)
        dq = flash_backward_dq(*bwd, need_dbias=need, **kw)
        dk, dv = flash_backward_dkv(*bwd, **kw)
        torch.cuda.synchronize()
        dq_ref = flash_backward_dq_plain(*bwd, need_dbias=need, **kw)
        dk_ref, dv_ref = flash_backward_dkv_plain(*bwd, **kw)
        rel = {}
        if need:
            (dq, dbias), (dq_ref, dbias_ref) = dq, dq_ref
            rel["dbias"] = _rel_err(dbias, dbias_ref)
        err = {"fwd": max(float((o.float() - o_ref.float()).abs().max()),
                          float((lse - lse_ref).abs().max())),
               "dq": float((dq.float() - dq_ref.float()).abs().max()),
               "dkv": max(float((dk.float() - dk_ref.float()).abs().max()),
                          float((dv.float() - dv_ref.float()).abs().max()))}
        rel.update(dq=_rel_err(dq, dq_ref),
                   dkv=max(_rel_err(dk, dk_ref), _rel_err(dv, dv_ref)))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse, dq, dk, dv))
        same_as_materialised = None
        if name == "causal_segments_bf16":
            # a row no key shares a segment with weighs its visited keys alike
            for r in LONELY_ROWS:
                seen = (r // 64 + 1) * 64
                want = vf[:h, :seen].float().mean(1)
                rel["lonely_rows"] = max(rel.get("lonely_rows", 0.0), float(
                    (o[:h, r].float() - want).abs().max()))
        if name == "mask_bias_bf16":
            o_mat, lse_mat = flash_forward(
                qf, kf, vf, **dict(kw, bias=extra["bias"].contiguous()))
            same_as_materialised = bool(torch.equal(o_mat, o)
                                        and torch.equal(lse_mat, lse))
        if not (finite and err["fwd"] <= tol and max(rel.values()) <= tol
                and same_as_materialised is not False):
            raise AssertionError(
                f"flash {name}: kernel vs plain: forward max_abs_err "
                f"{err['fwd']}, gradient rel_err {rel} (tolerance {tol}), "
                f"equal to the materialised bias: {same_as_materialised}")
        qh, kh, vh, doh = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
            *a, attn_mask=sdpa_mask, scale=kw["scale"])  # mask holds causal
        lib_fwd = time_ms(lambda: sdpa(qh, kh, vh))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves), leaves, doh))
        r = {
            "fwd": {"ms": time_ms(lambda: flash_forward(qf, kf, vf, **kw)),
                    "plain_ms": time_ms(lambda: flash_forward_plain(
                        qf, kf, vf, **kw), iters=5),
                    "library_ms": lib_fwd},
            "dq": {"ms": time_ms(lambda: flash_backward_dq(
                       *bwd, need_dbias=need, **kw)),
                   "plain_ms": time_ms(lambda: flash_backward_dq_plain(
                       *bwd, need_dbias=need, **kw), iters=5),
                   "library_ms": lib_fwd_bwd - lib_fwd},
            "dkv": {"ms": time_ms(lambda: flash_backward_dkv(*bwd, **kw)),
                    "plain_ms": time_ms(lambda: flash_backward_dkv_plain(
                        *bwd, **kw), iters=5),
                    "library_ms": lib_fwd_bwd - lib_fwd},
        }
        for kind in r:
            kind_bytes = extra_bytes + (b * h * s * s * 4
                                        if need and kind == "dq" else 0)
            r[kind].update(max_abs_err=err[kind], rel_err=rel.get(kind),
                           **_flash_bound(kind, b, s, h, h, d, dtype, causal,
                                          kind_bytes))
        results[name] = r
        emit("flash_kernel", case=name, shape=[b, s, h, d], h_kv=h,
             dtype=str(dtype), causal=causal, tol=tol,
             lonely_rows_max_abs_err=rel.get("lonely_rows"),
             lengths=list(ENC_LENGTHS), dbias_rel_err=rel.get("dbias"),
             equal_to_materialised_bias=same_as_materialised,
             library="scaled_dot_product_attention with the same mask "
                     "(dq and dkv entries: its backward, for the two "
                     "kernels together, without dbias)", **r)
        del o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref, leaves
    return results


# ---------------------------------------------------------------------------
# 5. the decode kernels against their plain versions
# ---------------------------------------------------------------------------
# generate()'s cache for prompt 128 + 256 new tokens, aligned to its 256-row
# block; the positions its decode steps attend up to
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 128, 256
# generate()'s warm-up call (every kernel and GEMM shape of a call, short)
# and timed calls: a whole 256-token warm-up and a second timed call cost
# the run about 45 s, which the serving engine's phases need to stay
# inside the run's time limit
GEN_WARMUP, GEN_TIMED = 16, 1
DEC_CACHE_T = 512
DEC_POSITIONS = (0, 127, 255, 383)
# gpt3-350m's decode linears (K, N, has bias) and the tied LM head
DEC_LINEARS = (("qkv", 1024, 3072, True), ("out", 1024, 1024, True),
               ("fc1", 1024, 4096, True), ("fc2", 4096, 1024, True),
               ("head", 1024, 50304, False))


def _decode_attention_bound(b, h, n_live, d, dtype, q8) -> dict:
    """Least time: q and out once, the live K/V rows once (int8: values
    plus a float32 scale per row), 4 * rows * d operations per (b, h)
    over the peak for q's type."""
    es = torch.tensor([], dtype=dtype).element_size()
    row = d + 4 if q8 else d * es
    n_bytes = 2 * b * h * d * es + 2 * b * h * n_live * row
    ops = 4 * b * h * n_live * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _matmul_bound(b, k, n, dtype, bias_dtype=None) -> dict:
    """Least time: x, the int8 weight, the scales (and the bias, in its own
    type) read once, the output written once; 2 * B * K * N operations
    over the peak for x's type."""
    es = torch.tensor([], dtype=dtype).element_size()
    bias_es = 0 if bias_dtype is None else torch.tensor(
        [], dtype=bias_dtype).element_size()
    n_bytes = b * k * es + k * n + n * 4 + n * bias_es + b * n * es
    ops = 2 * b * k * n
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


# (name, cache kind, q dtype, batch, heads, head dim, cache rows,
# positions): gpt3-350m's decode at batch 8, then gpt3-760m's (16 heads of
# 96) and gpt3-2.7b's (32 of 80); then one stream decoding gpt3-350m at the
# end of a 2048-row cache, where 16 pairs alone would leave most SMs idle
# and the kernel splits each pair's rows (the float32 cache at 1e-4: a
# mis-weighted merge moves these outputs, averages of 2048 rows, by about
# 1e-3, which a bf16 output's TOL alone does not see)
DEC_LONG_T = 2048
DEC_ATTN_CASES = (
    ("bf16", "bf16", "bfloat16", GEN_BATCH, 16, 64, DEC_CACHE_T,
     DEC_POSITIONS),
    ("f32", "f32", "float32", GEN_BATCH, 16, 64, DEC_CACHE_T,
     DEC_POSITIONS),
    ("q8", "q8", "bfloat16", GEN_BATCH, 16, 64, DEC_CACHE_T,
     DEC_POSITIONS),
    *((f"{kind}_d{d}", kind, "bfloat16", GEN_BATCH, h, d, DEC_CACHE_T,
       (255,))
      for h, d in ((16, 96), (32, 80)) for kind in ("bf16", "q8")),
    *((f"long_{kind}_b1", kind, dtype, 1, 16, 64, DEC_LONG_T,
       (DEC_LONG_T - 1,))
      for kind, dtype in (("bf16", "bfloat16"), ("q8", "bfloat16"),
                          ("f32", "float32"))))


def _decode_attention_inputs(kind, dtype, b, h, d, t_len):
    """q ``[b, h, 1, d]`` and a ``t_len``-row cache from the seed:
    ``(k, v)`` in q's dtype, or int8 ``(k_q, k_s, v_q, v_s)``."""
    from paddle_ray_tpu_torch.models.generation import _kv_quant
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    q = torch.randn(b, h, 1, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, h, t_len, d, generator=g, device="cuda")
    v = torch.randn(b, h, t_len, d, generator=g, device="cuda")
    if kind == "q8":
        (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
        return q, (kq, ks, vq, vs)
    return q, (k.to(dtype), v.to(dtype))


def _decode_attention_cases():
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.decode_attention import (
        fused_decode_attention, fused_decode_attention_plain,
        fused_decode_attention_q8_plain, kernel_plan)
    results = {}
    for name, kind, dtype, b, h, d, t_len, positions in DEC_ATTN_CASES:
        dtype = getattr(torch, dtype)
        scale = 1.0 / d ** 0.5
        q, cache = _decode_attention_inputs(kind, dtype, b, h, d, t_len)
        if kind == "q8":
            kq, ks, vq, vs = cache
            plain = fused_decode_attention_q8_plain
            kd = (kq.float() * ks).to(dtype)
            vd = (vq.float() * vs).to(dtype)
        else:
            plain = fused_decode_attention_plain
            kd, vd = cache
        for pos in positions:
            got = fused_decode_attention(q, cache, pos, scale=scale)
            again = fused_decode_attention(q, cache, pos, scale=scale)
            torch.cuda.synchronize()
            same_bits = bool(torch.equal(got, again))
            want = plain(q, cache, pos, scale=scale)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            # a bf16 output is held besides to every row's largest value,
            # as the paged kernel's (PAGED_BF16_REL_TOL)
            rel = _row_rel_err(got, want)
            rel_tol = PAGED_BF16_REL_TOL if dtype == torch.bfloat16 else None
            if not (err <= tol and (rel_tol is None or rel <= rel_tol)
                    and torch.isfinite(got).all() and same_bits):
                raise AssertionError(f"decode attention {name} pos {pos}: "
                                     f"max_abs_err {err} (tolerance {tol}), "
                                     f"row_rel_err {rel} (tolerance "
                                     f"{rel_tol}), the same bits in two "
                                     f"calls {same_bits}")
            n_splits, rps = kernel_plan(q, pos)
            ks_, vs_ = (kd[:, :, :pos + 1].contiguous(),
                        vd[:, :, :pos + 1].contiguous())
            r = {"max_abs_err": err, "tol": tol, "row_rel_err": rel,
                 "row_rel_tol": rel_tol, "same_bits_twice": same_bits,
                 "n_splits": n_splits, "rows_per_split": rps,
                 "ms": time_ms(lambda: fused_decode_attention(
                     q, cache, pos, scale=scale)),
                 "plain_ms": time_ms(lambda: plain(q, cache, pos,
                                                   scale=scale), iters=5),
                 "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                     q, ks_, vs_, scale=scale)),
                 **_decode_attention_bound(b, h, pos + 1, d, dtype,
                                           kind == "q8")}
            results[f"{name}_pos{pos}"] = r
            emit("decode_kernel", kernel="fused_decode_attention",
                 case=f"{name}_pos{pos}", shape=[b, h, t_len, d],
                 q_dtype=str(dtype), cache_dtype=str(cache[0].dtype),
                 library="scaled_dot_product_attention over [B, h, pos+1, d]"
                 + (" (dequantised cache)" if kind == "q8" else ""), **r)
    return results


ONE_CALL_REPEATS = 4


def _one_call_kernels(fn) -> tuple:
    """The device kernels of one call of ``fn``: ``ONE_CALL_REPEATS``
    calls under ``torch.profiler``, as (name, calls a call), and the
    profiles :func:`profiled` took; a kernel not launched the same number
    of times in every call raises."""
    _, rows, attempts = profiled(
        lambda: [fn() for _ in range(ONE_CALL_REPEATS)])
    if not rows or any(c % ONE_CALL_REPEATS for _, _, c in rows):
        raise AssertionError(f"{ONE_CALL_REPEATS} calls ran the device "
                             f"kernels {[(k[:60], c) for k, _, c in rows]}")
    return [(k, c // ONE_CALL_REPEATS) for k, _, c in rows], attempts


def matmul_cases() -> list:
    """``int8_stream_matmul``'s cases: (name, rows, K, N, bias, x dtype)."""
    cases = [(name, GEN_BATCH, k, n, bias, torch.bfloat16)
             for name, k, n, bias in DEC_LINEARS]
    return cases + [
        ("out_no_bias", GEN_BATCH, 1024, 1024, False, torch.bfloat16),
        ("n97", GEN_BATCH, 1024, 97, True, torch.bfloat16),
        ("qkv_f32", GEN_BATCH, 1024, 3072, True, torch.float32),
        ("rows1", 1, 1024, 4096, True, torch.bfloat16),
        ("rows128", 128, 1024, 1024, True, torch.bfloat16)]


def matmul_inputs(b, k, n, with_bias, dtype):
    """``(x, w_q, scale, bias)`` from ``SEED`` at gpt3-350m-like magnitudes:
    weights N(0, 0.02) quantized per channel, activations of unit scale
    (half for the 4096-wide fc2 input), a bias in x's dtype."""
    from paddle_ray_tpu_torch.quantization import quantize_per_channel
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    w = 0.02 * torch.randn(k, n, generator=g, device="cuda")
    w_q, scale = quantize_per_channel(w, axis=1)
    x = (torch.randn(b, k, generator=g, device="cuda")
         * (0.5 if k > 1024 else 1.0)).to(dtype)
    bias = (0.02 * torch.randn(n, generator=g, device="cuda")).to(dtype) \
        if with_bias else None
    return x, w_q, scale.reshape(-1), bias


def _matmul_cases():
    from paddle_ray_tpu_torch.ops.decode_matmul import (
        int8_stream_matmul, int8_stream_matmul_plain,
        int8_stream_matmul_split_plain, kernel_plan)
    results = {}
    for name, b, k, n, with_bias, dtype in matmul_cases():
        x, w_q, scale, bias = matmul_inputs(b, k, n, with_bias, dtype)
        got = int8_stream_matmul(x, w_q, scale, bias)
        again = int8_stream_matmul(x, w_q, scale, bias)
        torch.cuda.synchronize()
        want = int8_stream_matmul_plain(x, w_q, scale, bias)
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype]
        same = bool(torch.equal(got, again))
        rows_per_split, n_splits = kernel_plan(b, k, n, x.device)
        # a float32 x against the kernel's own cut of K summed run by run:
        # the split and its merge held to float32 rounding
        split_err = None if dtype != torch.float32 else _rel_err(
            got, int8_stream_matmul_split_plain(
                x, w_q, scale, bias, rows_per_split=rows_per_split))
        if not (err <= tol and torch.isfinite(got).all() and same
                and (split_err is None or split_err <= STREAM_SPLIT_TOL)):
            raise AssertionError(f"int8_stream_matmul {name}: max_abs_err "
                                 f"{err} (tol {tol}), the same bits in two "
                                 f"calls {same}, against the split plain "
                                 f"version {split_err} (max|err| / max|ref|"
                                 f" tolerance {STREAM_SPLIT_TOL})")
        plan = {"rows_per_split": rows_per_split, "n_splits": n_splits,
                "same_bits_twice": same, "split_rel_err": split_err}

        def library():
            y = torch.matmul(x, w_q.to(dtype)) * scale.to(dtype)
            return y + bias if bias is not None else y
        r = {"max_abs_err": err, "tol": tol,
             "ms": time_ms(lambda: int8_stream_matmul(x, w_q, scale, bias)),
             "plain_ms": time_ms(lambda: int8_stream_matmul_plain(
                 x, w_q, scale, bias), iters=5),
             "library_ms": time_ms(library),
             **plan, **_matmul_bound(b, k, n, dtype,
                                     None if bias is None else bias.dtype)}
        results[name] = r
        emit("decode_kernel", kernel="int8_stream_matmul", case=name,
             shape=[b, k, n], dtype=str(dtype), bias=with_bias,
             library="torch.matmul(x, w_q.to(x.dtype)) * scale (+ bias)",
             **r)
    return results


def phase_decode_kernel() -> dict:
    return {"attention": _decode_attention_cases(),
            "matmul": _matmul_cases()}


def phase_int8_one_call(when: str) -> None:
    """The device kernels of one call of each int8 kernel's caller (run
    ``when`` early, after the decode kernels, and late, after ``qat``:
    the profiler kept a late window's kernels worst):
    ``int8_stream_matmul`` at gpt3-350m's qkv with a bf16
    bias must run its kernel alone (the bias read in its own type, split-K
    merged in the launch); a bf16 ``QuantizedLinear`` of the encoder's
    linear1 width with a bf16 bias at 8 x 512 rows must run one
    ``int8_matmul`` kernel, which adds the bias and writes bf16 (the rest
    are the per-tensor quantize and the scale product)."""
    from paddle_ray_tpu_torch.ops.decode_matmul import int8_stream_matmul
    from paddle_ray_tpu_torch.quantization import (QuantizedLinear,
                                                   quantize_per_channel)
    x, w_q, scale, bias = matmul_inputs(GEN_BATCH, ENC_D, 3 * ENC_D, True,
                                        torch.bfloat16)
    stream, stream_attempts = _one_call_kernels(
        lambda: int8_stream_matmul(x, w_q, scale, bias))
    if len(stream) != 1 or stream[0][1] != 1 \
            or "int8_stream_matmul_kernel" not in stream[0][0]:
        raise AssertionError(f"int8_stream_matmul: one call ran the device "
                             f"kernels {stream}")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)
    w_qs, s = quantize_per_channel(
        0.02 * torch.randn(ENC_D, ENC_FFN, generator=g, device="cuda"),
        axis=1)
    lin = QuantizedLinear(w_qs, s, (0.02 * torch.randn(
        ENC_FFN, generator=g, device="cuda")).bfloat16())
    h = torch.randn(ENC_BATCH * ENC_SEQ, ENC_D, generator=g,
                    device="cuda").bfloat16()
    with torch.no_grad():
        layer, layer_attempts = _one_call_kernels(lambda: lin(h))
    int8_calls = sum(c for k, c in layer if "int8_matmul_kernel" in k)
    if int8_calls != 1:
        raise AssertionError(f"QuantizedLinear: one call ran the device "
                             f"kernels {layer}")
    emit("int8_one_call", when=when, repeats=ONE_CALL_REPEATS,
         profile_attempts=[stream_attempts, layer_attempts],
         int8_stream_matmul_kernels=[(k[:70], c) for k, c in stream],
         quantized_linear_kernels=[(k[:70], c) for k, c in layer])


# ---------------------------------------------------------------------------
# 13. the GroupNorm kernels against their plain versions
# ---------------------------------------------------------------------------
# mode -> (act, scale+shift); "mod" is a ResBlock's norm2
GN_MODES = {"none": ("none", False), "silu": ("silu", False),
            "mod": ("silu", True)}
GN_EPS = 1e-5


def unet_gn_calls(cfg=UNET_CFG, img=UNET_IMG):
    """(rows, C, mode) of each fused GroupNorm call of one UNet forward,
    in order, walking ``models/unet.py``'s structure: a ResBlock's norm1
    ("silu") and norm2 ("mod"), an AttnBlock's norm ("none"), the output
    norm ("silu")."""
    ch, mults = cfg["base_channels"], cfg["channel_mults"]
    attn, per = cfg["attn_levels"], cfg["blocks_per_level"]
    calls, chans, cin = [], [ch], ch
    last = len(mults) - 1

    def block(rows, c_in, c_out, lvl):
        calls.extend([(rows, c_in, "silu"), (rows, c_out, "mod")])
        if lvl in attn:
            calls.append((rows, c_out, "none"))

    for lvl, mult in enumerate(mults):
        rows = (img >> lvl) ** 2
        for _ in range(per):
            block(rows, cin, ch * mult, lvl)
            cin = ch * mult
            chans.append(cin)
        if lvl != last:
            chans.append(cin)
    rows = (img >> last) ** 2
    calls.extend([(rows, cin, "silu"), (rows, cin, "mod"),
                  (rows, cin, "none"), (rows, cin, "silu"),
                  (rows, cin, "mod")])
    for lvl, mult in reversed(list(enumerate(mults))):
        rows = (img >> lvl) ** 2
        for _ in range(per + 1):
            block(rows, cin + chans.pop(), ch * mult, lvl)
            cin = ch * mult
    calls.append((img * img, cin, "silu"))
    return calls


def _gn_inputs(n, rows, c, mod, dtype):
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = (1.5 * r(n, rows, c) + 0.5).to(dtype)
    w, b = (1.0 + 0.2 * r(c)).to(dtype), (0.2 * r(c)).to(dtype)
    s = t = None
    if mod:
        s, t = (0.3 * r(n, c)).to(dtype), (0.3 * r(n, c)).to(dtype)
    return x, w, b, s, t, r(n, rows, c).to(dtype)


def _gn_bound(kind, n, rows, c, groups, dtype, mode) -> dict:
    """The least time: bytes -- forward x read and y written, backward x
    and dy read and dx written, each once, plus the parameters, the
    statistics and the float32 gradients of the parameters -- over the HBM
    rate, against the float32 operations a pass does per element (forward
    6, +4 for SiLU; backward 12, +10 for SiLU, +5 for the modulation) over
    the float32 CUDA-core peak (the arithmetic is float32 whatever x's
    type); the larger of the two."""
    act, mod = GN_MODES[mode]
    es = torch.tensor([], dtype=dtype).element_size()
    elems = n * rows * c
    params = 2 * c * es + (2 * n * c * es if mod else 0) + 2 * n * groups * 4
    if kind == "fwd":
        n_bytes = 2 * elems * es + params
        ops = elems * (6 + (4 if act == "silu" else 0))
    else:
        n_bytes = (3 * elems * es + params + 2 * c * 4
                   + (2 * n * c * 4 if mod else 0))
        ops = elems * (12 + (10 if act == "silu" else 0) + (5 if mod else 0))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _gn_route(n, rows, c, groups, dtype, fwd_tensors, bwd_tensors) -> dict:
    """Each kernel's plan (``group_norm_plan``) and the route the launch
    takes with these tensors (a plan the card cannot hold has already
    failed at its launch)."""
    from paddle_ray_tpu_torch.ops import groupnorm as gn
    out = {}
    for kind, ts in (("fwd", fwd_tensors), ("bwd", bwd_tensors)):
        plan = gn.group_norm_plan(n, rows, c, groups, dtype, kind)
        route = "cluster" if gn._plan_args(plan, *ts)[0] else "rowwise"
        out[kind] = {**{k: v for k, v in plan._asdict().items()
                        if v not in ("", 0)}, "route": route}
    return out


def _gn_case(name, n, rows, c, groups, mode, dtype, timed,
             misalign=False) -> dict:
    """One case: the kernels against the plain versions on the same
    inputs (the backward from the plain forward's statistics), each
    kernel twice (the same bits), with the plan and route each took; with
    ``misalign`` x and dy are views 2 bytes into a buffer (the rowwise
    route by alignment).  With ``timed`` each timed beside its bound, the
    plain version and ``torch.nn.functional.group_norm`` on the
    channels-last NCHW view."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.groupnorm import (
        fused_group_norm_bwd, fused_group_norm_bwd_plain, fused_group_norm_fwd,
        fused_group_norm_fwd_plain)
    act, mod = GN_MODES[mode]
    x, w, b, s, t, dy = _gn_inputs(n, rows, c, mod, dtype)
    if misalign:
        def shifted(a):
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
            view = buf[1:].view(a.shape)
            view.copy_(a)
            return view
        x, dy = shifted(x), shifted(dy)
    kw = dict(groups=groups, act=act)
    y, mu, rs = fused_group_norm_fwd(x, w, b, s, t, epsilon=GN_EPS, **kw)
    again = fused_group_norm_fwd(x, w, b, s, t, epsilon=GN_EPS, **kw)
    torch.cuda.synchronize()
    y_ref, mu_ref, rs_ref = fused_group_norm_fwd_plain(
        x, w, b, s, t, epsilon=GN_EPS, **kw)
    bwd = (x, w, b, s, t, mu_ref, rs_ref, dy)
    got = fused_group_norm_bwd(*bwd, **kw)
    got2 = fused_group_norm_bwd(*bwd, **kw)
    torch.cuda.synchronize()
    route = _gn_route(n, rows, c, groups, dtype, (x, y), (x, dy, got[0]))
    same_bits = all(torch.equal(a, e) for a, e in zip(
        (y, mu, rs, *got), (*again, *got2)) if e is not None)
    want = fused_group_norm_bwd_plain(*bwd, **kw)
    tol = TOL[dtype]
    # bfloat16: atol plus one rounding of the output type (a value that the
    # two float32 paths put on either side of a rounding boundary)
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    fwd_err = float((y.float() - y_ref.float()).abs().max())
    stat_err = max(float((mu - mu_ref).abs().max()),
                   float((rs - rs_ref).abs().max()))
    bwd_abs = max(float((a.float() - e.float()).abs().max())
                  for a, e in zip(got, want) if e is not None)
    bwd_rel = {k: _rel_err(a, e) for k, a, e in zip(
        ("dx", "dweight", "dbias", "dscale", "dshift"), got, want)
        if e is not None}
    finite = all(bool(torch.isfinite(a).all()) for a in (y, mu, rs, *got)
                 if a is not None)
    if not (finite and same_bits
            and torch.allclose(y.float(), y_ref.float(), rtol=rtol, atol=tol)
            and stat_err <= 1e-4 and max(bwd_rel.values()) <= tol):
        raise AssertionError(
            f"group norm {name} ({route}): kernel vs plain: forward "
            f"max_abs_err {fwd_err}, statistics {stat_err}, gradients "
            f"rel_err {bwd_rel} (tolerance {tol}); the same bits twice: "
            f"{same_bits}")
    r = {"fwd": {"max_abs_err": fwd_err, "stat_err": stat_err,
                 **route["fwd"],
                 **_gn_bound("fwd", n, rows, c, groups, dtype, mode)},
         "bwd": {"max_abs_err": bwd_abs, "rel_err": bwd_rel,
                 **route["bwd"],
                 **_gn_bound("bwd", n, rows, c, groups, dtype, mode)}}
    if timed:
        xv = x.view(n, rows, 1, c).permute(0, 3, 1, 2)
        dyv = dy.view(n, rows, 1, c).permute(0, 3, 1, 2)
        lib_fwd = time_ms(lambda: F.group_norm(xv, groups, w, b, GN_EPS))
        leaves = [a.detach().requires_grad_() for a in (xv, w, b)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            F.group_norm(leaves[0], groups, leaves[1], leaves[2], GN_EPS),
            leaves, dyv))
        r["fwd"].update(
            ms=time_ms(lambda: fused_group_norm_fwd(
                x, w, b, s, t, epsilon=GN_EPS, **kw)),
            plain_ms=time_ms(lambda: fused_group_norm_fwd_plain(
                x, w, b, s, t, epsilon=GN_EPS, **kw), iters=5),
            library_ms=lib_fwd)
        r["bwd"].update(
            ms=time_ms(lambda: fused_group_norm_bwd(*bwd, **kw)),
            plain_ms=time_ms(lambda: fused_group_norm_bwd_plain(*bwd, **kw),
                             iters=5),
            library_ms=lib_fwd_bwd - lib_fwd)
    emit("gn_kernel", case=name, shape=[n, rows, c], groups=groups,
         mode=mode, dtype=str(dtype), tol=tol, rtol=rtol, timed=timed,
         same_bits_twice=same_bits,
         library="torch.nn.functional.group_norm on the channels-last NCHW "
                 "view: GroupNorm alone, without the modulation or SiLU "
                 "(bwd: its autograd backward)", **r)
    return r


# (name, N, rows, C, groups, mode, dtype, misalign) beyond the UNet step's
# bf16 cases: float32, odd rows, other group counts, and each route of the
# plan -- the cluster route at 1 block a cluster (64 rows) and at 16 (g2,
# cpg10), the rowwise route for C * itemsize not a multiple of 16 bytes, for
# a slice past 16 blocks' shared memory, and for a view that does not start
# on 16 bytes; then a large batch of one- and four-row slices at cpg 4 and
# 1, whose one-block slices widen to group-sets of many groups (at 4 rows and
# cpg 1, 256 groups over the block's 256 threads)
GN_EXTRA_CASES = (
    ("f32_4096x320_mod", UNET_BATCH, 4096, 320, 32, "mod", "float32", False),
    ("f32_256x1280_none", UNET_BATCH, 256, 1280, 32, "none", "float32",
     False),
    ("f32_64x2560_silu", UNET_BATCH, 64, 2560, 32, "silu", "float32", False),
    ("odd_rows_63x640_g16_mod_bf16", UNET_BATCH, 63, 640, 16, "mod",
     "bfloat16", False),
    ("g2_cpg320_1024x640_silu_f32", 8, 1024, 640, 2, "silu", "float32",
     False),
    ("g4_cpg10_4095x40_mod_bf16", 4, 4095, 40, 4, "mod", "bfloat16", False),
    ("rowwise_c36_g4_mod_bf16", 2, 4096, 36, 4, "mod", "bfloat16", False),
    ("rowwise_past_cluster_65536x320_mod_bf16", 2, 65536, 320, 32, "mod",
     "bfloat16", False),
    ("rowwise_misaligned_1024x640_silu_bf16", 4, 1024, 640, 32, "silu",
     "bfloat16", True),
    ("n512_1x256_g64_cpg4_mod_bf16", 512, 1, 256, 64, "mod", "bfloat16",
     False),
    ("n1024_4x512_g512_cpg1_silu_f32", 1024, 4, 512, 512, "silu", "float32",
     False),
)


def _gn_refusals() -> dict:
    """The C entries refuse a cluster plan they cannot run, before any
    launch: a group-set of more groups than the block has threads (the
    statistics are written one group a thread; at ``[512, 1, 256]`` bf16,
    G 64, 64 groups a set over 32 threads), and a plan whose shared
    memory is not the kernels' own layout.  Each must raise."""
    from paddle_ray_tpu_torch.ops import groupnorm as gn
    n, rows, c, groups = 512, 1, 256, 64
    x, w, b, _, _, _ = _gn_inputs(n, rows, c, False, torch.bfloat16)
    y = torch.empty_like(x)
    mu = torch.empty(n, groups, device="cuda")
    rs = torch.empty_like(mu)
    plan = gn.group_norm_plan(n, rows, c, groups, torch.bfloat16)
    wide = gn._cluster_plan(rows, c // groups, 2, False, 64, 1)
    bad = {"groups_over_threads": wide,
           "smem_off_layout": plan._replace(smem_bytes=plan.smem_bytes + 16)}
    out = {}
    for name, p in bad.items():
        try:
            gn._launch("fused_group_norm", "prt_group_norm_fwd", x.device,
                       x.data_ptr(), w.data_ptr(), b.data_ptr(), None, None,
                       y.data_ptr(), mu.data_ptr(), rs.data_ptr(), n, rows,
                       c, groups, GN_EPS, 0, 1, 1, 0, *gn._plan_args(p, x))
        except RuntimeError:
            out[name] = "refused"
            continue
        raise AssertionError(f"group norm plan {p} ({name}) was launched")
    if wide.groups_per_set <= wide.threads:
        raise AssertionError(f"{wide} is not a plan to refuse")
    return out


def phase_gn_kernel() -> dict:
    """The UNet step's (rows, C, mode) calls at batch 32 in bfloat16,
    timed; the other modes at the step's shapes, checked; then
    ``GN_EXTRA_CASES`` (the float32 ones timed)."""
    calls = unet_gn_calls()
    step_cases = sorted(set(calls), key=lambda k: (-k[0], k[1], k[2]))
    shapes = sorted({(rows, c) for rows, c, _ in calls}, reverse=True)
    groups = UNET_CFG["groups"]
    bf16 = torch.bfloat16
    results = {}
    for rows, c, mode in step_cases:
        results[(rows, c, mode)] = _gn_case(
            f"unet_{rows}x{c}_{mode}_bf16", UNET_BATCH, rows, c, groups,
            mode, bf16, timed=True)
    for rows, c in shapes:
        for mode in GN_MODES:
            if (rows, c, mode) not in results:
                _gn_case(f"unet_{rows}x{c}_{mode}_bf16", UNET_BATCH, rows, c,
                         groups, mode, bf16, timed=False)
    routes = set()
    for name, n, rows, c, g, mode, dtype, misalign in GN_EXTRA_CASES:
        dt = getattr(torch, dtype)
        r = _gn_case(name, n, rows, c, g, mode, dt,
                     timed=dt == torch.float32, misalign=misalign)
        routes |= {r["fwd"]["route"], r["bwd"]["route"]}
    if routes != {"cluster", "rowwise"}:
        raise AssertionError(f"group norm cases took routes {routes}")
    emit("gn_plan_refusals", **_gn_refusals())
    # the step's 56 calls of each kernel, summed
    step = {kind: {k: sum(results[call][kind][k] for call in calls)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for kind in ("fwd", "bwd")}
    emit("gn_kernel_step", calls_per_step=len(calls),
         distinct_shapes=len(shapes), distinct_cases=len(step_cases),
         **step)
    return {"cases": results, "step": step, "calls": len(calls)}


# ---------------------------------------------------------------------------
# 16. the fused dropout-add-LayerNorm kernels against their plain versions
# ---------------------------------------------------------------------------
def _dal_bound(kind, rows, h, dtype, dh2) -> dict:
    """The least time: bytes -- forward x and residual read, y and h
    written; backward h, dy (and dh2 when given) read, dx and dres
    written; each once, plus the parameters, the row statistics and the
    float32 dweight / dbias -- over the HBM rate, against the float32
    operations a pass does per element (forward 10, backward 16; the hash
    is integer work, not counted) over the float32 CUDA-core peak; the
    larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    elems = rows * h
    if kind == "fwd":
        n_bytes = 4 * elems * es + 2 * h * es + 2 * rows * 4
        ops = 10 * elems
    else:
        n_bytes = ((4 + int(dh2)) * elems * es + h * es + 2 * rows * 4
                   + 2 * h * 4)
        ops = 16 * elems
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _dal_case(name, rows, h, dtype, p, training, dh2, timed) -> dict:
    """One case: the kernels against the plain versions on the same inputs
    (the backward from the plain forward's h and statistics), the keep
    mask bit for bit, and with ``timed`` each kernel timed beside its
    bound, the plain version and ``torch.nn.functional.layer_norm`` on h
    (the nearest library call: LayerNorm alone; bwd its autograd
    backward)."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.fused import (
        dal_backward, dal_backward_plain, dal_forward, dal_forward_plain,
        keep_mask_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + rows)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x, res, dy = (r(rows, h).to(dtype) for _ in range(3))
    d2 = r(rows, h).to(dtype) if dh2 else None
    w, b = (1.0 + 0.2 * r(h)).to(dtype), (0.2 * r(h)).to(dtype)
    kw = dict(p=p, training=training)
    out = dal_forward(x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw)
    out_again = dal_forward(x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw)
    torch.cuda.synchronize()
    fwd_same_bits = all(torch.equal(a, b) for a, b in zip(out, out_again))
    ref = dal_forward_plain(x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw)
    bwd = (ref[1], ref[2], ref[3], w, dy, d2, DAL_SEED)
    got = dal_backward(*bwd, **kw)
    again = dal_backward(*bwd, **kw)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    want = dal_backward_plain(*bwd, **kw)
    tol = TOL[dtype]
    # bfloat16: atol plus one rounding step of the output type
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    fwd_err = max(float((a.float() - e.float()).abs().max())
                  for a, e in zip(out[:2], ref[:2]))
    stat_err = max(float((a - e).abs().max())
                   for a, e in zip(out[2:], ref[2:]))
    bwd_rel = {k: _rel_err(a, e) for k, a, e in zip(
        ("dx", "dres", "dweight", "dbias"), got, want)}
    bwd_abs = max(float((a.float() - e.float()).abs().max())
                  for a, e in zip(got, want))
    mask_same = None
    if training and p > 0.0:
        ones = torch.ones(rows, h, dtype=dtype, device="cuda")
        hm = dal_forward(ones, torch.zeros_like(ones),
                         torch.ones(h, dtype=dtype, device="cuda"),
                         torch.zeros(h, dtype=dtype, device="cuda"),
                         DAL_SEED, epsilon=DAL_EPS, **kw)[1]
        keep = keep_mask_plain((rows, h), p, DAL_SEED, device="cuda")
        mask_same = bool(torch.equal(hm != 0, keep != 0))
    finite = all(bool(torch.isfinite(a).all()) for a in (*out, *got))
    if not (finite and mask_same is not False and same_bits and fwd_same_bits
            and all(torch.allclose(a.float(), e.float(), rtol=rtol, atol=tol)
                    for a, e in zip(out[:2], ref[:2]))
            and stat_err <= 1e-4 and max(bwd_rel.values()) <= tol):
        raise AssertionError(
            f"dal {name}: kernel vs plain: forward max_abs_err {fwd_err}, "
            f"statistics {stat_err}, gradients rel_err {bwd_rel} (tolerance "
            f"{tol}), mask bit-identical {mask_same}, the same bits in two "
            f"calls: forward {fwd_same_bits}, backward {same_bits}")
    out_r = {"fwd": {"max_abs_err": fwd_err, "stat_err": stat_err,
                     **_dal_bound("fwd", rows, h, dtype, dh2)},
             "bwd": {"max_abs_err": bwd_abs, "rel_err": bwd_rel,
                     **_dal_bound("bwd", rows, h, dtype, dh2)}}
    if timed:
        hh = ref[1]
        lib_fwd = time_ms(lambda: F.layer_norm(hh, (h,), w, b, DAL_EPS))
        leaves = [a.detach().requires_grad_() for a in (hh, w, b)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            F.layer_norm(leaves[0], (h,), leaves[1], leaves[2], DAL_EPS),
            leaves, dy))
        # its backward alone, on a graph built once (the difference above,
        # which earlier runs reported, subtracts one timing floor too many)
        y_lib = F.layer_norm(leaves[0], (h,), leaves[1], leaves[2], DAL_EPS)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            y_lib, leaves, dy, retain_graph=True))
        out_r["fwd"].update(
            ms=time_ms(lambda: dal_forward(x, res, w, b, DAL_SEED,
                                           epsilon=DAL_EPS, **kw)),
            plain_ms=time_ms(lambda: dal_forward_plain(
                x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw), iters=5),
            library_ms=lib_fwd)
        out_r["bwd"].update(
            ms=time_ms(lambda: dal_backward(*bwd, **kw)),
            plain_ms=time_ms(lambda: dal_backward_plain(*bwd, **kw),
                             iters=5),
            library_ms=lib_bwd,
            library_fwd_bwd_minus_fwd_ms=lib_fwd_bwd - lib_fwd)
    emit("dal_kernel", case=name, shape=[rows, h], dtype=str(dtype), p=p,
         training=training, dh2=dh2, tol=tol, rtol=rtol,
         mask_bit_identical=mask_same, fwd_same_bits_twice=fwd_same_bits,
         bwd_same_bits_twice=same_bits,
         timed=timed,
         library="torch.nn.functional.layer_norm on h: LayerNorm alone, "
                 "without the dropout or the residual add (bwd: its "
                 "autograd backward on a graph built once)", **out_r)
    return out_r


# (name, rows, H, dtype, p, training, h's cotangent, timed): the fused
# encoder's shape [8 x 512, 1024] first (bf16, p 0.1, training, no
# cotangent of h: its main path), the other modes, float32, odd row
# counts; then the widths BERT-base (768) and 8192 (the kernels' widest)
# and rows not a whole number of 16-byte vectors (element loads)
DAL_CASES = (
    ("encoder_bf16_p0.1", 4096, ENC_D, "bfloat16", ENC_RATE, True, False,
     True),
    ("bf16_p0.1_dh2", 4096, ENC_D, "bfloat16", ENC_RATE, True, True, False),
    ("bf16_p0_dh2", 4096, ENC_D, "bfloat16", 0.0, True, True, False),
    ("bf16_eval", 4096, ENC_D, "bfloat16", ENC_RATE, False, False, False),
    ("f32_p0.1_dh2", 4096, ENC_D, "float32", ENC_RATE, True, True, True),
    ("f32_eval", 4096, ENC_D, "float32", ENC_RATE, False, True, False),
    ("odd_rows_bf16_p0.1", 4093, ENC_D, "bfloat16", ENC_RATE, True, True,
     False),
    ("odd_rows_f32_p0.1", 7, ENC_D, "float32", ENC_RATE, True, True, False),
    ("h768_bf16_p0.1", 4096, 768, "bfloat16", ENC_RATE, True, False, True),
    ("h8192_bf16_p0.1", 4096, 8192, "bfloat16", ENC_RATE, True, False,
     True),
    ("h8192_f32_p0.1_dh2", 515, 8192, "float32", ENC_RATE, True, True,
     True),
    ("h1020_bf16_p0.1_dh2", 4096, 1020, "bfloat16", ENC_RATE, True, True,
     True),
    ("h1022_f32_p0.1", 45, 1022, "float32", ENC_RATE, True, False, True),
)


def phase_dal_kernel() -> dict:
    """Every case of ``DAL_CASES``; the encoder's is the main path's."""
    assert ENC_BATCH * ENC_SEQ == DAL_CASES[0][1]
    results = {}
    for name, n, h, dtype, p, training, dh2, timed in DAL_CASES:
        results[name] = _dal_case(name, n, h, getattr(torch, dtype), p,
                                  training, dh2, timed)
    return results


# ---------------------------------------------------------------------------
# 16b. the dropout kernel against its plain version
# ---------------------------------------------------------------------------
def _dropout_bound(n, dtype) -> dict:
    """The least time: x read and y written once over the HBM rate,
    against ``DROPOUT_INT_OPS`` int32 operations an element over the
    card's int32 rate; the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes, ops = 2 * n * es, DROPOUT_INT_OPS * n
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


# (name, shape, dtype, p, offset in elements of x into its buffer, timed):
# the recipe's dropout shape [8, 1024, 1024] (batch 8 of seq 1024 at width
# 1024) in bf16 at p 0.1 first, float32, p 0.5, a size no whole number of
# 16-byte vectors, and a view 4 bytes into its buffer (element loads)
DROPOUT_CASES = (
    ("recipe_bf16_p0.1", (8, 1024, 1024), "bfloat16", 0.1, 0, True),
    ("f32_p0.1", (8, 1024, 1024), "float32", 0.1, 0, True),
    ("bf16_p0.5", (8, 1024, 1024), "bfloat16", 0.5, 0, True),
    ("odd_bf16_p0.1", (3, 1000, 1001), "bfloat16", 0.1, 0, True),
    ("odd_view_f32_p0.1", (3, 1000, 1001), "float32", 0.1, 1, True),
)


def _dropout_case(name, shape, dtype, p, offset, timed) -> dict:
    """The kernel against ``dropout_plain`` bit for bit: forward, the same
    bits in two calls, and the autograd backward (the kernel on dy)
    against the plain version of dy; with ``timed``, the kernel beside its
    bound, the plain version and ``torch.nn.functional.dropout`` (the same
    work with other random bits: PyTorch's Philox)."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.ops.dropout import (dropout, dropout_plain,
                                                  threefry_dropout)
    n = int(np.prod(shape))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + n)
    buf = torch.randn(n + offset, generator=g, device="cuda").to(dtype)
    x = buf[offset:].view(shape)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    key = prng.fold_in(prng.PRNGKey(SEED), n)
    y = threefry_dropout(x, key, p)
    again = threefry_dropout(x, key, p)
    leaf = x.detach().requires_grad_()
    y_ad = dropout(leaf, key, p)
    y_ad.backward(dy)
    torch.cuda.synchronize()
    ref, ref_dx = dropout_plain(x, key, p), dropout_plain(dy, key, p)
    same = {"fwd": bool(torch.equal(y, ref)),
            "twice": bool(torch.equal(y, again)),
            "autograd_fwd": bool(torch.equal(y_ad, ref)),
            "bwd": bool(torch.equal(leaf.grad, ref_dx))}
    err = max(float((y.float() - ref.float()).abs().max()),
              float((leaf.grad.float() - ref_dx.float()).abs().max()))
    if not all(same.values()):
        raise AssertionError(f"dropout {name}: kernel vs plain, bit for "
                             f"bit: {same}, max_abs_err {err}")
    out = {"max_abs_err": err, "keep_share": float((ref != 0).float().mean()),
           **_dropout_bound(n, dtype)}
    if timed:
        out.update(ms=time_ms(lambda: threefry_dropout(x, key, p)),
                   plain_ms=time_ms(lambda: dropout_plain(x, key, p),
                                    iters=5),
                   library_ms=time_ms(lambda: F.dropout(x, p)))
    emit("dropout_kernel", case=name, shape=list(shape), dtype=str(dtype),
         p=p, offset=offset, bit_identical=same,
         library="torch.nn.functional.dropout: the same work with other "
                 "random bits (Philox)", **out)
    return out


def phase_dropout_kernel() -> dict:
    """Every case of ``DROPOUT_CASES``; the first is the recipe's."""
    return {name: _dropout_case(name, shape, getattr(torch, dtype), p, off,
                                timed)
            for name, shape, dtype, p, off, timed in DROPOUT_CASES}


# ---------------------------------------------------------------------------
# 6. the serving path: gpt3-350m
# ---------------------------------------------------------------------------
def bench_serving_workload(span: int):
    """``bench.py:bench_serving``'s mixed-length workload: 11 short chats
    and one long document, ``(prompt_len, max_new)`` pairs."""
    r = np.random.RandomState(0)
    return ([(int(t0), int(n)) for t0, n in zip(
        r.randint(span // 16, span // 8, 11),
        r.randint(span // 16, span // 8, 11))]
        + [(span // 2 + span // 4, span // 8)])


def phase_serve(model, phase="serve", name=MODEL) -> dict:
    """``bench_serving_workload``'s requests, greedy, over a pool in the
    model's dtype (page 64, ``max_batch`` 8): ``serve`` is gpt3-350m,
    ``serve_760m`` gpt3-760m (head dim 96)."""
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    workload = bench_serving_workload(cfg.max_seq_len)
    eng = ServingEngine(model, page_size=PAGE, max_batch=MAX_BATCH,
                        device=model.device)
    r = np.random.RandomState(1)
    torch.cuda.reset_peak_memory_stats()
    paged_ragged_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(r.randint(0, cfg.vocab_size, (t,)), n)
            for t, n in workload]
    out = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_ragged_attention.launches
    for rid, (_, n) in zip(rids, workload):
        if len(out[rid]) != n:
            raise AssertionError(f"request {rid} returned {len(out[rid])} "
                                 f"tokens, wanted {n}")
    st = eng.stats.to_dict()
    if launches == 0 or launches != cfg.num_layers * st["mixed_steps"]:
        raise AssertionError(f"paged_ragged_attention launched {launches} "
                             f"times in {st['mixed_steps']} steps of "
                             f"{cfg.num_layers} layers")
    fields = {k: st[k] for k in (
        "decode_tokens_per_s", "prefill_tokens_per_s", "p50_token_ms",
        "p99_token_ms", "mixed_steps", "decode_tokens", "prefill_tokens",
        "prefix_hit_tokens", "timed_decode_tokens", "timed_prefill_tokens",
        "decode_s", "prefill_s")}
    emit(phase, model=name, dtype=str(model.dtype),
         head_dim=cfg.hidden_size // cfg.num_heads, requests=len(rids),
         workload=workload, launches=launches, wall_s=round(wall_s, 3),
         peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
         pool=eng.pool_stats(), **fields)
    return {"launches": launches, **fields}


# ---------------------------------------------------------------------------
# 7. correctness of the serving path on the card
# ---------------------------------------------------------------------------
def phase_check(model) -> None:
    """Two requests through an engine on a float32 copy of the weights
    against greedy decoding that recomputes plain ``GPT.forward`` at every
    step.  Tokens must agree up to the first step where the reference's
    top-2 logit gap is below 1e-3 (there a 1-ulp difference may flip the
    argmax)."""
    from paddle_ray_tpu_torch.serving import ServingEngine
    m32 = copy.deepcopy(model).float()
    r = np.random.RandomState(2)
    prompts = [r.randint(0, m32.cfg.vocab_size, (n,)) for n in (40, 100)]
    new = 16
    eng = ServingEngine(m32, page_size=PAGE, max_batch=MAX_BATCH,
                        device=m32.device)
    rids = [eng.submit(p, new) for p in prompts]
    out = eng.run()
    report = []
    for rid, p in zip(rids, prompts):
        ids = torch.tensor(p, dtype=torch.long, device=m32.device)[None]
        ref, tie_at = [], None
        with torch.no_grad():
            for step in range(new):
                logits = m32(ids)[0, -1].float()
                top2 = torch.topk(logits, 2).values
                if tie_at is None and float(top2[0] - top2[1]) < 1e-3:
                    tie_at = step
                tok = int(torch.argmax(logits))
                ref.append(tok)
                ids = torch.cat([ids, ids.new_tensor([[tok]])], dim=1)
        upto = new if tie_at is None else tie_at
        got = [int(t) for t in out[rid]]
        if len(got) != new or got[:upto] != ref[:upto]:
            raise AssertionError(f"request {rid}: engine {got} vs plain "
                                 f"GPT.forward {ref} (near tie at {tie_at})")
        report.append({"rid": rid, "prompt_tokens": len(p),
                       "equal_tokens": upto, "near_tie_at": tie_at})
    emit("check", dtype="float32", requests=report)
    del eng, m32


def _check_model(name, max_seq_len=512):
    """A 4-layer float32 model of ``name``'s width, random from a seed."""
    from paddle_ray_tpu_torch.models import build_gpt
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    return build_gpt(name, device="cuda", dtype=torch.float32, num_layers=4,
                     max_seq_len=max_seq_len, generator=g)


def phase_check_760m() -> None:
    """A 4-layer float32 model of gpt3-760m's width (head dim 96): two
    requests served greedily over a float32 pool against greedy
    ``generate()`` on each prompt (the dense decode kernel), equal up to a
    step where the reference's top-2 logit gap is below ``CHECK_TIE``;
    both paths must have launched their kernels at head dim 96."""
    from paddle_ray_tpu_torch.models import generate
    from paddle_ray_tpu_torch.ops.decode_attention import (
        fused_decode_attention)
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    from paddle_ray_tpu_torch.serving import ServingEngine
    model = _check_model(M760)
    r = np.random.RandomState(SEED + 3)
    prompts = [r.randint(0, model.cfg.vocab_size, (n,)) for n in (40, 100)]
    new = 16
    paged_ragged_attention.launches = fused_decode_attention.launches = 0
    eng = ServingEngine(model, page_size=PAGE, max_batch=MAX_BATCH,
                        device=model.device)
    rids = [eng.submit(p, new) for p in prompts]
    out = eng.run()
    report = []
    for rid, p in zip(rids, prompts):
        ids = torch.tensor(p, dtype=torch.long, device="cuda")[None]
        want = generate(model, ids, new)
        got = torch.cat([ids, torch.as_tensor(
            np.asarray(out[rid]), dtype=torch.long, device="cuda")[None]], 1)
        report.append({"prompt_tokens": len(p), **_same_tokens(
            f"serve vs generate (gpt3-760m width, prompt {len(p)})", model,
            got, want, len(p))})
    launches = {"paged_ragged_attention": paged_ragged_attention.launches,
                "fused_decode_attention": fused_decode_attention.launches}
    if not all(launches.values()):
        raise AssertionError(f"check_760m: kernels not launched {launches}")
    emit("check_760m", model=M760, layers=4, dtype="float32",
         head_dim=model.cfg.hidden_size // model.cfg.num_heads,
         tie=CHECK_TIE, requests=report, launches=launches)
    del eng, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 10d-10h. the serving engine's lifecycle, speculation, async dispatch,
# prefix cache and fault containment: gpt3-350m at full width, bf16
# ---------------------------------------------------------------------------
# near ties of served bf16 tokens: the gap in the reference's
# teacher-forced float32-head logits (over an int8 pool, the paged pass
# through one, which sees the pool's quantization; for a sampled token
# _sampled_margin) below which two runs may part.  bf16 GEMMs tile by row
# count and the served logits are bf16 (an ulp of 0.016 at this width's
# logits), so the same token's logits move between step shapes by a few
# hundredths: over an int8 pool, sync against async, by at most 0.0424
# (1,139 sampled positions) on an NVIDIA H100 80GB HBM3, 700.00 W, as over
# a bf16 pool, so both take 0.1
SERVE_TIE = {"model": 0.1, "int8": 0.1}
# the int8 tie's teacher-forced paged pass takes the engine's default
# prefill chunk
PAGED_TIE_CHUNK = 2 * PAGE
# bench.py:bench_serving_spec's workload: 8 prompts of 16 tokens from
# RandomState(3), 128 new tokens, max_batch 4, spec_k 4, n-gram drafts
SPEC_REQUESTS, SPEC_PROMPT, SPEC_NEW, SPEC_BATCH, SPEC_K = 8, 16, 128, 4, 4
# bench.py:bench_serving_prefix's workload: 8 requests of one 512-token
# prefix and 16-token suffixes, 16 new tokens, max_batch 4, warmed by one
PREFIX_REQUESTS, PREFIX_LEN, PREFIX_SUFFIX, PREFIX_NEW = 8, 512, 16, 16
# steady decode steps timed and profiled by serve_async
ASYNC_WINDOW = 16
# serve_lifecycle's long request and its deadline: past ten steps of it,
# well short of its LIFE_NEW tokens
LIFE_NEW, LIFE_DEADLINE_S = 64, 2.0


def _paged_counts() -> dict:
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    return {"model": paged_ragged_attention.launches,
            "int8": paged_ragged_attention.launches_q8}


def _reset_paged() -> None:
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    paged_ragged_attention.launches = paged_ragged_attention.launches_q8 = 0


def _check_launches(name, eng, kv="model") -> int:
    """The paged kernel (of the pool's kind, and no other) launched once a
    layer in every dispatched step."""
    got = _paged_counts()
    want = eng.model.cfg.num_layers * eng.stats.mixed_steps
    other = got["int8" if kv == "model" else "model"]
    if got[kv] == 0 or got[kv] != want or other:
        raise AssertionError(f"{name}: paged kernel launches {got} in "
                             f"{eng.stats.mixed_steps} steps, want {want} "
                             f"({kv} pool)")
    return got[kv]


def _sampled_scores(logits, positions, kw):
    """``sample_tokens``'s perturbed scores for rows ``logits [T, V]`` at
    their positions, for the request's sampling keywords."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models.generation import fold_sample_keys
    t, v = logits.shape
    lg = logits.float() / kw["temperature"]
    if kw.get("top_k"):
        kth = torch.sort(lg, dim=-1, descending=True).values[
            :, kw["top_k"] - 1:kw["top_k"]]
        lg = torch.where(lg < kth, torch.full((), float("-inf"),
                                              device=lg.device), lg)
    if kw.get("top_p", 1.0) < 1.0:
        desc = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
        idx = (cum < kw["top_p"]).sum(-1).clamp(max=v - 1)
        cut = torch.gather(desc, -1, idx[:, None])
        lg = torch.where(lg < cut, torch.full((), float("-inf"),
                                              device=lg.device), lg)
    seeds = torch.full((t,), kw["seed"] & 0xFFFFFFFF, dtype=torch.int64,
                       device=lg.device)
    return prng.gumbel(fold_sample_keys(seeds, positions), (v,)) + lg


class _Float32Head:
    """``model`` with its LM head in float32: the teacher-forced paged
    pass reads float32 logits, where bf16 ones (an ulp of 0.016 at this
    width's scale) would tie often."""

    class _Head:
        def __init__(self, head, dtype):
            self.norm, self.proj, self.dtype = head.norm, head.proj, dtype

        def __call__(self, h, embed_weight):
            hn = self.norm(h).float()
            return (hn @ embed_weight.float().T if self.proj is None
                    else self.proj(hn.to(self.dtype)).float())

    def __init__(self, model):
        self.model = model
        self.head = self._Head(model.head, model.dtype)

    def __getattr__(self, name):
        return getattr(self.model, name)


def _paged_int8_logits(model, seq) -> torch.Tensor:
    """Float32-head logits ``[len(seq), V]`` of one teacher-forced pass of
    ``seq`` through ``paged_mixed_step`` over a fresh int8 pool (page
    ``PAGE``, chunks of ``PAGED_TIE_CHUNK`` rows): the blocks and the
    paged kernel as the int8-pool engine runs them, every key and value
    through the pool's int8 quantization.  The pass's paged launches are
    taken back out of the counters."""
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    from paddle_ray_tpu_torch.serving import PagePool, paged_mixed_step
    cfg, dev = model.cfg, model.device
    saved = _paged_counts()
    n = len(seq)
    pool = PagePool(cfg.num_layers, 1 + -(-n // PAGE), PAGE, cfg.num_heads,
                    cfg.head_dim, quantized=True, device=dev)
    table = torch.tensor([pool.alloc(-(-n // PAGE))], dtype=torch.int32,
                         device=dev)
    toks = torch.as_tensor(np.asarray(seq), dtype=torch.long, device=dev)
    out = []
    with torch.no_grad():
        for start in range(0, n, PAGED_TIE_CHUNK):
            end = min(n, start + PAGED_TIE_CHUNK)
            c = end - start
            _, logits = paged_mixed_step(
                _Float32Head(model), toks[None, start:end],
                torch.arange(start, end, device=dev)[None],
                torch.tensor([c], dtype=torch.int32, device=dev),
                torch.tensor([end], dtype=torch.int32, device=dev), table,
                pool.arrays, host_lengths=[end], all_logits=True)
            out.append(logits[0])
    paged_ragged_attention.launches = saved["model"]
    paged_ragged_attention.launches_q8 = saved["int8"]
    return torch.cat(out)


def _reference_logits(model, prompt, want, paged_int8=False):
    """The float32-head logits ``[len(want), V]`` that predict each new
    token of ``want`` in one teacher-forced pass over ``prompt`` and
    ``want``: ``GPT.forward`` (the blocks in the model's dtype), or with
    ``paged_int8`` the paged pass over an int8 pool
    (:func:`_paged_int8_logits`)."""
    seq = np.concatenate([prompt, want[:-1]])
    if paged_int8:
        return _paged_int8_logits(model, seq)[len(prompt) - 1:]
    ids = torch.as_tensor(seq, dtype=torch.long, device=model.device)[None]
    with torch.no_grad():
        h, _ = model._hidden_states(ids)
        hn = model.head.norm(h[0, len(prompt) - 1:]).float()
        w = model._embed_weight()
        return (hn @ w.float().T if model.head.proj is None
                else model.head.proj(hn.to(model.dtype)).float())


def _sampled_margin(row, token, position, kw, tie) -> float:
    """How far the scores of one sampled position would have to move for
    ``token`` to be drawn, in ``sample_tokens``'s score units (logits /
    temperature + Gumbel noise), under a move of every scaled logit by at
    most ``tie / 2``.  The top-k and top-p cuts keep the tokens at or
    above a threshold value (the k-th largest; the value where the
    nucleus's mass reaches top_p), so such a move shifts a threshold by up
    to ``tie / 2`` and the nucleus's masses by a factor up to
    ``e^(+-tie)``: a token that may fall on either side of a threshold is
    possibly kept, one clear of both surely kept.  The margin is infinite
    when ``token`` cannot be kept, else the lead of the best surely kept
    other token over it (0 if none leads).  A top-2 gap of the scores
    after the cuts misses a parting where the runs' cuts differ: a tail
    token at a threshold, drawn by its Gumbel noise."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models.generation import fold_sample_keys
    lg = row.float() / kw["temperature"]
    half = tie / 2
    desc = torch.sort(lg, descending=True).values
    keep_lo = keep_hi = torch.tensor(float("-inf"), device=lg.device)
    n = lg.numel()
    if kw.get("top_k"):
        kth = desc[kw["top_k"] - 1]
        keep_lo, keep_hi = kth - half, kth + half
        n = int((lg >= kth).sum())
    if kw.get("top_p", 1.0) < 1.0:
        c = torch.cumsum(torch.softmax(desc[:n], -1), -1)
        e = float(np.exp(tie))
        lo, hi = c / (c + (1 - c) * e), c / (c + (1 - c) / e)
        cut_few = min(int((hi < kw["top_p"]).sum()), n - 1)
        cut_many = min(int((lo < kw["top_p"]).sum()), n - 1)
        keep_lo = torch.maximum(keep_lo, desc[cut_many] - half)
        keep_hi = torch.maximum(keep_hi, desc[cut_few] + half)
    if lg[token] + half < keep_lo:
        return float("inf")
    seeds = torch.tensor([kw["seed"] & 0xFFFFFFFF], dtype=torch.int64,
                         device=lg.device)
    pos = torch.tensor([position], device=lg.device)
    scores = prng.gumbel(fold_sample_keys(seeds, pos), (lg.numel(),))[0] + lg
    surely = lg - half >= keep_hi
    surely[token] = False
    if not bool(surely.any()):
        return 0.0
    return max(0.0, float(scores[surely].max() - scores[token]))


def _near_tie_equal(name, model, prompt, got, want, tie, kw=None,
                    paged_int8=False) -> dict:
    """Two runs' tokens of one request must be equal, or part only at a
    near tie of the reference run ``want``: the first new token where they
    differ must lie within ``tie`` in the reference's teacher-forced
    logits (:func:`_reference_logits`; over an int8 pool,
    ``paged_int8``, the paged pass through that pool) -- for a greedy
    token a top-2 gap below ``tie``, for a sampled one a
    :func:`_sampled_margin` below it for the token of each run.  Reports
    the tokens equal, the first position whose top-2 gap (of the scores
    after the cuts, if it samples) is below ``tie``, and the gap where the
    runs part (the larger of the two margins, each also reported, if it
    samples; and there the top-2 gap, and over an int8 pool
    ``GPT.forward``'s top-2 gap, which does not see the pool)."""
    got, want = np.asarray(got), np.asarray(want)
    logits = _reference_logits(model, prompt, want, paged_int8)
    pos = torch.arange(len(prompt), len(prompt) + len(want),
                       device=model.device)
    scores = _sampled_scores(logits, pos, kw) if kw else logits
    top2 = torch.topk(scores, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    ties = np.nonzero(gaps < tie)[0]
    out = {"equal_tokens": len(want),
           "first_tie": int(ties[0]) if len(ties) else None,
           "gap_where_parted": None}
    if paged_int8:
        out["min_top2_gap"] = float(gaps.min())
    n = min(len(got), len(want))
    diffs = np.nonzero(got[:n] != want[:n])[0]
    if len(diffs) == 0 and len(got) == len(want):
        return out
    j = int(diffs[0]) if len(diffs) else n
    gap = None
    if j < len(gaps):
        if kw:
            # both runs' tokens are held to the teacher's scores: a run
            # that drew a token no near tie explains fails, whichever it is
            margins = [_sampled_margin(logits[j], int(t[j]),
                                       len(prompt) + j, kw, tie)
                       if j < len(t) else float("inf")
                       for t in (got, want)]
            out.update(margin_got=margins[0], margin_want=margins[1])
            gap = max(margins)
        else:
            gap = float(gaps[j])
        out["top2_gap_where_parted"] = float(gaps[j])
        if paged_int8:
            fwd = _reference_logits(model, prompt, want)
            fs = _sampled_scores(fwd, pos, kw) if kw else fwd
            f2 = torch.topk(fs[j], 2).values
            out["forward_top2_gap_where_parted"] = float(f2[0] - f2[1])
    if gap is None or gap >= tie:
        raise AssertionError(
            f"{name}: tokens part at new token {j} where the reference's "
            f"gap is {gap} (a near tie is below {tie}): "
            f"{got[max(j - 2, 0):j + 3]} vs {want[max(j - 2, 0):j + 3]}")
    out.update(equal_tokens=j, gap_where_parted=gap)
    return out


def _serve_stats(eng) -> dict:
    st = eng.stats.to_dict()
    return {k: st[k] for k in (
        "decode_tokens_per_s", "prefill_tokens_per_s", "p50_token_ms",
        "p99_token_ms", "mixed_steps", "decode_tokens", "prefill_tokens",
        "prefix_hit_tokens", "draft_tokens", "accepted_tokens",
        "acceptance_rate", "step_failures", "retries_total",
        "preempted_total")}


def _all_ok(name, eng) -> None:
    """Every request ended OK, with no step failure."""
    bad = {r: s.status for r, s in eng.request_stats.items()
           if s.status != "OK"}
    if bad or eng.stats.step_failures:
        raise AssertionError(f"{name}: statuses {bad}, step failures "
                             f"{eng.stats.step_failures}")


def phase_serve_spec(model) -> dict:
    """``bench.py:bench_serving_spec``'s workload with speculation off and
    on; tokens equal, or parted only at a near tie; then a 4-layer
    float32 model of the same width, speculation on, against greedy
    ``generate()`` up to ``CHECK_TIE``."""
    from paddle_ray_tpu_torch.models import generate
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    r = np.random.RandomState(3)
    prompts = [r.randint(0, cfg.vocab_size, (SPEC_PROMPT,))
               for _ in range(SPEC_REQUESTS)]
    chunk = min(2 * PAGE, cfg.max_seq_len)
    budget = SPEC_BATCH * (SPEC_K + 1) + chunk

    def drive(m, spec, prompts, new):
        eng = ServingEngine(m, page_size=PAGE, max_batch=SPEC_BATCH,
                            prefix_cache=False, chunk_size=chunk,
                            token_budget=budget, spec_k=SPEC_K,
                            spec_decode="ngram" if spec else None,
                            device=m.device)
        _reset_paged()
        t0 = time.perf_counter()
        rids = [eng.submit(p, new) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _all_ok("serve_spec", eng)
        launches = _check_launches("serve_spec", eng)
        return eng, [out[i] for i in rids], launches, wall

    runs, outs, launches = {}, {}, 0
    for spec in (False, True):
        name = "spec_on" if spec else "spec_off"
        eng, outs[name], n, wall = drive(model, spec, prompts, SPEC_NEW)
        launches += n
        runs[name] = {**_serve_stats(eng), "launches": n,
                      "wall_s": round(wall, 3),
                      "executables": eng.executable_count}
    agree = [_near_tie_equal(f"serve_spec request {i}", model, p, a, b,
                             SERVE_TIE["model"])
             for i, (p, a, b) in enumerate(zip(prompts, outs["spec_on"],
                                               outs["spec_off"]))]
    if runs["spec_on"]["draft_tokens"] == 0:
        raise AssertionError("serve_spec: speculation drafted nothing")
    # float32, 4 layers: spec on against greedy generate()
    m32 = _check_model(MODEL)
    check_prompts = prompts[:3]
    eng32, got32, n32, _ = drive(m32, True, check_prompts, 48)
    launches += n32
    check = []
    for p, got in zip(check_prompts, got32):
        ids = torch.tensor(p, dtype=torch.long, device=m32.device)[None]
        want = generate(m32, ids, 48)
        full = torch.cat([ids, torch.as_tensor(
            np.asarray(got), dtype=torch.long, device=m32.device)[None]], 1)
        check.append(_same_tokens("serve_spec float32 spec vs generate",
                                  m32, full, want, len(p)))
    emit("serve_spec", model=MODEL, dtype=str(model.dtype),
         requests=SPEC_REQUESTS, prompt=SPEC_PROMPT, new_tokens=SPEC_NEW,
         max_batch=SPEC_BATCH, spec_k=SPEC_K, token_budget=budget,
         chunk_size=chunk, draft="ngram", **runs,
         steps_shrunk=round(runs["spec_off"]["mixed_steps"]
                            / max(runs["spec_on"]["mixed_steps"], 1), 3),
         decode_speedup=round(runs["spec_on"]["decode_tokens_per_s"]
                              / max(runs["spec_off"]["decode_tokens_per_s"],
                                    1e-9), 3),
         tie=SERVE_TIE["model"], agreement=agree,
         float32_check={"layers": 4, "tie": CHECK_TIE, "requests": check,
                        "draft_tokens": eng32.stats.draft_tokens,
                        "accepted_tokens": eng32.stats.accepted_tokens})
    del m32, eng32
    torch.cuda.empty_cache()
    return {"model": launches, "int8": 0}


def _instrument(eng, sync_check: bool) -> dict:
    """Count ``_fetch`` calls and run every ``_dispatch`` after the
    engine's first step under ``set_sync_debug_mode("error")`` (a
    host-device sync in it raises); ``_fetch`` runs outside."""
    import types
    calls = {"fetch": 0, "dispatch": 0, "checked": 0}
    dispatch, fetch = type(eng)._dispatch, type(eng)._fetch

    def d(self, *a):
        calls["dispatch"] += 1
        if not sync_check or calls["dispatch"] == 1:
            return dispatch(self, *a)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            calls["checked"] += 1

    def f(self, inf):
        calls["fetch"] += 1
        return fetch(self, inf)

    eng._dispatch = types.MethodType(d, eng)
    eng._fetch = types.MethodType(f, eng)
    return calls


def _steady(eng) -> bool:
    """Every prompt prefilled: the steps are decode only."""
    return not eng.pending and not any(
        s is not None and s.prefilling for s in eng._slots)


def phase_serve_async(model) -> dict:
    """``serve``'s 12 requests with ``async_dispatch`` off and on, over a
    bf16 pool (greedy) and an int8 pool (every other request sampled):
    tokens equal, or parted only at a near tie, one ``_fetch`` per
    dispatched step, the dispatches after the first free of host-device
    syncs; the wall time a step over ``ASYNC_WINDOW`` steps of steady
    decode and, over the bf16 pool, the device's idle share: the device
    time a step of the next ``ASYNC_WINDOW`` steps, under
    ``torch.profiler`` (CUDA activity only), against that wall time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    workload = bench_serving_workload(cfg.max_seq_len)
    r = np.random.RandomState(1)
    prompts = [r.randint(0, cfg.vocab_size, (t,)) for t, _ in workload]
    news = [n for _, n in workload]
    results, launches = {}, {"model": 0, "int8": 0}
    for kv in ("model", "int8"):
        sampling = ([dict(SAMPLED, seed=1000 + i) if i % 2 else {}
                     for i in range(len(workload))] if kv == "int8"
                    else [{}] * len(workload))
        kw = dict(page_size=PAGE, max_batch=MAX_BATCH, kv_cache_dtype=kv,
                  device=model.device)
        outs = {}
        for mode in (False, True):
            name = f"{'async' if mode else 'sync'}"
            eng = ServingEngine(model, async_dispatch=mode, **kw)
            calls = _instrument(eng, sync_check=True)
            _reset_paged()
            rids = [eng.submit(p, n, **s)
                    for p, n, s in zip(prompts, news, sampling)]
            # steady decode: ASYNC_WINDOW steps timed, then (bf16 pool)
            # ASYNC_WINDOW more under torch.profiler for their device time
            per_step, win, prof = [], {}, None
            t0 = time.perf_counter()
            while eng.pending or eng.active or eng._inflight is not None:
                if "first" not in win and _steady(eng):
                    torch.cuda.synchronize()
                    win.update(first=len(per_step), t=time.perf_counter())
                n0 = calls["fetch"]
                eng.step()
                per_step.append(calls["fetch"] - n0)
                done = len(per_step) - win.get("first", len(per_step))
                if done == ASYNC_WINDOW and "wall_ms" not in win:
                    torch.cuda.synchronize()
                    win["wall_ms"] = 1e3 * (time.perf_counter() - win["t"]) \
                        / ASYNC_WINDOW
                    if kv == "model":
                        prof = profile(activities=[ProfilerActivity.CUDA])
                        prof.start()
                elif done == 2 * ASYNC_WINDOW and prof is not None:
                    torch.cuda.synchronize()
                    prof.stop()
                    win["device_ms"] = sum(
                        t for _, t, _ in kernel_rows(prof)) / 1e3 \
                        / ASYNC_WINDOW
                    prof = None
            if prof is not None:            # the run ended inside the window
                prof.stop()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = eng.run()
            _all_ok(f"serve_async {kv} {name}", eng)
            launches[kv] += _check_launches(f"serve_async {kv} {name}", eng,
                                            kv)
            if max(per_step) != 1 or sum(per_step) != eng.stats.mixed_steps:
                raise AssertionError(
                    f"serve_async {kv} {name}: fetches per step "
                    f"{per_step}, {eng.stats.mixed_steps} steps")
            for rid, n in zip(rids, news):
                if len(out[rid]) != n:
                    raise AssertionError(f"serve_async: request {rid} "
                                         f"returned {len(out[rid])} tokens")
            outs[name] = [out[i] for i in rids]
            res = {**_serve_stats(eng), "wall_s": round(wall, 3),
                   "fetches": calls["fetch"],
                   "dispatches_sync_checked": calls["checked"],
                   "steps": len(per_step)}
            if "wall_ms" in win:
                res.update(window_first_step=win["first"],
                           window_wall_ms_per_step=round(win["wall_ms"], 4))
            if "device_ms" in win:
                res.update(
                    window_device_ms_per_step=round(win["device_ms"], 4),
                    window_device_idle_share=round(
                        1.0 - win["device_ms"] / win["wall_ms"], 4))
            results[f"{kv}_{name}"] = res
            del eng
        results[f"{kv}_agreement"] = [
            _near_tie_equal(f"serve_async {kv} request {i}", model, p, a, b,
                            SERVE_TIE[kv], s or None,
                            paged_int8=kv == "int8")
            for i, (p, a, b, s) in enumerate(zip(
                prompts, outs["async"], outs["sync"], sampling))]
    emit("serve_async", model=MODEL, dtype=str(model.dtype),
         requests=len(workload), window_steps=ASYNC_WINDOW, tie=SERVE_TIE,
         sampled_int8=[i for i in range(len(workload)) if i % 2],
         sampling=SAMPLED, **results)
    # the int8 tie's measurements: where sync and async parted over the
    # int8 pool, the gap (for a sampled token the larger margin, each
    # run's beside it: got is async, want sync), the paged pass's and
    # GPT.forward's top-2 gaps there, and each request's smallest paged
    # top-2 gap
    emit("serve_int8_tie", tie=SERVE_TIE["int8"], partings=[
        {"request": i, "sampled": bool(i % 2), "new_token": a["equal_tokens"],
         **{k: a[k] for k in ("gap_where_parted", "top2_gap_where_parted",
                              "forward_top2_gap_where_parted", "margin_got",
                              "margin_want") if k in a}}
        for i, a in enumerate(results["int8_agreement"])
        if a["gap_where_parted"] is not None],
        min_top2_gaps=[a["min_top2_gap"]
                       for a in results["int8_agreement"]])
    torch.cuda.empty_cache()
    return launches


def phase_serve_prefix(model) -> dict:
    """``bench.py:bench_serving_prefix``'s workload with the prefix cache
    on and off (the cache warmed by one extra request): TTFT p50/p99,
    prefill tokens/s, prefix hits (above 0 with the cache on), tokens
    equal, or parted only at a near tie."""
    from paddle_ray_tpu_torch.serving import ServingEngine
    from paddle_ray_tpu_torch.serving.engine import percentile
    cfg = model.cfg
    r = np.random.RandomState(7)
    prefix = r.randint(0, cfg.vocab_size, (PREFIX_LEN,))
    warm = np.concatenate([prefix, r.randint(0, cfg.vocab_size,
                                             (PREFIX_SUFFIX,))])
    prompts = [np.concatenate([prefix, r.randint(0, cfg.vocab_size,
                                                 (PREFIX_SUFFIX,))])
               for _ in range(PREFIX_REQUESTS)]
    runs, outs, launches = {}, {}, 0
    for cache in (True, False):
        name = "cache_on" if cache else "cache_off"
        eng = ServingEngine(model, page_size=PAGE, max_batch=4,
                            prefix_cache=cache, device=model.device)
        _reset_paged()
        eng.submit(warm, PREFIX_NEW)
        eng.run()
        rids = [eng.submit(p, PREFIX_NEW) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        _all_ok("serve_prefix", eng)
        launches += _check_launches("serve_prefix", eng)
        stats = [eng.request_stats[i] for i in rids]
        ttfts = sorted(1e3 * s.ttft_s for s in stats)
        st = eng.stats.to_dict()
        runs[name] = {
            "ttft_p50_ms": round(percentile(ttfts, 0.5), 3),
            "ttft_p99_ms": round(percentile(ttfts, 0.99), 3),
            "prefill_tokens_per_s": st["prefill_tokens_per_s"],
            "prefill_tokens": st["prefill_tokens"],
            "prefix_hit_tokens": sum(s.prefix_hit_tokens for s in stats),
            "mixed_steps": st["mixed_steps"],
            "pool": eng.pool_stats()}
        outs[name] = [out[i] for i in rids]
        if cache and eng.pool.pages_in_use != eng.prefix.cached_pages:
            raise AssertionError("serve_prefix: pages held past drain")
    if runs["cache_on"]["prefix_hit_tokens"] <= 0:
        raise AssertionError("serve_prefix: the cache never hit")
    agree = [_near_tie_equal(f"serve_prefix request {i}", model, p, a, b,
                             SERVE_TIE["model"])
             for i, (p, a, b) in enumerate(zip(prompts, outs["cache_on"],
                                               outs["cache_off"]))]
    emit("serve_prefix", model=MODEL, dtype=str(model.dtype),
         requests=PREFIX_REQUESTS, prefix_len=PREFIX_LEN,
         suffix_len=PREFIX_SUFFIX, new_tokens=PREFIX_NEW, max_batch=4,
         **runs, ttft_p50_speedup=round(
             runs["cache_off"]["ttft_p50_ms"]
             / max(runs["cache_on"]["ttft_p50_ms"], 1e-9), 3),
         tie=SERVE_TIE["model"], agreement=agree)
    return {"model": launches, "int8": 0}


def _drain_queue(q) -> list:
    out = []
    while True:
        t = q.get_nowait()
        if t is None:
            return out
        out.append(int(t))


def _drained(name, eng) -> None:
    """After a drain: pagesan's drain check and books, and every page free
    but those the prefix cache holds."""
    eng.sanitizer.check_drain(eng.prefix.pages() if eng.prefix else ())
    eng.sanitizer.verify_pool()
    held = eng.prefix.cached_pages if eng.prefix else 0
    if eng.pool.pages_in_use != held or eng._inflight is not None:
        raise AssertionError(f"{name}: {eng.pool.pages_in_use} pages in use "
                             f"after drain, the cache holds {held}")


def phase_serve_lifecycle(model) -> dict:
    """With ``sanitize=True``, sync and async: a mid-flight cancel, a
    deadline that expires one request mid-flight and one queued, ``stream``
    queues equal to the drained output and ended by ``None``,
    preempt-and-restore under a pool that forces a priority-1 request to
    preempt, and ``park_all`` with resubmission by ``committed=`` on a
    second engine; outputs equal to uninterrupted runs or parted only at a
    near tie; pagesan's drain check after each drain."""
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    r = np.random.RandomState(SEED + 11)
    tie = SERVE_TIE["model"]
    p_long, p_other, p_vip, p_queued = (
        r.randint(0, cfg.vocab_size, (n,)) for n in (100, 60, 90, 20))
    base = dict(page_size=PAGE, sanitize=True, device=model.device)
    launches = 0

    def ref(p, n):
        eng = ServingEngine(model, page_size=PAGE, max_batch=2,
                            device=model.device)
        rid = eng.submit(p, n)
        return eng.run()[rid]

    want_long, want_other = ref(p_long, LIFE_NEW), ref(p_other, 24)
    want_vip, want_queued = ref(p_vip, 24), ref(p_queued, 8)
    report = {}
    for mode in (False, True):
        tag = "async" if mode else "sync"
        rep = {}
        # cancel mid-flight, streams
        _reset_paged()
        eng = ServingEngine(model, max_batch=4, async_dispatch=mode, **base)
        r1 = eng.submit(p_long, LIFE_NEW, stream=True)
        r2 = eng.submit(p_other, 24, stream=True)
        for _ in range(8):
            eng.step()
        if not eng.cancel(r1):
            raise AssertionError("serve_lifecycle: cancel found nothing")
        out = eng.run()
        st = {i: eng.request_stats[i].status for i in (r1, r2)}
        if (st != {r1: "CANCELLED", r2: "OK"}
                or not 0 < len(out[r1]) < LIFE_NEW):
            raise AssertionError(f"serve_lifecycle {tag} cancel: {st}, "
                                 f"{len(out[r1])} tokens")
        for rid in (r1, r2):
            if _drain_queue(eng.stream(rid)) != [int(t) for t in out[rid]]:
                raise AssertionError(f"serve_lifecycle {tag}: stream {rid} "
                                     f"is not the drained output")
        rep["cancel"] = {
            "committed": len(out[r1]),
            "cancelled": _near_tie_equal("cancelled prefix", model, p_long,
                                         out[r1], want_long[:len(out[r1])],
                                         tie),
            "other": _near_tie_equal("co-batched", model, p_other, out[r2],
                                     want_other, tie)}
        _drained(f"serve_lifecycle {tag} cancel", eng)
        launches += _check_launches("serve_lifecycle cancel", eng)
        # deadlines: one mid-flight, one still queued behind it
        _reset_paged()
        eng = ServingEngine(model, max_batch=1, async_dispatch=mode, **base)
        t_sub = time.perf_counter()
        rd = eng.submit(p_long, LIFE_NEW, deadline_s=LIFE_DEADLINE_S)
        rq = eng.submit(p_queued, 8, deadline_s=LIFE_DEADLINE_S)
        for _ in range(10):
            eng.step()
        time.sleep(max(0.0, t_sub + LIFE_DEADLINE_S + 0.01
                       - time.perf_counter()))
        out = eng.run()
        st = {i: eng.request_stats[i].status for i in (rd, rq)}
        if (st != {rd: "DEADLINE", rq: "DEADLINE"} or len(out[rq])
                or not 0 < len(out[rd]) < LIFE_NEW):
            raise AssertionError(f"serve_lifecycle {tag} deadline: {st}")
        rep["deadline"] = {
            "committed": len(out[rd]),
            "expired": eng.stats.deadline_expired_total,
            "prefix": _near_tie_equal("deadline prefix", model, p_long,
                                      out[rd], want_long[:len(out[rd])],
                                      tie)}
        _drained(f"serve_lifecycle {tag} deadline", eng)
        launches += _check_launches("serve_lifecycle deadline", eng)
        # preempt-and-restore: the pool holds the long request's worst
        # case and one page; the priority-1 request needs more
        _reset_paged()
        need = -(-(len(p_long) + LIFE_NEW - 1) // PAGE)
        eng = ServingEngine(model, max_batch=2, num_pages=1 + need + 1,
                            async_dispatch=mode, **base)
        ra = eng.submit(p_long, LIFE_NEW, stream=True)
        for _ in range(24):
            eng.step()
        rb = eng.submit(p_vip, 24, priority=1, stream=True)
        out = eng.run()
        _all_ok(f"serve_lifecycle {tag} preempt", eng)
        sa = eng.request_stats[ra]
        if eng.stats.preempted_total < 1 or sa.preemptions < 1:
            raise AssertionError(f"serve_lifecycle {tag}: no preemption")
        for rid in (ra, rb):
            if _drain_queue(eng.stream(rid)) != [int(t) for t in out[rid]]:
                raise AssertionError(f"serve_lifecycle {tag}: stream {rid}")
        rep["preempt"] = {
            "preempted": eng.stats.preempted_total,
            "restore_prefix_hit_tokens": sa.prefix_hit_tokens,
            "restored": _near_tie_equal("restored", model, p_long, out[ra],
                                        want_long, tie),
            "vip": _near_tie_equal("priority 1", model, p_vip, out[rb],
                                   want_vip, tie)}
        _drained(f"serve_lifecycle {tag} preempt", eng)
        launches += _check_launches("serve_lifecycle preempt", eng)
        # park_all mid-run, resubmit on a second engine
        _reset_paged()
        eng = ServingEngine(model, max_batch=2, async_dispatch=mode, **base)
        for p, n in ((p_long, LIFE_NEW), (p_other, 24), (p_queued, 8)):
            eng.submit(p, n)
        for _ in range(12):
            eng.step()
        tickets, fin = eng.park_all()
        launches += _check_launches("serve_lifecycle park", eng)
        _drained(f"serve_lifecycle {tag} park", eng)
        if fin or len(tickets) != 3 or not any(t["committed"]
                                               for t in tickets):
            raise AssertionError(f"serve_lifecycle {tag} park: {fin}, "
                                 f"{[len(t['committed']) for t in tickets]}")
        _reset_paged()
        second = ServingEngine(model, max_batch=2, async_dispatch=mode,
                               **base)
        rids = [second.submit(t["prompt"], t["max_new_tokens"],
                              committed=t["committed"] or None)
                for t in tickets]
        out = second.run()
        _all_ok(f"serve_lifecycle {tag} resubmitted", second)
        launches += _check_launches("serve_lifecycle resubmit", second)
        _drained(f"serve_lifecycle {tag} resubmitted", second)
        wants = (want_long, want_other, want_queued)        # by rid
        rep["park"] = {
            "committed": [len(t["committed"]) for t in tickets],
            "restored": [_near_tie_equal(
                f"parked {t['rid']}", model, t["prompt"], out[rid],
                wants[t["rid"]], tie) for t, rid in zip(tickets, rids)]}
        report[tag] = rep
    emit("serve_lifecycle", model=MODEL, dtype=str(model.dtype),
         sanitize=True, tie=tie, **report)
    torch.cuda.empty_cache()
    return {"model": launches, "int8": 0}


def phase_serve_chaos(model) -> dict:
    """A seeded ``FaultPlan.random`` over sync, async and spec engines (8
    requests, 32 new tokens, every fault kind): requests that end OK equal
    the fault-free run (or part from it only at a near tie), the others a
    prefix of it; ``max_step_failures`` consecutive dispatch faults drain
    with every live request ``FAILED``; a loop that stops scheduling
    raises ``EngineStallError``."""
    import types
    from paddle_ray_tpu_torch.serving import (EngineStallError, FaultEvent,
                                              FaultPlan, ServingEngine)
    cfg = model.cfg
    r = np.random.RandomState(SEED + 13)
    tie = SERVE_TIE["model"]
    prompts = [r.randint(0, cfg.vocab_size, (int(n),))
               for n in r.randint(16, 200, 8)]
    new = 32
    # a pool for the four largest worst cases: only the spikes squeeze it
    need = sum(sorted(-(-(len(p) + new - 1) // PAGE) for p in prompts)[-4:])
    modes = {"sync": {}, "async": dict(async_dispatch=True),
             "spec": dict(spec_decode="ngram", spec_k=SPEC_K)}
    report, launches = {}, 0
    for i, (tag, extra) in enumerate(modes.items()):
        kw = dict(page_size=PAGE, max_batch=4, sanitize=True,
                  retry_budget=12, num_pages=1 + need, device=model.device,
                  **extra)
        _reset_paged()
        clean = ServingEngine(model, **kw)
        rids = [clean.submit(p, new) for p in prompts]
        want = clean.run()
        _all_ok(f"serve_chaos {tag} fault-free", clean)
        launches += _check_launches(f"serve_chaos {tag}", clean)
        plan = FaultPlan.random(SEED + i, steps=120, p_pool_alloc=0.05,
                                p_dispatch=0.05, p_fetch=0.05,
                                p_fetch_delay=0.02, p_pool_spike=0.05,
                                delay_s=0.002)
        _reset_paged()
        eng = ServingEngine(model, chaos=plan, **kw)
        rids = [eng.submit(p, new) for p in prompts]
        got = eng.run()
        launches += _check_launches(f"serve_chaos {tag} faults", eng)
        _drained(f"serve_chaos {tag}", eng)
        statuses, agree = {}, []
        for j, (rid, p) in enumerate(zip(rids, prompts)):
            s = eng.request_stats[rid].status
            statuses[s] = statuses.get(s, 0) + 1
            w = want[rid] if s == "OK" else want[rid][:len(got[rid])]
            agree.append(_near_tie_equal(f"serve_chaos {tag} request {j}",
                                         model, p, got[rid], w, tie))
        if not plan.fired_log() or not eng.stats.step_failures:
            raise AssertionError(f"serve_chaos {tag}: nothing fired")
        report[tag] = {"fired": plan.fired_log(), "statuses": statuses,
                       **{k: v for k, v in _serve_stats(eng).items()
                          if k in ("mixed_steps", "step_failures",
                                   "retries_total", "preempted_total",
                                   "draft_tokens", "accepted_tokens")},
                       "agreement": agree}
    # consecutive failures drain every live request FAILED
    _reset_paged()
    plan = FaultPlan([FaultEvent(s, "dispatch") for s in range(3, 40)])
    eng = ServingEngine(model, page_size=PAGE, max_batch=4, sanitize=True,
                        chaos=plan, retry_budget=100, max_step_failures=3,
                        device=model.device)
    rids = [eng.submit(p, new) for p in prompts[:4]]
    eng.run()
    launches += _check_launches("serve_chaos drain", eng)
    failed = [eng.request_stats[i].status for i in rids]
    if eng.failed_drain is None or set(failed) != {"FAILED"}:
        raise AssertionError(f"serve_chaos drain: {failed}")
    _drained("serve_chaos drain", eng)
    report["failed_drain"] = {"step_failures": eng.stats.step_failures,
                              "statuses": failed}
    # the watchdog
    _reset_paged()
    eng = ServingEngine(model, page_size=PAGE, max_batch=4, sanitize=True,
                        device=model.device)
    rid = eng.submit(prompts[0], new, stream=True)
    eng._schedule = types.MethodType(lambda self: ([], 0, 0), eng)
    t0 = time.perf_counter()
    try:
        eng.run(max_stall_s=0.2)
    except EngineStallError as err:
        report["watchdog"] = {"raised": type(err).__name__,
                              "after_s": round(time.perf_counter() - t0, 3),
                              "status": eng.request_stats[rid].status}
    else:
        raise AssertionError("serve_chaos: the watchdog did not trip")
    if (report["watchdog"]["status"] != "FAILED"
            or eng.stream(rid).get(timeout=1) is not None):
        raise AssertionError(f"serve_chaos watchdog: {report['watchdog']}")
    emit("serve_chaos", model=MODEL, dtype=str(model.dtype),
         requests=len(prompts), new_tokens=new, tie=tie, **report)
    return {"model": launches, "int8": 0}


# ---------------------------------------------------------------------------
# 8. the serving path with the int8 KV pool and sampled requests
# ---------------------------------------------------------------------------
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _serve_requests(eng, prompts, news, sampling):
    rids = [eng.submit(p, n, **kw)
            for p, n, kw in zip(prompts, news, sampling)]
    out = eng.run()
    return [out[r] for r in rids]


def phase_serve_int8(model) -> dict:
    """The serving workload over an int8 KV pool, every other request
    sampled with its own seed."""
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    workload = bench_serving_workload(cfg.max_seq_len)
    r = np.random.RandomState(1)
    prompts = [r.randint(0, cfg.vocab_size, (t,)) for t, _ in workload]
    news = [n for _, n in workload]
    sampling = [dict(SAMPLED, seed=1000 + i) if i % 2 else {}
                for i in range(len(workload))]
    kw = dict(page_size=PAGE, max_batch=MAX_BATCH, kv_cache_dtype="int8",
              device=model.device)
    eng = ServingEngine(model, **kw)
    torch.cuda.reset_peak_memory_stats()
    paged_ragged_attention.launches = paged_ragged_attention.launches_q8 = 0
    t0 = time.perf_counter()
    out = _serve_requests(eng, prompts, news, sampling)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_ragged_attention.launches_q8
    st = eng.stats.to_dict()
    for i, (toks, n) in enumerate(zip(out, news)):
        if len(toks) != n:
            raise AssertionError(f"int8 request {i} returned {len(toks)} "
                                 f"tokens, wanted {n}")
    if (launches == 0 or launches != cfg.num_layers * st["mixed_steps"]
            or paged_ragged_attention.launches != 0):
        raise AssertionError(
            f"paged int8 kernel launched {launches} times (bf16 kernel "
            f"{paged_ragged_attention.launches}) in {st['mixed_steps']} "
            f"steps of {cfg.num_layers} layers")
    # streams depend only on seed and position: four sampled requests
    # served by a fresh engine, and in reverse order (other slots) by
    # another, draw the same tokens.  Their prompts are 8 tokens, so every
    # step multiplies at most 64 rows: cuBLAS's bf16 GEMMs tile larger row
    # counts so that a row's sums depend on its place in the batch, and
    # then a sampled token at a near tie may change with the slot.
    r = np.random.RandomState(3)
    same_len = [r.randint(0, cfg.vocab_size, (8,)) for _ in range(4)]
    four = [dict(SAMPLED, seed=2000 + i) for i in range(4)]
    fwd = _serve_requests(ServingEngine(model, **kw), same_len, [64] * 4,
                          four)
    rev = _serve_requests(ServingEngine(model, **kw), same_len[::-1],
                          [64] * 4, four[::-1])[::-1]
    for i, (a, b) in enumerate(zip(fwd, rev)):
        if not np.array_equal(a, b):
            first = int(np.argmax(a != b))
            raise AssertionError(
                f"sampled request {i} served in reverse order drew other "
                f"tokens from position {first}: {b[:first + 4]} vs "
                f"{a[:first + 4]}")
    # the workload's first four sampled requests alone, in reverse order:
    # other step shapes than the 12-request run; the share of their tokens
    # equal to that run's is reported, not held
    again_idx = [i for i, kw_i in enumerate(sampling) if kw_i][:4][::-1]
    again = _serve_requests(ServingEngine(model, **kw),
                            [prompts[i] for i in again_idx],
                            [news[i] for i in again_idx],
                            [sampling[i] for i in again_idx])
    equal_share = float(np.mean(np.concatenate(
        [toks == out[i] for i, toks in zip(again_idx, again)])))
    first_diff = [int(np.argmax(toks != out[i])) if (toks != out[i]).any()
                  else None for i, toks in zip(again_idx, again)]
    greedy = [i for i, kw_i in enumerate(sampling) if not kw_i]
    fields = {k: st[k] for k in (
        "decode_tokens_per_s", "prefill_tokens_per_s", "p50_token_ms",
        "p99_token_ms", "mixed_steps", "decode_tokens", "prefill_tokens",
        "prefix_hit_tokens", "timed_decode_tokens", "timed_prefill_tokens",
        "decode_s", "prefill_s")}
    emit("serve_int8", model=MODEL, dtype=str(model.dtype),
         kv_cache_dtype="int8", requests=len(out),
         sampled=[i for i in range(len(out)) if sampling[i]],
         sampling=SAMPLED, greedy=greedy, launches_q8=launches,
         reverse_order_equal=True, workload_resubmitted=again_idx,
         workload_resubmitted_equal_share=equal_share,
         workload_resubmitted_first_diff=first_diff, wall_s=round(wall_s, 3),
         peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
         pool=eng.pool_stats(), **fields)
    return {"launches": launches, **fields}


# ---------------------------------------------------------------------------
# 9. generate(): bench.py's two generation rows
# ---------------------------------------------------------------------------
def _decode_counters():
    from paddle_ray_tpu_torch.ops.decode_attention import (
        fused_decode_attention)
    from paddle_ray_tpu_torch.ops.decode_matmul import int8_stream_matmul
    return {
        "fused_decode_attention": (fused_decode_attention, "launches"),
        "fused_decode_attention_q8": (fused_decode_attention, "launches_q8"),
        "int8_stream_matmul": (int8_stream_matmul, "launches"),
    }


def _reset(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters) -> dict:
    return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}


def phase_generate(model) -> dict:
    """(a) bf16 ``generate()``, (b) ``quantize_for_decode`` with the int8
    KV cache: batch 8, prompt 128, 256 new tokens, a ``GEN_WARMUP``-token
    warm-up and ``GEN_TIMED`` timed call; every call must launch the
    kernels the path runs the
    expected number of times.  Then 16 new tokens of each under
    ``torch.profiler``, beside the same call unprofiled."""
    from paddle_ray_tpu_torch.models import generate, quantize_for_decode
    cfg = model.cfg
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))).to("cuda")
    steps = GEN_NEW - 1                   # decode steps after the prefill
    n_layers = cfg.num_layers
    configs = {
        "bf16": (model, {}, {"fused_decode_attention": n_layers * steps}),
        "int8": (quantize_for_decode(model), {"kv_cache_dtype": "int8"},
                 {"fused_decode_attention_q8": n_layers * steps,
                  # the prefill's LM head row, then 4 linears per layer
                  # and the head at every decode step
                  "int8_stream_matmul": 1 + steps * (4 * n_layers + 1)}),
    }
    counters = _decode_counters()
    results, outs = {}, {}
    for name, (m, kw, expect) in configs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # warm-up: every kernel and GEMM shape of the call, a short one
        generate(m, ids, GEN_WARMUP, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(GEN_TIMED):
            _reset(counters)
            t0 = time.perf_counter()
            out = generate(m, ids, GEN_NEW, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = _read(counters)
            want = {n: expect.get(n, 0) for n in counters}
            if launches != want:
                raise AssertionError(f"generate {name}: launches {launches}"
                                     f", want {want}")
        if (out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW)
                or not torch.equal(out[:, :GEN_PROMPT], ids)
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
            raise AssertionError(f"generate {name}: bad output {out.shape}")
        outs[name] = out[:, GEN_PROMPT:]
        call_s = float(np.mean(times))
        r = {"tokens_per_s": GEN_BATCH * GEN_NEW / call_s,
             "ms_per_token": 1e3 * call_s / GEN_NEW,
             "call_s": times,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
             "launches_per_call": launches}

        # where the time goes: a 16-token call, unprofiled then profiled
        short = 16
        generate(m, ids, short, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(m, ids, short, **kw)
        torch.cuda.synchronize()
        short_ms = 1e3 * (time.perf_counter() - t0)
        _, rows, attempts = profiled(
            lambda: generate(m, ids, short, **kw),
            on_active=lambda: _reset(counters))
        launched = _read(counters)
        device_ms = sum(t for _, t, _ in rows) / 1e3
        top = sorted(rows, key=lambda x: -x[1])[:10]
        r["profile"] = {
            "new_tokens": short, "call_ms_unprofiled": short_ms,
            "profile_attempts": attempts,
            "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / short_ms,
            "kernels_launched": sum(c for _, _, c in rows),
            "top_kernels": [{"name": k[:80], "ms": t / 1e3, "calls": c}
                            for k, t, c in top]}
        if "int8_stream_matmul" in expect:
            # one device kernel a call: no second kernel merges split-K
            stream = [(k, t, c) for k, t, c in rows if "int8_stream" in k]
            calls = sum(c for _, _, c in stream)
            if calls != launched["int8_stream_matmul"] or len(stream) != 1:
                raise AssertionError(
                    f"generate {name}: {launched['int8_stream_matmul']} "
                    f"int8_stream_matmul launches ran the device kernels "
                    f"{[(k[:60], c) for k, _, c in stream]}")
            r["profile"]["int8_stream_matmul"] = {
                "launches": launched["int8_stream_matmul"],
                "kernel_calls": calls,
                "ms": sum(t for _, t, _ in stream) / 1e3}
        results[name] = r
        emit("generate", model=MODEL, config=name, batch=GEN_BATCH,
             prompt=GEN_PROMPT, new_tokens=GEN_NEW,
             weights="bf16" if name == "bf16" else "int8 (weight-only)",
             kv_cache=kw.get("kv_cache_dtype", "model"), **r)
    results["bf16_int8_equal_share"] = float(
        (outs["bf16"] == outs["int8"]).float().mean())
    emit("generate_agreement",
         share_of_new_tokens_equal=results["bf16_int8_equal_share"])
    del configs
    torch.cuda.empty_cache()
    return results


# one stream's prompts: bench.py's 128, and a long context whose decode
# positions (1536-1790) fused decode attention splits
GEN_B1_PROMPTS = (GEN_PROMPT, 1536)
# new tokens of each profiled batch-1 call (64 before the recipe's phases
# joined the run; 16 keeps the run near 10 min)
GEN_B1_PROFILED = 16
# timed batch-1 calls a prompt (one, to keep the run inside its limit)
GEN_B1_TIMED = 1


def phase_generate_b1(model) -> dict:
    """One stream: bf16 ``generate()`` at batch 1, 256 new tokens from each
    prompt of ``GEN_B1_PROMPTS``.  16 (batch, head) pairs leave most SMs
    idle, so over a long cache fused decode attention splits a pair's
    rows.  For each prompt a ``GEN_WARMUP``-token warm-up and
    ``GEN_B1_TIMED`` timed call, launching the kernel once a layer and
    step; the split plan of every launch, as
    the wrapper takes it from ``kernel_plan``; then the kernel's device
    time in a profiled ``GEN_B1_PROFILED``-token call as planned, and in
    one with every launch held to a single split."""
    from paddle_ray_tpu_torch.models import generate
    from paddle_ray_tpu_torch.ops import decode_attention as da
    cfg = model.cfg
    expect = cfg.num_layers * (GEN_NEW - 1)
    counters = _decode_counters()
    planned = da.kernel_plan
    splits = []

    def recorded(q, pos):
        plan = planned(q, pos)
        splits.append(plan[0])
        return plan

    def unsplit(q, pos):
        return da.decode_split_plan(q.shape[0] * q.shape[1], pos + 1, 1)

    results = {}
    for prompt in GEN_B1_PROMPTS:
        ids = torch.from_numpy(np.random.RandomState(SEED + 5).randint(
            0, cfg.vocab_size, (1, prompt))).to("cuda")
        generate(model, ids, GEN_WARMUP)                       # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(GEN_B1_TIMED):
            _reset(counters)
            splits.clear()
            da.kernel_plan = recorded
            try:
                t0 = time.perf_counter()
                out = generate(model, ids, GEN_NEW)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            finally:
                da.kernel_plan = planned
            launches = _read(counters)
            if (launches["fused_decode_attention"] != expect
                    or len(splits) != expect):
                raise AssertionError(f"generate_b1 prompt {prompt}: "
                                     f"launches {launches}, plans "
                                     f"{len(splits)}, want {expect}")
        if (out.shape != (1, prompt + GEN_NEW)
                or not torch.equal(out[:, :prompt], ids)
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
            raise AssertionError(f"generate_b1 prompt {prompt}: bad output "
                                 f"{out.shape}")
        n_split = sum(n > 1 for n in splits)
        call_s = float(np.mean(times))
        r = {"tokens_per_s": GEN_NEW / call_s, "call_s": times,
             "decode_attention_launches": len(splits),
             "split_launches": n_split, "split_share": n_split / len(splits),
             "n_splits_min_max": [min(splits), max(splits)]}
        for mode, plan in (("split", planned), ("one_split", unsplit)):
            da.kernel_plan = plan
            try:
                _, rows, attempts = profiled(
                    lambda: generate(model, ids, GEN_B1_PROFILED))
            finally:
                da.kernel_plan = planned
            att = [(t, c) for k, t, c in rows
                   if "fused_decode_attention_kernel" in k]
            r[f"profile_{mode}"] = {
                "new_tokens": GEN_B1_PROFILED, "profile_attempts": attempts,
                "device_ms": sum(t for _, t, _ in rows) / 1e3,
                "decode_attention_ms": sum(t for t, _ in att) / 1e3,
                "decode_attention_launches": sum(c for _, c in att)}
        results[prompt] = r
        emit("generate_b1", model=MODEL, batch=1, prompt=prompt,
             new_tokens=GEN_NEW, weights="bf16", kv_cache="model", **r)
    return results


# ---------------------------------------------------------------------------
# 10. correctness of the decode path on the card
# ---------------------------------------------------------------------------
CHECK_TIE = 1e-3
CHECK_B1_PROMPT = 1040


def _first_gap(model, seq, t0, j) -> float:
    """The top-2 gap of plain ``GPT.forward``'s logits for new token ``j``
    of ``seq`` (the smallest over the batch rows)."""
    with torch.no_grad():
        logits = model(seq[:, :t0 + j])[:, -1].float()
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _same_tokens(name, model, got, want, t0) -> dict:
    """Greedy tokens of two paths must be equal, except from a step where
    the reference's top-2 logit gap is below ``CHECK_TIE`` (there float32
    sums taken in another order may flip the argmax)."""
    diff = torch.nonzero((got != want).any(dim=0)).flatten()
    if diff.numel() == 0:
        return {"equal_tokens": int(got.shape[1] - t0), "near_tie_at": None}
    j = int(diff[0]) - t0
    gap = _first_gap(model, want, t0, j)
    if j < 0 or gap >= CHECK_TIE:
        raise AssertionError(f"generate_check {name}: tokens differ at new "
                             f"token {j} where the top-2 gap is {gap}")
    return {"equal_tokens": j, "near_tie_at": j, "gap": gap}


def phase_generate_check() -> None:
    """4-layer float32 models of gpt3-350m's and gpt3-760m's widths (head
    dims 64 and 96): the kernels' greedy tokens against the plain chain
    (``fused_attention=False``) for the dense cache in the model's dtype
    and in int8, and the paged layout against the dense one, at batch 8
    and, for gpt3-350m, at batch 1 (where decode attention splits), every
    kernel of the chain launched; then the threefry bits of 4,096 (seed,
    position) keys on the card against the CPU."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models import generate
    from paddle_ray_tpu_torch.models.generation import fold_sample_keys
    from paddle_ray_tpu_torch.ops.decode_attention import kernel_plan
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    counters = {**_decode_counters(),
                "paged_ragged_attention": (paged_ragged_attention,
                                           "launches"),
                "paged_ragged_attention_q8": (paged_ragged_attention,
                                              "launches_q8")}
    b, t0, new = GEN_BATCH, 64, 32
    report = {}
    # (model, batch, prompt): gpt3-350m's widths at batch 1 too, over a
    # cache long enough that fused decode attention splits its 16 pairs
    for name, bs, prompt in ((MODEL, b, t0), (MODEL, 1, CHECK_B1_PROMPT),
                             (M760, b, t0)):
        model = _check_model(name, max(512, prompt + new))
        tag = name if bs == b else f"{name}_b{bs}"
        ids = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
            0, model.cfg.vocab_size, (bs, prompt))).to("cuda")
        if bs == 1:
            cfg = model.cfg
            q = torch.empty(1, cfg.num_heads, 1, cfg.head_dim, device="cuda")
            report[f"{tag}_decode_splits"] = [
                kernel_plan(q, prompt)[0],
                kernel_plan(q, prompt + new - 2)[0]]
            if min(report[f"{tag}_decode_splits"]) < 2:
                raise AssertionError(f"generate_check {tag}: decode "
                                     f"attention does not split")
        _reset(counters)
        for kv in ("model", "int8"):
            kernel = generate(model, ids, new, kv_cache_dtype=kv)
            plain = generate(model, ids, new, kv_cache_dtype=kv,
                             fused_attention=False)
            paged = generate(model, ids, new, kv_cache_dtype=kv,
                             kv_layout="paged", page_size=PAGE)
            report[f"{tag}_fused_vs_plain_{kv}"] = _same_tokens(
                f"{tag} fused vs plain ({kv} KV)", model, kernel, plain,
                prompt)
            report[f"{tag}_paged_vs_dense_{kv}"] = _same_tokens(
                f"{tag} paged vs dense ({kv} KV)", model, paged, kernel,
                prompt)
        launches = _read(counters)
        missing = [k for k, n in launches.items()
                   if n == 0 and k != "int8_stream_matmul"]
        if missing:
            raise AssertionError(f"generate_check {tag}: kernels not "
                                 f"launched: {missing}")
        report[f"{tag}_launches"] = launches
        del model
    r = np.random.RandomState(SEED + 2)
    seeds = np.concatenate([np.asarray([0, 2 ** 31 + 5, 2 ** 32 - 1],
                                       np.uint64),
                            r.randint(0, 2 ** 32, 4093, dtype=np.uint64)])
    positions = r.randint(0, 4096, 4096)
    bits = {}
    for dev in ("cuda", "cpu"):
        keys = fold_sample_keys(torch.from_numpy(seeds.astype(np.int64)).to(
            dev), torch.from_numpy(positions).to(dev))
        bits[dev] = prng.random_bits(keys, (16,)).cpu()
    if not torch.equal(bits["cuda"], bits["cpu"]):
        raise AssertionError("threefry bits differ between the card and the "
                             "CPU")
    emit("generate_check", dtype="float32", layers=4, batch=b, prompt=t0,
         b1_prompt=CHECK_B1_PROMPT,
         new_tokens=new, tie=CHECK_TIE, threefry_keys=len(seeds),
         threefry_bits_equal=True, **report)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 11. the training path: gpt3-350m
# ---------------------------------------------------------------------------
def _flash_counters():
    from paddle_ray_tpu_torch.ops.flash_attention import (
        flash_backward_dkv, flash_backward_dq, flash_forward)
    return dict(zip(FLASH_KERNELS, (flash_forward, flash_backward_dq,
                                    flash_backward_dkv)))


def phase_train() -> dict:
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    # bench.py builds the model with max_seq_len = seq
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      attn_impl="flash", remat=False, max_seq_len=TRAIN_SEQ,
                      generator=g)
    cfg = model.cfg
    ts = build_train_step(model, AdamW(TRAIN_LR), gpt_loss_fn)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    batch = (ids, ids)
    counters = _flash_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses = [ts.step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [ts.step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: "
                             f"{losses}")
    for n, count in launches.items():
        if count != cfg.num_layers * steps:
            raise AssertionError(f"{n} launched {count} times in {steps} "
                                 f"steps of {cfg.num_layers} layers")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TIMED_STEPS / dt
    # bench.py's count: 6 N + 12 L H S FLOP per token, against the bf16 peak
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ)
    step_ms = 1e3 * dt / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    emit("train", model=MODEL, dtype="bfloat16", attn_impl="flash",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, optimizer=f"AdamW({TRAIN_LR})",
         steps=steps, timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=losses, **out)

    # one more step under the profiler: where a step's device time goes
    prof, rows, attempts = profiled(lambda: ts.step(batch))
    device_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:8]
    emit("train_profile", steps=1, step_ms_unprofiled=step_ms,
         profile_attempts=attempts,
         device_ms=device_ms, device_idle_share=1.0 - device_ms / step_ms,
         kernels_launched=sum(c for _, _, c in rows),
         flash_ms=sum(t for k, t, _ in rows if "flash_" in k) / 1e3,
         top_kernels=[{"name": k[:90], "ms": t / 1e3, "calls": c}
                      for k, t, c in top],
         annotated_spans=[{"name": k, "ms": t / 1e3}
                          for k, t in annotation_spans(prof)])
    del ts, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 24. gpt3-760m training: the flash kernels at head dim 96
# ---------------------------------------------------------------------------
def phase_train_760m() -> dict:
    """``bench.py``'s gpt3-760m row (bf16, flash, remat off, batch 4 x
    1024, ``AdamW(1e-4)``): 2 warm-up and 3 timed steps, losses finite and
    falling, each flash kernel launched once per layer a step (head dim
    1536 / 16 = 96)."""
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_gpt(M760, device="cuda", dtype=torch.bfloat16,
                      attn_impl="flash", remat=False, max_seq_len=TRAIN_SEQ,
                      generator=g)
    cfg = model.cfg
    head_dim = cfg.hidden_size // cfg.num_heads
    ts = build_train_step(model, AdamW(TRAIN_LR), gpt_loss_fn)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (M760_BATCH, TRAIN_SEQ))).to("cuda")
    batch = (ids, ids)
    counters = _flash_counters()
    run = _timed_train(ts, lambda i: ts.step(batch), counters,
                       {n: cfg.num_layers for n in counters}, "train_760m",
                       timed=M760_TIMED)
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = M760_BATCH * TRAIN_SEQ * M760_TIMED / run["seconds"]
    # bench.py's count: 6 N + 12 L H S FLOP per token, against the bf16 peak
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ)
    out = {"tokens_per_s": tokens_per_s,
           "step_ms": 1e3 * run["seconds"] / M760_TIMED,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "peak_memory_gb": run["peak_memory_gb"],
           "launches": run["launches"]}
    emit("train_760m", model=M760, dtype="bfloat16", attn_impl="flash",
         head_dim=head_dim, batch=M760_BATCH, seq=TRAIN_SEQ,
         optimizer=f"AdamW({TRAIN_LR})", steps=run["steps"],
         timed_steps=M760_TIMED, n_params=n_params,
         flops_per_token=flops_per_token, losses=run["losses"], **out)
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 25-27. GPT pretraining options: the recipe, seq 8192, and their check
# ---------------------------------------------------------------------------
def _recipe_optimizer():
    from paddle_ray_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                                CosineAnnealingDecay,
                                                LinearWarmup)
    return AdamW(LinearWarmup(CosineAnnealingDecay(
        RECIPE_LR, RECIPE_DECAY, RECIPE_LR_MIN), RECIPE_WARMUP),
        beta2=0.95, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))


def _recipe_counters():
    from paddle_ray_tpu_torch.ops.dropout import threefry_dropout
    return {**_flash_counters(), DROPOUT_KERNELS[0]: threefry_dropout}


def recipe_launches(layers, policy, micro) -> dict:
    """Launches a step of ``micro`` micro-batches of ``layers`` blocks: a
    micro-batch drops 1 + 2 L times forward and backward (the embedding,
    each block's attention and MLP outputs) and L more in the recompute
    (each block's attention-output drop, which the second norm's input
    needs; the recompute stops before the MLP's); the flash forward runs
    again in the recompute unless the policy saves its outputs
    (``"dots_attn"``).  ``tests/test_torch_train_options.py`` holds the
    pattern on the CPU."""
    fwd = layers * (1 if policy == "dots_attn" else 2)
    return {DROPOUT_KERNELS[0]: micro * (2 * (1 + 2 * layers) + layers),
            FLASH_KERNELS[0]: micro * fwd, FLASH_KERNELS[1]: micro * layers,
            FLASH_KERNELS[2]: micro * layers}


def _train_recipe(label, seq, batch, policy, accum) -> dict:
    """gpt3-350m at full width (bf16, flash) through ``build_train_step``
    with the recipe's options and ``remat_policy=policy``, ``grad_accum=
    accum``, step i's key ``fold_in(PRNGKey(SEED), i)``: 2 warm-up and 10
    timed steps, losses finite and falling, every kernel launched as
    :func:`recipe_launches` says; one step in which a host-device sync
    raises; then one profiled step."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      attn_impl="flash", max_seq_len=seq, generator=g,
                      **{**RECIPE_CFG, "remat_policy": policy})
    cfg = model.cfg
    ts = build_train_step(model, _recipe_optimizer(), gpt_loss_fn,
                          grad_accum=accum)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    key = prng.PRNGKey(SEED)

    def step(i):
        return ts.step((ids, ids), prng.fold_in(key, i))
    run = _timed_train(ts, step, _recipe_counters(),
                       recipe_launches(cfg.num_layers, policy, accum), label)
    # one more step with every host-device sync an error: the step never
    # waits for the device
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(WARMUP_STEPS + TIMED_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = batch * seq * TIMED_STEPS / run["seconds"]
    # bench.py's count: 6 N + 12 L H S FLOP per token (no recompute),
    # against the bf16 peak
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * seq)
    step_ms = 1e3 * run["seconds"] / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "peak_memory_gb": run["peak_memory_gb"],
           "launches": run["launches"]}
    emit(label, model=MODEL, dtype="bfloat16", attn_impl="flash",
         batch=batch, seq=seq, grad_accum=accum, remat_policy=policy,
         dropout=cfg.dropout, ce_chunk=cfg.ce_chunk,
         optimizer=f"AdamW(LinearWarmup(CosineAnnealingDecay({RECIPE_LR}, "
                   f"{RECIPE_DECAY}, {RECIPE_LR_MIN}), {RECIPE_WARMUP}), "
                   f"beta2=0.95, weight_decay=0.1, "
                   f"grad_clip=ClipGradByGlobalNorm(1.0))",
         steps=run["steps"], timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=run["losses"],
         sync_free_step=True, **out)
    _profile_step(lambda: step(WARMUP_STEPS + TIMED_STEPS + 1),
                  f"{label}_profile",
                  step_ms, {"dropout": ("dropout_kernel",),
                            "flash": ("flash_",)})
    del ts, model, ids
    torch.cuda.empty_cache()
    return out


def phase_train_recipe() -> dict:
    """The slice's main path: batch 8 x 1024 in two micro-batches, remat
    ``"dots"``."""
    return _train_recipe("train_recipe", TRAIN_SEQ, TRAIN_BATCH,
                         RECIPE_CFG["remat_policy"], RECIPE_ACCUM)


def phase_train_seq8k() -> dict:
    """``bench.py``'s seq-8192 row: batch 1, remat ``"dots_attn"``."""
    return _train_recipe("train_seq8k", SEQ8K, SEQ8K_BATCH, SEQ8K_POLICY, 1)


def phase_train_recipe_check() -> None:
    """A 4-layer float32 model of gpt3-350m's width (flash, dropout 0.1,
    one key) built several times from one set of weights: remat off,
    ``"none"``, ``"dots"`` and ``"dots_attn"`` give losses and gradients
    within 1e-6 of max|ref| (the recompute runs the same kernels on the
    same inputs), each policy's peak memory beside remat off's;
    ``ce_chunk`` 256 against the full cross-entropy (loss ``rtol`` 1e-5,
    gradients ``max|err| / max|ref|`` 1e-4: chunked sums in another
    order); without dropout, ``grad_accum`` 2 against one batch of the
    same four rows (loss ``rtol`` 1e-5, gradients 1e-5: float32
    rounding)."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    b, s = 2, 512
    key = prng.PRNGKey(SEED + 2)

    def build(**kw):
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 2)
        return build_gpt(MODEL, device="cuda", dtype=torch.float32,
                         num_layers=4, max_seq_len=s, attn_impl="flash",
                         generator=g, **{"dropout": 0.1, **kw})
    ids = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, 50304, (2 * b, s))).to("cuda")
    batch = (ids[:b], ids[:b])

    def grads(m, batch, key):
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = gpt_loss_fn(m, batch, key)
        loss.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        return float(loss), {n: p.grad.clone()
                             for n, p in m.named_parameters()}, peak
    runs = {}
    for policy in ("off", "none", "dots", "dots_attn"):
        kw = (dict(remat=False) if policy == "off"
              else dict(remat=True, remat_policy=policy))
        m = build(**kw)
        runs[policy] = grads(m, batch, key)
        del m
    loss0, g0, _ = runs["off"]
    remat = {}
    for policy in ("none", "dots", "dots_attn"):
        loss, g, peak = runs[policy]
        err = max(_rel_err(g[n], g0[n]) for n in g0)
        remat[policy] = {"loss": loss, "max_grad_rel_err": err,
                         "peak_memory_gb": peak}
        if err > 1e-6 or abs(loss - loss0) > 1e-6 * abs(loss0):
            raise AssertionError(f"train_recipe_check: remat {policy} "
                                 f"against off: loss {loss} vs {loss0}, "
                                 f"grad rel_err {err}")
    full, chunked = build(), build(ce_chunk=256)
    lf, gf, _ = grads(full, batch, key)
    lc, gc, _ = grads(chunked, batch, key)
    ce_err = max(_rel_err(gc[n], gf[n]) for n in gf)
    if ce_err > 1e-4 or abs(lc - lf) > 1e-5 * abs(lf):
        raise AssertionError(f"train_recipe_check: ce_chunk loss {lc} vs "
                             f"{lf}, grad rel_err {ce_err}")
    del full, chunked
    acc = {}
    for n_acc in (2, 1):
        m = build(dropout=0.0)
        ts = build_train_step(m, AdamW(0.0), gpt_loss_fn, grad_accum=n_acc)
        loss = float(ts.step((ids, ids)))
        acc[n_acc] = (loss, {n: p.grad.clone()
                             for n, p in m.named_parameters()})
        del ts, m
    acc_err = max(_rel_err(acc[2][1][n], acc[1][1][n]) for n in acc[1][1])
    if acc_err > 1e-5 or abs(acc[2][0] - acc[1][0]) > 1e-5 * abs(acc[1][0]):
        raise AssertionError(f"train_recipe_check: grad_accum 2 loss "
                             f"{acc[2][0]} vs {acc[1][0]}, grad rel_err "
                             f"{acc_err}")
    emit("train_recipe_check", dtype="float32", layers=4, batch=b, seq=s,
         loss_off=loss0, peak_memory_gb_off=runs["off"][2], remat=remat,
         remat_tol=1e-6, ce_chunk={"loss": lc, "loss_full": lf,
                                   "max_grad_rel_err": ce_err, "tol": 1e-4},
         grad_accum={"loss_2": acc[2][0], "loss_1": acc[1][0],
                     "max_grad_rel_err": acc_err, "tol": 1e-5})
    del runs, acc
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 28-33. gpt3-1.3b with MemoryEfficientAdamW, offload, AMP, the optimizers,
# loss scaling
# ---------------------------------------------------------------------------
def _me_leaf(name, shape, dtype, moment_dtype="int8", master=False,
             l2=0.0, block=256, offset=0):
    return dict(name=name, shape=shape, dtype=dtype,
                moment_dtype=moment_dtype, master=master, l2=l2, block=block,
                offset=offset)


def gpt_leaf_shapes(cfg) -> dict:
    """``{shape: count}`` of a GPT's parameters (tied head, learned
    positions): what the step's ``me_adamw`` launches update."""
    h, f = cfg.hidden_size, cfg.d_ffn
    layer = [(h, 3 * h), (3 * h,), (h, h), (h, f), (f,), (f, h)] + [(h,)] * 6
    out: dict = {}
    for s in ([tuple(s) for s in layer] * cfg.num_layers
              + [(cfg.vocab_size, h), (cfg.max_seq_len, h), (h,), (h,)]):
        out[s] = out.get(s, 0) + 1
    return out


def me_step_cases(cfg) -> list:
    """One case a distinct leaf shape of ``cfg``'s GPT (bf16, int8
    moments, no master: the main path's update)."""
    return [_me_leaf("leaf_" + "x".join(map(str, s)), s, "bfloat16")
            for s in gpt_leaf_shapes(cfg)]


# other kinds the optimizer takes: an odd size, float32 parameters, bf16
# and float32 moments, float32 masters (bf16 and float16 parameters), an
# L2 decay; the kernel's general path: blocks of 100 and a parameter 2
# bytes into its buffer (int8 moments, two passes over each block)
ME_EXTRA_CASES = (
    _me_leaf("odd_1000", (1000,), "bfloat16"),
    _me_leaf("block_100", (2048, 2048), "bfloat16", block=100),
    _me_leaf("misaligned_odd", (1000, 1001), "bfloat16", offset=1),
    _me_leaf("f32_params", (2048, 8192), "float32"),
    _me_leaf("bf16_moments", (2048, 6144), "bfloat16", "bfloat16"),
    _me_leaf("f32_moments", (2048, 6144), "bfloat16", "float32"),
    _me_leaf("master", (2048, 6144), "bfloat16", master=True),
    _me_leaf("f16_master_odd", (1000, 1001), "float16", master=True),
    _me_leaf("l2_decay", (2048, 2048), "bfloat16", l2=0.01),
)
ME_STEPS = 3
# operations of the update an element with int8 moments and stochastic
# rounding: int32 -- the threefry2x32 hash (as DROPOUT_INT_OPS' first 72),
# the xor of its words, the mask, the add and the shift of the rounding;
# float32 -- dequantize (3), the moments (7), bias corrections, sqrt, eps
# and quotient (5), decay and step (4), quantize both (12)
ME_SR_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1 + 3
ME_F32_OPS = 3 + 7 + 5 + 4 + 12


def _me_bound(c) -> dict:
    """Bytes: the parameter and its gradient read, the parameter written,
    the moments read and written (int8: a byte each way each, and 16 bytes
    of scales a block), the master read and written; operations: the
    float32 arithmetic over 67 T/s and, with stochastic rounding, the
    int32 hash over ``INT32_OPS_PER_S``, the larger."""
    n = int(np.prod(c["shape"]))
    es = torch.tensor([], dtype=getattr(torch, c["dtype"])).element_size()
    mom = {"int8": 4 * n + 16 * -(-n // c["block"]), "bfloat16": 8 * n,
           "float32": 16 * n}[c["moment_dtype"]]
    n_bytes = 3 * es * n + mom + (8 * n if c["master"] else 0)
    sr = c["dtype"] == "bfloat16" and not c["master"]
    t_int = (ME_SR_INT_OPS * n if sr else 0) / INT32_OPS_PER_S
    t_fp = ME_F32_OPS * n / PEAK_OPS_PER_S[torch.float32]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, max(t_int, t_fp)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "int_ops": ME_SR_INT_OPS * n if sr else 0,
            "f32_ops": ME_F32_OPS * n}


def _me_case(c, timed=True) -> dict:
    """The kernel against ``me_adamw_plain`` on the card: ``ME_STEPS``
    updates of one parameter from the same state and gradients (the
    optimizer's keys and bias corrections, leaf index 7), ``torch.equal``
    on the parameter, codes, scales, moments and master; the kernel's run
    twice gives the same bits.  Timed: one kernel update (median of 20, L2
    flushed) beside its bound, the plain version and ``torch._fused_adamw_``
    over float32 parameters, gradients and moments of the same size (a
    reference point: another function)."""
    from paddle_ray_tpu_torch.optimizer import MemoryEfficientAdamW
    from paddle_ray_tpu_torch.ops.me_adamw import (
        QMoment, me_adamw_plain, me_adamw_update)
    dt = getattr(torch, c["dtype"])
    shape, n = tuple(c["shape"]), int(np.prod(c["shape"]))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + n)
    p0 = (0.02 * torch.randn(shape, generator=g, device="cuda")).to(dt)
    grads = [(10.0 ** (-3 + s) * torch.randn(shape, generator=g,
                                             device="cuda")).to(dt)
             for s in range(ME_STEPS)]
    opt = MemoryEfficientAdamW(1e-3, moment_dtype=c["moment_dtype"],
                               master_weights=c["master"],
                               block_size=c["block"])
    leaf = 7

    def fresh():
        buf = torch.empty(n + c["offset"], dtype=dt, device="cuda")
        p = buf[c["offset"]:].view(shape)
        p.copy_(p0)
        st = {k: opt._init_slot(k, p) for k in ("m", "v")}
        if c["master"]:
            st["master"] = p.float()
        return p, st

    def tensors(p, st):
        out = [p]
        for k in ("m", "v", "master"):
            x = st.get(k)
            out += ([x.codes, x.scale] if isinstance(x, QMoment)
                    else [] if x is None else [x])
        return out

    def kwargs(t):
        bc1, bc2 = opt._bias_corrections(t, opt.beta1, opt.beta2)
        sr = dt == torch.bfloat16 and not c["master"]
        return dict(lr=1e-3, b1=opt.beta1, b2=opt.beta2, eps=opt.epsilon,
                    wd=opt.weight_decay if len(shape) > 1 else 0.0,
                    l1=0.0, l2=c["l2"], bc1=bc1, bc2=bc2,
                    block=opt.block_size,
                    key=opt._sr_key(t, leaf) if sr else None)

    def run(fn):
        p, st = fresh()
        for t in range(1, ME_STEPS + 1):
            fn(p, grads[t - 1], st["m"], st["v"], st.get("master"),
               **kwargs(t))
        torch.cuda.synchronize()
        return tensors(p, st)
    launches = me_adamw_update.launches
    got, again = run(me_adamw_update), run(me_adamw_update)
    me_adamw_update.launches = launches
    want = run(me_adamw_plain)
    same = {"plain": all(torch.equal(a, b) for a, b in zip(got, want)),
            "twice": all(torch.equal(a, b) for a, b in zip(got, again))}
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    if not all(same.values()):
        raise AssertionError(f"me_adamw {c['name']}: kernel vs plain, bit "
                             f"for bit: {same}, max_abs_err {err}")
    out = {"max_abs_err": err, **_me_bound(c)}
    if timed:
        p, st = fresh()
        kw = kwargs(1)
        out["ms"] = time_ms(lambda: me_adamw_update(
            p, grads[0], st["m"], st["v"], st.get("master"), **kw))
        me_adamw_update.launches = launches
        out["plain_ms"] = time_ms(lambda: me_adamw_plain(
            p, grads[0], st["m"], st["v"], st.get("master"), **kw),
            iters=5, warmup=1)
        f32 = [torch.randn(shape, generator=g, device="cuda")
               for _ in range(4)]
        step = torch.ones((), device="cuda")
        out["fused_adamw_ms"] = time_ms(lambda: torch._fused_adamw_(
            [f32[0]], [f32[1]], [f32[2]], [f32[3]], [], [step], lr=1e-3,
            beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
            amsgrad=False, maximize=False))
        out["library_ms"] = None
        del f32
    emit("me_adamw_kernel", case=c["name"], shape=list(shape),
         dtype=c["dtype"], moment_dtype=c["moment_dtype"],
         master_weights=c["master"], l2=c["l2"], block=c["block"],
         offset=c["offset"], steps=ME_STEPS,
         bit_identical=same,
         fused_adamw="torch._fused_adamw_ over float32 parameters, "
                     "gradients and moments of the same size: a reference "
                     "point, not the same function", **out)
    del p0, grads, got, again, want
    torch.cuda.empty_cache()
    return out


def phase_me_adamw_kernel() -> dict:
    """The kernel at every leaf shape of gpt3-1.3b (``me_step_cases``)
    and ``ME_EXTRA_CASES``; and the step's sums over its leaves."""
    from paddle_ray_tpu_torch.models.gpt import gpt_config
    cfg = gpt_config(M1P3B, max_seq_len=TRAIN_SEQ)
    cases = {c["name"]: _me_case(c) for c in me_step_cases(cfg)}
    extra = {c["name"]: _me_case(c) for c in ME_EXTRA_CASES}
    counts = {"leaf_" + "x".join(map(str, s)): k
              for s, k in gpt_leaf_shapes(cfg).items()}
    step = {k: sum(counts[n] * cases[n][k] for n in counts)
            for k in ("ms", "plain_ms", "fused_adamw_ms", "bytes",
                      "int_ops", "f32_ops")}
    t_bytes = step["bytes"] / HBM_BYTES_PER_S
    t_ops = max(step["int_ops"] / INT32_OPS_PER_S,
                step["f32_ops"] / PEAK_OPS_PER_S[torch.float32])
    step.update(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                launches=sum(counts.values()), library_ms=None,
                max_abs_err=max(r["max_abs_err"] for r in
                                list(cases.values()) + list(extra.values())))
    emit("me_adamw_step", model=M1P3B, leaves=counts, **step)
    return {"cases": cases, "extra": extra, "step": step}


def _me_counters():
    from paddle_ray_tpu_torch.ops.me_adamw import me_adamw_update
    return {**_flash_counters(), ME_KERNELS[0]: me_adamw_update}


def _build_1p3b():
    from paddle_ray_tpu_torch.models import build_gpt
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    return build_gpt(M1P3B, device="cuda", dtype=torch.bfloat16,
                     attn_impl="flash", remat=False, max_seq_len=TRAIN_SEQ,
                     generator=g)


def phase_train_1p3b() -> dict:
    """``bench.py``'s gpt3-1.3b row: bf16, flash (head dim 128), remat off,
    batch 7 x 1024, ``MemoryEfficientAdamW(1e-4, moment_dtype="int8")``
    through ``build_train_step``: 2 warm-up and 10 timed steps, losses
    finite and falling, each flash kernel launched once a layer and the
    update kernel once a parameter a step; step ms, tokens/s, MFU, peak
    memory, the optimizer state's bytes; one profiled step with the update
    kernel's and the flash kernels' launches and device ms."""
    from paddle_ray_tpu_torch.models import gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import MemoryEfficientAdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    model = _build_1p3b()
    cfg = model.cfg
    shapes: dict = {}
    for p in model.parameters():
        shapes[tuple(p.shape)] = shapes.get(tuple(p.shape), 0) + 1
    if shapes != gpt_leaf_shapes(cfg):
        raise AssertionError(f"train_1p3b: leaves {shapes} are not "
                             f"gpt_leaf_shapes'")
    n_leaves = sum(shapes.values())
    opt = MemoryEfficientAdamW(M1P3B_LR, moment_dtype="int8")
    ts = build_train_step(model, opt, gpt_loss_fn)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (M1P3B_BATCH, TRAIN_SEQ))).to("cuda")
    batch = (ids, ids)
    per_step = {n: cfg.num_layers for n in FLASH_KERNELS}
    per_step[ME_KERNELS[0]] = n_leaves
    run = _timed_train(ts, lambda i: ts.step(batch), _me_counters(),
                       per_step, "train_1p3b")
    # one more step with every host-device sync an error: the update keys
    # and bias corrections are host numbers, the launches never wait
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = M1P3B_BATCH * TRAIN_SEQ * TIMED_STEPS / run["seconds"]
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ)
    step_ms = 1e3 * run["seconds"] / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "losses": run["losses"], "peak_memory_gb": run["peak_memory_gb"],
           "state_bytes": opt.state_nbytes(), "launches": run["launches"]}
    emit("train_1p3b", model=M1P3B, dtype="bfloat16", attn_impl="flash",
         head_dim=cfg.head_dim, batch=M1P3B_BATCH, seq=TRAIN_SEQ,
         optimizer=f"MemoryEfficientAdamW({M1P3B_LR}, moment_dtype='int8')",
         steps=run["steps"], timed_steps=TIMED_STEPS, n_params=n_params,
         leaves=n_leaves, flops_per_token=flops_per_token,
         sync_free_step=True, **out)
    out["profile"] = _profile_step(
        lambda: ts.step(batch), "train_1p3b_profile", step_ms,
        {"me_adamw": ("me_adamw_kernel",), "flash_fwd": ("flash_fwd",),
         "flash_dq": ("flash_bwd_dq",), "flash_dkv": ("flash_bwd_dkv",),
         "cublas": ("nvjet", "gemm"), "elementwise": ("elementwise",
                                                      "reduce_kernel")})
    del ts, model, opt, batch
    torch.cuda.empty_cache()
    return out


def phase_train_1p3b_offload(losses_on_device) -> dict:
    """``train_1p3b`` with ``offload_opt_state=True`` for
    ``M1P3B_OFFLOAD_STEPS`` steps from the same weights: every state
    tensor pinned host memory, the device holding no state but the
    staging buffers, the losses ``train_1p3b``'s first ones bit for
    bit; then two more steps, each read back on the host at once: a bare
    read of ``opt.state`` (whether it saw a copy still running is
    reported) and ``opt.state_dict()``, which must equal the state once
    the device is idle."""
    from paddle_ray_tpu_torch.models import gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import MemoryEfficientAdamW
    from paddle_ray_tpu_torch.optimizer.optimizer import _state_tensors
    from paddle_ray_tpu_torch.parallel import build_train_step
    model = _build_1p3b()
    cfg = model.cfg
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    opt = MemoryEfficientAdamW(M1P3B_LR, moment_dtype="int8")
    ts = build_train_step(model, opt, gpt_loss_fn, offload_opt_state=True)
    state = [x for p in model.parameters()
             for _, x in _state_tensors(opt.state[p])]
    if not all(x.device.type == "cpu" and x.is_pinned() for x in state):
        raise AssertionError("train_1p3b_offload: a state tensor is not in "
                             "pinned host memory")
    torch.cuda.synchronize()
    staging = sum(b.numel() * b.element_size()
                  for b in opt._staging.values())
    # the caching allocator hands out a large block in whole 2 MiB
    mib2 = 2 << 20
    staging_alloc = sum(-(-b.numel() * b.element_size() // mib2) * mib2
                        for b in opt._staging.values())
    resident = torch.cuda.memory_allocated() - base
    if resident > staging_alloc:
        raise AssertionError(f"train_1p3b_offload: the optimizer holds "
                             f"{resident} bytes on the device, its staging "
                             f"buffers {staging} ({staging_alloc} "
                             f"allocated)")
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (M1P3B_BATCH, TRAIN_SEQ))).to("cuda")
    counters = _me_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the staged copies are non-blocking: no step waits for the device
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [ts.step((ids, ids)) for _ in range(M1P3B_OFFLOAD_STEPS)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    losses = [float(x) for x in losses]
    want = losses_on_device[:M1P3B_OFFLOAD_STEPS]
    if losses != want:
        raise AssertionError(f"train_1p3b_offload: losses {losses}, on the "
                             f"device {want}")
    n_leaves = sum(gpt_leaf_shapes(cfg).values())
    if launches[ME_KERNELS[0]] != n_leaves * M1P3B_OFFLOAD_STEPS:
        raise AssertionError(f"train_1p3b_offload: launches {launches}")

    # the copies back to the host run after a step returns: a read of the
    # host state through state_dict() right after a step waits for them
    # and sees the values it holds once the device is idle; a bare read of
    # opt.state at the same point is reported, not checked.  Both read the
    # last-updated parameters first: the host runs ahead of the device by
    # the launch queue, so theirs are the copies still to come
    def host_state(st):
        return [x for s in reversed(list(st)) for _, x in _state_tensors(s)]
    ts.step((ids, ids))
    bare = [x.clone() for x in host_state(opt.state.values())]
    torch.cuda.synchronize()
    stale_without_wait = not all(torch.equal(a, b) for a, b in zip(
        bare, host_state(opt.state.values())))
    del bare
    ts.step((ids, ids))
    sd = opt.state_dict()["state"]
    read = [x.clone() for x in host_state(sd.values())]
    torch.cuda.synchronize()
    final = host_state(sd.values())
    if len(read) != len(state) or not all(
            torch.equal(a, b) for a, b in zip(read, final)):
        raise AssertionError("train_1p3b_offload: state_dict() right after "
                             "a step does not hold the step's state")
    del read, final, sd
    out = {"step_ms": 1e3 * dt / M1P3B_OFFLOAD_STEPS, "losses": losses,
           "host_state_bytes": opt.state_nbytes(), "staging_bytes": staging,
           "optimizer_device_bytes": resident, "launches": launches,
           "stale_without_wait": stale_without_wait}
    emit("train_1p3b_offload", model=M1P3B, batch=M1P3B_BATCH,
         seq=TRAIN_SEQ, steps=M1P3B_OFFLOAD_STEPS, pinned=True,
         losses_equal_on_device=True, sync_free_steps=True,
         state_read_after_step_waits=True, **out)
    del ts, model, opt, ids
    torch.cuda.empty_cache()
    return out


def phase_amp_train() -> dict:
    """gpt3-350m with float32 parameters (flash) under
    ``amp.auto_cast(dtype="bfloat16")`` (O1) with ``AdamW(1e-4)``: the
    linears' products and the attention in bf16 (the qkv projection's
    output is bf16, so the bf16 flash kernels run), 2 warm-up and
    ``AMP_STEPS`` steps, losses finite and falling; then O2:
    ``amp.decorate(model, dtype="bfloat16")`` with float32 masters in a
    new AdamW, under ``auto_cast(level="O2")``, the same."""
    from paddle_ray_tpu_torch import amp
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_gpt(MODEL, device="cuda", dtype=torch.float32,
                      attn_impl="flash", remat=False, max_seq_len=TRAIN_SEQ,
                      generator=g)
    cfg = model.cfg
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (AMP_BATCH, TRAIN_SEQ))).to("cuda")
    seen = []
    hook = model.blocks[0].attn.qkv.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    out = {}
    for level in ("O1", "O2"):
        if level == "O2":
            amp.decorate(model, dtype="bfloat16")
        ts = build_train_step(model, AdamW(TRAIN_LR), gpt_loss_fn)

        def step(i, ts=ts, level=level):
            with amp.auto_cast(dtype="bfloat16", level=level):
                return ts.step((ids, ids))
        seen.clear()
        run = _timed_train(ts, step, _flash_counters(),
                           {n: cfg.num_layers for n in FLASH_KERNELS},
                           f"amp_train {level}", timed=AMP_STEPS)
        if set(seen) != {torch.bfloat16}:
            raise AssertionError(f"amp_train {level}: qkv outputs {seen}")
        masters = [s["master"].dtype for s in ts.opt.state.values()
                   if "master" in s]
        out[level] = {"step_ms": 1e3 * run["seconds"] / AMP_STEPS,
                      "losses": run["losses"],
                      "param_dtype": str(next(model.parameters()).dtype),
                      "masters": len(masters),
                      "peak_memory_gb": run["peak_memory_gb"],
                      "launches": run["launches"]}
        if level == "O2" and (masters != [torch.float32] * len(
                list(model.parameters()))):
            raise AssertionError("amp_train O2: a parameter without a "
                                 "float32 master")
    hook.remove()
    emit("amp_train", model=MODEL, batch=AMP_BATCH, seq=TRAIN_SEQ,
         compute_dtype="bfloat16", qkv_dtype="bfloat16", **out)
    del ts, model, ids
    torch.cuda.empty_cache()
    return out


def _optimizer_cases():
    from paddle_ray_tpu_torch import optimizer as O
    return {"SGD": lambda: O.SGD(1e-2), "Momentum": lambda: O.Momentum(
        1e-2, use_nesterov=True), "Lamb": lambda: O.Lamb(1e-3),
        "Adamax": lambda: O.Adamax(1e-3), "Adadelta": lambda: O.Adadelta(),
        "Adagrad": lambda: O.Adagrad(1e-2),
        "RMSProp": lambda: O.RMSProp(1e-3), "LARS": lambda: O.LARS(0.1),
        "MemoryEfficientAdamW": lambda: O.MemoryEfficientAdamW(1e-3)}


def phase_optimizers_check() -> None:
    """A 4-layer float32 GPT of gpt3-350m's width (flash, B 2, S 512; the
    vocabulary cut to ``OPT_CHECK_VOCAB``, since the CPU copy's updates
    take most of the phase's time) on the card, and a CPU copy of its
    parameters under the same optimizer, fed the card's gradients: 3
    steps of each optimizer of ``_optimizer_cases`` from the same weights,
    TF32 off.  Each parameter on the card within ``OPT_CHECK_TOL``
    (``max|err| / max|ref|``) of the CPU's (the plain versions), the
    losses finite."""
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    ref = build_gpt(MODEL, device="cuda", dtype=torch.float32, num_layers=4,
                    max_seq_len=512, vocab_size=OPT_CHECK_VOCAB,
                    attn_impl="flash", generator=g)
    ids = torch.from_numpy(np.random.RandomState(SEED + 4).randint(
        0, ref.cfg.vocab_size, (2, 512))).to("cuda")
    results = {}
    for name, make in _optimizer_cases().items():
        m = copy.deepcopy(ref)
        ts = build_train_step(m, make(), gpt_loss_fn)
        host = {n: torch.nn.Parameter(p.detach().cpu().clone())
                for n, p in m.named_parameters()}
        host_opt = make()
        host_opt.bind(list(host.items()))
        losses = []
        for _ in range(3):
            losses.append(float(ts.step((ids, ids))))
            for n, p in m.named_parameters():
                host[n].grad = p.grad.cpu()
            host_opt.step()
        err = max(_rel_err(p.detach().cpu(), host[n].detach())
                  for n, p in m.named_parameters())
        results[name] = {"losses": losses, "max_param_rel_err": err}
        if err > OPT_CHECK_TOL or not all(np.isfinite(losses)):
            raise AssertionError(f"optimizers_check {name}: {results[name]}")
        del ts, m, host, host_opt
    emit("optimizers_check", dtype="float32", layers=4, batch=2, seq=512,
         vocab=OPT_CHECK_VOCAB, tol=OPT_CHECK_TOL, results=results)
    del ref
    torch.cuda.empty_cache()


def phase_scaler_check() -> None:
    """A 4-layer bf16 GPT of gpt3-350m's width (flash, B 2, S 512) with
    ``MemoryEfficientAdamW`` and a ``GradScaler`` (2**15, halving after
    one bad step): a clean step, then a step whose loss is multiplied by
    inf leaves the parameters, every state tensor and the step count
    bit-equal and halves the scale; a clean step after it updates."""
    from paddle_ray_tpu_torch.amp import GradScaler
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import MemoryEfficientAdamW
    from paddle_ray_tpu_torch.optimizer.optimizer import _state_tensors
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      num_layers=4, max_seq_len=512, attn_impl="flash",
                      generator=g)
    poison = torch.ones((), device="cuda")

    def loss_fn(m, batch, rng):
        return gpt_loss_fn(m, batch, rng) * poison
    scaler = GradScaler(init_loss_scaling=2.0 ** 15,
                        decr_every_n_nan_or_inf=1, incr_every_n_steps=10 ** 6)
    ts = build_train_step(model, MemoryEfficientAdamW(1e-4), loss_fn,
                          scaler=scaler)
    ids = torch.from_numpy(np.random.RandomState(SEED + 5).randint(
        0, model.cfg.vocab_size, (2, 512))).to("cuda")

    def snapshot():
        return [x.clone() for p in model.parameters()
                for x in [p.detach()] + [t for _, t in
                                         _state_tensors(ts.opt.state[p])]]
    l0 = float(ts.step((ids, ids)))
    before, scale0 = snapshot(), float(ts.scaler_state.scale)
    count0 = ts.opt.step_count
    poison.fill_(float("inf"))
    ts.step((ids, ids))
    after = snapshot()
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    scale1 = float(ts.scaler_state.scale)
    if not same or ts.opt.step_count != count0 or scale1 != scale0 / 2:
        raise AssertionError(f"scaler_check: bad step kept state {same}, "
                             f"step {ts.opt.step_count} vs {count0}, scale "
                             f"{scale1} vs {scale0}")
    poison.fill_(1.0)
    l2 = float(ts.step((ids, ids)))
    moved = not all(torch.equal(a, b) for a, b in zip(before, snapshot()))
    if not moved or ts.opt.step_count != count0 + 1 or not np.isfinite(l2):
        raise AssertionError("scaler_check: the clean step after the bad "
                             "one did not update")
    emit("scaler_check", dtype="bfloat16", layers=4, batch=2, seq=512,
         loss_first=l0, loss_after=l2, scale_before=scale0,
         scale_after_bad=scale1, state_bit_equal_after_bad=same,
         step_count=ts.opt.step_count)
    del ts, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 34-35. checkpoints and the resilient train loop: kill anywhere, resume
# ---------------------------------------------------------------------------
RES_STEPS, RES_INTERVAL, RES_LAG, RES_KEEP = 8, 2, 1, 2
# train_resilient's plan: a kill at step 4, inside the overlapped write of
# step_4 (the second life resumes from step_2, written while step 2
# updated the state in place and committed before step 3), a loss-fetch
# failure at step 5, the save-IO failure of step_6 and a preempt at step 7
# (a synchronous save of step_7; the third life resumes there)
RES_PLAN = ((4, "kill"), (5, "fetch"), (6, "save_io"),
            (7, "preempt_signal"))
# train_resilient_check: gpt3-1.3b's width, 4 layers, batch 4 x 1024, 6
# steps; a kill at step 5, inside the overlapped write of step_4 (the
# second life resumes from step_2)
RES_CHECK_LAYERS, RES_CHECK_BATCH, RES_CHECK_STEPS = 4, 4, 6
RES_CHECK_PLAN = ((5, "kill"),)


def resilient_launches(layers) -> dict:
    """Launches a step of ``train_resilient``'s model (remat off, dropout
    on): each flash kernel once a layer, the dropout kernel 1 + 2 L times
    forward and as often backward (the embedding's and each block's
    attention and MLP outputs)."""
    return {DROPOUT_KERNELS[0]: 2 * (1 + 2 * layers),
            **{k: layers for k in FLASH_KERNELS}}


def _checkpoint_dir(nbytes: int) -> str:
    """A new directory for a phase's checkpoints under the system temp
    directory (``TMPDIR``), which must have room for ``RES_KEEP`` + 2 of
    them (the kept steps, the one being written and the one a commit
    replaces).  A run killed before its phase ends leaves it there."""
    import tempfile
    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    if free < (RES_KEEP + 2) * nbytes:
        raise AssertionError(
            f"{base} has {free} bytes free, checkpoints need "
            f"{(RES_KEEP + 2) * nbytes}: point TMPDIR at a larger disk")
    return tempfile.mkdtemp(prefix="resilient-", dir=base)


def _capture_bytes(ts) -> int:
    from paddle_ray_tpu_torch.checkpoint.sharded import _leaf_map
    return sum(t.numel() * t.element_size()
               for t in _leaf_map(ts.capture()).values())


def _timed_life(loop, times) -> None:
    """Time ``loop``'s save dispatches, commit waits and restore, and each
    step from its dispatch to its loss's fetch, a step tagged with whether
    a checkpoint write was in flight."""
    mgr, ts = loop.manager, loop.ts
    save, wait, resume = mgr.save, mgr.wait, loop.resume
    step, fetch = ts.step, loop._fetch_loss
    cur = {}

    def timed(key, fn, when=lambda: True):
        def run(*a, **kw):
            on, t0 = when(), time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if on:
                    times[key].append(1e3 * (time.perf_counter() - t0))
        return run

    def t_step(*a, **kw):
        cur.update(t0=time.perf_counter(),
                   overlapped=mgr._pending_commit is not None)
        return step(*a, **kw)

    def t_fetch(*a, **kw):
        val = fetch(*a, **kw)
        times["step_ms_overlapped" if cur["overlapped"]
              else "step_ms"].append(1e3 * (time.perf_counter() - cur["t0"]))
        return val

    mgr.save = timed("save_dispatch_ms", save)
    mgr.wait = timed("commit_wait_ms", wait,
                     lambda: mgr._pending_commit is not None)
    loop.resume = timed("restore_ms", resume,
                        lambda: mgr.latest_step() is not None)
    ts.step, loop._fetch_loss = t_step, t_fetch


def _resilient_run(name, make_ts, data_fn, n_steps, plan_events, counters,
                   per_step) -> dict:
    """The uninterrupted curve of ``n_steps`` (step k's key ``fold_in(
    PRNGKey(SEED), k)``), then ``ResilientTrainLoop`` lives under the
    fixed plan, each on a train state built afresh, relaunched after a
    kill or a preempt until the run completes: the curve assembled across
    lives must equal the uninterrupted one bit for bit, the lives be one
    more than the plan's kills and preempts, every event fire, and each
    counted kernel launch ``per_step`` times for every step the lives
    executed.  The checkpoints go to :func:`_checkpoint_dir`, removed
    after."""
    import collections
    import warnings
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.train import (ChaosKill, ResilientTrainLoop,
                                            TrainFaultEvent, TrainFaultPlan)
    counters = {k: c if isinstance(c, tuple) else (c, "launches")
                for k, c in counters.items()}
    ts = make_ts()
    nbytes = _capture_bytes(ts)
    key = prng.PRNGKey(SEED)
    ref, ref_ms = [], []
    for s in range(n_steps):
        t0 = time.perf_counter()
        ref.append(float(ts.step(data_fn(s), prng.fold_in(key, s))))
        ref_ms.append(1e3 * (time.perf_counter() - t0))
    del ts
    torch.cuda.empty_cache()
    directory = _checkpoint_dir(nbytes)
    plan = TrainFaultPlan([TrainFaultEvent(k, kind)
                           for k, kind in plan_events])
    times = collections.defaultdict(list)
    curve, lives = {}, []
    _reset(counters)
    try:
        while True:
            if len(lives) > 2 * len(plan_events) + 1:
                raise AssertionError(f"{name}: relaunches did not end")
            ts = make_ts()
            loop = ResilientTrainLoop(
                ts, data_fn, directory, seed=SEED, rng=True,
                save_interval_steps=RES_INTERVAL, max_to_keep=RES_KEEP,
                commit_lag=RES_LAG, chaos=plan)
            _timed_life(loop, times)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    status = loop.run(n_steps).status
                except ChaosKill:
                    status = "killed"
            curve.update(loop.step_losses)
            lives.append({"status": status,
                          "steps": sorted(loop.step_losses),
                          "committed": loop.manager.all_steps()})
            # the timing wrappers and the loop's chaos hook are cycles:
            # collect them, so that a life's state is freed before the next
            del loop, ts
            gc.collect()
            torch.cuda.empty_cache()
            if status == "complete":
                break
        launches = _read(counters)
        ckpt_bytes = sum(
            os.path.getsize(os.path.join(root, f))
            for root, _, files in os.walk(os.path.join(
                directory, f"step_{n_steps}")) for f in files)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    executed = sum(len(life["steps"]) for life in lives)
    relaunches = sum(1 for _, kind in plan_events
                     if kind in ("kill", "preempt_signal"))
    if sorted(curve) != list(range(n_steps)) or any(
            curve[s] != ref[s] for s in range(n_steps)):
        raise AssertionError(
            f"{name}: the curve across lives is not the uninterrupted one: "
            f"{[curve.get(s) for s in range(n_steps)]} vs {ref}")
    if len(lives) != relaunches + 1 or \
            sorted(plan.fired_log()) != sorted(plan_events):
        raise AssertionError(f"{name}: lives {lives}, fired "
                             f"{plan.fired_log()} of {plan_events}")
    for k, n in launches.items():
        if n != per_step[k] * executed:
            raise AssertionError(f"{name}: {k} launched {n} times in "
                                 f"{executed} steps, want {per_step[k]} a "
                                 f"step")
    return {"losses": ref, "lives": lives, "fired": plan.fired_log(),
            "executed_steps": executed, "launches": launches,
            "checkpoint_dir": os.path.dirname(directory),
            "checkpoint_bytes": ckpt_bytes, "capture_bytes": nbytes,
            "step_ms_uninterrupted": ref_ms,
            **{k: v for k, v in times.items()}}


def phase_train_resilient(smi) -> dict:
    """gpt3-350m at full width (bf16, flash, remat off, dropout 0.1, batch
    8 x 1024, ``AdamW(1e-4)``) under ``ResilientTrainLoop`` for
    ``RES_STEPS`` steps, saving every ``RES_INTERVAL`` with ``commit_lag``
    ``RES_LAG``, through ``RES_PLAN``'s kill, save-IO, fetch and preempt
    faults (:func:`_resilient_run`); the save-dispatch, commit-wait and
    restore times, the checkpoint's bytes and the step time with and
    without an overlapped write, beside the card's name and power
    limit."""
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.models.gpt import gpt_config
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    cfg = gpt_config(MODEL)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (RES_STEPS, TRAIN_BATCH, TRAIN_SEQ))).to("cuda")

    def make_ts():
        g.manual_seed(SEED)
        model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                          attn_impl="flash", remat=False, dropout=0.1,
                          max_seq_len=TRAIN_SEQ, generator=g)
        return build_train_step(model, AdamW(TRAIN_LR), gpt_loss_fn)

    out = _resilient_run("train_resilient", make_ts,
                         lambda s: (ids[s], ids[s]), RES_STEPS, RES_PLAN,
                         _recipe_counters(),
                         resilient_launches(cfg.num_layers))
    emit("train_resilient", card=smi, model=MODEL, dtype="bfloat16",
         attn_impl="flash", dropout=0.1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         optimizer=f"AdamW({TRAIN_LR})", steps=RES_STEPS,
         save_interval_steps=RES_INTERVAL, commit_lag=RES_LAG,
         max_to_keep=RES_KEEP, plan=RES_PLAN, curve_bit_equal=True,
         cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
         **out)
    del ids
    torch.cuda.empty_cache()
    return out


def phase_train_resilient_check(smi) -> dict:
    """A ``RES_CHECK_LAYERS``-layer model at gpt3-1.3b's width (bf16,
    flash, remat off, dropout 0.1, batch 4 x 1024) with
    ``MemoryEfficientAdamW(1e-4, moment_dtype="int8")`` and its state
    offloaded to pinned host memory, under ``ResilientTrainLoop`` through
    one kill inside an overlapped write: the curve bit for bit, the update
    kernel launched once a parameter for every step executed (the codes,
    scales and offloaded state through a restore)."""
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.models.gpt import gpt_config
    from paddle_ray_tpu_torch.ops.me_adamw import me_adamw_update
    from paddle_ray_tpu_torch.optimizer import MemoryEfficientAdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    over = dict(num_layers=RES_CHECK_LAYERS, attn_impl="flash", remat=False,
                dropout=0.1, max_seq_len=TRAIN_SEQ)
    cfg = gpt_config(M1P3B, **over)
    ids = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, cfg.vocab_size, (RES_CHECK_STEPS, RES_CHECK_BATCH,
                            TRAIN_SEQ))).to("cuda")
    # the update kernel: once a parameter a step
    per_step = dict(resilient_launches(cfg.num_layers))

    def make_ts():
        g.manual_seed(SEED + 6)
        model = build_gpt(M1P3B, device="cuda", dtype=torch.bfloat16,
                          generator=g, **over)
        per_step[ME_KERNELS[0]] = len(list(model.parameters()))
        ts = build_train_step(
            model, MemoryEfficientAdamW(M1P3B_LR, moment_dtype="int8"),
            gpt_loss_fn, offload_opt_state=True)
        if not ts.opt.offloaded:
            raise AssertionError("train_resilient_check: state not "
                                 "offloaded")
        return ts

    counters = {**_recipe_counters(), ME_KERNELS[0]: me_adamw_update}
    out = _resilient_run("train_resilient_check", make_ts,
                         lambda s: (ids[s], ids[s]), RES_CHECK_STEPS,
                         RES_CHECK_PLAN, counters, per_step)
    emit("train_resilient_check", card=smi, model=M1P3B,
         layers=RES_CHECK_LAYERS, dtype="bfloat16", dropout=0.1,
         batch=RES_CHECK_BATCH, seq=TRAIN_SEQ,
         optimizer=f"MemoryEfficientAdamW({M1P3B_LR}, moment_dtype=int8), "
                   f"offload_opt_state=True", steps=RES_CHECK_STEPS,
         save_interval_steps=RES_INTERVAL, commit_lag=RES_LAG,
         plan=RES_CHECK_PLAN, curve_bit_equal=True, **out)
    del ids
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 12. correctness of the training path on the card
# ---------------------------------------------------------------------------
def phase_train_check() -> None:
    """A 4-layer float32 model of gpt3-350m's width, built twice from one
    set of weights: flash kernels against plain dense attention."""
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    b, s = 2, 512
    models = {}
    for impl in ("flash", "dense"):
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 1)
        models[impl] = build_gpt(MODEL, device="cuda", dtype=torch.float32,
                                 num_layers=4, max_seq_len=s, remat=False,
                                 attn_impl=impl, generator=g)
    ids = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, models["flash"].cfg.vocab_size, (b, s))).to("cuda")
    grads = {}
    for impl, m in models.items():
        gpt_loss_fn(m, (ids, ids)).backward()
        grads[impl] = {n: p.grad.clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    grad_err = {n: _rel_err(grads["flash"][n], want)
                for n, want in grads["dense"].items()}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > 1e-3:
        raise AssertionError(f"train_check: grad of {worst} off by "
                             f"{grad_err[worst]} (max|err|/max|ref|)")
    losses = {}
    for impl, m in models.items():
        ts = build_train_step(m, AdamW(TRAIN_LR), gpt_loss_fn)
        losses[impl] = [float(ts.step((ids, ids))) for _ in range(3)]
    if not np.allclose(losses["flash"], losses["dense"], rtol=1e-3, atol=0):
        raise AssertionError(f"train_check: losses {losses}")
    emit("train_check", dtype="float32", layers=4, batch=b, seq=s,
         max_grad_rel_err=grad_err[worst], worst_param=worst,
         losses=losses, grad_tol=1e-3, loss_rtol=1e-3)
    del models, grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 14. the UNet training path: bench.py's SD-UNet
# ---------------------------------------------------------------------------
def _gn_counters():
    from paddle_ray_tpu_torch.ops.groupnorm import (fused_group_norm_bwd,
                                                    fused_group_norm_fwd)
    return dict(zip(GN_KERNELS, (fused_group_norm_fwd, fused_group_norm_bwd)))


def phase_unet_train() -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    from paddle_ray_tpu_torch.models import (UNetConfig, build_unet,
                                             unet_loss_fn)
    from paddle_ray_tpu_torch.ops.groupnorm import fused_group_norm
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_unet(UNetConfig(**UNET_CFG), dtype=torch.bfloat16,
                       device="cuda", generator=g)
    b, img = UNET_BATCH, UNET_IMG
    x = torch.randn(b, img, img, 4, generator=g, device="cuda").bfloat16()
    t = torch.randint(0, 1000, (b,), generator=g, device="cuda")
    eps = torch.randn(b, img, img, 4, generator=g, device="cuda").bfloat16()
    batch = (x, t, eps)
    # the forward's FLOPs (convolutions and matmuls, as counted by
    # PyTorch), x 3 for a training step: bench.py's convention
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, t)
    fwd_flops = fc.get_total_flops()
    ts = build_train_step(model, AdamW(UNET_LR), unet_loss_fn)
    counters = _gn_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    fused_group_norm.copies = 0
    losses = [ts.step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [ts.step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    copies = fused_group_norm.copies
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"unet losses not finite and falling: {losses}")
    per_step = len(unet_gn_calls())
    for n, count in launches.items():
        if count != per_step * steps:
            raise AssertionError(f"{n} launched {count} times in {steps} "
                                 f"steps, want {per_step} a step")
    images_per_s = b * TIMED_STEPS / dt
    step_ms = 1e3 * dt / TIMED_STEPS
    out = {"images_per_s": images_per_s, "step_ms": step_ms,
           "mfu": images_per_s * 3 * fwd_flops / b
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "launches_per_step": per_step,
           "group_norm_input_copies": copies}
    emit("unet_train", config=UNET_CFG, dtype="bfloat16", batch=b, img=img,
         optimizer=f"AdamW({UNET_LR})", steps=steps, timed_steps=TIMED_STEPS,
         n_params=sum(p.numel() for p in model.parameters()),
         fwd_flops_per_image=fwd_flops / b, losses=losses, **out)

    # one more step under the profiler: where a step's device time goes
    prof, rows, attempts = profiled(lambda: ts.step(batch))
    device_ms = sum(t_ for _, t_, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:12]

    def share(*keys):
        return sum(t_ for k, t_, _ in rows if any(q in k for q in keys)) / 1e3
    # device ms by kind, by kernel name (in this order): cuDNN's convolution
    # kernels are named fprop / dgrad / wgrad, cuBLAS's GEMMs gemm or nvjet
    kinds = {"group_norm": ("gn_fwd", "gn_bwd"),
             "convolution": ("fprop", "dgrad", "wgrad", "convolve", "cudnn"),
             "matmul": ("gemm", "nvjet"), "softmax": ("softmax",)}
    by_kind, seen = {}, set()
    for kind, keys in kinds.items():
        names = {k for k, _, _ in rows if k not in seen
                 and any(q in k.lower() for q in keys)}
        seen |= names
        by_kind[kind] = sum(t_ for k, t_, _ in rows if k in names) / 1e3
    by_kind["other"] = device_ms - sum(by_kind.values())
    emit("unet_profile", steps=1, step_ms_unprofiled=step_ms,
         profile_attempts=attempts,
         device_ms=device_ms, device_idle_share=1.0 - device_ms / step_ms,
         kernels_launched=sum(c for _, _, c in rows),
         device_ms_by_kind=by_kind,
         group_norm_ms={"fwd": share("gn_fwd"), "bwd": share("gn_bwd")},
         top_kernels=[{"name": k[:90], "ms": t_ / 1e3, "calls": c}
                      for k, t_, c in top],
         annotated_spans=[{"name": k, "ms": t_ / 1e3}
                          for k, t_ in annotation_spans(prof)])
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 15. correctness of the UNet training path on the card
# ---------------------------------------------------------------------------
UNET_CHECK_CFG = dict(UNET_CFG, channel_mults=(1, 2), blocks_per_level=1,
                      attn_levels=(1,))


def phase_unet_check() -> None:
    """A shallow float32 UNet of SD width on the card (kernels) and as a
    copy on the CPU (plain versions), TF32 off for both convolutions and
    matmuls."""
    from paddle_ray_tpu_torch.models import (UNetConfig, build_unet,
                                             unet_loss_fn)
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    models = {"cuda": build_unet(UNetConfig(**UNET_CHECK_CFG),
                                 dtype=torch.float32, device="cuda",
                                 generator=g)}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    r = np.random.RandomState(SEED + 3)
    b, img = 2, 32
    arrays = (r.randn(b, img, img, 4).astype(np.float32),
              np.asarray([17, 901]),
              r.randn(b, img, img, 4).astype(np.float32))
    batches = {dev: tuple(torch.from_numpy(a).to(dev) for a in arrays)
               for dev in models}
    counters = _gn_counters()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        ys = {dev: m(*batches[dev][:2]) for dev, m in models.items()}
    fwd_err = _rel_err(ys["cuda"].cpu(), ys["cpu"])
    if not fwd_err <= 1e-4:
        raise AssertionError(f"unet_check: forward off by {fwd_err} "
                             f"(max|err|/max|ref|)")
    grads = {}
    for dev, m in models.items():
        unet_loss_fn(m, batches[dev]).backward()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in
                      m.named_parameters()}
        m.zero_grad(set_to_none=True)
    launches = {n: c.launches for n, c in counters.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"unet_check: GroupNorm kernels not launched "
                             f"on the card: {launches}")
    grad_err = {n: _rel_err(grads["cuda"][n], want)
                for n, want in grads["cpu"].items()}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > 1e-3:
        raise AssertionError(f"unet_check: grad of {worst} off by "
                             f"{grad_err[worst]} (max|err|/max|ref|)")
    losses = {}
    for dev, m in models.items():
        ts = build_train_step(m, AdamW(UNET_LR), unet_loss_fn)
        losses[dev] = [float(ts.step(batches[dev])) for _ in range(3)]
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-3, atol=0):
        raise AssertionError(f"unet_check: losses {losses}")
    emit("unet_check", config=UNET_CHECK_CFG, dtype="float32", batch=b,
         img=img, tf32=False, forward_rel_err=fwd_err,
         max_grad_rel_err=grad_err[worst], worst_param=worst,
         losses=losses, launches=launches, fwd_tol=1e-4, grad_tol=1e-3,
         loss_rtol=1e-3)
    del models, grads, ys
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. the BERT pretraining path: bench.py's BERT-large
# ---------------------------------------------------------------------------
def _profile_step(step, label, step_ms, groups) -> dict:
    """One more ``step()`` under ``torch.profiler``: device ms, idle
    share, launches, the top kernels and the device ms and calls of each
    named group of kernel-name keys (the profiler's warm-up call is one
    more ``step()``).  Returns the emitted fields."""
    prof, rows, attempts = profiled(step)
    device_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:10]
    out = dict(
        steps=1, step_ms_unprofiled=step_ms, device_ms=device_ms,
        profile_attempts=attempts,
        device_idle_share=1.0 - device_ms / step_ms,
        kernels_launched=sum(c for _, _, c in rows),
        group_ms={name: sum(t for k, t, _ in rows
                            if any(q in k for q in keys)) / 1e3
                  for name, keys in groups.items()},
        group_calls={name: sum(c for k, _, c in rows
                               if any(q in k for q in keys))
                     for name, keys in groups.items()},
        top_kernels=[{"name": k[:90], "ms": t / 1e3, "calls": c}
                     for k, t, c in top],
        annotated_spans=[{"name": k, "ms": t / 1e3}
                         for k, t in annotation_spans(prof)])
    emit(label, **out)
    return out


def _timed_train(ts, step, counters, per_step, what,
                 timed=TIMED_STEPS) -> dict:
    """2 warm-up and ``timed`` (10) timed ``step()`` calls with the kernel
    counters set to 0 first: losses finite and falling, each counter at
    ``per_step`` a step.  Returns the losses, seconds and launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses = [step(i) for i in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(WARMUP_STEPS + i) for i in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    steps = WARMUP_STEPS + timed
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what} losses not finite and falling: "
                             f"{losses}")
    for n, count in launches.items():
        if count != per_step[n] * steps:
            raise AssertionError(f"{what}: {n} launched {count} times in "
                                 f"{steps} steps, want {per_step[n]} a step")
    return {"losses": losses, "seconds": dt, "launches": launches,
            "steps": steps,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}


def phase_bert_train() -> dict:
    from paddle_ray_tpu_torch.models import (BertForPretraining, bert_config,
                                             bert_pretrain_loss_fn)
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    cfg = bert_config(BERT_MODEL, max_seq_len=BERT_SEQ, dtype="bfloat16",
                      attn_impl="flash")
    model = BertForPretraining(cfg, device="cuda", generator=g)
    ts = build_train_step(model, AdamW(BERT_LR), bert_pretrain_loss_fn)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))).to("cuda")
    batch = {"ids": ids, "mlm_labels": ids,
             "nsp_labels": torch.zeros(BERT_BATCH, dtype=torch.long,
                                       device="cuda")}
    counters = _flash_counters()
    run = _timed_train(ts, lambda i: ts.step(batch), counters,
                       {n: cfg.num_layers for n in counters}, "bert_train")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = BERT_BATCH * BERT_SEQ * TIMED_STEPS / run["seconds"]
    # bench.py's count: 6 N + 12 L H S FLOP per token, against the bf16 peak
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * BERT_SEQ)
    step_ms = 1e3 * run["seconds"] / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "peak_memory_gb": run["peak_memory_gb"],
           "launches": run["launches"]}
    emit("bert_train", model=BERT_MODEL, dtype="bfloat16",
         attn_impl="flash", batch=BERT_BATCH, seq=BERT_SEQ,
         optimizer=f"AdamW({BERT_LR})", steps=run["steps"],
         timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=run["losses"], **out)
    _profile_step(lambda: ts.step(batch), "bert_profile", step_ms,
                  {"flash": ("flash_",), "matmul": ("gemm", "nvjet")})
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 18. correctness of the BERT path on the card
# ---------------------------------------------------------------------------
def phase_bert_check() -> None:
    """BERT-large width in float32, 4 layers, padded (segment ids on the
    flash path), on the card (kernels) and as a copy on the CPU (plain
    versions), TF32 off."""
    from paddle_ray_tpu_torch.models import (BertForPretraining, bert_config,
                                             bert_pretrain_loss_fn)
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = 2, BERT_SEQ
    cfg = bert_config(BERT_MODEL, max_seq_len=s, num_layers=4,
                      attn_impl="flash")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    models = {"cuda": BertForPretraining(cfg, device="cuda", generator=g)}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    r = np.random.RandomState(SEED + 4)
    lengths = (512, 333)
    arrays = {"ids": r.randint(0, cfg.vocab_size, (b, s)),
              "token_type_ids": (np.arange(s)[None, :] >= 200).repeat(b, 0),
              "attention_mask": (np.arange(s)[None, :]
                                 < np.asarray(lengths)[:, None]),
              "mlm_labels": np.where(r.rand(b, s) < 0.15,
                                     r.randint(0, cfg.vocab_size, (b, s)),
                                     -100),
              "nsp_labels": np.asarray([0, 1])}
    batches = {dev: {k: torch.from_numpy(np.asarray(a)).long().to(dev)
                     for k, a in arrays.items()} for dev in models}
    counters = _flash_counters()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        logits = {dev: m(batches[dev]["ids"], batches[dev]["token_type_ids"],
                         batches[dev]["attention_mask"])[0]
                  for dev, m in models.items()}
    fwd_err = _rel_err(logits["cuda"].cpu(), logits["cpu"])
    if not fwd_err <= 1e-4:
        raise AssertionError(f"bert_check: MLM logits off by {fwd_err} "
                             f"(max|err|/max|ref|)")
    del logits
    grads = {}
    for dev, m in models.items():
        bert_pretrain_loss_fn(m, batches[dev]).backward()
        grads[dev] = {n: p.grad.detach().cpu()
                      for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    launches = {n: c.launches for n, c in counters.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"bert_check: flash kernels not launched on "
                             f"the card: {launches}")
    grad_err = {n: _rel_err(grads["cuda"][n], want)
                for n, want in grads["cpu"].items()}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > 1e-3:
        raise AssertionError(f"bert_check: grad of {worst} off by "
                             f"{grad_err[worst]} (max|err|/max|ref|)")
    losses = {}
    for dev, m in models.items():
        ts = build_train_step(m, AdamW(BERT_LR), bert_pretrain_loss_fn)
        losses[dev] = [float(ts.step(batches[dev])) for _ in range(3)]
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-3, atol=0):
        raise AssertionError(f"bert_check: losses {losses}")
    emit("bert_check", dtype="float32", layers=4, batch=b, seq=s,
         lengths=list(lengths), tf32=False, forward_rel_err=fwd_err,
         max_grad_rel_err=grad_err[worst], worst_param=worst,
         losses=losses, launches=launches, fwd_tol=1e-4, grad_tol=1e-3,
         loss_rtol=1e-3)
    del models, grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 19. the fused encoder: 24 FusedTransformerEncoderLayer of BERT-large width
# ---------------------------------------------------------------------------
class _EncoderStack(torch.nn.Module):
    """``FusedTransformerEncoderLayer``s in a row, each under its own key
    (``fold_in(rng, layer)``)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, src, src_mask, rng=None):
        from paddle_ray_tpu_torch.core import prng
        for i, layer in enumerate(self.layers):
            src = layer(src, src_mask,
                        rng=None if rng is None else prng.fold_in(rng, i))
        return src


def _dal_counters():
    from paddle_ray_tpu_torch.ops.fused import dal_backward, dal_forward
    return dict(zip(DAL_KERNELS, (dal_forward, dal_backward)))


def _encoder_stack(n_layers, dtype, g, device="cuda") -> _EncoderStack:
    """The fused encoder at BERT-large width (post-LN, dropout 0.1 at the
    residuals only), weights drawn from ``g``."""
    from paddle_ray_tpu_torch.incubate import FusedTransformerEncoderLayer
    return _EncoderStack([FusedTransformerEncoderLayer(
        ENC_D, ENC_HEADS, ENC_FFN, dropout_rate=ENC_RATE, activation="gelu",
        attn_dropout_rate=0.0, act_dropout_rate=0.0, normalize_before=False,
        dtype=dtype, device=device, generator=g)
        for _ in range(n_layers)])


def _padding_mask(lengths, s, device="cuda") -> torch.Tensor:
    """``[B, S]`` boolean: True on each row's first ``lengths[b]`` keys."""
    return (torch.arange(s, device=device)[None, :]
            < torch.tensor(lengths, device=device)[:, None])


def phase_encoder_train() -> dict:
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = _encoder_stack(ENC_LAYERS, "bfloat16", g)
    b, s = ENC_BATCH, ENC_SEQ
    src = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    target = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    src_mask = _padding_mask(ENC_LENGTHS, s)[:, None, None, :]

    def loss_fn(m, batch, rng):
        x, mask, y = batch
        return ((m(x, mask, rng).float() - y.float()) ** 2).mean()
    ts = build_train_step(model, AdamW(ENC_LR), loss_fn)
    batch = (src, src_mask, target)
    root = prng.PRNGKey(0)
    counters = {**_dal_counters(), **_flash_counters()}
    per_step = {**{n: 2 * ENC_LAYERS for n in DAL_KERNELS},
                **{n: ENC_LAYERS for n in FLASH_KERNELS}}
    run = _timed_train(ts, lambda i: ts.step(batch, prng.fold_in(root, i)),
                       counters, per_step, "encoder_train")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = b * s * TIMED_STEPS / run["seconds"]
    flops_per_token = 6 * n_params + 12 * ENC_LAYERS * ENC_D * s
    step_ms = 1e3 * run["seconds"] / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "peak_memory_gb": run["peak_memory_gb"],
           "launches": run["launches"]}
    emit("encoder_train", layers=ENC_LAYERS, d_model=ENC_D, heads=ENC_HEADS,
         ffn=ENC_FFN, dropout_rate=ENC_RATE, dtype="bfloat16", batch=b,
         seq=s, lengths=list(ENC_LENGTHS), optimizer=f"AdamW({ENC_LR})",
         steps=run["steps"], timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=run["losses"], **out)
    _profile_step(lambda: ts.step(batch, prng.fold_in(root, 99)),
                  "encoder_profile", step_ms,
                  {"dropout_add_layernorm": ("dal_fwd", "dal_bwd"),
                   "flash": ("flash_",), "matmul": ("gemm", "nvjet")})
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 20. the int8 matmul kernel against its plain version
# ---------------------------------------------------------------------------
def _int8_bound(m, k, n, out_dtype, x_scale=True, bias_dtype=None) -> dict:
    """The least time: the int8 operands, the float32 scales (and the
    bias) read once, the output written once, over the HBM rate, against
    2 M N K operations over the int8 tensor-core peak; the larger of the
    two."""
    es = torch.tensor([], dtype=out_dtype).element_size()
    n_bytes = m * k + k * n + 4 * n + m * n * es + (4 * m if x_scale else 0)
    if bias_dtype is not None:
        n_bytes += n * torch.tensor([], dtype=bias_dtype).element_size()
    ops = 2 * m * n * k
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.int8]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _int8_case(name, m, k, n, out_dtype, timed, linear_form=False,
               bias_dtype=None) -> dict:
    """One case: the kernel (through ``int8_mm`` on the K-major weight, as
    ``QuantizedLinear`` calls it) against ``int8_matmul_plain`` on the
    ``[K, N]`` weight, on the same random int8 values and positive scales:
    ``torch.equal``, and the same bits in two calls.  ``linear_form``: no
    x scale and ``w_scale = s_x * s_w``, as ``QuantizedLinear`` calls it;
    ``bias_dtype``: a bias of that type added before the cast.  With
    ``timed`` the kernel, the plain version and the library yardstick
    ``torch._int_mm`` (its B operand made column-major first, outside the
    timing) followed by the scale products (and the bias add and cast),
    and ``torch._int_mm``'s int32 product alone, where ``torch._int_mm``
    takes the shape (K and N multiples of 8, M above 16)."""
    from paddle_ray_tpu_torch.ops.fused import int8_matmul_plain, int8_mm
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + m + k + n)
    xq = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    xs = torch.rand(m, generator=g, device="cuda") * 1e-2 + 1e-3
    ws = torch.rand(n, generator=g, device="cuda") * 1e-2 + 1e-3
    bias = None if bias_dtype is None else (
        0.1 * torch.randn(n, generator=g, device="cuda")).to(bias_dtype)
    if linear_form:
        xs = None
        ws = ws * 0.0371
    wt = wq.t().contiguous()        # the K-major copy QuantizedLinear keeps

    def kernel():
        return int8_mm(xq, wt, xs, ws, out_dtype, bias=bias, k_major=True)
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    want = int8_matmul_plain(xq, wq, xs, ws, out_dtype, bias=bias)
    err = float((got.float() - want.float()).abs().max())
    same = bool(torch.equal(got, again))
    if not (torch.equal(got, want) and torch.isfinite(got).all() and same):
        raise AssertionError(f"int8_matmul {name}: kernel differs from the "
                             f"plain version (max_abs_err {err}) or gives "
                             f"other bits in a second call ({not same})")
    r = {"max_abs_err": err, "equal": True, "same_bits_twice": same,
         "masked_path": k % 16 != 0,
         **_int8_bound(m, k, n, out_dtype, xs is not None, bias_dtype)}
    if timed:
        r.update(ms=time_ms(kernel),
                 plain_ms=time_ms(lambda: int8_matmul_plain(
                     xq, wq, xs, ws, out_dtype, bias=bias), iters=5),
                 library_ms=None, int_mm_ms=None)
        if k % 8 == 0 and n % 8 == 0 and m > 16:
            w_cm = wq.t().contiguous().t()   # column-major, as _int_mm wants

            def library():
                y = torch._int_mm(xq, w_cm).float()
                if xs is not None:
                    y = y * xs[:, None]
                y = y * ws[None, :]
                return (y if bias is None else y + bias).to(out_dtype)
            r.update(library_ms=time_ms(library),
                     int_mm_ms=time_ms(lambda: torch._int_mm(xq, w_cm)))
    emit("int8_mm_kernel", case=name, shape=[m, k, n],
         out_dtype=str(out_dtype), linear_form=linear_form,
         bias=None if bias_dtype is None else str(bias_dtype), timed=timed,
         library="torch._int_mm(xq, wq column-major) then * x_scale[:, "
                 "None] * w_scale[None, :] (+ bias) in float32, cast", **r)
    return r


def phase_int8_mm_kernel() -> dict:
    """The fused encoder's four linears at M = 8 x 512 and gpt3-350m's
    fc1 at its training batch, then the four in the ``QuantizedLinear``
    form of the bf16 encoder (bias and output in bfloat16; the forward
    sums these), bfloat16 output, the float32 ``QuantizedLinear`` form,
    and ragged M, N and K (K 1000 and 5 x 37 x 3: the masked path's byte
    loads; K 1040: TMA with a part-empty last stage), all timed."""
    m = ENC_BATCH * ENC_SEQ
    f32, bf16 = torch.float32, torch.bfloat16
    results = {}
    for name, mm, k, n, dt, form, bias in (
            *((lin, m, k, n, f32, False, None) for lin, k, n in ENC_LINEARS),
            ("fc1_8192", 8192, 1024, 4096, f32, False, None),
            *((f"{lin}_ql_bf16", m, k, n, bf16, True, bf16)
              for lin, k, n in ENC_LINEARS),
            ("linear1_bf16", m, ENC_D, ENC_FFN, bf16, False, None),
            ("linear1_quantized_linear", m, ENC_D, ENC_FFN, f32, True, f32),
            ("ragged_m4093_n97_k1000", m - 3, 1000, 97, f32, False, None),
            ("ragged_m4093_n97_k1000_bf16", m - 3, 1000, 97, bf16, False,
             None),
            ("ragged_m4093_n1000_k1040", m - 3, 1040, 1000, f32, False,
             None),
            ("tiny_5x37x3", 5, 37, 3, bf16, False, None)):
        results[name] = _int8_case(name, mm, k, n, dt, True, form, bias)
    return results


def _int8_forward_sum(cases, layers) -> dict:
    """One forward's ``layers`` x four int8 products of the bf16 encoder
    (the ``QuantizedLinear`` form, bias and output in bfloat16): times and
    bounds summed over those cases (each launch is bounded on its own, so
    the forward's bound is the sum of theirs), and what sets the larger
    share of that sum."""
    form = [f"{lin}_ql_bf16" for lin, _, _ in ENC_LINEARS]
    out = {key: layers * sum(cases[c][key] for c in form)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "int_mm_ms")}
    by = {k: sum(cases[c]["bound_ms"] for c in form
                 if cases[c]["bound_by"] == k)
          for k in ("bytes", "operations")}
    out["bound_by"] = max(by, key=by.get)
    return out


# ---------------------------------------------------------------------------
# 21. dynamic-PTQ int8 inference of the fused encoder
# ---------------------------------------------------------------------------
def _forward_counters():
    from paddle_ray_tpu_torch.ops.fused import int8_matmul
    return {**_dal_counters(), **_flash_counters(), "int8_matmul": int8_matmul}


def _timed_forward(fn, counters, per_call, what) -> dict:
    """One warm-up and ``PTQ_TIMED`` timed calls of ``fn`` under
    ``torch.no_grad()``, the counters set to 0 first and each held at
    ``per_call`` a call; ms a call by the host clock ended by
    ``torch.cuda.synchronize()``, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PTQ_TIMED):
            out = fn()
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    calls = PTQ_TIMED + 1
    launches = {n: c.launches for n, c in counters.items()}
    for n, count in launches.items():
        if count != per_call.get(n, 0) * calls:
            raise AssertionError(f"{what}: {n} launched {count} times in "
                                 f"{calls} calls, want {per_call.get(n, 0)} "
                                 f"a call")
    return {"out": out, "ms": 1e3 * dt / PTQ_TIMED, "launches": launches,
            "calls": calls,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}


def phase_ptq_encoder() -> dict:
    """``encoder_train``'s 24-layer stack (same seed, bf16) in eval mode:
    the bf16 forward, then ``PTQ(QuantConfig())`` and the same forward
    in int8, each timed and profiled once."""
    from paddle_ray_tpu_torch.quantization import PTQ, QuantConfig
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = _encoder_stack(ENC_LAYERS, "bfloat16", g).eval()
    b, s = ENC_BATCH, ENC_SEQ
    src = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    valid = _padding_mask(ENC_LENGTHS, s)
    src_mask = valid[:, None, None, :]
    counters = _forward_counters()
    per = {"fused_dropout_add_layernorm": 2 * ENC_LAYERS,
           "flash_attention_fwd": ENC_LAYERS}
    runs = {"bf16": _timed_forward(lambda: model(src, src_mask), counters,
                                   per, "ptq_encoder bf16")}
    groups = {"int8_matmul": ("int8_matmul",), "flash": ("flash_",),
              "dropout_add_layernorm": ("dal_fwd",),
              "matmul": ("gemm", "nvjet"),
              "elementwise_and_reductions": ("elementwise", "reduce")}
    with torch.no_grad():
        _profile_step(lambda: model(src, src_mask), "ptq_encoder_profile",
                      runs["bf16"]["ms"], groups)
    ptq = PTQ(QuantConfig())
    model = ptq.convert(ptq.quantize(model))
    per["int8_matmul"] = 4 * ENC_LAYERS
    runs["int8"] = _timed_forward(lambda: model(src, src_mask), counters,
                                  per, "ptq_encoder int8")
    with torch.no_grad():
        _profile_step(lambda: model(src, src_mask), "ptq_encoder_profile",
                      runs["int8"]["ms"], groups)
    ref = runs["bf16"].pop("out")[valid].float()
    got = runs["int8"].pop("out")[valid].float()
    if not torch.isfinite(got).all():
        raise AssertionError("ptq_encoder: int8 output not finite")
    rel = _rel_err(got, ref)
    cos = float(torch.nn.functional.cosine_similarity(
        got.flatten(), ref.flatten(), dim=0))
    for r in runs.values():
        r["tokens_per_s"] = b * s / (r["ms"] / 1e3)
    emit("ptq_encoder", layers=ENC_LAYERS, d_model=ENC_D, heads=ENC_HEADS,
         ffn=ENC_FFN, batch=b, seq=s, lengths=list(ENC_LENGTHS),
         timed_calls=PTQ_TIMED, int8_vs_bf16_rel_err=rel,
         int8_vs_bf16_cosine=cos, **runs)
    out = {"launches": runs["int8"]["launches"]["int8_matmul"],
           "ms": {k: r["ms"] for k, r in runs.items()}}
    del model, src
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 22. correctness of the PTQ path on the card
# ---------------------------------------------------------------------------
def phase_ptq_check() -> None:
    """A 4-layer float32 stack of the encoder's width, TF32 off, batch 2
    of 512 padded to lengths 512 and 333, quantized on the card and as a
    copy on the CPU (the plain versions).  Exact: the int8 weights and
    scales equal, the first projection (whose input is the same on both
    sides) equal bit for bit inside the forward, and ``QuantizedLinear``
    equal on one shared input.  The stack's outputs agree only within the
    int8 error: flash and the plain attention, and the LayerNorms, sum in
    other orders, so a few activations take the neighbouring int8 step on
    one side; when one of them is a tensor's largest, that tensor's
    per-tensor scale moves and every activation is rounded on a shifted
    grid, and later layers take many steps apart.  The phase measures that
    floor on the CPU alone (the same stack under a 1e-7 relative
    perturbation of its input) and holds the card to ``max|err| /
    max|ref|`` ``PTQ_CHECK_TOL``."""
    from paddle_ray_tpu_torch.ops.fused import int8_matmul
    from paddle_ray_tpu_torch.quantization import quantize_model
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 6)
    models = {"cuda": _encoder_stack(4, "float32", g).eval()}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    models = {dev: quantize_model(m) for dev, m in models.items()}
    b, s, lengths = 2, ENC_SEQ, (512, 333)
    r = np.random.RandomState(SEED + 6)
    x = torch.from_numpy(r.randn(b, s, ENC_D).astype(np.float32))
    x_moved = x * (1 + 1e-7 * torch.from_numpy(
        r.randn(b, s, ENC_D).astype(np.float32)))
    valid = _padding_mask(lengths, s, device="cpu")
    mask = valid[:, None, None, :]
    first = {}

    def keep(dev):
        def hook(mod, inp, out):
            first[dev] = out.cpu()       # returns None: the output stays
        return hook
    hooks = [m.layers[0].fused_attn.qkv.register_forward_hook(keep(dev))
             for dev, m in models.items()]
    int8_matmul.launches = 0
    with torch.no_grad():
        ys = {dev: m(x.to(dev), mask.to(dev)).cpu()
              for dev, m in models.items()}
        for h in hooks:
            h.remove()
        y_moved = models["cpu"](x_moved, mask)
        lin = {dev: m.layers[0].ffn.linear1 for dev, m in models.items()}
        h = torch.from_numpy(r.randn(b * s, ENC_D).astype(np.float32))
        lin_out = {dev: lin[dev](h.to(dev)).cpu() for dev in lin}
    launches = int8_matmul.launches
    if launches != 4 * 4 + 1:
        raise AssertionError(f"ptq_check: int8_matmul launched {launches} "
                             f"times, want 17")
    same_weights = all(torch.equal(a.cpu(), c) for a, c in zip(
        models["cuda"].state_dict().values(),
        models["cpu"].state_dict().values()))
    first_equal = bool(torch.equal(first["cuda"], first["cpu"]))
    linear_equal = bool(torch.equal(lin_out["cuda"], lin_out["cpu"]))
    err = _rel_err(ys["cuda"][valid], ys["cpu"][valid])
    floor = _rel_err(y_moved[valid], ys["cpu"][valid])
    if not (same_weights and first_equal and linear_equal
            and err <= PTQ_CHECK_TOL and torch.isfinite(ys["cuda"]).all()):
        raise AssertionError(
            f"ptq_check: int8 weights equal {same_weights}, first qkv "
            f"bit-equal {first_equal}, QuantizedLinear bit-equal "
            f"{linear_equal}, stack off by {err} (max|err| / max|ref|, "
            f"tolerance {PTQ_CHECK_TOL}; the CPU's own floor {floor})")
    emit("ptq_check", dtype="float32", layers=4, batch=b, seq=s,
         lengths=list(lengths), tf32=False, rel_err=err,
         cpu_perturbed_rel_err=floor, tol=PTQ_CHECK_TOL,
         int8_weights_equal=same_weights, first_qkv_bit_equal=first_equal,
         quantized_linear_bit_equal=linear_equal, launches=launches)
    del models
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 23. QAT of the fused encoder, then its int8 conversion
# ---------------------------------------------------------------------------
def phase_qat() -> dict:
    """``QAT().quantize`` on a 4-layer bf16 stack of the encoder's width:
    ``QAT_STEPS`` ``AdamW(1e-4)`` steps (MSE, ``encoder_train``'s
    per-step keys), losses finite and falling; then ``QAT().convert`` and
    one eval forward, 16 int8 launches."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.ops.fused import int8_matmul
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    from paddle_ray_tpu_torch.quantization import (QAT, QATLinear,
                                                   QuantizedLinear)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 7)
    qat = QAT()
    model = qat.quantize(_encoder_stack(QAT_LAYERS, "bfloat16", g))
    n_qat = sum(isinstance(m, QATLinear) for m in model.modules())
    b, s = ENC_BATCH, ENC_SEQ
    src = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    target = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    src_mask = _padding_mask(ENC_LENGTHS, s)[:, None, None, :]

    def loss_fn(m, batch, rng):
        x, mask, y = batch
        return ((m(x, mask, rng).float() - y.float()) ** 2).mean()
    ts = build_train_step(model, AdamW(ENC_LR), loss_fn)
    root = prng.PRNGKey(0)
    losses = [float(ts.step((src, src_mask, target), prng.fold_in(root, i)))
              for i in range(QAT_STEPS)]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"qat losses not finite and falling: {losses}")
    model = qat.convert(ts.model).eval()
    n_int8 = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    int8_matmul.launches = 0
    with torch.no_grad():
        y = model(src, src_mask)
    launches = int8_matmul.launches
    if not (launches == 4 * QAT_LAYERS and n_qat == n_int8 == launches
            and torch.isfinite(y).all()):
        raise AssertionError(f"qat: {n_qat} QATLinear, {n_int8} "
                             f"QuantizedLinear, {launches} int8 launches a "
                             f"forward (want {4 * QAT_LAYERS})")
    emit("qat", layers=QAT_LAYERS, d_model=ENC_D, dtype="bfloat16",
         batch=b, seq=s, optimizer=f"AdamW({ENC_LR})", steps=QAT_STEPS,
         losses=losses, qat_linears=n_qat, int8_launches=launches)
    del ts, model
    torch.cuda.empty_cache()
    return {"launches": launches}


def _entry(name, source, replaces, body, launches, case, shape,
           max_abs_err=None) -> dict:
    """One row of the ``kernels`` line: the main path's launches, the
    numbers of one measured case (or of a sum of cases, as built by the
    caller)."""
    return {
        "name": name, "route": "cuda",
        "source": f"paddle_ray_tpu_torch/ops/csrc/{source}",
        "replaces": f"paddle_ray_tpu/ops/{replaces}", "tpu_kernel": body,
        "launches": launches,
        "max_abs_err": (case["max_abs_err"] if max_abs_err is None
                        else max_abs_err),
        "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "library_ms": case["library_ms"], "shape": shape}


def _decode_note(att, kind) -> str:
    """The decode kernel's other head dims and its single-stream long
    case, for the ``kernels`` line."""
    d96, d80, long_ = (att[f"{kind}_d96_pos255"], att[f"{kind}_d80_pos255"],
                       att[f"long_{kind}_b1_pos{DEC_LONG_T - 1}"])
    return (f"d 96 (h 16) {d96['ms']:.5f} ms against SDPA's "
            f"{d96['library_ms']:.5f}, d 80 (h 32) {d80['ms']:.5f} against "
            f"{d80['library_ms']:.5f}; B 1, h 16 at pos {DEC_LONG_T - 1}: "
            f"{long_['ms']:.5f} ms in {long_['n_splits']} splits of "
            f"{long_['rows_per_split']} rows merged in the launch, against "
            f"SDPA's {long_['library_ms']:.5f}")


def _decode_step_matmuls(matmul, n_layers) -> dict:
    """The int8 matmul launches of one decode step of gpt3-350m (four
    linears a layer and the tied head), their times and bounds summed."""
    count = {"qkv": n_layers, "out": n_layers, "fc1": n_layers,
             "fc2": n_layers, "head": 1}
    step = {k: sum(n * matmul[c][k] for c, n in count.items())
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = sum(n * matmul[c]["bytes"] for c, n in count.items()) \
        / HBM_BYTES_PER_S
    t_ops = sum(n * matmul[c]["ops"] for c, n in count.items()) \
        / PEAK_OPS_PER_S[torch.bfloat16]
    step["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    step["max_abs_err"] = max(r["max_abs_err"] for r in matmul.values())
    return step


def main() -> None:
    smi = phase_device()
    from paddle_ray_tpu_torch.models import build_gpt
    phase_build()
    kernel = phase_kernel()
    flash = phase_flash_kernel()
    decode = phase_decode_kernel()
    phase_int8_one_call("early")
    gn = phase_gn_kernel()
    dal = phase_dal_kernel()
    drop = phase_dropout_kernel()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    serve = phase_serve(model)
    phase_check(model)
    serve_int8 = phase_serve_int8(model)
    gen = phase_generate(model)
    gen_b1 = phase_generate_b1(model)
    n_layers = model.cfg.num_layers
    del model
    torch.cuda.empty_cache()
    phase_generate_check()
    g.manual_seed(SEED)
    m760 = build_gpt(M760, device="cuda", dtype=torch.bfloat16, generator=g)
    serve_760m = phase_serve(m760, "serve_760m", M760)
    del m760
    torch.cuda.empty_cache()
    phase_check_760m()
    g.manual_seed(SEED)
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    served = {"serve_spec": phase_serve_spec(model),
              "serve_async": phase_serve_async(model),
              "serve_prefix": phase_serve_prefix(model),
              "serve_lifecycle": phase_serve_lifecycle(model),
              "serve_chaos": phase_serve_chaos(model)}
    del model
    torch.cuda.empty_cache()
    train = phase_train()
    phase_train_check()
    train_760m = phase_train_760m()
    recipe = phase_train_recipe()
    seq8k = phase_train_seq8k()
    phase_train_recipe_check()
    me = phase_me_adamw_kernel()
    m1p3b = phase_train_1p3b()
    offload = phase_train_1p3b_offload(m1p3b["losses"])
    phase_amp_train()
    phase_optimizers_check()
    phase_scaler_check()
    resilient = phase_train_resilient(smi)
    resilient_check = phase_train_resilient_check(smi)
    unet = phase_unet_train()
    phase_unet_check()
    bert = phase_bert_train()
    phase_bert_check()
    enc = phase_encoder_train()
    int8 = phase_int8_mm_kernel()
    ptq = phase_ptq_encoder()
    phase_ptq_check()
    qat = phase_qat()
    phase_int8_one_call("late")
    train_case = flash["train_bf16"]
    runs = {"gpt": train, "gpt760m": train_760m, "bert": bert,
            "encoder": enc, "recipe": recipe, "seq8k": seq8k,
            "resilient": resilient, "resilient_check": resilient_check}
    flash_entries = [_entry(
        name, "flash_attention.cu", f"flash_attention.py:{line}", body,
        sum(r["launches"][name] for r in runs.values()), train_case[kind],
        "bf16 causal, B 8, S 1024, H 16, D 64 (launches: gpt3-350m, "
        "gpt3-760m, BERT-large, the fused encoder, the pretraining recipe "
        "and seq-8192 training runs, and the resilient loop's lives at "
        "gpt3-350m and at gpt3-1.3b's width, "
        + ", ".join(f"{r['launches'][name]}" for r in runs.values())
        + "); non-causal B 8, S 512 with segment ids {:.4f} ms, a [B,1,1,S] "
        "mask-bias {:.4f} ms, a full bias{} {:.4f} ms".format(
            *(flash[m][kind]["ms"] for m in FLASH_MODES[:2]),
            " with dbias" if kind == "dq" else "",
            flash[FLASH_MODES[2]][kind]["ms"])
        + ("" if kind == "fwd" else "; library_ms is SDPA's backward, for "
           "dq and dk/dv together")
        + "; bf16 on the tensor cores (wgmma, TMA), float32 on the CUDA "
          "cores")
        for name, kind, line, body in zip(
            FLASH_KERNELS, ("fwd", "dq", "dkv"), (76, 135, 186),
            ("_fwd_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel"))]
    q8_case = kernel["decode_2048_q8_bf16"]
    paged_err = {q8: max(r["max_abs_err"] for r in kernel.values()
                         if r["tol"] == TOL[torch.bfloat16]
                         and r["q8"] == q8) for q8 in (False, True)}
    att = decode["attention"]
    gen_launches = {k: gen[c]["launches_per_call"][k] for c, k in (
        ("bf16", "fused_decode_attention"),
        ("int8", "fused_decode_attention_q8"),
        ("int8", "int8_stream_matmul"))}
    bf16_case = kernel["decode_2048_bf16"]
    new_paged = {kv: sum(r[kv] for r in served.values())
                 for kv in ("model", "int8")}
    new_note = ", ".join(f"{k} {r['model']}" for k, r in served.items()
                         if r["model"])
    verify = {c: kernel[c] for c in kernel if c.startswith("verify_")}
    verify_note = "; verify steps (decode lanes of 5, 5, 3, 1 rows) " + \
        ", ".join(f"{c} {r['ms']:.4f} ms against SDPA's "
                  f"{r['library_ms']:.4f} (bound {r['bound_ms']:.5f})"
                  for c, r in verify.items())
    entries = [
        _entry("paged_ragged_attention", "paged_attention.cu",
               "paged_attention.py:108", "_kernel",
               serve["launches"] + serve_760m["launches"]
               + new_paged["model"], bf16_case,
               f"bf16 pool, bf16 q: decode, 8 slots x 2048 tokens, h=16, "
               f"d=64, page 64; split-K: {bf16_case['splits']} splits of "
               f"{bf16_case['pages_per_split']} pages; decode rows without "
               f"GQA or with GQA 2 on the CUDA cores, tiles of more pairs on "
               f"mma.sync (a 128-row chunk without GQA "
               f"{kernel['mixed_bf16']['ms']:.4f} ms against SDPA's "
               f"{kernel['mixed_bf16']['library_ms']:.4f}){verify_note}; "
               f"launches: serve (gpt3-350m, d 64) {serve['launches']}, "
               f"serve_760m (gpt3-760m, d 96) {serve_760m['launches']}, "
               f"{new_note}",
               paged_err[False]),
        *flash_entries,
        _entry("paged_ragged_attention_q8", "paged_attention.cu",
               "paged_attention.py:134", "_kernel_q8",
               serve_int8["launches"] + new_paged["int8"], q8_case,
               f"int8 pool, bf16 q: decode, 8 slots x 2048 tokens, h=16, "
               f"d=64, page 64; split-K: {q8_case['splits']} splits of "
               f"{q8_case['pages_per_split']} pages merged in the launch; "
               f"decode rows without GQA or with GQA 2 on the CUDA cores, "
               f"tiles of more pairs on mma.sync (a 128-row chunk without "
               f"GQA {kernel['mixed_q8_bf16']['ms']:.4f} ms against SDPA's "
               f"{kernel['mixed_q8_bf16']['library_ms']:.4f}); launches: "
               f"serve_int8 {serve_int8['launches']}, serve_async "
               f"{new_paged['int8']}; library_ms is SDPA over the "
               f"dequantised cache", paged_err[True]),
        _entry("fused_decode_attention", "decode_attention.cu",
               "decode_attention.py:71", "_kernel_bf16",
               gen_launches["fused_decode_attention"], att["bf16_pos255"],
               "bf16, B 8, h 16, d 64, pos 255 of a 512-row cache (the "
               "middle of generate()'s decode positions 128..382); one "
               "launch a call, q pre-scaled in the kernel, rows by cp.async "
               "in 32-row groups, the V sum over 16-byte column slices; "
               + _decode_note(att, "bf16")
               + "; generate() at batch 1: " + "; ".join(
                   f"prompt {p}: {r['split_launches']} of "
                   f"{r['decode_attention_launches']} launches split "
                   f"(up to {r['n_splits_min_max'][1]} ways), the kernel "
                   f"{r['profile_split']['decode_attention_ms']:.3f} ms of "
                   f"a {GEN_B1_PROFILED}-token call against "
                   f"{r['profile_one_split']['decode_attention_ms']:.3f} "
                   f"held to one split" for p, r in gen_b1.items()),
               max(r["max_abs_err"] for k, r in att.items()
                   if "bf16" in k)),
        _entry("fused_decode_attention_q8", "decode_attention.cu",
               "decode_attention.py:88", "_kernel_q8",
               gen_launches["fused_decode_attention_q8"], att["q8_pos255"],
               "int8 cache, bf16 q, B 8, h 16, d 64, pos 255 of a 512-row "
               "cache; the same kernel as the bf16 cache's; "
               + _decode_note(att, "q8")
               + "; library_ms is SDPA over the dequantised cache",
               max(r["max_abs_err"] for k, r in att.items()
                   if "q8" in k)),
        _entry("int8_stream_matmul", "decode_matmul.cu",
               "decode_matmul.py:27", "_kernel",
               gen_launches["int8_stream_matmul"],
               _decode_step_matmuls(decode["matmul"], n_layers),
               "one decode step of gpt3-350m at batch 8, bf16 x: 24 x "
               "(1024->3072, 1024->1024, 1024->4096, 4096->1024, with bias) "
               "+ the 1024->50304 head, 97 launches summed (the head "
               f"{decode['matmul']['head']['ms']:.4f} ms against a "
               f"{decode['matmul']['head']['bound_ms']:.4f} bound); one "
               "launch a call: bf16 x on mma.sync m16n8k16 over the "
               "transposed product, the int8 weight widened in registers, "
               "streamed by 16-byte cp.async through a 4-stage ring, split-K "
               "merged in the launch in split order; float32 x on the CUDA "
               "cores"),
    ]
    gn_case = gn["cases"][(UNET_IMG * UNET_IMG, 320, "mod")]
    gn_shape = (f"bf16 [{UNET_BATCH}, {UNET_IMG}, {UNET_IMG}, 320], 32 "
                f"groups, scale+shift+silu (the step's {gn['calls']} calls "
                f"sum to {{:.4f}} ms against a {{:.4f}} ms bound); a "
                f"cluster of blocks holds a (sample, group-set) slice in "
                f"shared memory, read by 16-byte cp.async once, statistics "
                f"exchanged over distributed shared memory in rank order; "
                f"library_ms is torch.nn.functional.group_norm alone on the "
                f"channels-last NCHW view")
    entries += [
        _entry(name, "groupnorm.cu", f"groupnorm.py:{line}", body,
               unet["launches"][name], gn_case[kind],
               gn_shape.format(gn["step"][kind]["ms"],
                               gn["step"][kind]["bound_ms"])
               + ("" if kind == "fwd" else ", its autograd backward"))
        for name, kind, line, body in zip(
            GN_KERNELS, ("fwd", "bwd"), (48, 109),
            ("_fwd_kernel", "_bwd_kernel"))]
    dal_case = dal["encoder_bf16_p0.1"]
    entries += [
        _entry(name, "fused.cu", f"fused.py:{line}", body,
               enc["launches"][name], dal_case[kind],
               f"bf16 [{ENC_BATCH} x {ENC_SEQ}, {ENC_D}], p {ENC_RATE}, "
               f"training, h unused (the fused encoder's post-LN call); a "
               f"row in the registers of {warps} warps, 16-byte loads and "
               f"stores, shuffle sums, at most 256 blocks, {ahead} by "
               f"cp.async; library_ms is torch.nn.functional.layer_norm "
               f"on h alone"
               + ("" if kind == "fwd" else ", its autograd backward"))
        for name, kind, line, body, warps, ahead in zip(
            DAL_KERNELS, ("fwd", "bwd"), (95, 116),
            ("_dal_fwd_kernel", "_dal_bwd_kernel"), (2, 4),
            ("two rows ahead", "the next row"))]
    fwd = _int8_forward_sum(int8, ENC_LAYERS)
    entries.append(_entry(
        "int8_matmul", "int8_matmul.cu", "fused.py:320", "_int8_mm_kernel",
        ptq["launches"] + qat["launches"], int8["linear1"],
        f"float32 out, [{ENC_BATCH} x {ENC_SEQ}, {ENC_D}] x [{ENC_D}, "
        f"{ENC_FFN}] (the fused encoder's linear1); the 24-layer PTQ "
        f"forward's 96 launches sum to {fwd['ms']:.4f} ms against a "
        f"{fwd['bound_ms']:.4f} ms bound ({fwd['bound_by']}; the bf16 "
        f"QuantizedLinear form, bias and bf16 output in the launch; "
        f"torch._int_mm alone {fwd['int_mm_ms']:.4f}, with the scales, bias "
        f"and cast {fwd['library_ms']:.4f}); launches: ptq_encoder's "
        f"{ptq['launches']} and qat's {qat['launches']}; wgmma m64n256k32 "
        f"s8 on 128 x 256 tiles fed by TMA through a 4-stage mbarrier ring, "
        f"two consumer warpgroups, the epilogue staged through shared "
        f"memory; library_ms is torch._int_mm then the two scale products"))
    drop_case = drop[DROPOUT_CASES[0][0]]
    entries.append({
        "name": DROPOUT_KERNELS[0], "route": "cuda",
        "source": "paddle_ray_tpu_torch/ops/csrc/dropout.cu",
        "replaces": "paddle_ray_tpu/nn/functional.py:123",
        "tpu_kernel": None,
        "launches": sum(r["launches"][DROPOUT_KERNELS[0]]
                        for r in (recipe, seq8k, resilient,
                                  resilient_check)),
        "max_abs_err": max(r["max_abs_err"] for r in drop.values()),
        **{k: drop_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "shape": (
            f"bf16 [8, 1024, 1024], p 0.1 (the recipe's drops); replaces no "
            f"pl.pallas_call: the JAX dropout is jnp that XLA fuses into one "
            f"pass, and the plain version is about 170 launches; bit for bit "
            f"the plain version in every case, forward and backward (the "
            f"same kernel on dy); bound by {DROPOUT_INT_OPS} int32 operations "
            f"an element at {INT32_OPS_PER_S / 1e12:.1f} T/s; launches: "
            f"train_recipe {recipe['launches'][DROPOUT_KERNELS[0]]}, "
            f"train_seq8k {seq8k['launches'][DROPOUT_KERNELS[0]]}, "
            f"train_resilient "
            f"{resilient['launches'][DROPOUT_KERNELS[0]]}, "
            f"train_resilient_check "
            f"{resilient_check['launches'][DROPOUT_KERNELS[0]]}; "
            f"library_ms is torch.nn.functional.dropout, the same work with "
            f"other random bits (Philox)")})
    me_step, prof = me["step"], m1p3b["profile"]
    entries.append({
        "name": ME_KERNELS[0], "route": "cuda",
        "source": "paddle_ray_tpu_torch/ops/csrc/me_adamw.cu",
        "replaces": "paddle_ray_tpu/optimizer/memory_efficient.py:101",
        "tpu_kernel": None,
        "launches": (m1p3b["launches"][ME_KERNELS[0]]
                     + offload["launches"][ME_KERNELS[0]]
                     + resilient_check["launches"][ME_KERNELS[0]]),
        **{k: me_step[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        "shape": (
            f"one gpt3-1.3b step's {me_step['launches']} updates (bf16 "
            f"parameters, int8 moments, stochastic rounding), each leaf "
            f"shape timed once and summed; the profiled train_1p3b step's "
            f"{prof['group_calls']['me_adamw']} launches took "
            f"{prof['group_ms']['me_adamw']:.4f} ms; the embedding "
            f"[50304, 2048] {me['cases']['leaf_50304x2048']['ms']:.4f} ms "
            f"against a {me['cases']['leaf_50304x2048']['bound_ms']:.4f} "
            f"bound; replaces no pl.pallas_call: the JAX optimizer is jnp "
            f"that XLA fuses a pass a leaf, the plain version about 30 "
            f"launches a leaf and 170 more for the rounding bits; bit for "
            f"bit the plain version in every case; library_ms: no PyTorch "
            f"call computes blockwise-int8 AdamW with stochastic rounding; "
            f"torch._fused_adamw_ over float32 parameters and moments of "
            f"the same sizes, a reference point only, "
            f"{me_step['fused_adamw_ms']:.4f} ms; launches: train_1p3b "
            f"{m1p3b['launches'][ME_KERNELS[0]]}, train_1p3b_offload "
            f"{offload['launches'][ME_KERNELS[0]]}, train_resilient_check "
            f"{resilient_check['launches'][ME_KERNELS[0]]}")})
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
