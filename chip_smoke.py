#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which raises on failure (exit code != 0, no result line):

  1. device   the card's name, count and power limit; TF32 off for matmuls
              and cuDNN, so fp32 means fp32.
  2. build    every CUDA kernel from ``src/repro_torch/csrc``, one nvcc per
              source, all started together (registers, spills and seconds
              per source); then, from ``cuobjdump``, every kernel
              instantiation's HMMA count, registers and static shared
              memory beside the dynamic shared memory a launch asks for
              (the SSD scan's at the Mamba2 prefill shape): HMMA > 0 in
              every bfloat16 instantiation of flash attention, weighted
              attention and the SSD scan (tensor cores), 0 in every
              float32 one ("not measured" without ``cuobjdump``).
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (the instruction encoder's passes of
              4096 instructions among them, and, timed beside them, a
              monolithic batch's 32768 in one launch, and multicore
              training's M = 1476 with peer channels at batch 32) and
              the reference kernel tests' sweeps,
              in float32 and bfloat16.  Attention: max abs err <= 2e-5 /
              2e-2, exact zeros for a row with no valid key (weighted: all
              weights 0, or zero-weight keys leading every live score by
              ~200, so the row max taken over them underflows every p);
              both also at lengths that are not multiples of 16 or 64,
              every head dim, a whole 64-key tile masked or weighing 0,
              and strided q/k/v views of one fused QKV tensor (100 and 369
              rows); flash at a causal window ending inside a key tile;
              head dim 112 (zero-padded onto the D=128 instantiation) in
              flash, causal or not, and in weighted attention.  SSD scan
              (``SSD_CASES``, many chunks with a ragged last one, S shorter
              than the chunk, P 128 with N 256, the Mamba2 prefill shape, a
              4-chunk state carry, a large-decay case, an all-padding chunk,
              B/C views that break 16-byte alignment): max abs err / max
              |plain| <= 1e-5 / 1e-2 for y, 1e-5 / 1e-4 for the state.
  4. timing   each kernel at its path shapes (the multicore block
              encoder's M=369 and M=1476 among them; CUDA events after warm-up,
              the least of three means of at least 20 back-to-back calls,
              enough to fill ~2 ms for short ones):
              kernel (and, for attention, its device time under
              ``torch.profiler``: the instruction encoder's shape is
              launch-bound, so the event time there is the wrapper's),
              plain version, and, where one PyTorch call computes
              the same function, that call (``scaled_dot_product_attention``
              for attention, timed as a yardstick only — the port never
              calls it; none exists for the SSD scan), beside the least
              time the card could take (bytes at 3.35 TB/s, operations at
              67 TFLOP/s float32 or 989 TFLOP/s bfloat16, the larger); the
              SSD scan's device time per launch of its four kernels, from a
              capture (after a warm-up step it drops) that holds each of
              them once per call (a capture that lost launches is taken
              again, at most twice, then fails the run).  Then
              each timing gate of this slice, with its verdict: the SSD
              scan's (bf16 <= 2.0 ms, f32 <= 4.5 ms) and weighted
              attention's at U=128 in bf16 (<= 0.10 ms) fail the run; the
              others (weighted bf16 U=64 <= 0.045 ms, weighted f32 below
              the first kernel's times, flash's block-shape device times
              within 5% of the previous body's) are reported.
 4b. embedding the token table's gradient kernel
              (``csrc/embedding_grad.cu``, no TPU kernel: added for
              PyTorch's serial ``indexing_backward_kernel``) against its
              plain version at the train cells' shapes into the paper's
              512 x 128 f32 table (an instruction-encoder pass of 4096 x
              16 ids, the contexts of 256 x 360 and 32 x 1476), int32 and
              int64 ids, and at a 1500-id table over 72 columns (three
              vocabulary tiles, ragged columns, negative ids): each entry
              within 1e-6 of the sum of its |values|; two calls the same
              bits.  Timed at the three shapes like phase 4: kernel ms,
              its two kernels' device ms, the bound (bytes), the plain
              version (``index_add_``), as ``library_ms`` the backward of
              ``F.embedding`` (``embedding_dense_backward``: sorted ids,
              partial segments; its error and whether two calls give the
              same bits), and as ``index_put_ms`` PyTorch's
              ``index_put_(accumulate=True)``, the gradient of
              ``table[ids]`` that the port no longer calls.  The kernel's
              launches are counted in the phases that train (train
              capsim, train multicore, lstm, remat, examples), each against
              its expected count where the phase fixes one.
  5. engine   ``SimulationEngine.run`` at the paper model's full width
              (E=128, 4 heads, 4+4 layers, M=360) with seeded random
              parameters, on the first 3 Table II benchmarks: unfused and
              fused fp32, unfused and fused bf16, the paper model's own
              dtype (kernel launch counters reset just before each run and
              read just after), and one benchmark on the CPU through the
              plain versions.  Checks: both kernels launched, predictions
              finite, fused vs unfused <= 1e-3 relative, card vs CPU <= 1e-4
              relative, equal oracle cycles, each bf16 run within 1% of its
              fp32 twin, and the fused bf16 run's launch counts equal to
              the fused fp32 run's.
  6. multicore ``run_multicore`` at the same width on the multicore suite
              (mt.stream, mt.chase, mt.counter, mt.mix, each on 4 cores;
              context width M=369), one checkpoint each, batch 256:
              unfused and fused in fp32 and bf16 (counters reset before
              each run and read after).  Per run: clips, wall seconds and
              clips/s, predict seconds, batches and pad rows, the launches
              of each kernel (flash > 0 in every run, weighted > 0 exactly
              in the fused ones), per core predicted and oracle cycles;
              the U of every fused batch.  Checks: clips conserved (the
              cores' sum is the predictor's count), fused vs unfused
              <= 1e-3 in fp32, bf16 vs fp32 <= 1% (unfused and fused), card vs CPU (mt.stream)
              <= 1e-4 per core with equal oracle cycles.  Then the weighted
              kernel at each U the fused step reached (self weighted by
              multiplicities summing to 369, cross to 128) against its
              plain version, and timed like phase 4.
  7. rt-store ``rt_store_dir`` in a temporary directory under ``build/``:
              a cold multicore run persists, a restart loads the table
              (rows loaded > 0, none encoded), the tables are bit-exact and
              the restart's per-core predictions bitwise the cold run's,
              in fp32 and in bf16; a store the CPU path wrote into the
              same directory is not adopted by the card, which adopts its
              own (the key names framework and device).
  8. sampling ``EngineConfig.sampling`` (the analytical-ML fusion path) at
              the same width in fp32, batch 256, the README's settings
              (fraction 0.08, 4 strata, 2 clips a stratum at least, 200
              bootstrap resamples): the first 3 Table II benchmarks at up
              to 6 checkpoints (502.gcc has 1; 2600 clips) and the
              multicore suite (3200 clips).  Checks: fraction=1.0 bitwise
              the unsampled card run (single-core unfused and fused, and
              per core), the sampled estimate inside its CI, and on the CPU
              for one benchmark the same sample and estimate and CI within
              1e-4.  Reported per benchmark: clips predicted and
              extrapolated, the CI, the error against the unsampled total,
              and clips/s of both runs.
  9. service  ``SimulationService`` at the same width (the fp32 reference,
              batch 256) over ``build_dataset``'s clips of the first 3
              Table II benchmarks (4 checkpoints, every sliced clip kept)
              in 32 requests, after ``prewarm``.  Healthy burst: every
              ticket ok at fused_int8, clips/s and p50/p99 latency, each
              rung's spot check (64 clips) against the monolithic fp32
              reference within the service's own per-clip tolerance
              (fused_int8 5%, fused 1e-3, rt 1e-6: C2), with the int8
              total reported and held to the port's CPU int8 path
              within 1e-4.
              Chaos (nan_output 0.1, device_error 0.05, slow_flush 0.05,
              watchdog 1 s, one request at a time): every ticket typed, at
              least one demotion, re-promotion and abandoned flush thread
              (all joined after), every served total within its rung's gate
              against a monolithic fp32 replay.  Store: a corrupt read
              cold-encodes to bitwise the same totals, and a crashed
              persist leaves the previous generation loadable and
              bit-exact.  Then the weighted kernel at each U the healthy
              run's fused batches reached (self weighted by multiplicities
              summing to 360), checked and timed like phase 4.
 10. mamba2   the LM zoo's Mamba2-780m at full width (48 layers, d_model
              1536, 48 SSD heads x 64, d_state 128, vocab 50280 padded to
              50288), seeded random parameters: ``generate`` over B=4
              prompts of 4096 tokens + 16 greedy decode steps, in float32
              (TF32 off) and with the parameters in bfloat16 (every launch
              counter reset just before the two runs and read just after:
              48 SSD launches per prefill).  Checks: finite logits, no
              padded token id, card vs CPU on a 2-layer full-width model
              (prompt 511 + 2 decode steps) <= 1e-4 relative, prefill(511)
              + one decode step == prefill(512)'s last row <= 1e-4
              relative; the bf16 vs f32 logits gap, the peak memory of each
              run, and, under ``torch.profiler``, the device-busy time,
              idle share and top kernels of one prefill and one decode step
              in each dtype are reported.
 11. mamba2 bf16 gate: 12 layers at full width, the same seeded bf16
              parameters on the card and through the port's CPU bf16 path,
              a prefill of 2 x 300 tokens: the last row's logits card vs
              CPU within half of the port's bf16-vs-f32 gap (on the CPU),
              and each layer fed the CPU's input within 1e-3 (C4, on the
              generator draw it was set on).  Then the same model on the
              LM zoo's own draw (``transformer.init_params``, C6): each
              layer fed the CPU's input, the SSD kernel's output against
              the SSD scan's plain version on the same card run within
              half of the port's bf16-vs-f32 gap at that layer; card vs CPU
              per layer reported beside it.
 12. dense    the LM zoo's dense decoders at full width in bfloat16 (their
              own dtype), seeded random parameters, through ``generate``:
              qwen3-4b (36 layers, d_model 2560, 32 query / 8 KV heads x
              128, d_ff 9728 SwiGLU, qk_norm, vocab 151936) on B=4
              prompts of 4096 tokens, and olmo-1b (16 layers, d_model
              2048, 16 heads x 128 with KV heads = heads, tied embeddings,
              non-parametric LayerNorm, vocab 50304) on B=2 x 2048, each +
              16 greedy decode steps; cut from prefill_32k in batch and
              length only.  Every launch counter reset just before each
              run and read just after: one causal flash launch per layer
              (36 / 16), none of another kernel.  Reported: prefill
              tokens/s, decode ms/step, peak memory, and under
              ``torch.profiler`` the device-busy time, idle share and top
              kernels of one prefill and one decode step.  Before it: the
              head-dim-128 instantiations' registers and spills from the
              build log, and causal flash at (1, 4096, 32, 128) and (1,
              2048, 16, 128) against its plain version (2e-5 / 2e-2 max
              abs).  After it, qwen3-4b at full width cut to 2 layers, B=2
              x 300 tokens (a ragged last query and key tile): f32 card vs
              CPU logits <= 1e-4 relative (prefill + 2 decode steps),
              prefill(300) + one decode step == prefill(301)'s last row
              <= 1e-4 relative; bf16 last-row logits with the flash
              kernel within half of the port's CPU bf16-vs-f32 gap of the
              same card run with the attention's plain version (card vs
              CPU in bf16 is reported: cuBLAS's bf16 products part them);
              then causal flash
              timed at (4, 4096, 32, 128) and (2, 2048, 16, 128) in both
              dtypes like phase 4 (SDPA with ``is_causal=True`` as the
              library yardstick; the bound counts the causal pairs,
              2·B·H·D·S·(S+1) FLOPs), beside the kernel's device time
              without the mask (twice the work: the causal grid's
              imbalance is what the causal time exceeds half of it by).
 13. moe      the LM zoo's MoE and hybrid models at full width in bf16
              through ``generate``, B=4 x 4096 tokens + 16 greedy decode
              steps, cut from prefill_32k in batch and length only:
              llama4-maverick's super-block (a dense layer, then 128
              experts top-1), kimi-k2's layer (384 experts top-8, head dim
              112) and jamba's super-block (7 SSM + 1 attention layer, 4
              MoE FFNs, 4 of its 16 experts).  Each model is initialized
              on the card (its seconds printed) and freed before the next.
              Every launch counter reset just before each run and read
              just after: one causal flash launch per attention layer and
              one SSD launch per SSM layer (2/0, 1/0, 1/7), no weighted
              attention.  Reported: prefill tokens/s, decode ms/step beside
              the HBM time of the weights a step reads (the dense (E, cap,
              d) buffer runs every expert), peak memory, each MoE layer's
              tokens per expert (min, max) and dropped share, and the
              profiler's device-busy time, idle share and top kernels of
              one prefill and one decode step.  Before it: causal flash at
              (1, 4096, 40 / 64 / 64, 128 / 112 / 128) and the SSD scan at
              (1, 4096, 256, 64, 128) against their plain versions
              (phase 3's tolerances).  After it, f32 card vs CPU (B=2 x
              300 + 2 decode steps): llama4's super-block at full width
              with 8 experts, and jamba's at widths cut by 8 with its 16
              experts; every routing flip must be a near tie (the two
              experts' CPU router scores within 1e-5 relative), logits
              <= 1e-4 relative over the batch entries without one; on the
              card, llama4's prefill(300) + one decode step ==
              prefill(301)'s last row <= 1e-4 over the entries that
              neither prefill dropped a token of, or whose last token
              prefill(301) kept (the MoE layer is the super-block's last
              op, so a drop changes only its own row); bf16 card vs CPU and
              kernel vs plain of both models reported with their flips,
              not enforced (a flipped top-1 choice replaces a token's
              whole FFN output).
              Then causal flash and the SSD scan timed at the path shapes
              in bf16 like phase 4 (SDPA ``is_causal`` beside flash).
 14. frontends the LM zoo's frontend and codebook models whole (every
              layer) at full width in bf16 through ``generate`` on
              ``random_batch``'s prefill batch, B=4 x 4096 positions + 16
              greedy decode steps, cut from prefill_32k in batch and length
              only: qwen2-vl-2b (28 layers, d_model 1536, 12 query / 2 KV
              heads x 128, M-RoPE over (3, B, S) positions, 256 vision
              frontend embeddings + 3840 tokens, vocab 151936) and
              musicgen-large (48 layers, d_model 2048, 32 heads x 64, GELU,
              64 audio frontend embeddings + 4032 positions of 4 codebook
              tokens, (B, S, 4, 2048) logits, per-codebook greedy decode).
              Every launch counter reset just before each run and read
              just after: one causal flash launch per layer (28 / 48), none
              of another kernel.  Reported: init seconds, prefill
              positions/s, decode ms/step, peak memory, and the profiler's
              device-busy time, idle share and top kernels of one prefill
              and one decode step.  Before it: causal flash at (1, 4096,
              12, 128) and (1, 4096, 32, 64) against its plain version
              (2e-5 / 2e-2 max abs).  After it, each model at full width
              cut to 2 layers, B=2 x 300 positions (the frontend's first;
              qwen2-vl fed three different position streams): f32 card vs
              CPU logits <= 1e-4 relative with the same tokens (prefill + 2
              decode steps), prefill(300) + one decode step ==
              prefill(301)'s last row <= 1e-4 relative; bf16 last-row
              logits with the flash kernel within half of the port's CPU
              bf16-vs-f32 gap of the same card run with the attention's
              plain version (card vs CPU in bf16 reported).  Then causal
              flash timed at (4, 4096, 12, 128) and (4, 4096, 32, 64) in
              bf16 like phase 13.
 15. train grads  the flash and SSD kernels' gradients: each wrapper's
              ``torch.autograd.Function`` (the kernel's launch forward;
              the backward the f32 flash backward kernels, or the plain
              version's recompute for bf16 flash and the SSD scan)
              against autograd through the plain version on the card,
              at the CAPSim train
              step's attention shapes at batch 32 (instruction encoder
              4096 x 16 with its mask, block self 360 / 369, cross 360 /
              369 -> 128 with clip_mask), causal (1, 1024, 32, 128) and
              Mamba2's SSD shape (1, 4096, 48, 64, 128): f32 <= 1e-4
              relative norm per input, bf16 reported, all finite, the
              forward bitwise the no-grad launch.  Each flash shape timed
              forward (kernel, plain, SDPA, bound) and backward.
              Then the f32 flash backward kernels
              (``csrc/flash_attention_bwd.cu``, no TPU kernel: the
              reference recomputes through ``attention_ref``) at the
              train cells' shapes (4096 x 16 masked, 256 x 360^2,
              256 x 360 -> 128, 32 x 1476^2, 32 x 1476 -> 128), a causal
              window, causal (1, 1024, 32, 128), every f32 head dim and
              the one-tile kernel: the forward's log-sum-exp against the
              plain one with the output bitwise the launch without it;
              dq/dk/dv against the plain equations and against the plain
              recompute, f32 <= 1e-4 relative norm; two calls the same
              bits; keyless rows and masked keys exactly 0; timed
              (kernels, recompute, SDPA's backward, bound).
 16. train capsim the CAPSim predictor at full width in f32 on 750 clips
              (every Table II benchmark, 2 checkpoints of 10 000): card
              vs CPU from one init over 3 batches of 32 (the first
              gradient of every leaf nonzero and <= 1e-4, the parameters
              after 3 SGD-momentum steps <= 1e-4); then
              ``launch/train.py``'s ``train_capsim`` for 100 steps through
              ResilientTrainer and CheckpointManager (a save every 50),
              launch counters reset just before and read just after (12
              flash launches a forward, 12 flash backward launches a
              step), the MAPE curve, steps/s and
              clips/s; its restart resumes at step 100 with the state
              bitwise the saved one; one step of the real train step
              profiled and cut at its ``record_function`` ranges
              (forward, backward with the flash backward kernels apart,
              update); a throughput row at batch 256 (40 flash backward
              launches a step).
 17. train multicore  ``train_capsim_multicore`` on 4 cores at interval
              20 000 for 20 steps, at context width 369 and with peer
              channels (1476 rows): finite losses, steps/s, the flash
              launches exactly 12 a forward and 12 backward a step.
 18. train lm  qwen3-4b (2 layers) and mamba2-780m (4 layers) at full
              width in bf16, batch 1 x 4096: 3 AdamW steps on one batch,
              the loss finite and falling, every leaf's first gradient
              finite and nonzero, one flash / SSD launch per layer a
              forward, tokens/s, peak memory, a profiled step; then the
              f32 gradient at 1 x 256 on the card against the CPU (loss
              <= 1e-5, each leaf <= 1e-4 relative norm).
 19. mesh     the data mesh (``EngineConfig.mesh_shape``) at phases 5 and
              6's configurations (600 clips single-core, 3200 on 4 cores
              at M = 369, batch 256), fp32 and bf16, unfused and fused,
              each run with a cold RT cache, after a warm-up pass on the
              first benchmark (not counted): the unsharded engine, then
              mesh (1,) on cuda:0 and 2 and 4 shards asked for on the one
              card (each on its own stream; counters reset before each
              run and read after).  Checks: mesh (1,) bitwise per clip;
              2 and 4 shards with the RT table byte-identical, the same
              batches, flash and weighted launches exactly n x the
              unsharded run's, fp32 per clip and per benchmark or core
              <= 1e-6 relative (the service's rt gate, C2), bf16 <= 1e-2
              (its bf16-vs-fp32 gate), the multicore demux exact.
              Reported: the per-clip gap and whether it is bitwise,
              clips/s and predict seconds beside the unsharded run's.
              Then the same on distinct cards where two or more are
              visible (else one line says so), a pool of 3 clips on 4
              shards (5 pad rows dropped, <= 1e-6), and ``serve.py
              --mesh 1 --device cuda`` and ``--engine-config`` with
              ``mesh_shape: [1]`` in subprocesses.

 20. dist     the LM zoo's multi-device paths (ROADMAP item 6b) on the one
              card.  (a) A process group of one rank over NCCL in this
              process, ``make_test_mesh()`` on it: qwen3-4b whole (36
              layers, bf16, B=4 x 4096 + 16 decode steps) with
              ``attn_impl="sp"`` and llama4-maverick's super-block (the
              MoE layer on the expert-parallel path over one shard)
              through ``generate`` under ``LOGICAL_RULES_DECODE``, in
              turns with the meshless run (meshless, mesh, mesh,
              meshless: the decode rate is host-bound and drifts), every
              run bitwise the first (logits and tokens), the flash
              launches one per attention layer, the expert-parallel calls
              one per MoE layer and call.  (c) The CAPSim DP trainer at
              full width in f32 (batch 32 x 128 instructions, 20 steps,
              ``LOGICAL_RULES_PREDICTOR``) bitwise the single-process
              trainer; then 2 ranks in two processes on the one card over
              gloo where gloo all-reduces a CUDA tensor (loss per step <=
              1e-5 relative from 1 rank), else one line saying why not.
              (b) n shards of each body in one process at full width:
              sequence-parallel prefill at qwen3-4b's (4, 4096, 32 / 8,
              128), n = 2 and 4: each shard's flash kernel at Sq = S/n,
              Skv = (m+1)·S/n against its plain version (2e-5 / 2e-2)
              and the full causal output's rows (bitwise reported), n
              launches, each shard timed in bf16 beside SDPA with a
              lower-right causal mask and the bound; flash-decoding merged
              over 2, 4 and 8 shards of 4112 positions against
              ``decode_attention`` (f32 <= 1e-5, bf16 reported); llama4's
              128 experts over 2, 4 and 8 model shards: routing identical
              to the meshless path, y at a no-drop capacity within 1e-5
              relative (bf16: f32 weights would hold 64 GB), and the
              dropped share at the config's factor.  ``dist distinct
              cards: not run`` on one card.

 21. tp       GSPMD's weight layouts as per-rank blocks (ROADMAP item
              6c; ``tools/tp_phase.py`` runs it alone).  The meshless
              runs in this process, then two gloo ranks in two processes
              sharing the card, mesh (1, 2), tensor parallelism over
              'model' under ``LOGICAL_RULES_DECODE``: qwen3-4b whole,
              Mamba2-780m whole and llama4-maverick's super-block with
              its 128 experts (64 a rank) at full width in bf16 through
              ``generate`` (B=1 x 4096 + 16 decode steps), each rank's
              resident parameter bytes below the meshless run's, its
              flash and SSD launches one per attention / SSM layer, each
              at the rank's H/2 query heads or nheads/2 SSM heads (the
              wrappers count their launches by the head count they were
              given; the counters reset before and read after in the
              rank), greedy
              tokens beside the meshless run's (bf16: reported); the f32
              cuts (qwen3-4b 2 layers, Mamba2 4, llama4 with 8 experts)
              <= 1e-4 from the meshless run with tokens equal; training
              with 'model' = 2 (qwen3-4b 2 layers, Mamba2 4, 1 x 4096)
              and with FSDP rows on (2, 1): f32 loss <= 1e-5 and every
              gathered gradient <= 1e-4 relative norm from the meshless
              step (bf16 reported), rank 0's peak allocation beside the
              meshless step's.  Then n = 2, 4, 8 tensor-parallel
              shards in one process: the flash kernel at qwen3-4b's
              (4, 4096, 32/n, 128) over 8/n KV heads, the SSD scan at
              Mamba2's 48/n and jamba's 256/n heads, each against its
              plain version and timed in bf16 beside 1/n of the
              unsharded kernel, SDPA and the bound; the attention and
              SSM layers' n shards summed against the unsharded layer
              in f32 (<= 1e-4).

 22. lstm     the Ithemal-style LSTM baseline (Fig 10) at the CAPSim full
              config: the forward at batch 256 (ms, clips/s, peak) beside
              ``predictor.predict_step``'s; f32 card vs CPU <= 1e-4; 20
              SGD-momentum steps on one batch of 8, finite and falling.

 23. remat    activation rematerialization: one train step with remat
              off and on from the same state (the least of 3 after a
              warm one) for CAPSim at full width in f32 at batch 32 and
              256 and qwen3-4b cut to 2 layers in bf16 at 1 x 4096: ms,
              the step's peak, flash/SSD launches doubled by the
              recompute, the step's peak lower, every gradient within
              1e-6 (f32) / 3e-2 (bf16) relative of the other run's.

 24. dryrun   ``launch/dryrun.py`` on meta on the host: qwen3-4b
              train_4k, kimi-k2 decode_32k and capsim train_clips on
              rank 0 of pod_16x16 and ``roofline_report``'s table; each
              remat cell's estimated peak against the card's step peak
              (0.7-1.3) and its FLOPs over the card's step time.

 25. examples ``examples/*_torch.py`` on the card in this process, the
              fewest steps that show each working.

After the phases, their seconds and the main-path launches each added.
The line before the last is the card's name and power limit from
nvidia-smi; before it, one JSON object ``{"kernels": [...]}`` (the
attention entries also carry their main shape's bfloat16 numbers as
``*_bf16``).  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
BENCHMARKS = 3
MULTICORE_CORES, MULTICORE_INTERVAL = 4, 20_000
# the mesh phase's shards on one card (each on its own stream)
MESH_SHARDS = (2, 4)
# one-element kernels launched at the start of each ``device_ms`` capture
CAPTURE_PAD = 256
F32_TOL, BF16_TOL = 2e-5, 2e-2
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SSD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the embedding gradient's shapes at the paper's 512 x 128 table: (label,
# ids shape), and its tolerance, a share of the sum of each entry's
# |values| (f32 sums of the same values in another order)
EMB_PATH = (("encoder_pass_4096x16", (4096, 16)),
            ("context_b256_256x360", (256, 360)),
            ("context_mc4_32x1476", (32, 1476)))
EMB_VOCAB, EMB_WIDTH, EMB_TOL = 512, 128, 1e-6
# the final state: in bf16 the operands formed in f32 enter the products
# as hi and lo halves, so the state keeps f32 accuracy (y is rounded to
# bf16 on both sides, so its max error is a bf16 ulp at the largest |y|)
SSD_STATE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
MAMBA2_BATCH, MAMBA2_PROMPT, MAMBA2_DECODE = 4, 4096, 16
MAMBA2_GATE_LAYERS, MAMBA2_GATE_BATCH, MAMBA2_GATE_PROMPT = 12, 2, 300
# this slice's timing gates (ms, NVIDIA H100 80GB HBM3 at 700 W): the
# weighted-attention kernel's first body (float32: below its times), the
# flash body's block-shape device times (within 5%), the SSD scan's
WA_BF16_GATE = {"fused_self_u64": 0.045, "fused_self_u128": 0.10,
                "fused_cross_u128": 0.10}
WA_F32_FIRST = {"fused_self_u64": 0.0868, "fused_self_u128": 0.2223,
                "fused_cross_u128": 0.2201}
FLASH_DEVICE_BEFORE = {("block_self", "bfloat16"): 0.1335,
                       ("block_cross", "bfloat16"): 0.0671,
                       ("block_self", "float32"): 0.6397,
                       ("block_cross", "float32"): 0.2448}
SSD_GATE = {"bfloat16": 2.0, "float32": 4.5}
# the SSD scan's kernels: one call launches each once
SSD_KERNELS = 4
# the sampled simulation: the README's CLI settings; Table II gives the
# first two single-core benchmarks >= 6 checkpoints and 502.gcc one
SAMPLING = dict(fraction=0.08, strata=4, min_clips_per_stratum=2,
                bootstrap_resamples=200)
SAMPLING_CHECKPOINTS = 6
# the service: requests; each rung's gate against the monolithic fp32
# reference, per clip (the service's spot-check measure and its own
# tolerances: fused_int8 5%, fused 1e-3, rt 1e-6, with monolithic held to
# rt's); the int8 rung is also held to the port's CPU int8 path; the
# chaos run's faults
SERVICE_REQUESTS, SERVICE_CHECKPOINTS = 32, 4
SERVICE_GATES = {"fused_int8": 0.05, "fused": 1e-3, "rt": 1e-6,
                 "monolithic": 1e-6}
CHAOS_FAULTS = {"nan_output": 0.1, "device_error": 0.05, "slow_flush": 0.05}
CHAOS_SEED = 1
# the LM zoo's dense decoders at full width in bf16, their own dtype:
# (arch, batch, prompt), cut from prefill_32k in batch and length only;
# then greedy decode steps.  The card-vs-CPU checks: qwen3-4b at full
# width cut to 2 layers, a prompt with a ragged last query and key tile
DENSE_RUNS = (("qwen3-4b", 4, 4096), ("olmo-1b", 2, 2048))
DENSE_DECODE = 16
DENSE_GATE_LAYERS, DENSE_GATE_BATCH, DENSE_GATE_PROMPT = 2, 2, 300
# causal flash attention at the dense prefills' shapes (label, B, S, H,
# D): checked against the plain version at batch 1, timed at B
FA_DENSE = (("qwen3_prefill", 4, 4096, 32, 128),
            ("olmo_prefill", 2, 2048, 16, 128))
# the LM zoo's MoE and hybrid models at full width in bf16, cut from
# prefill_32k in batch and length only: (arch, layers, experts (None:
# the config's), flash label, SSD label); llama4-maverick's super-block
# (a dense layer, then an MoE layer of 128 experts, top-1), kimi-k2's
# layer (384 experts, top-8) and jamba's super-block (7 SSM + 1
# attention layer, 4 MoE FFNs) with 4 of its 16 experts: 16 would hold
# 77 GB in one super-block.  Then greedy decode steps
MOE_RUNS = (("llama4-maverick-400b-a17b", 2, None, "llama4_prefill", None),
            ("kimi-k2-1t-a32b", 1, None, "kimi_prefill", None),
            ("jamba-1.5-large-398b", 8, 4, "jamba_prefill", "jamba_ssd"))
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 4, 4096, 16
# the card-vs-CPU checks in f32: B x prompt (+ 2 decode steps); a routing
# flip passes only as a near tie (the two experts' CPU router scores
# within FLIP_REL relative); jamba's widths cut by 8 (32 SSD heads of 64,
# 8 heads x 128 over 1 KV head), its 16 experts kept
MOE_GATE_BATCH, MOE_GATE_PROMPT = 2, 300
FLIP_REL = 1e-5
JAMBA_CUT = dict(d_model=1024, num_heads=8, num_kv_heads=1, head_dim=128,
                 d_ff=3072)
# causal flash at the MoE prefills' attention shapes (label, B, S, H, D;
# kimi-k2's head dim 112 runs zero-padded on D=128) and the SSD scan at
# jamba's (label, Bt, S, H, P, N, chunk): checked against the plain
# versions at batch 1, timed at B
FA_MOE = (("llama4_prefill", 4, 4096, 40, 128),
          ("kimi_prefill", 4, 4096, 64, 112),
          ("jamba_prefill", 4, 4096, 64, 128))
SSD_JAMBA = ("jamba_ssd", 4, 4096, 256, 64, 128, 256)
# the LM zoo's frontend and codebook models, whole (every layer) at full
# width in bf16, cut from prefill_32k in batch and length only: (arch,
# batch, positions), the frontend's embeddings the first frontend_len of
# them (qwen2-vl 256, musicgen 64); then greedy decode steps.  The
# card-vs-CPU checks: each cut to 2 layers at full width in f32, B x
# positions + 2 decode steps
FRONTEND_RUNS = (("qwen2-vl-2b", 4, 4096), ("musicgen-large", 4, 4096))
FRONTEND_DECODE = 16
FRONTEND_GATE_LAYERS, FRONTEND_GATE_BATCH, FRONTEND_GATE_POSITIONS = 2, 2, 300
# causal flash at their prefills' attention shapes (label, B, S, H, D):
# qwen2-vl's 2 KV heads repeated to its 12 query heads, musicgen's head
# dim 64; checked against the plain version at batch 1, timed at B
FA_FRONTENDS = (("qwen2vl_prefill", 4, 4096, 12, 128),
                ("musicgen_prefill", 4, 4096, 32, 64))

# training (ROADMAP item 7): the CAPSim train step's attention shapes at
# batch 32 (label, B, Sq, Skv, H, D, causal, masked) and a causal LM
# shape, and the Mamba2 SSD shape (label, Bt, S, H, P, N, chunk), where
# the Functions' gradients are held to the plain versions' (f32 within
# GRAD_TOL relative norm per input)
FA_TRAIN = (("inst", 4096, 16, 16, 4, 32, False, True),
            ("block_self", 32, 360, 360, 4, 32, False, False),
            ("block_self_369", 32, 369, 369, 4, 32, False, False),
            ("block_cross", 32, 360, 128, 4, 32, False, True),
            ("block_cross_369", 32, 369, 128, 4, 32, False, True),
            ("causal_lm", 1, 1024, 1024, 32, 128, True, False))
SSD_TRAIN = ("mamba2_train", 1, 4096, 48, 64, 128, 256)
GRAD_TOL = 1e-4
# the f32 flash backward kernels (csrc/flash_attention_bwd.cu) at the train
# cells' shapes (an instruction-encoder pass, b256's block self and cross,
# mc4's over 1476 context rows), a causal window, the LM zoo's causal
# D=128 gradient check, every other head dim and the one-tile kernel
# (Sq, Skv <= 16) off its path shape: (label, B, Sq, Skv, H, D, causal,
# window, masked); a masked case leaves batch row 0 no key
FA_BWD = (("inst_4096", 4096, 16, 16, 4, 32, False, 0, True),
          ("block_self_b256", 256, 360, 360, 4, 32, False, 0, False),
          ("block_cross_b256", 256, 360, 128, 4, 32, False, 0, True),
          ("block_self_m1476", 32, 1476, 1476, 4, 32, False, 0, False),
          ("block_cross_m1476", 32, 1476, 128, 4, 32, False, 0, True),
          ("causal_window", 2, 300, 517, 4, 32, True, 100, True),
          ("causal_lm", 1, 1024, 1024, 32, 128, True, 0, False),
          ("q17_kv40_d32", 3, 17, 40, 4, 32, True, 0, True),
          ("d16", 3, 100, 257, 2, 16, False, 0, True),
          ("d64_causal", 2, 200, 200, 2, 64, True, 0, False),
          ("d128", 2, 100, 257, 2, 128, False, 0, True),
          ("d112_window", 2, 33, 257, 2, 112, True, 50, True),
          ("one_tile_causal", 5, 9, 14, 3, 64, True, 4, True),
          ("one_tile_d16", 7, 16, 11, 2, 16, False, 0, True),
          ("one_tile_d128", 3, 16, 16, 2, 128, True, 0, False))
# the bf16 backward kernels: NemotronH's causal attention in the nemo3
# train cell (2 x 4096 tokens, 32 heads of 128, the KV heads repeated),
# then every other head dim, a window, a query offset and a mask
FA_BWD_BF16 = (("nemo3_attn", 2, 4096, 4096, 32, 128, True, 0, False),
               ("q17_kv40_d32", 3, 17, 40, 4, 32, True, 0, True),
               ("d16", 3, 100, 257, 2, 16, False, 0, True),
               ("d64_causal", 2, 200, 200, 2, 64, True, 0, False),
               ("d112_window", 2, 33, 257, 2, 112, True, 50, True))
# CAPSim training at full width: the data (Table II benchmarks, interval,
# checkpoints: every benchmark, since the first 3 give 27 training clips,
# less than one batch), the paper's batch, the trainer's steps and
# checkpoint period, and a throughput row at a larger batch
TRAIN_DATA = (24, 10_000, 2)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_EVERY = 32, 100, 50
TRAIN_BIG_BATCH, TRAIN_BIG_STEPS = 256, 11
TRAIN_MC_CORES, TRAIN_MC_INTERVAL, TRAIN_MC_STEPS = 4, 20_000, 20
# the LM zoo's loss at full width, cut in depth: (arch, layers), AdamW
# steps on one batch; the f32 card-vs-CPU gradient at a shorter sequence
LM_TRAIN_RUNS = (("qwen3-4b", 2), ("mamba2-780m", 4))
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_GATE_SEQ = 1, 4096, 3, 256
# the LM zoo's multi-device paths (ROADMAP item 6b) on the one card: (a)
# world size 1 over NCCL, (arch, layers, batch, prompt) + decode steps;
# (b) n shards in one process: sequence-parallel prefill at qwen3-4b's
# (B, S, H, KV, D), flash-decoding at its decode shape (B, H, KV, D) over
# S + DIST_DECODE positions, llama4's experts over n model shards (the
# no-drop check at DIST_MOE_TOKENS tokens); (c) the CAPSim DP trainer at
# full width: batch, clip length, steps, and the 2-rank gloo gate
DIST_LM_RUNS = (("qwen3-4b", 36, 4, 4096),
                ("llama4-maverick-400b-a17b", 2, 4, 4096))
DIST_DECODE = 16
DIST_ORDER = ("meshless", "mesh", "mesh", "meshless")
DIST_SP = (4, 4096, 32, 8, 128)
DIST_SP_SHARDS = (2, 4)
DIST_DECODE_SHAPE = (4, 32, 8, 128)
DIST_DECODE_SHARDS = (2, 4, 8)
DIST_DECODE_TOL = 1e-5
DIST_MOE_SHARDS = (2, 4, 8)
DIST_MOE_TOKENS, DIST_MOE_TOL = 1024, 1e-5
DIST_BATCH, DIST_CLIP, DIST_STEPS, DIST_LOSS_TOL = 32, 128, 20, 1e-5
# GSPMD's weight layouts (ROADMAP item 6c): (a) two gloo ranks sharing
# the card, mesh (1, 2), TP over 'model' under LOGICAL_RULES_DECODE at
# full width in bf16, (arch, layers, experts) with B x prompt + decode
# steps through generate, and the f32 gates' cuts (prompt and decode
# steps of their own); (b) training with 'model' = 2 under
# LOGICAL_RULES_TRAIN, (arch, layers) at 1 x TP_TRAIN_SEQ, then FSDP
# rows on a (2, 1) mesh at TP_FSDP_BATCH x TP_FSDP_SEQ; (c) n TP shards in
# one process: flash at qwen3-4b's (B, S, H, KV, D) with H/n and KV/n
# heads, the SSD scan at Mamba2's and jamba's prefill shapes with H/n
TP_RUNS = (("qwen3-4b", None, None), ("mamba2-780m", None, None),
           ("llama4-maverick-400b-a17b", 2, None))
TP_BATCH, TP_PROMPT, TP_DECODE = 1, 4096, 16
TP_GATES = (("qwen3-4b", 2, None), ("mamba2-780m", 4, None),
            ("llama4-maverick-400b-a17b", 2, 8))
TP_GATE_PROMPT, TP_GATE_DECODE = 1024, 4
TP_TRAIN = (("qwen3-4b", 2), ("mamba2-780m", 4))
TP_TRAIN_SEQ, TP_FSDP_BATCH, TP_FSDP_SEQ = 4096, 2, 1024
TP_GATE_TOL, TP_LOSS_TOL, TP_GRAD_TOL = 1e-4, 1e-5, 1e-4
TP_SHARDS = (2, 4, 8)
TP_FLASH = (4, 4096, 32, 8, 128)
TP_SSD = (("mamba2", 4, 4096, 48, 64, 128, 256),
          ("jamba", 4, 4096, 256, 64, 128, 256))
TP_STORE = "tp.store"


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3,
            rounds: int = 3, window_ms: float = 2.0) -> float:
    """ms per call: CUDA events around back-to-back calls after
    ``warmup``, the least mean of ``rounds`` such runs.  A run makes at
    least ``iters`` calls and, for short calls, enough to fill about
    ``window_ms`` (at most 500), so that the start of a run after a
    synchronisation does not weigh on a call of a few microseconds.
    Where a call's host time exceeds its device time (a launch-bound
    shape), this is the host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_ms = 1e3 * (time.perf_counter() - t0)
    iters = max(iters, min(500, math.ceil(window_ms / max(once_ms, 1e-3))))
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one launch of the port's own kernel (names in
    the ``capsim_*`` namespaces; ``fn`` launches one), from
    ``torch.profiler``: at a launch-bound shape the host clock of
    ``cuda_ms`` times the wrapper, this the kernel.  Each capture is
    ``_capture``'s (host and device activity) of ``iters`` calls, after
    ``iters`` calls outside it, and holds every one of their launches.
    Late in a whole run the profiler drops the first device records of
    every capture, whatever their kernel, more of them the more device
    records were captured before (``tools/profiler_drop_probe.py``): a
    capture of a few launches of a long kernel then holds none.  So each
    capture first launches ``pad`` one-element kernels, which take the
    loss; a capture that still lost launches of ``fn`` is taken again
    with a pad 4 times as long, at most three times."""
    from torch.autograd import DeviceType
    pad_tensor = torch.zeros(1, device="cuda")
    pad = CAPTURE_PAD

    def padded():
        for _ in range(pad):
            pad_tensor.add_(1.0)
        for _ in range(iters):
            fn()
    for _ in range(4):
        for _ in range(iters):
            fn()
        _, _, avg = _capture(torch, padded)
        ours = [e for e in avg if e.device_type == DeviceType.CUDA
                and "capsim" in e.key]
        launches = sum(e.count for e in ours)
        if launches == iters:
            break
        print(f"device_ms: a capture held {launches} of {iters} launches "
              f"after a pad of {pad}; capturing again after {4 * pad}")
        pad *= 4
    require(launches == iters, f"the profiler held {launches} of {iters} "
            "launches of the port's kernel")
    return sum(e.self_device_time_total for e in ours) / launches / 1e3


def _roof(flops: float, nbytes: float, dtype: str):
    """(ms, "bytes"|"operations"): the larger of the bytes at the HBM rate
    and the FLOPs at the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound(B, Sq, Skv, H, D, dtype: str, aux: bool, causal: bool = False):
    """(ms, "bytes"|"operations") of one attention launch's work,
    ``attention_cost`` (flash attention's ops module, which the dry-run's
    meta route reports too): q/k/v read once, o written once, the
    per-key mask/weights read once; QK^T and PV over the (query, key)
    pairs the mask leaves live."""
    from repro_torch.kernels.flash_attention.ops import attention_cost
    return _roof(*attention_cost(B, Sq, Skv, H, D,
                                 4 if dtype == "float32" else 2, aux,
                                 causal), dtype)


KERNEL_NAMES = r"(ssd_chunk_state|ssd_chunk_out|ssd_state_pass|ssd_cb|" \
    r"fa_fwd_bf16|fa_fwd_f32|fa_bwd_delta_f32|fa_bwd_dkdv_f32|fa_bwd_dq_f32|" \
    r"fa_bwd_delta_bf16|fa_bwd_dkdv_bf16|fa_bwd_dq_bf16)"


def kernel_label(mangled: str):
    """(label, dtype or None, template ints) of a port kernel's mangled
    name, e.g. ("ssd_chunk_out<bf16, 64>", "bf16", [64])."""
    kind = re.search(KERNEL_NAMES, mangled)
    if kind is None:
        return None
    name = kind.group(1)
    dtype = ("bf16" if "13__nv_bfloat16" in mangled
             or name.startswith("fa_") and name.endswith("_bf16")
             else "f32" if name.startswith("fa_") or re.search(
                 r"\d" + name + r"If", mangled) else None)
    ints = [int(v) for v in re.findall(r"Li(\d+)E", mangled)]
    flags = re.findall(r"Lb([01])E", mangled)
    args = ([dtype] if name.startswith("ssd") and dtype else []) + \
        [str(v) for v in ints] + \
        [{"0": "flash", "1": "weighted"}[f] for f in flags]
    return f"{name}<{', '.join(args)}>" if args else name, dtype, ints


def sass_pipes(torch, build, fa_ops, ssd_ops):
    """Each kernel instantiation's HMMA count (``cuobjdump -sass``),
    registers and static shared memory (``-res-usage``), and the dynamic
    shared memory a launch asks for (the SSD scan's at the Mamba2 prefill
    shape).  bfloat16 must run on the tensor cores (HMMA > 0), float32 on
    the FMA pipes (HMMA == 0)."""
    if build.cuobjdump() is None:
        print("sass: cuobjdump not found; HMMA counts and static shared "
              "memory not measured")
        return
    _, _, _, P, N, q, _, _ = SSD_PATH[1:]
    ssd_smem = {dt: ssd_ops.shared_bytes(getattr(torch, name), P, N, q)
                for dt, name in (("f32", "float32"), ("bf16", "bfloat16"))}
    ssd_slot = {"ssd_cb": 0, "ssd_chunk_state": 1, "ssd_state_pass": 2,
                "ssd_chunk_out": 3}
    for lib in ("flash_attention", "flash_attention_bwd",
                "weighted_attention", "ssd"):
        path = build.library_path(lib)
        hmma = {k: v["HMMA"] for k, v in build.sass_opcodes(path).items()}
        usage = build.resource_usage(path)
        seen = set()
        for name, count in sorted(hmma.items()):
            found = kernel_label(name)
            if found is None:
                continue
            label, dtype, ints = found
            regs, static = usage.get(name, ("not measured", "not measured"))
            base = label.split("<")[0]
            if base.startswith("fa_bwd"):
                dyn = "- (fa_bwd: DkvSmem / DqSmem)"
            elif base.startswith("fa_fwd"):
                tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
                dyn = fa_ops.shared_bytes(tdt, ints[0])
                seen.add((dtype, ints[0]))
            elif base == "ssd_state_pass":
                dyn = 0
            elif not ints or ints[0] == P:
                dyn = ssd_smem[dtype][ssd_slot[base]]
            else:
                dyn = "- (not at the path shape)"
            seen.add(label)
            print(f"sass {lib} {label}: HMMA {count}, registers {regs}, "
                  f"static shared {static} B, dynamic shared {dyn} B")
            if dtype == "bf16":
                # the backward's Δ = rowsum(dO ∘ O) has no product
                require(count > 0 or base == "fa_bwd_delta_bf16",
                        f"{lib} {label} has no HMMA: not on the tensor cores")
            else:
                require(count == 0, f"{lib} {label} has {count} HMMA: f32 "
                        "must stay on the FMA pipes")
        if lib == "flash_attention_bwd":
            want = {f"{k}_{dt}<{d}>" for k in ("fa_bwd_delta",
                                               "fa_bwd_dkdv", "fa_bwd_dq")
                    for dt in ("f32", "bf16") for d in fa_ops.HEAD_DIMS}
            require(want <= seen, f"{lib}: instantiations in the SASS "
                    f"{sorted(seen)}")
        elif lib != "ssd":
            want = {(k, d) for k in ("bf16", "f32") for d in fa_ops.HEAD_DIMS}
            require(want <= seen, f"{lib} instantiations in the SASS: "
                    f"{sorted(x for x in seen if isinstance(x, tuple))}")
            flag = "weighted" if lib == "weighted_attention" else "flash"
            require(all(flag in x for x in seen if isinstance(x, str)),
                    f"{lib} holds the other attention variant")
        else:
            require(any("ssd_chunk_out<bf16" in x for x in seen)
                    and any("ssd_chunk_out<f32" in x for x in seen),
                    "ssd: both dtypes' instantiations in the SASS")


# --------------------------------------------------------------------- #
# kernel cases
# --------------------------------------------------------------------- #

# (label, B, Sq, Skv, H, D, causal, window, mask): the main path's shapes
# at the paper's width (H=4, D=32, batch 256, M=360, L_clip=128, encode
# passes of 32-64 static rows x L_token=16), then the reference kernel
# tests' sweep (tests/test_kernels.py FA_CASES), then a row with no key
FA_PATH = [
    ("inst_encoder", 64, 16, 16, 4, 32, False, 0, "tokens"),
    # since the C2 repair the card runs the instruction encoder in passes
    # of exactly predictor.ENCODE_CHUNK = 4096 instructions: the RT
    # build's and the monolithic rung's shape
    ("inst_encoder_4096", 4096, 16, 16, 4, 32, False, 0, "tokens"),
    # a monolithic batch's instruction rows (256 x 128) in one launch,
    # the shape before the C2 repair, timed beside the passes
    ("inst_encoder_32768", 32768, 16, 16, 4, 32, False, 0, "tokens"),
    ("block_self", 256, 360, 360, 4, 32, False, 0, None),
    ("block_cross", 256, 360, 128, 4, 32, False, 0, "clip"),
    # the multicore path: each core's context carries its core-id channel,
    # M = 369 (369 mod 64 = 49 keys in the last tile)
    ("block_self_m369", 256, 369, 369, 4, 32, False, 0, None),
    ("block_cross_m369", 256, 369, 128, 4, 32, False, 0, "clip"),
    # multicore training with peer channels: 4 cores' contexts side by
    # side, M = 1476 (1476 mod 64 = 4 keys in the last tile), at the
    # paper's training batch
    ("block_self_m1476", 32, 1476, 1476, 4, 32, False, 0, None),
    ("block_cross_m1476", 32, 1476, 128, 4, 32, False, 0, "clip"),
]
FA_SWEEP = [
    ("sweep", 2, 128, 128, 4, 64, True, 0, None),
    ("sweep", 1, 100, 100, 2, 32, True, 0, None),
    ("sweep", 2, 16, 16, 4, 32, False, 0, "random"),
    ("sweep", 1, 360, 128, 4, 32, False, 0, "random"),
    ("sweep", 2, 256, 256, 2, 64, True, 64, None),
    ("sweep", 1, 1, 257, 2, 128, True, 0, None),
    ("sweep", 1, 64, 192, 1, 16, True, 0, None),
    ("fully_masked_row", 4, 16, 16, 4, 32, False, 0, "empty_row"),
    # the tiled kernel's edges: 16-row query blocks and 64-key tiles that
    # end mid-block, a causal window that ends inside a key tile, a mask
    # that empties one whole key tile while the others stay live, and
    # every head dim in both dtypes
    ("q1_kv257", 2, 1, 257, 4, 32, False, 0, "random"),
    ("q17_kv257", 2, 17, 257, 4, 32, True, 0, "random"),
    ("q17_kv257", 1, 17, 257, 2, 16, False, 0, None),
    ("q100_kv257", 2, 100, 257, 2, 64, True, 0, None),
    ("q100_kv257", 1, 100, 257, 2, 128, False, 0, "random"),
    ("window_in_tile", 2, 100, 257, 2, 32, True, 40, None),
    ("window_in_tile", 1, 33, 257, 2, 128, True, 50, "random"),
    ("empty_key_tile", 2, 100, 257, 2, 32, False, 0, "empty_tile"),
    ("empty_key_tile", 2, 70, 200, 2, 16, False, 0, "empty_tile"),
    ("empty_key_tile", 2, 40, 300, 2, 64, True, 0, "empty_tile"),
    # head_dim 112 runs zero-padded on the D=128 instantiation
    ("d112", 2, 100, 257, 2, 112, False, 0, "random"),
    ("d112_causal", 2, 100, 257, 2, 112, True, 0, None),
    ("d112_window", 1, 33, 257, 2, 112, True, 50, "random"),
]
# (label, B, Sq, Skv, H, D, weights): fused self over U deduped tokens (U
# from the dedup ladder, weights = multiplicities with zero-weight padding
# slots), fused cross from U to L_clip=128 (weights = clip_mask)
WA_PATH = [
    ("fused_self_u64", 256, 64, 64, 4, 32, "counts"),
    ("fused_self_u128", 256, 128, 128, 4, 32, "counts"),
    ("fused_cross_u128", 256, 128, 128, 4, 32, "clip"),
]
# the tiled kernel's edges: U not a multiple of 16 or 64, every head dim,
# a whole 64-key tile of zero weights, and zero-weight keys that lead
# every live score (the row max runs over them: by ~200 in batch row 0,
# which must then be zeros)
WA_EDGE = [
    ("zero_weight_keys", 8, 48, 48, 4, 32, "counts"),
    ("all_zero_row", 8, 32, 32, 4, 32, "empty_row"),
    ("u1", 4, 1, 1, 4, 32, "counts"),
    ("u17_d16", 4, 17, 17, 4, 16, "counts"),
    ("u65_d64", 4, 65, 65, 2, 64, "counts"),
    ("u257_d128", 2, 257, 257, 2, 128, "counts"),
    ("empty_key_tile", 4, 100, 200, 2, 32, "counts_empty_tile"),
    ("max_at_zero", 4, 40, 70, 2, 32, "max_at_zero"),
    ("u100_d112", 4, 100, 100, 2, 112, "counts"),
    ("u257_d112", 2, 257, 257, 2, 112, "counts_empty_tile"),
]


def make_qkv(torch, gen, B, Sq, Skv, H, D, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)
    return r(B, Sq, H, D), r(B, Skv, H, D), r(B, Skv, H, D)


def make_aux(torch, gen, kind, B, Skv):
    """Per-key mask/weights, float32 (B, Skv), on the card."""
    if kind is None:
        return None
    if kind == "tokens":                  # <PAD> tail of a token row
        n = torch.randint(2, Skv + 1, (B,), generator=gen)
        w = (torch.arange(Skv)[None] < n[:, None]).float()
    elif kind == "clip":                  # clip_mask: a real prefix of
        # at least half the clip (l_min=100 of l_clip=128 on the path)
        n = torch.randint(Skv // 2, Skv + 1, (B,), generator=gen)
        w = (torch.arange(Skv)[None] < n[:, None]).float()
    elif kind in ("random", "empty_tile"):
        w = (torch.rand(B, Skv, generator=gen) > 0.3).float()
        w[:, 0] = 1.0
        if kind == "empty_tile":          # keys 64-127: one whole tile
            w[:, 64:128] = 0.0
    elif kind in ("counts", "counts_empty_tile", "max_at_zero"):
        # multiplicities + zero padding
        w = torch.randint(1, 9, (B, Skv), generator=gen).float()
        n = torch.randint(Skv // 2, Skv + 1, (B,), generator=gen)
        w = w * (torch.arange(Skv)[None] < n[:, None])
        if kind == "counts_empty_tile":   # keys 64-127: one whole tile
            w[:, 64:128] = 0.0
        if kind == "max_at_zero":         # every fourth key weighs 0
            w[:, torch.arange(Skv) % 4 == 1] = 0.0
    elif kind == "empty_row":
        w = torch.ones(B, Skv)
        w[0] = 0.0
    else:
        raise ValueError(kind)
    return w.to("cuda")


def check_kernels(torch, fa_ops, wa_ops):
    """Every case, both dtypes, kernel vs plain version on the card.
    Returns {kernel: {dtype: max abs err over its cases}}."""
    gen = torch.Generator().manual_seed(0)
    errs = {"flash_attention": {}, "weighted_attention": {}}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        worst = 0.0
        for (label, B, Sq, Skv, H, D, causal, window, kind) in \
                FA_PATH + FA_SWEEP:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, H, D, tdt)
            m = make_aux(torch, gen, kind, B, Skv)
            out = fa_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, kv_mask=m)
            ref = fa_ops.flash_attention_plain(q, k, v, causal=causal,
                                               window=window, kv_mask=m)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel flash_attention {label:16s} {dtype:8s} "
                  f"B={B} Sq={Sq} Skv={Skv} H={H} D={D} causal={causal} "
                  f"window={window} mask={kind} max_abs_err={err:.3e}")
            require(err <= tol, f"flash_attention {label} {dtype} err {err}")
            if kind == "empty_row":
                require(float(out[0].float().abs().max()) == 0.0,
                        "flash_attention: a row with no valid key must "
                        "output zeros")
            worst = max(worst, err)
        errs["flash_attention"][dtype] = worst
        worst = 0.0
        for (label, B, Sq, Skv, H, D, kind) in WA_PATH + WA_EDGE:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, H, D, tdt)
            w = make_aux(torch, gen, kind, B, Skv)
            if kind == "max_at_zero":     # zero-weight keys lead the scores
                zero = (torch.arange(Skv) % 4 == 1).to(w.device)
                q[..., 0] = q[..., 0].abs() + 1.0
                k[:, zero, :, 0] = 5.0 * math.sqrt(D)
                k[0, zero, :, 0] = 200.0 * math.sqrt(D)
            out = wa_ops.weighted_attention(q, k, v, w)
            ref = wa_ops.weighted_attention_plain(q, k, v, w)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel weighted_attention {label:16s} {dtype:8s} "
                  f"B={B} Sq={Sq} Skv={Skv} H={H} D={D} weights={kind} "
                  f"max_abs_err={err:.3e}")
            require(err <= tol,
                    f"weighted_attention {label} {dtype} err {err}")
            if kind in ("empty_row", "max_at_zero"):
                require(float(out[0].float().abs().max()) == 0.0,
                        f"weighted_attention {label}: batch row 0 must "
                        "output zeros")
            if kind == "max_at_zero":
                require(float(out[1:].float().abs().max()) > 0.0,
                        "weighted_attention max_at_zero: rows 1.. are live")
            worst = max(worst, err)
        errs["weighted_attention"][dtype] = worst
    # the fused step hands the weighted kernel strided q/k/v views of one
    # QKV matmul; flash attention gets the same kind of views; both dtypes,
    # every tile edge: 100 rows over 100 keys (ragged 16-row and 64-key
    # tiles)
    for dtype in ("float32", "bfloat16"):
        qkv = torch.randn(8, 100, 384, generator=gen).to("cuda",
                                                         getattr(torch, dtype))
        q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
        w = make_aux(torch, gen, "counts", 8, 100)
        err = float((wa_ops.weighted_attention(q, k, v, w).float()
                     - wa_ops.weighted_attention_plain(q, k, v, w).float())
                    .abs().max())
        print(f"kernel weighted_attention strided_qkv      {dtype:8s} "
              f"B=8 Sq=Skv=100 H=4 D=32 weights=counts max_abs_err="
              f"{err:.3e}")
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        require(err <= tol, f"weighted_attention strided views {dtype} "
                f"err {err}")
        errs["weighted_attention"][dtype] = max(
            errs["weighted_attention"][dtype], err)
    # (and at the multicore context width, 369 rows)
    for dtype, S in (("float32", 100), ("bfloat16", 100), ("float32", 369),
                     ("bfloat16", 369)):
        qkv = torch.randn(8, S, 384, generator=gen).to("cuda",
                                                       getattr(torch, dtype))
        q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
        m = make_aux(torch, gen, "random", 8, S)
        for causal in (False, True):
            out = fa_ops.flash_attention(q, k, v, causal=causal, kv_mask=m)
            ref = fa_ops.flash_attention_plain(q, k, v, causal=causal,
                                               kv_mask=m)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel flash_attention strided_qkv      {dtype:8s} "
                  f"B=8 Sq=Skv={S} H=4 D=32 causal={causal} mask=random "
                  f"max_abs_err={err:.3e}")
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            require(err <= tol, f"flash_attention strided views {dtype} "
                    f"err {err}")
            errs["flash_attention"][dtype] = max(
                errs["flash_attention"][dtype], err)
    return errs


def time_kernels(torch, fa_ops, wa_ops):
    """Kernel / plain / library times at the path shapes, both dtypes.
    Returns {kernel: [row, ...]}."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    rows = {"flash_attention": [], "weighted_attention": []}

    def sdpa_inputs(q, k, v):
        return [x.transpose(1, 2).contiguous() for x in (q, k, v)]

    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for (label, B, Sq, Skv, H, D, _, _, kind) in FA_PATH:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, H, D, tdt)
            m = make_aux(torch, gen, kind, B, Skv)
            qt, kt, vt = sdpa_inputs(q, k, v)
            lib_mask = None if m is None else (m > 0)[:, None, None, :]
            row = {
                "shape": label, "dtype": dtype,
                "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                    q, k, v, kv_mask=m)),
                "device_ms": device_ms(torch, lambda: fa_ops.flash_attention(
                    q, k, v, kv_mask=m)),
                "plain_ms": cuda_ms(torch, lambda:
                                    fa_ops.flash_attention_plain(
                                        q, k, v, kv_mask=m)),
                "library_ms": cuda_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          qt, kt, vt, attn_mask=lib_mask)),
            }
            row["bound_ms"], row["bound_by"] = bound(B, Sq, Skv, H, D,
                                                     dtype, m is not None)
            rows["flash_attention"].append(row)
        for (label, B, Sq, Skv, _, _, kind) in WA_PATH:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, 4, 32, tdt)
            w = make_aux(torch, gen, kind, B, Skv)
            qt, kt, vt = sdpa_inputs(q, k, v)
            # softmax(s + log w) == w·e^s / Σ w·e^s: the same function
            log_w = torch.log(w)[:, None, None, :].to(tdt)
            row = {
                "shape": label, "dtype": dtype,
                "ms": cuda_ms(torch, lambda: wa_ops.weighted_attention(
                    q, k, v, w)),
                "device_ms": device_ms(torch, lambda:
                                       wa_ops.weighted_attention(q, k, v, w)),
                "plain_ms": cuda_ms(torch, lambda:
                                    wa_ops.weighted_attention_plain(
                                        q, k, v, w)),
                "library_ms": cuda_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          qt, kt, vt, attn_mask=log_w)),
            }
            row["bound_ms"], row["bound_by"] = bound(B, Sq, Skv, 4, 32,
                                                     dtype, True)
            rows["weighted_attention"].append(row)
    for name, rs in rows.items():
        for r in rs:
            print(f"time {name} {r['shape']:16s} {r['dtype']:8s} "
                  f"kernel_ms={r['ms']:.4f} "
                  f"device_ms={r['device_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"bound_share={r['bound_ms'] / r['ms']:.3f}")
    return rows


def gate(what: str, value: float, limit: float, enforced: bool) -> None:
    """Print a timing gate's verdict; an enforced gate that is missed
    fails the run."""
    ok = value <= limit
    print(f"gate {what}: {value:.4f} ms <= {limit:.4f} ms "
          f"{'met' if ok else 'MISSED'}"
          f"{'' if enforced else ' (reported, not enforced)'}")
    if enforced:
        require(ok, f"timing gate {what}: {value} > {limit}")


def check_gates(rows) -> None:
    """This slice's timing gates on the rows of time_kernels/time_ssd."""
    for r in rows["weighted_attention"]:
        if r["dtype"] == "bfloat16":
            limit = WA_BF16_GATE[r["shape"]]
            gate(f"weighted {r['shape']} bf16 kernel_ms", r["ms"], limit,
                 limit >= 0.10)
        else:
            gate(f"weighted {r['shape']} f32 kernel_ms below the first "
                 "body's", r["ms"], WA_F32_FIRST[r["shape"]], False)
    for r in rows["flash_attention"]:
        before = FLASH_DEVICE_BEFORE.get((r["shape"], r["dtype"]))
        if before is not None:
            gate(f"flash {r['shape']} {r['dtype']} device_ms within 5%",
                 r["device_ms"], 1.05 * before, False)
    for r in rows["ssd"]:
        gate(f"ssd {r['shape']} {r['dtype']} kernel_ms", r["ms"],
             SSD_GATE[r["dtype"]], True)


# --------------------------------------------------------------------- #
# SSD scan
# --------------------------------------------------------------------- #

# (label, Bt, S, H, P, N, chunk, a_scale, pad_chunk): the reference kernel
# tests' sweep (tests/test_kernels.py SSD_CASES: padding S=100, a single
# chunk), the Mamba2-780m prefill shape, a 4-chunk state carry, dt·|A|
# large enough that seg reaches -1e4 (the split exp form gives 0/0), and
# an all-padding chunk (dt = x = B = C = 0 over the second chunk)
SSD_PATH = ("mamba2_prefill", 4, 4096, 48, 64, 128, 256, 1.0, False)
SSD_CHECKS = [
    ("sweep", 2, 64, 4, 32, 64, 16, 1.0, False),
    ("sweep", 1, 128, 2, 64, 128, 64, 1.0, False),
    ("sweep_padding", 2, 100, 3, 16, 32, 32, 1.0, False),
    ("sweep_one_chunk", 1, 256, 8, 64, 128, 256, 1.0, False),
    SSD_PATH,
    ("state_carry", 2, 1024, 8, 64, 128, 256, 1.0, False),
    ("large_decay", 2, 300, 4, 64, 128, 256, 60.0, False),
    ("padding_chunk", 1, 512, 4, 64, 128, 256, 1.0, True),
    # the chunk-parallel kernel's edges: many chunks with a ragged last
    # one, S shorter than the chunk, the widest head and state, and B/C
    # views one element off 16 bytes (the plain-copy path)
    ("many_chunks_ragged", 1, 5 * 64 + 17, 2, 32, 64, 64, 1.0, False),
    ("s_below_chunk", 2, 40, 3, 16, 32, 64, 1.0, False),
    ("p128_n256", 1, 128, 2, 128, 256, 64, 1.0, False),
    ("unaligned_bc", 2, 300, 4, 64, 20, 128, 1.0, False),
]


# B/C in G groups, head h reading group h // (H / G): (label, Bt, S, H, P,
# N, G, chunk).  Small and ragged shapes, and the LM train cell's
# (nemo3.train-s4k-b2: NemotronH's mixer, 64 heads in 8 groups).
SSD_GROUPED_PATH = ("nemo3_train", 2, 4096, 64, 64, 128, 8, 128)
SSD_GROUPED_CHECKS = [
    ("grouped_small", 2, 100, 8, 16, 32, 4, 32),
    ("grouped_ragged", 1, 5 * 64 + 17, 6, 32, 64, 3, 64),
    SSD_GROUPED_PATH,
]


def ssd_inputs(torch, gen, Bt, S, H, P, N, dtype, a_scale=1.0,
               pad_chunk=0):
    """x, dt, B, C, A on the card, drawn as the reference tests draw
    them; ``pad_chunk`` > 0 zeroes every step from that index on."""
    x = torch.randn(Bt, S, H, P, generator=gen) * 0.5
    dt = torch.randn(Bt, S, H, generator=gen).abs() * 0.4 + 0.01
    B = torch.randn(Bt, S, N, generator=gen) * 0.3
    C = torch.randn(Bt, S, N, generator=gen) * 0.3
    A = (-torch.randn(H, generator=gen).abs() - 0.1) * a_scale
    if pad_chunk:
        for t in (x, dt, B, C):
            t[:, pad_chunk:] = 0.0
    return (x.to("cuda", dtype), dt.cuda(), B.to("cuda", dtype),
            C.to("cuda", dtype), A.cuda())


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|."""
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def check_ssd(torch, ssd_ops):
    """Every SSD case, both dtypes, kernel vs plain version on the card.
    Returns {dtype: max abs err over the cases}."""
    gen = torch.Generator().manual_seed(2)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        worst = 0.0
        for (label, Bt, S, H, P, N, q, a_scale, pad) in SSD_CHECKS:
            args = ssd_inputs(torch, gen, Bt, S, H, P, N, tdt, a_scale,
                              q if pad else 0)
            if label == "unaligned_bc":   # rows N + 1 apart, one element in
                x, dt, B, C, A = args
                B, C = (torch.nn.functional.pad(t, (1, 0))[..., 1:]
                        for t in (B, C))
                args = (x, dt, B, C, A)
            y, st = ssd_ops.ssd_scan(*args, chunk=q)
            yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=q)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(y.float()).all()
                         and torch.isfinite(st).all()),
                    f"ssd {label} {dtype}: non-finite output")
            ey, es = rel_err(y, yp), rel_err(st, sp)
            abs_err = float(max((y.float() - yp.float()).abs().max(),
                                (st - sp).abs().max()))
            extra = ""
            if label == "state_carry":     # one 1024-step chunk, same state
                _, st1 = ssd_ops.ssd_scan(*args, chunk=S)
                torch.cuda.synchronize()
                extra = f" vs_one_chunk_state={rel_err(st1, st):.3e}"
                require(rel_err(st1, st) <= SSD_TOL[dtype],
                        f"ssd state carry {dtype}: chunked vs one chunk")
            if label == "padding_chunk":   # the empty chunk leaves the state
                _, st1 = ssd_ops.ssd_scan(*(a[:, :q] if a.dim() > 1 else a
                                            for a in args), chunk=q)
                torch.cuda.synchronize()
                require(torch.equal(st1, st), f"ssd {dtype}: an all-padding "
                        "chunk changed the state")
            print(f"kernel ssd {label:16s} {dtype:8s} Bt={Bt} S={S} H={H} "
                  f"P={P} N={N} chunk={q} A_scale={a_scale} rel_err_y="
                  f"{ey:.3e} rel_err_state={es:.3e} max_abs_err="
                  f"{abs_err:.3e}{extra}")
            require(ey <= SSD_TOL[dtype] and es <= SSD_STATE_TOL[dtype],
                    f"ssd {label} {dtype}: rel err y {ey} state {es}")
            worst = max(worst, abs_err)
        errs[dtype] = worst
    return errs


def grouped_inputs(torch, gen, Bt, S, H, P, N, G, dtype, one_projection):
    """``ssd_inputs`` with B/C (Bt, S, G, N): contiguous, as the mixer's
    two products give them, or (``one_projection``) sliced from one
    (Bt, S, 2·G·N) product, their rows 2·G·N apart."""
    x, dt, B, C, A = ssd_inputs(torch, gen, Bt, S, H, P, G * N, dtype)
    if one_projection:
        BC = torch.cat([B, C], -1)
        B, C = BC[..., :G * N], BC[..., G * N:]
    return x, dt, B.unflatten(-1, (G, N)), C.unflatten(-1, (G, N)), A


def per_group_scan(torch, ssd_ops, x, dt, B, C, A, chunk):
    """The one-group plain version once per group over its heads: the
    grouped scan's meaning, apart from its own plain version."""
    G = B.shape[2]
    R = x.shape[2] // G
    ys, sts = zip(*(ssd_ops.ssd_scan_plain(
        x[:, :, g * R:(g + 1) * R], dt[:, :, g * R:(g + 1) * R],
        B[:, :, g], C[:, :, g], A[g * R:(g + 1) * R], chunk)
        for g in range(G)))
    return torch.cat(ys, 2), torch.cat(sts, 1)


def check_ssd_grouped(torch, ssd_ops):
    """Every grouped case, both dtypes, both B/C layouts: the kernel
    against the plain version and against the one-group plain version
    per group; at the smallest case the backward too (the card's
    ``_SSDScan`` against autograd through the per-group loop).  Returns
    {dtype: max abs err}."""
    gen = torch.Generator().manual_seed(6)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        worst = 0.0
        for (label, Bt, S, H, P, N, G, q) in SSD_GROUPED_CHECKS:
            for one in (False, True):
                args = grouped_inputs(torch, gen, Bt, S, H, P, N, G, tdt, one)
                y, st = ssd_ops.ssd_scan(*args, chunk=q)
                yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=q)
                yg, sg = per_group_scan(torch, ssd_ops, *args, q)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(y.float()).all()
                             and torch.isfinite(st).all()),
                        f"ssd {label} {dtype}: non-finite output")
                ey, es = rel_err(y, yp), rel_err(st, sp)
                gy, gs = rel_err(y, yg), rel_err(st, sg)
                abs_err = float(max((y.float() - yp.float()).abs().max(),
                                    (st - sp).abs().max()))
                layout = "one_projection" if one else "two_products"
                print(f"kernel ssd {label:16s} {dtype:8s} Bt={Bt} S={S} "
                      f"H={H} P={P} N={N} G={G} chunk={q} {layout}: vs "
                      f"plain rel_err_y={ey:.3e} rel_err_state={es:.3e}; "
                      f"vs per-group plain rel_err_y={gy:.3e} "
                      f"rel_err_state={gs:.3e}; max_abs_err={abs_err:.3e}")
                require(max(ey, gy) <= SSD_TOL[dtype]
                        and max(es, gs) <= SSD_STATE_TOL[dtype],
                        f"ssd {label} {dtype} {layout}: rel err y {ey} / "
                        f"{gy} state {es} / {gs}")
                worst = max(worst, abs_err)
                del args, y, st, yp, sp, yg, sg
        label, Bt, S, H, P, N, G, q = SSD_GROUPED_CHECKS[0]
        args = [t.detach().requires_grad_(True) for t in grouped_inputs(
            torch, gen, Bt, S, H, P, N, G, tdt, True)]
        w = torch.randn(Bt, S, H, P, generator=gen).to("cuda", tdt)
        y, _ = ssd_ops.ssd_scan(*args, chunk=q)
        got = torch.autograd.grad((y.float() * w.float()).sum(), args)
        y, _ = per_group_scan(torch, ssd_ops, *args, q)
        want = torch.autograd.grad((y.float() * w.float()).sum(), args)
        for name, a, b in zip(("x", "dt", "B", "C", "A"), got, want):
            e = rel_err(a, b)
            print(f"kernel ssd {label} {dtype} backward d{name} vs "
                  f"per-group autograd rel_err={e:.3e}")
            require(e <= SSD_TOL[dtype], f"ssd {label} {dtype}: backward "
                    f"d{name} rel err {e}")
        errs[dtype] = worst
    torch.cuda.empty_cache()
    return errs


def time_ssd_grouped(torch, ssd_ops):
    """Kernel / plain / per-group plain times and the bound at the LM
    train cell's shape (B/C as the mixer gives them), both dtypes."""
    gen = torch.Generator().manual_seed(7)
    label, Bt, S, H, P, N, G, q = SSD_GROUPED_PATH
    rows = []
    for dtype in ("float32", "bfloat16"):
        args = grouped_inputs(torch, gen, Bt, S, H, P, N, G,
                              getattr(torch, dtype), False)
        row = {"shape": label, "dtype": dtype,
               "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan(*args, chunk=q),
                             iters=10, warmup=2),
               "plain_ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan_plain(
                   *args, chunk=q), iters=3, warmup=1, rounds=1),
               "per_group_ms": cuda_ms(torch, lambda: per_group_scan(
                   torch, ssd_ops, *args, q), iters=2, warmup=1, rounds=1),
               "library_ms": None}
        parts = device_breakdown(torch, lambda: ssd_ops.ssd_scan(
            *args, chunk=q), SSD_KERNELS)
        row["device_ms"] = sum(parts.values())
        row["bound_ms"], row["bound_by"] = _roof(*ssd_ops.ssd_cost(
            Bt, S, H, P, N, q, 4 if dtype == "float32" else 2, G), dtype)
        rows.append(row)
        print(f"time ssd {label:16s} {dtype:8s} Bt={Bt} S={S} H={H} P={P} "
              f"N={N} G={G} chunk={q} kernel_ms={row['ms']:.4f} "
              f"device_ms={row['device_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"per_group_plain_ms={row['per_group_ms']:.4f} "
              f"library_ms=none bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}) bound_share="
              f"{row['bound_ms'] / row['device_ms']:.4f}; device ms per "
              "kernel: " + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        del args
    torch.cuda.empty_cache()
    return rows


def ssd_bound(Bt, S, H, P, N, q, dtype: str):
    """(ms, "bytes"|"operations") for the work the function needs,
    ``ssd_cost`` (the SSD scan's ops module, which the dry-run's meta
    route reports too): C·Bᵀ over each chunk's causal half once, the
    decayed causal product and the carried state per head; x read and y
    written, B/C, dt and A read, the f32 state written once."""
    from repro_torch.kernels.ssd.ops import ssd_cost
    return _roof(*ssd_cost(Bt, S, H, P, N, q,
                           4 if dtype == "float32" else 2), dtype)


def device_breakdown(torch, fn, kernels: int, iters: int = 5):
    """Device ms per call of each of the ``kernels`` port kernels (names
    in the ``capsim_*`` namespaces) that one call of ``fn`` launches once
    each, from ``torch.profiler``.  A capture counts as whole only when
    it holds each of them ``iters`` times: one that lost launches would
    read low, so it is taken again, at most twice, and then refused.  The
    first launches of a capture can reach the profiler late (the first
    call's first two kernels went missing at the Mamba2 shape), so each
    capture records ``iters`` calls after a warm-up step of as many,
    whose events the profiler's schedule drops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        ready = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: ready.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        out, counts = {}, {}
        for e in (ready[-1] if ready else []):
            if e.device_type == DeviceType.CUDA and "capsim" in e.key:
                name = re.sub(r"\(capsim_ssd::Args.*", "", e.key)
                name = name.replace("capsim_ssd::", "").replace("void ", "")
                out[name] = e.self_device_time_total / iters / 1e3
                counts[name] = e.count
        whole = len(counts) == kernels and all(
            n == iters for n in counts.values())
        if whole:
            break
        print(f"device_breakdown: a partial capture ({len(counts)} of "
              f"{kernels} kernels, launches {sorted(counts.values())} where "
              f"each should read {iters}); capturing again")
    require(whole, f"device_breakdown: no whole capture in 3 ({counts})")
    return out


def time_ssd(torch, ssd_ops):
    """Kernel / plain times at the Mamba2 prefill shape, both dtypes."""
    gen = torch.Generator().manual_seed(3)
    label, Bt, S, H, P, N, q, _, _ = SSD_PATH
    rows = []
    for dtype in ("float32", "bfloat16"):
        args = ssd_inputs(torch, gen, Bt, S, H, P, N, getattr(torch, dtype))
        row = {"shape": label, "dtype": dtype,
               "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan(*args, chunk=q),
                             iters=10, warmup=2),
               "plain_ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan_plain(
                   *args, chunk=q), iters=3, warmup=1, rounds=1),
               "library_ms": None}
        parts = device_breakdown(torch, lambda: ssd_ops.ssd_scan(
            *args, chunk=q), SSD_KERNELS)
        row["device_ms"] = sum(parts.values())
        row["bound_ms"], row["bound_by"] = ssd_bound(Bt, S, H, P, N, q,
                                                     dtype)
        rows.append(row)
        print(f"time ssd {label:16s} {dtype:8s} kernel_ms={row['ms']:.4f} "
              f"device_ms={row['device_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms=none "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"bound_share={row['bound_ms'] / row['ms']:.4f}; device ms "
              "per kernel: " + "; ".join(f"{k} {v:.4f}"
                                         for k, v in parts.items()))
    return rows


def embedding_ids(torch, gen, shape, vocab, dtype):
    """Token rows as the train cells hold them: ids in [1, vocab) with a
    <PAD> (0) tail along the last axis, on the card."""
    ids = torch.randint(1, vocab, shape, generator=gen)
    lens = torch.randint(1, shape[-1] + 1, shape[:-1], generator=gen)
    ids[torch.arange(shape[-1]) >= lens[..., None]] = 0
    return ids.to("cuda", dtype)


def check_embedding(torch, emb_ops):
    """The embedding gradient kernel against its plain version, bitwise
    repeatable, then timed (the module docstring's phase 4b).  Returns
    (the rows of the timing, the largest error as a share of the sum of
    |values|)."""
    gen = torch.Generator().manual_seed(11)
    cases = [(label, shape, EMB_VOCAB, EMB_WIDTH, dtype)
             for label, shape in EMB_PATH
             for dtype in (torch.int32, torch.int64)]
    cases.append(("vocab_tiles_1500x72", (700, 16), 1500, 72, torch.int64))
    worst = 0.0
    for label, shape, vocab, width, dtype in cases:
        ids = embedding_ids(torch, gen, shape, vocab, dtype)
        if label.startswith("vocab_tiles"):
            ids = torch.where(ids % 3 == 0, ids - vocab, ids)
        g = torch.randn(*shape, width, generator=gen).cuda()
        got = emb_ops.embedding_grad(g, ids, vocab)
        again = emb_ops.embedding_grad(g, ids, vocab)
        want = emb_ops.embedding_grad_plain(g, ids, vocab)
        scale = emb_ops.embedding_grad_plain(g.abs(), ids, vocab)
        torch.cuda.synchronize()
        err = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
        print(f"kernel embedding_grad {label:22s} {str(dtype)[6:]:5s} "
              f"ids={tuple(shape)} table={vocab}x{width} err/sum|g|="
              f"{err:.3e} same_bits={torch.equal(got, again)}")
        require(bool(((got - want).abs() <= EMB_TOL * scale).all()),
                f"embedding_grad {label} {dtype}: {err:.3e} of the sum of "
                f"|values| > {EMB_TOL}")
        require(torch.equal(got, again), f"embedding_grad {label}: two "
                "calls differ")
        worst = max(worst, err)
    rows = []
    for label, shape in EMB_PATH:
        ids = embedding_ids(torch, gen, shape, EMB_VOCAB, torch.int32)
        g = torch.randn(*shape, EMB_WIDTH, generator=gen).cuda()
        flat, g2 = ids.reshape(-1).long(), g.reshape(-1, EMB_WIDTH)
        zeros = torch.zeros(EMB_VOCAB, EMB_WIDTH, device="cuda")
        n = ids.numel()

        def library():
            """``F.embedding``'s backward (``padding_idx`` -1: none)."""
            return torch.ops.aten.embedding_dense_backward(
                g, ids, EMB_VOCAB, -1, False)
        lib = library()
        want = emb_ops.embedding_grad_plain(g, ids, EMB_VOCAB)
        scale = emb_ops.embedding_grad_plain(g.abs(), ids, EMB_VOCAB)
        lib_err = float(((lib - want).abs() / scale.clamp(min=1e-30)).max())
        lib_same = torch.equal(lib, library())

        def index_put():
            return zeros.clone().index_put_((flat,), g2, accumulate=True)
        row = {"shape": label, "dtype": "float32",
               "ms": cuda_ms(torch, lambda: emb_ops.embedding_grad(
                   g, ids, EMB_VOCAB)),
               "plain_ms": cuda_ms(torch, lambda: emb_ops.
                                   embedding_grad_plain(g, ids, EMB_VOCAB)),
               "library_ms": cuda_ms(torch, library),
               "index_put_ms": cuda_ms(torch, index_put)}
        # every kernel of the two library paths, 5 calls under the profiler
        libs = {what: device_profile(torch, lambda: [fn() for _ in range(5)],
                                     8)[2:]
                for what, fn in (("F.embedding backward", library),
                                 ("index_put_ accumulate", index_put))}
        parts = device_breakdown(torch, lambda: emb_ops.embedding_grad(
            g, ids, EMB_VOCAB), 2)
        row["device_ms"] = sum(parts.values())
        row["bound_ms"], row["bound_by"] = _roof(*emb_ops.embedding_grad_cost(
            n, EMB_VOCAB, EMB_WIDTH, 4), "float32")
        chunks = emb_ops.chunk_count(n, EMB_VOCAB, EMB_WIDTH,
                                     emb_ops._sm_count(0))
        rows.append(row)
        print(f"time embedding_grad {label:22s} float32 kernel_ms="
              f"{row['ms']:.4f} device_ms={row['device_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms="
              f"{row['library_ms']:.4f} (F.embedding backward: "
              f"err/sum|g|={lib_err:.3e}, same_bits={lib_same}) "
              f"index_put_ms={row['index_put_ms']:.4f} (index_put_ "
              f"accumulate) bound_ms="
              f"{row['bound_ms']:.4f} ({row['bound_by']}) bound_share="
              f"{row['bound_ms'] / row['ms']:.4f} device_bound_share="
              f"{row['bound_ms'] / row['device_ms']:.4f} chunks={chunks}; "
              "device ms per kernel: " + "; ".join(
                  f"{re.sub(r'[(<].*', '', k.split('::')[-1])} {v:.4f}"
                  for k, v in parts.items()))
        for what, (busy, _, top) in libs.items():
            print(f"time embedding_grad {label:22s} {what}: device ms a call "
                  f"{1e3 * busy / 5:.4f}; its kernels (device ms a call, "
                  "launches a call): " + "; ".join(
                      f"{name[:90]} {ms / 5:.4f} x{n // 5}"
                      for name, ms, n in top))
    return rows, worst


# --------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------- #

def run_engine(torch, params, cfg, vocab, names, config, device="cuda"):
    from repro_torch.core.engine import SimulationEngine
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          device=device)
    engine.submit_names(names)
    t0 = time.perf_counter()
    results = engine.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return results, wall, engine


def check_engine(torch, fa_ops, wa_ops):
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import progen

    cfg = config()
    vocab = std_mod.build_vocab()
    names = list(progen.TABLE_II)[:BENCHMARKS]
    params = predictor.init_params(cfg, seed=0, device="cuda")
    base = EngineConfig(precision="fp32", interval_size=20_000,
                        max_checkpoints=1, batch_size=256, with_oracle=True)
    print(f"engine config: E={cfg.d_model} heads={cfg.num_heads} "
          f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} M={cfg.context_tokens} "
          f"L_clip={base.l_clip} L_token={base.l_token} batch="
          f"{base.batch_size} interval={base.interval_size} benchmarks="
          f"{names}")

    runs, launches = {}, {}
    for fused in (False, True):
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        res, wall, eng = run_engine(torch, params, cfg, vocab, names,
                                    base.replace(fused_serving=fused))
        launches[fused] = (fa_ops.flash_attention.launches,
                           wa_ops.weighted_attention.launches)
        runs[fused] = res
        st, rt = eng.last_stats, eng.last_rt_stats
        n_clips = sum(r.n_clips for r in res)
        print(f"engine fused={fused} fp32: {n_clips} clips in {wall:.3f} s "
              f"= {n_clips / wall:.1f} clips/s (host front-end and oracle "
              f"included); predict {st.predict_seconds:.3f} s, "
              f"{st.n_batches} batches, {st.n_pad} pad rows; rt build "
              f"{rt.build_seconds:.3f} s for {rt.n_rows_encoded} rows in "
              f"{rt.n_encode_passes} passes; launches flash="
              f"{launches[fused][0]} weighted={launches[fused][1]}")
        for r in res:
            print(f"  {r.name:16s} clips={r.n_clips} predicted="
                  f"{r.predicted_cycles!r} oracle={r.oracle_cycles!r}")
    require(launches[False][0] > 0, "unfused run launched no flash kernel")
    require(launches[True][0] > 0, "fused run launched no flash kernel "
            "(RT build)")
    require(launches[True][1] > 0, "fused run launched no weighted kernel")
    for fused, res in runs.items():
        require(all(math.isfinite(r.predicted_cycles) for r in res),
                f"non-finite prediction (fused={fused})")
        require(all(r.n_clips > 0 for r in res), "a benchmark had no clips")
    for a, b in zip(runs[False], runs[True]):
        rel = abs(b.predicted_cycles - a.predicted_cycles) \
            / abs(a.predicted_cycles)
        print(f"fused vs unfused {a.name}: rel {rel:.3e}")
        require(a.oracle_cycles == b.oracle_cycles, "oracle cycles differ")
        require(rel <= 1e-3, f"fused vs unfused {a.name} rel {rel}")

    # bf16, the paper model's own dtype: unfused (flash) and fused (the
    # weighted kernel's bf16 instantiation on the engine path)
    for fused in (False, True):
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        bf16, wall, eng = run_engine(
            torch, params, cfg, vocab, names,
            base.replace(precision="bf16", fused_serving=fused))
        counts = (fa_ops.flash_attention.launches,
                  wa_ops.weighted_attention.launches)
        st = eng.last_stats
        n_clips = sum(r.n_clips for r in bf16)
        print(f"engine fused={fused} bf16: {n_clips} clips in {wall:.3f} s "
              f"= {n_clips / wall:.1f} clips/s (host front-end and oracle "
              f"included); predict {st.predict_seconds:.3f} s, "
              f"{st.n_batches} batches, {st.n_pad} pad rows; launches "
              f"flash={counts[0]} weighted={counts[1]}")
        require(counts[0] > 0, f"bf16 fused={fused} run launched no flash "
                "kernel")
        if fused:
            require(counts == launches[True], f"fused bf16 launches {counts}"
                    f" != fused fp32 launches {launches[True]}")
        for a, b in zip(runs[fused], bf16):
            rel = abs(b.predicted_cycles - a.predicted_cycles) \
                / abs(a.predicted_cycles)
            print(f"bf16 vs fp32 fused={fused} {a.name}: rel {rel:.3e}")
            require(a.oracle_cycles == b.oracle_cycles,
                    "oracle cycles differ")
            require(rel <= 1e-2, f"bf16 vs fp32 fused={fused} {a.name} "
                    f"rel {rel}")

    cpu, cpu_wall, _ = run_engine(torch, params, cfg, vocab, names[:1],
                                  base, device="cpu")
    a, b = runs[False][0], cpu[0]
    rel = abs(b.predicted_cycles - a.predicted_cycles) \
        / abs(a.predicted_cycles)
    print(f"card vs CPU plain path {a.name}: rel {rel:.3e} "
          f"(CPU run {cpu_wall:.1f} s)")
    require(a.oracle_cycles == b.oracle_cycles, "oracle cycles differ")
    require(rel <= 1e-4, f"card vs CPU {a.name} rel {rel}")
    return {"flash_attention": launches[False][0] + launches[True][0],
            "weighted_attention": launches[False][1] + launches[True][1]}


# --------------------------------------------------------------------- #
# multicore engine and the persistent RT store
# --------------------------------------------------------------------- #

def run_multicore(torch, params, cfg, vocab, mbenches, config,
                  device="cuda"):
    from repro_torch.core.engine import SimulationEngine
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          device=device)
    t0 = time.perf_counter()
    results = engine.run_multicore(mbenches)
    if device == "cuda":
        torch.cuda.synchronize()
    return results, time.perf_counter() - t0, engine


def print_multicore(what, results, wall, engine, counts) -> None:
    st, rt = engine.last_stats, engine.last_rt_stats
    n_clips = sum(r.n_clips for r in results)
    print(f"multicore {what}: {n_clips} clips in {wall:.3f} s = "
          f"{n_clips / wall:.1f} clips/s (host front-end and oracle "
          f"included); predict {st.predict_seconds:.3f} s, {st.n_batches} "
          f"batches, {st.n_pad} pad rows; rt {rt.n_rows_encoded} rows "
          f"encoded, {rt.n_rows_loaded} loaded; launches flash={counts[0]} "
          f"weighted={counts[1]}")
    for r in results:
        for c in r.cores:
            print(f"  {c.name:16s} clips={c.n_clips} predicted="
                  f"{c.predicted_cycles!r} oracle={c.oracle_cycles!r}")
    require(sum(c.n_clips for r in results for c in r.cores)
            == st.n_predicted == st.n_clips,
            f"multicore {what}: clips not conserved")
    require(all(math.isfinite(c.predicted_cycles) and c.n_clips > 0
                for r in results for c in r.cores),
            f"multicore {what}: a core has no clips or a non-finite "
            "prediction")


def per_core_rel(a_results, b_results, what: str, tol: float) -> float:
    """max over cores of |b - a| / |a|; checks that the cores, their
    clips and their oracle cycles line up."""
    worst = 0.0
    for a, b in zip(a_results, b_results, strict=True):
        for ca, cb in zip(a.cores, b.cores, strict=True):
            require((ca.name, ca.n_clips) == (cb.name, cb.n_clips),
                    f"{what}: cores differ")
            require(ca.oracle_cycles == cb.oracle_cycles,
                    f"{what}: oracle cycles differ at {ca.name}")
            worst = max(worst, abs(cb.predicted_cycles - ca.predicted_cycles)
                        / abs(ca.predicted_cycles))
    print(f"{what}: max per-core rel {worst:.3e} (limit {tol:g})")
    require(worst <= tol, f"{what}: per-core rel {worst} > {tol}")
    return worst


def check_multicore(torch, fa_ops, wa_ops):
    """The multicore suite (mt.stream, mt.chase, mt.counter, mt.mix, each
    on MULTICORE_CORES cores) through ``run_multicore`` at the paper
    model's full width.  Returns (launches, the weighted kernel's (U,
    rows) seen in the fused runs)."""
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import multicore

    cfg = config()
    vocab = std_mod.build_vocab()
    params = predictor.init_params(cfg, seed=0, device="cuda")
    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    base = EngineConfig(precision="fp32", interval_size=MULTICORE_INTERVAL,
                        max_checkpoints=1, batch_size=256, with_oracle=True)
    print(f"multicore config: E={cfg.d_model} heads={cfg.num_heads} "
          f"head_dim={cfg.head_dim} M=369 L_clip={base.l_clip} batch="
          f"{base.batch_size} interval={base.interval_size} checkpoints="
          f"{base.max_checkpoints} benchmarks={[m.name for m in mbenches]} "
          f"x{MULTICORE_CORES} cores")
    # the fused step's U per batch, read off the host-side dedup
    seen_u = {}
    dedupe = std_mod.dedupe_context_tokens

    def recording(ctx, *a, **kw):
        uniq, counts = dedupe(ctx, *a, **kw)
        require(ctx.shape[1] == 369, f"a fused batch has M={ctx.shape[1]}")
        seen_u[uniq.shape[1]] = seen_u.get(uniq.shape[1], 0) + 1
        return uniq, counts

    runs, launches = {}, [0, 0]
    for precision in ("fp32", "bf16"):
        for fused in (False, True):
            fa_ops.flash_attention.launches = 0
            wa_ops.weighted_attention.launches = 0
            std_mod.dedupe_context_tokens = recording
            try:
                res, wall, eng = run_multicore(
                    torch, params, cfg, vocab, mbenches,
                    base.replace(precision=precision, fused_serving=fused))
            finally:
                std_mod.dedupe_context_tokens = dedupe
            counts = (fa_ops.flash_attention.launches,
                      wa_ops.weighted_attention.launches)
            if precision == "fp32":
                launches = [launches[0] + counts[0], launches[1] + counts[1]]
            runs[precision, fused] = res
            print_multicore(f"{precision} fused={fused}", res, wall, eng,
                            counts)
            require(counts[0] > 0, f"multicore {precision} fused={fused}: "
                    "no flash launch")
            require((counts[1] > 0) == fused, f"multicore {precision} "
                    f"fused={fused}: weighted launches {counts[1]}")
    print(f"multicore fused batches by U: {dict(sorted(seen_u.items()))}")
    per_core_rel(runs["fp32", False], runs["fp32", True],
                 "multicore fused vs unfused fp32", 1e-3)
    for fused in (False, True):
        per_core_rel(runs["fp32", fused], runs["bf16", fused],
                     f"multicore bf16 vs fp32 fused={fused}", 1e-2)
    # the card's fp32 run against the port's CPU path, one benchmark
    cpu, cpu_wall, _ = run_multicore(torch, params, cfg, vocab,
                                     mbenches[:1], base, device="cpu")
    print(f"multicore CPU plain path: {mbenches[0].name} in {cpu_wall:.1f} s")
    per_core_rel(runs["fp32", False][:1], cpu,
                 f"multicore card vs CPU {mbenches[0].name}", 1e-4)
    return {"flash_attention": launches[0],
            "weighted_attention": launches[1]}, seen_u


def fused_weighted_shapes(torch, wa_ops, seen_u, m_ctx=369, prefix="mc",
                          seed=4):
    """The weighted kernel at each U a fused step reached (batch 256, H4
    D32): self U->U weighted by multiplicities summing to the context
    width ``m_ctx``, cross U->128 weighted by clip_mask; kernel vs plain
    in both dtypes, and the timing rows."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(seed)
    rows, errs = [], {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        for U in sorted(seen_u):
            for label, Skv in ((f"{prefix}_fused_self_u{U}", U),
                               (f"{prefix}_fused_cross_u{U}", 128)):
                B, H, D = 256, 4, 32
                q, k, v = make_qkv(torch, gen, B, U, Skv, H, D, tdt)
                if Skv == U:      # multiplicities of U slots summing to M
                    n = torch.randint(max(1, U // 2), U + 1, (B,),
                                      generator=gen)
                    w = torch.zeros(B, U)
                    for b in range(B):
                        w[b, :n[b]] = torch.bincount(
                            torch.randint(0, int(n[b]),
                                          (m_ctx - int(n[b]),),
                                          generator=gen),
                            minlength=int(n[b])).float() + 1.0
                    w = w.cuda()
                else:
                    w = make_aux(torch, gen, "clip", B, Skv)
                out = wa_ops.weighted_attention(q, k, v, w)
                ref = wa_ops.weighted_attention_plain(q, k, v, w)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                print(f"kernel weighted_attention {label:16s} {dtype:8s} "
                      f"B={B} Sq={U} Skv={Skv} H={H} D={D} "
                      f"max_abs_err={err:.3e}")
                require(err <= tol, f"weighted_attention {label} {dtype} "
                        f"err {err}")
                errs[dtype] = max(errs.get(dtype, 0.0), err)
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                log_w = torch.log(w)[:, None, None, :].to(tdt)
                row = {"shape": label, "dtype": dtype,
                       "ms": cuda_ms(torch, lambda: wa_ops.weighted_attention(
                           q, k, v, w)),
                       "device_ms": device_ms(torch, lambda:
                                              wa_ops.weighted_attention(
                                                  q, k, v, w)),
                       "plain_ms": cuda_ms(torch, lambda:
                                           wa_ops.weighted_attention_plain(
                                               q, k, v, w)),
                       "library_ms": cuda_ms(torch, lambda:
                                             F.scaled_dot_product_attention(
                                                 qt, kt, vt, attn_mask=log_w))}
                row["bound_ms"], row["bound_by"] = bound(B, U, Skv, H, D,
                                                         dtype, True)
                rows.append(row)
                print(f"time weighted_attention {label:16s} {dtype:8s} "
                      f"kernel_ms={row['ms']:.4f} "
                      f"device_ms={row['device_ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"library_ms={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"bound_share={row['bound_ms'] / row['ms']:.3f}")
    return rows, errs


def check_rt_store(torch):
    """The persistent RT store on the card, through ``rt_store_dir``:
    a run persists, a restart adopts the table (rows loaded, none
    encoded) and reproduces the run bitwise, in fp32 and in bf16 (whose
    table round-trips bit for bit), and a store the CPU path wrote in the
    same directory is not adopted by the card."""
    import shutil
    import tempfile

    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.core.rt_cache import RTCache
    from repro_torch.isa import multicore

    cfg = config()
    vocab = std_mod.build_vocab()
    params = predictor.init_params(cfg, seed=0, device="cuda")
    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="rt_store_", dir=build_dir))
    try:
        for precision in ("fp32", "bf16"):
            ec = EngineConfig(precision=precision,
                              interval_size=MULTICORE_INTERVAL,
                              max_checkpoints=1, batch_size=256,
                              with_oracle=False, rt_store_dir=str(store))
            runs = []
            for attempt in ("cold", "restart"):
                res, wall, eng = run_multicore(torch, params, cfg, vocab,
                                               mbenches, ec)
                rt = eng.last_rt_stats
                table = eng._stack.cache.table[:eng._stack.cache.n_rows]
                runs.append(([c.predicted_cycles for r in res
                              for c in r.cores], rt, table))
                print(f"rt-store {precision} {attempt}: {wall:.3f} s, "
                      f"{rt.n_rows_encoded} rows encoded in "
                      f"{rt.build_seconds:.4f} s, {rt.n_rows_loaded} loaded "
                      f"in {rt.store_load_seconds:.4f} s, table "
                      f"{table.dtype}")
            (p1, rt1, t1), (p2, rt2, t2) = runs
            require(rt1.n_rows_loaded == 0 and rt1.n_rows_encoded > 0,
                    f"rt-store {precision}: the cold run loaded rows")
            require(rt2.n_rows_loaded == rt1.n_rows_encoded > 0
                    and rt2.n_rows_encoded == 0,
                    f"rt-store {precision}: restart loaded "
                    f"{rt2.n_rows_loaded}, encoded {rt2.n_rows_encoded}")
            bits = torch.int16 if t1.dtype == torch.bfloat16 else torch.int32
            require(torch.equal(t1.view(bits), t2.view(bits)),
                    f"rt-store {precision}: the adopted table is not "
                    "bit-exact")
            require(p1 == p2, f"rt-store {precision}: restart predictions "
                    "are not bitwise the cold run's")
            print(f"rt-store {precision}: table {tuple(t1.shape)} "
                  f"{t1.dtype} bit-exact, {len(p1)} per-core predictions "
                  "bitwise equal")
        # a store the port's CPU path writes into the same directory, with
        # the same parameters, config (the bf16 runs' inference config is
        # ``cfg`` itself), l_token and vocab, is not the card's (C1/C2):
        # the card adopts its own bf16 table, the CPU its own rows
        p_cpu = _to(params, "cpu")
        cpu_cache = RTCache(p_cpu, cfg, 16, device="cpu",
                            store_dir=str(store),
                            store_extra=vocab.signature())
        require(cpu_cache.stats.n_rows_loaded == 0,
                "the CPU path adopted a table the card encoded")
        cpu_cache.ensure_rows(mbenches[0].compiled()[0].token_table(vocab,
                                                                    16))
        cpu_cache.persist()
        card = RTCache(params, cfg, 16, device="cuda", store_dir=str(store),
                       store_extra=vocab.signature())
        again = RTCache(p_cpu, cfg, 16, device="cpu", store_dir=str(store),
                        store_extra=vocab.signature())
        print(f"rt-store CPU-written store in the same directory: the card "
              f"loaded {card.stats.n_rows_loaded} rows (its own bf16 "
              f"table: {t1.shape[0]}), the CPU {again.stats.n_rows_loaded} "
              f"(its own: {cpu_cache.n_rows})")
        require(card.stats.n_rows_loaded == t1.shape[0] and torch.equal(
            card.table[:card.n_rows].view(torch.int16), t1.view(torch.int16)),
                "the card did not adopt exactly its own bf16 table")
        require(again.stats.n_rows_loaded == cpu_cache.n_rows,
                "the CPU path did not adopt its own store")
    finally:
        shutil.rmtree(store, ignore_errors=True)


# --------------------------------------------------------------------- #
# the data mesh (EngineConfig.mesh_shape)
# --------------------------------------------------------------------- #

def clip_gap(a, b) -> float:
    """max over clips of |b - a| / |a| (numpy arrays of one length)."""
    require(a.shape == b.shape, f"clip counts differ: {a.shape} {b.shape}")
    return float((abs(b.astype("float64") - a) / abs(a)).max())


def check_mesh(torch, fa_ops, wa_ops):
    """The data mesh at the engine phases' configurations: mesh (1,) on
    cuda:0, then MESH_SHARDS shards on the one card (each on its own
    stream, asked for explicitly), against the unsharded engine on the
    same card, single-core (3 Table II benchmarks, M 360) and multicore
    (4 cores, M 369), fp32 and bf16, unfused and fused, each run with a
    cold RT cache.  Distinct cards where two or more are visible; then
    ``serve.py --mesh 1`` and ``--engine-config``.  Returns the launches
    of every mesh run."""
    import os

    import numpy as np

    from repro_torch.configs.capsim import config
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine import BatchedPredictor
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import multicore, progen
    from repro_torch.launch.mesh import make_data_mesh

    cfg = config()
    vocab = std_mod.build_vocab()
    names = list(progen.TABLE_II)[:BENCHMARKS]
    params = predictor.init_params(cfg, seed=0, device="cuda")
    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    single = EngineConfig(interval_size=20_000, max_checkpoints=1,
                          batch_size=256, with_oracle=True)
    multi = single.replace(interval_size=MULTICORE_INTERVAL)
    print(f"mesh config: E={cfg.d_model} batch={single.batch_size}; "
          f"single-core {names} interval {single.interval_size}; multicore "
          f"x{MULTICORE_CORES} cores interval {multi.interval_size}; "
          f"shards on one card {MESH_SHARDS}; cards visible "
          f"{torch.cuda.device_count()}")
    drained = []                 # each run's per-clip predictions
    drain = BatchedPredictor.drain

    def recording(self):
        out = drain(self)
        drained.append(out)
        return out

    total = [0, 0]

    def run(what, n, mesh_kw, precision, fused, mc, warm=False):
        """One engine run: (results, per-clip predictions, RT table,
        launches, wall s, engine).  ``warm``: the first benchmark only,
        launches not counted (the first use of a GEMM shape or a stream
        loads kernels and workspaces; the timed runs come after)."""
        ec = (multi if mc else single).replace(precision=precision,
                                               fused_serving=fused)
        kw = {}
        if n:
            ec = ec.replace(mesh_shape=(n,))
            kw["mesh"] = make_data_mesh(n, **mesh_kw)
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        drained.clear()
        engine = engine_mod.SimulationEngine(params, cfg, vocab, ec,
                                             device="cuda", **kw)
        t0 = time.perf_counter()
        if mc:
            res = engine.run_multicore(mbenches[:1] if warm else mbenches)
        else:
            engine.submit_names(names[:1] if warm else names)
            res = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa_ops.flash_attention.launches,
                  wa_ops.weighted_attention.launches)
        if not warm:
            total[0] += counts[0]
            total[1] += counts[1]
        require(len(drained) == 1, f"mesh {what}: {len(drained)} drains")
        cache = engine._stack.cache
        table = cache.table[:cache.n_rows].clone()
        return res, drained[0], table, counts, wall, engine

    def same_table(t0, t1) -> bool:
        bits = torch.int16 if t0.dtype == torch.bfloat16 else torch.int32
        return t0.shape == t1.shape and torch.equal(t0.view(bits),
                                                    t1.view(bits))

    def report(what, base, got, n, precision, mc) -> None:
        res0, p0, t0, c0, w0, e0 = base
        res1, p1, t1, c1, w1, e1 = got
        gap = clip_gap(p0, p1)
        bitwise = bool((p0 == p1).all())
        table_ok = same_table(t0, t1)
        n_clips = p0.shape[0]
        print(f"mesh {what}: {n_clips} clips, per-clip max rel "
              f"{gap:.3e} (bitwise {bitwise}), table {tuple(t1.shape)} "
              f"byte-identical {table_ok}; launches flash / weighted "
              f"{c1[0]} / {c1[1]} against {c0[0]} / {c0[1]} unsharded "
              f"({e1.last_stats.n_batches} / {e0.last_stats.n_batches} "
              f"batches); {n_clips / w1:.1f} clips/s, predict "
              f"{e1.last_stats.predict_seconds:.4f} s against "
              f"{n_clips / w0:.1f} clips/s, "
              f"{e0.last_stats.predict_seconds:.4f} s unsharded")
        require(table_ok, f"mesh {what}: the RT table is not byte-"
                "identical (the C2 guarantee of the 4096-row passes)")
        require(e1.last_stats.n_batches == e0.last_stats.n_batches,
                f"mesh {what}: batch counts differ")
        require(c1 == (n * c0[0], n * c0[1]), f"mesh {what}: launches "
                f"{c1} are not {n} x the unsharded {c0}")
        require(e1.last_stats.n_predicted == n_clips
                == e0.last_stats.n_predicted, f"mesh {what}: clips lost")
        if mc:
            for a, b in zip(res0, res1, strict=True):
                for ca, cb in zip(a.cores, b.cores, strict=True):
                    require((ca.name, ca.n_clips, ca.oracle_cycles)
                            == (cb.name, cb.n_clips, cb.oracle_cycles),
                            f"mesh {what}: the demux differs at {ca.name}")
        else:
            for a, b in zip(res0, res1, strict=True):
                require((a.name, a.n_clips, a.oracle_cycles)
                        == (b.name, b.n_clips, b.oracle_cycles),
                        f"mesh {what}: results differ at {a.name}")
        if n == 1:
            require(bitwise, f"mesh {what}: mesh (1,) is not bitwise")
        elif precision == "fp32":
            require(gap <= 1e-6, f"mesh {what}: per-clip gap {gap} > 1e-6")
            worst = 0.0
            for a, b in zip(res0, res1):
                for ca, cb in zip(getattr(a, "cores", [a]),
                                  getattr(b, "cores", [b])):
                    worst = max(worst, abs(cb.predicted_cycles
                                           - ca.predicted_cycles)
                                / abs(ca.predicted_cycles))
            print(f"mesh {what}: max per-{'core' if mc else 'benchmark'} "
                  f"rel {worst:.3e} (limit 1e-6)")
            require(worst <= 1e-6, f"mesh {what}: total gap {worst}")
        else:
            worst = max(abs(b.predicted_cycles - a.predicted_cycles)
                        / abs(a.predicted_cycles)
                        for a, b in zip(res0, res1))
            print(f"mesh {what}: bf16 per-clip max rel {gap:.3e}, per "
                  f"total {worst:.3e} (the bf16-vs-fp32 gate: 1e-2)")
            require(worst <= 1e-2 and gap <= 1e-2,
                    f"mesh {what}: bf16 gap {gap} / {worst} > 1e-2")

    BatchedPredictor.drain = recording
    try:
        for mc in (False, True):
            for precision in ("fp32", "bf16"):
                for fused in (False, True):
                    for n in (0, 1, *MESH_SHARDS):
                        run("warm-up", n, dict(device="cuda:0",
                                               on_one_device=True),
                            precision, fused, mc, warm=True)
        for mc in (False, True):
            for precision in ("fp32", "bf16"):
                for fused in (False, True):
                    tag = (f"{'multicore' if mc else 'single-core'} "
                           f"{precision} fused={fused}")
                    base = run(tag, 0, {}, precision, fused, mc)
                    shards = ((1, *MESH_SHARDS) if not mc else MESH_SHARDS)
                    for n in shards:
                        got = run(tag, n, dict(device="cuda:0",
                                               on_one_device=True),
                                  precision, fused, mc)
                        report(f"({n},) one card {tag}", base, got, n,
                               precision, mc)
                    cards = torch.cuda.device_count()
                    for n in MESH_SHARDS:
                        if n > cards:
                            continue
                        got = run(tag, n, dict(device="cuda"), precision,
                                  fused, mc)
                        report(f"({n},) {n} cards {tag}", base, got, n,
                               precision, mc)
        if torch.cuda.device_count() < 2:
            print(f"mesh distinct cards: not run, "
                  f"{torch.cuda.device_count()} card visible")
    finally:
        BatchedPredictor.drain = drain

    # a pool of 3 clips on 4 shards: padded to a full set of shards (the
    # bucket floor 8), the pads dropped
    rng = np.random.RandomState(0)
    tok = rng.randint(0, vocab.size, (3, 128, cfg.clip_tokens)).astype(
        np.int32)
    ctx = rng.randint(0, vocab.size, (3, cfg.context_tokens)).astype(
        np.int32)
    mask = np.ones((3, 128), np.float32)
    preds = []
    for n in (0, 4):
        ec = EngineConfig(batch_size=256, rt_cache=False,
                          mesh_shape=(n,) if n else ())
        kw = ({"mesh": make_data_mesh(n, "cuda:0", on_one_device=True)}
              if n else {})
        fa_ops.flash_attention.launches = 0
        bp = BatchedPredictor(params, cfg, config=ec, device="cuda", **kw)
        bp.add(tok, ctx, mask)
        preds.append(bp.drain())
        total[0] += fa_ops.flash_attention.launches
        require(preds[-1].shape == (3,) and bp.stats.n_pad == 5,
                f"mesh pool of 3 on {n} shards: {preds[-1].shape}, "
                f"{bp.stats.n_pad} pads")
    gap = clip_gap(preds[0], preds[1])
    print(f"mesh pool of 3 clips on 4 shards: 5 pad rows dropped, per-clip "
          f"max rel {gap:.3e} against unsharded")
    require(gap <= 1e-6, f"mesh pool of 3: gap {gap}")

    # the launcher: --mesh 1 on the card, and --engine-config with it
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for extra in (["--mesh", "1"],
                  ["--engine-config", '{"mesh_shape": [1]}',
                   "--fused-serving"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
               "cuda", "--n-benchmarks", str(BENCHMARKS), *extra]
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("served ")]
        print(f"mesh serve {' '.join(extra)}: rc {out.returncode}; "
              f"{lines[-1] if lines else out.stderr[-2000:]}")
        require(out.returncode == 0 and lines
                and "over a 1-shard mesh on cuda" in lines[-1],
                f"serve {' '.join(extra)} failed")
    return {"flash_attention": total[0], "weighted_attention": total[1]}


# --------------------------------------------------------------------- #
# sampled simulation (the analytical-ML fusion path)
# --------------------------------------------------------------------- #

def counted(fa_ops, wa_ops, fn):
    """``fn()`` with both attention launch counters set to 0 just before
    and read just after: (its result, (flash, weighted) launches)."""
    fa_ops.flash_attention.launches = 0
    wa_ops.weighted_attention.launches = 0
    out = fn()
    return out, (fa_ops.flash_attention.launches,
                 wa_ops.weighted_attention.launches)


def sampling_config(fraction: float):
    from repro_torch.core.engine_config import SamplingConfig
    return SamplingConfig(**dict(SAMPLING, fraction=fraction))


def check_sampling(torch, fa_ops, wa_ops):
    """``EngineConfig.sampling`` at the paper model's full width, fp32,
    batch 256.  Single-core, the first 3 Table II benchmarks at up to
    SAMPLING_CHECKPOINTS checkpoints (502.gcc has 1): fraction=1.0
    bitwise the unsampled run, unfused and fused; fraction=0.08 reported
    per benchmark (clips predicted / extrapolated, CI, error against the
    unsampled total, clips/s), and on the CPU for one benchmark (the same
    sample, <= 1e-4).  Multicore, the 4 mt benchmarks x 4 cores, one
    checkpoint: fraction=1.0 bitwise per core, fraction=0.08 reported.
    Returns the (flash, weighted) launches of the card runs."""
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import multicore, progen

    cfg = config()
    vocab = std_mod.build_vocab()
    names = list(progen.TABLE_II)[:BENCHMARKS]
    params = predictor.init_params(cfg, seed=0, device="cuda")
    base = EngineConfig(precision="fp32", interval_size=20_000,
                        max_checkpoints=SAMPLING_CHECKPOINTS, batch_size=256,
                        with_oracle=False)
    launches = [0, 0]

    def run(what, config, device="cuda", multi=None):
        def go():
            if multi is not None:
                return run_multicore(torch, params, cfg, vocab, multi,
                                     config, device)
            return run_engine(torch, params, cfg, vocab,
                              names if device == "cuda" else names[:1],
                              config, device)
        (res, wall, eng), counts = counted(fa_ops, wa_ops, go)
        st, fe = eng.last_stats, eng.frontend_stats
        n_clips = sum(r.n_clips for r in res)
        n_pred = sum(r.clips_predicted for r in res)
        print(f"sampling {what} on {device}: {n_clips} clips, {n_pred} "
              f"predicted and {n_clips - n_pred} extrapolated, in "
              f"{wall:.3f} s = {n_clips / wall:.1f} clips/s; front-end "
              f"{fe.frontend_seconds:.3f} s (interpret "
              f"{fe.interpret_seconds:.3f}, tokenize "
              f"{fe.tokenize_seconds:.3f}, context "
              f"{fe.context_seconds:.3f}, analytical features "
              f"{fe.analytical_seconds:.3f}); predict "
              f"{st.predict_seconds:.3f} s, {st.n_batches} batches; "
              f"launches flash={counts[0]} weighted={counts[1]}")
        if device == "cuda":
            fused = config.fused_serving
            require(counts[0] > 0 and (counts[1] > 0) == fused,
                    f"sampling {what}: launches {counts}")
            launches[0] += counts[0]
            launches[1] += counts[1]
        require(all(math.isfinite(r.predicted_cycles) for r in res),
                f"sampling {what}: non-finite prediction")
        return res, wall

    print(f"sampling config: E={cfg.d_model} fp32 batch 256, benchmarks "
          f"{names} at up to {SAMPLING_CHECKPOINTS} checkpoints of 20,000 "
          f"instructions; {SAMPLING}")
    full = {}
    for fused in (False, True):
        ec = base.replace(fused_serving=fused)
        full[fused], full_wall = run(f"unsampled fused={fused}", ec)
        one, _ = run(f"fraction=1.0 fused={fused}",
                     ec.replace(sampling=sampling_config(1.0)))
        for a, b in zip(full[fused], one, strict=True):
            require(b.predicted_cycles == a.predicted_cycles
                    and b.clips_extrapolated == 0,
                    f"sampling fraction=1.0 fused={fused} {a.name}: "
                    f"{b.predicted_cycles!r} != {a.predicted_cycles!r}")
        print(f"sampling fraction=1.0 fused={fused}: predicted cycles "
              f"bitwise the unsampled run's for {len(one)} benchmarks")
        if not fused:
            unsampled_wall = full_wall
    sampled, wall = run("fraction=0.08", base.replace(
        sampling=sampling_config(SAMPLING["fraction"])))
    for a, r in zip(full[False], sampled, strict=True):
        lo, hi = r.cycles_ci
        err = (r.predicted_cycles - a.predicted_cycles) / a.predicted_cycles
        print(f"  {r.name:16s} clips={r.n_clips} predicted="
              f"{r.clips_predicted} extrapolated={r.clips_extrapolated} "
              f"estimate={r.predicted_cycles!r} CI=[{lo!r}, {hi!r}] "
              f"(width {(hi - lo) / r.predicted_cycles:.3e}) unsampled="
              f"{a.predicted_cycles!r} error {err:+.3e} unsampled in CI "
              f"{lo <= a.predicted_cycles <= hi}")
        require(0 < r.clips_predicted < r.n_clips and lo <= r.predicted_cycles
                <= hi, f"sampling {r.name}: report {r.cycles_ci}")
    n_clips = sum(r.n_clips for r in sampled)
    print(f"sampling fraction=0.08: {n_clips / wall:.1f} clips/s against "
          f"the unsampled run's {n_clips / unsampled_wall:.1f}")
    cpu, _ = run("fraction=0.08", base.replace(
        sampling=sampling_config(SAMPLING["fraction"])), device="cpu")
    a, b = sampled[0], cpu[0]
    require(bool((a.clip_provenance == b.clip_provenance).all()),
            f"sampling card vs CPU {a.name}: different samples")
    rel = max(abs(y - x) / abs(x) for x, y in
              zip((a.predicted_cycles, *a.cycles_ci),
                  (b.predicted_cycles, *b.cycles_ci)))
    print(f"sampling card vs CPU {a.name}: the same {a.clips_predicted} "
          f"clips sampled; estimate and CI rel {rel:.3e} (limit 1e-4)")
    require(rel <= 1e-4, f"sampling card vs CPU rel {rel}")

    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    mbase = base.replace(interval_size=MULTICORE_INTERVAL, max_checkpoints=1)
    mfull, mwall = run("multicore unsampled", mbase, multi=mbenches)
    mone, _ = run("multicore fraction=1.0",
                  mbase.replace(sampling=sampling_config(1.0)),
                  multi=mbenches)
    for a, b in zip(mfull, mone, strict=True):
        for ca, cb in zip(a.cores, b.cores, strict=True):
            require(cb.predicted_cycles == ca.predicted_cycles,
                    f"sampling multicore fraction=1.0 {ca.name}: "
                    f"{cb.predicted_cycles!r} != {ca.predicted_cycles!r}")
    print(f"sampling multicore fraction=1.0: every one of "
          f"{sum(len(r.cores) for r in mone)} cores bitwise the unsampled "
          "run's (one checkpoint: each core's clips are one segment)")
    msampled, wall = run("multicore fraction=0.08", mbase.replace(
        sampling=sampling_config(SAMPLING["fraction"])), multi=mbenches)
    for a, r in zip(mfull, msampled, strict=True):
        lo, hi = r.cycles_ci
        err = (r.predicted_cycles - a.predicted_cycles) / a.predicted_cycles
        print(f"  {r.name:16s} x{r.n_cores} clips={r.n_clips} predicted="
              f"{r.clips_predicted} extrapolated={r.clips_extrapolated} "
              f"estimate={r.predicted_cycles!r} CI=[{lo!r}, {hi!r}] "
              f"unsampled={a.predicted_cycles!r} error {err:+.3e} "
              f"unsampled in CI {lo <= a.predicted_cycles <= hi}")
    n_clips = sum(r.n_clips for r in msampled)
    print(f"sampling multicore fraction=0.08: {n_clips / wall:.1f} clips/s "
          f"against the unsampled run's {n_clips / mwall:.1f}")
    return {"flash_attention": launches[0],
            "weighted_attention": launches[1]}


# --------------------------------------------------------------------- #
# the fault-tolerant SimulationService
# --------------------------------------------------------------------- #

def service_requests(ds, n: int):
    """The dataset's clips split into ``n`` equal requests."""
    from repro_torch.serving import Request
    per = max(1, len(ds) // n)
    return [Request(i, ds.clip_tokens[i * per:(i + 1) * per],
                    ds.context_tokens[i * per:(i + 1) * per],
                    ds.clip_mask[i * per:(i + 1) * per]) for i in range(n)]


def check_service(torch, fa_ops, wa_ops):
    """``SimulationService`` at the paper model's full width (fp32
    reference, batch 256) over requests built with ``build_dataset`` from
    the first 3 Table II benchmarks.  Healthy: every ticket ok at
    fused_int8, clips/s and p50/p99 latency, each rung's spot check
    against the monolithic fp32 reference within its gate (rt: C2; the
    int8 rung also against the port's CPU int8 path).
    Chaos: nan_output/device_error/slow_flush, every ticket typed, a
    demotion, a re-promotion and an abandoned flush seen, every served
    total within its rung's gate against a monolithic fp32 replay.
    Store: a corrupt read cold-encodes to the same totals, and the
    previous generation survives a crashed persist.  Returns the
    (flash, weighted) launches of the healthy and chaos runs and the U of
    the healthy run's fused batches."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    import numpy as np

    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.data.dataset import BuildConfig, build_dataset
    from repro_torch.isa import progen
    from repro_torch.serving import (PredictorEngine, ServiceSLA,
                                     SimulationService)
    from repro_torch.serving.service import STATUSES, _QueuedRequest

    cfg = config().replace(dtype="float32")   # the ladder's fp32 rungs
    vocab = std_mod.build_vocab()
    params = predictor.init_params(cfg, seed=0, device="cuda")
    names = list(progen.TABLE_II)[:BENCHMARKS]
    base = EngineConfig(batch_size=256)
    t0 = time.perf_counter()
    bcfg = BuildConfig(interval_size=20_000, warmup=0,
                       max_checkpoints=SERVICE_CHECKPOINTS, sample=False)
    ds = build_dataset(names, bcfg, vocab)
    reqs = service_requests(ds, SERVICE_REQUESTS)
    print(f"service config: E={cfg.d_model} fp32 reference, batch 256; "
          f"{len(ds)} clips of {names} (build_dataset, up to "
          f"{SERVICE_CHECKPOINTS} checkpoints, every sliced clip kept, "
          f"{time.perf_counter() - t0:.1f} s) in {SERVICE_REQUESTS} "
          f"requests of {reqs[0].clip_mask.shape[0]} clips")
    launches = [0, 0]
    seen_u = {}
    dedupe = std_mod.dedupe_context_tokens

    def recording(ctx, *a, **kw):
        uniq, counts = dedupe(ctx, *a, **kw)
        seen_u[uniq.shape[1]] = seen_u.get(uniq.shape[1], 0) + 1
        return uniq, counts

    # healthy: one burst of every request
    sla = ServiceSLA(default_deadline_s=120.0, watchdog_s=10.0,
                     check_clips=64)
    svc = SimulationService(params, cfg, base, sla=sla, device="cuda")
    svc.prewarm(reqs[0])

    def burst():
        with svc:
            t = time.perf_counter()
            tickets = [svc.submit(r) for r in reqs]
            out = [tk.result(timeout=300) for tk in tickets]
            return out, time.perf_counter() - t
    std_mod.dedupe_context_tokens = recording
    try:
        (results, wall), counts = counted(fa_ops, wa_ops, burst)
    finally:
        std_mod.dedupe_context_tokens = dedupe
    launches = [launches[0] + counts[0], launches[1] + counts[1]]
    require(all(r.status == "ok" and r.tier == "fused_int8" for r in results),
            "service healthy: " + str({r.status for r in results}))
    lat = [r.latency_seconds for r in results]
    clips = sum(r.n_clips for r in results)
    print(f"service healthy: {len(results)} requests, {clips} clips in "
          f"{wall:.3f} s = {clips / wall:.1f} clips/s; latency p50 "
          f"{1e3 * np.percentile(lat, 50):.1f} ms, p99 "
          f"{1e3 * np.percentile(lat, 99):.1f} ms; "
          f"{svc.stats()['n_flushes']} flushes; fused U "
          f"{dict(sorted(seen_u.items()))}; launches flash={counts[0]} "
          f"weighted={counts[1]}")
    require(counts[0] > 0 and counts[1] > 0,
            f"service healthy: launches {counts}")
    qr = _QueuedRequest(req=reqs[1], ticket=None, arrival=0.0, deadline=0.0)
    k = sla.check_clips
    check = dataclasses.replace(reqs[1], clip_tokens=reqs[1].clip_tokens[:k],
                                context_tokens=reqs[1].context_tokens[:k],
                                clip_mask=reqs[1].clip_mask[:k])

    def tier_times(tier):
        with torch.inference_mode():
            b = tier.backend()
            b.reset_context_width()
            b.add(check.clip_tokens, check.context_tokens, check.clip_mask)
            return b.drain()
    want = float(tier_times(svc._reference).sum())
    for tier, name in zip(svc._tiers[:-1],
                          (s.name for s in svc.tier_stats)):
        err = svc._spot_check(tier, [qr])
        times = tier_times(tier)
        total = abs(float(times.sum()) - want) / abs(want)
        gate = SERVICE_GATES[name]
        print(f"service spot check {name} vs monolithic fp32 ({k} "
              f"clips): max rel per clip {err!r} (gate {gate:g}), rel of "
              f"the total {total!r}")
        require(err is not None and err <= gate,
                f"service spot check {name}: {err} > {gate}")
        if name == "fused_int8":
            # the quantized model's own error depends on the parameters;
            # what the port must hold is its CPU int8 path
            cpu = PredictorEngine(params, cfg, tier.config, device="cpu")
            cpu.submit(check)
            cpu_total = cpu.flush()[0].total_cycles
            rel = abs(float(times.sum()) - cpu_total) / abs(cpu_total)
            print(f"service fused_int8 card vs the port's CPU int8 path "
                  f"({k} clips): total rel {rel!r} (limit 1e-4)")
            require(rel <= 1e-4, f"service fused_int8 card vs CPU {rel}")
    print(f"c2 held: the rt rung against the monolithic one on the card "
          f"{svc._spot_check(svc._tiers[2], [qr])!r}")

    # chaos: one request at a time, so every flush draws its faults
    creqs = service_requests(ds, 2 * SERVICE_REQUESTS)
    csla = ServiceSLA(default_deadline_s=120.0, watchdog_s=1.0,
                      check_every=4, check_clips=64, promote_after=1,
                      backoff_max=4)
    svc = SimulationService(params, cfg, base.replace(
        faults=CHAOS_FAULTS, fault_seed=CHAOS_SEED), sla=csla, device="cuda")
    svc.prewarm(creqs[0])

    def closed_loop():
        with svc:
            t = time.perf_counter()
            out = [svc.submit(r).result(timeout=120) for r in creqs]
            return out, time.perf_counter() - t
    (results, wall), counts = counted(fa_ops, wa_ops, closed_loop)
    launches = [launches[0] + counts[0], launches[1] + counts[1]]
    st = svc.stats()
    alive = svc.join_abandoned(timeout=60)
    tiers = st["tiers"]
    demotions = sum(t["demotions"] for t in tiers.values())
    promotions = sum(t["promotions"] for t in tiers.values())
    print(f"service chaos {CHAOS_FAULTS} seed {CHAOS_SEED}, watchdog "
          f"{csla.watchdog_s} s: {len(results)} requests in {wall:.3f} s; "
          f"{st['statuses']}; faults fired {st['faults_fired']}; demotions "
          f"{demotions}, promotions {promotions}, flush threads abandoned "
          f"{st['abandoned_flush_threads_total']} ({alive} alive after the "
          f"join); launches flash={counts[0]} weighted={counts[1]}")
    for name, t in tiers.items():
        print(f"  tier {name}: " + ", ".join(
            f"{k} {v}" for k, v in t.items() if k != "name" and v))
    require(all(r.status in STATUSES for r in results),
            "service chaos: an untyped result")
    require(demotions >= 1 and promotions >= 1,
            f"service chaos: demotions {demotions} promotions {promotions}")
    require(st["abandoned_flush_threads_total"] >= 1 and alive == 0,
            "service chaos: no flush thread abandoned, or one still alive")
    ref = PredictorEngine(params, cfg, base.replace(rt_cache=False),
                          device="cuda")
    worst = {}
    for r, q in zip(results, creqs, strict=True):
        if not r.ok:
            continue
        ref.submit(q)
        want = ref.flush()[0].total_cycles
        rel = abs(r.total_cycles - want) / abs(want)
        worst[r.tier] = max(worst.get(r.tier, 0.0), rel)
        require(rel <= SERVICE_GATES[r.tier], f"service chaos request "
                f"{r.request_id} at {r.tier}: rel {rel} against the "
                "monolithic replay")
    print("service chaos: served totals against a monolithic fp32 replay, "
          "max rel per rung " + ", ".join(
              f"{k} {v!r} (gate {SERVICE_GATES[k]:g})"
              for k, v in worst.items()))

    # the RT store under corrupt reads and crashed persists
    store = Path(tempfile.mkdtemp(prefix="svc_store_", dir=ROOT / "build"))
    try:
        def serve(faults, requests):
            svc = SimulationService(
                params, cfg, base.replace(rt_store_dir=str(store),
                                          faults=faults),
                sla=ServiceSLA(check_every=0), device="cuda")
            loaded = svc._tiers[0].cache.stats.n_rows_loaded
            with svc:
                out = [svc.submit(r).result(timeout=120) for r in requests]
            require(all(r.status == "ok" for r in out),
                    f"service store {faults}: {[r.status for r in out]}")
            return svc, loaded, [r.total_cycles for r in out]
        clean, loaded, want = serve({}, reqs[:4])
        table = clean._tiers[0].cache.table[:clean._tiers[0].cache.n_rows]
        require(loaded == 0, "service store: the first run loaded rows")
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            bad, loaded, got = serve({"corrupt_rt_read": 1.0}, reqs[:4])
        fired = bad.injector.stats().get("corrupt_rt_read", 0)
        print(f"service store corrupt_rt_read: fired {fired}, rows loaded "
              f"{loaded}, {len(warned)} warnings, totals bitwise the clean "
              f"run's {got == want}")
        require(fired >= 1 and loaded == 0 and warned and got == want,
                "service store: a corrupt read did not cold-encode to the "
                "same totals")
        extra = build_dataset(
            list(progen.TABLE_II)[BENCHMARKS:BENCHMARKS + 1],
            dataclasses.replace(bcfg, max_checkpoints=1), vocab)
        crash, loaded, _ = serve({"crash_persist": 1.0},
                                 service_requests(extra, 2))
        failures = crash.stats()["tiers"]["fused_int8"]["persist_failures"]
        after = SimulationService(params, cfg, base.replace(
            rt_store_dir=str(store)), device="cuda")._tiers[0].cache
        kept = after.table[:after.n_rows]
        print(f"service store crash_persist: {loaded} rows loaded, "
              f"{crash._tiers[0].cache.n_rows} after growing, persist "
              f"failures {failures}; a restart loads {after.n_rows} rows, "
              f"bit-exact the previous generation "
              f"{torch.equal(kept, table)}")
        require(loaded == table.shape[0] and failures >= 1
                and crash._tiers[0].cache.n_rows > loaded
                and torch.equal(kept, table),
                "service store: a crashed persist lost the previous "
                "generation")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return {"flash_attention": launches[0],
            "weighted_attention": launches[1]}, seen_u


# --------------------------------------------------------------------- #
# Mamba2 LM
# --------------------------------------------------------------------- #

def cast_params(params, specs, dtype):
    """Cast every parameter whose spec has no dtype of its own (the
    reference's fp32 norms, A_log, dt_bias and D stay float32)."""
    if not isinstance(specs, dict):
        return params if specs.dtype else params.to(dtype)
    return {k: cast_params(params[k], specs[k], dtype) for k in params}


def live_rel(a, b, vocab: int) -> float:
    """max |a - b| / max |b| over the real vocab columns."""
    return rel_err(a[..., :vocab], b[..., :vocab])


def check_mamba2(torch, fa_ops, wa_ops, ssd_ops):
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    cfg = get_config("mamba2-780m")
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = tfm.init_params(f32, seed=0, device="cuda")
    params16 = cast_params(params, tfm.model_specs(cfg), torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"mamba2 config: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"ssd_heads={cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim} "
          f"head_dim={cfg.ssm_head_dim} d_state={cfg.ssm_state} chunk="
          f"{cfg.ssm_chunk} vocab={V} padded={tfm.padded_vocab(cfg)} "
          f"params={n_params} (init {time.perf_counter() - t0:.1f} s); "
          f"batch {MAMBA2_BATCH} x {MAMBA2_PROMPT} tokens + "
          f"{MAMBA2_DECODE} decode steps")
    shape = ShapeConfig("prefill_4k", MAMBA2_PROMPT, MAMBA2_BATCH,
                        "prefill")
    batch = random_batch(cfg, shape, "prefill", seed=0, device="cuda")
    # warm-up (cuBLAS handles, lazy modules), not counted
    generate(params, f32, {"tokens": batch["tokens"][:1, :256]}, 1)

    fa_ops.flash_attention.launches = 0
    wa_ops.weighted_attention.launches = 0
    ssd_ops.ssd_scan.launches = 0
    runs, peaks = {}, {}
    for dtype, p, c in (("float32", params, f32),
                        ("bfloat16", params16, cfg)):
        torch.cuda.reset_peak_memory_stats()
        runs[dtype] = generate(p, c, batch, MAMBA2_DECODE)
        peaks[dtype] = torch.cuda.max_memory_allocated() / 2**30
    launches = ssd_ops.ssd_scan.launches
    print(f"mamba2 launches: ssd={launches} flash="
          f"{fa_ops.flash_attention.launches} weighted="
          f"{wa_ops.weighted_attention.launches}")
    require(launches == 2 * cfg.num_layers,
            f"mamba2: {launches} SSD launches, expected {cfg.num_layers} "
            "per prefill")
    for dtype, g in runs.items():
        n_tok = MAMBA2_BATCH * MAMBA2_PROMPT
        print(f"mamba2 {dtype}: prefill {g.prefill_seconds:.4f} s = "
              f"{n_tok / g.prefill_seconds:.1f} tokens/s; decode "
              f"{1e3 * g.decode_seconds / MAMBA2_DECODE:.3f} ms/step "
              f"(batch {MAMBA2_BATCH}); peak memory {peaks[dtype]:.2f} GiB "
              f"(f32 and bf16 parameters included); first tokens "
              f"{g.tokens[0, :6].tolist()}")
        require(bool(torch.isfinite(g.logits.float()).all()),
                f"mamba2 {dtype}: non-finite logits")
        require(int(g.tokens.max()) < V,
                f"mamba2 {dtype}: decoded a padded vocab column")
    gap = float((runs["bfloat16"].logits[:, 0, :V].float()
                 - runs["float32"].logits[:, 0, :V]).norm()
                / runs["float32"].logits[:, 0, :V].norm())
    agree = float((runs["bfloat16"].tokens == runs["float32"].tokens)
                  .float().mean())
    print(f"mamba2 bf16 vs f32: prefill last-row logits relative norm "
          f"{gap:.3e} (reported, not gated); greedy tokens agree "
          f"{agree:.3f}")

    # where the device time goes: one prefill and one decode step per
    # dtype under the profiler (after the counted runs)
    for dtype, p, c in (("float32", params, f32),
                        ("bfloat16", params16, cfg)):
        (_, cache), *prof = device_profile(
            torch, lambda: tfm.prefill_step(p, batch, c))
        print_profile(f"mamba2 {dtype} prefill", *prof)
        _, *prof = device_profile(torch, lambda: tfm.decode_step(
            p, {"tokens": runs[dtype].tokens[:, :1]}, c, cache,
            MAMBA2_PROMPT))
        print_profile(f"mamba2 {dtype} decode step", *prof)
        del cache

    # card vs the port's CPU plain path, and prefill vs decode, on a
    # 2-layer model at full width in f32
    two = f32.replace(num_layers=2)
    p_cpu = tfm.init_params(two, seed=1, device="cpu")
    p_card = _to(p_cpu, "cuda")
    tok = torch.randint(0, V, (1, 512),
                        generator=torch.Generator().manual_seed(1))
    card = generate(p_card, two, {"tokens": tok[:, :511]}, 2, device="cuda")
    cpu = generate(p_cpu, two, {"tokens": tok[:, :511]}, 2, device="cpu")
    rel = live_rel(card.logits.cpu(), cpu.logits, V)
    full_card, _ = tfm.prefill_step(p_card, {"tokens": tok[:, :511].cuda()},
                                    two)
    full_cpu, _ = tfm.prefill_step(p_cpu, {"tokens": tok[:, :511]}, two)
    rel_full = live_rel(full_card.cpu(), full_cpu, V)
    print(f"mamba2 card vs CPU (2 layers, prompt 511 + 2 decode steps): "
          f"step logits rel {rel:.3e}, prefill logits rel {rel_full:.3e}, "
          f"tokens equal {torch.equal(card.tokens.cpu(), cpu.tokens)}")
    require(rel <= 1e-4 and rel_full <= 1e-4,
            f"mamba2 card vs CPU rel {rel} / {rel_full}")
    long, _ = tfm.prefill_step(p_card, {"tokens": tok.cuda()}, two)
    _, cache = tfm.prefill_step(p_card, {"tokens": tok[:, :511].cuda()}, two)
    step, _ = tfm.decode_step(p_card, {"tokens": tok[:, 511:].cuda()}, two,
                              cache, 511)
    rel_pd = live_rel(step[:, 0], long[:, -1], V)
    print(f"mamba2 prefill(511) + decode vs prefill(512) last row: rel "
          f"{rel_pd:.3e}")
    require(rel_pd <= 1e-4, f"mamba2 prefill vs decode rel {rel_pd}")
    return launches


def rel_norm(a, b) -> float:
    """|a - b| / |b| (Frobenius), in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_mamba2_bf16(torch):
    """bf16 Mamba2 on the card held to the port's CPU bf16 path: the same
    seeded bf16 parameters, cut to MAMBA2_GATE_LAYERS layers at full
    width, one prefill of MAMBA2_GATE_PROMPT tokens (a ragged second SSD
    chunk).  Gated as the CPU test gates the port against JAX: the last
    row's logits on the card lie within half of the port's own bf16-vs-
    f32 gap (on the CPU) of the CPU's, and each layer fed the CPU's input
    stays within 1e-3 (relative norm) of the CPU's output.  The
    parameters are the ones the gate was set on (C4): drawn from a CPU
    generator in sorted key order (``layers.init_from_specs``, the LM
    zoo's init before its counter hash).  On the counter hash's draw of
    the same seed layer 0 reads 1.028e-3, 0.990e-3 of it with the SSD
    scan's plain version on the card (``tools/mamba2_bf16_probe.py
    --init hash``): cuBLAS's bf16 products, not the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_from_specs

    cfg = get_config("mamba2-780m").replace(num_layers=MAMBA2_GATE_LAYERS)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    p32 = init_from_specs(tfm.model_specs(f32), torch.Generator().manual_seed(
        2), "float32", torch.device("cpu"))
    p16 = cast_params(p32, tfm.model_specs(cfg), torch.bfloat16)
    p16_card, p32_card = _to(p16, "cuda"), _to(p32, "cuda")
    tok = torch.randint(0, V, (MAMBA2_GATE_BATCH, MAMBA2_GATE_PROMPT),
                        generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()

    def last(p, c, device):
        logits, _ = tfm.prefill_step(p, {"tokens": tok.to(device)}, c)
        return logits[:, -1, :V].float().cpu()
    card16, card32 = last(p16_card, cfg, "cuda"), last(p32_card, f32, "cuda")
    cpu16, cpu32 = last(p16, cfg, "cpu"), last(p32, f32, "cpu")
    gap_cpu, gap_card = rel_norm(cpu16, cpu32), rel_norm(card16, card32)
    d = rel_norm(card16, cpu16)
    # each layer fed the CPU's input
    x = tfm._embed_tokens(p16, tok, cfg)
    per_layer = []
    for r in range(cfg.num_layers):
        y_cpu, *_ = tfm._block_forward(tfm._index(p16["blocks"], r)["i0"], x,
                                      cfg, "prefill", None)
        y_card, *_ = tfm._block_forward(
            tfm._index(p16_card["blocks"], r)["i0"], x.cuda(), cfg,
            "prefill", None)
        per_layer.append(rel_norm(y_card.cpu(), y_cpu))
        x = y_cpu
    print(f"mamba2 bf16 gate ({cfg.num_layers} layers at full width, "
          f"B={MAMBA2_GATE_BATCH} x {MAMBA2_GATE_PROMPT} tokens, "
          f"{time.perf_counter() - t0:.1f} s): last-row logits card vs CPU "
          f"{d:.3e}; the port's bf16 vs f32 gap on the CPU {gap_cpu:.3e} "
          f"(on the card {gap_card:.3e}); per layer fed the CPU's input "
          f"max {max(per_layer):.3e} (" + ", ".join(
              f"{v:.2e}" for v in per_layer) + ")")
    require(d < 0.5 * gap_cpu, f"mamba2 bf16 card vs CPU {d} >= half of "
            f"the bf16 vs f32 gap {gap_cpu}")
    require(max(per_layer) <= 1e-3, f"mamba2 bf16 per layer "
            f"{max(per_layer)} > 1e-3")


def check_mamba2_bf16_zoo(torch, ssd_ops):
    """The bf16 SSD kernel on the parameters the LM zoo runs (C6): the
    same model, batch and prompt as ``check_mamba2_bf16``, drawn by
    ``transformer.init_params`` (the counter hash of seed 2).  Each layer
    is fed the CPU's bf16 input and run on the card twice, with the SSD
    kernel and with the SSD scan's plain version in its place (the same
    cuBLAS products); the two outputs must lie within half of the port's
    bf16-vs-f32 gap at that layer (on the CPU, the f32 layer fed the
    same input), as ``check_dense_cpu`` holds the flash kernel.  Card vs
    CPU per layer, with the kernel and with the plain version, is printed
    beside it (layer 0 read 1.028e-3 and 0.990e-3 on this draw): the C4
    gate's 1e-3 holds the draw it was set on."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config("mamba2-780m").replace(num_layers=MAMBA2_GATE_LAYERS)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    p16_card = tfm.init_params(cfg, seed=2, device="cuda")
    p16 = _to(p16_card, "cpu")
    p32 = _to(tfm.init_params(f32, seed=2, device="cuda"), "cpu")
    tok = torch.randint(0, cfg.vocab_size,
                        (MAMBA2_GATE_BATCH, MAMBA2_GATE_PROMPT),
                        generator=torch.Generator().manual_seed(2))

    def layer(params, r, x, c):
        y, *_ = tfm._block_forward(tfm._index(params["blocks"], r)["i0"], x,
                                   c, "prefill", None)
        return y.cpu()
    x = tfm._embed_tokens(p16, tok, cfg)
    rows = []
    kernel = ssd_ops.ssd_scan
    for r in range(cfg.num_layers):
        y_card = layer(p16_card, r, x.cuda(), cfg)
        ssd_ops.ssd_scan = ssd_ops.ssd_scan_plain
        try:
            y_plain = layer(p16_card, r, x.cuda(), cfg)
        finally:
            ssd_ops.ssd_scan = kernel
        y_cpu = layer(p16, r, x, cfg)
        gap = rel_norm(y_cpu, layer(p32, r, x.float(), f32))
        rows.append((rel_norm(y_card, y_plain), gap,
                     rel_norm(y_card, y_cpu), rel_norm(y_plain, y_cpu)))
        x = y_cpu
    print(f"mamba2 bf16 zoo-draw gate ({cfg.num_layers} layers at full "
          f"width, transformer.init_params seed 2, B={MAMBA2_GATE_BATCH} x "
          f"{MAMBA2_GATE_PROMPT} tokens, {time.perf_counter() - t0:.1f} s): "
          "per layer fed the CPU's input, SSD kernel vs its plain version "
          "on the card / the port's bf16-vs-f32 gap on the CPU; card vs "
          "CPU with the kernel / with the plain version (reported): "
          + ", ".join(f"{i}: {k:.2e}/{g:.2e}; {c:.3e}/{p:.3e}"
                      for i, (k, g, c, p) in enumerate(rows)))
    for i, (k, g, _, _) in enumerate(rows):
        require(k < 0.5 * g, f"mamba2 bf16 zoo draw layer {i}: SSD kernel "
                f"vs its plain version on the card {k} >= half of the bf16 "
                f"vs f32 gap {g}")


# --------------------------------------------------------------------- #
# the LM zoo's dense decoders
# --------------------------------------------------------------------- #

def print_d128_ptxas(build) -> None:
    """Registers and spills of every head-dim-128 instantiation of the
    attention kernels, from nvcc's ``-Xptxas -v`` log of the last build
    (the causal dense prefill runs flash on D=128)."""
    for lib in ("flash_attention", "weighted_attention"):
        log = build.BUILD_DIR / f"{lib}.log"
        if not log.is_file():
            print(f"ptxas {lib}: no build log")
            continue
        name, seen = None, {}
        for line in log.read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(_Z\w+)", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                seen.setdefault(name, {})["spills"] = m.group(1, 2)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                seen.setdefault(name, {})["registers"] = m.group(1)
        for fn, info in sorted(seen.items()):
            found = kernel_label(fn)
            if found is None or not found[2] or found[2][0] != 128:
                continue
            stores, loads = info.get("spills", ("?", "?"))
            print(f"ptxas {lib} {found[0]}: registers "
                  f"{info.get('registers', '?')}, spill stores {stores} B, "
                  f"spill loads {loads} B")


def time_dense_flash(torch, fa_ops, launches):
    """Causal flash at the dense prefills' shapes, both dtypes: kernel
    (events and profiler), plain version, SDPA with ``is_causal=True``
    (a yardstick the port never calls) and the causal bound.  ``launches``
    {label: flash launches per prefill on the dense path}."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(7)
    rows = []
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for (label, B, S, H, D) in FA_DENSE:
            q, k, v = make_qkv(torch, gen, B, S, S, H, D, tdt)
            qt, kt, vt = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
            row = {
                "shape": label, "dtype": dtype,
                "launches_per_prefill": launches[label],
                "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                    q, k, v, causal=True), iters=10),
                "device_ms": device_ms(torch, lambda: fa_ops.flash_attention(
                    q, k, v, causal=True), iters=5),
                # the same shape without the mask: twice the work, so a
                # causal time above half of it is the causal grid's
                # imbalance
                "full_device_ms": device_ms(torch, lambda:
                                            fa_ops.flash_attention(q, k, v),
                                            iters=5),
                "plain_ms": cuda_ms(torch, lambda:
                                    fa_ops.flash_attention_plain(
                                        q, k, v, causal=True),
                                    iters=3, warmup=1, rounds=2),
                "library_ms": cuda_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          qt, kt, vt, is_causal=True),
                                      iters=10),
            }
            row["bound_ms"], row["bound_by"] = bound(B, S, S, H, D, dtype,
                                                     False, causal=True)
            print(f"time flash_attention {label:16s} {dtype:8s} B={B} "
                  f"S={S} H={H} D={D} causal kernel_ms={row['ms']:.4f} "
                  f"device_ms={row['device_ms']:.4f} "
                  f"(not causal {row['full_device_ms']:.4f}) "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} (sdpa is_causal) "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                  f"bound_share={row['bound_ms'] / row['ms']:.3f} "
                  f"launches_per_prefill={row['launches_per_prefill']}")
            rows.append(row)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return rows


def check_dense(torch, fa_ops, wa_ops, ssd_ops):
    """Each of DENSE_RUNS at full width in bf16 through ``generate``,
    every launch counter reset just before the run and read just after
    (one causal flash launch per layer in the prefill, none in decode);
    then one prefill and one decode step under the profiler.  Returns
    ({label: flash launches per prefill}, total flash launches)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    per_prefill, total = {}, 0
    for (arch, B, S), (label, *_) in zip(DENSE_RUNS, FA_DENSE):
        cfg = get_config(arch)
        V = cfg.vocab_size
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, seed=0, device="cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        torch.cuda.synchronize()
        print(f"dense {arch} config: layers={cfg.num_layers} d_model="
              f"{cfg.d_model} heads={cfg.num_heads} kv_heads="
              f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
              f"{cfg.activation} qk_norm={cfg.qk_norm} tied="
              f"{cfg.tie_embeddings} nonparametric_norm="
              f"{cfg.nonparametric_norm} vocab={V} padded="
              f"{tfm.padded_vocab(cfg)} {cfg.dtype} params={n_params} "
              f"(init {time.perf_counter() - t0:.1f} s); batch {B} x {S} "
              f"tokens + {DENSE_DECODE} decode steps (prefill_32k's 32 x "
              f"32768 cut in batch and length only)")
        batch = random_batch(cfg, ShapeConfig(f"prefill_{S}", S, B,
                                              "prefill"), "prefill",
                             seed=0, device="cuda")
        # warm-up (cuBLAS handles, lazy modules), not counted
        generate(params, cfg, {"tokens": batch["tokens"][:1, :256]}, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        ssd_ops.ssd_scan.launches = 0
        g = generate(params, cfg, batch, DENSE_DECODE)
        n = fa_ops.flash_attention.launches
        other = (wa_ops.weighted_attention.launches,
                 ssd_ops.ssd_scan.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"dense {arch} launches: flash={n} (per prefill, expected "
              f"{cfg.num_layers}) weighted={other[0]} ssd={other[1]}")
        require(n == cfg.num_layers, f"dense {arch}: {n} flash launches, "
                f"expected {cfg.num_layers} per prefill")
        require(other == (0, 0), f"dense {arch}: launches of another "
                f"kernel {other}")
        per_prefill[label] = n
        total += n
        print(f"dense {arch} bfloat16: prefill {g.prefill_seconds:.4f} s = "
              f"{B * S / g.prefill_seconds:.1f} tokens/s; decode "
              f"{1e3 * g.decode_seconds / DENSE_DECODE:.3f} ms/step (batch "
              f"{B}); peak memory {peak:.2f} GiB (parameters included); "
              f"first tokens {g.tokens[0, :6].tolist()}")
        require(bool(torch.isfinite(g.logits.float()).all()),
                f"dense {arch}: non-finite logits")
        require(tuple(g.logits.shape) == (B, DENSE_DECODE + 1,
                                          tfm.padded_vocab(cfg)),
                f"dense {arch}: logits shape {tuple(g.logits.shape)}")
        require(int(g.tokens.max()) < V,
                f"dense {arch}: decoded a padded vocab column")
        (logits, cache), *prof = device_profile(
            torch, lambda: tfm.prefill_step(params, batch, cfg))
        print_profile(f"dense {arch} bfloat16 prefill", *prof)
        del logits
        cache = tfm.place_caches(cfg, cache, S + 1)
        _, *prof = device_profile(torch, lambda: tfm.decode_step(
            params, {"tokens": g.tokens[:, :1]}, cfg, cache, S))
        print_profile(f"dense {arch} bfloat16 decode step", *prof)
        del params, cache, g, batch, prof
        torch.cuda.empty_cache()
    return per_prefill, total


def check_dense_cpu(torch, fa_ops):
    """qwen3-4b at full width cut to DENSE_GATE_LAYERS layers, the same
    seeded parameters on the card and through the port's CPU path, a
    prompt of DENSE_GATE_BATCH x DENSE_GATE_PROMPT tokens: f32 (TF32 off)
    prefill + 2 decode steps, logits card vs CPU <= 1e-4 relative;
    prefill(S) + one decode step == prefill(S + 1)'s last row on the
    card, <= 1e-4 relative.  bf16: the last row's logits with the flash
    kernel within half of the port's CPU bf16-vs-f32 gap of the same card
    run with the attention's plain version on the card.  The card's bf16
    against the CPU's is reported beside it: cuBLAS's bf16 products
    alone (tensor-core accumulation, ~1e-4 from an f32-accumulated
    product where the CPU's are ~3e-5) part the two paths by 0.64 of
    the gap at 2 layers, the flash kernel in or out
    (``tools/dense_bf16_probe.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm

    cfg = get_config("qwen3-4b").replace(num_layers=DENSE_GATE_LAYERS)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    t0 = time.perf_counter()
    p32 = tfm.init_params(f32, seed=1, device="cpu")
    p32_card = _to(p32, "cuda")
    tok = torch.randint(0, V, (DENSE_GATE_BATCH, DENSE_GATE_PROMPT + 1),
                        generator=torch.Generator().manual_seed(3))
    prompt = tok[:, :DENSE_GATE_PROMPT]
    card = generate(p32_card, f32, {"tokens": prompt}, 2, device="cuda")
    cpu = generate(p32, f32, {"tokens": prompt}, 2, device="cpu")
    rel = live_rel(card.logits.cpu(), cpu.logits, V)
    print(f"dense card vs CPU (qwen3-4b, {cfg.num_layers} layers at full "
          f"width, f32, B={DENSE_GATE_BATCH} x {DENSE_GATE_PROMPT} tokens "
          f"+ 2 decode steps): logits rel {rel:.3e}, tokens equal "
          f"{torch.equal(card.tokens.cpu(), cpu.tokens)}")
    require(rel <= 1e-4, f"dense card vs CPU rel {rel}")

    long, _ = tfm.prefill_step(p32_card, {"tokens": tok.cuda()}, f32)
    _, cache = tfm.prefill_step(p32_card, {"tokens": prompt.cuda()}, f32)
    cache = tfm.place_caches(f32, cache, DENSE_GATE_PROMPT + 1)
    step, _ = tfm.decode_step(p32_card, {"tokens": tok[:, -1:].cuda()}, f32,
                              cache, DENSE_GATE_PROMPT)
    rel_pd = live_rel(step[:, 0], long[:, -1], V)
    print(f"dense prefill({DENSE_GATE_PROMPT}) + decode vs prefill("
          f"{DENSE_GATE_PROMPT + 1}) last row on the card: rel {rel_pd:.3e}")
    require(rel_pd <= 1e-4, f"dense prefill vs decode rel {rel_pd}")
    del p32_card, long, cache, step

    p16 = cast_params(p32, tfm.model_specs(cfg), torch.bfloat16)
    p16_card = _to(p16, "cuda")

    def last(p, c, device):
        logits, _ = tfm.prefill_step(p, {"tokens": prompt.to(device)}, c)
        return logits[:, -1, :V].float().cpu()
    card16 = last(p16_card, cfg, "cuda")
    # the same card run with the attention's plain version on the card:
    # the same cuBLAS products, only the flash kernel taken out
    kernel = fa_ops.flash_attention
    fa_ops.flash_attention = fa_ops.flash_attention_plain
    try:
        card16_plain = last(p16_card, cfg, "cuda")
    finally:
        fa_ops.flash_attention = kernel
    cpu16, cpu32 = last(p16, cfg, "cpu"), last(p32, f32, "cpu")
    gap = rel_norm(cpu16, cpu32)
    d_cpu = rel_norm(card16, cpu16)
    d_plain = rel_norm(card16_plain, cpu16)
    d_kernel = rel_norm(card16, card16_plain)
    print(f"dense bf16 gate (qwen3-4b, {cfg.num_layers} layers at full "
          f"width, B={DENSE_GATE_BATCH} x {DENSE_GATE_PROMPT} tokens, "
          f"{time.perf_counter() - t0:.1f} s): the port's bf16 vs f32 gap "
          f"on the CPU {gap:.3e}; last-row logits card (flash kernel) vs "
          f"card (the attention's plain version, the same cuBLAS products) "
          f"{d_kernel:.3e} (gate: below half the gap); card vs CPU "
          f"{d_cpu:.3e} and with the plain attention on the card "
          f"{d_plain:.3e} (reported, not enforced: cuBLAS's bf16 products "
          f"part the card from the CPU, tools/dense_bf16_probe.py); card "
          f"bf16 vs CPU f32 {rel_norm(card16, cpu32):.3e}")
    require(d_kernel < 0.5 * gap, f"dense bf16 flash kernel vs its plain "
            f"version on the card {d_kernel} >= half of the bf16 vs f32 gap "
            f"{gap}")


# --------------------------------------------------------------------- #
# the LM zoo's MoE and hybrid models
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def record_routing(moe_mod):
    """Route every MoE call a second time, just before it runs, and keep
    ((B, S), Routing) in call order."""
    seen, run = [], moe_mod.moe_forward

    def recorded(params, x, cfg):
        seen.append((tuple(x.shape[:2]), moe_mod.route(
            params["router"], x.reshape(-1, x.shape[-1]),
            cfg.experts_per_token, cfg.capacity_factor)))
        return run(params, x, cfg)
    moe_mod.moe_forward = recorded
    try:
        yield seen
    finally:
        moe_mod.moe_forward = run


def moe_cfg(get_config, arch, layers, experts=None, **kw):
    cfg = get_config(arch).replace(num_layers=layers, **kw)
    return cfg.replace(num_experts=experts) if experts else cfg


def card_qkv(torch, gen, B, S, H, D, dtype):
    """q, k, v of (B, S, H, D), drawn on the card."""
    return [torch.randn(B, S, H, D, generator=gen, device="cuda",
                        dtype=dtype) for _ in range(3)]


def check_causal_flash(torch, fa_ops, shapes, seed: int):
    """Causal flash at each (label, B, S, H, D) of ``shapes`` at batch 1,
    q/k/v drawn on the card, kernel vs plain version in both dtypes
    (phase 3's tolerances).  Returns {dtype: max abs err}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        errs[dtype] = 0.0
        for (label, _, S, H, D) in shapes:
            q, k, v = card_qkv(torch, gen, 1, S, H, D, tdt)
            out = fa_ops.flash_attention(q, k, v, causal=True)
            ref = fa_ops.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel flash_attention {label:16s} {dtype:8s} B=1 "
                  f"Sq=Skv={S} H={H} D={D} causal=True max_abs_err="
                  f"{err:.3e}")
            require(err <= tol, f"flash_attention {label} {dtype} err {err}")
            errs[dtype] = max(errs[dtype], err)
            del q, k, v, out, ref
    torch.cuda.empty_cache()
    return errs


def check_moe_kernels(torch, fa_ops, ssd_ops):
    """Causal flash at the MoE models' attention shapes and the SSD scan
    at jamba's (batch 1), kernel vs plain version in both dtypes.
    Returns {kernel: {dtype: max abs err}}."""
    errs = {"flash_attention": check_causal_flash(torch, fa_ops, FA_MOE, 8),
            "ssd": {}}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        label, _, S, H, P, N, q = SSD_JAMBA
        args = ssd_inputs(torch, torch.Generator().manual_seed(9), 1, S, H,
                          P, N, tdt)
        y, st = ssd_ops.ssd_scan(*args, chunk=q)
        yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=q)
        torch.cuda.synchronize()
        ey, es = rel_err(y, yp), rel_err(st, sp)
        abs_err = float(max((y.float() - yp.float()).abs().max(),
                            (st - sp).abs().max()))
        print(f"kernel ssd {label:16s} {dtype:8s} Bt=1 S={S} H={H} P={P} "
              f"N={N} chunk={q} rel_err_y={ey:.3e} rel_err_state={es:.3e} "
              f"max_abs_err={abs_err:.3e}")
        require(ey <= SSD_TOL[dtype] and es <= SSD_STATE_TOL[dtype],
                f"ssd {label} {dtype}: rel err y {ey} state {es}")
        errs["ssd"][dtype] = abs_err
        del args, y, st, yp, sp
    torch.cuda.empty_cache()
    return errs


def time_causal_flash(torch, fa_ops, shapes, launches, seed: int):
    """Causal flash in bf16 at each (label, B, S, H, D) of ``shapes``:
    kernel (events and profiler), plain version, SDPA ``is_causal`` (a
    yardstick the port never calls) and the causal bound.  ``launches``
    {label: launches per prefill on the path}.  Returns the rows."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    dtype = "bfloat16"
    for (label, B, S, H, D) in shapes:
        q, k, v = card_qkv(torch, gen, B, S, H, D, torch.bfloat16)
        qt, kt, vt = [x.transpose(1, 2) for x in (q, k, v)]
        row = {
            "shape": label, "dtype": dtype,
            "launches_per_prefill": launches[label],
            "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                q, k, v, causal=True), iters=10),
            "device_ms": device_ms(torch, lambda: fa_ops.flash_attention(
                q, k, v, causal=True), iters=5),
            "plain_ms": cuda_ms(torch, lambda: fa_ops.flash_attention_plain(
                q, k, v, causal=True), iters=3, warmup=1, rounds=2),
            "library_ms": cuda_ms(torch, lambda:
                                  F.scaled_dot_product_attention(
                                      qt, kt, vt, is_causal=True), iters=10),
        }
        row["bound_ms"], row["bound_by"] = bound(B, S, S, H, D, dtype, False,
                                                 causal=True)
        print(f"time flash_attention {label:16s} {dtype:8s} B={B} S={S} "
              f"H={H} D={D} causal kernel_ms={row['ms']:.4f} device_ms="
              f"{row['device_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (sdpa is_causal) "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"bound_share={row['bound_ms'] / row['ms']:.3f} "
              f"launches_per_prefill={row['launches_per_prefill']}")
        rows.append(row)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def time_moe_kernels(torch, fa_ops, ssd_ops, launches):
    """Causal flash at the MoE models' prefill shapes and the SSD scan at
    jamba's, bf16 (their dtype): kernel (events and profiler), plain
    version, SDPA ``is_causal`` for flash, the bounds.  ``launches``
    {label: launches per prefill on the MoE path}."""
    rows = {"flash_attention": time_causal_flash(torch, fa_ops, FA_MOE,
                                                 launches, 10),
            "ssd": []}
    dtype = "bfloat16"
    label, Bt, S, H, P, N, q = SSD_JAMBA
    args = ssd_inputs(torch, torch.Generator().manual_seed(11), Bt, S, H, P,
                      N, torch.bfloat16)
    row = {"shape": label, "dtype": dtype,
           "launches_per_prefill": launches[label],
           "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan(*args, chunk=q),
                         iters=10, warmup=2),
           "plain_ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan_plain(
               *args, chunk=q), iters=3, warmup=1, rounds=1),
           "library_ms": None}
    parts = device_breakdown(torch, lambda: ssd_ops.ssd_scan(*args, chunk=q),
                             SSD_KERNELS)
    row["device_ms"] = sum(parts.values())
    row["bound_ms"], row["bound_by"] = ssd_bound(Bt, S, H, P, N, q, dtype)
    print(f"time ssd {label:16s} {dtype:8s} Bt={Bt} S={S} H={H} P={P} N={N} "
          f"kernel_ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms=none bound_ms="
          f"{row['bound_ms']:.4f} ({row['bound_by']}) bound_share="
          f"{row['bound_ms'] / row['ms']:.4f} launches_per_prefill="
          f"{row['launches_per_prefill']}; device ms per kernel: "
          + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    rows["ssd"].append(row)
    del args
    torch.cuda.empty_cache()
    return rows


def routing_stats(what: str, calls, n_exp: int) -> None:
    """Per MoE call: tokens per expert (min, max: routed (token, slot)
    pairs, before the capacity) and the dropped share of the pairs."""
    for i, ((B, S), r) in enumerate(calls):
        counts = r.idx.reshape(-1).bincount(minlength=n_exp)
        print(f"{what} moe layer {i}: {B * S} tokens x top-"
              f"{r.idx.shape[1]} over {n_exp} experts, capacity {r.cap}; "
              f"tokens per expert min {int(counts.min())} max "
              f"{int(counts.max())}; dropped share "
              f"{float((~r.keep).float().mean()):.4f}")


def check_moe(torch, fa_ops, wa_ops, ssd_ops):
    """Each of MOE_RUNS at full width in bf16 through ``generate``, every
    launch counter reset just before the run and read just after (one
    causal flash launch per attention layer and one SSD launch per SSM
    layer in the prefill, none in decode); then its routing over one more
    prefill, and one prefill and one decode step under the profiler.
    Returns ({label: launches per prefill}, {kernel: total launches})."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    per_prefill, total = {}, {"flash_attention": 0, "ssd": 0}
    for arch, layers, experts, label, ssd_label in MOE_RUNS:
        cfg = moe_cfg(get_config, arch, layers, experts)
        V, E = cfg.vocab_size, cfg.num_experts
        mixers = [m for m, _ in cfg.pattern()] * cfg.num_repeats
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        leaves = list(_leaves(params))
        n_params = sum(t.numel() for t in leaves)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        expert_bytes = sum(
            t.numel() * t.element_size()
            for blk in params["blocks"].values() if "router" in
            blk.get("ffn", {}) for n, t in blk["ffn"].items() if n != "router")
        print(f"moe {arch} config: layers={cfg.num_layers} pattern="
              f"{'/'.join(f'{m}+{f}' for m, f in cfg.pattern())} d_model="
              f"{cfg.d_model} heads={cfg.num_heads} kv_heads="
              f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
              f"experts={E} (config {get_config(arch).num_experts}) top-"
              f"{cfg.experts_per_token} capacity_factor="
              f"{cfg.capacity_factor} vocab={V} padded="
              f"{tfm.padded_vocab(cfg)} {cfg.dtype} params={n_params} "
              f"({nbytes / 1e9:.2f} GB, experts {expert_bytes / 1e9:.2f} GB; "
              f"init {t_init:.2f} s on the card); batch {MOE_BATCH} x "
              f"{MOE_PROMPT} tokens + {MOE_DECODE} decode steps "
              "(prefill_32k's 32 x 32768 cut in batch and length only)")
        batch = random_batch(cfg, ShapeConfig(f"prefill_{MOE_PROMPT}",
                                              MOE_PROMPT, MOE_BATCH,
                                              "prefill"), "prefill",
                             seed=0, device="cuda")
        # warm-up (cuBLAS handles, lazy modules), not counted
        generate(params, cfg, {"tokens": batch["tokens"][:1, :256]}, 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        ssd_ops.ssd_scan.launches = 0
        g = generate(params, cfg, batch, MOE_DECODE)
        n = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches,
             wa_ops.weighted_attention.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect = (mixers.count("attn"), mixers.count("ssm"), 0)
        print(f"moe {arch} launches: flash={n[0]} ssd={n[1]} weighted="
              f"{n[2]} (per prefill, expected {expect})")
        require(n == expect, f"moe {arch}: launches (flash, ssd, weighted) "
                f"{n}, expected {expect}")
        per_prefill[label] = n[0]
        if ssd_label:
            per_prefill[ssd_label] = n[1]
        total["flash_attention"] += n[0]
        total["ssd"] += n[1]
        step_ms = 1e3 * g.decode_seconds / MOE_DECODE
        print(f"moe {arch} bfloat16: prefill {g.prefill_seconds:.4f} s = "
              f"{MOE_BATCH * MOE_PROMPT / g.prefill_seconds:.1f} tokens/s; "
              f"decode {step_ms:.3f} ms/step (batch {MOE_BATCH}); peak "
              f"memory {peak:.2f} GiB (parameters included); a decode step "
              f"reads every expert (the dense (E, cap, d) buffer): "
              f"{1e3 * expert_bytes / HBM_BYTES_PER_S:.3f} ms of HBM time for "
              f"the experts, {1e3 * nbytes / HBM_BYTES_PER_S:.3f} ms for all "
              f"weights at 3.35 TB/s; first tokens {g.tokens[0, :6].tolist()}")
        require(bool(torch.isfinite(g.logits.float()).all()),
                f"moe {arch}: non-finite logits")
        require(tuple(g.logits.shape) == (MOE_BATCH, MOE_DECODE + 1,
                                          tfm.padded_vocab(cfg)),
                f"moe {arch}: logits shape {tuple(g.logits.shape)}")
        require(int(g.tokens.max()) < V,
                f"moe {arch}: decoded a padded vocab column")
        with record_routing(moe_mod) as calls:
            logits, _ = tfm.prefill_step(params, batch, cfg)
        del logits
        routing_stats(f"moe {arch} prefill", calls, E)
        del calls
        (logits, cache), *prof = device_profile(
            torch, lambda: tfm.prefill_step(params, batch, cfg))
        print_profile(f"moe {arch} bfloat16 prefill", *prof)
        del logits
        cache = tfm.place_caches(cfg, cache, MOE_PROMPT + 1)
        _, *prof = device_profile(torch, lambda: tfm.decode_step(
            params, {"tokens": g.tokens[:, :1]}, cfg, cache, MOE_PROMPT))
        print_profile(f"moe {arch} bfloat16 decode step", *prof)
        del params, cache, g, batch, prof
        torch.cuda.empty_cache()
    return per_prefill, total


def routing_flips(what: str, card_calls, cpu_calls):
    """The tokens whose top-k experts differ between the card's calls and
    the CPU's.  Each differing slot must be a near tie on the CPU: its
    two experts' router scores within FLIP_REL relative.  Returns (number
    of flipped tokens, the batch entries that hold one)."""
    flips, entries = 0, set()
    require(len(card_calls) == len(cpu_calls), f"{what}: MoE calls differ")
    for (shape, rc), (_, rp) in zip(card_calls, cpu_calls):
        a, b = rc.idx.cpu(), rp.idx
        diff = a != b
        for t, j in diff.nonzero().tolist():
            sa = float(rp.scores[t, a[t, j]])
            sb = float(rp.scores[t, b[t, j]])
            rel = abs(sa - sb) / max(abs(sa), abs(sb))
            print(f"{what}: token {t} slot {j} expert {int(a[t, j])} on the "
                  f"card, {int(b[t, j])} on the CPU; CPU scores {sa:.7g} / "
                  f"{sb:.7g}, rel {rel:.3e}")
            require(rel < FLIP_REL, f"{what}: a routing flip that is not a "
                    f"near tie (rel {rel})")
        flipped = diff.any(-1)
        flips += int(flipped.sum())
        entries |= set(flipped.reshape(shape).any(-1).nonzero()
                       .flatten().tolist())
    return flips, entries


def dropped_entries(calls):
    """Batch entries with a (token, slot) over capacity in any call."""
    out = set()
    for shape, r in calls:
        out |= set((~r.keep).reshape(shape + (-1,)).any(-1).any(-1)
                   .nonzero().flatten().cpu().tolist())
    return out


def moe_prefill_vs_decode(torch, tfm, moe_mod, p_card, cfg, tok, arch):
    """On the card: prefill(S) + one decode step vs prefill(S + 1)'s last
    row, <= 1e-4 relative.  The entries that neither prefill dropped a
    token of compare; so does an entry whose last token prefill(S + 1)
    kept when the model's one MoE layer is its last op: a drop there
    changes only its own token's row, and the decode step drops
    nothing."""
    V, S = cfg.vocab_size, tok.shape[1] - 1
    with record_routing(moe_mod) as long_calls:
        long, _ = tfm.prefill_step(p_card, {"tokens": tok.cuda()}, cfg)
    with record_routing(moe_mod) as short_calls:
        _, cache = tfm.prefill_step(p_card, {"tokens": tok[:, :S].cuda()},
                                    cfg)
    cache = tfm.place_caches(cfg, cache, S + 1)
    step, _ = tfm.decode_step(p_card, {"tokens": tok[:, -1:].cuda()}, cfg,
                              cache, S)
    require(cfg.pattern()[-1][1] == "moe" and len(long_calls) == 1,
            f"moe prefill vs decode: {arch}'s MoE layer is not its last")
    dropped = dropped_entries(long_calls) | dropped_entries(short_calls)
    strict = [b for b in range(tok.shape[0]) if b not in dropped]
    (shape, r), = long_calls
    kept = r.keep.reshape(shape + (-1,))[:, -1].all(-1).tolist()
    clean = [b for b in range(tok.shape[0]) if kept[b]]
    n_long = int(sum((~r.keep).sum() for _, r in long_calls))
    n_short = int(sum((~r.keep).sum() for _, r in short_calls))
    print(f"moe prefill({S}) + decode vs prefill({S + 1}) on the card "
          f"({arch}): dropped pairs {n_short} / {n_long}; entries without a "
          f"drop {strict}, entries whose last token prefill({S + 1}) kept "
          f"{clean}", end="")
    require(bool(clean), "moe prefill vs decode: every entry's last token "
            "dropped; nothing to compare")
    rel_pd = live_rel(step[clean, 0], long[clean, -1], V)
    rel_strict = (f"{live_rel(step[strict, 0], long[strict, -1], V):.3e}"
                  if strict else "none")
    print(f": rel {rel_pd:.3e} (over the entries without a drop: "
          f"{rel_strict})")
    require(rel_pd <= 1e-4, f"moe prefill vs decode rel {rel_pd}")


def report_moe_bf16(torch, fa_ops, tfm, moe_mod, p_cpu, cfg, prompt, arch):
    """bf16 last-row logits, reported and not enforced: card vs CPU, and
    the flash kernel vs its plain version on the card, each with the
    tokens the two runs routed otherwise."""
    V = cfg.vocab_size
    p16 = cast_params(p_cpu, tfm.model_specs(cfg), torch.bfloat16)
    p16_card = _to(p16, "cuda")

    def last(p, device):
        with record_routing(moe_mod) as calls:
            logits, _ = tfm.prefill_step(p, {"tokens": prompt.to(device)},
                                         cfg)
        return logits[:, -1, :V].float().cpu(), calls
    card16, card_calls = last(p16_card, "cuda")
    kernel = fa_ops.flash_attention
    fa_ops.flash_attention = fa_ops.flash_attention_plain
    try:
        plain16, plain_calls = last(p16_card, "cuda")
    finally:
        fa_ops.flash_attention = kernel
    cpu16, cpu_calls = last(p16, "cpu")

    def routed_otherwise(a, b):
        return sum(int((ra.idx.cpu() != rb.idx.cpu()).any(-1).sum())
                   for (_, ra), (_, rb) in zip(a, b))
    print(f"moe bf16 ({arch}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts, B={prompt.shape[0]} x "
          f"{prompt.shape[1]} tokens; reported, not enforced): last-row "
          f"logits card vs CPU {rel_norm(card16, cpu16):.3e} (tokens routed "
          f"otherwise {routed_otherwise(card_calls, cpu_calls)}); flash "
          f"kernel vs its plain version on the card "
          f"{rel_norm(card16, plain16):.3e} (routed otherwise "
          f"{routed_otherwise(card_calls, plain_calls)})")


def check_moe_cpu(torch, fa_ops):
    """f32 (TF32 off), the same seeded parameters on the card and through
    the port's CPU path (drawn on the card: the counter-hash init gives
    the CPU's bits), B=MOE_GATE_BATCH x MOE_GATE_PROMPT + 2 decode
    steps.  llama4-maverick at full width cut to its super-block with 8
    experts, and jamba's super-block at widths cut by 8: every routing
    flip between the card and the CPU must be a near tie, and logits
    agree <= 1e-4 relative over the batch entries without a flip.  On the
    card, llama4's prefill(S) + one decode step against prefill(S + 1)
    (``moe_prefill_vs_decode``).  bf16, both models: card vs CPU and
    flash kernel vs plain, reported with their flips."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    gates = (("llama4-maverick-400b-a17b", moe_cfg(
        get_config, "llama4-maverick-400b-a17b", 2, 8)),
             ("jamba-1.5-large-398b", moe_cfg(
                 get_config, "jamba-1.5-large-398b", 8, None, **JAMBA_CUT)))
    for arch, cfg in gates:
        t0 = time.perf_counter()
        f32 = cfg.replace(dtype="float32", param_dtype="float32")
        V = cfg.vocab_size
        p_card = tfm.init_params(f32, seed=1, device="cuda")
        p_cpu = _to(p_card, "cpu")
        tok = torch.randint(0, V, (MOE_GATE_BATCH, MOE_GATE_PROMPT + 1),
                            generator=torch.Generator().manual_seed(3))
        prompt = tok[:, :MOE_GATE_PROMPT]
        with record_routing(moe_mod) as card_calls:
            card = generate(p_card, f32, {"tokens": prompt}, 2,
                            device="cuda")
        with record_routing(moe_mod) as cpu_calls:
            cpu = generate(p_cpu, f32, {"tokens": prompt}, 2, device="cpu")
        what = f"moe card vs CPU ({arch}, f32)"
        flips, flipped = routing_flips(what, card_calls, cpu_calls)
        keep = [b for b in range(MOE_GATE_BATCH) if b not in flipped]
        require(bool(keep), f"{what}: every batch entry holds a flip")
        rel = live_rel(card.logits.cpu()[keep], cpu.logits[keep], V)
        print(f"{what}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_experts} experts top-{cfg.experts_per_token}, "
              f"B={MOE_GATE_BATCH} x {MOE_GATE_PROMPT} tokens + 2 decode "
              f"steps ({time.perf_counter() - t0:.1f} s): routing flips "
              f"{flips} (entries {sorted(flipped)}); logits rel {rel:.3e} "
              f"over entries {keep}; dropped (token, slot) pairs in the "
              f"prefill {int(sum((~r.keep).sum() for _, r in card_calls))}; "
              f"tokens equal {torch.equal(card.tokens.cpu(), cpu.tokens)}")
        require(rel <= 1e-4, f"{what}: logits rel {rel}")
        del card_calls, cpu_calls, card, cpu
        if arch == "llama4-maverick-400b-a17b":
            moe_prefill_vs_decode(torch, tfm, moe_mod, p_card, f32, tok,
                                  arch)
        del p_card
        report_moe_bf16(torch, fa_ops, tfm, moe_mod, p_cpu, cfg, prompt,
                        arch)
        del p_cpu
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the LM zoo's frontend and codebook models
# --------------------------------------------------------------------- #

def check_frontends(torch, fa_ops, wa_ops, ssd_ops):
    """Each of FRONTEND_RUNS whole at full width in bf16 through
    ``generate`` on ``random_batch``'s prefill batch (tokens, the
    frontend's embeddings, qwen2-vl's (3, B, S) positions), every launch
    counter reset just before the run and read just after: one causal
    flash launch per layer in the prefill, none of another kernel.  Then
    one prefill and one decode step under the profiler.  Returns ({label:
    flash launches per prefill}, total flash launches)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import torch_dtype

    per_prefill, total = {}, 0
    for (arch, B, S), (label, *_) in zip(FRONTEND_RUNS, FA_FRONTENDS):
        cfg = get_config(arch)
        V, C, F = cfg.vocab_size, cfg.num_codebooks, cfg.frontend_len
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        leaves = list(_leaves(params))
        n_params = sum(t.numel() for t in leaves)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        kv_bytes = sum(math.prod(spec.shape) for spec in _leaves(
            tfm.cache_specs(cfg, B, S + FRONTEND_DECODE))) \
            * torch_dtype(cfg.dtype).itemsize
        print(f"frontends {arch} config: layers={cfg.num_layers} d_model="
              f"{cfg.d_model} heads={cfg.num_heads} kv_heads="
              f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
              f"{cfg.activation} mrope_sections={cfg.mrope_sections} "
              f"frontend={cfg.frontend} x {F} codebooks={C} vocab={V} "
              f"padded={tfm.padded_vocab(cfg)} {cfg.dtype} params={n_params}"
              f" ({nbytes / 1e9:.2f} GB; init {t_init:.2f} s on the card); "
              f"batch {B} x {S} positions ({F} frontend + {S - F} token "
              f"positions) + {FRONTEND_DECODE} decode steps, KV cache at "
              f"{S + FRONTEND_DECODE} positions {kv_bytes / 1e9:.2f} GB "
              "(prefill_32k's 32 x 32768 cut in batch and length only)")
        batch = random_batch(cfg, ShapeConfig(f"prefill_{S}", S, B,
                                              "prefill"), "prefill",
                             seed=0, device="cuda")
        # warm-up (cuBLAS handles, lazy modules), not counted
        warm = random_batch(cfg, ShapeConfig("warm", F + 256, 1, "prefill"),
                            "prefill", seed=1, device="cuda")
        generate(params, cfg, warm, 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        ssd_ops.ssd_scan.launches = 0
        g = generate(params, cfg, batch, FRONTEND_DECODE)
        n = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches,
             wa_ops.weighted_attention.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect = (cfg.num_layers, 0, 0)
        print(f"frontends {arch} launches: flash={n[0]} ssd={n[1]} "
              f"weighted={n[2]} (per prefill, expected {expect})")
        require(n == expect, f"frontends {arch}: launches (flash, ssd, "
                f"weighted) {n}, expected {expect}")
        per_prefill[label] = n[0]
        total += n[0]
        carry = (f", each position carrying {C} codebook tokens" if C > 1
                 else "")
        print(f"frontends {arch} bfloat16: prefill {g.prefill_seconds:.4f} "
              f"s = {B * S / g.prefill_seconds:.1f} positions/s ({F} "
              f"frontend embeddings a sequence{carry}); decode "
              f"{1e3 * g.decode_seconds / FRONTEND_DECODE:.3f} ms/step "
              f"(batch {B}; all weights {1e3 * nbytes / HBM_BYTES_PER_S:.3f} "
              f"ms of HBM time at 3.35 TB/s); peak memory {peak:.2f} GiB "
              f"(parameters included); first tokens "
              f"{g.tokens[0, :4].tolist()}")
        require(bool(torch.isfinite(g.logits.float()).all()),
                f"frontends {arch}: non-finite logits")
        books = (C,) if C > 1 else ()
        shape = (B, FRONTEND_DECODE + 1) + books + (tfm.padded_vocab(cfg),)
        require(tuple(g.logits.shape) == shape,
                f"frontends {arch}: logits shape {tuple(g.logits.shape)}, "
                f"expected {shape}")
        require(tuple(g.tokens.shape) == shape[:-1],
                f"frontends {arch}: tokens shape {tuple(g.tokens.shape)}")
        require(int(g.tokens.max()) < V,
                f"frontends {arch}: decoded a padded vocab column")
        (logits, cache), *prof = device_profile(
            torch, lambda: tfm.prefill_step(params, batch, cfg))
        print_profile(f"frontends {arch} bfloat16 prefill", *prof)
        del logits
        cache = tfm.place_caches(cfg, cache, S + 1)
        _, *prof = device_profile(torch, lambda: tfm.decode_step(
            params, {"tokens": g.tokens[:, :1]}, cfg, cache, S))
        print_profile(f"frontends {arch} bfloat16 decode step", *prof)
        del params, cache, g, batch, warm, prof
        torch.cuda.empty_cache()
    return per_prefill, total


def frontend_gate_batch(torch, cfg, S: int):
    """B=FRONTEND_GATE_BATCH x (S + 1) positions from ``random_batch``
    (seed 3, on the CPU): the frontend's embeddings, then tokens.  With
    M-RoPE, three different position streams (a permutation of the first
    S positions each), and position S in all three at the last, the
    position a decode step after a prefill of S takes."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import random_batch

    batch = random_batch(cfg, ShapeConfig("gate", S + 1, FRONTEND_GATE_BATCH,
                                          "prefill"), "prefill", seed=3,
                         device="cpu")
    if cfg.mrope_sections:
        gen = torch.Generator().manual_seed(3)
        pos = torch.full((3, FRONTEND_GATE_BATCH, S + 1), S)
        for i in range(3):
            for b in range(FRONTEND_GATE_BATCH):
                pos[i, b, :S] = torch.randperm(S, generator=gen)
        batch["positions"] = pos
    return batch


def check_frontends_cpu(torch, fa_ops):
    """Each frontend model at full width cut to FRONTEND_GATE_LAYERS
    layers, the same seeded parameters on the card and through the
    port's CPU path, FRONTEND_GATE_BATCH x FRONTEND_GATE_POSITIONS
    positions (the frontend's embeddings first; qwen2-vl fed three
    different position streams): f32 (TF32 off) prefill + 2 decode steps,
    logits card vs CPU <= 1e-4 relative and the same tokens; prefill(S)
    + one decode step == prefill(S + 1)'s last row on the card, <= 1e-4
    relative.  bf16: the last row's logits with the flash kernel within
    half of the port's CPU bf16-vs-f32 gap of the same card run with the
    attention's plain version (``check_dense_cpu``'s gate); card vs CPU
    in bf16 reported beside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm

    S = FRONTEND_GATE_POSITIONS
    for arch, *_ in FRONTEND_RUNS:
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(num_layers=FRONTEND_GATE_LAYERS)
        f32 = cfg.replace(dtype="float32", param_dtype="float32")
        V = cfg.vocab_size
        p32_card = tfm.init_params(f32, seed=1, device="cuda")
        p32 = _to(p32_card, "cpu")
        long = frontend_gate_batch(torch, f32, S)
        n_tok = S - cfg.frontend_len
        prompt = dict(long, tokens=long["tokens"][:, :n_tok])
        if "positions" in long:
            prompt["positions"] = long["positions"][:, :, :S]
        card = generate(p32_card, f32, prompt, 2, device="cuda")
        cpu = generate(p32, f32, prompt, 2, device="cpu")
        rel = live_rel(card.logits.cpu(), cpu.logits, V)
        streams = ("three different position streams"
                   if cfg.mrope_sections else "one position stream")
        print(f"frontends card vs CPU ({arch}, {cfg.num_layers} layers at "
              f"full width, f32, B={FRONTEND_GATE_BATCH} x {S} positions: "
              f"{cfg.frontend_len} frontend + {n_tok} tokens, {streams}, + 2 "
              f"decode steps): logits rel {rel:.3e}, tokens equal "
              f"{torch.equal(card.tokens.cpu(), cpu.tokens)}")
        require(rel <= 1e-4, f"frontends {arch} card vs CPU rel {rel}")
        require(torch.equal(card.tokens.cpu(), cpu.tokens),
                f"frontends {arch}: card and CPU tokens differ")
        del card, cpu

        def on_card(b):
            return {k: v.cuda() for k, v in b.items()}
        full, _ = tfm.prefill_step(p32_card, on_card(long), f32)
        _, cache = tfm.prefill_step(p32_card, on_card(prompt), f32)
        cache = tfm.place_caches(f32, cache, S + 1)
        step, _ = tfm.decode_step(p32_card, {"tokens": long["tokens"][
            :, n_tok:].cuda()}, f32, cache, S)
        rel_pd = live_rel(step[:, 0], full[:, -1], V)
        print(f"frontends {arch} prefill({S}) + decode vs prefill({S + 1}) "
              f"last row on the card: rel {rel_pd:.3e}")
        require(rel_pd <= 1e-4, f"frontends {arch} prefill vs decode rel "
                f"{rel_pd}")
        del p32_card, full, cache, step

        p16 = cast_params(p32, tfm.model_specs(cfg), torch.bfloat16)
        p16_card = _to(p16, "cuda")

        def last(p, c, device):
            logits, _ = tfm.prefill_step(p, {k: v.to(device) for k, v in
                                             prompt.items()}, c)
            return logits[:, -1, ..., :V].float().cpu()
        card16 = last(p16_card, cfg, "cuda")
        kernel = fa_ops.flash_attention
        fa_ops.flash_attention = fa_ops.flash_attention_plain
        try:
            card16_plain = last(p16_card, cfg, "cuda")
        finally:
            fa_ops.flash_attention = kernel
        cpu16, cpu32 = last(p16, cfg, "cpu"), last(p32, f32, "cpu")
        gap = rel_norm(cpu16, cpu32)
        d_kernel = rel_norm(card16, card16_plain)
        print(f"frontends bf16 gate ({arch}, {cfg.num_layers} layers at full "
              f"width, {time.perf_counter() - t0:.1f} s): the port's bf16 vs "
              f"f32 gap on the CPU {gap:.3e}; last-row logits card (flash "
              f"kernel) vs card (the attention's plain version) "
              f"{d_kernel:.3e} (gate: below half the gap); card vs CPU "
              f"{rel_norm(card16, cpu16):.3e} and with the plain attention "
              f"on the card {rel_norm(card16_plain, cpu16):.3e} (reported, "
              "not enforced)")
        require(d_kernel < 0.5 * gap, f"frontends {arch} bf16 flash kernel "
                f"vs its plain version on the card {d_kernel} >= half of the "
                f"bf16 vs f32 gap {gap}")
        del p16, p16_card, p32
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# training: gradients through the kernels, CAPSim at full width, LMs
# --------------------------------------------------------------------- #

def rel_norm_err(a, b) -> float:
    """|a - b| / |b| in f32 (Frobenius norms)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def check_train_grads(torch, fa_ops, ssd_ops):
    """The flash and SSD Functions' gradients (the kernel's forward, the
    plain version's recompute) against autograd through the plain
    versions on the card, at FA_TRAIN's and SSD_TRAIN's shapes: f32 <=
    GRAD_TOL per input in relative norm, bf16 reported, all finite; the
    forward under grad bitwise the no-grad launch.  Then the forward
    kernel at each train shape in both dtypes, timed beside its plain
    version, SDPA and its bound, and the backward recompute's time."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for label, B, Sq, Skv, H, D, causal, masked in FA_TRAIN:
            q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda",
                                   dtype=tdt).requires_grad_(True)
                       for S in (Sq, Skv, Skv))
            g = torch.randn(B, Sq, H, D, generator=gen, device="cuda",
                            dtype=tdt)
            m = ((torch.rand(B, Skv, generator=gen, device="cuda") > 0.25)
                 .float() if masked else None)
            kw = dict(causal=causal, kv_mask=m)
            out = fa_ops.flash_attention(q, k, v, **kw)
            with torch.no_grad():
                same = torch.equal(out.detach(),
                                   fa_ops.flash_attention(q, k, v, **kw))
            got = torch.autograd.grad(out, (q, k, v), g)
            ref = torch.autograd.grad(fa_ops.flash_attention_plain(
                q, k, v, **kw), (q, k, v), g)
            errs = [rel_norm_err(a, b) for a, b in zip(got, ref)]
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            print(f"train grad flash_attention {label:14s} {dtype:8s} B={B} "
                  f"Sq={Sq} Skv={Skv} H={H} D={D} causal={causal} "
                  f"masked={masked}: rel_norm dq/dk/dv "
                  + "/".join(f"{e:.3e}" for e in errs)
                  + f" finite={finite} forward_bitwise_no_grad={same}")
            require(finite and same, f"flash grad {label} {dtype}: finite "
                    f"{finite}, forward bitwise {same}")
            if dtype == "float32":
                require(max(errs) <= GRAD_TOL,
                        f"flash grad {label}: rel norm {errs}")
            with torch.no_grad():
                qt, kt, vt = (x.detach() for x in (q, k, v))
                row = {"shape": f"train_{label}", "dtype": dtype,
                       "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                           qt, kt, vt, **kw), iters=10),
                       "plain_ms": cuda_ms(
                           torch, lambda: fa_ops.flash_attention_plain(
                               qt, kt, vt, **kw), iters=3, warmup=1,
                           rounds=2)}
                sq, sk, sv = (x.transpose(1, 2) for x in (qt, kt, vt))
                bias = None if m is None else torch.where(
                    m[:, None, None, :] > 0, 0.0, -1e30).to(tdt)
                row["library_ms"] = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=bias, is_causal=causal),
                    iters=10)
            row["backward_ms"] = cuda_ms(
                torch, lambda: fa_ops.flash_attention_backward(
                    qt, kt, vt, m, g, causal, 0), iters=3, warmup=1,
                rounds=2)
            row["bound_ms"], row["bound_by"] = bound(B, Sq, Skv, H, D, dtype,
                                                     masked, causal)
            print(f"time flash_attention {row['shape']:20s} {dtype:8s} "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                  f" library_ms={row['library_ms']:.4f} (sdpa) bound_ms="
                  f"{row['bound_ms']:.4f} ({row['bound_by']}) bound_share="
                  f"{row['bound_ms'] / row['ms']:.3f} backward_recompute_ms="
                  f"{row['backward_ms']:.4f}")
            rows.append(row)
            del q, k, v, g, out, got, ref, qt, kt, vt, sq, sk, sv
        label, Bt, S, H, P, N, chunk = SSD_TRAIN
        ins = [t.requires_grad_(True) for t in ssd_inputs(
            torch, torch.Generator().manual_seed(22), Bt, S, H, P, N, tdt)]
        y, st = ssd_ops.ssd_scan(*ins, chunk=chunk)
        with torch.no_grad():
            y0, st0 = ssd_ops.ssd_scan(*ins, chunk=chunk)
        same = torch.equal(y.detach(), y0) and torch.equal(st.detach(), st0)
        gy, gs = torch.randn_like(y), torch.randn_like(st)
        got = torch.autograd.grad((y, st), ins, (gy, gs))
        ref = torch.autograd.grad(ssd_ops.ssd_scan_plain(*ins, chunk),
                                  ins, (gy, gs))
        errs = [rel_norm_err(a, b) for a, b in zip(got, ref)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        print(f"train grad ssd {label:14s} {dtype:8s} Bt={Bt} S={S} H={H} "
              f"P={P} N={N} chunk={chunk}: rel_norm dx/ddt/dB/dC/dA "
              + "/".join(f"{e:.3e}" for e in errs)
              + f" finite={finite} forward_bitwise_no_grad={same}")
        require(finite and same, f"ssd grad {dtype}: finite {finite}, "
                f"forward bitwise {same}")
        if dtype == "float32":
            require(max(errs) <= GRAD_TOL, f"ssd grad: rel norm {errs}")
        detached = [t.detach() for t in ins]
        with torch.no_grad():
            fwd = cuda_ms(torch, lambda: ssd_ops.ssd_scan(
                *detached, chunk=chunk), iters=10)
            plain = cuda_ms(torch, lambda: ssd_ops.ssd_scan_plain(
                *detached, chunk), iters=3, warmup=1, rounds=2)
        ms = cuda_ms(torch, lambda: ssd_ops.ssd_scan_backward(
            *detached, chunk, gy, gs), iters=3, warmup=1, rounds=2)
        b_ms, b_by = ssd_bound(Bt, S, H, P, N, chunk, dtype)
        print(f"time ssd {label} {dtype} kernel_ms={fwd:.4f} plain_ms="
              f"{plain:.4f} bound_ms={b_ms:.4f} ({b_by}) bound_share="
              f"{b_ms / fwd:.3f} backward_recompute_ms={ms:.4f}")
        del ins, y, st, y0, st0, gy, gs, got, ref, detached
        torch.cuda.empty_cache()
    return rows


def check_flash_backward(torch, fa_ops):
    """The flash backward kernels, f32 at FA_BWD's shapes and bf16 at
    FA_BWD_BF16's: the forward's log-sum-exp against the plain one (rows
    with a live key within 1e-5 in f32, 1e-4 in bf16, +inf where none)
    with the output bitwise the launch without it; the kernels' dq/dk/dv
    against the plain equations from the same o and lse
    (``flash_attention_backward_plain``, with bf16's rounding points) and
    against autograd through the plain recompute
    (``flash_attention_backward``), f32 <= GRAD_TOL and bf16 <= BF16_TOL
    relative norm per input, all finite; two calls the same bits; a
    keyless row's dq and a masked key's dk, dv exactly 0; one launch
    counted a call.  Each shape timed: the kernels, the plain recompute,
    SDPA's backward in the same dtype (masks as an additive bias; no
    window, so none there) and the bound (``attention_bwd_cost``: five
    products at 67 / 989 TFLOP/s or the bytes)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    for dtype, shapes in (("float32", FA_BWD), ("bfloat16", FA_BWD_BF16)):
        tdt = getattr(torch, dtype)
        f32 = dtype == "float32"
        for label, B, Sq, Skv, H, D, causal, window, masked in shapes:
            rows.append(_flash_backward_row(
                torch, F, fa_ops, gen, tdt, label, B, Sq, Skv, H, D, causal,
                window, masked, GRAD_TOL if f32 else BF16_TOL,
                1e-5 if f32 else 1e-4))
            torch.cuda.empty_cache()
    return rows


def _flash_backward_row(torch, F, fa_ops, gen, tdt, label, B, Sq, Skv, H,
                        D, causal, window, masked, tol, lse_tol):
    """One shape of ``check_flash_backward``: its checks and its timing
    row."""
    dtype = str(tdt).removeprefix("torch.")
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(tdt)
               for S in (Sq, Skv, Skv))
    g = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(tdt)
    m = None
    if masked:
        m = (torch.rand(B, Skv, generator=gen, device="cuda") > 0.3).float()
        m[0] = 0.0
    kw = dict(causal=causal, window=window, kv_mask=m)
    lse = torch.empty(B, H, Sq, device="cuda")
    o = fa_ops._launch(q, k, v, m, causal, window, lse)
    _, lse_ref = fa_ops.flash_attention_plain(q, k, v, **kw, return_lse=True)
    same_o = torch.equal(o, fa_ops._launch(q, k, v, m, causal, window))
    keyless = torch.isinf(lse_ref)
    lse_err = float((lse - lse_ref)[~keyless].abs().max()) \
        if bool((~keyless).any()) else 0.0
    lse_ok = bool(torch.isposinf(lse[keyless]).all()) and lse_err <= lse_tol
    del lse_ref
    before = fa_ops.flash_attention_bwd.launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, g, m, causal, window)
    again = fa_ops.flash_attention_bwd(q, k, v, o, lse, g, m, causal, window)
    n = fa_ops.flash_attention_bwd.launches - before
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    plain = fa_ops.flash_attention_backward_plain(q, k, v, o, lse, g, m,
                                                  causal, window)
    e_plain = [rel_norm_err(a, b) for a, b in zip(got, plain)]
    del plain
    recompute = fa_ops.flash_attention_backward(q, k, v, m, g, causal, window)
    e_rec = [rel_norm_err(a, b) for a, b in zip(got, recompute)]
    del recompute
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    zeros = True
    if m is not None:
        off = m == 0
        zeros = bool((got[0][0] == 0).all()) and bool(
            (got[1][off] == 0).all()) and bool((got[2][off] == 0).all())
    print(f"flash_bwd {label:18s} {dtype} B={B} Sq={Sq} Skv={Skv} H={H} "
          f"D={D} causal={causal} window={window} masked={masked}: rel_norm "
          "dq/dk/dv vs plain equations "
          + "/".join(f"{e:.3e}" for e in e_plain) + " vs recompute "
          + "/".join(f"{e:.3e}" for e in e_rec)
          + f"; lse max err {lse_err:.3e} (keyless rows "
          f"{int(keyless.sum())} +inf: {lse_ok}); o bitwise without "
          f"lse {same_o}; two calls bitwise {bitwise}; finite {finite}; "
          f"masked zeros {zeros}; launches {n}")
    require(finite and bitwise and same_o and lse_ok and zeros and n == 2,
            f"flash backward {label} {dtype}: finite {finite}, bitwise "
            f"{bitwise}, o {same_o}, lse {lse_ok} ({lse_err}), zeros "
            f"{zeros}, launches {n}")
    require(max(e_plain + e_rec) <= tol,
            f"flash backward {label} {dtype}: rel norm {e_plain} / {e_rec}")
    row = {"shape": f"bwd_{label}", "dtype": dtype,
           "ms": cuda_ms(torch, lambda: fa_ops.flash_attention_bwd(
               q, k, v, o, lse, g, m, causal, window), iters=10),
           "recompute_ms": cuda_ms(
               torch, lambda: fa_ops.flash_attention_backward(
                   q, k, v, m, g, causal, window), iters=3, warmup=1,
               rounds=2)}
    row["library_ms"] = float("nan")
    if window == 0:
        sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        bias = None
        if masked or (causal and Sq != Skv):
            bias = torch.where(fa_ops.live_pairs(q, k, causal, 0, m),
                               0.0, -1e30).to(tdt)
        out = F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=bias, is_causal=causal and bias is None)
        gt = g.transpose(1, 2)
        row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (sq, sk, sv), gt, retain_graph=True), iters=5)
        del sq, sk, sv, bias, out, gt
    row["bound_ms"], row["bound_by"] = _roof(*fa_ops.attention_bwd_cost(
        B, Sq, Skv, H, D, tdt.itemsize, masked, causal), dtype)
    print(f"time flash_attention_bwd {label:18s} {dtype} kernel_ms="
          f"{row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}) bound_share="
          f"{row['bound_ms'] / row['ms']:.3f} recompute_ms="
          f"{row['recompute_ms']:.4f} library_ms="
          f"{row['library_ms']:.4f} (sdpa backward)")
    return row


@contextlib.contextmanager
def recorded_steps(torch, train_mod, last: int):
    """``train_mod.make_train_step`` wrapped for the duration: each step
    built appends its loss tensor to ``seen["losses"]``, with no
    synchronization; ``seen["t0"]`` is the host time at the first step's
    entry and ``seen["t_end"]`` the host time at the end of step ``last``
    (the device synchronized there, after the last step to be timed)."""
    make, seen = train_mod.make_train_step, {"losses": [], "t0": None,
                                             "t_end": None}

    def wrapped_make(loss_fn, tcfg):
        step = make(loss_fn, tcfg)

        def recorded(state, batch):
            if seen["t0"] is None:
                seen["t0"] = time.perf_counter()
            state, metrics = step(state, batch)
            seen["losses"].append(metrics["loss"])
            if len(seen["losses"]) == last:
                torch.cuda.synchronize()
                seen["t_end"] = time.perf_counter()
            return state, metrics
        return recorded
    train_mod.make_train_step = wrapped_make
    try:
        yield seen
    finally:
        train_mod.make_train_step = make


def emb_per_step(batch: int) -> int:
    """The embedding gradient's launches in a CAPSim train step of
    ``batch`` clips of 128 instructions: one a pass of the instruction
    encoder (``predictor.ENCODE_CHUNK`` instructions) and one for the
    context gather."""
    from repro_torch.core import predictor
    return -(-batch * 128 // predictor.ENCODE_CHUNK) + 1


def bwd_per_step(batch: int) -> int:
    """The flash backward kernels' launches in a CAPSim train step of
    ``batch`` clips (f32): one a layer of each instruction-encoder pass
    (4 layers), and the block encoder's self and cross attention (4
    layers each); remat recomputes forwards, not backwards."""
    from repro_torch.core import predictor
    return 4 * -(-batch * 128 // predictor.ENCODE_CHUNK) + 8


def steps_per_s(seen) -> float:
    """Steps a second of a recorded run: all its steps over the span from
    the first step's entry to the last step's end (its work done on the
    device); the checkpoints saved in between are inside the span."""
    return len(seen["losses"]) / (seen["t_end"] - seen["t0"])


# the train step's ``record_function`` ranges (training/train_loop.py)
# and the flash Function's backward (kernels/flash_attention/ops.py)
TRAIN_RANGES = ("train/forward", "train/backward", "train/update",
                "flash_attention_backward")


def train_step_split(torch, fn, what: str) -> dict:
    """One call of a train step ``fn`` (the real ``make_train_step``)
    under ``torch.profiler``, printed as ``device_profile`` prints, and
    cut at the step's ``record_function`` ranges: the device ms of the
    kernels launched inside each, and the host ms each range spans.  The
    autograd engine launches the backward's kernels from its own thread,
    outside the main thread's ``train/backward`` range, so the backward's
    device time is the busy time that the forward and the update leave.
    The flash Function's backward runs in that thread inside its own
    range; in f32 it launches the backward kernels through ctypes, which
    the profiler does not charge to the range, so its part is their
    device time by name (``capsim_fa_bwd::``).  Returns {part: device
    ms}."""
    from torch.autograd import DeviceType
    _, wall, avg = _capture(torch, fn)
    busy, ours, top = _summary(avg)
    print_profile(what, wall, busy, ours, top)
    ranges = {e.key: e for e in avg
              if e.device_type == DeviceType.CPU and e.key in TRAIN_RANGES}
    require(set(ranges) == set(TRAIN_RANGES),
            f"{what}: the profiler holds the ranges {sorted(ranges)}")
    dev = {k: e.device_time_total / 1e3 for k, e in ranges.items()}
    host = {k: e.cpu_time_total / 1e3 for k, e in ranges.items()}
    flash_bwd = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA
                    and "capsim_fa_bwd::" in e.key) / 1e3
    parts = {"forward": dev["train/forward"],
             "backward": 1e3 * busy - dev["train/forward"]
             - dev["train/update"],
             "of which flash backward": flash_bwd,
             "update": dev["train/update"]}
    require(parts["forward"] > 0 and parts["update"] > 0
            and parts["of which flash backward"] > 0,
            f"{what}: a part holds no device time {parts}")
    print(f"{what} split (device ms of the kernels each part launched): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"; busy {1e3 * busy:.2f}, the flash backward "
          f"{parts['of which flash backward'] / (1e3 * busy):.3f} of it; "
          "host ms in each range: "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    return parts


def check_train_capsim(torch, fa_ops, wa_ops):
    """CAPSim training at full width (``get_config("capsim")`` in f32 as
    ``launch/train.py::_capsim_cfg`` builds it) on TRAIN_DATA's clips:
    the card against the CPU from the same init over the same 3 batches
    of TRAIN_BATCH (the first gradient of every leaf nonzero and finite
    on the card, <= GRAD_TOL relative norm; the parameters after 3 SGD-
    momentum steps <= 1e-4 relative); then ``launch/train.py``'s
    ``train_capsim`` for TRAIN_STEPS steps through ResilientTrainer and
    CheckpointManager (every launch counter reset just before, read just
    after), and its restart, which resumes at the last step with the
    state bitwise the saved one; one step cut at its parts and under the
    profiler; a throughput row at TRAIN_BIG_BATCH.  Returns the trainer's
    run's launches by kernel (flash, embedding gradient)."""
    import argparse
    import tempfile
    from repro_torch.core import predictor
    from repro_torch.core.standardize import build_vocab
    from repro_torch.data.dataset import (BuildConfig, batches,
                                          build_dataset, split_dataset)
    from repro_torch.isa.progen import TABLE_II
    from repro_torch.kernels.embedding import ops as emb_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.optimizer import tree_leaves

    n_bench, interval, ckpts = TRAIN_DATA
    vocab = build_vocab()
    t0 = time.perf_counter()
    ds = build_dataset(list(TABLE_II)[:n_bench], BuildConfig(
        interval_size=interval, warmup=interval // 10,
        max_checkpoints=ckpts), vocab)
    build_s = time.perf_counter() - t0
    train_ds, val_ds, _ = split_dataset(ds)
    cfg = train_mod._capsim_cfg(argparse.Namespace(smoke=False), vocab)
    print(f"train capsim data: {n_bench} Table II benchmarks x {ckpts} "
          f"checkpoints of {interval} instructions: {len(ds)} clips "
          f"(train {len(train_ds)}, val {len(val_ds)}) built in {build_s:.2f}"
          f" s on the host; config d_model={cfg.d_model} heads="
          f"{cfg.num_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size} M={cfg.context_tokens} {cfg.dtype}")

    # card vs CPU: first gradients, then 3 steps
    def loss_fn(p, b):
        return predictor.mape_loss(p, b, cfg)
    tcfg = ttl.TrainConfig(optimizer="sgdm", base_lr=1e-3, warmup_steps=0,
                           total_steps=3)
    step = ttl.make_train_step(loss_fn, tcfg)
    p_cpu = predictor.init_params(cfg, seed=0, device="cpu")
    p_card = _to(p_cpu, "cuda")
    three = [{k: torch.from_numpy(v) for k, v in b.items()}
             for b, _ in zip(batches(train_ds, TRAIN_BATCH), range(3))]
    (l_card, _), g_card = ttl.value_and_grad(loss_fn, p_card,
                                             _to(three[0], "cuda"))
    (l_cpu, _), g_cpu = ttl.value_and_grad(loss_fn, p_cpu, three[0])
    g_errs, zero = [], []
    for (name, a), b in zip(_named(g_card), tree_leaves(g_cpu)):
        require(bool(torch.isfinite(a).all()), f"capsim grad {name} finite")
        if not bool((a != 0).any()):
            zero.append(name)
        g_errs.append((rel_norm_err(a.cpu(), b), name))
    print(f"train capsim card vs CPU: loss {float(l_card):.7f} / "
          f"{float(l_cpu):.7f}; first gradient, {len(g_errs)} leaves, "
          f"worst rel norm {max(g_errs)[0]:.3e} ({max(g_errs)[1]}); leaves "
          f"with an all-zero gradient on the card: {zero}")
    require(not zero, f"capsim: leaves without a gradient on the card {zero}")
    require(max(g_errs)[0] <= GRAD_TOL, f"capsim first gradient {max(g_errs)}")
    s_card = ttl.init_train_state(p_card, tcfg)
    s_cpu = ttl.init_train_state(p_cpu, tcfg)
    for b in three:
        s_card, m_card = step(s_card, _to(b, "cuda"))
        s_cpu, m_cpu = step(s_cpu, b)
    worst, moved = 0.0, []
    for a, b, p0 in zip(tree_leaves(s_card["params"]),
                        tree_leaves(s_cpu["params"]), tree_leaves(p_cpu)):
        a = a.cpu()
        worst = max(worst, float((a - b).abs().max()
                                 / b.abs().max().clamp(min=1e-30)))
        moved.append(rel_norm_err(a - p0, b - p0))
    print(f"train capsim card vs CPU after 3 sgdm steps: parameters worst "
          f"rel {worst:.3e}; the updates' worst rel norm {max(moved):.3e}; "
          f"mape {float(m_card['loss']):.6f} / {float(m_cpu['loss']):.6f}")
    require(worst <= 1e-4, f"capsim 3 steps: parameters rel {worst}")
    del p_cpu, g_cpu, s_cpu

    # the trainer's run through the launcher, then its restart
    with tempfile.TemporaryDirectory() as tmp:
        args = train_mod.parse_args([
            "--device", "cuda", "--n-benchmarks", str(n_bench),
            "--interval-size", str(interval), "--max-checkpoints",
            str(ckpts), "--steps", str(TRAIN_STEPS),
            "--batch-size", str(TRAIN_BATCH), "--save-every",
            str(TRAIN_SAVE_EVERY), "--ckpt-dir", tmp])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recorded_steps(torch, train_mod, TRAIN_STEPS) as seen:
            fa_ops.flash_attention.launches = 0
            wa_ops.weighted_attention.launches = 0
            emb_ops.embedding_grad.launches = 0
            fa_ops.flash_attention_bwd.launches = 0
            t0 = time.perf_counter()
            state = train_mod.train_capsim(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = (fa_ops.flash_attention.launches,
                 wa_ops.weighted_attention.launches,
                 emb_ops.embedding_grad.launches,
                 fa_ops.flash_attention_bwd.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        mape = [float(loss) for loss in seen["losses"]]
        sps = steps_per_s(seen)
        n_eval = -(-len(val_ds) // TRAIN_BATCH)
        # a train step's forward runs again in its backward under remat;
        # its backward launches the embedding gradient once a gather: the
        # instruction encoder's passes and the context (validation: none)
        per_step = 12 * (2 if cfg.remat else 1)
        expect = (per_step * TRAIN_STEPS + 12 * n_eval, 0,
                  TRAIN_STEPS * emb_per_step(TRAIN_BATCH),
                  TRAIN_STEPS * bwd_per_step(TRAIN_BATCH))
        print(f"train capsim launcher: {len(mape)} steps in {wall:.2f} s "
              f"(data build and validation included); {sps:.2f} steps/s = "
              f"{sps * TRAIN_BATCH:.1f} clips/s (checkpoints every "
              f"{TRAIN_SAVE_EVERY} included); peak {peak:.2f} GiB; launches "
              f"flash={n[0]} weighted={n[1]} embedding_grad={n[2]} "
              f"flash_bwd={n[3]} (expected {expect}: 4 + 8 flash a "
              f"forward, twice a step with remat={cfg.remat}, {n_eval} "
              f"validation batches; {emb_per_step(TRAIN_BATCH)} embedding "
              f"gradients and {bwd_per_step(TRAIN_BATCH)} flash backwards "
              "a step)")
        require(n == expect and len(mape) == TRAIN_STEPS,
                f"capsim training launches {n} / steps {len(mape)}")
        require(all(math.isfinite(x) for x in mape), "capsim: non-finite MAPE")
        print("train capsim mape first 20: "
              + " ".join(f"{x:.4f}" for x in mape[:20]))
        print("train capsim mape last 20: "
              + " ".join(f"{x:.4f}" for x in mape[-20:]))
        saved, at = train_mod.CheckpointManager(tmp).restore_latest(
            state, device="cuda")
        with recorded_steps(torch, train_mod, 1) as again:
            resumed = train_mod.train_capsim(args)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(resumed), tree_leaves(state))) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(saved),
                                              tree_leaves(state)))
        print(f"train capsim restart: resumed at step {at} "
              f"(state step {int(resumed['step'])}), {len(again['losses'])} steps "
              f"run, state bitwise the saved one: {same}")
        require(at == TRAIN_STEPS and not again["losses"] and same
                and int(resumed["step"]) == TRAIN_STEPS,
                "capsim restart did not resume at the saved state")

    # one step under the profiler, cut at its parts
    batch = _to({k: torch.from_numpy(v) for k, v in next(
        batches(train_ds, TRAIN_BATCH, seed=1)).items()}, "cuda")
    tcfg = ttl.TrainConfig(optimizer="sgdm", base_lr=1e-3,
                           warmup_steps=20, total_steps=TRAIN_STEPS)
    step = ttl.make_train_step(loss_fn, tcfg)
    step(state, batch)                                          # warm
    train_step_split(torch, lambda: step(state, batch),
                     f"train capsim step (batch {TRAIN_BATCH})")

    # throughput at the larger batch
    big = [_to({k: torch.from_numpy(v) for k, v in b.items()}, "cuda")
           for b, _ in zip(batches(train_ds, TRAIN_BIG_BATCH, epochs=10),
                           range(TRAIN_BIG_STEPS))]
    s = ttl.init_train_state(state["params"], tcfg)
    s, m = step(s, big[0])                                       # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_bwd = fa_ops.flash_attention_bwd.launches
    t0 = time.perf_counter()
    for b in big[1:]:
        s, m = step(s, b)
    float(m["loss"])
    dt = time.perf_counter() - t0
    n_bwd = fa_ops.flash_attention_bwd.launches - n_bwd
    print(f"train capsim batch {TRAIN_BIG_BATCH}: flash backward launches "
          f"{n_bwd} over {len(big) - 1} steps (expected "
          f"{bwd_per_step(TRAIN_BIG_BATCH)} a step)")
    require(n_bwd == (len(big) - 1) * bwd_per_step(TRAIN_BIG_BATCH),
            f"flash backward launches at batch {TRAIN_BIG_BATCH}: {n_bwd}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    sps = (len(big) - 1) / dt
    print(f"train capsim batch {TRAIN_BIG_BATCH}: {sps:.2f} steps/s = "
          f"{sps * TRAIN_BIG_BATCH:.1f} clips/s over {len(big) - 1} steps, "
          f"peak {peak:.2f} GiB")
    train_step_split(torch, lambda: step(s, big[0]),
                     f"train capsim step (batch {TRAIN_BIG_BATCH})")
    del state, s, big, batch
    torch.cuda.empty_cache()
    return {"flash_attention": n[0], "embedding_grad": n[2]}


def check_train_multicore(torch, fa_ops, wa_ops):
    """``launch/train.py``'s ``train_capsim_multicore`` on TRAIN_MC_CORES
    cores at TRAIN_MC_INTERVAL for TRAIN_MC_STEPS steps, at context width
    369 and with ``--peer-channels`` (4 x 369 rows), each with the launch
    counters reset just before and read just after: finite losses, the
    flash launches exactly 12 a forward (4 instruction-encoder layers in
    one pass of 4096 rows, 4 block layers of self and cross attention),
    a train step's twice under the config's remat, over the steps and
    the validation and held-out batches, and the embedding gradient's
    ``emb_per_step`` a step; steps/s.  Returns the launches by kernel
    (flash, embedding gradient)."""
    import tempfile
    from repro_torch.core.standardize import build_vocab
    from repro_torch.data.dataset import split_dataset
    from repro_torch.data.multicore_dataset import (MulticoreBuildConfig,
                                                    build_multicore_dataset)
    from repro_torch.isa.multicore import MULTICORE_NAMES
    from repro_torch.kernels.embedding import ops as emb_ops
    from repro_torch.launch import train as train_mod

    total = {"flash_attention": 0, "embedding_grad": 0}
    for peer in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--device", "cuda", "--multicore", str(TRAIN_MC_CORES),
                    "--interval-size",
                    str(TRAIN_MC_INTERVAL), "--steps", str(TRAIN_MC_STEPS),
                    "--batch-size", str(TRAIN_BATCH), "--ckpt-dir", tmp]
            args = train_mod.parse_args(argv + (["--peer-channels"]
                                                if peer else []))
            # the launcher's data, built here too to count its batches
            _, val, test = split_dataset(build_multicore_dataset(
                list(MULTICORE_NAMES)[:args.n_benchmarks],
                MulticoreBuildConfig(
                    interval_size=args.interval_size,
                    warmup=args.interval_size // 10,
                    max_checkpoints=args.max_checkpoints,
                    n_cores=args.multicore, peer_channels=peer),
                build_vocab()))
            n_eval = sum(-(-len(d) // TRAIN_BATCH) for d in (val, test))
            remat = train_mod._capsim_cfg(args, build_vocab()).remat
            expect = (12 * (2 if remat else 1) * TRAIN_MC_STEPS
                      + 12 * n_eval, 0,
                      TRAIN_MC_STEPS * emb_per_step(TRAIN_BATCH),
                      TRAIN_MC_STEPS * bwd_per_step(TRAIN_BATCH))
            torch.cuda.reset_peak_memory_stats()
            with recorded_steps(torch, train_mod, TRAIN_MC_STEPS) as seen:
                fa_ops.flash_attention.launches = 0
                wa_ops.weighted_attention.launches = 0
                emb_ops.embedding_grad.launches = 0
                fa_ops.flash_attention_bwd.launches = 0
                t0 = time.perf_counter()
                train_mod.train_capsim_multicore(args)
                wall = time.perf_counter() - t0
                n = (fa_ops.flash_attention.launches,
                     wa_ops.weighted_attention.launches,
                     emb_ops.embedding_grad.launches,
                     fa_ops.flash_attention_bwd.launches)
            losses = [float(loss) for loss in seen["losses"]]
            sps = steps_per_s(seen)
        width = 369 * (TRAIN_MC_CORES if peer else 1)
        print(f"train multicore {TRAIN_MC_CORES} cores context width "
              f"{width} (peer_channels={peer}): {len(losses)} steps, "
              f"{sps:.2f} steps/s = {sps * TRAIN_BATCH:.1f} clips/s, wall "
              f"{wall:.2f} s (build and eval included), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches flash={n[0]} weighted={n[1]} embedding_grad={n[2]} "
              f"flash_bwd={n[3]} (expected {expect}: {n_eval} validation "
              f"and held-out batches); mape "
              f"first/last {losses[0]:.4f} / {losses[-1]:.4f}")
        require(len(losses) == TRAIN_MC_STEPS and n == expect
                and all(math.isfinite(x) for x in losses),
                f"multicore training (peer {peer}): steps {len(losses)}, "
                f"launches {n} (expected {expect}), losses {losses}")
        total["flash_attention"] += n[0]
        total["embedding_grad"] += n[2]
    torch.cuda.empty_cache()
    return total


def check_train_lm(torch, fa_ops, wa_ops, ssd_ops):
    """Each of LM_TRAIN_RUNS at full width, cut in depth, in its config
    dtype: LM_TRAIN_STEPS AdamW steps on one batch of LM_TRAIN_BATCH x
    LM_TRAIN_SEQ (the launcher's optimizer), the launch counters reset
    just before and read just after (one flash launch per attention layer
    and one SSD launch per SSM layer a forward, two with the config's
    remat); the first gradient of
    every leaf finite and nonzero; the loss finite and falling;
    tokens/s, peak memory and a profiled step.  Then the card against
    the CPU for one f32 gradient at LM_GATE_SEQ: the loss <= 1e-5
    relative, each leaf <= GRAD_TOL relative norm.  Returns (flash, SSD)
    launches."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.optimizer import tree_leaves

    flash = ssd = 0
    for arch, layers in LM_TRAIN_RUNS:
        cfg = get_config(arch).replace(num_layers=layers)
        mixers = [m for m, _ in cfg.pattern()] * cfg.num_repeats
        B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
        params = tfm.init_params(cfg, seed=0, device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        batch = random_batch(cfg, ShapeConfig("train", S, B, "train"),
                             "train", seed=0, device="cuda")

        def loss_fn(p, b):
            return tfm.loss_fn(p, b, cfg)
        (_, _), grads = ttl.value_and_grad(loss_fn, params, batch)
        zero = [name for name, g in _named(grads)
                if not bool((g != 0).any()) or not bool(
                    torch.isfinite(g).all())]
        require(not zero, f"{arch}: leaves with a zero or non-finite "
                f"gradient {zero}")
        del grads
        tcfg = ttl.TrainConfig(optimizer="adamw", base_lr=1e-3,
                               warmup_steps=0, total_steps=LM_TRAIN_STEPS)
        step = ttl.make_train_step(loss_fn, tcfg)
        state = ttl.init_train_state(params, tcfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        ssd_ops.ssd_scan.launches = 0
        losses, times = [], []
        for _ in range(LM_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        n = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches,
             wa_ops.weighted_attention.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the forward runs again in the backward under remat
        runs = LM_TRAIN_STEPS * (2 if cfg.remat else 1)
        expect = (runs * mixers.count("attn"), runs * mixers.count("ssm"),
                  0)
        # the first step warms the allocator; each step ends synchronized
        # (its loss read)
        tok_s = B * S * len(times[1:]) / sum(times[1:])
        print(f"train lm {arch} ({layers} of {get_config(arch).num_layers} "
              f"layers, full width, {cfg.dtype}, {n_params} params) batch "
              f"{B} x {S}: losses " + " ".join(f"{x:.4f}" for x in losses)
              + f"; step s " + " ".join(f"{x:.3f}" for x in times)
              + f"; {tok_s:.1f} tokens/s (steps 2-{LM_TRAIN_STEPS}); peak "
              f"{peak:.2f} GiB; launches flash={n[0]} ssd={n[1]} "
              f"weighted={n[2]} (expected {expect}); every leaf's first "
              "gradient finite and nonzero")
        require(n == expect, f"{arch} training launches {n}, expected "
                f"{expect}")
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0], f"{arch}: losses {losses}")
        flash += n[0]
        ssd += n[1]
        _, *prof = device_profile(torch, lambda: step(state, batch))
        print_profile(f"train lm {arch} step", *prof)
        del params, state, batch, prof
        torch.cuda.empty_cache()

        # f32 card vs CPU
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        batch = random_batch(cfg32, ShapeConfig("gate", LM_GATE_SEQ, 1,
                                                "train"), "train", seed=1,
                             device="cpu")
        p_cpu = tfm.init_params(cfg32, seed=0, device="cpu")
        p_card = tfm.init_params(cfg32, seed=0, device="cuda")

        def loss32(p, b):
            return tfm.loss_fn(p, b, cfg32)
        (l_card, _), g_card = ttl.value_and_grad(loss32, p_card,
                                                 _to(batch, "cuda"))
        (l_cpu, _), g_cpu = ttl.value_and_grad(loss32, p_cpu, batch)
        errs = [(rel_norm_err(a.cpu(), b), name) for (name, a), b in zip(
            _named(g_card), tree_leaves(g_cpu))]
        loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        print(f"train lm {arch} f32 card vs CPU, 1 x {LM_GATE_SEQ}: loss "
              f"{float(l_card):.6f} / {float(l_cpu):.6f} (rel {loss_rel:.3e})"
              f"; gradients, {len(errs)} leaves, worst rel norm "
              f"{max(errs)[0]:.3e} ({max(errs)[1]})")
        require(loss_rel <= 1e-5 and max(errs)[0] <= GRAD_TOL,
                f"{arch} f32 card vs CPU: loss {loss_rel}, {max(errs)}")
        del p_cpu, p_card, g_card, g_cpu
        torch.cuda.empty_cache()
    return flash, ssd


DIST_STORE = "dist.store"


def dist_capsim_cfg():
    """The CAPSim predictor at full width in f32, as ``launch/train.py``
    builds it."""
    import argparse
    from repro_torch.core.standardize import build_vocab
    from repro_torch.launch import train as train_mod
    return train_mod._capsim_cfg(argparse.Namespace(smoke=False),
                                 build_vocab())


def dist_capsim_batch(torch, cfg, step: int, device):
    """Global batch ``step`` of the data-parallel CAPSim runs: DIST_BATCH
    clips of DIST_CLIP instructions with <PAD> tails, drawn from a numpy
    seed (every rank draws the same)."""
    import numpy as np
    rng = np.random.RandomState(100 + step)
    V, T, B, L = cfg.vocab_size, cfg.clip_tokens, DIST_BATCH, DIST_CLIP
    tok = rng.randint(1, V, (B, L, T))
    tok[np.arange(T) >= rng.randint(2, T + 1, (B, L))[..., None]] = 0
    batch = {"clip_tokens": tok,
             "context_tokens": rng.randint(1, V, (B, cfg.context_tokens)),
             "clip_mask": np.ones((B, L), np.float32),
             "time": rng.uniform(50.0, 5000.0, B).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def dist_capsim_run(torch, cfg, mesh, device):
    """DIST_STEPS SGD-momentum steps of the CAPSim trainer from seed 0 on
    the global batches, under ``LOGICAL_RULES_PREDICTOR`` on ``mesh``
    (None: no mesh).  Returns (losses, final state)."""
    from repro_torch.core import predictor
    from repro_torch.distributed.sharding import (LOGICAL_RULES_PREDICTOR,
                                                  use_mesh_and_rules)
    from repro_torch.training import train_loop as ttl
    tcfg = ttl.TrainConfig(optimizer="sgdm", base_lr=1e-3, warmup_steps=2,
                           total_steps=DIST_STEPS)
    state = ttl.init_train_state(predictor.init_params(cfg, seed=0,
                                                       device=device), tcfg)
    step = ttl.make_train_step(
        lambda p, b: predictor.mape_loss(p, b, cfg), tcfg)
    losses = []
    with use_mesh_and_rules(mesh, LOGICAL_RULES_PREDICTOR):
        for i in range(DIST_STEPS):
            state, m = step(state, dist_capsim_batch(torch, cfg, i, device))
            losses.append(m["loss"])
    return [float(x) for x in losses], state


def dist_gloo_child() -> int:
    """One rank of the 2-rank CAPSim trainer on the one card over gloo
    (``check_dist`` starts two): first whether gloo takes a CUDA tensor
    for ``all_reduce`` (if not, it says so and stops), then the run;
    rank 0 writes the losses."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import make_mesh
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=os.environ["INIT"],
                            rank=rank, world_size=2)
    try:
        t = torch.ones(4, device="cuda")
        try:
            dist.all_reduce(t)
        except RuntimeError as e:
            print(f"GLOO_NO_CUDA {str(e).splitlines()[0]}")
            return 0
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = make_mesh((2, 1), ("data", "model"), "cuda:0")
        losses, _ = dist_capsim_run(torch, dist_capsim_cfg(), mesh,
                                    mesh.device)
        if rank == 0:
            print("LOSSES " + json.dumps(losses))
        return 0
    finally:
        dist.destroy_process_group()


def dist_gloo_on_one_card(ref_losses):
    """The 2-rank gloo run in two processes on the one card; its losses
    against the 1-rank run's (<= DIST_LOSS_TOL relative), or one line
    saying why it did not run."""
    import os
    store = ROOT / "build" / "dist_gloo.store"
    store.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke; sys.exit(chip_smoke.dist_gloo_child())")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "INIT": f"file://{store}"})
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(all(p.returncode == 0 for p in procs),
            "dist gloo ranks failed:\n" + "\n".join(o[-2000:] for o in outs))
    if "GLOO_NO_CUDA" in outs[0]:
        why = outs[0].split("GLOO_NO_CUDA", 1)[1].strip().splitlines()[0]
        print(f"dist dp capsim 2 ranks gloo on one card: not run (gloo "
              f"here does not all_reduce a CUDA tensor: {why})")
        return
    losses = json.loads(outs[0].split("LOSSES ", 1)[1].splitlines()[0])
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    print(f"dist dp capsim 2 ranks gloo on one card ({DIST_BATCH // 2} "
          f"clips a rank): {len(losses)} steps in "
          f"{time.perf_counter() - t0:.1f} s (both processes' start "
          f"included); loss per step vs 1 rank max rel gap {gap:.3e} "
          f"(<= {DIST_LOSS_TOL}); last loss {losses[-1]:.6f}")
    require(gap <= DIST_LOSS_TOL, f"dist gloo losses off by {gap}")


def dist_world_one(torch, fa_ops, mesh):
    """(a) and (c) at world size 1 over NCCL: qwen3-4b whole with
    ``attn_impl="sp"`` and llama4-maverick's super-block through
    ``generate`` under ``make_test_mesh()`` and ``LOGICAL_RULES_DECODE``
    (the MoE layers on the expert-parallel path over one shard) against
    their meshless runs, bitwise; the CAPSim DP trainer the same way.
    Returns the flash launches of these runs."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import (LOGICAL_RULES_DECODE,
                                                  use_mesh_and_rules)
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    total = 0
    ep_calls = [0]
    local_experts = moe_mod.local_experts

    def counted_experts(*a, **kw):
        ep_calls[0] += 1
        return local_experts(*a, **kw)
    moe_mod.local_experts = counted_experts
    try:
        for arch, layers, B, S in DIST_LM_RUNS:
            cfg = moe_cfg(get_config, arch, layers)
            t0 = time.perf_counter()
            params = tfm.init_params(cfg, seed=0, device="cuda")
            batch = random_batch(cfg, ShapeConfig(f"prefill_{S}", S, B,
                                                  "prefill"), "prefill",
                                 seed=0, device="cuda")
            generate(params, cfg, {"tokens": batch["tokens"][:1, :256]}, 1)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            # in turns (meshless, mesh, mesh, meshless): the host-bound
            # decode rate drifts between runs of one call
            runs = []
            for what in DIST_ORDER:
                rules = LOGICAL_RULES_DECODE if what == "mesh" else None
                run_cfg = cfg.replace(attn_impl="sp") if rules else cfg
                ep_calls[0] = 0
                fa_ops.flash_attention.launches = 0
                with use_mesh_and_rules(mesh if rules else None, rules):
                    g = generate(params, run_cfg, batch, DIST_DECODE)
                n = fa_ops.flash_attention.launches
                total += n
                runs.append((what, g, n, ep_calls[0]))
            g0 = runs[0][1]
            same = all(torch.equal(g.logits, g0.logits)
                       and torch.equal(g.tokens, g0.tokens)
                       for _, g, _, _ in runs)
            n_attn = sum(m == "attn" for m, _ in cfg.pattern()) \
                * cfg.num_repeats
            n_moe = sum(f == "moe" for _, f in cfg.pattern()) \
                * cfg.num_repeats

            def rate(side, key):
                vals = [getattr(g, key) for w, g, _, _ in runs if w == side]
                return sum(vals) / len(vals)
            launches = {(w, n) for w, _, n, _ in runs}
            calls = {(w, e) for w, _, _, e in runs}
            print(f"dist world1 {arch} ({cfg.num_layers} layers, bf16, B={B}"
                  f" x {S} + {DIST_DECODE} decode steps; init + warm-up "
                  f"{init_s:.1f} s): mesh {mesh.shape} attn_impl=sp under "
                  f"LOGICAL_RULES_DECODE vs meshless, runs "
                  f"{'/'.join(DIST_ORDER)}: bitwise={same} (logits and "
                  f"tokens of every run); flash launches "
                  f"{sorted(launches)} (expected {n_attn} a run); "
                  f"expert-parallel layer calls {sorted(calls)} (expected "
                  f"{n_moe * (1 + DIST_DECODE)} a mesh run); prefill s "
                  f"mesh / meshless {rate('mesh', 'prefill_seconds'):.4f} / "
                  f"{rate('meshless', 'prefill_seconds'):.4f}; decode "
                  f"ms/step each run " + ", ".join(
                      f"{w} {1e3 * g.decode_seconds / DIST_DECODE:.3f}"
                      for w, g, _, _ in runs))
            require(same, f"dist world1 {arch}: mesh run not bitwise")
            require(all(n == n_attn for _, n in launches),
                    f"dist world1 {arch}: flash launches {launches}, "
                    f"expected {n_attn}")
            require(calls == {("mesh", n_moe * (1 + DIST_DECODE)),
                              ("meshless", 0)},
                    f"dist world1 {arch}: expert-parallel calls {calls}")
            del g, g0
            del params, batch, runs
            torch.cuda.empty_cache()
    finally:
        moe_mod.local_experts = local_experts

    cfg = dist_capsim_cfg()
    fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    l1, s1 = dist_capsim_run(torch, cfg, mesh, "cuda")
    t1 = time.perf_counter()
    n = fa_ops.flash_attention.launches
    total += n
    l0, s0 = dist_capsim_run(torch, cfg, None, "cuda")
    same = l0 == l1 and all(torch.equal(a, b) for a, b in
                            zip(_leaves(s0), _leaves(s1)))
    print(f"dist dp capsim world1 nccl (full width f32, batch {DIST_BATCH} "
          f"x {DIST_CLIP} instructions, {DIST_STEPS} steps, "
          f"LOGICAL_RULES_PREDICTOR): bitwise the single-process trainer="
          f"{same} (losses and state); flash launches {n} (12 a forward, "
          f"twice a step with remat={cfg.remat}); "
          f"{DIST_STEPS / (t1 - t0):.2f} steps/s; loss {l1[0]:.5f} -> "
          f"{l1[-1]:.5f}")
    require(same, "dist dp capsim world1: not bitwise")
    require(n == 12 * (2 if cfg.remat else 1) * DIST_STEPS,
            f"dist dp capsim: {n} flash launches")
    dist_gloo_on_one_card(l1)
    return total


def dist_shards(torch, fa_ops):
    """(b) One process, n shards on the one card at full width: each
    sequence-parallel shard of qwen3-4b's prefill attention (the flash
    kernel at Sq = S/n, Skv = (m+1)·S/n) against its plain version and
    the full causal output's rows, timed beside SDPA with a lower-right
    causal mask and the bound; flash-decoding merged over n shards
    against ``decode_attention``; llama4's 128 experts over n model
    shards.  Returns (flash launches, timing rows, {dtype: max err})."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import init_from_seed

    B, S, H, KV, D = DIST_SP
    G = H // KV
    gen = torch.Generator(device="cuda").manual_seed(21)
    launches, rows, errs = 0, [], {}
    for dtype in ("bfloat16", "float32"):
        tdt, tol = getattr(torch, dtype), (BF16_TOL if dtype == "bfloat16"
                                           else F32_TOL)
        q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=tdt)
        k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda",
                            dtype=tdt) for _ in range(2))
        full = att.causal_attention(q, k, v)
        errs[dtype] = 0.0
        if dtype == "bfloat16":
            # the unsharded run in this call: the shards' yardstick
            qb, kf, vf = (q, k.repeat_interleave(G, 2),
                          v.repeat_interleave(G, 2))
            full_ms = cuda_ms(torch, lambda: fa_ops.flash_attention(
                qb, kf, vf, causal=True), iters=10)
            qt, kt, vt = (t.transpose(1, 2) for t in (qb, kf, vf))
            row = {"shape": "sp_full", "dtype": dtype, "ms": full_ms,
                   "plain_ms": None,
                   "library_ms": cuda_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True), iters=10)}
            row["bound_ms"], row["bound_by"] = bound(B, S, S, H, D, dtype,
                                                     False, causal=True)
            rows.append(row)
            print(f"dist sp {dtype} unsharded: flash kernel at Sq=Skv={S} "
                  f"(B={B} H={H} D={D}, causal) kernel_ms={full_ms:.4f} "
                  f"library_ms={row['library_ms']:.4f} (sdpa is_causal) "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
            del qt, kt, vt, kf, vf
        for n in DIST_SP_SHARDS:
            s_loc = S // n
            fa_ops.flash_attention.launches = 0
            outs = att.sp_shards(q, k, v, n)
            got = fa_ops.flash_attention.launches
            launches += got
            require(got == n, f"dist sp n={n}: {got} flash launches")
            for m, o in enumerate(outs):
                rows_m = slice(m * s_loc, (m + 1) * s_loc)
                kv = (m + 1) * s_loc
                qm = q[:, rows_m]
                kb, vb = (t[:, :kv].repeat_interleave(G, 2) for t in (k, v))
                plain = fa_ops.flash_attention_plain(qm, kb, vb, causal=True)
                err = (o.float() - plain.float()).abs().max().item()
                gap = (o.float() - full[:, rows_m].float()).abs().max().item()
                same = bool(torch.equal(o, full[:, rows_m]))
                errs[dtype] = max(errs[dtype], err)
                line = (f"dist sp {dtype} n={n} shard {m}: flash kernel at "
                        f"Sq={s_loc} Skv={kv} (B={B} H={H} D={D}, causal, q "
                        f"offset {m * s_loc}) vs plain max abs {err:.3e} "
                        f"(<= {tol}); vs the full causal output's rows "
                        f"{gap:.3e}, bitwise={same}")
                require(err <= tol and gap <= tol, line)
                if dtype == "bfloat16":
                    kt, vt, qt = (t.transpose(1, 2) for t in (kb, vb, qm))
                    mask = causal_lower_right(s_loc, kv)
                    qc = qm.contiguous()
                    row = {"shape": f"sp{n}_shard{m}", "dtype": dtype,
                           "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                               qm, kb, vb, causal=True), iters=10),
                           "contiguous_q_ms": cuda_ms(
                               torch, lambda: fa_ops.flash_attention(
                                   qc, kb, vb, causal=True), iters=10),
                           "shard_ms": cuda_ms(torch, lambda:
                                               att.sp_shard_attention(
                                                   qm, k, v, m), iters=10),
                           "plain_ms": cuda_ms(
                               torch, lambda: fa_ops.flash_attention_plain(
                                   qm, kb, vb, causal=True),
                               iters=3, warmup=1, rounds=2),
                           "library_ms": cuda_ms(
                               torch, lambda: F.scaled_dot_product_attention(
                                   qt, kt, vt, attn_mask=mask), iters=10)}
                    row["bound_ms"], row["bound_by"] = bound(
                        B, s_loc, kv, H, D, dtype, False, causal=True)
                    rows.append(row)
                    line += (f"; kernel_ms={row['ms']:.4f} (q a contiguous "
                             f"copy: {row['contiguous_q_ms']:.4f}) "
                             f"shard_ms (K/V "
                             f"repeat included)={row['shard_ms']:.4f} "
                             f"plain_ms={row['plain_ms']:.4f} library_ms="
                             f"{row['library_ms']:.4f} (sdpa lower-right "
                             f"causal) bound_ms={row['bound_ms']:.4f} "
                             f"({row['bound_by']})")
                    del kt, vt, qt, qc
                print(line)
                del plain, kb, vb
            if dtype == "bfloat16":
                shard_ms = [r["ms"] for r in rows[-n:]]
                print(f"dist sp {dtype} n={n}: the shards' kernel ms sum "
                      f"{sum(shard_ms):.4f} = {sum(shard_ms) / full_ms:.3f} x "
                      f"the unsharded run's; each shard's share of the "
                      f"causal pairs (2m+1)/n^2 against its share of the "
                      f"time: " + ", ".join(
                          f"{(2 * m + 1) / n ** 2:.3f}/"
                          f"{t / sum(shard_ms):.3f}"
                          for m, t in enumerate(shard_ms)))
        del q, k, v, full, outs
        torch.cuda.empty_cache()

    B, H, KV, D = DIST_DECODE_SHAPE
    S_max = DIST_SP[1] + DIST_DECODE
    pos = S_max - 12
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda", dtype=tdt)
        kc, vc = (torch.randn(B, S_max, KV, D, generator=gen, device="cuda",
                              dtype=tdt) for _ in range(2))
        want = att.decode_attention(q, kc, vc, pos).float()
        for n in DIST_DECODE_SHARDS:
            got = att.flash_decode_shards(q, kc, vc, pos, n).float()
            gap = (got - want).abs().max().item()
            print(f"dist decode {dtype} n={n}: merged shards of "
                  f"{S_max // n} positions (B={B} H={H} KV={KV} D={D}, "
                  f"cache_pos {pos}) vs decode_attention max abs {gap:.3e}"
                  + (f" (<= {DIST_DECODE_TOL})" if dtype == "float32"
                     else " (reported)"))
            if dtype == "float32":
                require(gap <= DIST_DECODE_TOL, f"dist decode n={n}: {gap}")
        del q, kc, vc

    cfg = get_config("llama4-maverick-400b-a17b")
    t0 = time.perf_counter()
    params = init_from_seed(moe_mod.moe_specs(cfg), 0, cfg.param_dtype,
                            torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"dist moe llama4 layer: {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token} d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"bf16 (f32 weights would hold 64 GB), init "
          f"{time.perf_counter() - t0:.2f} s on the card")
    dt = params["w_up"].dtype
    x = torch.randn(1, DIST_MOE_TOKENS, cfg.d_model, generator=gen,
                    device="cuda", dtype=dt)
    wide = cfg.replace(capacity_factor=float(cfg.num_experts))
    y0, _, _ = moe_mod.moe_forward(params, x, wide)
    ref = moe_mod.route(params["router"], x.reshape(-1, cfg.d_model),
                        cfg.experts_per_token, wide.capacity_factor)
    require(bool(ref.keep.all()), "dist moe: the wide capacity dropped")
    for n in DIST_MOE_SHARDS:
        parts = moe_mod.moe_shards(params, x, wide, n)
        y = sum(p.y for p in parts).reshape(x.shape)
        same_route = all(torch.equal(p.routing.idx, ref.idx) for p in parts)
        gap = ((y.float() - y0.float()).abs().max()
               / y0.float().abs().max()).item()
        print(f"dist moe n_model={n}: {cfg.num_experts // n} experts a "
              f"shard, {DIST_MOE_TOKENS} tokens, capacity factor "
              f"{wide.capacity_factor:g} (no drop): routing identical to "
              f"the meshless path={same_route}; y vs meshless max rel "
              f"{gap:.3e} (<= {DIST_MOE_TOL}), bitwise="
              f"{bool(torch.equal(y, y0))}")
        require(same_route and gap <= DIST_MOE_TOL, f"dist moe n={n}")
        del parts, y
    del x, y0
    x = torch.randn(MOE_BATCH, MOE_PROMPT, cfg.d_model, generator=gen,
                    device="cuda", dtype=dt)
    for n in (1,) + DIST_MOE_SHARDS:
        parts = moe_mod.moe_shards(params, x, cfg, n)
        keep = parts[0].routing.keep
        print(f"dist moe n_model={n} at the config's capacity factor "
              f"{cfg.capacity_factor} ({x.shape[0]} x {x.shape[1]} tokens, "
              f"capacity {parts[0].routing.cap} a expert): dropped share "
              f"{1 - keep.float().mean().item():.4f} (the capacity counts "
              "one device's tokens, B·S/dp with dp = 1 here, so every n "
              "drops the same pairs)")
        del parts
    del params, x
    torch.cuda.empty_cache()
    return launches, rows, errs


def check_dist(torch, fa_ops):
    """The LM zoo's multi-device paths (ROADMAP item 6b) on the one card:
    a process group of one rank over NCCL in this process with
    ``make_test_mesh()`` on it ((a) and (c) at world size 1, bitwise the
    meshless runs; the 2-rank CAPSim trainer over gloo in two processes
    on the card), then n shards of each body in one process at full
    width (b).  Returns (flash launches, flash timing rows, errs)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    store = ROOT / "build" / DIST_STORE
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh("cuda")
        print(f"dist group: backend {dist.get_backend()} world "
              f"{dist.get_world_size()}; make_test_mesh() {mesh.shape} "
              f"{mesh.axis_names} on {mesh.device}, device mesh "
              f"{mesh.device_mesh}")
        launches = dist_world_one(torch, fa_ops, mesh)
    finally:
        dist.destroy_process_group()
    n, rows, errs = dist_shards(torch, fa_ops)
    print(f"dist distinct cards: not run ({torch.cuda.device_count()} card "
          "visible; NCCL takes one rank a card)")
    return launches + n, rows, errs


# --------------------------------------------------------------------- #
# tp: GSPMD's weight layouts as per-rank blocks (ROADMAP item 6c)
# --------------------------------------------------------------------- #

def tp_cfg(arch, layers, experts, dtype=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if experts:
        cfg = cfg.replace(num_experts=experts)
    return cfg.replace(dtype=dtype, param_dtype=dtype) if dtype else cfg


def tp_tokens(torch, cfg, B: int, S: int):
    """A seeded prompt (the same on every rank and in the parent)."""
    gen = torch.Generator().manual_seed(41)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen)


def tp_generate(torch, cfg, mesh, rules, B, S, steps):
    """init_params (the rank's blocks on a mesh, whole without) and
    ``generate`` of a seeded prompt under ``rules``, the launch counters
    reset just before and read just after.  Returns (Generation, resident
    parameter bytes, (flash, SSD) launches, (flash, SSD) launches by the
    head count the wrapper was given)."""
    from repro_torch.distributed.sharding import use_mesh_and_rules
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm
    with use_mesh_and_rules(mesh, rules):
        params = tfm.init_params(cfg, seed=0, device="cuda", mesh=mesh)
        nbytes = sum(t.numel() * t.element_size() for _, t in _named(params))
        tok = tp_tokens(torch, cfg, B, S)
        generate(params, cfg, {"tokens": tok[:, :64]}, 1,
                 device="cuda")                                 # warm-up
        torch.cuda.synchronize()
        fa_ops.flash_attention.launches = 0
        ssd_ops.ssd_scan.launches = 0
        fa_ops.flash_attention.heads = {}
        ssd_ops.ssd_scan.heads = {}
        g = generate(params, cfg, {"tokens": tok}, steps, device="cuda")
        n = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches)
        heads = (dict(fa_ops.flash_attention.heads),
                 dict(ssd_ops.ssd_scan.heads))
    del params
    torch.cuda.empty_cache()
    return g, nbytes, n, heads


def tp_grads(torch, cfg, mesh, rules, B, S):
    """(loss, {leaf: whole gradient}, peak GiB) of ``loss_fn`` on a
    seeded batch through ``make_grad_fn`` under ``rules`` (the rank's
    blocks on a mesh, gathered after; the peak is the most the card
    held from the draw to the gradients, before that gather, above what
    it held before the draw)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop as ttl
    batch = random_batch(cfg, ShapeConfig("train", S, B, "train"), "train",
                         seed=7, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with sh.use_mesh_and_rules(mesh, rules):
        params = tfm.init_params(cfg, seed=1, device="cuda", mesh=mesh)
        loss, _, grads = ttl.make_grad_fn(
            lambda p, b: tfm.loss_fn(p, b, cfg), ttl.TrainConfig())(
                params, batch)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        if mesh is not None:
            grads = sh.gather_tree(sh.inherit_marks(grads, params))
    del params
    return float(loss), dict(_named(grads)), peak


def tp_child() -> int:
    """One of the two gloo ranks of the tp phase on the one card (the
    parent starts both): (a) the TP_RUNS and TP_GATES generate runs under
    LOGICAL_RULES_DECODE on mesh (1, 2), (b) the TP_TRAIN gradients under
    LOGICAL_RULES_TRAIN on (1, 2), then on (2, 1) with FSDP rows, each
    against the meshless gradient that rank 0 computes after; rank 0
    writes what the parent prints and checks to ``TP_OUT``."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed.sharding import (LOGICAL_RULES_DECODE,
                                                  LOGICAL_RULES_TRAIN)
    from repro_torch.launch.mesh import make_mesh
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=os.environ["INIT"],
                            rank=rank, world_size=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        mesh = make_mesh((1, 2), ("data", "model"), "cuda:0")
        for arch, layers, experts in TP_RUNS:
            cfg = tp_cfg(arch, layers, experts)
            t0 = time.perf_counter()
            g, nbytes, n, heads = tp_generate(torch, cfg, mesh,
                                              LOGICAL_RULES_DECODE, TP_BATCH,
                                              TP_PROMPT, TP_DECODE)
            per_rank = [None, None]
            dist.all_gather_object(per_rank, (nbytes, heads))
            out[f"run/{arch}"] = {
                "tokens": g.tokens.cpu(), "bytes": nbytes, "launches": n,
                "rank_bytes": [b for b, _ in per_rank],
                "rank_heads": [h for _, h in per_rank],
                "first": g.logits[:, 0].float().cpu(),
                "prefill_s": g.prefill_seconds,
                "decode_ms": 1e3 * g.decode_seconds / TP_DECODE,
                "seconds": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            torch.cuda.reset_peak_memory_stats()
        for arch, layers, experts in TP_GATES:
            cfg = tp_cfg(arch, layers, experts, "float32")
            g, nbytes, n, heads = tp_generate(torch, cfg, mesh,
                                              LOGICAL_RULES_DECODE, 1,
                                              TP_GATE_PROMPT, TP_GATE_DECODE)
            out[f"gate/{arch}"] = {"tokens": g.tokens.cpu(),
                                   "logits": g.logits.float().cpu(),
                                   "bytes": nbytes, "launches": n,
                                   "heads": heads}
        for where, m, B, S in (("tp", mesh, 1, TP_TRAIN_SEQ),
                               ("fsdp", None, TP_FSDP_BATCH, TP_FSDP_SEQ)):
            if m is None:
                m = make_mesh((2, 1), ("data", "model"), "cuda:0")
            for arch, layers in TP_TRAIN:
                for dtype in ("float32", "bfloat16"):
                    if where == "fsdp" and dtype == "bfloat16":
                        continue
                    cfg = tp_cfg(arch, layers, None, dtype)
                    loss, grads, peak = tp_grads(torch, cfg, m,
                                                 LOGICAL_RULES_TRAIN, B, S)
                    dist.barrier()
                    if rank == 0:
                        loss0, want, peak0 = tp_grads(torch, cfg, None, None,
                                                      B, S)
                        rel = {k: rel_norm_err(grads[k], want[k])
                               for k in want}
                        worst = max(rel, key=rel.get)
                        out[f"train/{where}/{arch}/{dtype}"] = {
                            "loss": loss, "meshless_loss": loss0,
                            "leaves": len(rel), "worst": worst,
                            "worst_rel": rel[worst], "peak_gib": peak,
                            "meshless_peak_gib": peak0}
                        del want
                    del grads
                    torch.cuda.empty_cache()
                    dist.barrier()
        if rank == 0:
            torch.save(out, os.environ["TP_OUT"])
        return 0
    finally:
        dist.destroy_process_group()


def tp_ranks(torch):
    """The two gloo ranks of ``tp_child`` in two processes on the card;
    returns what rank 0 wrote."""
    import os
    out = ROOT / "build" / "tp_ranks.pt"
    store = ROOT / "build" / TP_STORE
    store.parent.mkdir(parents=True, exist_ok=True)
    for f in (out, store):
        f.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke; sys.exit(chip_smoke.tp_child())")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "INIT": f"file://{store}",
             "TP_OUT": str(out)}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(all(p.returncode == 0 for p in procs),
            "tp ranks failed:\n" + "\n".join(o[-3000:] for o in outs))
    print(f"tp ranks: 2 gloo processes on the card, {time.perf_counter() - t0:.1f}"
          " s with their start")
    return torch.load(out)


def tp_meshless(torch):
    """The meshless runs the ranks are held to, in this process: each of
    TP_RUNS (bf16) and TP_GATES (f32) through ``generate``."""
    runs = {}
    for arch, layers, experts in TP_RUNS:
        cfg = tp_cfg(arch, layers, experts)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g, nbytes, n, heads = tp_generate(torch, cfg, None, None, TP_BATCH,
                                          TP_PROMPT, TP_DECODE)
        runs[f"run/{arch}"] = {
            "tokens": g.tokens.cpu(), "bytes": nbytes, "launches": n,
            "heads": heads,
            "first": g.logits[:, 0].float().cpu(),
            "prefill_s": g.prefill_seconds,
            "decode_ms": 1e3 * g.decode_seconds / TP_DECODE,
            "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    for arch, layers, experts in TP_GATES:
        cfg = tp_cfg(arch, layers, experts, "float32")
        g, nbytes, n, heads = tp_generate(torch, cfg, None, None, 1,
                                          TP_GATE_PROMPT, TP_GATE_DECODE)
        runs[f"gate/{arch}"] = {"tokens": g.tokens.cpu(),
                                "logits": g.logits.float().cpu(),
                                "bytes": nbytes, "launches": n,
                                "heads": heads}
    return runs


def tp_shards_check(torch, fa_ops, ssd_ops):
    """(c) n TP shards in one process at full width: the flash kernel at
    qwen3-4b's prefill with H/n query and KV/n KV heads and the SSD scan
    at Mamba2's and jamba's prefill shapes with H/n heads, each against
    its plain version (both dtypes), timed in bf16 beside 1/n of the
    unsharded kernel, SDPA (flash) and the bound; then each layer's n
    shards' row-parallel outputs summed (``attention.tp_shards``,
    ``mamba2.tp_shards``) against the unsharded layer in f32.  Returns
    ({kernel: timing rows}, {kernel: {dtype: max abs err}})."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.layers import init_from_seed

    rows = {"flash_attention": [], "ssd": []}
    errs = {"flash_attention": {}, "ssd": {}}
    gen = torch.Generator().manual_seed(43)
    B, S, H, KV, D = TP_FLASH
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
        q = torch.randn(B, S, H, D, generator=gen).to("cuda", tdt)
        k, v = (torch.randn(B, S, KV, D, generator=gen).to("cuda", tdt)
                for _ in range(2))
        full_ms = None
        if dtype == "bfloat16":
            kf, vf = (t.repeat_interleave(H // KV, 2) for t in (k, v))
            full_ms = cuda_ms(torch, lambda: fa_ops.flash_attention(
                q, kf, vf, causal=True), iters=10)
            del kf, vf
        errs["flash_attention"][dtype] = 0.0
        for n in TP_SHARDS:
            hl, kl = H // n, KV // n
            qs, ks, vs = q[:, :, :hl], k[:, :, :kl], v[:, :, :kl]
            kb, vb = (t.repeat_interleave(hl // kl, 2) for t in (ks, vs))
            o = fa_ops.flash_attention(qs, kb, vb, causal=True)
            plain = fa_ops.flash_attention_plain(qs, kb, vb, causal=True)
            err = (o.float() - plain.float()).abs().max().item()
            errs["flash_attention"][dtype] = max(
                errs["flash_attention"][dtype], err)
            line = (f"tp flash {dtype} n={n}: kernel at B={B} S={S} H={hl} "
                    f"(KV {kl} repeated) D={D} causal vs plain max abs "
                    f"{err:.3e} (<= {tol})")
            require(err <= tol, line)
            if dtype == "bfloat16":
                qt, kt, vt = (t.transpose(1, 2) for t in (qs, kb, vb))
                row = {"shape": f"tp{n}_qwen3_prefill", "dtype": dtype,
                       "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                           qs, kb, vb, causal=True), iters=10),
                       "plain_ms": cuda_ms(
                           torch, lambda: fa_ops.flash_attention_plain(
                               qs, kb, vb, causal=True),
                           iters=3, warmup=1, rounds=2),
                       "library_ms": cuda_ms(
                           torch, lambda: F.scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True), iters=10)}
                row["bound_ms"], row["bound_by"] = bound(B, S, S, hl, D,
                                                         dtype, False,
                                                         causal=True)
                rows["flash_attention"].append(row)
                line += (f"; kernel_ms={row['ms']:.4f} (unsharded "
                         f"{full_ms:.4f} / {n} = {full_ms / n:.4f}) "
                         f"plain_ms={row['plain_ms']:.4f} library_ms="
                         f"{row['library_ms']:.4f} (sdpa is_causal) "
                         f"bound_ms={row['bound_ms']:.4f} "
                         f"({row['bound_by']})")
                del qt, kt, vt
            print(line)
            del o, plain, kb, vb
        del q, k, v
    torch.cuda.empty_cache()

    for label, Bt, S, H, P, N, q in TP_SSD:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            full = ssd_inputs(torch, gen, Bt, S, H, P, N, tdt)
            full_ms = cuda_ms(torch, lambda: ssd_ops.ssd_scan(
                *full, chunk=q), iters=5, warmup=1) \
                if dtype == "bfloat16" else None
            errs["ssd"].setdefault(dtype, 0.0)
            for n in TP_SHARDS:
                hl = H // n
                x, dt, Bm, Cm, A = full
                args = (x[:, :, :hl], dt[:, :, :hl], Bm, Cm, A[:hl])
                y, st = ssd_ops.ssd_scan(*args, chunk=q)
                yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=q)
                ey, es = rel_err(y, yp), rel_err(st, sp)
                errs["ssd"][dtype] = max(errs["ssd"][dtype], float(max(
                    (y.float() - yp.float()).abs().max(),
                    (st - sp).abs().max())))
                line = (f"tp ssd {label} {dtype} n={n}: kernel at Bt={Bt} "
                        f"S={S} H={hl} P={P} N={N} chunk={q} (a head slice "
                        f"of the {H}-head input, its strides) vs plain "
                        f"rel_err_y={ey:.3e} rel_err_state={es:.3e}")
                require(ey <= SSD_TOL[dtype] and es <= SSD_STATE_TOL[dtype],
                        line)
                if dtype == "bfloat16":
                    row = {"shape": f"tp{n}_{label}_prefill", "dtype": dtype,
                           "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan(
                               *args, chunk=q), iters=5, warmup=1),
                           "plain_ms": cuda_ms(
                               torch, lambda: ssd_ops.ssd_scan_plain(
                                   *args, chunk=q), iters=2, warmup=1,
                               rounds=1),
                           "library_ms": None}
                    row["bound_ms"], row["bound_by"] = ssd_bound(
                        Bt, S, hl, P, N, q, dtype)
                    rows["ssd"].append(row)
                    line += (f"; kernel_ms={row['ms']:.4f} (unsharded "
                             f"{full_ms:.4f} / {n} = {full_ms / n:.4f}) "
                             f"plain_ms={row['plain_ms']:.4f} "
                             f"library_ms=none bound_ms="
                             f"{row['bound_ms']:.4f} ({row['bound_by']})")
                print(line)
                del y, st, yp, sp
            del full
            torch.cuda.empty_cache()

    # the layers: n shards' partial outputs summed vs the unsharded layer
    cfg = get_config("qwen3-4b").replace(dtype="float32",
                                         param_dtype="float32")
    p = init_from_seed(att.attn_specs(cfg), 5, "float32",
                       torch.device("cuda"))
    x = torch.randn(1, TP_FLASH[1], cfg.d_model, generator=gen).cuda()
    pos = torch.arange(x.shape[1], device="cuda")[None]
    with torch.no_grad():
        want, _ = att.attention_forward(p, x, pos, cfg, "train")
        for n in TP_SHARDS:
            got = sum(att.tp_shards(p, x, pos, cfg, n))
            rel = rel_err(got, want)
            line = (f"tp attention layer f32 n={n} (qwen3-4b width, 1 x "
                    f"{x.shape[1]}): the shards' row-parallel outputs "
                    f"summed vs the unsharded layer rel {rel:.3e} (<= "
                    f"{TP_GATE_TOL})")
            print(line)
            require(rel <= TP_GATE_TOL, line)
    del p, x, want, got
    cfg = get_config("mamba2-780m").replace(dtype="float32",
                                            param_dtype="float32")
    p = init_from_seed(m2.ssm_specs(cfg), 5, "float32", torch.device("cuda"))
    x = torch.randn(1, TP_FLASH[1], cfg.d_model, generator=gen).cuda()
    with torch.no_grad():
        want, _ = m2.ssm_forward(p, x, cfg, "train")
        for n in TP_SHARDS:
            got = sum(m2.tp_shards(p, x, cfg, n))
            rel = rel_err(got, want)
            line = (f"tp ssm layer f32 n={n} (mamba2-780m width, 1 x "
                    f"{x.shape[1]}, {m2.ssm_dims(cfg)[1] // n} heads a "
                    f"shard): the shards' gate norm and out_proj summed vs "
                    f"the unsharded layer rel {rel:.3e} (<= {TP_GATE_TOL})")
            print(line)
            require(rel <= TP_GATE_TOL, line)
    del p, x, want, got
    torch.cuda.empty_cache()
    return rows, errs


def tp_heads(cfg, n: int):
    """The (flash, SSD) launches by head count that one of n TP ranks
    makes in a ``generate``: each attention layer's prefill on its H/n
    query heads, each SSM layer's scan on its nheads/n heads."""
    from repro_torch.models.mamba2 import ssm_dims
    mixers = [m for m, _ in cfg.pattern()]
    n_attn = mixers.count("attn") * cfg.num_repeats
    n_ssm = mixers.count("ssm") * cfg.num_repeats
    return ({cfg.num_heads // n: n_attn} if n_attn else {},
            {ssm_dims(cfg)[1] // n: n_ssm} if n_ssm else {})


def check_tp(torch, fa_ops, ssd_ops):
    """GSPMD's weight layouts (ROADMAP item 6c) on the one card: the
    meshless runs here, (a) and (b) on two gloo ranks (``tp_ranks``),
    then (c) n TP shards in one process.  Returns ({kernel: main-path
    launches of the ranks' runs}, timing rows, errs)."""
    ref = tp_meshless(torch)
    got = tp_ranks(torch)
    launches = {"flash_attention": 0, "ssd": 0}
    for arch, layers, experts in TP_RUNS:
        cfg = tp_cfg(arch, layers, experts)
        a, b = got[f"run/{arch}"], ref[f"run/{arch}"]
        n_attn = sum(m == "attn" for m, _ in cfg.pattern()) * cfg.num_repeats
        n_ssm = sum(m == "ssm" for m, _ in cfg.pattern()) * cfg.num_repeats
        same = bool(torch.equal(a["tokens"], b["tokens"]))
        agree = (a["tokens"] == b["tokens"]).float().mean().item()
        # the prefill's last row: the TP run's gap to the meshless run
        # beside the meshless run's margin between its two top logits
        V = cfg.vocab_size
        top2 = b["first"][..., :V].topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).min().item()
        gap = (a["first"] - b["first"])[..., :V].abs().max().item()
        launches["flash_attention"] += a["launches"][0]
        launches["ssd"] += a["launches"][1]
        want_heads = [tp_heads(cfg, 2)] * 2
        line = (f"tp {arch} ({cfg.num_layers} layers, {cfg.num_experts or 0}"
                f" experts, bf16, B={TP_BATCH} x {TP_PROMPT} + {TP_DECODE} "
                f"decode steps, LOGICAL_RULES_DECODE on mesh (1, 2), 2 gloo "
                f"ranks on one card): the ranks hold " + " / ".join(
                    f"{x / 2**30:.3f}" for x in a["rank_bytes"])
                + f" GiB of parameters vs {b['bytes'] / 2**30:.3f} GiB "
                f"meshless ({a['bytes'] / b['bytes']:.3f}); launches a rank "
                f"flash="
                f"{a['launches'][0]} ssd={a['launches'][1]} (expected "
                f"{n_attn}/{n_ssm}; meshless {b['launches']}); launches by "
                f"head count, ranks 0 / 1 (flash, SSD): "
                f"{a['rank_heads'][0]} / {a['rank_heads'][1]} (expected "
                f"{want_heads[0]}; meshless {b['heads']}); greedy tokens "
                f"equal the meshless run's={same} ({agree:.3f} of "
                f"{a['tokens'].numel()} agree, bf16: reported; the "
                f"prefill's last logits max abs gap {gap:.4e}, rel "
                f"{live_rel(a['first'], b['first'], V):.3e}, beside the "
                f"meshless top-2 margin {margin:.4e}); prefill s "
                f"{a['prefill_s']:.3f} vs meshless {b['prefill_s']:.3f}, "
                f"decode ms/step {a['decode_ms']:.2f} vs {b['decode_ms']:.2f}"
                f"; rank 0 peak {a['peak_gib']:.2f} GiB vs meshless "
                f"{b['peak_gib']:.2f} GiB")
        print(line)
        require(max(a["rank_bytes"]) < b["bytes"], line)
        require(a["launches"] == (n_attn, n_ssm), line)
        require(a["rank_heads"] == want_heads, line)
        require(b["heads"] == tp_heads(cfg, 1), line)
    for arch, layers, experts in TP_GATES:
        cfg = tp_cfg(arch, layers, experts, "float32")
        a, b = got[f"gate/{arch}"], ref[f"gate/{arch}"]
        rel = live_rel(a["logits"], b["logits"], cfg.vocab_size)
        same = bool(torch.equal(a["tokens"], b["tokens"]))
        launches["flash_attention"] += a["launches"][0]
        launches["ssd"] += a["launches"][1]
        line = (f"tp gate {arch} f32 ({cfg.num_layers} layers, "
                f"{cfg.num_experts or 0} experts, 1 x {TP_GATE_PROMPT} + "
                f"{TP_GATE_DECODE} decode steps, TP over 2 ranks): logits "
                f"vs the meshless run on the card rel {rel:.3e} (<= "
                f"{TP_GATE_TOL}), greedy tokens equal={same}; parameter "
                f"bytes a rank {a['bytes']} vs {b['bytes']}; rank 0's "
                f"launches by head count {a['heads']} (expected "
                f"{tp_heads(cfg, 2)})")
        print(line)
        require(rel <= TP_GATE_TOL and same and a["bytes"] < b["bytes"]
                and a["heads"] == tp_heads(cfg, 2), line)
    for key, r in got.items():
        if not key.startswith("train/"):
            continue
        _, where, arch, dtype = key.split("/")
        gap = abs(r["loss"] - r["meshless_loss"]) / abs(r["meshless_loss"])
        what = ("'model' = 2 on mesh (1, 2), 1 x "
                f"{TP_TRAIN_SEQ}" if where == "tp" else
                f"FSDP rows over 'data' on mesh (2, 1), {TP_FSDP_BATCH} x "
                f"{TP_FSDP_SEQ}")
        line = (f"tp train {arch} {dtype} ({dict(TP_TRAIN)[arch]} layers, "
                f"LOGICAL_RULES_TRAIN, {what}): loss {r['loss']:.6f} vs "
                f"meshless {r['meshless_loss']:.6f} rel {gap:.3e}; "
                f"{r['leaves']} gradient leaves gathered, worst "
                f"{r['worst']} rel norm {r['worst_rel']:.3e}; peak GiB "
                f"rank 0 {r['peak_gib']:.3f} vs meshless "
                f"{r['meshless_peak_gib']:.3f}")
        if dtype == "float32":
            line += f" (<= {TP_LOSS_TOL} / {TP_GRAD_TOL})"
            print(line)
            require(gap <= TP_LOSS_TOL and r["worst_rel"] <= TP_GRAD_TOL,
                    line)
        else:
            print(line + " (bf16: reported)")
    rows, errs = tp_shards_check(torch, fa_ops, ssd_ops)
    return launches, rows, errs


# the LSTM baseline (Fig 10), activation
# rematerialization, the dry-run against the card, the examples
LSTM_BATCH, LSTM_CPU_BATCH = 256, 64
LSTM_TRAIN_BATCH, LSTM_TRAIN_STEPS = 8, 20
REMAT_CAPSIM_BATCHES = (32, 256)
REMAT_STEPS = 3                               # timed steps, after a warm one
REMAT_LM = ("qwen3-4b", 2, 1, 4096)          # arch, layers, B, S
# remat's gradients against none: f32 rel <= 1e-6 (0 expected); bf16 at
# the LM zoo's bf16 gate (relative norm)
REMAT_TOL = {"float32": 1e-6, "bfloat16": 3e-2}
DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"),
                ("capsim", "train_clips"))
PEAK_RATIO = (0.7, 1.3)


def capsim_clip_batch(torch, cfg, B: int, seed: int, device, L: int = 128,
                      M: int = 360):
    """B random clips in the predictor's layout from a numpy seed: each
    instruction 2..L_token tokens, each clip L/2..L instructions (the
    rest all-<PAD> and masked), M context tokens, and a time of 0.5-3
    cycles an instruction."""
    import numpy as np
    rng = np.random.RandomState(seed)
    T = cfg.clip_tokens
    tok = rng.randint(1, 383, (B, L, T))
    lens = rng.randint(2, T + 1, (B, L))
    tok[np.arange(T) >= lens[..., None]] = 0
    mask = np.ones((B, L), np.float32)
    n = rng.randint(L // 2, L + 1, B)
    mask[np.arange(L) >= n[:, None]] = 0.0
    tok[mask == 0] = 0
    t = (mask.sum(1) * rng.uniform(0.5, 3.0, B)).astype(np.float32)
    out = {"clip_tokens": tok, "context_tokens": rng.randint(1, 383, (B, M)),
           "clip_mask": mask, "time": t}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def check_lstm(torch, fa_ops):
    """The Ithemal-style LSTM baseline (``core/lstm_baseline.py``) at the
    CAPSim full config (E=128, vocab 512, L_clip 128, L_token 16, bf16
    compute over f32 parameters): the forward at LSTM_BATCH clips on the
    card, finite, with its ms, clips/s and peak GiB beside
    ``predictor.predict_step``'s at the same batch (Fig 10's speed
    half); an f32 forward of the same parameters against its CPU run
    (<= 1e-4 relative, LSTM_CPU_BATCH clips); LSTM_TRAIN_STEPS SGD-
    momentum steps (lr 1e-3, ``bench_accuracy.py``'s recipe) of
    ``mape_loss`` through ``make_train_step`` on one batch of
    LSTM_TRAIN_BATCH: finite and falling, one embedding gradient a step
    (the LSTM's one gather).  The LSTM has no kernel of its own; the
    predictor's forward launches flash attention 4 times a pass of the
    instruction encoder and 8 times in the block encoder.  Returns the
    training's launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core import lstm_baseline as lstm
    from repro_torch.core import predictor
    from repro_torch.kernels.embedding import ops as emb_ops
    from repro_torch.training import train_loop as ttl

    cfg = get_config("capsim")
    params = lstm.init_params(cfg, seed=0, device="cuda")
    batch = capsim_clip_batch(torch, cfg, LSTM_BATCH, 0, "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        y = lstm.forward(params, batch, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(tuple(y.shape) == (LSTM_BATCH,)
                and bool(torch.isfinite(y).all()) and bool((y > 0).all()),
                f"lstm forward: shape {tuple(y.shape)}, finite/positive")
        ms = cuda_ms(torch, lambda: lstm.forward(params, batch, cfg),
                     iters=3, warmup=1, rounds=2)
        pparams = predictor.init_params(cfg, seed=0, device="cuda")
        n0 = fa_ops.flash_attention.launches
        predictor.predict_step(pparams, batch, cfg)
        per_call = fa_ops.flash_attention.launches - n0
        pms = cuda_ms(torch, lambda: predictor.predict_step(pparams, batch,
                                                            cfg),
                      iters=3, warmup=1, rounds=2)
    steps = 16 + 128
    print(f"lstm forward (full config, {cfg.dtype} compute, f32 params) "
          f"batch {LSTM_BATCH} x {128} instructions x {cfg.clip_tokens} "
          f"tokens: {ms:.3f} ms = {LSTM_BATCH / ms * 1e3:.1f} clips/s "
          f"({steps} sequential steps, {ms / steps * 1e3:.1f} us a step); "
          f"peak {peak:.2f} GiB; predictor.predict_step at the same batch "
          f"{pms:.3f} ms = {LSTM_BATCH / pms * 1e3:.1f} clips/s ({per_call} "
          f"flash launches a call); LSTM / predictor time "
          f"{ms / pms:.2f}")
    # the instruction encoder in passes of ENCODE_CHUNK rows, 4 layers a
    # pass; the block encoder's 4 layers of self and cross attention
    want = 4 * -(-LSTM_BATCH * 128 // predictor.ENCODE_CHUNK) + 8
    require(per_call == want, f"predictor forward launched {per_call} "
            f"flash, expected {want}")

    cfg32 = cfg.replace(dtype="float32")
    small = {k: v[:LSTM_CPU_BATCH] for k, v in batch.items()}
    with torch.no_grad():
        card = lstm.forward(params, small, cfg32).cpu()
        cpu = lstm.forward(_to(params, "cpu"), _to(small, "cpu"), cfg32)
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    print(f"lstm f32 card vs CPU, {LSTM_CPU_BATCH} clips: max rel "
          f"{rel:.3e} (<= 1e-4)")
    require(rel <= 1e-4, f"lstm f32 card vs CPU rel {rel}")

    tcfg = ttl.TrainConfig(optimizer="sgdm", base_lr=1e-3, momentum=0.9,
                           warmup_steps=0, total_steps=0)
    step = ttl.make_train_step(lambda p, b: lstm.mape_loss(p, b, cfg), tcfg)
    state = ttl.init_train_state(params, tcfg)
    train = capsim_clip_batch(torch, cfg, LSTM_TRAIN_BATCH, 1, "cuda")
    losses = []
    emb_ops.embedding_grad.launches = 0
    t0 = time.perf_counter()
    for _ in range(LSTM_TRAIN_STEPS):
        state, m = step(state, train)
        losses.append(float(m["loss"]))
    dt = time.perf_counter() - t0
    n_emb = emb_ops.embedding_grad.launches
    print(f"lstm train {LSTM_TRAIN_STEPS} sgdm steps (lr 1e-3, momentum "
          f"0.9) on one batch of {LSTM_TRAIN_BATCH}: mape "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; {LSTM_TRAIN_STEPS / dt:.2f} steps/s; embedding_grad "
          f"launches {n_emb} (expected {LSTM_TRAIN_STEPS})")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"lstm training losses {losses}")
    require(n_emb == LSTM_TRAIN_STEPS, f"lstm training: {n_emb} embedding "
            f"gradients in {LSTM_TRAIN_STEPS} steps")
    del params, pparams, state, batch
    torch.cuda.empty_cache()
    return {"embedding_grad": n_emb}


def remat_cell(torch, fa_ops, ssd_ops, what, cfg, loss_of, params, batch,
               tcfg, tol):
    """Train steps of ``cfg`` with remat off, then on, from the same
    state: step ms (the least of REMAT_STEPS, each on the host clock to
    its synchronized end, after a warm-up step), the step's peak (``max_memory_allocated``, reset just before;
    and the step's own: less what was allocated before it besides the
    step's state and batch), flash and SSD launches a step (twice with
    remat) and the embedding gradient's (the same with remat: the
    gathers are not recomputed); then every gradient of the two against
    each other, and the gradient pass's own peak (``value_and_grad``, no
    update), which remat must lower: the step's peak can be the
    optimizer update's, which remat leaves alone (qwen3-4b's AdamW
    update sets it once the flash backward holds no scores).  Returns
    ({remat: measurements}, the launches of the timed steps by
    kernel)."""
    import gc
    from repro_torch.kernels.embedding import ops as emb_ops
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.optimizer import tree_leaves
    out, grads = {}, {}
    total = {"flash_attention": 0, "ssd": 0, "embedding_grad": 0}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        step = ttl.make_train_step(lambda p, b: loss_of(p, b, c), tcfg)
        state = ttl.init_train_state(params, tcfg)
        warm = step(state, batch)
        float(warm[1]["loss"])
        del warm
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        args = storage_bytes(tree_leaves(state) + list(batch.values()))
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.flash_attention.launches = 0
        ssd_ops.ssd_scan.launches = 0
        emb_ops.embedding_grad.launches = 0
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            new, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            del new, m
        n = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches)
        n_emb = emb_ops.embedding_grad.launches
        total["flash_attention"] += n[0]
        total["ssd"] += n[1]
        total["embedding_grad"] += n_emb
        peak = torch.cuda.max_memory_allocated()
        del state
        gc.collect()
        out[remat] = {"ms": min(times), "times": times, "peak": peak,
                      "step_peak": peak - (before - args), "args": args,
                      "launches": tuple(x // REMAT_STEPS for x in n),
                      "emb": n_emb / REMAT_STEPS}
        torch.cuda.empty_cache()
    # the gradients after both timed steps, so neither step's peak holds
    # the other's
    grad_peak = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, g = ttl.value_and_grad(lambda p, b: loss_of(p, b, c), params,
                                  batch)
        grad_peak[remat] = torch.cuda.max_memory_allocated() - base
        grads[remat] = tree_leaves(g)
        del g
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(grads[True], grads[False]))
    max_abs = max(float((a - b).abs().max())
                  for a, b in zip(grads[True], grads[False]))
    off, on = out[False], out[True]
    print(f"remat {what}: step ms off / on {off['ms']:.2f} / {on['ms']:.2f} "
          f"({on['ms'] / off['ms']:.3f}; least of " + " / ".join(
              ", ".join(f"{t:.2f}" for t in r["times"]) for r in (off, on))
          + f"); peak GiB (max_memory_allocated) "
          f"{off['peak'] / 2**30:.2f} / {on['peak'] / 2**30:.2f}, the step's "
          f"own {off['step_peak'] / 2**30:.2f} / "
          f"{on['step_peak'] / 2**30:.2f} (state and batch "
          f"{off['args'] / 2**30:.2f} GiB), the gradient pass's "
          f"{grad_peak[False] / 2**30:.2f} / {grad_peak[True] / 2**30:.2f}; "
          f"launches (flash, SSD) a step "
          f"{off['launches']} / {on['launches']}, embedding gradients a "
          f"step {off['emb']:g} / {on['emb']:g}; gradients, "
          f"{len(grads[True])} leaves: max |d| {max_abs:.3e}, worst rel "
          f"{worst:.3e} (<= {tol})")
    require(worst <= tol, f"remat {what}: gradients rel {worst}")
    require(on["launches"] == tuple(2 * x for x in off["launches"]),
            f"remat {what}: launches {off['launches']} -> {on['launches']}")
    require(on["emb"] == off["emb"], f"remat {what}: embedding gradients "
            f"a step {off['emb']} -> {on['emb']}")
    require(grad_peak[True] < grad_peak[False],
            f"remat {what}: the gradient pass's peak did not fall")
    del grads
    torch.cuda.empty_cache()
    return out, total


def check_remat(torch, fa_ops, ssd_ops):
    """Activation rematerialization on the card: the CAPSim predictor at
    full width in f32 (the trainer's dtype; SGD momentum) at
    REMAT_CAPSIM_BATCHES clips, and REMAT_LM (qwen3-4b cut to 2 layers,
    bf16, AdamW) at 1 x 4096, each through ``remat_cell`` (CAPSim's
    steps with ``emb_per_step`` embedding gradients, the LM's with none,
    as its embedding is its own code).  Returns the launches and the
    cells for the dry-run's estimates."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import predictor
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop as ttl

    cells = []
    launches = {"flash_attention": 0, "ssd": 0, "embedding_grad": 0}
    cfg = get_config("capsim").replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cuda")
    tcfg = ttl.TrainConfig(optimizer="sgdm", base_lr=1e-3, warmup_steps=0,
                           total_steps=0)
    for B in REMAT_CAPSIM_BATCHES:
        batch = capsim_clip_batch(torch, cfg, B, 2, "cuda")
        got, n = remat_cell(torch, fa_ops, ssd_ops,
                            f"capsim f32 batch {B}", cfg,
                            predictor.mape_loss, params, batch, tcfg,
                            REMAT_TOL["float32"])
        require(got[False]["emb"] == emb_per_step(B),
                f"remat capsim batch {B}: {got[False]['emb']} embedding "
                f"gradients a step, expected {emb_per_step(B)}")
        for k in launches:
            launches[k] += n[k]
        cells.append((f"capsim f32 batch {B}", cfg,
                      ShapeConfig("remat", 128, B, "train"), tcfg, got))
        del batch
    del params
    arch, layers, B, S = REMAT_LM
    cfg = get_config(arch).replace(num_layers=layers)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    shape = ShapeConfig("remat", S, B, "train")
    batch = random_batch(cfg, shape, "train", seed=0, device="cuda")
    tcfg = ttl.TrainConfig(optimizer="adamw", base_lr=1e-3, warmup_steps=0,
                           total_steps=0)
    what = f"{arch} {layers} layers {cfg.dtype} {B} x {S}"
    got, n = remat_cell(torch, fa_ops, ssd_ops, what, cfg, tfm.loss_fn,
                        params, batch, tcfg, REMAT_TOL[cfg.dtype])
    require(got[False]["emb"] == 0, f"remat {what}: embedding gradients")
    for k in launches:
        launches[k] += n[k]
    cells.append((what, cfg, shape, tcfg, got))
    del params, batch
    torch.cuda.empty_cache()
    return launches, cells


def check_dryrun(torch, remat_cells):
    """The dry-run (``launch/dryrun.py``) on meta, on the card's host:
    DRYRUN_CELLS through ``run_cell`` on rank 0 of ``pod_16x16`` (capsim
    under the predictor's rules), each with its seconds, then
    ``roofline_report``'s table; then the meshless cells the remat phase
    measured, each estimated peak (arguments + the step's live peak)
    beside the card's and their ratio (gated at PEAK_RATIO), and the
    estimated FLOPs over the card's step time as achieved TFLOP/s."""
    import tempfile
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch import roofline_report as rr
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = dry.run_cell(arch, shape, False, out_dir=Path(tmp))
            require("skipped" not in rec, f"dryrun {arch} {shape}: {rec}")
            mem = rec["scanned"]["memory"]
            print(f"dryrun {arch} {shape} pod_16x16 rank 0: "
                  f"{time.perf_counter() - t0:.1f} s (the step on meta "
                  f"{rec['run_s']:.1f} s); arguments "
                  f"{mem['argument_bytes'] / 2**30:.2f} GiB, live peak "
                  f"{mem['temp_bytes'] / 2**30:.2f} GiB, FLOPs "
                  f"{rec['scanned']['cost']['flops']:.4e}, collectives "
                  + ", ".join(f"{k} x{v['count']}"
                              for k, v in sorted(rec["scanned"][
                                  "collectives"].items())))
        print("dryrun roofline report (pod_16x16):")
        print(rr.report("pod_16x16", results_dir=Path(tmp)))
    for what, cfg, shape, tcfg, card in remat_cells:
        for remat in (False, True):
            c = cfg.replace(remat=remat)
            t0 = time.perf_counter()
            est = dry.measure_cell(c, shape, None, None, tcfg)
            peak = dry.estimated_peak_bytes(est)
            got = card[remat]
            ratio = peak / got["step_peak"]
            tflops = est["cost"]["flops"] / (got["ms"] * 1e-3) / 1e12
            print(f"dryrun vs card {what} remat={remat}: estimated peak "
                  f"{peak / 2**30:.3f} GiB (arguments "
                  f"{est['memory']['argument_bytes'] / 2**30:.3f}, card "
                  f"{got['args'] / 2**30:.3f}) vs the card's step "
                  f"{got['step_peak'] / 2**30:.3f} GiB "
                  f"(max_memory_allocated {got['peak'] / 2**30:.3f}): "
                  f"ratio {ratio:.3f}; estimated FLOPs "
                  f"{est['cost']['flops']:.4e} over the card's "
                  f"{got['ms']:.2f} ms = {tflops:.2f} TFLOP/s achieved; "
                  f"estimated in {time.perf_counter() - t0:.1f} s")
            require(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
                    f"dryrun {what} remat={remat}: peak ratio {ratio}")


def check_examples(torch, fa_ops, wa_ops, ssd_ops):
    """Each of ``examples/*_torch.py`` on the card, in this process, at
    its defaults but for the fewest steps and data that show it working;
    the launch counters reset just before each and read just after (the
    embedding gradient in CAPSim's training alone).  Returns the
    launches."""
    import importlib.util
    import tempfile
    from repro_torch.kernels.embedding import ops as emb_ops
    runs = (("quickstart_torch", []),
            ("simulate_benchmark_torch", ["--max-checkpoints", "1"]),
            ("train_capsim_torch", ["--fast", "--steps", "5"]),
            ("train_lm_torch", ["--steps", "5"]))
    total = {"flash_attention": 0, "weighted_attention": 0, "ssd": 0,
             "embedding_grad": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in runs:
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if name.startswith("train"):
                argv = argv + ["--ckpt-dir", f"{tmp}/{name}"]
            fa_ops.flash_attention.launches = 0
            wa_ops.weighted_attention.launches = 0
            ssd_ops.ssd_scan.launches = 0
            emb_ops.embedding_grad.launches = 0
            t0 = time.perf_counter()
            out = mod.main(argv)
            torch.cuda.synchronize()
            n = {"flash_attention": fa_ops.flash_attention.launches,
                 "weighted_attention": wa_ops.weighted_attention.launches,
                 "ssd": ssd_ops.ssd_scan.launches,
                 "embedding_grad": emb_ops.embedding_grad.launches}
            for k in total:
                total[k] += n[k]
            print(f"examples {name} {' '.join(argv)}: "
                  f"{time.perf_counter() - t0:.1f} s, launches "
                  + " ".join(f"{k}={v}" for k, v in n.items()))
            require(n["flash_attention"] > 0, f"examples {name}: no flash")
            require((n["embedding_grad"] > 0) == (name == "train_capsim_torch"),
                    f"examples {name}: embedding gradients {n}")
            if name == "quickstart_torch":
                import numpy as np
                require(bool(np.isfinite(out["predicted"]).all()),
                        "quickstart: non-finite predictions")
            elif name == "simulate_benchmark_torch":
                require(len(out) == 3 and all(
                    math.isfinite(r.predicted_cycles) for r in out),
                    "simulate_benchmark: results")
            else:
                require(out["steps"] == 5, f"examples {name}: {out}")
    return total


def _named(tree, prefix=""):
    """(name, leaf) in sorted key order (``tree_leaves``' order)."""
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _named(tree[k], name)
        else:
            yield name, tree[k]


def _capture(torch, fn):
    """Run ``fn`` once under ``torch.profiler`` (host and device).
    Returns (its result, wall s, the capture's ``key_averages``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, prof.key_averages()


def _summary(avg, top: int = 5):
    """(device busy s = the sum of the kernels' device times, the port's
    own kernels' device s, the ``top`` kernels by device time as (name,
    ms, calls)).  The device-side copies of ``record_function`` ranges
    span kernels already counted, and are left out."""
    from torch.autograd import DeviceType
    kernels = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    ours = sum(e.self_device_time_total for e in kernels
               if "capsim" in e.key) / 1e6
    require(busy > 0, "the profiler saw no device time")
    return busy, ours, [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in kernels[:top]]


def device_profile(torch, fn, top: int = 5):
    """Run ``fn`` once under ``torch.profiler``.  Returns (its result, wall
    s, device busy s = the sum of the kernels' device times, the port's
    own kernels' device s, the ``top`` kernels by device time as (name,
    ms, calls))."""
    out, wall, avg = _capture(torch, fn)
    return (out, wall) + _summary(avg, top)


def print_profile(what: str, wall: float, busy: float, ours: float,
                  top) -> None:
    print(f"{what} profiled: wall {1e3 * wall:.2f} ms, device busy "
          f"{1e3 * busy:.2f} ms (idle share {1 - busy / wall:.3f}); the "
          f"port's kernels {1e3 * ours:.2f} ms ({ours / busy:.3f} of busy); "
          "top kernels " + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}"
                                     for name, ms, n in top))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding import ops as emb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_serving import ops as wa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    t_start = time.perf_counter()
    phase_s = {}                        # phase -> seconds, in order
    phase_n = {}                        # phase -> main-path launches
    launches = {}

    def phase(name: str) -> None:
        """Close phase ``name`` at now (it began where the last ended),
        with the main-path launches it added."""
        phase_s[name] = time.perf_counter() - t_start - sum(
            phase_s.values())
        phase_n[name] = {k: n - sum(d.get(k, 0) for d in phase_n.values())
                         for k, n in launches.items()}
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for cuBLAS matmuls and cuDNN (fp32 means fp32)")

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(logs) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (log, seconds) in logs.items():
        regs = [int(line.split("Used ")[1].split()[0])
                for line in log.splitlines() if "Used " in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line and " 0 bytes spill" not in line]
        print(f"build {name}: {len(regs)} instantiations, registers "
              f"{min(regs)}-{max(regs)}, {len(spills)} with spills, nvcc "
              f"{seconds:.1f} s")
    sass_pipes(torch, build, fa_ops, ssd_ops)
    phase("device+build")

    errs = check_kernels(torch, fa_ops, wa_ops)
    errs["ssd"] = check_ssd(torch, ssd_ops)
    for dtype, err in check_ssd_grouped(torch, ssd_ops).items():
        errs["ssd"][dtype] = max(errs["ssd"][dtype], err)
    rows = time_kernels(torch, fa_ops, wa_ops)
    rows["ssd"] = time_ssd(torch, ssd_ops) + time_ssd_grouped(torch, ssd_ops)
    check_gates(rows)
    phase("kernels+timing")
    rows["embedding_grad"], emb_err = check_embedding(torch, emb_ops)
    phase("embedding")
    launches = check_engine(torch, fa_ops, wa_ops)
    launches["embedding_grad"] = 0
    phase("engine")
    mc_launches, seen_u = check_multicore(torch, fa_ops, wa_ops)
    for name, n in mc_launches.items():
        launches[name] += n
    mc_rows, mc_errs = fused_weighted_shapes(torch, wa_ops, seen_u)
    rows["weighted_attention"] += mc_rows
    for dtype, err in mc_errs.items():
        errs["weighted_attention"][dtype] = max(
            errs["weighted_attention"][dtype], err)
    phase("multicore")
    check_rt_store(torch)
    phase("rt-store")
    for name, n in check_sampling(torch, fa_ops, wa_ops).items():
        launches[name] += n
    phase("sampling")
    svc_launches, svc_u = check_service(torch, fa_ops, wa_ops)
    for name, n in svc_launches.items():
        launches[name] += n
    svc_rows, svc_errs = fused_weighted_shapes(torch, wa_ops, svc_u, 360,
                                               "svc", seed=5)
    rows["weighted_attention"] += svc_rows
    for dtype, err in svc_errs.items():
        errs["weighted_attention"][dtype] = max(
            errs["weighted_attention"][dtype], err)
    phase("service")
    launches["ssd"] = check_mamba2(torch, fa_ops, wa_ops, ssd_ops)
    phase("mamba2")
    check_mamba2_bf16(torch)
    check_mamba2_bf16_zoo(torch, ssd_ops)
    phase("mamba2 bf16 gate")
    print_d128_ptxas(build)
    for dtype, err in check_causal_flash(torch, fa_ops, FA_DENSE,
                                         6).items():
        errs["flash_attention"][dtype] = max(
            errs["flash_attention"][dtype], err)
    per_prefill, n = check_dense(torch, fa_ops, wa_ops, ssd_ops)
    launches["flash_attention"] += n
    check_dense_cpu(torch, fa_ops)
    rows["flash_attention"] += time_dense_flash(torch, fa_ops, per_prefill)
    phase("dense")
    for name, kernel_errs in check_moe_kernels(torch, fa_ops,
                                               ssd_ops).items():
        for dtype, err in kernel_errs.items():
            errs[name][dtype] = max(errs[name][dtype], err)
    per_prefill, moe_launches = check_moe(torch, fa_ops, wa_ops, ssd_ops)
    for name, n in moe_launches.items():
        launches[name] += n
    check_moe_cpu(torch, fa_ops)
    for name, moe_rows in time_moe_kernels(torch, fa_ops, ssd_ops,
                                           per_prefill).items():
        rows[name] += moe_rows
    phase("moe")
    for dtype, err in check_causal_flash(torch, fa_ops, FA_FRONTENDS,
                                         12).items():
        errs["flash_attention"][dtype] = max(
            errs["flash_attention"][dtype], err)
    per_prefill, n = check_frontends(torch, fa_ops, wa_ops, ssd_ops)
    launches["flash_attention"] += n
    check_frontends_cpu(torch, fa_ops)
    rows["flash_attention"] += time_causal_flash(torch, fa_ops, FA_FRONTENDS,
                                                 per_prefill, 13)
    phase("frontends")
    rows["flash_attention"] += check_train_grads(torch, fa_ops, ssd_ops)
    rows["flash_attention_bwd"] = check_flash_backward(torch, fa_ops)
    phase("train grads")
    for name, n in check_train_capsim(torch, fa_ops, wa_ops).items():
        launches[name] += n
    phase("train capsim")
    for name, n in check_train_multicore(torch, fa_ops, wa_ops).items():
        launches[name] += n
    phase("train multicore")
    n_flash, n_ssd = check_train_lm(torch, fa_ops, wa_ops, ssd_ops)
    launches["flash_attention"] += n_flash
    launches["ssd"] += n_ssd
    phase("train lm")
    for name, n in check_mesh(torch, fa_ops, wa_ops).items():
        launches[name] += n
    phase("mesh")
    n, dist_rows, dist_errs = check_dist(torch, fa_ops)
    launches["flash_attention"] += n
    rows["flash_attention"] += dist_rows
    for dtype, err in dist_errs.items():
        errs["flash_attention"][dtype] = max(
            errs["flash_attention"][dtype], err)
    phase("dist")
    tp_launches, tp_rows, tp_errs = check_tp(torch, fa_ops, ssd_ops)
    for name, n in tp_launches.items():
        launches[name] += n
        rows[name] += tp_rows[name]
        for dtype, err in tp_errs[name].items():
            errs[name][dtype] = max(errs[name][dtype], err)
    phase("tp")
    for name, n in check_lstm(torch, fa_ops).items():
        launches[name] += n
    phase("lstm")
    remat_launches, remat_cells = check_remat(torch, fa_ops, ssd_ops)
    for name, n in remat_launches.items():
        launches[name] += n
    phase("remat")
    check_dryrun(torch, remat_cells)
    phase("dryrun")
    for name, n in check_examples(torch, fa_ops, wa_ops, ssd_ops).items():
        launches[name] += n
    phase("examples")
    print("phases: " + ", ".join(f"{name} {sec:.1f} s"
                                 for name, sec in phase_s.items()))
    print("launches by phase (flash / weighted / SSD / embedding "
          "gradient): " + ", ".join(
              f"{name} " + " / ".join(str(n.get(k, 0)) for k in (
                  "flash_attention", "weighted_attention", "ssd",
                  "embedding_grad"))
              for name, n in phase_n.items() if any(n.values())))

    sources = {"flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:33", "block_self",
        "float32"),
        "weighted_attention": (
        "src/repro_torch/csrc/weighted_attention.cu",
        "src/repro/kernels/fused_serving/kernel.py:33", "fused_self_u128",
        "float32"),
        "ssd": (
        "src/repro_torch/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:30", SSD_PATH[0], "bfloat16")}
    kernels = []
    for name, (source, replaces, main_shape, dtype) in sources.items():
        row = next(r for r in rows[name]
                   if r["shape"] == main_shape and r["dtype"] == dtype)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "shape": f"{main_shape} {dtype}",
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}
        if "device_ms" in row:
            entry["device_ms"] = row["device_ms"]
        if name != "ssd":                 # the paper model's own dtype
            row = next(r for r in rows[name]
                       if r["shape"] == main_shape
                       and r["dtype"] == "bfloat16")
            entry.update({f"{key}_bf16": row[key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
        kernels.append(entry)
    row = rows["embedding_grad"][0]
    kernels.append({
        "name": "embedding_grad", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_grad.cu",
        "replaces": "none (PyTorch's indexing_backward_kernel)",
        "launches": launches["embedding_grad"],
        "max_err_share_of_abs_sum": emb_err,
        "shape": f"{row['shape']} float32", "ms": row["ms"],
        "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "index_put_ms": row["index_put_ms"]})
    row = next(r for r in rows["flash_attention_bwd"]
               if r["shape"] == "bwd_block_self_m1476")
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none (the reference's custom VJP recomputes through "
                    "attention_ref)",
        "shape": f"{row['shape']} float32", "ms": row["ms"],
        "recompute_ms": row["recompute_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
