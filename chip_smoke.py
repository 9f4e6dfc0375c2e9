#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (any
sm_90a card), the CUDA toolkit and PyTorch. It imports nothing of JAX and
nothing of the JAX package ``repro``. Phases, each printing what it found
and its time:

1. device — fail without CUDA; print the card's name and power limit;
   turn TF32 off (fp32 matmuls and convolutions run in full fp32).
2. build — compile the five CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, all at once); print registers, shared memory and
   spills per kernel.
3. kernel checks — each kernel against its plain PyTorch version at the
   main path's shapes: ``gram_xtx`` at 512 tokens, d = 4096 and 14336,
   with bf16 activations (the tensor-core path the main path takes) and
   fp32 ones (the CUDA-core path): within 1e-5 of max|G| (fp32 sums in
   another order; products of bf16 values are exact in fp32) and G == Gᵀ
   exactly. Each dtype timed at both shapes by device time with a cold L2
   (as spmm below): the kernel, the plain version, the dtype's one
   PyTorch call (``torch.mm(x.T, x, out_dtype=torch.float32)`` for bf16,
   ``torch.matmul(x.T, x)`` for fp32; ``library_ms``), and the bound
   (bf16: bytes 2·T·d + 4·d² against T·d·(d+1) operations at the bf16
   tensor-core peak; fp32: 4·(T·d + d²) bytes against the fp32 peak).
   ``swap_topk`` (k = 8) on a Wanda 0.6 mask over a correlated Gram at
   the four (R, d) of the main path's sites — (1024, 4096) wk / wv,
   (4096, 4096) wq / wo, (14336, 4096) w_gate / w_up and (4096, 14336)
   w_down — bitwise on feasible entries, with the same +inf positions and
   in-range indices, each timed with CUDA events (3 calls) beside its
   plain version (the kernel runs on all rows; the plain version on a
   fixed 256 of them, the first 128 and the last 128-row block, and
   those rows are compared), the bound (5 operations per feasible pair at the fp32
   peak) and the issue floor (6 unfused fp32 instructions per feasible
   pair on every SM's 128 lanes at the card's maximum SM clock, read from
   nvidia-smi). ``swap_argmin`` likewise at the four shapes, bitwise on
   every row (value bits, u and p, the (+inf, 0, 0) of rows with no
   feasible pair included), timed at each beside ``swap_topk``;
   ``swap_commit`` on ``swap_topk``'s k = 8 candidates at the same four
   shapes: its decisions kernel bitwise against the sub-Gram gather +
   ``commit_decisions`` and its apply kernel against ``apply_commits``'
   flips and Eq. 6 update, with accepts and rejects; each kernel's device
   time beside its bytes bound (the decisions' scattered reads counted as
   32-byte sectors; the apply's c and m read and written plus two Gram
   rows per candidate it reads in full), the launches per call, and the
   device time and launches of the whole step after the search as
   ``profile_swap --commit`` times it (two commit kernels, no gather);
   the apply's column reads (an asymmetric G's path) forced on the same
   G, bitwise equal to its row reads, and their time.
   ``spmm`` at every shape of the serve path — w_gate / w_up (14336 x
   4096, silu), w_down (4096 x 14336), wq / wo (4096 x 4096) and wk / wv
   (1024 x 4096), T = 4 (decode) and 128 (prefill), nm24 on a 2:4 mask
   and gathered on a PerRow(0.6) mask and on the same 2:4 mask, and at
   w_gate also T = 1 and 64 (untimed; the continuous scheduler's one-row
   decode bucket and its chunked-prefill window) — in fp32
   (within 1e-5 of max|y|: fp32 sums in another order) and bf16 (within
   one bf16 ulp of the plain element, or 1e-5 of max|y|: the two fp32
   sums round to neighbouring bf16 values), nm24 and gathered bitwise
   equal on the 2:4 mask. Times, at w_gate and w_down, in bf16 with
   a cold L2 (a 128 MB rewrite before each call), by device time alone:
   torch.profiler sums the kernels of each call (spmm: the product kernel
   and its split reduction; the library call: every kernel it launched;
   the flush's kernel excluded by name), so the host's work in the
   wrapper is never counted (where five traces in a row lose records,
   each call is timed by CUDA events behind its flush instead, and
   stderr says so); the median and min-max of 20 calls of the
   kernel, of ``torch.matmul(x, (W*mask).T)`` on the dense masked weight
   (``library_ms``, the masked format's cost) and of the plain version,
   and the bound max(2*T*d_out*K at the bf16 tensor-core peak, bytes at
   the HBM rate).
4. main path — ``prune_model`` (the recipe -> plan -> executor shim) on
   llama31-8b at full width (d_model 4096, 32 heads / 8 KV heads, d_ff
   14336, vocab 128256) with the depth cut to 2 layers, bf16, random
   weights from seed 0: 16 calibration samples x 128 tokens in batches of
   4, Wanda warmstart, PerRow(0.6), k-swap with k = 8, t_max = 4 search
   passes; then dense vs pruned perplexity on 4 validation batches of
   8 x 128. Asserts that all 7 taps x 2 layers x 4 batches = 56 Gram
   launches took the bf16 tensor-core path (none the fp32 one), that
   swap_topk ran once per site, layer and pass (7 x 2 x 4 = 56; taps and
   sites counted by ``pruning.sites``), exact per-row
   sparsity at every site, monotone row losses, a positive mean error
   reduction over Wanda, finite perplexities; prints a digest of the
   masks (to compare runs and commits bit for bit).
5. second path — on layer 0's w_down with its calibration Gram:
   ``refine(k_swaps=1, t_max=2)``, so ``swap_argmin`` runs (its wall
   time and a digest of its masks, swaps and losses printed); then
   ``refine(k_swaps=8, commit_mode="candidates", t_max=4)`` without and
   with ``compact_every=2``, so ``swap_commit`` runs, and the same at an
   ``eps`` that leaves ~70% of the rows without an accepted swap in the
   first pass, without and with ``compact_every=1``, so later passes run
   on a gathered working set (each run's wall time and a digest of its
   masks, swaps and losses printed). Asserts the kernels launched
   (``swap_commit`` once per search pass), monotone losses, exact
   sparsity, tracked losses within 1e-3 of loss_init of recomputed ones,
   masks, swaps and losses bitwise equal with and without compaction, no
   more rows scored with it and fewer at that ``eps``; and on 256 rows
   the kernel path's masks equal the plain chunked search and commit on
   the card.
4d. mesh prune (run last, after 9v, so that a process group and two
   spawned ranks come after every profiled phase; phase 4's model and
   batches made again from seed 0, phase 5's Grams made again and held to
   them by digest, phase 4's masks digest and phase 5's candidate run on
   w_down kept from then): (a) this process as a one-rank NCCL world
   on a file:// store, the (1, 1) ("data", "model") host mesh:
   ``prune_model(mesh=)`` at PerRow(0.6) from phase 5's Grams gives phase
   4's masks digest and at 2:4 the single-device run's digest (every group
   rows-sharded); ``accumulate_stats(mesh=)`` the single-device Grams
   within the Gram tolerance; ``refine_rows_sharded`` with the candidate
   commit on layer 0's w_down phase 5's candidate run's masks and losses
   bitwise; its Gram, swap_topk and swap_commit launches those of phases
   4 and 5. (b) MESH_RANKS spawned ranks sharing the card over gloo (NCCL
   refuses two ranks on one device; the collectives stage CUDA tensors
   through the host), each rank: the single-device Grams made again,
   held to phase 5's by digest (2.4 GB, past the write budget as a file);
   on the (2, 1) mesh calibration of the first MESH_CALIB_BATCHES batches
   split over "data" within the Gram tolerance of the single-device Grams
   of those batches, and ``prune_model(mesh=)`` PerRow(0.6) from the
   single-device Grams: phase 4's masks digest; each rank's launches
   exactly phase 4's Gram launches a batch times MESH_CALIB_BATCHES, and
   phase 4's swap_topk. On the (1, 2) mesh ``accumulate_stats(mesh=)``
   of all 16 batches splits every Gram's columns over "model" (w_down's
   shard bitwise the single-device Gram's columns; phase 4's Gram
   launches on each rank), and w_down's first MESH_G_ROWS rows refine
   through the engine in the Gram regime (its 0.82 GB G past
   MESH_GRAM_BUDGET) on the rank's (14336, 7168) calibration shard at
   k = 1 and 8, t_max = T_MAX: masks and losses bitwise
   ``distributed.refine_split_single`` (one device's run of the same
   column split), each rank's peak memory during the group under the
   plan's per-rank reckoning (``PrunePlan.refine_costs``). Then 9d (b)
   (``mesh_train_rank``) at phase 9's configuration: a (1, 2) train step
   bitwise one device's, the state's bytes a rank the reckoning; a (2, 1)
   norms_biases recovery of MESH_RECOVER_STEPS steps in float32 within
   MESH_RTOL of one device's (CE, and all but 1e-3 of the entries), the
   same in bf16 with its gap printed (the halves' bf16 products round by
   their row count); the float32 run's (2, 1) checkpoint, and the layer
   stack written (2, 1)-sharded, read on one device bitwise.
   Prints each run's time beside phase 4's and the card line.
6. serve path — the same model and params: PerRow(0.6) masks from phase
   4 and Wanda 2:4 masks (``prune_model(method="none")``, same
   calibration). ``ServeEngine`` for dense, masked (both mask sets),
   nm24 (2:4) and gathered (both mask sets), each ``generate``-ing
   batch 4 x prompt 32 + 16 new tokens of a synthetic validation prompt.
   Asserts: every packed generate launched spmm 7 sites x 2 layers x
   (1 prefill + 15 decode steps) = 224 times; nm24 and gathered give
   bitwise equal tokens and logits for the 2:4 masks; packed vs masked
   logits within SERVE_TOL of max|logits| at the prefill and at every
   decode step, the packed model fed the masked model's greedy tokens
   (teacher-forced: greedy tokens of near-tied logits part ways), since
   the masked path rounds each linear's pre-activation to bf16 before
   the bias and activation and the kernel keeps it in fp32; nm24 holds
   fewer weight bytes than masked. Prints per format the prefill ms, decode tok/s,
   weight bytes and ``kernel_used`` (best of 3 warm runs), and per packed
   engine the device time of its spmm kernels in one more warm
   ``generate`` (torch.profiler; the trace must hold every launch, or
   the time is printed as not measured).
6c. continuous serving (run after phase 8, on the params of phase 4 made
   again from seed 0) — phase 4's PerRow(0.6) masks and phase 6's Wanda
   2:4 masks, dense / masked PerRow(0.6) / nm24 (2:4) /
   gathered PerRow(0.6) engines, each through ``ContinuousScheduler``
   (8 slots of 1024 tokens, 16-token pages, decode chunks of 8):
   (a) the reference test's four mixed greedy and sampled requests at
   the pinned width give each request's solo tokens bitwise, and the
   pools end empty; (b) across shapes, where the card's matmuls may
   round a row otherwise: chunked prefill (64-token windows) vs one-shot
   of 100-, 300- and 500-token prompts, and a batch of four 32-token
   prompts prefilled together (the fixed path) vs each alone, both
   teacher-forced for 8 and 16 decode steps — logits within SERVE_TOL
   of max|logits|, with the largest |dK|, |dV| over valid positions and
   the greedy tokens that flip (at near ties) printed; then the
   scheduler's greedy tokens, chunked vs one-shot and against
   ``generate``, equal up to the first near-tie (a step whose top-2
   logit gap is within twice the forced pair's largest logits error),
   with how many streams the gate held past step 0 printed;
   (c) disaggregated (two pools, page shipping) == interleaved bitwise,
   with shipped bytes = shipped pages x page bytes; (d) ``run_chaos``
   under ``FaultPlan.chaos(0)``: no leaked bytes, no stream mismatches,
   faults fired; (e) in every scheduler run spmm launched sites x layers
   x (prefill dispatches + decode steps) times, counted from the
   scheduler's ``dispatches`` (0 for dense and masked). One profiled
   run per packed engine splits its wall time into device kernels
   (spmm's share) and the rest. (f) ``bench_load_rows``, one pass
   each (no warm-up pass), prompts 32-512 and outputs 16-128 tokens:
   continuous for masked, nm24 and gathered at 8 arrivals/s (below the
   continuous path's saturation, 13-19/s by host, from
   ``launch/profile_serve.py``'s sweep; a saturated queue is driven by
   6mc, which saturates at this rate), over a window of LOAD_REQUESTS /
   8 seconds (64 / 8, seed 0: the count is printed); and
   nm24 continuous vs fixed over the first 2 s at 8/s (15 requests; the
   fixed path, each prompt length alone, saturates by 2/s). Offered and
   delivered tok/s, TTFT, queue wait and per-token p50 / p99, wasted
   tokens: printed, not gated.
7. recipe path — ``repro_torch.launch.prune.prune`` on the same model
   (its own params from seed 0) with a recipe of every rule kind: 2:4
   sparseswaps on wq/wo, sparsegpt PerRow(0.6) on wk, skip on wv, dsnot
   PerRow(0.6) on w_down (moments only, ``calib_stats="minimal"``),
   sparseswaps PerRow(0.6) with ``compact_every=2`` on the rest, t_max =
   4, into a temporary out dir with calibration checkpoints every 2
   batches. Asserts exact sparsity per resolved pattern, the skipped site
   dense and its tap absent, no Gram for the dsnot site, finite
   perplexities; a second run into the same directory restores every
   group (counted by a ``PruneCallback``) with bitwise equal masks; a
   third run, resumed again under cProfile, prints where its host time
   goes (checkpoint hashing and reads, the data fingerprint, calibration
   restore, evaluation, the out dir's writes); ``plan_only`` prints the
   plan and allocates no CUDA memory.
3b. the other dense configs' shapes (chatglm3-6b, granite-34b,
   minitron-4b, internlm2-20b), each kernel held as in phase 3: the Gram
   (bf16, T = 512) at d = 3072, 6144, 9216, 13696, 16384, 24576, timed at
   13696 and 24576; swap_topk, swap_argmin and the commit (k = 8) at
   (6144, 24576) granite w_down (a 2.42 GB G), (4096, 13696) chatglm
   w_down (a 128-column last p-tile), (256, 4096) chatglm wk / wv, (128,
   6144) granite's MQA wk / wv, (3072, 9216) and (9216, 3072) minitron
   w_down / w_up, each on all rows with the searches held bitwise on the
   first 128 rows and the last 32-row block and the commit on every row,
   swap_topk and the commit step timed at the first two; spmm at chatglm
   wq and wk with a bias, granite w_up (gelu), w_down and wk (d_out =
   128), minitron w_up (relu2) and w_down, the granite pair timed in
   bf16.
4b / 6b. for each of those four configs, at full width with the depth
   cut to 2 layers, bf16, random weights from seed 0 (chatglm3's qkv
   biases, zero at init, drawn from N(0, 0.02²)): phase 4's prune_model
   and gates, the Gram and swap_topk launch counts from the config's taps
   and sites (``pruning.sites``: 7 for a gated MLP, 6 for a plain one),
   its time, peak memory and mask digest; then phase 6's serving without
   the timed runs (dense, masked, nm24 and gathered on the PerRow(0.6)
   masks and on Wanda 2:4 ones), spmm launches = sites x
   layers x 16 per packed generate, nm24 == gathered bitwise, packed vs
   masked logits within SERVE_TOL. Each config's state is freed before
   the next.
3m. the MoE experts' shapes, each stacked call one launch for all its
   experts: ``gram_xtx_stacked`` (bf16) at mixtral-8x7b's (E = 8, T =
   160, d = 4096 and 14336) and granite-moe-3b's (E = 40, T = 128, d =
   1536 and 512), T an expert's capacity buffer over a calibration batch
   of 4 x 128 tokens: within 1e-5 of max|G|, every G_e exactly symmetric
   and bitwise ``gram_xtx`` of its slice; ``spmm_stacked`` at the experts'
   w_gate (silu) and w_down of both configs, T = 4 (decode) and 40
   (mixtral's prefill) an expert, and the continuous scheduler's T at
   mixtral's w_gate (8: a decode step of 8 slots; 20: a 64-token prefill
   window) and granite-moe's prefill T = 32 (phase 9m's serving), nm24
   (2:4) and gathered (PerRow(0.6) and 2:4), fp32 and bf16: phase 3's
   tolerances, every expert's y bitwise ``spmm`` of its slice, nm24 ==
   gathered bitwise on 2:4. Timed as phase 3 times (mixtral at every
   such T, granite-moe at 4 and 32): the kernel, the plain
   version, ``torch.bmm`` (bf16 in, fp32 out for the Gram, the fp32
   upcast's time printed beside it; on the masked dense weights for spmm;
   ``library_ms``) and the bound (summed over the experts).
4m / 6m. mixtral-8x7b and granite-moe-3b-a800m at full width with the
   depth cut to 2 layers, bf16, seed 0: phase 4's prune_model and gates,
   an MoE tap's Gram one stacked launch a layer and batch (mixtral: 2
   taps x 2 layers x 4 batches = 16) and no unstacked Gram for an expert,
   swap_topk once per instance and search pass (an instance is one expert
   of one layer, at most t_max passes each); time, peak memory and a masks
   digest. mixtral-8x7b is then served as phase 6b serves: attention
   through ``spmm`` (4 sites x 2 layers x 16 =
   128 launches a packed generate) and the experts through
   ``spmm_stacked`` (3 x 2 x 16 = 96), nm24 == gathered bitwise, packed
   vs masked logits within SERVE_TOL with the routing teacher-forced too
   (the masked run's expert ids replayed): every routing decision that
   flips unforced must be a near tie (top-k gap at most twice the
   router-logit difference) and at most ROUTE_FLIPS of them may flip.
6mc. continuous serving of mixtral-8x7b (after 6m, on its params and
   its PerRow(0.6) and Wanda 2:4 masks): masked PerRow(0.6), nm24 (2:4),
   gathered PerRow(0.6) and gathered 2:4 through ``ContinuousScheduler``
   (phase 6c's shape: 8 slots x 1024 tokens, 16-token pages, decode
   chunks of 8), every capacity drop counted (``models.moe.count_drops``,
   no host read): (a) phase 6c's four mixed requests batched == each
   alone, bitwise; (b) chunked (64-token windows) vs one-shot prefill of
   100-, 300- and 500-token prompts, tokens and routing teacher-forced
   (``RouteTape`` cut to the windows): a window dispatches with
   capacity(64), one-shot prefill with capacity(S_bucket), so where
   either drops they compute different functions (printed, not gated);
   the same pair at capacity_factor E / top_k (no group can drop) within
   SERVE_TOL; a batch of four 32-token prompts vs each alone (the same
   groups) within SERVE_TOL; every unforced routing flip a near tie, at
   most ROUTE_FLIPS; the scheduler's greedy streams (chunked vs one-shot
   where neither drops, and through a scheduler at capacity_factor E /
   top_k; vs ``generate``) equal up to the first near-tie of a token or
   of a routing decision the two runs route differently (a near-tie both
   resolve alike voids nothing), how many streams the gate held past
   step 0 printed, and the phase fails if it held none of the scheduler
   vs ``generate`` streams; (c) disaggregated == interleaved
   bitwise, in 64-token windows; nm24 == gathered bitwise on the 2:4
   masks; (d) nm24 under ``FaultPlan.chaos(0)``; (e) every scheduler run
   launched spmm 4 and spmm_stacked 3 x layers x dispatches; (f) the
   first MOE_LOAD_REQUESTS (20) requests of phase 6c's stream at 8/s in
   64-token windows:
   every request completed and no page left, TTFT, per-token latency,
   goodput and drops printed for masked, nm24 and gathered; nm24 on the
   first 8 requests under torch.profiler: the device-busy share and
   spmm's and spmm_stacked's device ms (product kernels matched to their
   calls in launch order). spmm_stacked's calls are tallied by tokens an
   expert (T).
3z / 4z / 6z. zamba2-7b (after 3m, before 4m): 3z every kernel of its path at its
   shapes new to the kernels, held and timed as phase 3 holds and times
   them: the bf16 Gram at T = 512, d = 3584 and 7168; swap_topk (k = 8)
   and the commit at in_proj (14576 x 3584: 16 x 911 rows, a ragged
   last row block) and the shared wq (7168 x 7168), the search bitwise
   on the first 128 rows and the last 128-row block, the commit on every
   row; spmm (nm24, gathered PerRow(0.6) and 2:4; fp32 and bf16; T = 4
   and 128) at in_proj and the shared gelu w_gate (14336 x 7168). 4z and
   6z on zamba2-7b at full width, 7 layers (the shared block at layers 0
   and 6), bf16, seed 0: the shared Gram against the sum of its two
   sites' Grams taken one by one (1e-5 of max|G|); ``prune_model`` at
   PerRow(0.6) and 2:4 (Wanda, SparseSwaps k = 8, t_max = 4) with phase
   4's gates (a shared tap one Gram a site and batch; no swap_topk for
   2:4: the N:M search is plain ops in both packages), time, peak memory
   and digests; the candidate commit (phase 5's gates) on layer 0's
   in_proj and the shared wq; then phase 6's serving, (2 x 7 + 7 x 2) x
   16 = 448 spmm launches a packed generate, nm24 == gathered bitwise,
   packed vs masked logits printed (bf16 rounding alone carries these 7
   random layers past SERVE_TOL); then the same six engines at float32
   (the fp32 spmm kernel): 448 launches a packed generate again, nm24 ==
   gathered bitwise, packed vs masked logits within SERVE_TOL.
3r / 4r / 6r. rwkv6-1.6b (after 4z / 6z, before 4m): 3r every kernel of
   its path at its shapes new to the kernels, held and timed as phase 3
   holds and times them: the bf16 Gram at T = 512, d = 64 (td_w2's
   input), 2048 and 7168 (cm_wv's); swap_topk (k = 8) and the commit at
   every site shape — (2048, 2048) wr / wk / wv / wg / wo / cm_wr, (64,
   2048) td_w1 (two 32-row search blocks), (2048, 64) td_w2 (a quarter
   p-tile, one 64-column box of G), (7168, 2048) cm_wk, (2048, 7168)
   cm_wv — the search bitwise on every row of td_w1 and on the first 128
   rows and the last 128-row block of the others, the commit on every
   row; spmm (nm24, gathered PerRow(0.6) and 2:4; fp32 and bf16; T = 4
   and 128) at td_w1 (64 rows), td_w2 (K = 64; PerRow(0.6) keeps 26), the
   relu2 cm_wk and the silu wg. 4r and 6r on rwkv6-1.6b at full width, 2
   layers, bf16, seed 0: ``prune_model`` at PerRow(0.6) and 2:4 (Wanda,
   SparseSwaps k = 8, t_max = 4) with phase 4's gates (10 taps x 2 layers
   x 4 batches = 80 Gram launches, 80 swap_topk launches for PerRow(0.6),
   none for 2:4), time, peak memory and digests; the candidate commit
   (phase 5's gates) on layer 0's td_w1 and td_w2; then phase 6's serving
   at prompts of 32 and 37 tokens (the WKV chunk's pad path), 10 x 2 x 16
   = 320 spmm launches a packed generate, nm24 == gathered bitwise,
   packed vs masked logits within SERVE_TOL in bf16 and in the same six
   engines built at float32; the dense model's bf16 logits against its
   float32 ones, fed the same tokens, printed; prefill of 21 tokens and
   32 decode steps against one forward over the 53 (logits, and the WKV
   state and token-shift vectors carried against a prefill of all of
   them), within SERVE_TOL in bf16 and 1e-3 at float32.
3e / 4e / 6e, 3v / 4v / 6v. the cross-attention families (after 4r /
   6r, before 4m): seamless-m4t-medium (the encoder-decoder: d 1024, 16
   heads (MHA), ReLU MLP d_ff 4096, layernorm, vocab 256206, 1024 source
   frames) and llama-3.2-vision-90b (the VLM: d 8192, 64 / 8 KV heads,
   gated SiLU d_ff 28672, vocab 128256, a gated cross-attention layer
   every 5th layer over 1600 image tokens). 3e / 3v: every kernel of
   their paths at its shapes new to the kernels, held and timed as phase
   3 holds and times them (the plain swap searches on at most 256 rows):
   the bf16 Gram at the decoder's T = 512 and at the T of the encoder's
   and the cross wk / wv taps (4 x 1024 source frames, 4 x 1600 image
   tokens; at T = 6400 the Gram is operations-bound), and at the VLM's d
   = 28672 (w_down's input, a 3.29 GB G); swap_topk (k = 8) and the
   commit at every site shape; spmm (nm24, gathered PerRow(0.6) and 2:4;
   fp32 and bf16) at T = 4 and 128 at the MLP's shapes (seamless's relu
   w_up), and at the prefill's T for the sites that run over the source
   or image states (the encoder's, the cross wk / wv of the cross-KV
   precompute). 4e / 4v: seamless at full width with 2 encoder + 2
   decoder layers, the VLM with 5 layers (one group: 4 self layers and a
   cross layer, its tanh-gates set to 0.5 / -0.5: at init they are 0 and
   the cross layers would add nothing), bf16, seed 0, the calibration
   batches carrying their frontend states: ``prune_model`` at PerRow(0.6)
   (Wanda, SparseSwaps k = 8, t_max = 4) with phase 4's gates (one Gram a
   tap instance and batch: an encoder's, a decoder's self, cross ``x_*``
   and MLP taps, a VLM's (1, 4) self stack and its cross layer's), then
   Wanda 2:4 (``method="none"``: exact sparsity, finite perplexities);
   time, peak memory and digests; the candidate commit (phase 5's gates)
   on the first cross wk (its Gram over the source or image states).
   The PerRow(0.6) masks wait on the host, as bool, while the 2:4 run
   calibrates. 6e / 6v: phase 6's serving with the frontend states in the
   prompt (4 x 1024 x 1024 source frames, 4 x 1600 x 8192 image tokens;
   masks as bool), spmm launches a packed generate = the prefill's (every
   site instance once; the encoder's and the cross wk / wv only there) +
   15 decode steps' (the decoder's self, cross wq / wo and MLP sites, a
   VLM's self and cross layers'), nm24 == gathered bitwise, packed vs
   masked logits within SERVE_TOL, teacher-forced; prefill + 16 decode
   steps against one forward within SERVE_TOL; other frontend states
   change the logits of every engine at the prefill and at a decode
   step. The cross path is also held on a scale of its own, since the
   VLM's cross attention moves its random model's logits by ~3e-3 of
   their max, below bf16 rounding (``check_cross_path``): for each
   packed engine and its masked one, the precomputed cross KV of the
   same states within XATTN_KV_TOL of its max, element by element (and
   the masked KV far off the dense one), and the cross attention on it
   of the same queries within SERVE_TOL.
8. full depth, shapes only: every config's ``plan_pruning`` on the
   meta device (nothing allocated), its weight, Gram and calibration
   bytes, and whether the bf16 model and its calibration state fit the
   card.
9. training and recovery (run last, after 6c; llama31-8b's layer widths
   — d_model 4096, 32 / 8 KV heads, d_ff 14336, so every kernel runs at
   the shapes of phases 3-6 — with depth 1 and vocabulary 32000, bf16,
   seed 0: a TrainState checkpoint at 2 layers and vocabulary 128256 is
   15 GB, and a run of the script is held under 45 GiB of writes), all
   through the launchers in a temporary directory: (a)
   ``launch.train.train`` for 8 steps of batch 4 x 128 tokens without
   checkpoints: finite losses, step 7's below step 0's; then with a
   checkpoint every 4 steps, stopped by SIGTERM after step 3 (the
   preemption path: one checkpoint, at step 4), and rerun: it resumes at
   step 4 and ends with the uninterrupted run's losses and params
   bitwise; these two runs are phase 9d (a)'s: this process is a
   one-rank NCCL world, and they train on its (1, 1) mesh
   (``launch.train(mesh="host")``: the TrainState sharded by
   ``state_pspecs``, the checkpoint written and resumed in the sharded
   layout);
   (b) ``launch.prune.prune(from_ckpt=...)`` of the trained checkpoint,
   PerRow(0.6), Wanda, SparseSwaps, k = 8, t_max = 4 with phase 4's gates
   and launch arithmetic, the pruned params the trained ones;
   (c) ``--recover all_masked`` for 20 steps, a checkpoint every 10
   (``gc(keep=2)`` leaves 10 and 20): CE finite at every step, pruned
   coordinates 0.0 in the recovered weights and in the saved m and v;
   the step-20 checkpoint deleted, a rerun prints "recover: resumed at
   step 10", runs 10 steps and gives the recovered params and CE
   bitwise; then ``--recover norms_biases`` into the same out dir (how
   many norm scale elements moved is printed), and 9d (a): the same
   command with ``mesh="host"`` and no out dir (every group computed on
   the one-rank mesh): report, masks, recovered params, CE and
   perplexities bitwise the single-device command's, its Gram and
   swap_topk launches (b)'s; (d) ``export_packed``, gathered for
   these PerRow(0.6) masks and nm24 for a 2:4 run (recovered
   all_masked), each served by ``launch.serve.serve(masks_from=...,
   from_ckpt=...)``: greedy tokens and logits bitwise those of the
   in-process recovered params in the same format, packed vs masked
   logits (fed the masked tokens) within SERVE_TOL, spmm launches =
   sites x layers x 16 per generate; and ``prune_ckpt``'s ``groups/``
   root served with the run's masks' tokens. Prints the CE at the start
   and end, the trainable fraction, the dense / pruned / recovered
   perplexities, the train-step and recover-step ms (CUDA events, median
   of steps 2-4), peak memory and the phase's wall time beside the card
   line.
9m. MoE training and recovery, run last: granite-moe-3b-a800m at full
   width and its own vocabulary 49155, 1 layer (2 layers write 16.7 GB,
   past the run's 45 GiB budget beside phases 7 and 9), bf16, seed 0,
   through phase 9's path, with these differences: (a) a second uninterrupted run
   repeats the first bitwise, and the preempted and resumed runs (and
   the uninterrupted run they are held to) train under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``: every op
   it flags is printed and any but cuBLAS's workspace notice fails; (c)
   all_masked with one checkpoint (step 20: pruned coordinates 0.0 in
   the weights, m and v), then lora into the same out dir, checkpointed
   every 10 steps and rerun to resume at step 10 bitwise (lora's
   checkpoints hold only the adapters: the write budget); (d) the
   all_masked export served in gathered and nm24, the experts through
   ``spmm_stacked`` (decode T = 4, prefill T = 32 an expert), packed vs
   masked with the routing teacher-forced. Every phase prints the bytes
   it wrote (``wchar``); the run fails past WRITE_BUDGET (45 GiB, where
   the card's machine would end it).
10. the kernels line (``spmm``: the nm24 kernel at w_gate T = 128, its
   launches the nm24 engines'; ``spmm_gather``: the gathered kernel at
   w_gate T = 4 on PerRow(0.6), its launches the gathered engines'; the
   Gram's, swap_topk's and spmm's launches those of phases 4, 6, 6c, 9
   and 9m and of every 4b / 6b / 4m / 6m / 6mc run; ``gram_xtx_stacked``
   at mixtral's moe_w_down, its launches phases 4m's and 9m's;
   ``spmm_stacked`` and ``spmm_stacked_gather`` at mixtral's w_gate, nm24
   at T = 40 and gathered PerRow(0.6) at T = 4, their launches phases
   6m's, 6mc's and 9m's; the zamba and rwkv phases' Gram, swap_topk,
   swap_commit and spmm launches among them, and those of the
   cross-attention phases and of phase 4d's mesh runs: its Grams,
   swap_topk and swap_commit), the card line, and last
   {"ok": true, "device": ...}.

Where the main path's device time goes is measured apart from this
script, by ``python -m repro_torch.launch.profile_prune``.

Exits non-zero, printing no result, when CUDA is unavailable or the
script is not inside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

KERNELS = {
    "gram_xtx": ("gram", "src/repro_torch/csrc/gram.cu",
                 "src/repro/kernels/gram.py:22"),
    # the stacked calls: the reference's vmaps of kernels 1 and 5 over
    # experts, one launch of the same CUDA sources each
    "gram_xtx_stacked": ("gram", "src/repro_torch/csrc/gram.cu",
                         "src/repro/kernels/ops.py:176"),
    "swap_topk": ("swap_topk", "src/repro_torch/csrc/swap_topk.cu",
                  "src/repro/kernels/swap_topk.py:78"),
    "swap_argmin": ("swap_topk", "src/repro_torch/csrc/swap_topk.cu",
                    "src/repro/kernels/swap_argmin.py:33"),
    "swap_commit": ("swap_commit", "src/repro_torch/csrc/swap_commit.cu",
                    "src/repro/kernels/swap_topk.py:200"),
    "spmm": ("spmm", "src/repro_torch/csrc/spmm.cu",
             "src/repro/kernels/spmm.py:220"),
    "spmm_gather": ("spmm", "src/repro_torch/csrc/spmm.cu",
                    "src/repro/kernels/spmm.py:220"),
    "spmm_stacked": ("spmm", "src/repro_torch/csrc/spmm.cu",
                     "src/repro/kernels/spmm.py:490"),
    "spmm_stacked_gather": ("spmm", "src/repro_torch/csrc/spmm.cu",
                            "src/repro/kernels/spmm.py:490"),
}
PEAK_FP32 = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
T_MAX = 4                # search passes of the main path (k = 8)
SERVE_TOL = 0.05         # packed vs masked prefill logits, of max|logits|
SERVE_GEN = 16           # new tokens per request on the serve path
ROUTE_FLIPS = 0.01       # mixtral's routing decisions that may flip in a
                         # pair (other configs: scaled by near_tie_scale)
WRITE_BUDGET = 45 * 2**30   # bytes a run may write
# the other dense configs (phases 3b, 4b, 6b) and their shapes new to the
# kernels
OTHER_DENSE = ("chatglm3-6b", "granite-34b", "minitron-4b", "internlm2-20b")
GRAM_DS = (3072, 6144, 9216, 13696, 16384, 24576)
GRAM_TIMED = (13696, 24576)
SWAP_SHAPES = [                  # (R, d, site); the first two timed
    (6144, 24576, "granite-34b w_down"),
    (4096, 13696, "chatglm3-6b w_down: a 128-column last p-tile"),
    (256, 4096, "chatglm3-6b wk/wv"),
    (128, 6144, "granite-34b wk/wv: MQA"),
    (3072, 9216, "minitron-4b w_down"),
    (9216, 3072, "minitron-4b w_up"),
]
# the MoE configs (phases 3m, 4m, 6m) and their stacked kernels' shapes.
# The Gram: (E, T, d, site), T an expert's capacity buffer over a
# calibration batch of 4 x 128 tokens (mixtral: 4 x capacity(128) = 4 x
# 40; granite-moe: 4 x capacity(128) = 4 x 32). spmm: (E, d_out, d_in,
# act, site, the T an expert checked, those timed): T = 4 (a decode step
# of 4 rows: capacity(1) = 1 slot a row), 40 (mixtral's prefill of 4 x 32
# tokens: 4 x capacity(32) = 4 x 10), and the continuous scheduler's (phase
# 6mc) 8 (a decode step of 8 slots) and 20 (a 64-token prefill window:
# capacity(64)); granite-moe's 32 (its prefill of 4 x 32 tokens, phase
# 9m: 4 x capacity(32) = 4 x 8; 32 tokens are one dispatch group).
MOE = ("mixtral-8x7b", "granite-moe-3b-a800m")
GRAM_STACKED = [
    (8, 160, 4096, "mixtral-8x7b moe_w_up"),
    (8, 160, 14336, "mixtral-8x7b moe_w_down"),
    (40, 128, 1536, "granite-moe-3b moe_w_up"),
    (40, 128, 512, "granite-moe-3b moe_w_down"),
]
SPMM_STACKED = [
    (8, 14336, 4096, "silu", "mixtral-8x7b w_gate", (4, 8, 20, 40),
     (4, 8, 20, 40)),
    (8, 4096, 14336, None, "mixtral-8x7b w_down", (4, 40), (4, 40)),
    (40, 512, 1536, "silu", "granite-moe-3b w_gate", (4, 32, 40), (4, 32)),
    (40, 1536, 512, None, "granite-moe-3b w_down", (4, 32, 40), (4, 32)),
]
# zamba2-7b (phases 3z, 4z, 6z): its shapes new to the kernels — the Gram
# at d = 3584 and 7168; the swap search and commit at in_proj (14576 rows,
# 16 x 911: a ragged last 32- and 128-row block) and shared.attn.wq; spmm
# at in_proj (PerRow(0.6) keeps 1434 of 3584: k % 16 != 0) and the shared
# MLP's gelu w_gate — and the depth its paths run at: 7, so the shared
# block runs at layers 0 and 6 and its Gram sums two sites.
ZAMBA = "zamba2-7b"
ZAMBA_LAYERS = 7
ZAMBA_GRAM_DS = (3584, 7168)
ZAMBA_SWAPS = [(14576, 3584, "zamba2-7b in_proj"),
               (7168, 7168, "zamba2-7b shared.attn.wq")]
ZAMBA_SPMM = [(14576, 3584, None, "zamba2-7b in_proj"),
              (14336, 7168, "gelu", "zamba2-7b shared.mlp.w_gate")]
# rwkv6-1.6b (phases 3r, 4r, 6r): its shapes new to the kernels — the
# Gram at d = 64 (td_w2's input: tanh of the decay LoRA), 2048 (the five
# ddlerp inputs, cm_wk's and cm_wr's) and 7168 (cm_wv's relu²(k)); the swap
# search and commit at every site shape, td_w2's 64-wide rows a quarter
# of swap_topk's 256-column p-tile and one 64-column TMA box of G, td_w1's
# 64 rows two 32-row search blocks; spmm at td_w1 (64 rows: half of
# nm24's 128-row block), td_w2 (K = 64: half of nm24's 128-column tile;
# PerRow(0.6) keeps 26, k % 16 != 0), the relu2 cm_wk and the silu wg —
# and the depth its paths run at.
RWKV = "rwkv6-1.6b"
RWKV_LAYERS = 2
RWKV_GRAM_DS = (64, 2048, 7168)
RWKV_SWAPS = [(2048, 2048, "rwkv6-1.6b wr/wk/wv/wg/wo/cm_wr"),
              (64, 2048, "rwkv6-1.6b td_w1"),
              (2048, 64, "rwkv6-1.6b td_w2"),
              (7168, 2048, "rwkv6-1.6b cm_wk"),
              (2048, 7168, "rwkv6-1.6b cm_wv")]
RWKV_SPMM = [(64, 2048, None, "rwkv6-1.6b td_w1"),
             (2048, 64, None, "rwkv6-1.6b td_w2"),
             (7168, 2048, "relu2", "rwkv6-1.6b cm_wk"),
             (2048, 2048, "silu", "rwkv6-1.6b wg")]
RWKV_PROMPTS = (32, 37)          # two WKV chunks; 37 takes the pad path
# the cross-attention families (phases 3e / 4e / 6e, 3v / 4v / 6v): the
# depths their paths run at and their shapes new to the kernels. The Gram:
# (T, d, site), T the tokens of a calibration batch of 4 (4 x 128 for the
# decoder's taps; the encoder's and the cross wk / wv taps read 4 x 1024
# source frames or 4 x 1600 image tokens). The swaps: (R, d, site). spmm:
# (d_out, d_in, act, site, the T checked and timed): 4 (a decode step)
# and 128 (the prefill of 4 x 32 tokens); the prefill's 4 x 1024 / 4 x
# 1600 rows at the sites that read the source or image states.
SEAMLESS = "seamless-m4t-medium"
SEAMLESS_LAYERS = 2              # encoder and decoder layers each
SEAMLESS_GRAMS = [(512, 1024, "seamless decoder taps"),
                  (512, 4096, "seamless w_down"),
                  (4096, 1024, "seamless encoder taps, cross wk / wv")]
SEAMLESS_SWAPS = [(1024, 1024, "seamless wq / wk / wv / wo (MHA)"),
                  (4096, 1024, "seamless w_up"),
                  (1024, 4096, "seamless w_down")]
SEAMLESS_SPMM = [(4096, 1024, "relu", "seamless w_up", (4, 128, 4096)),
                 (1024, 4096, None, "seamless w_down", (4, 128, 4096)),
                 (1024, 1024, None, "seamless wq / cross wk", (4096,))]
VLM = "llama-3.2-vision-90b"
VLM_LAYERS = 5                   # one group: 4 self layers + 1 cross layer
VLM_GATES = (0.5, -0.5)          # tanh-gates of the cross attention, MLP
VLM_GRAMS = [(512, 8192, "vlm taps"),
             (512, 28672, "vlm w_down"),
             (6400, 8192, "vlm cross wk / wv over the image tokens")]
VLM_SWAPS = [(8192, 28672, "vlm w_down"),
             (28672, 8192, "vlm w_gate / w_up"),
             (8192, 8192, "vlm wq / wo"),
             (1024, 8192, "vlm wk / wv")]
VLM_SPMM = [(28672, 8192, "silu", "vlm w_gate", (4, 128)),
            (8192, 28672, None, "vlm w_down", (4, 128)),
            (1024, 8192, None, "vlm cross wk", (6400,))]
SPMM_SHAPES = [                  # (d_out, d_in, act, bias, site, timed)
    (4096, 4096, None, True, "chatglm3-6b wq", False),
    (256, 4096, None, True, "chatglm3-6b wk", False),
    (24576, 6144, "gelu", False, "granite-34b w_up", True),
    (6144, 24576, None, False, "granite-34b w_down", True),
    (128, 6144, None, False, "granite-34b wk", False),
    (9216, 3072, "relu2", False, "minitron-4b w_up", False),
    (3072, 9216, None, False, "minitron-4b w_down", False),
]


def _tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    """A check of the run that fails the script (kept under python -O)."""
    if not cond:
        raise AssertionError(msg)


# bytes of the files phase 4d (b)'s spawned ranks wrote (their wchar
# would count gloo's socket traffic too)
CHILD_WRITES = [0]


def bytes_written() -> int:
    """Bytes this process has handed to write calls so far (``wchar`` of
    /proc/self/io; 0 where the file is missing), and the files its spawned
    ranks wrote: the run's disk writes, its checkpoints and out dirs,
    held under WRITE_BUDGET."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("wchar:"):
                return int(line.split()[1]) + CHILD_WRITES[0]
    except OSError:
        pass
    return CHILD_WRITES[0]


class Phase:
    """Times a phase and prints its name, wall time and bytes written."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        self.w0 = bytes_written()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.s = time.perf_counter() - self.t0
        w = bytes_written()
        if exc[0] is None:
            log(f"   {self.name}: {self.s:.2f} s, {(w - self.w0) / 1e9:.3f} "
                f"GB written ({w / 2**30:.2f} GiB in the run so far)")


def cuda_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, *, reps: int, tries: int = 5) -> float:
    """Mean device time in ms of the CUDA kernels whose name contains
    ``kernel``, per call of ``fn()``, by torch.profiler: the kernel alone,
    without the host time of its wrapper between launches. A trace that
    lost records (the profiler drops some late in a long process) is
    taken again, up to ``tries`` times; past that the whole call is timed
    by CUDA events, an upper bound of the kernel, and a line on stderr
    says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_spmm import profiler_preroll

    fn()
    torch.cuda.synchronize()
    us: list[float] = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) == reps:
            return sum(us) / 1e3 / reps
    print(f"kernel_ms: the profiler saw {len(us)} {kernel} launches, want "
          f"{reps} ({tries} tries); the whole call timed by CUDA events "
          f"instead", file=sys.stderr, flush=True)
    return cuda_ms(fn, reps=reps)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32
          ) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def digest(tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes, in
    order: masks, swaps and losses compared bit for bit across runs."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for t in tensors:      # each tensor's bytes, hashed where they lie
        h.update(t.detach().contiguous().cpu().numpy().reshape(-1)
                 .view(np.uint8))
    return h.hexdigest()[:16]


def mask_leaves(tree):
    """A mask tree's leaves in key order, as bool tensors."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in mask_leaves(tree[k])]
    import torch

    return [tree if tree.dtype == torch.bool else tree > 0.5]


def plain_rows(R: int):
    """The rows a plain swap search is held on where the kernel runs on
    all R: every row of a problem of at most 256, else a fixed 256, the
    first 128 and the last 128-row block (a ragged tail)."""
    import torch

    if R <= 256:
        return None
    return torch.unique(torch.cat([
        torch.arange(128), torch.arange((R - 1) // 128 * 128, R)])).cuda()


def by_rows(fn, w, m, c, G, rows: int = 64):
    """A plain swap search over row blocks, so its (rows, d, chunk)
    intermediates fit in device memory."""
    import torch

    outs = [fn(w[i:i + rows], m[i:i + rows], c[i:i + rows], G)
            for i in range(0, w.shape[0], rows)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def check_swaps(w, m, c, G, k: int, tag: str, *, names, timed,
                clock_mhz: float, rows=None) -> dict:
    """The swap searches in ``names`` against their plain versions on one
    problem: swap_topk bitwise on feasible entries, swap_argmin on every
    row. The kernel runs on all rows; with ``rows`` (an index tensor) the
    plain version runs on those rows only, and they are compared (a row's
    result depends on that row and G alone). Times those in ``timed``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import swap_argmin as argmin_mod
    from repro_torch.kernels import swap_topk as topk_mod

    out = {}
    R, d = w.shape
    pairs = float(((m > 0.5).sum(1).double() * (m < 0.5).sum(1).double()).sum())
    searches = {
        "swap_topk": (lambda: ops.swap_topk(w, m, c, G, k=k),
                      lambda *a: topk_mod.swap_topk_plain(*a, k=k), k),
        "swap_argmin": (lambda: ops.swap_argmin(w, m, c, G),
                        argmin_mod.swap_argmin_plain, 1)}
    for name in names:
        kern, plain, kk = searches[name]
        got = kern()
        sub = (w, m, c)
        if rows is not None:
            got = tuple(g[rows] for g in got)
            sub = tuple(t[rows] for t in sub)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = by_rows(plain, *sub, G)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        fin = torch.isfinite(want[0])
        same_inf = torch.equal(torch.isfinite(got[0]), fin)
        if name == "swap_argmin":        # every row, the value's bits too
            equal = (torch.equal(got[0].view(torch.int32),
                                 want[0].view(torch.int32))
                     and all(torch.equal(g, t)
                             for g, t in zip(got[1:], want[1:])))
        else:
            equal = all(torch.equal(g[fin], t[fin])
                        for g, t in zip(got, want))
        in_range = all(bool(((g >= 0) & (g < d)).all()) for g in got[1:])
        err = float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() else 0.0
        log(f"   {name} {tag}: feasible {int(fin.sum())}/{fin.numel()} "
            f"bitwise-equal={equal} inf-tail-equal={same_inf} "
            f"indices-in-range={in_range} max_abs_err={err}")
        require(equal and same_inf and in_range,
                f"{name} {tag} disagrees with its plain version")
        if name in timed:
            ms = cuda_ms(kern, reps=3)
            out_bytes = R * kk * 12
            b_ms, b_by = bound(5.0 * pairs, 4.0 * (3 * R * d + d * d) + out_bytes)
            out[name] = {"max_abs_err": err, "ms": ms,
                         "plain_ms": 1e3 * plain_s, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None,
                         "shape": f"R={R} d={d}" + (f" k={k}" if kk > 1 else "")}
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            floor = 1e3 * 6.0 * pairs / (sms * 128 * clock_mhz * 1e6)
            n_plain = R if rows is None else len(rows)
            log(f"   {name} {tag}: kernel {ms:.2f} ms, plain "
                f"{1e3*plain_s:.1f} ms on {n_plain} rows, bound "
                f"{b_ms:.3f} ms ({b_by}; "
                f"{pairs:.3e} feasible pairs; kernel at "
                f"{100 * b_ms / ms:.1f}% of the bound), issue floor "
                f"{floor:.3f} ms (6 instructions per feasible pair, {sms} "
                f"SMs x 128 lanes at {clock_mhz:.0f} MHz; kernel at "
                f"{100 * floor / ms:.1f}% of it)")
    return out


def bitwise(a, b) -> bool:
    """Equal bit for bit (fp32 compared as int32, so NaNs too)."""
    import torch

    view = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return a.shape == b.shape and torch.equal(view(a), view(b))


def check_commit(w, m, c, G, k: int, tag: str, *,
                 time_it: bool = True) -> dict:
    """The commit kernels on swap_topk's candidates against their plain
    versions, bitwise: the decisions (sub-Gram gather + commit_decisions)
    and the apply (apply_commits' flips and Eq. 6). Each kernel's device
    time, bytes bound and share of it; the device time and launches of the
    whole step after the search (``profile_swap.commit_split``, as it
    times a parent tree), which must hold the two kernels once each and
    no gather or index kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import swap_topk as topk_mod
    from repro_torch.launch import profile_swap

    R, d = w.shape
    dl, u, p = ops._swap_topk(w, m, c, G, k=k)     # int32, as the step uses
    gram = ops.gram_facts(G)
    run = lambda: ops.swap_commit(w, m, c, G, dl, u, p, gram=gram)
    decide = lambda: topk_mod.swap_commit_decide_plain(w, c, G, dl, u, p,
                                                       eps=0.0)
    m2, c2, acc, dls = run()
    want_acc, want_dls = decide()
    want_m, want_c = topk_mod.swap_commit_apply_plain(w, m, c, G, acc, u, p)
    eq_decide = bitwise(acc, want_acc) and bitwise(dls, want_dls)
    eq_apply = bitwise(m2, want_m) and bitwise(c2, want_c)
    err = float((c2 - want_c).abs().max())
    n_valid = int(torch.isfinite(dl).sum())
    n_acc = int(acc.sum())
    log(f"   swap_commit {tag} k={k}: decisions bitwise-equal={eq_decide}, "
        f"apply bitwise-equal={eq_apply}, max_abs_err {err}; accepted "
        f"{n_acc}, rejected {n_valid - n_acc} of {n_valid} valid "
        f"candidates ({acc.numel()} slots); G symmetric={gram.symmetric} "
        f"max|G|={gram.amax:.6g}")
    require(eq_decide and eq_apply,
            f"swap_commit {tag} disagrees with its plain versions")
    require(0 < n_acc < n_valid,
            f"swap_commit {tag}: want accepts and rejects in the batch")
    # the column reads an asymmetric G takes, forced on this G: the same
    # bits as the row reads
    cols = ops.GramFacts(False, gram.amax)
    run_cols = lambda: ops.swap_commit(w, m, c, G, dl, u, p, gram=cols)
    eq_cols = all(bitwise(x, y) for x, y in zip(run_cols(), (m2, c2, acc,
                                                             dls)))
    require(eq_cols, f"swap_commit {tag}: column and row reads disagree")
    if not time_it:
        log(f"   swap_commit {tag}: apply by Gram columns (forced) bitwise "
            f"equal to the row reads: {eq_cols}")
        return {}
    # the apply reads both Gram rows of every candidate it cannot skip
    wu, wp = w.gather(1, u.long()), w.gather(1, p.long())
    n_full = int(((acc != 0)
                  | ~((wu.abs() + wp.abs()) * gram.amax <= 1e38)).sum())
    dec_ms = kernel_ms(run, "swap_commit_decide_kernel", reps=20)
    app_ms = kernel_ms(run, "swap_commit_apply_kernel", reps=20)
    plain_ms = cuda_ms(lambda: topk_mod.swap_commit_apply_plain(
        w, m, c, G, decide()[0], u, p), reps=3)
    # decisions: each scattered read of G, w or c costs its 32-byte sector
    dec_bytes = 32.0 * (3 * R * k * k + 4 * R * k) + 4.0 * 5 * R * k
    dec_b, dec_by = bound(16.0 * R * k * k, dec_bytes)
    # apply: c and m read and written, two Gram rows per full candidate
    app_bytes = 16.0 * R * d + 8.0 * d * n_full + 4.0 * 3 * R * k
    app_b, app_by = bound(5.0 * d * n_full, app_bytes)
    cols_ms = kernel_ms(run_cols, "swap_commit_apply_kernel", reps=3)
    log(f"   swap_commit {tag}: apply by Gram columns (forced) "
        f"{cols_ms:.4f} ms (device), bitwise equal to the row reads: "
        f"{eq_cols}")
    before = ops.LAUNCHES["swap_commit"]
    run()
    launches = ops.LAUNCHES["swap_commit"] - before
    split, _ = profile_swap.commit_split(w, m, c, G)
    step_ms = sum(ms for _, ms in split.values())
    step_n = sum(n for n, _ in split.values())
    kinds = {profile_swap._kind(name) for _, name in split}
    log(f"   swap_commit {tag}: decisions {dec_ms:.4f} ms (device), bound "
        f"{dec_b:.5f} ms ({dec_by}, {dec_bytes / 1e6:.2f} MB counted in "
        f"32-byte sectors; {100 * dec_b / dec_ms:.1f}% of it); apply "
        f"{app_ms:.4f} ms, bound {app_b:.5f} ms ({app_by}, "
        f"{app_bytes / 1e6:.1f} MB: {n_full} of {acc.numel()} candidates "
        f"read in full, {2 * n_full} Gram rows; "
        f"{100 * app_b / app_ms:.1f}% of it); plain decisions + apply "
        f"{plain_ms:.3f} ms (events); {launches} swap_commit launch count per "
        f"call (two CUDA kernels)")
    log(f"   swap_commit {tag}: the step after the search "
        f"{step_ms:.4f} ms device, {step_n:g} launches per call: " + ", ".join(
            f"{ph} {name} {ms:.4f} ms / {n:g}"
            for (ph, name), (n, ms) in sorted(split.items(),
                                              key=lambda x: -x[1][1])))
    require(split.get(("decisions", "swap_commit_decide_kernel"), [0])[0] == 1
            and split.get(("apply", "swap_commit_apply_kernel"), [0])[0] == 1
            and "gathers" not in kinds,
            f"swap_commit {tag}: the step after the search did not run as "
            f"the two commit kernels without gathers: {sorted(split)}")
    return {"max_abs_err": err, "ms": dec_ms + app_ms, "plain_ms": plain_ms,
            "bound_ms": dec_b + app_b, "bound_by": app_by,
            "library_ms": None, "shape": f"{tag} k={k}"}


def check_refined(W, G, res, pattern, tag: str) -> None:
    """Gates of a ``refine`` result: monotone row losses, exact sparsity,
    tracked losses within 1e-3 of loss_init of recomputed ones."""
    from repro_torch.core import masks, swap_math as sm

    direct = sm.row_loss(W.float(), res.mask, G)
    gap = float(((direct - res.loss_final).abs()
                 / res.loss_init.clamp(min=1e-30)).max())
    log(f"   {tag}: tracked-vs-recomputed loss gap {gap:.2e} (of loss_init)")
    require(bool((res.loss_final <= res.loss_init).all()),
            f"{tag}: a row loss rose")
    require(masks.validate_mask(res.mask, pattern),
            f"{tag}: per-row sparsity not exact")
    require(gap < 1e-3, f"{tag}: tracked losses drift from recomputed ones")


def check_gram(T: int, d: int, *, dtypes=("bf16", "fp32"),
               time_it: bool = True) -> dict:
    """gram_xtx in ``dtypes`` against its plain version (within 1e-5 of
    max|G| at T <= 512, exactly symmetric), then, if asked, device times
    with a cold L2. Returns {dtype tag: timings}.

    The kernel and the plain version are two fp32 sums of T products in
    other orders, whose rounding grows with the number of terms: past T =
    512 (phase 3's) the tolerance grows as the square root of T, 1e-5 x
    sqrt(T / 512) of max|G| (2.83e-5 at T = 4096, 3.54e-5 at 6400),
    and both are also held to the exact (fp64) Gram within it, their
    errors printed."""
    import torch
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_spmm import cold_device_ms

    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(T, d, generator=gen, device="cuda")
    flops = float(T) * d * (d + 1)           # the symmetric half
    out = {}
    for xx, tag in ((x.to(torch.bfloat16), "bf16"), (x, "fp32")):
        if tag not in dtypes:
            continue
        Gk = ops.gram_xtx(xx)
        Gp = gram_mod.gram_xtx_plain(xx)
        err = float((Gk - Gp).abs().max())
        scale = float(Gp.abs().max())
        sym = torch.equal(Gk, Gk.T)
        rel = 1e-5 * max(1.0, T / 512) ** 0.5
        log(f"   gram_xtx T={T} d={d} {tag}: max_abs_err {err:.3e} "
            f"(max|G| {scale:.3e}, {err / scale:.2e} of it; tolerance "
            f"{rel:.2e}) symmetric={sym}")
        require(err <= rel * scale and sym,
                f"gram_xtx T={T} d={d} {tag} out of tolerance")
        if T > 512:
            x64 = xx.double()
            G64 = x64.T @ x64
            e_k = float((Gk.double() - G64).abs().max())
            e_p = float((Gp.double() - G64).abs().max())
            log(f"   gram_xtx T={T} d={d} {tag}: against the exact (fp64) "
                f"Gram: kernel {e_k:.3e} ({e_k / scale:.2e} of max|G|), "
                f"plain {e_p:.3e} ({e_p / scale:.2e})")
            require(max(e_k, e_p) <= rel * scale,
                    f"gram_xtx T={T} d={d} {tag}: off the exact Gram")
            del x64, G64
        del Gk, Gp
        if not time_it:
            continue
        if tag == "bf16":
            lib_name = "torch.mm(x.T, x, out_dtype=torch.float32)"
            lib = lambda: torch.mm(xx.T, xx, out_dtype=torch.float32)
            b_ms, b_by = bound(flops, 2.0 * T * d + 4.0 * d * d, PEAK_BF16)
        else:
            lib_name = "torch.matmul(x.T, x)"
            lib = lambda: torch.matmul(xx.T, xx)
            b_ms, b_by = bound(flops, 4.0 * (T * d + d * d))
        ms, ms_lo, ms_hi = cold_device_ms(lambda: ops.gram_xtx(xx))
        plain_ms, _, _ = cold_device_ms(lambda: gram_mod.gram_xtx_plain(xx))
        lib_ms, lib_lo, lib_hi = cold_device_ms(lib)
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "shape": f"T={T} d={d} {tag}"}
        log(f"   gram_xtx T={T} d={d} {tag}: device time, median [min-max] "
            f"of 20 calls, L2 flushed: kernel {ms:.4f} [{ms_lo:.4f}-"
            f"{ms_hi:.4f}] ms ({flops / ms / 1e9:.1f} TFLOP/s on the half "
            f"it computes), plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} "
            f"[{lib_lo:.4f}-{lib_hi:.4f}] ms, bound {b_ms:.4f} ms ({b_by}; "
            f"kernel at {100 * b_ms / ms:.1f}% of the bound)")
    return out


def spmm_tol(want):
    """Elementwise bound for the spmm checks: 1e-5 of max|y|, and for a
    bf16 result one bf16 ulp of the plain element as well."""
    import torch

    w32 = want.float()
    tol = torch.full_like(w32, 1e-5 * float(w32.abs().max()))
    if want.dtype == torch.bfloat16:
        mag = w32.abs().clamp_min(torch.finfo(torch.float32).tiny)
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(mag)) - 7))
    return tol


def check_spmm(d_out: int, d_in: int, act, tag: str, *,
               time_it: bool = True, bias: bool = False,
               extra_T: tuple = (), Ts: tuple = (4, 128)) -> dict:
    """spmm against its plain version at one weight shape, T in ``Ts``
    (and the untimed ``extra_T``),
    nm24 (2:4) and gathered (PerRow 0.6 and 2:4), fp32 and bf16, with
    nm24 == gathered bitwise on the 2:4 mask; bf16 times when asked.
    With ``bias`` a random (d_out,) bias goes to both, which add it to the
    fp32 sum before the epilogue. Returns {(T, "nm24" | "gathered" |
    "gathered 2:4"): timings}."""
    import torch
    from repro_torch.core import masks, packed
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmm as spmm_mod
    from repro_torch.launch.profile_spmm import cold_device_ms

    gen = torch.Generator(device="cuda").manual_seed(d_out + d_in)
    w = torch.randn(d_out, d_in, generator=gen, device="cuda") * d_in ** -0.5
    scores = torch.rand(d_out, d_in, generator=gen, device="cuda")
    m24 = masks.make_mask(scores, masks.NM(2, 4))
    runs = {"nm24": ("nm24", m24),
            "gathered": ("gathered", masks.make_mask(scores,
                                                     masks.PerRow(0.6))),
            "gathered 2:4": ("gathered", m24)}
    del scores
    b = torch.randn(d_out, generator=gen, device="cuda") if bias else None
    tag = tag + (" +bias" if bias else "")
    out = {}
    packs = {}
    for T in tuple(Ts) + tuple(extra_T):
        x32 = torch.randn(T, d_in, generator=gen, device="cuda")
        y24 = {}
        for name, (fmt, mask) in runs.items():
            errs = {}
            for dt in (torch.float32, torch.bfloat16):
                if (name, dt) not in packs:     # packed once, every T
                    packs[name, dt] = packed.pack(w.to(dt), mask, fmt)
                pw = packs[name, dt]
                x = x32.to(dt)
                got = ops.spmm(x, pw, bias=b, act=act)
                want = spmm_mod.spmm_plain(x, pw, b, act)
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= spmm_tol(want)).all())
                errs[str(dt).split(".")[1]] = float(diff.max())
                require(ok and got.dtype == dt,
                        f"spmm {tag} T={T} {name} {dt} out of tolerance")
                if mask is m24:
                    y24.setdefault(dt, []).append(got)
            if not time_it or T in extra_T:
                log(f"   spmm {tag} ({d_out}x{d_in}, act={act}) T={T} {name} "
                    f"K={pw.k}: max_abs_err fp32 {errs['float32']:.3e} "
                    f"bf16 {errs['bfloat16']:.3e}")
                continue
            wm = (w * mask).to(torch.bfloat16)
            ms, ms_lo, ms_hi = cold_device_ms(
                lambda: ops.spmm(x, pw, bias=b, act=act))
            plain_ms, _, _ = cold_device_ms(
                lambda: spmm_mod.spmm_plain(x, pw, b, act))
            lib_ms, lib_lo, lib_hi = cold_device_ms(
                lambda: torch.matmul(x, wm.T))
            del wm
            K = pw.k
            nbytes = (2 * T * d_in + pw.nbytes + 2 * T * d_out)
            b_ms, b_by = bound(2.0 * T * d_out * K, nbytes, PEAK_BF16)
            out[(T, name)] = {"max_abs_err": errs["bfloat16"], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms,
                              "shape": f"{tag} T={T} {name} bf16"}
            log(f"   spmm {tag} ({d_out}x{d_in}, act={act}) T={T} {name} "
                f"K={K}: max_abs_err fp32 {errs['float32']:.3e} bf16 "
                f"{errs['bfloat16']:.3e}; bf16 device time, median [min-max] "
                f"of 20 cold calls: kernel {ms:.4f} [{ms_lo:.4f}-{ms_hi:.4f}] "
                f"ms, plain {plain_ms:.4f} ms, torch.matmul on masked dense "
                f"{lib_ms:.4f} [{lib_lo:.4f}-{lib_hi:.4f}] ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB; kernel at "
                f"{100 * b_ms / ms:.1f}% of the bound)")
        for dt, (y_nm, y_ga) in y24.items():
            require(torch.equal(y_nm, y_ga),
                    f"spmm {tag} T={T} {dt}: nm24 and gathered differ on "
                    "the 2:4 mask")
    return out


def check_gram_stacked(E: int, T: int, d: int, tag: str) -> dict:
    """The stacked Gram (bf16, the calibration path) against its plain
    version, within 1e-5 of max|G|, each G_e exactly symmetric and
    bitwise the unstacked kernel on its slice; one launch a call; then
    device times with a cold L2: the kernel, the plain version,
    ``torch.bmm(x.mT, x, out_dtype=torch.float32)`` on the bf16 stack
    (``library_ms``, the counterpart of phase 3's ``torch.mm`` call),
    ``torch.bmm`` over the fp32 upcast (printed only) and the bound
    (E·T·d·(d+1) operations at the bf16 peak against 2·E·T·d + 4·E·d²
    bytes)."""
    import torch
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_spmm import cold_device_ms

    gen = torch.Generator(device="cuda").manual_seed(E * d + T)
    x = torch.randn(E, T, d, generator=gen, device="cuda").to(torch.bfloat16)
    ops.reset_launches()
    Gk = ops.gram_xtx_stacked(x)
    require(ops.LAUNCHES["gram_xtx_stacked_bf16"] == 1,
            f"gram_xtx_stacked {tag}: not one launch")
    Gp = gram_mod.gram_xtx_stacked_plain(x)
    err = float((Gk - Gp).abs().max())
    scale = float(Gp.abs().max())
    del Gp
    sym = torch.equal(Gk, Gk.transpose(1, 2))
    per = all(torch.equal(Gk[e], ops.gram_xtx(x[e])) for e in range(E))
    log(f"   gram_xtx_stacked {tag} (E={E}, T={T}, d={d}) bf16: max_abs_err "
        f"{err:.3e} (max|G| {scale:.3e}, {err / scale:.2e} of it) "
        f"symmetric={sym} per expert == gram_xtx of its slice: {per}")
    require(err <= 1e-5 * scale and sym and per,
            f"gram_xtx_stacked {tag} out of tolerance")
    del Gk
    x32 = x.float()
    flops = float(E) * T * d * (d + 1)
    b_ms, b_by = bound(flops, 2.0 * E * T * d + 4.0 * E * d * d, PEAK_BF16)
    ms, lo, hi = cold_device_ms(lambda: ops.gram_xtx_stacked(x))
    plain_ms, _, _ = cold_device_ms(
        lambda: gram_mod.gram_xtx_stacked_plain(x))
    up_ms, ulo, uhi = cold_device_ms(lambda: torch.bmm(x32.mT, x32))
    del x32
    torch.cuda.empty_cache()
    lib_ms, llo, lhi = cold_device_ms(
        lambda: torch.bmm(x.mT, x, out_dtype=torch.float32))
    log(f"   gram_xtx_stacked {tag}: device time, median [min-max] of 20 "
        f"calls, L2 flushed: kernel {ms:.4f} [{lo:.4f}-{hi:.4f}] ms, plain "
        f"{plain_ms:.4f} ms, torch.bmm(x.mT, x, out_dtype=torch.float32) "
        f"{lib_ms:.4f} [{llo:.4f}-{lhi:.4f}] ms, torch.bmm on the fp32 "
        f"upcast {up_ms:.4f} [{ulo:.4f}-{uhi:.4f}] ms, bound {b_ms:.4f} ms "
        f"({b_by}; kernel at {100 * b_ms / ms:.1f}% of the bound)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"{tag} E={E} T={T} d={d} bf16"}


def check_spmm_stacked(E: int, d_out: int, d_in: int, act, tag: str, *,
                       Ts=(4, 40), timed=()) -> dict:
    """The stacked spmm at one expert shape, each T of ``Ts`` an expert,
    nm24 (2:4) and gathered (PerRow 0.6 and 2:4), fp32 and bf16: one
    launch a call, within phase 3's tolerances of the plain version, each
    expert's y bitwise the unstacked kernel on its slice, nm24 == gathered
    bitwise on the 2:4 mask; at each T of ``timed``, bf16 device times
    with a cold L2 (the kernel, the plain version, ``torch.bmm(x,
    (W⊙M)ᵀ)`` as ``library_ms``, and the bound summed over the experts).
    Returns {(T, "nm24" | "gathered" | "gathered 2:4"): timings}."""
    import dataclasses

    import torch
    from repro_torch.core import masks, packed
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmm as spmm_mod
    from repro_torch.launch.profile_spmm import cold_device_ms

    gen = torch.Generator(device="cuda").manual_seed(E + d_out + d_in)
    w = (torch.randn(E, d_out, d_in, generator=gen, device="cuda")
         * d_in ** -0.5)
    scores = torch.rand(E * d_out, d_in, generator=gen, device="cuda")
    m24 = masks.make_mask(scores, masks.NM(2, 4)).reshape(w.shape)
    m60 = masks.make_mask(scores, masks.PerRow(0.6)).reshape(w.shape)
    del scores
    runs = {"nm24": ("nm24", m24), "gathered": ("gathered", m60),
            "gathered 2:4": ("gathered", m24)}
    out = {}
    packs = {}
    for T in Ts:
        x32 = torch.randn(E, T, d_in, generator=gen, device="cuda")
        y24 = {}
        for name, (fmt, mask) in runs.items():
            errs = {}
            for dt in (torch.float32, torch.bfloat16):
                if (name, dt) not in packs:     # packed once, every T
                    packs[name, dt] = packed.pack(w.to(dt), mask, fmt)
                pw = packs[name, dt]
                x = x32.to(dt)
                ops.reset_launches()
                got = ops.spmm_stacked(x, pw, act=act)
                require(ops.LAUNCHES["spmm_stacked"] == 1
                        and ops.LAUNCHES["spmm"] == 0,
                        f"spmm_stacked {tag} T={T} {name}: not one launch")
                want = spmm_mod.spmm_stacked_plain(x, pw, None, act)
                diff = (got.float() - want.float()).abs()
                require(bool((diff <= spmm_tol(want)).all())
                        and got.dtype == dt,
                        f"spmm_stacked {tag} T={T} {name} {dt} out of "
                        "tolerance")
                errs[str(dt).split(".")[1]] = float(diff.max())
                for e in range(E):
                    one = dataclasses.replace(pw, values=pw.values[e],
                                              idx=pw.idx[e])
                    require(torch.equal(got[e], ops.spmm(x[e], one, act=act)),
                            f"spmm_stacked {tag} T={T} {name} {dt}: expert "
                            f"{e} differs from the unstacked kernel")
                if mask is m24:
                    y24.setdefault(dt, []).append(got)
            line = (f"   spmm_stacked {tag} (E={E}, {d_out}x{d_in}, act={act}"
                    f") T={T} {name} K={pw.k}: max_abs_err fp32 "
                    f"{errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; "
                    f"every expert bitwise the unstacked kernel")
            if T not in timed:
                log(line)
                continue
            wm = (w * mask).to(torch.bfloat16)
            ms, lo, hi = cold_device_ms(lambda: ops.spmm_stacked(x, pw,
                                                                 act=act))
            plain_ms, _, _ = cold_device_ms(
                lambda: spmm_mod.spmm_stacked_plain(x, pw, None, act))
            lib_ms, llo, lhi = cold_device_ms(
                lambda: torch.bmm(x, wm.transpose(1, 2)))
            del wm
            K = pw.k
            nbytes = E * (2 * T * d_in + 2 * T * d_out) + pw.nbytes
            b_ms, b_by = bound(2.0 * E * T * d_out * K, nbytes, PEAK_BF16)
            out[(T, name)] = {"max_abs_err": errs["bfloat16"], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms,
                              "shape": f"{tag} E={E} T={T} {name} bf16"}
            log(f"{line}; bf16 device time, median [min-max] of 20 cold "
                f"calls: kernel {ms:.4f} [{lo:.4f}-{hi:.4f}] ms, plain "
                f"{plain_ms:.4f} ms, torch.bmm on masked dense {lib_ms:.4f} "
                f"[{llo:.4f}-{lhi:.4f}] ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{nbytes / 1e6:.1f} MB; kernel at {100 * b_ms / ms:.1f}% of "
                f"the bound)")
        for dt, (y_nm, y_ga) in y24.items():
            require(torch.equal(y_nm, y_ga),
                    f"spmm_stacked {tag} T={T} {dt}: nm24 and gathered "
                    "differ on the 2:4 mask")
        del x32, y24
    del w, m24, m60
    torch.cuda.empty_cache()
    return out


def moe_shapes() -> dict:
    """Phase 3m: the stacked Gram at GRAM_STACKED and the stacked spmm at
    SPMM_STACKED, each held and timed as ``check_gram_stacked`` and
    ``check_spmm_stacked`` say. Returns the kernels line's rows."""
    grams = {tag: check_gram_stacked(E, T, d, tag)
             for E, T, d, tag in GRAM_STACKED}
    spmm = {}
    for E, d_out, d_in, act, tag, Ts, timed in SPMM_STACKED:
        spmm[tag] = check_spmm_stacked(E, d_out, d_in, act, tag, Ts=Ts,
                                       timed=timed)
    return {"gram_xtx_stacked": grams["mixtral-8x7b moe_w_down"],
            "spmm_stacked": spmm["mixtral-8x7b w_gate"][(40, "nm24")],
            "spmm_stacked_gather": spmm["mixtral-8x7b w_gate"][
                (4, "gathered")]}


def forced_logits(eng, prompt: dict, tokens):
    """(n_new, B, vocab) fp32 logits of ``eng``'s model at the prefill and
    at each decode step, fed ``tokens`` (B, n_new) in place of its own
    greedy choices; the cache is sized as ``generate`` sizes it."""
    import torch
    from repro_torch.serve.engine import next_pow2

    api = eng.api
    B, S = prompt["tokens"].shape
    n_new = tokens.shape[1]
    with torch.no_grad():
        cache = api.init_cache(eng.params, B, next_pow2(S + n_new))
        logits, cache = api.prefill(eng.params, prompt, cache,
                                    masks=eng.masks)
        out = [logits[:, -1].float()]
        for i in range(n_new - 1):
            logits, cache = api.decode_step(eng.params, tokens[:, i:i + 1],
                                            cache, masks=eng.masks)
            out.append(logits[:, -1].float())
    return torch.stack(out)


class RouteTape:
    """Routing teacher-forced, as ``forced_logits`` forces the tokens: an
    MoE model's top-k routing is a discrete choice, and where two of a
    token's router logits nearly tie, the 1-2 bf16 ulps between a packed
    and a masked run's hidden states can send it to another expert, whose
    output differs by O(1). ``record`` keeps every ``models.moe.route``
    call's (logits, expert ids) of one run; ``replay`` makes the calls of
    another run, in the same order, take the recorded ids (with gates
    from its own logits at them) and notes each token whose own top-k
    differs (a flip): the recorded run's gap between its k-th and
    (k+1)-th logits there, and the largest router-logit difference
    between the runs at that token. A run along other shapes (prefill
    windows, one row of a batch) replays a ``seq`` cut from the record
    (``windows``, ``row``). ``max_diff`` is the largest router-logit
    difference over every replayed token. ``own`` keeps, per replayed
    call, the (logits, expert ids) the replaying run would have taken on
    its own there (``unwindow`` puts a windowed run's back into the
    one-shot layout), so ``first_route_split`` can tell the near-ties the
    two runs resolve alike from those they split on."""

    def __init__(self):
        self.calls, self.flips, self.tokens, self.max_diff = [], [], 0, 0.0
        self.own = []
        self.routing = (8, 2)                  # (experts, top-k) replayed

    def _patched(self, fn):
        import contextlib

        from repro_torch.models import moe

        @contextlib.contextmanager
        def ctx():
            orig, moe.route = moe.route, lambda *a, **kw: fn(orig, *a, **kw)
            try:
                yield self
            finally:
                moe.route = orig
        return ctx()

    def record(self):
        def fn(orig, x, router, k):
            logits, ids, gates = orig(x, router, k)
            self.calls.append((logits.clone(), ids.clone()))
            return logits, ids, gates
        return self._patched(fn)

    def replay(self, seq=None):
        import torch
        it = iter(self.calls if seq is None else seq)

        def fn(orig, x, router, k):
            logits, ids, _ = orig(x, router, k)
            ref_logits, ref_ids = next(it)
            flip = (ids.sort(-1).values != ref_ids.sort(-1).values).any(-1)
            gap = topk_gap(ref_logits, k)
            diff = (logits - ref_logits).abs().amax(-1)
            self.flips += list(zip(gap[flip].tolist(), diff[flip].tolist()))
            self.tokens += flip.numel()
            self.max_diff = max(self.max_diff, float(diff.max()))
            self.own.append((logits.clone(), ids.clone()))
            self.routing = (logits.shape[-1], k)
            return (logits, ref_ids,
                    torch.softmax(logits.gather(-1, ref_ids), dim=-1))
        return self._patched(fn)

    def windows(self, n_layers: int, n_valid: int, window: int) -> list:
        """The record of a one-shot prefill (its first ``n_layers`` calls)
        and decode steps, cut for the same run prefilled in
        ``window``-token windows: each window's layers, in order, then
        the decode steps' calls as recorded."""
        pre = self.calls[:n_layers]
        return [(lg[:, w:w + window], ids[:, w:w + window])
                for w in range(0, n_valid, window) for lg, ids in pre
                ] + self.calls[n_layers:]

    def row(self, i: int) -> list:
        """The record of a batched run, cut to its row ``i``."""
        return [(lg[i:i + 1], ids[i:i + 1]) for lg, ids in self.calls]

    def unwindow(self, n_layers: int, n_valid: int, window: int) -> list:
        """``own`` of a replay of ``windows(n_layers, n_valid, window)``,
        back in the one-shot layout: each layer's windows joined along
        the positions (the valid ones, ``n_valid``), then the decode
        steps' calls."""
        import torch

        n_pre = n_layers * -(-n_valid // window)
        pre = self.own[:n_pre]
        return [tuple(torch.cat([pre[w + l][j] for w in range(0, n_pre,
                                                                n_layers)],
                                dim=1)[:, :n_valid] for j in range(2))
                for l in range(n_layers)] + self.own[n_pre:]

    def check(self, tag: str) -> None:
        """Fails unless every flip was a near tie (gap at most twice the
        router-logit difference) and at most ROUTE_FLIPS of the decisions
        flipped, scaled by ``near_tie_scale`` of the routing replayed."""
        bound = ROUTE_FLIPS * near_tie_scale(*self.routing)
        require(all(g <= 2 * d for g, d in self.flips),
                f"{tag}: a routing decision flips away from a near tie")
        require(len(self.flips) <= bound * self.tokens,
                f"{tag}: {len(self.flips)} of {self.tokens} routing "
                f"decisions flip, more than {bound:.1%}")

    def summary(self) -> str:
        return (f"{len(self.flips)} of {self.tokens} routing decisions flip "
                f"unforced, (top-k gap, router-logit difference): "
                f"{[(round(g, 6), round(d, 6)) for g, d in self.flips[:8]]}")


def near_tie_scale(n_experts: int, k: int) -> float:
    """How much more often a config's routing nearly ties than
    mixtral-8x7b's (8 experts, top-2), for router logits drawn i.i.d.
    normal: the expected gap between the k-th and (k+1)-th largest of E
    is about 1 / (E·φ(Φ⁻¹(1 - k/E))), and the share of decisions an ulp
    of rounding can flip grows as that gap shrinks (granite-moe-3b's 40
    experts, top-8: 4.4x)."""
    from statistics import NormalDist

    nd = NormalDist()
    gap = lambda e, kk: 1 / (e * nd.pdf(nd.inv_cdf(1 - kk / e)))  # noqa: E731
    return gap(8, 2) / gap(n_experts, k)


def topk_gap(logits, k: int):
    """(..., E) router logits -> (...) gap between the k-th and (k+1)-th
    largest: how near a token's routing is to a tie."""
    top = logits.sort(-1, descending=True).values
    return top[..., k - 1] - top[..., k]


def routed_pair(eng, ref_eng, prompt: dict, tokens, tag: str) -> float:
    """An MoE pair's logits error with both the tokens and the routing
    teacher-forced (``RouteTape``): the reference engine's forced run
    records its routing, the other's replays it, and the routing
    decisions that would have flipped are printed with their top-k gap
    and router-logit difference. Fails unless every flip is a near tie
    (its gap at most twice the difference, which any flip of a true
    top-k needs) and at most ROUTE_FLIPS of the decisions flip. Returns
    the largest logits error."""
    tape = RouteTape()
    with tape.record():
        ref = forced_logits(ref_eng, prompt, tokens)
    with tape.replay():
        got = forced_logits(eng, prompt, tokens)
    err = float((got - ref).abs().max())
    log(f"   {tag}, routing teacher-forced too: logits max_abs_err "
        f"{err:.4e} ({err / float(ref.abs().max()):.2e} of max|logits|); "
        f"{tape.summary()}")
    tape.check(tag)
    return err


def spmm_device_ms(eng, prompt: dict, launches: int,
                   tries: int = 5) -> tuple[float | None, float]:
    """Device time in ms of the spmm kernels (product and split reduction)
    of one warm ``generate`` by torch.profiler, and the generate's wall
    ms. The profiler must see all ``launches`` product kernels: a trace
    that lost records is taken again, up to ``tries`` times, and past
    that the device time is None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_spmm import profiler_preroll

    n, wall = 0, 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()
            t0 = time.perf_counter()
            eng.generate(prompt, SERVE_GEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ms, n = 0.0, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "spmm_" in e.name or "splitk_reduce" in e.name:
                ms += e.time_range.elapsed_us() / 1e3
                n += "spmm_" in e.name
        if n == launches:
            return ms, 1e3 * wall
    print(f"spmm_device_ms: the profiler saw {n} spmm product kernels of a "
          f"generate, want {launches} ({tries} tries)", file=sys.stderr,
          flush=True)
    return None, 1e3 * wall


def serve_bench(engines: dict, prompt: dict, launches: dict) -> dict:
    """Phase 6's timings: 3 warm ``generate``s per engine (prefill ms,
    decode tok/s, weight bytes; best of 3), then each packed engine's spmm
    device time in one more. Returns the warm results per engine."""
    warm = {name: [] for name in engines}
    for _ in range(3):
        for name, eng in engines.items():
            warm[name].append(eng.generate(prompt, SERVE_GEN))
    B, S = prompt["tokens"].shape
    for name, eng in engines.items():
        pre = min(r.prefill_s for r in warm[name])
        dec = max(r.tok_s for r in warm[name])
        log(f"   {name:13s} prefill {1e3 * pre:8.3f} ms "
            f"({B * S / pre:9.1f} tok/s)  decode {dec:8.1f} tok/s "
            f"({1e3 / (dec / B):7.3f} ms/step)  weights "
            f"{eng.weight_bytes():>11d} B  kernel_used {eng.kernel_used}")
    for name, eng in engines.items():
        if launches[name]:
            ms, wall = spmm_device_ms(eng, prompt, launches[name])
            ms = ("not measured (the profiler lost records)" if ms is None
                  else f"{ms:.4f} ms")
            log(f"   {name:13s} one warm generate: spmm device time "
                f"{ms} (all {launches[name]} product kernels "
                f"and their split reductions), generate {wall:.3f} ms wall")
    return warm


def shared_sites(cfg) -> int:
    """How many times a forward runs a hybrid model's shared block (its
    invocation sites: every ``shared_attn_every`` layers); 0 without one."""
    from repro_torch.models import zamba

    return zamba.n_sites(cfg) if cfg.family == "hybrid" else 0


def prefill_only(name: str) -> bool:
    """Whether a site runs at the prefill alone: an encoder's, and the
    cross wk / wv, which project the frontend states once into the cross
    KV."""
    return name.startswith("enc_layers.") or name in (
        "dec_layers.xattn.wk", "dec_layers.xattn.wv",
        "cross_layers.attn.wk", "cross_layers.attn.wv")


def spmm_sites(cfg, params, *, prefill: bool = False) -> dict:
    """A served model's spmm launches a forward (a decode step, a
    scheduler dispatch; a prefill with ``prefill``), by kernel: {"spmm":
    the unstacked sites, each once an instance (a layer, a VLM's self
    layer of a group; a shared block's once a site it runs at), the
    prefill-only sites (``prefill_only``) at the prefill alone,
    "spmm_stacked": an MoE model's expert sites, once a layer}."""
    from repro_torch.pruning import sites

    out = {"spmm": 0, "spmm_stacked": 0}
    for s in sites.site_specs(cfg, params):
        if not s.stack_shape:
            out["spmm"] += shared_sites(cfg)
        elif cfg.is_moe and len(s.stack_shape) == 2:
            out["spmm_stacked"] += s.stack_shape[0]
        elif prefill or not prefill_only(s.name):
            out["spmm"] += s.n_instances
    return out


def serve_path(api, params, masks60: dict, masks24: dict, prompt: dict, *,
               bench: bool = True, gate: bool = True, also=None):
    """Phase 6 (and 6b, 6m with ``bench=False``: no timed runs or
    profiles). Returns the spmm launches of each engine's first generate, {"spmm": unstacked
    calls, "spmm_stacked": stacked ones (an MoE model's experts)}.

    ``gate=False`` (6z's bf16 engines) prints the packed vs masked logits
    without holding them to SERVE_TOL: bf16 rounding alone carries a model
    of many recurrent layers past it (zamba2-7b at 7 random layers: masked
    and packed bf16 each 8-19% of max|logits| from the masked model in
    fp32), so 6z holds the same engines built at float32 instead.

    ``also(engines)``, if given, runs last, on the six engines ({"dense",
    "masked_0.6", ...}), after the launches are counted."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    specs = {"dense": (None, "dense"), "masked_0.6": (masks60, "masked"),
             "gathered_0.6": (masks60, "gathered"),
             "masked_2:4": (masks24, "masked"), "nm24_2:4": (masks24, "nm24"),
             "gathered_2:4": (masks24, "gathered")}
    n_sites = spmm_sites(api.cfg, params)
    n_first = spmm_sites(api.cfg, params, prefill=True)
    engines = {name: ServeEngine(api, params, masks=m, fmt=fmt)
               for name, (m, fmt) in specs.items()}
    for name, eng in engines.items():
        log(f"   {name}: packed in {eng.pack_s:.2f} s, "
            f"{eng.weight_bytes() / 2**30:.3f} GiB of weights")
    ops.reset_launches()
    cold, serve_launches = {}, {}
    for name, eng in engines.items():
        before = {k: ops.LAUNCHES[k] for k in n_sites}
        cold[name] = eng.generate(prompt, SERVE_GEN)
        n = serve_launches[name] = {k: ops.LAUNCHES[k] - v
                                    for k, v in before.items()}
        packed = specs[name][1] in ("nm24", "gathered")
        want = {k: n_first[k] + v * (SERVE_GEN - 1) if packed else 0
                for k, v in n_sites.items()}
        require(n == want, f"{name}: spmm launches {n}, want {want}")
    warm = (serve_bench(engines, prompt, {k: sum(v.values()) for k, v in
                                          serve_launches.items()})
            if bench else {name: [] for name in engines})
    traces = {name: eng.logits_trace(prompt, SERVE_GEN)
              for name, eng in engines.items()}
    toks = {name: [r.tokens for r in warm[name]] + [cold[name].tokens]
            for name in engines}
    for name in engines:                      # greedy decode is repeatable
        require(all(torch.equal(t, toks[name][0]) for t in toks[name]),
                 f"{name}: tokens differ between runs")
    require(torch.equal(traces["nm24_2:4"], traces["gathered_2:4"])
            and torch.equal(toks["nm24_2:4"][0], toks["gathered_2:4"][0]),
            "nm24 and gathered disagree on the 2:4 masks")
    log("   nm24 == gathered (2:4 masks): tokens and logits bitwise equal")
    for packed_name, masked_name in (("nm24_2:4", "masked_2:4"),
                                     ("gathered_2:4", "masked_2:4"),
                                     ("gathered_0.6", "masked_0.6")):
        ref = traces[masked_name]
        forced = forced_logits(engines[packed_name], prompt,
                               toks[masked_name][0])
        scale = float(ref.abs().max())
        errs = (forced - ref).abs().amax(dim=(1, 2))      # per position
        err = float(errs.max())
        prune_gap = float((traces["dense"][0] - ref[0]).abs().max())
        agree = float((toks[packed_name][0] == toks[masked_name][0])
                      .float().mean())
        log(f"   {packed_name} vs {masked_name} (fed the masked tokens): "
            f"logits max_abs_err prefill {float(errs[0]):.4e}, decode steps "
            f"{float(errs[1:].max()):.4e} ({err / scale:.2e} of "
            f"max|logits| {scale:.3f}; dense vs masked prefill "
            f"{prune_gap:.4e}); free-running greedy "
            f"tokens agree {100 * agree:.1f}%")
        if api.cfg.is_moe:
            err = routed_pair(engines[packed_name], engines[masked_name],
                              prompt, toks[masked_name][0],
                              f"{packed_name} vs {masked_name}")
        require(not gate or (math.isfinite(err)
                             and err <= SERVE_TOL * scale),
                f"{packed_name} vs {masked_name} beyond {SERVE_TOL} of "
                "max|logits|")
    require(engines["nm24_2:4"].weight_bytes()
            < engines["masked_2:4"].weight_bytes(),
            "nm24 holds no fewer weight bytes than masked")
    if also is not None:
        also(engines)
    return serve_launches


XATTN_KV_TOL = 1e-2      # packed vs masked cross KV, of max|k| and max|v|


def check_cross_path(engines: dict, prompt: dict, other: dict,
                     tag: str) -> None:
    """6e / 6v: the cross-attention path on a scale of its own, where the
    logits cannot show it (the VLM's cross attention moves its random
    model's logits by ~3e-3 of their max, below bf16 rounding).

    * For each packed engine and its masked one, every layer's
      precomputed cross KV (``precompute_cross_kv``, what prefill stores)
      of the same source states (the image states; the masked model's
      encoder output) within XATTN_KV_TOL of its max, element by element,
      and the masked KV off the dense KV by far more (the masks bite);
    * the cross attention on that KV (``cross_attention`` with
      ``kv_cache``, as prefill and decode run it: q and the output
      projection packed or masked) of the same unit-normal queries within
      SERVE_TOL of max|out|;
    * every engine's logits, at the prefill and at a decode step, change
      with the frontend states (``other``): a cross layer that the served
      path skipped would leave them bitwise equal."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer

    any_eng = engines["dense"]
    cfg, mod = any_eng.cfg, any_eng.api.module
    vlm = bool(cfg.cross_attn_every)
    key = "img" if vlm else "src"
    layers, sub = (("cross_layers", "attn") if vlm
                   else ("dec_layers", "xattn"))
    dev = prompt["tokens"].device
    gen = torch.Generator(device=dev).manual_seed(7)
    h = torch.randn(*prompt["tokens"].shape, cfg.d_model, generator=gen,
                    device=dev).to(getattr(torch, cfg.dtype))

    def kv_and_out(eng, states):
        kv = mod.precompute_cross_kv(eng.params, states, cfg,
                                     masks=eng.masks)
        m = None if eng.masks is None else eng.masks[layers].get(sub)
        outs = [attn.cross_attention(
            transformer._index(eng.params[layers], i)[sub], h, None, cfg,
            masks=transformer._index(m, i), kv_cache=(kv[0][i], kv[1][i]))
            for i in range(kv[0].shape[0])]
        return kv, torch.stack(outs)

    with torch.no_grad():
        for packed_name, masked_name in (("nm24_2:4", "masked_2:4"),
                                         ("gathered_2:4", "masked_2:4"),
                                         ("gathered_0.6", "masked_0.6")):
            p, m = engines[packed_name], engines[masked_name]
            if vlm:
                states = prompt["img"].to(h.dtype)
            else:
                states, _ = mod.encode(m.params, prompt["src"], cfg,
                                       masks=m.masks)
            (kp, vp), op = kv_and_out(p, states)
            (km, vm), om = kv_and_out(m, states)
            (kd, vd), _ = kv_and_out(engines["dense"], states)
            for nm, got, want, dense in (("k", kp, km, kd),
                                         ("v", vp, vm, vd)):
                scale = float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                gap = float((dense.float() - want.float()).abs().max())
                log(f"   6{tag} cross {nm} {tuple(got.shape)}: "
                    f"{packed_name} vs {masked_name} max_abs_err {err:.4e} "
                    f"({err / scale:.2e} of max {scale:.3f}); dense vs "
                    f"masked {gap:.4e} ({gap / scale:.2e})")
                require(math.isfinite(err) and err <= XATTN_KV_TOL * scale,
                        f"6{tag} {packed_name}: cross {nm} beyond "
                        f"{XATTN_KV_TOL} of max")
                require(gap > 10 * XATTN_KV_TOL * scale,
                        f"6{tag} {masked_name}: the cross {nm} ignores the "
                        "masks")
            scale = float(om.float().abs().max())
            err = float((op.float() - om.float()).abs().max())
            log(f"   6{tag} cross attention out {tuple(op.shape)}: "
                f"{packed_name} vs {masked_name} max_abs_err {err:.4e} "
                f"({err / scale:.2e} of max {scale:.3f})")
            require(math.isfinite(err) and err <= SERVE_TOL * scale,
                    f"6{tag} {packed_name}: cross attention beyond "
                    f"{SERVE_TOL} of max")
    for name, eng in engines.items():
        a, b = eng.logits_trace(prompt, 2), eng.logits_trace(other, 2)
        gaps = (a - b).abs().amax(dim=(1, 2))       # prefill, decode step
        scale = float(a.abs().max())
        log(f"   6{tag} {name}: other {key} states move the logits by "
            + ", ".join(f"{float(g) / scale:.2e}" for g in gaps)
            + " of max|logits| (prefill, decode step)")
        require(bool((gaps > 0).all()),
                f"6{tag} {name}: the served logits ignore {key}")


# continuous serving (phase 6c): the chunked-prefill window, the prompt
# lengths held chunked vs one-shot; the load rows' arrival rate, below the
# continuous path's saturation (~18 requests/s on an H100 in
# ``launch/profile_serve.py``'s sweep: goodput follows the rate to 16/s
# and makespans pass 1.6x the window at 24 and 32/s; a saturated queue is
# driven by 6mc), the expected requests (the window is this / rate), and
# those of the fixed path's row (it saturates by 2/s).
# The scheduler's shape and the traffic (CONT, LOAD_PROMPT, LOAD_OUTPUT)
# are profile_serve's.
CHUNK_W = 64
CHUNK_PROMPTS = (100, 300, 500)
LOAD_RATES = (8.0,)
LOAD_REQUESTS = 64
FIXED_REQUESTS = 16


def token_ids(n: int, seed: int, vocab: int):
    import numpy as np

    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(
        np.int32)


def sched_traffic(vocab: int):
    """Phases 6c's and 6mc's requests, (prompt, max_new, SamplingParams):
    (mixed: the reference test's four greedy and sampled requests; longs:
    {S: prompt} of CHUNK_PROMPTS, held chunked vs one-shot; short: four
    32-token prompts, phase 6's shape; disagg: mixed, a long sampled
    request and a one-token one)."""
    from repro_torch.serve import GREEDY, SamplingParams

    ids = lambda n, seed: token_ids(n, seed, vocab)  # noqa: E731
    mixed = [(ids(7, 1), 6, GREEDY),
             (ids(12, 2), 9, SamplingParams(temperature=0.8, seed=4)),
             (ids(5, 3), 3, SamplingParams(temperature=1.2, top_p=0.9,
                                           top_k=32, seed=5)),
             (ids(9, 4), 7, GREEDY)]
    longs = {S: ids(S, 10 + S) for S in CHUNK_PROMPTS}
    short = [ids(32, 20 + i) for i in range(4)]
    disagg = mixed + [(longs[300], 8, SamplingParams(temperature=0.9,
                                                     top_p=0.95, seed=9)),
                      (ids(20, 5), 1, GREEDY)]
    return mixed, longs, short, disagg


def sched_run(eng, reqs, n_sites: dict, **kw):
    """Serve ``reqs`` — (prompt, max_new, SamplingParams) — through one
    ``ContinuousScheduler`` (``CONT``, plus ``kw``) until idle. Checks that
    the pools end empty and, phase 6c (e), that the engine launched each
    spmm kernel of ``n_sites`` (``spmm_sites``: its launches a forward)
    times (prefill dispatches + decode steps), counted from the
    scheduler's own dispatches (none for dense and masked, nor off the
    card). Returns (tokens per request,
    scheduler, {kernel: launches})."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import CONT
    from repro_torch.serve import ContinuousScheduler

    before = {k: ops.LAUNCHES[k] for k in n_sites}
    sch = ContinuousScheduler(eng, **CONT, **kw)
    rids = [sch.submit(p, n, sampling=s) for p, n, s in reqs]
    done = sch.run_until_idle()
    n = {k: ops.LAUNCHES[k] - v for k, v in before.items()}
    d = sch.dispatches
    per = (d["prefill"] + d["decode_steps"]
           if eng.fmt in ("nm24", "gathered") and eng.device.type == "cuda"
           else 0)
    want = {k: v * per for k, v in n_sites.items()}
    require(n == want, f"{eng.fmt}: spmm launches {n} for {d}, want {want}")
    require(sch.pool.used_bytes == 0 and (
        sch.prefill_pool is None or sch.prefill_pool.used_bytes == 0),
        f"{eng.fmt}: pages leaked")
    return [done[r].tokens for r in rids], sch, n


def forced_run(eng, tokens, n_valid: int, cap: int, feed, window=None):
    """Prefill ``tokens`` (B, S_pad; right-padded past ``n_valid``) into a
    cache of ``cap`` slots, in one shot (``window`` None) or in
    ``window``-token ``prefill_window`` calls, then one decode step per
    column of ``feed`` (B, n) on the same cache, or, for an int ``feed``,
    that many steps fed their own greedy tokens. Returns the (n + 1, B, V)
    fp32 logits, the K, V of the valid prompt positions and the tokens
    fed."""
    import torch

    api, dev = eng.api, eng.device
    nv = torch.tensor(n_valid, device=dev)
    with torch.no_grad():
        cache = api.init_cache(eng.params, tokens.shape[0], cap)
        if window is None:
            logits, cache = api.prefill(eng.params, {"tokens": tokens,
                                                     "n_valid": nv},
                                        cache, masks=eng.masks)
        else:
            for off in range(0, n_valid, window):
                logits, cache = api.prefill_window(
                    eng.params, {"tokens": tokens[:, off:off + window],
                                 "offset": torch.tensor(off, device=dev),
                                 "n_valid": nv}, cache, masks=eng.masks)
        kv = (cache.kv.k[:, :, :n_valid].clone(),
              cache.kv.v[:, :, :n_valid].clone())
        out, fed = [logits[:, -1].float()], []
        n = feed if isinstance(feed, int) else feed.shape[1]
        for i in range(n):
            tok = (out[-1].argmax(-1)[:, None] if isinstance(feed, int)
                   else feed[:, i:i + 1])
            fed.append(tok)
            logits, cache = api.decode_step(eng.params, tok, cache,
                                            masks=eng.masks)
            out.append(logits[:, -1].float())
    return torch.stack(out), kv, torch.cat(fed, dim=1)


def cross_shape(a, b) -> dict:
    """Two forced runs of the same tokens along different shapes: the
    largest |dK|, |dV| over valid positions, the logits' largest error and
    scale, and the greedy tokens that flip. In a teacher-forced pair a
    flip sits at a top-2 gap within twice that step's logits error, so
    the logits' bound is what holds the flips."""
    import torch

    (la, (ka, va), _), (lb, (kb, vb), _) = a, b
    diff = lambda x, y: float((x.float() - y.float()).abs().max())
    flips = la.argmax(-1) != lb.argmax(-1)
    gaps = top2_gap(la)[flips]
    return {"dk": diff(ka, kb), "dv": diff(va, vb), "err": diff(la, lb),
            "scale": float(la.abs().max()), "flips": int(flips.sum()),
            "n": flips.numel(),
            "gap": float(gaps.max()) if gaps.numel() else None}


def top2_gap(logits):
    """(..., V) logits -> (...) gap between the two largest."""
    import torch

    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def check_cross(name: str, what: str, r: dict) -> None:
    """Prints a cross-shape comparison and gates its logits at SERVE_TOL
    of max|logits| (the serving tolerance of phase 6)."""
    rel = r["err"] / r["scale"]
    flips = (f"{r['flips']} of {r['n']} greedy tokens flip, at top-2 gaps "
             f"<= {r['gap']:.4e}" if r["flips"] else
             f"all {r['n']} greedy tokens agree")
    log(f"   {name} {what}: max |dK| {r['dk']:.3e} |dV| "
        f"{r['dv']:.3e} over valid positions; teacher-forced logits "
        f"max_abs_err {r['err']:.4e} ({rel:.2e} of max|logits| "
        f"{r['scale']:.3f}); {flips}")
    require(math.isfinite(r["err"]) and r["err"] <= SERVE_TOL * r["scale"],
            f"{name} {what}: logits beyond {SERVE_TOL} of max|logits|")


def check_streams(name: str, what: str, got, want, ref, err: float,
                  route_near: int | None = None) -> tuple[str, bool]:
    """Phase 6c (b)'s token gate across shapes: the greedy streams ``got``
    and ``want`` (n tokens each) must agree up to the first near-tie, a
    step whose reference logits ``ref`` (n, V; fed ``want``'s tokens)
    have a top-2 gap within twice ``err``, or (MoE) the first token a
    routing near-tie the two runs split on may change (``route_near``,
    from ``first_route_split``). The scheduler decodes at still other
    shapes (8 rows over 1024 slots) than the forced pair that measured
    ``err``, so ``err`` is that pair's largest logits error, not its
    error at the step. Returns a summary and whether the gate held any
    token (its first near-tie past step 0)."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    n = len(want)
    differ = np.flatnonzero(got[:n] != want)
    first_diff = int(differ[0]) if differ.size else n
    near = np.flatnonzero((top2_gap(ref[:n]) <= 2 * err).cpu().numpy())
    first_near = int(near[0]) if near.size else n
    if route_near is not None:
        first_near = min(first_near, route_near)
    require(first_diff >= first_near,
            f"{name} {what}: greedy tokens differ at step {first_diff}, "
            f"before the first near-tie (step {first_near}, top-2 gap <= "
            f"{2 * err:.4e})")
    return f"{first_diff}/{n} (near-tie at {first_near})", first_near > 0


def gated_line(tag: str, pairs: dict) -> None:
    """Prints how many of each pair's streams the gate held past step 0
    (``check_streams``' second value)."""
    log(f"   {tag}: streams gated past step 0: " + ", ".join(
        f"{what} {sum(g for _, g in res)} of {len(res)}"
        for what, res in pairs.items()))


def cross_shape_checks(eng, name: str, longs: dict, short: list,
                       n_sites: dict) -> int:
    """Phase 6c (b): comparisons across shapes, where the card's matmuls
    (cuBLAS, spmm's split plan) may round a row otherwise: chunked
    (CHUNK_W-token windows) vs one-shot prefill of each long prompt into
    its pow2 bucket, and the fixed path's batch-4 prefill of the short
    prompts vs each alone, teacher-forced (logits within SERVE_TOL).
    Then the same prompts' greedy tokens through the scheduler, chunked
    vs one-shot, and the scheduler (B = 1 prefill) vs ``generate``
    (B = 4): each pair equal up to the first near-tie, judged on the
    one-shot (batch) path's logits fed the stream and the largest logits
    error of the forced pair (``check_streams``). Returns the spmm
    launches of its scheduler runs."""
    import numpy as np
    import torch
    from repro_torch.serve import GREEDY
    from repro_torch.serve.engine import next_pow2

    dev = eng.device
    n_new = 8
    reqs = [(p, n_new, GREEDY) for p in longs.values()]
    sch_one, _, n1 = sched_run(eng, reqs, n_sites, bucket_batch=False)
    sch_chunk, _, n2 = sched_run(eng, reqs, n_sites, bucket_batch=False,
                                 prefill_chunk=CHUNK_W)
    agree = []
    for (S, p), got, want in zip(longs.items(), sch_chunk, sch_one):
        sb = next_pow2(S)
        toks = torch.zeros((1, sb), dtype=torch.int64)
        toks[0, :S] = torch.from_numpy(p.astype(np.int64))
        toks = toks.to(dev)
        one = forced_run(eng, toks, S, sb, n_new)
        r = cross_shape(one, forced_run(eng, toks, S, sb, one[2],
                                        window=CHUNK_W))
        check_cross(f"6c (b) {name}", f"S={S} chunked W={CHUNK_W} vs "
                    f"one-shot", r)
        feed = torch.as_tensor(np.asarray(want[:n_new - 1]),
                               device=dev)[None]
        ref = forced_run(eng, toks, S, sb, feed)[0][:, 0]
        agree.append(check_streams(f"6c (b) {name}", f"S={S} scheduler "
                                   f"chunked vs one-shot", got, want, ref,
                                   r["err"]))
    S = len(short[0])
    toks = torch.from_numpy(np.stack(short).astype(np.int64)).to(dev)
    cap = next_pow2(S + SERVE_GEN)
    fixed = eng.generate({"tokens": toks}, SERVE_GEN).tokens
    feed = fixed[:, :SERVE_GEN - 1]
    batch = forced_run(eng, toks, S, cap, feed)
    solo = [forced_run(eng, toks[i:i + 1], S, cap, feed[i:i + 1])
            for i in range(len(short))]
    solo = (torch.cat([r[0] for r in solo], dim=1),
            tuple(torch.cat([r[1][j] for r in solo], dim=1)
                  for j in range(2)), feed)
    r = cross_shape(batch, solo)
    check_cross(f"6c (b) {name}", f"batch {len(short)} x S={S} prefill vs "
                f"each alone", r)
    sched, _, n3 = sched_run(eng, [(p, SERVE_GEN, GREEDY) for p in short],
                             n_sites, bucket_batch=False)
    vs_gen = [check_streams(f"6c (b) {name}", f"request {i} scheduler vs "
                            f"generate", got, want.cpu(), batch[0][:, i],
                            r["err"])
              for i, (got, want) in enumerate(zip(sched, fixed))]
    gated_line(f"6c (b) {name}", {"chunked vs one-shot": agree,
                                  "scheduler vs generate": vs_gen})
    log(f"   6c (b) {name}: scheduler greedy tokens equal before the first "
        f"difference, chunked vs one-shot {[a for a, _ in agree]}; "
        f"scheduler vs generate {[v for v, _ in vs_gen]}")
    return n1["spmm"] + n2["spmm"] + n3["spmm"]


def continuous_path(api, params, masks60: dict, masks24: dict) -> dict:
    """Phase 6c: the continuous scheduler on the card, dense / masked
    PerRow(0.6) / nm24 (Wanda 2:4) / gathered PerRow(0.6), checks (a)-(e)
    in every format, then the load rows (f). Returns the spmm launches
    of the phase per kernel ({"spmm": nm24's, "spmm_gather": gathered's})."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import CONT, LOAD_OUTPUT, LOAD_PROMPT
    from repro_torch.serve import FaultPlan, ServeEngine, loadgen

    vocab = api.cfg.vocab_size
    n_sites = spmm_sites(api.cfg, params)
    specs = {"dense": (None, "dense"), "masked": (masks60, "masked"),
             "nm24": (masks24, "nm24"), "gathered": (masks60, "gathered")}
    engines = {name: ServeEngine(api, params, masks=m, fmt=fmt)
               for name, (m, fmt) in specs.items()}
    mixed, longs, short, disagg = sched_traffic(vocab)
    launches = {name: 0 for name in engines}
    ops.reset_launches()
    for name, eng in engines.items():
        t0 = time.perf_counter()
        # (a) batched == solo, bitwise, at the pinned width
        toks, _, n = sched_run(eng, mixed, n_sites,
                               bucket_batch=False)
        launches[name] += n["spmm"]
        for i, req in enumerate(mixed):
            solo, _, n = sched_run(eng, [req], n_sites,
                                   bucket_batch=False)
            launches[name] += n["spmm"]
            require(np.array_equal(toks[i], solo[0]),
                    f"6c (a) {name}: request {i} batched != solo")
        # (b) across shapes: chunked vs one-shot, batch 4 vs alone
        launches[name] += cross_shape_checks(eng, name, longs, short,
                                             n_sites)
        # (c) disaggregated == interleaved, bitwise, same width
        inter, _, n1 = sched_run(eng, disagg, n_sites,
                                 bucket_batch=False)
        dis, sch, n2 = sched_run(eng, disagg, n_sites,
                                 bucket_batch=False, disaggregate=True)
        launches[name] += n1["spmm"] + n2["spmm"]
        require(all(np.array_equal(a, b) for a, b in zip(inter, dis)),
                f"6c (c) {name}: disaggregated tokens differ")
        pages = sum(sch.pool.pages_for(len(p)) for p, n, _ in disagg
                    if n > 1)
        require(sch.shipped_bytes == pages * sch.pool.page_bytes
                == sch.prefill_pool.shipped_bytes_out,
                f"6c (c) {name}: shipped {sch.shipped_bytes} B, want "
                f"{pages} pages")
        # (d) chaos
        work = loadgen.make_workload(loadgen.LoadConfig(
            arrival_rate=64.0, duration_s=0.5, prompt_len=(16, 128),
            output_len=(8, 48), vocab_size=vocab))
        before = ops.LAUNCHES["spmm"]
        res = loadgen.run_chaos(eng, work, FaultPlan.chaos(0), **CONT)
        launches[name] += ops.LAUNCHES["spmm"] - before
        require(res["leaked_bytes"] == 0 and res["stream_mismatches"] == 0
                and res["ok"] and res["faults_fired"],
                f"6c (d) {name}: chaos verdict {res}")
        torch.cuda.synchronize()
        log(f"   6c {name}: (a) 4 requests batched == solo bitwise; (c) "
            f"disaggregated == interleaved bitwise, {pages} pages x "
            f"{sch.pool.page_bytes} B shipped; (d) chaos "
            f"[{res['plan']}] {res['completed_faulted']}/"
            f"{res['n_requests']} completed, leaked 0 B, 0 mismatches, "
            f"fired {res['faults_fired']}, counters {res['counters']}; "
            f"(e) spmm launches {launches[name]} = sites x layers x "
            f"dispatches; {time.perf_counter() - t0:.2f} s")
    # where a scheduler step's time goes: host vs device, spmm's share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name in ("nm24", "gathered"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, sch, n = sched_run(engines[name], mixed, n_sites,
                                  bucket_batch=False)
            wall = time.perf_counter() - t0
        launches[name] += n["spmm"]
        dev_ms = spmm = 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                dev_ms += ms
                if "spmm_" in e.name or "splitk_reduce" in e.name:
                    spmm += ms
        log(f"   6c {name}: one run of the 4 mixed requests ({sch._step_no} "
            f"steps, {sch.dispatches}): wall {1e3 * wall:.2f} ms, device "
            f"kernels {dev_ms:.2f} ms (spmm {spmm:.2f} ms), host or idle "
            f"{1e3 * wall - dev_ms:.2f} ms")
    del engines
    # (f) the load rows: one pass each, no warm-up pass (the kernels are
    # built and (a)-(e) ran them; each run first dispatches every decode
    # shape once, ``ContinuousScheduler.warm``)
    base = loadgen.LoadConfig(prompt_len=LOAD_PROMPT, output_len=LOAD_OUTPUT,
                              seed=0)
    runs = [(rate, LOAD_REQUESTS, ("continuous",), (masks60, ("masked",
                                                              "gathered")))
            for rate in LOAD_RATES]
    runs += [(rate, LOAD_REQUESTS, ("continuous",), (masks24, ("nm24",)))
             for rate in LOAD_RATES]
    runs.append((LOAD_RATES[0], FIXED_REQUESTS, ("continuous", "fixed"),
                 (masks24, ("nm24",))))
    rows = []
    for rate, n_req, modes, (masks, formats) in runs:
        t0 = time.perf_counter()
        before = ops.LAUNCHES["spmm"]
        got = loadgen.bench_load_rows(
            api, params, masks, formats=formats, rates=(rate,),
            load=dataclasses.replace(base, duration_s=n_req / rate),
            modes=modes, warmup=False, **CONT)
        launches["gathered" if masks is masks60 else "nm24"] += \
            ops.LAUNCHES["spmm"] - before
        for r in got:
            require("error" not in r, f"6c (f): {r}")
        rows += got
        log(f"   6c (f) {'/'.join(formats)} {'/'.join(modes)} rate {rate}/s "
            f"over {n_req / rate} s: {time.perf_counter() - t0:.2f} s")
    for r in rows:
        window = r["duration_s"]
        log(f"   6c (f) {r['variant']:8s} {r['mode']:10s} rate "
            f"{r['arrival_rate']:5.1f}/s window {window:.3f} s: "
            f"{r['completed']}/{r['n_requests']} done, makespan "
            f"{r['makespan_s']:.3f} s ({r['makespan_s'] / window:.2f}x the "
            f"window), tokens asked at "
            f"{r['offered_tok_s'] * r['makespan_s'] / window:.1f} tok/s over "
            f"the window, goodput {r['goodput_tok_s']:.1f} tok/s over the "
            f"makespan, TTFT p50 {1e3 * r['p50_ttft_s']:.1f} p99 "
            f"{1e3 * r['p99_ttft_s']:.1f} ms, queue wait p50 "
            f"{1e3 * r['p50_queue_wait_s']:.1f} p99 "
            f"{1e3 * r['p99_queue_wait_s']:.1f} ms, per-token p50 "
            f"{1e3 * r['p50_tok_latency_s']:.2f} p99 "
            f"{1e3 * r['p99_tok_latency_s']:.2f} ms, wasted "
            f"{r['wasted_decode_tokens']} tokens [{r['kernel_used']}]")
    return {"spmm": launches["nm24"], "spmm_gather": launches["gathered"]}


# phase 6mc: continuous serving of mixtral-8x7b. The load rows serve the
# first MOE_LOAD_REQUESTS requests of phase 6c's stream at its lower rate,
# in CHUNK_W-token prefill windows.
MOE_LOAD_REQUESTS, PROFILED_REQUESTS = 20, 8


def sync(cuda: bool) -> None:
    import torch

    if cuda:
        torch.cuda.synchronize()


class SpmmCalls:
    """The packed products launched while entered, in launch order: each
    ``ops.spmm`` ("spmm") and ``ops.spmm_stacked`` ("spmm_stacked") call
    that launched its kernel, and per stacked shape (experts, tokens an
    expert, d_out, d_in, format) the calls made at it (``stacked``). A
    call launches one product kernel (and, split, one reduction after
    it), so the order tells a profiler's product kernels apart: the
    stacked calls run the same kernels as the unstacked ones."""

    def __init__(self):
        import collections

        self.order, self.stacked = [], collections.Counter()

    def __enter__(self):
        from repro_torch.kernels import ops

        self._orig = ops.spmm, ops.spmm_stacked
        plain, stacked = self._orig

        def spmm(x, pw, **kw):
            if x.numel():
                self.order.append("spmm")
            return plain(x, pw, **kw)

        def spmm_stacked(x, pw, **kw):
            if x.numel():
                self.order.append("spmm_stacked")
                self.stacked[(x.shape[0], x[0].numel() // pw.d_in,
                              pw.values.shape[-2], pw.d_in, pw.fmt)] += 1
            return stacked(x, pw, **kw)

        ops.spmm, ops.spmm_stacked = spmm, spmm_stacked
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.spmm, ops.spmm_stacked = self._orig


def device_split(prof, order: list) -> dict:
    """A profiled run's device time in ms: every kernel and copy
    ("device"), and the packed products with their split reductions by
    the call that launched them ("spmm", "spmm_stacked"), matched in
    launch order to ``SpmmCalls.order``; None for those two when the
    trace lost a product kernel."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    out = {"device": sum(e.time_range.elapsed_us() for e in evs) / 1e3,
           "spmm": 0.0, "spmm_stacked": 0.0}
    calls, kind = iter(order), None
    products = 0
    for e in evs:
        ms = e.time_range.elapsed_us() / 1e3
        if "spmm_" in e.name:
            kind = next(calls, None)
            products += 1
        elif "splitk_reduce" not in e.name:
            continue
        if kind is not None:
            out[kind] += ms
    if products != len(order):
        out["spmm"] = out["spmm_stacked"] = None
    return out


def first_route_split(ref: list, own: list, n_layers: int, n_valid: int,
                      k: int, thr: float) -> int:
    """The first generated token a routing near-tie may change: a
    decision whose top-k gap in ``ref`` is within ``thr`` and that the
    two runs resolve differently (their expert sets differ). ``ref`` and
    ``own`` are two runs' (logits, expert ids) records in the one-shot
    layout (``RouteTape.calls``; a replay's ``own``, ``unwindow``-ed for
    a windowed run): the prefill's layers, then each decode step's.
    Returns 0 where a prompt position splits, else 1 + the first decode
    step that does; a near-tie both runs resolved alike voids nothing."""
    def splits(a, b, n=None):
        (lg, ids), (_, ids2) = a, b
        differ = (ids[:, :n].sort(-1).values
                  != ids2[:, :n].sort(-1).values).any(-1)
        return bool((differ & (topk_gap(lg[:, :n], k) <= thr)).any())

    if any(splits(a, b, n_valid) for a, b in zip(ref[:n_layers],
                                                 own[:n_layers])):
        return 0
    dec, dec_own = ref[n_layers:], own[n_layers:]
    for i in range(0, len(dec), n_layers):
        if any(splits(a, b) for a, b in zip(dec[i:i + n_layers],
                                            dec_own[i:i + n_layers])):
            return i // n_layers + 1
    return len(dec) // n_layers + 1


def moe_cross_shape(eng, no_drop, name: str, longs: dict, short: list,
                    n_sites: dict) -> tuple[dict, int]:
    """Phase 6mc (b): phase 6c (b)'s comparisons across shapes on an MoE
    model, the routing teacher-forced with the tokens (``RouteTape``) and
    the capacity drops counted (``models.moe.count_drops``). A W-token
    window dispatches with capacity(W), a one-shot prefill with
    capacity(S_bucket): where either drops an assignment the two compute
    different functions (printed, not gated), so the chunked vs one-shot
    pair also runs at capacity_factor E / top_k, where no group can drop
    (``no_drop``: the same weights and masks served at that factor), and
    is gated there within SERVE_TOL, its logits and, through the
    scheduler at that factor too, its greedy streams. The batch-4 prefill
    vs each row alone dispatches the same groups (one a row), so its
    drops are equal and it is gated. Every unforced routing flip must be
    a near tie, at most ROUTE_FLIPS of them. The scheduler's greedy
    streams (chunked vs one-shot where neither dropped; the scheduler vs
    ``generate``) agree up to the first near-tie of a token or of a
    routing decision the two runs split on (``first_route_split``: a
    near-tie both resolve alike voids nothing). Returns the spmm
    launches of its scheduler runs and how many scheduler vs
    ``generate`` streams the gate held past step 0."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import GREEDY
    from repro_torch.serve.engine import next_pow2

    cfg, dev = eng.cfg, eng.device
    L, k = cfg.n_layers, cfg.top_k
    tag = f"6mc (b) {name}"
    n_new = 8
    reqs = [(p, n_new, GREEDY) for p in longs.values()]
    launches = dict.fromkeys(n_sites, 0)

    def sched(e, rs, **kw):
        toks, _, n = sched_run(e, rs, n_sites, bucket_batch=False, **kw)
        for kk, v in n.items():
            launches[kk] += v
        return toks

    streams = {}                    # engine -> (one-shot, chunked) streams
    for e in (eng, no_drop):
        with moe.count_drops() as d:
            streams[e] = (sched(e, reqs),
                          sched(e, reqs, prefill_chunk=CHUNK_W))
        require(e is eng or d.total() == 0,
                f"{tag}: {d.total()} drops at capacity_factor "
                f"{e.cfg.capacity_factor:g}")
    agree = {eng: [], no_drop: []}
    for i, (S, p) in enumerate(longs.items()):
        sb = next_pow2(S)
        toks = torch.zeros((1, sb), dtype=torch.int64)
        toks[0, :S] = torch.from_numpy(p.astype(np.int64))
        toks = toks.to(dev)
        for e in (eng, no_drop):
            cf = f"capacity_factor {e.cfg.capacity_factor:g}"
            tape = RouteTape()
            with tape.record(), moe.count_drops() as d_one:
                one = forced_run(e, toks, S, sb, n_new)
            with tape.replay(tape.windows(L, S, CHUNK_W)), \
                    moe.count_drops() as d_chunk:
                chunk = forced_run(e, toks, S, sb, one[2], window=CHUNK_W)
            r = cross_shape(one, chunk)
            drops = (d_one.total(), d_chunk.total())
            what = (f"S={S} chunked W={CHUNK_W} vs one-shot, {cf}, routing "
                    f"forced ({tape.summary()}); drops one-shot {drops[0]}, "
                    f"chunked {drops[1]} of {d_one.assignments} assignments")
            want, got = streams[e][0][i], streams[e][1][i]
            if any(drops):
                log(f"   {tag} {what}: different functions where a group "
                    f"drops (not gated): teacher-forced logits max_abs_err "
                    f"{r['err']:.4e} ({r['err'] / r['scale']:.2e} of "
                    f"max|logits|), max |dK| {r['dk']:.3e}")
                differ = np.flatnonzero(np.asarray(got) != np.asarray(want))
                agree[e].append((f"{differ[0] if differ.size else n_new}/"
                                 f"{n_new} (drops: not gated)", False))
                continue
            check_cross(tag, what, r)
            tape.check(f"{tag} S={S} {cf}")
            # the stream's own pair: one-shot fed the one-shot stream,
            # recorded; chunked fed the same, replaying it (its own
            # decisions kept for first_route_split)
            feed = torch.as_tensor(np.asarray(want[:n_new - 1]),
                                   device=dev)[None]
            rec = RouteTape()
            with rec.record():
                ref = forced_run(e, toks, S, sb, feed)[0][:, 0]
            with rec.replay(rec.windows(L, S, CHUNK_W)):
                forced_run(e, toks, S, sb, feed, window=CHUNK_W)
            split = first_route_split(rec.calls, rec.unwindow(L, S, CHUNK_W),
                                      L, S, k,
                                      2 * max(tape.max_diff, rec.max_diff))
            agree[e].append(check_streams(
                tag, f"S={S} scheduler chunked vs one-shot, {cf}", got, want,
                ref, r["err"], split))
    S = len(short[0])
    toks = torch.from_numpy(np.stack(short).astype(np.int64)).to(dev)
    cap = next_pow2(S + SERVE_GEN)
    fixed = eng.generate({"tokens": toks}, SERVE_GEN).tokens
    feed = fixed[:, :SERVE_GEN - 1]
    tape = RouteTape()
    with tape.record(), moe.count_drops() as d_batch:
        batch = forced_run(eng, toks, S, cap, feed)
    solo = []
    with moe.count_drops() as d_solo:
        for i in range(len(short)):
            with tape.replay(tape.row(i)):
                solo.append(forced_run(eng, toks[i:i + 1], S, cap,
                                       feed[i:i + 1]))
    solo = (torch.cat([r[0] for r in solo], dim=1),
            tuple(torch.cat([r[1][j] for r in solo], dim=1)
                  for j in range(2)), feed)
    r = cross_shape(batch, solo)
    require(d_batch.total() == d_solo.total(),
            f"{tag}: the batch dropped {d_batch.total()} assignments, its "
            f"rows alone {d_solo.total()}")
    check_cross(tag, f"batch {len(short)} x S={S} prefill vs each alone, "
                f"routing forced ({tape.summary()}); drops "
                f"{d_batch.total()} of {d_batch.assignments} in both", r)
    tape.check(f"{tag} batch vs alone")
    sched_short = sched(eng, [(p, SERVE_GEN, GREEDY) for p in short])
    n_calls = len(tape.calls)          # row i's replay: own[i * n_calls:]
    vs_gen = [check_streams(
        tag, f"request {i} scheduler vs generate", got, want.cpu(),
        batch[0][:, i], r["err"],
        first_route_split(tape.row(i),
                          tape.own[i * n_calls:(i + 1) * n_calls], L, S, k,
                          2 * tape.max_diff))
        for i, (got, want) in enumerate(zip(sched_short, fixed))]
    pairs = {f"chunked vs one-shot at capacity_factor "
             f"{e.cfg.capacity_factor:g}": agree[e] for e in (eng, no_drop)}
    pairs["scheduler vs generate"] = vs_gen
    gated_line(tag, pairs)
    log(f"   {tag}: scheduler greedy tokens equal before the first "
        f"difference, " + "; ".join(
            f"{what} {[a for a, _ in res]}" for what, res in pairs.items()))
    return launches, sum(g for _, g in vs_gen)


def moe_continuous_path(api, params, masks60: dict, masks24: dict,
                        device="cuda"):
    """Phase 6mc: an MoE model through ``ContinuousScheduler`` (``CONT``:
    8 slots of 1024 tokens, 16-token pages, decode chunks of 8) in masked
    PerRow(0.6), nm24 (2:4), gathered PerRow(0.6) and gathered 2:4, with
    every capacity drop counted. (a) The four mixed requests batched ==
    each alone, bitwise at the pinned width (a decode row is its own
    dispatch group). (b) ``moe_cross_shape``. (c) Disaggregated ==
    interleaved bitwise, both in CHUNK_W-token windows. nm24 == gathered
    bitwise on the 2:4 masks (streams and forced logits). (d) nm24 under
    ``FaultPlan.chaos(0)``. (e) Every scheduler run launched spmm 4 and
    spmm_stacked 3 x layers x dispatches. (f) The load rows: the first
    MOE_LOAD_REQUESTS requests of phase 6c's stream at LOAD_RATES[0] in
    CHUNK_W-token windows, every request completed and no page left, in
    masked, nm24 and gathered PerRow(0.6); then nm24 on the first
    PROFILED_REQUESTS under torch.profiler: the device-busy share and the
    device ms of spmm and spmm_stacked. Returns ({"spmm", "spmm_gather",
    "spmm_stacked", "spmm_stacked_gather"} launches, the stacked calls
    by shape)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import CONT, LOAD_OUTPUT, LOAD_PROMPT
    from repro_torch.models import moe
    from repro_torch.serve import FaultPlan, ServeEngine, loadgen

    vocab = api.cfg.vocab_size
    n_sites = spmm_sites(api.cfg, params)
    no_drop_api = models.build(api.cfg.replace(
        capacity_factor=api.cfg.n_experts / api.cfg.top_k))
    specs = {"masked": (masks60, "masked"), "nm24": (masks24, "nm24"),
             "gathered": (masks60, "gathered"),
             "gathered_2:4": (masks24, "gathered")}
    t0 = time.perf_counter()
    engines = {name: ServeEngine(api, params, masks=m, fmt=fmt,
                                 device=device)
               for name, (m, fmt) in specs.items()}
    cuda = engines["nm24"].device.type == "cuda"
    log(f"   6mc: {len(engines)} engines in {time.perf_counter() - t0:.2f} s")
    mixed, longs, short, disagg = sched_traffic(vocab)
    launches = {name: dict.fromkeys(n_sites, 0) for name in engines}

    def add(name, n):
        for kk, v in n.items():
            launches[name][kk] += v

    streams = {}
    vs_gen_gated = 0        # scheduler vs generate streams gated past 0
    calls = SpmmCalls()
    with calls:
        for name, eng in engines.items():
            t0 = time.perf_counter()
            with moe.count_drops() as drops:
                toks, _, n = sched_run(eng, mixed, n_sites,
                                       bucket_batch=False)
                add(name, n)
                for i, req in enumerate(mixed):
                    solo, _, n = sched_run(eng, [req], n_sites,
                                           bucket_batch=False)
                    add(name, n)
                    require(np.array_equal(toks[i], solo[0]),
                            f"6mc (a) {name}: request {i} batched != solo")
                inter, _, n1 = sched_run(eng, disagg, n_sites,
                                         bucket_batch=False,
                                         prefill_chunk=CHUNK_W)
                dis, sch, n2 = sched_run(eng, disagg, n_sites,
                                         bucket_batch=False,
                                         disaggregate=True,
                                         prefill_chunk=CHUNK_W)
                add(name, n1)
                add(name, n2)
                require(all(np.array_equal(a, b)
                            for a, b in zip(inter, dis)),
                        f"6mc (c) {name}: disaggregated tokens differ")
            streams[name] = toks + inter
            log(f"   6mc {name}: (a) 4 requests batched == solo bitwise; "
                f"(c) disaggregated == interleaved bitwise in {CHUNK_W}-token"
                f" windows, {sch.shipped_bytes} B shipped; "
                f"{drops.total()} of {drops.assignments} assignments dropped"
                f"; {time.perf_counter() - t0:.2f} s")
            if name != "gathered_2:4":          # nm24's, bitwise (below)
                t0 = time.perf_counter()
                m, fmt = specs[name]
                no_drop = ServeEngine(no_drop_api, params, masks=m, fmt=fmt,
                                      device=device)
                n, held = moe_cross_shape(eng, no_drop, name, longs, short,
                                          n_sites)
                del no_drop
                add(name, n)
                vs_gen_gated += held
                log(f"   6mc (b) {name}: {time.perf_counter() - t0:.2f} s")
        require(vs_gen_gated > 0,
                "6mc (b): the scheduler vs generate gate held no stream "
                "past step 0")
        require(all(np.array_equal(a, b) for a, b in
                    zip(streams["nm24"], streams["gathered_2:4"])),
                "6mc: nm24 and gathered differ on the 2:4 masks")
        p = longs[CHUNK_PROMPTS[-1]]
        toks = torch.zeros((1, 512), dtype=torch.int64)
        toks[0, :len(p)] = torch.from_numpy(p.astype(np.int64))
        toks = toks.to(device)
        runs = [forced_run(engines[nm], toks, len(p), 512, 8, window=CHUNK_W)
                for nm in ("nm24", "gathered_2:4")]
        require(torch.equal(runs[0][0], runs[1][0]),
                "6mc: nm24 and gathered logits differ on the 2:4 masks")
        log("   6mc nm24 == gathered (2:4 masks): scheduler streams and "
            f"chunked-prefill logits (S={len(p)}) bitwise equal")
        # (d) chaos, nm24
        work = loadgen.make_workload(loadgen.LoadConfig(
            arrival_rate=64.0, duration_s=0.5, prompt_len=(16, 128),
            output_len=(8, 48), vocab_size=vocab))
        before = {kk: ops.LAUNCHES[kk] for kk in n_sites}
        t0 = time.perf_counter()
        res = loadgen.run_chaos(engines["nm24"], work, FaultPlan.chaos(0),
                                prefill_chunk=CHUNK_W, **CONT)
        add("nm24", {kk: ops.LAUNCHES[kk] - v for kk, v in before.items()})
        require(res["leaked_bytes"] == 0 and res["stream_mismatches"] == 0
                and res["ok"] and res["faults_fired"],
                f"6mc (d) nm24: chaos verdict {res}")
        log(f"   6mc (d) nm24 chaos [{res['plan']}]: "
            f"{res['completed_faulted']}/{res['n_requests']} completed, "
            f"leaked 0 B, 0 mismatches, fired {res['faults_fired']}, "
            f"counters {res['counters']}; {time.perf_counter() - t0:.2f} s")
        # (f) the load rows, then a profiled pass of each packed format
        wl = loadgen.make_workload(loadgen.LoadConfig(
            arrival_rate=LOAD_RATES[0],
            duration_s=LOAD_REQUESTS / LOAD_RATES[0],
            prompt_len=LOAD_PROMPT, output_len=LOAD_OUTPUT, seed=0,
            vocab_size=vocab))[:MOE_LOAD_REQUESTS]
        asked = sum(r.max_new for r in wl)
        for name in ("masked", "nm24", "gathered"):
            before = {kk: ops.LAUNCHES[kk] for kk in n_sites}
            t0 = time.perf_counter()
            with moe.count_drops() as drops:
                r = loadgen.run_continuous(engines[name], wl, warmup=False,
                                           prefill_chunk=CHUNK_W, **CONT)
            add(name, {kk: ops.LAUNCHES[kk] - v for kk, v in before.items()})
            require(r["completed"] == len(wl) and r["leaked_bytes"] == 0,
                    f"6mc (f) {name}: {r['completed']} of {len(wl)} "
                    f"completed, {r['leaked_bytes']} B left in the pools")
            log(f"   6mc (f) {name:8s} {len(wl)} requests at "
                f"{LOAD_RATES[0]}/s ({asked} tokens asked): "
                f"{r['completed']} done, 0 B left, makespan "
                f"{r['makespan_s']:.3f} s, goodput "
                f"{r['goodput_tok_s']:.1f} tok/s, TTFT p50 "
                f"{1e3 * r['p50_ttft_s']:.1f} p99 "
                f"{1e3 * r['p99_ttft_s']:.1f} ms, per-token p50 "
                f"{1e3 * r['p50_tok_latency_s']:.2f} p99 "
                f"{1e3 * r['p99_tok_latency_s']:.2f} ms, wasted "
                f"{r['wasted_decode_tokens']} tokens; {drops.total()} of "
                f"{drops.assignments} assignments dropped; "
                f"{time.perf_counter() - t0:.2f} s")
        # the profiled pass takes the first PROFILED_REQUESTS: the trace's
        # post-processing grows with its ~200k kernel records
        before = {kk: ops.LAUNCHES[kk] for kk in n_sites}
        calls.order.clear()
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            sync(cuda)
            t0 = time.perf_counter()
            r = loadgen.run_continuous(engines["nm24"],
                                       wl[:PROFILED_REQUESTS], warmup=False,
                                       prefill_chunk=CHUNK_W, **CONT)
            sync(cuda)
            wall = 1e3 * (time.perf_counter() - t0)
        add("nm24", {kk: ops.LAUNCHES[kk] - v for kk, v in before.items()})
        split = device_split(prof, calls.order)
        fmt = lambda v: "not measured (lost records)" if v is None \
            else f"{v:.2f} ms"  # noqa: E731
        log(f"   6mc (f) nm24, the first {PROFILED_REQUESTS} requests under "
            f"torch.profiler: wall {wall:.2f} ms, device busy "
            f"{split['device']:.2f} ms ({100 * split['device'] / wall:.1f}%"
            f"), spmm {fmt(split['spmm'])}, spmm_stacked "
            f"{fmt(split['spmm_stacked'])} ({calls.order.count('spmm')} + "
            f"{calls.order.count('spmm_stacked')} calls); goodput "
            f"{r['goodput_tok_s']:.1f} tok/s")
    del engines
    torch.cuda.empty_cache()
    nm, ga, ga24 = (launches[k] for k in ("nm24", "gathered", "gathered_2:4"))
    return ({"spmm": nm["spmm"], "spmm_gather": ga["spmm"] + ga24["spmm"],
             "spmm_stacked": nm["spmm_stacked"],
             "spmm_stacked_gather": ga["spmm_stacked"]
             + ga24["spmm_stacked"]}, calls.stacked)


def other_shapes(clock_mhz: float) -> None:
    """Phase 3b: every kernel at the other dense configs' shapes, held
    against its plain version as phase 3 holds it. The Gram (bf16, T =
    512) at each d of GRAM_DS, timed at GRAM_TIMED; the three swap kernels
    (k = 8) at SWAP_SHAPES, on all rows, swap_topk and swap_argmin held
    bitwise on the first 128 rows and the last 32-row block, the commit on
    every row, swap_topk and the commit step timed at the two largest;
    spmm at SPMM_SHAPES, the granite pair timed in bf16."""
    import torch
    from repro_torch.launch import profile_swap

    for d in GRAM_DS:
        check_gram(512, d, dtypes=("bf16",), time_it=d in GRAM_TIMED)
    for i, (R, d, site) in enumerate(SWAP_SHAPES):
        w, m, c, G = profile_swap.problem(R, d, i)
        tag = f"R={R} d={d} ({site})"
        last = (R - 1) // 32 * 32
        rows = torch.unique(torch.cat([torch.arange(min(R, 128)),
                                       torch.arange(last, R)])).cuda()
        timed = ("swap_topk",) if i < 2 else ()
        check_swaps(w, m, c, G, 8, tag, names=("swap_topk", "swap_argmin"),
                    timed=timed, clock_mhz=clock_mhz, rows=rows)
        check_commit(w, m, c, G, 8, tag, time_it=i < 2)
        del w, m, c, G
        torch.cuda.empty_cache()
    for d_out, d_in, act, bias, site, timed in SPMM_SHAPES:
        check_spmm(d_out, d_in, act, site, time_it=timed, bias=bias)
    torch.cuda.empty_cache()


def full_depth_plans() -> None:
    """Each dense config's ``plan_pruning`` at full depth on the meta
    device (nothing allocated): weight, Gram and calibration bytes, and
    whether calibration — the bf16 model and the skip-aware full
    accumulator — fits this card's memory."""
    import torch
    from repro_torch import configs, models
    from repro_torch.core import masks
    from repro_torch.pruning import plan as plan_lib, recipe as recipe_lib

    card = torch.cuda.get_device_properties(0).total_memory
    before = torch.cuda.memory_allocated()
    for name, cfg in configs.ARCHS.items():
        api = models.build(cfg)
        params = api.init(device="meta")
        plan = plan_lib.plan_pruning(
            api, params, recipe_lib.PruneRecipe.single(masks.PerRow(0.6)))
        weights = 2 * cfg.n_params()
        calib = plan.total_calib_bytes(minimal=False)
        fits = weights + calib <= card
        log(f"   {name}: {cfg.n_layers} layers, {cfg.n_params()} params "
            f"({weights / 1e9:.2f} GB bf16); prunable weights "
            f"{plan.total_weight_bytes() / 1e9:.2f} GB fp32, Grams "
            f"{plan.total_gram_bytes() / 1e9:.2f} GB, calibration state "
            f"{calib / 1e9:.2f} GB ({calib / cfg.n_layers / 1e9:.3f} GB a "
            f"layer); model + calibration {(weights + calib) / 1e9:.2f} GB "
            f"{'fits' if fits else 'does NOT fit'} one card "
            f"({card / 1e9:.2f} GB)")
    require(torch.cuda.memory_allocated() == before,
            "the full-depth plans allocated CUDA memory")


def other_config(name: str) -> dict:
    """Phases 4b and 6b for one dense config at full width, 2 layers, bf16,
    random weights from seed 0 (chatglm3's qkv biases, zero at init, drawn
    from N(0, 0.02²) so the bias path carries values): prune_model as in
    phase 4 with its gates, then serving as phase 6 without the timed
    runs. Returns the launches of both paths."""
    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.core import masks
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    cfg = configs.get(name).replace(n_layers=2)
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    if cfg.qkv_bias:
        gen = torch.Generator(device=dev).manual_seed(0)
        for b in ("bq", "bk", "bv"):
            t = params["layers"]["attn"][b]
            t.copy_(0.02 * torch.randn(t.shape, generator=gen, device=dev))
    pattern = masks.PerRow(0.6)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    with Phase(f"4b {name}: prune_model + perplexity"):
        log(f"   config: {name} full width (d_model {cfg.d_model}, "
            f"{cfg.n_heads} / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff} "
            f"{cfg.mlp} {cfg.act}, vocab {cfg.vocab_size}, qkv_bias "
            f"{cfg.qkv_bias}, rope_pct {cfg.rope_pct}), n_layers 2 (reduced "
            f"from {configs.get(name).n_layers}), {cfg.dtype}")
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = pruning.prune_model(api, params, batches, pattern,
                                     warmstart="wanda", method="sparseswaps",
                                     t_max=T_MAX)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        prune_launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        dense = pruning.evaluate(api, params, seed=0, device=dev)
        pruned = pruning.evaluate(api, params, masks=report.masks, seed=0,
                                  device=dev)
        log(report.summary())
        log(f"   {name}: prune_model {t_prune:.2f} s, max memory "
            f"{peak / 2**30:.2f} GiB; dense ppl {dense['perplexity']:.4f}, "
            f"pruned ppl {pruned['perplexity']:.4f}; mean error reduction "
            f"{100 * report.mean_error_reduction():.3f}%")
        log(f"   {name}: launches {prune_launches}")
        log(f"   {name}: masks digest {digest(mask_leaves(report.masks))}")
        check_pruned(api, params, report, prune_launches, len(batches),
                     pattern, dense, pruned)
    with Phase(f"6b {name}: serve masked / nm24 / gathered"):
        rep24 = pruning.prune_model(api, params, batches, masks.NM(2, 4),
                                    warmstart="wanda", method="none")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 32, split="val", device=dev)
        serve_launches = serve_path(api, params, report.masks, rep24.masks,
                                    pipe.get(0), bench=False)
        log(f"   {name}: spmm launches {serve_launches}")
    del params, report, rep24, batches
    torch.cuda.empty_cache()
    return {"prune": prune_launches, "serve": serve_launches}


def moe_config(name: str, *, serve: bool) -> dict:
    """Phases 4m (and 6m, 6mc with ``serve``) for one MoE config at full
    width, 2 layers, bf16, random weights from seed 0: phase 4's
    prune_model with its gates (``check_pruned``: an MoE tap's Gram one
    stacked launch a layer and batch; swap_topk once per instance and
    search pass, every expert of a layer an instance), time, peak memory
    and a masks digest; then phase 6's serving without the timed runs:
    dense, masked, nm24 and gathered on the PerRow(0.6) and Wanda 2:4
    masks, attention through spmm and the experts through spmm_stacked
    (sites x layers x 16 launches each a packed generate), nm24 ==
    gathered bitwise, packed vs masked logits within SERVE_TOL; then the
    continuous scheduler on the same masks (``moe_continuous_path``).
    Returns the launches of each path and the stacked calls by shape."""
    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.core import masks
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    full = configs.get(name)
    cfg = full.replace(n_layers=2)
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    pattern = masks.PerRow(0.6)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    out = {}
    with Phase(f"4m {name}: prune_model + perplexity"):
        log(f"   config: {name} full width (d_model {cfg.d_model}, "
            f"{cfg.n_heads} / {cfg.n_kv_heads} KV heads, {cfg.n_experts} "
            f"experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, moe_group_size "
            f"{cfg.moe_group_size}, sliding_window {cfg.sliding_window}, "
            f"vocab {cfg.vocab_size}), n_layers 2 (reduced from "
            f"{full.n_layers}), {cfg.dtype}; {cfg.n_params()} params "
            f"({cfg.n_active_params()} active)")
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = pruning.prune_model(api, params, batches, pattern,
                                     warmstart="wanda", method="sparseswaps",
                                     t_max=T_MAX)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        out["prune"] = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        dense = pruning.evaluate(api, params, seed=0, device=dev)
        pruned = pruning.evaluate(api, params, masks=report.masks, seed=0,
                                  device=dev)
        log(report.summary())
        n_inst = sum(s.n_instances
                     for s in pruning.site_specs(cfg, params))
        log(f"   {name}: prune_model {t_prune:.2f} s, max memory "
            f"{peak / 2**30:.2f} GiB; dense ppl {dense['perplexity']:.4f}, "
            f"pruned ppl {pruned['perplexity']:.4f}; mean error reduction "
            f"{100 * report.mean_error_reduction():.3f}%; {n_inst} "
            f"instances refined")
        log(f"   {name}: launches {out['prune']}")
        log(f"   {name}: masks digest {digest(mask_leaves(report.masks))}")
        check_pruned(api, params, report, out["prune"], len(batches),
                     pattern, dense, pruned)
    masks60 = _tree_to(report.masks, "cpu")     # 11.8 GB at mixtral: held on
    del report                                  # the host while the 2:4
    torch.cuda.empty_cache()                    # run calibrates
    if serve:
        with Phase(f"6m {name}: serve dense / masked / nm24 / gathered"):
            rep24 = pruning.prune_model(api, params, batches, masks.NM(2, 4),
                                        warmstart="wanda", method="none")
            pipe = synthetic.DataPipeline(
                synthetic.CorpusConfig(cfg.vocab_size), 4, 32, split="val",
                device=dev)
            out["serve"] = serve_path(api, params, _tree_to(masks60, dev),
                                      rep24.masks, pipe.get(0), bench=False)
            log(f"   {name}: spmm launches {out['serve']}")
        torch.cuda.empty_cache()
        with Phase(f"6mc {name}: continuous serving: scheduler, chunked "
                   "prefill, disaggregation, chaos, load"):
            out["continuous"], out["stacked_calls"] = moe_continuous_path(
                api, params, _tree_to(masks60, dev), rep24.masks)
            log(f"   {name}: spmm launches {out['continuous']}; "
                f"spmm_stacked calls by (E, T, d_out, d_in, format): "
                f"{dict(sorted(out['stacked_calls'].items()))}")
            del rep24
    del params, masks60, batches
    torch.cuda.empty_cache()
    return out


def family_shapes(clock_mhz: float, grams, swaps, spmms,
                  seed: int) -> dict:
    """Phases 3z, 3r, 3e and 3v: every kernel of a model family's path at
    its shapes new to the kernels, held against its plain version as
    phase 3 holds it and timed beside its bound and the one PyTorch call:
    the bf16 Gram at each of ``grams`` (d at T = 512, or (T, d, site));
    swap_topk (k = 8) and the commit at ``swaps`` (R, d, site) on all
    rows, the search held bitwise on ``plain_rows``, the commit on every
    row; spmm (nm24 on 2:4, gathered on PerRow(0.6) and 2:4; fp32 and
    bf16) at ``spmms`` (d_out, d_in, act, site[, the T checked and timed;
    4 and 128 by default]). The swap problems are drawn from ``seed`` +
    their index. Returns the timings by kernel and shape."""
    import torch
    from repro_torch.launch import profile_swap

    out = {}
    for g in grams:
        T, d = (512, g) if isinstance(g, int) else g[:2]
        out[("gram", T, d)] = check_gram(T, d, dtypes=("bf16",))["bf16"]
    for i, (R, d, site) in enumerate(swaps):
        w, m, c, G = profile_swap.problem(R, d, seed + i)
        tag = f"R={R} d={d} ({site})"
        out[("swap_topk", R, d)] = check_swaps(
            w, m, c, G, 8, tag, names=("swap_topk",), timed=("swap_topk",),
            clock_mhz=clock_mhz, rows=plain_rows(R))["swap_topk"]
        out[("swap_commit", R, d)] = check_commit(w, m, c, G, 8, tag)
        del w, m, c, G
        torch.cuda.empty_cache()
    for d_out, d_in, act, site, *Ts in spmms:
        got = check_spmm(d_out, d_in, act, site, **(
            {"Ts": Ts[0]} if Ts else {}))
        out.update({("spmm", d_out, d_in, *k): v for k, v in got.items()})
        torch.cuda.empty_cache()
    return out


def check_shared_gram(api, params, batches) -> None:
    """Phase 4z: the shared block's Gram as calibration accumulates it
    (one ``Taps`` summing the block's sites, ``models.zamba``) against
    the sum of its sites' Grams taken one by one (a ``TapPolicy`` that
    keeps each site's Gram apart, through the same kernel), within 1e-5
    of max|G| per tap: the same fp32 partial sums, added in another
    order."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import common
    from repro_torch.pruning import sites

    n = shared_sites(api.cfg)
    shared = {t.name for t in sites.tap_specs(api.cfg, sites.site_specs(
        api.cfg, params)) if t.path[0] == "shared"}

    class BySite(common.TapPolicy):
        """Every tap at gram level; a shared tap's Gram also kept per
        site (the block's calls come in site order each forward)."""

        def __init__(self):
            self.name, self.calls, self.sites = None, {}, {}

        def fields(self, name):
            self.name = name
            return ("g", "s", "n")

        def gram(self, x2):
            g = ops.gram_xtx(x2)
            if self.name in shared:
                i = self.calls.get(self.name, 0)
                self.calls[self.name] = i + 1
                per = self.sites.setdefault(self.name, [None] * n)
                per[i % n] = g.clone() if per[i % n] is None \
                    else per[i % n] + g
            return g

    pol, acc = BySite(), {}
    with torch.no_grad():
        for b in batches:
            _, aux = api.loss(params, b, want_taps=True, tap_policy=pol)
            for name, ent in aux["taps"]["shared"].items():
                acc[name] = ent["g"] + acc[name] if name in acc else ent["g"]
    require(set(acc) == shared and all(
        pol.calls[nm] == n * len(batches) for nm in shared),
        f"4z: shared taps {sorted(acc)}, calls {pol.calls}")
    for name in sorted(shared):
        want = sum(pol.sites[name][1:], pol.sites[name][0])
        err = float((acc[name] - want).abs().max())
        rel = err / float(want.abs().max())
        share = [float(g.diagonal().sum() / want.diagonal().sum())
                 for g in pol.sites[name]]
        require(rel <= 1e-5, f"4z: shared {name} Gram off its sites' sum "
                f"by {rel:.2e} of max|G|")
        log(f"   4z shared {name}: Gram (d = {want.shape[0]}) == the sum of "
            f"its {n} sites' Grams taken one by one, max_abs_err {err:.3e}"
            f" ({rel:.2e} of max|G|); trace shares by site "
            f"{[round(x, 4) for x in share]}")
    del pol, acc
    torch.cuda.empty_cache()


def prune_patterns(api, params, batches, dev, *,
                   nm_method: str = "sparseswaps",
                   host_masks: bool = False) -> tuple[dict, dict]:
    """Phases 4z, 4r, 4e and 4v: ``prune_model`` at PerRow(0.6) (Wanda
    warmstart, SparseSwaps k = 8, t_max = T_MAX) and at 2:4 (the same,
    or Wanda alone with ``nm_method="none"``) with phase 4's gates
    (``check_pruned``), time, peak memory and a masks digest each. With
    ``host_masks`` each report's masks go to the host as bool once held
    (the next run's calibration then has the card). Returns (the launches
    of both runs summed, {pattern tag: report})."""
    import torch
    from repro_torch import pruning
    from repro_torch.core import masks
    from repro_torch.kernels import ops

    name = api.cfg.name
    total, reports = {}, {}
    t0 = time.perf_counter()
    dense = pruning.evaluate(api, params, seed=0, device=dev)
    log(f"   {name}: dense evaluation {time.perf_counter() - t0:.2f} s")
    for tag, pattern in (("0.6", masks.PerRow(0.6)), ("2:4", masks.NM(2, 4))):
        method = "sparseswaps" if tag == "0.6" else nm_method
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = pruning.prune_model(api, params, batches, pattern,
                                     warmstart="wanda", method=method,
                                     t_max=T_MAX)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        pruned = pruning.evaluate(api, params, masks=report.masks, seed=0,
                                  device=dev)
        t_eval = time.perf_counter() - t0
        log(report.summary())
        log(f"   {name} {tag}: prune_model {t_prune:.2f} s, max memory "
            f"{peak / 2**30:.2f} GiB; dense ppl {dense['perplexity']:.4f}"
            f", pruned ppl {pruned['perplexity']:.4f} ({t_eval:.2f} s); "
            f"mean error reduction "
            f"{100 * report.mean_error_reduction():.3f}%")
        log(f"   {name} {tag}: launches {launches}")
        check_pruned(api, params, report, launches, len(batches), pattern,
                     dense, pruned, refined=method != "none")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        t0 = time.perf_counter()
        if host_masks:
            report.masks = _tree_to(_tree_to(report.masks, dev, torch.bool),
                                    "cpu")
            torch.cuda.empty_cache()
        log(f"   {name} {tag}: masks digest "
            f"{digest(mask_leaves(report.masks))} "
            f"({time.perf_counter() - t0:.2f} s"
            f"{', the masks to the host as bool first' if host_masks else ''})")
        reports[tag] = report
    return total, reports


def refine_candidates(phase: str, problems) -> int:
    """Phases 4z and 4r: ``refine(commit_mode="candidates")`` from a Wanda
    PerRow(0.6) warmstart on each (site, W, G) of ``problems`` (a layer's
    weight and its calibration Gram), so the commit kernel runs at the
    family's shapes: phase 5's gates, one swap_commit launch a pass.
    Returns the swap_commit launches."""
    import torch
    from repro_torch.core import masks, sparseswaps
    from repro_torch.core.warmstart import warmstart_mask
    from repro_torch.kernels import ops

    pattern = masks.PerRow(0.6)
    total = 0
    for site, W, G in problems:
        m0 = warmstart_mask(W.float(), G, pattern, "wanda")
        before = ops.LAUNCHES["swap_commit"]
        t0 = time.perf_counter()
        with sparseswaps.count_search_passes() as cnt:
            r = sparseswaps.refine(W, G, m0, pattern, k_swaps=8,
                                   commit_mode="candidates", t_max=T_MAX)
        torch.cuda.synchronize()
        n = ops.LAUNCHES["swap_commit"] - before
        check_refined(W, G, r, pattern, f"{phase} {site} candidates")
        require(n == cnt.passes > 0,
                f"{phase} {site}: swap_commit launched {n} times in "
                f"{cnt.passes} passes")
        total += n
        log(f"   {phase} {site} ({W.shape[0]} x {W.shape[1]}) "
            f"refine(commit_mode=candidates): passes {cnt.passes}, "
            f"swaps {int(r.swaps.sum())}, error reduction "
            f"{100 * float(r.error_reduction.mean()):.3f}%, swap_commit "
            f"launches {n}, {time.perf_counter() - t0:.3f} s; digest of "
            f"masks, swaps, losses "
            f"{digest([r.mask > 0.5, r.swaps, r.loss_final])}")
    return total


def zamba_config(cfg=None, device="cuda") -> dict:
    """Phases 4z and 6z: zamba2-7b at full width, depth ZAMBA_LAYERS (the
    shared block at layers 0 and 6), bf16, random weights from seed 0.
    4z: ``check_shared_gram``; ``prune_model`` at PerRow(0.6) and at 2:4
    (Wanda warmstart, SparseSwaps k = 8, t_max = T_MAX) with phase 4's
    gates (``check_pruned``: a shared tap's Gram one launch a site it
    runs at and batch), time, peak memory and a masks digest each; then
    ``refine(commit_mode="candidates")`` on layer 0's in_proj and on the
    shared wq with their calibration Grams, so the commit kernel runs on
    the zamba path (its rows and d new to it): phase 5's gates, one
    swap_commit launch a pass. 6z: phase 6's serving (dense, masked, nm24
    and gathered on the PerRow(0.6) masks and on the 2:4 ones, batch 4 x
    prompt 32 + SERVE_GEN new tokens, timed), spmm launches (2 x layers +
    7 x sites) x SERVE_GEN forwards a packed generate, nm24 == gathered
    bitwise, packed vs masked logits printed (bf16 rounding carries this
    model past SERVE_TOL by itself); then the same six engines built at
    float32 (the fp32 spmm kernel): the same launches, nm24 == gathered
    bitwise, and packed vs masked logits within SERVE_TOL. Returns the
    launches of each path. ``cfg`` and ``device`` rehearse it elsewhere
    (a TINY config on the CPU, where no launch counts hold)."""
    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.data import synthetic

    dev = torch.device(device)
    full = configs.get(ZAMBA)
    cfg = cfg or full.replace(n_layers=ZAMBA_LAYERS)
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    n_sites = shared_sites(cfg)
    out = {}
    with Phase(f"4z {ZAMBA}: prune_model + perplexity, the shared Gram"):
        log(f"   config: {ZAMBA} full width (d_model {cfg.d_model}, "
            f"d_inner {cfg.d_inner}, {cfg.n_ssm_heads} SSM heads of "
            f"{cfg.ssm_head_dim}, ssm_state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}; the shared block {cfg.n_heads} heads x "
            f"{cfg.head_dim} on 2 x d_model, d_ff {cfg.d_ff} {cfg.act}, "
            f"every {cfg.shared_attn_every} layers: {n_sites} sites), "
            f"n_layers {cfg.n_layers} (reduced from {full.n_layers}), "
            f"{cfg.dtype}; {cfg.n_params()} params")
        check_shared_gram(api, params, batches)
        out["prune"], reports = prune_patterns(api, params, batches, dev)
        taps = pruning.accumulate(api, params, batches)
        out["swap_commit"] = refine_candidates("4z", (
            ("layers.mamba.in_proj[0]",
             params["layers"]["mamba"]["in_proj"][0],
             taps["mamba"]["in_proj"]["g"][0]),
            ("shared.attn.wq", params["shared"]["attn"]["wq"],
             taps["shared"]["wq"]["g"])))
        del taps
        torch.cuda.empty_cache()
    with Phase(f"6z {ZAMBA}: serve dense / masked / nm24 / gathered"):
        per = spmm_sites(cfg, params)["spmm"]
        log(f"   spmm launches a packed generate: (2 mamba sites x "
            f"{cfg.n_layers} layers + 7 shared sites x {n_sites} sites) x "
            f"{SERVE_GEN} forwards (1 prefill + {SERVE_GEN - 1} decode "
            f"steps) = {per * SERVE_GEN}")
        require(per == 2 * cfg.n_layers + 7 * n_sites,
                f"6z: {per} spmm launches a forward")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 32, split="val", device=dev)
        prompt = pipe.get(0)
        bf16 = serve_path(api, params, reports["0.6"].masks,
                          reports["2:4"].masks, prompt, gate=False)
        torch.cuda.empty_cache()
        log("   the same engines at float32 (the fp32 spmm kernel), packed "
            f"vs masked within {SERVE_TOL} of max|logits|:")
        up = lambda t: ({k: up(v) for k, v in t.items()}  # noqa: E731
                        if isinstance(t, dict) else t.float())
        fp32 = serve_path(models.build(cfg.replace(dtype="float32")),
                          up(params), up(reports["0.6"].masks),
                          up(reports["2:4"].masks), prompt, bench=False)
        out["serve"] = {name: {k: v + fp32[name][k] for k, v in n.items()}
                        for name, n in bf16.items()}
        log(f"   {ZAMBA}: spmm launches {out['serve']}")
    del params, reports, batches
    torch.cuda.empty_cache()
    return out


def check_incremental(api, params, batch: dict, S0: int, tol: float,
                      tag: str, states: tuple = ()) -> None:
    """Phases 6r, 6e and 6v: ``prefill`` of the first ``S0`` tokens of
    ``batch`` (with its frontend states, where it has them), then
    ``decode_step`` over the rest, against one ``forward`` over all of
    them: the logits at every position within ``tol`` of max|logits|;
    and each cache field of ``states`` the decode steps carried (rwkv's
    WKV matrix and token-shift vectors) against ``prefill``'s of all the
    tokens, within ``tol`` of its max."""
    import torch

    tokens = batch["tokens"]
    B, S = tokens.shape
    extra = {k: v for k, v in batch.items() if k in ("img", "src")}
    with torch.no_grad():
        cache = api.init_cache(params, B, S)
        logits, cache = api.prefill(
            params, {"tokens": tokens[:, :S0], **extra}, cache)
        outs = [logits]
        for t in range(S0, S):
            logits, cache = api.decode_step(params, tokens[:, t:t + 1], cache)
            outs.append(logits)
        hidden, _, _ = api.forward(params, {"tokens": tokens, **extra})
        want = api.module.lm_head(params, hidden, api.cfg)[:, S0 - 1:S - 1]
        got = torch.cat(outs[:-1], 1)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        carried = {}
        if states:
            one = api.init_cache(params, B, S)
            _, one = api.prefill(params, {"tokens": tokens, **extra}, one)
            require(one.t == S, f"{tag}: cache clock {one.t}")
            for name in states:
                a, b = getattr(cache, name).float(), getattr(one, name).float()
                carried[name] = float((a - b).abs().max()) / float(
                    b.abs().max())
    log(f"   {tag}: prefill {S0} + {S - S0} decode steps vs one forward "
        f"over {S} tokens: logits max_abs_err {err:.4e} ({err / scale:.2e} "
        f"of max|logits| {scale:.3f})" + (
            "; carried state vs prefill of all, of its max: " + ", ".join(
                f"{k} {v:.2e}" for k, v in carried.items()) if states else ""))
    require(cache.t == S, f"{tag}: cache clock {cache.t}")
    require(math.isfinite(err) and err <= tol * scale,
            f"{tag}: prefill + decode off one forward by {err / scale:.2e} "
            "of max|logits|")
    require(all(v <= tol for v in carried.values()),
            f"{tag}: the carried state is off the prefill's {carried}")


def rwkv_config(cfg=None, device="cuda") -> dict:
    """Phases 4r and 6r: rwkv6-1.6b at full width, depth RWKV_LAYERS,
    bf16, random weights from seed 0. 4r: ``prune_model`` at PerRow(0.6)
    and at 2:4 (Wanda warmstart, SparseSwaps k = 8, t_max = T_MAX) with
    phase 4's gates (``check_pruned``: ten taps, each one Gram a layer and
    batch, none stacked or shared), time, peak memory and a masks digest
    each; then ``refine(commit_mode="candidates")`` on layer 0's td_w1
    and td_w2 with their calibration Grams, so the commit kernel runs on
    the 64-wide sites: phase 5's gates, one swap_commit launch a pass. 6r:
    phase 6's serving (dense, masked, nm24 and gathered on the PerRow(0.6)
    masks and on the 2:4 ones, batch 4, SERVE_GEN new tokens) at each
    prompt length of RWKV_PROMPTS (the first timed), 10 sites x layers x
    SERVE_GEN spmm launches a packed generate, nm24 == gathered bitwise,
    packed vs masked logits within SERVE_TOL (bf16 rounding at these 2
    layers stays ~1e-2 of max|logits|, so bf16 is gated, not only the
    float32 engines as 6z must); the dense model's bf16 logits against
    the same model's at float32, fed its tokens, printed; the same six
    engines at float32 (the fp32 spmm kernel) under the same gates; and
    ``check_incremental`` in bf16 (within SERVE_TOL) and at float32
    (within 1e-3). Returns the launches of each path. ``cfg`` and
    ``device`` rehearse it elsewhere (a TINY config on the CPU, where no
    launch counts hold)."""
    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.data import synthetic
    from repro_torch.serve import ServeEngine

    dev = torch.device(device)
    full = configs.get(RWKV)
    cfg = cfg or full.replace(n_layers=RWKV_LAYERS)
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    out = {}
    with Phase(f"4r {RWKV}: prune_model + perplexity"):
        log(f"   config: {RWKV} full width (d_model {cfg.d_model}, "
            f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
            f"{cfg.rwkv_head_dim}, chunk {cfg.rwkv_chunk}, decay LoRA "
            f"{cfg.rwkv_lora_decay}, mix LoRA {cfg.rwkv_lora_mix}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}), n_layers {cfg.n_layers} "
            f"(reduced from {full.n_layers}), {cfg.dtype}; "
            f"{cfg.n_params()} params")
        out["prune"], reports = prune_patterns(api, params, batches, dev)
        taps = pruning.accumulate(api, params, batches)
        out["swap_commit"] = refine_candidates("4r", [
            (f"layers.tm.{site}[0]", params["layers"]["tm"][site][0],
             taps[site]["g"][0]) for site in ("td_w1", "td_w2")])
        del taps
        torch.cuda.empty_cache()
    with Phase(f"6r {RWKV}: serve dense / masked / nm24 / gathered"):
        per = spmm_sites(cfg, params)["spmm"]
        log(f"   spmm launches a packed generate: 10 sites x "
            f"{cfg.n_layers} layers x {SERVE_GEN} forwards (1 prefill + "
            f"{SERVE_GEN - 1} decode steps) = {per * SERVE_GEN}")
        require(per == 10 * cfg.n_layers, f"6r: {per} spmm launches a "
                "forward")
        up = lambda t: ({k: up(v) for k, v in t.items()}  # noqa: E731
                        if isinstance(t, dict) else t.float())
        api32 = models.build(cfg.replace(dtype="float32"))
        params32 = up(params)
        m60, m24 = reports["0.6"].masks, reports["2:4"].masks
        served = []
        for S in RWKV_PROMPTS:
            pipe = synthetic.DataPipeline(
                synthetic.CorpusConfig(cfg.vocab_size), 4, S, split="val",
                device=dev)
            prompt = pipe.get(0)
            log(f"   prompt batch 4 x {S} ({S // cfg.rwkv_chunk} WKV chunks"
                f"{f' + {S % cfg.rwkv_chunk} padded' if S % cfg.rwkv_chunk else ''}"
                f"), bf16:")
            served.append(serve_path(api, params, m60, m24, prompt,
                                     bench=S == RWKV_PROMPTS[0]))
            eng32 = ServeEngine(api32, params32, fmt="dense")
            ref = eng32.logits_trace(prompt, SERVE_GEN)
            got = forced_logits(ServeEngine(api, params, fmt="dense"), prompt,
                                eng32.generate(prompt, SERVE_GEN).tokens)
            gaps = (got - ref).abs().amax(dim=(1, 2))
            scale = float(ref.abs().max())
            log(f"   dense bf16 vs the same model at float32 (prompt {S}, fed "
                f"the float32 model's tokens): logits max_abs_err prefill "
                f"{float(gaps[0]):.4e}, decode steps {float(gaps[1:].max()):.4e}"
                f" ({float(gaps.max()) / scale:.2e} of max|logits| "
                f"{scale:.3f})")
            del eng32
            log(f"   the same engines at float32 (the fp32 spmm kernel), "
                f"prompt {S}:")
            served.append(serve_path(api32, params32, up(m60), up(m24),
                                     prompt, bench=False))
            torch.cuda.empty_cache()
        tokens = synthetic.DataPipeline(
            synthetic.CorpusConfig(cfg.vocab_size), 4, RWKV_PROMPTS[1] + 16,
            split="val", device=dev).get(1)["tokens"]
        S0 = RWKV_PROMPTS[1] - 16
        states = ("s", "x_tm", "x_cm")
        check_incremental(api, params, {"tokens": tokens}, S0, SERVE_TOL,
                          "6r bf16", states)
        check_incremental(api32, params32, {"tokens": tokens}, S0, 1e-3,
                          "6r float32", states)
        out["serve"] = {name: {k: sum(s[name][k] for s in served) for k in n}
                        for name, n in served[0].items()}
        log(f"   {RWKV}: spmm launches {out['serve']}")
    del params, params32, reports, batches
    torch.cuda.empty_cache()
    return out


def xattn_config(name: str, cfg=None, device="cuda") -> dict:
    """Phases 4e / 6e (seamless-m4t-medium, SEAMLESS_LAYERS encoder and
    decoder layers) and 4v / 6v (llama-3.2-vision-90b, VLM_LAYERS: one
    group of 4 self layers and a cross layer, its gates set to
    VLM_GATES), at full width, bf16, random weights from seed 0, the
    calibration batches carrying their frontend states
    (``synthetic.with_modality``). 4e / 4v: ``prune_patterns`` at
    PerRow(0.6) (SparseSwaps) and Wanda 2:4 (``method="none"``), the
    PerRow(0.6) masks on the host as bool meanwhile; the VLM's peak
    reckoned from ``plan_pruning`` first; ``refine_candidates`` on the
    first cross wk (its Gram over the source or image states, from a
    calibration of the "wk" taps alone). 6e / 6v: ``serve_path`` (timed)
    on both mask sets as bool, the prompt's frontend states 4 x
    n_src_frames / n_img_tokens, spmm launches a packed generate = the
    prefill's + 15 decode steps'; other frontend states change the dense
    logits; ``check_incremental`` within SERVE_TOL. Returns the launches
    of each path. ``cfg`` and ``device`` rehearse it elsewhere (a TINY
    config on the CPU, where no launch counts hold)."""
    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.data import synthetic
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    dev = torch.device(device)
    full = configs.get(name)
    vlm = bool(full.cross_attn_every)
    tag, key = ("v", "img") if vlm else ("e", "src")
    if cfg is None:
        cfg = (full.replace(n_layers=VLM_LAYERS) if vlm else full.replace(
            n_layers=SEAMLESS_LAYERS, n_enc_layers=SEAMLESS_LAYERS))
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    if vlm:
        G, NS = transformer.groups(cfg)
        for gate, v in zip(("gate_attn", "gate_mlp"), VLM_GATES):
            params["cross_layers"][gate].fill_(v)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    out = {}
    with Phase(f"4{tag} {name}: prune_model + perplexity"):
        if vlm:
            log(f"   config: {name} full width (d_model {cfg.d_model}, "
                f"{cfg.n_heads} / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff} "
                f"{cfg.mlp} {cfg.act}, vocab {cfg.vocab_size}; a gated "
                f"cross-attention layer every {cfg.cross_attn_every} over "
                f"{cfg.n_img_tokens} image tokens), n_layers {cfg.n_layers} "
                f"(reduced from {full.n_layers}: {G} group of {NS} self "
                f"layers + 1 cross layer), gates {VLM_GATES}, {cfg.dtype}; "
                f"{cfg.n_params()} params")
            plan = pruning.plan_pruning(
                api, api.init(device="meta"),
                pruning.PruneRecipe.single("0.6"))
            weights, calib = 2 * cfg.n_params(), plan.total_calib_bytes(
                minimal=False)
            layer = max(4 * t.d_in * t.d_in for t in pruning.tap_specs(
                cfg, pruning.site_specs(cfg, params)))
            log(f"   reckoned peak of calibration: bf16 weights "
                f"{weights / 1e9:.2f} GB + the accumulated taps "
                f"{calib / 1e9:.2f} GB + a batch's taps {calib / 1e9:.2f} GB "
                f"+ one layer's largest tap {layer / 1e9:.2f} GB (its slot "
                f"copy) = {(weights + 2 * calib + layer) / 2**30:.2f} GiB of "
                f"the card's {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
        else:
            log(f"   config: {name} full width (d_model {cfg.d_model}, "
                f"{cfg.n_heads} / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff} "
                f"{cfg.mlp} {cfg.act}, {cfg.norm}, vocab {cfg.vocab_size}, "
                f"{cfg.n_src_frames} source frames), n_enc_layers "
                f"{cfg.n_enc_layers} and n_layers {cfg.n_layers} (reduced "
                f"from {full.n_enc_layers} + {full.n_layers}), {cfg.dtype}; "
                f"{cfg.n_params()} params")
        out["prune"], reports = prune_patterns(
            api, params, batches, dev, nm_method="none", host_masks=True)
        taps = pruning.accumulate_stats(
            api, params, batches,
            spec=pruning.CalibSpec(levels=(("wk", "gram"),))).taps
        if vlm:
            site = ("cross_layers.attn.wk[0]",
                    params["cross_layers"]["attn"]["wk"][0],
                    taps["cross"]["wk"]["g"][0])
        else:
            site = ("dec_layers.xattn.wk[0]",
                    params["dec_layers"]["xattn"]["wk"][0],
                    taps["dec"]["x_wk"]["g"][0])
        out["swap_commit"] = refine_candidates(f"4{tag}", [site])
        del taps, site
        torch.cuda.empty_cache()
    with Phase(f"6{tag} {name}: serve dense / masked / nm24 / gathered"):
        per = spmm_sites(cfg, params)["spmm"]
        first = spmm_sites(cfg, params, prefill=True)["spmm"]
        if vlm:
            want = (7 * NS * G + 5 * G, 7 * NS * G + 7 * G)
            what = (f"(7 sites x {NS} self layers + 5 cross sites) x {G} "
                    f"group, the cross wk / wv at the prefill alone")
        else:
            want = (8 * cfg.n_layers,
                    8 * cfg.n_layers + 2 * cfg.n_layers + 6 * cfg.n_enc_layers)
            what = (f"8 decoder sites x {cfg.n_layers} layers, the encoder's "
                    f"6 x {cfg.n_enc_layers} and the cross wk / wv at the "
                    "prefill alone")
        log(f"   spmm launches a packed generate: {what}: {first} (the "
            f"prefill) + {SERVE_GEN - 1} x {per} (decode steps) = "
            f"{first + (SERVE_GEN - 1) * per}")
        require((per, first) == want,
                f"6{tag}: spmm launches {per} a decode step and {first} a "
                f"prefill, want {want}")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 32, split="val", device=dev)
        prompt = synthetic.with_modality(pipe.get(0), cfg, 0, 0)
        log(f"   prompt: tokens {tuple(prompt['tokens'].shape)}, {key} "
            f"{tuple(prompt[key].shape)} {prompt[key].dtype}")
        other = dict(prompt)
        other[key] = synthetic.with_modality(pipe.get(0), cfg, 1, 0)[key]
        out["serve"] = serve_path(
            api, params, _tree_to(reports["0.6"].masks, dev, torch.bool),
            _tree_to(reports["2:4"].masks, dev, torch.bool), prompt,
            also=lambda engines: check_cross_path(engines, prompt, other,
                                                  tag))
        log(f"   {name}: spmm launches {out['serve']}")
        del reports
        torch.cuda.empty_cache()
        eng = ServeEngine(api, params, fmt="dense", device=dev)
        a, b = eng.logits_trace(prompt, 2), eng.logits_trace(other, 2)
        gap, scale = float((a - b).abs().max()), float(a.abs().max())
        log(f"   6{tag}: other {key} states move the dense logits by "
            f"{gap:.4e} ({gap / scale:.2e} of max|logits| {scale:.3f})")
        require(gap > 1e-3 * scale, f"6{tag}: the logits ignore {key}")
        del eng
        longer = synthetic.DataPipeline(
            synthetic.CorpusConfig(cfg.vocab_size), 4, 48, split="val",
            device=dev).get(1)
        check_incremental(api, params, synthetic.with_modality(
            longer, cfg, 0, 1), 32, SERVE_TOL, f"6{tag}")
    del params, batches
    torch.cuda.empty_cache()
    return out


def check_pruned(api, params, report, launches: dict, n_batches: int,
                 pattern, dense: dict, pruned: dict, *,
                 refined: bool = True) -> None:
    """Phases 4, 4b, 4m, 4z, 4r, 4e and 4v: every Gram launch on the bf16
    path, one per tap instance (a layer; a VLM's self layer of a group)
    and batch, an MoE tap's (every expert's Gram) one stacked launch a
    layer, a shared block's tap one a site it runs at; swap_topk once per
    site instance and pass: T_MAX passes each (taps, sites and instances
    from ``pruning.sites``; an expert of a layer is an instance), none for
    an N:M pattern or an unrefined run; exact per-row sparsity, monotone
    row losses, finite perplexities, and with ``refined`` (a SparseSwaps
    run, not Wanda alone) a positive mean error reduction."""
    from repro_torch.core import masks
    from repro_torch.pruning import sites

    cfg = api.cfg
    specs = sites.site_specs(cfg, params)
    by = {s.name: s for s in specs}
    n_gram = n_stacked = 0
    for t in sites.tap_specs(cfg, specs):
        s = by[t.sites[0]]
        if not s.stack_shape:
            n_gram += shared_sites(cfg)
        elif cfg.is_moe and len(s.stack_shape) == 2:
            n_stacked += s.stack_shape[0]
        else:
            n_gram += s.n_instances
    n_gram, n_stacked = n_gram * n_batches, n_stacked * n_batches
    require(launches["gram_xtx_bf16"] == n_gram and launches["gram_xtx"] == 0
            and launches["gram_xtx_stacked_bf16"] == n_stacked
            and launches["gram_xtx_stacked"] == 0,
            f"{cfg.name}: the Gram launches were not {n_gram} unstacked and "
            f"{n_stacked} stacked, all on the bf16 path")
    # an N:M search runs swap_math.topk_swaps_nm, plain ops in both
    # packages (the reference's is jnp, no Pallas kernel)
    n_topk = (0 if isinstance(pattern, masks.NM) or not refined
              else sum(s.n_instances for s in specs) * T_MAX)
    require(launches["swap_topk"] == n_topk,
            f"{cfg.name}: swap_topk launched {launches['swap_topk']} times, "
            f"want {n_topk}")
    for s in report.sites:
        node = report.masks
        for k in s.name.split("."):
            node = node[k]
        require(masks.validate_mask(node, pattern),
                f"{cfg.name} {s.name}: per-row sparsity not exact")
        require(bool((s.row_loss_final <= s.row_loss_init).all()),
                f"{cfg.name} {s.name}: a row loss rose")
    require(not refined or report.mean_error_reduction() > 0,
            f"{cfg.name}: no error reduction over the warmstart")
    require(math.isfinite(dense["perplexity"])
            and math.isfinite(pruned["perplexity"]),
            f"{cfg.name}: perplexity not finite")


RECIPE = {
    "defaults": {"pattern": "0.6", "t_max": T_MAX},
    "rules": [
        {"select": "*.attn.wq", "pattern": "2:4"},
        {"select": "*.attn.wo", "pattern": "2:4"},
        {"select": "*.attn.wk", "method": "sparsegpt"},
        {"select": "*.attn.wv", "skip": True},
        {"select": "*.mlp.w_down", "method": "dsnot"},
        {"select": "*"},
    ],
}


# where the host time of a resumed recipe run goes: (label, file, function,
# caller or None) of the port, by cumulative time under cProfile
RESUME_SPLIT = [
    ("launch.prune.prune", "launch/prune.py", "prune", None),
    ("  PruneExecutor.run", "pruning/executor.py", "run", None),
    ("    accumulate_stats (calibration restore)", "pruning/stats.py",
     "accumulate_stats", None),
    ("    _data_fingerprint (to host, sha256)", "pruning/executor.py",
     "_data_fingerprint", None),
    ("    _restore_group", "pruning/executor.py", "_restore_group", None),
    ("      ckpt.restore_latest (read, hash check)", "ckpt/store.py",
     "restore_latest", "_restore_group"),
    ("  evaluate (dense + pruned)", "pruning/evaluate.py", "evaluate", None),
    ("  write_out_dir", "launch/prune.py", "write_out_dir", None),
]


def host_split(prof, top: int = 12) -> list[str]:
    """RESUME_SPLIT's cumulative times, then the ``top`` functions by self
    time (C calls included: hashing, copies, file reads and writes)."""
    import pstats

    st = pstats.Stats(prof).stats
    lines = []
    for label, path, func, caller in RESUME_SPLIT:
        ct = 0.0
        for (f, _, fn), (_, _, _, cum, callers) in st.items():
            if fn != func or not f.endswith(path):
                continue
            ct += cum if caller is None else sum(
                v[3] for (_, _, cfn), v in callers.items() if cfn == caller)
        lines.append(f"     {ct:8.3f} s  {label}")
    lines.append("     by self time:")
    for (f, ln, fn), v in sorted(st.items(), key=lambda kv: -kv[1][2])[:top]:
        where = fn if f == "~" else f"{Path(f).name}:{ln} {fn}"
        lines.append(f"     {v[2]:8.3f} s {v[1]:7d}x  {where[:90]}")
    return lines


def recipe_path(cfg) -> None:
    """Phase 7: the launcher with a recipe of every rule kind, run twice
    into one out dir (the second resumes every group), a third time
    under cProfile (the host-time split of a resume), and plan_only."""
    import cProfile
    import tempfile

    import torch
    from repro_torch import pruning
    from repro_torch.core import masks
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    class Count(pruning.PruneCallback):
        """Restored and computed groups, and each group's wall time."""

        def __init__(self):
            self.restored, self.computed, self.secs = [], [], {}

        def on_group_start(self, planned, index, total):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_group_done(self, planned, report, *, restored):
            torch.cuda.synchronize()
            self.secs[f"{planned.name} [{report.pattern} {report.method}]"] \
                = time.perf_counter() - self.t0
            (self.restored if restored else self.computed).append(
                planned.name)

    with tempfile.TemporaryDirectory() as tmp:
        recipe_file = Path(tmp) / "recipe.json"
        recipe_file.write_text(json.dumps(RECIPE))
        kw = dict(tiny=False, n_layers=cfg.n_layers, recipe=str(recipe_file),
                  out_dir=str(Path(tmp) / "out"), calib_ckpt_every=2,
                  calib_stats="minimal", compact_every=2, device="cuda",
                  verbose=False)
        outs, counts = [], []
        for run in (1, 2):
            counts.append(Count())
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = launch_prune.prune(cfg.name, callback=counts[-1], **kw)
            torch.cuda.synchronize()
            outs.append(out)
            rep = out["report"]
            log(f"   run {run}: {time.perf_counter() - t0:.2f} s "
                f"(executor {rep.wall_time_s:.2f} s), computed "
                f"{len(counts[-1].computed)} groups, restored "
                f"{len(counts[-1].restored)}, calibration batches "
                f"{out['stats'].batches}, launches {dict(ops.LAUNCHES)}")
            log(f"   run {run}: dense ppl {out['dense']['perplexity']:.4f}, "
                f"pruned ppl {out['pruned']['perplexity']:.4f}")
            log("   group wall times: " + ", ".join(
                f"{k} {v:.2f} s" for k, v in counts[-1].secs.items()))
            if run == 1:
                log(rep.summary())
        rep, stats = outs[0]["report"], outs[0]["stats"]
        for s in rep.sites:
            node = rep.masks
            for k in s.name.split("."):
                node = node[k]
            require(masks.validate_mask(node, masks.parse_pattern(s.pattern)),
                    f"{s.name}: sparsity not exact for {s.pattern}")
        require("wv" not in rep.masks["layers"]["attn"]
                and "wv" not in stats.taps,
                "the skipped site has a mask or a tap")
        require(set(stats.taps["w_down"]) == {"d", "s", "n"},
                "the dsnot site accumulated a Gram")
        require(sorted({s.method for s in rep.sites})
                == ["dsnot", "sparsegpt", "sparseswaps"],
                "the recipe did not run every method")
        for out in outs:
            require(math.isfinite(out["dense"]["perplexity"])
                    and math.isfinite(out["pruned"]["perplexity"]),
                    "perplexity not finite")
        n_active = len(rep.sites)
        require(len(counts[0].computed) == n_active and not counts[0].restored,
                "the first run did not compute every group")
        require(len(counts[1].restored) == n_active
                and not counts[1].computed,
                "the second run recomputed a group")
        again = outs[1]["report"]
        for s in rep.sites:
            a, b = rep.masks, again.masks
            for k in s.name.split("."):
                a, b = a[k], b[k]
            require(torch.equal(a, b), f"{s.name}: resumed masks differ")
        log(f"   resume: {n_active}/{n_active} groups restored, masks "
            "bitwise equal")
        del outs, rep, again, stats
        count = Count()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        launch_prune.prune(cfg.name, callback=count, **kw)
        torch.cuda.synchronize()
        prof.disable()
        log(f"   run 3 (resumed again, under cProfile): "
            f"{time.perf_counter() - t0:.2f} s, restored "
            f"{len(count.restored)} groups; host time split:")
        require(len(count.restored) == n_active and not count.computed,
                "the third run recomputed a group")
        for line in host_split(prof):
            log(line)
        del prof
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        launch_prune.prune(cfg.name, plan_only=True,
                           **{k: v for k, v in kw.items()
                              if k not in ("out_dir", "calib_ckpt_every",
                                           "calib_stats", "verbose")})
        after = torch.cuda.memory_allocated()
        log(f"   plan_only: cuda memory allocated {before} -> {after} B")
        require(after == before, "plan_only allocated CUDA memory")


# phase 9: training and post-prune recovery (8 train steps of batch 4 x
# 128 tokens, a checkpoint every 4; 20 recovery steps, a checkpoint every
# 10). A whole run of this script is held under 45 GiB of disk writes.
# llama31-8b's TrainState at 2 layers and vocabulary 128256 is 15 GB a
# checkpoint (bf16 params and fp32 m and v of 1.49 B params), and the
# phase writes two besides the recovery's, so phase 9 keeps every layer
# width (every kernel shape of phases 3-6) but cuts the depth to 1 and
# the vocabulary to llama-2's 32000 (arXiv:2307.09288): 4.8 GB a
# TrainState, ~25 GB written by the whole phase.
P9_LAYERS, P9_VOCAB = 1, 32000
TRAIN_STEPS, TRAIN_CKPT = 8, 4
RECOVER_STEPS, RECOVER_CKPT = 20, 10
TIMED_STEPS = 4          # CUDA-event timed steps; the median skips the first
# phase 9m: granite-moe-3b-a800m at full width and its own vocabulary
# 49155. At 2 layers (0.35 B params, a 3.5 GB TrainState: bf16 params,
# fp32 m and v) the phase writes 16.7 GB, which with phases 7 (8.3 GB)
# and 9 (24.0 GB) would pass the 45 GiB budget; at 1 layer (0.25 B
# params, 2.5 GB) 9.9 GB
P9M_LAYERS = 1


def event_ms(step, state, *args, n: int = TIMED_STEPS) -> float:
    """Median ms of steps 2..n of ``state = step(*args, state, ...)`` by
    CUDA events (each step's device work, the first left out)."""
    import torch

    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = step(*args[:-1], state, args[-1])
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    del state
    return sorted(times[1:])[len(times[1:]) // 2]


def echo_run(fn, **kw):
    """``fn(**kw)`` with its standard output captured (and echoed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(**kw)
    text = buf.getvalue()
    for line in text.splitlines():
        if "recover" in line or line.startswith(("resumed", "step ")):
            log(f"     | {line}")
    return out, text


def equal_trees(a, b) -> bool:
    import torch
    from repro_torch.pruning.recover import _flat_leaves

    fa, fb = _flat_leaves(a), _flat_leaves(b)
    return [n for n, _ in fa] == [n for n, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def deterministic_mode(seen: set):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` while
    entered: every op without a deterministic implementation warns
    instead of running as it would, and each distinct warning text is
    added to ``seen``."""
    import contextlib
    import warnings

    import torch

    @contextlib.contextmanager
    def ctx():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    yield
                finally:
                    seen.update(str(w.message) for w in caught)
        finally:
            torch.use_deterministic_algorithms(False)
    return ctx()


# each recovery run of phases 9 and 9m, into one out dir: (selection, its
# checkpoint period in steps (0: none), rerun to resume). Phase 9 resumes
# all_masked; 9m checkpoints all_masked once (its m and v are read there)
# and resumes lora, whose checkpoints hold only the adapters: the write
# budget. Phase 9's norms_biases run (llama31-8b has no biases: its norm
# scales) is the single-device command 9d (a) holds its mesh run to.
RECOVERIES_9 = (("all_masked", RECOVER_CKPT, True),
                ("norms_biases", 0, False))
RECOVERIES_9M = (("all_masked", RECOVER_STEPS, False),
                 ("lora", RECOVER_CKPT, True))


@contextlib.contextmanager
def one_rank_world(store: Path, device):
    """This process as a one-rank world (NCCL on the card, gloo on the
    CPU) on a file:// store, destroyed on the way out."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_distributed(device, init_method=f"file://{store}", rank=0,
                              world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def train_recover_path(cfg, smi: str, device="cuda", *,
                       recoveries=RECOVERIES_9, deterministic=False,
                       tag: str = "9", mesh: bool = False) -> dict:
    """Phase 9 (and 9m) on ``cfg`` (registered under its name for the
    launchers): train -> prune the trained checkpoint -> recover each of
    ``recoveries`` into one out dir (a rerun of the resumed one) -> export
    the first -> serve the export. With ``deterministic``, a second
    uninterrupted run must repeat the first bitwise, and the preempted
    and resumed runs (and the uninterrupted run they are held to) train
    under ``deterministic_mode``: every op it flags is printed, and any
    but cuBLAS's workspace notice fails the phase. With ``mesh`` (phase
    9d (a)) the process is a one-rank world: the preempted and resumed
    runs train on its (1, 1) mesh (``launch.train(mesh="host")``, sharded
    checkpoints), and ``launch.prune(mesh="host")`` with the last of
    ``recoveries`` is held bitwise to the single-device command. Returns
    the kernel launches of its prune and serve runs."""
    import importlib
    import os
    import shutil
    import signal
    import tempfile

    import torch
    from repro_torch import ckpt, configs, models
    from repro_torch.core import masks
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine
    from repro_torch.train import steps as steps_lib

    rec_mod = importlib.import_module("repro_torch.pruning.recover")
    cuda = torch.device(device).type == "cuda"
    configs.ARCHS[cfg.name] = cfg
    arch, n_layers = cfg.name, cfg.n_layers
    api = models.build(cfg)
    n_sites = spmm_sites(cfg, api.init(device="meta"))
    totals = dict.fromkeys(("gram_xtx", "gram_xtx_stacked", "swap_topk",
                            "spmm", "spmm_gather", "spmm_stacked",
                            "spmm_stacked_gather"), 0)
    pattern = masks.PerRow(0.6)
    common = dict(arch=arch, tiny=False, device=device)

    def count(launches):
        totals["gram_xtx"] += launches["gram_xtx"] + launches["gram_xtx_bf16"]
        totals["gram_xtx_stacked"] += (launches["gram_xtx_stacked"]
                                       + launches["gram_xtx_stacked_bf16"])
        totals["swap_topk"] += launches["swap_topk"]

    def count_spmm(fmt, before):
        suffix = "" if fmt == "nm24" else "_gather"
        for k, v in before.items():
            totals[k + suffix] += ops.LAUNCHES[k] - v

    def sigterm_after(n: int):
        """A make_train_step whose step sends this process SIGTERM after
        its n-th call (the launcher's PreemptionGuard catches it)."""
        real = steps_lib.make_train_step

        def make(api, opt_cfg, **kw):
            step, calls = real(api, opt_cfg, **kw), [0]

            def wrapped(state, batch):
                out = step(state, batch)
                calls[0] += 1
                if calls[0] == n:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            return wrapped

        return make

    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, (
            one_rank_world(Path(tmp) / "store", device) if mesh
            else contextlib.nullcontext()):
        work = Path(tmp)
        tdir = work / "train"
        # (a) train uninterrupted (no checkpoint); then with checkpoints,
        # preempted by SIGTERM after step 3, and resumed to the end
        kw = dict(common, n_steps=TRAIN_STEPS, batch=4, seq=128, seed=0,
                  log_every=1)
        t0 = time.perf_counter()
        full, _ = echo_run(launch_train.train, **kw)
        t_full = time.perf_counter() - t0
        losses = full["losses"]
        require(len(losses) == TRAIN_STEPS
                and all(math.isfinite(x) for x in losses),
                f"train losses not finite: {losses}")
        require(losses[-1] < losses[0],
                f"step {TRAIN_STEPS - 1}'s loss {losses[-1]} is not below "
                f"step 0's {losses[0]}")
        params1 = full["state"].params
        del full
        flagged = set()
        if deterministic:
            again, _ = echo_run(launch_train.train, **kw)
            require(again["losses"] == losses
                    and equal_trees(again["state"].params, params1),
                    "two uninterrupted runs differ: the backward is not "
                    "deterministic")
            del again
        with (deterministic_mode(flagged) if deterministic
              else contextlib.nullcontext()):
            if deterministic:
                ref, _ = echo_run(launch_train.train, **kw)
                same = (ref["losses"] == losses
                        and equal_trees(ref["state"].params, params1))
                losses, params1 = ref["losses"], ref["state"].params
                del ref
            kw.update(ckpt_dir=str(tdir), ckpt_every=TRAIN_CKPT,
                      **({"mesh": "host"} if mesh else {}))
            real_make = steps_lib.make_train_step
            steps_lib.make_train_step = sigterm_after(TRAIN_CKPT)
            try:
                t0 = time.perf_counter()
                cut, text = echo_run(launch_train.train, **kw)
                t_cut = time.perf_counter() - t0
            finally:
                steps_lib.make_train_step = real_make
            require("preempted at step 3" in text
                    and cut["final_step"] == TRAIN_CKPT
                    and ckpt.steps(tdir) == [TRAIN_CKPT],
                    f"SIGTERM did not stop the run at step {TRAIN_CKPT} with "
                    f"one checkpoint: {ckpt.steps(tdir)}")
            require(cut["losses"] == losses[:TRAIN_CKPT],
                    "the checkpointed run's losses differ from the "
                    "uninterrupted run's")
            del cut
            t0 = time.perf_counter()
            run2, _ = echo_run(launch_train.train, **kw)
            t_run2 = time.perf_counter() - t0
        require(run2["start_step"] == TRAIN_CKPT
                and run2["final_step"] == TRAIN_STEPS,
                f"resume ran {run2['start_step']}..{run2['final_step']}")
        require(run2["losses"] == losses[TRAIN_CKPT:],
                "the resumed run's losses differ from the uninterrupted "
                "run's")
        require(equal_trees(run2["params"], params1),
                "the resumed run's params differ from the uninterrupted "
                "run's")
        log(f"   ({tag}a) train: losses {[round(x, 4) for x in losses]}; "
            f"{t_full:.2f} s for {TRAIN_STEPS} steps; with checkpoints "
            f"{t_cut:.2f} s to the SIGTERM and its step-{TRAIN_CKPT} "
            f"checkpoint, {t_run2:.2f} s resumed to the end"
            + (" on a one-rank mesh (9d a: the state sharded by "
               "state_pspecs, the checkpoint in the sharded layout)"
               if mesh else "")
            + ": losses and params bitwise the uninterrupted single-device "
            "run's")
        if deterministic:
            log(f"   ({tag}a) two uninterrupted runs bitwise equal; under "
                f"deterministic algorithms (the preempted and resumed runs "
                f"and the run they match) the losses and params "
                f"{'equal' if same else 'DIFFER from'} the default mode's; "
                f"ops flagged: {sorted(m[:160] for m in flagged) or 'none'}")
            require(all("CuBLAS" in m for m in flagged),
                    f"a nondeterministic op in the train step: {flagged}")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 128, split="train", device=device)
        step = steps_lib.make_train_step(api, adamw.AdamWConfig())
        train_ms = (event_ms(step, run2["state"], pipe.get(0)) if cuda
                    else float("nan"))
        trained = run2["params"]
        del run2, params1, step

        # (b) prune the trained checkpoint, (c) each recovery into the same
        # out dir (the first run computes every group, later ones restore)
        pdir = work / "prune"
        rdir = pdir / "prune_ckpt" / "recover"
        pkw = dict(common, pattern="0.6", warmstart="wanda",
                   method="sparseswaps", k_swaps=8, t_max=T_MAX, n_calib=16,
                   calib_seq=128, calib_batch=4, seed=0, out_dir=str(pdir),
                   from_ckpt=str(tdir), recover_steps=RECOVER_STEPS)
        batch = pipe.get(1)
        step_ms, first = {}, None
        for select, every, resumed in recoveries:
            rkw = dict(pkw, recover=select, calib_ckpt_every=every)
            ops.reset_launches()
            t0 = time.perf_counter()
            res, _ = echo_run(launch_prune.prune, **rkw)
            t_run = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            count(launches)
            rep, ex = res["report"], res["executor"]
            if first is None:
                require(equal_trees(ex.params, trained),
                        "--from-ckpt did not prune the trained params")
                check_pruned(api, ex.params, rep, launches, 4, pattern,
                             res["dense"], res["pruned"])
                log(f"   ({tag}b) prune --from-ckpt: {t_run:.2f} s with "
                    f"recovery, launches {launches}; dense ppl "
                    f"{res['dense']['perplexity']:.4f}, pruned ppl "
                    f"{res['pruned']['perplexity']:.4f}, error reduction "
                    f"{100 * rep.mean_error_reduction():.3f}%; masks digest "
                    f"{digest(mask_leaves(rep.masks))}")
            rr = res["recover_result"]
            require(rr.steps_run == RECOVER_STEPS and not rr.diverged
                    and all(math.isfinite(c) for c in rr.ce_history),
                    f"{select} recovery CE not finite at every step: "
                    f"{rr.ce_history}")
            notes = ""
            if select in ("all_masked", "lora"):
                flat_masks = dict(rec_mod._flat_leaves(rep.masks))
                flat_rec = dict(rec_mod._flat_leaves(rep.updated_params))
                for name, m in flat_masks.items():
                    require(not bool(flat_rec[name][m == 0].any()),
                            f"{select} {name}: a pruned weight is nonzero "
                            "after recovery")
                notes = "; pruned coordinates 0.0 in the weights"
            if every:
                want = list(range(every, RECOVER_STEPS + 1, every))[-2:]
                require(ckpt.steps(rdir) == want,
                        f"{select} recovery checkpoints {ckpt.steps(rdir)}, "
                        f"want {want}")
            if select == "all_masked" and every:
                saved, _ = ckpt.restore(rdir, RECOVER_STEPS,
                                        [f".opt/.{p}/{n}" for p in "mv"
                                         for n in flat_masks])
                for path, arr in saved.items():
                    m = flat_masks[path.split("/")[-1]]
                    require(not bool(ckpt.to_tensor(arr, device)[m == 0]
                                     .any()),
                            f"{path}: a moment is nonzero at a pruned "
                            "coordinate")
                del saved
                notes += ", m and v"
            if select.startswith("norms"):
                base = dict(rec_mod._flat_leaves(trained))
                notes = "; norm scale elements changed: " + str(
                    {n: f"{int((a != base[n]).sum())}/{a.numel()} {a.dtype}"
                     for n, a in rec_mod._flat_leaves(rr.trainable)})
            log(f"   ({tag}c) recover {select}: {t_run:.2f} s, CE "
                f"{rr.ce_history[0]:.4f} -> {rr.ce_history[-1]:.4f} over "
                f"{rr.steps_run} steps, trainable {rr.trainable_count} of "
                f"{rr.total_count} ({100 * rr.trainable_frac:.4f}%), "
                f"recovered ppl {res['recovered']['perplexity']:.4f}{notes}")
            if resumed:
                recovered = rep.updated_params
                shutil.rmtree(rdir / f"step_{RECOVER_STEPS:08d}")
                ops.reset_launches()
                t0 = time.perf_counter()
                res, text = echo_run(launch_prune.prune, **rkw)
                t_resume = time.perf_counter() - t0
                count(dict(ops.LAUNCHES))
                rr2 = res["recover_result"]
                back = RECOVER_STEPS - every
                require(f"recover: resumed at step {back}" in text,
                        f"the {select} rerun did not resume the recovery")
                require(rr2.start_step == back
                        and rr2.steps_run == RECOVER_STEPS - back,
                        f"the {select} rerun ran {rr2.start_step} + "
                        f"{rr2.steps_run} steps")
                require(equal_trees(res["report"].updated_params, recovered),
                        f"the resumed {select} recovery's params differ from "
                        "the uninterrupted run's")
                require(rr2.ce_history == rr.ce_history[back:],
                        f"the resumed {select} recovery's CE differs")
                log(f"   ({tag}c) {select} rerun: {t_resume:.2f} s, resumed "
                    f"at step {rr2.start_step}, ran {rr2.steps_run} steps: "
                    "recovered params and CE bitwise the uninterrupted run's")
                del recovered
            sel = rec_mod.build_selection(trained, rep.masks, rr.spec)
            rstep = rec_mod._make_step(api, rep.masks, sel,
                                       rr.spec.opt_config())
            rstate = steps_lib.TrainState(sel.trainable,
                                          adamw.init(sel.trainable))
            step_ms[select] = (event_ms(rstep, rstate, trained, batch)
                               if cuda else float("nan"))
            del sel, rstep, rstate
            if first is None:
                first, first_launches = res, launches
            last = res
            del res
        if mesh:
            # 9d (a): the last recovery's command on the one-rank mesh,
            # computing every group (no out dir): bitwise the single-device
            # command's report, masks, recovery and evaluations
            ops.reset_launches()
            t0 = time.perf_counter()
            got, _ = echo_run(launch_prune.prune, **dict(
                pkw, recover=recoveries[-1][0], calib_ckpt_every=0,
                out_dir=None, mesh="host"))
            t_mesh = time.perf_counter() - t0
            mesh_launches = dict(ops.LAUNCHES)
            count(mesh_launches)
            a, b = got["report"], last["report"]
            ra, rb = got["recover_result"], last["recover_result"]
            same = {
                "masks": digest(mask_leaves(a.masks))
                == digest(mask_leaves(b.masks)),
                # (the mesh's swap counts are its net mask distance / 2)
                "site losses": all(
                    torch.equal(getattr(x, f), getattr(y, f))
                    for x, y in zip(a.sites, b.sites)
                    for f in ("row_loss_init", "row_loss_final")),
                "recovered params": equal_trees(a.updated_params,
                                                b.updated_params),
                "trained leaves": equal_trees(ra.trainable, rb.trainable),
                "CE": ra.ce_history == rb.ce_history,
                "evaluations": all(got[k] == last[k] for k in
                                   ("dense", "pruned", "recovered"))}
            require(all(same.values()),
                    f"(9d a) prune --mesh host --recover {recoveries[-1][0]}"
                    f" vs the single-device command, equal: {same}")
            require(all(mesh_launches[k] == first_launches[k]
                        for k in ("gram_xtx_bf16", "swap_topk")),
                    f"(9d a) the mesh run's launches {mesh_launches}, the "
                    f"single-device prune's {first_launches}")
            log(f"   (9d a) prune --from-ckpt --mesh host --recover "
                f"{recoveries[-1][0]} on a one-rank mesh: {t_mesh:.2f} s, "
                f"launches {mesh_launches}; report, masks (digest "
                f"{digest(mask_leaves(a.masks))}), recovered params, CE and "
                "perplexities bitwise the single-device command's")
            del got, a, b
        del last

        # (d) export and serve the first recovery: PerRow(0.6) gathered;
        # a 2:4 run for nm24
        prompt = synthetic.DataPipeline(
            synthetic.CorpusConfig(cfg.vocab_size, seed=0), 4, 32,
            split="val", device=device).get(0)
        ex, rep = first["executor"], first["report"]
        ops.reset_launches()
        res24, _ = echo_run(launch_prune.prune, **dict(
            pkw, recover=recoveries[0][0], pattern="2:4", out_dir=None,
            calib_ckpt_every=0))
        count(dict(ops.LAUNCHES))
        want_n = {k: v * SERVE_GEN if cuda else 0
                  for k, v in n_sites.items()}
        for fmt, (exe, rp) in (("gathered", (ex, rep)),
                               ("nm24", (res24["executor"],
                                         res24["report"]))):
            out = exe.export_packed(work / f"export_{fmt}", fmt)
            first_n = {k: ops.LAUNCHES[k] for k in n_sites}
            want = ServeEngine(api, rp.updated_params, masks=rp.masks,
                               fmt=fmt, device=device)
            before = {k: ops.LAUNCHES[k] for k in n_sites}
            served, _ = echo_run(
                launch_serve.serve, **dict(
                    common, batch=4, prompt_len=32,
                    gen=SERVE_GEN, masks_from=str(out), fmt=fmt, seed=0,
                    from_ckpt=str(tdir), verbose=False))
            n = {k: ops.LAUNCHES[k] - v for k, v in before.items()}
            require(n == want_n, f"{fmt}: serving the export launched {n}, "
                    f"want {want_n}")
            direct = want.generate(prompt, SERVE_GEN)
            require(torch.equal(served["tokens"], direct.tokens),
                    f"{fmt}: the export's greedy tokens differ from the "
                    "in-process recovered model's")
            via = ServeEngine(api, trained, masks=out, fmt=fmt,
                              device=device)
            lt = want.logits_trace(prompt, SERVE_GEN)
            require(torch.equal(via.logits_trace(prompt, SERVE_GEN), lt),
                    f"{fmt}: the export's logits differ from the "
                    "in-process recovered model's")
            masked = ServeEngine(api, rp.updated_params, masks=rp.masks,
                                 fmt="masked", device=device)
            ref = masked.logits_trace(prompt, SERVE_GEN)
            toks = masked.generate(prompt, SERVE_GEN).tokens
            if cfg.is_moe:
                err = routed_pair(want, masked, prompt, toks,
                                  f"({tag}d) {fmt} vs masked")
            else:
                err = float((forced_logits(want, prompt, toks) - ref)
                            .abs().max())
            scale = float(ref.abs().max())
            require(math.isfinite(err) and err <= SERVE_TOL * scale,
                    f"{fmt} vs masked beyond {SERVE_TOL} of max|logits|")
            count_spmm(fmt, first_n)
            log(f"   ({tag}d) {fmt}: launch.serve --masks-from the export: "
                f"tokens and logits bitwise the in-process recovered "
                f"model's, spmm launches {n}; vs masked (fed its tokens) "
                f"{err / scale:.2e} of max|logits| {scale:.3f}")
            del want, via, masked
        groups = pdir / "prune_ckpt"
        before = {k: ops.LAUNCHES[k] for k in n_sites}
        served, _ = echo_run(launch_serve.serve, **dict(
            common, batch=4, prompt_len=32, gen=SERVE_GEN,
            masks_from=str(groups), fmt="gathered", seed=0,
            from_ckpt=str(tdir), verbose=False))
        want = ServeEngine(api, trained, masks=rep.masks, fmt="gathered",
                           device=device).generate(prompt, SERVE_GEN)
        count_spmm("gathered", before)
        require(torch.equal(served["tokens"], want.tokens),
                "serving prune_ckpt/groups differs from the run's masks")
        log(f"   ({tag}d) launch.serve --masks-from prune_ckpt (groups/): "
            "tokens bitwise the pruned model's")
        del first, res24, ex, rep, trained
    peak = (torch.cuda.max_memory_allocated() / 2**30 if cuda
            else float("nan"))
    log(f"   train step {train_ms:.2f} ms, recover steps "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in step_ms.items())
        + f" (CUDA events, median of steps 2-{TIMED_STEPS}); peak memory "
        f"{peak:.2f} GiB; phase {time.perf_counter() - t_phase:.2f} s; {smi}")
    return totals


# phases 9z, 9r, 9e and 9v: the four newest families trained, pruned,
# recovered and served at full width, bf16, seed 0, in memory: no
# TrainState is written (10 B a parameter, past the write budget), and
# each family's checkpoint format and resume are held on the CPU
# (tests/test_torch_*_train.py). The cuts (depth; the VLM's vocabulary
# too, for memory: at its own 128256 the TrainState and grad_accum 4's
# fp32 gradient sum reach ~61 GB before AdamW's temporaries) and the site
# whose trained weights and calibration Gram the candidate commit refines.
FAMILY_TRAIN = (
    dict(tag="9z", name=ZAMBA, cut=dict(n_layers=1), serve="export",
         lr=3e-4,
         commit=("layers.mamba.in_proj[0]", ("layers", "mamba", "in_proj"),
                 ("mamba", "in_proj"))),
    dict(tag="9r", name=RWKV, cut=dict(n_layers=2), serve="export",
         lr=3e-4,
         commit=("layers.tm.td_w1[0]", ("layers", "tm", "td_w1"),
                 ("td_w1",))),
    dict(tag="9e", name=SEAMLESS, cut=dict(n_layers=2, n_enc_layers=2),
         serve="export", lr=3e-4,
         commit=("dec_layers.xattn.wk[0]", ("dec_layers", "xattn", "wk"),
                 ("dec", "x_wk"))),
    # the others train at the launcher's lr; at d = 8192 its 3e-4 (one
    # warmup step) took the next batch's loss from 11.85 to 45.46 in one
    # step: the VLM trains at 3e-5
    dict(tag="9v", name=VLM,
         cut=dict(n_layers=2, cross_attn_every=2, vocab_size=32000),
         serve="in process", lr=3e-5,
         commit=("cross_layers.attn.wk[0]", ("cross_layers", "attn", "wk"),
                 ("cross", "wk"))),
)

# norms_biases at RecoverSpec's 1e-3 (PERP's few norm and bias leaves);
# all_masked, which trains every kept weight, at 1e-4: at 1e-3
# seamless's first all_masked step lifted the CE from 10.33 to 11.17, and
# step 0's batch ended above where it started (10.3384 against 10.3339)
FAMILY_RECOVER_LR = {"norms_biases": 1e-3, "all_masked": 1e-4}


def family_train_path(row: dict, smi: str, *, exported: list, base=None,
                      device="cuda") -> dict:
    """Phases 9z / 9r / 9e / 9v on a row of FAMILY_TRAIN: its config
    ``name`` cut by ``cut`` (registered under its own name for the
    launcher), trained at ``lr``.

    (a) ``launch.train`` twice in memory, TRAIN_STEPS steps of 4 x 128
    tokens (frontend states included), the second under
    ``deterministic_mode``: losses finite, step 0's batch's loss lower
    after the steps than at step 0, the two runs bitwise equal, no flagged
    op but cuBLAS's; step ms (CUDA events) and peak memory; the optimizer
    state freed. (b) A ``PruneExecutor`` (no checkpoint directory) on the
    trained params at PerRow(0.6) (Wanda, k = 8, t_max = T_MAX, 16 x 128
    calibration tokens with their frontend states; a VLM's gates set to
    VLM_GATES first) with phase 4's gates, then ``refine_candidates`` on
    the row's ``commit`` site (label, param path, tap path) with its
    calibration Gram. (c) ``recover`` norms_biases, then all_masked, each
    RECOVER_STEPS steps from the pruned model at FAMILY_RECOVER_LR: CE
    finite at every step and falling (step 0's batch's CE lower after the
    steps), all_masked's pruned coordinates 0.0 in the weights; the
    recovered perplexity beside the pruned one; step ms. (d) The
    norms_biases recovery served gathered: with ``serve == "export"``
    through ``export_packed`` into a temporary directory, read back by
    ``load_masks_and_weights``, its greedy tokens and logits bitwise the
    in-process engine's (its bytes appended to ``exported``), else in
    process; spmm launches a generate = the site table's; packed vs
    masked (fed its tokens) printed, and in process (the VLM: its export
    would pass the write budget) gated within SERVE_TOL. Returns the
    kernel launches of (b)-(d). ``base`` (a TINY config, cut by ``cut``
    in its place) and ``device`` rehearse it elsewhere (on the CPU, where
    no launch counts hold)."""
    import importlib
    import shutil
    import tempfile

    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.core import masks, packed
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine
    from repro_torch.train import steps as steps_lib

    rec_mod = importlib.import_module("repro_torch.pruning.recover")
    cuda = torch.device(device).type == "cuda"
    tag, name, cut, serve = row["tag"], row["name"], row["cut"], row["serve"]
    full = base or configs.get(name)
    cfg = full.replace(name=f"{name}-" + "-".join(
        f"{k}{v}" for k, v in cut.items()), **cut)
    configs.ARCHS[cfg.name] = cfg
    api = models.build(cfg)
    log(f"   config: {name} at full width, cut: " + ", ".join(
        f"{k} {v} (of {getattr(full, k)})" for k, v in cut.items())
        + f"; grad_accum {cfg.grad_accum}, {cfg.dtype}; {cfg.n_params()} "
        f"params; train lr {row['lr']}")
    totals = dict.fromkeys(("gram_xtx", "swap_topk", "swap_commit",
                            "spmm_gather"), 0)

    # (a) train twice in memory, the second run under deterministic mode
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kw = dict(arch=cfg.name, tiny=False, device=device, n_steps=TRAIN_STEPS,
              batch=4, seq=128, seed=0, log_every=1, lr=row["lr"])
    t0 = time.perf_counter()
    run, _ = echo_run(launch_train.train, **kw)
    t_train = time.perf_counter() - t0
    losses, trained = run["losses"], run["state"].params
    del run
    require(len(losses) == TRAIN_STEPS
            and all(math.isfinite(x) for x in losses),
            f"{tag}: train losses not finite: {losses}")
    # each step draws its own batch, and at random weights a batch's CE
    # depends on how many of its tokens the steps before it saw (the VLM's
    # spread 10.97-13.12 at lr 3e-5, a step of 4e-6 apart): the falling
    # loss is held on step 0's batch, before and after the training
    pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                  4, 128, split="train", device=device)
    batch = synthetic.with_modality(pipe.get(0), cfg, 0, 0)
    with torch.no_grad():
        after = float(api.loss(trained, batch)[0])
    require(after < losses[0],
            f"{tag}: step 0's batch has loss {after} after training, "
            f"{losses[0]} before")
    flagged = set()
    with deterministic_mode(flagged):
        again, _ = echo_run(launch_train.train, **kw)
    require(again["losses"] == losses
            and equal_trees(again["state"].params, trained),
            f"{tag}: the run under deterministic algorithms differs from the "
            "first")
    del again
    log(f"   ({tag}a) train: losses {[round(x, 4) for x in losses]}; "
        f"step 0's batch {losses[0]:.4f} -> {after:.4f}; "
        f"{t_train:.2f} s for {TRAIN_STEPS} steps; the second run, under "
        "deterministic algorithms, bitwise the first; ops flagged: "
        f"{sorted(m[:160] for m in flagged) or 'none'}")
    require(all("CuBLAS" in m for m in flagged),
            f"{tag}: a nondeterministic op in the train step: {flagged}")
    step = steps_lib.make_train_step(api, adamw.AdamWConfig())
    train_ms = (event_ms(step, steps_lib.TrainState(trained,
                                                    adamw.init(trained)),
                         batch) if cuda else float("nan"))
    del step
    peak_train = (torch.cuda.max_memory_allocated() / 2**30 if cuda
                  else float("nan"))
    log(f"   ({tag}a) train step {train_ms:.2f} ms (CUDA events, median of "
        f"steps 2-{TIMED_STEPS}); peak memory {peak_train:.2f} GiB; the "
        "optimizer state freed")

    # (b) prune the trained params in process
    if cfg.cross_attn_every:
        for gate, v in zip(("gate_attn", "gate_mlp"), VLM_GATES):
            trained["cross_layers"][gate].fill_(v)
    pattern = masks.PerRow(0.6)
    calib = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=device))
    plan = pruning.plan_pruning(api, trained, pruning.PruneRecipe.single(
        pattern, method="sparseswaps", warmstart="wanda", t_max=T_MAX,
        k_swaps=8))
    ex = pruning.PruneExecutor(api, trained, plan)
    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = ex.run(calib)
    if cuda:
        torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_prune = (torch.cuda.max_memory_allocated() / 2**30 if cuda
                  else float("nan"))
    dense = pruning.evaluate(api, trained, seed=0, device=device)
    pruned = pruning.evaluate(api, trained, masks=rep.masks, seed=0,
                              device=device)
    check_pruned(api, trained, rep, launches, len(calib), pattern, dense,
                 pruned)
    totals["gram_xtx"] += launches["gram_xtx"] + launches["gram_xtx_bf16"]
    totals["swap_topk"] += launches["swap_topk"]
    log(f"   ({tag}b) prune the trained params: {t_prune:.2f} s, peak "
        f"memory {peak_prune:.2f} GiB, launches {launches}; dense ppl "
        f"{dense['perplexity']:.4f}, pruned ppl {pruned['perplexity']:.4f}, "
        f"error reduction {100 * rep.mean_error_reduction():.3f}%; masks "
        f"digest {digest(mask_leaves(rep.masks))}")
    label, wpath, gpath = row["commit"]
    totals["swap_commit"] += refine_candidates(f"{tag}b", [
        (label, packed._get(trained, wpath)[0],
         packed._get(ex.taps, gpath)["g"][0])])
    ex.taps = ex.stats = None
    del calib
    if cuda:
        torch.cuda.empty_cache()

    # (c) recover norms_biases, then all_masked, each from the pruned model
    step_ms, recovered = {}, None
    batch = synthetic.with_modality(pipe.get(1), cfg, 0, 1)
    for select in ("norms_biases", "all_masked"):
        rep.updated_params = None
        spec = rec_mod.RecoverSpec(select=select, steps=RECOVER_STEPS,
                                   lr=FAMILY_RECOVER_LR[select], seed=0)
        t0 = time.perf_counter()
        rr = ex.recover(spec)
        t_rec = time.perf_counter() - t0
        ce = rr.ce_history
        b0 = rec_mod._calib_batch_fn(cfg, spec, device)(0)
        with torch.no_grad():
            ce0 = float(api.loss(rr.params, b0, masks=rep.masks)[1]["ce"])
        require(rr.steps_run == RECOVER_STEPS and not rr.diverged
                and all(math.isfinite(c) for c in ce) and ce0 < ce[0],
                f"{tag}: {select} recovery CE not finite and falling: {ce}; "
                f"step 0's batch {ce0} after")
        notes = ""
        if select == "all_masked":
            flat = dict(rec_mod._flat_leaves(rr.params))
            for site, m in rec_mod._flat_leaves(rep.masks):
                require(not bool(flat[site][m == 0].any()),
                        f"{tag} {site}: a pruned weight is nonzero after "
                        "recovery")
            notes = "; pruned coordinates 0.0 in the weights"
            del flat
        ppl = pruning.evaluate(api, rr.params, masks=rep.masks, seed=0,
                               device=device)["perplexity"]
        sel = rec_mod.build_selection(trained, rep.masks, spec)
        rstep = rec_mod._make_step(api, rep.masks, sel, spec.opt_config())
        step_ms[select] = (event_ms(rstep, steps_lib.TrainState(
            sel.trainable, adamw.init(sel.trainable)), trained, batch)
            if cuda else float("nan"))
        del sel, rstep
        log(f"   ({tag}c) recover {select}: {t_rec:.2f} s, CE "
            f"{ce[0]:.4f} -> {ce[-1]:.4f} over {rr.steps_run} steps (step "
            f"0's batch {ce[0]:.4f} -> {ce0:.4f}), "
            f"trainable {rr.trainable_count} of {rr.total_count} "
            f"({100 * rr.trainable_frac:.4f}%), recovered ppl {ppl:.4f} "
            f"(pruned {pruned['perplexity']:.4f}), "
            f"step {step_ms[select]:.2f} ms{notes}")
        if recovered is None:
            recovered = rr.params
        del rr
    rep.updated_params = recovered
    if cuda:
        torch.cuda.empty_cache()

    # (d) serve the norms_biases recovery, gathered (every spmm launch of
    # this step is a gathered one: the masked engine runs none)
    s0 = ops.LAUNCHES["spmm"]
    prompt = synthetic.with_modality(synthetic.DataPipeline(
        synthetic.CorpusConfig(cfg.vocab_size), 4, 32, split="val",
        device=device).get(0), cfg, 0, 0)
    n_first = spmm_sites(cfg, trained, prefill=True)["spmm"]
    want_n = (n_first + (SERVE_GEN - 1) * spmm_sites(cfg, trained)["spmm"]
              if cuda else 0)
    want = ServeEngine(api, recovered, masks=rep.masks, fmt="gathered",
                       device=device)
    before = ops.LAUNCHES["spmm"]
    lt = want.logits_trace(prompt, SERVE_GEN)
    n = ops.LAUNCHES["spmm"] - before
    require(n == want_n, f"{tag}: a packed generate launched {n} spmm, want "
            f"{want_n}")
    if serve == "export":
        tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"))
        try:
            w0 = bytes_written()
            t0 = time.perf_counter()
            ex.export_packed(tmp / "export", "gathered")
            t_export = time.perf_counter() - t0
            exported.append(bytes_written() - w0)
            m2, p2 = packed.load_masks_and_weights(cfg, trained,
                                                   tmp / "export")
            via = ServeEngine(api, p2, masks=m2, fmt="gathered",
                              device=device)
            require(torch.equal(via.logits_trace(prompt, SERVE_GEN), lt)
                    and torch.equal(via.generate(prompt, SERVE_GEN).tokens,
                                    want.generate(prompt, SERVE_GEN).tokens),
                    f"{tag}: the export's greedy tokens or logits differ "
                    "from the in-process recovered model's")
            log(f"   ({tag}d) export_packed (gathered) {t_export:.2f} s, "
                f"{exported[-1] / 1e9:.3f} GB written; read back by "
                "load_masks_and_weights and served: greedy tokens and "
                "logits bitwise the in-process recovered model's; spmm "
                f"launches {n} a generate")
            del via, m2, p2
        finally:
            shutil.rmtree(tmp)
    masked = ServeEngine(api, recovered, masks=rep.masks, fmt="masked",
                         device=device)
    ref = masked.logits_trace(prompt, SERVE_GEN)
    toks = masked.generate(prompt, SERVE_GEN).tokens
    err = float((forced_logits(want, prompt, toks) - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"   ({tag}d) gathered vs masked (fed its tokens): {err / scale:.2e} "
        f"of max|logits| {scale:.3f}"
        + (f" (gated within {SERVE_TOL})" if serve == "in process" else "")
        + f"; spmm launches {n} a generate")
    if serve == "in process":
        require(math.isfinite(err) and err <= SERVE_TOL * scale,
                f"{tag}: gathered vs masked beyond {SERVE_TOL} of "
                "max|logits|")
    totals["spmm_gather"] += ops.LAUNCHES["spmm"] - s0
    del want, masked, ex, rep, recovered, trained
    if cuda:
        torch.cuda.empty_cache()
    log(f"   ({tag}) train step {train_ms:.2f} ms, recover steps "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in step_ms.items())
        + f"; peak memory train {peak_train:.2f} GiB, prune "
        f"{peak_prune:.2f} GiB; {smi}")
    return totals


MESH_RANKS = 2            # phase 4d (b): ranks sharing the one card over gloo
MESH_CALIB_BATCHES = 1    # 4d (b): calibration batches split over "data"
MESH_G_ROWS = 32          # 4d (b): w_down rows through the Gram-sharded refiner
MESH_JOIN_S = 300         # 4d (b): the ranks' time limit
# 4d (b): the Gram budget of the (1, 2) run: below w_down's 0.82 GB fp32 G
# (14336 wide), above the 4096-wide taps' 64 MiB
MESH_GRAM_BUDGET = 512 * 2**20
MESH_RECOVER_STEPS = 4    # 9d (b): the (2, 1) norms_biases recovery
MESH_RTOL = 1e-5          # 9d (b): a data-split step's fp32 sums reordered


def gram_gap(got: dict, want: dict, tokens: int) -> float:
    """The largest |G - G'| / max|G'| over two tap trees' Gram leaves, held
    to the Gram's tolerance at ``tokens`` summed tokens (1e-5 of max|G| at
    T <= 512, growing as sqrt(T / 512) past it)."""
    import torch

    worst = 0.0
    for k in sorted(want):
        if isinstance(want[k], dict):
            worst = max(worst, gram_gap(got[k], want[k], tokens))
        elif k == "g":
            ref = want[k].float()
            gap = float((got[k].float() - ref).abs().max() / ref.abs().max())
            worst = max(worst, gap)
    tol = 1e-5 * max(1.0, tokens / 512) ** 0.5
    require(worst <= tol, f"mesh Grams off by {worst:.3g} of max|G| "
                          f"(tolerance {tol:.3g})")
    return worst


def mesh_one_rank(api, params, batches, taps, pattern, digest60: str,
                  cand, store: Path, device: str = "cuda") -> dict:
    """Phase 4d (a): this process as a one-rank NCCL world on a file://
    store, the (1, 1) host mesh. prune_model(mesh=) at PerRow(0.6) from
    phase 4's Grams must give phase 4's masks (digest) and at 2:4 the
    single-device masks; accumulate_stats(mesh=) the single-device Grams;
    the rows-sharded refiner with the candidate commit (swap_commit) on
    layer 0's w_down phase 5's candidate run (``cand``: its mask and
    losses on the host), bitwise. Returns the launches of the mesh runs and
    their times."""
    import torch
    import torch.distributed as dist
    from repro_torch import pruning
    from repro_torch.core import masks
    from repro_torch.core.warmstart import warmstart_mask
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.pruning import distributed

    mesh_lib.init_distributed(device, init_method=f"file://{store}",
                              rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh()
        log(f"   (a) {mesh}, backend {dist.get_backend()}")
        ops.reset_launches()
        t0 = time.perf_counter()
        rep = pruning.prune_model(api, params, None, pattern, t_max=T_MAX,
                                  taps=taps, mesh=mesh)
        sync(device == "cuda")
        t60 = time.perf_counter() - t0
        paths = {g.engine_path for g in rep.plan.groups}
        got = digest(mask_leaves(rep.masks))
        require(paths == {"rows-sharded"}, f"4d (a) engine paths {paths}")
        require(got == digest60, f"4d (a): mesh PerRow(0.6) masks {got}, "
                                 f"phase 4's {digest60}")
        log(f"   (a) prune_model(mesh) PerRow(0.6): {t60:.2f} s (phase 4's "
            f"single-device run above), masks digest {got} == phase 4's")
        nm = masks.NM(2, 4)
        t0 = time.perf_counter()
        rep24 = pruning.prune_model(api, params, None, nm, t_max=T_MAX,
                                    taps=taps, mesh=mesh)
        sync(device == "cuda")
        t24 = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        one = pruning.prune_model(api, params, None, nm, t_max=T_MAX,
                                  taps=taps)
        d24, want24 = (digest(mask_leaves(r.masks)) for r in (rep24, one))
        require(d24 == want24, f"4d (a): mesh 2:4 masks {d24}, single "
                               f"device {want24}")
        log(f"   (a) prune_model(mesh) 2:4: {t24:.2f} s, masks digest {d24}"
            f" == the single-device run's")
        ops.reset_launches()
        t0 = time.perf_counter()
        st = pruning.accumulate_stats(api, params, batches, mesh=mesh)
        sync(device == "cuda")
        t_cal = time.perf_counter() - t0
        gap = gram_gap(st.full_taps(), taps, 512 * len(batches))
        log(f"   (a) accumulate_stats(mesh): {t_cal:.2f} s, Grams within "
            f"{gap:.3g} of max|G| of phase 5's")
        del st
        W = params["layers"]["mlp"]["w_down"][0]
        G = taps["w_down"]["g"][0]
        m0 = warmstart_mask(W.float(), G, pattern, "wanda")
        t0 = time.perf_counter()
        m, _, l1 = distributed.refine_rows_sharded(
            W, G, m0, pattern, mesh, t_max=T_MAX, k_swaps=8,
            commit_mode="candidates")
        sync(device == "cuda")
        t_c = time.perf_counter() - t0
        require(torch.equal(m.cpu(), cand[0])
                and torch.equal(l1.cpu(), cand[1]),
                "4d (a): the rows-sharded candidate refine differs from "
                "phase 5's")
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        log(f"   (a) refine_rows_sharded(candidates) on w_down: {t_c:.2f} s,"
            f" masks and losses bitwise phase 5's candidate run")
        log(f"   (a) launches {launches}")
        return {"launches": launches, "prune_s": t60}
    finally:
        dist.destroy_process_group()


def magnitude_masks(cfg, params, pattern) -> dict:
    """|W| masks under ``pattern`` for every prunable site, as the masks
    tree ``loss`` takes (phase 9d (b)'s recovery: the masks need no
    calibration)."""
    from repro_torch.core import masks
    from repro_torch.pruning import sites

    import torch

    tree = {}
    for _, ppath, _, n_stack in sites._table(cfg):
        w = sites._get(params, ppath)
        flat = w.reshape(-1, *w.shape[n_stack:]).float().abs()
        m = torch.stack([masks.make_mask(x, pattern) for x in flat])
        node = tree
        for k in ppath[:-1]:
            node = node.setdefault(k, {})
        node[ppath[-1]] = m.reshape(w.shape)
    return tree


def gram_regime_rank(rank: int, api, params, batches, taps, pattern,
                     device: str) -> dict:
    """Phase 4d (b) on the (1, 2) ("data", "model") mesh: calibration
    splits every Gram's columns over "model"; w_down's first MESH_G_ROWS
    rows refine through the engine in the Gram regime (its 0.82 GB G past
    MESH_GRAM_BUDGET) on this rank's (14336, 7168) calibration shard, at
    k = 1 and 8, against one device's run of the same column split, with
    this rank's peak memory during the group beside the plan's reckoning."""
    import torch
    from repro_torch import pruning
    from repro_torch.core import sparseswaps
    from repro_torch.core.warmstart import warmstart_mask
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.pruning import distributed, engine
    from repro_torch.pruning import sites as sites_lib

    cuda = device == "cuda"
    mesh = mesh_lib.make_host_mesh(data=1, model=MESH_RANKS)
    sync(cuda)
    t0 = time.perf_counter()
    st = pruning.accumulate_stats(api, params, batches, mesh=mesh)
    sync(cuda)
    res = {"calib_s": time.perf_counter() - t0,
           "launches": dict(ops.LAUNCHES)}
    ent = st.gram_block(("w_down",), mesh)
    G = taps["w_down"]["g"][0]
    d, cols = G.shape[0], ent["g"].shape[-1]
    res["block"] = list(ent["g"].shape)
    # the rank's calibration shard is the single-device Gram's columns
    # (one rank of "data": each rank runs every batch whole)
    res["shard_equal"] = all(
        bool(torch.equal(ent["g"][i], taps["w_down"]["g"][i][
            :, rank * cols:(rank + 1) * cols]))
        for i in range(ent["g"].shape[0]))
    plan = pruning.plan_pruning(
        api, api.init(device="meta"),
        pruning.PruneRecipe.single(pattern, t_max=T_MAX), mesh=mesh,
        gram_budget_bytes=MESH_GRAM_BUDGET)
    paths = {g.name: g.engine_path for g in plan.groups}
    res["paths"] = paths
    reckon = plan.refine_costs()["layers.mlp.w_down"]
    res["reckoning"] = reckon
    res["reckoning_rows"] = distributed.refine_bytes(
        "gram", MESH_G_ROWS, d, mesh)["total"]
    W = params["layers"]["mlp"]["w_down"][0][:MESH_G_ROWS]
    group = sites_lib.SiteGroup(
        name="layers.mlp.w_down", weights=W[None],
        gram=sites_lib._gram_batch({k: v[:1] for k, v in ent.items()}),
        mask_path=("layers", "mlp", "w_down"), stack_shape=(1,))
    m0 = warmstart_mask(W.float(), G, pattern, "wanda")
    for k in (1, 8):
        ctx = engine.RefineContext(t_max=T_MAX, k_swaps=k, mesh=mesh,
                                   gram_budget_bytes=MESH_GRAM_BUDGET)
        sync(cuda)
        base = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = engine.refine_group("sparseswaps", group, pattern, ctx)
        sync(cuda)
        t_g = time.perf_counter() - t0
        # the group's bytes: what it allocated at its peak, and the block
        # it reads where calibration left it
        peak = ((torch.cuda.max_memory_allocated() - base) if cuda
                else 0) + d * cols * 4
        m, l1 = out.masks[0], out.loss_final[0]
        one = distributed.refine_split_single(
            W, G, m0, pattern, n_cols=MESH_RANKS, t_max=T_MAX, k_swaps=k)
        whole = sparseswaps.refine(W, G, m0, pattern, t_max=T_MAX,
                                   k_swaps=k)
        res[f"gram_k{k}"] = {
            "s": t_g, "swaps": int((m - m0).abs().sum()) // 2,
            "masks_equal": bool(torch.equal(m, one[0])),
            "losses_equal": bool(torch.equal(l1, one[2])),
            "all_columns_masks_equal": bool(torch.equal(m, whole.mask)),
            "peak": peak, "digest": digest([m > 0.5])}
    del st, ent, group
    return res


def mesh_train_rank(rank: int, root: str, mesh21, mesh12, device: str,
                    tiny: bool) -> dict:
    """Phase 9d (b): phase 9's configuration (llama31-8b's widths, depth
    P9_LAYERS, vocabulary P9_VOCAB) on the two ranks: a (1, 2) train step
    against one device's, bitwise; a (2, 1) norms_biases recovery within
    MESH_RTOL of one device's in float32 (in bf16 the gap is printed);
    its (2, 1) checkpoint, and the (2, 1) shards of the layer stack,
    restored on one device bitwise."""
    import torch
    from repro_torch import ckpt, configs, models, pruning
    from repro_torch.core import masks
    from repro_torch.data import synthetic
    from repro_torch.dist import placement
    from repro_torch.dist import specs as specs_lib
    from repro_torch.optim import adamw
    from repro_torch.pruning.recover import build_selection
    from repro_torch.train import steps

    cuda = device == "cuda"
    dev = torch.device(device)
    base = (configs.get_tiny("llama31-8b") if tiny
            else configs.get("llama31-8b"))
    cfg = base.replace(name=f"{base.name}-L{P9_LAYERS}-V{P9_VOCAB}",
                       n_layers=P9_LAYERS,
                       vocab_size=min(P9_VOCAB, base.vocab_size))
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    batch = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                   4, 128, split="train",
                                   device=dev).get(0)
    opt = adamw.AdamWConfig()
    res = {}
    # (1, 2): one step, the state sharded over "model"
    one, om = steps.train_step_fn(api, opt)(
        steps.TrainState(params, adamw.init(params)), batch)
    layout = steps.state_layout(api, mesh12)
    state = steps.shard_state(steps.TrainState(params, adamw.init(params)),
                              layout)
    fn = steps.train_step_fn(api, opt, mesh=mesh12)
    sync(cuda)
    t0 = time.perf_counter()
    state, m = fn(state, batch)
    sync(cuda)
    res["step12_s"] = time.perf_counter() - t0
    want = placement.shard(one, layout.specs, mesh12)
    got_l, want_l = adamw.tree_leaves(state.params), adamw.tree_leaves(
        want.params)
    res["step12_equal"] = (
        float(m["loss"]) == float(om["loss"])
        and all(torch.equal(a, b) for a, b in zip(got_l, want_l))
        and all(torch.equal(a, b) for a, b in zip(
            adamw.tree_leaves(state.opt.m), adamw.tree_leaves(want.opt.m))))
    res["step12_loss"] = float(m["loss"])
    res["state_bytes"] = (
        sum(t.numel() * t.element_size() for t in got_l
            + adamw.tree_leaves(state.opt.m) + adamw.tree_leaves(state.opt.v))
        + 4, placement.bytes_per_rank(steps.abstract_state(api),
                                      layout.specs, mesh12))
    del one, state, want, got_l, want_l
    # (2, 1): norms_biases recovery, its batches split over "data": in
    # float32 held to one device within MESH_RTOL (the split reorders
    # fp32 sums); in bf16, phase 9's dtype, the gap printed (the halves'
    # bf16 products round by their row count on the card)
    spec = pruning.RecoverSpec(select="norms_biases",
                               steps=MESH_RECOVER_STEPS, batch_size=4,
                               seq_len=128, seed=0)
    rdir = Path(root) / "rec21"
    for dtype in ("float32", "bfloat16"):
        a32 = models.build(cfg.replace(dtype=dtype))
        p32 = a32.init(seed=0, device=dev)
        msk = magnitude_masks(cfg, p32, masks.PerRow(0.6))
        single = pruning.recover(a32, p32, msk, spec)
        gated = dtype == "float32"
        sync(cuda)
        t0 = time.perf_counter()
        rec = pruning.recover(a32, p32, msk, spec, mesh=mesh21,
                              **({"ckpt_dir": rdir, "checkpoint_every": 2}
                                 if gated else {}))
        sync(cuda)
        worst, off = 0.0, 0
        for (_, a), (_, b) in zip(sorted(rec.trainable.items()),
                                  sorted(single.trainable.items())):
            gap = (a.float() - b.float()).abs()
            worst = max(worst, float(gap.max()))
            off += int((gap > 1e-6 + MESH_RTOL * b.float().abs()).sum())
        res[f"recover21_{dtype}"] = {
            "s": time.perf_counter() - t0, "max_abs": worst, "off": off,
            "n": sum(t.numel() for t in rec.trainable.values()),
            "ce": rec.ce_history, "ce_one": single.ce_history}
        if gated:
            kept = (a32, p32, msk, rec)
        del a32, p32, msk, single, rec
    api32, params32, msk, rec = kept
    sel = build_selection(params32, msk, spec)
    like = placement.like(steps.TrainState(sel.trainable,
                                           adamw.init(sel.trainable)))
    back, _ = ckpt.restore_like(rdir / "recover", MESH_RECOVER_STEPS, like,
                                device=dev)
    res["recover21_ckpt_equal"] = all(
        torch.equal(back.params[k], rec.trainable[k]) for k in rec.trainable)
    del api32, params32, msk, rec, kept, sel, back
    # the layer stack (2, 1)-sharded, written, and read on one device
    tree = {"layers": params["layers"]}
    lay = placement.Layout(specs_lib.param_pspecs(cfg, tree, mesh21), mesh21)
    t0 = time.perf_counter()
    ckpt.save(Path(root) / "layers21", 0,
              placement.shard(tree, lay.specs, mesh21), shardings=lay)
    res["layers21_save_s"] = time.perf_counter() - t0
    back, man = ckpt.restore_like(Path(root) / "layers21", 0, tree,
                                  device=dev)
    res["layers21_equal"] = all(
        torch.equal(a, b) for a, b in zip(adamw.tree_leaves(back),
                                          adamw.tree_leaves(tree)))
    res["layers21_shards"] = sorted({len(e["shards"])
                                     for e in man["leaves"]})
    return res


def mesh_rank(rank: int, root: str, device: str = "cuda",
              tiny: bool = False) -> None:
    """Phase 4d (b), one of MESH_RANKS processes sharing the card over gloo
    (NCCL refuses two ranks on one device): on the (2, 1) mesh
    calibration split over "data" against the single-device Grams and
    prune_model(mesh=) at PerRow(0.6) from the single-device Grams; on
    (1, 2) the Gram-sharded w_down on its calibration shard
    (``gram_regime_rank``); then phase 9d (b) (``mesh_train_rank``).
    Results (or the traceback) to ``root/rank<r>.json``."""
    out = Path(root) / f"rank{rank}.json"
    try:
        sys.path.insert(0, str(SRC))
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch import configs, models, pruning
        from repro_torch.core import masks
        from repro_torch.kernels import ops
        from repro_torch.launch import mesh as mesh_lib

        res = {}
        mesh_lib.init_distributed(device, backend="gloo",
                                  init_method=f"file://{root}/store",
                                  rank=rank, world_size=MESH_RANKS)
        mesh = mesh_lib.make_host_mesh()
        dev = torch.device(device)
        cfg = (configs.get_tiny("llama31-8b") if tiny
               else configs.get("llama31-8b").replace(n_layers=2))
        api = models.build(cfg)
        params = api.init(seed=0, device=dev)
        batches = list(pruning.calibration_batches(
            cfg, n_samples=16, seq_len=128, batch_size=4, seed=0,
            device=dev))
        pattern = masks.PerRow(0.6)
        # the single-device Grams, made here as phase 4 made them (their
        # 2.4 GB would not fit the run's write budget as a file): held to
        # phase 5's by digest
        taps = pruning.accumulate(api, params, batches)
        res["taps_digest"] = digest(_leaves_of(taps))
        first = pruning.accumulate(api, params, batches[:MESH_CALIB_BATCHES])
        ops.reset_launches()
        sync(device == "cuda")
        t0 = time.perf_counter()
        st = pruning.accumulate_stats(api, params,
                                      batches[:MESH_CALIB_BATCHES],
                                      mesh=mesh)
        sync(device == "cuda")
        res["calib_s"] = time.perf_counter() - t0
        res["gram_gap"] = gram_gap(st.full_taps(), first,
                                   512 * MESH_CALIB_BATCHES)
        del st, first
        sync(device == "cuda")
        t0 = time.perf_counter()
        rep = pruning.prune_model(api, params, None, pattern, t_max=T_MAX,
                                  taps=taps, mesh=mesh)
        sync(device == "cuda")
        res["prune_s"] = time.perf_counter() - t0
        res["launches"] = dict(ops.LAUNCHES)
        res["digest60"] = digest(mask_leaves(rep.masks))
        del rep
        ops.reset_launches()
        res["gram"] = gram_regime_rank(rank, api, params, batches, taps,
                                       pattern, device)
        del taps, params, batches
        if device == "cuda":
            torch.cuda.empty_cache()
        res["train"] = mesh_train_rank(
            rank, root, mesh, mesh_lib.make_host_mesh(data=1,
                                                      model=MESH_RANKS),
            device, tiny)
        out.write_text(json.dumps(res))
        torch.distributed.destroy_process_group()
    except Exception:
        import traceback

        # the traceback for the parent's failure message, then raised
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise


def _leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    return [tree]


def mesh_two_ranks(digest60: str, taps_digest: str, device: str = "cuda",
                   tiny: bool = False) -> dict:
    """Phase 4d (b) and 9d (b): MESH_RANKS spawned ranks on the card over
    gloo. On (2, 1) each must find the single-device Grams of phase 5,
    calibration Grams within tolerance and phase 4's masks; on (1, 2) its
    calibration shard of w_down's Gram bitwise the single-device Gram's
    columns, the Gram-sharded refine bitwise one device's run of the same
    column split at k = 1 and 8, and its peak under the plan's per-rank
    reckoning; and 9d (b)'s gates (``mesh_train_rank``). Returns the
    ranks' launches summed and per rank, and their times."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_4d_") as root:
        procs = [ctx.Process(target=mesh_rank, args=(r, root, device, tiny))
                 for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, MESH_JOIN_S - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        wall = time.perf_counter() - t0
        errs = [Path(root, f"rank{r}.err") for r in range(MESH_RANKS)]
        errs = [e.read_text() for e in errs if e.exists()]
        codes = [p.exitcode for p in procs]
        require(not errs and codes == [0] * MESH_RANKS,
                f"4d (b): exit codes {codes}\n" + "\n".join(errs))
        res = [json.loads(Path(root, f"rank{r}.json").read_text())
               for r in range(MESH_RANKS)]
        # every file the ranks wrote is still there (no checkpoint was
        # superseded): their stores, checkpoints and JSON
        written = sum(f.stat().st_size for f in Path(root).rglob("*")
                      if f.is_file())
    CHILD_WRITES[0] += written
    for r, x in enumerate(res):
        require(x["taps_digest"] == taps_digest,
                f"4d (b) rank {r}: its single-device Grams are not phase "
                f"5's ({x['taps_digest']} vs {taps_digest})")
        require(x["digest60"] == digest60,
                f"4d (b) rank {r}: mesh PerRow(0.6) masks {x['digest60']}, "
                f"phase 4's {digest60}")
        log(f"   (b) rank {r}, (2, 1): calibration over data "
            f"({MESH_CALIB_BATCHES} batches) {x['calib_s']:.2f} s, Grams "
            f"within {x['gram_gap']:.3g} of max|G|; prune_model(mesh) "
            f"{x['prune_s']:.2f} s, masks digest {x['digest60']} == phase "
            f"4's; launches {x['launches']}")
        g = x["gram"]
        require(g["paths"]["layers.mlp.w_down"] == "gram-sharded"
                and g["shard_equal"],
                f"4d (b) rank {r}, (1, 2): w_down {g['paths']}, its "
                f"calibration shard bitwise the Gram's columns: "
                f"{g['shard_equal']}")
        total = g["reckoning"]["total"]
        for k in (1, 8):
            gk = g[f"gram_k{k}"]
            require(gk["masks_equal"] and gk["losses_equal"] and gk["swaps"],
                    f"4d (b) rank {r}: Gram-sharded refine at k = {k}: {gk}")
            # the reckoning at the rows refined here, and below what a
            # rank holding w_down's G whole beside its block would take
            whole_g = 4 * g["block"][-2] ** 2 + 4 * g["block"][-2] * g[
                "block"][-1]
            require(gk["peak"] <= min(total, g["reckoning_rows"])
                    and gk["peak"] < whole_g,
                    f"4d (b) rank {r}: the Gram-sharded group's peak "
                    f"{gk['peak'] / 1e9:.3f} GB is over the plan's "
                    f"reckoning {total / 1e9:.3f} GB, its reckoning at "
                    f"{MESH_G_ROWS} rows {g['reckoning_rows'] / 1e9:.3f} "
                    f"GB, or G whole and the block {whole_g / 1e9:.3f} GB")
        log(f"   (b) rank {r}, (1, 2): calibration (16 batches, Grams over "
            f"\"model\") {g['calib_s']:.2f} s, w_down's block "
            f"{g['block']} bitwise the Gram's columns; Gram-sharded "
            f"w_down[:{MESH_G_ROWS}] through the engine k=1 "
            f"{g['gram_k1']['s']:.2f} s ({g['gram_k1']['swaps']} swaps, "
            f"digest {g['gram_k1']['digest']}), k=8 "
            f"{g['gram_k8']['s']:.2f} s ({g['gram_k8']['swaps']} swaps, "
            f"digest {g['gram_k8']['digest']}), bitwise one device's run "
            f"of the same column split (the all-columns carry's masks "
            f"equal: k=1 {g['gram_k1']['all_columns_masks_equal']}, k=8 "
            f"{g['gram_k8']['all_columns_masks_equal']}); peak during the "
            f"group k=1 {g['gram_k1']['peak'] / 1e9:.3f} GB, k=8 "
            f"{g['gram_k8']['peak'] / 1e9:.3f} GB, under the plan's "
            f"per-rank reckoning {total / 1e9:.3f} GB (G block "
            f"{g['reckoning']['gram'] / 1e9:.3f} GB, w_down's whole G "
            f"{g['block'][-2] ** 2 * 4 / 1e9:.3f}; at {MESH_G_ROWS} rows "
            f"{g['reckoning_rows'] / 1e9:.3f} GB); launches "
            f"{g['launches']}")
        t = x["train"]
        rec, rbf = t["recover21_float32"], t["recover21_bfloat16"]
        require(t["step12_equal"],
                f"9d (b) rank {r}: the (1, 2) train step differs from one "
                "device's")
        require(t["state_bytes"][0] == t["state_bytes"][1],
                f"9d (b) rank {r}: state bytes {t['state_bytes']}")
        require(rec["off"] <= 1e-3 * rec["n"]
                and rec["max_abs"] <= 1e-3 * MESH_RECOVER_STEPS
                and all(math.isclose(a, b, rel_tol=MESH_RTOL)
                        for a, b in zip(rec["ce"], rec["ce_one"])),
                f"9d (b) rank {r}: the float32 (2, 1) recovery is off one "
                f"device's: {rec}")
        require(t["recover21_ckpt_equal"] and t["layers21_equal"],
                f"9d (b) rank {r}: a (2, 1) checkpoint read on one device "
                "differs")
        log(f"   (9d b) rank {r}: (1, 2) train step {t['step12_s']:.2f} s, "
            f"loss {t['step12_loss']:.4f}, params and moments bitwise one "
            f"device's, {t['state_bytes'][0] / 1e9:.3f} GB of state a rank "
            f"== the reckoning; (2, 1) norms_biases recovery "
            f"{MESH_RECOVER_STEPS} steps in float32 {rec['s']:.2f} s, CE "
            f"{[round(c, 6) for c in rec['ce']]} (one device "
            f"{[round(c, 6) for c in rec['ce_one']]}), {rec['off']} of "
            f"{rec['n']} trained entries past 1e-6 + {MESH_RTOL}·|one "
            f"device's| (max |diff| {rec['max_abs']:.3g}); in bf16 (not "
            f"gated) {rbf['s']:.2f} s, CE {[round(c, 4) for c in rbf['ce']]}"
            f" (one device {[round(c, 4) for c in rbf['ce_one']]}), "
            f"{rbf['off']} entries past it (max |diff| "
            f"{rbf['max_abs']:.3g}); its float32 step-"
            f"{MESH_RECOVER_STEPS} checkpoint and the (2, 1) layer stack "
            f"(shards a leaf {t['layers21_shards']}, saved in "
            f"{t['layers21_save_s']:.2f} s) read on one device bitwise")
    log(f"   (b) {MESH_RANKS} ranks over gloo: {wall:.2f} s wall, spawn "
        f"included, {written / 1e9:.3f} GB of files written")
    per_rank = [{k: x["launches"][k] + x["gram"]["launches"][k]
                 for k in x["launches"]} for x in res]
    launches = {k: sum(x[k] for x in per_rank) for k in per_rank[0]}
    return {"launches": launches, "per_rank": per_rank,
            "per_rank_21": [x["launches"] for x in res],
            "per_rank_12": [x["gram"]["launches"] for x in res],
            "prune_s": max(x["prune_s"] for x in res)}


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import configs, models, pruning
    from repro_torch.core import masks, sparseswaps, swap_math as sm
    from repro_torch.core.warmstart import warmstart_mask
    from repro_torch.kernels import build, ops
    from repro_torch.launch import profile_swap

    t_start = time.perf_counter()
    with Phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        log(f"   torch {torch.__version__} cuda {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("   TF32 off for matmuls and cuDNN")

    with Phase("2 build"):
        libs = sorted({v[0] for v in KERNELS.values()})
        build.build(libs)
        for lib in libs:
            log(f"   {lib} ({build.lib_path(lib).name}):")
            for line in build.ptxas_report(lib).splitlines():
                log(f"     {line}")

    results = {}
    with Phase("3 kernel checks at main-path shapes"):
        check_gram(512, 4096)
        results["gram_xtx"] = check_gram(512, 14336)["bf16"]
        clock = profile_swap.sm_clock_mhz()
        for R, d, seed in profile_swap.SHAPES:
            w, m, c, G = profile_swap.problem(R, d, seed)
            tag = f"R={R} d={d}"
            w_down = (R, d) == profile_swap.SHAPES[-1][:2]
            names = ("swap_topk", "swap_argmin")
            res = check_swaps(w, m, c, G, 8, tag, names=names, timed=names,
                              clock_mhz=clock, rows=plain_rows(R))
            ratio = res["swap_argmin"]["ms"] / res["swap_topk"]["ms"]
            log(f"   swap_argmin {tag}: {ratio:.3f}x swap_topk's time")
            commit = check_commit(w, m, c, G, 8, tag)
            if w_down:
                results.update(res)
                results["swap_commit"] = commit
            del w, m, c, G
        # T = 1 and 64: a one-row decode bucket and a chunked-prefill
        # window of the continuous scheduler (phase 6c)
        spmm_res = check_spmm(14336, 4096, "silu", "w_gate", extra_T=(1, 64))
        spmm_res.update({(T, f"{fmt} w_down"): r for (T, fmt), r in
                         check_spmm(4096, 14336, None, "w_down").items()})
        check_spmm(4096, 4096, None, "wq/wo", time_it=False)
        check_spmm(1024, 4096, None, "wk/wv", time_it=False)
        results["spmm"] = spmm_res[(128, "nm24")]
        results["spmm_gather"] = spmm_res[(4, "gathered")]
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    cfg = configs.get("llama31-8b").replace(n_layers=2)
    log(f"   config: {cfg.name} full width, n_layers {cfg.n_layers} "
        f"(reduced from 32), {cfg.dtype}")
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    pattern = masks.PerRow(0.6)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))

    with Phase("4 main path: prune_model + perplexity"):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = pruning.prune_model(api, params, batches, pattern,
                                     warmstart="wanda", method="sparseswaps",
                                     t_max=T_MAX)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = pruning.evaluate(api, params, seed=0, device=dev)
        pruned = pruning.evaluate(api, params, masks=report.masks, seed=0,
                                  device=dev)
        t_eval = time.perf_counter() - t0
        main_launches = dict(ops.LAUNCHES)
        log(report.summary())
        log(f"   prune_model {t_prune:.2f} s, evaluation {t_eval:.2f} s, "
            f"max memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"   dense  ppl {dense['perplexity']:.4f} acc {dense['accuracy']:.4f}")
        log(f"   pruned ppl {pruned['perplexity']:.4f} acc {pruned['accuracy']:.4f}")
        log(f"   launches {main_launches}")
        digest60 = digest(mask_leaves(report.masks))
        log(f"   masks digest {digest60}")
        check_pruned(api, params, report, main_launches, len(batches),
                     pattern, dense, pruned)

    with Phase("5 second path: refine on layer 0 w_down (k=1, candidates)"):
        taps = pruning.accumulate(api, params, batches)
        G = taps["w_down"]["g"][0]
        W = params["layers"]["mlp"]["w_down"][0]
        m0 = warmstart_mask(W.float(), G, pattern, "wanda")
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sparseswaps.count_search_passes() as cnt:
            res = sparseswaps.refine(W, G, m0, pattern, k_swaps=1, t_max=2)
        torch.cuda.synchronize()
        t_k1 = time.perf_counter() - t0
        argmin_launches = ops.LAUNCHES["swap_argmin"]
        check_refined(W, G, res, pattern, "k=1")
        log(f"   k=1: passes {cnt.passes}, swaps {int(res.swaps.sum())}, "
            f"error reduction {100*float(res.error_reduction.mean()):.3f}%, "
            f"swap_argmin launches {argmin_launches}, {t_k1:.3f} s; "
            f"digest of masks, swaps, losses "
            f"{digest([res.mask > 0.5, res.swaps, res.loss_final])}")
        require(argmin_launches > 0, "the k=1 path did not launch swap_argmin")

        # eps = 0 keeps every row searching through t_max = 4 passes at
        # this width, so compaction gathers nothing; at eps = -(30th
        # percentile of the rows' best first-pass ΔL) ~70% of the rows
        # accept nothing in pass 1 and sit at a fixed point from then on,
        # so compact_every=1 runs later passes on a gathered working set
        # with pad slots.
        c0, _ = sparseswaps._init_carry(W.float(), m0, G)
        best = ops.swap_topk(W.float(), m0, c0, G, k=1)[0][:, 0]
        eps_fix = float(-torch.quantile(best, 0.3))
        del c0, best
        require(eps_fix > 0, "the rows' best first-pass swaps do not improve")
        log(f"   the calibration Gram's {ops.gram_facts(G)}")
        runs = {}
        commit_launches = 0
        for eps, every in ((0.0, 0), (0.0, 2), (eps_fix, 0), (eps_fix, 1)):
            tag = f"candidates eps={eps:.6g} compact_every={every}"
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sparseswaps.count_search_passes() as cnt:
                r = sparseswaps.refine(W, G, m0, pattern, k_swaps=8,
                                       commit_mode="candidates", t_max=T_MAX,
                                       eps=eps, compact_every=every)
            torch.cuda.synchronize()
            runs[eps, every] = (r, cnt, time.perf_counter() - t0,
                                dict(ops.LAUNCHES))
            check_refined(W, G, r, pattern, tag)
            log(f"   {tag}: passes {cnt.passes}, rows scored "
                f"{cnt.rows_scored}, swaps {int(r.swaps.sum())}, error "
                f"reduction {100*float(r.error_reduction.mean()):.3f}%, "
                f"{runs[eps, every][2]:.3f} s, launches "
                f"{runs[eps, every][3]}; digest of masks, swaps, losses "
                f"{digest([r.mask > 0.5, r.swaps, r.loss_final])}")
            require(runs[eps, every][3]["swap_commit"] == cnt.passes > 0,
                    "swap_commit did not launch once per search pass")
            commit_launches += runs[eps, every][3]["swap_commit"]
        for eps, every in ((0.0, 2), (eps_fix, 1)):
            (a, ca, _, _), (b, cb, _, _) = runs[eps, 0], runs[eps, every]
            require(torch.equal(a.mask, b.mask)
                    and torch.equal(a.swaps, b.swaps)
                    and torch.equal(a.loss_final, b.loss_final),
                    f"compaction changed the masks, swaps or losses "
                    f"(eps={eps:.6g})")
            require(cb.rows_scored <= ca.rows_scored,
                    "compaction scored more rows")
            log(f"   compaction eps={eps:.6g} compact_every={every}: masks, "
                f"swaps and losses bitwise equal; rows scored "
                f"{ca.rows_scored} -> {cb.rows_scored}")
        require(runs[eps_fix, 1][1].rows_scored
                < runs[eps_fix, 0][1].rows_scored,
                "no row left the working set at eps > 0")
        kern = sparseswaps.refine(W[:256], G, m0[:256], pattern, k_swaps=8,
                                  commit_mode="candidates", t_max=T_MAX,
                                  method="kernel")
        plain = sparseswaps.refine(W[:256], G, m0[:256], pattern, k_swaps=8,
                                   commit_mode="candidates", t_max=T_MAX,
                                   method="chunked", chunk=128)
        require(torch.equal(kern.mask, plain.mask)
                and torch.equal(kern.swaps, plain.swaps),
                "kernel and plain candidate refinement disagree (256 rows)")
        log(f"   256 rows: kernel path == plain chunked path "
            f"({int(kern.swaps.sum())} swaps, {kern.iters} passes)")
        del G, W

    # phase 4d, run last, holds the mesh path to these: phase 4's masks
    # digest, phase 5's Grams (by digest) and its candidate run on w_down
    taps_digest = digest(_leaves_of(taps))
    cand, cand_l = runs[0.0, 0][0], runs[0.0, 0][3]
    cand = (cand.mask.cpu(), cand.loss_final.cpu())
    del taps

    with Phase("6 serve path: dense / masked / nm24 / gathered"):
        from repro_torch.data import synthetic

        rep24 = pruning.prune_model(api, params, batches, masks.NM(2, 4),
                                    warmstart="wanda", method="none")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 32, split="val", device=dev)
        serve_launches = serve_path(api, params, report.masks, rep24.masks,
                                    pipe.get(0))
        log(f"   spmm launches {serve_launches}")
        # phase 6c runs last, on these masks (kept on the host meanwhile)
        masks_6c = [_tree_to(m, "cpu") for m in (report.masks, rep24.masks)]

    with Phase("7 recipe path: launch.prune with a mixed recipe, resume"):
        recipe_path(cfg)
    del params, report, rep24, batches, api
    torch.cuda.empty_cache()

    with Phase("3b kernel checks at the other dense configs' shapes"):
        other_shapes(clock)
    other = {name: other_config(name) for name in OTHER_DENSE}
    with Phase("3m kernel checks at the MoE experts' shapes: stacked Gram "
               "and spmm"):
        results.update(moe_shapes())
    # before the MoE phases: the profiler loses records late in a long
    # process (3z's timed spmm calls lost some after 6mc)
    with Phase("3z kernel checks at zamba2-7b's shapes: Gram, swap search "
               "and commit, spmm"):
        family_shapes(clock, ZAMBA_GRAM_DS, ZAMBA_SWAPS, ZAMBA_SPMM, 100)
    zamba = zamba_config()
    with Phase("3r kernel checks at rwkv6-1.6b's shapes: Gram, swap search "
               "and commit, spmm"):
        family_shapes(clock, RWKV_GRAM_DS, RWKV_SWAPS, RWKV_SPMM, 200)
    rwkv = rwkv_config()
    with Phase("3e kernel checks at seamless-m4t-medium's shapes: Gram, "
               "swap search and commit, spmm"):
        family_shapes(clock, SEAMLESS_GRAMS, SEAMLESS_SWAPS, SEAMLESS_SPMM,
                      300)
    seamless = xattn_config(SEAMLESS)
    with Phase("3v kernel checks at llama-3.2-vision-90b's shapes: Gram, "
               "swap search and commit, spmm"):
        family_shapes(clock, VLM_GRAMS, VLM_SWAPS, VLM_SPMM, 400)
    vlm = xattn_config(VLM)
    moe = {name: moe_config(name, serve=name == "mixtral-8x7b")
           for name in MOE}
    with Phase("8 full depth, shapes only: plan_pruning on the meta device"):
        full_depth_plans()
    with Phase("6c continuous serving: scheduler, chunked prefill, "
               "disaggregation, chaos, load"):
        api = models.build(cfg)
        params = api.init(seed=0, device=dev)      # phase 4's params
        cont_launches = continuous_path(api, params, *masks_6c)
        log(f"   spmm launches {cont_launches}")
        del api, params, masks_6c
    torch.cuda.empty_cache()
    with Phase("9 training and recovery: train, prune --from-ckpt, "
               "recover, export, serve the export; 9d (a) on a one-rank "
               "mesh"):
        cfg9 = cfg.replace(name=f"{cfg.name}-L{P9_LAYERS}-V{P9_VOCAB}",
                           n_layers=P9_LAYERS, vocab_size=P9_VOCAB)
        log(f"   config: {cfg9.name}: llama31-8b's layer widths, depth "
            f"{P9_LAYERS}, vocabulary {P9_VOCAB} (the write budget)")
        rec_launches = train_recover_path(cfg9, smi, mesh=True)
        log(f"   launches {rec_launches}")
    torch.cuda.empty_cache()
    with Phase("9m MoE training and recovery: train, prune --from-ckpt, "
               "recover all_masked and lora, export, serve the export"):
        moe9 = configs.get(MOE[1])
        cfg9m = moe9.replace(name=f"{moe9.name}-L{P9M_LAYERS}",
                             n_layers=P9M_LAYERS)
        log(f"   config: {cfg9m.name}: {moe9.name} at full width, its "
            f"vocabulary {moe9.vocab_size}, depth {P9M_LAYERS} (the write "
            f"budget); {cfg9m.n_params()} params")
        with SpmmCalls() as calls:
            moe_rec = train_recover_path(cfg9m, smi,
                                         recoveries=RECOVERIES_9M,
                                         deterministic=True, tag="9m")
        log(f"   launches {moe_rec}; spmm_stacked calls by (E, T, d_out, "
            f"d_in, format): {dict(sorted(calls.stacked.items()))}")
    fam_rec, exported = [], []
    for row in FAMILY_TRAIN:
        torch.cuda.empty_cache()
        where = ("from its export" if row["serve"] == "export"
                 else "in process")
        with Phase(f"{row['tag']} {row['name']} training and recovery: "
                   "train, prune, recover norms_biases and all_masked, "
                   f"serve the recovery {where}"):
            fam_rec.append(family_train_path(row, smi, exported=exported))
            log(f"   launches {fam_rec[-1]}")
    log(f"   9z / 9r / 9e exports: {sum(exported) / 2**30:.2f} GiB written")
    torch.cuda.empty_cache()
    # last: a process group (NCCL) and two spawned ranks in a long run
    # come after every profiled phase
    with Phase("4d mesh prune and 9d (b) mesh training: one rank over "
               "NCCL, two ranks on the card over gloo"):
        import tempfile

        api = models.build(cfg)
        params = api.init(seed=0, device=dev)      # phase 4's params
        batches = list(pruning.calibration_batches(
            cfg, n_samples=16, seq_len=128, batch_size=4, seed=0,
            device=dev))
        taps = pruning.accumulate(api, params, batches)
        require(digest(_leaves_of(taps)) == taps_digest,
                "4d: phase 5's Grams were not made again bitwise")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_4d_") as tmp:
            mesh_one = mesh_one_rank(api, params, batches, taps, pattern,
                                     digest60, cand, Path(tmp) / "store")
        n_batches = len(batches)
        del api, params, batches, taps
        torch.cuda.empty_cache()
        mesh_two = mesh_two_ranks(digest60, taps_digest)
        one_l = mesh_one["launches"]
        require(one_l["gram_xtx_bf16"] == main_launches["gram_xtx_bf16"]
                and one_l["swap_topk"] == (main_launches["swap_topk"]
                                           + cand_l["swap_topk"])
                and one_l["swap_commit"] == cand_l["swap_commit"],
                f"4d (a) launches {one_l}: not phase 4's Grams and "
                f"swap_topk with phase 5's candidate run's swap_topk and "
                f"swap_commit")
        # each rank runs the forward on its half of every batch (one Gram
        # a tap and batch) and refines its half of every instance's rows
        # (one swap_topk a pass, as phase 4's single-device run)
        per_rank = {"gram_xtx_bf16": main_launches["gram_xtx_bf16"]
                    * MESH_CALIB_BATCHES // n_batches,
                    "swap_topk": main_launches["swap_topk"]}
        for r, got in enumerate(mesh_two["per_rank_21"]):
            require(all(got[k] == v for k, v in per_rank.items()),
                    f"4d (b) rank {r} launches {got}, want {per_rank}")
        # (1, 2): each rank runs every batch whole (one Gram a tap and
        # batch); the Gram-sharded search is plain torch
        per_rank = {"gram_xtx_bf16": main_launches["gram_xtx_bf16"],
                    "swap_topk": 0}
        for r, got in enumerate(mesh_two["per_rank_12"]):
            require(all(got[k] == v for k, v in per_rank.items()),
                    f"4d (b) rank {r}, (1, 2): launches {got}, want "
                    f"{per_rank}")
        log(f"   prune_model PerRow(0.6): one device {t_prune:.2f} s "
            f"(phase 4), a one-rank mesh {mesh_one['prune_s']:.2f} s, "
            f"{MESH_RANKS} ranks sharing the card "
            f"{mesh_two['prune_s']:.2f} s (the slower rank); {smi}")

    runs = [(main_launches, serve_launches)] + [
        (o["prune"], o.get("serve"))
        for o in (*other.values(), *moe.values(), zamba, rwkv, seamless,
                  vlm)]
    served = [s for _, s in runs if s is not None]
    # the continuous runs (6c, 6mc) and the served exports (9, 9m)
    later = [cont_launches, rec_launches, moe_rec, *fam_rec] + [
        o["continuous"] for o in moe.values() if "continuous" in o]
    # phase 4d's mesh runs, their Grams on both input paths
    later += [dict(x, gram_xtx=x["gram_xtx"] + x["gram_xtx_bf16"])
              for x in (mesh_one["launches"], mesh_two["launches"])]
    more = lambda k: sum(x.get(k, 0) for x in later)  # noqa: E731
    launches = {"gram_xtx": sum(p["gram_xtx_bf16"] + p["gram_xtx"]
                                for p, _ in runs) + more("gram_xtx"),
                "gram_xtx_stacked": sum(p["gram_xtx_stacked_bf16"]
                                        + p["gram_xtx_stacked"]
                                        for p, _ in runs)
                + more("gram_xtx_stacked"),
                "swap_topk": sum(p["swap_topk"] for p, _ in runs)
                + more("swap_topk"),
                "swap_argmin": argmin_launches,
                "swap_commit": commit_launches + sum(
                    o["swap_commit"] for o in (zamba, rwkv, seamless, vlm))
                + more("swap_commit"),
                "spmm": sum(s["nm24_2:4"]["spmm"] for s in served)
                + more("spmm"),
                "spmm_gather": sum(s["gathered_0.6"]["spmm"]
                                   + s["gathered_2:4"]["spmm"]
                                   for s in served) + more("spmm_gather"),
                "spmm_stacked": sum(s["nm24_2:4"]["spmm_stacked"]
                                    for s in served) + more("spmm_stacked"),
                "spmm_stacked_gather": sum(
                    s["gathered_0.6"]["spmm_stacked"]
                    + s["gathered_2:4"]["spmm_stacked"] for s in served)
                + more("spmm_stacked_gather")}
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    written = bytes_written()
    log(f"   total {time.perf_counter() - t_start:.1f} s, "
        f"{written / 2**30:.2f} GiB written")
    require(written <= WRITE_BUDGET,
            f"the run wrote {written / 2**30:.2f} GiB, more than "
            f"{WRITE_BUDGET / 2**30:.0f}")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
