#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; a failing phase raises and the
script exits non-zero:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` builds every kernel source of the serving and
   training paths from ``src/repro_torch/kernels/csrc``, all at once
   (timed);
3. decode attention against its plain version at gemma3-12b's
   full-width decode shapes (8 slots, 16 heads, 8 KV heads, head_dim
   256): a windowed ring of T=1024 with positions several laps past the
   window and a global cache of T=2048, bf16 and f32 pools. Prints the
   split plan and grid of each shape (its shared memory held against
   the kernel's own count). At the plan's edges (pos 0 with empty
   splits, L - 1, L, L + 1, T - 1, rings several laps on) and at the
   timed positions: outputs within ``decode_parity_tolerance``, updated
   caches bitwise equal, and every row launched alone (B = 1) bitwise
   equal to its row of the B = 8 launch. Times the kernel and one
   ``scaled_dot_product_attention`` call over the same cache (a
   yardstick only: the port never calls it) on the card (a CUDA graph of
   50 calls, replayed: ``device_ms``) and eagerly, host included, and
   the plain version eagerly, beside the bound;
3b. the four segmented optimizer kernels against their plain versions
   at qwen2.5-3b's widths with the group axis cut to 4 layers
   (0.93e9 elements) and on a tree of 309 tiny segments (smaller than
   a row, straddling 128-row chunks): lars ±nesterov ±trust_clip,
   paper and lamb ±trust_clip, each at f32, bf16_master and
   bf16_master_sr. Pass-1 tables within ``NORM_RTOL`` of the plain
   version and bitwise equal over two launches; pass 2 fed the
   kernel's own table bitwise equal to the plain version. Times both
   passes, kernel and plain, beside their bounds;
3c. the two per-tensor LARS kernels, each one launch over a whole
   pass of segments, against the plain pass (``ref.lars_norm2_pass`` /
   ``lars_apply_pass``, segment by segment) on five passes:
   qwen2.5-3b's 14 kernel segments with the group axis cut to 4 layers,
   the CNN's 16 ADAPT leaves (init_cnn defaults), the edges (9
   elements, unaligned, 40 members of 35), a segment of 80 members, and
   1,280 members (40,960 B of pointers, beyond the kernel parameter
   space); bf16, f32 and bf16 w with f32 g, heavy ball and nesterov;
   and one pass mixing the three (w, g) dtype pairs:
   sums within ``LARS_NORM_RTOL`` and bitwise repeatable, the apply fed
   the kernel's sums (each segment at its column of a wider table)
   bitwise equal (momentum, delta, telemetry). Times both passes (card,
   eager, plain, ``torch._foreach_norm`` beside the norm) beside their
   bounds at size (b), whisper-large-v3's kernel segments at full width
   and depth in f32, and (c), the CNN's leaves;
3d. RMSNorm against its plain version at gemma3-12b prefill (16,384 x
   3840, the block-per-row kernel) and qwen2.5-3b (4,096 x 2048, the
   warp-per-row kernel) shapes in bf16 and f32, at d 128-8192 (f16
   too) and on an x that is not 16-byte aligned: within
   ``rmsnorm_tolerance``, bitwise repeatable; its path is the public
   ``ops.rmsnorm`` (no model calls it, as in the JAX package), driven
   once per main shape with counts at 0; kernel and one
   ``F.rms_norm`` call (a yardstick only) timed on the card and
   eagerly, the plain version eagerly, beside the bound;
4. serving at full width: gemma3-12b, all 48 layers, bf16, random
   weights from seed 0 on the card, ``ServeConfig(slots=8,
   max_len=2048, page_size=16)``; 12 requests (more than the slots)
   with prompts of 256-1536 tokens and 32-96 new tokens each, drained
   through the engine. Checks every request's token count, that the
   decode-attention kernel launched 48 times per decode step, and that
   two requests re-run alone through ``generate`` give the same greedy
   tokens up to bf16 ties. Prints the decode step's time (the decode
   and sample spans) and, from a second run of the same traffic with
   CUDA events around every decode-attention launch, the kernel's share
   of a step;
5. the same traffic through gemma3-12b at full width in f32, cut to
   ``PHASE5_LAYERS`` (24) of 48 layers (printed as ``reduced:``):
   engine and ``generate`` give exactly the same greedy tokens;
6. the same engine at smoke size in f32 on the card against the CPU's
   plain path on the same weights, token for token;
7. training at full width through ``repro_torch.launch.train.run``:
   qwen2.5-3b, all 36 layers, bf16 weights from seed 0, (a) fused
   TVLARS with f32 state, global batch 8 x 512 tokens, 3 steps; (b)
   fused LAMB with bf16 stochastically rounded state, 2 microbatches
   of 4, 3 steps. Counts set to 0 before each run must read exactly
   one norm and one apply launch per step; losses finite; at the last
   step the kernel's per-segment norms are held against
   ``torch.linalg.vector_norm`` of the same members and 4,096 random
   rows of its delta and state against the plain apply on the same
   table (bitwise). Prints the per-step loss+grad / optimizer split
   and peak memory, then times both kernels and their plain versions
   on the run's own buffers (the main path's shapes);
7c. the same model through ``launch.train.run`` with WA-LARS
   ``--use-kernel per_tensor`` (f32 momentum, bf16 weights, global
   batch 8 x 512, 3 steps): exactly one launch of each per-tensor
   kernel per step, over its 14 kernel segments; at the last step every
   segment's norms against
   ``torch.linalg.vector_norm``, its telemetry against the plain ratio
   and 4,096 elements of its momentum and delta against the plain
   apply (bitwise); split, peak memory, both passes timed on the run's
   own tensors (size (a));
8. the qwen2.5-3b smoke LM in f32: 3 fused TVLARS, 3 fused LAMB and
   (8b) 3 per-tensor WA-LARS steps on the card against the CPU's plain
   path, same weights and batches;
9. the paper's loop on the card through its entry point
   ``launch.classify.run`` at its defaults (classifier B=1024, 200
   steps, γ_target 1.0; Barlow Twins B=512, 120 + 80 steps) for
   WA-LARS, NOWA-LARS, LAMB and TVLARS, with accuracies, LNR summaries
   and whether the reference's ordering holds (reported);
   the CNN at init_cnn defaults, 20 WA-LARS steps through the
   per-tensor kernels (one pass a step: 1 + 1 launches), each
   step's update against the tree path's from the same state;
10. the sharpness diagnostics at full width through
   ``launch.train.run``: qwen2.5-3b cut to ``PHASE10_LAYERS`` (2) of its
   36 layers (``depth_cut``), bf16 weights from seed 0, per-tensor
   WA-LARS, global batch 8 in 8 microbatches of 1 x
   512 tokens (microbatches of 2 leave no room for the probe's double
   backward), 3 steps, a Lanczos lambda_max probe after every step (4
   iterations, no reorthogonalization: no basis on the card, the
   previous vector in host memory) on a held batch stacked K = 8,
   streamed to JSONL. Exactly one launch of each per-tensor kernel per
   step and none inside a probe; params and momentum bitwise unchanged
   by every probe (checksums); lambda_max finite at steps 0-2, the file
   valid, lambda_max >= alpha_1. Then a SAM (rho 0.05) and a
   noise-scale probe (K = 8) on the final state, the HVP's symmetry for
   two seeded directions, one matvec timed, the peak memory, and the
   per-tensor kernels timed at this run's shapes;
10b. the smoke LM in f32 on the card against the CPU's plain path, same
   weights and batch: flat HVP, Lanczos alpha/beta from one v0,
   sam_sharpness, gradient_noise_scale and a loss slice;
10c. ``launch.sharpness.run`` at its defaults (the bench's MLP, WA-LARS
   and TVLARS, 40 steps, probes every 5, SLQ at the end): files valid,
   the early lambda_max of each optimizer and their ratio reported;
10d. the probe smoke, ``repro_torch.diagnostics.smoke``, at its CLI
   defaults (on the card);
11. the adaptive-batch controller at full width through
   ``launch.train.run --adaptive-batch``: qwen2.5-3b, all 36 layers,
   bf16 weights from seed 0, fused TVLARS in f32, microbatches of 1 x
   512 tokens, the global batch starting at 2 and free in [1, 16], a
   noise-scale probe (2 microbatches from seed 998) every 2 steps, 4
   steps (6 until phases 20-20c came in), batches drawn by ``--prefetch 2``. At least one switch, each
   switch's ``controller/lr`` equal to ``batch_scaled_lr`` at its batch,
   exactly one segmented norm and one apply launch per step at every
   visited K and none inside the controller, one step built per visited
   K, the prefetched batches equal by checksum to the plain stream's
   retargeted at the same steps, the JSONL valid. Prints the step time
   per K and the peak beside its prediction;
11b. the smoke LM in f32 on the card: a scripted K switch (2 -> 8) after
   3 steps against a fresh K = 8 run from the same state and stream
   position (1e-6), and ``fit(controller=)`` with the noise probe on the
   card against the CPU's plain path (losses and params 1e-5, noise
   scale 1e-3, the same decisions);
11c. the paper's experiment launchers on the card at their reference constants
   (``launch.table1``, ``ssl``, ``fig2_lnr``, ``ablations``,
   ``schedules``, ``adaptive_batch``), their CSV and JSONL files
   checked, Table 1 again with ``--use-kernel per_tensor`` (one launch
   of each per-tensor kernel per step over the ADAPT leaves); prints Table 1
   and the adaptive bench's switches;
12. codeqwen1.5-7b at full width and depth (32 layers, bf16, random
   weights from seed 0): the prediction (weights + KV pool) first,
   decode attention against its plain version at its serving shape (8
   slots, 32 heads over 32 KV heads: one query head per KV head,
   head_dim 128, T 2048, bf16; the plan's edges and the timed
   positions), then phase 4's traffic through the engine: 32 launches
   per decode step, tok/s, the decode step, the kernel's card time per
   step (CUDA events, a second run) and the peak;
12b. qwen2-72b at full width cut in depth (``reduced: num_layers 80 ->
   L`` is printed: the deepest L whose weights, KV pool and a prefill
   batch are predicted under 60 GiB): the kernel at its shape (4 slots,
   64 heads over 8 KV heads, head_dim 128, T 1024) and 4 requests;
12c. the main path, qwen2.5-3b at full width: ``launch.train.run``
   with fused TVLARS, global batch 8 x 512, 4 steps, once synchronous
   and once with ``--async-metrics 2`` from the same seed: histories
   and the final state's checksums bitwise equal, 1 + 1 segmented
   launches per step, the card synchronisations per step over steps
   1-3 (those sync-debug mode reports plus explicit
   ``torch.cuda.synchronize`` calls) outside and inside the resolves,
   none outside in the async run. A third run, async again, under
   ``--profile-dir`` from step 1: its history and state equal the
   synchronous run's, and its trace, up to the end of the last
   resolve, counts the CUDA runtime and driver calls that wait on the
   card or may (synchronisations, allocations and frees, pinned host
   allocations, blocking copies) and the pageable copies inside and
   outside the resolves, none that waits and no pageable copy outside,
   with the card's busy share and the host time in kernel launches.
   Decode attention against its plain version at the serving shape (4
   slots, 16 heads over 2 KV heads, head_dim 128, T 1024, bf16; the
   plan's edges and the timed positions), timed beside SDPA. Then the
   trained params saved by ``repro_torch.checkpoint`` in
   the reference's layout (free disk checked first; bytes, save and
   restore seconds), ``Engine.from_checkpoint`` (restored params
   bitwise the trained ones) and an engine on the in-memory params
   serve 4 requests each: the same tokens, 36 launches per decode
   step;
12d. ``launch.pipeline`` at the bench's constants: sync and async
   loops' metrics equal, 1 + 1 segmented launches per step, the
   sync / async ratio (recorded, not asserted);
12e. ``launch.landscape`` at the bench's constants: both checkpoints
   restored, the 9 x 7 grid finite, its CSV written;
12f. ``launch.train --smoke --profile-dir`` on the card: the Chrome
   trace names both segmented kernels;
13. olmoe-1b-7b (MoE, 64 experts top-8) served at full width and depth
   (16 layers, bf16, random weights from seed 0) on phase 4's slots,
   request count and new-token counts, every prompt 1024 tokens long
   (capacity drops depend on the padded length, so the engine and
   ``generate`` route alike only at bucket-aligned prompts): the
   prediction, decode attention against its plain version at (8
   slots, 16 / 16 heads, Dh 128, T 2048), 16 launches per decode step,
   requests 0 and 7 alone through ``generate`` up to bf16 ties,
   tok/s, the decode step beside its weight-read bound, the kernel's
   card time per step and the peak;
13b. qwen3-moe-30b-a3b (128 experts) at full width and, where the
   prediction fits under 60 GiB, full depth (48 layers; else the cut is
   printed), 4 slots x 1024, 4 requests: the kernel at (4 slots, 32 / 4
   heads, G = 8, Dh 128, T 1024) beside SDPA and its bound; 48 launches
   per decode step; the decode step beside the all-experts weight read;
13c. olmoe-1b-7b trained through ``launch.train.run`` at full width cut
   in depth to the most layers predicted under 70 GiB (20 B a
   parameter + 6 GiB; printed), fused TVLARS f32, 8 x 512, 3 steps: 1 +
   1 segmented launches per step, the last step checked as in phase 7,
   the load-balance and router z losses finite and non-zero;
13d. mamba2-1.3b trained at full width cut to 12 of 48 blocks
   (``FAMILY_CUTS``: the script's time budget; 8 x 512, two SSD chunks
   a row): fused TVLARS f32 (then ``generate`` on its
   params: 4 prompts of 32 tokens through the token-by-token prefill
   plus 16 new tokens, 0 decode-attention launches) and per-tensor
   WA-LARS (1 + 1 launches per step over its 11 kernel segments, the
   last step checked as in 7c);
13e. zamba2-1.2b: the kernel at (4 slots, 32 / 32 heads, Dh 64, T 48,
   ``generate``'s cache), then trained at full width cut to 14 of 38
   blocks (two groups and the trailing two: the shared block at 2 call
   sites; fused TVLARS f32, 8 x 512, 3 steps) and ``generate`` as in
   13d with 2 decode launches per step;
13f. the four families' smoke configs in f32 on the card against the
   CPU's plain path on the same weights: logits, every MoE layer's
   routing decisions (equal, with and without drops), ``generate``'s
   tokens and one fused TVLARS step.
14. llama-3.2-vision-11b cut to 20 of 40 self layers (4 of 8 gated
   cross layers) served at full width (bf16, random weights from seed 0, every gate
   opened to 0.5 in the phase, one image block [8, 1600, 4096] of
   seeded normal draws) on phase 4's engine and traffic: the
   prediction, 20 decode launches per step (the cross layers none),
   tok/s, the decode step beside its weight read, the peak; three
   requests, one per image row the engine gave them (row i of its
   admission batch), held against ``generate`` on that row up to bf16
   ties, and one request on another image must change tokens;
14b. whisper-large-v3 cut to 8 + 8 of 32 + 32 layers ``generate`` at
   full width: 4 prompts of 64 tokens, 32 new, random frames [4, 1500,
   1280]; 8 decode launches per step, the tokens against the argmax
   of a teacher-forced ``apply`` up to bf16 ties, other frames must
   change tokens;
14c. whisper-large-v3 trained at full width, 8 + 8 layers, through
   ``launch.train.run`` with random frames in place of the launcher's
   zero stub (``live_frontend``): fused TVLARS f32 8 x 512 (1 + 1
   launches per step) and per-tensor WA-LARS (1 + 1 over 28 kernel
   segments), last steps
   checked as in 7 / 7c; then one step of the launcher on its zero
   stub (the gradient overflows there, in both packages: F11);
14d. llama-3.2-vision-11b trained cut in depth to whole groups (the
   deepest predicted under 70 GiB: printed), gates opened, random
   images, fused TVLARS f32 8 x 512, 3 steps: the cross layers'
   attention weights and gate get non-zero gradients;
14e. (inside 14 and 14b) decode attention against its plain version
   at G = 4 / Dh 128 (8 slots, 32 / 8 heads, T 2048) and G = 1 / Dh 64
   (4 slots, 20 / 20 heads, T 96), timed beside SDPA and the bound;
14f. both smoke configs in f32 (gates opened, random extra embeddings)
   on the card against the CPU: logits, ``generate``, one fused
   TVLARS step and (vlm) the engine's tokens on distinct image rows.
15. data parallelism over ``torch.distributed``: two ranks (spawned,
   gloo: NCCL refuses two ranks on one card) share the card, each
   training qwen2.5-3b at full width cut in depth (``reduced:
   num_layers 36 -> L`` is printed: at most ``DP_LAYERS`` (2), the
   script's time budget, and predicted under half the free card less a
   context) through
   ``launch.train.run --mesh-data 2``: fused TVLARS f32, 8 x 512 (4 x
   512 a rank), 1 step, after a D = 1 run on the same samples in this
   process. 1 + 1 segmented launches per rank per step, the ranks'
   state fingerprints equal after every step, loss, grad_norm and every
   segment's (w_norm, g_norm, trust_ratio) within a bound of its own
   of D = 1 (``DP_BOUNDS``); a D = 1 run on batches whose second shard
   repeats the first (what two ranks that both read shard 0 compute)
   must fail those bounds; per rank the step split into loss+grad, the
   host-staged all-reduce and the optimizer, and the peak beside its
   prediction;
15b. the adaptive-batch controller on 4 ranks (the smoke LM, scripted
   noise readings): the (1, 1) -> (4, 2) schedule, its batches and LR,
   steps built for two (D, K) pairs, 1 + 1 launches per rank per step,
   ranks bitwise equal after every step;
15c. NCCL at world size 1: the bucketed all-reduce over f32 buffers of
   qwen2.5-3b's leaf shapes (a sum of one: values unchanged), timed,
   and one
   ``--mesh-data 1`` step through the launcher in that world;
15d. rank 0's checkpoint of phase 15's params restored here (D = 1) by
   ``Engine.from_checkpoint(mesh=make_data_mesh(1))`` onto the card,
   bitwise the ranks' params, serving 4
   requests. The kernels are built before any rank is spawned. Phases
   15-18 (15c's NCCL world apart) hand their calls to two worlds of 2
   and 4 gloo ranks that start on first use and stay up to the end
   (``RankPool``), so each rank's start, imports and first launches are
   paid once; a rank that fails or a call that hangs past its timeout
   fails the phase.
16. the model axis, tensor-parallel serving: gemma3-12b at full width,
   cut to ``TP_LAYERS`` (6) of 48 layers (the script's time budget),
   bf16, on a (1, 2) mesh, two gloo ranks sharing
   the card, each holding its blocks of the seed-0 draw
   (``Model.init(0, mesh=)``: 8 of 16 heads, 4 of 8 KV heads, half of
   d_ff and of the vocabulary) and running the decode kernel on its
   share of the heads. First the decode kernel at a rank's shape (4
   slots, 8 / 4 heads, Dh 256, T 288, bf16) against its plain version,
   timed beside SDPA and its bound; then, in this process, the M = 1
   engine on the same weights serves 4 requests (prompts of 64-256
   tokens, 16-32 new, 4 slots, greedy), the requests as one padded
   batch (and request 0 alone) are teacher-forced along its tokens
   (the logits kept), and the weights are freed. On the ranks: the
   engine on the same requests (6 decode launches per rank per step,
   every rank's tokens equal, equal to M = 1's up to each request's
   first difference, which must be a bf16 near-tie in both logit
   sets), the same teacher-forced batches (the max and mean |logit
   gap| to M = 1 under
   ``TP_LOGIT_BOUND`` / ``TP_LOGIT_MEAN_BOUND``, which the fault, every
   wo partial left unsummed, must exceed), the peak a rank against
   ``weight_bytes / 2 + 2 * kv_pool_bytes / 2`` and a context, and a
   decode step at 4 slots split on the host clock into compute, the
   row's ``model_sum_`` calls and the logits gather;
16b. the gemma3 and qwen2 smoke configs in f32 on a (2, 2) mesh of four
   gloo ranks on the card (the windowed ring past T, QKV biases set to
   draws, both axes' groups), on weights drawn on the CPU: every rank's
   tokens equal M = 1's on the CPU, prefill logits within
   ``TP_SMALL_LOGIT_BOUND``, which the QKV biases' rows of the other
   rank must exceed.
17. the decode kernel's partial mode (a KV cache split over T): at
   17a's rank shape (4 slots, 16 / 2 heads, Dh 128, T 288 in four
   blocks of 72, bf16) and at a synthetic ring (Dh 256, window 1024 in
   four blocks, positions several laps past T), every block launched
   with its offset against the plain version (out, lse, the appended
   block bitwise; rows with no needed key in a block out 0, lse -inf,
   no NaN), the four blocks merged against the unsplit launch within
   ``decode_parity_tolerance``; each block's card time beside SDPA over
   the same block and its bound;
17a. qwen2.5-3b at full width cut to ``TF_LAYERS`` (2) of its 36
   layers (the script's time budget), bf16, on a (1, 4)
   mesh of four gloo ranks sharing the card: 4 of 16 heads and both KV
   heads a rank, so the KV pool holds block r of T (72 of 288 keys) and
   every decode launch is in the partial mode (q gathered over the row,
   the (out, lse) partials gathered and merged). As phase 16: M = 1
   first on the same weights, the engine's 4 requests (2 launches per
   rank per step, ranks' tokens equal, differences to M = 1 only at
   bf16 near-ties), teacher-forced logit gaps under ``TF_LOGIT_BOUND``
   / ``TF_LOGIT_MEAN_BOUND``, which merging without the lse weights
   must exceed, the peak a rank against its prediction, and a decode
   step split into compute, the sums and each gather;
17b. the same weights on a (2, 2) mesh: each data row's pool holds 2 of
   the 4 slots and decodes them (2 launches per rank per step on the
   half batch), the sampled tokens gathered over the data column; the
   tokens equal M = 1's up to bf16 near-ties;
17c. llama-3.2-vision-11b through the engine (40 decode launches a
   step, the cross layers none), whisper-large-v3, mamba2-1.3b and
   zamba2-1.2b through ``generate(mesh=)``, at full width on a (1, 2)
   mesh of two gloo ranks (depth cuts in ``FAM_TP_LAYERS``): ranks'
   tokens equal, launches per step, the last prompt logits against M =
   1 on the same weights under the 17a bounds;
17d. every family's smoke config in f32 at (1, 4) (inside 17a's world)
   and (2, 2) (inside 17b's): tokens equal the CPU's M = 1.
18. training over the model axis: qwen2.5-3b at full width (2048 wide,
   16 / 2 heads, d_ff 11008, vocab 151936, bf16) cut to ``TT_LAYERS``
   (2) of 36 layers (printed), fused TVLARS f32, 4 x 512, 2 steps
   through ``launch.train.run --mesh-model 2`` on a (1, 2) mesh of two
   gloo ranks sharing the card (each holding its blocks of the seed-0
   draw under the reference's training placement), after an M = 1 run
   on the same weights and batches here: 1 + 1 segmented launches a
   rank a step, the ranks holding the same block bitwise equal, the
   loss, grad_norm and layer-wise norms within ``TT_BOUNDS`` of M = 1
   and every rank's blocks of the params within its ``params`` bound;
   the step split (compute, row sums, fsdp gathers, column reduce, the
   norm table's and grad norm's all-reduce, from ``Mesh.collectives``),
   the state bytes a rank equal to the placement rules' prediction, the
   peak against its prediction; the segmented kernels on rank 0's flat
   buffers against their plain versions, timed;
18a. the same on a (2, 2) mesh of four ranks: fsdp over the data axis
   (the leaves' data blocks gathered per layer, their gradients
   summed over the column);
18b. per-tensor WA-LARS at (1, 2): 1 + 1 launches a rank a step (one
   pass over the kernel segments, chosen by whole size), the state
   bytes and the split as 18, the per-tensor passes on rank 0's blocks
   of the largest segment against the plain pass, timed;
18c. 18a's state saved (``checkpoint.save_train_state``: rank 0 writes
   the gathered state) and restored here at M = 1, bitwise the gathered
   state, one request served from it through the decode kernel; the
   qwen2.5-3b and gemma3-12b smoke configs in f32 at (2, 2) and (1, 4)
   (inside 18a's world; weights and batches drawn on the CPU, K = 2)
   against the CPU's single-rank losses (1e-5).
19. training the other families over the reference's GSPMD mesh:
   mamba2-1.3b and zamba2-1.2b at full width cut to whole blocks
   (``FT_CUTS``, printed as ``reduced:``), fused TVLARS f32, 4 x 512, 1
   step through ``launch.train.run --mesh-model 2 --mesh-data 2`` on
   a (2, 2) mesh of four gloo ranks sharing the card, after an M = 1
   run on the same weights and batches here: as 18, 1 + 1 segmented
   launches a rank a step, the state bytes a rank equal to the rules'
   blocks, the ranks holding one block bitwise equal, the gaps to M =
   1 within ``TT_BOUNDS``, the step split; the leaves whose data axis
   the reference puts on a stacked dim (conv_w / conv_b) counted;
19a. whisper-large-v3 and llama-3.2-vision-11b (one group) likewise on
   a (1, 2) mesh of two ranks, whisper in bf16 (its vocabulary-parallel
   head sums each rank's f32 partial of the hidden state's gradient
   over the row and rounds once, as one device's head does), the vlm in
   f32 (printed: in bf16 its gate's one-device gradient is itself 10%
   from the f32 step's), on seeded random frames and image embeddings
   (zero frames overflow whisper's LayerNorm backward, F11) and the
   vlm's cross gates opened;
19b. olmoe-1b-7b likewise on a (2, 1) mesh through the GSPMD
   ``--data-parallel 2``: its load balance within ``FT_LB_BOUND`` of M
   = 1 (the global batch's means), and the per-shard means' value on
   the same weights and batch, whose gap must exceed that bound;
19c. a 2-iteration Lanczos probe (no reorthogonalization) of
   qwen2.5-3b cut to ``TT_LAYERS`` after a per-tensor WA-LARS step at
   (1, 2) and (2, 2): λ_max within ``FT_PROBE_BOUND`` of the M = 1
   probe from the same seed vector, no kernel launched inside a probe,
   the step before it 1 + 1 per-tensor launches a rank, the state
   bitwise unchanged by it;
19d. every family's smoke config in f32 at (2, 2) (the MoE's at (4,
   1)), 2 steps, the vlm's gates opened and seeded extra embeddings,
   against the CPU's single-rank losses (1e-5).
20. expert parallelism, the MoE family over the model axis:
   qwen3-moe-30b-a3b at full width cut to ``EP_LAYERS`` (6) of 48
   layers (printed as ``reduced:``), bf16, on a (1, 2) mesh of two gloo
   ranks sharing the card, each holding its blocks of the seed-0 draw
   (64 of 128 experts and the router's 64 columns, 16 / 2 heads, half
   the vocabulary). The decode kernel at a rank's shape (4 slots, 16 /
   2 heads, G = 8, Dh 128, T 1024) against its plain version, timed;
   then M = 1 here on the same weights (the engine's 4 requests on 4
   slots x 1024, 4-8 new tokens, and the requests teacher-forced
   along its tokens), and on the ranks the same through
   ``Engine(mesh=)``: 6 decode launches a rank a step, the ranks'
   tokens equal, equal to M = 1's up to bf16 near-ties, the |logit
   gap| to M = 1 under ``TP_LOGIT_BOUND`` / ``TP_LOGIT_MEAN_BOUND``,
   the decode step's split (compute, the row's sums, the router-logit
   and logit gathers) beside the rank's expert weight read;
20a. olmoe-1b-7b likewise at full width cut to ``EP_OLMOE_LAYERS`` (4)
   of 16 layers on a (1, 4) mesh of four ranks: 16 of 64 experts, 4 /
   4 heads a rank;
20b. olmoe-1b-7b trained at full width cut to 1 of 16 layers through
   ``launch.train.run --mesh-model 2 --mesh-data 2`` on a (2, 2) mesh
   (32 of 64 experts a rank, fsdp over the data axis): fused TVLARS f32,
   4 x 512, 1 step after an M = 1 run on the same weights and batches,
   then one per-tensor WA-LARS step: 1 + 1 segmented launches a rank a
   step and 1 + 1 per-tensor launches a rank a step, the state bytes a
   rank equal to the rules' blocks, the ranks holding one block bitwise
   equal, the gaps to M = 1 within ``TT_BOUNDS`` and the load balance
   within ``FT_LB_BOUND``, the step split; both kernels on rank 0's
   buffers against their plain versions, timed;
20c. both MoE smoke configs in f32 at (2, 2) and (1, 4), 2 steps,
   against the CPU's single-rank losses (1e-5); a 4-iteration Lanczos
   probe of olmoe's smoke config at (2, 2) against M = 1
   (``FT_PROBE_BOUND``), no kernel launched inside it, the step before
   it 1 + 1 per-tensor launches a rank.

21. the decode kernel's two modes for a KV cache split over the head
   dim (scores: the append and the f32 partial scores; apply: mask,
   scale, softmax and probs . V over the block) against their plain
   versions at whisper-large-v3's rank shape at M = 8 (4 slots, 20 / 20
   heads, Dh 64 in blocks of 8, T 448) and qwen2.5-3b's at M = 4 in case
   B (16 heads gathered over 2 KV heads, Dh 128 in blocks of 32, T
   1021), bf16 and f32, global and a ring past two laps: each block's
   scores within f32 rounding of plain, nothing written past a row's
   last needed key, each append in its block's slice only; the blocks'
   scores summed in rank order within f32 rounding of the one-block
   launch; apply within ``decode_parity_tolerance`` of plain and the
   gathered output of ``attention_decode_ref`` on the whole cache;
   rank 0's launches timed on the card, eagerly and in their plain
   versions beside their byte bounds, SDPA over the whole cache;
21a. whisper-large-v3 at full width cut to ``DH_LAYERS`` (2) of 32 + 32
   layers (printed as ``reduced:``), bf16, on a (1, 8) mesh of eight
   gloo ranks sharing the card (its 20 heads whole on every rank, d_ff
   640 of 5120): ``generate(mesh=)`` of 4 prompts of 8 tokens, 8 new,
   on random frames [4, 1500, 1280], after M = 1 here on the same
   weights, twice: a cache of 16 (8 divides it: the self caches over T,
   the partial mode, one launch a decoder layer a rank a call) and of
   17 (over Dh: one scores and one apply launch); the cross K/V over
   Dh in both. A rank's cache bytes 1/8 of M = 1's, the ranks' tokens
   equal, equal to M = 1's up to bf16 near-ties, the |logit gap| along
   the calls within ``TP_LOGIT_BOUND`` / ``TP_LOGIT_MEAN_BOUND``, the
   decode step split (compute, score sums, gathers, wo / MLP sums);
21b. qwen2.5-3b at full width cut to 2 layers on (1, 4) (case B: 4 of
   16 heads a rank, both KV heads): the engine on a pool of 1021 keys a
   slot (over Dh), 4 requests of 4-8 new tokens: one scores and one
   apply launch a layer
   a rank a step, tokens and teacher-forced gaps as 17a's;
21c. one fused TVLARS f32 step of whisper-large-v3 cut to 2 + 2 layers
   at (1, 8) through ``launch.train.run``, after M = 1: as 19a (1 + 1
   segmented launches a rank, the gaps within ``TT_BOUNDS``, the state
   bytes a rank the rules');
22. sequence parallelism against its own dry run: qwen2.5-3b at full
   width cut to ``SP_LAYERS`` (4) of 36, seq 4096, bf16, on a (1, 2)
   mesh of two gloo ranks sharing the card, after M = 1 here on the
   same weights and batch: one fused TVLARS step with the sequence over
   the model axis and one without, from the same state. The gaps
   between the two and to M = 1 within ``TT_BOUNDS``; each rank's
   ``max_memory_allocated`` within ``SP_PEAK_RTOL`` (10%) of the dry
   run's prediction for the same step (``launch.dryrun`` on a
   ``DryMesh`` of the rank), and so the bytes the forward holds for the
   backward (the split's saving), the collective
   records equal to the prediction name by name (count and bytes), and
   1 + 1 segmented launches a rank a step, as predicted;
22a. prefill under sequence parallelism: ``Model.apply``'s
   last-position logits on the same shape with the split and without,
   |logit gap| max and mean within ``TP_LOGIT_BOUND`` /
   ``TP_LOGIT_MEAN_BOUND``;
22b. three production dry runs on the (16, 16) mesh (qwen2-72b ×
   train_4k, qwen2.5-3b × decode_32k, gemma3-12b × long_500k), in a
   process of their own while 22 runs: status, GiB a rank, dot FLOPs,
   collective GiB and seconds (predictions of the port, not card
   measurements).
23. the four examples (``examples/torch_*.py``, the twins of the JAX
   package's ``examples/``), each by its ``run`` function in this
   process at its JAX twin's sizes, which are the whole of what it
   defines. 23: the quickstart (the tiny dense LM, TVLARS at LR 2.0, 16
   x 64, 30 steps): its loss line, the loss declining;
23a. the classification example (B 1024, base 64, 200 steps, γ 1.0,
   WA-LARS, NOWA-LARS, LAMB and TVLARS, the eval on 2048 samples): the
   Table-1-style summary with the JAX example's numbers from a CPU
   sandbox beside it (other samples: not a gate), the three LARS-family
   runs finite, and no optimizer kernel launched (``build_optimizer``'s
   default ``use_kernel=False``, as in the JAX script);
23b. the Barlow-Twins example (B 512, 120 steps, LR 0.8, λ 1e-5, then
   the SGD linear probe of 80 steps at B 256) for WA-LARS and TVLARS;
23c. the serving example for every arch id at its smoke config: the
   engine's tokens equal per-request ``generate``'s on 4 staggered
   requests (``generate`` twice, deterministic, for the families without
   a batched prefill), and the decode kernel launched once per attention
   layer per decode step (zamba2: once per call site of its shared
   block; mamba2 none);
23d. ``tools/torch_validate_metrics.py`` (by ``main``) over every JSONL
   file phases 10-11c wrote, with ``--min-records 1``: exit 0.

Every phase prints its seconds (``phase {label}: {s} s``).

The last lines are the script's total time, the ``nvidia-smi`` line,
one JSON object describing each kernel (decode attention and RMSNorm
with a row per timed shape under ``shapes``; the per-tensor pair with
its eager time, ``foreach_norm_ms`` and sizes (a)-(c) under ``sizes``;
decode attention and the optimizer kernels with their launches per phase under
``launches_by_phase``), and ``{"ok":
true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script fails before
printing any result.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

# The phases share one process. With fixed segments the caching
# allocator carves the 12.66 GiB buffers that one phase frees into the
# smaller blocks of the next, and phase 11's fused update then found
# 12.48 GiB free with 8.44 GiB reserved in split segments; expandable
# segments map pages on demand instead. Set before CUDA starts.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# gemma3-12b decode attention at the serving path's shapes
SLOTS, HEADS, KV_HEADS, HEAD_DIM = 8, 16, 8, 256
WINDOW, MAX_LEN = 1024, 2048
LOCAL_PER_STEP, GLOBAL_PER_STEP = 40, 8        # launches per decode step
POS = {"local": [0, 5, 1023, 1024, 2500, 3071, 4100, 6143],
       "global": [0, 300, 700, 1023, 1024, 1400, 1536, 2047]}


@contextlib.contextmanager
def phase_clock(label: str):
    """Prints the block's seconds as ``phase {label}: {s} s``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s",
              flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """The card's time for one call of ``fn``: ``iters`` calls captured
    in a CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's cost per call (Python, the launch) is out of the
    reading. Warm-up on the capturing stream first, so buffers the call
    keeps are allocated outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events, after one warm-up call: the card's time, or the host's cost
    per call where that is longer (eager)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def edge_positions(kind: str, keys: int, t: int) -> list:
    """Positions at the split plan's edges: pos = 0 (every split but the
    first empty), L - 1, L and L + 1 around the first split boundary,
    T - 1, and on rings several laps past the window."""
    if kind == "global":
        return [0, keys - 1, keys, keys + 1, t - 1, 5, t // 2, t - 2]
    return [0, keys - 1, keys, keys + 1, t - 1, t + keys, 3 * t + 5,
            9 * t - 1]


def decode_check(tad, ops, label, operands, window, tol) -> tuple:
    """One launch against the plain version on copies of the caches:
    output within ``tol``, caches bitwise equal, finite; then every row
    launched alone (B = 1, same T) bitwise equal to its row of the full
    launch. Returns (max abs error, kernel output, kernel's caches)."""
    q, nk, nv, kc, vc, pos = operands
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out_k = ops.attention_decode(q, nk, nv, kk, vk, pos, window=window)
    out_p = tad.attention_decode_ref(q, nk, nv, kp, vp, pos, window=window)
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    torch.testing.assert_close(out_k.float(), out_p.float(), **tol)
    if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
        raise AssertionError(f"{label}: updated caches differ between "
                             f"kernel and plain")
    if not torch.isfinite(out_k.float()).all():
        raise AssertionError(f"{label}: non-finite output")
    for b in range(q.shape[0]):
        row = slice(b, b + 1)
        alone = ops.attention_decode(q[row], nk[row], nv[row],
                                     kc[row].clone(), vc[row].clone(),
                                     pos[row], window=window)
        if not torch.equal(alone, out_k[row]):
            raise AssertionError(f"{label}: row {b} launched alone differs "
                                 f"from its row of the B={q.shape[0]} "
                                 f"launch")
    return err, out_k, kk, vk


def phase_kernel(tad, ops) -> dict:
    """Kernel vs plain version at full width; returns the timings."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for kind in ("local", "global"):
            t = WINDOW if kind == "local" else MAX_LEN
            row = kernel_row(tad, ops, gen, kind, t,
                             WINDOW if kind == "local" else None, dtype,
                             SLOTS, HEADS, KV_HEADS, HEAD_DIM, POS[kind])
            rows[(kind, dtype)] = row
            max_err = max(max_err, row["max_abs_err"])
    return {"rows": rows, "max_abs_err": max_err}


def kernel_row(tad, ops, gen, kind, t, window, dtype, slots, heads,
               kv_heads, head_dim, timed) -> dict:
    """Decode attention against its plain version at one shape (the
    plan's edge positions, then ``timed``), timed beside SDPA and the
    bound; returns the shape's row."""
    dev = torch.device("cuda")
    lib = tad._lib()
    tol = tad.decode_parity_tolerance(dtype)
    dname = str(dtype).split(".")[-1]
    plan = tad.decode_plan(t, head_dim, dtype, heads // kv_heads)
    smem_c = lib.repro_attention_decode_smem(
        tad._DTYPE_CODES[dtype], head_dim, plan.heads)
    if smem_c != plan.smem:
        raise AssertionError(f"plan's shared memory {plan.smem} B, "
                             f"the kernel's {smem_c} B")
    print(f"kernel attention_decode {kind} T={t} {dname} pool, {slots} "
          f"slots x {heads} heads / {kv_heads} KV heads x {head_dim}: plan "
          f"L={plan.keys} keys x {plan.splits} splits, "
          f"{plan.heads} query heads a block, grid "
          f"{plan.grid(slots, kv_heads)} x {tad.WARPS * 32} "
          f"threads, {plan.smem} B shared memory", flush=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q = randn(slots, 1, heads, head_dim)
    nk, nv = randn(slots, 1, kv_heads, head_dim), \
        randn(slots, 1, kv_heads, head_dim)
    kc, vc = randn(slots, t, kv_heads, head_dim), \
        randn(slots, t, kv_heads, head_dim)
    def chunks(xs):
        """``xs`` in launches of ``slots`` rows, the last one filled
        from the start of ``xs``."""
        out = []
        for i in range(0, len(xs), slots):
            c = xs[i:i + slots]
            out.append(c + [xs[j % len(xs)]
                            for j in range(slots - len(c))])
        return out

    # the split plan's edges first, then the timed positions; the last
    # launch's positions are the ones timed
    edge = [p for p in edge_positions(kind, plan.keys, t)
            if window is not None or p < t]
    launches = chunks(edge) + chunks(list(timed))
    err = 0.0
    for rows_pos in launches:
        pos = torch.tensor(rows_pos, dtype=torch.int32, device=dev)
        e, _, kk, vk = decode_check(
            tad, ops, f"{kind} {dname} positions {rows_pos}",
            (q, nk, nv, kc, vc, pos), window, tol)
        err = max(err, e)
    print(f"  positions {edge} and {list(timed)}: within "
          f"rtol=atol={tol['rtol']:.2e} of plain, caches bitwise "
          f"equal, each row alone (B=1) bitwise equal to its row "
          f"of the B={slots} launch", flush=True)
    kp, vp = kk.clone(), vk.clone()

    # the yardstick: one SDPA call over the same (already
    # appended) cache with a boolean validity mask
    posl = pos.long()[:, None]
    kpos = torch.arange(t, device=dev)[None, :]
    if window is None:
        ok = kpos <= posl
    else:
        slot = posl % t
        wraps = (posl // t) * t
        a = kpos + torch.where(kpos <= slot, wraps, wraps - t)
        ok = (a >= 0) & (a <= posl) & (a > posl - window)
    mask = ok[:, None, None, :]
    qs, ks, vs = q.transpose(1, 2), kk.transpose(1, 2), \
        vk.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)

    out_p = tad.attention_decode_ref(q, nk, nv, kp.clone(),
                                     vp.clone(), pos, window=window)
    sdpa_err = (sdpa().transpose(1, 2).float()
                - out_p.float()).abs().max().item()

    # least time: the bytes the function must move (the valid
    # K/V rows read once, q read and out written, new K/V read
    # and appended, pos) and its f32 operations (QK and PV:
    # 4 flops per head-dim element per valid key per head)
    csize = kc.element_size()
    valid_keys = int(ok.sum().item())   # (row, key) pairs needed
    bytes_moved = (2 * valid_keys * kv_heads * head_dim * csize
                   + 2 * q.numel() * q.element_size()
                   + 4 * nk.numel() * csize + 4 * slots)
    flops = 4 * valid_keys * heads * head_dim
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3

    def kernel():
        return ops.attention_decode(q, nk, nv, kk, vk, pos,
                                    window=window)

    row = {
        "shape": f"{kind} T={t} {dname}"
        if (slots, heads, kv_heads, head_dim) == (SLOTS, HEADS, KV_HEADS,
                                                  HEAD_DIM)
        else f"{kind} T={t} {dname} B={slots} H={heads} Hkv={kv_heads} "
             f"Dh={head_dim}",
        "ms": device_ms(kernel), "eager_ms": time_ms(kernel, 50),
        "plain_ms": time_ms(lambda: tad.attention_decode_ref(
            q, nk, nv, kp, vp, pos, window=window), 10),
        "library_ms": device_ms(sdpa),
        "library_eager_ms": time_ms(sdpa, 50),
        "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms
        else "operations",
        "max_abs_err": err, "keys": plan.keys,
        "splits": plan.splits,
        "grid": list(plan.grid(slots, kv_heads))}
    print(f"  card time (CUDA graph): kernel {row['ms']:.4f} ms, "
          f"sdpa {row['library_ms']:.4f} ms (max|err| "
          f"{sdpa_err:.3e}); eager, host included: kernel "
          f"{row['eager_ms']:.4f} ms, sdpa "
          f"{row['library_eager_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms; bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{bytes_moved} B, {flops} flop): "
          f"{row['bound_ms'] / row['ms']:.1%} of the bound; "
          f"max|err| {err:.3e}", flush=True)
    return row


def traffic(vocab_size: int):
    """Phase 4's requests: prompts of 256-1536 tokens, 32-96 new."""
    rng = np.random.RandomState(0)
    lens = rng.randint(256, 1537, size=12)
    new = rng.randint(32, 97, size=12)
    prompts = [rng.randint(1, vocab_size, size=n).astype(np.int32)
               for n in lens]
    return prompts, lens, new


def engine(serving, model, params, tracer, slots=SLOTS, max_len=MAX_LEN):
    """An engine on ``params`` with pages of 16 positions."""
    return serving.Engine(
        model, params, serving.ServeConfig(slots=slots, max_len=max_len,
                                           page_size=16),
        device="cuda", tracer=tracer)


def serve(eng, ops, requests=None):
    """Drain phase 4's traffic (or ``requests``: (prompts, new)) through
    ``eng``: half submitted up front, the rest admitted mid-flight.
    Returns (results, stats, seconds, kernel launches during the run)."""
    model = eng.model
    prompts, new = requests if requests is not None \
        else traffic(model.cfg.vocab_size)[::2]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    half = len(prompts) // 2
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts[:half], new[:half])]
    for _ in range(3):
        eng.step()
    ids += [eng.submit(p, max_new_tokens=int(m))
            for p, m in zip(prompts[half:], new[half:])]
    eng.drain()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launches["attention_decode"]
    results = [eng.result(i) for i in ids]
    for r, m in zip(results, new):
        if not r.finished or len(r.tokens) != m:
            raise AssertionError(f"request {r.id}: finished={r.finished} "
                                 f"with {len(r.tokens)} of {m} tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.id}: token out of range")
    return results, eng.stats(), elapsed, launches


def picks(lens) -> list:
    """The requests re-run alone: the first longer than the window
    (ring packing at prefill) and the first not longer."""
    return [int(np.argmax(lens > WINDOW)), int(np.argmax(lens <= WINDOW))]


def init_checked(model):
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for layer in params["layers"]
                   for part in layer.values() for x in part.values()) \
        + sum(x.numel() for x in params["embed"].values()) \
        + params["final_norm"]["scale"].numel()
    if n_params != model.cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{model.cfg.param_count()}")
    print(f"serving: gemma3-12b {model.cfg.num_layers} layers, {n_params} "
          f"params ({model.cfg.param_dtype}) initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def tie_gaps(serving, model, params, prompt, tokens, tol,
             max_len: int = MAX_LEN, extra=None) -> list:
    """Feed the engine's tokens through the request-alone path (what
    ``generate`` runs: prefill of the bare prompt, then one-row decode
    steps; ``extra`` [1, ...] the request's image row) and return per
    position (best logit - logit of the engine's token, allowed gap
    rtol * |best| + atol)."""
    x = torch.tensor(prompt[None], dtype=torch.int64, device="cuda")
    logits, cache = serving.prefill(model, params, x, max_len, extra)
    rows = []
    for j, tok in enumerate(tokens):
        lg = logits[0, -1].float()
        best = lg.max()
        rows.append(((best - lg[tok]).item(),
                     (tol["rtol"] * best.abs() + tol["atol"]).item()))
        if j + 1 < len(tokens):
            nxt = torch.tensor([[tok]], dtype=torch.int32, device="cuda")
            logits, cache = model.decode_step(params, cache, nxt,
                                              int(prompt.size) + j)
    return rows


def decode_step_ms(spans: dict, steps: int) -> float:
    """Host time of a decode step: the ``decode`` span (dispatch) plus
    the ``sample`` span (the wait for the card's tokens)."""
    return (spans["decode"]["total_ms"] + spans["sample"]["total_ms"]) \
        / steps


class LaunchEvents:
    """Stands in for the decode-attention library inside a ``with``
    block and records a pair of CUDA events around every kernel launch
    (the C call that enqueues it, after the wrapper's host work), so
    the kernel's time on the serving path can be summed from the
    card's clock."""

    def __init__(self):
        from repro_torch.kernels import attention_decode as tad
        self.tad = tad
        self.lib = tad._lib()
        self.saved = None
        self.pairs = []

    def repro_attention_decode(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = self.lib.repro_attention_decode(*args)
        end.record()
        self.pairs.append((start, end))
        return rc

    def __enter__(self):
        self.saved = self.tad._lib
        self.tad._lib = lambda: self
        return self

    def __exit__(self, *exc):
        self.tad._lib = self.saved

    @property
    def calls(self) -> int:
        return len(self.pairs)

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def engine_vs_generate(label, serving, model, params, prompts, new,
                       results, picked, max_len, tol, extras=None) -> dict:
    """Engine == generate in bf16, up to bf16 ties, for the requests
    ``picked``: the engine pads and batches (prefill [4, S_bucket],
    decode [slots, 1]) where generate runs the bare request ([1, S],
    [1, 1]), so the matrix products round differently and a near-tie
    in the argmax may go either way. Where the tokens differ, the
    engine's tokens are fed through the alone path and each must be its
    argmax within ``tol``. ``extras`` maps a request to the extra row
    [1, ...] the engine gave it. Returns each request's tokens alone."""
    out = {}
    for i in picked:
        extra = None if extras is None else extras[i]
        alone = serving.generate(model, params, prompts[i][None],
                                 num_tokens=int(new[i]), max_len=max_len,
                                 extra_embeds=extra,
                                 device="cuda")[0].tolist()
        out[i] = alone
        eng_tokens = results[i].tokens
        if alone == eng_tokens:
            print(f"{label}: request {i} (prompt {len(prompts[i])}) alone "
                  f"through generate: same {len(alone)} greedy tokens",
                  flush=True)
            continue
        first = next(j for j, (a, b) in enumerate(zip(alone, eng_tokens))
                     if a != b)
        rows = tie_gaps(serving, model, params, prompts[i], eng_tokens,
                        tol, max_len, extra)
        ties = [(j, g, lim) for j, (g, lim) in enumerate(rows) if g > 0]
        worst = max(ties, key=lambda r: r[1] / r[2],
                    default=(first, 0.0, rows[first][1]))
        print(f"{label}: request {i} (prompt {len(prompts[i])}) alone "
              f"through generate: tokens differ from token {first}; the "
              f"engine's tokens fed through the alone path are its argmax "
              f"at {len(rows) - len(ties)} of {len(rows)} positions, and "
              f"within {worst[1]:.4f} of the best logit at token "
              f"{worst[0]} (allowed {worst[2]:.4f}, rtol=atol="
              f"{tol['rtol']:.4f}); gaps at the first ties: "
              f"{[round(g, 4) for _, g, _ in ties[:5]]}", flush=True)
        if any(g > lim for _, g, lim in ties):
            raise AssertionError(f"{label} request {i}: an engine token is "
                                 f"not the alone path's argmax within bf16 "
                                 f"tolerance")
    return out


def phase_serving(ops, serving, get_config, get_model, Tracer,
                  phase_summary, bf16_tol) -> dict:
    """The main path: bf16 gemma3-12b at full width and depth."""
    model = get_model(get_config("gemma3-12b"))
    params = init_checked(model)
    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats()
    results, stats, elapsed, launches = serve(
        engine(serving, model, params, tracer), ops)
    want = model.cfg.num_layers * stats["decode_steps"]
    if launches != want or stats["kernel_launches"] != launches:
        raise AssertionError(f"attention_decode launched {launches} times, "
                             f"expected {want} = {model.cfg.num_layers} "
                             f"layers x {stats['decode_steps']} decode "
                             f"steps")
    prompts, lens, new = traffic(model.cfg.vocab_size)
    generated = stats["tokens_generated"]
    spans = phase_summary(tracer.events())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serving: {len(results)} requests (prompts {lens.min()}-"
          f"{lens.max()}, {int(sum(lens > WINDOW))} longer than the "
          f"window), {generated} tokens in {elapsed:.3f} s = "
          f"{generated / elapsed:.2f} tok/s; {stats['decode_steps']} decode "
          f"steps, {launches} attention_decode launches; peak memory "
          f"{peak:.1f} GiB", flush=True)
    for name in ("prefill", "decode", "sample", "admit", "finish"):
        row = spans.get(name)
        if row:
            print(f"  span {name}: n={row['count']} "
                  f"total={row['total_ms']:.1f} ms "
                  f"mean={row['mean_us']:.0f} us", flush=True)
    step_ms = decode_step_ms(spans, stats["decode_steps"])
    print(f"serving: decode span mean {spans['decode']['mean_us'] / 1e3:.3f} "
          f"ms (dispatch) + sample span mean "
          f"{spans['sample']['mean_us'] / 1e3:.3f} ms (the wait for the "
          f"card) = {step_ms:.3f} ms per decode step", flush=True)

    # the attention kernel's share of a decode step: the same traffic
    # again, with a pair of CUDA events around every kernel launch
    timer = LaunchEvents()
    tracer2 = Tracer()
    with timer:
        _, stats2, _, _ = serve(engine(serving, model, params, tracer2),
                                ops)
    att_ms = timer.total_ms() / stats2["decode_steps"]
    step2_ms = decode_step_ms(phase_summary(tracer2.events()),
                              stats2["decode_steps"])
    if timer.calls != launches:
        raise AssertionError(f"{timer.calls} launches timed, {launches} in "
                             f"the first run of the same traffic")
    print(f"serving: attention_decode {att_ms:.3f} ms of the card per "
          f"decode step ({timer.calls} launches over "
          f"{stats2['decode_steps']} steps, CUDA events around each "
          f"launch) in a step of {step2_ms:.3f} ms in that run: "
          f"{att_ms / step2_ms:.1%} of a step", flush=True)

    engine_vs_generate("serving", serving, model, params, prompts, new,
                       results, picks(lens), MAX_LEN, bf16_tol)
    return {"launches": launches, "elapsed": elapsed,
            "generated": generated, "spans": spans, "step_ms": step_ms,
            "attention_ms_per_step": att_ms}


def phase_f32_full_width(ops, serving, get_config, get_model):
    """Engine == generate exactly: the same traffic through gemma3-12b
    at full width in f32 (no bf16 rounding to break ties), cut to
    ``PHASE5_LAYERS`` layers."""
    full = get_config("gemma3-12b")
    print(f"f32 gemma3-12b: reduced: num_layers {full.num_layers} -> "
          f"{PHASE5_LAYERS} (the script's time budget: phases 20-20c came "
          f"in; width as published)", flush=True)
    model = get_model(full.replace(num_layers=PHASE5_LAYERS,
                                   param_dtype="float32",
                                   compute_dtype="float32"))
    params = init_checked(model)
    results, stats, elapsed, launches = serve(
        engine(serving, model, params, None), ops)
    if launches != model.cfg.num_layers * stats["decode_steps"]:
        raise AssertionError(f"f32: {launches} launches for "
                             f"{stats['decode_steps']} decode steps")
    prompts, lens, new = traffic(model.cfg.vocab_size)
    print(f"f32: {len(results)} requests, {stats['tokens_generated']} "
          f"tokens in {elapsed:.3f} s", flush=True)
    for i in picks(lens):
        alone = serving.generate(model, params, prompts[i][None],
                                 num_tokens=int(new[i]), max_len=MAX_LEN,
                                 device="cuda")[0].tolist()
        if alone != results[i].tokens:
            first = next(j for j, (a, b) in enumerate(
                zip(alone, results[i].tokens)) if a != b)
            raise AssertionError(
                f"f32 request {i}: engine and generate differ from token "
                f"{first}: engine {results[i].tokens[first:first + 8]} "
                f"generate {alone[first:first + 8]}")
        print(f"f32: request {i} (prompt {lens[i]}) alone through "
              f"generate: same {len(alone)} greedy tokens", flush=True)


def phase_small_against_cpu(serving, get_smoke_config, get_model):
    """The same engine at smoke size in f32: kernel path on the card vs
    the plain path on the CPU, same weights, token for token."""
    model = get_model(get_smoke_config("gemma3-12b"))
    cpu_params = model.init(0, device="cpu")
    gpu_params = {
        "embed": {k: v.cuda() for k, v in cpu_params["embed"].items()},
        "layers": [{part: {k: v.cuda() for k, v in d.items()}
                    for part, d in layer.items()}
                   for layer in cpu_params["layers"]],
        "final_norm": {"scale": cpu_params["final_norm"]["scale"].cuda()}}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, size=n) for n in (5, 9, 3, 12, 7)]
    sc = serving.ServeConfig(slots=3, max_len=64, page_size=8,
                             prefill_batch=2)
    out = []
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = serving.Engine(model, params, sc, device=dev)
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.drain()
        out.append([eng.result(i).tokens for i in ids])
    if out[0] != out[1]:
        raise AssertionError(f"smoke-size engine: card {out[1]} != "
                             f"cpu {out[0]}")
    print(f"small: gemma3-12b smoke config f32, {len(prompts)} requests, "
          f"card (kernel) == cpu (plain) token for token", flush=True)


# --------------------------------------------------------------------------
# the training slice: the four segmented optimizer kernels
# --------------------------------------------------------------------------

SEG_KERNELS = {
    "seg_norm_lars": "src/repro/kernels/segmented_update.py:89",
    "seg_norm_lamb": "src/repro/kernels/segmented_update.py:103",
    "seg_apply_lars": "src/repro/kernels/segmented_update.py:136",
    "seg_apply_lamb": "src/repro/kernels/segmented_update.py:152",
}
SEG_SOURCE = "src/repro_torch/kernels/csrc/segmented_update.cu"
DEV = "cuda"               # the card (the training phases' device)
KERNEL_GROUPS = 4          # qwen2.5-3b's group axis, cut for the check
# Pass 1 against the plain version: both sum the same f32 squares in
# other orders (kernel: 4 per lane, a 32-lane butterfly, runs of <= 128
# rows, then <= ceil(chunks / 32) partials per lane; plain: PyTorch's
# row sums and index_add_). Positive terms, so each sum's relative error
# is at most its depth times 2^-24: about 2^-24 * 800 = 5e-5 for the
# 151936 x 2048 embeddings. Stated bound:
NORM_RTOL = 1e-4
OPT_HYPER = dict(eta=1e-3, weight_decay=5e-4, momentum=0.9, b1=0.9,
                 b2=0.999, eps=1e-6)
# mode cases of the kernel check: (name, mode, nesterov, trust_clip)
SEG_CASES = [("lars", "lars", False, None), ("lars-nesterov", "lars",
                                               True, None),
             ("lars-clip", "lars", False, 10.0),
             ("lars-nesterov-clip", "lars", True, 10.0),
             ("paper", "paper", False, None),
             ("lamb", "lamb", False, None), ("lamb-clip", "lamb", False,
                                              10.0)]
SEG_PRECISIONS = ("f32", "bf16_master", "bf16_master_sr")
FLOPS_PER_ELEMENT = {("norm", "lars"): 4, ("norm", "paper"): 4,
                     ("norm", "lamb"): 16, ("apply", "lars"): 8,
                     ("apply", "paper"): 7, ("apply", "lamb"): 17}


def seg_bound(which: str, mode: str, rows: int, itemsize: int,
              nseg: int) -> dict:
    """Least time of one pass over ``rows`` x 128 elements: every input
    read once, every output written once (in-place state counts a read
    and a write), against the f32 operations it does."""
    n = rows * 128
    nbuf = 2 if mode == "lamb" else 1
    ids = rows * 4
    if which == "norm":
        moved = (2 + (nbuf if mode == "lamb" else 0)) * n * itemsize \
            + ids + 2 * nseg * 4
    else:
        moved = (2 + nbuf) * n * itemsize + ids + 2 * nseg * 4 \
            + nbuf * n * itemsize + 4 * n
    flops = FLOPS_PER_ELEMENT[(which, mode)] * n
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    return {"bytes": moved, "flops": flops, "bound_ms": max(bytes_ms,
                                                            ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def qwen_tree(cfg, groups: int) -> dict:
    """qwen2.5-3b's parameter tree at its full widths, ``groups``
    layers deep, as meta tensors (shapes only)."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim_
    f, v = cfg.d_ff, cfg.vocab_size

    def t(*shape):
        return torch.empty(shape, device="meta")

    layer = {"norm1": {"scale": (d,)}, "norm2": {"scale": (d,)},
             "attn": {"wq": (d, h, hd), "wk": (d, hkv, hd),
                      "wv": (d, hkv, hd), "wo": (h, hd, d),
                      "bq": (h, hd), "bk": (hkv, hd), "bv": (hkv, hd)},
             "mlp": {"wi": (d, f), "wg": (d, f), "wo": (f, d)}}
    return {"embed": {"table": t(v, d), "head": t(d, v)},
            "final_norm": {"scale": t(d)},
            "layers": [{k: {n: t(*s) for n, s in part.items()}
                        for k, part in layer.items()}
                       for _ in range(groups)]}


def flat_problem(spec, mode: str, dtype, gen) -> tuple:
    """Random (w, g, bufs) flat buffers on the card with zero padding."""
    dev = torch.device(DEV)

    def rand(scale, positive=False):
        x = torch.randn((spec.num_rows, 128), generator=gen, device=dev,
                        dtype=torch.float32).mul_(scale)
        if positive:
            x.square_()
        x = x.to(dtype)
        flat = x.view(-1)
        used = 0
        for off, size, srows in zip(spec.row_offset, spec.sizes,
                                    spec.seg_rows):
            flat[off * 128 + size:(off + srows) * 128] = 0
            used = off + srows
        flat[used * 128:] = 0
        return x

    w, g = rand(0.02), rand(1e-3)
    bufs = (rand(1e-3), rand(1e-3, positive=True)) if mode == "lamb" \
        else (rand(1e-3),)
    return w, g, bufs


def seg_case(su, sref, spec, w, g, bufs, ids, adapt, mode, nesterov,
             trust_clip, sr: bool) -> dict:
    """One kernel-vs-plain case: table within NORM_RTOL and repeated
    bitwise; pass 2 on the kernel's table bitwise equal to the plain
    version. Returns the errors."""
    nseg = spec.num_segments
    h = OPT_HYPER
    dev = w.device
    bc1 = torch.tensor(0.271, device=dev)
    bc2 = torch.tensor(0.0039, device=dev)
    seed = torch.tensor(3, dtype=torch.int32, device=dev)
    lr = torch.tensor(0.35, device=dev)
    common = dict(b1=h["b1"], b2=h["b2"], eps=h["eps"], bc1=bc1, bc2=bc2)
    t1 = su.seg_norm_cuda(w, g, bufs, ids, nseg, mode=mode,
                          weight_decay=h["weight_decay"], **common)
    t2 = su.seg_norm_cuda(w, g, bufs, ids, nseg, mode=mode,
                          weight_decay=h["weight_decay"], **common)
    tp = su.seg_norm_ref(w, g, bufs, ids, nseg, mode=mode,
                         weight_decay=h["weight_decay"], **common)
    torch.cuda.synchronize()
    if not torch.equal(t1, t2):
        raise AssertionError(f"{mode}: pass-1 table differs between two "
                             f"launches")
    if not torch.isfinite(t1).all():
        raise AssertionError(f"{mode}: non-finite norms")
    norm_abs = (t1 - tp).abs().max().item()
    norm_rel = ((t1 - tp).abs() / tp.abs().clamp_min(1e-30)).max().item()
    if norm_rel > NORM_RTOL:
        raise AssertionError(f"{mode}: norms {norm_rel:.3e} relative from "
                             f"the plain version (bound {NORM_RTOL})")
    _, _, ratio = sref.trust_ratio(t1[0], t1[1], adapt, mode=mode,
                                   eta=h["eta"],
                                   weight_decay=h["weight_decay"],
                                   eps=h["eps"], trust_clip=trust_clip)
    table = sref.scales_from_ratio(ratio, adapt, lr, h["weight_decay"])
    apply_kw = dict(mode=mode, momentum=h["momentum"], nesterov=nesterov,
                    stochastic_round=sr, seed=seed, **common)
    kbufs = tuple(b.clone() for b in bufs)
    _, kdelta = su.seg_apply_cuda(w, g, kbufs, ids, table, **apply_kw)
    pbufs, pdelta = su.seg_apply_ref(w, g, bufs, ids, table, **apply_kw)
    torch.cuda.synchronize()
    apply_abs = (kdelta - pdelta).abs().max().item()
    for k, (a, b) in enumerate(zip(kbufs, pbufs)):
        apply_abs = max(apply_abs, (a.float() - b.float()).abs().max()
                        .item())
        if not torch.equal(a, b):
            raise AssertionError(f"{mode}: state {k} of pass 2 differs "
                                 f"from the plain version")
    if not torch.equal(kdelta, pdelta):
        raise AssertionError(f"{mode}: pass-2 delta differs from the "
                             f"plain version ({apply_abs:.3e})")
    del kbufs, pbufs, kdelta, pdelta
    return {"norm_abs": norm_abs, "norm_rel": norm_rel,
            "apply_abs": apply_abs, "table": table, "t": t1}


def phase_seg_kernels(su, sref, flatten, convert, get_config) -> dict:
    """The four kernels against their plain version: qwen2.5-3b's
    widths with the group axis cut to KERNEL_GROUPS layers, and a tree
    of many tiny segments (smaller than a row, straddling chunks)."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = get_config("qwen2.5-3b").replace(num_layers=KERNEL_GROUPS)
    big = qwen_tree(cfg, KERNEL_GROUPS)
    rng = np.random.RandomState(2)
    sizes = list(rng.randint(1, 200, size=300)) + [127, 128, 129, 256,
                                                   16383, 16385, 40000,
                                                   70001]
    tiny = {f"s{i:03d}": torch.empty((int(n),), device="meta")
            for i, n in enumerate(sizes)}
    tiny["m0"] = torch.empty((37, 29), device="meta")
    errs = {k: 0.0 for k in SEG_KERNELS}
    norm_rel = 0.0
    timings = {}
    for label, tree, segmenter in (
            ("qwen2.5-3b x4", big,
             lambda p: convert.segment_paths(cfg, p)),
            ("tiny segments", tiny, None)):
        for precision in SEG_PRECISIONS:
            dtype = torch.float32 if precision == "f32" else torch.bfloat16
            spec = flatten.build_spec(tree, dtype=dtype,
                                      segments=segmenter)
            ids = spec.segment_ids(dev)
            adapt = spec.adapt_mask(dev)
            sr = precision.endswith("_sr")
            for lamb in (False, True):
                w, g, bufs = flat_problem(spec, "lamb" if lamb else "lars",
                                          dtype, gen)
                case_rel = 0.0
                for name, mode, nesterov, clip in SEG_CASES:
                    if (mode == "lamb") != lamb:
                        continue
                    r = seg_case(su, sref, spec, w, g, bufs, ids, adapt,
                                 mode, nesterov, clip, sr)
                    norm_k, apply_k = su.KERNELS[mode]
                    errs[norm_k] = max(errs[norm_k], r["norm_abs"])
                    errs[apply_k] = max(errs[apply_k], r["apply_abs"])
                    norm_rel = max(norm_rel, r["norm_rel"])
                    case_rel = max(case_rel, r["norm_rel"])
                    if label.startswith("qwen") and name in ("lars",
                                                             "lamb"):
                        timings[(mode, precision)] = time_seg(
                            su, spec, w, g, bufs, ids, r["table"], mode,
                            sr)
                print(f"kernel segmented {label} {precision} "
                      f"{'lamb' if lamb else 'lars/paper'}: "
                      f"{spec.num_segments} segments, {spec.num_rows} "
                      f"rows; tables repeat bitwise (within "
                      f"{case_rel:.3e} of plain), pass 2 bitwise equal "
                      f"to plain", flush=True)
                del w, g, bufs
                torch.cuda.empty_cache()
    print(f"kernel segmented: pass-1 tables within {norm_rel:.3e} "
          f"relative of the plain version (bound {NORM_RTOL}); max abs "
          f"err {errs}", flush=True)
    for (mode, precision), t in sorted(timings.items()):
        for which in ("norm", "apply"):
            b = t[which]
            print(f"  {su.KERNELS[mode][which == 'apply']} "
                  f"{precision} at {KERNEL_GROUPS} layers: kernel "
                  f"{b['ms']:.4f} ms, plain {b['plain_ms']:.4f} ms, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                  f"{b['bytes']} B)", flush=True)
    return {"max_abs_err": errs, "norm_rel": norm_rel,
            "timings": timings}


def time_seg(su, spec, w, g, bufs, ids, table, mode, sr,
             iters: int = 10, plain_iters: int = 2) -> dict:
    """Kernel and plain times of both passes on these buffers (pass 2 in
    place on copies of the state), beside their bounds."""
    h = OPT_HYPER
    common = dict(b1=h["b1"], b2=h["b2"], eps=h["eps"], bc1=0.5, bc2=0.01)
    nseg = spec.num_segments
    kbufs = tuple(b.clone() for b in bufs)
    delta = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    apply_kw = dict(mode=mode, momentum=h["momentum"], stochastic_round=sr,
                    seed=1, **common)
    out = {}
    for which, kfn, pfn in (
            ("norm",
             lambda: su.seg_norm_cuda(w, g, bufs, ids, nseg, mode=mode,
                                      weight_decay=h["weight_decay"],
                                      **common),
             lambda: su.seg_norm_ref(w, g, bufs, ids, nseg, mode=mode,
                                     weight_decay=h["weight_decay"],
                                     **common)),
            ("apply",
             lambda: su.seg_apply_cuda(w, g, kbufs, ids, table,
                                       out_delta=delta, **apply_kw),
             lambda: su.seg_apply_ref(w, g, kbufs, ids, table,
                                      out_bufs=kbufs, out_delta=delta,
                                      **apply_kw))):
        b = seg_bound(which, mode, spec.num_rows, w.element_size(), nseg)
        b["ms"] = time_ms(kfn, iters)
        b["plain_ms"] = time_ms(pfn, plain_iters)
        out[which] = b
    return out


# --------------------------------------------------------------------------
# the third slice: the per-tensor LARS kernels and RMSNorm
# --------------------------------------------------------------------------

LARS_KERNELS = {
    "lars_norm2": "src/repro/kernels/lars_update.py:61",
    "lars_apply": "src/repro/kernels/lars_update.py:76",
}
LARS_SOURCE = "src/repro_torch/kernels/csrc/lars_update.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm.py:24"
RMS_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
LARS_HYPER = dict(eta=1e-3, weight_decay=5e-4, momentum_mu=0.9, eps=1e-9)
# the per-tensor norm against its plain version: two f32 sums of the
# same positive terms in other orders. Each addition rounds by at most
# 2^-24 of a partial sum no larger than the total; as independent
# errors they drift as a random walk, at most 2^-24 * sqrt(depth / 3)
# relative per sum. The kernel's depth is 32 terms a thread, 13 steps of
# block sum, ceil(blocks / 256) partials a thread and 13 more: 445 on
# the deepest segment checked, the full-width run's 36 x 22.5M-element
# MLP segment (99,072 blocks); PyTorch's reduction is taken as deep.
# Five standard deviations of the difference, 5 * 2^-24 * sqrt(2 * 445
# / 3) = 5.1e-6, rounded up. A dropped 8192-element chunk moves the
# embedding's sum by 2.6e-5 and the MLP segment's by 1.0e-5: both fail.
LARS_NORM_RTOL = 6e-6
LARS_FLOPS = {"norm": 4, "apply": 7}   # f32 operations per element


def lars_bound(which: str, ws, gs, segments: int) -> dict:
    """Least time of one pass over these members (of ``segments``
    segments): the bytes it must move against its f32 operations. The
    norm reads w and g once and writes two f32 sums a segment; the apply
    reads w, g, the f32 momentum, a segment's two sums and base_lr, and
    writes the momentum and the f32 delta."""
    n = sum(w.numel() for w in ws)
    moved = sum(w.numel() * w.element_size() + g.numel() * g.element_size()
                for w, g in zip(ws, gs)) + 8 * segments
    if which == "apply":
        moved += 12 * n + 4
    flops = LARS_FLOPS[which] * n
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    return {"bytes": moved, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def lars_case(lu, sref, segs, base_lr, nesterov: bool) -> dict:
    """One pass ``segs`` [(ws, gs, ms)], kernels against the plain pass:
    the norm table repeats bitwise and lies within LARS_NORM_RTOL of the
    plain sums; the apply fed the kernel's sums, each segment at column
    2 s + 1 of a wider table (other segments' columns between, as the
    tree path's table in the spec's order), is bitwise equal to the
    plain apply (momentum, delta and the telemetry table), compared
    segment by segment."""
    wg = [(ws, gs) for ws, gs, _ in segs]
    s1 = lu.lars_norm2_cuda(wg)
    s2 = lu.lars_norm2_cuda(wg)
    sp = sref.lars_norm2_pass(wg)
    torch.cuda.synchronize()
    if not torch.equal(s1, s2):
        raise AssertionError("per-tensor norm pass differs between two "
                             "launches")
    if not torch.isfinite(s1).all():
        raise AssertionError("per-tensor norm pass is not finite")
    rel = ((s1 - sp).abs() / sp.abs().clamp_min(1e-30)).max().item()
    if rel > LARS_NORM_RTOL:
        raise AssertionError(f"per-tensor norms {rel:.3e} relative from the "
                             f"plain pass (bound {LARS_NORM_RTOL})")
    wide = torch.zeros((2, 2 * len(segs)), dtype=torch.float32, device=DEV)
    wide[:, 1::2] = s1
    cols = [2 * j + 1 for j in range(len(segs))]
    km = [[m.clone() for m in ms] for _, _, ms in segs]
    kd, kstats = lu.lars_apply_cuda(
        [(ws, gs, m) for (ws, gs, _), m in zip(segs, km)], wide,
        base_lr=base_lr, nesterov=nesterov, stats=True, columns=cols,
        **LARS_HYPER)
    apply_abs, same = 0.0, True
    for j, seg in enumerate(segs):
        pm, pd, pst = sref.lars_apply_pass([seg], wide, base_lr,
                                           columns=[cols[j]],
                                           nesterov=nesterov, **LARS_HYPER)
        same = same and torch.equal(kstats[:, j], pst[:, 0])
        a = torch.cat([x.reshape(-1) for x in km[j] + kd[j]])
        b = torch.cat([x.reshape(-1) for x in pm[0] + pd[0]])
        apply_abs = max(apply_abs, (a - b).abs().max().item())
        same = same and torch.equal(a, b)
        del pm, pd, a, b
    if not same:
        raise AssertionError(f"per-tensor apply pass differs from the plain "
                             f"pass ({apply_abs:.3e})")
    return {"norm_abs": (s1 - sp).abs().max().item(), "norm_rel": rel,
            "apply_abs": apply_abs}


# w / g dtypes of the per-tensor check: the bf16 weights and gradients
# of the full-width run, f32, and bf16 weights with f32 gradients (the
# accumulated gradients of a run with microbatches)
LARS_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
               "f32": (torch.float32, torch.float32),
               "bf16-w f32-g": (torch.bfloat16, torch.float32)}


def lars_members(shapes_counts, wdtype, gdtype, gen) -> list:
    """A pass [(ws, gs, ms)] of random members on the card: w ~ 0.02 at
    ``wdtype``, g ~ 1e-3 at ``gdtype``, f32 momentum ~ 1e-3."""
    out = []
    for shape, count in shapes_counts:
        def rand(scale, dt):
            return [(torch.randn(shape, generator=gen, device=DEV)
                     * scale).to(dt) for _ in range(count)]
        out.append((rand(0.02, wdtype), rand(1e-3, gdtype),
                    rand(1e-3, torch.float32)))
    return out


def model_kernel_segments(arch: str, flatten, layerwise, get_config,
                          layers=None) -> list:
    """[(member shape, member count)] of ``arch``'s kernel segments at
    full width (``layers`` deep, else as published), in the spec's
    order."""
    from repro_torch.models import get_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    spec = flatten.build_spec(meta_params(cfg),
                              segments=get_model(cfg).segments)
    names = set(layerwise.kernel_segments(spec))
    return [(tuple(spec.shapes[i][1:]) if len(paths) > 1
             else tuple(spec.shapes[i]), len(paths))
            for i, (name, paths) in enumerate(zip(spec.names, spec.paths))
            if name in names]


def cnn_kernel_leaves(cnn, tree_leaves) -> list:
    """[(shape, 1)] of the CNN's kernel segments (``init_cnn``
    defaults): its leaves of two or more axes, one member each."""
    return [(tuple(x.shape), 1) for x in
            tree_leaves(cnn.init_cnn(0, device="cpu")) if x.dim() >= 2]


# 3c's passes: the pointers of a pass beyond the kernel parameter space
# (32,764 B) take 1,024 members of 4 pointers; 16 segments of 80 members
LARS_EDGES = [((9,), 1), ((3, 3), 1), ((8,), 1), ((13,), 3), ((129,), 2),
              ((8193,), 2), ((5, 7), 40)]
LARS_80 = [((96, 130), 80)]
LARS_WIDE = [((16, 24 + j), 80) for j in range(16)]
# a pass whose segments take the three (w, g) dtype pairs (mamba2-1.3b
# keeps some leaves in f32 beside bf16 ones)
LARS_MIXED = [(((256, 1024), 4), torch.bfloat16, torch.bfloat16),
              (((1000,), 2), torch.float32, torch.float32),
              (((33, 65), 3), torch.bfloat16, torch.float32),
              (((24, 1024), 4), torch.float32, torch.float32)]


def phase_lars_kernels(lu, sref, flatten, layerwise, convert, get_config,
                       cnn, tree_leaves) -> dict:
    """3c: the per-tensor passes against the plain pass, each in bf16,
    f32 and bf16-w / f32-g, heavy ball and nesterov: qwen2.5-3b's kernel
    segments with the group axis cut to KERNEL_GROUPS layers; the CNN's
    leaves (init_cnn defaults); the edges in one pass (9 elements, an
    unaligned member, 40 members of 35); a segment of 80 members; a pass
    of 1,280 members (40,960 B of pointers); then one pass of mixed
    (w, g) dtype pairs. Then both passes timed at
    size (b), whisper-large-v3's kernel segments at full width and depth
    in f32 (random members, as qwen's), and (c), the CNN's leaves."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    cfg = get_config("qwen2.5-3b").replace(num_layers=KERNEL_GROUPS)
    tree = qwen_tree(cfg, KERNEL_GROUPS)
    spec = flatten.build_spec(tree, segments=lambda p:
                              convert.segment_paths(cfg, p))
    names = set(layerwise.kernel_segments(spec))
    qwen = [(tuple(spec.shapes[i][1:]) if len(paths) > 1
             else tuple(spec.shapes[i]), len(paths))
            for i, (name, paths) in enumerate(zip(spec.names, spec.paths))
            if name in names]
    cnn_leaves = cnn_kernel_leaves(cnn, tree_leaves)
    base_lr = torch.tensor(0.35, device=DEV)
    errs = {k: 0.0 for k in LARS_KERNELS}
    norm_rel = 0.0
    timing = {}

    def check(segs, nesterov):
        nonlocal norm_rel
        r = lars_case(lu, sref, segs, base_lr, nesterov)
        errs["lars_norm2"] = max(errs["lars_norm2"], r["norm_abs"])
        errs["lars_apply"] = max(errs["lars_apply"], r["apply_abs"])
        norm_rel = max(norm_rel, r["norm_rel"])

    for label, cases in (("qwen2.5-3b x4", qwen), ("cnn", cnn_leaves),
                         ("edges", LARS_EDGES), ("80 members", LARS_80),
                         ("1280 members", LARS_WIDE)):
        for dname, (wdtype, gdtype) in LARS_DTYPES.items():
            segs = lars_members(cases, wdtype, gdtype, gen)
            if label == "edges":      # an unaligned member: scalar path
                buf = torch.randn(65, generator=gen, device=DEV)
                segs.append(([buf[1:].to(wdtype)],
                             [(buf[:64] * 1e-3).to(gdtype)],
                             [torch.randn(64, generator=gen, device=DEV)]))
            for nesterov in (False, True):
                check(segs, nesterov)
            members = sum(len(s[0]) for s in segs)
            print(f"kernel per-tensor {label} {dname}: one pass of "
                  f"{len(segs)} segments, {members} members "
                  f"({32 * members} B of pointers), "
                  f"{lu.pass_tiles(segs)} tiles, heavy ball and nesterov: "
                  f"sums repeat bitwise, apply bitwise equal to the plain "
                  f"pass", flush=True)
            if label == "cnn" and dname == "f32":
                timing["c"] = time_lars(lu, sref, segs, base_lr)
            del segs
            torch.cuda.empty_cache()
    segs = [seg for shape, wdt, gdt in LARS_MIXED
            for seg in lars_members([shape], wdt, gdt, gen)]
    for nesterov in (False, True):
        check(segs, nesterov)
    print(f"kernel per-tensor mixed dtype pairs: one pass of {len(segs)} "
          f"segments (bf16 / bf16, f32 / f32, bf16 / f32), heavy ball and "
          f"nesterov: sums repeat bitwise, apply bitwise equal to the plain "
          f"pass", flush=True)
    # (b): whisper-large-v3 at full width and depth in f32
    whisper = model_kernel_segments("whisper-large-v3", flatten, layerwise,
                                    get_config)
    segs = lars_members(whisper, torch.float32, torch.float32, gen)
    timing["b"] = time_lars(lu, sref, segs, base_lr)
    del segs
    torch.cuda.empty_cache()
    print(f"kernel per-tensor: norms within {norm_rel:.3e} relative of the "
          f"plain pass (bound {LARS_NORM_RTOL}); max abs err {errs}",
          flush=True)
    for size, t in sorted(timing.items()):
        print_lars_timing(f"({size}) "
                          + ("whisper-large-v3 f32" if size == "b"
                             else "CNN leaves f32"), t)
    return {"max_abs_err": errs, "norm_rel": norm_rel, "timing": timing}


def lars_step_times(norm, apply, segs) -> dict:
    """A whole step's norm and apply over ``segs`` [(ws, gs, ms)]:
    ``norm(wg)`` over [(ws, gs)] returns the step's sums, ``apply(segs,
    sums)`` the deltas (the port's two launches, or an older checkout's
    loop over the segments: ``tools/chip_compare.py --lars``). Each call
    takes the next of two sets of gradients, the second a copy at other
    addresses, as a trainer's step gets fresh gradients. Per pass: the
    card's ms (``device_ms``, a CUDA graph of 20 calls), eager ms
    (``time_ms`` of 5 calls: the host's work included), the bound and,
    beside the norm, ``torch._foreach_norm(ws + gs, dtype=float32)``
    over the same members: the nearest library call, which gives each
    member's norm and not the segments' sums, so not the same function.
    The apply runs in place on the momentum (values no longer
    checked)."""
    alt = [(ws, [g.clone() for g in gs], ms) for ws, gs, ms in segs]
    turns = itertools.cycle([segs, alt])
    sums = norm([(ws, gs) for ws, gs, _ in segs])
    ws_all = [w for ws, _, _ in segs for w in ws]
    gs_all = [g for _, gs, _ in segs for g in gs]
    out = {}
    for which, fn in (
            ("norm", lambda: norm([(ws, gs) for ws, gs, _ in next(turns)])),
            ("apply", lambda: apply(next(turns), sums))):
        b = lars_bound(which, ws_all, gs_all, len(segs))
        b.update(ms=device_ms(fn, iters=20), eager_ms=time_ms(fn, 5),
                 segments=len(segs), members=len(ws_all),
                 elements=sum(w.numel() for w in ws_all),
                 foreach_norm_ms=device_ms(lambda: torch._foreach_norm(
                     ws_all + gs_all, dtype=torch.float32), iters=20)
                 if which == "norm" else None)
        out[which] = b
    del alt
    return out


def time_lars(lu, sref, segs, base_lr, plain_iters: int = 1) -> dict:
    """Both passes over ``segs`` (one launch each, a whole step) timed
    by ``lars_step_times``, beside the plain pass's ms (eager, segment
    by segment)."""
    lr = torch.as_tensor(base_lr, dtype=torch.float32).to(DEV)
    out = lars_step_times(
        lu.lars_norm2_cuda,
        lambda s, sums: lu.lars_apply_cuda(s, sums, base_lr=lr,
                                           **LARS_HYPER), segs)
    wg = [(ws, gs) for ws, gs, _ in segs]
    sums = lu.lars_norm2_cuda(wg)

    def plain_apply():
        for j, seg in enumerate(segs):
            sref.lars_apply_pass([seg], sums, lr, columns=[j], **LARS_HYPER)

    for which, pfn in (("norm", lambda: [sref.lars_norm2(ws, gs)
                                         for ws, gs in wg]),
                       ("apply", plain_apply)):
        out[which].update(plain_ms=time_ms(pfn, plain_iters), launches=1)
    return out


def print_lars_timing(label: str, timing: dict) -> None:
    for which, t in timing.items():
        share = t["bound_ms"] / t["ms"]
        print(f"  lars_{'norm2' if which == 'norm' else which} {label}: "
              f"{t['segments']} segments, {t['members']} members, "
              f"{t['elements']} elements, one launch a step: card "
              f"{t['ms']:.4f} ms ({share:.0%} of the bound), eager "
              f"{t['eager_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B)"
              + (f", _foreach_norm {t['foreach_norm_ms']:.4f} ms (member "
                 f"norms: not the same function)" if which == "norm"
                 else ""), flush=True)


# RMSNorm at the shapes of the two configurations: gemma3-12b prefill
# (8 x 2048 rows of 3840) and qwen2.5-3b training (8 x 512 rows of 2048)
RMS_MAIN = [((8, 2048, 3840), torch.bfloat16), ((8, 2048, 3840),
                                                torch.float32),
            ((8, 512, 2048), torch.bfloat16), ((8, 512, 2048),
                                               torch.float32)]
RMS_EXTRA = [((5, 128), torch.bfloat16), ((3, 640), torch.float32),
             ((4, 8192), torch.bfloat16), ((2, 3, 1024), torch.float16),
             ((7, 2048), torch.float16), ((6, 2176), torch.bfloat16)]


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two tensors
    of one float dtype (same-sign values; 0 for equal)."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[a.dtype]
    ia = a.contiguous().view(bits).long()
    ib = b.contiguous().view(bits).long()
    return int((ia - ib).abs().max().item())


def phase_rmsnorm(rms, sref, ops) -> dict:
    """3d: RMSNorm against its plain version, repeated bitwise, at the
    shapes of RMS_MAIN and RMS_EXTRA; then its path, the public
    ``ops.rmsnorm`` driven once at each RMS_MAIN shape with the counts
    at 0; kernel, plain and one ``F.rms_norm`` call (the yardstick: the
    port never calls it) timed beside the bound."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    eps = 1e-6
    inputs = []
    max_err, worst_ulp = 0.0, {}
    for shape, dtype in RMS_MAIN + RMS_EXTRA:
        d = shape[-1]
        x = (torch.randn(shape, generator=gen, device=DEV) * 3.0).to(dtype)
        w = (torch.randn((d,), generator=gen, device=DEV) * 0.2).to(dtype)
        y1 = rms.rmsnorm_cuda(x, w, eps=eps)
        y2 = rms.rmsnorm_cuda(x, w, eps=eps)
        yp = sref.rmsnorm_ref(x, w, eps=eps)
        torch.cuda.synchronize()
        if not torch.equal(y1, y2):
            raise AssertionError(f"rmsnorm {shape} {dtype}: differs between "
                                 f"two launches")
        if not torch.isfinite(y1.float()).all():
            raise AssertionError(f"rmsnorm {shape} {dtype}: not finite")
        torch.testing.assert_close(y1.float(), yp.float(),
                                   **rms.rmsnorm_tolerance(dtype))
        max_err = max(max_err, (y1.float() - yp.float()).abs().max().item())
        key = str(dtype).split(".")[-1]
        worst_ulp[key] = max(worst_ulp.get(key, 0), ulp_gap(y1, yp))
        if (shape, dtype) in RMS_MAIN:
            inputs.append((x, w))
    # an x that is 8-byte but not 16-byte aligned: the narrow rows go to
    # the block-per-row kernel
    d = 2048
    x = (torch.randn((4 * d + 4,), generator=gen, device=DEV) * 3.0).to(
        torch.bfloat16)[4:].view(4, d)
    w = (torch.randn((d,), generator=gen, device=DEV) * 0.2).to(
        torch.bfloat16)
    if x.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    y1, y2 = rms.rmsnorm_cuda(x, w, eps=eps), rms.rmsnorm_cuda(x, w, eps=eps)
    yp = sref.rmsnorm_ref(x, w, eps=eps)
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError("rmsnorm unaligned: differs between launches")
    torch.testing.assert_close(y1.float(), yp.float(),
                               **rms.rmsnorm_tolerance(torch.bfloat16))
    max_err = max(max_err, (y1.float() - yp.float()).abs().max().item())
    print(f"kernel rmsnorm: {len(RMS_MAIN) + len(RMS_EXTRA) + 1} shapes "
          f"(d 128-8192, f32 / bf16 / f16, one x not 16-byte aligned) "
          f"repeat bitwise, within rmsnorm_tolerance of plain; max abs err "
          f"{max_err:.3e}, worst ulp gap {worst_ulp}", flush=True)
    ops.reset_launches()
    for x, w in inputs:
        ops.rmsnorm(x, w, eps=eps)
    torch.cuda.synchronize()
    launches = ops.launches["rmsnorm"]
    if launches != len(inputs) or sum(ops.launches.values()) != launches:
        raise AssertionError(f"ops.rmsnorm path: launches {ops.launches}")
    rows = []
    for (x, w), (shape, dtype) in zip(inputs, RMS_MAIN):
        d = shape[-1]
        w1 = (1.0 + w.float()).to(dtype)
        moved = rms.rmsnorm_bytes(x, w)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 5 * x.numel() / F32_FLOP_PER_S * 1e3
        plan = rms.rmsnorm_launch(x.numel() // d, d, aligned=True)

        def kernel():
            return rms.rmsnorm_cuda(x, w, eps=eps)

        def library():
            return torch.nn.functional.rms_norm(x, (d,), w1, eps)

        row = {"shape": f"{tuple(shape)} {str(dtype).split('.')[-1]}",
               "kernel": "narrow" if plan["narrow"] else "wide",
               "ms": device_ms(kernel),
               "eager_ms": time_ms(kernel, 50),
               "plain_ms": time_ms(lambda: sref.rmsnorm_ref(x, w, eps=eps),
                                   10),
               "library_ms": device_ms(library),
               "library_eager_ms": time_ms(library, 50),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "max_abs_err": (rms.rmsnorm_cuda(x, w, eps=eps).float()
                               - sref.rmsnorm_ref(x, w, eps=eps).float()
                               ).abs().max().item()}
        rows.append(row)
        print(f"  rmsnorm {row['shape']} ({row['kernel']} kernel, "
              f"{plan['blocks']} blocks of {plan['threads']}): "
              f"card time (CUDA graph): kernel {row['ms']:.4f} ms, "
              f"F.rms_norm {row['library_ms']:.4f} ms; eager, host "
              f"included: kernel {row['eager_ms']:.4f} ms, F.rms_norm "
              f"{row['library_eager_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {moved} B): "
              f"{row['bound_ms'] / row['ms']:.1%} of the bound", flush=True)
    mean = {k: sum(r[k] for r in rows) / len(rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"launches": launches, "max_abs_err": max_err, "rows": rows,
            "mean": mean, "worst_ulp": worst_ulp}


class LastStepCheck:
    """Stands in for ``ops.segmented_update`` during a training run and,
    at the run's last optimizer step, checks the kernels on the real
    buffers: the telemetry's per-segment w_norm / g_norm against
    ``torch.linalg.vector_norm`` in f32 of the same members, and the
    delta and new state of 4,096 random rows against the plain apply
    on the same table. Keeps the last call's buffers for timing."""

    def __init__(self, real, su, sref, steps: int):
        self.real, self.su, self.sref = real, su, sref
        self.steps = steps
        self.calls = 0
        self.report: dict = {}

    def _segment_norms(self, w2d, g2d, bufs, ids, kw):
        """f32 vector norms of every segment's w and b (b = g, or the
        wd-augmented Adam direction for lamb), chunked over rows."""
        counts = torch.bincount(ids.long(), minlength=len(kw["adapt_mask"]))
        ends = torch.cumsum(counts, 0).tolist()
        starts = [0] + ends[:-1]
        chunk = 1 << 20
        wn, bn = [], []
        for r0, r1 in zip(starts, ends):
            wsq = bsq = 0.0
            for c0 in range(r0, r1, chunk):
                c1 = min(r1, c0 + chunk)
                w = w2d[c0:c1].float()
                if kw["mode"] == "lamb":
                    d, _ = self.sref.direction(
                        "lamb", w, g2d[c0:c1].float(),
                        tuple(b[c0:c1].float() for b in bufs),
                        b1=kw["b1"], b2=kw["b2"], bc1=kw["bc1"],
                        bc2=kw["bc2"], eps=kw["eps"])
                    b = d + kw["weight_decay"] * w
                else:
                    b = g2d[c0:c1].float()
                wsq = wsq + torch.linalg.vector_norm(w) ** 2
                bsq = bsq + torch.linalg.vector_norm(b) ** 2
            wn.append(torch.sqrt(torch.as_tensor(wsq)))
            bn.append(torch.sqrt(torch.as_tensor(bsq)))
        return torch.stack(wn), torch.stack(bn)

    def __call__(self, w2d, g2d, bufs, *, delta=None, **kw):
        self.calls += 1
        if self.calls < self.steps:
            return self.real(w2d, g2d, bufs, delta=delta, **kw)
        torch.cuda.synchronize()
        self.report["peak_before_last_step"] = \
            torch.cuda.max_memory_allocated()
        ids = kw["seg_ids"]
        wn, bn = self._segment_norms(w2d, g2d, bufs, ids, kw)
        gen = torch.Generator(device=w2d.device).manual_seed(7)
        rows = torch.randint(0, w2d.shape[0], (4096,), generator=gen,
                             device=w2d.device)
        snap = (w2d[rows].clone(), g2d[rows].clone(),
                tuple(b[rows].clone() for b in bufs), ids[rows].clone())
        out = self.real(w2d, g2d, bufs, delta=delta, **kw)
        tel = out[2]
        torch.cuda.synchronize()
        rel = max(((tel["w_norm"] - wn).abs() / wn.clamp_min(1e-30))
                  .max().item(),
                  ((tel["g_norm"] - bn).abs() / bn.clamp_min(1e-30))
                  .max().item())
        if not rel <= NORM_RTOL:
            raise AssertionError(f"last step: telemetry norms {rel:.3e} "
                                 f"relative from vector_norm")
        table = self.sref.scales_from_ratio(
            tel["trust_ratio"], kw["adapt_mask"], kw["base_lr"],
            kw["weight_decay"])
        pbufs, pdelta = self.su.seg_apply_ref(
            snap[0], snap[1], snap[2], snap[3], table, rows=rows,
            mode=kw["mode"], momentum=kw["momentum"],
            nesterov=kw["nesterov"], b1=kw["b1"], b2=kw["b2"],
            eps=kw["eps"], bc1=kw["bc1"], bc2=kw["bc2"],
            stochastic_round=kw["stochastic_round"], seed=kw["seed"])
        err = (pdelta - out[1][rows]).abs().max().item()
        same = torch.equal(pdelta, out[1][rows]) and all(
            torch.equal(a, b[rows]) for a, b in zip(pbufs, out[0]))
        if not same:
            raise AssertionError(f"last step: the delta / state of 4096 "
                                 f"rows differ from the plain apply "
                                 f"({err:.3e})")
        self.report.update(norm_rel=rel, rows_abs_err=err,
                           buffers=(w2d, g2d, out[0], out[1], ids,
                                    table), kw=kw)
        return out


def tree_params(cfg) -> int:
    """The model's tensor elements, counted on the reference layout's
    template: ``param_count()`` leaves out the QKV biases and
    undercounts the ssm and hybrid trees (F8)."""
    from repro_torch.core.base import tree_leaves
    from repro_torch.models import jax_template
    return sum(t.numel() for t in tree_leaves(jax_template(cfg)))


def phase_train_full(run, ops, su, sref, tree_leaves, argv: list,
                     label: str, want_layers: int = 36,
                     inspect=None) -> dict:
    """One full-width run (qwen2.5-3b unless ``argv`` names an
    ``--arch``) through ``launch.train.run`` with the last step
    checked, then both kernels timed on its buffers. ``inspect(out)``
    sees the run's result before its state is freed; what it returns
    is kept under ``"inspect"``."""
    steps = int(argv[argv.index("--steps") + 1])
    check = LastStepCheck(ops.segmented_update, su, sref, steps)
    ops.reset_launches()
    ops.segmented_update = check
    try:
        out = run(argv + ["--device", DEV, "--layerwise-every", "1"],
                  log_fn=lambda line: print(f"  {label}: {line}",
                                            flush=True))
    finally:
        ops.segmented_update = check.real
    launches = dict(ops.launches)
    mode = check.report["kw"]["mode"]
    norm_k, apply_k = su.KERNELS[mode]
    want = {k: 0 for k in launches}
    want.update({norm_k: steps, apply_k: steps})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} (1 norm + 1 apply per step)")
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: losses {out['losses']}")
    cfg = out["model"].cfg
    n_params = sum(x.numel() for x in tree_leaves(out["state"].params))
    if cfg.num_layers != want_layers or n_params != tree_params(cfg):
        raise AssertionError(f"{label}: {cfg.num_layers} layers, "
                             f"{n_params} params")
    peak = out["peak_memory_bytes"] or 0
    seen = inspect(out) if inspect else None
    print(f"train {label}: {cfg.arch_id} {cfg.num_layers} layers, "
          f"{n_params} "
          f"params ({cfg.param_dtype}); losses "
          f"{[round(x, 4) for x in out['losses']]}; per step loss+grad "
          f"{[round(x * 1e3, 1) for x in out['loss_grad_seconds']]} ms, "
          f"optimizer {[round(x * 1e3, 1) for x in out['optimizer_seconds']]}"
          f" ms; peak {peak / 2**30:.2f} GiB ({peak} B; before the "
          f"checked step {check.report['peak_before_last_step']} B); "
          f"launches {norm_k}={launches[norm_k]} "
          f"{apply_k}={launches[apply_k]}; last step: telemetry norms "
          f"within {check.report['norm_rel']:.3e} of vector_norm, 4096 "
          f"rows bitwise equal to the plain apply; {smi_line()}",
          flush=True)
    del out

    # the two kernels at the main path's shapes, on its buffers (the
    # run is over: pass 2 may overwrite the state)
    w2d, g2d, bufs, delta, ids, table = check.report["buffers"]
    kw = check.report["kw"]
    nseg = len(kw["adapt_mask"])
    common = dict(b1=kw["b1"], b2=kw["b2"], eps=kw["eps"], bc1=kw["bc1"],
                  bc2=kw["bc2"])
    apply_kw = dict(mode=mode, momentum=kw["momentum"],
                    nesterov=kw["nesterov"],
                    stochastic_round=kw["stochastic_round"],
                    seed=kw["seed"], **common)
    rows = w2d.shape[0]
    res = {}
    for which, name, kfn, pfn in (
            ("norm", norm_k,
             lambda: su.seg_norm_cuda(w2d, g2d, bufs, ids, nseg, mode=mode,
                                      weight_decay=kw["weight_decay"],
                                      **common),
             lambda: su.seg_norm_ref(w2d, g2d, bufs, ids, nseg, mode=mode,
                                     weight_decay=kw["weight_decay"],
                                     **common)),
            ("apply", apply_k,
             lambda: su.seg_apply_cuda(w2d, g2d, bufs, ids, table,
                                       out_delta=delta, **apply_kw),
             lambda: su.seg_apply_ref(w2d, g2d, bufs, ids, table,
                                      out_bufs=bufs, out_delta=delta,
                                      **apply_kw))):
        b = seg_bound(which, mode, rows, w2d.element_size(), nseg)
        b["ms"] = time_ms(kfn, 5)
        b["plain_ms"] = time_ms(pfn, 1)
        b["launches"] = launches[name]
        res[name] = b
        print(f"  {name} at the main path's shapes ({rows} rows, "
              f"{w2d.dtype}): kernel {b['ms']:.4f} ms, plain "
              f"{b['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, {b['bytes']} B)", flush=True)
    res[apply_k]["rows_abs_err"] = check.report["rows_abs_err"]
    res["inspect"] = seen
    res["peak_gib"] = peak / GIB
    return res


class LarsLastStepCheck:
    """Stands in for ``ops.lars_apply`` during a per-tensor training run
    (the optimizer takes every kernel segment's sums with one
    ``ops.lars_norm2`` pass, then applies them all in one pass) and
    checks every kernel segment of the run's last optimizer step: the
    sums it is handed (the counted norm launch's, at the segment's
    column) must have square roots within LARS_NORM_RTOL / 2 of
    ``torch.linalg.vector_norm`` of the members (a square root halves a
    relative error), the segment's column of the counted apply's
    telemetry table must equal the plain ratio from those sums, and
    4,096 random elements of its new momentum and delta must equal the
    plain apply on the same sums (bitwise). Keeps the last step's pass
    for timing (without its gradients when ``keep_grads`` is False, so
    that they are freed with the step)."""

    def __init__(self, real, lu, sref, steps: int, *,
                 keep_grads: bool = True):
        self.real, self.lu, self.sref = real, lu, sref
        self.keep_grads = keep_grads
        self.last_from = steps - 1
        self.calls = 0
        self.segments: list = []
        self.base_lr = None
        self.norm_rel = 0.0
        self.elem_abs = 0.0
        self.peak_before_last_step = None

    def __call__(self, segments, sums, **kw):
        self.calls += 1
        if self.calls <= self.last_from:
            return self.real(segments, sums, **kw)
        torch.cuda.synchronize()
        self.peak_before_last_step = torch.cuda.max_memory_allocated()
        segs = [tuple(list(xs) for xs in seg) for seg in segments]
        cols = list(range(len(segs)) if kw.get("columns") is None
                    else kw["columns"])
        sums = sums.clone()
        picks = []
        for j, (ws, gs, ms) in enumerate(segs):
            n = ws[0].numel()
            gen = torch.Generator(device=DEV).manual_seed(1000 * self.calls
                                                          + j)
            idx = torch.randint(0, n * len(ws), (4096,), generator=gen,
                                device=DEV)
            pick = (idx // n, idx % n)
            picks.append(pick + (tuple(self._pick(pick, xs)
                                       for xs in (ws, gs, ms)),))
        out = self.real(segments, sums, **kw)
        torch.cuda.synchronize()
        kw_ratio = dict(eta=kw["eta"], weight_decay=kw["weight_decay"],
                        eps=kw["eps"])
        stats = out[1]
        for j, ((ws, gs, ms), c, pick) in enumerate(zip(segs, cols, picks)):
            wn = torch.sqrt(sum(torch.linalg.vector_norm(x.float()) ** 2
                                for x in ws))
            gn = torch.sqrt(sum(torch.linalg.vector_norm(x.float()) ** 2
                                for x in gs))
            pwn, pgn, pratio, scale = self.sref.lars_ratio(
                sums[:, c], kw["base_lr"], **kw_ratio)
            rel = max(((pwn - wn).abs() / wn).item(),
                      ((pgn - gn).abs() / gn.clamp_min(1e-30)).item())
            self.norm_rel = max(self.norm_rel, rel)
            if not rel <= LARS_NORM_RTOL / 2:
                raise AssertionError(f"last step, segment {j}: per-tensor "
                                     f"norms {rel:.3e} relative from "
                                     f"vector_norm (bound "
                                     f"{LARS_NORM_RTOL / 2})")
            if not torch.equal(stats[:, j], torch.stack([pwn, pgn, pratio])):
                raise AssertionError(f"last step, segment {j}: telemetry "
                                     f"differs from the plain ratio of the "
                                     f"kernel's sums")
            snap = pick[2]
            pm, pd = self.sref.lars_apply(
                snap[0], snap[1], snap[2], scale,
                weight_decay=kw["weight_decay"],
                momentum_mu=kw["momentum_mu"], nesterov=kw["nesterov"])
            km, kd = self._pick(pick, ms), self._pick(pick, out[0][j])
            self.elem_abs = max(self.elem_abs, (pd - kd).abs().max().item(),
                                (pm - km).abs().max().item())
            if not (torch.equal(pm, km) and torch.equal(pd, kd)):
                raise AssertionError(f"last step, segment {j}: 4096 "
                                     f"elements differ from the plain "
                                     f"apply ({self.elem_abs:.3e})")
        self.segments = [(ws, gs if self.keep_grads else None, ms)
                         for ws, gs, ms in segs]
        self.base_lr = kw["base_lr"]
        return out

    @staticmethod
    def _pick(pick, xs) -> torch.Tensor:
        """The 4,096 elements ``pick`` = (member, offset) of ``xs``."""
        member, off = pick[0], pick[1]
        vals = torch.empty(4096, dtype=xs[0].dtype, device=DEV)
        for k, x in enumerate(xs):
            sel = member == k
            vals[sel] = x.reshape(-1)[off[sel]]
        return vals


def meta_params(cfg) -> dict:
    """The port's parameter tree for ``cfg`` as meta tensors (shapes
    only), from the family's own init."""
    from repro_torch.models.registry import FAMILIES
    return FAMILIES[cfg.family][0](cfg, torch.Generator(),
                                   torch.device("meta"))


def phase_train_per_tensor(run, ops, lu, sref, layerwise, flatten,
                           tree_leaves, argv: list, label: str,
                           want_layers: int = 36) -> dict:
    """7c: a full-width run (qwen2.5-3b unless ``argv`` names an
    ``--arch``) through ``launch.train.run`` with the per-tensor path:
    exactly one launch of each kernel per step over every kernel
    segment, the last step's segments checked, then both passes and the
    plain pass timed on the last step's own tensors (size (a) of the
    qwen2.5-3b run)."""
    steps = int(argv[argv.index("--steps") + 1])
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv \
        else "qwen2.5-3b"
    model = get_model(get_config(arch))
    names = layerwise.kernel_segments(
        flatten.build_spec(meta_params(model.cfg), segments=model.segments))
    check = LarsLastStepCheck(ops.lars_apply, lu, sref, steps)
    ops.reset_launches()
    ops.lars_apply = check
    try:
        out = run(argv + ["--device", DEV, "--layerwise-every", "1"],
                  log_fn=lambda line: print(f"  {label}: {line}",
                                            flush=True))
    finally:
        ops.lars_apply = check.real
    launches = dict(ops.launches)
    want = {k: 0 for k in launches}
    want.update({"lars_norm2": steps, "lars_apply": steps})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} (one pass of {len(names)} kernel "
                             f"segments x {steps} steps)")
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: losses {out['losses']}")
    cfg = out["model"].cfg
    n_params = sum(x.numel() for x in tree_leaves(out["state"].params))
    if cfg.num_layers != want_layers or len(check.segments) != len(names):
        raise AssertionError(f"{label}: {cfg.num_layers} layers, "
                             f"{len(check.segments)} checked segments")
    peak = out["peak_memory_bytes"] or 0
    print(f"train {label}: {cfg.arch_id} {cfg.num_layers} layers, "
          f"{n_params} params ({cfg.param_dtype}); {len(names)} kernel "
          f"segments in one pass; "
          f"losses {[round(x, 4) for x in out['losses']]}; per step "
          f"loss+grad "
          f"{[round(x * 1e3, 1) for x in out['loss_grad_seconds']]} ms, "
          f"optimizer {[round(x * 1e3, 1) for x in out['optimizer_seconds']]}"
          f" ms; peak {peak / 2**30:.2f} GiB ({peak} B; before the checked "
          f"step {check.peak_before_last_step} B); launches lars_norm2="
          f"{launches['lars_norm2']} lars_apply={launches['lars_apply']}; "
          f"last step: norms within {check.norm_rel:.3e} of vector_norm, "
          f"telemetry equal to the plain ratio, 4096 elements per segment "
          f"bitwise equal to the plain apply; {smi_line()}", flush=True)
    del out
    timing = time_lars(lu, sref, check.segments, check.base_lr)
    print_lars_timing(f"at {label}'s shapes", timing)
    res = {}
    for which, name in (("norm", "lars_norm2"), ("apply", "lars_apply")):
        res[name] = dict(timing[which], launches=launches[name],
                         max_abs_err=check.elem_abs if which == "apply"
                         else 0.0)
    return res


def phase_train_small_against_cpu(get_smoke_config, get_model,
                                  build_optimizer, training, lm_iterator,
                                  tree_leaves, tree_map, ops, su, layerwise,
                                  flatten):
    """The qwen2.5-3b smoke LM in f32: 3 fused TVLARS, 3 fused LAMB and
    (8b) 3 per-tensor WA-LARS steps on the card (kernels) against the
    CPU (plain versions), same weights and batches. Stated bounds, at
    each leaf's scale: TVLARS and WA-LARS 1e-5 on losses and params
    (the CPU tests' bound against the JAX package); LAMB 1e-4 on losses
    and 1e-3 on params, because its Adam direction m/(sqrt(v) + eps)
    turns a last-bit gradient difference at |g| ~ eps into a visible
    one (the port and the JAX package on the CPU already differ by
    9.6e-5 after 3 steps)."""
    model = get_model(get_smoke_config("qwen2.5-3b"))
    for name, use_kernel in (("tvlars", "fused"), ("lamb", "fused"),
                             ("wa-lars", "per_tensor")):
        cpu = model.init(0, device="cpu")
        results = []
        for dev, params in (("cpu", cpu),
                            (DEV, tree_map(lambda t: t.to(DEV), cpu))):
            params = tree_map(lambda t: t.detach().clone(), params)
            opt = build_optimizer(name, total_steps=10, learning_rate=2.0,
                                  batch_size=8, use_kernel=use_kernel,
                                  segments=model.segments, device=dev)
            state = training.TrainState.create(params, opt)
            step = training.make_train_step(training.lm_task(model), opt)
            batches = lm_iterator(8, 64, model.cfg.vocab_size, seed=1,
                                  device=dev)
            ops.reset_launches()
            losses = []
            for _ in range(3):
                state, m = step(state, next(batches))
                losses.append(float(m["loss"]))
            results.append((losses, state.params, dict(ops.launches)))
        (lc, pc, kc), (lg, pg, kg) = results
        if use_kernel == "fused":
            kernels = su.KERNELS["lamb" if name == "lamb" else "lars"]
            per_step = 1
        else:
            kernels = ("lars_norm2", "lars_apply")
            per_step = 1       # one pass over every kernel segment
        want = {k: 0 for k in kg}
        want.update({k: 3 * per_step for k in kernels})
        if kg != want or any(kc.values()):
            raise AssertionError(f"small {name}: launches cpu {kc} card "
                                 f"{kg}, expected {want}")
        loss_rtol, param_rtol = (1e-4, 1e-3) if name == "lamb" \
            else (1e-5, 1e-5)
        np.testing.assert_allclose(lg, lc, rtol=loss_rtol)
        worst = 0.0
        for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
            a, b = a.detach().cpu().numpy(), b.detach().numpy()
            scale = float(np.abs(b).max())
            worst = max(worst, float(np.abs(a - b).max()) / scale)
            np.testing.assert_allclose(a, b, rtol=param_rtol,
                                       atol=param_rtol * scale)
        print(f"small train: qwen2.5-3b smoke f32 {use_kernel} {name}, 3 "
              f"steps ({want[kernels[0]]} launches of each kernel): card "
              f"(kernels) == cpu (plain) within {param_rtol} (losses "
              f"{[round(x, 6) for x in lg]}, worst param gap "
              f"{worst:.3e} of its leaf's scale)", flush=True)


# the paper's ordering at large B (benchmarks/paper_runs.py:22-24)
PAPER_ORDER = ("tvlars", "wa-lars", "nowa-lars", "lamb")


def phase_paper_loop(classify, cnn, core, training, synthetic, ops,
                     layerwise, flatten, tree_leaves, tree_map) -> dict:
    """9: the classifier and Barlow-Twins loops on the card at the
    examples' settings, each optimizer's accuracy and LNR summary, and
    whether the reference's ordering holds with the port's samples
    (reported, not enforced); then the CNN at init_cnn defaults, 20
    WA-LARS steps through the per-tensor kernels, each step's update
    held against the tree path's from the same state."""
    t0 = time.perf_counter()
    res = classify.run(["--device", DEV], log_fn=lambda line: print(
        f"paper loop: {line}", flush=True))
    for name, r in res["classification"].items():
        if not np.isfinite(r["final_loss"]) or not r["summary"] or not all(
                np.isfinite(v) for v in r["summary"].values()):
            raise AssertionError(f"paper loop {name}: final loss "
                                 f"{r['final_loss']}, summary "
                                 f"{r['summary']}")
    out = {"classification": {k: r["accuracy"] for k, r
                              in res["classification"].items()},
           "ssl": res["ssl"]}
    if set(out["classification"]) != set(PAPER_ORDER) \
            or set(out["ssl"]) != set(PAPER_ORDER):
        raise AssertionError(f"paper loop ran {sorted(out['ssl'])}, not "
                             f"{sorted(PAPER_ORDER)}")
    for task in ("classification", "ssl"):
        accs = out[task]
        if not all(0.0 <= a <= 1.0 for a in accs.values()):
            raise AssertionError(f"paper loop {task}: accuracies {accs}")
        ranking = sorted(accs, key=lambda k: -accs[k])
        holds = all(accs[a] > accs[b] for a, b in zip(PAPER_ORDER,
                                                      PAPER_ORDER[1:]))
        print(f"paper loop {task}: ranking "
              f"{' > '.join(f'{k} {accs[k]:.4f}' for k in ranking)}; the "
              f"reference's ordering {' > '.join(PAPER_ORDER)} "
              f"{'holds' if holds else 'does NOT hold'}", flush=True)
    print(f"paper loop: {time.perf_counter() - t0:.1f} s on the card",
          flush=True)

    # the CNN's many small leaves through the per-tensor kernels. Each
    # step's per-tensor update is held against the tree path's update
    # from the same params, gradients and state (a copy): the two round
    # scale*(g + wd*w) and sg*g + sw*w differently and sum the norms in
    # other orders, so the stated bound is the reference's per-tensor
    # bound, 2e-5 of each leaf's update scale. Free-running trajectories
    # are not compared: at this LR the 1-D leaves take raw steps of
    # lr*g, and a last-bit difference grows from step to step.
    data = synthetic.ClassificationData(seed=7)
    hyper = dict(total_steps=20, learning_rate=1.0, batch_size=256,
                 base_batch_size=64, device=DEV)
    pt_opt = core.build_optimizer("wa-lars", use_kernel="per_tensor",
                                  **hyper)
    tree_opt = core.build_optimizer("wa-lars", **hyper)
    gaps = []

    def paired_update(grads, state, params):
        copy = type(state)(state.step.clone(),
                           tree_map(lambda t: t.clone(), state[1]))
        tu, _ = tree_opt.update(grads, copy, params)
        pu, new_state = pt_opt.update(grads, state, params)
        gaps.append(max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(tree_leaves(pu), tree_leaves(tu))))
        return pu, new_state

    opt = core.GradientTransform(pt_opt.init, paired_update)
    params = cnn.init_cnn(0, device=DEV)
    state = training.TrainState.create(params, opt)
    step = training.make_classifier_step(cnn.apply_cnn, opt)
    batches = synthetic.batch_iterator(data, 256, seed=3, device=DEV)
    ops.reset_launches()
    losses = []
    for _ in range(20):
        state, m = step(state, next(batches))
        losses.append(float(m["loss"]))
    launches = dict(ops.launches)
    n_adapt = len(layerwise.kernel_segments(flatten.build_spec(params)))
    want = {k: 0 for k in launches}
    want.update({"lars_norm2": 20, "lars_apply": 20})
    if launches != want:
        raise AssertionError(f"cnn: launches {launches}, expected {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"cnn: losses {losses}")
    if max(gaps) > 2e-5:
        raise AssertionError(f"cnn: per-tensor update {max(gaps):.3e} of "
                             f"its scale from the tree path's")
    print(f"paper loop: CNN (init_cnn defaults, {n_adapt} ADAPT leaves, "
          f"{sum(x.numel() for x in tree_leaves(params))} params) 20 "
          f"WA-LARS steps B=256 through the per-tensor kernels "
          f"({launches['lars_norm2']} + {launches['lars_apply']} "
          f"launches, one pass a step): losses {losses[0]:.4f} -> {losses[-1]:.4f}; each "
          f"step's update within {max(gaps):.3e} of the tree path's from "
          f"the same state (bound 2e-5)", flush=True)
    out["launches"] = launches
    return out


# phase 10: the sharpness diagnostics at full width. Stated bounds:
# sam_sharpness >= -SAM_FLOOR_REL * loss on the bf16 model (the
# perturbation's first-order term is >= 0 even after rounding each
# perturbed weight to bf16; the rest is the bf16 loss's own rounding),
# HVP asymmetry |u.Hv - v.Hu| / (|u| |Hv|) <= HVP_SYM_BF16 (one bf16
# unit, 2^-8), lambda_max >= alpha_1 - LANCZOS_EIGH_TOL * max|T| (the
# largest eigenvalue of T is at least its (1,1) entry; eigh in f32)
SAM_FLOOR_REL = 1e-3
# phase 10's depth: cut from 36 to 18 when phase 16 pushed the script
# past its time aim, to 9 when phases 17-17d came in, to 2 when phases
# 20-20c did (ROADMAP "Time budgets")
PHASE10_LAYERS = 2
# phase 5's depth (4 of gemma3-12b's local:global groups of 6): cut from
# 48 when phases 20-20c came in (the script's time budget)
PHASE5_LAYERS = 24
HVP_SYM_BF16 = 2.0 ** -8
LANCZOS_EIGH_TOL = 1e-5
# phase 10b, the smoke LM in f32, card against the CPU's plain path: a
# vector's (HVP, Lanczos alpha/beta, loss slice) largest gap relative to
# its largest entry, a scalar's gap relative to itself. The CPU tests'
# 1e-4 bound on LM gradients against the JAX package; SAM sharpness is a
# difference of two losses and the noise scale a ratio of differences of
# squared norms, so 1e-3 of their own size
SMALL_F32_RTOL = {"hvp": 1e-4, "lanczos": 1e-4, "sam": 1e-3, "gns": 1e-3,
                  "slice": 1e-5}


def state_checksum(state, tree_leaves) -> list:
    """Per tensor of the params and the optimizer state: the sum of its
    bit patterns and of their squares (int64, wrapping), which any
    change of a bit moves."""
    out = []
    for t in tree_leaves(state.params) + tree_leaves(state.opt_state):
        if not isinstance(t, torch.Tensor):
            out.append((repr(t),))
            continue
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.int8}[t.element_size()]
        b = t.detach().reshape(-1).view(bits).to(torch.int64)
        out.append((int(b.sum()), int((b * b).sum())))
        del b
    return out


class ProbeWatch:
    """Wraps a probe class's ``__call__`` during a run: at each call the
    launch counts, the state's checksum and the card's time around it,
    and for a Lanczos probe the first Rayleigh quotient alpha_1 beside
    the probe's top eigenvalue."""

    def __init__(self, cls, ops, tree_leaves):
        self.cls, self.ops, self.tree_leaves = cls, ops, tree_leaves
        self.real = cls.__call__
        self.calls: list = []
        watch = self

        def call(probe, step, state):
            torch.cuda.synchronize()
            before = dict(ops.launches)
            csum = state_checksum(state, tree_leaves)
            t0 = time.perf_counter()
            raw = probe.dispatch(step, state)
            out = probe.resolve(raw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec = {"step": step, "out": out, "seconds": seconds,
                   "launches_before": before,
                   "launches_after": dict(ops.launches),
                   "unchanged": state_checksum(state, tree_leaves) == csum}
            if hasattr(raw, "alphas"):
                rec["alpha1"] = float(raw.alphas[0])
                rec["t_max"] = float(max(raw.alphas.abs().max(),
                                         raw.betas.abs().max()))
            watch.calls.append(rec)
            return out

        cls.__call__ = call

    def restore(self):
        self.cls.__call__ = self.real


def check_one_pass(label: str, launches: dict) -> None:
    """``launches`` of one per-tensor step: one ``lars_norm2`` and one
    ``lars_apply`` launch (the step's pass over every kernel segment)
    and nothing else."""
    want = {k: 0 for k in launches}
    want.update({"lars_norm2": 1, "lars_apply": 1})
    if launches != want:
        raise AssertionError(f"{label}: launches of one per-tensor step "
                             f"{launches}, expected {want}")


def check_probe_calls(label: str, calls: list, per_step: dict) -> None:
    """Every probe call: no launch inside it, the state bitwise unchanged
    and, given ``per_step`` launches of each kernel, exactly (step + 1)
    steps' launches before it (the probe runs after its step)."""
    for c in calls:
        if c["launches_after"] != c["launches_before"]:
            raise AssertionError(f"{label}: probe at step {c['step']} "
                                 f"launched kernels: {c['launches_before']}"
                                 f" -> {c['launches_after']}")
        if not c["unchanged"]:
            raise AssertionError(f"{label}: probe at step {c['step']} "
                                 f"changed the params or optimizer state")
        if per_step is not None:
            want = {k: per_step.get(k, 0) * (c["step"] + 1)
                    for k in c["launches_before"]}
            if c["launches_before"] != want:
                raise AssertionError(f"{label}: launches before the probe "
                                     f"at step {c['step']} "
                                     f"{c['launches_before']}, expected "
                                     f"{want}")


def phase_sharpness_full(run, ops, lu, sref, layerwise, flatten,
                         tree_leaves, diag, synthetic, training,
                         argv: list, label: str,
                         layers: int = 36) -> dict:
    """10: qwen2.5-3b at full width (``layers`` of its 36 layers: the
    caller cuts the launcher's config with ``depth_cut``; bf16, seed 0)
    through ``launch.train.run`` with per-tensor WA-LARS and a Lanczos
    lambda_max
    probe after each of its steps (held batch stacked like the run, 4
    iterations, no reorthogonalization): one launch of each per-tensor
    kernel per step and none inside a probe; params and momentum
    bitwise unchanged by every probe; a finite lambda_max at every step
    in the JSONL, which the port's ``validate_jsonl`` accepts;
    lambda_max >= alpha_1. Then, on the final state, a SAM and a
    noise-scale probe (finite, same launch and checksum checks) and the
    HVP's symmetry for two seeded directions. Prints the span times,
    one matvec's time and the peak memory; times the per-tensor kernels
    on the run's params and momentum (a random bf16 gradient of the
    same shapes: the step's own gradients are freed before the probe)."""
    steps = int(argv[argv.index("--steps") + 1])
    k = int(argv[argv.index("--global-batch") + 1]) \
        // int(argv[argv.index("--microbatch") + 1])
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    model = get_model(get_config("qwen2.5-3b"))
    per_step = {"lars_norm2": 1, "lars_apply": 1}    # one pass a step
    check = LarsLastStepCheck(ops.lars_apply, lu, sref, steps,
                              keep_grads=False)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.lars_apply = check
    watch = ProbeWatch(diag.LanczosProbe, ops, tree_leaves)
    tmp = tempfile.mkdtemp(prefix="phase10_")
    JSONL_DIRS.append(tmp)
    metrics = f"{tmp}/metrics.jsonl"
    try:
        out = run(argv + ["--device", DEV, "--layerwise-every", "1",
                          "--metrics-out", metrics],
                  log_fn=lambda line: print(f"  {label}: {line}",
                                            flush=True))
    finally:
        ops.lars_apply = check.real
        watch.restore()
    launches = dict(ops.launches)
    want = {k_: 0 for k_ in launches}
    want.update({k_: steps * n for k_, n in per_step.items()})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    if [c["step"] for c in watch.calls] != list(range(steps)):
        raise AssertionError(f"{label}: probes ran at "
                             f"{[c['step'] for c in watch.calls]}")
    check_probe_calls(label, watch.calls, per_step)
    n_records = diag.validate_jsonl(metrics)
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    lam = {r["step"]: r["lanczos/lambda_max"] for r in recs
           if "lanczos/lambda_max" in r}
    if sorted(lam) != list(range(steps)) or not all(
            v is not None and np.isfinite(v) for v in lam.values()):
        raise AssertionError(f"{label}: lambda_max records {lam}")
    for c in watch.calls:
        lm = c["out"]["lambda_max"]
        if lm < c["alpha1"] - LANCZOS_EIGH_TOL * c["t_max"]:
            raise AssertionError(f"{label}: step {c['step']} lambda_max "
                                 f"{lm} < alpha_1 {c['alpha1']}")
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: losses {out['losses']}")
    cfg = out["model"].cfg
    if cfg.num_layers != layers or cfg.param_dtype != "bfloat16":
        raise AssertionError(f"{label}: {cfg.num_layers} layers "
                             f"{cfg.param_dtype}")
    state = out["state"]
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    print(f"sharpness {label}: qwen2.5-3b {cfg.num_layers} layers, "
          f"{n_params} params ({cfg.param_dtype}), K={k}; losses "
          f"{[round(x, 4) for x in out['losses']]}; lambda_max "
          f"{[lam[i] for i in range(steps)]}, alpha_1 "
          f"{[c['alpha1'] for c in watch.calls]}; per step "
          f"loss+grad {[round(x * 1e3, 1) for x in out['loss_grad_seconds']]}"
          f" ms, optimizer "
          f"{[round(x * 1e3, 1) for x in out['optimizer_seconds']]} ms, "
          f"probe {[round(x * 1e3, 1) for x in out['probe_seconds']]} ms; "
          f"launches {launches['lars_norm2']} + {launches['lars_apply']} "
          f"(none inside the probes); params and momentum bitwise "
          f"unchanged by every probe; {n_records} JSONL records valid; "
          f"peak through training and probes "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    # SAM and noise-scale probes on the final state, the same checks
    task = training.lm_task(out["model"])
    ptoks, plabels = synthetic.lm_batch(torch.Generator().manual_seed(997),
                                        8, 512, cfg.vocab_size, device=DEV)
    pbatch = synthetic.stack_microbatches({"tokens": ptoks,
                                           "labels": plabels}, k)
    res = {}
    for cls, probe in ((diag.SharpnessProbe,
                        diag.SharpnessProbe(task, pbatch, every=1, rho=0.05,
                                            accum_steps=k)),
                       (diag.GradNoiseProbe,
                        diag.GradNoiseProbe(task, pbatch, accum_steps=k,
                                            every=1))):
        w = ProbeWatch(cls, ops, tree_leaves)
        try:
            r = probe(steps - 1, state)
        finally:
            w.restore()
        check_probe_calls(f"{label} {probe.name}", w.calls, None)
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label} {probe.name}: {r}")
        res[probe.name] = (r, w.calls[0]["seconds"])
    sam = res["sharpness"][0]
    if sam["sam_sharpness"] < -SAM_FLOOR_REL * abs(sam["loss"]):
        raise AssertionError(f"{label}: sam_sharpness "
                             f"{sam['sam_sharpness']} below -"
                             f"{SAM_FLOOR_REL} x loss")
    print(f"sharpness {label}: SAM (rho 0.05) {sam} in "
          f"{res['sharpness'][1]:.2f} s; noise scale {res['gns'][0]} in "
          f"{res['gns'][1]:.2f} s; launches none, state unchanged",
          flush=True)

    # the HVP's symmetry for two seeded directions, and one matvec's time;
    # one f32 direction lives beside its product at a time (each is
    # drawn again from its seed when it is needed a second time)
    from repro_torch.diagnostics.lanczos import vdot
    gc.collect()
    torch.cuda.empty_cache()
    op = diag.make_flat_hvp(task, state.params, pbatch, accum_steps=k)
    csum = state_checksum(state, tree_leaves)

    def direction(seed):
        return diag.probes.seed_vector(op.spec, seed, DEV).view(-1)

    def dot(seed, x):
        d = direction(seed)
        return float(vdot(d, x.view(-1)))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hv = op.matvec(direction(2))
    torch.cuda.synchronize()
    matvec_s = time.perf_counter() - t0
    hv_norm = float(torch.sqrt(vdot(hv.view(-1), hv.view(-1))))
    u_hv = dot(1, hv)
    del hv
    hu = op.matvec(direction(1))
    v_hu = dot(2, hu)
    del hu
    u = direction(1)
    u_norm = float(torch.sqrt(vdot(u, u)))
    del u
    asym = abs(u_hv - v_hu) / (u_norm * hv_norm)
    if not asym <= HVP_SYM_BF16:
        raise AssertionError(f"{label}: HVP asymmetry {asym:.3e} > "
                             f"{HVP_SYM_BF16:.3e}")
    if state_checksum(state, tree_leaves) != csum:
        raise AssertionError(f"{label}: the HVPs changed the state")
    peak = torch.cuda.max_memory_allocated()
    lg = out["loss_grad_seconds"]
    print(f"sharpness {label}: HVP u.Hv {u_hv:.6e} v.Hu {v_hu:.6e}, "
          f"asymmetry {asym:.3e} of |u||Hv| (bound {HVP_SYM_BF16:.3e}); "
          f"one matvec {matvec_s * 1e3:.1f} ms ({matvec_s / lg[-1]:.2f}x "
          f"the last loss+grad step); peak {peak / 2**30:.2f} GiB "
          f"({peak} B)", flush=True)

    # the per-tensor passes on this run's params and momentum
    gen = torch.Generator(device=DEV).manual_seed(5)
    segs = [(ws, [1e-3 * torch.randn(w.shape, generator=gen, device=DEV)
                  .to(w.dtype) for w in ws], ms)
            for ws, _, ms in check.segments]
    timing = time_lars(lu, sref, segs, check.base_lr)
    print_lars_timing("at phase 10's shapes", timing)
    kernels = {name: dict(timing[which], launches=launches[name])
               for which, name in (("norm", "lars_norm2"),
                                   ("apply", "lars_apply"))}
    return {"lambda_max": [lam[i] for i in range(steps)], "peak": peak,
            "matvec_s": matvec_s, "kernels": kernels,
            "probe_seconds": out["probe_seconds"]}


def phase_sharpness_small_against_cpu(get_smoke_config, get_model, diag,
                                      synthetic, training, tree_map) -> None:
    """10b: the qwen2.5-3b smoke LM in f32 on the card against the CPU's
    plain path, same weights and batch (K = 4): the flat HVP, Lanczos
    alpha/beta from the same v0 (8 iterations, reorthogonalized),
    sam_sharpness, gradient_noise_scale and a 1-D loss slice along one
    filter-normalized direction, each within SMALL_F32_RTOL of its own
    scale."""
    from repro_torch.diagnostics.lanczos import lanczos
    model = get_model(get_smoke_config("qwen2.5-3b"))
    task = training.lm_task(model)
    cpu = model.init(0, device="cpu")
    toks, labels = synthetic.lm_batch(torch.Generator().manual_seed(11), 8,
                                      64, model.cfg.vocab_size, device="cpu")
    batch = synthetic.stack_microbatches({"tokens": toks, "labels": labels},
                                         4)
    spec = diag.hvp.build_spec(task, cpu)
    v0 = diag.probes.seed_vector(spec, 3, "cpu")
    direction = diag.filter_normalized_direction(
        torch.Generator().manual_seed(4), cpu)
    alphas = [-0.5, -0.1, 0.0, 0.1, 0.5]
    got = {}
    for dev in ("cpu", DEV):
        params = tree_map(lambda t: t.to(dev), cpu)
        b = tree_map(lambda t: t.to(dev), batch)
        op = diag.make_flat_hvp(task, params, b, accum_steps=4)
        res = lanczos(op.matvec, v0.to(dev), 8)
        sam = diag.sam_sharpness(task, params, b, accum_steps=4)
        gns = diag.gradient_noise_scale(task, params, b, accum_steps=4)
        got[dev] = {
            "hvp": op.matvec(v0.to(dev)).cpu(),
            "lanczos": torch.cat([res.alphas, res.betas]).cpu(),
            "sam": torch.stack([sam["sam_sharpness"], sam["loss"]]).cpu(),
            "gns": torch.stack([gns[k_] for k_ in sorted(gns)]).cpu(),
            "slice": diag.loss_slice_1d(
                task, params, tree_map(lambda t: t.to(dev), direction), b,
                alphas, accum_steps=4).cpu()}
    worst = {}
    for key, rtol in SMALL_F32_RTOL.items():
        a, c = got[DEV][key], got["cpu"][key]
        if key in ("sam", "gns"):
            worst[key] = float(((a - c).abs() / c.abs()).max())
        else:
            worst[key] = float((a - c).abs().max() / c.abs().max())
        if not worst[key] <= rtol:
            raise AssertionError(f"small sharpness {key}: card {a} cpu {c}: "
                                 f"{worst[key]:.3e} of its scale > {rtol}")
    print(f"sharpness small: qwen2.5-3b smoke f32 K=4, card == cpu within "
          f"{ {k_: f'{v:.2e}' for k_, v in worst.items()} } of each "
          f"quantity's scale (bounds {SMALL_F32_RTOL}); lambda_max via "
          f"alpha/beta {float(diag.top_k_eigenvalues(got[DEV]['lanczos'][:8], got[DEV]['lanczos'][8:])[0]):.6f}",
          flush=True)


def phase_sharpness_bench(sharpness_launch, diag) -> dict:
    """10c: ``launch.sharpness.run`` on the card at its defaults (the
    bench's MLP, B = 256, LR 1.0, 40 steps, probes every 5, SLQ 4 x 16
    x 64), both JSONL files of each optimizer validated; the early-phase
    lambda_max of WA-LARS and TVLARS and their ratio are reported, not
    gated (the JAX bench recorded about 1.25)."""
    tmp = tempfile.mkdtemp(prefix="phase10c_")
    JSONL_DIRS.append(tmp)
    t0 = time.perf_counter()
    res = sharpness_launch.run(["--device", DEV, "--out", tmp],
                               log_fn=lambda line: print(
                                   f"sharpness bench: {line}", flush=True))
    for opt, paths in res["paths"].items():
        for path in paths:
            diag.validate_jsonl(path)
        if not all(np.isfinite(lam) for _, lam in res["trajectories"][opt]):
            raise AssertionError(f"sharpness bench {opt}: "
                                 f"{res['trajectories'][opt]}")
    print(f"sharpness bench: early lambda_max WA-LARS "
          f"{res['early']['wa-lars']:.4f}, TVLARS {res['early']['tvlars']:.4f},"
          f" ratio {res['ratio']:.4f} (reported; the JAX bench: about "
          f"1.25); {time.perf_counter() - t0:.1f} s on the card", flush=True)
    return res


# --------------------------------------------------------------------------
# the sixth slice: the adaptive-batch controller, its streams and the
# paper's experiment launchers
# --------------------------------------------------------------------------

# phase 11's memory, predicted before the first chip run (PERF.md §5):
# bf16 params 6.33 + f32 momentum 12.66 + the f32 gradient accumulator
# of K microbatches 12.66 + the fused update's packed params, packed
# gradients and f32 delta (12.66 each, freed after each update) =
# 69.63 GiB at the optimizer, beside one 1 x 512 microbatch
PHASE11_PREDICTED_GIB = 69.63
# 11b's bound on the noise scale card against CPU: phase 10b's
# (SMALL_F32_RTOL["gns"]); losses and params as phase 8 (1e-5 at each
# leaf's scale); a K switch against a fresh run at the new K: 1e-6
# absolute (the reference's test_k_switch_parity_with_fresh_run)
SWITCH_PARITY_ATOL = 1e-6


def batch_checksum(batch) -> tuple:
    """Per leaf of an LM batch: its shape, the sum of its values and the
    sum of its values weighted by their positions (int64)."""
    out = []
    for key in sorted(batch):
        t = batch[key].detach().reshape(-1).to(torch.int64)
        w = torch.arange(1, t.numel() + 1, device=t.device)
        out.append((key, tuple(batch[key].shape), int(t.sum()),
                    int((t * w).sum())))
    return tuple(out)


class MethodWatch:
    """Wraps ``cls.<name>`` during a run, calling ``record(self, args,
    result, before, after)`` with the launch counts around each call."""

    def __init__(self, cls, name: str, ops, record):
        self.cls, self.name, self.real = cls, name, getattr(cls, name)
        real = self.real

        def call(obj, *args, **kw):
            before = dict(ops.launches)
            result = real(obj, *args, **kw)
            record(obj, args, result, before, dict(ops.launches))
            return result

        setattr(cls, name, call)

    def restore(self):
        setattr(self.cls, self.name, self.real)


def phase_adaptive_full(run, ops, su, pipeline, synthetic, schedules,
                        training, diag, argv: list, label: str) -> dict:
    """11: the adaptive-batch controller on qwen2.5-3b at full width (36
    layers, bf16, seed 0) through ``launch.train.run`` with fused TVLARS
    in f32, a noise-scale probe every 2 steps and the batch free in
    [1, 16] x 512 tokens, streamed through a prefetching producer. At
    least one controller switch; ``controller/lr`` on each switch equal
    to ``batch_scaled_lr`` at its batch; exactly one segmented norm and
    one apply launch per step at every visited K, none inside the
    controller; one step built per visited K; the batches the run took
    through ``--prefetch 2`` equal, by checksum, those of the plain
    stream retargeted at the same steps. Prints the step time per K and
    the peak beside its prediction."""
    steps = int(argv[argv.index("--steps") + 1])
    seq = int(argv[argv.index("--seq") + 1])
    lr = 2.0
    calls, boundaries = [], []
    seg_watch = ops.segmented_update

    def counting(*args, **kw):
        before = dict(ops.launches)
        out = seg_watch(*args, **kw)
        calls.append((kw["mode"], before, dict(ops.launches)))
        return out

    ctrl_watch = MethodWatch(
        training.AdaptiveBatchController, "__call__", ops,
        lambda obj, args, result, before, after: boundaries.append(
            (args[0], before, after, result)))
    sums: list = []
    next_watch = MethodWatch(
        pipeline.PrefetchingStream, "__next__", ops,
        lambda obj, args, result, before, after: sums.append(
            batch_checksum(result)))
    tmp = tempfile.mkdtemp(prefix="phase11_")
    JSONL_DIRS.append(tmp)
    metrics = f"{tmp}/metrics.jsonl"
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    ops.segmented_update = counting
    try:
        out = run(argv + ["--device", DEV, "--metrics-out", metrics],
                  log_fn=lambda line: print(f"  {label}: {line}",
                                            flush=True))
    finally:
        ops.segmented_update = seg_watch
        ctrl_watch.restore()
        next_watch.restore()
    launches = dict(ops.launches)
    ctrl = out["controller"]
    batches = [int(b) for b in out["global_batches"]]
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: losses {out['losses']}")
    cfg = out["model"].cfg
    # launches: one norm and one apply per step at every K, none inside
    # the controller's boundaries
    if len(calls) != steps:
        raise AssertionError(f"{label}: {len(calls)} optimizer updates in "
                             f"{steps} steps")
    norm_k, apply_k = su.KERNELS[calls[0][0]]
    per_k: dict = {}
    for i, (_, before, after) in enumerate(calls):
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        want = {k: 0 for k in after}
        want.update({norm_k: 1, apply_k: 1})
        if delta != want:
            raise AssertionError(f"{label}: step {i} (global batch "
                                 f"{batches[i]}) launched {delta}")
        per_k.setdefault(batches[i], 0)
        per_k[batches[i]] += 1
    want = {k: 0 for k in launches}
    want.update({norm_k: steps, apply_k: steps})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    for step, before, after, _ in boundaries:
        if before != after:
            raise AssertionError(f"{label}: the controller at step {step} "
                                 f"launched kernels: {before} -> {after}")
    # the controller: switches, the LR of each, steps built once per K
    recs = out["controller_records"]
    if [r["step"] for r in recs] != [b[0] for b in boundaries]:
        raise AssertionError(f"{label}: controller records at "
                             f"{[r['step'] for r in recs]}")
    switches = [r for r in recs if r["controller/changed"] == 1.0]
    if not switches:
        raise AssertionError(f"{label}: no controller switch; noise scale "
                             f"{[r['controller/b_noise'] for r in recs]}")
    for r in switches:
        want_lr = schedules.batch_scaled_lr(
            lr, int(r["controller/global_batch"]), 256)
        if r["controller/lr"] != want_lr:
            raise AssertionError(f"{label}: switch at step {r['step']} lr "
                                 f"{r['controller/lr']} != batch_scaled_lr "
                                 f"{want_lr}")
    if ctrl.compiles != len(ctrl.visited_ks) \
            or set(ctrl.visited_ks) != set(per_k):
        raise AssertionError(f"{label}: {ctrl.compiles} steps built for "
                             f"Ks {ctrl.visited_ks}, steps ran at {per_k}")
    # prefetching changed no batch: the plain stream, retargeted at the
    # same steps, gives the same checksums
    plain = pipeline.MicrobatchedStream(
        synthetic.lm_sample_source(seq, cfg.vocab_size, seed=0,
                                   device=DEV), 1)
    for i, b in enumerate(batches):
        plain.set_accum_steps(b)
        if batch_checksum(next(plain)) != sums[i]:
            raise AssertionError(f"{label}: step {i}'s prefetched batch "
                                 f"differs from the plain stream's")
    n_records = diag.validate_jsonl(metrics)
    if cfg.num_layers != 36 or cfg.param_dtype != "bfloat16":
        raise AssertionError(f"{label}: {cfg.num_layers} layers "
                             f"{cfg.param_dtype}")
    peak = out["peak_memory_bytes"]
    seconds = {}
    for i, b in enumerate(batches):
        seconds.setdefault(b, []).append(
            round((out["loss_grad_seconds"][i]
                   + out["optimizer_seconds"][i]) * 1e3, 1))
    moves = [(r["step"], int(r["controller/global_batch"]),
              r["controller/lr"]) for r in switches]
    print(f"adaptive {label}: qwen2.5-3b {cfg.num_layers} layers "
          f"({cfg.param_dtype}); global batch per step {batches}; "
          f"switches (step, batch, lr) {moves} (each lr == "
          f"batch_scaled_lr); noise scale "
          f"{[round(r['controller/b_noise'], 2) for r in recs]}; visited K "
          f"{list(ctrl.visited_ks)}, {ctrl.compiles} steps built; launches "
          f"{norm_k}={launches[norm_k]} {apply_k}={launches[apply_k]} (1 + 1 "
          f"per step at every K, none in the controller's "
          f"{len(boundaries)} boundaries); {len(sums)} prefetched batches "
          f"== the plain stream's; {n_records} JSONL records valid; losses "
          f"{[round(x, 4) for x in out['losses']]}", flush=True)
    print(f"adaptive {label}: step ms (loss+grad + optimizer) by global "
          f"batch {seconds}; optimizer ms "
          f"{[round(x * 1e3, 1) for x in out['optimizer_seconds']]}; "
          f"controller ms "
          f"{[round(x * 1e3, 1) for x in out['controller_seconds']]}; peak "
          f"{peak / 2**30:.2f} GiB ({peak} B; predicted "
          f"{PHASE11_PREDICTED_GIB} GiB)", flush=True)
    return {"launches": {norm_k: launches[norm_k],
                         apply_k: launches[apply_k]},
            "peak": peak, "switches": switches}


def adaptive_smoke_run(dev, model, cpu_params, *, pipeline, synthetic,
                       training, diag, build_optimizer, tree_map,
                       sinks, steps: int = 6):
    """The smoke LM through ``fit(controller=)`` on ``dev``: fused
    TVLARS f32, microbatch 2, batch in [2, 32], a noise-scale probe
    (K = 4 microbatches of 2 x 64 from seed 998) every 2 steps."""
    task = training.lm_task(model)
    params = tree_map(lambda t: t.detach().clone().to(dev), cpu_params)
    toks, labels = synthetic.lm_batch(torch.Generator().manual_seed(998),
                                      8, 64, model.cfg.vocab_size,
                                      device=dev)
    ctrl = training.AdaptiveBatchController(
        lambda opt, k: training.make_train_step(task, opt, accum_steps=k),
        lambda b: build_optimizer("tvlars", total_steps=10,
                                  learning_rate=2.0, batch_size=b,
                                  use_kernel="fused",
                                  segments=model.segments, device=dev),
        diag.GradNoiseProbe(task, pipeline.stack_microbatches(
            {"tokens": toks, "labels": labels}, 4), accum_steps=4,
            every=2),
        training.ControllerConfig(microbatch=2, batch_min=2, batch_max=32,
                                  every=2), init_batch=4, base_lr=2.0)
    stream = pipeline.MicrobatchedStream(
        synthetic.lm_sample_source(64, model.cfg.vocab_size, seed=0,
                                   device=dev), 2)
    mem = sinks.MemorySink()
    state = training.TrainState.create(params, ctrl.optimizer())
    state, hist = training.fit(None, state, stream, steps,
                               options=training.FitOptions(
                                   sink=mem, controller=ctrl))
    recs = [r for r in mem.records if "controller/changed" in r]
    return hist, state, recs, ctrl


def phase_adaptive_small(get_smoke_config, get_model, pipeline, synthetic,
                         training, diag, build_optimizer, tree_leaves,
                         tree_map, ops, su, sinks) -> None:
    """11b: the smoke LM in f32 on the card. (1) A scripted retarget
    after 3 steps (K 2 -> 8) against a fresh run at K = 8 from a copy of
    the same state and the same stream position: params within
    SWITCH_PARITY_ATOL. (2) ``fit(controller=)`` with the noise probe, 6
    steps on the card against the CPU's plain path from the same
    weights: losses and params within 1e-5 (phase 8's bound), each
    boundary's noise scale within SMALL_F32_RTOL["gns"] (phase 10b's)
    and the same decisions; one norm and one apply launch per step on
    the card, none on the CPU."""
    model = get_model(get_smoke_config("qwen2.5-3b"))
    task = training.lm_task(model)
    cpu = model.init(0, device="cpu")

    def factory(b):
        return build_optimizer("tvlars", total_steps=10, learning_rate=2.0,
                               batch_size=b, use_kernel="fused",
                               segments=model.segments, device=DEV)

    def source():
        return synthetic.lm_sample_source(64, model.cfg.vocab_size, seed=0,
                                          device=DEV)

    ctrl = training.AdaptiveBatchController(
        lambda opt, k: training.make_train_step(task, opt, accum_steps=k),
        factory, lambda step, state: {"grad_noise_scale": 1.0},
        training.ControllerConfig(microbatch=2, batch_min=2, batch_max=32,
                                  every=100), init_batch=4, base_lr=2.0)
    stream = pipeline.MicrobatchedStream(source(), 2)
    ctrl.attach(stream)
    state = training.TrainState.create(
        tree_map(lambda t: t.detach().clone().to(DEV), cpu),
        ctrl.optimizer())
    for _ in range(3):
        state, _ = ctrl.step_fn()(state, next(stream))
    copy = training.TrainState(
        state.step, tree_map(lambda t: t.detach().clone(), state.params),
        tree_map(lambda t: t.clone(), state.opt_state))
    pos = stream.position
    if not ctrl.retarget(16):
        raise AssertionError("11b: retarget to 16 changed nothing")
    for _ in range(3):
        state, _ = ctrl.step_fn()(state, next(stream))
    fresh_step = training.make_train_step(task, factory(16), accum_steps=8)
    fresh_stream = pipeline.MicrobatchedStream(source(), 2, accum_steps=8,
                                               position=pos)
    fresh = copy
    for _ in range(3):
        fresh, _ = fresh_step(fresh, next(fresh_stream))
    gap = max(float((a - b).detach().abs().max()) for a, b in zip(
        tree_leaves(state.params), tree_leaves(fresh.params)))
    if not gap <= SWITCH_PARITY_ATOL:
        raise AssertionError(f"11b: K switch vs fresh run {gap:.3e}")

    res = {}
    for dev in ("cpu", DEV):
        ops.reset_launches()
        res[dev] = adaptive_smoke_run(
            dev, model, cpu, pipeline=pipeline, synthetic=synthetic,
            training=training, diag=diag, build_optimizer=build_optimizer,
            tree_map=tree_map, sinks=sinks) + (dict(ops.launches),)
    (hc, sc, rc, cc, kc), (hg, sg, rg, cg, kg) = res["cpu"], res[DEV]
    norm_k, apply_k = su.KERNELS["paper"]
    want = {k: 0 for k in kg}
    want.update({norm_k: 6, apply_k: 6})
    if kg != want or any(kc.values()):
        raise AssertionError(f"11b: launches cpu {kc} card {kg}")
    np.testing.assert_allclose([h["loss"] for h in hg],
                               [h["loss"] for h in hc], rtol=1e-5)
    worst = 0.0
    for a, b in zip(tree_leaves(sg.params), tree_leaves(sc.params)):
        a, b = a.detach().cpu().numpy(), b.detach().numpy()
        scale = float(np.abs(b).max())
        worst = max(worst, float(np.abs(a - b).max()) / scale)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
    gns = [abs(a["controller/b_noise"] - b["controller/b_noise"])
           / abs(b["controller/b_noise"]) for a, b in zip(rg, rc)]
    if [r["controller/global_batch"] for r in rg] != \
            [r["controller/global_batch"] for r in rc] \
            or not max(gns) <= SMALL_F32_RTOL["gns"]:
        raise AssertionError(f"11b: controller card {rg} cpu {rc}")
    print(f"adaptive small: smoke LM f32 fused TVLARS; K switch 2 -> 8 "
          f"after 3 steps == a fresh K=8 run from the same state within "
          f"{gap:.3e} (bound {SWITCH_PARITY_ATOL}); fit(controller=) 6 "
          f"steps card == cpu: worst param gap {worst:.3e} of its leaf's "
          f"scale, noise scale within {max(gns):.3e} (bound "
          f"{SMALL_F32_RTOL['gns']}), batches "
          f"{[int(h['global_batch']) for h in hg]} on both, visited K "
          f"{list(cg.visited_ks)}; launches {kg[norm_k]} + {kg[apply_k]}",
          flush=True)


def read_csv_rows(path) -> tuple:
    import csv
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def phase_paper_runs(launchers: dict, ops, layerwise, flatten, cnn,
                     paper_io, diag) -> dict:
    """11c: the paper's experiment launchers on the card at their
    reference constants (Table 1's 30 runs, SSL's 6, Fig. 2's 3, the
    ablations' 23, the schedules, the adaptive bench's 3), every CSV and
    JSONL checked; Table 1 again with ``--use-kernel per_tensor`` for
    the optimizers that accept it, with exactly one launch of each
    per-tensor kernel per step. Prints Table 1 and the
    adaptive switches."""
    tmp = tempfile.mkdtemp(prefix="phase11c_")
    JSONL_DIRS.append(tmp)
    res, seconds = {}, {}

    def drive(name, module, argv=()):
        t0 = time.perf_counter()
        res[name] = launchers[module].run(
            ["--device", DEV, "--out-dir", f"{tmp}/{name}", *argv],
            log_fn=lambda line: None)
        seconds[name] = round(time.perf_counter() - t0, 1)

    for name in ("table1", "ssl", "fig2_lnr", "ablations", "schedules",
                 "adaptive_batch"):
        drive(name, name)
    ops.reset_launches()
    drive("table1_per_tensor", "table1", ["--use-kernel", "per_tensor"])
    launches = dict(ops.launches)
    t1 = launchers["table1"]
    rows = res["table1"]["rows"]
    if len(rows) != sum(len(v) for v in t1.GRID.values()) * len(t1.OPTS) \
            or not all(np.isfinite(r[4]) and 0 <= r[3] <= 1 for r in rows):
        raise AssertionError(f"11c table1: {rows}")
    pt_rows = res["table1_per_tensor"]["rows"]
    params = cnn.init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=32,
                                     hidden=128, device=DEV)
    n_adapt = len(layerwise.kernel_segments(flatten.build_spec(params)))
    want = {k: 0 for k in launches}
    n = len(pt_rows) * t1.STEPS      # one pass a step
    want.update({"lars_norm2": n, "lars_apply": n})
    if launches != want or [r[0] for r in pt_rows] != \
            [o for o in t1.OPTS if o in paper_io.PER_TENSOR_OPTS] \
            * (len(pt_rows) // len(paper_io.PER_TENSOR_OPTS)):
        raise AssertionError(f"11c table1 per_tensor: launches {launches}, "
                             f"expected {want}; rows {pt_rows}")
    for name, files in (("table1", ["table1"]), ("ssl", ["table1_ssl"]),
                        ("fig2_lnr", ["fig2_lnr_traces"]),
                        ("ablations", ["fig5_lambda", "fig6_lr",
                                       "fig7_init"]),
                        ("schedules", ["schedules_fig1_fig4"])):
        for stem in files:
            header, body = read_csv_rows(f"{tmp}/{name}/{stem}.csv")
            if not body:
                raise AssertionError(f"11c {name}: {stem}.csv is empty")
            print(f"paper runs: {name} -> {stem}.csv {header}, "
                  f"{len(body)} rows", flush=True)
    ab = res["adaptive_batch"]
    for path in ab["paths"].values():
        diag.validate_jsonl(path)
    print("paper runs: Table 1 on the card (optimizer, batch, lr, "
          "accuracy, final loss): " + "; ".join(
              f"{o} B{b} lr{lr} {a:.4f} {fl:.4f}"
              for o, b, lr, a, fl in rows), flush=True)
    print("paper runs: Table 1 per-tensor: " + "; ".join(
        f"{o} B{b} lr{lr} {a:.4f} {fl:.4f}" for o, b, lr, a, fl in pt_rows)
        + f"; launches {launches['lars_norm2']} + {launches['lars_apply']} "
        f"= {len(pt_rows)} runs x {t1.STEPS} steps, one pass a step over "
        f"{n_adapt} ADAPT leaves", flush=True)
    lnr = res["fig2_lnr"]["summaries"]
    print(f"paper runs: Table 1 TVLARS >= WA-LARS - 0.005 in "
          f"{res['table1']['wins']}/{res['table1']['cells']} cells; SSL "
          f"{res['ssl']['rows']}; Fig. 2 max initial LNR "
          f"{ {k: round(v['max_initial_lnr'], 4) for k, v in lnr.items()} }"
          f", accuracy {res['fig2_lnr']['accuracy']}, warm-up caps LNR "
          f"{res['fig2_lnr']['warmup_caps_lnr']}; ablations lambda "
          f"{res['ablations']['lambda']} lr {res['ablations']['lr']} init "
          f"{res['ablations']['init']}; schedules head LR warm-up "
          f"{res['schedules']['warmup_head_lr']:.4f} TVLARS "
          f"{res['schedules']['tvlars_head_lr']:.4f}", flush=True)
    moves = [(s["step"], int(s["controller/global_batch"]),
              s["controller/lr"]) for s in ab["switches"]]
    print(f"paper runs: adaptive bench accuracy {ab['accuracy']}; "
          f"switches (step, batch, lr) {moves}; visited K "
          f"{list(ab['visited_ks'])}, {ab['compiles']} steps built; "
          f"seconds on the card {seconds}", flush=True)
    return {"results": res, "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# 12-12f: two more dense configs served, train -> checkpoint -> serve,
# the metric ring, the pipeline and landscape benches, the profiler
# ---------------------------------------------------------------------------

GIB = 2 ** 30
PEAK_CEILING_GIB = 60.0     # 12b: the deepest cut predicted under this
PREFILL_MARGIN_GIB = 1.0    # 12b: activations of one prefill batch
MAIN_STEPS = 4              # 12c: steps of each training run
MAIN_ARGV = ["--arch", "qwen2.5-3b", "--optimizer", "tvlars",
             "--use-kernel", "fused", "--global-batch", "8", "--seq",
             "512", "--steps", str(MAIN_STEPS)]
SEG_LARS = ("seg_norm_lars", "seg_apply_lars")
# 12c's traced run: CUDA runtime and driver calls that wait on the card,
# or may (an allocation or free, a pinned host allocation, a blocking
# copy or memset), and the kernel launches
BLOCKING_CALL = re.compile(r"Synchroniz|Malloc|Free|HostAlloc|HostRegister"
                           r"|^cudaMemcpy$|^cudaMemset$|^cuMem(?!cpy|set)")
WAIT_CALL = re.compile(r"Synchroniz")
LAUNCH_CALL = re.compile(r"^cu(da)?LaunchKernel")
RESOLVE_MARK = "chip_smoke.resolve"


def weight_bytes(cfg) -> int:
    """The model's weight bytes, from the reference layout's template
    (f32 leaves such as the MoE router at 4 B)."""
    from repro_torch.core.base import tree_leaves
    from repro_torch.models import jax_template
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(jax_template(cfg)))


def kv_pool_bytes(cfg, slots: int, max_len: int) -> int:
    return (slots * max_len * cfg.num_layers * 2 * cfg.num_kv_heads
            * cfg.head_dim_ * torch.empty((), dtype=cfg.kv_dtype)
            .element_size())


def requests_of(vocab: int, seed: int, n: int, prompt: tuple,
                new: tuple) -> tuple:
    rng = np.random.RandomState(seed)
    lens = rng.randint(prompt[0], prompt[1] + 1, size=n)
    news = rng.randint(new[0], new[1] + 1, size=n)
    return [rng.randint(1, vocab, size=k).astype(np.int32)
            for k in lens], news


def phase_dense_serving(label, cfg, requests, slots, max_len, ops,
                        serving, tad, get_model, Tracer, phase_summary,
                        tree_leaves, alone=(), tol=None) -> dict:
    """Serve ``requests`` through the engine on ``cfg`` at full width
    (random bf16 weights from seed 0), after holding the decode kernel
    against its plain version at the serving shape; prints the
    prediction first, then tok/s, the decode step, the kernel's card
    time per step (CUDA events around each launch, a second run) and
    the peak. The requests ``alone`` are re-run through ``generate``
    and held against the engine's tokens up to bf16 ties (``tol``)."""
    weights = weight_bytes(cfg)
    pool = kv_pool_bytes(cfg, slots, max_len)
    print(f"{label}: {cfg.arch_id} {cfg.num_layers} layers, "
          f"{cfg.param_count()} params by param_count(), "
          f"{tree_params(cfg)} in the tree: predicted weights "
          f"{weights / 1e9:.2f} GB + bf16 KV pool {pool / 1e9:.2f} GB "
          f"({slots} x {max_len} x {cfg.num_layers} layers x 2 x "
          f"{cfg.num_kv_heads} x {cfg.head_dim_} x 2 B) = "
          f"{(weights + pool) / GIB:.2f} GiB before activations; a "
          f"decode step's weight read {weights / HBM_BYTES_PER_S * 1e3:.2f}"
          f" ms at 3.35 TB/s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(12)
    timed = [p * max_len // MAX_LEN for p in POS["global"]]
    row = kernel_row(tad, ops, gen, "global", max_len, None, cfg.kv_dtype,
                     slots, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                     timed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    if n_params != tree_params(cfg):
        raise AssertionError(f"{n_params} params, the template has "
                             f"{tree_params(cfg)}")
    print(f"{label}: {n_params} params initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tracer = Tracer()
    results, stats, elapsed, launches = serve(
        engine(serving, model, params, tracer, slots, max_len), ops,
        requests)
    want = cfg.num_layers * stats["decode_steps"]
    if launches != want or stats["kernel_launches"] != launches:
        raise AssertionError(f"{label}: attention_decode launched "
                             f"{launches} times, expected {want} = "
                             f"{cfg.num_layers} layers x "
                             f"{stats['decode_steps']} decode steps")
    spans = phase_summary(tracer.events())
    step_ms = decode_step_ms(spans, stats["decode_steps"])
    generated = stats["tokens_generated"]
    engine_vs_generate(label, serving, model, params, requests[0],
                       requests[1], results, alone, max_len, tol)
    timer = LaunchEvents()
    with timer:
        _, stats2, _, _ = serve(
            engine(serving, model, params, None, slots, max_len), ops,
            requests)
    att_ms = timer.total_ms() / stats2["decode_steps"]
    peak = torch.cuda.max_memory_allocated() / GIB
    lens = [len(p) for p in requests[0]]
    print(f"{label}: {len(results)} requests (prompts {min(lens)}-"
          f"{max(lens)}), {generated} tokens in {elapsed:.3f} s = "
          f"{generated / elapsed:.2f} tok/s; {stats['decode_steps']} decode "
          f"steps x {cfg.num_layers} = {launches} attention_decode "
          f"launches; decode step {step_ms:.3f} ms (decode + sample "
          f"spans); attention_decode {att_ms:.3f} ms of the card per "
          f"step ({timer.calls} launches timed); peak {peak:.2f} GiB "
          f"(predicted {(weights + pool) / GIB:.2f} before activations); "
          f"{smi_line()}", flush=True)
    del params, results
    return {"launches": launches, "row": row, "tok_s": generated / elapsed,
            "step_ms": step_ms, "attention_ms_per_step": att_ms,
            "peak_gib": peak, "layers": cfg.num_layers}


def cut_depth(cfg, slots: int, max_len: int) -> int:
    """The deepest layer count whose weights, KV pool and one prefill
    batch's activations are predicted under ``PEAK_CEILING_GIB``."""
    one, two = (weight_bytes(cfg.replace(num_layers=n)) for n in (1, 2))
    fixed = 2 * one - two
    layer = two - one \
        + kv_pool_bytes(cfg.replace(num_layers=1), slots, max_len)
    room = (PEAK_CEILING_GIB - PREFILL_MARGIN_GIB) * GIB - fixed
    return min(cfg.num_layers, int(room // layer))


class SyncCounter:
    """Counts the card synchronisations inside the block: those torch's
    sync-debug mode reports (a read-back, a blocking copy, a stream
    synchronise) and the explicit ``torch.cuda.synchronize`` calls,
    which it does not report. Each is kept with the step of ``fit``'s
    loop it fell in (None outside the loop), whether it was a resolve
    (inside ``trainer.fetch`` / ``_to_host``: the intended read of a
    step's metrics) and the innermost line of the port that made it."""

    def __enter__(self):
        self.records = []
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._record
        self._synchronize = torch.cuda.synchronize

        def synchronize(device=None):
            self.records.append(self._where(sys._getframe(1)))
            return self._synchronize(device)

        torch.cuda.synchronize = synchronize
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize = self._synchronize
        self._catch.__exit__(*exc)

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if "synchroniz" not in str(message):
            return self._show(message, category, filename, lineno, file,
                              line)
        self.records.append(self._where(sys._getframe(1)))
        return None

    @staticmethod
    def _where(f) -> tuple:
        step, resolve, site = None, False, None
        while f is not None:
            code = f.f_code
            port = "repro_torch" in code.co_filename
            if port and site is None:
                site = (f"{code.co_filename.split('src/')[-1]}:"
                        f"{f.f_lineno} {code.co_name}")
            if port and code.co_name in ("fetch", "_to_host"):
                resolve = True
            if port and code.co_name == "fit" and "i" in f.f_locals:
                step = f.f_locals["i"]
                break
            f = f.f_back
        return step, resolve, site

    def per_step(self, steps: int) -> dict:
        """Over fit's steps 1 .. steps - 1: syncs per step outside and
        inside a resolve, and the sites outside."""
        rest = [r for r in self.records
                if r[0] is not None and r[0] >= 1]
        n = max(steps - 1, 1)
        outside = [r for r in rest if not r[1]]
        return {"outside_per_step": len(outside) / n,
                "resolve_per_step": (len(rest) - len(outside)) / n,
                "sites": sorted({r[2] for r in outside}),
                "total": len(self.records)}


class ResolveMarks:
    """Inside the block, each of ``trainer.fetch``'s reads (the ring's
    resolves) runs in a ``torch.profiler.record_function`` range named
    ``RESOLVE_MARK``, so a trace tells the intended waits apart."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __enter__(self):
        self.fetch = fetch = self.trainer.fetch

        def marked(tree):
            with torch.profiler.record_function(RESOLVE_MARK):
                return fetch(tree)

        self.trainer.fetch = marked
        return self

    def __exit__(self, *exc):
        self.trainer.fetch = self.fetch


def read_window(path: str, steps: int) -> dict:
    """A ``torch.profiler`` Chrome trace of ``steps`` training steps and
    the ring's drain, cut at the end of the last resolve (what follows
    is the profiler's own stop): the CUDA runtime and driver calls
    matching ``BLOCKING_CALL`` and the pageable copies (by their
    runtime call), each inside or outside the resolve ranges (count and
    host us by name); the kernel launches, their host time and the most
    launched kernels; the card's busy time (kernels, copies and
    memsets, overlaps merged) and its share of the window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    resolves = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("name") == RESOLVE_MARK
                      and e.get("cat") == "user_annotation")
    if not resolves:
        raise AssertionError("12c trace: no resolve in the window")
    t1 = max(b for _, b in resolves)
    events = [e for e in events if e["ts"] < t1]
    host = [e for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                "user_annotation")]
    card = sorted((e["ts"], min(e["ts"] + e["dur"], t1)) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy",
                                      "gpu_memset"))
    if not host or not card:
        raise AssertionError(f"12c trace: {len(host)} host and {len(card)} "
                             f"card events")
    t0 = min(e["ts"] for e in host)
    busy, end = 0.0, t0
    for a, b in card:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    calls = {"outside": {}, "resolve": {}}
    pageable = {"outside": {}, "resolve": {}}

    def add(table, e, name):
        where = "resolve" if any(a <= e["ts"] < b for a, b in resolves) \
            else "outside"
        n, us = table[where].get(name, (0, 0))
        table[where][name] = (n + 1, us + round(e["dur"]))

    runtime = {}
    launch_us, launch_max, launches = 0.0, 0.0, 0
    for e in host:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        runtime[e.get("args", {}).get("correlation")] = e
        name = e["name"]
        if LAUNCH_CALL.match(name):
            launches += 1
            launch_us += e["dur"]
            launch_max = max(launch_max, e["dur"])
        if BLOCKING_CALL.search(name):
            add(calls, e, name)
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "Pageable" in e["name"]:
            call = runtime.get(e.get("args", {}).get("correlation"))
            if call is None:
                raise AssertionError(f"12c trace: no runtime call for "
                                     f"{e['name']}")
            add(pageable, call, e["name"])
    kernels = collections.Counter(e["name"][:60] for e in events
                                  if e.get("cat") == "kernel")
    return {"window_ms": (t1 - t0) / 1e3, "busy_share": busy / (t1 - t0),
            "card_ms_per_step": busy / 1e3 / steps,
            "resolves": len(resolves), "calls": calls,
            "pageable": pageable, "launches_per_step": launches / steps,
            "launch_ms": launch_us / 1e3, "launch_max_ms": launch_max / 1e3,
            "top_kernels": kernels.most_common(5),
            "waits_outside_per_step": sum(
                n for name, (n, _) in calls["outside"].items()
                if WAIT_CALL.search(name)) / steps}


def phase_main_path(train_run, ops, checkpoint, convert, serving, tad,
                    trainer, tree_leaves) -> dict:
    """qwen2.5-3b at full width: fused TVLARS trained synchronously and
    with ``--async-metrics 2`` from the same seed (histories and final
    params bitwise equal, 1 + 1 segmented launches per step, card
    synchronisations per step counted), and once more with
    ``--async-metrics 2`` under ``--profile-dir`` from step 1 on, whose
    trace counts the runtime calls that wait on the card or may; the
    decode kernel held against its plain version at the serving shape;
    the async run's params saved in the reference's layout, served
    through ``Engine.from_checkpoint`` (restored params bitwise the
    trained ones) and through an engine on the in-memory params: the
    same tokens."""
    from repro_torch.obs.profiler import TRACE_NAME
    runs = {}
    state = traced = None
    # the traced run before the timed async one, whose state is kept
    for label in ("sync", "traced", "async"):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        argv = MAIN_ARGV + ([] if label == "sync"
                            else ["--async-metrics", "2"])
        with tempfile.TemporaryDirectory() as out_dir, \
                (ResolveMarks(trainer) if label == "traced"
                 else contextlib.nullcontext()):
            if label == "traced":
                argv += ["--profile-dir", out_dir, "--profile-start", "1",
                         "--profile-steps", str(MAIN_STEPS - 1)]
            with SyncCounter() as counter:
                out = train_run(argv, log_fn=lambda m, _l=label: print(
                    f"12c {_l}: {m}", flush=True))
            if label == "traced":
                traced = read_window(os.path.join(out_dir, TRACE_NAME),
                                     MAIN_STEPS - 1)
        launches = {k: ops.launches[k] for k in SEG_LARS}
        if any(v != MAIN_STEPS for v in launches.values()):
            raise AssertionError(f"12c {label}: segmented launches "
                                 f"{launches}, expected 1 + 1 per step "
                                 f"over {MAIN_STEPS} steps")
        syncs = counter.per_step(MAIN_STEPS)
        runs[label] = {
            "history": out["history"], "launches": launches,
            "checksum": state_checksum(out["state"], tree_leaves),
            "syncs": syncs, "seconds": out["seconds"],
            "loss_grad_seconds": out["loss_grad_seconds"],
            "optimizer_seconds": out["optimizer_seconds"],
            "dispatch_seconds": out["dispatch_seconds"],
            "resolve_seconds": out["resolve_seconds"],
            "peak_gib": out["peak_memory_bytes"] / GIB}
        print(f"12c {label}: {MAIN_STEPS} steps in {out['seconds']:.3f} s "
              f"({out['seconds'] / MAIN_STEPS * 1e3:.1f} ms a step); "
              f"loss_grad "
              f"{[round(x * 1e3, 1) for x in out['loss_grad_seconds']]} ms, "
              f"optimizer "
              f"{[round(x * 1e3, 1) for x in out['optimizer_seconds']]} ms, "
              f"dispatch "
              f"{[round(x * 1e3, 1) for x in out['dispatch_seconds']]} ms, "
              f"resolve "
              f"{[round(x * 1e3, 1) for x in out['resolve_seconds']]} ms; "
              f"launches {launches}; card synchronisations per step over "
              f"steps 1-{MAIN_STEPS - 1}: {syncs['outside_per_step']:.2f} "
              f"outside a resolve, {syncs['resolve_per_step']:.2f} in "
              f"resolves ({syncs['total']} in the whole run); sites "
              f"outside: {syncs['sites']}; peak "
              f"{runs[label]['peak_gib']:.2f} GiB", flush=True)
        if label == "async":
            state, model = out["state"], out["model"]
        del out
    sync_run, async_run = runs["sync"], runs["async"]
    # the traced run's own count includes the profiler's stop, which
    # synchronises; its trace is read up to the end of the last resolve
    if async_run["syncs"]["outside_per_step"] != 0:
        raise AssertionError(f"12c: the async run synchronises the card "
                             f"between dispatch and resolve: "
                             f"{async_run['syncs']}")
    for label in ("traced", "async"):
        if sync_run["history"] != runs[label]["history"]:
            raise AssertionError(f"12c {label}: history differs from sync")
        if sync_run["checksum"] != runs[label]["checksum"]:
            raise AssertionError(f"12c {label}: final state differs from "
                                 f"sync")
    calls = traced["calls"]
    print(f"12c traced: steps 1-{MAIN_STEPS - 1} and the drain, a "
          f"{traced['window_ms']:.1f} ms window: card busy "
          f"{traced['busy_share']:.1%} ({traced['card_ms_per_step']:.1f} "
          f"ms a step); {traced['launches_per_step']:.0f} kernel launches "
          f"a step, {traced['launch_ms']:.1f} ms of host time in them "
          f"(longest {traced['launch_max_ms']:.3f} ms); the most launched: "
          f"{traced['top_kernels']}; runtime calls that wait or may, as "
          f"name: (count, host us), outside the {traced['resolves']} "
          f"resolves: {calls['outside']}; inside: {calls['resolve']}; "
          f"pageable copies by their runtime call, outside: "
          f"{traced['pageable']['outside']}; inside: "
          f"{traced['pageable']['resolve']}", flush=True)
    if traced["waits_outside_per_step"] != 0:
        raise AssertionError(f"12c traced: the trace shows the host waiting "
                             f"on the card outside a resolve: "
                             f"{calls['outside']}")
    if traced["pageable"]["outside"]:
        raise AssertionError(f"12c traced: pageable copies outside a "
                             f"resolve (batches go through pinned "
                             f"memory): {traced['pageable']['outside']}")
    print(f"12c: histories ({len(sync_run['history'])} records, "
          f"{len(sync_run['history'][0])} metrics each) and the final "
          f"params' and momentum's checksums bitwise equal", flush=True)

    params, cfg = state.params, model.cfg
    del state
    gc.collect()
    torch.cuda.empty_cache()
    sc = serving.ServeConfig(slots=4, max_len=1024, page_size=16)
    row = kernel_row(tad, ops, torch.Generator(device="cuda").manual_seed(13),
                     "global", sc.max_len, None, cfg.kv_dtype, sc.slots,
                     cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                     [p * sc.max_len // MAX_LEN for p in POS["global"]])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        need = weight_bytes(cfg) + GIB
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(f"12c: {free / 1e9:.1f} GB free under "
                               f"{tmp}, the checkpoint needs "
                               f"{need / 1e9:.1f} GB")
        t0 = time.perf_counter()
        checkpoint.save(tmp, convert.params_to_jax(cfg, params),
                        step=MAIN_STEPS)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = serving.Engine.from_checkpoint(tmp, model, sc,
                                                  device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ours, theirs = tree_leaves(restored.params), tree_leaves(params)
        if len(ours) != len(theirs) or not all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(ours, theirs)):
            raise AssertionError("12c: restored params differ from the "
                                 "trained ones")
        print(f"12c: checkpoint {nbytes} B ({free / 1e9:.1f} GB free "
              f"before) saved in {save_s:.2f} s, restored onto the card by "
              f"Engine.from_checkpoint in {restore_s:.2f} s; restored "
              f"params bitwise equal to the trained ones ({len(ours)} "
              f"tensors)", flush=True)
        requests = requests_of(cfg.vocab_size, 2, 4, (64, 512), (16, 48))
        tokens = {}
        for name, eng in (("checkpoint", restored),
                          ("in-memory", serving.Engine(model, params, sc,
                                                       device="cuda"))):
            results, stats, elapsed, launches = serve(eng, ops, requests)
            if launches != cfg.num_layers * stats["decode_steps"]:
                raise AssertionError(f"12c {name}: {launches} launches for "
                                     f"{stats['decode_steps']} decode steps")
            tokens[name] = [r.tokens for r in results]
            print(f"12c serve ({name} engine): {len(results)} requests, "
                  f"{stats['tokens_generated']} tokens in {elapsed:.3f} s, "
                  f"{stats['decode_steps']} decode steps x "
                  f"{cfg.num_layers} = {launches} attention_decode "
                  f"launches", flush=True)
        if tokens["checkpoint"] != tokens["in-memory"]:
            raise AssertionError("12c: the checkpointed engine's tokens "
                                 "differ from the in-memory engine's")
        print("12c: the checkpointed engine's greedy tokens equal the "
              "in-memory engine's", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"runs": runs, "traced": traced, "row": row, "save_s": save_s,
            "restore_s": restore_s, "bytes": nbytes,
            "decode_launches": launches, "layers": cfg.num_layers,
            "seg_launches": {k: sync_run["launches"][k]
                             + async_run["launches"][k] for k in SEG_LARS}}


def phase_pipeline_bench(pipeline_launch, ops) -> dict:
    """``launch.pipeline`` at the bench's constants on the card."""
    with tempfile.TemporaryDirectory() as out_dir:
        ops.reset_launches()
        out = pipeline_launch.run(["--device", "cuda", "--out-dir",
                                   out_dir],
                                  log_fn=lambda m: print(f"12d: {m}",
                                                         flush=True))
    if out["launches_per_step"] != {k: 1.0 for k in SEG_LARS}:
        raise AssertionError(f"12d: segmented launches per step "
                             f"{out['launches_per_step']}, expected 1 + 1")
    print(f"12d: sync {out['sync_us']:.1f} us/step, async "
          f"{out['async_us']:.1f} us/step, bare {out['bare_us']:.1f} "
          f"us/step: sync/async {out['ratio']:.3f} (the reference asserts "
          f">= 1.3 on its host; recorded here, not asserted); metrics "
          f"equal", flush=True)
    return {**{k: out[k] for k in ("sync_us", "async_us", "bare_us",
                                   "ratio")},
            "launches": {k: ops.launches[k] for k in SEG_LARS}}


def phase_landscape_bench(landscape_launch) -> dict:
    """``launch.landscape`` at the bench's constants on the card."""
    with tempfile.TemporaryDirectory() as out_dir:
        out = landscape_launch.run(["--device", "cuda", "--out-dir",
                                    out_dir],
                                   log_fn=lambda m: print(f"12e: {m}",
                                                          flush=True))
        rows = open(out["csv"]).read().splitlines()
    if not torch.isfinite(out["grid"]).all() or len(rows) != 64:
        raise AssertionError(f"12e: grid {out['grid']} / {len(rows)} CSV "
                             f"lines")
    return {"endpoints": out["endpoints"], "barrier": out["barrier"]}


def phase_profile(train_run, ops) -> dict:
    """``launch.train --smoke --profile-dir`` on the card: the Chrome
    trace names the segmented kernels."""
    from repro_torch.obs.profiler import TRACE_NAME
    with tempfile.TemporaryDirectory() as out_dir:
        ops.reset_launches()
        train_run(["--smoke", "--steps", "4", "--seq", "64",
                   "--use-kernel", "fused", "--profile-dir", out_dir,
                   "--profile-start", "1", "--profile-steps", "2"],
                  log_fn=lambda m: print(f"12f: {m}", flush=True))
        with open(os.path.join(out_dir, TRACE_NAME)) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(out_dir, TRACE_NAME))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in e.get("name", "") for e in kernels)
             for k in ("seg_norm_kernel", "seg_apply_kernel")}
    if not all(named.values()):
        raise AssertionError(f"12f: the trace's {len(kernels)} kernel "
                             f"events name the segmented kernels "
                             f"{named} times")
    print(f"12f: trace {size} B, {len(events)} events, {len(kernels)} "
          f"kernel events; segmented kernels in the 2-step window: "
          f"{named}", flush=True)
    return {"named": named, "launches": {k: ops.launches[k]
                                         for k in SEG_LARS}}


# --------------------------------------------------------------------------
# 13-13f: the MoE, Mamba2 and Zamba2 families
# --------------------------------------------------------------------------

MOE_PROMPT = 1024             # 13: every prompt on a pow2 / page bucket
TRAIN_CEILING_GIB = 70.0      # 13c: the deepest olmoe cut predicted under
TRAIN_MARGIN_GIB = 6.0        # 13c: activations, CE head, allocator slack
# fused TVLARS f32 per parameter: bf16 weight and gradient (2 + 2 B), f32
# momentum (4), the update's packed weights, gradients and delta (3 x 4)
TRAIN_BYTES_PER_PARAM = 20
GEN_SHAPE = (4, 32, 16)       # 13d / 13e: prompts, prompt length, new
FAMILY_ARGV = ["--optimizer", "tvlars", "--use-kernel", "fused",
               "--precision", "f32", "--global-batch", "8", "--seq", "512",
               "--steps", "3"]
FAMILY_SMOKE = ("olmoe-1b-7b", "qwen3-moe-30b-a3b", "mamba2-1.3b",
                "zamba2-1.2b")


def moe_traffic(vocab: int) -> tuple:
    """Phase 4's request count and new-token counts, every prompt 1024
    tokens long: capacity drops depend on the padded length, and the
    engine pads prompts to pow2 buckets where ``generate`` does not, so
    the two route alike only at bucket-aligned prompts (as the
    reference's MoE parity test holds them)."""
    _, _, new = traffic(vocab)
    rng = np.random.RandomState(13)
    return [rng.randint(1, vocab, size=MOE_PROMPT).astype(np.int32)
            for _ in new], new


def train_depth(cfg) -> tuple:
    """(layers, predicted GiB): the deepest cut of ``cfg`` whose fused
    TVLARS f32 step is predicted under ``TRAIN_CEILING_GIB`` at
    ``TRAIN_BYTES_PER_PARAM`` plus ``TRAIN_MARGIN_GIB``."""
    one, two = (tree_params(cfg.replace(num_layers=n)) for n in (1, 2))
    per, fixed = two - one, 2 * one - two

    def gib(n):
        return (fixed + n * per) * TRAIN_BYTES_PER_PARAM / GIB \
            + TRAIN_MARGIN_GIB

    n = max(k for k in range(1, cfg.num_layers + 1)
            if gib(k) <= TRAIN_CEILING_GIB)
    return n, gib(n)


@contextlib.contextmanager
def config_cut(launcher, arch: str, **fields):
    """Inside the block ``launcher.get_config(arch)`` has ``fields``
    replaced (depth cuts: ``num_layers``, ``encoder_layers``), its
    widths as published: how a phase trains a model too deep for one
    card through the launcher's own path."""
    real = launcher.get_config
    launcher.get_config = lambda a: real(a).replace(**fields) \
        if a == arch else real(a)
    try:
        yield
    finally:
        launcher.get_config = real


def depth_cut(launcher, arch: str, layers: int):
    """:func:`config_cut` of ``arch`` to ``layers`` layers."""
    return config_cut(launcher, arch, num_layers=layers)


def moe_aux_check(out) -> dict:
    """The trained MoE's load-balance loss at every step (its metric)
    and both aux losses of one more forward: finite and non-zero."""
    from repro_torch.data.synthetic import lm_batch
    model, params = out["model"], out["state"].params
    lbs = [float(h["load_balance"]) for h in out["history"]]
    toks, labels = lm_batch(torch.Generator().manual_seed(5), 8, 512,
                            model.cfg.vocab_size, device=DEV)
    with torch.no_grad():
        _, aux = model.loss(params, {"tokens": toks, "labels": labels})
    lb, z = float(aux.load_balance_loss), float(aux.router_z_loss)
    if not all(np.isfinite(x) and x > 0 for x in lbs + [lb, z]):
        raise AssertionError(f"MoE aux losses {lbs}, {lb}, {z}")
    print(f"  aux: load balance per step {[round(x, 4) for x in lbs]} "
          f"(summed over {model.cfg.num_layers} layers); after training "
          f"lb {lb:.4f}, router z {z:.4f}", flush=True)
    return {"load_balance": lbs, "lb": lb, "z": z}


def family_generate(label, serving, ops, out, per_step: int) -> dict:
    """``serving.generate`` on the trained params: ``GEN_SHAPE``'s
    prompts through the token-by-token prefill (the family has no
    batched one), then the new tokens; exactly ``per_step``
    decode-attention launches per decode step. Prints the prompt's
    last-position logits through the recurrence against the
    full-sequence forward (recorded, not asserted: bf16 through every
    layer in two summation orders)."""
    model, params = out["model"], out["state"].params
    b, s, new = GEN_SHAPE
    if model.prefill is not None:
        raise AssertionError(f"{label}: the family has a batched prefill")
    prompts = np.random.RandomState(14).randint(1, model.cfg.vocab_size,
                                                size=(b, s))
    x = torch.as_tensor(prompts, device=DEV)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        toks = serving.generate(model, params, prompts, num_tokens=new,
                                device=DEV)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launches["attention_decode"]
        last, _ = serving.prefill(model, params, x, s + new)
        full = model.apply(params, x)[:, -1].float()
    last = last[:, -1].float()
    want = per_step * (s + new)
    if launches != want:
        raise AssertionError(f"{label}: {launches} attention_decode "
                             f"launches, expected {want} = {per_step} x "
                             f"{s + new} decode steps")
    if tuple(toks.shape) != (b, new) or not bool(
            ((toks >= 0) & (toks < model.cfg.vocab_size)).all()) \
            or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{label}: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    rel = ((last - full).abs().max() / full.abs().max()).item()
    agree = (last.argmax(-1) == full.argmax(-1)).sum().item()
    print(f"{label}: generate {b} prompts x {s} tokens + {new} new "
          f"through the token-by-token prefill in {elapsed:.3f} s "
          f"({b * new / elapsed:.2f} new tok/s, {s + new} decode steps); "
          f"attention_decode launches {launches} ({per_step} per step); "
          f"the prompt's last logits, recurrence vs full-sequence "
          f"forward: max |diff| {rel:.3e} of max |logit|, argmax equal in "
          f"{agree} of {b} rows; {smi_line()}", flush=True)
    return {"launches": launches, "seconds": elapsed, "rel": rel}


def phase_families_small(get_smoke_config, get_model, serving,
                         build_optimizer, training, lm_iterator,
                         tree_leaves, tree_map, ops, su, moe) -> None:
    """13f: the four smoke configs in f32, the card (kernels) against
    the CPU (plain versions) on the same weights: logits within 1e-4
    (the CPU tests' bound against the JAX package), every MoE layer's
    routing decisions (top-k, keep, slots; at the smoke capacity and at
    1.0, where tokens drop) equal, ``generate``'s greedy tokens equal,
    and one fused TVLARS step at phase 8's bounds (loss and params 1e-5
    at each leaf's scale, 1 + 1 segmented launches)."""
    for arch in FAMILY_SMOKE:
        model = get_model(get_smoke_config(arch))
        cpu = model.init(0, device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        rng = np.random.RandomState(6)
        toks = rng.randint(1, 512, size=(2, 16))
        with torch.no_grad():
            lc = model.apply(cpu, torch.as_tensor(toks))
            lg = model.apply(gpu, torch.as_tensor(toks, device=DEV)).cpu()
        err = (lg - lc).abs().max().item()
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
        routed = 0
        if model.cfg.num_experts:
            x = torch.as_tensor(rng.normal(size=(3, 16, model.cfg.d_model)),
                                dtype=torch.float32)
            for layer_c, layer_g in zip(cpu["layers"], gpu["layers"]):
                for cf in (model.cfg.capacity_factor, 1.0):
                    c = model.cfg.replace(capacity_factor=cf)
                    rc = moe.route(layer_c["moe"], c, x)
                    rg = moe.route(layer_g["moe"], c, x.to(DEV))
                    for name in ("topk_idx", "keep", "slot"):
                        if not torch.equal(getattr(rg, name).cpu(),
                                           getattr(rc, name)):
                            raise AssertionError(f"13f {arch}: routing "
                                                 f"{name} differs")
                    routed += int((~rc.keep).sum())
        gen = [serving.generate(model, p, toks[:, :6], num_tokens=8,
                                device=d).cpu()
               for p, d in ((cpu, "cpu"), (gpu, DEV))]
        if not torch.equal(*gen):
            raise AssertionError(f"13f {arch}: generate card {gen[1]} "
                                 f"!= cpu {gen[0]}")
        out = []
        for dev, params in (("cpu", cpu), (DEV, gpu)):
            opt = build_optimizer("tvlars", total_steps=10,
                                  learning_rate=2.0, batch_size=8,
                                  use_kernel="fused",
                                  segments=model.segments, device=dev)
            state = training.TrainState.create(
                tree_map(lambda t: t.detach().clone(), params), opt)
            step = training.make_train_step(training.lm_task(model), opt)
            ops.reset_launches()
            state, m = step(state, next(lm_iterator(8, 64,
                                                    model.cfg.vocab_size,
                                                    seed=1, device=dev)))
            out.append((float(m["loss"]), state.params,
                        dict(ops.launches)))
        (lossc, pc, kc), (lossg, pg, kg) = out
        want = {k: 0 for k in kg}
        want.update({k: 1 for k in su.KERNELS["lars"]})
        if kg != want or any(kc.values()):
            raise AssertionError(f"13f {arch}: launches cpu {kc} card {kg}")
        np.testing.assert_allclose(lossg, lossc, rtol=1e-5)
        worst = 0.0
        for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
            a, b = a.detach().cpu().numpy(), b.detach().numpy()
            scale = float(np.abs(b).max())
            worst = max(worst, float(np.abs(a - b).max()) / scale)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
        print(f"13f {arch}: smoke f32, card == cpu: logits within {err:.3e}"
              f", generate's 8 tokens x 2 rows equal"
              + (f", routing equal in every layer ({routed} dropped "
                 f"entries at capacity 1.0)" if model.cfg.num_experts
                 else "")
              + f", one fused TVLARS step (1 + 1 launches) loss "
              f"{lossg:.6f}, worst param gap {worst:.3e} of its leaf's "
              f"scale; {smi_line()}", flush=True)


def phase_families(train_module, ops, su, sref, lu, layerwise, flatten,
                   serving, tad, get_config, get_model, Tracer,
                   phase_summary, tree_leaves) -> dict:
    """13-13e: MoE serving at full width (olmoe-1b-7b full depth,
    qwen3-moe-30b-a3b at the deepest cut predicted to fit), olmoe
    trained cut in depth, mamba2-1.3b and zamba2-1.2b trained at full
    width and depth and then generating."""
    bf16_tol = tad.decode_parity_tolerance(torch.bfloat16)
    run = train_module.run
    out = {}

    def clear():
        gc.collect()
        torch.cuda.empty_cache()

    clear()
    olmoe = get_config("olmoe-1b-7b")
    out["13"] = phase_dense_serving(
        "13 olmoe-1b-7b", olmoe, moe_traffic(olmoe.vocab_size), SLOTS,
        MAX_LEN, ops, serving, tad, get_model, Tracer, phase_summary,
        tree_leaves, alone=(0, 7), tol=bf16_tol)
    clear()
    q3 = get_config("qwen3-moe-30b-a3b")
    depth = cut_depth(q3, 4, 1024)
    print(f"13b qwen3-moe-30b-a3b: "
          + ("full depth, " if depth == q3.num_layers else
             f"reduced: num_layers {q3.num_layers} -> {depth}, ")
          + f"the deepest whose weights, KV pool and {PREFILL_MARGIN_GIB} "
          f"GiB of prefill activations are predicted under "
          f"{PEAK_CEILING_GIB} GiB", flush=True)
    out["13b"] = phase_dense_serving(
        "13b qwen3-moe-30b-a3b", q3.replace(num_layers=depth),
        requests_of(q3.vocab_size, 1, 4, (128, 512), (16, 32)), 4, 1024,
        ops, serving, tad, get_model, Tracer, phase_summary, tree_leaves)
    clear()

    layers, gib = train_depth(olmoe)
    print(f"13c olmoe-1b-7b: reduced: num_layers {olmoe.num_layers} -> "
          f"{layers}, the deepest predicted under {TRAIN_CEILING_GIB} GiB "
          f"({gib:.2f} GiB: {TRAIN_BYTES_PER_PARAM} B a parameter + "
          f"{TRAIN_MARGIN_GIB} GiB)", flush=True)
    with depth_cut(train_module, "olmoe-1b-7b", layers):
        out["13c"] = phase_train_full(
            run, ops, su, sref, tree_leaves,
            ["--arch", "olmoe-1b-7b"] + FAMILY_ARGV, "13c olmoe-tvlars-f32",
            want_layers=layers, inspect=moe_aux_check)
    out["13c"]["predicted_gib"] = gib
    clear()

    mamba = cut_config(get_config, "mamba2-1.3b")
    print(cut_line("13d mamba2-1.3b", get_config("mamba2-1.3b"), mamba)
          + f", {tree_params(mamba)} params (param_count() says "
          f"{mamba.param_count()}, F8): predicted fused peak "
          f"{tree_params(mamba) * TRAIN_BYTES_PER_PARAM / GIB:.2f} GiB "
          f"before activations", flush=True)
    with config_cut(train_module, "mamba2-1.3b",
                    **FAMILY_CUTS["mamba2-1.3b"]):
        out["13d"] = phase_train_full(
            run, ops, su, sref, tree_leaves,
            ["--arch", "mamba2-1.3b"] + FAMILY_ARGV,
            "13d mamba2-tvlars-f32", want_layers=mamba.num_layers,
            inspect=lambda o: family_generate("13d mamba2-1.3b", serving,
                                              ops, o, 0))
        clear()
        out["13d-pt"] = phase_train_per_tensor(
            run, ops, lu, sref, layerwise, flatten, tree_leaves,
            ["--arch", "mamba2-1.3b", "--optimizer", "wa-lars",
             "--use-kernel", "per_tensor", "--precision", "f32",
             "--global-batch", "8", "--seq", "512", "--steps", "3"],
            "13d mamba2-wa-lars-per-tensor", want_layers=mamba.num_layers)
    clear()

    zamba = cut_config(get_config, "zamba2-1.2b")
    sites = zamba.num_layers // zamba.attn_every
    b, s, new = GEN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(13)
    t = s + new
    row = kernel_row(tad, ops, gen, "global", t, None, zamba.cdtype, b,
                     zamba.num_heads, zamba.num_kv_heads, zamba.head_dim_,
                     [p * t // MAX_LEN for p in POS["global"]])
    print(cut_line("13e zamba2-1.2b", get_config("zamba2-1.2b"), zamba)
          + f", {tree_params(zamba)} params (param_count() says "
          f"{zamba.param_count()}, F8), the shared attention block at "
          f"{sites} call sites; the kernel row above on {smi_line()}",
          flush=True)
    clear()
    with config_cut(train_module, "zamba2-1.2b",
                    **FAMILY_CUTS["zamba2-1.2b"]):
        out["13e"] = phase_train_full(
            run, ops, su, sref, tree_leaves,
            ["--arch", "zamba2-1.2b"] + FAMILY_ARGV,
            "13e zamba2-tvlars-f32", want_layers=zamba.num_layers,
            inspect=lambda o: family_generate("13e zamba2-1.2b", serving,
                                              ops, o, sites))
    out["13e"]["row"] = row
    clear()
    return out


# --------------------------------------------------------------------------
# 14-14f: the encoder-decoder and vision families
# --------------------------------------------------------------------------

# 13d / 13e / 14 / 14b / 14c: depth cuts for the script's time budget
# (with phase 22 the whole script took 1127.8 s of its 1200 s on an
# H100 machine whose host ran 1.3x slower than others); widths as
# published. mamba2 48 -> 12 blocks, zamba2 38 -> 14 (two
# groups of 6 and the 2 trailing: 2 shared-block sites), the vlm 40 ->
# 20 self layers (4 gated cross layers), whisper 32 + 32 -> 8 + 8
FAMILY_CUTS = {"mamba2-1.3b": dict(num_layers=12),
               "zamba2-1.2b": dict(num_layers=14),
               "llama-3.2-vision-11b": dict(num_layers=20),
               "whisper-large-v3": dict(num_layers=8, encoder_layers=8)}


def cut_config(get_config, arch: str):
    """``get_config(arch)`` at its ``FAMILY_CUTS`` depth."""
    return get_config(arch).replace(**FAMILY_CUTS[arch])


def cut_line(label: str, full, cut) -> str:
    """``reduced:`` for each depth field ``cut`` changes from ``full``."""
    fields = [f"{k} {getattr(full, k)} -> {getattr(cut, k)}"
              for k in ("num_layers", "encoder_layers")
              if getattr(full, k) != getattr(cut, k)]
    return (f"{label}: reduced: {', '.join(fields)} (the script's time "
            f"budget; width as published)")


GATE_OPEN = 0.5               # 14 / 14d / 14f: every vlm cross gate
WHISPER_GEN = (4, 64, 32)     # 14b: prompts, prompt length, new tokens
VLM_PICKS = 3                 # 14: requests re-run alone, one per row
CROSS_SMOKE = ("whisper-large-v3", "llama-3.2-vision-11b")


def extra_draw(cfg, batch: int, seed: int, device=None) -> torch.Tensor:
    """``batch`` rows of the stubbed frontend's output for ``cfg`` on
    ``device`` (the card by default): seeded normal draws in the compute
    dtype, never zeros (zero frames leave whisper's cross path idle)."""
    from repro_torch.models import extra_embed_shape
    device = device or DEV
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(extra_embed_shape(cfg, batch), generator=gen,
                       device=device, dtype=torch.float32).to(cfg.cdtype)


def open_gates(params, value: float = GATE_OPEN) -> int:
    """Every vlm cross gate of the port's ``params`` set to ``value``
    (init leaves them at 0, where the image is ignored); returns how
    many."""
    gates = [layer["gate"] for layer in params["layers"] if "gate" in layer]
    with torch.no_grad():
        for g in gates:
            g.fill_(value)
    return len(gates)


@contextlib.contextmanager
def live_frontend(launcher, draw_seed: int, gates=None):
    """Inside the block ``launcher`` (``launch.train``) feeds every
    batch seeded normal extra embeddings in place of its stub's zeros
    and, with ``gates``, the model it builds starts with its cross
    gates at ``gates``: the launcher's own path with the cross path
    live."""
    real_stub, real_get_model = launcher._stub_frontend, launcher.get_model
    gen = torch.Generator(device=DEV).manual_seed(draw_seed)

    def stub(cfg, batch):
        out = real_stub(cfg, batch)
        e = out.get("extra_embeds")
        if e is not None:
            out["extra_embeds"] = torch.randn(
                e.shape, generator=gen, device=e.device,
                dtype=torch.float32).to(e.dtype)
        return out

    def get_model(cfg):
        model = real_get_model(cfg)

        def init(seed=0, *, device="cuda", **kw):
            params = model.init(seed, device=device, **kw)
            open_gates(params, gates)
            return params
        return model._replace(init=init)

    launcher._stub_frontend = stub
    if gates is not None:
        launcher.get_model = get_model
    try:
        yield
    finally:
        launcher._stub_frontend = real_stub
        launcher.get_model = real_get_model


class PrefillRows:
    """Wraps an engine's ``model.prefill`` and records, for every
    request prompt it prefills, the row of its admission batch: the
    engine reads row i of its extra block for the i-th request of a
    batch, whatever its slot (F10)."""

    def __init__(self, eng):
        self.real = eng.model.prefill
        self.rows: dict = {}
        eng.model = eng.model._replace(prefill=self)

    def __call__(self, params, tokens, max_len, lens=None, logits_at=None,
                 extra=None):
        for i, n in enumerate(lens.tolist()):
            self.rows[tokens[i, :n].cpu().numpy().tobytes()] = i
        return self.real(params, tokens, max_len, lens, logits_at, extra)

    def row(self, prompt: np.ndarray) -> int:
        return self.rows[prompt.astype(np.int64).tobytes()]


def logit_gaps(logits: torch.Tensor, tokens: torch.Tensor, tol) -> tuple:
    """Per position, the best logit minus the logit of ``tokens`` and
    the allowed gap rtol * |best| + atol (``tol``): (gaps, allowed)."""
    lg = logits.float()
    best = lg.max(dim=-1).values
    got = lg.gather(-1, tokens.long()[..., None])[..., 0]
    return best - got, tol["rtol"] * best.abs() + tol["atol"]


def phase_vlm_serving(ops, serving, tad, get_config, get_model, Tracer,
                      phase_summary, tree_leaves, tol) -> dict:
    """14: llama-3.2-vision-11b served at full width and depth (40 self
    layers + 8 gated cross layers, bf16, random weights from seed 0,
    every gate opened to ``GATE_OPEN``) through the engine on phase 4's
    traffic with one image block [8, 1600, 4096] of seeded normal
    draws; the decode kernel at its shape first (14e)."""
    label = "14 llama-3.2-vision-11b"
    cfg = get_config("llama-3.2-vision-11b")
    prompts, lens, new = traffic(cfg.vocab_size)
    n_cross = cfg.num_layers // cfg.cross_attn_every
    weights = weight_bytes(cfg)
    pool = kv_pool_bytes(cfg, SLOTS, MAX_LEN)
    cross = (SLOTS * cfg.num_image_tokens * n_cross * 2 * cfg.num_kv_heads
             * cfg.head_dim_ * 2)
    print(f"{label}: {cfg.num_layers} self + {n_cross} cross layers, "
          f"{tree_params(cfg)} params in the tree ({cfg.param_count()} by "
          f"param_count(), F9): predicted weights {weights / GIB:.2f} GiB "
          f"+ bf16 KV pool {pool / GIB:.2f} GiB + cross K/V "
          f"{cross / GIB:.2f} GiB = {(weights + pool + cross) / GIB:.2f} "
          f"GiB, peak 25-28 GiB with prefill; a decode step's weight read "
          f"{weights / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s",
          flush=True)
    gen = torch.Generator(device=DEV).manual_seed(14)
    print("14e: decode attention at llama-3.2-vision-11b's serving shape "
          "(G = 4, Dh 128)", flush=True)
    row = kernel_row(tad, ops, gen, "global", MAX_LEN, None, cfg.kv_dtype,
                     SLOTS, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                     POS["global"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=DEV)
    gates = open_gates(params)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    if n_params != tree_params(cfg) or gates != n_cross:
        raise AssertionError(f"{label}: {n_params} params, {gates} gates")
    print(f"{label}: {n_params} params initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s, {gates} cross gates opened "
          f"to {GATE_OPEN}", flush=True)
    image = extra_draw(cfg, SLOTS, 14)
    tracer = Tracer()
    eng = serving.Engine(
        model, params, serving.ServeConfig(slots=SLOTS, max_len=MAX_LEN,
                                           page_size=16),
        device=DEV, tracer=tracer, extra=image)
    rows = PrefillRows(eng)
    results, stats, elapsed, launches = serve(eng, ops, (prompts, new))
    want = cfg.num_layers * stats["decode_steps"]
    if launches != want or stats["kernel_launches"] != launches:
        raise AssertionError(f"{label}: attention_decode launched "
                             f"{launches} times, expected {want} = "
                             f"{cfg.num_layers} self layers x "
                             f"{stats['decode_steps']} decode steps")
    spans = phase_summary(tracer.events())
    step_ms = decode_step_ms(spans, stats["decode_steps"])
    generated = stats["tokens_generated"]
    peak = torch.cuda.max_memory_allocated() / GIB
    used = [rows.row(p) for p in prompts]
    print(f"{label}: {len(results)} requests (prompts {lens.min()}-"
          f"{lens.max()}), {generated} tokens in {elapsed:.3f} s = "
          f"{generated / elapsed:.2f} tok/s; {stats['decode_steps']} decode "
          f"steps x {cfg.num_layers} = {launches} attention_decode launches "
          f"(the {n_cross} cross layers launch none); decode step "
          f"{step_ms:.3f} ms against a weight read of "
          f"{weights / HBM_BYTES_PER_S * 1e3:.2f} ms; image rows of the "
          f"admission batches {used}; peak {peak:.2f} GiB (predicted "
          f"25-28); {smi_line()}", flush=True)
    # one request per image row, each held alone on the row it was given
    picked = [used.index(r) for r in sorted(set(used))][:VLM_PICKS]
    extras = {i: image[used[i]:used[i] + 1] for i in picked}
    alone = engine_vs_generate(label, serving, model, params, prompts, new,
                               results, picked, MAX_LEN, tol, extras)
    same = sum(alone[i] == results[i].tokens for i in picked)
    # the cross path is live: the same request on another image block
    other = extra_draw(cfg, 1, 15)
    i = picked[0]
    moved = serving.generate(model, params, prompts[i][None],
                             num_tokens=int(new[i]), max_len=MAX_LEN,
                             extra_embeds=other, device=DEV)[0].tolist()
    differ = sum(a != b for a, b in zip(moved, alone[i]))
    print(f"{label}: requests {picked} on image rows "
          f"{[used[i] for i in picked]}: {same} equal to generate on the "
          f"same row token for token, the rest up to bf16 ties; request "
          f"{i} on another image: {differ} of {len(moved)} tokens differ",
          flush=True)
    if len(picked) < 2 or differ == 0:
        raise AssertionError(f"{label}: {len(picked)} rows held, the image "
                             f"changed {differ} tokens")
    del params, results, eng
    return {"launches": launches, "row": row, "tok_s": generated / elapsed,
            "step_ms": step_ms, "peak_gib": peak, "layers": cfg.num_layers,
            "rows": used, "differ": differ}


def phase_whisper_generate(ops, serving, tad, get_config, get_model,
                           tree_leaves) -> dict:
    """14b: whisper-large-v3 ``generate`` at full width and depth (32 +
    32 layers, bf16, random weights from seed 0): 4 prompts of 64
    tokens and 32 new tokens on random frames [4, 1500, 1280]; the
    decode kernel at its shape first (14e)."""
    label = "14b whisper-large-v3"
    cfg = get_config("whisper-large-v3")
    b, s, new = WHISPER_GEN
    t = s + new
    gen = torch.Generator(device=DEV).manual_seed(16)
    print("14e: decode attention at whisper-large-v3's generate shape "
          "(G = 1, Dh 64, Hkv 20)", flush=True)
    row = kernel_row(tad, ops, gen, "global", t, None, cfg.cdtype, b,
                     cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                     [p * t // MAX_LEN for p in POS["global"]])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    params = model.init(0, device=DEV)
    n_params = sum(x.numel() for x in tree_leaves(params))
    if n_params != tree_params(cfg) or model.prefill is not None:
        raise AssertionError(f"{label}: {n_params} params")
    prompts = np.random.RandomState(14).randint(1, cfg.vocab_size,
                                                size=(b, s))
    frames = extra_draw(cfg, b, 16)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        toks = serving.generate(model, params, prompts, num_tokens=new,
                                extra_embeds=frames, device=DEV)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launches["attention_decode"]
        peak = torch.cuda.max_memory_allocated() / GIB
        # teacher-forced: the full-sequence forward over prompt +
        # generated tokens must pick each generated token (bf16 ties)
        x = torch.cat([torch.as_tensor(prompts, device=DEV),
                       toks.long()], dim=1)[:, :-1]
        logits = model.apply(params, x, frames)[:, s - 1:]
        other = serving.generate(model, params, prompts, num_tokens=new,
                                 extra_embeds=extra_draw(cfg, b, 17),
                                 device=DEV)
    want = cfg.num_layers * t
    if launches != want:
        raise AssertionError(f"{label}: {launches} attention_decode "
                             f"launches, expected {want} = "
                             f"{cfg.num_layers} x {t} decode steps")
    gaps, allowed = logit_gaps(logits, toks,
                               tad.decode_parity_tolerance(torch.bfloat16))
    equal = int((gaps == 0).sum())
    worst = float((gaps / allowed).max())
    differ = int((other != toks).sum())
    print(f"{label}: generate {b} prompts x {s} tokens + {new} new on "
          f"random frames {tuple(frames.shape)} in {elapsed:.3f} s "
          f"({b * new / elapsed:.2f} new tok/s, {t} decode steps x "
          f"{cfg.num_layers} = {launches} attention_decode launches); "
          f"teacher-forced apply picks the generated token at {equal} of "
          f"{toks.numel()} positions, the rest within {worst:.3f} of the "
          f"allowed bf16 gap; other frames change {differ} of "
          f"{toks.numel()} tokens; peak {peak:.2f} GiB; {smi_line()}",
          flush=True)
    if worst > 1.0 or differ == 0:
        raise AssertionError(f"{label}: worst gap {worst:.3f} of allowed, "
                             f"{differ} tokens moved by the frames")
    del params
    return {"launches": launches, "row": row, "seconds": elapsed,
            "tok_s": b * new / elapsed, "peak_gib": peak,
            "layers": cfg.num_layers}


def cross_grads(out) -> dict:
    """The last step's gradient norms of the cross layers' attention
    weights and gates (``--layerwise-every 1``): finite and non-zero, so
    the opened gates put the image on the path."""
    last = out["history"][-1]
    norms = {k[len("layerwise/"):-len("/g_norm")]: float(v)
             for k, v in last.items()
             if k.startswith("layerwise/") and "_cross/" in k
             and k.endswith("/g_norm")}
    attn = {k: v for k, v in norms.items()
            if "/attn/" in k or k.endswith("/gate")}
    if len(attn) != 5 or not all(np.isfinite(v) and v > 0
                                 for v in attn.values()):
        raise AssertionError(f"cross layers' gradient norms {attn}")
    print(f"  cross layers' gradient norms at the last step: "
          f"{ {k: round(v, 6) for k, v in attn.items()} }", flush=True)
    return attn


def phase_cross_families(train_module, ops, su, sref, lu, layerwise,
                         flatten, serving, tad, get_config, get_model,
                         Tracer, phase_summary, tree_leaves) -> dict:
    """14-14e: llama-3.2-vision-11b served at full width and depth,
    whisper-large-v3 generating and trained at full width and depth,
    llama-3.2-vision-11b trained cut in depth to whole groups; the
    decode kernel at both new shapes (14e)."""
    run = train_module.run
    out = {}

    def clear():
        gc.collect()
        torch.cuda.empty_cache()

    clear()

    def cut(arch):
        return cut_config(get_config, arch)

    for arch, label in (("llama-3.2-vision-11b", "14"),
                        ("whisper-large-v3", "14b / 14c")):
        print(cut_line(f"{label} {arch}", get_config(arch), cut(arch)),
              flush=True)
    out["14"] = phase_vlm_serving(ops, serving, tad, cut, get_model,
                                  Tracer, phase_summary, tree_leaves,
                                  tad.decode_parity_tolerance(torch.bfloat16))
    clear()
    out["14b"] = phase_whisper_generate(ops, serving, tad, cut, get_model,
                                        tree_leaves)
    clear()

    whisper = cut("whisper-large-v3")
    n = tree_params(whisper)
    print(f"14c whisper-large-v3: {n} params ({whisper.param_count()} by "
          f"param_count(), F9): predicted fused peak "
          f"{n * TRAIN_BYTES_PER_PARAM / GIB:.2f} GiB + activations (one "
          f"encoder layer's [8, 20, 1500, 1500] f32 scores "
          f"{8 * 20 * 1500 * 1500 * 4 / GIB:.2f} GiB under remat); batches "
          f"carry random frames [8, 1500, 1280]", flush=True)
    with live_frontend(train_module, 17), \
            config_cut(train_module, "whisper-large-v3",
                       **FAMILY_CUTS["whisper-large-v3"]):
        out["14c"] = phase_train_full(
            run, ops, su, sref, tree_leaves,
            ["--arch", "whisper-large-v3"] + FAMILY_ARGV,
            "14c whisper-tvlars-f32", want_layers=whisper.num_layers)
        clear()
        out["14c-pt"] = phase_train_per_tensor(
            run, ops, lu, sref, layerwise, flatten, tree_leaves,
            ["--arch", "whisper-large-v3", "--optimizer", "wa-lars",
             "--use-kernel", "per_tensor", "--precision", "f32",
             "--global-batch", "8", "--seq", "512", "--steps", "3"],
            "14c whisper-wa-lars-per-tensor",
            want_layers=whisper.num_layers)
    clear()
    # the launcher's own stub (zero frames), one step: zero frames give
    # the encoder zero-variance rows, whose LayerNorm backward scales by
    # rsqrt(eps) in every layer, so the gradient overflows at full depth
    # and step 1 would be NaN, as in the reference (F11)
    ops.reset_launches()
    with config_cut(train_module, "whisper-large-v3",
                    **FAMILY_CUTS["whisper-large-v3"]):
        stub = run(["--arch", "whisper-large-v3", "--optimizer", "tvlars",
                    "--use-kernel", "fused", "--global-batch", "8",
                    "--seq", "512", "--steps", "1", "--device", DEV],
                   log_fn=lambda line: print(
                       f"  14c launch.train stub: {line}", flush=True))
    want = {k: 0 for k in ops.launches}
    want.update({k: 1 for k in su.KERNELS["lars"]})
    if dict(ops.launches) != want or not np.all(np.isfinite(
            stub["losses"])):
        raise AssertionError(f"14c stub: launches {dict(ops.launches)}, "
                             f"losses {stub['losses']}")
    print(f"14c launch.train --arch whisper-large-v3 on its zero-frame "
          f"stub: 1 step, loss {stub['losses'][0]:.4f}, grad_norm "
          f"{float(stub['history'][0]['grad_norm'])} (F11: zero-variance "
          f"encoder rows), 1 + 1 segmented launches, peak "
          f"{(stub['peak_memory_bytes'] or 0) / GIB:.2f} GiB", flush=True)
    out["14c-stub"] = {k: 1 for k in su.KERNELS["lars"]}
    del stub
    clear()

    vlm = get_config("llama-3.2-vision-11b")
    every = vlm.cross_attn_every

    def gib(layers):
        return tree_params(vlm.replace(num_layers=layers)) \
            * TRAIN_BYTES_PER_PARAM / GIB + TRAIN_MARGIN_GIB

    cuts = {k: gib(k) for k in range(every, vlm.num_layers + 1, every)}
    layers = max(k for k, g in cuts.items() if g <= TRAIN_CEILING_GIB)
    print(f"14d llama-3.2-vision-11b: reduced: num_layers {vlm.num_layers} "
          f"-> {layers} ({layers // every} group(s) of {every} self + 1 "
          f"cross layer, "
          f"{tree_params(vlm.replace(num_layers=layers))} params), the "
          f"deepest whole-group cut predicted under {TRAIN_CEILING_GIB} GiB "
          f"({', '.join(f'{k} layers {g:.2f} GiB' for k, g in cuts.items() if k <= 2 * every)}: "
          f"{TRAIN_BYTES_PER_PARAM} B a parameter + {TRAIN_MARGIN_GIB} GiB); "
          f"gates opened to {GATE_OPEN}, random image embeddings",
          flush=True)
    with depth_cut(train_module, "llama-3.2-vision-11b", layers), \
            live_frontend(train_module, 18, GATE_OPEN):
        out["14d"] = phase_train_full(
            run, ops, su, sref, tree_leaves,
            ["--arch", "llama-3.2-vision-11b"] + FAMILY_ARGV,
            "14d llama-vision-tvlars-f32", want_layers=layers,
            inspect=cross_grads)
    out["14d"]["predicted_gib"] = cuts[layers]
    clear()
    return out


def phase_cross_families_small(get_smoke_config, get_model, serving,
                               build_optimizer, training, lm_iterator,
                               tree_leaves, tree_map, ops, su) -> None:
    """14f: the whisper and llama-vision smoke configs in f32 (gates
    opened, random extra embeddings), the card (kernels) against the
    CPU (plain versions) on the same weights: logits within 1e-4,
    ``generate``'s greedy tokens equal, one fused TVLARS step at phase
    8's bounds with 1 + 1 segmented launches, and (vlm) the engine's
    tokens with distinct image rows per slot equal."""
    for arch in CROSS_SMOKE:
        model = get_model(get_smoke_config(arch))
        cfg = model.cfg
        cpu = model.init(0, device="cpu")
        if cfg.family == "vlm":
            open_gates(cpu)
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        rng = np.random.RandomState(6)
        toks = rng.randint(1, 512, size=(2, 16))
        extra = extra_draw(cfg, 2, 19, device="cpu")
        with torch.no_grad():
            lc = model.apply(cpu, torch.as_tensor(toks), extra)
            lg = model.apply(gpu, torch.as_tensor(toks, device=DEV),
                             extra.to(DEV)).cpu()
        err = (lg - lc).abs().max().item()
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
        gen = [serving.generate(model, p, toks[:, :6], num_tokens=8,
                                extra_embeds=extra, device=d).cpu()
               for p, d in ((cpu, "cpu"), (gpu, DEV))]
        if not torch.equal(*gen):
            raise AssertionError(f"14f {arch}: generate card {gen[1]} "
                                 f"!= cpu {gen[0]}")
        out = []
        for dev, params in (("cpu", cpu), (DEV, gpu)):
            opt = build_optimizer("tvlars", total_steps=10,
                                  learning_rate=2.0, batch_size=8,
                                  use_kernel="fused",
                                  segments=model.segments, device=dev)
            state = training.TrainState.create(
                tree_map(lambda t: t.detach().clone(), params), opt)
            step = training.make_train_step(training.lm_task(model), opt)
            bt = next(lm_iterator(8, 64, cfg.vocab_size, seed=1,
                                  device=dev))
            bt["extra_embeds"] = extra_draw(cfg, 8, 20, device="cpu").to(dev)
            ops.reset_launches()
            state, m = step(state, bt)
            out.append((float(m["loss"]), state.params,
                        dict(ops.launches)))
        (lossc, pc, kc), (lossg, pg, kg) = out
        want = {k: 0 for k in kg}
        want.update({k: 1 for k in su.KERNELS["lars"]})
        if kg != want or any(kc.values()):
            raise AssertionError(f"14f {arch}: launches cpu {kc} card {kg}")
        np.testing.assert_allclose(lossg, lossc, rtol=1e-5)
        worst = 0.0
        for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
            a, b = a.detach().cpu().numpy(), b.detach().numpy()
            scale = float(np.abs(b).max())
            worst = max(worst, float(np.abs(a - b).max()) / scale)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
        engine_note = ""
        if cfg.family == "vlm":
            slots = 3
            block = extra_draw(cfg, slots, 21, device="cpu")
            prompts = [rng.randint(1, 512, size=n).astype(np.int32)
                       for n in (5, 9, 7)]
            got = []
            for dev, params in (("cpu", cpu), (DEV, gpu)):
                eng = serving.Engine(
                    model, params, serving.ServeConfig(
                        slots=slots, max_len=32, page_size=8,
                        prefill_batch=slots),
                    device=dev, extra=block.to(dev))
                ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
                eng.drain()
                got.append([eng.result(i).tokens for i in ids])
            if got[0] != got[1]:
                raise AssertionError(f"14f {arch}: engine card {got[1]} "
                                     f"!= cpu {got[0]}")
            engine_note = (f", the engine's tokens on {slots} distinct "
                           f"image rows equal")
        print(f"14f {arch}: smoke f32, card == cpu: logits within "
              f"{err:.3e}, generate's 8 tokens x 2 rows equal, one fused "
              f"TVLARS step (1 + 1 launches) loss {lossg:.6f}, worst param "
              f"gap {worst:.3e} of its leaf's scale{engine_note}; "
              f"{smi_line()}", flush=True)


# ------------------------------------------- ranks shared by 15-18
class RankPool:
    """``size`` gloo ranks sharing the card, started once (``spawn``
    start method, a ``FileStore`` rendezvous in a temporary directory)
    and joined into one world that phases 15-18 hand their calls to in
    turn: :meth:`run` gives every rank ``fn(*args)`` and returns the
    results in rank order, as ``launch.mesh.spawn`` does with a world of
    its own. Before each call a rank zeroes the launch counts and the
    peak memory statistic (what a new process starts from); after it,
    it frees what the call left cached. A rank that raises, or a call
    that does not finish within its timeout, stops every rank and
    raises here; a rank also stops when this process is gone."""

    def __init__(self, size: int, device=DEV, timeout: float = 900.0):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
        init = "file://" + os.path.join(self.tmp, "rendezvous")
        self.jobs = [ctx.Queue() for _ in range(size)]
        self.out = ctx.Queue()
        self.procs = [ctx.Process(target=pool_rank_main,
                                  args=(r, size, str(device), init, timeout,
                                        self.jobs[r], self.out))
                      for r in range(size)]
        for p in self.procs:
            p.start()

    def run(self, fn, args=(), timeout: float = 600.0) -> list:
        import queue
        for q in self.jobs:
            q.put((fn, tuple(args)))
        results: dict = {}
        deadline = time.monotonic() + timeout
        while len(results) < self.size:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = self.out.get(timeout=min(max(left, 0.01),
                                                           5.0))
            except queue.Empty:
                dead = [p.exitcode for p in self.procs
                        if p.exitcode is not None]
                if left > 5.0 and not dead:
                    continue
                self.close(wait=1.0)
                raise RuntimeError(
                    f"{fn.__name__} on {self.size} ranks: " + (
                        f"ranks exited with codes {dead}" if dead else
                        f"did not finish in {timeout:.0f} s"))
            if not ok:
                self.close(wait=1.0)
                raise RuntimeError(f"{fn.__name__}: rank {rank} of "
                                   f"{self.size} failed:\n{value}")
            results[rank] = value
        return [results[r] for r in range(self.size)]

    def close(self, wait: float = 60.0) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=wait)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


def pool_rank_main(rank, size, device, init, timeout, jobs, out) -> None:
    """One rank of a :class:`RankPool`: join the world, then run the
    calls handed to it until told to stop."""
    import multiprocessing
    import queue
    import traceback
    from repro_torch import distributed as dist_lib
    from repro_torch.kernels import ops
    parent = multiprocessing.parent_process()
    dist_lib.init_world("gloo", device, rank, size, init, timeout)
    try:
        while True:
            try:
                job = jobs.get(timeout=5.0)
            except queue.Empty:
                if parent is not None and not parent.is_alive():
                    return
                continue
            if job is None:
                return
            fn, args = job
            ops.reset_launches()
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            try:
                result = fn(*args)
                torch.distributed.barrier()
            except BaseException:
                out.put((rank, False, traceback.format_exc()))
                raise
            out.put((rank, True, result))
            del result, job, fn, args
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        dist_lib.leave()


_POOLS: dict = {}


def on_ranks(fn, size: int, args=(), timeout: float = 600.0) -> list:
    """``fn(*args)`` on every rank of the script's shared world of
    ``size`` gloo ranks (a :class:`RankPool`, started on first use and
    stopped at this process's exit)."""
    if not _POOLS:
        # runs before multiprocessing's own exit hook, which would wait
        # on the idle ranks
        atexit.register(close_pools)
    if size not in _POOLS:
        _POOLS[size] = RankPool(size)
    return _POOLS[size].run(fn, args, timeout)


def close_pools() -> None:
    """Stop every rank :func:`on_ranks` started."""
    while _POOLS:
        _POOLS.popitem()[1].close()


# ------------------------------------------------ 15-15d: data parallel
DP_ARCH = "qwen2.5-3b"
DP_RANKS = 2
DP_STEPS = 1
# of 36: the script's time budget. The gloo all-reduce moves every
# gradient through the host each step, 7.1 GB at the 15 layers that fit
# half the card and 3.7 GB at 4 (the table and head are 622M of the
# params at any depth)
DP_LAYERS = 2
DP_ARGV = ["--arch", DP_ARCH, "--optimizer", "tvlars", "--use-kernel",
           "fused", "--precision", "f32", "--global-batch", "8", "--seq",
           "512", "--steps", str(DP_STEPS), "--layerwise-every", "1",
           "--device", DEV]
# per parameter on a rank: phase 7's measured 65.87 GiB over qwen2.5-3b's
# 3,397,103,616 params (bf16 weight and gradient, f32 momentum, the fused
# update's packed weights, gradients and delta, activations), plus 2 B
# for the gradients held in f32 for the all-reduce instead of bf16
DP_BYTES_PER_PARAM = 65.87 * 2 ** 30 / 3_397_103_616 + 2
DP_CONTEXT_GIB = 0.75          # a rank's CUDA context, outside its peak
# 15b: the controller scenario of the CPU tests, on the card
DP_MB = 2
DP_READINGS = {0: float(DP_MB), 2: 8.0 * DP_MB, 4: 8.0 * DP_MB,
               6: float(DP_MB), 8: 8.0 * DP_MB}
DP_BATCHES = [2, 2, 2, 16, 16, 16, 16, 2, 2, 16]
DP_NCCL_REPEATS = 3


# D = 2 against D = 1 on the same samples, relative, per metric (the
# worst over 3 steps and every segment): each rank's bf16 gradients
# round apart from one backward over all 8 rows. About ten times the
# readings on the H100 (loss 4.6e-6, grad_norm 7.0e-5, w_norm 4.7e-4,
# g_norm 8.4e-4, trust_ratio 1.1e-3), and the duplicate-shard control
# below must exceed them
DP_BOUNDS = {"loss": 5e-5, "grad_norm": 7e-4, "w_norm": 5e-3,
             "g_norm": 1e-2, "trust_ratio": 1e-2}


def gaps_where(got: list, want: list) -> tuple:
    """The worst relative gap of every ``DP_BOUNDS`` metric between two
    runs' histories, over steps and segments, and the key (segment)
    where each is."""
    worst, where = {}, {}
    for a, b in zip(got, want):
        for key in b:
            metric = key.split("/")[-1]
            if metric in DP_BOUNDS:
                rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                if rel >= worst.get(metric, -1.0):
                    worst[metric], where[metric] = rel, key
    return worst, where


def dp_gaps(got: list, want: list) -> dict:
    """The worst relative gap of every ``DP_BOUNDS`` metric between two
    runs' histories, over steps and segments."""
    return gaps_where(got, want)[0]


@contextlib.contextmanager
def duplicated_shards(launcher, d: int):
    """Inside the block every batch of the launcher's ``lm_iterator``
    repeats its first of ``d`` shards ``d`` times: a D = 1 run then
    computes what ``d`` ranks that all read shard 0 compute (the
    duplicate-shard fault the phase's bounds must catch)."""
    real = launcher.lm_iterator

    def repeat_first(x):
        b = x.shape[0] // d
        return x[:b].repeat(d, *([1] * (x.dim() - 1)))

    def faulty(*a, **kw):
        for batch in real(*a, **kw):
            yield {k: repeat_first(v) for k, v in batch.items()}

    launcher.lm_iterator = faulty
    try:
        yield
    finally:
        launcher.lm_iterator = real


def dp_depth(cfg, budget_gib: float, most: int) -> tuple:
    """(layers, predicted GiB per rank): the deepest cut of ``cfg`` of
    at most ``most`` layers whose rank is predicted under
    ``budget_gib``."""
    one, two = (tree_params(cfg.replace(num_layers=n)) for n in (1, 2))
    per, fixed = two - one, 2 * one - two

    def gib(n):
        return (fixed + n * per) * DP_BYTES_PER_PARAM / GIB

    n = max(k for k in range(1, min(cfg.num_layers, most) + 1)
            if gib(k) <= budget_gib)
    return n, gib(n)


class StepWatch:
    """A callback of every step: this rank's state fingerprint and the
    kernel launches of the step."""
    name, every = "watch", 1

    def __init__(self, ops):
        from repro_torch.training.train_state import fingerprint
        self.ops, self.fingerprint = ops, fingerprint
        self.prints, self.launches = [], []
        self._seen = dict(ops.launches)

    def __call__(self, step, state):
        now = dict(self.ops.launches)
        self.launches.append({k: now[k] - self._seen.get(k, 0)
                              for k in now if now[k] != self._seen.get(k, 0)})
        self._seen = now
        self.prints.append(self.fingerprint(state))
        return {}


@contextlib.contextmanager
def watched_fit(launcher, watch):
    """Inside the block the launcher's ``fit`` also calls ``watch`` after
    every step (first among its callbacks)."""
    real = launcher.fit

    def fit(step_fn, state, batches, n, *, options):
        options = dataclasses.replace(
            options, callbacks=(watch, *options.callbacks))
        return real(step_fn, state, batches, n, options=options)

    launcher.fit = fit
    try:
        yield
    finally:
        launcher.fit = real


def dp_rank(layers: int, ckpt_dir: str) -> dict:
    """Phase 15 on one rank: ``launch.train.run --mesh-data 2`` on
    qwen2.5-3b cut to ``layers`` layers; then rank 0 saves the params
    (15d) and every rank waits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_launch
    from repro_torch.models import convert
    from repro_torch.training.train_state import fingerprint
    mesh = mesh_lib.make_data_mesh(DP_RANKS)
    ops.reset_launches()
    watch = StepWatch(ops)
    with depth_cut(train_launch, DP_ARCH, layers), \
            watched_fit(train_launch, watch):
        out = train_launch.run(
            DP_ARGV + ["--mesh-data", str(DP_RANKS), "--microbatch",
                       str(8 // DP_RANKS)],
            log_fn=lambda line: print(f"  15 rank {mesh.rank}: {line}",
                                      flush=True))
    state, cfg = out["state"], out["model"].cfg
    params_print = fingerprint(state.params)
    tree = convert.params_to_jax(cfg, state.params) if mesh.rank == 0 \
        else None
    del state
    t0 = time.perf_counter()
    checkpoint.save(ckpt_dir, tree, step=DP_STEPS, mesh=mesh)
    save_s = time.perf_counter() - t0
    del tree
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": mesh.backend, "history": out["history"],
            "loss_grad": out["loss_grad_seconds"],
            "all_reduce": out["all_reduce_seconds"],
            "optimizer": out["optimizer_seconds"],
            "peak": out["peak_memory_bytes"], "launches": watch.launches,
            "equal": mesh_lib.all_equal(mesh, watch.prints),
            "params_print": params_print, "save_s": save_s}


def dp_controller_rank() -> dict:
    """15b on one of 4 ranks: the smoke LM under the controller's (D, K)
    schedule (1, 1) -> (4, 2), scripted noise readings as the CPU
    tests', fused TVLARS on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import build_optimizer, schedules
    from repro_torch.data import pipeline
    from repro_torch.data.synthetic import lm_sample_source
    from repro_torch.diagnostics import sink as sinks
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.training import (AdaptiveBatchController,
                                      ControllerConfig, FitOptions,
                                      TrainState, fit, lm_task,
                                      make_train_step)
    from repro_torch.training.train_state import replicate
    model = get_model(get_smoke_config(DP_ARCH))
    dev = mesh_lib.world().device
    cfg = ControllerConfig(microbatch=DP_MB, batch_min=DP_MB,
                           batch_max=64 * DP_MB, every=2, deadband=0.0,
                           ema=0.0, data_max=4)

    def opt_for(b):
        return build_optimizer("tvlars", total_steps=20, learning_rate=1.0,
                               batch_size=b, base_batch_size=64,
                               use_kernel="fused", segments=model.segments,
                               device=dev)

    ctl = AdaptiveBatchController(
        lambda opt, k, mesh: make_train_step(lm_task(model), opt,
                                             accum_steps=k, mesh=mesh),
        opt_for, lambda step, state: {
            "grad_noise_scale": DP_READINGS.get(step, float("nan"))},
        cfg, init_batch=DP_MB, base_lr=1.0, base_batch_size=64)
    state = replicate(TrainState.create(model.init(0, device=dev),
                                        ctl.optimizer()), ctl.mesh_for(4))
    stream = pipeline.MicrobatchedStream(
        lm_sample_source(64, model.cfg.vocab_size, seed=0, device=dev),
        DP_MB)
    ops.reset_launches()
    watch = StepWatch(ops)
    sink = sinks.MemorySink()
    t0 = time.perf_counter()
    _, history = fit(None, state, stream, len(DP_BATCHES),
                     options=FitOptions(sink=sink, callbacks=[watch],
                                        controller=ctl,
                                        rank=ctl.mesh_for(4).rank))
    seconds = time.perf_counter() - t0
    # every rank keeps the history; rank 0 alone writes the sink
    records = [r for r in sink.records if "controller/changed" in r]
    return {"batches": [h["global_batch"] for h in history],
            "records": len(records),
            "launches": watch.launches, "compiles": ctl.compiles,
            "visited": [list(t) for t in ctl.visited_targets],
            "lr_ok": all(math.isclose(r["controller/lr"],
                                      schedules.batch_scaled_lr(
                                          1.0, int(r["controller/"
                                                     "global_batch"]),
                                          64, "sqrt"), rel_tol=1e-12)
                         for r in records),
            "switches": ctl.switches, "seconds": seconds,
            "equal": mesh_lib.all_equal(ctl.mesh_for(4), watch.prints)}


def dp_nccl_rank() -> dict:
    """15c on a world of one rank over NCCL: the bucketed all-reduce over
    f32 buffers of qwen2.5-3b's leaf shapes (a sum of one: the values
    must not move), timed; then one ``--mesh-data 1``
    step of the launcher on the smoke LM in that world."""
    from repro_torch.configs import get_config
    from repro_torch.core.base import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_launch
    from repro_torch.models import jax_template
    from repro_torch.training.train_state import fingerprint
    mesh = mesh_lib.make_data_mesh(1)
    gen = torch.Generator(device=mesh.device).manual_seed(15)
    bufs = [torch.rand(t.shape, generator=gen, device=mesh.device)
            for t in tree_leaves(jax_template(get_config(DP_ARCH)))]
    before = fingerprint(bufs)
    times = []
    for _ in range(DP_NCCL_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.mean_(bufs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    nbytes = sum(b.numel() * 4 for b in bufs)
    same = fingerprint(bufs) == before
    del bufs
    torch.cuda.empty_cache()
    ops.reset_launches()
    out = train_launch.run(
        ["--smoke", "--mesh-data", "1", "--steps", "1", "--seq", "64",
         "--use-kernel", "fused", "--device", DEV, "--dist-backend",
         "nccl"], log_fn=lambda line: print(f"  15c: {line}", flush=True))
    return {"backend": mesh.backend, "world": mesh.world, "bytes": nbytes,
            "seconds": times, "unchanged": same,
            "launches": dict(ops.launches), "loss": out["losses"][0]}


def phase_data_parallel(train_launch, ops, serving, mesh_lib, get_config,
                        get_model, tree_leaves) -> dict:
    """15-15d: data parallelism on the card (see the module docstring)."""
    from repro_torch.training.train_state import fingerprint
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    budget = free / DP_RANKS / GIB - DP_CONTEXT_GIB
    cfg_full = get_config(DP_ARCH)
    layers, pred = dp_depth(cfg_full, budget, DP_LAYERS)
    print(f"15 {DP_ARCH}: reduced: num_layers {cfg_full.num_layers} -> "
          f"{layers} (the script's time budget: at most {DP_LAYERS}, the "
          f"all-reduce's bytes; and predicted under {budget:.2f} GiB a "
          f"rank: half of the {free / GIB:.2f} GiB free less a "
          f"{DP_CONTEXT_GIB} GiB context; {DP_BYTES_PER_PARAM:.2f} B a "
          f"parameter); predicted peak per rank {pred:.2f} GiB; width as "
          f"published", flush=True)

    # the D = 1 run on the same samples from the same state, kept as its
    # small tables only
    ops.reset_launches()
    with depth_cut(train_launch, DP_ARCH, layers):
        one = train_launch.run(DP_ARGV, log_fn=lambda line: print(
            f"  15 D=1: {line}", flush=True))
    single = one["history"]
    single_peak = one["peak_memory_bytes"]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    # the control: a D = 1 run whose second shard repeats the first
    with depth_cut(train_launch, DP_ARCH, layers), \
            duplicated_shards(train_launch, DP_RANKS):
        fault = dp_gaps(train_launch.run(DP_ARGV, log_fn=lambda line: None)[
            "history"], single)
    gc.collect()
    torch.cuda.empty_cache()
    caught = sorted(k for k, v in fault.items() if v > DP_BOUNDS[k])
    print("15 control: rank 1 reading shard 0 (a D = 1 run on the "
          "duplicated shards) against D=1, worst relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(fault.items()))
          + f"; over its bound: {caught}", flush=True)
    if not caught:
        raise AssertionError("15: the bounds do not catch a duplicated "
                             "shard")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        need = weight_bytes(cfg_full.replace(num_layers=layers)) + GIB
        free_disk = shutil.disk_usage(tmp).free
        if free_disk < need:
            raise RuntimeError(f"15d: {free_disk / 1e9:.1f} GB free under "
                               f"{tmp}, the checkpoint needs "
                               f"{need / 1e9:.1f} GB")
        t0 = time.perf_counter()
        ranks = on_ranks(dp_rank, DP_RANKS, args=(layers, tmp),
                         timeout=600)
        spawn_s = time.perf_counter() - t0
        want = {"seg_norm_lars": 1, "seg_apply_lars": 1}
        for r in ranks:
            if r["launches"] != [want] * DP_STEPS:
                raise AssertionError(f"15 rank {r['rank']}: launches per "
                                     f"step {r['launches']}, expected "
                                     f"{want}")
            if not r["equal"]:
                raise AssertionError("15: the ranks' states differ after a "
                                     "step")
        worst = dp_gaps(ranks[0]["history"], single)
        over = {k: v for k, v in worst.items() if not v <= DP_BOUNDS[k]}
        if over or set(worst) != set(DP_BOUNDS):
            raise AssertionError(f"15: D=2 against D=1 worst relative "
                                 f"{worst}, bounds {DP_BOUNDS}")
        for r in ranks:
            compute = [lg - ar for lg, ar in zip(r["loss_grad"],
                                                 r["all_reduce"])]
            print(f"15 rank {r['rank']} ({r['backend']}, {r['device']}): "
                  f"per step loss+grad {[round(x * 1e3, 1) for x in compute]}"
                  f" ms, all-reduce (host-staged gloo over one card) "
                  f"{[round(x * 1e3, 1) for x in r['all_reduce']]} ms, "
                  f"optimizer {[round(x * 1e3, 1) for x in r['optimizer']]}"
                  f" ms; peak {r['peak'] / GIB:.2f} GiB (predicted "
                  f"{pred:.2f}); launches per step {r['launches'][0]}",
                  flush=True)
        print(f"15: {DP_RANKS} ranks of {layers} layers on one card, "
              f"{DP_STEPS} steps of 8 x 512 (4 x 512 a rank) in "
              f"{spawn_s:.1f} s on the shared ranks (started on first "
              f"use); ranks bitwise equal after "
              f"every step (fingerprints); against D=1 on the same samples "
              f"(peak {single_peak / GIB:.2f} GiB) worst relative "
              + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
              + f" (bounds {DP_BOUNDS}); {smi_line()}", flush=True)

        # 15d: rank 0's checkpoint restored here (D = 1) and served
        cfg = cfg_full.replace(num_layers=layers)
        model = get_model(cfg)
        sc = serving.ServeConfig(slots=4, max_len=1024, page_size=16)
        t0 = time.perf_counter()
        eng = serving.Engine.from_checkpoint(
            tmp, model, sc, device=DEV, mesh=mesh_lib.make_data_mesh(1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        placed = {str(t.device) for t in tree_leaves(eng.params)}
        if placed != {str(torch.device(DEV, 0))}:
            raise AssertionError(f"15d: restored onto {placed}, asked for "
                                 f"{DEV}")
        if fingerprint(eng.params) != ranks[0]["params_print"]:
            raise AssertionError("15d: the restored params differ from the "
                                 "ranks' trained params")
        results, stats, elapsed, launches = serve(
            eng, ops, requests_of(cfg.vocab_size, 15, 4, (64, 256),
                                  (16, 32)))
        if launches != layers * stats["decode_steps"]:
            raise AssertionError(f"15d: {launches} decode launches for "
                                 f"{stats['decode_steps']} steps")
        print(f"15d: rank 0 saved the params in {ranks[0]['save_s']:.2f} s; "
              f"restored here (D=1) by Engine.from_checkpoint in "
              f"{restore_s:.2f} s, bitwise the ranks' (fingerprints); "
              f"{len(results)} requests, {stats['tokens_generated']} tokens "
              f"in {elapsed:.3f} s, {launches} attention_decode launches",
              flush=True)
        del eng, results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 15b: the controller's D knob, 4 ranks on the smoke LM
    ctl = on_ranks(dp_controller_rank, 4, timeout=300)
    for i, r in enumerate(ctl):
        ok = (r["batches"] == [float(b) for b in DP_BATCHES]
              and r["records"] == (len(DP_BATCHES) // 2 if i == 0 else 0)
              and r["launches"] == [{"seg_norm_lars": 1,
                                     "seg_apply_lars": 1}] * len(DP_BATCHES)
              and r["compiles"] == 2 and r["visited"] == [[1, 1], [4, 2]]
              and r["switches"] == 3 and r["lr_ok"] and r["equal"])
        if not ok:
            raise AssertionError(f"15b rank {i}: {r}")
    print(f"15b: the controller on 4 ranks (gloo, one card), smoke "
          f"{DP_ARCH}: global batches {ctl[0]['batches']}, (D, K) built "
          f"{ctl[0]['visited']} ({ctl[0]['compiles']} steps, "
          f"{ctl[0]['switches']} switches), controller/lr = "
          f"batch_scaled_lr at every boundary, 1 + 1 segmented launches "
          f"per rank per step, ranks bitwise equal after every step; "
          f"{ctl[0]['seconds']:.1f} s", flush=True)

    # 15c: the NCCL route at world size 1
    nccl = mesh_lib.spawn(dp_nccl_rank, 1, "nccl", DEV, timeout=300)[0]
    if not (nccl["unchanged"] and nccl["backend"] == "nccl"
            and nccl["launches"].get("seg_norm_lars") == 1
            and nccl["launches"].get("seg_apply_lars") == 1
            and math.isfinite(nccl["loss"])):
        raise AssertionError(f"15c: {nccl}")
    best = min(nccl["seconds"])
    print(f"15c: NCCL, world of 1: the bucketed all-reduce over "
          f"{nccl['bytes']} B of f32 (qwen2.5-3b's leaves) in "
          f"{[round(s * 1e3, 2) for s in nccl['seconds']]} ms "
          f"({nccl['bytes'] / best / 1e9:.1f} GB/s of buffer, a sum of "
          f"one), values unchanged; one --mesh-data 1 step through the "
          f"launcher: loss {nccl['loss']:.4f}, 1 + 1 segmented launches; "
          f"{smi_line()}", flush=True)
    return {"layers": layers, "predicted_gib": pred, "ranks": ranks,
            "controller": ctl, "nccl": nccl,
            "launches": {k: sum(s.get(k, 0) for s in ranks[0]["launches"])
                         for k in SEG_LARS},
            "controller_launches": {
                k: sum(s.get(k, 0) for s in ctl[0]["launches"])
                for k in SEG_LARS}}


# ------------------------------------------------ 16-16b: the model axis
TP_ARCH = "gemma3-12b"
# phase 16's depth: cut from 48 (4 of its local:global groups of 6)
# when phases 17-17d came in (the script's time aim)
TP_LAYERS = 6
TP_MESH = (1, 2)               # (data, model): two gloo ranks, one card
TP_SLOTS, TP_MAX_LEN = 4, 288  # prompts 64-256 + 16-32 new tokens
TP_SPLIT_STEPS = 8             # decode steps of the timed split
TP_CONTEXT_GIB = 0.5           # activations, logits, the CUDA allocator
TP_PEAK_MARGIN_GIB = 1.0       # |peak - prediction| allowed per rank
# the largest and the mean |logit gap| to M = 1 over the prefill and
# teacher-forced decode logits (bf16, 262,144 words, logits of std
# ~1.24): each rank's wo partial is rounded to bf16 before the f32 sum,
# so bits differ from M = 1's. An emulation of that rounding on the CPU
# at full width cut to 6 / 12 layers (vocabulary 16,384) gave max 0.063
# / 0.070, mean 0.0084 / 0.0109; half of every wo partial dropped gave
# max 4.0, mean 0.65. The fault (every wo left unsummed) must exceed both
TP_LOGIT_BOUND = 0.5
TP_LOGIT_MEAN_BOUND = 0.08
TP_SMALL = ("gemma3-12b", "qwen2-72b")
TP_SMALL_MESH = (2, 2)
TP_SMALL_SERVE = dict(slots=4, max_len=48, page_size=8, prefill_batch=4)
TP_SMALL_PROMPTS = [(0, 5, 12), (1, 19, 9), (2, 3, 16), (3, 11, 7),
                    (4, 26, 10), (5, 8, 14)]
# 16b, f32 smoke configs: prefill logits of the (2, 2) ranks on the card
# against M = 1 on the CPU; a bias with the other rank's rows must
# exceed it
TP_SMALL_LOGIT_BOUND = 1e-3


def tp_requests(vocab: int) -> tuple:
    return requests_of(vocab, 16, 4, (64, 256), (16, 32))


def teacher_forced(L, model, params, prompts, tokens, mesh=None,
                   max_len: int = TP_MAX_LEN) -> list:
    """The requests as one right-padded batch, teacher-forced: the
    prefill's logits at each prompt's last position, then decode steps
    fed each request's ``tokens`` (the M = 1 engine's), on ``mesh``'s
    blocks; [len(tokens[i]), V] logits per request on the host (row j
    is the distribution token j was chosen from). A request past its
    tokens decodes a 0 that is never read."""
    lens = [int(p.size) for p in prompts]
    x = torch.zeros((len(prompts), max(lens)), dtype=torch.int64)
    for i, p in enumerate(prompts):
        x[i, :p.size] = torch.from_numpy(p.astype(np.int64))
    lens_t = torch.tensor(lens, device="cuda")
    with L.batch_sharding(mesh):
        logits, cache = model.prefill(params, x.to("cuda"), max_len,
                                      lens_t, logits_at=lens_t - 1)
        rows = [[logits[i, 0]] for i in range(len(prompts))]
        for j in range(max(len(t) for t in tokens) - 1):
            tok = torch.tensor([[t[j] if j < len(t) else 0] for t in tokens],
                               dtype=torch.int32, device="cuda")
            logits, cache = model.decode_step(params, cache, tok,
                                              (lens_t + j).int())
            for i, t in enumerate(tokens):
                if j + 1 < len(t):
                    rows[i].append(logits[i, -1])
    del cache
    return [torch.stack(r).cpu() for r in rows]


@contextlib.contextmanager
def unsummed_wo(L):
    """Inside the block no row-parallel wo partial (attention's or the
    MLP's) is summed over the model row: the fault phase 16's bounds
    must catch."""
    real = L._row_sum

    def faulty(y, local, full, what):
        return y if what.endswith(" wo") else real(y, local, full, what)

    L._row_sum = faulty
    try:
        yield
    finally:
        L._row_sum = real


def decode_split(model, params, mesh, ops, L, slots: int = TP_SLOTS,
                 max_len: int = TP_MAX_LEN) -> dict:
    """Host time of a decode step at the engine's shape (``slots``
    slots) on ``mesh``'s blocks, split into the model row's sums, its
    gathers (by name: the logits', and under the T fallback q's and the
    partials') and the rest (compute dispatch and its wait); the card's
    queue drains before each collective's clock starts."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    tok = torch.randint(1, model.cfg.vocab_size, (slots, 1),
                        generator=gen, device="cuda", dtype=torch.int32)
    pos = torch.tensor([64, 128, 200, 255][:slots], dtype=torch.int32,
                       device="cuda")
    with L.batch_sharding(mesh):
        cache = model.init_cache(params, slots, max_len)
        for i in range(2):
            model.decode_step(params, cache, tok, pos + i)
        torch.cuda.synchronize()
        mesh.collectives.clear()
        ops.reset_launches()
        t0 = time.perf_counter()
        for i in range(TP_SPLIT_STEPS):
            model.decode_step(params, cache, tok, pos + 2 + i)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / TP_SPLIT_STEPS
    coll = {k: dict(v) for k, v in mesh.collectives.items()}
    per = {k: v["seconds"] * 1e3 / TP_SPLIT_STEPS for k, v in coll.items()}
    del cache
    return {"step_ms": total, "sum_ms": per["model_sum"],
            "gather_ms": per["model_gather"],
            "compute_ms": total - sum(per.values()),
            "sums": coll["model_sum"]["calls"] // TP_SPLIT_STEPS,
            "sum_bytes": coll["model_sum"]["bytes"] // TP_SPLIT_STEPS,
            "gathers": coll["model_gather"]["calls"] // TP_SPLIT_STEPS,
            "ms": per, "calls": {k: v["calls"] // TP_SPLIT_STEPS
                                 for k, v in coll.items()},
            "launches": ops.decode_launches() / TP_SPLIT_STEPS}


def bits(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bf16 as its int16 bits (``unbits``
    inverts it)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def unbits(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if t.dtype == torch.int16 else t


def tp_rank(requests, tokens1) -> dict:
    """Phase 16 on one rank of the (1, 2) mesh: this rank's blocks of
    gemma3-12b's seed-0 draw (``Model.init(0, mesh=)``), the engine on
    phase 16's requests, the requests teacher-forced along M = 1's
    tokens, the decode step's split, and the fault."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.obs import Tracer, phase_summary
    mesh = mesh_lib.make_host_mesh(*TP_MESH)
    model = get_model(get_config(TP_ARCH).replace(num_layers=TP_LAYERS))
    t0 = time.perf_counter()
    params = model.init(0, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    shapes = {"wq": tuple(params["layers"][0]["attn"]["wq"].shape),
              "wk": tuple(params["layers"][0]["attn"]["wk"].shape),
              "wi": tuple(params["layers"][0]["mlp"]["wi"].shape),
              "table": tuple(params["embed"]["table"].shape),
              "head": tuple(params["embed"]["head"].shape)}
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=TP_SLOTS, max_len=TP_MAX_LEN, page_size=16),
        device=mesh.device, tracer=tracer, mesh=mesh)
    mesh.collectives.clear()
    results, stats, elapsed, launches = serve(eng, ops, requests)
    engine_coll = {k: dict(v) for k, v in mesh.collectives.items()}
    spans = phase_summary(tracer.events())
    pool = tuple(eng._kv.cache[0]["k"].shape)
    tokens2 = [list(r.tokens) for r in results]
    del eng, results
    tf = teacher_forced(L, model, params, requests[0], tokens1,
                        mesh)
    with unsummed_wo(L):
        fault = teacher_forced(L, model, params, requests[0][:1],
                               tokens1[:1], mesh)
    split = decode_split(model, params, mesh, ops, L)
    peak = torch.cuda.max_memory_allocated()
    first = mesh.rank == 0
    # as numpy bf16 bits: a tensor would cross to the parent as a
    # shared-memory handle that dies with this process
    tf, fault = ([bits(t) for t in x] for x in (tf, fault))
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "device": str(mesh.device), "backend": mesh.backend,
            "init_s": init_s, "init_peak": init_peak, "shapes": shapes,
            "pool": pool, "tokens": tokens2, "stats": stats,
            "elapsed": elapsed, "launches": launches, "spans": spans,
            "collectives": engine_coll, "split": split, "peak": peak,
            "equal": mesh_lib.all_equal(mesh, tokens2),
            "tf": tf if first else None, "fault": fault if first else None}


def tp_small_rank(arch: str, params, prompts) -> dict:
    """16b on one rank of the (2, 2) mesh: the smoke config's CPU-drawn
    weights (QKV biases set to draws), its blocks by ``shard_params`` on
    the card, the engine's tokens and the prompts' prefill logits, then
    the prefill logits again with each QKV bias's rows taken from the
    other model rank (the fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.base import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import convert, get_model
    from repro_torch.models import layers as L
    mesh = mesh_lib.make_host_mesh(*TP_SMALL_MESH)
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    local = convert.shard_params(
        cfg, tree_map(lambda t: t.to(mesh.device), params), mesh)
    eng = serving.Engine(model, local,
                         serving.ServeConfig(**TP_SMALL_SERVE),
                         device=mesh.device, mesh=mesh)
    ops.reset_launches()
    ids = [eng.submit(p, max_new_tokens=n) for p, n in prompts]
    got = {r.id: r.tokens for r in eng.drain()}
    decode_steps = eng.stats()["decode_steps"]
    launches = ops.launches["attention_decode"]
    last = [serving.prefill(model, local, torch.tensor(
        p[None], dtype=torch.int64, device=mesh.device), TP_SMALL_SERVE[
            "max_len"], mesh=mesh)[0][0, -1].cpu() for p, _ in prompts]
    real = L._head_rows

    def other_rows(b, heads, partial=False):
        if b.shape[0] == heads:
            return b
        j = (mesh.coords["model"] + 1) % mesh.shape["model"]
        return b[j * heads:(j + 1) * heads]

    fault = None
    if cfg.qkv_bias:
        L._head_rows = other_rows
        try:
            fault = [serving.prefill(model, local, torch.tensor(
                p[None], dtype=torch.int64, device=mesh.device),
                TP_SMALL_SERVE["max_len"], mesh=mesh)[0][0, -1].cpu()
                for p, _ in prompts]
        finally:
            L._head_rows = real
    tokens = [got[i] for i in ids]
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "tokens": tokens, "last": torch.stack(last).numpy(),
            "fault": None if fault is None else torch.stack(fault).numpy(),
            "launches": launches, "decode_steps": decode_steps,
            "equal": mesh_lib.all_equal(mesh, tokens)}


def phase_model_axis(ops, serving, tad, mesh_lib, get_config,
                     get_smoke_config, get_model, Tracer, phase_summary,
                     tree_leaves) -> dict:
    """16-16b: tensor-parallel serving (see the module docstring)."""
    from repro_torch.models import layers as L
    cfg = get_config(TP_ARCH).replace(num_layers=TP_LAYERS)
    print(f"16 {TP_ARCH}: reduced: num_layers "
          f"{get_config(TP_ARCH).num_layers} -> {TP_LAYERS} (the script's "
          f"time budget: phases 17-17d came in; width as published)",
          flush=True)
    m = TP_MESH[1]
    weights = weight_bytes(cfg)
    pool = kv_pool_bytes(cfg, TP_SLOTS, TP_MAX_LEN)
    # a rank: its half of the weights, its half of the pool, the
    # admission's prefill dump (as large as the pool at 4 of 4 slots)
    pred = (weights / m + 2 * pool / m) / GIB + TP_CONTEXT_GIB
    print(f"16 {TP_ARCH}: full width ({cfg.num_layers} layers, "
          f"bf16) on a {TP_MESH} mesh, {m} gloo ranks on one card: "
          f"{cfg.num_heads // m} of {cfg.num_heads} heads, "
          f"{cfg.num_kv_heads // m} of {cfg.num_kv_heads} KV heads, "
          f"{cfg.d_ff // m} of {cfg.d_ff} d_ff, {cfg.vocab_size // m} of "
          f"{cfg.vocab_size} words a rank; predicted peak a rank "
          f"{pred:.2f} GiB (weights {weights / GIB:.2f} / {m} + pool "
          f"{pool / GIB:.3f} / {m} + prefill dump {pool / GIB:.3f} / {m} "
          f"+ {TP_CONTEXT_GIB} context)", flush=True)
    # the decode kernel at a rank's shape, against its plain version
    gen = torch.Generator(device="cuda").manual_seed(16)
    row = kernel_row(tad, ops, gen, "global", TP_MAX_LEN, None,
                     torch.bfloat16, TP_SLOTS, cfg.num_heads // m,
                     cfg.num_kv_heads // m, cfg.head_dim_,
                     [64, 128, 200, 287])

    # M = 1 in this process on the same seed-0 weights, freed after
    model = get_model(cfg)
    requests = tp_requests(cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    results, stats1, elapsed1, _ = serve(engine(
        serving, model, params, None, TP_SLOTS, TP_MAX_LEN), ops, requests)
    tokens1 = [list(r.tokens) for r in results]
    tf1 = teacher_forced(L, model, params, requests[0], tokens1)
    fault1 = teacher_forced(L, model, params, requests[0][:1],
                            tokens1[:1])
    del params, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"16 M=1: {len(tokens1)} requests (prompts "
          f"{[len(p) for p in requests[0]]}, new "
          f"{[int(n) for n in requests[1]]}), "
          f"{stats1['tokens_generated']} tokens in {elapsed1:.3f} s; "
          f"teacher-forced logits kept", flush=True)

    t0 = time.perf_counter()
    ranks = on_ranks(tp_rank, m, args=(requests, tokens1), timeout=600)
    spawn_s = time.perf_counter() - t0
    tol = tad.decode_parity_tolerance(torch.bfloat16)
    for r in ranks:
        if not r["equal"] or r["tokens"] != ranks[0]["tokens"]:
            raise AssertionError("16: the ranks served different tokens")
        want = cfg.num_layers * r["stats"]["decode_steps"]
        if r["launches"] != want or r["split"]["launches"] != \
                cfg.num_layers:
            raise AssertionError(f"16 rank {r['rank']}: {r['launches']} "
                                 f"decode launches for "
                                 f"{r['stats']['decode_steps']} steps "
                                 f"(expected {want}); split "
                                 f"{r['split']['launches']} a step")
        if r["pool"][2] != cfg.num_kv_heads // m:
            raise AssertionError(f"16: pool {r['pool']}")
        if abs(r["peak"] / GIB - pred) > TP_PEAK_MARGIN_GIB:
            raise AssertionError(f"16 rank {r['rank']}: peak "
                                 f"{r['peak'] / GIB:.2f} GiB, predicted "
                                 f"{pred:.2f} +- {TP_PEAK_MARGIN_GIB}")
    # logits to M = 1, along M = 1's tokens: (max, mean) |gap| per
    # request, and the fault's on request 0
    def gap(a, b):
        d = (a.float() - b.float()).abs()
        return d.max().item(), d.mean().item()

    tf2 = [unbits(a) for a in ranks[0]["tf"]]
    gaps = [gap(a, b) for a, b in zip(tf2, tf1)]
    fault_gap = gap(unbits(ranks[0]["fault"][0]), fault1[0])
    worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    if not (worst[0] <= TP_LOGIT_BOUND and worst[1] <= TP_LOGIT_MEAN_BOUND):
        raise AssertionError(f"16: logit gaps to M=1 (max, mean) {gaps}, "
                             f"bounds {TP_LOGIT_BOUND}, "
                             f"{TP_LOGIT_MEAN_BOUND}")
    if not (fault_gap[0] > TP_LOGIT_BOUND
            and fault_gap[1] > TP_LOGIT_MEAN_BOUND):
        raise AssertionError(f"16: the unsummed-wo fault's gaps "
                             f"{fault_gap} do not exceed the bounds")
    # tokens: equal to M = 1 up to each request's first difference,
    # which must be a near-tie in both M = 1's and M = 2's logits
    ties = []
    for i, (a, b) in enumerate(zip(tokens1, ranks[0]["tokens"])):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        g1, lim1 = logit_gaps(tf1[i][j], torch.tensor(b[j]), tol)
        g2, lim2 = logit_gaps(tf2[i][j], torch.tensor(a[j]), tol)
        ties.append((i, j, round(g1.item(), 4), round(g2.item(), 4)))
        if g1 > lim1 or g2 > lim2:
            raise AssertionError(f"16 request {i}: token {j} differs from "
                                 f"M=1 ({a[j]} vs {b[j]}) beyond a bf16 "
                                 f"tie: gaps {g1.item()} / {g2.item()}, "
                                 f"allowed {lim1.item()} / {lim2.item()}")
    r0 = ranks[0]
    sp = r0["split"]
    spans = r0["spans"]
    step_ms = decode_step_ms(spans, r0["stats"]["decode_steps"])
    generated = r0["stats"]["tokens_generated"]
    coll = {k: (v["calls"], round(v["seconds"], 3))
            for k, v in r0["collectives"].items()}
    for r in ranks:
        print(f"16 rank {r['rank']} {r['coords']} ({r['backend']}, "
              f"{r['device']}): blocks {r['shapes']}, KV pool {r['pool']}; "
              f"init {r['init_s']:.1f} s (peak {r['init_peak'] / GIB:.2f} "
              f"GiB: the blocks and the largest leaf drawn whole); serving "
              f"peak {r['peak'] / GIB:.2f} GiB (predicted {pred:.2f}); "
              f"{r['launches']} decode launches over "
              f"{r['stats']['decode_steps']} steps "
              f"({r['launches'] // r['stats']['decode_steps']} a step)",
              flush=True)
    print(f"16: {len(r0['tokens'])} requests, {generated} tokens in "
          f"{r0['elapsed']:.3f} s = {generated / r0['elapsed']:.2f} tok/s "
          f"(M=1 {stats1['tokens_generated'] / elapsed1:.2f}); decode step "
          f"{step_ms:.3f} ms (decode + sample spans); engine collectives "
          f"{coll} (calls, s); tokens equal on {m} ranks; to M=1: "
          f"{sum(a == b for a, b in zip(tokens1, r0['tokens']))} of "
          f"{len(tokens1)} requests equal, first differences (request, "
          f"token, gap in M=1's logits, in M=2's) {ties}; |logit gap| "
          f"along M=1's tokens (max, mean) a request "
          f"{[(round(a, 4), round(b, 5)) for a, b in gaps]} (bounds "
          f"{TP_LOGIT_BOUND}, {TP_LOGIT_MEAN_BOUND}); every wo unsummed "
          f"(the fault) ({fault_gap[0]:.4f}, {fault_gap[1]:.5f}); "
          f"{spawn_s:.1f} s on the shared ranks (started on first use); "
          f"{smi_line()}", flush=True)
    print(f"16 decode step split (rank 0, {TP_SLOTS} slots, "
          f"{TP_SPLIT_STEPS} steps, host clock): {sp['step_ms']:.3f} ms = "
          f"compute {sp['compute_ms']:.3f} + model_sum_ {sp['sum_ms']:.3f} "
          f"({sp['sums']} calls, {sp['sum_bytes']} B) + logits gather "
          f"{sp['gather_ms']:.3f} ({sp['gathers']} call); "
          f"{sp['launches']:.0f} decode launches a step", flush=True)

    # 16b: the smoke configs on a (2, 2) mesh against the CPU
    small = {}
    for arch in TP_SMALL:
        scfg = get_smoke_config(arch)
        smodel = get_model(scfg)
        cpu = smodel.init(0, device="cpu")
        g = torch.Generator().manual_seed(7)
        for layer in cpu["layers"]:
            for k in ("bq", "bk", "bv"):
                if k in layer["attn"]:
                    layer["attn"][k] = 0.05 * torch.randn(
                        layer["attn"][k].shape, generator=g)
        prompts = [(np.random.RandomState(s).randint(1, scfg.vocab_size,
                                                     size=n), new)
                   for s, n, new in TP_SMALL_PROMPTS]
        eng = serving.Engine(smodel, cpu,
                             serving.ServeConfig(**TP_SMALL_SERVE),
                             device="cpu")
        ids = [eng.submit(p, max_new_tokens=n) for p, n in prompts]
        got = {r.id: r.tokens for r in eng.drain()}
        want = [got[i] for i in ids]
        last = torch.stack([serving.prefill(smodel, cpu, torch.tensor(
            p[None], dtype=torch.int64), TP_SMALL_SERVE["max_len"])[0][0, -1]
            for p, _ in prompts])
        rs = on_ranks(tp_small_rank, 4, args=(arch, cpu, prompts),
                      timeout=300)
        for r in rs:
            if not r["equal"] or r["tokens"] != want:
                raise AssertionError(f"16b {arch} rank {r['rank']}: tokens "
                                     f"differ from the CPU's M=1")
            if r["launches"] != scfg.num_layers * r["decode_steps"]:
                raise AssertionError(f"16b {arch}: {r['launches']} launches")
        gap = (torch.from_numpy(rs[0]["last"]) - last).abs().max().item()
        fault = None if rs[0]["fault"] is None else \
            (torch.from_numpy(rs[0]["fault"]) - last).abs().max().item()
        if not gap <= TP_SMALL_LOGIT_BOUND or (
                fault is not None and not fault > TP_SMALL_LOGIT_BOUND):
            raise AssertionError(f"16b {arch}: prefill logit gap {gap}, "
                                 f"the other rank's bias rows {fault}, "
                                 f"bound {TP_SMALL_LOGIT_BOUND}")
        small[arch] = {"launches": rs[0]["launches"], "gap": gap,
                       "fault": fault}
        print(f"16b {arch}: smoke f32 on a {TP_SMALL_MESH} mesh (4 gloo "
              f"ranks, one card) == M=1 on the CPU: {len(want)} requests' "
              f"tokens equal on every rank, {rs[0]['launches']} decode "
              f"launches ({scfg.num_layers} a step); prefill logits within "
              f"{gap:.3e} (bound {TP_SMALL_LOGIT_BOUND})"
              + ("" if fault is None else
                 f"; each QKV bias with the other rank's rows: {fault:.3e}")
              + f"; {smi_line()}", flush=True)
    return {"row": row, "launches": r0["launches"], "gaps": gaps,
            "fault_gap": fault_gap, "split": sp, "peak_gib": [
                r["peak"] / GIB for r in ranks], "predicted_gib": pred,
            "small": small}


# -------------------------------- 17-17d: the rest of the model axis
TF_ARCH = "qwen2.5-3b"
TF_LAYERS = 2                  # of 36: the script's time budget
TF_MESH = (1, 4)               # 4 of 16 heads a rank; 2 KV heads: over T
TF_DATA_MESH = (2, 2)          # 2 of 4 slots a data row; 8 / 1 heads
TF_SLOTS, TF_MAX_LEN = 4, 288  # 72 keys of T a rank at M = 4
TF_NEW = (8, 16)               # new tokens a request (prompts 64-256)
TF_FAULT_TOKENS = 4            # the unweighted merge's teacher-forced run
TF_CONTEXT_GIB = 0.5           # activations, logits, the CUDA allocator
TF_PEAK_MARGIN_GIB = 1.0       # |peak - prediction| allowed per rank
# the largest and the mean |logit gap| to M = 1 along M = 1's tokens:
# each rank's partial output rounds to bf16 before the f32 merge, and
# the wo / MLP partials before their f32 sum, as in phase 16 (bounds
# 0.5 / 0.08; read 0.114 / 0.017 there at gemma3-12b M = 2)
TF_LOGIT_BOUND = 0.5
TF_LOGIT_MEAN_BOUND = 0.08
# the merge's own check: layer 0's attention decode (wo summed) on
# seeded bf16 caches of unit scale, at 17a's positions, max |diff| to
# M = 1 over max |M = 1|. At the random init q and k are small, so the
# model's own attention is near uniform and a block averaged without
# its lse weight barely moves the logits (on the H100 the unweighted
# merge's logit gaps read 0.19-0.20 / 0.024-0.026, under the bounds
# above); unit-scale caches make the scores peaked. Each partial rounds
# to bf16 once more than at M = 1 (2^-8 relative); the two faults, the
# blocks averaged without their lse weights and rank 1's partial left
# out, must exceed the bound
TF_ATTN_REL_BOUND = 0.05
TF_ATTN_POS = [64, 128, 200, 287]
TF_SPLIT = 4                   # blocks of T in phase 17
# 17: (kind, T, window, slots, heads, KV heads, Dh, positions): 17a's
# rank shape, then a ring at Dh 256 whose window is split four ways.
# The ring is synthetic: no registered config splits a ring's T at
# M <= 4 (gemma3-12b's 8 KV heads divide 4)
TF_KERNEL = [("global", TF_MAX_LEN, None, TF_SLOTS, 16, 2, 128,
              [0, 5, 71, 72, 73, 143, 287, 3, 64, 128, 200, 255]),
             ("local", 1024, 1024, 4, 8, 2, 256,
              [0, 255, 256, 1023, 1024, 2500, 4100, 6143])]
# 17c: the families at (1, 2), full width; generate's prompts, prompt
# length and new tokens, the engine's slots and cache, depth cuts
FAM_TP_ARCHS = ("llama-3.2-vision-11b", "whisper-large-v3", "mamba2-1.3b",
                "zamba2-1.2b")
FAM_TP_MESH = (1, 2)
FAM_TP_GEN = (2, 16, 8)
FAM_TP_SLOTS, FAM_TP_MAX_LEN = 4, 64
# arch -> num_layers: each cut to about half its depth, then to about a
# quarter (two vlm groups) when phases 18-18c came in, then to about an
# eighth (one vlm group, one zamba2 group) when phases 20-20c did, and
# whisper to 2 when phases 21-21c did (the script's time budget;
# whisper's 32 encoder layers stay)
FAM_TP_LAYERS = {"llama-3.2-vision-11b": 5, "whisper-large-v3": 2,
                 "mamba2-1.3b": 6, "zamba2-1.2b": 6}
# 17d: every family's smoke config at (1, 4) and (2, 2), f32, card
# against the CPU
TF_SMALL = ("qwen2.5-3b", "gemma3-12b", "llama-3.2-vision-11b",
            "whisper-large-v3", "mamba2-1.3b", "zamba2-1.2b")
TF_SMALL_GEN = (4, 8, 6)


def tf_config(get_config):
    """17a / 17b's config: ``TF_ARCH`` cut to ``TF_LAYERS`` layers, its
    widths as published."""
    return get_config(TF_ARCH).replace(num_layers=TF_LAYERS)


def partial_row(tad, ops, gen, kind, t, window, slots, heads, kv_heads,
                dh, positions, m: int = TF_SPLIT,
                dtype=torch.bfloat16) -> dict:
    """The decode kernel's partial mode against its plain version: the
    cache cut into ``m`` blocks of T, each launched with its offset on
    the positions (``slots`` at a time): out within the parity bound,
    lse within 1e-5 (f32 either way) and -inf on the same rows, caches
    bitwise equal, a block with no needed key out 0 / lse -inf and no
    NaN; the blocks merged (``merge_partials``) within the bound of the
    unsplit launch. Then each block's launch timed on the card beside
    the plain version, SDPA over the same block (output only) and its
    bound. Returns the shape's row."""
    dev = torch.device("cuda")
    tol = tad.decode_parity_tolerance(dtype)
    n = t // m
    plan = tad.decode_plan(n, dh, dtype, heads // kv_heads)
    dname = str(dtype).split(".")[-1]
    print(f"17 kernel partial mode {kind} T={t} in {m} blocks of {n}, "
          f"{dname}, {slots} slots x {heads} / {kv_heads} heads x {dh}: "
          f"plan L={plan.keys} x {plan.splits} splits, grid "
          f"{plan.grid(slots, kv_heads)}", flush=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q = randn(slots, 1, heads, dh)
    nk, nv = randn(slots, 1, kv_heads, dh), randn(slots, 1, kv_heads, dh)
    kc, vc = randn(slots, t, kv_heads, dh), randn(slots, t, kv_heads, dh)
    err = merged_err = 0.0
    empty = 0
    for i in range(0, len(positions), slots):
        rows_pos = positions[i:i + slots]
        pos = torch.tensor(rows_pos, dtype=torch.int32, device=dev)
        whole = ops.attention_decode(q, nk, nv, kc.clone(), vc.clone(), pos,
                                     window=window)
        outs, lses, blocks = [], [], []
        for r in range(m):
            part = slice(r * n, (r + 1) * n)
            kb, vb = kc[:, part].clone(), vc[:, part].clone()
            kp, vp = kb.clone(), vb.clone()
            kw = dict(window=window, t0=r * n, t_total=t, return_lse=True)
            o, lse = ops.attention_decode(q, nk, nv, kb, vb, pos, **kw)
            op, lp = tad.attention_decode_ref(q, nk, nv, kp, vp, pos, **kw)
            torch.cuda.synchronize()
            label = f"17 {kind} block {r} positions {rows_pos}"
            torch.testing.assert_close(o.float(), op.float(), **tol)
            if not torch.equal(torch.isneginf(lse), torch.isneginf(lp)):
                raise AssertionError(f"{label}: lse -inf rows differ")
            fin = torch.isfinite(lp)
            torch.testing.assert_close(lse[fin], lp[fin], rtol=1e-5,
                                       atol=1e-5)
            if torch.isnan(o.float()).any() or torch.isnan(lse).any():
                raise AssertionError(f"{label}: NaN")
            gone = torch.isneginf(lse).all(dim=-1)
            if o[gone].abs().max().item() if gone.any() else 0.0:
                raise AssertionError(f"{label}: an empty row's out is "
                                     f"not 0")
            empty += int(gone.sum())
            if not (torch.equal(kb, kp) and torch.equal(vb, vp)):
                raise AssertionError(f"{label}: appended blocks differ "
                                     f"from plain")
            err = max(err, (o.float() - op.float()).abs().max().item())
            outs.append(o)
            lses.append(lse)
            blocks.append((kb, vb))
        merged = tad.merge_partials(outs, lses)
        torch.testing.assert_close(merged.float(), whole.float(), **tol)
        merged_err = max(merged_err,
                         (merged.float() - whole.float()).abs().max().item())
    if empty == 0:
        raise AssertionError(f"17 {kind}: no row with an empty block")
    # timing at the last launch's positions, every block
    csize = kc.element_size()
    posl = pos.long()[:, None]
    ms, plain, lib, bounds, bytes_ms_all, ops_ms_all = [], [], [], [], [], []
    for r, (kb, vb) in enumerate(blocks):
        kw = dict(window=window, t0=r * n, t_total=t, return_lse=True)
        kpos = r * n + torch.arange(n, device=dev)[None, :]
        if window is None:
            ok = kpos <= posl
        else:
            slot = posl % t
            wraps = (posl // t) * t
            a = kpos + torch.where(kpos <= slot, wraps, wraps - t)
            ok = (a >= 0) & (a <= posl) & (a > posl - window)
        valid = int(ok.sum().item())
        bytes_moved = (2 * valid * kv_heads * dh * csize
                       + 2 * q.numel() * q.element_size()
                       + 4 * slots * heads
                       + 4 * nk.numel() * csize + 4 * slots)
        b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        o_ms = 4 * valid * heads * dh / F32_FLOP_PER_S * 1e3
        bytes_ms_all.append(b_ms)
        ops_ms_all.append(o_ms)
        bounds.append(max(b_ms, o_ms))
        ms.append(device_ms(lambda: ops.attention_decode(
            q, nk, nv, kb, vb, pos, **kw)))
        plain.append(time_ms(lambda: tad.attention_decode_ref(
            q, nk, nv, kb, vb, pos, **kw), 10))
        qs, ks, vs = q.transpose(1, 2), kb.transpose(1, 2), \
            vb.transpose(1, 2)
        mask = ok[:, None, None, :]
        lib.append(device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)))
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    row = {"shape": f"{kind} T={t} over {m} blocks of {n} {dname} "
                    f"B={slots} H={heads} Hkv={kv_heads} Dh={dh} (partial)",
           "ms": mean(ms), "ms_blocks": ms, "plain_ms": mean(plain),
           "library_ms": mean(lib), "library_blocks": lib,
           "bound_ms": mean(bounds), "bytes_ms": mean(bytes_ms_all),
           "ops_ms": mean(ops_ms_all),
           "bound_by": "bytes" if mean(bytes_ms_all) >= mean(ops_ms_all)
           else "operations",
           "max_abs_err": max(err, merged_err), "merged_err": merged_err,
           "empty_rows": empty, "keys": plan.keys, "splits": plan.splits,
           "grid": list(plan.grid(slots, kv_heads))}
    print(f"  positions {positions}: each block within rtol=atol="
          f"{tol['rtol']:.2e} of plain (max|err| {err:.3e}), lse within "
          f"1e-5, {empty} (row, block) pairs with no needed key gave out 0 "
          f"and lse -inf, appended blocks bitwise equal; the {m} blocks "
          f"merged within {merged_err:.3e} of the unsplit launch. Card "
          f"ms per block (CUDA graph) {[round(x, 4) for x in ms]}, SDPA "
          f"over the same block {[round(x, 4) for x in lib]}, plain "
          f"(eager) {mean(plain):.4f}; bound {[round(x, 5) for x in bounds]}"
          f" ({row['bound_by']}): {row['bound_ms'] / row['ms']:.1%} of it "
          f"on average", flush=True)
    return row


@contextlib.contextmanager
def faulty_merge(L, fault: str):
    """Inside the block the model row's partials are merged wrongly:
    ``"unweighted"`` averages the outputs without their lse weights,
    ``"drop"`` leaves rank 1's partial out. The faults phase 17a's
    attention check must catch."""
    real = L.merge_partials

    def unweighted(outs, lses):
        return (sum(o.float() for o in outs) / len(outs)).to(outs[0].dtype)

    def drop(outs, lses):
        return real(outs[:1] + outs[2:], lses[:1] + lses[2:])

    L.merge_partials = unweighted if fault == "unweighted" else drop
    try:
        yield
    finally:
        L.merge_partials = real


def attn_probe_inputs(cfg) -> tuple:
    """17a's attention check: a seeded [B,1,D] input and unit-scale
    [B,T,Hkv,Dh] bf16 caches on the card, at ``TF_ATTN_POS``."""
    gen = torch.Generator(device="cuda").manual_seed(171)
    b = len(TF_ATTN_POS)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    shape = (b, TF_MAX_LEN, cfg.num_kv_heads, cfg.head_dim_)
    return (randn(b, 1, cfg.d_model), randn(*shape), randn(*shape),
            torch.tensor(TF_ATTN_POS, dtype=torch.int32, device="cuda"))


def attn_probe(L, cfg, attn, inputs, mesh=None) -> torch.Tensor:
    """Layer 0's attention decode on ``inputs`` (the caches copied; on
    ``mesh`` this rank's block of T), on the host."""
    x, kc, vc, pos = inputs
    if mesh is not None:
        m, r = mesh.shape["model"], mesh.coords["model"]
        n = kc.shape[1] // m
        kc, vc = kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n]
    with L.batch_sharding(mesh):
        out = L.attention_decode(attn, cfg, x, kc.clone(), vc.clone(), pos)
    return out.float().cpu()


def small_cases(get_smoke_config, get_model, serving, extra_embed_shape):
    """17d's cases: every family's smoke config, its seed-0 draw on the
    CPU (vlm gates opened), its inputs and its tokens at M = 1 on the
    CPU (the engine for dense and vlm, ``generate`` for the rest)."""
    cases = []
    for arch in TF_SMALL:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        params = model.init(0, device="cpu")
        for layer in params.get("layers", ()):
            if "gate" in layer:
                layer["gate"].fill_(GATE_OPEN)
        if model.prefill is not None:
            es = extra_embed_shape(cfg, TP_SMALL_SERVE["slots"])
            extra = None if es is None else torch.randn(
                es, generator=torch.Generator().manual_seed(17))
            prompts = [(np.random.RandomState(s).randint(
                1, cfg.vocab_size, size=n), new)
                for s, n, new in TP_SMALL_PROMPTS]
            eng = serving.Engine(model, params,
                                 serving.ServeConfig(**TP_SMALL_SERVE),
                                 device="cpu", extra=extra)
            ids = [eng.submit(p, max_new_tokens=k) for p, k in prompts]
            got = {r.id: r.tokens for r in eng.drain()}
            want = [got[i] for i in ids]
            inputs = (prompts, extra)
        else:
            b, s, new = TF_SMALL_GEN
            es = extra_embed_shape(cfg, b)
            extra = None if es is None else torch.randn(
                es, generator=torch.Generator().manual_seed(17))
            prompts = np.random.RandomState(17).randint(1, cfg.vocab_size,
                                                        size=(b, s))
            want = serving.generate(model, params, prompts, num_tokens=new,
                                    extra_embeds=extra,
                                    device="cpu").tolist()
            inputs = (prompts, extra)
        cases.append((arch, params, inputs, want))
    return cases


def small_on_mesh(mesh, cases) -> dict:
    """17d on this rank: each case's CPU weights placed by
    ``shard_params`` on the card and served on ``mesh``; its tokens and
    decode launches."""
    from repro_torch import serving
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.base import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import convert, get_model
    out = {}
    for arch, params, (prompts, extra), _ in cases:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        local = convert.shard_params(
            cfg, tree_map(lambda t: t.to(mesh.device), params), mesh)
        extra = None if extra is None else extra.to(mesh.device)
        ops.reset_launches()
        if model.prefill is not None:
            eng = serving.Engine(model, local,
                                 serving.ServeConfig(**TP_SMALL_SERVE),
                                 device=mesh.device, mesh=mesh, extra=extra)
            ids = [eng.submit(p, max_new_tokens=k) for p, k in prompts]
            got = {r.id: r.tokens for r in eng.drain()}
            tokens = [got[i] for i in ids]
            steps = eng.stats()["decode_steps"]
        else:
            tokens = serving.generate(
                model, local, prompts, num_tokens=TF_SMALL_GEN[2],
                extra_embeds=extra, device=mesh.device,
                mesh=mesh).cpu().tolist()
            steps = TF_SMALL_GEN[1] + TF_SMALL_GEN[2]
        out[arch] = {"tokens": tokens, "steps": steps,
                     "launches": ops.launches["attention_decode"]}
    return out


def tf_rank(requests, tokens1, cases, probe) -> dict:
    """17a on one rank of the (1, 4) mesh: this rank's blocks of
    qwen2.5-3b's seed-0 draw (4 of 16 heads, every KV head: the KV cache
    over T), the engine on the requests, the requests teacher-forced
    along M = 1's tokens, the faults, the decode step's split; then
    17d's cases on the same mesh, and 17b in the same world
    (:func:`tf_data_rank`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.obs import Tracer, phase_summary
    mesh = mesh_lib.make_host_mesh(*TF_MESH)
    model = get_model(tf_config(get_config))
    t0 = time.perf_counter()
    params = model.init(0, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    attn0 = params["layers"][0]["attn"]
    shapes = {k: tuple(attn0[k].shape) for k in ("wq", "wk", "wo")}
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=TF_SLOTS, max_len=TF_MAX_LEN, page_size=16),
        device=mesh.device, tracer=tracer, mesh=mesh)
    mesh.collectives.clear()
    results, stats, elapsed, launches = serve(eng, ops, requests)
    engine_coll = {k: dict(v) for k, v in mesh.collectives.items()}
    spans = phase_summary(tracer.events())
    pool = tuple(eng._kv.cache[0]["k"].shape)
    tokens2 = [list(r.tokens) for r in results]
    del eng, results
    tf = teacher_forced(L, model, params, requests[0], tokens1, mesh,
                        TF_MAX_LEN)
    with faulty_merge(L, "unweighted"):
        fault = teacher_forced(L, model, params, requests[0][:1],
                               [tokens1[0][:TF_FAULT_TOKENS]], mesh,
                               TF_MAX_LEN)
    inputs = tuple(unbits(a).to(mesh.device) for a in probe)
    attn = {"merged": attn_probe(L, model.cfg, attn0, inputs, mesh)}
    for kind in ("unweighted", "drop"):
        with faulty_merge(L, kind):
            attn[kind] = attn_probe(L, model.cfg, attn0, inputs, mesh)
    split = decode_split(model, params, mesh, ops, L, TF_SLOTS, TF_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small = small_on_mesh(mesh, cases)
    first = mesh.rank == 0
    tf, fault = ([bits(t) for t in x] for x in (tf, fault))
    equal = mesh_lib.all_equal(mesh, tokens2)
    torch.cuda.reset_peak_memory_stats()
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "data": tf_data_rank(requests, cases),
            "init_s": init_s, "init_peak": init_peak, "shapes": shapes,
            "attn": {k: v.numpy() for k, v in attn.items()},
            "pool": pool, "tokens": tokens2, "stats": stats,
            "elapsed": elapsed, "launches": launches, "spans": spans,
            "collectives": engine_coll, "split": split, "peak": peak,
            "equal": equal, "small": small,
            "tf": tf if first else None, "fault": fault if first else None}


def tf_data_rank(requests, cases) -> dict:
    """17b on this rank of a (2, 2) mesh over the same world as 17a's:
    qwen2.5-3b's blocks (8 of 16 heads, 1 of 2 KV heads), the engine
    holding this data row's 2 of 4 slots; then 17d's cases on the same
    mesh."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    mesh = mesh_lib.make_host_mesh(*TF_DATA_MESH)
    model = get_model(tf_config(get_config))
    params = model.init(0, device=mesh.device, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=TF_SLOTS, max_len=TF_MAX_LEN, page_size=16),
        device=mesh.device, mesh=mesh)
    mesh.collectives.clear()
    results, stats, elapsed, launches = serve(eng, ops, requests)
    coll = {k: v["calls"] for k, v in mesh.collectives.items()}
    pool = tuple(eng._kv.cache[0]["k"].shape)
    tokens = [list(r.tokens) for r in results]
    del eng, results
    split = decode_split(model, params, mesh, ops, L, TF_SLOTS // 2,
                         TF_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small = small_on_mesh(mesh, cases)
    return {"rank": mesh.rank, "coords": dict(mesh.coords), "pool": pool,
            "tokens": tokens, "stats": stats, "elapsed": elapsed,
            "launches": launches, "collectives": coll, "split": split,
            "peak": peak, "small": small,
            "equal": mesh_lib.all_equal(mesh, tokens)}


def local_weight_bytes(cfg, mesh_shape: tuple) -> int:
    """A rank's weight bytes on a (data, model) mesh: its blocks of the
    reference layout's leaves under ``state_pspecs``."""
    from repro_torch.core.base import tree_flatten_with_path
    from repro_torch.launch import sharding
    from repro_torch.models import jax_template

    class Shape:
        shape = {"data": mesh_shape[0], "model": mesh_shape[1]}
        coords = {"data": 0, "model": 0}

    total = 0
    for path, leaf in tree_flatten_with_path(jax_template(cfg)):
        spec = sharding.leaf_pspec(path, leaf, Shape)
        block = leaf[sharding.local_block(spec, Shape, leaf.shape)]
        total += block.numel() * leaf.element_size()
    return total


def check_small(label: str, ranks_out: list, cases) -> dict:
    """17d: every rank's tokens of every case equal the CPU's M = 1
    tokens; decode launches = self-attention layers x decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.models.hybrid import hybrid_layout
    out = {}
    for arch, _, _, want in cases:
        cfg = get_smoke_config(arch)
        if cfg.family == "ssm":
            per = 0
        elif cfg.family == "hybrid":
            per = hybrid_layout(cfg)[0]
        elif cfg.family == "encdec":
            per = cfg.num_layers
        else:
            per = sum(k != "cross" for k in layer_kinds(cfg))
        for r in ranks_out:
            got = r["small"][arch]
            if got["tokens"] != want:
                raise AssertionError(f"{label} {arch} rank {r['rank']}: "
                                     f"tokens differ from the CPU's M=1")
            if got["launches"] != per * got["steps"]:
                raise AssertionError(f"{label} {arch}: {got['launches']} "
                                     f"decode launches for {got['steps']} "
                                     f"steps ({per} a step expected)")
        out[arch] = ranks_out[0]["small"][arch]["launches"]
    print(f"{label}: the smoke configs {list(TF_SMALL)} in f32 on every "
          f"rank == M=1 on the CPU (engine for dense / vlm, generate for "
          f"the rest), decode launches {out}; {smi_line()}", flush=True)
    return out


def phase_t_fallback(ops, serving, tad, mesh_lib, get_config,
                     get_smoke_config, get_model, Tracer, phase_summary
                     ) -> dict:
    """17, 17a, 17b and 17d: see the module docstring."""
    from repro_torch.models import extra_embed_shape
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = [partial_row(tad, ops, gen, *shape) for shape in TF_KERNEL]

    cfg = tf_config(get_config)
    m = TF_MESH[1]
    weights = local_weight_bytes(cfg, TF_MESH)
    requests = requests_of(cfg.vocab_size, 16, 4, (64, 256), TF_NEW)
    pool = kv_pool_bytes(cfg, TF_SLOTS, TF_MAX_LEN)
    pred = (weights + 2 * pool / m) / GIB + TF_CONTEXT_GIB
    print(f"17a {TF_ARCH}: reduced: num_layers "
          f"{get_config(TF_ARCH).num_layers} -> {cfg.num_layers} (the "
          f"script's time budget: phases 18-18c came in; width as "
          f"published)", flush=True)
    print(f"17a {TF_ARCH}: full width ({cfg.num_layers} layers, "
          f"bf16) on a {TF_MESH} mesh, {m} gloo ranks on one card: "
          f"{cfg.num_heads // m} of {cfg.num_heads} heads and all "
          f"{cfg.num_kv_heads} KV heads a rank, the KV cache over T "
          f"({TF_MAX_LEN // m} of {TF_MAX_LEN} keys); predicted peak a rank "
          f"{pred:.2f} GiB (weights {weights / GIB:.3f} + pool "
          f"{pool / GIB:.3f} / {m} + prefill dump {pool / GIB:.3f} / {m} + "
          f"{TF_CONTEXT_GIB} context)", flush=True)
    cases = small_cases(get_smoke_config, get_model, serving,
                        extra_embed_shape)

    # M = 1 in this process on the same seed-0 weights, freed after
    model = get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    results, stats1, elapsed1, _ = serve(engine(
        serving, model, params, None, TF_SLOTS, TF_MAX_LEN), ops, requests)
    tokens1 = [list(r.tokens) for r in results]
    tf1 = teacher_forced(L, model, params, requests[0], tokens1,
                         max_len=TF_MAX_LEN)
    fault1 = teacher_forced(L, model, params, requests[0][:1],
                            [tokens1[0][:TF_FAULT_TOKENS]],
                            max_len=TF_MAX_LEN)
    probe = attn_probe_inputs(cfg)
    attn1 = attn_probe(L, cfg, params["layers"][0]["attn"], probe)
    probe = [bits(t.cpu()) for t in probe]
    del params, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"17a M=1: {len(tokens1)} requests (prompts "
          f"{[len(p) for p in requests[0]]}, new "
          f"{[int(n) for n in requests[1]]}), "
          f"{stats1['tokens_generated']} tokens in {elapsed1:.3f} s",
          flush=True)

    t0 = time.perf_counter()
    ranks = on_ranks(tf_rank, m, args=(requests, tokens1, cases, probe),
                     timeout=600)
    spawn_s = time.perf_counter() - t0
    tol = tad.decode_parity_tolerance(torch.bfloat16)
    for r in ranks:
        if not r["equal"] or r["tokens"] != ranks[0]["tokens"]:
            raise AssertionError("17a: the ranks served different tokens")
        want = cfg.num_layers * r["stats"]["decode_steps"]
        if r["launches"] != want or r["split"]["launches"] != \
                cfg.num_layers:
            raise AssertionError(f"17a rank {r['rank']}: {r['launches']} "
                                 f"decode launches (expected {want}); "
                                 f"split {r['split']['launches']} a step")
        if r["pool"] != (TF_SLOTS, TF_MAX_LEN // m, cfg.num_kv_heads,
                         cfg.head_dim_):
            raise AssertionError(f"17a: pool {r['pool']}")
        if abs(r["peak"] / GIB - pred) > TF_PEAK_MARGIN_GIB:
            raise AssertionError(f"17a rank {r['rank']}: peak "
                                 f"{r['peak'] / GIB:.2f} GiB, predicted "
                                 f"{pred:.2f} +- {TF_PEAK_MARGIN_GIB}")

    def gap(a, b):
        d = (a.float() - b.float()).abs()
        return d.max().item(), d.mean().item()

    tf2 = [unbits(a) for a in ranks[0]["tf"]]
    gaps = [gap(a, b) for a, b in zip(tf2, tf1)]
    fault_gap = gap(unbits(ranks[0]["fault"][0]), fault1[0])
    worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    scale = attn1.abs().max().item()
    attn_rel = {k: max((torch.from_numpy(r["attn"][k]) - attn1).abs().max()
                       .item() for r in ranks) / scale
                for k in ranks[0]["attn"]}
    print(f"17a: |logit gap| to M=1 along its tokens (max, mean) "
          f"{[(round(a, 4), round(b, 5)) for a, b in gaps]}, the "
          f"unweighted merge's ({fault_gap[0]:.4f}, {fault_gap[1]:.5f}); "
          f"layer 0's attention on unit-scale caches, max |diff| to M=1 / "
          f"max |M=1| ({scale:.4f}): "
          f"{ {k: round(v, 5) for k, v in attn_rel.items()} } (bound "
          f"{TF_ATTN_REL_BOUND})", flush=True)
    if not (worst[0] <= TF_LOGIT_BOUND and worst[1] <= TF_LOGIT_MEAN_BOUND):
        raise AssertionError(f"17a: logit gaps to M=1 (max, mean) {gaps}, "
                             f"bounds {TF_LOGIT_BOUND}, "
                             f"{TF_LOGIT_MEAN_BOUND}")
    if not (attn_rel["merged"] <= TF_ATTN_REL_BOUND
            and attn_rel["unweighted"] > TF_ATTN_REL_BOUND
            and attn_rel["drop"] > TF_ATTN_REL_BOUND):
        raise AssertionError(f"17a: the attention check {attn_rel} against "
                             f"{TF_ATTN_REL_BOUND}: the merge must be "
                             f"under it and both faults over it")
    ties = near_ties("17a", tokens1, ranks[0]["tokens"], tf1, tf2, tol)
    r0 = ranks[0]
    sp = r0["split"]
    step_ms = decode_step_ms(r0["spans"], r0["stats"]["decode_steps"])
    generated = r0["stats"]["tokens_generated"]
    coll = {k: (v["calls"], round(v["seconds"], 3))
            for k, v in r0["collectives"].items()}
    for r in ranks:
        print(f"17a rank {r['rank']} {r['coords']}: blocks {r['shapes']}, "
              f"KV pool {r['pool']}; init {r['init_s']:.1f} s (peak "
              f"{r['init_peak'] / GIB:.2f} GiB); serving peak "
              f"{r['peak'] / GIB:.2f} GiB (predicted {pred:.2f}); "
              f"{r['launches']} decode launches, all in the partial mode, "
              f"over {r['stats']['decode_steps']} steps "
              f"({r['launches'] // r['stats']['decode_steps']} a step)",
              flush=True)
    print(f"17a: {len(r0['tokens'])} requests, {generated} tokens in "
          f"{r0['elapsed']:.3f} s = {generated / r0['elapsed']:.2f} tok/s "
          f"(M=1 {stats1['tokens_generated'] / elapsed1:.2f}); decode step "
          f"{step_ms:.3f} ms (decode + sample spans); engine collectives "
          f"{coll} (calls, s); tokens equal on {m} ranks; to M=1: "
          f"{sum(a == b for a, b in zip(tokens1, r0['tokens']))} of "
          f"{len(tokens1)} requests equal, first differences (request, "
          f"token, gap in M=1's logits, in M=4's) {ties}; |logit gap| "
          f"along M=1's tokens (max, mean) a request "
          f"{[(round(a, 4), round(b, 5)) for a, b in gaps]} (bounds "
          f"{TF_LOGIT_BOUND}, {TF_LOGIT_MEAN_BOUND}); {spawn_s:.1f} s on "
          f"the shared ranks (started on first use); {smi_line()}", flush=True)
    print(f"17a decode step split (rank 0, {TF_SLOTS} slots, "
          f"{TP_SPLIT_STEPS} steps, host clock): {sp['step_ms']:.3f} ms = "
          f"compute {sp['compute_ms']:.3f} + "
          + " + ".join(f"{k} {v:.3f} ({sp['calls'][k]} calls)"
                       for k, v in sorted(sp["ms"].items()))
          + f"; {sp['launches']:.0f} decode launches a step", flush=True)
    small = {"17d-1x4": check_small("17d (1, 4)", ranks, cases)}

    # 17b: the slots over the data axis (in 17a's world)
    dranks = [r["data"] for r in ranks]
    half = TF_SLOTS // TF_DATA_MESH[0]
    for r in dranks:
        if not r["equal"] or r["tokens"] != dranks[0]["tokens"]:
            raise AssertionError("17b: the ranks served different tokens")
        st = r["stats"]
        if r["launches"] != cfg.num_layers * st["decode_steps"] or \
                r["split"]["launches"] != cfg.num_layers:
            raise AssertionError(f"17b rank {r['rank']}: {r['launches']} "
                                 f"launches over {st['decode_steps']} "
                                 f"steps")
        if st["row_slots"] != half or r["pool"][0] != half or \
                r["pool"][2] != cfg.num_kv_heads // TF_DATA_MESH[1]:
            raise AssertionError(f"17b: pool {r['pool']}, slots "
                                 f"{st['row_slots']}")
        if r["collectives"].get("data_gather") != \
                st["decode_steps"] + st["prefills"]:
            raise AssertionError(f"17b: collectives {r['collectives']}")
    dties = near_ties("17b", tokens1, dranks[0]["tokens"], tf1, None, tol)
    d0 = dranks[0]
    dsp = d0["split"]
    dgen = d0["stats"]["tokens_generated"]
    print(f"17b {TF_ARCH} on a {TF_DATA_MESH} mesh (4 gloo ranks, one "
          f"card): each data row decodes {half} of {TF_SLOTS} slots "
          f"(pool {d0['pool']}); {dgen} tokens in {d0['elapsed']:.3f} s = "
          f"{dgen / d0['elapsed']:.2f} tok/s; {d0['launches']} decode "
          f"launches a rank over {d0['stats']['decode_steps']} steps "
          f"({cfg.num_layers} a step on {half} rows); collectives "
          f"{d0['collectives']}; tokens equal on 4 ranks, to M=1: "
          f"{sum(a == b for a, b in zip(tokens1, d0['tokens']))} of "
          f"{len(tokens1)} requests equal, first differences {dties}; peak "
          f"{[round(r['peak'] / GIB, 2) for r in dranks]} GiB; decode step "
          f"at {half} slots {dsp['step_ms']:.3f} ms = compute "
          f"{dsp['compute_ms']:.3f} + "
          + " + ".join(f"{k} {v:.3f}" for k, v in sorted(dsp["ms"].items()))
          + f"; {smi_line()}", flush=True)
    small["17d-2x2"] = check_small("17d (2, 2)", dranks, cases)
    return {"rows": rows, "launches": r0["launches"],
            "data_launches": d0["launches"], "gaps": gaps,
            "fault_gap": fault_gap, "attn_rel": attn_rel, "split": sp,
            "data_split": dsp,
            "peak_gib": [r["peak"] / GIB for r in ranks],
            "predicted_gib": pred, "small": small}


def near_ties(label, tokens1, tokens2, tf1, tf2, tol) -> list:
    """Each request's tokens equal M = 1's up to its first difference,
    which must be a bf16 near-tie in M = 1's teacher-forced logits (and
    in ``tf2``'s, when given); returns (request, token, gaps)."""
    ties = []
    for i, (a, b) in enumerate(zip(tokens1, tokens2)):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        g1, lim1 = logit_gaps(tf1[i][j], torch.tensor(b[j]), tol)
        g2, lim2 = (torch.tensor(0.0), torch.tensor(1.0)) if tf2 is None \
            else logit_gaps(tf2[i][j], torch.tensor(a[j]), tol)
        ties.append((i, j, round(g1.item(), 4), round(g2.item(), 4)))
        if g1 > lim1 or g2 > lim2:
            raise AssertionError(f"{label} request {i}: token {j} differs "
                                 f"from M=1 ({a[j]} vs {b[j]}) beyond a "
                                 f"bf16 tie: gaps {g1.item()} / "
                                 f"{g2.item()}, allowed {lim1.item()} / "
                                 f"{lim2.item()}")
    return ties


def fam_inputs(cfg, model):
    """17c's inputs for ``cfg``: the engine's requests and image rows
    (vlm), or ``generate``'s prompts and frames."""
    if model.prefill is not None:
        reqs = requests_of(cfg.vocab_size, 17, 4, (16, 48), (8, 16))
        return reqs, extra_draw(cfg, FAM_TP_SLOTS, 17)
    b, s, _ = FAM_TP_GEN
    prompts = np.random.RandomState(17).randint(1, cfg.vocab_size,
                                                size=(b, s))
    extra = None if cfg.family != "encdec" else extra_draw(cfg, b, 17)
    return prompts, extra


def fam_run(serving, ops, L, model, params, mesh=None, want=None) -> dict:
    """17c's run of one family on ``params`` (on ``mesh``'s blocks):
    its tokens, decode launches and steps, the last prompt position's
    logits (bf16 bits), and, against ``want`` (M = 1's tokens), for
    each row that differs the gap of M = 1's token in this run's
    logits at the first difference (teacher-forced along ``want``)
    beside the bf16 tie allowance."""
    from repro_torch.kernels.attention_decode import decode_parity_tolerance
    cfg = model.cfg
    inputs, extra = fam_inputs(cfg, model)
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = None
    if model.prefill is not None:
        eng = serving.Engine(model, params, serving.ServeConfig(
            slots=FAM_TP_SLOTS, max_len=FAM_TP_MAX_LEN, page_size=16),
            device="cuda" if mesh is None else mesh.device, mesh=mesh,
            extra=extra)
        rows = PrefillRows(eng)
        results, stats, elapsed, launches = serve(eng, ops, inputs)
        tokens = [list(r.tokens) for r in results]
        steps = stats["decode_steps"]
        del eng
        last = [serving.prefill(model, params, torch.tensor(
            p[None], dtype=torch.int64, device="cuda"), FAM_TP_MAX_LEN,
            extra[i:i + 1], mesh=mesh)[0][0, -1] for i, p in
            enumerate(inputs[0])]
        last = torch.stack(last)
    else:
        b, s, new = FAM_TP_GEN
        tokens = serving.generate(model, params, inputs, num_tokens=new,
                                  extra_embeds=extra, device="cuda",
                                  mesh=mesh).cpu().tolist()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launches["attention_decode"]
        steps = s + new
        last = serving.prefill(model, params, torch.as_tensor(
            inputs, device="cuda"), s + new, extra, mesh=mesh)[0][:, -1]
    peak = torch.cuda.max_memory_allocated()
    ties = []
    tol = decode_parity_tolerance(torch.bfloat16)
    for i, (a, b) in enumerate(zip(want or [], tokens)):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        if rows is not None:
            prompt, max_len = inputs[0][i], FAM_TP_MAX_LEN
            r = rows.row(prompt)
        else:
            prompt, max_len, r = inputs[i], FAM_TP_GEN[1] + FAM_TP_GEN[2], i
        with L.batch_sharding(mesh):
            g = tie_gaps(serving, model, params, prompt, a[:j + 1], tol,
                         max_len, None if extra is None
                         else extra[r:r + 1])
        ties.append((i, j, g[j][0], g[j][1]))
    return {"tokens": tokens, "launches": launches, "steps": steps,
            "seconds": elapsed, "last": bits(last.float().cpu()),
            "peak": peak, "ties": ties}


def fam_config(get_config, arch):
    cfg = get_config(arch)
    if arch in FAM_TP_LAYERS:
        cfg = cfg.replace(num_layers=FAM_TP_LAYERS[arch])
    return cfg


def fam_tp_rank(wants: dict) -> dict:
    """17c on one rank of the (1, 2) mesh: each family's blocks of its
    seed-0 draw (vlm gates opened), run as :func:`fam_run`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    mesh = mesh_lib.make_host_mesh(*FAM_TP_MESH)
    out = {"rank": mesh.rank}
    for arch in FAM_TP_ARCHS:
        model = get_model(fam_config(get_config, arch))
        torch.cuda.reset_peak_memory_stats()
        params = model.init(0, device=mesh.device, mesh=mesh)
        if "layers" in params:
            open_gates(params)
        res = fam_run(serving, ops, L, model, params, mesh, wants[arch])
        res["equal"] = mesh_lib.all_equal(mesh, res["tokens"])
        out[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_families_tp(ops, serving, mesh_lib, get_config, get_model
                      ) -> dict:
    """17c: the vlm, encdec, ssm and hybrid families at (1, 2), full
    width: M = 1 here first on the same seed-0 weights, then two gloo
    ranks."""
    from repro_torch.models import layers as L
    from repro_torch.models.hybrid import hybrid_layout
    single = {}
    for arch in FAM_TP_ARCHS:
        cfg = fam_config(get_config, arch)
        if arch in FAM_TP_LAYERS:
            print(f"17c {arch}: reduced: num_layers "
                  f"{get_config(arch).num_layers} -> {cfg.num_layers} (the "
                  f"script's time budget; width as published)", flush=True)
        model = get_model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(0, device="cuda")
        if "layers" in params:
            open_gates(params)
        single[arch] = fam_run(serving, ops, L, model, params)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = on_ranks(fam_tp_rank, FAM_TP_MESH[1],
                     args=({a: single[a]["tokens"] for a in FAM_TP_ARCHS},),
                     timeout=600)
    spawn_s = time.perf_counter() - t0
    out = {}
    for arch in FAM_TP_ARCHS:
        cfg = fam_config(get_config, arch)
        per = {"vlm": cfg.num_layers, "encdec": cfg.num_layers, "ssm": 0,
               "hybrid": hybrid_layout(cfg)[0]}[cfg.family]
        one = single[arch]
        got = [r[arch] for r in ranks]
        for g in got:
            if not g["equal"] or g["tokens"] != got[0]["tokens"]:
                raise AssertionError(f"17c {arch}: ranks differ")
            if g["launches"] != per * g["steps"]:
                raise AssertionError(f"17c {arch}: {g['launches']} decode "
                                     f"launches over {g['steps']} steps "
                                     f"({per} a step expected)")
        d = (unbits(got[0]["last"]).float()
             - unbits(one["last"]).float()).abs()
        gap = (d.max().item(), d.mean().item())
        if not (gap[0] <= TF_LOGIT_BOUND and gap[1] <= TF_LOGIT_MEAN_BOUND):
            raise AssertionError(f"17c {arch}: last prompt logits to M=1 "
                                 f"(max, mean) {gap}")
        equal = sum(a == b for a, b in zip(one["tokens"], got[0]["tokens"]))
        for i, j, g, allowed in got[0]["ties"]:
            if g > allowed:
                raise AssertionError(f"17c {arch} row {i}: token {j} differs "
                                     f"from M=1 beyond a bf16 tie: M=1's "
                                     f"token {g:.4f} below the best of "
                                     f"M=2's logits, allowed {allowed:.4f}")
        how = "engine" if cfg.family == "vlm" else "generate"
        print(f"17c {arch} ({cfg.family}, {cfg.num_layers} layers) on a "
              f"{FAM_TP_MESH} mesh: {how} in {got[0]['seconds']:.2f} s (M=1 {one['seconds']:.2f} s), "
              f"tokens equal on 2 ranks, {equal} of {len(one['tokens'])} "
              f"rows equal to M=1 (first differences: row, token, gap of "
              f"M=1's token in M=2's logits "
              f"{[(i, j, round(g, 4)) for i, j, g, _ in got[0]['ties']]}); "
              f"{got[0]['launches']} decode launches "
              f"over {got[0]['steps']} steps ({per} a step); last prompt "
              f"logits to M=1 (max, mean) ({gap[0]:.4f}, {gap[1]:.5f}); "
              f"peak a rank {[round(g['peak'] / GIB, 2) for g in got]} GiB "
              f"(M=1 {one['peak'] / GIB:.2f})", flush=True)
        out[arch] = {"launches": got[0]["launches"], "gap": gap,
                     "equal": equal}
    print(f"17c: {spawn_s:.1f} s on the shared ranks (started on first "
          f"use); {smi_line()}", flush=True)
    return out


# ------------------------------------ 18-18c: training over the model axis
TT_ARCH = "qwen2.5-3b"
TT_LAYERS = 2                  # of 36: the script's time budget
TT_STEPS = 2
TT_BATCH = 4                   # global batch of 4 x 512 tokens
TT_ARGV = ["--arch", TT_ARCH, "--optimizer", "tvlars", "--use-kernel",
           "fused", "--precision", "f32", "--global-batch", str(TT_BATCH),
           "--seq", "512", "--steps", str(TT_STEPS), "--layerwise-every",
           "1", "--device", DEV]
TT_PT_ARGV = ["--arch", TT_ARCH, "--optimizer", "wa-lars", "--use-kernel",
              "per_tensor", "--precision", "f32", "--global-batch",
              str(TT_BATCH), "--seq", "512", "--steps", str(TT_STEPS),
              "--device", DEV]
TT_MESH, TT_FSDP_MESH = (1, 2), (2, 2)
# gaps to M = 1 on the same samples and weights (bf16 model): the loss,
# grad_norm and the layer-wise norms relative as phase 15's DP_BOUNDS;
# the params after 3 steps absolute, the reference test's own atol
# (tests/test_sharding_multidevice.py) over the bf16 leaves
TT_BOUNDS = dict(DP_BOUNDS, params=2e-3)
TT_SMOKE = ("qwen2.5-3b", "gemma3-12b")
TT_SMOKE_MESHES = ((2, 2), (1, 4))
# the step split: collectives by what they carry (Mesh.collectives names)
TT_SPLIT = {"row sums": ("model_sum",),
            "fsdp gathers": ("fsdp_gather",),
            "column reduce": ("fsdp_reduce", "column_reduce"),
            "table all_reduce": ("norm_table", "grad_norm")}


def tt_rules(cfg, mesh_shape: tuple, use_kernel: str) -> dict:
    """What the placement rules give one rank of a ``mesh_shape`` mesh
    (every rank's blocks have one shape): the params' bytes, the
    optimizer state's (the step, and the fused flat buffer over the
    blocks or a tree of f32 blocks), the gradients' (the blocks at the
    params' dtype; f32 for leaves whole over the data axis when D > 1,
    which the column average widens), the flat elements and the kernel
    segments by whole size."""
    from repro_torch.core import flatten, layerwise
    from repro_torch.core.base import tree_flatten_with_path, tree_from_paths
    from repro_torch.launch import sharding
    from repro_torch.models import convert, get_model
    from repro_torch.models.registry import FAMILIES

    class At:
        shape = dict(zip(("data", "model"), mesh_shape))
        coords = {"data": 0, "model": 0}

    place = convert.placement(cfg, At())
    meta = FAMILIES[cfg.family][0](cfg, torch.Generator(),
                                   torch.device("meta"))
    blocks = tree_from_paths(meta, {
        p: t[sharding.local_block(place.spec(p), At(), t.shape)]
        for p, t in tree_flatten_with_path(meta)})
    spec = flatten.build_spec(blocks, segments=get_model(cfg).segments)
    leaves = list(tree_flatten_with_path(blocks))
    params = sum(t.numel() * t.element_size() for _, t in leaves)
    grads = sum(t.numel() * (4 if mesh_shape[0] > 1
                             and place.data_dim(p) is None
                             else t.element_size()) for p, t in leaves)
    elems = spec.num_rows * flatten.LANES
    state = params + 4 + (elems * 4 if use_kernel == "fused"
                          else sum(t.numel() * 4 for _, t in leaves))
    return {"params": params, "grads": grads, "state": state,
            "flat": elems,
            "kernel_segments": layerwise.kernel_segments(spec, place)}


def tt_peak(cfg, mesh_shape: tuple, rules: dict, fused: bool = True
            ) -> float:
    """Predicted peak bytes of a rank of a TVLARS / WA-LARS f32 step: the
    state, the gradients (:func:`tt_rules`), on the fused path the
    optimizer's packed weights, gradients and f32 delta (3 x 4 B a flat
    element; the per-tensor path's deltas are one segment's), the remat
    inputs of every layer, one layer's recomputed activations at the TP
    widths, and a CE chunk's f32 logits over V / M (three live
    copies)."""
    d, m = mesh_shape
    b, s = TT_BATCH // d, 512
    grads = rules["grads"]
    layer = b * s * (8 * cfg.d_model + 3 * cfg.d_ff // m) * 4
    remat = b * s * cfg.d_model * 2 * cfg.num_layers
    ce = b * 256 * (cfg.vocab_size // m) * 4 * 3
    work = 3 * 4 * rules["flat"] if fused else 0
    return rules["state"] + grads + work + remat + layer + ce


def tt_state_bytes(state) -> int:
    from repro_torch.core.base import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(state)
               if isinstance(x, torch.Tensor))


def tt_param_gap(params, place, ref_path: str) -> float:
    """The largest |gap| of this rank's blocks to the M = 1 run's whole
    params (a file of CPU tensors by path, memory-mapped)."""
    from repro_torch.core.base import path_name, tree_flatten_with_path
    ref = torch.load(ref_path, mmap=True)
    worst = 0.0
    for path, block in tree_flatten_with_path(params):
        whole = ref[path_name(path)]
        mine = place.block(path, whole).to(block.device)
        worst = max(worst, (mine.float() - block.float()).abs().max().item())
    return worst


def tt_split(out: dict, steps: int) -> dict:
    """Mean ms a step: the step (loss+grad and optimizer spans, both
    synchronised) and each TT_SPLIT group of collectives, compute the
    rest."""
    total = (sum(out["loss_grad_seconds"]) + sum(out["optimizer_seconds"])) \
        / steps * 1e3
    col = out["collectives"]
    split = {k: sum(col.get(n, {}).get("seconds", 0.0) for n in names)
             / steps * 1e3 for k, names in TT_SPLIT.items()}
    calls = {k: sum(col.get(n, {}).get("calls", 0) for n in names) // steps
             for k, names in TT_SPLIT.items()}
    return {"step": total, "compute": total - sum(split.values()),
            **split, "calls": calls}


def tt_seg_kernels(su, sref, flatten, model, params, place) -> dict:
    """The segmented kernels on this rank's flat buffers (its blocks
    packed, seeded gradients, a copy of the momentum): pass 1 against
    the plain version (NORM_RTOL), pass 2 bitwise, and on rank 0 both
    timed."""
    spec = flatten.build_spec(params, segments=model.segments)
    w = flatten.pack(params, spec)
    gen = torch.Generator(device=w.device).manual_seed(18)
    g = torch.randn(w.shape, generator=gen, device=w.device) * 1e-3
    bufs = (torch.randn(w.shape, generator=gen, device=w.device) * 1e-3,)
    ids = spec.segment_ids(w.device)
    adapt = spec.adapt_mask(w.device)
    h = OPT_HYPER
    common = dict(b1=h["b1"], b2=h["b2"], eps=h["eps"], bc1=0.5, bc2=0.01)
    nseg = spec.num_segments
    norms = su.seg_norm_cuda(w, g, bufs, ids, nseg, mode="paper",
                             weight_decay=h["weight_decay"], **common)
    plain = su.seg_norm_ref(w, g, bufs, ids, nseg, mode="paper",
                                        weight_decay=h["weight_decay"],
                                        **common)
    err = ((norms - plain).abs() / plain.abs().clamp_min(1e-30)).max().item()
    if not err <= NORM_RTOL:
        raise AssertionError(f"18: seg_norm on a rank's block, relative "
                             f"error {err}")
    _, _, ratio = sref.trust_ratio(norms[0], norms[1], adapt, mode="paper",
                                   eta=h["eta"],
                                   weight_decay=h["weight_decay"],
                                   eps=h["eps"], trust_clip=None)
    table = sref.scales_from_ratio(ratio, adapt, 0.1, h["weight_decay"])
    kb = tuple(b.clone() for b in bufs)
    _, kd = su.seg_apply_cuda(w, g, kb, ids, table, mode="paper",
                              momentum=h["momentum"], seed=1, **common)
    pb, pd = su.seg_apply_ref(w, g, bufs, ids, table, mode="paper",
                              momentum=h["momentum"], seed=1, **common)
    if not (torch.equal(kd, pd) and all(torch.equal(a, b)
                                        for a, b in zip(kb, pb))):
        raise AssertionError("18: seg_apply on a rank's block differs "
                             "from its plain version")
    # timed on rank 0 alone: the other rank would share the card
    place.mesh.barrier()
    times = time_seg(su, spec, w, g, bufs, ids, table, "paper", False,
                     iters=5, plain_iters=1) if place.mesh.rank == 0 \
        else None
    place.mesh.barrier()
    return {"norm_err": err, "apply_abs_err": (kd - pd).abs().max().item(),
            "rows": spec.num_rows, "segments": nseg, "times": times}


def tt_lars_kernels(lu, sref, cfg, params, names: list, mesh) -> dict:
    """The per-tensor passes on this rank's blocks of the largest
    kernel segment (its members, seeded gradients, zero momentum):
    sums within LARS_NORM_RTOL of plain, the apply bitwise, and on rank
    0 both timed."""
    from repro_torch.core.base import tree_get
    from repro_torch.models import convert
    segs = convert.segment_paths(cfg, params)
    seg = max((s for s in segs if s.name in names),
              key=lambda s: sum(tree_get(params, p).numel() for p in s.paths))
    ws = [tree_get(params, p).contiguous() for p in seg.paths]
    gen = torch.Generator(device=ws[0].device).manual_seed(19)
    gs = [torch.randn(w.shape, generator=gen, device=w.device)
          .to(w.dtype) * 1e-3 for w in ws]
    ms = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
          for w in ws]
    lr = torch.tensor(0.1, device=ws[0].device)
    case = lars_case(lu, sref, [(ws, gs, ms)], lr, False)
    mesh.barrier()
    times = time_lars(lu, sref, [(ws, gs, [m.clone() for m in ms])], lr) \
        if mesh.rank == 0 else None
    mesh.barrier()
    return {"segment": seg.name, "case": case, "times": times,
            "elements": sum(w.numel() for w in ws)}


def tt_rank_1x2(layers: int, ref_path: str) -> dict:
    """18 and 18b on one rank of a (1, 2) world: fused TVLARS through
    ``launch.train.run --mesh-model 2`` (launch counts a step, the step
    split, state bytes, peak, the param gap to M = 1, the segmented
    kernels on this rank's flat buffers), then per-tensor WA-LARS (its
    launches a step and the per-tensor kernels on this rank's blocks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import flatten
    from repro_torch.kernels import lars_update as lu
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as sref
    from repro_torch.kernels import segmented_update as su
    from repro_torch.launch import train as train_launch
    res = {}
    for label, argv in (("18", TT_ARGV), ("18b", TT_PT_ARGV)):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        watch = StepWatch(ops)
        with depth_cut(train_launch, TT_ARCH, layers), \
                watched_fit(train_launch, watch):
            out = train_launch.run(argv + ["--mesh-model", "2"],
                                   log_fn=_tt_log(label))
        model, place, state = out["model"], out["placement"], out["state"]
        r = {"history": out["history"], "launches": watch.launches,
             "split": tt_split(out, TT_STEPS),
             "state_bytes": tt_state_bytes(state),
             "peak": out["peak_memory_bytes"], "rank": out["rank"]}
        if label == "18":
            r["param_gap"] = tt_param_gap(state.params, place, ref_path)
            r["seg"] = tt_seg_kernels(su, sref, flatten, model,
                                      state.params, place)
        else:
            names = tt_rules(model.cfg, TT_MESH, "per_tensor")[
                "kernel_segments"]
            r["kernel_segments"] = len(names)
            r["lars"] = tt_lars_kernels(lu, sref, model.cfg, state.params,
                                        names, out["mesh"])
        res[label] = r
        del out, state
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _tt_log(label: str):
    from repro_torch import distributed as dist_lib
    rank = dist_lib.world().rank
    return lambda line: print(f"  {label} rank {rank}: {line}", flush=True) \
        if rank == 0 else None


def tt_rank_2x2(layers: int, ref_path: str, ckpt: str) -> dict:
    """18a and 18c on one rank of a (2, 2) world: fused TVLARS through
    ``launch.train.run --mesh-model 2 --mesh-data 2`` (as 18), its state
    saved (``checkpoint.save_train_state``, the gathered state's
    fingerprint returned), then the smoke configs at (2, 2) and (1, 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_launch
    from repro_torch.training.train_state import fingerprint
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    watch = StepWatch(ops)
    with depth_cut(train_launch, TT_ARCH, layers), \
            watched_fit(train_launch, watch):
        out = train_launch.run(TT_ARGV + ["--mesh-model", "2",
                                          "--mesh-data", "2"],
                               log_fn=_tt_log("18a"))
    model, place, state = out["model"], out["placement"], out["state"]
    res = {"history": out["history"], "launches": watch.launches,
           "split": tt_split(out, TT_STEPS),
           "state_bytes": tt_state_bytes(state),
           "peak": out["peak_memory_bytes"], "rank": out["rank"],
           "param_gap": tt_param_gap(state.params, place, ref_path)}
    t0 = time.perf_counter()
    whole = checkpoint.save_train_state(ckpt, state, cfg=model.cfg,
                                        mesh=out["mesh"], placement=place,
                                        segments=model.segments)
    res["save_s"] = time.perf_counter() - t0
    res["saved_print"] = None if whole is None else fingerprint(whole)
    del out, state, whole
    gc.collect()
    torch.cuda.empty_cache()
    small = {}
    for d, m in TT_SMOKE_MESHES:
        mesh = mesh_lib.make_host_mesh(d, m)
        for arch in TT_SMOKE:
            small[(d, m, arch)] = tt_small_losses(arch, mesh,
                                                  FT_SMALL_STEPS)
    res["small"] = small
    res["world"] = mesh_lib.world().size
    return res


def tt_small_losses(arch: str, mesh=None, steps: int = 3) -> list:
    """``steps`` fused TVLARS steps of ``arch``'s smoke config in f32
    (K = 2 of 4 x 32) from the seed-0 weights drawn on the CPU (a vlm's
    gates opened) and CPU-drawn batches (with seeded normal extra
    embeddings for a family that reads them): on the CPU
    (``mesh=None``), or on this rank's blocks of ``mesh`` on its card.
    The losses."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import build_optimizer
    from repro_torch.core.base import tree_map
    from repro_torch.data.synthetic import lm_iterator
    from repro_torch.models import convert, extra_embed_shape, get_model
    from repro_torch.training import TrainState, lm_task, make_train_step
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    if cfg.family == "vlm":
        open_gates(params)
    dev, place = torch.device("cpu"), None
    if mesh is not None:
        dev, place = mesh.device, convert.placement(cfg, mesh)
        params = tree_map(lambda t: t.to(dev), convert.shard_params(
            cfg, params, mesh, fsdp=True))
    opt = build_optimizer("tvlars", total_steps=10, learning_rate=2.0,
                          batch_size=8, use_kernel="fused",
                          segments=model.segments, device=dev,
                          placement=place)
    state = TrainState.create(params, opt)
    step = make_train_step(lm_task(model), opt, accum_steps=2, mesh=mesh,
                           placement=place)
    gen = torch.Generator().manual_seed(FT_DRAW_SEED)
    shape = extra_embed_shape(cfg, 4)
    losses = []
    for batch in lm_iterator(8, 32, cfg.vocab_size, seed=1, accum_steps=2,
                             device="cpu"):
        if shape is not None:
            batch = dict(batch, extra_embeds=torch.randn(
                (2,) + shape, generator=gen))
        state, metrics = step(state, {k: v.to(dev) for k, v in
                                      batch.items()})
        losses.append(float(metrics["loss"]))
        if len(losses) == steps:
            return losses


def tt_report(label, mesh_shape, ranks, one, rules, pred_peak, per_step,
              arch=TT_ARCH, steps=TT_STEPS):
    """Check and print one mesh's run: launches a step, replicas (the
    launcher raised otherwise), gaps to M = 1's history ``one`` (when
    given; the segment of each metric's worst gap printed) and params
    within TT_BOUNDS, state bytes equal to the rules' prediction; the
    split, the peak (beside ``pred_peak`` when given) and, where the run
    counted them, the leaves whose data axis the reference puts on a
    stacked dim."""
    for r in ranks:
        if r["launches"] != [per_step] * steps:
            raise AssertionError(f"{label} {arch} rank {r['rank']}: "
                                 f"launches per step {r['launches']}, "
                                 f"expected {per_step}")
        if r["state_bytes"] != rules["state"]:
            raise AssertionError(f"{label} {arch} rank {r['rank']}: state "
                                 f"{r['state_bytes']} B, the rules say "
                                 f"{rules['state']}")
    gaps, worst = ({}, {}) if one is None \
        else gaps_where(ranks[0]["history"], one)
    if "param_gap" in ranks[0]:
        gaps["params"] = max(r["param_gap"] for r in ranks)
    over = {k: v for k, v in gaps.items() if not v <= TT_BOUNDS[k]}
    if over:
        raise AssertionError(f"{label} {arch}: gaps to M=1 {gaps} over the "
                             f"bounds {TT_BOUNDS} (worst at {worst})")
    sp = ranks[0]["split"]
    picks = ranks[0].get("stacked_picks")
    print(f"{label} {arch} on a {mesh_shape} mesh (gloo ranks sharing "
          f"the card): {per_step} a rank a step; ranks holding the same "
          f"block bitwise equal; "
          + ("" if picks is None else
             f"{picks} leaves whole over the data column where the "
             f"reference puts the data axis on a stacked dim; ")
          + (f"gaps to M=1 (worst over {steps} steps) "
             + ", ".join(f"{k} {v:.3e}" for k, v in sorted(gaps.items()))
             + f" (bounds {TT_BOUNDS}; worst at {worst}); "
             if gaps else "")
          + "step split (rank 0, mean ms a step) "
          f"{sp['step']:.1f} = compute {sp['compute']:.1f} + "
          + " + ".join(f"{k} {sp[k]:.1f} ({sp['calls'][k]} calls)"
                       for k in TT_SPLIT)
          + f"; state a rank {ranks[0]['state_bytes']} B (rules "
          f"{rules['state']} B, params {rules['params']} B); peak a rank "
          f"{[round(r['peak'] / GIB, 2) for r in ranks]} GiB"
          + ("" if pred_peak is None
             else f" (predicted {pred_peak / GIB:.2f})"), flush=True)
    return gaps


def phase_model_axis_training(train_launch, ops, serving, checkpoint,
                              mesh_lib, get_config, get_smoke_config,
                              get_model, tree_leaves) -> dict:
    """18-18c: training over the model axis (see the module docstring)."""
    from repro_torch.core import build_optimizer
    from repro_torch.core.base import path_name, tree_flatten_with_path
    from repro_torch.training import TrainState
    from repro_torch.training.train_state import fingerprint
    full = get_config(TT_ARCH)
    cfg = full.replace(num_layers=TT_LAYERS)
    print(f"18 {TT_ARCH}: reduced: num_layers {full.num_layers} -> "
          f"{TT_LAYERS} (the script's time budget; width as published: "
          f"{cfg.d_model} wide, {cfg.num_heads} / {cfg.num_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16)", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tt_")
    try:
        # M = 1 on the same weights and batches, both optimizers
        ref_path = os.path.join(tmp, "m1.pt")
        with depth_cut(train_launch, TT_ARCH, TT_LAYERS):
            one = train_launch.run(TT_ARGV, log_fn=lambda line: None)
        single = one["history"]
        torch.save({path_name(p): t.detach().cpu() for p, t in
                    tree_flatten_with_path(one["state"].params)}, ref_path)
        del one
        gc.collect()
        torch.cuda.empty_cache()
        rules = {shape: tt_rules(cfg, shape, "fused")
                 for shape in (TT_MESH, TT_FSDP_MESH)}
        rules_pt = tt_rules(cfg, TT_MESH, "per_tensor")
        preds = {shape: tt_peak(cfg, shape, rules[shape])
                 for shape in rules}
        print(f"18 predicted: state a rank {rules[TT_MESH]['state']} B at "
              f"{TT_MESH}, {rules[TT_FSDP_MESH]['state']} B at "
              f"{TT_FSDP_MESH}; peak a rank "
              f"{preds[TT_MESH] / GIB:.2f} / "
              f"{preds[TT_FSDP_MESH] / GIB:.2f} GiB", flush=True)
        seg = {"seg_norm_lars": 1, "seg_apply_lars": 1}
        t0 = time.perf_counter()
        r12 = on_ranks(tt_rank_1x2, 2, args=(TT_LAYERS, ref_path),
                       timeout=600)
        s12 = time.perf_counter() - t0
        gaps = {"18": tt_report("18", TT_MESH, [r["18"] for r in r12],
                                single, rules[TT_MESH], preds[TT_MESH],
                                seg)}
        n_pt = len(rules_pt["kernel_segments"])
        pt = {"lars_norm2": 1, "lars_apply": 1}     # one pass a step
        for r in r12:
            if r["18b"]["kernel_segments"] != n_pt:
                raise AssertionError("18b: kernel segments differ from the "
                                     "rules'")
        tt_report("18b", TT_MESH, [r["18b"] for r in r12], None, rules_pt,
                                tt_peak(cfg, TT_MESH, rules_pt, False), pt)
        s18 = r12[0]["18"]["seg"]
        l18 = r12[0]["18b"]["lars"]
        print(f"18 kernels on rank 0's flat buffers ({s18['rows']} rows, "
              f"{s18['segments']} segments): seg_norm within "
              f"{s18['norm_err']:.2e} of plain, seg_apply bitwise; "
              f"{s18['times']['norm']['ms']:.4f} / "
              f"{s18['times']['apply']['ms']:.4f} ms (plain "
              f"{s18['times']['norm']['plain_ms']:.4f} / "
              f"{s18['times']['apply']['plain_ms']:.4f}, bounds "
              f"{s18['times']['norm']['bound_ms']:.4f} / "
              f"{s18['times']['apply']['bound_ms']:.4f}); 18b per-tensor "
              f"kernels on rank 0's blocks of {l18['segment']} "
              f"({l18['elements']} elements): {l18['case']}; "
              f"{l18['times']['norm']['ms']:.4f} / "
              f"{l18['times']['apply']['ms']:.4f} ms (plain "
              f"{l18['times']['norm']['plain_ms']:.4f} / "
              f"{l18['times']['apply']['plain_ms']:.4f}, bounds "
              f"{l18['times']['norm']['bound_ms']:.4f} / "
              f"{l18['times']['apply']['bound_ms']:.4f}); {s12:.1f} s "
              f"on the shared ranks (started on first use); {smi_line()}", flush=True)

        # 18a / 18c: (2, 2), the save, the smoke configs
        cpu_small = {arch: tt_small_losses(arch, steps=FT_SMALL_STEPS)
                     for arch in TT_SMOKE}
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        r22 = on_ranks(tt_rank_2x2, 4, args=(TT_LAYERS, ref_path, ckpt),
                       timeout=900)
        s22 = time.perf_counter() - t0
        gaps["18a"] = tt_report("18a", TT_FSDP_MESH, r22, single,
                                rules[TT_FSDP_MESH], preds[TT_FSDP_MESH],
                                seg)
        for (d, m, arch), got in r22[0]["small"].items():
            np.testing.assert_allclose(got, cpu_small[arch], rtol=1e-5,
                                       err_msg=f"18c {arch} ({d}, {m})")
        print(f"18c smoke configs {TT_SMOKE} f32 at {TT_SMOKE_MESHES} on the "
              f"card: losses within 1e-5 of the CPU's single-rank run "
              f"({ {a: [round(x, 6) for x in v] for a, v in cpu_small.items()} })",
              flush=True)
        # restore at M = 1, bitwise the gathered state, and serve
        model = get_model(cfg)
        opt = build_optimizer("tvlars", total_steps=TT_STEPS,
                              learning_rate=2.0, batch_size=TT_BATCH,
                              use_kernel="fused", segments=model.segments,
                              device=DEV)
        like = TrainState.create(model.init(0, device=DEV), opt)
        t0 = time.perf_counter()
        restored = checkpoint.restore_train_state(ckpt, like, cfg=cfg,
                                                  device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = fingerprint(checkpoint.train_state_tree(restored, cfg=cfg))
        if back != r22[0]["saved_print"]:
            raise AssertionError("18c: the state restored at M=1 differs "
                                 "from the (2, 2) ranks' gathered state")
        sc = serving.ServeConfig(slots=1, max_len=256, page_size=16)
        eng = serving.Engine(model, restored.params, sc, device=DEV)
        results, stats, elapsed, launches = serve(
            eng, ops, requests_of(cfg.vocab_size, 18, 1, (64, 128),
                                  (16, 32)))
        if launches != TT_LAYERS * stats["decode_steps"] or not launches:
            raise AssertionError(f"18c: {launches} decode launches for "
                                 f"{stats['decode_steps']} steps")
        print(f"18c: saved at {TT_FSDP_MESH} in {r22[0]['save_s']:.2f} s "
              f"(rank 0 writes the gathered state); restored at M=1 in "
              f"{restore_s:.2f} s, bitwise the gathered state "
              f"(fingerprints); one request served from it: "
              f"{stats['tokens_generated']} tokens, {launches} "
              f"attention_decode launches; {s22:.1f} s on the shared ranks (started on first use); "
              f"{smi_line()}", flush=True)
        del eng, restored, like
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"gaps": gaps, "r12": r12, "r22": r22,
            "seg": r12[0]["18"]["seg"], "lars": r12[0]["18b"]["lars"],
            "launches": {k: sum(s.get(k, 0) for s in r12[0]["18"]["launches"])
                         for k in SEG_LARS},
            "launches_2x2": {k: sum(s.get(k, 0)
                                    for s in r22[0]["launches"])
                             for k in SEG_LARS},
            "launches_pt": {k: sum(s.get(k, 0)
                                   for s in r12[0]["18b"]["launches"])
                            for k in ("lars_norm2", "lars_apply")}}


# ---------------- 19-19d: the other families over the GSPMD mesh, probes
FT_STEPS = 1
FT_ARGV = ["--optimizer", "tvlars", "--use-kernel", "fused", "--precision",
           "f32", "--global-batch", str(TT_BATCH), "--seq", "512",
           "--steps", str(FT_STEPS), "--layerwise-every", "1", "--device",
           DEV]
# depth cuts (whole blocks, groups or layers; widths as published): the
# script's time budget. mamba2 keeps 6 blocks so that fsdp gives the data
# axis to the stacked dim of conv_w / conv_b as at 48 (at 4 or fewer the
# conv width takes it); zamba2 one group of 6 blocks and its shared
# block; whisper 2 + 2 layers; the vlm one group (4 + 1 cross); olmoe 1.
# The vlm trains in f32: in bf16 the gradient of its gate (one scalar)
# is a sum over 2048 x 4096 products that cancel, and its M = 1 value
# is itself 10% from the f32 step's on the same values, so M = 2's sits
# 11.7% from it (tests/torch_bf16_card.py). Whisper trains in bf16: its
# vocabulary-parallel head sums each rank's f32 partial of the hidden
# state's gradient over the row and rounds once, which its final norm
# scale's g_norm needs to stay within TT_BOUNDS of M = 1's (bf16
# partials rounded on each rank put it 3.8% off: fault P5, ROADMAP §3)
FT_F32 = dict(param_dtype="float32", compute_dtype="float32")
FT_CUTS = {"mamba2-1.3b": dict(num_layers=6),
           "zamba2-1.2b": dict(num_layers=6),
           "whisper-large-v3": dict(num_layers=2, encoder_layers=2),
           "llama-3.2-vision-11b": dict(num_layers=5, **FT_F32),
           "olmoe-1b-7b": dict(num_layers=1)}
FT_MESHES = {"19": (("mamba2-1.3b", "zamba2-1.2b"), (2, 2)),
             "19a": (("whisper-large-v3", "llama-3.2-vision-11b"), (1, 2)),
             "19b": (("olmoe-1b-7b",), (2, 1))}
FT_DRAW_SEED = 19              # the random frames and image embeddings
# 19b: olmoe's load balance (summed over its layers) at D = 2 against
# D = 1, relative. Each data row routes its own block of the batch with
# the same weights as D = 1's rows (routing groups are batch rows), so
# the global means differ from D = 1's only where a bf16 product's
# rounding moves a router probability or flips a top-1 choice between
# near-ties; each flip moves the term by about E / N of a layer's
# value (N = 2048 tokens): 1e-4 leaves room for a few. The per-shard
# means' gap (0.16% at the smoke config's 2 shards) must exceed it
FT_LB_BOUND = 1e-4
# 19c: λ_max of the (1, 2) / (2, 2) probe against M = 1's from the same
# seed vector. The HVP is taken at the params' dtype (bf16): the TP
# path rounds its partial products apart from one device's, and the
# repo's bf16 HVP is held to 4·2⁻⁸ relative of the reference's
# (test_flat_hvp_bf16_lm_matches_reference, F5); λ_max of a 4-step
# Lanczos is a Rayleigh quotient of those products, so it gets the same
# relative bound
FT_PROBE_BOUND = 4 * 2.0 ** -8
# 19c's probe: 2 Lanczos iterations (4 until phases 20-20c came in: the
# script's time budget; each is a Hessian-vector product over the mesh)
FT_PROBE_ITERS = 2
FT_PROBE_ARGV = ["--arch", TT_ARCH, "--optimizer", "wa-lars",
                 "--use-kernel", "per_tensor", "--precision", "f32",
                 "--global-batch", str(TT_BATCH), "--seq", "512",
                 "--steps", "1", "--probe-every", "1", "--probe-iters",
                 str(FT_PROBE_ITERS), "--probe-no-reorth", "--device", DEV]
FT_SMALL = ("qwen2.5-3b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-1.2b",
            "whisper-large-v3", "llama-3.2-vision-11b")
# the smoke configs' steps in 18c, 19d and 20c (3 until phases 19 and
# 20 came in: the script's time budget)
FT_SMALL_STEPS = 2


def ft_live(launcher, arch: str):
    """The launcher with seeded random extra embeddings and the vlm's
    gates opened for a cross family, else nothing."""
    if arch == "whisper-large-v3":
        return live_frontend(launcher, FT_DRAW_SEED)
    if arch == "llama-3.2-vision-11b":
        return live_frontend(launcher, FT_DRAW_SEED, GATE_OPEN)
    return contextlib.nullcontext()


def ft_argv(arch: str, mesh_shape=None) -> list:
    argv = ["--arch", arch] + FT_ARGV
    if mesh_shape is None:
        return argv
    d, m = mesh_shape
    if m == 1:
        return argv + ["--data-parallel", str(d)]
    return argv + ["--mesh-model", str(m), "--mesh-data", str(d)]


def ft_lb_per_shard(arch: str, cut: dict, shards: int) -> float:
    """The load balance of the first batch of a run of ``arch`` (its
    seed-0 weights, the launcher's seed-0 stream) with each of
    ``shards`` data rows taking the means of its own block, averaged
    over the rows: the mesh-native data axis's rule, which the GSPMD
    step must not follow."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_iterator
    from repro_torch.models import get_model
    cfg = get_config(arch).replace(**cut)
    model = get_model(cfg)
    params = model.init(0, device=DEV)
    batch = next(lm_iterator(TT_BATCH, 512, cfg.vocab_size, seed=0,
                             device=DEV))
    b = TT_BATCH // shards
    with torch.no_grad():
        lbs = [float(model.loss(params, {k: v[i * b:(i + 1) * b]
                                         for k, v in batch.items()})[1]
                     .load_balance_loss) for i in range(shards)]
    del params
    return sum(lbs) / shards


def ft_rank(arch: str, cut: dict, mesh_shape: tuple, ref_path: str
            ) -> dict:
    """19-19b on one rank: ``arch`` with ``cut`` (``FT_CUTS``) through
    ``launch.train.run`` on ``mesh_shape`` (launch counts a step, the
    step split, state bytes, peak, the param gap to M = 1, the leaves
    whose data axis the reference puts on a stacked dim)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    watch = StepWatch(ops)
    with config_cut(train_launch, arch, **cut), \
            ft_live(train_launch, arch), watched_fit(train_launch, watch):
        out = train_launch.run(ft_argv(arch, mesh_shape),
                               log_fn=_tt_log(f"19 {arch}"))
    place, state = out["placement"], out["state"]
    res = {"history": out["history"], "launches": watch.launches,
           "split": tt_split(out, FT_STEPS),
           "state_bytes": tt_state_bytes(state),
           "peak": out["peak_memory_bytes"], "rank": out["rank"],
           "param_gap": tt_param_gap(state.params, place, ref_path),
           "stacked_picks": len(place.stacked_picks)}
    del out, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fp_rank(mesh_shape) -> dict:
    """19c on one rank (or, with ``mesh_shape`` None, here at M = 1):
    qwen2.5-3b cut to ``TT_LAYERS``, a per-tensor WA-LARS step and an
    ``FT_PROBE_ITERS``-iteration Lanczos probe through
    ``launch.train.run`` (the GSPMD
    path with ``mesh_shape``): λ_max, the launches around the probe and
    whether it left the state bitwise as it was."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import diagnostics as diag
    from repro_torch.core.base import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    ops.reset_launches()
    argv = list(FT_PROBE_ARGV)
    if mesh_shape is not None:
        argv += ["--mesh-model", str(mesh_shape[1]), "--mesh-data",
                 str(mesh_shape[0])]
    watch = ProbeWatch(diag.LanczosProbe, ops, tree_leaves)
    try:
        with depth_cut(train_launch, TT_ARCH, TT_LAYERS):
            out = train_launch.run(argv, log_fn=_tt_log("19c"))
    finally:
        watch.restore()
    res = {"calls": watch.calls, "rank": out["rank"],
           "lambda_max": [c["out"]["lambda_max"] for c in watch.calls],
           "collectives": {k: v["calls"] for k, v in
                           out["collectives"].items()}}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fs_rank() -> dict:
    """19d on one rank of a world of 4: every family's smoke config at
    (2, 2), the MoE's at (4, 1)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_lib
    meshes = {shape: mesh_lib.make_host_mesh(*shape)
              for shape in ((2, 2), (4, 1))}
    return {arch: tt_small_losses(arch, meshes[
        (4, 1) if get_smoke_config(arch).family == "moe" else (2, 2)],
        FT_SMALL_STEPS) for arch in FT_SMALL}


def ft_train(label: str, arch: str, cut: dict, shape: tuple,
             train_launch, get_config, tmp: str, per_step: dict) -> dict:
    """One arch of 19-19b: M = 1 here, then ``shape`` on the shared
    ranks, checked and printed (:func:`ft_report`); olmoe's load balance
    against M = 1 and the per-shard means'."""
    from repro_torch.core.base import path_name, tree_flatten_with_path
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(**cut)
    print(f"{label} {arch}: reduced: " + ", ".join(
        f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items())
        + f" (the script's time budget, and f32 where FT_CUTS says why; "
        f"width as published: {cfg.d_model} wide, {cfg.param_dtype})",
        flush=True)
    ref_path = os.path.join(tmp, f"{arch}.pt")
    with config_cut(train_launch, arch, **cut), ft_live(train_launch, arch):
        one = train_launch.run(ft_argv(arch), log_fn=lambda line: None)
    torch.save({path_name(p): t.detach().cpu() for p, t in
                tree_flatten_with_path(one["state"].params)}, ref_path)
    single = one["history"]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    ranks = on_ranks(ft_rank, shape[0] * shape[1],
                     args=(arch, cut, shape, ref_path), timeout=600)
    gaps = tt_report(label, shape, ranks, single,
                     tt_rules(cfg, shape, "fused"), None, per_step,
                     arch=arch, steps=FT_STEPS)
    r = {"gaps": gaps, "split": ranks[0]["split"], "launches": {
        k: sum(x.get(k, 0) for x in ranks[0]["launches"])
        for k in SEG_LARS}}
    if cfg.family == "moe":
        lb1 = single[0]["load_balance"]
        lbs = [h["load_balance"] for h in ranks[0]["history"]]
        gap = max(abs(a["load_balance"] - b["load_balance"])
                  / abs(b["load_balance"])
                  for a, b in zip(ranks[0]["history"], single))
        shard = ft_lb_per_shard(arch, cut, shape[0])
        shard_gap = abs(shard - lb1) / abs(lb1)
        if not gap <= FT_LB_BOUND < shard_gap:
            raise AssertionError(f"{label}: load balance gap {gap:.3e}, "
                                 f"per-shard means' {shard_gap:.3e}, bound "
                                 f"{FT_LB_BOUND}")
        print(f"{label} {arch}: load balance per step {lbs} at D="
              f"{shape[0]} (the global batch's means), gap to D=1 "
              f"{gap:.3e} <= {FT_LB_BOUND}; per-shard means on step 0's "
              f"weights and batch {shard:.6f} against {lb1:.6f}, gap "
              f"{shard_gap:.3e}", flush=True)
        r["lb_gap"], r["lb_shard_gap"] = gap, shard_gap
    r["seconds"] = time.perf_counter() - t0
    print(f"{label} {arch}: {r['seconds']:.1f} s (M=1 here, then the "
          f"shared ranks)", flush=True)
    return r


def phase_families_training(train_launch, get_config) -> dict:
    """19-19d: the other families trained over the GSPMD mesh and the
    probe over it (see the module docstring)."""
    seg = {"seg_norm_lars": 1, "seg_apply_lars": 1}
    res: dict = {"train": {}, "probe": {}, "seconds": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        for label, (archs, shape) in FT_MESHES.items():
            for arch in archs:
                res["train"][(label, arch)] = ft_train(
                    label, arch, FT_CUTS[arch], shape, train_launch,
                    get_config, tmp, seg)
        # 19c: the probe over the GSPMD mesh
        t0 = time.perf_counter()
        one = fp_rank(None)
        lam1 = one["lambda_max"]
        pt = one["calls"][0]["launches_before"]
        check_one_pass("19c M=1", pt)
        for shape in ((1, 2), (2, 2)):
            ranks = on_ranks(fp_rank, shape[0] * shape[1], args=(shape,),
                             timeout=600)
            for r in ranks:
                check_probe_calls(f"19c {shape}", r["calls"], None)
                if r["lambda_max"] != ranks[0]["lambda_max"]:
                    raise AssertionError(f"19c {shape}: ranks' lambda_max "
                                         f"differ")
                launched = r["calls"][0]["launches_before"]
                if launched != pt:
                    raise AssertionError(f"19c {shape}: launches before "
                                         f"the probe {launched}, M=1 {pt}")
            got = ranks[0]["lambda_max"]
            gap = max(abs(a - b) / abs(b) for a, b in zip(got, lam1))
            if not gap <= FT_PROBE_BOUND:
                raise AssertionError(f"19c {shape}: lambda_max {got} against "
                                     f"M=1 {lam1}, gap {gap:.3e} over "
                                     f"{FT_PROBE_BOUND:.3e}")
            secs = [c["seconds"] for c in ranks[0]["calls"]]
            print(f"19c {TT_ARCH} ({TT_LAYERS} layers) probe on {shape}: "
                  f"lambda_max {got} against M=1 {lam1} (gap {gap:.3e} <= "
                  f"{FT_PROBE_BOUND:.3e}); no kernel launched inside it "
                  f"(per-tensor launches before it {pt}, as M=1's step), "
                  f"state bitwise unchanged; probe {secs} s on rank 0 (M=1 "
                  f"{[c['seconds'] for c in one['calls']]} s); lanczos "
                  f"inner products "
                  f"{ranks[0]['collectives'].get('lanczos_dot', 0)} "
                  f"collectives; {smi_line()}", flush=True)
            res["probe"][shape] = {"gap": gap, "lambda_max": got,
                                   "seconds": secs}
        res["probe_launches"] = pt
        res["seconds"]["19c"] = time.perf_counter() - t0
        print(f"19c: {res['seconds']['19c']:.1f} s", flush=True)
        # 19d: every family's smoke config at (2, 2)
        t0 = time.perf_counter()
        cpu = {arch: tt_small_losses(arch, steps=FT_SMALL_STEPS)
               for arch in FT_SMALL}
        got = on_ranks(fs_rank, 4, timeout=600)[0]
        for arch in FT_SMALL:
            np.testing.assert_allclose(got[arch], cpu[arch], rtol=1e-5,
                                       err_msg=f"19d {arch}")
        print(f"19d smoke configs f32 at (2, 2) (olmoe at (4, 1)) on the "
              f"card: losses within 1e-5 of the CPU's single-rank run "
              f"({ {a: [round(x, 6) for x in v] for a, v in cpu.items()} })",
              flush=True)
        res["seconds"]["19d"] = time.perf_counter() - t0
        print(f"19d: {res['seconds']['19d']:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -------------------- 20-20c: the MoE family over the model axis (experts)
EP_ARCH = "qwen3-moe-30b-a3b"
# 20's depth: 6 of 48 layers (the script's time budget: each layer adds
# three host-staged collectives a decode step at 1.8-4.5 ms each, PR 21)
EP_LAYERS = 6
EP_MESH = (1, 2)               # 64 of 128 experts, 16 / 2 heads a rank
EP_OLMOE = "olmoe-1b-7b"
EP_OLMOE_MESH = (1, 4)         # 16 of 64 experts, 4 / 4 heads a rank
EP_OLMOE_LAYERS = 4            # of 16: the script's time budget
EP_SLOTS, EP_MAX_LEN = 4, 1024
EP_PROMPTS, EP_NEW = (128, 512), (4, 8)
EP_CONTEXT_GIB = 0.5           # activations, logits, the CUDA allocator
# 20b: olmoe trained at full width, 1 of 16 layers (the script's time
# budget: the experts' fsdp gathers and the column reduce are
# host-staged), fused TVLARS f32 then one per-tensor WA-LARS step
EP_TRAIN_CUT = dict(num_layers=1)
EP_TRAIN_MESH = (2, 2)
EP_PT_ARGV = ["--optimizer", "wa-lars", "--use-kernel", "per_tensor",
              "--precision", "f32", "--global-batch", str(TT_BATCH),
              "--seq", "512", "--steps", "1", "--device", DEV]
EP_SMALL = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
EP_SMALL_MESHES = ((2, 2), (1, 4))
EP_PROBE_ARGV = ["--arch", EP_OLMOE, "--smoke", "--optimizer", "wa-lars",
                 "--use-kernel", "per_tensor", "--precision", "f32",
                 "--global-batch", str(TT_BATCH), "--seq", "512",
                 "--steps", "1", "--probe-every", "1", "--probe-iters",
                 "4", "--probe-no-reorth", "--device", DEV]


def moe_weight_bytes(params) -> int:
    """The bytes of the MoE leaves (router and experts) of a tree: a
    decode step reads every one of them (every expert holds a slot)."""
    return sum(t.numel() * t.element_size() for layer in params["layers"]
               for t in layer["moe"].values())


def ep_serve_rank(arch: str, layers: int, shape: tuple, requests,
                  tokens1) -> dict:
    """20 / 20a on one rank: this rank's blocks of ``arch``'s seed-0
    draw cut to ``layers`` (its experts, heads and vocabulary), the
    engine on the requests, the requests teacher-forced along M = 1's
    tokens and the decode step's split."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.obs import Tracer, phase_summary
    mesh = mesh_lib.make_host_mesh(*shape)
    model = get_model(get_config(arch).replace(num_layers=layers))
    t0 = time.perf_counter()
    params = model.init(0, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layer = params["layers"][0]
    shapes = {"router": tuple(layer["moe"]["router"].shape),
              "wi": tuple(layer["moe"]["wi"].shape),
              "wq": tuple(layer["attn"]["wq"].shape),
              "wk": tuple(layer["attn"]["wk"].shape)}
    expert_bytes = moe_weight_bytes(params)
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=EP_SLOTS, max_len=EP_MAX_LEN, page_size=16),
        device=mesh.device, tracer=tracer, mesh=mesh)
    mesh.collectives.clear()
    results, stats, elapsed, launches = serve(eng, ops, requests)
    engine_coll = {k: dict(v) for k, v in mesh.collectives.items()}
    spans = phase_summary(tracer.events())
    pool = tuple(eng._kv.cache[0]["k"].shape)
    tokens2 = [list(r.tokens) for r in results]
    del eng, results
    tf = teacher_forced(L, model, params, requests[0], tokens1, mesh,
                        EP_MAX_LEN)
    split = decode_split(model, params, mesh, ops, L, EP_SLOTS, EP_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    del params
    first = mesh.rank == 0
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "backend": mesh.backend, "init_s": init_s, "shapes": shapes,
            "expert_bytes": expert_bytes, "pool": pool, "tokens": tokens2,
            "stats": stats, "elapsed": elapsed, "launches": launches,
            "spans": spans, "collectives": engine_coll, "split": split,
            "peak": peak, "equal": mesh_lib.all_equal(mesh, tokens2),
            "tf": [bits(t) for t in tf] if first else None}


def ep_serving(label: str, arch: str, layers: int, shape: tuple, seed: int,
               tad, ops, serving, get_config, get_model) -> dict:
    """20 / 20a: the decode kernel at a rank's shape against its plain
    version, M = 1 here on the same seed-0 weights (the engine's tokens
    and the teacher-forced logits), then the ranks (``ep_serve_rank``):
    launches, tokens, logit gaps, the step split and the rank's expert
    read."""
    from repro_torch.models import layers as L
    full = get_config(arch)
    cfg = full.replace(num_layers=layers)
    m = shape[1]
    if layers != full.num_layers:
        print(f"{label} {arch}: reduced: num_layers {full.num_layers} -> "
              f"{layers} (the script's time budget; width as published)",
              flush=True)
    weights = local_weight_bytes(cfg, shape)
    pool = kv_pool_bytes(cfg, EP_SLOTS, EP_MAX_LEN)
    kv_local = cfg.num_kv_heads // m
    pred = (weights + 2 * pool / m) / GIB + EP_CONTEXT_GIB
    print(f"{label} {arch}: full width ({cfg.num_layers} layers, bf16) on a "
          f"{shape} mesh, {m} gloo ranks on one card: "
          f"{cfg.num_experts // m} of {cfg.num_experts} experts (top-"
          f"{cfg.experts_per_token}), {cfg.num_heads // m} of "
          f"{cfg.num_heads} heads, {kv_local} of {cfg.num_kv_heads} KV "
          f"heads, {cfg.vocab_size // m} of {cfg.vocab_size} words a rank; "
          f"predicted peak a rank {pred:.2f} GiB (its blocks "
          f"{weights / GIB:.3f} + pool {pool / GIB:.3f} / {m} + prefill "
          f"dump {pool / GIB:.3f} / {m} + {EP_CONTEXT_GIB} context)",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    row = kernel_row(tad, ops, gen, "global", EP_MAX_LEN, None,
                     torch.bfloat16, EP_SLOTS, cfg.num_heads // m,
                     kv_local, cfg.head_dim_, [64, 200, 513, 1023])
    model = get_model(cfg)
    requests = requests_of(cfg.vocab_size, seed, 4, EP_PROMPTS, EP_NEW)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    read1 = moe_weight_bytes(params)
    results, stats1, elapsed1, _ = serve(engine(
        serving, model, params, None, EP_SLOTS, EP_MAX_LEN), ops, requests)
    tokens1 = [list(r.tokens) for r in results]
    tf1 = teacher_forced(L, model, params, requests[0], tokens1,
                         max_len=EP_MAX_LEN)
    del params, results
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = on_ranks(ep_serve_rank, m, args=(arch, layers, shape, requests,
                                             tokens1), timeout=600)
    ranks_s = time.perf_counter() - t0
    tol = tad.decode_parity_tolerance(torch.bfloat16)
    for r in ranks:
        if not r["equal"] or r["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"{label}: the ranks served different "
                                 f"tokens")
        want = layers * r["stats"]["decode_steps"]
        if r["launches"] != want or r["split"]["launches"] != layers:
            raise AssertionError(f"{label} rank {r['rank']}: "
                                 f"{r['launches']} decode launches for "
                                 f"{r['stats']['decode_steps']} steps "
                                 f"(expected {want}); split "
                                 f"{r['split']['launches']} a step")
        if r["shapes"]["wi"][0] != cfg.num_experts // m \
                or r["shapes"]["router"][1] != cfg.num_experts // m:
            raise AssertionError(f"{label}: expert blocks {r['shapes']}")
    tf2 = [unbits(a) for a in ranks[0]["tf"]]
    gaps = []
    for a, b in zip(tf2, tf1):
        d = (a.float() - b.float()).abs()
        gaps.append((d.max().item(), d.mean().item()))
    worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    if not (worst[0] <= TP_LOGIT_BOUND and worst[1] <= TP_LOGIT_MEAN_BOUND):
        raise AssertionError(f"{label}: logit gaps to M=1 (max, mean) "
                             f"{gaps}, bounds {TP_LOGIT_BOUND}, "
                             f"{TP_LOGIT_MEAN_BOUND}")
    ties = near_ties(label, tokens1, ranks[0]["tokens"], tf1, tf2, tol)
    r0 = ranks[0]
    sp = r0["split"]
    step_ms = decode_step_ms(r0["spans"], r0["stats"]["decode_steps"])
    read_ms = r0["expert_bytes"] / HBM_BYTES_PER_S * 1e3
    generated = r0["stats"]["tokens_generated"]
    for r in ranks:
        print(f"{label} rank {r['rank']} {r['coords']} ({r['backend']}): "
              f"blocks {r['shapes']}, KV pool {r['pool']}; init "
              f"{r['init_s']:.1f} s; serving peak {r['peak'] / GIB:.2f} GiB "
              f"(predicted {pred:.2f}); {r['launches']} decode launches "
              f"over {r['stats']['decode_steps']} steps "
              f"({r['launches'] // r['stats']['decode_steps']} a step)",
              flush=True)
    coll = {k: (v["calls"], round(v["seconds"], 3))
            for k, v in r0["collectives"].items()}
    print(f"{label}: {len(r0['tokens'])} requests (prompts "
          f"{[len(p) for p in requests[0]]}), {generated} tokens in "
          f"{r0['elapsed']:.3f} s = {generated / r0['elapsed']:.2f} tok/s "
          f"(M=1 {stats1['tokens_generated'] / elapsed1:.2f}); decode step "
          f"{step_ms:.3f} ms (decode + sample spans); engine collectives "
          f"{coll} (calls, s); tokens equal on {m} ranks; to M=1: "
          f"{sum(a == b for a, b in zip(tokens1, r0['tokens']))} of "
          f"{len(tokens1)} requests equal, first differences (request, "
          f"token, gap in M=1's logits, in M={m}'s) {ties}; |logit gap| "
          f"along M=1's tokens (max, mean) a request "
          f"{[(round(a, 4), round(b, 5)) for a, b in gaps]} (bounds "
          f"{TP_LOGIT_BOUND}, {TP_LOGIT_MEAN_BOUND}); {ranks_s:.1f} s on "
          f"the shared ranks; {smi_line()}", flush=True)
    others = "".join(f" + {k} {v:.3f}" for k, v in sp["ms"].items()
                     if k not in ("model_sum", "model_gather"))
    print(f"{label} decode step split (rank 0, {EP_SLOTS} slots, "
          f"{TP_SPLIT_STEPS} steps, host clock): {sp['step_ms']:.3f} ms = "
          f"compute {sp['compute_ms']:.3f} + model_sum_ {sp['sum_ms']:.3f} "
          f"({sp['sums']} calls: attention's wo and the experts' output a "
          f"layer, the embedding) + gathers {sp['gather_ms']:.3f} "
          f"({sp['gathers']} calls: the router logits a layer, the "
          f"logits){others}; "
          f"the rank's expert weights {r0['expert_bytes']} B read a step: "
          f"{read_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s (M=1 "
          f"{read1 / HBM_BYTES_PER_S * 1e3:.3f} ms)", flush=True)
    return {"row": row, "launches": r0["launches"], "gaps": gaps,
            "ties": ties, "split": sp, "step_ms": step_ms,
            "read_ms": read_ms, "peak_gib": [r["peak"] / GIB for r in ranks],
            "predicted_gib": pred, "layers": layers}


def ep_train_rank(ref_path: str) -> dict:
    """20b on one rank of the (2, 2) world: olmoe cut to
    ``EP_TRAIN_CUT`` through ``launch.train.run --mesh-model 2
    --mesh-data 2`` with fused TVLARS (launches, split, state bytes,
    peak, the param gap to M = 1, the segmented kernels on this rank's
    flat buffers), then one per-tensor WA-LARS step (its launches,
    state bytes and the per-tensor kernels on this rank's blocks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import flatten
    from repro_torch.kernels import lars_update as lu
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as sref
    from repro_torch.kernels import segmented_update as su
    from repro_torch.launch import train as train_launch
    mesh_argv = ["--mesh-model", str(EP_TRAIN_MESH[1]), "--mesh-data",
                 str(EP_TRAIN_MESH[0])]
    res = {}
    for label, argv in (("20b", ft_argv(EP_OLMOE) + mesh_argv),
                        ("20b-pt", ["--arch", EP_OLMOE] + EP_PT_ARGV
                         + mesh_argv)):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        watch = StepWatch(ops)
        with config_cut(train_launch, EP_OLMOE, **EP_TRAIN_CUT), \
                watched_fit(train_launch, watch):
            out = train_launch.run(argv, log_fn=_tt_log(label))
        model, place, state = out["model"], out["placement"], out["state"]
        steps = len(out["history"])
        r = {"history": out["history"], "launches": watch.launches,
             "split": tt_split(out, steps),
             "state_bytes": tt_state_bytes(state),
             "peak": out["peak_memory_bytes"], "rank": out["rank"],
             "experts": state.params["layers"][0]["moe"]["wi"].shape}
        if label == "20b":
            r["param_gap"] = tt_param_gap(state.params, place, ref_path)
            r["seg"] = tt_seg_kernels(su, sref, flatten, model,
                                      state.params, place)
        else:
            names = tt_rules(model.cfg, EP_TRAIN_MESH, "per_tensor")[
                "kernel_segments"]
            r["kernel_segments"] = len(names)
            r["lars"] = tt_lars_kernels(lu, sref, model.cfg, state.params,
                                        names, out["mesh"])
        res[label] = r
        del out, state
        gc.collect()
        torch.cuda.empty_cache()
    return res


def ep_small_rank() -> dict:
    """20c on one rank of a world of 4: both MoE smoke configs' losses
    at (2, 2) and (1, 4)."""
    from repro_torch.launch import mesh as mesh_lib
    meshes = {shape: mesh_lib.make_host_mesh(*shape)
              for shape in EP_SMALL_MESHES}
    return {(shape, arch): tt_small_losses(arch, mesh, FT_SMALL_STEPS)
            for shape, mesh in meshes.items() for arch in EP_SMALL}


def ep_probe_rank(mesh_shape) -> dict:
    """20c's probe on one rank (or, with ``mesh_shape`` None, here at M
    = 1): olmoe's smoke config in f32, a per-tensor WA-LARS step and a
    4-iteration Lanczos probe through ``launch.train.run``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import diagnostics as diag
    from repro_torch.core.base import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    ops.reset_launches()
    argv = list(EP_PROBE_ARGV)
    if mesh_shape is not None:
        argv += ["--mesh-model", str(mesh_shape[1]), "--mesh-data",
                 str(mesh_shape[0])]
    watch = ProbeWatch(diag.LanczosProbe, ops, tree_leaves)
    try:
        out = train_launch.run(argv, log_fn=lambda line: None)
    finally:
        watch.restore()
    return {"calls": watch.calls, "rank": out["rank"],
            "lambda_max": [c["out"]["lambda_max"] for c in watch.calls]}


def phase_experts(tad, ops, serving, train_launch, get_config,
                  get_model) -> dict:
    """20-20c: the MoE family over the model axis (see the module
    docstring)."""
    out: dict = {"seconds": {}}
    t0 = time.perf_counter()
    out["20"] = ep_serving("20", EP_ARCH, EP_LAYERS, EP_MESH, 20, tad, ops,
                           serving, get_config, get_model)
    out["seconds"]["20"] = time.perf_counter() - t0
    print(f"20: {out['seconds']['20']:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["20a"] = ep_serving("20a", EP_OLMOE,
                            EP_OLMOE_LAYERS, EP_OLMOE_MESH,
                            21, tad, ops, serving, get_config, get_model)
    out["seconds"]["20a"] = time.perf_counter() - t0
    print(f"20a: {out['seconds']['20a']:.1f} s", flush=True)

    # 20b: olmoe trained over (2, 2), after M = 1 on the same weights
    from repro_torch.core.base import path_name, tree_flatten_with_path
    t0 = time.perf_counter()
    full = get_config(EP_OLMOE)
    cfg = full.replace(**EP_TRAIN_CUT)
    shape = EP_TRAIN_MESH
    print(f"20b {EP_OLMOE}: reduced: " + ", ".join(
        f"{k} {getattr(full, k)} -> {v}" for k, v in EP_TRAIN_CUT.items())
        + f" (the script's time budget; width as published: {cfg.d_model} "
        f"wide, {cfg.num_experts} experts, {cfg.param_dtype})", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    try:
        ref_path = os.path.join(tmp, "m1.pt")
        with config_cut(train_launch, EP_OLMOE, **EP_TRAIN_CUT):
            one = train_launch.run(ft_argv(EP_OLMOE), log_fn=lambda line: None)
        torch.save({path_name(p): t.detach().cpu() for p, t in
                    tree_flatten_with_path(one["state"].params)}, ref_path)
        single = one["history"]
        del one
        gc.collect()
        torch.cuda.empty_cache()
        ranks = on_ranks(ep_train_rank, shape[0] * shape[1],
                         args=(ref_path,), timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seg = {"seg_norm_lars": 1, "seg_apply_lars": 1}
    fused = [r["20b"] for r in ranks]
    for r in fused:
        if r["experts"][0] != cfg.num_experts // shape[1]:
            raise AssertionError(f"20b: rank {r['rank']} holds experts "
                                 f"{r['experts']}")
    gaps = tt_report("20b", shape, fused, single,
                     tt_rules(cfg, shape, "fused"), None, seg,
                     arch=EP_OLMOE, steps=FT_STEPS)
    lb_gap = max(abs(a["load_balance"] - b["load_balance"])
                 / abs(b["load_balance"])
                 for a, b in zip(fused[0]["history"], single))
    if not lb_gap <= FT_LB_BOUND:
        raise AssertionError(f"20b: load balance gap {lb_gap:.3e} over "
                             f"{FT_LB_BOUND}")
    pt_rules = tt_rules(cfg, shape, "per_tensor")
    pt = [r["20b-pt"] for r in ranks]
    tt_report("20b per-tensor", shape, pt, None, pt_rules, None,
              {"lars_norm2": 1, "lars_apply": 1}, arch=EP_OLMOE, steps=1)
    s0 = fused[0]["seg"]
    l0 = pt[0]["lars"]
    print(f"20b {EP_OLMOE}: {cfg.num_experts // shape[1]} of "
          f"{cfg.num_experts} experts a rank (fsdp over the data axis); "
          f"load balance per step "
          f"{[h['load_balance'] for h in fused[0]['history']]} against M=1 "
          f"{[h['load_balance'] for h in single]}, gap {lb_gap:.3e} <= "
          f"{FT_LB_BOUND}; segmented kernels on rank 0's flat buffers "
          f"({s0['rows']} rows, {s0['segments']} segments): norm relative "
          f"error {s0['norm_err']:.3e}, apply bitwise; card ms "
          f"{s0['times']}; per-tensor kernels on rank 0's blocks of "
          f"{l0['segment']} ({l0['elements']} elements): card ms "
          f"{l0['times']}; {smi_line()}", flush=True)
    out["20b"] = {"gaps": gaps, "lb_gap": lb_gap, "split": fused[0]["split"],
                  "launches": {k: sum(x.get(k, 0) for x in fused[0][
                      "launches"]) for k in SEG_LARS},
                  "launches_pt": {k: sum(x.get(k, 0) for x in pt[0][
                      "launches"]) for k in ("lars_norm2", "lars_apply")},
                  "seg": s0, "lars": l0}
    out["seconds"]["20b"] = time.perf_counter() - t0
    print(f"20b: {out['seconds']['20b']:.1f} s", flush=True)

    # 20c: the smoke configs at (2, 2) and (1, 4), and the probe
    t0 = time.perf_counter()
    cpu = {arch: tt_small_losses(arch, steps=FT_SMALL_STEPS)
           for arch in EP_SMALL}
    got = on_ranks(ep_small_rank, 4, timeout=600)[0]
    for (mesh_shape, arch), losses in got.items():
        np.testing.assert_allclose(losses, cpu[arch], rtol=1e-5,
                                   err_msg=f"20c {arch} {mesh_shape}")
    shown = {a: [round(x, 6) for x in v] for a, v in cpu.items()}
    print(f"20c MoE smoke configs f32 at {EP_SMALL_MESHES} on the card "
          f"(experts 2 and 1 a rank): losses within 1e-5 of the CPU's "
          f"single-rank run ({shown})", flush=True)
    one = ep_probe_rank(None)
    ranks = on_ranks(ep_probe_rank, 4, args=((2, 2),), timeout=600)
    pt_before = one["calls"][0]["launches_before"]
    check_one_pass("20c M=1", pt_before)
    for r in ranks:
        check_probe_calls("20c (2, 2)", r["calls"], None)
        if r["lambda_max"] != ranks[0]["lambda_max"] \
                or r["calls"][0]["launches_before"] != pt_before:
            before = r["calls"][0]["launches_before"]
            raise AssertionError(f"20c: rank {r['rank']} lambda_max "
                                 f"{r['lambda_max']}, launches before "
                                 f"the probe {before} (M=1 {pt_before})")
    lam1, lam = one["lambda_max"], ranks[0]["lambda_max"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lam, lam1))
    if not gap <= FT_PROBE_BOUND:
        raise AssertionError(f"20c: lambda_max {lam} against M=1 {lam1}, "
                             f"gap {gap:.3e} over {FT_PROBE_BOUND:.3e}")
    print(f"20c {EP_OLMOE} smoke f32 probe on (2, 2): lambda_max {lam} "
          f"against M=1 {lam1} (gap {gap:.3e} <= {FT_PROBE_BOUND:.3e}); no "
          f"kernel launched inside it (per-tensor launches before it "
          f"{pt_before}, as M=1's step), state bitwise unchanged; probe "
          f"{[round(c['seconds'], 3) for c in ranks[0]['calls']]} s on rank "
          f"0 (M=1 {[round(c['seconds'], 3) for c in one['calls']]} s)",
          flush=True)
    out["20c"] = {"probe_gap": gap, "probe_launches": pt_before}
    out["seconds"]["20c"] = time.perf_counter() - t0
    print(f"20c: {out['seconds']['20c']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out

# ------------------------------------- 21-21c: the head-dim split (Dh)
DH_WHISPER = "whisper-large-v3"
DH_QWEN = "qwen2.5-3b"
# 21: (label, slots, heads, KV heads, Dh, M, T): whisper's rank shape at
# M = 8 (Dh 64 in blocks of 8; its decoder's 448 positions), qwen2.5-3b's
# at M = 4 in case B (16 heads gathered over 2 KV heads, Dh 128 in
# blocks of 32, 21b's pool of 1021 keys)
DH_KERNEL = [("whisper-large-v3 M=8", 4, 20, 20, 64, 8, 448),
             ("qwen2.5-3b M=4", 4, 16, 2, 128, 4, 1021)]
DH_MODES = ("attention_decode_scores", "attention_decode_apply")


def dh_positions(kind: str, t: int) -> list:
    """21's positions: global rows early, mid and at T - 1; ring rows in
    the first lap and two laps on."""
    if kind == "global":
        return [0, 37, t // 2, t - 1]
    return [5, t + 7, 2 * t + 11, 3 * t - 1]


def sum_bound(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, H, T]: twice the f32 rounding bound of a dot product of Dh
    terms summed in any order (Dh * 2^-24 * Σ|q_i k_i|): two summation
    orders of the same scores differ by at most this."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    qa = q.float().abs().reshape(b, hkv, h // hkv, dh)
    mag = torch.einsum("bkgd,btkd->bkgt", qa, k.float().abs())
    return 2 * dh * 2.0 ** -24 * mag.reshape(b, h, -1)


def dh_row(tad, ops, gen, label, slots, heads, kv_heads, dh, m, t, kind,
           dtype) -> dict:
    """21: the scores and apply modes against their plain versions on
    the ``m`` blocks of the head dim of one decode step (every rank's
    block in turn, here): each block's scores within f32 rounding of
    plain, its appended block bitwise plain's and only its slot's row
    changed, nothing written past each row's last needed key; the
    blocks' scores summed in rank order within f32 rounding of the
    one-block launch; each block's apply within the parity bound of
    plain, and the gathered outputs within it of
    ``attention_decode_ref`` on the whole cache. Then rank 0's launches
    timed on the card, eagerly and in their plain versions beside their
    bounds, and SDPA over the whole cache. Returns the shape's row."""
    dev = torch.device("cuda")
    tol = tad.decode_parity_tolerance(dtype)
    dl = dh // m
    window = None if kind == "global" else t
    dname = str(dtype).split(".")[-1]
    positions = dh_positions(kind, t)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q = randn(slots, 1, heads, dh)
    nk, nv = randn(slots, 1, kv_heads, dh), randn(slots, 1, kv_heads, dh)
    kc, vc = randn(slots, t, kv_heads, dh), randn(slots, t, kv_heads, dh)
    whole_k, whole_v = kc.clone(), vc.clone()
    whole = tad.attention_decode_ref(q, nk, nv, whole_k, whole_v, pos,
                                     window=window)
    one = ops.attention_decode_scores(q, nk, nv, kc.clone(), vc.clone(), pos,
                                      window=window)
    last = tad.last_keys(pos.long(), t, window)
    past = torch.arange(t, device=dev)[None, :] > last[:, None]   # [B,T]
    write = tad._slots(pos.long(), t, window)[1]
    rows = torch.arange(slots, device=dev)
    blocks, summed, s_err = [], None, 0.0
    for r in range(m):
        blk = slice(r * dl, (r + 1) * dl)
        qb, nkb, nvb = (x[..., blk].contiguous() for x in (q, nk, nv))
        kb, vb = kc[..., blk].contiguous(), vc[..., blk].contiguous()
        kp, vp = kb.clone(), vb.clone()
        before = kb.clone()
        s_k = ops.attention_decode_scores(qb, nkb, nvb, kb, vb, pos,
                                          window=window)
        s_p = tad.attention_decode_scores_ref(qb, nkb, nvb, kp, vp, pos,
                                              window=window)
        torch.cuda.synchronize()
        where = f"21 {label} {kind} {dname} block {r}"
        bound = sum_bound(qb, kp)
        gap = (s_k - s_p).abs()
        if not bool((gap <= bound).all()):
            raise AssertionError(f"{where}: scores off plain by "
                                 f"{gap.max().item():.3e} (bound "
                                 f"{bound.max().item():.3e})")
        s_err = max(s_err, gap.max().item())
        if s_k.masked_select(past[:, None, :]).abs().max().item() \
                if past.any() else 0.0:
            raise AssertionError(f"{where}: a score past a row's last "
                                 f"needed key is not 0")
        if not (torch.equal(kb, kp) and torch.equal(vb, vp)):
            raise AssertionError(f"{where}: appended blocks differ from "
                                 f"plain")
        changed = (kb != before).any(-1).any(-1)                  # [B,T]
        want = torch.zeros_like(changed)
        want[rows, write] = True
        if bool((changed & ~want).any()) \
                or not torch.equal(kb[rows, write], nkb[:, 0]):
            raise AssertionError(f"{where}: the append touched another "
                                 f"row than the slot's")
        summed = s_k if summed is None else summed + s_k
        blocks.append((qb, nkb, nvb, kb, vb))
    gap = (summed - one).abs()
    bound = sum_bound(q, whole_k)
    if not bool((gap <= bound).all()):
        raise AssertionError(f"21 {label} {kind} {dname}: the {m} blocks' "
                             f"scores summed in rank order off the "
                             f"one-block launch by {gap.max().item():.3e} "
                             f"(f32 rounding bound {bound.max().item():.3e})")
    sum_err = gap.max().item()
    outs, a_err = [], 0.0
    for r, (_, _, _, kb, vb) in enumerate(blocks):
        o_k = ops.attention_decode_apply(summed, vb, pos, head_dim=dh,
                                         dtype=dtype, window=window)
        o_p = tad.attention_decode_apply_ref(summed, vb, pos, head_dim=dh,
                                             dtype=dtype, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(o_k.float(), o_p.float(), **tol)
        a_err = max(a_err, (o_k.float() - o_p.float()).abs().max().item())
        outs.append(o_k)
    gathered = torch.cat(outs, dim=-1)
    torch.testing.assert_close(gathered.float(), whole.float(), **tol)
    err = (gathered.float() - whole.float()).abs().max().item()

    # rank 0's launches timed, at these positions
    qb, nkb, nvb, kb, vb = blocks[0]
    csize, qsize = kc.element_size(), q.element_size()
    needed = int((last + 1).sum().item())             # (row, key) pairs
    ok = tad._valid(pos.long(), 0, t, t, window)
    valid = int(ok.sum().item())
    s_bytes = (needed * kv_heads * dl * csize + qb.numel() * qsize
               + 4 * nkb.numel() * csize + 4 * slots * heads * t
               + 4 * slots)
    s_ops = 2 * needed * heads * dl
    a_bytes = (4 * needed * heads + valid * kv_heads * dl * csize
               + slots * heads * dl * qsize + 4 * slots)
    a_ops = 2 * valid * heads * dl + 4 * needed * heads

    def bound_of(nbytes, nops):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / F32_FLOP_PER_S * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    def scores():
        return ops.attention_decode_scores(qb, nkb, nvb, kb, vb, pos,
                                           window=window)

    def apply():
        return ops.attention_decode_apply(summed, vb, pos, head_dim=dh,
                                          dtype=dtype, window=window)

    mask = ok[:, None, None, :]
    qs, ks, vs = (x.transpose(1, 2) for x in (q, whole_k, whole_v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)

    timed = {}
    for name, fn, plain, (nbytes, nops) in (
            ("attention_decode_scores", scores,
             lambda: tad.attention_decode_scores_ref(
                 qb, nkb, nvb, kb, vb, pos, window=window),
             (s_bytes, s_ops)),
            ("attention_decode_apply", apply,
             lambda: tad.attention_decode_apply_ref(
                 summed, vb, pos, head_dim=dh, dtype=dtype, window=window),
             (a_bytes, a_ops))):
        b_ms, by = bound_of(nbytes, nops)
        timed[name] = {"ms": device_ms(fn), "eager_ms": time_ms(fn, 50),
                       "plain_ms": time_ms(plain, 10), "bound_ms": b_ms,
                       "bound_by": by, "bytes": nbytes, "ops": nops}
    library = device_ms(sdpa)
    row = {"shape": f"{label} {kind} T={t} {dname} B={slots} H={heads} "
                    f"Hkv={kv_heads} Dh={dh} in {m} blocks of {dl}",
           "kind": kind, "dtype": dname,
           "modes": timed, "library_ms": library,
           "max_abs_err": max(err, a_err), "scores_err": s_err,
           "apply_err": max(err, a_err), "sum_err": sum_err}
    print(f"21 {row['shape']} positions {positions}: each block's scores "
          f"within f32 rounding of plain (max|err| {s_err:.3e}), 0 past "
          f"the last needed key, its append bitwise plain's and only in "
          f"the slot's row; the {m} blocks summed in rank order within "
          f"{sum_err:.3e} of the one-block launch (f32 rounding bound); "
          f"apply within rtol=atol={tol['rtol']:.2e} of plain (max|err| "
          f"{a_err:.3e}), the gathered output within it of the whole "
          f"cache's decode (max|err| {err:.3e}). Card ms (CUDA graph) / "
          f"eager / plain eager / bound: " + "; ".join(
              f"{n.split('_')[-1]} {v['ms']:.4f} / {v['eager_ms']:.4f} / "
              f"{v['plain_ms']:.4f} / {v['bound_ms']:.5f} ({v['bound_by']}, "
              f"{v['bytes']} B; {v['bound_ms'] / v['ms']:.1%})"
              for n, v in timed.items())
          + f"; SDPA over the whole cache {library:.4f}", flush=True)
    return row


def phase_dh_kernels(tad, ops) -> dict:
    """21: both modes at both rank shapes, bf16 and f32, global and a
    ring past two laps."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for label, slots, heads, kv, dh, m, t in DH_KERNEL:
        for dtype in (torch.bfloat16, torch.float32):
            for kind in ("global", "ring"):
                rows.append(dh_row(tad, ops, gen, label, slots, heads, kv,
                                   dh, m, t, kind, dtype))
    return {"rows": rows}


# 21a: whisper-large-v3 at full width on a (1, 8) mesh of eight gloo
# ranks: its 20 heads stay whole (8 divides neither them nor its 1500
# cross frames), d_ff 640 of 5120 a rank
DH_MESH = (1, 8)
# of 32 decoder and 32 encoder layers: the script's time budget (8 in
# the phase's first run on an NVIDIA H100 80GB HBM3 at 700 W: 73.9 s, a
# decode call 0.85-0.93 s, 24-32 collectives at 25-35 ms each among
# eight gloo ranks)
DH_LAYERS = 2
DH_GEN = (4, 8, 8)            # prompts, prompt length, new tokens
# generate's cache length: run 1's 16 divides 8 (the self caches over T,
# the decode kernel's partial mode), run 2's 17 does not (over Dh, its
# scores and apply modes); the cross K/V over Dh in both
DH_LENGTHS = {"t": 16, "dh": 17}
DH_DRAW_SEED = 21
# 21b: qwen2.5-3b at full width on (1, 4), case B: 4 of 16 heads a rank
# (gathered for the Dh split), its 2 KV heads whole, the engine's pool
# of 1021 keys a slot (pages of 1: 4 divides neither) over Dh
DH_ENGINE_MESH = (1, 4)
DH_ENGINE_LAYERS = 2          # of 36 (as 17a: the script's time budget)
DH_POOL = 1021
DH_SLOTS = 4
DH_NEW = (4, 8)               # new tokens a request (17a's 8-16 halved)
# 21c: one fused TVLARS f32 step of whisper-large-v3 at (1, 8), 2 + 2
# layers (19a's depth cut), the model in f32 (8 does not divide its
# vocabulary, so its head is whole: no split head to hold in bf16)
DH_TRAIN_CUT = dict(FT_CUTS["whisper-large-v3"], **FT_F32)


class DecodeWatch:
    """``model`` with a ``decode_step`` that keeps each call's last
    position's logits (on the card) and, at its first call (the encoder
    and cross K/V done before it), the cache's bytes, and restarts the
    clock, the launch counts and ``mesh``'s collective counts there."""

    def __init__(self, model, ops, mesh=None):
        self.calls, self.logits, self.cache_bytes, self.t0 = 0, [], 0, 0.0
        self.cache_shapes = {}
        real = model.decode_step

        def step(params, cache, tokens, pos):
            if self.calls == 0:
                torch.cuda.synchronize()
                for c in cache:
                    for k, v in c.items():
                        self.cache_bytes += v.numel() * v.element_size()
                        self.cache_shapes[k] = tuple(v.shape)
                if mesh is not None:
                    mesh.collectives.clear()
                ops.reset_launches()
                self.t0 = time.perf_counter()
            self.calls += 1
            logits, cache = real(params, cache, tokens, pos)
            self.logits.append(logits[:, -1].float())
            return logits, cache

        self.model = model._replace(decode_step=step)


def dh_generate(serving, ops, model, params, prompts, frames, max_len,
                mesh=None, keep_logits: bool = True) -> dict:
    """21a's ``generate`` (token-by-token prefill, then the new tokens)
    on ``params`` (``mesh``'s blocks): tokens, per-call logits (f32 on
    the host), the decode step's host time, launches by mode, the
    cache's bytes and leaf shapes and the row's collectives over the
    decode steps."""
    watch = DecodeWatch(model, ops, mesh)
    tokens = serving.generate(
        watch.model, params, prompts, num_tokens=DH_GEN[2], max_len=max_len,
        extra_embeds=frames, device="cuda" if mesh is None else mesh.device,
        mesh=mesh).cpu().tolist()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - watch.t0) * 1e3 / watch.calls
    return {"tokens": tokens, "calls": watch.calls, "step_ms": step_ms,
            "logits": torch.stack(watch.logits).cpu().numpy()
            if keep_logits else None,
            "launches": {k: ops.launches[k] for k in ops.DECODE_KERNELS},
            "cache_bytes": watch.cache_bytes,
            "cache": watch.cache_shapes,
            "collectives": {} if mesh is None else {
                k: dict(v) for k, v in mesh.collectives.items()}}


def dh_whisper_rank(prompts) -> dict:
    """21a on one rank of the (1, 8) world: this rank's blocks of
    whisper-large-v3's seed-0 draw cut to ``DH_LAYERS``, ``generate``
    at each length of ``DH_LENGTHS`` (rank 0 keeps the logits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    mesh = mesh_lib.make_host_mesh(*DH_MESH)
    cfg = get_config(DH_WHISPER).replace(num_layers=DH_LAYERS,
                                         encoder_layers=DH_LAYERS)
    model = get_model(cfg)
    params = model.init(0, device=mesh.device, mesh=mesh)
    layer = params["decoder"][0]
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "shapes": {"wq": tuple(layer["self_attn"]["wq"].shape),
                      "wi": tuple(layer["mlp"]["wi"].shape)}}
    frames = extra_draw(cfg, DH_GEN[0], DH_DRAW_SEED, device=mesh.device)
    for run, length in DH_LENGTHS.items():
        r = dh_generate(serving, ops, model, params, prompts, frames, length,
                        mesh, keep_logits=mesh.rank == 0)
        r["equal"] = mesh_lib.all_equal(mesh, r["tokens"])
        out[run] = r
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def dh_engine_rank(requests, tokens1) -> dict:
    """21b on one rank of the (1, 4) world: this rank's blocks of
    qwen2.5-3b cut to ``DH_ENGINE_LAYERS``, the engine on a pool of
    ``DH_POOL`` keys (over Dh), the requests teacher-forced along M =
    1's tokens, and the decode step's split."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    mesh = mesh_lib.make_host_mesh(*DH_ENGINE_MESH)
    model = get_model(get_config(DH_QWEN).replace(
        num_layers=DH_ENGINE_LAYERS))
    params = model.init(0, device=mesh.device, mesh=mesh)
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=DH_SLOTS, max_len=DH_POOL, page_size=1), device=mesh.device,
        mesh=mesh)
    mesh.collectives.clear()
    results, stats, elapsed, _ = serve(eng, ops, requests)
    modes = {k: ops.launches[k] for k in ops.DECODE_KERNELS}
    pool = tuple(eng._kv.cache[0]["k"].shape)
    tokens2 = [list(r.tokens) for r in results]
    del eng, results
    tf = teacher_forced(L, model, params, requests[0], tokens1, mesh,
                        DH_POOL)
    split = decode_split(model, params, mesh, ops, L, DH_SLOTS, DH_POOL)
    return {"rank": mesh.rank, "pool": pool, "tokens": tokens2,
            "stats": stats, "elapsed": elapsed, "modes": modes,
            "split": split, "peak": torch.cuda.max_memory_allocated(),
            "equal": mesh_lib.all_equal(mesh, tokens2),
            "tf": [bits(t) for t in tf] if mesh.rank == 0 else None}


def dh_gaps(label, run1, run8, prompt_len: int, tol) -> tuple:
    """21a's logits of the ranks' run against M = 1's at every call up
    to each row's first different token (|gap| max and mean), and that
    difference a bf16 near-tie in both logit sets: ((max, mean), ties)."""
    l1, l8 = torch.from_numpy(run1["logits"]), torch.from_numpy(
        run8["logits"])
    diffs, ties = [], []
    for i, (a, b) in enumerate(zip(run1["tokens"], run8["tokens"])):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        last = l1.shape[0] if j is None else prompt_len + j
        diffs.append((l8[:last, i] - l1[:last, i]).abs())
        if j is not None:
            call = prompt_len - 1 + j
            g1, lim1 = logit_gaps(l1[call, i], torch.tensor(b[j]), tol)
            g8, lim8 = logit_gaps(l8[call, i], torch.tensor(a[j]), tol)
            if g1 > lim1 or g8 > lim8:
                raise AssertionError(f"{label} row {i}: token {j} differs "
                                     f"from M=1 ({a[j]} vs {b[j]}) beyond a "
                                     f"bf16 tie: {g1.item()} / {g8.item()}")
            ties.append((i, j, round(g1.item(), 4), round(g8.item(), 4)))
    d = torch.cat([x.flatten() for x in diffs])
    return (d.max().item(), d.mean().item()), ties


def dh_split_line(r: dict) -> str:
    """A decode step's host time split from the row's collectives."""
    per = {k: v["seconds"] * 1e3 / r["calls"]
           for k, v in r["collectives"].items()}
    sums = per.get("model_sum", 0.0)
    scores = per.get("score_sum", 0.0)
    gathers = sum(v for k, v in per.items() if k.endswith("gather"))
    compute = r["step_ms"] - sums - scores - gathers
    calls = {k: v["calls"] // r["calls"] for k, v in
             r["collectives"].items()}
    return (f"{r['step_ms']:.3f} ms = compute {compute:.3f} + score sums "
            f"{scores:.3f} + gathers {gathers:.3f} + wo/MLP sums "
            f"{sums:.3f} (calls a step {calls})")


def phase_dh_split(tad, ops, serving, train_launch, get_config,
                   get_model) -> dict:
    """21-21c: the head-dim split (see the module docstring)."""
    out: dict = {"seconds": {}}
    t0 = time.perf_counter()
    out["21"] = phase_dh_kernels(tad, ops)
    out["seconds"]["21"] = time.perf_counter() - t0
    print(f"21: {out['seconds']['21']:.1f} s", flush=True)

    # 21a: whisper-large-v3 at (1, 8), after M = 1 here
    t0 = time.perf_counter()
    full = get_config(DH_WHISPER)
    cfg = full.replace(num_layers=DH_LAYERS, encoder_layers=DH_LAYERS)
    m = DH_MESH[1]
    print(f"21a {DH_WHISPER}: reduced: num_layers {full.num_layers} -> "
          f"{DH_LAYERS}, encoder_layers {full.encoder_layers} -> "
          f"{DH_LAYERS} (the script's time budget; width as published: "
          f"{cfg.d_model} wide, {cfg.num_heads} heads of "
          f"{cfg.head_dim_}, {cfg.encoder_seq} frames)", flush=True)
    model = get_model(cfg)
    b, s, new = DH_GEN
    prompts = np.random.RandomState(21).randint(1, cfg.vocab_size,
                                                size=(b, s))
    params = model.init(0, device="cuda")
    frames = extra_draw(cfg, b, DH_DRAW_SEED)
    single = {run: dh_generate(serving, ops, model, params, prompts, frames,
                               length)
              for run, length in DH_LENGTHS.items()}
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    ranks = on_ranks(dh_whisper_rank, m, args=(prompts,), timeout=900)
    tol = tad.decode_parity_tolerance(torch.bfloat16)
    from repro_torch.models import layers as L
    res = {}
    for run, length in DH_LENGTHS.items():
        one, r0 = single[run], ranks[0][run]
        axis = L.cache_axis(cfg, length, m)
        per = cfg.num_layers * r0["calls"]
        want = {"attention_decode": per if axis == "t" else 0,
                "attention_decode_scores": per if axis == "dh" else 0,
                "attention_decode_apply": per if axis == "dh" else 0}
        for r in ranks:
            x = r[run]
            if not x["equal"] or x["tokens"] != r0["tokens"]:
                raise AssertionError(f"21a {run}: the ranks differ")
            if x["launches"] != want:
                raise AssertionError(f"21a {run} rank {r['rank']}: "
                                     f"launches {x['launches']}, expected "
                                     f"{want}")
            if x["cache_bytes"] * m != one["cache_bytes"]:
                raise AssertionError(f"21a {run} rank {r['rank']}: cache "
                                     f"{x['cache_bytes']} B, M=1 "
                                     f"{one['cache_bytes']} B")
        if one["launches"]["attention_decode"] != per:
            raise AssertionError(f"21a {run} M=1: {one['launches']}")
        gaps, ties = dh_gaps(f"21a {run}", one, r0, s, tol)
        if not (gaps[0] <= TP_LOGIT_BOUND
                and gaps[1] <= TP_LOGIT_MEAN_BOUND):
            raise AssertionError(f"21a {run}: |logit gap| (max, mean) "
                                 f"{gaps}, bounds {TP_LOGIT_BOUND}, "
                                 f"{TP_LOGIT_MEAN_BOUND}")
        equal = sum(a == c for a, c in zip(one["tokens"], r0["tokens"]))
        print(f"21a {DH_WHISPER} run {run} (cache length {length}: self "
              f"caches over {axis}, cross K/V over "
              f"{L.cache_axis(cfg, cfg.encoder_seq, m)}) on a {DH_MESH} mesh "
              f"of {m} {ranks[0]['backend']} ranks sharing the card: blocks "
              f"{ranks[0]['shapes']}; cache a rank {r0['cache_bytes']} B = "
              f"M=1's {one['cache_bytes']} B / {m} (leaves {r0['cache']}); "
              f"launches a rank {r0['launches']} over {r0['calls']} calls "
              f"({cfg.num_layers} layers); tokens equal on {m} ranks, "
              f"{equal} of {b} rows equal to M=1 (first differences: row, "
              f"token, gaps in M=1's / M=8's logits {ties}); |logit gap| "
              f"to M=1 (max, mean) ({gaps[0]:.4f}, {gaps[1]:.5f}) (bounds "
              f"{TP_LOGIT_BOUND}, {TP_LOGIT_MEAN_BOUND}); decode step "
              f"(rank 0, host clock) {dh_split_line(r0)}; M=1 "
              f"{one['step_ms']:.3f} ms", flush=True)
        res[run] = {"launches": r0["launches"], "gaps": gaps,
                    "step_ms": r0["step_ms"], "ties": ties,
                    "collectives": r0["collectives"], "calls": r0["calls"],
                    "one_ms": one["step_ms"]}
    out["21a"] = res
    out["21a"]["peak_gib"] = [r["peak"] / GIB for r in ranks]
    out["seconds"]["21a"] = time.perf_counter() - t0
    print(f"21a: {out['seconds']['21a']:.1f} s; peak a rank "
          f"{[round(x, 2) for x in out['21a']['peak_gib']]} GiB; "
          f"{smi_line()}", flush=True)

    # 21b: qwen2.5-3b, case B, through the engine at (1, 4)
    t0 = time.perf_counter()
    full = get_config(DH_QWEN)
    cfg = full.replace(num_layers=DH_ENGINE_LAYERS)
    m = DH_ENGINE_MESH[1]
    print(f"21b {DH_QWEN}: reduced: num_layers {full.num_layers} -> "
          f"{DH_ENGINE_LAYERS} (the script's time budget; width as "
          f"published)", flush=True)
    model = get_model(cfg)
    requests = requests_of(cfg.vocab_size, 21, 4, (64, 256), DH_NEW)
    params = model.init(0, device="cuda")
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=DH_SLOTS, max_len=DH_POOL, page_size=1), device="cuda")
    results, stats1, elapsed1, _ = serve(eng, ops, requests)
    pool1 = tuple(eng._kv.cache[0]["k"].shape)
    tokens1 = [list(r.tokens) for r in results]
    del eng, results
    tf1 = teacher_forced(L, model, params, requests[0], tokens1,
                         max_len=DH_POOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ranks = on_ranks(dh_engine_rank, m, args=(requests, tokens1),
                     timeout=600)
    r0 = ranks[0]
    for r in ranks:
        steps = r["stats"]["decode_steps"]
        per = cfg.num_layers * steps
        if not r["equal"] or r["tokens"] != r0["tokens"]:
            raise AssertionError("21b: the ranks served different tokens")
        if r["modes"] != {"attention_decode": 0,
                          "attention_decode_scores": per,
                          "attention_decode_apply": per} \
                or r["split"]["launches"] != 2 * cfg.num_layers:
            raise AssertionError(f"21b rank {r['rank']}: launches "
                                 f"{r['modes']} over {steps} steps, split "
                                 f"{r['split']['launches']} a step")
        if r["pool"] != pool1[:3] + (pool1[3] // m,):
            raise AssertionError(f"21b: pool {r['pool']} (M=1 {pool1})")
    tf2 = [unbits(a) for a in r0["tf"]]
    gaps = []
    for a, c in zip(tf2, tf1):
        d = (a.float() - c.float()).abs()
        gaps.append((d.max().item(), d.mean().item()))
    worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    if not (worst[0] <= TF_LOGIT_BOUND and worst[1] <= TF_LOGIT_MEAN_BOUND):
        raise AssertionError(f"21b: logit gaps to M=1 {gaps}")
    ties = near_ties("21b", tokens1, r0["tokens"], tf1, tf2, tol)
    sp = r0["split"]
    others = ", ".join(f"{k} {v:.3f}" for k, v in sp["ms"].items())
    print(f"21b {DH_QWEN} on a {DH_ENGINE_MESH} mesh (4 of 16 heads a rank, "
          f"both KV heads, the pool of {DH_POOL} keys over Dh): KV pool a "
          f"rank {r0['pool']} (M=1 {pool1}); launches a rank {r0['modes']} "
          f"over {r0['stats']['decode_steps']} steps; tokens equal on {m} "
          f"ranks, {sum(a == c for a, c in zip(tokens1, r0['tokens']))} of "
          f"{len(tokens1)} requests equal to M=1 (first differences "
          f"{ties}); |logit gap| along M=1's tokens (max, mean) a request "
          f"{[(round(a, 4), round(c, 5)) for a, c in gaps]} (bounds "
          f"{TF_LOGIT_BOUND}, {TF_LOGIT_MEAN_BOUND}); "
          f"{r0['stats']['tokens_generated'] / r0['elapsed']:.2f} tok/s (M=1 "
          f"{stats1['tokens_generated'] / elapsed1:.2f}); decode step split "
          f"(rank 0, {DH_SLOTS} slots, host clock) {sp['step_ms']:.3f} ms = "
          f"compute {sp['compute_ms']:.3f} + collectives by name (ms) "
          f"{others}", flush=True)
    out["21b"] = {"modes": r0["modes"], "gaps": gaps, "ties": ties,
                  "split": sp, "steps": r0["stats"]["decode_steps"]}
    out["seconds"]["21b"] = time.perf_counter() - t0
    print(f"21b: {out['seconds']['21b']:.1f} s", flush=True)

    # 21c: whisper-large-v3 trained one fused step at (1, 8)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dh_")
    try:
        out["21c"] = ft_train("21c", DH_WHISPER, DH_TRAIN_CUT, DH_MESH,
                              train_launch, get_config, tmp,
                              {"seg_norm_lars": 1, "seg_apply_lars": 1})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"]["21c"] = time.perf_counter() - t0
    print(f"21c: {out['seconds']['21c']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------- 22-22b: sequence parallelism and its dry run
SP_ARCH = "qwen2.5-3b"
SP_LAYERS = 4                  # of 36: the script's time budget
SP_SEQ, SP_BATCH = 4096, 1
SP_MESH = (1, 2)
SP_HYPER = dict(total_steps=10, learning_rate=1.0)
# |card - dry run| / card, for the peak and the forward's held bytes
SP_PEAK_RTOL = 0.10
SP_DRY = (("qwen2-72b", "train_4k"), ("qwen2.5-3b", "decode_32k"),
          ("gemma3-12b", "long_500k"))
SP_METRICS = ("loss", "grad_norm", "layerwise/w_norm", "layerwise/g_norm",
              "layerwise/trust_ratio")


def sp_config():
    from repro_torch.configs import get_config
    return get_config(SP_ARCH).replace(num_layers=SP_LAYERS)


def sp_build(cfg, mesh, device):
    """The phase's step: the seed-0 params (this rank's fsdp + tensor
    parallel blocks on ``mesh``, whole at ``mesh=None``), fused TVLARS
    f32, and the seeded global batch, on ``device`` (the card, or meta
    for the dry run). Returns (model, placement, state, step, batch)."""
    from repro_torch.core import build_optimizer
    from repro_torch.models import convert, get_model
    from repro_torch.training import TrainState, make_train_step
    model = get_model(cfg)
    place = None if mesh is None else convert.placement(cfg, mesh)
    params = model.init(0, device=device, mesh=mesh, fsdp=mesh is not None)
    opt = build_optimizer("tvlars", **SP_HYPER, use_kernel="fused",
                          segments=model.segments, device=device,
                          placement=place)
    state = TrainState.create(params, opt)
    step = make_train_step(model, opt, mesh=mesh, placement=place,
                           layerwise=True)
    gen = torch.Generator().manual_seed(22)
    toks = torch.randint(0, cfg.vocab_size, (SP_BATCH, SP_SEQ + 1),
                         generator=gen)
    batch = {"tokens": toks[:, :-1].to(device),
             "labels": toks[:, 1:].to(device)}
    return model, place, state, step, batch


def sp_declare(L, mesh, seq: bool) -> None:
    L.set_batch_sharding(("data",), "model" if seq else None,
                         model_size=mesh.shape["model"], mesh=mesh)


def sp_saved(L, model, state, batch, mesh, place, seq, dev) -> int:
    """The bytes the forward of the step's loss holds for its backward
    (the remat boundaries, the CE chunks' inputs): allocated after the
    forward minus before, on ``dev`` (the card: ``memory_allocated``;
    meta: the dry run's live-bytes tracker)."""
    from repro_torch.core.base import tree_leaves
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun
    for t in tree_leaves(state.params):
        t.requires_grad_(True)       # as the step's gradient does
    sp_declare(L, mesh, seq)
    local = pipeline.place_over_data(mesh, batch)
    try:
        with L.training(mesh, place):
            if dev == "meta":
                with dryrun.LiveBytes() as live:
                    loss, _ = model.loss(state.params, local)
                    held = live.live
            else:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                loss, _ = model.loss(state.params, local)
                held = torch.cuda.memory_allocated() - before
            del loss
    finally:
        L.set_batch_sharding(None)
    return held


def sp_step_rank(ref_path: str) -> dict:
    """22 and 22a on one rank of a (1, 2) world: for the split and the
    unsplit run, the dry run of the step on a ``DryMesh`` of this rank
    (peak, records, launches, the forward's held bytes), then the step
    on the card from a fresh state (the same readings, the metrics, the
    params' gap to M = 1 and to the other run); then the prefill
    logits both ways."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.base import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers as L
    cfg = sp_config()
    mesh = mesh_lib.make_host_mesh(*SP_MESH)
    dry_mesh = dryrun.DryMesh(*SP_MESH, rank=mesh.rank)
    # cuBLAS keeps a workspace from its first product in a process: take
    # it before any reading, so no reading counts it
    torch.ones((8, 8), device=DEV) @ torch.ones((8, 8), device=DEV)
    torch.cuda.synchronize()
    out, blocks = {}, {}
    for seq in (True, False):
        key = "sp" if seq else "plain"
        # the prediction: the same step on meta
        model, place, state, step, batch = sp_build(cfg, dry_mesh, "meta")
        sp_declare(L, dry_mesh, seq)
        try:
            pred = dryrun.trace(dryrun.DryStep(
                step, (state, batch), dryrun.tensor_bytes(state)
                + dryrun.tensor_bytes(batch), "train"), dry_mesh)
        finally:
            L.set_batch_sharding(None)
        pred["held"] = sp_saved(L, model, state, batch, dry_mesh, place,
                                seq, "meta")
        del model, place, state, step, batch
        # the card
        model, place, state, step, batch = sp_build(cfg, mesh, DEV)
        held = sp_saved(L, model, state, batch, mesh, place, seq, DEV)
        args = dryrun.tensor_bytes(state) + dryrun.tensor_bytes(batch)
        gc.collect()
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - args
        torch.cuda.reset_peak_memory_stats()
        mesh.collectives.clear()
        ops.reset_launches()
        sp_declare(L, mesh, seq)
        t0 = time.perf_counter()
        try:
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
        finally:
            L.set_batch_sharding(None)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - other
        got = {"metrics": {k: metrics[k].float().cpu().numpy()
                           for k in SP_METRICS},
               "collectives": {k: {"count": v["calls"], "bytes": v["bytes"]}
                               for k, v in sorted(mesh.collectives.items())},
               "launches": {k: v for k, v in ops.launches.items() if v},
               "peak": peak, "other": other, "held": held, "args": args,
               "seconds": seconds,
               "param_gap_m1": tt_param_gap(state.params, place, ref_path)}
        blocks[key] = [t.detach().float() for t in
                       tree_leaves(state.params)]
        out[key] = {"pred": pred, "card": got}
        del model, state, step, batch, metrics
        gc.collect()
        torch.cuda.empty_cache()
    out["param_gap_sp"] = max((a - b).abs().max().item() for a, b in
                              zip(blocks["sp"], blocks["plain"]))
    del blocks
    # 22a: the prefill's last-position logits, split and unsplit
    from repro_torch.models import get_model
    model = get_model(cfg)
    params = model.init(0, device=DEV, mesh=mesh)
    tokens = torch.randint(
        0, cfg.vocab_size, (SP_BATCH, SP_SEQ),
        generator=torch.Generator().manual_seed(23)).to(DEV)
    logits = {}
    with torch.no_grad():
        for seq in (True, False):
            sp_declare(L, mesh, seq)
            try:
                logits[seq] = model.apply(params, tokens)[:, -1:].float()
            finally:
                L.set_batch_sharding(None)
    gap = (logits[True] - logits[False]).abs()
    out["logits"] = {"max": gap.max().item(), "mean": gap.mean().item(),
                     "bitwise": bool(torch.equal(logits[True],
                                                 logits[False]))}
    return out


def sp_dry_process(save_dir: str) -> subprocess.Popen:
    """22b: the three production dry runs in a process of their own
    (``python -m repro_torch.launch.dryrun``, meta tensors only)."""
    code = ("import sys; from repro_torch.launch import dryrun\n"
            f"for a, s in {SP_DRY!r}:\n"
            f"    dryrun.dryrun_one(a, s, save_dir={save_dir!r}, "
            f"verbose=False)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def phase_seq_parallel(get_config) -> dict:
    """22-22b (see the module docstring)."""
    from repro_torch.core.base import path_name, tree_flatten_with_path
    cfg = sp_config()
    full = get_config(SP_ARCH)
    print(f"22 {SP_ARCH}: reduced: num_layers {full.num_layers} -> "
          f"{SP_LAYERS} (the script's time budget; width as published: "
          f"{cfg.d_model} wide, {cfg.num_heads} / {cfg.num_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16); seq {SP_SEQ}, "
          f"batch {SP_BATCH}, mesh {SP_MESH}", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    dry = sp_dry_process(tmp)
    try:
        # M = 1 on the same weights and batch
        model, _, state, step, batch = sp_build(cfg, None, DEV)
        state, m1 = step(state, batch)
        single = {k: m1[k].float().cpu().numpy() for k in SP_METRICS}
        ref_path = os.path.join(tmp, "m1.pt")
        torch.save({path_name(p): t.detach().cpu() for p, t in
                    tree_flatten_with_path(state.params)}, ref_path)
        del model, state, step, batch, m1
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = on_ranks(sp_step_rank, SP_MESH[0] * SP_MESH[1],
                         args=(ref_path,), timeout=600)
        ranks_s = time.perf_counter() - t0

        def rel(a, b):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            return float(np.max(np.abs(a - b)
                                / np.maximum(np.abs(b), 1e-30)))

        for r, res in enumerate(ranks):
            for key in ("sp", "plain"):
                pred, card = res[key]["pred"], res[key]["card"]
                gaps = {k.split("/")[-1]: rel(card["metrics"][k], single[k])
                        for k in SP_METRICS}
                gaps["params"] = card["param_gap_m1"]
                bad = {k: v for k, v in gaps.items() if not v <= TT_BOUNDS[k]}
                if bad:
                    raise AssertionError(f"22 rank {r} {key}: gaps to M = 1 "
                                         f"over TT_BOUNDS: {bad}")
                if card["collectives"] != pred["collectives"]:
                    raise AssertionError(
                        f"22 rank {r} {key}: collective records "
                        f"{card['collectives']} but the dry run predicted "
                        f"{pred['collectives']}")
                if card["launches"] != pred["launches"] or \
                        card["launches"] != {"seg_norm_lars": 1,
                                             "seg_apply_lars": 1}:
                    raise AssertionError(
                        f"22 rank {r} {key}: launches {card['launches']}, "
                        f"predicted {pred['launches']}")
                err = abs(card["peak"] - pred["peak_bytes"]) / card["peak"]
                print(f"22 rank {r} {key}: peak {card['peak'] / GIB:.3f} GiB "
                      f"(max_memory_allocated less {card['other']} B held "
                      f"before the step) against the dry run's "
                      f"{pred['peak_bytes'] / GIB:.3f} GiB ({err:.2%}); "
                      f"arguments {card['args'] / GIB:.3f} GiB (dry "
                      f"{pred['argument_bytes'] / GIB:.3f}); the forward "
                      f"holds {card['held'] / 2**20:.1f} MiB for the "
                      f"backward (dry {pred['held'] / 2**20:.1f}); "
                      f"{pred['flops']:.4e} dot FLOPs predicted; step "
                      f"{card['seconds']:.2f} s; gaps to M = 1 "
                      f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }; "
                      f"records {card['collectives']} as predicted; "
                      f"launches {card['launches']}", flush=True)
                held = abs(card["held"] - pred["held"]) / card["held"]
                if not (err <= SP_PEAK_RTOL and held <= SP_PEAK_RTOL):
                    raise AssertionError(
                        f"22 rank {r} {key}: peak off the dry run's by "
                        f"{err:.2%}, the forward's held bytes by {held:.2%}")
            sp, plain = res["sp"]["card"], res["plain"]["card"]
            gaps = {k.split("/")[-1]: rel(sp["metrics"][k],
                                          plain["metrics"][k])
                    for k in SP_METRICS}
            gaps["params"] = res["param_gap_sp"]
            bad = {k: v for k, v in gaps.items() if not v <= TT_BOUNDS[k]}
            if bad:
                raise AssertionError(f"22 rank {r}: split vs unsplit over "
                                     f"TT_BOUNDS: {bad}")
            print(f"22 rank {r}: split vs unsplit gaps "
                  f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }; "
                  f"the split saves {(plain['held'] - sp['held']) / 2**20:.1f}"
                  f" MiB of the forward's held bytes (dry "
                  f"{(res['plain']['pred']['held'] - res['sp']['pred']['held']) / 2**20:.1f}"
                  f") and {(plain['peak'] - sp['peak']) / 2**20:.1f} MiB of "
                  f"the peak (dry "
                  f"{(res['plain']['pred']['peak_bytes'] - res['sp']['pred']['peak_bytes']) / 2**20:.1f})",
                  flush=True)
        lg = ranks[0]["logits"]
        if not (lg["max"] <= TP_LOGIT_BOUND
                and lg["mean"] <= TP_LOGIT_MEAN_BOUND):
            raise AssertionError(f"22a: prefill logits split vs unsplit {lg}")
        print(f"22a prefill logits [{SP_BATCH}, 1, {cfg.vocab_size}] split vs "
              f"unsplit: |gap| max {lg['max']:.4g} mean {lg['mean']:.4g} "
              f"(bitwise equal: {lg['bitwise']}); {ranks_s:.1f} s on the "
              f"shared ranks; {smi_line()}", flush=True)
        log, _ = dry.communicate(timeout=600)
        if dry.returncode != 0:
            raise AssertionError(f"22b: the dry runs failed:\n"
                                 f"{log.decode()[-3000:]}")
        prod = {}
        for arch, shape in SP_DRY:
            with open(os.path.join(tmp, f"{arch}__{shape}__single.json")) as f:
                r = json.load(f)
            prod[(arch, shape)] = r
            if r["status"] != "ok":
                raise AssertionError(f"22b {arch} x {shape}: {r}")
            print(f"22b {arch} x {shape} on (16, 16), the port's prediction "
                  f"(meta tensors, not a card measurement): {r['status']}, "
                  f"{r['peak_bytes'] / GIB:.2f} GiB a rank (arguments "
                  f"{r['argument_bytes'] / GIB:.2f}), {r['flops']:.4e} dot "
                  f"FLOPs a rank, {r['collective_bytes'] / GIB:.3f} GiB of "
                  f"collectives a rank, launches {r['launches']}, "
                  f"{r['seconds']:.1f} s", flush=True)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"ranks": ranks, "production": prod,
            "launches": {k: sum(r[key]["card"]["launches"].get(k, 0)
                                for key in ("sp", "plain"))
                         for r in ranks[:1] for k in SEG_LARS}}


# ------------------------------------------------ 23-23d: the examples
# the JAX package's examples on a CPU sandbox (examples/
# large_batch_classification.py and ssl_barlow_twins.py as committed):
# printed beside the card's numbers, not a gate (other samples)
JAX_CLASSIFICATION = {"wa-lars": (0.7144, 221.360),
                      "nowa-lars": (0.6851, 318.219),
                      "lamb": (0.0244, 3.95e15), "tvlars": (0.7056, 256.978)}
JAX_SSL = {"wa-lars": 0.0571, "tvlars": 0.0459}
LARS_FAMILY = ("wa-lars", "nowa-lars", "tvlars")
OPTIMIZER_KERNELS = ("seg_norm_lars", "seg_norm_lamb", "seg_apply_lars",
                     "seg_apply_lamb", "lars_norm2", "lars_apply")
# the directories phases 10-11c write their JSONL files to (23d reads them)
JSONL_DIRS: list = []


def load_file(rel: str, name: str):
    """The module at ``rel`` (a file of the repository outside ``src``),
    imported without running its ``__main__`` block."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def optimizer_launches(ops) -> dict:
    return {k: ops.launches[k] for k in OPTIMIZER_KERNELS}


def phase_examples(ops, ARCH_IDS) -> dict:
    """23-23d (see the module docstring): each example's ``run`` in this
    process on the card at its JAX twin's constants."""
    out: dict = {}
    with phase_clock("23"):
        qs = load_file("examples/torch_quickstart.py", "torch_quickstart")
        ops.reset_launches()
        hist = qs.run(DEV)
        print(qs.summary(hist).strip(), flush=True)
        if not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"23: loss {hist[0]['loss']} -> "
                                 f"{hist[-1]['loss']}")
        out["23"] = optimizer_launches(ops)

    with phase_clock("23a"):
        clf = load_file("examples/torch_large_batch_classification.py",
                        "torch_large_batch_classification")
        ops.reset_launches()
        results = clf.run(DEV)
        launches = optimizer_launches(ops)
        clf.report(results)
        for name, (acc, s, hist) in results.items():
            want_acc, want_lnr = JAX_CLASSIFICATION[name]
            print(f"23a {name:10s} card acc={acc:.4f} max_init_LNR="
                  f"{s['max_initial_lnr']:.3f} final loss "
                  f"{hist[-1]['loss']:.4f}; JAX on a CPU sandbox acc="
                  f"{want_acc:.4f} max_init_LNR={want_lnr:.6g} (other "
                  f"samples: not a gate)", flush=True)
        for name in LARS_FAMILY:
            acc, s, hist = results[name]
            if not all(math.isfinite(h["loss"]) for h in hist) \
                    or not math.isfinite(s["max_initial_lnr"]):
                raise AssertionError(f"23a {name}: not finite")
        # build_optimizer's default use_kernel=False, as in the JAX
        # script: the tree path, no optimizer kernel
        if any(launches.values()):
            raise AssertionError(f"23a: optimizer kernel launches "
                                 f"{launches}, expected none")
        print(f"23a: optimizer kernel launches {launches} (expected 0: "
              f"use_kernel=False, as the JAX script)", flush=True)
        out["23a"] = launches

    with phase_clock("23b"):
        ssl = load_file("examples/torch_ssl_barlow_twins.py",
                        "torch_ssl_barlow_twins")
        ops.reset_launches()
        results = ssl.run(DEV)
        for name, (acc, hist, phist) in results.items():
            if not (0.0 <= acc <= 1.0 and all(
                    math.isfinite(h["loss"]) for h in hist + phist)):
                raise AssertionError(f"23b {name}: acc {acc}")
            print(f"23b {name}: card linear-probe accuracy {acc:.4f}; JAX "
                  f"on a CPU sandbox {JAX_SSL[name]:.4f} (other samples: "
                  f"not a gate)", flush=True)
        out["23b"] = optimizer_launches(ops)

    with phase_clock("23c"):
        serve = load_file("examples/torch_serve_lm.py", "torch_serve_lm")
        per_arch = {}
        for arch in ARCH_IDS:
            ops.reset_launches()
            got = serve.run(arch, device=DEV)
            # the example holds engine == generate itself, and launches
            # == attention layers x decode steps (held again here: its
            # asserts go under -O)
            if got["launches"] != got["expected"]:
                raise AssertionError(f"23c {arch}: {got}")
            per_arch[arch] = {"launches": got["launches"],
                              "per_step": serve.attention_layers(
                                  serve.get_smoke_config(arch)),
                              "engine": got["stats"] is not None}
            print(f"23c {arch}: decode launches {got['launches']} "
                  f"({per_arch[arch]['per_step']} per decode step, "
                  f"{'engine' if got['stats'] else 'generate x 2'})",
                  flush=True)
        out["23c"] = per_arch

    with phase_clock("23d"):
        vm = load_file("tools/torch_validate_metrics.py",
                       "torch_validate_metrics")
        paths = sorted(str(p) for d in JSONL_DIRS
                       for p in Path(d).rglob("*.jsonl"))
        if len(paths) < len(JSONL_DIRS):
            raise AssertionError(f"23d: {len(paths)} JSONL files in "
                                 f"{JSONL_DIRS}")
        rc = vm.main(["--min-records", "1", *paths])
        if rc != 0:
            raise AssertionError(f"23d: torch_validate_metrics exited {rc}")
        print(f"23d: torch_validate_metrics OK on {len(paths)} JSONL files "
              f"of phases 10-11c", flush=True)
        for d in JSONL_DIRS:
            shutil.rmtree(d, ignore_errors=True)
        out["23d"] = len(paths)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import serving, training
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.core import build_optimizer, flatten
    from repro_torch.core.base import tree_leaves, tree_map
    from repro_torch.data.synthetic import lm_iterator
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import attention_decode as tad
    from repro_torch.kernels import ref as sref
    from repro_torch.kernels import lars_update as lu
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import segmented_update as su
    from repro_torch.core import layerwise
    from repro_torch.data import synthetic
    from repro_torch import diagnostics as diag
    from repro_torch.diagnostics import smoke as diag_smoke
    from repro_torch.core import schedules
    from repro_torch.data import pipeline
    from repro_torch.launch import (ablations, adaptive_batch, classify,
                                    fig2_lnr, paper_io, table1)
    from repro_torch.launch import schedules as schedules_launch
    from repro_torch.launch import ssl as ssl_launch
    from repro_torch.launch import sharpness as sharpness_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import cnn, convert, get_model, moe
    from repro_torch.obs import Tracer, phase_summary
    from repro_torch import checkpoint, core
    from repro_torch.launch import landscape as landscape_launch
    from repro_torch.launch import pipeline as pipeline_launch
    from repro_torch.launch import mesh as mesh_lib

    # full-f32 matmuls and convolutions wherever f32 is computed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _build.build(["attention_decode", "segmented_update",
                           "lars_update", "rmsnorm"])
    for name, r in report.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           r["log"])]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             r["log"])]
        print(f"build: {name} in {r['seconds']:.1f} s -> {r['path']}; "
              f"ptxas: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, spill stores at most "
              f"{max(spills, default=0)} B")
    print(f"build: total {time.perf_counter() - t0:.1f} s", flush=True)

    with phase_clock("3"):
        kernel = phase_kernel(tad, ops)
    with phase_clock("3b"):
        seg = phase_seg_kernels(su, sref, flatten, convert, get_config)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("3c"):
        lars = phase_lars_kernels(lu, sref, flatten, layerwise, convert,
                                  get_config, cnn, tree_leaves)
    with phase_clock("3d"):
        rmsn = phase_rmsnorm(rms, sref, ops)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("4"):
        main_path = phase_serving(
            ops, serving, get_config, get_model, Tracer, phase_summary,
            tad.decode_parity_tolerance(torch.bfloat16))
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("5"):
        phase_f32_full_width(ops, serving, get_config, get_model)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("6"):
        phase_small_against_cpu(serving, get_smoke_config, get_model)

    # the training path at full width: (a) fused TVLARS in f32, (b) fused
    # LAMB with bf16 stochastic-rounded state and 2 microbatches
    train = {}
    for phase, label, argv in (
            ("7", "tvlars-f32", ["--optimizer", "tvlars", "--use-kernel",
                            "fused", "--precision", "f32",
                            "--global-batch", "8", "--seq", "512",
                            "--steps", "3"]),
            ("7b", "lamb-bf16sr-K2", ["--optimizer", "lamb", "--use-kernel",
                                "fused", "--precision", "bf16_master_sr",
                                "--global-batch", "8", "--microbatch",
                                "4", "--seq", "512", "--steps", "3"])):
        with phase_clock(phase):
            train.update(phase_train_full(train_run, ops, su, sref,
                                          tree_leaves, argv, label))
        gc.collect()
        torch.cuda.empty_cache()
    # (c) the per-tensor path: WA-LARS, f32 momentum, bf16 weights
    with phase_clock("7c"):
        train.update(phase_train_per_tensor(
            train_run, ops, lu, sref, layerwise, flatten, tree_leaves,
            ["--optimizer", "wa-lars", "--use-kernel", "per_tensor",
             "--precision", "f32", "--global-batch", "8", "--seq", "512",
             "--steps", "3"], "wa-lars-per-tensor"))
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("8"):
        phase_train_small_against_cpu(get_smoke_config, get_model,
                                      build_optimizer, training,
                                      lm_iterator, tree_leaves, tree_map,
                                      ops, su, layerwise, flatten)
    with phase_clock("9"):
        paper_loop = phase_paper_loop(
            classify, cnn, core, training, synthetic, ops,
                         layerwise, flatten, tree_leaves, tree_map)
    gc.collect()
    torch.cuda.empty_cache()

    # 10: the sharpness diagnostics at full width, then against the CPU,
    # the bench's port and the probe smoke's entry point
    print(f"10 qwen2.5-3b: reduced: num_layers 36 -> {PHASE10_LAYERS} "
          f"(the script's time budget: phases 16 and 17 came in; width as "
          f"published)", flush=True)
    with phase_clock("10"), depth_cut(train_launch, "qwen2.5-3b",
                                      PHASE10_LAYERS):
        sharp = phase_sharpness_full(
            train_run, ops, lu, sref, layerwise, flatten, tree_leaves, diag,
            synthetic, training,
            ["--arch", "qwen2.5-3b", "--optimizer", "wa-lars",
             "--use-kernel", "per_tensor", "--global-batch", "8",
             "--microbatch", "1", "--seq", "512", "--steps", "3",
             "--probe-every", "1", "--probe-iters", "4",
             "--probe-no-reorth"], "wa-lars-probes", PHASE10_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("10b-10d"):
        phase_sharpness_small_against_cpu(get_smoke_config, get_model,
                                          diag, synthetic, training,
                                          tree_map)
        phase_sharpness_bench(sharpness_launch, diag)
        JSONL_DIRS.append(tempfile.mkdtemp(prefix="phase10d_"))
        diag_smoke.main(["--out", JSONL_DIRS[-1]])
    gc.collect()
    torch.cuda.empty_cache()

    # 11: the adaptive-batch controller at full width, on the smoke LM
    # against the CPU, and the paper's experiment launchers
    with phase_clock("11"):
        adaptive = phase_adaptive_full(
            train_run, ops, su, pipeline, synthetic, schedules, training,
            diag,
            ["--arch", "qwen2.5-3b", "--optimizer", "tvlars",
             "--use-kernel", "fused", "--global-batch", "2", "--microbatch",
             "1", "--seq", "512", "--batch-max", "16", "--controller-every",
             "2", "--steps", "4", "--prefetch", "2", "--adaptive-batch"],
            "tvlars-adaptive")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("11b"):
        phase_adaptive_small(get_smoke_config, get_model, pipeline,
                             synthetic, training, diag, build_optimizer,
                             tree_leaves, tree_map, ops, su, diag.sink)
    with phase_clock("11c"):
        paper = phase_paper_runs(
            {"table1": table1, "ssl": ssl_launch, "fig2_lnr": fig2_lnr,
             "ablations": ablations, "schedules": schedules_launch,
             "adaptive_batch": adaptive_batch}, ops, layerwise, flatten,
            cnn, paper_io, diag)

    # 12-12f: codeqwen1.5-7b at full width and depth, qwen2-72b at full
    # width cut in depth, then the main path (train -> checkpoint ->
    # serve), the pipeline and landscape benches and the profiler
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("12"):
        codeqwen = phase_dense_serving(
            "12 codeqwen1.5-7b", get_config("codeqwen1.5-7b"),
            traffic(get_config("codeqwen1.5-7b").vocab_size)[::2], SLOTS,
            MAX_LEN, ops, serving, tad, get_model, Tracer, phase_summary,
            tree_leaves)
    gc.collect()
    torch.cuda.empty_cache()
    full72 = get_config("qwen2-72b")
    depth72 = cut_depth(full72, 4, 1024)
    cfg72 = full72.replace(num_layers=depth72)
    print(f"12b qwen2-72b: reduced: num_layers {full72.num_layers} -> "
          f"{depth72} (the deepest cut whose weights, KV pool and "
          f"{PREFILL_MARGIN_GIB} GiB of prefill activations are predicted "
          f"under {PEAK_CEILING_GIB} GiB; width as published)", flush=True)
    with phase_clock("12b"):
        qwen72 = phase_dense_serving(
            "12b qwen2-72b (cut in depth)", cfg72,
            requests_of(cfg72.vocab_size, 1, 4, (128, 512), (16, 32)), 4,
            1024, ops, serving, tad, get_model, Tracer, phase_summary,
            tree_leaves)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("12c"):
        main12 = phase_main_path(train_run, ops, checkpoint, convert,
                                 serving, tad, training.trainer,
                                 tree_leaves)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("12d-12f"):
        pipe = phase_pipeline_bench(pipeline_launch, ops)
        phase_landscape_bench(landscape_launch)
        prof = phase_profile(train_run, ops)

    # 13-13f: the MoE, Mamba2 and Zamba2 families
    with phase_clock("13-13e"):
        fam = phase_families(train_launch, ops, su, sref, lu, layerwise,
                             flatten, serving, tad, get_config, get_model,
                             Tracer, phase_summary, tree_leaves)
    with phase_clock("13f"):
        phase_families_small(get_smoke_config, get_model, serving,
                             build_optimizer, training, lm_iterator,
                             tree_leaves, tree_map, ops, su, moe)

    # 14-14f: the encoder-decoder and vision families
    with phase_clock("14-14e"):
        cross = phase_cross_families(train_launch, ops, su, sref, lu,
                                     layerwise, flatten, serving, tad,
                                     get_config, get_model, Tracer,
                                     phase_summary, tree_leaves)
    with phase_clock("14f"):
        phase_cross_families_small(get_smoke_config, get_model, serving,
                                   build_optimizer, training, lm_iterator,
                                   tree_leaves, tree_map, ops, su)

    # 15-15d: data parallelism over torch.distributed
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("15-15d"):
        dp = phase_data_parallel(train_launch, ops, serving, mesh_lib,
                                 get_config, get_model, tree_leaves)

    # 16-16b: the model axis, tensor-parallel serving
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("16-16b"):
        tp = phase_model_axis(ops, serving, tad, mesh_lib, get_config,
                              get_smoke_config, get_model, Tracer,
                              phase_summary, tree_leaves)

    # 17-17d: the KV cache over T (the decode kernel's partial mode), the
    # slots over the data axis, the other families on the model axis
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("17-17b, 17d"):
        tf = phase_t_fallback(ops, serving, tad, mesh_lib, get_config,
                              get_smoke_config, get_model, Tracer,
                              phase_summary)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("17c"):
        fam_tp = phase_families_tp(ops, serving, mesh_lib, get_config,
                                   get_model)

    # 18-18c: training over the model axis (fsdp + tensor parallelism)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("18-18c"):
        tt = phase_model_axis_training(train_launch, ops, serving,
                                       checkpoint, mesh_lib, get_config,
                                       get_smoke_config, get_model,
                                       tree_leaves)

    # 19-19d: the other families over the GSPMD mesh, and the probe
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("19-19d"):
        ft = phase_families_training(train_launch, get_config)

    # 20-20c: the MoE family over the model axis (expert parallelism)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("20-20c"):
        ep = phase_experts(tad, ops, serving, train_launch, get_config,
                           get_model)

    # 21-21c: the KV cache over the head dim (the decode kernel's scores
    # and apply modes) and over T beside whole heads; whisper-large-v3
    # served and trained at (1, 8), qwen2.5-3b's case B at (1, 4)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("21-21c"):
        dh = phase_dh_split(tad, ops, serving, train_launch, get_config,
                            get_model)

    # 22-22b: sequence parallelism against its own dry run, prefill
    # under it, and three production dry runs
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("22-22b"):
        sp = phase_seq_parallel(get_config)

    # 23-23d: the four examples on the card at their JAX twins' sizes,
    # and the validate tool's twin over the phases' JSONL files
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("23-23d"):
        ex = phase_examples(ops, ARCH_IDS)

    # the serving path's mix: 40 local and 8 global launches per decode
    # step (bf16 pool); per-launch means weighted by that mix
    rows = kernel["rows"]
    n = LOCAL_PER_STEP + GLOBAL_PER_STEP

    def mix(key):
        return (LOCAL_PER_STEP * rows[("local", torch.bfloat16)][key]
                + GLOBAL_PER_STEP * rows[("global", torch.bfloat16)][key]) \
            / n

    # max |err| over every shape held: gemma3-12b's four, the three
    # dense configs' serving shapes, the three of 13 / 13b / 13e, the
    # two of 14e, a rank's shape in 16 and the partial mode's two in 17
    served = (codeqwen, qwen72, main12, fam["13"], fam["13b"], fam["13e"],
              cross["14"], cross["14b"], tp, ep["20"], ep["20a"])
    kernel["max_abs_err"] = max(
        [kernel["max_abs_err"]] + [r["row"]["max_abs_err"] for r in served]
        + [r["max_abs_err"] for r in tf["rows"]])
    entries = [{"name": "attention_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/attention_decode.cu",
                "replaces": "src/repro/kernels/attention_decode.py:63",
                "launches": main_path["launches"],
                "max_abs_err": kernel["max_abs_err"],
                "ms": mix("ms"), "plain_ms": mix("plain_ms"),
                "bound_ms": mix("bound_ms"),
                "bound_by": "bytes" if mix("bytes_ms") >= mix("ops_ms")
                else "operations",
                "library_ms": mix("library_ms"),
                "shapes": [dict(rows[(kind, dt)], layers_per_step=n_kind)
                           for dt in (torch.bfloat16, torch.float32)
                           for kind, n_kind in (("local", LOCAL_PER_STEP),
                                                ("global", GLOBAL_PER_STEP))]
                + [dict(r["row"], layers_per_step=r["layers"])
                   for r in (codeqwen, qwen72, main12, fam["13"],
                             fam["13b"])]
                + [dict(fam["13e"]["row"], layers_per_step=6)]
                + [dict(cross[k]["row"], layers_per_step=cross[k]["layers"])
                   for k in ("14", "14b")]
                + [dict(tp["row"], layers_per_step=TP_LAYERS)]
                + [dict(ep[k]["row"], layers_per_step=ep[k]["layers"])
                   for k in ("20", "20a")]
                + [dict(r, layers_per_step=n, mode="partial")
                   for r, n in zip(tf["rows"], (TF_LAYERS, 0))],
                "launches_by_phase": {
                    "4": main_path["launches"], "12": codeqwen["launches"],
                    "12b": qwen72["launches"],
                    "12c": main12["decode_launches"],
                    "13": fam["13"]["launches"],
                    "13b": fam["13b"]["launches"],
                    "13d": fam["13d"]["inspect"]["launches"],
                    "13e": fam["13e"]["inspect"]["launches"],
                    "14": cross["14"]["launches"],
                    "14b": cross["14b"]["launches"],
                    # per rank: each rank of the mesh launches as many
                    "16": tp["launches"],
                    **{f"16b-{a}": r["launches"]
                       for a, r in tp["small"].items()},
                    # per rank; 17a's (and 17d (1, 4)'s dense and vlm
                    # ones) in the partial mode
                    "17a": tf["launches"], "17b": tf["data_launches"],
                    **{f"17c-{a}": r["launches"] for a, r in fam_tp.items()},
                    **{f"{k}-{a}": n for k, per in tf["small"].items()
                       for a, n in per.items()},
                    # per rank, on the rank's heads beside its experts
                    "20": ep["20"]["launches"],
                    "20a": ep["20a"]["launches"],
                    # per rank: whisper's self caches over T, heads whole
                    "21a-t": dh["21a"]["t"]["launches"]["attention_decode"],
                    # the serving example at every arch's smoke config
                    **{f"23c-{a}": r["launches"]
                       for a, r in ex["23c"].items()}}}]
    # the head-dim split's two modes: card times at the main path's
    # shapes (21's bf16 global rows, rank 0's block), SDPA over the whole
    # cache as the yardstick; launches per rank on 21a's Dh run and 21b
    main21 = [r for r in dh["21"]["rows"]
              if r["kind"] == "global" and r["dtype"] == "bfloat16"]
    for name in DH_MODES:
        rows21 = [r["modes"][name] for r in main21]
        mean21 = {k: sum(r[k] for r in rows21) / len(rows21)
                  for k in ("ms", "plain_ms", "bound_ms")}
        err = "scores_err" if name.endswith("scores") else "apply_err"
        by_phase = {"21a-dh": dh["21a"]["dh"]["launches"][name],
                    "21b": dh["21b"]["modes"][name]}
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention_decode.cu",
            "replaces": "src/repro/kernels/attention_decode.py:63",
            "launches": sum(by_phase.values()),
            "max_abs_err": max(r[err] for r in dh["21"]["rows"]),
            "ms": mean21["ms"], "plain_ms": mean21["plain_ms"],
            "bound_ms": mean21["bound_ms"],
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows21) else "operations",
            "library_ms": sum(r["library_ms"] for r in main21) / len(main21),
            "shapes": [dict(r["modes"][name], shape=r["shape"],
                            library_ms=r["library_ms"])
                       for r in dh["21"]["rows"]],
            "launches_by_phase": by_phase})
    # the segmented kernels: times at the main path's shapes (the
    # training runs' own buffers); no single PyTorch call computes
    # either pass, so library_ms is null
    for name, replaces in SEG_KERNELS.items():
        t = train[name]
        entries.append({
            "name": name, "route": "cuda", "source": SEG_SOURCE,
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": max(seg["max_abs_err"][name],
                               t.get("rows_abs_err", 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "launches_by_phase": {
                "7": t["launches"],
                "11": adaptive["launches"].get(name, 0),
                "12c": main12["seg_launches"].get(name, 0),
                "12d": pipe["launches"].get(name, 0),
                "12f": prof["launches"].get(name, 0),
                **{k: fam[k][name]["launches"] if name in fam[k] else 0
                   for k in ("13c", "13d", "13e")},
                **{k: cross[k][name]["launches"] if name in cross[k] else 0
                   for k in ("14c", "14d")},
                "14c-stub": cross["14c-stub"].get(name, 0),
                # per rank: every rank of 15 and 15b launches as many
                "15": dp["launches"].get(name, 0),
                "15b": dp["controller_launches"].get(name, 0),
                # per rank, on the rank's blocks
                "18": tt["launches"].get(name, 0),
                "18a": tt["launches_2x2"].get(name, 0),
                **{f"{label}-{arch}": r["launches"].get(name, 0)
                   for (label, arch), r in ft["train"].items()},
                "20b": ep["20b"]["launches"].get(name, 0),
                "21c": dh["21c"]["launches"].get(name, 0),
                # per rank: the split and the unsplit step
                "22": sp["launches"].get(name, 0),
                # the examples: the tree path (use_kernel=False)
                **{k: ex[k][name] for k in ("23", "23a", "23b")}},
            "on_a_ranks_block": tt["seg"]["times"][
                "norm" if "norm" in name else "apply"]})
    # the per-tensor kernels: one launch a step over every kernel
    # segment, timed on 7c's last step (size (a)); no single PyTorch
    # call computes the segments' sums or the trust-scaled momentum
    # apply, so library_ms is null (torch._foreach_norm, the nearest
    # call, gives member norms: foreach_norm_ms beside the norm)
    keep = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "foreach_norm_ms", "segments", "members", "elements")
    for name, replaces in LARS_KERNELS.items():
        t = train[name]
        which = "norm" if "norm" in name else "apply"
        entries.append({
            "name": name, "route": "cuda", "source": LARS_SOURCE,
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": max(lars["max_abs_err"][name],
                               t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "eager_ms": t["eager_ms"],
            "foreach_norm_ms": t["foreach_norm_ms"],
            "sizes": {"a": {k: t[k] for k in keep},
                      **{size: {k: lars["timing"][size][which][k]
                                for k in keep}
                         for size in ("b", "c")}},
            "launches_by_phase": {
                "7c": t["launches"],
                "9": paper_loop["launches"].get(name, 0),
                "10": sharp["kernels"][name]["launches"],
                "11c": paper["launches"].get(name, 0),
                "13d": fam["13d-pt"][name]["launches"],
                "14c": cross["14c-pt"][name]["launches"],
                # per rank, on the rank's blocks
                "18b": tt["launches_pt"][name],
                "19c": ft["probe_launches"].get(name, 0),
                "20b": ep["20b"]["launches_pt"][name],
                "20c": ep["20c"]["probe_launches"].get(name, 0),
                **{k: ex[k][name] for k in ("23", "23a", "23b")}},
            "on_a_ranks_block": {
                k: v for k, v in tt["lars"]["times"][
                    "norm" if "norm" in name else "apply"].items()
                if k != "rows"}})
    # RMSNorm: its path is the public ops.rmsnorm (no model calls it, as
    # in the JAX package); means over the four shapes it was driven at
    m = rmsn["mean"]
    entries.append({
        "name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
        "replaces": RMS_REPLACES, "launches": rmsn["launches"],
        "max_abs_err": rmsn["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in rmsn["rows"]) else "operations",
        "library_ms": m["library_ms"], "shapes": rmsn["rows"]})
    print(f"chip_smoke: total {time.perf_counter() - T_START:.1f} s",
          flush=True)
    print(smi_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
