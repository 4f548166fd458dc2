#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``ntxent_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result:

1. card: its name and power limit;
2. build: every CUDA kernel source in ``ntxent_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together, timed; the registers and
   spill bytes ptxas reports for every kernel it compiled (among them
   the TMA/wgmma #11, #12, #13 and #14 in bf16, at head_dim 64 and
   128, and the TF32 wgmma #1, #4-#10);
2a. data-parallel InfoNCE kernels: ``infonce_dual_fwd_rect`` (#9's
   rectangular stats-only mode), ``infonce_bwd_rows`` (#5's cross-modal
   mode) and ``infonce_bwd_cols`` (#4) against their plain versions at
   (rows, cols, D) = (256, 256, 512) (the path of this run), (64, 256,
   512) (one rank of 4 at batch 256), (1024, 4096, 512) (one rank of 4 at
   batch 4096) and a ragged (101, 1000, 96) with scattered ids and a
   padding row, fp32 and bf16, bitwise repeatable; #9 rectangular, #5
   cross-modal and #4 (TF32 wgmma walks) in fp32 at the first three
   shapes at least 10x below a one-pass TF32 control, their walks' ptxas
   registers and spills printed; CUDA-event times beside the bound; and
   the symmetric ``ntxent_fwd`` re-timed over 200 launches;
2b. the two-pass InfoNCE kernels: ``ntxent_fwd_general`` (#1) and
   ``ntxent_bwd_general_rows`` / ``_cols`` (#6) in their InfoNCE mode
   (``diag_pos``, the logit scale read on the card) against their plain
   versions at (R, C, D) = (256, 256, 512) (the two-pass CLIP path of
   this run), (1024, 4096, 512) (one rank of 4 at batch 4096) and a ragged
   (101, 1000, 96) with scattered ids and a padding row, fp32 and bf16,
   scales 14.3 and 100, within NTX_ATOL scaled to the largest logit,
   bitwise repeatable; in fp32 at least 10x below a one-pass TF32
   control; CUDA-event times beside the bound;
3. kernels: each hand-written kernel against its plain version on the
   card -- ``flash_attention_fwd`` (the ViT-B/16 serving and training
   shapes in bf16 and fp32, causal cases with q_offset != k_offset and
   ragged lengths, head_dim 128; in bf16 at the training shape, over
   four seeds, its rms error against an fp32 truth over the plain
   version's, and that of a control that rounds once more, which must
   miss);
   ``ntxent_fwd`` and ``ntxent_bwd_sym``
   (2N = 512 and 8192 at D = 128, and a ragged 2N = 1000 at D = 96, in
   fp32 and bf16; TF32 tensor-core kernels, held in fp32 at 2N = 512 and
   8192 at least 10x below a TF32 control's lse and gradient errors, their
   walks' ptxas registers and spills printed, timed at 2N = 512 and
   8192); ``flash_attention_dq`` and ``flash_attention_dkv``
   (the training shape in bf16 and fp32 and the causal offset cases, and
   a wholly masked ring hop whose dk and dv must be zero bit for bit; in
   bf16 the TMA/wgmma dQ, over four seeds at the training shape, against
   an fp32 truth as the forward is, its control accumulating dq in bf16;
   and the bf16 dK/dV's dk and dv over the same seeds against an fp32
   truth, over a reference that rounds p and ds to bf16 pairs as the
   kernel does, its control carrying dk and dv in bf16 pairs across
   64-row q tiles)
   --
   ``infonce_dual_fwd`` and ``infonce_dual_bwd`` (N = 256, 1000, 8192 at
   D = 512 and 128, fp32 and bf16, a logit scale of 17.5 passed as a
   device tensor; the loss bitwise repeatable; TF32 wgmma walks, held in
   fp32 at N = 256, 1000 and 8192 (D = 512) at least 10x below a TF32
   control's lse and gradient errors, their walks' ptxas registers and
   spills printed) -- then CUDA-event times
   of each kernel, its plain version and, where one PyTorch call computes
   the same function, that call (a yardstick the port never calls),
   beside the bound;
4. serve: a ViT-B/16 SimCLR embedding server built through
   ``ntxent_tpu_torch.cli``, concurrent ``/embed`` requests over HTTP,
   every answer held against the model's direct forward, the forward
   kernel's launch count per forward chunk, ``/healthz`` and
   ``/metrics``, and a 70-row engine call that chunks through the
   largest bucket;
5. train: ``ntxent-train --model vit_b16 --vit-attention flash
   --image-size 224 --batch 256 --steps 5`` through
   ``ntxent_tpu_torch.cli``: a finite loss every step, parameters that
   moved, exactly 1/1/12/12/12 launches per step of ntxent_fwd,
   ntxent_bwd_sym and the three flash kernels, a nonzero gradient on
   every q/k/v projection; step ms, images/s and peak memory;
6. step parity: one train step of ViT-B/16 (batch 4) on the card against
   the same step on the CPU (the kernels' plain versions) from identical
   weights and views: loss and relative gradient-norm error, in fp32
   within fixed tolerances; the path's bf16 step is printed as a reading
   beside the gap bf16 rounding opens on the CPU itself (the bf16
   kernels' accuracy is gated against an fp32 truth in phases 3 and
   12g);
7. CLIP train: ``ntxent-train --objective clip --model vit_b16
   --vit-attention flash --image-size 224 --batch 256 --steps 5
   --base-lr 5e-4 --warmup-steps 1`` through ``ntxent_tpu_torch.cli``: a
   finite loss every step, parameters that moved, exactly 1/1/12/12/12
   launches per step of infonce_dual_fwd, infonce_dual_bwd and the three
   flash kernels (image tower only: the causal text tower runs plain
   attention) and none of the NT-Xent kernels, a nonzero gradient on the
   logit scale and on every q/k/v projection of both towers; step ms,
   images/s and peak memory;
8. CLIP step parity: one fp32 CLIP ViT-B/16 train step (batch 4) on the
   card against the same step on the CPU, within fixed tolerances;
9. general NT-Xent kernels: ``ntxent_fwd_general`` (#1 in its general
   mode), ``ntxent_bwd_general_rows`` and ``ntxent_bwd_general_cols``
   (#6) against their plain versions at (R, C, D) = (512, 512, 128) (the
   data-parallel path of a world of one at --batch 256), (128, 512, 128)
   (one rank of a world of four, rank 3's row ids), (2048, 8192, 128)
   (one rank of four at global batch 4096) and a ragged (100, 1000, 96)
   with a padding row, in fp32 and bf16, with and without scattered
   column ids; the loss bitwise repeatable; CUDA-event times beside the
   bound;
10. four ranks emulated on one card: the per-rank strip losses and row and
   column gradients of P = 4 at global batch 256, summed and scattered as
   the all-gather's backward does, against the single-card symmetric loss
   and gradient; then four CLIP ranks at global batch 256 (D = 512):
   each rank's rectangular forward, the column lse merged by hand, each
   rank's rows and columns gradients, against the single-card
   ``info_nce_fused`` loss and gradients; then P = 2 and 4 ranks of the
   two-pass loss (``info_nce_partial_fused`` for each direction, as
   ``local_infonce_allgather`` calls it) against the same single-card
   loss and gradients, 2P launches of #1 and #6 rows and columns;
11. data-parallel train: ResNet-50 SimCLR through
   ``cli.train(..., data_parallel=True)`` over a real NCCL process group
   of world size 1 (a ``FileStore``), ``--image-size 224 --batch 256
   --steps 5``: finite losses, exactly 1/1/1 launches per step of the
   general forward and the two general backward kernels and none of any
   other loss or attention kernel, a nonzero gradient on every
   convolution and BatchNorm weight; step ms, images/s, peak memory;
12. device-count parity: one fp32 ResNet-50 step (batch 8) of the
   data-parallel step at world 1 against the single-card step from the
   same weights and views, cuDNN's TF32 off;
12a. data-parallel CLIP train: ``ntxent-train --objective clip --model
   vit_b16 --vit-attention flash --image-size 224 --batch 256 --steps 5``
   through ``cli.train(..., data_parallel=True)`` in the same NCCL group
   of world 1: finite losses, exactly 1/1/1 launches per step of the
   rectangular forward and the rows and columns kernels and 12/12/12 of
   the flash kernels, no other loss kernel, a nonzero gradient on the
   logit scale and every q/k/v weight of both towers; step ms, images/s,
   peak memory;
12b. its parity: one fp32 CLIP ViT-B/16 step (batch 4) of the
   data-parallel step at world 1 against the single-card CLIP step, TF32
   off; then the same CLIP ViT-B/16 at --batch 256 through
   ``make_sharded_clip_train_step(group, loss_impl="twopass")`` for 3
   steps against the "dual" step from the same weights and batches: the
   losses, each parameter's change, and exactly 2/2/2 launches a step of
   #1 and #6 rows and columns, 12/12/12 of the flash kernels and none of
   #4, #5 cross-modal, #9 or #10; step ms of both;
12c. shard-pair kernels: ``block_lse_dual`` (#7) and ``block_grads_dual``
   (#8; TF32 wgmma walks, #9's and #10's) against their plain versions at
   (R, C, D) = (512, 512, 128) (the self tile of the pair path of this
   run), (128, 128, 128) and (2048, 2048, 128) (the k = 1 tile of one rank
   of 4 at global batch 256 and 4096) and a ragged (100, 260, 96) with
   scattered, shared and sentinel ids, fp32 and bf16, bitwise repeatable;
   in fp32 at (512, 512, 128) and (2048, 2048, 128) at least 10x below a
   one-pass TF32 control's lse and gradient errors, their walks' ptxas
   registers and spills printed; CUDA-event times beside the bound;
12d. triangular kernels: ``ntxent_fwd_tri`` (#2, #9's dual walk) and
   ``ntxent_bwd_tri`` (#3, #5's walk with the transposed product; both on
   TF32 wgmma over ``tri_runs``'s plan, whose busiest CTA is printed
   against the mean tiles an SM) against their plain versions and against
   #1 + #5 at 2N = 512, 8192 and 300 (D = 128) and 40 (D = 32), fp32 and
   bf16, the loss and the gradient bitwise repeatable; in fp32 at 2N = 512
   and 8192 at least 10x below a one-pass TF32 control's lse and gradient
   errors, their walks' ptxas registers and spills printed; one
   ``ntxent_loss_fused(..., triangular=True)`` forward and backward
   launching #2 and #3 once each and nothing else; times at 2N = 512, 4096
   (T = 0.07, the reference's ``bench.py`` shape) and 8192 beside #1 +
   #5;
12e. pair ranks emulated on one card: P = 2, 3, 4 and 8 at global batch
   256 (255 for P = 3) through ``parallel.pair``'s per-rank functions,
   the lse shares merged and the gradient buffers summed by hand, against
   the single-card ``ntxent_fwd`` / ``ntxent_bwd_sym``;
12f. data-parallel train with ``--dp-loss pair``: the ResNet-50 command
   of phase 11 plus ``--dp-loss pair`` in the same NCCL group: exactly
   1/1 launches per step of #7 and #8 and none of any other kernel; and
   in phase 12 the world-1 fp32 pair step against the world-1 strip step;
12g. the carried-statistics fold kernel ``flash_fold`` (#12; in bf16 the
   TMA/wgmma walk of #11 with the carry in its register accumulator)
   against its plain version: consecutive folds with a carried state at
   (BH, L, D) = (8, 8192, 64) bf16 non-causal and causal with q_offset
   == k_offset, (8, 4096, 128) fp32 causal with q_offset > k_offset
   (partly masked), and a ragged (4, 1000, 64); after each, a block
   wholly after the rows (q_offset < k_offset) whose carry must come out
   bit for bit, and a control (the last block folded into a fresh carry
   must miss); over four seeds, two bf16 folds at the P = 4 hop (a past
   block, then the causal diagonal) against an fp32 truth, its control
   rounding acc to bf16 between them; at the long-context path's hop (8,
   32768, 64) and the P = 4 hop (8, 8192, 64) against the plain version
   run in row chunks, and times beside the bound, with the dQ and dK/dV
   kernels (#13, #14) there, held against their plain versions run in
   q-row chunks with the true lse and delta (a control without the first
   chunk must miss), and over every 64-row tile of dq and of dk/dv, each
   tile's error held to its own size (controls that leave one tile pair
   out of the heaviest walk must miss), and SDPA's causal forward and
   backward of the same block (the backward is #13's and #14's library
   time at the hop);
12h. ring attention of P = 2, 4, 8 ranks emulated on one card at (B 1, L
   8192, H 8, D 64), bf16 and fp32, causal and not: the flash ring against
   the jnp ring and flash_attention of the whole sequence (out, dq, dk,
   dv), exactly P folds (#12) per rank forward and P dQ and dK/dV hops
   per rank backward, no forward kernel (#11);
12i. the ring NT-Xent of P = 2, 4, 8 ranks emulated at 2N = 8192, D =
   128 (``emulated_ring_ntxent``: the ring's per-hop ``lse_hop`` over #1
   general, ``block_grads`` over #6) against ntxent_loss_fused, P
   launches of each per rank; #6 at the P = 4 hop against its plain
   versions, and its times there;
12j. the long-context path in the NCCL group of world 1:
   ``LongContextTransformer`` (vocabulary 49408, hidden 512, depth 8, 8
   heads, MLP 2048, max_len 32768, bf16) at B 1, L 32768 under
   ``make_ring_attention(group, causal=True, impl="flash")``: three
   forward and backward passes of the probe sum(out^2), host-clock timed,
   each launching exactly 8/8/8 of #12/#13/#14 and nothing else, every
   parameter's gradient finite; the output and gradients against the same
   weights under ``flash_attention`` and under 4 emulated ring ranks; an
   fp32 model at depth 2, L 1024 against the CPU;
12k. in the same group: Ulysses attention at world 1 against
   ``attention_oracle``, the flash ring with two transfer chunks against
   one, ``make_ring_ntxent(group, impl="fused")`` and ``impl="auto"``
   against ``ntxent_loss_fused`` (1/1/1 launches of #1 general and #6
   rows and columns), and the ring InfoNCE (dual and twoblock) against
   ``info_nce_fused``;
12l. wide embeddings (after 12d): every loss kernel #1-#10 in every
   mode (symmetric, general, InfoNCE, triangular, pair, square and
   rectangular InfoNCE, cross-modal) at D = 768, 1000 and 1024 against
   its plain version, fp32 and bf16, at 512 rows (the data-parallel CLIP
   kernels at (64, 256)) and at 2N = 4096 x D = 1024, bitwise
   repeatable, in fp32 against the TF32 control; fp32 times at 2N = 4096
   beside the bound; then the fp32 #11-#14 (the FMA walks) timed at the
   training shape beside their plain versions and bound; and after phase
   5, ``train --proj-dim 1024`` at phase 5's width for 2 steps (1/1
   launches of #1 and #5 a step);
12m. checkpoints (after phase 8, in a temporary directory): ViT-B/16
   SimCLR at phase 5's width, 6 steps with a save every 2 against 2
   steps with ``--async-ckpt`` relaunched to 6, equal by the manifests'
   CRC32 at steps 4 and 6, with save, async blocked and restore ms;
   ``build_server --ckpt-dir`` at that directory embedding as the trained
   model does; ``python -m ntxent_tpu_torch.cli train`` as a child,
   SIGTERM after its step-2 line: exit 0, the stopped step the newest
   valid one, and the relaunch at the uninterrupted step-6 CRC; CLIP
   ViT-B/16 and (after 12) data-parallel ResNet-50 at world 1 resumed
   (1 + 1 steps against 2, CRC for CRC);
12n. training resilience (after 12m, in its temporary directory): [guard]
   a guarded SimCLR ViT-B/16 step at scale 1 equal bit for bit to the
   plain step (params CRC), a NaN batch leaving parameters, momentum,
   count and running statistics bit for bit with the step advanced and
   step_ok false, 3 guarded steps back to back against 3 plain ones (the
   per-step sync's ms), 1/1/12/12/12 launches a step for both, and
   ``train --nan-policy backoff --chaos nan@2,nan@3 --steps 5`` backing
   off to scale 0.5 with finite parameters; [remat] 2 SimCLR steps with
   ``--remat`` against the plain ones (loss and params equal, or within
   1e-6 of their largest magnitude; #11 24 a step, the rest unchanged;
   step ms and peak memory of both) and (after 12) data-parallel
   ResNet-50 at world 1 with ``--remat`` (the running statistics as the
   plain run's); [accum] SimCLR and CLIP ViT-B/16 ``--accum-steps 2``, 1
   step saved mid-accumulation and relaunched to 2, equal to the
   uninterrupted run by the state's CRC32; [supervise] run A's flags
   with ``--max-restarts 1 --chaos crash@5,truncate@1``: a crash, a
   restore past the truncated step 4 to step 2, run A's step-6 CRC;
   [crash-audit] ``resilience.crashsim.CrashAudit`` of the single-card
   ResNet-50 path at 224 px and batch 256 (children of ``python -m
   ntxent_tpu_torch.cli train``, one at a time), 4 steps: a SIGKILL
   inside a save, no torn step, the survivor's final checkpoint equal to the
   reference run's;
12o. the input pipeline and evaluation (after 12n, in its temporary
   directory): [data] a uint8 npy row store of (1280, 224, 224, 3) written
   from a seed; the native and the threaded loader give the same first 6
   batches byte for byte across the epoch boundary; ViT-B/16 SimCLR at
   phase 5's width trained 6 steps from the store with --loader python,
   --loader native, and --loader native --prefetch 2 --lag-metrics
   --nan-policy skip --ckpt-dir: one state CRC32, 1/1/12/12/12 launches a
   step each, step ms, data wait ms a step and images/s of each;
   [data-lag] the plain loop, the synchronous guard and the lag-1 guard
   timed in rounds of 6 steps, ending equal; [data-lag-nan] a --chaos NaN
   batch under the third way ends bit for bit where the same run without
   --lag-metrics ends, the guard naming the step; [eval] ntxent-eval on
   the third way's checkpoint: the flash forward's features against the
   plain attention forward's on the card, --protocol both, --protocol
   finetune (12/12/12 of #11/#13/#14 a step, a finite loss), and CLIP
   ViT-B/16 zero-shot on [resume-clip]'s checkpoint; [data-imagefolder]
   512 PNGs of 256x320 in 4 class folders, 4 steps with --prefetch 0 and
   2, the data wait a step;
12p. serving completeness and the lag-1 guard under accumulation (after
   [serve-ckpt], on run A's checkpoint directory): [serve-int8] the
   float32 and the int8 rung of the same ViT-B/16 weights on the same
   rows: per-row cosine drift under 0.05, 12 #11 launches a chunk, the
   bytes a 64-row chunk moves to the card, chunk ms and the host
   quantization's ms; [serve-ladder] ``--adaptive-buckets`` driven by
   requests of 5-9 and 20-40 rows, a ``refresh_ladder()`` while batcher
   and HTTP clients are in flight: every answer within EMBED_ATOL of the
   direct forward, no request-path first run across the swap, the
   padding share down, both ladders printed; [serve-worker] the serve
   entry point (``cli.serve_main``) with ``--port-file --watch-ckpt
   --max-restarts 1 --stall-timeout 5 --log-jsonl --run-id smoke`` on a
   copy of run A's first kept step: /readyz 503 while warming, the newer
   step adopted and followed by X-Checkpoint-Step and the embeddings,
   ``POST /rollback``, a device call held past the timeout (/healthz
   "stalled", a restart, 200 again), latency p50/p99, the four spans of
   every request and their valid Chrome trace, serving_run_info in the
   Prometheus text; [accum-lag] ``--accum-steps 2 --lag-metrics
   --nan-policy skip`` with a NaN micro-batch ends at the synchronous
   guard's CRC32 (and the device fold equals ``step()``'s), and both
   guards under --accum-steps 2 timed in turns on batches on the card;
   [fleet] (after [serve-worker], on a watched copy of run A's steps)
   ``python -m ntxent_tpu_torch.fleet_cli`` as a subprocess over three of
   the port's serve workers at phase 4's width, with the shadow mirror,
   federation, SLOs, the history spill, the autoscaler and ``--chaos
   killworker,drainworker``, four clients of 1-8 rows from a pool of 48:
   every answer 200 or 429 and within EMBED_ATOL of a step's direct
   forward, cache-only answers bit for bit a worker's, the promote's
   flush and warm, w0 SIGKILLed and restarted, w2 drained to zero in
   flight then retired, run A's newer step canaried on w0, shadow-diffed
   and promoted, a step with the projection's last layer negated rolled
   back on the drift bar and blocked on both workers, ``/metrics/fleet``,
   ``/alerts``, ``/metrics/history`` and its spill, a SIGTERM exiting 0
   with no worker left, one merged Chrome trace of the router's and the
   workers' logs, and #11's launches in every worker that exited cleanly;
   in the same run the retrieval tier (``--index-mem``, two supervised
   shard processes with a journal, ``--chaos killshard``): a client
   storing 48 rows of its own, which no other client sends (the cache
   holds what the tier embeds), through ``/index/insert`` and
   ``/embed?store=true``
   and searching them (k 5), every answer 200 or 429, an insert gated
   (stored 0, not_trusted) only in a rollout window, each search on a
   whole plane the brute-force top k of its step's direct forward over
   the stored rows (the row itself first), the promote's version rebuilt
   from the docstore and every later search on the promoted step, the
   drift rollback's stale mark and rebuild, searches 200 and degraded
   while shard 0 is down, the shard back on its port, the journal's
   debt redelivered, every stored row its own first hit again (and at
   the end), ``retrieval_shard_up`` in ``/metrics/history``, no libtorch
   mapped by the router or a shard; [retrieval-scale] (host only) the
   port's ``VectorIndex`` at 524,288 rows of width 128 (``bench.py``'s
   corpus and settings, its rows cut from 4.1 M): recall@10 >= 0.95
   against brute force, at most 64 bytes a row scanned, build rows/s,
   quiet and concurrent search p50/p99, brute force p50, resident MB, and
   ``bench.py``'s repair arm on the port's shard plane;
12q. the data-parallel wire (in the NCCL group of world 1, after 12):
   [dp-chunked] phase 11's command with ``--dp-loss chunked --ring-chunks
   4``: finite losses, exactly 4/4/4 launches a step of #1 general and #6
   rows and columns (one a chunk) and none of any other kernel, every
   weight's gradient nonzero, step ms, and the ``--measure-overlap`` A/B
   (``measure_comms_overlap``: the strip against the chunked loss at
   phase 11's rows); [dp-chunked-parity] the fp32 world-1 chunked step
   against the world-1 strip step at phase 12's tolerances;
   [chunked-emulated] P = 4 ranks of the chunked ring emulated at 2N =
   8192, D = 128, 4 chunks a hop, against ntxent_loss_fused within
   EMULATED_LOSS_ATOL and EMULATED_GRAD_RTOL, P * P * 4 launches of #1 and
   of #6 rows and columns, and #1's and #6's times at one chunk of the P =
   4 hop; [wire] phase 11's command under ``--collective-dtype bf16`` and
   ``int8``, and with ``--dp-loss pair`` under int8: the strip's 1/1/1
   launches a step (the pair's 1/1), every loss within WIRE_LOSS_ATOL of
   phase 11's float32 run, the int8 residual nonzero,
   ``quantize_int8`` on the card equal to the CPU's bit for bit, the
   collective series by wire dtype (bytes 0 at world 1: the ring model),
   step ms against phase 11's; [wire-clip] data-parallel CLIP ViT-B/16
   under int8 for 2 steps (1/1/1 of #9 rectangular, #5 cross-modal and #4,
   12/12/12 of the flash kernels a step, the residual nonzero);
   [resume-ef] phase 11's command under int8 with ``--ckpt-save-ef``,
   1 + 1 steps against 2, CRC for CRC with the residual in the state;
12r. train-side telemetry and the space-to-depth stem (after 12o, in its
   temporary directory): [obs-train] phase 5's command for 16 steps with
   ``--metrics-port 0 --log-jsonl --trace-dir`` (the trigger and the
   capture need the room): /metrics scraped mid-run
   in JSON and Prometheus text (``train_steps_total``,
   ``train_step_device_ms``, ``train_mfu`` in (0, 1)), every ``step``
   event with data wait, device ms, steps/s and an MFU in (0, 1) from step
   1's counted FLOPs, ``losses_from_jsonl`` equal to the logged losses,
   ``touch TRIGGER`` giving a ``torch.profiler`` Chrome trace whose CUDA
   kernels include #1's, #5's and #11-#14's walks, ``python -m
   ntxent_tpu_torch.obs.trace`` exporting a step slice a step, 1/1/12/12/12
   launches a step; then rounds of 6 train_loop steps timing the plain
   loop, the timeline's synchronous path and the timeline under
   ``--lag-metrics``; [stem] ResNet-50 at 224 px and batch 256 with
   ``--stem space_to_depth`` and ``--stem conv`` from the same weights, 4
   steps each with ``--log-jsonl``: the first step's losses within 1e-2,
   #1/#5 1/1 a step, step ms and MFU of both; and in 12n's [supervise] a
   stall: phase 5's command for 6 steps with ``--max-restarts 1
   --stall-timeout 5 --log-jsonl`` and no checkpoints, batch 3 held 7 s:
   the escalation's flight dump holds the run's step events before it,
   one ``restart`` event, the restart trains to step 6;
12s. static analysis (in the NCCL group of world 1, after 12's
   [dp-parity]): [audit] the port's ``ntxent-audit`` on the card, no
   model built: the collective census (``analysis.graph.census``, a
   dispatch mode over every ``c10d`` op) of ``dist_loss/fwd`` and
   ``dist_loss/grad`` at B = 256, D = 128 float32 (#1 general and #6 rows
   and columns launched), every declared forward call seen per wire op,
   the backward's ``reduce_scatter_tensor`` seen on autograd's device
   thread, ``grad_reduce/int8`` and ``/bf16`` free of wire-dtype findings
   over NCCL, the ``donation`` analyzer clean on a CUDA state after one
   in-place step; calls and bytes per op (0 bytes at world 1, the ring
   model); and in 12r's [obs-train] the scrape holds
   ``collective_graph_bytes_total{source="ad"}`` (step 1 ran under the
   census) and step 1's wall time with and without the census;
13. one JSON line describing each kernel of the paths (with each loss
   kernel's D = 1024 times and each flash kernel's fp32 times, and #11's
   launches on the int8, adaptive-ladder and worker serve paths), after
   a line with the whole script's time;
14. the last line: ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --truth`` runs phases 1 and 2 and then prints the
four bf16 kernels' fp32-truth readings (#11, #13, #12, #14's dk and dv)
and the per-tile readings of #13 and #14 at the two hops of 12g, without
gating them: run over the kernels a change replaces, they are the
readings a gate's factor or tolerance is set between.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, the bf16
# tensor-core rate and the fastest fp32-accurate product: three TF32
# passes (3xTF32, hi.hi + hi.lo + lo.hi) at the 495 TFLOP/s TF32 rate.
# The 67 TFLOP/s CUDA-core fp32 rate is no least time: #1 and #5 run on
# the tensor cores in 3xTF32 and would read above 100% of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 495e12 / 3

# Serving shape of ViT-B/16 at bucket 64: B=64, L=197, H=12, D=64.
SERVE_SHAPE = dict(b=64, lq=197, lk=197, h=12, d=64)
# Training shape of ViT-B/16 at --batch 256: both views, B=512.
TRAIN_SHAPE = dict(b=512, lq=197, lk=197, h=12, d=64)
# (name, shape, dtype, causal, q_offset, k_offset)
KERNEL_CASES = [
    ("serve_bf16", SERVE_SHAPE, "bfloat16", False, 0, 0),
    ("serve_fp32", SERVE_SHAPE, "float32", False, 0, 0),
    ("train_bf16", TRAIN_SHAPE, "bfloat16", False, 0, 0),
    ("causal_bf16", dict(b=2, lq=100, lk=300, h=4, d=64), "bfloat16", True,
     0, 37),
    ("causal_fp32", dict(b=2, lq=100, lk=300, h=4, d=64), "float32", True,
     150, 20),
    ("d128_bf16", dict(b=4, lq=197, lk=197, h=8, d=128), "bfloat16", False,
     0, 0),
    ("d128_fp32", dict(b=4, lq=197, lk=197, h=8, d=128), "float32", False,
     0, 0),
]
# Tolerances (max abs error against the plain version on the same card).
# o in bf16: p is rounded to bf16 at the kernel's running max rather than
# the final one, and o itself is rounded to bf16 (one ulp is 2**-8
# relative) -> 2e-2. o in fp32: only the summation order differs -> 1e-4.
# lse is fp32 in both dtypes, built from the same exactly-multiplied
# inputs -> 1e-3.
O_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_ATOL = 1e-3
# The bf16 forward against an fp32 truth (the fp32 softmax of the same
# bf16 inputs, p never rounded) at the training shape, over seeds: its
# rms error over the plain version's. On the H100 the kernel read
# 0.9821-0.9822 over these seeds (it rounds p at a running maximum, the
# plain version at the final one) and a control that rounds acc to bf16
# once more before the division 1.2554-1.2556; the factor sits between
# them, near their geometric mean -> 1.1, and the control must exceed it.
TRUTH_SEEDS = (101, 102, 103, 104)
TRUTH_RMS_FACTOR = 1.1
# dQ (#13) and the fold (#12) against an fp32 truth in the same way, each
# over TRUTH_SEEDS: the same bf16 inputs through fp32 arithmetic with
# nothing rounded (p, ds and P in fp32). dQ at the training shape, from
# the plain forward's lse and delta; its control accumulates the plain
# dq in bf16 across 64-key tiles. The fold: two consecutive folds at the
# P = 4 hop (FOLD_TRUTH_SHAPE), a whole block of the past and then the
# causal diagonal block (q_offset == k_offset), normalized to acc / l;
# its control rounds acc to bf16 between the two folds. On the H100 the
# WMMA kernels these replaced read: dQ 1.00000 over the four seeds (it
# rounds ds as the plain version does), its control 1.9604-1.9618; the
# fold 0.9834-0.9844 (p rounded at a 64-key tile's running maximum), its
# control 1.3140-1.3253. Each factor sits between its two readings, near
# their geometric mean.
DQ_TRUTH_RMS_FACTOR = 1.4
FOLD_TRUTH_RMS_FACTOR = 1.14
FOLD_TRUTH_SHAPE = (8, 8192, 64)
# dK/dV (#14) against an fp32 truth at the training shape, each of dk and
# dv over TRUTH_SEEDS: the plain version itself (p and ds in fp32, nothing
# rounded), from the plain forward's lse and delta. The kernel keeps p
# and ds as bf16 pairs hi = bf16(x), lo = bf16(x - hi) (about 16 bits), so
# the reference is that rounding in plain arithmetic (p and ds rounded to
# the pairs, the products and sums in fp32), and the control rounds the
# running dk and dv to the same pairs after each 64-row q tile (a kernel
# that carried its sums in bf16 pairs). On the H100 the kernel as it
# stands (PR 8's TMA/wgmma #14) read, over the four seeds, dk 1.03995-
# 1.04006 and dv 1.02852-1.02861, the controls dk 1.97771-1.98016 and dv
# 1.97587-1.97804 (`chip_smoke.py --truth`). The factor sits between the
# two readings, near their geometric mean (1.43), as DQ_TRUTH_RMS_FACTOR.
DKV_TRUTH_RMS_FACTOR = 1.4
# Embeddings are unit vectors computed in bf16: batching and padding may
# change the GEMM shapes and so the rounding, never more than this.
EMBED_ATOL = 2e-2
# NT-Xent kernels against their plain versions: the same fp32 products
# (bf16 inputs are exact in fp32) summed in another order, logits up to
# 1/T = 10 -> 2e-4 on lse, loss_sum/2N and grad.
NTX_ATOL = 2e-4
# (2N, D): the path's shape, the north-star global batch 4096, and a
# ragged 2N with D != 2B.
NTX_SHAPES = [(512, 128), (8192, 128), (1000, 96)]
NTX_TEMPERATURE = 0.1
# The TF32 control of #1 and #5 at the first two NTX_SHAPES in fp32: the
# plain versions on z rounded to TF32 once (one TF32 pass, tf32_split's
# hi). The kernels' lse and gradient errors must lie this factor below
# the control's: a kernel that dropped a lo product would sit at the
# control's error, within NTX_ATOL.
TF32_CONTROL_FACTOR = 10
# Flash backward against its plain version. fp32: summation order only
# -> 1e-4. bf16: ds is rounded to bf16 before ds . K on both sides, and a
# one-ulp flip of a rounded ds between the two summation orders moves dq
# by up to 2**-8 |ds| |k| -> 3e-2 on dq; dk/dv keep p and ds to ~16 bits
# (the kernel's hi/lo split) against the plain version's fp32 -> 1e-2.
BWD_ATOL = {"bfloat16": dict(dq=3e-2, dkv=1e-2),
            "float32": dict(dq=1e-4, dkv=1e-4)}
BWD_CASES = [
    ("train_bf16", TRAIN_SHAPE, "bfloat16", False, 0, 0),
    ("train_fp32", TRAIN_SHAPE, "float32", False, 0, 0),
    ("causal_bf16", dict(b=2, lq=100, lk=300, h=4, d=64), "bfloat16", True,
     0, 37),
    ("causal_fp32", dict(b=2, lq=100, lk=300, h=4, d=64), "float32", True,
     150, 20),
]

# InfoNCE kernels against their plain versions. The same exact fp32
# products (bf16 inputs are exact in fp32) summed in another order, logits
# up to the scale 17.5 -> 2e-4 on lse_a, lse_b and loss_sum/2N; rows of G
# sum to at most 4 in absolute value over unit-norm embeddings -> 2e-4 on
# o_a and o_b.
INFONCE_ATOL = 2e-4
# (N, D): the CLIP path's shape (batch 256, embedding 512), a ragged N,
# N = 8192, each also at D = 128.
INFONCE_SHAPES = [(256, 512), (1000, 512), (8192, 512), (256, 128),
                  (1000, 128), (8192, 128)]
INFONCE_SCALE = 17.5  # not 1/T of the default temperature
INFONCE_TIMED_N = (256, 8192)

TRAIN_STEPS = 4
TRAIN_ARGV = ["--model", "vit_b16", "--vit-attention", "flash",
              "--image-size", "224", "--batch", "256", "--steps",
              str(TRAIN_STEPS), "--dataset", "synthetic", "--device", "cuda",
              "--log-every", "1"]
# Kernel launches per train step: the loss forward and backward once, each
# of the 12 blocks' attention forward, dQ and dK/dV once.
STEP_LAUNCHES = {"ntxent_fwd": 1, "ntxent_bwd_sym": 1,
                 "flash_attention_fwd": 12, "flash_attention_dq": 12,
                 "flash_attention_dkv": 12}
# Card vs CPU, one step of ViT-B/16 from the same weights and views.
# fp32: both sides compute in fp32 (FMA kernels, no TF32) and differ by
# summation order only, amplified through 12 blocks, the projection head
# and the loss's gradient -> 1e-4 on the loss, 1e-2 on the relative
# gradient norm. bf16, the path's dtype, is a printed reading and no
# gate: at initialization the embeddings of random images nearly coincide
# (loss ~ log(2B - 1)), so the loss and its gradient are made of
# differences between embeddings of the size of bf16 rounding, which the
# two devices round in other places (on one CPU the bf16 step's loss
# moves by 0.2 with the thread count alone), and kernels of one accuracy
# fell on both sides of any limit on it. The bf16 kernels' accuracy is
# held by their fp32-truth gates (TRUTH_GATES) instead.
PARITY_BATCH = 4
PARITY_LOSS_ATOL = 1e-4
PARITY_GRAD_RTOL = 1e-2

CLIP_STEPS = 4
CLIP_ARGV = ["--objective", "clip", "--model", "vit_b16", "--vit-attention",
             "flash", "--image-size", "224", "--batch", "256", "--steps",
             str(CLIP_STEPS), "--base-lr", "5e-4", "--warmup-steps", "1",
             "--device", "cuda", "--log-every", "1"]
# Kernel launches per CLIP step: the loss forward and backward once (each
# kernel covers both directions in one launch), each of the image tower's
# 12 blocks' attention forward, dQ and dK/dV once.
CLIP_STEP_LAUNCHES = {"infonce_dual_fwd": 1, "infonce_dual_bwd": 1,
                      "flash_attention_fwd": 12, "flash_attention_dq": 12,
                      "flash_attention_dkv": 12}
# Card vs CPU, one fp32 CLIP step from the same weights, images and
# tokens: summation order only, through 12 blocks of each tower, the
# projections and the loss -> the SimCLR step's fp32 tolerances.
CLIP_PARITY_BATCH = 4

# General NT-Xent kernels (#1 general mode, #6): (R, C, D). The first is
# the data-parallel path of this run (a world of one at --batch 256, every
# row a local row), the second one rank of a 4-card world at global batch
# 256, the third one rank of four at global batch 4096, the last ragged
# with a padding row (R odd) and D != 2B. Tolerances: those of the
# symmetric kernels (NTX_ATOL), for the same reasons.
GENERAL_SHAPES = [(512, 512, 128), (128, 512, 128), (2048, 8192, 128),
                  (101, 1000, 96)]
# Four ranks on one card: P = 4 strips of global batch 256 (2N = 512,
# D = 128) against the single-card loss: the same terms summed in another
# order -> 1e-5 on the mean loss, 1e-4 on the relative gradient.
EMULATED_RANKS, EMULATED_BATCH = 4, 256
EMULATED_LOSS_ATOL, EMULATED_GRAD_RTOL = 1e-5, 1e-4

DP_STEPS = 4
DP_ARGV = ["--model", "resnet50", "--image-size", "224", "--batch", "256",
           "--steps", str(DP_STEPS), "--dataset", "synthetic", "--device",
           "cuda", "--log-every", "1"]
# Kernel launches per data-parallel step: the strip loss's forward and
# its two backward kernels once; nothing else.
DP_STEP_LAUNCHES = {"ntxent_fwd_general": 1, "ntxent_bwd_general_rows": 1,
                    "ntxent_bwd_general_cols": 1}
# World-1 data-parallel step vs the single-card step, fp32 ResNet-50:
# the strip loss against the symmetric one (another summation order) and
# the cross-replica BatchNorm's all-reduces at world 1 -> the fp32 train
# parity tolerances.
DP_PARITY_BATCH = 8
# Queue A 3(d), the chunked ring-overlap loss at world 1: the rank's 2n =
# 512 rows fold as DP_CHUNKS chunks (no hop at world 1), so a step
# launches #1 general and #6 rows and columns once a chunk.
DP_CHUNKS = 4
DP_CHUNKED_ARGV = DP_ARGV + ["--dp-loss", "chunked", "--ring-chunks",
                             str(DP_CHUNKS)]
DP_CHUNKED_STEP_LAUNCHES = {n: DP_CHUNKS for n in DP_STEP_LAUNCHES}
# The chunked ring of P ranks emulated on one card (2N, D, P, chunks):
# EMULATED_LOSS_ATOL and EMULATED_GRAD_RTOL against ntxent_loss_fused.
CHUNKED_EMULATED = (8192, 128, 4, 4)
# Queue A 3(e), the wire: phase 11's command under each dtype. At world 1
# the all-gather moves the rank's own rows through the wire's rounding
# (bf16: 2^-9 relative; int8: half of amax / 127 a row), the losses at
# the JAX default's warmup lr stay within WIRE_LOSS_ATOL of float32's.
WIRE_RUNS = (("bf16", "strip"), ("int8", "strip"), ("int8", "pair"))
WIRE_LOSS_ATOL = 5e-2
WIRE_CLIP_STEPS = 2

# Data-parallel CLIP kernels (#9 rectangular, #5 cross-modal, #4): (rows,
# cols, D) of one rank's za rows against the gathered zb. A world of one
# at --batch 256 (the path of this run), one rank of 4 at batch 256, one
# rank of 4 at a global batch of 4096 (where the TPU package's backward
# takes its two-kernel fallback), and a ragged shape with scattered row
# ids and a padding row (id = cols). Tolerances: INFONCE_ATOL, for its
# reasons (the same exact products summed in another order).
DP_CLIP_SHAPES = [(256, 256, 512), (64, 256, 512), (1024, 4096, 512),
                  (101, 1000, 96)]
DP_CLIP_SCALE = 1 / 0.07  # CLIP's initial exp(logit_scale)
# Four ranks of a world of 4 on one card at global batch 256 (D = 512):
# the merged partial losses and gradients against the single-card
# info_nce_fused: the same terms summed in another order -> 1e-5 on the
# mean loss, 1e-4 on each relative gradient.
DP_CLIP_LOSS_ATOL, DP_CLIP_GRAD_RTOL = 1e-5, 1e-4
CLIP_DP_STEPS = 4
CLIP_DP_ARGV = ["--objective", "clip", "--model", "vit_b16",
                "--vit-attention", "flash", "--image-size", "224", "--batch",
                "256", "--steps", str(CLIP_DP_STEPS), "--base-lr", "5e-4",
                "--warmup-steps", "1", "--device", "cuda", "--log-every",
                "1"]
# Kernel launches per data-parallel CLIP step: the rectangular forward and
# the two backward kernels once, the image tower's flash kernels 12 times;
# no other loss kernel.
CLIP_DP_STEP_LAUNCHES = {"infonce_dual_fwd_rect": 1, "infonce_bwd_rows": 1,
                         "infonce_bwd_cols": 1, "flash_attention_fwd": 12,
                         "flash_attention_dq": 12, "flash_attention_dkv": 12}
# The two-pass data-parallel InfoNCE (loss_impl="twopass"): #1 and #6 in
# their InfoNCE mode (diag_pos: the diagonal is the positive and is not
# masked; a logit scale read on the device). (R, C, D): a world of one at
# CLIP's --batch 256 (embedding 512, the path of this run), one rank of 4
# at a global batch of 4096, and a ragged shape with scattered row ids and
# a padding row (id = C). Scales: CLIP's initial exp(logit_scale) (1 /
# 0.07, 14.3) and its cap (100).
TWOPASS_SHAPES = [(256, 256, 512), (1024, 4096, 512), (101, 1000, 96)]
TWOPASS_SCALES = (14.3, 100.0)


def _twopass_atol(scale: float) -> float:
    """NTX_ATOL holds the kernels to their plain versions at logits up to
    1/T = 10; an error of the products grows with the logits, which reach
    the scale here: NTX_ATOL * max(1, scale / 10) on lse, loss_sum/R and
    both gradients (2.9e-4 at 14.3, 2e-3 at 100)."""
    return NTX_ATOL * max(1.0, scale / 10)


# Ranks of the two-pass loss emulated on one card at global batch 256 (D =
# 512): the summed partial losses and the gradients of za, zb and the
# scale against the single-card info_nce_fused, at DP_CLIP_LOSS_ATOL and
# DP_CLIP_GRAD_RTOL (the same terms summed in another order).
TWOPASS_WORLDS = (2, 4)
# The full-width CLIP ViT-B/16 step with loss_impl="twopass" over the NCCL
# group of world 1 at --batch 256, against the "dual" step from the same
# weights and batches: step 1 runs at the warmup's lr of 0, steps 2-3
# train. Launches a step: #1 and #6 rows and columns twice (once for each
# direction), the image tower's flash kernels as the dual step launches
# them, and no other loss kernel.
TWOPASS_STEPS = 3
TWOPASS_STEP_LAUNCHES = {"ntxent_fwd_general": 2,
                         "ntxent_bwd_general_rows": 2,
                         "ntxent_bwd_general_cols": 2,
                         "flash_attention_fwd": 12, "flash_attention_dq": 12,
                         "flash_attention_dkv": 12}
# The two steps differ only in the loss kernels (the same fp32 embeddings
# into other kernels, summed in another order: ~1e-6 on a mean loss of
# ~log 256): each step's loss within PARITY_LOSS_ATOL, in the path's bf16
# towers and in fp32 ones. The parameters are held in fp32 (TF32 off), as
# every step parity of this script is: each parameter's change over the
# steps within PARITY_GRAD_RTOL of the dual step's. In the bf16 towers
# they are a printed reading and no gate: AdamW divides each gradient by
# its own root mean square, so where a weight's gradient at
# initialization is of the size of bf16 rounding (the attention queries
# of a late block: the keys nearly coincide) the ulp that the cast into
# the bf16 backward flips becomes a change of up to the lr (the first
# card run read 0.16 of a query weight's change). The attention key
# biases have a gradient of 0 in exact arithmetic (test_torch_clip_dp.py),
# so both updates are AdamW steps of rounding noise: they are held to
# AdamW's step bound, 2 lr an entry per training step, not to each other.
TWOPASS_LR = 5e-4

# The symmetric ntxent_fwd re-timed beside the data-parallel InfoNCE
# kernels over more launches than the other timings: ten launches of a
# ~0.1 ms kernel do not separate its modes' times.
SYM_RETIME_RUNS = 200

# Shard-pair kernels (#7 block_lse_dual, #8 block_grads_dual): (R, C, D,
# world) of one tile. The self tile of a world of one at --batch 256 (the
# data-parallel pair path of this run, k = 0), the k = 1 tile of rank 0
# of a world of 4 at global batch 256 ("r4") and 4096 ("r4/4096"), and a
# ragged tile (world None) with scattered ids, ids shared by rows and
# columns (self entries) and sentinel rows and columns. Tolerance:
# NTX_ATOL, for its reasons (the same exact products summed in another
# order).
PAIR_CASES = [(512, 512, 128, 1), (128, 128, 128, 4), (2048, 2048, 128, 4),
              (100, 260, 96, None)]
# Pair ranks emulated on one card one after another, their lse shares
# merged as the pmax and psum do and their gradient buffers summed as the
# psum does, against the single-card symmetric kernels: P = 2, 3, 4, 8 at
# global batch 256 (255 for P = 3, which 256 does not divide), D = 128.
# Tolerances: EMULATED_LOSS_ATOL and EMULATED_GRAD_RTOL.
PAIR_WORLDS = (2, 3, 4, 8)
DP_PAIR_ARGV = DP_ARGV + ["--dp-loss", "pair"]
# Kernel launches per data-parallel pair step at world 1: the self tile's
# dual stats and dual gradients once each; nothing else.
DP_PAIR_STEP_LAUNCHES = {"block_lse_dual": 1, "block_grads_dual": 1}
# Triangular kernels (#2 ntxent_fwd_tri, #3 ntxent_bwd_tri): (2N, D), the
# symmetric path's shape, the north-star global batch 4096, a 2N that is
# no multiple of the 64-row tile, and N < 64 (both views in one tile).
# Against their plain versions at NTX_ATOL; against the rectangular
# kernels (#1 + #5) on the same input, the loss within TRI_LOSS_RTOL (the
# same terms summed in another order). The first two also against the
# TF32 control (TF32_CONTROL_FACTOR), in fp32.
TRI_SHAPES = [(512, 128), (8192, 128), (300, 128), (40, 32)]
TRI_LOSS_RTOL = 1e-5
# Launches of one ntxent_loss_fused(..., triangular=True) forward and
# backward: #2 and #3 once each, nothing else.
TRI_LAUNCHES = {"ntxent_fwd_tri": 1, "ntxent_bwd_tri": 1}

# Wide embeddings (D > 512: CLIP ViT-L/14's 768, ViT-H/14's 1024, and a D
# that is no multiple of 32): every loss kernel #1-#10 in every mode
# against its plain version in fp32 and bf16, bitwise repeatable, at a
# small shape (WIDE_SMALL rows and columns; the data-parallel CLIP
# kernels at one rank of 4, WIDE_DP_CLIP_SMALL) and at WIDE_LARGE (2N =
# 4096 rows and columns at D = 1024); in fp32 at every shape at least
# TF32_CONTROL_FACTOR below one TF32 pass (a forward whose error is
# within WIDE_LSE_ULPS fp32 ulps of its largest output passes that gate
# too: its outputs' own rounding, which no walk can undercut, while one
# TF32 pass's lse error shrinks as sqrt(D) averages its rounding out --
# 7x at D = 1024; the gradients keep the factor with room); fp32 times at
# WIDE_LARGE beside the bound. Tolerances: each kernel's own phase's (the
# same exact products, more of them in each fp32 sum).
WIDE_DIMS = (768, 1000, 1024)
WIDE_SMALL = 512
WIDE_LARGE = (4096, 1024)
WIDE_DP_CLIP_SMALL = (64, 256)
WIDE_TWOPASS_SCALE = 14.3
WIDE_LSE_ULPS = 4
# ``train --proj-dim 1024`` at TRAIN_ARGV's width for this many steps: the
# symmetric #1 and #5 at (512, 1024) on the path.
WIDE_TRAIN_STEPS = 2
WIDE_PROJ_DIM = 1024

# Checkpoints and resume at the paths' full width (the JAX package's
# on-disk format, written under a temporary directory, at most
# RESUME_KEEP steps kept). SimCLR (TRAIN_ARGV): run A trains RESUME_STEPS
# steps saving every RESUME_EVERY; run B trains RESUME_FIRST steps with
# --async-ckpt and a relaunch of the same command resumes it to
# RESUME_STEPS; steps 4 and 6 of B must equal A's by the manifests' CRC32
# of state.msgpack (the loss kernels and the flash kernels are bitwise
# repeatable: fixed-order sums, no atomics). Preemption: the CLI as a
# child with --async-ckpt, SIGTERM after its "step PREEMPT_AFTER" line:
# exit 0, the newest valid step the one it stopped at, and a relaunch
# ends at A's step-6 CRC. CLIP (CLIP_ARGV) and data-parallel ResNet-50
# (DP_ARGV, NCCL world 1): PAIR_FIRST + 1 steps against PAIR_STEPS
# uninterrupted, CRC for CRC. Serving: build_server with --ckpt-dir at
# A's directory embeds a fixed batch as A's step-6 model does in eval
# mode (EMBED_ATOL: the serve path's bf16 tolerance).
RESUME_STEPS, RESUME_EVERY, RESUME_KEEP, RESUME_FIRST = 6, 2, 2, 2
PREEMPT_AFTER = 2
PAIR_STEPS, PAIR_FIRST = 2, 1
CHILD_TIMEOUT_S = 420

# Training resilience, at the SimCLR path's width (TRAIN_ARGV) unless
# named. Guard: a guarded step at scale 1 and the plain step from the same
# state and batch are equal bit for bit; a NaN batch leaves the
# parameters, the momentum, the count and the running statistics bit for
# bit, advances the step and reports step_ok false; rounds of
# GUARD_TIMED_STEPS steps back to back, plain and guarded in the order
# GUARD_ROUNDS (the plain ones queue without a host sync), time the
# guard's per-step sync; then the CLI with GUARD_CHAOS backs off to scale
# 0.5 and ends finite. Remat: REMAT_STEPS steps with --remat against the
# plain step from the same state and batches, each timed (the first
# holds first-call costs); the loss and parameters equal, or (should
# cuBLAS pick another algorithm for the recompute) within REMAT_RTOL of
# the largest magnitude; the recompute runs the attention forward again
# (REMAT_STEP_LAUNCHES). The data-parallel ResNet-50 (DP_ARGV at world
# 1) --remat for REMAT_DP_STEPS steps: the running statistics as the
# plain run's, by the same rule. Accumulation:
# --accum-steps ACCUM_K, ACCUM_FIRST steps saved (the last save on an odd
# micro-step) and relaunched to ACCUM_STEPS, against an uninterrupted
# ACCUM_STEPS-step run's state by the CRC32 of its msgpack bytes, SimCLR
# and CLIP. Supervisor: run A's flags of [resume] plus SUPERVISE_FLAGS:
# the crash at batch 5 restarts the run, truncate@1 corrupts step 4, the
# restore falls back to step 2, and the run ends at run A's step-6 CRC.
# Crash audit: AUDIT_KILLS SIGKILLed children of the single-card
# ResNet-50 SimCLR path at BASELINE.json configs[1]'s width (#1, #5,
# cuDNN), the first AUDIT_MIDSAVE inside a save, one child at a time
# (each holds ~35 GiB); no torn step, the survivor equal to the
# reference run's step-AUDIT_STEPS checkpoint.
GUARD_TIMED_STEPS = 4  # a timed round; more would cost the time limit
GUARD_ROUNDS = ("plain", "guarded", "guarded", "plain")
GUARD_CHAOS = ["--steps", "5", "--nan-policy", "backoff", "--chaos",
               "nan@2,nan@3"]
REMAT_STEPS, REMAT_DP_STEPS = 4, 2
REMAT_RTOL = 1e-6
REMAT_STEP_LAUNCHES = dict(STEP_LAUNCHES, flash_attention_fwd=24)
ACCUM_K, ACCUM_FIRST, ACCUM_STEPS = 2, 1, 2
SUPERVISE_FLAGS = ["--max-restarts", "1", "--chaos", "crash@5,truncate@1"]
AUDIT_STEPS, AUDIT_KILLS, AUDIT_MIDSAVE = 4, 1, 1
AUDIT_MODEL = dict(model="resnet50", image_size=224, batch=256,
                   device="cuda")

# The input pipeline (ROADMAP Queue A 7(b)) and evaluation (10), at the
# SimCLR path's width (TRAIN_ARGV). [data]: a uint8 row store of
# DATA_STORE (5 batches of 256 an epoch, 193 MB) written from DATA_SEED
# with numpy; the native and the threaded loader give the same first
# DATA_LOADER_BATCHES batches byte for byte, across the epoch boundary;
# then DATA_STEPS steps on the store each way of DATA_WAYS: one state
# CRC32 for all three, bit for bit (every op on the path repeats its
# bits), and STEP_LAUNCHES a step each. [data-lag]: rounds of
# GUARD_TIMED_STEPS steps of train_loop in the order DATA_LAG_ROUNDS:
# the plain loop, the synchronous guard and the lag-1 guard, ending
# equal bit for bit. [data-lag-nan]: way c with --chaos nan@DATA_NAN_AT
# against way c without --lag-metrics: one CRC32, the guard naming the
# step. [eval]: ntxent-eval (EVAL_ARGV) on way c's checkpoint: the
# features of the flash forward (#11) against the plain attention
# forward's on the card, both L2-normalized, within EMBED_ATOL (the
# serve path's bf16 tolerance); --protocol both; EVAL_FINETUNE (#11/#13/
# #14 12/12/12 a step, a finite loss); CLIP zero-shot on the CLIP
# checkpoint of [resume-clip] with EVAL_PROMPTS prompts saved by np.save.
# [data-imagefolder]: IMAGEFOLDER PNGs (count, classes, height, width)
# decoded by the loader's threads, IMAGEFOLDER_STEPS steps with
# --prefetch 0 and 2: the data wait a step.
DATA_STORE = (1280, 224, 224, 3)
DATA_SEED = 18
DATA_LOADER_BATCHES = 6
DATA_STEPS = 4
DATA_WAYS = {"a": ["--loader", "python"],
             "b": ["--loader", "native"],
             "c": ["--loader", "native", "--prefetch", "2", "--lag-metrics",
                   "--nan-policy", "skip"]}
DATA_LAG_ROUNDS = ("plain", "guarded", "lagged", "lagged", "guarded",
                   "plain")
DATA_NAN_AT = 3
EVAL_ARGV = ["--dataset", "synthetic", "--image-size", "224", "--model",
             "vit_b16", "--vit-attention", "flash", "--device", "cuda"]
EVAL_FINETUNE = ["--protocol", "finetune", "--finetune-steps", "4",
                 "--finetune-batch", "64"]
EVAL_CLIP_ARGV = ["--objective", "clip", "--model", "vit_b16",
                  "--vit-attention", "flash", "--image-size", "224",
                  "--device", "cuda"]
EVAL_PROMPTS = (4, 77)
IMAGEFOLDER = (512, 4, 256, 320)
IMAGEFOLDER_STEPS = 3

# Train-side telemetry (ROADMAP Queue A 11(b)) and the space-to-depth stem
# (6(b)). [obs-train]: the SimCLR path (TRAIN_ARGV) for OBS_STEPS steps
# through the CLI with OBS_FLAGS: a scrape of /metrics mid-run in JSON
# and Prometheus text shows OBS_SERIES; every step event carries
# OBS_STEP_FIELDS with 0 < mfu < 1; the loss curve from the JSONL equals
# the logged losses; touching TRIGGER once OBS_TRIGGER_AT steps are done
# captures OBS_TRACE_STEPS steps as a torch.profiler Chrome trace whose
# CUDA kernels include OBS_KERNELS (the hand-written ones, launched through
# ctypes); ``python -m ntxent_tpu_torch.obs.trace`` exports the JSONL;
# STEP_LAUNCHES a step over the whole run, the counted step 1 included.
# Then rounds of GUARD_TIMED_STEPS train_loop steps in the order
# OBS_ROUNDS time the plain loop, the timeline on the synchronous path and
# the timeline under --lag-metrics. [stem]: ResNet-50 at STEM_ARGV's
# width for STEM_STEPS steps with --stem space_to_depth and --stem conv
# from the same weights and batches: the first step's losses within
# STEM_LOSS_ATOL (bf16 stems summing in another order, through 49 more
# layers), #1 and #5 1/1 a step and nothing else. [supervise] adds a stall:
# TRAIN_ARGV with SUPERVISE_STALL_FLAGS and the SUPERVISE_STALL_AT-th
# batch held SUPERVISE_STALL_HOLD_S, no --ckpt-dir (the crash above covers
# the resume): the escalation's flight dump holds the tail of the run's
# events, and the restart trains again to the step count.
OBS_STEPS = 12  # the trigger lands on steps 4-9 (the scrape contends for
                # the interpreter lock with the loop): room for the capture
OBS_TRACE_STEPS = 2
OBS_TRIGGER_AT = 4
OBS_SERIES = ("train_steps_total", "train_step_device_ms", "train_mfu")
OBS_STEP_FIELDS = ("data_wait_ms", "device_ms", "steps_per_sec", "mfu")
OBS_KERNELS = ("ntxent_fwd_sym_walk", "ntxent_bwd_sym_walk",
               "flash_fwd_kernel_tma", "flash_dq_kernel_tma",
               "flash_dkv_kernel_tma")
OBS_TRACE_CAT = "kernel"  # torch.profiler's category of CUDA kernels
OBS_ROUNDS = ("plain", "sync", "lag", "lag", "sync", "plain")
# step 1 of a timeline with and without the collective census
CENSUS_ROUNDS = ("census", "nocensus", "nocensus", "census")
STEM_ARGV = ["--model", "resnet50", "--image-size", "224", "--batch", "256",
             "--dataset", "synthetic", "--device", "cuda", "--log-every",
             "1"]
STEM_STEPS = 3
STEM_LOSS_ATOL = 1e-2
STEM_LAUNCHES = {"ntxent_fwd": 1, "ntxent_bwd_sym": 1}
SUPERVISE_STALL_AT = 3
SUPERVISE_STALL_FLAGS = ["--max-restarts", "1", "--stall-timeout", "5"]
SUPERVISE_STALL_HOLD_S = 7.0

# Model parallelism and MoE (Queue A 9). [moe]: the SimCLR ViT-B/16 path
# with a switch-MoE MLP of 8 experts in every other block (6 layers) at
# --batch 256, through the CLI, with a checkpoint for [eval-moe]; the
# same launches a step as the dense path (the expert FFNs, routing,
# dispatch and combine are plain products and gathers: no kernel).
MOE_STEPS = 3
MOE_ARGV = TRAIN_ARGV[:TRAIN_ARGV.index("--steps")] + [
    "--steps", str(MOE_STEPS), "--dataset", "synthetic", "--device", "cuda",
    "--log-every", "1", "--moe-experts", "8", "--moe-aux-weight", "0.01"]
# The step-1 loss of the MoE path, fp32 (TF32 off) at batch 8, card vs
# CPU from the same weights and views: routing in fp32 gives the same
# expert ids, slots and kept flags on both sides, the rest differs by
# summation order -> 1e-2 on the loss (the dense parity's 1e-4 holds in
# practice, printed).
MOE_PARITY_BATCH = 8
MOE_PARITY_ATOL = 1e-2
# [moe-ep]: make_expert_parallel_moe at P = 1 against switch_moe at the
# path's MoE layer shape (tokens of 512 images of 197, width 768, 8
# experts of 3072), bf16: the same operations at P = 1 (the all-to-alls
# are the identity) -> bitwise.
MOE_EP_TOKENS = (512, 197)
# [tp] / [tp-clip] / [fsdp]: the world-1 steps of the model-parallel
# factories against the single-card and data-parallel steps, fp32 at
# PARITY_BATCH (TF32 off; 1e-4 on the loss, PARITY_GRAD_RTOL on the
# relative parameter update) and bf16 at batch 8 (1e-2 on the loss), the
# timed run at the path's batch with the path's launches.
MP_STEPS = 3
MP_BF16_BATCH = 8
MP_BF16_ATOL = 1e-2
FSDP_ARGV = DP_ARGV[:DP_ARGV.index("--steps")] + [
    "--steps", str(MP_STEPS), "--device", "cuda", "--log-every", "1",
    "--fsdp"]
# [pp]: make_pipelined_apply on LongContextTransformer at its defaults
# (512/8/8/2048, bf16) over the stage group of world 1, B 4, L 8192, 4
# microbatches; forward and gradients against the plain apply of the same
# weights, bf16, at the long-context path's rtols; #11, #13, #14 8 times
# a microbatch.
PP_BATCH, PP_LEN, PP_MICRO = 4, 8192, 4
# The TP SimCLR step's loss is the data-parallel strip over the data
# group: #1 general and #6 rows/cols once, the flash kernels 12 times.
TP_STEP_LAUNCHES = dict(DP_STEP_LAUNCHES, flash_attention_fwd=12,
                        flash_attention_dq=12, flash_attention_dkv=12)
PP_LAUNCHES = {"flash_attention_fwd": 8 * PP_MICRO,
               "flash_attention_dq": 8 * PP_MICRO,
               "flash_attention_dkv": 8 * PP_MICRO}

# The long-context slice. Fold kernel (#12) cases: (name, (BH, Lq, Lk,
# D), dtype, causal, q_offset, k_offsets of consecutive folds). Against
# the plain version: m, the same fp32 maxima of exact products -> 1e-4;
# l, the same fp32 terms summed in another order -> 1e-4 relative; acc /
# l (the attention output) as |a - b| / |b| over the whole tensor, the
# emulated rings' RING_RTOL: fp32 summation order -> 1e-5; bf16, p
# rounded to bf16 (2**-8 relative) at the running max of a 64-key tile
# where the plain version folds the block in one step -> 1e-2. A relative
# norm and not an absolute limit, since a typical |acc / l| over 8192
# randn keys is about 0.01. The control: a fold that dropped the carry
# must miss by more than that.
FOLD_CASES = [
    ("noncausal_bf16", (8, 8192, 8192, 64), "bfloat16", False, 0, (0, 8192)),
    ("partly_masked_fp32", (8, 4096, 4096, 128), "float32", True, 6144,
     (0, 4096)),
    ("diagonal_bf16", (8, 8192, 8192, 64), "bfloat16", True, 8192,
     (0, 8192)),
    ("ragged_bf16", (4, 1000, 1000, 64), "bfloat16", True, 1000, (0, 1000)),
]
FOLD_M_ATOL, FOLD_L_RTOL = 1e-4, 1e-4
FOLD_O_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
# The plain fold, dQ and dK/dV at the path's hop run in q-row chunks: the
# whole (8, 32768, 32768) fp32 score matrix would not fit on the card.
HOP_PLAIN_CHUNKS = 8
# #13 and #14 at those hops, tile by tile: the largest |a - b| / |b| over
# the 64-row tiles of dq (q tiles) and of dk, dv (kv tiles) against the
# plain versions. Under a causal mask with these random inputs the rows'
# p falls as 1/position, so dq shrinks from the first rows to the last
# and an absolute tolerance cannot see the late rows; a tile's relative
# error can. Controls leave one tile pair out of the heaviest walk and
# must miss: for dq the last q tile (its p spread over all its kv tiles)
# without the kv tile in the middle of its walk; for dk/dv kv tile 0
# (every q tile live) without q tile 1, the rows nearest its keys, which
# carry its dk/dv (a far q tile adds too little to be seen in bf16). On
# the H100 the worst tile read, at the path's hop and the P = 4 hop: dq
# 6.0e-4 and 2.7e-4 on the WMMA dQ this replaced, 6.0e-4 and 2.5e-4 on
# the TMA/wgmma dQ; dk/dv 1.4e-4 and 3.4e-5; the controls dq 4.4e-2 and
# 9.5e-2, dk/dv 0.50 and 0.52. The limit sits between the sound readings
# and the controls, near dq's geometric mean.
HOP_TILE_RTOL = 5e-3
# The path: batch 1 x 8 heads of 64 at L = 32768 (the tower's max_len).
LONGCTX_BATCH, LONGCTX_LEN, LONGCTX_BH, LONGCTX_HEAD_DIM = 1, 32768, 8, 64
LONGCTX_PASSES = 3
# One forward and backward at world 1: per block one fold, one dQ and one
# dK/dV hop; nothing else.
LONGCTX_LAUNCHES = {"flash_fold": 8, "flash_attention_dq": 8,
                    "flash_attention_dkv": 8}
# The same bf16 weights under another plan: each block's attention output
# may differ by a bf16 rounding of p at another running maximum (2**-8
# relative at most per element); over 8 blocks the gaps add up to
# 8 * 2**-8 -> 3e-2 relative on the output, twice that (6e-2) on the
# gradient vector, which goes through the blocks twice. The fp32 model
# against the CPU: the train parity tolerances (PARITY_LOSS_ATOL on the
# output, PARITY_GRAD_RTOL).
LONGCTX_OUT_RTOL, LONGCTX_GRAD_RTOL = 3e-2, 6e-2
LONGCTX_PARITY_LEN = 1024
# Emulated rings: (B, L, H, D), the rank counts, and the largest relative
# error |a - b| / |b| of out, dq, dk, dv against flash_attention of the
# whole sequence and against the jnp ring: fp32 summation order -> 1e-5;
# bf16, p rounded at other running maxima and ds at other lse roundings
# -> 1e-2.
RING_SHAPE = dict(b=1, l=8192, h=8, d=64)
RING_WORLDS = (2, 4, 8)
RING_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
# The ring NT-Xent's global batch and the ring InfoNCE's pairs; the
# kernels a fused ring NT-Xent launches once a hop per rank.
RING_NTX_2N = 8192
RING_NTX_KERNELS = ("ntxent_fwd_general", "ntxent_bwd_general_rows",
                    "ntxent_bwd_general_cols")
RING_INFONCE_N = 1024

SERVE_ARGV = ["--model", "vit_b16", "--vit-attention", "flash",
              "--image-size", "224", "--head", "embedding",
              "--buckets", "1,4,16,64", "--port", "0",
              # a window long enough for concurrent requests, whose bodies
              # take a while to parse, to coalesce into one device call
              "--max-delay-ms", "250", "--device", "cuda", "--seed", "0"]
CLIENT_THREADS = 4
CLIENT_ROUNDS = 2
ROW_COUNTS = (1, 3, 8)

# Serving completeness (ROADMAP Queue A 8(b)-(f)), at SERVE_ARGV's width.
# [serve-int8]: the float32 and the int8 rung of the same seeded weights
# on INT8_ROWS rows (chunks of 64, a tail): the largest per-row cosine
# distance under INT8_DRIFT_MAX (the JAX package's drift bar,
# tests/test_quant.py:566-575), 12 #11 launches a chunk, the bytes each
# chunk moves to the card. [serve-ladder]: --adaptive-buckets with
# LADDER_FLAGS, requests of LADDER_SIZES rows (skewed away from the 1/4/
# 16/64 prior) before, across and after a refresh_ladder() made while
# clients are in flight: every answer 200 and within EMBED_ATOL of the
# direct forward, no request-path first run across the swap, padding
# down. [serve-worker]: the serve entry point with WORKER_FLAGS on a copy
# of run A's first kept step: /readyz 503 while warming (the warmup held
# until the probe saw it), the newer step adopted, X-Checkpoint-Step and
# embeddings following it, POST /rollback, a device call held
# STALL_HOLD_S past --stall-timeout: /healthz "stalled", a restart, 200
# again; the JSONL's four spans per request, its Chrome trace valid,
# serving_run_info{run_id="smoke"} in the Prometheus text. [accum-lag]:
# --accum-steps 2 --lag-metrics --nan-policy skip with a NaN micro-batch
# ends at the synchronous guard's CRC32.
SERVE_IMAGE = 224  # SERVE_ARGV's --image-size
SMOKE_DEVICE = "cuda"
INT8_ROWS = 8 * 64 + 23
INT8_DRIFT_MAX = 0.05
LADDER_FLAGS = ["--adaptive-buckets", "--ladder-interval", "0",
                "--ladder-min-requests", "10", "--max-delay-ms", "5"]
LADDER_SIZES = ((5, 10), (20, 41))
LADDER_REQUESTS = 24  # a round: before the swap, across it, after it
STALL_TIMEOUT_S = 5.0
STALL_HOLD_S = STALL_TIMEOUT_S + 2.0
WORKER_FLAGS = ["--max-delay-ms", "5", "--max-restarts", "1",
                "--stall-timeout", str(STALL_TIMEOUT_S), "--watch-ckpt",
                "--watch-poll", "0.5", "--run-id", "smoke"]
WORKER_ROWS = (1, 2, 4, 8)
ACCUM_LAG_STEPS, ACCUM_LAG_NAN_AT = 4, 3
ACCUM_LAG_ROUNDS = ("guarded", "lagged", "lagged", "guarded")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# [audit]: the loss targets' rows a view and width on the card, and the
# kernels their census must launch (#1 general forward, #6 rows and
# columns: the strip's)
CENSUS_ROWS, CENSUS_DIM = 256, 128
CENSUS_KERNELS = ("ntxent_fwd_general", "ntxent_bwd_general_rows",
                  "ntxent_bwd_general_cols")


def _bound(moved: int, flops: int, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of their type."""
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / peak_flops * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def phase_card() -> tuple[str, str]:
    import torch

    from ntxent_tpu_torch.utils.capability import card_power_line

    name = torch.cuda.get_device_name(0)
    smi = card_power_line()
    print(f"[card] {name} | nvidia-smi: {smi} | torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return name, smi


def phase_build() -> dict:
    """Build every kernel; returns nvcc's reports by kernel name."""
    from ntxent_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel source(s) ready in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        if name not in logs:
            print(f"[build] {name}: built before this run, no ptxas report")
        for line in logs.get(name, "").splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "spill")):
                print(f"[build] {name}: {line.strip()}")
    return logs


def _qkv(shape, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bh = shape["b"] * shape["h"]

    def rand(length):
        return torch.randn(bh, length, shape["d"], generator=gen,
                           device="cuda").to(getattr(torch, dtype))

    return rand(shape["lq"]), rand(shape["lk"]), rand(shape["lk"])


def _fwd_truth_rms(seed: int) -> dict:
    """#11 at the training shape in bf16 against the fp32 softmax of the
    same inputs (p never rounded); the control is the plain forward's
    arithmetic with one rounding more, the unnormalized accumulator
    stored in v's dtype before the division (an epilogue that kept acc
    in bf16)."""
    import torch

    from ntxent_tpu_torch.ops import attention

    q, k, v = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / TRAIN_SHAPE["d"] ** 0.5
    truth = torch.softmax(s, -1) @ v.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    acc = torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)
    control = (acc.float() / p.sum(-1, keepdim=True)).to(q.dtype)
    del p, acc
    return {"kernel": _rms(attention.flash_attention_fwd(q, k, v)[0], truth),
            "plain": _rms(attention.attention_plain(q, k, v)[0], truth),
            "control": _rms(control, truth)}


def _truth_gate(label: str, wrapper: str, rms_of_seed, factor: float,
                control: str, reference: str = "plain version",
                gate: bool = True) -> None:
    """Hold a bf16 kernel to an fp32 truth over TRUTH_SEEDS: its rms
    error over the reference's (the plain version, or the kernel's
    rounding in plain arithmetic) must be at most ``factor``, and the
    control's (one rounding more) must exceed it. ``rms_of_seed(seed)``
    returns the rms errors of "kernel", "plain" (the reference) and
    "control". With ``gate`` false the readings are printed and nothing
    fails."""
    for seed in TRUTH_SEEDS:
        rms = rms_of_seed(seed)
        ratio = rms["kernel"] / rms["plain"]
        over = rms["control"] / rms["plain"]
        ok = gate and ratio <= factor < over
        verdict = ("ok" if ok else "MISMATCH") if gate else "(not gated)"
        print(f"[kernel] {label} seed {seed} against an fp32 truth: rms "
              f"error kernel {rms['kernel']:.6e}, {reference} "
              f"{rms['plain']:.6e}, ratio {ratio:.5f} (at most {factor}); "
              f"the control ({control}) {rms['control']:.6e}, ratio "
              f"{over:.5f} (must exceed it) {verdict}", flush=True)
        if gate and not ok:
            fail(f"{wrapper}'s bf16 result against the fp32 truth (seed "
                 f"{seed}): ratio {ratio:.5f}, control {over:.5f}, factor "
                 f"{factor:g}")


def _rms(a, b) -> float:
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


def _dq_truth_rms(seed: int) -> dict:
    """#13 at the training shape in bf16 against dq in fp32 with ds never
    rounded, from the plain forward's lse and delta; the control
    accumulates the plain dq in bf16 across 64-key tiles."""
    import torch

    from ntxent_tpu_torch.ops import attention as A

    q, k, v = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed)
    do = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed + 1000)[0]
    o, lse = A.attention_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    del o
    sc = A.resolve_attention_scale(None, q.shape[-1])
    _, ds = A._bwd_probs(q, k, v, do, lse, delta, sc, False, 0, 0)
    kf = k.float()
    truth = torch.matmul(ds, kf)
    ds = ds.to(k.dtype).float()
    control = torch.zeros_like(truth, dtype=torch.bfloat16)
    for j in range(0, k.shape[1], 64):
        control = (control.float() + torch.matmul(
            ds[..., j:j + 64], kf[:, j:j + 64])).to(torch.bfloat16)
    del ds, kf
    args = (q, k, v, do, lse, delta)
    return {"kernel": _rms(A.flash_attention_dq(*args), truth),
            "plain": _rms(A.attention_dq_plain(*args), truth),
            "control": _rms(control, truth)}


def _bf16_pair(x):
    """x rounded to a pair of bf16 values, hi = bf16(x) and lo = bf16(x -
    hi), as fp32 hi + lo: the operand rounding of #14."""
    import torch

    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


@functools.lru_cache(maxsize=1)  # one seed's dk and dv readings
def _dkv_truth(seed: int) -> dict:
    """{"dk"/"dv": rms errors} of #14 at the training shape in bf16
    against the fp32 plain version (p and ds never rounded), from the
    plain forward's lse and delta: the kernel's; "plain", the kernel's
    rounding of p and ds to bf16 pairs in plain arithmetic; "control",
    that with the running sums rounded to bf16 pairs after each 64-row q
    tile."""
    import torch

    from ntxent_tpu_torch.ops import attention as A

    q, k, v = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed)
    do = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed + 1000)[0]
    o, lse = A.attention_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    del o
    dk, dv = A.flash_attention_dkv(q, k, v, do, lse, delta)
    sc = A.resolve_attention_scale(None, q.shape[-1])
    p, ds = A._bwd_probs(q, k, v, do, lse, delta, sc, False, 0, 0)
    out = {}
    for name, x, y, got in (("dk", ds, q.float(), dk),
                            ("dv", p, do.float(), dv)):
        truth = torch.matmul(x.transpose(-1, -2), y)
        pair = _bf16_pair(x)
        plain = torch.matmul(pair.transpose(-1, -2), y)
        control = torch.zeros_like(truth)
        for j in range(0, x.shape[1], 64):
            control = _bf16_pair(control + torch.matmul(
                pair[:, j:j + 64].transpose(-1, -2), y[:, j:j + 64]))
        out[name] = {"kernel": _rms(got, truth), "plain": _rms(plain, truth),
                     "control": _rms(control, truth)}
        del truth, pair, plain, control
    return out


def _fold_truth_rms(seed: int) -> dict:
    """#12 in bf16: two consecutive folds at FOLD_TRUTH_SHAPE (a whole
    block of the past, then the causal diagonal block), acc / l, against
    the fp32 softmax of the same inputs over both blocks (P never
    rounded); the control rounds acc to bf16 between the two folds."""
    import torch

    from ntxent_tpu_torch.ops import attention as A

    bh, length, d = FOLD_TRUTH_SHAPE
    q, k1, v1 = _flat_qkv(bh, length, length, d, "bfloat16", seed)
    _, k2, v2 = _flat_qkv(bh, length, length, d, "bfloat16", seed + 1000)
    first = dict(q_offset=length, k_offset=0, causal=True)
    second = dict(q_offset=length, k_offset=length, causal=True)

    def out(carry):
        return carry[2] / carry[1][..., None]

    kernel = A.flash_fold(q, k1, v1, *_fold_carry(bh, length, d), **first)
    kernel = out(A.flash_fold(q, k2, v2, *kernel, **second))
    plain = A.flash_fold_plain(q, k1, v1, *_fold_carry(bh, length, d),
                               **first)
    rounded = (plain[0], plain[1], plain[2].to(torch.bfloat16).float())
    plain = out(A.flash_fold_plain(q, k2, v2, *plain, **second))
    control = out(A.flash_fold_plain(q, k2, v2, *rounded, **second))
    del rounded
    kf, vf = torch.cat([k1, k2], 1).float(), torch.cat([v1, v2], 1).float()
    sq = {"kernel": 0.0, "plain": 0.0, "control": 0.0}
    rows = length // 4
    for r in range(0, length, rows):  # the truth in row chunks
        s = torch.matmul(q[:, r:r + rows].float(), kf.transpose(-1, -2)) \
            * d ** -0.5
        live = torch.arange(2 * length, device=q.device)[None, :] \
            <= length + r + torch.arange(rows, device=q.device)[:, None]
        truth = torch.softmax(s.masked_fill(~live, float("-inf")), -1) @ vf
        del s
        for name, o in (("kernel", kernel), ("plain", plain),
                        ("control", control)):
            sq[name] += (o[:, r:r + rows] - truth).pow(2).sum().item()
    return {name: (total / kernel.numel()) ** 0.5
            for name, total in sq.items()}


# (label, wrapper, rms of a seed, factor, control[, reference]) of each
# bf16 kernel's fp32-truth gate: #11, #13, #12 and #14 (dk and dv).
TRUTH_GATES = [
    ("train_bf16", "flash_attention_fwd", _fwd_truth_rms, TRUTH_RMS_FACTOR,
     "acc rounded to bf16 once more"),
    ("dq train_bf16", "flash_attention_dq", _dq_truth_rms,
     DQ_TRUTH_RMS_FACTOR, "dq accumulated in bf16 across 64-key tiles"),
    ("fold P4 hop", "flash_fold", _fold_truth_rms, FOLD_TRUTH_RMS_FACTOR,
     "acc rounded to bf16 between the two folds"),
    ("dk train_bf16", "flash_attention_dkv",
     lambda seed: _dkv_truth(seed)["dk"], DKV_TRUTH_RMS_FACTOR,
     "dk carried in bf16 pairs across 64-row q tiles",
     "p and ds in bf16 pairs"),
    ("dv train_bf16", "flash_attention_dkv",
     lambda seed: _dkv_truth(seed)["dv"], DKV_TRUTH_RMS_FACTOR,
     "dv carried in bf16 pairs across 64-row q tiles",
     "p and ds in bf16 pairs"),
]


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from ntxent_tpu_torch.ops import attention
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    serve_err = None
    for i, (name, shape, dtype, causal, q_off, k_off) in enumerate(
            KERNEL_CASES):
        q, k, v = _qkv(shape, dtype, seed=i)
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        o, lse = attention.flash_attention_fwd(q, k, v, **kw)
        o_ref, lse_ref = attention.attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if o.dtype != q.dtype or lse.shape != (q.shape[0], q.shape[1]):
            fail(f"{name}: kernel returned o {o.dtype}, lse "
                 f"{tuple(lse.shape)}")
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = o_err <= O_ATOL[dtype] and lse_err <= LSE_ATOL
        print(f"[kernel] {name}: o max|err| {o_err:.3e} "
              f"(atol {O_ATOL[dtype]:g}), lse max|err| {lse_err:.3e} "
              f"(atol {LSE_ATOL:g}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"flash_attention_fwd disagrees with its plain version "
                 f"in case {name}")
        if name == "serve_bf16":
            serve_err = o_err

    _truth_gate(*TRUTH_GATES[0])

    times = {}
    for label, s in (("serve", SERVE_SHAPE), ("train", TRAIN_SHAPE)):
        q, k, v = _qkv(s, "bfloat16", seed=100)
        q4, k4, v4 = (t.view(s["b"], s["h"], -1, s["d"]) for t in (q, k, v))
        kernel_ms = cuda_time_ms(
            lambda: attention.flash_attention_fwd(q, k, v))
        plain_ms = cuda_time_ms(lambda: attention.attention_plain(q, k, v))
        sdpa_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4))
        bh, lq, lk, d = s["b"] * s["h"], s["lq"], s["lk"], s["d"]
        moved = (2 * bh * lq * d + 2 * bh * lk * d) * 2 + bh * lq * 4
        flops = 4 * bh * lq * lk * d
        bound_ms, bound_by = _bound(moved, flops, PEAK_BF16_FLOPS)
        print(f"[kernel] {label} shape (B*H={bh}, L={lq}, D={d}, bf16): "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({moved} bytes, "
              f"{flops} flops)", flush=True)
        times[label] = (kernel_ms, plain_ms, sdpa_ms, bound_ms, bound_by)
    kernel_ms, plain_ms, sdpa_ms, bound_ms, bound_by = times["train"]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "ntxent_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ntxent_tpu/ops/attention_pallas.py:73 (_fwd_kernel)",
            "checked": True, "launches": None, "max_abs_err": serve_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": sdpa_ms,
            "serve_shape_ms": times["serve"][0]}


def _unit_rows(rows, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(rows, d, generator=gen, device="cuda")
    return torch.nn.functional.normalize(z, dim=1).to(getattr(torch, dtype))


def _ptxas_walks(logs: dict, name: str) -> list[str]:
    """One line per TF32 walk kernel in a build report: its mangled name,
    ptxas's spill and register lines."""
    lines = logs.get(name, "").splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "_walk" in line:
            kernel = line.split("'")[1] if "'" in line else line
            report = [ln.split(":")[-1].strip() for ln in lines[i + 1:i + 4]
                      if "registers" in ln or "spill" in ln]
            out.append(f"{kernel}: {' | '.join(report)}")
    return out


def _tf32_control(z, t) -> tuple[tuple[float, float], tuple[float, float]]:
    """(lse, gradient) max abs errors against the fp32 plain versions of
    #1 + #5 on z, and of one TF32 pass (the plain versions on z rounded to
    TF32)."""
    import torch

    from ntxent_tpu_torch.ops import ntxent

    _, lse_ref = ntxent.ntxent_fwd_plain(z, t)
    grad_ref = ntxent.ntxent_bwd_sym_plain(z, lse_ref, t)
    _, lse = ntxent.ntxent_fwd(z, t)
    grad = ntxent.ntxent_bwd_sym(z, lse, t)
    z_tf32 = ntxent.tf32_split(z)[0]
    _, lse_c = ntxent.ntxent_fwd_plain(z_tf32, t)
    grad_c = ntxent.ntxent_bwd_sym_plain(z_tf32, lse_c, t)
    torch.cuda.synchronize()

    def err(a, b):
        return (a - b).abs().max().item()

    return ((err(lse, lse_ref), err(grad, grad_ref)),
            (err(lse_c, lse_ref), err(grad_c, grad_ref)))


def phase_ntxent_kernels(build_logs: dict) -> list[dict]:
    """ntxent_fwd and ntxent_bwd_sym against their plain versions, the
    TF32 control, ptxas's report of their walks, then times at the path's
    shape (2N = 512, D = 128, fp32) and at 2N = 8192."""
    import torch

    from ntxent_tpu_torch.ops import ntxent
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t = NTX_TEMPERATURE
    errs = {}
    for rows, d in NTX_SHAPES:
        for dtype in ("float32", "bfloat16"):
            z = _unit_rows(rows, d, dtype, seed=rows + d)
            loss, lse = ntxent.ntxent_fwd(z, t)
            grad = ntxent.ntxent_bwd_sym(z, lse, t)
            loss_ref, lse_ref = ntxent.ntxent_fwd_plain(z, t)
            grad_ref = ntxent.ntxent_bwd_sym_plain(z, lse_ref, t)
            again, _ = ntxent.ntxent_fwd(z, t)
            torch.cuda.synchronize()
            fwd_err = max((lse - lse_ref).abs().max().item(),
                          abs(loss.item() - loss_ref.item()) / rows)
            bwd_err = (grad - grad_ref).abs().max().item()
            repeat = again.item() == loss.item()
            ok = fwd_err <= NTX_ATOL and bwd_err <= NTX_ATOL and repeat
            print(f"[kernel] ntxent 2N={rows} D={d} {dtype}: fwd max|err| "
                  f"{fwd_err:.3e}, bwd max|err| {bwd_err:.3e} (atol "
                  f"{NTX_ATOL:g}), loss bitwise repeatable {repeat} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the NT-Xent kernels disagree with their plain "
                     f"versions at 2N={rows} D={d} {dtype}")
            if (rows, d, dtype) == (512, 128, "float32"):
                errs = {"ntxent_fwd": fwd_err, "ntxent_bwd_sym": bwd_err}
            del z, grad, grad_ref

    for rows, d in NTX_SHAPES[:2]:
        z = _unit_rows(rows, d, "float32", seed=rows + d)
        kernel, control = _tf32_control(z, t)
        ok = all(k <= NTX_ATOL and TF32_CONTROL_FACTOR * k <= c
                 for k, c in zip(kernel, control))
        print(f"[kernel] ntxent TF32 control 2N={rows} D={d} fp32: kernels "
              f"lse {kernel[0]:.3e} grad {kernel[1]:.3e}, one TF32 pass lse "
              f"{control[0]:.3e} grad {control[1]:.3e} (ratios "
              f"{control[0] / max(kernel[0], 1e-30):.1f}, "
              f"{control[1] / max(kernel[1], 1e-30):.1f}; at least "
              f"{TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"the NT-Xent kernels are not {TF32_CONTROL_FACTOR}x more "
                 f"accurate than one TF32 pass at 2N={rows}")
        del z
    for name in ("ntxent_fwd", "ntxent_bwd_sym"):
        for line in _ptxas_walks(build_logs, name):
            print(f"[kernel] ptxas {name}: {line}", flush=True)

    timed = {}
    for rows, d in NTX_SHAPES[:2]:
        z = _unit_rows(rows, d, "float32", seed=0)
        _, lse = ntxent.ntxent_fwd(z, t)
        runs = 3 if rows > 4096 else 10
        fwd_ms = cuda_time_ms(lambda: ntxent.ntxent_fwd(z, t))
        fwd_plain = cuda_time_ms(lambda: ntxent.ntxent_fwd_plain(z, t), runs)
        bwd_ms = cuda_time_ms(lambda: ntxent.ntxent_bwd_sym(z, lse, t))
        bwd_plain = cuda_time_ms(
            lambda: ntxent.ntxent_bwd_sym_plain(z, lse, t), runs)
        zb = rows * d * 4
        fwd_bound = _bound(zb + rows * 4 + 4, 2 * rows * rows * d,
                           PEAK_FP32_FLOPS)
        bwd_bound = _bound(2 * zb + rows * 4, 4 * rows * rows * d,
                           PEAK_FP32_FLOPS)
        splits = ntxent.column_splits(
            rows, rows, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        print(f"[kernel] ntxent (2N={rows}, D={d}, fp32; {splits[0]} column "
              f"split(s) of {splits[1]}): fwd {fwd_ms:.4f} ms (plain "
              f"{fwd_plain:.4f}, bound {fwd_bound[0]:.5f} by "
              f"{fwd_bound[1]}), bwd {bwd_ms:.4f} ms (plain "
              f"{bwd_plain:.4f}, bound {bwd_bound[0]:.5f} by "
              f"{bwd_bound[1]}); no single PyTorch call computes NT-Xent, "
              f"so there is no library time", flush=True)
        timed[rows] = ((fwd_ms, fwd_plain, fwd_bound),
                       (bwd_ms, bwd_plain, bwd_bound))
        del z
    common = {"route": "cuda", "checked": True, "launches": None,
              "library_ms": None}
    out = [
        {"name": "ntxent_fwd", **common,
         "source": "ntxent_tpu_torch/csrc/ntxent_fwd.cu",
         "replaces": "ntxent_tpu/ops/ntxent_pallas.py:130 (_fwd_kernel, "
                     "_fwd_call :190)",
         "max_abs_err": errs["ntxent_fwd"]},
        {"name": "ntxent_bwd_sym", **common,
         "source": "ntxent_tpu_torch/csrc/ntxent_bwd_sym.cu",
         "replaces": "ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel, "
                     "_bwd_sym_call :612)",
         "max_abs_err": errs["ntxent_bwd_sym"]},
    ]
    for i, entry in enumerate(out):
        (ms, plain, bound), big = timed[512][i], timed[8192][i]
        entry |= {"ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                  "bound_by": bound[1], "n8192_ms": big[0],
                  "n8192_plain_ms": big[1], "n8192_bound_ms": big[2][0]}
    return out


def _infonce_tf32_control(n: int, d: int, scale):
    """((lse, gradient) of #9 + #10, (lse, gradient) of one TF32 pass): max
    abs errors in fp32 against the plain versions, the gradients all at
    the plain forward's lse; the control is the plain versions on za, zb
    rounded to TF32 once."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I
    from ntxent_tpu_torch.ops import ntxent

    za = _unit_rows(n, d, "float32", seed=n + d)
    zb = _unit_rows(n, d, "float32", seed=n + d + 1)
    _, lse_a, lse_b = I.infonce_dual_fwd_plain(za, zb, scale)
    o_ref = I.infonce_dual_bwd_plain(za, zb, scale, lse_a, lse_b)
    _, got_a, got_b = I.infonce_dual_fwd(za, zb, scale)
    o_got = I.infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
    za_c, zb_c = ntxent.tf32_split(za)[0], ntxent.tf32_split(zb)[0]
    _, ctl_a, ctl_b = I.infonce_dual_fwd_plain(za_c, zb_c, scale)
    o_ctl = I.infonce_dual_bwd_plain(za_c, zb_c, scale, lse_a, lse_b)
    torch.cuda.synchronize()

    def err(pairs):
        return max((a - b).abs().max().item() for a, b in pairs)

    return ((err([(got_a, lse_a), (got_b, lse_b)]), err(zip(o_got, o_ref))),
            (err([(ctl_a, lse_a), (ctl_b, lse_b)]), err(zip(o_ctl, o_ref))))


def phase_infonce_kernels(build_logs: dict) -> list[dict]:
    """infonce_dual_fwd and infonce_dual_bwd against their plain versions,
    the TF32 control, ptxas's report of their walks, then times at the
    CLIP path's shape (N = 256, D = 512, fp32) and at N = 8192."""
    import torch

    from ntxent_tpu_torch.ops import infonce
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    scale = torch.tensor(INFONCE_SCALE, device="cuda")
    errs = {}
    for n, d in INFONCE_SHAPES:
        for dtype in ("float32", "bfloat16"):
            za = _unit_rows(n, d, dtype, seed=n + d)
            zb = _unit_rows(n, d, dtype, seed=n + d + 1)
            loss, lse_a, lse_b = infonce.infonce_dual_fwd(za, zb, scale)
            o_a, o_b = infonce.infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
            loss_ref, lse_a_ref, lse_b_ref = infonce.infonce_dual_fwd_plain(
                za, zb, scale)
            o_a_ref, o_b_ref = infonce.infonce_dual_bwd_plain(
                za, zb, scale, lse_a_ref, lse_b_ref)
            again = infonce.infonce_dual_fwd(za, zb, scale)[0]
            torch.cuda.synchronize()
            fwd_err = max((lse_a - lse_a_ref).abs().max().item(),
                          (lse_b - lse_b_ref).abs().max().item(),
                          abs(loss.item() - loss_ref.item()) / (2 * n))
            bwd_err = max((o_a - o_a_ref).abs().max().item(),
                          (o_b - o_b_ref).abs().max().item())
            repeat = again.item() == loss.item()
            ok = (fwd_err <= INFONCE_ATOL and bwd_err <= INFONCE_ATOL
                  and repeat)
            print(f"[kernel] infonce N={n} D={d} {dtype} scale "
                  f"{INFONCE_SCALE}: fwd max|err| {fwd_err:.3e}, bwd "
                  f"max|err| {bwd_err:.3e} (atol {INFONCE_ATOL:g}), loss "
                  f"bitwise repeatable {repeat} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"the InfoNCE kernels disagree with their plain "
                     f"versions at N={n} D={d} {dtype}")
            if (n, d, dtype) == (256, 512, "float32"):
                errs = {"infonce_dual_fwd": fwd_err,
                        "infonce_dual_bwd": bwd_err}
            del za, zb, o_a, o_b, o_a_ref, o_b_ref

    for n, d in INFONCE_SHAPES[:3]:
        kernel, control = _infonce_tf32_control(n, d, scale)
        ok = all(k <= INFONCE_ATOL and TF32_CONTROL_FACTOR * k <= c
                 for k, c in zip(kernel, control))
        print(f"[kernel] infonce TF32 control N={n} D={d} fp32: kernels lse "
              f"{kernel[0]:.3e} grad {kernel[1]:.3e}, one TF32 pass lse "
              f"{control[0]:.3e} grad {control[1]:.3e} (ratios "
              f"{control[0] / max(kernel[0], 1e-30):.1f}, "
              f"{control[1] / max(kernel[1], 1e-30):.1f}; at least "
              f"{TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"#9 and #10 are not {TF32_CONTROL_FACTOR}x more accurate "
                 f"than one TF32 pass at N={n} D={d}")
    for name in ("infonce_dual_fwd", "infonce_dual_bwd"):
        for line in _ptxas_walks(build_logs, name):
            if "infonce_dual" in line or "infonce_fwd_rect" in line:
                print(f"[kernel] ptxas {name}: {line}", flush=True)

    d = 512
    times = {}
    for n in INFONCE_TIMED_N:
        za = _unit_rows(n, d, "float32", seed=n)
        zb = _unit_rows(n, d, "float32", seed=n + 1)
        _, lse_a, lse_b = infonce.infonce_dual_fwd(za, zb, scale)
        fwd_ms = cuda_time_ms(lambda: infonce.infonce_dual_fwd(za, zb, scale))
        fwd_plain = cuda_time_ms(
            lambda: infonce.infonce_dual_fwd_plain(za, zb, scale))
        bwd_ms = cuda_time_ms(
            lambda: infonce.infonce_dual_bwd(za, zb, scale, lse_a, lse_b))
        bwd_plain = cuda_time_ms(
            lambda: infonce.infonce_dual_bwd_plain(za, zb, scale, lse_a,
                                                   lse_b))
        zbytes = n * d * 4
        # inputs read once (za, zb, the scale; lse for the backward),
        # outputs written once; 2 N^2 D and 6 N^2 D fp32 operations
        fwd_bound = _bound(2 * zbytes + 4 + 2 * n * 4 + 4, 2 * n * n * d,
                           PEAK_FP32_FLOPS)
        bwd_bound = _bound(2 * zbytes + 4 + 2 * n * 4 + 2 * zbytes,
                           6 * n * n * d, PEAK_FP32_FLOPS)
        print(f"[kernel] infonce N={n}, D={d}, fp32: fwd {fwd_ms:.4f} ms "
              f"(plain {fwd_plain:.4f}, bound {fwd_bound[0]:.5f} by "
              f"{fwd_bound[1]}), bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, "
              f"bound {bwd_bound[0]:.5f} by {bwd_bound[1]}); no single "
              f"PyTorch call computes InfoNCE, so there is no library time",
              flush=True)
        times[n] = (fwd_ms, fwd_plain, fwd_bound, bwd_ms, bwd_plain,
                    bwd_bound)
        del za, zb
    fwd_ms, fwd_plain, fwd_bound, bwd_ms, bwd_plain, bwd_bound = times[256]
    big = times[8192]
    common = {"route": "cuda", "checked": True, "launches": None,
              "library_ms": None}
    return [
        {"name": "infonce_dual_fwd", **common,
         "source": "ntxent_tpu_torch/csrc/infonce_dual_fwd.cu",
         "replaces": "ntxent_tpu/ops/infonce_pallas.py:75 (_dual_fwd_kernel, "
                     "_dual_fwd_call :165, pallas_call :174)",
         "max_abs_err": errs["infonce_dual_fwd"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], "n8192_ms": big[0],
         "n8192_plain_ms": big[1], "n8192_bound_ms": big[2][0]},
        {"name": "infonce_dual_bwd", **common,
         "source": "ntxent_tpu_torch/csrc/infonce_dual_bwd.cu",
         "replaces": "ntxent_tpu/ops/infonce_pallas.py:204 (_dual_bwd_kernel, "
                     "_dual_bwd_call :266, pallas_call :274)",
         "max_abs_err": errs["infonce_dual_bwd"], "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "n8192_ms": big[3],
         "n8192_plain_ms": big[4], "n8192_bound_ms": big[5][0]},
    ]


def _bwd_inputs(shape, dtype, causal, q_off, k_off, seed):
    import torch

    from ntxent_tpu_torch.ops import attention

    q, k, v = _qkv(shape, dtype, seed)
    do = _qkv(shape, dtype, seed + 1)[0]
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o, lse = attention.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta), kw


def phase_flash_backward() -> list[dict]:
    """flash_attention_dq / _dkv against their plain versions, then times
    at the training shape beside SDPA's backward through autograd."""
    import torch
    import torch.nn.functional as F

    from ntxent_tpu_torch.ops import attention
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    errs = {}
    for i, (name, shape, dtype, causal, q_off, k_off) in enumerate(
            BWD_CASES):
        args, kw = _bwd_inputs(shape, dtype, causal, q_off, k_off, 200 + i)
        dq = attention.flash_attention_dq(*args, **kw)
        dk, dv = attention.flash_attention_dkv(*args, **kw)
        dq_ref = attention.attention_dq_plain(*args, **kw)
        dk_ref, dv_ref = attention.attention_dkv_plain(*args, **kw)
        torch.cuda.synchronize()
        dq_err = (dq - dq_ref).abs().max().item()
        dkv_err = max((dk - dk_ref).abs().max().item(),
                      (dv - dv_ref).abs().max().item())
        tol = BWD_ATOL[dtype]
        ok = dq_err <= tol["dq"] and dkv_err <= tol["dkv"]
        print(f"[kernel] flash backward {name}: dq max|err| {dq_err:.3e} "
              f"(atol {tol['dq']:g}), dk/dv max|err| {dkv_err:.3e} (atol "
              f"{tol['dkv']:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the flash backward kernels disagree with their plain "
                 f"versions in case {name}")
        if name == "train_bf16":
            errs = {"flash_attention_dq": dq_err,
                    "flash_attention_dkv": dkv_err}
        del args, dq, dk, dv, dq_ref, dk_ref, dv_ref

    # A ring hop wholly after its queries: every kv tile of dK/dV has no
    # live q tile and must write zeros bit for bit.
    for dtype in ("bfloat16", "float32"):
        shape = dict(b=1, lq=1024, lk=1024, h=8, d=64)
        args, kw = _bwd_inputs(shape, dtype, True, 0, 1024, 400)
        dk, dv = attention.flash_attention_dkv(*args, **kw)
        torch.cuda.synchronize()
        zeros = bool(torch.equal(dk, torch.zeros_like(dk))
                     and torch.equal(dv, torch.zeros_like(dv)))
        print(f"[kernel] flash backward wholly masked hop ({dtype}): dk, dv "
              f"zero bit for bit: {zeros}", flush=True)
        if not zeros:
            fail(f"flash_attention_dkv wrote nonzeros on a wholly masked hop "
                 f"({dtype})")
    _truth_gate(*TRUTH_GATES[1])
    _truth_gate(*TRUTH_GATES[3])
    _truth_gate(*TRUTH_GATES[4])

    s = TRAIN_SHAPE
    args, kw = _bwd_inputs(s, "bfloat16", False, 0, 0, 300)
    dq_ms = cuda_time_ms(lambda: attention.flash_attention_dq(*args, **kw))
    dkv_ms = cuda_time_ms(lambda: attention.flash_attention_dkv(*args, **kw))
    dq_plain = cuda_time_ms(
        lambda: attention.attention_dq_plain(*args, **kw), runs=3)
    dkv_plain = cuda_time_ms(
        lambda: attention.attention_dkv_plain(*args, **kw), runs=3)
    q, k, v, do = (t.view(s["b"], s["h"], -1, s["d"]).detach()
                   .requires_grad_() for t in args[:4])
    out = F.scaled_dot_product_attention(q, k, v)
    sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (q, k, v), do.detach(), retain_graph=True))
    bh, l, d = s["b"] * s["h"], s["lq"], s["d"]
    inputs = 4 * bh * l * d * 2 + 2 * bh * l * 4
    dq_bound = _bound(inputs + bh * l * d * 4, 3 * 2 * bh * l * l * d,
                      PEAK_BF16_FLOPS)
    dkv_bound = _bound(inputs + 2 * bh * l * d * 4, 4 * 2 * bh * l * l * d,
                       PEAK_BF16_FLOPS)
    print(f"[kernel] flash backward train shape (B*H={bh}, L={l}, D={d}, "
          f"bf16): dq {dq_ms:.4f} ms (plain {dq_plain:.4f}, bound "
          f"{dq_bound[0]:.4f} by {dq_bound[1]}), dkv {dkv_ms:.4f} ms (plain "
          f"{dkv_plain:.4f}, bound {dkv_bound[0]:.4f} by {dkv_bound[1]}); "
          f"SDPA backward (dq, dk, dv together) {sdpa_bwd_ms:.4f} ms",
          flush=True)
    common = {"route": "cuda", "checked": True, "launches": None,
              "source": "ntxent_tpu_torch/csrc/flash_attention_bwd.cu",
              # one library call computes dq, dk and dv together
              "library_ms": sdpa_bwd_ms}
    return [
        {"name": "flash_attention_dq", **common,
         "replaces": "ntxent_tpu/ops/attention_pallas.py:125 (_dq_kernel, "
                     "flash_dq_hop :306)",
         "max_abs_err": errs["flash_attention_dq"], "ms": dq_ms,
         "plain_ms": dq_plain, "bound_ms": dq_bound[0],
         "bound_by": dq_bound[1]},
        {"name": "flash_attention_dkv", **common,
         "replaces": "ntxent_tpu/ops/attention_pallas.py:166 (_dkv_kernel, "
                     "flash_dkv_hop :338)",
         "max_abs_err": errs["flash_attention_dkv"], "ms": dkv_ms,
         "plain_ms": dkv_plain, "bound_ms": dkv_bound[0],
         "bound_by": dkv_bound[1]},
    ]


def _post(url, body, rid):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("X-Request-Id"), \
                json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("X-Request-Id"), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_embeddings(name, got, ref):
    got = np.asarray(got, dtype=np.float32)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        fail(f"{name}: embeddings of shape {got.shape}, expected "
             f"{ref.shape}, finite")
    norm_err = float(np.abs(np.linalg.norm(got, axis=1) - 1.0).max())
    err = float(np.abs(got - ref).max())
    if norm_err > 1e-3 or err > EMBED_ATOL:
        fail(f"{name}: |norm-1| {norm_err:.2e}, max|err| vs the direct "
             f"forward {err:.2e} (atol {EMBED_ATOL:g})")
    return err


def phase_serve(card_line: str) -> int:
    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.ops import attention

    t0 = time.monotonic()
    server = cli.build_server(cli.build_serve_parser().parse_args(SERVE_ARGV))
    server.start()
    engine = server.engine
    depth = len(engine.model.backbone.blocks)
    url = f"http://127.0.0.1:{server.port}"
    print(f"[serve] ViT-B/16 SimCLR server built and warm in "
          f"{time.monotonic() - t0:.1f} s at {url}", flush=True)
    try:
        rng = np.random.default_rng(0)
        requests = []  # (thread, round, x, body)
        for r in range(CLIENT_ROUNDS):
            for t in range(CLIENT_THREADS):
                n = ROW_COUNTS[(t + r) % len(ROW_COUNTS)]
                # three decimals keep the JSON body near 7 bytes a value
                x = rng.uniform(-1, 1, (n, 224, 224, 3)).round(3)
                body = json.dumps({"inputs": x.tolist(),
                                   "timeout_ms": 120000}).encode()
                requests.append((t, r, x.astype(np.float32), body))
        x_big = rng.uniform(-1, 1, (70, 224, 224, 3)).astype(np.float32)

        results, errors = {}, []
        barrier = threading.Barrier(CLIENT_THREADS)

        def client(t):
            try:
                for tt, r, _, body in requests:
                    if tt != t:
                        continue
                    barrier.wait(timeout=300)
                    t_send = time.monotonic()
                    status, rid, payload = _post(f"{url}/embed", body,
                                                 f"smoke-{t}-{r}")
                    results[(t, r)] = (status, rid, payload,
                                       (time.monotonic() - t_send) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"client {t}: {type(e).__name__}: {e}")

        attention.flash_attention_fwd.launches = 0
        calls0 = engine.metrics.device_calls
        t_http = time.monotonic()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(CLIENT_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        http_s = time.monotonic() - t_http
        out_big = engine.embed(x_big)
        launches = attention.flash_attention_fwd.launches
        chunks = engine.metrics.device_calls - calls0
        if errors or any(th.is_alive() for th in threads):
            fail(f"client threads: {errors or 'did not finish'}")

        if launches == 0 or launches != depth * chunks:
            fail(f"flash_attention_fwd launched {launches} times over "
                 f"{chunks} forward chunks; expected {depth} per chunk")
        print(f"[serve] flash_attention_fwd launches on the served path: "
              f"{launches} over {chunks} forward chunks ({depth} per "
              f"chunk)", flush=True)

        health, _ = _get(f"{url}/healthz")
        metrics_code, metrics = _get(f"{url}/metrics")
        if health != 200 or metrics_code != 200:
            fail(f"/healthz {health}, /metrics {metrics_code}")
        fill = metrics.get("batch_fill_ratio") or 0.0
        if fill <= 1.0:
            fail(f"batch_fill_ratio {fill}: concurrent requests were not "
                 "coalesced")

        worst = 0.0
        with torch.inference_mode():
            def direct(x):
                return engine.model(torch.from_numpy(x).to(
                    engine.device)).float().cpu().numpy()

            for t, r, x, _ in requests:
                status, rid, payload, _ = results[(t, r)]
                if status != 200 or rid != f"smoke-{t}-{r}":
                    fail(f"request {t}/{r}: HTTP {status}, X-Request-Id "
                         f"{rid!r}: {payload}")
                if payload["dim"] != 128 or payload["rows"] != x.shape[0]:
                    fail(f"request {t}/{r}: dim {payload['dim']}, rows "
                         f"{payload['rows']}")
                worst = max(worst, _check_embeddings(
                    f"request {t}/{r}", payload["embeddings"], direct(x)))
            worst = max(worst, _check_embeddings("70-row engine call",
                                                 out_big, direct(x_big)))
        lat = sorted(v[3] for v in results.values())
        rows = sum(x.shape[0] for _, _, x, _ in requests)
        print(f"[serve] {len(results)} concurrent /embed requests, {rows} "
              f"rows, all 200 and unit-norm (n, 128); max|err| vs direct "
              f"forward {worst:.3e}; batch_fill_ratio {fill}; "
              f"padding_waste {metrics.get('padding_waste')}", flush=True)
        print(f"[serve] request latency p50 {lat[len(lat) // 2]:.1f} ms, "
              f"p99 {lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.1f} ms, "
              f"{rows / http_s:.1f} rows/s over HTTP with JSON bodies "
              f"(client clock) on {card_line}", flush=True)
        return launches
    finally:
        server.close()


def phase_train(card_line: str) -> dict:
    """ntxent-train on the card; returns the launches of each kernel."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(TRAIN_ARGV)
    initial = cli.build_model(args).state_dict()
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    state, history = cli.train(args)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train losses {losses}: expected {TRAIN_STEPS} finite values")
    want = {n: STEP_LAUNCHES.get(n, 0) * TRAIN_STEPS for n in counters}
    if launches != want:
        fail(f"kernel launches over {TRAIN_STEPS} steps {launches}, "
             f"expected {want}")
    moved = max((p.detach().cpu() - initial[n]).abs().max().item()
                for n, p in state.model.named_parameters())
    if not moved > 0:
        fail("no parameter changed over the train steps")
    for i, block in enumerate(state.model.backbone.blocks):
        for proj in ("query", "key", "value"):
            g = getattr(block.attn, proj).weight.grad
            if g is None or not g.abs().sum().item() > 0:
                fail(f"block {i} attn.{proj}.weight has no gradient: "
                     "flash_attention did not carry the gradient")
    # steps after the first (which also loads the kernel libraries)
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    images_per_s = 2 * args.batch / step_ms * 1e3
    print(f"[train] ViT-B/16 flash, batch {args.batch} (2 x {args.batch} "
          f"views), {TRAIN_STEPS} steps in {wall_s:.1f} s: losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{ {n: c // TRAIN_STEPS for n, c in launches.items()} }; "
          f"largest parameter change {moved:.3e}; every q/k/v weight has "
          f"a nonzero gradient", flush=True)
    print(f"[train] step {step_ms:.1f} ms (steps 2-{TRAIN_STEPS}, host clock "
          f"around a synchronizing loss read), {images_per_s:.1f} images/s, "
          f"peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {card_line}", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


def _parity_step(dtype: str, device: str, views) -> tuple[float, object]:
    """(loss, flat fp32 gradient) of one train step of ViT-B/16 in
    ``dtype`` from the weights of seed 0."""
    import torch

    from ntxent_tpu_torch.models import SimCLRModel, ViT_B16, init_weights
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_train_state,
        make_train_step,
    )

    tdt = getattr(torch, dtype)
    model = init_weights(
        SimCLRModel(ViT_B16(image_size=224, attention_impl="flash",
                            dtype=tdt), dtype=tdt),
        torch.Generator().manual_seed(0))
    cfg = TrainerConfig(batch_size=PARITY_BATCH, warmup_steps=1)
    state = create_train_state(model, cfg, torch.device(device))
    step = make_train_step(cfg.temperature, use_fused=True)
    _, metrics = step(state, *(v.to(device) for v in views))
    grads = torch.cat([p.grad.detach().float().cpu().flatten()
                       for p in state.model.parameters()])
    return metrics["loss"].item(), grads


def phase_step_parity() -> None:
    """One train step on the card vs the same step on the CPU (the
    kernels' plain versions): fp32 within fixed tolerances; the path's
    bf16 printed beside the CPU's own bf16-vs-fp32 gap (see PARITY_*)."""
    import torch

    rng = np.random.default_rng(0)
    views = [torch.from_numpy(rng.uniform(size=(
        PARITY_BATCH, 224, 224, 3)).astype(np.float32)) for _ in range(2)]
    steps, cpu_s = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.monotonic()
        steps[dtype, "cpu"] = _parity_step(dtype, "cpu", views)
        cpu_s[dtype] = time.monotonic() - t0
        steps[dtype, "cuda"] = _parity_step(dtype, "cuda", views)

    def gap(a, b):
        """(|loss_a - loss_b|, |g_a - g_b| / |g_b|)."""
        (loss_a, g_a), (loss_b, g_b) = steps[a], steps[b]
        return abs(loss_a - loss_b), ((g_a - g_b).norm() / g_b.norm()).item()

    noise = gap(("bfloat16", "cpu"), ("float32", "cpu"))
    print(f"[parity] bf16 rounding on the CPU (its bf16 step vs its fp32 "
          f"step): loss {noise[0]:.2e}, gradient {noise[1]:.2e}", flush=True)
    for dtype in ("float32", "bfloat16"):
        loss_err, grad_err = gap((dtype, "cuda"), (dtype, "cpu"))
        if dtype == "float32":
            ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
            verdict = (f"(atol {PARITY_LOSS_ATOL:.2e}, rtol "
                       f"{PARITY_GRAD_RTOL:.2e}) {'ok' if ok else 'MISMATCH'}")
        else:
            ok, verdict = True, "(a reading, not gated)"
        print(f"[parity] ViT-B/16 train step {dtype}, batch {PARITY_BATCH}: "
              f"loss card {steps[dtype, 'cuda'][0]:.6f} vs CPU "
              f"{steps[dtype, 'cpu'][0]:.6f} (|err| {loss_err:.2e}); "
              f"gradient |g_card - g_cpu| / |g_cpu| = {grad_err:.2e}; CPU "
              f"step {cpu_s[dtype]:.1f} s {verdict}", flush=True)
        if not ok:
            fail(f"the card's {dtype} train step disagrees with the CPU's")


def phase_clip_train(card_line: str) -> dict:
    """ntxent-train --objective clip on the card; returns the launches of
    each kernel."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(CLIP_ARGV)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    state, history = cli.train(args)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != CLIP_STEPS or not all(map(math.isfinite, losses)):
        fail(f"CLIP losses {losses}: expected {CLIP_STEPS} finite values")
    want = {n: CLIP_STEP_LAUNCHES.get(n, 0) * CLIP_STEPS for n in counters}
    if launches != want:
        fail(f"kernel launches over {CLIP_STEPS} CLIP steps {launches}, "
             f"expected {want}")
    model = state.model
    initial = cli.build_clip_model(args).state_dict()
    moved = max((p.detach().cpu() - initial[n]).abs().max().item()
                for n, p in model.named_parameters())
    if not moved > 0:
        fail("no CLIP parameter changed over the train steps")
    g = model.logit_scale.grad
    if g is None or not g.abs().item() > 0:
        fail("the logit scale has no gradient")
    for tower in ("image_tower", "text_tower"):
        for i, block in enumerate(getattr(model, tower).blocks):
            for proj in ("query", "key", "value"):
                g = getattr(block.attn, proj).weight.grad
                if g is None or not g.abs().sum().item() > 0:
                    fail(f"{tower} block {i} attn.{proj}.weight has no "
                         "gradient")
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    print(f"[clip] CLIP ViT-B/16 (text width 512, 12 blocks, 77 tokens) "
          f"flash, batch {args.batch} pairs, {CLIP_STEPS} steps in "
          f"{wall_s:.1f} s: losses {[round(x, 4) for x in losses]}; launches "
          f"per step { {n: c // CLIP_STEPS for n, c in launches.items()} }; "
          f"largest parameter change {moved:.3e}; logit-scale gradient "
          f"{model.logit_scale.grad.item():.3e}; every q/k/v weight of both "
          f"towers has a nonzero gradient", flush=True)
    print(f"[clip] step {step_ms:.1f} ms (steps 2-{CLIP_STEPS}, host clock "
          f"around a synchronizing loss read), "
          f"{args.batch / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) on "
          f"{card_line}", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return launches


def _clip_parity_step(model, device: str, images, tokens):
    """(loss, flat fp32 gradient) of one fp32 CLIP train step of a copy of
    ``model`` on ``device``."""
    import copy

    import torch

    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_clip_train_state,
        make_clip_train_step,
    )

    cfg = TrainerConfig(batch_size=CLIP_PARITY_BATCH, base_lr=5e-4,
                        warmup_steps=1)
    state = create_clip_train_state(copy.deepcopy(model), cfg,
                                    torch.device(device))
    step = make_clip_train_step(use_fused=True)
    _, metrics = step(state, images.to(device), tokens.to(device))
    grads = torch.cat([p.grad.detach().float().cpu().flatten()
                       for p in state.model.parameters()])
    return metrics["loss"].item(), grads


def phase_clip_parity() -> None:
    """One fp32 CLIP step on the card vs the same step on the CPU (the
    kernels' plain versions) from the same weights, images and tokens."""
    import torch

    from ntxent_tpu_torch.models import (
        CLIPModel,
        TextTransformer,
        ViT_B16,
        init_weights,
    )

    model = init_weights(
        CLIPModel(ViT_B16(image_size=224, attention_impl="flash",
                          dtype=torch.float32),
                  TextTransformer(dtype=torch.float32)),
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(size=(
        CLIP_PARITY_BATCH, 224, 224, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, 49408, (CLIP_PARITY_BATCH,
                                                      77)))
    t0 = time.monotonic()
    loss_cpu, g_cpu = _clip_parity_step(model, "cpu", images, tokens)
    cpu_s = time.monotonic() - t0
    loss_gpu, g_gpu = _clip_parity_step(model, "cuda", images, tokens)
    loss_err = abs(loss_gpu - loss_cpu)
    grad_err = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
    print(f"[clip-parity] CLIP ViT-B/16 train step float32, batch "
          f"{CLIP_PARITY_BATCH}: loss card {loss_gpu:.6f} vs CPU "
          f"{loss_cpu:.6f} (|err| {loss_err:.2e}, atol "
          f"{PARITY_LOSS_ATOL:.2e}); gradient |g_card - g_cpu| / |g_cpu| = "
          f"{grad_err:.2e} (rtol {PARITY_GRAD_RTOL:.2e}); CPU step "
          f"{cpu_s:.1f} s {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the card's fp32 CLIP train step disagrees with the CPU's")


def _general_ids(rows, cols, scattered, seed):
    """(row_gid, col_gid, cols_actual, n_half) on the card: the strip of
    rank 3 of 4 (ids: indices of the gathered columns; a padding row with
    the sentinel 2N when ``rows`` is odd), or, ``scattered``, columns with
    scattered global ids of a problem twice as wide (the ring's block)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if not scattered:
        n = rows // 2
        base = 3 * n + torch.arange(n) if rows < cols else torch.arange(n)
        ids = [base, cols // 2 + base] + ([torch.tensor([cols])]
                                          if rows % 2 else [])
        return torch.cat(ids).cuda(), None, cols, cols // 2
    total = 2 * cols
    col_gid = torch.randperm(total, generator=gen)[:cols]
    row_gid = torch.cat([col_gid[:rows // 2], torch.randperm(
        total, generator=gen)[:rows - rows // 2]])
    return row_gid.cuda(), col_gid.cuda(), total, total // 2


def _general_bounds(rows, cols, d, extra=0):
    """Bounds of #1 general and of each #6 kernel at fp32 (R, C, D): each
    input read once (z_rows, z_cols, the row ids, ``extra`` bytes such as
    a scale; the lse for #6), each output written once; 2 R C D and 4 R C
    D fp32 operations."""
    inputs = (rows + cols) * d * 4 + rows * 4 + extra
    return (_bound(inputs + rows * 4 + 4, 2 * rows * cols * d,
                   PEAK_FP32_FLOPS),
            _bound(inputs + rows * 4 + rows * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS),
            _bound(inputs + rows * 4 + cols * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS))


def phase_general_kernels() -> list[dict]:
    """#1 general, #6 rows and #6 cols against their plain versions, then
    times at every fp32 strip shape."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t = NTX_TEMPERATURE
    errs = {}
    for rows, cols, d in GENERAL_SHAPES:
        for dtype in ("float32", "bfloat16"):
            for scattered in (False, True):
                zr = _unit_rows(rows, d, dtype, seed=rows + d)
                zc = _unit_rows(cols, d, dtype, seed=cols + d)
                row_gid, col_gid, total, n_half = _general_ids(
                    rows, cols, scattered, seed=rows)
                kw = dict(col_gid=col_gid, cols_actual=total, n_half=n_half)
                args = (zr, zc, row_gid)
                loss, lse = N.ntxent_fwd_general(*args, t, **kw)
                g_rows = N.ntxent_bwd_general_rows(*args, lse, t, **kw)
                g_cols = N.ntxent_bwd_general_cols(*args, lse, t, **kw)
                loss_ref, lse_ref = N.ntxent_fwd_general_plain(*args, t, **kw)
                g_rows_ref = N.ntxent_bwd_general_rows_plain(
                    *args, lse_ref, t, **kw)
                g_cols_ref = N.ntxent_bwd_general_cols_plain(
                    *args, lse_ref, t, **kw)
                again, _ = N.ntxent_fwd_general(*args, t, **kw)
                torch.cuda.synchronize()
                fwd_err = max((lse - lse_ref).abs().max().item(),
                              abs(loss.item() - loss_ref.item()) / rows)
                rows_err = (g_rows - g_rows_ref).abs().max().item()
                cols_err = (g_cols - g_cols_ref).abs().max().item()
                repeat = again.item() == loss.item()
                ok = (max(fwd_err, rows_err, cols_err) <= NTX_ATOL
                      and repeat)
                print(f"[general] R={rows} C={cols} D={d} {dtype} "
                      f"{'scattered column ids' if scattered else 'strip'}: "
                      f"fwd max|err| {fwd_err:.3e}, rows {rows_err:.3e}, "
                      f"cols {cols_err:.3e} (atol {NTX_ATOL:g}), loss "
                      f"bitwise repeatable {repeat} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"the general NT-Xent kernels disagree with their "
                         f"plain versions at R={rows} C={cols} D={d} "
                         f"{dtype} (scattered ids: {scattered})")
                if (rows, cols, dtype, scattered) == (512, 512, "float32",
                                                      False):
                    errs = {"ntxent_fwd_general": fwd_err,
                            "ntxent_bwd_general_rows": rows_err,
                            "ntxent_bwd_general_cols": cols_err}
                del zr, zc, g_rows, g_cols, g_rows_ref, g_cols_ref

    times = {}
    for rows, cols, d in GENERAL_SHAPES[:3]:
        zr = _unit_rows(rows, d, "float32", seed=1)
        zc = _unit_rows(cols, d, "float32", seed=2)
        row_gid = _general_ids(rows, cols, False, seed=0)[0]
        args = (zr, zc, row_gid)
        _, lse = N.ntxent_fwd_general(*args, t)
        runs = 3 if cols > 4096 else 10
        ms = (cuda_time_ms(lambda: N.ntxent_fwd_general(*args, t), runs),
              cuda_time_ms(lambda: N.ntxent_bwd_general_rows(*args, lse, t),
                           runs),
              cuda_time_ms(lambda: N.ntxent_bwd_general_cols(*args, lse, t),
                           runs))
        plain = (
            cuda_time_ms(lambda: N.ntxent_fwd_general_plain(*args, t), runs),
            cuda_time_ms(lambda: N.ntxent_bwd_general_rows_plain(
                *args, lse, t), runs),
            cuda_time_ms(lambda: N.ntxent_bwd_general_cols_plain(
                *args, lse, t), runs))
        bounds = _general_bounds(rows, cols, d)
        print(f"[general] R={rows} C={cols} D={d} fp32: fwd {ms[0]:.4f} ms "
              f"(plain {plain[0]:.4f}, bound {bounds[0][0]:.5f}), rows "
              f"{ms[1]:.4f} ms (plain {plain[1]:.4f}, bound "
              f"{bounds[1][0]:.5f}), cols {ms[2]:.4f} ms (plain "
              f"{plain[2]:.4f}, bound {bounds[2][0]:.5f}); no single PyTorch "
              f"call computes them, so there is no library time", flush=True)
        times[rows, cols] = (ms, plain, bounds)
        del zr, zc
    names = ("ntxent_fwd_general", "ntxent_bwd_general_rows",
             "ntxent_bwd_general_cols")
    replaces = (
        "ntxent_tpu/ops/ntxent_pallas.py:130 (_fwd_kernel in its general "
        "mode, _fwd_call :190)",
        "ntxent_tpu/ops/ntxent_pallas.py:552 (_bwd_rows_kernel, "
        "_bwd_general_call :648)",
        "ntxent_tpu/ops/ntxent_pallas.py:580 (_bwd_cols_kernel, "
        "_bwd_general_call :648)")
    sources = ("ntxent_tpu_torch/csrc/ntxent_fwd.cu",
               "ntxent_tpu_torch/csrc/ntxent_bwd_general.cu",
               "ntxent_tpu_torch/csrc/ntxent_bwd_general.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds = times[512, 512]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True, "launches": None,
                 "max_abs_err": errs[name], "ms": ms[i],
                 "plain_ms": plain[i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "library_ms": None}
        for (rows, cols), tag in (((128, 512), "rank4"),
                                  ((2048, 8192), "rank4_b4096")):
            ms, plain, bounds = times[rows, cols]
            entry |= {f"{tag}_ms": ms[i], f"{tag}_plain_ms": plain[i],
                      f"{tag}_bound_ms": bounds[i][0]}
        out.append(entry)
    return out


def _twopass_run(za, zb, gid, scale, plain=False):
    """(loss_sum, lse, grad rows, grad cols) of #1 and #6 in the InfoNCE
    mode (temperature 1, the scale on the card), from the kernels or from
    their plain versions."""
    from ntxent_tpu_torch.ops import ntxent as N

    kw = dict(diag_pos=True, scale=scale)
    fwd, rows, cols = ((N.ntxent_fwd_general_plain,
                        N.ntxent_bwd_general_rows_plain,
                        N.ntxent_bwd_general_cols_plain) if plain else
                       (N.ntxent_fwd_general, N.ntxent_bwd_general_rows,
                        N.ntxent_bwd_general_cols))
    loss, lse = fwd(za, zb, gid, 1.0, **kw)
    return (loss, lse, rows(za, zb, gid, lse, 1.0, **kw),
            cols(za, zb, gid, lse, 1.0, **kw))


def phase_twopass_kernels() -> dict:
    """#1 and #6 in their InfoNCE mode against their plain versions at
    every TWOPASS_SHAPES entry, fp32 and bf16, at both TWOPASS_SCALES,
    bitwise repeatable; in fp32 at the first two shapes at least
    TF32_CONTROL_FACTOR below a one-pass TF32 control; then times at the
    first two. Returns the fields this mode adds to each kernel's entry."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    names = ("ntxent_fwd_general", "ntxent_bwd_general_rows",
             "ntxent_bwd_general_cols")
    out = {name: {} for name in names}
    for rows, cols, d in TWOPASS_SHAPES:
        gid = _dp_clip_ids(rows, cols, seed=rows)
        for dtype in ("float32", "bfloat16"):
            za = _unit_rows(rows, d, dtype, seed=rows + d)
            zb = _unit_rows(cols, d, dtype, seed=cols + d + 1)
            for value in TWOPASS_SCALES:
                scale = torch.tensor(value, device="cuda")
                got = _twopass_run(za, zb, gid, scale)
                again = _twopass_run(za, zb, gid, scale)
                want = _twopass_run(za, zb, gid, scale, plain=True)
                torch.cuda.synchronize()
                errs = [abs(got[0].item() - want[0].item()) / rows] + [
                    (g - w).abs().max().item()
                    for g, w in zip(got[1:], want[1:])]
                fwd_err = max(errs[:2])
                repeat = all(torch.equal(a, b) for a, b in zip(got, again))
                atol = _twopass_atol(value)
                ok = max(errs) <= atol and repeat
                print(f"[twopass-kernel] R={rows} C={cols} D={d} {dtype} "
                      f"scale {value:g}: #1 fwd max|err| {fwd_err:.3e}, #6 "
                      f"rows {errs[2]:.3e}, cols {errs[3]:.3e} (atol "
                      f"{atol:.2e}); bitwise repeatable {repeat} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"#1 and #6 in the InfoNCE mode disagree with their "
                         f"plain versions at R={rows} C={cols} D={d} {dtype} "
                         f"scale {value:g}")
                if (rows, cols, dtype, value) == (256, 256, "float32",
                                                  TWOPASS_SCALES[0]):
                    for name, err in zip(names, (fwd_err, *errs[2:])):
                        out[name]["twopass_max_abs_err"] = err
            del za, zb

    for rows, cols, d in TWOPASS_SHAPES[:2]:
        gid = _dp_clip_ids(rows, cols, seed=rows)
        za = _unit_rows(rows, d, "float32", seed=rows)
        zb = _unit_rows(cols, d, "float32", seed=cols + 1)
        scale = torch.tensor(TWOPASS_SCALES[0], device="cuda")
        want = _twopass_run(za, zb, gid, scale, plain=True)
        got = _twopass_run(za, zb, gid, scale)
        ctl = _twopass_run(N.tf32_split(za)[0], N.tf32_split(zb)[0], gid,
                           scale, plain=True)
        torch.cuda.synchronize()
        pairs = [((g - w).abs().max().item(), (c - w).abs().max().item())
                 for g, c, w in zip(got[1:], ctl[1:], want[1:])]
        ok = all(TF32_CONTROL_FACTOR * k <= c for k, c in pairs)
        print(f"[twopass-kernel] TF32 control R={rows} C={cols} D={d} fp32 "
              f"scale {TWOPASS_SCALES[0]:g}: kernels lse / rows / cols "
              f"{' / '.join(f'{k:.3e}' for k, _ in pairs)}, one TF32 pass "
              f"{' / '.join(f'{c:.3e}' for _, c in pairs)} (ratios "
              f"{', '.join(f'{c / max(k, 1e-30):.1f}' for k, c in pairs)}; "
              f"at least {TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"#1 and #6 in the InfoNCE mode are not "
                 f"{TF32_CONTROL_FACTOR}x more accurate than one TF32 pass "
                 f"at R={rows} C={cols}")

        lse = got[1]
        kw = dict(diag_pos=True, scale=scale)
        args = (za, zb, gid)
        runs = 3 if cols > 1024 else 10
        calls = ((lambda: N.ntxent_fwd_general(*args, 1.0, **kw),
                  lambda: N.ntxent_fwd_general_plain(*args, 1.0, **kw)),
                 (lambda: N.ntxent_bwd_general_rows(*args, lse, 1.0, **kw),
                  lambda: N.ntxent_bwd_general_rows_plain(*args, lse, 1.0,
                                                          **kw)),
                 (lambda: N.ntxent_bwd_general_cols(*args, lse, 1.0, **kw),
                  lambda: N.ntxent_bwd_general_cols_plain(*args, lse, 1.0,
                                                          **kw)))
        bounds = _general_bounds(rows, cols, d, extra=4)
        tag = "twopass" if rows == cols else "twopass_rank4_b4096"
        parts = []
        for name, (kernel, plain), bound in zip(names, calls, bounds):
            ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(plain, runs)
            out[name] |= {f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms,
                          f"{tag}_bound_ms": bound[0]}
            parts.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f}, bound "
                         f"{bound[0]:.5f} by {bound[1]})")
        print(f"[twopass-kernel] R={rows} C={cols} D={d} fp32, InfoNCE mode: "
              f"{'; '.join(parts)}; no single PyTorch call computes them, so "
              f"there is no library time", flush=True)
        del za, zb, want, got, ctl
    return out


def phase_twopass_emulated_ranks() -> None:
    """P = 2 and 4 ranks of the two-pass loss at global batch 256 (D =
    512) one after another on the card, through info_nce_partial_fused as
    local_infonce_allgather calls it: each rank's za rows against all zb
    and its zb rows against all za, with their global ids; the partial
    losses summed, the gradients of each rank's rows and of the gathered
    columns summed by autograd (what the all-gathers' reduce-scatters do),
    against the single-card info_nce_fused loss and its gradients of za,
    zb and the scale."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I
    from ntxent_tpu_torch.utils.profiling import launch_counters

    batch, d = EMULATED_BATCH, 512
    za0 = _unit_rows(batch, d, "float32", seed=13)
    zb0 = _unit_rows(batch, d, "float32", seed=14)

    def leaves():
        return (za0.clone().requires_grad_(), zb0.clone().requires_grad_(),
                torch.tensor(DP_CLIP_SCALE, dtype=torch.float32,
                             device="cuda", requires_grad=True))

    a, b, s = leaves()
    ref = I.info_nce_fused(a, b, scale=s)
    ref.backward()
    want = (a.grad, b.grad, s.grad)
    counters = launch_counters()
    for p in TWOPASS_WORLDS:
        n = batch // p
        for wrapper in counters.values():
            wrapper.launches = 0
        za, zb, scale = leaves()
        loss = 0.0
        for rank in range(p):
            gid = rank * n + torch.arange(n, dtype=torch.int32,
                                          device="cuda")
            rows = slice(rank * n, (rank + 1) * n)
            loss = loss + I.info_nce_partial_fused(za[rows], zb, gid,
                                                   scale=scale) \
                + I.info_nce_partial_fused(zb[rows], za, gid, scale=scale)
        loss = loss / (2 * batch)
        loss.backward()
        torch.cuda.synchronize()
        launches = {k: c for k, c in ((k, w.launches)
                                      for k, w in counters.items()) if c}
        loss_err = abs(loss.item() - ref.item())
        grad_errs = [((g - w).norm() / w.norm()).item()
                     for g, w in zip((za.grad, zb.grad, scale.grad), want)]
        expect = {k: 2 * p for k in TWOPASS_STEP_LAUNCHES
                  if not k.startswith("flash")}
        ok = (loss_err <= DP_CLIP_LOSS_ATOL
              and max(grad_errs) <= DP_CLIP_GRAD_RTOL and launches == expect)
        print(f"[twopass-ranks] P = {p} ranks emulated at global batch "
              f"{batch} (D = {d}): summed partial losses / 2N "
              f"{loss.item():.6f} vs single card {ref.item():.6f} (|err| "
              f"{loss_err:.2e}, atol {DP_CLIP_LOSS_ATOL:g}); relative "
              f"gradient errors za {grad_errs[0]:.2e}, zb {grad_errs[1]:.2e}, "
              f"scale {grad_errs[2]:.2e} (rtol {DP_CLIP_GRAD_RTOL:g}); "
              f"launches {launches} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"the {p} emulated ranks of the two-pass InfoNCE disagree "
                 f"with the single-card loss and gradients or launched "
                 f"{launches}")


def _clip_steps(step, initial, steps: int):
    """Run ``steps`` CLIP steps of ``step`` from a copy of the CPU model
    ``initial`` on the synthetic pairs of CLIP_DP_ARGV: (losses, launches,
    the final parameters on the host, ms a step after the first)."""
    import copy

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import create_clip_train_state
    from ntxent_tpu_torch.training.datasets import (
        PairedArrayLoader,
        PairedPipeline,
    )
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(CLIP_DP_ARGV)
    images, tokens = cli._clip_data(args)
    state = create_clip_train_state(copy.deepcopy(initial),
                                    cli._clip_config(args),
                                    torch.device("cuda"))
    data = iter(PairedPipeline(PairedArrayLoader(images, tokens, args.batch,
                                                 seed=args.seed),
                               torch.device("cuda")))
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    losses, times = [], []
    for _ in range(steps):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = step(state, *batch)
        losses.append(metrics["loss"].item())
        times.append(time.monotonic() - t0)
    launches = {name: w.launches for name, w in counters.items()}
    params = {n: p.detach().float().cpu()
              for n, p in state.model.named_parameters()}
    del state
    torch.cuda.empty_cache()
    return losses, launches, params, 1e3 * sum(times[1:]) / (steps - 1)


def _update_errors(params, want, before):
    """(worst relative difference of a parameter's change from ``want``'s,
    its name, the largest change of an attention key bias)."""
    worst, worst_name, noise = 0.0, "", 0.0
    for name, p in params.items():
        delta, delta_w = p - before[name], want[name] - before[name]
        if name.endswith("attn.key.bias"):
            noise = max(noise, delta.abs().max().item(),
                        delta_w.abs().max().item())
            continue
        err = ((delta - delta_w).norm() / delta_w.norm().clamp(
            min=1e-30)).item()
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, noise


def phase_twopass_train(card_line: str) -> dict:
    """The full-width CLIP ViT-B/16 step with loss_impl="twopass" over the
    NCCL group of world 1 at --batch 256, TWOPASS_STEPS steps, against the
    "dual" step from the same weights and batches: in the path's bf16
    towers finite losses within PARITY_LOSS_ATOL a step and exactly
    TWOPASS_STEP_LAUNCHES a step; in fp32 towers the losses and each
    parameter's change (see TWOPASS_LR's comment). Returns the launches
    of each kernel on the bf16 path."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.models import (
        CLIPModel,
        TextTransformer,
        ViT_B16,
        init_weights,
    )
    from ntxent_tpu_torch.training import make_sharded_clip_train_step

    args = cli.build_train_parser().parse_args(CLIP_DP_ARGV)
    cli._clip_data(args)  # resolves the image size and the token length
    group = torch.distributed.group.WORLD
    bf16 = cli.build_clip_model(args)
    fp32 = init_weights(
        CLIPModel(ViT_B16(image_size=args.image_size, attention_impl="flash",
                          dtype=torch.float32),
                  TextTransformer(vocab_size=args.vocab_size,
                                  max_len=args.token_len,
                                  dtype=torch.float32)),
        torch.Generator().manual_seed(args.seed))
    torch.backends.cuda.matmul.allow_tf32 = False
    noise_bound = 2 * TWOPASS_LR * (TWOPASS_STEPS - 1)
    launches, ok = None, True
    for dtype, initial in (("bf16", bf16), ("fp32", fp32)):
        before = {n: p.detach().float()
                  for n, p in initial.named_parameters()}
        (losses_d, _, params_d, ms_d), (losses, got, params, ms) = (
            _clip_steps(make_sharded_clip_train_step(group, impl), initial,
                        TWOPASS_STEPS) for impl in ("dual", "twopass"))
        loss_err = max(abs(a - b) for a, b in zip(losses, losses_d))
        worst, worst_name, noise = _update_errors(params, params_d, before)
        gated = dtype == "fp32"
        step_ok = (all(map(math.isfinite, losses))
                   and loss_err <= PARITY_LOSS_ATOL
                   and (not gated or (worst <= PARITY_GRAD_RTOL
                                      and noise <= noise_bound)))
        if dtype == "bf16":
            launches = got
            want = {n: TWOPASS_STEP_LAUNCHES.get(n, 0) * TWOPASS_STEPS
                    for n in got}
            step_ok = step_ok and launches == want
        ok = ok and step_ok
        print(f"[twopass] CLIP ViT-B/16 {dtype} towers, data-parallel over "
              f"NCCL (world 1), batch {args.batch} pairs, loss_impl="
              f"\"twopass\" vs \"dual\" from the same weights and batches, "
              f"{TWOPASS_STEPS} steps: losses "
              f"{[round(x, 6) for x in losses]} vs "
              f"{[round(x, 6) for x in losses_d]} (max |err| {loss_err:.2e}, "
              f"atol {PARITY_LOSS_ATOL:g}); each parameter's change within "
              f"{worst:.2e} of the dual step's "
              f"({f'rtol {PARITY_GRAD_RTOL:g}' if gated else 'a reading'}; "
              f"worst {worst_name}), the attention key biases' largest "
              f"change {noise:.2e} (AdamW's bound {noise_bound:g}); "
              + (f"launches per step "
                 f"{ {n: c // TWOPASS_STEPS for n, c in got.items() if c} } "
                 f"(every other kernel 0) " if dtype == "bf16" else "")
              + ("ok" if step_ok else "MISMATCH"), flush=True)
        print(f"[twopass] {dtype} step {ms:.1f} ms, dual step {ms_d:.1f} ms "
              f"(steps 2-{TWOPASS_STEPS}, host clock around a synchronizing "
              f"loss read), {args.batch / ms * 1e3:.1f} images/s on "
              f"{card_line}", flush=True)
    if not ok:
        fail("the two-pass CLIP step disagrees with the dual step or "
             f"launched {launches}")
    return launches


def phase_emulated_ranks() -> None:
    """P = 4 ranks one after another on the card: each rank's strip loss
    and its row and column gradients from the kernels; the losses summed,
    the column gradients summed and the row gradients scattered (what the
    all-gather's reduce-scatter and the psum do), against the single-card
    ntxent_fwd / ntxent_bwd_sym on the same 2N rows."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    t, p, batch, d = NTX_TEMPERATURE, EMULATED_RANKS, EMULATED_BATCH, 128
    z = _unit_rows(2 * batch, d, "float32", seed=7)   # [view 1; view 2]
    n = batch // p
    loss, grad = 0.0, torch.zeros_like(z)
    for rank in range(p):
        gid = local_row_gids(rank, n, p, z.device)
        z_local = z[gid.long()]
        loss_r, lse_r = N.ntxent_fwd_general(z_local, z, gid, t)
        grad.index_add_(0, gid.long(),
                        N.ntxent_bwd_general_rows(z_local, z, gid, lse_r, t))
        grad += N.ntxent_bwd_general_cols(z_local, z, gid, lse_r, t)
        loss = loss + loss_r
    loss_sym, lse = N.ntxent_fwd(z, t)
    grad_sym = N.ntxent_bwd_sym(z, lse, t)
    torch.cuda.synchronize()
    loss_err = abs(loss.item() - loss_sym.item()) / (2 * batch)
    grad_err = ((grad - grad_sym).norm() / grad_sym.norm()).item()
    ok = loss_err <= EMULATED_LOSS_ATOL and grad_err <= EMULATED_GRAD_RTOL
    print(f"[ranks] {p} ranks emulated at global batch {batch} (2N = "
          f"{2 * batch}, D = {d}): sum of strip losses / 2N "
          f"{loss.item() / (2 * batch):.6f} vs single card "
          f"{loss_sym.item() / (2 * batch):.6f} (|err| {loss_err:.2e}, atol "
          f"{EMULATED_LOSS_ATOL:g}); gradient |g_ranks - g_card| / |g_card| "
          f"= {grad_err:.2e} (rtol {EMULATED_GRAD_RTOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the emulated ranks' strip losses do not sum to the single-card "
             "loss and gradient")


def phase_dp_train(card_line: str, argv=DP_ARGV,
                   step_launches=DP_STEP_LAUNCHES, tag: str = "dp",
                   out: dict | None = None) -> dict:
    """Data-parallel ResNet-50 SimCLR through ntxent_tpu_torch.cli over
    the NCCL group of world 1 (``argv``: the strip loss, or with
    ``--dp-loss pair`` the pair loss, ``chunked``, a wire dtype); returns
    the launches of each kernel. ``out`` receives the losses, the step ms
    and the largest error-feedback residual (None without one)."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.models import BatchNorm
    from ntxent_tpu_torch.models.resnet import Conv
    from ntxent_tpu_torch.parallel import mesh
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(argv)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    mark = mesh.comms_accounting().totals()
    t0 = time.monotonic()
    state, history = cli.train(args, data_parallel=True)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    comms = mesh.comms_accounting().delta(mark)
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != DP_STEPS or not all(map(math.isfinite, losses)):
        fail(f"data-parallel losses {losses}: expected {DP_STEPS} finite "
             "values")
    want = {n: step_launches.get(n, 0) * DP_STEPS for n in counters}
    if launches != want:
        fail(f"kernel launches over {DP_STEPS} data-parallel steps "
             f"{launches}, expected {want}")
    weights = [(n, m.weight) for n, m in state.model.named_modules()
               if isinstance(m, (Conv, BatchNorm))]
    for name, w in weights:
        if w.grad is None or not w.grad.abs().sum().item() > 0:
            fail(f"{name}.weight has no gradient in the data-parallel step")
    convs = sum(isinstance(m, Conv) for m in state.model.modules())
    norms = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    images_per_s = 2 * args.batch / step_ms * 1e3
    print(f"[{tag}] ResNet-50 SimCLR data-parallel over NCCL (world 1), "
          f"--dp-loss {args.dp_loss}, batch "
          f"{args.batch} (2 x {args.batch} views at 224 px), {DP_STEPS} "
          f"steps in {wall_s:.1f} s: losses {[round(x, 4) for x in losses]}; "
          f"launches per step "
          f"{ {n: c // DP_STEPS for n, c in launches.items() if c} } (every "
          f"other kernel 0); all {convs} convolutions and {norms} BatchNorms "
          f"have a nonzero weight gradient; comms over the run (calls, "
          f"bytes per device; 0 at world 1) "
          f"{ {op: c for (op, _), c in comms.items()} }", flush=True)
    print(f"[{tag}] step {step_ms:.1f} ms (steps 2-{DP_STEPS}, host clock "
          f"around a synchronizing loss read), {images_per_s:.1f} images/s, "
          f"peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {card_line}", flush=True)
    if out is not None:
        out.update(losses=losses, step_ms=step_ms, residual=None if
                   state.ef_residual is None else max(
                       e.abs().max().item() for e in state.ef_residual))
    del state
    torch.cuda.empty_cache()
    return launches


def _dp_parity_step(sharded: bool, views, loss_impl: str = "strip",
                    ring_chunks: int | None = None, fsdp: bool = False):
    """(loss, flat fp32 gradient) of one fp32 ResNet-50 step from the
    weights of seed 0: the data-parallel step at world 1 (with the
    ``loss_impl`` schedule, ``ring_chunks`` for chunked; ``fsdp``: the
    ZeRO-3 step over the world of one) or the single-card step."""
    import torch

    from ntxent_tpu_torch.models import (
        ResNet50,
        SimCLRModel,
        cross_replica_batch_norm,
        init_weights,
    )
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_train_state,
        make_sharded_train_step,
        make_train_step,
    )

    model = init_weights(SimCLRModel(ResNet50(dtype=torch.float32),
                                     dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    cfg = TrainerConfig(batch_size=DP_PARITY_BATCH, warmup_steps=1)
    if sharded:
        cross_replica_batch_norm(model, torch.distributed.group.WORLD)
        step = make_sharded_train_step(None, cfg.temperature,
                                       loss_impl=loss_impl,
                                       ring_chunks=ring_chunks)
    else:
        step = make_train_step(cfg.temperature, use_fused=True)
    state = create_train_state(model, cfg, torch.device("cuda"))
    if fsdp:
        from ntxent_tpu_torch.parallel import (
            make_fsdp_train_step,
            shard_train_state_fsdp,
        )

        state = shard_train_state_fsdp(state)
        step = make_fsdp_train_step(cfg.temperature)
    _, metrics = step(state, *(v.cuda() for v in views))
    grads = torch.cat([p.grad.detach().float().cpu().flatten()
                       for p in state.model.parameters()])
    return metrics["loss"].item(), grads


def phase_dp_parity() -> None:
    """The world-1 data-parallel step against the single-card step, and
    the world-1 pair and chunked steps against the world-1 strip step:
    fp32 ResNet-50, same weights and views, TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    views = [torch.from_numpy(rng.uniform(size=(
        DP_PARITY_BATCH, 224, 224, 3)).astype(np.float32)) for _ in range(2)]
    loss_dp, g_dp = _dp_parity_step(True, views)
    loss_one, g_one = _dp_parity_step(False, views)
    loss_pair, g_pair = _dp_parity_step(True, views, loss_impl="pair")
    loss_chunk, g_chunk = _dp_parity_step(True, views, loss_impl="chunked",
                                          ring_chunks=DP_CHUNKS)
    for tag, (loss_a, g_a), (loss_b, g_b), what in (
            ("dp-parity", (loss_dp, g_dp), (loss_one, g_one),
             "data-parallel (world 1) vs single card"),
            ("dp-pair-parity", (loss_pair, g_pair), (loss_dp, g_dp),
             "pair (world 1) vs strip (world 1)"),
            ("dp-chunked-parity", (loss_chunk, g_chunk), (loss_dp, g_dp),
             f"chunked, {DP_CHUNKS} chunks (world 1) vs strip (world 1)")):
        loss_err = abs(loss_a - loss_b)
        grad_err = ((g_a - g_b).norm() / g_b.norm()).item()
        ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
        print(f"[{tag}] ResNet-50 train step float32, batch "
              f"{DP_PARITY_BATCH}: loss {what} {loss_a:.6f} vs {loss_b:.6f} "
              f"(|err| {loss_err:.2e}, atol {PARITY_LOSS_ATOL:.2e}); "
              f"relative gradient error {grad_err:.2e} (rtol "
              f"{PARITY_GRAD_RTOL:.2e}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"the ResNet-50 steps disagree: {what}")


def _census_line(name: str, entries) -> str:
    from ntxent_tpu_torch.analysis.graph.census import wire_totals

    per = wire_totals(entries, keep_zero=True)
    return f"{name}: " + (", ".join(
        f"{op} {c} call{'s' * (c != 1)} {b:.0f} B"
        for op, (c, b) in sorted(per.items())) or "no collective")


def phase_audit(card_line: str) -> None:
    """[audit]: the port's ntxent-audit on the card in the NCCL group of
    world 1; fails on any gap (an unmapped c10d op raises from the
    census, nothing catches it)."""
    import torch

    from ntxent_tpu_torch.analysis.graph.census import (
        census_of_callable,
        declared_wire_totals,
        wire_totals,
    )
    from ntxent_tpu_torch.analysis.graph.donation import donation_findings
    from ntxent_tpu_torch.analysis.graph.targets import default_targets
    from ntxent_tpu_torch.analysis.graph.wiredtype import (
        wire_dtype_findings,
    )
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    targets = {t.name: t for t in default_targets(
        device=SMOKE_DEVICE, dim=CENSUS_DIM, n_local=CENSUS_ROWS)}
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    lines = []
    for name in ("dist_loss/fwd", "dist_loss/grad"):
        built = targets[name].build()
        entries, declared = census_of_callable(built["fn"], *built["args"])
        torch.cuda.synchronize()
        seen = wire_totals(entries, keep_zero=True)
        for op, (calls, _) in declared_wire_totals(
                declared, keep_zero=True).items():
            if seen.get(op, (0, 0.0))[0] < calls:
                fail(f"audit: {name} declared {calls} {op} call(s), the "
                     f"census saw {seen.get(op)}")
        lines.append(_census_line(name, entries))
        if name == "dist_loss/grad":
            scatter = [e for e in entries if e.op == "psum_scatter"]
            if not scatter or {e.thread for e in scatter} != {"autograd"}:
                fail(f"audit: the backward's reduce_scatter_tensor was not "
                     f"seen on autograd's device thread: "
                     f"{[(e.op, e.thread) for e in entries]}")
    launched = {k: counters[k].launches for k in CENSUS_KERNELS}
    if not all(launched.values()):
        fail(f"audit: the strip's kernels did not launch under the census: "
             f"{launched}")
    for name in ("grad_reduce/int8", "grad_reduce/bf16"):
        t = targets[name]
        built = t.build()
        entries, _ = census_of_callable(built["fn"], *built["args"])
        found = wire_dtype_findings(entries, t.policy, name)
        if found:
            fail(f"audit: {name} on NCCL: {[f.message for f in found]}")
        lines.append(_census_line(name, entries) + " " + "/".join(
            sorted({e.dtype for e in entries})))
    built = targets["train_step/donated"].build()
    found = donation_findings(built["step"], built["state"], built["args"],
                              built["snapshot"], "train_step/donated")
    if found:
        fail(f"audit: donation on a CUDA state: {[f.message for f in found]}")
    torch.cuda.synchronize()
    print(f"[audit] ntxent-audit in the NCCL group of world 1, B = "
          f"{CENSUS_ROWS}, D = {CENSUS_DIM} float32: " + "; ".join(lines)
          + f"; the backward's reduce_scatter_tensor seen on autograd's "
          f"device thread; wire-dtype clean under int8 and bf16; donation "
          f"clean after one in-place CUDA step; launches {launched}; "
          f"{time.monotonic() - t0:.1f} s on {card_line}", flush=True)


def phase_dp_chunked(card_line: str) -> dict:
    """[dp-chunked]: phase 11's command with ``--dp-loss chunked
    --ring-chunks DP_CHUNKS`` (the launch, loss and gradient gates of
    ``phase_dp_train``), then the ``--measure-overlap`` A/B at its rows,
    which ``measure_comms_overlap`` times on CUDA events; returns the
    launches."""
    from ntxent_tpu_torch.training import measure_comms_overlap

    out = {}
    launches = phase_dp_train(card_line, DP_CHUNKED_ARGV,
                              DP_CHUNKED_STEP_LAUNCHES, "dp-chunked", out)
    batch = int(DP_ARGV[DP_ARGV.index("--batch") + 1])
    overlap = measure_comms_overlap(None, batch, 128, ring_chunks=DP_CHUNKS)
    print(f"[dp-chunked] --measure-overlap A/B at world 1 ({batch} rows a "
          f"view, D = 128, fp32, forward and backward, CUDA events, median "
          f"of 5): strip {overlap['monolithic_ms']:.4f} ms, chunked "
          f"({overlap['chunks']} chunks) {overlap['chunked_ms']:.4f} ms, "
          f"overlap {overlap['overlap_ms']:.4f} ms "
          f"({overlap['overlap_frac']:.3f}); no hop at world 1, so this is "
          f"the chunks' own cost; on {card_line}", flush=True)
    return launches


def phase_chunked_emulated() -> dict:
    """[chunked-emulated]: the chunked ring of P ranks emulated on one card
    (``emulated_ring_ntxent(P, T, chunks)``: every rank's hops folded as
    ``chunks`` slices through the ring's ``lse_hop`` over #1 general, the
    backward's ``block_grads`` over #6 a slice in reverse hop order, the
    column cotangents summed last visitor first, as the chunked ring's
    transposed hops carry them home) against ntxent_loss_fused and its
    gradient, P * P * chunks launches of each;
    then #1 and #6 at one chunk of the P = 4 hop against their plain
    versions, and their times. Returns the times for the kernels' JSON."""
    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel.mesh import chunk_bounds, local_row_gids
    from ntxent_tpu_torch.utils.profiling import (
        cuda_time_ms,
        emulated_ring_ntxent,
        launch_counters,
    )

    two_n, d, p, chunks = CHUNKED_EMULATED
    t = NTX_TEMPERATURE
    z = _unit_rows(two_n, d, "float32", seed=37)  # [view 1; view 2]
    ref_loss, ref_grad = _ntxent_grad(_fused_ntxent(t), z)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    loss, grad = _ntxent_grad(emulated_ring_ntxent(p, t, chunks=chunks), z)
    launches = {name: w.launches for name, w in counters.items()}
    loss_err, grad_err = abs(loss - ref_loss), _rel(grad, ref_grad)
    want = {n_: p * p * chunks if n_ in RING_NTX_KERNELS else 0
            for n_ in counters}
    ok = (loss_err <= EMULATED_LOSS_ATOL and grad_err <= EMULATED_GRAD_RTOL
          and launches == want)
    print(f"[chunked-emulated] P = {p} ranks of the chunked ring emulated "
          f"(2N = {two_n}, D = {d}, {chunks} chunks a hop): loss "
          f"{loss:.6f} vs ntxent_loss_fused {ref_loss:.6f} (|err| "
          f"{loss_err:.2e}, atol {EMULATED_LOSS_ATOL:g}); gradient "
          f"{grad_err:.2e} relative (rtol {EMULATED_GRAD_RTOL:g}); launches "
          f"{ {k: c for k, c in launches.items() if c} } (P * P * chunks = "
          f"{p * p * chunks} each) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"the emulated chunked ring of {p} ranks disagrees or launched "
             f"{launches}")
    # one chunk of the P = 4 hop: 2n = 2048 rows against 512 columns
    n = two_n // 2 // p
    gid0, gid1 = (local_row_gids(r, n, p, z.device) for r in (0, 1))
    lo, hi = chunk_bounds(2 * n, chunks)[0]
    z0, z1 = z[gid0.long()], z[gid1.long()][lo:hi].contiguous()
    g1 = gid1[lo:hi].contiguous()
    lse0 = N.block_lse(z0, z1, gid0, g1, t, two_n)
    hop = (z0, z1, gid0, lse0, t, g1, two_n, two_n)
    got = (N.ntxent_fwd_general(z0, z1, gid0, t, g1, two_n, two_n)[1],
           *N.block_grads(z0, z1, gid0, g1, lse0, t, two_n))
    want = (N.ntxent_fwd_general_plain(z0, z1, gid0, t, g1, two_n,
                                       two_n)[1],
            N.ntxent_bwd_general_rows_plain(*hop),
            N.ntxent_bwd_general_cols_plain(*hop))
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    ok = max(errs) <= NTX_ATOL
    lse_ms = cuda_time_ms(lambda: N.block_lse(z0, z1, gid0, g1, t, two_n))
    rows_ms, cols_ms = (cuda_time_ms(lambda: fn(*hop)) for fn in (
        N.ntxent_bwd_general_rows, N.ntxent_bwd_general_cols))
    bounds = [b for b, _ in _general_bounds(2 * n, hi - lo, d)]
    print(f"[chunked-emulated] one chunk of the P = {p} hop ({2 * n} rows x "
          f"{hi - lo} columns, D = {d}, fp32): #1 lse max|err| "
          f"{errs[0]:.3e}, #6 rows {errs[1]:.3e}, cols {errs[2]:.3e} against "
          f"the plain versions (atol {NTX_ATOL:g}) {'ok' if ok else 'MISMATCH'}"
          f"; #1 {lse_ms:.4f} ms (bound {bounds[0]:.5f}), #6 rows "
          f"{rows_ms:.4f} ms (bound {bounds[1]:.5f}), cols {cols_ms:.4f} ms "
          f"(bound {bounds[2]:.5f})", flush=True)
    if not ok:
        fail("#1 or #6 disagrees with its plain version at a chunk of the "
             "P = 4 hop")
    return {name: {"chunk_hop_ms": ms, "chunk_hop_bound_ms": bound}
            for name, ms, bound in zip(
                ("ntxent_fwd_general", "ntxent_bwd_general_rows",
                 "ntxent_bwd_general_cols"), (lse_ms, rows_ms, cols_ms),
                bounds)}


def _wire_series() -> dict:
    """{(series, op, dtype): value} of the collective counters with a
    dtype label in the process-wide registry."""
    import re

    from ntxent_tpu_torch.obs.registry import default_registry

    out = {}
    for line in default_registry().render_prometheus().splitlines():
        m = re.match(r'(collective_(?:calls|bytes)_total)\{(.*)\} (\S+)$',
                     line)
        if m and 'dtype="' in m.group(2):
            labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
            out[(m.group(1), labels["op"], labels["dtype"])] = float(
                m.group(3))
    return out


def phase_wire(card_line: str, f32: dict) -> dict:
    """[wire]: phase 11's command under each (dtype, --dp-loss) of
    WIRE_RUNS (the launch, loss and gradient gates of ``phase_dp_train``):
    every loss within WIRE_LOSS_ATOL of the float32 strip run's (``f32``,
    phase 11's ``out``), int8's error-feedback residual nonzero, the
    collective series by wire dtype, step ms against float32;
    ``quantize_int8`` on the card against the CPU's, bit for bit. Returns
    {"<dtype>" or "<dtype>_pair": launches}."""
    import torch

    from ntxent_tpu_torch.parallel.precision import quantize_int8

    x = torch.randn(512, 128, generator=torch.Generator().manual_seed(41))
    x[3] = 0.0
    q_card, s_card = quantize_int8(x.cuda())
    q_cpu, s_cpu = quantize_int8(x)
    q_off = int((q_card.cpu() != q_cpu).sum())
    s_off = int((s_card.cpu() != s_cpu).sum())
    same = q_off == 0 and s_off == 0
    print(f"[wire] quantize_int8 of a (512, 128) float32 block (a zero row "
          f"included) on the card equals the CPU's bit for bit ({q_off} "
          f"values and {s_off} scales differ): "
          f"{'ok' if same else 'MISMATCH'}", flush=True)
    if not same:
        fail("quantize_int8 on the card differs from the CPU's")
    launches = {}
    for dtype, loss in WIRE_RUNS:
        before, out = _wire_series(), {}
        key = dtype if loss == "strip" else f"{dtype}_{loss}"
        launches[key] = phase_dp_train(
            card_line, DP_ARGV + ["--collective-dtype", dtype, "--dp-loss",
                                  loss],
            DP_STEP_LAUNCHES if loss == "strip" else DP_PAIR_STEP_LAUNCHES,
            f"wire-{key}", out)
        series = {k: v - before.get(k, 0.0)
                  for k, v in _wire_series().items() if v != before.get(k)}
        gaps = [abs(a - b) for a, b in zip(out["losses"], f32["losses"])]
        ok = max(gaps) <= WIRE_LOSS_ATOL and (
            dtype != "int8" or (out["residual"] or 0.0) > 0.0)
        labels = ", ".join(f"{name}{{op={op},dtype={d}}} {v:g}"
                           for (name, op, d), v in sorted(series.items()))
        print(f"[wire] --collective-dtype {dtype} --dp-loss {loss}: losses "
              f"vs float32 strip "
              f"max|diff| {max(gaps):.2e} (atol {WIRE_LOSS_ATOL:g}); step "
              f"{out['step_ms']:.1f} ms vs float32 {f32['step_ms']:.1f} ms; "
              f"largest error-feedback residual {out['residual']}; "
              f"collective series by wire dtype over the run (world 1: "
              f"bytes 0): {labels} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"the {dtype} wire's {loss} run: losses {out['losses']} "
                 f"against {f32['losses']}, residual {out['residual']}")
    return launches


def phase_wire_clip(card_line: str) -> dict:
    """[wire-clip]: data-parallel CLIP ViT-B/16 under int8 for
    WIRE_CLIP_STEPS steps (the gates of ``phase_clip_dp_train``), the
    error-feedback residual nonzero; returns the launches."""
    out = {}
    argv = _with_flags(CLIP_DP_ARGV, "--steps", str(WIRE_CLIP_STEPS)) + [
        "--collective-dtype", "int8"]
    launches = phase_clip_dp_train(card_line, argv, WIRE_CLIP_STEPS,
                                   "wire-clip", out)
    ok = (out["residual"] or 0.0) > 0.0
    print(f"[wire-clip] largest error-feedback residual after "
          f"{WIRE_CLIP_STEPS} int8 steps {out['residual']} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the int8 CLIP run carries no error-feedback residual")
    return launches


def phase_resume_ef(tmp: str) -> None:
    """[resume-ef]: phase 11's command under int8 with ``--ckpt-save-ef``,
    PAIR_FIRST + 1 steps against PAIR_STEPS uninterrupted, CRC for CRC
    (``phase_resume_pair``); the saved state holds the residual in the
    JAX layout, (1,) + each parameter's shape at world 1, nonzero."""
    from pathlib import Path

    from ntxent_tpu_torch.utils import msgpack

    argv = DP_ARGV + ["--collective-dtype", "int8", "--ckpt-save-ef"]
    whole = Path(phase_resume_pair(tmp, argv, "ef", data_parallel=True))
    state = msgpack.from_bytes((whole / str(PAIR_STEPS) / "state.msgpack")
                               .read_bytes())
    leaves = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else leaves.append(np.asarray(v))

    walk(state.get("ef_residual") or {})
    ok = bool(leaves) and all(v.shape[0] == 1 for v in leaves) and max(
        float(np.abs(v).max()) for v in leaves) > 0
    print(f"[resume-ef] the step-{PAIR_STEPS} state holds the residual of "
          f"{len(leaves)} parameters, (1,) + shape each, nonzero "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the --ckpt-save-ef checkpoint holds no error-feedback residual")
    shutil.rmtree(whole)


def _dp_clip_ids(rows: int, cols: int, seed: int):
    """Global row ids on the card: the rows of rank cols / rows - 1 where
    rows divide cols (rank 0 of a world of one at rows == cols), else
    scattered ids with a padding row (id = cols) last."""
    import torch

    if cols % rows == 0:
        first = cols - rows
        return (first + torch.arange(rows, dtype=torch.int32)).cuda()
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randperm(cols, generator=gen)[:rows].to(torch.int32)
    ids[-1] = cols
    return ids.cuda()


def _dp_clip_loss(za, zb, gid, scale, lse_a, lse_b):
    """The partial loss sum of the rows from the lse, as
    ``info_nce_dual_partial`` assembles it (a padding row's id clamped)."""
    import torch

    idx = gid.long().clamp(max=zb.shape[0] - 1)
    pos = scale * torch.sum(za.float() * zb.float()[idx], dim=1)
    return torch.sum(lse_a - pos) + torch.sum(lse_b[idx] - pos)


def _dp_clip_bounds(rows: int, cols: int, d: int, itemsize: int):
    """Bounds of #9 rectangular, #5 cross-modal and #4 at (rows, cols, D):
    each input read once (za, zb, the scale; the row ids and both lse for
    the backward), each output written once; 2 R C D and 4 R C D
    operations at the fp32 peak (bf16 inputs are widened to fp32)."""
    z = (rows + cols) * d * itemsize + 4
    lse = (rows + cols) * 4
    return (_bound(z + lse, 2 * rows * cols * d, PEAK_FP32_FLOPS),
            _bound(z + rows * 4 + lse + rows * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS),
            _bound(z + rows * 4 + lse + cols * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS))


def _dp_clip_tf32_control(rows: int, cols: int, d: int, scale):
    """(kernel, control) max abs errors of #9 rectangular (both lse), #5
    cross-modal and #4 in fp32 against their plain versions, the gradients
    all at the plain forward's lse: the kernels, and one TF32 pass (the
    plain versions on za, zb rounded to TF32 once)."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I
    from ntxent_tpu_torch.ops import ntxent

    gid = _dp_clip_ids(rows, cols, seed=rows)
    za = _unit_rows(rows, d, "float32", seed=rows)
    zb = _unit_rows(cols, d, "float32", seed=cols + 1)
    lse = I.infonce_dual_fwd_rect_plain(za, zb, scale)
    za_c, zb_c = ntxent.tf32_split(za)[0], ntxent.tf32_split(zb)[0]
    got = I.infonce_dual_fwd_rect(za, zb, scale)
    ctl = I.infonce_dual_fwd_rect_plain(za_c, zb_c, scale)
    torch.cuda.synchronize()
    out = [(max((g - w).abs().max().item() for g, w in zip(got, lse)),
            max((c - w).abs().max().item() for c, w in zip(ctl, lse)))]
    for kernel, plain in ((I.infonce_bwd_rows, I.infonce_bwd_rows_plain),
                          (I.infonce_bwd_cols, I.infonce_bwd_cols_plain)):
        want = plain(za, zb, gid, scale, *lse)
        got = kernel(za, zb, gid, scale, *lse)
        ctl = plain(za_c, zb_c, gid, scale, *lse)
        torch.cuda.synchronize()
        out.append(((got - want).abs().max().item(),
                    (ctl - want).abs().max().item()))
    return out


def _dp_clip_one_shot(scale) -> None:
    """``parallel.info_nce_loss_distributed`` (the one-shot data-parallel
    InfoNCE) in an NCCL world of one, held bitwise to
    ``make_sharded_infonce``'s dual body on the same pairs at CLIP's
    initial scale; the same loss again from ``temperature``."""
    import torch

    from ntxent_tpu_torch.parallel import (
        info_nce_loss_distributed,
        make_sharded_infonce,
        mesh,
    )

    rows, _, d = DP_CLIP_SHAPES[0]
    za = _unit_rows(rows, d, "float32", seed=31)
    zb = _unit_rows(rows, d, "float32", seed=32)
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_from_file(f"{tmp}/store", 0, 1, device="cuda")
        try:
            got = info_nce_loss_distributed(za, zb, scale=scale)
            want = make_sharded_infonce()(za, zb, scale)
            by_t = info_nce_loss_distributed(za, zb, temperature=0.07)
            torch.cuda.synchronize()
        finally:
            mesh.shutdown()
    err = (got - want).abs().item()
    t_err = (by_t - want).abs().item()
    ok = err == 0.0 and t_err <= INFONCE_ATOL and bool(torch.isfinite(got))
    print(f"[dp-clip-kernel] info_nce_loss_distributed at world 1, N={rows} "
          f"D={d} fp32: {got.item():.6f} against make_sharded_infonce's "
          f"{want.item():.6f} (|err| {err:.3e}, bitwise wanted; from "
          f"temperature 0.07 |err| {t_err:.3e}, atol {INFONCE_ATOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("info_nce_loss_distributed disagrees with make_sharded_infonce "
             "at world 1")


def phase_dp_clip_kernels(build_logs: dict) -> tuple[list[dict], float]:
    """#9 rectangular, #5 cross-modal and #4 against their plain versions;
    in fp32 at every shape but the ragged one all three at least
    TF32_CONTROL_FACTOR below a one-pass TF32 control; ptxas's report of
    their walks; then times at the same shapes; the one-shot
    ``info_nce_loss_distributed`` at world 1 (``_dp_clip_one_shot``); and
    the symmetric #1 re-timed in the same call. Returns the kernel
    entries and the symmetric #1's ms."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I
    from ntxent_tpu_torch.ops import ntxent
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    scale = torch.tensor(DP_CLIP_SCALE, dtype=torch.float32, device="cuda")
    errs = {}
    for rows, cols, d in DP_CLIP_SHAPES:
        gid = _dp_clip_ids(rows, cols, seed=rows)
        for dtype in ("float32", "bfloat16"):
            za = _unit_rows(rows, d, dtype, seed=rows + d)
            zb = _unit_rows(cols, d, dtype, seed=cols + d + 1)

            def run():
                lse_a, lse_b = I.infonce_dual_fwd_rect(za, zb, scale)
                return (lse_a, lse_b,
                        I.infonce_bwd_rows(za, zb, gid, scale, lse_a, lse_b),
                        I.infonce_bwd_cols(za, zb, gid, scale, lse_a, lse_b),
                        _dp_clip_loss(za, zb, gid, scale, lse_a, lse_b))

            got, again = run(), run()
            lse_a, lse_b, o_a, o_b, loss = got
            ref = I.infonce_dual_fwd_rect_plain(za, zb, scale)
            ref_oa = I.infonce_bwd_rows_plain(za, zb, gid, scale, lse_a,
                                              lse_b)
            ref_ob = I.infonce_bwd_cols_plain(za, zb, gid, scale, lse_a,
                                              lse_b)
            torch.cuda.synchronize()
            fwd_err = max((lse_a - ref[0]).abs().max().item(),
                          (lse_b - ref[1]).abs().max().item())
            rows_err = (o_a - ref_oa).abs().max().item()
            cols_err = (o_b - ref_ob).abs().max().item()
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = (max(fwd_err, rows_err, cols_err) <= INFONCE_ATOL
                  and repeat and bool(torch.isfinite(loss)))
            print(f"[dp-clip-kernel] R={rows} C={cols} D={d} {dtype}: rect "
                  f"fwd max|err| {fwd_err:.3e}, #5 rows {rows_err:.3e}, #4 "
                  f"cols {cols_err:.3e} (atol {INFONCE_ATOL:g}); lse, o_a, "
                  f"o_b and the loss bitwise repeatable {repeat} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the data-parallel InfoNCE kernels disagree with "
                     f"their plain versions at R={rows} C={cols} D={d} "
                     f"{dtype}")
            if (rows, cols, dtype) == (256, 256, "float32"):
                errs = {"infonce_dual_fwd_rect": fwd_err,
                        "infonce_bwd_rows": rows_err,
                        "infonce_bwd_cols": cols_err}
            del za, zb, got, again, ref_oa, ref_ob

    _dp_clip_one_shot(scale)
    for rows, cols, d in DP_CLIP_SHAPES[:3]:
        pairs = _dp_clip_tf32_control(rows, cols, d, scale)
        ok = all(TF32_CONTROL_FACTOR * k <= c for k, c in pairs)
        print(f"[dp-clip-kernel] TF32 control R={rows} C={cols} D={d} fp32: "
              f"kernels #9 rect lse / #5 rows / #4 cols "
              f"{' / '.join(f'{k:.3e}' for k, _ in pairs)}, one TF32 pass "
              f"{' / '.join(f'{c:.3e}' for _, c in pairs)} (ratios "
              f"{', '.join(f'{c / max(k, 1e-30):.1f}' for k, c in pairs)}; "
              f"at least {TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"#9 rectangular, #5 cross-modal and #4 are not "
                 f"{TF32_CONTROL_FACTOR}x more accurate than one TF32 pass "
                 f"at R={rows} C={cols}")
    for name in ("infonce_dual_fwd", "infonce_dual_bwd", "infonce_bwd_cols"):
        for line in _ptxas_walks(build_logs, name):
            print(f"[dp-clip-kernel] ptxas {name}: {line}", flush=True)

    times = {}
    for rows, cols, d in DP_CLIP_SHAPES[:3]:
        za = _unit_rows(rows, d, "float32", seed=1)
        zb = _unit_rows(cols, d, "float32", seed=2)
        gid = _dp_clip_ids(rows, cols, seed=0)
        lse_a, lse_b = I.infonce_dual_fwd_rect(za, zb, scale)
        args = (za, zb, gid, scale, lse_a, lse_b)
        ms = (cuda_time_ms(lambda: I.infonce_dual_fwd_rect(za, zb, scale)),
              cuda_time_ms(lambda: I.infonce_bwd_rows(*args)),
              cuda_time_ms(lambda: I.infonce_bwd_cols(*args)))
        plain = (cuda_time_ms(
            lambda: I.infonce_dual_fwd_rect_plain(za, zb, scale)),
            cuda_time_ms(lambda: I.infonce_bwd_rows_plain(*args)),
            cuda_time_ms(lambda: I.infonce_bwd_cols_plain(*args)))
        bounds = _dp_clip_bounds(rows, cols, d, 4)
        print(f"[dp-clip-kernel] R={rows} C={cols} D={d} fp32: rect fwd "
              f"{ms[0]:.4f} ms (plain {plain[0]:.4f}, bound "
              f"{bounds[0][0]:.5f} by {bounds[0][1]}), #5 rows {ms[1]:.4f} "
              f"ms (plain {plain[1]:.4f}, bound {bounds[1][0]:.5f} by "
              f"{bounds[1][1]}), #4 cols {ms[2]:.4f} ms (plain "
              f"{plain[2]:.4f}, bound {bounds[2][0]:.5f} by "
              f"{bounds[2][1]}); no single PyTorch call computes them, so "
              f"there is no library time", flush=True)
        times[rows, cols] = (ms, plain, bounds)
        del za, zb, args

    z = _unit_rows(*NTX_SHAPES[0], "float32", seed=0)
    sym_ms = cuda_time_ms(lambda: ntxent.ntxent_fwd(z, NTX_TEMPERATURE),
                          runs=SYM_RETIME_RUNS, warmup=20)
    print(f"[dp-clip-kernel] symmetric ntxent_fwd re-timed at 2N="
          f"{NTX_SHAPES[0][0]}, D={NTX_SHAPES[0][1]} fp32 over "
          f"{SYM_RETIME_RUNS} launches: {sym_ms:.4f} ms", flush=True)

    names = ("infonce_dual_fwd_rect", "infonce_bwd_rows", "infonce_bwd_cols")
    replaces = (
        "ntxent_tpu/ops/infonce_pallas.py:75 (_dual_fwd_kernel in its "
        "rectangular stats_only mode, _dual_fwd_call :165, pallas_call :174)",
        "ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel in its "
        "cross-modal mode, _bwd_sym_call :612, pallas_call :625)",
        "ntxent_tpu/ops/ntxent_pallas.py:479 (_bwd_sym_cols_kernel, "
        "_bwd_sym_cols_call :516, pallas_call :528)")
    # the TF32 walks of #5 cross-modal and #4 live in one header, which
    # csrc/infonce_dual_bwd.cu and csrc/infonce_bwd_cols.cu instantiate
    sources = ("ntxent_tpu_torch/csrc/infonce_dual_fwd.cu",
               "ntxent_tpu_torch/csrc/infonce_cross_bwd.cuh",
               "ntxent_tpu_torch/csrc/infonce_cross_bwd.cuh")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds = times[256, 256]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True, "launches": None,
                 "max_abs_err": errs[name], "ms": ms[i],
                 "plain_ms": plain[i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "library_ms": None}
        for (rows, cols), tag in (((64, 256), "rank4"),
                                  ((1024, 4096), "rank4_b4096")):
            ms, plain, bounds = times[rows, cols]
            entry |= {f"{tag}_ms": ms[i], f"{tag}_plain_ms": plain[i],
                      f"{tag}_bound_ms": bounds[i][0]}
        out.append(entry)
    return out, sym_ms


def phase_dp_clip_emulated_ranks() -> None:
    """P = 4 ranks of global batch 256 (D = 512) one after another on the
    card: each rank's rectangular forward, the column lse merged by hand
    (max, then log-sum-exp), each rank's rows and columns gradients; the
    partial losses summed, the za rows concatenated, the zb partials and
    the scale's shares summed, against the single-card info_nce_fused
    loss and its gradients."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I

    p, batch, d = EMULATED_RANKS, EMULATED_BATCH, 512
    za = _unit_rows(batch, d, "float32", seed=11)
    zb = _unit_rows(batch, d, "float32", seed=12)
    scale = torch.tensor(DP_CLIP_SCALE, dtype=torch.float32, device="cuda")
    n = batch // p
    parts = []
    for rank in range(p):
        gid = rank * n + torch.arange(n, dtype=torch.int32, device="cuda")
        za_r = za[rank * n:(rank + 1) * n]
        parts.append((za_r, gid, *I.infonce_dual_fwd_rect(za_r, zb, scale)))
    stacked = torch.stack([lse_b for *_, lse_b in parts])
    m = stacked.amax(dim=0)
    lse_b = m + torch.log(torch.exp(stacked - m).sum(dim=0))
    loss = 0.0
    g_za, g_zb, g_scale = [], torch.zeros_like(zb), 0.0
    coef = 1.0 / (2 * batch)
    for za_r, gid, lse_a, _ in parts:
        loss = loss + _dp_clip_loss(za_r, zb, gid, scale, lse_a, lse_b)
        o_a = I.infonce_bwd_rows(za_r, zb, gid, scale, lse_a, lse_b)
        g_za.append(o_a * coef * scale)
        g_zb += I.infonce_bwd_cols(za_r, zb, gid, scale, lse_a, lse_b) \
            * coef * scale
        g_scale = g_scale + coef * torch.sum(o_a * za_r)
    a, b, s = (t.clone().requires_grad_() for t in (za, zb, scale))
    ref = I.info_nce_fused(a, b, scale=s)
    ref.backward()
    torch.cuda.synchronize()
    loss_err = abs(loss.item() * coef - ref.item())
    grad_errs = [((got - want).norm() / want.norm()).item()
                 for got, want in ((torch.cat(g_za), a.grad), (g_zb, b.grad),
                                   (g_scale, s.grad))]
    ok = loss_err <= DP_CLIP_LOSS_ATOL and max(grad_errs) <= DP_CLIP_GRAD_RTOL
    print(f"[dp-clip-ranks] {p} ranks emulated at global batch {batch} "
          f"(D = {d}): merged partial losses / 2N {loss.item() * coef:.6f} "
          f"vs single card {ref.item():.6f} (|err| {loss_err:.2e}, atol "
          f"{DP_CLIP_LOSS_ATOL:g}); relative gradient errors za "
          f"{grad_errs[0]:.2e}, zb {grad_errs[1]:.2e}, scale "
          f"{grad_errs[2]:.2e} (rtol {DP_CLIP_GRAD_RTOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the emulated ranks' partial InfoNCE losses do not sum to the "
             "single-card loss and gradients")


def phase_clip_dp_train(card_line: str, argv=CLIP_DP_ARGV,
                        steps: int = CLIP_DP_STEPS, tag: str = "clip-dp",
                        out: dict | None = None) -> dict:
    """Data-parallel CLIP ViT-B/16 through ntxent_tpu_torch.cli over the
    NCCL group of world 1 (``argv``, ``steps`` steps); returns the
    launches of each kernel. ``out`` receives the step ms and the largest
    error-feedback residual (None without one)."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.parallel import mesh
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(argv)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    mark = mesh.comms_accounting().totals()
    t0 = time.monotonic()
    state, history = cli.train(args, data_parallel=True)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    comms = mesh.comms_accounting().delta(mark)
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"data-parallel CLIP losses {losses}: expected {steps} "
             "finite values")
    want = {n: CLIP_DP_STEP_LAUNCHES.get(n, 0) * steps for n in counters}
    if launches != want:
        fail(f"kernel launches over {steps} data-parallel CLIP "
             f"steps {launches}, expected {want}")
    model = state.model
    g = model.logit_scale.grad
    if g is None or not g.abs().item() > 0:
        fail("the logit scale has no gradient in the data-parallel step")
    for tower in ("image_tower", "text_tower"):
        for i, block in enumerate(getattr(model, tower).blocks):
            for proj in ("query", "key", "value"):
                g = getattr(block.attn, proj).weight.grad
                if g is None or not g.abs().sum().item() > 0:
                    fail(f"{tower} block {i} attn.{proj}.weight has no "
                         "gradient in the data-parallel step")
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    print(f"[{tag}] CLIP ViT-B/16 data-parallel over NCCL (world 1), "
          f"--collective-dtype {args.collective_dtype}, "
          f"batch {args.batch} pairs, {steps} steps in {wall_s:.1f} "
          f"s: losses {[round(x, 4) for x in losses]}; launches per step "
          f"{ {n: c // steps for n, c in launches.items() if c} } "
          f"(every other kernel 0); logit-scale gradient "
          f"{model.logit_scale.grad.item():.3e}; every q/k/v weight of both "
          f"towers has a nonzero gradient; comms over the run (calls, bytes "
          f"per device; 0 at world 1) "
          f"{ {op: c for (op, _), c in comms.items()} }", flush=True)
    print(f"[{tag}] step {step_ms:.1f} ms (steps 2-{steps}, host "
          f"clock around a synchronizing loss read), "
          f"{args.batch / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) on "
          f"{card_line}", flush=True)
    if out is not None:
        out.update(step_ms=step_ms, residual=None if
                   state.ef_residual is None else max(
                       e.abs().max().item() for e in state.ef_residual))
    del state, model
    torch.cuda.empty_cache()
    return launches


def phase_clip_dp_parity() -> None:
    """The world-1 data-parallel CLIP step against the single-card CLIP
    step, fp32 CLIP ViT-B/16, same weights, images and tokens, TF32 off."""
    import copy

    import torch

    from ntxent_tpu_torch.models import (
        CLIPModel,
        TextTransformer,
        ViT_B16,
        init_weights,
    )
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_clip_train_state,
        make_clip_train_step,
        make_sharded_clip_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_weights(
        CLIPModel(ViT_B16(image_size=224, attention_impl="flash",
                          dtype=torch.float32),
                  TextTransformer(dtype=torch.float32)),
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(size=(
        CLIP_PARITY_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.integers(1, 49408, (CLIP_PARITY_BATCH,
                                                      77))).cuda()
    cfg = TrainerConfig(batch_size=CLIP_PARITY_BATCH, base_lr=5e-4,
                        warmup_steps=1)
    results = []
    for step in (make_sharded_clip_train_step(None),
                 make_clip_train_step(use_fused=True)):
        state = create_clip_train_state(copy.deepcopy(model), cfg,
                                        torch.device("cuda"))
        _, metrics = step(state, images, tokens)
        results.append((metrics["loss"].item(), torch.cat(
            [p.grad.detach().float().cpu().flatten()
             for p in state.model.parameters()])))
        del state
    (loss_dp, g_dp), (loss_one, g_one) = results
    loss_err = abs(loss_dp - loss_one)
    grad_err = ((g_dp - g_one).norm() / g_one.norm()).item()
    ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
    print(f"[clip-dp-parity] CLIP ViT-B/16 train step float32, batch "
          f"{CLIP_PARITY_BATCH}: loss data-parallel (world 1) {loss_dp:.6f} "
          f"vs single card {loss_one:.6f} (|err| {loss_err:.2e}, atol "
          f"{PARITY_LOSS_ATOL:.2e}); gradient |g_dp - g_card| / |g_card| = "
          f"{grad_err:.2e} (rtol {PARITY_GRAD_RTOL:.2e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the data-parallel CLIP step at world 1 disagrees with the "
             "single-card CLIP step")


def _pair_ids(rows: int, cols: int, world, seed: int):
    """(row ids, column ids, total) on the card: rank 0's rows against
    shard (1 mod world)'s columns of a world of ``world`` (the self tile
    at world 1, the k = 1 tile beyond), or, for ``world`` None, scattered
    ids out of 4 (rows + cols) with 20 shared by rows and columns, two
    sentinel rows and three sentinel columns."""
    import torch

    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    if world is not None:
        n = rows // 2
        rid = local_row_gids(0, n, world)
        cid = local_row_gids(1 % world, n, world)
        return rid.cuda(), cid.cuda(), rows * world
    total = 4 * (rows + cols)
    perm = torch.randperm(total, generator=torch.Generator().manual_seed(
        seed)).to(torch.int32)
    rid = perm[:rows].clone()
    cid = torch.cat([perm[rows - 20:rows], perm[rows:rows + cols - 20]])
    rid[[3, 50]] = total
    cid[[7, 8, 200]] = total
    return rid.cuda(), cid.cuda(), total


def _pair_bounds(rows: int, cols: int, d: int, itemsize: int):
    """Bounds of #7 and #8 at (R, C, D): each input read once (z_rows,
    z_cols, both ids; both lse for #8), each output written once (both
    lse; both fp32 gradients for #8); 2 R C D and 6 R C D operations (the
    TPU kernels' work) at the fp32-accurate 3xTF32 rate (bf16 inputs are
    widened to fp32)."""
    z = (rows + cols) * d * itemsize
    ids = lse = (rows + cols) * 4
    return (_bound(z + ids + lse, 2 * rows * cols * d, PEAK_FP32_FLOPS),
            _bound(z + ids + lse + (rows + cols) * d * 4,
                   6 * rows * cols * d, PEAK_FP32_FLOPS))


def _pair_tf32_control(rows: int, cols: int, d: int, world):
    """((lse, gradient) of #7 + #8, (lse, gradient) of one TF32 pass): max
    abs errors in fp32 against the plain versions at the tile's ids, the
    gradients all at the plain lse; the control is the plain versions on
    z_rows, z_cols rounded to TF32 once."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N

    t = NTX_TEMPERATURE
    rid, cid, total = _pair_ids(rows, cols, world, seed=rows)
    zr = _unit_rows(rows, d, "float32", seed=rows + d)
    zc = _unit_rows(cols, d, "float32", seed=cols + d + 3)
    lse = N.block_lse_dual_plain(zr, zc, rid, cid, t, total)
    grads = N.block_grads_dual_plain(zr, zc, rid, cid, *lse, t, total)
    got_lse = N.block_lse_dual(zr, zc, rid, cid, t, total)
    got_grads = N.block_grads_dual(zr, zc, rid, cid, *lse, t, total)
    zr_c, zc_c = N.tf32_split(zr)[0], N.tf32_split(zc)[0]
    ctl_lse = N.block_lse_dual_plain(zr_c, zc_c, rid, cid, t, total)
    ctl_grads = N.block_grads_dual_plain(zr_c, zc_c, rid, cid, *lse, t,
                                         total)
    torch.cuda.synchronize()

    def err(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    return ((err(got_lse, lse), err(got_grads, grads)),
            (err(ctl_lse, lse), err(ctl_grads, grads)))


def phase_pair_kernels(build_logs: dict) -> list[dict]:
    """#7 and #8 against their plain versions at every shape and dtype,
    each bitwise repeatable; in fp32 at the self tile and at r4/4096 at
    least TF32_CONTROL_FACTOR below a one-pass TF32 control; ptxas's
    report of their walks; then times at the fp32 shapes."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t = NTX_TEMPERATURE
    errs = {}
    for rows, cols, d, world in PAIR_CASES:
        rid, cid, total = _pair_ids(rows, cols, world, seed=rows)
        for dtype in ("float32", "bfloat16"):
            zr = _unit_rows(rows, d, dtype, seed=rows + d)
            zc = _unit_rows(cols, d, dtype, seed=cols + d + 3)
            args = (zr, zc, rid, cid)
            lse_r, lse_c = N.block_lse_dual_plain(*args, t, total)

            def run():
                return (*N.block_lse_dual(*args, t, total),
                        *N.block_grads_dual(*args, lse_r, lse_c, t, total))

            got, again = run(), run()
            ref = (lse_r, lse_c,
                   *N.block_grads_dual_plain(*args, lse_r, lse_c, t, total))
            torch.cuda.synchronize()
            stats_err = max((got[i] - ref[i]).abs().max().item()
                            for i in (0, 1))
            grads_err = max((got[i] - ref[i]).abs().max().item()
                            for i in (2, 3))
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = max(stats_err, grads_err) <= NTX_ATOL and repeat
            print(f"[pair-kernel] R={rows} C={cols} D={d} {dtype} (total "
                  f"{total}): block_lse_dual max|err| {stats_err:.3e}, "
                  f"block_grads_dual {grads_err:.3e} (atol {NTX_ATOL:g}); "
                  f"both lse and both gradients bitwise repeatable "
                  f"{repeat} {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the shard-pair kernels disagree with their plain "
                     f"versions at R={rows} C={cols} D={d} {dtype}")
            if (rows, dtype) == (512, "float32"):
                errs = {"block_lse_dual": stats_err,
                        "block_grads_dual": grads_err}
            del zr, zc, got, again, ref

    for rows, cols, d, world in (PAIR_CASES[0], PAIR_CASES[2]):
        kernel, control = _pair_tf32_control(rows, cols, d, world)
        ok = all(k <= NTX_ATOL and TF32_CONTROL_FACTOR * k <= c
                 for k, c in zip(kernel, control))
        print(f"[pair-kernel] TF32 control R={rows} C={cols} D={d} fp32: "
              f"kernels lse {kernel[0]:.3e} grad {kernel[1]:.3e}, one TF32 "
              f"pass lse {control[0]:.3e} grad {control[1]:.3e} (ratios "
              f"{control[0] / max(kernel[0], 1e-30):.1f}, "
              f"{control[1] / max(kernel[1], 1e-30):.1f}; at least "
              f"{TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"#7 and #8 are not {TF32_CONTROL_FACTOR}x more accurate "
                 f"than one TF32 pass at R={rows} C={cols}")
    for name in ("ntxent_dual_stats", "ntxent_dual_grads"):
        for line in _ptxas_walks(build_logs, name):
            print(f"[pair-kernel] ptxas {name}: {line}", flush=True)

    times = {}
    for rows, cols, d, world in PAIR_CASES[:3]:
        rid, cid, total = _pair_ids(rows, cols, world, seed=0)
        args = (_unit_rows(rows, d, "float32", seed=1),
                _unit_rows(cols, d, "float32", seed=2), rid, cid)
        lse_r, lse_c = N.block_lse_dual(*args, t, total)
        runs = 3 if rows > 1024 else 10
        ms = (cuda_time_ms(lambda: N.block_lse_dual(*args, t, total), runs),
              cuda_time_ms(lambda: N.block_grads_dual(
                  *args, lse_r, lse_c, t, total), runs))
        plain = (cuda_time_ms(lambda: N.block_lse_dual_plain(
            *args, t, total), runs),
            cuda_time_ms(lambda: N.block_grads_dual_plain(
                *args, lse_r, lse_c, t, total), runs))
        bounds = _pair_bounds(rows, cols, d, 4)
        print(f"[pair-kernel] R={rows} C={cols} D={d} fp32: block_lse_dual "
              f"{ms[0]:.4f} ms (plain {plain[0]:.4f}, bound "
              f"{bounds[0][0]:.5f} by {bounds[0][1]}), block_grads_dual "
              f"{ms[1]:.4f} ms (plain {plain[1]:.4f}, bound "
              f"{bounds[1][0]:.5f} by {bounds[1][1]}); no single PyTorch "
              f"call computes them, so there is no library time",
              flush=True)
        times[rows] = (ms, plain, bounds)
        del args
    names = ("block_lse_dual", "block_grads_dual")
    replaces = (
        "ntxent_tpu/ops/ntxent_pallas.py:1037 (_dual_stats_kernel, "
        "block_lse_dual :1094)",
        "ntxent_tpu/ops/ntxent_pallas.py:1159 (_dual_grads_kernel, "
        "block_grads_dual :1213)")
    sources = ("ntxent_tpu_torch/csrc/ntxent_dual_stats.cu",
               "ntxent_tpu_torch/csrc/ntxent_dual_grads.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds = times[512]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True, "launches": None,
                 "max_abs_err": errs[name], "ms": ms[i],
                 "plain_ms": plain[i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "library_ms": None}
        for rows, tag in ((128, "rank4"), (2048, "rank4_b4096")):
            ms, plain, bounds = times[rows]
            entry |= {f"{tag}_ms": ms[i], f"{tag}_plain_ms": plain[i],
                      f"{tag}_bound_ms": bounds[i][0]}
        out.append(entry)
    return out


def phase_pair_emulated_ranks() -> None:
    """P = 2, 3, 4, 8 pair ranks one after another on the card, through
    the pair loss's own per-rank functions (``parallel.pair``): each
    rank's lse shares, merged over ranks as the pmax and psum do, and each
    rank's gradient buffer, summed as the psum does; the positives added
    by hand; against the single-card ntxent_fwd / ntxent_bwd_sym."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel import pair
    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    t, d = NTX_TEMPERATURE, 128
    for p in PAIR_WORLDS:
        batch = EMULATED_BATCH - EMULATED_BATCH % p
        two_n, n = 2 * batch, batch // p
        z = _unit_rows(two_n, d, "float32", seed=17 + p)  # [view 1; view 2]
        gids = [local_row_gids(r, n, p, z.device) for r in range(p)]
        z_g = torch.cat([z[g.long()] for g in gids])  # the all-gather
        shares = torch.stack([
            pair.rank_lse_part(z[g.long()], g, z_g, r, p, t)
            for r, g in enumerate(gids)])
        m = shares.amax(dim=0)                                 # pmax
        lse = m + torch.log(torch.exp(shares - m).sum(dim=0))  # psum
        buf = sum(pair.rank_grad_buffer(z[g.long()], g, z_g, r, p, lse, t)
                  for r, g in enumerate(gids))                 # psum
        rows = torch.arange(two_n, device=z.device)
        pos = (rows + batch) % two_n
        pos_logits = (z * z[pos]).sum(dim=1) * (1.0 / t)
        loss = (lse - pos_logits).sum() / two_n
        grad = buf - 2.0 * z[pos]  # d(-positives)/dz times T
        loss_sym, lse_sym = N.ntxent_fwd(z, t)
        grad_sym = N.ntxent_bwd_sym(z, lse_sym, t)
        torch.cuda.synchronize()
        loss_err = abs(loss.item() - loss_sym.item() / two_n)
        grad_err = ((grad - grad_sym).norm() / grad_sym.norm()).item()
        ok = loss_err <= EMULATED_LOSS_ATOL and grad_err <= EMULATED_GRAD_RTOL
        print(f"[pair-ranks] P = {p} pair ranks emulated at global batch "
              f"{batch} (2N = {two_n}, D = {d}, {len(pair._tile_schedule(p))}"
              f" tiles a rank): merged loss {loss.item():.6f} vs single card "
              f"{loss_sym.item() / two_n:.6f} (|err| {loss_err:.2e}, atol "
              f"{EMULATED_LOSS_ATOL:g}); gradient |g_ranks - g_card| / "
              f"|g_card| = {grad_err:.2e} (rtol {EMULATED_GRAD_RTOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the emulated pair ranks (P = {p}) do not give the "
                 "single-card loss and gradient")


def _tri_bounds(rows: int, d: int, itemsize: int):
    """Bounds of #2 and #3 at (2N, D): each input read once (z; the lse for
    #3), each output written once (lse and the loss; the fp32 gradient);
    (2N)^2 D and 3 (2N)^2 D operations at the 3xTF32 rate."""
    z = rows * d * itemsize
    return (_bound(z + rows * 4 + 4, rows * rows * d, PEAK_FP32_FLOPS),
            _bound(z + rows * 4 + rows * d * 4, 3 * rows * rows * d,
                   PEAK_FP32_FLOPS))


def _tri_tf32_control(z, t):
    """((lse, gradient) of #2 + #3, (lse, gradient) of one TF32 pass): max
    abs errors in fp32 against the plain versions, the gradients all at the
    plain forward's lse; the control is the plain versions on z rounded to
    TF32 once."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N

    _, lse_ref = N.ntxent_fwd_tri_plain(z, t)
    grad_ref = N.ntxent_bwd_tri_plain(z, lse_ref, t)
    _, lse = N.ntxent_fwd_tri(z, t)
    grad = N.ntxent_bwd_tri(z, lse_ref, t)
    z_c = N.tf32_split(z)[0]
    _, lse_c = N.ntxent_fwd_tri_plain(z_c, t)
    grad_c = N.ntxent_bwd_tri_plain(z_c, lse_ref, t)
    torch.cuda.synchronize()

    def err(a, b):
        return (a - b).abs().max().item()

    return ((err(lse, lse_ref), err(grad, grad_ref)),
            (err(lse_c, lse_ref), err(grad_c, grad_ref)))


def _tri_plan_line(rows: int, sms: int) -> str:
    """The plan of #2 (and of #3 at D <= 128) at 2N = rows: the busiest
    CTA's tiles and pieces, the longest run, against the mean an SM."""
    from ntxent_tpu_torch.ops import ntxent as N

    runs = N.tri_runs(rows, sms)
    tiles = runs.cta_tiles()
    pieces = max(b - a for a, b in zip(runs.cta_start, runs.cta_start[1:]))
    return (f"{len(tiles)} CTAs over {sum(tiles)} upper tiles: the busiest "
            f"walks {max(tiles)} tiles in at most {pieces} pieces, the "
            f"longest run {max(p[2] for p in runs.pieces)} tiles, against a "
            f"mean of {sum(tiles) / sms:.2f} tiles an SM ({sms} SMs)")


def phase_tri_kernels(build_logs: dict) -> tuple[list[dict], dict]:
    """#2 and #3 against their plain versions and against the rectangular
    kernels (#1 + #5) at every shape and dtype, the loss and the gradient
    bitwise repeatable; in fp32 at 2N = 512 and 8192 at least
    TF32_CONTROL_FACTOR below a one-pass TF32 control; ptxas's report of
    their walks; one ``ntxent_loss_fused(..., triangular=True)`` forward
    and backward (the triangular path) with its launches counted; times
    beside #1 + #5 at 2N = 512, 4096 (T = 0.07) and 8192. Returns the
    kernel entries and the path's launches."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms, launch_counters

    t = NTX_TEMPERATURE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {}
    for rows, d in TRI_SHAPES:
        print(f"[tri-plan] 2N={rows}: {_tri_plan_line(rows, sms)}",
              flush=True)
        for dtype in ("float32", "bfloat16"):
            z = _unit_rows(rows, d, dtype, seed=rows + d + 5)
            loss, lse = N.ntxent_fwd_tri(z, t)
            again, lse_again = N.ntxent_fwd_tri(z, t)
            loss_ref, lse_ref = N.ntxent_fwd_tri_plain(z, t)
            grad = N.ntxent_bwd_tri(z, lse_ref, t)
            grad_again = N.ntxent_bwd_tri(z, lse_ref, t)
            grad_ref = N.ntxent_bwd_tri_plain(z, lse_ref, t)
            loss_rect, lse_rect = N.ntxent_fwd(z, t)
            grad_rect = N.ntxent_bwd_sym(z, lse_rect, t)
            grad_tri = N.ntxent_bwd_tri(z, lse, t)
            torch.cuda.synchronize()
            fwd_err = max((lse - lse_ref).abs().max().item(),
                          abs(loss.item() - loss_ref.item()) / rows)
            bwd_err = (grad - grad_ref).abs().max().item()
            rect_loss = abs(loss.item() - loss_rect.item()) / abs(
                loss_rect.item())
            rect_grad = ((grad_tri - grad_rect).norm()
                         / grad_rect.norm()).item()
            repeat = (again.item() == loss.item()
                      and torch.equal(lse, lse_again))
            repeat_grad = torch.equal(grad, grad_again)
            ok = (max(fwd_err, bwd_err) <= NTX_ATOL and repeat
                  and repeat_grad and rect_loss <= TRI_LOSS_RTOL
                  and rect_grad <= EMULATED_GRAD_RTOL)
            print(f"[tri-kernel] 2N={rows} D={d} {dtype}: ntxent_fwd_tri "
                  f"max|err| {fwd_err:.3e}, ntxent_bwd_tri {bwd_err:.3e} "
                  f"(atol {NTX_ATOL:g}); against #1 + #5: loss "
                  f"{rect_loss:.2e} relative (rtol {TRI_LOSS_RTOL:g}), "
                  f"gradient {rect_grad:.2e} relative (rtol "
                  f"{EMULATED_GRAD_RTOL:g}); loss bitwise repeatable "
                  f"{repeat}, gradient bitwise repeatable {repeat_grad} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the triangular kernels disagree at 2N={rows} D={d} "
                     f"{dtype}")
            if (rows, dtype) == (512, "float32"):
                errs = {"ntxent_fwd_tri": fwd_err, "ntxent_bwd_tri": bwd_err}
            del z, grad, grad_again, grad_ref, grad_rect, grad_tri

    for rows, d in TRI_SHAPES[:2]:
        z = _unit_rows(rows, d, "float32", seed=rows + d)
        kernel, control = _tri_tf32_control(z, t)
        ok = all(k <= NTX_ATOL and TF32_CONTROL_FACTOR * k <= c
                 for k, c in zip(kernel, control))
        print(f"[tri-kernel] TF32 control 2N={rows} D={d} fp32: kernels "
              f"lse {kernel[0]:.3e} grad {kernel[1]:.3e}, one TF32 pass lse "
              f"{control[0]:.3e} grad {control[1]:.3e} (ratios "
              f"{control[0] / max(kernel[0], 1e-30):.1f}, "
              f"{control[1] / max(kernel[1], 1e-30):.1f}; at least "
              f"{TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"#2 and #3 are not {TF32_CONTROL_FACTOR}x more accurate "
                 f"than one TF32 pass at 2N={rows}")
        del z
    for name in ("ntxent_tri_fwd", "ntxent_tri_bwd"):
        for line in _ptxas_walks(build_logs, name):
            print(f"[tri-kernel] ptxas {name}: {line}", flush=True)

    # the triangular path: the public loss's forward and backward
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    z = _unit_rows(*TRI_SHAPES[0], "float32", seed=9).requires_grad_()
    loss = N.ntxent_loss_fused(z, t, triangular=True)
    loss.backward()
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in counters.items()}
    want = {name: TRI_LAUNCHES.get(name, 0) for name in counters}
    finite = bool(torch.isfinite(loss)) and bool(
        torch.isfinite(z.grad).all())
    print(f"[tri] ntxent_loss_fused(z, {t}, triangular=True).backward() at "
          f"2N={TRI_SHAPES[0][0]}: loss {loss.item():.6f}, launches "
          f"{ {n: c for n, c in launches.items() if c} } (every other "
          f"kernel 0), finite loss and gradient {finite}", flush=True)
    if launches != want or not finite:
        fail(f"the triangular loss launched {launches}, expected {want} "
             f"(finite: {finite})")

    times = {}
    for rows, tt in ((512, t), (4096, 0.07), (8192, t)):
        d = 128
        z = _unit_rows(rows, d, "float32", seed=1)
        _, lse = N.ntxent_fwd(z, tt)
        runs = 3 if rows > 4096 else 10
        ms = (cuda_time_ms(lambda: N.ntxent_fwd_tri(z, tt), 20),
              cuda_time_ms(lambda: N.ntxent_bwd_tri(z, lse, tt), 20))
        plain = (cuda_time_ms(lambda: N.ntxent_fwd_tri_plain(z, tt), runs),
                 cuda_time_ms(lambda: N.ntxent_bwd_tri_plain(z, lse, tt),
                              runs))
        rect = (cuda_time_ms(lambda: N.ntxent_fwd(z, tt), 20),
                cuda_time_ms(lambda: N.ntxent_bwd_sym(z, lse, tt), 20))
        bounds = _tri_bounds(rows, d, 4)
        print(f"[tri-kernel] 2N={rows} D={d} T={tt} fp32: ntxent_fwd_tri "
              f"{ms[0]:.4f} ms (plain {plain[0]:.4f}, bound "
              f"{bounds[0][0]:.5f} by {bounds[0][1]}; #1 symmetric "
              f"{rect[0]:.4f}), ntxent_bwd_tri {ms[1]:.4f} ms (plain "
              f"{plain[1]:.4f}, bound {bounds[1][0]:.5f} by {bounds[1][1]}; "
              f"#5 {rect[1]:.4f}); #2 + #3 {ms[0] + ms[1]:.4f} against #1 + "
              f"#5 {rect[0] + rect[1]:.4f}; no single PyTorch call computes "
              f"them, so there is no library time", flush=True)
        times[rows] = (ms, plain, bounds, rect)
        del z
    names = ("ntxent_fwd_tri", "ntxent_bwd_tri")
    replaces = (
        "ntxent_tpu/ops/ntxent_pallas.py:237 (_fwd_tri_kernel, "
        "_fwd_tri_call :308)",
        "ntxent_tpu/ops/ntxent_pallas.py:350 (_bwd_tri_kernel, "
        "_bwd_tri_call :406)")
    sources = ("ntxent_tpu_torch/csrc/ntxent_tri_fwd.cu",
               "ntxent_tpu_torch/csrc/ntxent_tri_bwd.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds, rect = times[512]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True,
                 "launches": None, "max_abs_err": errs[name],
                 "ms": ms[i], "plain_ms": plain[i],
                 "bound_ms": bounds[i][0], "bound_by": bounds[i][1],
                 "library_ms": None, "rectangular_ms": rect[i]}
        for rows in (4096, 8192):
            ms, plain, bounds, rect = times[rows]
            entry |= {f"n{rows}_ms": ms[i], f"n{rows}_plain_ms": plain[i],
                      f"n{rows}_bound_ms": bounds[i][0],
                      f"n{rows}_rectangular_ms": rect[i]}
        out.append(entry)
    return out, launches


def _rel(a, b) -> float:
    """|a - b| / |b| over whole tensors, in fp32."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _tile_rel(a, b) -> float:
    """The largest |a - b| / |b| over the 64-row tiles of (BH, L, D)
    tensors (L a multiple of 64), each tile against its own norm."""
    bh, n, d = b.shape

    def tiles(t):
        return t.float().reshape(bh, n // 64, 64 * d).norm(dim=-1)

    return (tiles(a.float() - b.float()) / tiles(b)).max().item()


def _fold_bound(bh, lq, lk, d, itemsize, pairs, peak):
    """#12's bound: q, k, v read once, (m, l, acc) read and written once;
    4 D operations (q.k and p.v) per live (query, key) pair."""
    moved = (bh * lq * d + 2 * bh * lk * d) * itemsize \
        + 2 * (2 * bh * lq * 4 + bh * lq * d * 4)
    return _bound(moved, 4 * d * bh * pairs, peak)


def _causal_pairs(lq, lk, q_off, k_off) -> int:
    """Live (query, key) pairs of a causal block: key position <= query
    position."""
    import numpy as np

    qpos = q_off + np.arange(lq)
    return int(np.clip(qpos - k_off + 1, 0, lk).sum())


def _fold_carry(bh, lq, d):
    import torch

    return (torch.full((bh, lq), -1e30, device="cuda"),
            torch.zeros(bh, lq, device="cuda"),
            torch.zeros(bh, lq, d, device="cuda"))


def _fold_errors(got, want) -> tuple[float, float, float, float]:
    """(m max|err|, l max relative error, acc / l relative error over the
    whole tensor, acc / l max|err|) of a fold against its plain version;
    every row has seen a key, so l > 0."""
    o_got = got[2] / got[1][..., None]
    o_want = want[2] / want[1][..., None]
    return ((got[0] - want[0]).abs().max().item(),
            ((got[1] - want[1]).abs() / want[1]).max().item(),
            _rel(o_got, o_want), (o_got - o_want).abs().max().item())


def _fold_ok(errs, dtype) -> bool:
    return (errs[0] <= FOLD_M_ATOL and errs[1] <= FOLD_L_RTOL
            and errs[2] <= FOLD_O_RTOL[dtype])


def _fold_report(errs, dtype) -> str:
    return (f"m max|err| {errs[0]:.2e} (atol {FOLD_M_ATOL:g}), l max rel "
            f"err {errs[1]:.2e} (rtol {FOLD_L_RTOL:g}), acc/l |a - b| / |b| "
            f"{errs[2]:.2e} (rtol {FOLD_O_RTOL[dtype]:g}), acc/l max|err| "
            f"{errs[3]:.2e}")


def _flat_qkv(bh, lq, lk, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(bh, n, d, generator=gen, device="cuda").to(dt)
                 for n in (lq, lk, lk))


def _hop_backward(q, k, v, do) -> dict:
    """#13 and #14 at a causal hop (q_offset = k_offset = 0) against their
    plain versions, run in q-row chunks that fit the card: the true lse
    and delta from the plain forward of each chunk; dq joined and (dk,
    dv) summed over the chunks. Returns the stats, the max|err| and
    |a - b| / |b| of each, the control (the plain sums without the first
    q chunk, which must miss) and the plain versions' times."""
    import torch

    from ntxent_tpu_torch.ops import attention as A
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    rows = q.shape[1] // HOP_PLAIN_CHUNKS
    parts = [(c * rows, slice(c * rows, (c + 1) * rows))
             for c in range(HOP_PLAIN_CHUNKS)]
    lse, delta = [], []
    for off, sl in parts:
        o, chunk_lse = A.attention_plain(q[:, sl], k, v, causal=True,
                                         q_offset=off)
        lse.append(chunk_lse)
        delta.append((do[:, sl].float() * o.float()).sum(-1))
        del o
    lse, delta = torch.cat(lse, 1), torch.cat(delta, 1)

    def chunk(off, sl):
        return ((q[:, sl], k, v, do[:, sl], lse[:, sl], delta[:, sl]),
                dict(causal=True, q_offset=off))

    def plain_dq(chunks=parts):
        return torch.cat([A.attention_dq_plain(*a, **kw)
                          for a, kw in (chunk(*p) for p in chunks)], 1)

    def plain_dkv(chunks=parts):
        dk = dv = 0
        for a, kw in (chunk(*p) for p in chunks):
            gk, gv = A.attention_dkv_plain(*a, **kw)
            dk, dv = dk + gk, dv + gv
        return dk, dv

    dq_want, (dk_want, dv_want) = plain_dq(), plain_dkv()
    dq_plain_ms = cuda_time_ms(plain_dq, runs=1, warmup=0)
    dkv_plain_ms = cuda_time_ms(plain_dkv, runs=1, warmup=0)
    kw = dict(causal=True, q_offset=0, k_offset=0)
    dq = A.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = A.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    out = {"stats": (lse, delta), "dq_plain_ms": dq_plain_ms,
           "dkv_plain_ms": dkv_plain_ms,
           "dq_err": (dq - dq_want).abs().max().item(),
           "dq_rel": _rel(dq, dq_want),
           "dq_tile": _tile_rel(dq, dq_want),
           "dkv_err": max((dk - dk_want).abs().max().item(),
                          (dv - dv_want).abs().max().item()),
           "dkv_rel": max(_rel(dk, dk_want), _rel(dv, dv_want)),
           "dkv_tile": max(_tile_rel(dk, dk_want), _tile_rel(dv, dv_want))}
    # the tile controls (HOP_TILE_RTOL): one tile pair's plain share taken
    # out of the heaviest walk
    n = q.shape[1]
    last, mid = slice(n - 64, n), slice(n // 2, n // 2 + 64)
    dq_want[:, last] -= A.attention_dq_plain(
        q[:, last], k[:, mid], v[:, mid], do[:, last], lse[:, last],
        delta[:, last], causal=True, q_offset=n - 64, k_offset=n // 2)
    first, second = slice(0, 64), slice(64, 128)
    gk, gv = A.attention_dkv_plain(
        q[:, second], k[:, first], v[:, first], do[:, second],
        lse[:, second], delta[:, second], causal=True, q_offset=64)
    dk_want[:, first] -= gk
    dv_want[:, first] -= gv
    out["dq_tile_control"] = _tile_rel(dq, dq_want)
    out["dkv_tile_control"] = max(_tile_rel(dk, dk_want),
                                  _tile_rel(dv, dv_want))
    dq_want = torch.cat([torch.zeros_like(dq_want[:, parts[0][1]]),
                         plain_dq(parts[1:])], 1)
    dk_want, dv_want = plain_dkv(parts[1:])
    out["dq_control"] = (dq - dq_want).abs().max().item()
    out["dkv_control"] = max((dk - dk_want).abs().max().item(),
                             (dv - dv_want).abs().max().item())
    return out


def _hop_bwd_check(label: str, bwd: dict, gate: bool = True) -> None:
    """Print #13's and #14's readings at a hop (``_hop_backward``) and,
    with ``gate``, fail unless each max|err| is within BWD_ATOL and each
    tile's relative error within HOP_TILE_RTOL, and every control misses
    both."""
    tol, rtol = BWD_ATOL["bfloat16"], HOP_TILE_RTOL
    ok = (bwd["dq_err"] <= tol["dq"] < bwd["dq_control"]
          and bwd["dkv_err"] <= tol["dkv"] < bwd["dkv_control"]
          and bwd["dq_tile"] <= rtol < bwd["dq_tile_control"]
          and bwd["dkv_tile"] <= rtol < bwd["dkv_tile_control"])
    verdict = ("ok" if ok else "MISMATCH") if gate else "(not gated)"
    print(f"[fold-kernel] {label} hop backward against the plain "
          f"versions (true lse and delta, {HOP_PLAIN_CHUNKS} q-row "
          f"chunks): dq max|err| {bwd['dq_err']:.3e} (atol "
          f"{tol['dq']:g}), |a - b| / |b| {bwd['dq_rel']:.2e}, worst 64-row "
          f"tile {bwd['dq_tile']:.3e} (rtol {rtol:g}); dk/dv max|err| "
          f"{bwd['dkv_err']:.3e} (atol {tol['dkv']:g}), |a - b| / |b| "
          f"{bwd['dkv_rel']:.2e}, worst 64-row tile {bwd['dkv_tile']:.3e} "
          f"(rtol {rtol:g}); without the first q chunk the plain dq "
          f"would miss by {bwd['dq_control']:.3e} and dk/dv by "
          f"{bwd['dkv_control']:.3e}; the worst tile would read "
          f"{bwd['dq_tile_control']:.3e} on dq with the last q tile's "
          f"middle kv tile left out, {bwd['dkv_tile_control']:.3e} on dk/dv "
          f"with kv tile 0's q tile 1 left out; plain dq "
          f"{bwd['dq_plain_ms']:.4f} ms, plain dk/dv "
          f"{bwd['dkv_plain_ms']:.4f} ms {verdict}", flush=True)
    if gate and not ok:
        fail(f"flash_attention_dq/_dkv disagree with their plain versions "
             f"at the {label} hop, or a control did not miss")


def _hop_tensors(length: int):
    """(q, k, v, do) of the hops of 12g: bf16 (LONGCTX_BH, length,
    LONGCTX_HEAD_DIM) from seeds 700 and 701."""
    bh, d = LONGCTX_BH, LONGCTX_HEAD_DIM
    q, k, v = _flat_qkv(bh, length, length, d, "bfloat16", 700)
    return q, k, v, _flat_qkv(bh, length, length, d, "bfloat16", 701)[0]


HOP_LENGTHS = (("path", LONGCTX_LEN), ("p4_hop", LONGCTX_LEN // 4))


def phase_fold_kernel() -> tuple[dict, dict]:
    """flash_fold (#12) against flash_fold_plain: consecutive folds with a
    carried state at every case's offsets, then a block wholly after the
    rows, whose carry must come out bit for bit, and the control (the
    plain fold of the last block from a fresh carry must miss); then at
    the long-context path's world-1 hop and at the P = 4 hop, the kernel
    against the plain version (run in row chunks), its time beside its
    bound and the plain version's; the dQ and dK/dV kernels (#13, #14) at
    the same hops against theirs (``_hop_backward``, ``_hop_bwd_check``).
    Returns #12's entry and the ring times of #13/#14."""
    import torch
    import torch.nn.functional as F

    from ntxent_tpu_torch.ops import attention as A
    from ntxent_tpu_torch.utils.capability import set_fp32_precision
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    set_fp32_precision()
    for i, (name, (bh, lq, lk, d), dtype, causal, q_off, k_offs) in \
            enumerate(FOLD_CASES):
        q, _, _ = _flat_qkv(bh, lq, lk, d, dtype, 500 + i)
        carry = want = _fold_carry(bh, lq, d)
        errs = (0.0, 0.0, 0.0, 0.0)
        for j, k_off in enumerate(k_offs):
            _, k, v = _flat_qkv(bh, lq, lk, d, dtype, 600 + 10 * i + j)
            kw = dict(q_offset=q_off, k_offset=k_off, causal=causal)
            carry = A.flash_fold(q, k, v, *carry, **kw)
            want = A.flash_fold_plain(q, k, v, *want, **kw)
            torch.cuda.synchronize()
            errs = tuple(map(max, errs, _fold_errors(carry, want)))
        # the control: the last block folded into a fresh carry
        control = _fold_errors(carry, A.flash_fold_plain(
            q, k, v, *_fold_carry(bh, lq, d), **kw))[2]
        after = A.flash_fold(q, k, v, *carry, q_offset=q_off,
                             k_offset=q_off + lq, causal=True)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(after, carry))
        ok = (_fold_ok(errs, dtype) and bitwise
              and control > FOLD_O_RTOL[dtype])
        print(f"[fold-kernel] {name} (BH={bh}, Lq={lq}, Lk={lk}, D={d}, "
              f"{dtype}, {'causal' if causal else 'full'}, q_offset "
              f"{q_off}, k_offsets {list(k_offs)}): "
              f"{_fold_report(errs, dtype)}; a fold that dropped the carry "
              f"would miss by {control:.2e}; a hop wholly in the rows' "
              f"future leaves the carry bit for bit: {bitwise} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"flash_fold disagrees with its plain version in case "
                 f"{name}")
        del q, k, v, carry, want, after
    _truth_gate(*TRUTH_GATES[2])

    times = {}
    for label, length in HOP_LENGTHS:
        bh, d = LONGCTX_BH, LONGCTX_HEAD_DIM
        q, k, v, do = _hop_tensors(length)
        carry = _fold_carry(bh, length, d)
        kw = dict(q_offset=0, k_offset=0, causal=True)
        got = A.flash_fold(q, k, v, *carry, **kw)
        ms = cuda_time_ms(lambda: A.flash_fold(q, k, v, *carry, **kw),
                          runs=5, warmup=1)
        rows = length // HOP_PLAIN_CHUNKS

        def plain():  # the same work in row chunks that fit the card
            parts = [A.flash_fold_plain(
                q[:, sl], k, v, carry[0][:, sl], carry[1][:, sl],
                carry[2][:, sl], q_offset=c * rows, k_offset=0, causal=True)
                for c, sl in ((c, slice(c * rows, (c + 1) * rows))
                              for c in range(HOP_PLAIN_CHUNKS))]
            return tuple(torch.cat(t, dim=1) for t in zip(*parts))

        want = plain()
        plain_ms = cuda_time_ms(plain, runs=1, warmup=0)
        errs = _fold_errors(got, want)
        ok = _fold_ok(errs, "bfloat16")
        del got, want
        pairs = _causal_pairs(length, length, 0, 0)
        bound = _fold_bound(bh, length, length, d, 2, pairs, PEAK_BF16_FLOPS)
        bwd = _hop_backward(q, k, v, do)
        stats = bwd.pop("stats")
        dq_ms = cuda_time_ms(lambda: A.flash_attention_dq(
            q, k, v, do, *stats, **kw), runs=3, warmup=1)
        dkv_ms = cuda_time_ms(lambda: A.flash_attention_dkv(
            q, k, v, do, *stats, **kw), runs=3, warmup=1)
        # SDPA's causal attention of the same (1, 8, L, 64) block: its
        # forward, and its backward (dq, dk, dv in one call), the library
        # time of #13 and #14 at the hop; the port never calls it.
        q4, k4, v4, do4 = (t.view(1, bh, length, d).detach().requires_grad_()
                           for t in (q, k, v, do))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        sdpa_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), runs=3, warmup=1)
        sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4.detach(), retain_graph=True), runs=3,
            warmup=1)
        del q4, k4, v4, do4, out4
        inputs = 4 * bh * length * d * 2 + 2 * bh * length * 4
        dq_bound = _bound(inputs + bh * length * d * 4,
                          3 * 2 * d * bh * pairs, PEAK_BF16_FLOPS)
        dkv_bound = _bound(inputs + 2 * bh * length * d * 4,
                           4 * 2 * d * bh * pairs, PEAK_BF16_FLOPS)
        print(f"[fold-kernel] {label} hop (BH={bh}, L={length}, D={d}, bf16, "
              f"causal, q_offset = k_offset = 0): against the plain version "
              f"{_fold_report(errs, 'bfloat16')} {'ok' if ok else 'MISMATCH'}"
              f"; flash_fold {ms:.4f} ms (plain {plain_ms:.4f} ms in "
              f"{HOP_PLAIN_CHUNKS} row chunks, bound {bound[0]:.4f} by "
              f"{bound[1]}; no single PyTorch call folds into a carried "
              f"state); flash_attention_dq {dq_ms:.4f} ms (bound "
              f"{dq_bound[0]:.4f}), flash_attention_dkv {dkv_ms:.4f} ms "
              f"(bound {dkv_bound[0]:.4f}); SDPA causal forward "
              f"{sdpa_fwd_ms:.4f} ms, backward (dq, dk, dv together) "
              f"{sdpa_bwd_ms:.4f} ms", flush=True)
        if not ok:
            fail(f"flash_fold disagrees with its plain version at the "
                 f"{label} hop")
        _hop_bwd_check(label, bwd)
        times[label] = dict(ms=ms, plain_ms=plain_ms, bound=bound,
                            err=errs[3], dq=(dq_ms, dq_bound),
                            dkv=(dkv_ms, dkv_bound), sdpa_fwd=sdpa_fwd_ms,
                            sdpa_bwd=sdpa_bwd_ms, bwd=bwd)
        del q, k, v, do, carry, stats
        torch.cuda.empty_cache()
    path, p4 = times["path"], times["p4_hop"]
    entry = {"name": "flash_fold", "route": "cuda",
             "source": "ntxent_tpu_torch/csrc/flash_attention_fold.cu",
             "replaces": "ntxent_tpu/ops/attention_pallas.py:217 "
                         "(_fold_kernel, flash_fold :261)",
             "checked": True, "launches": None, "max_abs_err": path["err"],
             "ms": path["ms"], "plain_ms": path["plain_ms"],
             "bound_ms": path["bound"][0], "bound_by": path["bound"][1],
             "library_ms": None, "p4_hop_ms": p4["ms"],
             "p4_hop_plain_ms": p4["plain_ms"],
             "p4_hop_bound_ms": p4["bound"][0],
             # SDPA's whole causal attention, not a fold: a yardstick only
             "longctx_hop_sdpa_fwd_ms": path["sdpa_fwd"],
             "p4_hop_sdpa_fwd_ms": p4["sdpa_fwd"]}
    ring = {name: {"longctx_hop_ms": path[key][0],
                   "longctx_hop_plain_ms": path["bwd"][f"{key}_plain_ms"],
                   "longctx_hop_bound_ms": path[key][1][0],
                   "longctx_hop_library_ms": path["sdpa_bwd"],
                   "longctx_hop_max_abs_err": path["bwd"][f"{key}_err"],
                   "p4_hop_ms": p4[key][0],
                   "p4_hop_plain_ms": p4["bwd"][f"{key}_plain_ms"],
                   "p4_hop_bound_ms": p4[key][1][0],
                   "p4_hop_library_ms": p4["sdpa_bwd"],
                   "p4_hop_max_abs_err": p4["bwd"][f"{key}_err"]}
            for name, key in (("flash_attention_dq", "dq"),
                              ("flash_attention_dkv", "dkv"))}
    return entry, ring


def _attention_grads(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn`` for the cotangent ``do``."""
    import torch

    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


def phase_emulated_rings() -> None:
    """Ring attention of P = 2, 4, 8 ranks emulated on one card at (B 1,
    L 8192, H 8, D 64), bf16 and fp32, causal and not: the flash ring
    (#12 forward, #13/#14 backward) against the jnp ring and against
    flash_attention on the whole sequence, out, dq, dk and dv; exactly P
    folds per rank forward and P dQ and dK/dV hops per rank backward, no
    forward kernel (#11)."""
    import torch

    from ntxent_tpu_torch.ops.attention import flash_attention
    from ntxent_tpu_torch.utils.capability import set_fp32_precision
    from ntxent_tpu_torch.utils.profiling import (
        emulated_ring_attention,
        launch_counters,
    )

    set_fp32_precision()
    counters = launch_counters()
    s = RING_SHAPE
    for dtype in ("bfloat16", "float32"):
        for causal in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(800)
            q, k, v, do = (torch.randn(s["b"], s["l"], s["h"], s["d"],
                                       generator=gen, device="cuda")
                           .to(getattr(torch, dtype)) for _ in range(4))
            for t in (q, k, v):
                t.requires_grad_()
            ref = _attention_grads(
                lambda a, b, c: flash_attention(a, b, c, causal=causal),
                q, k, v, do)
            for p in RING_WORLDS:
                for wrapper in counters.values():
                    wrapper.launches = 0
                out = emulated_ring_attention(p, causal=causal)(q, k, v)
                fwd = {n: w.launches for n, w in counters.items()}
                grads = torch.autograd.grad(out, (q, k, v), do)
                torch.cuda.synchronize()
                both = {n: w.launches for n, w in counters.items()}
                flash = (out.detach(), *grads)
                jnp = _attention_grads(
                    emulated_ring_attention(p, causal=causal, impl="jnp"),
                    q, k, v, do)
                want_fwd = {n: p * p if n == "flash_fold" else 0
                            for n in counters}
                want_both = {n: p * p if n in ("flash_fold",
                                               "flash_attention_dq",
                                               "flash_attention_dkv") else 0
                             for n in counters}
                err_ref = max(_rel(a, b) for a, b in zip(flash, ref))
                err_jnp = max(_rel(a, b) for a, b in zip(flash, jnp))
                tol = RING_RTOL[dtype]
                ok = (fwd == want_fwd and both == want_both
                      and err_ref <= tol and err_jnp <= tol)
                print(f"[ring] P = {p} ranks emulated, (B={s['b']}, "
                      f"L={s['l']}, H={s['h']}, D={s['d']}) {dtype} "
                      f"{'causal' if causal else 'full'}: flash ring vs "
                      f"flash_attention of the whole sequence "
                      f"{err_ref:.2e}, vs the jnp ring {err_jnp:.2e} (the "
                      f"largest relative error of out, dq, dk, dv; rtol "
                      f"{tol:g}); launches forward "
                      f"{ {n: c for n, c in fwd.items() if c} }, forward "
                      f"and backward { {n: c for n, c in both.items() if c} }"
                      f" ({p} a rank each) {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                if not ok:
                    fail(f"the emulated ring of {p} ranks ({dtype}, causal "
                         f"{causal}) disagrees or launched {both}")
                del out, grads, flash, jnp
            del q, k, v, do, ref
    torch.cuda.empty_cache()


def _set_attention(model, fn) -> None:
    model.attention_fn = fn
    for block in model.blocks:
        block.attn.attention_fn = fn


def _long_context_pass(model, tokens):
    """(output, every parameter's gradient) of one forward and backward of
    the probe sum(out^2)."""
    import torch

    model.zero_grad(set_to_none=True)
    out = model(tokens)
    out.float().pow(2).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), [p.grad for p in model.parameters()]


def phase_long_context(card_line: str) -> dict:
    """The long-context path at full width over the NCCL group of world 1:
    three forward and backward passes of LongContextTransformer under
    make_ring_attention(group, causal=True, impl="flash"), each launching
    exactly 8/8/8 of #12/#13/#14 and nothing else; every parameter's
    gradient finite; the output and gradients against the same weights
    under flash_attention and under 4 emulated ring ranks; then an fp32
    model at depth 2, L = 1024 against the CPU. Returns the launches of
    one pass."""
    import copy
    from functools import partial

    import torch

    from ntxent_tpu_torch.ops.attention import flash_attention
    from ntxent_tpu_torch.parallel import make_ring_attention
    from ntxent_tpu_torch.utils.capability import set_fp32_precision
    from ntxent_tpu_torch.utils.profiling import (
        build_long_context,
        emulated_ring_attention,
        launch_counters,
        long_context_tokens,
    )

    set_fp32_precision()
    torch.cuda.empty_cache()
    plan = make_ring_attention(torch.distributed.group.WORLD, causal=True,
                               impl="flash")
    model = build_long_context("cuda", plan)
    tokens = long_context_tokens("cuda", LONGCTX_LEN, LONGCTX_BATCH)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LONGCTX_PASSES):
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        out, grads = _long_context_pass(model, tokens)
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {name: w.launches for name, w in counters.items()}
        want = {n: LONGCTX_LAUNCHES.get(n, 0) for n in counters}
        if launches != want:
            fail(f"a long-context pass launched {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    names = [n for n, _ in model.named_parameters()]
    bad = [n for n, g in zip(names, grads)
           if g is None or not torch.isfinite(g).all()]
    if bad or not torch.isfinite(out).all() or out.shape != (
            LONGCTX_BATCH, LONGCTX_LEN, 512):
        fail(f"long-context output {tuple(out.shape)} finite "
             f"{bool(torch.isfinite(out).all())}; parameters without a "
             f"finite gradient: {bad}")
    grads = torch.cat([g.reshape(-1) for g in grads])
    print(f"[longctx] LongContextTransformer (vocab 49408, 512/8/8/2048, "
          f"max_len 32768, bf16) B={LONGCTX_BATCH}, L={LONGCTX_LEN}, causal "
          f"ring attention (flash) over the NCCL group of world 1: "
          f"{LONGCTX_PASSES} forward + backward passes "
          f"{[round(t, 1) for t in times]} ms (host clock, synchronized); "
          f"{LONGCTX_BATCH * LONGCTX_LEN / (min(times[1:]) / 1e3):.0f} "
          f"tokens/s at the fastest later pass; launches per pass "
          f"{ {n: c for n, c in launches.items() if c} } (every other "
          f"kernel 0); every parameter has a finite gradient; peak memory "
          f"{peak / 2**30:.2f} GiB on {card_line}", flush=True)
    for label, fn in (("flash_attention", partial(flash_attention,
                                                  causal=True)),
                      ("4 emulated ring ranks",
                       emulated_ring_attention(4, causal=True))):
        _set_attention(model, fn)
        out_b, grads_b = _long_context_pass(model, tokens)
        grads_b = torch.cat([g.reshape(-1) for g in grads_b])
        out_err, grad_err = _rel(out, out_b), _rel(grads, grads_b)
        ok = out_err <= LONGCTX_OUT_RTOL and grad_err <= LONGCTX_GRAD_RTOL
        print(f"[longctx] the same weights under {label}: output "
              f"|a - b| / |b| {out_err:.2e} (rtol {LONGCTX_OUT_RTOL:g}), "
              f"gradient {grad_err:.2e} (rtol {LONGCTX_GRAD_RTOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the ring plan disagrees with {label}")
        del out_b, grads_b
    del model, out, grads
    torch.cuda.empty_cache()

    # fp32 at depth 2, L = 1024: the card against the CPU
    model = build_long_context("cuda", plan, depth=2, dtype=torch.float32)
    cpu = copy.deepcopy(model).cpu()
    short = tokens[:, :LONGCTX_PARITY_LEN]
    out, grads = _long_context_pass(model, short)
    out_c, grads_c = _long_context_pass(cpu, short.cpu())
    out_err = (out.cpu() - out_c).abs().max().item()
    grad_err = _rel(torch.cat([g.reshape(-1).cpu() for g in grads]),
                    torch.cat([g.reshape(-1) for g in grads_c]))
    ok = out_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
    print(f"[longctx] fp32, depth 2, L = {LONGCTX_PARITY_LEN}: card vs CPU "
          f"output max|err| {out_err:.2e} (atol {PARITY_LOSS_ATOL:g}), "
          f"gradient |g_card - g_cpu| / |g_cpu| {grad_err:.2e} (rtol "
          f"{PARITY_GRAD_RTOL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the fp32 long-context model on the card disagrees with the CPU")
    del model, cpu
    torch.cuda.empty_cache()
    return launches


def _ntxent_grad(fn, z) -> tuple:
    """(loss, gradient of z) of ``fn(z1, z2)`` on the stacked views z =
    [z1; z2]."""
    import torch

    zr = z.clone().requires_grad_()
    n = z.shape[0] // 2
    loss = fn(zr[:n], zr[n:])
    grad, = torch.autograd.grad(loss, zr)
    return loss.item(), grad


def _fused_ntxent(t):
    """ntxent_loss_fused of the views (z1, z2), the one-card reference."""
    import torch

    from ntxent_tpu_torch.ops.ntxent import ntxent_loss_fused

    return lambda z1, z2: ntxent_loss_fused(torch.cat([z1, z2]), t)


def phase_world1_plans() -> None:
    """At world 1 over the NCCL group: Ulysses attention equals
    attention_oracle (its all-to-alls are the identity), and the flash ring
    with transfer_chunks=2 gives the same output and gradients as with one
    chunk, bit for bit; the ring NT-Xent's entry point, impl "fused" and
    "auto", equals ntxent_loss_fused in loss and gradient and launches #1
    general and #6 rows and columns once each."""
    import torch

    from ntxent_tpu_torch.parallel import (
        attention_oracle,
        make_ring_attention,
        make_ring_ntxent,
        make_ulysses_attention,
    )
    from ntxent_tpu_torch.utils.profiling import launch_counters

    group = torch.distributed.group.WORLD
    s = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(900)
    q, k, v, do = (torch.randn(s["b"], s["l"], s["h"], s["d"], generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    uly = _attention_grads(make_ulysses_attention(group, causal=True),
                           q, k, v, do)
    ref = _attention_grads(lambda a, b, c: attention_oracle(a, b, c,
                                                            causal=True),
                           q, k, v, do)
    uly_ok = all(torch.equal(a, b) for a, b in zip(uly, ref))
    one, two = (_attention_grads(make_ring_attention(
        group, causal=True, impl="flash", transfer_chunks=c), q, k, v, do)
        for c in (1, 2))
    chunks_ok = all(torch.equal(a, b) for a, b in zip(one, two))
    print(f"[world1] Ulysses at world 1 equals attention_oracle (out, dq, "
          f"dk, dv; {s}, bf16, causal) bit for bit: {uly_ok}; the flash "
          f"ring with transfer_chunks=2 equals one chunk bit for bit: "
          f"{chunks_ok}", flush=True)
    if not (uly_ok and chunks_ok):
        fail("Ulysses or the chunked ring disagrees at world 1")
    del q, k, v, do, uly, ref, one, two

    t = NTX_TEMPERATURE
    z = _unit_rows(RING_NTX_2N, 128, "float32", seed=32)
    ref_loss, ref_grad = _ntxent_grad(_fused_ntxent(t), z)
    counters = launch_counters()
    for impl in ("fused", "auto"):
        for wrapper in counters.values():
            wrapper.launches = 0
        loss, grad = _ntxent_grad(make_ring_ntxent(group, t, impl=impl), z)
        launches = {name: w.launches for name, w in counters.items()}
        want = {n: 1 if n in RING_NTX_KERNELS else 0 for n in counters}
        loss_err, grad_err = abs(loss - ref_loss), _rel(grad, ref_grad)
        ok = (loss_err <= EMULATED_LOSS_ATOL
              and grad_err <= EMULATED_GRAD_RTOL and launches == want)
        print(f"[world1] make_ring_ntxent(group, {t}, impl={impl!r}) at "
              f"world 1 (2N = {RING_NTX_2N}, D = 128, fp32): loss "
              f"{loss:.6f} vs ntxent_loss_fused {ref_loss:.6f} (|err| "
              f"{loss_err:.2e}, atol {EMULATED_LOSS_ATOL:g}); gradient "
              f"{grad_err:.2e} relative (rtol {EMULATED_GRAD_RTOL:g}); "
              f"launches { {n: c for n, c in launches.items() if c} } "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the ring NT-Xent ({impl}) at world 1 disagrees or "
                 f"launched {launches}")


def phase_ring_ntxent_emulated() -> dict:
    """The fused ring NT-Xent of P = 2, 4, 8 ranks emulated on one card at
    global 2N = 8192, D = 128 (``emulated_ring_ntxent``: each rank's hops
    through the ring's own ``lse_hop`` with block_lse (#1 general), its
    backward's block_grads (#6 rows and columns) in reverse hop order, the
    column gradients carried to their block's rank); against
    ntxent_loss_fused
    and its gradient. Returns the kernels' times at the P = 4 hop."""
    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel.mesh import local_row_gids
    from ntxent_tpu_torch.utils.profiling import (
        cuda_time_ms,
        emulated_ring_ntxent,
        launch_counters,
    )

    t, d = NTX_TEMPERATURE, 128
    two_n = RING_NTX_2N
    z = _unit_rows(two_n, d, "float32", seed=31)  # [view 1; view 2]
    ref_loss, ref_grad = _ntxent_grad(_fused_ntxent(t), z)
    counters = launch_counters()
    for p in RING_WORLDS:
        for wrapper in counters.values():
            wrapper.launches = 0
        loss, grad = _ntxent_grad(emulated_ring_ntxent(p, t), z)
        launches = {name: w.launches for name, w in counters.items()}
        loss_err = abs(loss - ref_loss)
        grad_err = _rel(grad, ref_grad)
        want = {n_: p * p if n_ in RING_NTX_KERNELS else 0
                for n_ in counters}
        ok = (loss_err <= EMULATED_LOSS_ATOL
              and grad_err <= EMULATED_GRAD_RTOL and launches == want)
        print(f"[ring-ntxent] P = {p} ranks emulated (2N = {two_n}, D = {d}, "
              f"fused: block_lse / block_grads): loss {loss:.6f} vs "
              f"ntxent_loss_fused {ref_loss:.6f} (|err| {loss_err:.2e}, "
              f"atol {EMULATED_LOSS_ATOL:g}); gradient {grad_err:.2e} "
              f"relative (rtol {EMULATED_GRAD_RTOL:g}); launches "
              f"{ {k: c for k, c in launches.items() if c} } ({p} a rank "
              f"each) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the emulated ring NT-Xent of {p} ranks disagrees or "
                 f"launched {launches}")
    # the P = 4 hop: 2n = 2048 rows against a 2048-column block
    n = two_n // 2 // 4
    gid0, gid1 = (local_row_gids(r, n, 4, z.device) for r in (0, 1))
    z0, z1 = z[gid0.long()], z[gid1.long()]
    lse0 = N.block_lse(z0, z1, gid0, gid1, t, two_n)
    # #6 at the hop against its plain versions (the ring's mode: the
    # block's column ids, cols_actual = n_half = 2N), NTX_ATOL
    hop = (z0, z1, gid0, lse0, t, gid1, two_n, two_n)
    got = N.block_grads(z0, z1, gid0, gid1, lse0, t, two_n)
    want = (N.ntxent_bwd_general_rows_plain(*hop),
            N.ntxent_bwd_general_cols_plain(*hop))
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    ok = max(errs) <= NTX_ATOL
    print(f"[ring-ntxent] the P = 4 hop: #6 rows max|err| {errs[0]:.3e}, "
          f"cols {errs[1]:.3e} against the plain versions (atol "
          f"{NTX_ATOL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("#6 disagrees with its plain versions at the ring's P = 4 hop")
    lse_ms = cuda_time_ms(lambda: N.block_lse(z0, z1, gid0, gid1, t, two_n))
    grads_ms = cuda_time_ms(lambda: N.block_grads(z0, z1, gid0, gid1, lse0,
                                                  t, two_n))
    rows_ms, cols_ms = (cuda_time_ms(lambda: fn(*hop)) for fn in (
        N.ntxent_bwd_general_rows, N.ntxent_bwd_general_cols))
    print(f"[ring-ntxent] the P = 4 hop (2048 rows x 2048 columns, D = {d}, "
          f"fp32): block_lse (#1 general) {lse_ms:.4f} ms, block_grads (#6 "
          f"rows + columns) {grads_ms:.4f} ms (rows {rows_ms:.4f}, columns "
          f"{cols_ms:.4f})", flush=True)
    return {"ntxent_fwd_general": {"ring_hop_ms": lse_ms},
            "ntxent_bwd_general_rows": {"ring_hop_rows_and_cols_ms":
                                        grads_ms, "ring_hop_ms": rows_ms},
            "ntxent_bwd_general_cols": {"ring_hop_ms": cols_ms}}


def phase_ring_infonce() -> None:
    """The ring InfoNCE, dual and twoblock, at world 1 over the NCCL group
    against the port's dual InfoNCE (info_nce_fused, #9/#10) on the same
    pairs and a learnable scale: loss and the gradients of both
    embeddings and of the scale."""
    import torch

    from ntxent_tpu_torch.ops.infonce import info_nce_fused
    from ntxent_tpu_torch.parallel import make_ring_infonce

    group = torch.distributed.group.WORLD
    za, zb = (_unit_rows(RING_INFONCE_N, 512, "float32", seed=s)
              for s in (41, 42))

    def loss_and_grads(fn):
        a, b = za.clone().requires_grad_(), zb.clone().requires_grad_()
        scale = torch.tensor(DP_CLIP_SCALE, device="cuda",
                             requires_grad=True)
        loss = fn(a, b, scale)
        return (loss.detach(), *torch.autograd.grad(loss, (a, b, scale)))

    ref = loss_and_grads(lambda a, b, s: info_nce_fused(a, b, scale=s))
    for impl in ("dual", "twoblock"):
        got = loss_and_grads(make_ring_infonce(group, impl=impl))
        loss_err = abs(got[0].item() - ref[0].item())
        grad_err = max(_rel(g, w) for g, w in zip(got[1:], ref[1:]))
        ok = (loss_err <= EMULATED_LOSS_ATOL
              and grad_err <= EMULATED_GRAD_RTOL)
        print(f"[ring-infonce] {impl} ring at world 1 (N = {RING_INFONCE_N}, "
              f"D = 512, scale {DP_CLIP_SCALE:.4f}): loss {got[0].item():.6f}"
              f" vs info_nce_fused {ref[0].item():.6f} (|err| "
              f"{loss_err:.2e}); gradients of za, zb and the scale "
              f"{grad_err:.2e} relative (rtol {EMULATED_GRAD_RTOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the {impl} ring InfoNCE disagrees with info_nce_fused")


def phase_flash_fp32() -> dict:
    """The fp32 variants of #11-#14 (the FMA walks of
    ``flash_attention_tile.cuh`` and the fp32 branches of
    ``flash_attention_bwd.cu``) timed at the training shape (B*H = 6144,
    L = 197, D = 64) beside their plain versions and their bound (fp32
    operations at the fp32-accurate rate, PEAK_FP32_FLOPS). Returns each
    wrapper's fp32 fields for the kernels line; their accuracy is held in
    phases 3, 3b and 12g."""
    import torch

    from ntxent_tpu_torch.ops import attention as A
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t0 = time.monotonic()
    s = TRAIN_SHAPE
    bh, l, d = s["b"] * s["h"], s["lq"], s["d"]
    q, k, v = _qkv(s, "float32", seed=500)
    args, kw = _bwd_inputs(s, "float32", False, 0, 0, 501)
    m = torch.full((bh, l), -1e30, device="cuda")
    lsum = torch.zeros((bh, l), device="cuda")
    acc = torch.zeros((bh, l, d), device="cuda")
    qkv = 3 * bh * l * d * 4
    pairs = bh * l * l * d
    cases = {
        "flash_attention_fwd": (lambda: A.flash_attention_fwd(q, k, v),
                                lambda: A.attention_plain(q, k, v),
                                qkv + bh * l * d * 4 + bh * l * 4,
                                4 * pairs),
        "flash_fold": (lambda: A.flash_fold(q, k, v, m, lsum, acc),
                       lambda: A.flash_fold_plain(q, k, v, m, lsum, acc),
                       qkv + 2 * (2 * bh * l * 4 + bh * l * d * 4),
                       4 * pairs),
        "flash_attention_dq": (
            lambda: A.flash_attention_dq(*args, **kw),
            lambda: A.attention_dq_plain(*args, **kw),
            4 * bh * l * d * 4 + 2 * bh * l * 4 + bh * l * d * 4,
            3 * 2 * pairs),
        "flash_attention_dkv": (
            lambda: A.flash_attention_dkv(*args, **kw),
            lambda: A.attention_dkv_plain(*args, **kw),
            4 * bh * l * d * 4 + 2 * bh * l * 4 + 2 * bh * l * d * 4,
            4 * 2 * pairs),
    }
    fields = {}
    for name, (kernel, plain, moved, flops) in cases.items():
        ms = cuda_time_ms(kernel)
        plain_ms = cuda_time_ms(plain, runs=3)
        bound_ms, bound_by = _bound(moved, flops, PEAK_FP32_FLOPS)
        print(f"[flash-fp32] {name} (B*H={bh}, L={l}, D={d}, fp32): "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} by "
              f"{bound_by}; {ms / bound_ms:.1f}x the bound)", flush=True)
        fields[name] = {"fp32_ms": ms, "fp32_plain_ms": plain_ms,
                        "fp32_bound_ms": bound_ms}
    print(f"[flash-fp32] phase {time.monotonic() - t0:.1f} s", flush=True)
    return fields


def _wide_families():
    """The loss kernels by family: (label, wrapper names, tolerance,
    inputs(dtype, rows, cols, d), fwd(inputs), fwd_plain(inputs), the
    backward kernels [bwd(inputs, fwd_plain's outputs) -> tuple], their
    plain versions, bounds(rows, cols, d) of the forward and of each
    backward kernel). A forward's outputs end with the loss over the rows
    where it has one; each backward runs at the plain forward's
    statistics. Wrapper names: the forward's, then each backward's."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I
    from ntxent_tpu_torch.ops import ntxent as N

    t = NTX_TEMPERATURE

    def cuda_scale(x):
        return torch.tensor(x, dtype=torch.float32, device="cuda")

    def sym_in(dtype, rows, cols, d):
        return (_unit_rows(rows, d, dtype, seed=rows + d),)

    def sym_fwd(fwd):
        def run(x):
            loss, lse = fwd(x[0], t)
            return lse, loss / x[0].shape[0]
        return run

    def sym_bounds(rows, cols, d):
        zb = rows * d * 4
        return (_bound(zb + rows * 4 + 4, 2 * rows * rows * d,
                       PEAK_FP32_FLOPS),
                _bound(2 * zb + rows * 4, 4 * rows * rows * d,
                       PEAK_FP32_FLOPS))

    def general_in(infonce):
        def make(dtype, rows, cols, d):
            zr = _unit_rows(rows, d, dtype, seed=rows + d)
            zc = _unit_rows(cols, d, dtype, seed=cols + d + 1)
            if infonce:
                gid = cols - rows + torch.arange(rows, device="cuda")
                return (zr, zc, gid), dict(
                    diag_pos=True, scale=cuda_scale(WIDE_TWOPASS_SCALE))
            row_gid, col_gid, total, n_half = _general_ids(
                rows, cols, False, seed=rows)
            return (zr, zc, row_gid), dict(col_gid=col_gid,
                                           cols_actual=total, n_half=n_half)
        return make

    def general_t(kw):
        return 1.0 if kw.get("diag_pos") else t

    def general_fwd(fwd):
        def run(x):
            args, kw = x
            loss, lse = fwd(*args, general_t(kw), **kw)
            return lse, loss / args[0].shape[0]
        return run

    def general_bwd(*fns):
        def one(fn):
            def run(x, ref):
                args, kw = x
                return (fn(*args, ref[0], general_t(kw), **kw),)
            return run
        return [one(fn) for fn in fns]

    def general_bounds(rows, cols, d):
        fwd, g_rows, g_cols = _general_bounds(rows, cols, d)
        return fwd, g_rows, g_cols

    def pair_in(dtype, rows, cols, d):
        rid, cid, total = _pair_ids(rows, cols, 1, seed=rows)
        return (_unit_rows(rows, d, dtype, seed=rows + d),
                _unit_rows(cols, d, dtype, seed=cols + d + 3), rid, cid,
                total)

    def infonce_in(dtype, rows, cols, d):
        return (_unit_rows(rows, d, dtype, seed=rows + d),
                _unit_rows(rows, d, dtype, seed=rows + d + 1),
                cuda_scale(INFONCE_SCALE))

    def infonce_fwd(fwd):
        def run(x):
            loss, lse_a, lse_b = fwd(*x)
            return lse_a, lse_b, loss / x[0].shape[0]
        return run

    def infonce_bounds(rows, cols, d):
        zbytes = 2 * rows * d * 4
        return (_bound(zbytes + 4 + 2 * rows * 4 + 4, 2 * rows * rows * d,
                       PEAK_FP32_FLOPS),
                _bound(zbytes + 4 + 2 * rows * 4 + zbytes,
                       6 * rows * rows * d, PEAK_FP32_FLOPS))

    def dp_clip_in(dtype, rows, cols, d):
        return (_unit_rows(rows, d, dtype, seed=rows + d),
                _unit_rows(cols, d, dtype, seed=cols + d + 1),
                _dp_clip_ids(rows, cols, seed=rows),
                cuda_scale(DP_CLIP_SCALE))

    def dp_clip_bwd(*fns):
        def one(fn):
            def run(x, ref):
                za, zb, gid, scale = x
                return (fn(za, zb, gid, scale, *ref),)
            return run
        return [one(fn) for fn in fns]

    return [
        ("symmetric #1 + #5", ("ntxent_fwd", "ntxent_bwd_sym"), NTX_ATOL,
         sym_in, sym_fwd(N.ntxent_fwd), sym_fwd(N.ntxent_fwd_plain),
         [lambda x, ref: (N.ntxent_bwd_sym(x[0], ref[0], t),)],
         [lambda x, ref: (N.ntxent_bwd_sym_plain(x[0], ref[0], t),)],
         sym_bounds),
        ("general #1 + #6", ("ntxent_fwd_general", "ntxent_bwd_general_rows",
                             "ntxent_bwd_general_cols"), NTX_ATOL,
         general_in(False), general_fwd(N.ntxent_fwd_general),
         general_fwd(N.ntxent_fwd_general_plain),
         general_bwd(N.ntxent_bwd_general_rows, N.ntxent_bwd_general_cols),
         general_bwd(N.ntxent_bwd_general_rows_plain,
                     N.ntxent_bwd_general_cols_plain), general_bounds),
        ("InfoNCE-mode #1 + #6", (), _twopass_atol(WIDE_TWOPASS_SCALE),
         general_in(True), general_fwd(N.ntxent_fwd_general),
         general_fwd(N.ntxent_fwd_general_plain),
         general_bwd(N.ntxent_bwd_general_rows, N.ntxent_bwd_general_cols),
         general_bwd(N.ntxent_bwd_general_rows_plain,
                     N.ntxent_bwd_general_cols_plain), None),
        ("triangular #2 + #3", ("ntxent_fwd_tri", "ntxent_bwd_tri"),
         NTX_ATOL, sym_in, sym_fwd(N.ntxent_fwd_tri),
         sym_fwd(N.ntxent_fwd_tri_plain),
         [lambda x, ref: (N.ntxent_bwd_tri(x[0], ref[0], t),)],
         [lambda x, ref: (N.ntxent_bwd_tri_plain(x[0], ref[0], t),)],
         lambda rows, cols, d: _tri_bounds(rows, d, 4)),
        ("pair #7 + #8", ("block_lse_dual", "block_grads_dual"), NTX_ATOL,
         pair_in, lambda x: N.block_lse_dual(*x[:4], t, x[4]),
         lambda x: N.block_lse_dual_plain(*x[:4], t, x[4]),
         [lambda x, ref: N.block_grads_dual(*x[:4], *ref, t, x[4])],
         [lambda x, ref: N.block_grads_dual_plain(*x[:4], *ref, t, x[4])],
         lambda rows, cols, d: _pair_bounds(rows, cols, d, 4)),
        ("square InfoNCE #9 + #10", ("infonce_dual_fwd", "infonce_dual_bwd"),
         INFONCE_ATOL, infonce_in, infonce_fwd(I.infonce_dual_fwd),
         infonce_fwd(I.infonce_dual_fwd_plain),
         [lambda x, ref: I.infonce_dual_bwd(*x, *ref[:2])],
         [lambda x, ref: I.infonce_dual_bwd_plain(*x, *ref[:2])],
         infonce_bounds),
        ("data-parallel CLIP #9 rect + #5 cross-modal + #4",
         ("infonce_dual_fwd_rect", "infonce_bwd_rows", "infonce_bwd_cols"),
         INFONCE_ATOL, dp_clip_in,
         lambda x: I.infonce_dual_fwd_rect(x[0], x[1], x[3]),
         lambda x: I.infonce_dual_fwd_rect_plain(x[0], x[1], x[3]),
         dp_clip_bwd(I.infonce_bwd_rows, I.infonce_bwd_cols),
         dp_clip_bwd(I.infonce_bwd_rows_plain, I.infonce_bwd_cols_plain),
         lambda rows, cols, d: _dp_clip_bounds(rows, cols, d, 4)),
    ]


def _tf32_inputs(x):
    """The inputs with every fp32 embedding rounded to TF32 once (ids,
    scales and keyword arguments unchanged)."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N

    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict):
        return (_tf32_inputs(x[0]), x[1])
    return tuple(N.tf32_split(v)[0] if isinstance(v, torch.Tensor)
                 and v.dtype == torch.float32 and v.dim() == 2 else v
                 for v in x)


def _max_err(got, want) -> float:
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


def phase_wide_d() -> dict:
    """Every loss kernel at D = 768, 1000 and 1024 (WIDE_DIMS) against its
    plain version, fp32 and bf16, small and large shapes, bitwise
    repeatable, the fp32 TF32 control; fp32 times at WIDE_LARGE beside the
    bound. Returns each wrapper's wide-D fields for the kernels line."""
    import torch

    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t0 = time.monotonic()
    fields = {}
    large_rows, large_d = WIDE_LARGE
    for (label, names, atol, make, fwd, fwd_plain, bwds, bwds_plain,
         bounds) in _wide_families():

        def bwd(x, ref, fns):
            return tuple(out for fn in fns for out in fn(x, ref))

        dp_clip = names and names[0] == "infonce_dual_fwd_rect"
        shapes = [((*WIDE_DP_CLIP_SMALL, d) if dp_clip
                   else (WIDE_SMALL, WIDE_SMALL, d)) for d in WIDE_DIMS]
        shapes.append((large_rows, large_rows, large_d))
        worst = 0.0
        for rows, cols, d in shapes:
            for dtype in ("float32", "bfloat16"):
                x = make(dtype, rows, cols, d)
                ref_f = fwd_plain(x)
                ref_b = bwd(x, ref_f, bwds_plain)
                got_f, got_b = fwd(x), bwd(x, ref_f, bwds)
                again_f, again_b = fwd(x), bwd(x, ref_f, bwds)
                torch.cuda.synchronize()
                fwd_err, bwd_err = _max_err(got_f, ref_f), _max_err(got_b,
                                                                    ref_b)
                repeat = all(torch.equal(a, b) for a, b in zip(
                    (*got_f, *got_b), (*again_f, *again_b)))
                ok = max(fwd_err, bwd_err) <= atol and repeat
                control = ""
                if dtype == "float32":
                    xc = _tf32_inputs(x)
                    ctl = (_max_err(fwd_plain(xc), ref_f),
                           _max_err(bwd(xc, ref_f, bwds_plain), ref_b))
                    ulps = WIDE_LSE_ULPS * float(np.spacing(np.float32(max(
                        v.abs().max().item() for v in ref_f))))
                    ok = ok and (TF32_CONTROL_FACTOR * fwd_err <= ctl[0]
                                 or fwd_err <= ulps) \
                        and TF32_CONTROL_FACTOR * bwd_err <= ctl[1]
                    control = (f"; one TF32 pass {ctl[0]:.3e} / {ctl[1]:.3e}"
                               f" (at least {TF32_CONTROL_FACTOR}x, or fwd "
                               f"within {ulps:.2e} = {WIDE_LSE_ULPS} ulps)")
                    worst = max(worst, fwd_err, bwd_err)
                print(f"[wide-d] {label} R={rows} C={cols} D={d} {dtype}: "
                      f"fwd max|err| {fwd_err:.3e}, bwd {bwd_err:.3e} (atol "
                      f"{atol:g}){control}; bitwise repeatable {repeat} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"the {label} kernels disagree with their plain "
                         f"versions at R={rows} C={cols} D={d} {dtype}")
                del x, ref_f, ref_b, got_f, got_b, again_f, again_b
            torch.cuda.empty_cache()
        if bounds is None:
            continue
        x = make("float32", large_rows, large_rows, large_d)
        ref_f = fwd_plain(x)
        calls = [(fwd, fwd_plain)] + [
            (functools.partial(fn, ref=ref_f),
             functools.partial(plain, ref=ref_f))
            for fn, plain in zip(bwds, bwds_plain)]
        bnds = bounds(large_rows, large_rows, large_d)
        for name, (fn, plain), bound in zip(names, calls, bnds):
            ms = cuda_time_ms(lambda: fn(x), 10)
            plain_ms = cuda_time_ms(lambda: plain(x), 3)
            print(f"[wide-d] {name} fp32 R=C={large_rows} D={large_d}: "
                  f"{ms:.4f} ms (plain {plain_ms:.4f}, bound {bound[0]:.5f} "
                  f"by {bound[1]}); no single PyTorch call computes it, so "
                  f"there is no library time", flush=True)
            fields[name] = {"wide_d1024_ms": ms,
                            "wide_d1024_plain_ms": plain_ms,
                            "wide_d1024_bound_ms": bound[0],
                            "wide_max_abs_err": worst}
        del x, ref_f
        torch.cuda.empty_cache()
    print(f"[wide-d] phase {time.monotonic() - t0:.1f} s", flush=True)
    return fields


def phase_wide_train(card_line: str) -> dict:
    """``train --proj-dim 1024`` at TRAIN_ARGV's width for WIDE_TRAIN_STEPS
    steps: finite losses, the symmetric #1 and #5 once a step at D =
    1024. Returns the launches."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    argv = _with_flags(TRAIN_ARGV, "--steps", str(WIDE_TRAIN_STEPS),
                       "--proj-dim", str(WIDE_PROJ_DIM))
    args = cli.build_train_parser().parse_args(argv)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    state, history = cli.train(args)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in counters.items()}
    losses = [h["loss"] for h in history]
    if len(losses) != WIDE_TRAIN_STEPS or not all(map(math.isfinite,
                                                       losses)):
        fail(f"train --proj-dim {WIDE_PROJ_DIM} losses {losses}")
    want = {n: STEP_LAUNCHES.get(n, 0) * WIDE_TRAIN_STEPS for n in counters}
    if launches != want:
        fail(f"train --proj-dim {WIDE_PROJ_DIM} launches {launches}, "
             f"expected {want}")
    print(f"[wide-train] ViT-B/16 flash, batch {args.batch}, --proj-dim "
          f"{WIDE_PROJ_DIM}: {WIDE_TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}, launches per step "
          f"{ {n: c // WIDE_TRAIN_STEPS for n, c in launches.items() if c} } "
          f"in {time.monotonic() - t0:.1f} s on {card_line}", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


def _with_flags(argv: list, *pairs: str) -> list:
    """``argv`` with each ``--flag value`` of ``pairs`` set (replaced where
    the flag is there, appended where it is not)."""
    out = list(argv)
    for flag, value in zip(pairs[::2], pairs[1::2]):
        if flag in out:
            out[out.index(flag) + 1] = value
        else:
            out += [flag, value]
    return out


def _manifest_crcs(directory) -> dict:
    """{step: [size, crc32] of state.msgpack} from a checkpoint
    directory's manifests.json."""
    from pathlib import Path

    manifests = json.loads((Path(directory) / "manifests.json").read_text())
    return {int(step): entry["files"]["state.msgpack"]
            for step, entry in manifests.items()}


def _ckpt_argv(argv, directory, steps, every=RESUME_EVERY,
               keep=RESUME_KEEP) -> list:
    return _with_flags(argv, "--steps", str(steps), "--ckpt-dir",
                       str(directory), "--ckpt-every", str(every),
                       "--ckpt-keep-last", str(keep))


def _train_ckpt(argv, data_parallel=None):
    """cli.train on ``argv``; returns (state, history, checkpoint stats),
    the losses checked finite."""
    import math

    from ntxent_tpu_torch import cli

    stats = {}
    state, history = cli.train(cli.build_train_parser().parse_args(argv),
                               data_parallel, checkpoint_stats=stats)
    if not all(math.isfinite(h["loss"]) for h in history):
        fail(f"non-finite losses {[h['loss'] for h in history]}")
    return state, history, stats


def _same_crc(label: str, want: dict, got: dict, steps) -> None:
    for step in steps:
        if step not in want or step not in got or want[step] != got[step]:
            fail(f"{label}: state.msgpack of step {step} is "
                 f"{got.get(step)} (size, crc32), the uninterrupted run's "
                 f"{want.get(step)}")


def _ms(values) -> str:
    return "/".join(f"{v:.1f}" for v in values) or "none"


def phase_resume(tmp: str, card_line: str):
    """SimCLR ViT-B/16 at batch 256: run A (RESUME_STEPS steps, a save
    every RESUME_EVERY) against run B (RESUME_FIRST steps with async
    saves, relaunched to RESUME_STEPS), CRC for CRC at steps 4 and 6.
    Returns A's directory and final state."""
    t0 = time.monotonic()
    dir_a, dir_b = f"{tmp}/resume_a", f"{tmp}/resume_b"
    state_a, hist_a, stats_a = _train_ckpt(_ckpt_argv(TRAIN_ARGV, dir_a,
                                                      RESUME_STEPS))
    if [h["step"] for h in hist_a] != list(range(1, RESUME_STEPS + 1)):
        fail(f"run A logged steps {[h['step'] for h in hist_a]}")
    _, _, stats_b1 = _train_ckpt(_ckpt_argv(
        TRAIN_ARGV, dir_b, RESUME_FIRST) + ["--async-ckpt"])
    _, hist_b, stats_b2 = _train_ckpt(_ckpt_argv(
        TRAIN_ARGV, dir_b, RESUME_STEPS) + ["--async-ckpt"])
    if [h["step"] for h in hist_b] != list(range(RESUME_FIRST + 1,
                                                 RESUME_STEPS + 1)):
        fail(f"the relaunch logged steps {[h['step'] for h in hist_b]}")
    crc_a = _manifest_crcs(dir_a)
    _same_crc("resumed SimCLR run", crc_a, _manifest_crcs(dir_b),
              (4, RESUME_STEPS))
    print(f"[resume] ViT-B/16 SimCLR batch 256: run A {RESUME_STEPS} steps "
          f"(saves every {RESUME_EVERY}), run B {RESUME_FIRST} steps "
          f"--async-ckpt + relaunch to {RESUME_STEPS}: steps 4 and "
          f"{RESUME_STEPS} equal by (size, crc32) {crc_a[RESUME_STEPS]}; "
          f"state {stats_a['state_bytes']} bytes; sync save ms "
          f"{_ms(stats_a['save_ms'])}; async blocked ms "
          f"{_ms(stats_b1['blocked_ms'] + stats_b2['blocked_ms'])} (writer "
          f"save ms {_ms(stats_b1['save_ms'] + stats_b2['save_ms'])}); "
          f"restore ms {_ms(stats_b2['restore_ms'])}; on {card_line}; "
          f"phase {time.monotonic() - t0:.1f} s", flush=True)
    return dir_a, state_a, crc_a


def phase_preempt(tmp: str, crc_a: dict) -> None:
    """The CLI as a child, SIGTERM after its step-PREEMPT_AFTER line: exit
    0 with the stopped step the newest valid one; a relaunch ends at run
    A's step-6 CRC."""
    import os
    import re
    import signal
    import subprocess
    from pathlib import Path

    from ntxent_tpu_torch.training import CheckpointManager

    t0 = time.monotonic()
    directory = f"{tmp}/preempt"
    cmd = [sys.executable, "-m", "ntxent_tpu_torch.cli", "train",
           *_ckpt_argv(TRAIN_ARGV, directory, RESUME_STEPS), "--async-ckpt"]
    root = str(Path(__file__).resolve().parent)

    def child(stop_after: int | None) -> tuple[int, list]:
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=dict(os.environ))
        lines, sent = [], False
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        try:
            for line in proc.stdout:
                lines.append(line.rstrip())
                if stop_after is not None and not sent and re.search(
                        rf"\bstep {stop_after} loss ", line):
                    proc.send_signal(signal.SIGTERM)
                    sent = True
                if time.monotonic() > deadline:
                    break
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if stop_after is not None and not sent:
            fail(f"the child never logged step {stop_after}: "
                 f"{lines[-5:]}")
        return rc, lines

    rc, lines = child(PREEMPT_AFTER)
    saved = [int(m.group(1)) for line in lines for m in [re.search(
        r"run was preempted; checkpoint saved at step (\d+)", line)] if m]
    if rc != 0 or len(saved) != 1:
        fail(f"the preempted child exited {rc} with {saved} preemption "
             f"lines; its last lines {lines[-8:]}")
    newest = CheckpointManager(directory).latest_valid_step()
    if newest != saved[0]:
        fail(f"the preempted child stopped at step {saved[0]} but the "
             f"newest valid step is {newest}")
    t_stop = time.monotonic() - t0
    rc, lines = child(None)
    if rc != 0:
        fail(f"the relaunched child exited {rc}: {lines[-8:]}")
    _same_crc("preempted and relaunched run", crc_a,
              _manifest_crcs(directory), (RESUME_STEPS,))
    print(f"[preempt] SIGTERM after the child's step {PREEMPT_AFTER} line: "
          f"exit 0, stopped and saved at step {saved[0]} (the newest valid "
          f"step) in {t_stop:.1f} s; the relaunch resumed it to step "
          f"{RESUME_STEPS}, equal to run A's by crc32; phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def phase_resume_pair(tmp: str, argv, label: str,
                      data_parallel=None) -> str:
    """PAIR_FIRST + 1 steps against PAIR_STEPS uninterrupted, CRC for CRC
    at the last step; returns the uninterrupted run's directory."""
    t0 = time.monotonic()
    whole, parts = f"{tmp}/{label}_whole", f"{tmp}/{label}_parts"
    _, _, stats_w = _train_ckpt(_ckpt_argv(argv, whole, PAIR_STEPS,
                                           every=PAIR_STEPS, keep=1),
                                data_parallel)
    _train_ckpt(_ckpt_argv(argv, parts, PAIR_FIRST, every=PAIR_STEPS,
                           keep=1), data_parallel)
    _, _, stats_r = _train_ckpt(_ckpt_argv(argv, parts, PAIR_STEPS,
                                           every=PAIR_STEPS, keep=1),
                                data_parallel)
    want = _manifest_crcs(whole)
    _same_crc(f"resumed {label} run", want, _manifest_crcs(parts),
              (PAIR_STEPS,))
    print(f"[resume-{label}] {PAIR_FIRST} + 1 steps equal {PAIR_STEPS} "
          f"uninterrupted by (size, crc32) {want[PAIR_STEPS]}; save ms "
          f"{_ms(stats_w['save_ms'])}, restore ms "
          f"{_ms(stats_r['restore_ms'])}; phase {time.monotonic() - t0:.1f} "
          f"s", flush=True)
    shutil.rmtree(parts)
    return whole


def phase_serve_ckpt(directory: str, state) -> None:
    """``build_server`` with ``--ckpt-dir`` at run A's directory embeds a
    fixed batch as run A's final model does in eval mode."""
    import torch

    from ntxent_tpu_torch import cli

    t0 = time.monotonic()
    args = cli.build_serve_parser().parse_args(
        _with_flags(SERVE_ARGV, "--ckpt-dir", directory) + ["--no-warmup"])
    server = cli.build_server(args)
    try:
        x = np.random.default_rng(7).uniform(
            -1, 1, (16, 224, 224, 3)).astype(np.float32)
        got = server.engine.embed(x)
        model = state.model.eval()
        with torch.inference_mode():
            want = model(torch.from_numpy(x).cuda()).float().cpu().numpy()
        err = _check_embeddings("serve --ckpt-dir", got, want)
    finally:
        server.close()
    print(f"[serve-ckpt] build_server --ckpt-dir at run A's step "
          f"{RESUME_STEPS}: 16 embeddings max|err| {err:.2e} against the "
          f"trained model in eval mode (atol {EMBED_ATOL:g}); phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def _post_full(url, body: bytes, rid: str):
    """(status, headers, JSON payload) of a POST."""
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get_text(url) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _flash_launches():
    from ntxent_tpu_torch.ops import attention

    return attention.flash_attention_fwd


@contextlib.contextmanager
def _uncounted(wrapper):
    """A reference forward between served requests: the wrapper's count
    is what it was before, so it holds the serve path's launches only."""
    saved = wrapper.launches
    try:
        yield
    finally:
        wrapper.launches = saved


def _cosine_drift(a, b) -> float:
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    return float((1.0 - cos).max())


def phase_serve_int8(card_line: str) -> int:
    """The float32 and the int8 rung of the same weights; returns the
    int8 rung's #11 launches."""
    from ntxent_tpu_torch import cli

    t0 = time.monotonic()
    flash = _flash_launches()
    servers = {}
    try:
        for dtype in ("float32", "int8"):
            servers[dtype] = cli.build_server(cli.build_serve_parser()
                                              .parse_args(_with_flags(
                                                  SERVE_ARGV, "--dtype",
                                                  dtype)))
        x = np.random.default_rng(19).uniform(
            -1, 1, (INT8_ROWS, SERVE_IMAGE, SERVE_IMAGE, 3)).astype(np.float32)
        out, launches, stats = {}, {}, {}
        for dtype, server in servers.items():
            engine = server.engine
            depth = len(engine.model.backbone.blocks)
            flash.launches = 0
            out[dtype] = engine.embed(x)
            chunks = engine.metrics.device_calls
            launches[dtype] = flash.launches
            if launches[dtype] != depth * chunks:
                fail(f"serve-int8 {dtype}: flash_attention_fwd launched "
                     f"{launches[dtype]} times over {chunks} chunks; "
                     f"expected {depth} a chunk")
            device = engine.metrics.to_dict()["latency_ms"]["device"]
            stats[dtype] = (engine.h2d_bytes // chunks, chunks,
                            device["p50_ms"], device["mean_ms"])
        quantize_ms = []
        for _ in range(5):  # the host half of the int8 rung, a 64-row chunk
            t = time.perf_counter()
            servers["int8"].engine._quantize_host(x[:64])
            quantize_ms.append((time.perf_counter() - t) * 1e3)
        f32, q8 = out["float32"], out["int8"]
        norm_err = float(np.abs(np.linalg.norm(q8, axis=1) - 1.0).max())
        drift = _cosine_drift(f32, q8)
        if not np.all(np.isfinite(q8)) or norm_err > 1e-3 \
                or drift >= INT8_DRIFT_MAX:
            fail(f"serve-int8: drift {drift:.3e} (bar {INT8_DRIFT_MAX}), "
                 f"|norm-1| {norm_err:.2e}")
        (b32, c32, p32, m32), (b8, c8, p8, m8) = stats["float32"], \
            stats["int8"]
        print(f"[serve-int8] ViT-B/16 {INT8_ROWS} rows, buckets 1/4/16/64: "
              f"int8 against float32 rung, largest per-row cosine distance "
              f"{drift:.3e} (bar {INT8_DRIFT_MAX}); flash_attention_fwd "
              f"{launches['int8']} launches over {c8} int8 chunks (12 a "
              f"chunk); host-to-device bytes a 64-row chunk float32 {b32}, "
              f"int8 {b8} ({b32 / b8:.2f}x less); chunk ms at bucket 64 "
              f"(host clock around copy in, forward, copy out) float32 p50 "
              f"{p32:.3f} / mean {m32:.3f} over {c32}, int8 p50 {p8:.3f} / "
              f"mean {m8:.3f} over {c8}; host quantization of a 64-row "
              f"chunk (outside that window) {_ms(quantize_ms)} ms; on "
              f"{card_line}; phase "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        return launches["int8"]
    finally:
        for server in servers.values():
            server.close()


def _ladder_sizes(rng, n: int) -> list[int]:
    return [int(rng.integers(*LADDER_SIZES[i % 2])) for i in range(n)]


def phase_serve_ladder(card_line: str) -> int:
    """--adaptive-buckets: skewed traffic, a refresh while clients are in
    flight; returns #11's launches over the phase."""
    import torch

    from ntxent_tpu_torch import cli

    t0 = time.monotonic()
    flash = _flash_launches()
    flash.launches = 0
    server = cli.build_server(cli.build_serve_parser().parse_args(
        SERVE_ARGV + LADDER_FLAGS)).start()
    engine = server.engine
    url = f"http://127.0.0.1:{server.port}"
    depth = len(engine.model.backbone.blocks)
    rng = np.random.default_rng(23)
    prior = engine.buckets
    try:
        compiles0 = engine.metrics.compiles
        results, errors = [], []

        def submit(x):
            try:
                results.append((x, server.batcher.submit(x, timeout_s=120)))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{len(x)} rows: {type(e).__name__}: {e}")

        def round_of(sizes, threads=2):
            xs = [rng.uniform(-1, 1, (n, SERVE_IMAGE, SERVE_IMAGE, 3)).astype(np.float32)
                  for n in sizes]  # drawn here: a Generator is one thread's
            ths = [threading.Thread(target=lambda c=c: [submit(x)
                                                        for x in c])
                   for c in (xs[i::threads] for i in range(threads))]
            for th in ths:
                th.start()
            return ths

        def padding(before):
            m = engine.metrics
            real = m.rows_real - before[0]
            padded = m.rows_padded - before[1]
            return padded / (real + padded)

        marks = (engine.metrics.rows_real, engine.metrics.rows_padded)
        for th in round_of(_ladder_sizes(rng, LADDER_REQUESTS)):
            th.join(600)
        waste_before = padding(marks)
        # across the swap: batcher clients and HTTP clients in flight
        http = []

        def http_client(x, body):
            status, _, payload = _post_full(f"{url}/embed", body,
                                            f"ladder-{len(x)}")
            http.append((x.astype(np.float32), status, payload))

        http_xs = [rng.uniform(-1, 1, (n, SERVE_IMAGE, SERVE_IMAGE, 3)).round(3)
                   for n in (5, 7, 9)]
        flying = round_of(_ladder_sizes(rng, LADDER_REQUESTS), threads=3)
        flying += [threading.Thread(target=http_client, args=(x, json.dumps(
            {"inputs": x.tolist(), "timeout_ms": 120000}).encode()))
            for x in http_xs]
        for th in flying[3:]:
            th.start()
        t_swap = time.monotonic()
        swapped = engine.refresh_ladder()
        swap_ms = (time.monotonic() - t_swap) * 1e3
        for th in flying:
            th.join(600)
        learned = engine.buckets
        marks = (engine.metrics.rows_real, engine.metrics.rows_padded)
        for th in round_of(_ladder_sizes(rng, LADDER_REQUESTS)):
            th.join(600)
        waste_after = padding(marks)
        if errors or not swapped or any(s != 200 for _, s, _ in http):
            fail(f"serve-ladder: swapped {swapped}, errors {errors}, HTTP "
                 f"{[s for _, s, _ in http]}")
        m = engine.metrics
        # the served path's own launches, read before any direct forward
        launches = flash.launches
        chunks, first_runs = m.device_calls, m.compiles + m.ladder_compiles
        worst = 0.0
        with torch.inference_mode(), _uncounted(flash):
            for x, got in results + [(x, np.asarray(p["embeddings"]))
                                     for x, _, p in http]:
                want = engine.model(torch.from_numpy(x).to(
                    engine.device)).float().cpu().numpy()
                worst = max(worst, _check_embeddings("serve-ladder", got,
                                                     want))
        if m.compiles != compiles0 or waste_after >= waste_before \
                or launches != depth * (chunks + first_runs):
            fail(f"serve-ladder: request-path first runs {compiles0} -> "
                 f"{m.compiles}, padding {waste_before:.4f} -> "
                 f"{waste_after:.4f}, launches {launches} over "
                 f"{chunks} chunks + {first_runs} first runs")
        print(f"[serve-ladder] ViT-B/16 --adaptive-buckets: "
              f"{len(results)} batcher requests and {len(http)} HTTP "
              f"requests of {LADDER_SIZES[0][0]}-{LADDER_SIZES[0][1] - 1} "
              f"and {LADDER_SIZES[1][0]}-{LADDER_SIZES[1][1] - 1} rows, all "
              f"answered, max|err| vs the direct forward {worst:.3e}; "
              f"ladder {list(prior)} -> {list(learned)} by a "
              f"refresh_ladder() with clients in flight ({swap_ms:.1f} ms, "
              f"{m.ladder_compiles} background first runs); request-path "
              f"first runs {compiles0} before, {m.compiles} after; padding "
              f"share {waste_before:.4f} before, {waste_after:.4f} after; "
              f"flash_attention_fwd {launches} launches = {depth} x "
              f"({chunks} chunks + {first_runs} first runs); on "
              f"{card_line}; phase "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        return launches
    finally:
        server.close()


def _step_model(directory: str, step: int):
    """The served ViT-B/16 with ``step``'s params on the card, eval mode."""
    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import CheckpointManager

    model = cli.build_model(cli.build_serve_parser().parse_args(SERVE_ARGV))
    CheckpointManager(directory).restore_variables(model, step=step)
    return model.to(SMOKE_DEVICE).eval()


def _worker_spans(path: str, rids: list) -> int:
    """The four span kinds of every request id in ``rids``, and the
    trace the JSONL exports; returns its event count."""
    from ntxent_tpu_torch.obs import events, trace

    spans = events.read_events(path, "span")
    by_name = {}
    for r in spans:
        by_name.setdefault(r["name"], []).append(r)
    batches = {}
    for r in by_name.get("serve.batch", []):
        for rid in r.get("request_ids", []):
            batches.setdefault(rid, []).append(r["span_id"])
    chunk_parents = {r.get("parent_id") for r in
                     by_name.get("serve.device_chunk", [])}
    for rid in rids:
        kinds = {r["name"] for r in spans if r.get("request_id") == rid}
        if not {"serve.request", "serve.queue_wait"} <= kinds \
                or not batches.get(rid) \
                or not set(batches[rid]) & chunk_parents:
            fail(f"serve-worker: request {rid} has spans {sorted(kinds)}, "
                 f"batches {batches.get(rid)}")
    n = trace.validate_chrome_trace(trace.export_chrome_trace(path))
    if n < 2 * len(rids):  # coalesced requests share batch and chunk
        fail(f"serve-worker: the trace holds {n} events for {len(rids)} "
             "requests")
    return n


def phase_serve_worker(tmp: str, dir_a: str, card_line: str) -> int:
    """The serve entry point as a fleet worker on run A's steps; returns
    #11's launches over the phase."""
    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.serving import engine as serving_engine
    from ntxent_tpu_torch.training import CheckpointManager

    t0 = time.monotonic()
    first, newer = sorted(CheckpointManager(dir_a).all_steps())[-2:]
    watch, port_file = f"{tmp}/watch", f"{tmp}/serve.port"
    jsonl = f"{tmp}/serve.jsonl"
    os.makedirs(watch)
    shutil.copy(f"{dir_a}/manifests.json", watch)

    def publish(step):  # atomically: the watcher never sees half a step
        shutil.copytree(f"{dir_a}/{step}", f"{watch}/.copy-{step}")
        os.rename(f"{watch}/.copy-{step}", f"{watch}/{step}")

    publish(first)
    argv = _with_flags(SERVE_ARGV, "--max-delay-ms", "5") + WORKER_FLAGS + [
        "--ckpt-dir", watch, "--port-file", port_file, "--log-jsonl", jsonl]
    flash = _flash_launches()
    flash.launches = 0
    captured, rc = {}, []
    probed = threading.Event()
    real_build, real_warmup = cli.build_server, \
        serving_engine.InferenceEngine.warmup

    def build(args):
        captured["server"] = server = real_build(args)
        return server

    def held_warmup(self):  # the boot probe sees the cold ladder first
        probed.wait(300)
        real_warmup(self)

    cli.build_server = build
    serving_engine.InferenceEngine.warmup = held_warmup
    loop = threading.Thread(target=lambda: rc.append(cli.serve_main(argv)),
                            name="serve-main")
    loop.start()
    server = None
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(port_file):
            if time.monotonic() > deadline or not loop.is_alive():
                fail("serve-worker: no port file")
            time.sleep(0.05)
        url = f"http://127.0.0.1:{int(open(port_file).read())}"
        ready_cold, cold = _get(f"{url}/readyz")
        x = np.random.default_rng(29).uniform(
            -1, 1, (4, SERVE_IMAGE, SERVE_IMAGE, 3)).round(3).astype(np.float32)
        body = json.dumps({"inputs": x.tolist(),
                           "timeout_ms": 120000}).encode()
        embed_cold, cold_headers, _ = _post_full(f"{url}/embed", body, "c0")
        probed.set()
        t_warm = time.monotonic()
        while _get(f"{url}/readyz")[0] != 200:
            if time.monotonic() - t_warm > 300:
                fail("serve-worker: /readyz never turned 200")
            time.sleep(0.05)
        warm_s = time.monotonic() - t_warm
        if ready_cold != 503 or cold.get("status") != "warming" \
                or embed_cold != 503 or "Retry-After" not in cold_headers:
            fail(f"serve-worker: while warming /readyz {ready_cold} {cold}, "
                 f"/embed {embed_cold}")
        while "server" not in captured or captured["server"]._watchdog \
                is None or captured["server"].batcher is None:
            time.sleep(0.01)  # the supervised attempt serves
        server = captured["server"]
        engine, watcher = server.engine, server.reloader
        rids, lat = [], []

        def embed(rid, payload=body):
            t = time.monotonic()
            status, headers, out = _post_full(f"{url}/embed", payload, rid)
            lat.append((time.monotonic() - t) * 1e3)
            if status == 200:
                rids.append(rid)
            return status, headers, out

        def check(label, step, want_model):
            status, headers, out = embed(f"step-{label}")
            if status != 200 or headers.get("X-Checkpoint-Step") \
                    != str(step):
                fail(f"serve-worker {label}: HTTP {status}, "
                     f"X-Checkpoint-Step {headers.get('X-Checkpoint-Step')}"
                     f", expected {step}")
            with torch.inference_mode(), _uncounted(flash):
                want = want_model(torch.from_numpy(x).to(SMOKE_DEVICE)).float() \
                    .cpu().numpy()
            return _check_embeddings(f"serve-worker {label}",
                                     out["embeddings"], want)

        model_first, model_newer = _step_model(dir_a, first), \
            _step_model(dir_a, newer)
        err = check("boot", first, model_first)
        publish(newer)
        t_seen = time.monotonic()
        while json.loads(_get_text(f"{url}/healthz")[1])[
                "checkpoint_step"] != newer:
            if time.monotonic() - t_seen > 120:
                fail(f"serve-worker: step {newer} never adopted")
            time.sleep(0.05)
        adopt_s = time.monotonic() - t_seen
        err = max(err, check("adopted", newer, model_newer))
        status, _, rolled = _post_full(f"{url}/rollback", json.dumps(
            {"step": newer}).encode(), "rb")
        if status != 200 or rolled != {"rolled_back": True,
                                       "checkpoint_step": first,
                                       "blocked_steps": [newer]}:
            fail(f"serve-worker: /rollback {status} {rolled}")
        err = max(err, check("rolled-back", first, model_first))
        time.sleep(1.0)  # two polls: the blocked step stays out
        if watcher.current_step != first:
            fail(f"serve-worker: the blocked step {newer} came back")
        del model_first, model_newer
        torch.cuda.empty_cache()

        # a forward held past --stall-timeout inside the engine's launch,
        # under its forward lock, as a wedged device call holds it
        real_launch = engine._launch
        hold = {"armed": True}

        def held(exe, args):
            if hold.pop("armed", False):
                time.sleep(STALL_HOLD_S)
            return real_launch(exe, args)

        engine._launch = held
        held_result = []
        t_hold = time.monotonic()
        holder = threading.Thread(target=lambda: held_result.append(
            embed("held")))
        holder.start()
        seen, t_stalled, t_back = [], None, None
        while time.monotonic() - t_hold < 120:
            status = json.loads(_get_text(f"{url}/healthz")[1])["status"]
            if not seen or seen[-1] != status:
                seen.append(status)
            if status == "stalled" and t_stalled is None:
                t_stalled = time.monotonic()
            if t_stalled is not None and status == "serving":
                t_back = time.monotonic()
                break
            time.sleep(0.02)
        after, _, _ = embed("after-restart")
        holder.join(120)
        engine._launch = real_launch
        if t_back is None or after != 200:
            fail(f"serve-worker: /healthz went {seen}; the next request "
                 f"answered {after}")
        restart_ms = (t_back - t_stalled) * 1e3

        # latency: concurrent clients after the restart
        bodies = [(f"lat-{i}", json.dumps({"inputs": np.random.default_rng(
            i).uniform(-1, 1, (WORKER_ROWS[i % 4], SERVE_IMAGE, SERVE_IMAGE,
                3)).round(
                3).tolist(), "timeout_ms": 120000}).encode())
            for i in range(16)]
        lat.clear()
        ths = [threading.Thread(target=lambda c=c: [embed(r, b)
                                                    for r, b in c])
               for c in (bodies[i::4] for i in range(4))]
        t_round = time.monotonic()
        for th in ths:
            th.start()
        for th in ths:
            th.join(600)
        round_s = time.monotonic() - t_round
        ordered = sorted(lat)
        rows = sum(WORKER_ROWS[i % 4] for i in range(16))
        code, prom = _get_text(f"{url}/metrics?format=prometheus")
        if code != 200 or 'serving_run_info{run_id="smoke"} 1' not in prom:
            fail("serve-worker: no serving_run_info{run_id=\"smoke\"} in "
                 "the Prometheus text")
        m = engine.metrics
        launches, chunks, first_runs = flash.launches, m.device_calls, \
            m.compiles + m.ladder_compiles
        if launches != 12 * (chunks + first_runs):
            fail(f"serve-worker: flash_attention_fwd {launches} launches "
                 f"over {chunks} chunks and {first_runs} first runs")
    finally:
        cli.build_server = real_build
        serving_engine.InferenceEngine.warmup = real_warmup
        probed.set()
        if server is not None:
            server.shutdown()
        loop.join(120)
        shutil.rmtree(watch, ignore_errors=True)
    if rc != [0]:
        fail(f"serve-worker: serve_main returned {rc}")
    n_events = _worker_spans(jsonl, rids)
    print(f"[serve-worker] serve_main --port-file --watch-ckpt (run A's "
          f"step {first}) --max-restarts 1 --stall-timeout "
          f"{STALL_TIMEOUT_S:g} --log-jsonl --run-id smoke: /readyz 503 "
          f"'warming' and /embed 503 + Retry-After until warm ({warm_s:.1f} "
          f"s), then 200; step {newer} adopted {adopt_s * 1e3:.0f} ms after "
          f"it landed (watcher swap ms {_ms(watcher.swap_ms)}); "
          f"X-Checkpoint-Step and embeddings followed {first} -> {newer} -> "
          f"{first} (POST /rollback, {newer} blocked), max|err| {err:.2e} "
          f"vs each step's direct forward; a device call held "
          f"{STALL_HOLD_S:g} s: /healthz {' -> '.join(seen)}, restart "
          f"{restart_ms:.0f} ms after 'stalled', next request 200 (held "
          f"request {held_result[0][0] if held_result else 'lost'}); "
          f"latency over 16 concurrent requests of 1-8 rows p50 "
          f"{ordered[len(ordered) // 2]:.1f} ms, p99 "
          f"{ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]:.1f}"
          f" ms, {rows / round_s:.1f} rows/s over HTTP with JSON bodies "
          f"(client clock); spans serve.request/queue_wait/batch/device_chunk for "
          f"all {len(rids)} answered requests, Chrome trace of {n_events} "
          f"events valid; flash_attention_fwd {launches} launches = 12 x "
          f"({chunks} chunks + {first_runs} first runs); on {card_line}; "
          f"phase {time.monotonic() - t0:.1f} s", flush=True)
    return launches


# [fleet] (ROADMAP Queue A 12(a)): the router process ``python -m
# ntxent_tpu_torch.fleet_cli`` over FLEET_WORKERS of the port's serve at
# SERVE_ARGV's width, on a watched copy of run A's steps, with the shadow
# mirror, federation, SLOs, history, the autoscaler and a chaos plan.
# Three workers start, one above --max-workers, so that both chaos
# actions land before the rollout and no supervision tick races a
# verdict: killworker SIGKILLs w0 (it restarts) and drainworker drains w2
# (zero in flight, then SIGTERM) down to the ceiling, where no scale-up
# follows; w0 and w1 carry the rollout. The idle scale-down is off: the
# drain is the pool's only one. The router parses every 224 px body (about
# 0.3 s of host time a row), so a canary needs tens of seconds to gather
# FLEET_CANARY outcomes: w1 adopts a new step FLEET_STAGGER_S after w0,
# long after the verdict. --eject-after is raised because a worker busy
# in a 26 MB json.loads answers no /readyz probe for seconds (the probe's
# timeout is 2 s).
FLEET_WORKERS = 3
FLEET_KILL_TICK, FLEET_DRAIN_TICK = 2, 3
FLEET_STAGGER_S = 34
FLEET_CANARY = 8
FLEET_CLIENTS = 4
# Request bodies a client cycles through: every fourth is 1-2 of
# FLEET_HOT rows (answered from the cache once seen), the others 1-8 rows
# of the rest of the pool, which outnumber the cache's --cache-rows, so
# most of them reach a worker (the canary needs forwarded outcomes).
FLEET_ROW_POOL, FLEET_HOT, FLEET_CACHE_ROWS = 48, 4, 24
FLEET_BODIES = 32
# The retrieval tier's rows are FLEET_RETRIEVAL_ROWS more, after the
# pool's: the router caches what /search and the stores embed, so rows the
# clients also sent would be answered from the cache with the bits of a
# forward of another batch, which no client saw, and the cache's
# bit-for-bit gate could not hold them. Its client stores a row a request
# (through /index/insert and /embed?store=true in turns) and searches one
# stored row, k FLEET_SEARCH_K; the phase stores FLEET_INDEX_TRAIN rows
# first, so
# that the plane is trained before killshard SIGKILLs shard 0, which lands
# FLEET_KILLSHARD_TICK shard-fleet ticks after the shards are ready: a tick
# takes --health-poll (1 s) while the workers boot (16-30 s), 1.5-2 s under
# the clients' load, so the kill lands 45-65 s in, after the seed and
# around w0's restart; the rollout waits for the shard's recovery. Shard 0
# owns 3 of the 8 lists (rendezvous placement).
FLEET_INDEX_TRAIN, FLEET_INDEX_LISTS, FLEET_DOCSTORE = 8, 8, 4
FLEET_RETRIEVAL_ROWS = 48
FLEET_KILLSHARD_TICK = 40
FLEET_SEARCH_K = 5
FLEET_HIT_ROWS = 8  # rows a self-hit search: ~10 MB of JSON, under 32 MB
FLEET_FLAGS = [
    "--workers", str(FLEET_WORKERS), "--watch-poll", "0.5",
    "--worker-stagger", str(FLEET_STAGGER_S), "--eject-after", "20",
    "--canary-fraction", "0.5", "--canary-min-requests", str(FLEET_CANARY),
    "--shadow-fraction", "0.5", "--shadow-min-samples", str(FLEET_CANARY),
    "--shadow-max-drift", "0.5", "--cache-rows", str(FLEET_CACHE_ROWS),
    "--fed-interval", "1", "--health-poll", "1.0",
    "--slo-availability", "0.99", "--slo-latency-ms", "5000",
    "--autoscale", "--min-workers", "1", "--max-workers",
    str(FLEET_WORKERS - 1), "--scale-idle-ticks", "1000000",
    "--chaos", f"killworker@{FLEET_KILL_TICK},drainworker@{FLEET_DRAIN_TICK},"
    f"killshard@{FLEET_KILLSHARD_TICK}",
    "--run-id", "smoke", "--port", "0",
    # the retrieval tier (ROADMAP Queue A 12(b)): the in-memory index and a
    # plane of two supervised shard processes with a journal, both trained
    # at FLEET_INDEX_TRAIN rows over FLEET_INDEX_LISTS lists, all probed
    # (their answers exact over the stored rows); the docstore bounded at
    # FLEET_DOCSTORE rows (602,112 bytes each at 224 px), which a promote
    # re-embeds through the router's JSON path (~16 MB of JSON a chunk of
    # 5 rows)
    "--index-mem", "--index-train-rows", str(FLEET_INDEX_TRAIN),
    "--index-centroids", str(FLEET_INDEX_LISTS), "--index-nprobe",
    str(FLEET_INDEX_LISTS), "--index-docstore-rows", str(FLEET_DOCSTORE),
    "--search-shards", "2", "--shard-procs", "--shard-repair-interval",
    "0.5", "--slo-retrieval-degraded", "0.9"]
FLEET_BUDGET_S = 210.0
FLEET_BOOT_S = 240.0  # three workers' first start on a cold host

# The launches of #11 in each worker process: a sitecustomize the
# workers inherit through PYTHONPATH writes them, with the engine's chunks
# and first runs, when a worker exits cleanly (SIGTERM: the drain, the
# shutdown); a SIGKILLed worker reports nothing. It chains to the
# sitecustomize it shadows.
_FLEET_SITE = '''
import atexit, gc, json, os, sys


def _report():
    attention = sys.modules.get("ntxent_tpu_torch.ops.attention")
    engine = sys.modules.get("ntxent_tpu_torch.serving.engine")
    if attention is None or engine is None:
        return
    engines = [o for o in gc.get_objects()
               if isinstance(o, engine.InferenceEngine)]
    argv = sys.argv
    worker = (os.path.basename(argv[argv.index("--port-file") + 1])
              .split(".")[0] if "--port-file" in argv else None)
    rec = {"pid": os.getpid(), "worker": worker,
           "launches": attention.flash_attention_fwd.launches,
           "chunks": sum(e.metrics.device_calls for e in engines),
           "first_runs": sum(e.metrics.compiles + e.metrics.ladder_compiles
                             for e in engines)}
    path = os.path.join(os.environ["NTXENT_SMOKE_COUNTS"],
                        f"{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


if os.environ.get("NTXENT_SMOKE_COUNTS"):
    atexit.register(_report)
_here = os.path.dirname(os.path.abspath(__file__))
for _entry in sys.path:
    _path = os.path.join(_entry or ".", "sitecustomize.py")
    if os.path.abspath(_entry or ".") != _here and os.path.isfile(_path):
        exec(compile(open(_path).read(), _path, "exec"))
        break
'''


def _fleet_refs(dir_a: str, steps: dict, rows: np.ndarray) -> dict:
    """Each step's direct forward of the row pool on the card; the bad
    step is ``steps["newer"]`` with the projection's last layer negated,
    saved by the port's manager at ``steps["bad"]`` under ``stage``."""
    import torch

    refs = {}
    with torch.inference_mode():
        for label in ("first", "newer"):
            model = _step_model(dir_a, steps[label])
            refs[label] = model(torch.from_numpy(rows).to(SMOKE_DEVICE)) \
                .float().cpu().numpy()
            del model
    refs["bad"] = -refs["newer"]  # the normalized output of -fc2
    torch.cuda.empty_cache()
    return refs


def _save_bad_step(dir_a: str, newer: int, bad: int, stage: str) -> None:
    """Step ``newer``'s weights with ``projector.fc2`` negated, a valid
    checkpoint at step ``bad`` written by the port's manager."""
    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import CheckpointManager
    from ntxent_tpu_torch.training import trainer as ttrain

    model = cli.build_model(cli.build_serve_parser().parse_args(SERVE_ARGV))
    CheckpointManager(dir_a).restore_variables(model, step=newer)
    with torch.no_grad():
        model.projector.fc2.weight.neg_()
    state = ttrain.create_train_state(model, ttrain.TrainerConfig(),
                                      torch.device("cpu"))
    state.step = bad
    if not CheckpointManager(stage).save(bad, state):
        fail("fleet: the bad step did not save")


def _fleet_get(url: str):
    status, body = _get_text(url)
    return status, (json.loads(body) if body.startswith(("{", "[")) else body)


def _router_events(path: str, event: str) -> list:
    from ntxent_tpu_torch.obs import events

    return events.read_events(path, event) if os.path.exists(path) else []


def _fleet_stop(router, router_log: str) -> list:
    """Stop the router (SIGTERM, which stops its workers; SIGKILL after a
    minute) and SIGKILL any worker it spawned that is still alive, as on
    a failed phase; returns those workers' pids."""
    import signal
    import subprocess

    if router.poll() is None:
        router.send_signal(signal.SIGTERM)
        try:
            router.wait(60)
        except subprocess.TimeoutExpired:
            router.kill()
            router.wait(30)
    alive = []
    for r in _router_events(router_log, "fleet"):
        if r.get("action") != "spawn":
            continue
        try:  # a worker or shard still running, not a reused pid
            with open(f"/proc/{r['pid']}/cmdline", "rb") as f:
                cmdline = f.read()
            if b"ntxent_tpu_torch.cli" not in cmdline and \
                    b"ntxent_tpu_torch.retrieval.shard" not in cmdline:
                continue
            os.kill(r["pid"], signal.SIGKILL)
            alive.append(r["pid"])
        except (KeyError, OSError):
            pass
    return alive


def _fleet_mix_evidence(router_log: str, pool: np.ndarray, answer: dict,
                        marks: dict, wall_start: float) -> None:
    """Print what the router's log says of an answer whose rows came from
    two steps: the phase's marks (the rollout's promote among them) and
    every cache insert of the answer's rows, each with the step it was
    computed at, the step trusted at its lookup, the cache generation and
    the trust gate's verdict, in seconds since the router started."""
    from ntxent_tpu_torch.serving.cache import row_key

    keys = {row_key(pool[j].astype(np.float32)).hex()[:16]: int(j)
            for j in answer["ids"]}
    print(f"[fleet] mixed answer {answer['rid']}: marks (s) "
          f"{ {k: round(v - marks['start'], 3) for k, v in marks.items()} }")
    for r in _router_events(router_log, "fleet"):
        if r.get("action") != "cache_insert":
            continue
        rows = [keys[k] for k in r.get("keys", ()) if k in keys]
        if rows:
            print(f"[fleet]   cache insert at "
                  f"{r['wall'] - wall_start:.3f} s: rows {rows} of step "
                  f"{r.get('step')} (trusted {r.get('trusted')}, "
                  f"generation {r.get('generation')}, admitted "
                  f"{r.get('admitted')}, {r.get('rid')})")


def _fleet_status_evidence(router_log: str, bad: list, marks: dict,
                           wall_start: float) -> None:
    """Print what the router's log says of answers that were neither 200
    nor 429: each answer's error body and times, the forwards the router
    made for it (worker, attempt, error), and the fleet's worker events
    (spawn, death, restart, eject, retire) and drains, in seconds since
    the router started."""
    print(f"[fleet] marks (s) "
          f"{ {k: round(v - marks['start'], 3) for k, v in marks.items()} }")
    rids = {a["rid"] for a in bad}
    for a in bad:
        print(f"[fleet] {a['rid']}: {a['status']} {a['payload']} sent "
              f"{a['t_send'] - marks['start']:.3f} s, answered "
              f"{a['t_recv'] - marks['start']:.3f} s")
    for r in _router_events(router_log, "span"):
        if r.get("request_id") in rids and r.get("name") == "fleet.forward":
            print(f"[fleet]   {r['request_id']} forward to {r.get('worker')} "
                  f"(attempt {r.get('attempt')}) ended "
                  f"{r['wall'] - wall_start:.3f} s after {r['dur_ms']} ms"
                  f", error {r.get('error')}")
    for event in ("fleet", "autoscale"):
        for r in _router_events(router_log, event):
            if r.get("action") in (None, "cache_insert"):
                continue
            rest = {k: v for k, v in r.items() if k not in (
                "event", "t", "wall", "run_id", "attempt", "action")}
            print(f"[fleet]   {event} {r['action']} at "
                  f"{r['wall'] - wall_start:.3f} s: {rest}")


def _shard_pids(router_log: str) -> list:
    """The pids of the shard processes the router spawned that run."""
    pids = []
    for r in _router_events(router_log, "fleet"):
        if r.get("action") != "spawn" or r.get("channel") != "shard":
            continue
        try:
            with open(f"/proc/{r['pid']}/cmdline", "rb") as f:
                if b"ntxent_tpu_torch.retrieval.shard" in f.read():
                    pids.append(r["pid"])
        except OSError:
            pass
    return pids


def _running(pid: int) -> bool:
    """Whether the process runs (a zombie, dead but not yet reaped by its
    parent, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def _maps_torch(pid: int) -> bool:
    """Whether the process maps libtorch."""
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def _pct(values, q: float) -> float:
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))] \
        if values else float("nan")


def _fleet_retrieval_gates(answers, outage, marks, refs, labels, row_l2,
                           index_events, seen) -> dict:
    """The retrieval tier's gates over [fleet]'s run; returns its
    numbers. ``answers`` are the retrieval client's (and the phase's own)
    answers, ``refs`` each step's direct forward of the row pool,
    ``labels`` a step's key in ``refs``, ``row_l2`` the largest L2
    distance of an answered row from its reference."""
    first, newer = seen["first"], seen["newer"]
    statuses = sorted({a["status"] for a in answers})
    if set(statuses) - {200, 429}:
        fail(f"fleet: retrieval statuses {statuses}: "
             f"{[a['payload'] for a in answers if a['status'] not in (200, 429)][:3]}")
    # stores: stored 0 (and, from /index/insert, reason not_trusted) only
    # while a canary is undecided or a laggard serves the prior step
    windows = ((marks["publish_newer"], marks["publish_bad"]),
               (marks["publish_bad"], marks["reverted"] + 1.0))
    stores = [a for a in answers if a["kind"] != "search"
              and a["status"] == 200]
    gated = []
    for a in stores:
        body = a["payload"]
        if body.get("stored"):
            if body["index_step"] not in (first, newer) or \
                    len(body["ids"]) != len(a["rows"]):
                fail(f"fleet: {a['rid']} stored {body}")
            continue
        gated.append(a)
        if (a["kind"] == "insert" and body.get("reason") != "not_trusted") \
                or not any(lo <= a["t_recv"] and a["t_send"] <= hi
                           for lo, hi in windows):
            fail(f"fleet: {a['rid']} stored nothing outside a rollout "
                 f"window ({a['t_send'] - marks['start']:.1f} s): {body}; "
                 f"marks {marks}")
    for a in stores:  # /embed?store=true answers carry the embeddings
        if a["kind"] == "store" and a["payload"].get("stored"):
            got = np.asarray(a["payload"]["embeddings"], np.float32)
            ref = refs[labels[a["payload"]["index_step"]]][a["rows"]]
            row_l2 = max(row_l2, float(np.linalg.norm(got - ref,
                                                      axis=1).max()))
    # searches: the brute-force top k of the rows stored under the
    # answer's step, from that step's direct forward, the row itself
    # first; ids may differ only where reference scores lie within
    # 4 x row_l2 (each score is off by at most 2 x row_l2). Held: the
    # searches on a whole plane (no shard down, no promote under way)
    # whose query that step embedded (or the cache held)
    tol = 4.0 * row_l2 + 1e-6
    skip = ((marks["shard_death"] - 0.5, marks["recall_restored"]),
            (marks["publish_newer"], marks["promoted"] + 2.0))
    checked = exact = 0
    for a in answers:
        if a["kind"] != "search" or a["status"] != 200 or a["k"] == 1:
            continue
        body = a["payload"]
        step = body["index_step"]
        if a["t_send"] > marks["promoted"] + 2.0 and step != newer:
            fail(f"fleet: {a['rid']} searched step {step} after the "
                 f"promote of {newer}")
        if body["shards"]["degraded"] or body["served_step"] not in (
                None, step) or any(lo <= a["t_recv"] and a["t_send"] <= hi
                                   for lo, hi in skip):
            # (a laggard's query searches the promoted plane from the
            # prior step's space: the plane does not match versions)
            continue
        held = a["stored"].get(step, {})
        q = a["rows"][0]
        own = [i for i, j in held.items() if j == q]
        if not own:
            continue
        ids = np.fromiter(held, np.int64)
        ref = refs[labels[step]]
        dots = ref[[held[i] for i in ids]] @ ref[q]
        order = np.argsort(-dots, kind="stable")[:a["k"]]
        got = [i for i in body["ids"][0] if i >= 0]
        by_id = dict(zip(ids.tolist(), dots.tolist()))
        if len(got) != len(order) or got[0] != own[0] \
                or any(i not in by_id for i in got) \
                or any(abs(by_id[i] - float(dots[o])) > tol
                       for i, o in zip(got, order)) \
                or any(abs(by_id[i] - s) > tol
                       for i, s in zip(got, body["scores"][0])):
            fail(f"fleet: {a['rid']} on step {step} answered {got} "
                 f"({body['scores'][0]}); brute force "
                 f"{ids[order].tolist()} ({dots[order].tolist()}), "
                 f"tolerance {tol:.3e}")
        checked += 1
        exact += got == ids[order].tolist()
    if not checked:
        fail("fleet: no search on a whole plane to hold to brute force")
    # the promote: the index's promoted version rebuilt from the docstore
    promoted = [r for r in index_events if r.get("action") == "promote"
                and r.get("step") == newer]
    rebuilds = [r for r in index_events if r.get("action") == "rebuild"]
    after = [r for r in rebuilds if promoted and r["wall"] >= promoted[0][
        "wall"] and r.get("step") == newer]
    docstore = min(FLEET_DOCSTORE, sum(
        a["payload"]["stored"] for a in stores if a["payload"].get("stored")
        and a["payload"]["index_step"] == first
        and a["t_recv"] < marks["promoted"]))
    if not promoted or not after or after[0]["rows"] != docstore:
        fail(f"fleet: the index's promote {promoted}, rebuilds {rebuilds}; "
             f"{docstore} rows in the docstore")
    view = seen["index"]
    if view["active_step"] != newer or view["versions"][str(newer)][
            "rows"] < 1:
        fail(f"fleet: /index after the rollout {view}")
    # the drift rollback: the live version marked stale
    stale = [r for r in index_events if r.get("action") == "stale"
             and "drift" in r.get("reason", "")]
    if not stale or stale[0].get("step") != newer:
        fail(f"fleet: the drift rollback's stale mark {stale}")
    # killshard: 200s reporting the dead shard, the restart on its port,
    # the journal's debt redelivered, every stored row found again
    if any(a["status"] != 200 for a in outage) or not any(
            a["payload"]["shards"]["degraded"] for a in outage):
        fail(f"fleet: searches while shard 0 was down: "
             f"{[(a['status'], a['payload'].get('shards')) for a in outage]}")
    healed, plane0 = seen["healed"], seen["plane0"]
    if [s["url"] for s in healed["shards"]] != [s["url"] for s in
                                                plane0["shards"]] \
            or healed["repaired"] < 1 or healed["dropped"] \
            or seen["shard_death"]["rc"] != -9:
        fail(f"fleet: the plane after killshard {healed} (before: "
             f"{plane0})")
    final = seen["final_hits"]
    if final is None or not final[1]:
        fail(f"fleet: the final self-hits "
             f"{final and [a['payload'] for a in final[0]]}")
    if seen["torch_maps"] or len(seen["shard_pids"]) != 2:
        fail(f"fleet: libtorch mapped in {seen['torch_maps']} (shards "
             f"{seen['shard_pids']})")
    ms = lambda kinds: [(a["t_recv"] - a["t_send"]) * 1e3  # noqa: E731
                        for a in answers if a["status"] == 200
                        and a["kind"] in kinds and a["k"] != 1]
    return dict(
        answers=len(answers), statuses=statuses, gated=len(gated),
        stores=len(stores), searches=len(ms(("search",))), checked=checked,
        exact=exact, tol=tol,
        search_ms=(_pct(ms(("search",)), 0.5), _pct(ms(("search",)), 0.99)),
        insert_ms=(_pct(ms(("insert", "store")), 0.5),
                   _pct(ms(("insert", "store")), 0.99)),
        index_active_ms=(after[0]["wall"] - promoted[0]["wall"]) * 1e3,
        rebuild_ms=after[0]["duration_ms"], rebuild_rows=after[0]["rows"],
        outage=len(outage), degraded=sum(
            a["payload"]["shards"]["degraded"] for a in outage),
        depth=max(seen["depths"]), repaired=healed["repaired"],
        healed_rows=len(seen["healed_ids"]),
        final_rows=sum(len(a["rows"]) for a in final[0]))


def phase_fleet(tmp: str, dir_a: str, card_line: str) -> int:
    """The serving fleet on run A's steps; returns #11's launches in the
    workers that reported."""
    import signal
    import subprocess

    from ntxent_tpu_torch.obs import trace
    from ntxent_tpu_torch.obs.history import MetricHistory
    from ntxent_tpu_torch.training import CheckpointManager

    t0 = time.monotonic()
    first, newer = sorted(CheckpointManager(dir_a).all_steps())[-2:]
    bad = newer + 1
    root = f"{tmp}/fleet"
    watch, stage, counts, site = (f"{root}/{d}" for d in (
        "watch", "stage", "counts", "site"))
    for d in (watch, stage, counts, site):
        os.makedirs(d)
    shutil.copy(f"{dir_a}/manifests.json", watch)

    def publish(src, step):  # atomically: no watcher sees half a step
        shutil.copytree(f"{src}/{step}", f"{watch}/.copy-{step}")
        os.rename(f"{watch}/.copy-{step}", f"{watch}/{step}")

    publish(dir_a, first)
    with open(f"{site}/sitecustomize.py", "w") as f:
        f.write(_FLEET_SITE)
    router_log, history_dir = f"{root}/router.jsonl", f"{root}/history"
    workdir, port_file = f"{root}/workers", f"{root}/router.port"
    journal = f"{root}/journal"
    # SERVE_ARGV's model and batching flags; the fleet places its workers
    model_flags = list(SERVE_ARGV)
    for flag in ("--port", "--device"):
        i = model_flags.index(flag)
        del model_flags[i:i + 2]
    argv = [sys.executable, "-m", "ntxent_tpu_torch.fleet_cli",
            *model_flags, *FLEET_FLAGS, "--ckpt-dir", watch, "--workdir",
            workdir, "--port-file", port_file, "--log-jsonl", router_log,
            "--history-dir", history_dir, "--shard-journal-dir", journal]
    env = dict(os.environ, NTXENT_SMOKE_COUNTS=counts, PYTHONPATH=os.pathsep
               .join([site, os.path.dirname(os.path.abspath(__file__)),
                      os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    out_path = f"{root}/router.out"
    marks, answers, bodies, stop = {"start": time.monotonic()}, [], [], \
        threading.Event()
    wall_start = time.time()  # the router log's "wall" at marks["start"]
    router = subprocess.Popen(argv, cwd=os.path.dirname(
        os.path.abspath(__file__)), env=env, stdout=open(out_path, "w"),
        stderr=subprocess.STDOUT)
    url = None

    def router_tail() -> str:
        with open(out_path) as f:
            return "".join(f.readlines()[-30:])

    def wait(what, predicate, timeout_s):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if router.poll() is not None:
                fail(f"fleet: the router exited {router.returncode} while "
                     f"waiting for {what}:\n{router_tail()}")
            value = predicate()
            if value:
                return value
            time.sleep(0.1)
        try:
            state = metrics()
        except OSError as e:
            state = repr(e)
        fail(f"fleet: no {what} within {timeout_s:.0f} s; the router's "
             f"/metrics: {state}\n{router_tail()}")

    def metrics():
        return _fleet_get(f"{url}/metrics")[1]

    def served(ready=False):
        """Each pool member's step (only the ready ones' with ``ready``:
        a probe that times out under load turns a worker unready for a
        poll, which says nothing about its step)."""
        return {w: v["checkpoint_step"] for w, v in metrics()["workers"]
                .items() if v["ready"] or not ready}

    def client(k: int) -> None:
        n = 0
        while not stop.is_set():
            ids, body = bodies[(k * 7 + n) % FLEET_BODIES]
            rid = f"fleet-{k}-{n}"
            t_send = time.monotonic()
            status, headers, payload = _post_full(f"{url}/embed", body, rid)
            answers.append(dict(rid=rid, ids=ids, status=status,
                                t_send=t_send, t_recv=time.monotonic(),
                                payload=payload, headers=headers))
            n += 1
            if status == 429:
                time.sleep(float(headers.get("Retry-After", 1)))

    # the retrieval tier: what each step's index holds (row id -> pool
    # row), every answer of /index/insert, /embed?store=true and /search
    # with what was stored when it was sent
    rlock, stored, r_answers = threading.Lock(), {}, []
    retrieval_rows = list(range(FLEET_ROW_POOL,
                                FLEET_ROW_POOL + FLEET_RETRIEVAL_ROWS))

    def rows_body(rows, k=None):
        extra = f', "k": {k}' if k is not None else ""
        return ('{"inputs": [' + ", ".join(row_json[j] for j in rows)
                + f'], "timeout_ms": 120000{extra}}}').encode()

    def retrieve(kind, rows, rid, k=FLEET_SEARCH_K):
        path = {"insert": "/index/insert", "store": "/embed?store=true",
                "search": "/search"}[kind]
        body = rows_body(rows, k if kind == "search" else None)
        with rlock:
            before = {step: dict(held) for step, held in stored.items()}
        t_send = time.monotonic()
        status, headers, payload = _post_full(url + path, body, rid)
        a = dict(kind=kind, rid=rid, rows=list(rows), status=status,
                 t_send=t_send, t_recv=time.monotonic(), payload=payload,
                 headers=headers, stored=before, k=k)
        if kind != "search" and status == 200 and payload.get("stored"):
            with rlock:
                stored.setdefault(payload["index_step"], {}).update(
                    zip(payload["ids"], rows))
        r_answers.append(a)
        return a

    def self_hits(held, rid):
        """A search of each stored row (``held``: id -> pool row), k 1,
        FLEET_HIT_ROWS rows a request (under the router's body cap), the
        requests at once: (the answers, whether every row came back as
        its own first hit from a whole plane)."""
        ids = sorted(held)
        chunks = [ids[lo:lo + FLEET_HIT_ROWS]
                  for lo in range(0, len(ids), FLEET_HIT_ROWS)]
        answers = [None] * len(chunks)

        def one(c):
            answers[c] = retrieve("search", [held[i] for i in chunks[c]],
                                  f"{rid}-{c}", k=1)

        threads = [threading.Thread(target=one, args=(c,), daemon=True)
                   for c in range(len(chunks))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        whole = all(a is not None and a["status"] == 200
                    and not a["payload"]["shards"]["degraded"]
                    for a in answers)
        return answers, whole and [row[0] for a in answers for row in
                                   a["payload"]["ids"]] == ids

    def rebuilding() -> bool:
        """Whether the index is re-embedding its docstore (after a promote
        or a stale mark). A rebuild runs in passes until one sees no
        insert, so the client stores nothing meanwhile."""
        last = [r["action"] for r in _router_events(router_log, "index")
                if r.get("action") in ("promote", "stale", "rebuild")]
        return bool(last) and last[-1] != "rebuild"

    # what the killshard watcher found: the outage's searches and plane
    # readings, the healed plane, the stored rows it found again
    heal = {}

    def outage_watch(victim, step) -> None:
        """From the moment the shard process ``victim`` is gone (its /proc
        state, polled: the router's log is flushed later), search a
        stored row over and over (a hot row the cache holds: no worker
        forward) and read the plane, until the shard is back on its port
        with no journal debt and every row stored under ``step`` is its
        own first hit."""
        if not _running(victim):
            heal["error"] = ("killshard landed before the plane trained: "
                             "move FLEET_KILLSHARD_TICK later")
            return
        while _running(victim):
            if stop.is_set():
                return
            time.sleep(0.02)
        marks["shard_death"] = time.monotonic()
        try:
            heal_after(step)
        except Exception as e:  # noqa: BLE001 — the phase's thread fails
            heal["error"] = f"the killshard watcher: {e!r}"

    def heal_after(step) -> None:
        outage, depths, n, plane = [], [], 0, None
        while time.monotonic() < marks["shard_death"] + 180:
            with rlock:
                held = dict(stored.get(step, {}))
            outage.append(retrieve("search", [held[min(held)]],
                                   f"outage-{n}"))
            n += 1
            plane = _fleet_get(f"{url}/index")[1]["shard_plane"]
            depths.append(plane["journal_depth"])
            respawned = [r for r in _router_events(router_log, "fleet")
                         if r.get("channel") == "shard" and r.get(
                             "action") == "spawn" and r["restarts"] >= 1]
            if not respawned or plane["journal_depth"] or not all(
                    sh["alive"] for sh in plane["shards"]):
                continue
            hits, every = self_hits(held, f"self-hits-{n}")
            if every:
                marks["recall_restored"] = max(a["t_recv"] for a in hits)
                heal.update(outage=outage, depths=depths, plane=plane,
                            ids=sorted(held))
                return
        heal["error"] = (f"no recall restored within 180 s of killshard; "
                         f"the plane: {plane}")

    def retrieval_client(step) -> None:
        n = 0
        while not stop.is_set():
            with rlock:
                held = dict(stored.get(step, {}))
            fresh = [j for j in retrieval_rows if j not in held.values()]
            a = None
            if fresh and not rebuilding():
                a = retrieve("store" if n % 2 else "insert",
                             [fresh[(7 * n) % len(fresh)]],
                             f"retrieval-{n}")
                if a["status"] == 200 and a["payload"].get("stored"):
                    step = a["payload"]["index_step"]
                    held = dict(stored.get(step, {}))
            if held and not stop.is_set():
                ids = sorted(held)
                a = retrieve("search", [held[ids[(3 * n) % len(ids)]]],
                             f"search-{n}")
                if a["status"] == 200:  # the plane's step, after a promote
                    step = a["payload"]["index_step"]
            n += 1
            if a is None:
                time.sleep(0.5)
            elif a["status"] == 429:
                time.sleep(float(a["headers"].get("Retry-After", 1)))

    # every worker ready on the first step: killworker lands one tick
    # (--health-poll) after the fleet's chaos arms there, so a thread
    # watches for that moment while the phase prepares its data
    all_ready = threading.Event()

    def watch_ready() -> None:
        want = {f"w{i}": first for i in range(FLEET_WORKERS)}
        while not stop.is_set():
            try:
                if served(ready=True) == want:
                    marks["ready"] = time.monotonic()
                    all_ready.set()
                    return
            except (OSError, ValueError):  # the router still starting
                pass
            time.sleep(0.1)

    clients = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(FLEET_CLIENTS)]
    try:
        url = "http://127.0.0.1:" + wait(
            "port file", lambda: os.path.exists(port_file)
            and open(port_file).read().strip(), 60)
        threading.Thread(target=watch_ready, daemon=True).start()
        # while the workers boot: the references, the bad step, the bodies
        rng = np.random.default_rng(23)
        pool = rng.uniform(-1, 1, (FLEET_ROW_POOL, SERVE_IMAGE,
                                   SERVE_IMAGE, 3)).round(3)
        pool = np.concatenate([pool, np.random.default_rng(24).uniform(
            -1, 1, (FLEET_RETRIEVAL_ROWS, *pool.shape[1:])).round(3)])
        refs = _fleet_refs(dir_a, {"first": first, "newer": newer},
                           pool.astype(np.float32))
        _save_bad_step(dir_a, newer, bad, stage)
        row_json = [json.dumps(r.tolist()) for r in pool]
        for i in range(FLEET_BODIES):
            ids = (rng.choice(FLEET_HOT, size=1 + i % 2) if i % 4 == 0 else
                   rng.choice(np.arange(FLEET_HOT, FLEET_ROW_POOL),
                              size=1 + i % 8))
            bodies.append((ids, ('{"inputs": [' + ", ".join(
                row_json[j] for j in ids)
                + '], "timeout_ms": 120000}').encode()))
        wait(f"{FLEET_WORKERS} ready workers on step {first}",
             all_ready.is_set, FLEET_BOOT_S)
        for th in clients:
            th.start()
        # the retrieval tier: FLEET_INDEX_TRAIN rows stored at once train
        # the index and the shard plane; then the client
        seed = retrieve("insert", retrieval_rows[:FLEET_INDEX_TRAIN],
                        "seed")
        if seed["status"] != 200 or seed["payload"].get("stored") != \
                FLEET_INDEX_TRAIN or seed["payload"].get("index_step") \
                != first:
            fail(f"fleet: the seed insert {seed['status']} "
                 f"{seed['payload']}")
        plane0 = _fleet_get(f"{url}/index")[1]["shard_plane"]
        if not plane0["trained"]:
            fail(f"fleet: the shard plane untrained after "
                 f"{FLEET_INDEX_TRAIN} rows: {plane0}")
        clients.append(threading.Thread(target=retrieval_client,
                                        args=(first,), daemon=True))
        clients[-1].start()
        shard0 = [r["pid"] for r in _router_events(router_log, "fleet")
                  if r.get("channel") == "shard" and r.get("action") ==
                  "spawn" and r["worker"] == "w0"][0]
        threading.Thread(target=outage_watch, args=(shard0, first),
                         daemon=True).start()
        # killworker (w0) and drainworker (the highest ordinal) land
        deaths = wait("the killed worker's death", lambda: [
            r for r in _router_events(router_log, "fleet")
            if r.get("action") == "death" and "channel" not in r], 60)
        drained = wait("the drain", lambda: [
            r for r in _router_events(router_log, "autoscale")
            if r.get("action") in ("drain_done", "drain_deadline")], 60)
        marks["drained"] = time.monotonic()
        wait("w0 and w1 ready after the restart",
             lambda: served(ready=True) == {"w0": first, "w1": first}, 120)
        marks["restarted"] = time.monotonic()
        restart_ms = (time.time() - deaths[0]["wall"]) * 1e3
        # killshard (``outage_watch``): searches during the outage, the
        # shard restarted on its port, the journal's debt redelivered,
        # every stored row found again
        wait("recall restored after killshard", lambda: heal, 240)
        if "error" in heal:
            fail(f"fleet: {heal['error']}")
        shard_death = wait("the killed shard's death event", lambda: [
            r for r in _router_events(router_log, "fleet")
            if r.get("action") == "death" and r.get("channel") == "shard"],
            30)[0]
        restored_ms = (marks["recall_restored"]
                       - marks["shard_death"]) * 1e3
        # the rollout: w0 adopts the newer step at once, w1 later
        marks["publish_newer"] = time.monotonic()
        publish(dir_a, newer)
        wait(f"step {newer} promoted", lambda: metrics()["trusted_step"]
             == newer, 120)
        marks["promoted"] = time.monotonic()
        promote_verdict, promote_view = metrics()["last_verdict"], served()
        if _fleet_get(f"{url}/healthz")[1].get("trusted_step") != newer:
            fail(f"fleet: /healthz after the promote of step {newer}")
        if promote_view.get("w1") != first:
            fail(f"fleet: step {newer} promoted with the workers on "
                 f"{promote_view}: w1 adopted before the verdict")
        wait(f"both workers on step {newer}", lambda: served() == {
            "w0": newer, "w1": newer}, FLEET_STAGGER_S + 60)
        wait(f"the index's version of step {newer} rebuilt", lambda: [
            r for r in _router_events(router_log, "index")
            if r.get("action") == "rebuild" and r.get("step") == newer],
            120)
        marks["rebuilt"] = time.monotonic()
        marks["publish_bad"] = time.monotonic()
        publish(stage, bad)
        wait(f"step {bad} rolled back", lambda: bad in metrics()[
            "bad_steps"], 120)
        marks["rolled_back"] = time.monotonic()
        rollback_verdict = metrics()["last_verdict"]
        wait(f"both workers back on step {newer}", lambda: served() == {
            "w0": newer, "w1": newer}, 60)
        marks["reverted"] = time.monotonic()
        worker_urls = {w: v["url"] for w, v in metrics()["workers"].items()}
        blocked = {}
        for w, wurl in worker_urls.items():
            status, _, body = _post_full(f"{wurl}/rollback", json.dumps(
                {"step": bad}).encode(), f"blocked-{w}")
            blocked[w] = body.get("blocked_steps") if status == 200 else None
            if status != 200 or bad not in body.get("blocked_steps", ()) \
                    or body.get("checkpoint_step") != newer:
                fail(f"fleet: {w} after the rollback: {status} {body}")
            health = _fleet_get(f"{wurl}/healthz")[1]
            if health.get("checkpoint_step") != newer:
                fail(f"fleet: {w} serves {health} after the rollback")
        time.sleep(2.0)  # answers after the rollback, on the newer step
        # the observability plane, both workers still in the pool
        status, fed = _fleet_get(f"{url}/metrics/fleet")
        if status != 200 or any(f'serving_queue_depth{{instance="{w}"}}'
                                not in fed for w in ("w0", "w1")):
            fail(f"fleet: /metrics/fleet {status} lacks the workers' "
                 f"serving series")
        status, alerts = _fleet_get(f"{url}/alerts")
        if status != 200 or "availability" in alerts["firing"] or not any(
                a["name"] == "canary_rollback" for a in alerts["history"]):
            fail(f"fleet: /alerts {status} {alerts}")
        status, history = _fleet_get(f"{url}/metrics/history")
        if status != 200 or history["raw_samples"] < 1:
            fail(f"fleet: /metrics/history {status} {history}")
        if not any(name.startswith("retrieval_shard_up")
                   for name in history["series_names"]):
            fail(f"fleet: no retrieval_shard_up in /metrics/history: "
                 f"{history['series_names']}")
        # the retrieval tier after the drift rollback: the newer step's
        # version active (the breach marks it stale, and its rebuild
        # re-embeds the docstore in the background), and every row stored
        # under it finds itself first
        index_view = _fleet_get(f"{url}/index")[1]
        stop.set()
        for th in clients:
            th.join(300)
        with rlock:
            held = dict(stored.get(newer, {}))
        if not held:
            # the retrieval client stores only while no rebuild runs, and
            # the rollout's rebuilds can leave it no window on the newer
            # step: the phase stores a row never stored before there once
            # the rollback's rebuild is done
            wait("the index's rebuild after the rollback",
                 lambda: not rebuilding(), 120)
            unused = [j for j in retrieval_rows if all(
                j not in h.values() for h in stored.values())]
            if not unused:
                fail("fleet: no retrieval row left to store on step "
                     f"{newer}")
            last = retrieve("store", unused[:1], "final-store")
            if last["status"] != 200 or last["payload"].get("stored") != 1 \
                    or last["payload"].get("index_step") != newer:
                fail(f"fleet: the store on step {newer} after the rollback "
                     f"{last['status']} {last['payload']}")
            print(f"[fleet-retrieval] the client stored no row on step "
                  f"{newer}; the phase stored row {unused[0]} after the "
                  f"rollback's rebuild", flush=True)
            with rlock:
                held = dict(stored.get(newer, {}))
        final_hits = self_hits(held, "self-hits-final") if held else None
        # neither the router nor a shard maps libtorch
        shard_pids = _shard_pids(router_log)
        torch_maps = [pid for pid in [router.pid, *shard_pids]
                      if _maps_torch(pid)]
        marks["clients_done"] = time.monotonic()
        time.sleep(1.0)
        final = metrics()
        _, prom = _get_text(f"{url}/metrics?format=prometheus")
        worker_metrics = {w: _fleet_get(f"{wurl}/metrics")[1]
                          for w, wurl in worker_urls.items()}
        marks["sigterm"] = time.monotonic()
        router.send_signal(signal.SIGTERM)
        rc = router.wait(120)
        marks["exited"] = time.monotonic()
    finally:
        stop.set()
        alive = _fleet_stop(router, router_log)
    if rc != 0:
        fail(f"fleet: the router exited {rc} on SIGTERM:\n{router_tail()}")
    if alive:
        fail(f"fleet: worker pids {alive} outlived the router")

    # 1-3: every answer 200 or 429, within EMBED_ATOL of a step's direct
    # forward (the router forwards no X-Checkpoint-Step, as the JAX
    # router does not: the nearest step names it); the cache
    statuses = sorted({a["status"] for a in answers})
    if not answers or set(statuses) - {200, 429}:
        _fleet_status_evidence(router_log, [
            a for a in answers if a["status"] not in (200, 429)], marks,
            wall_start)
        fail(f"fleet: client statuses {statuses} over {len(answers)} "
             "answers")
    seen = {}  # row id -> its rows' bytes in every forwarded answer
    by_step, worst, cache_only = {}, 0.0, []
    row_l2 = 0.0  # the largest L2 distance of an answered row from its ref
    for a in answers:
        if a["status"] != 200:
            continue
        got = np.asarray(a["payload"]["embeddings"], np.float32)
        errs = {s: float(np.abs(got - refs[s][a["ids"]]).max())
                for s in refs}
        step = min(errs, key=errs.get)
        a["step"] = step
        if errs[step] > EMBED_ATOL:  # two models in one answer?
            per_row = [min(refs, key=lambda s, i=i: float(np.abs(
                got[i] - refs[s][j]).max())) for i, j in enumerate(a["ids"])]
            _fleet_mix_evidence(router_log, pool, a, marks, wall_start)
            fail(f"fleet: {a['rid']} answered rows of steps {per_row} "
                 f"({a['payload'].get('cache_hits')} from the cache, sent "
                 f"{a['t_send'] - marks['start']:.1f} s after the router "
                 f"started; marks {marks})")
        by_step[step] = by_step.get(step, 0) + 1
        _check_embeddings(f"fleet {a['rid']} (step {step})", got,
                          refs[step][a["ids"]])
        worst = max(worst, errs[step])
        row_l2 = max(row_l2, float(np.linalg.norm(
            got - refs[step][a["ids"]], axis=1).max()))
        if a["payload"].get("cache_hits", 0) == len(a["ids"]):
            cache_only.append((a, got))
        else:
            for j, row in zip(a["ids"], got):
                seen.setdefault(int(j), set()).add(row.tobytes())
    bitwise = 0
    for a, got in cache_only:
        if a["step"] == "bad":
            fail(f"fleet: {a['rid']} came from the cache with the "
                 "undecided canary's embeddings")
        if all(row.tobytes() in seen.get(int(j), ()) for j, row in
               zip(a["ids"], got)):
            bitwise += 1
        elif a["t_send"] < marks["promoted"]:
            fail(f"fleet: cached answer {a['rid']} is no worker's answer "
                 "bit for bit")
    late = [a for a in answers if a["status"] == 200
            and a["t_send"] > marks["rolled_back"] + 1.0]
    if not late or any(a["step"] == "bad" for a in late):
        fail(f"fleet: answers after the rollback: "
             f"{[a['step'] for a in late]}")
    cache = final["cache"]
    evictions = [line for line in prom.splitlines()
                 if line.startswith("fleet_cache_evictions_total")]
    # the promote's warm replays the hot rows through whichever worker the
    # pool picks; rows a laggard still on the old step answers fail the
    # trust gate and stay cold (the JAX router's rule), so the replay is
    # gated and the rows it warmed are counted
    warms = [r for r in _router_events(router_log, "span")
             if r.get("name") == "fleet.cache_warm"]
    if not cache_only or not bitwise or cache["hits"] < 1 \
            or not any('reason="promote"' in line for line in evictions) \
            or not warms or warms[0].get("status") != 200:
        fail(f"fleet: cache-only answers {len(cache_only)} ({bitwise} bit "
             f"for bit), hits {cache['hits']}, evictions {evictions}, the "
             f"promote's warm {warms}")
    # 4: failover; 5-6: the verdicts; 8: the drain
    restarts = [line for line in prom.splitlines()
                if line.startswith("fleet_worker_restarts_total")]
    if not restarts or float(restarts[0].split()[-1]) < 1:
        fail(f"fleet: fleet_worker_restarts_total {restarts}")
    if promote_verdict.get("step") != newer or "drift" not in \
            promote_verdict.get("reason", "") or promote_verdict.get(
                "drift_samples", 0) < 1 or promote_verdict.get(
                "requests", 0) < FLEET_CANARY:
        fail(f"fleet: the promote of step {newer}: {promote_verdict}")
    swaps = {}  # the canary adopted first: w0's swap before w1's
    for w in ("w0", "w1"):
        swaps[w] = [r["wall"] for r in _router_events(
            f"{workdir}/{w}.jsonl", "rollout") if r.get("action") == "swap"
            and r.get("step") == newer]
    if not swaps["w0"] or not swaps["w1"] or \
            swaps["w0"][0] >= swaps["w1"][0]:
        fail(f"fleet: swaps to step {newer}: {swaps}")
    if rollback_verdict.get("step") != bad or rollback_verdict.get(
            "reason") != "shadow_drift":
        fail(f"fleet: the rollback of step {bad}: {rollback_verdict}")
    drain = drained[0]
    retired = [r for r in _router_events(router_log, "fleet")
               if r.get("action") == "retire" and "channel" not in r]
    if drain["action"] != "drain_done" or drain.get("worker") != \
            f"w{FLEET_WORKERS - 1}" or [r["worker"] for r in retired] \
            != [drain["worker"]]:
        fail(f"fleet: the drain {drain}, retired {retired}")
    # 7: the history spill reopens
    reopened = MetricHistory(spill_dir=history_dir)
    if not reopened.series_names():
        fail(f"fleet: the --history-dir spill under {history_dir} is empty")
    # 10: one merged trace; every forwarded answer in the router's lane
    # and a worker's (a request answered just before the SIGKILL may have
    # died in w0's unflushed log)
    logs = [router_log] + sorted(
        f"{workdir}/{n}" for n in os.listdir(workdir)
        if n.startswith("w") and n.endswith(".jsonl"))
    merged_path = f"{root}/merged.json"
    done = subprocess.run([sys.executable, "-m", "ntxent_tpu_torch.obs.trace",
                           "--merge", *logs, "-o", merged_path], env=env,
                          capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        fail(f"fleet: trace --merge: {done.stdout}{done.stderr}")
    with open(merged_path) as f:
        merged = json.load(f)
    n_events = trace.validate_chrome_trace(merged)
    lanes = {e["args"]["name"]: e["pid"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    rids_by_pid = {}
    for e in merged["traceEvents"]:
        rid = e.get("args", {}).get("request_id")
        if e.get("cat") == "span" and rid:
            rids_by_pid.setdefault(e["pid"], set()).add(rid)
    worker_rids = set().union(*(rids_by_pid.get(p, set()) for name, p in
                                lanes.items() if name != "router"))
    lost = []
    for a in answers:
        if a["status"] != 200 or a["payload"].get("cache_hits", 0) == \
                len(a["ids"]):
            continue
        if a["rid"] not in rids_by_pid.get(lanes["router"], set()):
            fail(f"fleet: {a['rid']} is not in the router's lane")
        if a["rid"] not in worker_rids:
            lost.append(a["rid"])
    # excused: answered by the killed w0 in the moments before its death
    # (its log's last records die with it, unflushed)
    forwards = {r["request_id"]: r for r in _router_events(
        router_log, "span") if r.get("name") == "fleet.forward"}
    death_wall = deaths[0]["wall"]
    unexcused = [r for r in lost if forwards.get(r, {}).get("worker") != "w0"
                 or not death_wall - 2.0 <= forwards[r]["wall"] <= death_wall]
    if unexcused:
        fail(f"fleet: forwarded answers in no worker's lane: {unexcused}")
    # 11: #11's launches in every worker that reported
    reports = []
    for name in sorted(os.listdir(counts)):
        if name.endswith(".json"):
            with open(f"{counts}/{name}") as f:
                reports.append(json.load(f))
    for r in reports:
        if r["launches"] != 12 * (r["chunks"] + r["first_runs"]):
            fail(f"fleet: {r['worker']} (pid {r['pid']}): "
                 f"flash_attention_fwd {r['launches']} launches over "
                 f"{r['chunks']} chunks and {r['first_runs']} first runs")
    if sorted(r["worker"] for r in reports) != ["w0", "w1", "w2"]:
        fail(f"fleet: reports from {[r['worker'] for r in reports]}, "
             "expected w0 (after its restart), w1 and w2")
    launches = sum(r["launches"] for r in reports)
    retrieval = _fleet_retrieval_gates(
        r_answers, heal["outage"], marks, refs, {first: "first",
                                                 newer: "newer", bad: "bad"},
        row_l2, _router_events(router_log, "index"), dict(
            plane0=plane0, healed=heal["plane"], healed_ids=heal["ids"],
            index=index_view, final_hits=final_hits,
            torch_maps=torch_maps, shard_pids=shard_pids,
            depths=heal["depths"], shard_death=shard_death, newer=newer,
            first=first))

    inserts = [r for r in _router_events(router_log, "fleet")
               if r.get("action") == "cache_insert"]
    refused = [r for r in inserts if not r.get("admitted")]
    print(f"[fleet] the router's log: {len(inserts)} cache inserts of "
          f"{sum(len(r.get('keys', ())) for r in inserts)} rows, "
          f"{len(refused)} refused by the trust gate (steps "
          f"{sorted({str(r.get('step')) for r in refused})}); no answer "
          f"mixed steps", flush=True)
    # probes of a live worker past their timeout: the worker stayed in
    # the pool as busy (the last one left still takes requests)
    timeouts = [r for r in _router_events(router_log, "fleet")
                if r.get("action") == "probe_timeout"]
    print(f"[fleet] probes of a live worker past "
          f"{timeouts[0]['timeout_s'] if timeouts else '-'} s: "
          f"{len(timeouts)} ("
          + ", ".join(f"{r.get('channel', 'embed')} {r['worker']} at "
                      f"{r['wall'] - wall_start:.1f} s" for r in timeouts)
          + "); every client answer 200 or 429", flush=True)
    ok = [a for a in answers if a["status"] == 200]
    window = [a for a in ok if marks["restarted"] <= a["t_send"]
              and a["t_recv"] <= marks["clients_done"]]
    span_s = max(a["t_recv"] for a in window) - min(
        a["t_send"] for a in window) if window else float("nan")
    rows_s = sum(len(a["ids"]) for a in window) / span_s
    lat = sorted((a["t_recv"] - a["t_send"]) * 1e3 for a in ok)
    router_lat = final["latency_ms"]
    worker_lat = worker_metrics["w0"]["latency_ms"]["total"]
    print(f"[fleet] python -m ntxent_tpu_torch.fleet_cli, {FLEET_WORKERS} "
          f"workers of ViT-B/16 flash 224 px (buckets 1/4/16/64) on run A's "
          f"steps, {FLEET_CLIENTS} clients of 1-8 rows from a pool of "
          f"{FLEET_ROW_POOL}: {len(answers)} answers {statuses}, "
          f"{len(ok)} 200 by step {by_step}, max|err| vs each step's "
          f"direct forward {worst:.2e}; killworker: w0 ready again "
          f"{restart_ms:.0f} ms after its death was seen; "
          f"drainworker: {drain['worker']} drained in {drain['drain_ms']:.0f}"
          f" ms to zero in flight, then retired; promote of step {newer} "
          f"{(marks['promoted'] - marks['publish_newer']) * 1e3:.0f} ms after "
          f"it landed ({promote_verdict['reason']}, drift p99 "
          f"{promote_verdict.get('drift_p99')} over "
          f"{promote_verdict.get('drift_samples')} rows, "
          f"{promote_verdict['requests']} canary outcomes); rollback of the "
          f"negated step {bad} "
          f"{(marks['rolled_back'] - marks['publish_bad']) * 1e3:.0f} ms "
          f"after it landed (drift p99 {rollback_verdict.get('drift_p99')}"
          f"), blocked on {sorted(blocked)}; cache: {cache['hits']} row "
          f"hits, {final['cache_only_responses']} cache-only answers "
          f"({bitwise} bit for bit a worker's), flushed on the promote, "
          f"{final['cache_warmed']} of {warms[0]['rows']} hot rows warmed "
          f"(the rest answered by the laggard); router latency p50/p99 "
          f"total "
          f"{router_lat['total']['p50_ms']:.1f}/"
          f"{router_lat['total']['p99_ms']:.1f} ms, forward "
          f"{router_lat['forward']['p50_ms']:.1f}/"
          f"{router_lat['forward']['p99_ms']:.1f} ms, w0's own total "
          f"{worker_lat['p50_ms']:.1f}/{worker_lat['p99_ms']:.1f} ms "
          f"(added by the router: p50 "
          f"{router_lat['total']['p50_ms'] - worker_lat['p50_ms']:.1f} ms, "
          f"p99 {router_lat['total']['p99_ms'] - worker_lat['p99_ms']:.1f}"
          f" ms); "
          f"client latency p50 {lat[len(lat) // 2]:.1f} ms, p99 "
          f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.1f} ms; "
          f"{rows_s:.2f} rows/s over 2 workers (JSON bodies, client clock); "
          f"merged trace of {n_events} events in {len(lanes)} lanes, "
          f"{len(lost)} forwarded answers lost with w0's SIGKILLed log; "
          f"history {len(reopened.series_names())} series reopened; "
          f"flash_attention_fwd {launches} launches = 12 x (chunks + first "
          f"runs) in {sorted(r['worker'] for r in reports)}; |first - "
          f"newer| {float(np.abs(refs['first'] - refs['newer']).max()):.2e}"
          f"; SIGTERM: exit "
          f"0 in {(marks['exited'] - marks['sigterm']):.1f} s, no worker "
          f"left; on {card_line}; phase {time.monotonic() - t0:.1f} s",
          flush=True)
    print("[fleet] timeline (s from the router's start): " + ", ".join(
        f"{k} {v - marks['start']:.1f}" for k, v in marks.items()),
          flush=True)
    r = retrieval
    print(f"[fleet-retrieval] --index-mem and 2 supervised shard processes "
          f"(--shard-procs, a journal), {FLEET_INDEX_LISTS} lists all "
          f"probed, in the same fleet run, over {FLEET_RETRIEVAL_ROWS} "
          f"rows of its own: {r['answers']} answers "
          f"{r['statuses']}, {r['stores']} stores ({r['gated']} gated "
          f"not_trusted, all in a rollout window), {r['searches']} "
          f"searches (k {FLEET_SEARCH_K}), {r['checked']} on a whole plane "
          f"held to the brute-force top k of each step's direct forward "
          f"({r['exact']} id for id, the rest within {r['tol']:.2e}), the "
          f"row itself first; search p50/p99 {r['search_ms'][0]:.1f}/"
          f"{r['search_ms'][1]:.1f} ms, insert p50/p99 "
          f"{r['insert_ms'][0]:.1f}/{r['insert_ms'][1]:.1f} ms (client "
          f"clock); promote of step {newer}: the index's version active "
          f"with the docstore re-embedded {r['index_active_ms']:.0f} ms "
          f"after the index's promote (rebuild {r['rebuild_ms']:.0f} ms, "
          f"{r['rebuild_rows']} rows); killshard: {r['degraded']} of "
          f"{r['outage']} searches during the outage degraded (all 200), "
          f"journal depth up to {r['depth']} rows at the restart, "
          f"{r['repaired']} rows redelivered, every one of "
          f"{r['healed_rows']} stored rows its own first hit "
          f"{restored_ms:.0f} ms after the death (again for "
          f"{r['final_rows']} rows at the end); no libtorch in the router "
          f"nor the shards; on {card_line}", flush=True)
    if time.monotonic() - t0 > FLEET_BUDGET_S:
        print(f"[fleet] over its {FLEET_BUDGET_S:.0f} s budget", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return launches


# [retrieval-scale] (ROADMAP Queue A 12(b)), host only: the retrieval tier
# at a size its users run. The JAX package's own committed corpus
# (``bench.py``'s retrieval arm: 4,100,000 unit rows on a rank-16 manifold
# plus noise 0.05, ``VectorIndex(train_rows=16384, n_centroids=512,
# nprobe=48, pq_m=8, pq_rerank=4096, seal_rows=65536, compact_at=16)``,
# trained on a 32,768-row prefix, 128 held-out queries, 200 quiet
# searches, 4 searchers against a writer of 4,000 rows, here 64 searches
# each where ``bench.py`` makes 250) at the fleet's
# stored width 128 (``--proj-dim``), its rows cut from 4.1 M to 524,288
# for this script's time limit: 268 MB of float32 against 4 MB of 8-byte
# codes. Gates: ``bench.py``'s, recall@10 >= 0.95 against
# ``brute_force_topk`` and at most 1/8 of a raw row scanned (64 bytes).
# Then ``bench.py``'s repair arm on the port's shard plane: 3 in-process
# ``ShardServer``s, 24,576 + 8,192 rows of width 64, one shard stopped
# under a live insert stream and restarted empty on its port; the journal
# drains to zero and the self-hit probe is back to 1.0.
RS_ROWS, RS_DIM, RS_RANK, RS_NOISE = 524_288, 128, 16, 0.05
RS_TRAIN = 32_768
RS_INDEX = dict(train_rows=16_384, n_centroids=512, nprobe=48, pq_m=8,
                pq_rerank=4096, seal_rows=65_536, compact_at=16)
RS_QUERIES, RS_K, RS_RECALL = 128, 10, 0.95
RS_QUIET, RS_SEARCHERS, RS_SEARCHES, RS_LIVE = 200, 4, 64, 4_000
RS_REPAIR = dict(dim=64, shards=3, base=24_576, live=8_192)


def _ms_stats(values) -> str:
    return (f"p50 {_pct(values, 0.5):.2f} ms, p99 "
            f"{_pct(values, 0.99):.2f} ms")


def _repair_arm() -> dict:
    """``bench.py``'s ``_retrieval_repair_arm`` on the port."""
    from ntxent_tpu_torch.retrieval import ShardFanout, ShardServer

    dim, n_base, n_live = (RS_REPAIR[k] for k in ("dim", "base", "live"))

    def rows(n, seed):
        x = np.random.RandomState(seed).randn(n, dim).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    servers = [ShardServer(dim).start() for _ in range(RS_REPAIR["shards"])]
    ports = [s.port for s in servers]
    jdir = tempfile.mkdtemp(prefix="smoke-shard-journal-")
    fan = ShardFanout([s.url for s in servers], dim=dim, train_rows=2048,
                      n_centroids=32, nprobe=32, pq_m=8, journal_dir=jdir,
                      cooldown_s=0.2)
    try:
        fan.activate(100)
        base = rows(n_base, 1)
        for i in range(0, n_base, 2048):
            fan.insert(np.arange(i, min(i + 2048, n_base)), base[i:i + 2048])
        probe = base[:256]

        def self_hit():
            res = fan.search(probe, k=1)
            return float(np.mean(res["ids"][:, 0] == np.arange(256)))

        if self_hit() != 1.0:
            fail("retrieval-scale: the repair arm's self-hits before the "
                 "kill")
        servers[1].stop()
        live = rows(n_live, 2)
        for i in range(0, n_live, 1024):
            fan.insert(np.arange(n_base + i, n_base + min(i + 1024, n_live)),
                       live[i:i + 1024])
        degraded = fan.search(probe, k=1)["shards"]["degraded"]
        dead_hit, depth = self_hit(), fan.journal.depth(1)
        if not degraded or dead_hit >= 1.0 or depth < 1:
            fail(f"retrieval-scale: with shard 1 down: degraded {degraded},"
                 f" self-hits {dead_hit}, journal depth {depth}")
        servers[1] = ShardServer(dim, port=ports[1]).start()
        rep0, t0 = fan.repaired, time.perf_counter()
        drain_s = restored_s = None
        while time.perf_counter() - t0 < 120.0:
            fan.repair_tick()
            if sum(fan.journal.depths().values()) == 0:
                drain_s = time.perf_counter() - t0
                break
        while drain_s is not None and time.perf_counter() - t0 < 120.0:
            if self_hit() >= 1.0:
                restored_s = time.perf_counter() - t0
                break
            fan.repair_tick()
        if drain_s is None or restored_s is None or fan.dropped:
            fail(f"retrieval-scale: the repair arm: drained in {drain_s} s,"
                 f" recall restored in {restored_s} s, {fan.dropped} "
                 "dropped")
        return dict(rows=n_base + n_live, depth=depth, dead_hit=dead_hit,
                    repaired=fan.repaired - rep0, drain_s=drain_s,
                    restored_s=restored_s)
    finally:
        fan.close()
        for s in servers:
            s.stop()
        shutil.rmtree(jdir, ignore_errors=True)


def phase_retrieval_scale(card_line: str) -> None:
    """The port's ``VectorIndex`` at RS_ROWS rows of width RS_DIM, then
    the repair arm; host only (the retrieval tier holds no card)."""
    from ntxent_tpu_torch.retrieval import VectorIndex, brute_force_topk

    t_phase = time.monotonic()
    proj = np.random.RandomState(0).randn(RS_RANK, RS_DIM).astype(np.float32)

    def make(n, seed):
        r = np.random.RandomState(seed)
        x = r.randn(n, RS_RANK).astype(np.float32) @ proj \
            + RS_NOISE * r.randn(n, RS_DIM).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    base = make(RS_ROWS, 1)
    idx = VectorIndex(RS_DIM, **RS_INDEX)
    t0 = time.perf_counter()
    idx.insert(np.arange(RS_TRAIN), base[:RS_TRAIN])
    idx.maintain()  # trains on the prefix: centroids and PQ codebooks
    if not idx.trained:
        fail("retrieval-scale: the index did not train on its prefix")
    for i in range(RS_TRAIN, RS_ROWS, 8192):
        idx.insert(np.arange(i, min(i + 8192, RS_ROWS)), base[i:i + 8192])
        if (i - RS_TRAIN) % 65_536 == 0:
            idx.maintain()  # the seal cadence
    while idx.maintain():
        pass
    build_s = time.perf_counter() - t0
    scanned = idx.scan_bytes_per_row()
    queries = make(RS_QUERIES, 2)
    ann_ids, _ = idx.search(queries, k=RS_K)
    ids_all, vecs_all = idx.store.all_rows()
    exact_ids, _ = brute_force_topk(queries, ids_all, vecs_all, RS_K)
    recall = float(np.mean([len(set(a) & set(e)) / RS_K for a, e in zip(
        ann_ids.tolist(), exact_ids.tolist())]))
    if recall < RS_RECALL or scanned > RS_DIM * 4 / 8:
        fail(f"retrieval-scale: recall@{RS_K} {recall:.4f} (at least "
             f"{RS_RECALL}), {scanned:.2f} bytes a row scanned (at most "
             f"{RS_DIM * 4 / 8:.0f})")
    brute = []
    for q in queries[:32]:
        t = time.perf_counter()
        brute_force_topk(q, ids_all, vecs_all, RS_K)
        brute.append((time.perf_counter() - t) * 1e3)
    del ids_all, vecs_all

    def searches(n, seed, out):
        qs = make(n, 100 + seed)
        for i in range(n):
            t = time.perf_counter()
            idx.search(qs[i], k=RS_K)
            out.append((time.perf_counter() - t) * 1e3)

    quiet = []
    searches(RS_QUIET, 3, quiet)
    live, stop = make(RS_LIVE, 4), threading.Event()

    def writer():
        i = 0
        while i < RS_LIVE and not stop.is_set():
            j = min(i + 256, RS_LIVE)
            idx.insert(np.arange(RS_ROWS + i, RS_ROWS + j), live[i:j])
            i = j
            idx.maintain()

    series = [[] for _ in range(RS_SEARCHERS)]
    threads = [threading.Thread(target=searches,
                                args=(RS_SEARCHES, 10 + s, series[s]))
               for s in range(RS_SEARCHERS)]
    w = threading.Thread(target=writer)
    t0 = time.perf_counter()
    for th in (w, *threads):
        th.start()
    for th in threads:
        th.join()
    stop.set()
    w.join()
    busy_s = time.perf_counter() - t0
    concurrent = [v for s in series for v in s]
    resident_mb = idx.resident_bytes() / 2**20
    rows = idx.rows
    del idx, base
    repair = _repair_arm()
    print(f"[retrieval-scale] the port's VectorIndex (host only, numpy) at "
          f"{RS_ROWS} rows of width {RS_DIM} (bench.py's rank-16 corpus, "
          f"its rows cut from 4,100,000 for the time limit), 512 lists, "
          f"nprobe 48, PQ m 8, re-rank 4096: built at "
          f"{RS_ROWS / build_s:.1f} rows/s ({build_s:.1f} s); recall@"
          f"{RS_K} {recall:.4f} on {RS_QUERIES} held-out queries against "
          f"brute force; {scanned:.2f} bytes a row scanned of "
          f"{RS_DIM * 4} raw; resident {resident_mb:.1f} MB; quiet "
          f"{_ms_stats(quiet)} ({RS_QUIET} searches); {RS_SEARCHERS} "
          f"searchers against a writer of {RS_LIVE} rows: "
          f"{_ms_stats(concurrent)}, {len(concurrent) / busy_s:.1f} "
          f"searches/s, {rows} rows at the end; brute force "
          f"{_ms_stats(brute)}; repair arm ({RS_REPAIR['shards']} shards, "
          f"{repair['rows']} rows of width {RS_REPAIR['dim']}): shard 1 down"
          f" under {RS_REPAIR['live']} inserted rows, self-hits "
          f"{repair['dead_hit']:.4f}, journal depth {repair['depth']} at the"
          f" restart, {repair['repaired']} rows redelivered in "
          f"{repair['drain_s'] * 1e3:.1f} ms "
          f"({repair['repaired'] / repair['drain_s']:.1f} rows/s), "
          f"self-hits 1.0 again {repair['restored_s'] * 1e3:.1f} ms after "
          f"the restart; host of {card_line}; phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)


def phase_accum_lag(card_line: str) -> dict:
    """--accum-steps 2 --lag-metrics --nan-policy skip against the same run
    without --lag-metrics; returns the lagged run's launches a step."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import MultiSteps
    from ntxent_tpu_torch.training.lars import LARS
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    # the device fold divides as step() does (CUDA: a product with the
    # float32 reciprocal of a host scalar), at every n of k = 7
    g = torch.Generator().manual_seed(31)
    params = {"w": torch.randn(1 << 20, generator=g).to(SMOKE_DEVICE)}
    grads = [torch.randn(1 << 20, generator=g).to(SMOKE_DEVICE)
             for _ in range(6)]
    sync = MultiSteps(LARS(dict(params), lambda c: 0.1), 7)
    kept = MultiSteps(LARS({"w": params["w"].clone()}, lambda c: 0.1), 7)
    ok = torch.ones((), dtype=torch.bool, device=SMOKE_DEVICE)
    for grad in grads:
        sync.params["w"].grad = grad.clone()
        sync.step()
        kept.params["w"].grad = grad.clone()
        kept.step_kept(ok)
        if not torch.equal(sync.acc["w"], kept.acc["w"]):
            fail(f"accum-lag: the device fold differs from step()'s at "
                 f"n = {sync.mini_step}")
    counters = launch_counters()
    chaos = ["--accum-steps", "2", "--nan-policy", "skip", "--chaos",
             f"nan@{ACCUM_LAG_NAN_AT}", "--steps", str(ACCUM_LAG_STEPS)]
    results, launches = {}, {}
    for label, extra in (("lagged", ["--lag-metrics"]), ("guarded", [])):
        for wrapper in counters.values():
            wrapper.launches = 0
        with _LogTap() as tap:
            state, history = cli.train(cli.build_train_parser().parse_args(
                _with_flags(TRAIN_ARGV, *chaos) + extra))
        launches[label] = {n: w.launches for n, w in counters.items()}
        named = tap.having(f"non-finite step {ACCUM_LAG_NAN_AT} skipped")
        losses = [h["loss"] for h in history]
        if [math.isfinite(v) for v in losses] != [
                i + 1 != ACCUM_LAG_NAN_AT for i in range(ACCUM_LAG_STEPS)] \
                or not named:
            fail(f"accum-lag {label}: losses {losses}, log {named}")
        opt = state.optimizer
        results[label] = (_state_crc(state), opt.gradient_step,
                          opt.mini_step, opt.count, _step_ms(history))
        del state, opt
        torch.cuda.empty_cache()
    want = {n: STEP_LAUNCHES.get(n, 0) * ACCUM_LAG_STEPS for n in counters}
    lag, sync_r = results["lagged"], results["guarded"]
    pct = 100 * (lag[4] / sync_r[4] - 1)
    if lag[:4] != sync_r[:4] or launches["lagged"] != want:
        fail(f"accum-lag: lagged {lag[:4]}, guarded {sync_r[:4]}; launches "
             f"{launches['lagged']} (expected {want})")
    rounds = _accum_lag_rounds()
    mean = {n: sum(v) / len(v) for n, v in rounds.items()}
    print(f"[accum-lag] ViT-B/16 batch 256 --accum-steps 2 --nan-policy "
          f"skip --chaos nan@{ACCUM_LAG_NAN_AT}, {ACCUM_LAG_STEPS} steps: "
          f"with --lag-metrics ends at (size, crc32) {lag[0]}, gradient_step "
          f"{lag[1]}, mini_step {lag[2]}, inner count {lag[3]}, bit for bit "
          f"where the synchronous guard ends; the device fold equals "
          f"step()'s at n = 1..6; the CLI runs' step ms (mean of the steady "
          f"records, synthetic views made on the host) lagged {lag[4]:.3f},"
          f" guarded {sync_r[4]:.3f} ({pct:+.2f}%); in turns, rounds of "
          f"{GUARD_TIMED_STEPS} train_loop steps on batches on the card "
          f"{'/'.join(ACCUM_LAG_ROUNDS)}: guarded (the inner update on the "
          f"k-th micro-step only, a host sync a step) "
          f"{'/'.join(f'{v:.3f}' for v in rounds['guarded'])}, lagged (the "
          f"inner update every micro-step, kept by a select, nothing read "
          f"on the host) {'/'.join(f'{v:.3f}' for v in rounds['lagged'])} "
          f"ms a step, mean {mean['guarded']:.3f} against "
          f"{mean['lagged']:.3f} "
          f"({100 * (mean['lagged'] / mean['guarded'] - 1):+.2f}%), both "
          f"ending at one params crc32; {STEP_LAUNCHES} launches a step; on "
          f"{card_line}; phase {time.monotonic() - t0:.1f} s", flush=True)
    return {n: v // ACCUM_LAG_STEPS for n, v in launches["lagged"].items()}


def _accum_lag_rounds() -> dict:
    """The synchronous and the lag-1 guard under --accum-steps 2, in turns
    (ACCUM_LAG_ROUNDS of GUARD_TIMED_STEPS train_loop steps on the same
    batches); returns each one's ms a step, round by round."""
    import torch

    from ntxent_tpu_torch.resilience import DivergenceGuard
    from ntxent_tpu_torch.training import make_train_step, train_loop

    args, cfg, states, pipe = _simclr_setup(_with_flags(
        TRAIN_ARGV, "--accum-steps", "2"))
    batches = [next(pipe) for _ in range(GUARD_TIMED_STEPS)]
    step = make_train_step(cfg.temperature, guard=True)
    runs = dict(zip(("guarded", "lagged"), states))

    def run(name, steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_loop(runs[name], iter(batches[:steps]), step, steps,
                   log_every=steps, log=False, metrics_lag=int(
                       name == "lagged"), step_guard=DivergenceGuard(
                       backoff_after=None, rollback_after=None))
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    for name in runs:  # first calls: libraries, the snapshot buffers
        run(name, 2)
    ms = {name: [] for name in runs}
    for name in ACCUM_LAG_ROUNDS:
        ms[name].append(run(name, GUARD_TIMED_STEPS))
    crcs = {name: _params_crc(state.model) for name, state in runs.items()}
    if len(set(crcs.values())) != 1:
        fail(f"accum-lag rounds: params crc32 {crcs}")
    del runs, states, batches
    torch.cuda.empty_cache()
    return ms


class _LogTap:
    """Collect the messages of every log record emitted inside the block
    (the supervisor's, the guard's and the checkpoint manager's)."""

    def __enter__(self):
        import logging

        self.messages = []
        self._handler = logging.Handler()
        self._handler.emit = lambda r: self.messages.append(r.getMessage())
        root = logging.getLogger()
        self._level = root.level
        root.setLevel(min(self._level or logging.INFO, logging.INFO))
        root.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        import logging

        root = logging.getLogger()
        root.removeHandler(self._handler)
        root.setLevel(self._level)

    def having(self, *parts: str) -> list[str]:
        return [m for m in self.messages if all(p in m for p in parts)]


def _state_crc(state) -> list:
    """[size, crc32] of the state.msgpack a save of ``state`` would write
    (the bytes the manifests record), computed in memory."""
    import zlib

    from ntxent_tpu_torch.training.checkpoint import snapshot_state
    from ntxent_tpu_torch.utils import msgpack

    size, crc = 0, 0

    def write(piece):
        nonlocal size, crc
        size += len(piece)
        crc = zlib.crc32(piece, crc)

    msgpack.pack(snapshot_state(state).state_dict, write)
    return [size, crc]


def _params_crc(model) -> int:
    import zlib

    crc = 0
    for p in model.parameters():
        crc = zlib.crc32(p.detach().float().cpu().numpy().tobytes(), crc)
    return crc


def _tensors(state) -> list:
    """Clones of the parameters, the momentum and the running statistics."""
    from ntxent_tpu_torch.models import BatchNorm

    out = [p.detach().clone() for p in state.model.parameters()]
    out += [t.clone() for t in state.optimizer.trace.values()]
    return out + [b.clone() for m in state.model.modules()
                  if isinstance(m, BatchNorm)
                  for b in (m.running_mean, m.running_var)]


def _max_rel(got, want) -> float:
    """The largest |a - b| over the largest |b| across tensor pairs."""
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    scale = max(float(b.float().abs().max()) for b in want)
    return err / max(scale, 1e-30)


def _simclr_setup(argv, copies: int = 2):
    """(args, ``copies`` states from the same weights of seed 0, batches)
    of the SimCLR path at ``argv``'s width on the card."""
    import copy

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import create_train_state

    args = cli.build_train_parser().parse_args(argv)
    args.image_size = args.image_size or 32
    cfg = cli._train_config(args)
    model = cli.build_model(args)
    device = torch.device(args.device)
    states = [create_train_state(copy.deepcopy(model), cfg, device)
              for _ in range(copies - 1)]
    states.append(create_train_state(model, cfg, device))
    return args, cfg, states, cli._make_pipeline(args, device)


def phase_guard(card_line: str) -> dict:
    """The divergence guard on the SimCLR path; returns the guarded
    step's launches a step."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import make_train_step
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    args, cfg, (plain, guarded), pipe = _simclr_setup(TRAIN_ARGV)
    batches = [next(pipe) for _ in range(1 + GUARD_TIMED_STEPS)]
    pstep = make_train_step(cfg.temperature)
    gstep = make_train_step(cfg.temperature, guard=True)
    plain, pm = pstep(plain, *batches[0])
    guarded, gm = gstep(guarded, *batches[0], 1.0)
    crcs = (_params_crc(plain.model), _params_crc(guarded.model))
    # the guarded step's metrics are host copies: compare the values
    if crcs[0] != crcs[1] or float(pm["loss"]) != float(gm["loss"]) \
            or not bool(gm["step_ok"]):
        fail(f"guarded step at scale 1: params crc32 {crcs[1]:#010x}, loss "
             f"{float(gm['loss'])}; the plain step's {crcs[0]:#010x}, "
             f"{float(pm['loss'])}")
    before, count, step = _tensors(guarded), guarded.optimizer.count, \
        guarded.step
    v1, v2 = batches[1]
    guarded, nm = gstep(guarded, torch.full_like(v1, float("nan")), v2, 1.0)
    kept = all(torch.equal(a, b) for a, b in zip(_tensors(guarded), before))
    if bool(nm["step_ok"]) or not kept or guarded.optimizer.count != count \
            or guarded.step != step + 1:
        fail(f"a NaN batch: step_ok {bool(nm['step_ok'])}, state kept bit "
             f"for bit {kept}, count {guarded.optimizer.count} (was {count}),"
             f" step {guarded.step} (was {step})")
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    runs = {"plain": [pstep, plain, ()], "guarded": [gstep, guarded, (1.0,)]}
    ms = {"plain": [], "guarded": []}
    for name in GUARD_ROUNDS:
        step_fn, state, extra = runs[name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for batch in batches[1:]:
            state, metrics = step_fn(state, *batch, *extra)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t) * 1e3 / GUARD_TIMED_STEPS)
        runs[name][1] = state
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            fail(f"the {name} steps' loss {loss}")
    plain, guarded = runs["plain"][1], runs["guarded"][1]
    steps = len(GUARD_ROUNDS) * GUARD_TIMED_STEPS
    launches = {n: w.launches for n, w in counters.items()}
    want = {n: STEP_LAUNCHES.get(n, 0) * steps for n in counters}
    if launches != want:
        fail(f"guard: launches over {steps} plain and guarded steps "
             f"{launches}, expected {want}")
    mean = {n: sum(v) / len(v) for n, v in ms.items()}
    # the host time of one LARS update's launches, which both steps queue
    # behind the backward (the guarded one reads ok after queueing it)
    torch.cuda.synchronize()
    t = time.perf_counter()
    guarded.optimizer.step()
    lars_host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    del plain, guarded, batches
    torch.cuda.empty_cache()
    print(f"[guard] ViT-B/16 batch {args.batch}: a guarded step at scale 1 "
          f"equals the plain step (params crc32 {crcs[0]:#010x}, loss "
          f"{float(pm['loss']):.6f}); a NaN batch kept the parameters, "
          f"momentum, count {count} and running statistics bit for bit, "
          f"step {step} -> {step + 1}, step_ok false, grad_norm "
          f"{float(nm['grad_norm'])}; rounds of {GUARD_TIMED_STEPS} steps "
          f"back to back, {'/'.join(GUARD_ROUNDS)}: ms a step plain "
          f"{'/'.join(f'{v:.3f}' for v in ms['plain'])}, guarded "
          f"{'/'.join(f'{v:.3f}' for v in ms['guarded'])}; mean plain "
          f"{mean['plain']:.3f}, guarded {mean['guarded']:.3f} "
          f"({mean['guarded'] - mean['plain']:+.3f} ms, "
          f"{100 * (mean['guarded'] / mean['plain'] - 1):+.2f}%: the "
          f"per-step host sync, host clock; one LARS update's launches take "
          f"{lars_host_ms:.3f} ms of host); launches a step "
          f"{ {n: c // steps for n, c in launches.items() if c} }"
          f" for both on {card_line}", flush=True)
    with _LogTap() as tap:
        state, history = cli.train(cli.build_train_parser().parse_args(
            _with_flags(TRAIN_ARGV, *GUARD_CHAOS[:2]) + GUARD_CHAOS[2:]))
    backoffs = tap.having("scale backed off to 0.5")
    skips = tap.having("divergence guard: non-finite step")
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.model.parameters())
    if state.step != 5 or not backoffs or len(skips) != 2 or not finite:
        fail(f"train {' '.join(GUARD_CHAOS)}: step {state.step}, skips "
             f"{skips}, backoff {backoffs}, finite params {finite}")
    print(f"[guard] train {' '.join(GUARD_CHAOS)}: 2 steps skipped, then "
          f"'{backoffs[0]}'; losses "
          f"{[round(h['loss'], 4) for h in history]}, every parameter "
          f"finite; phase {time.monotonic() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    return {n: c // steps for n, c in launches.items()}


def phase_remat(card_line: str) -> dict:
    """--remat against the plain step on the SimCLR path; returns the
    remat step's launches a step."""
    import torch

    from ntxent_tpu_torch.training import make_train_step
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    args, cfg, states, pipe = _simclr_setup(TRAIN_ARGV)
    batches = [next(pipe) for _ in range(REMAT_STEPS)]
    counters = launch_counters()
    runs = {}
    for remat, state in zip((False, True), states):
        step = make_train_step(cfg.temperature, remat=remat)
        for wrapper in counters.values():
            wrapper.launches = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # neither run inherits the other's blocks
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for batch in batches:
            t = time.perf_counter()
            state, metrics = step(state, *batch)
            losses.append(metrics["loss"].clone())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        runs[remat] = dict(
            losses=losses, ms=ms, peak=torch.cuda.max_memory_allocated(),
            params=[p.detach() for p in state.model.parameters()],
            launches={n: w.launches for n, w in counters.items()})
    want = {n: REMAT_STEP_LAUNCHES.get(n, 0) * REMAT_STEPS for n in counters}
    if runs[True]["launches"] != want:
        fail(f"remat: launches over {REMAT_STEPS} steps "
             f"{runs[True]['launches']}, expected {want}")
    pairs = list(zip(runs[True]["losses"] + runs[True]["params"],
                     runs[False]["losses"] + runs[False]["params"]))
    exact = all(torch.equal(a, b) for a, b in pairs)
    rel = 0.0 if exact else _max_rel(*zip(*pairs))
    if rel > REMAT_RTOL:
        fail(f"remat: loss and params {rel:.3e} of their largest magnitude "
             f"from the plain step's (gate {REMAT_RTOL:g})")
    warm = {r: runs[r]["ms"][1:] for r in runs}
    warm = {r: sum(v) / len(v) for r, v in warm.items()}
    print(f"[remat] ViT-B/16 batch {args.batch}, {REMAT_STEPS} steps: loss "
          f"and params {'equal bit for bit' if exact else f'within {rel:.3e}'}"
          f" of the plain step's (losses "
          f"{[round(float(x), 6) for x in runs[True]['losses']]}); step ms "
          f"plain {_ms(runs[False]['ms'])}, remat {_ms(runs[True]['ms'])} "
          f"(host clock, synchronized; step 1 includes first-call costs); "
          f"steps 2-{REMAT_STEPS} mean plain {warm[False]:.3f}, remat "
          f"{warm[True]:.3f} ({100 * (warm[True] / warm[False] - 1):+.2f}%); "
          f"peak memory plain "
          f"{runs[False]['peak'] / 2**30:.2f} GiB, remat "
          f"{runs[True]['peak'] / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated, both states resident); "
          f"launches a step "
          f"{ {n: c // REMAT_STEPS for n, c in runs[True]['launches'].items() if c} }"
          f" on {card_line}; phase {time.monotonic() - t0:.1f} s", flush=True)
    del states, runs, pairs, batches
    torch.cuda.empty_cache()
    return {n: c // REMAT_STEPS for n, c in want.items()}


def phase_remat_dp() -> None:
    """Data-parallel ResNet-50 at world 1 with --remat: the running
    statistics as the plain run's."""
    import torch

    from ntxent_tpu_torch import cli

    t0 = time.monotonic()
    argv = _with_flags(DP_ARGV, "--steps", str(REMAT_DP_STEPS))
    stats = []
    for flags in ([], ["--remat"]):
        state, _ = cli.train(cli.build_train_parser().parse_args(
            argv + flags), data_parallel=True)
        stats.append([b.clone() for n, b in state.model.named_buffers()
                      if "running" in n])
        del state
        torch.cuda.empty_cache()
    exact = all(torch.equal(a, b) for a, b in zip(*stats))
    rel = 0.0 if exact else _max_rel(stats[1], stats[0])
    if rel > REMAT_RTOL:
        fail(f"data-parallel --remat: running statistics {rel:.3e} from the "
             f"plain run's (gate {REMAT_RTOL:g})")
    print(f"[remat] data-parallel ResNet-50 (NCCL world 1) --remat, "
          f"{REMAT_DP_STEPS} steps: {len(stats[0])} running statistics "
          f"{'equal bit for bit' if exact else f'within {rel:.3e}'} to the "
          f"plain run's (one update a step); phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def phase_accum(tmp: str, card_line: str) -> None:
    """--accum-steps ACCUM_K resumed mid-accumulation equals the
    uninterrupted run, SimCLR and CLIP."""
    import torch

    from ntxent_tpu_torch import cli

    for label, argv in (("SimCLR", TRAIN_ARGV), ("CLIP", CLIP_ARGV)):
        t0 = time.monotonic()
        base = _with_flags(argv, "--accum-steps", str(ACCUM_K))
        state, _ = cli.train(cli.build_train_parser().parse_args(
            _with_flags(base, "--steps", str(ACCUM_STEPS))))
        want = _state_crc(state)
        del state
        torch.cuda.empty_cache()
        directory = f"{tmp}/accum_{label}"
        part, _, stats_1 = _train_ckpt(_ckpt_argv(
            base, directory, ACCUM_FIRST, every=ACCUM_FIRST, keep=1))
        mini = part.optimizer.mini_step
        del part
        state, hist, stats_2 = _train_ckpt(_ckpt_argv(
            base, directory, ACCUM_STEPS, every=ACCUM_FIRST, keep=1))
        got = _manifest_crcs(directory)[ACCUM_STEPS]
        opt = state.optimizer
        if mini != ACCUM_FIRST % ACCUM_K or got != want \
                or [h["step"] for h in hist] != [ACCUM_STEPS] \
                or opt.gradient_step != ACCUM_STEPS // ACCUM_K:
            fail(f"{label} --accum-steps {ACCUM_K}: saved at mini_step "
                 f"{mini}, resumed to step {ACCUM_STEPS} at (size, crc32) "
                 f"{got}, the uninterrupted run's {want}; gradient_step "
                 f"{opt.gradient_step}")
        print(f"[accum] {label} ViT-B/16 batch 256 --accum-steps {ACCUM_K}: "
              f"{ACCUM_FIRST} steps saved at mini_step {mini}, relaunched to "
              f"{ACCUM_STEPS} (gradient_step {opt.gradient_step}, inner "
              f"count {opt.count}): (size, crc32) {got}, equal to the "
              f"uninterrupted run's; save ms "
              f"{_ms(stats_1['save_ms'] + stats_2['save_ms'])}, restore ms "
              f"{_ms(stats_2['restore_ms'])} on {card_line}; phase "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        del state, opt
        torch.cuda.empty_cache()
        shutil.rmtree(directory)


def phase_supervise(tmp: str, crc_a: dict) -> None:
    """Run A's flags under the supervisor with SUPERVISE_FLAGS: it ends at
    run A's step-RESUME_STEPS CRC."""
    import torch

    t0 = time.monotonic()
    directory = f"{tmp}/supervise"
    with _LogTap() as tap:
        state, _, stats = _train_ckpt(_ckpt_argv(
            TRAIN_ARGV, directory, RESUME_STEPS) + SUPERVISE_FLAGS)
    died = tap.having("supervisor: attempt 1/2 died")
    fallback = tap.having("corrupt in every replica")
    resumed = tap.having("resumed from checkpoint at step")
    done = tap.having("run complete at step")
    if state.step != RESUME_STEPS or not died or not fallback \
            or resumed != ["resumed from checkpoint at step 2"] or not done:
        fail(f"supervised run: step {state.step}; logs {died} {fallback} "
             f"{resumed} {done}")
    _same_crc("supervised run", crc_a, _manifest_crcs(directory),
              (RESUME_STEPS,))
    print(f"[supervise] ViT-B/16 batch 256 {' '.join(SUPERVISE_FLAGS)} "
          f"--ckpt-every {RESUME_EVERY} --steps {RESUME_STEPS}: attempt 1 "
          f"died ('{died[0].split(' died')[0]}', ChaosError at batch 5); "
          f"'{fallback[0]}'; attempt 2 {resumed[0]}; '{done[0]}': step "
          f"{RESUME_STEPS} equal to run A's by (size, crc32) "
          f"{crc_a[RESUME_STEPS]}; restore ms {_ms(stats['restore_ms'])}; "
          f"phase {time.monotonic() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(directory)
    _supervise_stall(tmp)


class _Held:
    """The batches of ``inner``, the ``at``-th held ``hold_s`` first (a
    wedged input pipeline)."""

    def __init__(self, inner, at: int, hold_s: float):
        self.inner, self.at, self.hold_s, self.n = inner, at, hold_s, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n == self.at:
            time.sleep(self.hold_s)
        return next(self.inner)


def _supervise_stall(tmp: str) -> None:
    """Phase 5's command for RESUME_STEPS steps with SUPERVISE_STALL_FLAGS
    and --log-jsonl, the SUPERVISE_STALL_AT-th batch held
    SUPERVISE_STALL_HOLD_S: the stall escalation dumps the flight recorder
    into the log's directory (the tail of the run's events) and the
    restart, from step 0 (no --ckpt-dir), ends at RESUME_STEPS."""
    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.obs.events import read_events
    from ntxent_tpu_torch.training import create_train_state, make_train_step

    t0 = time.monotonic()
    root = f"{tmp}/supervise_stall"
    args = cli.build_train_parser().parse_args(
        _with_flags(TRAIN_ARGV, "--steps", str(RESUME_STEPS))
        + SUPERVISE_STALL_FLAGS + ["--log-jsonl", f"{root}/run.jsonl"])
    device = torch.device(args.device)
    cfg = cli._train_config(args)

    def fresh():
        return create_train_state(cli.build_model(args), cfg, device)

    telemetry = cli._setup_observability(args)
    try:
        state, _ = cli._fit(
            args, fresh(), _Held(cli._make_pipeline(args, device),
                                 SUPERVISE_STALL_AT, SUPERVISE_STALL_HOLD_S),
            make_train_step(cfg.temperature), {}, state_factory=fresh,
            timeline=telemetry.timeline)
    finally:
        telemetry.close()
    dumps = {}
    for name in os.listdir(root):
        if name.startswith("flight_"):
            header, *records = read_events(f"{root}/{name}")
            dumps[header["reason"].split(":")[0]] = (header, records)
    stall = dumps.get("stall")
    steps = [r["step"] for r in (stall[1] if stall else [])
             if r["event"] == "step"]
    restarts = read_events(f"{root}/run.jsonl", "restart")
    if state.step != RESUME_STEPS or stall is None \
            or steps != list(range(1, SUPERVISE_STALL_AT)) \
            or len(restarts) != 1 or not restarts[0]["stalled"]:
        fail(f"supervised stall: step {state.step}; flight dumps "
             f"{ {k: v[0] for k, v in dumps.items()} }, the stall's step "
             f"events {steps}; restart events {restarts}")
    print(f"[supervise] ViT-B/16 batch 256 {' '.join(SUPERVISE_STALL_FLAGS)}"
          f" --log-jsonl, batch {SUPERVISE_STALL_AT} held "
          f"{SUPERVISE_STALL_HOLD_S} s: "
          f"'{stall[0]['reason']}' flight dump of the last "
          f"{stall[0]['records']} events (step events {steps}, beside "
          f"{sorted(dumps)}), one restart event (stalled, at step "
          f"{restarts[0]['end_step']}), attempt 2 from step 0 to step "
          f"{state.step}; phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(root)


def phase_crash_audit(tmp: str, card_line: str) -> None:
    """CrashAudit of the single-card ResNet-50 SimCLR path on the card, one
    child process at a time."""
    import gc

    import torch

    from ntxent_tpu_torch.resilience.crashsim import (
        CrashAudit,
        CrashAuditError,
    )

    gc.collect()
    torch.cuda.empty_cache()
    workdir = f"{tmp}/audit"
    audit = CrashAudit(workdir, steps=AUDIT_STEPS, timeout_s=CHILD_TIMEOUT_S,
                       **AUDIT_MODEL)
    try:
        report = audit.audit(kills=AUDIT_KILLS, midsave=AUDIT_MIDSAVE,
                             lineages=1, workers=1)
    except CrashAuditError as e:
        fail(f"crash audit: {e}")
    rounds = [(r["kill_at"], r["midsave"], len(r["tmp"]))
              for r in report.rounds]
    print(f"[crash-audit] ResNet-50 SimCLR --image-size 224 --batch 256, "
          f"{AUDIT_STEPS} steps, --ckpt-every 1 --async-ckpt, children of "
          f"python -m ntxent_tpu_torch.cli train on the card: "
          f"{report.kills} SIGKILLs (kill step, mid-save, staging dirs) "
          f"{rounds}, {report.completed_early} runs that ended before their "
          f"kill, no torn step; survivor {report.survivor_fingerprint} "
          f"equal to the reference's; {report.elapsed_s} s on {card_line}",
          flush=True)
    shutil.rmtree(workdir)

def _data_argv(store: str, way: str) -> list:
    return _with_flags(TRAIN_ARGV, "--dataset", "npy", "--data-dir", store,
                       "--steps", str(DATA_STEPS)) + DATA_WAYS[way]


def _steady(history, key: str):
    """The mean of ``key`` over the log records (one a step) between the
    first step's and the last's: under --lag-metrics a record is written
    when its step's outcome is read, after the next step was queued, so
    the last record holds no step's queueing, only the wait for its
    step."""
    values = [h[key] for h in history[1:-1] if key in h]
    return sum(values) / len(values) if values else None


def _step_ms(history) -> float:
    """The mean step ms over the same records as ``_steady``."""
    return 1e3 * sum(1 / h["steps_per_sec"] for h in history[1:-1]) \
        / (len(history) - 2)


def phase_data(tmp: str, card_line: str):
    """The npy row store through both loaders and the three ways of
    DATA_WAYS; returns (the store, way c's checkpoint directory, the
    launches a step)."""
    import torch

    from ntxent_tpu_torch.training import (
        ArraySource,
        NativeStreamingLoader,
        StreamingLoader,
    )
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    store = f"{tmp}/rows.npy"
    np.save(store, np.random.default_rng(DATA_SEED).integers(
        0, 256, DATA_STORE, dtype=np.uint8))
    write_s = time.monotonic() - t0
    mm = np.load(store, mmap_mode="r")
    batch = int(TRAIN_ARGV[TRAIN_ARGV.index("--batch") + 1])
    loaders = {"native": NativeStreamingLoader(mm, batch),
               "python": StreamingLoader(ArraySource(mm), batch)}
    its = {name: iter(loader) for name, loader in loaders.items()}
    loader_ms = {name: 0.0 for name in its}
    for i in range(DATA_LOADER_BATCHES):
        got = {}
        for name, it in its.items():
            t = time.perf_counter()
            got[name] = next(it)
            loader_ms[name] += (time.perf_counter() - t) * 1e3
        if got["native"].shape != (batch, *DATA_STORE[1:]) \
                or not np.array_equal(got["native"], got["python"]):
            fail(f"data: batch {i} of the native loader differs from the "
                 "threaded loader's")
    for it in its.values():
        it.close()
    print(f"[data] store {DATA_STORE} uint8 ({mm.nbytes} bytes, "
          f"{DATA_STORE[0] // batch} batches of {batch} an epoch) written in "
          f"{write_s:.1f} s; the native and the threaded loader give the "
          f"same first {DATA_LOADER_BATCHES} batches byte for byte, across "
          f"the epoch boundary; ms a batch (the first holds the read-ahead "
          f"fill) native {loader_ms['native'] / DATA_LOADER_BATCHES:.1f}, "
          f"threaded {loader_ms['python'] / DATA_LOADER_BATCHES:.1f}",
          flush=True)
    del mm, loaders, its
    counters = launch_counters()
    ckpt = f"{tmp}/data_c"
    crcs, lines = {}, []
    for way in DATA_WAYS:
        argv = _data_argv(store, way)
        if way == "c":
            # saved at step 1 (an empty directory's first save, inside the
            # first step's record) and after the loop: no save in the
            # records of the later steps
            argv += ["--ckpt-dir", ckpt, "--ckpt-every", "1000"]
        for wrapper in counters.values():
            wrapper.launches = 0
        state, history, _ = _train_ckpt(argv)
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in counters.items()}
        want = {n: STEP_LAUNCHES.get(n, 0) * DATA_STEPS for n in counters}
        if launches != want or state.step != DATA_STEPS:
            fail(f"data way {way}: step {state.step}, launches {launches}, "
                 f"expected {want}")
        crcs[way] = _state_crc(state)
        step_ms = _step_ms(history)
        fetch = _steady(history, "fetch_ms")
        lines.append(
            f"way {way} ({' '.join(DATA_WAYS[way])}): step {step_ms:.3f} ms "
            f"(steps 2-{DATA_STEPS - 1}; {2 * batch * 1e3 / step_ms:.1f} "
            f"images/s), data wait {_steady(history, 'data_wait_ms'):.3f} "
            f"ms a step" + (f" (prefetcher: host fetch {fetch:.3f} ms, "
                            f"transfer dispatch "
                            f"{_steady(history, 'transfer_ms'):.3f} ms)"
                            if fetch is not None else "")
            + f", state crc32 {crcs[way][1]:#010x}")
        del state
        torch.cuda.empty_cache()
    if len({tuple(c) for c in crcs.values()}) != 1 \
            or _manifest_crcs(ckpt)[DATA_STEPS] != crcs["c"]:
        fail(f"data: the three ways end at (size, crc32) {crcs}; way c's "
             f"checkpoint {_manifest_crcs(ckpt)}")
    for line in lines:
        print(f"[data] {line}", flush=True)
    print(f"[data] the three ways end at one state, (size, crc32) "
          f"{crcs['a']}, bit for bit, launches a step "
          f"{ {n: c for n, c in STEP_LAUNCHES.items()} } each, on "
          f"{card_line}; phase {time.monotonic() - t0:.1f} s", flush=True)
    return store, ckpt, dict(STEP_LAUNCHES)


def phase_data_lag(card_line: str) -> None:
    """The lag-1 guard against the synchronous guard and the plain loop,
    rounds of GUARD_TIMED_STEPS steps of train_loop on the same batches."""
    import torch

    from ntxent_tpu_torch.resilience import DivergenceGuard
    from ntxent_tpu_torch.training import make_train_step, train_loop
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    args, cfg, states, pipe = _simclr_setup(TRAIN_ARGV, copies=3)
    batches = [next(pipe) for _ in range(GUARD_TIMED_STEPS)]
    pstep = make_train_step(cfg.temperature)
    gstep = make_train_step(cfg.temperature, guard=True)
    runs = {name: [state, step, lag] for name, state, step, lag in zip(
        ("plain", "guarded", "lagged"), states, (pstep, gstep, gstep),
        (0, 0, 1))}

    def run(name, steps):
        state, step, lag = runs[name]
        guard = None if name == "plain" else DivergenceGuard(
            backoff_after=None, rollback_after=None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_loop(state, iter(batches[:steps]), step, steps,
                   log_every=steps, log=False, step_guard=guard,
                   metrics_lag=lag)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    for name in runs:  # first calls: libraries, the snapshot buffers
        run(name, 1)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    ms = {name: [] for name in runs}
    for name in DATA_LAG_ROUNDS:
        ms[name].append(run(name, GUARD_TIMED_STEPS))
    steps = len(DATA_LAG_ROUNDS) * GUARD_TIMED_STEPS
    launches = {n: w.launches for n, w in counters.items()}
    want = {n: STEP_LAUNCHES.get(n, 0) * steps for n in counters}
    crcs = {name: _params_crc(state.model) for name, (state, _, _)
            in runs.items()}
    if launches != want or len(set(crcs.values())) != 1:
        fail(f"data-lag: launches {launches} (expected {want}); params "
             f"crc32 {crcs}")
    mean = {n: sum(v) / len(v) for n, v in ms.items()}
    print(f"[data-lag] ViT-B/16 batch {args.batch}, rounds of "
          f"{GUARD_TIMED_STEPS} train_loop steps {'/'.join(DATA_LAG_ROUNDS)}"
          f": ms a step plain "
          f"{'/'.join(f'{v:.3f}' for v in ms['plain'])}, guarded (a host "
          f"sync a step) {'/'.join(f'{v:.3f}' for v in ms['guarded'])}, "
          f"guarded under --lag-metrics (kept on the card, read a step "
          f"late) {'/'.join(f'{v:.3f}' for v in ms['lagged'])}; mean plain "
          f"{mean['plain']:.3f}, guarded {mean['guarded']:.3f} "
          f"({100 * (mean['guarded'] / mean['plain'] - 1):+.2f}%), lagged "
          f"{mean['lagged']:.3f} "
          f"({100 * (mean['lagged'] / mean['plain'] - 1):+.2f}%); all "
          f"three end at params crc32 {crcs['plain']:#010x}; host clock on "
          f"{card_line}; phase {time.monotonic() - t0:.1f} s", flush=True)
    del runs, states, batches
    torch.cuda.empty_cache()


def phase_data_lag_nan(store: str, card_line: str) -> None:
    """Way c with a NaN batch against way c without --lag-metrics."""
    import math

    import torch

    from ntxent_tpu_torch import cli

    t0 = time.monotonic()
    chaos = ["--chaos", f"nan@{DATA_NAN_AT}"]
    results = {}
    for label, argv in (
            ("lag", _data_argv(store, "c") + chaos),
            ("sync", [a for a in _data_argv(store, "c")
                      if a != "--lag-metrics"] + chaos)):
        with _LogTap() as tap:
            state, history = cli.train(cli.build_train_parser().parse_args(
                argv))
        named = tap.having(f"non-finite step {DATA_NAN_AT} skipped")
        losses = [h["loss"] for h in history]
        if [math.isfinite(x) for x in losses] != [
                i + 1 != DATA_NAN_AT for i in range(DATA_STEPS)]:
            fail(f"data-lag-nan {label}: losses {losses}")
        results[label] = (_state_crc(state), state.optimizer.count, named)
        del state
        torch.cuda.empty_cache()
    (crc_l, count_l, named_l), (crc_s, count_s, named_s) = \
        results["lag"], results["sync"]
    if crc_l != crc_s or not named_l or not named_s \
            or count_l != count_s or count_l != DATA_STEPS - 1:
        fail(f"data-lag-nan: lag {results['lag']}, sync {results['sync']}")
    print(f"[data-lag-nan] way c + --chaos nan@{DATA_NAN_AT}: '{named_l[0]}'"
          f"; ends at (size, crc32) {crc_l}, count {count_l}, bit for bit "
          f"where the run without --lag-metrics ends; on {card_line}; phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def phase_eval(tmp: str, ckpt: str, clip_dir: str, card_line: str) -> dict:
    """ntxent-eval on way c's checkpoint and on the CLIP checkpoint;
    returns the launches of a fine-tuning step and of a feature batch."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import extract_features
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    counters = launch_counters()

    def zero():
        for wrapper in counters.values():
            wrapper.launches = 0

    def args_of(*extra):
        return cli.build_eval_parser().parse_args(
            EVAL_ARGV + ["--ckpt-dir", ckpt, *extra])

    args = args_of()
    device = torch.device(args.device)
    _, _, xte, _ = cli._labeled_arrays(args)
    features = {}
    for impl in ("flash", "xla"):
        model, step = cli.eval_model(args_of("--vit-attention", impl),
                                     device)
        zero()
        t = time.perf_counter()
        f = extract_features(model.features, xte, args.batch, device).float()
        torch.cuda.synchronize()
        features[impl] = (f / f.norm(dim=1, keepdim=True)).cpu().numpy(), \
            (time.perf_counter() - t) * 1e3, counters[
                "flash_attention_fwd"].launches
        del model
        torch.cuda.empty_cache()
    batches = -(-len(xte) // args.batch)
    err = float(np.abs(features["flash"][0] - features["xla"][0]).max())
    if err > EMBED_ATOL or features["flash"][2] != 12 * batches \
            or features["xla"][2] != 0:
        fail(f"eval features: flash against plain attention {err:.2e} (atol "
             f"{EMBED_ATOL:g}); #11 launches {features['flash'][2]} and "
             f"{features['xla'][2]}, expected {12 * batches} and 0")
    t = time.perf_counter()
    both = cli.evaluate(args)
    both_s = time.perf_counter() - t
    ft_args = args_of(*EVAL_FINETUNE)
    zero()
    t = time.perf_counter()
    tuned = cli.evaluate(ft_args)
    tuned_s = time.perf_counter() - t
    launches = {n: w.launches for n, w in counters.items()}
    n_train, n_test = 384, len(xte)
    # one forward of one image for the feature width, the steps, then the
    # accuracies of both splits in batches
    predict = 1 - (-n_train // ft_args.finetune_batch) \
        - (-n_test // ft_args.finetune_batch)
    steps = ft_args.finetune_steps
    want = {n: 0 for n in counters}
    want.update(flash_attention_fwd=12 * (steps + predict),
                flash_attention_dq=12 * steps, flash_attention_dkv=12 * steps)
    if launches != want or not math.isfinite(tuned["finetune_loss"]):
        fail(f"eval finetune: launches {launches}, expected {want}; loss "
             f"{tuned['finetune_loss']}")
    prompts = f"{tmp}/prompts.npy"
    zs_args = cli.build_eval_parser().parse_args(
        EVAL_CLIP_ARGV + ["--ckpt-dir", clip_dir, "--protocol", "zeroshot",
                          "--class-tokens", prompts])
    np.save(prompts, np.random.default_rng(DATA_SEED).integers(
        0, zs_args.vocab_size, EVAL_PROMPTS))
    t = time.perf_counter()
    zero_shot = cli.evaluate(zs_args)
    zs_s = time.perf_counter() - t
    if zero_shot["num_classes"] != EVAL_PROMPTS[0] \
            or not 0 <= zero_shot["zeroshot_top1"] <= 1:
        fail(f"eval zeroshot: {zero_shot}")
    print(f"[eval] way c's step {step}, --dataset synthetic --image-size "
          f"224: {len(xte)} test features of the flash forward against the "
          f"plain attention forward on the card, L2-normalized: max |err| "
          f"{err:.2e} (atol {EMBED_ATOL:g}); extraction "
          f"{features['flash'][1]:.1f} ms flash, {features['xla'][1]:.1f} "
          f"ms plain ({batches} batches of {args.batch}; #11 12 a batch)",
          flush=True)
    print(f"[eval] --protocol both: {both} in {both_s:.1f} s; "
          f"{' '.join(EVAL_FINETUNE)}: {tuned} in {tuned_s:.1f} s, launches "
          f"{ {n: c for n, c in launches.items() if c} } ({steps} steps: "
          f"12/12/12 of #11/#13/#14 a step, and #11 12 a forward in "
          f"{predict} forwards of the width probe and the accuracies); CLIP"
          f" ViT-B/16 --protocol "
          f"zeroshot with {EVAL_PROMPTS[0]} prompts of {EVAL_PROMPTS[1]} "
          f"ids: {zero_shot} in {zs_s:.1f} s; on {card_line}; phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return {"eval_feature_launches": {"flash_attention_fwd": 12},
            "finetune_launches": {"flash_attention_fwd": 12,
                                  "flash_attention_dq": 12,
                                  "flash_attention_dkv": 12}}


def phase_data_imagefolder(tmp: str, card_line: str) -> None:
    """An ImageNet-layout folder of PNGs decoded by the loader's threads,
    trained with --prefetch 0 and 2: the data wait a step."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from PIL import Image

    t0 = time.monotonic()
    count, classes, height, width = IMAGEFOLDER
    root = f"{tmp}/folder"
    for c in range(classes):
        os.makedirs(f"{root}/class_{c}")
    rng = np.random.default_rng(DATA_SEED)
    pixels = [rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
              for _ in range(count)]

    def write(i):
        Image.fromarray(pixels[i]).save(
            f"{root}/class_{i % classes}/{i:04d}.png")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(count)))
    write_s = time.monotonic() - t0
    lines = []
    for depth in (0, 2):
        argv = _with_flags(TRAIN_ARGV, "--dataset", "imagefolder",
                           "--data-dir", root, "--steps",
                           str(IMAGEFOLDER_STEPS), "--prefetch", str(depth))
        state, history, _ = _train_ckpt(argv)
        fetch = _steady(history, "fetch_ms")
        waits = "/".join(f"{h['data_wait_ms']:.1f}" for h in history)
        lines.append(
            f"--prefetch {depth}: data wait a step {waits} ms (steps "
            f"1-{IMAGEFOLDER_STEPS}), step {_step_ms(history):.1f} ms (steps "
            f"2-{IMAGEFOLDER_STEPS - 1})" + (f", prefetcher host fetch "
                                              f"{fetch:.1f} ms"
                            if fetch is not None else ""))
        del state
        torch.cuda.empty_cache()
    print(f"[data-imagefolder] {count} PNGs of {height}x{width} in "
          f"{classes} class folders (written in {write_s:.1f} s), decoded "
          f"and centre-cropped to 224 by 8 loader threads, ViT-B/16 batch "
          f"256: {'; '.join(lines)}; on {card_line}; phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    shutil.rmtree(root)


class _Scraper(threading.Thread):
    """Scrape the run's /metrics mid-run: the port from the CLI's log line,
    then JSON and Prometheus text once the run has done a few steps;
    touches the profiler's TRIGGER file once OBS_TRIGGER_AT steps are
    done."""

    def __init__(self, tap, trigger: str):
        super().__init__(daemon=True)
        self.tap, self.trigger = tap, trigger
        self.done = threading.Event()
        self.json = self.text = None
        self.touched_at = None

    def run(self):
        port = None
        while port is None and not self.done.is_set():
            for m in self.tap.having("metrics endpoint: http://127.0.0.1:"):
                port = int(m.split("127.0.0.1:")[1].split("/")[0])
            time.sleep(0.05)
        base = f"http://127.0.0.1:{port}/metrics"
        while not self.done.is_set():
            try:
                snap = _get(base + "?format=json")[1]
            except (OSError, ValueError):
                time.sleep(0.05)
                continue
            steps = snap.get("train_steps_total", 0)
            if steps >= OBS_TRIGGER_AT and self.touched_at is None:
                open(self.trigger, "w").close()
                self.touched_at = steps
            if steps >= OBS_TRIGGER_AT + 1 and self.text is None:
                self.json = snap
                self.text = _get_text(base)[1]
            if self.text is not None and self.touched_at is not None:
                return
            time.sleep(0.05)


def _obs_rounds(flops: float) -> dict:
    """ms a step of the plain loop, the timeline on the synchronous path
    and under --lag-metrics, rounds of GUARD_TIMED_STEPS train_loop steps
    (OBS_ROUNDS) on batches on the card (the timelines take step 1's count
    as given, so no round counts); then one warm step counted
    (``"count"``: FlopCounterMode's host cost)."""
    import torch

    from ntxent_tpu_torch import obs
    from ntxent_tpu_torch.training import make_train_step, train_loop

    args, cfg, (state,), pipe = _simclr_setup(TRAIN_ARGV, copies=1)
    batches = [next(pipe) for _ in range(GUARD_TIMED_STEPS)]
    step = make_train_step(cfg.temperature)

    def run(name, steps):
        timeline = None if name == "plain" else obs.StepTimeline(
            registry=obs.MetricsRegistry())
        torch.cuda.synchronize()
        t = time.perf_counter()
        # the rounds time the timeline as before; "census" is step 1
        # under the collective census, "nocensus" the same step without
        train_loop(state, iter(batches[:steps]), step, steps,
                   log_every=steps, log=False, timeline=timeline,
                   metrics_lag=int(name == "lag"),
                   flops_per_step="auto" if name == "count" else flops,
                   graph_census=name in ("census", "count"))
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    ms = {name: [] for name in OBS_ROUNDS}
    previous = obs.install(obs.EventLog(None))  # the events' cost included
    try:
        for name in ms:  # first calls
            run(name, 1)
        for name in OBS_ROUNDS:
            ms[name].append(run(name, GUARD_TIMED_STEPS))
        ms["count"] = [run("count", 1)]
        ms["census"], ms["nocensus"] = [], []
        for name in CENSUS_ROUNDS:
            ms[name].append(run(name, 1))
    finally:
        obs.install(previous)
    del state, batches
    torch.cuda.empty_cache()
    return ms


def phase_obs_train(tmp: str, card_line: str) -> dict:
    """The SimCLR path with the telemetry flags through the CLI; returns
    its launches a step."""
    import math
    import subprocess

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.obs.events import read_events
    from ntxent_tpu_torch.resilience.crashsim import losses_from_jsonl
    from ntxent_tpu_torch.training.trainer import peak_flops_per_chip
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    root = f"{tmp}/obs"
    jsonl, traces = f"{root}/run.jsonl", f"{root}/traces"
    argv = _with_flags(TRAIN_ARGV, "--steps", str(OBS_STEPS), "--log-every",
                       "4") + ["--metrics-port", "0", "--log-jsonl", jsonl,
                               "--trace-dir", traces, "--trace-steps",
                               str(OBS_TRACE_STEPS)]
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    with _LogTap() as tap:
        scraper = _Scraper(tap, f"{traces}/TRIGGER")
        scraper.start()
        try:
            _, history, _ = _train_ckpt(argv)
        finally:
            scraper.done.set()
            scraper.join(30.0)
    launches = {n: w.launches for n, w in counters.items()}
    want = {n: STEP_LAUNCHES.get(n, 0) * OBS_STEPS for n in counters}
    if launches != want:
        fail(f"obs-train: launches over {OBS_STEPS} steps {launches}, "
             f"expected {want}")
    if scraper.json is None or scraper.touched_at is None:
        fail(f"obs-train: no mid-run scrape ({scraper.json is not None}) or "
             f"no trigger ({scraper.touched_at})")
    text = scraper.text
    missing = [n for n in OBS_SERIES if n not in scraper.json
               or f"\n{n}" not in "\n" + text and f"# TYPE {n}" not in text]
    mfu = scraper.json.get("train_mfu", 0.0)
    if missing or not 0.0 < mfu < 1.0:
        fail(f"obs-train: the mid-run scrape lacks {missing}, train_mfu "
             f"{mfu}")
    graph = scraper.json.get("collective_graph_bytes_total", {})
    ad_bytes = graph.get('{source="ad"}')
    if ad_bytes is None \
            or 'collective_graph_bytes_total{source="ad"}' not in text:
        fail(f"obs-train: step 1's census published no "
             f"collective_graph_bytes_total{{source=\"ad\"}} ({graph})")
    steps = read_events(jsonl, "step")
    (compile_rec,) = read_events(jsonl, "compile")
    bad = [r for r in steps
           if any(k not in r for k in OBS_STEP_FIELDS)
           or not 0.0 < r["mfu"] < 1.0]
    if [r["step"] for r in steps] != list(range(1, OBS_STEPS + 1)) or bad:
        fail(f"obs-train: step events {[r.get('step') for r in steps]}, "
             f"without {OBS_STEP_FIELDS} or an mfu in (0, 1): {bad[:2]}")
    losses = losses_from_jsonl(jsonl)
    logged = {h["step"]: h["loss"] for h in history}
    if any(losses.get(s) != v for s, v in logged.items()) \
            or not all(map(math.isfinite, losses.values())):
        fail(f"obs-train: losses_from_jsonl {losses} against the logged "
             f"{logged}")
    kernels = set()
    for path in os.listdir(traces):
        if path.startswith("step"):
            with open(f"{traces}/{path}/trace.json") as f:
                events = json.load(f)["traceEvents"]
            kernels |= {e["name"] for e in events
                        if e.get("cat") == OBS_TRACE_CAT}
    unseen = [k for k in OBS_KERNELS if not any(k in n for n in kernels)]
    if not kernels or unseen:
        fail(f"obs-train: the profiler trace's kernels {sorted(kernels)[:8]} "
             f"lack {unseen}")
    out = f"{root}/trace.json"
    done = subprocess.run([sys.executable, "-m", "ntxent_tpu_torch.obs.trace",
                           jsonl, "-o", out], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if done.returncode != 0:
        fail(f"obs-train: obs.trace exited {done.returncode}: "
             f"{done.stderr[-400:]}")
    with open(out) as f:
        exported = json.load(f)["traceEvents"]
    slices = sum(e.get("cat") == "step" for e in exported)
    if slices != OBS_STEPS:
        fail(f"obs-train: the exported trace has {slices} step slices")
    flops, peak = compile_rec["flops"], peak_flops_per_chip()
    # after the capture (CUPTI's start, the export) and its next step
    steady = steps[int(scraper.touched_at) + OBS_TRACE_STEPS + 2:]
    device_ms = "/".join(f"{r['device_ms']:.1f}" for r in steady)
    wait_ms = "/".join(f"{r['data_wait_ms']:.1f}" for r in steady)
    wall_ms = "/".join(f"{1e3 / r['steps_per_sec']:.1f}" for r in steady)
    step_mfu = "/".join(f"{r['mfu']:.4f}" for r in steady)
    per_step = {n: c // OBS_STEPS for n, c in launches.items() if c}
    print(f"[obs-train] ViT-B/16 flash batch 256 {OBS_STEPS} steps with "
          f"--metrics-port 0 --log-jsonl --trace-dir: mid-run scrape at "
          f"step {scraper.json['train_steps_total']:.0f} (JSON and "
          f"Prometheus) train_mfu {mfu:.4f}, train_step_device_ms p50 "
          f"{scraper.json['train_step_device_ms']['p50']:.3f}; step 1 "
          f"counted {flops:.4e} FLOPs a card (the first run "
          f"{compile_rec['duration_ms']:.1f} ms); device ms a step (sync "
          f"bracket) {device_ms}, data wait {wait_ms}, wall {wall_ms}, "
          f"mfu {step_mfu} against "
          f"{peak / 1e12:.1f} TFLOP/s; "
          f"TRIGGER touched at step {scraper.touched_at:.0f}: a "
          f"Chrome trace with {len(kernels)} CUDA kernel names, the "
          f"hand-written {', '.join(OBS_KERNELS)} among them; losses_from_"
          f"jsonl equal to the logged losses; obs.trace exported {slices} "
          f"step slices; launches a step {per_step} on {card_line}",
          flush=True)
    ms = _obs_rounds(flops)
    mean = {n: sum(v) / len(v) for n, v in ms.items()}
    plain_mfu = flops / mean["plain"] * 1e3 / peak
    print(f"[obs-train] rounds of {GUARD_TIMED_STEPS} train_loop steps "
          f"{'/'.join(OBS_ROUNDS)} on batches on the card: ms a step plain "
          f"{'/'.join(f'{v:.3f}' for v in ms['plain'])}, timeline (a sync a "
          f"step) {'/'.join(f'{v:.3f}' for v in ms['sync'])}, timeline "
          f"under --lag-metrics {'/'.join(f'{v:.3f}' for v in ms['lag'])}; "
          f"mean plain {mean['plain']:.3f}, sync {mean['sync']:.3f} "
          f"({100 * (mean['sync'] / mean['plain'] - 1):+.2f}%), lag "
          f"{mean['lag']:.3f} ({100 * (mean['lag'] / mean['plain'] - 1):+.2f}"
          f"%); MFU at the plain mean {plain_mfu:.4f}; a warm counted step "
          f"{ms['count'][0]:.1f} ms (under the census); step 1 of a "
          f"timeline with the collective census "
          f"{'/'.join(f'{v:.1f}' for v in ms['census'])} ms, without "
          f"{'/'.join(f'{v:.1f}' for v in ms['nocensus'])} ms; "
          f"collective_graph_bytes_total{{source=\"ad\"}} {ad_bytes:.0f} "
          f"at world 1; "
          f"host clock on "
          f"{card_line}; phase {time.monotonic() - t0:.1f} s",
          flush=True)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return {n: c // OBS_STEPS for n, c in launches.items()}


def phase_stem(tmp: str, card_line: str) -> dict:
    """ResNet-50 with --stem space_to_depth against --stem conv from the
    same weights and batches, each with --log-jsonl (its MFU); returns the
    space-to-depth run's launches a step."""
    import torch

    from ntxent_tpu_torch.models.resnet import SpaceToDepthStem
    from ntxent_tpu_torch.obs.events import read_events
    from ntxent_tpu_torch.utils.profiling import launch_counters

    t0 = time.monotonic()
    counters = launch_counters()
    runs, mfu = {}, {}
    for stem in ("space_to_depth", "conv"):
        for wrapper in counters.values():
            wrapper.launches = 0
        jsonl = f"{tmp}/stem_{stem}.jsonl"
        state, history, _ = _train_ckpt(_with_flags(
            STEM_ARGV, "--steps", str(STEM_STEPS), "--stem", stem,
            "--log-jsonl", jsonl))
        mfu[stem] = "/".join(f"{r['mfu']:.4f}"
                             for r in read_events(jsonl, "step")[1:])
        os.remove(jsonl)
        launches = {n: w.launches for n, w in counters.items()}
        want = {n: STEM_LAUNCHES.get(n, 0) * STEM_STEPS for n in counters}
        if launches != want:
            fail(f"stem {stem}: launches {launches}, expected {want}")
        is_s2d = isinstance(state.model.backbone.stem_conv, SpaceToDepthStem)
        if is_s2d != (stem == "space_to_depth"):
            fail(f"stem {stem}: the model's stem is "
                 f"{type(state.model.backbone.stem_conv).__name__}")
        runs[stem] = history
        if stem == "space_to_depth":
            per_step = {n: c // STEM_STEPS for n, c in launches.items()}
        del state
        torch.cuda.empty_cache()
    first = {stem: h[0]["loss"] for stem, h in runs.items()}
    gap = abs(first["space_to_depth"] - first["conv"])
    if not gap <= STEM_LOSS_ATOL:
        fail(f"stem: the first step's losses {first} differ by {gap} > "
             f"{STEM_LOSS_ATOL}")
    print(f"[stem] ResNet-50 224 px batch 256, {STEM_STEPS} steps each from "
          f"the same weights and batches: first-step loss space_to_depth "
          f"{first['space_to_depth']:.6f}, conv {first['conv']:.6f} (|gap| "
          f"{gap:.2e} <= {STEM_LOSS_ATOL}); step ms (steps "
          f"2-{STEM_STEPS - 1}, host clock around the loss read) "
          f"space_to_depth "
          f"{_step_ms(runs['space_to_depth']):.1f}, conv "
          f"{_step_ms(runs['conv']):.1f}, with the synchronous timeline; "
          f"MFU steps 2-{STEM_STEPS} space_to_depth {mfu['space_to_depth']}"
          f", conv {mfu['conv']}; #1/#5 1/1 a step, nothing else; "
          f"on {card_line}; phase {time.monotonic() - t0:.1f} s",
          flush=True)
    return per_step


def _moe_layers(model):
    from ntxent_tpu_torch.parallel.moe import MoEMlp

    return [m for m in model.modules() if isinstance(m, MoEMlp)]


def _steady_ms(history) -> float:
    steady = history[1:]
    return 1e3 * sum(1.0 / h["steps_per_sec"] for h in steady) / len(steady)


def _moe_parity(card_line: str) -> None:
    """The step-1 loss of the fp32 MoE ViT-B/16 SimCLR model at batch 8,
    card against CPU (TF32 off), and its routing: the same experts and
    kept flags in every MoE layer."""
    import copy

    import torch

    from ntxent_tpu_torch.models import SimCLRModel, ViT_B16, init_weights
    from ntxent_tpu_torch.ops import oracle
    from ntxent_tpu_torch.ops.ntxent import ntxent_loss_fused
    from ntxent_tpu_torch.parallel import moe

    model = init_weights(SimCLRModel(ViT_B16(
        image_size=224, attention_impl="flash", moe_experts=8,
        dtype=torch.float32), dtype=torch.float32),
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    both = torch.from_numpy(rng.uniform(size=(
        2 * MOE_PARITY_BATCH, 224, 224, 3)).astype(np.float32))
    routes = {}
    real = moe.route

    def recording(x2d, router, c, *rest):
        out = real(x2d, router, c, *rest)
        routes.setdefault(x2d.device.type, []).append(
            (out[0].cpu(), out[2].cpu()))
        return out

    moe.route = recording
    try:
        t0 = time.monotonic()
        with torch.no_grad():
            loss_cpu = oracle.ntxent_loss(model.train()(both), 0.1).item()
        cpu_s = time.monotonic() - t0
        card = copy.deepcopy(model).cuda().train()
        with torch.no_grad():
            loss_gpu = ntxent_loss_fused(card(both.cuda()), 0.1).item()
    finally:
        moe.route = real
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(routes["cpu"], routes["cuda"]))
    err = abs(loss_gpu - loss_cpu)
    ok = err <= MOE_PARITY_ATOL and same and len(routes["cuda"]) == 6
    print(f"[moe] step-1 loss float32, batch {MOE_PARITY_BATCH}: card "
          f"{loss_gpu:.6f} vs CPU {loss_cpu:.6f} (|err| {err:.2e}, atol "
          f"{MOE_PARITY_ATOL:g}); expert ids and kept flags of the "
          f"{len(routes['cuda'])} MoE layers identical: {same}; CPU forward "
          f"{cpu_s:.1f} s {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the MoE step-1 loss or routing on the card disagrees with the "
             "CPU's")
    del card
    torch.cuda.empty_cache()


def phase_moe(tmp: str, card_line: str) -> tuple[dict, str]:
    """[moe]: the SimCLR ViT-B/16 path with switch-MoE (8 experts, 6
    layers) through ``ntxent-train`` on the card at --batch 256: the
    dense path's launches a step, finite losses and aux, step ms, peak
    memory, the share of dropped tokens; a checkpoint for [eval-moe];
    then the step-1 loss against the CPU. Returns (launches, checkpoint
    directory)."""
    import math
    import os

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    ckpt = os.path.join(tmp, "moe_ckpt")
    # saved at the end only: a save inside the loop lands in a step's time
    argv = _ckpt_argv(MOE_ARGV, ckpt, MOE_STEPS, every=10 * MOE_STEPS,
                      keep=1)
    args = cli.build_train_parser().parse_args(argv)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    state, history = cli.train(args)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    auxes = [h.get("moe_aux", float("nan")) for h in history]
    if len(losses) != MOE_STEPS or not all(map(math.isfinite,
                                              losses + auxes)):
        fail(f"MoE losses {losses}, aux {auxes}: expected {MOE_STEPS} "
             "finite values of each")
    want = {n: STEP_LAUNCHES.get(n, 0) * MOE_STEPS for n in counters}
    if launches != want:
        fail(f"MoE kernel launches over {MOE_STEPS} steps {launches}, "
             f"expected {want}")
    layers = _moe_layers(state.model)
    dropped = [m.dropped.item() for m in layers]
    for m in layers:
        if m.w_up.grad is None or not m.w_up.grad.abs().sum().item() > 0 \
                or not m.router.grad.abs().sum().item() > 0:
            fail("an MoE layer's experts or router has no gradient")
    tokens = 2 * args.batch * 197
    step_ms = _steady_ms(history)
    print(f"[moe] ViT-B/16 flash + switch-MoE ({len(layers)} layers of 8 "
          f"experts, capacity {math.ceil(tokens / 8 * 1.25)} of {tokens} "
          f"tokens), batch {args.batch}, {MOE_STEPS} steps in {wall_s:.1f} s:"
          f" losses {[round(x, 4) for x in losses]}, moe_aux "
          f"{[round(x, 4) for x in auxes]}; launches per step "
          f"{ {n: c // MOE_STEPS for n, c in launches.items() if c} } (every "
          f"other kernel 0); dropped token share per layer at the last step "
          f"{[round(x, 4) for x in dropped]}", flush=True)
    print(f"[moe] step {step_ms:.1f} ms (steps 2-{MOE_STEPS}, host clock "
          f"around a synchronizing loss read), "
          f"{2 * args.batch / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) on "
          f"{card_line}", flush=True)
    del state
    torch.cuda.empty_cache()
    _moe_parity(card_line)
    return launches, ckpt


def phase_moe_ep() -> None:
    """[moe-ep]: make_expert_parallel_moe over the NCCL group of world 1
    against switch_moe at the path's MoE layer shape: output, aux and
    gradients bitwise."""
    import torch

    from ntxent_tpu_torch.parallel import (
        init_moe_params,
        make_expert_parallel_moe,
        switch_moe,
    )

    params = init_moe_params(torch.Generator().manual_seed(3), 8, 768, 3072)
    for name in ("router", "w_up", "b_up", "w_down", "b_down"):
        setattr(params, name, getattr(params, name).cuda().requires_grad_())
    x = torch.randn(*MOE_EP_TOKENS, 768, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4)
                    ).to(torch.bfloat16).requires_grad_()
    ep = make_expert_parallel_moe(torch.distributed.group.WORLD)
    results = []
    for fn in (ep, lambda p, v: switch_moe(p, v)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = fn(params, x)
        (y.float().square().sum() + aux).backward()
        torch.cuda.synchronize()
        results.append((y.detach(), aux.detach(),
                        [t.grad.clone() for t in (x, params.router,
                                                  params.w_up,
                                                  params.w_down)],
                        (time.perf_counter() - t0) * 1e3))
        for t in (x, params.router, params.w_up, params.b_up, params.w_down,
                  params.b_down):
            t.grad = None
    (y_a, aux_a, g_a, ms_a), (y_b, aux_b, g_b, ms_b) = results
    same = torch.equal(y_a, y_b) and torch.equal(aux_a, aux_b) and all(
        torch.equal(a, b) for a, b in zip(g_a, g_b))
    print(f"[moe-ep] make_expert_parallel_moe (P = 1, NCCL) vs switch_moe at "
          f"{MOE_EP_TOKENS[0] * MOE_EP_TOKENS[1]} tokens x 768, 8 experts of "
          f"3072, bf16: output, aux {aux_a.item():.6f} and the gradients of x,"
          f" the router and both expert kernels bitwise equal: {same}; "
          f"forward + backward {ms_a:.1f} / {ms_b:.1f} ms (host clock, "
          f"first calls)", flush=True)
    if not same:
        fail("expert parallelism at P = 1 differs from switch_moe")


def _world1_grid():
    from ntxent_tpu_torch.parallel import mesh

    return mesh.grid_groups(1, 1)  # (data, model)


# the model-parallel phases' CPU models of seed 0, drawn once and copied
# for every state (drawing ViT-B/16's weights takes seconds of host time)
_TEMPLATES: dict = {}


def _template(key, build):
    import copy

    import torch

    from ntxent_tpu_torch.models import init_weights

    if key not in _TEMPLATES:
        _TEMPLATES[key] = init_weights(build(),
                                       torch.Generator().manual_seed(0))
    return copy.deepcopy(_TEMPLATES[key])


def _vit_state(dtype, moe: int = 0, batch: int = 256):
    import torch

    from ntxent_tpu_torch.models import SimCLRModel, ViT_B16
    from ntxent_tpu_torch.training import TrainerConfig, create_train_state

    model = _template(("vit", dtype, moe), lambda: SimCLRModel(ViT_B16(
        image_size=224, attention_impl="flash", moe_experts=moe,
        dtype=dtype), dtype=dtype))
    return create_train_state(model, TrainerConfig(batch_size=batch,
                                                   warmup_steps=1),
                              torch.device("cuda"))


def _clip_state(dtype, moe: int = 0):
    import torch

    from ntxent_tpu_torch.models import CLIPModel, TextTransformer, ViT_B16
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_clip_train_state,
    )

    model = _template(("clip", dtype, moe), lambda: CLIPModel(
        ViT_B16(image_size=224, attention_impl="flash", moe_experts=moe,
                dtype=dtype), TextTransformer(dtype=dtype)))
    return create_clip_train_state(
        model, TrainerConfig(base_lr=5e-4, warmup_steps=1),
        torch.device("cuda"))


def _whole_params(state) -> list:
    if state.sharding is not None:
        state = state.sharding.gather(state)
    return [p.detach().float().cpu() for p in state.model.parameters()]


def _compare_steps(tag: str, what: str, runs: dict, atol: float,
                   params: bool) -> None:
    """Gate the (losses, parameters after two steps) of ``runs`` against
    the first run's: both losses within ``atol`` and, with ``params``,
    the two steps' parameter update u within PARITY_GRAD_RTOL of the
    first run's (u must not be 0: the gate would hold nothing)."""
    (base, (loss_b, p_b)), *rest = runs.items()
    moved = torch_cat(p_b[0]) - torch_cat(p_b[1])
    if params and not moved.norm().item() > 0:
        fail(f"{tag}: two {base} steps left the parameters where they were")
    for name, (losses, p) in rest:
        err = max(abs(a - b) for a, b in zip(losses, loss_b))
        rel = 0.0
        if params:
            rel = ((torch_cat(p[0]) - torch_cat(p[1]) - moved).norm().item()
                   / moved.norm().item())
        ok = err <= atol and rel <= PARITY_GRAD_RTOL
        print(f"[{tag}] {what}: losses of 2 steps {name} "
              f"{'/'.join(f'{x:.6f}' for x in losses)} vs {base} "
              f"{'/'.join(f'{x:.6f}' for x in loss_b)} (max |err| {err:.2e}, "
              f"atol {atol:g})"
              + (f"; parameter update of the 2 steps |du| / |u| {rel:.2e} "
                 f"(rtol {PARITY_GRAD_RTOL:g}, |u| "
                 f"{moved.norm().item():.3e})" if params else "")
              + f" {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{tag}: the {name} steps disagree with the {base} steps")


def torch_cat(parts):
    import torch

    return torch.cat([t.reshape(-1) for t in parts])


def _two_steps(state, step, *batch):
    """(the two losses, (parameters after, before)) of two steps of
    ``state`` on ``batch``. The schedule's learning rate is 0 at the
    first step (warmup_steps=1), so the second moves the parameters: by
    the LARS update of its gradient, which the TP backward (Megatron's f
    and g, LARS's sliced norms) computes."""
    before = _whole_params(state)
    losses = []
    for _ in range(2):
        state, metrics = step(state, *batch)
        losses.append(metrics["loss"].item())
    return losses, (_whole_params(state), before)


def _timed_steps(tag: str, state, step, batches, want: dict,
                 card_line: str, what: str) -> dict:
    """MP_STEPS steps of ``step`` on ``batches`` (one batch reused),
    launches gated to ``want`` a step; prints the step ms on CUDA
    events; returns the launches."""
    import math

    import torch

    from ntxent_tpu_torch.utils.profiling import launch_counters

    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(MP_STEPS):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        state, metrics = step(state, *batches)
        end.record()
        losses.append(metrics["loss"].item())
        times.append(start.elapsed_time(end))
    launches = {n: w.launches for n, w in counters.items()}
    expect = {n: want.get(n, 0) * MP_STEPS for n in counters}
    if launches != expect or not all(map(math.isfinite, losses)):
        fail(f"[{tag}] launches {launches}, expected {expect}; losses "
             f"{losses}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {what}: {MP_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}, step "
          f"{'/'.join(f'{t:.1f}' for t in times)} ms (CUDA events; steps "
          f"2-{MP_STEPS} mean {sum(times[1:]) / (MP_STEPS - 1):.1f} ms); "
          f"launches per step "
          f"{ {n: c // MP_STEPS for n, c in launches.items() if c} }; peak "
          f"memory {peak / 2**30:.2f} GiB on {card_line}", flush=True)
    return launches


def phase_tp(card_line: str) -> dict:
    """[tp]: make_tp_simclr_train_step on ViT-B/16 at the (data 1, model
    1) grid: the timed path at --batch 256 (the single-card step's
    launches), then one step against the single-card and the world-1
    data-parallel steps, fp32 and bf16. Returns the launches."""
    import torch

    from ntxent_tpu_torch.models import cross_replica_batch_norm
    from ntxent_tpu_torch.parallel.tp import (
        make_tp_simclr_train_step,
        shard_train_state,
    )
    from ntxent_tpu_torch.training import (
        make_sharded_train_step,
        make_train_step,
    )

    data, model = _world1_grid()
    gen = torch.Generator("cuda").manual_seed(6)
    views = [torch.rand(256, 224, 224, 3, device="cuda", generator=gen)
             for _ in range(2)]
    state = shard_train_state(_vit_state(torch.bfloat16), model, data)
    launches = _timed_steps("tp", state, make_tp_simclr_train_step(0.1),
                            views, TP_STEP_LAUNCHES, card_line,
                            "Megatron TP SimCLR ViT-B/16 flash (bf16) at the "
                            "(1, 1) grid, batch 256")
    del state
    torch.cuda.empty_cache()
    for dtype, batch, atol, params in (
            (torch.float32, PARITY_BATCH, PARITY_LOSS_ATOL, True),
            (torch.bfloat16, MP_BF16_BATCH, MP_BF16_ATOL, False)):
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
        small = [v[:batch] for v in views]
        runs = {}
        runs["single-card"] = _two_steps(_vit_state(dtype, batch=batch),
                                        make_train_step(0.1, use_fused=True),
                                        *small)
        dp = _vit_state(dtype, batch=batch)
        cross_replica_batch_norm(dp.model, torch.distributed.group.WORLD)
        runs["data-parallel"] = _two_steps(dp, make_sharded_train_step(
            None, 0.1), *small)
        for axes in ("data", "both"):
            runs[f"tp loss_axes={axes}"] = _two_steps(
                shard_train_state(_vit_state(dtype, batch=batch), model,
                                  data),
                make_tp_simclr_train_step(0.1, loss_axes=axes), *small)
        _compare_steps("tp", f"ViT-B/16 {str(dtype)[6:]}, batch {batch}",
                       runs, atol, params)
        torch.cuda.empty_cache()
    _TEMPLATES.clear()
    return launches


def phase_tp_clip(card_line: str) -> dict:
    """[tp-clip]: make_tp_clip_train_step on OpenAI CLIP ViT-B/16 with
    --moe-experts 8 at the (1, 1) grid: the timed path at batch 256, then
    one step against the single-card and world-1 data-parallel MoE CLIP
    steps, fp32 and bf16. Returns the launches."""
    import torch

    from ntxent_tpu_torch.parallel.tp import (
        make_tp_clip_train_step,
        shard_train_state,
    )
    from ntxent_tpu_torch.training import (
        make_clip_train_step,
        make_sharded_clip_train_step,
    )

    data, model = _world1_grid()
    gen = torch.Generator("cuda").manual_seed(7)
    images = torch.rand(256, 224, 224, 3, device="cuda", generator=gen)
    tokens = torch.randint(1, 49408, (256, 77), device="cuda", generator=gen)
    state = shard_train_state(_clip_state(torch.bfloat16, moe=8), model,
                              data)
    launches = _timed_steps(
        "tp-clip", state, make_tp_clip_train_step(moe_aux_weight=0.01),
        (images, tokens), CLIP_DP_STEP_LAUNCHES, card_line,
        "Megatron TP CLIP ViT-B/16 flash + MoE 8 (bf16) at the (1, 1) grid, "
        "batch 256")
    del state
    torch.cuda.empty_cache()
    for dtype, batch, atol, params in (
            (torch.float32, PARITY_BATCH, PARITY_LOSS_ATOL, True),
            (torch.bfloat16, MP_BF16_BATCH, MP_BF16_ATOL, False)):
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
        batch_in = (images[:batch], tokens[:batch])
        runs = {
            "single-card": _two_steps(_clip_state(dtype, 8),
                                     make_clip_train_step(
                                         use_fused=True, moe_aux_weight=0.01),
                                     *batch_in),
            "data-parallel": _two_steps(_clip_state(dtype, 8),
                                       make_sharded_clip_train_step(
                                           None, moe_aux_weight=0.01),
                                       *batch_in),
            "tp": _two_steps(shard_train_state(_clip_state(dtype, 8), model,
                                              data),
                            make_tp_clip_train_step(moe_aux_weight=0.01),
                            *batch_in)}
        _compare_steps("tp-clip", f"CLIP ViT-B/16 + MoE 8 {str(dtype)[6:]}, "
                       f"batch {batch}", runs, atol, params)
        torch.cuda.empty_cache()
    _TEMPLATES.clear()
    return launches


def phase_fsdp(tmp: str, card_line: str) -> dict:
    """[fsdp]: ResNet-50 SimCLR with --fsdp through ``ntxent-train`` in the
    NCCL group of world 1 (ZeRO-3's step; the data-parallel path's
    launches), saved under FSDP and restored on a single card CRC for
    CRC; then one fp32 step against the world-1 data-parallel step.
    Returns the launches."""
    import os

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.training import CheckpointManager, create_train_state
    from ntxent_tpu_torch.utils.profiling import launch_counters

    ckpt = os.path.join(tmp, "fsdp_ckpt")
    argv = _ckpt_argv(FSDP_ARGV, ckpt, MP_STEPS, every=10 * MP_STEPS,
                      keep=1)
    args = cli.build_train_parser().parse_args(argv)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, history, stats = _train_ckpt(argv, data_parallel=True)
    launches = {n: w.launches for n, w in counters.items()}
    want = {n: DP_STEP_LAUNCHES.get(n, 0) * MP_STEPS for n in counters}
    if launches != want or state.sharding is None:
        fail(f"FSDP launches {launches}, expected {want}; sharded "
             f"{state.sharding is not None}")
    peak = torch.cuda.max_memory_allocated()
    from ntxent_tpu_torch.parallel import param_bytes_per_device

    per_dev = param_bytes_per_device(state)
    del state
    torch.cuda.empty_cache()
    single = create_train_state(cli.build_model(args), cli._train_config(
        args), torch.device("cuda"))
    manager = CheckpointManager(ckpt)
    try:
        single = manager.restore(single)
    finally:
        manager.close()
    saved = _manifest_crcs(ckpt)[MP_STEPS]
    got = _state_crc(single)
    if single.step != MP_STEPS or got != saved:
        fail(f"[fsdp] the single-card restore of step {MP_STEPS} re-saves as "
             f"{got} (size, crc32), the FSDP save wrote {saved}")
    del single
    torch.cuda.empty_cache()
    step_ms = _steady_ms(history)
    print(f"[fsdp] ResNet-50 SimCLR --fsdp (ZeRO-3 over the NCCL group of "
          f"world 1), batch {args.batch}, {MP_STEPS} steps: losses "
          f"{[round(h['loss'], 4) for h in history]}; launches per step "
          f"{ {n: c // MP_STEPS for n, c in launches.items() if c} }; step "
          f"{step_ms:.1f} ms (steps 2-{MP_STEPS}, host clock around a "
          f"synchronizing loss read), {2 * args.batch / step_ms * 1e3:.1f} "
          f"images/s; parameter bytes a rank {per_dev}; peak memory "
          f"{peak / 2**30:.2f} GiB; saved under FSDP, restored on a single "
          f"card: state.msgpack {saved} (size, crc32) both ways; save ms "
          f"{_ms(stats.get('save_ms', []))} on {card_line}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    views = [torch.from_numpy(rng.uniform(size=(
        DP_PARITY_BATCH, 224, 224, 3)).astype(np.float32)) for _ in range(2)]
    loss_dp, g_dp = _dp_parity_step(True, views)
    loss_f, g_f = _dp_parity_step(True, views, fsdp=True)
    err = abs(loss_f - loss_dp)
    rel = ((g_f - g_dp).norm() / g_dp.norm()).item()
    ok = err <= PARITY_LOSS_ATOL and rel <= PARITY_GRAD_RTOL
    print(f"[fsdp] ResNet-50 train step float32, batch {DP_PARITY_BATCH}: "
          f"loss FSDP (world 1) {loss_f:.6f} vs data-parallel (world 1) "
          f"{loss_dp:.6f} (|err| {err:.2e}, atol {PARITY_LOSS_ATOL:.2e}); "
          f"relative gradient error {rel:.2e} (rtol {PARITY_GRAD_RTOL:.2e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the FSDP step disagrees with the data-parallel step")
    return launches


def phase_pp(card_line: str) -> dict:
    """[pp]: make_pipelined_apply on LongContextTransformer at its defaults
    over the stage group of world 1 (B 4, L 8192, 4 microbatches): the
    launches of a forward and backward, its output and every gradient
    against the plain apply of the same weights, and the times of both.
    Returns the launches of one pipelined pass."""
    import torch

    from ntxent_tpu_torch.models import make_pipelined_apply
    from ntxent_tpu_torch.ops.attention import flash_attention
    from ntxent_tpu_torch.utils.profiling import (
        build_long_context,
        launch_counters,
        long_context_tokens,
    )

    model = build_long_context("cuda", flash_attention)
    tokens = long_context_tokens("cuda", PP_LEN, PP_BATCH)
    pipe = make_pipelined_apply(model, torch.distributed.group.WORLD,
                                num_microbatches=PP_MICRO)
    counters = launch_counters()
    results = {}
    for label, fn in (("pipelined", pipe), ("plain", model)):
        times = []
        for _ in range(2):
            for wrapper in counters.values():
                wrapper.launches = 0
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tokens)
            out.float().pow(2).sum().backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {n: w.launches for n, w in counters.items()}
        results[label] = (out.detach(), torch_cat(
            [p.grad for p in model.parameters()]), times, launches)
    want = {n: PP_LAUNCHES.get(n, 0) for n in counters}
    out_p, g_p, t_p, launches = results["pipelined"]
    out_q, g_q, t_q, _ = results["plain"]
    out_err, grad_err = _rel(out_p, out_q), _rel(g_p, g_q)
    ok = (launches == want and torch.isfinite(g_p).all().item()
          and out_err <= LONGCTX_OUT_RTOL and grad_err <= LONGCTX_GRAD_RTOL)
    print(f"[pp] make_pipelined_apply, LongContextTransformer 512/8/8/2048 "
          f"bf16, B {PP_BATCH}, L {PP_LEN}, {PP_MICRO} microbatches over the "
          f"NCCL stage group of world 1: forward + backward "
          f"{_ms(t_p)} ms (plain apply {_ms(t_q)} ms; host clock, "
          f"synchronized), launches "
          f"{ {n: c for n, c in launches.items() if c} }; "
          f"output |a - b| / |b| {out_err:.2e} (rtol {LONGCTX_OUT_RTOL:g}), "
          f"gradients {grad_err:.2e} (rtol {LONGCTX_GRAD_RTOL:g}) against the "
          f"plain apply {'ok' if ok else 'MISMATCH'} on {card_line}",
          flush=True)
    if not ok:
        fail(f"the pipelined long-context pass disagrees with the plain one "
             f"(launches {launches}, expected {want})")
    del model, results
    torch.cuda.empty_cache()
    return launches


def phase_eval_moe(ckpt: str, card_line: str) -> dict:
    """[eval-moe]: ``ntxent-eval --protocol knn`` of [moe]'s checkpoint
    (the MoE ViT-B/16 restored from the save): #11 12 times a feature
    batch, every other kernel never; returns the launches of a feature
    batch."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_eval_parser().parse_args(
        EVAL_ARGV + ["--moe-experts", "8", "--ckpt-dir", ckpt, "--protocol",
                     "knn", "--max-train", "256", "--max-test", "128",
                     "--batch", "128"])
    xtr, _, xte, _ = cli._labeled_arrays(args)
    # knn extracts the train and test images as one array (cli.evaluate)
    batches = -(-(len(xtr) + len(xte)) // args.batch)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    result = cli.evaluate(args)
    eval_s = time.monotonic() - t0
    launches = {n: w.launches for n, w in counters.items()}
    want = {n: 0 for n in counters}
    want["flash_attention_fwd"] = 12 * batches
    if result.get("step") != MOE_STEPS or launches != want \
            or not math.isfinite(result.get("knn_top1", float("nan"))):
        fail(f"eval of the MoE checkpoint: {result}, launches {launches}, "
             f"expected step {MOE_STEPS} and {want}")
    fwd = launches["flash_attention_fwd"]
    print(f"[eval-moe] ntxent-eval --moe-experts 8 --protocol knn on [moe]'s "
          f"step {result['step']}: {result} in {eval_s:.1f} s; launches "
          f"{ {n: c for n, c in launches.items() if c} } over {batches} "
          f"feature batches of {args.batch} ({len(xtr)} train and "
          f"{len(xte)} test images), every other kernel 0, on {card_line}",
          flush=True)
    return {"flash_attention_fwd": fwd // batches}


def main() -> int:
    import torch

    t_start = time.monotonic()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs on "
              "the GPU only", file=sys.stderr)
        return 1
    import ntxent_tpu_torch  # noqa: F401 — fail before any result line

    kind, smi = phase_card()
    build_logs = phase_build()
    if sys.argv[1:] == ["--truth"]:
        # the bf16 kernels' fp32-truth readings alone, ungated: how each
        # factor is set from the kernels a change replaces
        from ntxent_tpu_torch.utils.capability import set_fp32_precision

        set_fp32_precision()
        for gate in TRUTH_GATES:
            _truth_gate(*gate, gate=False)
        for label, length in HOP_LENGTHS:
            bwd = _hop_backward(*_hop_tensors(length))
            _hop_bwd_check(label, bwd, gate=False)
            del bwd
            torch.cuda.empty_cache()
        return 0
    twopass_fields = phase_twopass_kernels()
    dp_clip_kernels, sym_retimed_ms = phase_dp_clip_kernels(build_logs)
    tri_kernels, tri_launches = phase_tri_kernels(build_logs)
    wide_fields = phase_wide_d()
    flash_fp32 = phase_flash_fp32()
    fold_kernel, ring_times = phase_fold_kernel()
    kernels = [phase_kernels(), *phase_ntxent_kernels(build_logs),
               *phase_flash_backward(), *phase_infonce_kernels(build_logs),
               *phase_general_kernels(), *dp_clip_kernels,
               *phase_pair_kernels(build_logs), *tri_kernels,
               fold_kernel]
    kernels[1]["retimed_ms"] = sym_retimed_ms
    phase_emulated_ranks()
    phase_dp_clip_emulated_ranks()
    phase_twopass_emulated_ranks()
    phase_pair_emulated_ranks()
    phase_emulated_rings()
    ring_times |= phase_ring_ntxent_emulated()
    serve_launches = phase_serve(smi)
    train_launches = phase_train(smi)
    phase_wide_train(smi)
    phase_step_parity()
    clip_launches = phase_clip_train(smi)
    phase_clip_parity()
    with tempfile.TemporaryDirectory() as tmp:
        dir_a, state_a, crc_a = phase_resume(tmp, smi)
        phase_serve_ckpt(dir_a, state_a)
        del state_a
        torch.cuda.empty_cache()
        int8_launches = phase_serve_int8(smi)
        ladder_launches = phase_serve_ladder(smi)
        worker_launches = phase_serve_worker(tmp, dir_a, smi)
        fleet_launches = phase_fleet(tmp, dir_a, smi)
        phase_retrieval_scale(smi)
        accum_lag_launches = phase_accum_lag(smi)
        phase_preempt(tmp, crc_a)
        shutil.rmtree(dir_a)
        clip_dir = phase_resume_pair(tmp, CLIP_ARGV, "clip")
        guard_launches = phase_guard(smi)
        remat_launches = phase_remat(smi)
        phase_accum(tmp, smi)
        phase_supervise(tmp, crc_a)
        phase_crash_audit(tmp, smi)
        store, data_ckpt, data_launches = phase_data(tmp, smi)
        phase_data_lag(smi)
        phase_data_lag_nan(store, smi)
        eval_launches = phase_eval(tmp, data_ckpt, clip_dir, smi)
        shutil.rmtree(clip_dir)
        shutil.rmtree(data_ckpt)
        phase_data_imagefolder(tmp, smi)
        obs_launches = phase_obs_train(tmp, smi)
        stem_launches = phase_stem(tmp, smi)
        t_mp = time.monotonic()
        moe_launches, moe_dir = phase_moe(tmp, smi)
        eval_moe_launches = phase_eval_moe(moe_dir, smi)
        shutil.rmtree(moe_dir)
        t_mp = time.monotonic() - t_mp
    from ntxent_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_from_file(f"{tmp}/store", 0, 1, device="cuda")
        try:
            t_wire, dp_f32 = time.monotonic(), {}
            dp_launches = phase_dp_train(smi, out=dp_f32)
            dp_pair_launches = phase_dp_train(
                smi, DP_PAIR_ARGV, DP_PAIR_STEP_LAUNCHES, "dp-pair")
            phase_dp_parity()
            t_wire = time.monotonic() - t_wire
            phase_audit(smi)
            t0 = time.monotonic()
            dp_chunked_launches = phase_dp_chunked(smi)
            ring_times_chunked = phase_chunked_emulated()
            wire_launches = phase_wire(smi, dp_f32)
            wire_clip_launches = phase_wire_clip(smi)
            phase_resume_ef(tmp)
            print(f"[wire] the data-parallel wire's phases ran "
                  f"{time.monotonic() - t0:.1f} s (phases 11, 12 and "
                  f"12f: {t_wire:.1f} s)", flush=True)
            shutil.rmtree(phase_resume_pair(tmp, DP_ARGV, "dp",
                                            data_parallel=True))
            phase_remat_dp()
            clip_dp_launches = phase_clip_dp_train(smi)
            phase_clip_dp_parity()
            twopass_launches = phase_twopass_train(smi)
            longctx_launches = phase_long_context(smi)
            phase_world1_plans()
            phase_ring_infonce()
            t0 = time.monotonic()
            phase_moe_ep()
            tp_launches = phase_tp(smi)
            tp_clip_launches = phase_tp_clip(smi)
            fsdp_launches = phase_fsdp(tmp, smi)
            pp_launches = phase_pp(smi)
            print(f"[mp] the model-parallel and MoE phases ran "
                  f"{t_mp + time.monotonic() - t0:.1f} s", flush=True)
        finally:
            mesh.shutdown()
    paths = (train_launches, clip_launches, dp_launches, clip_dp_launches,
             dp_pair_launches, tri_launches, longctx_launches)
    for wrapper, fields in (*twopass_fields.items(),
                            *ring_times_chunked.items()):
        ring_times.setdefault(wrapper, {}).update(fields)
    for kernel in kernels:
        # launches on the path that runs the kernel (SimCLR for the
        # symmetric NT-Xent and flash kernels, CLIP for the square InfoNCE
        # kernels, the data-parallel ResNet-50 for the general NT-Xent
        # kernels, the data-parallel CLIP for the rectangular InfoNCE
        # kernels, the data-parallel ResNet-50 with --dp-loss pair for the
        # shard-pair kernels, one triangular loss's forward and backward
        # for the triangular kernels, one long-context forward and backward
        # for the fold kernel), and on each path but SimCLR's (the two-pass
        # CLIP step's: the general NT-Xent kernels twice a step)
        wrapper = kernel["name"]
        kernel["launches"] = next((path[wrapper] for path in paths
                                   if path[wrapper]), 0)
        kernel["clip_launches"] = clip_launches[wrapper]
        kernel["dp_launches"] = dp_launches[wrapper]
        kernel["clip_dp_launches"] = clip_dp_launches[wrapper]
        kernel["dp_pair_launches"] = dp_pair_launches[wrapper]
        kernel["tri_launches"] = tri_launches[wrapper]
        kernel["longctx_launches"] = longctx_launches[wrapper]
        kernel["clip_twopass_launches"] = twopass_launches[wrapper]
        # the data-parallel wire: --dp-loss chunked --ring-chunks 4, the
        # strip under bf16 and int8, the pair under int8, CLIP under int8
        # (2 steps)
        kernel["dp_chunked_launches"] = dp_chunked_launches[wrapper]
        for dtype, per in wire_launches.items():
            kernel[f"wire_{dtype}_launches"] = per[wrapper]
        kernel["wire_clip_launches"] = wire_clip_launches[wrapper]
        # a step of the SimCLR path guarded, and under --remat
        kernel["guard_launches"] = guard_launches[wrapper]
        kernel["remat_launches"] = remat_launches[wrapper]
        # a step of the SimCLR path from the npy store (way c: native
        # loader, prefetch, lag-1 guard); a feature batch and a fine-tuning
        # step of ntxent-eval
        kernel["data_launches"] = data_launches.get(wrapper, 0)
        # a step of the SimCLR path with the telemetry flags, and of
        # ResNet-50 with --stem space_to_depth
        kernel["obs_train_launches"] = obs_launches.get(wrapper, 0)
        kernel["stem_launches"] = stem_launches.get(wrapper, 0)
        # model parallelism and MoE: a step of the SimCLR MoE path, a
        # feature batch of its eval, a world-1 step of TP SimCLR, of TP
        # CLIP with MoE and of FSDP ResNet-50, one pipelined long-context
        # forward and backward
        kernel["moe_launches"] = moe_launches[wrapper] // MOE_STEPS
        kernel["eval_moe_launches"] = eval_moe_launches.get(wrapper, 0)
        kernel["tp_launches"] = tp_launches[wrapper] // MP_STEPS
        kernel["tp_clip_launches"] = tp_clip_launches[wrapper] // MP_STEPS
        kernel["fsdp_launches"] = fsdp_launches[wrapper] // MP_STEPS
        kernel["pp_launches"] = pp_launches[wrapper]
        for key, per in eval_launches.items():
            kernel[key] = per.get(wrapper, 0)
        kernel |= ring_times.get(wrapper, {})
        kernel |= wide_fields.get(wrapper, {})
        kernel |= flash_fp32.get(wrapper, {})
    kernels[0]["serve_launches"] = serve_launches
    # #11 over the new serve paths: the int8 rung's chunks, the adaptive
    # ladder's phase (chunks, background first runs, direct forwards) and
    # the fleet worker's phase (chunks and first runs)
    kernels[0]["serve_int8_launches"] = int8_launches
    kernels[0]["serve_ladder_launches"] = ladder_launches
    kernels[0]["serve_worker_launches"] = worker_launches
    # and over the fleet's workers that exited cleanly (the drained one,
    # and the restarted one at the shutdown)
    kernels[0]["fleet_launches"] = fleet_launches
    for kernel in kernels:
        # a micro-step of SimCLR under --accum-steps 2 --lag-metrics
        kernel["accum_lag_launches"] = accum_lag_launches.get(
            kernel["name"], 0)
    print("[time] seconds by phase: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in sorted(
            PHASE_SECONDS.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"[total] chip_smoke.py ran {time.monotonic() - t_start:.1f} s "
          "(the kernels' build included)", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# Wall seconds of each phase function over the run (the [time] line):
# where the script's time limit goes when it grows.
PHASE_SECONDS: dict = {}


def _timed(fn):
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            key = fn.__name__.removeprefix("phase_")
            PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) \
                + time.monotonic() - t0

    return wrapper


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])


if __name__ == "__main__":
    sys.exit(main())
