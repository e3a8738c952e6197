#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of the repository, with one NVIDIA Hopper card visible:

    python3 chip_smoke.py

Phases (each prints one JSON line, with the seconds since the start as
``elapsed_s``; any failure exits non-zero before the last line):

1. env: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc compiles deepspeed_tpu_torch/csrc/fused_optim.cu,
   stream_attention.cu and block_attention.cu for sm_90a, one nvcc each,
   in parallel, and prints each kernel's registers, spills and static
   shared memory (ptxas -v).
3. tiny_parity: a tiny BERT trained 3 steps on the card and on the CPU
   (the kernels' plain versions) from the same weights must agree: at
   seq 64 (the einsum attention), then at seq 256 with padded rows (the
   streaming attention kernels), once with DSTPU_STREAM_BWD=fused and once
   with split, each with its launch counts checked.  Then a tiny GPT-2
   (seq 128, causal: the whole-tile kernels) the same way, 3 Adam steps.
   dispatch: dispatch_attention on the card against the CPU for every
   legal (forward, backward) pair of {xla, block} at seq 128 and of
   {xla, stream} at seq 256, each with its launch counts checked.
4. train: BERT-large pretraining (seq 128, bf16, LAMB lr 4e-3 max_coeff
   0.5 min_coeff 0.08, 20 masked positions, ZeRO off, micro-batch 32,
   gas 2) through ``deepspeed_tpu_torch.initialize`` + ``train_batch`` for
   6 steps from seeded random weights; losses finite, and every LAMB step
   through the kernels (launch counts = 22 leaves x 6 steps).
5. kernels: each optimizer kernel against its plain version on the real
   BERT-large leaves, grads and moments after step 6, with times, the
   least time the card could take (bound) and a library yardstick.
6. profile: one more LAMB step of the same engine under torch.profiler:
   device busy ms per step, busy share, top CUDA kernels by device time;
   each kernel row's ``profile_ms`` comes from its path's profile.
7. adam: 2 AdamW steps of BERT-large, every step through the Adam kernel.
   closure: the main path's end, under torch.use_deterministic_algorithms
   (CUBLAS_WORKSPACE_CONFIG=:4096:8 from the script's start).  A synthetic
   MLM corpus (seq 128, 20 masked positions, NSP labels; 8 global batches
   of 32 x gas 2) is written with FileDataset.save; BERT-large with NSP,
   max_seq_len 512 and "selective" remat trains on it through
   initialize(training_data=...) (one producer thread, the native
   collate), LAMB with WarmupLR.  Run A takes 6 steps and saves after step
   3 with the loader's state as client_state; run B, a fresh engine from
   another init seed, loads it, restores the loader and takes steps 4-6.
   Run B's losses, masters, moments, step, loss-scale state, LR and
   counters must equal run A's bitwise (torch.equal on the card).  Then
   BertForQuestionAnswering (same size) starts from that checkpoint
   (load_module_tree + init_from_module_tree: every backbone leaf must
   transfer) and fine-tunes 6 Adam steps (lr 3e-5) at seq 384, micro-batch
   8, gas 2, on synthetic answerable spans; finite losses, and span EM/F1
   on one eval batch as a smoke check.  Launch counts exact throughout.
8. train512: BERT-large at seq 512 (80 masked positions, padded rows,
   micro-batch 8, gas 2, otherwise as train) for 6 steps; every attention
   through the streaming kernels (24 layers x 2 micro-batches x 6 steps
   forward launches, and backward launches of the kernels
   DSTPU_STREAM_BWD=auto takes at this shape: at the committed budget of 0
   the split pair) and every LAMB step through its kernels; then 3 steps
   of the same engine on the einsum attention (DSTPU_FUSED_ATTN=0) as a
   yardstick, and a profile of one step.  train512_selective: a fresh
   engine with "selective" remat (bench.py's seq-512 recipe) on the same
   weights and batch for 6 steps: the remat-off run's launches plus one
   recomputed stream forward per layer and micro-step (288), losses within
   1e-2 relative of the remat-off run's, its peak memory beside that
   run's.
9. train_gpt2_1024: GPT-2 medium at its 1024-token context (bf16, Adam
   lr 1e-4, micro-batch 4, gas 2) for 6 steps, twice from the same weights
   and batch: the streaming backward as the split pair
   (DSTPU_STREAM_BWD=split: 288 forward, 288 dkv and 288 dq launches),
   then fused (288 fused backwards); losses agree step by step within
   1e-2 relative; a profile of one step of each (profile_gpt2_1024,
   profile_gpt2_1024_fused).
10. attn_kernels: each attention kernel against its plain version at the
   seq-512 shape (B=8, n=16, T=512, d=64, bf16, padded keys), with times,
   bounds and torch's scaled_dot_product_attention as the yardstick (also
   pinned to each masked backend, phase attn_library); the split pair
   also causal and with a fully padded row; every stream kernel also at
   the GPT-2 seq-1024 path's shape (causal), and there twice for bitwise
   repeatability.
11. bwd_sweep: the fused backward against the split pair by sequence
   length (16 heads, d 64, 4,096 tokens per call, T 256-2048, causal and
   not), in bf16 and in fp32, device time, the forward excluded; each
   row's fused scratch and the mode auto takes, and the scratch budget
   the rule of ops/stream_attention.py gives from these times, per dtype.
12. train_gpt2: GPT-2 medium causal-LM pretraining (seq 128, bf16, Adam
   lr 1e-4, ZeRO off, micro-batch 32, gas 2) for 6 steps; every attention
   through the whole-tile kernels (24 layers x 2 x 6 forward and backward
   launches) and every Adam step through its kernel (16 leaves x 6); then 3
   steps on the einsum attention as a yardstick, and a profile of one
   step.
13. block_kernels: each whole-tile kernel against its plain version at the
   GPT-2 shape (B=32, n=16, T=128, d=64, bf16, causal; q, k, v views of the
   packed qkv), and once with padded keys and a fully padded row, with
   times, bounds and scaled_dot_product_attention(is_causal=True); both
   checks again at tp_gpt2's shape (n=8 local heads).
14. zero_gpt2: GPT-2 medium as train_gpt2 on a one-rank NCCL process group
   (one card: data-parallel size 1, started through the port's
   init_distributed), 6 steps each with ZeRO off, stage 1 with overlap_comm
   off, stage 1 and stage 2 with it on (32 MB buckets: 43 over the
   354,871,296-element partition, no padding): launches exact (Adam 96, 6,
   258, 258; whole-tile 288 + 288 each; LAMB 0), the three ZeRO runs'
   losses and flat masters bitwise equal, ZeRO against off within 1e-5
   relative (and whether bitwise), samples/s, step ms and peak memory of
   each.  kernels_flat_adam: the Adam kernel on the whole flat partition
   (one launch) and as the 43-bucket loop against adam_plain, with graph
   and event times, the bound and torch.optim.AdamW(fused=True,
   capturable=True) on one flat tensor; the kernels line's adam row
   carries them as ``flat_partition``.
15. zero_ckpt: stage 2 (overlap on) under the deterministic flag: run A
   takes 6 steps and saves after step 3 (the model-state file and one
   ZeRO partition file), run B, from another seed, loads it and takes
   steps 4-6; losses, flat master, moments, step, loss scale and counters
   bitwise equal to run A's; save bytes and seconds, load seconds.  Then
   a third engine loads the save through the restore plan with
   ``checkpoint.restore_threads`` 1 and 8: both bitwise equal to the
   saved state, each with its ``restore_seconds``.
   gpt2_reference: train_gpt2's run at EARLY_LAYERS (6) of GPT-2
   medium's 24 layers, full width: the losses tp_gpt2, pp_gpt2 and
   zero3_pp_gpt2 are held to, since the multi-rank phases 16-20 run at
   that depth so that the script stays inside its time limit with phase
   21.  gpt2_1024_reference: train_gpt2_1024's run at that depth, for
   sp_gpt2.
16. tp_gpt2: GPT-2 medium (6 layers) as train_gpt2 at mp 2, dp 1, as two
   processes on the one card (``chip_smoke.py --tp-child``) over a gloo
   model group
   (NCCL refuses two ranks on one device, so each collective stages
   through the host, and the step times are not TP's on NVLink), from
   train_gpt2's seed-0 weights cut by the engine: (a) ZeRO off, (b) ZeRO-1
   with overlap_comm (32 MB buckets over the local flat), saved after
   step 3, (c) fresh processes resume that save, (d) this
   process loads its model states into an mp 1 engine, (e) a tiny fp32
   GPT-2 at mp 2 against mp 1.  Checks: losses bitwise equal across the
   ranks, the 9 replicated leaves' masters too, (a) within 2e-2 of
   gpt2_reference, (b) bitwise equal to (a), (c) bitwise (losses, flat
   master, moments, step, loss scale), (d) equal to the joined shards, (e)
   within 1e-5, launches exact per rank (whole-tile 144 + 144, Adam 96 in
   (a), and the bucket count a step in (b)); step ms, peak memory per
   rank, the save's file sizes.
17. zero3_gpt2: GPT-2 medium (6 layers) under ZeRO-3 at dp 2 (seq 128,
   bf16, Adam lr 1e-4, micro-batch 16 per rank, gas 2: train_gpt2's 64
   rows a step), as
   two processes on the one card (``chip_smoke.py --z3-child``) over a
   gloo data group (every gather and reduce-scatter stages through the
   host: the step times are not ZeRO-3's on NVLink), from train_gpt2's
   seed-0 weights: (a) on-demand gathers, 6 steps, saved after step 3;
   (b) overlap_comm (the gather prefetch) and (c) "full" remat, 3 steps
   each, bitwise equal to (a) in losses and both ranks' master, m and v
   shards, (c) at a lower peak; (d) ZeRO-1 at dp 2 within 1e-2 of (a);
   fresh processes resume (a)'s save, bitwise equal to its steps 4-6;
   this process loads the save at dp 1, stage 0 (the shard files
   rehydrated) and takes steps 4-6 within 1e-2 of (a)'s.  Launches exact
   per rank (Adam 16 shard leaves a step, whole-tile 24 + 24, the remat
   replaying the forward); the layout, peak memory, step ms, the save's
   files, save and load seconds.
18. pp_gpt2: GPT-2 medium (6 layers) at pp 2 (3 a stage; seq 128, bf16,
   Adam lr 1e-4, micro-batch 32, gas 2, 8 pipeline micro-batches of 4
   rows, so the head is sharded over the stages), as two stage processes
   on the one card (``chip_smoke.py --pp-child``) over a gloo pipe group
   (activations, gradients and the stage-replicated leaves' gradient sum
   stage through the host: the step times are not a pipeline's on
   NVLink), from train_gpt2's seed-0 weights and batch: (a) GPipe, 6
   steps, saved after step 3, within 2e-2 of gpt2_reference's losses; (b)
   1F1B, 3 steps, within 1e-2 of (a) at a lower peak on both stages, with
   3 and 0 stage inputs held; (c) GPipe with ZeRO-1 (one flat Adam launch
   a step per stage), bitwise equal to (a); (d) fresh processes resume
   (a)'s save bitwise (losses, masters, moments).  Launches exact per
   stage (whole-tile 96 + 96 a step; 1F1B replays the forward on stage
   0; Adam 16 leaves a step); one model file per stage, peak memory,
   step ms, save and load seconds.
19. sp_gpt2: GPT-2 medium (6 layers) at seq 1024 and sp 2, dp 1, as two
   seq-rank processes on the one card (``chip_smoke.py --sp-child``) over a
   gloo seq group (the ring's shifts, Ulysses' all-to-alls and the
   gradients' seq sum stage through the host: not NVLink's step times),
   train_gpt2_1024's seed-0 weights and batch, 512 tokens a rank: (a)
   ring attention, 6 steps, saved after step 3; (b) Ulysses (8 local heads
   of 16), 3 steps; (c) fresh processes resume (a)'s save.  Checks: (a)
   and (b) within 1e-2 of gpt2_1024_reference's losses step for step and
   of each other, (c) bitwise equal to (a)'s steps 4-6, launches exact per
   rank (the ring: no attention kernel; Ulysses: 12 streaming forwards,
   dkv and dq a step at G = 4 x 8, T 1024; Adam 16 leaves a step), the
   save the files of an sp 1 save (this process loads it at sp 1 and saves
   it again: the same names and sizes); the peak per rank, step ms.
20. zero3_pp_gpt2: GPT-2 medium (6 layers) at seq 128 under ZeRO-3 at dp
   2 x pp 2, as four processes (``chip_smoke.py --z3pp-child``) over gloo,
   train_gpt2's weights and 64-row batch (a data rank's 32 rows as
   micro-batch 16 x gas 2, 4 pipeline micro-batches of 4 rows): (a)
   GPipe, 4 steps, saved after step 2, within 2e-2 of gpt2_reference's
   losses; (b) 1F1B, 3 steps, within 1e-2 of (a); (c) fresh processes
   resume (a)'s save bitwise.  Each rank holds half of its stage's
   partitioned leaves, the shard files carry the row ``pp_stage * mp +
   mp_rank``, and launches are exact per rank (whole-tile 24 + 24 a step,
   1F1B replaying the forward on stage 0; Adam 16 shard leaves a step).
21. moe_gpt2: GPT2MoE at GPT-2 medium's width with 8 experts a layer
   (top-1, capacity 1.25, aux weight 0.01; seq 128, bf16, Adam lr 1e-4,
   micro-batch 16, gas 2, seeded weights and batch, ZeRO off): (a) all 24
   layers (1,765,214,208 parameters, 17 leaves), 6 steps, each step's
   weighted aux term printed; the Adam kernel on the 805,306,368-element
   expert leaf against adam_plain, with its time and bound; (b) top-2, 3
   steps; (c) moe_reference: (a) at MID_LAYERS (12), 6 steps; (d) that model
   at ep 2 (mp 2) as two processes on the one card (``chip_smoke.py
   --moe-child``) over gloo, ZeRO-1, 6 steps, saved after step 3 (free
   space in build/ checked first), 4 experts a rank, within 2e-2 of (c)
   step for step; (e) fresh processes resume the save, bitwise equal
   (losses, flat master, moments).  Launches exact (Adam 17 leaves a step
   at ZeRO off, one flat launch a step at ep 2; whole-tile 48 + 48 a step
   at 24 layers, 24 + 24 a rank at 12); peaks, step ms, file sizes.
   multistep_gpt2: GPT-2 medium at MID_LAYERS under the deterministic
   flag, 8 batches as 8 ``train_batch`` calls and as two ``train_many``
   blocks of 4 fed by ``BlockPrefetcher(place=...)``: masters, moments,
   counters and the last loss bitwise equal; then in fp16 with a NaN loss
   at step 2 (``chaos.poison_batch`` on a float batch leaf the loss is
   multiplied by), one skip both ways; the second block's step ms both
   ways and exact launches.
   resume_gpt2: ``resilience.run_resumable`` over ``train_many`` blocks of
   2 in child processes (``chip_smoke.py --resume-child``; GPT-2 medium at
   MID_LAYERS, the watchdog armed, 4 restore readers): an unbroken child
   to step 8; then ONE run of the port's launcher (``python -m
   deepspeed_tpu_torch.launcher.launch --max_restarts 1
   --compile_cache_dir ...``) around a child SIGTERM'd by chaos at step 3,
   which drains at step 4, writes an emergency tag, dumps the flight
   recorder (``preempt``) and exits RESUME_EXIT_CODE, and its relaunch,
   which resumes to step 8, its masters bitwise equal to the unbroken
   child's (the launcher exits 0 after one relaunch, one restart, no
   second SIGTERM, no watchdog fire; the compile cache, seeded with this
   process's three kernel libraries, serves both attempts: 3 hits, 0
   misses, every library loaded from it).
   obs_gpt2: GPT-2 medium at 24 layers, train_gpt2's recipe, 8 steps
   with observability off and on (report window 4, the JSONL log, the
   torch.profiler window of steps 5-6, the health endpoints, MFU against
   989 TFLOP/s) under the deterministic flag: (a) masters bitwise; (b) in
   steps 2-3 no synchronizing CUDA call (``set_sync_debug_mode("warn")``)
   and no counted fence; (c) the log passes the port's validator CLI, one
   startup and two window events whose loss is the step's, exactly; (d)
   the trace loads, holds the dstpu/ ranges and 32 / 96 / 96 launches of
   the Adam and whole-tile kernels; (e) /healthz 200, /metrics parses;
   (f) fp16 at MID_LAYERS with a NaN loss at step 2: the window's skipped
   1, masters bitwise with the spool off.  Samples/s on and off, the
   window's MFU and peak memory are reported.
   fleet_gpt2: GPT-2 medium at EARLY_LAYERS, dp 2 as two processes
   (``chip_smoke.py --fleet-child``) over gloo on the one card, 4 steps,
   report window 2, the fleet view on; rank 1 stalls 2 s on the host
   before step 3: rank 0 writes 2 schema-valid fleet events naming both
   ranks and rank 1 none, the StragglerDetector flags rank 1 in window 2
   only, the masters agree bitwise, each rank's exit-time flight-recorder
   dump holds its 4 boundaries.
   ``chip_smoke.py --only obs_gpt2,fleet_gpt2`` (or any of zero_ckpt,
   moe_gpt2, multistep_gpt2, resume_gpt2) runs the build and the named
   phases alone, with no result line.
22. attn_sweep: kernel fwd+bwd against the einsum path's (16 heads, d 64,
   4,096 tokens per call), times only: streaming at seq 256, 512 and 1024,
   non-causal and causal, and whole-tile at seq 64 and 128, causal and
   non-causal, with the smallest seq where the kernel is >= 1.05x faster
   (the data for the dispatch defaults in models/layers.py).
23. calibrate: ``calibrate_stream_threshold()`` (bf16, causal, batch 8, 12
   heads, d 64, seq 256-2048, CUDA events): each seq's times, the
   threshold it returns and the port's table's; a disagreement is
   recorded, not a failure.

Kernel and plain times are a run of 20 back-to-back calls between one
pair of CUDA events, over 20, the median of 5 runs (``_time_ms``), in the
order plain, kernel, kernel, plain in one process; the library yardstick
and the attention kernels' ``ms`` are device times without host work: 20
calls captured in a CUDA graph and replayed between a pair of events
(``_graph_ms``; ``_library_ms``, ``_kernel_ms``), with the events'
reading beside them; ``profile_ms`` is a kernel's device time in its
path's training profile.

Then one line with the card's name and power limit, one JSON line with
every kernel, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.

fp32 matrix products run in full fp32 (TF32 off for matmul and cuDNN) so the
fp32 comparisons hold to fp32 tolerances.
"""

import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory bandwidth and fp32
# arithmetic outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SEQ, NPRED, MICRO, GAS, STEPS, ADAM_STEPS = 128, 20, 32, 2, 6, 2
TINY = dict(max_seq_len=64, vocab_size=512, num_layers=2, hidden_size=128,
            num_heads=4)
# (bytes, flops) per parameter of each kernel: read each input once, write
# each output once (csrc/fused_optim.cu header)
KERNELS = {
    "lamb_phase1": dict(bytes=28, flops=16,
                        replaces="deepspeed_tpu/ops/pallas_optim.py:68"),
    "lamb_phase2": dict(bytes=12, flops=2,
                        replaces="deepspeed_tpu/ops/pallas_optim.py:105"),
    "adam": dict(bytes=28, flops=17,
                 replaces="deepspeed_tpu/ops/pallas_optim.py:167"),
}
SOURCE = "deepspeed_tpu_torch/csrc/fused_optim.cu"
# kernel vs plain on identical fp32 inputs: the kernel contracts to FMAs
# and sums the norms in another order
RTOL, ATOL = 1e-5, 1e-6

ATTN_SOURCE = "deepspeed_tpu_torch/csrc/stream_attention.cu"
BLOCK_SOURCE = "deepspeed_tpu_torch/csrc/block_attention.cu"
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
SEQ512, NPRED512, MICRO512, TRAIN512_STEPS, YARDSTICK_STEPS = (512, 80, 8, 6,
                                                              3)
# training steps under torch.profiler a profile phase takes: its trace of
# every host op and kernel is what costs (15-25 s for 3 steps on an H100
# host), and a step's device time varies little from step to step
PROFILE_STEPS = 1
# BERT-large at seq 512, micro-batch 8: G = 8 x 16 heads, d = 64
ATTN_SHAPE = dict(B=8, n=16, T=512, d=64)
# product passes over T^2 d per G, and [G, T, d] operands / fp32 [G, T] rows
# (stream) or the fp32 [B, T] mask (block) read plus written once
# (csrc/stream_attention.cu and block_attention.cu headers)
ATTN_KERNELS = {
    "stream_fwd": dict(passes=2, tensors=4, rows=2,
                       replaces="deepspeed_tpu/ops/pallas_attention.py:268"),
    "stream_bwd_fused": dict(passes=5, tensors=7, rows=3,
                             replaces="deepspeed_tpu/ops/pallas_attention.py"
                                      ":371"),
    "stream_dkv": dict(passes=4, tensors=6, rows=3,
                       replaces="deepspeed_tpu/ops/pallas_attention.py:330"),
    "stream_dq": dict(passes=3, tensors=5, rows=3,
                      replaces="deepspeed_tpu/ops/pallas_attention.py:435"),
    "block_fwd": dict(passes=2, tensors=4, rows=0, mask=True,
                      replaces="deepspeed_tpu/ops/pallas_attention.py:106"),
    "block_bwd": dict(passes=5, tensors=7, rows=0, mask=True,
                      replaces="deepspeed_tpu/ops/pallas_attention.py:122"),
}
# the device function behind each row (its name in a profiler trace); the
# bf16/fp16 attention kernels, not their fp32 routes
DEVICE_SYMBOL = {"lamb_phase1": "lamb_phase1_kernel",
                 "lamb_phase2": "lamb_phase2_kernel", "adam": "adam_kernel",
                 "stream_fwd": "stream_fwd_wg_kernel",
                 "stream_bwd_fused": "stream_bwd_mma_kernel",
                 "stream_dkv": "stream_dkv_mma_kernel",
                 "stream_dq": "stream_dq_wg_kernel",
                 "block_fwd": "block_fwd_wg_kernel",
                 "block_bwd": "block_bwd_wg_kernel"}
# GPT-2 medium at seq 128 (bench.py's GPT-2 recipe: Adam lr 1e-4, bf16);
# micro-batch 32 x gas 2 gives both BERT phases' 4,096 tokens per micro-step
GPT2_SEQ, GPT2_STEPS = 128, 6
# GPT-2 medium at its published context (n_ctx 1024), micro-batch 4 x gas 2:
# 4,096 tokens a micro-step, as every other training phase
GPT2_1024_SEQ, GPT2_1024_MICRO = 1024, 4
# the split and the fused backward differ in their sums' order and bf16
# rounding only: their runs' losses agree within this, step by step
GPT2_1024_LOSS_RTOL = 1e-2
# the fused backward's scratch is cached for the process's life: the
# budget of ops/stream_attention.py never exceeds this
SCRATCH_CAP = 256 * 2 ** 20
BLOCK_SHAPE = dict(B=32, n=16, T=128, d=64)
# the dispatch threshold rule of pallas_attention.calibrate_stream_threshold
SWEEP_WIN = 1.05
# the main-path closure (phase closure): BERT-large pretraining as phase
# train, with NSP and bench.py's "selective" remat, from a file-backed corpus
# of CLOSURE_BATCHES global batches through the data loader; a save after
# step CLOSURE_SAVE_AT of CLOSURE_STEPS and a resume from it; then the SQuAD
# fine-tune at BingBertSquad's max_seq_length 384 (doc stride 128), Adam
# lr 3e-5, micro-batch 8, gas 2.  max_seq_len 512 is BERT's published
# position table, which the fine-tune reads up to 384.
CLOSURE_STEPS, CLOSURE_SAVE_AT, CLOSURE_BATCHES = 6, 3, 8
CLOSURE_MAX_SEQ = 512
FT_SEQ, FT_MICRO, FT_STEPS, FT_LR = 384, 8, 6, 3e-5
SELECTIVE = {"enabled": True, "policy": "selective"}
# the ZeRO phases (zero_gpt2, zero_ckpt): GPT-2 medium as train_gpt2 on a
# one-rank NCCL group, with each zero_optimization section below (None:
# off); overlap_comm's default bucket is 32 MB, 8,388,608 fp32 elements
ZERO_RUNS = (("off", None),
             ("stage1", {"stage": 1, "overlap_comm": False}),
             ("stage1_overlap", {"stage": 1, "overlap_comm": True}),
             ("stage2_overlap", {"stage": 2, "overlap_comm": True}))
# ZeRO against off: the same elementwise update through the same kernel,
# so bitwise is expected; the limit is the phase's check
ZERO_LOSS_RTOL = 1e-5
ZERO_SAVE_AT = 3
ZERO_MODEL_FILE = "mp_rank_00_model_states.pt"
ZERO_OPTIM_FILE = "zero_pp_rank_0_mp_rank_00optim_states.pt"
# kernel vs plain on identical bf16 inputs: |err| <= ATTN_ATOL * max|want|
# + ATTN_RTOL * |want|.  The kernels run the online softmax over 64-row kv
# tiles where the plain versions take the whole row, so the unnormalised
# p is rounded to bf16 at other values, and the sums run in another order.
ATTN_RTOL, ATTN_ATOL = 2e-2, 1e-2


#: the script's start, for each phase line's ``elapsed_s``
_START = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


@contextlib.contextmanager
def env(name, value):
    """``os.environ[name] = value`` inside the block (None: unset)."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _counted():
    from deepspeed_tpu_torch.ops import block_attention as battn
    from deepspeed_tpu_torch.ops import cuda_optim
    from deepspeed_tpu_torch.ops import stream_attention as sattn
    return cuda_optim, sattn, battn


def reset_launch_counts():
    for mod in _counted():
        mod.reset_launch_counts()


def launch_counts():
    return {k: v for mod in _counted() for k, v in mod.LAUNCHES.items()}


def no_launches(**counts):
    """Every kernel's count 0 except ``counts``."""
    return {**dict.fromkeys(launch_counts(), 0), **counts}


def auto_bwd_launches(dtype, G, T, d, calls):
    """The kernel launches of ``calls`` streaming backwards at [G, T, d] in
    DSTPU_STREAM_BWD=auto: the fused kernel while its scratch fits
    ``STREAM_FUSED_SCRATCH_BUDGET``, else the split pair."""
    from deepspeed_tpu_torch.ops import stream_attention as sattn
    if sattn._fused_bwd_fits(dtype, G, T, d):
        return {"stream_bwd_fused": calls}
    return {"stream_dkv": calls, "stream_dq": calls}


def bert_config(opt_type, params, gas=GAS, micro=MICRO, dtype="bf16",
                remat=False):
    cfg = {"train_batch_size": micro * gas,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": opt_type, "params": params},
           "activation_checkpointing": remat,
           "steps_per_print": 10 ** 9}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def mlm_batch(rows, seq, vocab, npred, seed=0, pad=False):
    """The masked-positions MLM batch bench.py builds (numpy, seeded);
    ``pad``: every third row ends in padding of a different length."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(rows, seq)).astype(np.int32)
    mask = np.ones((rows, seq), np.int32)
    if pad:
        for r in range(0, rows, 3):
            mask[r, seq - seq // 8 - 5 * r:] = 0
    tt = np.zeros((rows, seq), np.int32)
    pos = np.stack([rng.choice(seq, size=npred, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    mlm_ids = np.take_along_axis(ids, pos, axis=1)
    return (ids, mask, tt, pos, mlm_ids, np.ones((rows, npred), np.float32))


def lm_batch(rows, seq, vocab, seed=0):
    """The causal-LM batch bench.py builds (``:646-648``): tokens from
    ``default_rng(seed)``, labels the tokens shifted by one, the last -1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(rows, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def make_engine(cfg, device, size="large", seed=0, params=None, gpt2=False,
                **over):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2, BertForPreTraining
    gen = torch.Generator(device=device).manual_seed(seed)
    model = (GPT2 if gpt2 else BertForPreTraining).from_size(
        size, generator=gen, device=device, **over)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=cfg, model=model, model_parameters=params, device=device)
    return engine


def free(device):
    """Release what the phase before left: its engines hold themselves in
    reference cycles (the optimizer facade and the LR scheduler point back
    at the engine), which only the cycle collector frees."""
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def phase_tiny_parity(device, seq=64, bwd_mode=None):
    """3 LAMB steps of a tiny fp32 BERT on ``device`` and on the CPU.  From
    seq 256 the attention runs the streaming kernels, their backward in
    ``bwd_mode``, and the launch counts are checked."""
    import numpy as np

    from deepspeed_tpu_torch import weights
    tiny = dict(TINY, max_seq_len=seq)
    cfg = bert_config("Lamb", {"lr": 1e-3, "eps": 1e-6, "max_coeff": 0.5,
                               "min_coeff": 0.08, "weight_decay": 0.01},
                      micro=4, dtype="fp32")
    ref = make_engine(cfg, "cpu", size="tiny", **tiny)
    params = weights.params_to_numpy(ref.module)
    dev = make_engine(cfg, device, size="tiny", params=params, **tiny)
    losses = []
    with env("DSTPU_STREAM_BWD", bwd_mode):
        sync(device)
        reset_launch_counts()
        for step in range(3):
            batch = mlm_batch(8, seq, tiny["vocab_size"], 8,
                              seed=100 + step, pad=seq > 64)
            losses.append((float(dev.train_batch(batch)),
                           float(ref.train_batch(batch))))
        sync(device)
        launches = launch_counts()
    ok = _engines_agree(dev, ref, losses)
    # layers x micro-batches x steps
    attn = tiny["num_layers"] * 2 * 3 if seq >= 256 else 0
    split = bwd_mode == "split"
    expected = no_launches(
        lamb_phase1=len(ref.master) * 3, lamb_phase2=len(ref.master) * 3,
        stream_fwd=attn, stream_bwd_fused=0 if split else attn,
        stream_dkv=attn if split else 0, stream_dq=attn if split else 0)
    emit("tiny_parity", seq=seq, bwd_mode=bwd_mode, losses=losses,
         masters_rtol=1e-4, masters_atol=ATOL * 10, launches=launches,
         expected_launches=expected, ok=ok)
    if not ok or not np.isfinite(losses).all():
        raise AssertionError(f"tiny BERT at seq {seq} on the card disagrees "
                             f"with the CPU")
    if launches != expected:
        raise AssertionError(f"tiny BERT at seq {seq}: launches {launches}, "
                             f"expected {expected}")
    return launches


def _engines_agree(dev, ref, losses):
    """The card's masters within ``ATOL * 10 + 1e-4 |want|`` of the CPU's,
    and every loss pair within ``rtol=1e-4``."""
    worst = 0.0
    for k, want in ref.master.items():
        got = dev.master[k].cpu()
        err = (got - want).abs() - (ATOL * 10 + 1e-4 * want.abs())
        worst = max(worst, float(err.max()))
    return worst <= 0 and all(abs(a - b) <= 1e-4 * abs(b) for a, b in losses)


def gpt2_config(micro, dtype="bf16", lr=1e-4):
    """bench.py's GPT-2 recipe: Adam (L2 decay 0), ZeRO off."""
    return bert_config("Adam", {"lr": lr}, micro=micro, dtype=dtype)


def phase_tiny_gpt2_parity(device):
    """3 Adam steps of a tiny fp32 GPT-2 (2 layers, hidden 128, 4 heads,
    d 32, vocab 512, seq 128, causal) on ``device`` and on the CPU: the
    attention runs the whole-tile kernels, checked by their launch counts."""
    import numpy as np

    from deepspeed_tpu_torch import weights
    cfg = gpt2_config(4, dtype="fp32", lr=1e-3)
    ref = make_engine(cfg, "cpu", size="tiny", gpt2=True)
    params = weights.params_to_numpy(ref.module)
    dev = make_engine(cfg, device, size="tiny", gpt2=True, params=params)
    layers, seq = ref.module.config.num_layers, ref.module.config.max_seq_len
    losses = []
    with env("DSTPU_FUSED_ATTN", None):
        sync(device)
        reset_launch_counts()
        for step in range(3):
            batch = lm_batch(4 * GAS, seq, ref.module.config.vocab_size,
                             seed=100 + step)
            losses.append((float(dev.train_batch(batch)),
                           float(ref.train_batch(batch))))
        sync(device)
        launches = launch_counts()
    ok = _engines_agree(dev, ref, losses)
    attn = layers * GAS * 3                # layers x micro-batches x steps
    expected = no_launches(adam=len(ref.master) * 3, block_fwd=attn,
                           block_bwd=attn)
    emit("tiny_gpt2_parity", seq=seq, losses=losses, masters_rtol=1e-4,
         masters_atol=ATOL * 10, launches=launches,
         expected_launches=expected, ok=ok)
    if not ok or not np.isfinite(losses).all():
        raise AssertionError("tiny GPT-2 on the card disagrees with the CPU")
    if launches != expected:
        raise AssertionError(f"tiny GPT-2: launches {launches}, expected "
                             f"{expected}")


def phase_dispatch(device):
    """``dispatch_attention`` on the card against the same call on the CPU
    (plain versions), fp32, output and grads of a sum(sin(.)) loss, for
    every legal (forward, backward) pair of {xla, block} at seq 128 and of
    {xla, stream} at seq 256 (causal, one padded key row), each with its
    launch counts checked.  (stream, block) needs a shape both kernels take:
    streaming starts at seq 256, the whole-tile kernels end at 128."""
    import itertools

    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import block_attention as battn
    from deepspeed_tpu_torch.ops import dispatch_attention as dattn
    from deepspeed_tpu_torch.ops import stream_attention as sattn
    B, n, d = 2, 4, 32
    rows, bad = [], []
    both = [T for T in (128, 256, 512) if battn.kernel_supported(T, d)
            and sattn.stream_supported(T, d)]
    cases = [(128, ("xla", "block")), (256, ("xla", "stream"))]
    cases += [(T, ("stream", "block")) for T in both]
    for T, impls in cases:
        rng = np.random.default_rng(T)
        x = [rng.normal(size=(B, T, n, d)).astype(np.float32)
             for _ in range(3)]
        mask = np.ones((B, T), np.float32)
        mask[1, T - T // 4:] = 0.0

        def run(dev, fwd_impl, bwd_impl):
            q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                       for a in x)
            out = dattn.dispatch_attention(q, k, v, torch.tensor(
                mask, device=dev), True, fwd_impl, bwd_impl)
            torch.sin(out).sum().backward()
            return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

        for fwd_impl, bwd_impl in itertools.product(impls, impls):
            if (fwd_impl, bwd_impl) == ("block", "stream"):
                continue                    # rejected: no logsumexp
            with env("DSTPU_STREAM_BWD", None):
                want = run("cpu", fwd_impl, bwd_impl)
                sync(device)
                reset_launch_counts()
                got = run(device, fwd_impl, bwd_impl)
                sync(device)
                launches = launch_counts()
            expected = no_launches(
                block_fwd=int(fwd_impl == "block"),
                block_bwd=int(bwd_impl == "block"),
                stream_fwd=int(fwd_impl == "stream"),
                **(auto_bwd_launches(torch.float32, B * n, T, d, 1)
                   if bwd_impl == "stream" else {}))
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            ok = launches == expected and all(
                torch.allclose(g, w, rtol=1e-4,
                               atol=1e-5 * float(w.abs().max()))
                for g, w in zip(got, want))
            rows.append({"seq": T, "fwd": fwd_impl, "bwd": bwd_impl,
                         "max_abs_err": max(errs), "launches": {
                             k: v for k, v in launches.items() if v},
                         "ok": ok})
            if not ok:
                bad.append((T, fwd_impl, bwd_impl))
    emit("dispatch", shape=dict(B=B, n=n, d=d), dtype="float32",
         causal=True, rtol=1e-4, atol_of_max=1e-5, rows=rows,
         stream_block_seqs=both, ok=not bad)
    if bad:
        raise AssertionError(f"dispatch pairs {bad} disagree with the CPU "
                             f"or launched other kernels")


def phase_train(device):
    import numpy as np
    import torch

    cfg = bert_config("Lamb", {"lr": 4e-3, "max_coeff": 0.5,
                               "min_coeff": 0.08})
    engine = make_engine(cfg, device, max_seq_len=SEQ)
    n_leaves = len(engine.master)
    n_params = engine.num_parameters()
    vocab = engine.module.config.vocab_size
    batch = mlm_batch(MICRO * GAS, SEQ, vocab, NPRED)
    sync(device)
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = launch_counts()
    want = n_leaves * STEPS
    # seq 128 is below the streaming kernels' granule: einsum attention
    ok = (np.isfinite(losses).all() and launches["lamb_phase1"] == want
          and launches["lamb_phase2"] == want and launches["adam"] == 0
          and not any(launches[k] for k in ATTN_KERNELS))
    emit("train", model="bert-large", seq=SEQ, micro_batch=MICRO, gas=GAS,
         dtype="bf16", optimizer="Lamb", params=n_params, leaves=n_leaves,
         losses=losses, step_ms=step_ms,
         samples_per_s_steady=(MICRO * GAS * (STEPS - 1)
                               / (sum(step_ms[1:]) / 1e3)),
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30
         if torch.device(device).type == "cuda" else None,
         launches=launches, expected_launches=want, ok=bool(ok))
    if not ok:
        raise AssertionError(f"train phase failed: losses {losses}, "
                             f"launches {launches}, expected {want}")
    return engine, batch, launches


def _time_ms(fn, device, calls=20, reps=5):
    """Time on the card of one call of ``fn``: ``calls`` back-to-back
    calls between one pair of CUDA events, divided by ``calls``, the median
    of ``reps`` such runs after one warm-up call.  A run of calls keeps the
    wrapper's host work (checks, allocation, the ctypes call) off the
    measured time once the card has work queued."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _self_device_ms(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0)) / 1e3


#: the side stream of each device that ``_graph_ms`` captures on (one, so
#: the fused backward's scratch, cached per stream, is allocated once)
_CAPTURE_STREAMS = {}


def _graph_ms(make, device, calls=20, reps=5):
    """Device time of one call, with no host work in the window: ``make()``
    runs on a side stream and returns the function to time (a library
    backward makes its forward there, so that autograd launches the
    backward on that stream); one warm-up call there, then ``calls`` calls
    captured in one CUDA graph, replayed between a pair of CUDA events,
    over ``calls``, the median of ``reps`` replays after one."""
    import torch
    s = _CAPTURE_STREAMS.setdefault(str(device), torch.cuda.Stream(device))
    s.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(s):
        fn = make()
        fn()
    s.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph, fn
    return statistics.median(times[1:])


def _kernel_ms(fn, device, event_ms, make=None):
    """``ms``: the graph-replay device time of ``fn`` (``_graph_ms``;
    ``make`` as there, else ``fn`` itself), beside its event time
    ``event_ms``.  The events also enclose host gaps (a wrapper's checks,
    allocation and ctypes call, a PyTorch call's autograd), and after the
    training profiles of this script torch.profiler read the attention
    kernels at 0.58-0.69 of their graph times on an H100, so neither is
    ``ms``."""
    return {"ms": _graph_ms(make or (lambda: fn), device),
            "event_ms": event_ms}


def _library_ms(fn, device, make=None):
    """A library yardstick's times (``_kernel_ms``)."""
    if fn is None:
        return {"library_ms": None, "library_event_ms": None}
    t = _kernel_ms(fn, device, _time_ms(fn, device), make)
    return {"library_ms": t["ms"], "library_event_ms": t["event_ms"]}


def _max_err(got, want):
    """(max abs err, max rel err, within tolerance) over tensor pairs; the
    relative error divides by max(|want|, ATOL / RTOL), so values near zero
    count by their absolute error."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err,
                      float((d / w.abs().clamp_min(ATOL / RTOL)).max()))
        ok = ok and bool((d <= ATOL + RTOL * w.abs()).all())
    return abs_err, rel_err, ok


def _bound_ms(name, n):
    k = KERNELS[name]
    return max(n * k["bytes"] / HBM_BYTES_PER_S,
               n * k["flops"] / FP32_FLOP_PER_S) * 1e3


def phase_kernels(engine, batch, device, lamb_launches):
    """Each kernel against its plain version on the BERT-large state."""
    import torch

    from deepspeed_tpu_torch.ops import cuda_optim
    from deepspeed_tpu_torch.ops import optim as optim_mod

    # one micro-batch of grads on top of the state after the last step
    engine.backward(engine(*(x[:MICRO] for x in batch)))
    grads, engine._acc = engine._acc, None
    names = list(engine.master)
    g = [grads[k] for k in names]
    n = sum(t.numel() for t in g)
    st = engine.opt_state
    lamb = engine.base_optimizer
    adam = optim_mod.AdamW(lr=1e-4, weight_decay=0.01)
    idx = range(len(names))

    def scalars(opt):
        ss = opt._step_size(opt.lr, st.step + 1, opt.beta1, opt.beta2)
        rows = [(opt.beta1, opt.beta2, ss, opt.weight_decay, opt.lr)] * len(g)
        # the unscale-and-clip divisor as the engine passes it: on device
        return cuda_optim.make_scalars(
            rows, torch.tensor(2.0, device=device), device)

    def state_copy():
        return [[t[k].clone() for k in names]
                for t in (engine.master, st.m, st.v)]

    lamb_kw = dict(min_coeff=lamb.min_coeff, max_coeff=lamb.max_coeff)
    # the plain and the kernel route each keep their own phase-1 outputs
    outs = {"kernel": [None] * len(g), "plain": [None] * len(g)}

    def lamb_fns(p, m, v, scal):
        def phase1(route, fn):
            def run():
                for i in idx:
                    outs[route][i] = fn(p[i], g[i], m[i], v[i], scal[i],
                                        eps=lamb.eps)
            return run

        def phase2(route, fn):
            def run():
                for i in idx:
                    u, parts = outs[route][i]
                    fn(p[i], u, parts, scal[i], **lamb_kw)
            return run
        return {
            "lamb_phase1": (phase1("kernel", cuda_optim.lamb_phase1),
                            phase1("plain", cuda_optim.lamb_phase1_plain)),
            "lamb_phase2": (phase2("kernel", cuda_optim.lamb_phase2),
                            phase2("plain", cuda_optim.lamb_phase2_plain)),
        }

    def adam_fns(p, m, v, scal):
        def run(fn):
            def go():
                for i in idx:
                    fn(p[i], g[i], m[i], v[i], scal[i], eps=adam.eps,
                       decoupled=True)
            return go
        return {"adam": (run(cuda_optim.fused_adam_update),
                         run(cuda_optim.adam_plain))}

    results = []
    for opt, make_fns, launches in ((lamb, lamb_fns, lamb_launches),
                                    (adam, adam_fns, None)):
        scal = scalars(opt)
        # correctness: one full update, kernel and plain, identical inputs
        kstate, pstate = state_copy(), state_copy()
        kfns, pfns = make_fns(*kstate, scal), make_fns(*pstate, scal)
        for name in kfns:
            kfns[name][0]()
            pfns[name][1]()
        sync(device)
        errs = {out: _max_err(a, b) for out, a, b in
                zip("pmv", kstate, pstate)}
        del kstate, kfns
        # timing, in place on the plain route's copy
        lib = None
        if opt is adam:
            lib_params = [t.clone().requires_grad_() for t in pstate[0]]
            for t, gr in zip(lib_params, g):
                t.grad = gr
            # capturable: its step count lives on the card, so the step
            # can be timed in a CUDA graph (_graph_ms)
            lib = torch.optim.AdamW(lib_params, lr=opt.lr, eps=opt.eps,
                                    weight_decay=opt.weight_decay,
                                    fused=True, capturable=True).step
        for name, (kfn, pfn) in pfns.items():
            # plain, kernel, kernel, plain: compare within one call
            plain_a = _time_ms(pfn, device)
            kernel_a = _time_ms(kfn, device)
            kernel_b = _time_ms(kfn, device)
            plain_b = _time_ms(pfn, device)
            outs_of = {"lamb_phase1": "mv", "lamb_phase2": "p"}.get(name,
                                                                    "pmv")
            results.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[name]["replaces"],
                "launches": None if launches is None else launches[name],
                "max_abs_err": max(errs[o][0] for o in outs_of),
                "errors": {o: {"max_abs": e[0], "max_rel": e[1],
                               "ok": e[2]} for o, e in errs.items()},
                "ms": min(kernel_a, kernel_b),
                "plain_ms": min(plain_a, plain_b),
                "bound_ms": _bound_ms(name, n), "bound_by": "bytes",
                **_library_ms(lib, device),
                "elements": n, "tensors": len(g)})
        del pstate, pfns, lib
        if not all(e[2] for e in errs.values()):
            raise AssertionError(f"{opt.name} kernels disagree with their "
                                 f"plain versions beyond rtol={RTOL} "
                                 f"atol={ATOL}: {errs}")
    outs.clear()
    for r in results:
        emit("kernels", **{k: r[k] for k in (
            "name", "ms", "plain_ms", "bound_ms", "library_ms",
            "library_event_ms", "errors", "elements", "tensors")})
    return results


def phase_profile(engine, batch, device, top=12, name="profile"):
    """Where a training step spends its device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    engine.train_batch(batch)
    sync(device)
    steps = PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3

    device_ms = _self_device_ms
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    by_name = {e.key: (e.count, device_ms(e)) for e in kernels}
    busy = sum(device_ms(e) for e in kernels)
    gemm = sum(device_ms(e) for e in kernels
               if "gemm" in e.key or "nvjet" in e.key)
    attn = sum(device_ms(e) for e in kernels if "stream_" in e.key)
    block = sum(device_ms(e) for e in kernels
                if any(DEVICE_SYMBOL[k] in e.key
                       for k in ("block_fwd", "block_bwd")))
    emit(name, steps=steps, step_ms_profiled=wall_ms / steps,
         device_busy_ms_per_step=busy / steps,
         device_busy_share_profiled=busy / wall_ms,
         gemm_ms_per_step=gemm / steps,
         stream_attention_ms_per_step=attn / steps,
         block_attention_ms_per_step=block / steps,
         top_kernels=[{"name": e.key[:90], "calls": e.count,
                       "ms_per_step": device_ms(e) / steps}
                      for e in sorted(kernels, key=device_ms,
                                      reverse=True)[:top]])
    return by_name


def profile_ms(by_name, name, per_launch=True):
    """A ported kernel's device time in a ``phase_profile`` trace: per
    launch, or (``per_launch`` False) per profiled step; None
    where the profiled path did not launch it."""
    hits = [v for k, v in by_name.items() if DEVICE_SYMBOL[name] in k]
    calls = sum(c for c, _ in hits)
    if not calls:
        return None
    total = sum(ms for _, ms in hits)
    return total / calls if per_launch else total / PROFILE_STEPS


def phase_adam(device):
    import numpy as np

    cfg = bert_config("AdamW", {"lr": 1e-4, "weight_decay": 0.01})
    engine = make_engine(cfg, device, max_seq_len=SEQ)
    batch = mlm_batch(MICRO * GAS, SEQ, engine.module.config.vocab_size,
                      NPRED, seed=1)
    sync(device)
    reset_launch_counts()
    losses = [float(engine.train_batch(batch)) for _ in range(ADAM_STEPS)]
    sync(device)
    launches = launch_counts()
    want = len(engine.master) * ADAM_STEPS
    ok = (np.isfinite(losses).all() and launches["adam"] == want
          and launches["lamb_phase1"] == 0)
    emit("adam", losses=losses, launches=launches, expected_launches=want,
         ok=bool(ok))
    if not ok:
        raise AssertionError(f"adam phase failed: {losses} {launches}")
    return launches


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block (cuBLAS
    needs CUBLAS_WORKSPACE_CONFIG, set by main() before CUDA starts)."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def closure_engine(device, seed, cfg, dataset=None, qa=False):
    """BERT-large (NSP head, or the span model) from a seeded init,
    through ``initialize``; with ``dataset`` also its data loader."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import (BertForPreTraining,
                                            BertForQuestionAnswering)
    gen = torch.Generator(device=device).manual_seed(seed)
    if qa:
        model = BertForQuestionAnswering.from_size(
            "large", generator=gen, device=device,
            max_seq_len=CLOSURE_MAX_SEQ)
    else:
        model = BertForPreTraining.from_size(
            "large", use_nsp=True, generator=gen, device=device,
            max_seq_len=CLOSURE_MAX_SEQ)
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        config=cfg, model=model, training_data=dataset, device=device)
    return engine, loader


def loader_step(engine, it):
    """One optimizer step of the split API over gas micro-batches of the
    loader; returns the last micro-step's loss (a device tensor)."""
    loss = None
    for _ in range(engine.gradient_accumulation_steps()):
        loss = engine(*next(it))
        engine.backward(loss)
        engine.step()
    return loss.detach()


def _state_equal(a, b):
    """Every master, moment, the step, the loss-scale state and the LR of
    two engines, bitwise (``torch.equal`` on the device)."""
    import torch
    same = {
        "master": all(torch.equal(a.master[k], b.master[k])
                      for k in a.master),
        "m": all(torch.equal(a.opt_state.m[k], b.opt_state.m[k])
                 for k in a.master),
        "v": all(torch.equal(a.opt_state.v[k], b.opt_state.v[k])
                 for k in a.master),
        "module": all(torch.equal(x, y) for x, y in zip(
            a.module.parameters(), b.module.parameters())),
        "step": a.opt_state.step == b.opt_state.step,
        "loss_scale": all(torch.equal(x, y) for x, y in zip(
            a.loss_scale_state, b.loss_scale_state)),
        "lr": (a.optimizer.param_groups == b.optimizer.param_groups
               and a.lr_scheduler.state_dict()
               == b.lr_scheduler.state_dict()),
        "counters": (a.global_steps, a.micro_steps, a.skipped_steps)
        == (b.global_steps, b.micro_steps, b.skipped_steps),
    }
    return same


def phase_closure(device):
    """The main path's end: pretrain BERT-large through the data loader
    with selective remat (run A), save after step 3, resume in a fresh
    engine from another init (run B) and hold steps 4-6 bitwise against
    run A, then fine-tune the span model from that checkpoint."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deepspeed_tpu_torch import checkpoint as ckpt
    from deepspeed_tpu_torch import metrics, native
    from deepspeed_tpu_torch.data import FileDataset
    from deepspeed_tpu_torch.examples.squad_finetune import synthetic_batch

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="closure_", dir=ROOT / "build")
    try:
        vocab = 30528
        rows = MICRO * GAS * CLOSURE_BATCHES
        ids, mask, tt, pos, mlm_ids, w = mlm_batch(rows, SEQ, vocab, NPRED,
                                                   seed=2)
        nsp = np.random.default_rng(3).integers(0, 2, rows).astype(np.int32)
        dataset = FileDataset(FileDataset.save(
            os.path.join(work, "corpus"), input_ids=ids, input_mask=mask,
            token_type_ids=tt, masked_positions=pos, masked_ids=mlm_ids,
            masked_weights=w, nsp_labels=nsp))
        cfg = bert_config("Lamb", {"lr": 4e-3, "max_coeff": 0.5,
                                   "min_coeff": 0.08}, remat=SELECTIVE)
        cfg["scheduler"] = {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 4e-3,
            "warmup_num_steps": 4}}
        ck_dir = os.path.join(work, "ckpt")
        with deterministic():
            a, loader_a = closure_engine(device, 0, cfg, dataset)
            n_leaves, workers = len(a.master), loader_a.num_workers
            it = iter(loader_a)
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            native.reset_routes()
            reset_launch_counts()
            losses_a, ms_a = [], []
            for step in range(1, CLOSURE_STEPS + 1):
                t0 = time.perf_counter()
                losses_a.append(loader_step(a, it))
                sync(device)
                ms_a.append((time.perf_counter() - t0) * 1e3)
                if step == CLOSURE_SAVE_AT:
                    t0 = time.perf_counter()
                    a.save_checkpoint(ck_dir, client_state={
                        "data": loader_a.state_dict()})
                    save_s = time.perf_counter() - t0
                    save_bytes = a.last_save_bytes
            sync(device)
            launches_a = launch_counts()
            routes = dict(native.ROUTES)
            peak_a = torch.cuda.max_memory_allocated(device) / 2 ** 30
            it.close()

            b, loader_b = closure_engine(device, 1, cfg, dataset)
            sync(device)
            t0 = time.perf_counter()
            _, client = b.load_checkpoint(ck_dir)
            sync(device)
            load_s = time.perf_counter() - t0
            loader_b.load_state_dict(client["data"])
            it = iter(loader_b)
            reset_launch_counts()
            losses_b, ms_b = [], []
            for _ in range(CLOSURE_STEPS - CLOSURE_SAVE_AT):
                t0 = time.perf_counter()
                losses_b.append(loader_step(b, it))
                sync(device)
                ms_b.append((time.perf_counter() - t0) * 1e3)
            launches_b = launch_counts()
            it.close()
            bitwise = {"losses": all(torch.equal(x, y) for x, y in zip(
                losses_a[CLOSURE_SAVE_AT:], losses_b))}
            bitwise.update(_state_equal(a, b))
            del a, b, loader_a, loader_b
            free(device)

            ft_cfg = bert_config("Adam", {"lr": FT_LR}, micro=FT_MICRO)
            qa, _ = closure_engine(device, 2, ft_cfg, qa=True)
            module = ckpt.load_module_tree(ck_dir)
            loaded, skipped = ckpt.init_from_module_tree(qa, module)
            del module
            backbone = [k for k in qa.master if not k.startswith("qa_")]
            rng = np.random.default_rng(4)
            reset_launch_counts()
            ft_losses, ft_ms = [], []
            for _ in range(FT_STEPS):
                batch = synthetic_batch(rng, FT_MICRO * GAS, FT_SEQ, vocab)
                t0 = time.perf_counter()
                ft_losses.append(float(qa.train_batch(batch)))
                sync(device)
                ft_ms.append((time.perf_counter() - t0) * 1e3)
            ft_launches = launch_counts()
            ids_e, attn_e, tt_e, gs, ge = synthetic_batch(
                np.random.default_rng(999), 32, FT_SEQ, vocab)
            sl, el = metrics.make_span_predictor(qa.module)(ids_e, attn_e,
                                                            tt_e)
            ps, pe = metrics.best_spans(sl, el, attn_e, max_answer_len=8)
            eval_spans = metrics.evaluate_spans(ps, pe, gs, ge)
            ft_leaves = len(qa.master)
            del qa
            free(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def steady(ms, rows_per_step):
        return rows_per_step * (len(ms) - 1) / (sum(ms[1:]) / 1e3)

    rows_step = MICRO * GAS
    steps_b = CLOSURE_STEPS - CLOSURE_SAVE_AT
    want_a = no_launches(lamb_phase1=n_leaves * CLOSURE_STEPS,
                         lamb_phase2=n_leaves * CLOSURE_STEPS)
    want_b = no_launches(lamb_phase1=n_leaves * steps_b,
                         lamb_phase2=n_leaves * steps_b)
    want_ft = no_launches(adam=ft_leaves * FT_STEPS)
    a_floats = [float(x) for x in losses_a]
    ok = {
        "bitwise": all(bitwise.values()),
        "finite": bool(np.isfinite(a_floats).all()
                       and np.isfinite(ft_losses).all()),
        "launches": (launches_a == want_a and launches_b == want_b
                     and ft_launches == want_ft),
        "native_collate": routes["native"] > 0 and routes["numpy"] == 0,
        "backbone_transferred": (sorted(loaded) == sorted(
            "".join(f"[{p!r}]" for p in k.split(".")) for k in backbone)
            and len(skipped) == 2),
    }
    # steps 2..6 of run A less the save (timed apart)
    emit("closure", model="bert-large", use_nsp=True, seq=SEQ,
         max_seq_len=CLOSURE_MAX_SEQ, micro_batch=MICRO, gas=GAS,
         optimizer="Lamb", scheduler="WarmupLR", dtype="bf16",
         activation_checkpointing="selective", corpus_rows=rows,
         loader_workers=workers, collate_routes=routes,
         losses_a=a_floats, losses_b=[float(x) for x in losses_b],
         step_ms_a=ms_a, step_ms_b=ms_b,
         samples_per_s_steady_a=steady(ms_a, rows_step),
         samples_per_s_steady_b=steady(ms_b, rows_step),
         peak_mem_gib_selective_seq128=peak_a,
         save_s=save_s, load_s=load_s, save_bytes=save_bytes,
         bitwise=bitwise, launches_a=launches_a, launches_b=launches_b,
         expected_launches_a=want_a, expected_launches_b=want_b,
         deterministic=True, ok=ok)
    emit("closure_finetune", model="bert-large-qa", seq=FT_SEQ,
         micro_batch=FT_MICRO, gas=GAS, optimizer="Adam", lr=FT_LR,
         leaves_transferred=len(loaded), leaves_kept=sorted(skipped),
         losses=ft_losses, step_ms=ft_ms,
         samples_per_s_steady=steady(ft_ms, FT_MICRO * GAS),
         launches=ft_launches, expected_launches=want_ft,
         eval_batch=eval_spans)
    if not all(ok.values()):
        raise AssertionError(f"closure phase failed: {ok}, bitwise "
                             f"{bitwise}")
    return ft_launches


def phase_train512(device, remat=False, off_run=None):
    """BERT-large at seq 512 through the streaming attention kernels, then
    (remat off) the same engine on the einsum attention as a yardstick.
    With ``remat`` "selective" (bench.py's seq-512 recipe) the backward
    recomputes each layer's attention forward: one more stream_fwd launch
    per layer and micro-step than ``off_run``, the remat-off run's
    (losses, launches, peak), beside which it reports."""
    import numpy as np
    import torch

    cfg = bert_config("Lamb", {"lr": 4e-3, "max_coeff": 0.5,
                               "min_coeff": 0.08}, micro=MICRO512,
                      remat=SELECTIVE if remat else False)
    engine = make_engine(cfg, device, max_seq_len=SEQ512)
    n_leaves = len(engine.master)
    layers = engine.module.config.num_layers
    batch = mlm_batch(MICRO512 * GAS, SEQ512, engine.module.config.vocab_size,
                      NPRED512, pad=True)

    def run(steps):
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        return losses, step_ms

    def steady(step_ms):
        return MICRO512 * GAS * (len(step_ms) - 1) / (sum(step_ms[1:]) / 1e3)

    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    with env("DSTPU_FUSED_ATTN", None), env("DSTPU_STREAM_BWD", None):
        reset_launch_counts()
        losses, step_ms = run(TRAIN512_STEPS)
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    attn = layers * GAS * TRAIN512_STEPS     # layers x micro-batches x steps
    cfg = engine.module.config
    expected = no_launches(
        lamb_phase1=n_leaves * TRAIN512_STEPS,
        lamb_phase2=n_leaves * TRAIN512_STEPS,
        stream_fwd=attn * (2 if remat else 1),
        **auto_bwd_launches(torch.bfloat16, MICRO512 * cfg.num_heads,
                            SEQ512, cfg.hidden_size // cfg.num_heads, attn))
    ok = bool(np.isfinite(losses).all()) and launches == expected
    extra = {}
    if remat:
        off_losses, off_launches, off_peak = off_run
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, off_losses))
        # the same arithmetic as the remat-off run, recomputed: its losses
        # within the split/fused comparison's 1e-2, and its launches the
        # remat-off run's plus one recomputed forward per layer and
        # micro-step
        ok = ok and rel <= GPT2_1024_LOSS_RTOL and launches == {
            **off_launches, "stream_fwd": off_launches["stream_fwd"] + attn}
        extra = dict(remat_off_losses=off_losses,
                     losses_max_rel_diff=rel,
                     losses_bitwise_equal=losses == off_losses,
                     remat_off_peak_mem_gib=off_peak)
    name = "train512_selective" if remat else "train512"
    emit(name, model="bert-large", seq=SEQ512, micro_batch=MICRO512,
         gas=GAS, masked_positions=NPRED512, dtype="bf16", optimizer="Lamb",
         activation_checkpointing=remat or False,
         params=engine.num_parameters(), losses=losses, step_ms=step_ms,
         samples_per_s_steady=steady(step_ms), peak_mem_gib=peak,
         launches=launches, expected_launches=expected, ok=ok, **extra)
    if not ok:
        raise AssertionError(f"{name} phase failed: losses {losses}, "
                             f"launches {launches}, expected {expected}")
    if remat:
        return None

    torch.cuda.reset_peak_memory_stats(device)
    with env("DSTPU_FUSED_ATTN", "0"):
        reset_launch_counts()
        y_losses, y_ms = run(YARDSTICK_STEPS)
        y_launches = launch_counts()
    emit("train512_einsum_yardstick", steps=YARDSTICK_STEPS, losses=y_losses,
         step_ms=y_ms, samples_per_s_steady=steady(y_ms),
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
         launches=y_launches)
    return engine, batch, launches, (losses, launches, peak)


def _attn_err(got, want):
    """(max abs err, max rel err, within tolerance) over tensor pairs, the
    tolerance ``ATTN_ATOL * max|want| + ATTN_RTOL * |want|``."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        atol = ATTN_ATOL * float(w.abs().max())
        abs_err = max(abs_err, float(diff.max()))
        rel_err = max(rel_err, float(
            (diff / w.abs().clamp_min(atol / ATTN_RTOL)).max()))
        ok = ok and bool((diff <= atol + ATTN_RTOL * w.abs()).all())
    return abs_err, rel_err, ok


def _attn_bound(name, G, T, d, elt_bytes=2, B=0):
    """(bound ms, bound_by): operands and rows (and the block kernels'
    [B, T] mask) read and written once, and the products at the bf16
    tensor-core peak (every tile: the streaming rows here are non-causal;
    the whole-tile rows are causal, where the products over the whole tile
    overstate the work, but their bytes bind by 3x and more even so)."""
    k = ATTN_KERNELS[name]
    flops = k["passes"] * 2.0 * G * T * T * d
    nbytes = (k["tensors"] * G * T * d * elt_bytes + k["rows"] * G * T * 4
              + (B * T * 4 if k.get("mask") else 0))
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _stream_checks(device, sattn):
    """The backward kernels against their plain versions on more inputs
    than the row shape's: the split pair causal at that shape and with a
    fully padded row (non-causal: under causal the kernels skip the tiles
    after the query's, as the Pallas grid does, where the plain versions
    take the whole row); and at the GPT-2 seq-1024 path's shape (B=4, n=16,
    causal, no padding) every stream kernel that path runs, the forward
    (o and lse), the split pair and the fused backward, each bitwise equal
    across two calls; and at the shape sp_gpt2's Ulysses gives its local
    attention (B=4, n=8 of the 16 heads, the whole causal sequence of 1024)
    the forward and the split pair.  ``(errors by case and kernel,
    repeatable)``."""
    import torch
    B, n, T, d = (ATTN_SHAPE[k] for k in "BnTd")
    cases = {}
    padded = torch.ones((B, T), device=device)
    for r in range(0, B, 3):
        padded[r, T - T // 8 - 5 * r:] = 0.0
    full = padded.clone()
    full[1] = 0.0
    ones_1024 = torch.ones((GPT2_1024_MICRO, GPT2_1024_SEQ), device=device)
    for case, (b, t, mask, causal, heads) in {
            "causal": (B, T, padded, True, n),
            "fully_padded_row": (B, T, full, False, n),
            "gpt2_1024": (GPT2_1024_MICRO, GPT2_1024_SEQ, ones_1024, True,
                          n),
            "ulysses_1024": (GPT2_1024_MICRO, GPT2_1024_SEQ, ones_1024,
                             True, n // SP)}.items():
        gen = torch.Generator(device=device).manual_seed(1)
        q, k, v, do = (torch.randn((b * heads, t, d), generator=gen,
                                   device=device).to(torch.bfloat16)
                       for _ in range(4))
        maskg = sattn.mask_gtd(mask, b, t, heads)
        o, lse = sattn.stream_fwd_plain(q, k, v, maskg, causal)
        delta = (do.float() * o.float()).sum(-1)[:, None, :]
        args = (q, k, v, maskg, do, lse, delta, causal)
        # each kernel's outputs, twice on the path's shape
        runs = {"stream_dkv": lambda: sattn.stream_dkv(*args),
                "stream_dq": lambda: (sattn.stream_dq(*args),)}
        want = sattn.stream_bwd_plain(*args)
        wants = {"stream_dkv": want[1:], "stream_dq": want[:1]}
        if case in ("gpt2_1024", "ulysses_1024"):
            runs.update(
                stream_fwd=lambda: sattn.stream_fwd(q, k, v, maskg, causal))
            wants.update(stream_fwd=(o, lse))
        if case == "gpt2_1024":
            runs.update(
                stream_bwd_fused=lambda: sattn.stream_bwd_fused(*args))
            wants.update(stream_bwd_fused=want)
        got = {name: run() for name, run in runs.items()}
        sync(device)
        cases[case] = {name: _attn_err(got[name], wants[name])
                       for name in runs}
        if case == "gpt2_1024":
            again = {name: run() for name, run in runs.items()}
            sync(device)
            repeatable = {name: all(torch.equal(a, b) for a, b in
                                    zip(got[name], again[name]))
                          for name in runs}
            del again
        del q, k, v, do, o, lse, delta, args, runs, want, wants, got
    return cases, repeatable


def phase_attn_kernels(device, launches, paths, profs):
    """Each attention kernel against its plain version at the seq-512
    BERT-large shape, with times, bounds, a library yardstick (and its
    time on each of torch's fused backends that take the mask), and each
    kernel's per-launch device time in its path's trace (``profs``), and
    the checks of ``_stream_checks``.  The split pair also: its times under
    causal at the same shape."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import stream_attention as sattn
    B, n, T, d = (ATTN_SHAPE[k] for k in "BnTd")
    G = B * n
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn((G, T, d), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((B, T), device=device)
    for r in range(0, B, 3):
        mask[r, T - T // 8 - 5 * r:] = 0.0
    maskg = sattn.mask_gtd(mask, B, T, n)
    o, lse = sattn.stream_fwd_plain(q, k, v, maskg, False)
    delta = (do.float() * o.float()).sum(-1)[:, None, :]
    bwd = (q, k, v, maskg, do, lse, delta, False)
    o_c, lse_c = sattn.stream_fwd_plain(q, k, v, maskg, True)
    bwd_c = (q, k, v, maskg, do, lse_c,
             (do.float() * o_c.float()).sum(-1)[:, None, :], True)
    del o_c
    causal_fns = {"stream_dkv": lambda: sattn.stream_dkv(*bwd_c),
                  "stream_dq": lambda: sattn.stream_dq(*bwd_c)}
    fns = {
        "stream_fwd": (lambda: sattn.stream_fwd(q, k, v, maskg, False),
                       lambda: sattn.stream_fwd_plain(q, k, v, maskg, False)),
        "stream_bwd_fused": (lambda: sattn.stream_bwd_fused(*bwd),
                             lambda: sattn.stream_bwd_plain(*bwd)),
        "stream_dkv": (lambda: sattn.stream_dkv(*bwd),
                       lambda: sattn.stream_dkv_plain(*bwd)),
        "stream_dq": (lambda: (sattn.stream_dq(*bwd),),
                      lambda: (sattn.stream_dq_plain(*bwd),)),
    }

    # yardstick: torch's fused attention with the boolean key mask, forward
    # and the backward of a kept graph (timed only; the port never calls it)
    def four(x):
        return x.view(B, n, T, d)
    keep = mask.bool()[:, None, None, :]

    def backward():
        """The backward of a kept graph, its leaves and forward made here
        (on the stream that will run it)."""
        leaves = [four(x).detach().clone().requires_grad_()
                  for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
        return lambda: torch.autograd.grad(out, leaves, four(do),
                                           retain_graph=True)

    def lib_times():
        """``_library_ms`` of each direction."""
        return {"fwd": _library_ms(
                    lambda: F.scaled_dot_product_attention(
                        four(q), four(k), four(v), attn_mask=keep), device),
                "bwd": _library_ms(backward(), device, make=backward)}
    lib_ms = lib_times()
    # the same call pinned to each backend that takes a mask: which one
    # the default dispatch picks decides the yardstick
    from torch.nn.attention import SDPBackend, sdpa_kernel
    by_backend = {}
    for backend in ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel([getattr(SDPBackend, backend)]):
                by_backend[backend] = lib_times()
        except RuntimeError as e:
            by_backend[backend] = f"refused: {str(e)[:120]}"
    emit("attn_library", shape=ATTN_SHAPE, dtype="bf16", default=lib_ms,
         by_backend=by_backend)

    checks, repeatable = _stream_checks(device, sattn)
    results = []
    for name, (kfn, pfn) in fns.items():
        got, want = kfn(), pfn()
        sync(device)
        err = _attn_err(got, want)
        del got, want
        mine = {case: c[name] for case, c in checks.items() if name in c}
        errs = [err] + list(mine.values())
        err = (max(e[0] for e in errs), max(e[1] for e in errs),
               all(e[2] for e in errs) and repeatable[name])
        extra = {"checks": {case: {"max_abs_err": e[0], "max_rel_err": e[1],
                                   "ok": e[2]} for case, e in mine.items()},
                 "bitwise_repeatable": repeatable[name]}
        if name in causal_fns:
            cfn = causal_fns[name]
            ct = _kernel_ms(cfn, device, min(_time_ms(cfn, device),
                                             _time_ms(cfn, device)))
            extra.update(causal_ms=ct["ms"], causal_event_ms=ct["event_ms"])
        # plain, kernel, kernel, plain: compare within one call
        plain_a = _time_ms(pfn, device)
        kernel_a = _time_ms(kfn, device)
        kernel_b = _time_ms(kfn, device)
        plain_b = _time_ms(pfn, device)
        bound, bound_by = _attn_bound(name, G, T, d)
        results.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ATTN_KERNELS[name]["replaces"],
            "launches": launches[name], "path": paths[name],
            "max_abs_err": err[0], "max_rel_err": err[1], "ok": err[2],
            **_kernel_ms(kfn, device, min(kernel_a, kernel_b)),
            "plain_ms": min(plain_a, plain_b),
            "bound_ms": bound, "bound_by": bound_by,
            **lib_ms["fwd" if name == "stream_fwd" else "bwd"],
            "profile_ms": profile_ms(profs[name], name), **extra})
    for r in results:
        emit("attn_kernels", shape=ATTN_SHAPE, dtype="bf16",
             rtol=ATTN_RTOL, atol_of_max=ATTN_ATOL, **{k: r[k] for k in (
                 "name", "ms", "event_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "library_event_ms", "profile_ms",
                 "max_abs_err", "max_rel_err", "ok", "causal_ms",
                 "causal_event_ms", "checks", "bitwise_repeatable")
                 if k in r})
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"attention kernels {bad} disagree with their "
                             f"plain versions beyond rtol={ATTN_RTOL} "
                             f"atol={ATTN_ATOL}*max|want|")
    return results


def phase_train_gpt2(device):
    """GPT-2 medium causal-LM pretraining at seq 128 through the whole-tile
    attention kernels and the Adam kernel, then the same engine on the
    einsum attention as a yardstick."""
    import numpy as np
    import torch

    engine = make_engine(gpt2_config(MICRO), device, size="medium",
                         gpt2=True)
    cfg = engine.module.config
    batch = lm_batch(MICRO * GAS, GPT2_SEQ, cfg.vocab_size)

    def run(steps):
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        return losses, step_ms

    def steady(step_ms):
        return MICRO * GAS * (len(step_ms) - 1) / (sum(step_ms[1:]) / 1e3)

    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    with env("DSTPU_FUSED_ATTN", None):
        reset_launch_counts()
        losses, step_ms = run(GPT2_STEPS)
        launches = launch_counts()
    attn = cfg.num_layers * GAS * GPT2_STEPS  # layers x micro-batches x steps
    expected = no_launches(adam=len(engine.master) * GPT2_STEPS,
                           block_fwd=attn, block_bwd=attn)
    ok = bool(np.isfinite(losses).all()) and launches == expected
    emit("train_gpt2", model="gpt2-medium", seq=GPT2_SEQ, micro_batch=MICRO,
         gas=GAS, dtype="bf16", optimizer="Adam", lr=1e-4,
         activation_checkpointing=False, params=engine.num_parameters(),
         leaves=len(engine.master), losses=losses, step_ms=step_ms,
         samples_per_s_steady=steady(step_ms),
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
         launches=launches, expected_launches=expected, ok=ok)
    if not ok:
        raise AssertionError(f"train_gpt2 phase failed: losses {losses}, "
                             f"launches {launches}, expected {expected}")

    torch.cuda.reset_peak_memory_stats(device)
    with env("DSTPU_FUSED_ATTN", "0"):
        reset_launch_counts()
        y_losses, y_ms = run(YARDSTICK_STEPS)
        y_launches = launch_counts()
    emit("train_gpt2_einsum_yardstick", steps=YARDSTICK_STEPS,
         losses=y_losses, step_ms=y_ms, samples_per_s_steady=steady(y_ms),
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
         launches=y_launches)
    return engine, batch, launches, losses


def phase_train_gpt2_1024(device):
    """GPT-2 medium at seq 1024 through the streaming kernels, twice from
    the same seeded weights and batch: the backward as the split pair, then
    fused, each profiled after its timed steps.  ``{mode: (launches,
    profile)}``, and the split run's losses under ``"split_losses"``."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import stream_attention as sattn
    runs, out = {}, {}
    for mode in ("split", "fused"):
        engine = make_engine(gpt2_config(GPT2_1024_MICRO), device,
                             size="medium", gpt2=True,
                             max_seq_len=GPT2_1024_SEQ)
        cfg = engine.module.config
        micro = GPT2_1024_MICRO
        batch = lm_batch(micro * GAS, GPT2_1024_SEQ, cfg.vocab_size)
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        losses, step_ms = [], []
        with env("DSTPU_FUSED_ATTN", None), env("DSTPU_STREAM_BWD", mode):
            reset_launch_counts()
            for _ in range(GPT2_STEPS):
                t0 = time.perf_counter()
                loss = engine.train_batch(batch)
                sync(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            prof = phase_profile(engine, batch, device,
                                 name="profile_gpt2_1024" + (
                                     "" if mode == "split" else "_fused"))
        out[mode] = (launches, prof)
        attn = cfg.num_layers * GAS * GPT2_STEPS
        bwd = ({"stream_dkv": attn, "stream_dq": attn} if mode == "split"
               else {"stream_bwd_fused": attn})
        expected = no_launches(adam=len(engine.master) * GPT2_STEPS,
                               stream_fwd=attn, **bwd)
        runs[mode] = dict(
            losses=losses, step_ms=step_ms, peak_mem_gib=peak,
            samples_per_s_steady=(micro * GAS * (GPT2_STEPS - 1)
                                  / (sum(step_ms[1:]) / 1e3)),
            launches=launches, expected_launches=expected,
            ok=bool(np.isfinite(losses).all()) and launches == expected)
        del engine, batch
        torch.cuda.empty_cache()
    agree = all(abs(a - b) <= GPT2_1024_LOSS_RTOL * abs(b) for a, b in zip(
        runs["split"]["losses"], runs["fused"]["losses"]))
    G = GPT2_1024_MICRO * cfg.num_heads
    d = cfg.hidden_size // cfg.num_heads
    scratch = 4 * sattn.fused_scratch_words(torch.bfloat16, G,
                                            GPT2_1024_SEQ, d)[0]
    ok = runs["split"]["ok"] and runs["fused"]["ok"] and agree
    out["split_losses"] = runs["split"]["losses"]
    emit("train_gpt2_1024", model="gpt2-medium", seq=GPT2_1024_SEQ,
         micro_batch=GPT2_1024_MICRO, gas=GAS, dtype="bf16",
         optimizer="Adam", lr=1e-4, activation_checkpointing=False,
         steps=GPT2_STEPS, fused_scratch_bytes=scratch,
         auto_mode=("fused" if sattn._fused_bwd_fits(torch.bfloat16, G,
                                                      GPT2_1024_SEQ, d)
                    else "split"),
         loss_rtol=GPT2_1024_LOSS_RTOL, losses_agree=agree, runs=runs, ok=ok)
    if not ok:
        raise AssertionError(f"train_gpt2_1024 phase failed: {runs}")
    return out


def phase_bwd_sweep(device, seqs=(256, 512, 1024, 2048), tokens=4096, n=16,
                    d=64):
    """The fused backward against the split pair (dkv then dq), by sequence
    length, causal and not, in bf16 (the Hopper kernels) and in fp32 (the
    FMA route): ``_graph_ms`` of each (the forward excluded), in turns
    fused, pair, pair, fused.  The budget rule of
    ``STREAM_FUSED_SCRATCH_BUDGET``, for each dtype: the largest fused
    scratch of the sweep such that the fused kernel is no slower than the
    pair at every swept shape, causal and not, whose scratch is no larger
    (0 if there is none), capped at 256 MiB.  At a fixed number of tokens
    the fp32 scratch is the same at every seq, so there one loss gives 0."""
    import torch

    from deepspeed_tpu_torch.ops import stream_attention as sattn
    rows, budgets = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        # the fp32 kernels take milliseconds: fewer calls a replay
        calls = 20 if dtype == torch.bfloat16 else 4
        mine = []
        for T in seqs:
            G = tokens // T * n
            scratch = 4 * sattn.fused_scratch_words(dtype, G, T, d)[0]
            for causal in (False, True):
                gen = torch.Generator(device=device).manual_seed(T)
                q, k, v, do = (torch.randn((G, T, d), generator=gen,
                                           device=device).to(dtype)
                               for _ in range(4))
                maskg = torch.ones((G, 1, T), device=device)
                o, lse = sattn.stream_fwd(q, k, v, maskg, causal)
                delta = (do.float() * o.float()).sum(-1)[:, None, :]
                args = (q, k, v, maskg, do, lse, delta, causal)
                fns = {"fused": lambda: sattn.stream_bwd_fused(*args),
                       "pair": lambda: (sattn.stream_dkv(*args),
                                        sattn.stream_dq(*args))}
                ms = {name: [] for name in fns}
                for name in ("fused", "pair", "pair", "fused"):
                    ms[name].append(_graph_ms(lambda f=fns[name]: f, device,
                                              calls=calls))
                f, p = min(ms["fused"]), min(ms["pair"])
                mine.append({"dtype": str(dtype).split(".")[-1], "seq": T,
                             "causal": causal, "G": G, "fused_ms": f,
                             "pair_ms": p, "pair_over_fused": p / f,
                             "fused_scratch_bytes": scratch,
                             "auto": "fused" if sattn._fused_bwd_fits(
                                 dtype, G, T, d) else "split"})
                del q, k, v, do, o, lse, delta, args, fns
        sizes = sorted({r["fused_scratch_bytes"] for r in mine})
        fits = [size for size in sizes if all(
            r["fused_ms"] <= r["pair_ms"] for r in mine
            if r["fused_scratch_bytes"] <= size)]
        budgets[mine[0]["dtype"]] = min(max(fits, default=0), SCRATCH_CAP)
        rows += mine
    emit("bwd_sweep", heads=n, head_dim=d, tokens=tokens, rows=rows,
         measured_budget=budgets,
         committed_budget=sattn.STREAM_FUSED_SCRATCH_BUDGET)


def phase_block_kernels(device, launches, prof_gpt2):
    """Each whole-tile kernel against its plain version at the GPT-2 shape
    (q, k, v views of the packed qkv, causal, no padding as on the path,
    and once more with padded keys and a fully padded row), with times on
    the path's inputs, bounds and a library yardstick."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import block_attention as battn
    B, n, T, d = (BLOCK_SHAPE[k] for k in "BnTd")

    def inputs(n):
        """q, k, v views of a packed qkv of ``n`` heads, the upstream
        gradient, and the two masks (no padding, as on the path; padded
        keys and a fully padded row)."""
        gen = torch.Generator(device=device).manual_seed(0)
        qkv = torch.randn((B, T, n, 3, d), generator=gen,
                          device=device).to(torch.bfloat16)
        do = torch.randn((B, T, n, d), generator=gen,
                         device=device).to(torch.bfloat16)
        ones = torch.ones((B, T), device=device)
        padded = ones.clone()
        padded[0] = 0.0
        for r in range(1, B, 3):
            padded[r, T - T // 8 - 3 * r:] = 0.0
        return (*qkv.unbind(3), do, ones, padded)

    q, k, v, do, ones, padded = inputs(n)

    def fns(mask, q=q, k=k, v=v, do=do):
        return {"block_fwd": (
            lambda: (battn.block_fwd(q, k, v, mask, True),),
            lambda: (battn.block_fwd_plain(q, k, v, mask, True),)),
            "block_bwd": (
            lambda: battn.block_bwd(q, k, v, mask, do, True),
            lambda: battn.block_bwd_plain(q, k, v, mask, do, True))}

    # yardstick: torch's fused causal attention on the same [B, n, T, d]
    # views, forward and the backward of a kept graph (timed only; the port
    # never calls it)
    four = [x.transpose(1, 2) for x in (q, k, v)]

    def backward():
        """The backward of a kept graph, its leaves and forward made here
        (on the stream that will run it)."""
        leaves = [x.detach().clone().requires_grad_() for x in four]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                           retain_graph=True)
    lib_ms = {"block_fwd": _library_ms(
                  lambda: F.scaled_dot_product_attention(*four,
                                                         is_causal=True),
                  device),
              "block_bwd": _library_ms(backward(), device, make=backward)}

    results = []
    padded_fns = fns(padded)
    # tp_gpt2's shape: n / mp local heads of each rank
    tq, tk, tv, tdo, tones, tpadded = inputs(n // TP)
    tp_fns = [fns(m, tq, tk, tv, tdo) for m in (tones, tpadded)]
    for name, (kfn, pfn) in fns(ones).items():
        errs, tp_errs = [], []
        for out, pairs in ((errs, ((kfn, pfn), padded_fns[name])),
                           (tp_errs, [f[name] for f in tp_fns])):
            for kf, pf in pairs:
                got, want = kf(), pf()
                sync(device)
                out.append(_attn_err(got, want))
                del got, want
        # plain, kernel, kernel, plain: compare within one call
        plain_a = _time_ms(pfn, device)
        kernel_a = _time_ms(kfn, device)
        kernel_b = _time_ms(kfn, device)
        plain_b = _time_ms(pfn, device)
        bound, bound_by = _attn_bound(name, B * n, T, d, B=B)
        results.append({
            "name": name, "route": "cuda", "source": BLOCK_SOURCE,
            "replaces": ATTN_KERNELS[name]["replaces"],
            "launches": launches[name], "path": "train_gpt2",
            "max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs),
            "tp_shape_max_abs_err": max(e[0] for e in tp_errs),
            "ok": all(e[2] for e in errs + tp_errs),
            **_kernel_ms(kfn, device, min(kernel_a, kernel_b)),
            "plain_ms": min(plain_a, plain_b),
            "bound_ms": bound, "bound_by": bound_by,
            **lib_ms[name], "profile_ms": profile_ms(prof_gpt2, name)})
    for r in results:
        emit("block_kernels", shape=BLOCK_SHAPE, dtype="bf16", causal=True,
             rtol=ATTN_RTOL, atol_of_max=ATTN_ATOL,
             tp_shape=dict(BLOCK_SHAPE, n=n // TP), **{k: r[k] for k in (
                 "name", "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "library_event_ms", "profile_ms",
                 "max_abs_err", "max_rel_err", "tp_shape_max_abs_err",
                 "ok")})
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"whole-tile kernels {bad} disagree with their "
                             f"plain versions beyond rtol={ATTN_RTOL} "
                             f"atol={ATTN_ATOL}*max|want|")
    return results


def process_group(device):
    """A one-rank NCCL process group on ``device`` (a TCP rendezvous on a
    free localhost port), started once for the ZeRO phases through the
    port's ``init_distributed``."""
    import socket

    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import topology
    if dist.is_initialized():
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    topology.init_distributed(coordinator_address=f"tcp://127.0.0.1:{port}",
                              num_processes=1, process_id=0, device=device)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"process group backend {dist.get_backend()}")


def zero_engine(device, zero_cfg, seed=0):
    """GPT-2 medium as phase train_gpt2 (the same weights for one seed),
    with ``zero_cfg`` as its zero_optimization section (None: off)."""
    cfg = gpt2_config(MICRO)
    if zero_cfg is not None:
        cfg["zero_optimization"] = zero_cfg
    return make_engine(cfg, device, size="medium", seed=seed, gpt2=True)


def flat_state(engine):
    """The fp32 masters in the flat layout: the ZeRO engine's partition, or
    the per-leaf masters concatenated in the flat order (ZeRO off)."""
    import torch

    from deepspeed_tpu_torch import zero
    if engine.zero_flat:
        return engine.master_flat
    meta = zero.make_flat_meta(engine.master, 1)
    return torch.cat([engine.master[k].reshape(-1) for k in meta.names])


def phase_zero_gpt2(device):
    """GPT-2 medium at seq 128 on a one-rank NCCL group, 6 steps each with
    ZeRO off, stage 1 (overlap off), stage 1 and stage 2 (overlap on, 32
    MB buckets): exact launches, the three ZeRO runs bitwise equal, ZeRO
    against off within ZERO_LOSS_RTOL; then the Adam kernel at the flat
    partition's shape (``phase_flat_adam``)."""
    import numpy as np
    import torch

    process_group(device)
    batch = None
    runs = {}
    for name, zero_cfg in ZERO_RUNS:
        engine = zero_engine(device, zero_cfg)
        cfg = engine.module.config
        if batch is None:
            batch = lm_batch(MICRO * GAS, GPT2_SEQ, cfg.vocab_size)
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(GPT2_STEPS):
            t0 = time.perf_counter()
            losses.append(engine.train_batch(batch))
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        attn = cfg.num_layers * GAS * GPT2_STEPS
        if engine.zero_flat:
            meta = engine.flat_meta
            buckets = engine._comm_buckets()
            adam = GPT2_STEPS * (len(buckets) if buckets else 1)
            layout = {"elements": meta.total, "padded": meta.padded,
                      "partition": meta.partition,
                      "buckets": len(buckets) if buckets else 1,
                      "last_bucket": (buckets[-1][1] - buckets[-1][0]
                                      if buckets else meta.partition),
                      "bucket_elems": engine.comm_bucket_elems}
        else:
            adam = GPT2_STEPS * len(engine.master)
            layout = {"leaves": len(engine.master)}
        expected = no_launches(adam=adam, block_fwd=attn, block_bwd=attn)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        # kept on the host, so no later run's peak counts it
        run = {"losses": torch.stack(losses).cpu(),
               "state": flat_state(engine).cpu(),
               "step_ms": step_ms,
               "samples_per_s_steady": MICRO * GAS * (GPT2_STEPS - 1)
               / (sum(step_ms[1:]) / 1e3),
               "peak_mem_gib": peak,
               "launches": launches, "expected_launches": expected,
               "layout": layout}
        runs[name] = run
        if name == "stage2_overlap":
            flat = phase_flat_adam(device, engine, launches["adam"])
        del engine, losses
        free(device)
        emit("zero_gpt2_run", run=name, zero=zero_cfg, **{
            k: run[k] for k in ("step_ms", "samples_per_s_steady",
                                "peak_mem_gib", "launches",
                                "expected_launches", "layout")},
             losses=[float(x) for x in run["losses"]])
    zero_runs = [runs[n] for n, z in ZERO_RUNS if z is not None]
    off = runs["off"]
    total = off["state"].numel()
    rel = float(((zero_runs[0]["losses"] - off["losses"]).abs()
                 / off["losses"].abs()).max())
    checks = {
        "launches": all(r["launches"] == r["expected_launches"]
                        for r in runs.values()),
        "finite": all(bool(torch.isfinite(r["losses"]).all())
                      for r in runs.values()),
        "zero_losses_bitwise": all(torch.equal(r["losses"],
                                               zero_runs[0]["losses"])
                                   for r in zero_runs),
        "zero_masters_bitwise": all(torch.equal(r["state"],
                                                zero_runs[0]["state"])
                                    for r in zero_runs),
        "zero_vs_off_losses": rel <= ZERO_LOSS_RTOL,
        "no_padding": all(r["layout"].get("padded", total) == total
                          for r in runs.values()),
    }
    bitwise_vs_off = {
        "losses": torch.equal(zero_runs[0]["losses"], off["losses"]),
        "masters": torch.equal(zero_runs[0]["state"][:total],
                               off["state"])}
    emit("zero_gpt2", model="gpt2-medium", seq=GPT2_SEQ, micro_batch=MICRO,
         gas=GAS, dtype="bf16", optimizer="Adam", lr=1e-4, dp=1,
         backend="nccl", checks=checks, zero_vs_off_max_rel=rel,
         zero_vs_off_bitwise=bitwise_vs_off,
         samples_per_s_steady={n: r["samples_per_s_steady"]
                               for n, r in runs.items()},
         step_ms_median={n: statistics.median(r["step_ms"][1:])
                         for n, r in runs.items()},
         peak_mem_gib={n: r["peak_mem_gib"] for n, r in runs.items()})
    if not all(checks.values()):
        raise AssertionError(f"zero_gpt2 phase failed: {checks}")
    return flat, runs["stage2_overlap"]["launches"]


def phase_flat_adam(device, engine, launches):
    """The Adam kernel at the ZeRO path's shapes: one launch over the whole
    flat partition (overlap off) and the 32 MB bucket loop (overlap on),
    on the engine's masters and moments after its steps and seeded grads,
    held against ``adam_plain`` on the same inputs; times, the bound and
    ``torch.optim.AdamW(fused=True, capturable=True)`` on one flat tensor
    of the same size."""
    import torch

    from deepspeed_tpu_torch.ops import cuda_optim
    opt = engine.base_optimizer
    st = engine.opt_state
    n = engine.flat_meta.partition
    gen = torch.Generator(device=device).manual_seed(5)
    g = torch.randn(n, generator=gen, device=device) * 1e-3
    ss = opt._step_size(opt.lr, st.step + 1, opt.beta1, opt.beta2)
    scal = cuda_optim.make_scalars(
        [(opt.beta1, opt.beta2, ss, opt.weight_decay, opt.lr)],
        torch.tensor(1.0, device=device), device)[0]
    buckets = engine._comm_buckets()

    def fresh():
        return [engine.master_flat.clone(), st.m["flat"].clone(),
                st.v["flat"].clone()]

    kw = dict(eps=opt.eps, eps_inside_sqrt=opt.eps_inside_sqrt,
              decoupled=opt.decoupled_decay)
    kst, pst = fresh(), fresh()
    cuda_optim.fused_adam_update(kst[0], g, kst[1], kst[2], scal, **kw)
    cuda_optim.adam_plain(pst[0], g, pst[1], pst[2], scal, **kw)
    sync(device)
    errs = {o: _max_err([a], [b]) for o, a, b in zip("pmv", kst, pst)}
    bst = fresh()
    for s, e in buckets:
        cuda_optim.fused_adam_update(bst[0][s:e], g[s:e], bst[1][s:e],
                                     bst[2][s:e], scal, **kw)
    sync(device)
    bucket_bitwise = all(torch.equal(a, b) for a, b in zip(bst, kst))
    del kst, bst

    p, m, v = pst

    def whole():
        cuda_optim.fused_adam_update(p, g, m, v, scal, **kw)

    def loop():
        for s, e in buckets:
            cuda_optim.fused_adam_update(p[s:e], g[s:e], m[s:e], v[s:e],
                                         scal, **kw)

    def plain():
        cuda_optim.adam_plain(p, g, m, v, scal, **kw)

    plain_a = _time_ms(plain, device, calls=5, reps=3)
    kernel_a = _time_ms(whole, device)
    loop_a = _time_ms(loop, device)
    kernel_b = _time_ms(whole, device)
    loop_b = _time_ms(loop, device)
    plain_b = _time_ms(plain, device, calls=5, reps=3)
    graph = _graph_ms(lambda: whole, device)
    loop_graph = _graph_ms(lambda: loop, device)
    lib_p = p.clone().requires_grad_()
    lib_p.grad = g
    lib = torch.optim.AdamW([lib_p], lr=opt.lr, eps=opt.eps,
                            weight_decay=opt.weight_decay, fused=True,
                            capturable=True)
    library = _library_ms(lib.step, device)
    del lib, lib_p, p, m, v, pst
    row = {"elements": n, "launches_overlap_on": launches,
           "buckets": len(buckets), "event_ms": min(kernel_a, kernel_b),
           "ms": graph, "bucket_loop_ms": loop_graph,
           "bucket_loop_event_ms": min(loop_a, loop_b),
           "plain_ms": min(plain_a, plain_b),
           "bound_ms": _bound_ms("adam", n), "bound_by": "bytes",
           **library, "max_abs_err": max(e[0] for e in errs.values()),
           "errors": {o: {"max_abs": e[0], "max_rel": e[1], "ok": e[2]}
                      for o, e in errs.items()},
           "buckets_bitwise_whole": bucket_bitwise}
    emit("kernels_flat_adam", **row)
    if not (all(e[2] for e in errs.values()) and bucket_bitwise):
        raise AssertionError(f"flat Adam: kernel against plain {errs}, "
                             f"buckets bitwise {bucket_bitwise}")
    return row


ZERO_RESTORE_THREADS = (1, 8)


def phase_zero_ckpt(device):
    """ZeRO-2 (overlap on) under the deterministic flag: run A takes 6
    steps and saves after step 3; run B, a fresh engine from another seed,
    loads it and takes steps 4-6.  Run B's losses, flat master, moments,
    step and loss-scale state must equal run A's bitwise.  Then a third
    engine loads the save with ``checkpoint.restore_threads`` 1 and 8
    (ZERO_RESTORE_THREADS): both loads bitwise equal to the saved state,
    each with its ``restore_seconds``."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.resilience import COUNTERS
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="zero_ckpt_", dir=ROOT / "build")
    ck_dir = os.path.join(work, "ckpt")
    zero_cfg = dict(ZERO_RUNS)["stage2_overlap"]
    try:
        with deterministic():
            a = zero_engine(device, zero_cfg)
            batch = lm_batch(MICRO * GAS, GPT2_SEQ,
                             a.module.config.vocab_size)
            batches = [batch, lm_batch(MICRO * GAS, GPT2_SEQ,
                                       a.module.config.vocab_size, seed=1)]
            reset_launch_counts()
            losses_a = []
            for step in range(1, GPT2_STEPS + 1):
                losses_a.append(a.train_batch(batches[step % 2]))
                if step == ZERO_SAVE_AT:
                    sync(device)
                    t0 = time.perf_counter()
                    path = a.save_checkpoint(ck_dir)
                    save_s = time.perf_counter() - t0
                    save_bytes = a.last_save_bytes
                    files = sorted(os.listdir(path))
                    root_files = sorted(os.listdir(ck_dir))
                    # the saved state, on the card: what both restores
                    # below must equal
                    saved = {"master": a.master_flat.clone(),
                             "m": a.opt_state.m["flat"].clone(),
                             "v": a.opt_state.v["flat"].clone(),
                             "step": a.opt_state.step}
            sync(device)
            launches_a = launch_counts()
            b = zero_engine(device, zero_cfg, seed=1)
            sync(device)
            t0 = time.perf_counter()
            b.load_checkpoint(ck_dir)
            sync(device)
            load_s = time.perf_counter() - t0
            reset_launch_counts()
            losses_b = [b.train_batch(batches[step % 2]) for step in
                        range(ZERO_SAVE_AT + 1, GPT2_STEPS + 1)]
            sync(device)
            launches_b = launch_counts()
            sa, sb = a.opt_state, b.opt_state
            bitwise = {
                "losses": all(torch.equal(x, y) for x, y in zip(
                    losses_a[ZERO_SAVE_AT:], losses_b)),
                "master": torch.equal(a.master_flat, b.master_flat),
                "m": torch.equal(sa.m["flat"], sb.m["flat"]),
                "v": torch.equal(sa.v["flat"], sb.v["flat"]),
                "params": torch.equal(a._params_flat, b._params_flat),
                "step": sa.step == sb.step,
                "loss_scale": all(torch.equal(x, y) for x, y in zip(
                    a.loss_scale_state, b.loss_scale_state)),
                "counters": (a.global_steps, a.micro_steps,
                             a.skipped_steps)
                == (b.global_steps, b.micro_steps, b.skipped_steps)}
            buckets = len(a._comm_buckets())
            attn = a.module.config.num_layers * GAS
            steps_b = GPT2_STEPS - ZERO_SAVE_AT
            del a, b
            free(device)
            # the restore plan serial and pooled, into one engine
            c = zero_engine(device, zero_cfg, seed=2)
            loads = {}
            for threads in ZERO_RESTORE_THREADS:
                c.config.checkpoint_restore_threads = threads
                COUNTERS.restore_seconds = 0.0
                sync(device)
                t0 = time.perf_counter()
                c.load_checkpoint(ck_dir)
                sync(device)
                loads[threads] = {
                    "restore_seconds": COUNTERS.restore_seconds,
                    "wall_s": time.perf_counter() - t0,
                    "bitwise": all(torch.equal(t, saved[k]) for k, t in (
                        ("master", c.master_flat),
                        ("m", c.opt_state.m["flat"]),
                        ("v", c.opt_state.v["flat"])))
                    and c.opt_state.step == saved["step"]}
            del c, saved
            free(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checks = {"bitwise": all(bitwise.values()),
              "restore_pooled_equals_serial": all(
                  r["bitwise"] for r in loads.values())
              and all(r["restore_seconds"] > 0 for r in loads.values()),
              "files": files == [ZERO_MODEL_FILE, ZERO_OPTIM_FILE]
              and root_files == ["global_step3", "latest"],
              "launches": (launches_a == no_launches(
                  adam=buckets * GPT2_STEPS, block_fwd=attn * GPT2_STEPS,
                  block_bwd=attn * GPT2_STEPS)
                  and launches_b == no_launches(
                      adam=buckets * steps_b, block_fwd=attn * steps_b,
                      block_bwd=attn * steps_b))}
    emit("zero_ckpt", model="gpt2-medium", zero=zero_cfg, deterministic=True,
         save_after=ZERO_SAVE_AT, files=files, save_bytes=save_bytes,
         save_s=save_s, load_s=load_s,
         restore=loads,
         losses_a=[float(x) for x in losses_a],
         losses_b=[float(x) for x in losses_b], bitwise=bitwise,
         launches_a=launches_a, launches_b=launches_b, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"zero_ckpt phase failed: {checks} {bitwise}")


# the tensor-parallel phase (tp_gpt2): GPT-2 medium as train_gpt2 at mp 2,
# dp 1, as two processes on the one card over a gloo model group (NCCL
# refuses two ranks on one device; gloo stages each collective through the
# host).  Runs: (a) ZeRO off, (b) ZeRO-1 with overlap_comm, saved after
# step 3, (c) that save resumed by fresh processes, (e) a tiny fp32 GPT-2
# at mp 2 against mp 1; (d), in the parent: the mp 2 model states loaded
# into an mp 1 GPT-2 medium.
TP, TP_SAVE_AT = 2, 3
TP_ZERO = {"stage": 1, "overlap_comm": True}
# (a) against train_gpt2: the two partial products of every row-parallel
# layer are rounded to bf16 before their sum, which train_gpt2 does not do
TP_LOSS_RTOL = 2e-2
# (e) tiny fp32 GPT-2 at mp 2 against mp 1: the same arithmetic in fp32,
# the sums split over two ranks
TP_TINY_RTOL = 1e-5
TP_CHILD_TIMEOUT = 600
# the depth of the multi-rank phases of GPT-2 medium before this slice's
# (tp_gpt2, zero3_gpt2, pp_gpt2, sp_gpt2, zero3_pp_gpt2): 6 of its 24
# layers, at its full width, so that the whole script stays inside its
# time limit with moe_gpt2, multistep_gpt2 and resume_gpt2 after them (at
# 12 layers the script took 1,147 s of its 1,200); tp_gpt2, pp_gpt2 and
# zero3_pp_gpt2 are held to gpt2_reference, sp_gpt2 to
# gpt2_1024_reference, train_gpt2's and train_gpt2_1024's weights and
# batches at this depth
EARLY_LAYERS = 6
# the depth of moe_gpt2's ep 2 runs and their reference, multistep_gpt2
# and resume_gpt2: 12 of the 24 layers, full width
MID_LAYERS = 12


def _depth(layers):
    """``from_size`` overrides for a model of ``layers`` layers (None: the
    size's own depth)."""
    return {} if layers is None else {"num_layers": int(layers)}


def phase_gpt2_reference(device, layers=EARLY_LAYERS, micro=MICRO,
                         seq=GPT2_SEQ, name="gpt2_reference"):
    """train_gpt2's run (seed-0 weights, its batch, 6 steps, mp 1, ZeRO
    off) at ``layers`` layers, or at ``seq`` 1024 train_gpt2_1024's
    (``micro`` 4): the losses the shallower multi-rank phases are held
    to."""
    over = {} if seq == GPT2_SEQ else {"max_seq_len": seq}
    engine = make_engine(gpt2_config(micro), device, size="medium",
                         gpt2=True, **_depth(layers), **over)
    batch = lm_batch(micro * GAS, seq, engine.module.config.vocab_size)
    losses = [float(engine.train_batch(batch)) for _ in range(GPT2_STEPS)]
    emit(name, model="gpt2-medium", layers=layers, seq=seq,
         micro_batch=micro, gas=GAS, losses=losses)
    del engine, batch
    free(device)
    return losses


def tp_engine(device, zero_cfg, seed=0, mp=TP, size="medium", cfg=None,
              layers=None):
    """GPT-2 ``size`` (at ``layers`` layers) from ``seed`` at ``mp``
    (medium: train_gpt2's weights for seed 0), its global weights cut by
    the engine; ``cfg`` defaults to train_gpt2's."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2
    cfg = dict(cfg or gpt2_config(MICRO))
    if zero_cfg is not None:
        cfg["zero_optimization"] = zero_cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    model = GPT2.from_size(size, generator=gen, device=device,
                           **_depth(layers))
    mesh = deepspeed_tpu_torch.MeshConfig(model_parallel_size=mp)
    return deepspeed_tpu_torch.initialize(config=cfg, model=model,
                                          device=device, mesh=mesh)[0]


def _sha(t):
    """sha256 of a tensor's bytes (bitwise identity across processes)."""
    import hashlib
    import torch
    raw = t.detach().contiguous().view(-1)
    if raw.dtype != torch.int32 and raw.element_size() == 4:
        raw = raw.view(torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def _tp_train(engine, batch, steps, device, save_dir=None):
    """``steps`` train_batch steps; (losses, step_ms, launches)."""
    losses, step_ms = [], []
    sync(device)
    reset_launch_counts()
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if save_dir is not None and step == TP_SAVE_AT:
            engine.save_checkpoint(save_dir)
    return losses, step_ms, launch_counts()


def _peak_gib(device):
    import torch
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _reset_peak(device):
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _zero_digest(engine):
    st = engine.opt_state
    return {"master": _sha(engine.master_flat), "m": _sha(st.m["flat"]),
            "v": _sha(st.v["flat"]), "step": st.step,
            "loss_scale": [_sha(x.float().reshape(1))
                           for x in engine.loss_scale_state]}


def tp_child(spec_path, rank):
    """One rank of the tp_gpt2 phase (started by ``phase_tp_gpt2``): mode
    "train" runs (a), (b) and (e); mode "resume" runs (c).  Writes
    ``<mode>_<rank>.json`` beside the spec."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.parallel import topology
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    size, cfg = spec["size"], gpt2_config(spec["micro"])
    if device.type == "cuda":
        for mod in _counted():          # the parent's build, loaded
            mod.build()
    topology.init_distributed(coordinator_address=spec["coordinator"],
                              num_processes=TP, process_id=rank,
                              device=device, backend="gloo")
    out = {"rank": rank, "backend": dist.get_backend()}
    t_start = time.perf_counter()
    with deterministic():
        if spec["mode"] == "train":
            a = tp_engine(device, None, size=size, cfg=cfg,
                          layers=spec["layers"])
            batch = lm_batch(spec["micro"] * GAS, GPT2_SEQ,
                             a.module.config.vocab_size)
            _reset_peak(device)
            losses, step_ms, launches = _tp_train(a, batch, GPT2_STEPS,
                                                  device)
            specs = a._param_specs
            repl = {k: t for k, t in a.master.items()
                    if specs[k] is None}
            meta = zero.make_flat_meta(a.master, 1)
            flat_a = zero.flatten_tree(a.master, meta)[:meta.total]
            out["a"] = {"losses": losses, "step_ms": step_ms,
                        "launches": launches, "leaves": len(a.master),
                        "layers": a.module.config.num_layers,
                        "peak_mem_gib": _peak_gib(device),
                        "local_params": a.num_parameters(),
                        "replicated": {k: _sha(t) for k, t in repl.items()},
                        "replicated_elements": sum(t.numel()
                                                   for t in repl.values())}
            del a
            free(device)
            b = tp_engine(device, TP_ZERO, size=size, cfg=cfg,
                          layers=spec["layers"])
            _reset_peak(device)
            losses, step_ms, launches = _tp_train(
                b, batch, GPT2_STEPS, device, save_dir=spec["ckpt"])
            meta, buckets = b.flat_meta, b._comm_buckets()
            out["b"] = {"losses": losses, "step_ms": step_ms,
                        "launches": launches,
                        "peak_mem_gib": _peak_gib(device),
                        "masters_equal_a": bool(torch.equal(
                            b.master_flat[:meta.total], flat_a)),
                        "layout": {"elements": meta.total,
                                   "padded": meta.padded,
                                   "buckets": len(buckets),
                                   "last_bucket": buckets[-1][1]
                                   - buckets[-1][0]},
                        **_zero_digest(b)}
            del b, flat_a
            free(device)
            e = tp_engine(device, None, size="tiny",
                          cfg=gpt2_config(4, dtype="fp32", lr=1e-3))
            out["e"] = {"losses": [
                float(e.train_batch(lm_batch(4 * GAS, 128, 512,
                                             seed=100 + step)))
                for step in range(3)]}
            del e
        else:
            c = tp_engine(device, TP_ZERO, seed=1, size=size, cfg=cfg,
                          layers=spec["layers"])
            batch = lm_batch(spec["micro"] * GAS, GPT2_SEQ,
                             c.module.config.vocab_size)
            c.load_checkpoint(spec["ckpt"])
            losses, step_ms, launches = _tp_train(
                c, batch, GPT2_STEPS - TP_SAVE_AT, device)
            out["c"] = {"losses": losses, "step_ms": step_ms,
                        "launches": launches, **_zero_digest(c)}
            del c
    free(device)
    out["seconds"] = time.perf_counter() - t_start
    (pathlib.Path(spec_path).parent / f"{spec['mode']}_{rank}.json"
     ).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def _tp_launch(work, mode, run, flag="--tp-child", world=TP):
    """Run ``mode`` in ``world`` child processes (``chip_smoke.py <flag>
    <spec> <rank>``; ``run``: the spec's device, checkpoint directory,
    model size and micro-batch); their results by rank."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = work / f"{mode}.json"
    spec.write_text(json.dumps({"mode": mode, **run,
                                "coordinator": f"tcp://127.0.0.1:{port}"}))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               flag, str(spec), str(r)])
             for r in range(world)]
    try:
        deadline = time.monotonic() + TP_CHILD_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise AssertionError(f"{flag} {mode} ranks exited {bad}")
    return [json.loads((work / f"{mode}_{r}.json").read_text())
            for r in range(world)]


def phase_tp_gpt2(device, train_losses, size="medium", micro=MICRO,
                  layers=None):
    """GPT-2 medium (at ``layers`` layers) at mp 2 on two processes over a
    gloo model group (see TP): runs (a)-(e), the checks of each, and the
    exact launches per rank.  ``train_losses``: train_gpt2's, for the same
    weights, depth and batch at mp 1."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch import checkpoint as ck
    from deepspeed_tpu_torch import weights
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="tp_gpt2_",
                                         dir=ROOT / "build"))
    ck_dir = str(work / "ckpt")
    run = {"device": str(device), "ckpt": ck_dir, "size": size,
           "micro": micro, "layers": layers}
    try:
        tr = _tp_launch(work, "train", run)
        tag = f"global_step{TP_SAVE_AT}"
        files = {f: os.path.getsize(os.path.join(ck_dir, tag, f))
                 for f in sorted(os.listdir(os.path.join(ck_dir, tag)))}
        rs = _tp_launch(work, "resume", run)

        # (d): the mp 2 model states into an mp 1 GPT-2 medium
        d = tp_engine(device, None, seed=2, mp=1, size=size,
                      cfg=gpt2_config(micro), layers=layers)
        d.load_checkpoint(ck_dir, load_optimizer_states=False)
        shards = [{k: ck.to_tensor(v) for k, v in weights.flatten_tree(
            ck._load_obj(ck.model_file(ck_dir, tag, m))["module"]).items()}
            for m in range(TP)]
        joined = weights.flatten_tree(weights.combine_local_trees(
            shards, d._param_specs))
        cross_mp = all(torch.equal(p.cpu(), joined[k])
                       for k, p in d.module.named_parameters())
        del d, shards, joined
        free(device)

        # (e): the same tiny fp32 GPT-2 at mp 1 in this process
        e = tp_engine(device, None, mp=1, size="tiny",
                      cfg=gpt2_config(4, dtype="fp32", lr=1e-3))
        tiny = [float(e.train_batch(lm_batch(4 * GAS, 128, 512,
                                             seed=100 + step)))
                for step in range(3)]
        del e
        free(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    a, b, c = ([r["a"] for r in tr], [r["b"] for r in tr],
               [r["c"] for r in rs])
    per_step = a[0]["layers"] * GAS        # layers x micro-batches
    rest = GPT2_STEPS - TP_SAVE_AT
    buckets = b[0]["layout"]["buckets"]
    expect = {"a": no_launches(adam=a[0]["leaves"] * GPT2_STEPS,
                               block_fwd=per_step * GPT2_STEPS,
                               block_bwd=per_step * GPT2_STEPS),
              "b": no_launches(adam=buckets * GPT2_STEPS,
                               block_fwd=per_step * GPT2_STEPS,
                               block_bwd=per_step * GPT2_STEPS),
              "c": no_launches(adam=buckets * rest,
                               block_fwd=per_step * rest,
                               block_bwd=per_step * rest)}
    gap = [abs(x - y) / abs(y) for x, y in zip(a[0]["losses"], train_losses)]
    tiny_gap = max(abs(x - y) / abs(y)
                   for x, y in zip(tr[0]["e"]["losses"], tiny))
    checks = {
        "losses_equal_across_ranks": all(
            run[0]["losses"] == run[1]["losses"] for run in (a, b, c))
        and tr[0]["e"]["losses"] == tr[1]["e"]["losses"],
        "replicated_masters_equal_across_ranks":
            a[0]["replicated"] == a[1]["replicated"]
            and len(a[0]["replicated"]) == 9,
        "a_vs_train_gpt2": max(gap) <= TP_LOSS_RTOL,
        "zero1_equals_off": all(x["losses"] == y["losses"]
                                and x["masters_equal_a"]
                                for x, y in zip(b, a)),
        "resume_bitwise": all(
            z["losses"] == y["losses"][TP_SAVE_AT:]
            and all(z[k] == y[k] for k in ("master", "m", "v", "step",
                                           "loss_scale"))
            for z, y in zip(c, b)),
        "cross_mp_load": cross_mp,
        "tiny_mp2_vs_mp1": tiny_gap <= TP_TINY_RTOL,
        "launches": all(r["launches"] == expect[k] for k, run in
                        (("a", a), ("b", b), ("c", c)) for r in run),
    }
    emit("tp_gpt2", model=f"gpt2-{size}", layers=a[0]["layers"], mp=TP,
         dp=1, seq=GPT2_SEQ,
         micro_batch=micro, gas=GAS, dtype="bf16", optimizer="Adam",
         lr=1e-4, backend=tr[0]["backend"],
         transport="gloo over the host (not NVLink)",
         local_params=a[0]["local_params"],
         replicated_leaves=len(a[0]["replicated"]),
         replicated_elements=a[0]["replicated_elements"],
         layout=b[0]["layout"], ckpt_files=files,
         losses={"a": a[0]["losses"], "b": b[0]["losses"],
                 "c": c[0]["losses"], "train_gpt2": train_losses,
                 "tiny_mp2": tr[0]["e"]["losses"], "tiny_mp1": tiny},
         a_vs_train_gpt2_rel=gap, tiny_mp2_vs_mp1_max_rel=tiny_gap,
         launches={k: [r["launches"] for r in run]
                   for k, run in (("a", a), ("b", b), ("c", c))},
         expected_launches=expect,
         step_ms_over_gloo={k: [r["step_ms"] for r in run]
                            for k, run in (("a", a), ("b", b), ("c", c))},
         peak_mem_gib={k: [r["peak_mem_gib"] for r in run]
                       for k, run in (("a", a), ("b", b))},
         child_seconds=[r["seconds"] for r in tr + rs], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"tp_gpt2 phase failed: {checks}")
    return {k: [r["launches"] for r in run]
            for k, run in (("a", a), ("b", b))}


# the zero3_gpt2 phase: GPT-2 medium at dp 2 under ZeRO-3, as two child
# processes on the one card over a gloo data group (NCCL refuses two ranks
# on one device, so every gather and reduce-scatter stages through the
# host: the step times are not ZeRO-3's on NVLink).  Micro-batch 16 per
# rank, gas 2: each step is train_gpt2's 64 rows, rank r's 32 of them.
Z3_DP, Z3_MICRO, Z3_SAVE_AT, Z3_SHORT_STEPS = 2, 16, 3, 3
Z3_BASE = {"stage": 3, "overlap_comm": False}
# (d) ZeRO-1 against (a): ZeRO-3 reduce-scatters each micro-step's bf16
# gradient in bf16 (one more rounding of the two ranks' sum) before the
# fp32 accumulation and the 1/world, ZeRO-1 adds the ranks' fp32
# accumulators; the limit is the phase's check, the prediction is in
# PERF.md
Z3_ZERO1_RTOL = 1e-2
# the dp 1 stage-0 load of (a)'s save against (a)'s steps 4-6 (rank 1's
# rows are the dp 1 run's last micro-step): the same weights, then the
# reductions of steps 5-6 in another order
Z3_DP1_RTOL = 1e-2


def z3_config(micro, gas, dp, zero_cfg, remat=False):
    cfg = gpt2_config(micro)
    cfg["train_batch_size"] = micro * gas * dp
    cfg["gradient_accumulation_steps"] = gas
    cfg["activation_checkpointing"] = remat
    if zero_cfg is not None:
        cfg["zero_optimization"] = zero_cfg
    return cfg


def _z3_digest(engine):
    """sha256 of every fp32 master, m and v leaf (shards at stage 3)."""
    import hashlib
    h = hashlib.sha256()
    st = engine.opt_state
    if engine.zero_flat:
        trees = [{"flat": engine.master_flat}, st.m, st.v]
    else:
        trees = [engine.master, st.m, st.v]
    for tree in trees:
        for k in sorted(tree):
            h.update(_sha(tree[k]).encode())
    return h.hexdigest()


def z3_child(spec_path, rank):
    """One rank of the zero3_gpt2 phase (started by
    ``phase_zero3_gpt2``): mode "train" runs (a)-(d), mode "resume" the
    resume of (a)'s save.  Writes ``<mode>_<rank>.json`` beside the
    spec."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import topology
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    size, micro = spec["size"], spec["micro"]
    if device.type == "cuda":
        for mod in _counted():          # the parent's build, loaded
            mod.build()
    topology.init_distributed(coordinator_address=spec["coordinator"],
                              num_processes=Z3_DP, process_id=rank,
                              device=device, backend="gloo")
    out = {"rank": rank, "backend": dist.get_backend()}
    t_start = time.perf_counter()

    def engine(zero_cfg, seed=0, remat=False):
        return make_engine(z3_config(micro, GAS, Z3_DP, zero_cfg, remat),
                           device, size=size, seed=seed, gpt2=True,
                           **_depth(spec["layers"]))

    def run(eng, steps, save_dir=None):
        vocab = eng.module.config.vocab_size
        toks, labels = lm_batch(micro * GAS * Z3_DP, GPT2_SEQ, vocab)
        rows = slice(rank * micro * GAS, (rank + 1) * micro * GAS)
        batch = (toks[rows], labels[rows])
        losses, step_ms, extra = [], [], {}
        sync(device)
        _reset_peak(device)
        reset_launch_counts()
        for step in range(1, steps + 1):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(batch)))
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if save_dir is not None and step == Z3_SAVE_AT:
                extra["digest_at_save"] = _z3_digest(eng)
                t0 = time.perf_counter()
                path = eng.save_checkpoint(save_dir)
                extra["save_s"] = time.perf_counter() - t0
                extra["files"] = {f: os.path.getsize(os.path.join(path, f))
                                  for f in sorted(os.listdir(path))}
        res = {"losses": losses, "step_ms": step_ms,
               "launches": launch_counts(), "peak_mem_gib": _peak_gib(device),
               "digest": _z3_digest(eng),
               "layers": eng.module.config.num_layers, **extra}
        if eng.zero3:
            dims = eng._zero3_dims
            res["layout"] = {
                "dims": dims,
                "partitioned_leaves": sum(d >= 0 for d in dims.values()),
                "elements_per_rank": sum(
                    t.numel() for k, t in eng.master.items()
                    if dims[k] >= 0),
                "replicated_elements": sum(
                    t.numel() for k, t in eng.master.items()
                    if dims[k] < 0)}
        return res

    with deterministic():
        if spec["mode"] == "train":
            for name, zero_cfg, remat, steps, save in (
                    ("a", Z3_BASE, False, GPT2_STEPS, spec["ckpt"]),
                    ("b", dict(Z3_BASE, overlap_comm=True), False,
                     Z3_SHORT_STEPS, None),
                    ("c", Z3_BASE, {"enabled": True, "policy": "full"},
                     Z3_SHORT_STEPS, None),
                    ("d", {"stage": 1, "overlap_comm": False}, False,
                     Z3_SHORT_STEPS, None)):
                eng = engine(zero_cfg, remat=remat)
                out[name] = run(eng, steps, save)
                del eng
                free(device)
        else:
            eng = engine(Z3_BASE, seed=1)
            t0 = time.perf_counter()
            eng.load_checkpoint(spec["ckpt"])
            sync(device)
            load_s = time.perf_counter() - t0
            out["resume"] = dict(run(eng, GPT2_STEPS - Z3_SAVE_AT),
                                 load_s=load_s)
            del eng
    free(device)
    out["seconds"] = time.perf_counter() - t_start
    (pathlib.Path(spec_path).parent / f"{spec['mode']}_{rank}.json"
     ).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_zero3_gpt2(device, size="medium", micro=Z3_MICRO, layers=None):
    """GPT-2 medium at dp 2 under ZeRO-3 on two processes over gloo (see
    Z3_DP): (a) on-demand gathers, saved after step 3; (b) the prefetch
    (overlap_comm) and (c) "full" remat, each bitwise equal to (a); (d)
    ZeRO-1 at dp 2 within Z3_ZERO1_RTOL of (a); the resume of (a)'s save
    in fresh processes, bitwise equal to (a)'s steps 4-6; and (a)'s save
    loaded into this process at dp 1 and stage 0 (the rehydrate), whose
    steps 4-6 are within Z3_DP1_RTOL of (a)'s.  Launches exact per rank.
    Returns the launches by run and rank."""
    import shutil
    import tempfile

    import numpy as np
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="zero3_gpt2_",
                                         dir=ROOT / "build"))
    ck_dir = str(work / "ckpt")
    spec = {"device": str(device), "ckpt": ck_dir, "size": size,
            "micro": micro, "layers": layers}
    try:
        tr = _tp_launch(work, "train", spec, flag="--z3-child", world=Z3_DP)
        rs = _tp_launch(work, "resume", spec, flag="--z3-child", world=Z3_DP)
        # the save into one process at dp 1, stage 0, gas 4: its micro-steps
        # are rank 0's two, then rank 1's two
        eng = make_engine(z3_config(micro, GAS * Z3_DP, 1, None), device,
                          size=size, seed=2, gpt2=True, **_depth(layers))
        t0 = time.perf_counter()
        eng.load_checkpoint(ck_dir)
        sync(device)
        dp1_load_s = time.perf_counter() - t0
        batch = lm_batch(micro * GAS * Z3_DP, GPT2_SEQ,
                         eng.module.config.vocab_size)
        reset_launch_counts()
        dp1 = [float(eng.train_batch(batch))
               for _ in range(GPT2_STEPS - Z3_SAVE_AT)]
        dp1_launches = launch_counts()
        del eng
        free(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    runs = {k: [r[k] for r in tr] for k in ("a", "b", "c", "d")}
    runs["resume"] = [r["resume"] for r in rs]
    a = runs["a"]
    per = a[0]["layout"]
    layers, leaves = a[0]["layers"], len(per["dims"])
    blk = layers * GAS                      # per step: layers x micro-steps
    short, rest = Z3_SHORT_STEPS, GPT2_STEPS - Z3_SAVE_AT
    expect = {"a": no_launches(adam=leaves * GPT2_STEPS,
                               block_fwd=blk * GPT2_STEPS,
                               block_bwd=blk * GPT2_STEPS),
              "b": no_launches(adam=leaves * short, block_fwd=blk * short,
                               block_bwd=blk * short),
              # the full remat replays each block's forward in the backward
              "c": no_launches(adam=leaves * short,
                               block_fwd=2 * blk * short,
                               block_bwd=blk * short),
              "d": no_launches(adam=short, block_fwd=blk * short,
                               block_bwd=blk * short),
              "resume": no_launches(adam=leaves * rest, block_fwd=blk * rest,
                                    block_bwd=blk * rest)}
    rel = lambda x, y: [abs(p - q) / abs(q) for p, q in zip(x, y)]
    zero1_gap = max(max(rel(d["losses"], x["losses"][:short]))
                    for d, x in zip(runs["d"], a))
    dp1_gap = rel(dp1, a[1]["losses"][Z3_SAVE_AT:])
    files = a[0]["files"]
    z3_files = {f: n for f, n in files.items()
                if f.startswith("zero3_dp_rank_")}
    checks = {
        "all_leaves_partitioned_on_every_rank": all(
            r["layout"] == per for r in a) and per["partitioned_leaves"] ==
        leaves,
        "prefetch_bitwise": all(
            b["losses"] == x["losses"][:short]
            and b["digest"] == x["digest_at_save"]
            for b, x in zip(runs["b"], a)),
        "full_remat_bitwise": all(
            c["losses"] == x["losses"][:short]
            and c["digest"] == x["digest_at_save"]
            for c, x in zip(runs["c"], a)),
        "full_remat_lower_peak": device.type != "cuda" or all(
            c["peak_mem_gib"] < x["peak_mem_gib"]
            for c, x in zip(runs["c"], a)),
        "zero1_within_rtol": zero1_gap <= Z3_ZERO1_RTOL,
        "resume_bitwise": all(
            z["losses"] == x["losses"][Z3_SAVE_AT:]
            and z["digest"] == x["digest"]
            for z, x in zip(runs["resume"], a)),
        "dp1_rehydrated_within_rtol": max(dp1_gap) <= Z3_DP1_RTOL,
        "dp1_launches": dp1_launches == no_launches(
            adam=leaves * rest, block_fwd=2 * blk * rest,
            block_bwd=2 * blk * rest),
        "one_shard_file_per_rank": len(z3_files) == Z3_DP,
        "finite": all(np.isfinite(r["losses"]).all()
                      for rr in runs.values() for r in rr),
        "launches": all(r["launches"] == expect[k] for k, rr in runs.items()
                        for r in rr),
    }
    steady = lambda ms: (micro * GAS * Z3_DP * (len(ms) - 1)
                         / (sum(ms[1:]) / 1e3))
    emit("zero3_gpt2", model=f"gpt2-{size}", layers=layers, dp=Z3_DP,
         seq=GPT2_SEQ,
         micro_batch_per_rank=micro, gas=GAS, dtype="bf16", optimizer="Adam",
         lr=1e-4, backend=tr[0]["backend"],
         transport="gloo over the host (not NVLink)", layout=per,
         losses={k: [r["losses"] for r in rr] for k, rr in runs.items()},
         dp1_rehydrated_losses=dp1, dp1_vs_a_rel=dp1_gap,
         zero1_vs_a_max_rel=zero1_gap,
         launches={k: [r["launches"] for r in rr] for k, rr in runs.items()},
         expected_launches=expect, dp1_launches=dp1_launches,
         peak_mem_gib={k: [r["peak_mem_gib"] for r in rr]
                       for k, rr in runs.items()},
         step_ms_over_gloo={k: [r["step_ms"] for r in rr]
                            for k, rr in runs.items()},
         median_step_ms={k: statistics.median(rr[0]["step_ms"][1:])
                         for k, rr in runs.items()},
         samples_per_s_steady={k: steady(rr[0]["step_ms"])
                               for k, rr in runs.items()},
         ckpt_files=files, save_s=[r["save_s"] for r in a],
         load_s=[r["load_s"] for r in runs["resume"]],
         dp1_load_s=dp1_load_s,
         child_seconds=[r["seconds"] for r in tr + rs], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"zero3_gpt2 phase failed: {checks}")
    return {k: [r["launches"] for r in rr] for k, rr in runs.items()}


# the pp_gpt2 phase: GPT-2 medium (EARLY_LAYERS deep) at pp 2, as two child
# processes on the one card over a gloo pipe group (NCCL refuses two ranks
# on one device, so every activation, gradient and the stage-replicated
# leaves' gradient sum stage through the host: the step times are not a
# pipeline's on NVLink).  train_gpt2's seed-0 weights and batch: micro-batch
# 32, gas 2, 8 pipeline micro-batches of 4 rows (divisible by pp: the head
# is sharded over the stages in both schedules).
PP, PP_MICRO_BATCHES, PP_SAVE_AT, PP_SHORT_STEPS = 2, 8, 3, 3
# (a) against train_gpt2: the same weights and batch, 8 micro-batches of 4
# rows instead of one of 32 (other GEMM shapes, so other bf16 roundings),
# the micro-batches' and the stages' gradients added in fp32
PP_LOSS_RTOL = 2e-2
# (b) 1F1B against (a) GPipe: the same arithmetic per micro-batch, the
# micro-batches' gradients added in another order
PP_1F1B_RTOL = 1e-2


def pp_config(micro, zero_cfg=None, schedule=None):
    cfg = gpt2_config(micro)
    cfg["pipeline_parallel_size"] = PP
    if zero_cfg is not None:
        cfg["zero_optimization"] = zero_cfg
    if schedule is not None:
        cfg["pipeline_schedule"] = schedule
    return cfg


def pp_engine(device, size, micro, seed=0, layers=None, **cfg):
    """GPT-2 ``size`` (at ``layers`` layers) from ``seed`` (medium, seed 0:
    train_gpt2's weights), pipelined over the started group's PP
    stages."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2Pipelined
    gen = torch.Generator(device=device).manual_seed(seed)
    model = GPT2Pipelined.from_size(size, num_micro_batches=PP_MICRO_BATCHES,
                                    generator=gen, device=device,
                                    **_depth(layers))
    return deepspeed_tpu_torch.initialize(
        config=pp_config(micro, **cfg), model=model, device=device)[0]


def pp_child(spec_path, rank):
    """One stage of the pp_gpt2 phase (started by ``phase_pp_gpt2``): mode
    "train" runs (a) GPipe saved after step PP_SAVE_AT, (b) 1F1B and (c)
    GPipe with ZeRO-1; mode "resume" runs (d), the resume of (a)'s save.
    Writes ``<mode>_<rank>.json`` beside the spec."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import topology
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    size, micro = spec["size"], spec["micro"]
    if device.type == "cuda":
        for mod in _counted():          # the parent's build, loaded
            mod.build()
    topology.init_distributed(coordinator_address=spec["coordinator"],
                              num_processes=PP, process_id=rank,
                              device=device, backend="gloo")
    out = {"rank": rank, "backend": dist.get_backend()}
    t_start = time.perf_counter()

    def run(eng, steps, save_dir=None):
        batch = lm_batch(micro * GAS, GPT2_SEQ, eng.module.config.vocab_size)
        losses, step_ms, extra = [], [], {}
        sync(device)
        _reset_peak(device)
        reset_launch_counts()
        for step in range(1, steps + 1):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(batch)))
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if save_dir is not None and step == PP_SAVE_AT:
                t0 = time.perf_counter()
                path = eng.save_checkpoint(save_dir)
                extra["save_s"] = time.perf_counter() - t0
                extra["files"] = {f: os.path.getsize(os.path.join(path, f))
                                  for f in sorted(os.listdir(path))}
        return {"losses": losses, "step_ms": step_ms,
                "launches": launch_counts(), "peak_mem_gib": _peak_gib(device),
                "digest": _z3_digest(eng), "stage": eng.pp_rank,
                "leaves": len(eng._params),
                "layers": int(eng.module.blocks.qkv_w.shape[0]),
                "local_params": eng.num_parameters(),
                "held": eng.module.last_pipe_stats.get("max_held_inputs"),
                **extra}

    with deterministic():
        if spec["mode"] == "train":
            for name, cfg, steps, save in (
                    ("a", {}, GPT2_STEPS, spec["ckpt"]),
                    ("b", {"schedule": "1f1b"}, PP_SHORT_STEPS, None),
                    ("c", {"zero_cfg": {"stage": 1, "overlap_comm": False}},
                     PP_SHORT_STEPS, None)):
                eng = pp_engine(device, size, micro, layers=spec["layers"],
                                **cfg)
                out[name] = run(eng, steps, save)
                del eng
                free(device)
        else:
            eng = pp_engine(device, size, micro, seed=1,
                            layers=spec["layers"])
            t0 = time.perf_counter()
            eng.load_checkpoint(spec["ckpt"])
            sync(device)
            load_s = time.perf_counter() - t0
            out["d"] = dict(run(eng, GPT2_STEPS - PP_SAVE_AT), load_s=load_s)
            del eng
    free(device)
    out["seconds"] = time.perf_counter() - t_start
    (pathlib.Path(spec_path).parent / f"{spec['mode']}_{rank}.json"
     ).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_pp_gpt2(device, train_losses, size="medium", micro=MICRO,
                  layers=None):
    """GPT-2 medium at pp 2 on two processes over gloo (see PP): (a)
    GPipe, 6 steps, saved after step 3, within PP_LOSS_RTOL of
    ``train_losses`` (train_gpt2's, the same weights and batch at pp 1);
    (b) 1F1B, 3 steps, within PP_1F1B_RTOL of (a) and at a lower peak on
    both stages; (c) GPipe with ZeRO-1 (the flat Adam per stage), 3
    steps, bitwise equal to (a); (d) fresh processes resume (a)'s save,
    bitwise equal to (a)'s steps 4-6.  Launches exact per stage.  Returns
    the launches by run and stage."""
    import shutil
    import tempfile

    import numpy as np
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="pp_gpt2_",
                                         dir=ROOT / "build"))
    run = {"device": str(device), "ckpt": str(work / "ckpt"), "size": size,
           "micro": micro, "layers": layers}
    try:
        tr = _tp_launch(work, "train", run, flag="--pp-child", world=PP)
        rs = _tp_launch(work, "resume", run, flag="--pp-child", world=PP)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    runs = {k: [r[k] for r in tr] for k in ("a", "b", "c")}
    runs["d"] = [r["d"] for r in rs]
    a = runs["a"]
    short, rest = PP_SHORT_STEPS, GPT2_STEPS - PP_SAVE_AT
    # per step and stage: the stage's layers x pipeline micro-batches x gas
    blk = a[0]["layers"] * PP_MICRO_BATCHES * GAS
    leaves = a[0]["leaves"]

    def launches(steps, adam, fwd=blk):
        return no_launches(adam=adam * steps, block_fwd=fwd * steps,
                           block_bwd=blk * steps)
    expect = {"a": [launches(GPT2_STEPS, leaves)] * PP,
              # 1F1B replays each micro-batch's forward for its backward,
              # except on the last stage, whose backward of a micro-batch
              # runs in the tick of its forward
              "b": [launches(short, leaves, 2 * blk)] * (PP - 1)
              + [launches(short, leaves)],
              "c": [launches(short, 1)] * PP,
              "d": [launches(rest, leaves)] * PP}
    rel = lambda x, y: [abs(p - q) / abs(q) for p, q in zip(x, y)]
    gap = rel(a[0]["losses"], train_losses)
    f1b_gap = rel(runs["b"][0]["losses"], a[0]["losses"][:short])
    files = a[0]["files"]
    checks = {
        "stages": [r["stage"] for r in a] == list(range(PP)),
        "losses_equal_across_stages": all(
            rr[0]["losses"] == r["losses"] for rr in runs.values()
            for r in rr),
        "a_vs_train_gpt2": max(gap) <= PP_LOSS_RTOL,
        "1f1b_vs_a": max(f1b_gap) <= PP_1F1B_RTOL,
        "1f1b_lower_peak": device.type != "cuda" or all(
            b["peak_mem_gib"] < x["peak_mem_gib"]
            for b, x in zip(runs["b"], a)),
        "1f1b_held_inputs": [b["held"] for b in runs["b"]] == [
            min(PP_MICRO_BATCHES, 2 * (PP - 1 - s) + 1)
            for s in range(PP - 1)] + [0],
        "zero1_bitwise": all(c["losses"] == x["losses"][:short]
                             for c, x in zip(runs["c"], a)),
        "resume_bitwise": all(
            d["losses"] == x["losses"][PP_SAVE_AT:]
            and d["digest"] == x["digest"] for d, x in zip(runs["d"], a)),
        "one_model_file_per_stage": sorted(files) == [
            f"pp_stage_{s:02d}_mp_rank_00_model_states.pt"
            for s in range(PP)],
        "finite": all(np.isfinite(r["losses"]).all()
                      for rr in runs.values() for r in rr),
        "launches": all(r["launches"] == want for k, rr in runs.items()
                        for r, want in zip(rr, expect[k])),
    }
    steady = lambda ms: (micro * GAS * (len(ms) - 1) / (sum(ms[1:]) / 1e3))
    emit("pp_gpt2", model=f"gpt2-{size}", layers=PP * a[0]["layers"], pp=PP,
         dp=1, seq=GPT2_SEQ,
         micro_batch=micro, gas=GAS,
         pipeline_micro_batches=PP_MICRO_BATCHES, dtype="bf16",
         optimizer="Adam", lr=1e-4, backend=tr[0]["backend"],
         transport="gloo over the host (not NVLink)",
         local_params=[r["local_params"] for r in a],
         losses={k: rr[0]["losses"] for k, rr in runs.items()},
         train_gpt2=train_losses, a_vs_train_gpt2_rel=gap,
         b_vs_a_rel=f1b_gap,
         launches={k: [r["launches"] for r in rr] for k, rr in runs.items()},
         expected_launches=expect,
         held_inputs=[b["held"] for b in runs["b"]],
         peak_mem_gib={k: [r["peak_mem_gib"] for r in rr]
                       for k, rr in runs.items()},
         step_ms_over_gloo={k: [r["step_ms"] for r in rr]
                            for k, rr in runs.items()},
         median_step_ms={k: statistics.median(rr[0]["step_ms"][1:])
                         for k, rr in runs.items()},
         samples_per_s_steady={k: steady(rr[0]["step_ms"])
                               for k, rr in runs.items()},
         ckpt_files=files, save_s=[r["save_s"] for r in a],
         load_s=[r["load_s"] for r in runs["d"]],
         child_seconds=[r["seconds"] for r in tr + rs], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"pp_gpt2 phase failed: {checks}")
    return {k: [r["launches"] for r in rr] for k, rr in runs.items()}


# the sp_gpt2 phase: GPT-2 medium at its 1024-token context at sp 2, dp 1,
# as two child processes on the one card over a gloo seq group (NCCL refuses
# two ranks on one device, so the ring's shifts, Ulysses' all-to-alls and
# the gradients' seq sum stage through the host: the step times are not
# sequence parallelism's on NVLink).  train_gpt2_1024's seed-0 weights and
# batch (micro-batch 4, gas 2): each rank takes the 8 rows and its 512
# tokens of every row.
SP, SP_SAVE_AT, SP_SHORT_STEPS = 2, 3, 3
# (a) ring and (b) Ulysses against train_gpt2_1024 (sp 1, the same weights
# and batch) and against each other: the ring folds its blocks in fp32
# tensor ops where sp 1 runs the streaming kernels in bf16, Ulysses runs
# those kernels over the whole sequence for half the heads, and the two
# seq ranks' gradients add in fp32
SP_LOSS_RTOL = 1e-2


def sp_config(micro, impl):
    cfg = gpt2_config(micro)
    cfg["context_parallel_size"] = SP
    cfg["sequence_parallel_impl"] = impl
    return cfg


def _child_setup(spec_path, rank, world):
    """A phase child's spec, device and (gloo) process group, the parent's
    kernel build loaded."""
    import torch

    from deepspeed_tpu_torch.parallel import topology
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    if device.type == "cuda":
        for mod in _counted():          # the parent's build, loaded
            mod.build()
    topology.init_distributed(coordinator_address=spec["coordinator"],
                              num_processes=world, process_id=rank,
                              device=device, backend="gloo")
    return spec, device


def _child_run(eng, batch, steps, device, save_dir=None, save_at=None):
    """``steps`` train_batch steps of ``eng`` on ``batch`` (this rank's
    rows), saved after step ``save_at``; losses, step ms, the launches,
    the peak and the state digest (and the save's files and seconds)."""
    losses, step_ms, extra = [], [], {}
    sync(device)
    _reset_peak(device)
    reset_launch_counts()
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)))
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if save_dir is not None and step == save_at:
            extra["digest_at_save"] = _z3_digest(eng)
            t0 = time.perf_counter()
            path = eng.save_checkpoint(save_dir)
            extra["save_s"] = time.perf_counter() - t0
            extra["files"] = {f: os.path.getsize(os.path.join(path, f))
                              for f in sorted(os.listdir(path))}
    return {"losses": losses, "step_ms": step_ms,
            "launches": launch_counts(), "peak_mem_gib": _peak_gib(device),
            "digest": _z3_digest(eng), "leaves": len(eng._params), **extra}


def _child_finish(spec_path, spec, out, t_start, device):
    import torch.distributed as dist
    free(device)
    out["seconds"] = time.perf_counter() - t_start
    (pathlib.Path(spec_path).parent / f"{spec['mode']}_{out['rank']}.json"
     ).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def sp_child(spec_path, rank):
    """One seq rank of the sp_gpt2 phase (started by ``phase_sp_gpt2``):
    mode "train" runs (a) the ring, saved after step SP_SAVE_AT, and (b)
    Ulysses; mode "resume" runs (c), the resume of (a)'s save.  Writes
    ``<mode>_<rank>.json`` beside the spec."""
    import torch.distributed as dist
    spec, device = _child_setup(spec_path, rank, SP)
    out = {"rank": rank, "backend": dist.get_backend()}
    t_start = time.perf_counter()
    size, micro = spec["size"], spec["micro"]

    def engine(impl, seed=0):
        return make_engine(sp_config(micro, impl), device, size=size,
                           seed=seed, gpt2=True, max_seq_len=spec["seq"],
                           **_depth(spec["layers"]))

    with deterministic():
        if spec["mode"] == "train":
            for name, impl, steps, save in (
                    ("a", "ring", GPT2_STEPS, spec["ckpt"]),
                    ("b", "ulysses", SP_SHORT_STEPS, None)):
                eng = engine(impl)
                batch = lm_batch(micro * GAS, spec["seq"],
                                 eng.module.config.vocab_size)
                out[name] = dict(
                    _child_run(eng, batch, steps, device, save, SP_SAVE_AT),
                    sp_rank=eng.sp_rank, heads=eng.module.config.num_heads,
                    layers=eng.module.config.num_layers)
                del eng, batch
                free(device)
        else:
            eng = engine("ring", seed=1)
            batch = lm_batch(micro * GAS, spec["seq"],
                             eng.module.config.vocab_size)
            t0 = time.perf_counter()
            eng.load_checkpoint(spec["ckpt"])
            sync(device)
            load_s = time.perf_counter() - t0
            out["c"] = dict(_child_run(eng, batch, GPT2_STEPS - SP_SAVE_AT,
                                       device), load_s=load_s)
            del eng
    return _child_finish(spec_path, spec, out, t_start, device)


def phase_sp_gpt2(device, sp1_losses, size="medium", micro=GPT2_1024_MICRO,
                  seq=GPT2_1024_SEQ, layers=None):
    """GPT-2 medium at seq 1024, sp 2, on two processes over gloo (see
    SP): (a) ring attention, 6 steps, saved after step 3; (b) Ulysses, 3
    steps; each within SP_LOSS_RTOL of ``sp1_losses`` (train_gpt2_1024's,
    the same weights and batch at sp 1) and of each other; (c) fresh
    processes resume (a)'s save, bitwise equal to its steps 4-6.  Then this
    process loads the save at sp 1 and saves it again: the same files, of
    the same sizes.  Launches exact per rank: the ring is plain tensor
    ops (no attention kernel), Ulysses runs the streaming forward and the
    split pair once per layer and micro-step.  Returns the launches by run
    and rank."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="sp_gpt2_",
                                         dir=ROOT / "build"))
    run = {"device": str(device), "ckpt": str(work / "ckpt"), "size": size,
           "micro": micro, "seq": seq, "layers": layers}
    try:
        tr = _tp_launch(work, "train", run, flag="--sp-child", world=SP)
        rs = _tp_launch(work, "resume", run, flag="--sp-child", world=SP)
        # the sp 2 save into one process at sp 1, saved again there
        eng = make_engine(gpt2_config(micro), device, size=size, seed=2,
                          gpt2=True, max_seq_len=seq, **_depth(layers))
        t0 = time.perf_counter()
        eng.load_checkpoint(run["ckpt"])
        sync(device)
        sp1_load_s = time.perf_counter() - t0
        batch = lm_batch(micro * GAS, seq, eng.module.config.vocab_size)
        path = eng.save_checkpoint(str(work / "sp1"))
        sp1_files = {f: os.path.getsize(os.path.join(path, f))
                     for f in sorted(os.listdir(path))}
        sp1_next = float(eng.train_batch(batch))
        del eng, batch
        free(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    runs = {k: [r[k] for r in tr] for k in ("a", "b")}
    runs["c"] = [r["c"] for r in rs]
    a, b = runs["a"], runs["b"]
    short, rest = SP_SHORT_STEPS, GPT2_STEPS - SP_SAVE_AT
    per_step = a[0]["layers"] * GAS            # layers x micro-steps
    leaves = a[0]["leaves"]
    G = micro * a[0]["heads"] // SP            # Ulysses' local heads
    expect = {"a": no_launches(adam=leaves * GPT2_STEPS),
              "b": no_launches(adam=leaves * short,
                               stream_fwd=per_step * short,
                               **auto_bwd_launches(torch.bfloat16, G, seq,
                                                   64, per_step * short)),
              "c": no_launches(adam=leaves * rest)}
    rel = lambda x, y: [abs(p - q) / abs(q) for p, q in zip(x, y)]
    gaps = {"a_vs_sp1": rel(a[0]["losses"], sp1_losses),
            "b_vs_sp1": rel(b[0]["losses"], sp1_losses[:short]),
            "b_vs_a": rel(b[0]["losses"], a[0]["losses"][:short]),
            "sp1_load_vs_a": rel([sp1_next], a[0]["losses"][SP_SAVE_AT:])}
    files = a[0]["files"]
    checks = {
        "seq_ranks": [r["sp_rank"] for r in a] == list(range(SP)),
        "losses_equal_across_ranks": all(
            rr[0]["losses"] == r["losses"] for rr in runs.values()
            for r in rr),
        "within_rtol": all(max(g) <= SP_LOSS_RTOL for g in gaps.values()),
        "resume_bitwise": all(
            c["losses"] == x["losses"][SP_SAVE_AT:]
            and c["digest"] == x["digest"] for c, x in zip(runs["c"], a)),
        "save_is_the_sp1_save": files == sp1_files
        and list(files) == ["mp_rank_00_model_states.pt"],
        "finite": all(np.isfinite(r["losses"]).all()
                      for rr in runs.values() for r in rr),
        "launches": all(r["launches"] == expect[k] for k, rr in runs.items()
                        for r in rr),
    }
    steady = lambda ms: (micro * GAS * (len(ms) - 1) / (sum(ms[1:]) / 1e3))
    emit("sp_gpt2", model=f"gpt2-{size}", sp=SP, dp=1, seq=seq,
         tokens_per_rank=seq // SP, micro_batch=micro, gas=GAS,
         dtype="bf16", optimizer="Adam", lr=1e-4,
         impls={"a": "ring", "b": "ulysses", "c": "ring (resumed)"},
         backend=tr[0]["backend"],
         transport="gloo over the host (not NVLink)",
         losses={k: rr[0]["losses"] for k, rr in runs.items()},
         train_gpt2_1024=sp1_losses, rel_gaps=gaps, sp1_load_next=sp1_next,
         launches={k: [r["launches"] for r in rr] for k, rr in runs.items()},
         expected_launches=expect,
         peak_mem_gib={k: [r["peak_mem_gib"] for r in rr]
                       for k, rr in runs.items()},
         step_ms_over_gloo={k: [r["step_ms"] for r in rr]
                            for k, rr in runs.items()},
         median_step_ms={k: statistics.median(rr[0]["step_ms"][1:])
                         for k, rr in runs.items()},
         samples_per_s_steady={k: steady(rr[0]["step_ms"])
                               for k, rr in runs.items()},
         ckpt_files=files, sp1_files=sp1_files,
         save_s=[r["save_s"] for r in a if "save_s" in r],
         load_s=[r["load_s"] for r in runs["c"]], sp1_load_s=sp1_load_s,
         child_seconds=[r["seconds"] for r in tr + rs], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"sp_gpt2 phase failed: {checks}")
    return {k: [r["launches"] for r in rr] for k, rr in runs.items()}


# the zero3_pp_gpt2 phase: GPT-2 medium at seq 128 under ZeRO-3 at dp 2 x
# pp 2 (EARLY_LAYERS / 2 layers a stage), as four child processes on the
# one card over gloo groups (every gather, reduce-scatter, activation and
# gradient stages through the host: the step times are not NVLink's).
# train_gpt2's (and pp_gpt2's) seed-0 weights and 64-row batch: each data
# rank takes its 32 rows as micro-batch 16 x gas 2, streamed as 4 pipeline
# micro-batches of 4 rows (the rows pp_gpt2 streams), so the head is
# sharded over the stages.
Z3PP_DP, Z3PP_MICRO, Z3PP_SAVE_AT = 2, 16, 2
Z3PP_STEPS, Z3PP_SHORT_STEPS = 4, 3
Z3PP_MICRO_BATCHES = Z3PP_MICRO // 4
# (a) against train_gpt2 (ZeRO off, pp 1, dp 1, the same weights, depth and
# batch, the reference pp_gpt2 (a) is held to at its own depth): the
# gradients reduce-scatter in bf16 before their fp32 sum, the micro-batches
# stream through two stages
Z3PP_LOSS_RTOL = 2e-2
# (b) 1F1B against (a) GPipe: the micro-batches' gradients add in another
# order
Z3PP_1F1B_RTOL = 1e-2


def z3pp_child(spec_path, rank):
    """One rank of the zero3_pp_gpt2 phase (started by
    ``phase_zero3_pp_gpt2``): mode "train" runs (a) GPipe, saved after
    step Z3PP_SAVE_AT, and (b) 1F1B; mode "resume" runs (c), the resume of
    (a)'s save.  Writes ``<mode>_<rank>.json`` beside the spec."""
    import math

    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2Pipelined
    world = Z3PP_DP * PP
    spec, device = _child_setup(spec_path, rank, world)
    out = {"rank": rank, "backend": dist.get_backend()}
    t_start = time.perf_counter()
    size, micro = spec["size"], spec["micro"]

    def engine(schedule, seed=0):
        cfg = z3_config(micro, GAS, Z3PP_DP, Z3_BASE)
        cfg["pipeline_parallel_size"] = PP
        cfg["pipeline_schedule"] = schedule
        gen = torch.Generator(device=device).manual_seed(seed)
        model = GPT2Pipelined.from_size(
            size, num_micro_batches=Z3PP_MICRO_BATCHES, generator=gen,
            device=device, **_depth(spec["layers"]))
        return deepspeed_tpu_torch.initialize(config=cfg, model=model,
                                              device=device)[0]

    def run(eng, steps, save=None):
        toks, labels = lm_batch(micro * GAS * Z3PP_DP, GPT2_SEQ,
                                eng.module.config.vocab_size)
        dpr = eng.topology.dp_rank
        rows = slice(dpr * micro * GAS, (dpr + 1) * micro * GAS)
        res = _child_run(eng, (toks[rows], labels[rows]), steps, device,
                         save, Z3PP_SAVE_AT)
        dims, shapes = eng._zero3_dims, eng._global_shapes
        # the stage's whole leaf: the block stacks cut over the pipe group
        stage = {k: math.prod(s) // (PP if k.startswith("blocks.") else 1)
                 for k, s in shapes.items()}
        res.update(
            coords=[dpr, eng.pp_rank],
            layers=int(eng.module.blocks.qkv_w.shape[0]),
            partitioned=sum(d >= 0 for d in dims.values()),
            half_of_stage=all(
                eng.master[k].numel() * Z3PP_DP == stage[k]
                for k, d in dims.items() if d >= 0),
            held=eng.module.last_pipe_stats.get("max_held_inputs"))
        return res

    with deterministic():
        if spec["mode"] == "train":
            for name, schedule, steps, save in (
                    ("a", "gpipe", Z3PP_STEPS, spec["ckpt"]),
                    ("b", "1f1b", Z3PP_SHORT_STEPS, None)):
                eng = engine(schedule)
                out[name] = run(eng, steps, save)
                del eng
                free(device)
        else:
            eng = engine("gpipe", seed=1)
            t0 = time.perf_counter()
            eng.load_checkpoint(spec["ckpt"])
            sync(device)
            load_s = time.perf_counter() - t0
            out["c"] = dict(run(eng, Z3PP_STEPS - Z3PP_SAVE_AT),
                            load_s=load_s)
            del eng
    return _child_finish(spec_path, spec, out, t_start, device)


def phase_zero3_pp_gpt2(device, ref_losses, size="medium",
                        micro=Z3PP_MICRO, layers=None):
    """GPT-2 medium under ZeRO-3 at dp 2 x pp 2 on four processes over
    gloo (see Z3PP_DP): (a) GPipe, 4 steps, saved after step 2, within
    Z3PP_LOSS_RTOL of ``ref_losses`` (gpt2_reference's at ``layers``:
    ZeRO off at pp 1 and dp 1, the same weights and batch), (b) 1F1B, 3
    steps, within
    Z3PP_1F1B_RTOL of
    (a); (c) fresh processes resume (a)'s save, bitwise equal to (a)'s
    steps 3-4.  Each rank holds half of its stage's partitioned leaves;
    the shard files are keyed by the row ``pp_stage * mp + mp_rank``.
    Launches exact per rank.  Returns the launches by run and rank."""
    import shutil
    import tempfile

    import numpy as np

    from deepspeed_tpu_torch import checkpoint as ck
    world = Z3PP_DP * PP
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="zero3_pp_gpt2_",
                                         dir=ROOT / "build"))
    run = {"device": str(device), "ckpt": str(work / "ckpt"), "size": size,
           "micro": micro, "layers": layers}
    try:
        tr = _tp_launch(work, "train", run, flag="--z3pp-child", world=world)
        tag = f"global_step{Z3PP_SAVE_AT}"
        rows = {f: int(ck._load_obj(os.path.join(run["ckpt"], tag, f))["row"])
                for f in sorted(os.listdir(os.path.join(run["ckpt"], tag)))
                if f.startswith("zero3_dp_rank_")}
        rs = _tp_launch(work, "resume", run, flag="--z3pp-child",
                        world=world)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    runs = {k: [r[k] for r in tr] for k in ("a", "b")}
    runs["c"] = [r["c"] for r in rs]
    a = runs["a"]
    short, rest = Z3PP_SHORT_STEPS, Z3PP_STEPS - Z3PP_SAVE_AT
    # per step and rank: the stage's layers x pipeline micro-batches x gas
    blk = a[0]["layers"] * Z3PP_MICRO_BATCHES * GAS
    leaves = a[0]["leaves"]

    def launches(steps, fwd=blk):
        return no_launches(adam=leaves * steps, block_fwd=fwd * steps,
                           block_bwd=blk * steps)
    last = [r["coords"][1] == PP - 1 for r in a]
    expect = {"a": [launches(Z3PP_STEPS)] * world,
              # 1F1B replays each micro-batch's forward for its backward,
              # except on the last stage
              "b": [launches(short, blk if is_last else 2 * blk)
                    for is_last in last],
              "c": [launches(rest)] * world}
    rel = lambda x, y: [abs(p - q) / abs(q) for p, q in zip(x, y)]
    mean = lambda rr: [float(x) for x in np.mean(
        [r["losses"] for r in rr if r["coords"][1] == 0], axis=0)]
    gap = rel(mean(a), ref_losses[:Z3PP_STEPS])
    f1b_gap = rel(mean(runs["b"]), mean(a)[:short])
    files = a[0]["files"]
    checks = {
        "coords": sorted(tuple(r["coords"]) for r in a) == [
            (d, s) for d in range(Z3PP_DP) for s in range(PP)],
        "losses_equal_across_stages": all(
            r["losses"] == x["losses"] for rr in runs.values() for r in rr
            for x in rr if x["coords"][0] == r["coords"][0]),
        "a_vs_train_gpt2": max(gap) <= Z3PP_LOSS_RTOL,
        "1f1b_vs_a": max(f1b_gap) <= Z3PP_1F1B_RTOL,
        "half_of_each_stage": all(r["half_of_stage"] and r["partitioned"]
                                  == leaves for r in a),
        "resume_bitwise": all(
            c["losses"] == x["losses"][Z3PP_SAVE_AT:]
            and c["digest"] == x["digest"] for c, x in zip(runs["c"], a)),
        "shard_rows": rows == {
            f"zero3_dp_rank_{d}_row_{s:02d}_states.pt": s
            for d in range(Z3PP_DP) for s in range(PP)},
        "model_files": sorted(f for f in files if f.endswith(
            "_model_states.pt")) == [
            f"pp_stage_{s:02d}_mp_rank_00_model_states.pt"
            for s in range(PP)],
        "finite": all(np.isfinite(r["losses"]).all()
                      for rr in runs.values() for r in rr),
        "launches": all(r["launches"] == want for k, rr in runs.items()
                        for r, want in zip(rr, expect[k])),
    }
    steady = lambda ms: (micro * GAS * Z3PP_DP * (len(ms) - 1)
                         / (sum(ms[1:]) / 1e3))
    emit("zero3_pp_gpt2", model=f"gpt2-{size}", dp=Z3PP_DP, pp=PP,
         seq=GPT2_SEQ, micro_batch_per_rank=micro, gas=GAS,
         pipeline_micro_batches=Z3PP_MICRO_BATCHES, dtype="bf16",
         optimizer="Adam", lr=1e-4, backend=tr[0]["backend"],
         transport="gloo over the host (not NVLink)",
         losses={k: mean(rr) for k, rr in runs.items()},
         train_gpt2=ref_losses[:Z3PP_STEPS], a_vs_train_gpt2_rel=gap,
         b_vs_a_rel=f1b_gap,
         launches={k: [r["launches"] for r in rr] for k, rr in runs.items()},
         expected_launches=expect,
         coords=[r["coords"] for r in a],
         held_inputs=[r["held"] for r in runs["b"]],
         peak_mem_gib={k: [r["peak_mem_gib"] for r in rr]
                       for k, rr in runs.items()},
         step_ms_over_gloo={k: [r["step_ms"] for r in rr]
                            for k, rr in runs.items()},
         median_step_ms={k: statistics.median(rr[0]["step_ms"][1:])
                         for k, rr in runs.items()},
         samples_per_s_steady={k: steady(rr[0]["step_ms"])
                               for k, rr in runs.items()},
         ckpt_files=files, shard_rows=rows,
         save_s=[r["save_s"] for r in a if "save_s" in r],
         load_s=[r["load_s"] for r in runs["c"]],
         child_seconds=[r["seconds"] for r in tr + rs], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"zero3_pp_gpt2 phase failed: {checks}")
    return {k: [r["launches"] for r in rr] for k, rr in runs.items()}


# the moe_gpt2 phase: GPT-2 medium with 8 experts a layer (GPT2MoE, the
# JAX gpt2_moe.py: top-1 Switch routing at capacity 1.25), seq 128, bf16,
# Adam lr 1e-4, micro-batch 16, gas 2, from seeded weights and batch.
# (a) top-1 at its full 24 layers, (b) top-2, (c) moe_reference: (a) at
# MID_LAYERS, (d) the 12-layer model at ep 2 (mp 2) as two child
# processes on the one card over gloo, ZeRO-1, saved after step 3, (e)
# fresh processes resume (d)'s save
MOE_EXPERTS, MOE_MICRO, MOE_SAVE_AT, MOE_TOP2_STEPS, MOE_EP = 8, 16, 3, 3, 2
MOE_ZERO = {"stage": 1, "overlap_comm": False}
# (d) at ep 2 against (c) at ep 1: the same routing, the combine's two
# partial sums and the row-parallel products rounded to bf16 before their
# sum, which (c) does not do (tp_gpt2's limit)
MOE_EP_RTOL = 2e-2
# bytes a save of the ep 2 model takes per parameter: the bf16 module and
# the fp32 master and two moments, with a margin
MOE_SAVE_BYTES_PER_PARAM = 14 * 1.25


def moe_engine(device, top_k=1, seed=0, layers=None, zero=None, mp=1,
               micro=MOE_MICRO, size="medium"):
    """GPT-2 medium MoE (``layers`` deep) from ``seed`` through
    ``initialize``; its model records each forward's weighted aux term in
    ``aux_terms``."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2MoE

    class RecordedMoE(GPT2MoE):
        aux_terms = []

        def _stack(self, x, blocks, z3_dims=None):
            x, aux = super()._stack(x, blocks, z3_dims)
            self.aux_terms.append(aux.detach())
            return x, aux

    gen = torch.Generator(device=device).manual_seed(seed)
    model = RecordedMoE.from_size(size, num_experts=MOE_EXPERTS,
                                  router_top_k=top_k, generator=gen,
                                  device=device, **_depth(layers))
    cfg = gpt2_config(micro)
    if zero is not None:
        cfg["zero_optimization"] = zero
    mesh = (deepspeed_tpu_torch.MeshConfig(model_parallel_size=mp)
            if mp > 1 else None)
    return deepspeed_tpu_torch.initialize(config=cfg, model=model,
                                          device=device, mesh=mesh)[0]


def _moe_run(eng, batch, steps, device):
    """``steps`` train_batch steps: losses, step ms, the weighted aux term
    of each step's last micro-step, launches, peak."""
    losses, step_ms, aux = [], [], []
    sync(device)
    _reset_peak(device)
    reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)))
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        aux.append(float(eng.module.aux_terms[-1]))
        eng.module.aux_terms.clear()
    return {"losses": losses, "step_ms": step_ms, "aux": aux,
            "launches": launch_counts(), "peak_mem_gib": _peak_gib(device)}


def moe_child(spec_path, rank):
    """One rank of moe_gpt2's ep 2 runs (started by ``phase_moe_gpt2``):
    mode "train" runs (d), saved after step MOE_SAVE_AT; mode "resume" runs
    (e).  Writes ``<mode>_<rank>.json`` beside the spec."""
    import torch.distributed as dist
    spec, device = _child_setup(spec_path, rank, MOE_EP)
    out = {"rank": rank, "backend": dist.get_backend()}
    t_start = time.perf_counter()
    with deterministic():
        if spec["mode"] == "train":
            eng = moe_engine(device, layers=spec["layers"], zero=MOE_ZERO,
                             mp=MOE_EP, micro=spec["micro"],
                             size=spec["size"])
            batch = lm_batch(spec["micro"] * GAS, GPT2_SEQ,
                             eng.module.config.vocab_size)
            out["d"] = dict(
                _child_run(eng, batch, GPT2_STEPS, device, spec["ckpt"],
                           MOE_SAVE_AT),
                local_params=eng.num_parameters(),
                local_experts=eng.module.blocks.exp1_w.shape[1],
                expert_leaf=list(eng.module.blocks.exp1_w.shape))
        else:
            eng = moe_engine(device, seed=1, layers=spec["layers"],
                             zero=MOE_ZERO, mp=MOE_EP, micro=spec["micro"],
                             size=spec["size"])
            batch = lm_batch(spec["micro"] * GAS, GPT2_SEQ,
                             eng.module.config.vocab_size)
            t0 = time.perf_counter()
            eng.load_checkpoint(spec["ckpt"])
            sync(device)
            load_s = time.perf_counter() - t0
            out["e"] = dict(_child_run(eng, batch, GPT2_STEPS - MOE_SAVE_AT,
                                       device), load_s=load_s)
        del eng
    return _child_finish(spec_path, spec, out, t_start, device)


def _expert_leaf_adam(engine, device):
    """The Adam kernel on the MoE's largest leaf (``blocks.exp1_w``, [L, E,
    h, 4h]) against ``adam_plain`` on the engine's master and moments and
    seeded grads; times and the bound (bytes at HBM_BYTES_PER_S)."""
    import torch

    from deepspeed_tpu_torch.ops import cuda_optim
    opt, st = engine.base_optimizer, engine.opt_state
    name = "blocks.exp1_w"
    p0 = engine.master[name]
    n = p0.numel()
    gen = torch.Generator(device=device).manual_seed(7)
    g = torch.randn(p0.shape, generator=gen, device=device) * 1e-3
    ss = opt._step_size(opt.lr, st.step + 1, opt.beta1, opt.beta2)
    scal = cuda_optim.make_scalars(
        [(opt.beta1, opt.beta2, ss, opt.weight_decay, opt.lr)],
        torch.tensor(1.0, device=device), device)[0]
    kw = dict(eps=opt.eps, eps_inside_sqrt=opt.eps_inside_sqrt,
              decoupled=opt.decoupled_decay)
    kst = [p0.clone(), st.m[name].clone(), st.v[name].clone()]
    cuda_optim.fused_adam_update(kst[0], g, kst[1], kst[2], scal, **kw)
    sync(device)
    pst = [p0.clone(), st.m[name].clone(), st.v[name].clone()]
    cuda_optim.adam_plain(pst[0], g, pst[1], pst[2], scal, **kw)
    sync(device)
    errs = {o: _max_err([a], [b]) for o, a, b in zip("pmv", kst, pst)}
    del pst
    p, m, v = kst

    def kernel():
        cuda_optim.fused_adam_update(p, g, m, v, scal, **kw)

    def plain():
        cuda_optim.adam_plain(p, g, m, v, scal, **kw)

    ms = plain_ms = None            # a CPU rehearsal times nothing
    if device.type == "cuda":
        ms = min(_time_ms(kernel, device, calls=5, reps=3),
                 _time_ms(kernel, device, calls=5, reps=3))
        plain_ms = _time_ms(plain, device, calls=2, reps=3)
    del kst, p, m, v, g
    free(device)
    return {"leaf": name, "shape": list(p0.shape), "elements": n,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": _bound_ms("adam", n),
            "bound_by": "bytes",
            "max_abs_err": max(e[0] for e in errs.values()),
            "errors": {o: {"max_abs": e[0], "max_rel": e[1], "ok": e[2]}
                       for o, e in errs.items()},
            "ok": all(e[2] for e in errs.values())}


def phase_moe_gpt2(device, size="medium", micro=MOE_MICRO, layers=None,
                   ep_layers=MID_LAYERS):
    """GPT-2 ``size`` with 8 experts (see MOE_EXPERTS): (a) top-1 at
    ``layers`` (None: all of them), 6 steps, with the expert leaf's Adam
    check; (b) top-2, 3 steps; (c) moe_reference at ``ep_layers``; (d),
    (e) at ep 2 in child processes.  Returns the launches of each run and
    the expert leaf's check.  ``phase_moe_gpt2(torch.device("cpu"),
    size="tiny", micro=2, ep_layers=2)`` rehearses it on the CPU (the
    kernel checks fail there by design)."""
    import shutil
    import tempfile

    import numpy as np

    kw = dict(micro=micro, size=size)
    # (a) top-1 at full depth
    eng = moe_engine(device, layers=layers, **kw)
    cfg = eng.module.config
    batch = lm_batch(micro * GAS, GPT2_SEQ, cfg.vocab_size)
    leaves = len(eng.master)
    a = dict(_moe_run(eng, batch, GPT2_STEPS, device),
             params=eng.num_parameters(), leaves=leaves,
             layers=cfg.num_layers)
    leaf = _expert_leaf_adam(eng, device)
    del eng
    free(device)
    # (b) top-2
    eng = moe_engine(device, top_k=2, layers=layers, **kw)
    b = _moe_run(eng, batch, MOE_TOP2_STEPS, device)
    del eng
    free(device)
    # (c) moe_reference: top-1 at the ep 2 runs' depth
    eng = moe_engine(device, layers=ep_layers, **kw)
    c = dict(_moe_run(eng, batch, GPT2_STEPS, device),
             params=eng.num_parameters())
    del eng
    free(device)

    (ROOT / "build").mkdir(exist_ok=True)
    need = c["params"] * MOE_SAVE_BYTES_PER_PARAM
    have = shutil.disk_usage(ROOT / "build").free
    if have < need:
        raise AssertionError(f"moe_gpt2: build/ has {have} bytes free, the "
                             f"ep 2 save needs about {need:.0f}")
    work = pathlib.Path(tempfile.mkdtemp(prefix="moe_gpt2_",
                                         dir=ROOT / "build"))
    run = {"device": str(device), "ckpt": str(work / "ckpt"),
           "layers": ep_layers, **kw}
    try:
        tr = _tp_launch(work, "train", run, flag="--moe-child",
                        world=MOE_EP)
        rs = _tp_launch(work, "resume", run, flag="--moe-child",
                        world=MOE_EP)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d, e = [r["d"] for r in tr], [r["e"] for r in rs]

    def attn(nl, steps):
        return nl * GAS * steps
    rest = GPT2_STEPS - MOE_SAVE_AT
    expect = {
        "a": no_launches(adam=leaves * GPT2_STEPS,
                         block_fwd=attn(a["layers"], GPT2_STEPS),
                         block_bwd=attn(a["layers"], GPT2_STEPS)),
        "b": no_launches(adam=leaves * MOE_TOP2_STEPS,
                         block_fwd=attn(a["layers"], MOE_TOP2_STEPS),
                         block_bwd=attn(a["layers"], MOE_TOP2_STEPS)),
        "c": no_launches(adam=leaves * GPT2_STEPS,
                         block_fwd=attn(ep_layers, GPT2_STEPS),
                         block_bwd=attn(ep_layers, GPT2_STEPS)),
        # ZeRO-1 with overlap off: one flat launch a step
        "d": no_launches(adam=GPT2_STEPS,
                         block_fwd=attn(ep_layers, GPT2_STEPS),
                         block_bwd=attn(ep_layers, GPT2_STEPS)),
        "e": no_launches(adam=rest, block_fwd=attn(ep_layers, rest),
                         block_bwd=attn(ep_layers, rest))}
    gap = [abs(x - y) / abs(y) for x, y in zip(d[0]["losses"], c["losses"])]
    checks = {
        "finite": all(np.isfinite(r["losses"]).all() and
                      np.isfinite(r["aux"]).all() for r in (a, b, c)),
        "expert_leaf_adam": leaf["ok"],
        "ep2_losses_equal_across_ranks": d[0]["losses"] == d[1]["losses"]
        and e[0]["losses"] == e[1]["losses"],
        "ep2_vs_ep1": max(gap) <= MOE_EP_RTOL,
        "four_experts_a_rank": all(r["local_experts"] == MOE_EXPERTS
                                   // MOE_EP for r in d),
        "resume_bitwise": all(
            z["losses"] == y["losses"][MOE_SAVE_AT:]
            and z["digest"] == y["digest"] for z, y in zip(e, d)),
        "launches": all(r["launches"] == expect[k] for k, r in
                        (("a", a), ("b", b), ("c", c)))
        and all(r["launches"] == expect["d"] for r in d)
        and all(r["launches"] == expect["e"] for r in e)}
    emit("moe_gpt2", model=f"gpt2-{size}-moe", experts=MOE_EXPERTS,
         capacity_factor=1.25, aux_weight=0.01, seq=GPT2_SEQ,
         micro_batch=micro, gas=GAS, dtype="bf16", optimizer="Adam",
         lr=1e-4, params=a["params"], leaves=leaves, layers=a["layers"],
         ep_layers=ep_layers, ep=MOE_EP, ep_zero=MOE_ZERO,
         ep_transport="gloo over the host (not NVLink)",
         ep_local_params=d[0]["local_params"],
         ep_expert_leaf=d[0]["expert_leaf"],
         losses={"a_top1": a["losses"], "b_top2": b["losses"],
                 "c_reference": c["losses"], "d_ep2": d[0]["losses"],
                 "e_resumed": e[0]["losses"]},
         aux_weighted={"a_top1": a["aux"], "b_top2": b["aux"],
                       "c_reference": c["aux"]},
         ep2_vs_ep1_rel=gap, step_ms={"a_top1": a["step_ms"],
                                      "b_top2": b["step_ms"],
                                      "c_reference": c["step_ms"]},
         step_ms_over_gloo={"d": [r["step_ms"] for r in d],
                            "e": [r["step_ms"] for r in e]},
         samples_per_s_steady={
             k: micro * GAS * (len(r["step_ms"]) - 1)
             / (sum(r["step_ms"][1:]) / 1e3)
             for k, r in (("a_top1", a), ("b_top2", b), ("c_reference", c))},
         peak_mem_gib={"a_top1": a["peak_mem_gib"],
                       "b_top2": b["peak_mem_gib"],
                       "c_reference": c["peak_mem_gib"],
                       "d": [r["peak_mem_gib"] for r in d],
                       "e": [r["peak_mem_gib"] for r in e]},
         ckpt_files=d[0]["files"], save_s=[r["save_s"] for r in d],
         load_s=[r["load_s"] for r in e], expert_leaf_adam=leaf,
         launches={"a": a["launches"], "b": b["launches"],
                   "c": c["launches"], "d": [r["launches"] for r in d],
                   "e": [r["launches"] for r in e]},
         expected_launches=expect,
         child_seconds=[r["seconds"] for r in tr + rs], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"moe_gpt2 phase failed: {checks}")
    return {"launches": {"a": a["launches"], "b": b["launches"],
                         "c": c["launches"],
                         "d": [r["launches"] for r in d],
                         "e": [r["launches"] for r in e]},
            "expert_leaf": leaf}


# the multistep_gpt2 phase: GPT-2 medium at MID_LAYERS, seq 128, under the
# deterministic flag; MULTI_BLOCKS blocks of MULTI_K batches as train_batch
# calls and as train_many blocks fed by BlockPrefetcher(place=...), in bf16
# and in fp16 with a chaos non-finite loss at step 2 (skipped both ways).
# The step times are the last block's: the first carries the warm-up.
MULTI_K, MULTI_BLOCKS = 4, 2


def chaos_gpt2_engine(device, cfg, layers, seed=0, size="medium"):
    """GPT-2 medium whose batch carries a float ``poison`` leaf [rows]: the
    loss is multiplied by ``1 + mean(poison)`` (exactly the loss for zeros;
    NaN everywhere once ``chaos.poison_batch`` fills it with NaN)."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2

    class ChaosGPT2(GPT2):
        def forward(self, tokens, labels, poison):
            loss = super().forward(tokens, labels)
            return loss * (1.0 + poison.float().mean())

    gen = torch.Generator(device=device).manual_seed(seed)
    model = ChaosGPT2.from_size(size, generator=gen, device=device,
                                **_depth(layers))
    return deepspeed_tpu_torch.initialize(config=cfg, model=model,
                                          device=device)[0]


def phase_multistep_gpt2(device, size="medium", micro=MICRO,
                         layers=MID_LAYERS):
    """(a) MULTI_BLOCKS x MULTI_K train_batch calls and (b) as many
    train_many blocks of the same batches (BlockPrefetcher staging them to
    the device), bitwise equal; (c) the same in fp16 with a NaN loss at
    step 2 (one skip both ways).  Returns the launches of each run.
    ``phase_multistep_gpt2(torch.device("cpu"), size="tiny", micro=2,
    layers=2)`` rehearses it on the CPU (the launch check fails there by
    design)."""
    import numpy as np

    from deepspeed_tpu_torch.data import BlockPrefetcher, device_placer
    from deepspeed_tpu_torch.resilience import chaos
    rows, n = micro * GAS, MULTI_K * MULTI_BLOCKS

    def batches(vocab):
        out = []
        for i in range(n):
            toks, labels = lm_batch(rows, GPT2_SEQ, vocab, seed=10 + i)
            out.append((toks, labels, np.zeros(rows, np.float32)))
        return out

    def serial(eng, bs):
        sync(device)
        reset_launch_counts()
        losses, step_ms = [], []
        for b in bs:
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(b)))
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"losses": losses, "step_ms": step_ms,
                "last_block_step_ms": sum(step_ms[-MULTI_K:]) / MULTI_K,
                "launches": launch_counts()}

    def blocks(eng, bs):
        sync(device)
        reset_launch_counts()
        block_ms, last = [], None
        t0 = time.perf_counter()
        for blk in BlockPrefetcher(iter(bs), MULTI_K,
                                   place=device_placer(device)):
            last = float(eng.train_many(blk))
            sync(device)
            t1 = time.perf_counter()
            block_ms.append((t1 - t0) * 1e3)
            t0 = t1
        return {"last_loss": last, "block_ms": block_ms,
                "last_block_step_ms": block_ms[-1] / MULTI_K,
                "launches": launch_counts()}

    def state(eng):
        ls = eng.loss_scale_state
        return {"digest": _z3_digest(eng), "step": eng.opt_state.step,
                "global_steps": eng.global_steps,
                "skipped": eng.skipped_steps,
                "loss_scale": float(ls.cur_scale)}

    out = {}
    with deterministic():
        for prec_name in ("bf16", "fp16"):
            cfg = gpt2_config(micro)
            if prec_name == "fp16":
                cfg.pop("bf16")
                # 2^16: the default 2^32 overflows the first boundaries
                cfg["fp16"] = {"enabled": True, "initial_scale_power": 16}
            eng = chaos_gpt2_engine(device, cfg, layers, size=size)
            bs = batches(eng.module.config.vocab_size)
            if prec_name == "fp16":
                bs[1] = chaos.poison_batch(bs[1])   # a NaN loss at step 2
            leaves = len(eng.master)
            s = dict(serial(eng, bs), **state(eng))
            del eng
            free(device)
            eng = chaos_gpt2_engine(device, cfg, layers, size=size)
            m = dict(blocks(eng, bs), **state(eng))
            del eng
            free(device)
            out[prec_name] = (s, m)
    attn = layers * GAS * n
    (sb, mb), (sf, mf) = out["bf16"], out["fp16"]
    # fp16: the skipped boundary launches no Adam, in either run
    expect = {"bf16_serial": no_launches(adam=leaves * n, block_fwd=attn,
                                         block_bwd=attn),
              "bf16_block": no_launches(adam=leaves * n, block_fwd=attn,
                                        block_bwd=attn),
              "fp16_serial": no_launches(adam=leaves * (n - 1),
                                         block_fwd=attn, block_bwd=attn),
              "fp16_block": no_launches(adam=leaves * (n - 1),
                                        block_fwd=attn, block_bwd=attn)}
    got = {"bf16_serial": sb["launches"], "bf16_block": mb["launches"],
           "fp16_serial": sf["launches"], "fp16_block": mf["launches"]}
    keys = ("digest", "step", "global_steps", "skipped", "loss_scale")
    checks = {
        "bf16_bitwise": all(sb[k] == mb[k] for k in keys)
        and sb["losses"][-1] == mb["last_loss"],
        "fp16_bitwise": all(sf[k] == mf[k] for k in keys)
        and sf["losses"][-1] == mf["last_loss"],
        "fp16_one_skip": sf["skipped"] == mf["skipped"] == 1,
        "launches": got == expect}
    emit("multistep_gpt2", model=f"gpt2-{size}", layers=layers,
         seq=GPT2_SEQ, micro_batch=micro, gas=GAS, k=MULTI_K,
         blocks=MULTI_BLOCKS, optimizer="Adam", lr=1e-4, deterministic=True,
         leaves=leaves, losses={"bf16": sb["losses"], "fp16": sf["losses"]},
         step_ms={"bf16_train_batch": sb["step_ms"],
                  "fp16_train_batch": sf["step_ms"]},
         block_ms={"bf16": mb["block_ms"], "fp16": mf["block_ms"]},
         last_block_step_ms={
             "bf16_train_batch": sb["last_block_step_ms"],
             "bf16_train_many": mb["last_block_step_ms"],
             "fp16_train_batch": sf["last_block_step_ms"],
             "fp16_train_many": mf["last_block_step_ms"]},
         skipped={"fp16_serial": sf["skipped"], "fp16_block": mf["skipped"]},
         loss_scale={"fp16": sf["loss_scale"]}, launches=got,
         expected_launches=expect, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"multistep_gpt2 phase failed: {checks}")
    return got


# the resume_gpt2 phase: resilience.run_resumable over train_many blocks of
# RESUME_K in child processes (GPT-2 medium at MID_LAYERS, the watchdog
# armed, the restore plan at RESUME_THREADS readers): an unbroken child to
# RESUME_STEPS; then one run of the port's launcher with --max_restarts 1
# and --compile_cache_dir, whose child chaos SIGTERMs itself at step
# RESUME_SIGTERM_AT, drains at the next K boundary (exit 43) and is
# relaunched, resuming from the emergency checkpoint
RESUME_K, RESUME_STEPS, RESUME_SIGTERM_AT = 2, 8, 3
RESUME_WATCHDOG_S = 300.0
RESUME_THREADS = 4


def resume_child(spec_path):
    """One process of the resume_gpt2 phase: ``run_resumable`` to
    RESUME_STEPS in train_many blocks; writes ``<name>.json`` beside the
    spec (``<name>_<generation>.json`` under the launcher, which exports
    the restart ordinal) and exits with ``run_resumable``'s code.  The
    three kernel libraries are loaded first, in parallel, from the
    compile cache's directory (DSTPU_COMPILE_CACHE_DIR, the launcher's
    --compile_cache_dir) or built there."""
    import torch

    from deepspeed_tpu_torch import resilience
    from deepspeed_tpu_torch.observability.health import \
        ENV_REPLICA_GENERATION
    from deepspeed_tpu_torch.resilience import chaos
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    t0 = time.perf_counter()
    libs = []
    if device.type == "cuda":
        with ThreadPoolExecutor(3) as pool:     # one nvcc per source
            libs = [job.result()._name for job in
                    [pool.submit(mod.build) for mod in _counted()]]
    build_s = time.perf_counter() - t0
    cfg = dict(gpt2_config(spec["micro"]), train_steps_per_dispatch=RESUME_K,
               resilience={"watchdog_timeout_s": RESUME_WATCHDOG_S},
               checkpoint={"restore_threads": RESUME_THREADS})
    gen = os.environ.get(ENV_REPLICA_GENERATION)
    name = spec["name"] if gen is None else f"{spec['name']}_{gen}"
    vocab = []

    def factory():
        eng = make_engine(cfg, device, size=spec["size"], gpt2=True,
                          **_depth(spec["layers"]))
        vocab.append(eng.module.config.vocab_size)
        return eng

    def k_block(eng, _batch):
        start = eng.global_steps
        for j in range(RESUME_K):
            chaos.step_point(start + j)     # the SIGTERM lands mid-block
        eng.train_many([lm_batch(spec["micro"] * GAS, GPT2_SEQ, vocab[-1],
                                 seed=100 + start + j)
                        for j in range(RESUME_K)])

    out = {"name": name, "build_s": build_s,
           "lib_dirs": sorted({os.path.dirname(x) for x in libs})}
    t0 = time.perf_counter()
    code = 0
    with deterministic():
        try:
            eng = resilience.run_resumable(factory, k_block,
                                           steps=RESUME_STEPS,
                                           save_dir=spec["ckpt"])
            out.update(digest=_z3_digest(eng),
                       global_steps=eng.global_steps,
                       watchdog_fired=bool(eng._watchdog.fired))
        except SystemExit as e:
            code = int(e.code)
            out["tags"] = sorted(os.listdir(os.path.join(spec["ckpt"],
                                                         "emergency")))
    out.update(exit=code, counters=resilience.COUNTERS.as_dict(),
               seconds=time.perf_counter() - t0)
    (pathlib.Path(spec_path).parent / f"{name}.json").write_text(
        json.dumps(out))
    return code


def phase_resume_gpt2(device, size="medium", micro=MICRO,
                      layers=MID_LAYERS):
    """run_resumable in child processes (see RESUME_K): unbroken, then the
    port's launcher with --max_restarts 1 around a child SIGTERM'd by
    chaos (drained at the K boundary, exit 43) and its relaunch (exit 0),
    whose masters are bitwise the unbroken run's; the relaunch loads the
    three kernel libraries from the compile cache (the launcher's
    --compile_cache_dir, seeded with the parent's build: both attempts
    load every library from it, 3 hits and 0 misses each, the relaunch
    from the directory the launcher re-exported), restores with
    RESUME_THREADS readers, and the drain left the flight recorder's
    ``preempt`` dump.  ``phase_resume_gpt2(torch.device("cpu"),
    size="tiny", micro=2, layers=2)`` rehearses it on the CPU (the
    compile-cache check fails there by design: no kernel is built)."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.launcher.run import encode_world_info
    from deepspeed_tpu_torch.observability import flightrec
    from deepspeed_tpu_torch.resilience import RESUME_EXIT_CODE
    from deepspeed_tpu_torch.resilience import chaos
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="resume_gpt2_",
                                         dir=ROOT / "build"))

    def spec_for(name, ckpt):
        spec = work / f"{name}.spec.json"
        spec.write_text(json.dumps({"name": name, "device": str(device),
                                    "ckpt": str(work / ckpt),
                                    "layers": layers, "size": size,
                                    "micro": micro}))
        return spec

    base = dict(os.environ)
    for key in (chaos.ENV_SIGTERM_STEP, "DSTPU_COMPILE_CACHE_DIR",
                "DSTPU_REPLICA_GENERATION"):
        base.pop(key, None)
    try:
        p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--resume-child", str(spec_for("unbroken", "u"))],
                           env=base, timeout=TP_CHILD_TIMEOUT)
        rc_u = p.returncode
        unbroken = json.loads((work / "unbroken.json").read_text())
        # the compile cache, seeded with the libraries this process built
        cache = work / "compile_cache"
        cache.mkdir()
        for mod in (_counted() if device.type == "cuda" else ()):
            shutil.copy2(mod.build()._name, cache)
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
             f"--world_info={encode_world_info({'localhost': [0]})}",
             f"--master_port={_free_port()}", "--max_restarts=1",
             "--restart_backoff=0.1", f"--compile_cache_dir={cache}",
             str(ROOT / "chip_smoke.py"), "--resume-child",
             str(spec_for("launched", "r"))],
            env=dict(base, **{chaos.ENV_SIGTERM_STEP: str(RESUME_SIGTERM_AT),
                              flightrec.ENV_DUMP_DIR: str(work / "fr")}),
            cwd=str(ROOT), timeout=2 * TP_CHILD_TIMEOUT)
        launcher_s = time.perf_counter() - t0
        rc_l = p.returncode
        attempts = sorted(f.name for f in work.glob("launched_*.json"))
        broken = json.loads((work / "launched_0.json").read_text())
        resumed = json.loads((work / "launched_1.json").read_text())
        try:
            preempt = flightrec.load_dump(
                str(work / "fr" / "flightrec_rank0_preempt.json"))
            preempt_kinds = [e["kind"] for e in preempt["entries"]][-3:]
        except (OSError, ValueError) as e:
            preempt, preempt_kinds = None, repr(e)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    drain = (RESUME_SIGTERM_AT // RESUME_K + 1) * RESUME_K
    cb, cr = broken["counters"], resumed["counters"]
    checks = {
        "unbroken_exit_0": rc_u == 0 and unbroken["global_steps"]
        == RESUME_STEPS,
        "launcher_one_relaunch": rc_l == 0 and attempts
        == ["launched_0.json", "launched_1.json"],
        "broken_drained_at_k_boundary": broken["exit"] == RESUME_EXIT_CODE
        and broken["tags"] == [f"global_step{drain}"]
        and cb["preemptions"] == 1,
        "relaunch_resumed": resumed["exit"] == 0
        and resumed["global_steps"] == RESUME_STEPS
        and cr["restarts"] == 1 and cr["restore_seconds"] > 0
        and cr["preemptions"] == 0,
        "masters_bitwise": resumed["digest"] == unbroken["digest"],
        "compile_cache": cb["compile_cache_hits"] == 3
        and cr["compile_cache_hits"] == 3
        and cb["compile_cache_misses"] == cr["compile_cache_misses"] == 0
        and broken["lib_dirs"] == resumed["lib_dirs"] == [str(cache)],
        "preempt_dump": preempt is not None and "preempt" in preempt_kinds,
        "no_watchdog_fire": not unbroken["watchdog_fired"]
        and not resumed["watchdog_fired"]
        and all(r["counters"]["watchdog_fires"] == 0
                for r in (unbroken, broken, resumed))}
    emit("resume_gpt2", model=f"gpt2-{size}", layers=layers, seq=GPT2_SEQ,
         micro_batch=micro, gas=GAS, k=RESUME_K, steps=RESUME_STEPS,
         sigterm_at=RESUME_SIGTERM_AT, drained_at=drain,
         watchdog_timeout_s=RESUME_WATCHDOG_S,
         restore_threads=RESUME_THREADS,
         exit_codes={"unbroken": rc_u, "launcher": rc_l,
                     "broken": broken["exit"], "relaunch": resumed["exit"]},
         attempts=attempts, preempt_dump_tail=preempt_kinds,
         counters={r["name"]: r["counters"]
                   for r in (unbroken, broken, resumed)},
         build_s={r["name"]: r["build_s"]
                  for r in (unbroken, broken, resumed)},
         lib_dirs={r["name"]: r["lib_dirs"]
                   for r in (unbroken, broken, resumed)},
         child_seconds={r["name"]: r["seconds"]
                        for r in (unbroken, broken, resumed)},
         launcher_s=launcher_s, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"resume_gpt2 phase failed: {checks}")


# the obs_gpt2 phase: GPT-2 medium at full width and depth with train_gpt2's
# recipe, OBS_STEPS steps from one seed with observability off and on (the
# metric spool, the JSONL log, the torch.profiler window of OBS_TRACE, the
# health endpoints, the MFU column against the card's 989 bf16 TFLOP/s),
# under the deterministic flag; then fp16 at MID_LAYERS with a NaN loss at
# step 2 of OBS_FP16_STEPS, spool on and off.  The sync-debug steps are
# between the window edges and before the trace.
OBS_STEPS, OBS_WINDOW, OBS_TRACE = 8, 4, (5, 2)
OBS_SYNC_STEPS = (1, 2)
OBS_FP16_STEPS = 4
PEAK_BF16_TFLOPS = 989.0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_get(port, path):
    """(status, body) of ``GET http://127.0.0.1:<port><path>``."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _validate_jsonl(path):
    """The port's validator CLI on ``path``: (exit code, output)."""
    p = subprocess.run([sys.executable, "-m",
                        "deepspeed_tpu_torch.observability", str(path)],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=120)
    return p.returncode, (p.stdout + p.stderr).strip()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _trace_counts(path):
    """A Chrome trace's kernel launches by port kernel name and its
    ``dstpu/`` ranges by name."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = dict.fromkeys(DEVICE_SYMBOL, 0)
    spans = {}
    for ev in events:
        name = str(ev.get("name", ""))
        if ev.get("cat") == "kernel":
            for k, sym in DEVICE_SYMBOL.items():
                if sym in name:
                    kernels[k] += 1
        elif name.startswith("dstpu/"):
            spans[name] = spans.get(name, 0) + 1
    return kernels, spans, len(events)


def gpt2_flops_per_sample(n_params, layers, hidden, seq):
    """Training FLOPs of one GPT-2 sample: 6 N T for the parameters and
    12 L d T^2 for the attention products (forward and backward)."""
    return 6 * n_params * seq + 12 * layers * hidden * seq * seq


def phase_obs_gpt2(device, size="medium", micro=MICRO, layers=None,
                   fp16_layers=MID_LAYERS):
    """Observability at full width and depth (see OBS_STEPS): (a) masters
    bitwise with the spool on and off; (b) no synchronizing CUDA call
    (``torch.cuda.set_sync_debug_mode("warn")``) and no counted fence in
    the sync-debug steps; (c) the JSONL log passes the port's validator
    with one startup and OBS_STEPS / OBS_WINDOW window events whose loss
    is the step's, exactly; (d) the trace window is a loadable Chrome
    trace with the dstpu/ ranges and the kernels' launches; (e) /healthz
    200 and /metrics parses; (f) fp16 with one NaN step: the window's
    skipped 1, the masters bitwise with the spool off.  Returns the
    launches.  ``phase_obs_gpt2(torch.device("cpu"), size="tiny",
    micro=2, layers=2, fp16_layers=2)`` rehearses it on the CPU (the
    launch and sync-debug checks fail there by design)."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from deepspeed_tpu_torch.observability import fences
    from deepspeed_tpu_torch.observability import health as health_mod
    from deepspeed_tpu_torch.resilience import chaos
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="obs_gpt2_",
                                         dir=ROOT / "build"))
    rows = micro * GAS
    cuda = device.type == "cuda"

    def staged(vocab, n, seed0, poison_at=None):
        out = []
        for i in range(n):
            toks, labels = lm_batch(rows, GPT2_SEQ, vocab, seed=seed0 + i)
            leaves = [toks, labels]
            if poison_at is not None:
                p = np.zeros(rows, np.float32)
                leaves.append(p)
            b = tuple(torch.as_tensor(x).to(device) for x in leaves)
            if poison_at is not None and i == poison_at:
                b = chaos.poison_batch(b)
            out.append(b)
        return out

    def run(eng, bs, sync_steps=()):
        """The steps; per step the wall ms (synchronized after the step,
        outside the sync-debug region), the loss tensors (read after the
        run), the sync-debug warnings and the fence deltas."""
        losses, step_ms, warned, fence_delta = [], [], [], 0
        sync(device)
        reset_launch_counts()
        for i, b in enumerate(bs):
            t0 = time.perf_counter()
            if i in sync_steps:
                f0 = fences.FENCE_COUNT
                with warnings.catch_warnings(record=True) as got:
                    warnings.simplefilter("always")
                    if cuda:
                        torch.cuda.set_sync_debug_mode("warn")
                    try:
                        losses.append(eng.train_batch(b))
                    finally:
                        if cuda:
                            torch.cuda.set_sync_debug_mode(0)
                fence_delta += fences.FENCE_COUNT - f0
                warned += [f"{w.filename}:{w.lineno}: {w.message}"
                           for w in got if "called a synchronizing CUDA"
                           in str(w.message)]
            else:
                losses.append(eng.train_batch(b))
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"losses": losses, "step_ms": step_ms, "warned": warned,
                "fence_delta": fence_delta, "launches": launch_counts()}

    # the on-run's steps 2-8 carry its instrumentation: the sync-debug
    # steps (0-based 1-2), the profiler's warm-up (3-4), the traced steps
    # (5-6) and the export (6); step 8 (7) carries the spool alone
    def steady(step_ms):
        sel = step_ms[1:]
        return rows * len(sel) / (sum(sel) / 1e3)

    try:
        with deterministic():
            # -------------------------------------------- (a)-(e): bf16
            eng = make_engine(gpt2_config(micro), device, size=size,
                              gpt2=True, **_depth(layers))
            mcfg = eng.module.config
            n_params = eng.num_parameters()
            leaves = len(eng.master)
            bs = staged(mcfg.vocab_size, OBS_STEPS, 300)
            _reset_peak(device)
            off = run(eng, bs)
            off.update(digest=_z3_digest(eng), peak_mem_gib=_peak_gib(device))
            del eng
            free(device)
            port = _free_port()
            fps = gpt2_flops_per_sample(n_params, mcfg.num_layers,
                                        mcfg.hidden_size, GPT2_SEQ)
            obs = {"report_window": OBS_WINDOW,
                   "jsonl_path": str(work / "events.jsonl"),
                   "trace_dir": str(work / "trace"),
                   "trace_start_step": OBS_TRACE[0],
                   "trace_num_steps": OBS_TRACE[1],
                   "health_port": port, "flops_per_sample": fps,
                   "peak_tflops_per_chip": PEAK_BF16_TFLOPS,
                   "flight_recorder_dir": str(work)}
            eng = make_engine(dict(gpt2_config(micro), observability=obs),
                              device, size=size, gpt2=True, **_depth(layers))
            _reset_peak(device)
            on = run(eng, bs, sync_steps=OBS_SYNC_STEPS)
            health = _http_get(port, "/healthz")
            metrics = _http_get(port, "/metrics")
            eng.flush_telemetry()
            on.update(digest=_z3_digest(eng), peak_mem_gib=_peak_gib(device))
            eng.telemetry.close()
            del eng
            free(device)
            # -------------------------------------------- (f): fp16
            fp16 = {}
            for mode in ("off", "on"):
                cfg = gpt2_config(micro)
                cfg.pop("bf16")
                cfg["fp16"] = {"enabled": True, "initial_scale_power": 16}
                if mode == "on":
                    cfg["observability"] = {
                        "report_window": OBS_FP16_STEPS,
                        "jsonl_path": str(work / "fp16.jsonl")}
                eng = chaos_gpt2_engine(device, cfg, fp16_layers, size=size)
                fb = staged(eng.module.config.vocab_size, OBS_FP16_STEPS,
                            400, poison_at=1)
                r = run(eng, fb)
                eng.flush_telemetry()
                r.update(digest=_z3_digest(eng), skipped=eng.skipped_steps)
                fp16[mode] = r
                del eng
                free(device)
        losses_on = [float(x) for x in on["losses"]]
        losses_off = [float(x) for x in off["losses"]]
        events = _read_jsonl(work / "events.jsonl")
        rc, verdict = _validate_jsonl(work / "events.jsonl")
        windows = [e for e in events
                   if e.get("schema") == "dstpu.telemetry.window"]
        startups = [e for e in events
                    if e.get("schema") == "dstpu.telemetry.startup"]
        trace_path = work / "trace" / (f"steps_{OBS_TRACE[0]}_"
                                       f"{OBS_TRACE[0] + OBS_TRACE[1]}.json")
        try:
            t_kernels, t_spans, t_events = _trace_counts(trace_path)
            trace_ok = True
        except (OSError, ValueError, KeyError) as e:
            t_kernels, t_spans, t_events, trace_ok = {}, {}, 0, repr(e)
        fp16_events = _read_jsonl(work / "fp16.jsonl")
        rc16, verdict16 = _validate_jsonl(work / "fp16.jsonl")
        fp16_windows = [e for e in fp16_events
                        if e.get("schema") == "dstpu.telemetry.window"]
        try:
            prom = health_mod.parse_prometheus_text(metrics[1])
        except ValueError as e:
            prom = {"error": repr(e)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    layers_run = mcfg.num_layers
    attn = layers_run * GAS * OBS_STEPS
    expect = no_launches(adam=leaves * OBS_STEPS, block_fwd=attn,
                         block_bwd=attn)
    n_traced = OBS_TRACE[1]
    expect_trace = {"adam": leaves * n_traced,
                    "block_fwd": layers_run * GAS * n_traced,
                    "block_bwd": layers_run * GAS * n_traced}
    edge_steps = [k * OBS_WINDOW - 1 for k in range(1, OBS_STEPS
                                                     // OBS_WINDOW + 1)]
    checks = {
        "a_masters_bitwise": on["digest"] == off["digest"]
        and losses_on == losses_off,
        "b_no_sync": not on["warned"] and on["fence_delta"] == 0,
        "c_jsonl": rc == 0 and len(startups) == 1
        and len(windows) == OBS_STEPS // OBS_WINDOW
        and [w["loss"] for w in windows] == [losses_on[i]
                                             for i in edge_steps]
        and [w["step"] for w in windows] == [i + 1 for i in edge_steps]
        and all(w["skipped"] == 0 for w in windows),
        "d_trace": trace_ok is True
        and {k: t_kernels.get(k) for k in expect_trace} == expect_trace
        and all(t_spans.get(f"dstpu/{s}", 0) > 0
                for s in ("fwd", "bwd", "boundary", "train_batch")),
        "e_health": health[0] == 200 and json.loads(health[1])["ok"] is True
        and "error" not in prom and prom.get("dstpu_step") == OBS_STEPS,
        "f_fp16": rc16 == 0 and len(fp16_windows) == 1
        and fp16_windows[0]["skipped"] == 1
        and fp16["on"]["skipped"] == fp16["off"]["skipped"] == 1
        and fp16["on"]["digest"] == fp16["off"]["digest"],
        "launches": on["launches"] == expect and off["launches"] == expect}
    last = windows[-1] if windows else {}
    emit("obs_gpt2", model=f"gpt2-{size}", layers=layers_run, seq=GPT2_SEQ,
         micro_batch=micro, gas=GAS, dtype="bf16", optimizer="Adam",
         lr=1e-4, deterministic=True, params=n_params, leaves=leaves,
         steps=OBS_STEPS, report_window=OBS_WINDOW, trace_steps=OBS_TRACE,
         sync_debug_steps=OBS_SYNC_STEPS, flops_per_sample=fps,
         losses={"off": losses_off, "on": losses_on},
         step_ms={"off": off["step_ms"], "on": on["step_ms"]},
         samples_per_s_steady={"off": steady(off["step_ms"]),
                               "on": steady(on["step_ms"])},
         peak_mem_gib={"off": off["peak_mem_gib"], "on": on["peak_mem_gib"]},
         window_events=[{k: w.get(k) for k in (
             "step", "window_steps", "loss", "loss_mean", "grad_norm",
             "loss_scale", "skipped", "step_ms", "samples_per_sec", "mfu",
             "measured_peak_hbm_gb", "host_ms")} for w in windows],
         startup=startups[0] if startups else None,
         validator={"rc": rc, "out": verdict, "fp16_rc": rc16,
                    "fp16_out": verdict16},
         sync_warnings=on["warned"], fence_delta=on["fence_delta"],
         trace={"events": t_events, "kernels": t_kernels, "spans": t_spans,
                "expected_kernels": expect_trace, "loaded": trace_ok},
         health={"healthz": health[0], "metrics_parsed": len(prom),
                 "step": prom.get("dstpu_step")},
         fp16={"layers": fp16_layers, "steps": OBS_FP16_STEPS,
               "losses": {m: [float(x) for x in r["losses"]]
                          for m, r in fp16.items()},
               "skipped": {m: r["skipped"] for m, r in fp16.items()},
               "window": {k: fp16_windows[0].get(k) for k in (
                   "step", "window_steps", "skipped", "loss_scale")}
               if fp16_windows else None},
         mfu=last.get("mfu"), launches={"off": off["launches"],
                                        "on": on["launches"]},
         expected_launches=expect, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"obs_gpt2 phase failed: {checks}")
    return {"off": off["launches"], "on": on["launches"],
            "trace": {k: t_kernels.get(k) for k in expect_trace},
            "fp16_off": fp16["off"]["launches"],
            "fp16_on": fp16["on"]["launches"]}


# the fleet_gpt2 phase: GPT-2 medium at EARLY_LAYERS, dp 2 as two processes
# on the one card over gloo, FLEET_STEPS steps with report_window
# FLEET_WINDOW and the fleet view on; rank 1 stalls FLEET_STALL_S on the
# host (the chaos stall point) before step FLEET_STALL_AT's work
FLEET_STEPS, FLEET_WINDOW, FLEET_STALL_AT, FLEET_STALL_S = 4, 2, 2, 2.0


def fleet_child(spec_path, rank):
    """One rank of the fleet_gpt2 phase (started by ``phase_fleet_gpt2``):
    FLEET_STEPS train_batch steps on its rows, the telemetry flushed; its
    flight recorder dumps at exit (DSTPU_FLIGHTREC_DUMP_AT_EXIT)."""
    t_start = time.perf_counter()
    spec, device = _child_setup(spec_path, rank, 2)
    micro = spec["micro"]
    obs = {"report_window": FLEET_WINDOW,
           "jsonl_path": os.path.join(spec["work"], f"events_{rank}.jsonl"),
           "fleet": True, "fleet_wait_s": 60.0,
           "flight_recorder_dir": spec["work"]}
    cfg = dict(gpt2_config(micro), observability=obs)
    cfg["train_batch_size"] = micro * GAS * 2
    eng = make_engine(cfg, device, size=spec["size"], gpt2=True,
                      **_depth(spec["layers"]))
    rows = micro * GAS
    toks, labels = lm_batch(rows * 2, GPT2_SEQ, eng.module.config.vocab_size)
    batch = (toks[rank * rows:(rank + 1) * rows],
             labels[rank * rows:(rank + 1) * rows])
    out = {"rank": rank, **_child_run(eng, batch, FLEET_STEPS, device)}
    t0 = time.perf_counter()
    eng.flush_telemetry()
    out["flush_s"] = time.perf_counter() - t0
    out["window"] = eng.telemetry.last_window_event
    eng.telemetry.close()
    del eng
    return _child_finish(spec_path, spec, out, t_start, device)


def phase_fleet_gpt2(device, size="medium", micro=MICRO, layers=EARLY_LAYERS):
    """The fleet view across two ranks (see FLEET_STEPS): rank 0 writes
    FLEET_STEPS / FLEET_WINDOW schema-valid fleet events naming both
    hosts and rank 1 writes none; the StragglerDetector flags rank 1 in
    the stalled window; both ranks' masters bitwise equal; each rank's
    flight-recorder dump holds its boundary records.  Returns each rank's
    launches.  ``phase_fleet_gpt2(torch.device("cpu"), size="tiny",
    micro=2, layers=2)`` rehearses it on the CPU (the launch check fails
    there by design)."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.observability import flightrec
    from deepspeed_tpu_torch.resilience import chaos
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="fleet_gpt2_",
                                         dir=ROOT / "build"))
    spec = work / "fleet.json"
    spec.write_text(json.dumps({
        "mode": "fleet", "device": str(device), "size": size,
        "micro": micro, "layers": layers, "work": str(work),
        "coordinator": f"tcp://127.0.0.1:{_free_port()}"}))
    base = dict(os.environ, DSTPU_FLIGHTREC_DUMP_AT_EXIT="1")
    for key in (chaos.ENV_STALL_STEP, chaos.ENV_STALL_S):
        base.pop(key, None)
    stall = {chaos.ENV_STALL_STEP: str(FLEET_STALL_AT),
             chaos.ENV_STALL_S: str(FLEET_STALL_S)}
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-child",
             str(spec), str(r)], env=dict(base, **(stall if r else {})))
            for r in range(2)]
        try:
            deadline = time.monotonic() + TP_CHILD_TIMEOUT
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError(f"--fleet-child ranks exited "
                                 f"{[p.returncode for p in procs]}")
        ranks = [json.loads((work / f"fleet_{r}.json").read_text())
                 for r in range(2)]
        events = _read_jsonl(work / "events_0.jsonl")
        rc, verdict = _validate_jsonl(work / "events_0.jsonl")
        rank1_log = (work / "events_1.jsonl").exists()
        dumps = {}
        for r in range(2):
            path = work / f"flightrec_rank{r}_exit.json"
            try:
                d = flightrec.load_dump(str(path))
                dumps[r] = [e["step"] for e in d["entries"]
                            if e["kind"] == "boundary"]
            except (OSError, ValueError) as e:
                dumps[r] = repr(e)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fleet = [e for e in events if e.get("schema") == "dstpu.telemetry.fleet"]
    stalled_window = FLEET_STALL_AT // FLEET_WINDOW + 1
    checks = {
        "fleet_events": rc == 0 and not rank1_log
        and len(fleet) == FLEET_STEPS // FLEET_WINDOW
        and all(e["reported_hosts"] == 2 and sorted(e["per_host"]) ==
                ["0", "1"] and e["missing_hosts"] == [] for e in fleet),
        "straggler_flagged": [e["window"] for e in fleet
                              if 1 in (e.get("stragglers") or [])]
        == [stalled_window]
        and all(0 not in (e.get("stragglers") or []) for e in fleet),
        "masters_bitwise": ranks[0]["digest"] == ranks[1]["digest"],
        "flight_recorder": all(dumps[r] == list(range(1, FLEET_STEPS + 1))
                               for r in range(2))}
    emit("fleet_gpt2", model=f"gpt2-{size}", layers=layers, dp=2,
         backend="gloo (one card)", seq=GPT2_SEQ, micro_batch=micro,
         gas=GAS, steps=FLEET_STEPS, report_window=FLEET_WINDOW,
         stall={"rank": 1, "step": FLEET_STALL_AT, "s": FLEET_STALL_S},
         losses=[r["losses"] for r in ranks],
         step_ms=[r["step_ms"] for r in ranks],
         peak_mem_gib=[r["peak_mem_gib"] for r in ranks],
         fleet_events=[{k: e.get(k) for k in (
             "window", "step", "reported_hosts", "missing_hosts",
             "straggler_index", "stragglers", "host_ms_min",
             "host_ms_median", "host_ms_max", "step_ms_median",
             "samples_per_sec_sum")} for e in fleet],
         validator={"rc": rc, "out": verdict},
         flight_recorder_boundaries=dumps,
         flush_s=[r["flush_s"] for r in ranks],
         child_seconds=[r["seconds"] for r in ranks],
         launches=[r["launches"] for r in ranks], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"fleet_gpt2 phase failed: {checks}")
    return [r["launches"] for r in ranks]


def phase_calibrate(device):
    """``calibrate_stream_threshold()``: the per-seq fwd+bwd times of the
    streaming kernels and the einsum path, the threshold it returns and
    the one the port's table holds.  A disagreement is recorded, not a
    failure; a raise or a time that is not finite is."""
    import math

    import torch

    from deepspeed_tpu_torch.models import layers as L
    from deepspeed_tpu_torch.ops import stream_attention as sattn
    rows = []
    t0 = time.perf_counter()
    threshold = sattn.calibrate_stream_threshold(rows=rows, verbose=False)
    entry = L.STREAM_AUTO_MIN_BY_KIND.get(torch.cuda.get_device_name(device))
    table = min(entry["causal"]) if entry else L.STREAM_AUTO_MIN_CAUSAL
    finite = bool(rows) and all(math.isfinite(r[k]) for r in rows
                                for k in ("einsum_ms", "stream_ms"))
    emit("calibrate", seconds=time.perf_counter() - t0, rows=rows,
         threshold=threshold, table_threshold=table,
         agrees_with_table=threshold == table, finite=finite)
    if not finite:
        raise AssertionError(f"calibrate phase: times not finite: {rows}")


def phase_attn_sweep(device, kernel, causal, seqs, tokens=4096, n=16,
                     d=64):
    """A kernel's fwd+bwd against the einsum path's, bf16, by sequence
    length, and the smallest length where the kernel is >= 1.05x faster:
    the data for the dispatch defaults in models/layers.py."""
    import torch

    from deepspeed_tpu_torch.models import layers as L
    from deepspeed_tpu_torch.ops import block_attention as battn
    from deepspeed_tpu_torch.ops import stream_attention as sattn
    attention = {"stream": sattn.stream_attention,
                 "block": battn.fused_attention}[kernel]
    rows = []
    for T in seqs:
        B = tokens // T
        gen = torch.Generator(device=device).manual_seed(T)
        q, k, v, do = (torch.randn((B, T, n, d), generator=gen,
                                   device=device).to(torch.bfloat16)
                       for _ in range(4))
        mask = torch.ones((B, T), device=device)

        def path(attn):
            def run():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                torch.autograd.grad(attn(*leaves), leaves, do)
            return run
        kern = path(lambda a, b, c: attention(a, b, c, mask, causal))
        einsum = path(lambda a, b, c: L.xla_attention(
            a, b, c, causal=causal, attn_mask=mask))
        e_a = _time_ms(einsum, device)
        k_a = _time_ms(kern, device)
        k_b = _time_ms(kern, device)
        e_b = _time_ms(einsum, device)
        rows.append({"seq": T, "batch": B, f"{kernel}_ms": min(k_a, k_b),
                     "einsum_ms": min(e_a, e_b),
                     f"einsum_over_{kernel}": min(e_a, e_b) / min(k_a, k_b)})
    wins = [r["seq"] for r in rows if r[f"einsum_over_{kernel}"] >= SWEEP_WIN]
    emit("attn_sweep" if kernel == "stream" else "attn_sweep_block",
         heads=n, head_dim=d, tokens=tokens, dtype="bf16", causal=causal,
         rows=rows, smallest_winning_seq=min(wins) if wins else None)


def main() -> int:
    if sys.argv[1:2] == ["--tp-child"]:
        sys.path.insert(0, str(ROOT))
        return tp_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--z3-child"]:
        sys.path.insert(0, str(ROOT))
        return z3_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--pp-child"]:
        sys.path.insert(0, str(ROOT))
        return pp_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--sp-child"]:
        sys.path.insert(0, str(ROOT))
        return sp_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--z3pp-child"]:
        sys.path.insert(0, str(ROOT))
        return z3pp_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--moe-child"]:
        sys.path.insert(0, str(ROOT))
        return moe_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--resume-child"]:
        sys.path.insert(0, str(ROOT))
        return resume_child(sys.argv[2])
    if sys.argv[1:2] == ["--fleet-child"]:
        sys.path.insert(0, str(ROOT))
        return fleet_child(sys.argv[2], int(sys.argv[3]))
    # --only obs_gpt2,fleet_gpt2,...: the build and those phases alone (a
    # quick check; no kernels line, no result)
    only = None
    only_phases = ("zero_ckpt", "moe_gpt2", "multistep_gpt2", "resume_gpt2",
                   "obs_gpt2", "fleet_gpt2")
    if sys.argv[1:2] == ["--only"]:
        only = set(sys.argv[2].split(","))
        unknown = only - set(only_phases)
        if unknown:
            print(f"chip_smoke.py: --only takes {', '.join(only_phases)}, "
                  f"not {sorted(unknown)}", file=sys.stderr)
            return 2
    if not (ROOT / "deepspeed_tpu_torch" / "csrc" / "fused_optim.cu").exists():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the closure phase's deterministic cuBLAS: set before CUDA starts
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    emit("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), tf32=False)

    mods = dict(zip((SOURCE, ATTN_SOURCE, BLOCK_SOURCE), _counted()))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source
        for job in [pool.submit(mod.build) for mod in mods.values()]:
            job.result()
    emit("build", seconds=time.perf_counter() - t0, sources=list(mods),
         flags=" ".join(mods[SOURCE].NVCC_FLAGS),
         ptxas={src: [ln.strip() for ln in mod.build_log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "smem" in ln or "entry function" in ln]
                for src, mod in mods.items()})

    if only is not None:
        for name in only_phases:
            if name in only:
                if name == "zero_ckpt":
                    process_group(device)
                globals()[f"phase_{name}"](device)
                free(device)
        return 0

    phase_tiny_parity(device)
    phase_tiny_parity(device, seq=256, bwd_mode="fused")
    phase_tiny_parity(device, seq=256, bwd_mode="split")
    phase_tiny_gpt2_parity(device)
    phase_dispatch(device)
    engine, batch, lamb_launches = phase_train(device)
    kernels = phase_kernels(engine, batch, device, lamb_launches)
    prof = phase_profile(engine, batch, device)
    del engine, batch
    free(device)
    adam_launches = phase_adam(device)
    free(device)
    phase_closure(device)
    for k in kernels:
        if k["name"] == "adam":
            # the AdamW phase is not profiled: profile_gpt2 gives its time
            k["launches"] = adam_launches["adam"]
        else:
            # per step: the row's ms covers all 22 leaves' launches
            k["path"] = "train"
            k["profile_ms"] = profile_ms(prof, k["name"], per_launch=False)
    free(device)

    engine, batch, launches512, off512 = phase_train512(device)
    prof512 = phase_profile(engine, batch, device, name="profile512")
    del engine, batch
    free(device)
    phase_train512(device, remat="selective", off_run=off512)
    free(device)
    runs1024 = phase_train_gpt2_1024(device)
    # the forward runs on train512, the split pair on GPT-2 at seq 1024 (and
    # on train512 where auto takes it there), the fused backward on train512
    # where auto takes it, else on the fused GPT-2 run
    by_path = {"train512": (launches512, prof512),
               "train_gpt2_1024 (split)": runs1024["split"],
               "train_gpt2_1024 (fused)": runs1024["fused"]}
    paths = {"stream_fwd": "train512",
             "stream_bwd_fused": ("train512" if launches512["stream_bwd_fused"]
                                  else "train_gpt2_1024 (fused)"),
             "stream_dkv": "train_gpt2_1024 (split)",
             "stream_dq": "train_gpt2_1024 (split)"}
    attn_launches = {k: by_path[v][0][k] for k, v in paths.items()}
    profs = {k: by_path[v][1] for k, v in paths.items()}
    kernels += phase_attn_kernels(device, attn_launches, paths, profs)
    phase_bwd_sweep(device)

    engine, batch, gpt2_launches, gpt2_losses = phase_train_gpt2(device)
    prof_gpt2 = phase_profile(engine, batch, device, name="profile_gpt2")
    del engine, batch
    free(device)
    kernels += phase_block_kernels(device, gpt2_launches, prof_gpt2)
    flat_adam, _ = phase_zero_gpt2(device)
    phase_zero_ckpt(device)
    free(device)
    gpt2_shallow = phase_gpt2_reference(device)
    tp_launches = phase_tp_gpt2(device, gpt2_shallow, layers=EARLY_LAYERS)
    for k in kernels:
        if k["name"] == "adam":
            # per GPT-2 step: 16 leaves' launches (its ms: BERT-large's 22)
            k["profile_ms"] = profile_ms(prof_gpt2, "adam", per_launch=False)
            k["path"] = "adam; profile_ms: train_gpt2"
            # the ZeRO path's shape: one flat partition, or its buckets
            k["flat_partition"] = {key: flat_adam[key] for key in (
                "elements", "buckets", "launches_overlap_on", "ms",
                "event_ms", "bucket_loop_ms", "plain_ms", "bound_ms",
                "library_ms", "max_abs_err")}
        if k["name"] in ("adam", "block_fwd", "block_bwd"):
            # per rank of tp_gpt2 (mp 2): ZeRO off (a) and ZeRO-1 (b)
            k["tp_gpt2_launches"] = {run: [r[k["name"]] for r in ranks]
                                     for run, ranks in tp_launches.items()}
    free(device)
    z3_launches = phase_zero3_gpt2(device, layers=EARLY_LAYERS)
    for k in kernels:
        if k["name"] in ("adam", "block_fwd", "block_bwd"):
            # per rank of zero3_gpt2 (dp 2): runs (a)-(d) and the resume
            k["zero3_gpt2_launches"] = {run: [r[k["name"]] for r in ranks]
                                        for run, ranks in z3_launches.items()}
    free(device)
    pp_launches = phase_pp_gpt2(device, gpt2_shallow, layers=EARLY_LAYERS)
    for k in kernels:
        if k["name"] in ("adam", "block_fwd", "block_bwd"):
            # per stage of pp_gpt2 (pp 2): runs (a)-(d)
            k["pp_gpt2_launches"] = {run: [r[k["name"]] for r in ranks]
                                     for run, ranks in pp_launches.items()}
    free(device)
    sp1_shallow = phase_gpt2_reference(device, micro=GPT2_1024_MICRO,
                                       seq=GPT2_1024_SEQ,
                                       name="gpt2_1024_reference")
    free(device)
    sp_launches = phase_sp_gpt2(device, sp1_shallow, layers=EARLY_LAYERS)
    for k in kernels:
        if k["name"] in ("adam", "stream_fwd", "stream_dkv", "stream_dq"):
            # per seq rank of sp_gpt2 (sp 2): (a) ring, (b) Ulysses, (c)
            k["sp_gpt2_launches"] = {run: [r[k["name"]] for r in ranks]
                                     for run, ranks in sp_launches.items()}
    free(device)
    z3pp_launches = phase_zero3_pp_gpt2(device, gpt2_shallow,
                                        layers=EARLY_LAYERS)
    for k in kernels:
        if k["name"] in ("adam", "block_fwd", "block_bwd"):
            # per rank of zero3_pp_gpt2 (dp 2 x pp 2): (a) GPipe, (b)
            # 1F1B, (c) the resume
            k["zero3_pp_gpt2_launches"] = {
                run: [r[k["name"]] for r in ranks]
                for run, ranks in z3pp_launches.items()}
    free(device)
    moe = phase_moe_gpt2(device)
    free(device)
    multi_launches = phase_multistep_gpt2(device)
    free(device)
    phase_resume_gpt2(device)
    free(device)
    obs_launches = phase_obs_gpt2(device)
    free(device)
    fleet_launches = phase_fleet_gpt2(device)
    free(device)
    for k in kernels:
        if k["name"] in ("adam", "block_fwd", "block_bwd"):
            # obs_gpt2 at 24 layers: spool off / on, the kernels in its
            # trace window, the fp16 runs at MID_LAYERS; fleet_gpt2 per
            # rank at EARLY_LAYERS
            k["obs_gpt2_launches"] = {
                **{run: v[k["name"]] for run, v in obs_launches.items()},
                "fleet_gpt2": [r[k["name"]] for r in fleet_launches]}
    for k in kernels:
        if k["name"] in ("adam", "block_fwd", "block_bwd"):
            # moe_gpt2 (a) top-1 at 24 layers, (b) top-2, (c) the 12-layer
            # reference, (d) ep 2 per rank, (e) its resume per rank; and
            # multistep_gpt2's train_batch / train_many runs
            k["moe_gpt2_launches"] = {
                run: ([r[k["name"]] for r in v] if isinstance(v, list)
                      else v[k["name"]])
                for run, v in moe["launches"].items()}
            k["multistep_gpt2_launches"] = {
                run: v[k["name"]] for run, v in multi_launches.items()}
        if k["name"] == "adam":
            # the MoE's expert leaf [24, 8, 1024, 4096], one launch
            k["moe_expert_leaf"] = {key: moe["expert_leaf"][key] for key in (
                "elements", "ms", "plain_ms", "bound_ms", "max_abs_err")}
    for causal in (False, True):
        phase_attn_sweep(device, "stream", causal, (256, 512, 1024))
        phase_attn_sweep(device, "block", causal, (64, 128))
    phase_calibrate(device)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "profile_ms", "path")
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(card)
    extra = ("flat_partition", "tp_gpt2_launches", "zero3_gpt2_launches",
             "pp_gpt2_launches", "sp_gpt2_launches",
             "zero3_pp_gpt2_launches", "moe_gpt2_launches",
             "multistep_gpt2_launches", "moe_expert_leaf",
             "obs_gpt2_launches")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: r[k] for k in extra if k in r}}
                                  for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
