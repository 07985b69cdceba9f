#!/usr/bin/env python3
"""Drive the PyTorch port's render path, training step, command-line path,
its other training attention modes, its int8 walks, its fp32 walks in
every mode, its exposure-control path and its (data, rays) mesh on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

0. Require CUDA; print the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``papr_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (the flagship model: 30k-point cube init, k = 20,
   bf16; the orbit pose of ``bench.py`` with focal 700 at 800x800):
   cull selection on the full frame (the candidates each tile scans before
   the early exit, the bound of that work, the earlier kernel's time beside
   the new one; at the training shape too), the query embedder on its 640,000
   rays, the eval attention on a 160x160 ray block (and, on its rays, the
   bf16 stream forwards against it: they run its walk code); then, on a 160x160
   training patch cropped at a seeded offset from the same frame, the
   training selection (exact 'approx' prefilter, one 2048-wide chunk), the
   query embedder backward and the key / value streams forward and
   backward (every output and gradient, d_rec per routing lane group): the
   record-native streams, the key stream with the query chain folded in
   (``tpu.query_fold``) and the streams on raw feature tensors
   (``tpu.fused_attn: stream``, dx per column group). Print errors and
   times; the bf16 record-native stream forwards and backwards (on wgmma)
   print the kernel alone beside the whole call, the bound and the earlier
   WMMA kernel's times, and the backwards also hold the median ray's error.
3. Render 1 + 3 orbit frames at 800x800 through ``render_frames`` (one
   full-frame tile) and one frame through ``render_full_image`` with the
   config's 100x100 test tiles; check the frames, that every kernel of the
   path launched and that no plain version ran; profile 3 more frames for
   the device-time split by stage; then hold a small frame of the kernel
   path against the plain fp32 path on the card.
4. Train on the patch with ``make_train_step`` (MSE + 1e-2 LPIPS on the
   seeded random VGG16 backbone): 1 warm-up and 5 timed steps (ms/step,
   rays/s, peak memory); check the loss and gradients are finite, every
   trained group moved, every training kernel launched on each step and no
   plain version ran; profile one step by stage (the stream kernels named:
   the bf16 forwards' and backwards' wgmma kernels); prune + grow and one more
   step on a fresh optimizer state; then one 32x32 step of the kernel path
   against the plain fp32 path (loss and per-group gradients), for
   ``streamrec`` + ``cull`` and for ``fused_attn: true`` + ``topk_impl:
   pallas``.
   Phase 2 also holds the streaming top-k, the fused attention scores
   (forward and backward), the dW reduction in bf16 and fp32 (each beside
   one ``torch.matmul``; two runs bit-equal)
   and the embedder kernels on the key and value stacks (512,000 tokens
   with the point-feature columns, forward and backward) against their
   plain versions at the command-line path's shapes.
5. The command-line path in process: a procedural sphere scene written at
   800x800 (``dataset/synth.py``), ``configs/default.yml`` with the sphere
   run's point init, 30,000 padded points, k = 20, 160x160 patches, bf16,
   MSE + 1e-2 LPIPS, ``tpu.topk_impl: pallas`` and ``tpu.fused_attn: true``:
   ``train_and_eval`` for 12 steps with a prune + grow event, eval renders
   and checkpoints; the checkpoint restored bit for bit and a resume of two
   more steps; the test entry point over the test split at 100x100 tiles;
   one frame again through the one-shot kernel and the two-kernel eval path
   (``eval_fused: false``), the split-kernel and two-kernel frames held
   against the one-shot kernel's; then ms/step, the device's idle
   share and the kernel time by stage of this configuration on a fixed
   batch and on the real loader, and of ``streamrec`` + ``cull`` on the same
   model and batch.
6. The two other training attention modes, ``tpu.fused_attn: stream`` and
   ``streamrec`` + ``tpu.query_fold: true``, beside ``streamrec`` on the
   flagship model and one 160x160 batch: each mode from the same seeded
   model, 1 warm-up and 10 timed steps, twice (there and back): ms/step,
   rays/s, peak memory, the profiler's kernel-time split and idle share;
   exact launch counts per step (1 + 1 key and 1 + 1 value launches, no
   query embedder launch under ``query_fold``) and no plain version; one
   800x800 frame at 100x100 tiles under each mode (64 + 64 launches), the
   new modes' frames held against the one-shot kernel's; then one 32x32 step
   of each new mode against the plain fp32 path.
   Phase 2 also holds the three int8 kernels (``attend_eval_i8`` on the eval
   block, self-calibrated and on a frame-level quantization;
   ``key_stream_i8_fwd`` / ``value_stream_i8_fwd`` on the training patch) and
   the four variants of the int8 walk microbenchmark against their plain
   versions on the same quantization, beside the bf16 kernels on the same
   inputs and the calibration alone.
7. The int8 walks at full width: 1 + 3 serving frames under
   ``tpu.int8_eval`` beside bf16 frames (ms/frame, peak memory, profiler
   split and idle share); one tiled frame (exactly 64 int8 launches, no bf16
   one, ONE calibration); the int8 frame against the bf16 frame (PSNR, pixels
   within 2/255, fused features, attention) on the seeded flagship model and
   on phase 5's trained sphere model with seeded influence scores; 1 + 10
   steps under ``tpu.int8_train`` beside ``streamrec`` from the same seeded
   model (ms/step, profiler split, exact launch counts: the int8 forwards,
   the unchanged backwards, no bf16 stream forward; every group moved; the
   first step's loss against the bf16 step's); each row where a knob cannot
   take effect once (bit-equal, one warning or none, the bf16 kernels); the
   microbenchmark through its entry point; then one 32x32 ``int8_train`` step
   against the plain fp32 path.
8. The fp32 walks (``use_amp: false``) on ``configs/t2/Caterpillar.yml``'s
   model (merged onto ``configs/default.yml``: 5 x 256 key / query stacks,
   the 8-layer value stack to 32, k_L [4,4,4], q_L [4], v_L [4,4], k = 20,
   5,000 cube points in 30,000 slots, background 4, 180x180 patches, MSE +
   1e-2 LPIPS) seen around ``dataset/synth.py``'s sphere: the fp32 kernels
   (``fused_mlp_f32`` fwd / bwd, ``attend_eval_f32``, the key / value streams
   fwd / bwd, ``wgrad_f32`` beside one ``torch.matmul``) against their plain
   fp32 versions at its shapes, with what one TF32 pass would read (the
   stream forwards and backwards, on wgmma: also each kernel alone, its
   profiler span, beside the earlier WMMA kernel's times, and a median-ray
   bound: the forwards' raw / fused, the key backward's dqq; the backwards'
   walk gradients at a tighter bound; the forwards against the fp32 K3 on
   its rays, the key's attention bit for bit, and at ``configs/demo.yml``'s
   widths); the first
   step's loss and gradients against the plain fp32 path, then 1 + 10 steps
   under ``auto`` (ms/step, rays/s, kernel time, idle share, peak memory,
   exact launch counts: fp32 kernels only, no plain version; the step's
   kernels grouped by the operator that issued them, the cuBLAS gemv ones
   first); a step with embedder dropout; one 800x800 serving frame and one
   tiled frame at 100x100 tiles, the serving frame against the plain fp32
   frame. Then the other modes under fp32 on the same model: their kernels
   against their plain fp32 versions at Caterpillar's shapes (the
   query-folded key stream, its key outputs also against the fp32 key
   stream's on its own qq bit for bit, the feature streams, the fused scores on the
   split path's embeddings, the embedder kernels on its key and value stacks,
   the int8 walks with their fp32 epilogue), and for each of ``stream``,
   ``true``, ``score``, ``streamrec`` + ``query_fold``, ``int8_eval`` and
   ``int8_train`` one step against the plain fp32 path's, 1 + 5 timed steps
   (ms/step, rays/s, peak memory, a profiled step's idle share) and a serving
   and a tiled frame against ``auto``'s fp32 frames (the int8 frame: int8's
   own distance), with exact launch counts (the mode's fp32 kernels, no bf16
   kernel, no plain version; the ``stream`` and ``query_fold`` serving
   frames profiled by kernel, the ``query_fold`` step's and frame's folded
   key stream kernels named); then ``configs/demo.yml`` untouched through
   ``cli.train`` and ``cli.test``.
9. Exposure control and the reference checkpoint format, on
   ``configs/t2_sphere_exposure.yml`` (bf16, FiLM live at the UNet's input)
   and ``configs/t2/Caterpillar_exposure_control.yml`` (fp32, FiLM off as
   the reference ships it), widths untouched, around a synth t2 sphere
   written with per-image exposure gains (the cuts are printed): a seeded
   model written as a model.pth by ``export_torch`` is the pretrained
   ``load_path``; the first step with a shading code against the plain
   fp32 path (32x32, phase 4's / phase 8's bounds); the candidate scores
   and pick against the plain fp32 path on one sample patch; one resample
   and one step with exact launch counts (no plain version, no twin of
   the other dtype), timed (render and batched decode; the step beside the
   same model's step without a code); then ``cli.exposure`` (3 steps,
   resamples at 0 and 2, an eval) and ``cli.test --exp`` (t2_sphere: also
   ``--random`` and ``--intrp``; Caterpillar: from the finetuned model.pth)
   in process, the counters reset just before and read just after; the
   finetuned model through ``export_torch`` / ``import_torch``: a test
   frame at 100x100 tiles and the codes bit-equal.
10. The (data, rays) mesh (``papr_tpu_torch/parallel``) on the card: the
   one-rank references in this process, then two ranks sharing the card
   over gloo (``--mesh-rank``, a file:// rendezvous, each rank with a hard
   time limit): (a) phase 4's flagship step on data = 1, rays = 2, its loss
   and every group's gradient against one rank's, 1 + 5 timed steps with
   exact per-rank launches and no plain version, the parameters bit-equal
   across the ranks; (b) phase 8's fp32 Caterpillar step on data = 2, rays
   = 1 with a batch of two against one rank at phase 8's bounds; (c) on (a)'s
   model an 800x800 serving frame (one tile, wrapped onto both ranks) and a
   frame at 100x100 tiles (32 a rank), bit-equal to one rank's, exact
   per-rank launches; which collectives gloo runs on CUDA tensors. Then (d)
   ``cli.train`` (a prune + grow event, evals) and ``cli.test`` on a synth
   sphere under ``torchrun`` on two ranks against one rank (losses within
   rel 1e-4, the test metrics equal; rank 1 writes nothing under the run's
   directory, ``tools/torch_rank_audit.py``), and (e) the collectives under
   NCCL at world size 1 against gloo.
11. Print the kernels' JSON line (each kernel's launches on its main path,
   and on phase 10's ranks, error, time, plain version's time and bound),
   then the card and the result line.

Imports nothing of JAX. Weights are random, from fixed seeds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Tolerances (bf16 compute on both sides; the plain versions round at the
# same points, so differences come from summation order inside the MMAs).
K1_MIN_EQUAL = 0.999      # share of rays whose index sets equal the plain's
K3_REL = 1e-2             # relative Frobenius error of fused
K3_ATTN_ABS = 5e-3        # max abs error of attn
# The forward walk on wgmma (K3, the bf16 stream forwards, K2) also holds the
# median over rays (rows) of each one's relative error: a rounding-point
# fault moves every ray a little, where the Frobenius norm of a sound kernel
# is dominated by the few rays whose bf16 roundings a summation order flips
# (PERF.md, Findings: the sound and planted-fault readings).
# Sound (NVIDIA H100 80GB HBM3, PERF.md §6): K3 4.0e-4, key raw 1.75e-3,
# value fused 4.2e-4, K2 0 (most rows bit-equal). Caught: activations
# rounded before the bias (K3 2.7e-3, key 8.6e-3, value 2.5e-3, K2 4.9e-3),
# the output LayerNorm's biased variance (key 6.3e-3, K2 3.3e-3); left to
# the `cuda` tests: that variance fault in K3 (4.2e-4) and the value rows
# not rounded before the fuse (K3 5.4e-4, value 5.4e-4).
FWD_MEDIAN_REL = {"attend_stream_eval": 1e-3, "key_stream_fwd": 3.5e-3,
                  "value_stream_fwd": 1e-3, "fused_mlp": 5e-4}
# K3's two faults the median ray misses, caught by two more statistics:
# the median ray of attn (sound 0: most rays' attention is bit-equal; the
# output LayerNorm's biased variance moves every ray's scores, 1.9e-5) and
# the fused error of the ray at the 5th percentile (the rays whose 40 walks
# all round alike read ~0; a rounding point moved, such as the value rows
# not rounded before the fuse, moves every ray) (PERF.md, Findings).
K3_ATTN_MEDIAN_REL = 5e-6
K3_FUSED_Q05_REL = 1e-5
# K2, the embedder forward (query stack, 640,000 rays): relative Frobenius
# error of the bf16 output (sound 2.1e-4; the variance fault 3.3e-3,
# activations rounded before the bias 5.0e-3), and its median row above.
K2_REL = 1e-3
# Row 3, the embedder backward (query stack, 25,600 rays, and the key / value
# stacks): the median row of dx against the plain backward at the TPU
# kernel's rounding points (the plain backwards' ``kernel_grads``: every
# gradient fp32, dz rounded for the dX and dW products, db from the fp32 dz;
# autograd's own rule rounds dz at each cast, a rounding point away), and
# each layer's bias gradient against it: the last layer's db held (its dz
# comes from dy through the output LayerNorm alone), the others printed (a
# summation order's bf16 flips reach every column of an inner layer's db).
# The stream backwards' db the same (DB_REL; the key's plain backward on the
# kernel forward's raw dots). Sound (NVIDIA H100 80GB HBM3): median dx row
# 1.7e-7, last db 2.0e-5 (query) / 3.5e-5 (key stack) / 5.3e-7 (value
# stack), key stream 4.4e-4, value stream 8.2e-7. Planted: activations
# rounded before the bias, dx 1.2e-2; db from the bf16-rounded dz 1.5e-3
# (query, key stack), 3.3e-3 (key stream), 2.2e-3 (value stream); on the
# value stack dy's bf16 values leave its last dz unrounded by the fault
# (5.3e-7: not seen there).
EMBED_DX_MEDIAN_REL = 1e-4
DB_REL = {"fused_mlp_bwd": 3e-4, "key_stream_bwd": 1.5e-3,
          "value_stream_bwd": 1e-4}
# The bf16 stream forwards on K3's rays against K3 (one walk code): the key's
# attn bit-equal, the value's fused on K3's attn up to the fuse's arithmetic
# (K3 sums with an online softmax; sound 1.1e-7, PERF.md, Findings).
K3_FUSED_REL = 1e-5
TILED_MIN_CLOSE = 0.999   # share of pixels within 2/255, tiled vs full tile
REF_REL = 3e-2            # small frame: bf16 kernel path vs fp32 plain path
# Training kernels. Forward: relative Frobenius error of each output;
# backward: of every gradient, d_rec per lane group (both sides round
# activations and dz to bf16; the plain version also rounds dW to bf16 and
# sums in another order; a hidden relu whose input the two forwards round
# to opposite signs switches one token's path in one of them only). The
# plain key stream is given the kernel forward's score relu pattern, so
# both differentiate the same function. The sound kernels read up to 3.2e-2
# here (value d_rec, key walk biases); planted faults read 5.4e-2 (the
# LayerNorm backward's variance term dropped, key walk) and above (PERF.md,
# Findings).
K1_TRAIN_MIN_EQUAL = 0.999
FWD_REL = 5e-3         # sound <= 2.1e-3 (raw); a score scale off by 1 %: 1.0e-2
SS_REL = 3e-2          # masked scores keep ~6 % of the dots: ~5x raw's error
RELU_MIN_AGREE = 0.99  # share of alive scores whose relu the forwards agree on
BWD_REL = 4e-2
# The bf16 stream backwards on wgmma (rows 5, 6) also hold the MEDIAN of the
# per-ray relative error of d_rec and of the per-row error of the walk
# gradients (a row of a matrix, an entry of a vector), per kernel: a
# rounding-point fault moves every ray a little, which a Frobenius norm
# dominated by a few relu flips does not show. Sound (d_rec, walk): key
# 4.9e-3 / 1.58e-2, value 1.91e-2 / 1.04e-2; dz truncated to bf16 instead of
# rounded: key 1.49e-2 / 1.71e-2, value 2.99e-2 / 1.74e-2, under BWD_REL
# (PERF.md, Findings: the planted-fault readings).
BWD_MEDIAN_REL = {"key_stream_bwd": (1e-2, 2.5e-2),
                  "value_stream_bwd": (2.5e-2, 1.4e-2)}
# The streams of ``fused_attn: stream`` and ``query_fold``. The folded key
# stream holds FWD_REL / BWD_REL as the record-native one (sound: raw 2.1e-3,
# qq 2.9e-4, gradients <= 3.12e-2; the query backward fed 1.05 dqq reads
# 5.07e-2, b_q left out 3.6e-2 forward). The feature streams get the same
# geometry floats as their plain versions and read lower, so their bounds
# are tighter. Sound: raw 5.5e-4, fused 1.44e-4, gradients <= 1.37e-2 (key),
# 8.9e-3 (value), attn max abs 1.2e-4 (features) / 1.8e-4 (folded). Planted
# faults: score scale off by 1 % raw 1.0e-2; value rows not rounded before
# the fuse 4.1e-4; d_influ scaled by 1.05 5.0e-2, without its relu 19; dxk's
# position columns zeroed 1.0; dqq keeping one slot 0.98; b_q left out attn
# 1.0e-3 (PERF.md, Findings).
STREAM_ATTN_ABS = 5e-4
# The folded key stream (WMMA) on its own qq against the unfolded bf16 key
# forward (wgmma): the same function and rounding points in another
# summation order. Sound: attn max abs 7.1e-5, raw 6.7e-5 (PERF.md,
# Findings).
Q_UNFOLD_ABS = 5e-4
Q_UNFOLD_REL = 5e-4
FEAT_RAW_REL = 2e-3
FEAT_FUSED_REL = 3e-4
FEAT_BWD_REL = 2.5e-2
# One 32x32 training step, bf16 kernel path vs fp32 plain path: loss and
# per-group gradients (relative Frobenius error).
TRAIN_REF_LOSS_REL = 2e-2
TRAIN_REF_GRAD_REL = 1e-1
# Streaming top-k: the kernel rounds like its plain version, rows are equal.
TOPK_MIN_EQUAL = 1.0
# Fused scores, on the embedder's own outputs at the patch. Forward: attn
# max abs and raw dots relative Frobenius (both sides round the two
# projections to bf16; the summation order differs): the sound kernel reads
# 2.3e-5 / 7.6e-5; planted faults read 1.2e-4 / 1.0e-2 (score scale off by
# 1 %), 3.4e-4 / 5.4e-3 (projection not rounded before its bias) and above.
# Backward: every gradient, relative Frobenius, against the plain backward
# given the kernel forward's relu pattern: sound 2.3e-3; faults 1.1e-2
# (scale off by 1 %), 2.6e-2 (the rounding point) and above (PERF.md,
# Findings).
SCORE_ATTN_ABS = 1e-4
SCORE_RAW_REL = 2e-3
SCORE_BWD_REL = 6e-3
# The embedder kernels on the key and value stacks (512,000 tokens, the value
# stack with 64 pass-through point-feature columns). Sound: forward 6.2e-4,
# every gradient <= 8.8e-3. Planted faults: pass-through columns scaled by
# 1 % in the encoding read 5.5e-3 / 1.2e-2 forward and 9.6e-2 / 1.4e-1
# backward; dx of some raw columns scaled by 5 % reads 2.9e-2 / 5.1e-2, by
# 1 % 8.4e-3 / 1.3e-2 (not caught) (PERF.md, Findings).
STACK_FWD_REL = 2e-3
STACK_BWD_REL = 2e-2
# The dW reduction against the fp32 product of the same bf16 operands (both
# sum exact products in fp32; only the order differs).
WGRAD_REL = 1e-4
# The earlier WMMA kernels' times (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
# K3 on phase 2's 25,600-ray block and per 800x800 frame, wgrad at phase 2's
# and phase 8's shapes; printed beside the wgmma kernels' times.
K3_WMMA_MS = 11.915
K3_WMMA_FRAME_MS = 212.6
# The int8 K3 on walk.cuh's WMMA walk before its wgmma redesign (PERF.md §6,
# same card): row 4q's kernel alone on phase 2's block, row 4qf's call on
# phase 8's 32,400 rays.
K3_I8_WMMA_MS = 9.247
K3_I8F32_WMMA_MS = 12.321
# The earlier K1 (one thread a ray, 512-wide chunks, an exit test after each)
# at the serving and training shapes, and the earlier fp32 K3 (3xTF32 on
# walk.cuh's WMMA walk) at phase 8's 32,400 rays and an 800x800 frame
# (tools/torch_k1_ablate.py, tools/torch_k3_ablate.py --f32 on that tree,
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
K1_EARLIER_MS = {"serving": 0.5011, "training": 0.1637}
K3_F32_WMMA_MS = 40.421
K3_F32_WMMA_FRAME_MS = 762.6
# The fp32 frames on Caterpillar's model with that K3 (phase 8, NVIDIA H100
# 80GB HBM3, 700.00 W): serving, 100x100-tiled.
F32_FRAME_WMMA_MS = (807.5, 1378.4)
WGRAD_WMMA_MS = 0.934
WGRAD_F32_WMMA_MS = 4.819
# The fp32 stream backwards on walk_bwd.cuh's WMMA walk before their wgmma
# redesign, (whole call, kernel alone: its profiler span) ms at phase 8's
# shapes (tools/torch_stream_bwd_ablate.py --f32 on that tree, Caterpillar's
# walks with random weights; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
F32_BWD_WMMA_MS = {"key_stream_f32_bwd": (53.692, 47.031),
                   "value_stream_f32_bwd": (58.484, 50.305),
                   "key_stream_q_f32_bwd": (56.791, 49.642)}
# The fp32 stream forwards on walk.cuh's WMMA walk before their wgmma
# redesign (the key's softmax inside the kernel), the same readings
# (tools/torch_stream_fwd_ablate.py --f32 on that tree; the feature
# streams' with --feat --f32; PERF.md §6). The folded key stream's (row 7f,
# both directions): phase 8's call on that tree, and as alone its kernel's
# span in phase 8's profiled query_fold step.
F32_FWD_WMMA_MS = {"key_stream_f32_fwd": (18.304, 17.861),
                   "key_stream_q_f32_fwd": (19.931, 19.476),
                   "value_stream_f32_fwd": (21.857, 21.403),
                   "key_stream_feat_f32_fwd": (18.285, 18.017),
                   "value_stream_feat_f32_fwd": (21.713, 21.149)}
# The fp32 embedder (rows 2f / 3f) on walk.cuh / walk_bwd.cuh's WMMA walk
# before its wgmma redesign, the same readings at phase 8's shapes and
# Caterpillar's widths (tools/torch_embed_ablate.py --f32 on that tree,
# random weights: the query stack forward on 640,000 rays, backward on
# 32,400; the key / value stacks of ``true`` on 648,000 tokens; PERF.md §6).
F32_EMBED_WMMA_MS = {"fused_mlp_f32": (13.523, 13.134),
                     "fused_mlp_bwd_f32": (2.552, 1.736),
                     "fused_mlp_f32 (key stack)": (14.510, 14.128),
                     "fused_mlp_f32 (value stack)": (20.930, 20.596),
                     "fused_mlp_bwd_f32 (key stack)": (41.089, 36.003),
                     "fused_mlp_bwd_f32 (value stack)": (54.434, 46.341)}
# The bf16 WMMA kernels before their wgmma redesigns (NVIDIA H100 80GB HBM3,
# 700 W), (whole call, kernel alone: its profiler span) ms, measured on the
# tree before each redesign (PERF.md §6): the key / value stream forwards
# and backwards on phase 2's patch (tools/torch_stream_fwd_ablate.py /
# torch_stream_bwd_ablate.py); the embedder forward (K2) on the query stack
# at 640,000 rays and the key / value stacks at 512,000 tokens, its backward
# (row 3) on the query stack at 25,600 rays and the stacks
# (tools/torch_embed_ablate.py --split-only, random walks at the flagship's
# widths).
WMMA_MS = {"fused_mlp": (4.579, 4.056), "fused_mlp_bwd": (2.003, 0.602),
           "fused_mlp key stack": (3.942, 3.490),
           "fused_mlp value stack": (5.103, 4.489),
           "fused_mlp_bwd key stack": (12.073, 9.845),
           "fused_mlp_bwd value stack": (14.369, 11.713),
           "key_stream_fwd": (5.721, 5.445),
                  "value_stream_fwd": (6.229, 5.950),
                  "key_stream_bwd": (24.596, 18.738),
                  "value_stream_bwd": (23.592, 16.277)}
# Two-kernel eval frame against the one-shot kernel's frame.
EVAL_TWO_MIN_CLOSE = 0.999
# Tiled frames under ``stream`` and ``streamrec`` + ``query_fold`` against
# the one-shot kernel's tiled frame (the same selection): pixels within 1/255.
STREAM_FRAME_MIN_CLOSE = 0.999
# Split-kernel frame (topk_impl pallas, fused_attn true) against the one-shot
# kernel's frame (cull selection), on a model with non-zero influence
# scores: pixels, then the whole frame's fused features (relative Frobenius)
# and attention (max abs). The selections may swap near ties; both paths
# compute in bf16 and sum in different orders. A sound run reads 100 % of
# pixels within 1/255, 1.7e-4 and 2.6e-3.
EVAL_SPLIT_MIN_CLOSE = 0.999
SPLIT_FUSED_REL = 1e-3
SPLIT_ATTN_ABS = 5e-3

# The int8 kernels against their plain versions on the same quantization. The
# integer products are exact on both sides; the two differ where an fp32
# activation lands within an ulp of a rounding boundary (sincosf against
# torch.sin, LayerNorm summation order) and one quantized value flips by 1.
# Sound (deterministic across runs): K3 fused 6.4e-4 / 5.7e-4, attn max abs
# 2.9e-3 / 1.6e-3; key raw 1.9e-3, attn max abs 4.5e-4; value fused 6.3e-4.
# The weakest planted fault, a layer quantizing the bf16-rounded activation,
# reads fused 4.9e-3 / 4.1e-3, raw 1.5e-2, value 4.3e-3; truncation instead
# of rounding 7.2e-2 / 6.0e-2, 2.0e-2, 6.3e-2, key attn 1.0e-3, K3 attn
# 7.5e-3 (PERF.md, Findings).
I8_FUSED_REL = 2e-3
I8_RAW_REL = 5e-3
I8_ATTN_ABS = 5e-3
I8_KEY_ATTN_ABS = 8e-4
# The int8 K3's median ray, which no flip reaches: fp32 noise (sound 1.06e-7
# / 1.13e-7 on wgmma); its value rows left unrounded read 4.4e-4 (PERF.md,
# Findings).
I8_MEDIAN_REL = 1e-5
# The microbenchmark's variants: the int8 ones take the same fp32 operations
# in the same order as their plain versions (int8raw: integers all the way).
I8_BENCH_REL = {"bf16": 2e-3, "int8": 1e-5, "int8s": 1e-5, "int8raw": 0.0}
# The int8 frame against the bf16 frame: not kernel against plain but int8's
# own distance, so these only catch an int8 path that is broken outright
# (the JAX package's tests allow 5 % of scale and 0.02 on attn on a toy). On
# the seeded flagship model (diffuse attention) a sound run reads 1.9e-2 /
# 9.4e-3 max abs; on the trained sphere model with seeded influence scores
# the softmax is nearly one-hot (foreground mass 0.993), a few of 640,000
# rays swap their winning point and the max abs reads 0.18 while 99.5 % of
# pixels stay within 2/255: held by the Frobenius norms, max abs printed.
I8_FRAME_MIN_CLOSE = 0.98      # pixels within 2/255
I8_FRAME_FUSED_REL = 1.5e-1
I8_FRAME_ATTN_REL = 1.5e-1
I8_STEP_LOSS_REL = 2e-2        # first int8_train step's loss against bf16's

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, dense bf16 and int8 tensor-core rates, fp32 rate outside the tensor
# cores.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
# The fp32 walks' products are 3xTF32: three products at the 494.7 TFLOP/s
# dense TF32 peak for each fp32-accurate one, ~165 TFLOP/s.
F32_TC_FLOPS = 494.7e12 / 3

# Phase 8: the fp32 kernels against their plain fp32 versions (TF32 off, so
# true fp32 products) on the same inputs. Both sides compute in fp32; the
# kernels' 3xTF32 products (~2^-21 relative each) sum in another order, so
# now and then a hidden relu's input lands on the other side of 0 in one of
# them, which moves that token's gradient by O(1). The backwards are held
# on the rays whose relu inputs all stay F32_MARGIN x rms away from 0
# (``walk_relu_margin``; the cotangent is zero on the others); the key
# stream's score relu is given the kernel forward's pattern. Planted faults
# (tools/torch_plant_faults.py "fp32"; PERF.md, Findings) read above these;
# phase 8 also prints what a single TF32 pass reads on the same inputs (the
# plain version with TF32 on), which must exceed them.
# Sound: forwards <= 1.03e-6, attn <= 7.6e-6, backwards <= 3.7e-5 (75-99 %
# of the rays held), wgrad 1.2e-6. The weakest fault each comparison
# catches: the products accumulated in the tensor cores' own accumulator
# (forwards 2.3e-5, attn 7.0e-5, backwards 8.4e-4, wgrad 5.3e-4) and a bf16
# stash (backwards 5.5e-4); one TF32 pass reads 2.9e-4 (wgrad) to 8.6e-4.
F32_FWD_REL = 1e-5
F32_ATTN_ABS = 3e-5
F32_BWD_REL = 1e-4
# The fp32 stream backwards on wgmma also hold their walk's gradients (W, b,
# LayerNorm) to a tighter bound: sound key <= 6.8e-6, value <= 1.7e-6; the
# products accumulated in the tensor cores' own accumulator across the
# whole K move the value's to 3.7e-5 (its geometry lanes stay under
# F32_BWD_REL). The key's walk gradients move by less than their sound
# spread (sums over 648,000 tokens, cancelling), so the key also holds the
# median ray of dqq, which reads its forward recompute's products: sound
# 9.6e-7, that fault 3.1e-6 (PERF.md, Findings). The plain key backward
# reads the kernel forward's raw dots (raw_saved), as the kernel does.
F32_BWD_WALK_REL = 2e-5
F32_DQQ_MEDIAN_REL = 2e-6
# A fault only in the reverse walk's products (dz_l W_l^T) moves neither dqq
# nor the last layer's gradients, and the per-ray statistics of d_rec /
# d_rayo / d_rays drown in the geometry backward's noise on this view
# (median ray of d_rec[0:3]: sound 2.16e-5, that fault 2.29e-5). The walk's
# input-side gradients, which the whole reverse chain feeds (b0 and the
# input LayerNorm's), resolve it: sound key <= 1.49e-6, value <= 1.46e-6;
# the reverse products in the tensor cores' own accumulator 6.56e-6 /
# 8.81e-6, the forward and reverse products so 3.67e-6 / 2.08e-5 (PERF.md,
# Findings).
F32_BWD_IN_REL = 3e-6
# The fp32 stream forwards on wgmma also hold the median ray's relative
# error (the key: raw; the value: fused), as phase 2's bf16 forwards do
# (PERF.md, Findings). So do the `true` mode's key and value embedder stacks:
# the value stack's sound median row reads 1.69e-6, too close to 2e-6. The
# feature forwards (rows 8f / 9f) read sound 7.80e-7 / 1.495e-6; their
# products in the tensor cores' own accumulator across K read 1.358e-6 /
# 1.226e-5 (the value catches it, the key alone would not;
# tools/torch_plant_faults.py "fp32 feat fwd wgmma").
F32_FWD_MEDIAN_REL = 3e-6
# The fp32 embedder's median row on the query stack (row 2f), as the `cuda`
# tests hold it (tools/torch_plant_faults.py "fp32 embed wgmma"): sound
# 6.11e-7; the products in the tensor cores' own accumulator 2.70e-6, which
# F32_FWD_MEDIAN_REL let through and this bound catches (PERF.md, Findings).
F32_EMBED_MEDIAN_REL = 2e-6
F32_MARGIN = 1e-5
F32_WGRAD_REL = 1e-5           # against the fp64 product of the operands
# The int8 walks beside fp32 compute against their plain versions, on
# Caterpillar's model: the int8 flips of I8_* above with the fp32 epilogue
# on both sides, held by the Frobenius norms (the attention's max abs is
# printed: on this model one flip moves a near-tie ray's weight by up to
# 3.4e-2) and by the median ray, which no flip reaches: fp32 noise, where a
# bf16 rounding in the epilogue moves every ray.
I8_F32_FUSED_REL = 1e-3
I8_F32_MEDIAN_REL = 1e-5
# The first training step, kernel path against the plain fp32 path, whole
# model: the relu flips are in here.
F32_STEP_LOSS_REL = 1e-4
F32_STEP_GRAD_REL = 1e-2
F32_FRAME_MIN_CLOSE = 0.999    # serving frame, pixels within 1/255
F32_FRAME_PSNR = 50.0
CATERPILLAR = "configs/t2/Caterpillar.yml"
CAT_STEPS = 10

H = W = 800
FOCAL = 700.0
BLOCK = 160               # eval-attention comparison block (160x160 rays)
PATCH = 160               # training patch edge (configs/default.yml patches)
TRAIN_STEPS = 5
STREAM_STEPS = 10         # timed steps per mode and round in phase 6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def orbit(theta: float, radius: float = 35.0) -> np.ndarray:
    """Camera on a y-axis orbit looking inward (bench.py:116-126)."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                   np.float32)
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [0, 0, radius]
    return rot @ base


def flagship_cfg(points: int = 30000, k: int = 20, amp: bool = True, **tpu):
    """The configs/default.yml model as bench.py:112 builds it."""
    from papr_tpu_torch.config import load_config
    return load_config(overrides={
        "use_amp": amp, "max_num_pts": points,
        "geoms": {"points": {"init_num": points, "select_k": k}},
        "tpu": {"ray_chunk": 4096, **tpu}})


def build_model(cfg, device):
    """create_model with seeded random influence scores, so the attention
    scores (relu(q.k) x influence) are not all zero as at a fresh init."""
    import torch
    from papr_tpu_torch.model.papr import create_model
    params, state = create_model(cfg, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    params["points_influ_scores"] = torch.randn(
        params["points_influ_scores"].shape, generator=g).to(device)
    return params, state


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n runs after one warm-up, by CUDA
    events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def query_walk(params, cfg):
    """The query embedder of ``params`` as a kernel walk (ray directions)."""
    from papr_tpu_torch.ops.fused_mlp import posenc_plan, walk_from_params
    e = cfg.models.attn.embed
    _, qcols = posenc_plan((3,), tuple(int(l) for l in e.q_L),
                           int(e.embed_type), float(e.pe_factor),
                           float(e.pe_mult_factor), 0)
    return walk_from_params(params["attn"]["embed_q"], e.query, qcols)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (inputs read once, outputs written once) over the
    memory rate and its operations over the peak rate for their type."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None}


def walk_flops(*walks_or_weights) -> float:
    """2 x (sum of in x out over the dense layers) per token."""
    total = 0
    for w in walks_or_weights:
        for m in (w.ws if hasattr(w, "ws") else (w,)):
            total += int(m.shape[0]) * int(m.shape[1])
    return 2.0 * total


def walk_bytes(*walks) -> int:
    from papr_tpu_torch.ops.fused_mlp import walk_tensors
    return sum(nbytes(*walk_tensors(w)) for w in walks)


def rel_fro(a, b) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).norm() / b.norm().clamp_min(1e-30)).item())


def eval_block_args(params, state, cfg, device):
    """The one-shot eval attention's arguments on the central 160x160 ray
    block of the orbit frame (``attend_eval_idx`` order), and its ray count."""
    import torch
    from papr_tpu_torch.model.papr import (_point_record, _record_walks,
                                           model_meta)
    from papr_tpu_torch.nn.mlp import linear_apply, policy_from_config
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import tile_cull as tc
    from papr_tpu_torch.ops.geometry import get_rays, normalize_vector

    policy = policy_from_config(cfg)
    cdt = policy.compute_dtype
    meta = model_meta(cfg)
    k = meta.select_k
    eps = float(cfg.eps)
    c2w = torch.as_tensor(orbit(0.0), device=device)
    focal = torch.tensor([FOCAL, FOCAL], device=device)
    rayo, rayd = get_rays(H, W, c2w, focal)
    points, alive = params["points"], state["alive"]
    M = int(cfg.get_path("tpu.cull_candidates", 2048))
    r0 = (H - BLOCK) // 2
    blk = rayd[r0:r0 + BLOCK, r0:r0 + BLOCK].contiguous()
    T = BLOCK * BLOCK
    idx = tc.select_topk_culled(points, alive, rayo[0], blk, k, M=M,
                                block=16, eps=eps, prefilter="packsort")
    record = _point_record(params, alive, meta, cfg.geoms.point_feats)
    rayd_flat = blk.reshape(T, 3)
    rayo_flat = rayo.expand(T, 3).contiguous()
    rays = normalize_vector(rayd_flat, eps=eps)
    eq = fm.fused_mlp(rayd_flat.contiguous(), query_walk(params, cfg), cdt)
    qq = linear_apply(params["attn"]["w_q"], eq, policy).float()
    kwalk, vwalk = _record_walks(params, cfg, meta)
    return (record, idx, rayo_flat, rays, qq, kwalk,
            params["attn"]["w_k"]["w"], params["attn"]["w_k"]["bias"], vwalk,
            cfg.models.attn.score_act, float(cfg.geoms.background.constant),
            bool(cfg.models.normalize_topk_attn), eps, cdt), T


K1_STAGE = 64         # candidates between K1's exit tests (csrc/cull_topk.cu)


def cull_scanned(tiles, f, recs, k: int, step: int, early_exit: bool,
                 batch: int = 64):
    """The candidates each tile's stage 3 scans with the early exit tested
    after every ``step`` (the exit decides on the data alone: after a prefix,
    every ray's k-th smallest distinct packed distance so far strictly below
    the packed lower bound of the next candidate), as a list of counts."""
    import torch
    from papr_tpu_torch.ops.tile_cull import smallest_packed
    from papr_tpu_torch.ops.topk import MAXI, VAL_MASK
    T = tiles.shape[0]
    M = recs.shape[-1]
    if not early_exit:
        return [M] * T
    out = []
    for s0 in range(0, T, batch):
        d, fr, rc = tiles[s0:s0 + batch], f[s0:s0 + batch], recs[s0:s0 + batch]
        done = torch.full((d.shape[0],), M, device=tiles.device)
        for e in range(step, M, step):
            kth = (smallest_packed(d, fr, rc[..., :e], k)[..., -1] if e >= k
                   else torch.full(d.shape[:2], MAXI, device=d.device))
            lb = rc[:, 5, e].contiguous().view(torch.int32) & VAL_MASK
            stop = (kth.amax(dim=-1) < lb) & (done == M)
            done = torch.where(stop, torch.full_like(done, e), done)
            if bool((done < M).all()):
                break
        out += [int(x) for x in done.tolist()]
    return out


def cull_bound(tiles, f, recs, k: int, scanned) -> dict:
    """K1's bound from the candidates its data needs scanned: their records
    (five 4-byte rows) with the rays, their scale and the output, or 9 fp32
    operations a (ray, candidate) pair, whichever is larger."""
    T, TR, _ = tiles.shape
    cand = float(sum(scanned))
    return bound(cand * 5 * 4 + (tiles.numel() + f.numel() + T * TR * k) * 4,
                 9.0 * TR * cand, FP32_FLOPS)


def cull_histogram(scanned, step: int, M: int) -> str:
    """"[n_1, n_2, ...]": tiles that scanned step, 2 step, .. candidates."""
    return str([sum(1 for c in scanned if c == e)
                for e in range(step, M + 1, step)])


# ------------------------------------------------------------------ phases --

def compare_kernels(params, state, cfg, device, n_time: int = 5) -> list:
    """Phase 2: each kernel against its plain version on the same inputs:
    K1 on the 800x800 frame, K3 on its central ray block (the embedder
    kernels: ``compare_embed_kernels``)."""
    import torch
    from papr_tpu_torch.model.papr import model_meta
    from papr_tpu_torch.ops import tile_cull as tc
    from papr_tpu_torch.ops.geometry import get_rays
    from papr_tpu_torch.ops.topk import VAL_MASK

    k = model_meta(cfg).select_k
    eps = float(cfg.eps)
    c2w = torch.as_tensor(orbit(0.0), device=device)
    focal = torch.tensor([FOCAL, FOCAL], device=device)
    rayo, rayd = get_rays(H, W, c2w, focal)
    points, alive = params["points"], state["alive"]
    results = []

    # K1: cull selection, full frame.
    M = int(cfg.get_path("tpu.cull_candidates", 2048))
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        points, alive, rayo[0], rayd, M=M, block=16, eps=eps,
        prefilter="packsort", early_exit=True)
    got = tc.cull_select(tiles, f, recs, k, chunk, ee)
    want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
    torch.cuda.synchronize()
    # Packed distance of each selected index, recomputed with the kernel's
    # formula, so differing rays can be shown to be near-ties.
    v = points.float() - rayo[0]
    vv = (v * v).sum(-1) + torch.where(alive, 0.0, float("inf"))

    def packed_vals(sel):
        g = sel.long().clamp_max(points.shape[0] - 1)
        pv = v[g]                                        # (T, TR, k, 3)
        d = tiles[:, :, None, :]
        t = (d[..., 0] * pv[..., 0] + d[..., 1] * pv[..., 1]
             + d[..., 2] * pv[..., 2])
        dist = torch.clamp_min(vv[g] - t * t * f[..., None], 0.0)
        return dist, dist.view(torch.int32) & VAL_MASK

    set_eq = (torch.sort(got, -1).values == torch.sort(want, -1).values).all(-1)
    frac_eq = float(set_eq.float().mean().item())
    d_got, q_got = packed_vals(got)
    d_want, q_want = packed_vals(want)
    ties_ok = bool((torch.sort(q_got, -1).values
                    == torch.sort(q_want, -1).values).all().item())
    k1_err = float((torch.sort(d_got, -1).values
                    - torch.sort(d_want, -1).values).abs().max().item())
    ms = cuda_ms(lambda: tc.cull_select(tiles, f, recs, k, chunk, ee), n_time)
    plain_ms = cuda_ms(
        lambda: tc.cull_select_plain(tiles, f, recs, k, chunk, ee), 2)
    # The early exit makes the work depend on the data: the candidates each
    # tile scans with the exit tested after every K1_STAGE (this kernel) and
    # after every chunk (the earlier kernel, the JAX kernel's granularity).
    M = recs.shape[-1]
    scanned = cull_scanned(tiles, f, recs, k, K1_STAGE, ee)
    scanned_chunk = cull_scanned(tiles, f, recs, k, chunk, ee)
    k1_bound = cull_bound(tiles, f, recs, k, scanned)
    print(f"phase 2 K1 cull_select: tiles={tuple(tiles.shape)} M={M} "
          f"k={k} chunk={chunk} early_exit={ee}: equal sets {frac_eq:.6f} "
          f"(need >= {K1_MIN_EQUAL}), other rays near-ties only: {ties_ok}, "
          f"max |dist diff| {k1_err:.3g}; kernel {ms:.3f} ms (earlier kernel "
          f"{K1_EARLIER_MS['serving']} ms), plain {plain_ms:.3f} ms; "
          f"candidates a tile scans, exit tested every {K1_STAGE}: "
          f"{cull_histogram(scanned, K1_STAGE, M)} tiles at {K1_STAGE}, "
          f"{2 * K1_STAGE}, .. (mean {sum(scanned) / len(scanned):.1f}); "
          f"every {chunk}: {cull_histogram(scanned_chunk, chunk, M)} (mean "
          f"{sum(scanned_chunk) / len(scanned_chunk):.1f}); bound from the "
          f"candidates scanned {k1_bound['bound_ms']:.4f} ms "
          f"({k1_bound['bound_by']}; the earlier granularity "
          f"{cull_bound(tiles, f, recs, k, scanned_chunk)['bound_ms']:.4f})",
          flush=True)
    if frac_eq < K1_MIN_EQUAL or not ties_ok:
        fail("K1 cull selection disagrees with its plain version")
    results.append({"name": "cull_select", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/cull_topk.cu",
                    "replaces": "papr_tpu/ops/tile_cull.py:110",
                    "max_abs_err": k1_err, "ms": ms, "plain_ms": plain_ms,
                    **k1_bound})

    # K3: eval attention on the central 160x160 ray block.
    results.append(compare_k3(params, state, cfg, device, n_time))
    compare_fwd_with_k3(params, state, cfg, device)
    return results


def compare_k3(params, state, cfg, device, n_time: int) -> dict:
    """Phase 2, K3: the one-shot eval attention on the central 160x160 ray
    block against its plain version."""
    import torch
    from papr_tpu_torch.model.papr import model_meta
    from papr_tpu_torch.ops import stream_attn as sa
    k = model_meta(cfg).select_k
    args, T = eval_block_args(params, state, cfg, device)
    record, idx, rayo_flat, rays, qq, kwalk, _, _, vwalk = args[:9]
    f_got, a_got = sa.attend_eval_idx(*args)
    f_want, a_want = sa.attend_eval_plain(*args)
    err = rel_fro(f_got, f_want)
    med = median_row_rels([f_got], [f_want])[0]
    ray_rel = lambda g, w: (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(
        1e-30)
    a_med = float(ray_rel(a_got, a_want).median())
    f_q05 = float(torch.quantile(ray_rel(f_got, f_want), 0.05))
    f_abs = float((f_got - f_want).abs().max().item())
    a_abs = float((a_got - a_want).abs().max().item())
    finite = bool(torch.isfinite(f_got).all() and torch.isfinite(a_got).all())
    ms = cuda_ms(lambda: sa.attend_eval_idx(*args), n_time)
    plain_ms = cuda_ms(lambda: sa.attend_eval_plain(*args), 2)
    gflop = 2.0 * T * k * sum(
        int(w.shape[0]) * int(w.shape[1])
        for w in kwalk.ws + vwalk.ws + (params["attn"]["w_k"]["w"],)) / 1e9
    k3_bound = bound(nbytes(record, idx, rayo_flat, rays, qq, f_got, a_got)
                     + walk_bytes(kwalk, vwalk), gflop * 1e9, BF16_FLOPS)
    t_med = FWD_MEDIAN_REL["attend_stream_eval"]
    print(f"phase 2 K3 attend_eval: T={T} K={k}: fused rel Frobenius "
          f"{err:.3e} (need <= {K3_REL}), median ray {med:.3e} (need <= "
          f"{t_med}), max abs {f_abs:.3e}; attn max abs "
          f"{a_abs:.3e} (need <= {K3_ATTN_ABS}), median attn ray {a_med:.3e} "
          f"(need <= {K3_ATTN_MEDIAN_REL}); fused at the 5th-percentile ray "
          f"{f_q05:.3e} (need <= {K3_FUSED_Q05_REL}); finite {finite}; kernel "
          f"{ms:.3f} ms ({gflop / ms:.1f} TFLOP/s of walk matmuls; earlier "
          f"WMMA kernel {K3_WMMA_MS} ms here, {K3_WMMA_FRAME_MS} ms an 800x800 "
          f"frame), bound {k3_bound['bound_ms']:.4f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    if not (err <= K3_REL and med <= t_med and a_abs <= K3_ATTN_ABS
            and a_med <= K3_ATTN_MEDIAN_REL and f_q05 <= K3_FUSED_Q05_REL
            and finite):
        fail("K3 eval attention disagrees with its plain version")
    return {"name": "attend_stream_eval", "route": "cuda",
            "source": "papr_tpu_torch/csrc/attend_eval.cu",
            "replaces": "papr_tpu/ops/stream_attn.py:1856",
            "max_abs_err": f_abs, "ms": ms, "plain_ms": plain_ms, **k3_bound}


def compare_fwd_with_k3(params, state, cfg, device) -> None:
    """Phase 2: the bf16 stream forwards against K3 on K3's ray block, the
    record gathered k-major by K3's indices (the three kernels run
    walk_wgmma.cuh's forward walk): the key forward's attention against
    K3's, and the value forward on K3's attention against K3's fused
    features (K3 sums with an online softmax, the value forward renormalizes
    the attention it is given)."""
    import torch
    from papr_tpu_torch.ops import stream_attn as sa
    args, T = eval_block_args(params, state, cfg, device)
    (record, idx, rayo_f, rays, qq, kwalk, wk, bk, vwalk, score_act, bkg,
     normalize, eps, cdt) = args
    fused3, attn3 = sa.attend_eval_idx(*args)
    rec = record[idx.T.long()].contiguous()               # (K, T, 128)
    attn = sa.key_stream_fwd(rec, rayo_f, rays, qq, kwalk, wk, bk, score_act,
                             bkg, eps, cdt)[0]
    fused = sa.value_stream_fwd(rec, rayo_f, rays, attn3, vwalk, normalize,
                                eps, cdt)
    same = torch.equal(attn, attn3)
    a_abs = float((attn - attn3).abs().max())
    f_rel = rel_fro(fused, fused3)
    print(f"phase 2 stream forwards against K3 (T={T} K={idx.shape[1]}): key "
          f"attn bit-equal to K3's {same} (need True; max abs {a_abs:.3e}); "
          f"value fused on K3's attn bit-equal to K3's "
          f"{torch.equal(fused, fused3)} (rel Frobenius {f_rel:.3e}, need <= "
          f"{K3_FUSED_REL})", flush=True)
    if not (same and f_rel <= K3_FUSED_REL):
        fail("the stream forwards disagree with K3 on K3's rays")
    del rec


def compare_f32_fwd_with_k3(eargs, rec) -> bool:
    """Phase 8: the fp32 stream forwards against the fp32 K3 on K3's rays,
    the record gathered k-major by K3's indices (``rec``; the three kernels
    run walk_wgmma.cuh's fp32 forward walk): the key forward's attention
    against K3's bit for bit (one walk, one softmax), and the value forward
    on K3's attention against K3's fused features within K3_FUSED_REL (K3
    sums with an online softmax, the value forward renormalizes the
    attention it is given)."""
    import torch
    from papr_tpu_torch.ops import stream_attn as sa
    (record, idx, rayo_f, rays, qq, kwalk, wk, bk, vwalk, score_act, bkg,
     normalize, eps) = eargs
    fused3, attn3 = sa.attend_eval_f32(*eargs)
    attn = sa.key_stream_f32_fwd(rec, rayo_f, rays, qq, kwalk, wk, bk,
                                 score_act, bkg, eps)[0]
    fused = sa.value_stream_f32_fwd(rec, rayo_f, rays, attn3, vwalk,
                                    normalize, eps)
    same = torch.equal(attn, attn3)
    a_abs = float((attn - attn3).abs().max())
    f_rel = rel_fro(fused, fused3)
    print(f"phase 8 fp32 stream forwards against the fp32 K3 (T="
          f"{idx.shape[0]} K={idx.shape[1]}): key attn bit-equal to K3's "
          f"{same} (need True; max abs {a_abs:.3e}); value fused on K3's "
          f"attn rel Frobenius {f_rel:.3e} (need <= {K3_FUSED_REL})",
          flush=True)
    return same and f_rel <= K3_FUSED_REL


def compare_feat_onehot(xv, vwalk, k0: int = 7) -> bool:
    """Phase 8: the fp32 value forward on raw features (row 9f, its wgmma
    walk) with the attention one-hot at slot k0 and normalize off, against
    the fp32 embedder (row 2f: the same wg_walk) on the rows xv[k0]: one
    weight of 1 and K - 1 of 0, so the fuse adds nothing to the walk's
    rows, which must come out bit-equal."""
    import torch
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_feat as sf
    K, T, _ = xv.shape
    onehot = torch.zeros(T, K + 1, device=xv.device)
    onehot[:, k0] = 1.0
    fused = sf.value_stream_feat_fwd(xv, onehot, vwalk, False, torch.float32)
    rows = fm.fused_mlp_f32(xv[k0].contiguous(), vwalk)
    same = torch.equal(fused, rows)
    print(f"phase 8 value_stream_feat_f32_fwd on a one-hot attn (slot {k0}, "
          f"normalize off) against fused_mlp_f32 on xv[{k0}] (T={T}): "
          f"bit-equal {same} (need True; max abs "
          f"{float((fused - rows).abs().max()):.3e})", flush=True)
    return same


def compare_cli_kernels(params, state, cfg, device, n_time: int = 3) -> list:
    """Phase 2, the command-line path's kernels at the 160x160 patch
    (T = 25,600 rays, K = 20, 30,000 points): the streaming top-k, and the
    fused attention scores forward and backward on the key / query
    embeddings the fused embedder gives for those rays. Also times the dW
    reduction (``csrc/wgrad.cu``) beside one ``torch.matmul`` on the same
    bf16 operands."""
    import torch
    from papr_tpu_torch.model.papr import _split_embeddings, model_meta
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import pallas_topk as pt

    policy = policy_from_config(cfg)
    cdt = policy.compute_dtype
    meta = model_meta(cfg)
    k = meta.select_k
    eps = float(cfg.eps)
    points, alive = params["points"], state["alive"]
    rayo, rayd = training_patch(device)
    T = PATCH * PATCH
    gen = torch.Generator(device=device).manual_seed(6)
    results, failed = [], []

    # A: streaming top-k over every point.
    ops_in = pt.stream_inputs(points, alive, rayo[0], rayd.reshape(T, 3), eps)
    got = pt.topk_stream(*ops_in, k)
    want = pt.topk_stream_plain(*ops_in, k)
    torch.cuda.synchronize()
    frac = float((got == want).all(-1).float().mean())
    n_diff = int((got != want).sum())
    ms = cuda_ms(lambda: pt.topk_stream(*ops_in, k), n_time)
    plain_ms = cuda_ms(lambda: pt.topk_stream_plain(*ops_in, k), 1)
    work = bound(nbytes(*ops_in, got), 9.0 * T * ops_in[3].shape[0],
                 FP32_FLOPS)
    print(f"phase 2 topk_stream: R={T} P={points.shape[0]} (padded "
          f"{ops_in[3].shape[0]}) k={k}: equal rows {frac:.6f} (need >= "
          f"{TOPK_MIN_EQUAL}), differing entries {n_diff}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {work['bound_ms']:.4f} ms "
          f"({work['bound_by']})", flush=True)
    if frac < TOPK_MIN_EQUAL:
        failed.append("topk_stream")
    results.append({"name": "topk_stream", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/topk_stream.cu",
                    "replaces": "papr_tpu/ops/pallas_topk.py:45",
                    "max_abs_err": float(n_diff), "ms": ms,
                    "plain_ms": plain_ms, **work})

    # B, C: fused scores on real embeddings.
    idx = pt.pallas_select_topk(points, alive, rayo[0], rayd.reshape(T, 3), k,
                                eps).reshape(1, PATCH, PATCH, k)
    with torch.no_grad():
        ek, eq, _, influ, sel_alive = _split_embeddings(
            params, cfg, meta, idx, rayo, rayd, alive, eps, policy, True)
    a = params["attn"]
    args = (ek.contiguous(), eq.contiguous(), a["w_k"]["w"], a["w_k"]["bias"],
            a["w_q"]["w"], a["w_q"]["bias"], influ.float().contiguous(),
            sel_alive.float())
    opts = (cfg.models.attn.score_act, float(cfg.geoms.background.constant),
            cdt)
    Dk, dm = int(ek.shape[-1]), int(a["w_k"]["w"].shape[0])
    proj_flops = 2.0 * T * (k + 1) * Dk * dm
    attn_g, raw_g = fa.fused_scores_fwd(*args, *opts, with_raw=True)
    attn_w, raw_w = fa.fused_scores_plain(*args, *opts)
    torch.cuda.synchronize()
    a_abs = float((attn_g - attn_w).abs().max())
    raw_rel = rel_fro(raw_g, raw_w)
    finite = bool(torch.isfinite(attn_g).all())
    ms = cuda_ms(lambda: fa.fused_scores_fwd(*args, *opts), n_time)
    plain_ms = cuda_ms(lambda: fa.fused_scores_plain(*args, *opts), 1)
    work = bound(nbytes(*args, attn_g), proj_flops, BF16_FLOPS)
    print(f"phase 2 fused_scores_fwd: T={T} K={k} Dk={Dk} dm={dm}: attn max "
          f"abs {a_abs:.3e} (need <= {SCORE_ATTN_ABS}), raw rel Frobenius "
          f"{raw_rel:.3e} (need <= {SCORE_RAW_REL}); finite {finite}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{work['bound_ms']:.4f} ms ({work['bound_by']})", flush=True)
    if not (finite and a_abs <= SCORE_ATTN_ABS and raw_rel <= SCORE_RAW_REL):
        failed.append("fused_scores_fwd")
    results.append({"name": "fused_scores_fwd", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/fused_attn.cu",
                    "replaces": "papr_tpu/ops/fused_attn.py:116",
                    "max_abs_err": a_abs, "ms": ms, "plain_ms": plain_ms,
                    **work})

    dattn = torch.randn(T, k + 1, generator=gen, device=device)
    relu_on = raw_g > 0       # the plain backward takes the kernel's pattern
    g = fa.fused_scores_bwd(*args, dattn, *opts)
    w = fa.fused_scores_bwd_plain(*args, dattn, *opts, relu_on=relu_on)
    torch.cuda.synchronize()
    labels = ["d_embedk", "d_embedq", "dW_k", "db_k", "dW_q", "db_q",
              "d_influ"]
    rels = _rels(g, w)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in g)
    ms = cuda_ms(lambda: fa.fused_scores_bwd(*args, dattn, *opts), n_time)
    plain_ms = cuda_ms(lambda: fa.fused_scores_bwd_plain(
        *args, dattn, *opts, relu_on=relu_on), 1)
    work = bound(nbytes(*args, dattn, *g), 3 * proj_flops, BF16_FLOPS)
    print(f"phase 2 fused_scores_bwd: T={T} K={k}: rel Frobenius "
          + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, rels))
          + f" (max {max(rels):.3e}, need <= {SCORE_BWD_REL}); finite "
          f"{finite}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{work['bound_ms']:.4f} ms ({work['bound_by']})", flush=True)
    if not (finite and max(rels) <= SCORE_BWD_REL):
        failed.append("fused_scores_bwd")
    results.append({"name": "fused_scores_bwd", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/fused_attn.cu",
                    "replaces": "papr_tpu/ops/fused_attn.py:125",
                    "max_abs_err": _max_abs(g, w), "max_rel_err": max(rels),
                    "ms": ms, "plain_ms": plain_ms, **work})

    # The dW reduction beside the one PyTorch call that computes the same
    # function: dW = H^T DZ over K * T tokens of bf16 operands.
    hmat = ek.reshape(k * T, Dk).contiguous()
    dz = torch.randn(k * T, dm, generator=gen, device=device).to(torch.bfloat16)
    res = wgrad_check(device, hmat, dz, n_time)
    if res["max_rel_err"] > WGRAD_REL or not res.pop("bit_equal"):
        failed.append("wgrad")
    results.append(res)
    # The fp32 form beside it, on random operands at phase 8's shape (its
    # kernels-line entry is phase 8's, on Caterpillar's stash shapes).
    del hmat, dz
    h32 = torch.randn(648_000, 256, generator=gen, device=device)
    dz32 = torch.randn(648_000, 256, generator=gen, device=device)
    res = wgrad_check(device, h32, dz32, n_time)
    if res["max_rel_err"] > F32_WGRAD_REL or not res["bit_equal"]:
        failed.append("wgrad_f32")
    del h32, dz32
    del ek, eq, g, w
    torch.cuda.empty_cache()

    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
    return results


def wgrad_check(device, hmat, dz, n_time: int, phase: int = 2) -> dict:
    """dW = H^T DZ through ``fm.wgrad`` (bf16 operands, against their fp32
    product) or ``fm.wgrad_f32`` (fp32 operands, against their fp64
    product): error, two runs bit-equal, kernel time beside one
    ``torch.matmul`` on the same operands and the bound. Returns the
    kernels-line entry with ``bit_equal``."""
    import torch
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import fused_mlp as fm
    f32 = hmat.dtype == torch.float32
    (N, da), db = hmat.shape, dz.shape[1]
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = fm.wgrad_f32 if f32 else fm.wgrad
    run = lambda: fn(lib, hmat.data_ptr(), dz.data_ptr(), N, da, db, device,
                     stream)
    plain = ((lambda: (hmat.double().T @ dz.double()).float()) if f32 else
             (lambda: torch.matmul(hmat.float().T, dz.float())))
    got, want = run(), plain()
    err = rel_fro(got, want)
    same = bool(torch.equal(got, run()))
    ms, plain_ms = cuda_ms(run, n_time), cuda_ms(plain, 1)
    lib_ms = cuda_ms(lambda: torch.matmul(hmat.T, dz), n_time)
    work = bound(nbytes(hmat, dz, got), (3.0 if f32 else 1.0) * 2.0 * N * da
                 * db, F32_TC_FLOPS * 3 if f32 else BF16_FLOPS)
    work["library_ms"] = lib_ms
    name = "wgrad_f32" if f32 else "wgrad"
    print(f"phase {phase} {name} (dW = H^T DZ, N={N}, {da}x{db}, "
          f"{hmat.dtype} operands): rel Frobenius {err:.3e} (need <= "
          f"{F32_WGRAD_REL if f32 else WGRAD_REL}) against the "
          f"{'fp64' if f32 else 'fp32'} product; two runs bit-equal {same}; "
          f"kernel {ms:.3f} ms (earlier WMMA kernel "
          f"{WGRAD_F32_WMMA_MS if f32 else WGRAD_WMMA_MS} ms), plain "
          f"{plain_ms:.3f} ms, torch.matmul on the same operands "
          f"{lib_ms:.3f} ms, bound {work['bound_ms']:.4f} ms "
          f"({work['bound_by']})", flush=True)
    return {"name": name, "route": "cuda",
            "source": "papr_tpu_torch/csrc/wgrad.cu",
            "replaces": "papr_tpu/ops/fused_mlp.py:424 (the dW accumulation "
                        "of every TPU backward body)",
            "max_abs_err": _max_abs([got], [want]), "max_rel_err": err,
            "ms": ms, "plain_ms": plain_ms, "bit_equal": same, **work}


def compare_wgmma_kernels(params, state, cfg, device, n_time: int = 1):
    """The two wgmma designs alone (``tools/torch_plant_faults.py``): K3 on
    phase 2's eval block, ``wgrad`` on random bf16 operands at phase 2's
    shape and ``wgrad_f32`` on random fp32 operands at phase 8's."""
    import torch
    gen = torch.Generator(device=device).manual_seed(6)
    compare_k3(params, state, cfg, device, n_time)
    for N, cdt in ((512_000, torch.bfloat16), (648_000, torch.float32)):
        hmat = torch.randn(N, 256, generator=gen, device=device).to(cdt)
        dz = torch.randn(N, 256, generator=gen, device=device).to(cdt)
        res = wgrad_check(device, hmat, dz, n_time,
                          8 if cdt == torch.float32 else 2)
        tol = F32_WGRAD_REL if cdt == torch.float32 else WGRAD_REL
        if res["max_rel_err"] > tol or not res["bit_equal"]:
            fail(f"{res['name']} disagrees with its plain version")
        del hmat, dz
        torch.cuda.empty_cache()


def training_patch(device, seed: int = 0):
    """A 160x160 crop, at a seeded offset, of the orbit camera's 800x800
    rays (focal 700): coherent pixel tiles, as a training patch is.
    Returns rays_o (1, 3), rays_d (1, 160, 160, 3) on the card."""
    import torch
    from papr_tpu_torch.ops.geometry import get_rays
    rng = np.random.default_rng(seed)
    y0, x0 = (int(v) for v in rng.integers(0, H - PATCH, 2))
    c2w = torch.as_tensor(orbit(0.0), device=device)
    focal = torch.tensor([FOCAL, FOCAL], device=device)
    rayo, rayd = get_rays(H, W, c2w, focal)
    return rayo, rayd[y0:y0 + PATCH, x0:x0 + PATCH][None].contiguous()


def _rels(got, want) -> list:
    """Relative Frobenius error of each output; where the plain output is
    all zero, 0 if the kernel's is too, else inf."""
    return [rel_fro(g, w) if float(w.abs().max()) > 0
            else (0.0 if float(g.abs().max()) == 0 else float("inf"))
            for g, w in zip(got, want)]


def _max_abs(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def walk_labels(walk) -> list:
    """Names of a walk's gradients, in walk_tensors order."""
    n = len(walk.ws)
    return ([f"W{i}" for i in range(n)] + [f"b{i}" for i in range(n)]
            + [f"{ln}.{p}" for ln in ("ln_in", "ln_out")
               if getattr(walk, ln) is not None for p in "ab"])


def rec_lanes(grads) -> list:
    """d_rec (first of ``grads``) split by routing rule: the geometry
    gradient (lanes 0:3), d_influence (lane 3), the rest (alive lane and
    point features)."""
    d = grads[0]
    return [d[..., :3], d[..., 3], d[..., 4:]] + list(grads[1:])


REC_LABELS = ["d_rec[0:3]", "d_rec[3]", "d_rec[4:]"]


def median_rels(got, want, n_walk: int) -> tuple:
    """Of a stream backward's ``rec_lanes`` outputs: (the median over rays of
    d_rec's relative error, each ray's K x lanes entries together; the
    median over the rows of the last ``n_walk`` outputs, the walk
    gradients). Rays and rows whose plain value is 0 are left out."""
    import torch

    def med(d, n):
        keep = n > 0
        return float((d[keep] / n[keep]).median())

    def per_ray(lanes):
        x = torch.cat([t.reshape(t.shape[0], t.shape[1], -1) for t in lanes],
                      -1)
        return x.transpose(0, 1).reshape(x.shape[1], -1)

    g, w = per_ray(got[:3]), per_ray(want[:3])
    rec = med((g - w).norm(dim=-1), w.norm(dim=-1))
    rows = lambda t: t.reshape(t.shape[0], -1) if t.dim() > 1 else t[:, None]
    d = torch.cat([(rows(a) - rows(b)).norm(dim=-1)
                   for a, b in zip(got[-n_walk:], want[-n_walk:])])
    n = torch.cat([rows(b).norm(dim=-1) for b in want[-n_walk:]])
    return rec, med(d, n)


def median_row_rels(got, want) -> list:
    """Per output, the median over its rows (a vector: its entries) of each
    row's relative error; rows whose plain value is 0 are left out."""
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if g.dim() == 1:
            g, w = g[:, None], w[:, None]
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        d, n = (g - w).norm(dim=-1), w.norm(dim=-1)
        keep = n > 0
        out.append(float((d[keep] / n[keep]).median()) if bool(keep.any())
                   else 0.0)
    return out


def db_rels(got, ref, walk) -> list:
    """Each layer's bias gradient's relative Frobenius error, from outputs
    that end in the walk's gradients (``walk_tensors`` order)."""
    from papr_tpu_torch.ops import fused_mlp as fm
    n = len(walk.ws)
    b0 = len(got) - len(fm.walk_tensors(walk)) + n
    return [rel_fro(a, b) for a, b in zip(got[b0:b0 + n], ref[b0:b0 + n])]


def compare_embed_kernels(params, state, cfg, device, n_time: int = 5):
    """Phase 2, the embedder kernels against their plain versions on the
    main path's inputs: the forward K2 on the query stack at the 800x800
    frame's 640,000 rays; the backward (row 3) on the query stack at the
    160x160 training patch's 25,600 rays; both on the key and value stacks
    of ``fused_attn: true`` at that patch (K * T = 512,000 tokens, the
    geometry features and the point-feature pass-through columns, as the
    path's own head builds them). Each: the call and the kernel alone (its
    profiler span) beside the WMMA kernel's times (WMMA_MS) and the bound;
    the forward's median row; the backward's median dx row and bias
    gradients at the kernel's rounding points. Returns ([K2 record, row-3
    record], the stacks' readings by kernel name)."""
    import torch
    from papr_tpu_torch.model.papr import _split_embeddings, model_meta
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import pallas_topk as pt
    from papr_tpu_torch.ops.geometry import get_rays

    policy = policy_from_config(cfg)
    cdt = policy.compute_dtype
    meta = model_meta(cfg)
    eps = float(cfg.eps)
    gen = torch.Generator(device=device).manual_seed(7)
    qwalk = query_walk(params, cfg)
    c2w = torch.as_tensor(orbit(0.0), device=device)
    focal = torch.tensor([FOCAL, FOCAL], device=device)
    frame = get_rays(H, W, c2w, focal)[1].reshape(-1, 3).contiguous()
    rayo, rayd = training_patch(device)
    T = PATCH * PATCH
    patch = rayd.reshape(T, 3).contiguous()
    # The key and value stacks' inputs as the path's own head builds them.
    stacks, apply = [], fm.fused_mlp_apply

    def recording(x, walk, cdt):
        stacks.append((x.detach().contiguous(), walk))
        return apply(x, walk, cdt)

    idx = pt.pallas_select_topk(params["points"], state["alive"], rayo[0],
                                patch, meta.select_k, eps).reshape(
                                    1, PATCH, PATCH, meta.select_k)
    fm.fused_mlp_apply = recording
    try:
        with torch.no_grad():
            _split_embeddings(params, cfg, meta, idx, rayo, rayd,
                              state["alive"], eps, policy, True)
    finally:
        fm.fused_mlp_apply = apply
    by_name = dict(zip(("key", "query", "value"), stacks))
    failed, records, out_stacks = [], {}, {"fused_mlp": {}, "fused_mlp_bwd": {}}

    def timing(fn, plain, pattern, key, work):
        ms = cuda_ms(fn, n_time)
        alone = kernel_span_ms(fn, pattern)
        plain_ms = cuda_ms(plain, 1)
        old_call, old_alone = WMMA_MS[key]
        line = (f"kernel {ms:.3f} ms (alone {alone:.3f}; the earlier WMMA "
                f"kernel: call {old_call} ms, alone {old_alone} ms), bound "
                f"{work['bound_ms']:.4f} ms ({work['bound_by']}), plain "
                f"{plain_ms:.3f} ms")
        return {"ms": ms, "kernel_alone_ms": alone, "plain_ms": plain_ms,
                "wmma_ms": old_call, "wmma_alone_ms": old_alone}, line

    def forward(label, key, x, walk, tol):
        got = fm.fused_mlp(x, walk, cdt)
        want = fm.fused_mlp_plain(x, walk, cdt)
        err, med = rel_fro(got, want), median_row_rels([got], [want])[0]
        y_abs = float((got.float() - want.float()).abs().max())
        t_med = FWD_MEDIAN_REL["fused_mlp"]
        ok = (err <= tol and med <= t_med
              and bool(torch.isfinite(got.float()).all()))
        work = bound(nbytes(x, got) + walk_bytes(walk),
                     x.shape[0] * walk_flops(walk), BF16_FLOPS)
        times, line = timing(lambda: fm.fused_mlp(x, walk, cdt),
                             lambda: fm.fused_mlp_plain(x, walk, cdt),
                             "fused_mlp_fwd", key, work)
        print(f"phase 2 {label}: x={tuple(x.shape)} -> {tuple(got.shape)} "
              f"{got.dtype}: rel Frobenius {err:.3e} (need <= {tol}), median "
              f"row {med:.3e} (need <= {t_med}), max abs {y_abs:.3e}; {line}",
              flush=True)
        if not ok:
            failed.append(label)
        return {"max_abs_err": y_abs, "max_rel_err": err, "median_rel": med,
                **times, **work}

    def backward(label, key, x, walk, tol, split=lambda g: g):
        d_out = int(walk.ws[-1].shape[1])
        # The cotangent of a bf16 output: bf16 values (both sides read it so).
        dy = torch.randn(x.shape[0], d_out, generator=gen,
                         device=device).to(cdt).float()
        run = lambda: fm.fused_mlp_bwd(x, dy, walk, cdt)
        g = run()
        w = fm.fused_mlp_bwd_plain(x, dy, walk, cdt)
        ref = fm.fused_mlp_bwd_plain(x, dy, walk, cdt, kernel_grads=True)
        torch.cuda.synchronize()
        gl, wl = split([g[0]] + g[1]), split([w[0]] + w[1])
        labels = (["dx"] if len(gl) == len(g[1]) + 1
                  else ["dx[geometry]", "dx[point features]"]) \
            + walk_labels(walk)
        rels = _rels(gl, wl)
        finite = all(bool(torch.isfinite(t).all()) for t in gl)
        m_dx = median_row_rels([g[0]], [ref[0]])[0]
        dbs = db_rels([g[0]] + g[1], [ref[0]] + ref[1], walk)
        t_dx, t_db = EMBED_DX_MEDIAN_REL, DB_REL["fused_mlp_bwd"]
        ok = (finite and max(rels) <= tol and len(rels) == len(labels)
              and m_dx <= t_dx and dbs[-1] <= t_db)
        work = bound(nbytes(x, dy, g[0], *g[1]) + walk_bytes(walk),
                     3 * x.shape[0] * walk_flops(walk), BF16_FLOPS)
        times, line = timing(run, lambda: fm.fused_mlp_bwd_plain(x, dy, walk,
                                                                 cdt),
                             "fused_mlp_bwd", key, work)
        print(f"phase 2 {label}: x={tuple(x.shape)}: rel Frobenius "
              + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, rels))
              + f" (max {max(rels):.3e}, need <= {tol}); at the kernel's "
              f"rounding points: median dx row {m_dx:.3e} (need <= {t_dx}), "
              "db per layer " + ", ".join(f"{r:.2e}" for r in dbs)
              + f" (the last need <= {t_db}); finite {finite}; {line}",
              flush=True)
        if not ok:
            failed.append(label)
        return {"max_abs_err": _max_abs(gl, wl), "max_rel_err": max(rels),
                "median_rel": m_dx, "db_rel": dbs[-1], **times, **work}

    r = forward("K2 fused_mlp (query embedder)", "fused_mlp", frame, qwalk,
                K2_REL)
    records["fused_mlp"] = {"name": "fused_mlp", "route": "cuda",
                            "source": "papr_tpu_torch/csrc/fused_mlp.cu",
                            "replaces": "papr_tpu/ops/fused_mlp.py:417", **r}
    r = backward("fused_mlp_bwd (query embedder)", "fused_mlp_bwd", patch,
                 qwalk, BWD_REL)
    records["fused_mlp_bwd"] = {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "papr_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "papr_tpu/ops/fused_mlp.py:424", **r}
    del frame
    torch.cuda.empty_cache()
    for name in ("key", "value"):
        x, walk = by_name[name]
        # Raw columns the posenc encodes (geometry); the rest pass through.
        n_geo = 1 + max(c[0] for c in walk.cols if c[2] == 1)
        extras = n_geo < x.shape[1]
        r = forward(f"fused_mlp ({name} stack, {n_geo} geometry + "
                    f"{x.shape[1] - n_geo} point-feature columns)",
                    f"fused_mlp {name} stack", x, walk, STACK_FWD_REL)
        out_stacks["fused_mlp"][name] = {"tokens": int(x.shape[0]),
                                         "d_raw": int(x.shape[1]), **r}
        split = lambda g: ([g[0][:, :n_geo]]
                           + ([g[0][:, n_geo:]] if extras else []) + g[1:])
        r = backward(f"fused_mlp_bwd ({name} stack)",
                     f"fused_mlp_bwd {name} stack", x, walk, STACK_BWD_REL,
                     split)
        out_stacks["fused_mlp_bwd"][name] = {"tokens": int(x.shape[0]),
                                             "d_raw": int(x.shape[1]), **r}
        torch.cuda.empty_cache()
    if failed:
        fail(f"embedder kernels disagree with their plain versions: {failed}")
    return [records["fused_mlp"], records["fused_mlp_bwd"]], out_stacks


def stream_patch_inputs(params, state, cfg, rayo, rayd):
    """The record-native streams' inputs on a training patch, as the model's
    own head builds them: the selection (T, K), the (P, 128) record, its
    k-major gather rec (K, T, 128), rays, the projected query and the key /
    value walks."""
    from papr_tpu_torch.model.papr import _kernel_inputs, model_meta
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import tile_cull as tc

    meta = model_meta(cfg)
    eps = float(cfg.eps)
    alive = state["alive"]
    idx = tc.select_topk_culled(params["points"], alive, rayo[0], rayd[0],
                                meta.select_k, M=2048, block=16, eps=eps,
                                prefilter="approx")
    record, rayo_f, rays, rayd_f, qq, kwalk, vwalk = _kernel_inputs(
        params, cfg, meta, rayo, rayd, alive, eps, policy_from_config(cfg))
    rec = record[idx.T.long()].contiguous()               # (K, T, 128)
    return idx, record, rec, rayo_f, rays, rayd_f, qq.detach(), kwalk, vwalk


def compare_train_kernels(params, state, cfg, device, n_time: int = 3) -> dict:
    """Phase 2, training shapes: the selection at its training shape and
    the training kernel bodies against their plain versions on the 160x160
    patch (T = 25,600 rays, K = 20): the record-native key / value streams
    (the embedder backward: ``compare_embed_kernels``), the key stream with
    the query chain
    folded in, and the key / value streams on raw feature tensors, forward
    and backward each. Every case runs and prints before the phase fails on
    any of them."""
    import torch
    from papr_tpu_torch.model.papr import _stream_inputs, model_meta
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf
    from papr_tpu_torch.ops import tile_cull as tc

    cdt = policy_from_config(cfg).compute_dtype
    meta = model_meta(cfg)
    k = meta.select_k
    eps = float(cfg.eps)
    score_act = cfg.models.attn.score_act
    bkg = float(cfg.geoms.background.constant)
    normalize = bool(cfg.models.normalize_topk_attn)
    points, alive = params["points"], state["alive"]
    rayo, rayd = training_patch(device)
    T = PATCH * PATCH
    gen = torch.Generator(device=device).manual_seed(3)
    out, failed = {}, []

    # K1 at the training shape: approx (exact top-k) prefilter, no early
    # exit, one 2048-wide chunk.
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        points, alive, rayo[0], rayd[0], M=2048, block=16, eps=eps,
        prefilter="approx", early_exit=True)
    got = tc.cull_select(tiles, f, recs, k, chunk, ee)
    want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
    frac = float((torch.sort(got, -1).values == torch.sort(want, -1).values)
                 .all(-1).float().mean().item())
    ms = cuda_ms(lambda: tc.cull_select(tiles, f, recs, k, chunk, ee), n_time)
    plain_ms = cuda_ms(
        lambda: tc.cull_select_plain(tiles, f, recs, k, chunk, ee), 1)
    tb = cull_bound(tiles, f, recs, k, cull_scanned(tiles, f, recs, k,
                                                    K1_STAGE, ee))
    print(f"phase 2 K1 cull_select (training): tiles={tuple(tiles.shape)} "
          f"M={recs.shape[-1]} chunk={chunk} early_exit={ee}: equal sets "
          f"{frac:.6f} (need >= {K1_TRAIN_MIN_EQUAL}); kernel {ms:.3f} ms "
          f"(earlier kernel {K1_EARLIER_MS['training']} ms), plain "
          f"{plain_ms:.3f} ms, bound {tb['bound_ms']:.4f} ms ({tb['bound_by']}: every "
          f"candidate scanned)", flush=True)
    if chunk != 2048 or ee or frac < K1_TRAIN_MIN_EQUAL:
        failed.append("cull_select (training shape)")
    out["cull_select"] = {"equal_sets_train": frac, "ms_train": ms,
                          "plain_ms_train": plain_ms,
                          "bound_ms_train": tb["bound_ms"]}

    idx, record, rec, rayo_f, rays, rayd_f, qq, kwalk, vwalk = \
        stream_patch_inputs(params, state, cfg, rayo, rayd)
    wk = params["attn"]["w_k"]["w"]
    bk = params["attn"]["w_k"]["bias"]
    qwalk = query_walk(params, cfg)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)

    def record_case(name, source, replaces, fn, plain, tol, labels, in_bytes,
                    flops, fwd_tol=None, n_walk=0, span=None, median=None,
                    db=None):
        """Kernel against its plain version (the same bf16 compute): every
        output's relative Frobenius error held to ``tol``. ``in_bytes`` and
        ``flops`` (bf16 tensor-core work) give the bound; the outputs' bytes
        are added here. With ``n_walk`` (the stream backwards on wgmma), the
        medians of ``median_rels`` are held to BWD_MEDIAN_REL[name]; with
        ``median`` (an output's index: the forwards on wgmma) that output's
        median row to FWD_MEDIAN_REL[name]; with ``db`` ((the plain version
        at the kernel's rounding points, the walk): the backwards on wgmma)
        the walk's last bias gradient to DB_REL[name], every layer's
        printed; with ``span`` (a kernel name pattern: the wgmma kernel and
        the small kernel launched after it) the kernel alone is timed too
        (its profiler span), and the bound and the WMMA kernel's times
        printed beside."""
        g = fn()
        w = plain()
        torch.cuda.synchronize()
        rels = _rels(g, w)
        finite = all(bool(torch.isfinite(t).all()) for t in g)
        ms = cuda_ms(fn, n_time)
        p_ms = cuda_ms(plain, 1)
        worst = max(rels)
        ok = finite and worst <= tol and len(rels) == len(labels)
        line = (f"phase 2 {name}: T={T} K={k}: rel Frobenius "
                + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, rels))
                + f" (max {worst:.3e}, need <= {tol}); finite {finite}")
        if n_walk:
            m_rec, m_walk = median_rels(g, w, n_walk)
            t_rec, t_walk = BWD_MEDIAN_REL[name]
            line += (f"; median ray d_rec rel {m_rec:.3e} (need <= {t_rec}), "
                     f"median row of the walk gradients {m_walk:.3e} (need "
                     f"<= {t_walk})")
            ok &= m_rec <= t_rec and m_walk <= t_walk
        if median is not None:
            med = median_row_rels([g[median]], [w[median]])[0]
            line += (f"; median ray {labels[median]} rel {med:.3e} (need <= "
                     f"{FWD_MEDIAN_REL[name]})")
            ok &= med <= FWD_MEDIAN_REL[name]
        if db is not None:
            ref = db[0]()
            dbs = db_rels(g, ref, db[1])
            line += ("; db per layer at the kernel's rounding points "
                     + ", ".join(f"{r:.2e}" for r in dbs)
                     + f" (the last need <= {DB_REL[name]})")
            ok &= dbs[-1] <= DB_REL[name]
        work = bound(in_bytes + nbytes(*g), flops, BF16_FLOPS)
        line += f"; kernel {ms:.3f} ms, plain {p_ms:.3f} ms"
        alone = None
        if span is not None:
            ran = []
            alone = kernel_span_ms(fn, span, names=ran)
            old_call, old_alone = WMMA_MS[name]
            line += (f"; kernel alone {alone:.3f} ms ({' + '.join(ran)}; the "
                     f"rest of the call {ms - alone:.3f} ms: packs, host, a "
                     f"backward's wgrad and colsum), bound "
                     f"{work['bound_ms']:.4f} ms ({work['bound_by']}); the "
                     f"earlier WMMA kernel: call {old_call} ms, alone "
                     f"{old_alone} ms")
        print(line, flush=True)
        if not ok:
            failed.append(name)
        if fwd_tol is not None:
            a_abs = float((g[0] - w[0]).abs().max())
            print(f"phase 2 {name}: attn max abs {a_abs:.3e} (need <= "
                  f"{fwd_tol})", flush=True)
            if not a_abs <= fwd_tol:
                failed.append(name + " attn")
        out[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": _max_abs(g, w),
                     "max_rel_err": worst, "ms": ms, "plain_ms": p_ms, **work}
        if alone is not None:
            out[name]["kernel_alone_ms"] = alone
        return g

    kargs = (rec, rayo_f, rays, qq, kwalk, wk, bk)
    kopts = (score_act, bkg, eps, cdt)
    attn, raw = record_case(
        "key_stream_fwd", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:798",
        lambda: list(sa.key_stream_fwd(*kargs, *kopts))[:2],
        lambda: list(sa.key_stream_plain(*kargs, *kopts))[:2], FWD_REL,
        ["attn", "raw"], nbytes(rec, rayo_f, rays, qq) + walk_bytes(kwalk),
        T * k * walk_flops(kwalk, wk), span="key_fwd_", median=1)
    # The saved scores: exactly act(raw) x influence of the kernel's own
    # raw, and against the plain version's on the alive scores whose relu
    # both forwards agree on (the rest differ by a switched-off score).
    ss = sa.key_stream_fwd(*kargs, *kopts)[2]
    _, raw_p, ss_p = sa.key_stream_plain(*kargs, *kopts)
    live = rec[..., 4].T > 0.5
    sact = torch.clamp_min(raw, 0.0) if score_act == "relu" else raw
    exact = torch.equal(ss, torch.where(live, sact * rec[..., 3].T,
                                        sa.NEG_BIG))
    same = (raw > 0) == (raw_p > 0) if score_act == "relu" else live
    agree = float(same[live].float().mean())
    ss_rel = rel_fro(ss[live & same], ss_p[live & same])
    print(f"phase 2 key_stream_fwd saved scores: ss == act(raw) x influence "
          f"{exact}; alive scores whose relu pattern agrees {agree:.6f} "
          f"(need >= {RELU_MIN_AGREE}); ss on those rel Frobenius "
          f"{ss_rel:.3e} (need <= {SS_REL})", flush=True)
    if not (exact and agree >= RELU_MIN_AGREE and ss_rel <= SS_REL):
        failed.append("key_stream_fwd saved scores")
    # The plain backward differentiates the kernel forward's relu pattern.
    relu_on = raw > 0
    dattn = randn(T, k + 1)
    record_case(
        "key_stream_bwd", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:835",
        lambda: rec_lanes(sa.key_stream_bwd(*kargs, raw, ss, dattn, *kopts)),
        lambda: rec_lanes(sa.key_stream_bwd_plain(*kargs, dattn, *kopts,
                                                  relu_on=relu_on)),
        BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "dqq", "dW_k", "db_k"]
        + walk_labels(kwalk),
        nbytes(rec, rayo_f, rays, qq, raw, ss, dattn) + walk_bytes(kwalk),
        3 * T * k * walk_flops(kwalk, wk), n_walk=len(walk_labels(kwalk)),
        span="key_bwd_",
        db=(lambda: rec_lanes(sa.key_stream_bwd_plain(*kargs, dattn, *kopts,
                                                      relu_on=relu_on,
                                                      raw_saved=raw,
                                                      kernel_grads=True)),
            kwalk))
    vargs = (rec, rayo_f, rays, attn, vwalk)
    vopts = (normalize, eps, cdt)
    record_case(
        "value_stream_fwd", "papr_tpu_torch/csrc/value_stream.cu",
        "papr_tpu/ops/stream_attn.py:1601",
        lambda: [sa.value_stream_fwd(*vargs, *vopts)],
        lambda: [sa.value_stream_plain(*vargs, *vopts)], FWD_REL, ["fused"],
        nbytes(rec, rayo_f, rays, attn) + walk_bytes(vwalk),
        T * k * walk_flops(vwalk), span="value_fwd_", median=0)
    dfused = randn(T, int(vwalk.ws[-1].shape[1]))
    record_case(
        "value_stream_bwd", "papr_tpu_torch/csrc/value_stream.cu",
        "papr_tpu/ops/stream_attn.py:1634",
        lambda: rec_lanes(sa.value_stream_bwd(*vargs, dfused, *vopts)),
        lambda: rec_lanes(sa.value_stream_bwd_plain(*vargs, dfused, *vopts)),
        BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "d_attn"]
        + walk_labels(vwalk),
        nbytes(rec, rayo_f, rays, attn, dfused) + walk_bytes(vwalk),
        3 * T * k * walk_flops(vwalk), n_walk=len(walk_labels(vwalk)),
        span="value_bwd_",
        db=(lambda: rec_lanes(sa.value_stream_bwd_plain(
            *vargs, dfused, *vopts, kernel_grads=True)), vwalk))
    torch.cuda.empty_cache()

    # The key stream with the query chain folded in (tpu.query_fold): the
    # raw ray directions go in; qq comes out as a residual.
    a = params["attn"]
    qargs = (rec, rayo_f, rays, rayd_f.contiguous(), kwalk, wk, bk, qwalk,
             a["w_q"]["w"], a["w_q"]["bias"])
    q_flops = T * (k * walk_flops(kwalk, wk) + walk_flops(qwalk, a["w_q"]["w"]))
    q_bytes = nbytes(rec, rayo_f, rays, rayd_f) + walk_bytes(kwalk, qwalk)
    attn_q, raw_q, qq_q = record_case(
        "key_stream_q_fwd", "papr_tpu_torch/csrc/key_stream_q.cu",
        "papr_tpu/ops/stream_attn.py:1201",
        lambda: (lambda r: [r[0], r[1], r[3]])(sa.key_stream_q_fwd(*qargs,
                                                                  *kopts)),
        lambda: (lambda r: [r[0], r[1], r[3]])(sa.key_stream_q_plain(*qargs,
                                                                    *kopts)),
        FWD_REL, ["attn", "raw", "qq"], q_bytes, q_flops,
        fwd_tol=STREAM_ATTN_ABS)
    ss_q = sa.key_stream_q_fwd(*qargs, *kopts)[2]
    # On its own qq the folded kernel computes the unfolded kernel's function
    # (the bf16 unfolded forward runs on wgmma: another summation order).
    attn_u, raw_u, ss_u = sa.key_stream_fwd(rec, rayo_f, rays, qq_q, kwalk,
                                            wk, bk, *kopts)
    u_attn = float((attn_q - attn_u).abs().max())
    u_raw = rel_fro(raw_q, raw_u)
    print(f"phase 2 key_stream_q_fwd on its own qq against key_stream_fwd: "
          f"attn max abs {u_attn:.3e} (need <= {Q_UNFOLD_ABS}), raw rel "
          f"Frobenius {u_raw:.3e} (need <= {Q_UNFOLD_REL})", flush=True)
    if not (u_attn <= Q_UNFOLD_ABS and u_raw <= Q_UNFOLD_REL):
        failed.append("key_stream_q_fwd vs key_stream_fwd")
    relu_q = raw_q > 0
    record_case(
        "key_stream_q_bwd", "papr_tpu_torch/csrc/key_stream_q.cu",
        "papr_tpu/ops/stream_attn.py:1243",
        lambda: rec_lanes(sa.key_stream_q_bwd(*qargs, qq_q, raw_q, ss_q,
                                              dattn, *kopts)),
        lambda: rec_lanes(sa.key_stream_q_bwd_plain(*qargs, dattn, *kopts,
                                                    relu_on=relu_q)),
        BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "d_rayd", "dW_k", "db_k",
                               "dW_q", "db_q"] + walk_labels(kwalk)
        + ["q." + l for l in walk_labels(qwalk)],
        q_bytes + nbytes(qq_q, raw_q, ss_q, dattn), 3 * q_flops)
    del rec, record, qargs
    torch.cuda.empty_cache()

    # The streams on raw feature tensors (tpu.fused_attn: stream), on the
    # inputs the model's own head builds: xk (K, T, 9), xv (K, T, 70).
    with torch.no_grad():
        xk, kwalk_f, xv, vwalk_f, influ, sel_alive, _ = _stream_inputs(
            params, cfg, meta, idx, rayo, rayd, alive, eps)
    xk, xv = xk.contiguous(), xv.contiguous()
    influ, sel_alive = influ.contiguous(), sel_alive.contiguous()
    fargs = (xk, qq, kwalk_f, wk, bk, influ, sel_alive)
    fopts = (score_act, bkg, cdt)
    # dx by column group: the key positions (returned here, detached by the
    # caller) / proj + perp; the value geometry / point features.
    cols = lambda n: (lambda g: [g[0][..., :n], g[0][..., n:]] + list(g[1:]))
    attn_f, raw_f = record_case(
        "key_stream_feat_fwd", "papr_tpu_torch/csrc/key_stream_feat.cu",
        "papr_tpu/ops/stream_attn.py:133",
        lambda: list(sf.key_stream_feat_fwd(*fargs, *fopts)),
        lambda: list(sf.key_stream_feat_plain(*fargs, *fopts)), FEAT_RAW_REL,
        ["attn", "raw"],
        nbytes(xk, qq, influ, sel_alive) + walk_bytes(kwalk_f),
        T * k * walk_flops(kwalk_f, wk), fwd_tol=STREAM_ATTN_ABS)
    relu_f = raw_f > 0
    record_case(
        "key_stream_feat_bwd", "papr_tpu_torch/csrc/key_stream_feat.cu",
        "papr_tpu/ops/stream_attn.py:159",
        lambda: cols(3)(sf.key_stream_feat_bwd(*fargs, raw_f, dattn, *fopts)),
        lambda: cols(3)(sf.key_stream_feat_bwd_plain(*fargs, dattn, *fopts,
                                                     relu_on=relu_f)),
        FEAT_BWD_REL, ["dxk[position]", "dxk[proj, perp]", "dqq", "d_influ",
                  "dW_k", "db_k"] + walk_labels(kwalk_f),
        nbytes(xk, qq, influ, sel_alive, raw_f, dattn) + walk_bytes(kwalk_f),
        3 * T * k * walk_flops(kwalk_f, wk))
    record_case(
        "value_stream_feat_fwd", "papr_tpu_torch/csrc/value_stream_feat.cu",
        "papr_tpu/ops/stream_attn.py:406",
        lambda: [sf.value_stream_feat_fwd(xv, attn_f, vwalk_f, normalize,
                                          cdt)],
        lambda: [sf.value_stream_feat_plain(xv, attn_f, vwalk_f, normalize,
                                            cdt)], FEAT_FUSED_REL,
        ["fused"], nbytes(xv, attn_f) + walk_bytes(vwalk_f),
        T * k * walk_flops(vwalk_f))
    record_case(
        "value_stream_feat_bwd", "papr_tpu_torch/csrc/value_stream_feat.cu",
        "papr_tpu/ops/stream_attn.py:433",
        lambda: cols(6)(sf.value_stream_feat_bwd(xv, attn_f, vwalk_f, dfused,
                                                 normalize, cdt)),
        lambda: cols(6)(sf.value_stream_feat_bwd_plain(
            xv, attn_f, vwalk_f, dfused, normalize, cdt)),
        FEAT_BWD_REL, ["dxv[proj, perp]", "dxv[point features]", "d_attn"]
        + walk_labels(vwalk_f),
        nbytes(xv, attn_f, dfused) + walk_bytes(vwalk_f),
        3 * T * k * walk_flops(vwalk_f))
    del xk, xv, fargs
    torch.cuda.empty_cache()
    if failed:
        fail(f"training kernels disagree with their plain versions: {failed}")
    return out


def kernel_span_ms(fn, pattern, n: int = 3, names=None) -> float:
    """Device time per call of the kernels whose name holds ``pattern`` (a
    string, or a tuple of strings: any of them), over n calls of fn under
    the profiler (after one warm-up): a wrapper's kernel without the small
    launches around it. NaN if the profiler saw none. ``names``, a list,
    receives those kernels' names (without arguments)."""
    pats = (pattern,) if isinstance(pattern, str) else tuple(pattern)
    fn()
    _, _, spans = device_profile(lambda: [fn() for _ in range(n)])
    hit = [(e0 - s0, name) for s0, e0, name in spans
           if any(p in name for p in pats)]
    if names is not None:
        names.extend(sorted({name.split("(")[0] for _, name in hit}))
    return sum(t for t, _ in hit) / n / 1e3 if hit else float("nan")


def load_tool(name: str):
    """A script under tools/ as a module (tools/ is not a package)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_int8_kernels(params, state, cfg, device, n_time: int = 3) -> list:
    """Phase 2, the int8 walks: ``attend_eval_i8`` on the 160x160 eval block
    (self-calibrated and on a frame-level quantization), ``key_stream_i8_fwd``
    / ``value_stream_i8_fwd`` on the training patch, and the four variants of
    the int8 walk microbenchmark, each against its plain version on the same
    quantization. Beside each: the bf16 kernel on the same inputs, and the
    calibration alone."""
    import torch
    from papr_tpu_torch.model.papr import eval_quant_params
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops.geometry import get_rays

    policy = policy_from_config(cfg)
    cdt = policy.compute_dtype
    eps = float(cfg.eps)
    results, failed = [], []

    def i8_bound(n_bytes, int8_ops, bf16_ops=0.0):
        """Bytes over the memory rate against int8 operations over the int8
        peak plus what stays bf16 (w_k) over the bf16 peak."""
        t_b = n_bytes / HBM_BYTES_S * 1e3
        t_o = (int8_ops / INT8_OPS + bf16_ops / BF16_FLOPS) * 1e3
        return {"bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": None}

    # ---- attend_eval_i8 on the eval block ----
    args, T = eval_block_args(params, state, cfg, device)
    record, idx, rayo_flat, rays, qq, kwalk, wk, _, vwalk = args[:9]
    k = idx.shape[1]
    cfg8 = flagship_cfg(int8_eval=True)
    c2w = torch.as_tensor(orbit(0.0), device=device)
    _, frame_rays = get_rays(H, W, c2w, torch.tensor([FOCAL, FOCAL],
                                                     device=device))
    frame_rays = frame_rays.reshape(-1, 3)
    sample = frame_rays[::max(1, frame_rays.shape[0] // 1024)]
    calibrate = lambda: eval_quant_params(params, state, cfg8, rayo_flat[0],
                                          sample, policy=policy)
    qp = calibrate()
    bf16_ms = cuda_ms(lambda: sa.attend_eval_idx(*args), n_time)
    work = i8_bound(nbytes(record, idx, rayo_flat, rays, qq)
                    + walk_bytes(kwalk, vwalk) + T * (32 + k + 1) * 4,
                    T * k * walk_flops(kwalk, vwalk), T * k * walk_flops(wk))
    for name, quant, cal in (
            ("frame-level quant_params", qp, calibrate),
            ("self-calibrated", None, lambda: sa._calibrate_idx(
                record, idx, rayo_flat, rays, (kwalk, vwalk), eps, cdt))):
        call = lambda: sa.attend_eval_idx(*args, True, quant)
        f_got, a_got = call()
        f_want, a_want = sa.attend_eval_plain(*args, True, quant)
        torch.cuda.synchronize()
        err = rel_fro(f_got, f_want)
        med = median_row_rels([f_got], [f_want])[0]
        f_abs = float((f_got - f_want).abs().max())
        a_abs = float((a_got - a_want).abs().max())
        finite = bool(torch.isfinite(f_got).all()
                      and torch.isfinite(a_got).all())
        f_bf, a_bf = sa.attend_eval_idx(*args)
        ms = cuda_ms(call, n_time)
        kern_ms = kernel_span_ms(call, "attend_eval_i8_wgmma_kernel")
        plain_ms = cuda_ms(lambda: sa.attend_eval_plain(*args, True, quant), 1)
        cal_ms = cuda_ms(cal, n_time)
        print(f"phase 2 attend_eval_i8 ({name}): T={T} K={k}: fused rel "
              f"Frobenius {err:.3e} (need <= {I8_FUSED_REL}), median ray "
              f"{med:.3e} (need <= {I8_MEDIAN_REL}), max abs "
              f"{f_abs:.3e}; attn max abs {a_abs:.3e} (need <= "
              f"{I8_ATTN_ABS}); finite {finite}; call {ms:.3f} ms, its kernel "
              f"alone {kern_ms:.3f} ms (on WMMA before: {K3_I8_WMMA_MS} ms), "
              f"the bf16 kernel on the same inputs "
              f"{bf16_ms:.3f} ms, plain {plain_ms:.3f} ms, the calibration "
              f"alone {cal_ms:.3f} ms, bound {work['bound_ms']:.4f} ms "
              f"({work['bound_by']}); int8 against bf16 kernel: fused rel "
              f"Frobenius {rel_fro(f_got, f_bf):.3e}, attn max abs "
              f"{float((a_got - a_bf).abs().max()):.3e}", flush=True)
        if not (finite and err <= I8_FUSED_REL and med <= I8_MEDIAN_REL
                and a_abs <= I8_ATTN_ABS):
            failed.append(f"attend_eval_i8 ({name})")
        if quant is not None:
            results.append({
                "name": "attend_eval_i8", "route": "cuda",
                "source": "papr_tpu_torch/csrc/attend_eval.cu",
                "replaces": "papr_tpu/ops/stream_attn.py:1856 (quant=True: "
                            "papr_tpu/ops/fused_mlp.py:322)",
                "max_abs_err": f_abs, "max_rel_err": err, "ms": ms,
                "kernel_ms": kern_ms, "bf16_kernel_ms": bf16_ms,
                "plain_ms": plain_ms, "calibration_ms": cal_ms, **work})
        else:
            results[-1]["self_calibrated"] = {
                "max_abs_err": f_abs, "max_rel_err": err, "ms": ms,
                "kernel_ms": kern_ms, "plain_ms": plain_ms,
                "calibration_ms": cal_ms}
    del args, record, idx, qq, f_got, f_want, a_got, a_want
    torch.cuda.empty_cache()

    # ---- the two int8 training forwards on the training patch ----
    rayo, rayd = training_patch(device)
    _, _, rec, rayo_f, rays, _, qq, kwalk, vwalk = stream_patch_inputs(
        params, state, cfg, rayo, rayd)
    T, wk, bk = PATCH * PATCH, params["attn"]["w_k"]["w"], \
        params["attn"]["w_k"]["bias"]
    kargs = (rec, rayo_f, rays, qq, kwalk, wk, bk)
    kopts = (cfg.models.attn.score_act, float(cfg.geoms.background.constant),
             eps, cdt)
    attn = sa.key_stream_fwd(*kargs, *kopts)[0]
    vargs = (rec, rayo_f, rays, attn, vwalk)
    vopts = (bool(cfg.models.normalize_topk_attn), eps, cdt)
    cases = (
        ("key_stream_i8_fwd", "papr_tpu_torch/csrc/key_stream.cu",
         "papr_tpu/ops/stream_attn.py:798 (quant=True)", "key_i8_fwd_kernel",
         lambda i8: list(sa.key_stream_fwd(*kargs, *kopts, int8=i8))[:2],
         lambda: list(sa.key_stream_plain(*kargs, *kopts, int8=True))[:2],
         ["attn", "raw"], kwalk, I8_RAW_REL,
         i8_bound(nbytes(rec, rayo_f, rays, qq) + walk_bytes(kwalk)
                  + T * (3 * k + 1) * 4, T * k * walk_flops(kwalk),
                  T * k * walk_flops(wk))),
        ("value_stream_i8_fwd", "papr_tpu_torch/csrc/value_stream.cu",
         "papr_tpu/ops/stream_attn.py:1601 (quant=True)",
         "value_i8_fwd_kernel",
         lambda i8: [sa.value_stream_fwd(*vargs, *vopts, int8=i8)],
         lambda: [sa.value_stream_plain(*vargs, *vopts, int8=True)],
         ["fused"], vwalk, I8_FUSED_REL,
         i8_bound(nbytes(rec, rayo_f, rays, attn) + walk_bytes(vwalk)
                  + T * 32 * 4, T * k * walk_flops(vwalk))))
    for (name, source, replaces, pattern, fn, plain, labels, walk, tol,
         work) in cases:
        g, w = fn(True), plain()
        torch.cuda.synchronize()
        rels = _rels(g, w)
        finite = all(bool(torch.isfinite(t).all()) for t in g)
        vs_bf16 = _rels(g, fn(False))
        ms = cuda_ms(lambda: fn(True), n_time)
        kern_ms = kernel_span_ms(lambda: fn(True), pattern)
        bf16_ms = cuda_ms(lambda: fn(False), n_time)
        plain_ms = cuda_ms(plain, 1)
        cal_ms = cuda_ms(lambda: sa.calibrate_walk(rec, rayo_f, rays, walk,
                                                   eps, cdt), n_time)
        print(f"phase 2 {name}: T={T} K={k}: rel Frobenius "
              + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, rels))
              + f" (need <= {tol}); finite {finite}; call {ms:.3f} ms "
              f"(with its calibration, {cal_ms:.3f} ms alone), its kernel "
              f"alone {kern_ms:.3f} ms, the bf16 kernel on the same inputs "
              f"{bf16_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{work['bound_ms']:.4f} ms ({work['bound_by']}); int8 against "
              "bf16 kernel: "
              + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, vs_bf16)),
              flush=True)
        if not (finite and max(rels) <= tol):
            failed.append(name)
        if name == "key_stream_i8_fwd":
            a_abs = float((g[0] - w[0]).abs().max())
            print(f"phase 2 {name}: attn max abs {a_abs:.3e} (need <= "
                  f"{I8_KEY_ATTN_ABS})", flush=True)
            if not a_abs <= I8_KEY_ATTN_ABS:
                failed.append(name + " attn")
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": _max_abs(g, w),
                        "max_rel_err": max(rels), "ms": ms,
                        "kernel_ms": kern_ms, "bf16_kernel_ms": bf16_ms,
                        "plain_ms": plain_ms, "calibration_ms": cal_ms,
                        **work})
    del rec, kargs, vargs, attn, g, w
    torch.cuda.empty_cache()

    # ---- the microbenchmark's four variants, 1024 x 128 rows, 8 layers ----
    mb = load_tool("torch_int8_walk_microbench")
    rows, tiles, layers = 1024, 128, 8
    x = torch.randn(rows * tiles, mb.D,
                    generator=torch.Generator().manual_seed(100)).to(device)
    ws, bs = mb.make_weights(layers, device)
    variants = {}
    for kind in mb.KINDS:
        got = mb.int8_walk_bench(kind, x, ws, bs)
        want = mb.walk_bench_plain(kind, x, ws, bs)
        torch.cuda.synchronize()
        err = rel_fro(got, want)
        tol = I8_BENCH_REL[kind]
        variants[kind] = {
            "max_abs_err": float((got - want).abs().max()),
            "max_rel_err": err, "equal": bool(torch.equal(got, want)),
            "ms": mb.time_kind(kind, x, ws, bs, 10),
            "plain_ms": cuda_ms(lambda: mb.walk_bench_plain(kind, x, ws, bs),
                                1)}
        v = variants[kind]
        print(f"phase 2 int8_walk_bench ({kind}): {rows * tiles} rows x "
              f"{layers} layers of {mb.D}x{mb.D}: rel Frobenius {err:.3e} "
              f"(need <= {tol}), equal {v['equal']}; kernel {v['ms']:.3f} ms, "
              f"plain {v['plain_ms']:.3f} ms", flush=True)
        if not err <= tol:
            failed.append(f"int8_walk_bench ({kind})")
        del got, want
    ops = 2.0 * rows * tiles * layers * mb.D * mb.D
    n_bytes = nbytes(x) * 2 + layers * mb.D * (mb.D + 12)
    results.append({
        "name": "int8_walk_bench", "route": "cuda",
        "source": "papr_tpu_torch/csrc/int8_walk_bench.cu",
        "replaces": "tools/int8_walk_microbench.py:132 (bodies :33, :45, "
                    ":63, :80); ms, plain_ms, errors and the bound are the "
                    "int8s variant's (the model's form)",
        "max_abs_err": variants["int8s"]["max_abs_err"],
        "max_rel_err": variants["int8s"]["max_rel_err"],
        "ms": variants["int8s"]["ms"],
        "plain_ms": variants["int8s"]["plain_ms"], "variants": variants,
        "bf16_bound_ms": ops / BF16_FLOPS * 1e3,
        **i8_bound(n_bytes, ops)})
    if failed:
        fail(f"int8 kernels disagree with their plain versions: {failed}")
    return results


def counters(training: bool = False):
    """The launch counters of one path's kernels and the call counters of
    every plain version."""
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import pallas_topk as pt
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf
    from papr_tpu_torch.ops import tile_cull as tc
    kernels = {"cull_select": tc.cull_select, "fused_mlp": fm.fused_mlp}
    if training:
        kernels.update({"fused_mlp_bwd": fm.fused_mlp_bwd,
                        "key_stream_fwd": sa.key_stream_fwd,
                        "key_stream_bwd": sa.key_stream_bwd,
                        "value_stream_fwd": sa.value_stream_fwd,
                        "value_stream_bwd": sa.value_stream_bwd,
                        "wgrad": fm.wgrad})
    else:
        kernels["attend_stream_eval"] = sa.attend_eval_idx
    plains = {"cull_select": tc.cull_select_plain,
              "fused_mlp": fm.fused_mlp_plain,
              "fused_mlp_bwd": fm.fused_mlp_bwd_plain,
              "attend_stream_eval": sa.attend_eval_plain,
              "key_stream_fwd": sa.key_stream_plain,
              "key_stream_bwd": sa.key_stream_bwd_plain,
              "value_stream_fwd": sa.value_stream_plain,
              "value_stream_bwd": sa.value_stream_bwd_plain,
              "topk_stream": pt.topk_stream_plain,
              "fused_scores_fwd": fa.fused_scores_plain,
              "fused_scores_bwd": fa.fused_scores_bwd_plain,
              "key_stream_q_fwd": sa.key_stream_q_plain,
              "key_stream_q_bwd": sa.key_stream_q_bwd_plain,
              "key_stream_feat_fwd": sf.key_stream_feat_plain,
              "key_stream_feat_bwd": sf.key_stream_feat_bwd_plain,
              "value_stream_feat_fwd": sf.value_stream_feat_plain,
              "value_stream_feat_bwd": sf.value_stream_feat_bwd_plain}
    return kernels, plains


def stream_counters():
    """Every kernel a training step or a tiled frame can launch under
    ``streamrec``, ``streamrec`` + ``query_fold`` or ``stream``."""
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf
    kernels, plains = counters(training=True)
    kernels.update({"attend_stream_eval": sa.attend_eval_idx,
                    "key_stream_q_fwd": sa.key_stream_q_fwd,
                    "key_stream_q_bwd": sa.key_stream_q_bwd,
                    "key_stream_feat_fwd": sf.key_stream_feat_fwd,
                    "key_stream_feat_bwd": sf.key_stream_feat_bwd,
                    "value_stream_feat_fwd": sf.value_stream_feat_fwd,
                    "value_stream_feat_bwd": sf.value_stream_feat_bwd})
    return kernels, plains


# Launches of one training step / one tiled 800x800 frame (64 tiles) by
# attention mode; a kernel not named launches 0 times (wgrad: at least once a
# step).
STREAM_MODES = {
    "stream": ({"fused_attn": "stream"},
               ("cull_select", "fused_mlp", "fused_mlp_bwd",
                "key_stream_feat_fwd", "key_stream_feat_bwd",
                "value_stream_feat_fwd", "value_stream_feat_bwd"),
               ("cull_select", "fused_mlp", "key_stream_feat_fwd",
                "value_stream_feat_fwd")),
    "streamrec + query_fold": ({"fused_attn": "streamrec", "query_fold": True},
                               ("cull_select", "key_stream_q_fwd",
                                "key_stream_q_bwd", "value_stream_fwd",
                                "value_stream_bwd"),
                               ("cull_select", "key_stream_q_fwd",
                                "value_stream_fwd")),
    "streamrec": ({"fused_attn": "streamrec"},
                  ("cull_select", "fused_mlp", "fused_mlp_bwd",
                   "key_stream_fwd", "key_stream_bwd", "value_stream_fwd",
                   "value_stream_bwd"),
                  ("cull_select", "fused_mlp", "attend_stream_eval")),
}


def drive_stream_modes(device) -> dict:
    """Phase 6: training and rendering under ``tpu.fused_attn: stream`` and
    ``streamrec`` + ``tpu.query_fold``, beside ``streamrec``, on the flagship
    model and one 160x160 batch in this one call: each mode starts from the
    same seeded model and optimizer state; the modes run in two rounds (there
    and back) so a drift of the card shows. The counters are reset just before
    each mode's timed steps and frame and read just after."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.step import (make_opt_state, make_train_step,
                                           render_full_image)

    rayo, rayd = training_patch(device)
    gen = torch.Generator(device=device).manual_seed(4)
    target = torch.rand(1, PATCH, PATCH, 3, generator=gen, device=device)
    c2w = orbit(0.0)
    n_rays = PATCH * PATCH
    kernels, plains = stream_counters()
    base = flagship_cfg()
    loss_fn = build_loss(base, policy_from_config(base), device=device)
    total = {n: 0 for n in kernels}
    readings = {m: [] for m in STREAM_MODES}

    def check_launches(what, mode, got, named, per_unit, training):
        """Exactly per_unit launches of each named kernel, none of any other
        (wgrad: at least per_unit in training, none in a frame), and no plain
        version."""
        want = {n: (per_unit if n in named else 0) for n in got}
        bad = {n: (got[n], want[n]) for n in got
               if n != "wgrad" and got[n] != want[n]}
        calls = {n: fn.calls for n, fn in plains.items() if fn.calls}
        wgrad_ok = (got["wgrad"] >= per_unit if training
                    else got["wgrad"] == 0)
        if bad or calls or not wgrad_ok:
            fail(f"{what} under {mode}: launches (got, want) {bad}; plain "
                 f"versions called {calls}; wgrad {got['wgrad']}")

    order = list(STREAM_MODES) + list(STREAM_MODES)[::-1]
    for rnd, mode in enumerate(order):
        tpu, step_kernels, _ = STREAM_MODES[mode]
        cfg = flagship_cfg(**tpu)
        params, state = build_model(cfg, device)
        opt = make_opt_state(cfg, params)
        step_fn = make_train_step(cfg, loss_fn)
        losses = [step_fn(params, opt, state, rayo, rayd, target, c2w,
                          1000)[2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(kernels, plains)
        t0 = time.perf_counter()
        for i in range(STREAM_STEPS):
            params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd,
                                              target, c2w, 1001 + i)
            losses.append(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STREAM_STEPS * 1e3
        got = {n: fn.launches for n, fn in kernels.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check_launches("training steps", mode, got, step_kernels, STREAM_STEPS,
                       True)
        for n in total:
            total[n] += got[n]
        losses = [float(l) for l in losses]
        if not (all(np.isfinite(losses))
                and pred.shape == (1, PATCH, PATCH, 3)):
            fail(f"training under {mode}: losses {losses}")
        wall, idle, spans = device_profile(lambda: [step_fn(
            params, opt, state, rayo, rayd, target, c2w, 1100 + i)
            for i in range(3)])
        split, kern = stage_split(spans, TRAIN_STAGES, 3, TRAIN_OTHER)
        readings[mode].append((ms, kern, idle, peak_gb))
        print(f"phase 6 step ({mode}, round {rnd // len(STREAM_MODES) + 1}; "
              f"{n_rays} rays): {ms:.1f} ms/step over {STREAM_STEPS} steps = "
              f"{n_rays / ms * 1e3:.0f} rays/s; peak device memory "
              f"{peak_gb:.2f} GiB; losses "
              + ", ".join(f"{l:.6f}" for l in losses)
              + f"; 3 profiled steps: {wall / 3:.1f} ms/step, device idle "
              f"share {idle:.4f}, kernel time {kern:.3f} ms/step: {split}; "
              f"launches {({n: v for n, v in got.items() if v})}", flush=True)
        del params, state, opt
        torch.cuda.empty_cache()
    print("phase 6 ms/step, both rounds (kernel ms/step; idle share): "
          + "; ".join(f"{m}: " + ", ".join(
              f"{r[0]:.1f} ({r[1]:.3f}; {r[2]:.4f})" for r in rs)
              for m, rs in readings.items()), flush=True)

    # One 800x800 frame at the config's 100x100 test tiles under each mode;
    # the new modes' frames against the one-shot kernel's.
    th, tw = int(base.test.max_height), int(base.test.max_width)
    fr_o, fr_d = get_rays_np(H, W, FOCAL, FOCAL, orbit(0.0)[None])
    frames = {}
    for mode in ("streamrec", "stream", "streamrec + query_fold"):
        tpu, _, frame_kernels = STREAM_MODES[mode]
        cfg = flagship_cfg(**tpu)
        params, state = build_model(cfg, device)
        render = lambda: render_full_image(
            params, state, cfg, fr_o, fr_d, th, tw, rgb_only=True,
            rgb_uint8=True)["rgb"][0]
        render()                                             # warm-up
        torch.cuda.synchronize()
        reset_counters(kernels, plains)
        t0 = time.perf_counter()
        frames[mode] = render()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {n: fn.launches for n, fn in kernels.items()}
        n_tiles = (H // th) * (W // tw)
        check_launches("a tiled frame", mode, got, frame_kernels, n_tiles,
                       False)
        for n in total:
            total[n] += got[n]
        fr = frames[mode]
        if fr.shape != (H, W, 3) or fr.dtype != np.uint8 \
                or int(fr.max()) == int(fr.min()):
            fail(f"frame under {mode}: {fr.shape} {fr.dtype}")
        line = (f"phase 6 frame ({mode}): {H}x{W} in {th}x{tw} tiles, "
                f"{ms:.1f} ms; launches "
                f"{({n: v for n, v in got.items() if v})}")
        if mode != "streamrec":
            diff = np.abs(fr.astype(np.int16)
                          - frames["streamrec"].astype(np.int16))
            close = float((diff.max(-1) <= 1).mean())
            line += (f"; against the one-shot kernel's frame: pixels within "
                     f"1/255 {close:.6f} (need >= {STREAM_FRAME_MIN_CLOSE}), "
                     f"max diff {int(diff.max())}")
            if close < STREAM_FRAME_MIN_CLOSE:
                print(line, flush=True)
                fail(f"the tiled frame under {mode} disagrees with the "
                     "one-shot kernel's")
        print(line, flush=True)
        del params, state
        torch.cuda.empty_cache()
    return {"launches": total, "step_ms": {m: [r[0] for r in rs]
                                           for m, rs in readings.items()}}


def int8_counters():
    """The kernels an int8 frame or an ``int8_train`` step can launch (with
    the bf16 twins they must not), and every plain version."""
    from papr_tpu_torch.ops import stream_attn as sa
    kernels, plains = stream_counters()
    kernels.update({"attend_eval_i8": sa.attend_eval_i8,
                    "key_stream_i8_fwd": sa.key_stream_i8_fwd,
                    "value_stream_i8_fwd": sa.value_stream_i8_fwd})
    return kernels, plains


def frame_distance(what, a, b, att_a, att_b) -> None:
    """An int8 frame against the bf16 frame of the same model and pose: uint8
    pixels (PSNR, share within 2/255), fused features and attention of the
    whole frame. Fails outside int8's own distance."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    close = float((diff.max(-1) <= 2).mean())
    mse = float(np.mean((diff / 255.0) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-12))
    f_rel = float(np.linalg.norm(att_a["fused"] - att_b["fused"])
                  / max(np.linalg.norm(att_b["fused"]), 1e-30))
    f_scale = float(np.abs(att_a["fused"] - att_b["fused"]).max()
                    / max(np.abs(att_b["fused"]).max(), 1e-30))
    a_rel = float(np.linalg.norm(att_a["attn"] - att_b["attn"])
                  / max(np.linalg.norm(att_b["attn"]), 1e-30))
    a_abs = float(np.abs(att_a["attn"] - att_b["attn"]).max())
    fg = 1.0 - att_b["attn"][..., -1, 0]
    print(f"phase 7 int8 frame against bf16 frame ({what}): PSNR between "
          f"them {psnr:.2f} dB, pixels within 2/255 {close:.6f} (need >= "
          f"{I8_FRAME_MIN_CLOSE}), max diff {int(diff.max())}; fused features "
          f"rel Frobenius {f_rel:.3e} (need <= {I8_FRAME_FUSED_REL}), max abs "
          f"over scale {f_scale:.3e}; attn rel Frobenius {a_rel:.3e} (need <= "
          f"{I8_FRAME_ATTN_REL}), max abs {a_abs:.3e}; foreground attention "
          f"mean {float(fg.mean()):.4f}, max {float(fg.max()):.4f}",
          flush=True)
    if not (close >= I8_FRAME_MIN_CLOSE and f_rel <= I8_FRAME_FUSED_REL
            and a_rel <= I8_FRAME_ATTN_REL
            and float(fg.max()) > float(fg.min())):
        fail(f"the int8 frame is outside int8's distance of the bf16 frame "
             f"({what})")


def drive_int8_paths(device, cli_model) -> dict:
    """Phase 7: ``tpu.int8_eval`` frames and ``tpu.int8_train`` steps at full
    width beside their bf16 twins in this one call, the knobs' ignored rows
    once each, and the microbenchmark through its entry point. Counters are
    reset just before each part and read just after."""
    import warnings

    import torch
    from papr_tpu_torch.model import papr as tpapr
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
    from papr_tpu_torch.train.step import (make_opt_state, make_train_step,
                                           render_frame, render_frames,
                                           render_full_image)

    kernels, plains = int8_counters()
    total = {n: 0 for n in kernels}

    def read(what, want, units=1, wgrad_min=0):
        """Exactly ``want[n] * units`` launches of each named kernel, none of
        any other, no plain version; adds the counts to the phase's total."""
        got = {n: fn.launches for n, fn in kernels.items()}
        bad = {n: (got[n], want.get(n, 0) * units) for n in got
               if n != "wgrad" and got[n] != want.get(n, 0) * units}
        calls = {n: fn.calls for n, fn in plains.items() if fn.calls}
        if bad or calls or got["wgrad"] < wgrad_min \
                or (wgrad_min == 0 and got["wgrad"]):
            fail(f"{what}: launches (got, want) {bad}; plain versions called "
                 f"{calls}; wgrad {got['wgrad']}")
        for n in total:
            total[n] += got[n]
        return {n: v for n, v in got.items() if v}

    # ---- (a) serving frames under int8_eval beside bf16 ----
    cfg8, cfgb = flagship_cfg(int8_eval=True), flagship_cfg()
    params, state = build_model(cfg8, device)
    poses = [orbit(2 * np.pi * i / 3) for i in range(3)]
    serve = lambda cfg, ps: list(render_frames(params, state, cfg, ps, FOCAL,
                                               FOCAL, H, W, H, W))
    frame_ms, peaks = {}, {}
    for name, cfg in (("int8_eval", cfg8), ("bf16", cfgb), ("int8_eval, again",
                                                            cfg8)):
        serve(cfg, [orbit(0.3)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(kernels, plains)
        cal = tpapr.eval_quant_params.calls, sa.walk_amax.calls
        t0 = time.perf_counter()
        frames = serve(cfg, poses)
        frame_ms[name] = (time.perf_counter() - t0) / len(poses) * 1e3
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        cal = (tpapr.eval_quant_params.calls - cal[0],
               sa.walk_amax.calls - cal[1])
        i8 = name != "bf16"
        got = read(f"serving frames ({name})",
                   {"cull_select": 1, "fused_mlp": 1,
                    "attend_eval_i8" if i8 else "attend_stream_eval": 1}, 3)
        if cal != ((3, 6) if i8 else (0, 0)) or any(
                f.shape != (H, W, 3) or int(f.max()) == int(f.min())
                for f in frames):
            fail(f"serving frames ({name}): calibrations {cal}")
        print(f"phase 7 render_frames {H}x{W} ({name}): "
              f"{frame_ms[name]:.1f} ms/frame over 3 frames; peak device "
              f"memory {peaks[name]:.2f} GiB; launches {got}; calibrations "
              f"(frames, walks) {cal}", flush=True)
    for name, cfg in (("int8_eval", cfg8), ("bf16", cfgb)):
        wall, idle, spans = device_profile(lambda: [render_frame(
            params, state, cfg, orbit(2 * np.pi * i / 3), FOCAL, FOCAL, H, W)
            for i in range(3)])
        split, kern = stage_split(spans, FRAME_STAGES, 3)
        print(f"phase 7 profile ({name}): 3 frames, {wall / 3:.1f} ms/frame "
              f"under the profiler; device idle share {idle:.4f}; kernel time "
              f"{kern:.3f} ms/frame: {split}", flush=True)

    # One tiled frame: 64 tiles, ONE calibration.
    th, tw = int(cfg8.test.max_height), int(cfg8.test.max_width)
    rayo, rayd = get_rays_np(H, W, FOCAL, FOCAL, poses[0][None])
    tiled = lambda cfg, **kw: render_full_image(params, state, cfg, rayo, rayd,
                                                th, tw, **kw)
    rgb = dict(rgb_only=True, rgb_uint8=True)
    tiled(cfg8, **rgb)
    tiled(cfgb, **rgb)
    torch.cuda.synchronize()
    reset_counters(kernels, plains)
    cal = tpapr.eval_quant_params.calls, sa.walk_amax.calls
    t0 = time.perf_counter()
    fr8 = tiled(cfg8, **rgb)["rgb"][0]
    tiled_ms = [(time.perf_counter() - t0) * 1e3]
    cal = (tpapr.eval_quant_params.calls - cal[0], sa.walk_amax.calls - cal[1])
    n_tiles = (H // th) * (W // tw)
    got = read("a tiled int8 frame", {"cull_select": 1, "fused_mlp": 1,
                                      "attend_eval_i8": 1}, n_tiles)
    # The tile loop is host code and its clock spreads: bf16 and int8 frames
    # in turn, twice more.
    tiled_b_ms = []
    for cfg, ms in ((cfgb, tiled_b_ms), (cfg8, tiled_ms)) * 2 \
            + ((cfgb, tiled_b_ms),):
        t0 = time.perf_counter()
        frb = tiled(cfg, **rgb)["rgb"][0]
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 7 render_full_image {H}x{W} in {th}x{tw} tiles, frames in "
          "turn: int8_eval " + ", ".join(f"{m:.1f}" for m in tiled_ms)
          + " ms; bf16 " + ", ".join(f"{m:.1f}" for m in tiled_b_ms)
          + f" ms; the int8 frame's launches {got}; calibrations (frames, "
          f"walks) {cal}", flush=True)
    if cal != (1, 2) or n_tiles != 64:
        fail(f"the tiled int8 frame calibrated {cal} times over {n_tiles} "
             "tiles, want (1, 2) over 64")
    frame_distance("seeded flagship model", fr8, frb,
                   tiled(cfg8, attention_only=True),
                   tiled(cfgb, attention_only=True))
    del params, state
    torch.cuda.empty_cache()
    probe, pstate, prayo, prayd, pcfg = cli_model
    ptiled = lambda cfg, **kw: render_full_image(probe, pstate, cfg, prayo,
                                                 prayd, 100, 100, **kw)
    frame_distance("the command-line path's trained sphere model, seeded "
                   "influence scores",
                   ptiled(pcfg(int8_eval=True), **rgb)["rgb"][0],
                   ptiled(pcfg(), **rgb)["rgb"][0],
                   ptiled(pcfg(int8_eval=True), attention_only=True),
                   ptiled(pcfg(), attention_only=True))
    del probe, pstate
    torch.cuda.empty_cache()

    # ---- (b) training steps under int8_train beside streamrec ----
    rayo, rayd = training_patch(device)
    gen = torch.Generator(device=device).manual_seed(4)
    target = torch.rand(1, PATCH, PATCH, 3, generator=gen, device=device)
    c2w = orbit(0.0)
    n_rays = PATCH * PATCH
    base = flagship_cfg()
    loss_fn = build_loss(base, policy_from_config(base), device=device)
    step_want = {
        "int8_train": {"cull_select": 1, "fused_mlp": 1, "fused_mlp_bwd": 1,
                       "key_stream_i8_fwd": 1, "key_stream_bwd": 1,
                       "value_stream_i8_fwd": 1, "value_stream_bwd": 1},
        "streamrec": {"cull_select": 1, "fused_mlp": 1, "fused_mlp_bwd": 1,
                      "key_stream_fwd": 1, "key_stream_bwd": 1,
                      "value_stream_fwd": 1, "value_stream_bwd": 1}}
    first, step_ms = {}, {}
    for mode, tpu in (("int8_train", {"int8_train": True}), ("streamrec", {})):
        cfg = flagship_cfg(fused_attn="streamrec", **tpu)
        params, state = build_model(cfg, device)
        specs = build_group_specs(cfg)
        before = _snapshot(params, specs)
        opt = make_opt_state(cfg, params)
        step_fn = make_train_step(cfg, loss_fn)
        losses = [step_fn(params, opt, state, rayo, rayd, target, c2w,
                          1000)[2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(kernels, plains)
        t0 = time.perf_counter()
        for i in range(STREAM_STEPS):
            params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd,
                                              target, c2w, 1001 + i)
            losses.append(loss)
        torch.cuda.synchronize()
        step_ms[mode] = (time.perf_counter() - t0) / STREAM_STEPS * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        got = read(f"training steps ({mode})", step_want[mode], STREAM_STEPS,
                   wgrad_min=STREAM_STEPS)
        losses = [float(l) for l in losses]
        first[mode] = losses[0]
        moved = {k: any(not torch.equal(a, b) for a, b in
                        zip(before[k], tree_leaves(params[k])))
                 for k in before}
        if not (all(np.isfinite(losses)) and all(moved.values())
                and pred.shape == (1, PATCH, PATCH, 3)):
            fail(f"training under {mode}: losses {losses}, moved {moved}")
        wall, idle, spans = device_profile(lambda: [step_fn(
            params, opt, state, rayo, rayd, target, c2w, 1100 + i)
            for i in range(3)])
        split, kern = stage_split(spans, TRAIN_STAGES, 3, TRAIN_OTHER)
        print(f"phase 7 step ({mode}; {n_rays} rays): {step_ms[mode]:.1f} "
              f"ms/step over {STREAM_STEPS} steps = "
              f"{n_rays / step_ms[mode] * 1e3:.0f} rays/s; peak device memory "
              f"{peak_gb:.2f} GiB; losses "
              + ", ".join(f"{l:.6f}" for l in losses)
              + f"; every group moved {all(moved.values())}; 3 profiled "
              f"steps: {wall / 3:.1f} ms/step, device idle share {idle:.4f}, "
              f"kernel time {kern:.3f} ms/step: {split}; launches {got}",
              flush=True)
        del params, state, opt
        torch.cuda.empty_cache()
    loss_rel = abs(first["int8_train"] - first["streamrec"]) \
        / abs(first["streamrec"])
    print(f"phase 7 first step's loss, int8_train {first['int8_train']:.6f} "
          f"against streamrec {first['streamrec']:.6f}: rel {loss_rel:.3e} "
          f"(need <= {I8_STEP_LOSS_REL})", flush=True)
    if not loss_rel <= I8_STEP_LOSS_REL:
        fail("the int8_train step's loss is outside int8's distance of the "
             "bf16 step's")

    # ---- (c) the rows where a knob cannot take effect, once each ----
    params, state = build_model(base, device)
    side = 64
    focal = FOCAL * side / 800
    s_o, s_d = get_rays_np(side, side, focal, focal, orbit(0.7)[None])
    s_o, s_d = (torch.as_tensor(s_o, device=device),
                torch.as_tensor(s_d, device=device))
    policy = policy_from_config(base)

    def call(training, **tpu):
        fn = tpapr.forward if training else tpapr.evaluate
        with torch.no_grad():
            out = fn(params, state, flagship_cfg(**tpu), s_o, s_d,
                     policy=policy)
        return out if training else torch.cat([out[0].flatten(),
                                               out[1].flatten()])

    i8 = ("attend_eval_i8", "key_stream_i8_fwd", "value_stream_i8_fwd")
    rows = (
        ("int8_eval", {"eval_fused": False}, False, True,
         ("key_stream_fwd", "value_stream_fwd")),
        ("int8_eval", {"query_fold": True}, False, True,
         ("key_stream_q_fwd", "value_stream_fwd")),
        ("int8_eval", {"fused_attn": "stream"}, False, True,
         ("key_stream_feat_fwd", "value_stream_feat_fwd")),
        ("int8_eval", {}, True, False, ("key_stream_fwd", "value_stream_fwd")),
        ("int8_train", {"query_fold": True}, True, True,
         ("key_stream_q_fwd", "value_stream_fwd")),
        ("int8_train", {"fused_attn": "stream"}, True, True,
         ("key_stream_feat_fwd", "value_stream_feat_fwd")),
        ("int8_train", {}, False, False, ("attend_stream_eval",)),
        ("int8_eval", {"fused_attn": True}, False, False, ()),
        ("int8_train", {"fused_attn": True}, True, False, ()))
    for knob, rest, training, warns, ran in rows:
        want = call(training, **rest)
        tpapr._warned.clear()
        reset_counters(kernels, plains)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = call(training, **{**rest, knob: True})
            again = call(training, **{**rest, knob: True})
        named = [w for w in seen
                 if f"tpu.{knob}: true ignored" in str(w.message)]
        launched = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        ok = (torch.equal(got, want) and torch.equal(again, want)
              and len(named) == (1 if warns else 0)
              and not any(n in launched for n in i8)
              and all(launched.get(n) == 2 for n in ran)
              and not any(fn.calls for fn in plains.values()))
        print(f"phase 7 ignored knob: {knob} with {rest or 'streamrec'} on "
              f"{'a training' if training else 'an eval'} call: bit-equal to "
              f"the config without it {bool(torch.equal(got, want))}; "
              f"warnings in two calls {len(named)} (want "
              f"{1 if warns else 0}); launches {launched}", flush=True)
        if not ok:
            fail(f"ignored-knob row {knob} {rest} training={training}")
    del params, state
    torch.cuda.empty_cache()

    # ---- the microbenchmark through its entry point ----
    mb = load_tool("torch_int8_walk_microbench")
    mb.int8_walk_bench.launches = 0
    out = mb.main(["--reps", "10"])
    print(f"phase 7 int8 walk microbenchmark: {json.dumps(out)}", flush=True)
    total["int8_walk_bench"] = mb.int8_walk_bench.launches
    if mb.walk_bench_plain.calls:
        fail("a plain version ran inside the microbenchmark")
    return {"launches": total, "frame_ms": frame_ms, "step_ms": step_ms,
            "bench": out}


def cli_counters():
    """The kernels of the command-line path under ``topk_impl: pallas`` and
    ``fused_attn: true`` (training, eval render, test render), and of its
    two-kernel eval frame."""
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import pallas_topk as pt
    from papr_tpu_torch.ops import stream_attn as sa
    return {"topk_stream": pt.topk_stream,
            "fused_mlp": fm.fused_mlp, "fused_mlp_bwd": fm.fused_mlp_bwd,
            "fused_scores_fwd": fa.fused_scores_fwd,
            "fused_scores_bwd": fa.fused_scores_bwd, "wgrad": fm.wgrad,
            "key_stream_fwd": sa.key_stream_fwd,
            "value_stream_fwd": sa.value_stream_fwd,
            "attend_stream_eval": sa.attend_eval_idx}, counters()[1]


def reset_counters(kernels, plains) -> None:
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains.values():
        fn.calls = 0


def drive_main_path(params, state, cfg, device) -> dict:
    """Phase 3: the serving path, counters reset just before it."""
    import torch
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_frames, render_full_image

    kernels, plains = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels, plains)

    poses = [orbit(2 * np.pi * i / 3) for i in range(3)]
    t0 = time.perf_counter()
    warm = list(render_frames(params, state, cfg, [orbit(0.3)], FOCAL, FOCAL,
                              H, W, H, W))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = list(render_frames(params, state, cfg, poses, FOCAL, FOCAL, H, W,
                                H, W))
    frame_ms = (time.perf_counter() - t0) / len(poses) * 1e3
    th, tw = int(cfg.test.max_height), int(cfg.test.max_width)
    rayo, rayd = get_rays_np(H, W, FOCAL, FOCAL, poses[0][None])
    t0 = time.perf_counter()
    tiled = render_full_image(params, state, cfg, rayo, rayd, th, tw,
                              rgb_only=True, rgb_uint8=True)["rgb"][0]
    tiled_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {n: fn.launches for n, fn in kernels.items()}
    plain_calls = {n: fn.calls for n, fn in plains.items()}

    for i, fr in enumerate(warm + frames + [tiled]):
        if fr.shape != (H, W, 3) or fr.dtype != np.uint8:
            fail(f"frame {i}: {fr.shape} {fr.dtype}, want ({H}, {W}, 3) uint8")
        if int(fr.max()) == int(fr.min()):
            fail(f"frame {i} is constant ({int(fr.max())})")
    diff = np.abs(tiled.astype(np.int16) - frames[0].astype(np.int16))
    close = float((diff.max(-1) <= 2).mean())
    print(f"phase 3 render_frames {H}x{W} (one full-frame tile): first frame "
          f"{first_s:.2f} s, then {frame_ms:.1f} ms/frame over {len(poses)} "
          f"frames; render_full_image {th}x{tw} tiles: {tiled_ms:.1f} ms; "
          f"tiled vs full-tile pixels within 2/255: {close:.6f} (need >= "
          f"{TILED_MIN_CLOSE}), max diff {int(diff.max())}; peak device "
          f"memory {peak_gb:.2f} GiB", flush=True)
    print(f"phase 3 launches {launches}; plain-version calls {plain_calls}",
          flush=True)
    if close < TILED_MIN_CLOSE:
        fail("tiled render disagrees with the full-tile render")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    if max(plain_calls.values()) != 0:
        fail(f"a plain version ran on the card's path: {plain_calls}")
    return {"launches": launches, "frame_ms": frame_ms,
            "tiled_ms": tiled_ms, "peak_gb": peak_gb}


def profile_frames(params, state, cfg, n: int = 3) -> None:
    """Device-time split of n serving frames (torch.profiler, CUPTI kernel
    times): each stage's ms per frame and share, and the device's idle share
    of the window."""
    from papr_tpu_torch.train.step import render_frame

    def frames():
        for i in range(n):
            render_frame(params, state, cfg, orbit(2 * np.pi * i / n), FOCAL,
                         FOCAL, H, W)

    wall_ms, idle, spans = device_profile(frames)
    if not spans:
        print("phase 3 profile: not measured (the profiler saw no device "
              "events)", flush=True)
        return
    split, _ = stage_split(spans, FRAME_STAGES, n)
    print(f"phase 3 profile: {n} frames, {wall_ms / n:.1f} ms/frame under the "
          f"profiler; device idle share {idle:.4f}; per frame: {split}",
          flush=True)


def reference_check(device, side: int = 64) -> float:
    """A small frame through the kernel path (bf16) against the plain
    unfused fp32 path (tpu.fused_attn: false, use_amp: false) on the card,
    on the same weights: relative Frobenius error of the fused features
    (the attention output) and of the fp32 RGB."""
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_full_image

    cfg_k = flagship_cfg()
    cfg_ref = flagship_cfg(amp=False, fused_attn=False)
    params, state = build_model(cfg_k, device)
    focal = FOCAL * side / 800
    rayo, rayd = get_rays_np(side, side, focal, focal, orbit(0.7)[None])
    got = render_full_image(params, state, cfg_k, rayo, rayd, side, side,
                            with_extras=True)
    want = render_full_image(params, state, cfg_ref, rayo, rayd, side, side,
                             with_extras=True)
    rel = lambda a, b: float(np.linalg.norm(a - b)
                             / max(np.linalg.norm(b), 1e-30))
    err_f = rel(got["fused"], want["fused"])
    err_rgb = rel(got["rgb"], want["rgb"])
    ok = (np.isfinite(got["rgb"]).all() and np.isfinite(got["fused"]).all()
          and got["rgb"].shape == (1, side, side, 3))
    print(f"phase 3 reference: {side}x{side} frame, bf16 kernel path vs fp32 "
          f"plain path: fused features rel Frobenius {err_f:.3e}, rgb "
          f"{err_rgb:.3e} (need <= {REF_REL}); finite and shaped: {bool(ok)}",
          flush=True)
    if not (ok and err_f <= REF_REL and err_rgb <= REF_REL):
        fail("kernel path disagrees with the plain fp32 path")
    return err_f


def _snapshot(params, specs):
    from papr_tpu_torch.train.optim import tree_leaves
    return {k: [t.detach().clone() for t in tree_leaves(params[k])]
            for k in specs if k in params}


def drive_training(params, state, cfg, device) -> dict:
    """Phase 4: the training path on the 160x160 patch, counters reset just
    before the timed steps and read just after."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import (apply_updates, build_group_specs,
                                            tree_leaves)
    from papr_tpu_torch.train.points_host import add_points, prune_points
    from papr_tpu_torch.train.step import (loss_and_grads, make_opt_state,
                                           make_train_step)

    policy = policy_from_config(cfg)
    specs = build_group_specs(cfg)
    rayo, rayd = training_patch(device)
    gen = torch.Generator(device=device).manual_seed(4)
    target = torch.rand(1, PATCH, PATCH, 3, generator=gen, device=device)
    c2w = orbit(0.0)
    loss_fn = build_loss(cfg, policy, device=device)
    step_fn = make_train_step(cfg, loss_fn)
    opt = make_opt_state(cfg, params)

    # Warm-up step, spelled out to check the gradients themselves.
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(params, state, cfg, rayo, rayd, target,
                                    c2w, loss_fn, specs, policy)
    apply_updates(params, grads, opt, specs, 1000)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    bad = [k for k in grads
           if not all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads[k]))]
    zero = [k for k in grads
            if max(float(g.abs().max()) for g in tree_leaves(grads[k])) == 0.0]
    if not bool(torch.isfinite(loss)) or bad or zero:
        fail(f"warm-up step: loss {float(loss)}, non-finite gradients {bad}, "
             f"all-zero gradients {zero}")
    del grads

    kernels, plains = counters(training=True)
    before = _snapshot(params, specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels, plains)
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd,
                                          target, c2w, 1001 + i)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = {n: fn.launches for n, fn in kernels.items()}
    plain_calls = {n: fn.calls for n, fn in plains.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(l) for l in losses]
    moved = {k: any(not torch.equal(a, b) for a, b in
                    zip(before[k], tree_leaves(params[k]))) for k in before}
    rays_s = PATCH * PATCH / (step_ms / 1e3)
    print(f"phase 4 train {PATCH}x{PATCH} patch (T={PATCH * PATCH} rays, "
          f"k={cfg.geoms.points.select_k}): warm-up step {warm_s:.2f} s, then "
          f"{step_ms:.1f} ms/step over {TRAIN_STEPS} steps = {rays_s:.0f} "
          f"rays/s; peak device memory {peak_gb:.2f} GiB; losses "
          + ", ".join(f"{l:.6f}" for l in losses), flush=True)
    print(f"phase 4 launches {launches}; plain-version calls {plain_calls}; "
          f"groups moved {moved}", flush=True)
    if not all(np.isfinite(losses)) or pred.shape != (1, PATCH, PATCH, 3):
        fail(f"training step output: losses {losses}, pred {tuple(pred.shape)}")
    if not all(moved.values()):
        fail(f"a trained group did not change: {moved}")
    # wgrad launches once per dense layer of every backward body.
    if any(v != TRAIN_STEPS for n, v in launches.items() if n != "wgrad") \
            or launches["wgrad"] < TRAIN_STEPS:
        fail(f"a training kernel did not launch once per step: {launches}")
    if max(plain_calls.values()) != 0:
        fail(f"a plain version ran on the training path: {plain_calls}")

    profile_train_step(step_fn, params, opt, state, cfg, rayo, rayd, target,
                       c2w, loss_fn, policy)

    # Prune + grow, fresh optimizer state, one more step.
    params, state, n_pr = prune_points(params, state, 0.0)
    params, state, n_add = add_points(params, state, cfg,
                                      int(cfg.training.add_num),
                                      np.random.default_rng(0))
    opt = make_opt_state(cfg, params)
    reset_counters(kernels, plains)
    params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd, target,
                                      c2w, 2000)
    torch.cuda.synchronize()
    launched = {n: fn.launches for n, fn in kernels.items()}
    n_alive = int(state["alive"].sum())
    print(f"phase 4 prune {n_pr} + grow {n_add} points ({n_alive} alive), "
          f"fresh optimizer state: step loss {float(loss):.6f}; launches "
          f"{launched}", flush=True)
    if not (np.isfinite(float(loss)) and n_pr > 0 and n_add > 0
            and all(v == 1 for n, v in launched.items() if n != "wgrad")
            and launched["wgrad"] >= 1
            and all(st["t"] == 1 for st in opt.values())):
        fail("the step after prune / grow failed")
    return {"launches": launches, "step_ms": step_ms, "rays_s": rays_s,
            "peak_gb": peak_gb}


def cli_config(scene: str, save_dir: str, steps: int, **tpu):
    """``configs/default.yml`` with the sphere run's point init and
    ``coord_scale`` (``configs/quality_sphere.yml``): 30,000 padded points
    (10,000 at the cube init), k = 20, 160x160 patches, bf16, MSE + 1e-2
    LPIPS; a prune + grow event at step 10, an eval render and a checkpoint
    every 5 steps, 100x100 render tiles."""
    from papr_tpu_torch.config import load_config
    ds = {"name": "testset", "type": "synthetic", "path": scene}
    return load_config(overrides={
        "index": "chip_smoke", "save_dir": save_dir, "seed": 1,
        "use_amp": True, "max_num_pts": 30000,
        "dataset": {"coord_scale": 1.0, "type": "synthetic", "white_bg": True,
                    "path": scene, "factor": 1},
        "geoms": {"points": {"init_type": "cube",
                             "init_scale": [0.8, 0.8, 0.8],
                             "init_num": 10000}},
        "training": {"steps": steps, "prune_steps": 10, "prune_start": 10,
                     "prune_stop": 12, "add_steps": 10, "add_start": 10,
                     "add_stop": 12, "add_num": 1000},
        "eval": {"dataset": ds, "step": 5, "img_idx": 0, "max_height": 100,
                 "max_width": 100, "save_fig": False},
        "test": {"save_fig": True, "save_video": False, "max_height": 100,
                 "max_width": 100, "datasets": [ds]},
        "tpu": {"topk_impl": "pallas", "fused_attn": True, **tpu}})


def drive_cli_path(device) -> dict:
    """Phase 5: dataset -> training loop -> checkpoint -> resume -> test
    render, in process through ``train_and_eval`` and the test entry point,
    the counters reset just before and read just after."""
    import contextlib
    import io
    import os
    import tempfile

    import torch
    from papr_tpu_torch.cli import test as cli_test
    from papr_tpu_torch.config import Config, make_eval_config, make_test_config
    from papr_tpu_torch.dataset import get_dataset, get_loader
    from papr_tpu_torch.dataset.dataset import device_prefetch
    from papr_tpu_torch.dataset.synth import make_demo_scene
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train import checkpoint as ck
    from papr_tpu_torch.train.loop import train_and_eval
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import tree_leaves
    from papr_tpu_torch.train.step import (make_opt_state, make_train_step,
                                           render_full_image)

    root = tempfile.mkdtemp(prefix="papr_chip_smoke_")
    t0 = time.perf_counter()
    scene = make_demo_scene(os.path.join(root, "scene"), n_train=4, n_test=2,
                            H=H, W=W)
    print(f"phase 5 scene: procedural sphere, 4 train + 2 test + 1 val views "
          f"at {H}x{W} written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    save_dir = os.path.join(root, "experiments")
    cfg = cli_config(scene, save_dir, 12)
    log_dir = os.path.join(save_dir, cfg.index)

    def logged(fn):
        """Run fn with its prints captured (and echoed with a prefix)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"phase 5 | {line}", flush=True)
        return out, text

    kernels, plains = cli_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels, plains)

    # ---- train: 12 steps, eval + checkpoint at 5 and 10, prune + grow at 10 --
    t0 = time.perf_counter()
    (params, opt, state, hist), text = logged(
        lambda: train_and_eval(cfg, make_eval_config(cfg)))
    train_s = time.perf_counter() - t0
    losses = hist["train_losses"]
    if "Training finished!" not in text or "Pruned" not in text \
            or f"Added {int(cfg.training.add_num)} points" not in text:
        fail("the training loop did not finish with its prune + grow event")
    if hist["steps"] != [5, 10] or not all(np.isfinite(losses)) \
            or not all(np.isfinite(hist["eval_psnrs"])):
        fail(f"training histories: {hist}")

    # ---- the checkpoint restores bit for bit; resume takes two more steps --
    from papr_tpu_torch.model.papr import create_model
    step, tree = ck.load_checkpoint(log_dir)
    fresh_p, fresh_s = create_model(cfg, seed=7, device=device)
    same = step == 12
    for got, want in ((ck.restore_into(fresh_p, tree["params"]), params),
                      (ck.restore_into(fresh_s, tree["state"]), state),
                      (ck.restore_into(make_opt_state(cfg, fresh_p),
                                       tree["opt_state"]), opt)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            same &= (bool(torch.equal(a, b)) if isinstance(a, torch.Tensor)
                     else a == b)
    t_before = {k: v["t"] for k, v in opt.items()}
    cfg14 = cli_config(scene, save_dir, 14)
    (params, opt, state, hist2), text = logged(
        lambda: train_and_eval(cfg14, make_eval_config(cfg14), resume=1))
    step2, _ = ck.load_checkpoint(log_dir)
    t_after = {k: v["t"] for k, v in opt.items()}
    print(f"phase 5 train_and_eval: 12 steps in {train_s:.1f} s (dataset, "
          f"loss and eval renders included); mean loss steps 1-5 "
          f"{losses[0]:.6f}, steps 6-10 {losses[1]:.6f}; eval PSNR "
          + ", ".join(f"{p:.3f}" for p in hist["eval_psnrs"])
          + f"; checkpoint at step {step} restored bit-equal (parameters, "
          f"alive mask, Adam moments and t): {same}; resume -> step {step2}, "
          f"Adam t {t_before} -> {t_after}", flush=True)
    if not (same and "Resume from step 12" in text and step2 == 14
            and all(t_after[k] == t_before[k] + 2 for k in t_after)):
        fail("checkpoint / resume did not restore the training state")

    # ---- the test entry point over the test split, 100x100 tiles ----
    entry = Config(cfg14.test.datasets[0])
    tcfg = make_test_config(cfg14, entry)
    t0 = time.perf_counter()
    means, text = logged(lambda: cli_test.run_test(tcfg, entry.name,
                                                   entry.mode, 14))
    test_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    plain_calls = {n: fn.calls for n, fn in plains.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    pngs = [f for f in os.listdir(os.path.join(log_dir, "test", "images"))
            if f.endswith("-predrgb.png")]
    print(f"phase 5 test entry point: 2 frames at {H}x{W} in 100x100 tiles in "
          f"{test_s:.1f} s; PSNR {means['psnr']:.4f}, SSIM {means['ssim']:.4f}"
          f", loss {means['loss']:.6f}; {len(pngs)} predrgb PNGs; peak device "
          f"memory {peak_gb:.2f} GiB", flush=True)
    print(f"phase 5 launches {launches}; plain-version calls {plain_calls}",
          flush=True)
    if not (np.isfinite(means["psnr"]) and np.isfinite(means["ssim"])
            and "test PSNR:" in text and len(pngs) == 2):
        fail(f"the test render failed: {means}")
    need = ("topk_stream", "fused_mlp", "fused_mlp_bwd", "fused_scores_fwd",
            "fused_scores_bwd", "wgrad")
    if min(launches[n] for n in need) <= 0:
        fail(f"a kernel of the command-line path never launched: {launches}")
    if launches["fused_mlp"] < 3 * 14 or launches["fused_mlp_bwd"] != 3 * 14:
        fail(f"the fused embedder did not run on all three stacks: {launches}")
    if max(plain_calls.values()) != 0:
        fail(f"a plain version ran on the command-line path: {plain_calls}")

    # ---- one frame through the two-kernel eval path against the one-shot --
    # After 14 steps the influence scores are still 0 (every score 0, the
    # attention uniform), so these comparisons give the trained model seeded
    # random ones, as build_model does: the score path then decides pixels.
    test_set = get_dataset(tcfg.dataset, mode="test")
    _, rayd, rayo = test_set.get_full_img(0)
    probe = dict(params)
    probe["points_influ_scores"] = torch.randn(
        params["points_influ_scores"].shape,
        generator=torch.Generator().manual_seed(8)).to(device)
    frames = {}
    for name, tpu in (("split-kernel", {}),
                      ("one-shot", {"fused_attn": "streamrec"}),
                      ("two-kernel", {"fused_attn": "streamrec",
                                      "eval_fused": False})):
        c = cli_config(scene, save_dir, 14, **tpu)
        t0 = time.perf_counter()
        frames[name] = render_full_image(probe, state, c, rayo, rayd, 100,
                                         100, rgb_only=True,
                                         rgb_uint8=True)["rgb"][0]
        frames[name + " ms"] = (time.perf_counter() - t0) * 1e3
    two = {n: kernels[n].launches - launches[n]
           for n in ("key_stream_fwd", "value_stream_fwd",
                     "attend_stream_eval")}
    plain_calls = {n: fn.calls for n, fn in plains.items()}
    diff = np.abs(frames["two-kernel"].astype(np.int16)
                  - frames["one-shot"].astype(np.int16))
    close = float((diff.max(-1) <= 2).mean())
    sdiff = np.abs(frames["split-kernel"].astype(np.int16)
                   - frames["one-shot"].astype(np.int16))
    sclose = float((sdiff.max(-1) <= 2).mean())
    mse = float(np.mean((sdiff / 255.0) ** 2))
    print(f"phase 5 split-kernel frame (fused_attn true, topk_impl pallas) "
          f"against the one-shot kernel's frame (cull selection): pixels "
          f"within 2/255: {sclose:.6f} (need >= {EVAL_SPLIT_MIN_CLOSE}), max "
          f"diff {int(sdiff.max())}, PSNR between them "
          f"{-10 * np.log10(max(mse, 1e-12)):.2f} dB", flush=True)
    # The same two paths before the UNet: fused features and attention of
    # the whole frame (the uint8 pixels hide small differences).
    att = {name: render_full_image(
        probe, state, cli_config(scene, save_dir, 14, **tpu), rayo, rayd,
        100, 100, attention_only=True)
        for name, tpu in (("split", {}), ("one-shot",
                                          {"fused_attn": "streamrec"}))}
    f_rel = float(np.linalg.norm(att["split"]["fused"] - att["one-shot"]["fused"])
                  / max(np.linalg.norm(att["one-shot"]["fused"]), 1e-30))
    a_abs = float(np.abs(att["split"]["attn"] - att["one-shot"]["attn"]).max())
    fg = 1.0 - att["one-shot"]["attn"][..., -1, 0]
    # Selected positions (..., K, 3), each coordinate sorted along K.
    same_sel = float((np.sort(att["split"]["selected"], -2)
                      == np.sort(att["one-shot"]["selected"], -2))
                     .all((-1, -2)).mean())
    print(f"phase 5 split-kernel attention against the one-shot kernel's, "
          f"whole frame: fused features rel Frobenius {f_rel:.3e} (need <= "
          f"{SPLIT_FUSED_REL}), attn max abs {a_abs:.3e} (need <= "
          f"{SPLIT_ATTN_ABS}); "
          f"rays with the same selection {same_sel:.6f}; foreground "
          f"attention mean {float(fg.mean()):.4f}, max {float(fg.max()):.4f}",
          flush=True)
    if not (sclose >= EVAL_SPLIT_MIN_CLOSE and f_rel <= SPLIT_FUSED_REL
            and a_abs <= SPLIT_ATTN_ABS and float(fg.max()) > float(fg.min())):
        fail("the split-kernel eval frame disagrees with the one-shot kernel")
    del att
    print(f"phase 5 eval_fused false: two-kernel frame "
          f"{frames['two-kernel ms']:.1f} ms, one-shot frame "
          f"{frames['one-shot ms']:.1f} ms, the command-line path's "
          f"split-kernel frame (fused_attn true, topk_impl pallas) "
          f"{frames['split-kernel ms']:.1f} ms ({H}x{W}, 100x100 tiles, the "
          f"first two include warm-up); pixels within 2/255: {close:.6f} "
          f"(need >= {EVAL_TWO_MIN_CLOSE}), max diff {int(diff.max())}; "
          f"launches {two}", flush=True)
    if not (close >= EVAL_TWO_MIN_CLOSE and two["key_stream_fwd"] == 64
            and two["value_stream_fwd"] == 64
            and two["attend_stream_eval"] == 64
            and max(plain_calls.values()) == 0
            and int(frames["one-shot"].max()) > int(frames["one-shot"].min())):
        fail("the two-kernel eval path disagrees with the one-shot kernel")

    # ---- ms/step and idle share: a fixed batch against the real loader, and
    # the other training mode on the same model and batch ----
    policy = policy_from_config(cfg)
    loss_fn = build_loss(cfg, policy, device=device)
    steps = {"topk_impl pallas, fused_attn true": make_train_step(cfg, loss_fn),
             "topk_impl cull, fused_attn streamrec": make_train_step(
                 cli_config(scene, save_dir, 14, topk_impl="cull",
                            fused_attn="streamrec"), loss_fn)}
    dataset = get_dataset(cfg.dataset, mode="train", seed=int(cfg.seed))

    def batches():
        while True:
            yield from device_prefetch(get_loader(dataset, cfg.dataset),
                                       device=device)

    feed = batches()
    fixed = next(feed)
    n_rays = fixed.rayd[..., 0].numel()
    cli_mode, other_mode = steps

    def run(n, mode, source):
        losses = []
        for i in range(n):
            b = source()
            losses.append(steps[mode](params, opt, state, b.rayo, b.rayd,
                                      b.image, b.c2w, 1000 + i)[2])
        return losses

    out = {}
    for name, mode, source in (("fixed batch", cli_mode, lambda: fixed),
                               ("real loader", cli_mode, lambda: next(feed)),
                               ("fixed batch", other_mode, lambda: fixed)):
        seen = run(1, mode, source)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen += run(TRAIN_STEPS, mode, source)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        wall, idle, spans = device_profile(lambda: run(3, mode, source))
        split, kern = stage_split(spans, TRAIN_STAGES, 3, TRAIN_OTHER)
        out[name, mode] = ms
        if name == "fixed batch":
            # The loop's patches are random crops (some all background), so
            # the loss is held to fall where the batch stays the same.
            fixed_losses = [float(l) for l in seen]
            if not (all(np.isfinite(fixed_losses))
                    and fixed_losses[-1] < fixed_losses[0]):
                fail(f"the loss on a fixed batch did not fall: {fixed_losses}")
            print(f"phase 5 losses on the fixed batch ({mode}): "
                  + ", ".join(f"{l:.6f}" for l in fixed_losses), flush=True)
        print(f"phase 5 step ({name}; {mode}, {n_rays} rays): {ms:.1f} ms/step "
              f"over {TRAIN_STEPS} steps = {n_rays / ms * 1e3:.0f} rays/s; 3 "
              f"profiled steps: {wall / 3:.1f} ms/step, device idle share "
              f"{idle:.4f}, kernel time {kern:.3f} ms/step: {split}; largest "
              f"of 'other': {largest_unstaged(spans, TRAIN_STAGES, 3)}",
              flush=True)
    plain_calls = {n: fn.calls for n, fn in plains.items()}
    if max(plain_calls.values()) != 0:
        fail(f"a plain version ran in the timed steps: {plain_calls}")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    # The trained model with its seeded influence scores and the test view's
    # rays, for the int8 frame of phase 7.
    model = (probe, state, rayo, rayd,
             lambda **tpu: cli_config(scene, save_dir, 14,
                                      fused_attn="streamrec", **tpu))
    return {"launches": launches, "step_ms": out["real loader", cli_mode],
            "model": model}


def device_profile(fn):
    """One call of fn under torch.profiler (CUPTI kernel times): returns
    (host wall ms, device idle share of the window, kernel spans as
    (start, end, name)); no spans when the profiler saw no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.device_type == DeviceType.CUDA})
    if not spans:
        return wall_ms, float("nan"), spans
    busy, end = 0.0, spans[0][0]
    for s0, e0, _ in spans:
        busy += max(e0 - max(s0, end), 0.0)
        end = max(end, e0)
    return wall_ms, 1.0 - busy / (end - spans[0][0]), spans


# Stage of a device kernel: the first pattern found in its name.
FRAME_STAGES = (("K3 attend_eval_i8", "attend_eval_i8_wgmma_kernel"),
                ("K3 attend_eval", "attend_eval"), ("K2 fused_mlp", "fused_mlp"),
                ("K1 cull", "cull_topk"), ("sort", "Sort"),
                ("conv (cuDNN)", "fprop"), ("gemm", "gemm"))
# The stream frame's: the feature forwards (wgmma, or the WMMA kernels of an
# earlier tree) and the key's softmax kernel, then a frame's.
FEAT_FRAME_STAGES = (("key stream fwd (features)", "key_feat_fwd_"),
                     ("key stream fwd (features)", "keyf_fwd_kernel"),
                     ("key softmax", "key_fwd_softmax"),
                     ("value stream fwd (features)", "value_feat_fwd_"),
                     ("value stream fwd (features)", "valuef_fwd_kernel")) \
    + FRAME_STAGES
# The query_fold frame's: the fp32 query chain and the key forward it feeds
# (wgmma), or the folded WMMA kernel of an earlier tree, then a frame's.
FOLD_FRAME_STAGES = (("query chain fwd (query folded)", "query_head_fwd_"),
                     ("key stream fwd (query folded, WMMA)", "keyq_fwd_kernel"),
                     ("key softmax", "key_fwd_softmax"),
                     ("key stream fwd", "key_fwd_"),
                     ("value stream fwd", "value_fwd_")) + FRAME_STAGES
TRAIN_STAGES = (("selection (cull kernel)", "cull_topk"),
                ("selection (streaming top-k kernel)", "topk_stream"),
                ("embedder fwd", "fused_mlp_fwd_"),
                ("embedder bwd", "fused_mlp_bwd_"),
                ("fused scores fwd", "fused_scores_fwd_kernel"),
                ("fused scores bwd", "fused_scores_bwd_kernel"),
                ("key softmax", "key_fwd_softmax"),
                ("key stream fwd", "key_fwd_"),
                ("key stream fwd (int8)", "key_i8_fwd_kernel"),
                ("value stream fwd (int8)", "value_i8_fwd_kernel"),
                ("key stream bwd", "key_bwd_"),
                ("value stream fwd", "value_fwd_"),
                ("value stream bwd", "value_bwd_"),
                ("key stream fwd (query folded)", "keyq_fwd_kernel"),
                ("key stream bwd (query folded)", "keyq_bwd_kernel"),
                ("query chain fwd (query folded)", "query_head_fwd_"),
                ("query chain bwd (query folded)", "query_head_bwd_"),
                ("key stream fwd (features)", "keyf_fwd_kernel"),
                ("key stream fwd (features)", "key_feat_fwd_"),
                ("key stream bwd (features)", "keyf_bwd_kernel"),
                ("value stream fwd (features)", "valuef_fwd_kernel"),
                ("value stream fwd (features)", "value_feat_fwd_"),
                ("value stream bwd (features)", "valuef_bwd_kernel"),
                ("dW reduction (wgrad)", "wgrad_"),
                ("dW reduction (wgrad)", "colsum_kernel"),
                ("selection (prefilter sort / top-k)", "ort"),
                ("selection (prefilter sort / top-k)", "topk"),
                ("convolutions (UNet + LPIPS)", "conv"),
                ("convolutions (UNet + LPIPS)", "xmma"),
                ("convolutions (UNet + LPIPS)", "cudnn"),
                ("gemm", "gemm"))
TRAIN_OTHER = ("other (gather / scatter, elementwise, UNet / LPIPS non-conv, "
               "optimizer)")


def stage_split(spans, stages, n: int, other: str = "other"):
    """Kernel time of the spans by stage -> ("stage x ms (y %), ..." per unit
    over n units, largest first; total kernel ms per unit)."""
    by = {}
    for s0, e0, name in spans:
        stage = next((k for k, pat in stages if pat in name), other)
        by[stage] = by.get(stage, 0.0) + (e0 - s0)
    total = sum(by.values())
    text = ", ".join(f"{k} {v / n / 1e3:.3f} ms ({100 * v / total:.1f} %)"
                     for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    return text, total / n / 1e3


def largest_unstaged(spans, stages, n: int, count: int = 3) -> str:
    """The kernels no stage pattern names, largest first: "name x ms" per
    unit over n units."""
    by = {}
    for s0, e0, name in spans:
        if not any(pat in name for _, pat in stages):
            by[name] = by.get(name, 0.0) + (e0 - s0)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
    return ", ".join(f"{k[:70]} {v / n / 1e3:.3f} ms" for k, v in top)


def kernels_by_op(fn, pattern: str = "", count: int = 6) -> str:
    """One call of fn under torch.profiler with input shapes and Python
    stacks: the device time of the kernels whose name holds ``pattern``,
    grouped by the operator that launched them, its input shapes and where
    it came from (the nearest frames of this repository, or the autograd
    node for a backward op): "op shapes <- origin x ms (n kernels)", largest
    first; "not measured" when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()

    def origin(e):
        node, p, top = None, e, e.name
        while p is not None:
            if node is None and "evaluate_function" in p.name:
                node = p.name.split(": ", 1)[-1]
            frames = [f for f in (p.stack or [])
                      if "papr_tpu_torch" in f or "chip_smoke" in f]
            if frames:
                return " < ".join(frames[:3]) + (f" [{node}]" if node else "")
            top = p.name
            p = p.cpu_parent
        return node or f"under {top}"

    by = {}
    for e in prof.events():
        # The profiler's own bookkeeping spans claim every kernel.
        if e.device_type != DeviceType.CPU or "Buffer" in e.name:
            continue
        hit = [kk for kk in getattr(e, "kernels", []) if pattern in kk.name]
        if not hit:
            continue
        key = (e.name, str(e.input_shapes)[:80], origin(e))
        t, n = by.get(key, (0.0, 0))
        by[key] = (t + sum(kk.duration for kk in hit), n + len(hit))
    if not by:
        return "not measured"
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:count]
    return "; ".join(f"{op} {shapes} <- {orig}: {t / 1e3:.3f} ms ({n} kernels)"
                     for (op, shapes, orig), (t, n) in top)


def profile_train_step(step_fn, params, opt, state, cfg, rayo, rayd, target,
                       c2w, loss_fn, policy) -> None:
    """Device-time split of one training step by stage (kernel names), the
    device's idle share, and the UNet, LPIPS and optimizer stages run alone
    (their convolution and elementwise kernels carry no stage in their
    names): device kernel time and host wall each."""
    import torch
    from papr_tpu_torch.model.papr import render_foreground
    from papr_tpu_torch.train.optim import (apply_updates, build_group_specs,
                                            init_opt_state, tree_map)

    wall_ms, idle, spans = device_profile(
        lambda: step_fn(params, opt, state, rayo, rayd, target, c2w, 1500))
    if not spans:
        print("phase 4 profile: not measured (the profiler saw no device "
              "events)", flush=True)
        return
    split, total = stage_split(spans, TRAIN_STAGES, 1, TRAIN_OTHER)
    print(f"phase 4 profile: one step, {wall_ms:.1f} ms under the profiler; "
          f"device idle share {idle:.4f}; kernel time {total:.3f} ms: "
          f"{split}", flush=True)
    # The bf16 embedder and stream forwards and backwards ran their wgmma
    # kernels.
    names = {n for _, _, n in spans}
    wg = {k: any(k in n for n in names)
          for k in ("fused_mlp_fwd_wgmma_kernel", "fused_mlp_bwd_wgmma_kernel",
                    "key_fwd_wgmma_kernel", "value_fwd_wgmma_kernel",
                    "key_bwd_wgmma_kernel", "value_bwd_wgmma_kernel")}
    print(f"phase 4 profile names the wgmma kernels: {wg}", flush=True)
    if not all(wg.values()):
        fail(f"the training step did not run the wgmma kernels: {wg}")

    feats = torch.randn(1, PATCH, PATCH,
                        int(cfg.models.attn.embed.value.d_ff_out),
                        device=rayd.device, requires_grad=True)
    pred = torch.rand(1, PATCH, PATCH, 3, device=rayd.device)
    rp = tree_map(lambda t: t.detach().requires_grad_(True),
                  params["renderer"])

    def unet():
        render_foreground({"renderer": rp}, cfg, feats,
                          policy=policy).sum().backward()

    def lpips():
        loss_fn(pred.detach().requires_grad_(True), target).backward()

    specs = build_group_specs(cfg)
    grads = tree_map(torch.ones_like, {k: params[k] for k in specs
                                       if k in params})
    scratch = {k: tree_map(torch.clone, params[k]) for k in grads}
    st = init_opt_state(scratch, specs)
    adam = lambda: apply_updates(scratch, grads, st, specs, 1000)
    parts = []
    for name, fn in (("UNet fwd + bwd", unet), ("MSE + LPIPS fwd + bwd", lpips),
                     ("Adam update", adam)):
        fn()
        w_ms, _, sp = device_profile(fn)
        dev_ms = sum(e0 - s0 for s0, e0, _ in sp) / 1e3
        parts.append(f"{name} {dev_ms:.3f} ms device ({w_ms:.3f} ms host)")
    print("phase 4 stages alone: " + ", ".join(parts), flush=True)


REF_MODES = (("streamrec + cull", {"topk_impl": "cull"}),
             ("true + pallas", {"topk_impl": "pallas", "fused_attn": True}))
REF_INT8_MODES = (("streamrec + int8_train + cull",
                   {"topk_impl": "cull", "fused_attn": "streamrec",
                    "int8_train": True}),)
REF_STREAM_MODES = (("stream + cull", {"topk_impl": "cull",
                                       "fused_attn": "stream"}),
                    ("streamrec + query_fold + cull",
                     {"topk_impl": "cull", "fused_attn": "streamrec",
                      "query_fold": True}))


def train_reference_check(device, modes=REF_MODES, phase: int = 4,
                          side: int = 32, make_cfg=flagship_cfg, view=None,
                          code=None, bounds=(TRAIN_REF_LOSS_REL,
                                             TRAIN_REF_GRAD_REL),
                          dtype: str = "bf16", group_bounds=None,
                          compute_plain: bool = False) -> None:
    """One training step's loss and gradients at a 32x32 patch: each kernel
    path of ``modes`` (``make_cfg(**tpu)``: by default the flagship widths,
    bf16) against the plain fp32 path (``make_cfg(amp=False, ...)`` with
    tpu.fused_attn: false) on the same weights and the same selection.
    ``view``: (rays_o, rays_d, target, c2w) of the patch (default a crop of
    the orbit camera's rays and a random target); ``code``: the shading code
    both steps take; ``bounds``: (loss, gradient) relative bounds, and
    ``group_bounds`` a gradient bound for a named group instead;
    ``compute_plain``: also print what the plain path in the kernel path's
    compute dtype reads against the plain fp32 path."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
    from papr_tpu_torch.train.step import loss_and_grads

    if view is None:
        rayo, rayd = training_patch(device, seed=1)
        rayd = rayd[:, :side, :side].contiguous()
        gen = torch.Generator(device=device).manual_seed(5)
        target = torch.rand(1, side, side, 3, generator=gen, device=device)
        c2w = orbit(0.0)
    else:
        rayo, rayd, target, c2w = view
    if code is not None:
        code = torch.as_tensor(code, device=device)

    def step(cfg):
        params, state = build_model(cfg, device)
        policy = policy_from_config(cfg)
        loss, _, grads = loss_and_grads(
            params, state, cfg, rayo, rayd, target, c2w,
            build_loss(cfg, policy, device=device), build_group_specs(cfg),
            policy, shading_code=code)
        return float(loss), {k: torch.cat([g.float().reshape(-1)
                                           for g in tree_leaves(v)])
                             for k, v in grads.items()}

    # Each kernel path against the plain path on the same selection.
    loss_bound, grad_bound = bounds
    for name, tpu in modes:
        lk, gk = step(make_cfg(**tpu))
        lp, gp = step(make_cfg(amp=False, **{**tpu, "fused_attn": False}))
        loss_rel = abs(lk - lp) / max(abs(lp), 1e-30)
        errs = {k: rel_fro(gk[k], gp[k]) for k in gp}
        limit = {k: (group_bounds or {}).get(k, grad_bound) for k in gp}
        finite = np.isfinite(lk) and all(bool(torch.isfinite(g).all())
                                         for g in gk.values())
        print(f"phase {phase} reference: {rayd.shape[1]}x{rayd.shape[2]} "
              f"patch, one step, {dtype} kernel path ({name}) vs fp32 plain "
              f"path: loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}, need <= "
              f"{loss_bound}); gradient rel Frobenius "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (need <= {grad_bound}"
              + "".join(f", {k} <= {v}" for k, v in (group_bounds or {})
                        .items()) + f"); finite {finite}", flush=True)
        if compute_plain:
            lc, gc = step(make_cfg(**{**tpu, "fused_attn": False}))
            print(f"phase {phase} reference: the {dtype} plain path "
                  f"(fused_attn false) vs fp32 plain path: loss rel "
                  f"{abs(lc - lp) / max(abs(lp), 1e-30):.3e}; gradient rel "
                  "Frobenius " + ", ".join(f"{k} {rel_fro(gc[k], gp[k]):.3e}"
                                           for k in gp), flush=True)
        if not (finite and loss_rel <= loss_bound
                and all(errs[k] <= limit[k] for k in errs)):
            fail(f"the training step's kernel path ({name}) disagrees with "
                 "the plain path")


# ------------------------------------------------------------- phase 8 ----

def f32_counters():
    """The fp32 kernels of the ``use_amp: false`` path, their bf16 twins
    (which must not launch there) and every plain version."""
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import tile_cull as tc
    f32 = {"cull_select": tc.cull_select, "fused_mlp_f32": fm.fused_mlp_f32,
           "fused_mlp_bwd_f32": fm.fused_mlp_bwd_f32,
           "attend_eval_f32": sa.attend_eval_f32,
           "key_stream_f32_fwd": sa.key_stream_f32_fwd,
           "key_stream_f32_bwd": sa.key_stream_f32_bwd,
           "value_stream_f32_fwd": sa.value_stream_f32_fwd,
           "value_stream_f32_bwd": sa.value_stream_f32_bwd,
           "wgrad_f32": fm.wgrad_f32}
    bf16 = {"fused_mlp": fm.fused_mlp, "fused_mlp_bwd": fm.fused_mlp_bwd,
            "attend_stream_eval": sa.attend_eval_idx,
            "key_stream_fwd": sa.key_stream_fwd,
            "key_stream_bwd": sa.key_stream_bwd,
            "value_stream_fwd": sa.value_stream_fwd,
            "value_stream_bwd": sa.value_stream_bwd, "wgrad": fm.wgrad}
    return f32, bf16, counters()[1]


def caterpillar_cfg(over=None, **tpu):
    """``configs/t2/Caterpillar.yml`` merged onto ``configs/default.yml`` as
    the loader merges them, with ``over`` and ``tpu`` on top."""
    from papr_tpu_torch.config import load_config, merge_config
    o = {"tpu": {"ray_chunk": 4096, **tpu}}
    if over:
        merge_config(o, over)
    return load_config(CATERPILLAR, overrides=o)


def sphere_view(cfg, device, theta: float = 0.6):
    """``dataset/synth.py``'s sphere seen at 800x800 (focal 700) from an orbit
    camera at 4 scene units, its position scaled by ``coord_scale`` as the
    loader scales it: (c2w in the model's coordinates, rays_o (1, 3), rays_d
    (1, H, W, 3), the sphere's RGB on white (1, H, W, 3)), on the card."""
    import torch
    from papr_tpu_torch.dataset.synth import _look_at, render_sphere
    from papr_tpu_torch.ops.geometry import get_rays
    c2w = _look_at(4.0 * np.array([np.sin(theta), 0.35, np.cos(theta)]))
    rgba = render_sphere(c2w, H, W, FOCAL)
    rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
    c2w[:3, 3] *= float(cfg.dataset.coord_scale)
    rayo, rayd = get_rays(H, W, torch.as_tensor(c2w, device=device),
                          torch.tensor([FOCAL, FOCAL], device=device))
    return (c2w, rayo, rayd[None].contiguous(),
            torch.as_tensor(rgb[None].astype(np.float32), device=device))


def crop(t, side: int):
    """The central side x side crop of a (1, H, W, c) tensor."""
    r0 = (H - side) // 2
    return t[:, r0:r0 + side, r0:r0 + side].contiguous()


def tokens_margin(x, walk):
    """``walk_relu_margin`` of a walk over k-major raw features x (K, T, d),
    per ray: the smallest over the ray's K tokens."""
    from papr_tpu_torch.ops import fused_mlp as fm
    K, T, d = x.shape
    enc = fm.encode_plain(x.reshape(K * T, d), walk.cols)
    return fm.walk_relu_margin(enc, walk).reshape(K, T).amin(dim=0)


def tf32_reading(fn, want) -> float:
    """What a single TF32 pass reads: ``fn`` (a plain fp32 version) with
    TF32 products on, its relative Frobenius error against ``want``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return rel_fro(got, want)


def compare_f32_kernels(params, state, cfg, device, rayo, rayd, patch,
                        n_time: int = 3) -> list:
    """Phase 8: each fp32 kernel against its plain fp32 version at
    Caterpillar's shapes: the query embedder on the frame's 640,000 rays,
    its backward, the one-shot eval attention and the key / value streams
    (forward and backward) on the 180x180 patch (T = 32,400, K = 20), and
    the dW reduction on the key stack's (K * T, 256) x (K * T, 256)."""
    import torch
    from papr_tpu_torch.config import load_config
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.model.papr import (_split_embeddings, _stream_inputs,
                                           model_meta)
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf

    f32 = torch.float32
    k = int(cfg.geoms.points.select_k)
    eps = float(cfg.eps)
    score_act = cfg.models.attn.score_act
    bkg = float(cfg.geoms.background.constant)
    normalize = bool(cfg.models.normalize_topk_attn)
    gen = torch.Generator(device=device).manual_seed(8)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    results, failed = [], []

    def firm(cot, margin, what):
        """The cotangent with the rows whose relu margin is under
        F32_MARGIN zeroed."""
        keep = margin >= F32_MARGIN
        print(f"phase 8 {what}: rows held (relu margin >= {F32_MARGIN}) "
              f"{float(keep.float().mean()):.4f}", flush=True)
        return torch.where(keep[:, None], cot, 0.0)

    def record(name, source, replaces, fn, plain, tol, labels, in_bytes,
               flops, tf32=None, attn_tol=None, library=None,
               rate=F32_TC_FLOPS, stack_of=None, median=None, earlier=None,
               span=None, n_walk=0, hold_in=False):
        """Kernel against its plain fp32 version; with ``stack_of`` the
        reading goes into that kernel's record as a stack it also runs;
        ``median`` (output index, bound): the median over rays of that
        output row's relative error, held to the bound; ``span`` (a
        kernel name pattern) times the kernel alone too (its profiler span),
        beside its earlier WMMA kernel's (F32_BWD_WMMA_MS, F32_FWD_WMMA_MS
        or F32_EMBED_WMMA_MS by name); the last
        ``n_walk`` outputs (a walk's gradients) are held to
        F32_BWD_WALK_REL too; ``hold_in`` holds the walk's input-side
        gradients (b0, ln_in.a, ln_in.b) to F32_BWD_IN_REL."""
        g, w = fn(), plain()
        torch.cuda.synchronize()
        rels = _rels(g, w)
        finite = all(bool(torch.isfinite(t).all()) for t in g)
        ms, p_ms = cuda_ms(fn, n_time), cuda_ms(plain, 1)
        work = bound(in_bytes + nbytes(*g), flops, rate)
        if library is not None:
            work["library_ms"] = cuda_ms(library, n_time)
        worst = max(rels)
        line = (f"phase 8 {name}: rel Frobenius "
                + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, rels))
                + f" (max {worst:.3e}, need <= {tol}); finite {finite}")
        ok = finite and worst <= tol and len(rels) == len(labels)
        if attn_tol is not None:
            a_abs = float((g[0] - w[0]).abs().max())
            if attn_tol == "printed":
                line += (f"; attn max abs {a_abs:.3e} (printed: a flipped "
                         "quantized activation moves a near-tie ray)")
            else:
                line += f"; attn max abs {a_abs:.3e} (need <= {attn_tol})"
                ok &= a_abs <= attn_tol
        if n_walk:
            w_max = max(rels[-n_walk:])
            line += (f"; the walk's gradients max {w_max:.3e} (need <= "
                     f"{F32_BWD_WALK_REL})")
            ok &= w_max <= F32_BWD_WALK_REL
        if hold_in:
            ins = [r for l, r in zip(labels, rels)
                   if l in ("b0", "ln_in.a", "ln_in.b")]
            line += (f"; the walk's input-side gradients (b0, ln_in) max "
                     f"{max(ins):.3e} (need <= {F32_BWD_IN_REL})")
            ok &= max(ins) <= F32_BWD_IN_REL
        if median is not None:
            i, m_tol = median
            d = (g[i] - w[i]).norm(dim=-1)
            n = w[i].norm(dim=-1)
            med = float((d[n > 0] / n[n > 0]).median())
            line += (f"; median ray {labels[i]} rel {med:.3e} (need <= "
                     f"{m_tol})")
            ok &= med <= m_tol
        if tf32 is not None:
            t = tf32()
            line += (f"; one TF32 pass would read {t:.3e} (need > {tol}, the "
                     "bound catches it)")
            ok &= t > tol
        line += f"; kernel {ms:.3f} ms"
        if earlier is not None:
            line += f" ({earlier})"
        alone = None
        if span is not None:
            ran = []
            alone = kernel_span_ms(fn, span, names=ran)
            old = {**F32_BWD_WMMA_MS, **F32_FWD_WMMA_MS,
                   **F32_EMBED_WMMA_MS}.get(name)
            rest = ("wgrad_f32, colsum, the combine kernel, packs, host"
                    if "_bwd" in name else
                    "the pack, the output's allocation, host")
            line += (f"; kernel alone {alone:.3f} ms ({' + '.join(ran)}; the "
                     f"rest of the call {ms - alone:.3f} ms: {rest}"
                     + (f"; the earlier WMMA kernel: call {old[0]} ms, alone "
                        f"{old[1]} ms)" if old else ")"))
        line += (f", plain {p_ms:.3f} ms, bound "
                 f"{work['bound_ms']:.4f} ms ({work['bound_by']})")
        if library is not None:
            line += f", torch.matmul {work['library_ms']:.3f} ms"
        print(line, flush=True)
        if not ok:
            failed.append(name)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "max_abs_err": _max_abs(g, w),
                 "max_rel_err": worst, "ms": ms, "plain_ms": p_ms, **work}
        if alone is not None:
            entry["kernel_alone_ms"] = alone
        if stack_of is None:
            results.append(entry)
        else:
            owner = next(r for r in results if r["name"] == stack_of)
            owner.setdefault("stacks", {})[name] = entry
        return g

    # Row 2: the query embedder on the frame's rays.
    qwalk = query_walk(params, cfg)
    x = rayd.reshape(-1, 3).contiguous()
    record("fused_mlp_f32", "papr_tpu_torch/csrc/fused_mlp.cu",
           "papr_tpu/ops/fused_mlp.py:417",
           lambda: [fm.fused_mlp_f32(x, qwalk)],
           lambda: [fm.fused_mlp_plain(x, qwalk, f32)], F32_FWD_REL, ["y"],
           nbytes(x) + walk_bytes(qwalk), x.shape[0] * walk_flops(qwalk),
           tf32=lambda: tf32_reading(lambda: fm.fused_mlp_plain(x, qwalk, f32),
                                     fm.fused_mlp_plain(x, qwalk, f32)),
           span="fused_mlp_fwd_wgmma_f32", median=(0, F32_EMBED_MEDIAN_REL))
    # Row 3 on the patch's rays.
    T = patch * patch
    xp = crop(rayd, patch).reshape(T, 3)
    dy = firm(randn(T, int(qwalk.ws[-1].shape[1])),
              fm.walk_relu_margin(fm.encode_plain(xp, qwalk.cols), qwalk),
              "fused_mlp_bwd_f32")
    record("fused_mlp_bwd_f32", "papr_tpu_torch/csrc/fused_mlp_bwd.cu",
           "papr_tpu/ops/fused_mlp.py:424",
           lambda: (lambda r: [r[0]] + r[1])(fm.fused_mlp_bwd_f32(xp, dy,
                                                                  qwalk)),
           lambda: (lambda r: [r[0]] + r[1])(fm.fused_mlp_bwd_plain(
               xp, dy, qwalk, f32)),
           F32_BWD_REL, ["dx"] + walk_labels(qwalk),
           nbytes(xp, dy) + walk_bytes(qwalk), 3 * T * walk_flops(qwalk),
           span="fused_mlp_bwd_wgmma_f32", hold_in=True)

    idx, record_, rec, rayo_f, rays, rayd_f, qq, kwalk, vwalk = \
        stream_patch_inputs(params, state, cfg, rayo, crop(rayd, patch))
    wk, bk = params["attn"]["w_k"]["w"], params["attn"]["w_k"]["bias"]
    # Row 4 on the patch (the one-shot eval attention reads the record by
    # index).
    eargs = (record_, idx, rayo_f, rays, qq, kwalk, wk, bk, vwalk, score_act,
             bkg, normalize, eps)
    e_flops = T * k * walk_flops(kwalk, wk, vwalk)
    record("attend_eval_f32", "papr_tpu_torch/csrc/attend_eval.cu",
           "papr_tpu/ops/stream_attn.py:1856",
           lambda: list(sa.attend_eval_f32(*eargs)),
           lambda: list(sa.attend_eval_plain(*eargs, f32)), F32_FWD_REL,
           ["fused", "attn"],
           nbytes(record_, idx, rayo_f, rays, qq) + walk_bytes(kwalk, vwalk),
           e_flops, attn_tol=F32_ATTN_ABS,
           tf32=lambda: tf32_reading(
               lambda: sa.attend_eval_plain(*eargs, f32)[0],
               sa.attend_eval_plain(*eargs, f32)[0]),
           earlier=f"3xTF32 on WMMA before: {K3_F32_WMMA_MS} ms here, "
                   f"{K3_F32_WMMA_FRAME_MS} ms at an 800x800 frame's rays")
    # Rows 5 and 6, forward and backward.
    kargs = (rec, rayo_f, rays, qq, kwalk, wk, bk)
    kopts = (score_act, bkg, eps)
    attn, raw = record(
        "key_stream_f32_fwd", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:798",
        lambda: list(sa.key_stream_f32_fwd(*kargs, *kopts))[:2],
        lambda: list(sa.key_stream_plain(*kargs, *kopts, f32))[:2],
        F32_FWD_REL, ["attn", "raw"],
        nbytes(rec, rayo_f, rays, qq) + walk_bytes(kwalk),
        T * k * walk_flops(kwalk, wk), attn_tol=F32_ATTN_ABS,
        span="key_fwd", median=(1, F32_FWD_MEDIAN_REL))
    ss = sa.key_stream_f32_fwd(*kargs, *kopts)[2]
    dattn = firm(randn(T, k + 1),
                 sa.rec_relu_margin(rec, rayo_f, rays, kwalk, eps),
                 "key_stream_f32_bwd")
    record("key_stream_f32_bwd", "papr_tpu_torch/csrc/key_stream.cu",
           "papr_tpu/ops/stream_attn.py:835",
           lambda: rec_lanes(sa.key_stream_f32_bwd(*kargs, raw, ss, dattn,
                                                   *kopts)),
           lambda: rec_lanes(sa.key_stream_bwd_plain(
               *kargs, dattn, *kopts, f32, relu_on=raw > 0, raw_saved=raw)),
           F32_BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "dqq", "dW_k", "db_k"]
           + walk_labels(kwalk),
           nbytes(rec, rayo_f, rays, qq, raw, ss, dattn) + walk_bytes(kwalk),
           3 * T * k * walk_flops(kwalk, wk), span="key_bwd_wgmma_f32",
           n_walk=len(walk_labels(kwalk)), median=(5, F32_DQQ_MEDIAN_REL),
           hold_in=True)
    vargs = (rec, rayo_f, rays, attn, vwalk)
    record("value_stream_f32_fwd", "papr_tpu_torch/csrc/value_stream.cu",
           "papr_tpu/ops/stream_attn.py:1601",
           lambda: [sa.value_stream_f32_fwd(*vargs, normalize, eps)],
           lambda: [sa.value_stream_plain(*vargs, normalize, eps, f32)],
           F32_FWD_REL, ["fused"],
           nbytes(rec, rayo_f, rays, attn) + walk_bytes(vwalk),
           T * k * walk_flops(vwalk), span="value_fwd_wgmma_f32",
           median=(0, F32_FWD_MEDIAN_REL))
    if not compare_f32_fwd_with_k3(eargs, rec):
        failed.append("the fp32 stream forwards against the fp32 K3")
    # The two forwards at configs/demo.yml's widths (key 3 x 64, value 3
    # layers to 32 on 16 point features: an 80-wide value encoding, whose
    # last 32-deep chunk reads E columns past it), on the same patch.
    cfg_d = load_config("configs/demo.yml")
    params_d, state_d = build_model(cfg_d, device)
    _, record_d, rec_d, rayo_d, rays_d, _, qq_d, kwalk_d, vwalk_d = \
        stream_patch_inputs(params_d, state_d, cfg_d, rayo, crop(rayd, patch))
    ad = params_d["attn"]
    dkargs = (rec_d, rayo_d, rays_d, qq_d, kwalk_d, ad["w_k"]["w"],
              ad["w_k"]["bias"])
    k_d = int(rec_d.shape[0])
    attn_d = record(
        "key_stream_f32_fwd (demo widths)", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:798",
        lambda: list(sa.key_stream_f32_fwd(*dkargs, *kopts))[:2],
        lambda: list(sa.key_stream_plain(*dkargs, *kopts, f32))[:2],
        F32_FWD_REL, ["attn", "raw"],
        nbytes(rec_d, rayo_d, rays_d, qq_d) + walk_bytes(kwalk_d),
        T * k_d * walk_flops(kwalk_d, ad["w_k"]["w"]), attn_tol=F32_ATTN_ABS,
        median=(1, F32_FWD_MEDIAN_REL), stack_of="key_stream_f32_fwd")[0]
    dvargs = (rec_d, rayo_d, rays_d, attn_d, vwalk_d)
    record("value_stream_f32_fwd (demo widths)",
           "papr_tpu_torch/csrc/value_stream.cu",
           "papr_tpu/ops/stream_attn.py:1601",
           lambda: [sa.value_stream_f32_fwd(*dvargs, normalize, eps)],
           lambda: [sa.value_stream_plain(*dvargs, normalize, eps, f32)],
           F32_FWD_REL, ["fused"],
           nbytes(rec_d, rayo_d, rays_d, attn_d) + walk_bytes(vwalk_d),
           T * k_d * walk_flops(vwalk_d), median=(0, F32_FWD_MEDIAN_REL),
           stack_of="value_stream_f32_fwd")
    del params_d, state_d, record_d, rec_d, dkargs, dvargs, attn_d
    dfused = firm(randn(T, int(vwalk.ws[-1].shape[1])),
                  sa.rec_relu_margin(rec, rayo_f, rays, vwalk, eps),
                  "value_stream_f32_bwd")
    record("value_stream_f32_bwd", "papr_tpu_torch/csrc/value_stream.cu",
           "papr_tpu/ops/stream_attn.py:1634",
           lambda: rec_lanes(sa.value_stream_f32_bwd(*vargs, dfused,
                                                     normalize, eps)),
           lambda: rec_lanes(sa.value_stream_bwd_plain(*vargs, dfused,
                                                       normalize, eps, f32)),
           F32_BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "d_attn"]
           + walk_labels(vwalk),
           nbytes(rec, rayo_f, rays, attn, dfused) + walk_bytes(vwalk),
           3 * T * k * walk_flops(vwalk), span="value_bwd_wgmma_f32",
           n_walk=len(walk_labels(vwalk)), hold_in=True)
    # Row 7 in fp32: the key stream with the query chain folded in (qq is
    # never rounded); backward held on the rays whose key and query relus
    # keep their margin.
    a = params["attn"]
    qargs = (rec, rayo_f, rays, rayd_f.contiguous(), kwalk, wk, bk, qwalk,
             a["w_q"]["w"], a["w_q"]["bias"])
    q_flops = T * (k * walk_flops(kwalk, wk)
                   + walk_flops(qwalk, a["w_q"]["w"]))
    q_bytes = nbytes(rec, rayo_f, rays, rayd_f) + walk_bytes(kwalk, qwalk)
    # On wgmma (the fp32 embedder's walk with w_q as its head, then row 5f's
    # kernels): qq's median row held as row 2f's; the plain backward reads
    # the kernel forward's raw dots, as row 5f's does; the key's outputs bit
    # for bit row 5f's on the fold's own qq and dattn.
    attn_q, raw_q, qq_q = record(
        "key_stream_q_f32_fwd", "papr_tpu_torch/csrc/key_stream_q.cu",
        "papr_tpu/ops/stream_attn.py:1201",
        lambda: (lambda r: [r[0], r[1], r[3]])(sa.key_stream_q_f32_fwd(
            *qargs, *kopts)),
        lambda: (lambda r: [r[0], r[1], r[3]])(sa.key_stream_q_plain(
            *qargs, *kopts, f32)),
        F32_FWD_REL, ["attn", "raw", "qq"], q_bytes, q_flops,
        attn_tol=F32_ATTN_ABS, span=("query_head_fwd", "key_fwd"),
        median=(2, F32_EMBED_MEDIAN_REL))
    ss_q = sa.key_stream_q_f32_fwd(*qargs, *kopts)[2]
    kargs_q = (rec, rayo_f, rays, qq_q, kwalk, wk, bk)
    same = [torch.equal(a_, b_) for a_, b_ in zip(
        (attn_q, raw_q, ss_q), sa.key_stream_f32_fwd(*kargs_q, *kopts))]
    print(f"phase 8 key_stream_q_f32_fwd on its own qq against "
          f"key_stream_f32_fwd: attn, raw, ss bit-equal {same}", flush=True)
    if not all(same):
        failed.append("key_stream_q_f32_fwd vs key_stream_f32_fwd")
    margin_q = torch.minimum(
        sa.rec_relu_margin(rec, rayo_f, rays, kwalk, eps),
        fm.walk_relu_margin(fm.encode_plain(rayd_f, qwalk.cols), qwalk))
    dattn_q = firm(randn(T, k + 1), margin_q, "key_stream_q_f32_bwd")
    record("key_stream_q_f32_bwd", "papr_tpu_torch/csrc/key_stream_q.cu",
           "papr_tpu/ops/stream_attn.py:1243",
           lambda: rec_lanes(sa.key_stream_q_f32_bwd(
               *qargs, qq_q, raw_q, ss_q, dattn_q, *kopts)),
           lambda: rec_lanes(sa.key_stream_q_bwd_plain(
               *qargs, dattn_q, *kopts, f32, relu_on=raw_q > 0,
               raw_saved=raw_q)),
           F32_BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "d_rayd", "dW_k",
                                      "db_k", "dW_q", "db_q"]
           + walk_labels(kwalk) + ["q." + l for l in walk_labels(qwalk)],
           q_bytes + nbytes(qq_q, raw_q, ss_q, dattn_q), 3 * q_flops,
           span=("key_bwd_wgmma_f32", "query_head_bwd"))
    got_q = sa.key_stream_q_f32_bwd(*qargs, qq_q, raw_q, ss_q, dattn_q,
                                    *kopts)
    got_5 = sa.key_stream_f32_bwd(*kargs_q, raw_q, ss_q, dattn_q, *kopts)
    nk = len(walk_labels(kwalk))
    same = [torch.equal(a_, b_) for a_, b_ in zip(
        got_q[:3] + got_q[4:6] + got_q[8:8 + nk], got_5[:3] + got_5[4:])]
    print(f"phase 8 key_stream_q_f32_bwd on its own qq against "
          f"key_stream_f32_bwd: d_rec, d_rayo, d_rays, dW_k, db_k and the key "
          f"walk's {nk} gradients bit-equal {all(same)} "
          f"({sum(same)} of {len(same)})", flush=True)
    if not all(same) or len(same) != 5 + nk:
        failed.append("key_stream_q_f32_bwd vs key_stream_f32_bwd")
    del qargs, kargs_q, attn_q, raw_q, qq_q, ss_q, got_q, got_5

    # Rows 4q-6q beside fp32 compute: the int8 walks with the fp32 epilogue
    # against the plain int8 walks in fp32 (the calibration is the same
    # plain code on both sides). A flipped quantized activation moves a few
    # rays by up to 1/127 of a term; the median ray has no flip and reads
    # fp32 noise, where a bf16 rounding of the epilogue moves every ray.
    qp = tuple(sa.calibrate_walk(rec, rayo_f, rays, w, eps, f32)
               for w in (kwalk, vwalk))
    e8 = eargs + (f32, True, qp)
    i8_flops = T * k * walk_flops(kwalk, vwalk)
    record("attend_eval_i8_f32", "papr_tpu_torch/csrc/attend_eval.cu",
           "papr_tpu/ops/stream_attn.py:1856",
           lambda: list(sa.attend_eval_idx(*e8)),
           lambda: list(sa.attend_eval_plain(*e8)), I8_F32_FUSED_REL,
           ["fused", "attn"],
           nbytes(record_, idx, rayo_f, rays, qq) + walk_bytes(kwalk, vwalk),
           i8_flops + T * k * walk_flops(wk) * INT8_OPS / F32_TC_FLOPS,
           attn_tol="printed", rate=INT8_OPS, median=(0, I8_F32_MEDIAN_REL),
           span="attend_eval_i8_wgmma_kernel",
           earlier=f"int8 walks on WMMA before: {K3_I8F32_WMMA_MS} ms here")
    attn8 = record(
        "key_stream_i8_f32_fwd", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:798",
        lambda: list(sa.key_stream_i8_f32_fwd(*kargs, *kopts))[:2],
        lambda: list(sa.key_stream_plain(*kargs, *kopts, f32,
                                         int8=True))[:2], I8_RAW_REL,
        ["attn", "raw"], nbytes(rec, rayo_f, rays, qq) + walk_bytes(kwalk),
        T * k * (walk_flops(kwalk) + walk_flops(wk) * INT8_OPS / F32_TC_FLOPS),
        attn_tol="printed", rate=INT8_OPS,
        median=(1, I8_F32_MEDIAN_REL))[0]
    record("value_stream_i8_f32_fwd", "papr_tpu_torch/csrc/value_stream.cu",
           "papr_tpu/ops/stream_attn.py:1601",
           lambda: [sa.value_stream_i8_f32_fwd(rec, rayo_f, rays, attn8,
                                               vwalk, normalize, eps)],
           lambda: [sa.value_stream_plain(rec, rayo_f, rays, attn8, vwalk,
                                          normalize, eps, f32, True)],
           I8_F32_FUSED_REL, ["fused"],
           nbytes(rec, rayo_f, rays, attn8) + walk_bytes(vwalk),
           T * k * walk_flops(vwalk), rate=INT8_OPS,
           median=(0, I8_F32_MEDIAN_REL))
    del rec, record_, vargs, kargs, eargs, e8, attn8, qp
    torch.cuda.empty_cache()

    # Rows 8 and 9 in fp32: the streams on raw feature tensors, on the inputs
    # the model's own head builds (xk (K, T, 9), xv (K, T, 70)).
    meta = model_meta(cfg)
    rayd_c = crop(rayd, patch)
    with torch.no_grad():
        xk, kwalk_f, xv, vwalk_f, influ, sel_alive, _ = _stream_inputs(
            params, cfg, meta, idx.reshape(1, patch, patch, k), rayo, rayd_c,
            state["alive"], eps)
    xk, xv = xk.contiguous(), xv.contiguous()
    influ, sel_alive = influ.contiguous(), sel_alive.contiguous()
    fargs = (xk, qq, kwalk_f, wk, bk, influ, sel_alive)
    fopts = (score_act, bkg, f32)
    cols = lambda n: (lambda g: [g[0][..., :n], g[0][..., n:]] + list(g[1:]))
    attn_f, raw_f = record(
        "key_stream_feat_f32_fwd", "papr_tpu_torch/csrc/key_stream_feat.cu",
        "papr_tpu/ops/stream_attn.py:133",
        lambda: list(sf.key_stream_feat_fwd(*fargs, *fopts)),
        lambda: list(sf.key_stream_feat_plain(*fargs, *fopts)), F32_FWD_REL,
        ["attn", "raw"],
        nbytes(xk, qq, influ, sel_alive) + walk_bytes(kwalk_f),
        T * k * walk_flops(kwalk_f, wk), attn_tol=F32_ATTN_ABS,
        span=("key_feat_fwd", "key_fwd_softmax"),
        median=(1, F32_FWD_MEDIAN_REL))
    dattn_f = firm(randn(T, k + 1), tokens_margin(xk, kwalk_f),
                   "key_stream_feat_f32_bwd")
    record("key_stream_feat_f32_bwd", "papr_tpu_torch/csrc/key_stream_feat.cu",
           "papr_tpu/ops/stream_attn.py:159",
           lambda: cols(3)(sf.key_stream_feat_bwd(*fargs, raw_f, dattn_f,
                                                  *fopts)),
           lambda: cols(3)(sf.key_stream_feat_bwd_plain(
               *fargs, dattn_f, *fopts, relu_on=raw_f > 0)),
           F32_BWD_REL, ["dxk[position]", "dxk[proj, perp]", "dqq",
                         "d_influ", "dW_k", "db_k"] + walk_labels(kwalk_f),
           nbytes(xk, qq, influ, sel_alive, raw_f, dattn_f)
           + walk_bytes(kwalk_f), 3 * T * k * walk_flops(kwalk_f, wk))
    record("value_stream_feat_f32_fwd",
           "papr_tpu_torch/csrc/value_stream_feat.cu",
           "papr_tpu/ops/stream_attn.py:406",
           lambda: [sf.value_stream_feat_fwd(xv, attn_f, vwalk_f, normalize,
                                             f32)],
           lambda: [sf.value_stream_feat_plain(xv, attn_f, vwalk_f,
                                               normalize, f32)],
           F32_FWD_REL, ["fused"], nbytes(xv, attn_f) + walk_bytes(vwalk_f),
           T * k * walk_flops(vwalk_f), span="value_feat_fwd",
           median=(0, F32_FWD_MEDIAN_REL))
    if not compare_feat_onehot(xv, vwalk_f):
        failed.append("the fp32 value forward (features) on a one-hot attn")
    dfused_f = firm(randn(T, int(vwalk_f.ws[-1].shape[1])),
                    tokens_margin(xv, vwalk_f), "value_stream_feat_f32_bwd")
    record("value_stream_feat_f32_bwd",
           "papr_tpu_torch/csrc/value_stream_feat.cu",
           "papr_tpu/ops/stream_attn.py:433",
           lambda: cols(6)(sf.value_stream_feat_bwd(xv, attn_f, vwalk_f,
                                                    dfused_f, normalize, f32)),
           lambda: cols(6)(sf.value_stream_feat_bwd_plain(
               xv, attn_f, vwalk_f, dfused_f, normalize, f32)),
           F32_BWD_REL, ["dxv[proj, perp]", "dxv[point features]", "d_attn"]
           + walk_labels(vwalk_f),
           nbytes(xv, attn_f, dfused_f) + walk_bytes(vwalk_f),
           3 * T * k * walk_flops(vwalk_f))
    del xk, xv, fargs, attn_f, raw_f, dattn_f, dfused_f
    torch.cuda.empty_cache()

    # Row 10 in fp32, and rows 2 / 3 on the key and value stacks, on the
    # embeddings the split-kernel path's own head builds under
    # ``fused_attn: true`` (its fused embedder inputs recorded on the way).
    stacks, apply = [], fm.fused_mlp_apply

    def recording(x, walk, cdt):
        stacks.append((x, walk))
        return apply(x, walk, cdt)

    fm.fused_mlp_apply = recording
    try:
        with torch.no_grad():
            ek, eq, _, influ, sel_alive = _split_embeddings(
                params, cfg, meta, idx.reshape(1, patch, patch, k), rayo,
                rayd_c, state["alive"], eps, policy_from_config(cfg), True)
    finally:
        fm.fused_mlp_apply = apply
    sargs = (ek.contiguous(), eq.contiguous(), wk, bk, a["w_q"]["w"],
             a["w_q"]["bias"], influ.float().contiguous(), sel_alive.float())
    sopts = (score_act, bkg, f32)
    Dk, dm = int(ek.shape[-1]), int(wk.shape[0])
    proj_flops = 2.0 * T * (k + 1) * Dk * dm
    attn_s, raw_s = record(
        "fused_scores_f32_fwd", "papr_tpu_torch/csrc/fused_attn.cu",
        "papr_tpu/ops/fused_attn.py:116",
        lambda: list(fa.fused_scores_f32_fwd(*sargs, *sopts[:2],
                                                    with_raw=True)),
        lambda: list(fa.fused_scores_plain(*sargs, *sopts)),
        F32_FWD_REL, ["attn", "raw"], nbytes(*sargs), proj_flops,
        attn_tol=F32_ATTN_ABS,
        tf32=lambda: tf32_reading(
            lambda: fa.fused_scores_plain(*sargs, *sopts)[1],
            fa.fused_scores_plain(*sargs, *sopts)[1]))
    dattn_s = randn(T, k + 1)
    record("fused_scores_f32_bwd", "papr_tpu_torch/csrc/fused_attn.cu",
           "papr_tpu/ops/fused_attn.py:125",
           lambda: fa.fused_scores_f32_bwd(*sargs, dattn_s,
                                                  *sopts[:2]),
           lambda: fa.fused_scores_bwd_plain(
               *sargs, dattn_s, *sopts, relu_on=raw_s > 0),
           F32_BWD_REL, ["d_embedk", "d_embedq", "dW_k", "db_k", "dW_q",
                         "db_q", "d_influ"],
           nbytes(*sargs, dattn_s), 3 * proj_flops)
    del ek, eq, sargs, attn_s, raw_s, dattn_s
    torch.cuda.empty_cache()
    by_name = dict(zip(("key", "query", "value"), stacks))
    for name in ("key", "value"):
        x, walk = by_name[name]
        x = x.detach().contiguous()
        n_geo = 1 + max(c[0] for c in walk.cols if c[2] == 1)
        extras = n_geo < x.shape[1]
        record(
            f"fused_mlp_f32 ({name} stack)",
            "papr_tpu_torch/csrc/fused_mlp.cu",
            "papr_tpu/ops/fused_mlp.py:417",
            lambda: [fm.fused_mlp_f32(x, walk)],
            lambda: [fm.fused_mlp_plain(x, walk, f32)], F32_FWD_REL, ["y"],
            nbytes(x) + walk_bytes(walk), x.shape[0] * walk_flops(walk),
            stack_of="fused_mlp_f32", span="fused_mlp_fwd_wgmma_f32",
            median=(0, F32_FWD_MEDIAN_REL))
        dy = firm(randn(x.shape[0], int(walk.ws[-1].shape[1])),
                  fm.walk_relu_margin(fm.encode_plain(x, walk.cols), walk),
                  f"fused_mlp_bwd_f32 ({name} stack)")
        split = lambda r: ([r[0][:, :n_geo]]
                           + ([r[0][:, n_geo:]] if extras else [])
                           + list(r[1]))
        record(f"fused_mlp_bwd_f32 ({name} stack)",
               "papr_tpu_torch/csrc/fused_mlp_bwd.cu",
               "papr_tpu/ops/fused_mlp.py:424",
               lambda: split(fm.fused_mlp_bwd_f32(x, dy, walk)),
               lambda: split(fm.fused_mlp_bwd_plain(x, dy, walk, f32)),
               F32_BWD_REL, ["dx[geometry]"]
               + (["dx[point features]"] if extras else [])
               + walk_labels(walk),
               nbytes(x, dy) + walk_bytes(walk),
               3 * x.shape[0] * walk_flops(walk),
               stack_of="fused_mlp_bwd_f32", span="fused_mlp_bwd_wgmma_f32",
               hold_in=True)
        del x, dy
        torch.cuda.empty_cache()
    del stacks, by_name

    # The dW reduction on the key stack's stash shapes, fp32 operands,
    # against their fp64 product, beside one torch.matmul (fp32).
    N, D = k * T, int(kwalk.ws[1].shape[0])
    hmat, dz = randn(N, D), randn(N, D)
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    record("wgrad_f32", "papr_tpu_torch/csrc/wgrad.cu",
           "papr_tpu/ops/fused_mlp.py:424 (the dW accumulation of every TPU "
           "backward body)",
           lambda: [fm.wgrad_f32(lib, hmat.data_ptr(), dz.data_ptr(), N, D, D,
                                 device, stream)],
           lambda: [(hmat.double().T @ dz.double()).float()], F32_WGRAD_REL,
           ["dW"], nbytes(hmat, dz), 2.0 * N * D * D,
           library=lambda: torch.matmul(hmat.T, dz),
           tf32=lambda: tf32_reading(lambda: torch.matmul(hmat.T, dz),
                                     (hmat.double().T @ dz.double()).float()))
    run = lambda: fm.wgrad_f32(lib, hmat.data_ptr(), dz.data_ptr(), N, D, D,
                               device, stream)
    same = bool(torch.equal(run(), run()))
    print(f"phase 8 wgrad_f32: two runs bit-equal {same} (earlier WMMA "
          f"kernel {WGRAD_F32_WMMA_MS} ms on these shapes)", flush=True)
    if not same:
        failed.append("wgrad_f32 (two runs differ)")
    del hmat, dz
    torch.cuda.empty_cache()
    if failed:
        fail(f"fp32 kernels disagree with their plain versions: {failed}")
    return results


def drive_fp32_path(device) -> dict:
    """Phase 8: Caterpillar's model under ``use_amp: false`` and
    ``fused_attn: auto`` on the card. Kernels against their plain versions,
    the first step against the plain fp32 path, timed steps, a dropout step,
    the serving and tiled frames; counters reset just before each timed part
    and read just after."""
    import torch
    from papr_tpu_torch.model.papr import _kernel_mode
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import (build_group_specs, tree_leaves,
                                            tree_map)
    from papr_tpu_torch.train.step import (loss_and_grads, make_opt_state,
                                           make_train_step, render_frames,
                                           render_full_image)

    cfg = caterpillar_cfg()
    policy = policy_from_config(cfg)
    patch = int(cfg.dataset.patches.height)
    k = int(cfg.geoms.points.select_k)
    e = cfg.models.attn.embed
    print(f"phase 8 config: {CATERPILLAR} on configs/default.yml: use_amp "
          f"{cfg.use_amp} (compute {policy.compute_dtype}), fused_attn "
          f"{cfg.get_path('tpu.fused_attn', 'auto')} -> "
          f"{_kernel_mode(cfg, k)}, k {k}, "
          f"{cfg.geoms.points.init_num} {cfg.geoms.points.init_type} points "
          f"in {cfg.max_num_pts} slots, key / query {e.key.n_ff_layer} x "
          f"{e.key.d_ff}, value {e.value.n_ff_layer} layers to "
          f"{e.value.d_ff_out}, k_L {list(e.k_L)} q_L {list(e.q_L)} v_L "
          f"{list(e.v_L)}, background {cfg.geoms.background.constant}, "
          f"{patch}x{patch} patches, losses {dict(cfg.training.losses)}; "
          f"the card's fp32 tensor-core rate used for bounds: 3xTF32 at "
          f"{F32_TC_FLOPS / 1e12:.1f} TFLOP/s", flush=True)
    if cfg.use_amp or policy.compute_dtype != torch.float32 or k != 20 \
            or patch != 180:
        fail("Caterpillar's config is not the one phase 8 drives")
    params, state = build_model(cfg, device)
    c2w, rayo, rayd, target = sphere_view(cfg, device)
    results = compare_f32_kernels(params, state, cfg, device, rayo, rayd,
                                  patch)
    rayd_p, target_p = crop(rayd, patch), crop(target, patch)
    f32k, bf16k, plains = f32_counters()
    specs = build_group_specs(cfg)
    loss_fn = build_loss(cfg, policy, device=device)

    # The first step's loss and gradients against the plain fp32 path on the
    # same weights and selection.
    cat = lambda g: {key: torch.cat([t.float().reshape(-1)
                                     for t in tree_leaves(v)])
                     for key, v in g.items()}
    lk, _, gk = loss_and_grads(params, state, cfg, rayo, rayd_p, target_p, c2w,
                               loss_fn, specs, policy)
    gk = cat(gk)
    lp, _, gp = loss_and_grads(params, state, caterpillar_cfg(fused_attn=False),
                               rayo, rayd_p, target_p, c2w, loss_fn, specs,
                               policy)
    gp = cat(gp)
    ref = (float(lp), gp)
    loss_rel = abs(float(lk) - float(lp)) / max(abs(float(lp)), 1e-30)
    errs = {key: rel_fro(gk[key], gp[key]) for key in gp}
    finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all())
                                              for g in gk.values())
    print(f"phase 8 reference: {patch}x{patch} patch, one step, fp32 kernel "
          f"path vs fp32 plain path: loss {float(lk):.6f} vs {float(lp):.6f} "
          f"(rel {loss_rel:.3e}, need <= {F32_STEP_LOSS_REL}); gradient rel "
          "Frobenius " + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
          + f" (need <= {F32_STEP_GRAD_REL}); finite {finite}", flush=True)
    if not (finite and loss_rel <= F32_STEP_LOSS_REL
            and max(errs.values()) <= F32_STEP_GRAD_REL):
        fail("the fp32 training step disagrees with the plain fp32 path")
    del gk
    torch.cuda.empty_cache()

    # 1 + 10 steps under auto.
    step_fn = make_train_step(cfg, loss_fn)
    opt = make_opt_state(cfg, params)
    before = _snapshot(params, specs)
    params, opt, loss, _ = step_fn(params, opt, state, rayo, rayd_p, target_p,
                                   c2w, 1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters({**f32k, **bf16k}, plains)
    losses = [loss]
    t0 = time.perf_counter()
    for i in range(CAT_STEPS):
        params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd_p,
                                          target_p, c2w, 1001 + i)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / CAT_STEPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {n: fn.launches for n, fn in f32k.items()}
    twins = {n: fn.launches for n, fn in bf16k.items()}
    calls = {n: fn.calls for n, fn in plains.items() if fn.calls}
    moved = {key: any(not torch.equal(a, b) for a, b in
                      zip(before[key], tree_leaves(params[key])))
             for key in before}
    losses = [float(l) for l in losses]
    wall, idle, spans = device_profile(
        lambda: step_fn(params, opt, state, rayo, rayd_p, target_p, c2w, 1500))
    split, kernel_ms = (stage_split(spans, TRAIN_STAGES, 1, TRAIN_OTHER)
                        if spans else ("not measured", float("nan")))
    if spans:
        split += "; largest unstaged: " + largest_unstaged(spans,
                                                           TRAIN_STAGES, 1)
    print(f"phase 8 train {patch}x{patch} patch (T={patch * patch} rays, "
          f"k={k}, fp32): {step_ms:.1f} ms/step over {CAT_STEPS} steps = "
          f"{patch * patch / (step_ms / 1e3):.0f} rays/s; peak device memory "
          f"{peak_gb:.2f} GiB; losses " + ", ".join(f"{l:.6f}" for l in losses)
          + f"; groups moved {moved}", flush=True)
    print(f"phase 8 profile: one step, {wall:.1f} ms under the profiler; "
          f"device idle share {idle:.4f}; kernel time {kernel_ms:.3f} ms: "
          f"{split}", flush=True)
    print(f"phase 8 launches {got}; bf16 twins {twins}; plain-version calls "
          f"{calls}", flush=True)
    step_once = lambda: step_fn(params, opt, state, rayo, rayd_p, target_p,
                                c2w, 1600)
    print("phase 8 profile by issuing op, the gemv kernels: "
          + kernels_by_op(step_once, "gemv"), flush=True)
    print("phase 8 profile by issuing op, every kernel (largest 8): "
          + kernels_by_op(step_once, "", 8), flush=True)
    per_step = {n: 0 if n == "attend_eval_f32" else CAT_STEPS
                for n in got if n != "wgrad_f32"}
    if any(got[n] != v for n, v in per_step.items()) \
            or got["wgrad_f32"] < CAT_STEPS or max(twins.values()) != 0 \
            or calls:
        fail("the fp32 step did not run exactly its fp32 kernels")
    if not (all(np.isfinite(losses)) and all(moved.values())):
        fail(f"fp32 training: losses {losses}, groups moved {moved}")

    # One step with embedder dropout (the plain path, as in the JAX package).
    dcfg = caterpillar_cfg({"models": {"attn": {"embed": {
        n: {"dropout_ff": 0.1} for n in ("key", "query", "value")}}}})
    dstep = make_train_step(dcfg, loss_fn)
    dp = {key: tree_map(torch.clone, v) for key, v in params.items()}
    dp, _, dloss, _ = dstep(dp, make_opt_state(dcfg, dp), state, rayo,
                            crop(rayd, 64), crop(target, 64), c2w, 2000)
    torch.cuda.synchronize()
    print(f"phase 8 dropout step (dropout_ff 0.1 in all three embedders, "
          f"64x64 patch, the plain path): loss {float(dloss):.6f}", flush=True)
    if not np.isfinite(float(dloss)):
        fail("the dropout step failed")
    del dp, dstep
    torch.cuda.empty_cache()

    # One serving frame (one full-frame tile) and one tiled frame.
    reset_counters({**f32k, **bf16k}, plains)
    t0 = time.perf_counter()
    frame = next(render_frames(params, state, cfg, [c2w], FOCAL, FOCAL, H, W,
                               H, W))
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    frame = next(render_frames(params, state, cfg, [c2w], FOCAL, FOCAL, H, W,
                               H, W))
    frame_ms = (time.perf_counter() - t0) * 1e3
    served = {n: fn.launches for n, fn in f32k.items()}
    rayo_np, rayd_np = get_rays_np(H, W, FOCAL, FOCAL, c2w[None])
    t0 = time.perf_counter()
    tiled = render_full_image(params, state, cfg, rayo_np, rayd_np, 100, 100,
                              rgb_only=True, rgb_uint8=True)["rgb"][0]
    tiled_ms = (time.perf_counter() - t0) * 1e3
    frames_l = {n: fn.launches for n, fn in f32k.items()}
    twins = {n: fn.launches for n, fn in bf16k.items()}
    calls = {n: fn.calls for n, fn in plains.items() if fn.calls}
    plain = next(render_frames(params, state, caterpillar_cfg(fused_attn=False),
                               [c2w], FOCAL, FOCAL, H, W, 200, 200))
    diff = np.abs(frame.astype(np.int16) - plain.astype(np.int16))
    close = float((diff.max(-1) <= 1).mean())
    mse = float(np.mean((frame.astype(np.float64) - plain) ** 2)) / 255 ** 2
    psnr = float("inf") if mse == 0 else -10 * np.log10(mse)
    t_diff = np.abs(tiled.astype(np.int16) - frame.astype(np.int16))
    print(f"phase 8 render_frames {H}x{W} (one full-frame tile, fp32): first "
          f"{first_ms:.1f} ms, then {frame_ms:.1f} ms/frame (with the WMMA "
          f"K3: {F32_FRAME_WMMA_MS[0]}); render_full_image 100x100 tiles: "
          f"{tiled_ms:.1f} ms ({F32_FRAME_WMMA_MS[1]}); serving frame vs the "
          f"plain fp32 "
          f"frame: PSNR {psnr:.2f} dB (need >= {F32_FRAME_PSNR}), pixels within "
          f"1/255 {close:.6f} (need >= {F32_FRAME_MIN_CLOSE}), max diff "
          f"{int(diff.max())}; tiled vs serving within 2/255 "
          f"{float((t_diff.max(-1) <= 2).mean()):.6f}; launches: two serving "
          f"frames {served}, then with the tiled frame {frames_l}; bf16 twins "
          f"{twins}; plain-version calls {calls}", flush=True)
    for i, fr in enumerate((frame, tiled)):
        if fr.shape != (H, W, 3) or fr.dtype != np.uint8 \
                or int(fr.max()) == int(fr.min()):
            fail(f"fp32 frame {i}: {fr.shape} {fr.dtype}")
    if served["attend_eval_f32"] != 2 or served["fused_mlp_f32"] != 2 \
            or frames_l["attend_eval_f32"] != 2 + (H // 100) * (W // 100) \
            or max(twins.values()) != 0 or calls:
        fail("the fp32 frames did not run exactly their fp32 kernels")
    if psnr < F32_FRAME_PSNR or close < F32_FRAME_MIN_CLOSE:
        fail("the fp32 serving frame disagrees with the plain fp32 frame")
    # Each fp32 kernel's launches on this path: the timed steps and frames.
    launches = {n: got[n] + frames_l[n] for n in got if n != "cull_select"}
    return {"results": results, "launches": launches, "step_ms": step_ms,
            "frame_ms": frame_ms, "ref": ref}


# The int8 frame beside fp32 against the fp32 frame: int8's own distance on
# Caterpillar's random model, which this only holds against a path broken
# outright. The frame-level calibration samples 1,024 strided rays of the
# whole 800x800 frame, few of them on the sphere: a sound run reads 35.4 dB,
# max abs 38/255.
I8_F32_FRAME_PSNR = 25.0
# Phase 8's other attention modes under fp32: (name, tpu.*, launches of one
# training step, of one frame's tile). A kernel not named launches 0 times
# (wgrad_f32: at least once a step).
F32_MODES = (
    ("stream", {"fused_attn": "stream"},
     {"fused_mlp_f32": 1, "fused_mlp_bwd_f32": 1, "key_stream_feat_f32_fwd": 1,
      "key_stream_feat_f32_bwd": 1, "value_stream_feat_f32_fwd": 1,
      "value_stream_feat_f32_bwd": 1},
     {"fused_mlp_f32": 1, "key_stream_feat_f32_fwd": 1,
      "value_stream_feat_f32_fwd": 1}),
    ("true", {"fused_attn": True},
     {"fused_mlp_f32": 3, "fused_mlp_bwd_f32": 3, "fused_scores_f32_fwd": 1,
      "fused_scores_f32_bwd": 1},
     {"fused_mlp_f32": 3, "fused_scores_f32_fwd": 1}),
    ("score", {"fused_attn": "score"},
     {"fused_scores_f32_fwd": 1, "fused_scores_f32_bwd": 1},
     {"fused_scores_f32_fwd": 1}),
    ("query_fold", {"fused_attn": "streamrec", "query_fold": True},
     {"key_stream_q_f32_fwd": 1, "key_stream_q_f32_bwd": 1,
      "value_stream_f32_fwd": 1, "value_stream_f32_bwd": 1},
     {"key_stream_q_f32_fwd": 1, "value_stream_f32_fwd": 1}),
    ("int8_eval", {"int8_eval": True},
     {"fused_mlp_f32": 1, "fused_mlp_bwd_f32": 1, "key_stream_f32_fwd": 1,
      "key_stream_f32_bwd": 1, "value_stream_f32_fwd": 1,
      "value_stream_f32_bwd": 1},
     {"fused_mlp_f32": 1, "attend_eval_i8_f32": 1}),
    ("int8_train", {"int8_train": True},
     {"fused_mlp_f32": 1, "fused_mlp_bwd_f32": 1, "key_stream_i8_f32_fwd": 1,
      "key_stream_f32_bwd": 1, "value_stream_i8_f32_fwd": 1,
      "value_stream_f32_bwd": 1},
     {"fused_mlp_f32": 1, "attend_eval_f32": 1}),
)
MODE_STEPS = 5


def f32_mode_counters():
    """Every fp32 kernel phase 8's modes run, every bf16 (and bf16 int8)
    kernel, which must not launch there, and every plain version."""
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf
    f32, bf16, plains = f32_counters()
    f32.update({"attend_eval_i8_f32": sa.attend_eval_i8_f32,
                "key_stream_i8_f32_fwd": sa.key_stream_i8_f32_fwd,
                "value_stream_i8_f32_fwd": sa.value_stream_i8_f32_fwd,
                "key_stream_q_f32_fwd": sa.key_stream_q_f32_fwd,
                "key_stream_q_f32_bwd": sa.key_stream_q_f32_bwd,
                "key_stream_feat_f32_fwd": sf.key_stream_feat_f32_fwd,
                "key_stream_feat_f32_bwd": sf.key_stream_feat_f32_bwd,
                "value_stream_feat_f32_fwd": sf.value_stream_feat_f32_fwd,
                "value_stream_feat_f32_bwd": sf.value_stream_feat_f32_bwd,
                "fused_scores_f32_fwd": fa.fused_scores_f32_fwd,
                "fused_scores_f32_bwd": fa.fused_scores_f32_bwd})
    bf16.update({"attend_eval_i8": sa.attend_eval_i8,
                 "key_stream_i8_fwd": sa.key_stream_i8_fwd,
                 "value_stream_i8_fwd": sa.value_stream_i8_fwd,
                 "key_stream_q_fwd": sa.key_stream_q_fwd,
                 "key_stream_q_bwd": sa.key_stream_q_bwd,
                 "key_stream_feat_fwd": sf.key_stream_feat_fwd,
                 "key_stream_feat_bwd": sf.key_stream_feat_bwd,
                 "value_stream_feat_fwd": sf.value_stream_feat_fwd,
                 "value_stream_feat_bwd": sf.value_stream_feat_bwd,
                 "fused_scores_fwd": fa.fused_scores_fwd,
                 "fused_scores_bwd": fa.fused_scores_bwd})
    return f32, bf16, plains


def drive_fp32_modes(device, ref) -> dict:
    """Phase 8, the other attention modes under fp32 on Caterpillar's model
    (fresh from its seeds, as the first step of ``drive_fp32_path`` saw it):
    for each mode one step against the plain fp32 path's (``ref``), 1 +
    MODE_STEPS timed steps (ms/step, rays/s, peak memory, a profiled step's
    idle share), a serving frame and a tiled frame against ``auto``'s, with
    exact launch counts: the mode's fp32 kernels, no bf16 kernel, no plain
    version. Counters are reset just before each part and read just
    after."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
    from papr_tpu_torch.train.step import (loss_and_grads, make_opt_state,
                                           make_train_step, render_frames,
                                           render_full_image)

    cfg = caterpillar_cfg()
    policy = policy_from_config(cfg)
    patch = int(cfg.dataset.patches.height)
    T = patch * patch
    n_tiles = (H // 100) * (W // 100)
    params0, state = build_model(cfg, device)
    c2w, rayo, rayd, target = sphere_view(cfg, device)
    rayd_p, target_p = crop(rayd, patch), crop(target, patch)
    specs = build_group_specs(cfg)
    loss_fn = build_loss(cfg, policy, device=device)
    f32k, bf16k, plains = f32_mode_counters()
    lp, gp = ref
    launches = {n: 0 for n in f32k if n != "cull_select"}
    out = {}

    def read():
        return ({n: fn.launches for n, fn in f32k.items() if fn.launches},
                {n: fn.launches for n, fn in bf16k.items() if fn.launches},
                {n: fn.calls for n, fn in plains.items() if fn.calls})

    def frames(mcfg):
        with torch.no_grad():
            t0 = time.perf_counter()
            fr = next(render_frames(params0, state, mcfg, [c2w], FOCAL, FOCAL,
                                    H, W, H, W))
            first = (time.perf_counter() - t0) * 1e3
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fr = next(render_frames(params0, state, mcfg, [c2w], FOCAL, FOCAL,
                                    H, W, H, W))
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rayo_np, rayd_np = get_rays_np(H, W, FOCAL, FOCAL, c2w[None])
            t0 = time.perf_counter()
            tiled = render_full_image(params0, state, mcfg, rayo_np, rayd_np,
                                      100, 100, rgb_only=True,
                                      rgb_uint8=True)["rgb"][0]
            tiled_ms = (time.perf_counter() - t0) * 1e3
        return fr, tiled, first, ms, tiled_ms, peak

    def distance(a, b):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
        mse = float(np.mean((a.astype(np.float64) - b) ** 2)) / 255 ** 2
        psnr = float("inf") if mse == 0 else -10 * np.log10(mse)
        return psnr, float((d <= 1).mean()), float((d <= 2).mean()), \
            int(d.max())

    # The auto frames every mode's frames are held against.
    auto_frame, auto_tiled = frames(cfg)[:2]
    for name, tpu, per_step, per_tile in F32_MODES:
        mcfg = caterpillar_cfg(**tpu)
        # One step against the plain fp32 path on the same weights.
        reset_counters({**f32k, **bf16k}, plains)
        lk, _, gk = loss_and_grads(params0, state, mcfg, rayo, rayd_p,
                                   target_p, c2w, loss_fn, specs, policy)
        torch.cuda.synchronize()
        once = read()
        gk = {key: torch.cat([t.float().reshape(-1) for t in tree_leaves(v)])
              for key, v in gk.items()}
        loss_rel = abs(float(lk) - lp) / max(abs(lp), 1e-30)
        errs = {key: rel_fro(gk[key], gp[key]) for key in gp}
        finite = bool(torch.isfinite(lk)) and all(
            bool(torch.isfinite(g).all()) for g in gk.values())
        int8_step = name == "int8_train"
        loss_tol = I8_STEP_LOSS_REL if int8_step else F32_STEP_LOSS_REL
        print(f"phase 8 {name} reference: {patch}x{patch} patch, one step, "
              f"fp32 kernel path vs fp32 plain path: loss {float(lk):.6f} vs "
              f"{lp:.6f} (rel {loss_rel:.3e}, need <= {loss_tol}); gradient "
              "rel Frobenius " + ", ".join(f"{key} {v:.3e}"
                                           for key, v in errs.items())
              + (" (int8's own distance, printed)" if int8_step
                 else f" (need <= {F32_STEP_GRAD_REL})")
              + f"; finite {finite}; launches {once[0]}", flush=True)
        if not (finite and loss_rel <= loss_tol and (
                int8_step or max(errs.values()) <= F32_STEP_GRAD_REL)):
            fail(f"the fp32 {name} step disagrees with the plain fp32 path")
        del gk
        # 1 + MODE_STEPS timed steps from the same weights.
        step_fn = make_train_step(mcfg, loss_fn)
        params = build_model(mcfg, device)[0]           # params0, anew
        opt = make_opt_state(mcfg, params)
        params, opt, _, _ = step_fn(params, opt, state, rayo, rayd_p,
                                    target_p, c2w, 1000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters({**f32k, **bf16k}, plains)
        t0 = time.perf_counter()
        for i in range(MODE_STEPS):
            params, opt, loss, _ = step_fn(params, opt, state, rayo, rayd_p,
                                           target_p, c2w, 1001 + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / MODE_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, twins, calls = read()
        for n in launches:
            launches[n] += got.get(n, 0)
        want = {n: v * MODE_STEPS for n, v in per_step.items()}
        want["cull_select"] = MODE_STEPS
        wg = got.pop("wgrad_f32", 0)
        wall, idle, spans = device_profile(
            lambda: step_fn(params, opt, state, rayo, rayd_p, target_p, c2w,
                            1500))
        split, kernel_ms = (stage_split(spans, TRAIN_STAGES, 1, TRAIN_OTHER)
                            if spans else ("not measured", float("nan")))
        print(f"phase 8 {name} train: {step_ms:.1f} ms/step over {MODE_STEPS} "
              f"steps = {T / (step_ms / 1e3):.0f} rays/s; peak device memory "
              f"{peak:.2f} GiB; last loss {float(loss):.6f}; profiled step "
              f"{wall:.1f} ms, device idle share {idle:.4f}, kernel time "
              f"{kernel_ms:.3f} ms: {split}; launches {got}, wgrad_f32 {wg}; "
              f"bf16 kernels {twins}; plain-version calls {calls}", flush=True)
        if got != want or wg < MODE_STEPS or twins or calls \
                or not np.isfinite(float(loss)):
            fail(f"the fp32 {name} steps did not run exactly their fp32 "
                 f"kernels (want {want})")
        del params, opt, step_fn
        torch.cuda.empty_cache()
        # A serving frame (one full-frame tile, twice) and a tiled frame.
        reset_counters({**f32k, **bf16k}, plains)
        fr, tiled, first_ms, frame_ms, tiled_ms, fpeak = frames(mcfg)
        got, twins, calls = read()
        for n in launches:
            launches[n] += got.get(n, 0)
        want = {n: v * (2 + n_tiles) for n, v in per_tile.items()}
        want["cull_select"] = 2 + n_tiles
        psnr, close1, close2, dmax = distance(fr, auto_frame)
        t_psnr, t_close1, _, _ = distance(tiled, auto_tiled)
        int8_frame = name == "int8_eval"
        need = (f"PSNR >= {I8_F32_FRAME_PSNR}: int8's own distance, max "
                "abs printed" if int8_frame else
                f"PSNR >= {F32_FRAME_PSNR}, within 1/255 >= "
                f"{F32_FRAME_MIN_CLOSE}")
        print(f"phase 8 {name} frames {H}x{W}: serving first {first_ms:.1f} "
              f"ms, then {frame_ms:.1f} ms/frame (peak {fpeak:.2f} GiB); "
              f"tiled at 100x100 {tiled_ms:.1f} ms; against auto's fp32 "
              f"frame: PSNR {psnr:.2f} dB, within 1/255 {close1:.6f}, within "
              f"2/255 {close2:.6f}, max abs {dmax} ({need}); tiled against "
              f"auto's tiled: PSNR {t_psnr:.2f} dB, within 1/255 "
              f"{t_close1:.6f}; launches {got}; bf16 kernels {twins}; "
              f"plain-version calls {calls}", flush=True)
        for i, f_ in enumerate((fr, tiled)):
            if f_.shape != (H, W, 3) or f_.dtype != np.uint8 \
                    or int(f_.max()) == int(f_.min()):
                fail(f"fp32 {name} frame {i}: {f_.shape} {f_.dtype}")
        if got != want or twins or calls:
            fail(f"the fp32 {name} frames did not run exactly their fp32 "
                 f"kernels (want {want})")
        ok = (psnr >= I8_F32_FRAME_PSNR if int8_frame else
              psnr >= F32_FRAME_PSNR and close1 >= F32_FRAME_MIN_CLOSE
              and t_psnr >= F32_FRAME_PSNR)
        if not ok:
            fail(f"the fp32 {name} frame disagrees with auto's fp32 frame")
        if name in ("stream", "query_fold"):
            # One more serving frame under the profiler: its device time by
            # kernel, the mode's forwards' kernels named.
            with torch.no_grad():
                _, _, fsp = device_profile(lambda: next(render_frames(
                    params0, state, mcfg, [c2w], FOCAL, FOCAL, H, W, H, W)))
            stages = FEAT_FRAME_STAGES if name == "stream" \
                else FOLD_FRAME_STAGES
            print(f"phase 8 {name} frame profile (one serving frame): "
                  + (stage_split(fsp, stages, 1)[0] if fsp
                     else "not measured"), flush=True)
        if name == "query_fold":
            # The step's and the frame's folded key stream kernels by name:
            # the fp32 query chain and row 5f's kernels, no WMMA keyq_*;
            # each profile that saw the device names the kernels it ran.
            names = sorted({n_.split("(")[0].replace("void ", "")
                            for _, _, n_ in list(spans or []) + list(fsp or [])
                            if any(p_ in n_ for p_ in (
                                "query_head", "key_fwd", "key_bwd",
                                "keyq_"))})
            need = ((["query_head_fwd", "query_head_bwd", "key_fwd_wgmma_f32",
                      "key_bwd_wgmma_f32"] if spans else [])
                    + (["query_head_fwd", "key_fwd_wgmma_f32"] if fsp
                       else []))
            print("phase 8 query_fold kernels (profiled step and frame): "
                  + (", ".join(names) if need else
                     "not measured (no device time in either profile)"),
                  flush=True)
            if any("keyq_" in n_ for n_ in names) or not all(
                    any(w_ in n_ for n_ in names) for w_ in need):
                fail("the fp32 query_fold path did not run the wgmma "
                     "kernels of row 7f")
        out[name] = {"step_ms": step_ms, "frame_ms": frame_ms,
                     "tiled_ms": tiled_ms, "peak_gib": peak, "idle": idle}
        torch.cuda.empty_cache()
    return {"modes": out, "launches": launches}


def drive_demo_cli() -> None:
    """Phase 8: ``configs/demo.yml`` untouched through the command-line
    entry points, in process so the counters can be read: the procedural
    scene as its header says, ``cli.train`` (60 steps with evals, prune and
    grow), then ``cli.test``."""
    import os
    import shutil

    import torch
    from papr_tpu_torch.cli import test as cli_test
    from papr_tpu_torch.cli import train as cli_train
    from papr_tpu_torch.config import load_config

    cfg = load_config("configs/demo.yml")
    r = subprocess.run([sys.executable, "-m", "papr_tpu_torch.dataset.synth",
                        "--out", cfg.dataset.path], capture_output=True,
                       text=True, timeout=300)
    if r.returncode:
        fail(f"the demo scene: {r.stderr[-2000:]}")
    shutil.rmtree(os.path.join(cfg.save_dir, cfg.index), ignore_errors=True)
    f32k, bf16k, plains = f32_counters()
    reset_counters({**f32k, **bf16k}, plains)
    out, err = sys.stdout, sys.stderr
    t0 = time.perf_counter()
    try:
        params, opt, state, hist = cli_train.main(["--opt", "configs/demo.yml"])
        train_s = time.perf_counter() - t0
        results = cli_test.main(["--opt", "configs/demo.yml"])
    finally:
        sys.stdout, sys.stderr = out, err
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0 - train_s
    got = {n: fn.launches for n, fn in f32k.items()}
    twins = {n: fn.launches for n, fn in bf16k.items()}
    calls = {n: fn.calls for n, fn in plains.items() if fn.calls}
    means = next(iter(results.values()))
    print(f"phase 8 configs/demo.yml (use_amp {cfg.use_amp}, fused_attn "
          f"{cfg.get_path('tpu.fused_attn', 'auto')}), untouched: cli.train "
          f"{int(cfg.training.steps)} steps in {train_s:.1f} s, last train "
          f"losses {[round(float(x), 6) for x in hist['train_losses'][-2:]]}, "
          f"eval PSNR {[round(float(x), 3) for x in hist['eval_psnrs']]}; "
          f"cli.test in {test_s:.1f} s: PSNR {means['psnr']:.4f}, SSIM "
          f"{means['ssim']:.4f}; launches {got}; bf16 twins {twins}; "
          f"plain-version calls {calls}", flush=True)
    if not (np.isfinite(means["psnr"]) and all(np.isfinite(
            hist["train_losses"]))):
        fail("configs/demo.yml did not train and test")
    if min(got[n] for n in ("fused_mlp_f32", "fused_mlp_bwd_f32",
                            "key_stream_f32_fwd", "key_stream_f32_bwd",
                            "value_stream_f32_fwd", "value_stream_f32_bwd",
                            "attend_eval_f32", "wgrad_f32")) <= 0 \
            or max(twins.values()) != 0 or calls:
        fail("configs/demo.yml did not run on the fp32 kernels alone")


# ------------------------------------------------------------- phase 9 ----

# The two exposure-control configurations phase 9 drives, untouched apart
# from the cuts it prints: (label, config file).
EXPOSURE_CONFIGS = (("t2_sphere_exposure", "configs/t2_sphere_exposure.yml"),
                    ("Caterpillar_exposure_control",
                     "configs/t2/Caterpillar_exposure_control.yml"))
# The synth t2 scene's image size: the t2 loader resizes every image to the
# Tanks&Temples shape over the factor (640 x 1088 at factor 2), so it is
# written at that size.
EXP_HW = (640, 1088)
EXP_VIEWS = (3, 1)        # its train and test views
EXP_JITTER = 0.4          # per-train-image exposure gain exp(U(-0.4, 0.4))
EXP_STEPS = 3             # finetune steps
EXP_RESAMPLE_ITER = 2     # resamples at steps 0 and 2
EXP_TIMED = 3             # timed steps with and without a code
# Candidate scores (MSE against the image) of the kernel path against the
# plain fp32 path on one sample patch: the small frame's bound under bf16,
# the fp32 step's loss bound under fp32.
EXP_SCORE_REL = {"bf16": REF_REL, "fp32": F32_STEP_LOSS_REL}
# The bf16 first step's mapping MLP gradient against the plain fp32 path:
# it reaches the codes through the FiLM product's gradient, a sum over the
# patch of bf16 products that cancel, then 8 bf16 layers; the bf16 plain
# path reads as much on its own (printed beside it; PERF.md, Findings).
EXP_MAPPING_GRAD_REL = 2e-1
# A configuration's model without exposure control (no mapping MLP, no FiLM).
NO_EXPOSURE = {"exposure_control": {"use": False}, "models": {"renderer": {
    "generator": {"small_unet": {"affine_layer": -1}}}}}


def exposure_cfg(path: str, scene: str, save_dir: str, load_path: str,
                 over=None):
    """``path`` merged onto ``configs/default.yml`` with phase 9's cuts: the
    synth t2 scene for every split, EXP_STEPS steps, a resample every
    EXP_RESAMPLE_ITER steps, one eval at the end, ``save_dir`` and
    ``load_path``; ``over`` on top."""
    from papr_tpu_torch.config import load_config, merge_config
    o = {"save_dir": save_dir, "load_path": load_path,
         "dataset": {"path": scene},
         "exposure_control": {"shading_code_resample_iter": EXP_RESAMPLE_ITER},
         "training": {"steps": EXP_STEPS},
         "eval": {"dataset": {"path": scene}, "step": EXP_STEPS},
         "test": {"datasets": [{"name": "testset", "path": scene}]}}
    if over:
        merge_config(o, over)
    return load_config(path, overrides=o)


def write_cfg(cfg, path: str) -> str:
    """``cfg`` as the YAML file a user passes with --opt."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    return path


def same_pick(plain, kern, tol: float) -> bool:
    """The kernel path picks the plain path's best candidate, or, where
    other plain scores lie within ``tol`` of the best, one of those."""
    plain, kern = np.asarray(plain), np.asarray(kern)
    best = plain.min()
    tied = np.flatnonzero(plain <= best + tol * abs(best))
    return int(np.argmin(kern)) in tied.tolist()


def in_process(fn, label: str, phase: int = 9):
    """Run a CLI's main (which points sys.stdout / sys.stderr at its log
    files) with its output echoed under ``label``; the streams restored."""
    import contextlib
    import io
    out, err = sys.stdout, sys.stderr
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn()
    finally:
        sys.stdout, sys.stderr = out, err
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"phase {phase} {label} | {line}", flush=True)
    return res, text


def drive_exposure_config(device, label: str, path: str, scene: str,
                          root: str, card: str) -> dict:
    """Phase 9 on one configuration: the first step against the plain fp32
    path, the candidate scores and pick against the plain fp32 path, exact
    launches and times of one step (beside the step without a code) and of
    one resample, then ``cli.exposure`` and ``cli.test --exp`` in process
    with the counters reset just before and read just after, and the
    model.pth round trip. -> {"launches": the CLI runs' launches}."""
    import math
    import os

    import torch
    from papr_tpu_torch.cli import exposure as cli_exposure
    from papr_tpu_torch.cli import test as cli_test
    from papr_tpu_torch.dataset import get_dataset
    from papr_tpu_torch.model.papr import create_model, mapping_apply
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train import checkpoint as ck
    from papr_tpu_torch.train.exposure import (_candidate_scores_fn,
                                               render_attention,
                                               resample_shading_codes)
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import tree_map
    from papr_tpu_torch.train.step import (make_opt_state, make_train_step,
                                           render_full_image)

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    save_dir = os.path.join(root, "experiments")
    pre_pth = os.path.join(root, f"{label}_pretrained.pth")
    cfg = exposure_cfg(path, scene, save_dir, pre_pth)
    amp = bool(cfg.use_amp)
    dtype = "bf16" if amp else "fp32"
    policy = policy_from_config(cfg)
    ec = cfg.exposure_control
    su = cfg.models.renderer.generator.small_unet
    e = cfg.models.attn.embed
    seed = int(cfg.seed)
    print(f"phase 9 config: {path} on configs/default.yml: use_amp {amp} "
          f"({dtype}), {cfg.geoms.points.init_num} {cfg.geoms.points.init_type}"
          f" points in {cfg.max_num_pts} slots, k {cfg.geoms.points.select_k}, "
          f"key / query {e.key.n_ff_layer} x {e.key.d_ff}, value "
          f"{e.value.n_ff_layer} layers to {e.value.d_ff_out}, k_L "
          f"{list(e.k_L)} q_L {list(e.q_L)} v_L {list(e.v_L)}, "
          f"{cfg.dataset.patches.height}x{cfg.dataset.patches.width} patches, "
          f"affine_layer {su.affine_layer} (FiLM "
          f"{'live' if int(su.affine_layer) >= 0 else 'off'}), shading codes "
          f"{ec.shading_code_dim} wide, {ec.shading_code_num_samples} "
          f"candidates by {ec.shading_code_resample_select_by} at "
          f"{ec.shading_code_resample_size}x{ec.shading_code_resample_size}, "
          f"mapping MLP {ec.mapping_mlp.num_layers} x {ec.mapping_mlp.dim} -> "
          f"{ec.mapping_mlp.out_dim}, losses {dict(cfg.training.losses)}; cuts: "
          f"the synth t2 sphere ({EXP_VIEWS[0]} train + {EXP_VIEWS[1]} test "
          f"views at {EXP_HW[0]}x{EXP_HW[1]}, factor {cfg.dataset.factor}, "
          f"exposure jitter {EXP_JITTER}) for the dataset, eval and test "
          f"paths; steps {EXP_STEPS}; shading_code_resample_iter "
          f"{EXP_RESAMPLE_ITER}; eval.step {EXP_STEPS}; load_path a model.pth "
          f"the port wrote of a seeded model; widths untouched", flush=True)

    f32k, bf16k, plains = f32_counters()
    if amp:
        kernels = {"cull_select": f32k["cull_select"], **bf16k}
        twins = {n: fn for n, fn in f32k.items() if n != "cull_select"}
    else:
        kernels, twins = f32k, bf16k
    eval_k = next(n for n in kernels if n.startswith("attend"))
    embed_k = "fused_mlp" if amp else "fused_mlp_f32"

    def read(fns):
        return {n: fn.launches for n, fn in fns.items()}

    def plain_calls():
        return {n: fn.calls for n, fn in plains.items() if fn.calls}

    # The "pretrained" model.pth: phase 8's seeded Caterpillar model for
    # Caterpillar's config, the seeded model of t2_sphere_exposure.yml
    # without exposure control for the other: no mapping MLP in either.
    if label.startswith("Caterpillar"):
        pre_cfg = caterpillar_cfg()
    else:
        pre_cfg = exposure_cfg(path, scene, save_dir, "", NO_EXPOSURE)
    pp, ps = build_model(pre_cfg, device)
    ck.export_torch(pre_pth, pp, ps, pre_cfg, step=0)
    del pp, ps

    # The first step against the plain fp32 path, 32x32, one shading code.
    dim = int(ec.shading_code_dim)
    code = (np.random.default_rng(7).standard_normal(dim).astype(np.float32)
            * float(ec.shading_code_scale))
    c2w_v, rayo_v, rayd_v, target_v = sphere_view(cfg, device)
    make = lambda amp=amp, **tpu: exposure_cfg(
        path, scene, save_dir, pre_pth, {"use_amp": amp, "tpu": tpu})
    train_reference_check(
        device, (("auto", {}),), phase=9, make_cfg=make,
        view=(rayo_v, crop(rayd_v, 32), crop(target_v, 32), c2w_v), code=code,
        bounds=((TRAIN_REF_LOSS_REL, TRAIN_REF_GRAD_REL) if amp
                else (F32_STEP_LOSS_REL, F32_STEP_GRAD_REL)), dtype=dtype,
        group_bounds={"mapping_mlp": EXP_MAPPING_GRAD_REL} if amp else None,
        compute_plain=amp)
    del rayd_v, target_v
    torch.cuda.empty_cache()

    # The model as the finetune starts it: the pretrained file through
    # import_torch, the mapping MLP fresh.
    params, state = create_model(cfg, seed=seed, device=device)
    params, state, _ = cli_exposure.load_pretrained(cfg, params, state)
    sample_ds = get_dataset(cli_exposure.sample_config(cfg).dataset,
                            mode="train", seed=seed)
    _, _, img, rayd_s, rayo_s = sample_ds[0]
    img, rayd_s, rayo_s = img[None], rayd_s[None], rayo_s[None]
    n_cand = int(ec.shading_code_num_samples)
    cands = (np.random.default_rng(8).standard_normal((n_cand, dim))
             .astype(np.float32) * float(ec.shading_code_scale))

    # Candidate scores: the kernel path against the plain fp32 path on the
    # same sample patch and candidates.
    plain_cfg = exposure_cfg(path, scene, save_dir, pre_pth,
                             {"use_amp": False, "tpu": {"fused_attn": False}})
    score_k = _candidate_scores_fn(cfg)
    sk = score_k(params, *render_attention(params, state, cfg, rayo_s, rayd_s),
                 img, cands)
    sp = _candidate_scores_fn(plain_cfg)(
        params, *render_attention(params, state, plain_cfg, rayo_s, rayd_s),
        img, cands)
    tol = EXP_SCORE_REL[dtype]
    rel = np.abs(sk - sp) / np.maximum(np.abs(sp), 1e-30)
    pick_ok = same_pick(sp, sk, tol)
    print(f"phase 9 candidate scores ({label}, {n_cand} candidates, "
          f"{img.shape[1]}x{img.shape[2]} sample patch, by "
          f"{ec.shading_code_resample_select_by}): {dtype} kernel path "
          f"[{', '.join(f'{v:.7f}' for v in sk)}] vs fp32 plain path "
          f"[{', '.join(f'{v:.7f}' for v in sp)}]: max rel {rel.max():.3e} "
          f"(need <= {tol}); picks {int(np.argmin(sk))} vs "
          f"{int(np.argmin(sp))} (the plain scores within {tol} of its best: "
          f"{np.flatnonzero(sp <= sp.min() + tol * abs(sp.min())).tolist()})",
          flush=True)
    if not (np.isfinite(sk).all() and rel.max() <= tol and pick_ok):
        fail(f"{label}: the candidate scores disagree with the plain path")

    # One resample of one image: exact launches, render and decode timed.
    th, tw = int(cfg.eval.max_height), int(cfg.eval.max_width)
    size = int(ec.shading_code_resample_size)
    tiles = math.ceil(size / th) * math.ceil(size / tw)
    codes = np.zeros((len(sample_ds), dim), np.float32)
    rng = np.random.default_rng(9)
    resample_shading_codes(codes, cfg, params, state, sample_ds, 0, 0, rng,
                           score_k)
    torch.cuda.synchronize()
    reset_counters({**kernels, **twins}, plains)
    resample_shading_codes(codes, cfg, params, state, sample_ds, 1, 0, rng,
                           score_k)
    torch.cuda.synchronize()
    got, tw_l, calls = read(kernels), read(twins), plain_calls()
    want = {n: (tiles if n in ("cull_select", embed_k, eval_k) else 0)
            for n in kernels}
    render_ms, decode_ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        fused, bkg = render_attention(params, state, cfg, rayo_s, rayd_s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        score_k(params, fused, bkg, img, cands)
        torch.cuda.synchronize()
        render_ms.append((t1 - t0) * 1e3)
        decode_ms.append((time.perf_counter() - t1) * 1e3)
    decode = lambda: score_k(params, fused, bkg, img, cands)
    by_name = {}
    for t0, t1, name in device_profile(decode)[2]:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + t1 - t0, n + 1)
    by_op = (kernels_by_op(decode, "", 3) + "; by kernel name: " + "; ".join(
        f"{name[:70]} x {n}: {t / 1e3:.3f} ms" for name, (t, n) in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:3]))
    print(f"phase 9 resample ({label}, one image, {size}x{size} at {th}x{tw} "
          f"tiles = {tiles} tiles, {n_cand} candidates): render "
          f"{render_ms[-1]:.2f} ms (first {render_ms[0]:.2f}), batched decode "
          f"{decode_ms[-1]:.2f} ms (first {decode_ms[0]:.2f}); launches {got} "
          f"(want {want}); twins {tw_l}; plain-version calls {calls}; the "
          f"decode by issuing op: {by_op}", flush=True)
    if got != want or max(tw_l.values()) != 0 or calls:
        fail(f"{label}: one resample did not run exactly its kernels")
    del fused, bkg

    # One finetune step with a code: exact launches; then ms/step with a
    # code beside the same model's step with exposure control off.
    ds = get_dataset(cfg.dataset, mode="train", seed=seed)
    _, _, timg, trayd, trayo = ds[0]
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None],
                                    device=device)
    timg, trayd, trayo, tc2w = dev(timg), dev(trayd), dev(trayo), \
        ds.get_c2w(0)
    loss_fn = build_loss(cfg, policy, device=device)
    code_t = torch.as_tensor(code, device=device)
    runs = {}
    for name, run_cfg, p0, c in (
            ("with a code", cfg, params, code_t),
            ("without", exposure_cfg(path, scene, save_dir, pre_pth,
                                     NO_EXPOSURE),
             {k: v for k, v in params.items() if k != "mapping_mlp"}, None)):
        p = {k: tree_map(torch.clone, v) for k, v in p0.items()}
        step_fn = make_train_step(run_cfg, loss_fn)
        opt = make_opt_state(run_cfg, p)
        p, opt, loss, _ = step_fn(p, opt, state, trayo, trayd, timg, tc2w,
                                  1000, shading_code=c)
        torch.cuda.synchronize()
        reset_counters({**kernels, **twins}, plains)
        p, opt, loss, _ = step_fn(p, opt, state, trayo, trayd, timg, tc2w,
                                  1001, shading_code=c)
        torch.cuda.synchronize()
        one = (read(kernels), read(twins), plain_calls())
        t0 = time.perf_counter()
        for i in range(EXP_TIMED):
            p, opt, loss, _ = step_fn(p, opt, state, trayo, trayd, timg,
                                      tc2w, 1002 + i, shading_code=c)
        torch.cuda.synchronize()
        runs[name] = ((time.perf_counter() - t0) / EXP_TIMED * 1e3,
                      float(loss), one)
        del p, opt
    got, tw_l, calls = runs["with a code"][2]
    want = {n: (0 if n == eval_k else 1) for n in kernels
            if not n.startswith("wgrad")}
    print(f"phase 9 finetune step ({label}, {timg.shape[1]}x{timg.shape[2]} "
          f"patch, {dtype}): with a code {runs['with a code'][0]:.1f} ms/step, "
          f"without (exposure control off: no mapping MLP, no FiLM; the same "
          f"weights otherwise) "
          f"{runs['without'][0]:.1f} ms/step over {EXP_TIMED} steps; losses "
          f"{runs['with a code'][1]:.6f} / {runs['without'][1]:.6f}; launches "
          f"of one step {got} (want {want}, wgrad >= 1); twins {tw_l}; "
          f"plain-version calls {calls}; {card}", flush=True)
    wg = "wgrad" if amp else "wgrad_f32"
    if any(got[n] != v for n, v in want.items()) or got[wg] < 1 \
            or max(tw_l.values()) != 0 or calls \
            or not np.isfinite(runs["with a code"][1]):
        fail(f"{label}: one finetune step did not run exactly its kernels")
    del params, state
    torch.cuda.empty_cache()

    # The command-line path: cli.exposure, then the finetuned model.pth
    # round trip, then cli.test --exp.
    opt_path = write_cfg(cfg, os.path.join(root, f"{label}.yml"))
    reset_counters({**kernels, **twins}, plains)
    t0 = time.perf_counter()
    (fp, fo, fs, fcodes, hist), text = in_process(
        lambda: cli_exposure.main(["--opt", opt_path]), "cli.exposure")
    torch.cuda.synchronize()
    finetune_s = time.perf_counter() - t0
    n_res = text.count("Resampling shading codes")
    if "Training finished!" not in text or n_res != math.ceil(
            EXP_STEPS / EXP_RESAMPLE_ITER) or not all(
            np.isfinite(hist["train_losses"] + hist["eval_losses"])):
        fail(f"{label}: cli.exposure did not finetune")
    print(f"phase 9 cli.exposure ({label}): {EXP_STEPS} steps, {n_res} "
          f"resamples of {len(sample_ds)} codes, one eval, in {finetune_s:.1f} "
          f"s; eval PSNR {[round(float(x), 3) for x in hist['eval_psnrs']]}",
          flush=True)
    del fp, fo, fs
    cli_launches = read(kernels)

    # model.pth round trip on the card: the finetuned checkpoint's test frame
    # at the test tiles, exported and imported, bit for bit; the codes too.
    log_dir = os.path.join(save_dir, cfg.index)
    step_f, tree = ck.load_checkpoint(log_dir)
    p0, s0 = create_model(cfg, seed=seed, device=device)
    params = ck.restore_into(p0, tree["params"])
    state = ck.restore_into(s0, tree["state"])
    test_ds = get_dataset(cfg.dataset, mode="test", seed=seed)
    timg_np, trayd_np, trayo_np = test_ds.get_full_img(0)
    eval_code = tree["extras"]["eval_shading_codes"][0]
    tth, ttw = int(cfg.test.max_height), int(cfg.test.max_width)

    def frame(p, s):
        g, b = mapping_apply(p, cfg, eval_code)
        t0 = time.perf_counter()
        rgb = render_full_image(p, s, cfg, trayo_np, trayd_np, tth, ttw,
                                gamma=g, beta=b)["rgb"]
        return rgb, (time.perf_counter() - t0) * 1e3

    before, _ = frame(params, state)
    pth = os.path.join(root, f"{label}_finetuned.pth")
    ck.export_torch(pth, params, state, cfg, step=step_f, extras=tree["extras"])
    p1, s1 = create_model(cfg, seed=seed + 1, device=device)
    step_i, p1, s1, extras = ck.import_torch(pth, p1, s1, cfg)
    after, _ = frame(p1, s1)
    after, frame_ms = frame(p1, s1)
    codes_equal = all(np.array_equal(extras[k].cpu().numpy(), tree["extras"][k])
                      for k in tree["extras"])
    print(f"phase 9 model.pth round trip ({label}): step {step_i}, a "
          f"{timg_np.shape[1]}x{timg_np.shape[2]} test frame at {tth}x{ttw} "
          f"tiles bit-equal {np.array_equal(before, after)} (max diff "
          f"{float(np.abs(before - after).max()):.3e}), codes bit-equal "
          f"{codes_equal}; one --exp frame {frame_ms:.1f} ms; {card}",
          flush=True)
    if not (np.array_equal(before, after) and codes_equal
            and step_i == step_f and np.isfinite(after).all()):
        fail(f"{label}: the model.pth round trip changed the model")
    del params, state, p0, s0, p1, s1, tree
    torch.cuda.empty_cache()

    # cli.test --exp: the finetuned checkpoint (t2_sphere: all three modes),
    # or the exported model.pth as the config's test.load_path (Caterpillar).
    if label.startswith("Caterpillar"):
        opt_path = write_cfg(exposure_cfg(path, scene, save_dir, pre_pth,
                                          {"test": {"load_path": pth}}),
                             os.path.join(root, f"{label}_test.yml"))
        modes = (("--exp", ["--exp"], "exposure_control_test", 1),)
    else:
        modes = (("--exp", ["--exp"], "exposure_control_test", 1),
                 ("--exp --random", ["--exp", "--random", "--num_samples",
                                     "2"], "exposure_control_random_scale1.0",
                  2),
                 ("--exp --intrp", ["--exp", "--intrp", "--num_samples", "2",
                                    "--num_intrp", "2"],
                  "exposure_control_intrp_scale1.0", 2))
    for name, flags, out_dir, frames in modes:
        t0 = time.perf_counter()
        res, text = in_process(
            lambda: cli_test.main(["--opt", opt_path] + flags),
            f"cli.test {name}")
        torch.cuda.synchronize()
        means = next(iter(res.values()))
        written = os.listdir(os.path.join(log_dir, "test", out_dir))
        n_png = sum(f.endswith("-predrgb.png") for f in written)
        print(f"phase 9 cli.test {name} ({label}): {frames} frame(s) in "
              f"{time.perf_counter() - t0:.1f} s, PSNR {means['psnr']:.4f}, "
              f"{n_png} predrgb PNGs in test/{out_dir}", flush=True)
        if "Avg test loss" not in text or not np.isfinite(means["psnr"]) \
                or text.count("Test frame:") != frames or n_png != frames:
            fail(f"{label}: cli.test {name} did not render")
    torch.cuda.synchronize()
    launches = read(kernels)
    tw_l, calls = read(twins), plain_calls()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 9 launches of the command-line runs ({label}): finetune "
          f"{cli_launches}, with the tests {launches}; twins {tw_l}; "
          f"plain-version calls {calls}; peak device memory {peak_gb:.2f} GiB;"
          f" {time.perf_counter() - t_phase:.1f} s for this configuration; "
          f"{card}", flush=True)
    if min(launches.values()) <= 0 or max(tw_l.values()) != 0 or calls:
        fail(f"{label}: the command-line path did not run exactly its kernels")
    return {"launches": launches}


def drive_exposure_path(device, card: str) -> dict:
    """Phase 9: exposure control and the reference checkpoint format on
    ``configs/t2_sphere_exposure.yml`` (bf16, FiLM live) and
    ``configs/t2/Caterpillar_exposure_control.yml`` (fp32, FiLM off as the
    reference ships it), on a synth t2 sphere written with per-image
    exposure gains. -> {"launches": each kernel's launches in the
    command-line runs of both}."""
    import os
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="papr_chip_smoke_exp_")
    scene = os.path.join(root, "t2_sphere")
    r = subprocess.run([sys.executable, "-m", "papr_tpu_torch.dataset.synth",
                        "--format", "t2", "--exposure_jitter",
                        str(EXP_JITTER), "--height", str(EXP_HW[0]),
                        "--width", str(EXP_HW[1]), "--n_train",
                        str(EXP_VIEWS[0]), "--n_test", str(EXP_VIEWS[1]),
                        "--out", scene], capture_output=True, text=True,
                       timeout=300)
    if r.returncode:
        fail(f"the exposure scene: {r.stderr[-2000:]}")
    launches = {}
    for label, path in EXPOSURE_CONFIGS:
        got = drive_exposure_config(device, label, path, scene, root, card)
        for n, v in got["launches"].items():
            launches[n] = launches.get(n, 0) + v
    print(f"phase 9 exposure path: both configurations in "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return {"launches": launches}


# ------------------------------------------------------------ phase 10 ----

# Phase 10: the (data, rays) mesh on the card. Two ranks share cuda:0 and so
# talk over gloo (NCCL refuses two ranks on one device); they meet through a
# file:// rendezvous and run ``python3 chip_smoke.py --mesh-rank``.
MESH_STEPS = 5            # timed steps after one warm-up, on two ranks
MESH_RANK_TIMEOUT = 420   # s, each rank (the library is built: no nvcc)
MESH_CLI_TIMEOUT = 420    # s, each torchrun launch
MESH_HW = 320             # the command-line sphere's views
MESH_CLI_STEPS = 12       # evals at 5 and 10, prune + grow at 10
# One step on the flagship patch, two ranks (data = 1, rays = 2) against one
# rank on the card. One rank repeats its step bit for bit (the second
# one-rank run is printed beside). Two ranks order some fp32 sums otherwise:
# the stream kernels' persistent grids split a ray's K units between blocks
# at other places for half the rays, the points' gradients and every dW sum
# half the tokens before the ranks add them; the bf16 roundings of the UNet
# and LPIPS that such a difference flips carry it into every gradient.
# Sound (NVIDIA H100 80GB HBM3, 700 W; the same on two machines): loss
# 1.18e-6; gradients points 6.3e-3, pc_feats 2.1e-3, influence 1.2e-3,
# attn and renderer 5.7e-4 (fp32, (b): <= 3.2e-5). A UNet gradient counted
# on both ranks reads 1, the ray blocks' attention gradients averaged
# instead of summed 0.5 (PERF.md, Findings).
MESH_LOSS_REL = 1e-5
MESH_GRAD_REL = 2e-2
# Each rank's launches in Caterpillar's fp32 step on its image.
MESH_F32_STEP_LAUNCHES = {"cull_select": 1, "fused_mlp_f32": 1,
                          "fused_mlp_bwd_f32": 1, "attend_eval_f32": 0,
                          "key_stream_f32_fwd": 1, "key_stream_f32_bwd": 1,
                          "value_stream_f32_fwd": 1,
                          "value_stream_f32_bwd": 1, "wgrad_f32": 19}
# Each rank's launches in one training step on its block: phase 4's.
MESH_STEP_LAUNCHES = {"cull_select": 1, "fused_mlp": 1, "fused_mlp_bwd": 1,
                      "key_stream_fwd": 1, "key_stream_bwd": 1,
                      "value_stream_fwd": 1, "value_stream_bwd": 1,
                      "wgrad": 19}
MESH_CAT_VIEWS = (0.6, 1.4)   # the fp32 batch: two views of the sphere


def mesh_flagship(device, **tpu):
    """Phase 10 a / c: phase 4's seeded flagship model, 160x160 patch and
    random target, made alike in every process."""
    import torch
    cfg = flagship_cfg(**tpu)
    params, state = build_model(cfg, device)
    rayo, rayd = training_patch(device)
    gen = torch.Generator(device=device).manual_seed(4)
    target = torch.rand(1, PATCH, PATCH, 3, generator=gen, device=device)
    return cfg, params, state, rayo, rayd, target, orbit(0.0)


def mesh_caterpillar(device, **tpu):
    """Phase 10 b: Caterpillar's seeded model (phase 8's) and a batch of two
    180x180 crops of the synth sphere seen from two cameras."""
    import torch
    cfg = caterpillar_cfg({"dataset": {"batch_size": 2}}, **tpu)
    params, state = build_model(cfg, device)
    side = int(cfg.dataset.patches.height)
    views = [sphere_view(cfg, device, th) for th in MESH_CAT_VIEWS]
    rayo = torch.cat([v[1] for v in views])
    rayd = torch.cat([crop(v[2], side) for v in views])
    target = torch.cat([crop(v[3], side) for v in views])
    c2w = np.stack([v[0] for v in views]).astype(np.float32)
    return cfg, params, state, rayo, rayd, target, c2w


def mesh_step_grads(cfg, params, state, rayo, rayd, target, c2w, device,
                    plan=None):
    """One step's loss and each group's gradient (flat, on the host), on one
    rank or on this rank's block of ``plan``."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
    from papr_tpu_torch.train.step import loss_and_grads
    policy = policy_from_config(cfg)
    if plan is not None:
        rayo, rayd = plan.batch_block(rayo), plan.ray_block(rayd)
        target, c2w = plan.batch_block(target), plan.batch_block(c2w)
    loss, _, grads = loss_and_grads(
        params, state, cfg, rayo, rayd, target, c2w,
        build_loss(cfg, policy, device=device), build_group_specs(cfg),
        policy, mesh=plan.mesh if plan is not None else None)
    return float(loss), {k: torch.cat([g.float().reshape(-1)
                                       for g in tree_leaves(v)]).cpu()
                         for k, v in grads.items()}


def mesh_frames(params, state, cfg):
    """Phase 10 c: one 800x800 serving frame (one tile) and one frame at the
    config's 100x100 test tiles (64 tiles), both uint8, with each one's
    launches on this process."""
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_frame, render_full_image
    kernels, plains = counters()
    reset_counters(kernels, plains)
    serving = render_frame(params, state, cfg, orbit(0.3), FOCAL, FOCAL, H, W)
    one = ({n: fn.launches for n, fn in kernels.items()},
           {n: fn.calls for n, fn in plains.items() if fn.calls})
    reset_counters(kernels, plains)
    rayo, rayd = get_rays_np(H, W, FOCAL, FOCAL, orbit(0.3)[None])
    tiled = render_full_image(params, state, cfg, rayo, rayd,
                              int(cfg.test.max_height),
                              int(cfg.test.max_width), rgb_only=True,
                              rgb_uint8=True)["rgb"][0]
    tiles = ({n: fn.launches for n, fn in kernels.items()},
             {n: fn.calls for n, fn in plains.items() if fn.calls})
    return serving, tiled, one, tiles


def params_digest(params) -> str:
    import hashlib
    from papr_tpu_torch.train.optim import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gloo_cuda_probe(device) -> dict:
    """Which collectives gloo runs on CUDA tensors in this build: each call
    on a two-element tensor, 'ok' or the error's first words."""
    import torch
    import torch.distributed as dist
    x = torch.ones(2, device=device)
    world = dist.get_world_size()
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(2 * world, device=device), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=device), torch.ones(2 * world,
                                                      device=device)),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
    return out


def mesh_rank(tmp: str, rank: str, world: str) -> None:
    """One rank of phase 10 a-c (``python3 chip_smoke.py --mesh-rank <tmp>
    <rank> <world>``): joins the gloo group through ``<tmp>/pg``, writes its
    readings to ``<tmp>/rank<rank>.pt``."""
    import os

    import torch
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.parallel import mesh as pmesh
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.step import make_opt_state, make_train_step

    pmesh.init_ranks(f"file://{tmp}/pg", int(rank), int(world))
    device = torch.device("cuda", torch.cuda.current_device())
    build.load()
    out = {"gloo_cuda": gloo_cuda_probe(device)}

    # a / c: the flagship model on (data = 1, rays = 2).
    cfg, params, state, rayo, rayd, target, c2w = mesh_flagship(
        device, mesh={"data": 1, "rays": 2})
    plan = pmesh.make_plan(pmesh.mesh_from_config(cfg))
    out["frames"] = mesh_frames(params, state, cfg)
    out["a"] = mesh_step_grads(cfg, params, state, rayo, rayd, target, c2w,
                               device, plan)
    step_fn = make_train_step(cfg, build_loss(cfg, policy_from_config(cfg),
                                              device=device), sharding=plan)
    opt = make_opt_state(cfg, params)
    block = (plan.batch_block(rayo), plan.ray_block(rayd),
             plan.batch_block(target), c2w)
    params, opt, loss, _ = step_fn(params, opt, state, *block, 1000)
    kernels, plains = counters(training=True)
    torch.cuda.synchronize()
    reset_counters(kernels, plains)
    t0 = time.perf_counter()
    losses = []
    for i in range(MESH_STEPS):
        params, opt, loss, pred = step_fn(params, opt, state, *block,
                                          1001 + i)
        losses.append(loss)
    torch.cuda.synchronize()
    out["timed"] = {
        "ms": (time.perf_counter() - t0) / MESH_STEPS * 1e3,
        "losses": [float(x) for x in losses],
        "pred": tuple(pred.shape),
        "launches": {n: fn.launches for n, fn in kernels.items()},
        "plain": {n: fn.calls for n, fn in plains.items() if fn.calls},
        "digest": params_digest(params)}
    del params, opt, state, pred
    torch.cuda.empty_cache()

    # b: Caterpillar's fp32 model on (data = 2, rays = 1), a batch of two.
    cat = mesh_caterpillar(device, mesh={"data": 2, "rays": 1})
    f32k, bf16k, plains = f32_counters()
    reset_counters({**f32k, **bf16k}, plains)
    out["b"] = mesh_step_grads(*cat, device, pmesh.make_plan(
        pmesh.mesh_from_config(cat[0])))
    out["b_launches"] = {n: fn.launches for n, fn in f32k.items()}
    out["b_others"] = {n: fn.launches for n, fn in bf16k.items()
                       if fn.launches}
    out["b_others"].update({n: fn.calls for n, fn in plains.items()
                            if fn.calls})
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt.tmp"))
    os.replace(os.path.join(tmp, f"rank{rank}.pt.tmp"),
               os.path.join(tmp, f"rank{rank}.pt"))


def wait_ranks(procs, logs, limit: float, label: str) -> None:
    """Wait for every process; one that fails or outlives ``limit`` seconds
    fails the phase (the others are killed)."""
    deadline = time.monotonic() + limit
    while True:
        rcs = [p.poll() for p in procs]
        bad = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
        late = time.monotonic() > deadline
        if bad or late or all(rc == 0 for rc in rcs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if bad or late:
        i = bad[0] if bad else 0
        with open(logs[i]) as f:
            tail = f.read()[-3000:]
        fail(f"{label} {i} {'exited ' + str(rcs[i]) if bad else 'timed out'}"
             f":\n{tail}")


def mesh_check_step(label, want, got, loss_bound, grad_bound,
                    again=None) -> None:
    """Two ranks' loss and gradients (each rank's, after the reduction)
    against one rank's; the ranks' gradients bit-equal. ``again``: a second
    one-rank run, whose distance from the first (one rank's own spread) is
    printed beside."""
    import torch
    (lw, gw), (l0, g0), (l1, g1) = want, got[0], got[1]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss_rel = max(rel(l0, lw), rel(l1, lw))
    errs = {k: rel_fro(g0[k], gw[k]) for k in gw}
    same = l0 == l1 and all(torch.equal(g0[k], g1[k]) for k in g0)
    finite = np.isfinite(l0) and all(bool(torch.isfinite(g).all())
                                     for g in g0.values())
    spread = ""
    if again is not None:
        spread = (f"; one rank against itself: loss rel "
                  f"{rel(again[0], lw):.3e}, gradients "
                  + ", ".join(f"{k} {rel_fro(again[1][k], gw[k]):.3e}"
                              for k in gw))
    print(f"phase 10 {label}: one step, two ranks vs one rank on the card: "
          f"loss {l0:.7f} vs {lw:.7f} (rel {loss_rel:.3e}, need <= "
          f"{loss_bound}); gradient rel Frobenius "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (need <= {grad_bound}){spread}; the ranks' loss and "
          f"gradients bit-equal: {same}; finite {finite}", flush=True)
    if not (finite and same and loss_rel <= loss_bound
            and max(errs.values()) <= grad_bound):
        fail(f"phase 10 {label}: two ranks disagree with one")


def drive_mesh_cli(root: str, card: str) -> None:
    """Phase 10 d: ``cli.train`` on the synth sphere (phase 5's config, the
    main path's modes) under two ranks (data = 1, rays = 2) against one rank
    in process, then ``cli.test`` under two ranks against one rank on the
    two ranks' checkpoint; ``tools/torch_rank_audit.py`` refuses any write
    by rank 1 under the run's directory."""
    import copy
    import os
    import re

    from papr_tpu_torch.cli import test as cli_test
    from papr_tpu_torch.cli import train as cli_train
    from papr_tpu_torch.config import Config
    from papr_tpu_torch.dataset.synth import make_demo_scene

    scene = make_demo_scene(os.path.join(root, "scene"), n_train=4, n_test=1,
                            H=MESH_HW, W=MESH_HW)
    tpu = {"topk_impl": "cull", "fused_attn": "streamrec"}
    one = cli_config(scene, os.path.join(root, "one"), MESH_CLI_STEPS, **tpu)
    two = cli_config(scene, os.path.join(root, "two"), MESH_CLI_STEPS,
                     mesh={"data": 1, "rays": 2}, **tpu)
    opt1 = write_cfg(one, os.path.join(root, "one.yml"))
    opt2 = write_cfg(two, os.path.join(root, "two.yml"))
    test1 = copy.deepcopy(dict(one))
    test1["test"]["load_path"] = os.path.join(two.save_dir, two.index)
    opt_t = write_cfg(Config(test1), os.path.join(root, "test1.yml"))

    def torchrun(module, opt, label):
        log = os.path.join(root, f"{label}.log")
        with open(log, "w") as f:
            p = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=2", "tools/torch_rank_audit.py",
                 two.save_dir, module, "--opt", opt], stdout=f,
                stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        wait_ranks([p], [log], MESH_CLI_TIMEOUT, f"torchrun {label}")
        with open(log) as f:
            text = f.read()
        return text, time.perf_counter() - t0

    t0 = time.perf_counter()
    (_, _, _, hist1), _ = in_process(lambda: cli_train.main(["--opt", opt1]),
                                     "cli.train one rank", phase=10)
    one_s = time.perf_counter() - t0
    text, two_s = torchrun("papr_tpu_torch.cli.train", opt2, "train")
    m = re.findall(r"Eval step: (\d+) train_loss: ([\d.eE+-]+) eval_loss: "
                   r"([\d.eE+-]+) eval_psnr: ([\d.eE+-]+)", text)
    events = re.findall(r"(Pruned|Added) (\d+) points", text)
    if not m or "Training finished!" not in text:
        fail(f"phase 10 d: cli.train under two ranks:\n{text[-3000:]}")
    step2, tl2, el2 = int(m[-1][0]), float(m[-1][1]), float(m[-1][2])
    tl1, el1 = hist1["train_losses"][-1], hist1["eval_losses"][-1]
    rel_t = abs(tl2 - tl1) / max(abs(tl1), 1e-30)
    rel_e = abs(el2 - el1) / max(abs(el1), 1e-30)
    print(f"phase 10 d: cli.train {MESH_CLI_STEPS} steps on the {MESH_HW}x"
          f"{MESH_HW} sphere (prune + grow at 10: {events}), two ranks "
          f"under torchrun in {two_s:.1f} s (startup included) vs one rank "
          f"in process in {one_s:.1f} s: final train loss {tl2:.6f} vs "
          f"{tl1:.6f} (rel {rel_t:.3e}), eval loss {el2:.6f} vs {el1:.6f} "
          f"(rel {rel_e:.3e}; need <= 1e-4); rank 1 wrote nothing under the "
          f"run's directory (audited); {card}", flush=True)
    if step2 != hist1["steps"][-1] or "Pruned" not in text \
            or "Added" not in text or rel_t > 1e-4 or rel_e > 1e-4:
        fail("phase 10 d: two ranks trained otherwise than one")
    text, test_s = torchrun("papr_tpu_torch.cli.test", opt2, "test")
    res1, _ = in_process(lambda: cli_test.main(["--opt", opt_t]),
                         "cli.test one rank", phase=10)
    got = re.findall(r"Avg test loss: ([\d.eE+-]+), test PSNR: "
                     r"([\d.eE+-]+)", text)
    want = next(iter(res1.values()))
    print(f"phase 10 d: cli.test on the two ranks' checkpoint under two ranks "
          f"in {test_s:.1f} s: {got} vs one rank: loss {want['loss']:.4f}, "
          f"PSNR {want['psnr']:.4f}", flush=True)
    if got != [(f"{want['loss']:.4f}", f"{want['psnr']:.4f}")] \
            or text.count("Avg test loss") != 1:
        fail("phase 10 d: cli.test under two ranks reports otherwise than "
             "one rank")


def mesh_collectives(device) -> dict:
    """The collectives of ``parallel/collectives.py`` on a one-rank mesh of
    the running group, on fixed CUDA tensors -> their results (host)."""
    import torch
    from papr_tpu_torch.parallel import collectives as coll
    from papr_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(1, 1)
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(2, 8, 5, 7, generator=gen, device=device,
                    requires_grad=True)
    y = coll.gather_rows(x, mesh)
    (gx,) = torch.autograd.grad((y * y).sum(), x)
    grads = [torch.randn(33, generator=gen, device=device),
             torch.randn(4, 4, generator=gen, device=device)]
    coll.reduce_gradients(grads, mesh)
    tree = {"a": torch.randn(6, generator=gen, device=device),
            "b": torch.rand(5, generator=gen, device=device) > 0.5}
    coll.replicate(mesh, tree)
    coll.barrier(mesh)
    host = lambda t: t.detach().cpu()
    return {"rows": host(y), "rows_grad": host(gx),
            "batch": host(coll.gather_batch(x.detach(), mesh)),
            "world": host(coll.gather_world(x.detach(), mesh)),
            "mean": host(coll.mean_over_data(x.detach().sum(), mesh)),
            "grads": [host(g) for g in grads],
            "tree": {k: host(v) for k, v in tree.items()},
            "x": host(x)}


def drive_nccl_world1(device, root: str) -> None:
    """Phase 10 e: NCCL initialised at world size 1 on the card (one rank,
    one card) runs every collective, which must give what gloo gives."""
    import torch
    import torch.distributed as dist
    from papr_tpu_torch.parallel import mesh as pmesh
    pmesh.init_ranks(f"file://{root}/nccl", 0, 1)
    backend = dist.get_backend()
    try:
        nccl = mesh_collectives(device)
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{root}/gloo",
                            rank=0, world_size=1)
    try:
        gloo = mesh_collectives(device)
    finally:
        dist.destroy_process_group()
    flat = lambda r: [t for v in r.values() for t in
                      (v.values() if isinstance(v, dict) else
                       v if isinstance(v, list) else [v])]
    same = all(torch.equal(a, b) for a, b in zip(flat(nccl), flat(gloo)))
    exact = (torch.equal(nccl["rows"], nccl["x"])
             and torch.equal(nccl["rows_grad"], 2 * nccl["x"]))
    version = (".".join(map(str, torch.cuda.nccl.version()))
               if backend == "nccl" else "not initialised")
    print(f"phase 10 e: the collectives under {backend} (NCCL {version}) "
          f"at world size 1 "
          f"on the card vs gloo: bit-equal {same}; the row gather and its "
          f"reduce-scatter exact {exact}", flush=True)
    if backend != "nccl" or not (same and exact):
        fail("phase 10 e: the collectives under NCCL differ from gloo")


def drive_mesh_path(device, card: str) -> dict:
    """Phase 10: the (data, rays) mesh on the card. One-rank references in
    this process, then two ranks sharing the card (a: the flagship step on
    data = 1, rays = 2; b: Caterpillar's fp32 step on data = 2, rays = 1;
    c: the serving and tiled frames), then the command-line path under
    torchrun (d) and NCCL at world size 1 (e). -> {"launches": each
    kernel's launches on the two ranks (a's timed steps, b's step, c's
    frames)}."""
    import os
    import tempfile

    import torch

    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="papr_chip_smoke_mesh_")
    # One rank: the references.
    cfg, params, state, rayo, rayd, target, c2w = mesh_flagship(device)
    ref_frames = mesh_frames(params, state, cfg)
    ref_a = mesh_step_grads(cfg, params, state, rayo, rayd, target, c2w,
                            device)
    ref_a2 = mesh_step_grads(cfg, params, state, rayo, rayd, target, c2w,
                             device)
    del params, state
    ref_b = mesh_step_grads(*mesh_caterpillar(device), device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # Two ranks sharing the card.
    logs = [os.path.join(root, f"rank{r}.log") for r in range(2)]
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 root, str(r), "2"], stdout=f, stderr=subprocess.STDOUT))
    wait_ranks(procs, logs, MESH_RANK_TIMEOUT, "rank")
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        path = os.path.join(root, f"rank{r}.pt")
        if not os.path.exists(path):
            fail(f"phase 10: rank {r} left no result")
        ranks.append(torch.load(path, weights_only=False))
    with open(logs[0]) as f:
        head = [l.strip() for l in f if l.startswith("Process group")]
    print(f"phase 10 two ranks on {card} (one card, shared): {head}; "
          f"both ran in {ranks_s:.1f} s (start-up, model builds and every "
          f"reading included); gloo on CUDA tensors: {ranks[0]['gloo_cuda']}",
          flush=True)

    # a: the step against one rank; timed steps; exact launches; params.
    mesh_check_step("a (flagship, bf16, data = 1, rays = 2)", ref_a,
                    [r["a"] for r in ranks], MESH_LOSS_REL, MESH_GRAD_REL,
                    ref_a2)
    t = [r["timed"] for r in ranks]
    want = {n: MESH_STEPS * v for n, v in MESH_STEP_LAUNCHES.items()}
    print(f"phase 10 a: 1 + {MESH_STEPS} steps, two ranks sharing one card "
          f"(not a scaling figure): {t[0]['ms']:.1f} / {t[1]['ms']:.1f} "
          f"ms/step on ranks 0 / 1; losses {t[0]['losses']}; pred "
          f"{t[0]['pred']}; launches per rank {t[0]['launches']} / "
          f"{t[1]['launches']} (want {want}); plain-version calls "
          f"{t[0]['plain']} / {t[1]['plain']}; parameters bit-equal across "
          f"ranks after the steps: {t[0]['digest'] == t[1]['digest']}",
          flush=True)
    if any(x["launches"] != want or x["plain"] for x in t) \
            or t[0]["digest"] != t[1]["digest"] \
            or t[0]["losses"] != t[1]["losses"] \
            or t[0]["pred"] != (1, PATCH, PATCH, 3):
        fail("phase 10 a: the ranks' steps")

    # b: Caterpillar's fp32 step against one rank, phase 8's bounds.
    mesh_check_step("b (Caterpillar, fp32, data = 2, rays = 1, batch 2)",
                    ref_b, [r["b"] for r in ranks], F32_STEP_LOSS_REL,
                    F32_STEP_GRAD_REL)
    f32_got = [r["b_launches"] for r in ranks]
    others = [r["b_others"] for r in ranks]
    print(f"phase 10 b: launches per rank {f32_got[0]} / {f32_got[1]} (want "
          f"{MESH_F32_STEP_LAUNCHES}); bf16 twins and plain versions "
          f"{others[0]} / {others[1]}", flush=True)
    if any(x != MESH_F32_STEP_LAUNCHES for x in f32_got) or any(others):
        fail("phase 10 b: the fp32 step's launches")

    # c: frames bit-equal to one rank's; exact per-rank launches.
    serve_w, tiled_w = ref_frames[0], ref_frames[1]
    n_tiles = (H // int(cfg.test.max_height)) * (W // int(cfg.test.max_width))
    want_one = {"cull_select": 1, "fused_mlp": 1, "attend_stream_eval": 1}
    want_tiles = {n: n_tiles // 2 for n in want_one}
    ok = True
    for r, x in enumerate(ranks):
        serve, tiled, one, tiles = x["frames"]
        ok &= (np.array_equal(serve, serve_w)
               and np.array_equal(tiled, tiled_w) and one[0] == want_one and tiles[0] == want_tiles
               and not one[1] and not tiles[1])
        print(f"phase 10 c rank {r}: {H}x{W} serving frame (one tile, "
              f"wrapped onto both ranks) bit-equal to one rank's: "
              f"{np.array_equal(serve, serve_w)}, launches {one[0]}; frame "
              f"at {cfg.test.max_height}x{cfg.test.max_width} tiles "
              f"({n_tiles} tiles, {n_tiles // 2} a rank) bit-equal: "
              f"{np.array_equal(tiled, tiled_w)}, launches {tiles[0]} (want "
              f"{want_one} / {want_tiles}); plain-version calls {one[1]} / "
              f"{tiles[1]}", flush=True)
    if not ok:
        fail("phase 10 c: the sharded frames")

    launches = {}
    for x in ranks:
        for d in (x["timed"]["launches"], x["b_launches"], x["frames"][2][0],
                  x["frames"][3][0]):
            for n, v in d.items():
                launches[n] = launches.get(n, 0) + v
    del ranks
    torch.cuda.empty_cache()
    drive_mesh_cli(root, card)
    drive_nccl_world1(device, root)
    print(f"phase 10 mesh path: {time.perf_counter() - t_start:.1f} s; "
          f"{card}", flush=True)
    return {"launches": launches}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "GPU only", file=sys.stderr)
        raise SystemExit(1)
    from papr_tpu_torch.kernels import build   # fails outside the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 0 card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.load()
    with open(build.library_path()[:-3] + ".log") as f:
        ptxas = [l.strip() for l in f if "registers" in l or "spill" in l]
    print(f"phase 1 kernels built and loaded in {time.perf_counter() - t0:.1f}"
          f" s ({build.library_path()})", flush=True)
    for line in ptxas:
        print(f"phase 1 ptxas: {line}", flush=True)

    cfg = flagship_cfg()
    params, state = build_model(cfg, device)
    results = compare_kernels(params, state, cfg, device)
    embed_results, stacks = compare_embed_kernels(params, state, cfg, device)
    results += embed_results
    train_results = compare_train_kernels(params, state, cfg, device)
    results[0].update(train_results.pop("cull_select"))
    results += list(train_results.values())
    results += compare_cli_kernels(params, state, cfg, device)
    results += compare_int8_kernels(params, state, cfg, device)
    for r in results:
        # The embedder kernels at the command-line path's key / value stacks.
        if r["name"] in stacks:
            r["stacks"] = stacks[r["name"]]
    run = drive_main_path(params, state, cfg, device)
    profile_frames(params, state, cfg)
    reference_check(device)
    train = drive_training(params, state, cfg, device)
    train_reference_check(device)
    del params, state
    torch.cuda.empty_cache()
    cli = drive_cli_path(device)
    modes = drive_stream_modes(device)
    train_reference_check(device, REF_STREAM_MODES, phase=6)
    int8 = drive_int8_paths(device, cli.pop("model"))
    train_reference_check(device, REF_INT8_MODES, phase=7)
    f32 = drive_fp32_path(device)
    results += f32["results"]
    f32_modes = drive_fp32_modes(device, f32.pop("ref"))
    drive_demo_cli()
    exposure = drive_exposure_path(device, card)
    mesh = drive_mesh_path(device, card)

    # Each kernel's launches on the main path that holds it: the serving
    # path and the training step (phases 3, 4), the command-line path, the
    # stream modes' steps and frames (phase 6), or the int8 frames, steps and
    # microbenchmark (phase 7), the fp32 step and frames (phase 8); and the
    # exposure path's command-line runs (phase 9).
    int8_only = ("attend_eval_i8", "key_stream_i8_fwd", "value_stream_i8_fwd",
                 "int8_walk_bench")
    cli_only = ("topk_stream", "fused_scores_fwd", "fused_scores_bwd")
    mode_only = ("key_stream_q_fwd", "key_stream_q_bwd",
                 "key_stream_feat_fwd", "key_stream_feat_bwd",
                 "value_stream_feat_fwd", "value_stream_feat_bwd")
    for r in results:
        r["launches"] = (int8["launches"][r["name"]] if r["name"] in int8_only
                         else f32["launches"][r["name"]]
                         + f32_modes["launches"].get(r["name"], 0)
                         if r["name"] in f32["launches"]
                         else f32_modes["launches"][r["name"]]
                         if r["name"] in f32_modes["launches"]
                         else cli["launches"][r["name"]] if r["name"] in cli_only
                         else modes["launches"][r["name"]]
                         if r["name"] in mode_only
                         else run["launches"].get(r["name"], 0)
                         + train["launches"].get(r["name"], 0))
        if r["name"] not in mode_only and modes["launches"].get(r["name"]):
            r["launches_stream_modes"] = modes["launches"][r["name"]]
        if cli["launches"].get(r["name"], 0) > 0:
            r["launches_command_line_path"] = cli["launches"][r["name"]]
        # Phase 9 drives the main path's kernels of both dtypes through the
        # exposure CLIs.
        if exposure["launches"].get(r["name"], 0) > 0:
            r["launches"] += exposure["launches"][r["name"]]
            r["launches_exposure_path"] = exposure["launches"][r["name"]]
        # Phase 10: both ranks' launches (the timed steps, the fp32 step,
        # the frames).
        r["launches_mesh_path"] = mesh["launches"].get(r["name"], 0)
        missing = [key for key in ("name", "route", "source", "replaces",
                                   "launches", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms") if key not in r]
        if missing or r["launches"] <= 0:
            fail(f"kernel record {r.get('name')}: missing {missing}, "
                 f"launches {r.get('launches')}")
    print(json.dumps({"kernels": results}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(*sys.argv[2:5])
    else:
        main()
